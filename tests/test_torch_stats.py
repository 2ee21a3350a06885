"""The port's posterior statistics against the JAX package's, from
identical tallies and subsample masks, on the CPU: the packed form of the
main path, and the unpacked form with the coupled path's missing_stats and
mac_extra inputs.

Integer fields (genotype and allele tallies, denominators, GT calls with
their tie counting, SAF filter codes) are exact. Packed NAK, FAK and MAC are
float32 contractions shipped as float16; they agree within rtol 2e-3 /
atol 2e-3, one float16 step at the magnitudes the writer prints. Unpacked,
GPP, APP and GQ agree within 1e-6 and NAK, FAK and MAC within 1e-5
relative (sums in another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayestyper_tpu.model import buckets as jbuckets
from bayestyper_tpu.model import gibbs as jg
from bayestyper_tpu.model import stats as jstats
from bayestyper_tpu_torch.model import buckets as tbuckets
from bayestyper_tpu_torch.model import stats as tstats
from tests.test_torch_gibbs import BUCKETS, _synthetic_bucket

CH = 3
F16_CLOSE = dict(rtol=2e-3, atol=2e-3)


def _tallies(rng, host, num_samples=40):
    """[C, ch, S, O] int32 tallies of num_samples draws per (cluster,
    chain, sample) over the sample's ploidy-valid outcomes, concentrated on
    a few outcomes, with exact two-way ties in some rows."""
    c = host.mult.shape[0]
    s = host.counts.shape[2]
    osp = jg.make_outcome_space(host.mult.shape[2])
    o = osp.num_outcomes
    out = np.zeros((c, CH, s, o), np.int32)
    for ci in range(c):
        for si in range(s):
            valid = np.flatnonzero(osp.ploidy_mask[host.ploidy[ci, si]])
            for x in range(CH):
                p = rng.dirichlet(np.full(len(valid), 0.3))
                out[ci, x, si, valid] = rng.multinomial(num_samples, p)
            if rng.random() < 0.3 and len(valid) >= 2:
                out[ci, :, si] = 0
                out[ci, :, si, valid[0]] = num_samples // 2
                out[ci, :, si, valid[-1]] = num_samples // 2
    return out


@pytest.mark.parametrize("name", sorted(BUCKETS))
@pytest.mark.parametrize("exact_mac", [True, False])
def test_packed_stats_match(name, exact_mac):
    host, tables = BUCKETS[name]()
    rng = np.random.default_rng(12)
    h = host.mult.shape[2]
    osp = jg.make_outcome_space(h)
    o = osp.num_outcomes
    mac_top_t = o if exact_mac else min(8, o)
    tallies = np.stack([_tallies(rng, host), _tallies(rng, host)])
    w = np.stack([rng.random((host.mult.shape[0], CH, host.mult.shape[1]))
                  < 0.5] * 2) & host.kmer_valid[None, :, None, :]
    s = host.counts.shape[2]
    filters = jstats.FilterConfig.from_model(np.full(s, 15.0), 0.99, 1.0)
    jb = host.device_arrays()
    want = jstats.collect_bucket_stats_packed_stacked(
        jbuckets.stack_buckets([jb, jb]), osp, jnp.asarray(tallies),
        jnp.asarray(w), filters, allele_capacity=4, mac_top_t=mac_top_t)
    tb = tbuckets.bucket_from_numpy(host, "cpu")
    got = tstats.collect_bucket_stats_packed_stacked(
        tbuckets.stack_buckets([tb, tb]), osp, torch.from_numpy(tallies),
        torch.from_numpy(w), tstats.FilterConfig(*map(
            lambda f: getattr(filters, f.name),
            jstats.FilterConfig.__dataclass_fields__.values())),
        allele_capacity=4, mac_top_t=mac_top_t)
    for field in ("gt_tally", "al_tally", "denom", "gt", "saf"):
        np.testing.assert_array_equal(
            getattr(got, field).numpy().astype(np.int64),
            np.asarray(getattr(want, field)).astype(np.int64), err_msg=field)
    for field in ("nak", "fak", "mac"):
        g = getattr(got, field)
        assert g.dtype == torch.float16
        np.testing.assert_allclose(
            g.numpy().astype(np.float32),
            np.asarray(getattr(want, field)).astype(np.float32),
            err_msg=field, **F16_CLOSE)
    # the host unpack (copied code) derives the same GPP/GQ from either
    host_want = jstats.unpack_stats_host(jstats.PackedBucketStats(
        *(np.asarray(x) for x in jax_leaves(want))))
    host_got = tstats.unpack_stats_host(tstats.PackedBucketStats(
        got.gt_tally.numpy().astype(np.uint16),
        got.al_tally.numpy().astype(np.uint16),
        got.denom.numpy().astype(np.uint16), got.gt.numpy(),
        got.saf.numpy(), got.nak.numpy(), got.fak.numpy(), got.mac.numpy()))
    for field in ("gpp", "app", "gq", "gt"):
        np.testing.assert_array_equal(getattr(host_got, field),
                                      getattr(host_want, field))


def jax_leaves(p):
    return (p.gt_tally, p.al_tally, p.denom, p.gt, p.saf, p.nak, p.fak,
            p.mac)


def _filters(s):
    return jstats.FilterConfig.from_model(np.full(s, 15.0), 0.99, 1.0)


def _port_filters(filters):
    return tstats.FilterConfig(filters.min_genotype_posterior,
                               filters.min_number_of_kmers,
                               filters.min_fraction_observed_kmers)


def _assert_unpacked_close(got, want):
    for field in ("gt", "saf"):
        np.testing.assert_array_equal(
            getattr(got, field).numpy().astype(np.int64),
            np.asarray(getattr(want, field)).astype(np.int64), err_msg=field)
    for field in ("gpp", "app", "gq"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=1e-6, atol=1e-6, err_msg=field)
    for field in ("nak", "fak", "mac"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=1e-5, atol=1e-5, err_msg=field)


@pytest.mark.parametrize("name", sorted(BUCKETS))
@pytest.mark.parametrize("coupled", [False, True])
def test_unpacked_stats_match(name, coupled):
    """collect_bucket_stats, with the coupled path's substitutions of the
    `*` allele's stats (missing_stats) and MAC correction (mac_extra)."""
    host, _ = BUCKETS[name]()
    rng = np.random.default_rng(31)
    c, k, h = host.mult.shape
    s = host.counts.shape[2]
    v = host.hap_allele.shape[2]
    osp = jg.make_outcome_space(h)
    o = osp.num_outcomes
    a_cap = 4
    if coupled:
        # a last allele on no haplotype, as a nested child's `*`: its own
        # k-mer stats are empty, so the parent's are substituted
        na = host.num_alleles
        host = dataclasses.replace(
            host, num_alleles=np.where(na > 0, np.minimum(na + 1, a_cap),
                                       0).astype(na.dtype))
    tally = _tallies(rng, host)
    w = (rng.random((c, CH, k)) < 0.5) & host.kmer_valid[:, None, :]
    filters = _filters(s)
    kw_j, kw_t = {}, {}
    if coupled:
        missing = tuple(rng.random((c, s)).astype(np.float32) * 20
                        for _ in range(3))
        extra = (rng.random((c, s, v, a_cap)).astype(np.float32) - 0.5) * 50
        kw_j = dict(missing_stats=tuple(map(jnp.asarray, missing)),
                    mac_extra=jnp.asarray(extra))
        kw_t = dict(missing_stats=tuple(map(torch.from_numpy, missing)),
                    mac_extra=torch.from_numpy(extra))
    want = jstats.collect_bucket_stats(
        host.device_arrays(), osp, jnp.asarray(tally), jnp.asarray(w),
        filters, allele_capacity=a_cap, mac_top_t=o, **kw_j)
    got = tstats.collect_bucket_stats(
        tbuckets.bucket_from_numpy(host, "cpu"), osp, torch.from_numpy(tally),
        torch.from_numpy(w), _port_filters(filters), allele_capacity=a_cap,
        mac_top_t=o, **kw_t)
    _assert_unpacked_close(got, want)
    if coupled:  # the substitution took effect somewhere
        sub = np.asarray(want.nak) != np.asarray(jstats.collect_bucket_stats(
            host.device_arrays(), osp, jnp.asarray(tally), jnp.asarray(w),
            filters, allele_capacity=a_cap, mac_top_t=o).nak)
        assert sub.any()


def test_unpacked_stacked_stats_match():
    """collect_bucket_stats_stacked, the main path's form for tallies
    beyond u16."""
    host, _ = BUCKETS["H64"]()
    rng = np.random.default_rng(7)
    s = host.counts.shape[2]
    osp = jg.make_outcome_space(host.mult.shape[2])
    tallies = np.stack([_tallies(rng, host), _tallies(rng, host)])
    w = np.stack([rng.random((host.mult.shape[0], CH, host.mult.shape[1]))
                  < 0.5] * 2) & host.kmer_valid[None, :, None, :]
    filters = _filters(s)
    jb = host.device_arrays()
    tb = tbuckets.bucket_from_numpy(host, "cpu")
    want = jstats.collect_bucket_stats_stacked(
        jbuckets.stack_buckets([jb, jb]), osp, jnp.asarray(tallies),
        jnp.asarray(w), filters, allele_capacity=4, mac_top_t=8)
    got = tstats.collect_bucket_stats_stacked(
        tbuckets.stack_buckets([tb, tb]), osp, torch.from_numpy(tallies),
        torch.from_numpy(w), _port_filters(filters), allele_capacity=4,
        mac_top_t=8)
    _assert_unpacked_close(got, want)


def _tied_tallies(host):
    """[C, ch, S, O] tallies over the H16 outcome space whose totals over
    chains tie across the 8th and 9th places of every (cluster, sample):
    5 at five ploidy-valid outcomes, 3 at the next twelve (spread over the
    chains, so the per-chain tallies differ), 0 elsewhere."""
    c = host.mult.shape[0]
    s = host.counts.shape[2]
    osp = jg.make_outcome_space(host.mult.shape[2])
    out = np.zeros((c, CH, s, osp.num_outcomes), np.int32)
    rng = np.random.default_rng(4)
    for ci in range(c):
        for si in range(s):
            valid = np.flatnonzero(osp.ploidy_mask[host.ploidy[ci, si]])
            if len(valid) < 17:
                continue
            pick = rng.permutation(valid)[:17]
            out[ci, :, si, pick[:5]] = (2, 2, 1)
            out[ci, :, si, pick[5:]] = 1
    return out


@pytest.mark.parametrize("packed", [False, True])
def test_top8_ties_match(packed):
    """MAC over the top 8 of O = 153 outcomes (H16, where the engine
    truncates) when the 8th place is a tie of twelve outcomes: the port's
    selection takes the tied outcomes in lax.top_k's order (ties to the
    lower index), as the JAX package does."""
    host, _ = _synthetic_bucket(16, 9)
    c, k, h = host.mult.shape
    s = host.counts.shape[2]
    osp = jg.make_outcome_space(h)
    assert osp.num_outcomes > 64
    tally = _tied_tallies(host)
    top = -np.sort(-tally.sum(axis=1), axis=-1)
    assert (top[..., 7] == top[..., 8]).any()
    rng = np.random.default_rng(17)
    w = (rng.random((c, CH, k)) < 0.7) & host.kmer_valid[:, None, :]
    filters = _filters(s)
    if packed:
        jb = host.device_arrays()
        tb = tbuckets.bucket_from_numpy(host, "cpu")
        want = jstats.collect_bucket_stats_packed_stacked(
            jbuckets.stack_buckets([jb]), osp, jnp.asarray(tally[None]),
            jnp.asarray(w[None]), filters, allele_capacity=4, mac_top_t=8)
        got = tstats.collect_bucket_stats_packed_stacked(
            tbuckets.stack_buckets([tb]), osp, torch.from_numpy(tally[None]),
            torch.from_numpy(w[None]), _port_filters(filters),
            allele_capacity=4, mac_top_t=8)
        np.testing.assert_allclose(
            got.mac.numpy().astype(np.float32),
            np.asarray(want.mac).astype(np.float32), **F16_CLOSE)
        return
    want = jstats.collect_bucket_stats(
        host.device_arrays(), osp, jnp.asarray(tally), jnp.asarray(w),
        filters, allele_capacity=4, mac_top_t=8)
    got = tstats.collect_bucket_stats(
        tbuckets.bucket_from_numpy(host, "cpu"), osp, torch.from_numpy(tally),
        torch.from_numpy(w), _port_filters(filters), allele_capacity=4,
        mac_top_t=8)
    _assert_unpacked_close(got, want)
