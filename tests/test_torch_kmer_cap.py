"""The k-mer cap and the noise-rate update in their redesigned forms, on
the CPU.

kmer_cap's plain version ranks each column's kept memberships over the
kept slots in visit order, where the JAX package (gibbs.apply_kmer_cap)
walks all K slots in a scan with a counter per column; the two must give
the same masks bit for bit, through gibbs._subsample_with_cap in both
packages: random clusters (H up to 8, V up to 4, K up to 256), caps of
1, 2, 3 and K, subsampling rates up to 1.0; a chunk where the cap binds
on most (cluster, chain) pairs and one where it binds on none.

The rate update is the key-only draws of a scan (kernels.noise_rate_draws)
and a per-iteration update from them (kernels.noise_rate_update); over a
short scan they must give reference.noise_rates' rates, log rates and trace
bit for bit, and zero the statistics.
"""

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from bayestyper_tpu.model import buckets as jbuckets
from bayestyper_tpu.model import gibbs as jg
from bayestyper_tpu_torch import kernels
from bayestyper_tpu_torch.kernels import reference
from bayestyper_tpu_torch.model import buckets as tbuckets
from bayestyper_tpu_torch.model import gibbs as tg
from bayestyper_tpu_torch.ops import prng

S = 2


def _cluster(rng, k, h, v, density, cid):
    """A cluster of k k-mers over h haplotypes and v variants whose member
    bits are set with the given density."""
    return dict(
        mult=rng.integers(0, 3, (k, h)).astype(np.uint8),
        inter_mult=np.zeros((k, S), np.uint8),
        counts=rng.integers(0, 30, (k, S)).astype(np.uint8),
        ploidy=np.full(S, 2, np.int8),
        hap_allele=(np.arange(h)[:, None] % 2 + np.zeros((1, v), int))
        .astype(np.int16),
        num_alleles=np.full(v, 2, np.int16),
        member=rng.random((k, v, h)) < density,
        cover=list(range(h)), cluster_id=cid,
    )


def _masks(host, seed, chains, rate, cap):
    """(JAX masks, the port's) of _subsample_with_cap with the cap on."""
    jb, tb = host.device_arrays(), tbuckets.bucket_from_numpy(host, "cpu")
    cfg = jg.GibbsConfig(num_chains=chains, kmer_subsampling_rate=rate,
                         max_haplotype_variant_kmers=cap, apply_cap=True)
    want = jg._subsample_with_cap(jax.random.PRNGKey(seed), jb, chains, cfg)
    base, fold = tg._chain_base(prng.prng_key(seed), chains)
    got = tg._subsample_with_cap(base, fold, tb, cfg)
    return np.asarray(want), got.numpy()


@settings(max_examples=24, deadline=None, database=None, derandomize=True)
@given(k=st.integers(1, 256), h=st.integers(1, 8), v=st.integers(1, 4),
       cap=st.sampled_from((1, 2, 3, "K")),
       rate=st.sampled_from((0.1, 0.5, 1.0)),
       density=st.sampled_from((0.2, 0.6, 1.0)),
       seed=st.integers(0, 2 ** 16))
def test_rank_form_equals_the_scan(k, h, v, cap, rate, density, seed):
    """Random clusters (the last one shorter than K, so the chunk has
    padded slots) under every kind of cap: bit-equal masks."""
    rng = np.random.default_rng(seed)
    clusters = [_cluster(rng, kk, h, v, density, 7 + 31 * i)
                for i, kk in enumerate((k, max(1, k // 2)))]
    host = jbuckets.build_bucket(clusters, (3, k, h, v), S)
    cap = k if cap == "K" else cap
    want, got = _masks(host, seed, 3, rate, cap)
    np.testing.assert_array_equal(got, want)


def _capped(host, rate, cap):
    """The port's masks (equal to the JAX package's), the subsample masks
    they were cut from, and which k-mers hold a membership [C, K]."""
    want, got = _masks(host, 5, 4, rate, cap)
    np.testing.assert_array_equal(got, want)
    bare = kernels.subsample_masks(
        *tg._chain_base(prng.split(prng.prng_key(5), 2)[0], 4),
        torch.from_numpy(host.cluster_id), torch.from_numpy(host.kmer_valid),
        rate, tg._SUBSAMPLE_SALT).numpy()
    return got, bare, (host.member != 0).any(axis=(2, 3))


def test_cap_binds_on_most_pairs():
    """Every k-mer in most columns and the whole pool kept: the cap binds
    on every real (cluster, chain) pair."""
    rng = np.random.default_rng(1)
    clusters = [_cluster(rng, 200, 4, 2, 0.9, 100 + i) for i in range(3)]
    host = jbuckets.build_bucket(clusters, (4, 224, 4, 2), S)
    got, bare, _ = _capped(host, 1.0, 3)
    changed = (got != bare).any(axis=2)[host.cluster_valid]
    assert changed.all(), changed


def test_cap_binds_on_no_pair():
    """A cap above every column's kept count: the masks are the subsample
    masks of the k-mers that hold a membership (the scan drops a kept k-mer
    of none; here about one in 64)."""
    rng = np.random.default_rng(2)
    clusters = [_cluster(rng, 60, 3, 2, 0.5, 40 + i) for i in range(3)]
    host = jbuckets.build_bucket(clusters, (4, 64, 4, 2), S)
    got, bare, member = _capped(host, 0.5, 64)
    assert (bare & ~member[:, None, :]).any()
    np.testing.assert_array_equal(got, bare & member[:, None, :])


@pytest.mark.parametrize("prior", [(1.0, 0.01), (0.5, 2.0)])
def test_rate_draws_and_update_equal_the_reference(prior):
    """A 12-iteration scan: noise_rate_draws once, then noise_rate_update per
    iteration, against reference.noise_rates per iteration, from the same
    statistics (zero on some entries, so a prior shape under one takes the
    boost): rates, log rates and the trace bit-equal, statistics zeroed."""
    rng = np.random.default_rng(4)
    ch, s, iters = 3, 5, 12
    _, k_noise = tg._chain_keys(prng.prng_key(6), ch, 0)
    stats = [[torch.from_numpy((rng.integers(0, hi, (ch, s))
                                * (rng.random((ch, s)) < 0.7))
                               .astype(np.int32)) for hi in (300, 9000)]
             for _ in range(iters)]
    runs = []
    for paired in (True, False):
        rates = torch.full((ch, s), 1e-3)
        log_r = torch.zeros((ch, s))
        trace = torch.full((ch, iters, s), -1.0)
        draws = kernels.noise_rate_draws(k_noise, trace)
        outs = []
        for t in range(iters):
            cs, no = (x.clone() for x in stats[t])
            if paired:
                kernels.noise_rate_update(draws, cs, no, rates, log_r, trace,
                                          t, *prior)
            else:
                reference.noise_rates(k_noise, cs, no, rates, log_r, trace, t,
                                      *prior)
            assert not (cs.any() or no.any())
            outs.append((rates.clone(), log_r.clone()))
        runs.append((outs, trace))
    (got, trace_got), (want, trace_want) = runs
    for (r_g, l_g), (r_w, l_w) in zip(got, want):
        assert torch.equal(r_g, r_w) and torch.equal(l_g, l_w)
    assert torch.equal(trace_got, trace_want)
    # the draws of a window equal the scan's slice of them
    window = kernels.noise_rate_draws(k_noise, trace_got, 5, 3)
    assert torch.equal(window.keys, draws.keys[5:8])
    assert torch.equal(window.draws, draws.draws[5:8])
