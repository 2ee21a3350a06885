"""The port's Gibbs programs against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
port runs its kernels' plain versions (tensors on the CPU). Tolerances:

  * subsample masks and PRNG-derived draws: bit-equal;
  * LL, A, B: rtol=1e-5, atol=1e-4 (sums over k in another order); C0
    the same plus 5e-7 per summed k-mer (XLA's lgamma(1) is 4.8e-7);
  * one Gibbs iteration from the reference's LL: drawn outcomes equal on
    >= 99.9% of (cluster, chain, sample) entries (exp/log differ from XLA's
    in the last bits, which can move a draw across a CDF threshold);
  * tallies: bit-equal for every (cluster, chain) whose drawn outcomes were
    identical in every iteration of a recorded scan, and those are >= 95%
    of the pairs; whole genotype_stacked scans give equal tallies on >= 95%
    of the pairs.

Buckets: the H2 demo bucket of __graft_entry__, a synthetic H64 bucket
(haploid, null-ploidy and intercluster k-mers included, so both samplers
and every LL term are exercised), and H16 clusters of a run_cluster_phase
unit.
"""

import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_demo_bucket
from bayestyper_tpu.model import buckets as jbuckets
from bayestyper_tpu.model import gibbs as jg
from bayestyper_tpu.ops.distributions import np_build_count_log_prob_tables
from bayestyper_tpu_torch import kernels
from bayestyper_tpu_torch.model import buckets as tbuckets
from bayestyper_tpu_torch.model import gibbs as tg
from bayestyper_tpu_torch.ops import prng

S = 4
RATE_CASES = (0.1, 0.6)


def _multi_hap_cluster(rng, h_real, cid, nk=3):
    """A cluster with h_real haplotypes over two variants: private k-mer
    blocks per haplotype, k-mers shared by half the haplotypes, and k-mers
    with intercluster multiplicity. Sample 1 is haploid, sample 2 null."""
    k = h_real * nk + 6
    mult = np.zeros((k, h_real), np.uint8)
    for h in range(h_real):
        mult[h * nk:(h + 1) * nk, h] = 1
    shared = h_real * nk
    mult[shared:shared + 3, : h_real // 2] = 1
    mult[shared + 3:shared + 6, h_real // 2:] = 2
    inter = np.zeros((k, S), np.uint8)
    inter[shared + 1, :] = 1
    inter[rng.integers(0, shared), 0] = 2
    truth = [tuple(rng.integers(0, min(h_real, 4), 2)) for _ in range(S)]
    counts = np.zeros((k, S), np.uint8)
    for si, (a1, a2) in enumerate(truth):
        m = mult[:, a1].astype(np.int64) + mult[:, a2] + inter[:, si]
        counts[:, si] = np.clip(
            rng.negative_binomial(np.maximum(m, 1) * 7.5, 0.5)
            * (m > 0) + rng.poisson(0.05, k), 0, 255)
    hap_allele = np.stack([np.arange(h_real) % 3,
                           np.arange(h_real) // 3 % 2], axis=1).astype(np.int16)
    member = np.zeros((k, 2, h_real), bool)
    for v in range(2):
        for h in range(h_real):
            member[:, v, h] = mult[:, h] > 0
    return dict(
        mult=mult, inter_mult=inter, counts=counts,
        ploidy=np.array([2, 1, 0, 2], np.int8),
        hap_allele=hap_allele, num_alleles=np.array([3, 2], np.int16),
        member=member, cover=list(range(0, h_real, 3)), cluster_id=cid,
    )


def _synthetic_bucket(h_cap, seed):
    rng = np.random.default_rng(seed)
    h_real = h_cap - 3
    cls = [_multi_hap_cluster(rng, h_real, 1000 + 7 * i) for i in range(3)]
    k_cap = max(len(c["mult"]) for c in cls) + 5
    host = jbuckets.build_bucket(cls, (4, k_cap, h_cap, 2), S)
    tables = np_build_count_log_prob_tables(
        np.full(S, 0.5), np.full(S, 7.5), np.full(S, 0.05), 16)
    return host, tables


def _demo_bucket():
    bucket, tables = _make_demo_bucket(num_clusters=8, num_samples=3, seed=0)
    host = jbuckets.ClusterBucket(**{
        f: np.asarray(getattr(bucket, f))
        for f in jbuckets.ClusterBucket.__dataclass_fields__
    })
    return host, np.array(tables)


@functools.lru_cache(maxsize=None)
def _unit_bucket():
    """Four H16 clusters of a run_cluster_phase unit (chip_smoke.py's
    workload at a small scale, 13 samples, k = 55), built by the JAX
    package's engine helpers."""
    import chip_smoke
    from bayestyper_tpu import engine as jengine
    from bayestyper_tpu.io.samples import ChromosomePloidy
    from bayestyper_tpu.model.count_model import fit_genomic_nb

    ploidy = ChromosomePloidy.human_default()
    with tempfile.TemporaryDirectory() as td:
        genome, vcf_path, _, _, samples = chip_smoke.simulate(td, 3, 0.02)
        unit = jengine.run_cluster_phase(
            genome, samples, vcf_path, ploidy, kmer_size=chip_smoke.K,
            max_parameter_kmers=1_000_000)
        table, counts = jengine.gather_sample_counts(unit, samples)
    nb = fit_genomic_nb(jengine.parameter_kmer_stats(unit, samples, table,
                                                     counts))
    singles = list(unit.compiled)
    plan = jengine._plan_unit(singles, jengine._class_map(singles),
                              jengine.GenotypeOptions(), samples, None)
    pc = next(plan[kc] for kc in sorted(plan) if kc[0] == 16)
    host = jengine._build_bucket_batch(
        pc.chunks[0][:4], (4, pc.k, pc.h, pc.v), samples, ploidy,
        jengine._UnitCounts(unit, table, counts), 1)
    tables = np_build_count_log_prob_tables(
        nb.p, nb.size, np.full(len(samples), 1e-3), 255)
    return host, tables


BUCKETS = {
    "H2-demo": _demo_bucket,
    "H64": lambda: _synthetic_bucket(64, 5),
    "H16-unit": _unit_bucket,
}


@pytest.fixture(scope="module", params=sorted(BUCKETS))
def case(request):
    host, tables = BUCKETS[request.param]()
    return request.param, host, tables


def _pair(host):
    """(JAX bucket, port bucket on the CPU) of one host bucket."""
    return host.device_arrays(), tbuckets.bucket_from_numpy(host, "cpu")


def _keys(seed):
    return jax.random.PRNGKey(seed), prng.prng_key(seed)


@pytest.mark.parametrize("rate", RATE_CASES)
def test_subsample_masks_bit_equal(case, rate):
    _, host, _ = case
    jb, tb = _pair(host)
    jk, tk = _keys(31)
    want = jg.subsample_masks(jk, jb.kmer_valid, 5, rate,
                              cluster_ids=jb.cluster_id)
    got = tg.subsample_masks(tk, tb.kmer_valid, 5, rate,
                             cluster_ids=tb.cluster_id)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kmer_cap_bit_equal(case):
    _, host, _ = case
    jb, tb = _pair(host)
    cfg = jg.GibbsConfig(num_chains=3, kmer_subsampling_rate=0.9,
                         max_haplotype_variant_kmers=2, apply_cap=True)
    jk, tk = _keys(8)
    want = jg._subsample_with_cap(jk, jb, 3, cfg)
    base, fold = tg._chain_base(tk, 3)
    got = tg._subsample_with_cap(base, fold, tb, cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kmer_cap_on_coupled_level(case):
    """The cap as a level of the coupled scan takes it: the level's key is
    fold_in(key, level), split into (subsample, chain) keys, and the
    subsample key split again for the cap (gibbs.py:1054-1056, :666-682);
    the port's nested_setup masks equal the JAX package's."""
    _, host, _ = case
    jb, tb = _pair(host)
    cfg = jg.GibbsConfig(num_chains=3, kmer_subsampling_rate=0.9,
                         max_haplotype_variant_kmers=2, apply_cap=True)
    jk, tk = _keys(12)
    level = 3
    want = jg._subsample_with_cap(
        jax.random.split(jax.random.fold_in(jk, jnp.uint32(level)))[0], jb, 3,
        cfg)
    base, fold = tg._chain_base(prng.split(prng.fold_in(tk, level), 2)[0], 3)
    got = tg._subsample_with_cap(base, fold, tb, cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    uncapped = jg.subsample_masks(
        jax.random.split(jax.random.split(
            jax.random.fold_in(jk, jnp.uint32(level)))[0])[0],
        jb.kmer_valid, 3, 0.9, cluster_ids=jb.cluster_id)
    assert int(got.sum()) < int(np.asarray(uncapped).sum())


def _masks(jb, tb, seed=17, rate=0.6, ch=3):
    jk, tk = _keys(seed)
    w = jg.subsample_masks(jk, jb.kmer_valid, ch, rate,
                           cluster_ids=jb.cluster_id)
    return np.array(w)


@pytest.mark.parametrize("include_noise_row", [True, False])
@pytest.mark.parametrize("gather_strategy", [True, False])
def test_log_likelihoods_close(case, include_noise_row, gather_strategy,
                               monkeypatch):
    _, host, tables = case
    jb, tb = _pair(host)
    w = _masks(jb, tb)
    if not gather_strategy:  # the JAX package's multiplicity-class loop
        monkeypatch.setattr(jg, "_LL_GATHER_BYTES", 0)
    osp = jg.make_outcome_space(host.mult.shape[2])
    want = jg.compute_log_likelihoods(
        jb, osp, jnp.asarray(tables), jnp.asarray(w), 8,
        include_noise_row=include_noise_row)
    got = tg.compute_log_likelihoods(
        tb, osp, torch.from_numpy(tables), torch.from_numpy(w), 8,
        include_noise_row=include_noise_row)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-4)


def test_noise_terms_close(case):
    _, host, tables = case
    jb, tb = _pair(host)
    w = _masks(jb, tb)
    osp = jg.make_outcome_space(host.mult.shape[2])
    want = jg.compute_noise_terms(jb, osp, jnp.asarray(w))
    got = tg.compute_noise_terms(tb, osp, torch.from_numpy(tables),
                                 torch.from_numpy(w))
    a, b, c0 = (np.asarray(x) for x in want)
    np.testing.assert_allclose(got[0].numpy(), a, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), b, rtol=1e-5, atol=1e-4)
    # XLA's float32 lgamma is off by up to ~5e-7 at small integers
    # (lgamma(1) = 4.8e-7 there, 0 in torch and CUDA), and C0 sums one
    # lgamma per counted k-mer: allow that much per summed term
    err = np.abs(got[2].numpy() - c0)
    assert (err <= 1e-4 + 1e-5 * np.abs(c0) + 5e-7 * b).all(), err.max()


def _random_freqs(rng, hap_valid, ch):
    c, h = hap_valid.shape
    f = rng.dirichlet(np.ones(h), size=(c, ch)).astype(np.float32)
    f[rng.random((c, ch, h)) < 0.3] = 0.0
    f *= hap_valid[:, None, :]
    tot = f.sum(-1, keepdims=True)
    return np.where(tot > 0, f / np.maximum(tot, 1e-30),
                    hap_valid[:, None, :] / np.maximum(hap_valid.sum(-1), 1)[:, None, None]
                    ).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("osp",))
def _jax_iteration(jb, osp, ll, freqs, chain_keys, t):
    oa = jg._osp_arrays(osp)

    def per_cc(ck, f, llv, ploidy, hv, sp, usp):
        return jg._gibbs_iteration(jax.random.fold_in(ck, t), f, llv, ploidy,
                                   hv, sp, usp, oa)

    per_cluster = jax.vmap(per_cc, in_axes=(0, 0, 0, None, None, None, None))
    return jax.vmap(per_cluster)(chain_keys, freqs, ll, jb.ploidy,
                                 jb.hap_valid, jb.sparsity, jb.use_sparse)


def test_gibbs_iteration_matches(case):
    """One iteration fed the reference's LL and frequencies."""
    _, host, tables = case
    jb, tb = _pair(host)
    ch = 4
    osp = jg.make_outcome_space(host.mult.shape[2])
    w = _masks(jb, tb, ch=ch)
    ll = np.array(jg.compute_log_likelihoods(
        jb, osp, jnp.asarray(tables), jnp.asarray(w), 8))
    rng = np.random.default_rng(2)
    freqs = _random_freqs(rng, host.hap_valid, ch)
    jk, tk = _keys(23)
    chain_keys = jg._chain_keys(jk, jb.cluster_id, ch)
    agree, total = 0, 0
    for t in (0, 1, 117, 349):
        f_j, o_j = _jax_iteration(jb, osp, jnp.asarray(ll),
                                  jnp.asarray(freqs), chain_keys,
                                  jnp.uint32(t))
        base, fold = tg._chain_base(tk, ch)
        c, _, s, o = ll.shape
        f_t, _, o_t = kernels.gibbs_sweep(
            torch.from_numpy(ll).reshape(c * ch, s, o),
            *tg._cluster_fields(tbuckets.stack_buckets([tb])), base, fold,
            torch.from_numpy(freqs).reshape(c * ch, -1), t, t + 1, t + 1,
            tg.outcome_tensors(osp.num_haplotypes, "cpu"))
        o_j, o_t = np.asarray(o_j), o_t.reshape(c, ch, s).numpy()
        f_t = f_t.reshape(freqs.shape)
        same = o_j == o_t
        agree += same.sum()
        total += same.size
        pair_same = same.all(axis=-1)
        np.testing.assert_allclose(f_t.numpy()[pair_same],
                                   np.asarray(f_j)[pair_same], atol=1e-5)
    assert agree / total >= 0.999, (agree, total)


def test_scan_tallies_exact_where_draws_agree(case):
    """A short scan fed the reference's LL, with every iteration's drawn
    outcomes recorded on both sides: the port's tally (one gibbs_sweep call)
    equals the reference's histogram of its draws on every (cluster, chain)
    whose draws never diverged, and those are nearly all."""
    _, host, tables = case
    jb, tb = _pair(host)
    ch, burn_in, iters = 3, 4, 16
    osp = jg.make_outcome_space(host.mult.shape[2])
    w = _masks(jb, tb, ch=ch)
    ll = np.array(jg.compute_log_likelihoods(
        jb, osp, jnp.asarray(tables), jnp.asarray(w), 8))
    c, _, s, o = ll.shape
    freqs = _random_freqs(np.random.default_rng(4), host.hap_valid, ch)
    jk, tk = _keys(29)
    chain_keys = jg._chain_keys(jk, jb.cluster_id, ch)
    base, fold = tg._chain_base(tk, ch)
    fields = tg._cluster_fields(tbuckets.stack_buckets([tb]))
    ots = tg.outcome_tensors(osp.num_haplotypes, "cpu")
    ll_t = torch.from_numpy(ll).reshape(c * ch, s, o)
    f0_t = torch.from_numpy(freqs).reshape(c * ch, -1)

    f_j, f_t = jnp.asarray(freqs), f0_t.clone()
    tally_j = np.zeros((c, ch, s, o), np.int32)
    diverged = np.zeros((c, ch), bool)
    for t in range(iters):
        f_j, o_j = _jax_iteration(jb, osp, jnp.asarray(ll), f_j, chain_keys,
                                  jnp.uint32(t))
        f_t, _, o_t = kernels.gibbs_sweep(ll_t, *fields, base, fold, f_t, t,
                                          t + 1, t + 1, ots)
        o_j = np.asarray(o_j)
        diverged |= (o_j != o_t.reshape(c, ch, s).numpy()).any(axis=-1)
        if t >= burn_in:
            np.put_along_axis(
                tally_j, o_j[..., None],
                np.take_along_axis(tally_j, o_j[..., None], -1) + 1, -1)
    tally_t = torch.zeros((c * ch, s, o), dtype=torch.int32)
    kernels.gibbs_sweep(ll_t, *fields, base, fold, f0_t.clone(), 0, iters,
                        burn_in, ots, tally_t)
    tally_t = tally_t.reshape(c, ch, s, o).numpy()
    np.testing.assert_array_equal(tally_t[~diverged], tally_j[~diverged])
    assert (~diverged).mean() >= 0.95, (~diverged).mean()


def test_genotype_stacked_tallies(case):
    """Whole frozen-noise scans through both packages' genotype_stacked:
    equal subsample masks, tallies equal on >= 95% of the (chunk, cluster,
    chain) pairs, and every pair's tally counts every sample iteration."""
    _, host, tables = case
    jb, tb = _pair(host)
    cfg = jg.GibbsConfig(num_chains=3, burn_in=6, num_samples=14,
                         kmer_subsampling_rate=0.6, max_total_mult=8)
    osp = jg.make_outcome_space(host.mult.shape[2])
    jk, tk = _keys(5)
    t_j, w_j = jg.genotype_stacked(
        jk, jbuckets.stack_buckets([jb, jb]), jnp.asarray(tables), osp, cfg)
    t_t, w_t = tg.genotype_stacked(
        tk, tbuckets.stack_buckets([tb, tb]), torch.from_numpy(tables), osp,
        cfg)
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    t_j, t_t = np.asarray(t_j), t_t.numpy()
    assert t_t.dtype == np.int32
    same = (t_j == t_t).all(axis=(-2, -1))              # [B, C, ch]
    assert same.mean() >= 0.95, same.mean()
    np.testing.assert_array_equal(t_t.sum(-1), t_j.sum(-1))


@pytest.fixture(scope="module", params=["H2-demo", "H16-unit"])
def noise_case(request):
    host, tables = BUCKETS[request.param]()
    return request.param, host, tables


def test_noise_chains_close(noise_case):
    """Noise chains over one stacked class: the rate trajectories agree
    within 1e-4 relative (gamma draws agree to ~1e-6 per step, and the
    int32 statistics are exact while the draws agree)."""
    _, host, tables = noise_case
    jb, tb = _pair(host)
    cfg = jg.GibbsConfig(num_chains=2, burn_in=4, num_samples=8,
                         kmer_subsampling_rate=0.6, max_total_mult=8)
    osp = jg.make_outcome_space(host.mult.shape[2])
    s = host.counts.shape[2]
    nv = np.zeros((2, host.mult.shape[0]), bool)
    nv[0] = host.cluster_valid
    nv[1, :2] = host.cluster_valid[:2]
    init = np.full((2, s), 2e-3, np.float32)
    jk, tk = _keys(9)
    rs_j, tr_j = jg.noise_chains_stacked(
        jk, (jbuckets.stack_buckets([jb, jb]),), (jnp.asarray(nv),),
        jnp.asarray(tables), jnp.asarray(init), (1.0, 0.01), (osp,), (cfg,),
        num_chains=2)
    rs_t, tr_t = tg.noise_chains_stacked(
        tk, [tbuckets.stack_buckets([tb, tb])], [torch.from_numpy(nv)],
        torch.from_numpy(tables), torch.from_numpy(init), (1.0, 0.01),
        [osp], [cfg], num_chains=2)
    np.testing.assert_allclose(tr_t.numpy(), np.asarray(tr_j), rtol=1e-4)
    np.testing.assert_allclose(rs_t.numpy(), np.asarray(rs_j), rtol=1e-4)


@pytest.mark.parametrize("k", [1, 31, 32, 33, 128, 1000])
def test_pack_bits_matches_its_unpack(k):
    """The LL kernel's packed masks: bit j of int32 word i is k-mer 32 i +
    j; the words past K are zero; unpack_member_bits inverts the packing."""
    from bayestyper_tpu_torch.model.buckets import unpack_member_bits

    w = torch.from_numpy(np.random.default_rng(k).random((3, 4, k)) < 0.3)
    words = kernels.pack_bits(w)
    assert words.dtype == torch.int32 and words.shape == (3, 4, (k + 31) // 32)
    assert torch.equal(unpack_member_bits(words, k), w)
    flat = unpack_member_bits(words, words.shape[-1] * 32)
    assert not bool(flat[..., k:].any())
    ref = np.zeros(words.shape, np.uint64)
    for j in range(k):
        ref[..., j // 32] |= (w[..., j].numpy().astype(np.uint64)
                              << np.uint64(j % 32))
    assert np.array_equal(words.numpy().view(np.uint32), ref.astype(np.uint32))
