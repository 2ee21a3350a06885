"""The port on a CUDA card: every kernel against its plain version, and the
sequential genotype phase end to end. Marked `cuda`; each test skips where
torch sees no card. Run on the card (the suite's conftest imports jax, which
the card's machine does not need):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import chip_smoke
from bayestyper_tpu_torch import engine, kernels
from bayestyper_tpu_torch.io.samples import ChromosomePloidy
from bayestyper_tpu_torch.model import buckets as tbuckets
from bayestyper_tpu_torch.model import gibbs as tg
from bayestyper_tpu_torch.ops import prng
from bayestyper_tpu_torch.ops.distributions import (
    np_build_count_log_prob_tables)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def small_unit(cuda, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("cuda_unit"))
    genome, vcf_path, variants, truth, samples = chip_smoke.simulate(
        tmp, 1, 0.02)
    ploidy = ChromosomePloidy.human_default()
    unit = engine.run_cluster_phase(genome, samples, vcf_path, ploidy,
                                    kmer_size=chip_smoke.K)
    opts = engine.GenotypeOptions(num_chains=4, burn_in=10, num_samples=20,
                                  random_seed=1)
    return tmp, genome, variants, truth, samples, ploidy, unit, opts


def test_kernels_match_plain_versions(cuda, small_unit):
    _, _, _, _, samples, ploidy, unit, opts = small_unit
    book, plan = chip_smoke.kernel_phase(unit, samples, ploidy, opts, cuda)
    assert not book.failures, book.failures
    assert book.osel[1] > 0 and book.gt[1] > 0


def test_genotype_unit_on_card(cuda, small_unit):
    tmp, genome, variants, truth, samples, ploidy, unit, opts = small_unit
    out = os.path.join(tmp, "genotypes.vcf")
    kernels.reset_launch_counts()
    summary = engine.genotype_unit(unit, samples, genome, ploidy, out, opts)
    # this unit's chunks are below the ragged-upload size: no unpack_bucket
    assert all(kernels.LAUNCHES[nm] > 0 for nm in chip_smoke.MAIN_KERNELS
               if nm != "unpack_bucket"), kernels.LAUNCHES
    assert summary["num_variants"] == len(variants)
    call_rate, conc, _ = chip_smoke.concordance(out, variants, truth)
    assert conc > 0.95 and call_rate > 0.7, (conc, call_rate)


def test_genotype_unit_joint_on_card(cuda, small_unit):
    tmp, genome, variants, truth, samples, ploidy, unit, opts = small_unit
    out = os.path.join(tmp, "genotypes_joint.vcf")
    kernels.reset_launch_counts()
    with chip_smoke.no_plain_rate_update():
        summary = engine.genotype_unit_joint(unit, samples, genome, ploidy,
                                             out, opts)
    assert all(kernels.LAUNCHES[nm] > 0 for nm in chip_smoke.JOINT_KERNELS
               if nm != "unpack_bucket"), kernels.LAUNCHES
    assert kernels.LAUNCHES["noise_rates"] == opts.burn_in + opts.num_samples
    assert summary["num_variants"] == len(variants)
    call_rate, conc, _ = chip_smoke.concordance(out, variants, truth)
    assert conc > 0.95 and call_rate > 0.7, (conc, call_rate)


def _random_chunk(rng, c, k, h, v, s, ch, a_cap):
    """A chunk's bucket tensors, tallies and masks, from a seed."""
    osp = tg.make_outcome_space(h)
    o = osp.num_outcomes
    na = rng.integers(2, a_cap + 1, (c, v)).astype(np.int16)
    member = rng.random((c, k, v, h)) < 0.3
    words = (h + 31) // 32
    packed = np.zeros((c, k, v, words * 32), bool)
    packed[..., :h] = member
    member_w = np.packbits(packed, axis=-1, bitorder="little").view(np.int32)
    ploidy = rng.integers(0, 3, (c, s)).astype(np.int8)
    tally = np.zeros((c, ch, s, o), np.int32)
    for ci in range(c):
        for si in range(s):
            valid = np.flatnonzero(osp.ploidy_mask[ploidy[ci, si]])
            p = rng.dirichlet(np.full(len(valid), 0.3), size=ch)
            for x in range(ch):
                tally[ci, x, si, valid] = rng.multinomial(30, p[x])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return dict(
        mult=t(rng.integers(0, 3, (c, k, h)).astype(np.uint8)),
        inter=t(rng.integers(0, 2, (c, k, s)).astype(np.uint8)),
        counts=t(rng.integers(0, 40, (c, k, s)).astype(np.uint8)),
        member=t(member_w),
        hap_allele=t((rng.integers(0, 100, (c, h, v)) % na[:, None, :])
                     .astype(np.int16)),
        num_alleles=t(na), ploidy=t(ploidy), tally=t(tally),
        w=t(rng.random((c, ch, k)) < 0.5),
        oa=t(osp.oa), ob=t(osp.ob),
    )


@pytest.mark.parametrize("h, t_top, coupled", [(4, None, True),
                                               (16, 8, False)])
@pytest.mark.parametrize("packed", [True, False])
def test_bucket_stats_matches_plain(cuda, h, t_top, coupled, packed):
    rng = np.random.default_rng(h)
    c, k, v, s, ch, a_cap = 5, 200, 3, 4, 3, 4
    chunk = _random_chunk(rng, c, k, h, v, s, ch, a_cap)
    o = chunk["oa"].shape[0]
    extra = dict(missing=None, mac_extra=None)
    if coupled:
        extra = dict(
            missing=tuple(torch.from_numpy(rng.random((c, s), np.float32))
                          for _ in range(3)),
            mac_extra=torch.from_numpy(
                rng.random((c, s, v, a_cap), np.float32)))
    args = lambda dev: [x.to(dev) for x in chunk.values()]  # noqa: E731
    tail = (a_cap, t_top or o, 0.99, 1.0,
            torch.tensor([0.9, 0.5, 0.2, 0.0]), packed)
    on_dev = lambda d, x: None if x is None else (  # noqa: E731
        tuple(y.to(d) for y in x) if isinstance(x, tuple) else x.to(d))
    got = kernels.bucket_stats(*args(cuda), *tail,
                               **{n: on_dev(cuda, x) for n, x in extra.items()})
    want = kernels.PLAIN["bucket_stats"](
        *args(cuda), *tail, **{n: on_dev(cuda, x) for n, x in extra.items()})
    _assert_stats_close(got, want)


def _assert_stats_close(got, want):
    """bucket_stats' outputs against its plain version's: integer fields
    equal, float fields within rtol 1e-5 (float16 ones 1e-3), atol 1e-5."""
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g.float(), w.float(), rtol=1e-3 if
                                       g.dtype == torch.float16 else 1e-5,
                                       atol=1e-5)
        else:
            assert torch.equal(g, w), i


@pytest.mark.parametrize("h, c, k, v", [(16, 5, 200, 3), (64, 1, 24, 4),
                                        (128, 1, 40, 2)])
@pytest.mark.parametrize("ties", [False, True])
def test_bucket_stats_top_t_matches_plain(cuda, h, c, k, v, ties):
    """The top-8 MAC selection past O = 64 against the plain version: an
    H16 chunk of several variants per cluster, and single clusters of
    O = 2,145 and 8,385 outcomes (their selection merges several
    partitions of outcomes); with ties, every (cluster, sample) holds many
    outcomes of equal total tally across the 8th and 9th places, so the
    order (ties to the lower index) decides the selection."""
    rng = np.random.default_rng(h + ties)
    s, ch, a_cap = 4, 3, 4
    chunk = _random_chunk(rng, c, k, h, v, s, ch, a_cap)
    if ties:
        o = chunk["oa"].shape[0]
        tally = np.zeros((c, ch, s, o), np.int32)
        # one chain's unit draws over 40 outcomes and 3 double ones: totals
        # 2 at three outcomes, 1 at the rest
        for ci in range(c):
            for si in range(s):
                picks = rng.choice(o, 40, replace=False)
                tally[ci, 0, si, picks] = 1
                tally[ci, 1, si, picks[:3]] = 1
        chunk["tally"] = torch.from_numpy(tally)
    args = [x.to(cuda) for x in chunk.values()]
    tail = (a_cap, 8, 0.99, 1.0, torch.tensor([0.9, 0.5, 0.2, 0.0]), True)
    _assert_stats_close(kernels.bucket_stats(*args, *tail),
                        kernels.PLAIN["bucket_stats"](*args, *tail))


def test_subsample_masks_matches_plain(cuda):
    """The masks bit-equal to the plain version on chunks whose clusters
    and slots include padding (padded clusters hold no valid slot), at K
    classes that are and are not multiples of four slots."""
    rng = np.random.default_rng(5)
    base, fold = tg._chain_base(prng.prng_key(23), 20)
    for c, k in ((37, 128), (5, 1023), (3, 1), (2, 20000)):
        lens = rng.integers(0, k + 1, c)
        lens[-2:] = 0                                     # padded clusters
        valid = np.arange(k)[None, :] < lens[:, None]
        cid = rng.integers(0, 2 ** 31, c)
        cid[-2:] = 0
        args = (base, fold, torch.from_numpy(cid).to(cuda),
                torch.from_numpy(valid).to(cuda), 0.1, tg._SUBSAMPLE_SALT)
        got = kernels.subsample_masks(*args)
        want = kernels.PLAIN["subsample_masks"](*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (c, k)
        assert not bool(got[-2:].any())


def test_kmer_cap_matches_plain(cuda):
    rng = np.random.default_rng(3)
    chunk = _random_chunk(rng, 4, 300, 40, 3, 2, 5, 4)
    base, fold = tg._chain_base(prng.prng_key(11), 5)
    args = (base, fold, (torch.arange(4) + 17).to(cuda), chunk["w"].to(cuda),
            chunk["member"].to(cuda), 40, 3, tg._CAP_SALT)
    got = kernels.kmer_cap(*args)
    want = kernels.PLAIN["kmer_cap"](*args)
    assert torch.equal(got, want)
    assert int(got.sum()) < int(chunk["w"].sum())


def _coupled_setup(dev, h=2, seed=5, ch=4, s=3):
    """Two coupled groups on two rank levels of h haplotypes and s samples:
    a parent (haplotype 0 keeps its child) with its child, and two sibling
    clusters sharing six k-mers in a pool, with the MAC fold."""
    rng = np.random.default_rng(seed)

    def cluster(cid, k, h, na, ploidy=2):
        mult = np.zeros((k, h), np.uint8)
        for i in range(k):
            mult[i, i % h] = 1
        return dict(
            mult=mult, inter_mult=np.zeros((k, s), np.uint8),
            counts=rng.poisson(9.0, (k, s)).astype(np.uint8),
            ploidy=np.full(s, ploidy, np.int8),
            hap_allele=np.arange(h, dtype=np.int16)[:, None] % na,
            num_alleles=np.array([na], np.int16),
            member=(mult > 0)[:, None, :], cover=[0], cluster_id=cid)

    lvl0 = [cluster(10, 40, h, 2), cluster(20, 30, h, 2)]
    lvl1 = [cluster(11, 36, h, 3), cluster(21, 30, h, 2)]
    buckets = [tbuckets.build_bucket(lv, (2, 64, h, 1), s).to_device(dev)
               for lv in (lvl0, lvl1)]
    osp = tg.make_outcome_space(h)
    keeps = np.zeros(h + 1, np.int8)
    keeps[0] = 1                                       # parent hap 0 keeps
    retain = np.zeros((2, osp.num_outcomes), np.int8)
    retain[0] = keeps[osp.oa] + keeps[osp.ob]
    # row 1 of each level holds the six shared k-mers (slots 0-5)
    q = np.arange(24, 30)
    info = dict(sh_idx=np.zeros((2, 8), np.int32),
                sh_slot=np.zeros((2, 8), np.int32),
                sh_valid=np.zeros((2, 8), bool), sh_mask=np.zeros((2, 64), bool))
    info["sh_idx"][1, :6] = q
    info["sh_slot"][1, :6] = np.arange(6)
    info["sh_valid"][1, :6] = True
    info["sh_mask"][1, q] = True
    infos = [info, info]
    tables = torch.from_numpy(np_build_count_log_prob_tables(
        np.full(s, 0.4), np.full(s, 6.0), np.full(s, 1e-3), 16)).to(dev)
    cfg = tg.GibbsConfig(num_chains=ch, burn_in=10, num_samples=30,
                         kmer_subsampling_rate=0.8, max_total_mult=12)
    return tg.nested_setup(
        prng.prng_key(seed), buckets,
        [np.full(2, -1, np.int32), np.array([0, -1], np.int32)],
        [np.zeros(2, np.int32), np.zeros(2, np.int32)],
        [np.zeros((2, osp.num_outcomes), np.int8), retain], infos, tables,
        [osp, osp], [cfg, cfg], num_pool=6, acaps=[2, 2],
        groups=(torch.tensor([0, 2, 4], dtype=torch.int32),
                torch.tensor([[0, 0], [1, 0], [0, 1], [1, 1]],
                             dtype=torch.int32)))


def _deep_setup(dev, n_levels=48, seed=7, ch=4, s=5):
    """One containment family of n_levels rank levels (a deletion and its
    n_levels - 1 children, one cluster per level, each child demoted
    through the deletion's outcome) beside a two-cluster family, H2."""
    rng = np.random.default_rng(seed)
    h = 2

    def cluster(cid, k):
        mult = np.zeros((k, h), np.uint8)
        for i in range(k):
            mult[i, i % h] = 1
        return dict(
            mult=mult, inter_mult=np.zeros((k, s), np.uint8),
            counts=rng.poisson(9.0, (k, s)).astype(np.uint8),
            ploidy=np.full(s, 2, np.int8),
            hap_allele=np.arange(h, dtype=np.int16)[:, None] % 2,
            num_alleles=np.array([2], np.int16),
            member=(mult > 0)[:, None, :], cover=[0], cluster_id=cid)

    osp = tg.make_outcome_space(h)
    keeps = np.array([0, 1, 0], np.int8)               # deletion on hap 0
    retain = (keeps[osp.oa] + keeps[osp.ob]).astype(np.int8)
    buckets, plv, prw, rts, members = [], [], [], [], []
    for l in range(n_levels):
        # levels 0-1 also hold the two-cluster family
        rows = [cluster(100 + l, 30)] + ([cluster(900 + l, 24)] if l < 2
                                         else [])
        c = len(rows)
        buckets.append(tbuckets.build_bucket(rows, (c, 64, h, 1), s)
                       .to_device(dev))
        plv.append(np.array([-1 if l == 0 else 0, -1 if l == 0 else 0][:c],
                            np.int32))
        prw.append(np.array([0, 1][:c], np.int32))
        rt = np.zeros((c, osp.num_outcomes), np.int8)
        rt[:] = retain if l > 0 else 0
        rts.append(rt)
        members.append((l, 0))
    tables = torch.from_numpy(np_build_count_log_prob_tables(
        np.full(s, 0.4), np.full(s, 6.0), np.full(s, 1e-3), 16)).to(dev)
    cfg = tg.GibbsConfig(num_chains=ch, burn_in=10, num_samples=30,
                         kmer_subsampling_rate=0.8, max_total_mult=12)
    groups = (torch.tensor([0, 2, 2 + n_levels], dtype=torch.int32),
              torch.tensor([(0, 1), (1, 1)] + members, dtype=torch.int32))
    return tg.nested_setup(
        prng.prng_key(seed), buckets, plv, prw, rts, [None] * n_levels,
        tables, [osp] * n_levels, [cfg] * n_levels, groups=groups)


def _agrees_with_plain(setup, got_t, got_m, bar=0.9):
    plain = setup.clone()
    kernels.PLAIN["nested_sweep"](plain.levels, plain.pool, plain.groups, 0,
                                  plain.num_iters, plain.burn_in)
    torch.cuda.synchronize()
    for lv, gt_l, gm in zip(plain.levels, got_t, got_m):
        same = (gt_l == lv.tally).all(dim=-1).all(dim=-1)       # [C, ch]
        assert same.float().mean() >= bar, same
        if gm is not None and bool(same.all()):
            torch.testing.assert_close(gm, lv.mac["acc"].sum(dim=1),
                                       rtol=1e-4, atol=1e-4)
        assert bool((gt_l.sum(-1) == setup.num_iters - setup.burn_in).all())


@pytest.mark.parametrize("h", [2, 16, "deep"])
def test_nested_sweep_matches_plain(cuda, h):
    """The coupled scan on the on-chip layout against its plain version:
    two two-level groups (H2, H16) and a 48-level containment family."""
    setup = _deep_setup(cuda) if h == "deep" else _coupled_setup(cuda, h)
    kernels.reset_launch_counts()
    got_t, _, got_m = setup.clone().run()
    assert kernels.LAUNCHES["nested_sweep"] == 1
    _agrees_with_plain(setup, got_t, got_m)


def test_nested_sweep_group_order_keeps_the_bits(cuda):
    """A launch over the groups in another order (equal sizes: the stable
    deepest-first order keeps the caller's) is bit-equal to the original
    order's: tallies, frequencies, outcomes, MAC sums and the pool."""
    setup = _coupled_setup(cuda, 2)
    offsets, members = setup.groups
    swapped = (offsets, torch.cat([members[2:], members[:2]]))
    runs = []
    for groups in (setup.groups, swapped):
        st = dataclasses.replace(setup.clone(), groups=groups)
        st.run()
        runs.append(st)
    torch.cuda.synchronize()
    a, b = runs
    assert torch.equal(a.pool, b.pool)
    for la, lb in zip(a.levels, b.levels):
        for f in ("tally", "freqs", "ocur"):
            assert torch.equal(getattr(la, f), getattr(lb, f)), f
        if la.mac is not None:
            assert torch.equal(la.mac["acc"], lb.mac["acc"])


def _noise_pairs(rng, dev, h, c=6, ch=4, s=5):
    """A class of c clusters x ch chains for the noise and joint steps:
    random llg/a/b, validity, ploidies, haplotype masks and keys."""
    osp = tg.make_outcome_space(h)
    o = osp.num_outcomes
    n = c * ch
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    hap_valid = rng.random((c, h)) < 0.8
    hap_valid[:, 0] = True
    f0 = hap_valid / hap_valid.sum(1, keepdims=True)
    base, fold = tg._chain_base(prng.prng_key(int(rng.integers(1 << 30))), ch)
    return dict(
        llg=t(-rng.random((n, s, o)).astype(np.float32) * 40),
        a=t(rng.integers(0, 30, (n, s, o)).astype(np.float32)),
        b=t(rng.integers(0, 200, (n, s, o)).astype(np.float32)),
        cv=t((rng.random(c) < 0.7).astype(np.float32)),
        fields=(t(rng.integers(0, 3, (c, s)).astype(np.int8)), t(hap_valid),
                t(rng.uniform(0.2, 0.8, c).astype(np.float32)),
                t(rng.random(c) < 0.5), t(np.arange(c, dtype=np.int64) + 100)),
        base=base, fold=fold,
        freqs=t(np.repeat(f0, ch, axis=0).astype(np.float32)),
        osp=tg.outcome_tensors(h, dev), ch=ch, s=s, o=o)


@pytest.mark.parametrize("h", [2, 16])
def test_joint_step_matches_plain(cuda, h):
    """Drawn outcomes agree on >= 99.9% of entries; the kernel's int32
    statistics and tally increments are exact for its own draws, and its
    frequencies match the plain version's where the draws agree."""
    p = _noise_pairs(np.random.default_rng(h), cuda, h)
    ch, s, o = p["ch"], p["s"], p["o"]
    rates = torch.full((ch, s), 2e-3, device=cuda)
    log_r = torch.log(rates)
    burn_in = 5
    agree = total = 0
    for t in (3, 5, 40):
        outs = []
        for fn in (kernels.joint_step, kernels.PLAIN["joint_step"]):
            cs = torch.zeros((ch, s), dtype=torch.int32, device=cuda)
            no = torch.zeros_like(cs)
            tally = torch.zeros(p["llg"].shape, dtype=torch.int32, device=cuda)
            f, osel = fn(p["llg"], p["a"], p["b"], p["cv"], log_r, rates,
                         *p["fields"], p["base"], p["fold"], p["freqs"].clone(),
                         t, p["osp"], cs, no, tally, burn_in)
            outs.append((f, osel.to(torch.int64), cs, no, tally))
        torch.cuda.synchronize()
        (f_k, o_k, cs_k, no_k, t_k), (f_p, o_p, _, _, _) = outs
        same = o_k == o_p
        agree += int(same.sum())
        total += same.numel()
        cvp = p["cv"].repeat_interleave(ch)[:, None]
        for x, want in ((p["a"], cs_k), (p["b"], no_k)):
            sel = (torch.gather(x, 2, o_k[..., None])[..., 0] * cvp).to(
                torch.int32).reshape(-1, ch, s).sum(0, dtype=torch.int32)
            assert torch.equal(sel, want)
        onehot = torch.zeros_like(t_k).scatter_(2, o_k[..., None], 1)
        assert torch.equal(t_k, onehot if t >= burn_in else 0 * onehot)
        pair_same = same.all(dim=1)
        torch.testing.assert_close(f_k[pair_same], f_p[pair_same],
                                   rtol=0, atol=1e-5)
    assert agree >= 0.999 * total, (agree, total)


def test_noise_rates_matches_plain(cuda):
    """Rates within 1e-5 relative on >= 99.9% of (chain, sample) entries
    (a last-bit logf/powf difference can flip an accept/reject); log rates,
    the trace column and the zeroed statistics as the plain version's."""
    rng = np.random.default_rng(9)
    ch, s, n_t, t = 64, 32, 350, 117
    _, k_noise = tg._chain_keys(prng.prng_key(3), ch, 0)
    stats = [torch.from_numpy(rng.integers(0, hi, (ch, s)).astype(np.int32))
             .to(cuda) for hi in (400, 90_000)]
    outs = []
    for fn in (kernels.noise_rates, kernels.PLAIN["noise_rates"]):
        cs, no = (x.clone() for x in stats)
        rates = torch.zeros((ch, s), device=cuda)
        log_r = torch.zeros_like(rates)
        trace = torch.full((ch, n_t, s), -1.0, device=cuda)
        fn(kernels.key_words(k_noise, cuda), cs, no, rates, log_r, trace, t,
           1.0, 0.01)
        outs.append((rates, log_r, trace, cs, no))
    torch.cuda.synchronize()
    (r_k, l_k, tr_k, cs_k, no_k), (r_p, l_p, tr_p, _, _) = outs
    close = torch.isclose(r_k, r_p, rtol=1e-5, atol=0)
    assert float(close.float().mean()) >= 0.999, r_k[~close]
    torch.testing.assert_close(l_k[close], l_p[close], rtol=1e-5, atol=1e-6)
    assert torch.equal(tr_k[:, t], r_k)
    assert bool((tr_k[:, :t] == -1).all() and (tr_k[:, t + 1:] == -1).all())
    assert not cs_k.any() and not no_k.any()


def test_gamma_draw_matches_plain(cuda):
    """Samples within 2e-6 relative (above float32's smallest normal) of the
    plain version on >= 99.99% of the elements, over log-uniform alpha in
    [1e-3, 2e5] and the prior shape 1.0; a NaN alpha draws NaN, as in JAX;
    every other sample is finite."""
    rng = np.random.default_rng(5)
    n, e = 256, 64
    keys = prng.split(prng.prng_key(7), n).to(cuda)
    lo, hi = np.log(chip_smoke.GAMMA_ALPHA)
    alpha = torch.from_numpy(np.exp(rng.uniform(lo, hi, (n, e)))
                             .astype(np.float32)).to(cuda)
    alpha[0] = 1.0
    alpha[1, :4] = float("nan")
    got = kernels.gamma_draw(keys, alpha)
    want = kernels.PLAIN["gamma_draw"](keys, alpha)
    torch.cuda.synchronize()
    nan = alpha.isnan()
    assert bool(got[nan].isnan().all() and want[nan].isnan().all())
    assert bool(torch.isfinite(got[~nan]).all())
    close = torch.isclose(got[~nan], want[~nan], rtol=chip_smoke.GAMMA_RTOL,
                          atol=chip_smoke.GAMMA_ATOL)
    assert float(close.float().mean()) >= chip_smoke.GAMMA_AGREE_MIN, (
        got[~nan][~close], want[~nan][~close])


def test_unpack_bucket_matches_plain(cuda):
    rng = np.random.default_rng(4)
    c, k, s, h, v, words = 37, 128, 13, 8, 3, 2
    lens = rng.integers(0, k + 1, c)
    lens[:3] = (0, k, 1)
    n = int(lens.sum())
    args = [torch.from_numpy(a).to(cuda) for a in (
        rng.integers(0, 256, (n, s)).astype(np.uint8),
        rng.integers(0, 256, (n, 2)).astype(np.uint8),
        rng.integers(0, 256, (n, h)).astype(np.uint8),
        rng.integers(-2 ** 31, 2 ** 31, (n, v, words)).astype(np.int32),
        lens.astype(np.int64), rng.integers(0, 2, s).astype(np.int64))]
    got = kernels.unpack_bucket(*args, k)
    want = kernels.PLAIN["unpack_bucket"](*args, k)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("p", [4, 3])
def test_lane_lookup_matches_plain(cuda, p):
    """A sorted table of 100,003 keys (ties on hi, pad rows at the end) and
    ascending queries, half of them hits: payload rows byte-equal."""
    rng = np.random.default_rng(p)
    m, pad = 100_003, 5
    hi = np.sort(rng.integers(0, 2**54, m)).astype(np.int64)
    hi[1:400:2] = hi[:400:2]
    lo = rng.integers(0, 2**55, m).astype(np.int64) * 2
    order = np.lexsort((lo, hi))
    keys = np.full((m + pad, 2), np.iinfo(np.int64).max, np.int64)
    keys[:m, 0], keys[:m, 1] = hi[order], lo[order]
    valid = np.arange(m + pad) < m
    payload = rng.integers(0, 256, (m + pad, p)).astype(np.uint8)
    rows = np.sort(rng.integers(0, m, 50_000))
    q = keys[rows].copy()
    q[::2, 1] += 1                                   # misses: odd lo
    expect = np.where((np.arange(len(rows)) % 2 == 1)[:, None], payload[rows],
                      0).astype(np.uint8)
    # below every key, and a pad row's key
    q = np.concatenate([[[-1, -1], [0, 0]], q, keys[-1:]])
    args = [torch.from_numpy(a).to(cuda) for a in (keys, payload, valid, q)]
    got = kernels.lane_lookup(*args)
    want = kernels.PLAIN["lane_lookup"](*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint8 and got.shape == (len(q), p)
    assert torch.equal(got, want)
    assert np.array_equal(got[2:-1].cpu().numpy(), expect)
    assert not got[-1].any() and not got[:2].any()


@pytest.mark.parametrize("h", [1, 10])
def test_bloom_query_matches_plain(cuda, h):
    rng = np.random.default_rng(h)
    n_words, n = 1 << 20, 200_000
    bits = torch.from_numpy(rng.integers(-2**31, 2**31, n_words)
                            .astype(np.int32)).to(cuda)
    word = torch.from_numpy(rng.integers(0, n_words, (h, n))
                            .astype(np.int32)).to(cuda)
    shift = torch.from_numpy(rng.integers(0, 32, (h, n))
                             .astype(np.int32)).to(cuda)
    got = kernels.bloom_query(bits, word, shift)
    want = kernels.PLAIN["bloom_query"](bits, word, shift)
    torch.cuda.synchronize()
    assert got.dtype == torch.bool and torch.equal(got, want)
    assert bool(want.any()) and not bool(want.all())


def test_gather_counts_device_lookup_on_card(cuda, small_unit, monkeypatch):
    """BT_DEVICE_LOOKUP=1 on the card: the counts of the host path, one
    lane_lookup launch per KMC batch."""
    _, _, _, _, samples, _, unit, _ = small_unit
    _, host = engine.gather_sample_counts(unit, samples)
    monkeypatch.setenv("BT_DEVICE_LOOKUP", "1")
    kernels.reset_launch_counts()
    _, dev = engine.gather_sample_counts(unit, samples, 2)
    assert np.array_equal(dev, host)
    assert kernels.LAUNCHES["lane_lookup"] == chip_smoke.stream_batches(
        samples)


# -- the global-memory variants: shapes past the card's shared memory ------

def _launched(name, fn):
    """fn()'s result, asserting that it launched name's global-memory
    variant and not its shared layout."""
    kernels.reset_launch_counts()
    out = fn()
    glob = kernels.GLOBAL[name]
    assert kernels.LAUNCHES[glob] > 0 and kernels.LAUNCHES[name] == 0, (
        {nm: n for nm, n in kernels.LAUNCHES.items() if n})
    return out


@pytest.mark.parametrize("h, s", [(64, 25), (64, 30), (64, 64), (512, 30)])
@pytest.mark.parametrize("name", ["gibbs_sweep", "noise_step", "joint_step"])
def test_gibbs_global_variants_match_plain(cuda, name, h, s):
    """The Gibbs-team kernels at H64 from S = 25 (the LL in device memory)
    and at H512 x 30 samples (the whole team there) against their plain
    versions, at chip_smoke.py's bars: drawn outcomes agree on >= 99.9%,
    frequencies within 1e-5 where a pair's draws agree, and the noise
    kernels' int32 statistics and tallies exact for their own draws. At
    H512 the plain version's block sums and their cumsum (a parallel scan
    on the card) round the 2,060 64-outcome blocks in another order than
    the kernel's running sums, so a uniform near a block boundary can pick
    the next block: there the drawn outcomes agree on >= 99%."""
    c, ch = (4, 3) if h == 64 else (2, 4)
    p = _noise_pairs(np.random.default_rng(h + s), cuda, h, c=c, ch=ch, s=s)
    o = p["o"]
    rates = torch.full((ch, s), 2e-3, device=cuda)
    log_r = torch.log(rates)
    cvp = p["cv"].repeat_interleave(ch)[:, None]
    agree = total = 0
    for t in (3, 40):
        outs = []
        for fn in (getattr(kernels, name), kernels.PLAIN[name]):
            cs = torch.zeros((ch, s), dtype=torch.int32, device=cuda)
            no = torch.zeros_like(cs)
            tally = torch.zeros(p["llg"].shape, dtype=torch.int32,
                                device=cuda)
            if name == "gibbs_sweep":
                args = (p["llg"], *p["fields"], p["base"], p["fold"],
                        p["freqs"].clone(), t, t + 1, 0, p["osp"], tally)
            else:
                args = (p["llg"], p["a"], p["b"], p["cv"], log_r, rates,
                        *p["fields"], p["base"], p["fold"],
                        p["freqs"].clone(), t, p["osp"], cs, no)
                args += (tally, 0) if name == "joint_step" else ()
            if fn is kernels.PLAIN[name]:
                res = fn(*args)
            else:
                res = _launched(name, lambda: fn(*args))
            torch.cuda.synchronize()
            f, osel = res[0], res[-1]
            outs.append((f, osel.to(torch.int64), cs, no, tally))
        (f_k, o_k, cs_k, no_k, t_k), (f_p, o_p, _, _, _) = outs
        same = o_k == o_p
        agree += int(same.sum())
        total += same.numel()
        pair_same = same.all(dim=1)
        torch.testing.assert_close(f_k[pair_same], f_p[pair_same], rtol=0,
                                   atol=chip_smoke.FREQ_ATOL)
        if name != "noise_step":
            onehot = torch.zeros_like(t_k).scatter_(2, o_k[..., None], 1)
            assert torch.equal(t_k, onehot)
        if name != "gibbs_sweep":
            for x, want in ((p["a"], cs_k), (p["b"], no_k)):
                sel = (torch.gather(x, 2, o_k[..., None])[..., 0] * cvp).to(
                    torch.int32).reshape(-1, ch, s).sum(0, dtype=torch.int32)
                assert torch.equal(sel, want)
    assert o == h * (h + 1) // 2 + h + 1
    bar = chip_smoke.OSEL_AGREE_MIN if h == 64 else 0.99
    assert agree >= bar * total, (agree, total)


def test_nested_sweep_global_matches_plain(cuda):
    """The coupled scan on H64 levels at 30 samples (the team's LL in
    device memory) against its plain version, at the bars of
    test_nested_sweep_matches_plain."""
    setup = _coupled_setup(cuda, 64, s=30)
    got_t, _, got_m = _launched("nested_sweep", lambda: setup.clone().run())
    _agrees_with_plain(setup, got_t, got_m)


def test_kmer_cap_global_matches_plain(cuda):
    """The cap at K = 32,768 slots (the sort keys in device memory): masks
    bit-equal to the plain version's, and the cap binds."""
    rng = np.random.default_rng(6)
    k = 32768
    chunk = _random_chunk(rng, 2, k, 8, 2, 1, 2, 4)
    base, fold = tg._chain_base(prng.prng_key(13), 2)
    args = (base, fold, (torch.arange(2) + 5).to(cuda), chunk["w"].to(cuda),
            chunk["member"].to(cuda), 8, 40, tg._CAP_SALT)
    got = _launched("kmer_cap", lambda: kernels.kmer_cap(*args))
    want = kernels.PLAIN["kmer_cap"](*args)
    assert torch.equal(got, want)
    assert int(got.sum()) < int(chunk["w"].sum())


@pytest.mark.parametrize("h, k, is_global", [(64, 20000, False),
                                              (128, 512, True)])
@pytest.mark.parametrize("packed", [True, False])
def test_bucket_stats_global_matches_plain(cuda, packed, h, k, is_global):
    """Stats of an H64 chunk of 20,000 k-mer slots (its k-mer sets read as
    bit words from device memory, so the shared layout) and of an H128
    chunk (its 7·O outcome words past shared memory, in device memory: the
    global-memory variant) against the plain version, at the bars of
    test_bucket_stats_matches_plain."""
    rng = np.random.default_rng(8)
    c, v, s, ch, a_cap = 2, 2, 3, 3, 4
    chunk = _random_chunk(rng, c, k, h, v, s, ch, a_cap)
    args = [x.to(cuda) for x in chunk.values()]
    tail = (a_cap, 8, 0.99, 1.0, torch.tensor([0.9, 0.5, 0.2]), packed)
    kernels.reset_launch_counts()
    got = kernels.bucket_stats(*args, *tail)
    assert kernels.LAUNCHES[kernels.GLOBAL["bucket_stats"]] == is_global
    assert kernels.LAUNCHES["bucket_stats"] == (not is_global)
    _assert_stats_close(got, kernels.PLAIN["bucket_stats"](*args, *tail))


@pytest.mark.parametrize("h, s, k", [(2, 13, 128), (16, 30, 2048),
                                     (256, 30, 24), (4096, 2, 24)])
def test_ll_noise_terms_matches_plain(cuda, h, s, k):
    """LL and noise terms against the plain version, within chip_smoke.py's
    LL bars, in the one layout: the bulk class (H2/K128), a class whose K
    spans many k-mer tiles (H16/K2048 at 30 samples), H256 at 30 samples
    (outcome tables past shared memory) and H4096, the largest class the
    compiler's beam forms at 30 samples x 32 sample haplotypes (3,840
    paths; its multiplicities read in place)."""
    rng = np.random.default_rng(h)
    c, ch = 3, 20 if h < 256 else 2
    osp = tg.outcome_tensors(h, cuda)
    t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    args = (t(rng.integers(0, 3, (c, k, h)).astype(np.uint8)),
            t(rng.integers(0, 2, (c, k, s)).astype(np.uint8)),
            t(rng.integers(0, 40, (c, k, s)).astype(np.uint8)),
            t(rng.random((c, ch, k)) < 0.6),
            t(np_build_count_log_prob_tables(
                np.full(s, 0.4), np.full(s, 6.0), np.full(s, 1e-3), 16)
              .astype(np.float32)), 16, osp.oa32, osp.ob32)
    for noise in (False, True):
        kernels.reset_launch_counts()
        got = kernels.ll_noise_terms(*args, include_noise_row=not noise,
                                     noise_terms=noise)
        assert kernels.LAUNCHES["ll_noise_terms"] == 1
        want = kernels.PLAIN["ll_noise_terms"](
            *args, include_noise_row=not noise, noise_terms=noise)
        torch.cuda.synchronize()
        pairs = [(got[0], want[0])] + (list(zip(got[1], want[1])) if noise
                                       else [])
        for g, w in pairs:
            assert bool(torch.isfinite(g).all())
            torch.testing.assert_close(g, w, rtol=chip_smoke.LL_RTOL,
                                       atol=chip_smoke.LL_ATOL)
        # A and B are integer sums: exact
        for g, w in pairs[1:3] if noise else []:
            assert torch.equal(g, w)


def test_genotype_unit_mesh_on_card(cuda, small_unit):
    """genotype_unit and genotype_unit_joint over a mesh of two shards
    (round-robin over the visible cards) write the one-device VCFs."""
    tmp, genome, _, _, samples, ploidy, unit, opts = small_unit
    for run in (engine.genotype_unit, engine.genotype_unit_joint):
        paths = []
        for ndev in (1, 2):
            out = os.path.join(tmp, f"{run.__name__}_{ndev}.vcf")
            with chip_smoke.no_plain_rate_update():
                run(unit, samples, genome, ploidy, out,
                    dataclasses.replace(opts, num_devices=ndev))
            paths.append(out)
        one, two = (open(p, "rb").read() for p in paths)
        assert one == two


# -- the block-of-pairs step: every packing, sample count and layout ------

def _step_args(name, p, t, tally, burn_in, log_r, rates):
    if name == "gibbs_sweep":
        return (p["llg"], *p["fields"], p["base"], p["fold"],
                p["freqs"].clone(), t, t + 1, burn_in, p["osp"], tally)
    cs = torch.zeros(rates.shape, dtype=torch.int32, device=rates.device)
    args = (p["llg"], p["a"], p["b"], p["cv"], log_r, rates, *p["fields"],
            p["base"], p["fold"], p["freqs"].clone(), t, p["osp"], cs,
            torch.zeros_like(cs))
    return args + ((tally, burn_in) if name == "joint_step" else ())


@pytest.mark.parametrize("s", [1, 13, 30])
@pytest.mark.parametrize("h", [2, 4, 8, 16, 64])
@pytest.mark.parametrize("name", ["gibbs_sweep", "noise_step", "joint_step"])
def test_gibbs_step_classes_match_plain(cuda, name, h, s):
    """Each Gibbs kernel on a class of every packing and layout (H2, H4:
    several pairs per block, logits in registers; H8: several pairs, the
    shared exp cache; H16: a block per pair, every exp cached; H64: the LL
    in device memory, every exp cached up to 13 samples, the chosen
    block's at 30) and S = 1, 13, 30, over 37 clusters x 4 chains (a
    ragged last block), against its plain version at chip_smoke.py's bars:
    drawn outcomes agree on >= 99.9%, frequencies within 1e-5 where a
    pair's draws agree, tallies and int32 statistics exact for the
    kernel's own draws."""
    p = _noise_pairs(np.random.default_rng(100 * h + s), cuda, h, c=37, ch=4,
                     s=s)
    ch, o = p["ch"], p["o"]
    rates = torch.full((ch, s), 2e-3, device=cuda)
    log_r = torch.log(rates)
    cvp = p["cv"].repeat_interleave(ch)[:, None]
    agree = total = 0
    for t in (3, 40, 41):
        outs = []
        for fn in (getattr(kernels, name), kernels.PLAIN[name]):
            tally = torch.zeros(p["llg"].shape, dtype=torch.int32,
                                device=cuda)
            args = _step_args(name, p, t, tally, 40, log_r, rates)
            res = fn(*args)
            torch.cuda.synchronize()
            stats = args[-4:-2] if name == "joint_step" else args[-2:]
            outs.append((res[0], res[-1].to(torch.int64), stats, tally))
        (f_k, o_k, (cs_k, no_k), t_k), (f_p, o_p, _, _) = outs
        same = o_k == o_p
        agree += int(same.sum())
        total += same.numel()
        pair_same = same.all(dim=1)
        torch.testing.assert_close(f_k[pair_same], f_p[pair_same], rtol=0,
                                   atol=chip_smoke.FREQ_ATOL)
        if name != "noise_step":
            onehot = torch.zeros_like(t_k).scatter_(2, o_k[..., None], 1)
            assert torch.equal(t_k, onehot if t >= 40 else 0 * onehot)
        if name != "gibbs_sweep":
            for x, want in ((p["a"], cs_k), (p["b"], no_k)):
                sel = (torch.gather(x, 2, o_k[..., None])[..., 0] * cvp).to(
                    torch.int32).reshape(-1, ch, s).sum(0, dtype=torch.int32)
                assert torch.equal(sel, want)
    assert agree >= chip_smoke.OSEL_AGREE_MIN * total, (agree, total)


@pytest.mark.parametrize("h, s", [(2, 13), (8, 30), (16, 1), (64, 13),
                                  (64, 30)])
def test_gibbs_sweep_windows_equal_whole_scan(cuda, h, s):
    """A scan split into windows, with the burn-in inside a window, gives
    the whole scan's bits (the tally kept in shared memory per launch and
    added into the device tally at its end; at H64 x 30 samples, where it
    does not fit, written to device memory directly), and the whole scan's
    tally agrees with the plain version's on >= 90% of pairs."""
    p = _noise_pairs(np.random.default_rng(7 * h + s), cuda, h, c=11, ch=4,
                     s=s)
    iters, burn_in = 60, 25

    def scan(fn, windows):
        f = p["freqs"].clone()
        tally = torch.zeros(p["llg"].shape, dtype=torch.int32, device=cuda)
        for t0, t1 in windows:
            f, _, osel = fn(p["llg"], *p["fields"], p["base"], p["fold"], f,
                            t0, t1, burn_in, p["osp"], tally)
        torch.cuda.synchronize()
        return f, tally, osel

    whole = scan(kernels.gibbs_sweep, [(0, iters)])
    split = scan(kernels.gibbs_sweep, [(0, 10), (10, 40), (40, iters)])
    for x, y in zip(whole, split):
        assert torch.equal(x, y)
    assert bool((whole[1].sum(-1) == iters - burn_in).all())
    plain = scan(kernels.PLAIN["gibbs_sweep"], [(0, iters)])
    same = (plain[1] == whole[1]).all(dim=-1).all(dim=-1)
    assert same.float().mean() >= 0.9, same
