"""The port's coupled scan (gibbs.genotype_nested) against the JAX
package's, on the CPU, from the same inputs:

  * "segdup": the two-sibling family of tests/test_coupling_adversarial.py
    (shared multicluster k-mers in a pool, the MAC sibling fold);
  * "segdup_padded": the same with a padded row on each level, which the
    port's scan leaves unsampled (zero tallies) and the JAX package's runs;
  * "containment": the deletion-over-SNV unit of tests/test_nested.py
    (the child's ploidy demoted through its parent's retain table);
  * "capped": the same unit with a per-(haplotype, variant) cap of 8, so
    the parent's level takes the exact k-mer cap.

The containment inputs are the arguments the JAX engine passes to
genotype_nested, captured while it genotypes the unit. Bars: subsample
(+ cap) masks, initial outcomes and the initial pool bit-equal; tallies
equal on >= 95% of the (cluster, chain) pairs and, with one iteration,
the drawn outcomes equal on >= 99.9% of the entries (exp/log differ from
XLA's in the last bits); the MAC corrections within 1e-4 relative on every
cluster whose chains' tallies all agree. Tallies and MAC corrections are
compared on the real clusters; padded rows' tallies are zero in the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayestyper_tpu.model import gibbs as jg
from bayestyper_tpu.model.buckets import build_bucket
from bayestyper_tpu.ops.distributions import np_build_count_log_prob_tables
from bayestyper_tpu_torch.model import buckets as tbuckets
from bayestyper_tpu_torch.model import gibbs as tg
from tests import test_coupling_adversarial as tca


def _segdup_args(num_chains=4, burn_in=5, num_samples=15, c_pad=1):
    """genotype_nested's arguments for the segdup family: one cluster per
    rank level, ten shared k-mers; c_pad - 1 padded rows per level."""
    rng = np.random.default_rng(2)
    n_private, n_shared = 2, 10
    clusters, _, _ = tca._family(rng, n_private, n_shared)
    tables = np_build_count_log_prob_tables(
        np.full(2, 9.0 / 24.0), np.full(2, 81.0 / 15.0), np.full(2, 1e-3),
        max_multiplicity=16).astype(np.float32)
    k_pad = 32
    buckets, infos = [], []
    for ci, cl in enumerate(clusters):
        buckets.append(build_bucket([dict(
            mult=cl.mult.astype(np.uint8), inter_mult=cl.inter.astype(np.uint8),
            counts=cl.counts.astype(np.uint8), ploidy=cl.ploidy.astype(np.int8),
            hap_allele=cl.hap_allele.astype(np.int16),
            num_alleles=cl.num_alleles.astype(np.int16),
            member=np.ones((cl.k, 1, cl.h), bool), cover=[0],
            cluster_id=100 + ci)], (c_pad, k_pad, 2, 1), 2).device_arrays())
        q = np.arange(cl.k - n_shared, cl.k)
        info = dict(sh_idx=np.zeros((c_pad, 16), np.int32),
                    sh_slot=np.zeros((c_pad, 16), np.int32),
                    sh_valid=np.zeros((c_pad, 16), bool),
                    sh_mask=np.zeros((c_pad, k_pad), bool))
        info["sh_idx"][0, :n_shared] = q
        info["sh_slot"][0, :n_shared] = np.arange(n_shared)
        info["sh_valid"][0, :n_shared] = True
        info["sh_mask"][0, q] = True
        infos.append({k: jnp.asarray(v) for k, v in info.items()})
    osp = jg.make_outcome_space(2)
    cfg = jg.GibbsConfig(num_chains=num_chains, burn_in=burn_in,
                         num_samples=num_samples, kmer_subsampling_rate=0.8,
                         max_total_mult=12)
    args = (jax.random.PRNGKey(9), tuple(buckets),
            (jnp.full(c_pad, -1, jnp.int32),) * 2,
            (jnp.zeros(c_pad, jnp.int32),) * 2,
            (jnp.zeros((c_pad, osp.num_outcomes), jnp.int8),) * 2, tuple(infos),
            jnp.asarray(tables), (osp, osp), (cfg, cfg))
    return args, dict(num_pool=n_shared, acaps=(2, 2))


def _captured_args(tmp_path_factory, cap):
    """The arguments the JAX engine passes to genotype_nested for the
    deletion-over-SNV unit of tests/test_nested.py."""
    from bayestyper_tpu import engine as jengine
    from tests import test_nested

    captured = {}
    real = jg.genotype_nested

    def capture(*args, **kwargs):
        captured["args"], captured["kwargs"] = args, kwargs
        return real(*args, **kwargs)

    real_opts = jengine.GenotypeOptions

    def opts(**kw):
        kw.update(num_chains=4, burn_in=6, num_samples=14,
                  max_haplotype_variant_kmers=cap)
        return real_opts(**kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(jg, "genotype_nested", capture)
    mp.setattr(test_nested, "GenotypeOptions", opts)
    try:
        tmp = tmp_path_factory.mktemp(f"nested_cap{cap}")
        try:
            test_nested.test_deletion_spanning_snv(tmp)
        except AssertionError:
            pass  # short chains may miss the calls the JAX test asserts
    finally:
        mp.undo()
    return captured["args"], captured["kwargs"]


def _groups(buckets, plv, prw, infos):
    """The coupled groups the port's scan takes, which the JAX package's
    arguments do not carry: real clusters joined by a containment parent or
    a shared pool slot, each group in level order."""
    root = {}

    def find(x):
        while root.setdefault(x, x) != x:
            x = root[x]
        return x

    for l, b in enumerate(buckets):
        for r in np.flatnonzero(np.asarray(b.cluster_valid)).tolist():
            find((l, r))
            links = [find((int(plv[l][r]), int(prw[l][r])))] \
                if plv[l][r] >= 0 else []
            if infos[l] is not None:
                ok = np.asarray(infos[l]["sh_valid"][r])
                links += [find(("slot", int(x)))
                          for x in np.asarray(infos[l]["sh_slot"][r])[ok]]
            for j in links:
                root[find((l, r))] = j
    groups = {}
    for lr in sorted(x for x in root if x[0] != "slot"):
        groups.setdefault(find(lr), []).append(lr)
    offsets = np.cumsum([0] + [len(g) for g in groups.values()])
    members = [lr for g in groups.values() for lr in g]
    assert all(len({l for l, _ in g}) == len(g) for g in groups.values())
    return (torch.tensor(offsets, dtype=torch.int32),
            torch.tensor(members, dtype=torch.int32).reshape(-1, 2))


def _port_args(args, kwargs):
    """The JAX package's genotype_nested arguments as the port's."""
    (key, buckets, plv, prw, rts, infos, tables, outcomes, cfgs) = args
    fields = [f.name for f in dataclasses.fields(tg.GibbsConfig)]
    to_np = lambda x: None if x is None else np.asarray(x)  # noqa: E731
    return (
        torch.from_numpy(np.asarray(key).astype(np.int64)),
        [tbuckets.bucket_from_numpy(b, "cpu") for b in buckets],
        [to_np(x) for x in plv], [to_np(x) for x in prw],
        [to_np(x) for x in rts],
        [None if i is None else {k: np.asarray(v) for k, v in i.items()}
         for i in infos],
        torch.from_numpy(np.asarray(tables)), list(outcomes),
        [tg.GibbsConfig(**{f: getattr(c, f) for f in fields}) for c in cfgs],
    ), dict(num_pool=kwargs.get("num_pool", 0),
            acaps=None if kwargs.get("acaps") is None
            else list(kwargs["acaps"]),
            groups=_groups(buckets, [to_np(x) for x in plv],
                           [to_np(x) for x in prw], infos))


@pytest.fixture(scope="module",
                params=["segdup", "segdup_padded", "containment", "capped"])
def case(request, tmp_path_factory):
    if request.param.startswith("segdup"):
        args, kwargs = _segdup_args(
            c_pad=2 if request.param == "segdup_padded" else 1)
    else:
        args, kwargs = _captured_args(
            tmp_path_factory, 8 if request.param == "capped" else 500)
    return request.param, args, kwargs


def test_case_exercises_its_path(case):
    name, args, kwargs = case
    cfgs, infos, plv = args[8], args[5], args[2]
    if name.startswith("segdup"):
        assert kwargs["num_pool"] > 0 and all(i is not None for i in infos)
    else:
        assert any((np.asarray(p) >= 0).any() for p in plv)
    assert any(c.apply_cap for c in cfgs) == (name == "capped")
    padded = [not np.asarray(b.cluster_valid).all() for b in args[1]]
    assert all(padded) == (name == "segdup_padded")


def test_setup_bit_equal(case):
    """Per-level masks, initial outcomes and the initial pool."""
    _, args, kwargs = case
    _, want_ws, _ = jg.genotype_nested(*args, **kwargs)
    targs, tkw = _port_args(args, kwargs)
    setup = tg.nested_setup(*targs, **tkw)
    key, buckets, outcomes = args[0], args[1], args[7]
    ch = args[8][0].num_chains
    pool = np.zeros(setup.pool.shape, np.int64)
    for l, (b, lv) in enumerate(zip(buckets, setup.levels)):
        np.testing.assert_array_equal(setup.ws[l].numpy(),
                                      np.asarray(want_ws[l]))
        # the JAX package's initial outcomes (gibbs.py:1376-1402)
        valid = jnp.asarray(outcomes[l].ploidy_mask)[b.ploidy.astype(jnp.int32)]
        logits = jnp.where(valid, 0.0, jg.NEG_INF)
        k_init = jax.random.fold_in(jax.random.fold_in(key, jnp.uint32(l)),
                                    jnp.uint32(0x696E6974))
        o_init = np.stack([
            np.stack([np.asarray(jg._sample_outcomes(jax.random.fold_in(
                jax.random.fold_in(k_init, jnp.uint32(int(cid))),
                jnp.uint32(x)), logits[ci])) for x in range(ch)])
            for ci, cid in enumerate(np.asarray(b.cluster_id))])
        o_init = np.where(np.asarray(b.cluster_valid)[:, None, None], o_init,
                          outcomes[l].num_outcomes - 1)
        np.testing.assert_array_equal(lv.ocur.numpy(), o_init)
        if lv.sh is not None:
            dip = lv.sh["dip"].numpy()
            for ci in range(o_init.shape[0]):
                for qi, (slot, ok) in enumerate(zip(lv.sh["slot"][ci].tolist(),
                                                    lv.sh["valid"][ci].tolist())):
                    if ok:
                        pool[slot] += dip[ci, qi][o_init[ci]]
    np.testing.assert_array_equal(setup.pool.numpy(), pool)


@pytest.mark.parametrize("one_iteration", [False, True])
def test_tallies_and_mac_extras(case, one_iteration):
    name, args, kwargs = case
    if one_iteration:
        cfgs = tuple(dataclasses.replace(c, burn_in=0, num_samples=1)
                     for c in args[8])
        args = args[:8] + (cfgs,)
    want_t, _, want_m = jg.genotype_nested(*args, **kwargs)
    targs, tkw = _port_args(args, kwargs)
    got_t, _, got_m = tg.genotype_nested(*targs, **tkw)
    pairs = agree = entries = same_entries = 0
    for l in range(len(got_t)):
        wt, gt_l = np.asarray(want_t[l]), got_t[l].numpy()
        assert gt_l.dtype == np.int32 and gt_l.shape == wt.shape
        # padded rows are not sampled; their tallies are never emitted
        real = np.asarray(args[1][l].cluster_valid)
        assert (gt_l[~real] == 0).all()
        wt, gt_l = wt[real], gt_l[real]
        same = (wt == gt_l).all(axis=(-2, -1))                  # [C, ch]
        pairs += same.size
        agree += same.sum()
        entries += (wt == gt_l).all(axis=-1).size
        same_entries += (wt == gt_l).all(axis=-1).sum()
        if want_m[l] is not None:
            ok = same.all(axis=1)
            np.testing.assert_allclose(got_m[l].numpy()[real][ok],
                                       np.asarray(want_m[l])[real][ok],
                                       rtol=1e-4, atol=1e-6)
        else:
            assert got_m[l] is None
    if one_iteration:
        assert same_entries >= 0.999 * entries, (same_entries, entries)
    else:
        assert agree >= 0.95 * pairs, (agree, pairs)


def test_groups_order_deepest_first_and_stable():
    """order_groups: sizes descending, equal sizes in the caller's order,
    every group's members kept together and in order."""
    from bayestyper_tpu_torch import kernels

    sizes = [2, 3, 1, 3, 2, 5]
    offsets = torch.tensor(np.cumsum([0] + sizes), dtype=torch.int32)
    members = torch.arange(2 * sum(sizes), dtype=torch.int32).reshape(-1, 2)
    off, mem = kernels.order_groups((offsets, members))
    assert off.dtype == mem.dtype == torch.int32
    got = [mem[off[g]:off[g + 1]].tolist() for g in range(len(sizes))]
    order = [5, 1, 3, 0, 4, 2]
    assert got == [members[offsets[g]:offsets[g + 1]].tolist() for g in order]


def _port_setup(case):
    _, args, kwargs = case
    targs, tkw = _port_args(args, kwargs)
    return tg.nested_setup(*targs, **tkw)


def test_plain_scan_ignores_the_group_order(case):
    """The plain coupled scan over the deepest-first order gives the
    original order's tallies, frequencies, outcomes, MAC sums and pool."""
    from bayestyper_tpu_torch import kernels

    setup = _port_setup(case)
    runs = []
    for groups in (setup.groups, kernels.order_groups(setup.groups)):
        st = dataclasses.replace(setup.clone(), groups=groups)
        kernels.PLAIN["nested_sweep"](st.levels, st.pool, st.groups, 0,
                                      st.num_iters, st.burn_in)
        runs.append(st)
    a, b = runs
    assert torch.equal(a.pool, b.pool)
    for la, lb in zip(a.levels, b.levels):
        for f in ("tally", "freqs", "ocur"):
            assert torch.equal(getattr(la, f), getattr(lb, f)), f
        if la.mac is not None:
            assert torch.equal(la.mac["acc"], lb.mac["acc"])


def test_dense_pool_ranges_cover_every_slot_once(case):
    """nested_tables: each group's shared rows map to a dense range of its
    own, the ranges together hold every slot the groups' valid rows use
    once, and each member's parent is an earlier member of its group."""
    from bayestyper_tpu_torch import kernels

    setup = _port_setup(case)
    offsets, members = kernels.order_groups(setup.groups)
    rows, qrows, pofs, gslot = kernels.nested_tables(setup.levels,
                                                     (offsets, members))
    assert rows.shape == (members.shape[0], 4)
    assert torch.equal(rows[:, :2], members)
    assert int(rows[:, 3].sum()) == qrows.shape[0]
    used = set()
    q_at = 0
    for g in range(offsets.numel() - 1):
        lo, hi = int(pofs[g]), int(pofs[g + 1])
        mine = gslot[lo:hi].tolist()
        assert len(set(mine)) == len(mine) and not used & set(mine)
        used |= set(mine)
        for i, m in enumerate(range(int(offsets[g]), int(offsets[g + 1]))):
            l, r, parent, nq = rows[m].tolist()
            assert -1 <= parent < i
            lv = setup.levels[l]
            if parent >= 0:
                assert rows[int(offsets[g]) + parent, :2].tolist() == [
                    int(lv.parent_level[r]), int(lv.parent_row[r])]
            want = ([] if lv.sh is None else
                    torch.nonzero(lv.sh["valid"][r])[:, 0].tolist())
            assert qrows[q_at:q_at + nq, 0].tolist() == want
            for q, local in qrows[q_at:q_at + nq].tolist():
                assert 0 <= local < hi - lo
                assert mine[local] == int(lv.sh["slot"][r, q])
            q_at += nq
    valid_slots = {int(lv.sh["slot"][r, q])
                   for l, r in members.tolist()
                   for lv in [setup.levels[l]] if lv.sh is not None
                   for q in torch.nonzero(lv.sh["valid"][r])[:, 0].tolist()}
    assert used == valid_slots
