"""chip_smoke.py's accounting on the CPU: the Gibbs step's operation count
by type, the bound over the float32 and INT32 rates, the per-class launch
counting, kernel_ab.py's fingerprints and step_sections.py's marks."""

import pytest
import torch

import chip_smoke
import kernel_ab
from bayestyper_tpu_torch import kernels


@pytest.mark.parametrize("n, s, o, h", [(1, 13, 6, 2), (40, 30, 45, 8),
                                        (3, 1, 2145, 64)])
def test_step_ops_counts_every_hash_and_lgamma(n, s, o, h):
    flt, ints = chip_smoke.step_ops(n, s, o, h)
    assert ints == n * chip_smoke.THREEFRY_OPS * (9 + s + 3 * h)
    assert flt == n * (8 * s * o + 4 * s + 50 * h
                       + (4 * chip_smoke.LGAMMA_OPS + 12) * (h + 1))


def test_bound_divides_integer_work_by_the_int32_rate():
    ms, by = chip_smoke.bound(0, 0, 33.5e9)
    assert by == "operations" and ms == pytest.approx(1.0)
    ms, by = chip_smoke.bound(0, 67e9, 0)
    assert by == "operations" and ms == pytest.approx(1.0)
    # the pipes run side by side: the larger of the two, not their sum
    ms, _ = chip_smoke.bound(0, 67e9, 33.5e9)
    assert ms == pytest.approx(1.0)
    ms, by = chip_smoke.bound(3.35e9 * 2, 67e9, 33.5e9)
    assert by == "bytes" and ms == pytest.approx(2.0)


def test_joint_step_cost_adds_the_ll_build_to_the_step():
    nbytes, flt, ints = chip_smoke.joint_step_cost(20, 13, 6, 2, 1)
    step_f, step_i = chip_smoke.step_ops(20, 13, 6, 2)
    assert (flt, ints) == (step_f + 4 * 20 * 13 * 6, step_i)
    assert nbytes == 3 * 20 * 13 * 6 * 4 + 2 * 20 * 2 * 4 + 4 + 3 * 20 * 13 * 4


def test_launches_by_width_counts_the_timed_kernels(monkeypatch):
    calls = []
    monkeypatch.setattr(kernels, "_launch_layout",
                        lambda name, *args: calls.append(name) or "out")
    counts = {}
    with chip_smoke.launches_by_width(counts):
        for name, o in (("gibbs_sweep", 6), ("noise_step", 6),
                        ("gibbs_sweep", 6), ("joint_step", 45),
                        ("ll_noise_terms", 6)):
            assert kernels._launch_layout(name, torch.zeros(2, 3, o)) == "out"
    assert counts == {("gibbs_sweep", 6): 2, ("noise_step", 6): 1,
                      ("joint_step", 45): 1}
    assert len(calls) == 5
    assert kernels._launch_layout("x") == "out"  # the stub is back


def test_log_class_times_names_pairs_launches_and_bound(capsys):
    book = chip_smoke.KernelBook()
    book.timing("gibbs_sweep", False, ms=1.5, plain_ms=9.0, bound_ms=0.25,
                bound_by="operations", library_ms=None, shape="H2/K128/C8",
                pairs=160, o=6)
    book.timing("bucket_stats", False, ms=1.0, plain_ms=2.0, bound_ms=0.1,
                bound_by="bytes", library_ms=None, shape="H2/K128/C8")
    chip_smoke.log_class_times(book, {("gibbs_sweep", 6): 3})
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    assert "160 pairs" in out[0] and "3 launches at O = 6" in out[0]
    assert "bound 0.2500 ms (operations)" in out[0]


def test_kernel_ab_fingerprints_the_bytes():
    a = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    assert kernel_ab.sha(a) == kernel_ab.sha(a.clone())
    assert kernel_ab.sha(a) != kernel_ab.sha(a.flip(0))
    assert kernel_ab.sha(a, a) != kernel_ab.sha(a)


def test_kernel_ab_records_the_coupled_stats_call(monkeypatch):
    """coupled_stats_call keeps a copy of the first call's arguments made
    with missing and mac_extra, given by position as the engine gives
    them, and lets every call through."""
    from bayestyper_tpu_torch import kernels

    seen = []
    monkeypatch.setattr(kernels, "bucket_stats",
                        lambda *a, **kw: seen.append((a, kw)) or len(seen))
    t = torch.zeros(3)
    head = (t,) * 16
    with kernel_ab.coupled_stats_call([]) as calls:
        assert kernels.bucket_stats(*head, True) == 1
        assert kernels.bucket_stats(*head, False, (t, t, t), t) == 2
        kernels.bucket_stats(*head, False, missing=(t,), mac_extra=t)
    assert kernels.bucket_stats is not None and len(seen) == 3
    assert len(calls) == 1
    args, kw = calls[0]
    assert len(args) == 16 and set(kw) == {"missing", "mac_extra"}
    t += 1
    assert float(args[0].sum()) == 0.0 and float(kw["mac_extra"].sum()) == 0


@pytest.mark.parametrize("power, runs", [(2.0, (256, 512)),
                                         (1.0, (256, 512, 2048, 4096))])
def test_kernel_ab_skips_stats_cases_past_the_limit(monkeypatch, power,
                                                     runs):
    """beyond_stats_rows extrapolates the later cases from the first two
    as a power of O and runs only those under the limit: a kernel whose
    time grows as O^2 from 50 ms at H512 skips H2048 and H4096, one that
    grows as O runs them."""
    import types

    ran = []

    def fields(cs, st_args):
        o = st_args[7].shape[-1]
        ran.append(o)
        return {"stats_ms": 50.0 * (o / 131841) ** power,
                "stats_unpacked_ms": 0.0, "stats_int_sha": "0" * 12,
                "stats_float_sha": "0" * 12}

    monkeypatch.setattr(kernel_ab, "stats_fields", fields)

    def chunk(gen, dev, c, k, h, v, s, ch, a_cap):
        o = h * (h + 1) // 2 + h + 1
        return types.SimpleNamespace(**dict.fromkeys(
            ("mult", "inter_mult", "counts", "member", "hap_allele",
             "num_alleles", "ploidy"))), torch.zeros((c, ch, s, o))

    cs = types.SimpleNamespace(BEYOND_LL=chip_smoke.BEYOND_LL,
                               random_chunk=chunk, log=lambda msg: None)
    monkeypatch.setattr("bayestyper_tpu_torch.model.gibbs.outcome_tensors",
                        lambda h, dev: types.SimpleNamespace(oa32=None,
                                                             ob32=None))
    rows = kernel_ab.beyond_stats_rows(cs, torch.device("cpu"), 0)
    assert ran == [h * (h + 1) // 2 + h + 1 for h in runs]
    skipped = [r["class"] for r in rows if "skipped" in r]
    assert len(skipped) == 4 - len(runs)
    assert all(r["skipped"] == "skipped (O² selection)" for r in rows
               if "skipped" in r)


def test_step_sections_marks_every_barrier_of_the_step():
    import os

    import step_sections

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "bayestyper_tpu_torch", "kernels", "csrc",
        "gibbs_step.cuh")
    with open(path) as f:
        src = f.read()
    out = step_sections.instrument(src)
    start = out.index("inline void bt_gibbs_step(")
    body = out[start:out.index("\n}\n", start)]
    barriers = body.count("sync();")
    assert barriers > 0
    assert body.count("sync(); BT_SEC_MARK();") == barriers
    assert "long long bt_t = clock64();" in body
    # nothing outside the step is marked, and the counters are declared
    rest = out.replace(body, "")
    assert "BT_SEC_MARK();" not in rest.split("#define BT_SEC_MARK()")[1]
    assert "__device__ unsigned long long bt_sec[64];" in out


def _nested_stub(depths, s=13, h=2, ch=20):
    """A coupled scan's setup as nested_cost reads it: one H level per rank,
    no shared k-mers, groups of the given depths (one row per level)."""
    import types

    o = h * (h + 1) // 2 + h + 1
    n_levels = max(depths)
    c = len(depths)
    levels = [types.SimpleNamespace(
        ll=torch.zeros((c, ch, s, o)), hap_valid=torch.ones((c, h)),
        freqs=torch.zeros((c * ch, h)), ocur=torch.zeros((c, ch, s)),
        tally=torch.zeros((c, ch, s, o), dtype=torch.int32),
        retain=torch.zeros((c, o), dtype=torch.int8),
        ploidy=torch.zeros((c, s), dtype=torch.int8), sh=None, mac=None)
        for _ in range(n_levels)]
    members = [(l, g) for g, d in enumerate(depths) for l in range(d)]
    offsets = [0]
    for d in depths:
        offsets.append(offsets[-1] + d)
    return types.SimpleNamespace(
        levels=levels, pool=torch.zeros((1, ch, s), dtype=torch.int32),
        groups=(torch.tensor(offsets, dtype=torch.int32),
                torch.tensor(members, dtype=torch.int32)))


@pytest.mark.parametrize("depths, chain_binds", [((65, 9, 9, 3), True),
                                                 ((2,) * 4000, False)])
def test_nested_bound_takes_the_deepest_chain(depths, chain_binds):
    """nested_bound: the larger of the launch's roofline and the deepest
    (group, chain)'s member steps at one SM's share of the float32 and
    INT32 peaks."""
    setup = _nested_stub(depths)
    iters = 350
    flt, ints = chip_smoke.step_ops(1, 13, 6, 2)
    chain = iters * max(depths) * max(
        flt / (chip_smoke.PEAK_OPS_S / chip_smoke.SMS),
        ints / (chip_smoke.PEAK_INT_OPS_S / chip_smoke.SMS)) * 1e3
    roof, roof_by = chip_smoke.bound(*chip_smoke.nested_cost(setup, iters))
    ms, by, chain_ms = chip_smoke.nested_bound(setup, iters)
    assert chain_ms == pytest.approx(chain)
    assert ms == pytest.approx(max(roof, chain))
    assert (chain > roof) == chain_binds
    assert by == ("operations" if chain_binds else roof_by)
    # the launch's operations: every member of every group and chain
    _, ops, i_ops = chip_smoke.nested_cost(setup, iters)
    assert ops == pytest.approx(20 * iters * sum(depths) * flt)
    assert i_ops == pytest.approx(20 * iters * sum(depths) * ints)
