"""The window and rate arithmetic, the per-layer readers and the roofline
work counts."""

import types

import numpy as np
import pytest

from portbench import run, trace, work
from portbench.metrics import unit_mean


def test_window_runs_units_until_the_time_and_ends_with_the_unit(
        monkeypatch):
    calls = []
    # a clock that each unit moves by 0.03 s, so a loaded machine reads
    # the same
    clock = [1000.0]
    monkeypatch.setattr(run.time, "perf_counter", lambda: clock[0])

    def one(index, out):
        calls.append((index, out))
        clock[0] += 0.03
        return {"num_variants": 100, "timings": {"counts_s": 0.01 * index}}

    summaries, outs, window_s = run.drive_window(
        one, lambda i: f"u{i}.vcf", seconds=0.1)
    # the unit in flight when 0.1 s pass ends the window: 4 units of 0.03
    assert len(summaries) == 4
    assert outs == ["u0.vcf", "u1.vcf", "u2.vcf", "u3.vcf"]
    assert [i for i, _ in calls] == [0, 1, 2, 3]
    assert 0.1 <= window_s < 0.2
    assert run.variants_per_s(summaries, window_s) == pytest.approx(
        400 / window_s)
    assert unit_mean({"summaries": summaries}, "counts_s") == pytest.approx(
        0.015)
    assert unit_mean({"summaries": summaries}, "joint_s") is None


def test_window_wraps_each_unit_and_always_runs_one():
    entered = []

    class Window:
        def __enter__(self):
            entered.append(1)

        def __exit__(self, *exc):
            return False

    summaries, _, _ = run.drive_window(
        lambda i, o: {"num_variants": 1, "timings": {}}, str, 0.0,
        window=Window)
    assert len(summaries) == 1 and len(entered) == 1


def test_step_work_and_least_time():
    # S = 13, H = 2: O = 3
    flt, ints = work.step_work(13, 2)
    assert flt == 8 * 13 * 3 + 4 * 13 + 50 * 2
    assert ints == 75 * (9 + 13 + 6)
    assert work.least_seconds(3.35e12, 1.0, 1.0) == pytest.approx(1.0)
    assert work.least_seconds(1.0, 67e12, 1.0) == pytest.approx(1.0)
    assert work.least_seconds(1.0, 1.0, 33.5e12) == pytest.approx(1.0)
    assert work.cluster_bytes(13, 2, 100) == 100 * 13 + 25 + 4 * 13 * 3


def _fc(h, k, variants=1, coupled=False, group_size=1):
    return types.SimpleNamespace(
        hap_allele=np.zeros((h, variants)), kmer_hi=np.zeros(k),
        variants=[None] * variants, parent_id=0 if coupled else -1,
        children_ids=[], shared_slot=None, group_size=group_size)


def test_unit_work_by_layer():
    unit = types.SimpleNamespace(compiled=[
        _fc(2, 100), _fc(4, 200, variants=2, group_size=2),
        _fc(16, 300, variants=4, coupled=True)])
    opts = {"num_chains": 20, "burn_in": 100, "num_samples": 250}
    w = work.unit_work(unit, 13, opts)
    steps = 20 * 350
    f2, i2 = work.step_work(13, 2)
    f4, i4 = work.step_work(13, 4)
    f16, i16 = work.step_work(13, 16)
    rate = (4 * 20 * 350 * 13, work.RATE_OPS * 20 * 350 * 13,
            work.RATE_INT_OPS * 20 * 350 * 13)
    # the noise scan reads only single-cluster groups
    assert w["noise"] == (work.cluster_bytes(13, 2, 100) + rate[0],
                          f2 * steps + rate[1], i2 * steps + rate[2])
    assert w["waves"] == (work.cluster_bytes(13, 2, 100)
                          + work.cluster_bytes(13, 4, 200),
                          (f2 + f4) * steps, (i2 + i4) * steps)
    assert w["coupled"] == (work.cluster_bytes(13, 16, 300), f16 * steps,
                            i16 * steps)


def test_idle_share_and_peak_readers():
    t = trace.Totals()
    ctx = {"totals": t, "peak_bytes": 0}
    assert run.read_metric("device_idle_share", ctx) is None
    assert run.read_metric("device_peak_gib", ctx) is None
    t.busy_s, t.window_s, t.device_events = 2.5, 10.0, 7
    ctx["peak_bytes"] = 3 * 2**30
    assert run.read_metric("device_idle_share", ctx) == pytest.approx(75.0)
    assert run.read_metric("device_peak_gib", ctx) == pytest.approx(3.0)


def test_every_metric_has_a_reader_and_cells_their_metrics():
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    ctx = {"summaries": [{"num_variants": 1, "timings": {}}],
           "totals": trace.Totals(), "peak_bytes": 0,
           "work": {k: (0, 0, 0) for k in ("noise", "waves", "coupled")}}
    for m in bench["per_layer"]:
        assert run.read_metric(m["name"], ctx) is None
    for cell in bench["workloads"]:
        names = {m["name"] for m in run.cell_metrics(bench, cell,
                                                     "end_to_end")}
        assert names == {"variants_per_s", "setup_s"}
        assert run.cell_metrics(bench, cell, "per_layer")


def test_configuration_states_only_the_judges_reach():
    """A configuration's "judge" merges over judge.json for its reach
    alone; the block, limits, control and cut stay judge.json's."""
    base = run.load_json(run.HERE, "judge.json")
    assert run.judge_settings({}) == base
    wide = run.judge_settings({"judge": {"max_haplotypes": 1025}})
    assert wide == dict(base, max_haplotypes=1025)
    for key in ("block_elements", "limits", "control", "cut", "gpp_floor"):
        with pytest.raises(ValueError):
            run.judge_settings({"name": "x", "judge": {key: {}}})


def test_existing_configurations_state_no_new_settings():
    """The cells' configurations state no judge reach, no blooms and their
    mixes no lengths: their runs are as they were."""
    import json

    bench = json.load(open(f"{run.ROOT}/BENCHMARK.json"))
    for cell in bench["workloads"]:
        _, _, cfg, mix = run.specs(cell["name"])
        assert "judge" not in cfg and "lengths" not in mix
        assert not cfg["cluster"].get("sample_blooms", False)
        assert run.sample_blooms(cfg, [], 1) is None
