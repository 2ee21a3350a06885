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
    barriers = body.count("__syncthreads();")
    assert barriers > 0
    assert body.count("__syncthreads(); BT_SEC_MARK();") == barriers
    assert "long long bt_t = clock64();" in body
    # nothing outside the step is marked, and the counters are declared
    rest = out.replace(body, "")
    assert "BT_SEC_MARK();" not in rest.split("#define BT_SEC_MARK()")[1]
    assert "__device__ unsigned long long bt_sec[64];" in out
