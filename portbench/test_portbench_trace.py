"""Idle share and span attribution of trace.py on a synthetic trace."""

import pytest
from torch.autograd import DeviceType

from portbench import trace
from portbench.metrics import roofline


class Ev:
    def __init__(self, name, start, end, device=False, corr=0, linked=0):
        self._n, self._s, self._e = name, start, end
        self._d = DeviceType.CUDA if device else DeviceType.CPU
        self._c, self._l = corr, linked

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l


def _unit_events():
    """A unit span [0, 1000); bt.noise [100, 400) holding bt.noise_chains
    [150, 300); bt.genotype_wave [500, 800). Kernels (launch -> device):
    k1 launched at 160 runs [200, 260); k2 launched at 120 runs [260, 300);
    k3 launched at 510 runs [600, 700) beside a copy [650, 720); k4
    launched at 900 (outside bt spans) runs [950, 980). The device's
    mirror of bt.noise must not count as activity."""
    return [
        Ev("portbench.unit", 0, 1000),
        Ev("bt.noise", 100, 400), Ev("bt.noise_chains", 150, 300),
        Ev("bt.genotype_wave", 500, 800),
        Ev("bt.noise", 100, 400, device=True),
        Ev("cudaLaunchKernel", 160, 165, corr=1),
        Ev("cudaLaunchKernel", 120, 125, corr=2),
        Ev("cudaLaunchKernel", 510, 515, corr=3),
        Ev("cudaMemcpyAsync", 520, 525, corr=4),
        Ev("cudaLaunchKernel", 900, 905, corr=5),
        Ev("bt_noise_pair_kernel", 200, 260, device=True, corr=1),
        Ev("bt_noise_rates_kernel", 260, 300, device=True, linked=2),
        Ev("bt_gibbs_sweep_kernel", 600, 700, device=True, corr=3),
        Ev("Memcpy DtoH (Device -> Pinned)", 650, 720, device=True, corr=4),
        Ev("bt_bucket_stats_kernel", 950, 980, device=True, corr=5),
    ]


def test_busy_idle_and_window():
    t = trace.Totals()
    trace.reduce_events(_unit_events(), t)
    # busy: [200, 300) + [600, 720) + [950, 980) = 250 ns of 1000
    assert t.busy_s == pytest.approx(250e-9)
    assert t.window_s == pytest.approx(1000e-9)
    assert t.units == 1
    assert dict(t.ops_s) == pytest.approx({
        "bt_noise_pair_kernel": 60e-9, "bt_noise_rates_kernel": 40e-9,
        "bt_gibbs_sweep_kernel": 100e-9,
        "Memcpy DtoH (Device -> Pinned)": 70e-9,
        "bt_bucket_stats_kernel": 30e-9})


def test_kernels_count_for_every_enclosing_span():
    t = trace.Totals()
    trace.reduce_events(_unit_events(), t)
    k = t.span_kernel_s
    assert k["bt.noise"] == pytest.approx(100e-9)          # k1 + k2
    assert k["bt.noise_chains"] == pytest.approx(60e-9)    # k1 only
    assert k["bt.genotype_wave"] == pytest.approx(100e-9)  # k3, not the copy
    assert k["portbench.unit"] == pytest.approx(230e-9)    # every kernel


def test_idle_time_filed_under_the_innermost_span():
    t = trace.Totals()
    trace.reduce_events(_unit_events(), t)
    gaps = dict(t.idle_s)
    # idle [0,200) [300,600) [720,950) [980,1000), cut at span edges:
    # [0,100) unit, [100,150) bt.noise, [150,200) bt.noise_chains,
    # [300,400) bt.noise, [400,500) unit, [500,600) bt.genotype_wave,
    # [720,800) bt.genotype_wave, [800,950) unit, [980,1000) unit
    assert gaps["bt.noise"] == pytest.approx(150e-9)
    assert gaps["bt.noise_chains"] == pytest.approx(50e-9)
    assert gaps["bt.genotype_wave"] == pytest.approx(180e-9)
    assert gaps["portbench.unit"] == pytest.approx((100 + 100 + 150 + 20)
                                                   * 1e-9)
    assert sum(gaps.values()) == pytest.approx(750e-9)
    assert t.busy_s + sum(gaps.values()) == pytest.approx(t.window_s)


def test_units_add_up_and_breakdown():
    t = trace.Totals()
    trace.reduce_events(_unit_events(), t)
    trace.reduce_events(_unit_events(), t)
    assert t.units == 2 and t.window_s == pytest.approx(2000e-9)
    b = t.breakdown(top=2)
    assert [n for n, _ in b["device_ops"]] == [
        "bt_gibbs_sweep_kernel", "Memcpy DtoH (Device -> Pinned)"]
    assert b["idle_gaps"][0][0] == "portbench.unit"


def test_union_and_gaps():
    assert trace.union([(0, 10), (5, 15), (20, 30)]) == 25
    assert trace.gaps([(0, 10), (5, 15), (20, 30)], 0, 40) == [(15, 20),
                                                                (30, 40)]
    assert trace.gaps([], 3, 9) == [(3, 9)]


def test_roofline_reads_nothing_without_device_time():
    t = trace.Totals()
    ctx = {"totals": t, "work": {"noise": (1e6, 1e9, 1e9)}}
    assert roofline(ctx, "noise", ("bt.noise",)) is None
    trace.reduce_events(_unit_events(), t)
    got = roofline(ctx, "noise", ("bt.noise",))
    # least time: max(1e6 / 3.35e12, 1e9 / 67e12, 1e9 / 33.5e12) s
    assert got == pytest.approx(100 * (1e9 / 33.5e12) / 100e-9)
