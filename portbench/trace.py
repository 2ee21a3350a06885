"""The traced run's profiler window and its reduction to numbers.

Each unit of a `--trace 1` window runs under its own torch.profiler window
(CPU and CUDA activity), reduced in memory as soon as the unit ends: no
trace file is written. From the Kineto events:

  * busy: the union of the device's kernel, copy and memset intervals
    (the interval arithmetic of the port's utils/profiling._union, copied);
  * span device time: each kernel counts for every `bt.*` span (the
    program's torch.profiler.record_function ranges) and `portbench.*`
    span (the benchmark's own, around the calls into the program) that was
    open on the host when it was launched, matched through the launch's
    correlation id (the device's mirrors of the spans are not device
    activity);
  * the device's idle time inside the window, cut at the host spans'
    edges and each piece filed under the innermost span open on the host;
  * device seconds per kernel name.
"""

from __future__ import annotations

import bisect
import collections

SPAN_PREFIXES = ("bt.", "portbench.")
NO_SPAN = "no span (counts, plan, write)"


def union(intervals):
    """Total length of the union of [start, end) intervals (a copy of the
    port's utils/profiling._union)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, w0, w1):
    """The [start, end) pieces of [w0, w1) that no interval covers."""
    out, cur = [], w0
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, w1)))
        cur = max(cur, e)
        if cur >= w1:
            break
    if cur < w1:
        out.append((cur, w1))
    return [(s, e) for s, e in out if e > s]


class Spans:
    """Nested host spans (start, end, name); innermost(t) is the latest-
    starting span that holds t, which for nested spans is the innermost."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s for s, _, _ in self.spans]
        self.edges = sorted({t for s, e, _ in self.spans for t in (s, e)})

    def pieces(self, s, e):
        """[s, e) cut at every span edge inside it."""
        i = bisect.bisect_right(self.edges, s)
        j = bisect.bisect_left(self.edges, e)
        cuts = [s] + self.edges[i:j] + [e]
        return list(zip(cuts[:-1], cuts[1:]))

    def innermost(self, t):
        names = self.holding(t, first=True)
        return names[0] if names else None

    def holding(self, t, first=False):
        """Names of the spans that hold t, innermost first."""
        out = []
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0:
            s, e, name = self.spans[i]
            if t < e:
                out.append(name)
                if first:
                    break
            i -= 1
        return out


class Totals:
    """What the traced units add up to."""

    def __init__(self):
        self.busy_s = 0.0
        self.window_s = 0.0
        self.units = 0
        self.span_kernel_s = collections.Counter()
        self.idle_s = collections.Counter()
        self.ops_s = collections.Counter()
        self.device_events = 0

    def breakdown(self, top=10):
        return {
            "device_ops": [[n, s] for n, s in self.ops_s.most_common(top)],
            "idle_gaps": [[n, s] for n, s in self.idle_s.most_common(top)],
        }


def _kind(ev):
    """'kernel', 'copy', 'memset', 'runtime', 'span' or None."""
    from torch.autograd import DeviceType

    name = ev.name()
    if ev.device_type() == DeviceType.CUDA:
        if name.startswith(SPAN_PREFIXES):
            return None   # a host span's mirror on the device timeline
        low = name.lower()
        if "memcpy" in low:
            return "copy"
        if "memset" in low:
            return "memset"
        return "kernel"
    if name.startswith(SPAN_PREFIXES):
        return "span"
    if name.startswith(("cuda", "cu")) and not name.startswith("cudnn"):
        return "runtime"
    return None


UNIT_SPAN = "portbench.unit"


def reduce_events(events, totals):
    """Fold one profiler window's Kineto events into totals. The window is
    the UNIT_SPAN range (with any device activity past its ends)."""
    spans, launches, device = [], {}, []
    for ev in events:
        kind = _kind(ev)
        if kind == "span":
            spans.append((ev.start_ns(), ev.end_ns(), ev.name()))
        elif kind == "runtime":
            launches[ev.correlation_id()] = ev.start_ns()
        elif kind is not None:
            device.append(ev)
    spans = Spans(spans)
    intervals = []
    for ev in device:
        s, e = ev.start_ns(), ev.end_ns()
        intervals.append((s, e))
        secs = (e - s) / 1e9
        totals.ops_s[ev.name()[:120]] += secs
        t = launches.get(ev.correlation_id())
        if t is None:
            t = launches.get(ev.linked_correlation_id())
        if t is not None and _kind(ev) == "kernel":
            for name in set(spans.holding(t)) or (NO_SPAN,):
                totals.span_kernel_s[name] += secs
    ends = [(s, e) for s, e, name in spans.spans if name == UNIT_SPAN]
    ends += intervals
    if not ends:
        return
    w0 = min(s for s, _ in ends)
    w1 = max(e for _, e in ends)
    totals.device_events += len(device)
    totals.busy_s += union(intervals) / 1e9
    totals.window_s += (w1 - w0) / 1e9
    totals.units += 1
    for gs, ge in gaps(intervals, w0, w1):
        for s, e in spans.pieces(gs, ge):
            totals.idle_s[spans.innermost((s + e) // 2) or NO_SPAN] += (
                (e - s) / 1e9)


class Window:
    """A profiler window around one unit; folds it into totals on exit."""

    def __init__(self, totals):
        self.totals = totals

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.span = torch.profiler.record_function(UNIT_SPAN)
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.span.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is None:
            reduce_events(self.prof.profiler.kineto_results.events(),
                          self.totals)
        self.prof = None
        return False
