"""Per-layer metric readers: metrics/<name>.py's read(ctx) returns the
metric, or None where the run gives it nothing to read. ctx holds the
window's per-unit summaries, the trace totals (trace.Totals), the work of
each layer of one unit (work.unit_work) and the peak device memory."""

from portbench import work


def unit_mean(ctx, key):
    vals = [s["timings"][key] for s in ctx["summaries"]
            if key in s["timings"]]
    return sum(vals) / len(vals) if vals else None


def roofline(ctx, layer, spans):
    """100 x (least time of the layer's work in the traced units) / (the
    device time of the kernels launched inside spans)."""
    totals = ctx["totals"]
    device_s = sum(totals.span_kernel_s.get(s, 0.0) for s in spans)
    nbytes, flops, int_ops = ctx["work"][layer]
    if device_s <= 0 or not (flops or int_ops):
        return None
    least = work.least_seconds(nbytes, flops, int_ops) * totals.units
    return 100.0 * least / device_s
