"""waves_s: the per-unit mean of genotype_unit's timings["waves_s"], host seconds, over the window's units."""

from portbench.metrics import unit_mean


def read(ctx):
    return unit_mean(ctx, "waves_s")
