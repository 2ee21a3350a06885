"""noise_s: the per-unit mean of genotype_unit's timings["noise_s"], host seconds, over the window's units."""

from portbench.metrics import unit_mean


def read(ctx):
    return unit_mean(ctx, "noise_s")
