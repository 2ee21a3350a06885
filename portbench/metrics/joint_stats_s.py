"""joint_stats_s: the per-unit mean of genotype_unit_joint's
timings["stats_s"] (statistics and VCF rendering after the joint scan),
host seconds, over the window's units."""

from portbench.metrics import unit_mean


def read(ctx):
    return unit_mean(ctx, "stats_s")
