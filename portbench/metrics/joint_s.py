"""joint_s: the per-unit mean of genotype_unit_joint's timings["joint_s"] (the joint scan), host seconds, over the window's units."""

from portbench.metrics import unit_mean


def read(ctx):
    return unit_mean(ctx, "joint_s")
