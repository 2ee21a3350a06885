"""waves_roofline: the least time of the waves layer's work (work.py, from
the unit's real clusters) over the device time of the kernels launched
inside span(s) bt.genotype_wave,bt.stats, in %, over the traced units."""

from portbench.metrics import roofline


def read(ctx):
    return roofline(ctx, "waves", ("bt.genotype_wave","bt.stats",))
