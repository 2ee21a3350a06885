"""The least time each traced layer's work needs on one H100: the yardstick
of the span rooflines.

Counted from the unit itself (each cluster's real haplotypes and k-mers,
not the program's padded size classes) and the run's settings (samples,
chains, iterations), so that the count stays the same whatever kernels,
fusions or graphs the program uses. Only operations that every correct
Gibbs sampler of this model does are counted. Per (cluster, chain,
iteration), with S samples, H haplotypes and O = H (H + 1) / 2 diploid
outcomes, the step of chip_smoke.step_ops (frozen here) without its
size-prior term (four lgammas per haplotype count, which a table removes):

    float32:  8 S O + 4 S + 50 H
    integer:  75 (9 + S + 3 H)     (threefry hashes of the step's keys)

Bytes: each input byte read once (the k-mer counts, one byte per k-mer
and sample, and the k-mer-by-haplotype membership bits) and each output
byte written once (the genotype tallies, 4 bytes per sample and outcome;
the noise rates, 4 bytes per chain, iteration and sample).

The least time is the largest of bytes over the HBM rate, float32
operations over the float32 rate and integer operations over the INT32
rate, at NVIDIA's published peaks of the H100 SXM at 700 W (67 TFLOP/s
float32, taken also for the integer pipe at half that, 3.35 TB/s): peaks
at or above the card's, so that the share stays under 100%.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = 67e12
PEAK_INT_OPS_S = PEAK_FLOPS_S / 2

STEP_OPS_SO = 8
STEP_OPS_S = 4
STEP_OPS_H = 50
THREEFRY_OPS = 75
STEP_KEYS = 9
#   the noise scan's rate update per (chain, iteration, sample): its shape and
#   scale, one gamma draw's first round (two logs, the erfinv polynomial),
#   and its keys' three threefry hashes
RATE_OPS = 60
RATE_INT_OPS = 3 * THREEFRY_OPS
# BayesTyper's default cap on the variants that the noise estimate reads
NOISE_ESTIMATION_VARIANTS = 100_000


def is_coupled(fc) -> bool:
    """Clusters that the coupled scan genotypes: containment parents and
    children, and holders of k-mers shared within a group."""
    return (getattr(fc, "parent_id", -1) >= 0
            or bool(getattr(fc, "children_ids", []))
            or getattr(fc, "shared_slot", None) is not None)


def step_work(s, h):
    """(float32 ops, integer ops) of one Gibbs step of one (cluster, chain)."""
    o = h * (h + 1) // 2
    return (STEP_OPS_SO * s * o + STEP_OPS_S * s + STEP_OPS_H * h,
            THREEFRY_OPS * (STEP_KEYS + s + 3 * h))


def cluster_bytes(s, h, k):
    """Input and output bytes of one cluster's genotyping."""
    o = h * (h + 1) // 2
    return k * s + (k * h + 7) // 8 + 4 * s * o


def least_seconds(nbytes, flops, int_ops):
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS_S,
               int_ops / PEAK_INT_OPS_S)


def unit_work(unit, num_samples, opts):
    """{layer: (bytes, float32 ops, integer ops)} of one genotype_unit call
    on `unit` under `opts` (a dict of the configuration's settings): the
    noise scan over the single clusters of single-cluster groups (up to
    NOISE_ESTIMATION_VARIANTS of their variants), the waves over every
    single cluster and the coupled scan over the coupled clusters."""
    s = num_samples
    ch = opts["num_chains"]
    iters = opts["burn_in"] + opts["num_samples"]
    acc = {name: [0, 0, 0] for name in ("noise", "waves", "coupled")}
    noise_variants = 0
    for fc in unit.compiled:
        h = fc.hap_allele.shape[0]
        k = len(fc.kmer_hi)
        flt, ints = step_work(s, h)
        steps = ch * iters
        layers = []
        if is_coupled(fc):
            layers.append("coupled")
        else:
            layers.append("waves")
            if (getattr(fc, "group_size", 1) == 1
                    and noise_variants < NOISE_ESTIMATION_VARIANTS):
                noise_variants += len(fc.variants)
                layers.append("noise")
        for name in layers:
            a = acc[name]
            a[0] += cluster_bytes(s, h, k)
            a[1] += flt * steps
            a[2] += ints * steps
    a = acc["noise"]
    a[0] += 4 * ch * iters * s
    a[1] += RATE_OPS * ch * iters * s
    a[2] += RATE_INT_OPS * ch * iters * s
    return {name: tuple(v) for name, v in acc.items()}
