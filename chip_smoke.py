"""Drive the PyTorch/CUDA port (bayestyper_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--scale 2]

Phases, one line each; any failure raises and the script exits non-zero:

  1. device   the card's name and power limit (nvidia-smi);
  2. build    the fourteen CUDA C++ kernels (six with a global-memory
              variant for shapes past the card's shared memory) for sm_90a,
              through torch.utils.cpp_extension (one compiler per source, in
              parallel);
  3. data     a simulated README-row-3-shaped unit: 13 samples at 50x,
              k = 55, SNVs, indels, dense 2/4/6-SNV clusters, SV deletions
              and insertions, a duplicated 50 kb block (the generator of
              bench.py on the port's own io modules); --scale 2 is ~17.4k
              variants; then the port's cluster phase;
  4. kernels  every kernel of the sequential path against its plain PyTorch
              version on the card, on the first chunk of every size class of
              that unit (20 chains, chunks of up to 4096 clusters), with
              CUDA-event times; the ragged-row unpack against its plain
              version and the host's dense build; and the k-mer cap on the
              card against the CPU, forced on the class with the most
              haplotypes;
  5. main     genotype_unit on the card at production settings (20 chains,
              100 burn-in, 250 samples), launch counts of every kernel, and
              concordance / call rate against the simulated truth;
  6. lookup   the device k-mer lookup path (BT_DEVICE_LOOKUP=1):
              lane_lookup against its plain version and the host lookup on
              the main unit's lane table, queried with one sample's KMC
              stream in batches of 1 << 20, and at chr20 scale (159M lanes
              generated sorted on the card, 64M ascending queries; Mq/s
              beside the host's native merge and LaneTable.lookup);
              bloom_query against its plain version and the host contains
              on one sample's bloom (make_bloom) and on a chr20-scale bloom
              (457M k-mers at fpr 0.001); then gather_sample_counts and
              device_bloom_query on the card (counts byte-identical to the
              host path's, one lane_lookup launch per KMC batch), and
              genotype_unit under BT_DEVICE_LOOKUP=1 with the main bars and
              phase 5's GT calls;
  7. joint    joint_step against its plain version on the first chunk of
              every size class, a 350-iteration joint scan over those chunks
              whose every rate update noise_rates replays against its plain
              version (the scan's rate draws, noise_rates_draws, against
              theirs; the update timed as 350 launches back to back); then
              genotype_unit_joint (--noise-genotyping) on the
              main unit at production settings, with the same bars;
  8. coupled  a second unit whose clusters are coupled (13 samples, 50x,
              k = 55; at --scale 2: 300 deletions of 0.6-3 kb over 1-8 SNVs,
              one ~4 kb deletion over 64 SNVs 60 bp apart, 50 deletions over
              an SNV in each of two copies of a 200 bp repeat, and 1,000
              isolated SNVs): its rank levels, capped levels and shared pool;
              kmer_cap, nested_sweep and bucket_stats against their plain
              versions on its levels, with CUDA-event times; genotype_unit
              and genotype_unit_joint on it, with concordance / call rate
              over all and over the coupled variants;
  9. single   the JAX package's single-bucket forms on the first chunk of
              every size class of the main unit (20 chains, 100 + 250
              iterations): gamma_draw against its plain version at the
              engines' shape and at 2^20 elements of log-uniform alpha;
              genotype_bucket and genotype_buckets_multi bit-equal to
              genotype_stacked; noise_chains_multi and joint_chains_multi
              bit-equal to the stacked chains; noise_chain from
              CountModel's prior draw, its first iterations replayed through
              the plain versions; the port's examples.genotype_simulated;
 10. mesh     (run right after phase 7, whose VCFs it reads) the cluster-
              sharded path: genotype_unit over 2 and 4 shards and
              genotype_unit_joint over 2, the shards placed round-robin over
              the visible cards, must write phases 5 and 7's VCFs byte for
              byte, with the stacked kernels launched once per shard and the
              rate update once per iteration; genotype_bucket_sharded and
              noise_chain_sharded bit-equal to genotype_bucket and
              noise_chain on the bulk class's first chunk;
 11. wide     a 30-sample unit (the reference's cap) from the main
              generator at scale 0.1 with an H128 cluster of 8 SNVs, four 5
              kb insertions in one K32768 cluster under the k-mer cap and a
              deletion over 6 SNVs (an H64 coupled child level): every
              kernel against its plain version on each class's first chunk
              (24-iteration scans), joint_step per class and the coupled
              scan, each filed under the global-memory variant that
              launched (the H64 classes' LL [S, O] is past shared memory at
              30 samples), and kmer_cap on the K32768 class at its own cap,
              at cap 2 and at rate 1.0 (where pairs sort in device memory);
              ll_noise_terms at H256 x 30 samples and at H4096
              and bucket_stats past shared memory on inputs drawn on the
              card; then genotype_unit and genotype_unit_joint on it with
              the main bars.

The genotype runs of phases 5-9 are made with the port's plain gamma
samplers (torch fixed_round_gamma and its split form,
prng._gamma_one_batch) replaced by
functions that raise, so no plain rate update or prior draw runs on a card
path; each counts launches from zero, and logs the sha256 of the VCF it
wrote, so that two trees' runs can be compared bit for bit. After the
joint phase it logs gibbs_sweep's, noise_step's and joint_step's time on
every class of the main unit with the chunk's pairs, the main and joint
paths' launches at the class's width and the bound. It ends with a
JSON line of per-kernel numbers (launches per path and summed; a global-
memory variant is an entry of its own, with the wide phase's numbers),
then the result line {"ok": true, "device": {...}}. Without a CUDA card it
exits 2 and prints no result.
"""

import argparse
import contextlib
import dataclasses
import faulthandler
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

K = 55
NUM_SAMPLES = 13
COVERAGE = 50.0
DUP_BLOCK = 50_000
# clusters per kind at scale 1 (bench.py's MIX)
MIX = (("snv", 5200), ("indel", 800), ("dense2", 600), ("dense4", 250),
       ("dense6", 60), ("sv_del", 70), ("sv_ins", 50))
# families per kind of the coupled unit at scale 1; one dense family always
COUPLED_MIX = (("contain", 150), ("segdup", 25), ("snv", 500))
DENSE_SNVS, DENSE_SPACING = 64, 60
# the wide unit: WIDE_SAMPLES samples, the reference's cap
# (constants.MAX_SAMPLES, main.cpp:72,188), the main mix at WIDE_SCALE, and
# three clusters past the kernels' shared layouts at that width: 8 SNVs
# within a k-mer (an H128 class: without sample blooms the compiler's beam
# keeps 128 paths), WIDE_INS = (count, length) insertions 12 bp apart (the
# cluster phase keeps at most 5,000 k-mers per (variant, haplotype), so
# four such variants make a K32768 class under the k-mer cap) and a 600 bp
# deletion over 6 SNVs (a coupled family whose child level is H64); its
# kernel checks run WIDE_SCAN (iterations, burn-in) of the Gibbs scan
# against the plain version
WIDE_SAMPLES = 30
WIDE_SCALE = 0.1
WIDE_INS = (4, 5000)
WIDE_SCAN = (24, 8)
# ll_noise_terms beyond the wide unit, (H, S, C, K, chains) each: the first
# class past shared memory at the wide width, and the largest class
BEYOND_LL = ((256, WIDE_SAMPLES, 2, 96, 20), (4096, 2, 1, 24, 2))
# a deletion haplotype carries its nested children's `*` allele
STAR = 2

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 operations/s
# outside the tensor cores (the kernels' integer and float work is scalar)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# 32-bit integer operations/s: 64 INT32 lanes per SM against 128 FP32
PEAK_INT_OPS_S = PEAK_OPS_S / 2
# streaming multiprocessors: a serial chain of steps runs on one of them
SMS = 132

# the kernels each path must launch: the main unit's genotype_unit and
# genotype_unit_joint, the coupled unit's genotype_unit (its
# genotype_unit_joint launches the joint kernels and the coupled ones);
# unpack_bucket runs for chunks of at least 4 MB, which the main unit has
# at --scale 2
MAIN_KERNELS = ("subsample_masks", "ll_noise_terms", "gibbs_sweep",
                "noise_step", "noise_rates", "noise_rates_draws",
                "bucket_stats", "unpack_bucket", "gamma_draw")
JOINT_KERNELS = ("subsample_masks", "ll_noise_terms", "joint_step",
                 "noise_rates", "noise_rates_draws", "bucket_stats",
                 "unpack_bucket", "gamma_draw")
COUPLED_KERNELS = ("kmer_cap", "bucket_stats", "nested_sweep", "noise_rates",
                   "noise_rates_draws", "gamma_draw")
# the global-memory variants (kernels.GLOBAL) the wide unit's paths launch
WIDE_KERNELS = ("gibbs_sweep_global", "noise_step_global", "kmer_cap_global",
                "bucket_stats_global", "nested_sweep_global")
WIDE_JOINT_KERNELS = ("joint_step_global", "kmer_cap_global",
                      "bucket_stats_global", "nested_sweep_global")
# the mesh phase's shard counts: genotype_unit at each, genotype_unit_joint
# at the first
MESH_SHARDS = (2, 4)
# the single phase's forms (kmer_cap only where a class takes the cap)
SINGLE_KERNELS = ("subsample_masks", "ll_noise_terms", "gibbs_sweep",
                  "noise_step", "joint_step", "noise_rates",
                  "noise_rates_draws", "bucket_stats", "gamma_draw")

# bars against the plain versions
LL_RTOL, LL_ATOL = 1e-5, 1e-4
OSEL_AGREE_MIN = 0.999
FREQ_ATOL = 1e-5
GT_AGREE_MIN = 0.99
# a cap low enough to bind in any class, for the on-card cap check
FORCED_CAP = 2
# bars of the coupled kernels against their plain versions: scan tallies
# equal on this share of (cluster, chain) pairs (exp/log last bits), MAC
# corrections and unpacked float stats within these tolerances
PAIRS_AGREE_MIN = 0.99
# the coupled scan is held against its plain version (a level-major loop of
# torch ops, ~25 ms per level and iteration on the card) over two windows
# of NESTED_WINDOW iterations: the first, NESTED_WINDOW_BURN of them
# burn-in, and one across the path's own burn-in, from the kernel's state
NESTED_WINDOW, NESTED_WINDOW_BURN = 24, 8
MAC_RTOL = 1e-4
STATS_RTOL, STATS_ATOL = 1e-5, 1e-5
# noise_rates against its plain version: rates within RATES_RTOL on this
# share of (iteration, chain, sample) entries (a last-bit logf/powf
# difference can flip a gamma accept/reject; every flip is printed)
RATES_RTOL, RATES_AGREE_MIN = 1e-5, 0.999
# gamma_draw against its plain version: samples within GAMMA_RTOL on
# GAMMA_AGREE_MIN of the elements (tests/test_torch_joint.py's rtol; a
# last-bit logf/sqrtf/powf difference can flip an accept/reject or move a
# boost; every flip is printed). A boost pow(u, 1 / alpha) that underflows
# into subnormal floats holds fewer than 24 bits, and the sample is d * V
# (below 64) times it: the relative bar starts at 64 times float32's
# smallest normal (atol 2^-120, as tests/test_torch_gamma.py). The bulk
# draw: GAMMA_BULK (keys, elements per key) with alpha log-uniform over
# GAMMA_ALPHA: the boost below 1, pow underflowing to 0 near 1e-3, and the
# conjugate update's prior_shape + count_sum up to ~1e5
GAMMA_RTOL, GAMMA_ATOL, GAMMA_AGREE_MIN = 2e-6, 2.0 ** -120, 0.9999
GAMMA_BULK = (1 << 10, 1 << 10)
GAMMA_ALPHA = (1e-3, 2e5)
# noise_chain's first NOISE_WINDOW iterations replayed through the plain
# versions
NOISE_WINDOW = 24
# the lookup phase: KMC batch size of gather_sample_counts, and the chr20
# yardstick of the JAX package's human-scale run
# (benchmarks/HUMAN_SCALE_r05.json: a count table of 159M unique lanes,
# 457M k-mers per sample at 30x), queried with 64 batches
LOOKUP_BATCH = 1 << 20
CHR20_LANES = 159_000_000
CHR20_BLOOM_KMERS = 457_000_000
CHR20_QUERIES = 64 * LOOKUP_BATCH
# the count gathering's profiler spans (engine.gather_sample_counts)
GATHER_SPANS = ("bt.kmc_decode", "bt.lookup_upload", "bt.lane_lookup",
                "bt.lookup_download", "bt.count_match", "bt.count_scatter")


def log(msg):
    print(msg, flush=True)


def log_vcf(label, path):
    """The sha256 of a VCF written on the card, so that two trees' runs can
    be compared bit for bit."""
    with open(path, "rb") as f:
        log(f"{label}: VCF sha256 {hashlib.sha256(f.read()).hexdigest()}")


# ---------------------------------------------------------------------------
# workload
# ---------------------------------------------------------------------------

def make_genome_and_variants(rng, scale):
    """Genome with a duplicated block and the mixed variant placement of
    bench.py. Returns (seq, [(pos0, ref, alt)])."""
    kinds = [k for k, n in MIX for _ in range(int(n * scale))]
    rng.shuffle(kinds)
    base_len = 300 + sum(520 + (420 if k.startswith("sv") else 0)
                         for k in kinds)
    seq = (np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, base_len + 600)]
           .tobytes().decode())
    seq = seq + seq[1000:1000 + DUP_BLOCK]
    variants = []
    pos = 300
    for kind in kinds:
        pos += int(420 + rng.integers(0, 200))
        if pos + 900 >= base_len:
            break
        ref_base = seq[pos]
        if kind == "snv":
            alt = str(rng.choice([b for b in "ACGT" if b != ref_base]))
            variants.append((pos, ref_base, alt))
        elif kind == "indel":
            if rng.random() < 0.5:
                ins = "".join(rng.choice(list("ACGT"), int(rng.integers(2, 9))))
                variants.append((pos, ref_base, ref_base + ins))
            else:
                dlen = int(rng.integers(2, 9))
                variants.append((pos, seq[pos:pos + dlen + 1], ref_base))
        elif kind.startswith("dense"):
            p = pos
            n = int(kind[5:])
            for _ in range(n):
                rb = seq[p]
                alt = str(rng.choice([b for b in "ACGT" if b != rb]))
                variants.append((p, rb, alt))
                p += int(rng.integers(4, max(5, (K - 6) // n)))
            pos = p
        elif kind == "sv_del":
            dlen = int(rng.integers(150, 401))
            variants.append((pos, seq[pos:pos + dlen + 1], ref_base))
            pos += dlen
        else:
            ins = "".join(rng.choice(list("ACGT"), int(rng.integers(100, 201))))
            variants.append((pos, ref_base, ref_base + ins))
    return seq, variants


def make_coupled_genome_and_variants(rng, scale):
    """Genome and variants of the coupled unit: containment families (a
    deletion over SNVs >= 60 bp from its flanks and from each other),
    segmental-duplication families (a deletion over an SNV at the same
    offset in each of two copies of a 200 bp repeat, so the two children
    share their crossing k-mers) and one dense family, among isolated SNVs.
    Returns (seq, [(pos0, ref, alt)], families), each family (kind,
    deletion index, child indices)."""
    kinds = [k for k, n in COUPLED_MIX for _ in range(int(n * scale))]
    kinds.append("dense")
    rng.shuffle(kinds)
    sizes = {"contain": [int(rng.integers(600, 3001)) for _ in kinds],
             "segdup": 1000, "dense": 200 + (DENSE_SNVS - 1) * DENSE_SPACING,
             "snv": 1}
    total = 600 + sum(600 + (sizes[k][i] if k == "contain" else sizes[k])
                      for i, k in enumerate(kinds))
    bases = np.frombuffer(b"ACGT", np.uint8)
    seq = bytearray(bases[rng.integers(0, 4, total)].tobytes())
    variants, families = [], []

    def snv(p):
        ref = chr(seq[p])
        variants.append((p, ref, str(rng.choice([b for b in "ACGT"
                                                 if b != ref]))))
        return len(variants) - 1

    def deletion(p, dlen, child_pos):
        d = len(variants)
        variants.append((p, seq[p:p + dlen + 1].decode(), chr(seq[p])))
        return d, [snv(q) for q in child_pos]

    pos = 300
    for i, kind in enumerate(kinds):
        pos += int(400 + rng.integers(0, 200))
        if kind == "snv":
            snv(pos)
            pos += 1
            continue
        if kind == "contain":
            dlen = sizes["contain"][i]
            n = int(rng.integers(1, 9))
            span = dlen - 120 - 60 * (n - 1)
            offs = np.sort(rng.integers(0, span, n)) + 60 * np.arange(n)
            kids = [pos + 61 + int(o) for o in offs]
        elif kind == "segdup":
            dlen = sizes["segdup"]
            dup = seq[pos + 100:pos + 300]
            seq[pos + 700:pos + 900] = dup
            kids = [pos + 200, pos + 800]
        else:
            dlen = sizes["dense"]
            kids = [pos + 100 + DENSE_SPACING * j for j in range(DENSE_SNVS)]
        d, children = deletion(pos, dlen, kids)
        if kind == "segdup":  # the same alt at the same repeat offset
            p2, r2, _ = variants[children[1]]
            variants[children[1]] = (p2, r2, variants[children[0]][2])
        families.append((kind, d, children))
        pos += dlen + 1
    return seq.decode(), variants, families


def coupled_haplotypes(rng, variants, families):
    """Per-variant alleles of one haplotype: each family's deletion is
    present with probability 0.3, and then its children carry `*`; else
    each child is ref or alt (a segmental-duplication family's two children
    alike, so that the shared k-mers identify them)."""
    alleles = [int(rng.integers(0, 2)) for _ in variants]
    for kind, d, children in families:
        deleted = rng.random() < 0.3
        alleles[d] = int(deleted)
        same = int(rng.integers(0, 2))
        for c in children:
            alleles[c] = STAR if deleted else (
                same if kind == "segdup" else alleles[c])
    return alleles


def apply_haplotype(seq, variants, alleles):
    """One haplotype's sequence; variants sorted by position. Reference
    and `*` alleles leave the sequence as it is (a `*` child lies inside
    its parent's deleted span)."""
    out, cursor = [], 0
    for (pos, ref, alt), a in zip(variants, alleles):
        if a == 0 or a == STAR:
            continue
        assert pos >= cursor, "overlapping alternative alleles"
        out.append(seq[cursor:pos])
        out.append(alt)
        cursor = pos + len(ref)
    out.append(seq[cursor:])
    return "".join(out)


def simulate(tmp, seed, scale):
    """Write genome.fa, candidates.vcf and one KMC table per sample of the
    main unit. Returns (genome, vcf path, variants, truth, samples)."""
    rng = np.random.default_rng(seed)
    seq, variants = make_genome_and_variants(rng, scale)
    truth = [[tuple(sorted(rng.integers(0, 2, 2))) for _ in variants]
             for _ in range(NUM_SAMPLES)]
    haps = [[[int(g[i]) for g in t] for i in range(2)] for t in truth]
    return write_unit(tmp, rng, seq, variants, haps)


def simulate_coupled(tmp, seed, scale):
    """simulate() for the coupled unit; also returns its families."""
    rng = np.random.default_rng(seed + 1)
    seq, variants, families = make_coupled_genome_and_variants(rng, scale)
    haps = [[coupled_haplotypes(rng, variants, families) for _ in range(2)]
            for _ in range(NUM_SAMPLES)]
    return write_unit(tmp, rng, seq, variants, haps) + (families,)


def random_bases(rng, n):
    return (np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
            .tobytes().decode())


def make_wide_genome_and_variants(rng, scale):
    """The main mix at `scale`, then, in a region of its own after it: 8
    SNVs 4-5 bp apart, WIDE_INS insertions 12 bp apart, and a 600 bp
    deletion over 6 SNVs 4-6 bp apart 200 bp in from its start. Returns
    (seq, variants, families) with the deletion's family."""
    seq, variants = make_genome_and_variants(rng, scale)
    off = len(seq)
    seq += random_bases(rng, 3000)

    def snvs(p, n, lo, hi):
        out = []
        for _ in range(n):
            ref = seq[p]
            out.append(len(variants))
            variants.append((p, ref, str(rng.choice([b for b in "ACGT"
                                                     if b != ref]))))
            p += int(rng.integers(lo, hi))
        return out

    snvs(off + 300, 8, 4, 6)
    n_ins, length = WIDE_INS
    for i in range(n_ins):
        p = off + 1000 + 12 * i
        variants.append((p, seq[p], seq[p] + random_bases(rng, length)))
    p = off + 2000
    d = len(variants)
    variants.append((p, seq[p:p + 601], seq[p]))
    return seq, variants, [("contain", d, snvs(p + 200, 6, 4, 7))]


def simulate_wide(tmp, seed, scale):
    """simulate() for the wide unit (WIDE_SAMPLES samples); also returns
    its family."""
    rng = np.random.default_rng(seed + 2)
    seq, variants, families = make_wide_genome_and_variants(rng, scale)
    haps = [[coupled_haplotypes(rng, variants, families) for _ in range(2)]
            for _ in range(WIDE_SAMPLES)]
    return write_unit(tmp, rng, seq, variants, haps) + (families,)


def write_unit(tmp, rng, seq, variants, haps):
    """genome.fa, candidates.vcf and a KMC table per sample of haplotype
    alleles haps[sample] = (alleles of copy 1, of copy 2): one sample per
    entry of haps."""
    from concurrent.futures import ThreadPoolExecutor

    from bayestyper_tpu_torch.constants import GENDER_FEMALE
    from bayestyper_tpu_torch.io.fasta import Genome, write_fasta
    from bayestyper_tpu_torch.io.kmc import (count_kmers_from_sequences,
                                             write_kmc1)
    from bayestyper_tpu_torch.io.samples import Sample

    genome = Genome()
    genome.names = ["chr1"]
    genome.sequences["chr1"] = seq.encode()
    write_fasta(os.path.join(tmp, "genome.fa"), [("chr1", seq.encode())])
    vcf_path = os.path.join(tmp, "candidates.vcf")
    with open(vcf_path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write(f"##contig=<ID=chr1,length={len(seq)}>\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for pos, ref, alt in variants:
            fh.write(f"chr1\t{pos + 1}\t.\t{ref}\t{alt}\t.\t.\t.\n")
    truth = [[tuple(sorted(a)) for a in zip(*h)] for h in haps]
    num_samples = len(haps)
    sample_seeds = rng.integers(0, 2**63, num_samples)

    def one_sample(si):
        srng = np.random.default_rng(int(sample_seeds[si]))
        h1 = apply_haplotype(seq, variants, haps[si][0])
        h2 = apply_haplotype(seq, variants, haps[si][1])
        hi, lo, mult = count_kmers_from_sequences([h1.encode(), h2.encode()], K)
        m = mult.astype(np.float64)
        mm, vv = COVERAGE * m, 2.0 * COVERAGE * m
        counts = srng.negative_binomial(mm * mm / (vv - mm), mm / vv)
        keep = counts > 0
        prefix = os.path.join(tmp, f"sample{si}")
        write_kmc1(prefix, hi[keep], lo[keep],
                   np.minimum(counts[keep], 2**31 - 1), kmer_length=K)
        return Sample(f"s{si:02d}", GENDER_FEMALE, prefix)

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        samples = list(pool.map(one_sample, range(num_samples)))
    return genome, vcf_path, variants, truth, samples


def concordance(vcf_path, variants, truth, subset=None):
    """(call rate, concordance, genotypes) of a genotyped VCF against the
    truth, over the variant indices in subset (default: all)."""
    from bayestyper_tpu_torch.io.vcf import VcfReader

    pos_to_vi = {pos + 1: vi for vi, (pos, _, _) in enumerate(variants)
                 if subset is None or vi in subset}
    called = correct = total = 0
    for r in VcfReader(vcf_path, parse_samples=True):
        vi = pos_to_vi.get(r.pos)
        if vi is None:
            continue
        for si, s in enumerate(r.samples):
            total += 1
            gt = s["GT"]
            if "." in gt:
                continue
            called += 1
            a = tuple(sorted(int(x) for x in gt.replace("|", "/").split("/")))
            correct += a == truth[si][vi]
    return called / max(total, 1), correct / max(called, 1), total


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps):
    """Median CUDA-event time of fn() in ms, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def device_ms(fn, name, reps=3):
    """Device time in ms per launch of the kernels whose name holds `name`
    over reps calls of fn() after a warm-up call, from torch.profiler's CUDA
    activity (CUPTI); None where it recorded none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [ev for ev in prof.key_averages() if name in ev.key]
    total = sum(ev.self_device_time_total for ev in hits)
    count = sum(ev.count for ev in hits)
    return total / count / 1e3 if total and count else None


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.5f} ms"


def bound(nbytes, ops, int_ops=0):
    """(bound_ms, bound_by): the largest of bytes over the HBM rate,
    float32 operations over the scalar float32 rate and integer operations
    over the INT32 rate (the two pipes run side by side)."""
    t_b = nbytes / PEAK_BYTES_S * 1e3
    t_o = max(ops / PEAK_OPS_S, int_ops / PEAK_INT_OPS_S) * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# operations counted per unit of work (scalar 32-bit ops):
#   threefry2x32 = 20 rounds x (add, rotate, xor) + 5 key injections x 3,
#   all integer
THREEFRY_OPS = 75
#   a float32 lgamma (its rational approximation and log)
LGAMMA_OPS = 40
#   one Gibbs step per (pair, iteration), float32: per (sample, outcome)
#   the logit (prior add, LL add), max, exp, two running sums and a
#   compare; per sample the uniform's conversion and scale; per haplotype
#   the count, the gkey's conversion, a gamma draw's float work (the
#   erfinv polynomial, two logs, sqrt, division) and the normalise; per
#   size t <= H the log-probability (four lgammas, the prior's products)
#   and its exp, sum and compare
STEP_OPS_SO = 8
STEP_OPS_S = 4
STEP_OPS_H = 50
STEP_OPS_T = 4 * LGAMMA_OPS + 12
#   and integer: threefry hashes for the step's nine keys (fold_in(chain,
#   t), k_cat, k_freq, k_size, k_sel, k_gam and the gamma draw's k_boost,
#   k_norm, k_unif), one uniform per sample, one gkey uniform per
#   haplotype and a gamma draw's normal and uniform per haplotype (one
#   rejection round: most accept in the first)
STEP_KEYS = 9


def step_ops(n_pairs, s, o, h):
    """(float32 ops, integer ops) of one Gibbs step of n_pairs pairs:
    n * (8 S O + 4 S + 50 H + (4 LGAMMA_OPS + 12) (H + 1)) and
    n * THREEFRY_OPS * (9 + S + 3 H)."""
    flt = n_pairs * (STEP_OPS_SO * s * o + STEP_OPS_S * s + STEP_OPS_H * h
                     + STEP_OPS_T * (h + 1))
    return flt, n_pairs * THREEFRY_OPS * (STEP_KEYS + s + 3 * h)


#   the rate update's key-only draws (noise_rates_draws): four key
#   derivations per (iteration, chain), then per element the first round's
#   normal and uniform and the boost uniform (three threefry hashes, the
#   erfinv polynomial and log1p); the update per (chain, sample): the
#   shape, scale, d and c, the first round's test (most elements accept
#   there: the least work) with two logs, the log of the rate
RATE_KEY_OPS = 4 * THREEFRY_OPS
RATE_DRAW_OPS, RATE_DRAW_FLOPS = 3 * THREEFRY_OPS, 40
RATE_OPS = 60
#   one gamma_draw element (jax.random.gamma): the element key, the first
#   split, then one outer and one inner rejection round (most elements
#   accept their first: the least work) of a three-way and a two-way split,
#   the normal's and the acceptance uniform's bits and the final uniform's:
#   eleven threefry hashes; the erfinv polynomial and log1p, sqrt and a
#   division for c, and two logs in the test; a pow where alpha < 1
GAMMA_OPS = 11 * THREEFRY_OPS + 90
GAMMA_POW_OPS = 30


@contextlib.contextmanager
def no_plain_rate_update():
    """Replace the port's torch gamma samplers, the plain rate update
    (sampling.fixed_round_gamma and its split form) and the plain prior
    draw (prng._gamma_one_batch), by functions that raise, for the card runs
    of the genotype paths."""
    from bayestyper_tpu_torch.ops import prng, sampling

    real = (sampling.fixed_round_gamma, sampling.fixed_round_gamma_split,
            prng._gamma_one_batch)

    def refuse(*args, **kwargs):
        raise RuntimeError("a plain torch gamma sampler ran on a card path")

    sampling.fixed_round_gamma = sampling.fixed_round_gamma_split = refuse
    prng._gamma_one_batch = refuse
    try:
        yield
    finally:
        (sampling.fixed_round_gamma, sampling.fixed_round_gamma_split,
         prng._gamma_one_batch) = real


# the kernels whose time chip_smoke.py logs on every class of the main unit
CLASS_TIMED = ("gibbs_sweep", "noise_step", "joint_step")


@contextlib.contextmanager
def launches_by_width(counts):
    """Count the launches of CLASS_TIMED's kernels by their outcome width O
    (the last axis of their first tensor) into counts[(name, O)], beside
    kernels.LAUNCHES."""
    from bayestyper_tpu_torch import kernels

    real = kernels._launch_layout

    def counted(name, *args):
        if name in CLASS_TIMED:
            key = (name, int(args[0].shape[-1]))
            counts[key] = counts.get(key, 0) + 1
        return real(name, *args)

    kernels._launch_layout = counted
    try:
        yield counts
    finally:
        kernels._launch_layout = real


def log_class_times(book, by_width):
    """CLASS_TIMED's time on the first chunk of every class, with the
    chunk's real pairs, the path's launches at the class's width and the
    bound."""
    for nm, r in book.times:
        if nm in CLASS_TIMED:
            log(f"  class time {nm} at {r['shape']}: {r['ms']:.4f} ms over "
                f"{r['pairs']} pairs; {by_width.get((nm, r['o']), 0)} "
                f"launches at O = {r['o']} on the path; bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']})")


class KernelBook:
    """Per-kernel results: bars over every class, times at the bulk class."""

    def __init__(self):
        self.rows = {}
        self.times = []
        self.failures = []
        self.osel = [0, 0]  # gibbs_sweep drawn outcomes: agreeing, compared
        self.nosel = [0, 0]  # noise_step drawn outcomes: agreeing, compared
        self.josel = [0, 0]  # joint_step drawn outcomes: agreeing, compared
        self.gt = [0, 0]    # GT calls after the whole scan: agreeing, compared

    def check(self, ok, msg):
        if not ok:
            self.failures.append(msg)

    def err(self, name, value):
        row = self.rows.setdefault(name, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], float(value))

    def timing(self, name, bulk, **kw):
        """Times at one class; the bulk class's go into the JSON line."""
        self.times.append((name, kw))
        if bulk:
            self.rows.setdefault(name, {"max_abs_err": 0.0}).update(kw)

    @contextlib.contextmanager
    def variants(self):
        """Checks filed by the layout that launched: a kernel whose
        global-memory variant ran inside (kernels.GLOBAL), and not its
        shared layout, files its error and, the first time, its times
        (recorded as bulk) under the variant's name; any other kernel adds
        its error to its own row and keeps its times."""
        from bayestyper_tpu_torch import kernels

        before = dict(kernels.LAUNCHES)
        outer, self.rows = self.rows, {}
        try:
            yield
        finally:
            inner, self.rows = self.rows, outer
        moved = {nm for nm, n in kernels.LAUNCHES.items() if n > before[nm]}
        for nm, row in inner.items():
            glob = kernels.GLOBAL.get(nm)
            if glob not in moved:
                self.err(nm, row["max_abs_err"])
                continue
            self.check(nm not in moved, f"{nm}: both layouts in one check")
            dst = self.rows.setdefault(glob, {"max_abs_err": 0.0})
            err = max(dst["max_abs_err"], row["max_abs_err"])
            if "ms" not in dst:
                dst.update(row)
            dst["max_abs_err"] = err


def check_class(book, pc, bucket, tables, filters, seed, bulk, scan=None):
    """Every kernel against its plain version on one chunk of one class;
    the Gibbs scan over the path's iterations, or scan = (iterations,
    burn-in)."""
    from bayestyper_tpu_torch import kernels
    from bayestyper_tpu_torch.model import gibbs, stats
    from bayestyper_tpu_torch.model.buckets import stack_buckets
    from bayestyper_tpu_torch.ops import prng

    plain = kernels.PLAIN
    dev = bucket.mult.device
    cfg = pc.cfg
    ch = cfg.num_chains
    h, k = pc.h, pc.k
    c = bucket.mult.shape[0]
    s = bucket.counts.shape[2]
    outcomes = gibbs.make_outcome_space(h)
    o = outcomes.num_outcomes
    osp = gibbs.outcome_tensors(h, dev)
    mmax = min(cfg.max_total_mult, tables.shape[1] - 1)
    n = c * ch
    tag = f"H{h}/K{k}/C{c}"
    lines = []

    ks = prng.split(prng.prng_key(seed), 2)
    sub_base, fold = gibbs._chain_base(ks[0], ch)
    chain_base, _ = gibbs._chain_base(ks[1], ch)
    # the kernels' key words, converted once as the engine does
    chain_base = kernels.key_words(chain_base, dev)
    fold = kernels.key_words(fold, dev)
    salt = gibbs._SUBSAMPLE_SALT
    rate = cfg.kmer_subsampling_rate

    # -- subsample_masks: bit-equal --
    args = (sub_base, fold, bucket.cluster_id, bucket.kmer_valid, rate, salt)
    w = kernels.subsample_masks(*args)
    w_p = plain["subsample_masks"](*args)
    torch.cuda.synchronize()
    bad = int((w != w_p).sum())
    book.check(bad == 0, f"subsample_masks {tag}: {bad} entries differ")
    book.err("subsample_masks", min(bad, 1))
    lines.append(f"subsample_masks {tag}: {bad} of {w.numel()} differ")
    ms = cuda_ms(lambda: kernels.subsample_masks(*args), 5)
    pms = cuda_ms(lambda: plain["subsample_masks"](*args), 3)
    # bounds count the real clusters and k-mers, not the padding
    c_r = int(bucket.cluster_valid.sum())
    n_r = c_r * ch
    k_r = int(bucket.kmer_valid.sum())
    nbytes = k_r + ch * k_r + c_r * 8 + ch * 12
    ops = THREEFRY_OPS * (ch * k_r + 2 * n_r)
    bms, by = bound(nbytes, ops)
    book.timing("subsample_masks", bulk, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=None, shape=tag)

    # -- ll_noise_terms, genotype form and noise form --
    ll_args = (bucket.mult, bucket.inter_mult, bucket.counts, w, tables, mmax,
               osp.oa32, osp.ob32)
    ll, _ = kernels.ll_noise_terms(*ll_args, include_noise_row=True)
    ll_p, _ = plain["ll_noise_terms"](*ll_args, include_noise_row=True)
    llg, abc = kernels.ll_noise_terms(*ll_args, include_noise_row=False,
                                      noise_terms=True)
    llg_p, abc_p = plain["ll_noise_terms"](*ll_args, include_noise_row=False,
                                           noise_terms=True)
    torch.cuda.synchronize()
    for nm, x, y in (("LL", ll, ll_p), ("LLg", llg, llg_p),
                     ("A", abc[0], abc_p[0]), ("B", abc[1], abc_p[1]),
                     ("C0", abc[2], abc_p[2])):
        err = float((x - y).abs().max())
        ok = bool(torch.isfinite(x).all()) and torch.allclose(
            x, y, rtol=LL_RTOL, atol=LL_ATOL)
        book.check(ok, f"ll_noise_terms {tag} {nm}: max abs err {err}")
        book.err("ll_noise_terms", err)
    lines.append(f"ll_noise_terms {tag}: max abs err LL "
                 f"{float((ll - ll_p).abs().max()):.3g}")
    ms = cuda_ms(lambda: kernels.ll_noise_terms(*ll_args), 5)
    pms = cuda_ms(lambda: plain["ll_noise_terms"](*ll_args), 3)
    n_sub = int(w.sum())
    nbytes = (k_r * (h + 2 * s) + ch * k_r + tables[:, :mmax + 1].numel() * 4
              + n_r * s * o * 4)
    ops = 2 * n_sub * s * o
    bms, by = bound(nbytes, ops)
    book.timing("ll_noise_terms", bulk, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=None, shape=tag)
    del llg_p, abc_p

    # -- gibbs_sweep: one iteration from the same LL, freqs and keys --
    sb = stack_buckets([bucket])
    fields = gibbs._cluster_fields(sb)
    ll_n = ll.reshape(n, s, o)
    freqs0 = gibbs._freqs0(sb, ch).reshape(n, h)
    agree = total = 0
    for t in (0, 1, 200):
        f_k, _, o_k = kernels.gibbs_sweep(ll_n, *fields, chain_base, fold,
                                          freqs0.clone(), t, t + 1, t + 1, osp)
        f_p, _, o_p = plain["gibbs_sweep"](ll_n, *fields, chain_base, fold,
                                           freqs0.clone(), t, t + 1, t + 1,
                                           osp)
        torch.cuda.synchronize()
        same = o_k == o_p
        agree += int(same.sum())
        total += same.numel()
        pair_same = same.all(dim=1)
        ferr = float((f_k - f_p)[pair_same].abs().max()) if bool(
            pair_same.any()) else 0.0
        book.check(ferr <= FREQ_ATOL,
                   f"gibbs_sweep {tag} t={t}: freqs differ by {ferr}")
        book.err("gibbs_sweep", ferr)
    book.osel[0] += agree
    book.osel[1] += total
    lines.append(f"gibbs_sweep {tag}: one iteration, drawn outcomes agree "
                 f"on {agree}/{total}")

    # -- gibbs_sweep: the whole scan -> GT calls --
    iters, burn_in = scan or (cfg.burn_in + cfg.num_samples, cfg.burn_in)

    def scan(fn):
        tally = torch.zeros((n, s, o), dtype=torch.int32, device=dev)
        fn(ll_n, *fields, chain_base, fold, freqs0.clone(), 0, iters,
           burn_in, osp, tally)
        return tally

    t_k = scan(kernels.gibbs_sweep)
    t_p = scan(plain["gibbs_sweep"])
    torch.cuda.synchronize()
    book.check(bool((t_k.sum(-1) == iters - burn_in).all()),
               f"gibbs_sweep {tag}: tally rows do not sum to the samples")
    gts = [stats.collect_bucket_stats(
        bucket, outcomes, tally.reshape(c, ch, s, o), w, filters,
        allele_capacity=pc.a, mac_top_t=o if o <= 64 else 8).gt
        for tally in (t_k, t_p)]                           # [C, S, V, 2]
    real = (bucket.cluster_valid[:, None, None]
            & bucket.variant_valid[:, None, :]).expand(c, s, -1)
    gt_same = (gts[0] == gts[1]).all(dim=-1)[real]
    book.gt[0] += int(gt_same.sum())
    book.gt[1] += gt_same.numel()
    lines.append(f"gibbs_sweep {tag}: {iters}-iteration scan, GT calls agree "
                 f"on {int(gt_same.sum())}/{gt_same.numel()}")
    ms = cuda_ms(lambda: scan(kernels.gibbs_sweep), 5)
    pms = event_ms(lambda: scan(plain["gibbs_sweep"]))
    nbytes = n_r * s * o * 4 * 2 + n_r * h * 4
    f_ops, i_ops = step_ops(n_r, s, o, h)
    bms, by = bound(nbytes, iters * f_ops, iters * i_ops)
    book.timing("gibbs_sweep", bulk, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=None, shape=f"{tag} x{iters}",
                pairs=n_r, o=o)

    # -- bucket_stats, the main path's packed form, from the scan's tally --
    t_top = o if o <= 64 else 8
    st_args = (bucket.mult, bucket.inter_mult, bucket.counts, bucket.member,
               bucket.hap_allele, bucket.num_alleles, bucket.ploidy,
               t_k.reshape(c, ch, s, o), w, osp.oa32, osp.ob32, pc.a, t_top,
               filters.min_genotype_posterior, filters.min_number_of_kmers,
               torch.tensor(filters.min_fraction_observed_kmers), True)
    lines.append(check_stats(book, tag, bucket, st_args, bulk))
    del t_k, t_p

    # -- noise_step: exact int32 statistics from identical outcomes --
    cv = bucket.cluster_valid.to(torch.float32)
    a_t, b_t, c0_t = abc
    c0_t[..., -1] = 0.0
    llg_n = (llg - c0_t).reshape(n, s, o)
    a_n, b_n = a_t.reshape(n, s, o), b_t.reshape(n, s, o)
    rates = torch.full((ch, s), 2e-3, device=dev)
    log_r = torch.log(rates)

    def nstep(fn, cs, no):
        return fn(llg_n, a_n, b_n, cv, log_r, rates, *fields, chain_base,
                  fold, freqs0.clone(), 7, osp, cs, no)

    zeros = lambda: torch.zeros((ch, s), dtype=torch.int32, device=dev)  # noqa: E731
    cs_k, no_k = zeros(), zeros()
    f_k, o_k = nstep(kernels.noise_step, cs_k, no_k)
    f_p, o_p = nstep(plain["noise_step"], zeros(), zeros())
    sel = o_k.to(torch.int64)[..., None]
    cvp = cv.repeat_interleave(ch)[:, None]
    want_cs = (torch.gather(a_n, 2, sel)[..., 0] * cvp).to(torch.int32) \
        .reshape(c, ch, s).sum(0, dtype=torch.int32)
    want_no = (torch.gather(b_n, 2, sel)[..., 0] * cvp).to(torch.int32) \
        .reshape(c, ch, s).sum(0, dtype=torch.int32)
    torch.cuda.synchronize()
    d = int((cs_k - want_cs).abs().max()) + int((no_k - want_no).abs().max())
    book.check(d == 0, f"noise_step {tag}: int32 statistics differ by {d}")
    book.err("noise_step", d)
    same = o_k == o_p
    pair_same = same.all(dim=1)
    ferr = float((f_k - f_p)[pair_same].abs().max()) if bool(
        pair_same.any()) else 0.0
    book.check(ferr <= FREQ_ATOL,
               f"noise_step {tag}: freqs differ by {ferr}")
    book.err("noise_step", ferr)
    book.nosel[0] += int(same.sum())
    book.nosel[1] += same.numel()
    lines.append(f"noise_step {tag}: statistics differ by {d}; drawn "
                 f"outcomes agree on {int(same.sum())}/{same.numel()}, "
                 f"freqs within {ferr:.3g} where they agree")
    ms = cuda_ms(lambda: nstep(kernels.noise_step, zeros(), zeros()), 5)
    pms = cuda_ms(lambda: nstep(plain["noise_step"], zeros(), zeros()), 3)
    nbytes = 3 * n_r * s * o * 4 + 2 * n_r * h * 4 + c_r * 4
    f_ops, i_ops = step_ops(n_r, s, o, h)
    bms, by = bound(nbytes, f_ops + 4 * n_r * s * o, i_ops)
    book.timing("noise_step", bulk, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=None, shape=tag, pairs=n_r, o=o)
    return lines


def stats_cost(bucket, ch, s, o, a_cap, t_top):
    """(bytes, operations) of one bucket_stats call on the real clusters,
    k-mers and variants: every input read once and every output written
    once; per (cluster, sample, variant) the chain x haplotype x k-mer count
    sums, the chain x T x k-mer MAC sums and the per-outcome and per-allele
    sums; per (cluster, sample) a top-T selection over the outcomes."""
    real = bucket.cluster_valid
    c_r = int(real.sum())
    k_c = bucket.kmer_valid[real].sum(dim=1).double()
    v_c = bucket.variant_valid[real].sum(dim=1).double()
    h = bucket.num_haplotypes
    w_words = bucket.member.shape[3]
    v_pad = bucket.member.shape[2]
    g = a_cap * (a_cap + 1) // 2
    k_r = float(k_c.sum())
    nbytes = (c_r * ch * s * o * 4 + ch * k_r + k_r * v_pad * w_words * 4
              + k_r * (h + 2 * s) + c_r * s * v_pad * (g + a_cap) * 4
              + c_r * s * v_pad * (2 + 4 * a_cap))
    per_v = (ch * (h + 1) * k_c * 2 + ch * t_top * k_c * 8 + ch * o * 14
             + a_cap * (o * 8 + ch * t_top * 8))
    top = o * max(1, (t_top - 1).bit_length())
    ops = s * float((v_c * per_v).sum()) + c_r * s * top
    return nbytes, ops


def check_stats(book, tag, bucket, args, bulk, missing=None, mac_extra=None):
    """bucket_stats against its plain version: integer fields exact, float
    fields within STATS_RTOL / STATS_ATOL (float16 ones within 1e-3)."""
    from bayestyper_tpu_torch import kernels

    kw = dict(missing=missing, mac_extra=mac_extra)
    got = kernels.bucket_stats(*args, **kw)
    want = kernels.PLAIN["bucket_stats"](*args, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for i, (g, x) in enumerate(zip(got, want)):
        if g.dtype.is_floating_point:
            g, x = g.float(), x.float()
            rtol = 1e-3 if got[i].dtype == torch.float16 else STATS_RTOL
            ok = bool(torch.isclose(g, x, rtol=rtol, atol=STATS_ATOL).all())
            err = max(err, float((g - x).abs().max()) if g.numel() else 0.0)
        else:
            ok = torch.equal(g, x)
        book.check(ok, f"bucket_stats {tag}: output {i} differs")
    book.err("bucket_stats", err)
    ms = cuda_ms(lambda: kernels.bucket_stats(*args, **kw), 5)
    pms = cuda_ms(lambda: kernels.PLAIN["bucket_stats"](*args, **kw), 2)
    _, ch, s, o = args[7].shape
    bms, by = bound(*stats_cost(bucket, ch, s, o, args[11], args[12]))
    book.timing("bucket_stats", bulk, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=None, shape=tag)
    form = "packed" if args[16] else "unpacked"
    return (f"bucket_stats {tag} ({form}): max abs err {err:.3g}; {ms:.3f} "
            f"ms, plain {pms:.3f} ms, bound {bms:.4f} ms ({by})")


def check_cap(book, pc, bucket, seed):
    """The exact k-mer cap (gibbs.apply_kmer_cap, plain torch on the
    bucket's device) with a cap low enough to bind: the card's masks must
    equal the CPU's bit for bit."""
    from bayestyper_tpu_torch.model import gibbs
    from bayestyper_tpu_torch.ops import prng

    cfg = dataclasses.replace(pc.cfg, apply_cap=True,
                              max_haplotype_variant_kmers=FORCED_CAP)
    base, fold = gibbs._chain_base(prng.prng_key(seed), cfg.num_chains)
    t0 = time.perf_counter()
    w = gibbs._subsample_with_cap(base, fold, bucket, cfg)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    w_cpu = gibbs._subsample_with_cap(base, fold, bucket.to_device("cpu"), cfg)
    t_cpu = time.perf_counter() - t0
    bad = int((w.cpu() != w_cpu).sum())
    uncapped = int(gibbs._subsample_with_cap(
        base, fold, bucket, dataclasses.replace(
            cfg, max_haplotype_variant_kmers=pc.k)).sum())
    tag = f"H{pc.h}/K{pc.k}/C{bucket.mult.shape[0]}"
    book.check(bad == 0, f"apply_kmer_cap {tag}: {bad} entries differ")
    book.check(int(w_cpu.sum()) < uncapped,
               f"apply_kmer_cap {tag}: cap {FORCED_CAP} did not bind")
    return (f"apply_kmer_cap {tag}, cap {FORCED_CAP}: card vs CPU {bad} of "
            f"{w.numel()} differ; keeps {int(w_cpu.sum())} of {uncapped} "
            f"subsampled k-mers; card {t_card:.2f} s, CPU {t_cpu:.2f} s")


def check_cap_timed(book, pc, bucket, seed):
    """kmer_cap against its plain version on the card, from the path's
    split of the subsample key, at the class's own cap and rate, at
    FORCED_CAP and at rate 1.0 (every valid k-mer kept): masks bit-equal,
    the cap binding; CUDA-event times (the plain version's timed once), the
    variant that launched and how many pairs sorted in device memory. The
    class's own cap and rate give the kernel's row. Returns the lines."""
    from bayestyper_tpu_torch import kernels
    from bayestyper_tpu_torch.model import gibbs
    from bayestyper_tpu_torch.ops import prng

    cfg = pc.cfg
    base, fold = gibbs._chain_base(prng.prng_key(seed), cfg.num_chains)
    kk = prng.split(base, 2)
    tag = f"H{pc.h}/K{pc.k}/C{bucket.num_clusters}"
    own = cfg.max_haplotype_variant_kmers
    lines = []
    for cap, rate in ((own, cfg.kmer_subsampling_rate),
                      (FORCED_CAP, cfg.kmer_subsampling_rate), (own, 1.0)):
        w0 = kernels.subsample_masks(kk[:, 0], fold, bucket.cluster_id,
                                     bucket.kmer_valid, rate,
                                     gibbs._SUBSAMPLE_SALT)
        args = (kk[:, 1], fold, bucket.cluster_id, w0, bucket.member,
                bucket.num_haplotypes, cap, gibbs._CAP_SALT)
        before = dict(kernels.LAUNCHES)
        w_k = kernels.kmer_cap(*args)
        layout = "/".join(nm for nm in ("kmer_cap", "kmer_cap_global")
                          if kernels.LAUNCHES[nm] > before[nm])
        out = []
        pms = event_ms(lambda: out.append(kernels.PLAIN["kmer_cap"](*args)))
        bad = int((w_k != out[0]).sum())
        case = f"{tag} cap {cap} rate {rate}"
        book.check(bad == 0, f"kmer_cap {case}: {bad} entries differ")
        book.check(int(w_k.sum()) < int(w0.sum()),
                   f"kmer_cap {case}: the cap did not bind")
        book.err("kmer_cap", min(bad, 1))
        ms = cuda_ms(lambda: kernels.kmer_cap(*args), 3)
        dms = device_ms(lambda: kernels.kmer_cap(*args), "bt_kmer_cap_kernel")
        *cost, counts = cap_cost(bucket, w0, cap)
        bms, by = bound(*cost)
        path = (cap, rate) == (own, cfg.kmer_subsampling_rate)
        book.timing("kmer_cap", path, ms=ms, plain_ms=pms, bound_ms=bms,
                    bound_by=by, library_ms=None, shape=f"{case} ({layout})",
                    device_ms=dms)
        lines.append(
            f"kmer_cap {case} ({layout}): {bad} of {w_k.numel()} differ; "
            f"keeps {int(w_k.sum())} of {int(w0.sum())}; binds on "
            f"{counts['binding']} of {counts['pairs']} pairs, at most "
            f"{counts['max_m']} kept k-mers, {counts['device_sorted']} "
            f"sorted in device memory; {ms:.3f} ms (device {fmt_ms(dms)}), "
            f"plain {pms:.3f} ms, bound {bms:.4f} ms ({by})")
        del w0, w_k, out
    return lines


def check_unpack(book, pc, samples, ploidy, ucounts, opts, dev, bulk):
    """unpack_bucket (the JAX package's _unpack_bucket_jit, engine.py:
    1439-1474) on the first chunk of a class: the kernel's dense tensors
    equal its plain version's and the host's dense build bit for bit;
    CUDA-event times against the bytes it must move (ragged rows in, dense
    out)."""
    from bayestyper_tpu_torch import engine, kernels

    chunk = pc.chunks[0]
    host = engine._build_bucket_batch(chunk, (pc.c_pad, pc.k, pc.h, pc.v),
                                      samples, ploidy, ucounts,
                                      opts.random_seed)
    args = engine._ragged_rows(host, chunk, samples, dev)
    got = kernels.unpack_bucket(*args)
    want = kernels.PLAIN["unpack_bucket"](*args)
    dense = (host.counts, host.inter_mult, host.mult,
             host.member.view(np.int32), host.kmer_valid)
    torch.cuda.synchronize()
    tag = f"H{pc.h}/K{pc.k}/C{pc.c_pad}"
    bad = sum(int((g != w).sum()) + int((g.cpu().numpy() != d).sum())
              for g, w, d in zip(got, want, dense))
    book.check(bad == 0, f"unpack_bucket {tag}: {bad} entries differ")
    book.err("unpack_bucket", min(bad, 1))
    ms = cuda_ms(lambda: kernels.unpack_bucket(*args), 5)
    pms = cuda_ms(lambda: kernels.PLAIN["unpack_bucket"](*args), 3)
    nbytes = sum(a.numel() * a.element_size() for a in args[:-1]) + sum(
        o.numel() * o.element_size() for o in got)
    bms, by = bound(nbytes, 0)
    book.timing("unpack_bucket", bulk, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=None, shape=tag)
    return (f"unpack_bucket {tag}: {bad} entries differ from the plain "
            f"version and the host build; {ms:.3f} ms, plain {pms:.3f} ms, "
            f"bound {bms:.4f} ms ({by}, {nbytes} bytes)")


def kernel_phase(unit, samples, ploidy, opts, dev, scan=None,
                 variants=False):
    """Build the first chunk of every size class the way genotype_unit
    does, and hold each kernel against its plain version on it (the Gibbs
    scan over `scan` = (iterations, burn-in) when given). With variants,
    each class's checks are filed by the layout that launched
    (KernelBook.variants), and the class with the most k-mer slots also
    holds kmer_cap against its plain version with times (check_cap_timed).
    """
    from bayestyper_tpu_torch import engine
    from bayestyper_tpu_torch.model.count_model import fit_genomic_nb
    from bayestyper_tpu_torch.model.stats import FilterConfig
    from bayestyper_tpu_torch.ops.distributions import (
        np_build_count_log_prob_tables, tables_from_numpy)

    table, counts = engine.gather_sample_counts(unit, samples,
                                                opts.num_host_threads)
    nb = fit_genomic_nb(engine.parameter_kmer_stats(unit, samples, table,
                                                    counts))
    ucounts = engine._UnitCounts(unit, table, counts)
    singles = list(unit.compiled)
    plan = engine._plan_unit(singles, engine._class_map(singles), opts,
                             samples, None)
    tables = tables_from_numpy(np_build_count_log_prob_tables(
        nb.p, nb.size, np.full(len(samples), 1e-3), 255), dev)
    filters = FilterConfig.from_model(nb.mean, opts.min_genotype_posterior,
                                      opts.min_number_of_kmers)
    bulk = max(plan, key=lambda kc: sum(len(ch) for ch in plan[kc].chunks))
    widest = max(plan, key=lambda kc: (plan[kc].h, plan[kc].k))
    capped = sorted(f"H{kc[0]}/K{kc[1]}" for kc in plan
                    if plan[kc].cfg.apply_cap)
    log(f"  apply_kmer_cap on the main path: {len(capped)} of {len(plan)} "
        f"classes {capped}")
    longest = max(plan, key=lambda kc: plan[kc].k)
    book = KernelBook()
    for key_cls in sorted(plan):
        pc = plan[key_cls]
        with book.variants() if variants else contextlib.nullcontext():
            log("  " + check_unpack(book, pc, samples, ploidy, ucounts, opts,
                                    dev, variants or key_cls == bulk))
            bucket = engine._bucket_cached(
                None, pc.chunks[0], (pc.c_pad, pc.k, pc.h, pc.v), samples,
                ploidy, ucounts, opts.random_seed, dev)
            for line in check_class(book, pc, bucket, tables, filters,
                                    opts.random_seed,
                                    variants or key_cls == bulk, scan):
                log("  " + line)
            if key_cls == widest:
                log("  " + check_cap(book, pc, bucket, opts.random_seed))
            if variants and key_cls == longest:
                for line in check_cap_timed(book, pc, bucket,
                                            opts.random_seed):
                    log("  " + line)
        del bucket
        torch.cuda.empty_cache()
    book.check(book.osel[0] >= OSEL_AGREE_MIN * book.osel[1],
               f"gibbs_sweep drawn outcomes agree on "
               f"{book.osel[0]}/{book.osel[1]}")
    book.check(book.nosel[0] >= OSEL_AGREE_MIN * book.nosel[1],
               f"noise_step drawn outcomes agree on "
               f"{book.nosel[0]}/{book.nosel[1]}")
    book.check(book.gt[0] >= GT_AGREE_MIN * book.gt[1],
               f"GT calls agree on {book.gt[0]}/{book.gt[1]}")
    return book, plan


def joint_step_cost(n_r, s, o, h, c_r):
    """(bytes, float32 operations, integer operations) of one joint_step
    launch on n_r real pairs: llg, a and b read once, frequencies read and
    written, the pooling mask, and per (pair, sample) the tally entry of
    the drawn outcome read and written and the outcome written; the Gibbs
    step (step_ops) and the LL build (4 S O float ops per pair)."""
    nbytes = 3 * n_r * s * o * 4 + 2 * n_r * h * 4 + c_r * 4 + 3 * n_r * s * 4
    f_ops, i_ops = step_ops(n_r, s, o, h)
    return nbytes, f_ops + 4 * n_r * s * o, i_ops


def check_joint_class(book, pc, su, cv_real, burn_in, bulk):
    """joint_step against its plain version on one class's first chunk: one
    iteration at t = 0, 1 and 200 from the same state (burn-in 100). Drawn
    outcomes are counted for the phase's bar; the kernel's int32 statistics
    and tally increments must be exact for its own draws, and frequencies
    match where the draws agree."""
    from bayestyper_tpu_torch import kernels

    dev = su.llg.device
    n, s, o = su.llg.shape
    ch = su.chain_base.shape[0]
    h = su.freqs.shape[1]
    tag = f"H{pc.h}/K{pc.k}/C{n // ch}"
    rates = torch.full((ch, s), 2e-3, device=dev)
    log_r = torch.log(rates)
    zeros = lambda: torch.zeros((ch, s), dtype=torch.int32, device=dev)  # noqa: E731

    def jstep(fn, t, cs, no, tally):
        return fn(su.llg, su.a, su.b, su.cv, log_r, rates, *su.fields,
                  su.chain_base, su.fold, su.freqs.clone(), t, su.osp, cs,
                  no, tally, burn_in)

    agree = total = 0
    ferr = 0.0
    d = 0
    cvp = su.cv.repeat_interleave(ch)[:, None]
    for t in (0, 1, 200):
        cs_k, no_k = zeros(), zeros()
        t_k = torch.zeros((n, s, o), dtype=torch.int32, device=dev)
        f_k, o_k = jstep(kernels.joint_step, t, cs_k, no_k, t_k)
        f_p, o_p = jstep(kernels.PLAIN["joint_step"], t, zeros(), zeros(),
                         torch.zeros_like(t_k))
        sel = o_k.to(torch.int64)[..., None]
        want = [(torch.gather(x, 2, sel)[..., 0] * cvp).to(torch.int32)
                .reshape(-1, ch, s).sum(0, dtype=torch.int32)
                for x in (su.a, su.b)]
        onehot = torch.zeros_like(t_k).scatter_(2, sel, 1)
        torch.cuda.synchronize()
        d += int((cs_k - want[0]).abs().max()) + int(
            (no_k - want[1]).abs().max())
        d += int((t_k - (onehot if t >= burn_in else 0)).abs().max())
        same = o_k == o_p
        agree += int(same.sum())
        total += same.numel()
        pair_same = same.all(dim=1)
        if bool(pair_same.any()):
            ferr = max(ferr, float((f_k - f_p)[pair_same].abs().max()))
    book.check(d == 0, f"joint_step {tag}: statistics or tally differ by {d}")
    book.check(ferr <= FREQ_ATOL, f"joint_step {tag}: freqs differ by {ferr}")
    book.err("joint_step", max(d, ferr))
    book.josel[0] += agree
    book.josel[1] += total
    t_k = torch.zeros((n, s, o), dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: jstep(kernels.joint_step, 200, zeros(), zeros(),
                               t_k), 5)
    pms = cuda_ms(lambda: jstep(kernels.PLAIN["joint_step"], 200, zeros(),
                                zeros(), t_k), 3)
    c_r = int(cv_real)
    bms, by = bound(*joint_step_cost(c_r * ch, s, o, h, c_r))
    book.timing("joint_step", bulk, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=None, shape=tag, pairs=c_r * ch,
                o=o)
    return (f"joint_step {tag}: statistics and tally exact (differ by {d}); "
            f"drawn outcomes agree on {agree}/{total}, freqs within "
            f"{ferr:.3g} where they agree; {ms:.3f} ms, plain {pms:.3f} ms, "
            f"bound {bms:.4f} ms ({by})")


def record_rate_scan(setups, step, k_noise, init_rates, iters, prior):
    """Iterations 0..iters-1 of a noise or joint scan through the kernels,
    as gibbs._rate_scan runs them: the scan's rate draws, then per
    iteration step(su, t, log_r, rates, cs, no) on every class and the
    rate update, with count_sum/num_obs recorded before every update.
    Returns (trace [ch, iters, S], recorded)."""
    from bayestyper_tpu_torch import kernels

    dev = init_rates.device
    ch, s = init_rates.shape
    rates = init_rates.clone()
    log_r = torch.log(torch.clamp_min(rates, 1e-30))
    cs = torch.zeros((ch, s), dtype=torch.int32, device=dev)
    no = torch.zeros_like(cs)
    trace = torch.empty((ch, iters, s), device=dev)
    draws = kernels.noise_rate_draws(k_noise, trace)
    recorded = []
    for t in range(iters):
        for su in setups:
            step(su, t, log_r, rates, cs, no)
        recorded.append((cs.clone(), no.clone()))
        kernels.noise_rate_update(draws, cs, no, rates, log_r, trace, t,
                                  *prior)
    return trace, recorded


def replay_updates(book, k_noise, recorded, trace, prior, label):
    """Each recorded rate update replayed through noise_rates (that
    iteration's draws, then the update) and its plain version: the
    kernels' replays equal the scan's trace and zero the statistics, and
    the plain version agrees within RATES_RTOL on
    RATES_AGREE_MIN of the entries (every flip printed). Returns (flips,
    worst relative difference, entries, the last replay's buffers)."""
    from bayestyper_tpu_torch import kernels

    ch, iters, s = trace.shape
    dev = trace.device

    def replay(fn, t):
        c, n = (x.clone() for x in recorded[t])
        r, lr = torch.empty((ch, s), device=dev), torch.empty((ch, s),
                                                              device=dev)
        tr = torch.zeros((ch, iters, s), device=dev)
        fn(k_noise, c, n, r, lr, tr, t, *prior)
        return r, lr, c, n

    flips, worst, same_trace = [], 0.0, True
    zeroed = True
    for t in range(len(recorded)):
        r_k, lr_k, c_k, n_k = replay(kernels.noise_rates, t)
        r_p, lr_p, _, _ = replay(kernels.PLAIN["noise_rates"], t)
        torch.cuda.synchronize()
        same_trace &= torch.equal(r_k, trace[:, t])
        zeroed &= not (c_k.any() or n_k.any())
        rel = ((r_k - r_p).abs() / r_p.abs().clamp_min(1e-30))
        worst = max(worst, float(rel.max()))
        book.err("noise_rates", float((r_k - r_p).abs().max()))
        close_log = torch.isclose(lr_k, lr_p, rtol=RATES_RTOL, atol=1e-6)
        for x, y in torch.nonzero((rel > RATES_RTOL) | ~close_log).tolist():
            flips.append((t, x, y, float(r_k[x, y]), float(r_p[x, y])))
    n_all = len(recorded) * ch * s
    book.check(same_trace, f"{label}: noise_rates replay differs from the "
                           f"scan's trace")
    book.check(zeroed, f"{label}: noise_rates left statistics unzeroed")
    book.check(len(flips) <= (1 - RATES_AGREE_MIN) * n_all,
               f"{label}: {len(flips)} of {n_all} rates differ by more than "
               f"{RATES_RTOL} relative")
    for f in flips:
        log(f"  {label} noise_rates flip (iteration, chain, sample, kernel, "
            f"plain): {f}")
    return flips, worst, n_all, replay(kernels.noise_rates, len(recorded) - 1)


def replay_rates(book, setups, opts, init_rates, dev):
    """A joint scan of opts' iterations over the given classes through the
    kernels, recording count_sum/num_obs before every rate update; then
    each update replayed through noise_rates and its plain version: the
    replayed kernels equal the scan's trace, and the plain version agrees
    within RATES_RTOL on RATES_AGREE_MIN of the entries (flips printed);
    the draws against their plain version (check_rate_draws). The update's
    time is a run of the scan's launches back to back over their count,
    beside one launch between two events."""
    from bayestyper_tpu_torch import kernels
    from bayestyper_tpu_torch.model import gibbs
    from bayestyper_tpu_torch.ops import prng

    iters = opts.burn_in + opts.num_samples
    prior = opts.noise_rate_prior
    _, k_noise = gibbs._chain_keys(prng.prng_key(opts.random_seed),
                                   opts.num_chains, 0)
    k_noise = kernels.key_words(k_noise, dev)
    ch, s = init_rates.shape

    def step(su, t, log_r, rates, cs, no):
        kernels.joint_step(su.llg, su.a, su.b, su.cv, log_r, rates,
                           *su.fields, su.chain_base, su.fold, su.freqs, t,
                           su.osp, cs, no, su.tally, opts.burn_in)

    trace, recorded = record_rate_scan(setups, step, k_noise, init_rates,
                                       iters, prior)
    flips, worst, n_all, bufs = replay_updates(book, k_noise, recorded, trace,
                                               prior, "joint")
    draws_line = check_rate_draws(book, k_noise, trace)
    # the update alone on fixed buffers (it zeroes the statistics it reads;
    # its work does not depend on them beyond the rejection rounds): one
    # launch between two events, and a run of `iters` launches back to back
    # over the scan's iterations divided by their count
    draws = kernels.noise_rate_draws(k_noise, trace)
    tr = torch.zeros((ch, iters, s), device=dev)
    args = (bufs[2], bufs[3], bufs[0], bufs[1], tr)
    single_ms = cuda_ms(lambda: kernels.noise_rate_update(
        draws, *args, iters - 1, *prior), 20)

    def run():
        for t in range(iters):
            kernels.noise_rate_update(draws, *args, t, *prior)

    ms = cuda_ms(run, 3) / iters
    dms = device_ms(run, "bt_noise_rates_kernel")
    pms = cuda_ms(lambda: kernels.PLAIN["noise_rates"](
        k_noise, *args, iters - 1, *prior), 5)
    nbytes = ch * s * (2 * 4 + 3 * 4 + 2 * 4 + 3 * 4) + ch * 16
    bms, by = bound(nbytes, ch * s * RATE_OPS)
    book.timing("noise_rates", True, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=None, shape=f"[{ch}, {s}]",
                device_ms=dms)
    return (f"noise_rates: {iters} rate updates of [{ch}, {s}] replayed from "
            f"the joint scan's statistics: kernel replays equal the scan's "
            f"trace; {n_all - len(flips)}/{n_all} within {RATES_RTOL} "
            f"relative of the plain version (worst {worst:.3g}, "
            f"{len(flips)} flips); the update {ms:.5f} ms a launch over "
            f"{iters} back to back ({single_ms:.4f} ms for one between two "
            f"events; device time {fmt_ms(dms)} a launch), plain "
            f"{pms:.3f} ms, bound {bms:.6f} ms ({by}); " + draws_line)


def check_rate_draws(book, k_noise, trace):
    """noise_rates_draws for every iteration of trace [ch, T, S] against
    its plain version: keys equal, floats within RATES_RTOL (XLA's erfinv
    polynomial and a log1p on the card); CUDA-event times."""
    from bayestyper_tpu_torch import kernels

    ch, iters, s = trace.shape
    got = kernels.noise_rate_draws(k_noise, trace)
    want = kernels.PLAIN["noise_rates_draws"](k_noise, trace)
    torch.cuda.synchronize()
    same_keys = torch.equal(got.keys.to(torch.int64) & 0xFFFFFFFF,
                            want.keys)
    err = float((got.draws - want.draws).abs().max())
    close = torch.isclose(got.draws, want.draws, rtol=RATES_RTOL, atol=1e-6)
    book.check(same_keys, "noise_rates_draws: keys differ from the plain "
                          "version's")
    book.check(bool(close.all()), f"noise_rates_draws: "
               f"{int((~close).sum())} draws differ by more than "
               f"{RATES_RTOL} relative")
    book.err("noise_rates_draws", err)
    ms = cuda_ms(lambda: kernels.noise_rate_draws(k_noise, trace), 5)
    dms = device_ms(lambda: kernels.noise_rate_draws(k_noise, trace),
                    "bt_noise_rates_draws_kernel")
    pms = cuda_ms(lambda: kernels.PLAIN["noise_rates_draws"](k_noise, trace),
                  3)
    n = iters * ch * s
    bms, by = bound(n * 12 + iters * ch * 24 + ch * 8,
                    n * RATE_DRAW_FLOPS,
                    iters * ch * RATE_KEY_OPS + n * RATE_DRAW_OPS)
    book.timing("noise_rates_draws", True, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=None, shape=f"[{iters}, {ch}, {s}]",
                device_ms=dms)
    return (f"noise_rates_draws [{iters}, {ch}, {s}]: keys "
            f"{'equal' if same_keys else 'DIFFER'}, draws within {err:.3g} "
            f"of the plain version; {ms:.4f} ms (device {fmt_ms(dms)}), "
            f"plain {pms:.3f} ms, bound {bms:.6f} ms ({by})")


def joint_check(book, plan, unit, samples, ploidy, opts, dev):
    """Phase 6's kernel checks: the first chunk of every size class of the
    main unit set up as genotype_unit_joint sets it up (every real cluster
    pools), joint_step per class and the rate-update replay over all."""
    from bayestyper_tpu_torch import engine
    from bayestyper_tpu_torch.model import gibbs
    from bayestyper_tpu_torch.model.buckets import stack_buckets
    from bayestyper_tpu_torch.model.count_model import fit_genomic_nb
    from bayestyper_tpu_torch.ops import prng
    from bayestyper_tpu_torch.ops.distributions import (
        np_build_count_log_prob_tables, tables_from_numpy)

    table, counts = engine.gather_sample_counts(unit, samples,
                                                opts.num_host_threads)
    nb = fit_genomic_nb(engine.parameter_kmer_stats(unit, samples, table,
                                                    counts))
    ucounts = engine._UnitCounts(unit, table, counts)
    tables = tables_from_numpy(np_build_count_log_prob_tables(
        nb.p, nb.size, np.full(len(samples), 1e-3), 255), dev)
    key = prng.prng_key(opts.random_seed)
    k_master, _ = gibbs._chain_keys(key, opts.num_chains, 0)
    ks = prng.split(k_master, 2)
    bulk = max(plan, key=lambda kc: sum(len(ch) for ch in plan[kc].chunks))
    lines, setups = [], []
    for key_cls in sorted(plan):
        pc = plan[key_cls]
        sb = stack_buckets([engine._bucket_cached(
            None, pc.chunks[0], (pc.c_pad, pc.k, pc.h, pc.v), samples,
            ploidy, ucounts, opts.random_seed, dev)])
        su = gibbs._noise_setup(ks[:, 0], ks[:, 1], sb, sb.cluster_valid,
                                tables, gibbs.make_outcome_space(pc.h),
                                pc.cfg)
        lines.append(check_joint_class(book, pc, su, sb.cluster_valid.sum(),
                                       opts.burn_in, key_cls == bulk))
        su.tally = torch.zeros(su.llg.shape, dtype=torch.int32, device=dev)
        setups.append(su)
    lines.append(replay_rates(book, setups, opts,
                              engine._prior_rates(opts, len(samples), dev),
                              dev))
    book.check(book.josel[0] >= OSEL_AGREE_MIN * book.josel[1],
               f"joint_step drawn outcomes agree on "
               f"{book.josel[0]}/{book.josel[1]}")
    del setups
    torch.cuda.empty_cache()
    return lines


def check_rate_launches(launches, iters, label):
    """noise_rates runs once per iteration of every chain group, its draws
    once per group."""
    n = launches["noise_rates"]
    if n == 0 or n % iters:
        raise RuntimeError(f"{label}: {n} noise_rates launches for "
                           f"{iters}-iteration chain groups")
    if launches["noise_rates_draws"] != n // iters:
        raise RuntimeError(f"{label}: {launches['noise_rates_draws']} "
                           f"noise_rates_draws launches for {n // iters} "
                           f"chain groups")
    return n // iters


def joint_run(unit, samples, genome, ploidy, opts, out_path, name, smi,
              t_cluster, variants, truth, label, subsets=(("all", None),)):
    """genotype_unit_joint on the card with launches counted from zero and
    the plain rate update refused; bars over each subset of variants.
    Returns the run's launch counts."""
    from bayestyper_tpu_torch import engine, kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with no_plain_rate_update():
        summary = engine.genotype_unit_joint(
            unit, samples, genome, ploidy, out_path,
            dataclasses.replace(opts, noise_genotyping=True), device="cuda")
        torch.cuda.synchronize()
    t_genotype = time.perf_counter() - t0
    log_vcf(label, out_path)
    launches = dict(kernels.LAUNCHES)
    need = [nm for nm in JOINT_KERNELS if nm != "unpack_bucket"]
    missing = [nm for nm in need if launches[nm] == 0]
    if missing:
        raise RuntimeError(f"{label}: the joint path launched no {missing}")
    groups = check_rate_launches(launches, opts.burn_in + opts.num_samples,
                                 label)
    if summary["num_variants"] != len(variants):
        raise RuntimeError(f"{label}: wrote {summary['num_variants']} of "
                           f"{len(variants)} variants")
    if not np.isfinite(summary["noise_traces"]).all():
        raise RuntimeError(f"{label}: noise traces not finite")
    tm = summary["timings"]
    log(f"{label}: genotype_unit_joint on {name}: counts "
        f"{tm['counts_s']:.1f} s, joint {tm['joint_s']:.1f} s, stats "
        f"{tm['stats_s']:.1f} s, coupled {tm['coupled_s']:.1f} s, write "
        f"{tm['write_s']:.1f} s; cluster {t_cluster:.1f} s; "
        f"{len(variants) / (t_cluster + t_genotype):.1f} variants/s "
        f"(cluster + genotype, {smi}); {groups} chain group(s); mean noise "
        f"rates {', '.join(f'{r:.4g}' for r in summary['noise_rates'])}")
    log(f"{label}: launches {launches}")
    for sub, subset in subsets:
        call_rate, conc, n = concordance(out_path, variants, truth, subset)
        log(f"{label}: {sub} variants: call rate {call_rate:.4f}, "
            f"concordance {conc:.4f} over {n} genotypes")
        if not (conc > 0.95 and call_rate > 0.7):
            raise RuntimeError(f"{label}, {sub} variants: concordance "
                               f"{conc:.4f} / call rate {call_rate:.4f} "
                               f"below 0.95 / 0.7")
    return launches


# the keys kmer_cap sorts in shared memory beside its other arrays at
# K32768 on a card of 227 KB opt-in shared memory (a power of two): a pair
# with more kept k-mers sorts in device memory
CAP_SHARED_KEYS = 16384


def cap_cost(bucket, w0, cap):
    """(bytes, float32 operations, integer operations, counts) of one
    kmer_cap call, for this call's data: the masks in and out (every slot:
    the function reads its input and writes its output whole), the member
    words of the k-mers some chain keeps once; on the real clusters, per
    (cluster, chain) with m kept k-mers their member words' popcounts, and
    where some column holds more than cap of them (the cap binds) m keyed
    slot uniforms, an m log2 m comparison sort and the per-column ranks of
    the m k-mers. counts: pairs, binding pairs, the most k-mers a binding
    pair keeps, and the binding pairs past CAP_SHARED_KEYS."""
    from bayestyper_tpu_torch.model.buckets import unpack_member_bits

    real = bucket.cluster_valid
    ch = w0.shape[1]
    v, words = bucket.member.shape[2:]
    h = bucket.num_haplotypes
    w_r = w0[real].to(torch.float32)                            # [C_r, ch, K]
    mem = unpack_member_bits(bucket.member[real], h).reshape(
        w_r.shape[0], w_r.shape[2], v * h).to(torch.float32)
    bind = (torch.bmm(w_r, mem) > cap).any(dim=2)              # [C_r, ch]
    m = w_r.sum(dim=2).double()
    held = float(w0[real].any(dim=1).sum())
    nbytes = 2 * w0.numel() + held * v * words * 4 + ch * 12 \
        + int(real.sum()) * 8
    ranked = m * (THREEFRY_OPS + torch.log2(m.clamp_min(1)) + v * h)
    int_ops = float(torch.where(bind, ranked, m * v * words).sum())
    m_bind = m[bind]
    counts = {"pairs": int(m.numel()), "binding": int(bind.sum()),
              "max_m": int(m_bind.max()) if m_bind.numel() else 0,
              "device_sorted": int((m_bind > CAP_SHARED_KEYS).sum())}
    return nbytes, 0, int_ops, counts


def valid_shared_rows(setup):
    """Per level, each row's count of valid shared k-mers (a list)."""
    return [[0] * lv.ll.shape[0] if lv.sh is None
            else lv.sh["valid"].sum(1).tolist() for lv in setup.levels]


def nested_member_ops(lv, q, s):
    """(float32 ops, integer ops) of one coupled-scan step for one chain of
    a row of level lv with q valid shared k-mers: the Gibbs step
    (step_ops), the shared k-mer terms (four operations per valid (k-mer,
    sample, outcome) and eight per valid (k-mer, sample)) and the MAC
    fold."""
    o = lv.ll.shape[3]
    flt, ints = step_ops(1, s, o, lv.hap_valid.shape[1])
    if lv.sh is not None:
        flt += q * (4 * s * o + 8 * s)
        if lv.mac is not None:
            v, a = lv.mac["acc"].shape[3:]
            flt += s * v * (4 * q + 10 + 4 * a)
    return flt, ints


def nested_cost(setup, iters):
    """(bytes, float32 ops, integer ops) of a nested_sweep launch of
    `iters` iterations over the clusters its groups list (padded rows are
    not sampled): each level's tables of those rows read once and their
    carried state read and written once; per (cluster, chain, iteration)
    nested_member_ops."""
    s = setup.pool.shape[2]
    nbytes = setup.pool.numel() * 8
    ops = i_ops = 0
    members = setup.groups[1].to(torch.int64)
    qv = valid_shared_rows(setup)
    for l, lv in enumerate(setup.levels):
        rows = members[members[:, 0] == l, 1]
        c, ch, _, o = lv.ll.shape
        tensors = [lv.ll, lv.freqs, lv.ocur, lv.tally, lv.retain, lv.ploidy]
        if lv.sh is not None:
            tensors += [lv.sh[f] for f in ("slot", "valid", "counts", "inter",
                                           "dip", "w", "tcut")]
            if lv.mac is not None:
                tensors += [lv.mac[f] for f in ("mem", "n_hv", "ha", "acc")]
        nbytes += (sum(t.numel() * t.element_size() for t in tensors)
                   * rows.numel() / c)
        for r in rows.tolist():
            f, i = nested_member_ops(lv, qv[l][r], s)
            ops += ch * iters * f
            i_ops += ch * iters * i
    return nbytes, ops, i_ops


def nested_bound(setup, iters):
    """(bound_ms, bound_by, chain_ms) of a nested_sweep launch of `iters`
    iterations: the larger of the launch's roofline (nested_cost over the
    whole card) and its deepest serial chain, one (group, chain)'s member
    steps in order, whose operations run at one SM's share of the float32
    and INT32 peaks (each member step depends on the one before it)."""
    s = setup.pool.shape[2]
    offsets, members = setup.groups
    qv = valid_shared_rows(setup)
    chain_ms = 0.0
    for g in range(offsets.numel() - 1):
        flt = ints = 0
        for l, r in members[int(offsets[g]):int(offsets[g + 1])].tolist():
            f, i = nested_member_ops(setup.levels[l], qv[l][r], s)
            flt += f
            ints += i
        chain_ms = max(chain_ms, iters * max(flt / (PEAK_OPS_S / SMS),
                                             ints / (PEAK_INT_OPS_S / SMS))
                       * 1e3)
    bms, by = bound(*nested_cost(setup, iters))
    return max(bms, chain_ms), by if bms >= chain_ms else "operations", \
        chain_ms


def check_nested(book, setup, ch):
    """nested_sweep against its plain version over two windows of
    NESTED_WINDOW iterations: the first iterations from the setup, and
    iterations across the path's burn-in from the kernel's own state;
    CUDA-event times of the first window, of all iterations and of the
    deepest group alone. Returns the phase's lines."""
    from bayestyper_tpu_torch import kernels

    lines = []
    t_mid = setup.burn_in - NESTED_WINDOW // 2
    mid = setup.clone()
    kernels.nested_sweep(mid.levels, mid.pool, mid.groups, 0, t_mid,
                         setup.burn_in)
    windows = ((setup, (0, NESTED_WINDOW, NESTED_WINDOW_BURN)),
               (mid, (t_mid, t_mid + NESTED_WINDOW, setup.burn_in)))

    def window(fn, start, win):
        st = start.clone()
        fn(st.levels, st.pool, st.groups, *win)
        return st

    pairs = agree = 0
    mac_err = 0.0
    for start, win in windows:
        kern = window(kernels.nested_sweep, start, win)
        plain = window(kernels.PLAIN["nested_sweep"], start, win)
        torch.cuda.synchronize()
        for lk, lp in zip(kern.levels, plain.levels):
            same = (lk.tally == lp.tally).all(dim=-1).all(dim=-1)  # [C, ch]
            pairs += same.numel()
            agree += int(same.sum())
            if lk.mac is not None:
                ok = same.all(dim=1)
                gm = lk.mac["acc"].sum(dim=1)[ok]
                pm = lp.mac["acc"].sum(dim=1)[ok]
                if gm.numel():
                    d = (gm - pm).abs()
                    mac_err = max(mac_err, float(d.max()))
                    book.check(bool((d <= MAC_RTOL * pm.abs() + 1e-4).all()),
                               f"nested_sweep {win}: MAC corrections differ "
                               f"by {float(d.max())}")
    book.check(agree >= PAIRS_AGREE_MIN * pairs,
               f"nested_sweep: tallies agree on {agree}/{pairs} pairs")
    book.err("nested_sweep", mac_err)
    win0 = windows[0][1]
    ms = cuda_ms(lambda: window(kernels.nested_sweep, setup, win0), 3)
    pms = event_ms(lambda: window(kernels.PLAIN["nested_sweep"], setup, win0))
    full_ms = cuda_ms(lambda: setup.clone().run(), 2)
    bms, by, chain_ms = nested_bound(setup, NESTED_WINDOW)
    full_bms, _, full_chain_ms = nested_bound(setup, setup.num_iters)
    # the deepest group alone: the serial chain of steps that bounds the scan
    offsets, members = setup.groups
    sizes = offsets[1:] - offsets[:-1]
    g = int(torch.argmax(sizes))
    deep = (torch.tensor([0, int(sizes[g])], dtype=torch.int32),
            members[int(offsets[g]):int(offsets[g + 1])])
    deep_ms = cuda_ms(lambda: window(
        kernels.nested_sweep, dataclasses.replace(setup, groups=deep),
        (0, setup.num_iters, setup.burn_in)), 2)
    n_groups = offsets.numel() - 1
    us_step = 1e3 * deep_ms / (int(sizes[g]) * setup.num_iters)
    book.timing("nested_sweep", True, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=None,
                shape=f"{len(setup.levels)} levels, {n_groups} groups "
                      f"x{NESTED_WINDOW}")
    lines.append(f"nested_sweep ({len(setup.levels)} levels, {n_groups} "
                 f"groups of {members.shape[0]} clusters x {ch} chains), "
                 f"iterations {[w for _, w in windows]} (t0, t1, burn-in): "
                 f"tallies agree on {agree}/{pairs} (cluster, chain) pairs, "
                 f"MAC within {mac_err:.3g}; first window {ms:.3f} ms, plain "
                 f"{pms:.3f} ms, bound {bms:.4f} ms ({by}; the deepest "
                 f"chain's {chain_ms:.4f} ms); all {setup.num_iters} "
                 f"iterations {full_ms:.3f} ms, bound {full_bms:.4f} ms "
                 f"(chain {full_chain_ms:.4f} ms); the deepest group "
                 f"({int(sizes[g])} levels) alone {deep_ms:.3f} ms, "
                 f"{us_step:.3f} us per chain step")
    return lines


def coupled_phase(unit, samples, ploidy, opts, dev, book):
    """Lay the unit's coupled clusters out in rank levels as genotype_unit
    does, and hold kmer_cap, nested_sweep and bucket_stats against their
    plain versions on them."""
    from bayestyper_tpu_torch import engine, kernels
    from bayestyper_tpu_torch.model import gibbs
    from bayestyper_tpu_torch.model.count_model import fit_genomic_nb
    from bayestyper_tpu_torch.model.stats import FilterConfig
    from bayestyper_tpu_torch.ops import prng
    from bayestyper_tpu_torch.ops.distributions import (
        np_build_count_log_prob_tables, tables_from_numpy)

    table, counts = engine.gather_sample_counts(unit, samples,
                                                opts.num_host_threads)
    nb = fit_genomic_nb(engine.parameter_kmer_stats(unit, samples, table,
                                                    counts))
    ucounts = engine._UnitCounts(unit, table, counts)
    tables = tables_from_numpy(np_build_count_log_prob_tables(
        nb.p, nb.size, np.full(len(samples), 1e-3), 255), dev)
    filters = FilterConfig.from_model(nb.mean, opts.min_genotype_posterior,
                                      opts.min_number_of_kmers)
    nested = [fc for fc in unit.compiled if engine._is_coupled(fc)]
    ni = engine._nested_inputs(nested, samples, ploidy, ucounts, opts, dev)
    capped = [l for l, cfg in enumerate(ni.cfgs) if cfg.apply_cap]
    shared = [l for l, sh in enumerate(ni.shared_infos) if sh is not None]
    lines = [f"{len(nested)} coupled clusters in {len(ni.levels)} rank levels "
             f"(clusters per level {[len(f) for f in ni.levels][:8]}...); "
             f"{len(capped)} levels take the k-mer cap; {len(shared)} levels "
             f"hold shared k-mers, a pool of {ni.num_pool}"]
    book.check(len(capped) >= 1, "no coupled level takes the k-mer cap")
    book.check(ni.num_pool > 0, "the coupled unit's shared pool is empty")
    key = prng.prng_key(opts.random_seed)
    args, kwargs = ni.genotype_args(key, tables)
    setup = gibbs.nested_setup(*args, **kwargs)
    ch = opts.num_chains

    # -- kmer_cap on the capped level with the most k-mer slots --
    l = max(capped, key=lambda i: ni.buckets[i].mult.shape[:2].numel())
    bucket, cfg = ni.buckets[l], ni.cfgs[l]
    sub_key = prng.split(prng.fold_in(key, l), 2)[0]
    base, fold = gibbs._chain_base(sub_key, ch)
    kk = prng.split(base, 2)
    w0 = kernels.subsample_masks(kk[:, 0], fold, bucket.cluster_id,
                                 bucket.kmer_valid, cfg.kmer_subsampling_rate,
                                 gibbs._SUBSAMPLE_SALT)
    cap_args = (kk[:, 1], fold, bucket.cluster_id, w0, bucket.member,
                bucket.num_haplotypes, cfg.max_haplotype_variant_kmers,
                gibbs._CAP_SALT)
    w_k = kernels.kmer_cap(*cap_args)
    w_p = kernels.PLAIN["kmer_cap"](*cap_args)
    torch.cuda.synchronize()
    bad = int((w_k != w_p).sum())
    tag = (f"level {l} H{bucket.num_haplotypes}/K{bucket.num_kmers}/"
           f"C{bucket.num_clusters}")
    book.check(bad == 0, f"kmer_cap {tag}: {bad} entries differ")
    book.check(torch.equal(w_k, setup.ws[l]),
               f"kmer_cap {tag}: differs from the scan's masks")
    book.err("kmer_cap", min(bad, 1))
    ms = cuda_ms(lambda: kernels.kmer_cap(*cap_args), 5)
    dms = device_ms(lambda: kernels.kmer_cap(*cap_args), "bt_kmer_cap_kernel")
    pms = event_ms(lambda: kernels.PLAIN["kmer_cap"](*cap_args))
    *cost, counts = cap_cost(bucket, w0, cfg.max_haplotype_variant_kmers)
    bms, by = bound(*cost)
    book.timing("kmer_cap", True, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=None, shape=tag, device_ms=dms)
    lines.append(f"kmer_cap {tag}, cap {cfg.max_haplotype_variant_kmers}: "
                 f"{bad} of {w_k.numel()} differ; keeps {int(w_k.sum())} of "
                 f"{int(w0.sum())}; binds on {counts['binding']} of "
                 f"{counts['pairs']} pairs; {ms:.3f} ms (device "
                 f"{fmt_ms(dms)}), plain {pms:.3f} ms, bound {bms:.4f} ms "
                 f"({by})")

    # -- nested_sweep against its plain version --
    lines += check_nested(book, setup, ch)
    kern = setup.clone()
    kern.run()

    # -- bucket_stats, unpacked, on the scan's tallies: the largest shared
    # level with its MAC correction, the largest level of nested children
    # with handed-down `*` stats --
    mac_extras = [lv.mac["acc"].sum(dim=1) if lv.mac is not None else None
                  for lv in kern.levels]
    size = lambda i: ni.buckets[i].num_clusters                  # noqa: E731
    children = [i for i, lv in enumerate(ni.parent_levels) if (lv >= 0).any()]
    gen = torch.Generator(device=dev).manual_seed(opts.random_seed)
    for l, kind in ((max(shared, key=size), "shared"),
                    (max(children, key=size), "nested")):
        b = ni.buckets[l]
        osp = gibbs.outcome_tensors(b.num_haplotypes, dev)
        o = osp.oa.shape[0]
        t_top = o if kind == "shared" else engine._mac_top_t(
            ni.outcomes_list[l])
        st_args = (b.mult, b.inter_mult, b.counts, b.member, b.hap_allele,
                   b.num_alleles, b.ploidy, kern.levels[l].tally, setup.ws[l],
                   osp.oa32, osp.ob32, ni.caps_a[l], t_top,
                   filters.min_genotype_posterior, filters.min_number_of_kmers,
                   torch.tensor(filters.min_fraction_observed_kmers), False)
        missing = None
        if kind == "nested":
            missing = tuple(torch.rand(b.ploidy.shape, generator=gen,
                                       device=dev) * 20 for _ in range(3))
        lines.append(check_stats(
            book, f"{kind} level {l} H{b.num_haplotypes}/K{b.num_kmers}/"
                  f"C{b.num_clusters}", b, st_args, bulk=kind == "shared",
            missing=missing,
            mac_extra=mac_extras[l] if kind == "shared" else None))
    return lines


def coupled_run(tmp, args, opts, ploidy, book, dev, name, smi):
    """Phase 7: the coupled unit through the cluster phase, the coupled
    kernel checks, genotype_unit and genotype_unit_joint. Returns the two
    runs' launch counts."""
    from bayestyper_tpu_torch import engine, kernels

    ctmp = os.path.join(tmp, "coupled")
    os.makedirs(ctmp)
    t0 = time.perf_counter()
    genome, vcf_path, variants, truth, samples, families = simulate_coupled(
        ctmp, args.seed, args.scale)
    coupled_vi = {vi for _, d, kids in families for vi in [d] + kids}
    log(f"coupled data: {len(variants)} variants ({len(coupled_vi)} in "
        f"{len(families)} families), genome {len(genome['chr1'])} bp "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    unit = engine.run_cluster_phase(
        genome, samples, vcf_path, ploidy, kmer_size=K,
        max_parameter_kmers=1_000_000, num_threads=os.cpu_count() or 1)
    t_cluster = time.perf_counter() - t0
    n_coupled = sum(engine._is_coupled(fc) for fc in unit.compiled)
    log(f"coupled cluster: {len(unit.compiled)} clusters, {n_coupled} "
        f"coupled ({t_cluster:.1f} s)")
    t0 = time.perf_counter()
    for line in coupled_phase(unit, samples, ploidy, opts, dev, book):
        log("  " + line)
    log(f"coupled kernels: {time.perf_counter() - t0:.1f} s")
    if book.failures:
        raise RuntimeError("kernels disagree with their plain versions:\n"
                           + "\n".join(book.failures))

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out_path = os.path.join(ctmp, "genotypes.vcf")
    t0 = time.perf_counter()
    with no_plain_rate_update():
        summary = engine.genotype_unit(unit, samples, genome, ploidy,
                                       out_path, opts, device="cuda")
        torch.cuda.synchronize()
    t_genotype = time.perf_counter() - t0
    log_vcf("coupled", out_path)
    launches = dict(kernels.LAUNCHES)
    missing = [nm for nm in COUPLED_KERNELS if launches[nm] == 0]
    if missing:
        raise RuntimeError(f"coupled path launched no {missing}")
    check_rate_launches(launches, opts.burn_in + opts.num_samples, "coupled")
    if summary["num_variants"] != len(variants):
        raise RuntimeError(f"wrote {summary['num_variants']} of "
                           f"{len(variants)} coupled-unit variants")
    tm = summary["timings"]
    log(f"coupled: genotype_unit on {name}: counts {tm['counts_s']:.1f} s, "
        f"noise {tm['noise_s']:.1f} s, waves+stats {tm['waves_s']:.1f} s, "
        f"coupled {tm['coupled_s']:.1f} s, write {tm['write_s']:.1f} s; "
        f"cluster {t_cluster:.1f} s; "
        f"{len(variants) / (t_cluster + t_genotype):.1f} variants/s "
        f"(cluster + genotype, {smi})")
    log(f"coupled: launches {launches}")
    for label, subset in (("all", None), ("coupled", coupled_vi)):
        call_rate, conc, n = concordance(out_path, variants, truth, subset)
        log(f"coupled: {label} variants: call rate {call_rate:.4f}, "
            f"concordance {conc:.4f} over {n} genotypes")
        if not (conc > 0.95 and call_rate > 0.7):
            raise RuntimeError(f"{label} variants of the coupled unit: "
                               f"concordance {conc:.4f} / call rate "
                               f"{call_rate:.4f} below 0.95 / 0.7")
    launches_j = joint_run(
        unit, samples, genome, ploidy, opts,
        os.path.join(ctmp, "genotypes_joint.vcf"), name, smi, t_cluster,
        variants, truth, "coupled joint",
        (("all", None), ("coupled", coupled_vi)))
    missing = [nm for nm in COUPLED_KERNELS if launches_j[nm] == 0]
    if missing:
        raise RuntimeError(f"coupled joint path launched no {missing}")
    return launches, launches_j


# ---------------------------------------------------------------------------
# the device k-mer lookup path (BT_DEVICE_LOOKUP=1) and the device bloom
# ---------------------------------------------------------------------------

def event_ms(fn):
    """CUDA-event time of one call of fn() in ms (no warm-up: fn is a whole
    stream of launches)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1)


@contextlib.contextmanager
def device_lookup_env():
    """BT_DEVICE_LOOKUP=1 for the duration."""
    old = os.environ.get("BT_DEVICE_LOOKUP")
    os.environ["BT_DEVICE_LOOKUP"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["BT_DEVICE_LOOKUP"]
        else:
            os.environ["BT_DEVICE_LOOKUP"] = old


def lane_cost(n, m, p):
    """(bytes, operations) of lane_lookup on n queries over m rows with a
    p-byte payload: each query and one 16 B key row read, its payload row
    written; ceil(log2 m) compares per query."""
    return n * (16 + 16 + p), n * max((max(m, 2) - 1).bit_length(), 1)


def bloom_cost(n, h, bits_bytes):
    """(bytes, operations) of bloom_query on n queries of h hashes: per
    (hash, query) 8 B of index and offset, 1 B of output per query, and
    the gathers — a 32 B sector each, but never more than the bit array
    read once (all of it when it fits the L2 cache or when the gathers
    touch every sector); a shift, a mask and an AND per (hash, query)."""
    return n * h * 8 + min(n * h * 32, bits_bytes) + n, 3 * n * h


def stream_batches(samples):
    """The number of KMC batches in the samples' tables (gather_sample_counts
    reads each table in batches of LOOKUP_BATCH records)."""
    from bayestyper_tpu_torch.io.kmc import KmcReader

    n = 0
    for s in samples:
        reader = KmcReader(s.kmc_prefix)
        n += -(-reader.info.total_kmers // LOOKUP_BATCH)
        reader.close()
    return n


def gather_spans(unit, sample):
    """Host seconds in each of engine.gather_sample_counts' profiler spans
    under BT_DEVICE_LOOKUP=1, over one sample's KMC stream on one thread
    (bt.lane_lookup times the launches; bt.lookup_download waits for the
    kernel)."""
    from bayestyper_tpu_torch import engine

    with device_lookup_env(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        engine.gather_sample_counts(unit, [sample], 1, device="cuda")
    spans = {e.key: e.cpu_time_total / 1e6 for e in prof.key_averages()}
    missing = [s for s in GATHER_SPANS if s not in spans]
    if missing:
        raise RuntimeError(f"the device count gathering recorded no {missing}")
    return {s: spans[s] for s in GATHER_SPANS}


def check_lane_unit(book, table, sample, dev):
    """(a) lane_lookup on the main unit's lane table (the engine's layout:
    one shard, row-index payloads), queried with one sample's whole KMC
    stream in its batches: byte-equal to its plain version and to the host
    lookup."""
    from bayestyper_tpu_torch import kernels
    from bayestyper_tpu_torch.io.kmc import KmcReader
    from bayestyper_tpu_torch.parallel.sharded_table import (ShardedLaneTable,
                                                             row_payload)

    rows = row_payload(len(table))
    tab = ShardedLaneTable.build([dev], table.hi, table.lo, rows)
    keys, pay, valid = tab.keys[0], tab.payload[0], tab.valid[0]
    reader = KmcReader(sample.kmc_prefix)
    bad = n_q = hits = 0
    q_first = None
    for hi, lo, _ in reader.batches(LOOKUP_BATCH):
        q = torch.from_numpy(np.stack([hi, lo], 1).view(np.int64)).to(dev)
        got = kernels.lane_lookup(keys, pay, valid, q)
        want = kernels.PLAIN["lane_lookup"](keys, pay, valid, q)
        idx = table.lookup(hi, lo)
        host = np.where(idx[:, None] >= 0, rows[np.maximum(idx, 0)],
                        0).astype(np.uint8)
        torch.cuda.synchronize()
        bad += int((got != want).sum()) + int((got.cpu().numpy() != host)
                                              .sum())
        n_q += len(hi)
        hits += int((idx >= 0).sum())
        if q_first is None:
            q_first = q
    reader.close()
    book.check(bad == 0, f"lane_lookup (unit): {bad} payload bytes differ")
    book.err("lane_lookup", min(bad, 1))
    args = (keys, pay, valid, q_first)
    ms = cuda_ms(lambda: kernels.lane_lookup(*args), 10)
    pms = cuda_ms(lambda: kernels.PLAIN["lane_lookup"](*args), 3)
    m = keys.shape[0]
    bms, by = bound(*lane_cost(q_first.shape[0], m, 4))
    nb = q_first.shape[0]
    book.timing("lane_lookup", True, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=None, shape=f"{m} rows x {nb} queries")
    return (f"lane_lookup (a), the unit's table of {m} lanes, one sample's "
            f"stream of {n_q} k-mers ({hits} hits): {bad} bytes differ from "
            f"the plain version and the host lookup; per batch of {nb}: "
            f"{ms:.4f} ms ({nb / ms / 1e3:.1f} Mq/s), plain {pms:.3f} ms, "
            f"bound {bms:.4f} ms ({by})")


def chr20_lane_table(dev, n, seed):
    """A sorted table of n lanes generated on the card (cumulative random
    gaps: no host sort) with row-index payloads. Key v (below 2**61 + n)
    maps to hi = v >> 8 and lo = (v & 0xFF) << 48 | an even 48-bit draw,
    so (hi, lo) order is v order and an odd lo is never a key."""
    g = torch.Generator(device=dev).manual_seed(seed)
    v = torch.cumsum(torch.randint(1, (1 << 62) // n, (n,), device=dev,
                                   generator=g), 0)
    keys = torch.empty((n, 2), dtype=torch.int64, device=dev)
    keys[:, 0] = v >> 8
    keys[:, 1] = ((v & 0xFF) << 48) | (torch.randint(
        0, 1 << 47, (n,), device=dev, generator=g) * 2)
    del v
    payload = torch.arange(n, dtype=torch.int32, device=dev).view(
        torch.uint8).reshape(n, 4)
    return keys, payload, torch.ones(n, dtype=torch.bool, device=dev), g


def check_lane_chr20(book, dev, seed):
    """(b) lane_lookup at chr20 scale: CHR20_LANES lanes, CHR20_QUERIES
    ascending queries (half of them hits: a miss is a sampled key with lo
    + 1) in batches of 1 << 20; every payload against the expected row,
    the plain version on three batches; Mq/s of the kernel beside the
    host's native merge and LaneTable.lookup on the same queries."""
    from bayestyper_tpu_torch import kernels, native
    from bayestyper_tpu_torch.engine import LaneTable

    n, nq = CHR20_LANES, CHR20_QUERIES
    t0 = time.perf_counter()
    keys, pay, valid, g = chr20_lane_table(dev, n, seed)
    sel = torch.nonzero(torch.rand(n, device=dev, generator=g)
                        < 1.01 * nq / n)[:nq, 0]
    nq = sel.numel()
    miss = torch.randint(0, 2, (nq,), device=dev, generator=g)
    q = keys[sel]
    q[:, 1] += miss
    want_idx = torch.where(miss.bool(), -1, sel)
    del miss
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    batches = [(a, min(a + LOOKUP_BATCH, nq))
               for a in range(0, nq, LOOKUP_BATCH)]
    outs = []
    k_ms = event_ms(lambda: outs.extend(
        kernels.lane_lookup(keys, pay, valid, q[a:b]) for a, b in batches))
    got = torch.cat(outs).view(torch.int32).reshape(nq).to(torch.int64)
    bad = int((torch.where(got == 0, -1, got) != torch.where(
        want_idx == 0, -1, want_idx)).sum())
    del outs, got
    for a, b in (batches[0], batches[len(batches) // 2], batches[-1]):
        bad += int((kernels.lane_lookup(keys, pay, valid, q[a:b])
                    != kernels.PLAIN["lane_lookup"](keys, pay, valid,
                                                    q[a:b])).sum())
    # the engine's per-batch round trip: the batch up, payloads back
    q_host = q.cpu().numpy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a, b in batches:
        kernels.lane_lookup(keys, pay, valid,
                            torch.from_numpy(q_host[a:b]).to(dev)).cpu()
    t_trip = time.perf_counter() - t0
    a0, b0 = batches[0]
    ms = cuda_ms(lambda: kernels.lane_lookup(keys, pay, valid, q[a0:b0]), 5)
    pms = cuda_ms(lambda: kernels.PLAIN["lane_lookup"](keys, pay, valid,
                                                       q[a0:b0]), 2)
    bms_all, by = bound(*lane_cost(nq, n, 4))
    bms, _ = bound(*lane_cost(b0 - a0, n, 4))
    book.timing("lane_lookup", False, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=None,
                shape=f"{n} rows x {b0 - a0} queries (chr20 scale)")

    t_hi = keys[:, 0].contiguous().cpu().numpy().view(np.uint64)
    t_lo = keys[:, 1].contiguous().cpu().numpy().view(np.uint64)
    want_host = want_idx.cpu().numpy()
    del keys, pay, valid, q, sel, want_idx
    torch.cuda.empty_cache()
    qh = np.ascontiguousarray(q_host[:, 0]).view(np.uint64)
    ql = np.ascontiguousarray(q_host[:, 1]).view(np.uint64)
    del q_host
    t0 = time.perf_counter()
    cursor = 0
    merged = []
    for a, b in batches:
        idx, cursor = native.lane_merge_lookup(t_hi, t_lo, qh[a:b], ql[a:b],
                                               cursor)
        merged.append(idx)
    t_merge = time.perf_counter() - t0
    bad += int((np.concatenate(merged) != want_host).sum())
    del merged
    host = LaneTable.__new__(LaneTable)
    host.hi, host.lo = t_hi, t_lo
    t0 = time.perf_counter()
    host.lookup(qh[:1], ql[:1])                      # builds its root index
    t_roots = time.perf_counter() - t0
    t0 = time.perf_counter()
    rooted = [host.lookup(qh[a:b], ql[a:b]) for a, b in batches]
    t_rooted = time.perf_counter() - t0
    bad += int((np.concatenate(rooted) != want_host).sum())
    book.check(bad == 0, f"lane_lookup (chr20 scale): {bad} entries differ")
    book.err("lane_lookup", min(bad, 1))
    mq = lambda s: nq / s / 1e6                                  # noqa: E731
    return (f"lane_lookup (b), chr20 scale: {n} lanes generated sorted on "
            f"the card, {nq} ascending queries ({len(batches)} batches, half "
            f"hits; {t_gen:.1f} s to generate): {bad} entries differ from "
            f"the expected rows, the plain version (3 batches), the native "
            f"merge and LaneTable.lookup. Mq/s over all queries: kernel "
            f"{mq(k_ms / 1e3):.1f} ({k_ms:.1f} ms, bound {bms_all:.3f} ms, "
            f"{by}); kernel with each batch's upload and download "
            f"{mq(t_trip):.1f}; host native.lane_merge_lookup "
            f"{mq(t_merge):.1f}; host LaneTable.lookup {mq(t_rooted):.1f} "
            f"(+{t_roots:.2f} s root index). One batch of {b0 - a0}: "
            f"{ms:.4f} ms, plain {pms:.3f} ms, bound {bms:.4f} ms")


def check_bloom(book, bloom, hi, lo, dev, label, bulk, workers=1):
    """(c) bloom_query against its plain version and the host contains on
    the lanes (hi, lo), bit-equal; the host prepare and contains run in
    chunks over `workers` threads."""
    from concurrent.futures import ThreadPoolExecutor

    from bayestyper_tpu_torch import kernels
    from bayestyper_tpu_torch.ops.bloom import device_bloom_prepare

    n, h = len(hi), bloom.num_hashes
    word = torch.empty((h, n), dtype=torch.int32, device=dev)
    shift = torch.empty((h, n), dtype=torch.int32, device=dev)
    host = np.empty(n, bool)
    chunk = -(-n // (4 * workers))

    def part(a):
        b = min(a + chunk, n)
        w, s = device_bloom_prepare(bloom, hi[a:b], lo[a:b])
        host[a:b] = bloom.contains(hi[a:b], lo[a:b])
        return a, b, w, s

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for a, b, w, s in pool.map(part, range(0, n, chunk)):
            word[:, a:b] = torch.from_numpy(w).to(dev)
            shift[:, a:b] = torch.from_numpy(s.view(np.int32)).to(dev)
    t_host = time.perf_counter() - t0
    bits = torch.from_numpy(bloom.bits.view(np.int32)).to(dev)
    got = kernels.bloom_query(bits, word, shift)
    want = kernels.PLAIN["bloom_query"](bits, word, shift)
    torch.cuda.synchronize()
    bad = int((got != want).sum()) + int((got.cpu().numpy() != host).sum())
    present = int(host.sum())
    del want
    book.check(bad == 0, f"bloom_query ({label}): {bad} entries differ")
    book.err("bloom_query", min(bad, 1))
    ms = cuda_ms(lambda: kernels.bloom_query(bits, word, shift), 5)
    pms = cuda_ms(lambda: kernels.PLAIN["bloom_query"](bits, word, shift), 2)
    bms, by = bound(*bloom_cost(n, h, bloom.bits.nbytes))
    book.timing("bloom_query", bulk, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=None,
                shape=f"{bloom.num_bits} bits x {h} hashes x {n} queries")
    return (f"bloom_query (c), {label}: {bloom.num_bits} bits "
            f"({bloom.bits.nbytes / 1e6:.1f} MB), {h} hashes, {n} queries "
            f"({present} present): {bad} differ from the plain version and "
            f"the host contains; {ms:.3f} ms ({n / ms / 1e3:.1f} Mq/s), plain "
            f"{pms:.3f} ms, bound {bms:.4f} ms ({by}); host prepare + "
            f"contains {t_host:.1f} s ({workers} threads)")


def lookup_phase(book, tmp, unit, samples, genome, ploidy, opts, dev,
                 main_vcf, args, name, smi, t_cluster, variants, truth):
    """The lookup phase: (a)-(c) the two kernels against their plain
    versions and the host at the unit's scale and at chr20 scale, then
    (d) the device count gathering and the bloom entry point, and (e)
    genotype_unit under BT_DEVICE_LOOKUP=1, each with launches counted from
    zero. Returns the launches of (d) and (e)."""
    from bayestyper_tpu_torch import engine, kernels
    from bayestyper_tpu_torch.ops.bloom import (KmerBloomFilter,
                                                device_bloom_query)
    from bayestyper_tpu_torch.tools.make_bloom import kmc_to_bloom

    torch.cuda.empty_cache()
    threads = opts.num_host_threads
    t0 = time.perf_counter()
    table, host_counts = engine.gather_sample_counts(unit, samples, threads)
    t_host = time.perf_counter() - t0
    log("  " + check_lane_unit(book, table, samples[0], dev))
    log("  " + check_lane_chr20(book, dev, args.seed))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    bloom, _ = kmc_to_bloom(samples[0].kmc_prefix,
                            os.path.join(tmp, "sample0.bloom.npz"))
    log(f"  make_bloom of {samples[0].name}'s table: "
        f"{time.perf_counter() - t0:.1f} s")
    log("  " + check_bloom(book, bloom, table.hi, table.lo, dev,
                           "the unit's lanes in one sample's bloom", True))
    rng = np.random.default_rng(args.seed)
    big = KmerBloomFilter.with_optimal_parameters(CHR20_BLOOM_KMERS, 0.001)
    big.bits[:] = np.frombuffer(rng.bytes(big.bits.nbytes), np.uint64)
    fill = np.unpackbits(big.bits[:1 << 20].view(np.uint8)).mean()
    q_hi = rng.integers(0, 2**54, CHR20_QUERIES, dtype=np.uint64)
    q_lo = rng.integers(0, 2**56, CHR20_QUERIES, dtype=np.uint64)
    log("  " + check_bloom(book, big, q_hi, q_lo, dev,
                           f"chr20 scale ({CHR20_BLOOM_KMERS} k-mers at fpr "
                           f"0.001, random bits at {fill:.4f} fill)", False,
                           workers=os.cpu_count() or 1))
    del big, q_hi, q_lo
    torch.cuda.empty_cache()
    if book.failures:
        raise RuntimeError("lookup kernels disagree:\n"
                           + "\n".join(book.failures))

    # (d) the device count gathering and the bloom entry point
    n_batches = stream_batches(samples)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with device_lookup_env():
        _, dev_counts = engine.gather_sample_counts(unit, samples, threads,
                                                    device="cuda")
    t_dev = time.perf_counter() - t0
    present = device_bloom_query(bloom, table.hi, table.lo, device="cuda")
    launches = dict(kernels.LAUNCHES)
    if not np.array_equal(dev_counts, host_counts):
        raise RuntimeError(f"device lookup counts differ from the host "
                           f"path's in {int((dev_counts != host_counts).sum())}"
                           f" entries")
    if not np.array_equal(present, bloom.contains(table.hi, table.lo)):
        raise RuntimeError("device_bloom_query differs from contains")
    if launches["lane_lookup"] != n_batches or launches["bloom_query"] != 1:
        raise RuntimeError(f"device lookup path: {launches['lane_lookup']} "
                           f"lane_lookup launches for {n_batches} KMC "
                           f"batches, {launches['bloom_query']} bloom_query")
    log(f"  gather_sample_counts (d), {len(samples)} samples, table of "
        f"{len(table)} lanes: counts byte-identical; host path "
        f"{t_host:.2f} s, BT_DEVICE_LOOKUP=1 {t_dev:.2f} s ({threads} "
        f"threads); lane_lookup launches {launches['lane_lookup']} = "
        f"{n_batches} KMC batches; device_bloom_query equals contains")
    t0 = time.perf_counter()
    engine.gather_sample_counts(unit, samples, 1)
    t_host1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    with device_lookup_env():
        engine.gather_sample_counts(unit, samples, 1, device="cuda")
    t_dev1 = time.perf_counter() - t0
    spans = gather_spans(unit, samples[0])
    log(f"  gather_sample_counts (d), one thread: host path {t_host1:.2f} s, "
        f"BT_DEVICE_LOOKUP=1 {t_dev1:.2f} s; its profiler spans over "
        f"{samples[0].name}'s stream, s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in spans.items()))

    # (e) genotype_unit under BT_DEVICE_LOOKUP=1
    out_path = os.path.join(tmp, "genotypes_lookup.vcf")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with device_lookup_env(), no_plain_rate_update():
        summary = engine.genotype_unit(unit, samples, genome, ploidy,
                                       out_path, opts, device="cuda")
        torch.cuda.synchronize()
    t_genotype = time.perf_counter() - t0
    log_vcf("main_device_lookup", out_path)
    launches_e = dict(kernels.LAUNCHES)
    missing = [nm for nm in MAIN_KERNELS + ("lane_lookup",)
               if launches_e[nm] == 0]
    if missing or launches_e["lane_lookup"] != n_batches:
        raise RuntimeError(f"genotype_unit under BT_DEVICE_LOOKUP=1 launched "
                           f"no {missing}, lane_lookup "
                           f"{launches_e['lane_lookup']} times")
    call_rate, conc, n_calls = concordance(out_path, variants, truth)
    if not (conc > 0.95 and call_rate > 0.7):
        raise RuntimeError(f"device lookup: concordance {conc:.4f} / call "
                           f"rate {call_rate:.4f} below 0.95 / 0.7")
    same_gt, n_gt = compare_gt(main_vcf, out_path)
    if same_gt != n_gt:
        raise RuntimeError(f"device lookup: GT calls equal phase 5's on "
                           f"{same_gt}/{n_gt}")
    tm = summary["timings"]
    log(f"  genotype_unit (e) under BT_DEVICE_LOOKUP=1 on {name}: counts "
        f"{tm['counts_s']:.1f} s, noise {tm['noise_s']:.1f} s, waves+stats "
        f"{tm['waves_s']:.1f} s, write {tm['write_s']:.1f} s; "
        f"{len(variants) / (t_cluster + t_genotype):.1f} variants/s "
        f"(cluster + genotype, {smi}); call rate {call_rate:.4f}, "
        f"concordance {conc:.4f} over {n_calls} genotypes; GT calls equal "
        f"phase 5's on {same_gt}/{n_gt}; {first_difference(main_vcf, out_path)}")
    log(f"  launches {launches_e}")
    return launches, launches_e


def compare_gt(path_a, path_b):
    """(equal, compared) GT calls of two VCFs of the same records."""
    from bayestyper_tpu_torch.io.vcf import VcfReader

    a = [[s["GT"] for s in r.samples]
         for r in VcfReader(path_a, parse_samples=True)]
    b = [[s["GT"] for s in r.samples]
         for r in VcfReader(path_b, parse_samples=True)]
    if len(a) != len(b):
        return 0, max(len(a), len(b))
    same = sum(x == y for ra, rb in zip(a, b) for x, y in zip(ra, rb))
    return same, sum(len(r) for r in a)


def first_difference(path_a, path_b):
    """Whether two VCFs are byte-identical, else their first differing
    record."""
    with open(path_a, "rb") as fa, open(path_b, "rb") as fb:
        la, lb = fa.read().split(b"\n"), fb.read().split(b"\n")
    if la == lb:
        return "the VCF is byte-identical to phase 5's"
    i = next((i for i, (x, y) in enumerate(zip(la, lb)) if x != y),
             min(len(la), len(lb)))
    rec = (la + [b""])[i].split(b"\t")[:2]
    return (f"the VCF differs from phase 5's first at line {i + 1} "
            f"({b' '.join(rec).decode()})")


# ---------------------------------------------------------------------------
# the single-bucket forms and the prior gamma draw
# ---------------------------------------------------------------------------

def check_gamma(book, label, keys, alpha, bulk):
    """gamma_draw against its plain version on keys [N, 2], alpha [N, E]:
    finite samples within GAMMA_RTOL (above GAMMA_ATOL) on GAMMA_AGREE_MIN
    of the elements, every flip printed; CUDA-event times of the kernel, the
    plain version and torch._standard_gamma on the same alpha (the same
    distribution from another stream: PyTorch's one gamma sampler)."""
    from bayestyper_tpu_torch import kernels

    keys = kernels.key_words(keys, alpha.device)
    got = kernels.gamma_draw(keys, alpha)
    want = kernels.PLAIN["gamma_draw"](keys, alpha)
    torch.cuda.synchronize()
    n, e = alpha.shape
    close = torch.isclose(got, want, rtol=GAMMA_RTOL, atol=GAMMA_ATOL)
    flips = torch.nonzero(~close).tolist()
    for x, y in flips:
        log(f"  gamma_draw flip ({label}; key, element, alpha, kernel, "
            f"plain): ({x}, {y}, {float(alpha[x, y])!r}, "
            f"{float(got[x, y])!r}, {float(want[x, y])!r})")
    book.check(bool(torch.isfinite(got).all()),
               f"gamma_draw {label}: samples not finite")
    book.check(len(flips) <= (1 - GAMMA_AGREE_MIN) * close.numel(),
               f"gamma_draw {label}: {len(flips)} of {close.numel()} "
               f"samples beyond {GAMMA_RTOL} relative")
    book.err("gamma_draw", float((got - want).abs().max()))
    ms = cuda_ms(lambda: kernels.gamma_draw(keys, alpha), 10)
    pms = cuda_ms(lambda: kernels.PLAIN["gamma_draw"](keys, alpha), 1)
    lms = cuda_ms(lambda: torch._standard_gamma(alpha), 10)
    ops = n * e * GAMMA_OPS + int((alpha < 1).sum()) * GAMMA_POW_OPS
    bms, by = bound(n * e * 8 + n * 8, ops)
    book.timing("gamma_draw", bulk, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=lms, shape=f"[{n}, {e}]")
    return (f"gamma_draw {label} [{n}, {e}]: {close.numel() - len(flips)}/"
            f"{close.numel()} within {GAMMA_RTOL} relative of the plain "
            f"version ({int((got == want).sum())} equal, {len(flips)} flips, "
            f"{int((got == 0).sum())} zero samples); {ms:.4f} ms, plain "
            f"{pms:.3f} ms, torch._standard_gamma (same distribution, a "
            f"different stream) {lms:.4f} ms, bound {bms:.6f} ms ({by})")


def noise_chain_window(book, bucket, tables, init_rates, outcomes, cfg, key,
                       chain_trace, prior):
    """noise_chain's first NOISE_WINDOW iterations (chain 0) recorded
    through the kernels: the recorded trace equals the chain's, each
    iteration's drawn outcomes agree with the plain noise_step's from the
    same state on OSEL_AGREE_MIN of the entries, and each rate update
    replays through noise_rates and its plain version (replay_updates)."""
    from bayestyper_tpu_torch import kernels
    from bayestyper_tpu_torch.model import gibbs
    from bayestyper_tpu_torch.model.buckets import stack_buckets
    from bayestyper_tpu_torch.ops import prng

    dev = bucket.mult.device
    ks = prng.split(prng.fold_in(key, 0), 3)
    su = gibbs._noise_setup(ks[0:1], ks[1:2], stack_buckets([bucket]),
                            bucket.cluster_valid[None], tables, outcomes, cfg)
    k_noise = kernels.key_words(ks[2:3], dev)
    agree = [0, 0]

    def step(su, t, log_r, rates, cs, no):
        f0 = su.freqs.clone()
        su.freqs, o_k = kernels.noise_step(
            su.llg, su.a, su.b, su.cv, log_r, rates, *su.fields,
            su.chain_base, su.fold, su.freqs, t, su.osp, cs, no)
        zero = torch.zeros_like(cs)
        _, o_p = kernels.PLAIN["noise_step"](
            su.llg, su.a, su.b, su.cv, log_r, rates, *su.fields,
            su.chain_base, su.fold, f0, t, su.osp, zero, zero.clone())
        same = o_k == o_p
        agree[0] += int(same.sum())
        agree[1] += same.numel()

    trace, recorded = record_rate_scan(
        [su], step, k_noise, init_rates[None].to(torch.float32),
        NOISE_WINDOW, prior)
    same = torch.equal(trace[0], chain_trace[:NOISE_WINDOW])
    book.check(same, "noise_chain: the recorded window differs from the "
                     "chain's trace")
    book.check(agree[0] >= OSEL_AGREE_MIN * agree[1],
               f"noise_chain: drawn outcomes agree on {agree[0]}/{agree[1]}")
    flips, worst, n_all, _ = replay_updates(book, k_noise, recorded, trace,
                                            prior, "noise_chain")
    return (f"noise_chain window of {NOISE_WINDOW} iterations: the recorded "
            f"trace equals the chain's: {same}; drawn outcomes agree with the "
            f"plain noise_step on {agree[0]}/{agree[1]}; rate updates "
            f"{n_all - len(flips)}/{n_all} within {RATES_RTOL} relative of "
            f"the plain noise_rates (worst {worst:.3g}, {len(flips)} flips)")


def single_phase(book, plan, unit, samples, ploidy, opts, dev):
    """Phase 9: (a) gamma_draw against its plain version at the engines'
    shape and at the bulk shape; then, on the first chunk of every size
    class of the main unit, the single-bucket forms with launches counted
    from zero and the plain gamma samplers refused: (b) genotype_bucket per
    class and genotype_buckets_multi, (c) noise_chains_multi and
    joint_chains_multi from the engine's prior draw, (d) noise_chain from
    CountModel's prior draw on the largest class's chunk, (e) the port's
    examples.genotype_simulated; afterwards each held against the stacked
    programs (bit-equal), noise_chain's first iterations against the plain
    versions, and the example's calls against its truth. Returns the
    forms' launches."""
    from bayestyper_tpu_torch import engine, kernels
    from bayestyper_tpu_torch.examples import genotype_simulated
    from bayestyper_tpu_torch.model import gibbs
    from bayestyper_tpu_torch.model.buckets import stack_buckets
    from bayestyper_tpu_torch.model.count_model import (CountModel,
                                                        fit_genomic_nb)
    from bayestyper_tpu_torch.ops import prng
    from bayestyper_tpu_torch.ops.distributions import (
        np_build_count_log_prob_tables, tables_from_numpy)

    key = prng.prng_key(opts.random_seed)
    s, ch = len(samples), opts.num_chains
    prior = opts.noise_rate_prior

    # (a) the engines' draw and the bulk draw
    k77 = prng.fold_in(prng.fold_in(key, 77), torch.arange(ch)).to(dev)
    log("  " + check_gamma(book, "engines' shape", k77,
                           torch.full((ch, s), float(prior[0]), device=dev),
                           True))
    g = torch.Generator(device=dev).manual_seed(opts.random_seed)
    n, e = GAMMA_BULK
    lo, hi = np.log(GAMMA_ALPHA)
    alpha = torch.exp(torch.rand((n, e), generator=g, device=dev)
                      * float(hi - lo) + float(lo))
    log("  " + check_gamma(book, "log-uniform alpha", prng.split(key, n)
                           .to(dev), alpha, False))
    del alpha
    if book.failures:
        raise RuntimeError("gamma_draw disagrees with its plain version:\n"
                           + "\n".join(book.failures))

    table, counts = engine.gather_sample_counts(unit, samples,
                                                opts.num_host_threads)
    nb = fit_genomic_nb(engine.parameter_kmer_stats(unit, samples, table,
                                                    counts))
    ucounts = engine._UnitCounts(unit, table, counts)
    tables = tables_from_numpy(np_build_count_log_prob_tables(
        nb.p, nb.size, np.full(s, 1e-3), 255), dev)
    pcs = [plan[kc] for kc in sorted(plan)]
    tags = [f"H{pc.h}/K{pc.k}/C{pc.c_pad}" for pc in pcs]
    buckets = [engine._bucket_cached(
        None, pc.chunks[0], (pc.c_pad, pc.k, pc.h, pc.v), samples, ploidy,
        ucounts, opts.random_seed, dev) for pc in pcs]
    outcomes = [gibbs.make_outcome_space(pc.h) for pc in pcs]
    cfgs = [pc.cfg for pc in pcs]
    big = max(range(len(pcs)), key=lambda i: int(buckets[i].cluster_valid
                                                 .sum()))
    torch.cuda.synchronize()

    times = []

    def form(name, fn):
        before = dict(kernels.LAUNCHES)
        out = []
        ms = event_ms(lambda: out.append(fn()))
        made = {nm: kernels.LAUNCHES[nm] - before[nm]
                for nm in ("gibbs_sweep", "noise_step", "joint_step",
                           "gamma_draw") if kernels.LAUNCHES[nm] > before[nm]}
        times.append((name, ms, made))
        return out[0]

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with no_plain_rate_update():
        gb = [form(f"genotype_bucket {tag}", lambda i=i: gibbs.genotype_bucket(
            key, buckets[i], tables, outcomes[i], cfgs[i]))
            for i, tag in enumerate(tags)]
        multi = form("genotype_buckets_multi",
                     lambda: gibbs.genotype_buckets_multi(
                         key, buckets, tables, outcomes, cfgs))
        init = form("the engines' prior draw",
                    lambda: engine._prior_rates(opts, s, dev))
        noise_m = form("noise_chains_multi", lambda: gibbs.noise_chains_multi(
            key, buckets, tables, init, prior, outcomes, cfgs, ch))
        joint_m = form("joint_chains_multi", lambda: gibbs.joint_chains_multi(
            key, buckets, tables, init, prior, outcomes, cfgs, ch))
        model = form("CountModel.init_noise_from_prior",
                     lambda: CountModel.init_noise_from_prior(
                         nb, key, *prior, device=dev))
        chain = form(f"noise_chain {tags[big]}", lambda: gibbs.noise_chain(
            key, buckets[big], model.tables, model.noise_rates, prior,
            outcomes[big], cfgs[big], 0))
        example = form("examples.genotype_simulated",
                       lambda: genotype_simulated.run(dev))
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    missing = [nm for nm in SINGLE_KERNELS if launches[nm] == 0]
    if missing:
        raise RuntimeError(f"the single forms launched no {missing}")
    log("  single forms (CUDA-event ms of one call, host gaps included; "
        "gibbs_sweep/noise_step/joint_step/gamma_draw launches): "
        + "; ".join(f"{nm} {ms:.3f} {made}" for nm, ms, made in times))
    log(f"  launches {launches}")

    # (b) against genotype_stacked, each bucket of the multi form against
    # its own genotype_bucket
    bad = []
    for i, tag in enumerate(tags):
        tally, w = gibbs.genotype_stacked(key, stack_buckets([buckets[i]]),
                                          tables, outcomes[i], cfgs[i])
        if not (torch.equal(gb[i][0], tally[0]) and torch.equal(gb[i][1],
                                                                w[0])):
            bad.append(f"genotype_bucket {tag} differs from genotype_stacked")
        if not (torch.equal(multi[0][i], gb[i][0])
                and torch.equal(multi[1][i], gb[i][1])):
            bad.append(f"genotype_buckets_multi {tag} differs from "
                       f"genotype_bucket")
        if not bool((gb[i][0].sum(-1) == cfgs[i].num_samples).all()):
            bad.append(f"genotype_bucket {tag}: tally rows do not sum to "
                       f"num_samples")
    del gb, multi
    # (c) against the stacked chains over the same one-chunk stacks
    stacks = [stack_buckets([b]) for b in buckets]
    rs, tr = gibbs.noise_chains_stacked(
        key, stacks, [b.cluster_valid[None] for b in buckets], tables, init,
        prior, outcomes, cfgs, ch)
    if not (torch.equal(rs, noise_m[0]) and torch.equal(tr, noise_m[1])):
        bad.append("noise_chains_multi differs from noise_chains_stacked")
    tallies, ws, tr_j = gibbs.joint_chains_stacked(
        key, stacks, tables, init, prior, outcomes, cfgs, ch)
    if not (all(torch.equal(a[0], b) for a, b in zip(tallies, joint_m[0]))
            and all(torch.equal(a[0], b) for a, b in zip(ws, joint_m[1]))
            and torch.equal(tr_j, joint_m[2])):
        bad.append("joint_chains_multi differs from joint_chains_stacked")
    for nm, x in (("noise_chains_multi", noise_m[1]),
                  ("joint_chains_multi", joint_m[2]), ("noise_chain",
                                                       chain[1])):
        if not bool(torch.isfinite(x).all()):
            bad.append(f"{nm}: rate trace not finite")
    del stacks, tallies, ws, joint_m
    book.failures += bad
    log(f"  genotype_bucket on {len(tags)} classes ({', '.join(tags)}): bit-"
        f"equal to genotype_stacked, genotype_buckets_multi to each "
        f"genotype_bucket; noise_chains_multi and joint_chains_multi ({ch} "
        f"chains from the engines' gamma_draw prior draw) bit-equal to the "
        f"stacked chains: {not bad}")
    # (d) noise_chain: its first iterations against the plain versions
    log("  " + noise_chain_window(book, buckets[big], model.tables,
                                  model.noise_rates, outcomes[big],
                                  cfgs[big], key, chain[1], prior)
        + f"; CountModel's prior rates {model.noise_rates.tolist()}, the "
          f"chain's last rates {chain[1][-1].tolist()}")
    # (e) the example's calls
    calls, ex_launches, t_run, _ = example
    ok = sum(called == expected for _, _, called, _, expected in calls)
    for c, si, called, gq, expected in calls:
        log(f"  example cluster{c} sample{si}: called {called} GQ={gq:.0f} "
            f"expected {expected}")
    log(f"  examples.genotype_simulated on the card: {ok}/{len(calls)} "
        f"correct, {t_run * 1e3:.1f} ms, launches {ex_launches}")
    book.check(ok == len(calls), f"examples.genotype_simulated: {ok}/"
                                 f"{len(calls)} correct")
    if book.failures:
        raise RuntimeError("the single phase failed:\n"
                           + "\n".join(book.failures))
    del buckets, tables, model, chain, noise_m
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------

def random_chunk(gen, dev, c, k, h, v, s, ch, a_cap):
    """A chunk of c clusters of h haplotypes (a multiple of 32) drawn on the
    card: its ClusterBucket (every slot real, diploid samples, random
    member words) and tallies of 30 draws per (cluster, chain, sample) over
    the diploid outcomes."""
    from bayestyper_tpu_torch.model import gibbs
    from bayestyper_tpu_torch.model.buckets import ClusterBucket

    def ints(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    member = ints(-2 ** 31, 2 ** 31, (c, k, v, h // 32), torch.int32)
    na = ints(2, a_cap + 1, (c, v), torch.int16)
    osp = gibbs.make_outcome_space(h)
    dip = torch.from_numpy(osp.ploidy_mask[2]).to(dev)
    p = torch.rand((c * ch * s, len(osp.oa)), generator=gen,
                   device=dev) * dip
    tally = torch.zeros_like(p, dtype=torch.int32).scatter_add_(
        1, torch.multinomial(p, 30, replacement=True, generator=gen),
        torch.ones((c * ch * s, 30), dtype=torch.int32, device=dev))
    ones = lambda *shape: torch.ones(shape, dtype=torch.bool, device=dev)  # noqa: E731
    bucket = ClusterBucket(
        mult=ints(0, 3, (c, k, h), torch.uint8),
        inter_mult=ints(0, 2, (c, k, s), torch.uint8),
        counts=ints(0, 40, (c, k, s), torch.uint8), kmer_valid=ones(c, k),
        hap_valid=ones(c, h),
        ploidy=torch.full((c, s), 2, dtype=torch.int8, device=dev),
        hap_allele=(ints(0, 100, (c, h, v), torch.int16) % na[:, None, :]),
        num_alleles=na, variant_valid=ones(c, v),
        member=member, use_sparse=ones(c),
        sparsity=torch.full((c,), 0.5, device=dev),
        cluster_id=torch.arange(c, device=dev), cluster_valid=ones(c))
    return bucket, tally.reshape(c, ch, s, -1)


def check_beyond_unit(book, dev, seed):
    """Shapes that the wide unit does not reach, on inputs drawn on the
    card: ll_noise_terms at H256 x 30 samples (outcome tables past shared
    memory) and at H4096 x 2 samples (the largest class the compiler's beam
    forms at 30 samples x 32 sample haplotypes, 3,840 paths; its LL [S, O]
    alone is 67 MB; its multiplicities read in place); bucket_stats on an
    H64 chunk of 20,000 k-mer slots and at H4096 x 2 samples (8,394,753
    outcomes, its top-8 selection merged over 8,199 partitions; the
    global-memory variant); and subsample_masks on a chunk whose clusters
    and slots include padding. LL within LL_RTOL / LL_ATOL, stats as
    check_stats, masks bit-equal. Returns the lines."""
    from bayestyper_tpu_torch import kernels
    from bayestyper_tpu_torch.model import gibbs
    from bayestyper_tpu_torch.ops.distributions import (
        np_build_count_log_prob_tables)

    gen = torch.Generator(device=dev).manual_seed(seed)
    lines = []
    for h, s, c, k, ch in BEYOND_LL:
        bucket, _ = random_chunk(gen, dev, c, k, h, 1, s, ch, 2)
        w = torch.rand((c, ch, k), generator=gen, device=dev) < 0.5
        osp = gibbs.outcome_tensors(h, dev)
        mmax = 16
        tables = torch.from_numpy(np_build_count_log_prob_tables(
            np.full(s, 0.4), np.full(s, 6.0), np.full(s, 1e-3), mmax)
            .astype(np.float32)).to(dev)
        args = (bucket.mult, bucket.inter_mult, bucket.counts, w, tables,
                mmax, osp.oa32, osp.ob32)
        tag = f"H{h}/K{k}/C{c} x{s} samples"
        with book.variants():
            err = 0.0
            for noise in (False, True):
                kw = dict(include_noise_row=not noise, noise_terms=noise)
                got = kernels.ll_noise_terms(*args, **kw)
                want = kernels.PLAIN["ll_noise_terms"](*args, **kw)
                torch.cuda.synchronize()
                pairs = [(got[0], want[0])] + (list(zip(got[1], want[1]))
                                               if noise else [])
                for g, x in pairs:
                    err = max(err, float((g - x).abs().max()))
                    book.check(bool(torch.isfinite(g).all()) and
                               torch.allclose(g, x, rtol=LL_RTOL,
                                              atol=LL_ATOL),
                               f"ll_noise_terms {tag}: max abs err {err}")
                del got, want, pairs
            book.err("ll_noise_terms", err)
            ms = cuda_ms(lambda: kernels.ll_noise_terms(*args), 3)
            pms = cuda_ms(lambda: kernels.PLAIN["ll_noise_terms"](*args), 1)
            o = osp.oa.shape[0]
            nbytes = (c * k * (h + 2 * s) + ch * c * k + tables.numel() * 4
                      + c * ch * s * o * 4)
            bms, by = bound(nbytes, 2 * int(w.sum()) * s * o)
            book.timing("ll_noise_terms", True, ms=ms, plain_ms=pms,
                        bound_ms=bms, bound_by=by, library_ms=None, shape=tag)
        lines.append(f"ll_noise_terms {tag}: max abs err {err:.3g}; {ms:.3f} "
                     f"ms, plain {pms:.3f} ms, bound {bms:.4f} ms ({by})")
        del bucket, w, args
        torch.cuda.empty_cache()

    c, k, h, v, s, ch, a_cap = 2, 20000, 64, 2, 3, 3, 4
    bucket, tally = random_chunk(gen, dev, c, k, h, v, s, ch, a_cap)
    osp = gibbs.outcome_tensors(h, dev)
    w = torch.rand((c, ch, k), generator=gen, device=dev) < 0.5
    st_args = (bucket.mult, bucket.inter_mult, bucket.counts, bucket.member,
               bucket.hap_allele, bucket.num_alleles, bucket.ploidy, tally,
               w, osp.oa32, osp.ob32, a_cap, 8, 0.99, 1.0,
               torch.tensor([0.9, 0.5, 0.2]), True)
    with book.variants():
        lines.append(check_stats(book, f"H{h}/K{k}/C{c}", bucket, st_args,
                                 True))
    del bucket, tally, w, st_args

    # the largest class, at BEYOND_LL's second entry, two variants
    h, s, c, k, ch = BEYOND_LL[1]
    v, a_cap = 2, 3
    bucket, tally = random_chunk(gen, dev, c, k, h, v, s, ch, a_cap)
    osp = gibbs.outcome_tensors(h, dev)
    w = torch.rand((c, ch, k), generator=gen, device=dev) < 0.5
    st_args = (bucket.mult, bucket.inter_mult, bucket.counts, bucket.member,
               bucket.hap_allele, bucket.num_alleles, bucket.ploidy, tally,
               w, osp.oa32, osp.ob32, a_cap, 8, 0.99, 1.0,
               torch.tensor([0.9, 0.5]), True)
    with book.variants():
        lines.append(check_stats(book, f"H{h}/K{k}/C{c} x{s} samples",
                                 bucket, st_args, True))
    del bucket, tally, w, st_args
    torch.cuda.empty_cache()
    lines.append(check_masks_padded(book, gen, dev))
    return lines


def check_masks_padded(book, gen, dev):
    """subsample_masks bit-equal to its plain version on a bulk-sized chunk
    (4,096 clusters x 20 chains x 128 slots) whose last quarter of clusters
    is padding (no valid slot, cluster id 0) and whose real clusters hold
    0-128 k-mers; no padded slot kept."""
    from bayestyper_tpu_torch import kernels
    from bayestyper_tpu_torch.model import gibbs
    from bayestyper_tpu_torch.ops import prng

    c, ch, k = 4096, 20, 128
    lens = torch.randint(0, k + 1, (c,), generator=gen, device=dev)
    lens[3 * c // 4:] = 0
    valid = torch.arange(k, device=dev)[None, :] < lens[:, None]
    cid = torch.randint(0, 2 ** 31, (c,), generator=gen, device=dev)
    cid[3 * c // 4:] = 0
    base, fold = gibbs._chain_base(prng.prng_key(7), ch)
    args = (base, fold, cid, valid, 0.1, gibbs._SUBSAMPLE_SALT)
    got = kernels.subsample_masks(*args)
    want = kernels.PLAIN["subsample_masks"](*args)
    torch.cuda.synchronize()
    bad = int((got != want).sum())
    stray = int((got & ~valid[:, None, :]).sum())
    book.check(bad == 0 and stray == 0,
               f"subsample_masks, padded chunk: {bad} entries differ, "
               f"{stray} padded slots kept")
    book.err("subsample_masks", min(bad, 1))
    return (f"subsample_masks C{c}/K{k} x{ch} chains, a quarter of the "
            f"clusters padded: {bad} of {got.numel()} differ, {stray} "
            f"padded slots kept")


def wide_phase(tmp, args, opts, ploidy, dev, name, smi):
    """Phase "wide": the wide unit (WIDE_SAMPLES samples) through the
    cluster phase; every kernel against its plain version on the first
    chunk of every size class, filed by the layout that launched; the
    coupled scan on its H64 child level; then genotype_unit and
    genotype_unit_joint with the main bars, over all variants and over the
    coupled family. Returns (its book, the two runs' launches)."""
    from bayestyper_tpu_torch import engine, kernels
    from bayestyper_tpu_torch.model import gibbs
    from bayestyper_tpu_torch.model.buckets import stack_buckets
    from bayestyper_tpu_torch.model.count_model import fit_genomic_nb
    from bayestyper_tpu_torch.ops import prng
    from bayestyper_tpu_torch.ops.distributions import (
        np_build_count_log_prob_tables, tables_from_numpy)

    wtmp = os.path.join(tmp, "wide")
    os.makedirs(wtmp)
    t0 = time.perf_counter()
    genome, vcf_path, variants, truth, samples, families = simulate_wide(
        wtmp, args.seed, WIDE_SCALE)
    family_vi = {vi for _, d, kids in families for vi in [d] + kids}
    unit = engine.run_cluster_phase(
        genome, samples, vcf_path, ploidy, kmer_size=K,
        max_parameter_kmers=1_000_000, num_threads=os.cpu_count() or 1)
    t_cluster = time.perf_counter() - t0
    hs = {}
    for fc in unit.compiled:
        hs[fc.hap_allele.shape[0]] = hs.get(fc.hap_allele.shape[0], 0) + 1
    longest = max(len(fc.kmer_hi) for fc in unit.compiled)
    log(f"wide data: {len(variants)} variants, {len(samples)} samples at "
        f"{COVERAGE:.0f}x, genome {len(genome['chr1'])} bp; "
        f"{len(unit.compiled)} clusters, haplotype census "
        f"{dict(sorted(hs.items()))}, the longest of {longest} k-mers, "
        f"{sum(engine._is_coupled(fc) for fc in unit.compiled)} coupled "
        f"(simulate + cluster {t_cluster:.1f} s)")

    t0 = time.perf_counter()
    book, plan = kernel_phase(unit, samples, ploidy, opts, dev,
                              scan=WIDE_SCAN, variants=True)
    table, counts = engine.gather_sample_counts(unit, samples,
                                                opts.num_host_threads)
    nb = fit_genomic_nb(engine.parameter_kmer_stats(unit, samples, table,
                                                    counts))
    tables = tables_from_numpy(np_build_count_log_prob_tables(
        nb.p, nb.size, np.full(len(samples), 1e-3), 255), dev)
    ucounts = engine._UnitCounts(unit, table, counts)
    key = prng.prng_key(opts.random_seed)
    # joint_step on every class's first chunk, set up as joint mode does
    k_master, _ = gibbs._chain_keys(key, opts.num_chains, 0)
    ks = prng.split(k_master, 2)
    for key_cls in sorted(plan):
        pc = plan[key_cls]
        sb = stack_buckets([engine._bucket_cached(
            None, pc.chunks[0], (pc.c_pad, pc.k, pc.h, pc.v), samples,
            ploidy, ucounts, opts.random_seed, dev)])
        su = gibbs._noise_setup(ks[:, 0], ks[:, 1], sb, sb.cluster_valid,
                                tables, gibbs.make_outcome_space(pc.h),
                                pc.cfg)
        with book.variants():
            log("  " + check_joint_class(book, pc, su, sb.cluster_valid.sum(),
                                         opts.burn_in, True))
        del su, sb
    book.check(book.josel[0] >= OSEL_AGREE_MIN * book.josel[1],
               f"joint_step drawn outcomes agree on "
               f"{book.josel[0]}/{book.josel[1]}")
    # the coupled scan on the family's levels
    nested = [fc for fc in unit.compiled if engine._is_coupled(fc)]
    ni = engine._nested_inputs(nested, samples, ploidy, ucounts, opts, dev)
    cargs, ckw = ni.genotype_args(key, tables)
    setup = gibbs.nested_setup(*cargs, **ckw)
    log(f"  coupled levels H{[b.num_haplotypes for b in ni.buckets]}")
    with book.variants():
        for line in check_nested(book, setup, opts.num_chains):
            log("  " + line)
    for line in check_beyond_unit(book, dev, opts.random_seed):
        log("  " + line)
    for nm, r in book.times:
        log(f"  time {nm} at {r['shape']}: {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    missing = [nm for nm in kernels.GLOBAL.values() if nm not in book.rows]
    book.check(not missing, f"the wide checks ran no {missing}")
    if book.failures:
        raise RuntimeError("wide: kernels disagree with their plain "
                           "versions:\n" + "\n".join(book.failures))
    log(f"wide kernels: {', '.join(kernels.GLOBAL.values())} checked "
        f"({time.perf_counter() - t0:.1f} s); drawn outcomes agree on "
        f"{book.osel[0]}/{book.osel[1]} (gibbs_sweep), "
        f"{book.nosel[0]}/{book.nosel[1]} (noise_step) and "
        f"{book.josel[0]}/{book.josel[1]} (joint_step)")

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out_path = os.path.join(wtmp, "genotypes.vcf")
    t0 = time.perf_counter()
    with no_plain_rate_update():
        summary = engine.genotype_unit(unit, samples, genome, ploidy,
                                       out_path, opts, device="cuda")
        torch.cuda.synchronize()
    t_genotype = time.perf_counter() - t0
    log_vcf("wide", out_path)
    launches = dict(kernels.LAUNCHES)
    missing = [nm for nm in WIDE_KERNELS if launches[nm] == 0]
    if missing:
        raise RuntimeError(f"the wide path launched no {missing}")
    if summary["num_variants"] != len(variants):
        raise RuntimeError(f"wrote {summary['num_variants']} of "
                           f"{len(variants)} wide-unit variants")
    tm = summary["timings"]
    log(f"wide: genotype_unit on {name}: counts {tm['counts_s']:.1f} s, "
        f"noise {tm['noise_s']:.1f} s, waves+stats {tm['waves_s']:.1f} s, "
        f"coupled {tm['coupled_s']:.1f} s, write {tm['write_s']:.1f} s; "
        f"{len(variants) / (t_cluster + t_genotype):.1f} variants/s "
        f"(simulate + cluster + genotype, {smi})")
    log(f"wide: launches {launches}")
    subsets = (("all", None), ("coupled", family_vi))
    for label, subset in subsets:
        call_rate, conc, n = concordance(out_path, variants, truth, subset)
        log(f"wide: {label} variants: call rate {call_rate:.4f}, "
            f"concordance {conc:.4f} over {n} genotypes")
        if label == "all" and not (conc > 0.95 and call_rate > 0.7):
            raise RuntimeError(f"wide unit: concordance {conc:.4f} / call "
                               f"rate {call_rate:.4f} below 0.95 / 0.7")
    launches_j = joint_run(unit, samples, genome, ploidy, opts,
                           os.path.join(wtmp, "genotypes_joint.vcf"), name,
                           smi, t_cluster, variants, truth, "wide joint")
    missing = [nm for nm in WIDE_JOINT_KERNELS if launches_j[nm] == 0]
    if missing:
        raise RuntimeError(f"the wide joint path launched no {missing}")
    return book, launches, launches_j


def mesh_phase(plan, unit, samples, genome, ploidy, opts, dev, paths,
               launches_1, tmp):
    """Phase "mesh": genotype_unit at MESH_SHARDS shards and
    genotype_unit_joint at the first, each with its shards placed
    round-robin over the visible cards, must write the one-device runs'
    VCFs (paths: the sequential and the joint VCF of phases 5 and 7, whose
    launches launches_1 the sequential runs are held against); then
    genotype_bucket_sharded and noise_chain_sharded bit-equal to
    genotype_bucket and noise_chain on the bulk class's first chunk.
    Returns the mesh runs' summed launches."""
    from bayestyper_tpu_torch import engine, kernels
    from bayestyper_tpu_torch.model import gibbs
    from bayestyper_tpu_torch.model.count_model import fit_genomic_nb
    from bayestyper_tpu_torch.ops import prng
    from bayestyper_tpu_torch.ops.distributions import (
        np_build_count_log_prob_tables, tables_from_numpy)
    from bayestyper_tpu_torch.parallel import mesh as pmesh

    log(f"mesh: {torch.cuda.device_count()} card(s) visible; shards placed "
        f"round-robin over them")
    total = dict.fromkeys(kernels.LAUNCHES, 0)
    runs = [(engine.genotype_unit, n, paths[0]) for n in MESH_SHARDS]
    runs.append((engine.genotype_unit_joint, MESH_SHARDS[0], paths[1]))
    for run, n, ref in runs:
        out = os.path.join(tmp, f"mesh_{run.__name__}_{n}.vcf")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with no_plain_rate_update():
            run(unit, samples, genome, ploidy, out,
                dataclasses.replace(
                    opts, num_devices=n,
                    noise_genotyping=run is engine.genotype_unit_joint),
                device="cuda")
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        log_vcf(f"mesh {run.__name__} over {n}", out)
        launches = dict(kernels.LAUNCHES)
        for nm, c in launches.items():
            total[nm] += c
        with open(out, "rb") as a, open(ref, "rb") as b:
            same = a.read() == b.read()
        log(f"mesh: {run.__name__} over {n} shards: VCF "
            f"{'byte-identical to' if same else 'DIFFERS from'} the "
            f"one-device run's ({secs:.1f} s); launches per shard "
            + ", ".join(f"{nm} {c / n:g}" for nm, c in launches.items()
                        if c and nm not in ("noise_rates", "noise_rates_draws",
                                            "gamma_draw", "unpack_bucket"))
            + f"; once per run: noise_rates {launches['noise_rates']}, "
              f"noise_rates_draws {launches['noise_rates_draws']}, "
              f"gamma_draw {launches['gamma_draw']}, unpack_bucket "
              f"{launches['unpack_bucket']}")
        if not same:
            raise RuntimeError(f"mesh: {run.__name__} over {n} shards "
                               f"differs from the one-device VCF: "
                               f"{first_difference(out, ref)}")
        if run is engine.genotype_unit:
            for nm in ("gibbs_sweep", "noise_step", "bucket_stats"):
                if launches[nm] != n * launches_1[nm]:
                    raise RuntimeError(
                        f"mesh: {nm} launched {launches[nm]} times over {n} "
                        f"shards, not {n} x {launches_1[nm]}")
            for nm in ("noise_rates", "noise_rates_draws"):
                if launches[nm] != launches_1[nm]:
                    raise RuntimeError(f"mesh: {nm} did not run once per "
                                       f"iteration (draws: per scan)")

    # the mesh programs on the bulk class's first chunk
    key = prng.prng_key(opts.random_seed)
    table, counts = engine.gather_sample_counts(unit, samples,
                                                opts.num_host_threads)
    nb = fit_genomic_nb(engine.parameter_kmer_stats(unit, samples, table,
                                                    counts))
    tables = tables_from_numpy(np_build_count_log_prob_tables(
        nb.p, nb.size, np.full(len(samples), 1e-3), 255), dev)
    kc = max(plan, key=lambda k: sum(len(c) for c in plan[k].chunks))
    pc = plan[kc]
    mesh = pmesh.make_mesh(MESH_SHARDS[-1], dev)
    bucket = engine._bucket_cached(
        None, pc.chunks[0], (pc.c_pad, pc.k, pc.h, pc.v), samples, ploidy,
        engine._UnitCounts(unit, table, counts), opts.random_seed, dev)
    outcomes = gibbs.make_outcome_space(pc.h)
    init = engine._prior_rates(opts, len(samples), dev)[0]
    with no_plain_rate_update():
        one = gibbs.genotype_bucket(key, bucket, tables, outcomes, pc.cfg)
        sharded = pmesh.genotype_bucket_sharded(key, bucket, tables,
                                                outcomes, pc.cfg, mesh)
        chain = gibbs.noise_chain(key, bucket, tables, init,
                                  opts.noise_rate_prior, outcomes, pc.cfg, 0)
        chain_s = pmesh.noise_chain_sharded(key, bucket, tables, init,
                                            opts.noise_rate_prior, outcomes,
                                            pc.cfg, 0, mesh)
        torch.cuda.synchronize()
    tag = f"H{pc.h}/K{pc.k}/C{pc.c_pad}"
    for nm, a, b in (("genotype_bucket_sharded", one, sharded),
                     ("noise_chain_sharded", chain, chain_s)):
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        log(f"mesh: {nm} over {mesh.size} shards on {tag}: "
            f"{'bit-equal to' if same else 'DIFFERS from'} the one-device "
            f"form")
        if not same:
            raise RuntimeError(f"mesh: {nm} differs from the one-device form")
    return total


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=2.0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs on a CUDA card only", file=sys.stderr)
        return 2
    # a crash in native code prints the Python stack of every thread
    faulthandler.enable()

    from bayestyper_tpu_torch import engine, kernels
    from bayestyper_tpu_torch.io.samples import ChromosomePloidy

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(f"device: {name}, {torch.cuda.device_count()} visible; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")

    t0 = time.perf_counter()
    kernels.build()
    log(f"build: {len(kernels.KERNELS)} kernels (cpp_extension, sm_90a) in "
        f"{time.perf_counter() - t0:.1f} s")

    tmp = tempfile.mkdtemp(prefix="bt_chip_smoke_")
    try:
        t0 = time.perf_counter()
        genome, vcf_path, variants, truth, samples = simulate(
            tmp, args.seed, args.scale)
        t_sim = time.perf_counter() - t0
        log(f"data: {len(variants)} variants, {len(samples)} samples at "
            f"{COVERAGE:.0f}x, genome {len(genome['chr1'])} bp, k={K} "
            f"({t_sim:.1f} s)")

        ploidy = ChromosomePloidy.human_default()
        t0 = time.perf_counter()
        unit = engine.run_cluster_phase(
            genome, samples, vcf_path, ploidy, kmer_size=K,
            max_parameter_kmers=1_000_000, num_threads=os.cpu_count() or 1)
        t_cluster = time.perf_counter() - t0
        coupled = sum(engine._is_coupled(fc) for fc in unit.compiled)
        hs = {}
        for fc in unit.compiled:
            hs[fc.hap_allele.shape[0]] = hs.get(fc.hap_allele.shape[0], 0) + 1
        log(f"cluster: {len(unit.compiled)} clusters, haplotype census "
            f"{dict(sorted(hs.items()))}, {coupled} coupled ({t_cluster:.1f} s)")

        opts = engine.GenotypeOptions(
            num_chains=20, burn_in=100, num_samples=250, random_seed=1,
            max_bucket_clusters=4096, num_host_threads=os.cpu_count() or 1)
        t0 = time.perf_counter()
        book, plan = kernel_phase(unit, samples, ploidy, opts, dev)
        checked = ("subsample_masks", "ll_noise_terms", "gibbs_sweep",
                   "noise_step", "bucket_stats", "unpack_bucket", "kmer_cap")
        log(f"kernels: {', '.join(checked)} checked on "
            f"{len(plan)} size classes ({time.perf_counter() - t0:.1f} s); "
            f"drawn outcomes agree on {book.osel[0]}/{book.osel[1]} "
            f"(gibbs_sweep) and {book.nosel[0]}/{book.nosel[1]} (noise_step), "
            f"GT calls on {book.gt[0]}/{book.gt[1]}")
        for nm in checked[:4] + checked[5:6]:
            r = book.rows[nm]
            log(f"  {nm}: max abs err {r['max_abs_err']:.3g}; at {r['shape']} "
                f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
        for nm, r in book.times:
            log(f"  time {nm} at {r['shape']}: {r['ms']:.3f} ms, plain "
                f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
        if book.failures:
            raise RuntimeError("kernels disagree with their plain versions:\n"
                               + "\n".join(book.failures))
        log("kernels: " + ", ".join(f"{nm} ok" for nm in checked))

        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out_path = os.path.join(tmp, "genotypes.vcf")
        t0 = time.perf_counter()
        by_width = {}
        with no_plain_rate_update(), launches_by_width(by_width):
            summary = engine.genotype_unit(unit, samples, genome, ploidy,
                                           out_path, opts, device="cuda")
            torch.cuda.synchronize()
        t_genotype = time.perf_counter() - t0
        log_vcf("main", out_path)
        launches = dict(kernels.LAUNCHES)
        missing = [nm for nm in MAIN_KERNELS if launches[nm] == 0]
        if missing:
            raise RuntimeError(f"main path launched no {missing}")
        check_rate_launches(launches, opts.burn_in + opts.num_samples, "main")
        if summary["num_variants"] != len(variants):
            raise RuntimeError(f"wrote {summary['num_variants']} of "
                               f"{len(variants)} variants")
        if not np.isfinite(summary["noise_rates"]).all():
            raise RuntimeError(f"noise rates {summary['noise_rates']}")
        t0 = time.perf_counter()
        call_rate, conc, n_calls = concordance(out_path, variants, truth)
        tm = summary["timings"]
        log(f"main: genotype_unit on {name}: counts {tm['counts_s']:.1f} s, "
            f"noise {tm['noise_s']:.1f} s, waves+stats {tm['waves_s']:.1f} s, "
            f"coupled {tm['coupled_s']:.1f} s, write {tm['write_s']:.1f} s; "
            f"cluster {t_cluster:.1f} s; "
            f"{len(variants) / (t_cluster + t_genotype):.1f} variants/s "
            f"(cluster + genotype, {smi})")
        log(f"main: launches {launches}")
        log(f"main: call rate {call_rate:.4f}, concordance {conc:.4f} over "
            f"{n_calls} genotypes")
        if not (conc > 0.95 and call_rate > 0.7):
            raise RuntimeError(f"concordance {conc:.4f} / call rate "
                               f"{call_rate:.4f} below 0.95 / 0.7")

        t0 = time.perf_counter()
        launches_d, launches_dm = lookup_phase(
            book, tmp, unit, samples, genome, ploidy, opts, dev, out_path,
            args, name, smi, t_cluster, variants, truth)
        log(f"lookup: lane_lookup, bloom_query ok "
            f"({time.perf_counter() - t0:.1f} s)")

        t0 = time.perf_counter()
        for line in joint_check(book, plan, unit, samples, ploidy, opts, dev):
            log("  " + line)
        if book.failures:
            raise RuntimeError("kernels disagree with their plain versions:\n"
                               + "\n".join(book.failures))
        log(f"joint kernels: joint_step, noise_rates, noise_rates_draws ok "
            f"({time.perf_counter() - t0:.1f} s); drawn outcomes agree on "
            f"{book.josel[0]}/{book.josel[1]} (joint_step)")
        joint_path = os.path.join(tmp, "genotypes_joint.vcf")
        with launches_by_width(by_width):
            launches_j = joint_run(unit, samples, genome, ploidy, opts,
                                   joint_path, name, smi, t_cluster,
                                   variants, truth, "joint")
        log("main unit, every class (main and joint paths):")
        log_class_times(book, by_width)
        if launches_j["unpack_bucket"] == 0:
            raise RuntimeError("the joint path launched no unpack_bucket")

        t0 = time.perf_counter()
        launches_m = mesh_phase(plan, unit, samples, genome, ploidy, opts,
                                dev, (out_path, joint_path), launches, tmp)
        log(f"mesh: ok ({time.perf_counter() - t0:.1f} s)")

        launches_c, launches_cj = coupled_run(tmp, args, opts, ploidy, book,
                                              dev, name, smi)

        t0 = time.perf_counter()
        launches_s = single_phase(book, plan, unit, samples, ploidy, opts,
                                  dev)
        log(f"single: gamma_draw and the single-bucket forms ok "
            f"({time.perf_counter() - t0:.1f} s)")

        t0 = time.perf_counter()
        book_w, launches_w, launches_wj = wide_phase(tmp, args, opts, ploidy,
                                                     dev, name, smi)
        log(f"wide: ok ({time.perf_counter() - t0:.1f} s)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    rows = []
    paths = {"main": launches, "joint": launches_j, "coupled": launches_c,
             "coupled_joint": launches_cj, "device_lookup": launches_d,
             "main_device_lookup": launches_dm, "single": launches_s,
             "mesh": launches_m, "wide": launches_w,
             "wide_joint": launches_wj}
    base = {v: k for k, v in kernels.GLOBAL.items()}
    for nm in kernels.KERNELS + tuple(kernels.GLOBAL.values()):
        r = book_w.rows[nm] if nm in base else book.rows[nm]
        src = base.get(nm, nm)
        rows.append({
            "name": nm, "route": "cuda",
            "source": f"bayestyper_tpu_torch/kernels/csrc/{src}.cu",
            "replaces": kernels.REPLACES[src],
            "launches": sum(p[nm] for p in paths.values()),
            "launches_by_path": {p: c[nm] for p, c in paths.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "device_ms": r.get("device_ms"),
        })
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
