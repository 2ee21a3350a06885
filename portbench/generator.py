"""The benchmark's inputs, made from --seed: a genome, a candidate VCF and
one KMC1 k-mer table per sample.

One generator reads every traffic mix (`mixes/<name>.json`); its `kind`
picks the placement:

  * "bulk": SNVs, indels, dense clusters of N SNVs ("denseN"), SV
    deletions and insertions 420-620 bp apart, and a duplicated 50 kb
    block;
  * "coupled": containment families (a deletion over 1-8 SNVs), segmental-
    duplication families (a deletion over an SNV in each of two copies of
    a 200 bp repeat) and one dense family of many SNVs, among isolated SNVs.

A mix may state its SV lengths, "lengths": {"sv_del": [lo, hi], "sv_ins":
[lo, hi], "contain": [lo, hi]} (LENGTHS holds the ranges of a mix that
states none); the draws are the same calls in the same order either way.

The placement functions are copies of chip_smoke.py's
make_genome_and_variants, make_coupled_genome_and_variants,
coupled_haplotypes and apply_haplotype (frozen here, so that edits there
do not move the benchmark), changed in one respect: every random size
(indel and SV lengths, deletion spans, family sizes) is drawn from a
fixed list that the seed only shuffles, so that every seed makes the same
work in another order.

Each sample's k-mers are counted on the device (kmers.count) and its
counts drawn there from a torch.Generator seeded from --seed: a negative
binomial of mean coverage * multiplicity and variance ratio times that
(a gamma-Poisson mixture). The KMC1 files are written by write_kmc1, a
copy of the port's io.kmc.write_kmc1 with the suffix bytes composed on
the device.
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np
import torch

from . import kmers

STAR = 2  # a child allele inside its parent's deleted span


def _spread(rng, n, lo, hi):
    """n integers spread evenly over [lo, hi], in an order from rng."""
    if n <= 0:
        return []
    vals = np.rint(np.linspace(lo, hi, n)).astype(np.int64)
    return [int(v) for v in rng.permutation(vals)]


# the mix's "lengths" a kind may state, [lo, hi] in bp, and today's ranges:
# bulk deletions and insertions, coupled deletions over 1-8 SNVs (which
# need 541 bp or more to hold 8 SNVs 60 bp apart)
LENGTHS = {"sv_del": (150, 400), "sv_ins": (100, 200), "contain": (600, 3000)}
MIN_LENGTH = {"sv_del": 1, "sv_ins": 1, "contain": 541}


def lengths(mix, kind):
    """The [lo, hi] range of the mix's `kind` of SV: its "lengths" entry,
    else today's."""
    stated = mix.get("lengths", {})
    other = sorted(set(stated) - set(LENGTHS))
    if other:
        raise ValueError(f"unknown lengths {other}; a mix may state "
                         f"{sorted(LENGTHS)}")
    lo, hi = (int(v) for v in stated.get(kind, LENGTHS[kind]))
    if not MIN_LENGTH[kind] <= lo <= hi:
        raise ValueError(f"lengths {kind!r}: [{lo}, {hi}] is not a range "
                         f"from {MIN_LENGTH[kind]} bp up")
    return lo, hi


def _cycle(rng, n, values):
    """n items of values in turn, in an order from rng."""
    return [values[i] for i in rng.permutation(np.arange(n) % len(values))]


def make_bulk(rng, mix, scale, k):
    """Genome with a duplicated block and the mixed variant placement.
    Returns (seq, [(pos0, ref, alt)]). Adapted from chip_smoke.py's
    make_genome_and_variants: the places are drawn first, from spacings
    that the seed only shuffles, and the genome made as long as the widest
    placement needs, so that no seed drops a variant and every seed's
    genome has one length."""
    kinds = [kd for kd, n in mix["kinds"].items() for _ in range(int(n * scale))]
    kinds = [kinds[i] for i in rng.permutation(len(kinds))]
    count = {kd: kinds.count(kd) for kd in set(kinds)}
    indel = iter(_cycle(rng, count.get("indel", 0), ["ins", "del"]))
    indel_len = iter(_spread(rng, count.get("indel", 0), 2, 8))
    del_len = iter(_spread(rng, count.get("sv_del", 0),
                           *lengths(mix, "sv_del")))
    ins_len = iter(_spread(rng, count.get("sv_ins", 0),
                           *lengths(mix, "sv_ins")))
    gaps = _spread(rng, len(kinds), 420, 619)
    dense_max = {kd: int(kd[5:]) * (max(5, (k - 6) // int(kd[5:])) - 1)
                 for kd in count if kd.startswith("dense")}
    length = (300 + sum(gaps) + 1500
              + sum(dense_max[kd] * n for kd, n in count.items()
                    if kd in dense_max))
    places = []
    pos = 300
    for kind, gap in zip(kinds, gaps):
        pos += gap
        if kind == "indel":
            places.append((kind, pos, (next(indel), next(indel_len))))
        elif kind.startswith("dense"):
            n = int(kind[5:])
            steps = [int(rng.integers(4, max(5, (k - 6) // n)))
                     for _ in range(n)]
            places.append((kind, pos, steps))
            pos += sum(steps)
        elif kind == "sv_del":
            places.append((kind, pos, next(del_len)))
            pos += places[-1][2]
        elif kind == "sv_ins":
            places.append((kind, pos, next(ins_len)))
        elif kind == "snv":
            places.append((kind, pos, None))
        else:
            raise ValueError(f"unknown bulk kind {kind!r}")
    length += sum(p[2] for p in places if p[0] == "sv_del")
    seq = _bases(rng, length)
    seq = seq + seq[1000:1000 + mix.get("dup_block", 0)]
    variants = []
    for kind, pos, arg in places:
        ref_base = seq[pos]
        if kind == "snv":
            variants.append((pos, ref_base, _other(rng, ref_base)))
        elif kind == "indel":
            how, n = arg
            if how == "ins":
                variants.append((pos, ref_base, ref_base + _bases(rng, n)))
            else:
                variants.append((pos, seq[pos:pos + n + 1], ref_base))
        elif kind.startswith("dense"):
            p = pos
            for step in arg:
                variants.append((p, seq[p], _other(rng, seq[p])))
                p += step
        elif kind == "sv_del":
            variants.append((pos, seq[pos:pos + arg + 1], ref_base))
        else:
            variants.append((pos, ref_base, ref_base + _bases(rng, arg)))
    return seq, variants


def make_coupled(rng, mix, scale, k):
    """Genome and variants of the coupled unit. Returns (seq, variants,
    families), each family (kind, deletion index, child indices). Adapted
    from chip_smoke.py's make_coupled_genome_and_variants."""
    kinds = [kd for kd, n in mix["kinds"].items() for _ in range(int(n * scale))]
    kinds.append("dense")
    kinds = [kinds[i] for i in rng.permutation(len(kinds))]
    n_contain = kinds.count("contain")
    spans = iter(_spread(rng, n_contain, *lengths(mix, "contain")))
    members = iter(_cycle(rng, n_contain, list(range(1, 9))))
    dense_n, dense_gap = mix["dense_snvs"], mix["dense_spacing"]
    sizes = [next(spans) if kd == "contain" else
             {"segdup": 1000, "dense": 200 + (dense_n - 1) * dense_gap,
              "snv": 1}[kd] for kd in kinds]
    total = 600 + sum(600 + s for s in sizes)
    seq = bytearray(_bases(rng, total).encode())
    variants, families = [], []

    def snv(p):
        ref = chr(seq[p])
        variants.append((p, ref, _other(rng, ref)))
        return len(variants) - 1

    pos = 300
    for kind, size in zip(kinds, sizes):
        pos += int(400 + rng.integers(0, 200))
        if kind == "snv":
            snv(pos)
            pos += 1
            continue
        if kind == "contain":
            n = next(members)
            span = size - 120 - 60 * (n - 1)
            offs = np.sort(rng.integers(0, span, n)) + 60 * np.arange(n)
            kids = [pos + 61 + int(o) for o in offs]
        elif kind == "segdup":
            seq[pos + 700:pos + 900] = seq[pos + 100:pos + 300]
            kids = [pos + 200, pos + 800]
        else:
            kids = [pos + 100 + dense_gap * j for j in range(dense_n)]
        d = len(variants)
        variants.append((pos, seq[pos:pos + size + 1].decode(), chr(seq[pos])))
        children = [snv(q) for q in kids]
        if kind == "segdup":  # the same alt at the same repeat offset
            p2, r2, _ = variants[children[1]]
            variants[children[1]] = (p2, r2, variants[children[0]][2])
        families.append((kind, d, children))
        pos += size + 1
    return seq.decode(), variants, families


def _bases(rng, n):
    return (np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
            .tobytes().decode())


def _other(rng, base):
    return str(rng.choice([b for b in "ACGT" if b != base]))


def bulk_haplotypes(rng, variants, num_samples):
    """[sample, copy, variant] alleles: each variant's genotype drawn as
    chip_smoke.py's simulate draws it (two fair coins, sorted)."""
    g = np.sort(rng.integers(0, 2, (num_samples, len(variants), 2)), axis=2)
    return g.transpose(0, 2, 1).astype(np.int8)


def coupled_haplotypes(rng, variants, families):
    """Per-variant alleles of one haplotype: each family's deletion is
    present with probability 0.3, and then its children carry `*`; else
    each child is ref or alt (a segmental-duplication family's two children
    alike). Copied from chip_smoke.py."""
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
    """One haplotype's sequence; variants sorted by position. Reference and
    `*` alleles leave the sequence as it is. Copied from chip_smoke.py."""
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


def write_kmc1(prefix, hi, lo, counts, k, lut_prefix_length=7,
               counter_size=4, min_count=1):
    """A KMC1 database (.kmc_pre, .kmc_suf) of sorted canonical lane pairs
    (int64 tensors on any device) and their counts: the port's
    io.kmc.write_kmc1 (frozen copy) with the LUT and the suffix records
    built in torch."""
    assert (k - lut_prefix_length) % 4 == 0
    n_hi = min(kmers.N_HI, k)
    n = hi.numel()
    pref = hi >> (2 * (n_hi - lut_prefix_length))
    num_pref = 1 << (2 * lut_prefix_length)
    lut = torch.searchsorted(
        pref, torch.arange(num_pref, dtype=torch.int64, device=hi.device))

    def base_at(j):
        if j < n_hi:
            return (hi >> (2 * (n_hi - 1 - j))) & 3
        return (lo >> (2 * (k - 1 - j))) & 3

    cols = []
    for b in range((k - lut_prefix_length) // 4):
        base0 = lut_prefix_length + 4 * b
        byte = torch.zeros(n, dtype=torch.int64, device=hi.device)
        for t in range(4):
            byte = (byte << 2) | base_at(base0 + t)
        cols.append(byte)
    for b in range(counter_size):
        cols.append((counts >> (8 * b)) & 0xFF)
    rec = torch.stack(cols, dim=1).to(torch.uint8).cpu().numpy()
    header = np.array([k, (lut_prefix_length << 32) | counter_size,
                       (0xFFFFFFFF << 32) | min_count, n, 0], dtype="<u8")
    with open(prefix + ".kmc_pre", "wb") as fh:
        fh.write(b"KMCP")
        fh.write(lut.cpu().numpy().astype("<u8").tobytes())
        fh.write(header.tobytes())
        fh.write(struct.pack("<III", 0, 0, 8 * 5 + 8))
        fh.write(b"KMCP")
    with open(prefix + ".kmc_suf", "wb") as fh:
        fh.write(b"KMCS")
        fh.write(rec.tobytes())
        fh.write(b"KMCS")


def write_vcf(path, chrom, seq_len, variants):
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write(f"##contig=<ID={chrom},length={seq_len}>\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for pos, ref, alt in variants:
            fh.write(f"{chrom}\t{pos + 1}\t.\t{ref}\t{alt}\t.\t.\t.\n")


@dataclasses.dataclass
class Simulation:
    """What the generator made. `tables` holds each sample's (hi, lo,
    counts) as host numpy arrays, the raw counts that the KMC files hold,
    for the reference."""

    chrom: str
    seq: str
    variants: list
    families: list
    haps: list
    vcf_path: str
    prefixes: list
    tables: list


def seed_of(seed, *parts):
    """A 63-bit seed of (--seed, parts): independent streams per use."""
    ss = np.random.SeedSequence([int(seed) % (1 << 63)] + list(parts))
    return int(ss.generate_state(2, np.uint64)[0] >> np.uint64(1))


def simulate(tmp, seed, cfg, mix, device):
    """Write candidates.vcf and one KMC1 table per sample into tmp."""
    rng = np.random.default_rng(seed_of(seed, 0))
    k, num_samples = cfg["kmer_size"], cfg["samples"]
    scale = cfg["mix_scale"]
    if mix["kind"] == "bulk":
        seq, variants = make_bulk(rng, mix, scale, k)
        families = []
        haps = bulk_haplotypes(rng, variants, num_samples)
    elif mix["kind"] == "coupled":
        seq, variants, families = make_coupled(rng, mix, scale, k)
        haps = np.array([[coupled_haplotypes(rng, variants, families)
                          for _ in range(2)] for _ in range(num_samples)],
                        np.int8)
    else:
        raise ValueError(f"unknown mix kind {mix['kind']!r}")
    chrom = "chr1"
    vcf_path = os.path.join(tmp, "candidates.vcf")
    write_vcf(vcf_path, chrom, len(seq), variants)
    theta = cfg["count_variance_ratio"] - 1.0
    prefixes, tables = [], []
    for si in range(num_samples):
        hi, lo, mult = kmers.count(
            [apply_haplotype(seq, variants, h).encode() for h in haps[si]],
            k, device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed_of(seed, 1, si))
        shape = cfg["coverage"] * mult.double() / theta
        lam = torch._standard_gamma(shape, generator=gen) * theta
        counts = torch.poisson(lam, generator=gen).long().clamp(max=2**31 - 1)
        keep = counts > 0
        hi, lo, counts = hi[keep], lo[keep], counts[keep]
        prefix = os.path.join(tmp, f"sample{si}")
        write_kmc1(prefix, hi, lo, counts, k)
        prefixes.append(prefix)
        tables.append((hi.cpu().numpy(), lo.cpu().numpy(),
                       counts.to(torch.int32).cpu().numpy()))
        del hi, lo, mult, counts, lam, shape
    return Simulation(chrom, seq, variants, families, haps, vcf_path,
                      prefixes, tables)
