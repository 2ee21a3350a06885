"""The plain reference against the port's plain CPU path on tiny units."""

import hashlib
import tempfile

import numpy as np
import pytest
import torch

from portbench import generator, kmers, reference, run
from portbench.conftest import TINY_CONFIG, TINY_MIX

SPEC = {"confident_nats": 10.0, "max_haplotypes": 65, "nb_kmers": 20000,
        "block_elements": 4096}
JUDGE = run.load_json(run.HERE, "judge.json")


def _sim(cell, seed=2**34 + 9):
    _, _, cfg, mix = run.specs(cell)
    cfg = dict(cfg, **TINY_CONFIG)
    mix = dict(mix, **TINY_MIX)
    return generator.simulate(tempfile.mkdtemp(), seed, cfg, mix, "cpu"), cfg


def _program_unit(sim, cfg):
    from bayestyper_tpu_torch import engine
    from bayestyper_tpu_torch.constants import GENDER_FEMALE
    from bayestyper_tpu_torch.io.fasta import Genome
    from bayestyper_tpu_torch.io.samples import ChromosomePloidy, Sample

    genome = Genome()
    genome.names = [sim.chrom]
    genome.sequences[sim.chrom] = sim.seq.encode()
    samples = [Sample(f"s{i}", GENDER_FEMALE, p)
               for i, p in enumerate(sim.prefixes)]
    unit = engine.run_cluster_phase(
        genome, samples, sim.vcf_path, ChromosomePloidy.human_default(),
        kmer_size=cfg["kmer_size"], max_parameter_kmers=1_000_000,
        num_threads=2)
    return unit, samples


def test_small_lanes_equal_device_lanes():
    rng = np.random.default_rng(3)
    seq = generator._bases(rng, 700).encode()
    hi, lo = reference.small_lanes(seq, 55)
    d_hi, d_lo = kmers.lanes(kmers.encode(seq, "cpu"), 55)
    assert np.array_equal(hi, d_hi.numpy()) and np.array_equal(lo,
                                                               d_lo.numpy())


@pytest.mark.parametrize("cell", ["r3-bulk-seq", "r3-coupled-seq"])
def test_groups_are_the_program_groups(cell):
    """The reference's variant groups, worked out again from the candidate
    VCF, are the variant sets of the port's cluster groups."""
    sim, cfg = _sim(cell)
    unit, _ = _program_unit(sim, cfg)
    where = {v[0]: i for i, v in enumerate(sim.variants)}
    program = {}
    for fc in unit.compiled:
        key = (fc.group_id if fc.group_id >= 0 else ("c", fc.cluster_id))
        program.setdefault(key, set()).update(
            where[v.pos - 1] if v.pos - 1 in where else where[v.pos]
            for v in fc.variants)
    ours = {frozenset(g) for g, _, _ in reference.variant_groups(
        sim.variants, cfg["kmer_size"], len(sim.seq))}
    assert ours == {frozenset(v) for v in program.values()}


def test_reference_nb_mean_agrees_with_the_port_fit():
    from bayestyper_tpu_torch import engine
    from bayestyper_tpu_torch.model.count_model import fit_genomic_nb

    sim, cfg = _sim("r3-bulk-seq")
    unit, samples = _program_unit(sim, cfg)
    table, counts = engine.gather_sample_counts(unit, samples, 2, "cpu")
    nb = fit_genomic_nb(engine.parameter_kmer_stats(unit, samples, table,
                                                    counts))
    judge = reference.Judge(sim, cfg["kmer_size"], 1, "cpu", SPEC)
    assert np.allclose(nb.mean, judge.mean, rtol=0.01)
    assert np.allclose(judge.ratio, 2.0, atol=0.1)


def test_judge_scores_planted_calls():
    """The likelihood's best calls read gap 0; one altered call reads a
    wide gap; a missing call counts as missed. Small blocks of groups give
    the same likelihoods as one block."""
    sim, cfg = _sim("r3-bulk-seq")
    judge = reference.Judge(sim, cfg["kmer_size"], 1, "cpu", SPEC)
    one_block = reference.Judge(sim, cfg["kmer_size"], 1, "cpu",
                                dict(SPEC, block_elements=1 << 30))
    for shape in judge.buckets:
        assert torch.allclose(judge.bucket_ll(shape)[0],
                              one_block.bucket_ll(shape)[0])
    best = judge.best_codes(len(sim.variants))
    nb = [judge.mean]
    v = judge.judge([best], nb)
    assert v["worst_gap_nats"] == 0.0 and v["missed_share"] == 0.0
    assert v["nb_mean_gap"] == 0.0
    assert v["calls"] == best.size and v["confident"] > 0.9 * best.size
    vi = judge.groups[0].members[0]
    altered = best.copy()
    altered[vi, 0] = reference.pair_code(1, 1) if best[vi, 0] == 0 else 0
    assert judge.judge([altered], nb)["worst_gap_nats"] > 50
    missing = best.copy()
    missing[vi, 0] = reference.NOCALL
    got = judge.judge([best, missing], nb)
    assert got["missed_share"] == pytest.approx(1 / got["confident"])
    off = [np.array(judge.mean) * 1.5]
    assert judge.judge([best], off)["nb_mean_gap"] == pytest.approx(0.5)


def test_calls_are_read_from_the_vcf(tmp_path):
    variants = [(99, "A", "C"), (199, "G", "T")]
    path = tmp_path / "x.vcf"
    path.write_text(
        "##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\t"
        "INFO\tFORMAT\ts0\ts1\n"
        "chr1\t100\t.\tA\tC\t.\t.\t.\tGT:GQ:GPP\t1/0:99:0,0.995,0.005\t"
        "./.:0:0.4,0.3,0.3\n"
        "chr1\t200\t.\tG\tT,*\t.\t.\t.\tGT:GQ\t2|1:99\t0/0:9\n")
    codes, gpp = reference.read_calls(str(path),
                                      variants + [(299, "C", "G")], 2)
    assert codes.tolist() == [
        [reference.pair_code(0, 1), reference.NOCALL],
        [reference.pair_code(1, reference.STAR), reference.pair_code(0, 0)],
        [reference.NOCALL, reference.NOCALL]]
    assert gpp[0, 0] == 0.995
    assert np.isnan(gpp[[0, 1, 1, 2, 2], [1, 0, 1, 0, 1]]).all()


def test_noise_rows_gap_counts_missing_and_extra_rows(tmp_path):
    path = tmp_path / "x_noise_parameters.txt"
    rows = ["Chain\tIteration\ts0"]
    rows += [f"{c}\t{t}\t0.001" for c in (1, 2) for t in range(4)]
    path.write_text("\n".join(rows + ["0\t0\t0.001", ""]))
    assert reference.noise_rows_gap(str(path), 2, 3) == 0
    assert reference.noise_rows_gap(str(path), 2, 5) == 4
    assert reference.noise_rows_gap(str(path), 3, 3) == 4
    assert reference.noise_rows_gap(str(path), 2, 2) == 2


def test_local_windows_judge_every_coupled_variant():
    """Groups too wide to enumerate (the 64-SNV family, families of 7-8
    SNVs) are judged in local windows, each SNV with its parent deletion:
    no variant of the coupled mix goes unjudged, and the likelihood's best
    calls read gap 0 in every window."""
    sim, cfg = _sim("r3-coupled-seq")
    judge = reference.Judge(sim, cfg["kmer_size"], 1, "cpu", SPEC)
    assert judge.unjudged == 0 and judge.windows >= 64
    local = [g for g in judge.groups if len(g.alleles) == 3]
    assert local and not any(g.single for g in local)
    best = judge.best_codes(len(sim.variants))
    v = judge.judge([best], [judge.mean])
    assert v["worst_gap_nats"] == 0.0 and v["missed_share"] == 0.0


def test_local_window_has_no_other_member():
    """A local window holds the k-mers over its SNV and no other SNV of
    the family; under the parent deletion it holds no k-mer at all."""
    seq = generator._bases(np.random.default_rng(5), 2000)
    k = 55
    dele = (100, seq[100:1501], seq[100])
    kids = [(300 + 60 * j, seq[300 + 60 * j], "A" if seq[300 + 60 * j] != "A"
             else "C") for j in range(5)]
    variants = [dele] + kids
    windows = reference.local_windows(variants, list(range(6)), k, len(seq))
    assert [w[0] for w in windows] == [[0, j] for j in range(1, 6)]
    for (members, a, b), (pos, _, _) in zip(windows, kids):
        assert (a, b) == (pos - k + 1, pos + k)
        haps = reference.haplotypes(variants, members, 65)
        assert haps == [[0, 0], [0, 1], [1, reference.STAR]]
        assert reference.apply(seq, a, b, variants, members, haps[2]) == b""
        alt = reference.apply(seq, a, b, variants, members, haps[1])
        assert len(alt) == b - a and alt != seq[a:b].encode()


def test_reference_noise_rates_match_the_port():
    """The reference's noise rates, from the groups the program's noise
    scan reads at the likelihood's best pairs, lie within a small factor
    of the program's on a tiny run; the prior draws do not."""
    from portbench.conftest import tiny_run

    _, checks = tiny_run()
    gap = {n: v for n, v, _ in checks}["noise_rate_gap"]
    assert 0.0 <= gap < 0.5


LARGE_SPEC = dict(SPEC, max_haplotypes=1025, block_elements=1 << 20)


def _custom_sim(directory, mix, samples=2, seed=2**36 + 3):
    cfg = {"kmer_size": 55, "samples": samples, "mix_scale": 1,
           "coverage": 50.0, "count_variance_ratio": 2.0}
    return generator.simulate(str(directory), seed, cfg, mix, "cpu")


def _brute_terms(c, m, mean, ratio):
    """log P(count | multiplicity) [..., S] written out per element: the
    negative binomial of mean * m, variance ratio times that; a Poisson of
    1e-3 at multiplicity 0."""
    mean = torch.tensor(mean, dtype=torch.float64)
    ratio = torch.tensor(ratio, dtype=torch.float64)
    m = m[..., None].double()
    mu = mean * m
    r = mu / (ratio - 1.0)
    nb = (torch.lgamma(c + r) - torch.lgamma(r) - torch.lgamma(c + 1)
          + r * torch.log(1.0 / ratio) + c * torch.log1p(-1.0 / ratio))
    po = -1e-3 + c * np.log(1e-3) - torch.lgamma(c + 1)
    return torch.where(m == 0, po, nb)


def _brute_pairs(judge, g, block=256):
    """LL [P, S], noise k-mers [P] and their counts [P, S] of every pair of
    a group, summed k-mer by k-mer over each pair's multiplicities."""
    h = len(g.alleles)
    occ = np.zeros((len(g.rows), h), np.int64)
    np.add.at(occ, g.hits, 1)
    occ, bg = torch.from_numpy(occ), torch.from_numpy(g.bg)
    c = judge.counts[torch.from_numpy(g.rows)]                    # [X, S]
    i, j = (torch.from_numpy(t) for t in np.triu_indices(h))
    ll, n0, c0 = [], [], []
    for p0 in range(0, len(i), block):
        mult = (2 * bg[:, None] + occ[:, i[p0:p0 + block]]
                + occ[:, j[p0:p0 + block]])                       # [X, Pb]
        ll.append(_brute_terms(c[:, None, :], mult, judge.mean,
                               judge.ratio).sum(0))
        zero = (mult == 0).double()
        n0.append(zero.sum(0))
        c0.append((zero[:, :, None] * c[:, None, :]).sum(0))
    return torch.cat(ll), torch.cat(n0), torch.cat(c0)


@pytest.mark.parametrize("family", ["dense8", "deletion_over_7"])
def test_large_group_sums_equal_brute_force(family, tmp_path):
    """Past 65 haplotypes the pairs' likelihoods and noise sums come from
    matrix products; they equal a per-pair sum over every k-mer within
    1e-9 relative: an 8-SNV family (H256) and a deletion over 7 SNVs
    (H129), at 2 samples."""
    if family == "dense8":
        mix = {"kind": "bulk", "kinds": {"dense8": 1, "snv": 20},
               "dup_block": 0}
    else:
        # 7 deletions over 1..7 SNVs; the dense family a deletion over 2
        mix = {"kind": "coupled", "kinds": {"contain": 7, "snv": 5},
               "dense_snvs": 2, "dense_spacing": 60,
               "lengths": {"contain": [600, 800]}}
    sim = _custom_sim(tmp_path, mix)
    judge = reference.Judge(sim, 55, 1, "cpu", LARGE_SPEC)
    large = [k for k in judge.buckets if k[0] > reference.SMALL_HAPLOTYPES]
    assert [k[:2] for k in large] == ([(256, 8)] if family == "dense8"
                                      else [(129, 8)])
    assert judge.unjudged == 0
    ll, _, _ = judge.bucket_ll(large[0])
    n0, c0 = judge._noise[large[0]]
    g = judge.groups[judge.buckets[large[0]][0]]
    b_ll, b_n0, b_c0 = _brute_pairs(judge, g)
    assert ll.shape == (1, len(b_ll), 2)
    assert torch.all((ll[0] - b_ll).abs() <= 1e-9 * b_ll.abs())
    assert torch.equal(n0[0], b_n0)
    assert torch.all((c0[0] - b_c0).abs() <= 1e-9 * b_c0.abs())
    best = judge.best_codes(len(sim.variants))
    got = judge.judge([best], [judge.mean])
    assert got["worst_gap_nats"] == 0.0 and got["unjudged_share"] == 0.0


def _judge_readings(cell, seed):
    """What the judge makes of a tiny unit of a cell with judge.json's
    reach: a sha256 of its groups (members, allele vectors, occurrences,
    background copies, rows, whether the noise scan reads it), buckets,
    windows and unjudged count; its NB fit and reference noise rates; its
    checks on the likelihood's best calls with every third variant of the
    first sample called as its group's worst pair."""
    sim, cfg = _sim(cell, seed)
    judge = reference.Judge(sim, cfg["kmer_size"], 1, "cpu", SPEC)
    digest = hashlib.sha256()
    for g in judge.groups:
        for a in (g.members, g.alleles, g.occ, g.bg, g.rows, [g.single]):
            digest.update(np.ascontiguousarray(a, np.int64).tobytes())
    digest.update(repr((sorted(judge.buckets.items()), judge.windows,
                        judge.unjudged)).encode())
    codes = judge.best_codes(len(sim.variants))
    for shape, gis in judge.buckets.items():
        ll, _, _ = judge.bucket_ll(shape)
        worst = ll[:, :, 0].argmin(1)                             # [G]
        pair = judge._pair_codes(shape)                           # [G, P, V]
        members = np.array([judge.groups[g].members for g in gis])
        for v in range(shape[1]):
            code = pair[torch.arange(len(gis)), worst, v].numpy()
            third = members[:, v] % 3 == 0
            codes[members[third, v], 0] = code[third]
    verdict = judge.judge([codes], [judge.mean])
    noise = judge.noise_rates(0.1, *JUDGE["noise_prior"])
    return {"digest": digest.hexdigest(),
            "counts": [verdict[k] for k in ("missed_share", "confident",
                                            "calls")],
            "floats": [verdict["worst_gap_nats"], *map(float, judge.mean),
                       *map(float, noise)]}


# _judge_readings of the judge as it stood before groups past 65
# haplotypes took matrix products, at seeds 0-2 of each cell
PARENT_READINGS = {
    "cap30-bulk-seq": [
        {"digest": "6cb0442e689d3206a32aa1419550540f"
                   "f6155cd8362616454aaa1611cfb1f586",
         "counts": [0.08284883720930232, 688, 688],
         "floats": [66902.3327778212, 49.92425, 50.021675, 50.01565, 49.998525,
                    0.0008774238834781083, 0.0009101665604805679,
                    0.0009401146939926671, 0.0008876264867743653]},
        {"digest": "6d865f501952f6079023c9ec782a8f06"
                   "117ff4ce9291ca29d6a249b596c5df43",
         "counts": [0.08284883720930232, 688, 688],
         "floats": [73929.04720401652, 49.92795, 49.981875, 49.937675,
                    50.064425, 0.0009026085386767758, 0.0009160864785635764,
                    0.0009090909090909091, 0.0009859988168014198]},
        {"digest": "287944b2e6f3379274ea122263ebb518"
                   "587028c7fe0a2adc0b849e5953647384",
         "counts": [0.08284883720930232, 688, 688],
         "floats": [67330.75457882872, 50.0461, 49.993475, 49.91955, 50.00805,
                    0.0009045680687471732, 0.0009094216078574028,
                    0.000859180341953776, 0.0009015506671474937]},
    ],
    "r3-bulk-joint": [
        {"digest": "6cb0442e689d3206a32aa1419550540f"
                   "f6155cd8362616454aaa1611cfb1f586",
         "counts": [0.08284883720930232, 688, 688],
         "floats": [66902.3327778212, 49.92425, 50.021675, 50.01565, 49.998525,
                    0.0008774238834781083, 0.0009101665604805679,
                    0.0009401146939926671, 0.0008876264867743653]},
        {"digest": "6d865f501952f6079023c9ec782a8f06"
                   "117ff4ce9291ca29d6a249b596c5df43",
         "counts": [0.08284883720930232, 688, 688],
         "floats": [73929.04720401652, 49.92795, 49.981875, 49.937675,
                    50.064425, 0.0009026085386767758, 0.0009160864785635764,
                    0.0009090909090909091, 0.0009859988168014198]},
        {"digest": "287944b2e6f3379274ea122263ebb518"
                   "587028c7fe0a2adc0b849e5953647384",
         "counts": [0.08284883720930232, 688, 688],
         "floats": [67330.75457882872, 50.0461, 49.993475, 49.91955, 50.00805,
                    0.0009045680687471732, 0.0009094216078574028,
                    0.000859180341953776, 0.0009015506671474937]},
    ],
    "r3-bulk-seq": [
        {"digest": "6cb0442e689d3206a32aa1419550540f"
                   "f6155cd8362616454aaa1611cfb1f586",
         "counts": [0.08284883720930232, 688, 688],
         "floats": [66902.3327778212, 49.92425, 50.021675, 50.01565, 49.998525,
                    0.0008774238834781083, 0.0009101665604805679,
                    0.0009401146939926671, 0.0008876264867743653]},
        {"digest": "6d865f501952f6079023c9ec782a8f06"
                   "117ff4ce9291ca29d6a249b596c5df43",
         "counts": [0.08284883720930232, 688, 688],
         "floats": [73929.04720401652, 49.92795, 49.981875, 49.937675,
                    50.064425, 0.0009026085386767758, 0.0009160864785635764,
                    0.0009090909090909091, 0.0009859988168014198]},
        {"digest": "287944b2e6f3379274ea122263ebb518"
                   "587028c7fe0a2adc0b849e5953647384",
         "counts": [0.08284883720930232, 688, 688],
         "floats": [67330.75457882872, 50.0461, 49.993475, 49.91955, 50.00805,
                    0.0009045680687471732, 0.0009094216078574028,
                    0.000859180341953776, 0.0009015506671474937]},
    ],
    "r3-coupled-seq": [
        {"digest": "60c02ab9e9a3d596b5d944b9ac2d89d0"
                   "5521e60ec378a8e711fe148853229e4d",
         "counts": [0.047619047619047616, 588, 588],
         "floats": [1501552.6738721996, 50.06614952357684, 50.09125335939409,
                    49.90068409479599, 49.98870021988761, 0.00819672131147541,
                    0.00819672131147541, 0.00819672131147541,
                    0.008583690987124463]},
        {"digest": "2a0522725eb8477f2c042f340da6676e"
                   "268594d1334a445bf4da6cad1abc83f3",
         "counts": [0.047619047619047616, 588, 588],
         "floats": [1498667.3832750765, 49.96610065966284, 49.99609088688004,
                    49.98387490838016, 49.9198021011483, 0.00784313725490196,
                    0.007518796992481203, 0.009009009009009009,
                    0.007220216606498195]},
        {"digest": "803d753eaf41848935a02ab247ecd39a"
                   "53a9875594a50d61f5b604e0d778fb08",
         "counts": [0.047619047619047616, 588, 588],
         "floats": [3210139.9847502676, 50.000732958709996, 49.98326410945517,
                    49.96408502321036, 50.14500366479355, 0.007220216606498195,
                    0.008583690987124463, 0.00784313725490196,
                    0.007220216606498195]},
    ],
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cell", sorted(PARENT_READINGS))
def test_small_groups_keep_the_gather_path(cell, seed):
    """Within judge.json's reach of 65 haplotypes the judge builds the
    groups and buckets that it built before, byte for byte, and reads the
    same checks, NB fit and noise rates (the floats to 1e-12, as libm may
    differ between hosts) on the same calls: every existing cell's
    verdicts stay as they were. In these units no group passes 65."""
    got = _judge_readings(cell, seed)
    want = PARENT_READINGS[cell][seed]
    assert got["digest"] == want["digest"]
    assert got["counts"] == want["counts"]
    assert got["floats"] == pytest.approx(want["floats"], rel=1e-12)
