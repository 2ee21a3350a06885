"""The plain reference against the port's plain CPU path on tiny units."""

import tempfile

import numpy as np
import pytest
import torch

from portbench import generator, kmers, reference, run
from portbench.conftest import TINY_CONFIG, TINY_MIX

SPEC = {"confident_nats": 10.0, "max_haplotypes": 65, "nb_kmers": 20000,
        "block_elements": 4096}


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
