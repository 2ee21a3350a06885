"""The generator's k-mer tables against the host counting of the port, and
its seed semantics."""

import filecmp

import numpy as np
import pytest
import torch

from portbench import generator, kmers


def _host_counts(seqs, k):
    from bayestyper_tpu_torch.io.kmc import count_kmers_from_sequences

    return count_kmers_from_sequences(seqs, k)


def _sequences(seed, lengths):
    rng = np.random.default_rng(seed)
    return [generator._bases(rng, n).encode() for n in lengths]


@pytest.mark.parametrize("k", [55, 31])
def test_kmer_counts_equal_host_counting(k):
    seqs = _sequences(1, [4000, 2500, 60])
    seqs.append(seqs[0][1000:1800])       # repeated k-mers: multiplicity 2
    hi, lo, mult = kmers.count(seqs, k, "cpu")
    h_hi, h_lo, h_mult = _host_counts(seqs, k)
    assert np.array_equal(hi.numpy().astype(np.uint64), h_hi)
    assert np.array_equal(lo.numpy().astype(np.uint64), h_lo)
    assert np.array_equal(mult.numpy().astype(np.uint64), h_mult)
    assert mult.max() == 2


def test_kmc1_files_equal_port_writer(tmp_path):
    from bayestyper_tpu_torch.io.kmc import write_kmc1

    hi, lo, _ = kmers.count(_sequences(2, [3000, 3000]), 55, "cpu")
    counts = torch.randint(1, 1 << 20, (hi.numel(),),
                           generator=torch.Generator().manual_seed(3))
    generator.write_kmc1(str(tmp_path / "a"), hi, lo, counts, 55)
    write_kmc1(str(tmp_path / "b"), hi.numpy().astype(np.uint64),
               lo.numpy().astype(np.uint64), counts.numpy(), kmer_length=55)
    for ext in (".kmc_pre", ".kmc_suf"):
        assert filecmp.cmp(tmp_path / f"a{ext}", tmp_path / f"b{ext}",
                           shallow=False)


def test_tables_read_back_through_port_reader(tmp_path):
    """The port's own KMC reader decodes the benchmark's tables to the
    counts the generator drew."""
    from bayestyper_tpu_torch.io.kmc import KmcReader

    cfg = {"kmer_size": 55, "samples": 2, "mix_scale": 0.01,
           "coverage": 50.0, "count_variance_ratio": 2.0}
    mix = {"kind": "bulk", "kinds": {"snv": 200, "dense4": 20},
           "dup_block": 0}
    sim = generator.simulate(str(tmp_path), 2**40 + 1, cfg, mix, "cpu")
    hi, lo, counts = sim.tables[1]
    got_hi, got_lo, got_c = [], [], []
    reader = KmcReader(sim.prefixes[1])
    for b in reader.batches():
        got_hi.append(np.asarray(b[0]))
        got_lo.append(np.asarray(b[1]))
        got_c.append(np.asarray(b[2]))
    reader.close()
    assert np.array_equal(np.concatenate(got_hi).astype(np.int64), hi)
    assert np.array_equal(np.concatenate(got_lo).astype(np.int64), lo)
    assert np.array_equal(np.concatenate(got_c).astype(np.int64), counts)


def _sim(tmp_path, seed, kind="bulk", tag=""):
    cfg = {"kmer_size": 55, "samples": 3, "mix_scale": 0.01,
           "coverage": 50.0, "count_variance_ratio": 2.0}
    if kind == "bulk":
        mix = {"kind": "bulk", "dup_block": 0, "kinds": {
            "snv": 300, "indel": 100, "dense2": 50, "dense6": 20,
            "sv_del": 20, "sv_ins": 20}}
    else:
        mix = {"kind": "coupled", "dense_snvs": 8, "dense_spacing": 60,
               "kinds": {"contain": 200, "segdup": 50, "snv": 100}}
    d = tmp_path / f"{tag}{seed}"
    d.mkdir()
    return generator.simulate(str(d), seed, cfg, mix, "cpu")


@pytest.mark.parametrize("kind", ["bulk", "coupled"])
def test_same_seed_same_inputs(tmp_path, kind):
    a = _sim(tmp_path, 7, kind, "a")
    b = _sim(tmp_path, 7, kind, "b")
    assert a.seq == b.seq and a.variants == b.variants
    for ta, tb in zip(a.tables, b.tables):
        for x, y in zip(ta, tb):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("kind", ["bulk", "coupled"])
def test_every_seed_makes_the_same_sizes(tmp_path, kind):
    """Seeds shuffle the order, never the set of sizes: allele lengths and
    family sizes are the same multiset for any seed."""
    def sizes(sim):
        return sorted((len(r), len(a)) for _, r, a in sim.variants)

    a = _sim(tmp_path, 11, kind)
    b = _sim(tmp_path, 2**35 + 12, kind)
    assert a.seq != b.seq
    assert sizes(a) == sizes(b)
    assert len(a.seq) == len(b.seq)
    assert sorted(len(f[2]) for f in a.families) == \
        sorted(len(f[2]) for f in b.families)


def test_counts_follow_the_configured_distribution(tmp_path):
    """Counts of k-mers with two copies in the sample: mean 2 x 50,
    variance twice that."""
    sim = _sim(tmp_path, 5)
    seqs = [generator.apply_haplotype(sim.seq, sim.variants, h).encode()
            for h in sim.haps[0]]
    hi, lo, mult = kmers.count(seqs, 55, "cpu")
    t_hi, t_lo, t_c = (torch.from_numpy(x) for x in sim.tables[0])
    idx = kmers.lookup(t_hi, t_lo, hi, lo)
    c = torch.where(idx >= 0, t_c[idx.clamp(min=0)].long(),
                    torch.zeros_like(idx))[mult == 2].double()
    assert abs(float(c.mean()) - 100) < 1.0
    assert abs(float(c.var() / c.mean()) - 2.0) < 0.1


@pytest.mark.cuda
def test_generator_on_card_equals_cpu_counting(cuda_device):
    seqs = _sequences(4, [200_000, 150_000])
    hi, lo, mult = kmers.count(seqs, 55, cuda_device)
    c_hi, c_lo, c_mult = kmers.count(seqs, 55, "cpu")
    assert torch.equal(hi.cpu(), c_hi)
    assert torch.equal(lo.cpu(), c_lo)
    assert torch.equal(mult.cpu(), c_mult)
