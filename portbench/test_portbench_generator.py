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


# sha256 over (name, sha256) of every file simulate() writes (candidates.vcf,
# each sample's .kmc_pre and .kmc_suf), the r3 configuration at scale 1 and
# 2 samples, from the generator as it stood before mixes could state their
# SV lengths
INPUT_SHA256 = {
    ("bulk", 0): "2812c29347c1dda23dfaba2e1edd239b3a89960b95a6063d73491f88eb4bcffa",
    ("bulk", 1): "0cf69091c000eb770fd4f6a6745581f8446c028c19e70ab4d5f5fbec7fd382f9",
    ("bulk", 2): "f69c535589ebb67a75132d9f1797d669e8361aca6c5aa3375edcbdfcba6b5f71",
    ("bulk-joint", 0): "2812c29347c1dda23dfaba2e1edd239b3a89960b95a6063d73491f88eb4bcffa",
    ("bulk-joint", 1): "0cf69091c000eb770fd4f6a6745581f8446c028c19e70ab4d5f5fbec7fd382f9",
    ("bulk-joint", 2): "f69c535589ebb67a75132d9f1797d669e8361aca6c5aa3375edcbdfcba6b5f71",
    ("coupled", 0): "f73a77097872f2bae62fe45202d592069c917ea463dc47995de17c0fb3113da1",
    ("coupled", 1): "61f887874604c038c78ea7f7f67a8338ad544492b9c766df5ea3d0f76e5e22b9",
    ("coupled", 2): "e0879722088fc0f8c5edf98bd60a48d7cdc43ad83fe9229e75b70cdee4841315",
}


def _digest(directory):
    import hashlib
    import os

    h = hashlib.sha256()
    for name in sorted(os.listdir(directory)):
        h.update(name.encode())
        with open(os.path.join(directory, name), "rb") as fh:
            h.update(hashlib.sha256(fh.read()).digest())
    return h.hexdigest()


@pytest.mark.parametrize("mix,seed", sorted(INPUT_SHA256))
def test_inputs_are_byte_identical(tmp_path, mix, seed):
    """A mix that states no lengths makes the inputs it made before mixes
    could state them, byte for byte."""
    from portbench import run

    _, _, cfg, spec = run.specs({"bulk": "r3-bulk-seq",
                                 "bulk-joint": "r3-bulk-joint",
                                 "coupled": "r3-coupled-seq"}[mix])
    generator.simulate(str(tmp_path), seed,
                       dict(cfg, mix_scale=1, samples=2), spec, "cpu")
    assert _digest(tmp_path) == INPUT_SHA256[(mix, seed)]


@pytest.mark.parametrize("kind", ["bulk", "coupled"])
def test_stated_lengths_bound_the_svs(tmp_path, kind):
    """A mix's "lengths" set the range its SVs are spread over, end to
    end; a length it may not state is refused."""
    cfg = {"kmer_size": 55, "samples": 1, "mix_scale": 1,
           "coverage": 50.0, "count_variance_ratio": 2.0}
    if kind == "bulk":
        mix = {"kind": "bulk", "dup_block": 0,
               "kinds": {"snv": 20, "sv_del": 9, "sv_ins": 7},
               "lengths": {"sv_del": [2000, 9000], "sv_ins": [300, 500]}}
    else:
        mix = {"kind": "coupled", "dense_snvs": 2, "dense_spacing": 60,
               "kinds": {"contain": 8, "snv": 10},
               "lengths": {"contain": [5000, 12000]}}
    sim = generator.simulate(str(tmp_path), 2**37 + 1, cfg, mix, "cpu")
    dels = sorted(len(r) - 1 for _, r, a in sim.variants if len(r) > 100)
    ins = sorted(len(a) - 1 for _, r, a in sim.variants if len(a) > 100)
    if kind == "bulk":
        assert dels[0] == 2000 and dels[-1] == 9000 and len(dels) == 9
        assert ins[0] == 300 and ins[-1] == 500 and len(ins) == 7
    else:
        # the dense family's deletion is 200 + 60 bp long
        assert dels[:1] == [260] and dels[1] == 5000 and dels[-1] == 12000
        assert len(dels) == 9 and not ins
    with pytest.raises(ValueError):
        generator.simulate(str(tmp_path), 1, cfg,
                           dict(mix, lengths={"snv": [1, 2]}), "cpu")
