"""Faults planted in the program underneath a run, for the tests and for
readings.py: each must turn `correct` false. The benchmark's runs never
plant them.

  * unchanged: the Gibbs step returns its state unchanged (every chain
    keeps its frequencies and its first outcome). It is planted in the
    plain version of the step, so it acts on a CPU run only;
  * half: half of the batch left out: the count gather loses every other
    k-mer's counts (they read 0), and the NB fit and the calls take their
    means over all as if they were there;
  * altered: an answer altered where it is produced: the first rendered
    row of every VCF gets another genotype in its first sample;
  * altered_gpp: a posterior altered where it is produced: every row of
    every VCF gets the posteriors (GPP) 0.5 in its first sample, its
    genotype kept;
  * skip_noise: the noise scan returns its prior draws: every chain keeps
    its initial rates through every iteration, and the unit's rates are
    their mean (a sequential cell's noise scan; the joint scan is the
    genotyping's own).

The exchange between cards has no place in a one-card cell.
"""

import contextlib


@contextlib.contextmanager
def _patched(obj, name, value):
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield real
    finally:
        setattr(obj, name, real)


@contextlib.contextmanager
def unchanged():
    import torch

    from bayestyper_tpu_torch.kernels import reference as plain

    def step(keys, freqs, ll, *args, **kwargs):
        return freqs, torch.zeros(ll.shape[:-1], dtype=torch.int32,
                                  device=ll.device)

    with _patched(plain, "gibbs_step", step):
        yield


@contextlib.contextmanager
def half():
    from bayestyper_tpu_torch import engine

    real = engine.gather_sample_counts

    def gather(*args, **kwargs):
        table, counts = real(*args, **kwargs)
        counts = counts.copy()
        counts[::2] = 0
        return table, counts

    with _patched(engine, "gather_sample_counts", gather):
        yield


@contextlib.contextmanager
def altered():
    from bayestyper_tpu_torch.writer import GenotypeVcfWriter

    real = GenotypeVcfWriter.add_line
    done = []

    def add_line(self, chrom, pos, line):
        if not self.num_written:
            f = line.decode().split("\t")
            gt, rest = f[9].split(":", 1)
            f[9] = ("1/1" if gt in ("0/0", "0|0") else "0/0") + ":" + rest
            line = "\t".join(f).encode()
            done.append((self.path, pos))
        return real(self, chrom, pos, line)

    with _patched(GenotypeVcfWriter, "add_line", add_line):
        yield done


@contextlib.contextmanager
def altered_gpp():
    from bayestyper_tpu_torch.writer import GenotypeVcfWriter

    real = GenotypeVcfWriter.add_line
    done = []

    def add_line(self, chrom, pos, line):
        f = line.decode().split("\t")
        keys, field = f[8].split(":"), f[9].split(":")
        at = keys.index("GPP")
        field[at] = ",".join("0.5" for _ in field[at].split(","))
        f[9] = ":".join(field)
        done.append((self.path, pos))
        return real(self, chrom, pos, "\t".join(f).encode())

    with _patched(GenotypeVcfWriter, "add_line", add_line):
        yield done


@contextlib.contextmanager
def skip_noise():
    import numpy as np

    from bayestyper_tpu_torch import engine

    def estimate(unit, samples, table, counts, ploidy_model, nb_params, opts,
                 device=None, **kwargs):
        init = engine._prior_rates(opts, len(samples),
                                   engine.resolve_device(device)).cpu().numpy()
        traces = np.repeat(init[:, None, :],
                           1 + opts.burn_in + opts.num_samples, axis=1)
        return init.mean(axis=0), traces

    with _patched(engine, "estimate_noise", estimate):
        yield


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered,
          "altered_gpp": altered_gpp, "skip_noise": skip_noise}
