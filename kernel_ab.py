"""Time and fingerprint the genotype path's kernels of one tree of this
repository on one CUDA card, to compare two trees (a parent commit and a
change) on the same card.

    python3 kernel_ab.py --tree PATH --out RESULT.json [--seed 0] [--scale 2]

PATH is a checkout of the repository (the current one by default); the
script imports that tree's bayestyper_tpu_torch and chip_smoke, so its
kernels build into PATH/.torch_ext_build. On chip_smoke.py's simulated
units it records, per size class of the main unit and of the wide unit
(30 samples) on the class's first chunk:

  * gibbs_sweep: the 350-iteration scan (burn-in 100) from the path's
    inputs, and the same scan in two windows (0-60, 60-350), with the
    sha256 of its frequencies, tally and last drawn outcomes;
  * noise_step at t = 7 and joint_step at t = 200 (burn-in 100) from the
    class's noise terms: the sha256 of frequencies, drawn outcomes, int32
    statistics (and tally);
  * ll_noise_terms, genotype form (LL) and noise form (LL, A, B, C0): the
    sha256 of each, the largest |LL - plain| and the CUDA-event median of
    each form (also at chip_smoke.BEYOND_LL's H256 x 30 and H4096 x 2
    samples, on inputs drawn on the card from the seed);
  * subsample_masks: the sha256 of the masks and their time, with the
    path's host keys and with key words converted beforehand;
  * bucket_stats from the scan's tally, packed and unpacked: the sha256 of
    each form's outputs, of the integer outputs of both forms and of the
    float outputs of both, and the time of each form;

each with its CUDA-event median time (3 runs after a warm-up; noise_step
and joint_step per launch of 10 back to back; masks and stats 5 runs); the
coupled unit's nested_sweep over all 350 iterations (sha256 of every
level's tally, frequencies and MAC accumulator, and its time; the deepest
group alone, and its time per chain step); bucket_stats' rows for the
coupled unit's first call with missing and mac_extra (recorded during its
genotype_unit), for an H64 chunk of 20,000 k-mer slots, and for H256,
H512, H2048 and H4096 x 2 samples on inputs
drawn on the card (a tree whose time, extrapolated from H256 -> H512 as a
power of O, passes BEYOND_STATS_LIMIT_S at H2048 or H4096 reports the case
as "skipped (O² selection)" and does not run it); kmer_cap's masks
(sha256) and time on the coupled unit's capped level with the most k-mer
slots, and on the wide unit's K32768 class at its own cap, at cap 2 and at
subsampling rate 1.0; the rate update as a scan's 350 launches back to
back (after the scan's draws where the tree has them: its time per
launch, the whole scan's rate work, the sha256 of the rates and trace of
a 350-iteration run from statistics drawn from the seed); and the sha256
of the VCFs that genotype_unit and genotype_unit_joint write for the main,
coupled and wide units, with their phase seconds. Run parent, change,
change, parent one after another on one card (each in its own process:
the two trees' extensions share a name) and compare: equal fingerprints
mean the same bits, and the two runs of one tree give the run-to-run
spread of the times.
"""

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time


# launches per timing of the per-iteration kernels
REPS = 10


def sha(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def device_ms(fn, name, reps=3):
    """Device time in ms per launch of the kernels whose name holds `name`
    over reps calls of fn() after a warm-up call, from torch.profiler's CUDA
    activity; None where it recorded none. (chip_smoke.device_ms, kept here
    too: a parent tree's chip_smoke may not have it.)"""
    import torch
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


def file_sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def class_rows(cs, unit, samples, ploidy, opts, dev, label):
    """The Gibbs kernels on the first chunk of every size class of unit."""
    import numpy as np
    import torch

    from bayestyper_tpu_torch import engine, kernels
    from bayestyper_tpu_torch.model import gibbs
    from bayestyper_tpu_torch.model.buckets import stack_buckets
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
    singles = list(unit.compiled)
    plan = engine._plan_unit(singles, engine._class_map(singles), opts,
                             samples, None)
    tables = tables_from_numpy(np_build_count_log_prob_tables(
        nb.p, nb.size, np.full(len(samples), 1e-3), 255), dev)
    opts_filters = FilterConfig.from_model(
        nb.mean, opts.min_genotype_posterior, opts.min_number_of_kmers,
        opts.disable_observed_kmers)
    rows = []
    for key_cls in sorted(plan):
        pc = plan[key_cls]
        cfg = pc.cfg
        ch = cfg.num_chains
        bucket = engine._bucket_cached(
            None, pc.chunks[0], (pc.c_pad, pc.k, pc.h, pc.v), samples,
            ploidy, ucounts, opts.random_seed, dev)
        c = bucket.mult.shape[0]
        s = bucket.counts.shape[2]
        osp = gibbs.outcome_tensors(pc.h, dev)
        o = osp.oa.shape[0]
        n = c * ch
        ks = prng.split(prng.prng_key(opts.random_seed), 2)
        sub_base, fold = gibbs._chain_base(ks[0], ch)
        chain_base, _ = gibbs._chain_base(ks[1], ch)
        # the kernels' key words, converted once as the engine does
        chain_base = kernels.key_words(chain_base, dev)
        fold = kernels.key_words(fold, dev)
        w = kernels.subsample_masks(sub_base, fold, bucket.cluster_id,
                                    bucket.kmer_valid,
                                    cfg.kmer_subsampling_rate,
                                    gibbs._SUBSAMPLE_SALT)
        mmax = min(cfg.max_total_mult, tables.shape[1] - 1)
        ll_args = (bucket.mult, bucket.inter_mult, bucket.counts, w, tables,
                   mmax, osp.oa32, osp.ob32)
        ll, _ = kernels.ll_noise_terms(*ll_args, include_noise_row=True)
        llg, (a_t, b_t, c0_t) = kernels.ll_noise_terms(
            *ll_args, include_noise_row=False, noise_terms=True)
        ll_row = ll_rows(cs, ll_args, (ll,), (llg, a_t, b_t, c0_t))
        c0_t[..., -1] = 0.0
        ll_n = ll.reshape(n, s, o)
        llg_n = (llg - c0_t).reshape(n, s, o)
        a_n, b_n = a_t.reshape(n, s, o), b_t.reshape(n, s, o)
        del ll, llg, a_t, b_t, c0_t
        fields = gibbs._cluster_fields(stack_buckets([bucket]))
        freqs0 = gibbs._freqs0(stack_buckets([bucket]), ch).reshape(n, pc.h)
        cv = bucket.cluster_valid.to(torch.float32)
        rates = torch.full((ch, s), 2e-3, device=dev)
        log_r = torch.log(rates)
        iters, burn_in = cfg.burn_in + cfg.num_samples, cfg.burn_in
        tag = f"{label} H{pc.h}/K{pc.k}/C{c}"
        zeros = lambda: torch.zeros((ch, s), dtype=torch.int32, device=dev)  # noqa: E731

        def sweep(windows):
            f = freqs0.clone()
            tally = torch.zeros((n, s, o), dtype=torch.int32, device=dev)
            for t0, t1 in windows:
                _, _, osel = kernels.gibbs_sweep(
                    ll_n, *fields, chain_base, fold, f, t0, t1, burn_in, osp,
                    tally)
            return f, tally, osel

        def nstep():
            cs, no = zeros(), zeros()
            f, osel = kernels.noise_step(llg_n, a_n, b_n, cv, log_r, rates,
                                         *fields, chain_base, fold,
                                         freqs0.clone(), 7, osp, cs, no)
            return f, osel, cs, no

        def jstep(tally):
            cs, no = zeros(), zeros()
            f, osel = kernels.joint_step(llg_n, a_n, b_n, cv, log_r, rates,
                                         *fields, chain_base, fold,
                                         freqs0.clone(), 200, osp, cs, no,
                                         tally, burn_in)
            return f, osel, cs, no, tally

        new_tally = lambda: torch.zeros((n, s, o), dtype=torch.int32,  # noqa: E731
                                        device=dev)
        swept = sweep([(0, iters)])
        mask_args = (sub_base, fold, bucket.cluster_id, bucket.kmer_valid,
                     cfg.kmer_subsampling_rate, gibbs._SUBSAMPLE_SALT)
        # the same with the key words converted beforehand: the launch alone
        mask_words = (kernels.key_words(sub_base, dev),) + mask_args[1:]
        st_args = (bucket.mult, bucket.inter_mult, bucket.counts,
                   bucket.member, bucket.hap_allele, bucket.num_alleles,
                   bucket.ploidy, swept[1].reshape(c, ch, s, o), w, osp.oa32,
                   osp.ob32, pc.a, o if o <= 64 else 8,
                   opts_filters.min_genotype_posterior,
                   opts_filters.min_number_of_kmers,
                   torch.tensor(opts_filters.min_fraction_observed_kmers,
                                dtype=torch.float32))
        row = {
            "class": tag, "pairs": n, "s": s, "o": o, "h": pc.h,
            "iters": iters, **ll_row,
            "sweep_sha": sha(*swept),
            "sweep_windows_sha": sha(*sweep([(0, 60), (60, iters)])),
            "noise_sha": sha(*nstep()),
            "joint_sha": sha(*jstep(new_tally())),
            "masks_sha": sha(kernels.subsample_masks(*mask_args)),
            "masks_ms": cs.cuda_ms(
                lambda: kernels.subsample_masks(*mask_args), 5),
            "masks_kernel_ms": cs.cuda_ms(
                lambda: kernels.subsample_masks(*mask_words), 5),
            **stats_fields(cs, st_args),
        }
        del swept
        kernels.reset_launch_counts()
        sweep([(0, iters)])
        row["layouts"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
        row["sweep_ms"] = cs.cuda_ms(lambda: sweep([(0, iters)]), 3)
        # the per-iteration kernels: REPS launches back to back on one state
        f, cs_, no, tally = freqs0.clone(), zeros(), zeros(), new_tally()

        def reps(name, *extra):
            fn = getattr(kernels, name)
            for _ in range(REPS):
                fn(llg_n, a_n, b_n, cv, log_r, rates, *fields, chain_base,
                   fold, f, 200, osp, cs_, no, *extra)

        row["noise_ms"] = cs.cuda_ms(lambda: reps("noise_step"), 3) / REPS
        row["joint_ms"] = cs.cuda_ms(
            lambda: reps("joint_step", tally, burn_in), 3) / REPS
        cs.log(f"  {tag}: ll_noise_terms {row['ll_ms']:.4f} / noise form "
               f"{row['llnoise_ms']:.4f} ms, |LL - plain| <= "
               f"{row['ll_err']:.3g}; ll {row['ll_sha'][:12]} noise "
               f"{row['llnoise_sha'][:12]}")
        cs.log(f"  {tag}: subsample_masks {row['masks_ms']:.4f} ms (launch "
               f"alone {row['masks_kernel_ms']:.4f} ms) "
               f"{row['masks_sha'][:12]}; bucket_stats {row['stats_ms']:.4f} "
               f"/ unpacked {row['stats_unpacked_ms']:.4f} ms, integer "
               f"{row['stats_int_sha'][:12]} float "
               f"{row['stats_float_sha'][:12]}")
        cs.log(f"  {tag} ({n} pairs): sweep {row['sweep_ms']:.3f} ms, "
               f"noise {row['noise_ms']:.4f} ms, joint {row['joint_ms']:.4f} "
               f"ms; sweep {row['sweep_sha'][:12]} windows "
               f"{row['sweep_windows_sha'][:12]} noise "
               f"{row['noise_sha'][:12]} joint {row['joint_sha'][:12]}")
        rows.append(row)
        del bucket, ll_n, llg_n, a_n, b_n
        torch.cuda.empty_cache()
    return rows


def stats_fields(cs, st_args, **kw):
    """bucket_stats on one chunk in the packed and the unpacked form: the
    sha256 of the integer outputs of both forms (tallies, denominators, GT,
    SAF), of the float outputs (packed NAK/FAK/MAC, unpacked GPP/APP/GQ/
    NAK/FAK/MAC) and of all, and the CUDA-event median of each form."""
    from bayestyper_tpu_torch import kernels

    outs = [kernels.bucket_stats(*st_args, packed, **kw)
            for packed in (True, False)]
    flat = outs[0] + outs[1]
    return {
        "stats_sha": sha(*outs[0]), "stats_unpacked_sha": sha(*outs[1]),
        "stats_int_sha": sha(*(x for x in flat
                               if not x.dtype.is_floating_point)),
        "stats_float_sha": sha(*(x for x in flat
                                 if x.dtype.is_floating_point)),
        "stats_ms": cs.cuda_ms(
            lambda: kernels.bucket_stats(*st_args, True, **kw), 5),
        "stats_unpacked_ms": cs.cuda_ms(
            lambda: kernels.bucket_stats(*st_args, False, **kw), 5),
    }


# bucket_stats past the units' classes: (H, samples, clusters, k-mer slots,
# chains) of chip_smoke.BEYOND_LL's second entry at H256-H4096, two
# variants of three alleles; a later case runs where the tree's time at the
# second, scaled by the power of O that the first two showed, stays under
# BEYOND_STATS_LIMIT_S
BEYOND_STATS_H = (256, 512, 2048, 4096)
# seconds of one call (a row makes 14)
BEYOND_STATS_LIMIT_S = 5.0


def beyond_stats_rows(cs, dev, seed):
    """bucket_stats at BEYOND_STATS_H on inputs drawn on the card from the
    seed as chip_smoke.check_beyond_unit draws them; a case whose
    extrapolated time passes the limit is reported as skipped."""
    import math

    import torch

    from bayestyper_tpu_torch.model import gibbs

    _, s, c, k, ch = cs.BEYOND_LL[1]
    v, a_cap = 2, 3
    rows, times = [], {}
    for h in BEYOND_STATS_H:
        o = h * (h + 1) // 2 + h + 1
        row = {"class": f"H{h}/K{k}/C{c} x{s} samples", "o": o}
        if len(times) == 2:
            (o1, t1), (o2, t2) = sorted(times.items())
            e = math.log(t2 / t1) / math.log(o2 / o1)
            row["exponent"] = e
            row["extrapolated_ms"] = t2 * (o / o2) ** e
            if row["extrapolated_ms"] > 1e3 * BEYOND_STATS_LIMIT_S:
                row["skipped"] = "skipped (O² selection)"
                cs.log(f"  bucket_stats {row['class']}: skipped (O² "
                       f"selection): {row['extrapolated_ms']:.0f} ms "
                       f"extrapolated as O^{e:.2f}")
                rows.append(row)
                continue
        gen = torch.Generator(device=dev).manual_seed(seed + h)
        bucket, tally = cs.random_chunk(gen, dev, c, k, h, v, s, ch, a_cap)
        osp = gibbs.outcome_tensors(h, dev)
        w = torch.rand((c, ch, k), generator=gen, device=dev) < 0.5
        st_args = (bucket.mult, bucket.inter_mult, bucket.counts,
                   bucket.member, bucket.hap_allele, bucket.num_alleles,
                   bucket.ploidy, tally, w, osp.oa32, osp.ob32, a_cap, 8,
                   0.99, 1.0, torch.tensor([0.9, 0.5]))
        row.update(stats_fields(cs, st_args))
        if len(times) < 2:
            times[o] = row["stats_ms"]
        cs.log(f"  bucket_stats {row['class']}: {row['stats_ms']:.3f} / "
               f"unpacked {row['stats_unpacked_ms']:.3f} ms, integer "
               f"{row['stats_int_sha'][:12]} float "
               f"{row['stats_float_sha'][:12]}")
        rows.append(row)
        del bucket, tally, w, st_args
        torch.cuda.empty_cache()
    return rows


def wide_k_stats_row(cs, dev, seed):
    """bucket_stats on chip_smoke.check_beyond_unit's H64 chunk of 20,000
    k-mer slots (2 clusters, 2 variants, 3 samples, 3 chains), drawn on
    the card from the seed."""
    import torch

    from bayestyper_tpu_torch.model import gibbs

    c, k, h, v, s, ch, a_cap = 2, 20000, 64, 2, 3, 3, 4
    gen = torch.Generator(device=dev).manual_seed(seed)
    bucket, tally = cs.random_chunk(gen, dev, c, k, h, v, s, ch, a_cap)
    osp = gibbs.outcome_tensors(h, dev)
    w = torch.rand((c, ch, k), generator=gen, device=dev) < 0.5
    st_args = (bucket.mult, bucket.inter_mult, bucket.counts, bucket.member,
               bucket.hap_allele, bucket.num_alleles, bucket.ploidy, tally,
               w, osp.oa32, osp.ob32, a_cap, 8, 0.99, 1.0,
               torch.tensor([0.9, 0.5, 0.2]))
    row = {"class": f"H{h}/K{k}/C{c} x{s} samples",
           **stats_fields(cs, st_args)}
    cs.log(f"  bucket_stats {row['class']}: {row['stats_ms']:.3f} / unpacked "
           f"{row['stats_unpacked_ms']:.3f} ms, integer "
           f"{row['stats_int_sha'][:12]} float {row['stats_float_sha'][:12]}")
    return row


@contextlib.contextmanager
def coupled_stats_call(calls):
    """Record into calls a copy of the arguments of the first
    kernels.bucket_stats call made with the coupled path's missing and
    mac_extra inputs (all but the form; missing and mac_extra by name)."""
    import torch

    from bayestyper_tpu_torch import kernels

    real = kernels.bucket_stats
    copy = lambda x: x.clone() if torch.is_tensor(x) else (  # noqa: E731
        tuple(map(copy, x)) if isinstance(x, tuple) else x)

    def recording(*args, **kw):
        extra = dict(zip(("missing", "mac_extra"), args[17:]), **kw)
        if not calls and all(extra.get(nm) is not None
                              for nm in ("missing", "mac_extra")):
            calls.append((copy(args[:16]),
                          {nm: copy(x) for nm, x in extra.items()}))
        return real(*args, **kw)

    kernels.bucket_stats = recording
    try:
        yield calls
    finally:
        kernels.bucket_stats = real


def coupled_stats_row(cs, calls):
    """stats_fields of the coupled unit's recorded bucket_stats call (both
    forms, whichever the path ran)."""
    if not calls:
        raise RuntimeError("the coupled unit made no bucket_stats call with "
                           "missing and mac_extra")
    args, kw = calls[0]
    o = args[7].shape[3]
    row = {"class": f"coupled H{args[0].shape[2]}/K{args[0].shape[1]}/"
                    f"C{args[0].shape[0]} (missing, mac_extra)", "o": o,
           **stats_fields(cs, args, **kw)}
    cs.log(f"  bucket_stats {row['class']}: {row['stats_ms']:.4f} / unpacked "
           f"{row['stats_unpacked_ms']:.4f} ms, integer "
           f"{row['stats_int_sha'][:12]} float "
           f"{row['stats_float_sha'][:12]}")
    return row


def ll_rows(cs, ll_args, ll_out, noise_out):
    """ll_noise_terms' fingerprints, its largest |LL - plain| over both
    forms and the time of each form, from the outputs of one call each."""
    from bayestyper_tpu_torch import kernels

    plain = kernels.PLAIN["ll_noise_terms"]
    err = 0.0
    for kw, got in ((dict(include_noise_row=True), ll_out[0]),
                    (dict(include_noise_row=False, noise_terms=True),
                     noise_out[0])):
        want, _ = plain(*ll_args, **kw)
        err = max(err, float((got - want).abs().max()))
        del want
    return {
        "ll_sha": sha(*ll_out), "llnoise_sha": sha(*noise_out),
        "ll_err": err,
        "ll_ms": cs.cuda_ms(lambda: kernels.ll_noise_terms(*ll_args), 5),
        "llnoise_ms": cs.cuda_ms(lambda: kernels.ll_noise_terms(
            *ll_args, include_noise_row=False, noise_terms=True), 5),
    }


def beyond_ll_rows(cs, dev, seed):
    """ll_noise_terms at chip_smoke.BEYOND_LL's shapes, on inputs drawn on
    the card from the seed as chip_smoke.check_beyond_unit draws them."""
    import numpy as np
    import torch

    from bayestyper_tpu_torch import kernels
    from bayestyper_tpu_torch.model import gibbs
    from bayestyper_tpu_torch.ops.distributions import (
        np_build_count_log_prob_tables)

    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for h, s, c, k, ch in cs.BEYOND_LL:
        bucket, _ = cs.random_chunk(gen, dev, c, k, h, 1, s, ch, 2)
        w = torch.rand((c, ch, k), generator=gen, device=dev) < 0.5
        osp = gibbs.outcome_tensors(h, dev)
        mmax = 16
        tables = torch.from_numpy(np_build_count_log_prob_tables(
            np.full(s, 0.4), np.full(s, 6.0), np.full(s, 1e-3), mmax)
            .astype(np.float32)).to(dev)
        args = (bucket.mult, bucket.inter_mult, bucket.counts, w, tables,
                mmax, osp.oa32, osp.ob32)
        ll, _ = kernels.ll_noise_terms(*args, include_noise_row=True)
        llg, abc = kernels.ll_noise_terms(*args, include_noise_row=False,
                                          noise_terms=True)
        row = {"class": f"H{h}/K{k}/C{c} x{s} samples",
               **ll_rows(cs, args, (ll,), (llg,) + tuple(abc))}
        cs.log(f"  {row['class']}: ll_noise_terms {row['ll_ms']:.3f} / noise "
               f"form {row['llnoise_ms']:.3f} ms, |LL - plain| <= "
               f"{row['ll_err']:.3g}; ll {row['ll_sha'][:12]} noise "
               f"{row['llnoise_sha'][:12]}")
        rows.append(row)
        del bucket, w, args, ll, llg, abc
        torch.cuda.empty_cache()
    return rows


def nested_row(cs, unit, samples, ploidy, opts, dev):
    """nested_sweep over all iterations of the coupled unit's levels."""
    import numpy as np

    from bayestyper_tpu_torch import engine
    from bayestyper_tpu_torch.model import gibbs
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
    nested = [fc for fc in unit.compiled if engine._is_coupled(fc)]
    ni = engine._nested_inputs(nested, samples, ploidy, ucounts, opts, dev)
    args, kwargs = ni.genotype_args(prng.prng_key(opts.random_seed), tables)
    setup = gibbs.nested_setup(*args, **kwargs)
    run = setup.clone()
    run.run()
    parts = []
    for lv in run.levels:
        parts += [lv.tally, lv.freqs]
        if lv.mac is not None:
            parts.append(lv.mac["acc"])
    import torch

    offsets, members = setup.groups
    sizes = (offsets[1:] - offsets[:-1]).tolist()
    g = max(range(len(sizes)), key=lambda i: sizes[i])
    deep = dataclasses.replace(setup, groups=(
        torch.tensor([0, sizes[g]], dtype=torch.int32),
        members[int(offsets[g]):int(offsets[g + 1])]))
    deep_ms = cs.cuda_ms(lambda: deep.clone().run(), 3)
    row = {"levels": len(setup.levels), "iters": setup.num_iters,
           "nested_sha": sha(*parts),
           "nested_ms": cs.cuda_ms(lambda: setup.clone().run(), 3),
           "deep_members": sizes[g], "deep_ms": deep_ms,
           "deep_us_per_chain_step": 1e3 * deep_ms / (sizes[g]
                                                      * setup.num_iters)}
    cs.log(f"  nested_sweep ({row['levels']} levels x {row['iters']} it.): "
           f"{row['nested_ms']:.3f} ms, {row['nested_sha'][:12]}; the "
           f"deepest group ({sizes[g]} members) alone {deep_ms:.3f} ms, "
           f"{row['deep_us_per_chain_step']:.3f} us per chain step")
    return row


def cap_row(cs, tag, args):
    """kmer_cap on one call's arguments: its masks' sha256 and time."""
    from bayestyper_tpu_torch import kernels

    row = {"case": tag, "masks_sha": sha(kernels.kmer_cap(*args)),
           "kept_in": int(args[3].sum()),
           "kept_out": int(kernels.kmer_cap(*args).sum()),
           "ms": cs.cuda_ms(lambda: kernels.kmer_cap(*args), 5),
           "device_ms": device_ms(lambda: kernels.kmer_cap(*args),
                                  "bt_kmer_cap_kernel")}
    cs.log(f"  kmer_cap {tag}: {row['ms']:.4f} ms (device {row['device_ms']}"
           f" ms), keeps {row['kept_out']} of {row['kept_in']}, "
           f"{row['masks_sha'][:12]}")
    return row


def coupled_cap_row(cs, unit, samples, ploidy, opts, dev):
    """kmer_cap on the coupled unit's capped level with the most k-mer
    slots, from the path's keys (chip_smoke.coupled_phase's call)."""
    from bayestyper_tpu_torch import engine, kernels
    from bayestyper_tpu_torch.model import gibbs
    from bayestyper_tpu_torch.ops import prng

    table, counts = engine.gather_sample_counts(unit, samples,
                                                opts.num_host_threads)
    ucounts = engine._UnitCounts(unit, table, counts)
    nested = [fc for fc in unit.compiled if engine._is_coupled(fc)]
    ni = engine._nested_inputs(nested, samples, ploidy, ucounts, opts, dev)
    capped = [l for l, cfg in enumerate(ni.cfgs) if cfg.apply_cap]
    l = max(capped, key=lambda i: ni.buckets[i].mult.shape[:2].numel())
    bucket, cfg = ni.buckets[l], ni.cfgs[l]
    sub_key = prng.split(prng.fold_in(prng.prng_key(opts.random_seed), l),
                         2)[0]
    base, fold = gibbs._chain_base(sub_key, opts.num_chains)
    kk = prng.split(base, 2)
    w0 = kernels.subsample_masks(kk[:, 0], fold, bucket.cluster_id,
                                 bucket.kmer_valid, cfg.kmer_subsampling_rate,
                                 gibbs._SUBSAMPLE_SALT)
    return cap_row(cs, f"coupled level {l} H{bucket.num_haplotypes}/"
                       f"K{bucket.num_kmers}/C{bucket.num_clusters}",
                   (kk[:, 1], fold, bucket.cluster_id, w0, bucket.member,
                    bucket.num_haplotypes, cfg.max_haplotype_variant_kmers,
                    gibbs._CAP_SALT))


def wide_cap_rows(cs, unit, samples, ploidy, opts, dev):
    """kmer_cap on the first chunk of the wide unit's class with the most
    k-mer slots (chip_smoke.check_cap_timed's calls): at the class's own
    cap and rate, at chip_smoke.FORCED_CAP and at rate 1.0."""
    from bayestyper_tpu_torch import engine, kernels
    from bayestyper_tpu_torch.model import gibbs
    from bayestyper_tpu_torch.ops import prng

    table, counts = engine.gather_sample_counts(unit, samples,
                                                opts.num_host_threads)
    singles = list(unit.compiled)
    plan = engine._plan_unit(singles, engine._class_map(singles), opts,
                             samples, None)
    pc = plan[max(plan, key=lambda kc: plan[kc].k)]
    bucket = engine._bucket_cached(
        None, pc.chunks[0], (pc.c_pad, pc.k, pc.h, pc.v), samples, ploidy,
        engine._UnitCounts(unit, table, counts), opts.random_seed, dev)
    cfg = pc.cfg
    base, fold = gibbs._chain_base(prng.prng_key(opts.random_seed),
                                   cfg.num_chains)
    kk = prng.split(base, 2)
    own = cfg.max_haplotype_variant_kmers
    rows = []
    for cap, rate in ((own, cfg.kmer_subsampling_rate),
                      (cs.FORCED_CAP, cfg.kmer_subsampling_rate), (own, 1.0)):
        w0 = kernels.subsample_masks(kk[:, 0], fold, bucket.cluster_id,
                                     bucket.kmer_valid, rate,
                                     gibbs._SUBSAMPLE_SALT)
        rows.append(cap_row(
            cs, f"wide H{pc.h}/K{pc.k}/C{bucket.num_clusters} cap {cap} "
                f"rate {rate}",
            (kk[:, 1], fold, bucket.cluster_id, w0, bucket.member,
             bucket.num_haplotypes, cap, gibbs._CAP_SALT)))
        del w0
    return rows


# the rate update's scan: iterations, chains, samples (the wide unit's 30)
RATE_SCAN = (350, 20, 30)


def rates_row(cs, dev, seed):
    """The rate update over a 350-iteration scan of [20, 30] rates: with
    statistics drawn from the seed refilled before every update, the
    sha256 of the rates and the trace; then the scan's launches back to
    back on fixed buffers (the update zeroes its statistics): the time per
    update launch and of the scan's whole rate work (with the draws' one
    launch where the tree has noise_rate_draws)."""
    import numpy as np
    import torch

    from bayestyper_tpu_torch import kernels
    from bayestyper_tpu_torch.model import gibbs
    from bayestyper_tpu_torch.ops import prng

    iters, ch, s = RATE_SCAN
    prior = (1.0, 0.01)
    _, k_noise = gibbs._chain_keys(prng.prng_key(seed), ch, 0)
    k_noise = kernels.key_words(k_noise, dev)
    rng = np.random.default_rng(seed)
    stats = torch.from_numpy(np.stack([
        rng.integers(0, 400, (iters, ch, s)),
        rng.integers(0, 90_000, (iters, ch, s))], 1).astype(np.int32)).to(dev)
    paired = hasattr(kernels, "noise_rate_draws")
    rates = torch.full((ch, s), 2e-3, device=dev)
    log_r = torch.log(rates)
    cs_, no = torch.zeros((2, ch, s), dtype=torch.int32, device=dev)
    trace = torch.zeros((ch, iters, s), device=dev)

    def scan(refill):
        draws = kernels.noise_rate_draws(k_noise, trace) if paired else None
        for t in range(iters):
            if refill:
                cs_.copy_(stats[t, 0])
                no.copy_(stats[t, 1])
            if paired:
                kernels.noise_rate_update(draws, cs_, no, rates, log_r, trace,
                                          t, *prior)
            else:
                kernels.noise_rates(k_noise, cs_, no, rates, log_r, trace, t,
                                    *prior)
        return draws

    scan(True)
    row = {"case": f"[{iters}, {ch}, {s}]", "paired": paired,
           "rates_sha": sha(rates, log_r, trace)}
    row["scan_ms"] = cs.cuda_ms(lambda: scan(False), 3)
    if paired:
        draws = kernels.noise_rate_draws(k_noise, trace)

        def updates():
            for t in range(iters):
                kernels.noise_rate_update(draws, cs_, no, rates, log_r, trace,
                                          t, *prior)

        row["draws_ms"] = cs.cuda_ms(
            lambda: kernels.noise_rate_draws(k_noise, trace), 5)
        row["draws_device_ms"] = device_ms(
            lambda: kernels.noise_rate_draws(k_noise, trace),
            "bt_noise_rates_draws_kernel")
        row["update_ms"] = cs.cuda_ms(updates, 3) / iters
        row["update_device_ms"] = device_ms(updates, "bt_noise_rates_kernel")
    else:
        row["update_ms"] = row["scan_ms"] / iters
        row["update_device_ms"] = device_ms(lambda: scan(False),
                                            "bt_noise_rates_kernel")
    cs.log(f"  rate update {row['case']}: {row['update_ms']:.5f} ms a launch "
           f"over {iters} back to back (device {row['update_device_ms']} "
           f"ms), the scan's rate work {row['scan_ms']:.3f} ms, "
           f"{row['rates_sha'][:12]}")
    return row


def vcf_rows(cs, unit, samples, genome, ploidy, opts, tmp, label):
    """genotype_unit and genotype_unit_joint on the card: VCF sha256s."""
    import torch

    from bayestyper_tpu_torch import engine

    out = {}
    for mode in ("seq", "joint"):
        path = os.path.join(tmp, f"{label}_{mode}.vcf")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "seq":
            summary = engine.genotype_unit(unit, samples, genome, ploidy,
                                           path, opts, device="cuda")
        else:
            summary = engine.genotype_unit_joint(
                unit, samples, genome, ploidy, path,
                dataclasses.replace(opts, noise_genotyping=True),
                device="cuda")
        torch.cuda.synchronize()
        out[f"{label}_{mode}"] = {
            "sha256": file_sha(path), "seconds": time.perf_counter() - t0,
            "timings": summary["timings"]}
        cs.log(f"  {label} {mode}: {out[f'{label}_{mode}']['sha256']} "
               f"({out[f'{label}_{mode}']['seconds']:.2f} s)")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=2.0)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from bayestyper_tpu_torch import engine, kernels
    from bayestyper_tpu_torch.io.samples import ChromosomePloidy

    assert os.path.dirname(os.path.abspath(kernels.__file__)).startswith(tree)
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    t0 = time.perf_counter()
    kernels.build()
    cs.log(f"kernel_ab {tree}: {smi}; build {time.perf_counter() - t0:.1f} s")
    ploidy = ChromosomePloidy.human_default()
    opts = engine.GenotypeOptions(
        num_chains=20, burn_in=100, num_samples=250, random_seed=1,
        max_bucket_clusters=4096, num_host_threads=os.cpu_count() or 1)
    result = {"tree": tree, "device": smi, "classes": [], "vcf": {}}
    tmp = tempfile.mkdtemp(prefix="bt_kernel_ab_")

    def cluster(genome, samples, vcf_path):
        return engine.run_cluster_phase(
            genome, samples, vcf_path, ploidy, kmer_size=cs.K,
            max_parameter_kmers=1_000_000, num_threads=os.cpu_count() or 1)

    os.makedirs(os.path.join(tmp, "main"))
    genome, vcf_path, _, _, samples = cs.simulate(
        os.path.join(tmp, "main"), args.seed, args.scale)
    unit = cluster(genome, samples, vcf_path)
    result["classes"] += class_rows(cs, unit, samples, ploidy, opts, dev,
                                    "main")
    result["vcf"].update(vcf_rows(cs, unit, samples, genome, ploidy, opts,
                                  tmp, "main"))

    os.makedirs(os.path.join(tmp, "coupled"))
    genome, vcf_path, _, _, samples, _ = cs.simulate_coupled(
        os.path.join(tmp, "coupled"), args.seed, args.scale)
    unit = cluster(genome, samples, vcf_path)
    result["nested"] = nested_row(cs, unit, samples, ploidy, opts, dev)
    result["cap"] = [coupled_cap_row(cs, unit, samples, ploidy, opts, dev)]
    with coupled_stats_call([]) as calls:
        result["vcf"].update(vcf_rows(cs, unit, samples, genome, ploidy,
                                      opts, tmp, "coupled"))
    result["coupled_stats"] = coupled_stats_row(cs, calls)
    del calls

    os.makedirs(os.path.join(tmp, "wide"))
    genome, vcf_path, _, _, samples, _ = cs.simulate_wide(
        os.path.join(tmp, "wide"), args.seed, cs.WIDE_SCALE)
    unit = cluster(genome, samples, vcf_path)
    result["classes"] += class_rows(cs, unit, samples, ploidy, opts, dev,
                                    "wide")
    result["cap"] += wide_cap_rows(cs, unit, samples, ploidy, opts, dev)
    result["rates"] = rates_row(cs, dev, args.seed)
    result["beyond_ll"] = beyond_ll_rows(cs, dev, args.seed)
    result["wide_k_stats"] = wide_k_stats_row(cs, dev, args.seed)
    result["beyond_stats"] = beyond_stats_rows(cs, dev, args.seed)
    result["vcf"].update(vcf_rows(cs, unit, samples, genome, ploidy, opts,
                                  tmp, "wide"))
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    cs.log(f"kernel_ab: wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
