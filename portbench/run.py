"""The benchmark of bayestyper_tpu_torch, the PyTorch/CUDA port of
BayesTyper's genotyper: one cell, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up simulates the cell's inputs from --seed on the card (generator.py:
genome, candidate VCF, one KMC1 table per sample), runs the port's
cluster phase once (with each sample's bloom filter where the
configuration states "sample_blooms") and writes the unit file, then
warms up with one genotype unit of the cell's own shapes. The window then
drives the body of the port's `genotype` subcommand unit after unit:
engine.load_unit, then engine.genotype_unit (engine.genotype_unit_joint in
a joint mix), each with its own random seed from --seed and the unit's
index, each writing its VCF, until --seconds have passed; the window
closes when the unit in flight ends. With --trace 1 every unit runs under
its own profiler window (trace.py) and the run reports the cell's
per-layer metrics; with --trace 0 it reports the end-to-end ones. After
the window the plain reference (reference.py) judges every unit's VCF, and
`correct` says whether each compared number kept its limit (judge.json; a
configuration may state the judge's reach, judge_settings).

Everything a cell needs is found by name: BENCHMARK.json's entry names its
configuration (configs/<name>.json) and its traffic mix
(mixes/<name>.json), and each per-layer metric is read by
metrics/<name>.py. The last line of standard output is the result, a JSON
object. Without a CUDA card, with fewer cards than the cell asks for, or
with jax, jaxlib, flax or bayestyper_tpu loaded once the window has
closed, it prints no result and exits 2 or 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "bayestyper_tpu")
WARM_INDEX = 1 << 30


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN (whole
    names: bayestyper_tpu_torch is not bayestyper_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def specs(cell_name):
    """(benchmark, cell, configuration, mix) of a cell, by name."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise SystemExit(f"no workload {cell_name!r} in BENCHMARK.json")
    cell = cells[cell_name]
    cfg = load_json(HERE, "configs", f"{cell['config']}.json")
    mix = load_json(HERE, "mixes", f"{cell['traffic']}.json")
    return bench, cell, cfg, mix


def cell_metrics(bench, cell, kind):
    """The cell's metrics of BENCHMARK.json's list `kind`."""
    return [m for m in bench[kind]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def read_metric(name, ctx):
    """metrics/<name>.py's read(ctx): a number, or None where it finds
    nothing to read."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def judge_settings(cfg):
    """judge.json with the configuration's "judge" settings over it: only
    the judge's reach (reference.CONFIG_KEYS); the limits, the control and
    the cut stay judge.json's for every cell."""
    from portbench.reference import CONFIG_KEYS

    stated = cfg.get("judge", {})
    other = sorted(set(stated) - set(CONFIG_KEYS))
    if other:
        raise ValueError(f"configuration {cfg.get('name')!r} states judge "
                         f"settings {other}; it may state only "
                         f"{list(CONFIG_KEYS)}")
    return dict(load_json(HERE, "judge.json"), **stated)


def sample_blooms(cfg, samples, threads):
    """Each sample's k-mer bloom filter, loaded as the port's `cluster` and
    `workflow` subcommands load it (cli._load_sample_blooms: made from its
    KMC table), where the configuration's "cluster" states
    "sample_blooms": true; else None. The cluster phase enumerates a
    cluster's paths whole up to 32 x 4 x the number of blooms (1 without):
    128 paths without blooms, 1,664 with 13, so that a 10-SNV family keeps
    its 1,024."""
    if not cfg["cluster"].get("sample_blooms", False):
        return None
    from bayestyper_tpu_torch.cli import _load_sample_blooms

    return _load_sample_blooms(samples, threads)


def unit_options(engine, settings, seed, index, joint):
    from portbench.generator import seed_of

    return engine.GenotypeOptions(
        num_chains=settings["num_chains"], burn_in=settings["burn_in"],
        num_samples=settings["num_samples"],
        kmer_subsampling_rate=settings["kmer_subsampling_rate"],
        max_bucket_clusters=settings["max_bucket_clusters"],
        num_host_threads=settings["num_host_threads"],
        random_seed=1 + seed_of(seed, 2, index) % ((1 << 31) - 2),
        noise_genotyping=joint)


def drive_window(one, out_path, seconds, window=None):
    """Units back to back: one(index, out_path(index)) until `seconds` have
    passed since the first began; the unit in flight ends the window. Each unit runs inside window() where given (a traced
    run). Returns (summaries, output paths, window seconds), the window
    running from the first unit's start to the last unit's end."""
    summaries, outs = [], []
    t0 = time.perf_counter()
    while True:
        out = out_path(len(outs))
        with (window() if window else contextlib.nullcontext()):
            summaries.append(one(len(outs), out))
        outs.append(out)
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            return summaries, outs, elapsed


def variants_per_s(summaries, window_s):
    """Every unit's written variants over the window's wall seconds."""
    return sum(s["num_variants"] for s in summaries) / window_s


def run_cell(cell_name, seed, seconds, trace, device="cuda", settings=None,
             config=None, mix=None, warm=True, log=print, program=None):
    """One run of a cell. Returns (result dict without `checks`, checks as
    [(name, value, limit)]). settings, config and mix override the
    configuration's genotype settings and the configuration's and the
    mix's top-level keys, and warm=False skips the warm-up unit (for the
    CPU tests). program overrides the genotype settings the program runs
    with and the judge does not see (the control, a cut run)."""
    import torch
    from torch.profiler import record_function

    from bayestyper_tpu_torch import engine, kernels
    from bayestyper_tpu_torch.constants import GENDER_FEMALE
    from bayestyper_tpu_torch.io.fasta import Genome
    from bayestyper_tpu_torch.io.samples import ChromosomePloidy, Sample

    from portbench import generator, reference, work
    from portbench import trace as tracing

    bench, cell, cfg, mix_spec = specs(cell_name)
    cfg = dict(cfg, **(config or {}))
    mix = dict(mix_spec, **(mix or {}))
    settings = dict(cfg["genotype"], **(settings or {}))
    program = dict(settings, **(program or {}))
    judge_spec = judge_settings(cfg)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        kernels.build()
    log(f"portbench: imports and kernels loaded at "
        f"{time.perf_counter() - T_START:.2f} s")
    joint = mix["mode"] == "joint"
    genotype = engine.genotype_unit_joint if joint else engine.genotype_unit
    tmp = tempfile.mkdtemp(prefix="portbench_")
    try:
        t0 = time.perf_counter()
        sim = generator.simulate(tmp, seed, cfg, mix, device)
        log(f"portbench: simulated {len(sim.variants)} variants, "
            f"{len(sim.prefixes)} samples, genome {len(sim.seq)} bp "
            f"({time.perf_counter() - t0:.2f} s)")
        genome = Genome()
        genome.names = [sim.chrom]
        genome.sequences[sim.chrom] = sim.seq.encode()
        samples = [Sample(f"s{i:02d}", GENDER_FEMALE, p)
                   for i, p in enumerate(sim.prefixes)]
        ploidy = ChromosomePloidy.human_default()
        t0 = time.perf_counter()
        unit = engine.run_cluster_phase(
            genome, samples, sim.vcf_path, ploidy,
            sample_blooms=sample_blooms(cfg, samples,
                                        settings["num_host_threads"]),
            kmer_size=cfg["kmer_size"],
            max_parameter_kmers=cfg["cluster"]["max_parameter_kmers"],
            num_threads=settings["num_host_threads"])
        unit_path = os.path.join(tmp, "unit.pkl")
        unit.save(unit_path)
        layer_work = work.unit_work(unit, len(samples), settings)
        log(f"portbench: cluster phase {len(unit.compiled)} clusters "
            f"({time.perf_counter() - t0:.2f} s)")
        del unit

        def one(index, out):
            opts = unit_options(engine, program, seed, index, joint)
            t_load = time.perf_counter()
            with record_function("portbench.load_unit"):
                unit = engine.load_unit(unit_path)
            t_load = time.perf_counter() - t_load
            with record_function("portbench.genotype_unit"):
                summary = genotype(unit, samples, genome, ploidy, out, opts,
                                   device=device)
            if cuda:
                torch.cuda.synchronize()
            summary["timings"]["load_s"] = t_load
            return summary

        t0 = time.perf_counter()
        if warm:
            one(WARM_INDEX, os.path.join(tmp, "warm.vcf"))
        if trace and cuda:
            with tracing.Window(tracing.Totals()):
                torch.ones(1, device=device).add_(1)
        setup_s = time.perf_counter() - T_START
        log(f"portbench: warm-up unit {time.perf_counter() - t0:.2f} s; "
            f"set-up {setup_s:.2f} s")

        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        # the harness's own long-lived objects stay out of the collector's
        # scans in the window, as a genotype process would not hold them
        gc.collect()
        gc.freeze()
        totals = tracing.Totals()
        summaries, outs, window_s = drive_window(
            one, lambda i: os.path.join(tmp, f"unit{i}.vcf"), seconds,
            (lambda: tracing.Window(totals)) if trace else None)
        gc.unfreeze()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        found = forbidden_modules()
        if found:
            raise ForbiddenModules(found)

        written = sum(s["num_variants"] for s in summaries)
        attempted = len(sim.variants) * len(summaries)
        if cuda:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        judge = reference.Judge(sim, cfg["kmer_size"],
                                generator.seed_of(seed, 3), device,
                                judge_spec)
        codes, gpps = zip(*[reference.read_calls(p, sim.variants,
                                                 len(samples))
                            for p in outs])
        noise_ref = judge.noise_rates(settings["kmer_subsampling_rate"],
                                      *judge_spec["noise_prior"])
        verdict = judge.judge(codes, [s["nb_mean"] for s in summaries],
                              gpps, [s["noise_rates"] for s in summaries],
                              noise_ref, judge_spec["gpp_floor"])
        verdict["noise_rows_gap"] = sum(
            reference.noise_rows_gap(
                p[:-len(".vcf")] + "_noise_parameters.txt",
                settings["num_chains"],
                settings["burn_in"] + settings["num_samples"])
            for p in outs)
        log(f"portbench: reference judged {verdict['calls']} calls of "
            f"{len(judge.groups)} groups ({judge.windows} local windows) "
            f"over {len(outs)} units, {verdict['confident']} confident, "
            f"{judge.unjudged} variants not judged; noise rates "
            f"{[float(r) for r in noise_ref]} ("
            f"{time.perf_counter() - t0:.2f} s)")
        limits = judge_spec["limits"]
        checks = [(name, verdict[name], limits[name]) for name in limits]

        ctx = {"summaries": summaries, "totals": totals, "work": layer_work,
               "peak_bytes": peak}
        if trace:
            metrics = {m["name"]: (read_metric(m["name"], ctx), m["unit"])
                       for m in cell_metrics(bench, cell, "per_layer")}
        else:
            values = {"variants_per_s": variants_per_s(summaries, window_s),
                      "setup_s": setup_s}
            metrics = {m["name"]: (values[m["name"]], m["unit"])
                       for m in cell_metrics(bench, cell, "end_to_end")}
        result = {
            "correct": all(v <= lim for _, v, lim in checks),
            "attempted": attempted,
            "failed": attempted - written,
            "metrics": {n: {"value": v, "unit": u}
                        for n, (v, u) in metrics.items() if v is not None},
            "device": {"platform": "gpu" if cuda else "cpu",
                       "kind": (torch.cuda.get_device_name(0) if cuda
                                else "cpu"),
                       "count": 1, "memory_peak_bytes": peak},
        }
        if trace:
            result["device"]["busy_s"] = totals.busy_s
            result["device"]["window_s"] = totals.window_s
            result["breakdown"] = totals.breakdown()
        log(f"portbench: {len(outs)} units, {written} variants in "
            f"{window_s:.3f} s; setup {setup_s:.3f} s; per unit "
            + json.dumps([s["timings"] for s in summaries]))
        return result, checks
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class ForbiddenModules(RuntimeError):
    pass


def power_limit():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    bench, cell, _, _ = specs(args.workload)
    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is False; the benchmark "
              "runs on a CUDA card only", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    print(f"portbench: {power_limit()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", file=sys.stderr)
    try:
        result, checks = run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace),
                                  log=lambda m: print(m, file=sys.stderr))
    except ForbiddenModules as e:
        print(f"portbench: modules loaded that the benchmark refuses: "
              f"{e.args[0]}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"portbench: modules loaded that the benchmark refuses: "
              f"{found}", file=sys.stderr)
        return 2
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    for name, v, lim in checks:
        print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
