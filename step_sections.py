"""Where the Gibbs step spends its time, section by section, on one CUDA card.

    python3 step_sections.py [--tree PATH] [--out RESULT.json]
    python3 step_sections.py --nested [--tree PATH] [--out RESULT.json]
                             [--seed 0] [--scale 2]

Copies the step body of a tree of this repository (PATH, the current one by
default: bayestyper_tpu_torch/kernels/csrc/gibbs_step.cuh and gibbs_sweep.cu)
into PATH/.torch_ext_build/step_sections/, adds a clock64() mark after every
barrier of bt_gibbs_step (thread 0 of each block adds the cycles since its
last mark into one counter per barrier), builds it with nvcc for sm_90a
(-fmad=false, as the kernels) and runs gibbs_sweep's 350-iteration scan
(burn-in 100) on random inputs: 20 chains, 13 samples, every sample
diploid, at H2 x 4,096 clusters, H8 x 512, H16 x 128 and H64 x 64. It
prints, per shape, the scan's time with the marks and each barrier's share
of the marked cycles. The marks slow the step down and move work between
sections a little; the shares say which phase holds the block, not how
long it takes unmarked.

With --nested it profiles the coupled scan (nested_sweep) on chip_smoke.py's
coupled unit instead: it builds the tree's kernel extension from a copy
(PATH/.torch_ext_build/nested_sections/) in which every block of
nested_sweep records %globaltimer and its SM at its start and end (the
block timeline), and thread 0 of the blocks of the deepest group adds the
cycles of each section of a member step (a mark after every barrier of the
kernel and of the step, and at every "// ----" section comment of the
kernel) into one counter per mark. It runs the 350-iteration scan once with
every group and once with the deepest group alone, and prints when the
deepest group's blocks start and end within the launch, how the launch's
time splits between them and the rest, and each section's cycles per
member step.
"""

import argparse
import ctypes
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys

SHAPES = ((2, 4096, 13), (8, 512, 13), (16, 128, 13), (64, 64, 13))
CHAINS, ITERS, BURN_IN = 20, 350, 100
# the barriers of the step body: its sync() functor's, or the block's
BARRIER = re.compile(r"(\bsync\(\);|__syncthreads\(\);)")

WRAPPER = r'''
extern "C" int bt_sections_sweep(
    const float* ll, const int8_t* ploidy, const bool* hv, const float* sp,
    const bool* us, const int64_t* cid, const unsigned* bk,
    const unsigned* fold, const int* oa, const int* ob, float* freqs,
    int* tally, int* osel, long long ncl, int ch, int S, int O, int H,
    int t0, int t1, int burn_in) {
  unsigned long long zero[64] = {0};
  cudaMemcpyToSymbol(bt_sec, zero, sizeof(zero));
  return (int)bt_gibbs_sweep(ll, ploidy, hv, sp, us, cid, bk, fold, oa, ob,
                             freqs, tally, osel, nullptr, ncl, ch, S, O, H,
                             t0, t1, burn_in, 0);
}
extern "C" int bt_sections_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, bt_sec, 64 * sizeof(unsigned long long));
}
'''

MARKS = r'''
__device__ unsigned long long bt_sec[64];
#define BT_SEC_MARK()                                                   \
  do {                                                                  \
    if (threadIdx.x == 0) {                                             \
      const long long bt_now = clock64();                               \
      atomicAdd(&bt_sec[bt_k < 63 ? bt_k : 63],                         \
                (unsigned long long)(bt_now - bt_t));                   \
      bt_t = bt_now;                                                    \
      ++bt_k;                                                           \
    }                                                                   \
  } while (0)
'''


def instrument(src):
    """gibbs_step.cuh with a mark after every barrier of bt_gibbs_step."""
    start = src.index("inline void bt_gibbs_step(")
    open_brace = src.index("{", start)
    end = src.index("\n}\n", open_brace)
    body = BARRIER.sub(r"\1 BT_SEC_MARK();", src[open_brace + 1:end])
    head = src[:open_brace + 1] + "\n  long long bt_t = clock64();\n  int bt_k = 0;"
    marked = head + body + src[end:]
    pos = marked.index("#pragma once") + len("#pragma once")
    return marked[:pos] + "\n" + MARKS + marked[pos:]


def build(tree):
    csrc = os.path.join(tree, "bayestyper_tpu_torch", "kernels", "csrc")
    work = os.path.join(tree, ".torch_ext_build", "step_sections")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    for name in ("gibbs_step.cuh", "threefry.cuh", "launchers.h",
                 "gibbs_sweep.cu"):
        shutil.copy(os.path.join(csrc, name), work)
    path = os.path.join(work, "gibbs_step.cuh")
    with open(path) as f:
        src = f.read()
    with open(path, "w") as f:
        f.write(instrument(src))
    with open(os.path.join(work, "gibbs_sweep.cu"), "a") as f:
        f.write(WRAPPER)
    so = os.path.join(work, "libsections.so")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "nvcc")
    subprocess.run([nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-O3",
                    "-fmad=false", "-std=c++17", "-shared", "-Xcompiler",
                    "-fPIC", "-I", work, "-o", so,
                    os.path.join(work, "gibbs_sweep.cu")], check=True)
    lib = ctypes.CDLL(so)
    ptr = ctypes.c_void_p
    lib.bt_sections_sweep.argtypes = ([ptr] * 13 + [ctypes.c_longlong]
                                      + [ctypes.c_int] * 7)
    lib.bt_sections_read.argtypes = [ptr]
    return lib


def run_shape(lib, h, c, s, torch, np):
    dev = torch.device("cuda")
    o = h * (h + 1) // 2 + h + 1
    n = c * CHAINS
    gen = torch.Generator(device=dev).manual_seed(h)
    ll = -torch.rand((n, s, o), device=dev, generator=gen) * 40
    ii, jj = np.triu_indices(h)
    oa = torch.tensor(np.concatenate([ii, np.arange(h), [h]]),
                      dtype=torch.int32, device=dev)
    ob = torch.tensor(np.concatenate([jj, np.full(h, h), [h]]),
                      dtype=torch.int32, device=dev)
    args = [ll, torch.full((c, s), 2, dtype=torch.int8, device=dev),
            torch.ones((c, h), dtype=torch.bool, device=dev),
            torch.full((c,), 0.5, device=dev),
            torch.ones((c,), dtype=torch.bool, device=dev),
            torch.arange(c, dtype=torch.int64, device=dev),
            torch.randint(0, 1 << 30, (CHAINS, 2), dtype=torch.int32,
                          device=dev, generator=gen),
            torch.arange(CHAINS, dtype=torch.int32, device=dev), oa, ob,
            torch.full((n, h), 1.0 / h, device=dev),
            torch.zeros((n, s, o), dtype=torch.int32, device=dev),
            torch.zeros((n, s), dtype=torch.int32, device=dev)]
    ptrs = [a.data_ptr() for a in args]

    def sweep():
        rc = lib.bt_sections_sweep(*ptrs, c, CHAINS, s, o, h, 0, ITERS,
                                   BURN_IN)
        if rc:
            raise RuntimeError(f"gibbs_sweep launch failed: {rc}")

    sweep()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    sweep()
    e1.record()
    e1.synchronize()
    sec = (ctypes.c_ulonglong * 64)()
    lib.bt_sections_read(sec)
    total = sum(sec)
    return {"shape": f"H{h}/C{c} x{CHAINS}, S{s}, O{o}", "ms": e0.elapsed_time(e1),
            "shares": [round(100 * x / total, 1) for x in sec if x]}


# the nested profile's device counters and marks: the block timeline
# (start, end in ns of %globaltimer, SM) and, for the blocks of one group,
# thread 0's cycles per mark site
NESTED_MARKS = r'''
#define BT_TL_MAX 65536
static __device__ unsigned long long bt_tl[3 * BT_TL_MAX];
static __device__ unsigned long long bt_sec[256];
static __device__ unsigned long long bt_sec_steps;
static __device__ int bt_sec_group = -1;
static __device__ int bt_sec_chains = 1;
static __shared__ long long bt_sec_t;
static __shared__ int bt_sec_flag;
__device__ __forceinline__ unsigned long long bt_gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ bool bt_sec_on() {
  return threadIdx.x == 0 && bt_sec_flag;
}
// a block's row: its (group g, chain x), g * chains + x
#define BT_TL_ROW (g * bt_sec_chains + x)
#define BT_TL_START()                                                   \
  do {                                                                  \
    if (threadIdx.x == 0 && BT_TL_ROW < BT_TL_MAX) {                    \
      unsigned bt_smid;                                                 \
      asm volatile("mov.u32 %0, %%smid;" : "=r"(bt_smid));              \
      bt_tl[3 * BT_TL_ROW] = bt_gtime();                                \
      bt_tl[3 * BT_TL_ROW + 2] = bt_smid;                               \
    }                                                                   \
  } while (0)
#define BT_TL_END()                                                     \
  do {                                                                  \
    if (threadIdx.x == 0 && BT_TL_ROW < BT_TL_MAX)                      \
      bt_tl[3 * BT_TL_ROW + 1] = bt_gtime();                            \
  } while (0)
#define BT_SEC_BEGIN()                                                  \
  do {                                                                  \
    if (threadIdx.x == 0)                                               \
      bt_sec_flag = g == bt_sec_group;                                  \
    if (bt_sec_on()) {                                                  \
      bt_sec_t = clock64();                                             \
      atomicAdd(&bt_sec_steps, 1ull);                                   \
    }                                                                   \
  } while (0)
#define BT_SEC_AT(id)                                                   \
  do {                                                                  \
    if (bt_sec_on()) {                                                  \
      const long long bt_now = clock64();                               \
      atomicAdd(&bt_sec[id], (unsigned long long)(bt_now - bt_sec_t));  \
      bt_sec_t = bt_now;                                                \
    }                                                                   \
  } while (0)
'''

NESTED_WRAPPER = r'''
extern "C" int bt_nested_sections_arm(int group, int chains) {
  unsigned long long zero[256] = {0};
  unsigned long long z = 0;
  cudaError_t e = cudaMemcpyToSymbol(bt_sec, zero, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(bt_sec_steps, &z, sizeof(z));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(bt_sec_group, &group, sizeof(int));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(bt_sec_chains, &chains, sizeof(int));
  return (int)e;
}
extern "C" int bt_nested_sections_read(unsigned long long* sec,
                                       unsigned long long* steps,
                                       unsigned long long* tl, int n) {
  cudaError_t e = cudaMemcpyFromSymbol(sec, bt_sec, 256 * sizeof(unsigned long long));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(steps, bt_sec_steps, sizeof(unsigned long long));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(tl, bt_tl, 3 * (size_t)n * sizeof(unsigned long long));
  return (int)e;
}
'''
# the barriers of a kernel body or step body: block barriers and a
# block-team's or named barrier's sync
NESTED_BARRIER = re.compile(r"(__syncthreads\(\);|__syncwarp\(\);|\bsync\(\);)")


def _body_span(src, signature):
    """(index of the body's opening brace, index of its closing brace) of the
    function whose definition starts with `signature`."""
    start = src.index(signature)
    open_brace = src.index("{", src.index(")", start))
    return open_brace, src.index("\n}\n", open_brace) + 1


def instrument_nested(kernel_src, step_src):
    """(nested_sweep.cu, gibbs_step.cuh, [mark labels]) with the timeline
    at the start and end of the coupled-scan kernel, a section start at
    the top of each member step, and a numbered mark after every barrier
    and at every "// ----" comment of the member step and after every
    barrier of bt_gibbs_step. The member step is the kernel's body (a
    kernel with the step inline, bt_nested_sweep_kernel) or bt_chip_step
    (the on-chip kernel, bt_nested_chip_kernel, whose first mark then
    holds the wait for the producer's record)."""
    labels = []

    def marks(body, name, first_line, comments):
        out = []
        line = first_line
        for text in body.splitlines(keepends=True):
            stripped = text.strip()
            if comments and stripped.startswith("// ----"):
                out.append(f"BT_SEC_AT({len(labels)});")
                labels.append(f"{name}:{line} {stripped[3:].strip(' -')}")
            out.append(text)
            for _ in NESTED_BARRIER.findall(text):
                out.append(f" BT_SEC_AT({len(labels)});")
                labels.append(f"{name}:{line} barrier")
            line += text.count("\n")
        return "".join(out)

    def marked(src, signature, name, comments, hook=None):
        b0, b1 = _body_span(src, signature)
        body = src[b0 + 1:b1 - 1]
        if hook is None:
            body = marks(body, name, src[:b0 + 1].count("\n") + 1, comments)
        else:
            body = hook(body)
        return src[:b0 + 1] + body + src[b1 - 1:]

    def begin(body):
        # the timeline from where the block knows its (group g, chain x);
        # the section start in the member loop (the on-chip kernel's
        # consumers': "++m, ++j")
        at = re.search(r"x = blockIdx\.x % ch;\n", body).end()
        body = body[:at] + " BT_TL_START();\n" + body[at:]
        loop = (re.search(r"for \(int m = [^)]*\+\+j\) \{", body)
                or re.search(r"for \(int m = [^)]*\) \{", body))
        return (body[:loop.end()] + " BT_SEC_BEGIN();" + body[loop.end():]
                + " BT_TL_END();\n")

    chip = "bt_nested_chip_kernel(" in kernel_src
    kernel_sig = ("bt_nested_chip_kernel(const" if chip
                  else "__global__ void bt_nested_sweep_kernel")
    if chip:
        kernel = marked(kernel_src, "inline void bt_chip_step(",
                        "nested_sweep.cu", True)
        kernel = marked(kernel, kernel_sig, "", False, begin)
    else:
        kernel = marked(kernel_src, kernel_sig, "nested_sweep.cu", True)
        kernel = marked(kernel, kernel_sig, "", False, begin)
    kernel += NESTED_WRAPPER
    step = marked(step_src, "inline void bt_gibbs_step(", "gibbs_step.cuh",
                  False)
    pos = step.index("#pragma once") + len("#pragma once")
    step = step[:pos] + "\n" + NESTED_MARKS + step[pos:]
    return kernel, step, labels


def nested_profile(tree, seed, scale):
    """The coupled scan's block timeline and the deepest group's member-step
    sections (see the module docstring)."""
    import tempfile
    import time

    import numpy as np
    import torch

    sys.path.insert(0, tree)
    import chip_smoke as cs
    from bayestyper_tpu_torch import engine, kernels
    from bayestyper_tpu_torch.io.samples import ChromosomePloidy
    from bayestyper_tpu_torch.model import gibbs
    from bayestyper_tpu_torch.model.count_model import fit_genomic_nb
    from bayestyper_tpu_torch.ops import prng
    from bayestyper_tpu_torch.ops.distributions import (
        np_build_count_log_prob_tables, tables_from_numpy)

    assert os.path.dirname(os.path.abspath(kernels.__file__)).startswith(tree)
    csrc = os.path.join(tree, "bayestyper_tpu_torch", "kernels", "csrc")
    work = os.path.join(tree, ".torch_ext_build", "nested_sections")
    src = os.path.join(work, "src")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(csrc, src)
    with open(os.path.join(src, "nested_sweep.cu")) as f:
        kernel_src = f.read()
    with open(os.path.join(src, "gibbs_step.cuh")) as f:
        step_src = f.read()
    kernel_src, step_src, labels = instrument_nested(kernel_src, step_src)
    with open(os.path.join(src, "nested_sweep.cu"), "w") as f:
        f.write(kernel_src)
    with open(os.path.join(src, "gibbs_step.cuh"), "w") as f:
        f.write(step_src)
    from torch.utils import cpp_extension

    t0 = time.perf_counter()
    kernels._MODULE = cpp_extension.load(
        name="bt_kernels_sections",
        sources=[os.path.join(src, f) for f in kernels.SOURCES],
        extra_include_paths=[src], extra_cflags=["-O3"],
        extra_cuda_cflags=list(kernels.NVCC_FLAGS), build_directory=work)
    lib = ctypes.CDLL(kernels._MODULE.__file__)
    lib.bt_nested_sections_arm.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.bt_nested_sections_read.argtypes = [
        ctypes.POINTER(ctypes.c_ulonglong)] * 3 + [ctypes.c_int]
    print(f"nested sections: built in {time.perf_counter() - t0:.1f} s",
          flush=True)

    dev = torch.device("cuda")
    ploidy = ChromosomePloidy.human_default()
    opts = engine.GenotypeOptions(
        num_chains=20, burn_in=100, num_samples=250, random_seed=1,
        max_bucket_clusters=4096, num_host_threads=os.cpu_count() or 1)
    tmp = tempfile.mkdtemp(prefix="bt_nested_sections_")
    try:
        genome, vcf_path, _, _, samples, _ = cs.simulate_coupled(tmp, seed,
                                                                 scale)
        unit = engine.run_cluster_phase(
            genome, samples, vcf_path, ploidy, kmer_size=cs.K,
            max_parameter_kmers=1_000_000, num_threads=os.cpu_count() or 1)
        table, counts = engine.gather_sample_counts(unit, samples,
                                                    opts.num_host_threads)
        nb = fit_genomic_nb(engine.parameter_kmer_stats(unit, samples, table,
                                                        counts))
        tables = tables_from_numpy(np_build_count_log_prob_tables(
            nb.p, nb.size, np.full(len(samples), 1e-3), 255), dev)
        nested = [fc for fc in unit.compiled if engine._is_coupled(fc)]
        ni = engine._nested_inputs(nested, samples, ploidy,
                                   engine._UnitCounts(unit, table, counts),
                                   opts, dev)
        args, kwargs = ni.genotype_args(prng.prng_key(opts.random_seed),
                                        tables)
        setup = gibbs.nested_setup(*args, **kwargs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ch = opts.num_chains
    if hasattr(kernels, "order_groups"):
        # the launch order: blocks of group g are g * ch .. g * ch + ch - 1
        setup = dataclasses.replace(setup,
                                    groups=kernels.order_groups(setup.groups))
    offsets, members = setup.groups
    sizes = (offsets[1:] - offsets[:-1]).tolist()
    deep = max(range(len(sizes)), key=lambda g: sizes[g])
    shapes = sorted({(lv.hap_valid.shape[1], lv.ll.shape[3],
                      0 if lv.sh is None else lv.sh["slot"].shape[1])
                     for lv in setup.levels})
    deep_rows = members[int(offsets[deep]):int(offsets[deep + 1])].tolist()
    deep_shapes = sorted({(setup.levels[l].hap_valid.shape[1],
                           0 if setup.levels[l].sh is None else
                           int(setup.levels[l].sh["valid"][r].sum()))
                          for l, r in deep_rows})
    n_blocks = len(sizes) * ch

    def run(groups, group_index):
        st = dataclasses.replace(setup.clone(), groups=groups)
        rc = lib.bt_nested_sections_arm(group_index, ch)
        if rc:
            raise RuntimeError(f"arming the marks failed: {rc}")
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        st.run()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1)

    run(setup.groups, deep)  # warm-up
    ms = run(setup.groups, deep)
    sec = (ctypes.c_ulonglong * 256)()
    steps = ctypes.c_ulonglong()
    tl = (ctypes.c_ulonglong * (3 * n_blocks))()
    rc = lib.bt_nested_sections_read(sec, ctypes.byref(steps), tl, n_blocks)
    if rc:
        raise RuntimeError(f"reading the marks failed: {rc}")
    tl = np.array(tl, dtype=np.float64).reshape(n_blocks, 3)
    t_start = tl[:, 0].min()
    start = (tl[:, 0] - t_start) / 1e6
    end = (tl[:, 1] - t_start) / 1e6
    blocks = np.arange(n_blocks)
    in_deep = blocks // ch == deep
    deep_groups = (torch.tensor([0, sizes[deep]], dtype=torch.int32),
                   members[int(offsets[deep]):int(offsets[deep + 1])])
    alone_ms = run(deep_groups, 0)
    member_steps = sizes[deep] * setup.num_iters
    cycles = [int(x) for x in sec[:len(labels)]]
    total = sum(cycles) or 1
    per_step = int(steps.value) or 1
    rest = ~in_deep
    result = {
        "tree": tree, "groups": len(sizes), "blocks": n_blocks,
        "chains": ch, "iters": setup.num_iters,
        "group_sizes": sorted(sizes, reverse=True)[:12],
        "level_shapes_h_o_q": shapes, "deep_group": deep,
        "deep_members": sizes[deep], "deep_shapes_h_qvalid": deep_shapes,
        "launch_ms": ms, "deep_alone_ms": alone_ms,
        "deep_us_per_chain_step": 1e3 * alone_ms / member_steps,
        "deep_start_ms": [float(start[in_deep].min()),
                          float(start[in_deep].max())],
        "deep_end_ms": [float(end[in_deep].min()), float(end[in_deep].max())],
        "deep_span_ms": float((end[in_deep] - start[in_deep]).mean()),
        "rest_end_ms": float(end[rest].max()) if rest.any() else 0.0,
        "rest_block_ms_mean": float((end[rest] - start[rest]).mean())
        if rest.any() else 0.0,
        "deep_sms": sorted({int(x) for x in tl[in_deep, 2]}),
        "blocks_on_deep_sms": int(np.isin(tl[rest, 2],
                                          tl[in_deep, 2]).sum()),
        "member_steps_marked": per_step,
        "sections": [{"mark": lab, "cycles_per_step": c / per_step,
                      "share": round(100 * c / total, 1)}
                     for lab, c in zip(labels, cycles) if c],
    }
    print(f"{tree}: {len(sizes)} groups x {ch} chains = {n_blocks} blocks; "
          f"launch {ms:.2f} ms with the marks; the deepest group "
          f"({sizes[deep]} members, index {deep}) starts at "
          f"{result['deep_start_ms'][0]:.2f}-{result['deep_start_ms'][1]:.2f}"
          f" ms and ends at {result['deep_end_ms'][0]:.2f}-"
          f"{result['deep_end_ms'][1]:.2f} ms; alone {alone_ms:.2f} ms "
          f"({result['deep_us_per_chain_step']:.2f} us per chain step); the "
          f"other blocks end by {result['rest_end_ms']:.2f} ms", flush=True)
    for row in result["sections"]:
        print(f"  {row['mark']}: {row['cycles_per_step']:.0f} cycles per "
              f"member step ({row['share']}%)", flush=True)
    return result


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--out")
    ap.add_argument("--nested", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=2.0)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("step_sections: needs a CUDA card", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    if args.nested:
        result = nested_profile(tree, args.seed, args.scale)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)
        return 0
    lib = build(tree)
    rows = []
    for h, c, s in SHAPES:
        row = run_shape(lib, h, c, s, torch, np)
        print(f"{tree} {row['shape']}: {row['ms']:.2f} ms with the marks; "
              f"share per barrier, % {row['shares']}", flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"tree": tree, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
