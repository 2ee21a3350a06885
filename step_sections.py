"""Where the Gibbs step spends its time, section by section, on one CUDA card.

    python3 step_sections.py [--tree PATH] [--out RESULT.json]

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
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

SHAPES = ((2, 4096, 13), (8, 512, 13), (16, 128, 13), (64, 64, 13))
CHAINS, ITERS, BURN_IN = 20, 350, 100
# the barriers of the step body: the block team's and the block's
BARRIER = re.compile(r"(tm\.sync\(\);|__syncthreads\(\);)")

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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--out")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("step_sections: needs a CUDA card", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
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
