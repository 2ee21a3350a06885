// kmer_cap: the exact shuffled-order per-(haplotype, variant) k-mer cap of
// the subsample masks, bit-identical to the JAX package.
//
// Replaces gibbs.apply_kmer_cap (bayestyper_tpu/model/gibbs.py:171-231), a
// K-step lax.scan with a [C, ch, V, H] counter carry. The scan's counter of
// column e = (variant, haplotype) only grows, by one at each kept k-mer of
// membership e while under the cap, so after t visited slots it is
// min(cap, the kept k-mers of membership e among them): a kept k-mer
// survives iff, for one of its memberships e, fewer than cap kept k-mers of
// membership e come before it in visit order. No other column enters, so
// the walk is not serial in substance. One block per (cluster, chain):
//   1. the row's kept slots as bit words (one coalesced read of w, ballots);
//   2. each column's kept memberships (per member word, one ballot per bit
//      that some lane holds); where no column holds more than cap, out is
//      w on the k-mers that hold a membership (the scan drops a kept k-mer
//      of none) and the block ends: no key, no sort (the common case,
//      since the engine caps every chunk of a class where some pool
//      exceeds the cap);
//   3. else only the m kept slots are keyed, (uniform << 32 | slot) with
//      the pair's key fold_in(fold_in(base[chain], cluster_id),
//      fold[chain]) and the cap salt, and bitonic-sorted: the JAX package's
//      stable argsort restricted to them, ties to the lower slot;
//   4. a kept slot with a membership in a column of at most cap k-mers
//      survives; one warp per member word holding a column past the cap
//      runs each such column's exclusive prefix count over the sorted
//      slots (a ballot over 32 positions, __popc), a slot surviving where
//      its prefix is under cap, and stops once each column of the word has
//      reached cap.
// Every slot's result is written once. Integer work only, so the masks are
// bit-equal. Bound: bytes (w read, the kept slots' member words, out
// written), the sort's steps and the prefix walks running side by side
// across pairs.
//
// Layouts (bt_kmer_cap_shape): 0 keeps every array in shared memory, sized
// for m = K. Past the card's opt-in shared memory (K > 16,384 slots on the
// H100) the global-memory variant launches with the largest power-of-two
// key area that fits: a pair sorts there where its own next_pow2(m) keys
// fit, and otherwise in a caller-allocated [pairs, next_pow2(K)] device
// scratch, each pass of stride below the area's size staged through it
// (layout 1); layout 2 also keeps the [V, H] column counters there.
#include "launchers.h"
#include "threefry.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
// the fewest sort keys that layout 1 keeps in shared memory beside the
// counters; layout 2 moves the counters out below it
constexpr int kMinSharedKeys = 1024;

// the bits of haplotypes h < H in member word wi
__device__ __forceinline__ unsigned bt_cap_hap_mask(int wi, int H) {
  const int lo = wi * 32;
  if (lo + 32 <= H) return kFull;
  return lo >= H ? 0u : (1u << (H - lo)) - 1u;
}

// The compare-exchange passes j = j0, j0 / 2, ..., 1 of bitonic stage k on
// the keys of positions [base, base + n) held in s (n a power of two above
// j0): ascending where (position & k) == 0.
__device__ void bt_cap_passes(unsigned long long* s, int n, int base, int k,
                              int j0) {
  for (int j = j0; j > 0; j >>= 1) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int ixj = i ^ j;
      if (ixj > i) {
        const unsigned long long a = s[i], b = s[ixj];
        if ((a > b) == (((base + i) & k) == 0)) {
          s[i] = b;
          s[ixj] = a;
        }
      }
    }
    __syncthreads();
  }
}

// Sort mp keys (a power of two) in device memory g, through a shared chunk
// s of chunk keys (a smaller power of two): every stage up to the chunk and
// every pass of stride below it runs on one chunk in shared memory, the
// longer strides in place.
__device__ void bt_cap_sort_device(unsigned long long* g, int mp,
                                   unsigned long long* s, int chunk) {
  for (int k = chunk; k <= mp; k <<= 1) {
    if (k > chunk) {
      for (int j = k >> 1; j >= chunk; j >>= 1) {
        for (int i = threadIdx.x; i < mp; i += blockDim.x) {
          const int ixj = i ^ j;
          if (ixj > i) {
            const unsigned long long a = g[i], b = g[ixj];
            if ((a > b) == ((i & k) == 0)) {
              g[i] = b;
              g[ixj] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    for (int b = 0; b < mp; b += chunk) {
      for (int i = threadIdx.x; i < chunk; i += blockDim.x) s[i] = g[b + i];
      __syncthreads();
      if (k == chunk) {
        for (int kk = 2; kk <= chunk; kk <<= 1)
          bt_cap_passes(s, chunk, b, kk, kk >> 1);
      } else {
        bt_cap_passes(s, chunk, b, k, chunk >> 1);
      }
      for (int i = threadIdx.x; i < chunk; i += blockDim.x) g[b + i] = s[i];
      __syncthreads();
    }
  }
}

// out[i] = bit i of the [KW] words keep, every slot of the row once: 16
// bytes a thread where the row is 16-byte aligned (vec)
__device__ void bt_cap_write(bool* op, const unsigned* keep, int K,
                             bool vec) {
  if (!vec) {
    for (int i = threadIdx.x; i < K; i += blockDim.x)
      op[i] = (keep[i >> 5] >> (i & 31)) & 1u;
    return;
  }
  uint4* o16 = reinterpret_cast<uint4*>(op);
  for (int q = threadIdx.x; q < K / 16; q += blockDim.x) {
    const unsigned half = keep[q >> 1] >> (16 * (q & 1));
    unsigned b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const unsigned nib = half >> (4 * r);
      b[r] = (nib & 1u) | ((nib >> 1) & 1u) << 8 | ((nib >> 2) & 1u) << 16 |
             ((nib >> 3) & 1u) << 24;
    }
    o16[q] = make_uint4(b[0], b[1], b[2], b[3]);
  }
}

}  // namespace

// kLayout 0: all shared; 1: a pair's keys in the scratch where they pass
// key_cap; 2: also the column counters in the scratch. Shared memory: the
// key area (key_cap keys), then the [V * H] counters (layouts 0-1), the
// [V * W] words of columns past the cap, the kept and the surviving slots
// as [KW] bit words, and 33 ints of block sums.
template <int kLayout>
__global__ void __launch_bounds__(1024) bt_kmer_cap_kernel(
    const unsigned* __restrict__ base_keys, const unsigned* __restrict__ fold,
    const int64_t* __restrict__ cluster_id, const bool* __restrict__ w,
    const unsigned* __restrict__ member, bool* __restrict__ out, int ch,
    int K, int V, int W, int H, int cap, unsigned salt, int key_cap,
    long long stride, unsigned long long* scratch, bool vec) {
  extern __shared__ unsigned long long smem_u64[];
  const long long pair = blockIdx.x;
  const int kw = (K + 31) / 32, vh = V * H, vw = V * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  unsigned long long* skeys = smem_u64;
  int* counts = reinterpret_cast<int*>(smem_u64 + key_cap);
  unsigned* over =
      reinterpret_cast<unsigned*>(counts + (kLayout == 2 ? 0 : vh));
  unsigned* kept = over + vw;
  unsigned* keep = kept + kw;
  int* sums = reinterpret_cast<int*>(keep + kw);  // [32] warps, [32] m
  int kp = 1;
  while (kp < K) kp <<= 1;
  unsigned long long* own = kLayout > 0 ? scratch + pair * stride : nullptr;
  if (kLayout == 2) counts = reinterpret_cast<int*>(own + kp);

  const long long c = pair / ch;
  const int x = (int)(pair % ch);
  const bool* wp = w + pair * K;
  bool* op = out + pair * K;
  const unsigned* mrow = member + (size_t)c * K * vw;

  // 1. kept slots as bit words, m: 16 slots a thread where rows are
  // 16-byte aligned (vec), else a slot a lane
  for (int e = threadIdx.x; e < vh; e += blockDim.x) counts[e] = 0;
  for (int e = threadIdx.x; e < vw; e += blockDim.x) over[e] = 0;
  if (threadIdx.x == 0) sums[32] = 0;
  __syncthreads();
  int m_warp = 0;
  if (vec) {
    const int n16 = K / 16;
    const uint4* w16 = reinterpret_cast<const uint4*>(wp);
    for (int base = 0; base < n16; base += blockDim.x) {
      const int q = base + threadIdx.x;
      unsigned half = 0;
      if (q < n16) {
        const uint4 v = w16[q];
        const unsigned b[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int r = 0; r < 16; ++r)
          half |= ((b[r >> 2] >> (8 * (r & 3))) & 1u) << r;
      }
      const unsigned hi = __shfl_down_sync(kFull, half, 1);
      if (!(lane & 1) && q < n16) {
        const unsigned kb = half | (q + 1 < n16 ? hi << 16 : 0u);
        kept[q >> 1] = kb;
        m_warp += __popc(kb);
      }
    }
    m_warp = __reduce_add_sync(kFull, m_warp);
  } else {
#pragma unroll 4
    for (int j = warp; j < kw; j += n_warps) {
      const int i = j * 32 + lane;
      const unsigned kb = __ballot_sync(kFull, i < K && wp[i]);
      if (lane == 0) kept[j] = kb;
      m_warp += __popc(kb);
    }
  }
  if (lane == 0 && m_warp) atomicAdd(&sums[32], m_warp);
  __syncthreads();

  // 2. each column's kept memberships; the kept slots that hold one. A
  // warp takes four words at a time, their member loads in flight together
  for (int j0 = warp * 4; j0 < kw; j0 += n_warps * 4) {
    unsigned kb[4], held[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      kb[q] = j0 + q < kw ? kept[j0 + q] : 0u;
      held[q] = 0u;
    }
    if (kb[0] | kb[1] | kb[2] | kb[3]) {
      for (int it = 0; it < vw; ++it) {
        const int wi = it % W;
        const unsigned hm = bt_cap_hap_mask(wi, H);
        unsigned mw[4], any = 0u;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          mw[q] = (kb[q] >> lane) & 1u
                      ? mrow[(size_t)((j0 + q) * 32 + lane) * vw + it] & hm
                      : 0u;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          held[q] |= mw[q];
          any |= mw[q];
        }
        any = __reduce_or_sync(kFull, any);
        while (any) {
          const int b = __ffs(any) - 1;
          any &= any - 1;
          int n = 0;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            n += __popc(__ballot_sync(kFull, (mw[q] >> b) & 1u));
          if (lane == 0) atomicAdd(&counts[(it / W) * H + wi * 32 + b], n);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned hb = __ballot_sync(kFull, held[q] != 0u);
      if (lane == 0 && j0 + q < kw) keep[j0 + q] = hb;
    }
  }
  __syncthreads();
  int bind = 0;
  for (int e = threadIdx.x; e < vh; e += blockDim.x) {
    if (counts[e] > cap) {
      const int h = e % H;
      atomicOr(&over[(e / H) * W + (h >> 5)], 1u << (h & 31));
      bind = 1;
    }
  }
  if (!__syncthreads_or(bind)) {
    bt_cap_write(op, keep, K, vec);
    return;
  }

  // 3. the m kept slots keyed and sorted
  const int m = sums[32];
  int mp = 1;
  while (mp < m) mp <<= 1;
  unsigned long long* keys = (kLayout == 0 || mp <= key_cap) ? skeys : own;
  {
    // exclusive prefix of the kept counts over each thread's run of words
    const int per = (kw + blockDim.x - 1) / blockDim.x;
    const int j0 = min(kw, (int)threadIdx.x * per), j1 = min(kw, j0 + per);
    int mine = 0;
    for (int j = j0; j < j1; ++j) mine += __popc(kept[j]);
    int incl = mine;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int t = lane < n_warps ? sums[lane] : 0;
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, t, d);
        if (lane >= d) t += y;
      }
      sums[lane] = t;  // inclusive over warps
    }
    __syncthreads();
    int pos = incl - mine + (warp ? sums[warp - 1] : 0);
    for (int j = j0; j < j1; ++j) {
      for (unsigned kb = kept[j]; kb; kb &= kb - 1)
        keys[pos++] = (unsigned long long)(j * 32 + __ffs(kb) - 1);
    }
  }
  __syncthreads();
  const BtKey key = bt_fold_in(
      bt_fold_in(BtKey{base_keys[2 * x], base_keys[2 * x + 1]},
                 (uint32_t)cluster_id[c]),
      fold[x]);
  for (int p = threadIdx.x; p < mp; p += blockDim.x) {
    unsigned long long v = ~0ull;
    if (p < m) {
      const unsigned slot = (unsigned)keys[p];
      uint32_t y0, y1;
      bt_threefry(key, slot, salt, y0, y1);
      v = ((unsigned long long)(y0 >> 8) << 32) | slot;
    }
    keys[p] = v;
  }
  __syncthreads();
  if (keys == skeys) {
    for (int k = 2; k <= mp; k <<= 1) bt_cap_passes(keys, mp, 0, k, k >> 1);
  } else {
    bt_cap_sort_device(keys, mp, skeys, key_cap);
  }

  // 4. survivors: a membership in a column of at most cap k-mers, then the
  // prefix walk of each member word holding a column past it
  for (int j = warp; j < kw; j += n_warps) {
    const unsigned kb = kept[j];
    bool free_ = false;
    if ((kb >> lane) & 1u) {
      const unsigned* row = mrow + (size_t)(j * 32 + lane) * vw;
      for (int it = 0; it < vw && !free_; ++it)
        free_ = (row[it] & bt_cap_hap_mask(it % W, H) & ~over[it]) != 0u;
    }
    const unsigned fb = __ballot_sync(kFull, free_);
    if (lane == 0) keep[j] = fb;
  }
  __syncthreads();
  for (int it = warp; it < vw; it += n_warps) {
    const unsigned ov = over[it];
    if (!ov) continue;
    int before = 0;  // kept members of column bit `lane` so far
    for (int p0 = 0; p0 < m; p0 += 32) {
      const unsigned active =
          __ballot_sync(kFull, ((ov >> lane) & 1u) && before < cap);
      if (!active) break;
      const int p = p0 + lane;
      int slot = 0;
      unsigned mw = 0;
      if (p < m) {
        slot = (int)(unsigned)keys[p];
        mw = mrow[(size_t)slot * vw + it] & active;
      }
      bool surv = false;
      for (unsigned a = active; a; a &= a - 1) {
        const int b = __ffs(a) - 1;
        const bool bit = (mw >> b) & 1u;
        const unsigned bal = __ballot_sync(kFull, bit);
        const int prior = __shfl_sync(kFull, before, b) +
                          __popc(bal & ((1u << lane) - 1u));
        surv |= bit && prior < cap;
        if (lane == b) before += __popc(bal);
      }
      if (surv) atomicOr(&keep[slot >> 5], 1u << (slot & 31));
    }
  }
  __syncthreads();
  bt_cap_write(op, keep, K, vec);
}

// Layout, shared bytes, shared key capacity and scratch bytes per pair of a
// cap launch; -1 where not even layout 2's bit words fit.
static int bt_kmer_cap_shape(int K, int V, int W, int H, int* key_cap,
                             size_t* smem, int64_t* scratch) {
  int kp = 1;
  while (kp < K) kp <<= 1;
  const size_t limit = (size_t)bt_smem_optin();
  const size_t words = ((size_t)V * W + 2 * (size_t)((K + 31) / 32) + 33) * 4;
  const size_t counters = (size_t)V * H * 4;
  *scratch = 0;
  if ((size_t)kp * 8 + counters + words <= limit) {
    *key_cap = kp;
    *smem = (size_t)kp * 8 + counters + words;
    return 0;
  }
  int layout = 1;
  size_t rest = counters + words;
  if (rest + (size_t)kMinSharedKeys * 8 > limit) {
    layout = 2;
    rest = words;
    if (rest + 64 * 8 > limit) return -1;
  }
  int cap = 64;
  while ((size_t)cap * 16 + rest <= limit) cap <<= 1;
  *key_cap = cap;
  *smem = (size_t)cap * 8 + rest;
  *scratch = (int64_t)kp * 8;
  if (layout == 2) *scratch += ((int64_t)V * H + 1) / 2 * 8;
  return layout;
}

int bt_kmer_cap_layout(int K, int V, int W, int H, int64_t* scratch) {
  int key_cap;
  size_t smem;
  return bt_kmer_cap_shape(K, V, W, H, &key_cap, &smem, scratch);
}

template <int kLayout>
static cudaError_t bt_kmer_cap_launch(
    const unsigned* base_keys, const unsigned* fold, const int64_t* cluster_id,
    const bool* w, const unsigned* member, bool* out, int64_t C, int ch, int K,
    int V, int W, int H, int cap, unsigned salt, int key_cap, size_t smem,
    int64_t per_pair, void* scratch, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bt_kmer_cap_kernel<kLayout>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  // a block of 256 threads where several share an SM, else of 1,024
  const int per_sm = (int)((size_t)bt_smem_optin() / (smem ? smem : 1));
  const int threads = per_sm >= 4 ? 256 : 1024;
  bt_kmer_cap_kernel<kLayout><<<(unsigned)(C * ch), threads, smem, stream>>>(
      base_keys, fold, cluster_id, w, member, out, ch, K, V, W, H, cap, salt,
      key_cap, per_pair / 8, static_cast<unsigned long long*>(scratch),
      K % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(out) % 16 == 0);
  return cudaGetLastError();
}

cudaError_t bt_kmer_cap(const unsigned* base_keys, const unsigned* fold,
                        const int64_t* cluster_id, const bool* w,
                        const unsigned* member, bool* out, int64_t C, int ch,
                        int K, int V, int W, int H, int cap, unsigned salt,
                        void* scratch, cudaStream_t stream) {
  if (C * ch == 0 || K == 0) return cudaSuccess;
  int key_cap;
  size_t smem;
  int64_t per_pair;
  const int layout =
      bt_kmer_cap_shape(K, V, W, H, &key_cap, &smem, &per_pair);
  if (layout < 0 || (layout > 0 && scratch == nullptr))
    return cudaErrorInvalidValue;
  switch (layout) {
    case 0:
      return bt_kmer_cap_launch<0>(base_keys, fold, cluster_id, w, member, out,
                                   C, ch, K, V, W, H, cap, salt, key_cap, smem,
                                   per_pair, scratch, stream);
    case 1:
      return bt_kmer_cap_launch<1>(base_keys, fold, cluster_id, w, member, out,
                                   C, ch, K, V, W, H, cap, salt, key_cap, smem,
                                   per_pair, scratch, stream);
    default:
      return bt_kmer_cap_launch<2>(base_keys, fold, cluster_id, w, member, out,
                                   C, ch, K, V, W, H, cap, salt, key_cap, smem,
                                   per_pair, scratch, stream);
  }
}
