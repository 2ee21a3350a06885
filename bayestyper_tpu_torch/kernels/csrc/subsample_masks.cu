// subsample_masks: per-(cluster, chain, k-mer slot) Bernoulli(rate) k-mer
// subsets, bit-identical to the JAX package.
//
// Replaces gibbs._slot_uniform / subsample_masks
// (bayestyper_tpu/model/gibbs.py:120-168), a vmapped threefry program.
// Slot k of chain x in cluster c draws word 0 of threefry(key, (k, salt))
// with key = fold_in(fold_in(base[x], cluster_id[c]), fold[x]), and is kept
// when (bits >> 8) * 2^-24 < rate and the slot holds a k-mer.
// Bound: operations (one threefry hash per valid slot and two per
// (cluster, chain) key). A block covers BT_SM_SLOTS consecutive slots of
// the flat [C, ch, K] output: it derives the key of each (cluster, chain)
// row it touches once, into shared memory; each thread then hashes its
// four slots (none where the slot holds no k-mer, which covers padded
// clusters) and stores them as one 4-byte word.
#include "launchers.h"
#include "threefry.cuh"

#define BT_SM_THREADS 256
#define BT_SM_SLOTS (4 * BT_SM_THREADS)

__global__ void bt_subsample_masks_kernel(
    const unsigned* __restrict__ base_keys, const unsigned* __restrict__ fold,
    const int64_t* __restrict__ cluster_id,
    const bool* __restrict__ kmer_valid, bool* __restrict__ out, int64_t C,
    int ch, int K, float rate, unsigned salt) {
  // at most one row per slot (K = 1)
  __shared__ uint32_t keys[2 * BT_SM_SLOTS];
  const long long n = C * ch * K;
  const long long i0 = (long long)blockIdx.x * BT_SM_SLOTS;
  const long long i_end = i0 + BT_SM_SLOTS < n ? i0 + BT_SM_SLOTS : n;
  const long long r0 = i0 / K;
  const int rows = (int)((i_end - 1) / K - r0 + 1);
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const long long row = r0 + r;
    const int x = (int)(row % ch);
    const BtKey key = bt_fold_in(
        bt_fold_in(BtKey{base_keys[2 * x], base_keys[2 * x + 1]},
                   (uint32_t)cluster_id[row / ch]),
        fold[x]);
    keys[2 * r] = key.k0;
    keys[2 * r + 1] = key.k1;
  }
  __syncthreads();
  const long long i = i0 + 4LL * threadIdx.x;
  if (i >= n) return;
  const int m = n - i < 4 ? (int)(n - i) : 4;
  // the slot's (row within the block, chain, cluster, slot), stepped on
  long long row = i / K;
  int k = (int)(i - row * K), r = (int)(row - r0), x = (int)(row % ch);
  long long c = row / ch;
  uint32_t word = 0u;
  for (int j = 0; j < m; ++j) {
    if (kmer_valid[c * K + k]) {
      uint32_t y0, y1;
      bt_threefry(BtKey{keys[2 * r], keys[2 * r + 1]}, (uint32_t)k, salt, y0,
                  y1);
      const float u = (float)(y0 >> 8) * 5.96046448e-08f;  // 2^-24
      word |= (uint32_t)(u < rate) << (8 * j);
    }
    if (++k == K) {
      k = 0;
      ++r;
      if (++x == ch) {
        x = 0;
        ++c;
      }
    }
  }
  // i is a multiple of 4, and torch allocations are at least 4-byte aligned
  if (m == 4) {
    *reinterpret_cast<uint32_t*>(out + i) = word;
  } else {
    for (int j = 0; j < m; ++j) out[i + j] = (word >> (8 * j)) & 1u;
  }
}

cudaError_t bt_subsample_masks(const unsigned* base_keys, const unsigned* fold,
                               const int64_t* cluster_id,
                               const bool* kmer_valid, bool* out, int64_t C,
                               int ch, int K, float rate, unsigned salt,
                               cudaStream_t stream) {
  const long long n = C * ch * K;
  if (n == 0) return cudaSuccess;
  const long long blocks = (n + BT_SM_SLOTS - 1) / BT_SM_SLOTS;
  bt_subsample_masks_kernel<<<(unsigned)blocks, BT_SM_THREADS, 0, stream>>>(
      base_keys, fold, cluster_id, kmer_valid, out, C, ch, K, rate, salt);
  return cudaGetLastError();
}
