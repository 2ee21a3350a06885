// ll_noise_terms: per-(cluster, chain, sample, outcome) k-mer count
// log-likelihoods, and on request the noise sufficient statistics.
//
// Replaces gibbs.compute_log_likelihoods and gibbs.compute_noise_terms
// (bayestyper_tpu/model/gibbs.py:254-515). On the TPU both were built from
// one-hot MXU contractions because gathers serialise there; on this card
// the direct table gather is the natural form. Per cluster it is a product
//   LL[x, (s, o)] = sum_k w[x, k] * Q[k, (s, o)],
//   Q[k, (s, o)] = T_s[min(dip[k, o] + inter[k, s], mmax), count[k, s]]
// (k-mers of total multiplicity 0 skipped when include_noise_row == 0; the
// null outcome's column zeroed), and from the same pass
//   A, B, C0 = sum_k w * [dip + inter == 0] * (count, 1, lgamma(count + 1)).
//
// One layout for every class. A block owns a cluster's columns (sample,
// outcome) — several clusters at the small classes, so that its warps are
// full, or a 256-column tile of one cluster at the large ones — and each
// thread one column, with its oa/ob in registers. The block stages a tile
// of k-mers of its clusters: haplotype multiplicities, intercluster
// multiplicities, counts, and the masks of a tile of chains as packed
// 32-k-mer words (kernels.pack_bits); from H512 up the multiplicities are
// read in place (a column tile needs few of their rows, and a 32-k-mer
// tile of them passes 16 KB). Per 32 k-mers a thread gathers its column's
// Q once per k-mer into its own shared row, then, for each chain, adds the
// values at the set bits of the chain's word, lowest k first: the gather
// is shared by the chains, the masks are broadcasts, and only subsampled
// k-mers cost an add. LL and C0 accumulate in double and A and B as
// integers, in registers across every k tile, and are stored once; the
// noise form looks lgamma(count + 1) up in a block table of the 256 uint8
// counts (the same lgammaf values). So each entry is the sum over k
// ascending of the same float terms as the plain version's (one double add
// per set bit), rounded to float once. A block's chains are a tile of 20
// (the genotype form) or of 10 (the noise form: four accumulators per
// chain, in registers); each chain tile is a block row of its own and
// gathers once.
// Bound: bytes (writing the outputs) at the small classes, operations (an
// add per subsampled (k-mer, chain, column)) at the large ones; every input
// byte is read once per block.
#include "launchers.h"

#define BT_LL_THREADS 256
// shared memory a block aims at (several blocks per SM); a tile of 32
// k-mers takes more where it must
#define BT_LL_SMEM_TARGET (64 * 1024)
// the largest H whose multiplicities are staged
#define BT_LL_STAGE_MAX_H 511

struct BtLLShape {
  int kt, cpb, xt;   // k-mers per tile, clusters per block, chains per tile
  long long tiles;   // column tiles per cluster (0: cpb clusters per block)
  size_t smem;
};

__host__ __device__ inline size_t bt_ll_smem(int kt, int cpb, int xt, int H,
                                             int S, bool noise) {
  const int he = H <= BT_LL_STAGE_MAX_H ? H + 1 : 0;
  return (size_t)32 * BT_LL_THREADS * 4                    // qs
         + (noise ? 256 * 4 : 0)                           // lgamma(count + 1)
         + (size_t)cpb * xt * (kt / 32) * 4                // mask words
         + (size_t)cpb * kt * (he + 2 * S);   // mult, inter, counts
}

template <int kXT, bool kNoise>
__global__ void __launch_bounds__(BT_LL_THREADS) bt_ll_noise_terms_kernel(
    const uint8_t* __restrict__ mult, const uint8_t* __restrict__ inter,
    const uint8_t* __restrict__ counts, const unsigned* __restrict__ wbits,
    const float* __restrict__ tables, int m_rows, int mmax,
    const int* __restrict__ oa, const int* __restrict__ ob,
    float* __restrict__ ll, float* __restrict__ A, float* __restrict__ B,
    float* __restrict__ C0, long long C, int K, int H, int S, int ch, int O,
    int include_noise_row, int KT, int cpb, long long tiles) {
  extern __shared__ float smem[];
  const int nt = blockDim.x, tid = threadIdx.x;
  const bool staged = H <= BT_LL_STAGE_MAX_H;
  const int he = staged ? H + 1 : 0, KTW = KT / 32, KW = (K + 31) / 32;
  const long long SO = (long long)S * O;

  long long c0, col;
  int ncl, cl;
  if (tiles > 0) {
    c0 = blockIdx.x / tiles;
    col = (blockIdx.x % tiles) * nt + tid;
    ncl = 1;
    cl = 0;
  } else {
    c0 = (long long)blockIdx.x * cpb;
    ncl = (int)min((long long)cpb, C - c0);
    cl = tid / (int)SO;
    col = tid % SO;
  }
  const bool active = cl < ncl && col < SO;
  const int s = (int)(col / O), o = (int)(col % O);
  const int a = active ? oa[o] : 0, b = active ? ob[o] : 0;
  const float* tab = tables + (size_t)s * m_rows * 256;

  float* qs = smem;                                        // [32, nt]
  float* s_lg = qs + 32 * nt;                              // [256]
  unsigned* s_w = reinterpret_cast<unsigned*>(
      s_lg + (kNoise ? 256 : 0));                          // [cpb, kXT, KTW]
  uint8_t* s_me = reinterpret_cast<uint8_t*>(s_w + (size_t)cpb * kXT * KTW);
  uint8_t* s_in = s_me + (size_t)cpb * KT * he;            // [cpb, KT, S]
  uint8_t* s_cn = s_in + (size_t)cpb * KT * S;             // [cpb, KT, S]
  float* my_q = qs + tid;
  // lgamma(count + 1) of every uint8 count (the first tile's barrier
  // publishes it)
  for (int i = tid; kNoise && i < 256; i += nt)
    s_lg[i] = lgammaf((float)i + 1.0f);

  const int x0 = blockIdx.y * kXT;
  double acc[kXT], nc[kXT];
  int na[kXT], nb[kXT];
#pragma unroll
  for (int i = 0; i < kXT; ++i) {
    acc[i] = 0.0;
    nc[i] = 0.0;
    na[i] = 0;
    nb[i] = 0;
  }
  for (int k0 = 0; k0 < K; k0 += KT) {
    const int kt = min(KT, K - k0);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < ncl * KT * he; i += nt) {
      const int c = i / (KT * he), k = (i / he) % KT, h = i % he;
      s_me[i] = (k < kt && h < H)
                    ? mult[((c0 + c) * K + k0 + k) * H + h] : 0;
    }
    for (int i = tid; i < ncl * KT * S; i += nt) {
      const int c = i / (KT * S), k = (i / S) % KT, ss = i % S;
      const size_t g = ((c0 + c) * K + k0 + k) * S + ss;
      const int cnt = k < kt ? counts[g] : 0;
      s_in[i] = k < kt ? inter[g] : 0;
      s_cn[i] = (uint8_t)cnt;
    }
    for (int i = tid; i < ncl * kXT * KTW; i += nt) {
      const int c = i / (kXT * KTW), xi = (i / KTW) % kXT, wi = i % KTW;
      const int x = x0 + xi, word = k0 / 32 + wi;
      s_w[i] = (x < ch && word < KW)
                   ? wbits[((c0 + c) * ch + x) * KW + word] : 0u;
    }
    __syncthreads();
    if (!active) continue;
    const unsigned* wrow = s_w + (size_t)cl * kXT * KTW;
    const uint8_t* me = s_me + (size_t)cl * KT * he;
    const uint8_t* mrow = mult + ((c0 + cl) * K + k0) * H;
    // haplotype h's multiplicity at tile k-mer k (h = H: the null
    // haplotype's 0; k past the tile: 0)
    const auto mult_at = [&](int k, int h) -> int {
      if (staged) return me[k * he + h];
      return (k < kt && h < H) ? __ldg(mrow + (size_t)k * H + h) : 0;
    };
    const uint8_t* in = s_in + (size_t)cl * KT * S + s;
    const uint8_t* cn = s_cn + (size_t)cl * KT * S + s;
    for (int wi = 0; wi < (kt + 31) / 32; ++wi) {
      unsigned any = 0u;
#pragma unroll
      for (int xi = 0; xi < kXT; ++xi) any |= wrow[xi * KTW + wi];
      if (any == 0u) continue;
      // the column's Q of the word's 32 k-mers, each gathered once
      unsigned zero = 0u;
      for (int j = 0; j < 32; ++j) {
        const int k = wi * 32 + j;
        const int tot = mult_at(k, a) + mult_at(k, b) + in[k * S];
        zero |= (unsigned)(tot == 0) << j;
        my_q[j * nt] = tab[(tot < mmax ? tot : mmax) * 256 + cn[k * S]];
      }
      const int kb = wi * 32;
#pragma unroll
      for (int xi = 0; xi < kXT; ++xi) {
        const unsigned m = wrow[xi * KTW + wi];
        for (unsigned r = include_noise_row ? m : (m & ~zero); r;
             r &= r - 1u)
          acc[xi] += (double)my_q[(__ffs(r) - 1) * nt];
        if (kNoise) {
          unsigned r = m & zero;
          nb[xi] += __popc(r);
          for (; r; r &= r - 1u) {
            const int cnt = cn[(kb + __ffs(r) - 1) * S];
            na[xi] += cnt;
            nc[xi] += (double)s_lg[cnt];
          }
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int xi = 0; xi < kXT; ++xi) {
      const int x = x0 + xi;
      if (x >= ch) break;
      const size_t out = ((size_t)((c0 + cl) * ch + x) * S + s) * O + o;
      ll[out] = o == O - 1 ? 0.0f : (float)acc[xi];
      if (kNoise) {
        A[out] = (float)na[xi];
        B[out] = (float)nb[xi];
        C0[out] = (float)nc[xi];
      }
    }
  }
}

// The launch shape: chains per tile (20, or 10 for the noise form);
// clusters per block where a cluster's columns fit the block (one where
// fewer than two blocks per SM would run), else column tiles; the largest
// tile of k-mers (a multiple of 32) under BT_LL_SMEM_TARGET, or 32 where
// even that passes it. kt = 0: not even a 32-k-mer tile fits the card's
// opt-in shared memory.
static BtLLShape bt_ll_noise_terms_shape(long long C, int K, int H, int S,
                                         int O, int ch, bool noise) {
  BtLLShape l;
  const long long so = (long long)S * O;
  l.xt = noise ? 10 : 20;
  l.cpb = so <= BT_LL_THREADS ? (int)(BT_LL_THREADS / so) : 1;
  if ((C + l.cpb - 1) / l.cpb * ((ch + l.xt - 1) / l.xt) < 2 * 132) l.cpb = 1;
  l.tiles = so <= BT_LL_THREADS ? 0 : (so + BT_LL_THREADS - 1) / BT_LL_THREADS;
  const int k32 = ((K + 31) / 32) * 32;
  l.kt = 32;
  while (l.kt + 32 <= k32 &&
         bt_ll_smem(l.kt + 32, l.cpb, l.xt, H, S, noise) <= BT_LL_SMEM_TARGET)
    l.kt += 32;
  l.smem = bt_ll_smem(l.kt, l.cpb, l.xt, H, S, noise);
  if (l.smem > (size_t)bt_smem_optin()) l.kt = 0;
  return l;
}

int bt_ll_noise_terms_layout(int64_t C, int K, int H, int S, int O, int ch,
                             int noise) {
  return bt_ll_noise_terms_shape(C, K, H, S, O, ch, noise != 0).kt > 0 ? 0
                                                                      : -1;
}

template <int kXT, bool kNoise>
static cudaError_t bt_ll_noise_terms_launch(
    const BtLLShape& l, const uint8_t* mult, const uint8_t* inter,
    const uint8_t* counts, const unsigned* wbits, const float* tables,
    int m_rows, int mmax, const int* oa, const int* ob, float* ll, float* A,
    float* B, float* C0, int64_t C, int K, int H, int S, int ch, int O,
    int include_noise_row, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bt_ll_noise_terms_kernel<kXT, kNoise>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      l.tiles > 0 ? C * l.tiles : (C + l.cpb - 1) / l.cpb;
  const dim3 grid((unsigned)blocks, (unsigned)((ch + kXT - 1) / kXT));
  bt_ll_noise_terms_kernel<kXT, kNoise>
      <<<grid, BT_LL_THREADS, l.smem, stream>>>(
          mult, inter, counts, wbits, tables, m_rows, mmax, oa, ob, ll, A, B,
          C0, C, K, H, S, ch, O, include_noise_row, l.kt, l.cpb, l.tiles);
  return cudaGetLastError();
}

cudaError_t bt_ll_noise_terms(const uint8_t* mult, const uint8_t* inter,
                              const uint8_t* counts, const unsigned* wbits,
                              const float* tables, int m_rows, int mmax,
                              const int* oa, const int* ob, float* ll,
                              float* A, float* B, float* C0, int64_t C, int K,
                              int H, int S, int ch, int O,
                              int include_noise_row, cudaStream_t stream) {
  if (C == 0 || K == 0) return cudaSuccess;
  const bool noise = A != nullptr;
  const BtLLShape l = bt_ll_noise_terms_shape(C, K, H, S, O, ch, noise);
  if (l.kt == 0) return cudaErrorInvalidValue;
  if (noise)
    return bt_ll_noise_terms_launch<10, true>(
        l, mult, inter, counts, wbits, tables, m_rows, mmax, oa, ob, ll, A, B,
        C0, C, K, H, S, ch, O, include_noise_row, stream);
  return bt_ll_noise_terms_launch<20, false>(
      l, mult, inter, counts, wbits, tables, m_rows, mmax, oa, ob, ll, A, B,
      C0, C, K, H, S, ch, O, include_noise_row, stream);
}
