// bucket_stats: Gibbs outcome tallies -> per-(cluster, sample, variant)
// posterior statistics (GT/GQ/GPP/APP/NAK/FAK/MAC/SAF), unpacked float32 or
// transfer-compact packed (int32 tallies, int8 GT, float16 diagnostics).
//
// Replaces stats._collect_bucket_stats_impl (bayestyper_tpu/model/
// stats.py:235-677), which XLA ran as a lax.map over variants of one-hot
// MXU contractions. Three launches on one stream:
//   1. words: the chunk's k-mer sets as 32-slot bit words (bit j of word i
//      is slot 32 i + j), one warp per (cluster, word) with __ballot_sync:
//      the masks per chain, the observed k-mers (count > 0) per sample, and
//      each haplotype's member k-mers per variant (the member words
//      transposed 32 x 32 at a time);
//   2. select: the top-T outcomes of each (cluster, sample) by total tally
//      over chains, in lax.top_k's order (descending tally, ties to the
//      lower index). One warp per partition of BT_SEL_PART outcomes keeps
//      the partition's totals in shared memory and takes T rounds, each
//      the first outcome after the previous round's: O(O T), once per
//      (cluster, sample) and not once per variant;
//   3. stats: one team per (cluster, sample, variant), a warp where the
//      outcome space fits one (O <= 32: the H2-H6 classes, several items a
//      block) and a 256-thread block above. The team merges its partitions'
//      candidates into the top-T, then computes
//      * the exact int genotype and allele tallies (shared-memory integer
//        atomics), the denominator, and GT's max / tie count / argmax as
//        warp reductions;
//      * per (chain, haplotype) the subsampled k-mer count n and the
//        observed count fr of the variant as popcounts of the bit words,
//        folded per outcome over chains, then per allele: NAK, FAK with the
//        nested `*` substitution (missing);
//      * MAC over the top-T outcomes: per (chain, t) the sum of count /
//        max(dip + inter, 1) over the set bits of w & (hap_a | hap_b), in
//        ascending slot order, plus the coupled scan's correction
//        (mac_extra);
//      * the SAF filter codes and the called GT.
// Every float sum keeps the order of a 256-thread block (bt_team_sums):
// a warp team walks the block's eight warps in turn, so a warp and a block
// give the same bits, and results do not vary from run to run. Bound:
// operations (the per-outcome chain sums and the per-allele passes), not
// bytes.
//
// Above the card's shared memory (H128 at 30 samples and up) layout 1
// keeps the outcome- and haplotype-sized arrays (tall [O], per_o [6, O],
// al_ext [H+1], n_ext and fr_ext [ch, H+1]: 7·O words) in a device scratch
// row per block, the grid launched in waves of blocks that bound that
// scratch.
#include <cuda_fp16.h>
#include <limits.h>

#include "launchers.h"

#define BT_FLOAT_EPS100 1.1920929e-05f  // float32 eps * 100 (Utils.hpp)
#define BT_FULL 0xFFFFFFFFu
// outcomes per warp of the select launch, and its warps per block
#define BT_SEL_PART 1024
#define BT_SEL_WARPS 8
// words of a stats team's cross-warp scratch: 8 warps x 4 sums, 8 warps x
// (tally, outcome)
#define BT_RED_WORDS 32
#define BT_ARG_WORDS 16

__device__ __forceinline__ bool bt_float_compare(float a, float b) {
  const float m = fabsf(fminf(a, b));
  return a == b || fabsf(a - b) < m * BT_FLOAT_EPS100;
}

__device__ __forceinline__ bool bt_float_less(float a, float b) {
  return a < b && !bt_float_compare(a, b);
}

// (t1, o1) comes before (t2, o2) in lax.top_k's order: descending tally,
// ties to the lower index.
__device__ __forceinline__ bool bt_before(int t1, int o1, int t2, int o2) {
  return t1 > t2 || (t1 == t2 && o1 < o2);
}

// The first of the warp's (t, o) in that order, in every lane.
__device__ __forceinline__ void bt_warp_first(int& t, int& o) {
  for (int off = 16; off > 0; off >>= 1) {
    const int t2 = __shfl_xor_sync(BT_FULL, t, off);
    const int o2 = __shfl_xor_sync(BT_FULL, o, off);
    if (bt_before(t2, o2, t, o)) {
      t = t2;
      o = o2;
    }
  }
}

template <int kTeam>
__device__ __forceinline__ void bt_team_sync() {
  if (kTeam == 32)
    __syncwarp();
  else
    __syncthreads();
}

// The first of the team's (t, o), in every thread; arg holds
// BT_ARG_WORDS words. Ends synchronised.
template <int kTeam>
__device__ void bt_team_first(int tid, int& t, int& o, int* arg) {
  bt_warp_first(t, o);
  if (kTeam == 32) return;
  if ((tid & 31) == 0) {
    arg[2 * (tid >> 5)] = t;
    arg[2 * (tid >> 5) + 1] = o;
  }
  __syncthreads();
  for (int w = 0; w < kTeam / 32; ++w) {
    if (bt_before(arg[2 * w], arg[2 * w + 1], t, o)) {
      t = arg[2 * w];
      o = arg[2 * w + 1];
    }
  }
  __syncthreads();
}

// Sums N values over n_items items in the order of a 256-thread block:
// virtual thread j accumulates acc(j, v) over its items j, j + 256, ...,
// a shuffle tree folds each virtual warp of 32, and thread 0 adds the
// eight warp sums in order. A team of 32 threads walks the eight virtual
// warps in turn, a team of 256 takes one each, so both give the same bits.
// Virtual warps past n_items add exact zeros (every summand is >= 0) and
// are skipped. Team thread 0 writes out[0..N); red holds BT_RED_WORDS
// words. Ends synchronised.
template <int kTeam, int N, class F>
__device__ void bt_team_sums(int tid, int n_items, F acc, float* red,
                             float* out) {
  const int lane = tid & 31;
  for (int vw = tid >> 5; vw < 8; vw += kTeam / 32) {
    float v[N];
    for (int i = 0; i < N; ++i) v[i] = 0.0f;
    if (vw * 32 < n_items) {
      acc(vw * 32 + lane, v);
      for (int i = 0; i < N; ++i)
        for (int off = 16; off > 0; off >>= 1)
          v[i] += __shfl_down_sync(BT_FULL, v[i], off);
    }
    if (lane == 0)
      for (int i = 0; i < N; ++i) red[i * 8 + vw] = v[i];
  }
  bt_team_sync<kTeam>();
  if (tid == 0) {
    for (int i = 0; i < N; ++i) {
      float r = 0.0f;
      for (int w = 0; w < 8; ++w) r += red[i * 8 + w];
      out[i] = r;
    }
  }
  bt_team_sync<kTeam>();
}

// Words per team of layout 1's device scratch (the O- and H-sized arrays).
__host__ __device__ inline long long bt_stats_row_words(int O, int H, int ch) {
  return 7LL * O + (long long)(H + 1) * (1 + 2LL * ch);
}

// The launches' device scratch, carved by the launcher: the bit words, the
// select launch's candidates [C·S, P, T, 2] (tally, outcome), layout 1's
// rows.
struct BtStatsWork {
  unsigned *wbits, *obits, *hbits;  // [C, ch, KW], [C, S, KW], [C, V, H, KW]
  int* cand;
  float* rows;
  int KW, P, team_words;
};

__global__ void bt_stats_words_kernel(BtStatsArgs p, BtStatsWork q) {
  const long long item =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (item >= (long long)p.C * q.KW) return;
  const int KW = q.KW;
  const long long c = item / KW;
  const int kw = (int)(item % KW);
  const int k = kw * 32 + lane;
  const bool in = k < p.K;
  for (int x = 0; x < p.ch; ++x) {
    const unsigned b =
        __ballot_sync(BT_FULL, in && p.w[(c * p.ch + x) * (long long)p.K + k]);
    if (lane == 0) q.wbits[(c * p.ch + x) * KW + kw] = b;
  }
  for (int s = 0; s < p.S; ++s) {
    const unsigned b =
        __ballot_sync(BT_FULL, in && p.counts[(c * p.K + k) * p.S + s] > 0);
    if (lane == 0) q.obits[(c * p.S + s) * KW + kw] = b;
  }
  // lane l holds slot l's member word hw; ballot b gives haplotype
  // 32 hw + b's bits of this word, kept by lane b
  for (int v = 0; v < p.V; ++v) {
    for (int hw = 0; hw < p.W; ++hw) {
      const unsigned m =
          in ? p.member[((c * p.K + k) * p.V + v) * p.W + hw] : 0u;
      unsigned mine = 0u;
      for (int b = 0; b < 32; ++b) {
        const unsigned r = __ballot_sync(BT_FULL, (m >> b) & 1u);
        if (lane == b) mine = r;
      }
      const int h = hw * 32 + lane;
      if (h < p.H)
        q.hbits[((c * p.V + v) * p.H + h) * (long long)KW + kw] = mine;
    }
  }
}

__global__ void bt_stats_select_kernel(BtStatsArgs p, BtStatsWork q) {
  __shared__ int tiles[BT_SEL_WARPS][BT_SEL_PART];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * BT_SEL_WARPS + warp;
  if (item >= (long long)p.C * p.S * q.P) return;
  const long long cs = item / q.P;
  const int o0 = (int)(item % q.P) * BT_SEL_PART;
  const int n = min(BT_SEL_PART, p.O - o0);
  const long long c = cs / p.S, s = cs % p.S;
  const int* tl = p.tally + (c * p.ch * p.S + s) * (long long)p.O + o0;
  const long long xs = (long long)p.S * p.O;
  int* tile = tiles[warp];
  for (int i = lane; i < n; i += 32) {
    int t = 0;
    for (int x = 0; x < p.ch; ++x) t += tl[x * xs + i];
    tile[i] = t;
  }
  __syncwarp();
  // round r takes the first outcome after round r - 1's; (INT_MAX, -1)
  // comes before every outcome, and a round past the partition's last
  // outcome writes (-1, -1)
  int pt = INT_MAX, po = -1;
  int* out = q.cand + item * 2LL * p.T;
  for (int r = 0; r < p.T; ++r) {
    int bt = -1, bo = -1;
    for (int i = lane; i < n; i += 32) {
      const int ti = tile[i], oi = o0 + i;
      if (bt_before(pt, po, ti, oi) && bt_before(ti, oi, bt, bo)) {
        bt = ti;
        bo = oi;
      }
    }
    bt_warp_first(bt, bo);
    if (lane == 0) {
      out[2 * r] = bt;
      out[2 * r + 1] = bo;
    }
    pt = bt;
    po = bo;
  }
}

template <int kLayout, int kTeam>
__global__ void bt_bucket_stats_kernel(BtStatsArgs p, BtStatsWork q,
                                       long long item0) {
  extern __shared__ int smem_i[];
  const int S = p.S, V = p.V, K = p.K, H = p.H, O = p.O, A = p.A, G = p.G;
  const int T = p.T, ch = p.ch, KW = q.KW, he = p.H + 1;
  const int team = threadIdx.x / kTeam, tid = threadIdx.x % kTeam;
  const long long b =
      item0 + (long long)blockIdx.x * (blockDim.x / kTeam) + team;
  if (b >= (long long)p.C * S * V) return;
  const long long c = b / ((long long)S * V);
  const int s = (int)((b / V) % S);
  const int v = (int)(b % V);
  const long long cs = c * S + s;

  // layout 1: the outcome- and haplotype-sized arrays in the block's row
  float* row =
      kLayout == 1 ? q.rows + blockIdx.x * bt_stats_row_words(O, H, ch)
                   : nullptr;
  int* sm = smem_i + team * q.team_words;
  int* tall = kLayout == 1 ? reinterpret_cast<int*>(row) : sm;  // [O]
  if (kLayout == 0) sm += O;
  int* al_ext = kLayout == 1 ? tall + O : sm;                     // [H+1]
  if (kLayout == 0) sm += he;
  float* n_ext = kLayout == 1 ? row + O + he                      // [ch, H+1]
                              : reinterpret_cast<float*>(sm);
  if (kLayout == 0) sm += ch * he;
  float* fr_ext = kLayout == 1 ? n_ext + ch * he : reinterpret_cast<float*>(sm);
  if (kLayout == 0) sm += ch * he;
  float* per_o = kLayout == 1 ? fr_ext + ch * he    // nak/fd/fn, a and b
                              : reinterpret_cast<float*>(sm);
  if (kLayout == 0) sm += 6 * O;
  int* sel = sm;        sm += T;     // [T]
  int* gt_bins = sm;    sm += G;     // [G]
  int* al_bins = sm;    sm += A;     // [A]
  int* filt = sm;       sm += A;     // [A]
  int* subst = sm;      sm += A;     // [A] `*` stats substituted
  int* misc = sm;       sm += 4;     // the denominator
  int* arg = sm;        sm += BT_ARG_WORDS;
  float* f = reinterpret_cast<float*>(sm);
  float* mn = f;        f += 2 * ch * T;  // mn_a, mn_b [ch, T]
  float* red = f;       f += BT_RED_WORDS;
  float* sums = f;      f += 4 * A;  // calls, nak_num, fak_den, fak_num
  float* msums = f;     f += 2 * A;  // MAC numerator, denominator
  float* nak = f;       f += A;
  float* fak = f;       f += A;
  float* macv = f;

  const int pl = p.ploidy[cs];
  const bool is_dip = pl == 2, is_hap = pl == 1, valid = pl != 0;
  for (int h = tid; h < he; h += kTeam)
    al_ext[h] = h < H ? p.hap_allele[(c * H + h) * V + v]
                      : p.num_alleles[c * V + v] - 1;
  for (int i = tid; i < G; i += kTeam) gt_bins[i] = 0;
  for (int i = tid; i < A; i += kTeam) al_bins[i] = 0;
  if (tid == 0) misc[0] = 0;

  // ---- the top-T outcomes of (cluster, sample), from the candidates ----
  const int P = q.P;
  const int* cd = q.cand + cs * 2LL * P * T;
  if (P == 1) {
    for (int t = tid; t < T; t += kTeam) sel[t] = cd[2 * t + 1];
  } else {
    int pt = INT_MAX, po = -1;
    for (int r = 0; r < T; ++r) {
      int bt = -1, bo = -1;
      for (int i = tid; i < P * T; i += kTeam) {
        const int ti = cd[2 * i], oi = cd[2 * i + 1];
        if (oi >= 0 && bt_before(pt, po, ti, oi) &&
            bt_before(ti, oi, bt, bo)) {
          bt = ti;
          bo = oi;
        }
      }
      bt_team_first<kTeam>(tid, bt, bo, arg);
      if (tid == 0) sel[r] = bo;
      pt = bt;
      po = bo;
    }
  }

  // ---- per-(chain, haplotype) k-mer counts of this variant ----
  const unsigned* wb = q.wbits + c * ch * KW;
  const unsigned* obw = q.obits + cs * KW;
  const unsigned* hb_v = q.hbits + (c * V + v) * (long long)H * KW;
  for (int i = tid; i < ch * he; i += kTeam) {
    const int x = i / he, h = i % he;
    int n = 0, fr = 0;
    if (h < H) {
      for (int kw = 0; kw < KW; ++kw) {
        const unsigned m = wb[x * KW + kw] & hb_v[h * (long long)KW + kw];
        n += __popc(m);
        fr += __popc(m & obw[kw]);
      }
    }
    n_ext[i] = (float)n;
    fr_ext[i] = (float)fr;
  }
  bt_team_sync<kTeam>();

  // ---- per outcome: total tally, exact genotype / allele tallies, and
  // the k-mer sums over chains ----
  const int* tally = p.tally + (c * ch * S + s) * (long long)O;  // + x*S*O
  const long long xs = (long long)S * O;
  int dpart = 0;
  for (int o = tid; o < O; o += kTeam) {
    const int ha = p.oa[o], hb = p.ob[o];
    int to = 0;
    float nka = 0.f, fda = 0.f, fna = 0.f, nkb = 0.f, fdb = 0.f, fnb = 0.f;
    for (int x = 0; x < ch; ++x) {
      const int ti = tally[x * xs + o];
      to += ti;
      const float tv = (float)ti;
      const float na = n_ext[x * he + ha], nb = n_ext[x * he + hb];
      const float pa = na > 0.f ? 1.f : 0.f, pb = nb > 0.f ? 1.f : 0.f;
      nka += tv * na;
      nkb += tv * nb;
      fda += tv * pa;
      fdb += tv * pb;
      fna += tv * pa * (fr_ext[x * he + ha] / fmaxf(na, 1.f));
      fnb += tv * pb * (fr_ext[x * he + hb] / fmaxf(nb, 1.f));
    }
    tall[o] = to;
    per_o[o] = nka;
    per_o[O + o] = fda;
    per_o[2 * O + o] = fna;
    per_o[3 * O + o] = nkb;
    per_o[4 * O + o] = fdb;
    per_o[5 * O + o] = fnb;
    dpart += to;
    if (to == 0 || !valid) continue;
    const int a = al_ext[ha], bb = al_ext[hb];
    if (is_dip) {
      const int lo = min(a, bb), hi = max(a, bb);
      const int g = hi * (hi + 1) / 2 + lo;
      if (g >= 0 && g < G) atomicAdd(&gt_bins[g], to);
      if (a >= 0 && a < A) atomicAdd(&al_bins[a], to);
      if (a != bb && bb >= 0 && bb < A) atomicAdd(&al_bins[bb], to);
    } else {
      if (a >= 0 && a < G) atomicAdd(&gt_bins[a], to);
      if (a >= 0 && a < A) atomicAdd(&al_bins[a], to);
    }
  }
  if (dpart != 0) atomicAdd(&misc[0], dpart);
  bt_team_sync<kTeam>();
  const int denom = misc[0];
  const float denom_f = fmaxf((float)denom, 1.0f);

  // ---- NAK / FAK: per-outcome sums over chains, then per allele ----
  for (int a = 0; a < A; ++a) {
    bt_team_sums<kTeam, 4>(
        tid, O,
        [&](int j, float* acc) {
          for (int o = j; o < O; o += 256) {
            const float to = (float)tall[o];
            if (valid && al_ext[p.oa[o]] == a) {
              acc[0] += to;
              acc[1] += per_o[o];
              acc[2] += per_o[O + o];
              acc[3] += per_o[2 * O + o];
            }
            if (is_dip && valid && al_ext[p.ob[o]] == a) {
              acc[0] += to;
              acc[1] += per_o[3 * O + o];
              acc[2] += per_o[4 * O + o];
              acc[3] += per_o[5 * O + o];
            }
          }
        },
        red, sums + 4 * a);
  }
  const int na_v = p.num_alleles[c * V + v];
  for (int a = tid; a < A; a += kTeam) {
    const float calls = sums[4 * a], fd = sums[4 * a + 2];
    float nk = sums[4 * a + 1] / fmaxf(calls, 1.f);
    float fk = fd > 0.f ? sums[4 * a + 3] / fmaxf(fd, 1.f) : -1.f;
    const bool sub = p.missing != nullptr && a == na_v - 1 &&
                     bt_float_compare(nk, 0.f);
    if (sub) {
      nk = p.missing[cs];
      fk = p.missing[(long long)p.C * S + cs];
    }
    subst[a] = sub;
    nak[a] = nk;
    fak[a] = fk;
  }

  // ---- MAC over the top-T outcomes: the set bits of w & (hap_a | hap_b),
  // in ascending slot order ----
  const uint8_t* mrow = p.mult + c * (long long)K * H;
  const uint8_t* cnt = p.counts + c * (long long)K * S + s;    // + k*S
  const uint8_t* inter = p.inter + c * (long long)K * S + s;  // + k*S
  for (int i = tid; i < ch * T; i += kTeam) {
    const int x = i / T, t = i % T;
    const int o = sel[t];
    const int ha = p.oa[o], hb = p.ob[o];
    const unsigned* wx = wb + x * KW;
    const unsigned* hwa = hb_v + (long long)ha * KW;
    const unsigned* hwb = hb_v + (long long)hb * KW;
    float sa = 0.f, sb = 0.f;
    for (int kw = 0; kw < KW; ++kw) {
      const unsigned ba = ha < H ? hwa[kw] : 0u, bbits = hb < H ? hwb[kw] : 0u;
      unsigned m = wx[kw] & (ba | bbits);
      while (m != 0u) {
        const int bit = __ffs(m) - 1;
        m &= m - 1u;
        const int k = kw * 32 + bit;
        const int mt = (ha < H ? mrow[k * H + ha] : 0) +
                       (hb < H ? mrow[k * H + hb] : 0) + inter[k * S];
        const float val = (float)cnt[k * S] / fmaxf((float)mt, 1.f);
        if ((ba >> bit) & 1u) sa += val;
        if ((bbits >> bit) & 1u) sb += val;
      }
    }
    mn[i] = sa;
    mn[ch * T + i] = sb;
  }
  bt_team_sync<kTeam>();
  for (int a = 0; a < A; ++a) {
    bt_team_sums<kTeam, 2>(
        tid, ch * T,
        [&](int j, float* acc) {
          for (int i = j; i < ch * T; i += 256) {
            const int x = i / T, t = i % T;
            const int o = sel[t];
            const int ha = p.oa[o], hb = p.ob[o];
            const float ts = (float)tally[x * xs + o];
            const float na = n_ext[x * he + ha], nb = n_ext[x * he + hb];
            const float wa = (ha < H && al_ext[ha] == a && na > 0.f) ? ts : 0.f;
            const float wbt =
                (hb < H && al_ext[hb] == a && nb > 0.f) ? ts : 0.f;
            acc[0] += wa * (mn[i] / fmaxf(na, 1.f)) +
                      wbt * (mn[ch * T + i] / fmaxf(nb, 1.f));
            acc[1] += wa + wbt;
          }
        },
        red, msums + 2 * a);
  }
  for (int a = tid; a < A; a += kTeam) {
    float num = msums[2 * a];
    const float den = msums[2 * a + 1];
    if (p.mac_extra != nullptr) num += p.mac_extra[(cs * V + v) * A + a];
    float m = den > 0.f ? num / fmaxf(den, 1.f) : -1.f;
    if (subst[a] && m < 0.f) m = p.missing[2LL * p.C * S + cs];
    macv[a] = m;
    // SAF filter codes (Filters.cpp via the JAX package)
    const bool has_post = al_bins[a] > 0;
    int fl = (has_post && bt_float_less(nak[a], p.min_nak)) ? 1 : 0;
    if (has_post && !bt_float_compare(nak[a], 0.f) &&
        bt_float_less(fak[a], p.fak_thresh[s]))
      fl += 2;
    filt[a] = fl;
  }
  bt_team_sync<kTeam>();

  // ---- outputs ----
  const long long csv = cs * V + v;
  if (tid < 32) {
    // GT: the first genotype of highest tally and the number of genotypes
    // at that tally, over the team's first warp
    int max_t = INT_MIN, gmax = G;
    for (int g = tid; g < G; g += 32) {
      if (bt_before(gt_bins[g], g, max_t, gmax)) {
        max_t = gt_bins[g];
        gmax = g;
      }
    }
    bt_warp_first(max_t, gmax);
    int n_max = 0;
    for (int g = tid; g < G; g += 32) n_max += gt_bins[g] == max_t;
    for (int off = 16; off > 0; off >>= 1)
      n_max += __shfl_xor_sync(BT_FULL, n_max, off);
    if (tid == 0) {
      const float max_gpp = (float)max_t / denom_f;
      // triangular decode of gmax = hi * (hi + 1) / 2 + lo
      int ghi = 0;
      while ((ghi + 1) * (ghi + 2) / 2 <= gmax) ++ghi;
      const int glo = gmax - ghi * (ghi + 1) / 2;
      int gt_lo = is_dip ? glo : (is_hap ? gmax : -1);
      int gt_hi = is_dip ? ghi : -1;
      const bool thresh_ok = !bt_float_less(max_gpp, p.min_gpp);
      const int f_lo = filt[min(max(gt_lo, 0), A - 1)];
      const int f_hi = is_dip ? filt[min(max(gt_hi, 0), A - 1)] : 0;
      const bool called = n_max == 1 && thresh_ok && f_lo == 0 &&
                          f_hi == 0 && max_t > 0 && (is_dip || is_hap);
      gt_lo = called ? gt_lo : -1;
      gt_hi = (called && is_dip) ? gt_hi : -1;
      if (p.packed) {
        int8_t* gt = static_cast<int8_t*>(p.gt);
        gt[2 * csv] = (int8_t)gt_lo;
        gt[2 * csv + 1] = (int8_t)gt_hi;
        if (v == 0) p.denom[cs] = denom;
      } else {
        int* gt = static_cast<int*>(p.gt);
        gt[2 * csv] = gt_lo;
        gt[2 * csv + 1] = gt_hi;
        const float phred = -10.0f * log10f(fmaxf(1.0f - max_gpp, 1e-12f));
        p.gq[csv] = max_t == denom ? 99.0f : (max_t == 0 ? 0.0f : phred);
      }
    }
  }
  for (int g = tid; g < G; g += kTeam) {
    if (p.packed)
      p.gt_tally[csv * G + g] = gt_bins[g];
    else
      p.gpp[csv * G + g] = (float)gt_bins[g] / denom_f;
  }
  for (int a = tid; a < A; a += kTeam) {
    const long long i = csv * A + a;
    p.saf[i] = (uint8_t)filt[a];
    if (p.packed) {
      p.al_tally[i] = al_bins[a];
      __half* h16[3] = {static_cast<__half*>(p.nak), static_cast<__half*>(p.fak),
                        static_cast<__half*>(p.mac)};
      h16[0][i] = __float2half_rn(nak[a]);
      h16[1][i] = __float2half_rn(fak[a]);
      h16[2][i] = __float2half_rn(macv[a]);
    } else {
      p.app[i] = (float)al_bins[a] / denom_f;
      static_cast<float*>(p.nak)[i] = nak[a];
      static_cast<float*>(p.fak)[i] = fak[a];
      static_cast<float*>(p.mac)[i] = macv[a];
    }
  }
}

// The shape of a stats launch: its layout (0 all in shared memory, 1 the
// O- and H-sized arrays in device memory; -1 when not even that fits), its
// team (32: a warp per item, several a block; 256: a block per item), the
// threads and shared bytes of a block, the items of a block, the blocks of
// a wave (all unless layout 1), and the device scratch in 4-byte words.
struct BtStatsShape {
  int layout, team, threads, KW, P, team_words;
  size_t smem;
  long long blocks, wave, scratch_words;
};

static BtStatsShape bt_bucket_stats_shape(const BtStatsArgs& p) {
  BtStatsShape sh{};
  const long long items = (long long)p.C * p.S * p.V;
  sh.KW = (p.K + 31) / 32;
  sh.P = (p.O + BT_SEL_PART - 1) / BT_SEL_PART;
  const size_t small = (size_t)p.T + p.G + 3 * p.A + 4 + BT_ARG_WORDS +
                       2 * (size_t)p.ch * p.T + BT_RED_WORDS + 9 * p.A;
  const size_t sized = (size_t)bt_stats_row_words(p.O, p.H, p.ch);
  const size_t limit = (size_t)bt_smem_optin();
  const size_t whole = (small + sized) * 4;
  sh.scratch_words =
      (long long)p.C * sh.KW * (p.ch + p.S + (long long)p.V * p.H) +
      (long long)p.C * p.S * sh.P * p.T * 2;
  sh.wave = 0;
  if (p.O <= 32 && whole <= limit) {
    const int teams = (int)(limit / whole < 8 ? limit / whole : 8);
    sh.layout = 0;
    sh.team = 32;
    sh.threads = 32 * teams;
    sh.team_words = (int)(small + sized);
    sh.smem = teams * whole;
    sh.blocks = (items + teams - 1) / teams;
  } else if (whole <= limit) {
    sh.layout = 0;
    sh.team = sh.threads = 256;
    sh.team_words = (int)(small + sized);
    sh.smem = whole;
    sh.blocks = items;
  } else if (small * 4 <= limit) {
    sh.layout = 1;
    sh.team = sh.threads = 256;
    sh.team_words = (int)small;
    sh.smem = small * 4;
    sh.blocks = items;
    // waves of blocks whose scratch rows stay under 1 GB
    const long long rows = (1LL << 30) / (long long)(sized * 4);
    sh.wave = rows < 1 ? 1 : (rows < items ? rows : items);
    sh.scratch_words += sh.wave * (long long)sized;
  } else {
    sh.layout = -1;
  }
  if (sh.wave == 0) sh.wave = sh.blocks;
  return sh;
}

int bt_bucket_stats_layout(const BtStatsArgs& args, int64_t* scratch) {
  const BtStatsShape sh = bt_bucket_stats_shape(args);
  *scratch = sh.layout < 0 ? 0 : sh.scratch_words;
  return sh.layout;
}

template <int kLayout, int kTeam>
static cudaError_t bt_bucket_stats_launch(const BtStatsArgs& args,
                                          const BtStatsShape& sh,
                                          const BtStatsWork& work,
                                          cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bt_bucket_stats_kernel<kLayout, kTeam>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
  if (err != cudaSuccess) return err;
  const long long per_block = sh.threads / kTeam;
  for (long long b0 = 0; b0 < sh.blocks; b0 += sh.wave) {
    const long long n = sh.blocks - b0 < sh.wave ? sh.blocks - b0 : sh.wave;
    bt_bucket_stats_kernel<kLayout, kTeam>
        <<<(unsigned)n, sh.threads, sh.smem, stream>>>(args, work,
                                                       b0 * per_block);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

cudaError_t bt_bucket_stats(const BtStatsArgs& args, float* scratch,
                            cudaStream_t stream) {
  const BtStatsArgs& p = args;
  if ((long long)p.C * p.S * p.V == 0) return cudaSuccess;
  const BtStatsShape sh = bt_bucket_stats_shape(p);
  if (sh.layout < 0 || scratch == nullptr) return cudaErrorInvalidValue;
  BtStatsWork work;
  work.KW = sh.KW;
  work.P = sh.P;
  work.team_words = sh.team_words;
  work.wbits = reinterpret_cast<unsigned*>(scratch);
  work.obits = work.wbits + (long long)p.C * p.ch * sh.KW;
  work.hbits = work.obits + (long long)p.C * p.S * sh.KW;
  work.cand = reinterpret_cast<int*>(work.hbits +
                                     (long long)p.C * p.V * p.H * sh.KW);
  work.rows = reinterpret_cast<float*>(work.cand +
                                       (long long)p.C * p.S * sh.P * p.T * 2);
  const long long word_warps = (long long)p.C * sh.KW;
  if (word_warps > 0) {
    bt_stats_words_kernel<<<(unsigned)((word_warps + 7) / 8), 256, 0,
                            stream>>>(p, work);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long sel_warps = (long long)p.C * p.S * sh.P;
  bt_stats_select_kernel<<<(unsigned)((sel_warps + BT_SEL_WARPS - 1) /
                                      BT_SEL_WARPS),
                           32 * BT_SEL_WARPS, 0, stream>>>(p, work);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (sh.layout == 1)
    return bt_bucket_stats_launch<1, 256>(p, sh, work, stream);
  if (sh.team == 32) return bt_bucket_stats_launch<0, 32>(p, sh, work, stream);
  return bt_bucket_stats_launch<0, 256>(p, sh, work, stream);
}
