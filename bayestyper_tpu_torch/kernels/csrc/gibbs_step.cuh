// One Gibbs iteration for a block's (cluster, chain) pairs, run by the
// whole block over the pairs' state in shared memory. Used by gibbs_sweep.cu
// (all iterations of the frozen-noise scan), noise_body.cuh (noise_step and
// joint_step: one noise-chain iteration per launch) and nested_sweep.cu
// (the coupled scan, one step per rank level and iteration).
//
// Replaces the body of gibbs._gibbs_iteration + _sample_outcomes +
// sampling.sample_frequencies / fixed_round_gamma (bayestyper_tpu/model/
// gibbs.py:528-645, ops/sampling.py:35-222), which XLA ran as a vmapped scan
// body. Bound: operations (the S*O logits and exps, the threefry hashes,
// the lgammas of the size draw) and, per phase, the latency of its longest
// sequential chain; so the step keeps every lane busy and its chains short.
//
// A block owns np consecutive pairs (np = 1 for O > 128), and every phase of
// the step loops over the flattened (pair, item) space of the whole block:
// (pair, sample) rows for the categorical draw, (pair, sample, outcome) for
// cached logits and exps, (pair, haplotype) for the gkeys and gamma draws,
// (pair, t) for the size draw's log-probabilities, (pair, key) for the key
// derivations, pairs for the per-pair scans. So a warp's lanes work on up
// to 32 items of several pairs at once, where a warp per pair left most of
// them idle (2 of 32 lanes for the gamma draws at H2).
//
// Same bits as a team per pair: each value is computed by one thread from
// the same operands in the same order. Each pair-step's keys are derived
// once, two levels deep on their own threads (k_cat, k_freq from
// fold_in(chain, t); then k_size, k_sel, k_gam and the gamma draws' k_boost,
// k_norm, k_unif beside the categorical draw), and each random number as
// soon as its key is known. Each logit and exp is computed once: up to 16
// outcomes in a row thread's registers, else into a shared exp cache; the
// max, the exp-sum and the running inverse CDF of a sample stay sequential
// over o in one thread, over the same float32 values. The haplotype counts
// are integer shared-memory atomics (exact in any order). Large outcome
// spaces (O > 128) use the two-level inverse CDF of the JAX package: block
// maxima and block sums over (64-outcome block, sample) threads, samples
// fastest (neighbouring samples on neighbouring banks), then the draw
// within the chosen block; with every exp cached (BtDims::X) the logits
// and exps are computed over (sample, outcome), else the chosen block's 64
// exps of every sample in parallel and one thread per sample scans them.
#pragma once

#include "launchers.h"
#include "threefry.cuh"

#define BT_NEG_INF (-1e30f)
#define BT_ONELEVEL_MAX_O 128
#define BT_OBLOCK 64
#define BT_LOG2 0.693147182f
// threads of a block of pairs (O <= 128), before the register fit
#define BT_PACK_THREADS 256

// a pair's keys for one step, in its row of BtPairs::keys
enum {
  BT_K_CHAIN, BT_K_CAT, BT_K_FREQ, BT_K_SIZE, BT_K_SEL, BT_K_GAM,
  BT_K_BOOST, BT_K_NORM, BT_K_UNIF, BT_NKEYS
};
// a pair's integer scalars (BtPairs::isc) and float scalars (fsc)
enum { BT_I_RAW, BT_I_EXPAND, BT_I_SPARSE, BT_I_CHAIN, BT_NISC };
enum { BT_F_SPARSITY, BT_F_USIZE, BT_NFSC = 4 };

// n / d for 0 <= n < 2^31 without a division instruction: the quotient
// of a multiply by floor((2^32 - 1) / d), corrected once.
struct BtDiv {
  unsigned d, m;
  __host__ __device__ void set(int dd) {
    d = (unsigned)dd;
    m = 0xFFFFFFFFu / d;
  }
  __device__ __forceinline__ int operator()(int n) const {
    unsigned q = __umulhi((unsigned)n, m);
    if ((unsigned)n - q * d >= d) ++q;
    return (int)q;
  }
};

struct BtDims {
  int S, O, H, P, G;  // samples, outcomes, haplotypes, diploid pairs, O blocks
  // the exp cache holds every outcome of a sample (X; always for O <= 128)
  // or only its chosen 64-outcome block; E is its row stride (odd: no bank
  // conflicts between the rows of neighbouring threads)
  bool X;
  int E;
  BtDiv dS, dH, dH1;  // divisions by S, H and H + 1
};

__host__ __device__ inline bool bt_two_level(int O) {
  return O > BT_ONELEVEL_MAX_O;
}

// full: cache every outcome's exp also for O > 128 (bt_launch_shape takes
// it where it fits)
__host__ __device__ inline BtDims bt_dims(int S, int O, int H,
                                          bool full = false) {
  BtDims d;
  d.S = S;
  d.O = O;
  d.H = H;
  d.P = H * (H + 1) / 2;
  d.G = (O + BT_OBLOCK - 1) / BT_OBLOCK;
  d.X = full || !bt_two_level(O);
  d.E = d.X ? (O | 1) : BT_OBLOCK + 1;
  d.dS.set(S);
  d.dH.set(H);
  d.dH1.set(H + 1);
  return d;
}

// per-pair words besides the LL, in 4-byte words
__host__ __device__ inline int bt_team_small_words(const BtDims& d) {
  return 4 * (d.H + 1)                           // logf, logp, pexp, freqs
         + 2 * d.H                               // gkey, gam
         + (bt_two_level(d.O) ? 2 * d.S * d.G : 0)  // bmax, bsum
         + d.S                                   // mrow
         + 2 * d.H                               // gamma round 0: gx, gu
         + BT_NFSC                               // float scalars
         + d.S * d.E                             // exp cache
         + 2 * d.H                               // hapc, hvalid
         + 2 * d.S                               // osel, ploidy
         + BT_NISC                               // integer scalars
         + 2 * BT_NKEYS;                         // keys
}

// per-pair words of the shared layout: the LL [S, O] and the rest
__host__ __device__ inline int bt_team_words(const BtDims& d) {
  return d.S * d.O + bt_team_small_words(d);
}

// shared words of the packed outcome table (bt_load_outcomes)
__host__ __device__ inline int bt_outcome_words(int O) {
  return O + O / BT_OBLOCK + 1;
}

// A block's pairs' arrays, each [np, length] (freqs, logf, logp, pexp
// [np, H + 1]; ll [np, S, O]; ex [np, S, E]; bmax, bsum [np, G, S]).
struct BtPairs {
  float *ll, *ex, *logf, *logp, *pexp, *freqs, *gkey, *gam, *bmax, *bsum,
      *mrow, *gx, *gu, *fsc;
  int *hapc, *hvalid, *osel, *ploidy, *isc;
  unsigned* keys;
};

// The arrays of np pairs from base, their LL at ll; base and ll may lie in
// shared or in device memory (the global-memory variants, bt_launch_shape).
__device__ inline BtPairs bt_carve_pairs(float* base, float* ll,
                                         const BtDims& d, int np) {
  BtPairs m;
  float* p = base;
  const int h1 = np * (d.H + 1), sg = bt_two_level(d.O) ? np * d.S * d.G : 0;
  m.ll = ll;
  m.logf = p;   p += h1;
  m.logp = p;   p += h1;
  m.pexp = p;   p += h1;
  m.freqs = p;  p += h1;
  m.gkey = p;   p += np * d.H;
  m.gam = p;    p += np * d.H;
  m.bmax = p;   p += sg;
  m.bsum = p;   p += sg;
  m.mrow = p;   p += np * d.S;
  m.gx = p;     p += np * d.H;
  m.gu = p;     p += np * d.H;
  m.fsc = p;    p += np * BT_NFSC;
  m.ex = p;     p += np * d.S * d.E;
  int* q = reinterpret_cast<int*>(p);
  m.hapc = q;   q += np * d.H;
  m.hvalid = q; q += np * d.H;
  m.osel = q;   q += np * d.S;
  m.ploidy = q; q += np * d.S;
  m.isc = q;    q += np * BT_NISC;
  m.keys = reinterpret_cast<unsigned*>(q);
  return m;
}

__device__ __forceinline__ BtKey bt_key(const BtPairs& sm, int p, int k) {
  const unsigned* w = sm.keys + 2 * (p * BT_NKEYS + k);
  return BtKey{w[0], w[1]};
}

__device__ __forceinline__ void bt_set_key(const BtPairs& sm, int p, int k,
                                           BtKey v) {
  unsigned* w = sm.keys + 2 * (p * BT_NKEYS + k);
  w[0] = v.k0;
  w[1] = v.k1;
}

// The outcome tables: packed (a | b << 16) in shared memory with a pad
// word per 64 outcomes, so the threads of the two-level phases (one block
// each, 64 outcomes apart) read distinct banks; or oa/ob in device memory.
struct BtOutcomes {
  const int* oab;
  const int *oa, *ob;
  __device__ __forceinline__ void at(int o, int& a, int& b) const {
    if (oab != nullptr) {
      const int v = oab[o + o / BT_OBLOCK];
      a = v & 0xFFFF;
      b = v >> 16;
    } else {
      a = oa[o];
      b = ob[o];
    }
  }
};

// Block-level copy of the outcome tables into smem (bt_outcome_words);
// the caller synchronises before the first read.
__device__ inline BtOutcomes bt_load_outcomes(const int* oa, const int* ob,
                                              int O, int* smem) {
  for (int o = threadIdx.x; o < O; o += blockDim.x)
    smem[o + o / BT_OBLOCK] = oa[o] | (ob[o] << 16);
  return BtOutcomes{smem, oa, ob};
}

// The block: its thread, its threads and how many pairs it holds.
struct BtBlock {
  int tid, nt, np;
};

// (row, column) of a flat index over rows of C columns, advanced by a
// block-wide stride without a division per step.
struct BtRowCol {
  int r, c, dr, dc, C;
  __device__ BtRowCol(int start, int step, int cols)
      : r(start / cols), c(start % cols), dr(step / cols), dc(step % cols),
        C(cols) {}
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= C) {
      c -= C;
      ++r;
    }
  }
};

__device__ __forceinline__ bool bt_outcome_valid(int ploidy, int o,
                                                 const BtDims& d) {
  if (ploidy == 2) return o < d.P;
  if (ploidy == 1) return o >= d.P && o < d.P + d.H;
  return o == d.O - 1;
}

// logits[s, o] of gibbs._gibbs_iteration: prior(o) + ll[s, o] on the
// sample's ploidy block, NEG_INF elsewhere; lf and llrow are the pair's
// log-frequencies and the sample's LL row
__device__ __forceinline__ float bt_logit(const BtDims& d,
                                          const BtOutcomes& oc,
                                          const float* lf, const float* llrow,
                                          int pl, int o) {
  if (!bt_outcome_valid(pl, o, d)) return BT_NEG_INF;
  int a, b;
  oc.at(o, a, b);
  const float het = (o < d.P && a != b) ? BT_LOG2 : 0.0f;
  const float prior = (lf[a] + lf[b]) + het;
  return prior + llrow[o];
}

// The draw from O max-shifted exps read through at(o): the exp-sum and the
// running inverse CDF, sequential over o.
template <typename At>
__device__ __forceinline__ int bt_inverse_cdf(int O, float u01, At at) {
  float total = 0.0f;
  for (int o = 0; o < O; ++o) total += at(o);
  const float u = u01 * total;
  float c = 0.0f;
  int cnt = 0;
  for (int o = 0; o < O; ++o) {
    c += at(o);
    cnt += (c <= u);
  }
  return cnt;
}

// Adds the drawn outcome's haplotypes to pair p's counts (integer
// shared-memory atomics: exact in any order).
__device__ __forceinline__ void bt_count_haps(const BtPairs& sm,
                                              const BtDims& d,
                                              const BtOutcomes& oc, int p,
                                              int o) {
  int a, b;
  oc.at(o, a, b);
  if (a < d.H) atomicAdd(sm.hapc + p * d.H + a, 1);
  if (b < d.H) atomicAdd(sm.hapc + p * d.H + b, 1);
}

// Up to BT_REG_MAX_O outcomes: one thread per (pair, sample) row keeps the
// row's logits and exps in registers.
#define BT_REG_MAX_O 16
template <class Rand>
__device__ inline void bt_draw_rows_in_registers(const BtBlock& bk,
                                                 const BtPairs& sm,
                                                 const BtDims& d,
                                                 const BtOutcomes& oc,
                                                 const Rand& rnd) {
  const int S = d.S, O = d.O, H1 = d.H + 1;
  for (int row = bk.tid; row < bk.np * S; row += bk.nt) {
    const int p = d.dS(row), pl = sm.ploidy[row];
    const float* lf = sm.logf + p * H1;
    const float* llrow = sm.ll + row * O;
    float v[BT_REG_MAX_O];
    float m = -INFINITY;
#pragma unroll
    for (int o = 0; o < BT_REG_MAX_O; ++o) {
      if (o < O) {
        v[o] = bt_logit(d, oc, lf, llrow, pl, o);
        m = fmaxf(m, v[o]);
      }
    }
#pragma unroll
    for (int o = 0; o < BT_REG_MAX_O; ++o)
      if (o < O) v[o] = expf(v[o] - m);
    float total = 0.0f;
#pragma unroll
    for (int o = 0; o < BT_REG_MAX_O; ++o)
      if (o < O) total += v[o];
    const float u = rnd.u_cat(sm, p, row - p * S) * total;
    float c = 0.0f;
    int cnt = 0;
#pragma unroll
    for (int o = 0; o < BT_REG_MAX_O; ++o) {
      if (o < O) {
        c += v[o];
        cnt += (c <= u);
      }
    }
    sm.osel[row] = cnt;
    bt_count_haps(sm, d, oc, p, cnt);
  }
}

// The second level of keys: k_size, k_sel, k_gam = fold_in(k_freq, 0..2)
// and the gamma draws' k_boost, k_norm, k_unif = fold_in(k_gam, 0..2).
__device__ __forceinline__ void bt_keys_from_freq(const BtBlock& bk,
                                                  const BtPairs& sm) {
  for (int i = bk.tid; i < 6 * bk.np; i += bk.nt) {
    const int p = i / 6, j = i - 6 * p;
    BtKey k = bt_key(sm, p, BT_K_FREQ);
    if (j >= 3) k = bt_fold_in(k, 2u);
    bt_set_key(sm, p, j < 3 ? BT_K_SIZE + j : BT_K_BOOST + (j - 3),
               bt_fold_in(k, (uint32_t)(j % 3)));
  }
}

// The step's keys and random numbers: derived in the step from each pair's
// chain key (BtDeriveRand, the default), or read from a record that a
// producer warp derived ahead (nested_sweep.cu); and the size draw's
// lgamma of small integers, computed or looked up in a table of the same
// lgammaf values. Either gives the same bits.
struct BtDeriveRand {
  // k_cat, k_freq = fold_in(fold_in(chain, t), 0..1)
  __device__ void keys(const BtBlock& bk, const BtPairs& sm, int t) const {
    for (int i = bk.tid; i < 2 * bk.np; i += bk.nt)
      bt_set_key(sm, i >> 1, BT_K_CAT + (i & 1),
                 bt_fold_in(bt_fold_in(bt_key(sm, i >> 1, BT_K_CHAIN),
                                       (uint32_t)t),
                            (uint32_t)(i & 1)));
  }
  __device__ void keys2(const BtBlock& bk, const BtPairs& sm) const {
    bt_keys_from_freq(bk, sm);
  }
  __device__ float u_cat(const BtPairs& sm, int p, int s) const {
    return bt_uniform(bt_key(sm, p, BT_K_CAT), (uint32_t)s);
  }
  __device__ float u_sel(const BtPairs& sm, int p, int h) const {
    return bt_uniform(bt_key(sm, p, BT_K_SEL), (uint32_t)h);
  }
  __device__ float gx(const BtPairs& sm, int p, int h) const {
    return bt_gamma_normal0(bt_key(sm, p, BT_K_NORM), h);
  }
  __device__ float gu(const BtPairs& sm, int p, int h) const {
    return bt_gamma_uniform0(bt_key(sm, p, BT_K_UNIF), h);
  }
  __device__ float u_size(const BtPairs& sm, int p) const {
    return bt_uniform(bt_key(sm, p, BT_K_SIZE), 0u);
  }
  __device__ float lgamma(float x) const { return lgammaf(x); }
};

// The barrier between the step's phases: the block's (the default), or
// the consumer warps' of a block that also holds a producer.
struct BtSyncBlock {
  __device__ void operator()() const { __syncthreads(); }
};

// Draws o_sel[s] for every sample of every pair of the block into sm.osel
// and resamples sm.freqs, at iteration t of each pair's chain key
// (sm.keys[BT_K_CHAIN]). Every thread that sync() joins calls it (bk
// numbers them), after a barrier that follows the last write of the pairs'
// state. Each key level and each random number is derived (BtDeriveRand)
// where its parent key is first known, beside the phase that runs then.
template <class Rand = BtDeriveRand, class Sync = BtSyncBlock>
__device__ inline void bt_gibbs_step(const BtBlock& bk, const BtPairs& sm,
                                     const BtDims& d, const BtOutcomes& oc,
                                     int t, const Rand& rnd = Rand(),
                                     Sync sync = Sync()) {
  const int S = d.S, O = d.O, H = d.H, E = d.E, H1 = d.H + 1, np = bk.np;
  const int rows = np * S;
  const bool two = bt_two_level(O);
  const int SG = S * d.G;

  // ---- log-frequencies; zero counts; k_cat, k_freq from
  // fold_in(chain, t) ----
  for (int i = bk.tid; i < np * H1; i += bk.nt) {
    const int h = i - d.dH1(i) * H1;
    float lf = 0.0f;
    if (h < H) {
      const float f = sm.freqs[i];
      lf = f > 0.0f ? logf(fmaxf(f, 1e-30f)) : BT_NEG_INF;
    }
    sm.logf[i] = lf;
  }
  for (int i = bk.tid; i < np * H; i += bk.nt) sm.hapc[i] = 0;
  rnd.keys(bk, sm, t);
  sync();

  // ---- categorical outcome per sample: max-shifted inverse CDF; beside
  // it the second key level ----
  rnd.keys2(bk, sm);
  if (!two && O <= BT_REG_MAX_O) {
    bt_draw_rows_in_registers(bk, sm, d, oc, rnd);
  } else if (!two) {
    // logits into the exp cache, each row's max, the exps, the draw
    for (BtRowCol it(bk.tid, bk.nt, O); it.r < rows; it.next())
      sm.ex[it.r * E + it.c] =
          bt_logit(d, oc, sm.logf + d.dS(it.r) * H1, sm.ll + it.r * O,
                   sm.ploidy[it.r], it.c);
    sync();
    for (int row = bk.tid; row < rows; row += bk.nt) {
      const float* e = sm.ex + row * E;
      float m = -INFINITY;
      for (int o = 0; o < O; ++o) m = fmaxf(m, e[o]);
      sm.mrow[row] = m;
    }
    sync();
    for (BtRowCol it(bk.tid, bk.nt, O); it.r < rows; it.next()) {
      float* e = sm.ex + it.r * E + it.c;
      *e = expf(*e - sm.mrow[it.r]);
    }
    sync();
    for (int row = bk.tid; row < rows; row += bk.nt) {
      const int p = d.dS(row);
      const float* e = sm.ex + row * E;
      const int o = bt_inverse_cdf(O, rnd.u_cat(sm, p, row - p * S),
                                   [e](int k) { return e[k]; });
      sm.osel[row] = o;
      bt_count_haps(sm, d, oc, p, o);
    }
  } else {
    // two levels: block maxima (thread (block, sample), samples fastest),
    // each sample's maximum, block sums, the block of the draw, then the
    // draw within it; with every exp cached (X) the logits and exps are
    // computed once over (sample, outcome)
    const int G = d.G;
    if (d.X) {
      for (BtRowCol it(bk.tid, bk.nt, O); it.r < rows; it.next())
        sm.ex[it.r * E + it.c] =
            bt_logit(d, oc, sm.logf + d.dS(it.r) * H1, sm.ll + it.r * O,
                     sm.ploidy[it.r], it.c);
      sync();
    }
    for (int i = bk.tid; i < np * SG; i += bk.nt) {
      const int p = i / SG, g = (i % SG) / S, row = p * S + i % S;
      const int o0 = g * BT_OBLOCK, o1 = min(O, o0 + BT_OBLOCK);
      float m = -INFINITY;
      if (d.X) {
        const float* e = sm.ex + row * E;
#pragma unroll 8
        for (int o = o0; o < o1; ++o) m = fmaxf(m, e[o]);
      } else {
        const int pl = sm.ploidy[row];
        const float* lf = sm.logf + p * H1;
        const float* llrow = sm.ll + row * O;
#pragma unroll 8
        for (int o = o0; o < o1; ++o)
          m = fmaxf(m, bt_logit(d, oc, lf, llrow, pl, o));
      }
      sm.bmax[i] = m;
    }
    sync();
    for (int row = bk.tid; row < rows; row += bk.nt) {
      const int p = d.dS(row), s = row - p * S;
      float m = -INFINITY;
      for (int g = 0; g < G; ++g) m = fmaxf(m, sm.bmax[p * SG + g * S + s]);
      sm.mrow[row] = m;
    }
    sync();
    if (d.X) {
      for (BtRowCol it(bk.tid, bk.nt, O); it.r < rows; it.next()) {
        float* e = sm.ex + it.r * E + it.c;
        *e = expf(*e - sm.mrow[it.r]);
      }
      sync();
    }
    for (int i = bk.tid; i < np * SG; i += bk.nt) {
      const int p = i / SG, g = (i % SG) / S, row = p * S + i % S;
      const int o0 = g * BT_OBLOCK, o1 = min(O, o0 + BT_OBLOCK);
      float acc = 0.0f;
      if (d.X) {
        const float* e = sm.ex + row * E;
#pragma unroll 8
        for (int o = o0; o < o1; ++o) acc += e[o];
      } else {
        const int pl = sm.ploidy[row];
        const float* lf = sm.logf + p * H1;
        const float* llrow = sm.ll + row * O;
        const float m = sm.mrow[row];
#pragma unroll 8
        for (int o = o0; o < o1; ++o)
          acc += expf(bt_logit(d, oc, lf, llrow, pl, o) - m);
      }
      sm.bsum[i] = acc;
    }
    sync();
    // the block of each sample's draw (osel, for now) and the remainder
    // left for it (bmax, free from here)
    for (int row = bk.tid; row < rows; row += bk.nt) {
      const int p = d.dS(row), s = row - p * S;
      const float* bs = sm.bsum + p * SG + s;
      float total = 0.0f;
      for (int g = 0; g < G; ++g) total += bs[g * S];
      const float u = rnd.u_cat(sm, p, s) * total;
      float run = 0.0f;
      int cnt = 0;
      for (int g = 0; g < G; ++g) {
        run += bs[g * S];
        cnt += (run <= u);
      }
      const int gi = min(cnt, G - 1);
      float bcs = 0.0f;
      for (int g = 0; g <= gi; ++g) bcs += bs[g * S];
      sm.bmax[p * SG + s] = u - (bcs - bs[gi * S]);
      sm.osel[row] = gi;
    }
    sync();
    if (!d.X) {
      // the chosen block's exps, recomputed once each
      for (BtRowCol it(bk.tid, bk.nt, BT_OBLOCK); it.r < rows; it.next()) {
        const int p = d.dS(it.r);
        const int o = sm.osel[it.r] * BT_OBLOCK + it.c;
        sm.ex[it.r * E + it.c] =
            o < O ? expf(bt_logit(d, oc, sm.logf + p * H1, sm.ll + it.r * O,
                                  sm.ploidy[it.r], o) -
                         sm.mrow[it.r])
                  : 0.0f;
      }
      sync();
    }
    for (int row = bk.tid; row < rows; row += bk.nt) {
      const int p = d.dS(row), s = row - p * S;
      const int o0 = sm.osel[row] * BT_OBLOCK;
      const float* e = sm.ex + row * E + (d.X ? o0 : 0);
      const float rem = sm.bmax[p * SG + s];
      const int n_in = d.X ? min(BT_OBLOCK, O - o0) : BT_OBLOCK;
      float l = 0.0f;
      int j = 0;
      for (int jj = 0; jj < BT_OBLOCK; ++jj) {
        l += jj < n_in ? e[jj] : 0.0f;
        j += (l <= rem);
      }
      const int o = min(o0 + min(j, BT_OBLOCK - 1), O - 1);
      sm.osel[row] = o;
      bt_count_haps(sm, d, oc, p, o);
    }
  }
  sync();

  // ---- spike-and-slab frequency resample (sample_frequencies): the size
  // draw's log-probabilities, each item summing the pair's counts itself;
  // the gkeys; the gamma draws' first round and the size uniform ----
  for (int i = bk.tid; i < np * H1; i += bk.nt) {
    const int p = d.dH1(i), tt = i - p * H1;
    int n_raw = 0, n_plus = 0, n_total = 0, n_valid = 0;
    for (int h = p * H; h < (p + 1) * H; ++h) {
      const int c = sm.hvalid[h] ? sm.hapc[h] : 0;
      n_raw += sm.hapc[h];
      n_plus += c > 0;
      n_total += c;
      n_valid += sm.hvalid[h];
    }
    if (tt == 0) sm.isc[p * BT_NISC + BT_I_RAW] = n_raw;
    if (n_raw == 0) continue;  // nothing observed: frequencies stay
    const float sparsity = sm.fsc[p * BT_NFSC + BT_F_SPARSITY];
    const float np_f = (float)n_plus, nv = (float)n_valid,
                nt = (float)n_total;
    const float tf = (float)tt;
    const float j = np_f + tf;
    const float log_card =
        (rnd.lgamma(nv - np_f + 1.0f) - rnd.lgamma(tf + 1.0f)) -
        rnd.lgamma(nv - j + 1.0f);
    const float log_prior = j * logf(sparsity) + (nv - j) * log1pf(-sparsity);
    const float log_assign = rnd.lgamma(j) - rnd.lgamma(nt + j);
    const float lp = (log_card + log_prior) + log_assign;
    sm.logp[i] = j <= nv ? lp : BT_NEG_INF;
  }
  for (int i = bk.tid; i < np * H; i += bk.nt) {
    const int p = d.dH(i), h = i - p * H;
    const bool elig = sm.hvalid[i] && sm.hapc[i] == 0;
    sm.gkey[i] = elig ? rnd.u_sel(sm, p, h) : -1.0f;
    if (sm.hvalid[i]) {
      sm.gx[i] = rnd.gx(sm, p, h);
      sm.gu[i] = rnd.gu(sm, p, h);
    }
  }
  for (int p = bk.tid; p < np; p += bk.nt)
    sm.fsc[p * BT_NFSC + BT_F_USIZE] = rnd.u_size(sm, p);
  sync();
  for (int i = bk.tid; i < np * H1; i += bk.nt) {
    const int p = d.dH1(i);
    if (sm.isc[p * BT_NISC + BT_I_RAW] == 0) continue;
    const float* lp = sm.logp + p * H1;
    float m = -INFINITY;
    for (int tt = 0; tt <= H; ++tt) m = fmaxf(m, lp[tt]);
    sm.pexp[i] = expf(sm.logp[i] - m);
  }
  sync();
  for (int p = bk.tid; p < np; p += bk.nt) {
    int* sc = sm.isc + p * BT_NISC;
    if (sc[BT_I_RAW] == 0) continue;
    const float* e = sm.pexp + p * H1;
    sc[BT_I_EXPAND] = bt_inverse_cdf(H1, sm.fsc[p * BT_NFSC + BT_F_USIZE],
                                     [e](int k) { return e[k]; });
  }
  sync();
  for (int i = bk.tid; i < np * H; i += bk.nt) {
    const int p = d.dH(i), h = i - p * H;
    const int* sc = sm.isc + p * BT_NISC;
    if (sc[BT_I_RAW] == 0) continue;
    const bool valid = sm.hvalid[i] != 0;
    const int c = valid ? sm.hapc[i] : 0;
    const bool plus = c > 0;
    const float* gk = sm.gkey + p * H;
    const float g = gk[h];
    int rank = 0;
    for (int jh = 0; jh < H; ++jh) rank += gk[jh] > g;
    const bool expand = valid && !plus && rank < sc[BT_I_EXPAND];
    const bool active = sc[BT_I_SPARSE] ? (plus || expand) : valid;
    const float a = active ? (float)c + 1.0f : 1.0f;
    sm.gam[i] = active ? bt_fixed_round_gamma_keys(
                             bt_key(sm, p, BT_K_BOOST),
                             bt_key(sm, p, BT_K_NORM),
                             bt_key(sm, p, BT_K_UNIF), a, h, H, sm.gx[i],
                             sm.gu[i])
                       : 0.0f;
  }
  sync();
  for (int i = bk.tid; i < np * H; i += bk.nt) {
    const int p = d.dH(i), h = i - p * H;
    if (sm.isc[p * BT_NISC + BT_I_RAW] == 0) continue;
    const float* gm = sm.gam + p * H;
    float total = 0.0f;
    for (int jh = 0; jh < H; ++jh) total += gm[jh];
    sm.freqs[p * H1 + h] = gm[h] / fmaxf(total, 1e-30f);
  }
  sync();
}

// Loads a block's pairs' per-cluster inputs and chain keys
// fold_in(fold_in(base_keys[chain], cluster_id), fold[chain]); pairs are
// (cluster, chain) rows from pair0.
__device__ inline void bt_load_pairs(
    const BtBlock& bk, const BtPairs& sm, const BtDims& d, long long pair0,
    int ch, const signed char* ploidy, const bool* hap_valid,
    const float* freqs, const float* sparsity, const bool* use_sparse,
    const int64_t* cluster_id, const unsigned* base_keys,
    const unsigned* fold) {
  const int S = d.S, H = d.H;
  for (int i = bk.tid; i < bk.np * S; i += bk.nt) {
    const int p = d.dS(i);
    sm.ploidy[i] = ploidy[(pair0 + p) / ch * S + (i - p * S)];
  }
  for (int i = bk.tid; i < bk.np * H; i += bk.nt) {
    const int p = d.dH(i), h = i - p * H;
    sm.hvalid[i] = hap_valid[(pair0 + p) / ch * H + h];
    sm.freqs[p * (H + 1) + h] = freqs[pair0 * H + i];
  }
  for (int p = bk.tid; p < bk.np; p += bk.nt) {
    const long long cl = (pair0 + p) / ch;
    const int chn = (int)((pair0 + p) % ch);
    sm.fsc[p * BT_NFSC + BT_F_SPARSITY] = sparsity[cl];
    sm.isc[p * BT_NISC + BT_I_SPARSE] = use_sparse[cl];
    sm.isc[p * BT_NISC + BT_I_CHAIN] = chn;
    bt_set_key(sm, p, BT_K_CHAIN,
               bt_fold_in(bt_fold_in(BtKey{base_keys[2 * chn],
                                           base_keys[2 * chn + 1]},
                                     (uint32_t)cluster_id[cl]),
                          fold[chn]));
  }
}

// Writes the block's frequencies back to freqs [pairs, H].
__device__ inline void bt_store_freqs(const BtBlock& bk, const BtPairs& sm,
                                      const BtDims& d, long long pair0,
                                      float* freqs) {
  for (int i = bk.tid; i < bk.np * d.H; i += bk.nt) {
    const int p = d.dH(i);
    freqs[pair0 * d.H + i] = sm.freqs[p * (d.H + 1) + (i - p * d.H)];
  }
}

// Launch shape shared by the Gibbs kernels. A block holds pairs_per_block
// consecutive pairs for O <= 128 and one pair above (a block team). The
// layout is the first of these that fits the card's opt-in shared memory
// per block (bt_smem_optin) for one pair:
//   0  shared: the packed outcome table and each pair's LL and arrays in
//      shared memory (bt_team_words) with every outcome's exp cached (X);
//   1X for O > 128, global LL with every exp cached: the LL read from
//      (gibbs_sweep) or written to (the noise kernels, a [pairs, S, O]
//      scratch) device memory once per step, the pair's arrays and the
//      outcome table in shared memory (H64 at S = 13-24: the LL stays in
//      L2);
//   0  shared, caching only the chosen 64-outcome block's exps;
//   1  global LL, the chosen block's exps, the outcome table in shared
//      memory where it fits, else read from device memory
//      (bt_team_small_words: ~26 KB at S = 64, H = 64);
//   2  global team: the rest of the pair in a [pairs, small words] scratch
//      too (from ~H512 at S = 30), no shared memory; block teams only.
// Pairs per block: enough that the (pair, sample) phases fill
// BT_PACK_THREADS threads, no more than give every SM two blocks, and few
// enough that two blocks' shared memory fits one SM. A block team that
// caches every exp is sized to its (sample, outcome) phases, up to 1,024
// threads. With tally, a [pairs, S, O] uint16 tally follows in shared
// memory where it fits (tally_smem). Every shape runs the same
// bt_gibbs_step on the same values in the same order, so with -fmad=false
// they give the same bits. Layout -1: a pair too wide.
struct BtLaunch {
  BtDims d;  // with the exp cache the layout holds (BtDims::X)
  int threads, pairs_per_block;
  bool block_team;
  int layout;
  bool tables_smem;  // the packed outcome table first in shared memory
  size_t smem_bytes;
  // per pair, in 4-byte words, of the caller's device-memory scratch: the
  // LL (layouts 1-2 when the kernel writes it) then the pair's arrays
  // (layout 2), as two regions [pairs, ll_scratch] and [pairs, team_scratch]
  long long ll_scratch, team_scratch;
  bool tally_smem;
  int tally_offset;  // words from the start of shared memory
};

inline BtLaunch bt_launch_shape(int S, int O, int H, bool ll_written,
                                long long n_pairs = 0, bool tally = false) {
  BtLaunch l;
  const long long limit = bt_smem_optin() / 4;  // words
  const long long tables = bt_outcome_words(O);
  const BtDims dx = bt_dims(S, O, H, true), dp = bt_dims(S, O, H);
  const bool two = bt_two_level(O);
  l.block_team = two;
  l.pairs_per_block = 1;
  l.ll_scratch = 0;
  l.team_scratch = 0;
  l.tally_smem = false;
  l.tally_offset = 0;
  l.tables_smem = true;
  l.layout = 1;
  long long per_pair = 0;
  if (tables + bt_team_words(dx) <= limit) {
    l.d = dx;
    l.layout = 0;
  } else if (two && tables + bt_team_small_words(dx) <= limit) {
    l.d = dx;
  } else if (tables + bt_team_words(dp) <= limit) {
    l.d = dp;
    l.layout = 0;
  } else {
    l.d = dp;
    if (bt_team_small_words(dp) > limit) l.layout = two ? 2 : -1;
    l.tables_smem = l.layout == 1 && tables + bt_team_small_words(dp) <= limit;
  }
  const BtDims& d = l.d;
  if (l.layout == 0) {
    per_pair = bt_team_words(d);
  } else {
    l.ll_scratch = ll_written ? (long long)d.S * d.O : 0;
    if (l.layout == 1) per_pair = bt_team_small_words(d);
    if (l.layout == 2) l.team_scratch = bt_team_small_words(d);
  }
  const long long fixed = l.tables_smem ? tables : 0;
  const long long tally_words = ((long long)d.S * d.O + 1) / 2;
  if (two) {
    // the (sample, block) phases' width; with every exp cached the
    // (sample, outcome) phases', 16 outcomes a thread
    int need = d.S * d.G > d.H + 1 ? d.S * d.G : d.H + 1;
    if (d.X && need < d.S * d.O / 16) need = d.S * d.O / 16;
    need = ((need + 31) / 32) * 32;
    l.threads = need < 64 ? 64 : (need > 1024 ? 1024 : need);
  } else if (l.layout >= 0) {
    long long np = (BT_PACK_THREADS + d.S - 1) / d.S;
    if (n_pairs > 0) {
      const long long spread = (n_pairs + 2 * bt_sm_count() - 1) /
                               (2 * (long long)bt_sm_count());
      np = spread < np ? spread : np;
    }
    const long long budget = limit / 2 - 256;  // two blocks per SM
    const long long each = per_pair + (tally ? tally_words : 0);
    while (np > 1 && fixed + np * each > budget) --np;
    l.pairs_per_block = np < 1 ? 1 : (int)np;
    const long long lanes = ((l.pairs_per_block * (long long)d.S + 31) / 32) * 32;
    l.threads = lanes < BT_PACK_THREADS ? (int)lanes : BT_PACK_THREADS;
  }
  long long words = l.layout == 2 ? 0 : fixed + l.pairs_per_block * per_pair;
  if (tally && l.layout >= 0 && l.layout < 2 &&
      words + l.pairs_per_block * tally_words <= limit) {
    l.tally_smem = true;
    l.tally_offset = (int)words;
    words += l.pairs_per_block * tally_words;
  }
  l.smem_bytes = (size_t)words * 4;
  return l;
}

// A block wider than the kernel's register budget allows (1,024 threads
// need <= 64 registers each) is narrowed to the widest warp multiple that
// launches: the step's loops stride by the block's width and each result
// is computed by one thread, so the width changes no bit.
template <typename Kernel>
inline cudaError_t bt_fit_team(Kernel kernel, BtLaunch* l) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  if (l->threads > fa.maxThreadsPerBlock)
    l->threads = fa.maxThreadsPerBlock / 32 * 32;
  return cudaSuccess;
}
