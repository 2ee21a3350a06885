// nested_sweep: the coupled Gibbs scan of containment families and groups
// sharing multicluster k-mers, all iterations and rank levels in one launch.
//
// Replaces the 350-step lax.scan of gibbs.genotype_nested
// (bayestyper_tpu/model/gibbs.py:1163-1353), whose body runs the rank levels
// in order, each vmapped over its clusters. Shared k-mers never cross a
// group, a level holds at most one cluster of a group, and every key depends
// only on (level, cluster id, chain, t); so one block per (group, chain)
// runs all iterations over its group's members in rank order with no
// barrier across the grid, and reproduces the level-major scan. Per
// (member, t) the block:
//   * takes the member's ploidy from its parent's current outcome through
//     its retain table (containment demotion);
//   * adds the shared k-mers to the static LL, scored at
//     min(dip + inter + ext, mmax) with ext = pool - own (0 where the count
//     is 0); the null column keeps the static LL;
//   * runs bt_gibbs_step with key fold_in(chain_key, t);
//   * moves its shared contributions in the pool (integer adds: exact in
//     any order);
//   * after burn-in adds the MAC sibling fold (count / (own + inter +
//     siblings) - count / (own + inter), gated and per allele) to its
//     accumulator, and one to the tally of the drawn outcome.
// Every member step depends on the one before it (a member reads its
// parent's outcome at t, and the pool holds the lower members' moves at t
// and the higher ones' at t - 1), so a group's levels cannot be split
// across blocks: the launch is bound by its deepest group's serial chain of
// steps (members x iterations), each step's operations at one SM's share of
// the card.
//
// The on-chip layout (layout 0) attacks that chain:
//   * the wrapper orders the groups deepest first, so the longest chains
//     start in the first wave;
//   * the block stages its group's whole state in shared memory once: per
//     member the static LL, ploidy, retain row, hap_valid, frequencies,
//     current outcomes, a uint16 tally (<= 65,535 iterations), the chain
//     key folded once, its valid shared k-mer rows (counts, inter, dip, the
//     chain's mask bit, the slot in the group's dense pool range) and MAC
//     accumulator, and the group's pool rows; a step then reads device
//     memory only for the read-only tcut and MAC tables, and the state is
//     written back once at the end;
//   * a block's shared memory is its launch's largest group's, so the
//     groups whose state passes twice the median group's run as a second
//     launch on a side stream, beside the rest at their own occupancy;
//   * one producer warp derives every key and data-independent random
//     number of the coming steps (the categorical uniforms, the gkeys, the
//     gamma draws' first round and keys, the size uniform) into a shared
//     ring, BT_CHIP_BATCH steps at a time; the consumer warps run only the
//     data-dependent work and sync with it through two counters;
//   * the size draw's lgammas, all of small integers, come from a table of
//     lgammaf(0 .. 2 S + 2 H + 1) made once per block, and each member's
//     outcome table is packed in shared memory;
//   * the consumers are one warp (synced by __syncwarp) where every phase
//     has <= 32 items, else a named barrier over the consumer warps.
// The arithmetic is the global-memory variants', value for value, so the
// bits are theirs (shared k-mer rows with no valid slot add exact zeros
// there, and are skipped here).
//
// Where a group's state passes the card's shared memory (a 65-level H16
// group; an H64 level at 30 samples), or past 65,535 iterations, the
// global-memory variants keep each team's LL, which the step writes in
// place, in a caller-allocated [groups * chains, S, O_max] scratch (layout
// 1), and the rest of the team and its shared-k-mer rows [3, q_max, S] too
// when those do not fit either (layout 2).
#include <algorithm>
#include <vector>

#include "gibbs_step.cuh"
#include "launchers.h"

// ---- the on-chip layout ----

// the most consumer threads, and the steps a producer pass derives
#define BT_CHIP_CONSUMERS 256
#define BT_CHIP_BATCH 16

// One member's state in shared memory (bt_member_words 4-byte words).
struct BtMember {
  float *lls, *llw, *freqs, *acc;  // static LL, LL with shared k-mers [S, O]
  unsigned* key;                   // the chain key, folded once
  float* sparsity;
  int* use_sparse;
  int* q;                          // valid shared rows (bt_qrow)
  int* oab;                        // packed outcome table (bt_load_outcomes)
  uint16_t *tally, *ocur;          // [S, O], [S]
  int8_t *ploidy, *retain;         // [S], the retain row [parent's O]
  bool* hvalid;                    // [H]
};

// a shared row: slot * 2 + the chain's mask bit, q, counts and inter
// [S] (uint8: the bucket's), dip [O] (uint16: two uint8 multiplicities)
__host__ __device__ inline int bt_q_words(int S, int O) {
  return 2 + (2 * S + 3) / 4 + (O + 1) / 2;
}

__host__ __device__ inline int bt_member_words(int S, int O, int H, int nq,
                                               int parent_o, int mac) {
  const int so = S * O;
  return so + (nq > 0 ? so : 0) + H + 4 + nq * bt_q_words(S, O) +
         bt_outcome_words(O) +
         (so + 1) / 2 + (S + 1) / 2 + (S + 3) / 4 + (H + 3) / 4 +
         (parent_o + 3) / 4 + mac;
}

__device__ inline BtMember bt_member(float* base, int S, const int* md) {
  const int H = md[BT_MD_H], O = md[BT_MD_O], nq = md[BT_MD_NQ];
  const int so = S * O;
  BtMember m;
  float* p = base;
  m.lls = p;       p += so;
  m.llw = p;       p += nq > 0 ? so : 0;
  m.freqs = p;     p += H;
  m.key = reinterpret_cast<unsigned*>(p);  p += 2;
  m.sparsity = p;  p += 1;
  m.use_sparse = reinterpret_cast<int*>(p);  p += 1;
  m.q = reinterpret_cast<int*>(p);         p += nq * bt_q_words(S, O);
  m.oab = reinterpret_cast<int*>(p);       p += bt_outcome_words(O);
  m.tally = reinterpret_cast<uint16_t*>(p);  p += (so + 1) / 2;
  m.ocur = reinterpret_cast<uint16_t*>(p);   p += (S + 1) / 2;
  m.ploidy = reinterpret_cast<int8_t*>(p);   p += (S + 3) / 4;
  m.hvalid = reinterpret_cast<bool*>(p);     p += (H + 3) / 4;
  m.retain = reinterpret_cast<int8_t*>(p);   p += (md[BT_MD_PO] + 3) / 4;
  m.acc = p;
  return m;
}

struct BtQRow {
  int slot, q;
  bool w;
  uint8_t *cnt, *in;
  uint16_t* dip;
};

__device__ __forceinline__ BtQRow bt_qrow(int* rows, int j, int S, int O) {
  int* r = rows + j * bt_q_words(S, O);
  BtQRow x;
  x.slot = r[0] >> 1;
  x.w = (r[0] & 1) != 0;
  x.q = r[1];
  x.cnt = reinterpret_cast<uint8_t*>(r + 2);
  x.in = x.cnt + S;
  x.dip = reinterpret_cast<uint16_t*>(r + 2 + (2 * S + 3) / 4);
  return x;
}

// The largest integer whose lgamma the size draw takes: n_total + j <=
// 2 S + 2 H.
__host__ __device__ inline int bt_lgamma_max(int S, int hmax) {
  return 2 * S + 2 * hmax + 1;
}

// A ring record: the categorical uniforms [S], gkeys, the gamma draws'
// first normals and uniforms [H_max each], the size uniform, then the
// gamma keys k_boost, k_norm, k_unif (6 words).
__host__ __device__ inline int bt_record_words(int S, int hmax) {
  return S + 3 * hmax + 7;
}

// bt_gibbs_step's random numbers from a producer's record, and its
// lgammas of integers 0..lg_max from the block's table of lgammaf values.
struct BtRingRand {
  const float* rec;
  int S, hmax;
  const float* lg;
  int lg_max;
  __device__ float lgamma(float x) const {
    const int i = (int)x;
    return (x >= 0.0f && i <= lg_max && (float)i == x) ? lg[i] : lgammaf(x);
  }
  __device__ void keys(const BtBlock& bk, const BtPairs& sm, int) const {
    const unsigned* w =
        reinterpret_cast<const unsigned*>(rec + S + 3 * hmax + 1);
    for (int i = bk.tid; i < 6; i += bk.nt) sm.keys[2 * BT_K_BOOST + i] = w[i];
  }
  __device__ void keys2(const BtBlock&, const BtPairs&) const {}
  __device__ float u_cat(const BtPairs&, int, int s) const { return rec[s]; }
  __device__ float u_sel(const BtPairs&, int, int h) const {
    return rec[S + h];
  }
  __device__ float gx(const BtPairs&, int, int h) const {
    return rec[S + hmax + h];
  }
  __device__ float gu(const BtPairs&, int, int h) const {
    return rec[S + 2 * hmax + h];
  }
  __device__ float u_size(const BtPairs&, int) const {
    return rec[S + 3 * hmax];
  }
};

// The consumer warps' barrier: the warp's, or named barrier 1 over n
// threads (the producer warp never joins it).
struct BtSyncConsumers {
  int n;
  __device__ void operator()() const {
    if (n == 32)
      __syncwarp();
    else
      asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
  }
};

__device__ __forceinline__ int bt_ld_volatile(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}
__device__ __forceinline__ void bt_st_volatile(int* p, int v) {
  *reinterpret_cast<volatile int*>(p) = v;
}

// The producer warp: records for steps j = (t - t0) * nm + m, in the
// consumers' order, BT_CHIP_BATCH at a time: first each step's keys on its
// own lane, then the step's uniforms and normals over (step, item) lanes.
__device__ inline void bt_chip_produce(const int* s_md, float* gbase,
                                       float* ring, unsigned* pkeys,
                                       int* ctl, int lane, int S, int nm,
                                       int t0, int total, int R, int recw,
                                       int hmax) {
  const int per = S + 3 * hmax + 1;
  for (int j0 = 0; j0 < total; j0 += BT_CHIP_BATCH) {
    const int nb = min(BT_CHIP_BATCH, total - j0);
    if (lane == 0)
      while (bt_ld_volatile(ctl + 1) < j0 + nb - R) __nanosleep(32);
    __syncwarp();
    if (lane < nb) {
      const int j = j0 + lane, t = t0 + j / nm, m = j % nm;
      const BtMember mb = bt_member(gbase + s_md[m * BT_MD + BT_MD_WOFF], S,
                                    s_md + m * BT_MD);
      const BtKey step = bt_fold_in(BtKey{mb.key[0], mb.key[1]}, (uint32_t)t);
      const BtKey k_freq = bt_fold_in(step, 1u);
      const BtKey k_gam = bt_fold_in(k_freq, 2u);
      const BtKey ks[5] = {bt_fold_in(step, 0u), bt_fold_in(k_freq, 0u),
                           bt_fold_in(k_freq, 1u), bt_fold_in(k_gam, 1u),
                           bt_fold_in(k_gam, 2u)};
      unsigned* pk = pkeys + lane * 10;
      for (int i = 0; i < 5; ++i) {
        pk[2 * i] = ks[i].k0;
        pk[2 * i + 1] = ks[i].k1;
      }
      unsigned* gk = reinterpret_cast<unsigned*>(ring + (j % R) * recw + per);
      const BtKey k_boost = bt_fold_in(k_gam, 0u);
      gk[0] = k_boost.k0;
      gk[1] = k_boost.k1;
      gk[2] = ks[3].k0;
      gk[3] = ks[3].k1;
      gk[4] = ks[4].k0;
      gk[5] = ks[4].k1;
    }
    __syncwarp();
    for (int i = lane; i < nb * per; i += 32) {
      const int l = i / per, it = i - l * per, j = j0 + l;
      const unsigned* pk = pkeys + l * 10;
      float* rec = ring + (j % R) * recw;
      if (it < S) {
        rec[it] = bt_uniform(BtKey{pk[0], pk[1]}, (uint32_t)it);
      } else if (it < S + 3 * hmax) {
        const int kind = (it - S) / hmax, h = (it - S) - kind * hmax;
        if (h >= s_md[(j % nm) * BT_MD + BT_MD_H]) continue;
        if (kind == 0)
          rec[it] = bt_uniform(BtKey{pk[4], pk[5]}, (uint32_t)h);
        else if (kind == 1)
          rec[it] = bt_gamma_normal0(BtKey{pk[6], pk[7]}, h);
        else
          rec[it] = bt_gamma_uniform0(BtKey{pk[8], pk[9]}, h);
      } else {
        rec[it] = bt_uniform(BtKey{pk[2], pk[3]}, 0u);
      }
    }
    __threadfence_block();
    __syncwarp();
    if (lane == 0) bt_st_volatile(ctl, j0 + nb);
  }
}

// One member step of the consumer warps (see the file's comment), at
// ring record rec; ends with a consumer barrier.
__device__ inline void bt_chip_step(const BtNestedLevel* __restrict__ lv,
                                    const int* s_md, float* gbase,
                                    float* team, int* pool_l, const float* rec,
                                    const float* lg, int m, int t, int x,
                                    int ch, int S, int burn_in, int hmax,
                                    const BtSyncConsumers& sync) {
  const int* md = s_md + m * BT_MD;
  const BtNestedLevel& L = lv[md[BT_MD_LEVEL]];
  const int c = md[BT_MD_ROW], pm = md[BT_MD_PARENT], nq = md[BT_MD_NQ];
  const int O = md[BT_MD_O], H = md[BT_MD_H];
  const BtBlock bk{(int)threadIdx.x, sync.n, 1};
  const BtMember mb = bt_member(gbase + md[BT_MD_WOFF], S, md);
  const BtDims d = bt_dims(S, O, H);
  const BtPairs sm = bt_carve_pairs(team, nq > 0 ? mb.llw : mb.lls, d, 1);
  const long long pair = (long long)c * ch + x;

  // ---- ploidy, frequencies ----
  const uint16_t* pocur = nullptr;
  if (pm >= 0)
    pocur = bt_member(gbase + s_md[pm * BT_MD + BT_MD_WOFF], S,
                      s_md + pm * BT_MD).ocur;
  for (int s = bk.tid; s < S; s += bk.nt)
    sm.ploidy[s] = pm >= 0 ? mb.retain[pocur[s]] : mb.ploidy[s];
  for (int h = bk.tid; h < H; h += bk.nt) {
    sm.hvalid[h] = mb.hvalid[h];
    sm.freqs[h] = mb.freqs[h];
  }
  if (bk.tid == 0) {
    sm.fsc[BT_F_SPARSITY] = *mb.sparsity;
    sm.isc[BT_I_SPARSE] = *mb.use_sparse;
  }

  // ---- shared k-mers at the pool's current state ----
  if (nq > 0) {
    const int M = L.mmax + 1;
    for (int i = bk.tid; i < S * (O - 1); i += bk.nt) {
      const int s = i / (O - 1), o = i - s * (O - 1);
      float acc = 0.0f;
      for (int j = 0; j < nq; ++j) {
        const BtQRow r = bt_qrow(mb.q, j, S, O);
        if (!r.w) continue;
        const int ext =
            r.cnt[s] > 0 ? pool_l[r.slot * S + s] - r.dip[mb.ocur[s]] : 0;
        int mc = r.dip[o] + r.in[s] + ext;
        mc = min(mc, L.mmax);
        acc += mc >= 0 ? __ldg(L.tcut + (((long long)c * L.Q + r.q) * S + s) *
                                            M + mc)
                       : 0.0f;
      }
      mb.llw[s * O + o] = mb.lls[s * O + o] + acc;
    }
    for (int s = bk.tid; s < S; s += bk.nt)
      mb.llw[s * O + O - 1] = mb.lls[s * O + O - 1];
  }
  sync();

  // ---- the Gibbs step ----
  bt_gibbs_step(bk, sm, d, BtOutcomes{mb.oab, L.oa, L.ob}, t,
                BtRingRand{rec, S, hmax, lg, bt_lgamma_max(S, hmax)}, sync);
  for (int h = bk.tid; h < H; h += bk.nt) mb.freqs[h] = sm.freqs[h];

  // ---- pool update and the MAC sibling fold ----
  if (nq > 0) {
    for (int i = bk.tid; i < nq * S; i += bk.nt) {
      const int j = i / S, s = i - j * S;
      const BtQRow r = bt_qrow(mb.q, j, S, O);
      atomicAdd(pool_l + r.slot * S + s,
                (int)r.dip[sm.osel[s]] - (int)r.dip[mb.ocur[s]]);
    }
    sync();
    if (L.mac_acc != nullptr && t >= burn_in) {
      const int V = L.V, A = L.A, he = H + 1;
      for (int i = bk.tid; i < S * V; i += bk.nt) {
        const int s = i / V, v = i - s * V;
        const int o = sm.osel[s];
        float contrib[2];
        int allele[2];
        for (int slot = 0; slot < 2; ++slot) {
          const int h = slot == 0 ? L.oa[o] : L.ob[o];
          float dmn = 0.0f;
          for (int j = 0; j < nq; ++j) {
            const BtQRow r = bt_qrow(mb.q, j, S, O);
            const int own = r.dip[o];
            const int ext = pool_l[r.slot * S + s] - own;
            const float ms = (float)(own + r.in[s]);
            const float cnt = (float)r.cnt[s];
            const float vs = cnt / fmaxf(ms, 1.0f);
            const float vd = cnt / fmaxf(ms + (float)ext, 1.0f);
            dmn += (vd - vs) * (r.w ? 1.0f : 0.0f) *
                   (float)L.mem[(((long long)c * L.Q + r.q) * V + v) * he + h];
          }
          const float n_at = L.n_hv[(pair * V + v) * he + h];
          const float gate = (n_at > 0.0f && h < H) ? 1.0f : 0.0f;
          contrib[slot] = dmn / fmaxf(n_at, 1.0f) * gate;
          allele[slot] = L.ha[((long long)c * he + h) * V + v];
        }
        float* acc = mb.acc + (s * V + v) * A;
        for (int a = 0; a < A; ++a)
          acc[a] += (allele[0] == a ? contrib[0] : 0.0f) +
                    (allele[1] == a ? contrib[1] : 0.0f);
      }
    }
  }

  // ---- current outcome and tally ----
  for (int s = bk.tid; s < S; s += bk.nt) {
    const int o = sm.osel[s];
    mb.ocur[s] = (uint16_t)o;
    if (t >= burn_in) mb.tally[s * O + o] += 1;
  }
  sync();
}

__global__ void __launch_bounds__(BT_CHIP_CONSUMERS + 32)
    bt_nested_chip_kernel(const BtNestedLevel* __restrict__ lv, int* pool,
                          const int* __restrict__ md,
                          const int* __restrict__ goff,
                          const int* __restrict__ glist,
                          const int* __restrict__ qrows,
                          const int* __restrict__ pofs,
                          const int* __restrict__ gslot, int ch, int S,
                          int t0, int t1, int burn_in, int nc, int team_words,
                          int recw, int R, int hmax, int nm_max) {
  extern __shared__ float smem[];
  const int g = glist[blockIdx.x / ch], x = blockIdx.x % ch;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int m0 = goff[g], nm = goff[g + 1] - m0;
  const int p0 = pofs[g], P = pofs[g + 1] - p0;
  int* ctl = reinterpret_cast<int*>(smem);  // records produced, consumed
  int* s_md = ctl + 4;
  float* team = reinterpret_cast<float*>(s_md + nm_max * BT_MD);
  float* ring = team + team_words;
  unsigned* pkeys = reinterpret_cast<unsigned*>(ring + R * recw);
  float* lg = reinterpret_cast<float*>(pkeys + BT_CHIP_BATCH * 10);
  const int lg_max = bt_lgamma_max(S, hmax);
  int* pool_l = reinterpret_cast<int*>(lg + lg_max + 1);
  float* gbase = reinterpret_cast<float*>(pool_l);  // members at md's woff

  // ---- stage the group's state ----
  for (int i = tid; i < nm * BT_MD; i += nt) s_md[i] = md[m0 * BT_MD + i];
  if (tid < 2) ctl[tid] = 0;
  for (int i = tid; i <= lg_max; i += nt) lg[i] = lgammaf((float)i);
  for (int i = tid; i < P * S; i += nt)
    pool_l[i] = pool[((long long)gslot[p0 + i / S] * ch + x) * S + i % S];
  __syncthreads();
  for (int m = 0; m < nm; ++m) {
    const int* d = s_md + m * BT_MD;
    const BtNestedLevel& L = lv[d[BT_MD_LEVEL]];
    const int c = d[BT_MD_ROW], O = d[BT_MD_O], H = d[BT_MD_H];
    const int nq = d[BT_MD_NQ], so = S * O;
    const long long pair = (long long)c * ch + x;
    const BtMember mb = bt_member(gbase + d[BT_MD_WOFF], S, d);
    for (int i = tid; i < so; i += nt) {
      mb.lls[i] = L.ll[pair * so + i];
      mb.tally[i] = 0;
    }
    for (int s = tid; s < S; s += nt) {
      mb.ocur[s] = (uint16_t)L.ocur[pair * S + s];
      mb.ploidy[s] = L.ploidy[(long long)c * S + s];
    }
    for (int h = tid; h < H; h += nt) {
      mb.freqs[h] = L.freqs[pair * H + h];
      mb.hvalid[h] = L.hap_valid[(long long)c * H + h];
    }
    for (int o = tid; o < d[BT_MD_PO]; o += nt)
      mb.retain[o] = L.retain[(long long)c * L.o_pad + o];
    for (int o = tid; o < O; o += nt)
      mb.oab[o + o / BT_OBLOCK] = L.oa[o] | (L.ob[o] << 16);
    if (tid == 0) {
      const BtKey k = bt_fold_in(
          bt_fold_in(BtKey{L.key0, L.key1}, (uint32_t)L.cluster_id[c]),
          (uint32_t)x);
      mb.key[0] = k.k0;
      mb.key[1] = k.k1;
      *mb.sparsity = L.sparsity[c];
      *mb.use_sparse = L.use_sparse[c];
    }
    const int* qr = qrows + 2 * d[BT_MD_QOFF];
    const int qw = bt_q_words(S, O);
    for (int j = tid; j < nq; j += nt) {
      const bool w = L.sh_w[pair * L.Q + qr[2 * j]];
      mb.q[j * qw] = qr[2 * j + 1] * 2 + (w ? 1 : 0);
      mb.q[j * qw + 1] = qr[2 * j];
    }
    for (int i = tid; i < nq * S; i += nt) {
      const int j = i / S, s = i - j * S;
      const long long cq = (long long)c * L.Q + qr[2 * j];
      uint8_t* cnt = reinterpret_cast<uint8_t*>(mb.q + j * qw + 2);
      cnt[s] = (uint8_t)L.sh_counts[cq * S + s];
      cnt[S + s] = (uint8_t)L.sh_inter[cq * S + s];
    }
    for (int i = tid; i < nq * O; i += nt) {
      const int j = i / O, o = i - j * O;
      const long long cq = (long long)c * L.Q + qr[2 * j];
      reinterpret_cast<uint16_t*>(mb.q + j * qw + 2 + (2 * S + 3) / 4)[o] =
          (uint16_t)L.sh_dip[cq * O + o];
    }
    if (L.mac_acc != nullptr && nq > 0) {
      const int n = S * L.V * L.A;
      for (int i = tid; i < n; i += nt) mb.acc[i] = L.mac_acc[pair * n + i];
    }
  }
  __syncthreads();

  const int total = (t1 - t0) * nm;
  if (tid >= nc) {
    bt_chip_produce(s_md, gbase, ring, pkeys, ctl, tid - nc, S, nm, t0,
                    total, R, recw, hmax);
  } else {
    const BtSyncConsumers sync{nc};
    int j = 0;
    for (int t = t0; t < t1; ++t) {
      for (int m = 0; m < nm; ++m, ++j) {
        while (bt_ld_volatile(ctl) <= j) {
        }
        __threadfence_block();
        bt_chip_step(lv, s_md, gbase, team, pool_l, ring + (j % R) * recw, lg,
                     m, t, x, ch, S, burn_in, hmax, sync);
        if (tid == 0) {
          __threadfence_block();
          bt_st_volatile(ctl + 1, j + 1);
        }
      }
    }
  }
  __syncthreads();

  // ---- write the state back ----
  for (int m = 0; m < nm; ++m) {
    const int* d = s_md + m * BT_MD;
    const BtNestedLevel& L = lv[d[BT_MD_LEVEL]];
    const int c = d[BT_MD_ROW], O = d[BT_MD_O], H = d[BT_MD_H], so = S * O;
    const long long pair = (long long)c * ch + x;
    const BtMember mb = bt_member(gbase + d[BT_MD_WOFF], S, d);
    for (int i = tid; i < so; i += nt) L.tally[pair * so + i] += mb.tally[i];
    for (int s = tid; s < S; s += nt) L.ocur[pair * S + s] = mb.ocur[s];
    for (int h = tid; h < H; h += nt) L.freqs[pair * H + h] = mb.freqs[h];
    if (L.mac_acc != nullptr && d[BT_MD_NQ] > 0) {
      const int n = S * L.V * L.A;
      for (int i = tid; i < n; i += nt) L.mac_acc[pair * n + i] = mb.acc[i];
    }
  }
  for (int i = tid; i < P * S; i += nt)
    pool[((long long)gslot[p0 + i / S] * ch + x) * S + i % S] = pool_l[i];
}

// ---- the global-memory variants (layouts 1 and 2) ----

__device__ __forceinline__ int bt_pool_at(const int* pool, int slot, int x,
                                          int s, int ch, int S) {
  return __ldcg(pool + ((long long)slot * ch + x) * S + s);
}

template <int kLayout>
__global__ void bt_nested_sweep_kernel(const BtNestedLevel* __restrict__ lv,
                                       int* pool, const int* __restrict__ goff,
                                       const int* __restrict__ md, int ch,
                                       int S, int q_max, int t0, int t1,
                                       int burn_in, int team_words,
                                       float* gscratch, int ll_words,
                                       long long team_stride) {
  extern __shared__ float smem[];
  const int g = blockIdx.x / ch;
  const int x = blockIdx.x % ch;
  const BtBlock bk{(int)threadIdx.x, (int)blockDim.x, 1};
  // layout 1: the LL at the team's scratch row, the rest shared; 2: all of
  // it in the scratch row
  float* llbase = gscratch + (long long)blockIdx.x * team_stride;
  float* tbase = kLayout == 2 ? llbase + ll_words : smem;
  int* own_old = reinterpret_cast<int*>(tbase + team_words);  // [Q, S]
  int* own_new = own_old + q_max * S;                        // [Q, S]
  float* scratch = reinterpret_cast<float*>(own_new + q_max * S);  // [Q, S]
  const int m0 = goff[g], m1 = goff[g + 1];

  for (int t = t0; t < t1; ++t) {
    for (int m = m0; m < m1; ++m) {
      const BtNestedLevel& L = lv[md[BT_MD * m]];
      const int c = md[BT_MD * m + 1];
      const BtDims d = bt_dims(S, L.O, L.H);
      const BtPairs sm = bt_carve_pairs(tbase, llbase, d, 1);
      const long long pair = (long long)c * ch + x;
      const int Q = L.Q, O = L.O, H = L.H;

      // ---- ploidy, frequencies, static LL ----
      const int plv = L.parent_level[c];
      for (int s = bk.tid; s < S; s += bk.nt) {
        int pl = L.ploidy[(long long)c * S + s];
        if (plv >= 0) {
          const BtNestedLevel& P = lv[plv];
          const int po = __ldcg(P.ocur + ((long long)L.parent_row[c] * ch + x) * S + s);
          pl = L.retain[(long long)c * L.o_pad + po];
        }
        sm.ploidy[s] = pl;
      }
      for (int h = bk.tid; h < H; h += bk.nt) {
        sm.hvalid[h] = L.hap_valid[(long long)c * H + h];
        sm.freqs[h] = L.freqs[pair * H + h];
      }
      const float* llp = L.ll + pair * S * O;
      for (int i = bk.tid; i < S * O; i += bk.nt) sm.ll[i] = llp[i];

      // ---- shared k-mers at the pool's current state ----
      if (Q > 0) {
        for (int i = bk.tid; i < Q * S; i += bk.nt) {
          const int q = i / S, s = i % S;
          const long long cq = (long long)c * Q + q;
          const int o_old = __ldcg(L.ocur + pair * S + s);
          const int own = L.sh_dip[cq * O + o_old];
          own_old[i] = own;
          const int ext = bt_pool_at(pool, L.sh_slot[cq], x, s, ch, S) - own;
          reinterpret_cast<int*>(scratch)[i] = L.sh_counts[cq * S + s] > 0 ? ext : 0;
        }
        __syncthreads();
        const bool* wsh = L.sh_w + pair * Q;
        const int M = L.mmax + 1;
        for (int i = bk.tid; i < S * (O - 1); i += bk.nt) {
          const int s = i / (O - 1), o = i % (O - 1);
          float acc = 0.0f;
          for (int q = 0; q < Q; ++q) {
            if (!wsh[q]) continue;
            const long long cq = (long long)c * Q + q;
            int mc = L.sh_dip[cq * O + o] + L.sh_inter[cq * S + s] +
                     reinterpret_cast<int*>(scratch)[q * S + s];
            mc = min(mc, L.mmax);
            acc += mc >= 0 ? L.tcut[(cq * S + s) * M + mc] : 0.0f;
          }
          sm.ll[s * O + o] += acc;
        }
        __syncthreads();
      }

      // ---- the Gibbs step ----
      if (bk.tid == 0) {
        bt_set_key(sm, 0, BT_K_CHAIN,
                   bt_fold_in(bt_fold_in(BtKey{L.key0, L.key1},
                                         (uint32_t)L.cluster_id[c]),
                              (uint32_t)x));
        sm.fsc[BT_F_SPARSITY] = L.sparsity[c];
        sm.isc[BT_I_SPARSE] = L.use_sparse[c];
      }
      __syncthreads();
      bt_gibbs_step(bk, sm, d, BtOutcomes{nullptr, L.oa, L.ob}, t);
      for (int h = bk.tid; h < H; h += bk.nt) L.freqs[pair * H + h] = sm.freqs[h];

      // ---- pool update and the MAC sibling fold ----
      if (Q > 0) {
        for (int i = bk.tid; i < Q * S; i += bk.nt) {
          const int q = i / S, s = i % S;
          const long long cq = (long long)c * Q + q;
          const int own = L.sh_dip[cq * O + sm.osel[s]];
          own_new[i] = own;
          if (L.sh_valid[cq])
            atomicAdd(pool + ((long long)L.sh_slot[cq] * ch + x) * S + s,
                      own - own_old[i]);
        }
        __syncthreads();
        if (L.mac_acc != nullptr && t >= burn_in) {
          for (int i = bk.tid; i < Q * S; i += bk.nt) {
            const int q = i / S, s = i % S;
            const long long cq = (long long)c * Q + q;
            const int ext = L.sh_valid[cq]
                                ? bt_pool_at(pool, L.sh_slot[cq], x, s, ch, S) - own_new[i]
                                : 0;
            const float ms = (float)(own_new[i] + L.sh_inter[cq * S + s]);
            const float cnt = (float)L.sh_counts[cq * S + s];
            const float vs = cnt / fmaxf(ms, 1.0f);
            const float vd = cnt / fmaxf(ms + (float)ext, 1.0f);
            scratch[i] = (vd - vs) * (L.sh_w[pair * Q + q] ? 1.0f : 0.0f);
          }
          __syncthreads();
          const int V = L.V, A = L.A, he = H + 1;
          for (int i = bk.tid; i < S * V; i += bk.nt) {
            const int s = i / V, v = i % V;
            const int o = sm.osel[s];
            float contrib[2];
            int allele[2];
            for (int slot = 0; slot < 2; ++slot) {
              const int h = slot == 0 ? L.oa[o] : L.ob[o];
              float dmn = 0.0f;
              for (int q = 0; q < Q; ++q)
                dmn += scratch[q * S + s] *
                       (float)L.mem[(((long long)c * Q + q) * V + v) * he + h];
              const float n_at = L.n_hv[(pair * V + v) * he + h];
              const float gate = (n_at > 0.0f && h < H) ? 1.0f : 0.0f;
              contrib[slot] = dmn / fmaxf(n_at, 1.0f) * gate;
              allele[slot] = L.ha[((long long)c * he + h) * V + v];
            }
            float* acc = L.mac_acc + ((pair * S + s) * V + v) * A;
            for (int a = 0; a < A; ++a)
              acc[a] += (allele[0] == a ? contrib[0] : 0.0f) +
                        (allele[1] == a ? contrib[1] : 0.0f);
          }
        }
      }

      // ---- current outcome and tally ----
      for (int s = bk.tid; s < S; s += bk.nt) {
        const int o = sm.osel[s];
        L.ocur[pair * S + s] = o;
        if (t >= burn_in) L.tally[(pair * S + s) * O + o] += 1;
      }
      __syncthreads();
    }
  }
}

// The on-chip launch: consumer threads, words of the step's team arrays
// and of a ring record, ring records, the largest H, and per group its
// members and its words of state. Fills md's word offsets.
struct BtChipShape {
  int nc, team_words, recw, R, hmax;
  std::vector<int> members;
  std::vector<long long> words;
};

static BtChipShape bt_chip_shape(const BtNestedLevel* lv, int n_levels,
                                 int* md, const int* goff, int n_groups,
                                 const int* pofs, int S) {
  BtChipShape n{32, 0, 0, 2 * BT_CHIP_BATCH, 1, {}, {}};
  int need = 1;
  for (int l = 0; l < n_levels; ++l) {
    const BtDims d = bt_dims(S, lv[l].O, lv[l].H);
    n.team_words = max(n.team_words, bt_team_small_words(d));
    n.hmax = max(n.hmax, lv[l].H);
    need = max(need, max(d.S * d.G, d.H + 1));
  }
  n.nc = min(BT_CHIP_CONSUMERS, ((need + 31) / 32) * 32);
  n.recw = bt_record_words(S, n.hmax);
  for (int g = 0; g < n_groups; ++g) {
    long long w = (long long)(pofs[g + 1] - pofs[g]) * S;
    for (int m = goff[g]; m < goff[g + 1]; ++m) {
      int* d = md + (size_t)m * BT_MD;
      const BtNestedLevel& L = lv[d[BT_MD_LEVEL]];
      const int nq = d[BT_MD_NQ];
      d[BT_MD_WOFF] = (int)w;
      w += bt_member_words(S, L.O, L.H, nq, d[BT_MD_PO],
                           L.mac_acc != nullptr && nq > 0 ? S * L.V * L.A : 0);
    }
    n.members.push_back(goff[g + 1] - goff[g]);
    n.words.push_back(w);
  }
  return n;
}

// Shared bytes of a launch over the groups of list (indices).
static size_t bt_chip_smem(const BtChipShape& n, const std::vector<int>& list,
                           int S) {
  int nm_max = 0;
  long long gmax = 0;
  for (int g : list) {
    nm_max = max(nm_max, n.members[g]);
    gmax = max(gmax, n.words[g]);
  }
  return (size_t)4 * (4 + (size_t)nm_max * BT_MD + n.team_words +
                      (size_t)n.R * n.recw + BT_CHIP_BATCH * 10 +
                      bt_lgamma_max(S, n.hmax) + 1 + gmax);
}

// The groups split by their state: those past twice the median group's go
// to a launch of their own (their blocks would cut every other block's
// occupancy to theirs), the rest to another; each list in launch order.
static void bt_chip_split(const BtChipShape& n, std::vector<int>* large,
                          std::vector<int>* small) {
  std::vector<long long> sorted(n.words);
  std::sort(sorted.begin(), sorted.end());
  const long long limit = 2 * sorted[sorted.size() / 2];
  for (int g = 0; g < (int)n.words.size(); ++g)
    (n.words[g] > limit ? large : small)->push_back(g);
}

// The global-memory variants' launch: threads, the layout (1 or 2), the
// words per team before the shared-k-mer rows, shared bytes and the
// scratch words per team.
struct BtNestedShape {
  int threads, layout, team_words, ll_words, q_max;
  size_t smem;
  long long scratch;
};

static BtNestedShape bt_nested_shape(const BtNestedLevel* levels, int n_levels,
                                     int S) {
  BtNestedShape n{64, 1, 0, 0, 0, 0, 0};
  int small = 0;
  for (int l = 0; l < n_levels; ++l) {
    const BtDims d = bt_dims(S, levels[l].O, levels[l].H);
    small = max(small, bt_team_small_words(d));
    n.ll_words = max(n.ll_words, d.S * d.O);
    n.q_max = max(n.q_max, levels[l].Q);
    const int need = d.S * d.G > d.H + 1 ? d.S * d.G : d.H + 1;
    n.threads = max(n.threads, min(256, ((need + 31) / 32) * 32));
  }
  const size_t rows = 3 * (size_t)n.q_max * S;
  n.team_words = small;
  n.scratch = n.ll_words;
  if ((small + rows) * 4 <= (size_t)bt_smem_optin()) {
    n.smem = (small + rows) * 4;
  } else {
    n.layout = 2;
    n.scratch = n.ll_words + small + (long long)rows;
  }
  return n;
}

int bt_nested_layout(const BtNestedLevel* levels_host, int n_levels,
                     int* md_host, const int* goff_host, int n_groups,
                     const int* pofs_host, int S, int t0, int t1, int burn_in,
                     int64_t* scratch) {
  *scratch = 0;
  const BtChipShape c = bt_chip_shape(levels_host, n_levels, md_host,
                                      goff_host, n_groups, pofs_host, S);
  std::vector<int> all(n_groups);
  for (int g = 0; g < n_groups; ++g) all[g] = g;
  if (bt_chip_smem(c, all, S) <= (size_t)bt_smem_optin() &&
      t1 - max(t0, burn_in) <= 65535)
    return 0;
  const BtNestedShape n = bt_nested_shape(levels_host, n_levels, S);
  *scratch = n.scratch;
  return n.layout;
}

template <int kLayout>
static cudaError_t bt_nested_launch(const BtNestedLevel* levels_dev,
                                    int* pool, const int* group_offsets,
                                    const int* md, int n_groups, int ch,
                                    int S, int t0, int t1, int burn_in,
                                    const BtNestedShape& n, float* scratch,
                                    cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bt_nested_sweep_kernel<kLayout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)n.smem);
  if (err != cudaSuccess) return err;
  bt_nested_sweep_kernel<kLayout><<<(unsigned)(n_groups * ch), n.threads,
                                    n.smem, stream>>>(
      levels_dev, pool, group_offsets, md, ch, S, n.q_max, t0, t1, burn_in,
      n.team_words, scratch, n.ll_words, n.scratch);
  return cudaGetLastError();
}

// One on-chip launch over the groups glist_dev [list.size()] on stream.
static cudaError_t bt_chip_launch(const BtChipShape& c, int nc,
                                  const std::vector<int>& list,
                                  const int* glist_dev,
                                  const BtNestedLevel* levels_dev, int* pool,
                                  const int* md_dev, const int* goff_dev,
                                  const int* qrows_dev, const int* pofs_dev,
                                  const int* gslot_dev, int ch, int S, int t0,
                                  int t1, int burn_in, cudaStream_t stream) {
  if (list.empty()) return cudaSuccess;
  int nm_max = 0;
  for (int g : list) nm_max = max(nm_max, c.members[g]);
  const size_t smem = bt_chip_smem(c, list, S);
  cudaError_t err = cudaFuncSetAttribute(
      bt_nested_chip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  bt_nested_chip_kernel<<<(unsigned)(list.size() * ch), nc + 32, smem,
                          stream>>>(
      levels_dev, pool, md_dev, goff_dev, glist_dev, qrows_dev, pofs_dev,
      gslot_dev, ch, S, t0, t1, burn_in, nc, c.team_words, c.recw, c.R,
      c.hmax, nm_max);
  return cudaGetLastError();
}

cudaError_t bt_nested_sweep(const BtNestedLevel* levels_dev, int n_levels,
                            const BtNestedLevel* levels_host, int* pool,
                            const int* md_dev, int* md_host,
                            const int* goff_dev, const int* goff_host,
                            int n_groups, const int* qrows_dev,
                            const int* pofs_dev, const int* pofs_host,
                            const int* gslot_dev, int* glist_dev, int ch,
                            int S, int t0, int t1, int burn_in,
                            float* scratch, cudaStream_t stream,
                            cudaStream_t side) {
  if (n_groups == 0 || t1 <= t0) return cudaSuccess;
  int64_t words = 0;
  const int layout =
      bt_nested_layout(levels_host, n_levels, md_host, goff_host, n_groups,
                       pofs_host, S, t0, t1, burn_in, &words);
  if (layout == 0) {
    const BtChipShape c = bt_chip_shape(levels_host, n_levels, md_host,
                                        goff_host, n_groups, pofs_host, S);
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, bt_nested_chip_kernel);
    if (err != cudaSuccess) return err;
    // fewer consumer warps where registers cap the block: the step's loops
    // stride by the consumers' width, so the width changes no bit
    const int nc = min(c.nc, (fa.maxThreadsPerBlock / 32 - 1) * 32);
    std::vector<int> large, small;
    bt_chip_split(c, &large, &small);
    std::vector<int> glist(large);
    glist.insert(glist.end(), small.begin(), small.end());
    err = cudaMemcpyAsync(glist_dev, glist.data(), glist.size() * sizeof(int),
                          cudaMemcpyHostToDevice, stream);
    if (err != cudaSuccess) return err;
    // the large groups on a side stream that joins stream before and after
    cudaEvent_t ready, done;
    if ((err = cudaEventCreateWithFlags(&ready, cudaEventDisableTiming)) !=
        cudaSuccess)
      return err;
    if ((err = cudaEventCreateWithFlags(&done, cudaEventDisableTiming)) !=
        cudaSuccess) {
      cudaEventDestroy(ready);
      return err;
    }
    const cudaStream_t big = large.empty() || small.empty() ? stream : side;
    err = cudaEventRecord(ready, stream);
    if (err == cudaSuccess) err = cudaStreamWaitEvent(big, ready, 0);
    if (err == cudaSuccess)
      err = bt_chip_launch(c, nc, large, glist_dev, levels_dev, pool, md_dev,
                           goff_dev, qrows_dev, pofs_dev, gslot_dev, ch, S, t0,
                           t1, burn_in, big);
    if (err == cudaSuccess)
      err = bt_chip_launch(c, nc, small, glist_dev + large.size(), levels_dev,
                           pool, md_dev, goff_dev, qrows_dev, pofs_dev,
                           gslot_dev, ch, S, t0, t1, burn_in, stream);
    if (err == cudaSuccess) err = cudaEventRecord(done, big);
    if (err == cudaSuccess) err = cudaStreamWaitEvent(stream, done, 0);
    cudaEventDestroy(ready);
    cudaEventDestroy(done);
    return err;
  }
  const BtNestedShape n = bt_nested_shape(levels_host, n_levels, S);
  if (scratch == nullptr) return cudaErrorInvalidValue;
  if (n.layout == 1)
    return bt_nested_launch<1>(levels_dev, pool, goff_dev, md_dev, n_groups,
                               ch, S, t0, t1, burn_in, n, scratch, stream);
  return bt_nested_launch<2>(levels_dev, pool, goff_dev, md_dev, n_groups, ch,
                             S, t0, t1, burn_in, n, scratch, stream);
}
