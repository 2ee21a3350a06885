// nested_sweep: the coupled Gibbs scan of containment families and groups
// sharing multicluster k-mers, all iterations and rank levels in one launch.
//
// Replaces the 350-step lax.scan of gibbs.genotype_nested
// (bayestyper_tpu/model/gibbs.py:1163-1353), whose body runs the rank levels
// in order, each vmapped over its clusters. Shared k-mers never cross a
// group, a level holds at most one cluster of a group, and every key depends
// only on (level, cluster id, chain, t); so one block per (group, chain)
// runs all iterations over its group's levels in rank order with no barrier
// across the grid, and reproduces the level-major scan. Per (member, t) the
// block:
//   * reads the member's ploidy from its parent's current outcome through
//     its retain table (containment demotion);
//   * loads the static LL into shared memory and adds the shared k-mers,
//     scored at min(dip + inter + ext, mmax) with ext = pool - own (0 where
//     the count is 0); the null column stays 0;
//   * runs bt_gibbs_step with key fold_in(chain_key, t);
//   * moves its shared contributions in the int32 pool (atomicAdd: exact in
//     any order; read back with __ldcg past the L1);
//   * after burn-in adds the MAC sibling fold (count / (own + inter +
//     siblings) - count / (own + inter), gated and per allele) to its
//     accumulator, and one to the tally of the drawn outcome.
// Bound: the sequential chain of steps of the deepest group (levels x
// iterations), operations within a step; the LL of a step is read once.
//
// Above the card's shared memory (an H64 level from S = 25 on the H100)
// the global-memory variants keep each team's LL, which the step writes in
// place, in a caller-allocated [groups * chains, S, O_max] scratch (layout
// 1), and the rest of the team and its shared-k-mer rows [3, q_max, S]
// too when those do not fit either (layout 2). The arithmetic and its
// order are the shared layout's.
#include "gibbs_step.cuh"
#include "launchers.h"

__device__ __forceinline__ int bt_pool_at(const int* pool, int slot, int x,
                                          int s, int ch, int S) {
  return __ldcg(pool + ((long long)slot * ch + x) * S + s);
}

template <int kLayout>
__global__ void bt_nested_sweep_kernel(const BtNestedLevel* __restrict__ lv,
                                       int* pool, const int* __restrict__ goff,
                                       const int* __restrict__ gmem, int ch,
                                       int S, int q_max, int t0, int t1,
                                       int burn_in, int team_words,
                                       float* gscratch, int ll_words,
                                       long long team_stride) {
  extern __shared__ float smem[];
  const int g = blockIdx.x / ch;
  const int x = blockIdx.x % ch;
  const BtBlock bk{(int)threadIdx.x, (int)blockDim.x, 1};
  // layout 0: the team (LL first) in shared memory; 1: the LL at the
  // team's scratch row, the rest shared; 2: all of it in the scratch row
  float* tbase = smem;
  float* llbase = nullptr;
  if (kLayout > 0) {
    llbase = gscratch + (long long)blockIdx.x * team_stride;
    if (kLayout == 2) tbase = llbase + ll_words;
  }
  int* own_old = reinterpret_cast<int*>(tbase + team_words);  // [Q, S]
  int* own_new = own_old + q_max * S;                        // [Q, S]
  float* scratch = reinterpret_cast<float*>(own_new + q_max * S);  // [Q, S]
  const int m0 = goff[g], m1 = goff[g + 1];

  for (int t = t0; t < t1; ++t) {
    for (int m = m0; m < m1; ++m) {
      const BtNestedLevel& L = lv[gmem[2 * m]];
      const int c = gmem[2 * m + 1];
      const BtDims d = bt_dims(S, L.O, L.H);
      const BtPairs sm =
          kLayout == 0 ? bt_carve_pairs(smem + d.S * d.O, smem, d, 1)
                       : bt_carve_pairs(tbase, llbase, d, 1);
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

// The launch of a level table: threads, the layout (see the kernel), the
// words per team before the shared-k-mer rows, shared bytes and the
// scratch words per team.
struct BtNestedShape {
  int threads, layout, team_words, ll_words, q_max;
  size_t smem;
  long long scratch;
};

static BtNestedShape bt_nested_shape(const BtNestedLevel* levels, int n_levels,
                                     int S) {
  BtNestedShape n{64, 0, 0, 0, 0, 0, 0};
  int full = 0, small = 0;
  for (int l = 0; l < n_levels; ++l) {
    const BtDims d = bt_dims(S, levels[l].O, levels[l].H);
    full = max(full, bt_team_words(d));
    small = max(small, bt_team_small_words(d));
    n.ll_words = max(n.ll_words, d.S * d.O);
    n.q_max = max(n.q_max, levels[l].Q);
    const int need = d.S * d.G > d.H + 1 ? d.S * d.G : d.H + 1;
    n.threads = max(n.threads, min(256, ((need + 31) / 32) * 32));
  }
  const size_t rows = 3 * (size_t)n.q_max * S;
  const size_t limit = (size_t)bt_smem_optin();
  if ((full + rows) * 4 <= limit) {
    n.team_words = full;
    n.smem = (full + rows) * 4;
  } else if ((small + rows) * 4 <= limit) {
    n.layout = 1;
    n.team_words = small;
    n.smem = (small + rows) * 4;
    n.scratch = n.ll_words;
  } else {
    n.layout = 2;
    n.team_words = small;
    n.scratch = n.ll_words + small + (long long)rows;
  }
  return n;
}

int bt_nested_layout(const BtNestedLevel* levels_host, int n_levels, int S,
                     int64_t* scratch) {
  const BtNestedShape n = bt_nested_shape(levels_host, n_levels, S);
  *scratch = n.scratch;
  return n.layout;
}

template <int kLayout>
static cudaError_t bt_nested_launch(const BtNestedLevel* levels_dev,
                                    int* pool, const int* group_offsets,
                                    const int* group_members, int n_groups,
                                    int ch, int S, int t0, int t1, int burn_in,
                                    const BtNestedShape& n, float* scratch,
                                    cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bt_nested_sweep_kernel<kLayout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)n.smem);
  if (err != cudaSuccess) return err;
  bt_nested_sweep_kernel<kLayout><<<(unsigned)(n_groups * ch), n.threads,
                                    n.smem, stream>>>(
      levels_dev, pool, group_offsets, group_members, ch, S, n.q_max, t0, t1,
      burn_in, n.team_words, scratch, n.ll_words, n.scratch);
  return cudaGetLastError();
}

cudaError_t bt_nested_sweep(const BtNestedLevel* levels_dev, int n_levels,
                            const BtNestedLevel* levels_host, int* pool,
                            const int* group_offsets, const int* group_members,
                            int n_groups, int ch, int S, int t0, int t1,
                            int burn_in, float* scratch, cudaStream_t stream) {
  if (n_groups == 0 || t1 <= t0) return cudaSuccess;
  const BtNestedShape n = bt_nested_shape(levels_host, n_levels, S);
  if (n.layout > 0 && scratch == nullptr) return cudaErrorInvalidValue;
  switch (n.layout) {
    case 0:
      return bt_nested_launch<0>(levels_dev, pool, group_offsets,
                                 group_members, n_groups, ch, S, t0, t1,
                                 burn_in, n, scratch, stream);
    case 1:
      return bt_nested_launch<1>(levels_dev, pool, group_offsets,
                                 group_members, n_groups, ch, S, t0, t1,
                                 burn_in, n, scratch, stream);
    default:
      return bt_nested_launch<2>(levels_dev, pool, group_offsets,
                                 group_members, n_groups, ch, S, t0, t1,
                                 burn_in, n, scratch, stream);
  }
}
