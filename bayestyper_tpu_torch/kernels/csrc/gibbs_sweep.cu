// gibbs_sweep: the frozen-noise Gibbs scan of every (chunk, cluster, chain)
// pair, all iterations in one launch.
//
// Replaces the 350-step lax.scan of gibbs.genotype_stacked
// (bayestyper_tpu/model/gibbs.py:1842-1935), whose body is
// _gibbs_iteration + _sample_outcomes + sample_frequencies. There, every
// step re-read the [B, C, ch, S, O] LL and tally carries from HBM. Here a
// block owns consecutive pairs (several for O <= 128, one above; see
// gibbs_step.cuh) for the whole scan: their LL [S, O] (113 KB at H = 64,
// S = 13), frequencies and scratch live in shared memory, the per-iteration
// key is fold_in(chain_key, t), and after burn-in each drawn outcome adds
// one to a uint16 tally [pairs, S, O] in shared memory, added into the
// int32 tally in device memory once at the end of the launch (a launch runs
// at most 65,535 iterations on it). Bound: operations (the S*O exp per
// iteration, the threefry hashes and the lgamma/log of the frequency
// resample), not bytes — the LL is read once.
//
// Where the LL and the exp cache do not both fit in shared memory (H64
// from S = 13 on the H100) the global-memory variants (bt_launch_shape
// layouts 1-2) read each pair's LL in place from the input, which the scan
// never writes: once per step where every exp is cached (H64 to S = 24),
// else at every logit of the two-level draw, from L2/HBM. Where the tally
// does not fit beside the rest, each drawn outcome adds one to the device
// tally directly.
#include "gibbs_step.cuh"
#include "launchers.h"

#define BT_TALLY16_MAX_ITERS 65535

// at most 1,024 threads: <= 64 registers a thread
template <int kLayout>
__global__ void __launch_bounds__(1024) bt_gibbs_sweep_kernel(
    const float* __restrict__ ll, const signed char* __restrict__ ploidy,
    const bool* __restrict__ hap_valid, const float* __restrict__ sparsity,
    const bool* __restrict__ use_sparse,
    const int64_t* __restrict__ cluster_id,
    const unsigned* __restrict__ base_keys, const unsigned* __restrict__ fold,
    const int* __restrict__ oa, const int* __restrict__ ob, float* freqs,
    int* tally, int* osel_out, float* scratch, long long n_pairs, int ch,
    BtDims d, BtLaunch l, int t0, int t1, int burn_in) {
  extern __shared__ float smem[];
  const long long pair0 = (long long)blockIdx.x * l.pairs_per_block;
  const long long left = n_pairs - pair0;
  const BtBlock bk{(int)threadIdx.x, (int)blockDim.x,
                   (int)(left < l.pairs_per_block ? left : l.pairs_per_block)};
  const int SO = d.S * d.O;
  const float* ll_b = ll + pair0 * SO;

  BtOutcomes oc{nullptr, oa, ob};
  float* arrays = smem;
  if (l.tables_smem) {
    oc = bt_load_outcomes(oa, ob, d.O, reinterpret_cast<int*>(smem));
    arrays += bt_outcome_words(d.O);
  }
  BtPairs sm;
  if (kLayout == 0) {
    sm = bt_carve_pairs(arrays + l.pairs_per_block * SO, arrays, d, bk.np);
    for (int i = bk.tid; i < bk.np * SO; i += bk.nt) sm.ll[i] = ll_b[i];
  } else {
    if (kLayout == 2) arrays = scratch + pair0 * l.team_scratch;
    sm = bt_carve_pairs(arrays, const_cast<float*>(ll_b), d, bk.np);
  }
  unsigned short* t16 =
      l.tally_smem ? reinterpret_cast<unsigned short*>(smem + l.tally_offset)
                   : nullptr;
  if (t16 != nullptr)
    for (int i = bk.tid; i < bk.np * SO; i += bk.nt) t16[i] = 0;
  bt_load_pairs(bk, sm, d, pair0, ch, ploidy, hap_valid, freqs, sparsity,
                use_sparse, cluster_id, base_keys, fold);
  __syncthreads();

  const int rows = bk.np * d.S;
  for (int t = t0; t < t1; ++t) {
    bt_gibbs_step(bk, sm, d, oc, t);
    if (tally != nullptr && t >= burn_in) {
      // one thread per (pair, sample); the next write of osel is three
      // barriers into the next step
      for (int row = bk.tid; row < rows; row += bk.nt) {
        const int o = row * d.O + sm.osel[row];
        if (t16 != nullptr) t16[o] += 1;
        else tally[pair0 * SO + o] += 1;
      }
    }
  }
  __syncthreads();
  bt_store_freqs(bk, sm, d, pair0, freqs);
  if (osel_out != nullptr) {
    for (int row = bk.tid; row < rows; row += bk.nt)
      osel_out[pair0 * d.S + row] = sm.osel[row];
  }
  if (t16 != nullptr) {
    for (int i = bk.tid; i < bk.np * SO; i += bk.nt)
      if (t16[i] != 0) tally[pair0 * SO + i] += t16[i];
  }
}

int bt_gibbs_layout(int S, int O, int H, bool ll_written, int64_t* scratch) {
  const BtLaunch l = bt_launch_shape(S, O, H, ll_written);
  *scratch = l.ll_scratch + l.team_scratch;
  return l.layout;
}

template <int kLayout>
static cudaError_t bt_gibbs_sweep_launch(
    const float* ll, const int8_t* ploidy, const bool* hap_valid,
    const float* sparsity, const bool* use_sparse, const int64_t* cluster_id,
    const unsigned* base_keys, const unsigned* fold, const int* oa,
    const int* ob, float* freqs, int* tally, int* osel_out, float* scratch,
    long long n_pairs, int ch, BtDims d, BtLaunch l, int t0, int t1,
    int burn_in, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bt_gibbs_sweep_kernel<kLayout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem_bytes);
  if (err != cudaSuccess) return err;
  err = bt_fit_team(bt_gibbs_sweep_kernel<kLayout>, &l);
  if (err != cudaSuccess) return err;
  const long long blocks = (n_pairs + l.pairs_per_block - 1) / l.pairs_per_block;
  bt_gibbs_sweep_kernel<kLayout><<<(unsigned)blocks, l.threads, l.smem_bytes,
                                   stream>>>(
      ll, ploidy, hap_valid, sparsity, use_sparse, cluster_id, base_keys,
      fold, oa, ob, freqs, tally, osel_out, scratch, n_pairs, ch, d, l, t0,
      t1, burn_in);
  return cudaGetLastError();
}

cudaError_t bt_gibbs_sweep(const float* ll, const int8_t* ploidy,
                           const bool* hap_valid, const float* sparsity,
                           const bool* use_sparse, const int64_t* cluster_id,
                           const unsigned* base_keys, const unsigned* fold,
                           const int* oa, const int* ob, float* freqs,
                           int* tally, int* osel_out, float* scratch,
                           int64_t n_clusters, int ch, int S, int O, int H,
                           int t0, int t1, int burn_in, cudaStream_t stream) {
  const long long n_pairs = n_clusters * ch;
  const bool tally16 = tally != nullptr && t1 > burn_in &&
                       t1 - (t0 > burn_in ? t0 : burn_in) <= BT_TALLY16_MAX_ITERS;
  const BtLaunch l = bt_launch_shape(S, O, H, false, n_pairs, tally16);
  const BtDims d = l.d;
  if (n_pairs == 0) return cudaSuccess;
  if (l.layout < 0 || (l.layout == 2 && scratch == nullptr))
    return cudaErrorInvalidValue;
#define BT_SWEEP_ARGS                                                        \
  ll, ploidy, hap_valid, sparsity, use_sparse, cluster_id, base_keys, fold, \
      oa, ob, freqs, tally, osel_out, scratch, n_pairs, ch, d, l, t0, t1,   \
      burn_in, stream
  switch (l.layout) {
    case 0: return bt_gibbs_sweep_launch<0>(BT_SWEEP_ARGS);
    case 1: return bt_gibbs_sweep_launch<1>(BT_SWEEP_ARGS);
    default: return bt_gibbs_sweep_launch<2>(BT_SWEEP_ARGS);
  }
#undef BT_SWEEP_ARGS
}
