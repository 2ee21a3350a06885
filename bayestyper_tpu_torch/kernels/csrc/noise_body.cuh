// One noise-chain iteration of every (chunk, cluster, chain) pair of one
// stacked size class: the body shared by noise_step.cu (the noise phase)
// and joint_step.cu (joint noise + genotype estimation), so the two cannot
// drift apart. They differ only in the tally: kTally adds one to
// tally[pair, s, o_sel] for t >= burn_in (the joint chains' genotype
// tallies, gibbs.py:2207-2215).
//
// Per launch a block of consecutive pairs (several for O <= 128, one above;
// see gibbs_step.cuh) builds their LL [S, O] in shared memory from llg/a/b
// at each chain's current rates (ll = llg + a*log(r) - b*r, the null
// outcome zeroed), reading the block's span of llg, a and b in one
// coalesced pass; runs the Gibbs step shared with gibbs_sweep; and
// atomicAdds (int)(a_sel * cv) and (int)(b_sel * cv) into count_sum/num_obs
// [ch, S]: integer atomics keep the sums exact in any order. One thread
// owns each (pair, s), so the tally increment needs no atomic. The rate
// update that reads count_sum/num_obs is noise_rates.cu, launched after
// every class's step on the same stream. Bound: bytes — llg, a and b are
// read once per iteration.
//
// Where the LL and the exp cache do not both fit in shared memory (H64
// from S = 13) the global-memory variants (layouts 1-2 of bt_launch_shape)
// build the LL in a caller-allocated [pairs, S, O] scratch in device
// memory instead — the same expression written once and read back, so the
// bits are the shared layout's (recomputing it at every logit would read
// llg, a and b three times per iteration).
#pragma once

#include "gibbs_step.cuh"

// at most 1,024 threads: <= 64 registers a thread
template <bool kTally, int kLayout>
__global__ void __launch_bounds__(1024) bt_noise_pair_kernel(
    const float* __restrict__ llg, const float* __restrict__ a,
    const float* __restrict__ b, const float* __restrict__ cv,
    const float* __restrict__ log_r, const float* __restrict__ rates,
    const signed char* __restrict__ ploidy, const bool* __restrict__ hap_valid,
    const float* __restrict__ sparsity, const bool* __restrict__ use_sparse,
    const int64_t* __restrict__ cluster_id,
    const unsigned* __restrict__ base_keys, const unsigned* __restrict__ fold,
    const int* __restrict__ oa, const int* __restrict__ ob, float* freqs,
    int* count_sum, int* num_obs, int* tally, int* osel_out, float* scratch,
    long long n_pairs, int ch, BtDims d, BtLaunch l, int t, int burn_in) {
  extern __shared__ float smem[];
  const long long pair0 = (long long)blockIdx.x * l.pairs_per_block;
  const long long left = n_pairs - pair0;
  const BtBlock bk{(int)threadIdx.x, (int)blockDim.x,
                   (int)(left < l.pairs_per_block ? left : l.pairs_per_block)};
  const int S = d.S, O = d.O, SO = S * O;

  BtOutcomes oc{nullptr, oa, ob};
  float* arrays = smem;
  if (l.tables_smem) {
    oc = bt_load_outcomes(oa, ob, O, reinterpret_cast<int*>(smem));
    arrays += bt_outcome_words(O);
  }
  BtPairs sm;
  if (kLayout == 0) {
    sm = bt_carve_pairs(arrays + l.pairs_per_block * SO, arrays, d, bk.np);
  } else {
    // the scratch: the LL rows [pairs, ll_scratch], then the pairs' arrays
    // [pairs, team_scratch] (layout 2)
    if (kLayout == 2)
      arrays = scratch + n_pairs * l.ll_scratch + pair0 * l.team_scratch;
    sm = bt_carve_pairs(arrays, scratch + pair0 * l.ll_scratch, d, bk.np);
  }

  bt_load_pairs(bk, sm, d, pair0, ch, ploidy, hap_valid, freqs, sparsity,
                use_sparse, cluster_id, base_keys, fold);
  __syncthreads();
  const long long base = pair0 * SO;
  for (BtRowCol it(bk.tid, bk.nt, O); it.r < bk.np * S; it.next()) {
    const int i = it.r * O + it.c, p = d.dS(it.r);
    const int rs = sm.isc[p * BT_NISC + BT_I_CHAIN] * S + (it.r - p * S);
    const float part = it.c == O - 1
                           ? 0.0f
                           : a[base + i] * log_r[rs] - b[base + i] * rates[rs];
    sm.ll[i] = llg[base + i] + part;
  }
  __syncthreads();

  bt_gibbs_step(bk, sm, d, oc, t);

  for (int row = bk.tid; row < bk.np * S; row += bk.nt) {
    const int p = d.dS(row), s = row - p * S;
    const int chn = sm.isc[p * BT_NISC + BT_I_CHAIN];
    const int o = sm.osel[row];
    const float v = cv[(pair0 + p) / ch];
    const long long at = base + (long long)row * O + o;
    const int a_sel = (int)(a[at] * v);
    const int b_sel = (int)(b[at] * v);
    if (a_sel != 0) atomicAdd(count_sum + chn * S + s, a_sel);
    if (b_sel != 0) atomicAdd(num_obs + chn * S + s, b_sel);
    if (kTally && t >= burn_in) tally[at] += 1;
    if (osel_out != nullptr) osel_out[pair0 * S + row] = o;
  }
  bt_store_freqs(bk, sm, d, pair0, freqs);
}

// Host side of both launchers: layout, shared-memory opt-in, grid, launch.
template <bool kTally, int kLayout>
cudaError_t bt_noise_pair_launch_as(
    const float* llg, const float* a, const float* b, const float* cv,
    const float* log_r, const float* rates, const int8_t* ploidy,
    const bool* hap_valid, const float* sparsity, const bool* use_sparse,
    const int64_t* cluster_id, const unsigned* base_keys, const unsigned* fold,
    const int* oa, const int* ob, float* freqs, int* count_sum, int* num_obs,
    int* tally, int* osel_out, float* scratch, long long n_pairs, int ch,
    BtDims d, BtLaunch l, int t, int burn_in, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bt_noise_pair_kernel<kTally, kLayout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem_bytes);
  if (err != cudaSuccess) return err;
  err = bt_fit_team(bt_noise_pair_kernel<kTally, kLayout>, &l);
  if (err != cudaSuccess) return err;
  const long long blocks = (n_pairs + l.pairs_per_block - 1) / l.pairs_per_block;
  bt_noise_pair_kernel<kTally, kLayout><<<(unsigned)blocks, l.threads,
                                          l.smem_bytes, stream>>>(
      llg, a, b, cv, log_r, rates, ploidy, hap_valid, sparsity, use_sparse,
      cluster_id, base_keys, fold, oa, ob, freqs, count_sum, num_obs, tally,
      osel_out, scratch, n_pairs, ch, d, l, t, burn_in);
  return cudaGetLastError();
}

template <bool kTally>
cudaError_t bt_noise_pair_launch(
    const float* llg, const float* a, const float* b, const float* cv,
    const float* log_r, const float* rates, const int8_t* ploidy,
    const bool* hap_valid, const float* sparsity, const bool* use_sparse,
    const int64_t* cluster_id, const unsigned* base_keys, const unsigned* fold,
    const int* oa, const int* ob, float* freqs, int* count_sum, int* num_obs,
    int* tally, int* osel_out, float* scratch, int64_t n_clusters, int ch,
    int S, int O, int H, int t, int burn_in, cudaStream_t stream) {
  const long long n_pairs = n_clusters * ch;
  const BtLaunch l = bt_launch_shape(S, O, H, true, n_pairs);
  const BtDims d = l.d;
  if (n_pairs == 0) return cudaSuccess;
  if (l.layout < 0 || (l.layout > 0 && scratch == nullptr))
    return cudaErrorInvalidValue;
#define BT_NOISE_ARGS                                                        \
  llg, a, b, cv, log_r, rates, ploidy, hap_valid, sparsity, use_sparse,     \
      cluster_id, base_keys, fold, oa, ob, freqs, count_sum, num_obs, tally, \
      osel_out, scratch, n_pairs, ch, d, l, t, burn_in, stream
  switch (l.layout) {
    case 0: return bt_noise_pair_launch_as<kTally, 0>(BT_NOISE_ARGS);
    case 1: return bt_noise_pair_launch_as<kTally, 1>(BT_NOISE_ARGS);
    default: return bt_noise_pair_launch_as<kTally, 2>(BT_NOISE_ARGS);
  }
#undef BT_NOISE_ARGS
}
