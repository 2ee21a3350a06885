// noise_rates: the conjugate gamma update of every chain's per-sample
// noise rates, once per noise or joint iteration.
//
// Replaces the tail of the scan bodies of gibbs.noise_chains_stacked and
// joint_chains_stacked (bayestyper_tpu/model/gibbs.py:2127-2135,
// :2222-2230; ops/sampling.fixed_round_gamma, sampling.py:35-71):
//   rates[x, s] = fixed_round_gamma(fold_in(k_noise[x], t),
//                                   prior_shape + count_sum[x, s])[s]
//                 * prior_scale / (num_obs[x, s] * prior_scale + 1)
// with the gamma's element index s of S (key batch [ch]). What depends on
// the keys only (the three gamma keys, the first round's normal and
// uniform and the boost uniform) is drawn for every iteration of the scan
// before it starts (noise_rates_draws.cu); this kernel reads iteration t's
// slice and does the data-dependent arithmetic only: the shape and scale,
// the first round's accept test, rounds 1-5 from the stored keys where it
// rejects, the boost where the shape is under one. One thread per (chain,
// sample), one block for up to 1,024 of them, writes the rates,
// log(max(rates, 1e-30)) for the next iteration's LL and the trace column
// t, and zeroes count_sum/num_obs for the next iteration's atomics, so an
// iteration runs kernels only. Bound: bytes (a few hundred per chain) and
// the launch itself; the first round's logs where it accepts.
#include "launchers.h"
#include "threefry.cuh"

__global__ void bt_noise_rates_kernel(const unsigned* __restrict__ keys,
                                      const float* __restrict__ draws,
                                      int* count_sum, int* num_obs,
                                      float* rates, float* log_r,
                                      float* trace, int n, int S, int T,
                                      int t, float prior_shape,
                                      float prior_scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = i / S, s = i % S;
  const float shape = prior_shape + (float)count_sum[i];
  const float scale = prior_scale / ((float)num_obs[i] * prior_scale + 1.0f);
  const unsigned* k = keys + x * 6;
  float g = bt_gamma_rounds(BtKey{k[2], k[3]}, BtKey{k[4], k[5]}, shape, s,
                            S, draws[i], draws[n + i]);
  if (shape < 1.0f) g = bt_gamma_boost(g, shape, draws[2 * n + i]);
  const float r = g * scale;
  rates[i] = r;
  log_r[i] = logf(fmaxf(r, 1e-30f));
  trace[((long long)x * T + t) * S + s] = r;
  count_sum[i] = 0;
  num_obs[i] = 0;
}

cudaError_t bt_noise_rates(const unsigned* keys, const float* draws,
                           int* count_sum, int* num_obs, float* rates,
                           float* log_r, float* trace, int ch, int S, int T,
                           int t, int slot, float prior_shape,
                           float prior_scale, cudaStream_t stream) {
  const int n = ch * S;
  if (n == 0) return cudaSuccess;
  const int threads = n < 1024 ? (n + 31) / 32 * 32 : 1024;
  bt_noise_rates_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
      keys + (long long)slot * ch * 6, draws + (long long)slot * 3 * n,
      count_sum, num_obs, rates, log_r, trace, n, S, T, t, prior_shape,
      prior_scale);
  return cudaGetLastError();
}
