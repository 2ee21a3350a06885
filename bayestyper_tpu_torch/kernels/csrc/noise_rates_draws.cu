// noise_rates_draws: the key-only values of every rate update of a noise or
// joint scan, drawn once before its first iteration.
//
// Part of the same JAX program as noise_rates.cu (the rate update of
// gibbs.noise_chains_stacked and joint_chains_stacked,
// bayestyper_tpu/model/gibbs.py:2127-2135, :2222-2230): for iteration t and
// chain x, fixed_round_gamma splits fold_in(k_noise[x], t) into k_boost,
// k_norm and k_unif (ops/sampling.py:35-71), and element s draws its first
// round's normal and uniform and its boost uniform from them. None of that
// depends on the scan's data, so one launch computes it for iterations
// t0 .. t0 + n_t - 1 with the functions the update used inline
// (threefry.cuh), giving the same bits: keys [n_t, ch, 3, 2] words and
// draws [n_t, 3, ch, S] floats. One thread per (iteration, chain, sample);
// the thread of sample 0 writes the (iteration, chain) keys. Bound:
// operations (four threefry hashes per (iteration, chain), three and the
// erfinv polynomial per element), a launch per scan.
#include "launchers.h"
#include "threefry.cuh"

__global__ void bt_noise_rates_draws_kernel(
    const unsigned* __restrict__ k_noise, unsigned* __restrict__ keys,
    float* __restrict__ draws, int ch, int S, int t0, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = (int)(i % S);
  const long long row = i / S;  // (iteration, chain)
  const int x = (int)(row % ch);
  const long long ti = row / ch;
  const BtKey key = bt_fold_in(BtKey{k_noise[2 * x], k_noise[2 * x + 1]},
                               (uint32_t)(t0 + ti));
  const BtKey k_boost = bt_fold_in(key, 0), k_norm = bt_fold_in(key, 1),
              k_unif = bt_fold_in(key, 2);
  const long long plane = (long long)ch * S;
  float* d = draws + ti * 3 * plane + (long long)x * S + s;
  d[0] = bt_gamma_normal0(k_norm, s);
  d[plane] = bt_gamma_uniform0(k_unif, s);
  d[2 * plane] = bt_gamma_boost_uniform(k_boost, s);
  if (s == 0) {
    unsigned* k = keys + row * 6;
    k[0] = k_boost.k0;
    k[1] = k_boost.k1;
    k[2] = k_norm.k0;
    k[3] = k_norm.k1;
    k[4] = k_unif.k0;
    k[5] = k_unif.k1;
  }
}

cudaError_t bt_noise_rates_draws(const unsigned* k_noise, unsigned* keys,
                                 float* draws, int ch, int S, int t0, int n_t,
                                 cudaStream_t stream) {
  const long long n = (long long)n_t * ch * S;
  if (n == 0) return cudaSuccess;
  const int threads = 256;
  bt_noise_rates_draws_kernel<<<(unsigned)((n + threads - 1) / threads),
                                threads, 0, stream>>>(k_noise, keys, draws,
                                                      ch, S, t0, n);
  return cudaGetLastError();
}
