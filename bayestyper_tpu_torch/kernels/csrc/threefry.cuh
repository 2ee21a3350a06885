// Counter-based random numbers shared by the kernels: JAX's
// partitionable threefry2x32 (see ops/prng.py for the stream layout) and the
// float conversions of jax.random.uniform / normal.
//
// Every stream built only from bits (keys, bits, uniforms, subsample masks)
// is bit-identical to JAX's. normal() uses XLA's float32 erfinv polynomial;
// the kernels are built with -fmad=false so every multiply and add rounds
// as torch's and XLA's elementwise ops do.
#pragma once

#include <stdint.h>

struct BtKey {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t bt_rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32, 20 rounds: (y0, y1) = threefry(key, (x0, x1))
__device__ __forceinline__ void bt_threefry(BtKey k, uint32_t x0, uint32_t x1,
                                            uint32_t& y0, uint32_t& y1) {
  const uint32_t ks[3] = {k.k0, k.k1, k.k0 ^ k.k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = bt_rotl(x1, rot[i & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  y0 = x0;
  y1 = x1;
}

// fold_in(key, d) == split(key, n)[d]: threefry(key, (0, d))
__device__ __forceinline__ BtKey bt_fold_in(BtKey k, uint32_t d) {
  BtKey out;
  bt_threefry(k, 0u, d, out.k0, out.k1);
  return out;
}

// 32 random bits at flat index i of random_bits(key, shape)
__device__ __forceinline__ uint32_t bt_bits(BtKey k, uint32_t i) {
  uint32_t y0, y1;
  bt_threefry(k, 0u, i, y0, y1);
  return y0 ^ y1;
}

// jax.random.uniform(key, shape, minval=lo, maxval=lo+span) at flat index i
__device__ __forceinline__ float bt_uniform(BtKey k, uint32_t i,
                                            float lo = 0.0f,
                                            float span = 1.0f) {
  const float f = __uint_as_float((bt_bits(k, i) >> 9) | 0x3F800000u) - 1.0f;
  return fmaxf(f * span + lo, lo);
}

// XLA's float32 erfinv (ErfInv32): w = -log1p(-x^2), degree-8 polynomial
__device__ __forceinline__ float bt_erfinv(float x) {
  const float lt5[9] = {2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f,
                        -4.39150654e-06f, 0.00021858087f, -0.00125372503f,
                        -0.00417768164f, 0.246640727f, 1.50140941f};
  const float ge5[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                        -0.00367342844f, 0.00573950773f, -0.0076224613f,
                        0.00943887047f, 1.00167406f, 2.83297682f};
  float w = -log1pf(-x * x);
  const bool lt = w < 5.0f;
  w = lt ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = (lt ? lt5[i] : ge5[i]) + p * w;
  return fabsf(x) == 1.0f ? x * INFINITY : p * x;
}

// jax.random.normal(key, shape) at flat index i: sqrt(2) * erfinv(u) with
// u uniform on [nextafter(-1, 0), 1)
__device__ __forceinline__ float bt_normal(BtKey k, uint32_t i) {
  const float u = bt_uniform(k, i, -0.99999994f, 2.0f);
  return 1.41421356f * bt_erfinv(u);
}

// The first round's normal and uniform of fixed_round_gamma's element e
// (round r draws index r * n + e).
__device__ __forceinline__ float bt_gamma_normal0(BtKey k_norm, int e) {
  return bt_normal(k_norm, (uint32_t)e);
}
__device__ __forceinline__ float bt_gamma_uniform0(BtKey k_unif, int e) {
  return bt_uniform(k_unif, (uint32_t)e, 1e-12f, 1.0f);
}

// The boost uniform of fixed_round_gamma's element e (alpha < 1).
__device__ __forceinline__ float bt_gamma_boost_uniform(BtKey k_boost, int e) {
  return bt_uniform(k_boost, (uint32_t)e, 1e-12f, 1.0f);
}

// The rejection rounds of ops/sampling.fixed_round_gamma for element e of n
// (alpha at that element) from its normal and uniform keys, fold_in(key, 1)
// and (key, 2), and its first round's normal x0 and uniform u0
// (bt_gamma_normal0, bt_gamma_uniform0): the sample before the boost.
__device__ __forceinline__ float bt_gamma_rounds(BtKey k_norm, BtKey k_unif,
                                                 float alpha, int e, int n,
                                                 float x0, float u0) {
  const int kRounds = 6;
  const float a_eff = alpha < 1.0f ? alpha + 1.0f : alpha;
  const float d = a_eff - 0.333333343f;
  const float c = 1.0f / sqrtf(9.0f * d);
  float sample = a_eff;  // mean fallback when no round accepts
  for (int r = 0; r < kRounds; ++r) {
    const uint32_t idx = (uint32_t)(r * n + e);
    const float x = r == 0 ? x0 : bt_normal(k_norm, idx);
    const float u = r == 0 ? u0 : bt_uniform(k_unif, idx, 1e-12f, 1.0f);
    const float t = 1.0f + c * x;
    const float v = t * (t * t);
    const bool ok = (v > 0.0f) &&
                    (logf(u) < 0.5f * x * x + d - d * v +
                                   d * logf(v > 0.0f ? v : 1.0f));
    if (ok) {
      sample = d * v;
      break;
    }
  }
  return sample;
}

// fixed_round_gamma's boost of a sample with alpha < 1, from its uniform ub
__device__ __forceinline__ float bt_gamma_boost(float sample, float alpha,
                                                float ub) {
  return sample * powf(ub, 1.0f / fmaxf(alpha, 1e-12f));
}

// ops/sampling.fixed_round_gamma for element e of n (alpha at that element),
// from the three keys it splits its key into: fold_in(key, 0), (key, 1) and
// (key, 2), and its first round's normal x0 and uniform u0. A caller drawing
// several elements derives the keys once, and may draw the first round
// ahead.
__device__ __forceinline__ float bt_fixed_round_gamma_keys(BtKey k_boost,
                                                           BtKey k_norm,
                                                           BtKey k_unif,
                                                           float alpha, int e,
                                                           int n, float x0,
                                                           float u0) {
  const float sample = bt_gamma_rounds(k_norm, k_unif, alpha, e, n, x0, u0);
  if (!(alpha < 1.0f)) return sample;
  return bt_gamma_boost(sample, alpha, bt_gamma_boost_uniform(k_boost, e));
}
