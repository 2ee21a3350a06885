// PyTorch bindings of the kernels, built with
// torch.utils.cpp_extension.load (kernels/__init__.py). Each binding takes
// the kernel's tensors, checks their device, dtype, shape and layout against
// what the kernel reads, allocates the outputs and launches on the current
// stream. A mismatch or a failed launch raises.
#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>

#include <cstring>
#include <tuple>
#include <vector>

#include "launchers.h"

namespace {

void expect(const at::Tensor& t, const char* name, at::ScalarType dtype,
            at::IntArrayRef shape, const at::Device& dev) {
  TORCH_CHECK(t.device() == dev, name, " is on ", t.device(), ", expected ",
              dev);
  TORCH_CHECK(t.scalar_type() == dtype, name, " is ", t.scalar_type(),
              "; the kernel reads ", dtype);
  TORCH_CHECK(t.sizes() == shape, name, " has shape ", t.sizes(),
              ", expected ", shape);
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

void launched(cudaError_t err, const char* name) {
  TORCH_CHECK(err == cudaSuccess, "kernel ", name, " failed to launch: ",
              cudaGetErrorString(err));
}

// uint32 key words, stored in int32 tensors
const unsigned* u32(const at::Tensor& t) {
  return reinterpret_cast<const unsigned*>(t.data_ptr<int32_t>());
}

cudaStream_t stream() { return at::cuda::getCurrentCUDAStream(); }

// The device-memory scratch of a Gibbs-team kernel's global-memory variant
// (gibbs_step.cuh bt_launch_shape), or an undefined tensor for the shared
// layout; raises, with the shape, where no layout fits.
std::tuple<at::Tensor, int64_t> gibbs_scratch(const char* name, int64_t n,
                                              int64_t s, int64_t o, int64_t h,
                                              bool ll_written,
                                              const at::TensorOptions& f32) {
  int64_t words = 0;
  const int layout = bt_gibbs_layout((int)s, (int)o, (int)h, ll_written, &words);
  TORCH_CHECK(layout >= 0, name, ": no layout fits S = ", s, ", O = ", o,
              ", H = ", h, " in ", bt_smem_optin(), " bytes of shared memory");
  at::Tensor scratch;
  if (words > 0) scratch = at::empty({n, words}, f32);
  return {scratch, layout};
}

float* ptr_or_null(const at::Tensor& t) {
  return t.defined() ? t.data_ptr<float>() : nullptr;
}

// Checks shared by the two Gibbs kernels: pair rows [N, ...] with
// N = clusters * chains in (cluster, chain) order, per-cluster fields,
// per-chain keys and the outcome tables.
void expect_pairs(const at::Tensor& ll, const at::Tensor& ploidy,
                  const at::Tensor& hap_valid, const at::Tensor& sparsity,
                  const at::Tensor& use_sparse, const at::Tensor& cluster_id,
                  const at::Tensor& base_keys, const at::Tensor& fold,
                  const at::Tensor& oa, const at::Tensor& ob,
                  const at::Tensor& freqs, int64_t ch) {
  const auto dev = ll.device();
  TORCH_CHECK(dev.is_cuda(), "ll is on ", dev, "; the kernel runs on CUDA");
  TORCH_CHECK(ll.dim() == 3 && freqs.dim() == 2, "ll [N, S, O], freqs [N, H]");
  const int64_t n = ll.size(0), s = ll.size(1), o = ll.size(2);
  const int64_t h = freqs.size(1);
  TORCH_CHECK(ch > 0 && n % ch == 0, n, " pairs for ", ch, " chains");
  TORCH_CHECK(o == h * (h + 1) / 2 + h + 1, "O = ", o, " for H = ", h);
  const int64_t ncl = n / ch;
  expect(ll, "ll", at::kFloat, {n, s, o}, dev);
  expect(ploidy, "ploidy", at::kChar, {ncl, s}, dev);
  expect(hap_valid, "hap_valid", at::kBool, {ncl, h}, dev);
  expect(sparsity, "sparsity", at::kFloat, {ncl}, dev);
  expect(use_sparse, "use_sparse", at::kBool, {ncl}, dev);
  expect(cluster_id, "cluster_id", at::kLong, {ncl}, dev);
  expect(base_keys, "base_keys", at::kInt, {ch, 2}, dev);
  expect(fold, "fold", at::kInt, {ch}, dev);
  expect(oa, "oa", at::kInt, {o}, dev);
  expect(ob, "ob", at::kInt, {o}, dev);
  expect(freqs, "freqs", at::kFloat, {n, h}, dev);
}

}  // namespace

at::Tensor subsample_masks(const at::Tensor& base_keys, const at::Tensor& fold,
                           const at::Tensor& cluster_id,
                           const at::Tensor& kmer_valid, double rate,
                           int64_t salt) {
  const auto dev = kmer_valid.device();
  TORCH_CHECK(dev.is_cuda() && kmer_valid.dim() == 2,
              "kmer_valid: a [C, K] CUDA tensor");
  const int64_t c = kmer_valid.size(0), k = kmer_valid.size(1);
  const int64_t ch = base_keys.size(0);
  expect(kmer_valid, "kmer_valid", at::kBool, {c, k}, dev);
  expect(cluster_id, "cluster_id", at::kLong, {c}, dev);
  expect(base_keys, "base_keys", at::kInt, {ch, 2}, dev);
  expect(fold, "fold", at::kInt, {ch}, dev);
  const c10::cuda::CUDAGuard guard(dev);
  auto out = at::empty({c, ch, k}, kmer_valid.options());
  launched(bt_subsample_masks(u32(base_keys), u32(fold),
                              cluster_id.data_ptr<int64_t>(),
                              kmer_valid.data_ptr<bool>(),
                              out.data_ptr<bool>(), c, (int)ch, (int)k,
                              (float)rate, (unsigned)(salt & 0xFFFFFFFF),
                              stream()),
           "subsample_masks");
  return out;
}

std::vector<at::Tensor> ll_noise_terms(
    const at::Tensor& mult, const at::Tensor& inter, const at::Tensor& counts,
    const at::Tensor& wbits, const at::Tensor& tables, int64_t mmax,
    const at::Tensor& oa, const at::Tensor& ob, bool include_noise_row,
    bool noise_terms) {
  const auto dev = mult.device();
  TORCH_CHECK(dev.is_cuda() && mult.dim() == 3 && counts.dim() == 3 &&
                  wbits.dim() == 3 && tables.dim() == 3,
              "mult [C, K, H], counts [C, K, S], wbits [C, ch, K / 32], "
              "tables [S, M, 256]: CUDA tensors");
  const int64_t c = mult.size(0), k = mult.size(1), h = mult.size(2);
  const int64_t s = counts.size(2), ch = wbits.size(1), o = ob.size(0);
  const int64_t m_rows = tables.size(1);
  TORCH_CHECK(0 <= mmax && mmax < m_rows, "mmax ", mmax, " outside the ",
              "table's ", m_rows, " rows");
  expect(mult, "mult", at::kByte, {c, k, h}, dev);
  expect(inter, "inter", at::kByte, {c, k, s}, dev);
  expect(counts, "counts", at::kByte, {c, k, s}, dev);
  expect(wbits, "wbits", at::kInt, {c, ch, (k + 31) / 32}, dev);
  expect(tables, "tables", at::kFloat, {s, m_rows, 256}, dev);
  expect(oa, "oa", at::kInt, {h * (h + 1) / 2 + h + 1}, dev);
  expect(ob, "ob", at::kInt, {o}, dev);
  const c10::cuda::CUDAGuard guard(dev);
  TORCH_CHECK(bt_ll_noise_terms_layout(c, (int)k, (int)h, (int)s, (int)o,
                                       (int)ch, noise_terms ? 1 : 0) == 0,
              "ll_noise_terms: no tile of 32 k-mers fits H = ", h,
              ", S = ", s, " in ", bt_smem_optin(),
              " bytes of shared memory");
  std::vector<at::Tensor> out;
  for (int i = 0; i < (noise_terms ? 4 : 1); ++i)
    out.push_back(at::empty({c, ch, s, o}, tables.options()));
  float* abc[3] = {nullptr, nullptr, nullptr};
  for (int i = 0; noise_terms && i < 3; ++i) abc[i] = out[i + 1].data_ptr<float>();
  launched(bt_ll_noise_terms(mult.data_ptr<uint8_t>(), inter.data_ptr<uint8_t>(),
                             counts.data_ptr<uint8_t>(), u32(wbits),
                             tables.data_ptr<float>(), (int)m_rows, (int)mmax,
                             oa.data_ptr<int32_t>(), ob.data_ptr<int32_t>(),
                             out[0].data_ptr<float>(), abc[0], abc[1], abc[2],
                             c, (int)k, (int)h, (int)s, (int)ch, (int)o,
                             include_noise_row ? 1 : 0, stream()),
           "ll_noise_terms");
  return out;
}

std::tuple<at::Tensor, int64_t> gibbs_sweep(
                       const at::Tensor& ll, const at::Tensor& ploidy,
                       const at::Tensor& hap_valid, const at::Tensor& sparsity,
                       const at::Tensor& use_sparse,
                       const at::Tensor& cluster_id,
                       const at::Tensor& base_keys, const at::Tensor& fold,
                       const at::Tensor& oa, const at::Tensor& ob,
                       at::Tensor freqs, std::optional<at::Tensor> tally,
                       int64_t t0, int64_t t1, int64_t burn_in) {
  const int64_t ch = base_keys.size(0);
  expect_pairs(ll, ploidy, hap_valid, sparsity, use_sparse, cluster_id,
               base_keys, fold, oa, ob, freqs, ch);
  const int64_t n = ll.size(0), s = ll.size(1), o = ll.size(2);
  int* tally_p = nullptr;
  if (tally.has_value()) {
    expect(*tally, "tally", at::kInt, {n, s, o}, ll.device());
    tally_p = tally->data_ptr<int32_t>();
  }
  const c10::cuda::CUDAGuard guard(ll.device());
  auto osel = at::empty({n, s}, oa.options());
  auto [scratch, layout] = gibbs_scratch("gibbs_sweep", n, s, o,
                                         freqs.size(1), false, ll.options());
  launched(bt_gibbs_sweep(ll.data_ptr<float>(), ploidy.data_ptr<int8_t>(),
                          hap_valid.data_ptr<bool>(), sparsity.data_ptr<float>(),
                          use_sparse.data_ptr<bool>(),
                          cluster_id.data_ptr<int64_t>(), u32(base_keys),
                          u32(fold), oa.data_ptr<int32_t>(),
                          ob.data_ptr<int32_t>(), freqs.data_ptr<float>(),
                          tally_p, osel.data_ptr<int32_t>(),
                          ptr_or_null(scratch), n / ch, (int)ch,
                          (int)s, (int)o, (int)freqs.size(1), (int)t0, (int)t1,
                          (int)burn_in, stream()),
           "gibbs_sweep");
  return {osel, layout};
}

// noise_step and joint_step: the per-iteration noise LL inputs and the
// [ch, S] statistics on top of the pair checks; joint_step's tally too.
static void expect_noise_pairs(const at::Tensor& llg, const at::Tensor& a,
                        const at::Tensor& b, const at::Tensor& cv,
                        const at::Tensor& log_r, const at::Tensor& rates,
                        const at::Tensor& ploidy, const at::Tensor& hap_valid,
                        const at::Tensor& sparsity,
                        const at::Tensor& use_sparse,
                        const at::Tensor& cluster_id,
                        const at::Tensor& base_keys, const at::Tensor& fold,
                        const at::Tensor& oa, const at::Tensor& ob,
                        const at::Tensor& freqs, const at::Tensor& count_sum,
                        const at::Tensor& num_obs) {
  const int64_t ch = base_keys.size(0);
  expect_pairs(llg, ploidy, hap_valid, sparsity, use_sparse, cluster_id,
               base_keys, fold, oa, ob, freqs, ch);
  const auto dev = llg.device();
  const int64_t n = llg.size(0), s = llg.size(1), o = llg.size(2);
  expect(a, "a", at::kFloat, {n, s, o}, dev);
  expect(b, "b", at::kFloat, {n, s, o}, dev);
  expect(cv, "cv", at::kFloat, {n / ch}, dev);
  expect(log_r, "log_r", at::kFloat, {ch, s}, dev);
  expect(rates, "rates", at::kFloat, {ch, s}, dev);
  expect(count_sum, "count_sum", at::kInt, {ch, s}, dev);
  expect(num_obs, "num_obs", at::kInt, {ch, s}, dev);
}

std::tuple<at::Tensor, int64_t> noise_step(
                      const at::Tensor& llg, const at::Tensor& a,
                      const at::Tensor& b, const at::Tensor& cv,
                      const at::Tensor& log_r, const at::Tensor& rates,
                      const at::Tensor& ploidy, const at::Tensor& hap_valid,
                      const at::Tensor& sparsity, const at::Tensor& use_sparse,
                      const at::Tensor& cluster_id, const at::Tensor& base_keys,
                      const at::Tensor& fold, const at::Tensor& oa,
                      const at::Tensor& ob, at::Tensor freqs,
                      at::Tensor count_sum, at::Tensor num_obs, int64_t t) {
  expect_noise_pairs(llg, a, b, cv, log_r, rates, ploidy, hap_valid, sparsity,
                     use_sparse, cluster_id, base_keys, fold, oa, ob, freqs,
                     count_sum, num_obs);
  const int64_t ch = base_keys.size(0);
  const int64_t n = llg.size(0), s = llg.size(1), o = llg.size(2);
  const c10::cuda::CUDAGuard guard(llg.device());
  auto osel = at::empty({n, s}, oa.options());
  auto [scratch, layout] = gibbs_scratch("noise_step", n, s, o, freqs.size(1),
                                         true, llg.options());
  launched(bt_noise_step(llg.data_ptr<float>(), a.data_ptr<float>(),
                         b.data_ptr<float>(), cv.data_ptr<float>(),
                         log_r.data_ptr<float>(), rates.data_ptr<float>(),
                         ploidy.data_ptr<int8_t>(), hap_valid.data_ptr<bool>(),
                         sparsity.data_ptr<float>(), use_sparse.data_ptr<bool>(),
                         cluster_id.data_ptr<int64_t>(), u32(base_keys),
                         u32(fold), oa.data_ptr<int32_t>(),
                         ob.data_ptr<int32_t>(), freqs.data_ptr<float>(),
                         count_sum.data_ptr<int32_t>(),
                         num_obs.data_ptr<int32_t>(), osel.data_ptr<int32_t>(),
                         ptr_or_null(scratch), n / ch, (int)ch, (int)s, (int)o,
                         (int)freqs.size(1), (int)t, stream()),
           "noise_step");
  return {osel, layout};
}

std::tuple<at::Tensor, int64_t> joint_step(
                      const at::Tensor& llg, const at::Tensor& a,
                      const at::Tensor& b, const at::Tensor& cv,
                      const at::Tensor& log_r, const at::Tensor& rates,
                      const at::Tensor& ploidy, const at::Tensor& hap_valid,
                      const at::Tensor& sparsity, const at::Tensor& use_sparse,
                      const at::Tensor& cluster_id, const at::Tensor& base_keys,
                      const at::Tensor& fold, const at::Tensor& oa,
                      const at::Tensor& ob, at::Tensor freqs,
                      at::Tensor count_sum, at::Tensor num_obs,
                      at::Tensor tally, int64_t t, int64_t burn_in) {
  expect_noise_pairs(llg, a, b, cv, log_r, rates, ploidy, hap_valid, sparsity,
                     use_sparse, cluster_id, base_keys, fold, oa, ob, freqs,
                     count_sum, num_obs);
  const int64_t ch = base_keys.size(0);
  const int64_t n = llg.size(0), s = llg.size(1), o = llg.size(2);
  expect(tally, "tally", at::kInt, {n, s, o}, llg.device());
  const c10::cuda::CUDAGuard guard(llg.device());
  auto osel = at::empty({n, s}, oa.options());
  auto [scratch, layout] = gibbs_scratch("joint_step", n, s, o, freqs.size(1),
                                         true, llg.options());
  launched(bt_joint_step(llg.data_ptr<float>(), a.data_ptr<float>(),
                         b.data_ptr<float>(), cv.data_ptr<float>(),
                         log_r.data_ptr<float>(), rates.data_ptr<float>(),
                         ploidy.data_ptr<int8_t>(), hap_valid.data_ptr<bool>(),
                         sparsity.data_ptr<float>(), use_sparse.data_ptr<bool>(),
                         cluster_id.data_ptr<int64_t>(), u32(base_keys),
                         u32(fold), oa.data_ptr<int32_t>(),
                         ob.data_ptr<int32_t>(), freqs.data_ptr<float>(),
                         count_sum.data_ptr<int32_t>(),
                         num_obs.data_ptr<int32_t>(), tally.data_ptr<int32_t>(),
                         osel.data_ptr<int32_t>(), ptr_or_null(scratch),
                         n / ch, (int)ch, (int)s, (int)o, (int)freqs.size(1),
                         (int)t, (int)burn_in, stream()),
           "joint_step");
  return {osel, layout};
}

std::vector<at::Tensor> noise_rates_draws(const at::Tensor& k_noise,
                                          int64_t t0, int64_t n_t,
                                          int64_t s) {
  const auto dev = k_noise.device();
  TORCH_CHECK(dev.is_cuda() && k_noise.dim() == 2,
              "k_noise [ch, 2]: a CUDA tensor");
  const int64_t ch = k_noise.size(0);
  TORCH_CHECK(t0 >= 0 && n_t >= 0 && s >= 0 && t0 + n_t <= INT32_MAX,
              "iterations ", t0, " + ", n_t, " of ", s, " samples");
  expect(k_noise, "k_noise", at::kInt, {ch, 2}, dev);
  const c10::cuda::CUDAGuard guard(dev);
  auto keys = at::empty({n_t, ch, 3, 2}, k_noise.options());
  auto draws = at::empty({n_t, 3, ch, s}, k_noise.options().dtype(at::kFloat));
  launched(bt_noise_rates_draws(u32(k_noise),
                                reinterpret_cast<unsigned*>(
                                    keys.data_ptr<int32_t>()),
                                draws.data_ptr<float>(), (int)ch, (int)s,
                                (int)t0, (int)n_t, stream()),
           "noise_rates_draws");
  return {keys, draws};
}

void noise_rates(const at::Tensor& keys, const at::Tensor& draws,
                 int64_t slot, at::Tensor count_sum, at::Tensor num_obs,
                 at::Tensor rates, at::Tensor log_r, at::Tensor trace,
                 int64_t t, double prior_shape, double prior_scale) {
  const auto dev = rates.device();
  TORCH_CHECK(dev.is_cuda() && rates.dim() == 2 && trace.dim() == 3 &&
                  keys.dim() == 4,
              "rates [ch, S], trace [ch, T, S], keys [n_t, ch, 3, 2]: CUDA "
              "tensors");
  const int64_t ch = rates.size(0), s = rates.size(1), n_t = trace.size(1);
  const int64_t n_draws = keys.size(0);
  TORCH_CHECK(0 <= t && t < n_t, "iteration ", t, " outside the trace's ",
              n_t);
  TORCH_CHECK(0 <= slot && slot < n_draws, "draw slice ", slot,
              " outside the draws' ", n_draws);
  expect(keys, "keys", at::kInt, {n_draws, ch, 3, 2}, dev);
  expect(draws, "draws", at::kFloat, {n_draws, 3, ch, s}, dev);
  expect(count_sum, "count_sum", at::kInt, {ch, s}, dev);
  expect(num_obs, "num_obs", at::kInt, {ch, s}, dev);
  expect(rates, "rates", at::kFloat, {ch, s}, dev);
  expect(log_r, "log_r", at::kFloat, {ch, s}, dev);
  expect(trace, "trace", at::kFloat, {ch, n_t, s}, dev);
  const c10::cuda::CUDAGuard guard(dev);
  launched(bt_noise_rates(u32(keys), draws.data_ptr<float>(),
                          count_sum.data_ptr<int32_t>(),
                          num_obs.data_ptr<int32_t>(), rates.data_ptr<float>(),
                          log_r.data_ptr<float>(), trace.data_ptr<float>(),
                          (int)ch, (int)s, (int)n_t, (int)t, (int)slot,
                          (float)prior_shape, (float)prior_scale, stream()),
           "noise_rates");
}

at::Tensor gamma_draw(const at::Tensor& keys, const at::Tensor& alpha) {
  const auto dev = alpha.device();
  TORCH_CHECK(dev.is_cuda() && alpha.dim() == 2,
              "alpha: a [N, E] CUDA tensor");
  const int64_t n = alpha.size(0), e = alpha.size(1);
  TORCH_CHECK(e <= INT32_MAX, e, " elements per key");
  expect(keys, "keys", at::kInt, {n, 2}, dev);
  expect(alpha, "alpha", at::kFloat, {n, e}, dev);
  const c10::cuda::CUDAGuard guard(dev);
  auto out = at::empty_like(alpha);
  launched(bt_gamma_draw(u32(keys), alpha.data_ptr<float>(),
                         out.data_ptr<float>(), n, (int)e, stream()),
           "gamma_draw");
  return out;
}

std::vector<at::Tensor> unpack_bucket(const at::Tensor& flat_counts,
                                      const at::Tensor& flat_inter_fm,
                                      const at::Tensor& flat_mult,
                                      const at::Tensor& flat_member,
                                      const at::Tensor& lens,
                                      const at::Tensor& gcol, int64_t k) {
  const auto dev = flat_counts.device();
  TORCH_CHECK(dev.is_cuda() && flat_counts.dim() == 2 &&
                  flat_mult.dim() == 2 && flat_member.dim() == 3 &&
                  lens.dim() == 1,
              "flat_counts [N, S], flat_mult [N, H], flat_member [N, V, W], "
              "lens [C]: CUDA tensors");
  const int64_t rows = flat_counts.size(0), s = flat_counts.size(1);
  const int64_t h = flat_mult.size(1), v = flat_member.size(1);
  const int64_t words = flat_member.size(2), c = lens.size(0);
  TORCH_CHECK(k >= 0, "k = ", k);
  expect(flat_counts, "flat_counts", at::kByte, {rows, s}, dev);
  expect(flat_inter_fm, "flat_inter_fm", at::kByte, {rows, 2}, dev);
  expect(flat_mult, "flat_mult", at::kByte, {rows, h}, dev);
  expect(flat_member, "flat_member", at::kInt, {rows, v, words}, dev);
  expect(lens, "lens", at::kLong, {c}, dev);
  expect(gcol, "gcol", at::kLong, {s}, dev);
  const c10::cuda::CUDAGuard guard(dev);
  const auto u8 = flat_counts.options();
  std::vector<at::Tensor> out = {
      at::empty({c, k, s}, u8), at::empty({c, k, s}, u8),
      at::empty({c, k, h}, u8), at::empty({c, k, v, words}, flat_member.options()),
      at::empty({c, k}, u8.dtype(at::kBool))};
  launched(bt_unpack_bucket(flat_counts.data_ptr<uint8_t>(),
                            flat_inter_fm.data_ptr<uint8_t>(),
                            flat_mult.data_ptr<uint8_t>(),
                            flat_member.data_ptr<int>(),
                            lens.data_ptr<int64_t>(), gcol.data_ptr<int64_t>(),
                            out[0].data_ptr<uint8_t>(),
                            out[1].data_ptr<uint8_t>(),
                            out[2].data_ptr<uint8_t>(), out[3].data_ptr<int>(),
                            out[4].data_ptr<bool>(), rows, (int)c, (int)k,
                            (int)s, (int)h, (int)(v * words), stream()),
           "unpack_bucket");
  return out;
}

at::Tensor lane_lookup(const at::Tensor& keys, const at::Tensor& payload,
                       const at::Tensor& valid, const at::Tensor& queries) {
  const auto dev = keys.device();
  TORCH_CHECK(dev.is_cuda() && keys.dim() == 2 && payload.dim() == 2 &&
                  queries.dim() == 2,
              "keys [M, 2], payload [M, P], queries [N, 2]: CUDA tensors");
  const int64_t m = keys.size(0), p = payload.size(1), n = queries.size(0);
  expect(keys, "keys", at::kLong, {m, 2}, dev);
  expect(payload, "payload", at::kByte, {m, p}, dev);
  expect(valid, "valid", at::kBool, {m}, dev);
  expect(queries, "queries", at::kLong, {n, 2}, dev);
  // the kernel reads a (hi, lo) pair as one 16-byte load
  TORCH_CHECK(reinterpret_cast<uintptr_t>(keys.data_ptr()) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(queries.data_ptr()) % 16 == 0,
              "keys and queries must start on a 16-byte boundary");
  const c10::cuda::CUDAGuard guard(dev);
  auto out = at::empty({n, p}, payload.options());
  launched(bt_lane_lookup(keys.data_ptr<int64_t>(), payload.data_ptr<uint8_t>(),
                          valid.data_ptr<bool>(), queries.data_ptr<int64_t>(),
                          out.data_ptr<uint8_t>(), m, n, (int)p, stream()),
           "lane_lookup");
  return out;
}

at::Tensor bloom_query(const at::Tensor& bits, const at::Tensor& word,
                       const at::Tensor& shift) {
  const auto dev = bits.device();
  TORCH_CHECK(dev.is_cuda() && bits.dim() == 1 && word.dim() == 2,
              "bits [W], word [H, N], shift [H, N]: CUDA tensors");
  const int64_t n_words = bits.size(0), h = word.size(0), n = word.size(1);
  TORCH_CHECK(h >= 1, "at least one hash, got ", h);
  // int32 word indices reach 2^31 words and no further
  TORCH_CHECK(n_words <= (int64_t{1} << 31), "a bloom of ", n_words,
              " words is beyond int32 word indices");
  expect(bits, "bits", at::kInt, {n_words}, dev);
  expect(word, "word", at::kInt, {h, n}, dev);
  expect(shift, "shift", at::kInt, {h, n}, dev);
  const c10::cuda::CUDAGuard guard(dev);
  auto out = at::empty({n}, word.options().dtype(at::kBool));
  launched(bt_bloom_query(u32(bits), word.data_ptr<int>(), shift.data_ptr<int>(),
                          out.data_ptr<bool>(), n, (int)h, stream()),
           "bloom_query");
  return out;
}


std::tuple<at::Tensor, int64_t> kmer_cap(
                    const at::Tensor& base_keys, const at::Tensor& fold,
                    const at::Tensor& cluster_id, const at::Tensor& w,
                    const at::Tensor& member, int64_t num_haplotypes,
                    int64_t cap, int64_t salt) {
  const auto dev = w.device();
  TORCH_CHECK(dev.is_cuda() && w.dim() == 3 && member.dim() == 4,
              "w [C, ch, K], member [C, K, V, W]: CUDA tensors");
  const int64_t c = w.size(0), ch = w.size(1), k = w.size(2);
  const int64_t v = member.size(2), words = member.size(3);
  TORCH_CHECK(words * 32 >= num_haplotypes, words, " member words for ",
              num_haplotypes, " haplotypes");
  expect(w, "w", at::kBool, {c, ch, k}, dev);
  expect(member, "member", at::kInt, {c, k, v, words}, dev);
  expect(cluster_id, "cluster_id", at::kLong, {c}, dev);
  expect(base_keys, "base_keys", at::kInt, {ch, 2}, dev);
  expect(fold, "fold", at::kInt, {ch}, dev);
  const c10::cuda::CUDAGuard guard(dev);
  auto out = at::empty_like(w);
  int64_t per_pair = 0;
  const int layout = bt_kmer_cap_layout((int)k, (int)v, (int)words,
                                        (int)num_haplotypes, &per_pair);
  TORCH_CHECK(layout >= 0, "kmer_cap: no layout fits K = ", k, " in ",
              bt_smem_optin(), " bytes of shared memory");
  at::Tensor scratch;
  if (per_pair > 0)
    scratch = at::empty({c * ch, per_pair}, w.options().dtype(at::kByte));
  launched(bt_kmer_cap(u32(base_keys), u32(fold),
                       cluster_id.data_ptr<int64_t>(), w.data_ptr<bool>(),
                       u32(member), out.data_ptr<bool>(), c, (int)ch, (int)k,
                       (int)v, (int)words, (int)num_haplotypes, (int)cap,
                       (unsigned)(salt & 0xFFFFFFFF),
                       scratch.defined() ? scratch.data_ptr() : nullptr,
                       stream()),
           "kmer_cap");
  return {out, layout};
}

std::tuple<std::vector<at::Tensor>, int64_t> bucket_stats(
    const at::Tensor& mult, const at::Tensor& inter, const at::Tensor& counts,
    const at::Tensor& member, const at::Tensor& hap_allele,
    const at::Tensor& num_alleles, const at::Tensor& ploidy,
    const at::Tensor& tally, const at::Tensor& w, const at::Tensor& oa,
    const at::Tensor& ob, const at::Tensor& fak_thresh,
    std::optional<at::Tensor> missing, std::optional<at::Tensor> mac_extra,
    int64_t a_cap, int64_t t_top, double min_gpp, double min_nak,
    bool packed) {
  const auto dev = tally.device();
  TORCH_CHECK(dev.is_cuda() && mult.dim() == 3 && tally.dim() == 4 &&
                  member.dim() == 4,
              "mult [C, K, H], tally [C, ch, S, O], member [C, K, V, W]: "
              "CUDA tensors");
  const int64_t c = mult.size(0), k = mult.size(1), h = mult.size(2);
  const int64_t ch = tally.size(1), s = tally.size(2), o = tally.size(3);
  const int64_t v = member.size(2), words = member.size(3);
  const int64_t g = a_cap * (a_cap + 1) / 2;
  TORCH_CHECK(o == h * (h + 1) / 2 + h + 1, "O = ", o, " for H = ", h);
  TORCH_CHECK(0 < t_top && t_top <= o, "top-T ", t_top, " of ", o);
  TORCH_CHECK(0 < a_cap && a_cap < 128, "allele capacity ", a_cap);
  expect(mult, "mult", at::kByte, {c, k, h}, dev);
  expect(inter, "inter", at::kByte, {c, k, s}, dev);
  expect(counts, "counts", at::kByte, {c, k, s}, dev);
  expect(member, "member", at::kInt, {c, k, v, words}, dev);
  expect(hap_allele, "hap_allele", at::kShort, {c, h, v}, dev);
  expect(num_alleles, "num_alleles", at::kShort, {c, v}, dev);
  expect(ploidy, "ploidy", at::kChar, {c, s}, dev);
  expect(tally, "tally", at::kInt, {c, ch, s, o}, dev);
  expect(w, "w", at::kBool, {c, ch, k}, dev);
  expect(oa, "oa", at::kInt, {o}, dev);
  expect(ob, "ob", at::kInt, {o}, dev);
  expect(fak_thresh, "fak_thresh", at::kFloat, {s}, dev);
  BtStatsArgs a{};
  if (missing.has_value()) {
    expect(*missing, "missing", at::kFloat, {3, c, s}, dev);
    a.missing = missing->data_ptr<float>();
  }
  if (mac_extra.has_value()) {
    expect(*mac_extra, "mac_extra", at::kFloat, {c, s, v, a_cap}, dev);
    a.mac_extra = mac_extra->data_ptr<float>();
  }
  const c10::cuda::CUDAGuard guard(dev);
  const auto i32 = tally.options();
  const auto f32 = i32.dtype(at::kFloat);
  const auto diag = packed ? i32.dtype(at::kHalf) : f32;
  std::vector<at::Tensor> out;
  if (packed) {
    out = {at::empty({c, s, v, g}, i32), at::empty({c, s, v, a_cap}, i32),
           at::empty({c, s}, i32), at::empty({c, s, v, 2}, i32.dtype(at::kChar))};
    a.gt_tally = out[0].data_ptr<int>();
    a.al_tally = out[1].data_ptr<int>();
    a.denom = out[2].data_ptr<int>();
  } else {
    out = {at::empty({c, s, v, g}, f32), at::empty({c, s, v, a_cap}, f32),
           at::empty({c, s, v}, f32), at::empty({c, s, v, 2}, i32)};
    a.gpp = out[0].data_ptr<float>();
    a.app = out[1].data_ptr<float>();
    a.gq = out[2].data_ptr<float>();
  }
  a.gt = out[3].data_ptr();
  out.push_back(at::empty({c, s, v, a_cap}, i32.dtype(at::kByte)));
  a.saf = out[4].data_ptr<uint8_t>();
  for (int i = 0; i < 3; ++i) out.push_back(at::empty({c, s, v, a_cap}, diag));
  a.nak = out[5].data_ptr();
  a.fak = out[6].data_ptr();
  a.mac = out[7].data_ptr();
  a.mult = mult.data_ptr<uint8_t>();
  a.inter = inter.data_ptr<uint8_t>();
  a.counts = counts.data_ptr<uint8_t>();
  a.member = u32(member);
  a.hap_allele = hap_allele.data_ptr<int16_t>();
  a.num_alleles = num_alleles.data_ptr<int16_t>();
  a.ploidy = ploidy.data_ptr<int8_t>();
  a.tally = tally.data_ptr<int>();
  a.w = w.data_ptr<bool>();
  a.oa = oa.data_ptr<int>();
  a.ob = ob.data_ptr<int>();
  a.fak_thresh = fak_thresh.data_ptr<float>();
  a.C = (int)c; a.K = (int)k; a.H = (int)h; a.S = (int)s; a.V = (int)v;
  a.W = (int)words; a.ch = (int)ch; a.O = (int)o; a.A = (int)a_cap;
  a.G = (int)g; a.T = (int)t_top;
  a.min_gpp = (float)min_gpp;
  a.min_nak = (float)min_nak;
  a.packed = packed ? 1 : 0;
  int64_t rows = 0;
  const int layout = bt_bucket_stats_layout(a, &rows);
  TORCH_CHECK(layout >= 0, "bucket_stats: no layout fits O = ", o, ", K = ",
              k, ", chains = ", ch, ", top-T ", t_top, " in ",
              bt_smem_optin(), " bytes of shared memory");
  at::Tensor scratch;
  if (rows > 0) scratch = at::empty({rows}, f32);
  launched(bt_bucket_stats(a, ptr_or_null(scratch), stream()),
           "bucket_stats");
  return {out, layout};
}

// Tensors per level, in kernels.nested_sweep's order.
constexpr int kNestedTensors = 25;

std::tuple<at::Tensor, int64_t> nested_sweep(
                  const std::vector<at::Tensor>& flat,
                  const std::vector<int64_t>& ints, at::Tensor pool,
                  const at::Tensor& members, const at::Tensor& group_offsets,
                  const at::Tensor& qrows, const at::Tensor& pool_offsets,
                  const at::Tensor& gslot, int64_t t0, int64_t t1,
                  int64_t burn_in) {
  const auto dev = pool.device();
  const auto cpu = at::Device(at::kCPU);
  TORCH_CHECK(dev.is_cuda() && pool.dim() == 3, "pool [P, ch, S] on CUDA");
  TORCH_CHECK(flat.size() % kNestedTensors == 0 &&
                  ints.size() * kNestedTensors == 3 * flat.size(),
              "per level ", kNestedTensors, " tensors and 3 integers");
  const int64_t ch = pool.size(1), s = pool.size(2);
  expect(pool, "pool", at::kInt, {pool.size(0), ch, s}, dev);
  const int64_t n_groups = group_offsets.size(0) - 1;
  const int64_t n_members = members.size(0);
  TORCH_CHECK(n_groups >= 0, "group offsets [G + 1]");
  expect(members, "members", at::kInt, {n_members, 4}, cpu);
  expect(group_offsets, "group_offsets", at::kInt, {n_groups + 1}, cpu);
  expect(qrows, "qrows", at::kInt, {qrows.size(0), 2}, cpu);
  expect(pool_offsets, "pool_offsets", at::kInt, {n_groups + 1}, cpu);
  expect(gslot, "gslot", at::kInt, {gslot.size(0)}, cpu);
  const int n_levels = (int)(flat.size() / kNestedTensors);
  std::vector<BtNestedLevel> host(n_levels);
  for (int l = 0; l < n_levels; ++l) {
    const at::Tensor* t = flat.data() + (size_t)l * kNestedTensors;
    const at::Tensor &ll = t[0], &hap_valid = t[5], &tcut = t[20],
                     &acc = t[24];
    TORCH_CHECK(ll.dim() == 4 && hap_valid.dim() == 2 && t[4].dim() == 2,
                "level ", l, ": ll [C, ch, S, O], hap_valid [C, H], retain "
                "[C, O_pad]");
    const int64_t c = ll.size(0), o = ll.size(3), h = hap_valid.size(1);
    TORCH_CHECK(o == h * (h + 1) / 2 + h + 1, "level ", l, ": O = ", o,
                " for H = ", h);
    expect(ll, "ll", at::kFloat, {c, ch, s, o}, dev);
    expect(t[1], "ploidy", at::kChar, {c, s}, dev);
    expect(t[2], "parent_level", at::kInt, {c}, dev);
    expect(t[3], "parent_row", at::kInt, {c}, dev);
    expect(t[4], "retain", at::kChar, {c, t[4].size(1)}, dev);
    expect(hap_valid, "hap_valid", at::kBool, {c, h}, dev);
    expect(t[6], "sparsity", at::kFloat, {c}, dev);
    expect(t[7], "use_sparse", at::kBool, {c}, dev);
    expect(t[8], "cluster_id", at::kLong, {c}, dev);
    expect(t[9], "oa", at::kInt, {o}, dev);
    expect(t[10], "ob", at::kInt, {o}, dev);
    expect(t[11], "freqs", at::kFloat, {c * ch, h}, dev);
    expect(t[12], "ocur", at::kInt, {c, ch, s}, dev);
    expect(t[13], "tally", at::kInt, {c, ch, s, o}, dev);
    BtNestedLevel& L = host[l];
    L = BtNestedLevel{};
    L.ll = ll.data_ptr<float>();
    L.ploidy = t[1].data_ptr<int8_t>();
    L.parent_level = t[2].data_ptr<int>();
    L.parent_row = t[3].data_ptr<int>();
    L.retain = t[4].data_ptr<int8_t>();
    L.hap_valid = hap_valid.data_ptr<bool>();
    L.sparsity = t[6].data_ptr<float>();
    L.use_sparse = t[7].data_ptr<bool>();
    L.cluster_id = t[8].data_ptr<int64_t>();
    L.oa = t[9].data_ptr<int>();
    L.ob = t[10].data_ptr<int>();
    L.freqs = t[11].data_ptr<float>();
    L.ocur = t[12].data_ptr<int>();
    L.tally = t[13].data_ptr<int>();
    L.C = (int)c; L.H = (int)h; L.O = (int)o; L.o_pad = (int)t[4].size(1);
    L.mmax = (int)ints[3 * l];
    L.key0 = (unsigned)(ints[3 * l + 1] & 0xFFFFFFFF);
    L.key1 = (unsigned)(ints[3 * l + 2] & 0xFFFFFFFF);
    if (t[14].numel()) {
      const int64_t q = t[14].size(1);
      TORCH_CHECK(tcut.dim() == 4 && tcut.size(3) == L.mmax + 1, "level ", l,
                  ": tcut [C, Q, S, mmax + 1]");
      expect(t[14], "sh_slot", at::kInt, {c, q}, dev);
      expect(t[15], "sh_valid", at::kBool, {c, q}, dev);
      expect(t[16], "sh_counts", at::kInt, {c, q, s}, dev);
      expect(t[17], "sh_inter", at::kInt, {c, q, s}, dev);
      expect(t[18], "sh_dip", at::kInt, {c, q, o}, dev);
      expect(t[19], "sh_w", at::kBool, {c, ch, q}, dev);
      expect(tcut, "tcut", at::kFloat, {c, q, s, L.mmax + 1}, dev);
      L.Q = (int)q;
      L.sh_slot = t[14].data_ptr<int>();
      L.sh_valid = t[15].data_ptr<bool>();
      L.sh_counts = t[16].data_ptr<int>();
      L.sh_inter = t[17].data_ptr<int>();
      L.sh_dip = t[18].data_ptr<int>();
      L.sh_w = t[19].data_ptr<bool>();
      L.tcut = tcut.data_ptr<float>();
      if (acc.numel()) {
        TORCH_CHECK(acc.dim() == 5, "level ", l, ": acc [C, ch, S, V, A]");
        const int64_t v = acc.size(3), a = acc.size(4);
        expect(t[21], "mem", at::kByte, {c, q, v, h + 1}, dev);
        expect(t[22], "n_hv", at::kFloat, {c, ch, v, h + 1}, dev);
        expect(t[23], "ha", at::kInt, {c, h + 1, v}, dev);
        expect(acc, "acc", at::kFloat, {c, ch, s, v, a}, dev);
        L.V = (int)v;
        L.A = (int)a;
        L.mem = t[21].data_ptr<uint8_t>();
        L.n_hv = t[22].data_ptr<float>();
        L.ha = t[23].data_ptr<int>();
        L.mac_acc = acc.data_ptr<float>();
      }
    }
  }
  // the member table with its per-level fields, checked against the levels
  const int32_t* mem = members.data_ptr<int32_t>();
  const int32_t* goff = group_offsets.data_ptr<int32_t>();
  const int32_t* pofs = pool_offsets.data_ptr<int32_t>();
  TORCH_CHECK(goff[0] == 0 && goff[n_groups] == n_members && pofs[0] == 0 &&
                  pofs[n_groups] == gslot.size(0),
              "group and pool offsets do not cover the members and slots");
  std::vector<int> md((size_t)n_members * BT_MD, 0);
  int64_t q_total = 0;
  for (int64_t g = 0; g < n_groups; ++g) {
    TORCH_CHECK(goff[g] <= goff[g + 1] && pofs[g] <= pofs[g + 1],
                "group ", g, ": offsets decrease");
    for (int64_t m = goff[g]; m < goff[g + 1]; ++m) {
      const int32_t* r = mem + 4 * m;
      TORCH_CHECK(0 <= r[0] && r[0] < n_levels && 0 <= r[1] &&
                      r[1] < host[r[0]].C,
                  "member ", m, ": no row ", r[1], " at level ", r[0]);
      TORCH_CHECK(-1 <= r[2] && r[2] < m - goff[g], "member ", m, ": its parent ", r[2],
                  " is not an earlier member of its group");
      TORCH_CHECK(0 <= r[3] && r[3] <= host[r[0]].Q, "member ", m, ": ",
                  r[3], " shared rows");
      int* d = md.data() + (size_t)m * BT_MD;
      d[BT_MD_LEVEL] = r[0];
      d[BT_MD_ROW] = r[1];
      d[BT_MD_PARENT] = r[2];
      d[BT_MD_NQ] = r[3];
      d[BT_MD_H] = host[r[0]].H;
      d[BT_MD_O] = host[r[0]].O;
      d[BT_MD_PO] = r[2] >= 0 ? host[mem[4 * (goff[g] + r[2])]].O : 0;
      d[BT_MD_QOFF] = (int)q_total;
      q_total += r[3];
    }
  }
  TORCH_CHECK(q_total == qrows.size(0), "the members hold ", q_total,
              " shared rows, the table ", qrows.size(0));
  int64_t words = 0;
  const int layout = bt_nested_layout(host.data(), n_levels, md.data(), goff,
                                      (int)n_groups, pofs, (int)s, (int)t0,
                                      (int)t1, (int)burn_in, &words);
  // one device buffer: the level table, then md, goff, qrows, pofs, gslot
  const c10::cuda::CUDAGuard guard(dev);
  const size_t lv_bytes = ((n_levels * sizeof(BtNestedLevel) + 15) / 16) * 16;
  std::vector<int> ints_buf(md);
  ints_buf.insert(ints_buf.end(), goff, goff + n_groups + 1);
  const size_t q_at = ints_buf.size();
  ints_buf.insert(ints_buf.end(), qrows.data_ptr<int32_t>(),
                  qrows.data_ptr<int32_t>() + 2 * qrows.size(0));
  const size_t p_at = ints_buf.size();
  ints_buf.insert(ints_buf.end(), pofs, pofs + n_groups + 1);
  const size_t s_at = ints_buf.size();
  ints_buf.insert(ints_buf.end(), gslot.data_ptr<int32_t>(),
                  gslot.data_ptr<int32_t>() + gslot.size(0));
  std::vector<uint8_t> blob(lv_bytes + ints_buf.size() * sizeof(int));
  std::memcpy(blob.data(), host.data(), n_levels * sizeof(BtNestedLevel));
  std::memcpy(blob.data() + lv_bytes, ints_buf.data(),
              ints_buf.size() * sizeof(int));
  auto buf = at::empty({(int64_t)blob.size()}, pool.options().dtype(at::kByte));
  launched(cudaMemcpyAsync(buf.data_ptr(), blob.data(), blob.size(),
                           cudaMemcpyHostToDevice, stream()),
           "nested_sweep (tables)");
  const int* ib = reinterpret_cast<const int*>(buf.data_ptr<uint8_t>() +
                                               lv_bytes);
  at::Tensor scratch;
  if (words > 0)
    scratch = at::empty({n_groups * ch, words}, pool.options().dtype(at::kFloat));
  // the launch order of the groups (bt_nested_sweep splits them by size)
  auto glist = at::empty({std::max<int64_t>(n_groups, 1)},
                         pool.options().dtype(at::kInt));
  const auto side = at::cuda::getStreamFromPool(false, dev.index());
  launched(bt_nested_sweep(reinterpret_cast<const BtNestedLevel*>(
                               buf.data_ptr()),
                           n_levels, host.data(), pool.data_ptr<int>(), ib,
                           md.data(), ib + md.size(), goff, (int)n_groups,
                           ib + q_at, ib + p_at, pofs, ib + s_at,
                           glist.data_ptr<int>(), (int)ch, (int)s, (int)t0,
                           (int)t1, (int)burn_in, ptr_or_null(scratch),
                           stream(), side.stream()),
           "nested_sweep");
  return {pool, layout};
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("subsample_masks", &subsample_masks);
  m.def("ll_noise_terms", &ll_noise_terms);
  m.def("gibbs_sweep", &gibbs_sweep);
  m.def("noise_step", &noise_step);
  m.def("joint_step", &joint_step);
  m.def("noise_rates_draws", &noise_rates_draws);
  m.def("noise_rates", &noise_rates);
  m.def("gamma_draw", &gamma_draw);
  m.def("unpack_bucket", &unpack_bucket);
  m.def("kmer_cap", &kmer_cap);
  m.def("bucket_stats", &bucket_stats);
  m.def("nested_sweep", &nested_sweep);
  m.def("lane_lookup", &lane_lookup);
  m.def("bloom_query", &bloom_query);
}
