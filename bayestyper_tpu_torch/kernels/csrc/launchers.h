// Host launchers of the kernels, one per csrc/*.cu. bindings.cpp calls
// them with tensor pointers on the current stream; each .cu includes this
// header, so a launcher whose definition drifts from its declaration does not
// compile. Each returns the launch's cudaError_t.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// The current device's opt-in shared memory per block
// (cudaDevAttrMaxSharedMemoryPerBlockOptin), read once per device. Every
// launcher sizes its shared layout against it and takes its global-memory
// variant above it.
inline int bt_smem_optin() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev >= 0 && dev < 64 && cached[dev] > 0) return cached[dev];
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  if (dev >= 0 && dev < 64) cached[dev] = bytes;
  return bytes;
}

// The current device's number of SMs, read once per device.
inline int bt_sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev >= 0 && dev < 64 && cached[dev] > 0) return cached[dev];
  int n = 1;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      n < 1)
    return 1;
  if (dev >= 0 && dev < 64) cached[dev] = n;
  return n;
}

// The layout a kernel with a global-memory variant launches with (see each
// .cu): 0 its shared-memory layout, 1 or 2 a variant that keeps its large
// arrays in device memory, -1 a shape that not even the variant can run.
// *scratch is what the variant needs of the caller's device-memory scratch
// (4-byte words per pair for the Gibbs kernels, per (group, chain) team for
// nested_sweep, bytes per pair for kmer_cap). The launchers take the
// scratch and compute the same layout again.
int bt_gibbs_layout(int S, int O, int H, bool ll_written, int64_t* scratch);
int bt_kmer_cap_layout(int K, int V, int H, int64_t* scratch);
// 0 where a tile of 32 k-mers fits the card's opt-in shared memory, else -1
int bt_ll_noise_terms_layout(int64_t C, int K, int H, int S, int O, int ch,
                             int noise);

cudaError_t bt_subsample_masks(const unsigned* base_keys, const unsigned* fold,
                               const int64_t* cluster_id,
                               const bool* kmer_valid, bool* out, int64_t C,
                               int ch, int K, float rate, unsigned salt,
                               cudaStream_t stream);

// wbits [C, ch, ceil(K / 32)]: the masks packed as kernels.pack_bits does
cudaError_t bt_ll_noise_terms(const uint8_t* mult, const uint8_t* inter,
                              const uint8_t* counts, const unsigned* wbits,
                              const float* tables, int m_rows, int mmax,
                              const int* oa, const int* ob, float* ll,
                              float* A, float* B, float* C0, int64_t C, int K,
                              int H, int S, int ch, int O,
                              int include_noise_row, cudaStream_t stream);

cudaError_t bt_gibbs_sweep(const float* ll, const int8_t* ploidy,
                           const bool* hap_valid, const float* sparsity,
                           const bool* use_sparse, const int64_t* cluster_id,
                           const unsigned* base_keys, const unsigned* fold,
                           const int* oa, const int* ob, float* freqs,
                           int* tally, int* osel_out, float* scratch,
                           int64_t n_clusters, int ch, int S, int O, int H,
                           int t0, int t1, int burn_in, cudaStream_t stream);

cudaError_t bt_noise_step(const float* llg, const float* a, const float* b,
                          const float* cv, const float* log_r,
                          const float* rates, const int8_t* ploidy,
                          const bool* hap_valid, const float* sparsity,
                          const bool* use_sparse, const int64_t* cluster_id,
                          const unsigned* base_keys, const unsigned* fold,
                          const int* oa, const int* ob, float* freqs,
                          int* count_sum, int* num_obs, int* osel_out,
                          float* scratch, int64_t n_clusters, int ch, int S,
                          int O, int H, int t, cudaStream_t stream);

cudaError_t bt_joint_step(const float* llg, const float* a, const float* b,
                          const float* cv, const float* log_r,
                          const float* rates, const int8_t* ploidy,
                          const bool* hap_valid, const float* sparsity,
                          const bool* use_sparse, const int64_t* cluster_id,
                          const unsigned* base_keys, const unsigned* fold,
                          const int* oa, const int* ob, float* freqs,
                          int* count_sum, int* num_obs, int* tally,
                          int* osel_out, float* scratch, int64_t n_clusters,
                          int ch, int S, int O, int H, int t, int burn_in,
                          cudaStream_t stream);

cudaError_t bt_noise_rates(const unsigned* k_noise, int* count_sum,
                           int* num_obs, float* rates, float* log_r,
                           float* trace, int ch, int S, int T, int t,
                           float prior_shape, float prior_scale,
                           cudaStream_t stream);

// keys [N, 2] uint32 words, alpha and out [N, E]
cudaError_t bt_gamma_draw(const unsigned* keys, const float* alpha, float* out,
                          int64_t N, int E, cudaStream_t stream);

cudaError_t bt_unpack_bucket(const uint8_t* flat_counts,
                             const uint8_t* flat_inter_fm,
                             const uint8_t* flat_mult, const int* flat_member,
                             const int64_t* lens, const int64_t* gcol,
                             uint8_t* counts, uint8_t* inter, uint8_t* mult,
                             int* member, bool* valid, int64_t n_rows, int C,
                             int K, int S, int H, int VW,
                             cudaStream_t stream);

// keys [M, 2] and queries [N, 2] int64 (hi, lo) pairs, 16-byte aligned
cudaError_t bt_lane_lookup(const int64_t* keys, const uint8_t* payload,
                           const bool* valid, const int64_t* queries,
                           uint8_t* out, int64_t M, int64_t N, int P,
                           cudaStream_t stream);

cudaError_t bt_bloom_query(const unsigned* bits, const int* word,
                           const int* shift, bool* out, int64_t N, int H,
                           cudaStream_t stream);

cudaError_t bt_kmer_cap(const unsigned* base_keys, const unsigned* fold,
                        const int64_t* cluster_id, const bool* w,
                        const unsigned* member, bool* out, int64_t C, int ch,
                        int K, int V, int W, int H, int cap, unsigned salt,
                        void* scratch, cudaStream_t stream);

// Inputs, sizes and outputs of bucket_stats; outputs not written in the
// chosen form are null (packed: gt_tally, al_tally, denom, gt int8, saf,
// nak/fak/mac float16; unpacked: gpp, app, gq, gt int32, saf, nak/fak/mac
// float32).
struct BtStatsArgs {
  const uint8_t *mult, *inter, *counts;
  const unsigned* member;
  const int16_t *hap_allele, *num_alleles;
  const int8_t* ploidy;
  const int* tally;
  const bool* w;
  const int *oa, *ob;
  const float* fak_thresh;  // [S]
  const float* missing;     // [3, C, S] (nak, fak, mac) or null
  const float* mac_extra;   // [C, S, V, A] or null
  int C, K, H, S, V, W, ch, O, A, G, T;
  float min_gpp, min_nak;
  int packed;
  int *gt_tally, *al_tally, *denom;
  void* gt;
  uint8_t* saf;
  void *nak, *fak, *mac;
  float *gpp, *app, *gq;
};

// scratch: *scratch 4-byte words of device memory from
// bt_bucket_stats_layout, which every shape needs (the bit words and the
// top-T candidates; layout 1 also its rows)
cudaError_t bt_bucket_stats(const BtStatsArgs& args, float* scratch,
                            cudaStream_t stream);
int bt_bucket_stats_layout(const BtStatsArgs& args, int64_t* scratch);

// One rank level of the coupled scan (kernels.NestedLevel); the shared
// k-mer and MAC pointers are null on levels without them.
struct BtNestedLevel {
  const float* ll;            // [C, ch, S, O]
  const int8_t* ploidy;       // [C, S]
  const int* parent_level;    // [C]
  const int* parent_row;      // [C]
  const int8_t* retain;       // [C, o_pad]
  const bool* hap_valid;      // [C, H]
  const float* sparsity;      // [C]
  const bool* use_sparse;     // [C]
  const int64_t* cluster_id;  // [C]
  const int *oa, *ob;         // [O]
  float* freqs;               // [C * ch, H]
  int* ocur;                  // [C, ch, S]
  int* tally;                 // [C, ch, S, O]
  const int* sh_slot;         // [C, Q]
  const bool* sh_valid;       // [C, Q]
  const int* sh_counts;       // [C, Q, S]
  const int* sh_inter;        // [C, Q, S]
  const int* sh_dip;          // [C, Q, O]
  const bool* sh_w;           // [C, ch, Q]
  const float* tcut;          // [C, Q, S, mmax + 1]
  const uint8_t* mem;         // [C, Q, V, H + 1]
  const float* n_hv;          // [C, ch, V, H + 1]
  const int* ha;              // [C, H + 1, V]
  float* mac_acc;             // [C, ch, S, V, A]
  unsigned key0, key1;
  int C, H, O, Q, V, A, mmax, o_pad;
};

// The coupled scan's member table [N, BT_MD] int32: the groups' members in
// rank order, each row (level, row, its containment parent's index within
// the group or -1, its valid shared rows, the word offset of its state in
// the on-chip layout (bt_nested_layout fills it), H, O, the parent's O,
// its first row of the shared-row table). The shared-row table [NQ, 2]
// holds (q, the slot within the group's dense pool range); the group's
// dense slots map to global pool slots through gslot [pofs[g]:pofs[g+1]].
enum {
  BT_MD_LEVEL, BT_MD_ROW, BT_MD_PARENT, BT_MD_NQ, BT_MD_WOFF, BT_MD_H,
  BT_MD_O, BT_MD_PO, BT_MD_QOFF, BT_MD
};

cudaError_t bt_nested_sweep(const BtNestedLevel* levels_dev, int n_levels,
                            const BtNestedLevel* levels_host, int* pool,
                            const int* md_dev, int* md_host,
                            const int* goff_dev, const int* goff_host,
                            int n_groups, const int* qrows_dev,
                            const int* pofs_dev, const int* pofs_host,
                            const int* gslot_dev, int* glist_dev, int ch,
                            int S, int t0, int t1, int burn_in,
                            float* scratch, cudaStream_t stream,
                            cudaStream_t side);
// 0: the on-chip layout; 1, 2: the global-memory variants
int bt_nested_layout(const BtNestedLevel* levels_host, int n_levels,
                     int* md_host, const int* goff_host, int n_groups,
                     const int* pofs_host, int S, int t0, int t1, int burn_in,
                     int64_t* scratch);
