// Decode-burst paged attention for Hopper (sm_90a): kernel B.
//
// Replaces the Pallas TPU kernel
// githubrepostorag_tpu/ops/pallas_paged.py::paged_attention_decode_staged
// (_decode_staged_kernel, pallas_call at pallas_paged.py:395), with its two
// pool branches: full-precision and int8 rank-5 pools, the int8 ones with one
// f32 scale per (layer, kv head, page).  One decode query per row b attends,
// with online softmax, to the frozen pool prefix (pool_lens[b] tokens through
// its block table) and then to the burst's staged K/V tail (entries <
// staged_len).  The pools are the whole [L, n_kv, P, ps, hd] tensors plus a
// layer index: no per-layer slice is copied.  Masked scores are -1e30; a row
// with no valid KV writes 0; scores and accumulators are f32.  The staged
// tail is in the activation dtype whatever the pools hold.
//
// What bounds it on this card: each key is read once (2 * hd * 2 bytes of K
// and V in bf16, half that in int8) and used by the group's 7 queries, ~2-4
// FLOPs per byte, far below the H100's ~295 FLOP/byte ridge: device-memory
// bytes bound it.
//
// Design: the TPU grid (B, max_pages + 1) walked pages in order on one core.
// Here the pool prefix is split across blocks by pages (flash-decoding, the
// split-K body of decode_attention.cuh: TMA-fed tiles, tensor cores for bf16
// queries, int8 pages dequantized by their page scale in f32 on the scores
// and on P); the last block of each (row, kv head) to finish, which merges
// the splits' partials, also takes the staged tail: at most n_steps keys,
// read once.

#include "decode_attention.cuh"

namespace {

template <typename T, int HD>
int launch_pool(int pool, const port::decode::Launch& a, cudaStream_t st) {
  using port::decode::launch;
  if (pool == port::POOL_FP) return launch<T, T, HD, false, true>(a, st);
  if (pool == port::POOL_INT8) return launch<T, int8_t, HD, true, true>(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, n_q, hd]; pools [L, n_kv, P, ps, hd] in q's dtype, or int8 with
// k_scales / v_scales [L, n_kv, P] f32; staged [B, n_kv, n_steps, hd] in q's
// dtype; workspace (the splits' partials), counters ([B, n_kv] int32, 0
// between launches) and (pages_per_split, n_splits) from the wrapper and its
// plan (ops/paged_decode._plan_decode).
extern "C" int paged_decode_staged_launch(
    const void* q, const void* k_pages, const void* v_pages, const void* staged_k,
    const void* staged_v, void* out, const int* block_tables, const int* pool_lens,
    const float* k_scales, const float* v_scales, void* workspace, void* counters, int B,
    int n_q, int n_kv, int num_pages, int page_size, int head_dim, int max_pages, int n_steps,
    int staged_len, int layer, int dtype, int pool, int pages_per_split, int n_splits,
    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (staged_len < 1 || staged_len > n_steps) return (int)cudaErrorInvalidValue;
  // this layer's pools and scales
  const size_t layer_elems = (size_t)layer * n_kv * num_pages * page_size * head_dim;
  const size_t elem = pool == port::POOL_INT8 ? 1 : dtype == port::DTYPE_BF16 ? 2 : 4;
  const size_t layer_scales = (size_t)layer * n_kv * num_pages;
  const bool quant = pool == port::POOL_INT8;
  const port::decode::Launch a{
      q, static_cast<const char*>(k_pages) + layer_elems * elem,
      static_cast<const char*>(v_pages) + layer_elems * elem, staged_k, staged_v, out,
      block_tables, pool_lens, nullptr, quant ? k_scales + layer_scales : nullptr,
      quant ? v_scales + layer_scales : nullptr, static_cast<float*>(workspace),
      static_cast<int*>(counters), B, n_q, n_kv, num_pages, page_size, max_pages, n_steps,
      staged_len, pages_per_split, n_splits, scale};
  if (dtype == port::DTYPE_BF16 && head_dim == 128)
    return launch_pool<__nv_bfloat16, 128>(pool, a, st);
  if (dtype == port::DTYPE_BF16 && head_dim == 64)
    return launch_pool<__nv_bfloat16, 64>(pool, a, st);
  if (dtype == port::DTYPE_F32 && head_dim == 128) return launch_pool<float, 128>(pool, a, st);
  if (dtype == port::DTYPE_F32 && head_dim == 64) return launch_pool<float, 64>(pool, a, st);
  return (int)cudaErrorInvalidValue;
}
