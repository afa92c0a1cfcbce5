// Decode-burst paged attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// githubrepostorag_tpu/ops/pallas_paged.py::paged_attention_decode_staged
// (_decode_staged_kernel, pallas_call at pallas_paged.py:395), with its two
// pool branches: full-precision and int8 rank-5 pools, the int8 ones with one
// f32 scale per (layer, kv head, page).  One decode query per row b attends,
// with online softmax, to
// the frozen pool prefix (pool_lens[b] tokens through its block table) and
// then to the burst's staged K/V tail (entries < staged_len).  The pools are
// the whole [L, n_kv, P, ps, hd] tensors plus a layer index: no per-layer
// slice is copied.  Masked scores are -1e30; a row with no valid KV writes 0;
// scores and accumulators are f32.  The staged tail is in the activation
// dtype whatever the pools hold.
//
// What bounds it on this card: each key is read once (2 * hd * 2 bytes of K
// and V in bf16, half that in int8) and used by the group's 7 queries, ~2-4
// FLOPs per byte, far below the H100's ~295 FLOP/byte ridge: device-memory
// bytes bound it.
//
// Design: the TPU grid (B, max_pages + 1) walked pages in order on one core.
// Here one block of 8 warps handles one (row, kv head), with the block body
// kernel F shares (decode_attention.cuh): 32 keys of K and V a step through
// the block table into shared memory, warp g owning query g of the group and
// its online-softmax state.  After the pool prefix the same loop reads the
// staged tail.  The pool element type is a template parameter apart from the
// q / staged type: int8 pages are dequantized with their page scale as they
// load into the f32 tile (pallas_paged.py:204-223 dequantizes the page before
// its dots too).  The grid is only (n_kv, B): 32 blocks at batch 8 on 132
// SMs, too few to fill the card's memory pipes; splitting the page walk
// across blocks (flash-decoding) is later work.

#include "decode_attention.cuh"

namespace {

using port::decode::THREADS;
using port::decode::GMAX;

// T: q / staged / out element type; P: pool element type (T or int8_t)
template <typename T, typename P, int HD, bool QUANT>
__global__ void __launch_bounds__(THREADS) decode_staged_kernel(
    const T* __restrict__ q, const P* __restrict__ k_pages,
    const P* __restrict__ v_pages, const T* __restrict__ staged_k,
    const T* __restrict__ staged_v, T* __restrict__ out,
    const int* __restrict__ block_tables, const int* __restrict__ pool_lens,
    const float* __restrict__ k_scales, const float* __restrict__ v_scales,
    int n_q, int n_kv, int num_pages, int page_size, int max_pages, int n_steps,
    int staged_len, int layer, float scale) {
  const int b = blockIdx.y;
  port::decode::decode_block<T, P, HD, QUANT, true>(
      q, k_pages, v_pages, staged_k, staged_v, out, block_tables + (size_t)b * max_pages,
      pool_lens[b], k_scales, v_scales, b, blockIdx.x, n_q, n_kv, num_pages, page_size,
      max_pages, n_steps, staged_len, layer, scale);
}

template <typename T, typename P, int HD, bool QUANT>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* staged_k, const void* staged_v, void* out,
                   const int* block_tables, const int* pool_lens, const float* k_scales,
                   const float* v_scales, int B, int n_q, int n_kv, int num_pages,
                   int page_size, int max_pages, int n_steps, int staged_len, int layer,
                   float scale, cudaStream_t stream) {
  dim3 grid(n_kv, B);
  decode_staged_kernel<T, P, HD, QUANT><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k_pages),
      static_cast<const P*>(v_pages), static_cast<const T*>(staged_k),
      static_cast<const T*>(staged_v), static_cast<T*>(out), block_tables,
      pool_lens, k_scales, v_scales, n_q, n_kv, num_pages, page_size, max_pages,
      n_steps, staged_len, layer, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
int launch_pool(int pool, const void* q, const void* k_pages, const void* v_pages,
                const void* staged_k, const void* staged_v, void* out,
                const int* block_tables, const int* pool_lens, const float* k_scales,
                const float* v_scales, int B, int n_q, int n_kv, int num_pages,
                int page_size, int max_pages, int n_steps, int staged_len, int layer,
                float scale, cudaStream_t st) {
#define PORT_LAUNCH(P, QUANT)                                                          \
  return (int)launch<T, P, HD, QUANT>(q, k_pages, v_pages, staged_k, staged_v, out,    \
                                      block_tables, pool_lens, k_scales, v_scales, B,  \
                                      n_q, n_kv, num_pages, page_size, max_pages,      \
                                      n_steps, staged_len, layer, scale, st)
  if (pool == port::POOL_FP) PORT_LAUNCH(T, false);
  if (pool == port::POOL_INT8) PORT_LAUNCH(int8_t, true);
#undef PORT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int paged_decode_staged_launch(
    const void* q, const void* k_pages, const void* v_pages, const void* staged_k,
    const void* staged_v, void* out, const int* block_tables, const int* pool_lens,
    const float* k_scales, const float* v_scales, int B, int n_q, int n_kv,
    int num_pages, int page_size, int head_dim, int max_pages, int n_steps,
    int staged_len, int layer, int dtype, int pool, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (n_q / n_kv > GMAX) return (int)cudaErrorInvalidValue;
#define PORT_LAUNCH(T, HD)                                                            \
  return launch_pool<T, HD>(pool, q, k_pages, v_pages, staged_k, staged_v, out,       \
                            block_tables, pool_lens, k_scales, v_scales, B, n_q, n_kv, \
                            num_pages, page_size, max_pages, n_steps, staged_len,      \
                            layer, scale, st)
  if (dtype == port::DTYPE_BF16 && head_dim == 128) PORT_LAUNCH(__nv_bfloat16, 128);
  if (dtype == port::DTYPE_BF16 && head_dim == 64) PORT_LAUNCH(__nv_bfloat16, 64);
  if (dtype == port::DTYPE_F32 && head_dim == 128) PORT_LAUNCH(float, 128);
  if (dtype == port::DTYPE_F32 && head_dim == 64) PORT_LAUNCH(float, 64);
#undef PORT_LAUNCH
  return (int)cudaErrorInvalidValue;
}
