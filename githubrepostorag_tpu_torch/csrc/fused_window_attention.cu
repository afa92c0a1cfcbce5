// Prefill-window paged attention for Hopper (sm_90a): kernel A.
//
// Replaces the Pallas TPU kernel
// githubrepostorag_tpu/ops/fused_decode.py::fused_window_attention
// (_fused_window_kernel, pallas_call at fused_decode.py:232), with its three
// pool branches: full precision, int8 codes and int4 nibble planes, the
// quantized ones with one f32 scale per (kv head, page).  Each row b scores
// an S-token query window based at cached_lens[b] against the pages its
// block table lists, with online softmax, causal mask kv_pos <= cached + t
// and validity kv_pos < cached + new.  Masked scores are -1e30; a row with
// no valid KV writes 0; scores and accumulators are f32.
//
// What bounds it on this card: at prefill widths (S = 512, GQA group 7) the
// work is ~4 * hd FLOPs per (query, key) pair against 2 * hd * 2 bytes of K/V
// per key (1 byte per element for int8 pools, half a byte for int4) shared
// by the 7 * S queries of a kv head, so it sits far above the H100's ~295
// FLOP/byte ridge: operations bound it.
//
// Design: the TPU kernel kept a [group, S, hd] f32 accumulator in VMEM per
// (row, kv head); at S = 512, group 7 that is 1.8 MB, eight times a block's
// shared memory.  Here the flat (window position, group member) rows of one
// kv head are tiled over the grid (row tiles, kv heads, batch rows), and the
// route is chosen by q's dtype:
//   - bf16 queries (the engine's path): prefill_attention.cuh's tensor-core
//     body, 128 rows a block, K/V through a TMA ring, both products on
//     wgmma, quantized pages widened to bf16 in shared memory, longest
//     causal walks first;
//   - f32 queries (the checking path, held to 1e-5): window_attention.cuh's
//     CUDA-core body, 64 rows a block, pool elements widened to f32 as they
//     load.
// A shape either route refuses returns an error before any launch; nothing
// falls back to the other route.  Rows with total == 0 (bucket padding) run
// no tile and write zeros.

#include "prefill_attention.cuh"
#include "window_attention.cuh"

namespace {

using namespace port;

struct WindowTokens {  // window position t of batch row b is token b * S + t
  int base;
  __device__ int operator()(int t) const { return base + t; }
};

template <typename T, typename P, int HD, bool QUANT>
__global__ void __launch_bounds__(WIN_THREADS) fused_window_kernel(
    const T* __restrict__ q, const P* __restrict__ k_pages,
    const P* __restrict__ v_pages, T* __restrict__ out,
    const int* __restrict__ block_tables, const int* __restrict__ cached_lens,
    const int* __restrict__ new_lens, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, int S, int n_q, int n_kv, int num_pages,
    int page_size, int max_pages, float scale) {
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = n_q / n_kv;
  const int cached = cached_lens[b];
  const size_t head_off = (size_t)kvh * num_pages * page_size * PoolRow<P, HD>::STORED;
  const size_t scale_off = (size_t)kvh * num_pages;
  window_block<T, P, HD, QUANT>(
      q, k_pages + head_off, v_pages + head_off, out, block_tables + (size_t)b * max_pages,
      QUANT ? k_scales + scale_off : nullptr, QUANT ? v_scales + scale_off : nullptr,
      WindowTokens{b * S}, group * S, blockIdx.x * WIN_ROWS, kvh, group, n_q, cached,
      cached + new_lens[b], page_size, max_pages, scale);
}

template <typename T, typename P, int HD, bool QUANT>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages, void* out,
                   const int* block_tables, const int* cached_lens, const int* new_lens,
                   const float* k_scales, const float* v_scales, int B, int S, int n_q,
                   int n_kv, int num_pages, int page_size, int max_pages, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = window_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(fused_window_kernel<T, P, HD, QUANT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int rows_total = (n_q / n_kv) * S;
  dim3 grid((rows_total + WIN_ROWS - 1) / WIN_ROWS, n_kv, B);
  fused_window_kernel<T, P, HD, QUANT><<<grid, WIN_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k_pages),
      static_cast<const P*>(v_pages), static_cast<T*>(out), block_tables, cached_lens,
      new_lens, k_scales, v_scales, S, n_q, n_kv, num_pages, page_size, max_pages, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
int launch_pool(int pool, const void* q, const void* k_pages, const void* v_pages, void* out,
                const int* block_tables, const int* cached_lens, const int* new_lens,
                const float* k_scales, const float* v_scales, int B, int S, int n_q,
                int n_kv, int num_pages, int page_size, int max_pages, float scale,
                cudaStream_t st) {
#define PORT_LAUNCH(P, QUANT)                                                          \
  return (int)launch<T, P, HD, QUANT>(q, k_pages, v_pages, out, block_tables,          \
                                      cached_lens, new_lens, k_scales, v_scales, B, S, \
                                      n_q, n_kv, num_pages, page_size, max_pages,      \
                                      scale, st)
  if (pool == POOL_FP) PORT_LAUNCH(T, false);
  if (pool == POOL_INT8) PORT_LAUNCH(int8_t, true);
  if (pool == POOL_INT4) PORT_LAUNCH(uint8_t, true);
#undef PORT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int fused_window_attention_launch(
    const void* q, const void* k_pages, const void* v_pages, void* out,
    const int* block_tables, const int* cached_lens, const int* new_lens,
    const float* k_scales, const float* v_scales, int B, int S, int n_q, int n_kv,
    int num_pages, int page_size, int head_dim, int max_pages, int dtype, int pool,
    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0) return 0;
  if (dtype == DTYPE_BF16) {
    const prefill::Launch a{q, k_pages, v_pages, out, block_tables, cached_lens, new_lens,
                            nullptr, k_scales, v_scales, B, S, n_q, n_kv, num_pages,
                            page_size, max_pages, scale};
#define PORT_LAUNCH(P, HD) return prefill::launch<P, HD, false>(a, st)
    if (head_dim == 128 && pool == POOL_FP) PORT_LAUNCH(__nv_bfloat16, 128);
    if (head_dim == 128 && pool == POOL_INT8) PORT_LAUNCH(int8_t, 128);
    if (head_dim == 128 && pool == POOL_INT4) PORT_LAUNCH(uint8_t, 128);
    if (head_dim == 64 && pool == POOL_FP) PORT_LAUNCH(__nv_bfloat16, 64);
    if (head_dim == 64 && pool == POOL_INT8) PORT_LAUNCH(int8_t, 64);
    if (head_dim == 64 && pool == POOL_INT4) PORT_LAUNCH(uint8_t, 64);
#undef PORT_LAUNCH
    return (int)cudaErrorInvalidValue;
  }
#define PORT_LAUNCH(HD)                                                                \
  return launch_pool<float, HD>(pool, q, k_pages, v_pages, out, block_tables, cached_lens, \
                                new_lens, k_scales, v_scales, B, S, n_q, n_kv, num_pages,  \
                                page_size, max_pages, scale, st)
  if (dtype == DTYPE_F32 && head_dim == 128) PORT_LAUNCH(128);
  if (dtype == DTYPE_F32 && head_dim == 64) PORT_LAUNCH(64);
#undef PORT_LAUNCH
  return (int)cudaErrorInvalidValue;
}
