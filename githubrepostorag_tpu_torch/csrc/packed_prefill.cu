// Token-budget packed prefill attention for Hopper (sm_90a): kernel C.
//
// Replaces the Pallas TPU kernel
// githubrepostorag_tpu/ops/packed_prefill.py::packed_prefill_attention_seg
// (_packed_prefill_kernel, pallas_call at packed_prefill.py:198),
// full-precision pools.  A packed prefill wave holds every prefilling
// row's next chunk back to back in one [T] token buffer; segment r's
// new_lens[r] tokens sit at positions cached_lens[r] + i, i < new_lens[r],
// and attend causally over the pages of block_tables[r] up to their own
// position.  Masked scores are -1e30; scores and accumulators are f32.
//
// What bounds it on this card: the same work as kernel A per real token --
// ~4 * hd FLOPs per (query, key) pair over 2 * hd * 2 bytes of K/V per key
// shared by a segment's 7 * new queries -- so operations bound it.
//
// Design: the TPU kernel needs rectangular BlockSpec tiles, so its wrapper
// scatters the packed queries into a segment-major [R * tq] view, runs the
// kernel there, and gathers the outputs back: two passes over
// [R * tq, n_q, hd] per layer, with every segment's padding computed.  Here
// the kernel reads the packed q [T, n_q, hd] and writes the packed out
// [T, n_q, hd] directly.  The segment-major view exists only as an int32
// index row_of[r * tq + i] = packed token of segment r's i-th new token (the
// inverse of _segment_scatter_indices), which the wrapper builds with one
// scatter of T integers on the device.  Grid (row tiles, kv heads,
// segments); a tile past group * new_lens[r] exits at once, so a segment
// costs its real tokens only.  The block bodies are kernel A's, chosen by
// q's dtype the same way: bf16 queries take prefill_attention.cuh's
// tensor-core body, f32 queries window_attention.cuh's CUDA-core body.
// Padding tokens are never written: the wrapper hands the kernel a zeroed
// output.

#include "prefill_attention.cuh"
#include "window_attention.cuh"

namespace {

using namespace port;

struct SegmentTokens {  // segment position i is packed token row_of[i]
  const int* row_of;
  __device__ int operator()(int i) const { return row_of[i]; }
};

template <typename T, int HD>
__global__ void __launch_bounds__(WIN_THREADS) packed_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, T* __restrict__ out,
    const int* __restrict__ block_tables, const int* __restrict__ cached_lens,
    const int* __restrict__ new_lens, const int* __restrict__ row_of, int tq, int n_q,
    int n_kv, int num_pages, int page_size, int max_pages, float scale) {
  const int kvh = blockIdx.y;
  const int r = blockIdx.z;
  const int group = n_q / n_kv;
  const int rows_total = group * new_lens[r];
  const int r0 = blockIdx.x * WIN_ROWS;
  if (r0 >= rows_total) return;  // past the segment's real tokens
  const int cached = cached_lens[r];
  const size_t head_off = (size_t)kvh * num_pages * page_size * HD;
  window_block<T, T, HD, false>(
      q, k_pages + head_off, v_pages + head_off, out, block_tables + (size_t)r * max_pages,
      nullptr, nullptr, SegmentTokens{row_of + (size_t)r * tq}, rows_total, r0, kvh,
      group, n_q, cached, cached + new_lens[r], page_size, max_pages, scale);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages, void* out,
                   const int* block_tables, const int* cached_lens, const int* new_lens,
                   const int* row_of, int R, int tq, int n_q, int n_kv, int num_pages,
                   int page_size, int max_pages, float scale, cudaStream_t stream) {
  constexpr size_t smem = window_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(packed_prefill_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int rows_max = (n_q / n_kv) * tq;
  dim3 grid((rows_max + WIN_ROWS - 1) / WIN_ROWS, n_kv, R);
  packed_prefill_kernel<T, HD><<<grid, WIN_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<T*>(out), block_tables, cached_lens,
      new_lens, row_of, tq, n_q, n_kv, num_pages, page_size, max_pages, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int packed_prefill_launch(
    const void* q, const void* k_pages, const void* v_pages, void* out,
    const int* block_tables, const int* cached_lens, const int* new_lens,
    const int* row_of, int R, int tq, int n_q, int n_kv, int num_pages, int page_size,
    int head_dim, int max_pages, int dtype, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R == 0 || tq == 0) return 0;
  if (dtype == DTYPE_BF16) {
    const prefill::Launch a{q, k_pages, v_pages, out, block_tables, cached_lens, new_lens,
                            row_of, nullptr, nullptr, R, tq, n_q, n_kv, num_pages,
                            page_size, max_pages, scale};
    if (head_dim == 128) return prefill::launch<__nv_bfloat16, 128, true>(a, st);
    if (head_dim == 64) return prefill::launch<__nv_bfloat16, 64, true>(a, st);
    return (int)cudaErrorInvalidValue;
  }
#define PORT_LAUNCH(HD)                                                             \
  return (int)launch<float, HD>(q, k_pages, v_pages, out, block_tables, cached_lens, \
                                new_lens, row_of, R, tq, n_q, n_kv, num_pages, page_size, \
                                max_pages, scale, st)
  if (dtype == DTYPE_F32 && head_dim == 128) PORT_LAUNCH(128);
  if (dtype == DTYPE_F32 && head_dim == 64) PORT_LAUNCH(64);
#undef PORT_LAUNCH
  return (int)cudaErrorInvalidValue;
}
