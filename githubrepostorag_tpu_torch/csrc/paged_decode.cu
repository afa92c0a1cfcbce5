// Single-token paged attention decode for Hopper (sm_90a): kernel F.
//
// Replaces the Pallas TPU kernel
// githubrepostorag_tpu/ops/pallas_paged.py::paged_attention_decode
// (_decode_kernel, pallas_call at pallas_paged.py:150), full-precision pools
// only (the TPU kernel has no scales).  One query per row b attends, with
// online softmax, to the row's first cached_lens[b] + new_lens[b] keys of
// one layer's [n_kv, P, ps, hd] pool through its block table.  Scores are
// q.k / sqrt(hd) in f32, masked to -1e30 past the row's length; the output
// is acc / l in q's dtype, and a row with no key writes 0.
//
// What bounds it on this card: each live key's K and V are read once
// (2 * hd * 2 bytes in bf16) and used by the group's 7 queries, ~2 FLOPs per
// byte, far below the H100's ~295 FLOP/byte ridge: device-memory bytes bound
// it.
//
// Design: the TPU grid (B, n_kv, max_pages) walked one page of one kv head a
// step, carrying (m, l, acc) in VMEM scratch across the sequential page axis.
// Here that walk is a loop inside one block per (kv head, row), the block
// body kernel B runs (decode_attention.cuh) with no staged tail, a rank-4
// pool (layer 0) and the row's length cached + new: 32 keys of K and V a
// step through the block table into shared memory, warp g owning query g of
// the group.  The TPU index map sent table entries past the row's pages to
// page 0 and skipped their compute (pallas_paged.py:127-131); here only
// positions below the row's length read the table, so such entries (the
// engine pads tables with values that are not pages) are never dereferenced.
// As in B, the grid (n_kv, B) is small at low batch; split-K over pages and
// tensor cores are later work.

#include "decode_attention.cuh"

namespace {

using port::decode::THREADS;
using port::decode::GMAX;

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    T* __restrict__ out, const int* __restrict__ block_tables,
    const int* __restrict__ cached_lens, const int* __restrict__ new_lens, int n_q,
    int n_kv, int num_pages, int page_size, int max_pages, float scale) {
  const int b = blockIdx.y;
  port::decode::decode_block<T, T, HD, false, false>(
      q, k_pages, v_pages, nullptr, nullptr, out, block_tables + (size_t)b * max_pages,
      cached_lens[b] + new_lens[b], nullptr, nullptr, b, blockIdx.x, n_q, n_kv, num_pages,
      page_size, max_pages, 0, 0, 0, scale);
}

template <typename T, int HD>
int launch(const void* q, const void* k_pages, const void* v_pages, void* out,
           const int* block_tables, const int* cached_lens, const int* new_lens, int B,
           int n_q, int n_kv, int num_pages, int page_size, int max_pages, float scale,
           cudaStream_t stream) {
  dim3 grid(n_kv, B);
  paged_decode_kernel<T, HD><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<T*>(out), block_tables, cached_lens,
      new_lens, n_q, n_kv, num_pages, page_size, max_pages, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_decode_launch(
    const void* q, const void* k_pages, const void* v_pages, void* out,
    const int* block_tables, const int* cached_lens, const int* new_lens, int B, int n_q,
    int n_kv, int num_pages, int page_size, int head_dim, int max_pages, int dtype,
    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (n_q / n_kv > GMAX) return (int)cudaErrorInvalidValue;
#define PORT_LAUNCH(T, HD)                                                             \
  return launch<T, HD>(q, k_pages, v_pages, out, block_tables, cached_lens, new_lens, B, \
                       n_q, n_kv, num_pages, page_size, max_pages, scale, st)
  if (dtype == port::DTYPE_BF16 && head_dim == 128) PORT_LAUNCH(__nv_bfloat16, 128);
  if (dtype == port::DTYPE_BF16 && head_dim == 64) PORT_LAUNCH(__nv_bfloat16, 64);
  if (dtype == port::DTYPE_F32 && head_dim == 128) PORT_LAUNCH(float, 128);
  if (dtype == port::DTYPE_F32 && head_dim == 64) PORT_LAUNCH(float, 64);
#undef PORT_LAUNCH
  return (int)cudaErrorInvalidValue;
}
