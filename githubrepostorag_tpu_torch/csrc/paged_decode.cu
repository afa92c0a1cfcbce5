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
// Here the page axis is split across blocks (flash-decoding) and the last
// block of each (row, kv head) to finish merges the partials: the split-K
// kernel B runs (decode_attention.cuh) with no staged tail and the row's
// length cached + new, over a rank-4 pool.  The TPU index map sent table entries past the
// row's pages to page 0 and skipped their compute (pallas_paged.py:127-131);
// here only pages below the row's length read the table, so such entries
// (the engine pads tables with values that are not pages) are never
// dereferenced.

#include "decode_attention.cuh"

// q [B, n_q, hd], pools [n_kv, P, ps, hd] in q's dtype (bf16 or f32), out
// like q; workspace (the splits' partials), counters ([B, n_kv] int32, 0
// between launches) and (pages_per_split, n_splits) from the wrapper and its
// plan (ops/paged_decode._plan_decode).
extern "C" int paged_decode_launch(
    const void* q, const void* k_pages, const void* v_pages, void* out,
    const int* block_tables, const int* cached_lens, const int* new_lens, void* workspace,
    void* counters, int B, int n_q, int n_kv, int num_pages, int page_size, int head_dim,
    int max_pages, int dtype, int pages_per_split, int n_splits, float scale, void* stream) {
  using port::decode::launch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const port::decode::Launch a{q, k_pages, v_pages, nullptr, nullptr, out, block_tables,
                               cached_lens, new_lens, nullptr, nullptr,
                               static_cast<float*>(workspace), static_cast<int*>(counters), B,
                               n_q, n_kv, num_pages, page_size, max_pages, 0, 0,
                               pages_per_split, n_splits, scale};
  if (dtype == port::DTYPE_BF16 && head_dim == 128)
    return launch<__nv_bfloat16, __nv_bfloat16, 128, false, false>(a, st);
  if (dtype == port::DTYPE_BF16 && head_dim == 64)
    return launch<__nv_bfloat16, __nv_bfloat16, 64, false, false>(a, st);
  if (dtype == port::DTYPE_F32 && head_dim == 128)
    return launch<float, float, 128, false, false>(a, st);
  if (dtype == port::DTYPE_F32 && head_dim == 64)
    return launch<float, float, 64, false, false>(a, st);
  return (int)cudaErrorInvalidValue;
}
