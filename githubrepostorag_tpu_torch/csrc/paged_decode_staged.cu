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
// Here one block of 8 warps handles one (row, kv head): it loads 32 keys of
// K and V per step through the block table (16-byte loads) into shared
// memory, warp g scores query g of the group against the 32 keys (one key
// per lane) and owns that query's online-softmax state and its slice of the
// output, so no cross-warp reduction is needed.  Groups up to 8 fit (7 for
// Qwen2-7B; the eighth warp idles).  After the pool prefix the same loop
// reads the staged tail.  The pool element type is a template parameter
// apart from the q / staged type: int8 pages are dequantized with their page
// scale as they load into the f32 tile (pallas_paged.py:204-223 dequantizes
// the page before its dots too).  The grid is only (n_kv, B): 32 blocks at batch 8
// on 132 SMs, too few to fill the card's memory pipes; splitting the page
// walk across blocks (flash-decoding) is later work.

#include "common.cuh"

namespace {

using port::NEG_INF;
using port::PoolRow;
using port::Vec;
using port::from_float;

constexpr int KT = 32;        // keys per tile, one per lane
constexpr int GMAX = 8;       // largest GQA group, one warp per query
constexpr int THREADS = 32 * GMAX;

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
  using PoolR = PoolRow<P, HD>;
  using StagedR = PoolRow<T, HD>;
  constexpr int VN = Vec<T>::N;
  constexpr int VPR = HD / VN;
  constexpr int DC = HD / 32;  // head dims per lane in P.V
  __shared__ float Qs[GMAX][HD];
  __shared__ float Ks[KT][HD + 1];
  __shared__ float Vs[KT][HD];
  __shared__ float Ps[GMAX][KT];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int group = n_q / n_kv;

  for (int i = tid; i < GMAX * VPR; i += THREADS) {
    const int g = i / VPR, c = (i % VPR) * VN;
    float vals[VN];
    if (g < group) {
      Vec<T>::load(q + ((size_t)b * n_q + kvh * group + g) * HD + c, vals);
    } else {
#pragma unroll
      for (int j = 0; j < VN; ++j) vals[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VN; ++j) Qs[g][c + j] = vals[j];
  }

  const int pool_len = pool_lens[b];
  const int n_keys = pool_len + staged_len;
  const size_t layer_head = (size_t)layer * n_kv + kvh;
  const size_t head_off = layer_head * num_pages * page_size * PoolR::STORED;
  const P* kbase = k_pages + head_off;
  const P* vbase = v_pages + head_off;
  const float* ks = QUANT ? k_scales + layer_head * num_pages : nullptr;
  const float* vs = QUANT ? v_scales + layer_head * num_pages : nullptr;
  const size_t staged_off = ((size_t)b * n_kv + kvh) * n_steps * HD;
  const T* skbase = staged_k + staged_off;
  const T* svbase = staged_v + staged_off;
  const int* bt = block_tables + (size_t)b * max_pages;

  float m = NEG_INF, l = 0.f, acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) acc[c] = 0.f;

  for (int k0 = 0; k0 < n_keys; k0 += KT) {
    __syncthreads();  // Q stored / previous tile fully consumed
    // one 16-byte chunk of a staged row per iteration; a pool row has as
    // many chunks (full precision) or fewer (int8)
    for (int i = tid; i < KT * StagedR::CHUNKS; i += THREADS) {
      const int kk = i / StagedR::CHUNKS, ch = i % StagedR::CHUNKS;
      const int pos = k0 + kk;
      if (pos < pool_len) {
        if (ch < PoolR::CHUNKS) {
          const int page = bt[min(pos / page_size, max_pages - 1)];
          const size_t off = ((size_t)page * page_size + pos % page_size) * PoolR::STORED;
          PoolR::load(kbase + off, ch, Ks[kk], QUANT ? ks[page] : 1.f);
          PoolR::load(vbase + off, ch, Vs[kk], QUANT ? vs[page] : 1.f);
        }
      } else if (pos < n_keys) {
        const size_t off = (size_t)(pos - pool_len) * HD;
        StagedR::load(skbase + off, ch, Ks[kk], 1.f);
        StagedR::load(svbase + off, ch, Vs[kk], 1.f);
      } else {
        StagedR::zero(ch, Ks[kk]);
        StagedR::zero(ch, Vs[kk]);
      }
    }
    __syncthreads();

    float s = 0.f;
#pragma unroll 16
    for (int d = 0; d < HD; ++d) s = fmaf(Qs[warp][d], Ks[lane][d], s);
    s = (k0 + lane < n_keys) ? s * scale : NEG_INF;

    const float mn = fmaxf(m, port::warp_max(s, 32));
    const float alpha = expf(m - mn);
    const float p = expf(s - mn);
    l = l * alpha + port::warp_sum(p, 32);
    m = mn;
    Ps[warp][lane] = p;
    __syncwarp();
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[c] *= alpha;
#pragma unroll 4
    for (int kk = 0; kk < KT; ++kk) {
      const float pk = Ps[warp][kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[c] = fmaf(pk, Vs[kk][lane + 32 * c], acc[c]);
    }
  }

  if (warp < group) {
    const float inv = l > 0.f ? 1.f / l : 0.f;  // no valid KV -> 0
    T* dst = out + ((size_t)b * n_q + kvh * group + warp) * HD;
#pragma unroll
    for (int c = 0; c < DC; ++c) dst[lane + 32 * c] = from_float<T>(acc[c] * inv);
  }
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
