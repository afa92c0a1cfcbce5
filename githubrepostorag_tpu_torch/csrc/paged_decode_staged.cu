// Decode-burst paged attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// githubrepostorag_tpu/ops/pallas_paged.py::paged_attention_decode_staged
// (_decode_staged_kernel, pallas_call at pallas_paged.py:395), full-precision
// rank-5 pools.  One decode query per row b attends, with online softmax, to
// the frozen pool prefix (pool_lens[b] tokens through its block table) and
// then to the burst's staged K/V tail (entries < staged_len).  The pools are
// the whole [L, n_kv, P, ps, hd] tensors plus a layer index: no per-layer
// slice is copied.  Masked scores are -1e30; a row with no valid KV writes 0;
// scores and accumulators are f32.
//
// What bounds it on this card: each key is read once (2 * hd * 2 bytes of K
// and V in bf16) and used by the group's 7 queries, ~2 FLOPs per byte, far
// below the H100's ~295 FLOP/byte ridge: device-memory bytes bound it.
//
// Design: the TPU grid (B, max_pages + 1) walked pages in order on one core.
// Here one block of 8 warps handles one (row, kv head): it loads 32 keys of
// K and V per step through the block table (16-byte loads) into shared
// memory, warp g scores query g of the group against the 32 keys (one key
// per lane) and owns that query's online-softmax state and its slice of the
// output, so no cross-warp reduction is needed.  Groups up to 8 fit (7 for
// Qwen2-7B; the eighth warp idles).  After the pool prefix the same loop
// reads the staged tail.  The grid is only (n_kv, B): 32 blocks at batch 8
// on 132 SMs, too few to fill the card's memory pipes; splitting the page
// walk across blocks (flash-decoding) is later work.

#include "common.cuh"

namespace {

using port::NEG_INF;
using port::Vec;

constexpr int KT = 32;        // keys per tile, one per lane
constexpr int GMAX = 8;       // largest GQA group, one warp per query
constexpr int THREADS = 32 * GMAX;

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) decode_staged_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const T* __restrict__ staged_k,
    const T* __restrict__ staged_v, T* __restrict__ out,
    const int* __restrict__ block_tables, const int* __restrict__ pool_lens,
    int n_q, int n_kv, int num_pages, int page_size, int max_pages, int n_steps,
    int staged_len, int layer, float scale) {
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
  const size_t head_off =
      (((size_t)layer * n_kv + kvh) * num_pages) * page_size * HD;
  const T* kbase = k_pages + head_off;
  const T* vbase = v_pages + head_off;
  const size_t staged_off = ((size_t)b * n_kv + kvh) * n_steps * HD;
  const T* skbase = staged_k + staged_off;
  const T* svbase = staged_v + staged_off;
  const int* bt = block_tables + (size_t)b * max_pages;

  float m = NEG_INF, l = 0.f, acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) acc[c] = 0.f;

  for (int k0 = 0; k0 < n_keys; k0 += KT) {
    __syncthreads();  // Q stored / previous tile fully consumed
    for (int i = tid; i < KT * VPR; i += THREADS) {
      const int kk = i / VPR, c = (i % VPR) * VN;
      const int pos = k0 + kk;
      float kv[VN], vv[VN];
      if (pos < pool_len) {
        const int page = bt[min(pos / page_size, max_pages - 1)];
        const size_t off = ((size_t)page * page_size + pos % page_size) * HD + c;
        Vec<T>::load(kbase + off, kv);
        Vec<T>::load(vbase + off, vv);
      } else if (pos < n_keys) {
        const size_t off = (size_t)(pos - pool_len) * HD + c;
        Vec<T>::load(skbase + off, kv);
        Vec<T>::load(svbase + off, vv);
      } else {
#pragma unroll
        for (int j = 0; j < VN; ++j) kv[j] = vv[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VN; ++j) {
        Ks[kk][c + j] = kv[j];
        Vs[kk][c + j] = vv[j];
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

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* staged_k, const void* staged_v, void* out,
                   const int* block_tables, const int* pool_lens, int B, int n_q,
                   int n_kv, int num_pages, int page_size, int max_pages,
                   int n_steps, int staged_len, int layer, float scale,
                   cudaStream_t stream) {
  dim3 grid(n_kv, B);
  decode_staged_kernel<T, HD><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const T*>(staged_k),
      static_cast<const T*>(staged_v), static_cast<T*>(out), block_tables,
      pool_lens, n_q, n_kv, num_pages, page_size, max_pages, n_steps,
      staged_len, layer, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int paged_decode_staged_launch(
    const void* q, const void* k_pages, const void* v_pages, const void* staged_k,
    const void* staged_v, void* out, const int* block_tables, const int* pool_lens,
    int B, int n_q, int n_kv, int num_pages, int page_size, int head_dim,
    int max_pages, int n_steps, int staged_len, int layer, int dtype, float scale,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (n_q / n_kv > GMAX) return (int)cudaErrorInvalidValue;
#define PORT_LAUNCH(T, HD)                                                      \
  return (int)launch<T, HD>(q, k_pages, v_pages, staged_k, staged_v, out,       \
                            block_tables, pool_lens, B, n_q, n_kv, num_pages,   \
                            page_size, max_pages, n_steps, staged_len, layer,   \
                            scale, st)
  if (dtype == port::DTYPE_BF16 && head_dim == 128) PORT_LAUNCH(__nv_bfloat16, 128);
  if (dtype == port::DTYPE_BF16 && head_dim == 64) PORT_LAUNCH(__nv_bfloat16, 64);
  if (dtype == port::DTYPE_F32 && head_dim == 128) PORT_LAUNCH(float, 128);
  if (dtype == port::DTYPE_F32 && head_dim == 64) PORT_LAUNCH(float, 64);
#undef PORT_LAUNCH
  return (int)cudaErrorInvalidValue;
}
