// Prefill-window paged attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// githubrepostorag_tpu/ops/fused_decode.py::fused_window_attention
// (_fused_window_kernel, pallas_call at fused_decode.py:232), full-precision
// pools.  Each row b scores an S-token query window based at cached_lens[b]
// against the pages its block table lists, with online softmax, causal mask
// kv_pos <= cached + t and validity kv_pos < cached + new.  Masked scores are
// -1e30; a row with no valid KV writes 0; scores and accumulators are f32.
//
// What bounds it on this card: at prefill widths (S = 512, GQA group 7) the
// work is ~4 * hd FLOPs per (query, key) pair against 2 * hd * 2 bytes of K/V
// per key shared by the 7 * S queries of a kv head, so it sits far above the
// H100's ~295 FLOP/byte ridge: operations bound it.  This first version runs
// the products on the CUDA cores in f32 (no tensor cores), so it is bound by
// shared-memory operand traffic of the f32 FMA loops, well below the card's
// bf16 tensor-core peak.  wgmma / TMA pipelining is later work.
//
// Design: the TPU kernel kept a [group, S, hd] f32 accumulator in VMEM per
// (row, kv head); at S = 512, group 7 that is 1.8 MB, eight times a block's
// shared memory.  Here the (window position, group member) pairs of one kv
// head form one flat row index r = t * group + g (any group size, 7
// included), tiled 64 rows to a block.  Grid = (row tiles, kv heads, batch
// rows).  A block walks its keys 32 at a time through the block table up to
// min(total, cached + last t of the tile + 1) -- the causal bound of its
// rows -- with Q, one K tile, one V tile and the probabilities in shared
// memory and (m, l, acc) in registers.  Rows with total == 0 (bucket
// padding) run no tile and write zeros.

#include "common.cuh"

namespace {

using port::NEG_INF;
using port::Vec;

constexpr int ROWS = 64;      // flat query rows per block
constexpr int KT = 32;        // keys per tile
constexpr int THREADS = 256;  // 16 (tx) x 16 (ty)

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (ROWS * (HD + 1) + KT * (HD + 1) + KT * HD + ROWS * (KT + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) fused_window_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, T* __restrict__ out,
    const int* __restrict__ block_tables, const int* __restrict__ cached_lens,
    const int* __restrict__ new_lens, int S, int n_q, int n_kv, int num_pages,
    int page_size, int max_pages, float scale) {
  constexpr int VN = Vec<T>::N;
  constexpr int VPR = HD / VN;    // vectors per head row
  constexpr int DC = HD / 16;     // head dims per thread in P.V
  extern __shared__ float smem[];
  float* Qs = smem;                     // [ROWS][HD + 1]
  float* Ks = Qs + ROWS * (HD + 1);     // [KT][HD + 1]
  float* Vs = Ks + KT * (HD + 1);       // [KT][HD]
  float* Ps = Vs + KT * HD;             // [ROWS][KT + 1]

  const int group = n_q / n_kv;
  const int rows_total = group * S;
  const int r0 = blockIdx.x * ROWS;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const int cached = cached_lens[b];
  const int total = cached + new_lens[b];
  const int t_last = min(S - 1, (min(r0 + ROWS, rows_total) - 1) / group);
  const int kv_end = min(total, cached + t_last + 1);

  for (int i = tid; i < ROWS * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * VN;
    const int rr = r0 + r;
    float vals[VN];
    if (rr < rows_total) {
      const int t = rr / group, g = rr % group;
      Vec<T>::load(q + (((size_t)b * S + t) * n_q + kvh * group + g) * HD + c, vals);
    } else {
#pragma unroll
      for (int j = 0; j < VN; ++j) vals[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VN; ++j) Qs[r * (HD + 1) + c + j] = vals[j];
  }

  float m[4], l[4], acc[4][DC];
  int q_pos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
    const int rr = r0 + ty + 16 * i;
    q_pos[i] = cached + (rr < rows_total ? rr / group : 0);
  }

  const size_t head_off = (size_t)kvh * num_pages * page_size * HD;
  const T* kbase = k_pages + head_off;
  const T* vbase = v_pages + head_off;
  const int* bt = block_tables + (size_t)b * max_pages;

  for (int k0 = 0; k0 < kv_end; k0 += KT) {
    __syncthreads();  // Q stored / previous tile fully consumed
    for (int i = tid; i < KT * VPR; i += THREADS) {
      const int kk = i / VPR, c = (i % VPR) * VN;
      const int pos = k0 + kk;
      float kv[VN], vv[VN];
      if (pos < kv_end) {
        const int page = bt[min(pos / page_size, max_pages - 1)];
        const size_t off = ((size_t)page * page_size + pos % page_size) * HD + c;
        Vec<T>::load(kbase + off, kv);
        Vec<T>::load(vbase + off, vv);
      } else {
#pragma unroll
        for (int j = 0; j < VN; ++j) kv[j] = vv[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VN; ++j) {
        Ks[kk * (HD + 1) + c + j] = kv[j];
        Vs[kk * HD + c + j] = vv[j];
      }
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 16
    for (int d = 0; d < HD; ++d) {
      const float k0d = Ks[tx * (HD + 1) + d];
      const float k1d = Ks[(tx + 16) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qd = Qs[(ty + 16 * i) * (HD + 1) + d];
        s[i][0] = fmaf(qd, k0d, s[i][0]);
        s[i][1] = fmaf(qd, k1d, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mc = NEG_INF;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int pos = k0 + tx + 16 * j;
        const bool ok = pos < kv_end && pos <= q_pos[i];
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mc = fmaxf(mc, s[i][j]);
      }
      mc = port::warp_max(mc, 16);  // the 16 tx lanes sharing row ty + 16i
      const float mn = fmaxf(m[i], mc);
      const float alpha = expf(m[i] - mn);
      const float p0 = expf(s[i][0] - mn);
      const float p1 = expf(s[i][1] - mn);
      l[i] = l[i] * alpha + port::warp_sum(p0 + p1, 16);
      m[i] = mn;
      Ps[(ty + 16 * i) * (KT + 1) + tx] = p0;
      Ps[(ty + 16 * i) * (KT + 1) + tx + 16] = p1;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < KT; ++kk) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[kk * HD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * (KT + 1) + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = r0 + ty + 16 * i;
    if (rr >= rows_total) continue;
    const int t = rr / group, g = rr % group;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;  // no valid KV -> 0
    T* dst = out + (((size_t)b * S + t) * n_q + kvh * group + g) * HD;
#pragma unroll
    for (int c = 0; c < DC; ++c) dst[tx + 16 * c] = from_float<T>(acc[i][c] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages, void* out,
                   const int* block_tables, const int* cached_lens, const int* new_lens,
                   int B, int S, int n_q, int n_kv, int num_pages, int page_size,
                   int max_pages, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(fused_window_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int rows_total = (n_q / n_kv) * S;
  dim3 grid((rows_total + ROWS - 1) / ROWS, n_kv, B);
  fused_window_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<T*>(out), block_tables,
      cached_lens, new_lens, S, n_q, n_kv, num_pages, page_size, max_pages, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_window_attention_launch(
    const void* q, const void* k_pages, const void* v_pages, void* out,
    const int* block_tables, const int* cached_lens, const int* new_lens, int B,
    int S, int n_q, int n_kv, int num_pages, int page_size, int head_dim,
    int max_pages, int dtype, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0) return 0;
#define PORT_LAUNCH(T, HD)                                                        \
  return (int)launch<T, HD>(q, k_pages, v_pages, out, block_tables, cached_lens, \
                            new_lens, B, S, n_q, n_kv, num_pages, page_size,     \
                            max_pages, scale, st)
  if (dtype == port::DTYPE_BF16 && head_dim == 128) PORT_LAUNCH(__nv_bfloat16, 128);
  if (dtype == port::DTYPE_BF16 && head_dim == 64) PORT_LAUNCH(__nv_bfloat16, 64);
  if (dtype == port::DTYPE_F32 && head_dim == 128) PORT_LAUNCH(float, 128);
  if (dtype == port::DTYPE_F32 && head_dim == 64) PORT_LAUNCH(float, 64);
#undef PORT_LAUNCH
  return (int)cudaErrorInvalidValue;
}
