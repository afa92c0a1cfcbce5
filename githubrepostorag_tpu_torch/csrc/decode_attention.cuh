// Block body of the decode attention kernels B (paged_decode_staged.cu) and
// F (paged_decode.cu).
//
// One block of 8 warps handles one (kv head, row): it loads 32 keys of K and
// V per step through the row's block table (16-byte loads) into shared
// memory, warp g scores query g of the GQA group against the 32 keys (one
// key per lane) and owns that query's online-softmax state (m, l) and its
// slice of the output, so no cross-warp reduction is needed.  Groups up to
// 8 fit (7 for Qwen2-7B; the eighth warp idles).  Only positions below the
// row's pool length dereference the block table, so table entries past a
// row's pages are never read.  With STAGED the same loop then reads the
// burst's staged K/V tail (kernel B); without it the keys are the pool's
// alone (kernel F).  Masked scores are -1e30; a row with no valid key
// writes 0; scores and accumulators are f32.
#pragma once

#include "common.cuh"

namespace port {
namespace decode {

constexpr int KT = 32;        // keys per tile, one per lane
constexpr int GMAX = 8;       // largest GQA group, one warp per query
constexpr int THREADS = 32 * GMAX;

// T: q / staged / out element type; P: pool element type (T or int8_t,
// whose pages carry one f32 scale per (layer, kv head, page) when QUANT).
// q and out are [B, n_q, HD] for this launch; pools are
// [L, n_kv, num_pages, page_size, HD] read at `layer`; bt is this row's
// block table; staged_k / staged_v are [B, n_kv, n_steps, HD].
template <typename T, typename P, int HD, bool QUANT, bool STAGED>
__device__ __forceinline__ void decode_block(
    const T* __restrict__ q, const P* __restrict__ k_pages, const P* __restrict__ v_pages,
    const T* __restrict__ staged_k, const T* __restrict__ staged_v, T* __restrict__ out,
    const int* __restrict__ bt, int pool_len, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, int b, int kvh, int n_q, int n_kv, int num_pages,
    int page_size, int max_pages, int n_steps, int staged_len, int layer, float scale) {
  using PoolR = PoolRow<P, HD>;
  using StagedR = PoolRow<T, HD>;
  constexpr int VN = Vec<T>::N;
  constexpr int VPR = HD / VN;
  constexpr int DC = HD / 32;  // head dims per lane in P.V
  __shared__ float Qs[GMAX][HD];
  __shared__ float Ks[KT][HD + 1];
  __shared__ float Vs[KT][HD];
  __shared__ float Ps[GMAX][KT];

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

  const int n_keys = STAGED ? pool_len + staged_len : pool_len;
  const size_t layer_head = (size_t)layer * n_kv + kvh;
  const size_t head_off = layer_head * num_pages * page_size * PoolR::STORED;
  const P* kbase = k_pages + head_off;
  const P* vbase = v_pages + head_off;
  const float* ks = QUANT ? k_scales + layer_head * num_pages : nullptr;
  const float* vs = QUANT ? v_scales + layer_head * num_pages : nullptr;
  const size_t staged_off = STAGED ? ((size_t)b * n_kv + kvh) * n_steps * HD : 0;
  const T* skbase = STAGED ? staged_k + staged_off : nullptr;
  const T* svbase = STAGED ? staged_v + staged_off : nullptr;

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
      } else if (STAGED && pos < n_keys) {
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

    const float mn = fmaxf(m, warp_max(s, 32));
    const float alpha = expf(m - mn);
    const float p = expf(s - mn);
    l = l * alpha + warp_sum(p, 32);
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

}  // namespace decode
}  // namespace port
