// The CUDA-core block body of kernels A (fused_window_attention.cu) and C
// (packed_prefill.cu) for f32 queries: the checking path, held to 1e-5
// against the plain versions, which bf16 tensor cores cannot meet.  bf16
// queries take prefill_attention.cuh's tensor-core body.  Flash attention
// of a window of query positions of one kv head against the pages of one
// block table, causal from a cached base.
//
// The (window position t, group member g) pairs of one kv head form one flat
// row index rr = t * group + g (any group size, 7 included), tiled WIN_ROWS
// rows to a block.  Row rr reads and writes query token tok(t) of q / out
// ([tokens, n_q, HD]) at head kvh * group + g; its position is cached + t.
// A block walks its keys WIN_KT at a time through the block table up to
// min(total, cached + last t of the tile + 1) -- the causal bound of its
// rows -- with Q, one K tile, one V tile and the probabilities in shared
// memory and (m, l, acc) in registers.  Masked scores are -1e30; a row with
// no valid KV writes 0; scores and accumulators are f32.  Quantized pools
// (QUANT) hold int8 codes or int4 nibble planes: a key's score is scaled by
// scale * ks[page] and a value row by vs[page], in f32, as the TPU kernel
// applies them.
#pragma once

#include "common.cuh"

namespace port {

constexpr int WIN_ROWS = 64;      // flat query rows per block
constexpr int WIN_KT = 32;        // keys per tile
constexpr int WIN_THREADS = 256;  // 16 (tx) x 16 (ty)

template <int HD>
constexpr size_t window_smem_bytes() {
  return sizeof(float) * (WIN_ROWS * (HD + 1) + WIN_KT * (HD + 1) + WIN_KT * HD +
                          WIN_ROWS * (WIN_KT + 1) + WIN_KT);
}

// T: q / out element type; P: pool element type (T, int8_t or uint8_t).
// kbase / vbase: this kv head's pages; bt: this row's block table; ks / vs:
// this kv head's per-page scales (QUANT only).
template <typename T, typename P, int HD, bool QUANT, typename TokenOf>
__device__ __forceinline__ void window_block(
    const T* __restrict__ q, const P* __restrict__ kbase, const P* __restrict__ vbase,
    T* __restrict__ out, const int* __restrict__ bt, const float* __restrict__ ks,
    const float* __restrict__ vs, TokenOf tok, int rows_total, int r0, int kvh,
    int group, int n_q, int cached, int total, int page_size, int max_pages,
    float scale) {
  using Row = PoolRow<P, HD>;
  constexpr int VN = Vec<T>::N;
  constexpr int VPR = HD / VN;  // vectors per head row
  constexpr int DC = HD / 16;   // head dims per thread in P.V
  extern __shared__ float smem[];
  float* Qs = smem;                          // [WIN_ROWS][HD + 1]
  float* Ks = Qs + WIN_ROWS * (HD + 1);      // [WIN_KT][HD + 1]
  float* Vs = Ks + WIN_KT * (HD + 1);        // [WIN_KT][HD]
  float* Ps = Vs + WIN_KT * HD;              // [WIN_ROWS][WIN_KT + 1]
  float* Ksc = Ps + WIN_ROWS * (WIN_KT + 1);  // [WIN_KT] score scale per key

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int t_last = (min(r0 + WIN_ROWS, rows_total) - 1) / group;
  const int kv_end = min(total, cached + t_last + 1);

  for (int i = tid; i < WIN_ROWS * VPR; i += WIN_THREADS) {
    const int r = i / VPR, c = (i % VPR) * VN;
    const int rr = r0 + r;
    float vals[VN];
    if (rr < rows_total) {
      const int t = rr / group, g = rr % group;
      Vec<T>::load(q + ((size_t)tok(t) * n_q + kvh * group + g) * HD + c, vals);
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

  for (int k0 = 0; k0 < kv_end; k0 += WIN_KT) {
    __syncthreads();  // Q stored / previous tile fully consumed
    for (int i = tid; i < WIN_KT * Row::CHUNKS; i += WIN_THREADS) {
      const int kk = i / Row::CHUNKS, ch = i % Row::CHUNKS;
      const int pos = k0 + kk;
      if (pos < kv_end) {
        const int page = bt[min(pos / page_size, max_pages - 1)];
        const size_t off = ((size_t)page * page_size + pos % page_size) * Row::STORED;
        Row::load(kbase + off, ch, Ks + kk * (HD + 1), 1.f);
        Row::load(vbase + off, ch, Vs + kk * HD, QUANT ? vs[page] : 1.f);
        if (ch == 0) Ksc[kk] = QUANT ? scale * ks[page] : scale;
      } else {  // masked keys: zeros, so 0 * V stays finite
        Row::zero(ch, Ks + kk * (HD + 1));
        Row::zero(ch, Vs + kk * HD);
        if (ch == 0) Ksc[kk] = 0.f;
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
        s[i][j] = ok ? s[i][j] * Ksc[tx + 16 * j] : NEG_INF;
        mc = fmaxf(mc, s[i][j]);
      }
      mc = warp_max(mc, 16);  // the 16 tx lanes sharing row ty + 16i
      const float mn = fmaxf(m[i], mc);
      const float alpha = expf(m[i] - mn);
      const float p0 = expf(s[i][0] - mn);
      const float p1 = expf(s[i][1] - mn);
      l[i] = l[i] * alpha + warp_sum(p0 + p1, 16);
      m[i] = mn;
      Ps[(ty + 16 * i) * (WIN_KT + 1) + tx] = p0;
      Ps[(ty + 16 * i) * (WIN_KT + 1) + tx + 16] = p1;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < WIN_KT; ++kk) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[kk * HD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * (WIN_KT + 1) + kk];
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
    T* dst = out + ((size_t)tok(t) * n_q + kvh * group + g) * HD;
#pragma unroll
    for (int c = 0; c < DC; ++c) dst[tx + 16 * c] = from_float<T>(acc[i][c] * inv);
  }
}

}  // namespace port
