// int4 weight x int8 activation GEMM, W4A8 route (kernel E), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// githubrepostorag_tpu/ops/pallas_int4.py::_w4a8_matmul (_w4a8_kernel,
// pallas_call at pallas_int4.py:305).  For each weight group g it takes the
// int8 x uint4 -> int32 dot product of the row-quantized activations
// xg[g, m, :] against the group's nibble values and adds float(partial) *
// s[g, o] to an f32 accumulator:
//
//     acc[m, o] = sum_g s[g, o] * sum_j xg[g, m, j] * nib(g, j, o)
//
// The activation quantization, the zero-point term and the final
// sxn * (acc - zs_term) are plain torch around this kernel
// (ops/int4_matmul.py), as they are plain XLA around the Pallas call.
//
// What bounds it on this card: decode runs M <= 256 rows (8 on the serving
// path), so every weight byte feeds at most 2 * M integer operations: the
// int4 weight and scale bytes bound it.
//
// Design.  A block owns 128 output columns (4 per lane, so each packed-row
// read is one coalesced 128-byte warp load) and 8 activation rows; its 8
// warps split the groups among themselves (warp w takes g = w, w + 8, ...)
// and add their partial sums in warp order at the end through shared
// memory, so the result does not depend on scheduling.  Per group a warp
// stages the group's 8 x gsz int8 activations in shared memory (read back
// as broadcasts), then walks the packed rows four at a time: the low and
// high nibble planes of a 4-row x 4-column byte block are transposed with
// byte permutes so that each column's four consecutive k values sit in one
// word, and __dp4a takes the int8 dot products (nibbles 0..15 are valid
// signed bytes).  Partials stay int32 within a group: |p| <= 127 * 15 *
// gsz < 2^24, exact.  The grid runs the row tiles of one column range
// next to each other, so a weight tile read for one row tile is an L2 hit
// for the others.

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int COLS = 4;          // output columns per lane
constexpr int BN = 32 * COLS;    // output columns per block
constexpr int MT = 8;            // activation rows per block
constexpr int GSZ_MAX = 128;

// 4 packed rows x 4 columns of bytes (row t in word t, column c in byte c)
// -> per column c one word holding rows 0..3 in bytes 0..3
__device__ __forceinline__ void transpose4(const uint32_t* rows, uint32_t* cols) {
  const uint32_t a_lo = __byte_perm(rows[0], rows[1], 0x5140);  // r0c0 r1c0 r0c1 r1c1
  const uint32_t a_hi = __byte_perm(rows[0], rows[1], 0x7362);  // r0c2 r1c2 r0c3 r1c3
  const uint32_t b_lo = __byte_perm(rows[2], rows[3], 0x5140);  // r2c0 r3c0 r2c1 r3c1
  const uint32_t b_hi = __byte_perm(rows[2], rows[3], 0x7362);  // r2c2 r3c2 r2c3 r3c3
  cols[0] = __byte_perm(a_lo, b_lo, 0x5410);  // r0c0 r1c0 r2c0 r3c0
  cols[1] = __byte_perm(a_lo, b_lo, 0x7632);  // r0c1 r1c1 r2c1 r3c1
  cols[2] = __byte_perm(a_hi, b_hi, 0x5410);
  cols[3] = __byte_perm(a_hi, b_hi, 0x7632);
}

__global__ void __launch_bounds__(THREADS) w4a8_kernel(
    const int8_t* __restrict__ xg, const uint8_t* __restrict__ q,
    const __nv_bfloat16* __restrict__ s, float* __restrict__ acc_out, int M, int N,
    int n_g, int gsz) {
  __shared__ __align__(16) int8_t xs[WARPS][MT][GSZ_MAX];
  __shared__ float red[WARPS][MT][BN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * MT;
  const int col0 = blockIdx.y * BN + lane * COLS;
  const bool live = col0 < N;  // N % 4 == 0: a live lane owns 4 real columns
  const int half = gsz / 2;

  float acc[MT][COLS];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = 0.f;

  for (int g = warp; g < n_g; g += WARPS) {
    // stage this group's MT x gsz activations (rows past M are 0)
    __syncwarp();
    for (int i = lane * 16; i < MT * gsz; i += 32 * 16) {
      const int r = i / gsz, j = i % gsz;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M)
        v = *reinterpret_cast<const uint4*>(xg + ((size_t)g * M + m0 + r) * gsz + j);
      *reinterpret_cast<uint4*>(&xs[warp][r][j]) = v;
    }
    __syncwarp();

    int p[MT][COLS];
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int c = 0; c < COLS; ++c) p[r][c] = 0;

    for (int j = 0; j < half; j += 4) {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (live) {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          w[t] = *reinterpret_cast<const uint32_t*>(q + ((size_t)g * half + j + t) * N + col0);
      }
      uint32_t lo[4], hi[4], wl[4], wh[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        lo[t] = w[t] & 0x0F0F0F0Fu;         // rows g*gsz + j + t
        hi[t] = (w[t] >> 4) & 0x0F0F0F0Fu;  // rows g*gsz + half + j + t
      }
      transpose4(lo, wl);
      transpose4(hi, wh);
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        const int xl = *reinterpret_cast<const int*>(&xs[warp][r][j]);
        const int xh = *reinterpret_cast<const int*>(&xs[warp][r][half + j]);
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          p[r][c] = __dp4a(xl, (int)wl[c], p[r][c]);
          p[r][c] = __dp4a(xh, (int)wh[c], p[r][c]);
        }
      }
    }

    if (live) {
      const uint2 raw = *reinterpret_cast<const uint2*>(s + (size_t)g * N + col0);
      const __nv_bfloat162* sv = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 s01 = __bfloat1622float2(sv[0]), s23 = __bfloat1622float2(sv[1]);
      const float sc[COLS] = {s01.x, s01.y, s23.x, s23.y};
#pragma unroll
      for (int r = 0; r < MT; ++r)
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[r][c] += __fmul_rn((float)p[r][c], sc[c]);
    }
  }

  // add the warps' partial sums in warp order
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) red[warp][r][lane * COLS + c] = acc[r][c];
  __syncthreads();
  for (int i = tid; i < MT * BN; i += THREADS) {
    const int r = i / BN, cc = i % BN;
    const int col = blockIdx.y * BN + cc;
    if (m0 + r >= M || col >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += red[w][r][cc];
    acc_out[(size_t)(m0 + r) * N + col] = v;
  }
}

}  // namespace

// xg [n_g, M, gsz] int8 (group-major row-quantized activations), q [K/2, N]
// uint8, s [n_g, N] bf16, acc [M, N] f32.  Needs gsz % 16 == 0,
// gsz <= 128, N % 4 == 0.
extern "C" int w4a8_matmul_launch(const void* xg, const void* q, const void* s, void* acc,
                                  int M, int K, int N, int gsz, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return 0;
  if (gsz % 16 || gsz > GSZ_MAX || K % gsz || N % 4) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + MT - 1) / MT, (N + BN - 1) / BN);
  w4a8_kernel<<<grid, THREADS, 0, st>>>(static_cast<const int8_t*>(xg),
                                        static_cast<const uint8_t*>(q),
                                        static_cast<const __nv_bfloat16*>(s),
                                        static_cast<float*>(acc), M, N, K / gsz, gsz);
  return (int)cudaGetLastError();
}
