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
// gsz < 2^24 up to gsz 8800, exact in f32.  The grid runs the row tiles of
// one column range next to each other, so a weight tile read for one row
// tile is an L2 hit for the others.
//   w4a8_kernel takes groups up to 128 with N % 4 == 0 (every Qwen2-7B
// shape at groups 64 and 128): the whole group staged with 16-byte copies.
//   w4a8_general_kernel takes the rest the route sends (AutoAWQ's group
// 256, N % 4 != 0): a group walks its packed rows in pieces of PR (the
// largest of 64, 32, 16, 8 dividing gsz / 2), each staged as its low-plane
// then its high-plane activation columns, so the stage never grows; q and s
// are read byte by byte where N % 4 != 0, columns past N as 0.

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int COLS = 4;          // output columns per lane
constexpr int BN = 32 * COLS;    // output columns per block
constexpr int MT = 8;            // activation rows per block
constexpr int GSZ_MAX = 128;    // the 16-byte-staged kernel's widest group
constexpr int PR_MAX = 64;      // packed rows per staged piece (general kernel)

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

// gsz <= 128, N % 4 == 0, q 4-byte and s 8-byte aligned: the whole group
// staged with 16-byte copies, q and s read as words.
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

// four bytes of q row `row` from column col0 (0 past N)
template <bool VEC>
__device__ __forceinline__ uint32_t load_q4(const uint8_t* __restrict__ q, size_t row, int col0,
                                            int N) {
  if (VEC) return col0 < N ? *reinterpret_cast<const uint32_t*>(q + row * N + col0) : 0u;
  uint32_t w = 0u;
#pragma unroll
  for (int c = 0; c < COLS; ++c)
    if (col0 + c < N) w |= (uint32_t)q[row * N + col0 + c] << (8 * c);
  return w;
}

// Every other shape: groups in pieces of PR packed rows, q and s byte by byte
// unless N % 4 == 0 (VEC).
template <bool VEC>
__global__ void __launch_bounds__(THREADS) w4a8_general_kernel(
    const int8_t* __restrict__ xg, const uint8_t* __restrict__ q,
    const __nv_bfloat16* __restrict__ s, float* __restrict__ acc_out, int M, int N,
    int n_g, int gsz) {
  __shared__ __align__(16) int8_t xs[WARPS][MT][2 * PR_MAX];
  __shared__ float red[WARPS][MT][BN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * MT;
  const int col0 = blockIdx.y * BN + lane * COLS;
  const int half = gsz / 2;
  const int pr = half % 64 == 0 ? 64 : half % 32 == 0 ? 32 : half % 16 == 0 ? 16 : 8;

  float acc[MT][COLS];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = 0.f;

  for (int g = warp; g < n_g; g += WARPS) {
    int p[MT][COLS];
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int c = 0; c < COLS; ++c) p[r][c] = 0;

    for (int j0 = 0; j0 < half; j0 += pr) {
      // stage this piece's MT x 2pr activations, 4 bytes a copy: x columns
      // j0.. (low plane) then half + j0.. (high plane); rows past M are 0
      __syncwarp();
      for (int i = lane; i < MT * (2 * pr / 4); i += 32) {
        const int r = i / (2 * pr / 4), w4 = (i % (2 * pr / 4)) * 4;
        const int col = w4 < pr ? j0 + w4 : half + j0 + (w4 - pr);
        int v = 0;
        if (m0 + r < M)
          v = *reinterpret_cast<const int*>(xg + ((size_t)g * M + m0 + r) * gsz + col);
        *reinterpret_cast<int*>(&xs[warp][r][w4]) = v;
      }
      __syncwarp();

      for (int j = 0; j < pr; j += 4) {
        uint32_t w[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) w[t] = load_q4<VEC>(q, (size_t)g * half + j0 + j + t, col0, N);
        uint32_t lo[4], hi[4], wl[4], wh[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          lo[t] = w[t] & 0x0F0F0F0Fu;         // rows g*gsz + j0 + j + t
          hi[t] = (w[t] >> 4) & 0x0F0F0F0Fu;  // rows g*gsz + half + j0 + j + t
        }
        transpose4(lo, wl);
        transpose4(hi, wh);
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const int xl = *reinterpret_cast<const int*>(&xs[warp][r][j]);
          const int xh = *reinterpret_cast<const int*>(&xs[warp][r][pr + j]);
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            p[r][c] = __dp4a(xl, (int)wl[c], p[r][c]);
            p[r][c] = __dp4a(xh, (int)wh[c], p[r][c]);
          }
        }
      }
    }

    float sc[COLS];
    const __nv_bfloat16* srow = s + (size_t)g * N + col0;
    if (VEC && col0 < N) {
      const float2 s01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(srow));
      const float2 s23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(srow + 2));
      sc[0] = s01.x; sc[1] = s01.y; sc[2] = s23.x; sc[3] = s23.y;
    } else {
#pragma unroll
      for (int c = 0; c < COLS; ++c) sc[c] = col0 + c < N ? __bfloat162float(srow[c]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[r][c] += __fmul_rn((float)p[r][c], sc[c]);
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
// uint8, s [n_g, N] bf16, acc [M, N] f32.  Needs gsz % 16 == 0, gsz <= 8192,
// q and s 4-byte aligned.  `general` (the wrapper's plan,
// ops/int4_matmul._plan_w4a8) is 0 for the shapes w4a8_kernel takes
// (gsz <= 128, N % 4 == 0, s 8-byte aligned), 1 for the rest.
extern "C" int w4a8_matmul_launch(const void* xg, const void* q, const void* s, void* acc,
                                  int M, int K, int N, int gsz, int general, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return 0;
  if (gsz % 16 || gsz > 8192 || K % gsz || reinterpret_cast<uintptr_t>(q) % 4 ||
      reinterpret_cast<uintptr_t>(s) % 4 ||
      (!general && (gsz > GSZ_MAX || N % 4 || reinterpret_cast<uintptr_t>(s) % 8)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((M + MT - 1) / MT, (N + BN - 1) / BN);
  const auto* x8 = static_cast<const int8_t*>(xg);
  const auto* q8 = static_cast<const uint8_t*>(q);
  const auto* sb = static_cast<const __nv_bfloat16*>(s);
  auto* out = static_cast<float*>(acc);
  if (!general)
    w4a8_kernel<<<grid, THREADS, 0, st>>>(x8, q8, sb, out, M, N, K / gsz, gsz);
  else if (N % 4 == 0)
    w4a8_general_kernel<true><<<grid, THREADS, 0, st>>>(x8, q8, sb, out, M, N, K / gsz, gsz);
  else
    w4a8_general_kernel<false><<<grid, THREADS, 0, st>>>(x8, q8, sb, out, M, N, K / gsz, gsz);
  return (int)cudaGetLastError();
}
