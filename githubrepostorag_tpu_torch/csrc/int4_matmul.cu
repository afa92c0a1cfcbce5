// int4 weight-only GEMM, bf16-dequant route (kernel D), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// githubrepostorag_tpu/ops/pallas_int4.py::int4_matmul (_int4_kernel,
// pallas_call at pallas_int4.py:418).  out[M, N] = x[M, K] @ W, where W is
// the in-group plane-packed uint4 weight of models/quant.QuantizedLinear4:
// byte row j of group g holds weight row g*gsz + j in its low nibble and row
// g*gsz + j + gsz/2 in its high nibble, and a nibble n of group g dequantizes
// as n * s[g, o] - zs[g, o], rounded in the activation dtype exactly where
// the plain version (ops/int4_matmul.int4_matmul_ref) rounds.  Accumulation
// is f32; the output is bf16, or f32 for logits.
//
// What bounds it on this card: at prefill (M up to 4096 rows) each weight
// byte feeds M multiply-adds, far above the H100's ~295 FLOP/byte ridge, so
// operations bound it; at M = 8 (the prefill logits) the weight bytes do.
//
// Design.  A K step covers 32 packed byte rows, i.e. 64 weight rows: rows
// b0..b0+31's low nibbles and their high-nibble partners gsz/2 further on.
// The kernel fills 64 "k slots" in shared memory in that order (low plane,
// then high plane) and gathers the matching x columns, which are two
// contiguous 32-column runs per group, so no interleave is needed.  The
// dequantized tile is stored n-major (k contiguous) so that each mma
// fragment is one 32-bit shared load without bank conflicts.
//   bf16 x: 128 x 128 output tile per 256-thread block, 8 warps of 64 x 32,
//           tensor cores through mma.sync.m16n8k16 (bf16 in, f32 sum).
//   f32 x:  64 x 64 tile, 4 x 4 outputs per thread, f32 FMA on the CUDA
//           cores (the tensor cores have no full-f32 product); used by the
//           f32 comparison runs.
// Loads and compute are not overlapped (no cp.async / TMA pipeline) and
// the tensor-core path is mma.sync, not wgmma: a first version, right and
// simple; its times against the bound are in PERF.md.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int KB = 32;      // packed byte rows per K step
constexpr int KS = 2 * KB;  // k slots per K step: KB low-plane rows, then KB high-plane rows

template <typename T>
__device__ __forceinline__ float dequant(unsigned nib, float s, float z);
// f32: two f32 roundings, as torch's (n * s) - zs in float32
template <>
__device__ __forceinline__ float dequant<float>(unsigned nib, float s, float z) {
  return __fsub_rn(__fmul_rn((float)nib, s), z);
}
// bf16: the product rounds to bf16, then the difference does, as torch's
// bf16 (n * s) - zs
template <>
__device__ __forceinline__ float dequant<__nv_bfloat16>(unsigned nib, float s, float z) {
  const float p = __bfloat162float(__float2bfloat16_rn(__fmul_rn((float)nib, s)));
  return __bfloat162float(__float2bfloat16_rn(__fsub_rn(p, z)));
}

// x column of k slot `slot` in the K step that starts at packed byte row b0
__device__ __forceinline__ int slot_col(int b0, int slot, int half, int gsz) {
  const bool hi = slot >= KB;
  const int br = b0 + (hi ? slot - KB : slot);
  return (br / half) * gsz + br % half + (hi ? half : 0);
}

// four dequantized weights of column `col`: packed rows br and br + 1 (one
// group, since gsz/2 is even), low and high nibbles
template <typename T>
__device__ __forceinline__ void dequant_pair(const uint8_t* __restrict__ q,
                                             const __nv_bfloat16* __restrict__ s,
                                             const __nv_bfloat16* __restrict__ zs,
                                             int br, int col, int N, int half, float* lo,
                                             float* hi) {
  const size_t gi = (size_t)(br / half) * N + col;
  const float sv = __bfloat162float(s[gi]), zv = __bfloat162float(zs[gi]);
  const unsigned q0 = q[(size_t)br * N + col], q1 = q[(size_t)(br + 1) * N + col];
  lo[0] = dequant<T>(q0 & 15u, sv, zv);
  lo[1] = dequant<T>(q1 & 15u, sv, zv);
  hi[0] = dequant<T>(q0 >> 4, sv, zv);
  hi[1] = dequant<T>(q1 >> 4, sv, zv);
}

template <bool OUT_F32>
__device__ __forceinline__ void store2(void* out, size_t idx, float a, float b) {
  if (OUT_F32) {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) = make_float2(a, b);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + idx) =
        __floats2bfloat162_rn(a, b);
  }
}

// ------------------------------------------------------------ bf16 x, mma --

constexpr int BM = 128, BN = 128;
constexpr int SPAD = 8;  // bf16 row padding: rows 36 words apart, fragment loads conflict-free

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool OUT_F32>
__global__ void __launch_bounds__(THREADS) int4_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ zs,
    void* __restrict__ out, int M, int K, int N, int gsz) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][KS + SPAD];  // [row][k slot]
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][KS + SPAD];  // [col][k slot]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;  // warp's 64 x 32 sub-tile
  const int half = gsz / 2;

  float acc[4][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int b0 = 0; b0 < K / 2; b0 += KB) {
    // x tile: BM rows x KS slots, 8 slots (16 bytes) per load; 8 slots
    // never straddle a group half (gsz % 16 == 0)
    for (int i = tid; i < BM * (KS / 8); i += THREADS) {
      const int r = i / (KS / 8), c = (i % (KS / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M)
        v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + slot_col(b0, c, half, gsz));
      *reinterpret_cast<uint4*>(&As[r][c]) = v;
    }
    // weight tile: each pass dequantizes two packed rows of one column
    // (byte loads coalesced along N) into four k slots
    for (int i = tid; i < BN * (KB / 2); i += THREADS) {
      const int n = i % BN, r = (i / BN) * 2;
      float lo[2] = {0.f, 0.f}, hi[2] = {0.f, 0.f};
      if (n0 + n < N) dequant_pair<__nv_bfloat16>(q, s, zs, b0 + r, n0 + n, N, half, lo, hi);
      *reinterpret_cast<__nv_bfloat162*>(&Bs[n][r]) = __floats2bfloat162_rn(lo[0], lo[1]);
      *reinterpret_cast<__nv_bfloat162*>(&Bs[n][KB + r]) = __floats2bfloat162_rn(hi[0], hi[1]);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int row = wm + mt * 16 + gid;
        a[mt][0] = ld32(&As[row][kk + tig * 2]);
        a[mt][1] = ld32(&As[row + 8][kk + tig * 2]);
        a[mt][2] = ld32(&As[row][kk + tig * 2 + 8]);
        a[mt][3] = ld32(&As[row + 8][kk + tig * 2 + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = wn + nt * 8 + gid;
        b[nt][0] = ld32(&Bs[col][kk + tig * 2]);
        b[nt][1] = ld32(&Bs[col][kk + tig * 2 + 8]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();
  }

  // fragment (gid, tig): rows gid and gid + 8, columns 2*tig and 2*tig + 1
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int row = m0 + wm + mt * 16 + gid;
      const int col = n0 + wn + nt * 8 + tig * 2;
      if (col >= N) continue;
      if (row < M) store2<OUT_F32>(out, (size_t)row * N + col, acc[mt][nt][0], acc[mt][nt][1]);
      if (row + 8 < M)
        store2<OUT_F32>(out, (size_t)(row + 8) * N + col, acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

// ------------------------------------------------------------- f32 x, FMA --

constexpr int FBM = 64, FBN = 64, FPAD = 4;

template <bool OUT_F32>
__global__ void __launch_bounds__(THREADS) int4_fma_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ q,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ zs,
    void* __restrict__ out, int M, int K, int N, int gsz) {
  __shared__ __align__(16) float As[KS][FBM + FPAD];  // [k slot][row]
  __shared__ __align__(16) float Bs[KS][FBN + FPAD];  // [k slot][col]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * FBN, m0 = blockIdx.y * FBM;
  const int half = gsz / 2;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int b0 = 0; b0 < K / 2; b0 += KB) {
    for (int i = tid; i < FBM * (KS / 4); i += THREADS) {
      const int r = i / (KS / 4), c = (i % (KS / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < M)
        v = *reinterpret_cast<const float4*>(x + (size_t)(m0 + r) * K + slot_col(b0, c, half, gsz));
      As[c][r] = v.x;
      As[c + 1][r] = v.y;
      As[c + 2][r] = v.z;
      As[c + 3][r] = v.w;
    }
    for (int i = tid; i < FBN * (KB / 2); i += THREADS) {
      const int n = i % FBN, r = (i / FBN) * 2;
      float lo[2] = {0.f, 0.f}, hi[2] = {0.f, 0.f};
      if (n0 + n < N) dequant_pair<float>(q, s, zs, b0 + r, n0 + n, N, half, lo, hi);
      Bs[r][n] = lo[0];
      Bs[r + 1][n] = lo[1];
      Bs[KB + r][n] = hi[0];
      Bs[KB + r + 1][n] = hi[1];
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < KS; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      const int col = n0 + tx * 4 + j;
      if (col < N) store2<OUT_F32>(out, (size_t)row * N + col, acc[i][j], acc[i][j + 1]);
    }
  }
}

}  // namespace

// x [M, K] (bf16 or f32), q [K/2, N] uint8, s / zs [K/gsz, N] bf16,
// out [M, N] (bf16 or f32).  Needs K % 64 == 0, gsz % 16 == 0, N even.
extern "C" int int4_matmul_launch(const void* x, const void* q, const void* s, const void* zs,
                                  void* out, int M, int K, int N, int gsz, int x_dtype,
                                  int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return 0;
  if (K % KS || gsz % 16 || K % gsz || N % 2) return (int)cudaErrorInvalidValue;
  const auto* qb = static_cast<const uint8_t*>(q);
  const auto* sb = static_cast<const __nv_bfloat16*>(s);
  const auto* zb = static_cast<const __nv_bfloat16*>(zs);
  const bool f32_out = out_dtype == port::DTYPE_F32;
  if (x_dtype == port::DTYPE_BF16) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    if (f32_out)
      int4_mma_kernel<true><<<grid, THREADS, 0, st>>>(xb, qb, sb, zb, out, M, K, N, gsz);
    else
      int4_mma_kernel<false><<<grid, THREADS, 0, st>>>(xb, qb, sb, zb, out, M, K, N, gsz);
  } else if (x_dtype == port::DTYPE_F32) {
    const dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
    const auto* xf = static_cast<const float*>(x);
    if (f32_out)
      int4_fma_kernel<true><<<grid, THREADS, 0, st>>>(xf, qb, sb, zb, out, M, K, N, gsz);
    else
      int4_fma_kernel<false><<<grid, THREADS, 0, st>>>(xf, qb, sb, zb, out, M, K, N, gsz);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
