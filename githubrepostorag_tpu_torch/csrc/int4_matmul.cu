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
// the tensor cores bound it; at M = 8 (the prefill logits) the weight bytes
// do, and the dequantization's instructions come close.
//
// Design (bf16 x).  Swap-AB: the kernel computes out^T[N, M] = W^T x^T, so
// the dequantized weight is wgmma's A operand, built in registers, and x is
// the B operand, read by wgmma from shared memory; wgmma's n (8..256) is a
// tile of M, so the prefill logits (M = 8) run m64n8 with no padded rows.
//   - A K step covers SB packed byte rows: SB k slots of low nibbles, then
//     SB of high nibbles.  With SB = gsz/2 (gsz 64 or 128) a step is one
//     whole group and its slots are x's natural k order.
//   - Warp specialisation: warpgroup 0 loads, warpgroups 1 and 2 each own
//     64 weight columns of the block's 128 and all BM rows of x.  The loads
//     go through a ring of 3..8 shared-memory stages with one "full" and one
//     "empty" mbarrier each; setmaxnreg moves registers to the consumers.
//   - Two loaders fill the same stage layout.  TMA (cp.async.bulk.tensor),
//     one thread, for gsz 64 / 128 with 16-byte strides and bases: x as
//     [BM][64] bf16 boxes in the 128-byte swizzle (wgmma's K-major B), the
//     q tile [SB][128] uint8 in the 128-byte swizzle, one s and one zs row.
//     cp.async, the whole warpgroup, for every other shape the wrapper
//     accepts (ragged N, any gsz % 16 == 0): predicated 16-byte x copies
//     gathered into slot order, 4-byte q, s and zs copies (2-byte loads and
//     stores for q when N % 4 == 2), zeros past the edges.
//   - Each consumer thread dequantizes its A fragments straight from the q
//     tile: the mma A fragment gives it rows gid and gid + 8 of its warp's
//     16, which the kernel maps to the adjacent columns 2*gid and 2*gid + 1,
//     so one 2-byte load serves both, and the swizzle spreads the four
//     byte rows a load instruction touches over distinct banks.  Nothing
//     dequantized goes back to shared memory.  The product n * s rounds to
//     bf16, then the difference with zs does, as dequant4 rounds, in bf16x2
//     arithmetic (five instructions for two weights; deq2 says why the
//     bits are the same).
//   - Persistent blocks walk the (M, N) tiles, M fastest, so the loads of a
//     block's next tile overlap its epilogue.  The epilogue stores each
//     thread's two adjacent columns of a row: a warp writes whole 32-byte
//     sectors (64 bytes for f32 out).  No atomics: the sum order is fixed.
// f32 x (the comparison runs): int4_fma_kernel, a 64 x 64 tile on the CUDA
// cores, unchanged since its first version.

#include <cuda.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// ------------------------------------------------------------- f32 x, FMA --

constexpr int THREADS = 256;
constexpr int KB = 32;      // packed byte rows per K step
constexpr int KS = 2 * KB;  // k slots per K step: KB low-plane rows, then KB high-plane rows

// x column of k slot `slot` in the K step that starts at packed byte row b0
__device__ __forceinline__ int slot_col(int b0, int slot, int half, int gsz) {
  const bool hi = slot >= KB;
  const int br = b0 + (hi ? slot - KB : slot);
  return (br / half) * gsz + br % half + (hi ? half : 0);
}

// four dequantized f32 weights of column `col`: packed rows br and br + 1
// (one group, since gsz/2 is even), low and high nibbles; two f32
// roundings, as torch's (n * s) - zs in float32
__device__ __forceinline__ void dequant_pair(const uint8_t* __restrict__ q,
                                             const __nv_bfloat16* __restrict__ s,
                                             const __nv_bfloat16* __restrict__ zs, int br, int col,
                                             int N, int half, float* lo, float* hi) {
  const size_t gi = (size_t)(br / half) * N + col;
  const float sv = __bfloat162float(s[gi]), zv = __bfloat162float(zs[gi]);
  const unsigned q0 = q[(size_t)br * N + col], q1 = q[(size_t)(br + 1) * N + col];
  lo[0] = __fsub_rn(__fmul_rn((float)(q0 & 15u), sv), zv);
  lo[1] = __fsub_rn(__fmul_rn((float)(q1 & 15u), sv), zv);
  hi[0] = __fsub_rn(__fmul_rn((float)(q0 >> 4), sv), zv);
  hi[1] = __fsub_rn(__fmul_rn((float)(q1 >> 4), sv), zv);
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
      if (n0 + n < N) dequant_pair(q, s, zs, b0 + r, n0 + n, N, half, lo, hi);
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

// ------------------------------------------------------ bf16 x, wgmma --

constexpr int LOADER_TMA = 0, LOADER_CP_ASYNC = 1;  // codes passed from the wrapper
constexpr int WG = 128;                             // threads of a warpgroup
constexpr int GEMM_THREADS = 3 * WG;                // loader + two consumer warpgroups
constexpr int BN = 128;                             // weight columns per tile
constexpr int SMEM_LIMIT = 232448;                  // bytes of shared memory a block may use

template <int LOADER, int SB, int BM>
struct Cfg {
  static constexpr int KSTEP = 2 * SB;                        // k slots per step
  static constexpr int XSUB = KSTEP / 64;                     // [BM][64] x sub-tiles per step
  static constexpr int GW = LOADER == LOADER_TMA ? 1 : 4;     // s / zs rows per step
  static constexpr int X_BYTES = XSUB * BM * 128;
  static constexpr int Q_BYTES = SB * BN;
  static constexpr int S_BYTES = GW * BN * 2;
  static constexpr int STAGE = (X_BYTES + Q_BYTES + 2 * S_BYTES + 1023) / 1024 * 1024;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - 256) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + slack to align the ring to 1024 bytes
  // registers a thread after setmaxnreg (128 * LOADER_REGS + 256 *
  // CONSUMER_REGS <= 64K): the cp.async loader computes its addresses itself
  static constexpr int LOADER_REGS = LOADER == LOADER_TMA ? 40 : 56;
  static constexpr int CONSUMER_REGS = LOADER == LOADER_TMA ? 232 : 224;
  static_assert(STAGES >= 3, "stage does not fit three times");
  static_assert(BM % 8 == 0 && BM <= 256, "wgmma n");
};

struct GemmParams {
  CUtensorMap tm_x, tm_q, tm_s, tm_zs;  // TMA loader only
  const __nv_bfloat16* x;
  const uint8_t* q;
  const __nv_bfloat16* s;
  const __nv_bfloat16* zs;
  void* out;
  int M, K, N, gsz, out_f32, m_tiles, tiles;
};

// bf16x2 arithmetic, each result rounded once to nearest even (an explicit
// rounding mode also keeps ptxas from fusing a mul and a sub into an fma)
__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Two weights as bf16x2 from two nibbles, one in each 16-bit lane of
// `nib2` (bits 0..3 and 16..19, the rest 0), and one column's scales
// broadcast to both lanes: bf16(bf16(n * s) - zs), as dequant4 rounds.
// 0x4300 | n is the bf16 128 + n, exactly, so subtracting 128 gives n
// exactly; n * s is exact before its rounding (4 by 8 significant bits);
// and a difference of two bf16 values rounds to the same bf16 whether
// rounded once or first to f32 (f32 holds it exactly unless the exponents
// differ by more than 16, and then the smaller is below a quarter ulp of
// the larger): tests/test_torch_int4_kernels.py checks both claims over
// the bf16 values, and chip_smoke.py holds the kernel's weights to
// dequant4 bit for bit.
__device__ __forceinline__ uint32_t deq2(uint32_t nib2, uint32_t s2, uint32_t z2) {
  const uint32_t n2 = bf2_sub(nib2 | 0x43004300u, 0x43004300u);
  return bf2_sub(bf2_mul(n2, s2), z2);
}

__device__ __forceinline__ uint32_t lds16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// the bf16 pair {v[col], v[col + 1]} at p as {v[col], v[col]} and
// {v[col + 1], v[col + 1]}
__device__ __forceinline__ uint2 lds_bf2_split(const uint8_t* p) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
  return make_uint2(__byte_perm(v, 0, 0x1010), __byte_perm(v, 0, 0x3232));
}

// Loader warpgroup, cp.async route: one step's x slots, q rows and s / zs
// rows into a stage, zeros past the edges; every thread arrives twice on
// `full` (once now, once when its copies land).
template <int SB, int BM>
__device__ __forceinline__ void cp_async_step(const GemmParams& p, uint8_t* base, uint64_t* full,
                                              int m0, int n0, int b0, int lt) {
  using C = Cfg<LOADER_CP_ASYNC, SB, BM>;
  const int half = p.gsz / 2, n_g = p.K / p.gsz, gw = b0 / half;
  for (int i = lt; i < BM * (C::KSTEP / 8); i += WG) {
    const int r = i / (C::KSTEP / 8), j = (i % (C::KSTEP / 8)) * 8;  // row, first slot
    const bool hi = j >= SB;
    const int br = b0 + (hi ? j - SB : j);
    const int k = (br / half) * p.gsz + br % half + (hi ? half : 0);
    const bool ok = m0 + r < p.M;
    uint8_t* dst = base + (j / 64) * BM * 128 + r * 128 + ((((j % 64) / 8) ^ (r & 7)) << 4);
    hopper::cp_async16(dst, ok ? p.x + (size_t)(m0 + r) * p.K + k : p.x, ok ? 16 : 0);
  }
  uint8_t* qs = base + C::X_BYTES;
  if (p.N % 4 == 0) {
    for (int i = lt; i < SB * (BN / 4); i += WG) {
      const int r = i / (BN / 4), nl = (i % (BN / 4)) * 4;
      const bool ok = n0 + nl < p.N;
      uint8_t* dst = qs + r * 128 + (((nl >> 4) ^ (r & 7)) << 4) + (nl & 15);
      hopper::cp_async4(dst, ok ? p.q + (size_t)(b0 + r) * p.N + n0 + nl : p.q, ok ? 4 : 0);
    }
  } else {  // rows start 2 bytes off a 4-byte boundary: plain 2-byte copies
    for (int i = lt; i < SB * (BN / 2); i += WG) {
      const int r = i / (BN / 2), nl = (i % (BN / 2)) * 2;
      uint16_t v = 0;
      if (n0 + nl < p.N)
        v = *reinterpret_cast<const uint16_t*>(p.q + (size_t)(b0 + r) * p.N + n0 + nl);
      *reinterpret_cast<uint16_t*>(qs + r * 128 + (((nl >> 4) ^ (r & 7)) << 4) + (nl & 15)) = v;
    }
  }
  uint8_t* ss = qs + C::Q_BYTES;
  for (int i = lt; i < C::GW * (BN / 2); i += WG) {
    const int g = i / (BN / 2), nl = (i % (BN / 2)) * 2;
    const bool ok = n0 + nl < p.N && gw + g < n_g;
    const size_t off = ok ? (size_t)(gw + g) * p.N + n0 + nl : 0;
    hopper::cp_async4(ss + g * BN * 2 + nl * 2, p.s + off, ok ? 4 : 0);
    hopper::cp_async4(ss + C::S_BYTES + g * BN * 2 + nl * 2, p.zs + off, ok ? 4 : 0);
  }
  hopper::cp_async_arrive(full);
  hopper::mbar_arrive(full);
}

template <int LOADER, int SB, int BM>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    int4_wgmma_kernel(const __grid_constant__ GemmParams p) {
  using C = Cfg<LOADER, SB, BM>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[C::STAGES], empty_bar[C::STAGES];
  uint8_t* ring = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x, wg = tid / WG;
  if (tid == 0) {
    for (int st = 0; st < C::STAGES; ++st) {
      hopper::mbar_init(&full_bar[st], LOADER == LOADER_TMA ? 1 : 2 * WG);
      hopper::mbar_init(&empty_bar[st], 8);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  const int n_steps = p.K / (2 * SB);

  if (wg == 0) {
    // ---------------------------------------------------------- loader --
    hopper::setmaxnreg_dec<C::LOADER_REGS>();
    if constexpr (LOADER == LOADER_TMA) {
      if (tid != 0) return;
    }
    int it = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const int m0 = (t % p.m_tiles) * BM, n0 = (t / p.m_tiles) * BN;
      for (int step = 0; step < n_steps; ++step, ++it) {
        const int st = it % C::STAGES;
        hopper::mbar_wait(&empty_bar[st], ((it / C::STAGES) & 1) ^ 1);
        uint8_t* base = ring + st * C::STAGE;
        const int b0 = step * SB;
        if constexpr (LOADER == LOADER_TMA) {  // SB = gsz / 2: step `step` is group `step`
          hopper::mbar_expect_tx(&full_bar[st], C::X_BYTES + C::Q_BYTES + 2 * C::S_BYTES);
#pragma unroll
          for (int i = 0; i < C::XSUB; ++i)
            hopper::tma_load_2d(base + i * BM * 128, &p.tm_x, &full_bar[st], 2 * b0 + 64 * i, m0);
          uint8_t* qs = base + C::X_BYTES;
          hopper::tma_load_2d(qs, &p.tm_q, &full_bar[st], n0, b0);
          hopper::tma_load_2d(qs + C::Q_BYTES, &p.tm_s, &full_bar[st], n0, step);
          hopper::tma_load_2d(qs + C::Q_BYTES + C::S_BYTES, &p.tm_zs, &full_bar[st], n0, step);
        } else {
          cp_async_step<SB, BM>(p, base, &full_bar[st], m0, n0, b0, tid);
        }
      }
    }
    if constexpr (LOADER == LOADER_CP_ASYNC) hopper::cp_async_wait_all();
    return;
  }

  // ------------------------------------------------------------ consumers --
  hopper::setmaxnreg_inc<C::CONSUMER_REGS>();
  const int ct = tid - WG * wg, warp = ct / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  // A rows gid and gid + 8 of this warp are weight columns nl and nl + 1
  const int nl = 64 * (wg - 1) + 16 * warp + 2 * gid;
  // swizzled byte offsets of column nl in q rows r with r & 7 == 2*tig, 2*tig + 1
  const int qcol0 = (((nl >> 4) ^ (2 * tig)) << 4) | (nl & 15);
  const int qcol1 = (((nl >> 4) ^ (2 * tig + 1)) << 4) | (nl & 15);
  const int half = p.gsz / 2;

  float acc[BM / 2];
  // A fragments of one wgmma group (two pairs of byte-row blocks: four
  // slices), in two sets: a group's set is written again only after the
  // group has retired
  uint32_t a0[4][4], a1[4][4];

  int it = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const int m0 = (t % p.m_tiles) * BM, n0 = (t / p.m_tiles) * BN;
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
    hopper::fence_regs<BM / 2>(acc);

    // One wgmma group: byte rows 16*pi .. 16*pi + 15 for pi = p0, p0 + 1,
    // their low nibbles (slices p0, p0 + 1) and high nibbles (slices p0 +
    // SB/16, p0 + 1 + SB/16).  Everything is dequantized before the fence
    // (ptxas keeps wgmmas asynchronous only if nothing else writes their A
    // registers while they are in flight), then the four wgmmas issue as
    // one group; when the group before has retired, and it was the last of
    // its stage, that stage is released.
    auto group_fn = [&](const uint8_t* xs, int b0, int p0, bool release_prev,
                        uint32_t (&a)[4][4]) {
      const uint8_t* qs = xs + C::X_BYTES;
      const uint8_t* ss = qs + C::Q_BYTES;
      const int gw = b0 / half;
      const uint2 sv = lds_bf2_split(ss + nl * 2), zv = lds_bf2_split(ss + C::S_BYTES + nl * 2);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r0 = 16 * (p0 + u) + 2 * tig;  // rows r0, r0 + 1 (one group), r0 + 8, r0 + 9
        // bytes [col, col + 1] of rows r0 and r0 + 1 (then r0 + 8 and r0 + 9):
        // lane 0 of t holds row r0's pair, lane 1 row r0 + 1's
        const uint32_t t0 = __byte_perm(lds16(qs + r0 * 128 + qcol0),
                                        lds16(qs + (r0 + 1) * 128 + qcol1), 0x5410);
        const uint32_t t1 = __byte_perm(lds16(qs + (r0 + 8) * 128 + qcol0),
                                        lds16(qs + (r0 + 9) * 128 + qcol1), 0x5410);
        uint2 sa = sv, za = zv, sb = sv, zb = zv;
        if constexpr (LOADER == LOADER_CP_ASYNC) {  // a step may span up to four groups
          const int ga = (b0 + r0) / half - gw, gb = (b0 + r0 + 8) / half - gw;
          sa = lds_bf2_split(ss + ga * BN * 2 + nl * 2);
          za = lds_bf2_split(ss + C::S_BYTES + ga * BN * 2 + nl * 2);
          sb = lds_bf2_split(ss + gb * BN * 2 + nl * 2);
          zb = lds_bf2_split(ss + C::S_BYTES + gb * BN * 2 + nl * 2);
        }
        constexpr uint32_t NIB = 0x000F000Fu;
        uint32_t* lo = a[u];      // slice p0 + u: low nibbles; column col in byte 0
        uint32_t* hi = a[2 + u];  // slice p0 + u + SB/16: high nibbles
        lo[0] = deq2(t0 & NIB, sa.x, za.x);
        lo[1] = deq2((t0 >> 8) & NIB, sa.y, za.y);
        lo[2] = deq2(t1 & NIB, sb.x, zb.x);
        lo[3] = deq2((t1 >> 8) & NIB, sb.y, zb.y);
        hi[0] = deq2((t0 >> 4) & NIB, sa.x, za.x);
        hi[1] = deq2((t0 >> 12) & NIB, sa.y, za.y);
        hi[2] = deq2((t1 >> 4) & NIB, sb.x, zb.x);
        hi[3] = deq2((t1 >> 12) & NIB, sb.y, zb.y);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // slice sl reads slots 16*sl ..: x sub-tile sl / 4, 32 bytes a slice into its rows
        const int sl = p0 + (i & 1) + (i >> 1) * (SB / 16);
        const uint64_t desc = hopper::desc_k_sw128(xs + (sl / 4) * BM * 128, (sl % 4) * 32);
        hopper::wgmma_rs<BM>(acc, a[i], desc);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      if (release_prev) {
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty_bar[(it - 1) % C::STAGES]);
      }
    };

    // one K step: wait for its stage, then its SB/32 groups
    auto step_fn = [&](int step, uint32_t (&a)[4][4], uint32_t (&b)[4][4]) {
      const int st = it % C::STAGES;
      hopper::mbar_wait(&full_bar[st], (it / C::STAGES) & 1);
      if constexpr (LOADER == LOADER_CP_ASYNC) hopper::fence_proxy_async();
      const uint8_t* xs = ring + st * C::STAGE;
      group_fn(xs, step * SB, 0, step > 0, a);
      if constexpr (SB == 64) group_fn(xs, step * SB, 2, false, b);
      ++it;
    };

    // two groups an iteration, one set each, and no branch between them
    // (ptxas then sees that no in-flight wgmma reads a set being written)
    if constexpr (SB == 32) {  // one group a step
      int step = 0;
      for (; step + 1 < n_steps; step += 2) {
        step_fn(step, a0, a1);
        step_fn(step + 1, a1, a0);
      }
      if (step < n_steps) step_fn(step, a0, a1);
    } else {  // two groups a step
      for (int step = 0; step < n_steps; ++step) step_fn(step, a0, a1);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs<BM / 2>(acc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty_bar[(it - 1) % C::STAGES]);

    // D fragment: rows gid / gid + 8 are columns n, n + 1; chunk j holds
    // x rows 8j + 2*tig and 8j + 2*tig + 1
    const int n = n0 + nl;
    if (n < p.N) {
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const int m = m0 + 8 * j + 2 * tig;
        if (p.out_f32) {
          if (m < p.M) store2<true>(p.out, (size_t)m * p.N + n, acc[4 * j], acc[4 * j + 2]);
          if (m + 1 < p.M)
            store2<true>(p.out, (size_t)(m + 1) * p.N + n, acc[4 * j + 1], acc[4 * j + 3]);
        } else {
          if (m < p.M) store2<false>(p.out, (size_t)m * p.N + n, acc[4 * j], acc[4 * j + 2]);
          if (m + 1 < p.M)
            store2<false>(p.out, (size_t)(m + 1) * p.N + n, acc[4 * j + 1], acc[4 * j + 3]);
        }
      }
    }
  }
}

// ------------------------------------------------------------------ host --

template <int LOADER, int SB, int BM>
int launch_bm(GemmParams& p, int grid, cudaStream_t stream) {
  using C = Cfg<LOADER, SB, BM>;
  p.m_tiles = (p.M + BM - 1) / BM;
  p.tiles = p.m_tiles * ((p.N + BN - 1) / BN);
  if constexpr (LOADER == LOADER_TMA) {
    const uint64_t K = p.K, N = p.N;
    using hopper::encode_2d;
    if (!encode_2d(&p.tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.x, K, p.M, 2 * K, 64, BM,
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
        !encode_2d(&p.tm_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.q, N, K / 2, N, BN, SB,
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
        !encode_2d(&p.tm_s, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.s, N, K / p.gsz, 2 * N, BN, 1,
                   CU_TENSOR_MAP_SWIZZLE_NONE) ||
        !encode_2d(&p.tm_zs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.zs, N, K / p.gsz, 2 * N, BN, 1,
                   CU_TENSOR_MAP_SWIZZLE_NONE))
      return (int)cudaErrorInvalidValue;
  }
  auto kernel = int4_wgmma_kernel<LOADER, SB, BM>;
  static bool sized = false;  // one per instance
  if (!sized) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  kernel<<<grid < p.tiles ? grid : p.tiles, GEMM_THREADS, C::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int LOADER, int SB>
int launch_loader(GemmParams& p, int block_m, int grid, cudaStream_t stream) {
  switch (block_m) {
    case 8: return launch_bm<LOADER, SB, 8>(p, grid, stream);
    case 64: return launch_bm<LOADER, SB, 64>(p, grid, stream);
    case 128: return launch_bm<LOADER, SB, 128>(p, grid, stream);
    case 256: return launch_bm<LOADER, SB, 256>(p, grid, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// x [M, K] (bf16 or f32), q [K/2, N] uint8, s / zs [K/gsz, N] bf16,
// out [M, N] (bf16 or f32).  Needs K % 64 == 0, gsz % 16 == 0, N even.
// bf16 x: `loader` (0 TMA, 1 cp.async), `block_m` (8, 64, 128 or 256 rows
// of x per tile) and `grid` (persistent blocks) come from the wrapper's
// plan (ops/int4_matmul._plan_int4); the TMA loader needs gsz 64 or 128,
// N % 16 == 0 and 16-byte aligned x, q, s and zs, and a shape it cannot
// take is refused, not rerouted.  f32 x ignores the three.
extern "C" int int4_matmul_launch(const void* x, const void* q, const void* s, const void* zs,
                                  void* out, int M, int K, int N, int gsz, int x_dtype,
                                  int out_dtype, int loader, int block_m, int grid,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return 0;
  if (K % KS || gsz % 16 || K % gsz || N % 2) return (int)cudaErrorInvalidValue;
  const auto* qb = static_cast<const uint8_t*>(q);
  const auto* sb = static_cast<const __nv_bfloat16*>(s);
  const auto* zb = static_cast<const __nv_bfloat16*>(zs);
  const bool f32_out = out_dtype == port::DTYPE_F32;
  if (x_dtype == port::DTYPE_BF16) {
    if (grid < 1) return (int)cudaErrorInvalidValue;
    GemmParams p;
    p.x = static_cast<const __nv_bfloat16*>(x);
    p.q = qb;
    p.s = sb;
    p.zs = zb;
    p.out = out;
    p.M = M;
    p.K = K;
    p.N = N;
    p.gsz = gsz;
    p.out_f32 = f32_out ? 1 : 0;
    if (loader == LOADER_TMA) {
      if ((gsz != 64 && gsz != 128) || N % 16 || !aligned16(x) || !aligned16(q) ||
          !aligned16(s) || !aligned16(zs))
        return (int)cudaErrorInvalidValue;
      return gsz == 64 ? launch_loader<LOADER_TMA, 32>(p, block_m, grid, st)
                       : launch_loader<LOADER_TMA, 64>(p, block_m, grid, st);
    }
    if (loader == LOADER_CP_ASYNC) {
      if (!aligned16(x) || reinterpret_cast<uintptr_t>(q) % 4 ||
          reinterpret_cast<uintptr_t>(s) % 4 || reinterpret_cast<uintptr_t>(zs) % 4)
        return (int)cudaErrorInvalidValue;
      return launch_loader<LOADER_CP_ASYNC, 32>(p, block_m, grid, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (x_dtype == port::DTYPE_F32) {
    const dim3 fgrid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
    const auto* xf = static_cast<const float*>(x);
    if (f32_out)
      int4_fma_kernel<true><<<fgrid, THREADS, 0, st>>>(xf, qb, sb, zb, out, M, K, N, gsz);
    else
      int4_fma_kernel<false><<<fgrid, THREADS, 0, st>>>(xf, qb, sb, zb, out, M, K, N, gsz);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
