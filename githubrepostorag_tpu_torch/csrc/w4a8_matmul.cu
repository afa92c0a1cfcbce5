// int4 weight x int8 activation GEMM, the whole W4A8 route (kernel E), for
// Hopper (sm_90a).
//
// Replaces githubrepostorag_tpu/ops/pallas_int4.py::_w4a8_matmul: the Pallas
// TPU kernel (_w4a8_kernel, pallas_call at pallas_int4.py:305) and the XLA
// ops around it.  For x [M, K] (bf16 or f32), the in-group plane-packed int4
// weight q [K/2, N] (byte row j of group g: weight row g*gsz + j in the low
// nibble, g*gsz + gsz/2 + j in the high one) and its bf16 group scales s and
// zero points zs [K/gsz, N]:
//
//     xq, sxn  = per-row symmetric int8 of x (f32 amax; x * (127 / amax)
//                rounded half to even; 0 for an all-zero row; sxn = amax/127)
//     R[m, g]  = sum of xq over group g                            (int32)
//     acc[m,o] = sum_g s[g, o] * P[g, m, o]   (P: the exact int32 partial of
//                group g, xq against the nibbles 0..15)
//     zacc     = sum_g R[m, g] * zs[g, o]
//     y        = sxn * (acc - zacc), in bf16 or f32 (the logits)
//
// What bounds it on this card: decode runs M <= 256 rows (8 on the serving
// path), so each weight byte feeds at most 4 * M integer operations, far
// under the H100's ~590 int8 operations per byte of device memory: the
// weight, scale and zero-point bytes bound it at every decode shape, and at
// M = 8 the kernel has to keep ~25 KB a SM in flight to approach 3.35 TB/s.
//
// One C entry point launches two kernels on the caller's stream; the wrapper
// (ops/int4_matmul.py) allocates the output and one workspace, and plans
// every launch parameter from static shapes (_plan_w4a8).
//
//   w4a8_prologue: one block per row of x.  The row's amax, its int8 codes
//     (IEEE division and rintf, bit for bit torch's quantize_rows), sxn and
//     the group sums R, written in the layouts the main kernels read: for the
//     tensor-core kernel, per group and 32 packed rows, the two planes' 32 k
//     values each, permuted so that one 8-byte load is a thread's mma B
//     fragment.  It lets the main kernel launch at once (programmatic
//     dependent launch): the weights do not depend on it, the codes do.
//   w4a8_mma_kernel (every group with (gsz/2) % 32 == 0: the card's route):
//     - grid (row blocks, K splits, 128-column tiles); the plan splits the
//       groups so that the busiest SM carries as few as it can.  A block
//       owns a tile, 8 or 32 rows and a contiguous run of whole groups.
//     - warp 0 produces: per 32 packed rows of a group, one ring stage holding
//       the q tile [32][128] (TMA, 128-byte swizzle), the group's s and zs
//       rows (TMA), the codes of the chunk's two planes and the group's R
//       (bulk copies), all completing on one mbarrier.  The first ring fill's
//       weights are issued before the producer waits for the prologue
//       (griddepcontrol.wait), so weight bytes stream while it runs.  Shapes
//       TMA cannot take (N % 16, bases off 16 bytes) are copied by the
//       producer warp's own loads.
//     - 8 consumer warps: 4 column groups of 32 x 2 group parities.  A
//       thread reads 4 bytes (4 columns) of 8 packed rows, transposes them
//       with byte permutes and splits the nibble planes: 8 A fragments of
//       mma.m16n8k32.s8 (swap-AB: 16 weight columns x 32 k), reused for every
//       8-row tile of codes (the B operand, one 8-byte load).  Each group's
//       int32 partial is exact; it is folded as acc += float(p) * s, and
//       zacc += float(R) * zs beside it, in f32.
//     - the two parities add through shared memory; with one split the block
//       writes sxn * (acc - zacc), else its partial goes to the workspace and
//       the last block of the tile (a self-resetting arrival counter) merges
//       the splits in split order.  No result depends on scheduling.
//   w4a8_dp4a_kernel (groups the route never sends here: (gsz/2) % 32 != 0,
//     e.g. 16 or 48, reached by a direct call): the earlier CUDA-core body,
//     __dp4a on group-major codes, with the same in-kernel epilogue.

#include <cuda.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// codes passed from the wrapper's plan
constexpr int KIND_MMA = 0, KIND_DP4A = 1;
constexpr int LOADER_TMA = 0, LOADER_PLAIN = 1;
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a block may use

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

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void grid_dep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// D[16 x 8] (s32) += A[16 x 32] (s8, row-major fragment a[4]) * B[32 x 8]
// (s8, column-major fragment b0, b1)
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(hopper::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(hopper::smem_addr(bar))
      : "memory");
}

// 16 bytes of a row of x as floats
__device__ __forceinline__ void load_x16(const float* p, float* v) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}

__device__ __forceinline__ void load_x16(const __nv_bfloat16* p, float* v) {
  port::Vec<__nv_bfloat16>::load(p, v);
}

__device__ __forceinline__ int code_of(float v, float inv) {
  return static_cast<int>(rintf(__fmul_rn(v, inv)));
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 255) | (uint32_t)(b & 255) << 8 | (uint32_t)(c & 255) << 16 |
         (uint32_t)(d & 255) << 24;
}

// ------------------------------------------------------------- prologue --

constexpr int PRO_THREADS = 512;

// One block per row m of x (rows M..m_pad-1 write zeros).  MMA layout:
// codes [m_pad / bm][n_g][gsz / 64][2][bm][32]: per group, per 32 packed
// rows (a main-kernel stage), the low plane's then the high plane's 32 k
// values, word i of each 32-byte run holding the k offsets i, i+8, i+16 and
// i+24 (so a thread's mma B fragment is one 8-byte load); DP4A layout:
// codes [n_g][m_pad][gsz] in natural order (bm = m_pad).  Both: R [m_pad /
// bm][n_g][bm] int32, sxn [m_pad] f32.
template <typename T, bool MMA>
__global__ void __launch_bounds__(PRO_THREADS) w4a8_prologue(
    const T* __restrict__ x, int8_t* __restrict__ codes, int* __restrict__ rsum,
    float* __restrict__ sxn, int M, int K, int gsz, int bm, int m_pad) {
  grid_dep_launch();
  extern __shared__ int gsum[];  // [n_g]
  __shared__ float wmax[PRO_THREADS / 32];
  constexpr int V = 16 / sizeof(T);
  const int m = blockIdx.x, tid = threadIdx.x, n_g = K / gsz;
  const bool live = m < M;
  const T* row = x + (size_t)(live ? m : 0) * K;

  float amax = 0.f;
  if (live) {
    for (int i = tid * V; i < K; i += PRO_THREADS * V) {
      float v[V];
      load_x16(row + i, v);
#pragma unroll
      for (int j = 0; j < V; ++j) amax = fmaxf(amax, fabsf(v[j]));
    }
  }
  for (int g = tid; g < n_g; g += PRO_THREADS) gsum[g] = 0;
  amax = port::warp_max(amax, 32);
  if (tid % 32 == 0) wmax[tid / 32] = amax;
  __syncthreads();
  amax = wmax[0];
#pragma unroll
  for (int w = 1; w < PRO_THREADS / 32; ++w) amax = fmaxf(amax, wmax[w]);
  // torch: where(amax > 0, round(x * (127 / clamp_min(amax, 1e-30))), 0)
  const float inv = amax > 0.f ? __fdiv_rn(127.f, fmaxf(amax, 1e-30f)) : 0.f;

  if constexpr (MMA) {
    // natural k32 block kb of group g holds plane kb_g / kps, chunk kb_g % kps
    // (kb_g = kb - 2 kps g); it goes to block 2 (kps g + chunk) + plane
    const int kbs = K / 32, kps = gsz / 64;
    int8_t* dst = codes + ((size_t)(m / bm) * kbs * bm + m % bm) * 32;
    for (int kb = tid; kb < kbs; kb += PRO_THREADS) {
      int qv[32];
#pragma unroll
      for (int i = 0; i < 32; i += V) {
        float v[V];
        if (live) {
          load_x16(row + 32 * kb + i, v);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) v[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < V; ++j) qv[i + j] = code_of(v[j], inv);
      }
      int sum = 0;
      uint32_t w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        w[i] = pack4(qv[i], qv[i + 8], qv[i + 16], qv[i + 24]);
        sum += qv[i] + qv[i + 8] + qv[i + 16] + qv[i + 24];
      }
      const int g = kb / (2 * kps), kb_g = kb % (2 * kps);
      const int to = 2 * (kps * g + kb_g % kps) + kb_g / kps;
      uint4* d = reinterpret_cast<uint4*>(dst + (size_t)to * bm * 32);
      d[0] = make_uint4(w[0], w[1], w[2], w[3]);
      d[1] = make_uint4(w[4], w[5], w[6], w[7]);
      atomicAdd(&gsum[g], sum);  // integers: exact in any order
    }
  } else {
    for (int c = tid; c < K / 16; c += PRO_THREADS) {
      const int k0 = 16 * c, g = k0 / gsz;
      int qv[16];
#pragma unroll
      for (int i = 0; i < 16; i += V) {
        float v[V];
        if (live) {
          load_x16(row + k0 + i, v);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) v[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < V; ++j) qv[i + j] = code_of(v[j], inv);
      }
      int sum = 0;
#pragma unroll
      for (int i = 0; i < 16; ++i) sum += qv[i];
      *reinterpret_cast<uint4*>(codes + ((size_t)g * m_pad + m) * gsz + k0 % gsz) =
          make_uint4(pack4(qv[0], qv[1], qv[2], qv[3]), pack4(qv[4], qv[5], qv[6], qv[7]),
                     pack4(qv[8], qv[9], qv[10], qv[11]), pack4(qv[12], qv[13], qv[14], qv[15]));
      atomicAdd(&gsum[g], sum);  // integers: exact in any order
    }
  }
  __syncthreads();
  for (int g = tid; g < n_g; g += PRO_THREADS)
    rsum[((size_t)(m / bm) * n_g + g) * bm + m % bm] = gsum[g];
  if (tid == 0) sxn[m] = __fdiv_rn(amax, 127.f);
}

// --------------------------------------------------- tensor-core kernel --

constexpr int BN = 128;                            // weight columns per tile
constexpr int CONSUMERS = 8;                       // 4 column groups x 2 group parities
constexpr int MMA_THREADS = 32 * (1 + CONSUMERS);  // + the producer warp
constexpr int MAX_STAGES = 16;
constexpr int Q_ROWS = 32 * BN;  // q bytes of 32 packed rows (a group's plane at gsz 64)

// A stage holds G whole groups (gsz 64), or 32 packed rows of one group
// (gsz > 64: gsz / 64 stages a group, G = 1): the q tile [32 G][128] in the
// ring's q part (128-byte swizzle); in the stage's aux part the s rows [G]
// [128] and zs rows, the codes [G][2 planes][BM][32] and R [G][BM].
template <int BM>
struct MmaCfg {
  static constexpr int RT = BM / 8;  // 8-row tiles of codes
  static constexpr int X_BYTES = 2 * BM * 32;  // a chunk's codes
  static constexpr int R_BYTES = 4 * BM;
  static constexpr int MERGE = 128 * RT * 16 * 4;  // one parity's acc, zacc
  // aux offsets for G groups a stage; TMA writes 128-byte aligned
  __host__ __device__ static constexpr int x_off(int G) { return 4 * BN * G; }
  __host__ __device__ static constexpr int r_off(int G) { return (4 * BN + X_BYTES) * G; }
  __host__ __device__ static constexpr int aux(int G) {
    return ((4 * BN + X_BYTES + R_BYTES) * G + 127) / 128 * 128;
  }
};

struct MmaParams {
  CUtensorMap tm_q, tm_s, tm_zs;  // TMA loader only
  const uint8_t* q;
  const __nv_bfloat16* s;
  const __nv_bfloat16* zs;
  const int8_t* codes;
  const int* rsum;
  const float* sxn;
  float* part;
  int* counters;
  void* out;
  int M, N, n_g, kps, gpst, gps, splits, stages, out_f32, loader;
};

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The producer warp's own copy of a stage's q tile (packed rows row0 ..
// row0 + 32 cnt - 1) and the s / zs rows of groups g .. g + cnt - 1, for
// shapes TMA cannot take: bytes past N are zeros.
__device__ __forceinline__ void plain_weights(const MmaParams& p, uint8_t* qt, uint8_t* aux,
                                              size_t row0, int g, int cnt, int G, int n0,
                                              int lane) {
  const bool vec = p.N % 4 == 0 && reinterpret_cast<uintptr_t>(p.q) % 4 == 0;
  for (int i = lane; i < 32 * cnt * (BN / 4); i += 32) {
    const int r = i / (BN / 4), nl = (i % (BN / 4)) * 4;
    const uint8_t* src = p.q + (row0 + r) * p.N + n0 + nl;
    uint32_t w = 0u;
    if (vec) {
      if (n0 + nl < p.N) w = *reinterpret_cast<const uint32_t*>(src);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (n0 + nl + c < p.N) w |= (uint32_t)src[c] << (8 * c);
    }
    *reinterpret_cast<uint32_t*>(qt + r * 128 + (((nl >> 4) ^ (r & 7)) << 4) + (nl & 15)) = w;
  }
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  __nv_bfloat16* ss = reinterpret_cast<__nv_bfloat16*>(aux);
  for (int i = lane; i < cnt * BN; i += 32) {
    const int gl = i / BN, c = i % BN;
    const bool ok = n0 + c < p.N;
    ss[gl * BN + c] = ok ? p.s[(size_t)(g + gl) * p.N + n0 + c] : zero;
    ss[(G + gl) * BN + c] = ok ? p.zs[(size_t)(g + gl) * p.N + n0 + c] : zero;
  }
}

// MULTI: groups span several stages (gsz > 64), so the int32 partials of
// every row tile live across stages
// (blocks an SM the registers must allow: 3 at 8 rows, 1 at 32)
template <int BM, bool MULTI>
__global__ void __launch_bounds__(MMA_THREADS, BM == 8 ? 3 : 1)
    w4a8_mma_kernel(const __grid_constant__ MmaParams p) {
  using C = MmaCfg<BM>;
  constexpr int RT = C::RT;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[MAX_STAGES], empty_bar[MAX_STAGES];
  __shared__ int last_block;
  uint8_t* ring = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  const int stages = p.stages, G = p.gpst;
  const int q_stage = Q_ROWS * G, aux_stage = C::aux(G);
  const int x_off = C::x_off(G), r_off = C::r_off(G);
  uint8_t* aux_ring = ring + stages * q_stage;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rb = blockIdx.x, split = blockIdx.y, ct = blockIdx.z;
  const int m0 = rb * BM, n0 = ct * BN;
  const int g0 = split * p.gps;
  const int n = min(p.gps, p.n_g - g0);  // groups of this block
  const int kps = p.kps;                  // stages a group (G = 1 when above 1)
  const int n_st = kps == 1 ? (n + G - 1) / G : n * kps;
  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      // TMA: the producer's expect_tx; plain: that and the 32 lanes' stores
      hopper::mbar_init(&full_bar[st], p.loader == LOADER_TMA ? 1 : 33);
      hopper::mbar_init(&empty_bar[st], 4);  // the 4 warps of the stage's parity
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 0) {
    // -------------------------------------------------------- producer --
    // stage i: packed rows from (g0 kps + i G) * 32, groups from g0 + i G
    // (G > 1) or g0 + i / kps, cnt groups (a split's last stage may hold fewer)
    const int8_t* xsrc = p.codes + ((size_t)rb * p.n_g * kps + (size_t)g0 * kps) * C::X_BYTES;
    auto first = [&](int i) { return g0 + (kps == 1 ? i * G : i / kps); };
    auto count = [&](int i) { return kps == 1 ? min(G, n - i * G) : 1; };
    auto acts = [&](int i) {  // the stage's codes and its groups' R: from the prologue
      uint8_t* aux = aux_ring + (i % stages) * aux_stage;
      uint64_t* bar = &full_bar[i % stages];
      const int cnt = count(i);
      bulk_load(aux + x_off, xsrc + (size_t)i * G * C::X_BYTES, cnt * C::X_BYTES, bar);
      bulk_load(aux + r_off, p.rsum + ((size_t)rb * p.n_g + first(i)) * BM, cnt * C::R_BYTES, bar);
    };
    if (p.loader == LOADER_TMA) {
      if (lane != 0) return;
      auto weights = [&](int i) {
        const int st = i % stages;
        uint8_t* aux = aux_ring + st * aux_stage;
        const int cnt = count(i);
        hopper::mbar_expect_tx(&full_bar[st],
                               q_stage + 4 * BN * G + cnt * (C::X_BYTES + C::R_BYTES));
        hopper::tma_load_2d(ring + st * q_stage, &p.tm_q, &full_bar[st], n0,
                            (g0 * kps + i * G) * 32);
        hopper::tma_load_2d(aux, &p.tm_s, &full_bar[st], n0, first(i));
        hopper::tma_load_2d(aux + 2 * BN * G, &p.tm_zs, &full_bar[st], n0, first(i));
      };
      // the first ring fill's weights stream while the prologue runs
      const int pre = min(stages, n_st);
      for (int i = 0; i < pre; ++i) weights(i);
      grid_dep_wait();
      for (int i = 0; i < pre; ++i) acts(i);
      for (int i = pre; i < n_st; ++i) {
        hopper::mbar_wait(&empty_bar[i % stages], ((i / stages) & 1) ^ 1);
        weights(i);
        acts(i);
      }
    } else {
      grid_dep_wait();
      for (int i = 0; i < n_st; ++i) {
        const int st = i % stages, cnt = count(i);
        hopper::mbar_wait(&empty_bar[st], ((i / stages) & 1) ^ 1);
        if (lane == 0) {
          hopper::mbar_expect_tx(&full_bar[st], cnt * (C::X_BYTES + C::R_BYTES));
          acts(i);
        }
        plain_weights(p, ring + st * q_stage, aux_ring + st * aux_stage,
                      ((size_t)g0 * kps + (size_t)i * G) * 32, first(i), cnt, G, n0, lane);
        hopper::mbar_arrive(&full_bar[st]);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers --
  const int cw = warp - 1, cg = cw & 3, par = cw >> 2;
  const int gid = lane >> 2, tig = lane & 3;
  const int c4 = 32 * cg + 4 * gid;  // the thread's 4 columns of the tile: c4 .. c4 + 3
  // swizzled offsets of those columns in q rows r with r & 7 == 2 tig, 2 tig + 1
  const int off_e = (((c4 >> 4) ^ (2 * tig)) << 4) | (c4 & 15);
  const int off_o = (((c4 >> 4) ^ (2 * tig + 1)) << 4) | (c4 & 15);
  const int rts = min(RT, (p.M - m0 + 7) / 8);  // row tiles past the rows are skipped

  // thread outputs: rows 2 tig + h (h = e / 4) of each 8-row tile, columns
  // c4 + e % 4
  float acc[RT][8], zacc[RT][8];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[rt][e] = zacc[rt][e] = 0.f;
  int pc[MULTI ? RT : 1][2][4];  // int32 partials of the group, column pair t

  // parity par takes every other unit: a stage of G groups (gsz 64), or
  // the kps stages of one group
  const int n_units = kps == 1 ? n_st : n;
  for (int u = par; u < n_units; u += 2) {
    for (int c = 0; c < kps; ++c) {
      const int i = u * kps + c, st = i % stages;
      const bool last = !MULTI || c == kps - 1;
      const int cnt = kps == 1 ? min(G, n - i * G) : 1;
      hopper::mbar_wait(&full_bar[st], (i / stages) & 1);
      for (int gl = 0; gl < cnt; ++gl) {
        const uint8_t* qt = ring + st * q_stage + gl * Q_ROWS;
        const uint8_t* aux = aux_ring + st * aux_stage;

        // A fragments: column pair t (A rows gid and gid + 8 are columns c4 +
        // 2t and c4 + 2t + 1), low and high plane.  mma k index 4 tig + v is
        // packed row 2 tig + 8 v of the group's 32, 16 + 4 tig + v is 2 tig
        // + 1 + 8 v: every load instruction of the warp hits 32 distinct
        // banks in the 128-byte swizzle.
        uint32_t alo[2][4], ahi[2][4];
        {
          uint32_t we[4], wo[4], te[4], to[4];
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            we[v] = lds32(qt + (2 * tig + 8 * v) * 128 + off_e);
            wo[v] = lds32(qt + (2 * tig + 1 + 8 * v) * 128 + off_o);
          }
          transpose4(we, te);  // te[c]: column c4 + c, packed rows 2 tig + 8 v in byte v
          transpose4(wo, to);
          constexpr uint32_t NIB = 0x0F0F0F0Fu;
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            alo[t][0] = te[2 * t] & NIB;
            alo[t][1] = te[2 * t + 1] & NIB;
            alo[t][2] = to[2 * t] & NIB;
            alo[t][3] = to[2 * t + 1] & NIB;
            ahi[t][0] = (te[2 * t] >> 4) & NIB;
            ahi[t][1] = (te[2 * t + 1] >> 4) & NIB;
            ahi[t][2] = (to[2 * t] >> 4) & NIB;
            ahi[t][3] = (to[2 * t + 1] >> 4) & NIB;
          }
        }
        float sv[4], zv[4];
        if (last) {
          const uint2 sr = *reinterpret_cast<const uint2*>(aux + 2 * (gl * BN + c4));
          const uint2 zr = *reinterpret_cast<const uint2*>(aux + 2 * ((G + gl) * BN + c4));
          const float2 s01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&sr.x));
          const float2 s23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&sr.y));
          const float2 z01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&zr.x));
          const float2 z23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&zr.y));
          sv[0] = s01.x; sv[1] = s01.y; sv[2] = s23.x; sv[3] = s23.y;
          zv[0] = z01.x; zv[1] = z01.y; zv[2] = z23.x; zv[3] = z23.y;
        }
        // B fragments: codes of row 8 rt + gid, low plane then high plane
        const uint8_t* xs = aux + x_off + gl * C::X_BYTES + gid * 32 + tig * 8;
        const uint8_t* rs = aux + r_off + gl * C::R_BYTES + 8 * tig;
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          if (rt >= rts) break;
          int (&pt)[2][4] = pc[MULTI ? rt : 0];
          if (!MULTI || c == 0) {
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
              for (int d = 0; d < 4; ++d) pt[t][d] = 0;
          }
          const uint2 bl = *reinterpret_cast<const uint2*>(xs + 8 * rt * 32);
          const uint2 bh = *reinterpret_cast<const uint2*>(xs + (BM + 8 * rt) * 32);
          mma_s8(pt[0], alo[0], bl.x, bl.y);
          mma_s8(pt[1], alo[1], bl.x, bl.y);
          mma_s8(pt[0], ahi[0], bh.x, bh.y);
          mma_s8(pt[1], ahi[1], bh.x, bh.y);
          if (last) {
            const int2 rr = *reinterpret_cast<const int2*>(rs + 32 * rt);
            const float rf[2] = {(float)rr.x, (float)rr.y};
            // D of pair t: {col 2t, row 0}, {col 2t, row 1}, {col 2t+1, row 0}, {col 2t+1, row 1}
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
              for (int d = 0; d < 4; ++d) {
                const int h = d & 1, col = 2 * t + (d >> 1), e = 4 * h + col;
                acc[rt][e] += __fmul_rn((float)pt[t][d], sv[col]);
                // at gsz 64 R * zs is exact in f32 (|R| <= 127 * 64 < 2^13,
                // zs has 8 significant bits): the fma rounds as mul then add
                if constexpr (MULTI)
                  zacc[rt][e] += __fmul_rn(rf[h], zv[col]);
                else
                  zacc[rt][e] = __fmaf_rn(rf[h], zv[col], zacc[rt][e]);
              }
          }
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty_bar[st]);
    }
  }

  // the two parities add (parity 0 + parity 1) through the idle ring
  bar_sync(1, 32 * CONSUMERS);
  float* red = reinterpret_cast<float*>(ring);
  const int ti = 32 * cg + lane;  // 0..127 within a parity
  if (par == 1) {
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        red[(rt * 16 + e) * 128 + ti] = acc[rt][e];
        red[(rt * 16 + 8 + e) * 128 + ti] = zacc[rt][e];
      }
  }
  bar_sync(1, 32 * CONSUMERS);
  if (par == 1) return;
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      acc[rt][e] += red[(rt * 16 + e) * 128 + ti];
      zacc[rt][e] += red[(rt * 16 + 8 + e) * 128 + ti];
    }

  if (p.splits > 1) {
    // this split's partial, then the tile's last block merges in split order
    const size_t tile = (size_t)rb + (size_t)gridDim.x * ct;
    const size_t chunk = (size_t)RT * 16 * 128;
    float* mine = p.part + ((size_t)split * gridDim.x * gridDim.z + tile) * chunk;
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        mine[(rt * 16 + e) * 128 + ti] = acc[rt][e];
        mine[(rt * 16 + 8 + e) * 128 + ti] = zacc[rt][e];
      }
    __threadfence();
    bar_sync(2, 128);
    if (ti == 0) last_block = atomicAdd(p.counters + tile, 1) == p.splits - 1;
    bar_sync(2, 128);
    if (!last_block) return;
    __threadfence();
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[rt][e] = zacc[rt][e] = 0.f;
    for (int sp = 0; sp < p.splits; ++sp) {
      const float* src = p.part + ((size_t)sp * gridDim.x * gridDim.z + tile) * chunk;
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          acc[rt][e] += __ldcg(src + (rt * 16 + e) * 128 + ti);
          zacc[rt][e] += __ldcg(src + (rt * 16 + 8 + e) * 128 + ti);
        }
    }
    if (ti == 0) p.counters[tile] = 0;
  }

  // y = sxn * (acc - zacc); sxn comes from the prologue
  grid_dep_wait();
  const bool vec = p.N % 4 == 0;
#pragma unroll
  for (int rt = 0; rt < RT; ++rt) {
    if (rt >= rts) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 8 * rt + 2 * tig + h;
      if (m >= p.M) continue;
      const float sx = p.sxn[m];
      float y[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        y[c] = __fmul_rn(sx, __fsub_rn(acc[rt][4 * h + c], zacc[rt][4 * h + c]));
      const int col = n0 + c4;
      const size_t idx = (size_t)m * p.N + col;
      if (vec && col + 3 < p.N) {
        if (p.out_f32) {
          *reinterpret_cast<float4*>(static_cast<float*>(p.out) + idx) =
              make_float4(y[0], y[1], y[2], y[3]);
        } else {
          const __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
          *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.out) + idx) =
              make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                         *reinterpret_cast<const uint32_t*>(&hi));
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (col + c >= p.N) break;
          if (p.out_f32)
            static_cast<float*>(p.out)[idx + c] = y[c];
          else
            static_cast<__nv_bfloat16*>(p.out)[idx + c] = __float2bfloat16_rn(y[c]);
        }
      }
    }
  }
}

// ------------------------------------------------------- CUDA-core kernel --

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int COLS = 4;        // output columns per lane
constexpr int DBN = 32 * COLS;  // output columns per block
constexpr int MT = 8;          // activation rows per block
constexpr int PR_MAX = 64;     // packed rows per staged piece

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

// four bf16 of a [n_g, N] row from column col0 as floats (0 past N)
template <bool VEC>
__device__ __forceinline__ void load_row4(const __nv_bfloat16* __restrict__ row, int col0, int N,
                                          float* v) {
  if (VEC && col0 < N) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + col0));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + col0 + 2));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
#pragma unroll
    for (int c = 0; c < COLS; ++c) v[c] = col0 + c < N ? __bfloat162float(row[col0 + c]) : 0.f;
  }
}

// Any gsz % 16 == 0: the group's packed rows in pieces of PR (the largest
// of 64, 32, 16, 8 dividing gsz / 2), each staged as its low-plane then its
// high-plane codes; warp w takes groups w, w + 8, ...; q, s and zs are read
// byte by byte unless N % 4 == 0 (VEC).  xg [n_g][m_pad][gsz], R [n_g][m_pad].
template <bool VEC>
__global__ void __launch_bounds__(THREADS) w4a8_dp4a_kernel(
    const int8_t* __restrict__ xg, const uint8_t* __restrict__ q,
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ zs,
    const int* __restrict__ rsum, const float* __restrict__ sxn, void* __restrict__ out,
    int out_f32, int M, int m_pad, int N, int n_g, int gsz) {
  __shared__ __align__(16) int8_t xs[WARPS][MT][2 * PR_MAX];
  __shared__ float red[WARPS][MT][DBN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * MT;
  const int col0 = blockIdx.y * DBN + lane * COLS;
  const int half = gsz / 2;
  const int pr = half % 64 == 0 ? 64 : half % 32 == 0 ? 32 : half % 16 == 0 ? 16 : 8;

  float acc[MT][COLS], zacc[MT][COLS];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = zacc[r][c] = 0.f;

  for (int g = warp; g < n_g; g += WARPS) {
    int p[MT][COLS];
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int c = 0; c < COLS; ++c) p[r][c] = 0;

    for (int j0 = 0; j0 < half; j0 += pr) {
      // stage this piece's MT x 2pr codes, 4 bytes a copy: x columns j0..
      // (low plane) then half + j0.. (high plane)
      __syncwarp();
      for (int i = lane; i < MT * (2 * pr / 4); i += 32) {
        const int r = i / (2 * pr / 4), w4 = (i % (2 * pr / 4)) * 4;
        const int col = w4 < pr ? j0 + w4 : half + j0 + (w4 - pr);
        *reinterpret_cast<int*>(&xs[warp][r][w4]) =
            *reinterpret_cast<const int*>(xg + ((size_t)g * m_pad + m0 + r) * gsz + col);
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

    float sc[COLS], zc[COLS];
    load_row4<VEC>(s + (size_t)g * N, col0, N, sc);
    load_row4<VEC>(zs + (size_t)g * N, col0, N, zc);
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      const float rf = (float)rsum[(size_t)g * m_pad + m0 + r];
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        acc[r][c] += __fmul_rn((float)p[r][c], sc[c]);
        zacc[r][c] += __fmul_rn(rf, zc[c]);
      }
    }
  }

  // add the warps' acc, then their zacc, in warp order
  constexpr int PER = MT * DBN / THREADS;
  float a[PER];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) red[warp][r][lane * COLS + c] = acc[r][c];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * THREADS, r = i / DBN, cc = i % DBN;
    a[k] = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a[k] += red[w][r][cc];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) red[warp][r][lane * COLS + c] = zacc[r][c];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * THREADS, r = i / DBN, cc = i % DBN;
    const int col = blockIdx.y * DBN + cc;
    if (m0 + r >= M || col >= N) continue;
    float z = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) z += red[w][r][cc];
    const float y = __fmul_rn(sxn[m0 + r], __fsub_rn(a[k], z));
    const size_t idx = (size_t)(m0 + r) * N + col;
    if (out_f32)
      static_cast<float*>(out)[idx] = y;
    else
      static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(y);
  }
}

// ------------------------------------------------------------------ host --

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

template <int BM, bool MULTI>
int launch_mma(MmaParams& p, int n_rb, int n_ct, cudaStream_t stream) {
  using C = MmaCfg<BM>;
  const int G = p.gpst;
  if (p.stages < 2 || p.stages > MAX_STAGES || G < 1 || G > 8 || (p.kps > 1 && G != 1))
    return (int)cudaErrorInvalidValue;
  const int ring = p.stages * (Q_ROWS * G + C::aux(G));
  const int smem = (ring > C::MERGE ? ring : C::MERGE) + 1024;
  if (smem > SMEM_LIMIT - 1024) return (int)cudaErrorInvalidValue;
  if (p.loader == LOADER_TMA) {
    const uint64_t N = p.N;
    using hopper::encode_2d;
    if (!encode_2d(&p.tm_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.q, N, (uint64_t)p.n_g * p.kps * 32,
                   N, BN, 32 * G, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !encode_2d(&p.tm_s, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.s, N, p.n_g, 2 * N, BN, G,
                   CU_TENSOR_MAP_SWIZZLE_NONE) ||
        !encode_2d(&p.tm_zs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.zs, N, p.n_g, 2 * N, BN, G,
                   CU_TENSOR_MAP_SWIZZLE_NONE))
      return (int)cudaErrorInvalidValue;
  }
  auto kernel = w4a8_mma_kernel<BM, MULTI>;
  static int sized = 0;  // one per instance: the largest opt-in so far
  if (smem > sized) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    sized = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_rb, p.splits, n_ct);
  cfg.blockDim = dim3(MMA_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;  // may start while the prologue runs
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, p);
}

template <typename T>
int launch_prologue(const void* x, void* codes, void* rsum, void* sxn, int M, int K, int gsz,
                    int mma, int bm, int m_pad, cudaStream_t stream) {
  const int smem = (K / gsz) * 4;
  auto* xt = static_cast<const T*>(x);
  auto* c8 = static_cast<int8_t*>(codes);
  auto* r32 = static_cast<int*>(rsum);
  auto* sf = static_cast<float*>(sxn);
  if (mma)
    w4a8_prologue<T, true><<<m_pad, PRO_THREADS, smem, stream>>>(xt, c8, r32, sf, M, K, gsz, bm,
                                                                  m_pad);
  else
    w4a8_prologue<T, false><<<m_pad, PRO_THREADS, smem, stream>>>(xt, c8, r32, sf, M, K, gsz,
                                                                   m_pad, m_pad);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, K] (bf16 or f32, 16-byte aligned), q [K/2, N] uint8, s / zs [K/gsz,
// N] bf16 (4-byte aligned), out [M, N] (bf16 or f32).  The workspace's
// sections (ops/int4_matmul._w4a8_layout): codes (m_pad * K int8), rsum
// (K/gsz * m_pad int32), sxn (m_pad f32), part (the splits' partials, when
// splits > 1), 16-byte aligned; counters: int32 per (row block, column
// tile), 0 before and after the launch.  From the plan
// (ops/int4_matmul._plan_w4a8): kind (0 mma: needs gsz % 64 == 0, that is
// (gsz/2) % 32 == 0; 1 dp4a: any gsz % 16 == 0 up to 8192), loader (0 TMA:
// N % 16 == 0 and q, s, zs 16-byte aligned; 1 the producer's own loads),
// block_m (8 or 32; dp4a 8), splits and groups per split
// (every split non-empty), ring stages (2..16).  The main kernel is
// launched with programmatic stream serialization: it may start while the
// prologue runs.  A shape the plan's kernel cannot take is refused, never
// rerouted.
extern "C" int w4a8_matmul_launch(const void* x, const void* q, const void* s, const void* zs,
                                  void* out, void* codes, void* rsum, void* sxn, void* part,
                                  void* counters, int M, int K, int N, int gsz, int x_dtype,
                                  int out_dtype, int kind, int loader, int block_m, int splits,
                                  int gps, int gpst, int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return 0;
  if (gsz % 16 || gsz <= 0 || gsz > 8192 || K % gsz || K / gsz > 12288 || !aligned16(x) ||
      !aligned16(codes) || !aligned16(rsum) || reinterpret_cast<uintptr_t>(q) % 4 ||
      reinterpret_cast<uintptr_t>(s) % 4 || reinterpret_cast<uintptr_t>(zs) % 4 ||
      (x_dtype != port::DTYPE_BF16 && x_dtype != port::DTYPE_F32) ||
      (out_dtype != port::DTYPE_BF16 && out_dtype != port::DTYPE_F32))
    return (int)cudaErrorInvalidValue;
  const int n_g = K / gsz;
  const bool mma = kind == KIND_MMA;
  if (mma && (gsz % 64 || (block_m != 8 && block_m != 32) ||
              splits < 1 || gps < 1 || (splits - 1) * gps >= n_g || splits * gps < n_g ||
              (splits > 1 && (part == nullptr || counters == nullptr)) ||
              (loader == LOADER_TMA && (N % 16 || !aligned16(q) || !aligned16(s) ||
                                        !aligned16(zs))) ||
              (loader != LOADER_TMA && loader != LOADER_PLAIN)))
    return (int)cudaErrorInvalidValue;
  if (!mma && kind != KIND_DP4A) return (int)cudaErrorInvalidValue;
  const int bm = mma ? block_m : 8;
  const int m_pad = (M + bm - 1) / bm * bm;

  int err = x_dtype == port::DTYPE_BF16
                ? launch_prologue<__nv_bfloat16>(x, codes, rsum, sxn, M, K, gsz, mma, bm, m_pad, st)
                : launch_prologue<float>(x, codes, rsum, sxn, M, K, gsz, mma, bm, m_pad, st);
  if (err) return err;

  const auto* qb = static_cast<const uint8_t*>(q);
  const auto* sb = static_cast<const __nv_bfloat16*>(s);
  const auto* zb = static_cast<const __nv_bfloat16*>(zs);
  const int out_f32 = out_dtype == port::DTYPE_F32 ? 1 : 0;
  if (!mma) {
    const dim3 grid(m_pad / MT, (N + DBN - 1) / DBN);
    const auto* c8 = static_cast<const int8_t*>(codes);
    const auto* r32 = static_cast<const int*>(rsum);
    const auto* sf = static_cast<const float*>(sxn);
    if (N % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0 && reinterpret_cast<uintptr_t>(s) % 4 == 0 &&
        reinterpret_cast<uintptr_t>(zs) % 4 == 0)
      w4a8_dp4a_kernel<true><<<grid, THREADS, 0, st>>>(c8, qb, sb, zb, r32, sf, out, out_f32, M,
                                                       m_pad, N, n_g, gsz);
    else
      w4a8_dp4a_kernel<false><<<grid, THREADS, 0, st>>>(c8, qb, sb, zb, r32, sf, out, out_f32, M,
                                                        m_pad, N, n_g, gsz);
    return (int)cudaGetLastError();
  }

  MmaParams p;
  p.q = qb;
  p.s = sb;
  p.zs = zb;
  p.codes = static_cast<const int8_t*>(codes);
  p.rsum = static_cast<const int*>(rsum);
  p.sxn = static_cast<const float*>(sxn);
  p.part = static_cast<float*>(part);
  p.counters = static_cast<int*>(counters);
  p.out = out;
  p.M = M;
  p.N = N;
  p.n_g = n_g;
  p.gps = gps;
  p.gpst = gpst;
  p.splits = splits;
  p.stages = stages;
  p.out_f32 = out_f32;
  p.loader = loader;
  p.kps = gsz / 64;
  const int n_rb = m_pad / bm, n_ct = (N + BN - 1) / BN;
  if (p.kps == 1) {
    switch (bm) {
      case 8: return launch_mma<8, false>(p, n_rb, n_ct, st);
      case 32: return launch_mma<32, false>(p, n_rb, n_ct, st);
    }
  } else {
    switch (bm) {
      case 8: return launch_mma<8, true>(p, n_rb, n_ct, st);
      case 32: return launch_mma<32, true>(p, n_rb, n_ct, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
