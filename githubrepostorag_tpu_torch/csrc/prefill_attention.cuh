// The tensor-core block body of kernels A (fused_window_attention.cu) and C
// (packed_prefill.cu) for bf16 queries on Hopper (sm_90a): flash attention
// of a window of query positions of one kv head against the pages of one
// block table, causal from a cached base, over bf16, int8 or int4 pools.
// f32 queries (the checking path) take window_attention.cuh's CUDA-core
// body instead; the launchers choose by q's dtype and never fall back.
//
// What bounds it on this card: 4 * hd operations per (query, key) pair
// against 2 * hd pool elements per key shared by a kv head's group * S
// queries, far above the ~295 FLOP/byte ridge: operations, at the bf16
// tensor-core rate.  Both products run on wgmma; P goes in as two bf16
// terms (below), so the tensor cores do 1.5x the counted work.
//
// Rows.  The (window position t, group member g) pairs of one kv head form
// the flat row index rr = t * group + g (any group, 7 included); a block
// takes ROWS = 128 of them, 64 per consumer warpgroup.  Row rr reads and
// writes token tok(t) of q / out ([tokens, n_q, HD]) at head kvh * group +
// g; its position is cached + t.  Each consumer warpgroup gathers its 64 q
// rows once with cp.async (rows are no rectangular box: group 7 strides 7
// rows a position, kernel C reads through row_of) into shared memory, in
// the K tiles' swizzled layout, where wgmma reads them as the A operand of
// every S.  (Held in registers as A, the q fragments were overwritten
// inside the key loop by ptxas at hd 64: the SASS reuses them after the
// first S and never reloads them.)  Rows past rows_total are zero and
// never written.
//
// Keys.  Warp 0 of the loader warpgroups keeps a ring of 64-key K and V
// stages in flight by TMA (its lane 0) from 2-D tensor maps over the
// layer's pools as [n_kv * P * ps, row] rows (decode_attention.cuh's
// tiles: a box per page, or per 64-row piece of a page, and per 128 bytes
// of a row, in the 128/64/32-byte swizzle); its lanes read the block
// table, and a quantized page's two scales, 32 pages at a time, each
// once.  A block walks keys up to the causal bound of its last row,
// min(total, cached + t_last + 1); only stages that reach past its first
// row's bound or past total are masked.  Blocks start longest first:
// grid.x runs the row tiles in reverse.
//
// Products.  S = Q K^T: wgmma m64n64k16 per 16 head dims, both operands
// from shared memory (K-major, 128-byte swizzle).  Online softmax in f32
// in the log2 domain; masked p is 0 by a select, never exp of a difference
// of -1e30s; a row with no valid key writes 0.  O += P V: the S accumulator
// of 16 keys is the A fragment of the next product, V the stage read as an
// MN-major ("transposed") B.  P keeps f32 precision as p_hi = bf16(p) and
// p_lo = bf16(p - p_hi), two products, as kernel B does: one bf16 p errs by
// ~2^-9 of the output's scale.  The two consumer warpgroups take turns on
// the tensor cores (ping-pong on named barriers): a turn issues S(t) and
// P V(t - 1) back to back, and the softmax of t runs while the other
// warpgroup's turn runs.  No branch lies between a wgmma's issue and its
// wait: ptxas serialises the wgmmas of such code (C7514).  bf16 V rows past
// the walk's last key are zeroed before P V, so stale or unwritten shared
// memory cannot reach the output as 0 * NaN.
//
// Quantized pools (kernel A).  int8 codes and int4 nibbles are exact in
// bf16: the loader warpgroups' other seven warps widen each arrived stage
// into a bf16 stage of the same swizzled layout (four instructions a pair
// of codes, bf16x2 adds on magic-number bits), release the raw stage at
// once, and the consumers run the bf16 products on the widened one.  Any
// code is finite, so rows past the walk's end need no zeroing: their p is
// 0.  The page's K scale (times 1/sqrt(hd)) multiplies the f32 scores of
// its keys and its V scale their p before the hi/lo split: the order of the
// TPU kernel.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "decode_attention.cuh"
#include "hopper.cuh"

namespace port {
namespace prefill {

constexpr int KT = 64;           // keys per ring stage
constexpr int ROWS = 128;        // flat query rows per block
constexpr int WG = 128;          // threads of a warpgroup
constexpr int LOADER_WGS = 2;    // the loader warpgroups, then two consumer warpgroups
constexpr int THREADS = (LOADER_WGS + 2) * WG;
// The consumers hold two stages at once: t - 1 until its P V retires, and
// t.  Ring depth (raw stages, as the pool holds them): 4 for bf16 pools, 3
// for quantized ones, whose raw stages are freed as soon as they are
// widened into one of WIDE_STAGES bf16 stages.
template <bool QUANT>
constexpr int STAGES_OF = QUANT ? 3 : 4;
constexpr int WIDE_STAGES = 4;
constexpr int CONVERTER_WARPS = 4 * LOADER_WGS - 1;  // the loader warps but the first widen
constexpr int PAGES_MAX = KT / 8;   // pages of one stage (8-key pages)
// registers a thread after setmaxnreg: 256 * LOADER + 256 * CONSUMER <= 64K
constexpr int LOADER_REGS = 48, CONSUMER_REGS = 208;
constexpr float LOG2E = 1.4426950408889634f;

// P: pool element: __nv_bfloat16, int8_t (codes) or uint8_t (int4 nibble
// planes, HD / 2 bytes a row)
template <typename P, int HD>
struct Cfg {
  static constexpr bool QUANT = !std::is_same<P, __nv_bfloat16>::value;
  static constexpr bool INT4 = std::is_same<P, uint8_t>::value;
  static constexpr int STAGES = STAGES_OF<QUANT>;
  using Raw = decode::Tile<P, INT4 ? HD / 2 : HD>;  // a stage's K or V tile as it arrives
  using Wide = decode::Tile<__nv_bfloat16, HD>;     // the bf16 tile the products read
  static constexpr int RING = STAGES * 2 * Raw::BYTES;
  static constexpr int QBYTES = ROWS * HD * 2;  // the block's q rows, swizzled as a K tile
  static constexpr int WIDE = QUANT ? WIDE_STAGES * 2 * Wide::BYTES : 0;
  static constexpr int SMEM = 1024 + RING + QBYTES + WIDE;  // + the ring's 1024-byte alignment
};

struct Params {
  CUtensorMap tm_k, tm_v;  // this layer's pools as [n_kv * P * ps, row]
  const __nv_bfloat16* q;  // [tokens, n_q, HD]
  __nv_bfloat16* out;
  const int* bt;           // [B or R, max_pages]
  const int* cached_lens;  // [B or R]
  const int* new_lens;
  const int* row_of;       // C: [R * tq], packed token of segment position
  const float* k_scales;   // quantized: this layer's [n_kv, P]
  const float* v_scales;
  int s, n_q, n_kv, num_pages, page_size, max_pages;  // s: A's window S, C's tq
  float scale;
};

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ uint32_t bf2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Codes widened to bf16 exactly, four instructions a pair.  `p` holds two
// bytes of a raw row in the low bytes of its 16-bit halves (__byte_perm
// with 0x4140: bytes 0, 1; 0x4342: bytes 2, 3).
// int8 code x: 0x4300 | (x & 127) is the bf16 128 + (x & 127); adding -128
// (bit 7 clear) or -256 (set: 0xC300 ^ 0x80) leaves x, and every sum is exact.
__device__ __forceinline__ uint32_t i8_pair(uint32_t p) {
  return bf2_add((p & 0x007F007Fu) ^ 0x43004300u, (p & 0x00800080u) ^ 0xC300C300u);
}
// int4 nibble n (bits 0-3): 128 + (n ^ 8) less 136 is the sign-extended
// two's-complement value ((n ^ 8) - 8), as common.cuh's PoolRow<uint8_t>
__device__ __forceinline__ uint32_t i4_pair(uint32_t p) {
  return bf2_add((p & 0x000F000Fu) ^ 0x43084308u, 0xC308C308u);
}

// 16 codes (int8) or 32 nibbles (int4) of a raw row's 16-byte chunk, widened
// into the bf16 tile at `dst` (the byte offset of the chunk's first 16 bf16
// bytes; the next 16 are 16 bytes on, XORed in the swizzle) and, for int4's
// high nibbles (components + HD / 2), at `dst_hi`
template <typename P>
__device__ __forceinline__ void widen_chunk(uint4 w, uint8_t* dst, uint8_t* dst_hi) {
  const uint32_t in[4] = {w.x, w.y, w.z, w.w};
  uint32_t lo[8], hi[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t p01 = __byte_perm(in[k], 0u, 0x4140), p23 = __byte_perm(in[k], 0u, 0x4342);
    if constexpr (std::is_same<P, int8_t>::value) {  // component 16 ch + k is byte k
      lo[2 * k] = i8_pair(p01);
      lo[2 * k + 1] = i8_pair(p23);
    } else {  // byte k: component 16 ch + k (low nibble), + HD / 2 (high)
      lo[2 * k] = i4_pair(p01);
      lo[2 * k + 1] = i4_pair(p23);
      hi[2 * k] = i4_pair(p01 >> 4);
      hi[2 * k + 1] = i4_pair(p23 >> 4);
    }
  }
  const uint32_t d = hopper::smem_addr(dst);
  *reinterpret_cast<uint4*>(dst) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  *reinterpret_cast<uint4*>(dst + ((d ^ 16) - d)) = make_uint4(lo[4], lo[5], lo[6], lo[7]);
  if constexpr (std::is_same<P, uint8_t>::value) {
    const uint32_t e = hopper::smem_addr(dst_hi);
    *reinterpret_cast<uint4*>(dst_hi) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(dst_hi + ((e ^ 16) - e)) = make_uint4(hi[4], hi[5], hi[6], hi[7]);
  }
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; -1e30 gives 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// PACKED: kernel C (segment z, tokens through row_of, tiles past the
// segment's rows exit); else kernel A (batch row z, token z * S + t)
template <typename P, int HD, bool PACKED>
__global__ void __launch_bounds__(THREADS, 1) prefill_kernel(const __grid_constant__ Params p) {
  using C = Cfg<P, HD>;
  using Raw = typename C::Raw;
  using Wide = typename C::Wide;
  constexpr int STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES], empty_bar[STAGES];
  __shared__ __align__(8) uint64_t wfull_bar[WIDE_STAGES], wempty_bar[WIDE_STAGES];
  __shared__ float stage_sc[STAGES][2][PAGES_MAX];     // quantized: the stage's pages' K, V scales
  __shared__ float wide_sc[WIDE_STAGES][2][PAGES_MAX];  // the same, beside each bf16 stage

  const int tid = threadIdx.x, wg = tid / WG;
  const int kvh = blockIdx.y, z = blockIdx.z;
  const int group = p.n_q / p.n_kv;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * ROWS;  // longest causal walk first
  const int new_len = p.new_lens[z];
  const int rows_total = group * (PACKED ? new_len : p.s);
  if (r0 >= rows_total) return;  // C: past the segment's real tokens
  const int cached = p.cached_lens[z];
  const int total = cached + new_len;
  const int ps = p.page_size;
  const int t_first = r0 / group, t_last = (min(r0 + ROWS, rows_total) - 1) / group;
  // keys past the table's pages do not exist
  const int kv_end = min(min(total, cached + t_last + 1), p.max_pages * ps);
  const int full_end = min(kv_end, cached + t_first + 1);  // keys every row of the block sees
  const int n_tiles = (kv_end + KT - 1) / KT;
  const int* row_of = PACKED ? p.row_of + (size_t)z * p.s : nullptr;
  auto tok = [&](int t) { return PACKED ? row_of[t] : z * p.s + t; };

  uint8_t* ring = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* qs = ring + C::RING;  // [2 warpgroups][HD / 64 boxes][64 rows][128 bytes], swizzled
  uint8_t* wide = qs + C::QBYTES;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full_bar[s], 1);
      // a raw stage is released by every consumer warp, or by the converter warps
      hopper::mbar_init(&empty_bar[s], C::QUANT ? CONVERTER_WARPS : 8);
    }
    for (int s = 0; s < WIDE_STAGES; ++s) {
      hopper::mbar_init(&wfull_bar[s], CONVERTER_WARPS);
      hopper::mbar_init(&wempty_bar[s], 8);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg < LOADER_WGS) {
    // --------------------------------------------------- loader warpgroup --
    hopper::setmaxnreg_dec<LOADER_REGS>();
    if (tid < 32) {  // warp 0: the TMA producer (lane 0); its lanes read the table
      const int lane = tid;
      const int* bt = p.bt + (size_t)z * p.max_pages;
      const int page0 = kvh * p.num_pages;  // this kv head's first page in the 2-D maps
      const int n_pages = (kv_end + ps - 1) / ps;
      constexpr int BOX = Raw::SPAN / (int)sizeof(P);  // box width in elements
      // lane l holds table entry 32 * chunk + l and its page's scales: each
      // read once, 32 at a time (a stage's pages never straddle two chunks)
      int chunk = -1, pg_l = 0;
      float ks_l = 0.f, vs_l = 0.f;
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES, k0 = t * KT;
        const int pi0 = k0 / ps;
        const int cnt = ps >= KT ? 1 : min(KT / ps, n_pages - pi0);  // pages of this stage
        if (pi0 / 32 != chunk) {
          chunk = pi0 / 32;
          const int idx = 32 * chunk + lane;
          pg_l = idx < n_pages ? bt[idx] : 0;
          if constexpr (C::QUANT) {
            ks_l = idx < n_pages ? p.k_scales[(size_t)page0 + pg_l] : 0.f;
            vs_l = idx < n_pages ? p.v_scales[(size_t)page0 + pg_l] : 0.f;
          }
        }
        int pages[PAGES_MAX];
        float kj[PAGES_MAX], vj[PAGES_MAX];
#pragma unroll
        for (int j = 0; j < PAGES_MAX; ++j) {
          pages[j] = __shfl_sync(0xffffffffu, pg_l, (pi0 + j) % 32);
          if constexpr (C::QUANT) {
            kj[j] = __shfl_sync(0xffffffffu, ks_l, (pi0 + j) % 32);
            vj[j] = __shfl_sync(0xffffffffu, vs_l, (pi0 + j) % 32);
          }
        }
        if (lane == 0) {
          hopper::mbar_wait(&empty_bar[st], ((t / STAGES) & 1) ^ 1);
          if constexpr (C::QUANT) {
            // written before the arrival that publishes the stage; 0 past
            // the walk's pages, whose keys get p = 0 (a stale scale could be NaN)
#pragma unroll
            for (int j = 0; j < PAGES_MAX; ++j) {
              stage_sc[st][0][j] = j < cnt ? kj[j] : 0.f;
              stage_sc[st][1][j] = j < cnt ? vj[j] : 0.f;
            }
          }
          uint8_t* kt = ring + st * 2 * Raw::BYTES;
          uint8_t* vt = kt + Raw::BYTES;
          uint64_t* bar = &full_bar[st];
          if (ps >= KT) {
            const int row = (page0 + pages[0]) * ps + k0 % ps;
            hopper::mbar_expect_tx(bar, 2 * Raw::BYTES);
#pragma unroll
            for (int bx = 0; bx < Raw::BOXES; ++bx) {
              hopper::tma_load_2d(kt + bx * KT * Raw::SPAN, &p.tm_k, bar, bx * BOX, row);
              hopper::tma_load_2d(vt + bx * KT * Raw::SPAN, &p.tm_v, bar, bx * BOX, row);
            }
          } else {
            hopper::mbar_expect_tx(bar, 2 * cnt * ps * Raw::ROW);
            for (int j = 0; j < cnt; ++j) {
              const int row = (page0 + pages[j]) * ps;
#pragma unroll
              for (int bx = 0; bx < Raw::BOXES; ++bx) {
                const int dst = bx * KT * Raw::SPAN + j * ps * Raw::SPAN;
                hopper::tma_load_2d(kt + dst, &p.tm_k, bar, bx * BOX, row);
                hopper::tma_load_2d(vt + dst, &p.tm_v, bar, bx * BOX, row);
              }
            }
          }
        }
        __syncwarp();
      }
    } else if (C::QUANT && tid >= 32) {  // the converters: raw stages into bf16 stages
      const int cv = tid - 32, lane = tid % 32;
      constexpr int CH = Raw::ROW / 16;  // 16-byte chunks of a raw row
      constexpr int N_CH = 2 * KT * CH;  // of a stage's K and V
      constexpr int NT = 32 * CONVERTER_WARPS;
      constexpr int PER = (N_CH + NT - 1) / NT;  // chunks a thread
      // This thread's chunks are the same in every stage: raw chunk i = cv +
      // u * NT, its byte offset in the raw stage (low 16 bits) and its first
      // bf16 chunk's in the bf16 stage (high 16 bits).  Rows past the walk's
      // end are widened too: any code is finite, and those keys' p is 0.
      uint32_t where[PER];
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int i = min(cv + u * NT, N_CH - 1), kv = i / (KT * CH), r = (i / CH) % KT,
                  ch = i % CH;
        where[u] = (kv * Raw::BYTES + Raw::off(r, 16 * ch)) |
                   ((kv * Wide::BYTES + Wide::off(r, 32 * ch)) << 16);
      }
      // int4: the high nibbles' bf16 chunk (component + HD / 2)
      constexpr int HI = HD == 128 ? 64 * 128 : 0;  // the next 128-byte box, or 64 bytes on
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES, ws = t % WIDE_STAGES;
        hopper::mbar_wait(&full_bar[st], (t / STAGES) & 1);
        hopper::mbar_wait(&wempty_bar[ws], ((t / WIDE_STAGES) & 1) ^ 1);
        const uint8_t* kraw = ring + st * 2 * Raw::BYTES;
        uint8_t* wk = wide + ws * 2 * Wide::BYTES;
        uint4 w[PER];
#pragma unroll
        for (int u = 0; u < PER; ++u)
          if (u < PER - 1 || cv + u * NT < N_CH)
            w[u] = *reinterpret_cast<const uint4*>(kraw + (where[u] & 0xFFFF));
#pragma unroll
        for (int u = 0; u < PER; ++u) {
          if (u < PER - 1 || cv + u * NT < N_CH) {
            uint8_t* dst = wk + (where[u] >> 16);
            uint8_t* dst_hi = HD == 128 ? dst + HI : wk + (((where[u] >> 16)) ^ 64);
            widen_chunk<P>(w[u], dst, dst_hi);
          }
        }
        if (cv < 2 * PAGES_MAX)
          wide_sc[ws][cv / PAGES_MAX][cv % PAGES_MAX] = stage_sc[st][cv / PAGES_MAX][cv % PAGES_MAX];
        hopper::fence_proxy_async();  // the bf16 stage is read by wgmma
        __syncwarp();
        if (lane == 0) {
          hopper::mbar_arrive(&empty_bar[st]);  // the raw stage is free
          hopper::mbar_arrive(&wfull_bar[ws]);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers --
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - LOADER_WGS;                      // rows 64 cw .. of the block
  const int ct = tid - LOADER_WGS * WG, wt = ct % WG;  // thread among both / this warpgroup
  const int warp = wt / 32, lane = tid % 32, g = lane >> 2, c = lane & 3;

  // this warpgroup's 64 q rows into shared memory as wgmma's K-major A
  // operand (64-element boxes, 128-byte swizzle), zeros past rows_total
  uint8_t* qw = qs + cw * 64 * 2 * HD;
  for (int i = wt; i < 64 * (HD / 8); i += WG) {
    const int r = i / (HD / 8), ch = i % (HD / 8);
    const int rr = r0 + 64 * cw + r;
    const __nv_bfloat16* src = p.q;
    if (rr < rows_total)
      src = p.q + ((size_t)tok(rr / group) * p.n_q + kvh * group + rr % group) * HD + 8 * ch;
    hopper::cp_async16(qw + (ch / 8) * 64 * 128 + r * 128 + (((ch % 8) ^ (r & 7)) << 4), src,
                       rr < rows_total ? 16 : 0);
  }
  hopper::cp_async_wait_all();
  hopper::fence_proxy_async();
  bar_sync(2 + cw, WG);
  // this thread's rows rw, rw + 8 of the warpgroup's 64
  const int rw = 16 * warp + g;
  const int rr0 = r0 + 64 * cw + rw, rr1 = rr0 + 8;
  // each row's last visible key position; -1: a row past rows_total sees none
  const int qp0 = rr0 < rows_total ? cached + rr0 / group : -1;
  const int qp1 = rr1 < rows_total ? cached + rr1 / group : -1;
  // key k of a stage lies on its page k >> sh (one page a stage when ps >= KT)
  const int sh = ps >= KT ? 6 : __ffs(ps) - 1;
  const float sl2 = p.scale * LOG2E;

  // stage t's key and value tiles, the barrier that frees it, and its keys'
  // score and value scales (per n tile j: keys 8j .. 8j + 7)
  struct Stage {
    const uint8_t *kt, *vt;
    uint64_t* release;
    float ksc[8], vsc[8];
  };
  auto acquire = [&](int t, Stage& sg) {
    const int valid = min(KT, kv_end - t * KT);  // keys of this stage before the walk's end
    if constexpr (C::QUANT) {
      const int ws = t % WIDE_STAGES;
      hopper::mbar_wait(&wfull_bar[ws], (t / WIDE_STAGES) & 1);
      sg.kt = wide + ws * 2 * Wide::BYTES;
      sg.vt = sg.kt + Wide::BYTES;
      sg.release = &wempty_bar[ws];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int pg = sh >= 6 ? 0 : (8 * j) >> sh;
        sg.ksc[j] = sl2 * wide_sc[ws][0][pg];
        sg.vsc[j] = wide_sc[ws][1][pg];
      }
    } else {
      const int st = t % STAGES;
      hopper::mbar_wait(&full_bar[st], (t / STAGES) & 1);
      sg.kt = ring + st * 2 * Raw::BYTES;
      sg.vt = sg.kt + Raw::BYTES;
      sg.release = &empty_bar[st];
      if (valid < KT) {  // the walk's last stage: zero V's rows past its end
        uint8_t* v = ring + st * 2 * Raw::BYTES + Raw::BYTES;
        constexpr int CH = Raw::SPAN / 16;
        for (int i = ct; i < (KT - valid) * Raw::BOXES * CH; i += 2 * WG) {
          const int r = valid + i / (Raw::BOXES * CH), bx = (i / CH) % Raw::BOXES, ch = i % CH;
          *reinterpret_cast<uint4*>(v + bx * KT * Raw::SPAN + r * Raw::SPAN + ch * 16) =
              make_uint4(0u, 0u, 0u, 0u);
        }
        hopper::fence_proxy_async();
        bar_sync(1, 2 * WG);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) sg.ksc[j] = sl2, sg.vsc[j] = 1.f;
    }
  };

  float o[HD / 2];  // m64nHD accumulator: n tile j holds head dims 8j + 2c, + 1
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float a0 = 1.f, a1 = 1.f;  // the last softmax's rescale of o
  float s[32];               // scores, then p, of the current stage
  uint32_t ph[4][4], pl[4][4];  // the last stage's P as A fragments, hi and lo
  Stage cur, prev;

  // S = Q K^T over a stage's 64 keys, both operands from shared memory
  auto issue_s = [&](const Stage& sg) {
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const int off = (ks / 4) * 64 * 128;
      hopper::wgmma_ss_64(s, hopper::desc_k_sw128(qw + off, (ks % 4) * 32),
                          hopper::desc_k_sw128(sg.kt + off, (ks % 4) * 32), ks > 0);
    }
    hopper::wgmma_commit();
  };
  // O += P V over the last stage's 64 keys, p_hi then p_lo
  auto issue_pv = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = hopper::desc_mn_sw128(prev.vt + kk * 16 * 128, KT * 128);
      hopper::wgmma_rs_tb<HD>(o, ph[kk], dv);
      hopper::wgmma_rs_tb<HD>(o, pl[kk], dv);
    }
    hopper::wgmma_commit();
  };
  // before a turn's wgmmas: every register they read is written
  auto prepare = [&]() {
    hopper::fence_regs<32>(s);
    hopper::fence_regs<HD / 2>(o);
    hopper::wgmma_fence();
  };
  // the online softmax of stage t's scores, in the log2 domain:
  // s[4j + e] is row rw (e < 2) or rw + 8 at key k0 + 8j + 2c + (e & 1),
  // visible below lim, and masked p is 0 by a select, whatever the max.
  // Only a stage that reaches past the block's first row's bound masks.
  auto softmax = [&](int t, const Stage& sg, auto mask) {
    constexpr bool MASK = decltype(mask)::value;
    hopper::fence_regs<32>(s);
    const int k0 = t * KT;
    const int lim0 = min(qp0 + 1, kv_end) - k0 - 2 * c, lim1 = min(qp1 + 1, kv_end) - k0 - 2 * c;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = !MASK || 8 * j + (e & 1) < (e < 2 ? lim0 : lim1);
        const float x = ok ? s[4 * j + e] * sg.ksc[j] : NEG_INF;
        s[4 * j + e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    a0 = ex2(m0 - mn0);
    a1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = !MASK || 8 * j + (e & 1) < (e < 2 ? lim0 : lim1);
        const float pv = ok ? ex2(s[4 * j + e] - (e < 2 ? mn0 : mn1)) : 0.f;
        if (e < 2) ps0 += pv;
        else ps1 += pv;
        s[4 * j + e] = pv * sg.vsc[j];  // the V scale rides p (quantized pools)
      }
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
  };
  auto softmax_of = [&](int t, const Stage& sg) {
    if (t * KT + KT > full_end) softmax(t, sg, std::true_type{});
    else softmax(t, sg, std::false_type{});
  };
  // P V(t - 1) retires: its stage is freed; then stage t's P becomes the
  // A fragments: register f of k step kk (keys 16kk ..) is S's pair
  // 8kk + 2f: (row rw, n tile 2kk), (rw + 8, 2kk), (rw, 2kk + 1), (rw + 8, 2kk + 1)
  auto retire_and_build_p = [&](bool release_prev) {
    hopper::wgmma_wait<0>();
    hopper::fence_regs<HD / 2>(o);
    hopper::fence_regs<32>(s);
    if (release_prev) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(prev.release);
    }
    // o to stage t's running max, unless no row of the warp's moved (most
    // stages of a long walk)
    if (__any_sync(0xffffffffu, a0 != 1.f || a1 != 1.f)) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        decode::split_bf16(s[8 * kk + 2 * f], s[8 * kk + 2 * f + 1], ph[kk][f], pl[kk][f]);
    hopper::fence_regs<16>(&ph[0][0]);
    hopper::fence_regs<16>(&pl[0][0]);
  };

  // Ping-pong: the two warpgroups take turns on the tensor cores.  A turn
  // issues S(t) and P V(t - 1) back to back and hands over; the softmax of
  // t then runs on the CUDA cores while the other warpgroup's turn runs.
  // The first turn issues S(0) only, a last one P V(n_tiles - 1) only, so
  // no branch lies between a wgmma's issue and its wait.  Warpgroup 1
  // hands warpgroup 0 its first turn and does not hand over after its last.
  if (n_tiles > 0) {
    const int my_turn = 4 + cw, other_turn = 5 - cw;
    if (cw == 1) bar_arrive(4, 2 * WG);
    acquire(0, cur);
    bar_sync(my_turn, 2 * WG);
    prepare();
    issue_s(cur);
    bar_arrive(other_turn, 2 * WG);
    hopper::wgmma_wait<0>();
    softmax_of(0, cur);
    retire_and_build_p(false);
    prev = cur;
    for (int t = 1; t < n_tiles; ++t) {
      acquire(t, cur);
      bar_sync(my_turn, 2 * WG);
      prepare();
      issue_s(cur);
      issue_pv();
      bar_arrive(other_turn, 2 * WG);
      hopper::wgmma_wait<1>();  // S(t) has retired; P V(t - 1) may run on
      softmax_of(t, cur);
      retire_and_build_p(true);
      prev = cur;
    }
    bar_sync(my_turn, 2 * WG);
    prepare();
    issue_pv();
    if (cw == 0) bar_arrive(other_turn, 2 * WG);
    hopper::wgmma_wait<0>();
    hopper::fence_regs<HD / 2>(o);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(prev.release);
  }

  // the quad's partial sums of l, then acc / l (0 for a row with no key)
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = h ? rr1 : rr0;
    if (rr >= rows_total) continue;
    const float l = h ? l1 : l0;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat16* dst =
        p.out + ((size_t)tok(rr / group) * p.n_q + kvh * group + rr % group) * HD + 2 * c;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          decode::bf16x2(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
  }
}

// ---------------------------------------------------------------- host --

struct Launch {
  const void *q, *k_pages, *v_pages;
  void* out;
  const int *bt, *cached_lens, *new_lens, *row_of;
  const float *k_scales, *v_scales;
  int batch, s, n_q, n_kv, num_pages, page_size, max_pages;  // batch: A's B, C's R
  float scale;
};

// what ops/fused_decode._plan_window refuses, checked again here
inline bool plan_ok(const Launch& a) {
  const int ps = a.page_size;
  return ps > 0 && (ps % KT == 0 || (KT % ps == 0 && ps % 8 == 0)) && a.n_kv > 0 &&
         a.n_q % a.n_kv == 0 && a.s > 0;
}

template <typename P, int HD, bool PACKED>
int launch(const Launch& a, cudaStream_t stream) {
  using C = Cfg<P, HD>;
  using Raw = typename C::Raw;
  if (!plan_ok(a)) return (int)cudaErrorInvalidValue;
  if (a.batch == 0) return 0;
  Params p;
  const uint64_t rows = (uint64_t)a.n_kv * a.num_pages * a.page_size;
  const uint32_t box_rows = a.page_size < KT ? a.page_size : KT;
  const CUtensorMapSwizzle swz = Raw::SPAN == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : Raw::SPAN == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  constexpr int ELEMS = Raw::ROW / (int)sizeof(P);  // a raw row's elements
  if (!hopper::encode_2d(&p.tm_k, decode::tma_dtype<P>(), a.k_pages, ELEMS, rows, Raw::ROW,
                         Raw::SPAN / sizeof(P), box_rows, swz) ||
      !hopper::encode_2d(&p.tm_v, decode::tma_dtype<P>(), a.v_pages, ELEMS, rows, Raw::ROW,
                         Raw::SPAN / sizeof(P), box_rows, swz))
    return (int)cudaErrorInvalidValue;
  p.q = static_cast<const __nv_bfloat16*>(a.q);
  p.out = static_cast<__nv_bfloat16*>(a.out);
  p.bt = a.bt;
  p.cached_lens = a.cached_lens;
  p.new_lens = a.new_lens;
  p.row_of = a.row_of;
  p.k_scales = a.k_scales;
  p.v_scales = a.v_scales;
  p.s = a.s;
  p.n_q = a.n_q;
  p.n_kv = a.n_kv;
  p.num_pages = a.num_pages;
  p.page_size = a.page_size;
  p.max_pages = a.max_pages;
  p.scale = a.scale;
  auto kernel = prefill_kernel<P, HD, PACKED>;
  static bool sized = false;  // one per instance
  if (!sized) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const int row_tiles = ((a.n_q / a.n_kv) * a.s + ROWS - 1) / ROWS;
  kernel<<<dim3(row_tiles, a.n_kv, a.batch), THREADS, C::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace prefill
}  // namespace port
