// Block bodies and host launch of the decode attention kernels B
// (paged_decode_staged.cu) and F (paged_decode.cu): split-K over pages
// (flash-decoding) on Hopper.
//
// One decode query per row and its GQA group of n_q / n_kv <= 8 queries
// attend to the row's first n_keys keys of one kv head's pages, in one
// kernel, grid (n_splits (+ 1 for B), n_kv, B):
//
// Block s of (row b, kv head h) takes
//   the row's pages [s * pps, (s + 1) * pps) (pps, n_splits: the wrapper's
//   plan, ops/paged_decode._plan_decode, from static shapes only) and writes
//   the online-softmax partial (m, l, acc[group][HD]) of its keys,
//   unnormalised, to a workspace.  A split that starts at or past the row's
//   last key writes l = 0 and does nothing else.  Its 4 warps each own 16
//   keys of every 64-key tile.  Tiles arrive through a 2-stage ring
//   filled by TMA (cp.async.bulk.tensor on an mbarrier) from 2-D tensor maps
//   over the layer's K and V pools ([rows, HD], one page = ps consecutive
//   rows): one box per page (ps < 64) or per 64-row piece of a page (ps >=
//   64) and per 128 bytes of a key row, read straight in the pool's dtype.
//   The boxes land in the 128-byte (64-byte for int8 at HD 64) swizzle, so
//   the ldmatrix reads below hit 8 distinct bank groups: a plain row-major
//   tile (rows 256 bytes apart) would put all 8 rows of an ldmatrix phase in
//   one.  The block table is read once per page, into shared memory, beside
//   the row's length, then the int8 page scales.
//   bf16 queries (bf16 or int8 pools): both products on the tensor cores,
//   mma.sync.m16n8k16 bf16 -> f32, fed by ldmatrix: S = Q K^T with the
//   group's queries as rows 0-7 of the 16-row A tile (rows 8-15 zero), K
//   as the B operand; then O += P V with P from S's accumulator registers
//   (the C fragment of m16n8 is the A fragment of m16k16) and V through
//   ldmatrix.trans.  P stays at f32 precision: it enters as two bf16 terms,
//   p_hi = bf16(p) and p_lo = bf16(p - p_hi), two mmas.  int8 codes are exact
//   in bf16 (made from the bytes with full-rate integer and f32 adds, not
//   the quarter-rate I2F): S runs on the codes and its f32 scores take the
//   page's K scale; the V scale folds into P in f32 before the split.  (The
//   int8 fragments come from ldmatrix of byte pairs: S reads each thread's
//   4 codes as the d order 4c..4c+3 of a 16-wide k step, the Q fragment
//   takes the same order; P V's n tiles hold the even and the odd d of a
//   16-wide block.)
//   f32 queries (f32 or int8 pools): the same pipeline with the inner
//   products on the CUDA cores, the pool's values dequantized as the plain
//   version dequantizes them.
//   The 4 warps' states merge through shared memory into the block's
//   partial.  For B one more block a row (x = n_splits) makes the burst's
//   staged tail (< staged_len keys in the activation dtype) a partial too.
//   Then each block counts itself in on its (row, kv head)'s counter; the
//   last to arrive merges the row's partials (their (m, l) into shared
//   memory, weights exp(m - M), 0 for l == 0, then every output element's
//   weighted sum with no dependence between its loads), writes acc / l, or
//   0 for a row with no key, and sets the counter back to 0 for the next
//   launch.  So one launch does it all, with no second kernel's launch and
//   drain between the splits and their merge.
//
// Masked scores are -1e30 and their p is set to 0 by a select, so a tile or
// split with no valid key adds nothing to l.  Rows of the last tile past the
// row's end are never read from the table (entries past a row's pages may be
// anything); their V rows are zeroed before P V, so stale or unwritten
// shared memory cannot reach the output as 0 * NaN.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace port {
namespace decode {

constexpr int KT = 64;                   // keys per tile (ring stage)
constexpr int NW = 4;                    // warps per split block, 16 keys of a tile each
constexpr int SPLIT_THREADS = 32 * NW;
constexpr int GMAX = 8;                  // largest GQA group: rows 0-7 of the query tile
constexpr int PPS_MAX = 128;             // pages per split (the plan's most: 1024 keys of 8)

// One K or V tile of KT key rows of HD elements P in shared memory, as the
// TMA boxes write it: BOXES column boxes of SPAN bytes a row, box-major,
// each in the SPAN-byte swizzle (16-byte chunk index XOR address bits 7..).
template <typename P, int HD>
struct Tile {
  static constexpr int ROW = HD * (int)sizeof(P);
  static constexpr int SPAN = ROW < 128 ? ROW : 128;
  static constexpr int BOXES = ROW / SPAN;
  static constexpr int BYTES = KT * ROW;
  static constexpr int STAGES = 2;  // 3 or 4 stages measured no faster on the card
  static constexpr int RING = STAGES * 2 * BYTES;
  static constexpr int SMEM = RING + 1024;  // + the 1024-byte alignment of the ring
  // byte offset of byte `b` of key row `r`
  __device__ static __forceinline__ int off(int r, int b) {
    const int bb = b % SPAN;
    const int swz = ((r * SPAN) >> 7) & (SPAN / 16 - 1);
    return (b / SPAN) * KT * SPAN + r * SPAN + (((bb >> 4) ^ swz) << 4) + (bb & 15);
  }
};

struct SplitParams {
  CUtensorMap tm_k, tm_v;  // this layer's pools as [n_kv * P * ps, HD]
  const void* q;           // [B, n_q, HD]
  const int* bt;           // [B, max_pages]
  const int* lens;         // [B]: pool_lens (B) or cached_lens (F)
  const int* new_lens;     // F: [B], added to lens; B: nullptr
  const float* k_scales;   // int8: this layer's [n_kv, P]
  const float* v_scales;
  float* ws;               // [B, n_kv, parts of a row] x GMAX x (m, l), then x GMAX x HD
  int* counters;           // [B, n_kv] split blocks arrived, 0 between launches
  const void* staged_k;    // B: [B, n_kv, n_steps, HD] in q's dtype
  const void* staged_v;
  void* out;               // [B, n_q, HD] in q's dtype
  int n_q, n_kv, num_pages, page_size, max_pages, pps, n_splits, n_steps, staged_len;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// the int8 bytes `i` and `j` of w as a bf16 pair, exactly, on the full-rate
// pipes (I2F runs at a quarter of their rate): with wx = w ^ 0x80808080, byte
// u = x + 128 placed in the mantissa of 2^23 gives the f32 2^23 + u, and
// subtracting 2^23 + 128 leaves x, whose 8 significant bits are its bf16
// bits' upper half
__device__ __forceinline__ uint32_t i8_bf16x2(uint32_t wx, int i, int j) {
  const float fi = __uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7440 | i)) - 8388736.f;
  const float fj = __uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7440 | j)) - 8388736.f;
  return __byte_perm(__float_as_uint(fi), __float_as_uint(fj), 0x7632);
}

// p as two bf16 pairs whose sum carries p to ~2^-16 of itself
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = bf16x2(p0 - f.x, p1 - f.y);
}

// Per-warp partial of the tensor-core path: query g = lane / 4 of the
// group, keys of lane % 4's columns.  acc[n] is n tile n of O (16 x 8; its
// rows 8-15 are the zero query rows).
template <bool I8, int HD>
struct MmaState {
  static constexpr int NT = HD / 8;
  uint32_t qa[HD / 16][2];  // Q's A fragment per k step (a0, a2; a1 = a3 = 0)
  float acc[NT][4];
  float m, lsum;

  __device__ void init(const __nv_bfloat16* qrow, bool live, int c) {
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      // bf16 pools: k columns 2c, 2c + 1 -> d 16ks + 2c, +1; 2c + 8 -> +8.
      // int8: the 4 codes 4c..4c+3 of a k step's 16 -> columns 2c, 2c+1, 2c+8, 2c+9
      const int d0 = I8 ? 16 * ks + 4 * c : 16 * ks + 2 * c;
      const int d1 = I8 ? d0 + 2 : d0 + 8;
      qa[ks][0] = live ? *reinterpret_cast<const uint32_t*>(qrow + d0) : 0u;
      qa[ks][1] = live ? *reinterpret_cast<const uint32_t*>(qrow + d1) : 0u;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    m = NEG_INF;
    lsum = 0.f;
  }

  // d of O's C-fragment column `col` (0..7) of n tile n
  __device__ static __forceinline__ int d_of(int n, int col) {
    return I8 ? 16 * (n / 2) + 2 * col + (n % 2) : 8 * n + col;
  }
};

// kmul / vmul: the int8 page scales of the tile's first page on; key k of
// the tile takes entry k >> sh
template <typename P, int HD, bool QUANT>
__device__ __forceinline__ void mma_tile(MmaState<QUANT, HD>& st, const uint8_t* kt,
                                         const uint8_t* vt, int warp, int lane, int valid,
                                         const float* kmul, const float* vmul, int sh,
                                         float scale) {
  using Tl = Tile<P, HD>;
  const int c = lane & 3;
  const int kr = 16 * warp + (lane >> 4) * 8 + (lane & 7);         // S: B fragment rows
  const int vr = 16 * warp + ((lane >> 3) & 1) * 8 + (lane & 7);   // P V: .trans rows
  float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  if constexpr (!QUANT) {
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t r[4];
      hopper::ldmatrix_x4(r, kt + Tl::off(kr, 16 * (2 * ks + ((lane >> 3) & 1))));
      const uint32_t a[4] = {st.qa[ks][0], 0u, st.qa[ks][1], 0u};
      hopper::mma_bf16_16816(s[0], a, r[0], r[1]);
      hopper::mma_bf16_16816(s[1], a, r[2], r[3]);
    }
  } else {
    // the two k steps of a pair accumulate apart: the conversions lengthen
    // each step, and two chains of dependent mmas halve the tile's wait
    float s2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kp = 0; kp < HD / 32; ++kp) {
      uint32_t r[4];  // (keys 0-7, k step 2kp), (0-7, 2kp+1), (8-15, 2kp), (8-15, 2kp+1)
      hopper::ldmatrix_x4(r, kt + Tl::off(kr, 16 * (2 * kp + ((lane >> 3) & 1))));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t a[4] = {st.qa[2 * kp + h][0], 0u, st.qa[2 * kp + h][1], 0u};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const uint32_t w = r[2 * nt + h] ^ 0x80808080u;
          hopper::mma_bf16_16816(h ? s2[nt] : s[nt], a, i8_bf16x2(w, 0, 1), i8_bf16x2(w, 2, 3));
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] += s2[nt][e];
  }

  // scores of query g at local keys 2c, 2c+1 (n tile 0) and 8+2c, 9+2c (1)
  float sc[4], p[4];
  float mx = NEG_INF;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = 16 * warp + (i >> 1) * 8 + 2 * c + (i & 1);
    const float raw = s[i >> 1][i & 1] * scale * (QUANT ? kmul[key >> sh] : 1.f);
    sc[i] = key < valid ? raw : NEG_INF;
    mx = fmaxf(mx, sc[i]);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float mn = fmaxf(st.m, mx);
  const float alpha = expf(st.m - mn);
  float psum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = 16 * warp + (i >> 1) * 8 + 2 * c + (i & 1);
    p[i] = key < valid ? expf(sc[i] - mn) : 0.f;
    psum += p[i];
    if (QUANT) p[i] *= vmul[key >> sh];
  }
  st.lsum = st.lsum * alpha + psum;
  st.m = mn;
#pragma unroll
  for (int n = 0; n < MmaState<QUANT, HD>::NT; ++n) {
    st.acc[n][0] *= alpha;
    st.acc[n][1] *= alpha;
  }
  uint32_t hi[4] = {0u, 0u, 0u, 0u}, lo[4] = {0u, 0u, 0u, 0u};
  split_bf16(p[0], p[1], hi[0], lo[0]);
  split_bf16(p[2], p[3], hi[2], lo[2]);

  if constexpr (!QUANT) {
#pragma unroll
    for (int jj = 0; jj < HD / 16; ++jj) {
      uint32_t r[4];  // b0, b1 of n tile 2jj, then of 2jj + 1
      hopper::ldmatrix_x4_trans(r, vt + Tl::off(vr, 16 * (2 * jj + (lane >> 4))));
      hopper::mma_bf16_16816(st.acc[2 * jj], hi, r[0], r[1]);
      hopper::mma_bf16_16816(st.acc[2 * jj], lo, r[0], r[1]);
      hopper::mma_bf16_16816(st.acc[2 * jj + 1], hi, r[2], r[3]);
      hopper::mma_bf16_16816(st.acc[2 * jj + 1], lo, r[2], r[3]);
    }
  } else {
#pragma unroll
    for (int jp = 0; jp < HD / 32; ++jp) {
      uint32_t r[4];  // (keys 0-7, block 2jp), (8-15, 2jp), (0-7, 2jp+1), (8-15, 2jp+1)
      hopper::ldmatrix_x4_trans(r, vt + Tl::off(vr, 16 * (2 * jp + (lane >> 4))));
#pragma unroll
      for (int blk = 0; blk < 2; ++blk) {
        // bytes: (key 2c, d 2g), (2c, 2g+1), (2c+1, 2g), (2c+1, 2g+1)
        const uint32_t w0 = r[2 * blk] ^ 0x80808080u, w1 = r[2 * blk + 1] ^ 0x80808080u;
        const int n = 2 * (2 * jp + blk);
        const uint32_t e0 = i8_bf16x2(w0, 0, 2), e1 = i8_bf16x2(w1, 0, 2);
        const uint32_t o0 = i8_bf16x2(w0, 1, 3), o1 = i8_bf16x2(w1, 1, 3);
        hopper::mma_bf16_16816(st.acc[n], hi, e0, e1);
        hopper::mma_bf16_16816(st.acc[n], lo, e0, e1);
        hopper::mma_bf16_16816(st.acc[n + 1], hi, o0, o1);
        hopper::mma_bf16_16816(st.acc[n + 1], lo, o0, o1);
      }
    }
  }
}

// Per-warp partial of the CUDA-core path (f32 queries): lane owns key
// lane / 2 of the warp's 16 for queries q0..q0+3, q0 = 4 * (lane % 2), in
// S, and head dims lane + 32 j of all 8 queries in P V.
template <int HD>
struct FmaState {
  float acc[GMAX][HD / 32];
  float m[4], l[4];
  __device__ void init() {
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
#pragma unroll
      for (int j = 0; j < HD / 32; ++j) acc[g][j] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = NEG_INF, l[i] = 0.f;
  }
};

template <typename P, int HD, bool QUANT>
__device__ __forceinline__ void fma_tile(FmaState<HD>& st, const uint8_t* kt, const uint8_t* vt,
                                         const float (*qs)[HD], float (*ps)[16], float* al,
                                         int warp, int lane, int valid, const float* kmul,
                                         const float* vmul, int sh, float scale) {
  using Tl = Tile<P, HD>;
  const int kk = lane >> 1, q0 = 4 * (lane & 1);
  const int key = 16 * warp + kk;
  const float km = QUANT ? kmul[key >> sh] : 1.f;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    // dequantized as the plain version does: code * scale in f32
    const float kv =
        to_f32(*reinterpret_cast<const P*>(kt + Tl::off(key, d * (int)sizeof(P)))) * km;
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = fmaf(qs[q0 + i][d], kv, s[i]);
  }
  const bool ok = key < valid;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float sc = ok ? s[i] * scale : NEG_INF;
    float mx = sc;
    for (int o = 2; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float mn = fmaxf(st.m[i], mx);
    const float alpha = expf(st.m[i] - mn);
    const float p = ok ? expf(sc - mn) : 0.f;
    float sum = p;
    for (int o = 2; o < 32; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    st.l[i] = st.l[i] * alpha + sum;
    st.m[i] = mn;
    ps[q0 + i][kk] = p;
    if (kk == 0) al[q0 + i] = alpha;
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < HD / 32; ++j) {
    const int d = lane + 32 * j;
#pragma unroll
    for (int g = 0; g < GMAX; ++g) st.acc[g][j] *= al[g];
    for (int k2 = 0; k2 < 16; ++k2) {
      const int vk = 16 * warp + k2;
      const float v = to_f32(*reinterpret_cast<const P*>(vt + Tl::off(vk, d * (int)sizeof(P)))) *
                      (QUANT ? vmul[vk >> sh] : 1.f);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) st.acc[g][j] = fmaf(ps[g][k2], v, st.acc[g][j]);
    }
  }
  __syncwarp();
}

// B's staged tail as one more partial (block n_splits of the row): warp w
// takes queries w, w + 4, scores the < staged_len staged keys (activation
// dtype), and writes their unnormalised (m, l, acc) beside the page splits'.
template <typename T, int HD>
__device__ __forceinline__ void tail_partial(const SplitParams& p, int b, int kvh, int warp,
                                             int lane, float* ws_ml, float* ws_acc) {
  const int group = p.n_q / p.n_kv;
  const size_t base = ((size_t)b * p.n_kv + kvh) * p.n_steps * HD + lane;
  const T* sk = static_cast<const T*>(p.staged_k) + base;
  const T* sv = static_cast<const T*>(p.staged_v) + base;
  for (int g = warp; g < GMAX; g += NW) {
    if (g >= group) {
      if (lane == 0) ws_ml[2 * g] = NEG_INF, ws_ml[2 * g + 1] = 0.f;
      continue;
    }
    const T* q = static_cast<const T*>(p.q) + ((size_t)b * p.n_q + kvh * group + g) * HD + lane;
    float qv[HD / 32], acc[HD / 32];
#pragma unroll
    for (int j = 0; j < HD / 32; ++j) qv[j] = to_f32(q[32 * j]), acc[j] = 0.f;
    float m = NEG_INF, l = 0.f;
    for (int t = 0; t < p.staged_len; ++t) {
      float dot = 0.f, v[HD / 32];
#pragma unroll
      for (int j = 0; j < HD / 32; ++j) {
        dot = fmaf(qv[j], to_f32(sk[(size_t)t * HD + 32 * j]), dot);
        v[j] = to_f32(sv[(size_t)t * HD + 32 * j]);
      }
      const float sc = warp_sum(dot, 32) * p.scale;
      const float mn = fmaxf(m, sc), a = expf(m - mn), e = expf(sc - mn);
      l = l * a + e;
#pragma unroll
      for (int j = 0; j < HD / 32; ++j) acc[j] = acc[j] * a + e * v[j];
      m = mn;
    }
#pragma unroll
    for (int j = 0; j < HD / 32; ++j) ws_acc[g * HD + lane + 32 * j] = acc[j];
    if (lane == 0) ws_ml[2 * g] = m, ws_ml[2 * g + 1] = l;
  }
}

// The last block of a (row, kv head) to finish merges the row's n_parts
// partials: their (m, l) into shared memory, each query's max M and weights
// e = exp(m - M) (0 for a partial with l == 0), then every output element
// sums e * acc over the partials with no dependence between the loads, and
// writes acc / l (0 for a row with no key).  Partials are read past L1:
// other blocks wrote them.
template <typename T, int HD>
__device__ __forceinline__ void merge_row(const SplitParams& p, int b, int kvh, int n_parts,
                                          size_t parts, float* sm) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = p.n_q / p.n_kv;
  const size_t part0 = ((size_t)b * p.n_kv + kvh) * n_parts;
  float* e = sm;                                       // [n_parts][GMAX]
  float* inv = sm + n_parts * GMAX;                    // [GMAX]
  float2* ml = reinterpret_cast<float2*>(inv + GMAX);  // [n_parts][GMAX]
  for (int i = tid; i < n_parts * GMAX; i += SPLIT_THREADS)
    ml[i] = __ldcg(reinterpret_cast<const float2*>(p.ws + part0 * GMAX * 2) + i);
  __syncthreads();
  for (int g = warp; g < group; g += NW) {
    float mx = NEG_INF;
    for (int s = lane; s < n_parts; s += 32)
      if (ml[s * GMAX + g].y > 0.f) mx = fmaxf(mx, ml[s * GMAX + g].x);
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float l = 0.f;
    for (int s = lane; s < n_parts; s += 32) {
      const float2 v = ml[s * GMAX + g];
      const float w = v.y > 0.f ? expf(v.x - mx) : 0.f;
      e[s * GMAX + g] = w;
      l += w > 0.f ? w * v.y : 0.f;
    }
    l = warp_sum(l, 32);
    if (lane == 0) inv[g] = l > 0.f ? 1.f / l : 0.f;  // no key -> 0
  }
  __syncthreads();
  constexpr int PER = GMAX * HD / SPLIT_THREADS;  // outputs per thread
  const float* acc0 = p.ws + parts * GMAX * 2 + part0 * GMAX * HD;
  float a[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) a[k] = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_parts; ++s) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = tid + k * SPLIT_THREADS;  // (query i / HD, head dim i % HD)
      const float w = e[s * GMAX + i / HD];
      const float x = __ldcg(acc0 + (size_t)s * GMAX * HD + i);
      a[k] += w > 0.f ? w * x : 0.f;
    }
  }
  T* out = static_cast<T*>(p.out) + ((size_t)b * p.n_q + kvh * group) * HD;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * SPLIT_THREADS;
    if (i / HD < group) out[i] = from_float<T>(a[k] * inv[i / HD]);
  }
}

// T: q / out element type; P: pool element type (T or int8_t with
// scales); STAGED: kernel B's staged tail
template <typename T, typename P, int HD, bool QUANT, bool STAGED>
__global__ void __launch_bounds__(SPLIT_THREADS)
    split_kernel(const __grid_constant__ SplitParams p) {
  using Tl = Tile<P, HD>;
  constexpr bool TC = sizeof(T) == 2;  // bf16 queries: tensor cores
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[Tl::STAGES];
  __shared__ int pages[PPS_MAX];
  __shared__ float page_ks[QUANT ? PPS_MAX : 1], page_vs[QUANT ? PPS_MAX : 1];
  __shared__ __align__(16) float qs[TC ? 1 : GMAX][HD];
  __shared__ float ps[TC ? 1 : NW][GMAX][16];
  __shared__ float al[TC ? 1 : NW][GMAX];
  __shared__ int last;

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ps_ = p.page_size;
  // keys past the table's pages do not exist
  const int n_keys = min(p.lens[b] + (p.new_lens ? p.new_lens[b] : 0), p.max_pages * ps_);
  const int key_begin = split * p.pps * ps_;
  const size_t pair = (size_t)b * p.n_kv + kvh;
  const size_t part = pair * gridDim.x + split;
  const size_t parts = (size_t)gridDim.x * gridDim.y * gridDim.z;
  float* ws_ml = p.ws + part * GMAX * 2;
  float* ws_acc = p.ws + parts * GMAX * 2 + part * GMAX * HD;
  // the split's table entries, read beside the row's length (entries past
  // the row's pages are read, never used)
  const int page_end = min(p.pps, p.max_pages - split * p.pps);  // <= 0 for B's tail block
  for (int i = tid; i < page_end; i += SPLIT_THREADS)
    pages[i] = p.bt[(size_t)b * p.max_pages + split * p.pps + i];

  if (STAGED && split == p.n_splits) {  // the staged tail's partial
    tail_partial<T, HD>(p, b, kvh, warp, lane, ws_ml, ws_acc);
  } else if (key_begin >= n_keys) {  // wholly past the row's last key: an empty partial
    if (tid < GMAX) {
      ws_ml[2 * tid] = NEG_INF;
      ws_ml[2 * tid + 1] = 0.f;
    }
  } else {
    const int key_end = min(n_keys, key_begin + p.pps * ps_);
    const int n_pages = (key_end - key_begin + ps_ - 1) / ps_;
    const int group = p.n_q / p.n_kv;
    if (QUANT) {
      for (int i = tid; i < n_pages; i += SPLIT_THREADS) {  // this thread's own table reads
        const int pg = pages[i];
        page_ks[i] = p.k_scales[(size_t)kvh * p.num_pages + pg];
        page_vs[i] = p.v_scales[(size_t)kvh * p.num_pages + pg];
      }
    }
    uint8_t* ring = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
    if (tid == 0) {
      for (int s = 0; s < Tl::STAGES; ++s) hopper::mbar_init(&full_bar[s], 1);
      hopper::mbar_fence_init();
    }
    if constexpr (!TC) {
      const float* qrow = static_cast<const float*>(p.q) + ((size_t)b * p.n_q + kvh * group) * HD;
      for (int i = tid; i < GMAX * HD; i += SPLIT_THREADS)
        qs[i / HD][i % HD] = i / HD < group ? qrow[i] : 0.f;
    }
    __syncthreads();

    const int n_tiles = (key_end - key_begin + KT - 1) / KT;
    // key k of a tile lies on the tile's page k >> sh (one page a tile when
    // ps >= KT; ps, a power of two, below)
    const int sh = ps_ >= KT ? 30 : __ffs(ps_) - 1;
    const int head_page0 = kvh * p.num_pages;
    // thread 0: tile t's boxes into stage t % STAGES
    auto issue = [&](int t) {
      uint64_t* bar = &full_bar[t % Tl::STAGES];
      uint8_t* kt = ring + (t % Tl::STAGES) * 2 * Tl::BYTES;
      uint8_t* vt = kt + Tl::BYTES;
      const int k0 = t * KT;  // from key_begin
      constexpr int BOX_ELEMS = Tl::SPAN / (int)sizeof(P);
      if (ps_ >= KT) {
        const int row = (head_page0 + pages[k0 / ps_]) * ps_ + (key_begin + k0) % ps_;
        hopper::mbar_expect_tx(bar, 2 * Tl::BYTES);
        for (int bx = 0; bx < Tl::BOXES; ++bx) {
          hopper::tma_load_2d(kt + bx * KT * Tl::SPAN, &p.tm_k, bar, bx * BOX_ELEMS, row);
          hopper::tma_load_2d(vt + bx * KT * Tl::SPAN, &p.tm_v, bar, bx * BOX_ELEMS, row);
        }
      } else {
        const int pi0 = k0 / ps_;
        const int cnt = min(KT / ps_, n_pages - pi0);
        hopper::mbar_expect_tx(bar, 2 * cnt * ps_ * Tl::ROW);
        for (int j = 0; j < cnt; ++j) {
          const int row = (head_page0 + pages[pi0 + j]) * ps_;
          for (int bx = 0; bx < Tl::BOXES; ++bx) {
            const int dst = bx * KT * Tl::SPAN + j * ps_ * Tl::SPAN;
            hopper::tma_load_2d(kt + dst, &p.tm_k, bar, bx * BOX_ELEMS, row);
            hopper::tma_load_2d(vt + dst, &p.tm_v, bar, bx * BOX_ELEMS, row);
          }
        }
      }
    };
    if (tid == 0)
      for (int t = 0; t < Tl::STAGES && t < n_tiles; ++t) issue(t);

    MmaState<QUANT, HD> mst;
    FmaState<HD> fst;
    if constexpr (TC) {
      const int g = lane >> 2;
      mst.init(static_cast<const __nv_bfloat16*>(p.q) + ((size_t)b * p.n_q + kvh * group + g) * HD,
               g < group, lane & 3);
    } else {
      fst.init();
    }

    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * KT;
      const int valid = min(KT, key_end - key_begin - k0);  // valid rows of this tile
      hopper::mbar_wait(&full_bar[t % Tl::STAGES], (t / Tl::STAGES) & 1);
      const uint8_t* kt = ring + (t % Tl::STAGES) * 2 * Tl::BYTES;
      uint8_t* vt = ring + (t % Tl::STAGES) * 2 * Tl::BYTES + Tl::BYTES;
      if (valid < KT) {  // the split's last tile: zero this warp's V rows past the end
        const int r0 = max(valid, 16 * warp), r1 = 16 * warp + 16;
        constexpr int CH = Tl::SPAN / 16;  // 16-byte chunks of a box row
        for (int i = lane; i < (r1 > r0 ? r1 - r0 : 0) * Tl::BOXES * CH; i += 32) {
          const int r = r0 + i / (Tl::BOXES * CH), bx = (i / CH) % Tl::BOXES, ch = i % CH;
          *reinterpret_cast<uint4*>(vt + bx * KT * Tl::SPAN + r * Tl::SPAN + ch * 16) =
              make_uint4(0u, 0u, 0u, 0u);
        }
        __syncwarp();
      }
      const int pi0 = k0 / ps_;  // the tile's first page in the split
      if constexpr (TC)
        mma_tile<P, HD, QUANT>(mst, kt, vt, warp, lane, valid, page_ks + pi0, page_vs + pi0, sh,
                               p.scale);
      else
        fma_tile<P, HD, QUANT>(fst, kt, vt, qs, ps[warp], al[warp], warp, lane, valid,
                               page_ks + pi0, page_vs + pi0, sh, p.scale);
      __syncthreads();  // stage t consumed by every warp
      if (tid == 0 && t + Tl::STAGES < n_tiles) issue(t + Tl::STAGES);
    }

    // merge the warps' partials through shared memory (the ring is drained)
    float* wm = reinterpret_cast<float*>(ring);
    float* wl = wm + NW * GMAX;
    float* wacc = wl + NW * GMAX;  // [NW][GMAX][HD]
    if constexpr (TC) {
      const int g = lane >> 2, c = lane & 3;
      float l = mst.lsum;
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if (c == 0) {
        wm[warp * GMAX + g] = mst.m;
        wl[warp * GMAX + g] = l;
      }
      float* dst = wacc + (warp * GMAX + g) * HD;
#pragma unroll
      for (int n = 0; n < MmaState<QUANT, HD>::NT; ++n) {
        dst[MmaState<QUANT, HD>::d_of(n, 2 * c)] = mst.acc[n][0];
        dst[MmaState<QUANT, HD>::d_of(n, 2 * c + 1)] = mst.acc[n][1];
      }
    } else {
      if (lane < 2) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          wm[warp * GMAX + 4 * lane + i] = fst.m[i];
          wl[warp * GMAX + 4 * lane + i] = fst.l[i];
        }
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
#pragma unroll
        for (int j = 0; j < HD / 32; ++j)
          wacc[(warp * GMAX + g) * HD + lane + 32 * j] = fst.acc[g][j];
    }
    __syncthreads();
    for (int i = tid; i < GMAX * HD; i += SPLIT_THREADS) {
      const int g = i / HD, d = i % HD;
      float mx = NEG_INF;
#pragma unroll
      for (int w = 0; w < NW; ++w)
        if (wl[w * GMAX + g] > 0.f) mx = fmaxf(mx, wm[w * GMAX + g]);
      float l = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        if (!(wl[w * GMAX + g] > 0.f)) continue;
        const float e = expf(wm[w * GMAX + g] - mx);
        l += e * wl[w * GMAX + g];
        a += e * wacc[(w * GMAX + g) * HD + d];
      }
      ws_acc[i] = a;
      if (d == 0) {
        ws_ml[2 * g] = mx;
        ws_ml[2 * g + 1] = l;
      }
    }
  }

  // the last of the row's split blocks to arrive merges them, and resets
  // the counter for the next launch (or a graph's replay)
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(p.counters + pair, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  merge_row<T, HD>(p, b, kvh, gridDim.x, parts, reinterpret_cast<float*>(
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023)));
  if (tid == 0) p.counters[pair] = 0;
}

// ---------------------------------------------------------------- host --

struct Launch {
  const void *q, *k_pages, *v_pages, *staged_k, *staged_v;
  void* out;
  const int *bt, *lens, *new_lens;
  const float *k_scales, *v_scales;  // this layer's
  float* ws;
  int* counters;
  int B, n_q, n_kv, num_pages, page_size, max_pages, n_steps, staged_len, pps, n_splits;
  float scale;
};

template <typename P>
constexpr CUtensorMapDataType tma_dtype() {
  return sizeof(P) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : sizeof(P) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_UINT8;
}

// the plan's preconditions, as ops/paged_decode._plan_decode states them
inline bool plan_ok(const Launch& a) {
  const int ps = a.page_size;
  const bool pages_ok = ps % KT == 0 || (KT % ps == 0 && ps % 8 == 0);
  return pages_ok && a.pps >= 1 && a.pps <= PPS_MAX && (a.pps * ps) % KT == 0 &&
         a.n_splits >= 1 && (size_t)a.n_splits * a.pps >= (size_t)a.max_pages &&
         a.n_q % a.n_kv == 0 && a.n_q / a.n_kv <= GMAX;
}

template <typename T, typename P, int HD, bool QUANT, bool STAGED>
int launch(const Launch& a, cudaStream_t stream) {
  using Tl = Tile<P, HD>;
  // the last block's merge keeps each part's (m, l) and weights in the ring
  const int n_parts = a.n_splits + (STAGED ? 1 : 0);
  if (!plan_ok(a) || n_parts * GMAX * 12 + GMAX * 4 > Tl::RING) return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  SplitParams p;
  const uint64_t rows = (uint64_t)a.n_kv * a.num_pages * a.page_size;
  const uint32_t box_rows = a.page_size < KT ? a.page_size : KT;
  const CUtensorMapSwizzle swz =
      Tl::SPAN == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  if (!hopper::encode_2d(&p.tm_k, tma_dtype<P>(), a.k_pages, HD, rows, Tl::ROW,
                         Tl::SPAN / sizeof(P), box_rows, swz) ||
      !hopper::encode_2d(&p.tm_v, tma_dtype<P>(), a.v_pages, HD, rows, Tl::ROW,
                         Tl::SPAN / sizeof(P), box_rows, swz))
    return (int)cudaErrorInvalidValue;
  p.q = a.q;
  p.bt = a.bt;
  p.lens = a.lens;
  p.new_lens = a.new_lens;
  p.k_scales = a.k_scales;
  p.v_scales = a.v_scales;
  p.ws = a.ws;
  p.counters = a.counters;
  p.staged_k = a.staged_k;
  p.staged_v = a.staged_v;
  p.out = a.out;
  p.n_steps = a.n_steps;
  p.staged_len = a.staged_len;
  p.n_q = a.n_q;
  p.n_kv = a.n_kv;
  p.num_pages = a.num_pages;
  p.page_size = a.page_size;
  p.max_pages = a.max_pages;
  p.pps = a.pps;
  p.n_splits = a.n_splits;
  p.scale = a.scale;
  auto kernel = split_kernel<T, P, HD, QUANT, STAGED>;
  static bool sized = false;  // one per instance
  if (!sized) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  // B: one block more per row, the staged tail's partial
  kernel<<<dim3(n_parts, a.n_kv, a.B), SPLIT_THREADS, Tl::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace decode
}  // namespace port
