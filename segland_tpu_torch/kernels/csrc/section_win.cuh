// The attention section over padded windows: products on wgmma fed by a TMA
// ring (section_sm90.cuh's pieces), the attention core on K6's
// register-resident mma.sync core (mma_sync.cuh).  Shared by K9 and K10
// (section_hg.cuh) and K11 (attn_section_variants.cu); K9's and K11's masks are
// shipped in as [rows, 49] tables, window w taking row w % rows, K10's come
// from the window index.
//
// A pass of a block holds W windows (1, 2 or 4) as W m64 row tiles: window wl
// at rows 64 wl .. 64 wl + 48 of y, rows 49..63 zero.  At those W a block of
// flat rows (K3's 49 W) takes as many m64 tiles, so the padding costs no
// tensor work, and a window is a row tile.  y = T((LN(x) * gamma + beta) * m)
// goes into the 128-byte-swizzled A operand; a head's q, k and v of the pass
// are [64 W, 32] tiles of 64-byte rows in mma_sync.cuh's swizzled layout
// (qkv_off), written there by the q, k, v epilogue's store functor.  Rows
// 49..63 of a window hold T(bqkv): the JAX wrappers' pad tokens exactly, and
// finite.  The core (win_core, one warp a 16-query tile of one window and
// head) is K6's: QK^T by mma.sync on ldmatrix fragments, the bias and the
// shift-region penalty added in registers, the softmax with quad shuffles, P
// rounded to bf16 in registers as the A fragments of PV, V by ldmatrix.trans.
// It writes the context over its own q rows, where it is a 64-byte-swizzled
// wgmma A operand as it stands (K11's per-head projection reads it there), and
// copies it to the output rows where asked (the one projection after the last
// head: ctx_to_y brings it back into y's place, win_proj_epilogue adds the bias
// and the residual).  A head's bias is bf16 [49, 56] (the wrapper pads the
// columns), 4 bytes a pair of keys.

#pragma once

#include "mma_sync.cuh"
#include "section_sm90.cuh"

namespace {

constexpr int kWinRows = 64;                     // rows of a window in a pass
constexpr int kTileQ = kWinRows * kHD * 2;       // bytes of a window's q, k or v: 4,096
constexpr int kBiasLd = 56;                      // row stride of a head's bias, bf16
constexpr int kBiasHead = kN * kBiasLd;          // bf16 of a head's bias
constexpr float kPadBias = -998244352.0f;        // bf16(-1e9): a pad key's bias (JAX layout)
constexpr float kScale = 0.17677669529663687f;   // 32 ** -0.5

// W windows a pass, S ring slots, NQ sets of a head's q, k, v, NBIAS heads'
// bias.  The products are SecShape's over 64 W rows; the block is its two
// consumer warpgroups alone (HandBackRing).
template <int C_, int W_, int S_, int NQ_, int NBIAS_>
struct WinPlan : SecShape<C_, W_ * kWinRows, S_, false> {
  typedef SecShape<C_, W_ * kWinRows, S_, false> Shape;
  using Shape::C;
  using Shape::R;
  using Shape::S;
  using Shape::SLOT;
  using Shape::KT;
  using Shape::YK;
  static constexpr int THREADS = 256;
  static constexpr int W = W_, NQ = NQ_, NBIAS = NBIAS_;
  static constexpr int QKV = W * kTileQ;  // bytes of a head's q (or k, or v) of a pass
  static constexpr size_t OFF_Y = (size_t)S * SLOT;
  static constexpr size_t OFF_Q = OFF_Y + (size_t)KT * YK;
  static constexpr size_t OFF_BIAS = OFF_Q + (size_t)NQ * 3 * QKV;
  static constexpr size_t OFF_TOK = OFF_BIAS + align128((size_t)NBIAS * kBiasHead * 2);
  static constexpr size_t OFF_BAR = OFF_TOK + (size_t)R * sizeof(float);  // + hand-back counts
  static constexpr size_t SMEM = OFF_BAR + 2 * S * sizeof(uint64_t) + 1024;  // + alignment
  static_assert(W == 1 || W == 2 || W == 4, "a window a row tile, the tiles split evenly");
  static_assert(SMEM <= kMaxSmem, "over the shared memory a block can have");
};

// ---- a ring refilled by the warpgroup that hands a slot back last ----------------
// A ninth warp (section_sm90.cuh's lone producer) puts three warps on one SM
// sub-partition, and ptxas then gives every thread 168 registers; with the
// two consumer warpgroups alone a thread may have 255.  So the consumers fill
// the ring themselves: the stream is a numbered sequence of items (Items: item
// i's expected bytes and TMA loads into a slot), thread 0 starts the first S,
// and of the two warpgroups the one that hands a slot back second (a counter
// a slot in shared memory says which) starts the item S further on in it,
// when a producer would have.
template <int B, int S_, typename Items>
struct HandBackRing {
  sm90::Ring<B, S_> q;  // its full barriers; `empty` is not used
  int* owed;            // [S] hand-backs of each slot, in shared memory
  Items items;          // item i: expect its bytes on the slot's barrier, start its loads
  int item, pend_item, total;  // the item taken next, the one at q.pend; every item
};

// thread 0, before the block's first barrier: the first S items
template <int B, int S_, typename It>
__device__ __forceinline__ void ring_start(HandBackRing<B, S_, It>& r) {
  if (threadIdx.x == 0)
    for (int i = 0; i < S_ && i < r.total; ++i)
      r.items(i, r.q.base + (size_t)i * B, &r.q.full[i]);
}
// this warpgroup is done with item `it` in `slot`; the second to say so refills it
template <int B, int S_, typename It>
__device__ __forceinline__ void ring_hand_back(HandBackRing<B, S_, It>& r, int slot, int it) {
  if (slot >= 0 && threadIdx.x % 128 == 0 && (atomicAdd(&r.owed[slot], 1) & 1) &&
      it + S_ < r.total)
    r.items(it + S_, r.q.base + (size_t)slot * B, &r.q.full[slot]);
}
template <int B, int S_, typename It>
__device__ __forceinline__ unsigned char* ring_take(HandBackRing<B, S_, It>& r) {
  return sm90::ring_take(r.q);
}
template <int B, int S_, typename It>
__device__ __forceinline__ void ring_used(HandBackRing<B, S_, It>& r) {
  sm90::wgmma_wait<1>();
  ring_hand_back(r, r.q.pend, r.pend_item);
  r.q.pend = r.q.slot;
  r.pend_item = r.item;
}
template <int B, int S_, typename It>
__device__ __forceinline__ void ring_next(HandBackRing<B, S_, It>& r) {
  sm90::ring_next(r.q);
  ++r.item;
}
template <int B, int S_, typename It>
__device__ __forceinline__ void ring_drain(HandBackRing<B, S_, It>& r) {
  sm90::wgmma_wait<0>();
  ring_hand_back(r, r.q.pend, r.pend_item);
  r.q.pend = -1;
}
// the end of a pass: this warpgroup has taken exactly the `items` the stream
// holds for its passes so far, or the block stops here (a warpgroup that took
// fewer would read the next pass's weights as this one's, one that took more
// would wait for a slot no one fills)
template <int B, int S_, typename It>
__device__ __forceinline__ void ring_pass_end(const HandBackRing<B, S_, It>& r, int items) {
  if (r.item != items) __trap();
}
// n slots this warpgroup does not read, taken and handed back at once
template <int B, int S_, typename It>
__device__ __forceinline__ void ring_skip(HandBackRing<B, S_, It>& r, int n) {
  for (int i = 0; i < n; ++i) {
    ring_take(r);
    ring_hand_back(r, r.q.slot, r.item);
    ring_next(r);
  }
}

// The block's shared memory at a 1024-byte boundary (swizzle atoms), and its
// ring over it: S full barriers (one arrival, the loads' issuer's) and S
// hand-back counters at off_bar, the first S items started.
template <typename Pl, typename Items>
__device__ __forceinline__ unsigned char* win_smem(unsigned char* raw,
                                                   HandBackRing<Pl::SLOT, Pl::S, Items>& r,
                                                   Items items, int total,
                                                   size_t off_bar = Pl::OFF_BAR) {
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + off_bar);
  r = {{smem, full, 0, -1, 0u}, reinterpret_cast<int*>(full + Pl::S), items, 0, 0, total};
  if (threadIdx.x == 0) {
    for (int s = 0; s < Pl::S; ++s) {
      sm90::mbar_init(&full[s], 1);
      r.owed[s] = 0;
    }
    sm90::mbar_init_fence();
    ring_start(r);
  }
  __syncthreads();
  return smem;
}

// wqkv^T [3C, C] as the 3-D map of win_qkv_map: [3][C rows][C], boxes of
// [3][32][64], so that one box is a slot of a head's q, k, v rows at a K tile
// (laid out as section_sm90.cuh's produce_qkv lays it with three boxes)
inline cudaError_t win_qkv_map(CUtensorMap* map, const void* wqkv, int C) {
  const uint64_t dims[3] = {(uint64_t)C, (uint64_t)C, 3};
  const uint32_t box[3] = {64, (uint32_t)kHD, 3};
  return sm90::tile_map_nd(map, wqkv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 3, dims, box);
}

// the loads of a slot of a section stream: head h's q, k, v columns at K tile
// kt (one box of win_qkv_map); the projection's columns n0.. at K tile kt
template <typename Pl>
__device__ __forceinline__ void load_qkv(unsigned char* dst, uint64_t* bar, const CUtensorMap* mq,
                                         int h, int kt) {
  sm90::mbar_expect_tx(bar, Pl::SLOT);
  sm90::tma_load_3d(dst, mq, bar, kt * 64, h * kHD, 0);
}
template <typename Pl>
__device__ __forceinline__ void load_proj(unsigned char* dst, uint64_t* bar, const CUtensorMap* mp,
                                          int n0, int kt) {
  sm90::mbar_expect_tx(bar, Pl::SLOT);
  sm90::tma_load_2d(dst, mp, bar, kt * 64, n0);
}

// The windows [blk0, blk0 + nblk) of block b at `wblk` windows a block, and
// its passes of W (the last block and its last pass may be ragged).
struct Passes {
  long long blk0;
  int nblk, npass;
};
__device__ __forceinline__ Passes win_passes(long long NW, int wblk, int W) {
  const long long blk0 = (long long)blockIdx.x * wblk;
  const int nblk = (int)(NW - blk0 < (long long)wblk ? NW - blk0 : (long long)wblk);
  return {blk0, nblk, (nblk + W - 1) / W};
}

// token m (flat, from the pass's first window win0) of a [rows, 49] table
__device__ __forceinline__ float table_at(const float* __restrict__ table, int rows,
                                          long long win0, int m) {
  return table[(size_t)((win0 + m / kN) % rows) * kN + m % kN];
}

// the region id of every padded row of the pass, -1 on a pad token or a window
// past the pass's nwin (no key of a real token has it)
template <typename Pl>
__device__ __forceinline__ void win_tables(float* rid_s, const float* __restrict__ regions,
                                           int rows_r, long long win0, int nwin) {
  if (!regions) return;
  for (int i = threadIdx.x; i < Pl::R; i += 256) {
    const int wl = i / kWinRows, t = i % kWinRows;
    rid_s[i] = (t < kN && wl < nwin) ? table_at(regions, rows_r, win0, wl * kN + t) : -1.0f;
  }
}

// y = T((LN(x) * gamma + beta) * T(m)) of the pass's real rows, zero elsewhere
// (x: the pass's first row)
template <typename Pl>
__device__ __forceinline__ void win_ln(unsigned char* ys, const bf16* xb,
                                       const float* __restrict__ mask_tok, int rows_m,
                                       long long win0, int nwin, const float* __restrict__ gamma,
                                       const float* __restrict__ beta, float eps) {
  sm90::ln_rows_sw128<Pl::C, sm90::kLnBatch<Pl::C>>(
      [&](int r) -> const bf16* {
        const int wl = r / kWinRows, t = r % kWinRows;
        return t < kN && wl < nwin ? xb + (size_t)(wl * kN + t) * Pl::C : nullptr;
      },
      threadIdx.x / 32, kWarps, Pl::R, gamma, beta, eps, ys, Pl::YK,
      [&](int r) {
        return bf(table_at(mask_tok, rows_m, win0, r / kWinRows * kN + r % kWinRows));
      });
}

// a packed pair of q (which 0), k or v of a head at (row, d) into its tile of
// `buf`; q' = T(q * T(scale)) with scale_q
template <typename Pl>
__device__ __forceinline__ void store_qkv(unsigned char* buf, int which, int row, int d, uint32_t v,
                                          bool scale_q) {
  if (which == 0 && scale_q) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
    v = pack2(f.x * bf(kScale), f.y * bf(kScale));
  }
  *reinterpret_cast<uint32_t*>(buf + which * Pl::QKV + qkv_off(row, d >> 3) + (d & 7) * 2) = v;
}

// heads h0 .. h0 + n - 1 of the padded bias [nh, 49, 56] into dst, 16 bytes a copy
__device__ __forceinline__ void copy_bias(bf16* dst, const bf16* __restrict__ bias, int h0, int n) {
  const uint4* s = reinterpret_cast<const uint4*>(bias + (size_t)h0 * kBiasHead);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < n * kBiasHead / 8; i += 256) d[i] = s[i];
}

// ---- the core ---------------------------------------------------------------------
// kCoreDivide: p = exp(s - max), ctx = T((T(p) @ v) / sum) (K9, K10);
// kCoreNorm: p = T(exp(s - max) / sum) before PV (K11); kCoreNoMax: without
// the max; kCoreBf16Sm: e = exp(T(s - max)), p = T(T(e) / T(sum e));
// kCoreLinear: p = T(0.001 s), no max, exp or sum, the 15 pad keys included
// (bias T(-1e9), the region id of the pad rows' table entries, value
// T(bqkv)); kCoreLinearDiv: p = 0.001 s over the same 64 keys, ctx =
// T((T(p) @ v) / sum p) (K10's softmax mode).
enum { kCoreDivide, kCoreNorm, kCoreNoMax, kCoreBf16Sm, kCoreLinear, kCoreLinearDiv };

template <int MODE>
__device__ __forceinline__ uint32_t pack_p(float a, float b, float inv) {
  if constexpr (MODE == kCoreBf16Sm) {
    a = bf(a);
    b = bf(b);
  }
  if constexpr (MODE == kCoreNorm || MODE == kCoreNoMax || MODE == kCoreBf16Sm) {
    a *= inv;
    b *= inv;
  }
  return pack2(a, b);
}

// One warp: query rows 16 qt .. 16 qt + 15 of a window and head whose q, k, v
// tiles (64 rows each, qkv_off layout) start at qs, ks, vs.  s = (q . k) *
// scale + bias + (-100 where the region ids differ); bias: the head's [49, 56]
// bf16; rid: the window's 64 region ids or null.  T(ctx) goes over the warp's
// q rows below 49 and, with a sink, to sink rows 0..48 (row stride ld).
template <int MODE>
__device__ __forceinline__ void win_core(unsigned char* qs, const unsigned char* ks,
                                         const unsigned char* vs, int qt,
                                         const bf16* __restrict__ bias, const float* rid,
                                         float scale, bf16* sink, int ld) {
  constexpr bool LINEAR = MODE == kCoreLinear || MODE == kCoreLinearDiv;
  constexpr int NKT = LINEAR ? 8 : 7;  // key tiles of 8 (keys 56-63 only as pads)
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = qt * 16;
  const uint32_t sq = smem_addr(qs), sk = smem_addr(ks), sv = smem_addr(vs);

  uint32_t qa[2][4];
  {
    const int r = row0 + (lane & 7) + (lane & 8);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) ldsm_x4(qa[kk], sq + qkv_off(r, 2 * kk + (lane >> 4)));
  }
  float s[NKT][4];
#pragma unroll
  for (int j = 0; j < NKT; ++j) {
    uint32_t kb[4];
    ldsm_x4(kb, sk + qkv_off(8 * j + (lane & 7), lane >> 3));
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    mma_bf16(s[j], qa[0], kb[0], kb[1]);
    mma_bf16(s[j], qa[1], kb[2], kb[3]);
  }

  // this thread holds rows r and r + 8, keys 8j + 2t and 8j + 2t + 1
  float inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row0 + g + 8 * hf;
    const int rb = r < kN ? r : kN - 1;  // rows past 49 are never stored
    const float rq = rid ? rid[r] : 0.0f;
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      const int c = 8 * j + 2 * t;
      float2 b = make_float2(kPadBias, kPadBias);
      if (j < 7)
        b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + rb * kBiasLd + c));
      const float2 rk = rid ? *reinterpret_cast<const float2*>(rid + c) : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = s[j][2 * hf + e] * scale + (c + e < kN ? (e ? b.y : b.x) : kPadBias);
        if (rid && (e ? rk.y : rk.x) != rq) v += -100.0f;
        if (!LINEAR && c + e >= kN) v = -INFINITY;
        s[j][2 * hf + e] = v;
        m = fmaxf(m, v);
      }
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& p = s[j][2 * hf + e];
        if constexpr (LINEAR)
          p = 0.001f * p;
        else if constexpr (MODE == kCoreNoMax)
          p = __expf(p);
        else if constexpr (MODE == kCoreBf16Sm)
          p = __expf(bf(p - m));
        else
          p = __expf(p - m);
        sum += p;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[hf] = MODE == kCoreLinear ? 1.0f : 1.0f / (MODE == kCoreBf16Sm ? bf(sum) : sum);
  }

  // P as the A fragments of PV: k16 step kk is key tiles 2kk and 2kk + 1
  uint32_t pa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int j0 = 2 * kk, j1 = 2 * kk + 1;
    pa[kk][0] = pack_p<MODE>(s[j0][0], s[j0][1], inv[0]);
    pa[kk][1] = pack_p<MODE>(s[j0][2], s[j0][3], inv[1]);
    pa[kk][2] = j1 < NKT ? pack_p<MODE>(s[j1][0], s[j1][1], inv[0]) : 0u;
    pa[kk][3] = j1 < NKT ? pack_p<MODE>(s[j1][2], s[j1][3], inv[1]) : 0u;
  }
  float o[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int jn = 0; jn < 2; ++jn) {
      uint32_t vb[4];
      ldsm_x4_t(vb, sv + qkv_off(16 * kk + (lane & 7) + (lane & 8), 2 * jn + (lane >> 4)));
      mma_bf16(o[2 * jn], pa[kk], vb[0], vb[1]);
      mma_bf16(o[2 * jn + 1], pa[kk], vb[2], vb[3]);
    }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row0 + g + 8 * hf;
    const float f = MODE == kCoreDivide || MODE == kCoreLinearDiv ? inv[hf] : 1.0f;
    if (r < kN) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
        *reinterpret_cast<uint32_t*>(qs + qkv_off(r, n) + 4 * t) =
            pack2(o[n][2 * hf] * f, o[n][2 * hf + 1] * f);
    }
  }
  if (sink) {
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = lane + 32 * i, r = row0 + (idx >> 2), ch = idx & 3;
      if (r < kN)
        *reinterpret_cast<uint4*>(sink + (size_t)r * ld + ch * 8) =
            *reinterpret_cast<const uint4*>(qs + qkv_off(r, ch));
    }
  }
}

// ---- the projection after the last head ------------------------------------------
// the context of the pass's real rows (in the output rows, ctx at its first
// row) into y's place at their padded rows; fenced for wgmma
template <typename Pl>
__device__ __forceinline__ void ctx_to_y(const bf16* ctx, int nwin, unsigned char* ys) {
  constexpr int C8 = Pl::C / 8;
  for (int i = threadIdx.x; i < nwin * kN * C8; i += 256) {
    const int r = i / C8, c8 = i % C8;
    const int pr = r / kN * kWinRows + r % kN;
    const uint4 v = *reinterpret_cast<const uint4*>(ctx + (size_t)r * Pl::C + c8 * 8);
    *reinterpret_cast<uint4*>(ys + (c8 / 8) * Pl::YK + pr * 128 + (((c8 % 8) ^ (pr % 8)) << 4)) =
        v;
  }
  sm90::fence_async_smem();
}

// out = x + T(T(a) + T(bproj)) at padded row pr, columns col and col + 1, where
// pr is a real row of the pass (x and out: the pass's first row)
__device__ __forceinline__ void out_pair(int pr, int col, float a0, float a1, int nwin, int C,
                                         const float* __restrict__ bproj, const bf16* x,
                                         bf16* out) {
  const int wl = pr / kWinRows, t = pr % kWinRows;
  if (t < kN && wl < nwin) {
    const float2 bb = *reinterpret_cast<const float2*>(bproj + col);
    const size_t e = (size_t)(wl * kN + t) * C + col;
    const float2 xr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + e));
    *reinterpret_cast<__nv_bfloat162*>(out + e) =
        __floats2bfloat162_rn(xr.x + bf(bf(a0) + bf(bb.x)), xr.y + bf(bf(a1) + bf(bb.y)));
  }
}

// proj_epilogue over padded rows: the projection's columns n0.. of this
// warpgroup's rows
template <typename Pl>
__device__ __forceinline__ void win_proj_epilogue(const float (&acc)[Pl::NTW][Pl::ACC], int g,
                                                  int cofs, int n0, int nwin,
                                                  const float* __restrict__ bproj, const bf16* x,
                                                  bf16* out) {
  const int lane = threadIdx.x % 32, wrow = ((threadIdx.x / 32) % 4) * 16;
#pragma unroll
  for (int t = 0; t < Pl::NTW; ++t) {
    const int rt = Pl::ROWS ? g + 2 * t : 0;
#pragma unroll
    for (int i = 0; i < Pl::ACC; i += 2)
      out_pair(rt * 64 + wrow + lane / 4 + 8 * ((i / 2) % 2),
               n0 + cofs + (i / 4) * 8 + (lane % 4) * 2, acc[t][i], acc[t][i + 1], nwin, Pl::C,
               bproj, x, out);
  }
}

}  // namespace
