// K3's attention-section body on wgmma fed by a TMA ring, shared by
// attn_section.cu (K3, masks from the window index), swin_block.cu (K4, the
// section then the MLP) and attn_section_v1.cu (K5, masks shipped in and
// super-windows).  The design is described at the top of attn_section.cu.
//
// A block owns W windows as one flat [W*49, C] row matrix cut into m64 row
// tiles.  Two consumer warpgroups (threads 0..255) run the products; a
// producer (thread 256) streams the weight columns of every product through a
// ring of [96 rows, 64 K-columns] tiles in the order they are used:
// produce_qkv (a head's q, k, v columns) and produce_proj (96 of the
// projection's output columns).  The consumers' pieces: section_product (one
// product over the ring's next K tiles), qkv_epilogue, ctx_to_operand,
// proj_epilogue; section_rows composes them into K3's body (with K3's WMMA
// core and masks: section_geom.cuh's geom_section).  Where 96 does not divide
// C the projection's last pass is narrower (n64 / n32 / n16); where y does not
// fit resident (SecPlan::YS, K3 at C = 1536) produce_section_ys streams y and
// then the context from the block's scratch rows, each slot an A tile beside
// the weight tile.

#pragma once

#include <type_traits>

#include "attn_common.cuh"
#include "sm90.cuh"

namespace {

// The products of a block of R rows: C channels, S ring slots, RR a producer
// warpgroup and setmaxnreg.  What section_product, qkv_epilogue,
// ctx_to_operand and proj_epilogue read of a plan; SecPlan adds K3's layout.
template <int C_, int R_, int S_, bool RR_>
struct SecShape {
  static constexpr int C = C_, S = S_;
  static constexpr bool RR = RR_;               // a producer warpgroup and setmaxnreg
  static constexpr int THREADS = RR ? 384 : 288; // else a lone producer warp
  static constexpr int R = R_;                  // rows of the products
  static constexpr int RT = (R + 63) / 64;      // m64 row tiles
  static constexpr int RS = (R + 7) / 8 * 8;    // rows of a K tile of y
  static constexpr bool ROWS = RT >= 2;         // warpgroups split the rows, else the columns
  static constexpr int NTW = ROWS ? RT / 2 : 1; // row tiles a warpgroup
  static constexpr int NB = ROWS ? 96 : 48;     // columns a warpgroup's wgmma
  static constexpr int ACC = NB / 2;            // accumulator registers a row tile
  static constexpr int KT = (C + 63) / 64;      // K tiles
  static constexpr int KS = C / 16;             // k16 steps
  static constexpr int NH = C / kHD;
  static constexpr int SLOT = 96 * 128;         // a ring slot: [96 rows, 64 bf16]
  static constexpr int LOAD = SLOT;             // bytes that a slot's loads bring
  static constexpr int YK = RS * 128;           // bytes a K tile of y
  static constexpr int LW = C - 96 * ((C - 1) / 96);  // the projection's last pass: 96, 64 or 32
  static constexpr bool YS = false;             // y resident (SecPlan may stream it)
  static constexpr int A_BYTES = 0;             // no A tile in a ring slot
  static_assert(RT == 1 || RT % 2 == 0, "row tiles split evenly over two warpgroups");
  static_assert(C % 32 == 0 && LW % 32 == 0,
                "the projection walks 96 columns a pass, the last 64 or 32 where 96 does not "
                "divide C");
};

// K3's plan: W windows a block as W * 49 flat rows, TOK bytes a token of the
// token table (K3 and K4: a region id and pad flag in one byte; K5: the region
// id as fp32).  Where y would not fit resident (C = 1536: 172 KB for one
// window), y and then the context stream through the ring instead (YS): each
// slot holds the window's [64 rows, 64] A tile of them at its start, from the
// scratch rows the block writes, beside the [96, 64] weight tile.  RING: the
// least bytes a ring slot spans (K4 at C = 1536, whose MLP slots are larger
// than the section's); a slot's loads still bring LOAD bytes.
// ops/fused_attn.py:section_plan mirrors this arithmetic.
template <int C_, int W_, int S_, bool RR_, int TOK_ = 1, int RING_ = 0>
struct SecPlan : SecShape<C_, W_ * kN, S_, RR_> {
  typedef SecShape<C_, W_ * kN, S_, RR_> Shape;
  using Shape::C;
  using Shape::R;
  using Shape::RS;
  using Shape::RT;
  using Shape::S;
  using Shape::KT;
  using Shape::YK;
  static constexpr int W = W_;
  static constexpr int RQ = (R + 15) / 16 * 16 + 16;  // q/k/v rows: a window's tiles reach R + 14
  static constexpr int NSTRIP = 4 * W < kWarps ? 4 * W : kWarps;  // attention tiles at once
  static constexpr size_t Q_BYTES = align128((size_t)RQ * kLQ * sizeof(bf16));
  // q, k, v, the strips, a head's bias and the token table
  static constexpr size_t REST = 3 * Q_BYTES + (size_t)NSTRIP * kStrip * sizeof(float) +
                                 align128((size_t)kN * kN * sizeof(float)) +
                                 align128((size_t)R * TOK_);
  static constexpr size_t RESIDENT =
      (size_t)S * Shape::SLOT + (size_t)KT * YK + REST + 2 * S * sizeof(uint64_t) + 1024;
  static constexpr bool YS = RESIDENT > kMaxSmem;
  static constexpr int A_BYTES = YS ? 64 * 128 : 0;  // a slot's A tile (YS)
  static constexpr int LOAD = A_BYTES + Shape::SLOT;
  static constexpr int SLOT = LOAD > RING_ ? LOAD : RING_;
  static constexpr size_t OFF_Y = (size_t)S * SLOT;
  static constexpr size_t OFF_Q = OFF_Y + (YS ? 0 : (size_t)KT * YK);
  static constexpr size_t OFF_STRIP = OFF_Q + 3 * Q_BYTES;
  static constexpr size_t OFF_BIAS = OFF_STRIP + (size_t)NSTRIP * kStrip * sizeof(float);
  static constexpr size_t OFF_TOK = OFF_BIAS + align128((size_t)kN * kN * sizeof(float));
  static constexpr size_t OFF_BAR = OFF_TOK + align128((size_t)R * TOK_);
  // full and empty barriers a slot; YS: then `ready` (y written, then the context)
  static constexpr size_t SMEM = OFF_BAR + (2 * S + (YS ? 1 : 0)) * sizeof(uint64_t) + 1024;
  static_assert(YS || (size_t)(RT * 64 - RS) * 128 <= OFF_BAR - OFF_Q,
                "a row tile past y must stay inside the block's shared memory");
  static_assert(!YS || (W == 1 && C % 64 == 0), "a streamed y: one window, whole K tiles");
  static_assert(SMEM <= kMaxSmem, "over the shared memory a block can have");
};

// phases of the consumers' clock (the CLK builds): LN, token tables and bias
// copies; waiting for a ring slot; starting and waiting for wgmma; the q, k, v
// epilogue; the attention core; the context's copy back; the output epilogue.
// K4 adds its LN2, h epilogue and MLP output epilogue.
enum { kClkSetup, kClkWait, kClkMma, kClkQkv, kClkAttn, kClkCtx, kClkOut, kClkPhases };

// the block's 256 consumer threads
__device__ __forceinline__ void consumers_sync() { sm90::named_sync(1, 256); }

// ---- the producer -------------------------------------------------------------------
// head h's q, k, v columns, one slot a K tile (three boxes of 32 rows)
template <typename Pl, typename Fill>
__device__ __forceinline__ void produce_qkv(Fill& f, const CUtensorMap* mq, int h) {
#pragma unroll 1
  for (int kt = 0; kt < Pl::KT; ++kt) {
    unsigned char* dst = f.next(Pl::LOAD);
    for (int which = 0; which < 3; ++which)  // q, k, v columns of head h: 32 rows each
      sm90::tma_load_2d(dst + which * 32 * 128, mq, f.bar(), kt * 64, which * Pl::C + h * kHD);
    f.advance();
  }
}

// the projection's output columns n0..n0+95, one slot a K tile
template <typename Pl, typename Fill>
__device__ __forceinline__ void produce_proj(Fill& f, const CUtensorMap* mp, int n0) {
#pragma unroll 1
  for (int kt = 0; kt < Pl::KT; ++kt) f.load(mp, kt * 64, n0, Pl::LOAD);
}

// section_rows' stream: every head's q, k, v, then the projection
template <typename Pl, typename Fill>
__device__ __forceinline__ void produce_section(Fill& f, const CUtensorMap* mq,
                                                const CUtensorMap* mp) {
#pragma unroll 1
  for (int h = 0; h < Pl::NH; ++h) produce_qkv<Pl>(f, mq, h);
#pragma unroll 1
  for (int n0 = 0; n0 < Pl::C; n0 += 96) produce_proj<Pl>(f, mp, n0);
}

// produce_section where y and the context stream (Pl::YS), over `nwin`
// windows of 64 scratch rows each from row0 (K3 and K4: the block's window;
// K5's scratch path: its super-window, a window a chunk): a slot holds a
// window's [64, 64] tile of y (then of the context) from my (mc) beside the
// weight tile; y's tiles go once `ready` has completed its first phase (the
// consumers wrote y), the context's once its second
template <typename Pl, typename Fill>
__device__ __forceinline__ void produce_section_ys(Fill& f, const CUtensorMap* mq,
                                                   const CUtensorMap* mp, const CUtensorMap* my,
                                                   const CUtensorMap* mc, int row0,
                                                   uint64_t* ready, int nwin = 1) {
  sm90::mbar_wait(ready, 0u);
#pragma unroll 1
  for (int w = 0; w < nwin; ++w)
#pragma unroll 1
    for (int h = 0; h < Pl::NH; ++h)
#pragma unroll 1
      for (int kt = 0; kt < Pl::KT; ++kt) {
        unsigned char* dst = f.next(Pl::LOAD);
        sm90::tma_load_2d(dst, my, f.bar(), kt * 64, row0 + 64 * w);
        for (int which = 0; which < 3; ++which)  // q, k, v columns of head h: 32 rows each
          sm90::tma_load_2d(dst + Pl::A_BYTES + which * 32 * 128, mq, f.bar(), kt * 64,
                            which * Pl::C + h * kHD);
        f.advance();
      }
  sm90::mbar_wait(ready, 1u);
#pragma unroll 1
  for (int w = 0; w < nwin; ++w)
#pragma unroll 1
    for (int n0 = 0; n0 < Pl::C; n0 += 96)
#pragma unroll 1
      for (int kt = 0; kt < Pl::KT; ++kt) {
        unsigned char* dst = f.next(Pl::LOAD);
        sm90::tma_load_2d(dst, mc, f.bar(), kt * 64, row0 + 64 * w);
        sm90::tma_load_2d(dst + Pl::A_BYTES, mp, f.bar(), kt * 64, n0);
        f.advance();
      }
}

// ---- the consumers' pieces ----------------------------------------------------------
template <int NB>
__device__ __forceinline__ void wgmma_n(float* d, uint64_t da, uint64_t db) {
  if constexpr (NB == 96) {
    sm90::wgmma_ss_n96(d, da, db, 1);
  } else if constexpr (NB == 64) {
    sm90::wgmma_ss_n64(d, da, db, 1);
  } else if constexpr (NB == 48) {
    sm90::wgmma_ss_n48(d, da, db, 1);
  } else if constexpr (NB == 32) {
    sm90::wgmma_ss_n32(d, da, db, 1);
  } else {
    static_assert(NB == 16, "n96, n64, n48, n32 or n16");
    sm90::wgmma_ss_n16(d, da, db, 1);
  }
}

// acc[t] = A[row tiles of this warpgroup] @ (the ring's next KT slots, from
// column cofs of each), taken slot by slot, NB columns a wgmma (Pl::YS: A is
// each slot's own A tile).  The ring is an sm90::Ring or any
// type with its ring_take / ring_used / ring_next / ring_drain (found by ADL).
template <typename Pl, int NB = Pl::NB, typename Rg, typename Clk>
__device__ __forceinline__ void section_product(Rg& q, const unsigned char* a, int g, int cofs,
                                                float (&acc)[Pl::NTW][NB / 2], Clk& clk) {
#pragma unroll
  for (int t = 0; t < Pl::NTW; ++t) {
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) acc[t][i] = 0.0f;
    sm90::reg_fence(acc[t]);
  }
  // whole K tiles, then (C = 96) the half tile of the last 32 columns: the
  // k-steps of every wgmma are compile-time, none sits in a branch
  auto k_tile = [&](int kt, auto steps) {
    clk.template lap<kClkMma>();
    unsigned char* b = ring_take(q);
    clk.template lap<kClkWait>();
    const uint64_t db = sm90::desc_sw128(b + Pl::A_BYTES + cofs * 128);
#pragma unroll
    for (int t = 0; t < Pl::NTW; ++t) sm90::reg_fence(acc[t]);
    sm90::wgmma_fence();
#pragma unroll
    for (int t = 0; t < Pl::NTW; ++t) {
      const int rt = Pl::ROWS ? g + 2 * t : 0;
      const uint64_t da = Pl::YS ? sm90::desc_sw128(b)
                                 : sm90::desc_sw128(a + kt * Pl::YK + rt * 64 * 128);
#pragma unroll
      for (int ks = 0; ks < decltype(steps)::value; ++ks)
        wgmma_n<NB>(acc[t], sm90::desc_step(da, ks), sm90::desc_step(db, ks));
    }
    sm90::wgmma_commit();
    ring_used(q);
#pragma unroll
    for (int t = 0; t < Pl::NTW; ++t) sm90::reg_fence(acc[t]);
    ring_next(q);
  };
#pragma unroll 1
  for (int kt = 0; kt < Pl::KS / 4; ++kt) k_tile(kt, std::integral_constant<int, 4>());
  if constexpr (Pl::KS % 4 != 0) k_tile(Pl::KS / 4, std::integral_constant<int, Pl::KS % 4>());
  ring_drain(q);
  clk.template lap<kClkMma>();
#pragma unroll
  for (int t = 0; t < Pl::NTW; ++t) sm90::reg_fence(acc[t]);
}

// q, k, v of head h = T(T(acc) + T(bqkv)): sink(which, row, d, two packed bf16)
// for each pair of this warpgroup's rows below rmax (q = 0, k = 1, v = 2)
template <typename Pl, typename Sink>
__device__ __forceinline__ void qkv_epilogue(const float (&acc)[Pl::NTW][Pl::ACC], int g, int cofs,
                                             int h, int rmax, const float* __restrict__ bqkv,
                                             Sink sink) {
  const int lane = threadIdx.x % 32, wrow = ((threadIdx.x / 32) % 4) * 16;
#pragma unroll
  for (int t = 0; t < Pl::NTW; ++t) {
    const int rt = Pl::ROWS ? g + 2 * t : 0;
#pragma unroll
    for (int i = 0; i < Pl::ACC; i += 2) {
      const int row = rt * 64 + wrow + lane / 4 + 8 * ((i / 2) % 2);
      const int col = cofs + (i / 4) * 8 + (lane % 4) * 2;  // of q | k | v, 96 in all
      const int which = col / kHD, d = col % kHD;
      if (row < rmax) {
        const float2 bb = *reinterpret_cast<const float2*>(bqkv + which * Pl::C + h * kHD + d);
        sink(which, row, d,
             sm90::pack_bf16(bf(acc[t][i]) + bf(bb.x), bf(acc[t][i + 1]) + bf(bb.y)));
      }
    }
  }
}

// the context of `rows` rows (row stride C, in device memory) into y's place
// in the operand layout, 16 bytes a copy; fenced for wgmma
template <typename Pl>
__device__ __forceinline__ void ctx_to_operand(const bf16* ctx, int rows, unsigned char* ys) {
  constexpr int C = Pl::C;
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * (C / 8); i += 256) {
    const int r = i / (C / 8), c8 = i % (C / 8);
    const uint4 v = *reinterpret_cast<const uint4*>(ctx + (size_t)r * C + c8 * 8);
    *reinterpret_cast<uint4*>(ys + (c8 / 8) * Pl::YK + r * 128 + (((c8 % 8) ^ (r % 8)) << 4)) = v;
  }
  sm90::fence_async_smem();
}

// out = x + T(T(acc) + T(bproj)) at the projection's columns n0.., NB of them
// a warpgroup, this warpgroup's rows below `rows` (x and out: the block's first
// row, stride C)
template <typename Pl, int NB = Pl::NB>
__device__ __forceinline__ void proj_epilogue(const float (&acc)[Pl::NTW][NB / 2], int g,
                                              int cofs, int n0, int rows,
                                              const float* __restrict__ bproj, const bf16* x,
                                              bf16* out) {
  const int lane = threadIdx.x % 32, wrow = ((threadIdx.x / 32) % 4) * 16;
#pragma unroll
  for (int t = 0; t < Pl::NTW; ++t) {
    const int rt = Pl::ROWS ? g + 2 * t : 0;
#pragma unroll
    for (int i = 0; i < NB / 2; i += 2) {
      const int row = rt * 64 + wrow + lane / 4 + 8 * ((i / 2) % 2);
      const int col = n0 + cofs + (i / 4) * 8 + (lane % 4) * 2;
      if (row < rows) {
        const float2 bb = *reinterpret_cast<const float2*>(bproj + col);
        const size_t e = (size_t)row * Pl::C + col;
        const float2 xr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + e));
        *reinterpret_cast<__nv_bfloat162*>(out + e) = __floats2bfloat162_rn(
            xr.x + bf(bf(acc[t][i]) + bf(bb.x)), xr.y + bf(bf(acc[t][i + 1]) + bf(bb.y)));
      }
    }
  }
}

// a = x + T(T(ctx @ wproj) + T(bproj)) over the ring's next projection
// slots: 96 columns a pass, the last pass LW (C = 128, 256, 512, 1024: the
// TMA box past C is zero-filled and left unread by an n64 / n32 product, n32 /
// n16 a warpgroup with one row tile); ys is the context in y's place (Pl::YS:
// each slot's A tile), x and out the first of `rows` rows, row stride C
template <typename Pl, typename Rg, typename Clk>
__device__ __forceinline__ void proj_passes(Rg& q, const unsigned char* ys, int g, int cofs,
                                            int rows, const float* __restrict__ bproj,
                                            const bf16* x, bf16* out,
                                            float (&acc)[Pl::NTW][Pl::ACC], Clk& clk) {
  for (int n0 = 0; n0 + 96 <= Pl::C; n0 += 96) {
    section_product<Pl>(q, ys, g, cofs, acc, clk);
    proj_epilogue<Pl>(acc, g, cofs, n0, rows, bproj, x, out);
    clk.template lap<kClkOut>();
  }
  if constexpr (Pl::LW != 96) {
    constexpr int NBL = Pl::ROWS ? Pl::LW : Pl::LW / 2;
    const int cofsl = Pl::ROWS ? 0 : NBL * g;
    float accl[Pl::NTW][NBL / 2];
    section_product<Pl, NBL>(q, ys, g, cofsl, accl, clk);
    proj_epilogue<Pl, NBL>(accl, g, cofsl, Pl::C - Pl::LW, rows, bproj, x, out);
    clk.template lap<kClkOut>();
  }
}

// ---- the section of a block's rows, K3's body ------------------------------------------
// The consumers' side of produce_section over the block's W windows (`rows`
// real rows; x and out at the block's first row).  tables() fills the token
// tables; y = LN(src(r)) scaled by scale(r) (src null: a zero row); per head
// the q, k, v product and its epilogue into shared memory, then attend(h, q, k,
// v, bias, strips), which writes the head's context into out at its columns;
// after the last head the context goes back into y's place and the projection
// writes a = x + T(T(ctx @ wproj) + T(bproj)) over it, 96 columns a pass (the
// last pass LW).  Pl::YS (produce_section_ys): y goes to the block's scratch
// rows ysg instead (64 a window, zeros past the real ones) and attend writes
// the context to the scratch the producer reads it from; each is made visible
// to TMA and announced on `ready`.  Ends with each warpgroup's wgmma drained;
// y is free once both warpgroups are past a barrier.
template <typename Pl, typename Rg, typename Clk, typename Tables, typename Src, typename Scale,
          typename Attend>
__device__ __forceinline__ void section_rows(Rg& q, unsigned char* smem,
                                             const bf16* x, bf16* out, int rows,
                                             const float* __restrict__ gamma,
                                             const float* __restrict__ beta,
                                             const float* __restrict__ bqkv,
                                             const float* __restrict__ bproj,
                                             const float* __restrict__ bias, float eps,
                                             Tables tables, Src src, Scale scale, Attend attend,
                                             Clk& clk, bf16* ysg = nullptr,
                                             uint64_t* ready = nullptr) {
  constexpr int C = Pl::C;
  unsigned char* ys = smem + Pl::OFF_Y;
  bf16* qb = reinterpret_cast<bf16*>(smem + Pl::OFF_Q);
  bf16* kb = reinterpret_cast<bf16*>(smem + Pl::OFF_Q + Pl::Q_BYTES);
  bf16* vb = reinterpret_cast<bf16*>(smem + Pl::OFF_Q + 2 * Pl::Q_BYTES);
  float* strips = reinterpret_cast<float*>(smem + Pl::OFF_STRIP);
  float* bias_s = reinterpret_cast<float*>(smem + Pl::OFF_BIAS);
  const int cw = threadIdx.x / 32;
  const int g = cw / 4;                    // warpgroup
  const int cofs = Pl::ROWS ? 0 : 48 * g;  // the warpgroup's first column of a slot

  tables();
  // zero tails of q, k, v
  for (int i = threadIdx.x; i < (Pl::RQ - Pl::R) * kLQ; i += 256) {
    const bf16 z = __float2bfloat16(0.0f);
    qb[Pl::R * kLQ + i] = z;
    kb[Pl::R * kLQ + i] = z;
    vb[Pl::R * kLQ + i] = z;
  }
  if constexpr (Pl::YS) {
    // y = LN(x) * mask, a warp a row, into the scratch rows that TMA reads back
    sm90::ln_rows<C, sm90::kLnBatch<C>>(
        [&](int r) -> const bf16* { return r < rows ? src(r) : nullptr; }, cw, kWarps,
        64 * Pl::W, gamma, beta, eps,
        [&](int r, int c, uint32_t val, float2) {
          *reinterpret_cast<uint32_t*>(ysg + (size_t)r * C + c) = val;
        },
        scale);
    sm90::fence_async_all();
    consumers_sync();
    if (threadIdx.x == 0) sm90::mbar_arrive(ready);
  } else {
    // y = LN(x) * mask, a warp a row; rows past the real ones are zero
    sm90::ln_rows_sw128<C, sm90::kLnBatch<C>>(
        [&](int r) -> const bf16* { return r < rows ? src(r) : nullptr; }, cw, kWarps, Pl::RS,
        gamma, beta, eps, ys, Pl::YK, scale);
    sm90::fence_async_smem();
  }

  float acc[Pl::NTW][Pl::ACC];
  for (int h = 0; h < Pl::NH; ++h) {
    // this head's bias: the barrier that ended the head before's attention is behind us,
    // the one before this head's attention shows it
    for (int i = threadIdx.x; i < kN * kN; i += 256) bias_s[i] = bias[(size_t)h * kN * kN + i];
    if (h == 0) consumers_sync();  // y, the token tables and the tails, whole
    clk.template lap<kClkSetup>();
    section_product<Pl>(q, ys, g, cofs, acc, clk);
    // q, k, v of this head, rows past the real ones dropped
    qkv_epilogue<Pl>(acc, g, cofs, h, Pl::R, bqkv, [&](int which, int row, int d, uint32_t v) {
      bf16* dst = (which == 0 ? qb : (which == 1 ? kb : vb)) + row * kLQ + d;
      *reinterpret_cast<uint32_t*>(dst) = v;
    });
    consumers_sync();
    clk.template lap<kClkQkv>();
    attend(h, qb, kb, vb, bias_s, strips);
    consumers_sync();  // the context of this head is in `out`; q, k, v and the bias are free
    clk.template lap<kClkAttn>();
  }

  if constexpr (Pl::YS) {
    // every thread's context stores, visible to the projection's TMA loads
    sm90::fence_async_all();
    consumers_sync();
    if (threadIdx.x == 0) sm90::mbar_arrive(ready);
  } else {
    // the context, back from the output rows into y's place (y is dead)
    ctx_to_operand<Pl>(out, rows, ys);
    consumers_sync();
  }
  clk.template lap<kClkCtx>();

  // a = x + T(T(ctx @ wproj) + T(bproj)), 96 columns a pass, the last LW
  proj_passes<Pl>(q, ys, g, cofs, rows, bproj, x, out, acc, clk);
}

}  // namespace
