// K1's MLP body on wgmma fed by a TMA ring: ln_mlp.cu (K1) runs it over [M, C]
// rows, swin_block.cu (K4) over the rows of a block's windows after the
// attention section.  The design is described at the top of ln_mlp.cu.
//
// A work item is a row group (RG warpgroups down the rows, 64 rows each) and a
// pass over the output columns (NP of them; CG warpgroups across a pass's
// columns).  The caller puts y = LN(x) of the row group into the swizzled
// K-major operand layout (sm90.cuh) and shows it to the row group's
// warpgroups; mlp_item then walks the hidden dimension chunk by chunk and
// writes out = T(res + T(T(T(y @ w1 ...) @ w2) + T(b2)) * T(ls)).  The producer
// streams each item's tiles with produce_item, in the order mlp_item takes them.
// Where y does not fit resident (K1 at C = 1536), y is in device memory and
// produce_item_ys / mlp_item_ys carry its K tiles through the ring beside w1's.

#pragma once

#include "sm90.cuh"

namespace {
namespace mlp90 {

typedef __nv_bfloat16 bf16;

// The tile arithmetic of a build: RG consumer warpgroups down the rows, CG
// across the output columns (RG * CG = 2), NP passes over the output columns,
// HS hidden columns a warpgroup and chunk; YS: y streamed through the ring
// (each first-product slot holds a K tile of y beside the chunk's w1 tiles,
// each second-product slot the CG warpgroups' w2 tiles) instead of resident.
template <int C_, int RG_, int CG_, int NP_, int HS_, bool YS_ = false>
struct MlpTiles {
  static constexpr int C = C_, RG = RG_, CG = CG_, NP = NP_, HS = HS_;
  static constexpr bool YS = YS_;
  static constexpr int NWG = RG * CG;            // consumer warpgroups
  static constexpr int BM = 64 * RG;             // rows a work item
  static constexpr int HC = CG * HS;             // hidden columns a chunk
  static constexpr int CP = C / NP;              // output columns a pass
  static constexpr int CS = CP / CG;             // ... a warpgroup
  static constexpr int KT1 = (C + 63) / 64;      // K tiles of the first product
  static constexpr int KS1 = C / 16;             // its k16 steps
  static constexpr int NT1 = HS / 64;            // its n64 tiles a warpgroup
  static constexpr int KT2 = HC / 64;            // K tiles of the second product
  static constexpr int NT2 = (CS + 63) / 64;     // its n tiles a warpgroup
  static constexpr int LW = CS - 64 * (NT2 - 1); // width of the last: 64, or 32 (n32)
  static constexpr bool HREG = CG == 1;          // h stays in registers
  static constexpr int TILE = 8192;              // a weight tile: [64 rows, 64 bf16]
  static constexpr size_t H_BYTES = HREG ? 0 : (size_t)RG * 2 * KT2 * TILE;  // h, double-buffered
  static constexpr int SLOT = YS ? (1 + CG * NT1) * TILE : TILE;  // bytes a ring slot
  static_assert(NWG == 2, "two consumer warpgroups and a producer");
  static_assert(!YS || (RG == 1 && CG == 2 && NT1 == 1 && C % 64 == 0),
                "a streamed y: one row group, two column groups, one n tile of h each");
  static_assert(C % 32 == 0 && HS % 64 == 0 && C % (NP * CG) == 0, "tile shapes");
  static_assert(LW == 64 || LW == 32, "the last output tile is n64 or n32");
  static_assert(HREG || LW == 64, "the shared-h path takes whole n64 tiles");
};

// gelu_tanh in the form 0.5 x (1 + tanh(u)) = x / (1 + exp(-2u)): the same
// function to a few parts in 10^6 (__expf, __fdividef), far inside the bf16
// rounding that follows, in two MUFU operations where tanhf takes a dozen
// instructions.  The epilogue is elementwise work beside m64 n64 k16 products
// of K = C: at C = 96 tanhf's cost exceeded the tensor cores' (PERF.md).
__device__ __forceinline__ float gelu_tanh_fast(float x) {
  const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);  // sqrt(2/pi) (...)
  return __fdividef(x, 1.0f + __expf(-2.0f * u));
}

// h = T(gelu(T(T(acc) + T(b1)))): the first product's epilogue, before its
// final rounding
__device__ __forceinline__ float bias_gelu(float acc, float b) {
  return gelu_tanh_fast(sm90::round_bf16(sm90::round_bf16(acc) + sm90::round_bf16(b)));
}

// The weight tiles of one work item (pass p), chunk by chunk: a chunk's w1
// tiles (K tile, then warpgroup, then n tile), then its w2 tiles, each a slot.
template <typename Ml, typename Fill>
__device__ __forceinline__ void produce_item(Fill& fill, const CUtensorMap* m1,
                                             const CUtensorMap* m2, int p, int nch) {
#pragma unroll 1
  for (int j = 0; j < nch; ++j) {
#pragma unroll 1
    for (int i = 0; i < Ml::KT1 * Ml::CG * Ml::NT1; ++i) {
      const int kt = i / (Ml::CG * Ml::NT1), gn = i % (Ml::CG * Ml::NT1);
      fill.load(m1, kt * 64, j * Ml::HC + (gn / Ml::NT1) * Ml::HS + (gn % Ml::NT1) * 64,
                Ml::TILE);
    }
#pragma unroll 1
    for (int i = 0; i < Ml::KT2 * Ml::CG * Ml::NT2; ++i) {
      const int kt = i / (Ml::CG * Ml::NT2), gn = i % (Ml::CG * Ml::NT2);
      fill.load(m2, j * Ml::HC + kt * 64,
                p * Ml::CP + (gn / Ml::NT2) * Ml::CS + (gn % Ml::NT2) * 64, Ml::TILE);
    }
  }
}

// produce_item where y is streamed (Ml::YS): a chunk's slots hold, K tile by K
// tile, y's [64 rows, 64] tile (rows row0.. of my, zero-filled past M) and the
// CG warpgroups' w1 tiles, then, n tile by n tile, the CG warpgroups' w2 tiles.
template <typename Ml, typename Fill>
__device__ __forceinline__ void produce_item_ys(Fill& fill, const CUtensorMap* m1,
                                                const CUtensorMap* m2, const CUtensorMap* my,
                                                int row0, int p, int nch) {
  constexpr int TILE = Ml::TILE;
#pragma unroll 1
  for (int j = 0; j < nch; ++j) {
#pragma unroll 1
    for (int kt = 0; kt < Ml::KT1; ++kt) {
      unsigned char* dst = fill.next((1 + Ml::CG) * TILE);
      sm90::tma_load_2d(dst, my, fill.bar(), kt * 64, row0);
      for (int g = 0; g < Ml::CG; ++g)
        sm90::tma_load_2d(dst + (1 + g) * TILE, m1, fill.bar(), kt * 64, j * Ml::HC + g * Ml::HS);
      fill.advance();
    }
#pragma unroll 1
    for (int i = 0; i < Ml::KT2 * Ml::NT2; ++i) {
      const int kt = i / Ml::NT2, n = i % Ml::NT2;
      unsigned char* dst = fill.next(Ml::CG * TILE);
      for (int g = 0; g < Ml::CG; ++g)
        sm90::tma_load_2d(dst + g * TILE, m2, fill.bar(), j * Ml::HC + kt * 64,
                          p * Ml::CP + g * Ml::CS + n * 64);
      fill.advance();
    }
  }
}

// Which phase of the caller's PhaseClocks each part of an item adds to.
template <int WAIT, int MMA, int H, int OUT>
struct ItemClocks {
  static constexpr int wait = WAIT, mma = MMA, h = H, out = OUT;
};

// h[:, chunk j] = T(gelu(T(T(acc1) + T(b1)))) of column group cg, swizzled
// into the chunk's h tile hb (the shared-h path, CG > 1)
template <typename Ml>
__device__ __forceinline__ void h_store(const float (&acc1)[Ml::NT1][32], unsigned char* hb,
                                        int cg, int j, const float* __restrict__ b1) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < Ml::NT1; ++n)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int c = cg * Ml::HS + n * 64 + (i / 4) * 8 + (lane % 4) * 2;  // in the chunk
      const int r = warp * 16 + lane / 4 + 8 * ((i / 2) % 2);
      const float2 bb = *reinterpret_cast<const float2*>(b1 + j * Ml::HC + c);
      *reinterpret_cast<uint32_t*>(hb + (c / 64) * Ml::TILE + sm90::sw128(r, c % 64)) =
          sm90::pack_bf16(bias_gelu(acc1[n][i], bb.x), bias_gelu(acc1[n][i + 1], bb.y));
    }
}

// out = T(res + T(T(T(acc2) + T(b2)) * T(ls))) at pass p's columns of column
// group cg, rows row0.. (row stride C), rows past M masked; a 64-column tile's
// residual pairs are all loaded before the first is used
template <typename Ml>
__device__ __forceinline__ void mlp_out(const float (&acc2)[Ml::NT2][32], int p, int cg,
                                        const float* __restrict__ b2,
                                        const float* __restrict__ ls, const bf16* res, bf16* out,
                                        long long row0, long long M) {
  constexpr int C = Ml::C;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < Ml::NT2; ++n) {
    uint32_t rv[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int cl = n * 64 + (i / 4) * 8 + (lane % 4) * 2;
      const long long row = row0 + warp * 16 + lane / 4 + 8 * ((i / 2) % 2);
      rv[i / 2] = 0u;
      if (cl < Ml::CS && row < M)
        rv[i / 2] = *reinterpret_cast<const uint32_t*>(
            res + (size_t)row * C + p * Ml::CP + cg * Ml::CS + cl);
    }
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int cl = n * 64 + (i / 4) * 8 + (lane % 4) * 2;
      const long long row = row0 + warp * 16 + lane / 4 + 8 * ((i / 2) % 2);
      if (cl < Ml::CS && row < M) {
        const int col = p * Ml::CP + cg * Ml::CS + cl;
        const float2 bb = *reinterpret_cast<const float2*>(b2 + col);
        float o0 = sm90::round_bf16(sm90::round_bf16(acc2[n][i]) + sm90::round_bf16(bb.x));
        float o1 = sm90::round_bf16(sm90::round_bf16(acc2[n][i + 1]) + sm90::round_bf16(bb.y));
        if (ls) {
          const float2 l = *reinterpret_cast<const float2*>(ls + col);
          o0 = sm90::round_bf16(o0 * sm90::round_bf16(l.x));
          o1 = sm90::round_bf16(o1 * sm90::round_bf16(l.y));
        }
        const float2 r =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv[i / 2]));
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * C + col) =
            __floats2bfloat162_rn(r.x + o0, r.y + o1);
      }
    }
  }
}

// One work item by one consumer warpgroup (column group cg of its row group):
// ys is this warpgroup's 64 rows of y, K tiles YK bytes apart; hs the row
// group's double-buffered h tile (CG > 1), shared through named barrier bar_id
// of bar_n threads, hbuf the count of chunks so far.  Rows row0.. of res and
// out (row stride C) at or past M are masked; res may be out itself (each
// thread reads its residual before it writes).
template <typename Ml, int YK, typename Ph, int B, int S, typename Clk>
__device__ __forceinline__ void mlp_item(sm90::Ring<B, S>& q, const unsigned char* ys,
                                         unsigned char* hs, uint32_t& hbuf, int cg, int bar_id,
                                         int bar_n, int nch, int p, const float* __restrict__ b1,
                                         const float* __restrict__ b2,
                                         const float* __restrict__ ls, const bf16* res, bf16* out,
                                         long long row0, long long M, Clk& clk) {
  constexpr int TILE = Ml::TILE;
  const int lane = threadIdx.x % 32;
  float acc2[Ml::NT2][32];
#pragma unroll
  for (int n = 0; n < Ml::NT2; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc2[n][i] = 0.0f;

#pragma unroll 1
  for (int j = 0; j < nch; ++j) {
    // h[:, chunk] = y @ w1[:, chunk]
    float acc1[Ml::NT1][32];
#pragma unroll
    for (int n = 0; n < Ml::NT1; ++n) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc1[n][i] = 0.0f;
      sm90::reg_fence(acc1[n]);
    }
    // a K tile's slots hold every warpgroup's n tiles in turn: skip the others'
#pragma unroll
    for (int kt = 0; kt < Ml::KT1; ++kt) {
      const uint64_t da = sm90::desc_sw128(ys + kt * YK);
      clk.template lap<Ph::mma>();
      sm90::ring_skip(q, cg * Ml::NT1);
      clk.template lap<Ph::wait>();
#pragma unroll
      for (int n = 0; n < Ml::NT1; ++n) {
        clk.template lap<Ph::mma>();
        unsigned char* b = sm90::ring_take(q);
        clk.template lap<Ph::wait>();
        const uint64_t db = sm90::desc_sw128(b);
        sm90::reg_fence(acc1[n]);
        sm90::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          if (kt * 4 + ks < Ml::KS1)
            sm90::wgmma_ss_n64(acc1[n], sm90::desc_step(da, ks), sm90::desc_step(db, ks), 1);
        sm90::wgmma_commit();
        sm90::ring_used(q);
        sm90::reg_fence(acc1[n]);
        sm90::ring_next(q);
      }
      clk.template lap<Ph::mma>();
      sm90::ring_skip(q, (Ml::CG - 1 - cg) * Ml::NT1);
      clk.template lap<Ph::wait>();
    }
    sm90::ring_drain(q);
    clk.template lap<Ph::mma>();
#pragma unroll
    for (int n = 0; n < Ml::NT1; ++n) sm90::reg_fence(acc1[n]);

    // the bias and GELU epilogue, then acc2 += h[:, chunk] @ w2[chunk, :]
    const int colh = j * Ml::HC + cg * Ml::HS;  // this warpgroup's first hidden column
    if constexpr (Ml::HREG) {
      uint32_t ha[Ml::NT1 * 4][4];
#pragma unroll
      for (int n = 0; n < Ml::NT1; ++n)
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int col = colh + n * 64 + (i / 4) * 8 + (lane % 4) * 2;
          const float2 bb = *reinterpret_cast<const float2*>(b1 + col);
          ha[n * 4 + i / 8][(i % 8) / 2] =
              sm90::pack_bf16(bias_gelu(acc1[n][i], bb.x), bias_gelu(acc1[n][i + 1], bb.y));
        }
      sm90::reg_fence(ha);
      clk.template lap<Ph::h>();
#pragma unroll
      for (int n = 0; n < Ml::NT2; ++n) sm90::reg_fence(acc2[n]);
#pragma unroll
      for (int kt = 0; kt < Ml::KT2; ++kt)
#pragma unroll
        for (int n = 0; n < Ml::NT2; ++n) {
          clk.template lap<Ph::mma>();
          unsigned char* b = sm90::ring_take(q);
          clk.template lap<Ph::wait>();
          const uint64_t db = sm90::desc_sw128(b);
          sm90::reg_fence(acc2[n]);
          sm90::wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            if (n < Ml::NT2 - 1 || Ml::LW == 64)
              sm90::wgmma_rs_n64(acc2[n], ha[kt * 4 + ks], sm90::desc_step(db, ks), 1);
            else
              sm90::wgmma_rs_n32(acc2[n], ha[kt * 4 + ks], sm90::desc_step(db, ks), 1);
          }
          sm90::wgmma_commit();
          sm90::ring_used(q);
          sm90::reg_fence(acc2[n]);
          sm90::ring_next(q);
        }
      sm90::ring_drain(q);
      clk.template lap<Ph::mma>();
      sm90::reg_fence(ha);
    } else {
      unsigned char* hb = hs + (size_t)(hbuf & 1u) * Ml::KT2 * TILE;
      h_store<Ml>(acc1, hb, cg, j, b1);
      sm90::fence_async_smem();
      sm90::named_sync(bar_id, bar_n);  // the chunk's h, whole
      clk.template lap<Ph::h>();
#pragma unroll
      for (int n = 0; n < Ml::NT2; ++n) sm90::reg_fence(acc2[n]);
#pragma unroll
      for (int kt = 0; kt < Ml::KT2; ++kt) {
        const uint64_t da = sm90::desc_sw128(hb + kt * TILE);
        clk.template lap<Ph::mma>();
        sm90::ring_skip(q, cg * Ml::NT2);
        clk.template lap<Ph::wait>();
#pragma unroll
        for (int n = 0; n < Ml::NT2; ++n) {
          clk.template lap<Ph::mma>();
          unsigned char* b = sm90::ring_take(q);
          clk.template lap<Ph::wait>();
          const uint64_t db = sm90::desc_sw128(b);
          sm90::reg_fence(acc2[n]);
          sm90::wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            sm90::wgmma_ss_n64(acc2[n], sm90::desc_step(da, ks), sm90::desc_step(db, ks), 1);
          sm90::wgmma_commit();
          sm90::ring_used(q);
          sm90::reg_fence(acc2[n]);
          sm90::ring_next(q);
        }
        // a ring of at most NT2 + 1 slots (K4 at C = 1024): the slot this
        // warpgroup still holds is the one the producer fills for its next
        // take, so it goes back before the other warpgroup's tiles are passed
        if constexpr (S <= Ml::NT2 + 1) sm90::ring_drain(q);
        clk.template lap<Ph::mma>();
        sm90::ring_skip(q, (Ml::CG - 1 - cg) * Ml::NT2);
        clk.template lap<Ph::wait>();
      }
      sm90::ring_drain(q);
      clk.template lap<Ph::mma>();
      ++hbuf;
    }
#pragma unroll
    for (int n = 0; n < Ml::NT2; ++n) sm90::reg_fence(acc2[n]);
  }

  mlp_out<Ml>(acc2, p, cg, b2, ls, res, out, row0, M);
  clk.template lap<Ph::out>();
}

// mlp_item where y is streamed (Ml::YS, one row group of 64 rows, two column
// groups): each first-product slot holds y's K tile at its start and the
// column groups' w1 tiles after it, each second-product slot the column
// groups' w2 tiles, so both warpgroups take every slot and read their part.
// The h tile is shared as in mlp_item's shared-h path.
template <typename Ml, typename Ph, int B, int S, typename Clk>
__device__ __forceinline__ void mlp_item_ys(sm90::Ring<B, S>& q, unsigned char* hs,
                                            uint32_t& hbuf, int cg, int bar_id, int bar_n,
                                            int nch, int p, const float* __restrict__ b1,
                                            const float* __restrict__ b2,
                                            const float* __restrict__ ls, const bf16* res,
                                            bf16* out, long long row0, long long M, Clk& clk) {
  constexpr int TILE = Ml::TILE;
  static_assert(Ml::YS && B >= Ml::SLOT, "the streamed-y ring");
  float acc2[Ml::NT2][32];
#pragma unroll
  for (int n = 0; n < Ml::NT2; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc2[n][i] = 0.0f;

#pragma unroll 1
  for (int j = 0; j < nch; ++j) {
    // h[:, chunk] = y @ w1[:, chunk], y's K tiles from the ring
    float acc1[1][32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc1[0][i] = 0.0f;
    sm90::reg_fence(acc1[0]);
#pragma unroll 1
    for (int kt = 0; kt < Ml::KT1; ++kt) {
      clk.template lap<Ph::mma>();
      unsigned char* b = sm90::ring_take(q);
      clk.template lap<Ph::wait>();
      const uint64_t da = sm90::desc_sw128(b);
      const uint64_t db = sm90::desc_sw128(b + (1 + cg) * TILE);
      sm90::reg_fence(acc1[0]);
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        sm90::wgmma_ss_n64(acc1[0], sm90::desc_step(da, ks), sm90::desc_step(db, ks), 1);
      sm90::wgmma_commit();
      sm90::ring_used(q);
      sm90::reg_fence(acc1[0]);
      sm90::ring_next(q);
    }
    sm90::ring_drain(q);
    clk.template lap<Ph::mma>();
    sm90::reg_fence(acc1[0]);

    // the bias and GELU epilogue into the shared h tile, then acc2 += h @ w2[chunk, :]
    unsigned char* hb = hs + (size_t)(hbuf & 1u) * Ml::KT2 * TILE;
    h_store<Ml>(acc1, hb, cg, j, b1);
    sm90::fence_async_smem();
    sm90::named_sync(bar_id, bar_n);  // the chunk's h, whole
    clk.template lap<Ph::h>();
#pragma unroll
    for (int n = 0; n < Ml::NT2; ++n) sm90::reg_fence(acc2[n]);
#pragma unroll
    for (int kt = 0; kt < Ml::KT2; ++kt) {
      const uint64_t da = sm90::desc_sw128(hb + kt * TILE);
#pragma unroll
      for (int n = 0; n < Ml::NT2; ++n) {
        clk.template lap<Ph::mma>();
        unsigned char* b = sm90::ring_take(q);
        clk.template lap<Ph::wait>();
        const uint64_t db = sm90::desc_sw128(b + cg * TILE);
        sm90::reg_fence(acc2[n]);
        sm90::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          sm90::wgmma_ss_n64(acc2[n], sm90::desc_step(da, ks), sm90::desc_step(db, ks), 1);
        sm90::wgmma_commit();
        sm90::ring_used(q);
        sm90::reg_fence(acc2[n]);
        sm90::ring_next(q);
      }
    }
    sm90::ring_drain(q);
    clk.template lap<Ph::mma>();
    ++hbuf;
#pragma unroll
    for (int n = 0; n < Ml::NT2; ++n) sm90::reg_fence(acc2[n]);
  }
  mlp_out<Ml>(acc2, p, cg, b2, ls, res, out, row0, M);
  clk.template lap<Ph::out>();
}

}  // namespace mlp90
}  // namespace
