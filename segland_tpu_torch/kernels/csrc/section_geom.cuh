// K3's section with its masks from the window index and the WMMA attention
// core (attn_wmma.cuh): K3's body and K4's first half.

#pragma once

#include "attn_wmma.cuh"
#include "section_sm90.cuh"

namespace {

// section_rows with K3's masks: the region id and pad flag (bit 7) of every
// token from the window index, a pad token's row zero, and K3's attention core
// (16 query rows of one window a warp); K3's section and K4's first half.
// OPAQUE: attn_tile_bf16's opaque rotation.
// Pl::YS: the context goes to ctx and y to ysg (the block's scratch rows,
// announced on `ready`), as section_rows says.
template <typename Pl, bool OPAQUE = false, typename Clk>
__device__ __forceinline__ void geom_section(sm90::Ring<Pl::SLOT, Pl::S>& q, unsigned char* smem,
                                             const bf16* x, bf16* out, int rows, long long win0,
                                             const Geom& geo, const float* __restrict__ gamma,
                                             const float* __restrict__ beta,
                                             const float* __restrict__ bqkv,
                                             const float* __restrict__ bproj,
                                             const float* __restrict__ bias, float eps, Clk& clk,
                                             bf16* ctx = nullptr, bf16* ysg = nullptr,
                                             uint64_t* ready = nullptr) {
  uint8_t* rids = smem + Pl::OFF_TOK;
  bf16* cdst = Pl::YS ? ctx : out;  // where the attention core writes the context
  section_rows<Pl>(
      q, smem, x, out, rows, gamma, beta, bqkv, bproj, bias, eps,
      [&] {
        for (int i = threadIdx.x; i < Pl::R; i += 256) {
          int valid = 0, rid = 0;
          if (i < rows) token_geom((int)win0 + i / kN, i % kN, geo, &valid, &rid);
          rids[i] = (uint8_t)(rid | (valid ? 0 : 128));
        }
      },
      [&](int r) -> const bf16* {
        int valid = 0, rid = 0;
        token_geom((int)win0 + r / kN, r % kN, geo, &valid, &rid);
        return valid ? x + (size_t)r * Pl::C : nullptr;
      },
      sm90::Unscaled(),
      [&](int h, const bf16* qb, const bf16* kb, const bf16* vb, const float* bias_s,
          float* strips) {
        const int cw = threadIdx.x / 32;
        for (int u = cw; u < Pl::W * 4; u += kWarps) {
          const int wl = u / 4, rt = u % 4;
          if (wl >= rows / kN) continue;
          const int r0 = wl * kN;
          attn_tile_bf16<OPAQUE>(qb + r0 * kLQ, kb + r0 * kLQ, vb + r0 * kLQ, rt, bias_s,
                         geo.shift > 0 ? rids + r0 : nullptr, rsqrtf((float)kHD),
                         strips + cw * kStrip, cdst + (size_t)r0 * Pl::C + h * kHD, (size_t)Pl::C);
        }
      },
      clk, ysg, ready);
}

}  // namespace
