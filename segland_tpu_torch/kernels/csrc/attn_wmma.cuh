// The WMMA pieces of the Swin attention kernels: the fragment types (K5's
// super-window walk uses them too) and the attention core of K3, K4 and K5
// (attn_tile_bf16).  Everything lives in an anonymous namespace, so each
// source gets its own copy.

#pragma once

#include <mma.h>

#include "attn_common.cuh"

using namespace nvcuda;

namespace {

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// ---- the per-head core, bf16: one warp, 16 query rows of one window -------
// q, k, v: row 0 of the window, [>= 64 rows, kLQ]; rows 49..63 finite.
// bias: this head's [N, N] fp32, in shared memory.  rid: the window's N region ids, or null.
// sink: row 0 of the window's output at this head's column, row stride ld.
// OPAQUE: the rotation opaque to the compiler, so that the column offsets and
// masks derived from it are not hoisted out of the caller's head loop, where
// they held registers across the products (K4 at C = 128 spilled 12-16 B).
template <bool OPAQUE = false>
__device__ __forceinline__ void attn_tile_bf16(const bf16* q, const bf16* k, const bf16* v,
                                               int rt, const float* bias,
                                               const uint8_t* rid, float scale, float* strip,
                                               bf16* sink, size_t ld) {
  const int lane = threadIdx.x % 32;
  {
    FragC s[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(s[j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < kHD / 16; ++kk) {
      FragA a;
      wmma::load_matrix_sync(a, q + rt * 16 * kLQ + kk * 16, kLQ);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragBT b;
        wmma::load_matrix_sync(b, k + j * 16 * kLQ + kk * 16, kLQ);
        wmma::mma_sync(s[j], a, b, s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(strip + j * 16, s[j], kLS, wmma::mem_row_major);
  }
  __syncwarp();
  // softmax over the 49 real keys, two lanes a row (32 columns each, read in
  // an order rotated by row and half so that no two lanes meet in a bank);
  // the probabilities go as bf16 over the row's own scores (row stride
  // 2 * kLS bf16) once every lane holds its scores in registers
  bf16* p = reinterpret_cast<bf16*>(strip);
  {
    const int r = lane >> 1, hf = lane & 1;
    const int qi = rt * 16 + r;
    int rot = hf + 2 * (r >> 3);  // bank = (4 * (r & 7) + rot + c) % 32, all distinct
    if constexpr (OPAQUE) asm volatile("" : "+r"(rot));
    const bool live = qi < kN;
    const float* srow = strip + r * kLS + hf * 32;
    const float* brow = bias + (live ? qi : 0) * kN + hf * 32;
    const int rq = (rid && live) ? (rid[qi] & 127) : 0;
    float e[32];
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = (c + rot) & 31;
      float v = -INFINITY;
      if (live && hf * 32 + col < kN) {
        v = srow[col] * scale + brow[col];
        if (rid && (rid[hf * 32 + col] & 127) != rq) v += -100.0f;
      }
      e[c] = v;
      m = fmaxf(m, v);
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      e[c] = live ? __expf(e[c] - m) : 0.0f;
      sum += e[c];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float inv = live ? 1.0f / sum : 0.0f;
    __syncwarp();  // every score is in a register: the rows may be overwritten
    bf16* prow = p + r * 2 * kLS + hf * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) prow[(c + rot) & 31] = __float2bfloat16(e[c] * inv);
  }
  __syncwarp();
  FragC o[2];
  wmma::fill_fragment(o[0], 0.0f);
  wmma::fill_fragment(o[1], 0.0f);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    FragA a;
    wmma::load_matrix_sync(a, p + kk * 16, 2 * kLS);
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      FragB b;
      wmma::load_matrix_sync(b, v + kk * 16 * kLQ + f * 16, kLQ);
      wmma::mma_sync(o[f], a, b, o[f]);
    }
  }
  __syncwarp();  // every lane has loaded its probabilities: the strip is free
  wmma::store_matrix_sync(strip, o[0], kLS, wmma::mem_row_major);
  wmma::store_matrix_sync(strip + 16, o[1], kLS, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 16 * kHD; e += 32) {
    const int r = e / kHD, d = e % kHD;
    const int qi = rt * 16 + r;
    if (qi < kN) sink[(size_t)qi * ld + d] = __float2bfloat16(strip[r * kLS + d]);
  }
  __syncwarp();
}

}  // namespace
