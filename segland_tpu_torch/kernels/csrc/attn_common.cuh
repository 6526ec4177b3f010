// Device code shared by the Swin attention kernels: the shapes, the token
// geometry and the fp32 bodies (exact FMA loops) of K3, K4 and K5.  The WMMA pieces (K3-K5's attention core) are attn_wmma.cuh;
// the wgmma section body of K3, K4 and K5 is section_sm90.cuh.  Everything
// lives in an anonymous namespace, so each source gets its own copy.
//
// Shapes: windows of N = 49 tokens (7 x 7), heads of 32 channels, 8 warps a
// block.  T is bf16 or fp32.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kN = 49;      // tokens a window (7 x 7)
constexpr int kHD = 32;     // head dim
constexpr int kLQ = 48;     // row stride of the q/k/v buffers: every row 32-byte aligned
constexpr int kLS = 68;     // row stride of a score strip, floats
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStrip = 16 * kLS;  // floats in one warp's strip
constexpr size_t kMaxSmem = 232448;  // shared memory a block can have on sm_90

struct Geom {
  int h, w, hp, wp, ws, shift;
};

__device__ __forceinline__ float bf(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

// Pad-token mask and shift-region id of token `tok` of window `win` (the
// batch is folded into the window index), as _pad_token_mask and
// _shift_regions of the backbone give them.
__device__ __forceinline__ void token_geom(int win, int tok, const Geom& g, int* valid,
                                           int* rid) {
  const int wn = g.wp / g.ws;
  const int wr = (win / wn) % (g.hp / g.ws);
  const int wc = win % wn;
  const int grh = wr * g.ws + tok / g.ws;  // rolled coordinates
  const int gwc = wc * g.ws + tok % g.ws;
  int oh = grh + g.shift;  // un-roll with wraparound
  if (oh >= g.hp) oh -= g.hp;
  int ow = gwc + g.shift;
  if (ow >= g.wp) ow -= g.wp;
  *valid = (oh < g.h && ow < g.w) ? 1 : 0;
  int r = 0;
  if (g.shift > 0) {
    const int rh = (grh >= g.hp - g.ws) + (grh >= g.hp - g.shift);
    const int rc = (gwc >= g.wp - g.ws) + (gwc >= g.wp - g.shift);
    r = 3 * rh + rc;
  }
  *rid = r;
}

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }
__host__ __device__ constexpr size_t max_size(size_t a, size_t b) { return a > b ? a : b; }

// ---- fp32: exact FMA loops --------------------------------------------------
constexpr int kLQF = kHD + 1;  // q/k/v row stride, floats
constexpr int kLSF = kN + 1;   // score row stride
constexpr int kRowsA = 25;  // rows a thread accumulates in the fp32 qkv product
constexpr int kRowsP = 7;   // rows a pass of the fp32 projection

// One head of one window by the whole block.  q, k, v: [N, kLQF]; S: [N, kLSF].
__device__ void attn_head_f32(const float* q, const float* k, const float* v, float* S,
                              const float* __restrict__ bias, const uint8_t* rid, float scale,
                              float* sink, size_t ld) {
  const int nthr = blockDim.x;
  for (int idx = threadIdx.x; idx < kN * kN; idx += nthr) {
    const int i = idx / kN, j = idx % kN;
    float s = 0.0f;
#pragma unroll
    for (int d = 0; d < kHD; ++d) s += q[i * kLQF + d] * k[j * kLQF + d];
    s = s * scale + bias[idx];
    if (rid && rid[i] != rid[j]) s += -100.0f;
    S[i * kLSF + j] = s;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarp = nthr / 32;
  for (int i = warp; i < kN; i += nwarp) {
    const int c1 = lane + 32;
    const float v0 = S[i * kLSF + lane];
    const float v1 = c1 < kN ? S[i * kLSF + c1] : -INFINITY;
    const float m = warp_max(fmaxf(v0, v1));
    const float e0 = expf(v0 - m), e1 = c1 < kN ? expf(v1 - m) : 0.0f;
    const float sum = warp_sum(e0 + e1);
    S[i * kLSF + lane] = e0 / sum;
    if (c1 < kN) S[i * kLSF + c1] = e1 / sum;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kN * kHD; idx += nthr) {
    const int i = idx / kHD, d = idx % kHD;
    float a = 0.0f;
    for (int j = 0; j < kN; ++j) a += S[i * kLSF + j] * v[j * kLQF + d];
    sink[(size_t)i * ld + d] = a;
  }
  __syncthreads();
}

// One warp a row of C floats: dst = (LN(src) * gamma + beta) * m.
__device__ __forceinline__ void ln_row_f32(const float* src, int C,
                                           const float* __restrict__ gamma,
                                           const float* __restrict__ beta, float eps, float m,
                                           float* dst) {
  const int lane = threadIdx.x % 32;
  float s = 0.0f, ss = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float v = src[c];
    s += v;
    ss += v * v;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = s / C;
  const float var = fmaxf(ss / C - mu * mu, 0.0f);
  const float rs = rsqrtf(var + eps);
  for (int c = lane; c < C; c += 32) dst[c] = (((src[c] - mu) * rs) * gamma[c] + beta[c]) * m;
}

// q, k, v of head h for the 49 rows of ys [N, C]: threads 0..191 take one of
// the 96 columns and 25 rows each.  dst(which, row, d, value) stores.
template <typename Store>
__device__ __forceinline__ void qkv_head_f32(const float* ys, int C, int h,
                                             const float* __restrict__ wqkv,
                                             const float* __restrict__ bqkv, Store dst) {
  if (threadIdx.x < 192) {
    const int j = threadIdx.x % 96, grp = threadIdx.x / 96;
    const int which = j / kHD, d = j % kHD;
    const int col = which * C + h * kHD + d;
    const int r0 = grp * kRowsA;
    float acc[kRowsA];
#pragma unroll
    for (int i = 0; i < kRowsA; ++i) acc[i] = 0.0f;
    for (int k = 0; k < C; ++k) {
      const float wv = wqkv[(size_t)k * 3 * C + col];
#pragma unroll
      for (int i = 0; i < kRowsA; ++i) {
        const int r = r0 + i < kN ? r0 + i : kN - 1;
        acc[i] += ys[r * C + k] * wv;
      }
    }
    const float b = bqkv[col];
#pragma unroll
    for (int i = 0; i < kRowsA; ++i)
      if (r0 + i < kN) dst(which, r0 + i, d, acc[i] + b);
  }
}

// sink(row, c, value) for rows r0.. of T(ctx rows @ wproj + bproj), the ctx
// rows already in rowbuf [kRowsP, C].
template <typename Sink>
__device__ __forceinline__ void proj_rows_f32(const float* rowbuf, int C,
                                              const float* __restrict__ wproj,
                                              const float* __restrict__ bproj, int r0,
                                              Sink sink) {
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float acc[kRowsP];
#pragma unroll
    for (int i = 0; i < kRowsP; ++i) acc[i] = 0.0f;
    for (int k = 0; k < C; ++k) {
      const float wv = wproj[(size_t)k * C + c];
#pragma unroll
      for (int i = 0; i < kRowsP; ++i) acc[i] += rowbuf[i * C + k] * wv;
    }
    const float b = bproj[c];
#pragma unroll
    for (int i = 0; i < kRowsP; ++i) sink(r0 + i, c, acc[i] + b);
  }
}

// Shared memory of the fp32 section of one window, in floats: ys [N, C],
// q/k/v 3 x [N, kLQF], S [N, kLSF], rowbuf [kRowsP, C], then N region ids.
__host__ __device__ constexpr size_t section_f32_floats(int C) {
  return (size_t)kN * C + 3 * kN * kLQF + kN * kLSF + (size_t)kRowsP * C;
}

// The attention section with index-math masks of window `win`, fp32, by the
// whole block.  ctx is kept in the window's rows `ow` of the output buffer
// until the projection has read it; sink(row, c, x + proj) takes the result.
template <typename Sink>
__device__ __forceinline__ void section_f32(
    const float* __restrict__ xw, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ wqkv,
    const float* __restrict__ bqkv, const float* __restrict__ wproj,
    const float* __restrict__ bproj, const float* __restrict__ bias, float* ow, int C,
    long long win, const Geom& g, float eps, unsigned char* smem, Sink sink) {
  float* ys = reinterpret_cast<float*>(smem);  // [N, C]
  float* qs = ys + kN * C;                     // 3 x [N, kLQF]
  float* S = qs + 3 * kN * kLQF;               // [N, kLSF]
  float* rowbuf = S + kN * kLSF;               // [kRowsP, C]
  uint8_t* rids = reinterpret_cast<uint8_t*>(rowbuf + kRowsP * C);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nh = C / kHD;
  const float scale = rsqrtf((float)kHD);

  for (int r = warp; r < kN; r += kWarps) {
    int valid, rid;
    token_geom((int)win, r, g, &valid, &rid);
    if (lane == 0) rids[r] = (uint8_t)rid;
    ln_row_f32(xw + (size_t)r * C, C, gamma, beta, eps, valid ? 1.0f : 0.0f, ys + r * C);
  }
  __syncthreads();

  for (int h = 0; h < nh; ++h) {
    qkv_head_f32(ys, C, h, wqkv, bqkv, [&](int which, int row, int d, float v) {
      qs[which * kN * kLQF + row * kLQF + d] = v;
    });
    __syncthreads();
    attn_head_f32(qs, qs + kN * kLQF, qs + 2 * kN * kLQF, S, bias + (size_t)h * kN * kN,
                  g.shift > 0 ? rids : nullptr, scale, ow + h * kHD, (size_t)C);
  }

  for (int r0 = 0; r0 < kN; r0 += kRowsP) {
    for (int i = threadIdx.x; i < kRowsP * C; i += kThreads) rowbuf[i] = ow[(size_t)r0 * C + i];
    __syncthreads();
    proj_rows_f32(rowbuf, C, wproj, bproj, r0, [&](int row, int c, float v) {
      sink(row, c, xw[(size_t)row * C + c] + v);
    });
    __syncthreads();
  }
}

// ---- fp32, y streamed (C >= 1024, where y [N, C] does not fit) ---------------
constexpr int kKC = 64;  // y's columns a chunk

// Shared memory of the streamed fp32 section, in floats: a chunk of y [N, kKC],
// q/k/v 3 x [N, kLQF], S [N, kLSF], rowbuf [kRowsP, C], each row's mean,
// 1/std and mask, then N region ids.
__host__ __device__ constexpr size_t section_f32_stream_floats(int C) {
  return (size_t)kN * kKC + 3 * kN * kLQF + kN * kLSF + (size_t)kRowsP * C + 3 * kN;
}

// qkv_head_f32 with y made a chunk of kKC columns at a time from the rows'
// statistics (stats: mean, 1/std, mask, kN each), the same values and the same
// k order as y held whole
template <typename Store>
__device__ __forceinline__ void qkv_head_f32_stream(const float* __restrict__ xw, int C, int h,
                                                    const float* __restrict__ gamma,
                                                    const float* __restrict__ beta,
                                                    const float* stats, float* ych,
                                                    const float* __restrict__ wqkv,
                                                    const float* __restrict__ bqkv, Store dst) {
  const int j = threadIdx.x % 96, grp = threadIdx.x / 96;
  const int which = j / kHD, d = j % kHD;
  const int col = which * C + h * kHD + d;
  const int r0 = grp * kRowsA;
  float acc[kRowsA];
#pragma unroll
  for (int i = 0; i < kRowsA; ++i) acc[i] = 0.0f;
  for (int k0 = 0; k0 < C; k0 += kKC) {
    __syncthreads();  // the chunk before is read
    for (int i = threadIdx.x; i < kN * kKC; i += blockDim.x) {
      const int r = i / kKC, c = k0 + i % kKC;
      ych[i] = (((xw[(size_t)r * C + c] - stats[r]) * stats[kN + r]) * gamma[c] + beta[c]) *
               stats[2 * kN + r];
    }
    __syncthreads();
    if (threadIdx.x < 192) {
      for (int k = 0; k < kKC; ++k) {
        const float wv = wqkv[(size_t)(k0 + k) * 3 * C + col];
#pragma unroll
        for (int i = 0; i < kRowsA; ++i) {
          const int r = r0 + i < kN ? r0 + i : kN - 1;
          acc[i] += ych[r * kKC + k] * wv;
        }
      }
    }
  }
  if (threadIdx.x < 192) {
    const float b = bqkv[col];
#pragma unroll
    for (int i = 0; i < kRowsA; ++i)
      if (r0 + i < kN) dst(which, r0 + i, d, acc[i] + b);
  }
}

// section_f32 with y streamed: each row's statistics once, y a chunk at a time
// in every head's q, k, v product
template <typename Sink>
__device__ __forceinline__ void section_f32_stream(
    const float* __restrict__ xw, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ wqkv,
    const float* __restrict__ bqkv, const float* __restrict__ wproj,
    const float* __restrict__ bproj, const float* __restrict__ bias, float* ow, int C,
    long long win, const Geom& g, float eps, unsigned char* smem, Sink sink) {
  float* ych = reinterpret_cast<float*>(smem);  // [N, kKC]
  float* qs = ych + kN * kKC;                    // 3 x [N, kLQF]
  float* S = qs + 3 * kN * kLQF;                 // [N, kLSF]
  float* rowbuf = S + kN * kLSF;                 // [kRowsP, C]
  float* stats = rowbuf + kRowsP * C;            // mean, 1/std, mask
  uint8_t* rids = reinterpret_cast<uint8_t*>(stats + 3 * kN);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nh = C / kHD;
  const float scale = rsqrtf((float)kHD);

  for (int r = warp; r < kN; r += kWarps) {
    int valid, rid;
    token_geom((int)win, r, g, &valid, &rid);
    const float* src = xw + (size_t)r * C;
    float s = 0.0f, ss = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float v = src[c];
      s += v;
      ss += v * v;
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / C;
    const float var = fmaxf(ss / C - mu * mu, 0.0f);
    if (lane == 0) {
      rids[r] = (uint8_t)rid;
      stats[r] = mu;
      stats[kN + r] = rsqrtf(var + eps);
      stats[2 * kN + r] = valid ? 1.0f : 0.0f;
    }
  }

  for (int h = 0; h < nh; ++h) {
    qkv_head_f32_stream(xw, C, h, gamma, beta, stats, ych, wqkv, bqkv,
                        [&](int which, int row, int d, float v) {
                          qs[which * kN * kLQF + row * kLQF + d] = v;
                        });
    __syncthreads();
    attn_head_f32(qs, qs + kN * kLQF, qs + 2 * kN * kLQF, S, bias + (size_t)h * kN * kN,
                  g.shift > 0 ? rids : nullptr, scale, ow + h * kHD, (size_t)C);
  }

  for (int r0 = 0; r0 < kN; r0 += kRowsP) {
    for (int i = threadIdx.x; i < kRowsP * C; i += kThreads) rowbuf[i] = ow[(size_t)r0 * C + i];
    __syncthreads();
    proj_rows_f32(rowbuf, C, wproj, bproj, r0, [&](int row, int c, float v) {
      sink(row, c, xw[(size_t)row * C + c] + v);
    });
    __syncthreads();
  }
}

}  // namespace
