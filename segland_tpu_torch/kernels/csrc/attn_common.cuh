// Device code shared by the Swin attention kernels: attn_section.cu (the
// attention section with index-math masks, and the window-attention core),
// swin_block.cu (the whole block) and attn_section_v1.cu (the section with
// shipped masks and super-window grouping).  Everything lives in an
// anonymous namespace, so each source gets its own copy.
//
// Shapes: windows of N = 49 tokens (7 x 7), heads of 32 channels, 8 warps a
// block.  T is bf16 or fp32.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kN = 49;      // tokens a window (7 x 7)
constexpr int kHD = 32;     // head dim
constexpr int kLQ = 48;     // row stride of the q/k/v buffers: every row 32-byte aligned
constexpr int kLS = 68;     // row stride of a score strip, floats
constexpr int kLDB = 104;   // row stride of a staged weight chunk (96 + 8)
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

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }
__host__ __device__ constexpr size_t max_size(size_t a, size_t b) { return a > b ? a : b; }

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// ---- the per-head core, bf16: one warp, 16 query rows of one window -------
// q, k, v: row 0 of the window, [>= 64 rows, kLQ]; rows 49..63 finite.
// bias: this head's [N, N] fp32, in shared memory.  rid: the window's N region ids, or null.
// sink: row 0 of the window's output at this head's column, row stride ld.
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
    const int rot = hf + 2 * (r >> 3);  // bank = (4 * (r & 7) + rot + c) % 32, all distinct
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

// ---- the section's products, bf16 -------------------------------------------
// W windows a block; P splits a row tile's 96 output columns over P warps;
// KC weight rows a staged chunk; S chunk buffers in the ring.
template <int C, int W, int P, int KC, int S>
struct SecCfg {
  static constexpr int R = W * kN;              // real rows
  static constexpr int RT = (R + 15) / 16;      // row tiles
  static constexpr int UNITS = RT * P;
  static constexpr int ROUNDS = (UNITS + kWarps - 1) / kWarps;
  static constexpr int NFR = 6 / P;             // fragments a unit
  static constexpr int LDY = C + 8;
  static constexpr int RQ = RT * 16 + 16;       // q/k/v rows: the last window's tile reaches R + 14
  static constexpr int NH = C / kHD;
  static constexpr size_t Y_BYTES = align128((size_t)R * LDY * sizeof(bf16));
  static constexpr size_t OFF_CTX = Y_BYTES;
  static constexpr size_t OFF_Q = 2 * Y_BYTES;
  static constexpr size_t Q_BYTES = align128((size_t)RQ * kLQ * sizeof(bf16));
  static constexpr size_t OFF_STRIP = OFF_Q + 3 * Q_BYTES;
  static constexpr int NSTRIP = 4 * W < kWarps ? 4 * W : kWarps;  // attention tiles at once
  static constexpr size_t OFF_STAGE = OFF_STRIP + (size_t)NSTRIP * kStrip * sizeof(float);
  static_assert(NSTRIP * kStrip >= kWarps * 256, "every warp needs a 16 x 16 scratch tile");
  static constexpr size_t STAGE_ELEMS = align128((size_t)KC * kLDB * sizeof(bf16)) / sizeof(bf16);
  static constexpr size_t OFF_BIAS = OFF_STAGE + S * STAGE_ELEMS * sizeof(bf16);
  static constexpr size_t OFF_TOK = OFF_BIAS + align128((size_t)kN * kN * sizeof(float));
  static constexpr int NCH = C / KC;            // chunks a product
  static constexpr int NCALL = NH + C / 96;     // products: one a head, then the projection's
  static_assert(S >= 2, "the ring needs two buffers");
  static constexpr size_t SMEM = OFF_TOK + align128(R);
  static_assert(C % KC == 0 && KC % 16 == 0, "chunks must tile C");
  static_assert(C % 96 == 0, "the projection walks 96 columns a pass");
  static_assert(6 % P == 0 && kWarps % P == 0, "P must split 6 fragments and the warps");
  static_assert(OFF_CTX + (size_t)RT * 16 * LDY * sizeof(bf16) <= SMEM,
                "a row tile past ctx must stay inside the block's shared memory");
  static_assert(SMEM <= kMaxSmem, "over the shared memory a block can have");
};

__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, int ldb, int k0,
                                           int c0, int c1, int c2, int kc) {
  for (int i = threadIdx.x; i < kc * 12; i += kThreads) {
    const int r = i / 12, piece = i % 12;
    const int blk = piece / 4, off = (piece % 4) * 8;
    const int col = (blk == 0 ? c0 : (blk == 1 ? c1 : c2)) + off;
    cp_async16(dst + r * kLDB + blk * 32 + off, src + (size_t)(k0 + r) * ldb + col);
  }
}

// A block's weight stream: `total` chunks of KC rows; chunk g belongs to
// product call0 + (g / NCH) % ncall, where products 0..NH-1 are a head's q,
// k, v columns of wqkv and NH.. are 96 columns of wproj a pass.
struct Stream {
  int total, call0, ncall;
};

// Chunk g of the stream into its ring buffer.  Always commits a group, empty
// past the end, so that cp.async.wait_group counts the same at every step.
template <int C, int KC, int S, typename Cf>
__device__ __forceinline__ void fetch_chunk(int g, const Stream& st, bf16* stage,
                                            const bf16* __restrict__ wqkv,
                                            const bf16* __restrict__ wproj) {
  if (g < st.total) {
    const int call = st.call0 + (g / Cf::NCH) % st.ncall, k0 = (g % Cf::NCH) * KC;
    bf16* dst = stage + (g % S) * Cf::STAGE_ELEMS;
    if (call < Cf::NH) {
      stage_rows(dst, wqkv, 3 * C, k0, call * kHD, C + call * kHD, 2 * C + call * kHD, KC);
    } else {
      const int n0 = (call - Cf::NH) * 96;
      stage_rows(dst, wproj, C, k0, n0, n0 + 32, n0 + 64, KC);
    }
  }
  cp_async_commit();
}

// acc = A[rows, C] @ (96 weight columns of the product whose chunks start at
// g0 of the stream), the chunks taken from the ring as they land, the ring
// refilled S - 1 chunks ahead.  One barrier a chunk: it shows every thread's
// copies of this chunk and frees the buffer of the chunk before.  With
// `bias_src`, the head's [N, N] bias is copied to `bias_dst` on the way.
// Every thread of the block calls it.
template <int C, int KC, int S, typename Cf>
__device__ __forceinline__ void gemm96(const bf16* A, int g0, const Stream& st, bf16* stage,
                                       const bf16* __restrict__ wqkv,
                                       const bf16* __restrict__ wproj,
                                       FragC (&acc)[Cf::ROUNDS][Cf::NFR],
                                       const float* __restrict__ bias_src, float* bias_dst) {
  const int warp = threadIdx.x / 32;
  constexpr int PP = Cf::UNITS / Cf::RT;
  const int part = warp % PP;
#pragma unroll
  for (int rd = 0; rd < Cf::ROUNDS; ++rd)
#pragma unroll
    for (int f = 0; f < Cf::NFR; ++f) wmma::fill_fragment(acc[rd][f], 0.0f);
  for (int ch = 0; ch < Cf::NCH; ++ch) {
    const int g = g0 + ch;
    cp_async_wait<S - 2>();
    __syncthreads();
    fetch_chunk<C, KC, S, Cf>(g + S - 1, st, stage, wqkv, wproj);
    if (ch == 0 && bias_src) {
      // this head's bias, behind the barrier that ends the head before's attention;
      // the barrier before this head's attention shows it
      for (int i = threadIdx.x; i < kN * kN; i += kThreads) bias_dst[i] = bias_src[i];
    }
    const bf16* cur = stage + (g % S) * Cf::STAGE_ELEMS;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      FragA a[Cf::ROUNDS];
#pragma unroll
      for (int rd = 0; rd < Cf::ROUNDS; ++rd) {
        const int u = warp + kWarps * rd;
        if (u < Cf::UNITS)
          wmma::load_matrix_sync(a[rd], A + (u / PP) * 16 * Cf::LDY + ch * KC + kk * 16, Cf::LDY);
      }
#pragma unroll
      for (int f = 0; f < Cf::NFR; ++f) {
        FragB b;
        wmma::load_matrix_sync(b, cur + kk * 16 * kLDB + (part * Cf::NFR + f) * 16, kLDB);
#pragma unroll
        for (int rd = 0; rd < Cf::ROUNDS; ++rd) {
          const int u = warp + kWarps * rd;
          if (u < Cf::UNITS) wmma::mma_sync(acc[rd][f], a[rd], b, acc[rd][f]);
        }
      }
    }
  }
}

// One warp a row: dst[c] = T((LN(src) * gamma + beta) * m) for C channels,
// fp32 statistics, fast variance.  The row sits in registers between passes.
template <int C, typename Load>
__device__ __forceinline__ void ln_row_bf16(Load load, const float* __restrict__ gamma,
                                            const float* __restrict__ beta, float eps, float m,
                                            bf16* dst) {
  const int lane = threadIdx.x % 32;
  float xv[C / 32];
  float s = 0.0f, ss = 0.0f;
#pragma unroll
  for (int i = 0; i < C / 32; ++i) xv[i] = load(lane + 32 * i);
#pragma unroll
  for (int i = 0; i < C / 32; ++i) {
    s += xv[i];
    ss += xv[i] * xv[i];
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = s / C;
  const float var = fmaxf(ss / C - mu * mu, 0.0f);
  const float rs = rsqrtf(var + eps);
#pragma unroll
  for (int i = 0; i < C / 32; ++i) {
    const int c = lane + 32 * i;
    dst[c] = __float2bfloat16((((xv[i] - mu) * rs) * gamma[c] + beta[c]) * m);
  }
}

// ---- the attention section with index-math masks, bf16 ----------------------
// The windows win0.. of this block: LN, pad zeroing, qkv, attention, proj,
// +residual (the note at the top of attn_section.cu).  With KEEP the result
// a = T(x + proj) of every row stays in shared memory, over y (row stride
// LDY); otherwise it goes to `out`.  Every thread of the block calls it.
template <int C, int W, int P, int KC, int S, bool KEEP>
__device__ __forceinline__ void section_bf16(
    const bf16* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
    const bf16* __restrict__ wqkv, const float* __restrict__ bqkv,
    const bf16* __restrict__ wproj, const float* __restrict__ bproj,
    const float* __restrict__ bias, bf16* __restrict__ out, long long NW, const Geom& g,
    float eps, unsigned char* smem) {
  typedef SecCfg<C, W, P, KC, S> Cf;
  bf16* ys = reinterpret_cast<bf16*>(smem);
  bf16* ctx = reinterpret_cast<bf16*>(smem + Cf::OFF_CTX);
  bf16* qb = reinterpret_cast<bf16*>(smem + Cf::OFF_Q);
  bf16* kb = reinterpret_cast<bf16*>(smem + Cf::OFF_Q + Cf::Q_BYTES);
  bf16* vb = reinterpret_cast<bf16*>(smem + Cf::OFF_Q + 2 * Cf::Q_BYTES);
  float* strips = reinterpret_cast<float*>(smem + Cf::OFF_STRIP);
  bf16* stage = reinterpret_cast<bf16*>(smem + Cf::OFF_STAGE);
  float* bias_s = reinterpret_cast<float*>(smem + Cf::OFF_BIAS);
  uint8_t* rids = smem + Cf::OFF_TOK;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long win0 = (long long)blockIdx.x * W;
  const int nwin = (int)((NW - win0) < (long long)W ? (NW - win0) : (long long)W);
  const int rows = nwin * kN;  // real rows of this block
  const float scale = rsqrtf((float)kHD);
  float* strip = strips + warp * kStrip;   // this warp's attention tile (warps below NSTRIP)
  float* scratch = strips + warp * 256;    // this warp's 16 x 16 tile for the epilogues
  constexpr int PP = P;
  const Stream st = {Cf::NCALL * Cf::NCH, 0, Cf::NCALL};

  // the first weight chunks travel while the rows are normalised
  for (int c = 0; c < S - 1; ++c) fetch_chunk<C, KC, S, Cf>(c, st, stage, wqkv, wproj);

  // region id and pad flag (bit 7) of every token; zero tails of q, k, v
  for (int i = threadIdx.x; i < Cf::R; i += kThreads) {
    int valid = 0, rid = 0;
    if (i < rows) token_geom((int)win0 + i / kN, i % kN, g, &valid, &rid);
    rids[i] = (uint8_t)(rid | (valid ? 0 : 128));
  }
  for (int i = threadIdx.x; i < (Cf::RQ - Cf::R) * kLQ; i += kThreads) {
    const bf16 z = __float2bfloat16(0.0f);
    qb[Cf::R * kLQ + i] = z;
    kb[Cf::R * kLQ + i] = z;
    vb[Cf::R * kLQ + i] = z;
  }
  __syncthreads();
  // y = LN(x) * valid, one warp a row
  for (int r = warp; r < Cf::R; r += kWarps) {
    bf16* dst = ys + r * Cf::LDY;
    const bool valid = r < rows && !(rids[r] & 128);
    if (!valid) {  // warp-uniform
      for (int c = lane; c < C; c += 32) dst[c] = __float2bfloat16(0.0f);
      continue;
    }
    const bf16* src = x + ((size_t)win0 * kN + r) * C;
    ln_row_bf16<C>([&](int c) { return __bfloat162float(src[c]); }, gamma, beta, eps, 1.0f, dst);
  }
  // the first product's first barrier shows y, the region ids and the tails

  FragC acc[Cf::ROUNDS][Cf::NFR];
  for (int h = 0; h < Cf::NH; ++h) {
    gemm96<C, KC, S, Cf>(ys, h * Cf::NCH, st, stage, wqkv, wproj, acc,
                         bias + (size_t)h * kN * kN, bias_s);
    // q, k, v of this head = T(T(acc) + T(bqkv))
#pragma unroll
    for (int rd = 0; rd < Cf::ROUNDS; ++rd) {
      const int u = warp + kWarps * rd;
      if (u < Cf::UNITS) {
#pragma unroll
        for (int f = 0; f < Cf::NFR; ++f) {
          const int rt = u / PP, colt = (u % PP) * Cf::NFR + f;
          wmma::store_matrix_sync(scratch, acc[rd][f], 16, wmma::mem_row_major);
          // a lane keeps one column of the tile: e % 16 == lane % 16
          const int col = colt * 16 + lane % 16;
          const int which = col / kHD, d = col % kHD;
          const float bcol = bf(bqkv[which * C + h * kHD + d]);
          bf16* dstb = (which == 0 ? qb : (which == 1 ? kb : vb)) + d;
          __syncwarp();
#pragma unroll
          for (int e = lane; e < 256; e += 32) {
            const int row = rt * 16 + e / 16;
            if (row < Cf::R) dstb[row * kLQ] = __float2bfloat16(bf(scratch[e]) + bcol);
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();
    for (int u = warp; u < W * 4; u += kWarps) {
      const int wl = u / 4, rt = u % 4;
      if (wl >= nwin) continue;
      const int r0 = wl * kN;
      attn_tile_bf16(qb + r0 * kLQ, kb + r0 * kLQ, vb + r0 * kLQ, rt,
                     bias_s, g.shift > 0 ? rids + r0 : nullptr, scale, strip,
                     ctx + r0 * Cf::LDY + h * kHD, Cf::LDY);
    }
    // the next product's first barrier comes before q, k, v or ctx are touched again
  }

  // a = x + T(T(ctx @ wproj) + T(bproj)), 96 columns a pass
  for (int n0 = 0; n0 < C; n0 += 96) {
    gemm96<C, KC, S, Cf>(ctx, (Cf::NH + n0 / 96) * Cf::NCH, st, stage, wqkv, wproj, acc,
                         nullptr, nullptr);
#pragma unroll
    for (int rd = 0; rd < Cf::ROUNDS; ++rd) {
      const int u = warp + kWarps * rd;
      if (u < Cf::UNITS) {
#pragma unroll
        for (int f = 0; f < Cf::NFR; ++f) {
          const int rt = u / PP, colt = (u % PP) * Cf::NFR + f;
          wmma::store_matrix_sync(scratch, acc[rd][f], 16, wmma::mem_row_major);
          const int col = n0 + colt * 16 + lane % 16;  // this lane's column of the tile
          const float bcol = bf(bproj[col]);
          float xr[8];  // the residual, fetched before the tile is read back
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int row = rt * 16 + lane / 16 + 2 * i;
            xr[i] = row < rows ? __bfloat162float(x[((size_t)win0 * kN + row) * C + col]) : 0.0f;
          }
          __syncwarp();
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int row = rt * 16 + lane / 16 + 2 * i;
            const bf16 a = __float2bfloat16(xr[i] + bf(bf(scratch[lane + 32 * i]) + bcol));
            if (KEEP) {
              // y is dead since the last head's product; rows past R belong to ctx
              if (row < Cf::R) ys[row * Cf::LDY + col] = a;
            } else if (row < rows) {
              out[((size_t)win0 * kN + row) * C + col] = a;
            }
          }
          __syncwarp();
        }
      }
    }
  }
}

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

}  // namespace
