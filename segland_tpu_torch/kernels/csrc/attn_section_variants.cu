// The attention section of the variants probe: the v1 Swin section with its
// masks shipped in, `wblk` windows a thread block, fp32 or bf16 scores and
// eight modes (K11).
//
// Replaces: benchmarks/swin_attn_variants.py:section (body `_kernel`) as
// `segland_section_variants`, bf16.  The fp32 build is attn_section_f32.cu.
//
// Per window w of N = 49 tokens and C channels (heads of 32), bf16 T:
//   m, r = mask_tok[w % rows_m], regions[w % rows_r] (or none)
//   y    = T((LN(x) * gamma + beta) * m)                 fp32 stats, fast variance
//   qkv  = T(T(y @ wqkv) + T(bqkv))                      fp32 accumulate
//   per head:
//     s   = (q . k) * scale + T(bias) + (r_q != r_k ? -100 : 0)   fp32
//           (score_f32 = 0: q' = T(q * T(scale)) enters the product instead)
//     p   = T(exp(s - max s) / sum)                      normalised before PV
//     ctx = T(p @ v)
//     acc += ctx @ wproj[the head's 32 rows]             fp32, head by head
//   out  = x + T(T(acc) + T(bproj))
// Modes (runtime): 0 none; 1 ln, y = x * m without the norm; 2 io, out =
// x + y and nothing else (the JAX body computes a qkv product it discards);
// 3 attn, ctx = q; 4 softmax, p = T(0.001 s) with no max, exp or sum, and the
// 15 pad keys of the JAX wrapper's bf16 layout (score T(-1e9) * 0.001, value
// T(bqkv)) in the product with v; 5 nomax, exp(s) / sum; 6 bf16sm, e =
// exp(T(s - max)), p = T(T(e) / T(sum e)); 7 proj1, the heads' contexts
// assembled in shared memory and projected by one [rows, C] x [C, C] product.
//
// What bounds it on an H100: operations, 2*NW*N*C*(4C + 2N) over real tokens
// (as attn_section.cu) against one read and one write of [NW, N, C].
//
// Design: a block owns `wblk` windows (the grid is ceil(NW / wblk)) and walks
// them W at a time (W from the build, what shared memory and registers hold).
// A pass is K9's at one head a pass (attn_section_hg.cu): y of W windows in
// shared memory, one [W*49, C] x [C, 96] WMMA product a head through the
// cp.async ring of attn_common.cuh, warp-local attention tiles of 16 query rows.
// What the TPU body does differently from K3 and K9 is kept:
//   * the probabilities are normalised before PV (K9 divides after);
//   * mode `none` never holds the whole context: each head's [W*49, 32]
//     context goes through that head's 32 rows of wproj, staged in shared
//     memory, into an fp32 accumulator of [W*49, C] that lives in registers
//     for the whole pass, RT * C / 16 WMMA tiles over 8 warps (12 a warp at
//     C = 384, W = 1: 96 registers a thread).  ptxas -v for sm_90a: 255
//     registers and 36 B of spill stores at C = 384, 24 B at C = 96 (W = 2),
//     none at C = 192 (245 registers).  So W stays at 1-2 windows a pass where
//     K9 holds 3-4, and that, not the per-head projection (within 5% of
//     proj1 at the same W), is what K11 loses to K9;
//   * mode `proj1` assembles the context in shared memory and projects it 96
//     columns a pass through the ring, as K3 does.
// The builds (C, W, KC, S) are listed in SEGLAND_VARIANT_BUILDS below and in
// ops/section_variants.py; a width that is not built raises there with its
// arithmetic.

#include "attn_common.cuh"

namespace {

enum Mode { kNone = 0, kLn = 1, kIo = 2, kAttn = 3, kSoftmax = 4, kNoMax = 5, kBf16Sm = 6,
            kProj1 = 7 };
constexpr float kScale = 0.17677669529663687f;  // 32 ** -0.5
constexpr float kPadBias = -998244352.0f;       // bf16(-1e9): the key bias of a pad token
constexpr int kPadKeys = 15;                    // 64 - 49 pad tokens in the bf16 layout

template <int C_, int W_, int KC_, int S_>
struct VarCfg {
  static constexpr int C = C_, W = W_, KC = KC_, S = S_;
  typedef SecCfg<C, W, 2, KC, S> Sec;            // the qkv and proj1 products (gemm96)
  static constexpr int R = W * kN;               // rows of a pass
  static constexpr int RT = (R + 15) / 16;       // row tiles
  static constexpr int RQ = (R + 30) / 16 * 16;  // q/k/v rows: a last tile reaches R + 14
  static constexpr int NH = C / kHD;
  static constexpr int LDY = C + 8;
  static constexpr int CT = C / 16;              // column tiles of the accumulator
  static constexpr int UNITSP = RT * CT;         // accumulator tiles, 8 warps
  static constexpr int RP = (UNITSP + kWarps - 1) / kWarps;
  static constexpr size_t Y_BYTES = align128((size_t)RT * 16 * LDY * sizeof(bf16));
  static constexpr size_t OFF_CTX = Y_BYTES;     // proj1's assembled context
  static constexpr size_t Q_BYTES = align128((size_t)RQ * kLQ * sizeof(bf16));
  static constexpr size_t OFF_Q = OFF_CTX + Y_BYTES;  // q, k, v, the head's context
  static constexpr size_t OFF_STRIP = OFF_Q + 4 * Q_BYTES;
  static constexpr size_t OFF_STAGE = OFF_STRIP + (size_t)kWarps * kStrip * sizeof(float);
  static constexpr size_t OFF_WP = OFF_STAGE + S * Sec::STAGE_ELEMS * sizeof(bf16);
  static constexpr size_t OFF_BIAS = OFF_WP + align128((size_t)kHD * LDY * sizeof(bf16));
  static constexpr size_t OFF_TOK = OFF_BIAS + align128((size_t)kN * kN * sizeof(float));
  static constexpr size_t TOK_BYTES = align128((size_t)R * sizeof(float));
  static constexpr size_t SMEM = OFF_TOK + 2 * TOK_BYTES;
  static_assert(C % KC == 0 && KC % 16 == 0, "chunks must tile C");
  static_assert(C % 96 == 0, "the projection walks 96 columns a pass");
  static_assert(S >= 2, "the ring needs two buffers");
  static_assert(SMEM <= kMaxSmem, "over the shared memory a block can have");
};

// One head of 16 query rows (tile rt) of one window, by one warp: scores by
// WMMA into the warp's strip, the mode's softmax two lanes a row, the bf16
// probabilities over the scores, their product with v, T(ctx) to `sink` (row
// 0 of the window at this head's columns, row stride ld).  q, k, v: row 0 of
// the window, [>= 64 rows, kLQ], rows 49..63 finite.  bias: the head's [N, N]
// fp32 (values of T); rid: the window's N region ids or null; vpad: the
// head's 32 values of a pad token.
__device__ __forceinline__ void var_attn_tile(const bf16* q, const bf16* k, const bf16* v, int rt,
                                              const float* bias, const float* rid, float scale,
                                              int mode, const float* __restrict__ vpad,
                                              float* strip, bf16* sink, size_t ld) {
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
  // two lanes a row, 32 columns each, in an order rotated so that no two
  // lanes meet in a bank (attn_tile_bf16)
  bf16* p = reinterpret_cast<bf16*>(strip);
  {
    const int r = lane >> 1, hf = lane & 1;
    const int qi = rt * 16 + r;
    const int rot = hf + 2 * (r >> 3);
    const bool live = qi < kN;
    const float* srow = strip + r * kLS + hf * 32;
    const float* brow = bias + (live ? qi : 0) * kN + hf * 32;
    const float rq = (rid && live) ? rid[qi] : 0.0f;
    float e[32];
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = (c + rot) & 31;
      float val = -INFINITY;
      if (live && hf * 32 + col < kN) {
        val = srow[col] * scale + brow[col];
        if (rid && rid[hf * 32 + col] != rq) val += -100.0f;
      }
      e[c] = val;
      m = fmaxf(m, val);
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const bool key = live && hf * 32 + ((c + rot) & 31) < kN;
      float ev = 0.0f;
      if (key) {
        if (mode == kSoftmax) ev = 0.001f * e[c];
        else if (mode == kNoMax) ev = __expf(e[c]);
        else if (mode == kBf16Sm) ev = __expf(bf(e[c] - m));
        else ev = __expf(e[c] - m);
      }
      e[c] = ev;
      sum += ev;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float inv = live ? 1.0f / (mode == kBf16Sm ? bf(sum) : sum) : 0.0f;
    __syncwarp();  // every score is in a register: the rows may be overwritten
    bf16* prow = p + r * 2 * kLS + hf * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float pv = mode == kSoftmax ? e[c] : (mode == kBf16Sm ? bf(e[c]) : e[c]) * inv;
      prow[(c + rot) & 31] = __float2bfloat16(pv);
    }
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
  const float pad_term = mode == kSoftmax ? kPadKeys * bf(0.001f * kPadBias) * bf(vpad[lane]) : 0.0f;
  for (int r = 0; r < 16; ++r) {
    const int qi = rt * 16 + r;
    if (qi < kN) sink[(size_t)qi * ld + lane] = __float2bfloat16(strip[r * kLS + lane] + pad_term);
  }
  __syncwarp();
}

template <typename Cf>
__global__ void __launch_bounds__(kThreads, 1)
section_variants_kernel(const bf16* __restrict__ x, const float* __restrict__ mask_tok,
                        int rows_m, const float* __restrict__ regions, int rows_r,
                        const float* __restrict__ gamma, const float* __restrict__ beta,
                        const bf16* __restrict__ wqkv, const float* __restrict__ bqkv,
                        const bf16* __restrict__ wproj, const float* __restrict__ bproj,
                        const float* __restrict__ bias, bf16* __restrict__ out, long long NW,
                        int wblk, float eps, int mode, int score_f32) {
  typedef typename Cf::Sec Sec;
  constexpr int C = Cf::C, W = Cf::W, KC = Cf::KC, S = Cf::S, R = Cf::R, LDY = Cf::LDY;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ys = reinterpret_cast<bf16*>(smem);
  bf16* ctx_s = reinterpret_cast<bf16*>(smem + Cf::OFF_CTX);
  bf16* qb = reinterpret_cast<bf16*>(smem + Cf::OFF_Q);
  bf16* kb = reinterpret_cast<bf16*>(smem + Cf::OFF_Q + Cf::Q_BYTES);
  bf16* vb = reinterpret_cast<bf16*>(smem + Cf::OFF_Q + 2 * Cf::Q_BYTES);
  bf16* ch = reinterpret_cast<bf16*>(smem + Cf::OFF_Q + 3 * Cf::Q_BYTES);  // a head's context
  float* strips = reinterpret_cast<float*>(smem + Cf::OFF_STRIP);
  bf16* stage = reinterpret_cast<bf16*>(smem + Cf::OFF_STAGE);
  bf16* wp_s = reinterpret_cast<bf16*>(smem + Cf::OFF_WP);
  float* bias_s = reinterpret_cast<float*>(smem + Cf::OFF_BIAS);
  float* m_s = reinterpret_cast<float*>(smem + Cf::OFF_TOK);
  float* rid_s = reinterpret_cast<float*>(smem + Cf::OFF_TOK + Cf::TOK_BYTES);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long blk0 = (long long)blockIdx.x * wblk;
  const int nblk = (int)((NW - blk0) < (long long)wblk ? (NW - blk0) : (long long)wblk);
  const bool proj1 = mode == kProj1;
  const bool attend = mode != kAttn;
  const float scale = score_f32 ? kScale : 1.0f;
  const float scale_b = bf(kScale);
  const int nprod = mode == kIo ? 0 : Cf::NH + (proj1 ? C / 96 : 0);
  const Stream st = {nprod * Sec::NCH, 0, nprod > 0 ? nprod : 1};
  float* scratch = strips + warp * 256;  // this warp's 16 x 16 tile for the epilogues

  for (int p0 = 0; p0 < nblk; p0 += W) {
    const long long win0 = blk0 + p0;
    const int nwin = nblk - p0 < W ? nblk - p0 : W;
    const int rows = nwin * kN;  // real rows of this pass
    cp_async_wait<0>();
    __syncthreads();  // the pass before is done with every buffer
    for (int c = 0; c < S - 1; ++c) fetch_chunk<C, KC, S, Sec>(c, st, stage, wqkv, wproj);

    // mask value and region id of every token; zero tails of q, k, v and the context
    for (int i = threadIdx.x; i < R; i += kThreads) {
      float m = 0.0f, r = 0.0f;
      if (i < rows) {
        const long long w = win0 + i / kN;
        const int t = i % kN;
        m = bf(mask_tok[(size_t)(w % rows_m) * kN + t]);
        if (regions) r = regions[(size_t)(w % rows_r) * kN + t];
      }
      m_s[i] = m;
      rid_s[i] = r;
    }
    for (int i = threadIdx.x; i < 4 * (Cf::RQ - R) * kLQ; i += kThreads) {
      const int b = i / ((Cf::RQ - R) * kLQ), e = i % ((Cf::RQ - R) * kLQ);
      reinterpret_cast<bf16*>(smem + Cf::OFF_Q + b * Cf::Q_BYTES)[R * kLQ + e] =
          __float2bfloat16(0.0f);
    }
    __syncthreads();
    // y = LN(x) * m (ln: x * m), one warp a row; rows past the pass's windows are zero
    for (int r = warp; r < Cf::RT * 16; r += kWarps) {
      bf16* dst = ys + r * LDY;
      if (r >= rows) {  // warp-uniform
        for (int c = lane; c < C; c += 32) dst[c] = __float2bfloat16(0.0f);
        continue;
      }
      const bf16* src = x + ((size_t)win0 * kN + r) * C;
      if (mode == kLn) {
        for (int c = lane; c < C; c += 32)
          dst[c] = __float2bfloat16(__bfloat162float(src[c]) * m_s[r]);
      } else {
        ln_row_bf16<C>([&](int c) { return __bfloat162float(src[c]); }, gamma, beta, eps,
                       m_s[r], dst);
      }
    }
    if (mode == kIo) {  // out = x + y
      __syncthreads();
      for (int i = threadIdx.x; i < rows * (C / 8); i += kThreads) {
        const int r = i / (C / 8), c = (i % (C / 8)) * 8;
        const size_t at = ((size_t)win0 * kN + r) * C + c;
        uint4 val = *reinterpret_cast<const uint4*>(x + at);
        const uint4 yv = *reinterpret_cast<const uint4*>(ys + r * LDY + c);
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&val);
        const __nv_bfloat162* hy = reinterpret_cast<const __nv_bfloat162*>(&yv);
#pragma unroll
        for (int t = 0; t < 4; ++t) h[t] = __hadd2(h[t], hy[t]);
        *reinterpret_cast<uint4*>(out + at) = val;
      }
      continue;
    }
    // the first product's first barrier shows y and the token tables

    FragC accp[Cf::RP];  // the per-head projection's fp32 accumulator
#pragma unroll
    for (int i = 0; i < Cf::RP; ++i) wmma::fill_fragment(accp[i], 0.0f);
    FragC acc[Sec::ROUNDS][Sec::NFR];
    for (int h = 0; h < Cf::NH; ++h) {
      gemm96<C, KC, S, Sec>(ys, h * Sec::NCH, st, stage, wqkv, wproj, acc,
                            bias + (size_t)h * kN * kN, bias_s);
      // q, k, v of this head = T(T(acc) + T(bqkv)); q' = T(q * T(scale)) without
      // fp32 scores; with mode attn the head's context is q
#pragma unroll
      for (int rd = 0; rd < Sec::ROUNDS; ++rd) {
        const int u = warp + kWarps * rd;
        if (u < Sec::UNITS) {
#pragma unroll
          for (int f = 0; f < Sec::NFR; ++f) {
            const int rt = u / 2, colt = (u % 2) * Sec::NFR + f;
            wmma::store_matrix_sync(scratch, acc[rd][f], 16, wmma::mem_row_major);
            const int col = colt * 16 + lane % 16;  // this lane's column of the tile
            const int which = col / kHD, d = col % kHD;
            const float bcol = bf(bqkv[which * C + h * kHD + d]);
            bf16* dstb = (which == 0 ? qb : (which == 1 ? kb : vb)) + d;
            __syncwarp();
#pragma unroll
            for (int e = lane; e < 256; e += 32) {
              const int row = rt * 16 + e / 16;
              if (row < R) {
                float val = bf(bf(scratch[e]) + bcol);
                if (which == 0) {
                  if (!attend) ch[row * kLQ + d] = __float2bfloat16(val);
                  if (!score_f32) val = bf(val * scale_b);
                }
                dstb[row * kLQ] = __float2bfloat16(val);
              }
            }
            __syncwarp();
          }
        }
      }
      if (!proj1) {  // the head's 32 rows of wproj, behind the product's barriers
        for (int i = threadIdx.x; i < kHD * (C / 8); i += kThreads) {
          const int r = i / (C / 8), c = (i % (C / 8)) * 8;
          *reinterpret_cast<uint4*>(wp_s + r * LDY + c) =
              *reinterpret_cast<const uint4*>(wproj + (size_t)(h * kHD + r) * C + c);
        }
      }
      __syncthreads();
      if (attend) {
        for (int u = warp; u < nwin * 4; u += kWarps) {
          const int wl = u / 4, rt = u % 4;
          const int r0 = wl * kN;
          bf16* sink = proj1 ? ctx_s + (size_t)r0 * LDY + h * kHD : ch + r0 * kLQ;
          var_attn_tile(qb + r0 * kLQ, kb + r0 * kLQ, vb + r0 * kLQ, rt, bias_s,
                        regions ? rid_s + r0 : nullptr, scale, mode, bqkv + 2 * C + h * kHD,
                        strips + warp * kStrip, sink, proj1 ? (size_t)LDY : (size_t)kLQ);
        }
      }
      if (!proj1) {
        __syncthreads();  // the head's context is whole
        // accp += ctx_h @ wproj[h rows]; unit u = warp + 8 i is tile (u / CT, u % CT)
#pragma unroll
        for (int i = 0; i < Cf::RP; ++i) {
          const int u = warp + kWarps * i;
          if (u < Cf::UNITSP) {
            const int rt = u / Cf::CT, ct = u % Cf::CT;
#pragma unroll
            for (int kk = 0; kk < kHD / 16; ++kk) {
              FragA a;
              FragB b;
              wmma::load_matrix_sync(a, ch + rt * 16 * kLQ + kk * 16, kLQ);
              wmma::load_matrix_sync(b, wp_s + kk * 16 * LDY + ct * 16, LDY);
              wmma::mma_sync(accp[i], a, b, accp[i]);
            }
          }
        }
      }
      // the next product's first barrier comes before q, k, v, the context or
      // the staged rows are touched again
    }

    if (!proj1) {  // out = x + T(T(acc) + T(bproj))
#pragma unroll
      for (int i = 0; i < Cf::RP; ++i) {
        const int u = warp + kWarps * i;
        if (u < Cf::UNITSP) {
          const int rt = u / Cf::CT, ct = u % Cf::CT;
          wmma::store_matrix_sync(scratch, accp[i], 16, wmma::mem_row_major);
          const int col = ct * 16 + lane % 16;  // this lane's column of the tile
          const float bcol = bf(bproj[col]);
          float xr[8];  // the residual, fetched before the tile is read back
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int row = rt * 16 + lane / 16 + 2 * j;
            xr[j] = row < rows ? __bfloat162float(x[((size_t)win0 * kN + row) * C + col]) : 0.0f;
          }
          __syncwarp();
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int row = rt * 16 + lane / 16 + 2 * j;
            if (row < rows)
              out[((size_t)win0 * kN + row) * C + col] =
                  __float2bfloat16(xr[j] + bf(bf(scratch[lane + 32 * j]) + bcol));
          }
          __syncwarp();
        }
      }
      continue;
    }

    // proj1: out = x + T(T(ctx @ wproj) + T(bproj)), 96 columns a pass
    for (int n0 = 0; n0 < C; n0 += 96) {
      gemm96<C, KC, S, Sec>(ctx_s, (Cf::NH + n0 / 96) * Sec::NCH, st, stage, wqkv, wproj, acc,
                            nullptr, nullptr);
#pragma unroll
      for (int rd = 0; rd < Sec::ROUNDS; ++rd) {
        const int u = warp + kWarps * rd;
        if (u < Sec::UNITS) {
#pragma unroll
          for (int f = 0; f < Sec::NFR; ++f) {
            const int rt = u / 2, colt = (u % 2) * Sec::NFR + f;
            wmma::store_matrix_sync(scratch, acc[rd][f], 16, wmma::mem_row_major);
            const int col = n0 + colt * 16 + lane % 16;
            const float bcol = bf(bproj[col]);
            float xr[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int row = rt * 16 + lane / 16 + 2 * j;
              xr[j] = row < rows ? __bfloat162float(x[((size_t)win0 * kN + row) * C + col]) : 0.0f;
            }
            __syncwarp();
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int row = rt * 16 + lane / 16 + 2 * j;
              if (row < rows)
                out[((size_t)win0 * kN + row) * C + col] =
                    __float2bfloat16(xr[j] + bf(bf(scratch[lane + 32 * j]) + bcol));
            }
            __syncwarp();
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

struct VarArgs {
  const bf16 *x, *wqkv, *wproj;
  const float *mask_tok, *regions, *gamma, *beta, *bqkv, *bproj, *bias;
  int rows_m, rows_r;
  bf16* out;
  long long NW;
  int wblk;
  float eps;
  int mode, score_f32;
  cudaStream_t stream;
};

template <typename Cf>
cudaError_t launch_variants(const VarArgs& a) {
  auto kernel = section_variants_kernel<Cf>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Cf::SMEM);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((a.NW + a.wblk - 1) / a.wblk);
  kernel<<<grid, kThreads, Cf::SMEM, a.stream>>>(
      a.x, a.mask_tok, a.rows_m, a.regions, a.rows_r, a.gamma, a.beta, a.wqkv, a.bqkv, a.wproj,
      a.bproj, a.bias, a.out, a.NW, a.wblk, a.eps, a.mode, a.score_f32);
  return cudaGetLastError();
}

}  // namespace

// (C, W, KC, S); the same table is ops/section_variants.py:SECTION_BUILDS
#define SEGLAND_VARIANT_BUILDS(X) \
  X(96, 2, 48, 3)                 \
  X(192, 1, 48, 3)                \
  X(384, 1, 32, 3)

// bf16 x, wqkv, wproj and out; fp32 vectors, bias [nh, N, N] (values of bf16),
// mask_tok [rows_m, N] and regions [rows_r, N] (or null).  Windows of 7 x 7
// tokens and heads of 32; mode 0..7 as at the top.  Returns a cudaError_t.
extern "C" int segland_section_variants(const void* x, const void* mask_tok, int rows_m,
                                        const void* regions, int rows_r, const void* gamma,
                                        const void* beta, const void* wqkv, const void* bqkv,
                                        const void* wproj, const void* bproj, const void* bias,
                                        void* out, long long NW, int C, int nh, int wblk,
                                        float eps, int mode, int score_f32, int device,
                                        void* stream) {
  if (nh * kHD != C || wblk < 1 || mode < kNone || mode > kProj1 || !mask_tok || rows_m < 1 ||
      (regions && rows_r < 1))
    return (int)cudaErrorInvalidValue;
  if (NW <= 0) return (int)cudaSuccess;
  if (NW > 2147483647LL / kN) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const VarArgs a = {(const bf16*)x, (const bf16*)wqkv, (const bf16*)wproj,
                     (const float*)mask_tok, (const float*)regions, (const float*)gamma,
                     (const float*)beta, (const float*)bqkv, (const float*)bproj,
                     (const float*)bias, rows_m, rows_r, (bf16*)out, NW, wblk, eps, mode,
                     score_f32, (cudaStream_t)stream};
#define SEGLAND_VARIANT_CASE(c, w, kc, s) \
  if (C == c) return (int)launch_variants<VarCfg<c, w, kc, s>>(a);
  SEGLAND_VARIANT_BUILDS(SEGLAND_VARIANT_CASE)
#undef SEGLAND_VARIANT_CASE
  return (int)cudaErrorInvalidValue;
}
