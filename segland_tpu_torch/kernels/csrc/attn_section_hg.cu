// The head-grouped Swin attention section of the head-group probe, with its
// masks shipped in (K9) or taken from the window index (K10, with timing
// ablations).
//
// Replaces: benchmarks/swin_attn_hg.py:hg_section (body `_hg_kernel`) as
// `segland_hg_section`, and benchmarks/swin_attn_hg.py:hg2_section (body
// `_hg2_kernel`) as `segland_hg2_section`.  One body serves both; they differ
// in where the pad mask and the shift regions come from.
//
// Per window of N = 49 tokens and C channels (heads of 32), bf16 T:
//   m, r = mask_tok[w % rows_m], regions[w % rows_r]          (K9)
//        = pad flag and region id from the window index          (K10)
//   y    = T((LN(x) * gamma + beta) * m)             fp32 stats, fast variance
//   qkv  = T(T(y @ wqkv) + T(bqkv))                  fp32 accumulate
//   per group of hg heads, per head:
//     s   = (q . k) * scale + T(bias) + (r_q != r_k ? -100 : 0)   fp32
//           (score_f32 = 0: q' = T(q * T(scale)) enters the product instead)
//     p   = exp(s - max s), l = sum p                fp32, not normalised
//     ctx = T((T(p) @ v) / l)
//   out  = x + T(T(ctx @ wproj) + T(bproj))
// The JAX body accumulates the projection group by group; here it is one
// product over the context of all heads after the last group, the same fp32
// sum in another order: a [rows, C] fp32 accumulator kept across groups would
// take 96-192 registers a thread at C >= 384.
// Ablations (K10 only; timing builds with defined outputs): ioraw out = x + x;
// io out = x + y, after the qkv products, whose results are stored and never
// read; attn ctx = T(q * scale) and no attention; softmax p = 0.001 s with no
// max and no exp, and the 15 pad keys of the JAX wrapper's bf16 layout (score
// T(-1e9), value T(bqkv)) in the sums, as the JAX body has them.
//
// What bounds it on an H100: operations, 2*NW*N*C*(4C + 2N) over real tokens
// (as attn_section.cu): the scores stay per head and nothing is multiplied on
// zeros.  hg on the TPU packs the K and V of hg heads block-diagonally to fill
// its 128 lanes; here hg is the number of heads a pass.
//
// Design: a block owns `wblk` windows (a runtime argument; the grid is
// ceil(NW / wblk)) and walks them W at a time, W being what shared memory
// holds.  A pass is attn_section.cu's, with hg heads where that has one:
//   * the normalised rows y [W*49, C] stay in shared memory; one
//     [W*49, C] x [C, 96 hg] WMMA product a group makes q, k, v of hg heads,
//     so y is read nh / hg times, and each warp's A fragment of a 16-deep
//     step feeds 6 hg / PP column tiles;
//   * the weight columns of every product stream through one cp.async ring
//     of S chunks of KC rows, 96 hg columns wide;
//   * the attention tiles of the group's heads are in flight together, one
//     (window, head, 16 query rows) a warp, warp-local as in attn_section.cu,
//     the probabilities left unnormalised and the sum applied after PV;
//   * the group's bias sits in shared memory (bf16, the value the JAX wrapper
//     rounds it to) or is read from L2, and the context in shared memory or,
//     where that does not fit, in the output buffer until the projection's
//     pass copies it over y.
// The builds (C, hg, W, PP, KC, S, bias in shared memory, context in shared
// memory) are listed in SEGLAND_HG_BUILDS below and in ops/hg_attn.py; a pair
// that is not built raises there with its arithmetic.  bf16 only.

// segland-parts: 7
// kernels/__init__.py compiles this file once a part, -DSEGLAND_PART=0..6, in
// parallel: part p instantiates the builds of SEGLAND_HG_BUILDS marked p, and
// part 0 holds the entry points.

#include "attn_common.cuh"

#ifndef SEGLAND_PART
#define SEGLAND_PART 0
#endif

namespace segland_hg {
struct HgArgs {
  const bf16 *x, *wqkv, *wproj, *bias;
  const float *mask_tok, *regions, *gamma, *beta, *bqkv, *bproj;
  int rows_m, rows_r;
  bf16* out;
  long long NW;
  int wblk, h, w, hp, wp, ws, shift;
  float eps;
  int ablate, score_f32;
  cudaStream_t stream;
};
// the builds of part p; a cudaError_t, or -1 when (C, hg) is not among them
int launch_part0(const HgArgs& a, int C, int hg);
int launch_part1(const HgArgs& a, int C, int hg);
int launch_part2(const HgArgs& a, int C, int hg);
int launch_part3(const HgArgs& a, int C, int hg);
int launch_part4(const HgArgs& a, int C, int hg);
int launch_part5(const HgArgs& a, int C, int hg);
int launch_part6(const HgArgs& a, int C, int hg);
}  // namespace segland_hg

namespace {
using segland_hg::HgArgs;

enum Ablate { kNone = 0, kIoRaw = 1, kIo = 2, kAttnAb = 3, kSoftmaxAb = 4 };
constexpr float kScale = 0.17677669529663687f;  // 32 ** -0.5
constexpr float kPadBias = -998244352.0f;       // bf16(-1e9): the key bias of a pad token
constexpr int kPadKeys = 15;                    // 64 - 49 pad tokens in the bf16 layout

template <int C_, int HG_, int W_, int PP_, int KC_, int S_, bool BSM_, bool CTXS_>
struct HgCfg {
  static constexpr int C = C_, HG = HG_, W = W_, PP = PP_, KC = KC_, S = S_;
  static constexpr bool BSM = BSM_, CTXS = CTXS_;
  static constexpr int R = W * kN;               // rows of a pass
  static constexpr int RT = (R + 15) / 16;       // row tiles
  static constexpr int RQ = (R + 30) / 16 * 16;  // q/k/v rows: a last tile reaches R + 14
  static constexpr int NH = C / kHD;
  static constexpr int NG = NH / HG;             // groups
  static constexpr int LDY = C + 8;
  static constexpr int LDB = 96 * HG + 8;        // row stride of a staged weight chunk
  static constexpr int NF = 6 * HG;              // 16-column tiles of a group's product
  static constexpr int FR = NF / PP;             // tiles a unit
  static constexpr int UNITS = RT * PP;
  static constexpr int ROUNDS = (UNITS + kWarps - 1) / kWarps;
  static constexpr int UNITSJ = RT * 2;          // the projection: 96 columns a pass, 2 parts
  static constexpr int ROUNDSJ = (UNITSJ + kWarps - 1) / kWarps;
  static constexpr int NCH = C / KC;             // chunks a product
  static constexpr int NCALL = NG + C / 96;      // products: one a group, then the projection's
  static constexpr size_t Y_BYTES = align128((size_t)R * LDY * sizeof(bf16));
  static constexpr size_t OFF_CTX = Y_BYTES;
  static constexpr size_t OFF_Q = OFF_CTX + (CTXS ? Y_BYTES : 0);
  static constexpr size_t Q_BYTES = align128((size_t)RQ * kLQ * sizeof(bf16));
  static constexpr size_t OFF_STRIP = OFF_Q + 3 * HG * Q_BYTES;
  static constexpr size_t OFF_STAGE = OFF_STRIP + (size_t)kWarps * kStrip * sizeof(float);
  static constexpr size_t STAGE_ELEMS = align128((size_t)KC * LDB * sizeof(bf16)) / sizeof(bf16);
  static constexpr size_t OFF_BIAS = OFF_STAGE + S * STAGE_ELEMS * sizeof(bf16);
  static constexpr size_t OFF_TOK = OFF_BIAS + (BSM ? align128((size_t)HG * kN * kN * 2) : 0);
  static constexpr size_t TOK_BYTES = align128((size_t)R * sizeof(float));
  static constexpr size_t SMEM = OFF_TOK + 2 * TOK_BYTES;
  static_assert(NH % HG == 0, "hg must divide the heads");
  static_assert(C % KC == 0 && KC % 16 == 0, "chunks must tile C");
  static_assert(C % 96 == 0, "the projection walks 96 columns a pass");
  static_assert(NF % PP == 0 && kWarps % PP == 0, "PP must split the tiles and the warps");
  static_assert(S >= 2, "the ring needs two buffers");
  static_assert((CTXS ? OFF_CTX : 0) + (size_t)RT * 16 * LDY * sizeof(bf16) <= SMEM,
                "a row tile past y or ctx must stay inside the block's shared memory");
  static_assert(SMEM <= kMaxSmem, "over the shared memory a block can have");
};

// Chunk g of a pass's weight stream into its ring buffer: products 0..NG-1 are
// the q, k, v columns of a group's heads (head j's at j * 96), NG.. are 96
// columns of wproj a pass.  Always commits a group, empty past `total`.
template <typename Cf>
__device__ __forceinline__ void hg_fetch(int g, int total, bf16* stage,
                                         const bf16* __restrict__ wqkv,
                                         const bf16* __restrict__ wproj) {
  if (g < total) {
    const int call = g / Cf::NCH, k0 = (g % Cf::NCH) * Cf::KC;
    bf16* dst = stage + (g % Cf::S) * Cf::STAGE_ELEMS;
    if (call < Cf::NG) {
      const int h0 = call * Cf::HG;
      for (int i = threadIdx.x; i < Cf::KC * 12 * Cf::HG; i += kThreads) {
        const int r = i / (12 * Cf::HG), piece = i % (12 * Cf::HG);
        const int j = piece / 12, which = (piece % 12) / 4, off = (piece % 4) * 8;
        cp_async16(dst + r * Cf::LDB + j * 96 + which * kHD + off,
                   wqkv + (size_t)(k0 + r) * 3 * Cf::C + which * Cf::C + (h0 + j) * kHD + off);
      }
    } else {
      const int n0 = (call - Cf::NG) * 96;
      for (int i = threadIdx.x; i < Cf::KC * 12; i += kThreads) {
        const int r = i / 12, off = (i % 12) * 8;
        cp_async16(dst + r * Cf::LDB + off, wproj + (size_t)(k0 + r) * Cf::C + n0 + off);
      }
    }
  }
  cp_async_commit();
}

// acc = A[rows, C] @ (the FR * PPX 16-column tiles of the product whose chunks
// start at g0), a unit being (row tile, part): unit u = warp + 8 rd takes row
// tile u / PPX and tiles (warp % PPX) * FR.. of it.  The chunks are taken from
// the ring as they land and the ring refilled S - 1 chunks ahead, one barrier
// a chunk.  With `bias_dst`, `nbias` bias values are copied there on the way.
// Every thread of the block calls it.
template <typename Cf, int FR, int PPX, int ROUNDS, int UNITS>
__device__ __forceinline__ void hg_gemm(const bf16* A, int g0, int total, bf16* stage,
                                        const bf16* __restrict__ wqkv,
                                        const bf16* __restrict__ wproj,
                                        FragC (&acc)[ROUNDS][FR],
                                        const bf16* __restrict__ bias_src, bf16* bias_dst,
                                        int nbias) {
  const int warp = threadIdx.x / 32;
  const int part = warp % PPX;
#pragma unroll
  for (int rd = 0; rd < ROUNDS; ++rd)
#pragma unroll
    for (int f = 0; f < FR; ++f) wmma::fill_fragment(acc[rd][f], 0.0f);
  for (int ch = 0; ch < Cf::NCH; ++ch) {
    const int g = g0 + ch;
    cp_async_wait<Cf::S - 2>();
    __syncthreads();
    hg_fetch<Cf>(g + Cf::S - 1, total, stage, wqkv, wproj);
    if (ch == 0 && bias_dst) {
      // behind the barrier that ends the group before's attention; the barrier
      // before this group's attention shows it
      for (int i = threadIdx.x; i < nbias; i += kThreads) bias_dst[i] = bias_src[i];
    }
    const bf16* cur = stage + (g % Cf::S) * Cf::STAGE_ELEMS;
#pragma unroll
    for (int kk = 0; kk < Cf::KC / 16; ++kk) {
      FragA a[ROUNDS];
#pragma unroll
      for (int rd = 0; rd < ROUNDS; ++rd) {
        const int u = warp + kWarps * rd;
        if (u < UNITS)
          wmma::load_matrix_sync(a[rd], A + (u / PPX) * 16 * Cf::LDY + ch * Cf::KC + kk * 16,
                                 Cf::LDY);
      }
#pragma unroll
      for (int f = 0; f < FR; ++f) {
        FragB b;
        wmma::load_matrix_sync(b, cur + kk * 16 * Cf::LDB + (part * FR + f) * 16, Cf::LDB);
#pragma unroll
        for (int rd = 0; rd < ROUNDS; ++rd) {
          const int u = warp + kWarps * rd;
          if (u < UNITS) wmma::mma_sync(acc[rd][f], a[rd], b, acc[rd][f]);
        }
      }
    }
  }
}

// One head of 16 query rows (tile rt) of one window, by one warp.  q, k, v:
// row 0 of the window, [>= 64 rows, kLQ], rows 49..63 finite.  bias: the
// head's [N, N] in bf16; rid: the window's N region ids or null; q' . k is
// multiplied by `scale`.  The probabilities are written unnormalised; the row
// sum divides the product with v.  `softmax`: p = 0.001 s and the pad keys'
// terms (vpad: the head's 32 values of a pad token).  sink: row 0 of the
// window's context at this head's columns, row stride ld.
__device__ __forceinline__ void hg_attn_tile(const bf16* q, const bf16* k, const bf16* v, int rt,
                                             const bf16* bias, const float* rid, float scale,
                                             bool softmax, const float* __restrict__ vpad,
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
  // lanes meet in a bank; the row sum goes to column 64 of the strip
  bf16* p = reinterpret_cast<bf16*>(strip);
  const float ppad = 0.001f * kPadBias;
  {
    const int r = lane >> 1, hf = lane & 1;
    const int qi = rt * 16 + r;
    const int rot = hf + 2 * (r >> 3);
    const bool live = qi < kN;
    const float* srow = strip + r * kLS + hf * 32;
    const bf16* brow = bias + (live ? qi : 0) * kN + hf * 32;
    const float rq = (rid && live) ? rid[qi] : 0.0f;
    float e[32];
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = (c + rot) & 31;
      float val = -INFINITY;
      if (live && hf * 32 + col < kN) {
        val = srow[col] * scale + __bfloat162float(brow[col]);
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
      e[c] = key ? (softmax ? 0.001f * e[c] : __expf(e[c] - m)) : 0.0f;
      sum += e[c];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (softmax) sum += kPadKeys * ppad;
    __syncwarp();  // every score is in a register: the rows may be overwritten
    bf16* prow = p + r * 2 * kLS + hf * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) prow[(c + rot) & 31] = __float2bfloat16(e[c]);
    if (hf == 0) strip[r * kLS + 64] = sum;
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
  const float pad_term = softmax ? kPadKeys * bf(ppad) * bf(vpad[lane]) : 0.0f;
  for (int r = 0; r < 16; ++r) {
    const int qi = rt * 16 + r;
    if (qi < kN)
      sink[(size_t)qi * ld + lane] =
          __float2bfloat16((strip[r * kLS + lane] + pad_term) / strip[r * kLS + 64]);
  }
  __syncwarp();
}

template <typename Cf>
__global__ void __launch_bounds__(kThreads)
hg_section_kernel(const bf16* __restrict__ x, const float* __restrict__ mask_tok, int rows_m,
                  const float* __restrict__ regions, int rows_r, const float* __restrict__ gamma,
                  const float* __restrict__ beta, const bf16* __restrict__ wqkv,
                  const float* __restrict__ bqkv, const bf16* __restrict__ wproj,
                  const float* __restrict__ bproj, const bf16* __restrict__ bias,
                  bf16* __restrict__ out, long long NW, int wblk, Geom g, float eps, int ablate,
                  int score_f32) {
  constexpr int C = Cf::C, HG = Cf::HG, W = Cf::W, R = Cf::R, LDY = Cf::LDY;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ys = reinterpret_cast<bf16*>(smem);
  bf16* ctx_s = reinterpret_cast<bf16*>(smem + Cf::OFF_CTX);
  float* strips = reinterpret_cast<float*>(smem + Cf::OFF_STRIP);
  bf16* stage = reinterpret_cast<bf16*>(smem + Cf::OFF_STAGE);
  bf16* bias_s = reinterpret_cast<bf16*>(smem + Cf::OFF_BIAS);
  float* m_s = reinterpret_cast<float*>(smem + Cf::OFF_TOK);
  float* rid_s = reinterpret_cast<float*>(smem + Cf::OFF_TOK + Cf::TOK_BYTES);
  // q, k, v of head j of the group: which = 0, 1, 2
  auto qkv_buf = [&](int j, int which) {
    return reinterpret_cast<bf16*>(smem + Cf::OFF_Q + (3 * j + which) * Cf::Q_BYTES);
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long blk0 = (long long)blockIdx.x * wblk;
  const int nblk = (int)((NW - blk0) < (long long)wblk ? (NW - blk0) : (long long)wblk);
  if (ablate == kIoRaw) {  // out = x + x, 8 values a thread at a time
    const size_t n8 = (size_t)nblk * kN * C / 8;
    const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)blk0 * kN * C);
    uint4* dst = reinterpret_cast<uint4*>(out + (size_t)blk0 * kN * C);
    for (size_t i = threadIdx.x; i < n8; i += kThreads) {
      uint4 val = src[i];
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int t = 0; t < 4; ++t) h[t] = __hadd2(h[t], h[t]);
      dst[i] = val;
    }
    return;
  }
  const bool shipped = mask_tok != nullptr;
  const bool use_rid = shipped ? regions != nullptr : g.shift > 0;
  const float score_scale = score_f32 ? kScale : 1.0f;
  const float scale_b = bf(kScale);
  const bool attend = ablate == kNone || ablate == kSoftmaxAb;
  const int total = (ablate == kIo ? Cf::NG : Cf::NCALL) * Cf::NCH;
  float* scratch = strips + warp * 256;  // this warp's 16 x 16 tile for the epilogues

  for (int p0 = 0; p0 < nblk; p0 += W) {
    const long long win0 = blk0 + p0;
    const int nwin = nblk - p0 < W ? nblk - p0 : W;
    const int rows = nwin * kN;  // real rows of this pass
    bf16* sink = Cf::CTXS ? ctx_s : out + (size_t)win0 * kN * C;
    const size_t ldc = Cf::CTXS ? LDY : C;
    cp_async_wait<0>();
    __syncthreads();  // the pass before is done with every buffer
    for (int c = 0; c < Cf::S - 1; ++c) hg_fetch<Cf>(c, total, stage, wqkv, wproj);

    // mask value and region id of every token; zero tails of q, k, v
    for (int i = threadIdx.x; i < R; i += kThreads) {
      float m = 0.0f, r = 0.0f;
      if (i < rows) {
        const long long w = win0 + i / kN;
        const int t = i % kN;
        if (shipped) {
          m = bf(mask_tok[(size_t)(w % rows_m) * kN + t]);
          if (regions) r = regions[(size_t)(w % rows_r) * kN + t];
        } else {
          int valid, rid;
          token_geom((int)w, t, g, &valid, &rid);
          m = (float)valid;
          r = (float)rid;
        }
      }
      m_s[i] = m;
      rid_s[i] = r;
    }
    for (int i = threadIdx.x; i < 3 * HG * (Cf::RQ - R) * kLQ; i += kThreads) {
      const int b = i / ((Cf::RQ - R) * kLQ), e = i % ((Cf::RQ - R) * kLQ);
      qkv_buf(b / 3, b % 3)[R * kLQ + e] = __float2bfloat16(0.0f);
    }
    __syncthreads();
    // y = LN(x) * m, one warp a row
    for (int r = warp; r < R; r += kWarps) {
      bf16* dst = ys + r * LDY;
      if (r >= rows) {  // warp-uniform
        for (int c = lane; c < C; c += 32) dst[c] = __float2bfloat16(0.0f);
        continue;
      }
      const bf16* src = x + ((size_t)win0 * kN + r) * C;
      ln_row_bf16<C>([&](int c) { return __bfloat162float(src[c]); }, gamma, beta, eps, m_s[r],
                     dst);
    }
    // the first product's first barrier shows y and the token tables

    FragC acc[Cf::ROUNDS][Cf::FR];
    for (int grp = 0; grp < Cf::NG; ++grp) {
      const int h0 = grp * HG;
      hg_gemm<Cf, Cf::FR, Cf::PP, Cf::ROUNDS, Cf::UNITS>(
          ys, grp * Cf::NCH, total, stage, wqkv, wproj, acc, bias + (size_t)h0 * kN * kN,
          Cf::BSM ? bias_s : nullptr, HG * kN * kN);
      // q, k, v of the group's heads = T(T(acc) + T(bqkv)); q' = T(q * T(scale))
      // without fp32 scores; with ablate=attn the context is T(q * scale)
#pragma unroll
      for (int rd = 0; rd < Cf::ROUNDS; ++rd) {
        const int u = warp + kWarps * rd;
        if (u < Cf::UNITS) {
#pragma unroll
          for (int f = 0; f < Cf::FR; ++f) {
            const int rt = u / Cf::PP, colt = (u % Cf::PP) * Cf::FR + f;
            wmma::store_matrix_sync(scratch, acc[rd][f], 16, wmma::mem_row_major);
            const int col = colt * 16 + lane % 16;  // this lane's column of the tile
            const int j = col / 96, which = (col % 96) / kHD, d = col % kHD;
            const int hcol = (h0 + j) * kHD + d;
            const float bcol = bf(bqkv[which * C + hcol]);
            bf16* dstb = qkv_buf(j, which) + d;
            __syncwarp();
#pragma unroll
            for (int e = lane; e < 256; e += 32) {
              const int row = rt * 16 + e / 16;
              if (row < R) {
                float val = bf(bf(scratch[e]) + bcol);
                if (which == 0) {
                  const float qs = bf(val * scale_b);
                  if (ablate == kAttnAb && row < rows)
                    sink[(size_t)row * ldc + hcol] =
                        __float2bfloat16(score_f32 ? val * kScale : qs);
                  if (!score_f32) val = qs;
                }
                dstb[row * kLQ] = __float2bfloat16(val);
              }
            }
            __syncwarp();
          }
        }
      }
      __syncthreads();
      if (attend) {
        for (int u = warp; u < nwin * HG * 4; u += kWarps) {
          const int wl = u / (HG * 4), j = (u / 4) % HG, rt = u % 4;
          const int r0 = wl * kN;
          const bf16* bj = Cf::BSM ? bias_s + j * kN * kN : bias + (size_t)(h0 + j) * kN * kN;
          hg_attn_tile(qkv_buf(j, 0) + r0 * kLQ, qkv_buf(j, 1) + r0 * kLQ,
                       qkv_buf(j, 2) + r0 * kLQ, rt, bj, use_rid ? rid_s + r0 : nullptr,
                       score_scale, ablate == kSoftmaxAb, bqkv + 2 * C + (h0 + j) * kHD,
                       strips + warp * kStrip, sink + (size_t)r0 * ldc + (h0 + j) * kHD, ldc);
        }
      }
      // the next product's first barrier comes before q, k, v are touched again
    }

    if (ablate == kIo) {  // out = x + y; y has not changed since the barriers of the products
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
    const bf16* A = ctx_s;
    if (!Cf::CTXS) {
      __syncthreads();  // every warp's context rows are in out; y is dead
      for (int i = threadIdx.x; i < rows * (C / 8); i += kThreads) {
        const int r = i / (C / 8), c = (i % (C / 8)) * 8;
        *reinterpret_cast<uint4*>(ys + r * LDY + c) =
            *reinterpret_cast<const uint4*>(out + ((size_t)win0 * kN + r) * C + c);
      }
      A = ys;  // the projection's first barrier shows the copy
    }

    // out = x + T(T(ctx @ wproj) + T(bproj)), 96 columns a pass
    FragC accj[Cf::ROUNDSJ][3];
    for (int n0 = 0; n0 < C; n0 += 96) {
      hg_gemm<Cf, 3, 2, Cf::ROUNDSJ, Cf::UNITSJ>(A, (Cf::NG + n0 / 96) * Cf::NCH, total, stage,
                                                 wqkv, wproj, accj, nullptr, nullptr, 0);
#pragma unroll
      for (int rd = 0; rd < Cf::ROUNDSJ; ++rd) {
        const int u = warp + kWarps * rd;
        if (u < Cf::UNITSJ) {
#pragma unroll
          for (int f = 0; f < 3; ++f) {
            const int rt = u / 2, colt = (u % 2) * 3 + f;
            wmma::store_matrix_sync(scratch, accj[rd][f], 16, wmma::mem_row_major);
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
              if (row < rows)
                out[((size_t)win0 * kN + row) * C + col] =
                    __float2bfloat16(xr[i] + bf(bf(scratch[lane + 32 * i]) + bcol));
            }
            __syncwarp();
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <typename Cf>
cudaError_t launch_hg(const HgArgs& a) {
  auto kernel = hg_section_kernel<Cf>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Cf::SMEM);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((a.NW + a.wblk - 1) / a.wblk);
  const Geom g = {a.h, a.w, a.hp, a.wp, a.ws, a.shift};
  kernel<<<grid, kThreads, Cf::SMEM, a.stream>>>(
      a.x, a.mask_tok, a.rows_m, a.regions, a.rows_r, a.gamma, a.beta, a.wqkv, a.bqkv, a.wproj,
      a.bproj, a.bias, a.out, a.NW, a.wblk, g, a.eps, a.ablate, a.score_f32);
  return cudaGetLastError();
}

// Launch build <C_, HG_, ...> if (C, hg) is it.  Only part PART instantiates
// it: the discarded branch of a template's `if constexpr` is never instantiated.
template <int PART, int C_, int HG_, int W_, int PP_, int KC_, int S_, bool BSM_, bool CTXS_>
int try_build(const HgArgs& a, int C, int hg) {
  if constexpr (PART == SEGLAND_PART) {
    if (C == C_ && hg == HG_)
      return (int)launch_hg<HgCfg<C_, HG_, W_, PP_, KC_, S_, BSM_, CTXS_>>(a);
  }
  return -1;
}

}  // namespace

// (part, C, hg, W, PP, KC, S, bias in shared memory, context in shared
// memory); the same table is ops/hg_attn.py:HG_BUILDS
#define SEGLAND_HG_BUILDS(X)                 \
  X(0, 96, 1, 4, 2, 48, 3, true, true)       \
  X(0, 96, 3, 1, 2, 48, 3, true, true)       \
  X(1, 192, 1, 4, 2, 48, 3, true, false)     \
  X(1, 192, 2, 2, 4, 16, 4, true, true)      \
  X(2, 192, 3, 1, 2, 48, 3, true, true)      \
  X(2, 192, 6, 1, 4, 16, 3, false, false)    \
  X(3, 384, 1, 3, 2, 32, 3, true, false)     \
  X(3, 384, 2, 2, 4, 16, 4, true, false)     \
  X(4, 384, 3, 1, 2, 16, 4, true, true)      \
  X(4, 384, 4, 1, 8, 16, 4, true, false)     \
  X(5, 768, 1, 1, 2, 32, 3, true, true)      \
  X(5, 768, 2, 1, 4, 48, 3, true, false)     \
  X(6, 768, 3, 1, 2, 16, 4, true, false)     \
  X(6, 768, 4, 1, 8, 16, 3, false, false)

#define SEGLAND_CAT2(a, b) a##b
#define SEGLAND_CAT(a, b) SEGLAND_CAT2(a, b)

int segland_hg::SEGLAND_CAT(launch_part, SEGLAND_PART)(const HgArgs& a, int C, int hg) {
  int r;
#define SEGLAND_HG_CASE(part, c, h, w, pp, kc, s, bsm, ctxs) \
  if ((r = try_build<part, c, h, w, pp, kc, s, bsm, ctxs>(a, C, hg)) >= 0) return r;
  SEGLAND_HG_BUILDS(SEGLAND_HG_CASE)
#undef SEGLAND_HG_CASE
  return -1;
}

#if SEGLAND_PART == 0
static int hg_dispatch(const HgArgs& a, int C, int nh, int hg) {
  if (nh * kHD != C || hg < 1 || nh % hg || a.wblk < 1 || a.ablate < kNone ||
      a.ablate > kSoftmaxAb)
    return (int)cudaErrorInvalidValue;
  if (a.NW <= 0) return (int)cudaSuccess;
  if (a.NW > 2147483647LL / kN) return (int)cudaErrorInvalidValue;
  int (*const parts[])(const HgArgs&, int, int) = {
      segland_hg::launch_part0, segland_hg::launch_part1, segland_hg::launch_part2,
      segland_hg::launch_part3, segland_hg::launch_part4, segland_hg::launch_part5,
      segland_hg::launch_part6};
  for (auto part : parts) {
    const int r = part(a, C, hg);
    if (r >= 0) return r;
  }
  return (int)cudaErrorInvalidValue;
}

// bf16 x, wqkv, wproj, bias [nh, N, N] and out; fp32 vectors, mask_tok
// [rows_m, N] and regions [rows_r, N] (or null).  Windows of 7 x 7 tokens and
// heads of 32; ablate 0 = none, 1 = ioraw, 2 = io, 3 = attn, 4 = softmax.
// Returns a cudaError_t.
#define SEGLAND_HG_PARAMS                                                                      \
  const void *x, const void *mask_tok, int rows_m, const void *regions, int rows_r,            \
      const void *gamma, const void *beta, const void *wqkv, const void *bqkv,                 \
      const void *wproj, const void *bproj, const void *bias, void *out, long long NW, int C, \
      int nh, int hg, int wblk, int h, int w, int hp, int wp, int ws, int shift, float eps,    \
      int ablate, int score_f32, int device, void *stream

static int hg_entry(SEGLAND_HG_PARAMS) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const HgArgs a = {(const bf16*)x, (const bf16*)wqkv, (const bf16*)wproj, (const bf16*)bias,
                    (const float*)mask_tok, (const float*)regions, (const float*)gamma,
                    (const float*)beta, (const float*)bqkv, (const float*)bproj,
                    rows_m, rows_r, (bf16*)out, NW, wblk, h, w, hp, wp, ws, shift, eps,
                    ablate, score_f32, (cudaStream_t)stream};
  return hg_dispatch(a, C, nh, hg);
}

// K9: the pad mask and the region ids from the tables; no ablation.
extern "C" int segland_hg_section(SEGLAND_HG_PARAMS) {
  if (!mask_tok || rows_m < 1 || (regions && rows_r < 1) || ablate != 0)
    return (int)cudaErrorInvalidValue;
  return hg_entry(x, mask_tok, rows_m, regions, rows_r, gamma, beta, wqkv, bqkv, wproj, bproj,
                  bias, out, NW, C, nh, hg, wblk, h, w, hp, wp, ws, shift, eps, ablate, score_f32,
                  device, stream);
}

// K10: the pad mask and the region ids from geom = (h, w, hp, wp, ws, shift).
extern "C" int segland_hg2_section(SEGLAND_HG_PARAMS) {
  if (mask_tok || regions || ws * ws != kN || hp % ws || wp % ws || shift < 0 || shift >= ws)
    return (int)cudaErrorInvalidValue;
  return hg_entry(x, mask_tok, rows_m, regions, rows_r, gamma, beta, wqkv, bqkv, wproj, bproj,
                  bias, out, NW, C, nh, hg, wblk, h, w, hp, wp, ws, shift, eps, ablate, score_f32,
                  device, stream);
}
#endif  // SEGLAND_PART == 0
