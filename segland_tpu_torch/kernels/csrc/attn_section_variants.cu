// The attention section of the variants probe: the v1 Swin section with its
// masks shipped in, `wblk` windows a thread block, fp32 or bf16 scores and
// eight modes (K11).
//
// Replaces: benchmarks/swin_attn_variants.py:section (body `_kernel`) as
// `segland_section_variants`, bf16.  The fp32 build is attn_section_f32.cu.
//
// Per window w of N = 49 tokens and C channels (heads of 32), bf16 T:
//   m, r = mask_tok[w % rows_m], regions[w % rows_r] (or none)
//   y    = T((LN(x) * gamma + beta) * T(m))             fp32 stats, fast variance
//   qkv  = T(T(y @ wqkv) + T(bqkv))                      fp32 accumulate
//   per head:
//     s   = (q . k) * scale + T(bias) + (r_q != r_k ? -100 : 0)   fp32
//           (score_f32 = 0: q' = T(q * T(scale)) enters the product instead)
//     p   = T(exp(s - max s) / sum)                      normalised before PV
//     ctx = T(p @ v)
//     acc += ctx @ wproj[the head's 32 rows]             fp32, head by head
//   out  = x + T(T(acc) + T(bproj))
// Modes (template parameters): 0 none; 1 ln, y = T(x * T(m)) without the
// norm; 2 io, out = T(x + y) and nothing else (the probe's I/O floor; the JAX
// body computes a qkv product it discards); 3 attn, ctx = q; 4 softmax,
// p = T(0.001 s) with no max, exp or sum, and the 15 pad keys of the JAX
// wrapper's bf16 layout (score T(-1e9) * 0.001, value T(bqkv)) in the product
// with v; 5 nomax, exp(s) / sum; 6 bf16sm, e = exp(T(s - max)),
// p = T(T(e) / T(sum e)); 7 proj1, the heads' contexts assembled and
// projected by one [rows, C] x [C, C] product.
//
// What bounds it on an H100: operations, 2*NW*N*C*(4C + 2N) over real tokens
// (as attn_section.cu) against one read and one write of [NW, N, C].
//
// Design (sm_90a): section_win.cuh's body.  A block owns `wblk` windows (the
// grid is ceil(NW / wblk)) and walks them W at a time, a pass a [64 W, C]
// padded row matrix; two warpgroups and nothing else (255 registers a thread
// for ptxas, not 168), which stream the weights (K-major, as nn.Linear keeps
// them) once a pass through a ring of 12 KB slots that they refill themselves
// (section_win.cuh's HandBackRing).
// Per head: its q, k, v product on wgmma into one of two sets of q, k, v
// tiles, K6's register-resident core over the pass's 4 W query tiles (the
// probabilities normalised before PV, as the JAX body has them), the context
// left over q.  Then what the TPU body does differently from K3 and K9:
//   * modes none, ln, attn, softmax, nomax and bf16sm project each head's
//     context [64 W, 32] as it is, a K = 32 A operand in the 64-byte swizzle,
//     against that head's 32 K-columns of wproj^T, which the producer streams
//     as [96, 32] boxes (64-byte swizzle, a slot each), into an fp32
//     accumulator [64 W, C] that the two warpgroups hold in registers across
//     the heads (by columns at W = 1, by windows at W = 2): the JAX body's
//     order of sums.  The next head's q, k, v go to the other set of tiles,
//     so no barrier waits for the projection's wgmma;
//   * proj1 writes the contexts to the output rows, brings them back into y's
//     place after the last head and projects them 96 columns a slot, as K5;
//   * io runs no product, so it has a kernel of its own with no ring and no
//     shared memory: a warp a row of the block's windows (flat, unpadded),
//     sm90::ln_rows' batch of rows in flight at once, out = T(x + y) stored
//     as y is made, up to 16 warps a block.
// The builds (C, W, S) are listed in SEGLAND_VARIANT_BUILDS below and in
// ops/section_variants.py; a width that is not built raises there with its
// arithmetic.

// segland-parts: 8
// kernels/__init__.py compiles this file once a mode, -DSEGLAND_PART=0..7, in
// parallel: part p instantiates mode p at every width; part 0 also holds the
// measurement builds (mode none with phase clocks) and the entry points.

#ifndef SEGLAND_PART
#define SEGLAND_PART 0
#endif

#include "section_win.cuh"

namespace segland_var {
struct Args {
  const bf16 *x, *wqkv, *wproj, *bias;
  const float *mask_tok, *regions, *gamma, *beta, *bqkv, *bproj;
  int rows_m, rows_r;
  bf16* out;
  long long NW;
  int wblk;
  float eps;
  int score_f32;
  unsigned long long* clocks;  // the measurement builds only
  cudaStream_t stream;
};
// mode p's builds (part p): launch (a cudaError_t, or -1 where C has no
// build) and their attributes
int launch_part0(const Args& a, int C);
int launch_part1(const Args& a, int C);
int launch_part2(const Args& a, int C);
int launch_part3(const Args& a, int C);
int launch_part4(const Args& a, int C);
int launch_part5(const Args& a, int C);
int launch_part6(const Args& a, int C);
int launch_part7(const Args& a, int C);
int attrs_part0(int C, cudaFuncAttributes* fa, int* smem);
int attrs_part1(int C, cudaFuncAttributes* fa, int* smem);
int attrs_part2(int C, cudaFuncAttributes* fa, int* smem);
int attrs_part3(int C, cudaFuncAttributes* fa, int* smem);
int attrs_part4(int C, cudaFuncAttributes* fa, int* smem);
int attrs_part5(int C, cudaFuncAttributes* fa, int* smem);
int attrs_part6(int C, cudaFuncAttributes* fa, int* smem);
int attrs_part7(int C, cudaFuncAttributes* fa, int* smem);
}  // namespace segland_var

namespace {
using segland_var::Args;

enum Mode { kNone = 0, kLn = 1, kIo = 2, kAttn = 3, kSoftmax = 4, kNoMax = 5, kBf16Sm = 6,
            kProj1 = 7 };

// C channels, W windows a pass, S ring slots; two sets of q, k, v tiles, one
// head's bias.  The per-head projection: NP pieces a head ([96 output
// columns, 32 K-columns] of wproj^T, a slot each); a warpgroup takes NPC of
// them at NBP columns a wgmma.  At W = 1 the warpgroups split the columns:
// HALF (C = 96) one piece at 48 columns each, SPLIT (C > 96) a warpgroup its
// own C / 192 pieces (the other's skipped); at W = 2 each takes every piece
// for its window.
template <int C_, int W_, int S_>
struct VarPlan : WinPlan<C_, W_, S_, 2, 1> {
  typedef WinPlan<C_, W_, S_, 2, 1> Base;
  static constexpr int NP = C_ / 96;
  static constexpr bool HALF = !Base::ROWS && C_ == 96;
  static constexpr bool SPLIT = !Base::ROWS && C_ > 96;
  static constexpr int NPC = Base::ROWS ? NP : (HALF ? 1 : NP / 2);
  static constexpr int NBP = HALF ? 48 : 96;
  static constexpr int ACCP = NBP / 2;         // registers of a piece's accumulator
  static constexpr int PIECE = 96 * kHD * 2;   // bytes of a piece
  static_assert(!SPLIT || NP % 2 == 0, "the pieces split evenly over two warpgroups");
};

// a pass's stream, item by item, in the order the consumers take it: a head's
// q, k, v K tiles, then (per-head modes) its NP projection pieces; proj1 the
// projection's K tiles after the last head
template <typename Pl, int MODE>
struct VarItems {
  static constexpr int HEAD = Pl::KT + (MODE != kProj1 ? Pl::NP : 0);
  static constexpr int PASS = Pl::NH * HEAD + (MODE == kProj1 ? Pl::C / 96 * Pl::KT : 0);
  const CUtensorMap *mq, *mp, *mh;
  __device__ __forceinline__ void operator()(int i, unsigned char* dst, uint64_t* bar) const {
    const int j = i % PASS;
    if (j >= Pl::NH * HEAD) {
      const int k = j - Pl::NH * HEAD;
      load_proj<Pl>(dst, bar, mp, k / Pl::KT * 96, k % Pl::KT);
    } else if (j % HEAD < Pl::KT) {
      load_qkv<Pl>(dst, bar, mq, j / HEAD, j % HEAD);
    } else {  // [96, 32] of wproj^T: output columns 96 p.., the head's K-columns
      sm90::mbar_expect_tx(bar, Pl::PIECE);
      sm90::tma_load_2d(dst, mh, bar, j / HEAD * kHD, (j % HEAD - Pl::KT) * 96);
    }
  }
};

template <typename Pl>
using AccP = float[Pl::NTW][Pl::NPC][Pl::ACCP];

template <typename Pl>
__device__ __forceinline__ void fence_accp(AccP<Pl>& accp) {
#pragma unroll
  for (int t = 0; t < Pl::NTW; ++t)
#pragma unroll
    for (int p = 0; p < Pl::NPC; ++p) sm90::reg_fence(accp[t][p]);
}

// accp += ctx_h @ wproj^T[:, 32 h .. 32 h + 31]^T: the head's context (its q
// tiles, 64-byte swizzle) against the ring's next NP pieces
template <typename Pl, typename Rg, typename Clk>
__device__ __forceinline__ void head_projection(Rg& q, const unsigned char* ctx, int g,
                                                AccP<Pl>& accp, Clk& clk) {
  if constexpr (Pl::SPLIT) {
    clk.template lap<kClkMma>();
    ring_skip(q, g * Pl::NPC);
    clk.template lap<kClkWait>();
  }
#pragma unroll
  for (int p = 0; p < Pl::NPC; ++p) {
    clk.template lap<kClkMma>();
    unsigned char* b = ring_take(q);
    clk.template lap<kClkWait>();
    const uint64_t db = sm90::desc_sw64(b + (Pl::HALF ? 48 * kHD * 2 * g : 0));
    fence_accp<Pl>(accp);
    sm90::wgmma_fence();
#pragma unroll
    for (int t = 0; t < Pl::NTW; ++t) {
      const int rt = Pl::ROWS ? g + 2 * t : 0;
      const uint64_t da = sm90::desc_sw64(ctx + rt * kTileQ);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        wgmma_n<Pl::NBP>(accp[t][p], sm90::desc_step(da, ks), sm90::desc_step(db, ks));
    }
    sm90::wgmma_commit();
    ring_used(q);
    fence_accp<Pl>(accp);
    ring_next(q);
  }
  if constexpr (Pl::SPLIT) {
    clk.template lap<kClkMma>();
    ring_skip(q, (1 - g) * Pl::NPC);
    clk.template lap<kClkWait>();
  }
  ring_drain(q);
  clk.template lap<kClkMma>();
  fence_accp<Pl>(accp);
}

// out = x + T(T(accp) + T(bproj)) of this warpgroup's rows and columns
template <typename Pl>
__device__ __forceinline__ void head_proj_epilogue(AccP<Pl>& accp, int g, int nwin,
                                                   const float* __restrict__ bproj, const bf16* x,
                                                   bf16* out) {
  const int lane = threadIdx.x % 32, wrow = ((threadIdx.x / 32) % 4) * 16;
#pragma unroll
  for (int t = 0; t < Pl::NTW; ++t) {
    const int rt = Pl::ROWS ? g + 2 * t : 0;
#pragma unroll
    for (int p = 0; p < Pl::NPC; ++p) {
      const int c0 = Pl::HALF ? 48 * g : (Pl::SPLIT ? (g * Pl::NPC + p) * 96 : p * 96);
#pragma unroll
      for (int i = 0; i < Pl::ACCP; i += 2)
        out_pair(rt * 64 + wrow + lane / 4 + 8 * ((i / 2) % 2), c0 + (i / 4) * 8 + (lane % 4) * 2,
                 accp[t][p][i], accp[t][p][i + 1], nwin, Pl::C, bproj, x, out);
    }
  }
}

// y = T(x * T(m)) of the pass's real rows, zero elsewhere (mode ln)
template <typename Pl>
__device__ __forceinline__ void win_scale_rows(unsigned char* ys, const bf16* xb,
                                               const float* __restrict__ mask_tok, int rows_m,
                                               long long win0, int nwin) {
  const int lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < Pl::R; r += kWarps) {
    const int wl = r / kWinRows, t = r % kWinRows;
    const bool real = t < kN && wl < nwin;
    const float m = real ? bf(table_at(mask_tok, rows_m, win0, wl * kN + t)) : 0.0f;
    const bf16* src = xb + (size_t)(wl * kN + t) * Pl::C;
    for (int c = 2 * lane; c < Pl::C; c += 64) {
      uint32_t v = 0u;
      if (real) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + c));
        v = pack2(f.x * m, f.y * m);
      }
      *reinterpret_cast<uint32_t*>(ys + (c / 64) * Pl::YK + sm90::sw128(r, c % 64)) = v;
    }
  }
}

// Mode io: out = T(x + y), y = T((LN(x) * gamma + beta) * T(m)), of the
// block's windows as flat rows, a warp a row (win_ln's arithmetic, unpadded).
constexpr int kIoWarps = 16;  // a block's most warps (128 registers a thread)

template <int C>
__global__ void __launch_bounds__(kIoWarps * 32, 1)
io_kernel(const bf16* __restrict__ x, const float* __restrict__ mask_tok, int rows_m,
          const float* __restrict__ gamma, const float* __restrict__ beta,
          bf16* __restrict__ out, long long NW, int wblk, float eps) {
  const Passes ps = win_passes(NW, wblk, 1);
  const bf16* xb = x + (size_t)ps.blk0 * kN * C;
  bf16* ob = out + (size_t)ps.blk0 * kN * C;
  sm90::ln_rows<C, sm90::kLnBatch<C>>(
      [&](int r) { return xb + (size_t)r * C; }, threadIdx.x / 32, blockDim.x / 32,
      ps.nblk * kN, gamma, beta, eps,
      [&](int r, int c, uint32_t y, float2 xv) {
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r * C + c) =
            __hadd2(__floats2bfloat162_rn(xv.x, xv.y), *reinterpret_cast<__nv_bfloat162*>(&y));
      },
      [&](int r) { return bf(table_at(mask_tok, rows_m, ps.blk0, r)); });
}

// warps a block of mode io: one for each batch of rows of wblk windows, up to kIoWarps
template <int C>
int io_warps(int wblk) {
  const long long w = ((long long)wblk * kN + sm90::kLnBatch<C> - 1) / sm90::kLnBatch<C>;
  return w < kIoWarps ? (int)w : kIoWarps;
}

template <int C>
cudaError_t launch_io(const Args& a) {
  const unsigned grid = (unsigned)((a.NW + a.wblk - 1) / a.wblk);
  io_kernel<C><<<grid, io_warps<C>(a.wblk) * 32, 0, a.stream>>>(
      a.x, a.mask_tok, a.rows_m, a.gamma, a.beta, a.out, a.NW, a.wblk, a.eps);
  return cudaGetLastError();
}

template <typename Pl, int MODE, bool CLK>
__global__ void __launch_bounds__(Pl::THREADS, 1)
variants_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mp,
                const __grid_constant__ CUtensorMap mh, const bf16* __restrict__ x,
                const float* __restrict__ mask_tok, int rows_m, const float* __restrict__ regions,
                int rows_r, const float* __restrict__ gamma, const float* __restrict__ beta,
                const float* __restrict__ bqkv, const float* __restrict__ bproj,
                const bf16* __restrict__ bias, bf16* __restrict__ out, long long NW, int wblk,
                float eps, int score_f32, unsigned long long* __restrict__ clocks) {
  constexpr int C = Pl::C, W = Pl::W, S = Pl::S;
  static_assert(MODE != kIo, "mode io is io_kernel");
  constexpr bool PER_HEAD = MODE != kProj1;
  constexpr bool CORE = MODE != kAttn;
  constexpr int CORE_MODE = MODE == kSoftmax ? kCoreLinear
                            : MODE == kNoMax ? kCoreNoMax
                            : MODE == kBf16Sm ? kCoreBf16Sm : kCoreNorm;
  extern __shared__ unsigned char smem_raw[];
  const Passes ps = win_passes(NW, wblk, W);
  typedef VarItems<Pl, MODE> Items;
  HandBackRing<Pl::SLOT, S, Items> q;
  unsigned char* smem = win_smem<Pl>(smem_raw, q, Items{&mq, &mp, &mh}, ps.npass * Items::PASS);

  // ---- two warpgroups, which refill the ring too -----------------------------------
  unsigned char* ys = smem + Pl::OFF_Y;
  bf16* bias_s = reinterpret_cast<bf16*>(smem + Pl::OFF_BIAS);
  float* rid_s = reinterpret_cast<float*>(smem + Pl::OFF_TOK);
  const int cw = threadIdx.x / 32, g = cw / 4;
  const int cofs = Pl::ROWS ? 0 : 48 * g;  // the warpgroup's first column of a slot
  const float scale = score_f32 ? kScale : 1.0f;
  const bool scale_q = !score_f32 && MODE != kAttn;  // attn: the context is q itself
  sm90::PhaseClocks<CLK, kClkPhases> clk;
  clk.start();
  float acc[Pl::NTW][Pl::ACC];
  AccP<Pl> accp;
  for (int p = 0; p < ps.npass; ++p) {
    const long long win0 = ps.blk0 + (long long)p * W;
    const int nwin = ps.nblk - p * W < W ? ps.nblk - p * W : W;
    const bf16* xb = x + (size_t)win0 * kN * C;
    bf16* ob = out + (size_t)win0 * kN * C;
    if (p > 0) consumers_sync();  // the pass before is done with y, the tables, q, k, v
    win_tables<Pl>(rid_s, regions, rows_r, win0, nwin);
    if constexpr (MODE == kLn)
      win_scale_rows<Pl>(ys, xb, mask_tok, rows_m, win0, nwin);
    else
      win_ln<Pl>(ys, xb, mask_tok, rows_m, win0, nwin, gamma, beta, eps);
    sm90::fence_async_smem();
    if constexpr (PER_HEAD) {
#pragma unroll
      for (int t = 0; t < Pl::NTW; ++t)
#pragma unroll
        for (int pc = 0; pc < Pl::NPC; ++pc)
#pragma unroll
          for (int i = 0; i < Pl::ACCP; ++i) accp[t][pc][i] = 0.0f;
      fence_accp<Pl>(accp);
    }
    for (int h = 0; h < Pl::NH; ++h) {
      // this head's bias: the barrier that ended the head before's attention is
      // behind us, the one before this head's attention shows it
      if constexpr (CORE) copy_bias(bias_s, bias, h, 1);
      if (h == 0) consumers_sync();  // y and the tables, whole
      clk.template lap<kClkSetup>();
      section_product<Pl>(q, ys, g, cofs, acc, clk);
      // q, k, v of this head into the set of tiles the head before last used
      unsigned char* buf = smem + Pl::OFF_Q + (size_t)(h & 1) * 3 * Pl::QKV;
      qkv_epilogue<Pl>(acc, g, cofs, h, Pl::R, bqkv, [&](int which, int row, int d, uint32_t v) {
        store_qkv<Pl>(buf, which, row, d, v, scale_q);
      });
      if constexpr (MODE == kAttn) sm90::fence_async_smem();  // q is the projection's operand
      consumers_sync();  // q, k, v and the bias, whole
      clk.template lap<kClkQkv>();
      if constexpr (CORE) {
        for (int u = cw; u < nwin * 4; u += kWarps) {
          const int wl = u / 4, qt = u % 4;
          unsigned char* b = buf + wl * kTileQ;
          win_core<CORE_MODE>(b, b + Pl::QKV, b + 2 * Pl::QKV, qt, bias_s,
                              regions ? rid_s + wl * kWinRows : nullptr, scale,
                              MODE == kProj1 ? ob + (size_t)wl * kN * C + h * kHD : nullptr, C);
        }
        if constexpr (PER_HEAD) sm90::fence_async_smem();  // the context is an operand
        consumers_sync();  // the head's context, whole
        clk.template lap<kClkAttn>();
      }
      if constexpr (PER_HEAD) head_projection<Pl>(q, buf, g, accp, clk);
    }
    if constexpr (MODE == kProj1) {
      // the context back into y's place (y is dead), then 96 columns a slot
      ctx_to_y<Pl>(ob, nwin, ys);
      consumers_sync();
      clk.template lap<kClkCtx>();
      for (int n0 = 0; n0 < C; n0 += 96) {
        section_product<Pl>(q, ys, g, cofs, acc, clk);
        win_proj_epilogue<Pl>(acc, g, cofs, n0, nwin, bproj, xb, ob);
        clk.template lap<kClkOut>();
      }
    } else {
      head_proj_epilogue<Pl>(accp, g, nwin, bproj, xb, ob);
      clk.template lap<kClkOut>();
    }
    ring_pass_end(q, (p + 1) * Items::PASS);
  }
  clk.flush(clocks);
}

template <typename Pl, int MODE, bool CLK>
cudaError_t launch_variants(const Args& a) {
  constexpr int C = Pl::C;
  CUtensorMap mq, mp, mh;
  cudaError_t err = win_qkv_map(&mq, a.wqkv, C);
  if (err == cudaSuccess) err = sm90::tile_map(&mp, a.wproj, C, C, 96);
  if (err == cudaSuccess) {
    // [96, 32] boxes of wproj^T in the 64-byte swizzle: a head's pieces
    const uint64_t dims[2] = {(uint64_t)C, (uint64_t)C};
    const uint32_t box[2] = {(uint32_t)kHD, 96u};
    err = sm90::tile_map_nd(&mh, a.wproj, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 2, dims, box);
  }
  if (err != cudaSuccess) return err;
  auto kernel = variants_kernel<Pl, MODE, CLK>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Pl::SMEM);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((a.NW + a.wblk - 1) / a.wblk);
  kernel<<<grid, Pl::THREADS, Pl::SMEM, a.stream>>>(
      mq, mp, mh, a.x, a.mask_tok, a.rows_m, a.regions, a.rows_r, a.gamma, a.beta, a.bqkv,
      a.bproj, a.bias, a.out, a.NW, a.wblk, a.eps, a.score_f32, a.clocks);
  return cudaGetLastError();
}

}  // namespace

// (C, W, S); the same table is ops/section_variants.py:SECTION_BUILDS
#define SEGLAND_VARIANT_BUILDS(X) \
  X(96, 2, 6)                     \
  X(192, 2, 6)                    \
  X(384, 1, 6)

#define SEGLAND_CAT2(a, b) a##b
#define SEGLAND_CAT(a, b) SEGLAND_CAT2(a, b)

// mode MODE at width C; mode none also with phase clocks
template <int MODE>
int launch_mode(const Args& a, int C) {
#define SEGLAND_VARIANT_CASE(c, w, s)                                                 \
  if (C == c) {                                                                       \
    if constexpr (MODE == kIo) return (int)launch_io<c>(a);                           \
    if constexpr (MODE == kNone) {                                                    \
      if (a.clocks) return (int)launch_variants<VarPlan<c, w, s>, kNone, true>(a);    \
    }                                                                                 \
    if constexpr (MODE != kIo) return (int)launch_variants<VarPlan<c, w, s>, MODE, false>(a); \
  }
  SEGLAND_VARIANT_BUILDS(SEGLAND_VARIANT_CASE)
#undef SEGLAND_VARIANT_CASE
  return -1;
}

// the attributes and dynamic shared memory of mode MODE's kernel of plan Pl
template <int MODE, typename Pl>
int mode_attrs(cudaFuncAttributes* fa, int* smem) {
  if constexpr (MODE == kIo) {
    *smem = 0;
    return (int)cudaFuncGetAttributes(fa, io_kernel<Pl::C>);
  } else {
    *smem = (int)Pl::SMEM;
    return (int)cudaFuncGetAttributes(fa, variants_kernel<Pl, MODE, false>);
  }
}

int segland_var::SEGLAND_CAT(launch_part, SEGLAND_PART)(const Args& a, int C) {
  return launch_mode<SEGLAND_PART>(a, C);
}

int segland_var::SEGLAND_CAT(attrs_part, SEGLAND_PART)(int C, cudaFuncAttributes* fa, int* smem) {
#define SEGLAND_VARIANT_CASE(c, w, s) \
  if (C == c) return mode_attrs<SEGLAND_PART, VarPlan<c, w, s>>(fa, smem);
  SEGLAND_VARIANT_BUILDS(SEGLAND_VARIANT_CASE)
#undef SEGLAND_VARIANT_CASE
  return -1;
}

#if SEGLAND_PART == 0
#define SEGLAND_VAR_PARAMS                                                                     \
  const void *x, const void *mask_tok, int rows_m, const void *regions, int rows_r,            \
      const void *gamma, const void *beta, const void *wqkv, const void *bqkv,                 \
      const void *wproj, const void *bproj, const void *bias, void *out, long long NW, int C, \
      int nh, int wblk, float eps, int mode, int score_f32

static int var_entry(SEGLAND_VAR_PARAMS, unsigned long long* clocks, int device, void* stream) {
  if (nh * kHD != C || wblk < 1 || mode < kNone || mode > kProj1 || !mask_tok || rows_m < 1 ||
      (regions && rows_r < 1) || (clocks && mode != kNone))
    return (int)cudaErrorInvalidValue;
  if (NW <= 0) return (int)cudaSuccess;
  if (NW > 2147483647LL / kN) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a = {(const bf16*)x, (const bf16*)wqkv, (const bf16*)wproj, (const bf16*)bias,
                  (const float*)mask_tok, (const float*)regions, (const float*)gamma,
                  (const float*)beta, (const float*)bqkv, (const float*)bproj,
                  rows_m, rows_r, (bf16*)out, NW, wblk, eps, score_f32, clocks,
                  (cudaStream_t)stream};
  int (*const parts[])(const Args&, int) = {
      segland_var::launch_part0, segland_var::launch_part1, segland_var::launch_part2,
      segland_var::launch_part3, segland_var::launch_part4, segland_var::launch_part5,
      segland_var::launch_part6, segland_var::launch_part7};
  const int r = parts[mode](a, C);
  return r >= 0 ? r : (int)cudaErrorInvalidValue;
}

// K11.  bf16 x and out; K-major weights (read by every mode but io): wqkv^T
// [3C, C] and wproj^T [C, C] (nn.Linear's [out, in]); bias [nh, 49, 56] bf16 (the
// [nh, 49, 49] bias in T, its columns padded); fp32 vectors, mask_tok
// [rows_m, N] and regions [rows_r, N] (or null).  Windows of 7 x 7 tokens and
// heads of 32; mode 0..7 as at the top; C one of SEGLAND_VARIANT_BUILDS.
// Returns a cudaError_t.
extern "C" int segland_section_variants(SEGLAND_VAR_PARAMS, int device, void* stream) {
  return var_entry(x, mask_tok, rows_m, regions, rows_r, gamma, beta, wqkv, bqkv, wproj, bproj,
                   bias, out, NW, C, nh, wblk, eps, mode, score_f32, nullptr, device, stream);
}

// Mode none with its consumers' clock64() time by phase (setup, ring wait,
// wgmma, q/k/v epilogue, attention core, context copy, output epilogue) added
// to clocks[0..7) and the count of consumer warpgroups to clocks[7].
extern "C" int segland_section_variants_clocks(SEGLAND_VAR_PARAMS, void* clocks, int device,
                                               void* stream) {
  if (!clocks) return (int)cudaErrorInvalidValue;
  return var_entry(x, mask_tok, rows_m, regions, rows_r, gamma, beta, wqkv, bqkv, wproj, bproj,
                   bias, out, NW, C, nh, wblk, eps, mode, score_f32, (unsigned long long*)clocks,
                   device, stream);
}

// Registers a thread at launch, local (spill) bytes and dynamic shared memory
// of the served build of width C and `mode`, by cudaFuncGetAttributes.
extern "C" int segland_section_variants_attrs(int C, int mode, int* regs, int* local_bytes,
                                              int* smem) {
  int (*const parts[])(int, cudaFuncAttributes*, int*) = {
      segland_var::attrs_part0, segland_var::attrs_part1, segland_var::attrs_part2,
      segland_var::attrs_part3, segland_var::attrs_part4, segland_var::attrs_part5,
      segland_var::attrs_part6, segland_var::attrs_part7};
  if (mode < kNone || mode > kProj1) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  const int r = parts[mode](C, &fa, smem);
  if (r != 0) return r > 0 ? r : (int)cudaErrorInvalidValue;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return 0;
}
#endif  // SEGLAND_PART == 0
