// The head-grouped Swin attention section of the head-group probe with its
// masks shipped in (K9).
//
// Replaces: benchmarks/swin_attn_hg.py:hg_section (body `_hg_kernel`) as
// `segland_hg_section`, bf16.  The fp32 build is attn_section_f32.cu; K10
// (`segland_hg2_section`, masks from the window index) is attn_section_hg.cu.
//
// Per window of N = 49 tokens and C channels (heads of 32), bf16 T:
//   m, r = mask_tok[w % rows_m], regions[w % rows_r] (or none)
//   y    = T((LN(x) * gamma + beta) * T(m))          fp32 stats, fast variance
//   qkv  = T(T(y @ wqkv) + T(bqkv))                  fp32 accumulate
//   per group of hg heads, per head:
//     s   = (q . k) * scale + T(bias) + (r_q != r_k ? -100 : 0)   fp32
//           (score_f32 = 0: q' = T(q * T(scale)) enters the product instead)
//     p   = exp(s - max s), l = sum p                fp32, not normalised
//     ctx = T((T(p) @ v) / l)
//   out  = x + T(T(ctx @ wproj) + T(bproj))
// The JAX body accumulates the projection group by group; here it is one
// product over the context of every head after the last group: the same fp32
// sum in another order.
//
// What bounds it on an H100: operations, 2*NW*N*C*(4C + 2N) over real tokens
// (as attn_section.cu): the scores stay per head and nothing is multiplied on
// zeros.  hg on the TPU packs the K and V of hg heads block-diagonally to fill
// its 128 lanes; on this card it is the number of heads a pass holds.
//
// Design (sm_90a): section_win.cuh's body.  A block owns `wblk` windows (the
// grid is ceil(NW / wblk)) and walks them W at a time, a pass a [64 W, C]
// padded row matrix.  Two warpgroups and nothing else (so ptxas may give a
// thread 255 registers, not 168) run the products on wgmma with B from a ring
// of 12 KB slots that they refill by TMA themselves (section_win.cuh's
// HandBackRing), the weights K-major (wqkv^T [3C, C], wproj^T [C, C], as
// nn.Linear keeps them), streamed once a pass in the order they are
// used: every head's q, k, v columns, then the projection's, 96 columns a
// slot.  A group is hg heads: their q, k, v
// products run back to back into hg sets of q, k, v tiles, then all 4 W hg
// attention tiles of the group are in flight over the 8 warps on K6's
// register-resident core, one barrier a group; each writes its context to the
// output rows, from where it comes back into y's place for the projection
// after the last group.  Builds: SEGLAND_HG_SM90_BUILDS below and
// ops/hg_attn.py:HG_SM90_BUILDS; a pair without a build raises there with its
// arithmetic.

// segland-parts: 6
// kernels/__init__.py compiles this file once a part, -DSEGLAND_PART=0..5, in
// parallel: parts 0-2 instantiate the served builds of SEGLAND_HG_SM90_BUILDS
// marked with their part, parts 3-5 the same builds with phase clocks, and
// part 0 holds the entry points.

#ifndef SEGLAND_PART
#define SEGLAND_PART 0
#endif

#include "section_win.cuh"

namespace segland_hgs {
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
// the builds of part p: launch (a cudaError_t, or -1 when (C, hg) is not
// among them) and, for the served parts, their attributes
int launch_part0(const Args& a, int C, int hg);
int launch_part1(const Args& a, int C, int hg);
int launch_part2(const Args& a, int C, int hg);
int launch_part3(const Args& a, int C, int hg);
int launch_part4(const Args& a, int C, int hg);
int launch_part5(const Args& a, int C, int hg);
int attrs_part0(int C, int hg, cudaFuncAttributes* fa, int* smem);
int attrs_part1(int C, int hg, cudaFuncAttributes* fa, int* smem);
int attrs_part2(int C, int hg, cudaFuncAttributes* fa, int* smem);
}  // namespace segland_hgs

namespace {
using segland_hgs::Args;

// C channels, hg heads a group, W windows a pass, S ring slots
template <int C_, int HG_, int W_, int S_>
struct HgPlan : WinPlan<C_, W_, S_, HG_, HG_> {
  static constexpr int HG = HG_;
  static constexpr int NG = C_ / kHD / HG_;  // groups
  static_assert((C_ / kHD) % HG_ == 0, "hg must divide the heads");
};

// K9's stream, item by item: a pass's every head's q, k, v K tiles, then the
// projection's (section_sm90.cuh's produce_section)
template <typename Pl>
struct HgItems {
  static constexpr int QKV = Pl::NH * Pl::KT, PASS = QKV + Pl::C / 96 * Pl::KT;  // items a pass
  const CUtensorMap *mq, *mp;
  __device__ __forceinline__ void operator()(int i, unsigned char* dst, uint64_t* bar) const {
    const int j = i % PASS;
    if (j < QKV)
      load_qkv<Pl>(dst, bar, mq, j / Pl::KT, j % Pl::KT);
    else
      load_proj<Pl>(dst, bar, mp, (j - QKV) / Pl::KT * 96, (j - QKV) % Pl::KT);
  }
};

template <typename Pl, bool CLK>
__global__ void __launch_bounds__(Pl::THREADS, 1)
hg_sm90_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mp,
               const bf16* __restrict__ x, const float* __restrict__ mask_tok, int rows_m,
               const float* __restrict__ regions, int rows_r, const float* __restrict__ gamma,
               const float* __restrict__ beta, const float* __restrict__ bqkv,
               const float* __restrict__ bproj, const bf16* __restrict__ bias,
               bf16* __restrict__ out, long long NW, int wblk, float eps, int score_f32,
               unsigned long long* __restrict__ clocks) {
  constexpr int C = Pl::C, W = Pl::W, S = Pl::S, HG = Pl::HG;
  extern __shared__ unsigned char smem_raw[];
  const Passes ps = win_passes(NW, wblk, W);
  typedef HgItems<Pl> Items;
  HandBackRing<Pl::SLOT, S, Items> q;
  unsigned char* smem = win_smem<Pl>(smem_raw, q, Items{&mq, &mp}, ps.npass * Items::PASS);

  // ---- two warpgroups, which refill the ring too -----------------------------------
  unsigned char* ys = smem + Pl::OFF_Y;
  unsigned char* qkv = smem + Pl::OFF_Q;
  bf16* bias_s = reinterpret_cast<bf16*>(smem + Pl::OFF_BIAS);
  float* rid_s = reinterpret_cast<float*>(smem + Pl::OFF_TOK);
  const int cw = threadIdx.x / 32, g = cw / 4;
  const int cofs = Pl::ROWS ? 0 : 48 * g;  // the warpgroup's first column of a slot
  const float scale = score_f32 ? kScale : 1.0f;
  sm90::PhaseClocks<CLK, kClkPhases> clk;
  clk.start();
  float acc[Pl::NTW][Pl::ACC];
  for (int p = 0; p < ps.npass; ++p) {
    const long long win0 = ps.blk0 + (long long)p * W;
    const int nwin = ps.nblk - p * W < W ? ps.nblk - p * W : W;
    const bf16* xb = x + (size_t)win0 * kN * C;
    bf16* ob = out + (size_t)win0 * kN * C;
    if (p > 0) consumers_sync();  // the pass before is done with y, the tables, q, k, v
    win_tables<Pl>(rid_s, regions, rows_r, win0, nwin);
    win_ln<Pl>(ys, xb, mask_tok, rows_m, win0, nwin, gamma, beta, eps);
    sm90::fence_async_smem();
    for (int grp = 0; grp < Pl::NG; ++grp) {
      const int h0 = grp * HG;
      // the group's bias: the barrier that ended the group before's attention is
      // behind us, the one before this group's attention shows it
      copy_bias(bias_s, bias, h0, HG);
      if (grp == 0) consumers_sync();  // y and the tables, whole
      clk.template lap<kClkSetup>();
      for (int j = 0; j < HG; ++j) {
        section_product<Pl>(q, ys, g, cofs, acc, clk);
        unsigned char* buf = qkv + (size_t)j * 3 * Pl::QKV;
        qkv_epilogue<Pl>(acc, g, cofs, h0 + j, Pl::R, bqkv,
                         [&](int which, int row, int d, uint32_t v) {
                           store_qkv<Pl>(buf, which, row, d, v, !score_f32);
                         });
        clk.template lap<kClkQkv>();
      }
      consumers_sync();  // the group's q, k, v and bias
      clk.template lap<kClkQkv>();
      for (int u = cw; u < nwin * HG * 4; u += kWarps) {
        const int wl = u / (HG * 4), j = (u / 4) % HG, qt = u % 4;
        unsigned char* buf = qkv + (size_t)j * 3 * Pl::QKV + wl * kTileQ;
        win_core<kCoreDivide>(buf, buf + Pl::QKV, buf + 2 * Pl::QKV, qt, bias_s + j * kBiasHead,
                              regions ? rid_s + wl * kWinRows : nullptr, scale,
                              ob + (size_t)wl * kN * C + (h0 + j) * kHD, C);
      }
      consumers_sync();  // the group's context is in `out`; q, k, v and the bias are free
      clk.template lap<kClkAttn>();
    }
    // the context back into y's place (y is dead), then a = x + T(T(ctx @ wproj) + T(bproj))
    ctx_to_y<Pl>(ob, nwin, ys);
    consumers_sync();
    clk.template lap<kClkCtx>();
    for (int n0 = 0; n0 < C; n0 += 96) {
      section_product<Pl>(q, ys, g, cofs, acc, clk);
      win_proj_epilogue<Pl>(acc, g, cofs, n0, nwin, bproj, xb, ob);
      clk.template lap<kClkOut>();
    }
    ring_pass_end(q, (p + 1) * Items::PASS);
  }
  clk.flush(clocks);
}

template <typename Pl, bool CLK>
cudaError_t launch_hg_sm90(const Args& a) {
  constexpr int C = Pl::C;
  CUtensorMap mq, mp;
  cudaError_t err = win_qkv_map(&mq, a.wqkv, C);
  if (err == cudaSuccess) err = sm90::tile_map(&mp, a.wproj, C, C, 96);
  if (err != cudaSuccess) return err;
  auto kernel = hg_sm90_kernel<Pl, CLK>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Pl::SMEM);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((a.NW + a.wblk - 1) / a.wblk);
  kernel<<<grid, Pl::THREADS, Pl::SMEM, a.stream>>>(
      mq, mp, a.x, a.mask_tok, a.rows_m, a.regions, a.rows_r, a.gamma, a.beta, a.bqkv, a.bproj,
      a.bias, a.out, a.NW, a.wblk, a.eps, a.score_f32, a.clocks);
  return cudaGetLastError();
}

// Build <C_, HG_, W_, S_> of part PART (CLK: its measurement build, part
// PART + 3) if (C, hg) is it.  Only that part instantiates it: the discarded
// branch of a template's `if constexpr` is never instantiated.
template <int PART, bool CLK, int C_, int HG_, int W_, int S_>
int try_build(const Args& a, int C, int hg) {
  if constexpr (PART + (CLK ? 3 : 0) == SEGLAND_PART) {
    if (C == C_ && hg == HG_) return (int)launch_hg_sm90<HgPlan<C_, HG_, W_, S_>, CLK>(a);
  }
  return -1;
}

template <int PART, int C_, int HG_, int W_, int S_>
int try_attrs(int C, int hg, cudaFuncAttributes* fa, int* smem) {
  if constexpr (PART == SEGLAND_PART) {
    if (C == C_ && hg == HG_) {
      *smem = (int)HgPlan<C_, HG_, W_, S_>::SMEM;
      return (int)cudaFuncGetAttributes(fa, hg_sm90_kernel<HgPlan<C_, HG_, W_, S_>, false>);
    }
  }
  return -1;
}

}  // namespace

// (part, C, hg, W, S); the same table is ops/hg_attn.py:HG_SM90_BUILDS
#define SEGLAND_HG_SM90_BUILDS(X) \
  X(0, 96, 1, 4, 6)               \
  X(0, 96, 3, 2, 6)               \
  X(0, 192, 1, 2, 6)              \
  X(0, 192, 2, 2, 6)              \
  X(1, 192, 6, 1, 6)              \
  X(1, 384, 1, 2, 6)              \
  X(1, 384, 2, 2, 5)              \
  X(2, 384, 4, 1, 6)              \
  X(2, 768, 1, 1, 6)              \
  X(2, 768, 4, 1, 4)

#define SEGLAND_CAT2(a, b) a##b
#define SEGLAND_CAT(a, b) SEGLAND_CAT2(a, b)

int segland_hgs::SEGLAND_CAT(launch_part, SEGLAND_PART)(const Args& a, int C, int hg) {
  int r;
#define SEGLAND_HGS_CASE(part, c, h, w, s)                                           \
  if ((r = try_build<part, false, c, h, w, s>(a, C, hg)) >= 0) return r;            \
  if ((r = try_build<part, true, c, h, w, s>(a, C, hg)) >= 0) return r;
  SEGLAND_HG_SM90_BUILDS(SEGLAND_HGS_CASE)
#undef SEGLAND_HGS_CASE
  return -1;
}

#if SEGLAND_PART < 3
int segland_hgs::SEGLAND_CAT(attrs_part, SEGLAND_PART)(int C, int hg, cudaFuncAttributes* fa,
                                                       int* smem) {
  int r;
#define SEGLAND_HGS_CASE(part, c, h, w, s) \
  if ((r = try_attrs<part, c, h, w, s>(C, hg, fa, smem)) >= 0) return r;
  SEGLAND_HG_SM90_BUILDS(SEGLAND_HGS_CASE)
#undef SEGLAND_HGS_CASE
  return -1;
}
#endif

#if SEGLAND_PART == 0
#define SEGLAND_HGS_PARAMS                                                                     \
  const void *x, const void *mask_tok, int rows_m, const void *regions, int rows_r,            \
      const void *gamma, const void *beta, const void *wqkv, const void *bqkv,                 \
      const void *wproj, const void *bproj, const void *bias, void *out, long long NW, int C, \
      int nh, int hg, int wblk, float eps, int score_f32

static int hgs_entry(SEGLAND_HGS_PARAMS, unsigned long long* clocks, int device, void* stream) {
  if (nh * kHD != C || hg < 1 || nh % hg || wblk < 1 || !mask_tok || rows_m < 1 ||
      (regions && rows_r < 1))
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
  int (*const served[])(const Args&, int, int) = {
      segland_hgs::launch_part0, segland_hgs::launch_part1, segland_hgs::launch_part2};
  int (*const clocked[])(const Args&, int, int) = {
      segland_hgs::launch_part3, segland_hgs::launch_part4, segland_hgs::launch_part5};
  for (int i = 0; i < 3; ++i) {
    const int r = (clocks ? clocked : served)[i](a, C, hg);
    if (r >= 0) return r;
  }
  return (int)cudaErrorInvalidValue;
}

// K9.  bf16 x and out; K-major weights: wqkv^T [3C, C] and wproj^T [C, C]
// (nn.Linear's [out, in]); bias [nh, 49, 56] bf16 (the [nh, 49, 49] bias in
// T, its columns padded); fp32 vectors, mask_tok [rows_m, N] and regions [rows_r, N] (or
// null).  Windows of 7 x 7 tokens and heads of 32; (C, hg) one of
// SEGLAND_HG_SM90_BUILDS.  Returns a cudaError_t.
extern "C" int segland_hg_section(SEGLAND_HGS_PARAMS, int device, void* stream) {
  return hgs_entry(x, mask_tok, rows_m, regions, rows_r, gamma, beta, wqkv, bqkv, wproj, bproj,
                   bias, out, NW, C, nh, hg, wblk, eps, score_f32, nullptr, device, stream);
}

// The same with its consumers' clock64() time by phase (setup, ring wait,
// wgmma, q/k/v epilogue, attention core, context copy, output epilogue) added
// to clocks[0..7) and the count of consumer warpgroups to clocks[7].
extern "C" int segland_hg_section_clocks(SEGLAND_HGS_PARAMS, void* clocks, int device,
                                         void* stream) {
  if (!clocks) return (int)cudaErrorInvalidValue;
  return hgs_entry(x, mask_tok, rows_m, regions, rows_r, gamma, beta, wqkv, bqkv, wproj, bproj,
                   bias, out, NW, C, nh, hg, wblk, eps, score_f32, (unsigned long long*)clocks,
                   device, stream);
}

// Registers a thread at launch, local (spill) bytes and dynamic shared memory
// of K9's served build (C, hg), by cudaFuncGetAttributes.
extern "C" int segland_hg_section_attrs(int C, int hg, int* regs, int* local_bytes, int* smem) {
  int (*const parts[])(int, int, cudaFuncAttributes*, int*) = {
      segland_hgs::attrs_part0, segland_hgs::attrs_part1, segland_hgs::attrs_part2};
  for (auto part : parts) {
    cudaFuncAttributes fa;
    const int r = part(C, hg, &fa, smem);
    if (r > 0) return r;
    if (r == 0) {
      *regs = fa.numRegs;
      *local_bytes = (int)fa.localSizeBytes;
      return 0;
    }
  }
  return (int)cudaErrorInvalidValue;
}
#endif  // SEGLAND_PART == 0
