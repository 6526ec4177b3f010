// The head-grouped Swin attention section of the head-group probe with its
// masks shipped in (K9).
//
// Replaces: benchmarks/swin_attn_hg.py:hg_section (body `_hg_kernel`) as
// `segland_hg_section`, bf16.  The fp32 build is attn_section_f32.cu; K10
// (`segland_hg2_section`, masks from the window index) is
// attn_section_hg2_sm90.cu.
//
// The body (section_hg.cuh, shared with K10) is section_win.cuh's: padded
// windows, wgmma products fed by a TMA ring the two warpgroups refill
// themselves, K6's register-resident core inside the section; its header says
// what it computes and how.  Here it runs with the masks shipped in
// (ShippedMasks).  Builds: SEGLAND_HG_SM90_BUILDS below and
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

#include "section_hg.cuh"

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

template <bool CLK, typename Pl>
int launch(const Args& a) {
  const HgLaunch l = {a.x,   a.wqkv, a.wproj, a.bias, a.gamma,     a.beta,   a.bqkv, a.bproj,
                      a.out, a.NW,   a.wblk,  a.eps,  a.score_f32, a.clocks, a.stream};
  return (int)launch_hg<Pl, ShippedMasks, kHgNone, CLK>(
      l, ShippedMasks{a.mask_tok, a.regions, a.rows_m, a.rows_r});
}

// Build <C_, HG_, W_, S_> of part PART (CLK: its measurement build, part
// PART + 3) if (C, hg) is it.  Only that part instantiates it: the discarded
// branch of a template's `if constexpr` is never instantiated.
template <int PART, bool CLK, int C_, int HG_, int W_, int S_>
int try_build(const Args& a, int C, int hg) {
  if constexpr (PART + (CLK ? 3 : 0) == SEGLAND_PART) {
    if (C == C_ && hg == HG_) return launch<CLK, HgPlan<C_, HG_, W_, S_>>(a);
  }
  return -1;
}

template <int PART, int C_, int HG_, int W_, int S_>
int try_attrs(int C, int hg, cudaFuncAttributes* fa, int* smem) {
  if constexpr (PART == SEGLAND_PART) {
    if (C == C_ && hg == HG_)
      return hg_attrs<HgPlan<C_, HG_, W_, S_>, ShippedMasks, kHgNone>(fa, smem);
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
