// The head-grouped Swin attention section of the head-group probe with its
// masks taken from the window index, and its timing modes (K10).
//
// Replaces: benchmarks/swin_attn_hg.py:hg2_section (body `_hg2_kernel`) as
// `segland_hg2_section`, bf16.  The fp32 build is attn_section_f32.cu.
//
// The body is K9's (section_hg.cuh: padded windows, wgmma products fed by a
// TMA ring the two warpgroups refill themselves, K6's register-resident core
// inside the section; its header says what it computes, how, and what bounds
// it).  What K10 adds: the pad flag (a pad token's row of y is zero) and the
// shift-region id (the -100 penalty) of every token come from the window
// index (GeomMasks: token_geom, as K3 has them) in place of shipped tables,
// and four timing modes, a kernel each (a wgmma in a runtime branch is
// serialised by ptxas): io, attn and softmax on the same body (section_hg.cuh
// says what each computes), and ioraw, out = x + x, a streaming kernel with no
// ring and no shared memory.  Rows 49..63 of a window keep T(bqkv) and the key
// bias T(-1e9), the JAX wrapper's bf16 pad tokens, which the softmax mode sums
// over.
//
// Builds: every (C, hg) of SEGLAND_HG2_BUILDS in mode none; the modes io, attn
// and softmax and a measurement build (mode none with phase clocks) at the
// pairs of SEGLAND_HG2_MODES, hg = 1 and the JAX package's default hg of each
// swin-s width.  ops/hg_attn.py holds the same two tables (HG2_BUILDS,
// HG2_MODE_BUILDS); a pair or mode that is not built raises there with its
// arithmetic.

// segland-parts: 8
// kernels/__init__.py compiles this file once a part, -DSEGLAND_PART=0..7, in
// parallel: parts 0-3 instantiate the mode-none builds of SEGLAND_HG2_BUILDS
// marked with their part, parts 4-7 the mode builds and measurement builds of
// the pairs of SEGLAND_HG2_MODES marked with theirs, and part 0 also holds the
// ioraw kernel and the entry points.

#ifndef SEGLAND_PART
#define SEGLAND_PART 0
#endif

#include "section_hg.cuh"

// (part, C, hg, W, S) of the mode-none builds; the same table is
// ops/hg_attn.py:HG2_BUILDS
#define SEGLAND_HG2_BUILDS(X) \
  X(0, 96, 1, 4, 6)           \
  X(0, 96, 3, 2, 6)           \
  X(0, 192, 1, 2, 6)          \
  X(0, 192, 2, 2, 6)          \
  X(1, 192, 3, 2, 6)          \
  X(1, 192, 6, 1, 6)          \
  X(1, 384, 1, 2, 6)          \
  X(1, 384, 2, 2, 5)          \
  X(2, 384, 3, 1, 6)          \
  X(2, 384, 4, 1, 6)          \
  X(2, 768, 1, 1, 6)          \
  X(3, 768, 2, 1, 6)          \
  X(3, 768, 3, 1, 6)          \
  X(3, 768, 4, 1, 4)

// (part, C, hg) of the pairs whose modes io, attn and softmax and measurement
// build are built too; the same list is ops/hg_attn.py:HG2_MODE_BUILDS
#define SEGLAND_HG2_MODES(X) \
  X(4, 96, 1)                \
  X(4, 768, 4)               \
  X(5, 96, 3)                \
  X(5, 768, 1)               \
  X(6, 192, 1)               \
  X(6, 384, 4)               \
  X(7, 192, 6)               \
  X(7, 384, 1)

namespace segland_hg2 {
struct Args {
  const bf16 *x, *wqkv, *wproj, *bias;
  const float *gamma, *beta, *bqkv, *bproj;
  bf16* out;
  long long NW;
  int wblk, h, w, hp, wp, ws, shift;
  float eps;
  int mode, score_f32;
  unsigned long long* clocks;  // the measurement builds only
  cudaStream_t stream;
};
// the builds of part p: launch (a cudaError_t, or -1 when (C, hg, mode) is not
// among them) and their attributes
int launch_part0(const Args& a, int C, int hg);
int launch_part1(const Args& a, int C, int hg);
int launch_part2(const Args& a, int C, int hg);
int launch_part3(const Args& a, int C, int hg);
int launch_part4(const Args& a, int C, int hg);
int launch_part5(const Args& a, int C, int hg);
int launch_part6(const Args& a, int C, int hg);
int launch_part7(const Args& a, int C, int hg);
int attrs_part0(int C, int hg, int mode, cudaFuncAttributes* fa, int* smem);
int attrs_part1(int C, int hg, int mode, cudaFuncAttributes* fa, int* smem);
int attrs_part2(int C, int hg, int mode, cudaFuncAttributes* fa, int* smem);
int attrs_part3(int C, int hg, int mode, cudaFuncAttributes* fa, int* smem);
int attrs_part4(int C, int hg, int mode, cudaFuncAttributes* fa, int* smem);
int attrs_part5(int C, int hg, int mode, cudaFuncAttributes* fa, int* smem);
int attrs_part6(int C, int hg, int mode, cudaFuncAttributes* fa, int* smem);
int attrs_part7(int C, int hg, int mode, cudaFuncAttributes* fa, int* smem);
}  // namespace segland_hg2

namespace {
using segland_hg2::Args;

// the part holding pair (C, hg)'s mode builds and measurement build, or -1
constexpr int mode_part(int c, int hg) {
#define SEGLAND_HG2_MODE_PART(part, cc, h) \
  if (c == cc && hg == h) return part;
  SEGLAND_HG2_MODES(SEGLAND_HG2_MODE_PART)
#undef SEGLAND_HG2_MODE_PART
  return -1;
}

// the part that instantiates mode MODE (CLK: the measurement build) of the
// pair (C, hg) whose mode-none build is in part `part`
template <int MODE, bool CLK>
constexpr int part_of(int part, int c, int hg) {
  return MODE == kHgNone && !CLK ? part : mode_part(c, hg);
}

// Build <C_, HG_, W_, S_> in mode MODE, if this part instantiates it (the
// discarded branch of a template's `if constexpr` is never instantiated).
template <int PART, int MODE, bool CLK, int C_, int HG_, int W_, int S_>
int try_build(const Args& a) {
  if constexpr (part_of<MODE, CLK>(PART, C_, HG_) == SEGLAND_PART) {
    const HgLaunch l = {a.x,   a.wqkv, a.wproj, a.bias, a.gamma,     a.beta,   a.bqkv, a.bproj,
                        a.out, a.NW,   a.wblk,  a.eps,  a.score_f32, a.clocks, a.stream};
    const GeomMasks m = {{a.h, a.w, a.hp, a.wp, a.ws, a.shift}};
    return (int)launch_hg<HgPlan<C_, HG_, W_, S_>, GeomMasks, MODE, CLK>(l, m);
  }
  return -1;
}

template <int PART, int MODE, int C_, int HG_, int W_, int S_>
int try_attrs(cudaFuncAttributes* fa, int* smem) {
  if constexpr (part_of<MODE, false>(PART, C_, HG_) == SEGLAND_PART)
    return hg_attrs<HgPlan<C_, HG_, W_, S_>, GeomMasks, MODE>(fa, smem);
  return -1;
}

#if SEGLAND_PART == 0
// mode ioraw: out = T(x + x), 16 bytes a thread a step
constexpr int kIoRawThreads = 256, kIoRawBlocks = 132 * 8;

__global__ void __launch_bounds__(kIoRawThreads)
hg2_ioraw_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, long long n16) {
  for (long long i = (long long)blockIdx.x * kIoRawThreads + threadIdx.x; i < n16;
       i += (long long)gridDim.x * kIoRawThreads) {
    uint4 v = x[i];
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __hadd2(h[k], h[k]);
    out[i] = v;
  }
}
#endif

}  // namespace

#define SEGLAND_CAT2(a, b) a##b
#define SEGLAND_CAT(a, b) SEGLAND_CAT2(a, b)

int segland_hg2::SEGLAND_CAT(launch_part, SEGLAND_PART)(const Args& a, int C, int hg) {
#define SEGLAND_HG2_CASE(part, c, h, w, s)                                                \
  if (C == c && hg == h) {                                                                \
    if (a.clocks) return try_build<part, kHgNone, true, c, h, w, s>(a);                   \
    switch (a.mode) {                                                                     \
      case kHgNone: return try_build<part, kHgNone, false, c, h, w, s>(a);                \
      case kHgIo: return try_build<part, kHgIo, false, c, h, w, s>(a);                    \
      case kHgAttn: return try_build<part, kHgAttn, false, c, h, w, s>(a);                \
      case kHgSoftmax: return try_build<part, kHgSoftmax, false, c, h, w, s>(a);          \
      default: return -1;                                                                 \
    }                                                                                     \
  }
  SEGLAND_HG2_BUILDS(SEGLAND_HG2_CASE)
#undef SEGLAND_HG2_CASE
  return -1;
}

int segland_hg2::SEGLAND_CAT(attrs_part, SEGLAND_PART)(int C, int hg, int mode,
                                                       cudaFuncAttributes* fa, int* smem) {
#define SEGLAND_HG2_CASE(part, c, h, w, s)                                         \
  if (C == c && hg == h) {                                                         \
    switch (mode) {                                                                \
      case kHgNone: return try_attrs<part, kHgNone, c, h, w, s>(fa, smem);         \
      case kHgIo: return try_attrs<part, kHgIo, c, h, w, s>(fa, smem);             \
      case kHgAttn: return try_attrs<part, kHgAttn, c, h, w, s>(fa, smem);         \
      case kHgSoftmax: return try_attrs<part, kHgSoftmax, c, h, w, s>(fa, smem);   \
      default: return -1;                                                          \
    }                                                                              \
  }
  SEGLAND_HG2_BUILDS(SEGLAND_HG2_CASE)
#undef SEGLAND_HG2_CASE
  return -1;
}

#if SEGLAND_PART == 0
#define SEGLAND_HG2_PARAMS                                                                       \
  const void *x, const void *gamma, const void *beta, const void *wqkv, const void *bqkv,        \
      const void *wproj, const void *bproj, const void *bias, void *out, long long NW, int C,    \
      int nh, int hg, int wblk, int h, int w, int hp, int wp, int ws, int shift, float eps,      \
      int ablate, int score_f32

static int hg2_entry(SEGLAND_HG2_PARAMS, unsigned long long* clocks, int device, void* stream) {
  if (nh * kHD != C || hg < 1 || nh % hg || wblk < 1 || ablate < kHgNone ||
      ablate > kHgSoftmax || (clocks && ablate != kHgNone) || ws * ws != kN || hp % ws ||
      wp % ws || shift < 0 || shift >= ws)
    return (int)cudaErrorInvalidValue;
  if (NW <= 0) return (int)cudaSuccess;
  if (NW > 2147483647LL / kN) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ablate == kHgIoRaw) {
    const long long n16 = NW * kN * C / 8;
    const long long need = (n16 + kIoRawThreads - 1) / kIoRawThreads;
    const unsigned blocks = (unsigned)(need < kIoRawBlocks ? need : kIoRawBlocks);
    hg2_ioraw_kernel<<<blocks, kIoRawThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)x, (uint4*)out, n16);
    return (int)cudaGetLastError();
  }
  const Args a = {(const bf16*)x,     (const bf16*)wqkv, (const bf16*)wproj, (const bf16*)bias,
                  (const float*)gamma, (const float*)beta, (const float*)bqkv,
                  (const float*)bproj, (bf16*)out, NW, wblk, h, w, hp, wp, ws, shift, eps, ablate,
                  score_f32, clocks, (cudaStream_t)stream};
  int (*const parts[])(const Args&, int, int) = {
      segland_hg2::launch_part0, segland_hg2::launch_part1, segland_hg2::launch_part2,
      segland_hg2::launch_part3, segland_hg2::launch_part4, segland_hg2::launch_part5,
      segland_hg2::launch_part6, segland_hg2::launch_part7};
  for (auto part : parts) {
    const int r = part(a, C, hg);
    if (r >= 0) return r;
  }
  return (int)cudaErrorInvalidValue;
}

// K10.  bf16 x and out; K-major weights: wqkv^T [3C, C] and wproj^T [C, C]
// (nn.Linear's [out, in]); bias [nh, 49, 56] bf16 (the [nh, 49, 49] bias in
// T, its columns padded); fp32 vectors; the pad mask and the region ids from
// geom = (h, w, hp, wp, ws, shift).  Windows of 7 x 7 tokens and heads of 32;
// ablate 0 = none, 1 = ioraw, 2 = io, 3 = attn, 4 = softmax; (C, hg) one of
// SEGLAND_HG2_BUILDS, and of SEGLAND_HG2_MODES for io, attn and softmax.
// Returns a cudaError_t.
extern "C" int segland_hg2_section(SEGLAND_HG2_PARAMS, int device, void* stream) {
  return hg2_entry(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, out, NW, C, nh, hg, wblk, h,
                   w, hp, wp, ws, shift, eps, ablate, score_f32, nullptr, device, stream);
}

// Mode none with its consumers' clock64() time by phase (setup, ring wait,
// wgmma, q/k/v epilogue, attention core, context copy, output epilogue) added
// to clocks[0..7) and the count of consumer warpgroups to clocks[7]; (C, hg)
// one of SEGLAND_HG2_MODES.
extern "C" int segland_hg2_section_clocks(SEGLAND_HG2_PARAMS, void* clocks, int device,
                                          void* stream) {
  if (!clocks) return (int)cudaErrorInvalidValue;
  return hg2_entry(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, out, NW, C, nh, hg, wblk, h,
                   w, hp, wp, ws, shift, eps, ablate, score_f32, (unsigned long long*)clocks,
                   device, stream);
}

// Registers a thread at launch, local (spill) bytes and dynamic shared memory
// of K10's build (C, hg) in mode `ablate` (ioraw: its streaming kernel, any
// C and hg), by cudaFuncGetAttributes.
extern "C" int segland_hg2_section_attrs(int C, int hg, int ablate, int* regs, int* local_bytes,
                                         int* smem) {
  cudaFuncAttributes fa;
  int r = -1;
  if (ablate == kHgIoRaw) {
    *smem = 0;
    r = (int)cudaFuncGetAttributes(&fa, hg2_ioraw_kernel);
  } else {
    int (*const parts[])(int, int, int, cudaFuncAttributes*, int*) = {
        segland_hg2::attrs_part0, segland_hg2::attrs_part1, segland_hg2::attrs_part2,
        segland_hg2::attrs_part3, segland_hg2::attrs_part4, segland_hg2::attrs_part5,
        segland_hg2::attrs_part6, segland_hg2::attrs_part7};
    for (int i = 0; i < 8 && r < 0; ++i) r = parts[i](C, hg, ablate, &fa, smem);
  }
  if (r != 0) return r > 0 ? r : (int)cudaErrorInvalidValue;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return 0;
}
#endif  // SEGLAND_PART == 0
