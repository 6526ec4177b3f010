// The Swin attention section over window-partitioned tokens.
//
// Replaces: segland_tpu/ops/pallas_attn.py:_attn_section_v2_pallas (body
// `_v2_attn_body`) as `segland_attn_section`.  Its attention core is
// attn_common.cuh's WMMA core; the window-attention core alone
// (`segland_window_attention`) is window_attention.cu.
//
// attn_section, per window of N = 49 tokens and C channels (heads of 32):
//   valid, rid = pad-token mask and shift-region id from the window index
//   y    = T(LN(x) * gamma + beta) * valid         fp32 stats, fast variance
//   qkv  = T(T(y @ wqkv) + T(bqkv))                fp32 accumulate
//   s    = (q . k) * scale + bias + (rid_q != rid_k ? -100 : 0)      fp32
//   p    = T(softmax(s))                           fp32, divided before PV
//   ctx  = T(p @ v)                                fp32 accumulate
//   out  = x + T(T(ctx @ wproj) + T(bproj))
// T is bf16 or fp32.  A pad token is zeroed after the norm but still gets
// bqkv and takes part as a key; the residual is added to every row.
//
// What bounds it on an H100: operations.  One call at a swin-s stage shape of
// a batch of 8 1024^2 tiles is 2*NW*N*C*(4C + 2N) = 47-50 GFLOP against one
// read and one write of [NW, N, C] (206 MB at C=96, 15 MB at C=768) plus
// 8*C^2 bytes of weights, which every block re-reads from L2.  The products
// (the qkv and the projection, 4*C / (4*C + 2*N) of the operations) set the
// pace, so they run on wgmma.
//
// Design (bf16, sm_90a): one block owns W windows (4 at C=96, 2 at C=192 and
// 384, 1 at C=768) as one flat [W*49, C] row matrix, cut into m64 row tiles.
// Two consumer warpgroups and a lone producer warp, 168 registers a thread
// (ptxas' cap for 9 warps, 3 of them on one SM sub-partition); or, where that
// spills (C = 96), a producer warpgroup that setmaxnreg leaves 24 registers a
// thread, its consumers 240 (the same split spills 16 bytes at C = 192 and
// 384: measured, PERF.md).  The producer streams the weight columns of every
// product as tiles of [96 rows, 64 K-columns] (12 KB, 128-byte swizzle) by
// TMA into a ring of S slots (full / empty mbarriers), in the order they are
// used: a head's q, k, v columns (three boxes of 32 rows), head after head,
// then the projection's, 96 output columns a pass.  The consumer warpgroups
// normalise the rows (a batch of rows' loads at once) into shared memory in
// the swizzled K-major
// layout of a wgmma A operand and run each product as wgmma.mma_async with B
// from the ring: with two row tiles or more each warpgroup takes every other
// row tile at n96; with one (C=768) each takes 48 of the 96 columns.  The
// q, k, v epilogue goes from the accumulator registers into the per-head
// q/k/v buffers; the attention core is attn_tile_bf16 (WMMA, one warp a
// 16-query tile), which writes each head's context to the output rows in
// device memory.  After the last head, y is dead: the block copies its
// context back from those rows into y's place in the operand layout, and the
// projection's epilogue adds bproj and the residual from registers and
// overwrites the rows.  So the context costs one write and one read of the
// block's rows (L2-resident) instead of a second [W*49, C] buffer in shared
// memory, which is what lets two windows a block fit at C=384.  m64 tiles
// reach past the W*49 real rows into the buffer after y; a product's output
// row depends on its own input row only, so that feeds phantom rows alone,
// which are never stored (q/k/v keep a zeroed tail so phantom keys and values
// are finite).  Weights arrive K-major: wqkv^T [3C, C] and wproj^T [C, C]
// (nn.Linear's [out, in]).  The attention core and the setup (LN, the token
// tables, each head's bias copy) now take most of a call (PERF.md, phase
// clocks).
// swin-b's and swin-l's widths.  C = 128 (4 windows, a producer warpgroup, as
// C = 96), 256 (2 windows), 512 and 1024 (1 window; at 512 so that a 10-slot
// ring fits: 2 windows would leave 3).  Where 96 does not divide C (128, 256,
// 512, 1024) the projection's last pass takes the last C % 96 columns: its
// 96-row TMA box reaches past C and is zero-filled, and the pass's wgmma is
// n64 or n32 (halved, a warpgroup, with one row tile), so nothing past C is
// multiplied.  At C = 1536 one window's y is 172 KB and leaves no room for a
// ring, so y streams: the consumers write y = LN(x) * valid to the block's rows
// of a device scratch (64 rows a window, zeros past the 49 real ones), make
// the stores visible to TMA (fence.proxy.async) and arrive on a `ready`
// mbarrier that the producer waits on; each ring slot then carries the
// window's [64, 64] K tile of y beside the [96, 64] weight tile (20 KB, 8
// slots).  The attention core writes the context to a second scratch instead
// of the output rows, announced the same way, and the projection's slots carry
// its K tiles.  That reads the window's y (64 rows, 192 KB) back from L2 once a
// head, two thirds of the weight tiles' bytes, where the resident builds read
// it from shared memory.
// The fp32 build uses exact fp32 FMA loops (no TF32), one window a block,
// and keeps ctx in the output buffer until the projection overwrites it; at
// C >= 1024, where y [49, C] does not fit, it keeps each row's statistics and
// makes y 64 columns at a time for every head's product
// (attn_common.cuh:section_f32_stream).

// segland-parts: 4
// kernels/__init__.py compiles this file four times, in parallel:
// -DSEGLAND_PART=0 (the entry points, the fp32 bodies and the served bf16
// builds at C = 96, 192, 384, 768), 1 (their builds with phase clocks, reached
// through segland_attn_section_clocks), 2 (the served bf16 builds at swin-b's
// and swin-l's C = 128, 256, 512, 1024, 1536) and 3 (theirs with phase
// clocks).
#ifndef SEGLAND_PART
#define SEGLAND_PART 0
#endif

#include "attn_common.cuh"
#include "section_geom.cuh"
#include "sm90.cuh"

// The bf16 launches cross parts: segland_attn_section (part 0) hands a build's
// arguments to the part that instantiates it.
namespace segland_k3 {
struct SectionArgs {
  const void* x;
  const float *gamma, *beta;
  const void* wqkvt;
  const float* bqkv;
  const void* wprojt;
  const float *bproj, *bias;
  void *out, *scratch;  // scratch: y's and the context's rows, for the builds that stream y
  long long NW;
  int C, h, w, hp, wp, ws, shift;
  float eps;
  cudaStream_t stream;
  unsigned long long* clocks;
};
// the served build of a width in part section_part(C), its clock build in the next
int launch_part0(const SectionArgs& a);
int launch_part1(const SectionArgs& a);
int launch_part2(const SectionArgs& a);
int launch_part3(const SectionArgs& a);
int attrs_part0(int C, int* regs, int* local_bytes, int* smem);
int attrs_part2(int C, int* regs, int* local_bytes, int* smem);
}  // namespace segland_k3

namespace {

// ---- the section, bf16: wgmma products fed by a TMA ring (section_sm90.cuh) ----------
// A build is SecPlan<C, W, S, RR>: W windows a block, S ring slots.
// ops/fused_attn.py:SECTION_BUILDS mirrors the table in segland_attn_section
// and section_plan the arithmetic.
template <typename Pl, bool CLK>
__global__ void __launch_bounds__(Pl::THREADS, 1)
attn_section_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mp,
                          const __grid_constant__ CUtensorMap my,
                          const __grid_constant__ CUtensorMap mc, const bf16* __restrict__ x,
                          const float* __restrict__ gamma, const float* __restrict__ beta,
                          const float* __restrict__ bqkv, const float* __restrict__ bproj,
                          const float* __restrict__ bias, bf16* __restrict__ out,
                          bf16* __restrict__ scratch, long long NW, Geom geo, float eps,
                          unsigned long long* __restrict__ clocks) {
  constexpr int W = Pl::W, S = Pl::S;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));  // swizzle atoms
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Pl::OFF_BAR);  // then the empty ones
  uint64_t* ready = full + 2 * S;  // Pl::YS: y written, then the context
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&full[S + s], 2);
    }
    if constexpr (Pl::YS) sm90::mbar_init(ready, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  const long long win0 = (long long)blockIdx.x * W;

  if (threadIdx.x >= 256) {
    // ---- producer: one thread streams every product's weight columns ---------------
    if constexpr (Pl::RR) sm90::regs_dec<sm90::kProducerRegs>();
    if (threadIdx.x == 256) {
      sm90::RingFill<Pl::SLOT, S> fill = {smem, full, 0, 0u};
      if constexpr (Pl::YS)
        produce_section_ys<Pl>(fill, &mq, &mp, &my, &mc, (int)(win0 * 64), ready);
      else
        produce_section<Pl>(fill, &mq, &mp);
    }
    return;
  }

  // ---- consumers: 8 warps --------------------------------------------------------
  if constexpr (Pl::RR) sm90::regs_inc<sm90::kConsumerRegs>();
  const int nwin = (int)((NW - win0) < (long long)W ? (NW - win0) : (long long)W);
  sm90::Ring<Pl::SLOT, S> q = {smem, full, 0, -1, 0u};
  sm90::PhaseClocks<CLK, kClkPhases> clk;
  clk.start();
  // Pl::YS: the scratch holds y's rows, then the context's, 64 a window
  bf16* ysg = Pl::YS ? scratch + (size_t)win0 * 64 * Pl::C : nullptr;
  bf16* csg = Pl::YS ? scratch + ((size_t)NW + win0) * 64 * Pl::C : nullptr;
  geom_section<Pl>(q, smem, x + (size_t)win0 * kN * Pl::C, out + (size_t)win0 * kN * Pl::C,
                   nwin * kN, win0, geo, gamma, beta, bqkv, bproj, bias, eps, clk, csg, ysg,
                   ready);
  clk.flush(clocks);
}

// ---- fp32: exact FMA loops (STREAM: y a chunk at a time, C >= 1024) ------------
template <bool STREAM>
__global__ void __launch_bounds__(kThreads)
attn_section_f32_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                        const float* __restrict__ beta, const float* __restrict__ wqkv,
                        const float* __restrict__ bqkv, const float* __restrict__ wproj,
                        const float* __restrict__ bproj, const float* __restrict__ bias,
                        float* __restrict__ out, int C, Geom g, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long win = blockIdx.x;
  float* ow = out + (size_t)win * kN * C;
  auto sink = [&](int row, int c, float v) { ow[(size_t)row * C + c] = v; };
  if constexpr (STREAM)
    section_f32_stream(x + (size_t)win * kN * C, gamma, beta, wqkv, bqkv, wproj, bproj, bias, ow,
                       C, win, g, eps, smem, sink);
  else
    section_f32(x + (size_t)win * kN * C, gamma, beta, wqkv, bqkv, wproj, bproj, bias, ow, C,
                win, g, eps, smem, sink);
}

template <bool STREAM>
cudaError_t launch_section_f32(const float* x, const float* gamma, const float* beta,
                               const float* wqkv, const float* bqkv, const float* wproj,
                               const float* bproj, const float* bias, float* out, long long NW,
                               int C, Geom g, float eps, cudaStream_t stream) {
  const size_t smem =
      (STREAM ? section_f32_stream_floats(C) : section_f32_floats(C)) * sizeof(float) + 128;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = attn_section_f32_kernel<STREAM>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)NW, kThreads, smem, stream>>>(x, gamma, beta, wqkv, bqkv, wproj, bproj,
                                                   bias, out, C, g, eps);
  return cudaGetLastError();
}

template <typename Pl, bool CLK>
cudaError_t launch_section_bf16(const segland_k3::SectionArgs& a) {
  CUtensorMap mq, mp, my{}, mc{};
  cudaError_t err = sm90::tile_map(&mq, a.wqkvt, 3 * (uint64_t)Pl::C, Pl::C, 32);
  if (err != cudaSuccess) return err;
  err = sm90::tile_map(&mp, a.wprojt, Pl::C, Pl::C, 96);
  if (err != cudaSuccess) return err;
  if constexpr (Pl::YS) {
    // y's rows then the context's, 64 a window, [2 * NW * 64, C]
    if (!a.scratch) return cudaErrorInvalidValue;
    const bf16* ctx = (const bf16*)a.scratch + (size_t)a.NW * 64 * Pl::C;
    err = sm90::tile_map(&my, a.scratch, (uint64_t)a.NW * 64, Pl::C, 64);
    if (err == cudaSuccess) err = sm90::tile_map(&mc, ctx, (uint64_t)a.NW * 64, Pl::C, 64);
    if (err != cudaSuccess) return err;
  }
  auto kernel = attn_section_wgmma_kernel<Pl, CLK>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Pl::SMEM);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((a.NW + Pl::W - 1) / Pl::W);
  kernel<<<grid, Pl::THREADS, Pl::SMEM, a.stream>>>(
      mq, mp, my, mc, (const bf16*)a.x, a.gamma, a.beta, a.bqkv, a.bproj, a.bias, (bf16*)a.out,
      (bf16*)a.scratch, a.NW, Geom{a.h, a.w, a.hp, a.wp, a.ws, a.shift}, a.eps, a.clocks);
  return cudaGetLastError();
}

}  // namespace

// The bf16 builds, <C, W, S, RR> (ops/fused_attn.py:SECTION_BUILDS).
#define SEGLAND_SECTION_BUILDS(X) \
  X(96, 4, 4, 1)                  \
  X(128, 4, 5, 1)                 \
  X(192, 2, 6, 0)                 \
  X(256, 2, 7, 0)                 \
  X(384, 2, 4, 0)                 \
  X(512, 1, 10, 0)                \
  X(768, 1, 6, 0)                 \
  X(1024, 1, 5, 0)                \
  X(1536, 1, 8, 0)

namespace {

// the part that compiles a width's served build: swin-t/s's widths 0, swin-b's
// and swin-l's 2 (their clock builds in parts 1 and 3)
constexpr int section_part(int c) {
  return (c == 96 || c == 192 || c == 384 || c == 768) ? 0 : 2;
}

// build <c, ...> launched from part P: its served build in part
// section_part(c), its clock build in the part after it; elsewhere not
// instantiated
template <int P, int c, int w, int st, int rr>
int launch_in_part(const segland_k3::SectionArgs& a) {
  if constexpr (section_part(c) == (P & ~1))
    return (int)launch_section_bf16<SecPlan<c, w, st, rr>, (P & 1) != 0>(a);
  else
    return (int)cudaErrorInvalidValue;
}

template <int P, int c, int w, int st, int rr>
int attrs_in_part(int* regs, int* local_bytes, int* smem) {
  if constexpr (section_part(c) == P) {
    typedef SecPlan<c, w, st, rr> Pl;
    cudaFuncAttributes fa;
    const cudaError_t err = cudaFuncGetAttributes(&fa, attn_section_wgmma_kernel<Pl, false>);
    if (err != cudaSuccess) return (int)err;
    *regs = fa.numRegs;
    *local_bytes = (int)fa.localSizeBytes;
    *smem = (int)Pl::SMEM;
    return 0;
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

#define SEGLAND_CAT2(a, b) a##b
#define SEGLAND_CAT(a, b) SEGLAND_CAT2(a, b)

int segland_k3::SEGLAND_CAT(launch_part, SEGLAND_PART)(const SectionArgs& a) {
  switch (a.C) {
#define SEGLAND_CASE(c, w, st, rr) \
  case c: return launch_in_part<SEGLAND_PART, c, w, st, rr>(a);
    SEGLAND_SECTION_BUILDS(SEGLAND_CASE)
#undef SEGLAND_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

#if SEGLAND_PART == 0 || SEGLAND_PART == 2
int segland_k3::SEGLAND_CAT(attrs_part, SEGLAND_PART)(int C, int* regs, int* local_bytes,
                                                      int* smem) {
  switch (C) {
#define SEGLAND_CASE(c, w, st, rr) \
  case c: return attrs_in_part<SEGLAND_PART, c, w, st, rr>(regs, local_bytes, smem);
    SEGLAND_SECTION_BUILDS(SEGLAND_CASE)
#undef SEGLAND_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif

#if SEGLAND_PART == 0
namespace {
// the bf16 build at width C, its served build or (clocks) its clock build
int launch_build(const segland_k3::SectionArgs& a, bool clocks) {
  switch (section_part(a.C) + (clocks ? 1 : 0)) {
    case 0: return segland_k3::launch_part0(a);
    case 1: return segland_k3::launch_part1(a);
    case 2: return segland_k3::launch_part2(a);
    default: return segland_k3::launch_part3(a);
  }
}

bool bad_shape(int C, int nh, int hp, int wp, int ws, int shift) {
  return ws * ws != kN || nh * kHD != C || hp % ws || wp % ws || shift < 0 || shift >= ws;
}
}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, wqkv, wproj, out); vectors and bias
// [nh, N, N] are fp32.  fp32 weights are input-major (wqkv [C, 3C], wproj
// [C, C]); bf16 weights K-major (wqkv^T [3C, C], wproj^T [C, C]: nn.Linear's
// [out, in]).  Windows of 7 x 7 tokens and heads of 32 only; bf16 has builds
// for C in {96, 128, 192, 256, 384, 512, 768, 1024, 1536}; scratch is bf16
// [2 * NW * 64, C] for the build that streams y (C = 1536,
// ops/fused_attn.py:section_plan's "stream_y"), else null.  Returns a
// cudaError_t.
extern "C" int segland_attn_section(int dtype, const void* x, const void* gamma,
                                    const void* beta, const void* wqkv, const void* bqkv,
                                    const void* wproj, const void* bproj, const void* bias,
                                    void* out, void* scratch, long long NW, int C, int nh, int h,
                                    int w, int hp, int wp, int ws, int shift, float eps,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(C, nh, hp, wp, ws, shift)) return (int)cudaErrorInvalidValue;
  if (NW <= 0) return (int)cudaSuccess;
  if (NW > 2147483647LL / 64) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* ga = (const float*)gamma;
  const float* be = (const float*)beta;
  const float* bq = (const float*)bqkv;
  const float* bp = (const float*)bproj;
  const float* bi = (const float*)bias;
  if (dtype == 1) {
    const segland_k3::SectionArgs a = {x,  ga, be, wqkv, bq, wproj, bp,    bi,  out, scratch, NW,
                                       C,  h,  w,  hp,   wp, ws,    shift, eps, s,   nullptr};
    return launch_build(a, false);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const Geom g = {h, w, hp, wp, ws, shift};
  // y [N, C] resident where it fits, else streamed a chunk at a time (C >= 1024)
  const bool streamed = section_f32_floats(C) * sizeof(float) + 128 > kMaxSmem;
  const float *xf = (const float*)x, *wq = (const float*)wqkv, *wp_ = (const float*)wproj;
  return (int)(streamed ? launch_section_f32<true>(xf, ga, be, wq, bq, wp_, bp, bi, (float*)out,
                                                 NW, C, g, eps, s)
                        : launch_section_f32<false>(xf, ga, be, wq, bq, wp_, bp, bi,
                                                    (float*)out, NW, C, g, eps, s));
}

// Registers a thread at launch, local (spill) bytes and dynamic shared memory
// of the bf16 build at width C, by cudaFuncGetAttributes.
extern "C" int segland_attn_section_attrs(int C, int* regs, int* local_bytes, int* smem) {
  return section_part(C) == 0 ? segland_k3::attrs_part0(C, regs, local_bytes, smem)
                              : segland_k3::attrs_part2(C, regs, local_bytes, smem);
}

// The bf16 kernel of segland_attn_section with its consumers' clock64() time by
// phase (setup, ring wait, wgmma, q/k/v epilogue, attention core, context copy,
// output epilogue) added to clocks[0..7) and the count of consumer warpgroups
// to clocks[7].
extern "C" int segland_attn_section_clocks(const void* x, const void* gamma, const void* beta,
                                           const void* wqkv, const void* bqkv, const void* wproj,
                                           const void* bproj, const void* bias, void* out,
                                           void* scratch, long long NW, int C, int nh, int h,
                                           int w, int hp, int wp, int ws, int shift, float eps,
                                           void* clocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(C, nh, hp, wp, ws, shift)) return (int)cudaErrorInvalidValue;
  if (NW <= 0) return (int)cudaSuccess;
  if (NW > 2147483647LL / 64) return (int)cudaErrorInvalidValue;
  const segland_k3::SectionArgs a = {x,
                                     (const float*)gamma,
                                     (const float*)beta,
                                     wqkv,
                                     (const float*)bqkv,
                                     wproj,
                                     (const float*)bproj,
                                     (const float*)bias,
                                     out,
                                     scratch,
                                     NW,
                                     C,
                                     h,
                                     w,
                                     hp,
                                     wp,
                                     ws,
                                     shift,
                                     eps,
                                     (cudaStream_t)stream,
                                     (unsigned long long*)clocks};
  return launch_build(a, true);
}
#endif  // SEGLAND_PART == 0
