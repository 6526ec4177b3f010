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
// The fp32 build uses exact fp32 FMA loops (no TF32), one window a block,
// and keeps ctx in the output buffer until the projection overwrites it.

// segland-parts: 2
// kernels/__init__.py compiles this file twice, -DSEGLAND_PART=0 (the entry
// points of the served kernels) and 1 (segland_attn_section_clocks, the bf16
// builds with phase clocks).
#ifndef SEGLAND_PART
#define SEGLAND_PART 0
#endif

#include "attn_common.cuh"
#include "section_geom.cuh"
#include "sm90.cuh"

namespace {

// ---- the section, bf16: wgmma products fed by a TMA ring (section_sm90.cuh) ----------
// A build is SecPlan<C, W, S, RR>: W windows a block, S ring slots.
// ops/fused_attn.py:SECTION_BUILDS mirrors the table in segland_attn_section
// and section_plan the arithmetic.
template <typename Pl, bool CLK>
__global__ void __launch_bounds__(Pl::THREADS, 1)
attn_section_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mp, const bf16* __restrict__ x,
                          const float* __restrict__ gamma, const float* __restrict__ beta,
                          const float* __restrict__ bqkv, const float* __restrict__ bproj,
                          const float* __restrict__ bias, bf16* __restrict__ out, long long NW,
                          Geom geo, float eps, unsigned long long* __restrict__ clocks) {
  constexpr int W = Pl::W, S = Pl::S;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));  // swizzle atoms
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Pl::OFF_BAR);  // then the empty ones
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&full[S + s], 2);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer: one thread streams every product's weight columns ---------------
    if constexpr (Pl::RR) sm90::regs_dec<sm90::kProducerRegs>();
    if (threadIdx.x == 256) {
      sm90::RingFill<Pl::SLOT, S> fill = {smem, full, 0, 0u};
      produce_section<Pl>(fill, &mq, &mp);
    }
    return;
  }

  // ---- consumers: 8 warps --------------------------------------------------------
  if constexpr (Pl::RR) sm90::regs_inc<sm90::kConsumerRegs>();
  const long long win0 = (long long)blockIdx.x * W;
  const int nwin = (int)((NW - win0) < (long long)W ? (NW - win0) : (long long)W);
  sm90::Ring<Pl::SLOT, S> q = {smem, full, 0, -1, 0u};
  sm90::PhaseClocks<CLK, kClkPhases> clk;
  clk.start();
  geom_section<Pl>(q, smem, x + (size_t)win0 * kN * Pl::C, out + (size_t)win0 * kN * Pl::C,
                   nwin * kN, win0, geo, gamma, beta, bqkv, bproj, bias, eps, clk);
  clk.flush(clocks);
}

// ---- fp32: exact FMA loops --------------------------------------------------
__global__ void __launch_bounds__(kThreads)
attn_section_f32_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                        const float* __restrict__ beta, const float* __restrict__ wqkv,
                        const float* __restrict__ bqkv, const float* __restrict__ wproj,
                        const float* __restrict__ bproj, const float* __restrict__ bias,
                        float* __restrict__ out, int C, Geom g, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long win = blockIdx.x;
  float* ow = out + (size_t)win * kN * C;
  section_f32(x + (size_t)win * kN * C, gamma, beta, wqkv, bqkv, wproj, bproj, bias, ow, C, win,
              g, eps, smem, [&](int row, int c, float v) { ow[(size_t)row * C + c] = v; });
}

template <typename Pl, bool CLK>
cudaError_t launch_section_bf16(const void* x, const float* gamma, const float* beta,
                                const void* wqkvt, const float* bqkv, const void* wprojt,
                                const float* bproj, const float* bias, void* out, long long NW,
                                Geom g, float eps, cudaStream_t stream,
                                unsigned long long* clocks = nullptr) {
  CUtensorMap mq, mp;
  cudaError_t err = sm90::tile_map(&mq, wqkvt, 3 * (uint64_t)Pl::C, Pl::C, 32);
  if (err != cudaSuccess) return err;
  err = sm90::tile_map(&mp, wprojt, Pl::C, Pl::C, 96);
  if (err != cudaSuccess) return err;
  auto kernel = attn_section_wgmma_kernel<Pl, CLK>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Pl::SMEM);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((NW + Pl::W - 1) / Pl::W);
  kernel<<<grid, Pl::THREADS, Pl::SMEM, stream>>>(mq, mp, (const bf16*)x, gamma, beta, bqkv,
                                                   bproj, bias, (bf16*)out, NW, g, eps, clocks);
  return cudaGetLastError();
}

}  // namespace

// The bf16 builds, <C, W, S, RR> (ops/fused_attn.py:SECTION_BUILDS).
#define SEGLAND_SECTION_BUILDS(X) \
  X(96, 4, 4, 1)                  \
  X(192, 2, 6, 0)                 \
  X(384, 2, 4, 0)                 \
  X(768, 1, 6, 0)

#if SEGLAND_PART == 0
// dtype: 0 = float32, 1 = bfloat16 (x, wqkv, wproj, out); vectors and bias
// [nh, N, N] are fp32.  fp32 weights are input-major (wqkv [C, 3C], wproj
// [C, C]); bf16 weights K-major (wqkv^T [3C, C], wproj^T [C, C]: nn.Linear's
// [out, in]).  Windows of 7 x 7 tokens and heads of 32 only; bf16 has builds
// for C in {96, 192, 384, 768}.  Returns a cudaError_t.
extern "C" int segland_attn_section(int dtype, const void* x, const void* gamma,
                                    const void* beta, const void* wqkv, const void* bqkv,
                                    const void* wproj, const void* bproj, const void* bias,
                                    void* out, long long NW, int C, int nh, int h, int w, int hp,
                                    int wp, int ws, int shift, float eps, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ws * ws != kN || nh * kHD != C || hp % ws || wp % ws || shift < 0 || shift >= ws)
    return (int)cudaErrorInvalidValue;
  if (NW <= 0) return (int)cudaSuccess;
  if (NW > 2147483647LL / kN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Geom g = {h, w, hp, wp, ws, shift};
  const float* ga = (const float*)gamma;
  const float* be = (const float*)beta;
  const float* bq = (const float*)bqkv;
  const float* bp = (const float*)bproj;
  const float* bi = (const float*)bias;
#define SEGLAND_ARGS x, ga, be, wqkv, bq, wproj, bp, bi, out, NW, g, eps, s
  if (dtype == 1) {
    switch (C) {
#define SEGLAND_CASE(c, w, st, rr) \
  case c: return (int)launch_section_bf16<SecPlan<c, w, st, rr>, false>(SEGLAND_ARGS);
      SEGLAND_SECTION_BUILDS(SEGLAND_CASE)
#undef SEGLAND_CASE
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef SEGLAND_ARGS
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = section_f32_floats(C) * sizeof(float) + 128;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(attn_section_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_section_f32_kernel<<<(unsigned)NW, kThreads, smem, s>>>(
      (const float*)x, ga, be, (const float*)wqkv, bq, (const float*)wproj, bp, bi, (float*)out,
      C, g, eps);
  return (int)cudaGetLastError();
}

// Registers a thread at launch, local (spill) bytes and dynamic shared memory
// of the bf16 build at width C, by cudaFuncGetAttributes.
extern "C" int segland_attn_section_attrs(int C, int* regs, int* local_bytes, int* smem) {
  cudaFuncAttributes a;
  cudaError_t err = cudaErrorInvalidValue;
  switch (C) {
#define SEGLAND_CASE(c, w, st, rr)                                              \
  case c:                                                                       \
    err = cudaFuncGetAttributes(&a, attn_section_wgmma_kernel<SecPlan<c, w, st, rr>, false>); \
    *smem = (int)SecPlan<c, w, st, rr>::SMEM;                                   \
    break;
    SEGLAND_SECTION_BUILDS(SEGLAND_CASE)
#undef SEGLAND_CASE
    default: break;
  }
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}
#else
// The bf16 kernel of segland_attn_section with its consumers' clock64() time by
// phase (setup, ring wait, wgmma, q/k/v epilogue, attention core, context copy,
// output epilogue) added to clocks[0..7) and the count of consumer warpgroups
// to clocks[7].
extern "C" int segland_attn_section_clocks(const void* x, const void* gamma, const void* beta,
                                           const void* wqkv, const void* bqkv, const void* wproj,
                                           const void* bproj, const void* bias, void* out,
                                           long long NW, int C, int nh, int h, int w, int hp,
                                           int wp, int ws, int shift, float eps, void* clocks,
                                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ws * ws != kN || nh * kHD != C || hp % ws || wp % ws || shift < 0 || shift >= ws)
    return (int)cudaErrorInvalidValue;
  if (NW <= 0) return (int)cudaSuccess;
  const Geom g = {h, w, hp, wp, ws, shift};
  switch (C) {
#define SEGLAND_CASE(c, w_, st, rr)                                                            \
  case c:                                                                                      \
    return (int)launch_section_bf16<SecPlan<c, w_, st, rr>, true>(                             \
        x, (const float*)gamma, (const float*)beta, wqkv, (const float*)bqkv, wproj,           \
        (const float*)bproj, (const float*)bias, out, NW, g, eps, (cudaStream_t)stream,        \
        (unsigned long long*)clocks);
    SEGLAND_SECTION_BUILDS(SEGLAND_CASE)
#undef SEGLAND_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif  // SEGLAND_PART
