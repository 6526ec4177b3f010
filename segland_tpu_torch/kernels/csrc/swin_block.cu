// A whole Swin block over window-partitioned tokens in one launch: the
// attention section, then LayerNorm2 -> fc1 -> GELU -> fc2 -> +residual on
// its output, without a trip through device memory in between.
//
// Replaces: segland_tpu/ops/pallas_attn.py:_swin_block_v3_pallas (kernel
// `_block_v3_kernel`, whose first half is `_v2_attn_body`) as
// `segland_swin_block`.
//
// Per window of N = 49 tokens and C channels (heads of 32), T bf16 or fp32:
//   a    = the attention section of attn_section.cu: T(x + proj), with the
//          pad mask and the shift regions from the window index
//   y2   = T(LN(a) * gamma2 + beta2)                 fp32 stats, fast variance
//   h    = T(gelu(T(T(y2 @ w1) + T(b1))))            tanh form in bf16, erf in fp32
//   o    = T(T(h @ w2) + T(b2))
//   out  = T(a + o)
// A pad token is zeroed after the first norm only: LN2 and the MLP run on its
// row of `a` as on any other and the row is written (the caller un-pads).
//
// What bounds it on an H100: operations.  One call at a swin-s stage shape of
// a batch of 8 1024^2 tiles is 2*NW*N*C*(4C + 2N) + 16*NW*N*C^2 = 141-149
// GFLOP against one read and one write of [NW, N, C] (206 MB at C=96, 15 MB
// at C=768) plus 24*C^2 bytes of weights, which every block re-reads from L2.
//
// Design (bf16, sm_90a): K3's section body (section_sm90.cuh) and K1's MLP
// body (mlp_sm90.cuh) in one warp-specialised block.  A block owns W windows
// (4 at C=96, 2 at C=128 to 384, 1 from C=512: K3's, but 2 at C=128, where 4
// spilled) as one flat [W*49, C] row matrix cut into m64 row tiles across
// window boundaries.  A producer
// warpgroup (one thread issuing TMA) streams one ring schedule in consumption
// order: every head's q, k, v columns and the projection's as [96, 64] tiles,
// then straight on the MLP's w1^T and w2^T tiles ([64, 64], 8 KB in the same
// 12 KB slots) of every (row group, pass) work item, so the first MLP tiles
// travel while the projection runs.  The two consumer warpgroups run the
// section as K3 does (LN into the swizzled A operand, q, k, v then the
// projection on wgmma with B from the ring, the context through the output
// rows), whose projection epilogue writes a = x + proj to the output rows in
// device memory (L2-resident: this block wrote them).  LN2 reads those rows
// into y's dead operand buffer, and the MLP runs as K1 does on the block's row
// tiles: at C <= 192 each warpgroup owns a row tile and h goes from the first
// product's accumulator into the A-register fragments of the second (at C =
// 96 in chunks of 64 hidden columns, not K1's 128); at
// C >= 384 the warpgroups split each row tile's output columns and share an h
// tile (double-buffered over the dead q/k/v buffers); at C = 768 two passes
// over the output columns, each recomputing h.  The final epilogue reads the
// residual a back from the output rows and overwrites them.  So the products
// and their rounding points are K3's then K1's, in the same k order: the
// output equals K3 then K1 (chip_smoke.py --phases k4 prints whether it is
// bit for bit).  A block's 49 * W rows fill its m64 tiles to 77%, where K1
// tiles the flat rows: the MLP half streams its weights (2 * C * H bytes a
// row group, from L2) and runs its products for the phantom rows too, and
// that stream bounds it at C >= 384 (PERF.md: a ring of its own 12-22 slots
// deep over the section's dead buffers gained 3% at C = 384).  Weights arrive
// K-major: wqkv^T [3C, C], wproj^T [C, C], w1^T [H, C], w2^T [C, H]
// (nn.Linear's [out, in]).  ops/fused_attn.py:BLOCK_BUILDS mirrors the build
// table and block_plan the arithmetic.
// swin-b's and swin-l's widths take the same body with K1's MLP tiling at each
// width (C = 128 and 256 h in registers, 512 and 1024 the shared h tile, 1024
// in two passes); where 96 does not divide C the projection's last pass is
// K3's narrower one.  At C = 1024 the ring has 5 slots, one more than the 4
// w2 tiles a warpgroup takes in turn, so the MLP body hands its last slot back
// before it passes the other warpgroup's (mlp_sm90.cuh:mlp_item).  At C = 1536 y streams in both halves: the section as
// K3's (y, then the context, written by the consumers to the block's scratch
// rows, fenced for TMA and announced on a `ready` mbarrier, each slot an A
// tile beside the weights), then the consumers write y2 = LN2(a) over y's
// scratch rows, fence them and announce them on `ready`'s third phase, and
// the MLP runs as K1's streamed-y build (each first-product slot y2's K tile
// beside both warpgroups' w1 tiles, three passes of 512 output columns).  One
// ring carries both: its slots span the MLP's 24 KB, the section's loads
// bring 20 KB of it.
// The fp32 build (exact FMA loops, no TF32) runs one window a block: the fp32
// section with `a` kept over y, then LN2 and the MLP 16 rows at a time with
// w1 and w2 read from device memory.  At C >= 1024, where `a` and y do not
// fit together, the section streams y a chunk at a time
// (attn_common.cuh:section_f32_stream), `a` stays in the output rows in
// device memory and LN2 reads it back, 8 rows a group as K1's fp32 build
// takes them there.  Its weights are input-major.
//
// Registers, spills, TFLOP/s and the phase split of each build: chip_smoke.py
// --phases k4 (PERF.md).

// segland-parts: 4
// kernels/__init__.py compiles this file four times, in parallel:
// -DSEGLAND_PART=0 (the entry points, the fp32 bodies and the served bf16
// builds at swin-t/s's C = 96, 192, 384, 768), 1 (their builds with phase
// clocks, segland_swin_block_clocks), 2 (the served bf16 builds at C = 128,
// 256, 512) and 3 (at C = 1024, 1536).  The builds at swin-b's and swin-l's
// widths have no clock build.
#ifndef SEGLAND_PART
#define SEGLAND_PART 0
#endif

#include "attn_common.cuh"
#include "mlp_sm90.cuh"
#include "section_geom.cuh"

// The bf16 launches cross parts: segland_swin_block (part 0) hands a build's
// arguments to the part that instantiates it.
namespace segland_k4 {
struct BlockArgs {
  const void *x, *wqkv, *wproj, *w1, *w2;
  const float *gamma, *beta, *bqkv, *bproj, *bias, *gamma2, *beta2, *b1, *b2;
  void *out, *scratch;  // scratch: y's (then y2's) and the context's rows, where y streams
  long long NW;
  int C, H;
  int h, w, hp, wp, ws, shift;
  float eps;
  cudaStream_t stream;
  unsigned long long* clocks;
};
// the served build of a width in part block_part(C) (part 1: the clock builds)
int launch_part0(const BlockArgs& a);
int launch_part1(const BlockArgs& a);
int launch_part2(const BlockArgs& a);
int launch_part3(const BlockArgs& a);
int attrs_part0(int C, int* regs, int* local_bytes, int* smem);
int attrs_part2(int C, int* regs, int* local_bytes, int* smem);
int attrs_part3(int C, int* regs, int* local_bytes, int* smem);
}  // namespace segland_k4

namespace {

// A build: the section's W windows a block and S ring slots (its producer a
// warpgroup), the MLP's RG warpgroups down the rows, CG across the output
// columns, NP passes and HS hidden columns a warpgroup and chunk (K1's).  Where
// the section streams y (YS, C = 1536) the MLP streams y2 too, and the ring's
// slots span the larger MLP slot.
template <int C_, int W_, int S_, int RG_, int CG_, int NP_, int HS_>
struct BlockPlan {
  static constexpr bool YS = SecPlan<C_, W_, S_, true>::YS;
  typedef mlp90::MlpTiles<C_, RG_, CG_, NP_, HS_, YS> Mlp;
  typedef SecPlan<C_, W_, S_, true, 1, (YS ? Mlp::SLOT : 0)> Sec;
  static constexpr size_t OFF_H = Sec::OFF_Q;    // h over the dead q, k, v buffers
  static_assert(Sec::RT % RG_ == 0, "row tiles split evenly into row groups");
  static_assert(Mlp::SLOT <= Sec::SLOT, "an MLP slot fits a ring slot");
  static_assert(OFF_H + Mlp::H_BYTES <= Sec::OFF_BAR, "h fits behind y");
  static_assert(!YS || (W_ == 1 && RG_ == 1), "a streamed y: one window, one row group");
  // the attention tile's rotation opaque (attn_wmma.cuh): at C = 128 its
  // derived offsets, hoisted out of the head loop, spilled 12-16 B
  static constexpr bool OPAQUE_ROT = C_ == 128;
};

// phases of the consumers' clock (the CLK build): the section's, then LN2,
// the h epilogue and the MLP's output epilogue (its ring waits and wgmma add
// to the section's)
enum { kClkLn2 = kClkPhases, kClkH, kClkMlpOut, kBlockPhases };
typedef mlp90::ItemClocks<kClkWait, kClkMma, kClkH, kClkMlpOut> BlockItemPh;

template <typename Pl, bool CLK>
__global__ void __launch_bounds__(Pl::Sec::THREADS, 1)
swin_block_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mp,
                        const __grid_constant__ CUtensorMap m1,
                        const __grid_constant__ CUtensorMap m2,
                        const __grid_constant__ CUtensorMap my,
                        const __grid_constant__ CUtensorMap mc, const bf16* __restrict__ x,
                        const float* __restrict__ gamma, const float* __restrict__ beta,
                        const float* __restrict__ bqkv, const float* __restrict__ bproj,
                        const float* __restrict__ bias, const float* __restrict__ gamma2,
                        const float* __restrict__ beta2, const float* __restrict__ b1,
                        const float* __restrict__ b2, bf16* out, bf16* scratch, long long NW,
                        int H, Geom geo, float eps, unsigned long long* __restrict__ clocks) {
  typedef typename Pl::Sec Sec;
  typedef typename Pl::Mlp Ml;
  constexpr int C = Sec::C, W = Sec::W, S = Sec::S;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));  // swizzle atoms
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Sec::OFF_BAR);  // then the empty ones
  uint64_t* ready = full + 2 * S;  // Pl::YS: y written, the context, then y2
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&full[S + s], 2);
    }
    if constexpr (Pl::YS) sm90::mbar_init(ready, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  // the block's real rows and its MLP work items (row group, pass)
  auto block_rows = [&](long long b) {
    const long long win0 = b * W;
    return (int)((NW - win0) < (long long)W ? (NW - win0) : (long long)W) * kN;
  };
  auto mlp_items = [](int rows) { return (rows + Ml::BM - 1) / Ml::BM * Ml::NP; };

  if (threadIdx.x >= 256) {
    // ---- producer: the section's weight tiles, then every MLP item's -------------
    sm90::regs_dec<sm90::kProducerRegs>();
    if (threadIdx.x == 256) {
      sm90::RingFill<Sec::SLOT, S> fill = {smem, full, 0, 0u};
      if constexpr (Pl::YS)
        produce_section_ys<Sec>(fill, &mq, &mp, &my, &mc, (int)(blockIdx.x * 64), ready);
      else
        produce_section<Sec>(fill, &mq, &mp);
      // the items, counted only now: a count kept from before the section's
      // stream stayed live across it and spilled this thread's 24 registers
      long long b = blockIdx.x;
      asm volatile("" : "+l"(b));
      const int items = mlp_items(block_rows(b)), nch = H / Ml::HC;
      if constexpr (Pl::YS) {
        sm90::mbar_wait(ready, 0u);  // its third phase: y2 is in the scratch rows
#pragma unroll 1
        for (int w = 0; w < items; ++w)
          mlp90::produce_item_ys<Ml>(fill, &m1, &m2, &my, (int)(b * 64), w % Ml::NP, nch);
      } else {
#pragma unroll 1
        for (int w = 0; w < items; ++w) mlp90::produce_item<Ml>(fill, &m1, &m2, w % Ml::NP, nch);
      }
    }
    return;
  }

  // ---- consumers: 8 warps --------------------------------------------------------
  sm90::regs_inc<sm90::kConsumerRegs>();
  const long long win0 = (long long)blockIdx.x * W;
  const int rows = block_rows(blockIdx.x);  // real rows of this block
  const bf16* xb = x + (size_t)win0 * kN * C;
  bf16* ob = out + (size_t)win0 * kN * C;
  unsigned char* ys = smem + Sec::OFF_Y;
  sm90::Ring<Sec::SLOT, S> q = {smem, full, 0, -1, 0u};
  sm90::PhaseClocks<CLK, kBlockPhases> clk;
  clk.start();
  // Pl::YS: the scratch holds y's rows (then y2's), then the context's, 64 a window
  bf16* ysg = Pl::YS ? scratch + (size_t)win0 * 64 * C : nullptr;
  bf16* csg = Pl::YS ? scratch + ((size_t)NW + win0) * 64 * C : nullptr;
  geom_section<Sec, Pl::OPAQUE_ROT>(q, smem, xb, ob, rows, win0, geo, gamma, beta, bqkv, bproj,
                                    bias, eps, clk, csg, ysg, ready);
  consumers_sync();  // a is in the output rows; neither warpgroup reads y any more

  const int cw = threadIdx.x / 32;
  const int g = cw / 4, rg = g / Ml::CG, cg = g % Ml::CG;
  unsigned char* hs = smem + Pl::OFF_H + (size_t)rg * 2 * Ml::KT2 * Ml::TILE;
  uint32_t hbuf = 0;
  const int items = mlp_items(rows), nch = H / Ml::HC;
  if constexpr (Pl::YS) {
    // y2 = LN2(a) over y's scratch rows (every y tile has arrived, so TMA is done
    // reading them), zeros past the real rows, made visible to TMA and announced
    sm90::ln_rows<C, sm90::kLnBatch<C>>(
        [&](int r) -> const bf16* { return r < rows ? ob + (size_t)r * C : nullptr; }, cw,
        kWarps, 64, gamma2, beta2, eps, [&](int r, int c, uint32_t val, float2) {
          *reinterpret_cast<uint32_t*>(ysg + (size_t)r * C + c) = val;
        });
    sm90::fence_async_all();
    consumers_sync();
    if (threadIdx.x == 0) sm90::mbar_arrive(ready);
    clk.template lap<kClkLn2>();
    // out = a + T(T(h @ w2) + T(b2)), pass by pass, as K1's streamed-y build
    for (int w = 0; w < items; ++w)
      mlp90::mlp_item_ys<Ml, BlockItemPh>(q, hs, hbuf, cg, 2 + rg, 128 * Ml::CG, nch,
                                          w % Ml::NP, b1, b2, nullptr, ob, ob, 0, rows, clk);
  } else {
    // y2 = LN2(a) over y, a warp a row; rows past the real ones are zero
    sm90::ln_rows_sw128<C, sm90::kLnBatch<C>>(
        [&](int r) -> const bf16* { return r < rows ? ob + (size_t)r * C : nullptr; }, cw,
        kWarps, Sec::RS, gamma2, beta2, eps, ys, Sec::YK);
    sm90::fence_async_smem();
    consumers_sync();
    clk.template lap<kClkLn2>();

    // out = a + T(T(h @ w2) + T(b2)), work item by work item, as K1; the ring's
    // slots now carry the MLP's tiles
    for (int w = 0; w < items; ++w) {
      const int rt = (w / Ml::NP) * Ml::RG + rg;
      mlp90::mlp_item<Ml, Sec::YK, BlockItemPh>(q, ys + rt * 64 * 128, hs, hbuf, cg, 2 + rg,
                                                128 * Ml::CG, nch, w % Ml::NP, b1, b2, nullptr,
                                                ob, ob, rt * 64, rows, clk);
    }
  }
  clk.flush(clocks);
}

// ---- fp32: exact FMA loops --------------------------------------------------
// rows a group of the fp32 MLP: 16, or 8 at C >= 1024 (K1's fp32 build, where 16
// rows' outputs spilled)
template <int C>
constexpr int kRG = C >= 1024 ? 8 : 16;
constexpr int kHCF = 64;  // hidden columns a chunk of the fp32 MLP

// shared memory of the fp32 block with `a` kept over the section's y, and
// whether that does not fit, so that the section streams y and `a` stays in
// the output rows (C >= 1024)
template <int C>
constexpr size_t block_f32_resident_bytes() {
  const size_t sec = (section_f32_floats(C) - (size_t)kN * C) * sizeof(float) + 128;
  const size_t mlp = ((size_t)kRG<C> * C + kRG<C> * kHCF) * sizeof(float);
  return (size_t)kN * C * sizeof(float) + max_size(sec, mlp);
}
template <int C>
constexpr bool kBlockF32Stream = block_f32_resident_bytes<C>() > kMaxSmem;
template <int C>
constexpr size_t block_f32_bytes() {
  if constexpr (kBlockF32Stream<C>)
    return max_size(section_f32_stream_floats(C) * sizeof(float) + 128,
                    ((size_t)kRG<C> * C + kRG<C> * kHCF) * sizeof(float));
  else
    return block_f32_resident_bytes<C>();
}

template <int C>
__global__ void __launch_bounds__(kThreads)
swin_block_f32_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, const float* __restrict__ wqkv,
                      const float* __restrict__ bqkv, const float* __restrict__ wproj,
                      const float* __restrict__ bproj, const float* __restrict__ bias,
                      const float* __restrict__ gamma2, const float* __restrict__ beta2,
                      const float* __restrict__ w1, const float* __restrict__ b1,
                      const float* __restrict__ w2, const float* __restrict__ b2, float* out,
                      int H, Geom g, float eps) {
  constexpr bool STREAM = kBlockF32Stream<C>;
  constexpr int RG = kRG<C>;
  constexpr int PER = RG * C / kThreads;      // output elements a thread
  constexpr int HPER = RG * kHCF / kThreads;  // hidden elements a thread
  constexpr int RSTEP = kThreads / kHCF;
  static_assert(RG * C % kThreads == 0, "C must be a multiple of 16");
  extern __shared__ __align__(128) unsigned char smem[];
  const long long win = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* ow = out + (size_t)win * kN * C;
  // a: over the section's y, or (STREAM) the output rows themselves
  float* as = STREAM ? ow : reinterpret_cast<float*>(smem);
  float* y2 = STREAM ? reinterpret_cast<float*>(smem) : as + kN * C;  // [RG, C]
  float* hs = y2 + RG * C;                                             // [RG, kHCF]
  const float* xw = x + (size_t)win * kN * C;
  auto keep_a = [&](int row, int c, float v) { as[row * C + c] = v; };
  // the section with C opaque, as K3's fp32 kernel takes it at run time: a
  // constant power of two would turn LN's divisions by C into multiplies that
  // the compiler fuses otherwise, and `a` would part from K3's in the last bit
  int cr = C;
  asm volatile("" : "+r"(cr));
  if constexpr (STREAM)
    section_f32_stream(xw, gamma, beta, wqkv, bqkv, wproj, bproj, bias, ow, cr, win, g, eps,
                       smem, keep_a);
  else
    section_f32(xw, gamma, beta, wqkv, bqkv, wproj, bproj, bias, ow, cr, win, g, eps, smem,
                keep_a);

  const int n = threadIdx.x % kHCF, rr0 = threadIdx.x / kHCF;
  for (int r0 = 0; r0 < kN; r0 += RG) {
    for (int r = warp; r < RG; r += kWarps) {
      if (r0 + r < kN) {
        ln_row_f32(as + (r0 + r) * C, C, gamma2, beta2, eps, 1.0f, y2 + r * C);
      } else {
        for (int c = lane; c < C; c += 32) y2[r * C + c] = 0.0f;
      }
    }
    __syncthreads();
    float acc[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] = 0.0f;
    for (int j0 = 0; j0 < H; j0 += kHCF) {
      float h[HPER];
#pragma unroll
      for (int i = 0; i < HPER; ++i) h[i] = 0.0f;
      for (int k = 0; k < C; ++k) {
        const float wv = w1[(size_t)k * H + j0 + n];
#pragma unroll
        for (int i = 0; i < HPER; ++i) h[i] += y2[(rr0 + RSTEP * i) * C + k] * wv;
      }
#pragma unroll
      for (int i = 0; i < HPER; ++i)
        hs[(rr0 + RSTEP * i) * kHCF + n] = gelu_erf(h[i] + b1[j0 + n]);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int e = threadIdx.x + kThreads * i;
        const int r = e / C, c = e % C;
        float s = acc[i];
        for (int k = 0; k < kHCF; ++k) s += hs[r * kHCF + k] * w2[(size_t)(j0 + k) * C + c];
        acc[i] = s;
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + kThreads * i;
      const int row = r0 + e / C, c = e % C;
      if (row < kN) ow[(size_t)row * C + c] = as[row * C + c] + (acc[i] + b2[c]);
    }
    // the chunk loop's last barrier stands between these reads of y2 and the next group's LN
    // (STREAM: each thread rewrites only the elements of `a` it read)
  }
}

typedef segland_k4::BlockArgs BlockArgs;

template <typename Pl, bool CLK>
cudaError_t launch_block_bf16(const BlockArgs& a) {
  typedef typename Pl::Sec Sec;
  constexpr int C = Sec::C;
  if (a.H % Pl::Mlp::HC != 0) return cudaErrorInvalidValue;
  CUtensorMap mq, mp, m1, m2, my{}, mc{};
  cudaError_t err = sm90::tile_map(&mq, a.wqkv, 3 * (uint64_t)C, C, 32);
  if (err == cudaSuccess) err = sm90::tile_map(&mp, a.wproj, C, C, 96);
  if (err == cudaSuccess) err = sm90::tile_map(&m1, a.w1, (uint64_t)a.H, C, 64);
  if (err == cudaSuccess) err = sm90::tile_map(&m2, a.w2, C, (uint64_t)a.H, 64);
  if (err != cudaSuccess) return err;
  if constexpr (Pl::YS) {
    // y's rows (then y2's) and the context's, 64 a window, [2 * NW * 64, C]
    if (!a.scratch) return cudaErrorInvalidValue;
    const bf16* ctx = (const bf16*)a.scratch + (size_t)a.NW * 64 * C;
    err = sm90::tile_map(&my, a.scratch, (uint64_t)a.NW * 64, C, 64);
    if (err == cudaSuccess) err = sm90::tile_map(&mc, ctx, (uint64_t)a.NW * 64, C, 64);
    if (err != cudaSuccess) return err;
  }
  auto kernel = swin_block_wgmma_kernel<Pl, CLK>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sec::SMEM);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((a.NW + Sec::W - 1) / Sec::W);
  kernel<<<grid, Sec::THREADS, Sec::SMEM, a.stream>>>(
      mq, mp, m1, m2, my, mc, (const bf16*)a.x, a.gamma, a.beta, a.bqkv, a.bproj, a.bias,
      a.gamma2, a.beta2, a.b1, a.b2, (bf16*)a.out, (bf16*)a.scratch, a.NW, a.H,
      Geom{a.h, a.w, a.hp, a.wp, a.ws, a.shift}, a.eps, a.clocks);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_block_f32(const BlockArgs& a) {
  if (a.H % kHCF != 0) return cudaErrorInvalidValue;
  constexpr size_t smem = block_f32_bytes<C>();
  static_assert(smem <= kMaxSmem, "over the shared memory a block can have");
  auto kernel = swin_block_f32_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)a.NW, kThreads, smem, a.stream>>>(
      (const float*)a.x, a.gamma, a.beta, (const float*)a.wqkv, a.bqkv, (const float*)a.wproj,
      a.bproj, a.bias, a.gamma2, a.beta2, (const float*)a.w1, a.b1, (const float*)a.w2, a.b2,
      (float*)a.out, a.H, Geom{a.h, a.w, a.hp, a.wp, a.ws, a.shift}, a.eps);
  return cudaGetLastError();
}

}  // namespace

// The bf16 builds, <C, W, S, RG, CG, NP, HS> (ops/fused_attn.py:BLOCK_BUILDS).
#define SEGLAND_BLOCK_BUILDS(X)    \
  X(96, 4, 5, 2, 1, 1, 64)         \
  X(128, 2, 8, 2, 1, 1, 64)        \
  X(192, 2, 8, 2, 1, 1, 64)        \
  X(256, 2, 7, 2, 1, 1, 64)        \
  X(384, 2, 5, 1, 2, 1, 64)        \
  X(512, 1, 10, 1, 2, 1, 64)       \
  X(768, 1, 7, 1, 2, 2, 64)        \
  X(1024, 1, 5, 1, 2, 2, 64)       \
  X(1536, 1, 7, 1, 2, 3, 64)

namespace {

// the part that compiles a width's served build: swin-t/s's widths 0 (their
// clock builds 1), swin-b's and swin-l's 2 and 3
constexpr int block_part(int c) {
  return (c == 96 || c == 192 || c == 384 || c == 768) ? 0 : (c <= 512 ? 2 : 3);
}

// build <c, ...> launched from part P: its served build in part block_part(c),
// its clock build (swin-t/s's widths) in part 1; elsewhere not instantiated
template <int P, int c, int w, int s, int rg, int cg, int np, int hs>
int launch_in_part(const BlockArgs& a) {
  typedef BlockPlan<c, w, s, rg, cg, np, hs> Pl;
  if constexpr (block_part(c) == P)
    return (int)launch_block_bf16<Pl, false>(a);
  else if constexpr (P == 1 && block_part(c) == 0)
    return (int)launch_block_bf16<Pl, true>(a);
  else
    return (int)cudaErrorInvalidValue;
}

template <int P, int c, int w, int s, int rg, int cg, int np, int hs>
int attrs_in_part(int* regs, int* local_bytes, int* smem) {
  if constexpr (block_part(c) == P) {
    typedef BlockPlan<c, w, s, rg, cg, np, hs> Pl;
    cudaFuncAttributes fa;
    const cudaError_t err = cudaFuncGetAttributes(&fa, swin_block_wgmma_kernel<Pl, false>);
    if (err != cudaSuccess) return (int)err;
    *regs = fa.numRegs;
    *local_bytes = (int)fa.localSizeBytes;
    *smem = (int)Pl::Sec::SMEM;
    return 0;
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

#define SEGLAND_CAT2(a, b) a##b
#define SEGLAND_CAT(a, b) SEGLAND_CAT2(a, b)

int segland_k4::SEGLAND_CAT(launch_part, SEGLAND_PART)(const BlockArgs& a) {
  switch (a.C) {
#define SEGLAND_CASE(c, ...) \
  case c: return launch_in_part<SEGLAND_PART, c, __VA_ARGS__>(a);
    SEGLAND_BLOCK_BUILDS(SEGLAND_CASE)
#undef SEGLAND_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

#if SEGLAND_PART != 1
int segland_k4::SEGLAND_CAT(attrs_part, SEGLAND_PART)(int C, int* regs, int* local_bytes,
                                                      int* smem) {
  switch (C) {
#define SEGLAND_CASE(c, ...) \
  case c: return attrs_in_part<SEGLAND_PART, c, __VA_ARGS__>(regs, local_bytes, smem);
    SEGLAND_BLOCK_BUILDS(SEGLAND_CASE)
#undef SEGLAND_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif

#if SEGLAND_PART == 0
namespace {
// the checks and arguments shared by the entry points
int block_args(BlockArgs* a, const void* x, const void* gamma, const void* beta,
               const void* wqkv, const void* bqkv, const void* wproj, const void* bproj,
               const void* bias, const void* gamma2, const void* beta2, const void* w1,
               const void* b1, const void* w2, const void* b2, void* out, void* scratch,
               long long NW, int C, int nh, int H, int h, int w, int hp, int wp, int ws,
               int shift, float eps, int device, void* stream, void* clocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ws * ws != kN || nh * kHD != C || hp % ws || wp % ws || shift < 0 || shift >= ws || H <= 0)
    return (int)cudaErrorInvalidValue;
  if (NW > 2147483647LL / 64) return (int)cudaErrorInvalidValue;
  *a = {x, wqkv, wproj, w1, w2,
        (const float*)gamma, (const float*)beta, (const float*)bqkv,
        (const float*)bproj, (const float*)bias, (const float*)gamma2,
        (const float*)beta2, (const float*)b1, (const float*)b2,
        out, scratch, NW, C, H, h, w, hp, wp, ws, shift, eps, (cudaStream_t)stream,
        (unsigned long long*)clocks};
  return 0;
}
}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, the four weight matrices, out);
// vectors and bias [nh, N, N] are fp32.  fp32 weights are input-major (w1 [C,
// H], w2 [H, C], wqkv [C, 3C], wproj [C, C]); bf16 weights K-major (their
// transposes: nn.Linear's [out, in]).  Windows of 7 x 7 tokens, heads of 32,
// C in {96, 128, 192, 256, 384, 512, 768, 1024, 1536}; scratch is bf16 [2 * NW
// * 64, C] for the build that streams y (C = 1536,
// ops/fused_attn.py:block_plan's "stream_y"), else null.  Returns a
// cudaError_t.
extern "C" int segland_swin_block(int dtype, const void* x, const void* gamma, const void* beta,
                                  const void* wqkv, const void* bqkv, const void* wproj,
                                  const void* bproj, const void* bias, const void* gamma2,
                                  const void* beta2, const void* w1, const void* b1,
                                  const void* w2, const void* b2, void* out, void* scratch,
                                  long long NW, int C, int nh, int H, int h, int w, int hp,
                                  int wp, int ws, int shift, float eps, int device,
                                  void* stream) {
  BlockArgs a;
  const int err = block_args(&a, x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, gamma2, beta2,
                             w1, b1, w2, b2, out, scratch, NW, C, nh, H, h, w, hp, wp, ws,
                             shift, eps, device, stream, nullptr);
  if (err || NW <= 0) return err;
  if (dtype == 1) {
    switch (block_part(C)) {
      case 0: return segland_k4::launch_part0(a);
      case 2: return segland_k4::launch_part2(a);
      default: return segland_k4::launch_part3(a);
    }
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 96: return (int)launch_block_f32<96>(a);
    case 128: return (int)launch_block_f32<128>(a);
    case 192: return (int)launch_block_f32<192>(a);
    case 256: return (int)launch_block_f32<256>(a);
    case 384: return (int)launch_block_f32<384>(a);
    case 512: return (int)launch_block_f32<512>(a);
    case 768: return (int)launch_block_f32<768>(a);
    case 1024: return (int)launch_block_f32<1024>(a);
    case 1536: return (int)launch_block_f32<1536>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Registers a thread at launch, local (spill) bytes and dynamic shared memory
// of the bf16 build at width C, by cudaFuncGetAttributes.
extern "C" int segland_swin_block_attrs(int C, int* regs, int* local_bytes, int* smem) {
  switch (block_part(C)) {
    case 0: return segland_k4::attrs_part0(C, regs, local_bytes, smem);
    case 2: return segland_k4::attrs_part2(C, regs, local_bytes, smem);
    default: return segland_k4::attrs_part3(C, regs, local_bytes, smem);
  }
}

// The bf16 kernel of segland_swin_block with its consumers' clock64() time by
// phase (setup, ring wait, wgmma, q/k/v epilogue, attention core, context
// copy, section output epilogue, LN2, h epilogue, MLP output epilogue) added
// to clocks[0..10) and the count of consumer warpgroups to clocks[10]; at C in
// {96, 192, 384, 768} only.
extern "C" int segland_swin_block_clocks(const void* x, const void* gamma, const void* beta,
                                         const void* wqkv, const void* bqkv, const void* wproj,
                                         const void* bproj, const void* bias, const void* gamma2,
                                         const void* beta2, const void* w1, const void* b1,
                                         const void* w2, const void* b2, void* out,
                                         void* scratch, long long NW, int C, int nh, int H,
                                         int h, int w, int hp, int wp, int ws, int shift,
                                         float eps, void* clocks, int device, void* stream) {
  BlockArgs a;
  const int err = block_args(&a, x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, gamma2, beta2,
                             w1, b1, w2, b2, out, scratch, NW, C, nh, H, h, w, hp, wp, ws,
                             shift, eps, device, stream, clocks);
  if (err || NW <= 0) return err;
  if (block_part(C) != 0) return (int)cudaErrorInvalidValue;
  return segland_k4::launch_part1(a);
}
#endif  // SEGLAND_PART == 0
