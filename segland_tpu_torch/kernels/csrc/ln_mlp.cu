// Fused LayerNorm -> fc1 -> GELU -> fc2 -> layer-scale -> +residual over
// [M, C] rows (the ConvNeXt block's MLP section, and the Swin block's).
//
// Replaces: segland_tpu/ops/pallas_mlp.py:_pallas_ln_mlp (body `_kernel`).
// Rounding points, in the compute dtype T (bf16 or fp32), as that kernel:
//   mu, var = fp32 mean and max(E[x^2] - mu^2, 0)
//   y   = T(((x - mu) * rsqrt(var + eps)) * gamma + beta)
//   h   = T(T(y @ w1) + T(b1))              fp32 accumulate
//   h   = T(gelu(h))                        tanh form for bf16, erf for fp32
//   o   = T(T(h @ w2) + T(b2)); o = T(o * T(ls))
//   out = T(res + o)
//
// What bounds it on an H100: 4*M*C*H flops against 3*M*C*sizeof(T) bytes of
// activations, with the [M, 4C] hidden kept out of device memory.  At the
// ConvNeXt-T stage shapes of a batch of 8 1024^2 tiles every call is 77
// GFLOP (M*C^2 is constant) against 300 MB (C=96) to 38 MB (C=768) of
// activations, so the tensor cores bound it, and the weights, re-read for
// every row tile from L2, are the traffic to keep on chip.
//
// Design (bf16, sm_90a): warp-specialised, persistent (one block an SM walks
// row tiles of BM = 64 RG rows).  Three warpgroups: one producer warp starts
// TMA loads of weight tiles, [64 rows, 64 K-columns] of bf16 (8 KB, 128-byte
// swizzle), into a ring of S slots guarded by a `full` and an `empty`
// mbarrier each, in exactly the order the consumers take them, across chunk,
// pass and row-tile boundaries, so that one tile's epilogue overlaps the next
// tile's loads.  Two consumer warpgroups (setmaxnreg moves registers to
// them) run wgmma.mma_async: RG of them down the rows, CG across the output
// columns.  Each normalises its share of the tile's rows into shared memory
// in the swizzled K-major layout a wgmma A descriptor reads.  The hidden
// dimension is walked in chunks of HC = CG * HS columns: the first product
// h = y @ w1[:, chunk] (m64 n64 k16, A and B from shared memory), the bias and
// GELU epilogue in registers, then acc2 += h @ w2[chunk, :].  Where one
// warpgroup owns all of a pass's output columns (CG = 1, C <= 192) h goes
// from the accumulator straight into the A-register fragments of the second
// product (the m64 accumulator layout is the k16 A-fragment layout) and never
// touches shared memory.  At C >= 384 a warpgroup owns 192 of them (96
// accumulator registers a thread): each computes HS of h's columns, writes
// them swizzled to a double-buffered h tile, and a named barrier shares them.
// At C = 768 the 384 output columns a warpgroup pair can hold are half of C,
// so a tile takes NP = 2 passes, each recomputing h (1.5x the operations of
// one pass); the blocks walk (row tile, pass) work items.  swin-b's and
// swin-l's widths: C = 128 and 256 as C <= 192 (h in registers; at C = 256 a
// warpgroup holds all 256 output columns, 128 accumulator registers a thread),
// C = 512 as C = 384 but with 256 columns a warpgroup, so one pass; C = 1024
// takes NP = 2 passes of 512 columns with its 128 KB y tile resident and an
// 8-slot ring.  At C = 1536 the 64-row y tile alone is 192 KB, and beside the
// 32 KB h tile not even a 2-slot ring fits.  Splitting C would still need all
// of y for every chunk of h, so y streams instead: a small kernel
// (ln_rows_kernel) writes y = LN(x) once to a scratch [M, C] in device memory
// (L2-resident at swin-l's 8192 rows a batch: 25 MB), and each first-product
// ring slot carries y's [64, 64] K tile beside the two warpgroups' w1 tiles
// (24 KB, 8 slots); a second-product slot carries both warpgroups' w2 tiles.
// That re-reads 24 tiles of y a hidden chunk from L2 (0.375 of the weight
// tiles' bytes) and needs no resident y; the tile takes NP = 3 passes of 512
// columns (2x the operations of one pass), where a wider pass would need
// registers a thread does not have.  Every slot's
// wgmmas sit between operand fences and wgmma.fence and outside any runtime
// branch (a warpgroup takes the slots of the other's columns and hands them
// back unread), or ptxas serialises them.  The GELU is evaluated as
// x / (1 + exp(-2u)) (mlp_sm90.cuh:gelu_tanh_fast).  The body is
// mlp_sm90.cuh, which swin_block.cu (K4) runs after its attention section.
// What holds each width back, by the
// measurement build's phase clocks, is in PERF.md.  Weights arrive K-major
// (w1t = w1^T [H, C], w2t = w2^T [C, H]): the wrapper passes nn.Linear's own
// [out, in] weights when the caller's [in, out] tensor is their transpose,
// else a cached K-major copy.  A box that
// reaches past C (C = 96: K 96 of a 128-column pair of tiles, output rows 96..
// 127 of w2t) is zero-filled by TMA and skipped by the k-loop, or computed by
// an n32 product.  Rows past M are zero on load and masked on store, so any M
// works.
// The fp32 path has no tensor-core form at fp32 precision and uses FMA loops.

// segland-parts: 4
// kernels/__init__.py compiles this file four times, in parallel:
// -DSEGLAND_PART=0 (the entry points, the fp32 builds and the served bf16
// builds at C = 96, 192, 384, 768), 1 (their builds with phase clocks, reached
// through segland_ln_mlp_clocks), 2 (the served bf16 builds at swin-b's and
// swin-l's C = 128, 256, 512, 1024, 1536) and 3 (theirs with phase clocks), so
// that no set lengthens another.
#ifndef SEGLAND_PART
#define SEGLAND_PART 0
#endif

#include "mlp_sm90.cuh"
#include <math.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kWarps = 8;  // fp32 build
constexpr int kThreads = kWarps * 32;
constexpr int kHC = 64;  // hidden columns per chunk, fp32 build

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

using sm90::warp_sum;

// LayerNorm of rows [row0, row0 + BM) into ys (row stride lds), one warp a
// row; rows at or past M become zeros.
template <typename T, int C, int BM, int NW>
__device__ void layer_norm_rows(const T* __restrict__ x, long long M, long long row0,
                                const float* __restrict__ gamma,
                                const float* __restrict__ beta, float eps, T* ys,
                                int lds) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += NW) {
    T* dst = ys + r * lds;
    const long long row = row0 + r;
    if (row >= M) {
      for (int c = lane; c < C; c += 32) dst[c] = from_f<T>(0.0f);
      continue;
    }
    const T* src = x + row * C;
    float s = 0.0f, ss = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float v = to_f(src[c]);
      s += v;
      ss += v * v;
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / C;
    const float var = fmaxf(ss / C - mu * mu, 0.0f);
    const float rs = rsqrtf(var + eps);
    for (int c = lane; c < C; c += 32) {
      const float y = (to_f(src[c]) - mu) * rs;
      dst[c] = from_f<T>(y * gamma[c] + beta[c]);
    }
  }
}

// ---- bf16: wgmma fed by a TMA ring (the body is mlp_sm90.cuh) ---------------
// A build: RG consumer warpgroups down the rows, CG across the output columns,
// NP passes over the output columns, HS hidden columns a warpgroup and chunk,
// S ring slots.  ops/fused_mlp.py:MLP_BUILDS mirrors the table in
// segland_ln_mlp and ln_mlp_plan this arithmetic.
constexpr size_t kSmemMax = 232448;  // shared memory a block can have on sm_90

// shared memory of a build that keeps its row groups' y resident: the ring of S
// 8 KB weight tiles, y, the double-buffered h tile (CG > 1), barriers, alignment
constexpr size_t resident_smem(int c, int rg, int cg, int hs, int s) {
  return (size_t)s * 8192 + (size_t)rg * ((c + 63) / 64) * 8192 +
         (cg == 1 ? 0 : (size_t)rg * 2 * (cg * hs / 64) * 8192) + 2 * (size_t)s * 8 + 1024;
}

// y streams through the ring where it would not fit resident (C = 1536)
template <int C_, int RG_, int CG_, int NP_, int HS_, int S_>
struct MlpPlan
    : mlp90::MlpTiles<C_, RG_, CG_, NP_, HS_, (resident_smem(C_, RG_, CG_, HS_, S_) > kSmemMax)> {
  typedef mlp90::MlpTiles<C_, RG_, CG_, NP_, HS_,
                          (resident_smem(C_, RG_, CG_, HS_, S_) > kSmemMax)> Tiles;
  static constexpr int S = S_;
  static constexpr int THREADS = 128 * (Tiles::NWG + 1);
  static constexpr size_t OFF_Y = (size_t)S * Tiles::SLOT;
  static constexpr size_t OFF_H =
      OFF_Y + (Tiles::YS ? 0 : (size_t)Tiles::RG * Tiles::KT1 * Tiles::TILE);
  static constexpr size_t OFF_BAR = OFF_H + Tiles::H_BYTES;
  static constexpr size_t SMEM = OFF_BAR + 2 * S * sizeof(uint64_t) + 1024;  // + alignment
  static_assert(SMEM <= kSmemMax, "over the shared memory a block can have");
};

// phases of the consumers' clock (the CLK build): LN, waiting for a ring slot,
// starting and waiting for wgmma, the h epilogue, the output epilogue
enum { kClkLn, kClkWait, kClkMma, kClkH, kClkOut, kClkPhases };
typedef mlp90::ItemClocks<kClkWait, kClkMma, kClkH, kClkOut> ItemPh;

template <typename Pl, bool CLK>
__global__ void __launch_bounds__(Pl::THREADS, 1)
ln_mlp_wgmma_kernel(const __grid_constant__ CUtensorMap m1, const __grid_constant__ CUtensorMap m2,
                    const __grid_constant__ CUtensorMap my, const bf16* __restrict__ x,
                    const bf16* __restrict__ res, const float* __restrict__ gamma,
                    const float* __restrict__ beta, const float* __restrict__ b1,
                    const float* __restrict__ b2, const float* __restrict__ ls,
                    bf16* __restrict__ out, long long M, int H, float eps,
                    unsigned long long* __restrict__ clocks) {
  constexpr int C = Pl::C, S = Pl::S, TILE = Pl::TILE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));  // swizzle atoms
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Pl::OFF_BAR);
  uint64_t* empty = full + S;
  const int wg = threadIdx.x / 128;
  const long long ntiles = (M + Pl::BM - 1) / Pl::BM;
  const int nch = H / Pl::HC;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], Pl::NWG);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (wg == Pl::NWG) {
    // ---- producer: one thread streams every weight tile (and y's) through the ring ----
    sm90::regs_dec<sm90::kProducerRegs>();
    if (threadIdx.x % 128 == 0) {
      sm90::RingFill<Pl::SLOT, S> fill = {smem, full, 0, 0u};
#pragma unroll 1
      for (long long w = blockIdx.x; w < ntiles * Pl::NP; w += gridDim.x) {
        if constexpr (Pl::YS)
          mlp90::produce_item_ys<Pl>(fill, &m1, &m2, &my, (int)((w / Pl::NP) * Pl::BM),
                                     (int)(w % Pl::NP), nch);
        else
          mlp90::produce_item<Pl>(fill, &m1, &m2, (int)(w % Pl::NP), nch);
      }
    }
    return;
  }

  // ---- consumers ----------------------------------------------------------------
  sm90::regs_inc<sm90::kConsumerRegs>();
  const int rg = wg / Pl::CG, cg = wg % Pl::CG;
  [[maybe_unused]] const int warp = (threadIdx.x % 128) / 32;
  [[maybe_unused]] unsigned char* ys = smem + Pl::OFF_Y + (size_t)rg * Pl::KT1 * TILE;
  unsigned char* hs = smem + Pl::OFF_H + (size_t)rg * 2 * Pl::KT2 * TILE;
  const int bar_id = 1 + rg, bar_n = 128 * Pl::CG;  // the warpgroups of a row group
  sm90::Ring<Pl::SLOT, S> q = {smem, full, 0, -1, 0u};
  uint32_t hbuf = 0;  // chunks so far: which h buffer is next
  const bf16* rsrc = res ? res : x;
  sm90::PhaseClocks<CLK, kClkPhases> clk;
  clk.start();

  // work items: (row tile, pass over the output columns)
  for (long long w = blockIdx.x; w < ntiles * Pl::NP; w += gridDim.x) {
    const long long row0 = (w / Pl::NP) * Pl::BM + rg * 64;
    const int p = (int)(w % Pl::NP);
    if constexpr (Pl::YS) {
      // y = LN(x) is in device memory (ln_rows_kernel) and arrives with w1
      mlp90::mlp_item_ys<Pl, ItemPh>(q, hs, hbuf, cg, bar_id, bar_n, nch, p, b1, b2, ls, rsrc,
                                     out, row0, M, clk);
    } else {
      // y = LN(x) of the row group's 64 rows; its other warpgroups take other rows
      sm90::ln_rows_sw128<C, sm90::kLnBatch<C>>(
          [&](int r) { return row0 + r < M ? x + (row0 + r) * C : nullptr; }, cg * 4 + warp,
          4 * Pl::CG, 64, gamma, beta, eps, ys, TILE);
      sm90::fence_async_smem();
      sm90::named_sync(bar_id, bar_n);
      clk.template lap<kClkLn>();
      mlp90::mlp_item<Pl, TILE, ItemPh>(q, ys, hs, hbuf, cg, bar_id, bar_n, nch, p, b1, b2, ls,
                                        rsrc, out, row0, M, clk);
    }
  }
  clk.flush(clocks);
}

// y = T(LN(x) * gamma + beta) of every row into y [M, C] (row-major bf16), a
// warp a row, for the builds that stream y: the same rounding as the resident
// path's ln_rows_sw128, read back by TMA in 64-row boxes
template <int C>
__global__ void __launch_bounds__(256)
ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, float eps, bf16* __restrict__ y, int M) {
  const int warp = blockIdx.x * 8 + threadIdx.x / 32;
  sm90::ln_rows<C, sm90::kLnBatch<C>>(
      [&](int r) { return x + (size_t)r * C; }, warp, gridDim.x * 8, M, gamma, beta, eps,
      [&](int r, int c, uint32_t val, float2) {
        *reinterpret_cast<uint32_t*>(y + (size_t)r * C + c) = val;
      });
}

// ---- fp32: FMA loops -----------------------------------------------------
// rows a block: 16, or 8 at C >= 1024, where 16 rows' outputs (96 a thread at
// C = 1536) spilled 2.3 KB a thread and ran 23x slower than the plain version
template <int C>
constexpr int kF32Rows = C >= 1024 ? 8 : 16;

template <int C>
__global__ void __launch_bounds__(kThreads)
ln_mlp_f32_kernel(const float* __restrict__ x, const float* __restrict__ res,
                  const float* __restrict__ gamma, const float* __restrict__ beta,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  const float* __restrict__ ls, float* __restrict__ out, long long M,
                  int H, float eps) {
  constexpr int BM = kF32Rows<C>;
  constexpr int PER = BM * C / kThreads;     // output elements per thread
  constexpr int HPER = BM * kHC / kThreads;  // hidden elements per thread
  static_assert(BM * C % kThreads == 0, "C must be a multiple of 16");
  extern __shared__ __align__(128) unsigned char smem[];
  float* ys = reinterpret_cast<float*>(smem);  // [BM, C]
  float* hs = ys + BM * C;                     // [BM, HC]
  const long long row0 = (long long)blockIdx.x * BM;

  layer_norm_rows<float, C, BM, kWarps>(x, M, row0, gamma, beta, eps, ys, C);
  __syncthreads();

  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.0f;
  const int n = threadIdx.x % kHC, r0 = threadIdx.x / kHC;
  constexpr int RSTEP = kThreads / kHC;
  for (int j0 = 0; j0 < H; j0 += kHC) {
    float h[HPER];
#pragma unroll
    for (int i = 0; i < HPER; ++i) h[i] = 0.0f;
    for (int k = 0; k < C; ++k) {
      const float w = w1[(size_t)k * H + j0 + n];
#pragma unroll
      for (int i = 0; i < HPER; ++i) h[i] += ys[(r0 + RSTEP * i) * C + k] * w;
    }
#pragma unroll
    for (int i = 0; i < HPER; ++i)
      hs[(r0 + RSTEP * i) * kHC + n] = gelu_erf(h[i] + b1[j0 + n]);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + kThreads * i;
      const int r = e / C, c = e % C;
      float s = acc[i];
      for (int k = 0; k < kHC; ++k) s += hs[r * kHC + k] * w2[(size_t)(j0 + k) * C + c];
      acc[i] = s;
    }
    __syncthreads();
  }
  const float* r_src = res ? res : x;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = threadIdx.x + kThreads * i;
    const long long row = row0 + e / C;
    const int c = e % C;
    if (row < M) {
      float o = acc[i] + b2[c];
      if (ls) o *= ls[c];
      const size_t idx = (size_t)row * C + c;
      out[idx] = r_src[idx] + o;
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// The bf16 builds, <C, RG, CG, NP, HS, S> (ops/fused_mlp.py:MLP_BUILDS).
#define SEGLAND_MLP_BUILDS(X)  \
  X(96, 2, 1, 1, 128, 12)      \
  X(128, 2, 1, 1, 128, 16)     \
  X(192, 2, 1, 1, 64, 16)      \
  X(256, 2, 1, 1, 64, 16)      \
  X(384, 1, 2, 1, 64, 16)      \
  X(512, 1, 2, 1, 64, 16)      \
  X(768, 1, 2, 2, 64, 12)      \
  X(1024, 1, 2, 2, 64, 8)      \
  X(1536, 1, 2, 3, 64, 8)

// The bf16 launches cross parts: segland_ln_mlp (part 0) hands a build's
// arguments to the part that instantiates it.
namespace segland_k1 {
struct MlpArgs {
  const void *x, *res;
  const float *gamma, *beta;
  const void* w1t;
  const float* b1;
  const void* w2t;
  const float *b2, *ls;
  void *out, *scratch;  // scratch: y [M, C] bf16, for the builds that stream y
  long long M;
  int C, H;
  float eps;
  cudaStream_t stream;
  unsigned long long* clocks;
};
// the served builds of a width in part mlp_part(C), its clock build in the next
int launch_part0(const MlpArgs& a);
int launch_part1(const MlpArgs& a);
int launch_part2(const MlpArgs& a);
int launch_part3(const MlpArgs& a);
int attrs_part0(int C, int* regs, int* local_bytes, int* smem);
int attrs_part2(int C, int* regs, int* local_bytes, int* smem);
}  // namespace segland_k1

namespace {

// the part that compiles a width's served build: convnext-t's and swin-t/s's
// widths 0, swin-b's and swin-l's 2 (their clock builds in parts 1 and 3)
constexpr int mlp_part(int c) { return (c == 96 || c == 192 || c == 384 || c == 768) ? 0 : 2; }

template <typename Pl, bool CLK>
cudaError_t launch_bf16(const segland_k1::MlpArgs& a) {
  if (a.H % Pl::HC != 0) return cudaErrorInvalidValue;
  CUtensorMap m1, m2, my{};
  cudaError_t err = sm90::tile_map(&m1, a.w1t, (uint64_t)a.H, (uint64_t)Pl::C, 64);
  if (err != cudaSuccess) return err;
  err = sm90::tile_map(&m2, a.w2t, (uint64_t)Pl::C, (uint64_t)a.H, 64);
  if (err != cudaSuccess) return err;
  if constexpr (Pl::YS) {
    // y = LN(x) once into the scratch, whose 64-row boxes (zero past M) come with w1
    if (!a.scratch || a.M > 2147483647LL) return cudaErrorInvalidValue;
    err = sm90::tile_map(&my, a.scratch, (uint64_t)a.M, (uint64_t)Pl::C, 64);
    if (err != cudaSuccess) return err;
    const long long blocks = (a.M + 7) / 8;
    ln_rows_kernel<Pl::C><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, a.stream>>>(
        (const bf16*)a.x, a.gamma, a.beta, a.eps, (bf16*)a.scratch, (int)a.M);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  auto kernel = ln_mlp_wgmma_kernel<Pl, CLK>;
  err = allow_smem(kernel, Pl::SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long items = (a.M + Pl::BM - 1) / Pl::BM * Pl::NP;  // (row tile, pass)
  const unsigned grid = (unsigned)(items < sms ? items : sms);
  kernel<<<grid, Pl::THREADS, Pl::SMEM, a.stream>>>(
      m1, m2, my, (const bf16*)a.x, (const bf16*)a.res, a.gamma, a.beta, a.b1, a.b2, a.ls,
      (bf16*)a.out, a.M, a.H, a.eps, a.clocks);
  return cudaGetLastError();
}

// build <c, ...> launched from part P: its served build in part mlp_part(c),
// its clock build in the part after it; elsewhere not instantiated
template <int P, int c, int rg, int cg, int np, int hs, int st>
int launch_in_part(const segland_k1::MlpArgs& a) {
  if constexpr (mlp_part(c) == (P & ~1))
    return (int)launch_bf16<MlpPlan<c, rg, cg, np, hs, st>, (P & 1) != 0>(a);
  else
    return (int)cudaErrorInvalidValue;
}

template <int P, int c, int rg, int cg, int np, int hs, int st>
int attrs_in_part(int* regs, int* local_bytes, int* smem) {
  if constexpr (mlp_part(c) == P) {
    typedef MlpPlan<c, rg, cg, np, hs, st> Pl;
    cudaFuncAttributes fa;
    const cudaError_t err = cudaFuncGetAttributes(&fa, ln_mlp_wgmma_kernel<Pl, false>);
    if (err != cudaSuccess) return (int)err;
    *regs = fa.numRegs;
    *local_bytes = (int)fa.localSizeBytes;
    *smem = (int)Pl::SMEM;
    return 0;
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

template <int C>
cudaError_t launch_f32(const void* x, const void* res, const float* gamma,
                       const float* beta, const void* w1, const float* b1,
                       const void* w2, const float* b2, const float* ls, void* out,
                       long long M, int H, float eps, cudaStream_t stream) {
  if (H % kHC != 0) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(kF32Rows<C> * C + kF32Rows<C> * kHC) * sizeof(float);
  auto kernel = ln_mlp_f32_kernel<C>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((M + kF32Rows<C> - 1) / kF32Rows<C>);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const float*)x, (const float*)res, gamma, beta, (const float*)w1, b1,
      (const float*)w2, b2, ls, (float*)out, M, H, eps);
  return cudaGetLastError();
}

}  // namespace

#define SEGLAND_CAT2(a, b) a##b
#define SEGLAND_CAT(a, b) SEGLAND_CAT2(a, b)

int segland_k1::SEGLAND_CAT(launch_part, SEGLAND_PART)(const MlpArgs& a) {
  switch (a.C) {
#define SEGLAND_CASE(c, rg, cg, np, hs, st) \
  case c: return launch_in_part<SEGLAND_PART, c, rg, cg, np, hs, st>(a);
    SEGLAND_MLP_BUILDS(SEGLAND_CASE)
#undef SEGLAND_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

#if SEGLAND_PART == 0 || SEGLAND_PART == 2
int segland_k1::SEGLAND_CAT(attrs_part, SEGLAND_PART)(int C, int* regs, int* local_bytes,
                                                      int* smem) {
  switch (C) {
#define SEGLAND_CASE(c, rg, cg, np, hs, st) \
  case c: return attrs_in_part<SEGLAND_PART, c, rg, cg, np, hs, st>(regs, local_bytes, smem);
    SEGLAND_MLP_BUILDS(SEGLAND_CASE)
#undef SEGLAND_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif

#if SEGLAND_PART == 0
namespace {
// the bf16 build at width C, its served build or (clocks) its clock build
int launch_build(const segland_k1::MlpArgs& a, bool clocks) {
  const int part = mlp_part(a.C) + (clocks ? 1 : 0);
  switch (part) {
    case 0: return segland_k1::launch_part0(a);
    case 1: return segland_k1::launch_part1(a);
    case 2: return segland_k1::launch_part2(a);
    default: return segland_k1::launch_part3(a);
  }
}
}  // namespace

// dtype: 0 = float32 (w1 [C, H] and w2 [H, C], input-major), 1 = bfloat16
// (w1 and w2 K-major: w1t [H, C] and w2t [C, H], nn.Linear's [out, in]).
// res and ls may be null; scratch is y [M, C] bf16 for the bf16 builds that
// stream y (C = 1536, ops/fused_mlp.py:ln_mlp_plan's "stream_y"), else null.
// Returns a cudaError_t; cudaErrorInvalidValue for a C or H this build does
// not take.
extern "C" int segland_ln_mlp(int dtype, const void* x, const void* res,
                              const void* gamma, const void* beta, const void* w1,
                              const void* b1, const void* w2, const void* b2,
                              const void* ls, void* out, void* scratch, long long M, int C, int H,
                              float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const float* g = (const float*)gamma;
  const float* bt = (const float*)beta;
  const float* bb1 = (const float*)b1;
  const float* bb2 = (const float*)b2;
  const float* l = (const float*)ls;
  if (dtype == 1) {
    const segland_k1::MlpArgs a = {x, res, g, bt, w1, bb1, w2, bb2, l, out, scratch,
                                   M, C,  H,   eps, s, nullptr};
    return launch_build(a, false);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
#define SEGLAND_ARGS x, res, g, bt, w1, bb1, w2, bb2, l, out, M, H, eps, s
  switch (C) {
    case 96: err = launch_f32<96>(SEGLAND_ARGS); break;
    case 128: err = launch_f32<128>(SEGLAND_ARGS); break;
    case 192: err = launch_f32<192>(SEGLAND_ARGS); break;
    case 256: err = launch_f32<256>(SEGLAND_ARGS); break;
    case 384: err = launch_f32<384>(SEGLAND_ARGS); break;
    case 512: err = launch_f32<512>(SEGLAND_ARGS); break;
    case 768: err = launch_f32<768>(SEGLAND_ARGS); break;
    case 1024: err = launch_f32<1024>(SEGLAND_ARGS); break;
    case 1536: err = launch_f32<1536>(SEGLAND_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SEGLAND_ARGS
  return (int)err;
}

// Registers a thread at launch, local (spill) bytes and dynamic shared memory
// of the bf16 build at width C, by cudaFuncGetAttributes.
extern "C" int segland_ln_mlp_attrs(int C, int* regs, int* local_bytes, int* smem) {
  return mlp_part(C) == 0 ? segland_k1::attrs_part0(C, regs, local_bytes, smem)
                          : segland_k1::attrs_part2(C, regs, local_bytes, smem);
}

extern "C" const char* segland_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The bf16 kernel of segland_ln_mlp with its consumers' clock64() time by phase
// (LN, ring wait, wgmma, h epilogue, output epilogue) added to clocks[0..5)
// and the count of consumer warpgroups to clocks[5].
extern "C" int segland_ln_mlp_clocks(const void* x, const void* res, const void* gamma,
                                     const void* beta, const void* w1, const void* b1,
                                     const void* w2, const void* b2, const void* ls, void* out,
                                     void* scratch, long long M, int C, int H, float eps,
                                     void* clocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0) return (int)cudaSuccess;
  const segland_k1::MlpArgs a = {x,
                                 res,
                                 (const float*)gamma,
                                 (const float*)beta,
                                 w1,
                                 (const float*)b1,
                                 w2,
                                 (const float*)b2,
                                 (const float*)ls,
                                 out,
                                 scratch,
                                 M,
                                 C,
                                 H,
                                 eps,
                                 (cudaStream_t)stream,
                                 (unsigned long long*)clocks};
  return launch_build(a, true);
}
#endif  // SEGLAND_PART == 0
