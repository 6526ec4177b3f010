// int8 ResNet bottleneck kernels: the whole eval-mode block as two kernels
// behind one wrapper call (K7: segland_bottleneck_conv1, then
// segland_bottleneck_conv23), and its last stage alone, conv3 + residual (K8:
// segland_conv3_residual_int8).
//
// Replaces: segland_tpu/ops/pallas_bottleneck.py:fused_bottleneck_int8 (body
// `_kernel`) and :conv3_residual_int8 (body `_conv3_kernel`).
//
//   xq  = clip(rint(x / s_x))                      x bf16 [B,H,W,C]
//   h1q = clip(rint(relu(xq.w1 * a1 + b1) / s_h1)) 1x1, [C,P]; 0 outside the image
//   h2q = clip(rint(relu(h1q*w2 * a2 + b2) / s_h2)) 3x3, dilation d, zero padded
//   out = bf16(relu?(h2q.w3 * a3 + b3 + x))        1x1, [P,C]; the residual is x itself
//
// Every product is int8 x int8 -> int32 on the tensor cores, so every sum is
// exact, and every fp32 step is the plain version's (ops/fused_bottleneck.py),
// in its order: multiply and add stay unfused, rounding is half-even, and the
// requantization takes the plain version's true quotient (see quant_n()).  The
// kernels therefore give the plain version's bits.
//
// What bounds K7 on an H100: operations at resnet50's layer4 (C 2048, P 512:
// 1.17 TOP against 1.07 GB of input and output at 8 x 128^2 pixels), bytes at
// the narrower layers.
//
// K7's design (sm_90a).  The TPU kernel held th + 2d whole rows of the image
// and all three weight sets on chip.  A block here has 227 KB of shared
// memory, and one launch that keeps h1q on chip must hold a tile's halo'd
// footprint of it, which at layer4 (d = 4) leaves 8x8 tiles recomputing conv1
// 4 times.  So K7 is two kernels, and h1q goes through device memory as int8
// (2 * M * P bytes there and back, 134 MB at layer4 beside the 1.07 GB of x
// and out; the int32 sums stay on chip):
//   conv1   h1q [B,H,W,P] = requant(relu(quant(x) . w1 * a1 + b1)) over
//           tiles of 64 * RG rows.  A slot of the ring holds a k chunk (64
//           channels): the tile's x rows as TMA brings them (bf16) and w1's
//           [P, 64] K-major slice.  The two consumer warpgroups quantize the
//           rows into the slot's A operand, half each, then multiply, and
//           quantize the next chunk while the tensor cores run; they keep all
//           P columns of the rows in int32 accumulators (m64 n <= 256 each)
//           across the k loop, so x is read and quantized once.
//   conv23  an 8 x 16 pixel tile: conv2 as an implicit GEMM, one 4-D TMA box
//           of h1q a tap and 64 input channels, landing at the tap's offset
//           (y0 + (ti - 1) d, x0 + (tj - 1) d) already swizzled as the A
//           operand (TMA zero-fills what lies outside the image: the 3x3's
//           zero padding of h1q, and the ragged edges), beside w2's [NW, 64]
//           slice for the tap; h2q goes into a swizzled shared tile, and conv3
//           runs from it against w3's slices.  Its epilogue takes the residual
//           from a slot that TMA filled with the tile's x, writes the bf16
//           output over it and has TMA store it (clipped to the image).
// Both are persistent (a block an SM walks the tiles) and warp-specialised:
// one thread of a producer warpgroup fills a ring of slots guarded by full /
// empty mbarriers (sm90.cuh), across tile boundaries, while two consumer
// warpgroups run wgmma.mma_async m64nNk32.s32.s8.s8 with both operands in
// shared memory; the epilogues' (a, b) vectors sit in shared memory too.
// Weights arrive K-major ([P][C], [9][P][P] as (tap, out, in), [C][P]).  Any
// H and W; C a multiple of 64; P in 64, 128, 256, 512 (bottleneck_plan in
// ops/fused_bottleneck.py says why).
//
// What bounds K8 on an H100: bytes.  At resnet50's layer4 (P 512, C 2048,
// M = 16 x 128^2) res and out are 1.07 GB each and h2q 134 MB, 0.68 ms, against
// 0.55 TOP of int8 products, 0.28 ms.  K8's design (sm_90a) is conv23's conv3
// stage as a kernel of its own: persistent and warp-specialised like K7, a
// block walks row tiles of 128 rows; a tile's h2q comes by TMA into shared
// memory once and serves every column pass (a grid of output tiles would read
// it from L2 once a block of columns), w3's K-major slices stream through one
// ring and the residual, 64 channels a piece, through another, a few passes
// ahead; the epilogue writes the output over the residual's slot and TMA
// stores it (clipped at M), its smem read awaited one piece later.

// segland-parts: 5
// kernels/__init__.py compiles this file five times, in parallel:
// -DSEGLAND_PART=0 (K8, K7's conv1, the entry points), 1 and 2 (K7's conv23
// builds at P = 64, 128 and at P = 256, 512), 3 and 4 (the measurement builds
// with phase clocks: K7's conv1 and K8, segland_bottleneck_conv1_clocks and
// segland_conv3_residual_int8_clocks, and K7's conv23,
// segland_bottleneck_conv23_clocks), so that those do not lengthen the rest.
#ifndef SEGLAND_PART
#define SEGLAND_PART 0
#endif

#include "sm90.cuh"

namespace {

// clip(rint(v / s), -127, 127) of N values at once.  v * (1/s) differs from
// the true quotient by under 3e-5 wherever the result is not clipped, so the
// two round alike unless the product lies within 1e-3 of a tie; there the
// division decides.  Clamping to [-127, 127] before rounding gives the same
// integers, and adding 1.5 * 2^23 rounds a float that small half to even
// into the low bits of the sum: no conversion instruction (a quarter-rate
// pipe) on the common path, and no branch, so the N values' arithmetic
// overlaps; a batch holding a near-tie goes back for it.
template <int N>
__device__ __forceinline__ void quant_n(const float (&v)[N], float s, float inv, int (&q)[N]) {
  constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23
  bool near = false;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float t = fminf(fmaxf(__fmul_rn(v[i], inv), -127.0f), 127.0f);
    const float y = __fadd_rn(t, kMagic);
    near |= fabsf(fabsf(__fsub_rn(t, __fsub_rn(y, kMagic))) - 0.5f) < 1e-3f;
    q[i] = __float_as_int(y) - __float_as_int(kMagic);
  }
  if (near) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float t = fminf(fmaxf(__fmul_rn(v[i], inv), -127.0f), 127.0f);
      if (fabsf(fabsf(t - (float)q[i]) - 0.5f) < 1e-3f)
        q[i] = (int)fminf(fmaxf(rintf(__fdiv_rn(v[i], s)), -127.0f), 127.0f);
    }
  }
}

// four int8 in a word, the first in the low byte
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16) |
         ((uint32_t)(d & 0xff) << 24);
}

__device__ __forceinline__ uint16_t pack2(int a, int b) {
  return (uint16_t)((a & 0xff) | ((b & 0xff) << 8));
}

// relu(acc * a + b), multiply and add unfused as in the plain version
__device__ __forceinline__ float affine_relu(int acc, float a, float b) {
  return fmaxf(__fadd_rn(__fmul_rn((float)acc, a), b), 0.0f);
}

// four bf16 (two a word, the lower address in the low half) -> four int8
__device__ __forceinline__ uint32_t quant4_bf16(const uint2& w, float s, float inv) {
  const float v[4] = {__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                      __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u)};
  int q[4];
  quant_n(v, s, inv, q);
  return pack4(q[0], q[1], q[2], q[3]);
}

// ---------------------------------------------------------------------------
// K7: the plans (ops/fused_bottleneck.py:bottleneck_plan mirrors them)
// ---------------------------------------------------------------------------
constexpr int kK7Threads = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kChunk = 64;       // bytes of K (int8 channels) a ring slot holds
constexpr int kBarBytes = 128;   // room for 8 full and 8 empty mbarriers
constexpr int kAlign = 1024;     // slack to align the dynamic shared memory

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// conv1 at P output columns: a warpgroup holds NW = min(P, 256) of them (m64
// nNW, NW / 2 int32 registers a thread); CG = P / NW warpgroups across P and
// RG = 2 / CG down the rows.  A slot holds a chunk's x rows as TMA brings them
// (bf16, 128-byte swizzle), their quantized rows (A) and w1's slice (B).
template <int P_>
struct Conv1Plan {
  static constexpr int P = P_;
  static constexpr int NW = cmin(P, 256), CG = P / NW, RG = 2 / CG, BM = 64 * RG;
  static constexpr int A_OFF = BM * 2 * kChunk, B_OFF = A_OFF + BM * kChunk;
  static constexpr int SLOT = B_OFF + P * kChunk;
  static constexpr int VEC = P * 8;  // (a1, b1) by column
  static constexpr int S = cmin(8, (232448 - kAlign - kBarBytes - VEC) / SLOT);
  static constexpr int OFF_VEC = S * SLOT, OFF_BAR = OFF_VEC + VEC;
  static constexpr int SMEM = OFF_BAR + kBarBytes + kAlign;
  static_assert(P % NW == 0 && CG * RG == 2, "P = 64, 128, 256 or 512");
  static_assert(S >= 2 && SMEM <= 232448, "over the shared memory a block can have");
};

// conv23 on TH x TW = 8 x 16 pixels (BM = 128 rows, 64 a warpgroup): conv2 in
// NP2 passes of NW = min(P, 256) output columns, conv3 in C / NW3 passes.  A
// slot holds a tap's h1q box and w2's slice, or w3's slice, or 64 channels of
// the tile's residual x (bf16, 128-byte swizzle), which the epilogue
// overwrites with the output for TMA to store; h2q stays in shared memory
// (BM x P), and so do a pass's (a, b) columns (VEC bytes a warpgroup).
template <int P_, int NW3_>
struct Conv23Plan {
  static constexpr int P = P_, NW3 = NW3_;
  static constexpr int TH = 8, TW = 16, BM = TH * TW;
  static constexpr int NW = cmin(P, 256), NP2 = P / NW, KC = P / kChunk;
  static constexpr int A_BYTES = BM * kChunk, R_BYTES = BM * 2 * kChunk;
  static constexpr int SLOT = cmax(cmax(A_BYTES + NW * kChunk, NW3 * kChunk), R_BYTES);
  static constexpr int H2_BYTES = BM * P, VEC = 256 * 8;
  static constexpr int S = cmin(8, (232448 - kAlign - kBarBytes - H2_BYTES - 2 * VEC) / SLOT);
  static constexpr int OFF_H2 = S * SLOT, OFF_VEC = OFF_H2 + H2_BYTES;
  static constexpr int OFF_BAR = OFF_VEC + 2 * VEC;
  static constexpr int SMEM = OFF_BAR + kBarBytes + kAlign;
  static_assert(P % NW == 0 && (NW3 == 64 || NW3 == 128), "tile shapes");
  static_assert(S >= 2 && SMEM <= 232448, "over the shared memory a block can have");
};

// K8 on row tiles of BM = 128 rows (64 a warpgroup), NW3 output columns a
// pass, P up to 64 KCMAX: h2q [BM, P] stays in shared memory (KC chunks of
// [BM, 64] bytes); SW slots of w3's [NW3, 64] slices; SR slots of a residual
// piece [BM, 64] bf16 (128-byte swizzle), over which the epilogue writes the
// output; a pass's (a3, b3) columns (VEC bytes a warpgroup).  The residual
// gets up to 6 slots (a few passes ahead), the slices what is left, up to 8.
// ops/fused_bottleneck.py:conv3_plan mirrors this arithmetic.
template <int NW3_, int KCMAX_>
struct Conv3Plan {
  static constexpr int NW3 = NW3_, KCMAX = KCMAX_;
  static constexpr int BM = 128, PIECES = NW3 / 64;
  static constexpr int H2_CHUNK = BM * kChunk, H2_BYTES = KCMAX * H2_CHUNK;
  static constexpr int WSLOT = NW3 * kChunk, RSLOT = BM * 2 * kChunk, VEC = NW3 * 8;
  static constexpr int BARS = 8 * (2 * 8 + 2 * 8 + 2 * KCMAX);  // W, R and h2q, full and empty
  static constexpr int ROOM = 232448 - kAlign - BARS - H2_BYTES - 2 * VEC;
  static constexpr int SR = cmin(6, (ROOM - 4 * WSLOT) / RSLOT);
  static constexpr int SW = cmin(8, (ROOM - SR * RSLOT) / WSLOT);
  static constexpr int OFF_W = H2_BYTES, OFF_R = OFF_W + SW * WSLOT;
  static constexpr int OFF_VEC = OFF_R + SR * RSLOT, OFF_BAR = OFF_VEC + 2 * VEC;
  static constexpr int SMEM = OFF_BAR + BARS + kAlign;
  static_assert(NW3 == 64 || NW3 == 128, "a wgmma of 64 or 128 columns");
  static_assert(SR >= PIECES + 1 && SW >= 2, "a pass's pieces and one more, two slices");
  static_assert(SMEM <= 232448, "over the shared memory a block can have");
};

// the dynamic shared memory from its first kAlign-aligned byte (an offset
// into the array, so that the compiler still sees shared memory)
__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  return p + ((kAlign - (sm90::smem_u32(p) & (kAlign - 1))) & (kAlign - 1));
}

// row and column of accumulator register i (of a pair i, i + 1) of an m64nN
// wgmma, for thread t of the warpgroup
__device__ __forceinline__ int acc_row(int t, int i) {
  return 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int acc_col(int t, int i) { return 8 * (i / 4) + 2 * (t % 4); }

// one 64-byte k chunk of a warpgroup's m64nN product: both k32 steps, between
// the operand fences, as one wgmma group; the slot read before goes back
template <int N, int B, int S>
__device__ __forceinline__ void mma_chunk(sm90::Ring<B, S>& q, int (&acc)[N / 2], uint64_t da,
                                          uint64_t db) {
  sm90::reg_fence(acc);
  sm90::wgmma_fence();
  sm90::wgmma_s8<N>(acc, da, db);
  sm90::wgmma_s8<N>(acc, sm90::desc_step(da, 1), sm90::desc_step(db, 1));
  sm90::wgmma_commit();
  sm90::ring_used(q);
  sm90::reg_fence(acc);
  sm90::ring_next(q);
}

template <int R>
__device__ __forceinline__ void zero_acc(int (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0;
  sm90::reg_fence(acc);
}

// (a[c], b[c]) of N columns into vec, by one warpgroup (barrier 1 + wg):
// behind the warpgroup's last reads of vec, ahead of its next
template <int N>
__device__ __forceinline__ void stage_vec(float2* vec, const float* __restrict__ a,
                                          const float* __restrict__ b, int wg) {
  const int t = threadIdx.x % 128;
  float2 v[(N + 127) / 128];
#pragma unroll
  for (int u = 0; u < (N + 127) / 128; ++u)
    if (t + 128 * u < N) v[u] = make_float2(a[t + 128 * u], b[t + 128 * u]);
  sm90::named_sync(1 + wg, 128);
#pragma unroll
  for (int u = 0; u < (N + 127) / 128; ++u)
    if (t + 128 * u < N) vec[t + 128 * u] = v[u];
  sm90::named_sync(1 + wg, 128);
}

// S full barriers (the producer's arrival with the TMA bytes), then S empty
// ones (one arrival a consumer warpgroup)
template <int S>
__device__ __forceinline__ void init_ring(uint64_t* full) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&full[S + s], 2);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
}

// phases of the consumers' clocks in the measurement builds (PhaseClocks)
enum { kC1Wait, kC1Quant, kC1Mma, kC1Epi, kC1Phases };
enum { kC2Wait, kC2Mma, kC2Epi, kC3Wait, kC3Mma, kC3Epi, kC23Phases };
enum { kK8Wait, kK8Mma, kK8ResWait, kK8Epi, kK8Phases };

#if SEGLAND_PART == 0 || SEGLAND_PART == 3
// ---------------------------------------------------------------------------
// K7 conv1: h1q [M][P] int8 = requant(relu(quant(x) . w1 * a1 + b1))
// ---------------------------------------------------------------------------
// Persistent: a block walks row tiles blockIdx.x, + gridDim.x, ...; a k chunk
// of a tile is a slot: TMA brings the tile's x rows (bf16) and w1's slice,
// the consumer warpgroups quantize the rows into the slot's A operand, half
// of them each, and multiply while they quantize the next chunk.
// CLK builds add the consumers' clock64() time by phase to clocks.
template <int P, bool CLK>
__global__ void __launch_bounds__(kK7Threads, 1)
bottleneck_conv1_kernel(const __grid_constant__ CUtensorMap mx,
                        const __grid_constant__ CUtensorMap mw1, const float* __restrict__ a1,
                        const float* __restrict__ b1, int8_t* __restrict__ h1q, long long M,
                        int C, float s_x, float s_h1, unsigned long long* __restrict__ clocks) {
  typedef Conv1Plan<P> Pl;
  constexpr int S = Pl::S, SLOT = Pl::SLOT, NW = Pl::NW, BM = Pl::BM;
  extern __shared__ unsigned char k7_smem[];
  unsigned char* smem = align_smem(k7_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Pl::OFF_BAR);
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int ntiles = (int)((M + BM - 1) / BM), nk = C / kChunk;
  float2* vec = reinterpret_cast<float2*>(smem + Pl::OFF_VEC);  // (a1, b1) by column
  for (int c = threadIdx.x; c < P; c += kK7Threads) vec[c] = make_float2(a1[c], b1[c]);
  init_ring<S>(full);

  if (wg == 2) {
    // ---- producer: one thread streams every slot in the consumers' order ----
    if (t == 0) {
      sm90::RingFill<SLOT, S> fill = {smem, full, 0, 0u};
#pragma unroll 1
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x)
#pragma unroll 1
        for (int kc = 0; kc < nk; ++kc) {
          unsigned char* dst = fill.next(BM * 2 * kChunk + P * kChunk);
          sm90::tma_load_2d(dst, &mx, fill.bar(), kc * kChunk, tile * BM);
#pragma unroll
          for (int cg = 0; cg < Pl::CG; ++cg)
            sm90::tma_load_2d(dst + Pl::B_OFF + cg * NW * kChunk, &mw1, fill.bar(), kc * kChunk,
                              cg * NW);
          fill.advance();
        }
    }
    return;
  }

  // ---- consumers: rows 64 rg.., columns NW cg.. of each tile ----
  const int rg = wg / Pl::CG, cg = wg % Pl::CG;
  // this thread quantizes 4 channels (seg) of rows qr + 8 i of the chunk, in
  // the warpgroup's half of the rows; with CG = 2 both warpgroups read all BM
  const int seg = t % 16, qr = wg * (BM / 2) + t / 16;
  const int bar_id = Pl::CG == 1 ? 1 + wg : 3, bar_n = 128 * Pl::CG;
  sm90::Ring<SLOT, S> q = {smem, full, 0, -1, 0u};
  const float inv_x = __fdiv_rn(1.0f, s_x), inv = __fdiv_rn(1.0f, s_h1);
  sm90::PhaseClocks<CLK, kC1Phases> clk;
  clk.start();
#pragma unroll 1
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    int acc[NW / 2];
    zero_acc(acc);
#pragma unroll 1
    for (int kc = 0; kc < nk; ++kc) {
      unsigned char* s = sm90::ring_take(q);
      clk.template lap<kC1Wait>();
#pragma unroll
      for (int i = 0; i < BM / 16; ++i) {  // 4 values at a time, beside the last chunk's product
        const uint2 w = *reinterpret_cast<const uint2*>(s + sm90::sw128(qr + 8 * i, seg * 4));
        *reinterpret_cast<uint32_t*>(s + Pl::A_OFF + sm90::sw64(qr + 8 * i, seg * 4)) =
            quant4_bf16(w, s_x, inv_x);
        asm volatile("" ::: "memory");
      }
      sm90::fence_async_smem();
      sm90::named_sync(bar_id, bar_n);  // every row the product reads is quantized
      clk.template lap<kC1Quant>();
      mma_chunk<NW>(q, acc, sm90::desc_sw64(s + Pl::A_OFF + rg * 64 * kChunk),
                    sm90::desc_sw64(s + Pl::B_OFF + cg * NW * kChunk));
      clk.template lap<kC1Mma>();
    }
    sm90::ring_drain(q);
    sm90::reg_fence(acc);
    clk.template lap<kC1Mma>();
    const long long m0 = (long long)tile * BM + rg * 64;
    const bool in0 = m0 + acc_row(t, 0) < M, in1 = m0 + acc_row(t, 2) < M;
#pragma unroll
    for (int g = 0; g < NW / 2; g += 4) {  // a column pair in 2 rows
      const int col = cg * NW + acc_col(t, g);
      const float4 ab = *reinterpret_cast<const float4*>(vec + col);
      const float v[4] = {affine_relu(acc[g], ab.x, ab.y), affine_relu(acc[g + 1], ab.z, ab.w),
                          affine_relu(acc[g + 2], ab.x, ab.y), affine_relu(acc[g + 3], ab.z, ab.w)};
      int qv[4];
      quant_n(v, s_h1, inv, qv);
      int8_t* dst = h1q + (m0 + acc_row(t, g)) * P + col;
      if (in0) *reinterpret_cast<uint16_t*>(dst) = pack2(qv[0], qv[1]);
      if (in1) *reinterpret_cast<uint16_t*>(dst + 8 * P) = pack2(qv[2], qv[3]);
    }
    clk.template lap<kC1Epi>();
  }
  clk.flush(clocks);
}

#else
// ---------------------------------------------------------------------------
// K7 conv23: out = bf16(relu?(requant(relu(conv3x3(h1q) * a2 + b2)) . w3 * a3 + b3 + x))
// ---------------------------------------------------------------------------
// Persistent: a block walks tiles blockIdx.x, + gridDim.x, ... (image, tile
// row, tile column; the column fastest, so that neighbouring blocks share
// h1q's halo rows in L2).  Each tile's slots, in the order the consumers take
// them: per conv2 pass, 9 taps x KC chunks (h1q box + w2 slice); per conv3
// pass, KC w3 slices, then NW3 / 64 pieces of the residual.
// CLK builds add the consumers' clock64() time by phase to clocks.
template <int P, int NW3, bool CLK>
__global__ void __launch_bounds__(kK7Threads, 1)
bottleneck_conv23_kernel(const __grid_constant__ CUtensorMap mh1,
                         const __grid_constant__ CUtensorMap mw2,
                         const __grid_constant__ CUtensorMap mw3,
                         const __grid_constant__ CUtensorMap mx,
                         const __grid_constant__ CUtensorMap mo, const float* __restrict__ a2,
                         const float* __restrict__ b2, const float* __restrict__ a3,
                         const float* __restrict__ b3, int ntiles, int C, int d, int relu,
                         int tiles_y, int tiles_x, float s_h2,
                         unsigned long long* __restrict__ clocks) {
  typedef Conv23Plan<P, NW3> Pl;
  constexpr int S = Pl::S, SLOT = Pl::SLOT, NW = Pl::NW, BM = Pl::BM, TW = Pl::TW;
  constexpr int PIECES = NW3 / 64;  // residual pieces of a conv3 pass
  extern __shared__ unsigned char k7_smem[];
  unsigned char* smem = align_smem(k7_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Pl::OFF_BAR);
  unsigned char* h2 = smem + Pl::OFF_H2;  // h2q, KC tiles of [BM rows, 64 bytes]
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  // a pass's (a, b) by column, this warpgroup's
  float2* vec = reinterpret_cast<float2*>(smem + Pl::OFF_VEC + wg * Pl::VEC);
  init_ring<S>(full);

  if (wg == 2) {
    // ---- producer: one thread streams every slot in the consumers' order ----
    if (t == 0) {
      sm90::RingFill<SLOT, S> fill = {smem, full, 0, 0u};
#pragma unroll 1
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int x0 = (tile % tiles_x) * TW, y0 = (tile / tiles_x % tiles_y) * Pl::TH;
        const int img = tile / tiles_x / tiles_y;
#pragma unroll 1
        for (int n = 0; n < Pl::NP2; ++n)
#pragma unroll 1
          for (int tap = 0; tap < 9; ++tap)
#pragma unroll 1
            for (int kc = 0; kc < Pl::KC; ++kc) {
              unsigned char* dst = fill.next(Pl::A_BYTES + NW * kChunk);
              sm90::tma_load_4d(dst, &mh1, fill.bar(), kc * kChunk, x0 + (tap % 3 - 1) * d,
                                y0 + (tap / 3 - 1) * d, img);
              sm90::tma_load_2d(dst + Pl::A_BYTES, &mw2, fill.bar(), kc * kChunk,
                                tap * P + n * NW);
              fill.advance();
            }
#pragma unroll 1
        for (int n = 0; n < C / NW3; ++n) {
#pragma unroll 1
          for (int kc = 0; kc < Pl::KC; ++kc)
            fill.load(&mw3, kc * kChunk, n * NW3, NW3 * kChunk);
#pragma unroll 1
          for (int j = 0; j < PIECES; ++j) {
            unsigned char* dst = fill.next(Pl::R_BYTES);
            sm90::tma_load_4d(dst, &mx, fill.bar(), n * NW3 + j * 64, x0, y0, img);
            fill.advance();
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns tile rows 64 wg .. 64 wg + 63 ----
  sm90::Ring<SLOT, S> q = {smem, full, 0, -1, 0u};
  const float inv2 = __fdiv_rn(1.0f, s_h2);
  sm90::PhaseClocks<CLK, kC23Phases> clk;
  clk.start();
#pragma unroll 1
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
#pragma unroll 1
    for (int n = 0; n < Pl::NP2; ++n) {
      int acc[NW / 2];
      zero_acc(acc);
#pragma unroll 1
      for (int k = 0; k < 9 * Pl::KC; ++k) {
        unsigned char* s = sm90::ring_take(q);
        clk.template lap<kC2Wait>();
        mma_chunk<NW>(q, acc, sm90::desc_sw64(s + wg * 64 * kChunk),
                      sm90::desc_sw64(s + Pl::A_BYTES));
        clk.template lap<kC2Mma>();
      }
      sm90::ring_drain(q);
      sm90::reg_fence(acc);
      clk.template lap<kC2Mma>();
      stage_vec<NW>(vec, a2 + n * NW, b2 + n * NW, wg);
#pragma unroll
      for (int g = 0; g < NW / 2; g += 4) {  // a column pair in 2 rows
        const float4 ab = *reinterpret_cast<const float4*>(vec + acc_col(t, g));
        const float v[4] = {affine_relu(acc[g], ab.x, ab.y), affine_relu(acc[g + 1], ab.z, ab.w),
                            affine_relu(acc[g + 2], ab.x, ab.y),
                            affine_relu(acc[g + 3], ab.z, ab.w)};
        int qv[4];
        quant_n(v, s_h2, inv2, qv);
        const int col = n * NW + acc_col(t, g);
        unsigned char* dst = h2 + (col / kChunk) * (BM * kChunk);
        *reinterpret_cast<uint16_t*>(dst + sm90::sw64(wg * 64 + acc_row(t, g), col % kChunk)) =
            pack2(qv[0], qv[1]);
        *reinterpret_cast<uint16_t*>(dst + sm90::sw64(wg * 64 + acc_row(t, g + 2),
                                                      col % kChunk)) = pack2(qv[2], qv[3]);
      }
      clk.template lap<kC2Epi>();
    }
    // conv3 reads only this warpgroup's rows of h2q
    sm90::fence_async_smem();
    sm90::named_sync(1 + wg, 128);
    clk.template lap<kC2Epi>();

    const int x0 = (tile % tiles_x) * TW, y0 = (tile / tiles_x % tiles_y) * Pl::TH;
    const int img = tile / tiles_x / tiles_y;
#pragma unroll 1
    for (int n = 0; n < C / NW3; ++n) {
      int acc[NW3 / 2];
      zero_acc(acc);
      // this thread's column of the pass's (a, b), in flight during the product
      const float2 ab3 = t < NW3 ? make_float2(a3[n * NW3 + t], b3[n * NW3 + t])
                                 : make_float2(0.0f, 0.0f);
#pragma unroll 1
      for (int kc = 0; kc < Pl::KC; ++kc) {
        unsigned char* s = sm90::ring_take(q);
        clk.template lap<kC3Wait>();
        mma_chunk<NW3>(q, acc, sm90::desc_sw64(h2 + kc * (BM * kChunk) + wg * 64 * kChunk),
                       sm90::desc_sw64(s));
        clk.template lap<kC3Mma>();
      }
      sm90::ring_drain(q);
      sm90::reg_fence(acc);
      clk.template lap<kC3Mma>();
      sm90::named_sync(1 + wg, 128);  // the last epilogue is done with vec
      if (t < NW3) vec[t] = ab3;
      sm90::named_sync(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < PIECES; ++j) {
        clk.template lap<kC3Epi>();
        // 64 channels of the residual, overwritten in place with the output
        unsigned char* r = sm90::ring_take(q);
        clk.template lap<kC3Wait>();
#pragma unroll
        for (int g = 32 * j; g < 32 * j + 32; g += 4) {  // a column pair in 2 rows
          const int cp = acc_col(t, g) - 64 * j;
          const float4 ab = *reinterpret_cast<const float4*>(vec + 64 * j + cp);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
                r + sm90::sw128(wg * 64 + acc_row(t, g + 2 * h), cp));
            const float2 x2 = __bfloat1622float2(*o);
            float o0 = __fadd_rn(__fadd_rn(__fmul_rn((float)acc[g + 2 * h], ab.x), ab.y), x2.x);
            float o1 =
                __fadd_rn(__fadd_rn(__fmul_rn((float)acc[g + 2 * h + 1], ab.z), ab.w), x2.y);
            if (relu) {
              o0 = fmaxf(o0, 0.0f);
              o1 = fmaxf(o1, 0.0f);
            }
            *o = __floats2bfloat162_rn(o0, o1);
          }
        }
        // the warpgroup's 64 pixels (4 image rows) of the piece go out by TMA, which
        // clips what lies outside the image; the slot goes back once TMA has read it
        sm90::fence_async_smem();
        sm90::named_sync(1 + wg, 128);
        if (t == 0) {
          sm90::tma_store_4d(&mo, r + wg * 64 * 128, n * NW3 + 64 * j, x0, y0 + 4 * wg, img);
          sm90::tma_store_wait<true>();
        }
        sm90::ring_release(q, q.slot);
        sm90::ring_next(q);
      }
      clk.template lap<kC3Epi>();
    }
  }
  if (t == 0) sm90::tma_store_wait<false>();
  clk.flush(clocks);
}

#endif  // SEGLAND_PART == 0 || SEGLAND_PART == 3

#if SEGLAND_PART == 0 || SEGLAND_PART == 3
// ---------------------------------------------------------------------------
// K8: out[M,C] = bf16(relu?(h2q[M,P] . w3 * a3 + b3 + res))
// ---------------------------------------------------------------------------
// Persistent: a block walks row tiles of BM = 128 rows (64 a consumer
// warpgroup) blockIdx.x, + gridDim.x, ...  A tile's h2q [128, P] comes by TMA
// once, a barrier a 64-channel chunk, and serves its C / NW3 column passes; a
// pass streams w3's [NW3, 64] K-major slices through the W ring and its
// residual, [128 rows, 64 channels] a piece, through the R ring, whose slot
// the epilogue overwrites with the output for TMA to store.  The producer
// takes a pass's residual before its slices (and the tile's h2q after its
// first pass's residual), so the residual is read a few passes ahead.  In a
// tile's last pass the consumers hand each h2q chunk back once its product is
// done, so the next tile's h2q streams in during that pass's epilogue.
// CLK builds add the consumers' clock64() time by phase to clocks.
template <int NW3, int KCMAX, bool CLK>
__global__ void __launch_bounds__(kK7Threads, 1)
conv3_residual_kernel(const __grid_constant__ CUtensorMap mh, const __grid_constant__ CUtensorMap mw,
                      const __grid_constant__ CUtensorMap mr, const __grid_constant__ CUtensorMap mo,
                      const float* __restrict__ a3, const float* __restrict__ b3, int ntiles,
                      int KC, int C, int relu, unsigned long long* __restrict__ clocks) {
  typedef Conv3Plan<NW3, KCMAX> Pl;
  constexpr int BM = Pl::BM, SW = Pl::SW, SR = Pl::SR;
  extern __shared__ unsigned char k7_smem[];
  unsigned char* smem = align_smem(k7_smem);
  unsigned char* h2 = smem;  // h2q, KC chunks of [BM rows, 64 bytes]
  uint64_t* wbar = reinterpret_cast<uint64_t*>(smem + Pl::OFF_BAR);  // SW full, SW empty
  uint64_t* rbar = wbar + 2 * SW;                                     // SR full, SR empty
  uint64_t* hbar = rbar + 2 * SR;                                     // KC full, KC empty
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int NP = C / NW3;
  if (threadIdx.x == 0) {
    for (int kc = 0; kc < KC; ++kc) {
      sm90::mbar_init(&hbar[kc], 1);
      sm90::mbar_init(&hbar[KCMAX + kc], 2);
    }
  }
  init_ring<SW>(wbar);  // its fence and barrier cover the inits above
  init_ring<SR>(rbar);

  if (wg == 2) {
    // ---- producer: one thread streams every slot in the consumers' order ----
    if (t == 0) {
      sm90::RingFill<Pl::WSLOT, SW> fw = {smem + Pl::OFF_W, wbar, 0, 0u};
      sm90::RingFill<Pl::RSLOT, SR> fr = {smem + Pl::OFF_R, rbar, 0, 0u};
      uint32_t par = 0;
#pragma unroll 1
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, par ^= 1u)
#pragma unroll 1
        for (int n = 0; n < NP; ++n) {
#pragma unroll 1
          for (int j = 0; j < Pl::PIECES; ++j) fr.load(&mr, n * NW3 + 64 * j, tile * BM, Pl::RSLOT);
          if (n == 0) {
#pragma unroll 1
            for (int kc = 0; kc < KC; ++kc) {
              sm90::mbar_wait(&hbar[KCMAX + kc], par ^ 1u);  // the tile before is done with it
              sm90::mbar_expect_tx(&hbar[kc], Pl::H2_CHUNK);
              sm90::tma_load_2d(h2 + kc * Pl::H2_CHUNK, &mh, &hbar[kc], kc * kChunk, tile * BM);
            }
          }
#pragma unroll 1
          for (int kc = 0; kc < KC; ++kc) fw.load(&mw, kc * kChunk, n * NW3, Pl::WSLOT);
        }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile ----
  sm90::Ring<Pl::WSLOT, SW> qw = {smem + Pl::OFF_W, wbar, 0, -1, 0u};
  sm90::Ring<Pl::RSLOT, SR> qr = {smem + Pl::OFF_R, rbar, 0, -1, 0u};
  float2* vec = reinterpret_cast<float2*>(smem + Pl::OFF_VEC + wg * Pl::VEC);  // a pass's (a3, b3)
  int stored = -1;  // the R slot whose TMA store may still be reading it
  uint32_t par = 0;
  sm90::PhaseClocks<CLK, kK8Phases> clk;
  clk.start();
#pragma unroll 1
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, par ^= 1u) {
#pragma unroll 1
    for (int n = 0; n < NP; ++n) {
      const bool last = n == NP - 1;
      int acc[NW3 / 2];
      zero_acc(acc);
      // this thread's column of the pass's (a, b), in flight during the product
      const float2 ab3 = t < NW3 ? make_float2(a3[n * NW3 + t], b3[n * NW3 + t])
                                 : make_float2(0.0f, 0.0f);
#pragma unroll 1
      for (int kc = 0; kc < KC; ++kc) {
        sm90::mbar_wait(&hbar[kc], par);
        unsigned char* w = sm90::ring_take(qw);
        clk.template lap<kK8Wait>();
        mma_chunk<NW3>(qw, acc, sm90::desc_sw64(h2 + kc * Pl::H2_CHUNK + wg * 64 * kChunk),
                       sm90::desc_sw64(w));
        // the chunk before's product is done: in the last pass its h2q goes back
        if (last && kc > 0 && t == 0) sm90::mbar_arrive(&hbar[KCMAX + kc - 1]);
        clk.template lap<kK8Mma>();
      }
      sm90::ring_drain(qw);
      sm90::reg_fence(acc);
      if (last && t == 0) sm90::mbar_arrive(&hbar[KCMAX + KC - 1]);
      clk.template lap<kK8Mma>();
      sm90::named_sync(1 + wg, 128);  // the last epilogue is done with vec
      if (t < NW3) vec[t] = ab3;
      sm90::named_sync(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < Pl::PIECES; ++j) {
        clk.template lap<kK8Epi>();
        // 64 channels of the residual, overwritten in place with the output
        unsigned char* r = sm90::ring_take(qr);
        clk.template lap<kK8ResWait>();
#pragma unroll
        for (int g = 32 * j; g < 32 * j + 32; g += 4) {  // a column pair in 2 rows
          const int cp = acc_col(t, g) - 64 * j;
          const float4 ab = *reinterpret_cast<const float4*>(vec + 64 * j + cp);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
                r + sm90::sw128(wg * 64 + acc_row(t, g + 2 * h), cp));
            const float2 x2 = __bfloat1622float2(*o);
            float o0 = __fadd_rn(__fadd_rn(__fmul_rn((float)acc[g + 2 * h], ab.x), ab.y), x2.x);
            float o1 =
                __fadd_rn(__fadd_rn(__fmul_rn((float)acc[g + 2 * h + 1], ab.z), ab.w), x2.y);
            if (relu) {
              o0 = fmaxf(o0, 0.0f);
              o1 = fmaxf(o1, 0.0f);
            }
            *o = __floats2bfloat162_rn(o0, o1);
          }
        }
        // the warpgroup's 64 rows of the piece go out by TMA, which clips the
        // rows past M; the piece before's slot goes back once TMA has read it
        sm90::fence_async_smem();
        sm90::named_sync(1 + wg, 128);
        if (t == 0) {
          sm90::tma_store_2d(&mo, r + wg * 64 * 128, n * NW3 + 64 * j, tile * BM + wg * 64);
          sm90::tma_store_wait<true, 1>();
        }
        sm90::ring_release(qr, stored);
        stored = qr.slot;
        sm90::ring_next(qr);
      }
      clk.template lap<kK8Epi>();
    }
  }
  if (t == 0) sm90::tma_store_wait<false>();
  clk.flush(clocks);
}
#endif  // SEGLAND_PART == 0 || SEGLAND_PART == 3

template <class K>
cudaError_t opt_in(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// NW3 of conv3 at width C: 128 where it divides C, else 64
inline int conv3_width(int C) { return C % 128 == 0 ? 128 : 64; }

inline bool k7_takes(int C, int P) {
  return C >= 64 && C % 64 == 0 && (P == 64 || P == 128 || P == 256 || P == 512);
}

template <class K>
int kernel_attrs(K kernel, int smem_bytes, int* regs, int* local_bytes, int* smem) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *smem = smem_bytes;
  return 0;
}

// a persistent grid: one block an SM, or one a tile when there are fewer
inline cudaError_t persistent_grid(long long tiles, unsigned* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *grid = (unsigned)(tiles < sms ? tiles : sms);
  return err;
}

// P -> CASE(P) for a P that K7 takes
#define SEGLAND_K7_P(P, CASE) \
  switch (P) {                \
    case 64: CASE(64);        \
    case 128: CASE(128);      \
    case 256: CASE(256);      \
    case 512: CASE(512);      \
    default: break;           \
  }

}  // namespace

// conv23's arguments, and the launchers of the builds in parts 1 and 2
namespace segland_k7 {
struct Conv23Args {
  const void *h1q, *x, *w2t, *w3t, *a2, *b2, *a3, *b3;
  void* out;
  int B, H, W, C, P, d, relu;
  float s_h2;
  cudaStream_t stream;
  unsigned long long* clocks;  // the measurement builds' phase clocks, else null
};
// a cudaError_t, or -1 when P is not among the part's builds
int conv23_part1(const Conv23Args& a);
int conv23_part2(const Conv23Args& a);
int conv23_attrs_part1(int C, int P, int* regs, int* local_bytes, int* smem);
int conv23_attrs_part2(int C, int P, int* regs, int* local_bytes, int* smem);
}  // namespace segland_k7

#if SEGLAND_PART == 0 || SEGLAND_PART == 3
namespace {
template <int P, bool CLK>
cudaError_t launch_conv1(const void* x, const void* w1t, const void* a1, const void* b1,
                         void* h1q, long long M, int C, float s_x, float s_h1,
                         unsigned long long* clocks, void* stream) {
  typedef Conv1Plan<P> Pl;
  CUtensorMap mx, mw1;
  const uint64_t dx[2] = {(uint64_t)C, (uint64_t)M}, dw[2] = {(uint64_t)C, (uint64_t)P};
  const uint32_t bx[2] = {64, (uint32_t)Pl::BM}, bw[2] = {64, (uint32_t)Pl::NW};
  cudaError_t err = sm90::tile_map_nd(&mx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 2, dx, bx);
  if (err == cudaSuccess)
    err = sm90::tile_map_nd(&mw1, w1t, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2, dw, bw);
  unsigned grid = 0;
  if (err == cudaSuccess) err = persistent_grid((M + Pl::BM - 1) / Pl::BM, &grid);
  auto kernel = bottleneck_conv1_kernel<P, CLK>;
  if (err == cudaSuccess) err = opt_in(kernel, Pl::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kK7Threads, Pl::SMEM, (cudaStream_t)stream>>>(
      mx, mw1, (const float*)a1, (const float*)b1, (int8_t*)h1q, M, C, s_x, s_h1, clocks);
  return cudaGetLastError();
}
}  // namespace
#endif

#if SEGLAND_PART == 0 || SEGLAND_PART == 3
namespace {
template <int NW3, int KCMAX, bool CLK>
cudaError_t launch_conv3(const void* h2q, const void* res, const void* w3t, const void* a3,
                         const void* b3, void* out, long long M, int P, int C, int relu,
                         unsigned long long* clocks, void* stream) {
  typedef Conv3Plan<NW3, KCMAX> Pl;
  CUtensorMap mh, mw, mr, mo;
  const uint64_t dh[2] = {(uint64_t)P, (uint64_t)M}, dw[2] = {(uint64_t)P, (uint64_t)C};
  const uint64_t dr[2] = {(uint64_t)C, (uint64_t)M};
  const uint32_t bh[2] = {64, (uint32_t)Pl::BM}, bw[2] = {64, (uint32_t)NW3};
  const uint32_t br[2] = {64, (uint32_t)Pl::BM}, bo[2] = {64, 64};  // a warpgroup's rows
  cudaError_t err = sm90::tile_map_nd(&mh, h2q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2, dh, bh);
  if (err == cudaSuccess)
    err = sm90::tile_map_nd(&mw, w3t, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2, dw, bw);
  if (err == cudaSuccess)
    err = sm90::tile_map_nd(&mr, res, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 2, dr, br);
  if (err == cudaSuccess)
    err = sm90::tile_map_nd(&mo, out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 2, dr, bo);
  const long long tiles = (M + Pl::BM - 1) / Pl::BM;
  unsigned grid = 0;
  if (err == cudaSuccess) err = persistent_grid(tiles, &grid);
  auto kernel = conv3_residual_kernel<NW3, KCMAX, CLK>;
  if (err == cudaSuccess) err = opt_in(kernel, Pl::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kK7Threads, Pl::SMEM, (cudaStream_t)stream>>>(
      mh, mw, mr, mo, (const float*)a3, (const float*)b3, (int)tiles, P / kChunk, C, relu, clocks);
  return cudaGetLastError();
}

// K8 takes M rows (the tile rows within an int) and widths C, P that are
// multiples of 64, P at most 1024
inline bool k8_takes(long long M, int C, int P) {
  return M < (1ll << 31) - 128 && C >= 64 && C % 64 == 0 && P >= 64 && P % 64 == 0 &&
         P <= 16 * kChunk;
}
}  // namespace
#endif

#if SEGLAND_PART == 0
// K7's plan at widths C, P: out[0..10) = conv1 rows a tile, ring slots, slot
// bytes, shared memory; conv23 tile rows, tile columns, conv2 columns a
// warpgroup and pass, conv3's, ring slots, shared memory.  Returns 0 (and
// leaves out alone) when K7 does not take C, P or d.
extern "C" int segland_bottleneck_int8_plan(int C, int P, int d, int* out) {
  if (!k7_takes(C, P) || d < 1) return 0;
#define SEGLAND_PLAN2(p, nw3)                                               \
  {                                                                        \
    typedef Conv23Plan<p, nw3> P2;                                         \
    const int o2[6] = {P2::TH, P2::TW, P2::NW, P2::NW3, P2::S, P2::SMEM};  \
    for (int i = 0; i < 6; ++i) out[4 + i] = o2[i];                        \
  }
#define SEGLAND_PLAN(p)                                        \
  {                                                           \
    typedef Conv1Plan<p> P1;                                  \
    const int o1[4] = {P1::BM, P1::S, P1::SLOT, P1::SMEM};    \
    for (int i = 0; i < 4; ++i) out[i] = o1[i];               \
    if (conv3_width(C) == 128) SEGLAND_PLAN2(p, 128)          \
    else SEGLAND_PLAN2(p, 64)                                 \
    return 1;                                                 \
  }
  SEGLAND_K7_P(P, SEGLAND_PLAN)
#undef SEGLAND_PLAN
#undef SEGLAND_PLAN2
  return 0;
}

// K7 stage 1.  x [M][C] bf16, w1t [P][C] int8, a1 and b1 [P] fp32, h1q [M][P]
// int8 (written).  Returns a cudaError_t.
extern "C" int segland_bottleneck_conv1(const void* x, const void* w1t, const void* a1,
                                        const void* b1, void* h1q, long long M, int C, int P,
                                        float s_x, float s_h1, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!k7_takes(C, P) || M >= (1ll << 31) - 512) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
#define SEGLAND_CONV1(p) \
  return (int)launch_conv1<p, false>(x, w1t, a1, b1, h1q, M, C, s_x, s_h1, nullptr, stream);
  SEGLAND_K7_P(P, SEGLAND_CONV1)
#undef SEGLAND_CONV1
  return (int)cudaErrorInvalidValue;
}

// Registers a thread, local (spill) bytes and dynamic shared memory of the
// conv1 build K7 gives widths C, P.
extern "C" int segland_bottleneck_conv1_attrs(int C, int P, int* regs, int* local_bytes,
                                              int* smem) {
  if (!k7_takes(C, P)) return (int)cudaErrorInvalidValue;
#define SEGLAND_ATTRS(p)                                                                   \
  return kernel_attrs(bottleneck_conv1_kernel<p, false>, Conv1Plan<p>::SMEM, regs, local_bytes, \
                      smem);
  SEGLAND_K7_P(P, SEGLAND_ATTRS)
#undef SEGLAND_ATTRS
  return (int)cudaErrorInvalidValue;
}

// K7 stage 2.  h1q [B][H][W][P] int8, x and out [B][H][W][C] bf16, w2t
// [9][P][P] (tap, out, in) and w3t [C][P] int8, a2 b2 [P] and a3 b3 [C] fp32.
// Returns a cudaError_t.
extern "C" int segland_bottleneck_conv23(const void* h1q, const void* x, const void* w2t,
                                         const void* w3t, const void* a2, const void* b2,
                                         const void* a3, const void* b3, void* out, int B,
                                         int H, int W, int C, int P, int d, int relu, float s_h2,
                                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!k7_takes(C, P) || d < 1) return (int)cudaErrorInvalidValue;
  if ((long long)B * H * W == 0) return (int)cudaSuccess;
  const segland_k7::Conv23Args a = {h1q, x, w2t, w3t, a2,   b2,   a3,
                                    b3,  out, B, H,   W,   C,    P,    d,
                                    relu, s_h2, (cudaStream_t)stream, nullptr};
  const int r = P <= 128 ? segland_k7::conv23_part1(a) : segland_k7::conv23_part2(a);
  return r < 0 ? (int)cudaErrorInvalidValue : r;
}

// Registers a thread, local (spill) bytes and dynamic shared memory of the
// conv23 build K7 gives widths C, P.
extern "C" int segland_bottleneck_conv23_attrs(int C, int P, int* regs, int* local_bytes,
                                               int* smem) {
  if (!k7_takes(C, P)) return (int)cudaErrorInvalidValue;
  const int r = P <= 128 ? segland_k7::conv23_attrs_part1(C, P, regs, local_bytes, smem)
                         : segland_k7::conv23_attrs_part2(C, P, regs, local_bytes, smem);
  return r < 0 ? (int)cudaErrorInvalidValue : r;
}

// K8, the build of widths C, P: NW3 = conv3_width(C), h2q room for P <= 512
// or P <= 1024
#define SEGLAND_K8_BUILD(C, P, CASE)                       \
  if ((P) <= 8 * kChunk) {                                  \
    if (conv3_width(C) == 128) CASE(128, 8) else CASE(64, 8) \
  } else {                                                  \
    if (conv3_width(C) == 128) CASE(128, 16) else CASE(64, 16) \
  }

// K8.  h2q [M][P] int8, res and out [M][C] bf16, w3t [C][P] int8 (K-major),
// a3 and b3 [C] fp32.  Returns a cudaError_t.
extern "C" int segland_conv3_residual_int8(const void* h2q, const void* res, const void* w3t,
                                           const void* a3, const void* b3, void* out,
                                           long long M, int P, int C, int relu, int device,
                                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!k8_takes(M, C, P)) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
#define SEGLAND_K8_LAUNCH(nw3, kcmax)                                                        \
  return (int)launch_conv3<nw3, kcmax, false>(h2q, res, w3t, a3, b3, out, M, P, C, relu, nullptr, \
                                               stream);
  SEGLAND_K8_BUILD(C, P, SEGLAND_K8_LAUNCH)
#undef SEGLAND_K8_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Registers a thread, local (spill) bytes and dynamic shared memory of the
// build K8 gives widths C, P.
extern "C" int segland_conv3_residual_attrs(int C, int P, int* regs, int* local_bytes, int* smem) {
  if (!k8_takes(0, C, P)) return (int)cudaErrorInvalidValue;
#define SEGLAND_K8_ATTRS(nw3, kcmax)                                                       \
  return kernel_attrs(conv3_residual_kernel<nw3, kcmax, false>, Conv3Plan<nw3, kcmax>::SMEM, \
                      regs, local_bytes, smem);
  SEGLAND_K8_BUILD(C, P, SEGLAND_K8_ATTRS)
#undef SEGLAND_K8_ATTRS
  return (int)cudaErrorInvalidValue;
}

// K8's plan at widths C, P: out[0..6) = tile rows, columns a pass, h2q chunks
// it has room for, W slots, R slots, shared memory.  Returns 0 (and leaves out
// alone) when K8 does not take C, P.
extern "C" int segland_conv3_residual_plan(int C, int P, int* out) {
  if (!k8_takes(0, C, P)) return 0;
#define SEGLAND_K8_PLAN(nw3, kcmax)                                                    \
  {                                                                                    \
    typedef Conv3Plan<nw3, kcmax> Pl;                                                  \
    const int o[6] = {Pl::BM, Pl::NW3, Pl::KCMAX, Pl::SW, Pl::SR, Pl::SMEM};           \
    for (int i = 0; i < 6; ++i) out[i] = o[i];                                         \
    return 1;                                                                          \
  }
  SEGLAND_K8_BUILD(C, P, SEGLAND_K8_PLAN)
#undef SEGLAND_K8_PLAN
  return 0;
}

#elif SEGLAND_PART == 3
// The measurement build of K8 at C a multiple of 128 and P <= 512
// (segland_conv3_residual_int8's arguments, then clocks before device and
// stream): its consumers' clock64() time by phase (slice wait, wgmma,
// residual wait, epilogue) added to clocks[0..4) and the count of consumer
// warpgroups to clocks[4].
extern "C" int segland_conv3_residual_int8_clocks(const void* h2q, const void* res,
                                                  const void* w3t, const void* a3, const void* b3,
                                                  void* out, long long M, int P, int C, int relu,
                                                  void* clocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!k8_takes(M, C, P) || conv3_width(C) != 128 || P > 8 * kChunk)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  return (int)launch_conv3<128, 8, true>(h2q, res, w3t, a3, b3, out, M, P, C, relu,
                                         (unsigned long long*)clocks, stream);
}

// The measurement build of K7's conv1 (segland_bottleneck_conv1's arguments,
// then clocks before device and stream): its consumers' clock64() time by
// phase (slot wait, quantize, wgmma, epilogue) added to clocks[0..4) and the
// count of consumer warpgroups to clocks[4].
extern "C" int segland_bottleneck_conv1_clocks(const void* x, const void* w1t, const void* a1,
                                               const void* b1, void* h1q, long long M, int C,
                                               int P, float s_x, float s_h1, void* clocks,
                                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!k7_takes(C, P) || M >= (1ll << 31) - 512) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
#define SEGLAND_CONV1(p)                                                                   \
  return (int)launch_conv1<p, true>(x, w1t, a1, b1, h1q, M, C, s_x, s_h1,                  \
                                    (unsigned long long*)clocks, stream);
  SEGLAND_K7_P(P, SEGLAND_CONV1)
#undef SEGLAND_CONV1
  return (int)cudaErrorInvalidValue;
}
#else
namespace {
template <int P, int NW3, bool CLK>
int launch_conv23(const segland_k7::Conv23Args& a) {
  typedef Conv23Plan<P, NW3> Pl;
  const int tiles_y = (a.H + Pl::TH - 1) / Pl::TH, tiles_x = (a.W + Pl::TW - 1) / Pl::TW;
  CUtensorMap mh1, mw2, mw3, mx, mo;
  const uint64_t dh[4] = {(uint64_t)P, (uint64_t)a.W, (uint64_t)a.H, (uint64_t)a.B};
  const uint64_t dx[4] = {(uint64_t)a.C, (uint64_t)a.W, (uint64_t)a.H, (uint64_t)a.B};
  const uint32_t bh[4] = {64, (uint32_t)Pl::TW, (uint32_t)Pl::TH, 1};
  const uint64_t d2[2] = {(uint64_t)P, 9 * (uint64_t)P}, d3[2] = {(uint64_t)P, (uint64_t)a.C};
  const uint32_t b2x[2] = {64, (uint32_t)Pl::NW}, b3x[2] = {64, (uint32_t)NW3};
  cudaError_t err = sm90::tile_map_nd(&mh1, a.h1q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 4, dh, bh);
  if (err == cudaSuccess)
    err = sm90::tile_map_nd(&mw2, a.w2t, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2, d2, b2x);
  if (err == cudaSuccess)
    err = sm90::tile_map_nd(&mw3, a.w3t, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2, d3, b3x);
  if (err == cudaSuccess)
    err = sm90::tile_map_nd(&mx, a.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 4, dx, bh);
  const uint32_t bo[4] = {64, (uint32_t)Pl::TW, (uint32_t)Pl::TH / 2, 1};  // a warpgroup's half
  if (err == cudaSuccess)
    err = sm90::tile_map_nd(&mo, a.out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 4, dx, bo);
  const long long tiles = (long long)a.B * tiles_y * tiles_x;
  if (tiles >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  unsigned grid = 0;
  if (err == cudaSuccess) err = persistent_grid(tiles, &grid);
  auto kernel = bottleneck_conv23_kernel<P, NW3, CLK>;
  if (err == cudaSuccess) err = opt_in(kernel, Pl::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kK7Threads, Pl::SMEM, a.stream>>>(
      mh1, mw2, mw3, mx, mo, (const float*)a.a2, (const float*)a.b2, (const float*)a.a3,
      (const float*)a.b3, (int)tiles, a.C, a.d, a.relu, tiles_y, tiles_x, a.s_h2, a.clocks);
  return (int)cudaGetLastError();
}
}  // namespace

#if SEGLAND_PART == 4
// The measurement build of K7's conv23 at C a multiple of 128
// (segland_bottleneck_conv23's arguments, then clocks before device and
// stream): its consumers' clock64() time by phase (conv2 slot wait, wgmma,
// epilogue; conv3 slot wait, wgmma, epilogue) added to clocks[0..6) and the
// count of consumer warpgroups to clocks[6].
extern "C" int segland_bottleneck_conv23_clocks(const void* h1q, const void* x, const void* w2t,
                                                const void* w3t, const void* a2, const void* b2,
                                                const void* a3, const void* b3, void* out, int B,
                                                int H, int W, int C, int P, int d, int relu,
                                                float s_h2, void* clocks, int device,
                                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!k7_takes(C, P) || d < 1 || conv3_width(C) != 128) return (int)cudaErrorInvalidValue;
  if ((long long)B * H * W == 0) return (int)cudaSuccess;
  const segland_k7::Conv23Args a = {h1q, x, w2t, w3t, a2,   b2,   a3,
                                    b3,  out, B, H,   W,   C,    P,    d,
                                    relu, s_h2, (cudaStream_t)stream,
                                    (unsigned long long*)clocks};
#define SEGLAND_LAUNCH(p) return launch_conv23<p, 128, true>(a);
  SEGLAND_K7_P(P, SEGLAND_LAUNCH)
#undef SEGLAND_LAUNCH
  return (int)cudaErrorInvalidValue;
}
#else
#define SEGLAND_CAT2(a, b) a##b
#define SEGLAND_CAT(a, b) SEGLAND_CAT2(a, b)
#if SEGLAND_PART == 1
#define SEGLAND_K7_PART_P(CASE) \
  case 64: CASE(64);            \
  case 128: CASE(128);
#else
#define SEGLAND_K7_PART_P(CASE) \
  case 256: CASE(256);          \
  case 512: CASE(512);
#endif

int segland_k7::SEGLAND_CAT(conv23_part, SEGLAND_PART)(const Conv23Args& a) {
#define SEGLAND_LAUNCH(p) \
  return conv3_width(a.C) == 128 ? launch_conv23<p, 128, false>(a)                            \
                                 : launch_conv23<p, 64, false>(a);
  switch (a.P) {
    SEGLAND_K7_PART_P(SEGLAND_LAUNCH)
    default: return -1;
  }
#undef SEGLAND_LAUNCH
}

int segland_k7::SEGLAND_CAT(conv23_attrs_part, SEGLAND_PART)(int C, int P, int* regs,
                                                              int* local_bytes, int* smem) {
#define SEGLAND_ATTRS(p)                                                                    \
  return conv3_width(C) == 128                                                              \
             ? kernel_attrs(bottleneck_conv23_kernel<p, 128, false>, Conv23Plan<p, 128>::SMEM, \
                            regs, local_bytes, smem)                                        \
             : kernel_attrs(bottleneck_conv23_kernel<p, 64, false>, Conv23Plan<p, 64>::SMEM,  \
                            regs, local_bytes, smem);
  switch (P) {
    SEGLAND_K7_PART_P(SEGLAND_ATTRS)
    default: return -1;
  }
#undef SEGLAND_ATTRS
}
#endif  // SEGLAND_PART == 4
#endif  // SEGLAND_PART
