// The Swin attention section with its masks shipped in as arrays and `group`
// consecutive windows attended as one super-window.
//
// Replaces: segland_tpu/ops/pallas_attn.py:_attn_section_pallas (kernel
// `_attn_section_kernel`) as `segland_attn_section_v1`.
//
// Per window w of N = 49 tokens and C channels (heads of 32), T bf16 or fp32:
//   m    = mask_tok[w % rows_m], r = regions[w % rows_r] (or none)   fp32 rows
//   y    = T((LN(x) * gamma + beta) * m)              fp32 stats, fast variance
//   qkv  = T(T(y @ wqkv) + T(bqkv))
// and per super-window of `group` windows (the last may hold fewer), every
// query against the keys of all its windows:
//   s    = (q . k) * scale + (same window and real key ? bias : -1e9)
//          + (r_q != r_k ? -100 : 0)                              fp32
//   ctx  = T(softmax(s) @ v)            fp32 softmax over all group * 49 keys
//   out  = x + T(T(ctx @ wproj) + T(bproj))
// A key of another window has weight exp(-1e9 - max) = 0 exactly, so the
// value is that of group = 1 up to the order of the sums; the products with
// the other windows' keys and values are computed all the same.
//
// What bounds it on an H100: operations.  The function needs 2*NW*N*C*(4C + 2N)
// of them whatever the group (the cross-window terms are exact zeros), against
// one read and one write of [NW, N, C], the mask and region rows and 8*C^2
// bytes of weights.  This tiling runs 2*NW*N*C*(4C + 2*group*N): the excess is
// the super-window's own cost, not part of the bound.
//
// Design (bf16, sm_90a): K3's body (section_sm90.cuh: LN into the swizzled
// A operand, the products on wgmma with B from a TMA ring, the context through
// the output rows) with two changes.  The pad mask scales each row of y and
// the region ids go into the block's token table, both read from the shipped
// rows mask_tok[w % rows_m] and regions[w % rows_r].  And the attention core
// (attn_tile_group_bf16, WMMA, one warp a 16-query tile) walks the keys of
// every window of the query's super-window with a running maximum and sum,
// a 64-key tile at a time: the score work grows with `group`.
//   - windows (group <= W, the build's windows a block: group 1 and 2 at C <=
//     384): the block owns W / group whole super-windows and runs K3's body
//     over them, q, k and v of every window in shared memory.  W is 2 at C =
//     96, not K3's 4: two row tiles a warpgroup and the walk spill under the
//     168 registers ptxas gives a thread of a 288- or 384-thread block.
//   - scratch (the other groups): the block owns one super-window, in chunks
//     of W windows.  1. a chunk at a time, LN and q, k, v on the ring, into a
//     [NW, 49, 3C] scratch tensor in device memory (this block's rows: the
//     reads hit L2); 2. a head at a time, q, k, v of the super-window from
//     the scratch tensor into shared memory over y, the walk, the context into
//     the output rows; 3. a chunk at a time, the context back into y and the
//     projection on the ring, a = x + proj over it.
// The producer streams one ring schedule in consumption order (the windows
// path: K3's; scratch: every chunk's heads, then every chunk's projection).
// swin-b's and swin-l's widths: C = 128 and 256 at two windows a block (as C =
// 96), 512 and 1024 at one (two would leave the scratch path's phase 2 no
// room beside the ring); where 96 does not divide C the projection's last
// pass is K3's narrower one on both paths.  At C = 1536 one window's y does
// not fit, so y streams as in K3's build there: the consumers write y = LN(x)
// * mask of the block's windows to a device scratch (64 rows a window), fence
// it for TMA and announce it on a `ready` mbarrier; each ring slot carries a
// window's [64, 64] K tile of y beside the weight tile (20 KB); the context
// goes to a second scratch at 64 rows a window, announced the same way, and
// the projection's slots carry its tiles.  On the scratch path (one window a
// chunk) phase 2's buffers lie over the ring, which is idle then: the
// producer waits on `ready` for the context before it loads another slot.
// Weights arrive K-major: wqkv^T [3C, C] and wproj^T [C, C] (nn.Linear's
// [out, in]).  The probabilities are rounded to bf16 before the row sum
// divides (the division follows the product with v), which stays inside the
// bf16 tolerance.  ops/fused_attn.py:V1_BUILDS mirrors the build table and
// v1_plan the arithmetic of both paths.
// The fp32 build (exact FMA loops, no TF32) has the three phases with a full
// [49, group * 49] score matrix a query window instead of the walk, q, k, v
// always in the scratch tensor.  Where y [49, C] does not fit beside them (C
// = 1536) phase 1 keeps each row's statistics and makes y 64 columns at a time
// for every head's product (attn_common.cuh:qkv_head_f32_stream).  Its
// weights are input-major.
//
// Registers, spills, TFLOP/s and the phase split of each build and path:
// chip_smoke.py --phases k5 (PERF.md).

// segland-parts: 4
// kernels/__init__.py compiles this file four times, in parallel:
// -DSEGLAND_PART=0 (the entry points, the fp32 body and the served bf16
// builds at swin-t/s's C = 96, 192, 384, 768), 1 (their builds with phase
// clocks, segland_attn_section_v1_clocks), 2 (the served bf16 builds at C =
// 128, 256, 512) and 3 (at C = 1024, 1536).  The builds at swin-b's and
// swin-l's widths have no clock build.
#ifndef SEGLAND_PART
#define SEGLAND_PART 0
#endif

#include "attn_wmma.cuh"
#include "section_sm90.cuh"

namespace {

constexpr int kMaxGroup = 8;
constexpr float kOff = -1e9f;  // another window's key, or a phantom one

// Token m of the block's super-window, whose first window is win0: the fp32
// entry of a [rows, N] table whose row is picked by the window index.
__device__ __forceinline__ float table_at(const float* __restrict__ table, int rows, long long win0,
                                          int m) {
  return table[(size_t)((win0 + m / kN) % rows) * kN + m % kN];
}

// ---- bf16 -------------------------------------------------------------------
// A build: K3's SecPlan with the region ids as fp32 (the windows path), and
// the scratch path's phase-2 layout over y (Sec::YS: over the ring): the score
// strips, the bias, q, k and v of a super-window of up to kMaxGroup windows and
// its region ids.
template <int C_, int W_, int S_>
struct V1Plan {
  typedef SecPlan<C_, W_, S_, false, sizeof(float)> Sec;  // a lone producer warp
  static constexpr int RQ2 = kMaxGroup * kN + 16;  // q/k/v rows: the last window's tiles
  static constexpr size_t Q2_BYTES = align128((size_t)RQ2 * kLQ * sizeof(bf16));
  static constexpr size_t OFF2_STRIP = Sec::YS ? 0 : Sec::OFF_Y;
  static constexpr size_t OFF2_BIAS = OFF2_STRIP + (size_t)kWarps * kStrip * sizeof(float);
  static constexpr size_t OFF2_Q = OFF2_BIAS + align128((size_t)kN * kN * sizeof(float));
  static constexpr size_t OFF2_RID = OFF2_Q + 3 * Q2_BYTES;
  static constexpr size_t END2 = OFF2_RID + align128((size_t)kMaxGroup * kN * sizeof(float));
  // phases 1 and 3: y of a chunk, whose last row tile reads past it (Sec::YS: the ring)
  static constexpr size_t END13 =
      Sec::YS ? Sec::OFF_Y
              : Sec::OFF_Y + (size_t)Sec::KT * Sec::YK + (size_t)(Sec::RT * 64 - Sec::RS) * 128;
  static constexpr size_t OFF2_BAR = END2 > END13 ? END2 : END13;
  // full and empty barriers a slot (Sec::YS: then `ready`), alignment
  static constexpr size_t SMEM2 =
      OFF2_BAR + (2 * S_ + (Sec::YS ? 1 : 0)) * sizeof(uint64_t) + 1024;
  static_assert(SMEM2 <= kMaxSmem, "over the shared memory a block can have");
  static_assert(!Sec::YS || W_ == 1, "a streamed y: one window a block and a chunk");
};

// 16 query rows (tile rt) of window i of a super-window of nwin windows, one
// head, by one warp.  q, k, v: row 0 of the super-window, [nwin * 49 + 16,
// kLQ], rows past nwin * 49 finite.  rid: the super-window's region ids or null.
// sink: row 0 of the super-window's output at this head's columns, row stride
// ld, `wrows` rows a window (49, or a streamed context's 64).
__device__ __forceinline__ void attn_tile_group_bf16(const bf16* q, const bf16* k, const bf16* v,
                                                     int i, int rt, int nwin, const float* bias,
                                                     const float* rid, float scale, float* strip,
                                                     bf16* sink, size_t ld, int wrows = kN) {
  const int lane = threadIdx.x % 32;
  const int r = lane >> 1, hf = lane & 1;
  const int qi = rt * 16 + r;
  const int rot = hf + 2 * (r >> 3);  // bank = (4 * (r & 7) + rot + c) % 32, all distinct
  const bool live = qi < kN;
  const float* srow = strip + r * kLS + hf * 32;
  const float* brow = bias + (live ? qi : 0) * kN + hf * 32;
  const float rq = rid ? rid[i * kN + (live ? qi : 0)] : 0.0f;
  bf16* p = reinterpret_cast<bf16*>(strip);
  FragA aq[kHD / 16];
#pragma unroll
  for (int kk = 0; kk < kHD / 16; ++kk)
    wmma::load_matrix_sync(aq[kk], q + (i * kN + rt * 16) * kLQ + kk * 16, kLQ);
  float m = -INFINITY, l = 0.0f;
  float o[16];  // this lane's half of the output row
#pragma unroll
  for (int t = 0; t < 16; ++t) o[t] = 0.0f;

#pragma unroll 1
  for (int j = 0; j < nwin; ++j) {
    const bf16* kj = k + j * kN * kLQ;
    const bf16* vj = v + j * kN * kLQ;
    // the rotation, opaque in each key tile: the 32 column offsets, key masks
    // and bias loads derived from it are loop-invariant, and hoisted out of
    // the walk they held registers the section's products need (spills)
    int rj = rot;
    asm volatile("" : "+r"(rj));
    {
      FragC s[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) wmma::fill_fragment(s[c], 0.0f);
#pragma unroll
      for (int kk = 0; kk < kHD / 16; ++kk) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          FragBT b;
          wmma::load_matrix_sync(b, kj + c * 16 * kLQ + kk * 16, kLQ);
          wmma::mma_sync(s[c], aq[kk], b, s[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        wmma::store_matrix_sync(strip + c * 16, s[c], kLS, wmma::mem_row_major);
    }
    __syncwarp();
    float e[32];
    float bm = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = (c + rj) & 31;
      const int key = hf * 32 + col;
      float sc = srow[col] * scale;
      sc += (j == i && key < kN) ? brow[col] : kOff;
      if (rid && key < kN && rid[j * kN + key] != rq) sc += -100.0f;
      e[c] = sc;
      bm = fmaxf(bm, sc);
    }
    bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 1));
    const float mn = fmaxf(m, bm);
    const float alpha = __expf(m - mn);  // 0 at the first tile
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      e[c] = __expf(e[c] - mn);
      sum += e[c];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = mn;
    __syncwarp();  // every score is in a register: the rows may be overwritten
    bf16* prow = p + r * 2 * kLS + hf * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) prow[(c + rj) & 31] = __float2bfloat16(e[c]);
    __syncwarp();
    FragC pv[2];
    wmma::fill_fragment(pv[0], 0.0f);
    wmma::fill_fragment(pv[1], 0.0f);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      FragA a;
      wmma::load_matrix_sync(a, p + kk * 16, 2 * kLS);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        FragB b;
        wmma::load_matrix_sync(b, vj + kk * 16 * kLQ + f * 16, kLQ);
        wmma::mma_sync(pv[f], a, b, pv[f]);
      }
    }
    __syncwarp();  // every lane has loaded its probabilities: the strip is free
    wmma::store_matrix_sync(strip, pv[0], kLS, wmma::mem_row_major);
    wmma::store_matrix_sync(strip + 16, pv[1], kLS, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int t = 0; t < 16; ++t) o[t] = o[t] * alpha + strip[r * kLS + hf * 16 + t];
    __syncwarp();  // the next tile's scores overwrite the strip
  }
  if (live) {
    const float inv = 1.0f / l;
    bf16* dst = sink + ((size_t)i * wrows + qi) * ld + hf * 16;
#pragma unroll
    for (int t = 0; t < 16; ++t) dst[t] = __float2bfloat16(o[t] * inv);
  }
}

// barriers and both warp roles of a K5 block (Sec::YS: and `ready`, behind the
// empty barriers); returns the aligned shared memory
template <typename Sec>
__device__ __forceinline__ unsigned char* v1_smem(unsigned char* raw, size_t off_bar) {
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));  // swizzle atoms
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + off_bar);  // then the empty ones
  if (threadIdx.x == 0) {
    for (int s = 0; s < Sec::S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&full[Sec::S + s], 2);
    }
    if constexpr (Sec::YS) sm90::mbar_init(&full[2 * Sec::S], 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  return smem;
}

// The windows path: the block owns W windows, W / group whole super-windows.
// Sec::YS: ysc holds y's rows, then the context's, 64 a window ([2 * NW * 64, C]).
template <typename Pl, bool CLK>
__global__ void __launch_bounds__(Pl::Sec::THREADS, 1)
attn_section_v1_windows_kernel(const __grid_constant__ CUtensorMap mq,
                               const __grid_constant__ CUtensorMap mp,
                               const __grid_constant__ CUtensorMap my,
                               const __grid_constant__ CUtensorMap mc, const bf16* __restrict__ x,
                               const float* __restrict__ mask_tok, int rows_m,
                               const float* __restrict__ regions, int rows_r,
                               const float* __restrict__ gamma, const float* __restrict__ beta,
                               const float* __restrict__ bqkv, const float* __restrict__ bproj,
                               const float* __restrict__ bias, bf16* __restrict__ ysc,
                               bf16* __restrict__ out, long long NW, int group, float eps,
                               unsigned long long* __restrict__ clocks) {
  typedef typename Pl::Sec Sec;
  constexpr int C = Sec::C, W = Sec::W, S = Sec::S;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = v1_smem<Sec>(smem_raw, Sec::OFF_BAR);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Sec::OFF_BAR);
  uint64_t* ready = full + 2 * S;  // Sec::YS: y written, then the context
  const long long win0 = (long long)blockIdx.x * W;

  if (threadIdx.x >= 256) {
    // ---- producer: K3's stream --------------------------------------------------
    if (threadIdx.x == 256) {
      sm90::RingFill<Sec::SLOT, S> fill = {smem, full, 0, 0u};
      if constexpr (Sec::YS)
        produce_section_ys<Sec>(fill, &mq, &mp, &my, &mc, (int)(win0 * 64), ready);
      else
        produce_section<Sec>(fill, &mq, &mp);
    }
    return;
  }

  // ---- consumers: 8 warps --------------------------------------------------------
  const int nwin = (int)((NW - win0) < (long long)W ? (NW - win0) : (long long)W);
  const int rows = nwin * kN;  // real rows of this block
  const bf16* xb = x + (size_t)win0 * kN * C;
  bf16* ob = out + (size_t)win0 * kN * C;
  bf16* ysg = Sec::YS ? ysc + (size_t)win0 * 64 * C : nullptr;
  bf16* csg = Sec::YS ? ysc + ((size_t)NW + win0) * 64 * C : nullptr;
  float* rid_s = reinterpret_cast<float*>(smem + Sec::OFF_TOK);
  sm90::Ring<Sec::SLOT, S> q = {smem, full, 0, -1, 0u};
  sm90::PhaseClocks<CLK, kClkPhases> clk;
  clk.start();
  section_rows<Sec>(
      q, smem, xb, ob, rows, gamma, beta, bqkv, bproj, bias, eps,
      [&] {
        if (regions)
          for (int i = threadIdx.x; i < rows; i += 256)
            rid_s[i] = table_at(regions, rows_r, win0, i);
      },
      [&](int r) -> const bf16* { return xb + (size_t)r * C; },
      [&](int r) { return table_at(mask_tok, rows_m, win0, r); },
      [&](int h, const bf16* qb, const bf16* kb, const bf16* vb, const float* bias_s,
          float* strips) {
        const int cw = threadIdx.x / 32;
        for (int u = cw; u < W * 4; u += kWarps) {
          const int wl = u / 4, rt = u % 4;
          if (wl >= nwin) continue;
          const int s0 = wl / group * group;  // the first window of its super-window
          const int ns = nwin - s0 < group ? nwin - s0 : group;
          const int r0 = s0 * kN;
          // Sec::YS (one window): the context to its scratch rows
          bf16* sink = Sec::YS ? csg + h * kHD : ob + (size_t)r0 * C + h * kHD;
          attn_tile_group_bf16(qb + r0 * kLQ, kb + r0 * kLQ, vb + r0 * kLQ, wl - s0, rt, ns,
                               bias_s, regions ? rid_s + r0 : nullptr, rsqrtf((float)kHD),
                               strips + cw * kStrip, sink, (size_t)C);
        }
      },
      clk, ysg, ready);
  clk.flush(clocks);
}

// The scratch path: the block owns one super-window of up to kMaxGroup
// windows, in chunks of W, with q, k, v in the scratch tensor between phases.
// Sec::YS (W = 1): y of every window is written first, then the chunks' products
// read it from the ring; phase 2 writes the context to ysc's second half, and
// phase 3 reads it from the ring.
template <typename Pl, bool CLK>
__global__ void __launch_bounds__(Pl::Sec::THREADS, 1)
attn_section_v1_scratch_kernel(const __grid_constant__ CUtensorMap mq,
                               const __grid_constant__ CUtensorMap mp,
                               const __grid_constant__ CUtensorMap my,
                               const __grid_constant__ CUtensorMap mc, const bf16* __restrict__ x,
                               const float* __restrict__ mask_tok, int rows_m,
                               const float* __restrict__ regions, int rows_r,
                               const float* __restrict__ gamma, const float* __restrict__ beta,
                               const float* __restrict__ bqkv, const float* __restrict__ bproj,
                               const float* __restrict__ bias, bf16* scratch,
                               bf16* __restrict__ ysc, bf16* out, long long NW, int group,
                               float eps, unsigned long long* __restrict__ clocks) {
  typedef typename Pl::Sec Sec;
  constexpr int C = Sec::C, W = Sec::W, S = Sec::S, CR = W * kN;  // rows a chunk
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = v1_smem<Sec>(smem_raw, Pl::OFF2_BAR);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Pl::OFF2_BAR);
  uint64_t* ready = full + 2 * S;  // Sec::YS: y written, then the context
  const long long win0 = (long long)blockIdx.x * group;
  const int nwin = (int)((NW - win0) < (long long)group ? (NW - win0) : (long long)group);
  const int rows = nwin * kN;  // real rows of the super-window
  const int nchunk = (nwin + W - 1) / W;

  if (threadIdx.x >= 256) {
    // ---- producer: every chunk's heads, then every chunk's projection ---------------
    if (threadIdx.x == 256) {
      sm90::RingFill<Sec::SLOT, S> fill = {smem, full, 0, 0u};
      if constexpr (Sec::YS) {
        produce_section_ys<Sec>(fill, &mq, &mp, &my, &mc, (int)(win0 * 64), ready, nwin);
      } else {
#pragma unroll 1
        for (int c = 0; c < nchunk; ++c)
#pragma unroll 1
          for (int h = 0; h < Sec::NH; ++h) produce_qkv<Sec>(fill, &mq, h);
#pragma unroll 1
        for (int c = 0; c < nchunk; ++c)
#pragma unroll 1
          for (int n0 = 0; n0 < C; n0 += 96) produce_proj<Sec>(fill, &mp, n0);
      }
    }
    return;
  }

  // ---- consumers: 8 warps --------------------------------------------------------
  const bf16* xb = x + (size_t)win0 * kN * C;
  bf16* ob = out + (size_t)win0 * kN * C;
  bf16* sq = scratch + (size_t)win0 * kN * 3 * C;  // the super-window's rows of q | k | v
  bf16* ysg = Sec::YS ? ysc + (size_t)win0 * 64 * C : nullptr;
  bf16* csg = Sec::YS ? ysc + ((size_t)NW + win0) * 64 * C : nullptr;
  unsigned char* ys = smem + Sec::OFF_Y;
  const int cw = threadIdx.x / 32, g = cw / 4;
  const int cofs = Sec::ROWS ? 0 : 48 * g;  // the warpgroup's first column of a slot
  sm90::Ring<Sec::SLOT, S> q = {smem, full, 0, -1, 0u};
  sm90::PhaseClocks<CLK, kClkPhases> clk;
  clk.start();
  float acc[Sec::NTW][Sec::ACC];

  // ---- phase 1: q, k, v of every chunk and head into the scratch tensor ----------
  if constexpr (Sec::YS) {
    // y = LN(x) * mask of every window into its 64 scratch rows (zeros past 49),
    // made visible to TMA and announced
    sm90::ln_rows<C, sm90::kLnBatch<C>>(
        [&](int r) -> const bf16* {
          return r % 64 < kN ? xb + ((size_t)(r / 64) * kN + r % 64) * C : nullptr;
        },
        cw, kWarps, 64 * nwin, gamma, beta, eps,
        [&](int r, int c, uint32_t val, float2) {
          *reinterpret_cast<uint32_t*>(ysg + (size_t)r * C + c) = val;
        },
        [&](int r) { return table_at(mask_tok, rows_m, win0, (r / 64) * kN + r % 64); });
    sm90::fence_async_all();
    consumers_sync();
    if (threadIdx.x == 0) sm90::mbar_arrive(ready);
    clk.template lap<kClkSetup>();
  }
  for (int c = 0; c < nchunk; ++c) {
    const int r0 = c * CR, crows = rows - r0 < CR ? rows - r0 : CR;
    if constexpr (!Sec::YS) {
      if (c > 0) consumers_sync();  // both warpgroups are done with the chunk before's y
      sm90::ln_rows_sw128<C, sm90::kLnBatch<C>>(
          [&](int r) -> const bf16* { return r < crows ? xb + (size_t)(r0 + r) * C : nullptr; },
          cw, kWarps, Sec::RS, gamma, beta, eps, ys, Sec::YK,
          [&](int r) { return table_at(mask_tok, rows_m, win0, r0 + r); });
      sm90::fence_async_smem();
      consumers_sync();
      clk.template lap<kClkSetup>();
    }
    for (int h = 0; h < Sec::NH; ++h) {
      section_product<Sec>(q, ys, g, cofs, acc, clk);
      qkv_epilogue<Sec>(acc, g, cofs, h, crows, bqkv, [&](int which, int row, int d, uint32_t v) {
        *reinterpret_cast<uint32_t*>(sq + (size_t)(r0 + row) * 3 * C + which * C + h * kHD + d) =
            v;
      });
      clk.template lap<kClkQkv>();
    }
  }

  // ---- phase 2: attention over the super-window, a head at a time, over y ----------
  // (Sec::YS: over the ring, idle until the context is announced)
  consumers_sync();  // q, k, v are in the scratch tensor; y is free
  float* strips = reinterpret_cast<float*>(smem + Pl::OFF2_STRIP);
  float* bias_s = reinterpret_cast<float*>(smem + Pl::OFF2_BIAS);
  bf16* qb = reinterpret_cast<bf16*>(smem + Pl::OFF2_Q);
  bf16* kb = reinterpret_cast<bf16*>(smem + Pl::OFF2_Q + Pl::Q2_BYTES);
  bf16* vb = reinterpret_cast<bf16*>(smem + Pl::OFF2_Q + 2 * Pl::Q2_BYTES);
  float* rid_s = reinterpret_cast<float*>(smem + Pl::OFF2_RID);
  if (regions)
    for (int i = threadIdx.x; i < rows; i += 256) rid_s[i] = table_at(regions, rows_r, win0, i);
  for (int i = threadIdx.x; i < 16 * kLQ; i += 256) {  // the last window's tiles reach rows + 14
    const bf16 z = __float2bfloat16(0.0f);
    qb[rows * kLQ + i] = z;
    kb[rows * kLQ + i] = z;
    vb[rows * kLQ + i] = z;
  }
  clk.template lap<kClkSetup>();
  // the context's rows: the output rows, or (Sec::YS) 64 a window in the scratch
  bf16* cdst = Sec::YS ? csg : ob;
  const int crow = Sec::YS ? 64 : kN;
  for (int h = 0; h < Sec::NH; ++h) {
    for (int i = threadIdx.x; i < kN * kN; i += 256) bias_s[i] = bias[(size_t)h * kN * kN + i];
    for (int i = threadIdx.x; i < rows * 12; i += 256) {
      const int r = i / 12, which = (i % 12) / 4, piece = i % 4;
      const uint4 val = *reinterpret_cast<const uint4*>(sq + (size_t)r * 3 * C + which * C +
                                                        h * kHD + piece * 8);
      bf16* dst = which == 0 ? qb : (which == 1 ? kb : vb);
      *reinterpret_cast<uint4*>(dst + r * kLQ + piece * 8) = val;
    }
    consumers_sync();
    for (int u = cw; u < nwin * 4; u += kWarps)
      attn_tile_group_bf16(qb, kb, vb, u / 4, u % 4, nwin, bias_s, regions ? rid_s : nullptr,
                           rsqrtf((float)kHD), strips + cw * kStrip, cdst + h * kHD, (size_t)C,
                           crow);
    consumers_sync();  // the head's context is written; q, k, v and the bias are free
    clk.template lap<kClkAttn>();
  }

  // ---- phase 3: the projection and the residual, a chunk at a time ----------------
  if constexpr (Sec::YS) {
    // every thread's context stores, visible to the projection's TMA loads; the
    // generic writes over the ring ordered before the producer's next TMA
    sm90::fence_async_all();
    consumers_sync();
    if (threadIdx.x == 0) sm90::mbar_arrive(ready);
  }
  for (int c = 0; c < nchunk; ++c) {
    const int r0 = c * CR, crows = rows - r0 < CR ? rows - r0 : CR;
    if constexpr (!Sec::YS) {
      if (c > 0) consumers_sync();  // both warpgroups are done with the chunk before's y
      ctx_to_operand<Sec>(ob + (size_t)r0 * C, crows, ys);
      consumers_sync();
    }
    clk.template lap<kClkCtx>();
    proj_passes<Sec>(q, ys, g, cofs, crows, bproj, xb + (size_t)r0 * C, ob + (size_t)r0 * C,
                     acc, clk);
  }
  clk.flush(clocks);
}

// ---- fp32: exact FMA loops --------------------------------------------------
// Shared memory, in floats.  Phases 1 and 3: y [N, C] and rowbuf [kRowsP, C]
// (STREAM: y's chunk [N, kKC] and the rows' statistics [3 N], or rowbuf).
// Phase 2: q [N, kLQF], k and v [group * N, kLQF], S [N, group * N + 1].  The
// region ids [group * N] sit behind both.
__host__ __device__ constexpr size_t v1_f32_phase2(int group) {
  return (size_t)kN * kLQF + 2 * (size_t)group * kN * kLQF + (size_t)kN * (group * kN + 1);
}
__host__ __device__ constexpr size_t v1_f32_rid_off(int C, int group, bool stream) {
  return max_size(stream ? max_size((size_t)kN * kKC + 3 * kN, (size_t)kRowsP * C)
                         : (size_t)kN * C + (size_t)kRowsP * C,
                  v1_f32_phase2(group));
}
__host__ __device__ constexpr size_t v1_f32_floats(int C, int group, bool stream) {
  return v1_f32_rid_off(C, group, stream) + (size_t)group * kN;
}
// y streams where y [N, C] does not fit resident (C = 1536)
__host__ __device__ constexpr bool v1_f32_streams(int C, int group) {
  return v1_f32_floats(C, group, false) * sizeof(float) > kMaxSmem;
}

template <bool STREAM>
__global__ void __launch_bounds__(kThreads)
attn_section_v1_f32_kernel(const float* __restrict__ x, const float* __restrict__ mask_tok,
                           int rows_m, const float* __restrict__ regions, int rows_r,
                           const float* __restrict__ gamma, const float* __restrict__ beta,
                           const float* __restrict__ wqkv, const float* __restrict__ bqkv,
                           const float* __restrict__ wproj, const float* __restrict__ bproj,
                           const float* __restrict__ bias, float* scratch_qkv,
                           float* __restrict__ out, long long NW, int C, int group, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* base = reinterpret_cast<float*>(smem);
  float* ys = base;                    // phase 1: [N, C] (STREAM: a chunk [N, kKC])
  float* stats = base + kN * kKC;      // STREAM, phase 1: mean, 1/std, mask
  float* rowbuf = STREAM ? base : base + kN * C;  // phase 3: [kRowsP, C]
  float* qs = base;                    // phase 2
  float* ks = qs + kN * kLQF;
  float* vs = ks + group * kN * kLQF;
  float* S = vs + group * kN * kLQF;   // [N, group * N + 1]
  float* rid_s = base + v1_f32_rid_off(C, group, STREAM);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long win0 = (long long)blockIdx.x * group;
  const int nwin = (int)((NW - win0) < (long long)group ? (NW - win0) : (long long)group);
  const int rows = nwin * kN;
  const int nh = C / kHD;
  const int lds = group * kN + 1;
  const float scale = rsqrtf((float)kHD);
  float* sq = scratch_qkv + (size_t)win0 * kN * 3 * C;

  if (regions)
    for (int i = threadIdx.x; i < rows; i += kThreads)
      rid_s[i] = table_at(regions, rows_r, win0, i);

  // phase 1
  for (int wi = 0; wi < nwin; ++wi) {
    const float* xw = x + (size_t)(win0 + wi) * kN * C;
    if constexpr (STREAM) {
      // each row's statistics; y is made a chunk at a time in every head's product
      for (int r = warp; r < kN; r += kWarps) {
        const float* src = xw + (size_t)r * C;
        float s = 0.0f, ss = 0.0f;
        for (int c = lane; c < C; c += 32) {
          const float v = src[c];
          s += v;
          ss += v * v;
        }
        s = warp_sum(s);
        ss = warp_sum(ss);
        const float mu = s / C;
        const float var = fmaxf(ss / C - mu * mu, 0.0f);
        if (lane == 0) {
          stats[r] = mu;
          stats[kN + r] = rsqrtf(var + eps);
          stats[2 * kN + r] = table_at(mask_tok, rows_m, win0, wi * kN + r);
        }
      }
      for (int h = 0; h < nh; ++h)
        qkv_head_f32_stream(xw, C, h, gamma, beta, stats, ys, wqkv, bqkv,
                            [&](int which, int row, int d, float v) {
                              sq[(size_t)(wi * kN + row) * 3 * C + which * C + h * kHD + d] = v;
                            });
    } else {
      for (int r = warp; r < kN; r += kWarps)
        ln_row_f32(xw + (size_t)r * C, C, gamma, beta, eps,
                   table_at(mask_tok, rows_m, win0, wi * kN + r), ys + r * C);
      __syncthreads();
      for (int h = 0; h < nh; ++h)
        qkv_head_f32(ys, C, h, wqkv, bqkv, [&](int which, int row, int d, float v) {
          sq[(size_t)(wi * kN + row) * 3 * C + which * C + h * kHD + d] = v;
        });
    }
    __syncthreads();
  }
  // phase 2
  for (int h = 0; h < nh; ++h) {
    for (int i = threadIdx.x; i < rows * kHD; i += kThreads) {
      const int r = i / kHD, d = i % kHD;
      ks[r * kLQF + d] = sq[(size_t)r * 3 * C + C + h * kHD + d];
      vs[r * kLQF + d] = sq[(size_t)r * 3 * C + 2 * C + h * kHD + d];
    }
    for (int i = 0; i < nwin; ++i) {
      for (int e = threadIdx.x; e < kN * kHD; e += kThreads) {
        const int r = e / kHD, d = e % kHD;
        qs[r * kLQF + d] = sq[(size_t)(i * kN + r) * 3 * C + h * kHD + d];
      }
      __syncthreads();
      for (int idx = threadIdx.x; idx < kN * rows; idx += kThreads) {
        const int qi = idx / rows, key = idx % rows;
        float s = 0.0f;
#pragma unroll
        for (int d = 0; d < kHD; ++d) s += qs[qi * kLQF + d] * ks[key * kLQF + d];
        s *= scale;
        s += key / kN == i ? bias[((size_t)h * kN + qi) * kN + key % kN] : kOff;
        if (regions && rid_s[i * kN + qi] != rid_s[key]) s += -100.0f;
        S[qi * lds + key] = s;
      }
      __syncthreads();
      for (int qi = warp; qi < kN; qi += kWarps) {
        float m = -INFINITY;
        for (int c = lane; c < rows; c += 32) m = fmaxf(m, S[qi * lds + c]);
        m = warp_max(m);
        float sum = 0.0f;
        for (int c = lane; c < rows; c += 32) {
          const float e = expf(S[qi * lds + c] - m);
          S[qi * lds + c] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        for (int c = lane; c < rows; c += 32) S[qi * lds + c] /= sum;
      }
      __syncthreads();
      // ctx of this window and head goes over its q columns of the scratch tensor
      for (int e = threadIdx.x; e < kN * kHD; e += kThreads) {
        const int r = e / kHD, d = e % kHD;
        float a = 0.0f;
        for (int c = 0; c < rows; ++c) a += S[r * lds + c] * vs[c * kLQF + d];
        sq[(size_t)(i * kN + r) * 3 * C + h * kHD + d] = a;
      }
      __syncthreads();
    }
  }

  // phase 3
  for (int wi = 0; wi < nwin; ++wi) {
    const size_t row0 = (size_t)(win0 + wi) * kN;
    for (int r0 = 0; r0 < kN; r0 += kRowsP) {
      for (int i = threadIdx.x; i < kRowsP * C; i += kThreads)
        rowbuf[i] = sq[(size_t)(wi * kN + r0 + i / C) * 3 * C + i % C];
      __syncthreads();
      proj_rows_f32(rowbuf, C, wproj, bproj, r0, [&](int row, int c, float v) {
        const size_t idx = (row0 + row) * C + c;
        out[idx] = x[idx] + v;
      });
      __syncthreads();
    }
  }
}

}  // namespace

// The bf16 launches cross parts: segland_attn_section_v1 (part 0) hands a
// build's arguments to the part that instantiates it.
namespace segland_k5 {
struct V1Args {
  const void *x, *wqkv, *wproj;
  const float *mask_tok, *regions, *gamma, *beta, *bqkv, *bproj, *bias;
  int rows_m, rows_r;
  // scratch: q | k | v [NW, N, 3C] (the scratch path); ysc: y's and the
  // context's rows, 64 a window [2 * NW * 64, C] (the builds that stream y)
  void *scratch, *ysc, *out;
  long long NW;
  int C, group;
  float eps;
  cudaStream_t stream;
  unsigned long long* clocks;
};
// the served build of a width in part v1_part(C) (part 1: the clock builds)
int launch_part0(const V1Args& a);
int launch_part1(const V1Args& a);
int launch_part2(const V1Args& a);
int launch_part3(const V1Args& a);
int attrs_part0(int C, int group, int* regs, int* local_bytes, int* smem);
int attrs_part2(int C, int group, int* regs, int* local_bytes, int* smem);
int attrs_part3(int C, int group, int* regs, int* local_bytes, int* smem);
}  // namespace segland_k5

namespace {

typedef segland_k5::V1Args V1Args;

// whether a bf16 build at `group` takes the scratch path
template <typename Pl>
bool v1_scratch(int group) {
  return group > Pl::Sec::W;
}

template <typename Pl, bool CLK>
cudaError_t launch_v1_bf16(const V1Args& a) {
  typedef typename Pl::Sec Sec;
  constexpr int C = Sec::C;
  CUtensorMap mq, mp, my{}, mc{};
  cudaError_t err = sm90::tile_map(&mq, a.wqkv, 3 * (uint64_t)C, C, 32);
  if (err == cudaSuccess) err = sm90::tile_map(&mp, a.wproj, C, C, 96);
  if (err != cudaSuccess) return err;
  if constexpr (Sec::YS) {
    if (!a.ysc) return cudaErrorInvalidValue;
    const bf16* ctx = (const bf16*)a.ysc + (size_t)a.NW * 64 * C;
    err = sm90::tile_map(&my, a.ysc, (uint64_t)a.NW * 64, C, 64);
    if (err == cudaSuccess) err = sm90::tile_map(&mc, ctx, (uint64_t)a.NW * 64, C, 64);
    if (err != cudaSuccess) return err;
  }
  if (!v1_scratch<Pl>(a.group)) {
    auto kernel = attn_section_v1_windows_kernel<Pl, CLK>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Sec::SMEM);
    if (err != cudaSuccess) return err;
    const unsigned grid = (unsigned)((a.NW + Sec::W - 1) / Sec::W);
    kernel<<<grid, Sec::THREADS, Sec::SMEM, a.stream>>>(
        mq, mp, my, mc, (const bf16*)a.x, a.mask_tok, a.rows_m, a.regions, a.rows_r, a.gamma,
        a.beta, a.bqkv, a.bproj, a.bias, (bf16*)a.ysc, (bf16*)a.out, a.NW, a.group, a.eps,
        a.clocks);
  } else {
    if (!a.scratch) return cudaErrorInvalidValue;
    auto kernel = attn_section_v1_scratch_kernel<Pl, CLK>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Pl::SMEM2);
    if (err != cudaSuccess) return err;
    const unsigned grid = (unsigned)((a.NW + a.group - 1) / a.group);
    kernel<<<grid, Sec::THREADS, Pl::SMEM2, a.stream>>>(
        mq, mp, my, mc, (const bf16*)a.x, a.mask_tok, a.rows_m, a.regions, a.rows_r, a.gamma,
        a.beta, a.bqkv, a.bproj, a.bias, (bf16*)a.scratch, (bf16*)a.ysc, (bf16*)a.out, a.NW,
        a.group, a.eps, a.clocks);
  }
  return cudaGetLastError();
}

}  // namespace

// The bf16 builds, <C, W, S> (ops/fused_attn.py:V1_BUILDS).
#define SEGLAND_V1_BUILDS(X) \
  X(96, 2, 5)                \
  X(128, 2, 5)               \
  X(192, 2, 5)               \
  X(256, 2, 5)               \
  X(384, 2, 5)               \
  X(512, 1, 5)               \
  X(768, 1, 5)               \
  X(1024, 1, 5)              \
  X(1536, 1, 8)

namespace {

// the part that compiles a width's served build: swin-t/s's widths 0 (their
// clock builds 1), swin-b's and swin-l's 2 and 3
constexpr int v1_part(int c) {
  return (c == 96 || c == 192 || c == 384 || c == 768) ? 0 : (c <= 512 ? 2 : 3);
}

// build <c, w, st> launched from part P: its served build in part v1_part(c),
// its clock build (swin-t/s's widths) in part 1; elsewhere not instantiated
template <int P, int c, int w, int st>
int launch_in_part(const V1Args& a) {
  if constexpr (v1_part(c) == P)
    return (int)launch_v1_bf16<V1Plan<c, w, st>, false>(a);
  else if constexpr (P == 1 && v1_part(c) == 0)
    return (int)launch_v1_bf16<V1Plan<c, w, st>, true>(a);
  else
    return (int)cudaErrorInvalidValue;
}

template <int P, int c, int w, int st>
int attrs_in_part(int group, int* regs, int* local_bytes, int* smem) {
  if constexpr (v1_part(c) == P) {
    typedef V1Plan<c, w, st> Pl;
    cudaFuncAttributes fa;
    cudaError_t err;
    if (v1_scratch<Pl>(group)) {
      err = cudaFuncGetAttributes(&fa, attn_section_v1_scratch_kernel<Pl, false>);
      *smem = (int)Pl::SMEM2;
    } else {
      err = cudaFuncGetAttributes(&fa, attn_section_v1_windows_kernel<Pl, false>);
      *smem = (int)Pl::Sec::SMEM;
    }
    if (err != cudaSuccess) return (int)err;
    *regs = fa.numRegs;
    *local_bytes = (int)fa.localSizeBytes;
    return 0;
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

#define SEGLAND_CAT2(a, b) a##b
#define SEGLAND_CAT(a, b) SEGLAND_CAT2(a, b)

int segland_k5::SEGLAND_CAT(launch_part, SEGLAND_PART)(const V1Args& a) {
  switch (a.C) {
#define SEGLAND_CASE(c, w, st) \
  case c: return launch_in_part<SEGLAND_PART, c, w, st>(a);
    SEGLAND_V1_BUILDS(SEGLAND_CASE)
#undef SEGLAND_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

#if SEGLAND_PART != 1
int segland_k5::SEGLAND_CAT(attrs_part, SEGLAND_PART)(int C, int group, int* regs,
                                                      int* local_bytes, int* smem) {
  switch (C) {
#define SEGLAND_CASE(c, w, st) \
  case c: return attrs_in_part<SEGLAND_PART, c, w, st>(group, regs, local_bytes, smem);
    SEGLAND_V1_BUILDS(SEGLAND_CASE)
#undef SEGLAND_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif

#if SEGLAND_PART == 0
namespace {
// the checks and arguments shared by the entry points
int v1_args(V1Args* a, const void* x, const void* mask_tok, int rows_m, const void* regions,
            int rows_r, const void* gamma, const void* beta, const void* wqkv, const void* bqkv,
            const void* wproj, const void* bproj, const void* bias, void* scratch, void* ysc,
            void* out, long long NW, int C, int nh, int group, float eps, int device,
            void* stream, void* clocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nh * kHD != C || group < 1 || group > kMaxGroup || rows_m < 1 || (regions && rows_r < 1))
    return (int)cudaErrorInvalidValue;
  if (NW > 2147483647LL / 64) return (int)cudaErrorInvalidValue;
  *a = {x, wqkv, wproj,
        (const float*)mask_tok, (const float*)regions, (const float*)gamma,
        (const float*)beta, (const float*)bqkv, (const float*)bproj,
        (const float*)bias, rows_m, rows_r, scratch, ysc, out, NW, C, group, eps,
        (cudaStream_t)stream, (unsigned long long*)clocks};
  return 0;
}

template <bool STREAM>
cudaError_t launch_v1_f32(const V1Args& a) {
  const size_t smem = v1_f32_floats((int)a.C, a.group, STREAM) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = attn_section_v1_f32_kernel<STREAM>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((a.NW + a.group - 1) / a.group);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      (const float*)a.x, a.mask_tok, a.rows_m, a.regions, a.rows_r, a.gamma, a.beta,
      (const float*)a.wqkv, a.bqkv, (const float*)a.wproj, a.bproj, a.bias, (float*)a.scratch,
      (float*)a.out, a.NW, a.C, a.group, a.eps);
  return cudaGetLastError();
}
}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, wqkv, wproj, scratch [NW, N, 3C], ysc,
// out); vectors, bias [nh, N, N], mask_tok [rows_m, N] and regions [rows_r,
// N] (or null) are fp32.  fp32 weights are input-major (wqkv [C, 3C], wproj
// [C, C]); bf16 weights K-major (wqkv^T [3C, C], wproj^T [C, C]: nn.Linear's
// [out, in]).  Windows of 7 x 7 tokens and heads of 32; group in 1..8; bf16
// has builds for C in {96, 128, 192, 256, 384, 512, 768, 1024, 1536} and reads
// `scratch` (which may be null otherwise) only where group exceeds the build's
// windows a block, `ysc` ([2 * NW * 64, C], else null) only in the builds
// that stream y (C = 1536, ops/fused_attn.py:v1_plan's "stream_y").  Returns
// a cudaError_t.
extern "C" int segland_attn_section_v1(int dtype, const void* x, const void* mask_tok, int rows_m,
                                       const void* regions, int rows_r, const void* gamma,
                                       const void* beta, const void* wqkv, const void* bqkv,
                                       const void* wproj, const void* bproj, const void* bias,
                                       void* scratch, void* ysc, void* out, long long NW, int C,
                                       int nh, int group, float eps, int device, void* stream) {
  V1Args a;
  const int e = v1_args(&a, x, mask_tok, rows_m, regions, rows_r, gamma, beta, wqkv, bqkv, wproj,
                        bproj, bias, scratch, ysc, out, NW, C, nh, group, eps, device, stream,
                        nullptr);
  if (e || NW <= 0) return e;
  if (dtype == 1) {
    switch (v1_part(C)) {
      case 0: return segland_k5::launch_part0(a);
      case 2: return segland_k5::launch_part2(a);
      default: return segland_k5::launch_part3(a);
    }
  }
  if (dtype != 0 || !scratch) return (int)cudaErrorInvalidValue;
  return (int)(v1_f32_streams(C, group) ? launch_v1_f32<true>(a) : launch_v1_f32<false>(a));
}

// Registers a thread at launch, local (spill) bytes and dynamic shared memory
// of the bf16 kernel that width C and `group` launch, by cudaFuncGetAttributes.
extern "C" int segland_attn_section_v1_attrs(int C, int group, int* regs, int* local_bytes,
                                             int* smem) {
  switch (v1_part(C)) {
    case 0: return segland_k5::attrs_part0(C, group, regs, local_bytes, smem);
    case 2: return segland_k5::attrs_part2(C, group, regs, local_bytes, smem);
    default: return segland_k5::attrs_part3(C, group, regs, local_bytes, smem);
  }
}

// The bf16 kernel of segland_attn_section_v1 with its consumers' clock64() time
// by phase (setup, ring wait, wgmma, q/k/v epilogue, attention core with the
// super-window's key walk, context copy, output epilogue) added to
// clocks[0..7) and the count of consumer warpgroups to clocks[7]; at C in {96,
// 192, 384, 768} only.
extern "C" int segland_attn_section_v1_clocks(const void* x, const void* mask_tok, int rows_m,
                                              const void* regions, int rows_r, const void* gamma,
                                              const void* beta, const void* wqkv,
                                              const void* bqkv, const void* wproj,
                                              const void* bproj, const void* bias, void* scratch,
                                              void* ysc, void* out, long long NW, int C, int nh,
                                              int group, float eps, void* clocks, int device,
                                              void* stream) {
  V1Args a;
  const int e = v1_args(&a, x, mask_tok, rows_m, regions, rows_r, gamma, beta, wqkv, bqkv, wproj,
                        bproj, bias, scratch, ysc, out, NW, C, nh, group, eps, device, stream,
                        clocks);
  if (e || NW <= 0) return e;
  if (v1_part(C) != 0) return (int)cudaErrorInvalidValue;
  return segland_k5::launch_part1(a);
}
#endif  // SEGLAND_PART == 0
