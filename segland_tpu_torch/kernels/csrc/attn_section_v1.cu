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
// Design (bf16): one block of 8 warps owns one super-window and works in three
// phases, with q, k, v of its windows parked in a [NW, N, 3C] scratch tensor in
// device memory between them (written and read back by the same block, so the
// reads hit L2): y and ctx of 8 windows at C=768 would be 1.2 MB, five times
// what a block can hold.
//   1. a window at a time: LN and mask into shared memory, then a head's q, k,
//      v by one [64, C] x [C, 96] WMMA product, the weight chunks streamed by
//      cp.async through the ring of attn_common.cuh, across heads and windows;
//   2. a head at a time: q, k, v of the whole super-window from the scratch
//      tensor into shared memory ([group * 49, 32] each); a warp takes 16 query
//      rows of one window and walks the key windows with a running maximum and
//      sum: 16 x 64 scores by WMMA into its strip, two lanes a row rescale
//      their half of the fp32 output row (kept in registers) and the sum,
//      write exp(s - max) over the scores as bf16, and add that tile's product
//      with v.  ctx goes over the head's q columns of the scratch tensor;
//   3. a window at a time: ctx into shared memory, the projection 96 columns a
//      pass through the same ring, +residual, out.
// So `group` sets the rows a block owns, the q/k/v rows it holds and the key
// tiles a query row walks: the score and context work grows with it.  The
// probabilities are rounded to bf16 before the row sum divides (the division
// follows the product with v), which stays inside the bf16 tolerance.
// The fp32 build (exact FMA loops, no TF32) has the same three phases with a
// full [49, group * 49] score matrix a query window instead of the walk.
//
// Measured on an H100 (nvcc 12.8 -Xptxas -v; times from chip_smoke.py --phases
// k5): bf16 223 registers and no spills at C=96, 128 registers and 20 bytes of
// spills at C = 192, 384 and 768; fp32 80 registers, no spills.  Over the 24
// blocks of a swin-s forward of 8 1024^2 tiles, 42.0 / 46.5 / 56.0 / 79.1 ms at
// group 1 / 2 / 4 / 8, against 38.5 ms for attn_section: on this card a larger
// super-window only adds score and context work.

#include "attn_common.cuh"

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
// Phases 1 and 3 use the section's products with one window (a 64-row tile) at
// a time; phase 2 overlays everything with q, k, v of the super-window.
template <int C, int KC, int S>
struct V1Cfg {
  typedef SecCfg<C, 1, 2, KC, S> Sec;  // for its products: ROUNDS 1, 3 fragments a warp
  static constexpr int LDY = Sec::LDY;
  // phases 1 and 3: y or ctx of one window, 64 rows so that no row tile leaves it
  static constexpr size_t Y_BYTES = align128((size_t)64 * LDY * sizeof(bf16));
  static constexpr size_t OFF_SCR = Y_BYTES;  // a 16 x 16 fp32 tile a warp
  static constexpr size_t OFF_STAGE = OFF_SCR + (size_t)kWarps * 256 * sizeof(float);
  static constexpr size_t SMEM13 = OFF_STAGE + S * Sec::STAGE_ELEMS * sizeof(bf16);
  // phase 2: strips, bias, then q, k, v of `group` windows
  static constexpr size_t OFF_BIAS = (size_t)kWarps * kStrip * sizeof(float);
  static constexpr size_t OFF_QKV = OFF_BIAS + align128((size_t)kN * kN * sizeof(float));
  __host__ __device__ static constexpr size_t q_bytes(int group) {
    return align128((size_t)(group * kN + 16) * kLQ * sizeof(bf16));
  }
  // the region ids of the super-window sit behind both layouts
  __host__ __device__ static constexpr size_t off_rid(int group) {
    return max_size(SMEM13, OFF_QKV + 3 * q_bytes(group));
  }
  __host__ __device__ static constexpr size_t smem(int group) {
    return off_rid(group) + align128((size_t)group * kN * sizeof(float));
  }
};

// 16 query rows (tile rt) of window i of a super-window of nwin windows, one
// head, by one warp.  q, k, v: row 0 of the super-window, [nwin * 49 + 16,
// kLQ], rows past nwin * 49 zero.  rid: the super-window's region ids or null.
// sink: row 0 of the super-window's output at this head's columns.
__device__ __forceinline__ void attn_tile_group_bf16(const bf16* q, const bf16* k, const bf16* v,
                                                     int i, int rt, int nwin, const float* bias,
                                                     const float* rid, float scale, float* strip,
                                                     bf16* sink, size_t ld) {
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

  for (int j = 0; j < nwin; ++j) {
    const bf16* kj = k + j * kN * kLQ;
    const bf16* vj = v + j * kN * kLQ;
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
      const int col = (c + rot) & 31;
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
    for (int c = 0; c < 32; ++c) prow[(c + rot) & 31] = __float2bfloat16(e[c]);
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
    bf16* dst = sink + (size_t)(i * kN + qi) * ld + hf * 16;
#pragma unroll
    for (int t = 0; t < 16; ++t) dst[t] = __float2bfloat16(o[t] * inv);
  }
}

template <int C, int KC, int S>
__global__ void __launch_bounds__(kThreads)
attn_section_v1_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ mask_tok,
                            int rows_m, const float* __restrict__ regions, int rows_r,
                            const float* __restrict__ gamma, const float* __restrict__ beta,
                            const bf16* __restrict__ wqkv, const float* __restrict__ bqkv,
                            const bf16* __restrict__ wproj, const float* __restrict__ bproj,
                            const float* __restrict__ bias, bf16* scratch_qkv,
                            bf16* __restrict__ out, long long NW, int group, float eps) {
  typedef V1Cfg<C, KC, S> Cfg;
  typedef typename Cfg::Sec Sec;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ys = reinterpret_cast<bf16*>(smem);                       // phases 1, 3
  float* scr_all = reinterpret_cast<float*>(smem + Cfg::OFF_SCR);
  bf16* stage = reinterpret_cast<bf16*>(smem + Cfg::OFF_STAGE);
  float* strips = reinterpret_cast<float*>(smem);                 // phase 2
  float* bias_s = reinterpret_cast<float*>(smem + Cfg::OFF_BIAS);
  const size_t qbytes = Cfg::q_bytes(group);
  bf16* qb = reinterpret_cast<bf16*>(smem + Cfg::OFF_QKV);
  bf16* kb = reinterpret_cast<bf16*>(smem + Cfg::OFF_QKV + qbytes);
  bf16* vb = reinterpret_cast<bf16*>(smem + Cfg::OFF_QKV + 2 * qbytes);
  float* rid_s = reinterpret_cast<float*>(smem + Cfg::off_rid(group));

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long win0 = (long long)blockIdx.x * group;
  const int nwin = (int)((NW - win0) < (long long)group ? (NW - win0) : (long long)group);
  const int rows = nwin * kN;  // real rows of this block
  const float scale = rsqrtf((float)kHD);
  float* scr = scr_all + warp * 256;
  constexpr int NFR = Sec::NFR;  // 3 fragments a warp: row tile warp / 2, column half warp % 2
  const int rt = warp / 2, part = warp % 2;
  bf16* sq = scratch_qkv + (size_t)win0 * kN * 3 * C;  // this block's rows of the scratch tensor
  FragC acc[1][NFR];

  if (regions)
    for (int i = threadIdx.x; i < rows; i += kThreads)
      rid_s[i] = table_at(regions, rows_r, win0, i);

  // ---- phase 1: q, k, v of every window and head into the scratch tensor ----
  {
    const Stream st = {nwin * Sec::NH * Sec::NCH, 0, Sec::NH};
    for (int c = 0; c < S - 1; ++c) fetch_chunk<C, KC, S, Sec>(c, st, stage, wqkv, wproj);
    for (int wi = 0; wi < nwin; ++wi) {
      __syncthreads();  // the window before's last product has read y
      for (int r = warp; r < 64; r += kWarps) {
        bf16* dst = ys + r * Cfg::LDY;
        if (r >= kN) {  // warp-uniform: the phantom rows of the tile
          for (int c = lane; c < C; c += 32) dst[c] = __float2bfloat16(0.0f);
          continue;
        }
        const bf16* src = x + ((size_t)(win0 + wi) * kN + r) * C;
        const float mk = table_at(mask_tok, rows_m, win0, wi * kN + r);
        ln_row_bf16<C>([&](int c) { return __bfloat162float(src[c]); }, gamma, beta, eps, mk,
                       dst);
      }
      // the first product's first barrier shows y
      for (int h = 0; h < Sec::NH; ++h) {
        gemm96<C, KC, S, Sec>(ys, (wi * Sec::NH + h) * Sec::NCH, st, stage, wqkv, wproj, acc,
                              nullptr, nullptr);
#pragma unroll
        for (int f = 0; f < NFR; ++f) {
          wmma::store_matrix_sync(scr, acc[0][f], 16, wmma::mem_row_major);
          const int col = (part * NFR + f) * 16 + lane % 16;  // this lane's column of the tile
          const int which = col / kHD, d = col % kHD;
          const float bcol = bf(bqkv[which * C + h * kHD + d]);
          bf16* dstq = sq + (size_t)wi * kN * 3 * C + which * C + h * kHD + d;
          __syncwarp();
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int row = rt * 16 + lane / 16 + 2 * i;
            if (row < kN)
              dstq[(size_t)row * 3 * C] = __float2bfloat16(bf(scr[lane + 32 * i]) + bcol);
          }
          __syncwarp();
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // q, k, v of the super-window are written; phase 2 takes the memory
  }

  // ---- phase 2: attention over the super-window, a head at a time -----------
  for (int i = threadIdx.x; i < (group * kN + 16 - rows) * kLQ; i += kThreads) {
    const bf16 z = __float2bfloat16(0.0f);
    qb[rows * kLQ + i] = z;
    kb[rows * kLQ + i] = z;
    vb[rows * kLQ + i] = z;
  }
  for (int h = 0; h < Sec::NH; ++h) {
    for (int i = threadIdx.x; i < kN * kN; i += kThreads)
      bias_s[i] = bias[(size_t)h * kN * kN + i];
    for (int i = threadIdx.x; i < rows * 12; i += kThreads) {
      const int r = i / 12, which = (i % 12) / 4, piece = i % 4;
      const uint4 val = *reinterpret_cast<const uint4*>(sq + (size_t)r * 3 * C + which * C +
                                                        h * kHD + piece * 8);
      bf16* dst = which == 0 ? qb : (which == 1 ? kb : vb);
      *reinterpret_cast<uint4*>(dst + r * kLQ + piece * 8) = val;
    }
    __syncthreads();
    for (int u = warp; u < nwin * 4; u += kWarps)
      attn_tile_group_bf16(qb, kb, vb, u / 4, u % 4, nwin, bias_s, regions ? rid_s : nullptr,
                           scale, strips + warp * kStrip, sq + h * kHD, (size_t)3 * C);
    __syncthreads();  // ctx of this head is written; q, k, v and the bias are free
  }

  // ---- phase 3: projection and residual, a window at a time -----------------
  {
    const Stream st = {nwin * (C / 96) * Sec::NCH, Sec::NH, C / 96};
    for (int c = 0; c < S - 1; ++c) fetch_chunk<C, KC, S, Sec>(c, st, stage, wqkv, wproj);
    for (int wi = 0; wi < nwin; ++wi) {
      __syncthreads();  // the window before's last product has read ctx
      for (int i = threadIdx.x; i < 64 * (C / 8); i += kThreads) {
        const int r = i / (C / 8), c = (i % (C / 8)) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r < kN)
          val = *reinterpret_cast<const uint4*>(sq + (size_t)(wi * kN + r) * 3 * C + c);
        *reinterpret_cast<uint4*>(ys + r * Cfg::LDY + c) = val;
      }
      for (int n0 = 0; n0 < C; n0 += 96) {
        gemm96<C, KC, S, Sec>(ys, (wi * (C / 96) + n0 / 96) * Sec::NCH, st, stage, wqkv, wproj,
                              acc, nullptr, nullptr);
#pragma unroll
        for (int f = 0; f < NFR; ++f) {
          wmma::store_matrix_sync(scr, acc[0][f], 16, wmma::mem_row_major);
          const int col = n0 + (part * NFR + f) * 16 + lane % 16;
          const float bcol = bf(bproj[col]);
          const size_t base = ((size_t)(win0 + wi) * kN) * C + col;
          float xr[8];  // the residual, fetched before the tile is read back
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int row = rt * 16 + lane / 16 + 2 * i;
            xr[i] = row < kN ? __bfloat162float(x[base + (size_t)row * C]) : 0.0f;
          }
          __syncwarp();
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int row = rt * 16 + lane / 16 + 2 * i;
            if (row < kN)
              out[base + (size_t)row * C] =
                  __float2bfloat16(xr[i] + bf(bf(scr[lane + 32 * i]) + bcol));
          }
          __syncwarp();
        }
      }
    }
    cp_async_wait<0>();
  }
}

// ---- fp32: exact FMA loops --------------------------------------------------
// Shared memory, in floats.  Phases 1 and 3: y [N, C] and rowbuf [kRowsP, C].
// Phase 2: q [N, kLQF], k and v [group * N, kLQF], S [N, group * N + 1].  The
// region ids [group * N] sit behind both.
__host__ __device__ constexpr size_t v1_f32_rid_off(int C, int group) {
  return max_size((size_t)kN * C + (size_t)kRowsP * C,
                  (size_t)kN * kLQF + 2 * (size_t)group * kN * kLQF +
                      (size_t)kN * (group * kN + 1));
}
__host__ __device__ constexpr size_t v1_f32_floats(int C, int group) {
  return v1_f32_rid_off(C, group) + (size_t)group * kN;
}

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
  float* ys = base;                    // phases 1, 3: [N, C] (phase 3 uses rowbuf only)
  float* rowbuf = base + kN * C;       // [kRowsP, C]
  float* qs = base;                    // phase 2
  float* ks = qs + kN * kLQF;
  float* vs = ks + group * kN * kLQF;
  float* S = vs + group * kN * kLQF;   // [N, group * N + 1]
  float* rid_s = base + v1_f32_rid_off(C, group);
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
    for (int r = warp; r < kN; r += kWarps)
      ln_row_f32(x + ((size_t)(win0 + wi) * kN + r) * C, C, gamma, beta, eps,
                 table_at(mask_tok, rows_m, win0, wi * kN + r), ys + r * C);
    __syncthreads();
    for (int h = 0; h < nh; ++h)
      qkv_head_f32(ys, C, h, wqkv, bqkv, [&](int which, int row, int d, float v) {
        sq[(size_t)(wi * kN + row) * 3 * C + which * C + h * kHD + d] = v;
      });
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

struct V1Args {
  const void *x, *wqkv, *wproj;
  const float *mask_tok, *regions, *gamma, *beta, *bqkv, *bproj, *bias;
  int rows_m, rows_r;
  void *scratch, *out;
  long long NW;
  int group;
  float eps;
  cudaStream_t stream;
};

template <int C, int KC, int S>
cudaError_t launch_v1_bf16(const V1Args& a) {
  typedef V1Cfg<C, KC, S> Cfg;
  static_assert(Cfg::smem(kMaxGroup) <= kMaxSmem, "over the shared memory a block can have");
  auto kernel = attn_section_v1_bf16_kernel<C, KC, S>;
  const size_t smem = Cfg::smem(a.group);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((a.NW + a.group - 1) / a.group);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      (const bf16*)a.x, a.mask_tok, a.rows_m, a.regions, a.rows_r, a.gamma, a.beta,
      (const bf16*)a.wqkv, a.bqkv, (const bf16*)a.wproj, a.bproj, a.bias, (bf16*)a.scratch,
      (bf16*)a.out, a.NW, a.group, a.eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, wqkv, wproj, scratch [NW, N, 3C], out);
// vectors, bias [nh, N, N], mask_tok [rows_m, N] and regions [rows_r, N] (or
// null) are fp32.  Windows of 7 x 7 tokens and heads of 32; group in 1..8;
// bf16 has builds for C in {96, 192, 384, 768}.  Returns a cudaError_t.
extern "C" int segland_attn_section_v1(int dtype, const void* x, const void* mask_tok, int rows_m,
                                       const void* regions, int rows_r, const void* gamma,
                                       const void* beta, const void* wqkv, const void* bqkv,
                                       const void* wproj, const void* bproj, const void* bias,
                                       void* scratch, void* out, long long NW, int C, int nh,
                                       int group, float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nh * kHD != C || group < 1 || group > kMaxGroup || rows_m < 1 || (regions && rows_r < 1))
    return (int)cudaErrorInvalidValue;
  if (NW <= 0) return (int)cudaSuccess;
  if (NW > 2147483647LL / kN) return (int)cudaErrorInvalidValue;
  const V1Args a = {x, wqkv, wproj,
                    (const float*)mask_tok, (const float*)regions, (const float*)gamma,
                    (const float*)beta, (const float*)bqkv, (const float*)bproj,
                    (const float*)bias, rows_m, rows_r, scratch, out, NW, group, eps,
                    (cudaStream_t)stream};
  if (dtype == 1) {
    switch (C) {
      // <C, KC, S>
      case 96: return (int)launch_v1_bf16<96, 48, 3>(a);
      case 192: return (int)launch_v1_bf16<192, 96, 3>(a);
      case 384: return (int)launch_v1_bf16<384, 96, 4>(a);
      case 768: return (int)launch_v1_bf16<768, 32, 4>(a);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = v1_f32_floats(C, group) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(attn_section_v1_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((NW + group - 1) / group);
  attn_section_v1_f32_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, a.mask_tok, rows_m, a.regions, rows_r, a.gamma, a.beta,
      (const float*)wqkv, a.bqkv, (const float*)wproj, a.bproj, a.bias, (float*)scratch,
      (float*)out, NW, C, group, eps);
  return (int)cudaGetLastError();
}
