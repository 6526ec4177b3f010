// The head-grouped attention section of the head-group probe on
// section_win.cuh's body, shared by K9 (attn_section_hg_sm90.cu, masks shipped
// in as [rows, 49] tables) and K10 (attn_section_hg2_sm90.cu, masks from the
// window index, and its timing modes).
//
// Per window of N = 49 tokens and C channels (heads of 32), bf16 T:
//   m, r = the window's pad flag and region ids (Masks)
//   y    = T((LN(x) * gamma + beta) * m)             fp32 stats, fast variance
//   qkv  = T(T(y @ wqkv) + T(bqkv))                  fp32 accumulate
//   per group of hg heads, per head:
//     s   = (q . k) * scale + T(bias) + (r_q != r_k ? -100 : 0)   fp32
//           (score_f32 = 0: q' = T(q * T(scale)) enters the product instead)
//     p   = exp(s - max s), l = sum p                fp32, not normalised
//     ctx = T((T(p) @ v) / l)
//   out  = x + T(T(ctx @ wproj) + T(bproj))
// The JAX bodies accumulate the projection group by group; here it is one
// product over the context of every head after the last group: the same fp32
// sum in another order.
//
// What bounds it on an H100: operations, 2*NW*N*C*(4C + 2N) over real tokens
// (as attn_section.cu): the scores stay per head and nothing is multiplied on
// zeros.  hg on the TPU packs the K and V of hg heads block-diagonally to fill
// its 128 lanes; on this card it is the number of heads a pass holds.
//
// Design (sm_90a).  A block owns `wblk` windows (the grid is ceil(NW / wblk))
// and walks them W at a time, a pass a [64 W, C] padded row matrix.  Two
// warpgroups and nothing else (so ptxas may give a thread 255 registers, not
// 168) run the products on wgmma with B from a ring of 12 KB slots that they
// refill by TMA themselves (section_win.cuh's HandBackRing), the weights
// K-major (wqkv^T [3C, C], wproj^T [C, C], as nn.Linear keeps them), streamed
// once a pass in the order they are used: every head's q, k, v columns, then
// the projection's, 96 columns a slot.  A group is hg heads: their q, k, v
// products run back to back into hg sets of q, k, v tiles, then all 4 W hg
// attention tiles of the group are in flight over the 8 warps on K6's
// register-resident core, one barrier a group; each writes its context to the
// output rows, from where it comes back into y's place for the projection
// after the last group.
//
// K10's modes (template parameters, a kernel each; K9 runs kHgNone): kHgIo
// out = T(x + y) after the q, k, v products, whose results are stored and
// never read; kHgAttn ctx = T(q * scale), no attention; kHgSoftmax p = 0.001 s
// with no max and no exp, the 15 pad keys of the JAX wrapper's bf16 layout
// (score T(-1e9) * 0.001, value T(bqkv)) in the sums and the product with v.
// kHgIoRaw (out = x + x) runs no product: attn_section_hg2_sm90.cu's
// streaming kernel.

#pragma once

#include "section_win.cuh"

namespace {

enum { kHgNone = 0, kHgIoRaw = 1, kHgIo = 2, kHgAttn = 3, kHgSoftmax = 4 };

// C channels, hg heads a group, W windows a pass, S ring slots
template <int C_, int HG_, int W_, int S_>
struct HgPlan : WinPlan<C_, W_, S_, HG_, HG_> {
  static constexpr int HG = HG_;
  static constexpr int NG = C_ / kHD / HG_;  // groups
  static_assert((C_ / kHD) % HG_ == 0, "hg must divide the heads");
};

// the stream, item by item: a pass's every head's q, k, v K tiles, then (but
// in mode io) the projection's (section_sm90.cuh's produce_section)
template <typename Pl, int MODE>
struct HgItems {
  static constexpr int QKV = Pl::NH * Pl::KT;
  static constexpr int PASS = QKV + (MODE != kHgIo ? Pl::C / 96 * Pl::KT : 0);  // items a pass
  const CUtensorMap *mq, *mp;
  __device__ __forceinline__ void operator()(int i, unsigned char* dst, uint64_t* bar) const {
    const int j = i % PASS;
    if (j < QKV)
      load_qkv<Pl>(dst, bar, mq, j / Pl::KT, j % Pl::KT);
    else
      load_proj<Pl>(dst, bar, mp, (j - QKV) / Pl::KT * 96, (j - QKV) % Pl::KT);
  }
};

// ---- the masks --------------------------------------------------------------------
// K9's: window w takes row w % rows of the [rows, 49] tables mask_tok and
// regions (null: no shift regions)
struct ShippedMasks {
  const float *mask_tok, *regions;
  int rows_m, rows_r;
  __device__ __forceinline__ bool regions_on() const { return regions != nullptr; }
  template <typename Pl>
  __device__ __forceinline__ void tables(float* rid_s, long long win0, int nwin) const {
    win_tables<Pl>(rid_s, regions, rows_r, win0, nwin);
  }
  template <typename Pl>
  __device__ __forceinline__ void ln(unsigned char* ys, const bf16* xb, long long win0, int nwin,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ beta, float eps) const {
    win_ln<Pl>(ys, xb, mask_tok, rows_m, win0, nwin, gamma, beta, eps);
  }
};

// K10's: the pad flag and region id of every token from the window index,
// token_geom's arithmetic (as K3 has them) with the window's 7 x 7 known at
// compile time and each window's origin worked out once a pass, the pad rows
// 49..63 of a window included (the JAX body's iota arithmetic gives them ids
// too; only the softmax mode, whose pad keys enter the sums, sees them)
struct GeomMasks {
  Geom g;  // g.ws is 7: the entry takes 7 x 7 windows only
  __device__ __forceinline__ bool regions_on() const { return g.shift > 0; }
  // the rolled coordinates of token 0 of each of the pass's W windows
  template <int W>
  __device__ __forceinline__ void origins(long long win0, int (&gr)[W], int (&gc)[W]) const {
    const int wn = g.wp / 7, hn = g.hp / 7;
#pragma unroll
    for (int wl = 0; wl < W; ++wl) {
      const int win = (int)win0 + wl;
      gr[wl] = win / wn % hn * 7;
      gc[wl] = win % wn * 7;
    }
  }
  // token t of the window whose token 0 is at rolled (r0, c0): pad flag, region id
  __device__ __forceinline__ bool valid(int r0, int c0, int t) const {
    int oh = r0 + t / 7 + g.shift, ow = c0 + t % 7 + g.shift;  // un-roll with wraparound
    if (oh >= g.hp) oh -= g.hp;
    if (ow >= g.wp) ow -= g.wp;
    return oh < g.h && ow < g.w;
  }
  __device__ __forceinline__ int region(int r0, int c0, int t) const {
    const int grh = r0 + t / 7, gwc = c0 + t % 7;
    return 3 * ((grh >= g.hp - 7) + (grh >= g.hp - g.shift)) +
           (gwc >= g.wp - 7) + (gwc >= g.wp - g.shift);
  }
  // window wl's origin, picked without indexing a register array by a variable
  template <int W>
  __device__ __forceinline__ void pick(const int (&gr)[W], const int (&gc)[W], int wl, int* r0,
                                       int* c0) const {
    *r0 = gr[0];
    *c0 = gc[0];
#pragma unroll
    for (int k = 1; k < W; ++k)
      if (wl == k) {
        *r0 = gr[k];
        *c0 = gc[k];
      }
  }
  template <typename Pl>
  __device__ __forceinline__ void tables(float* rid_s, long long win0, int nwin) const {
    if (!regions_on()) return;
    int gr[Pl::W], gc[Pl::W];
    origins(win0, gr, gc);
    for (int i = threadIdx.x; i < Pl::R; i += 256) {
      const int wl = i / kWinRows;
      int r0, c0;
      pick(gr, gc, wl, &r0, &c0);
      rid_s[i] = wl < nwin ? (float)region(r0, c0, i % kWinRows) : -1.0f;
    }
  }
  template <typename Pl>
  __device__ __forceinline__ void ln(unsigned char* ys, const bf16* xb, long long win0, int nwin,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ beta, float eps) const {
    int gr[Pl::W], gc[Pl::W];
    origins(win0, gr, gc);
    sm90::ln_rows_sw128<Pl::C, sm90::kLnBatch<Pl::C>>(
        [&](int r) -> const bf16* {
          const int wl = r / kWinRows, t = r % kWinRows;
          int r0, c0;
          pick(gr, gc, wl, &r0, &c0);
          return t < kN && wl < nwin && valid(r0, c0, t) ? xb + (size_t)(wl * kN + t) * Pl::C
                                                         : nullptr;
        },
        threadIdx.x / 32, kWarps, Pl::R, gamma, beta, eps, ys, Pl::YK);
  }
};

// out = T(x + y) of the pass's real rows, y read at its padded rows (mode io)
template <typename Pl>
__device__ __forceinline__ void win_io_out(const unsigned char* ys, const bf16* xb, bf16* ob,
                                           int nwin) {
  constexpr int C8 = Pl::C / 8;
  for (int i = threadIdx.x; i < nwin * kN * C8; i += 256) {
    const int r = i / C8, c8 = i % C8;
    const int pr = r / kN * kWinRows + r % kN;
    uint4 v = *reinterpret_cast<const uint4*>(xb + (size_t)r * Pl::C + c8 * 8);
    const uint4 y = *reinterpret_cast<const uint4*>(ys + (c8 / 8) * Pl::YK + pr * 128 +
                                                    (((c8 % 8) ^ (pr % 8)) << 4));
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
    const __nv_bfloat162* hy = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __hadd2(h[k], hy[k]);
    *reinterpret_cast<uint4*>(ob + (size_t)r * Pl::C + c8 * 8) = v;
  }
}

template <typename Pl, typename Masks, int MODE, bool CLK>
__global__ void __launch_bounds__(Pl::THREADS, 1)
hg_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mp,
          const bf16* __restrict__ x, const Masks masks, const float* __restrict__ gamma,
          const float* __restrict__ beta, const float* __restrict__ bqkv,
          const float* __restrict__ bproj, const bf16* __restrict__ bias,
          bf16* __restrict__ out, long long NW, int wblk, float eps, int score_f32,
          unsigned long long* __restrict__ clocks) {
  constexpr int C = Pl::C, W = Pl::W, S = Pl::S, HG = Pl::HG;
  constexpr bool CORE = MODE == kHgNone || MODE == kHgSoftmax;
  static_assert(MODE != kHgIoRaw, "mode ioraw runs no product");
  extern __shared__ unsigned char smem_raw[];
  const Passes ps = win_passes(NW, wblk, W);
  typedef HgItems<Pl, MODE> Items;
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
    if constexpr (CORE) masks.template tables<Pl>(rid_s, win0, nwin);
    masks.template ln<Pl>(ys, xb, win0, nwin, gamma, beta, eps);
    sm90::fence_async_smem();
    for (int grp = 0; grp < Pl::NG; ++grp) {
      const int h0 = grp * HG;
      // the group's bias: the barrier that ended the group before's attention is
      // behind us, the one before this group's attention shows it
      if constexpr (CORE) copy_bias(bias_s, bias, h0, HG);
      if (grp == 0) consumers_sync();  // y and the tables, whole
      clk.template lap<kClkSetup>();
      for (int j = 0; j < HG; ++j) {
        section_product<Pl>(q, ys, g, cofs, acc, clk);
        unsigned char* buf = qkv + (size_t)j * 3 * Pl::QKV;
        qkv_epilogue<Pl>(acc, g, cofs, h0 + j, Pl::R, bqkv,
                         [&](int which, int row, int d, uint32_t v) {
                           if constexpr (MODE == kHgAttn) {  // ctx = T(q * scale), real rows
                             const int wl = row / kWinRows, t = row % kWinRows;
                             if (which == 0 && t < kN && wl < nwin) {
                               const float2 f = __bfloat1622float2(
                                   *reinterpret_cast<const __nv_bfloat162*>(&v));
                               const float sc = score_f32 ? kScale : bf(kScale);
                               *reinterpret_cast<uint32_t*>(
                                   ob + (size_t)(wl * kN + t) * C + (h0 + j) * kHD + d) =
                                   pack2(f.x * sc, f.y * sc);
                             }
                           }
                           store_qkv<Pl>(buf, which, row, d, v, !score_f32);
                         });
        clk.template lap<kClkQkv>();
      }
      consumers_sync();  // the group's q, k, v and bias
      clk.template lap<kClkQkv>();
      if constexpr (CORE) {
        for (int u = cw; u < nwin * HG * 4; u += kWarps) {
          const int wl = u / (HG * 4), j = (u / 4) % HG, qt = u % 4;
          unsigned char* buf = qkv + (size_t)j * 3 * Pl::QKV + wl * kTileQ;
          win_core<MODE == kHgSoftmax ? kCoreLinearDiv : kCoreDivide>(
              buf, buf + Pl::QKV, buf + 2 * Pl::QKV, qt, bias_s + j * kBiasHead,
              masks.regions_on() ? rid_s + wl * kWinRows : nullptr, scale,
              ob + (size_t)wl * kN * C + (h0 + j) * kHD, C);
        }
        consumers_sync();  // the group's context is in `out`; q, k, v and the bias are free
        clk.template lap<kClkAttn>();
      }
    }
    if constexpr (MODE == kHgIo) {
      win_io_out<Pl>(ys, xb, ob, nwin);
      clk.template lap<kClkOut>();
    }
    if constexpr (MODE != kHgIo) {
      // the context back into y's place (y is dead), then a = x + T(T(ctx @ wproj) + T(bproj))
      ctx_to_y<Pl>(ob, nwin, ys);
      consumers_sync();
      clk.template lap<kClkCtx>();
      for (int n0 = 0; n0 < C; n0 += 96) {
        section_product<Pl>(q, ys, g, cofs, acc, clk);
        win_proj_epilogue<Pl>(acc, g, cofs, n0, nwin, bproj, xb, ob);
        clk.template lap<kClkOut>();
      }
    }
    ring_pass_end(q, (p + 1) * Items::PASS);
  }
  clk.flush(clocks);
}

// what a launch of hg_kernel takes beside its masks
struct HgLaunch {
  const bf16 *x, *wqkv, *wproj, *bias;
  const float *gamma, *beta, *bqkv, *bproj;
  bf16* out;
  long long NW;
  int wblk;
  float eps;
  int score_f32;
  unsigned long long* clocks;  // the measurement builds only
  cudaStream_t stream;
};

template <typename Pl, typename Masks, int MODE, bool CLK>
cudaError_t launch_hg(const HgLaunch& a, const Masks& masks) {
  constexpr int C = Pl::C;
  CUtensorMap mq, mp;
  cudaError_t err = win_qkv_map(&mq, a.wqkv, C);
  if (err == cudaSuccess) err = sm90::tile_map(&mp, a.wproj, C, C, 96);
  if (err != cudaSuccess) return err;
  auto kernel = hg_kernel<Pl, Masks, MODE, CLK>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Pl::SMEM);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((a.NW + a.wblk - 1) / a.wblk);
  kernel<<<grid, Pl::THREADS, Pl::SMEM, a.stream>>>(mq, mp, a.x, masks, a.gamma, a.beta, a.bqkv,
                                                    a.bproj, a.bias, a.out, a.NW, a.wblk, a.eps,
                                                    a.score_f32, a.clocks);
  return cudaGetLastError();
}

// the attributes and dynamic shared memory of a served build
template <typename Pl, typename Masks, int MODE>
int hg_attrs(cudaFuncAttributes* fa, int* smem) {
  *smem = (int)Pl::SMEM;
  return (int)cudaFuncGetAttributes(fa, hg_kernel<Pl, Masks, MODE, false>);
}

}  // namespace
