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
// Design (bf16): the block of 8 warps that owns W windows (4 at C=96, 2 at
// C=192, 1 above) runs the section body shared with attn_section.cu
// (attn_common.cuh:section_bf16) with its last epilogue turned inwards: `a`
// lands as bf16 over the dead y buffer instead of in device memory.  The ring
// of wqkv/wproj chunks is drained; the shared memory behind y and ctx (q, k,
// v, the score strips, the ring, the bias) becomes the MLP's: a scratch tile
// a warp, the hidden chunk and STAGES buffers of w1 columns and w2 rows.
// LN2 goes from `a` to the dead ctx buffer, one warp a row.  The MLP then
// walks the block's rows in groups of MR (64, or 32 at C=768) and, inside a
// group, the hidden dimension in chunks of HC, as ln_mlp.cu does: a chunk of
// h by WMMA through bias and GELU into shared memory, at once consumed by the
// second product, whose [MR, C] fp32 accumulator lives in registers (a warp
// owns RS 16-row slabs and C / (16 * WC) column fragments).  Weight chunks
// are copied by cp.async, the next one in flight under this one's products
// where two buffers fit (C <= 384).  At C=768 `a` and y2 of one window are
// 152 KB of the 227 KB a block can have, so the group is 32 rows (96
// accumulator registers a thread instead of 192), the chunk 16 hidden
// columns in one buffer (62 KB), and each of its 2 hidden fragments is split
// 4 ways along k over the 8 warps and summed in shared memory.  Every group
// streams w1 and w2 again from L2.  A row tile of y2 past the block's real
// rows reads whatever follows the buffer: an output row depends on its own
// input row only, and those rows are never stored.
// The fp32 build (exact FMA loops, no TF32) runs one window a block: the fp32
// section with `a` kept over y, then LN2 and the MLP 16 rows at a time with
// w1 and w2 read from device memory.
//
// Measured on an H100 (nvcc 12.8 -Xptxas -v; times from chip_smoke.py --phases
// k4): bf16 176 / 128 / 255 / 212 registers at C = 96 / 192 / 384 / 768, no
// spills but 40 bytes at C=192; fp32 80 / 126 / 234 / 255 registers, 420 bytes
// of spills at C=768 only.  3.86 / 2.75 / 3.07 / 4.26 ms a call at the swin-s
// stage shapes, 37-52 TFLOP/s, against 2.78 / 2.03 / 2.78 / 3.27 ms for
// attn_section then ln_mlp as two launches: the MLP phase runs at one block
// of 8 warps an SM beside the section's shared memory, where ln_mlp alone has
// two to four blocks an SM to hide its loads behind, and it spends 64 rows on
// every 49-token window.

#include "attn_common.cuh"

namespace {

// The section's <C, W, P, KC, S> and the MLP's: WR warps down a group's rows
// with RS slabs each, HC hidden columns a chunk, STAGES weight buffers.
template <int C, int W, int P, int KC, int S, int WR, int RS, int HC, int STAGES>
struct BlockCfg {
  typedef SecCfg<C, W, P, KC, S> Sec;
  static constexpr int R = Sec::R;
  static constexpr int LDY = Sec::LDY;
  static constexpr int MR = 16 * RS * WR;           // rows a group
  static constexpr int NG = (R + MR - 1) / MR;      // groups a block
  static constexpr int WC = kWarps / WR;            // warps across the C columns
  static constexpr int NF = C / 16 / WC;            // output fragments a warp and slab
  static constexpr int F1 = (MR / 16) * (HC / 16);  // hidden fragments a chunk
  static constexpr int KS = F1 < kWarps ? kWarps / F1 : 1;  // k-split of each of them
  static constexpr int LDH = HC + 8;
  static constexpr int LDW1 = HC + 8;               // staged w1[:, chunk], [C, LDW1]
  static constexpr int LDW2 = C + 8;                // staged w2[chunk, :], [HC, LDW2]
  // the MLP phase keeps `a` over y and y2 over ctx, and takes the rest
  static constexpr size_t OFF_S = Sec::OFF_Q;       // a 16 x 16 fp32 tile a warp
  static constexpr size_t OFF_H = OFF_S + (size_t)kWarps * 256 * sizeof(float);
  static constexpr size_t OFF_W = OFF_H + align128((size_t)MR * LDH * sizeof(bf16));
  static constexpr size_t W1_BYTES = align128((size_t)C * LDW1 * sizeof(bf16));
  static constexpr size_t BUF = W1_BYTES + align128((size_t)HC * LDW2 * sizeof(bf16));
  static constexpr size_t SMEM = max_size(Sec::SMEM, OFF_W + STAGES * BUF);
  static_assert(kWarps % WR == 0 && C % (16 * WC) == 0, "C must split over the warp columns");
  static_assert(F1 % kWarps == 0 || kWarps % F1 == 0, "a chunk must split over the warps");
  static_assert((C / 16) % KS == 0, "the first product's k must split KS ways");
  static_assert(STAGES == 1 || STAGES == 2, "one or two weight buffers");
  static_assert(Sec::OFF_CTX + (size_t)NG * MR * LDY * sizeof(bf16) <= SMEM,
                "a row tile past y2 must stay inside the block's shared memory");
  static_assert(SMEM <= kMaxSmem, "over the shared memory a block can have");
};

template <typename Cfg, int C, int HC>
__device__ __forceinline__ void stage_mlp_chunk(unsigned char* buf, const bf16* __restrict__ w1,
                                                const bf16* __restrict__ w2, int j0, int H) {
  bf16* sw1 = reinterpret_cast<bf16*>(buf);
  bf16* sw2 = reinterpret_cast<bf16*>(buf + Cfg::W1_BYTES);
  constexpr int R1 = HC / 8, R2 = C / 8;  // 16-byte copies a row
  for (int i = threadIdx.x; i < C * R1; i += kThreads) {
    const int r = i / R1, c = (i % R1) * 8;
    cp_async16(sw1 + r * Cfg::LDW1 + c, w1 + (size_t)r * H + j0 + c);
  }
  for (int i = threadIdx.x; i < HC * R2; i += kThreads) {
    const int r = i / R2, c = (i % R2) * 8;
    cp_async16(sw2 + r * Cfg::LDW2 + c, w2 + (size_t)(j0 + r) * C + c);
  }
  cp_async_commit();
}

// h = T(gelu(T(T(acc) + T(b1)))): the first product's epilogue
__device__ __forceinline__ bf16 bias_gelu(float acc, float b) {
  return __float2bfloat16(gelu_tanh(bf(bf(acc) + bf(b))));
}

template <int C, int W, int P, int KC, int S, int WR, int RS, int HC, int STAGES>
__global__ void __launch_bounds__(kThreads)
swin_block_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta, const bf16* __restrict__ wqkv,
                       const float* __restrict__ bqkv, const bf16* __restrict__ wproj,
                       const float* __restrict__ bproj, const float* __restrict__ bias,
                       const float* __restrict__ gamma2, const float* __restrict__ beta2,
                       const bf16* __restrict__ w1, const float* __restrict__ b1,
                       const bf16* __restrict__ w2, const float* __restrict__ b2,
                       bf16* __restrict__ out, long long NW, int H, Geom g, float eps) {
  typedef BlockCfg<C, W, P, KC, S, WR, RS, HC, STAGES> Cfg;
  extern __shared__ __align__(128) unsigned char smem[];
  section_bf16<C, W, P, KC, S, true>(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, nullptr, NW,
                                     g, eps, smem);
  cp_async_wait<0>();
  __syncthreads();  // `a` is whole, and everything behind y and ctx is free

  const bf16* as = reinterpret_cast<const bf16*>(smem);               // a, [R, LDY]
  bf16* y2 = reinterpret_cast<bf16*>(smem + Cfg::Sec::OFF_CTX);       // [R, LDY]
  float* scratch = reinterpret_cast<float*>(smem + Cfg::OFF_S);
  bf16* hb = reinterpret_cast<bf16*>(smem + Cfg::OFF_H);              // [MR, LDH]
  unsigned char* wbuf = smem + Cfg::OFF_W;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp % WR, wc = warp / WR;
  const long long win0 = (long long)blockIdx.x * W;
  const int nwin = (int)((NW - win0) < (long long)W ? (NW - win0) : (long long)W);
  const int rows = nwin * kN;
  float* scr = scratch + warp * 256;
  const int nchk = H / HC;
  const int total = ((rows + Cfg::MR - 1) / Cfg::MR) * nchk;  // chunks over this block's groups

  stage_mlp_chunk<Cfg, C, HC>(wbuf, w1, w2, 0, H);
  for (int r = warp; r < Cfg::R; r += kWarps) {
    const bf16* src = as + r * Cfg::LDY;
    ln_row_bf16<C>([&](int c) { return __bfloat162float(src[c]); }, gamma2, beta2, eps, 1.0f,
                   y2 + r * Cfg::LDY);
  }

  FragC acc[RS][Cfg::NF];
  for (int t = 0; t < total; ++t) {
    const int grp = t / nchk, j0 = (t % nchk) * HC;
    unsigned char* buf = wbuf + (STAGES == 2 ? (t & 1) : 0) * Cfg::BUF;
    if (STAGES == 1) {
      if (t > 0) stage_mlp_chunk<Cfg, C, HC>(buf, w1, w2, j0, H);
      cp_async_wait<0>();
    } else if (t + 1 < total) {
      stage_mlp_chunk<Cfg, C, HC>(wbuf + ((t + 1) & 1) * Cfg::BUF, w1, w2,
                                  ((t + 1) % nchk) * HC, H);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this chunk's weights (and, at t = 0, y2) are visible
    const bf16* sw1 = reinterpret_cast<const bf16*>(buf);
    const bf16* sw2 = reinterpret_cast<const bf16*>(buf + Cfg::W1_BYTES);
    const bf16* yg = y2 + grp * Cfg::MR * Cfg::LDY;
    if (j0 == 0) {
#pragma unroll
      for (int s = 0; s < RS; ++s)
#pragma unroll
        for (int f = 0; f < Cfg::NF; ++f) wmma::fill_fragment(acc[s][f], 0.0f);
    }

    // h[:, j0:j0+HC] = gelu(y2 @ w1[:, chunk] + b1)
    if constexpr (Cfg::KS > 1) {
      // one fragment and one k-range a warp; the partial tiles are summed by the block
      const int f = warp % Cfg::F1, q = warp / Cfg::F1;
      const int slab = f % (Cfg::MR / 16), n = f / (Cfg::MR / 16) * 16;
      const bf16* ya = yg + slab * 16 * Cfg::LDY;
      constexpr int KR = C / Cfg::KS;
      FragC hacc;
      wmma::fill_fragment(hacc, 0.0f);
#pragma unroll 4
      for (int k = q * KR; k < (q + 1) * KR; k += 16) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, ya + k, Cfg::LDY);
        wmma::load_matrix_sync(b, sw1 + k * Cfg::LDW1 + n, Cfg::LDW1);
        wmma::mma_sync(hacc, a, b, hacc);
      }
      wmma::store_matrix_sync(scr, hacc, 16, wmma::mem_row_major);
      __syncthreads();
      for (int e = threadIdx.x; e < Cfg::F1 * 256; e += kThreads) {
        const int ff = e / 256, i = e % 256;
        float sum = 0.0f;
#pragma unroll
        for (int p = 0; p < Cfg::KS; ++p) sum += scratch[(ff + Cfg::F1 * p) * 256 + i];
        const int sl = ff % (Cfg::MR / 16), nn = ff / (Cfg::MR / 16) * 16 + i % 16;
        hb[(sl * 16 + i / 16) * Cfg::LDH + nn] = bias_gelu(sum, b1[j0 + nn]);
      }
    } else {
      // whole fragments dealt round-robin, each through its warp's scratch tile
#pragma unroll
      for (int q = 0; q < Cfg::F1 / kWarps; ++q) {
        const int id = warp + kWarps * q;
        const int slab = id % (Cfg::MR / 16), n = id / (Cfg::MR / 16) * 16;
        const bf16* ya = yg + slab * 16 * Cfg::LDY;
        FragC hacc;
        wmma::fill_fragment(hacc, 0.0f);
        for (int k = 0; k < C; k += 16) {
          FragA a;
          FragB b;
          wmma::load_matrix_sync(a, ya + k, Cfg::LDY);
          wmma::load_matrix_sync(b, sw1 + k * Cfg::LDW1 + n, Cfg::LDW1);
          wmma::mma_sync(hacc, a, b, hacc);
        }
        wmma::store_matrix_sync(scr, hacc, 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int c = n + e % 16;
          hb[(slab * 16 + e / 16) * Cfg::LDH + c] = bias_gelu(scr[e], b1[j0 + c]);
        }
        __syncwarp();
      }
    }
    __syncthreads();
    // acc += h[:, chunk] @ w2[chunk, :]
    const bf16* ha = hb + wr * RS * 16 * Cfg::LDH;
#pragma unroll
    for (int k = 0; k < HC; k += 16) {
      FragA a[RS];
#pragma unroll
      for (int s = 0; s < RS; ++s)
        wmma::load_matrix_sync(a[s], ha + s * 16 * Cfg::LDH + k, Cfg::LDH);
#pragma unroll
      for (int f = 0; f < Cfg::NF; ++f) {
        FragB b;
        wmma::load_matrix_sync(b, sw2 + k * Cfg::LDW2 + (wc * Cfg::NF + f) * 16, Cfg::LDW2);
#pragma unroll
        for (int s = 0; s < RS; ++s) wmma::mma_sync(acc[s][f], a[s], b, acc[s][f]);
      }
    }
    if (j0 + HC >= H) {
      // out = T(a + T(T(acc) + T(b2))) for this group's real rows
#pragma unroll
      for (int sf = 0; sf < RS * Cfg::NF; ++sf) {
        const int s = sf / Cfg::NF, f = sf % Cfg::NF;
        const int col = (wc * Cfg::NF + f) * 16 + lane % 16;  // this lane's column of the tile
        const float bcol = bf(b2[col]);
        wmma::store_matrix_sync(scr, acc[s][f], 16, wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = grp * Cfg::MR + (wr * RS + s) * 16 + lane / 16 + 2 * i;
          if (row < rows) {
            const float o = bf(bf(scr[lane + 32 * i]) + bcol);
            out[((size_t)win0 * kN + row) * C + col] =
                __float2bfloat16(__bfloat162float(as[row * Cfg::LDY + col]) + o);
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();  // hb, the scratch tiles and this chunk's weight buffer are rewritten next
  }
}

// ---- fp32: exact FMA loops --------------------------------------------------
constexpr int kRG = 16;   // rows a group of the fp32 MLP
constexpr int kHCF = 64;  // hidden columns a chunk of the fp32 MLP

__host__ __device__ constexpr size_t block_f32_bytes(int C) {
  const size_t sec = (section_f32_floats(C) - (size_t)kN * C) * sizeof(float) + 128;
  const size_t mlp = ((size_t)kRG * C + kRG * kHCF) * sizeof(float);
  return (size_t)kN * C * sizeof(float) + max_size(sec, mlp);
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
  constexpr int PER = kRG * C / kThreads;      // output elements a thread
  constexpr int HPER = kRG * kHCF / kThreads;  // hidden elements a thread
  constexpr int RSTEP = kThreads / kHCF;
  static_assert(kRG * C % kThreads == 0, "C must be a multiple of 16");
  extern __shared__ __align__(128) unsigned char smem[];
  float* as = reinterpret_cast<float*>(smem);  // a over the section's y, [N, C]
  float* y2 = as + kN * C;                     // [kRG, C], over the section's q, k, v
  float* hs = y2 + kRG * C;                    // [kRG, kHCF]
  const long long win = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* ow = out + (size_t)win * kN * C;
  section_f32(x + (size_t)win * kN * C, gamma, beta, wqkv, bqkv, wproj, bproj, bias, ow, C, win,
              g, eps, smem, [&](int row, int c, float v) { as[row * C + c] = v; });

  const int n = threadIdx.x % kHCF, rr0 = threadIdx.x / kHCF;
  for (int r0 = 0; r0 < kN; r0 += kRG) {
    for (int r = warp; r < kRG; r += kWarps) {
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
  }
}

struct BlockArgs {
  const void *x, *wqkv, *wproj, *w1, *w2;
  const float *gamma, *beta, *bqkv, *bproj, *bias, *gamma2, *beta2, *b1, *b2;
  void* out;
  long long NW;
  int H;
  Geom g;
  float eps;
  cudaStream_t stream;
};

template <int C, int W, int P, int KC, int S, int WR, int RS, int HC, int STAGES>
cudaError_t launch_block_bf16(const BlockArgs& a) {
  typedef BlockCfg<C, W, P, KC, S, WR, RS, HC, STAGES> Cfg;
  if (a.H % HC != 0) return cudaErrorInvalidValue;
  auto kernel = swin_block_bf16_kernel<C, W, P, KC, S, WR, RS, HC, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Cfg::SMEM);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((a.NW + W - 1) / W);
  kernel<<<grid, kThreads, Cfg::SMEM, a.stream>>>(
      (const bf16*)a.x, a.gamma, a.beta, (const bf16*)a.wqkv, a.bqkv, (const bf16*)a.wproj,
      a.bproj, a.bias, a.gamma2, a.beta2, (const bf16*)a.w1, a.b1, (const bf16*)a.w2, a.b2,
      (bf16*)a.out, a.NW, a.H, a.g, a.eps);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_block_f32(const BlockArgs& a) {
  if (a.H % kHCF != 0) return cudaErrorInvalidValue;
  constexpr size_t smem = block_f32_bytes(C);
  static_assert(smem <= kMaxSmem, "over the shared memory a block can have");
  auto kernel = swin_block_f32_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)a.NW, kThreads, smem, a.stream>>>(
      (const float*)a.x, a.gamma, a.beta, (const float*)a.wqkv, a.bqkv, (const float*)a.wproj,
      a.bproj, a.bias, a.gamma2, a.beta2, (const float*)a.w1, a.b1, (const float*)a.w2, a.b2,
      (float*)a.out, a.H, a.g, a.eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, the four weight matrices, out);
// vectors and bias [nh, N, N] are fp32; w1 [C, H], w2 [H, C].  Windows of
// 7 x 7 tokens, heads of 32, C in {96, 192, 384, 768}.  Returns a cudaError_t.
extern "C" int segland_swin_block(int dtype, const void* x, const void* gamma, const void* beta,
                                  const void* wqkv, const void* bqkv, const void* wproj,
                                  const void* bproj, const void* bias, const void* gamma2,
                                  const void* beta2, const void* w1, const void* b1,
                                  const void* w2, const void* b2, void* out, long long NW, int C,
                                  int nh, int H, int h, int w, int hp, int wp, int ws, int shift,
                                  float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ws * ws != kN || nh * kHD != C || hp % ws || wp % ws || shift < 0 || shift >= ws || H <= 0)
    return (int)cudaErrorInvalidValue;
  if (NW <= 0) return (int)cudaSuccess;
  if (NW > 2147483647LL / kN) return (int)cudaErrorInvalidValue;
  const BlockArgs a = {x, wqkv, wproj, w1, w2,
                       (const float*)gamma, (const float*)beta, (const float*)bqkv,
                       (const float*)bproj, (const float*)bias, (const float*)gamma2,
                       (const float*)beta2, (const float*)b1, (const float*)b2,
                       out, NW, H, {h, w, hp, wp, ws, shift}, eps, (cudaStream_t)stream};
  if (dtype == 1) {
    switch (C) {
      // <C, W, P, KC, S,  WR, RS, HC, STAGES>
      case 96: return (int)launch_block_bf16<96, 4, 1, 48, 3, 4, 1, 64, 2>(a);
      case 192: return (int)launch_block_bf16<192, 2, 1, 96, 3, 2, 2, 32, 2>(a);
      case 384: return (int)launch_block_bf16<384, 1, 2, 96, 4, 2, 2, 32, 2>(a);
      case 768: return (int)launch_block_bf16<768, 1, 2, 32, 4, 1, 2, 16, 1>(a);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 96: return (int)launch_block_f32<96>(a);
    case 192: return (int)launch_block_f32<192>(a);
    case 384: return (int)launch_block_f32<384>(a);
    case 768: return (int)launch_block_f32<768>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}
