// The fp32 body of the probes' attention sections: K9 hg_section and K10
// hg2_section (benchmarks/swin_attn_hg.py:hg_section, :hg2_section) and K11
// section (benchmarks/swin_attn_variants.py:section) on fp32 windows, as
// `segland_section_f32`.  Their bf16 builds are attn_section_hg_sm90.cu,
// attn_section_hg2_sm90.cu and attn_section_variants.cu.
//
// One body: the pad mask and region ids come from shipped [rows, N] tables
// (K9, K11) or from the window index (K10, geom); the probabilities are
// normalised before PV (K11, norm_first) or the sum divides after it (K9,
// K10); the projection sums `group` channels of the context (a head group,
// one head, or all of them for K11's proj1) before adding to the accumulator,
// as the JAX bodies do, so hg only changes the order of fp32 sums.  The 7 pad
// tokens of the JAX wrappers' fp32 layout (56 tokens: y = 0, so q, k, v =
// bqkv; key bias -1e9; region id -1 for shipped tables, the window index's
// for K10) are keys here too: only the softmax ablation sees them.
//
// Modes: 0 none; 1 ioraw, out = x + x; 2 io, out = x + y; 3 ln, y = x * m;
// 4 attn, ctx = q; 5 attn with ctx = q * scale (K10); 6 softmax, p = 0.001 s
// (K10 then divides by its sum, K11 not); 7 nomax, exp(s) / sum; 8 bf16sm,
// e = exp(bf16(s - max)), p = bf16(e) / bf16(sum e) (as XLA runs the JAX body).
//
// Exact FMA loops, no TF32, as attn_section_v1.cu's fp32 build: this build is
// for correctness, not speed.  What bounds it on an H100: operations, the
// same count as the bf16 builds, against the 67 TFLOP/s of fp32 outside the
// tensor cores.  Design: a block owns `wblk` windows and takes them one at a
// time: y [49, C], q, k, v [56, 33], the scores [49, 57] and 7 rows of context
// [7, C] in shared memory (205,828 B at C = 768); the context of every head
// waits in the window's rows of the output buffer until the projection, 7
// rows a pass, has read them (attn_common.cuh:section_f32).

#include "attn_common.cuh"

namespace {

enum F32Mode { kNone = 0, kIoRaw = 1, kIo = 2, kLn = 3, kAttnQ = 4, kAttnQs = 5, kSoftmax = 6,
               kNoMax = 7, kBf16Sm = 8 };
constexpr int kT = 56;            // tokens of the fp32 layout, 7 of them pad
constexpr int kLSF8 = kT + 1;     // score row stride: 56 keys and the row sum
constexpr float kPadKeyBias = -1e9f;

__host__ __device__ constexpr size_t f32_smem_floats(int C) {
  return (size_t)kN * C + 3 * kT * kLQF + (size_t)kN * kLSF8 + (size_t)kRowsP * C + 2 * kT;
}

__global__ void __launch_bounds__(kThreads)
section_f32_kernel(const float* __restrict__ x, const float* __restrict__ mask_tok, int rows_m,
                   const float* __restrict__ regions, int rows_r, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const float* __restrict__ wqkv,
                   const float* __restrict__ bqkv, const float* __restrict__ wproj,
                   const float* __restrict__ bproj, const float* __restrict__ bias,
                   float* __restrict__ out, long long NW, int C, int wblk, Geom g, float eps,
                   int mode, int norm_first, int group) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ys = reinterpret_cast<float*>(smem);  // [N, C]
  float* qs = ys + (size_t)kN * C;             // q, k, v: 3 x [kT, kLQF]
  float* ks = qs + kT * kLQF;
  float* vs = ks + kT * kLQF;
  float* S = vs + kT * kLQF;                   // [N, kLSF8]: the scores, then p and the sum
  float* rowbuf = S + kN * kLSF8;              // [kRowsP, C]
  float* m_s = rowbuf + kRowsP * C;            // [kT]
  float* r_s = m_s + kT;                       // [kT]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nh = C / kHD;
  const float scale = 0.17677669529663687f;  // 32 ** -0.5, as the plain versions round it
  const bool shipped = mask_tok != nullptr;
  const bool use_rid = shipped ? regions != nullptr : g.shift > 0;
  const long long blk0 = (long long)blockIdx.x * wblk;
  const long long blk1 = blk0 + wblk < NW ? blk0 + wblk : NW;

  for (long long win = blk0; win < blk1; ++win) {
    const float* xw = x + (size_t)win * kN * C;
    float* ow = out + (size_t)win * kN * C;
    __syncthreads();  // the window before is done with every buffer
    if (mode == kIoRaw) {
      for (int i = threadIdx.x; i < kN * C; i += kThreads) ow[i] = xw[i] + xw[i];
      continue;
    }
    for (int t = threadIdx.x; t < kT; t += kThreads) {
      float m = 0.0f, r = -1.0f;
      if (shipped) {
        if (t < kN) {
          m = mask_tok[(size_t)(win % rows_m) * kN + t];
          if (regions) r = regions[(size_t)(win % rows_r) * kN + t];
        }
      } else {
        int valid, rid;
        token_geom((int)win, t, g, &valid, &rid);
        m = t < kN && valid ? 1.0f : 0.0f;
        r = (float)rid;
      }
      m_s[t] = m;
      r_s[t] = r;
    }
    __syncthreads();
    for (int r = warp; r < kN; r += kWarps) {
      if (mode == kLn) {
        for (int c = lane; c < C; c += 32) ys[r * C + c] = xw[(size_t)r * C + c] * m_s[r];
      } else {
        ln_row_f32(xw + (size_t)r * C, C, gamma, beta, eps, m_s[r], ys + r * C);
      }
    }
    __syncthreads();
    if (mode == kIo) {
      for (int i = threadIdx.x; i < kN * C; i += kThreads) ow[i] = xw[i] + ys[i];
      continue;
    }

    for (int h = 0; h < nh; ++h) {
      // q, k, v of head h: a thread a (column, half of the rows); pad rows are bqkv
      if (threadIdx.x < 192) {
        const int j = threadIdx.x % 96, half = threadIdx.x / 96;
        const int which = j / kHD, d = j % kHD;
        const int col = which * C + h * kHD + d;
        const int r0 = half * (kT / 2);
        float acc[kT / 2];
#pragma unroll
        for (int i = 0; i < kT / 2; ++i) acc[i] = 0.0f;
        for (int k = 0; k < C; ++k) {
          const float wv = wqkv[(size_t)k * 3 * C + col];
#pragma unroll
          for (int i = 0; i < kT / 2; ++i)
            if (r0 + i < kN) acc[i] += ys[(r0 + i) * C + k] * wv;
        }
        const float b = bqkv[col];
        float* dst = qs + which * kT * kLQF + d;
#pragma unroll
        for (int i = 0; i < kT / 2; ++i) dst[(r0 + i) * kLQF] = acc[i] + b;
      }
      __syncthreads();
      if (mode == kAttnQ || mode == kAttnQs) {
        for (int idx = threadIdx.x; idx < kN * kHD; idx += kThreads) {
          const int i = idx / kHD, d = idx % kHD;
          const float q = qs[i * kLQF + d];
          ow[(size_t)i * C + h * kHD + d] = mode == kAttnQs ? q * scale : q;
        }
        __syncthreads();
        continue;
      }
      const float* bh = bias + (size_t)h * kN * kN;
      for (int idx = threadIdx.x; idx < kN * kT; idx += kThreads) {
        const int i = idx / kT, j = idx % kT;
        float s = 0.0f;
#pragma unroll
        for (int d = 0; d < kHD; ++d) s += (qs[i * kLQF + d] * scale) * ks[j * kLQF + d];
        s = s + (j < kN ? bh[i * kN + j] : kPadKeyBias);
        if (use_rid && r_s[i] != r_s[j]) s += -100.0f;
        S[i * kLSF8 + j] = s;
      }
      __syncthreads();
      // the mode's softmax, one warp a row, lanes over keys j and j + 32
      for (int i = warp; i < kN; i += kWarps) {
        float* row = S + i * kLSF8;
        const int j1 = lane + 32;
        const float s0 = row[lane], s1 = j1 < kT ? row[j1] : -INFINITY;
        const float m = warp_max(fmaxf(s0, s1));
        float e0, e1;
        if (mode == kSoftmax) {
          e0 = 0.001f * s0;
          e1 = j1 < kT ? 0.001f * s1 : 0.0f;
        } else if (mode == kNoMax) {
          e0 = expf(s0);
          e1 = j1 < kT ? expf(s1) : 0.0f;
        } else if (mode == kBf16Sm) {
          e0 = expf(bf(s0 - m));
          e1 = j1 < kT ? expf(bf(s1 - m)) : 0.0f;
        } else {
          e0 = expf(s0 - m);
          e1 = j1 < kT ? expf(s1 - m) : 0.0f;
        }
        const float sum = warp_sum(e0 + e1);
        if (mode == kBf16Sm) {
          const float sb = bf(sum);
          e0 = bf(e0) / sb;
          e1 = bf(e1) / sb;
        } else if (norm_first && mode != kSoftmax) {
          e0 = e0 / sum;
          e1 = e1 / sum;
        }
        row[lane] = e0;
        if (j1 < kT) row[j1] = e1;
        if (lane == 0) row[kT] = sum;
      }
      __syncthreads();
      const bool divide = !norm_first;
      for (int idx = threadIdx.x; idx < kN * kHD; idx += kThreads) {
        const int i = idx / kHD, d = idx % kHD;
        float a = 0.0f;
        for (int j = 0; j < kT; ++j) a += S[i * kLSF8 + j] * vs[j * kLQF + d];
        ow[(size_t)i * C + h * kHD + d] = divide ? a / S[i * kLSF8 + kT] : a;
      }
      __syncthreads();
    }

    // out = x + (ctx @ wproj + bproj), the context rows of the output buffer 7 at a
    // time; a group of `group` channels is summed before it joins the accumulator
    for (int r0 = 0; r0 < kN; r0 += kRowsP) {
      for (int i = threadIdx.x; i < kRowsP * C; i += kThreads) rowbuf[i] = ow[(size_t)r0 * C + i];
      __syncthreads();
      for (int c = threadIdx.x; c < C; c += kThreads) {
        float acc[kRowsP];
#pragma unroll
        for (int i = 0; i < kRowsP; ++i) acc[i] = 0.0f;
        for (int k0 = 0; k0 < C; k0 += group) {
          float part[kRowsP];
#pragma unroll
          for (int i = 0; i < kRowsP; ++i) part[i] = 0.0f;
          for (int k = k0; k < k0 + group; ++k) {
            const float wv = wproj[(size_t)k * C + c];
#pragma unroll
            for (int i = 0; i < kRowsP; ++i) part[i] += rowbuf[i * C + k] * wv;
          }
#pragma unroll
          for (int i = 0; i < kRowsP; ++i) acc[i] += part[i];
        }
        const float b = bproj[c];
#pragma unroll
        for (int i = 0; i < kRowsP; ++i)
          ow[(size_t)(r0 + i) * C + c] = xw[(size_t)(r0 + i) * C + c] + (acc[i] + b);
      }
      __syncthreads();
    }
  }
}

}  // namespace

// fp32 everything: x, out [NW, N, C], weights, vectors, bias [nh, N, N];
// mask_tok [rows_m, N] and regions [rows_r, N] (or null) for shipped masks, or
// mask_tok null and geom = (h, w, hp, wp, ws, shift).  Built at C = 96, 192,
// 384, 768.  Returns a cudaError_t.
extern "C" int segland_section_f32(const void* x, const void* mask_tok, int rows_m,
                                   const void* regions, int rows_r, const void* gamma,
                                   const void* beta, const void* wqkv, const void* bqkv,
                                   const void* wproj, const void* bproj, const void* bias,
                                   void* out, long long NW, int C, int nh, int wblk, int h, int w,
                                   int hp, int wp, int ws, int shift, float eps, int mode,
                                   int norm_first, int group, int device, void* stream) {
  if (nh * kHD != C || (C != 96 && C != 192 && C != 384 && C != 768) || wblk < 1 ||
      mode < kNone || mode > kBf16Sm || group < kHD || C % group || (mask_tok && rows_m < 1) ||
      (regions && (!mask_tok || rows_r < 1)))
    return (int)cudaErrorInvalidValue;
  if (!mask_tok && mode != kIoRaw &&
      (ws * ws != kN || hp % ws || wp % ws || shift < 0 || shift >= ws))
    return (int)cudaErrorInvalidValue;
  if (NW <= 0) return (int)cudaSuccess;
  if (NW > 2147483647LL / kN) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = f32_smem_floats(C) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(section_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((NW + wblk - 1) / wblk);
  const Geom g = {h, w, hp, wp, ws, shift};
  section_f32_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)mask_tok, rows_m, (const float*)regions, rows_r,
      (const float*)gamma, (const float*)beta, (const float*)wqkv, (const float*)bqkv,
      (const float*)wproj, (const float*)bproj, (const float*)bias, (float*)out, NW, C, wblk, g,
      eps, mode, norm_first, group);
  return (int)cudaGetLastError();
}
