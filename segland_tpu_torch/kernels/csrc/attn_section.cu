// The Swin attention section over window-partitioned tokens, and its inner
// window-attention core.
//
// Replaces: segland_tpu/ops/pallas_attn.py:_attn_section_v2_pallas (body
// `_v2_attn_body`) as `segland_attn_section`, and
// segland_tpu/ops/pallas_attn.py:window_attention_fused (body `_attn_kernel`)
// as `segland_window_attention`.  Both share the per-head core of
// attn_common.cuh, where the section's body lives too: swin_block.cu runs it
// as the first half of a whole block.
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
// 8*C^2 bytes of weights, which every block re-reads from L2.
//
// Design (bf16): one block of 8 warps owns W windows (4 at C=96, 2 at C=192,
// 1 above: y and ctx of more do not fit) as one flat [W*49, C] row matrix.
// The normalised rows y and the context ctx stay in shared memory; qkv never
// exists whole: heads are walked one at a time, each head's q, k, v
// ([rows, 32] each) made by one [rows, C] x [C, 96] WMMA product.  The
// projection is the same product over ctx, 96 output columns a pass.  The
// weight columns of all these products are one stream of chunks of KC rows,
// copied by cp.async into a ring of S buffers S - 1 chunks ahead, across the
// boundaries between products and under the attention, one barrier a chunk;
// a block reads each weight once.  The head's [49, 49] bias is copied to
// shared memory on the way.  The attention core is warp-local: a warp takes
// one (window, 16-query-row) tile, writes its 16 x 64 scores to a private
// strip of shared memory, does the softmax there with two lanes a row (16
// rows at once, one shuffle a reduction), writes the probabilities over the
// scores as bf16 and multiplies by v; no block barrier inside a head's
// attention.  N is padded to 64 only inside the core: phantom keys are masked
// in the softmax and given zero probability.  Row tiles of 16 may reach past
// the W*49 real rows of y or ctx into the buffer that follows; a product's
// output row depends on its own input row only, so that feeds phantom rows
// alone, which are never stored (q/k/v keep a zeroed tail so phantom keys and
// values are finite).  On an H100 the kernel reaches 29-41 TFLOP/s: the WMMA
// loops (one 16-deep step of 3-6 products a warp between shared-memory
// loads, 8 warps an SM) are about half of a block's time at C >= 384, the
// attention core and the epilogues, through shared-memory tiles, most of
// the rest.
// The fp32 build uses exact fp32 FMA loops (no TF32), one window a block,
// and keeps ctx in the output buffer until the projection overwrites it.

#include "attn_common.cuh"

namespace {

template <int C, int W, int P, int KC, int S>
__global__ void __launch_bounds__(kThreads)
attn_section_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                         const float* __restrict__ beta, const bf16* __restrict__ wqkv,
                         const float* __restrict__ bqkv, const bf16* __restrict__ wproj,
                         const float* __restrict__ bproj, const float* __restrict__ bias,
                         bf16* __restrict__ out, long long NW, Geom g, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  section_bf16<C, W, P, KC, S, false>(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, out, NW, g,
                                      eps, smem);
}

// ---- window_attention, bf16: one (window, head) a block of 4 warps ---------
__global__ void __launch_bounds__(128)
window_attention_bf16_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                             bf16* __restrict__ out, int C, int nh, int nw_img) {
  __shared__ __align__(128) bf16 qs[3][64 * kLQ];
  __shared__ __align__(128) float strips[4][kStrip];
  __shared__ float bias_s[kN * kN];
  const long long w = blockIdx.x / nh;
  const int h = blockIdx.x % nh;
  const int warp = threadIdx.x / 32;
  const float* bsrc = bias + ((size_t)(w % nw_img) * nh + h) * kN * kN;
  for (int i = threadIdx.x; i < kN * kN; i += 128) bias_s[i] = bsrc[i];
  for (int i = threadIdx.x; i < 3 * 64 * 4; i += 128) {
    const int which = i / 256, r = (i % 256) / 4, piece = i % 4;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < kN)
      val = *reinterpret_cast<const uint4*>(qkv + ((size_t)w * kN + r) * 3 * C + which * C +
                                            h * kHD + piece * 8);
    *reinterpret_cast<uint4*>(&qs[which][r * kLQ + piece * 8]) = val;
  }
  __syncthreads();
  attn_tile_bf16(qs[0], qs[1], qs[2], warp, bias_s, nullptr,
                 rsqrtf((float)kHD), strips[warp], out + (size_t)w * kN * C + h * kHD, (size_t)C);
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

__global__ void __launch_bounds__(128)
window_attention_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
                            float* __restrict__ out, int C, int nh, int nw_img) {
  __shared__ float qs[3 * kN * kLQF];
  __shared__ float S[kN * kLSF];
  const long long w = blockIdx.x / nh;
  const int h = blockIdx.x % nh;
  for (int i = threadIdx.x; i < 3 * kN * kHD; i += 128) {
    const int which = i / (kN * kHD), r = (i / kHD) % kN, d = i % kHD;
    qs[which * kN * kLQF + r * kLQF + d] =
        qkv[((size_t)w * kN + r) * 3 * C + which * C + h * kHD + d];
  }
  __syncthreads();
  attn_head_f32(qs, qs + kN * kLQF, qs + 2 * kN * kLQF, S,
                bias + ((size_t)(w % nw_img) * nh + h) * kN * kN, nullptr, rsqrtf((float)kHD),
                out + (size_t)w * kN * C + h * kHD, (size_t)C);
}

template <int C, int W, int P, int KC, int S>
cudaError_t launch_section_bf16(const void* x, const float* gamma, const float* beta,
                                const void* wqkv, const float* bqkv, const void* wproj,
                                const float* bproj, const float* bias, void* out, long long NW,
                                Geom g, float eps, cudaStream_t stream) {
  typedef SecCfg<C, W, P, KC, S> Cf;
  auto kernel = attn_section_bf16_kernel<C, W, P, KC, S>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Cf::SMEM);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((NW + W - 1) / W);
  kernel<<<grid, kThreads, Cf::SMEM, stream>>>(
      (const bf16*)x, gamma, beta, (const bf16*)wqkv, bqkv, (const bf16*)wproj, bproj, bias,
      (bf16*)out, NW, g, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, wqkv, wproj, out); vectors and bias
// [nh, N, N] are fp32.  Windows of 7 x 7 tokens and heads of 32 only; bf16
// has builds for C in {96, 192, 384, 768}.  Returns a cudaError_t.
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
      // <C, W, P, KC, S>
      case 96: return (int)launch_section_bf16<96, 4, 1, 48, 3>(SEGLAND_ARGS);
      case 192: return (int)launch_section_bf16<192, 2, 1, 96, 3>(SEGLAND_ARGS);
      case 384: return (int)launch_section_bf16<384, 1, 2, 96, 4>(SEGLAND_ARGS);
      case 768: return (int)launch_section_bf16<768, 1, 2, 32, 4>(SEGLAND_ARGS);
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

// qkv [NW, 49, 3C] and out [NW, 49, C] in dtype; bias [nw_img, nh, 49, 49]
// fp32, window w using bias[w % nw_img].  Heads of 32.  Returns a cudaError_t.
extern "C" int segland_window_attention(int dtype, const void* qkv, const void* bias, void* out,
                                        long long NW, int C, int nh, int nw_img, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nh * kHD != C || nw_img < 1 || NW * nh > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (NW <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = (unsigned)(NW * nh);
  if (dtype == 1) {
    window_attention_bf16_kernel<<<grid, 128, 0, s>>>((const bf16*)qkv, (const float*)bias,
                                                      (bf16*)out, C, nh, nw_img);
  } else if (dtype == 0) {
    window_attention_f32_kernel<<<grid, 128, 0, s>>>((const float*)qkv, (const float*)bias,
                                                     (float*)out, C, nh, nw_img);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
