// Eval epilogue: argmax over K of the bilinear (align_corners=True) fp32
// upsample of (B, h, w, K) logits to (oh, ow); only the uint8 class map is
// written.
//
// Replaces: segland_tpu/ops/fused_epilogue.py:upsample_argmax (body
// `_kernel`).  The TPU kernel ran both interpolation axes as split-bf16
// matrix products to reach fp32 accuracy on its matrix unit; here each
// output pixel is a plain fp32 4-tap lerp, so no split is needed.
//
// What bounds it on an H100: bytes.  At the serving shape (8, 256, 256, 8)
// -> (8, 1024, 1024) it reads 16 MB of logits and writes 8 MB of classes;
// the 268 MB of upsampled fp32 logits that an unfused resize + argmax
// would write and read back never exist.
//
// Design: one thread per output pixel.  The row and column (lo, hi, w)
// tables come from the host (float64 -> fp32, as ops/resize.py builds
// them), so the kernel and its plain version use the same weights.  Per
// class the rows are interpolated first and then the columns, in the order
// of the plain version, and the running (best, idx) is replaced only by a
// strictly greater value: the first maximum wins.  Neighbouring threads share
// source taps, which the L1 cache serves.  Any (h, w) -> (oh, ow) and any
// K <= 255 is taken.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__global__ void upsample_argmax_kernel(const float* __restrict__ logits,
                                       const int* __restrict__ rlo,
                                       const int* __restrict__ rhi,
                                       const float* __restrict__ rw,
                                       const int* __restrict__ clo,
                                       const int* __restrict__ chi,
                                       const float* __restrict__ cw,
                                       uint8_t* __restrict__ out, long long total,
                                       int h, int w, int K, int oh, int ow) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int x = (int)(idx % ow);
  const long long t = idx / ow;
  const int y = (int)(t % oh);
  const long long b = t / oh;

  const float wy = rw[y], wx = cw[x];
  const float* img = logits + b * h * w * K;
  const float* p00 = img + ((long long)rlo[y] * w + clo[x]) * K;
  const float* p01 = img + ((long long)rlo[y] * w + chi[x]) * K;
  const float* p10 = img + ((long long)rhi[y] * w + clo[x]) * K;
  const float* p11 = img + ((long long)rhi[y] * w + chi[x]) * K;

  float best = -INFINITY;
  int arg = 0;
  for (int k = 0; k < K; ++k) {
    const float left = p00[k] * (1.0f - wy) + p10[k] * wy;
    const float right = p01[k] * (1.0f - wy) + p11[k] * wy;
    const float v = left * (1.0f - wx) + right * wx;
    if (v > best) {
      best = v;
      arg = k;
    }
  }
  out[idx] = (uint8_t)arg;
}

}  // namespace

// Returns a cudaError_t.
extern "C" int segland_upsample_argmax(const void* logits, const void* rlo,
                                       const void* rhi, const void* rw,
                                       const void* clo, const void* chi,
                                       const void* cw, void* out, int B, int h,
                                       int w, int K, int oh, int ow, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K < 1 || K > 255) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * oh * ow;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned grid = (unsigned)((total + threads - 1) / threads);
  upsample_argmax_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)logits, (const int*)rlo, (const int*)rhi, (const float*)rw,
      (const int*)clo, (const int*)chi, (const float*)cw, (uint8_t*)out, total, h, w,
      K, oh, ow);
  return (int)cudaGetLastError();
}
