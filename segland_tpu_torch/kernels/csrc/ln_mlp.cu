// Fused LayerNorm -> fc1 -> GELU -> fc2 -> layer-scale -> +residual over
// [M, C] rows (the ConvNeXt block's MLP section).
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
// activations, so the tensor cores bound it, and the weights, re-read by
// every block, are the traffic to keep on chip.
//
// Design: one block owns BM rows.  It normalises them into shared memory,
// then walks the hidden dimension in chunks of HC columns: each chunk of h
// is produced by WMMA (bf16 in, fp32 accumulate), passed through bias and
// GELU, stored as bf16 in shared memory, and immediately consumed by the
// second product, whose [BM, C] fp32 accumulator lives in registers split
// over the warps (a warp owns RS 16-row slabs and C/WC columns, so each w2
// fragment it loads feeds RS WMMA ops).  Each chunk's w1 columns and w2 rows
// are copied to shared memory by cp.async, so weights are read once per
// block, coalesced, instead of once per warp: into two buffers, the next
// chunk's copy in flight while this one computes, at C <= 384 (8 warps, RS
// 2, BM 128 and HC 64 at C=96, BM 64 and HC 32 at C=192 and 384); into one
// buffer at C=768, where two do not fit beside the normalised rows (BM 32,
// 16 warps, <= 48 accumulator registers a thread, HC 32).  A chunk of C=768
// has 4 hidden fragments for 16 warps, so each fragment's k-loop is split 4
// ways and the partial tiles are summed in shared memory.
// Rows past M are zero-filled on load and masked on store, so any M works.
// The fp32 path has no tensor-core form at fp32 precision and uses FMA loops.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
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
// round a float to T and back: the kernel's rounding points
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

// ---- bf16: WMMA tensor cores -------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// Second product: WR warps down the rows, each owning RS 16-row slabs, NW
// warps in all.  HC hidden columns per chunk, whose F1 first-product
// fragments are dealt round-robin over the warps; where a chunk has fewer
// fragments than warps, each fragment's k-loop is split KS ways instead.
// STAGES weight buffers (see the note at the top).
template <int C, int WR, int RS, int NW, int HC, int STAGES>
struct Bf16Cfg {
  static constexpr int BM = 16 * RS * WR;  // rows per block
  static constexpr int WC = NW / WR;       // warps across the C columns
  static constexpr int NF = C / 16 / WC;   // output fragments per warp and slab
  static constexpr int F1 = (BM / 16) * (HC / 16);  // hidden fragments per chunk
  static constexpr int KS = F1 < NW ? NW / F1 : 1;  // k-split of each of them
  static constexpr int LDY = C + 8;        // +8: rows start on other banks
  static constexpr int LDH = HC + 8;
  static constexpr int LDW1 = HC + 8;      // staged w1[:, chunk], [C, LDW1]
  static constexpr int LDW2 = C + 8;       // staged w2[chunk, :], [HC, LDW2]
  static constexpr size_t OFF_H = align128((size_t)BM * LDY * sizeof(bf16));
  static constexpr size_t OFF_S = OFF_H + align128((size_t)BM * LDH * sizeof(bf16));
  static constexpr size_t OFF_W = OFF_S + (size_t)NW * 256 * sizeof(float);
  static constexpr size_t W1_BYTES = align128((size_t)C * LDW1 * sizeof(bf16));
  static constexpr size_t BUF = W1_BYTES + align128((size_t)HC * LDW2 * sizeof(bf16));
  static constexpr size_t SMEM = OFF_W + STAGES * BUF;
  static_assert(C % (16 * WC) == 0, "C must split over the warp columns");
  static_assert(F1 % NW == 0 || NW % F1 == 0, "chunk must split over the warps");
  static_assert((C / 16) % KS == 0, "the first product's k must split KS ways");
  static_assert(STAGES == 1 || STAGES == 2, "one or two weight buffers");
};

template <typename Cfg, int C, int HC, int NW>
__device__ __forceinline__ void stage_chunk(unsigned char* buf, const bf16* __restrict__ w1,
                                            const bf16* __restrict__ w2, int j0, int H) {
  bf16* sw1 = reinterpret_cast<bf16*>(buf);
  bf16* sw2 = reinterpret_cast<bf16*>(buf + Cfg::W1_BYTES);
  constexpr int R1 = HC / 8, R2 = C / 8;  // 16-byte copies per row
  for (int i = threadIdx.x; i < C * R1; i += NW * 32) {
    const int r = i / R1, c = (i % R1) * 8;
    cp_async16(sw1 + r * Cfg::LDW1 + c, w1 + (size_t)r * H + j0 + c);
  }
  for (int i = threadIdx.x; i < HC * R2; i += NW * 32) {
    const int r = i / R2, c = (i % R2) * 8;
    cp_async16(sw2 + r * Cfg::LDW2 + c, w2 + (size_t)(j0 + r) * C + c);
  }
  cp_async_commit();
}

// h = T(gelu(T(T(acc) + T(b1)))): the first product's epilogue
__device__ __forceinline__ bf16 bias_gelu(float acc, float b) {
  const float h = rnd<bf16>(rnd<bf16>(acc) + rnd<bf16>(b));
  return __float2bfloat16(gelu_tanh(h));
}

template <int C, int WR, int RS, int NW, int HC, int STAGES>
__global__ void __launch_bounds__(NW * 32)
ln_mlp_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   const bf16* __restrict__ w1, const float* __restrict__ b1,
                   const bf16* __restrict__ w2, const float* __restrict__ b2,
                   const float* __restrict__ ls, bf16* __restrict__ out, long long M,
                   int H, float eps) {
  typedef Bf16Cfg<C, WR, RS, NW, HC, STAGES> Cfg;
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ys = reinterpret_cast<bf16*>(smem);                 // [BM, LDY]
  bf16* hb = reinterpret_cast<bf16*>(smem + Cfg::OFF_H);    // [BM, LDH]
  float* scratch = reinterpret_cast<float*>(smem + Cfg::OFF_S);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp % WR, wc = warp / WR;
  const long long row0 = (long long)blockIdx.x * Cfg::BM;
  float* scr = scratch + warp * 256;

  stage_chunk<Cfg, C, HC, NW>(smem + Cfg::OFF_W, w1, w2, 0, H);
  layer_norm_rows<bf16, C, Cfg::BM, NW>(x, M, row0, gamma, beta, eps, ys, Cfg::LDY);
  __syncthreads();

  FragC acc[RS][Cfg::NF];
#pragma unroll
  for (int s = 0; s < RS; ++s)
#pragma unroll
    for (int f = 0; f < Cfg::NF; ++f) wmma::fill_fragment(acc[s][f], 0.0f);

  const bf16* ha = hb + wr * RS * 16 * Cfg::LDH;
  for (int j0 = 0, jc = 0; j0 < H; j0 += HC, ++jc) {
    // this chunk's weights, in shared memory
    unsigned char* buf = smem + Cfg::OFF_W + (STAGES == 2 ? (jc & 1) : 0) * Cfg::BUF;
    if (STAGES == 1) {
      if (jc > 0) stage_chunk<Cfg, C, HC, NW>(buf, w1, w2, j0, H);
      cp_async_wait<0>();
    } else if (j0 + HC < H) {
      stage_chunk<Cfg, C, HC, NW>(smem + Cfg::OFF_W + ((jc + 1) & 1) * Cfg::BUF, w1, w2,
                                  j0 + HC, H);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sw1 = reinterpret_cast<const bf16*>(buf);
    const bf16* sw2 = reinterpret_cast<const bf16*>(buf + Cfg::W1_BYTES);

    // h[:, j0:j0+HC] = gelu(y @ w1[:, chunk] + b1)
    if constexpr (Cfg::KS > 1) {
      // one fragment and one k-range per warp; the partial tiles are summed
      // by the whole block
      const int f = warp % Cfg::F1, q = warp / Cfg::F1;
      const int slab = f % (Cfg::BM / 16), n = f / (Cfg::BM / 16) * 16;
      const bf16* ya = ys + slab * 16 * Cfg::LDY;
      constexpr int KC = C / Cfg::KS;
      FragC hacc;
      wmma::fill_fragment(hacc, 0.0f);
#pragma unroll 4
      for (int k = q * KC; k < (q + 1) * KC; k += 16) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, ya + k, Cfg::LDY);
        wmma::load_matrix_sync(b, sw1 + k * Cfg::LDW1 + n, Cfg::LDW1);
        wmma::mma_sync(hacc, a, b, hacc);
      }
      wmma::store_matrix_sync(scr, hacc, 16, wmma::mem_row_major);
      __syncthreads();
      for (int e = threadIdx.x; e < Cfg::F1 * 256; e += NW * 32) {
        const int ff = e / 256, i = e % 256;
        float sum = 0.0f;
#pragma unroll
        for (int p = 0; p < Cfg::KS; ++p) sum += scratch[(ff + Cfg::F1 * p) * 256 + i];
        const int sl = ff % (Cfg::BM / 16), nn = ff / (Cfg::BM / 16) * 16 + i % 16;
        hb[(sl * 16 + i / 16) * Cfg::LDH + nn] = bias_gelu(sum, b1[j0 + nn]);
      }
    } else {
      // whole fragments dealt round-robin, each through its warp's scratch tile
#pragma unroll
      for (int g = 0; g < Cfg::F1 / NW; ++g) {
        const int id = warp + NW * g;
        const int slab = id % (Cfg::BM / 16), n = id / (Cfg::BM / 16) * 16;
        const bf16* ya = ys + slab * 16 * Cfg::LDY;
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
#pragma unroll
    for (int k = 0; k < HC; k += 16) {
      FragA a[RS];
#pragma unroll
      for (int s = 0; s < RS; ++s) wmma::load_matrix_sync(a[s], ha + s * 16 * Cfg::LDH + k, Cfg::LDH);
#pragma unroll
      for (int f = 0; f < Cfg::NF; ++f) {
        FragB b;
        wmma::load_matrix_sync(b, sw2 + k * Cfg::LDW2 + (wc * Cfg::NF + f) * 16, Cfg::LDW2);
#pragma unroll
        for (int s = 0; s < RS; ++s) wmma::mma_sync(acc[s][f], a[s], b, acc[s][f]);
      }
    }
    __syncthreads();  // hb, scratch and this chunk's weight buffer are rewritten next
  }

  const bf16* r_src = res ? res : x;
#pragma unroll
  for (int sf = 0; sf < RS * Cfg::NF; ++sf) {
    const int s = sf / Cfg::NF, f = sf % Cfg::NF;
    const int col0 = (wc * Cfg::NF + f) * 16;
    wmma::store_matrix_sync(scr, acc[s][f], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const long long row = row0 + (wr * RS + s) * 16 + e / 16;
      const int col = col0 + e % 16;
      if (row < M) {
        float o = rnd<bf16>(scr[e]);
        o = rnd<bf16>(o + rnd<bf16>(b2[col]));
        if (ls) o = rnd<bf16>(o * rnd<bf16>(ls[col]));
        const size_t i = (size_t)row * C + col;
        out[i] = __float2bfloat16(to_f(r_src[i]) + o);
      }
    }
    __syncwarp();
  }
}

// ---- fp32: FMA loops -----------------------------------------------------
constexpr int kF32Rows = 16;

template <int C>
__global__ void __launch_bounds__(kThreads)
ln_mlp_f32_kernel(const float* __restrict__ x, const float* __restrict__ res,
                  const float* __restrict__ gamma, const float* __restrict__ beta,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  const float* __restrict__ ls, float* __restrict__ out, long long M,
                  int H, float eps) {
  constexpr int BM = kF32Rows;
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

template <int C, int WR, int RS, int NW, int HC, int STAGES>
cudaError_t launch_bf16(const void* x, const void* res, const float* gamma,
                        const float* beta, const void* w1, const float* b1,
                        const void* w2, const float* b2, const float* ls, void* out,
                        long long M, int H, float eps, cudaStream_t stream) {
  typedef Bf16Cfg<C, WR, RS, NW, HC, STAGES> Cfg;
  if (H % HC != 0) return cudaErrorInvalidValue;
  auto kernel = ln_mlp_bf16_kernel<C, WR, RS, NW, HC, STAGES>;
  cudaError_t err = allow_smem(kernel, Cfg::SMEM);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((M + Cfg::BM - 1) / Cfg::BM);
  kernel<<<grid, NW * 32, Cfg::SMEM, stream>>>(
      (const bf16*)x, (const bf16*)res, gamma, beta, (const bf16*)w1, b1,
      (const bf16*)w2, b2, ls, (bf16*)out, M, H, eps);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_f32(const void* x, const void* res, const float* gamma,
                       const float* beta, const void* w1, const float* b1,
                       const void* w2, const float* b2, const float* ls, void* out,
                       long long M, int H, float eps, cudaStream_t stream) {
  if (H % kHC != 0) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(kF32Rows * C + kF32Rows * kHC) * sizeof(float);
  auto kernel = ln_mlp_f32_kernel<C>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((M + kF32Rows - 1) / kF32Rows);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const float*)x, (const float*)res, gamma, beta, (const float*)w1, b1,
      (const float*)w2, b2, ls, (float*)out, M, H, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  res and ls may be null.  Returns a
// cudaError_t; cudaErrorInvalidValue for a C or H this build does not take.
extern "C" int segland_ln_mlp(int dtype, const void* x, const void* res,
                              const void* gamma, const void* beta, const void* w1,
                              const void* b1, const void* w2, const void* b2,
                              const void* ls, void* out, long long M, int C, int H,
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
#define SEGLAND_ARGS x, res, g, bt, w1, bb1, w2, bb2, l, out, M, H, eps, s
  if (dtype == 1) {
    switch (C) {
      // <C, WR, RS, NW, HC, STAGES>
      case 96: err = launch_bf16<96, 4, 2, 8, 64, 2>(SEGLAND_ARGS); break;
      case 192: err = launch_bf16<192, 2, 2, 8, 32, 2>(SEGLAND_ARGS); break;
      case 384: err = launch_bf16<384, 2, 2, 8, 32, 2>(SEGLAND_ARGS); break;
      case 768: err = launch_bf16<768, 2, 1, 16, 32, 1>(SEGLAND_ARGS); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (dtype == 0) {
    switch (C) {
      case 96: err = launch_f32<96>(SEGLAND_ARGS); break;
      case 192: err = launch_f32<192>(SEGLAND_ARGS); break;
      case 384: err = launch_f32<384>(SEGLAND_ARGS); break;
      case 768: err = launch_f32<768>(SEGLAND_ARGS); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef SEGLAND_ARGS
  return (int)err;
}

extern "C" const char* segland_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
