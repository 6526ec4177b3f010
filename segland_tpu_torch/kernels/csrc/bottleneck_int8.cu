// int8 ResNet bottleneck kernels: the whole eval-mode block in one launch
// (segland_bottleneck_int8) and its last stage alone, conv3 + residual
// (segland_conv3_residual_int8).
//
// Replaces: segland_tpu/ops/pallas_bottleneck.py:fused_bottleneck_int8 (body
// `_kernel`) and :conv3_residual_int8 (body `_conv3_kernel`).
//
//   xq  = clip(rint(x / s_x))                      x bf16 [B,H,W,C]
//   h1q = clip(rint(relu(xq.w1 * a1 + b1) / s_h1)) 1x1, [C,P]; 0 outside the image
//   h2q = clip(rint(relu(h1q*w2 * a2 + b2) / s_h2)) 3x3, dilation d, zero padded
//   out = bf16(relu?(h2q.w3 * a3 + b3 + x))        1x1, [P,C]; the residual is x itself
//
// Every product is int8 x int8 -> int32 on the tensor cores
// (mma.sync.m16n8k32.s8), so every sum is exact, and every fp32 step is the
// plain version's (ops/fused_bottleneck.py), in its order: multiply and add
// stay unfused, rounding is half-even, and the requantization takes the
// plain version's true quotient (see quant()).  The kernel therefore gives
// the plain version's bits.
//
// What bounds it on an H100: operations at resnet50's layer4 (C 2048, P 512:
// 1.17 TOP against 1.07 GB of input and output at 8 x 128^2 pixels), bytes
// at the narrower layers.
//
// Design.  The TPU kernel held th + 2d whole rows of the image and all three
// weight sets on chip; a block here has 227 KB of shared memory, where one
// row of layer4's x alone is 512 KB.  So a block owns a TH x TW tile of one image
// and works in three phases, the intermediates in shared memory:
//   1. conv1 over the tile's halo'd footprint, (TH+2d) x (TW+2d) pixels:
//      x streams from global memory 128 pixels x 64 channels at a time, is
//      quantized on the way into shared memory, and meets w1 chunks that
//      cp.async keeps in flight; h1q lands in shared memory as int8, zero
//      where the pixel lies outside the image (the 3x3 pads the activation,
//      and a zero x would give relu(b1) there).  The halo is recomputed by
//      every tile that shares it.
//   2. conv2: nine taps, each a product of a shifted view of h1q with one
//      [P,P] slice of w2; h2q lands in shared memory.
//   3. conv3 from h2q, with the residual read from x and the result written
//      as bf16, both straight from the accumulator registers.
// The tile is the largest of 16x16, 8x16, 8x8 whose h1q and h2q fit (layer4
// at d = 4 gets 8x8: 256 footprint pixels for 64 outputs).  Weights arrive
// transposed, [N][K] with K contiguous, which is the operand order of
// mma.sync's "col" B; a warp computes 32 x 64 (or 32 x 32) of a 128-row
// product, fragments loaded with ldmatrix from rows padded by 16 bytes.
// Any H and W are taken (tails are guarded); C and P must be multiples of 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;        // bytes of k in a staged chunk
constexpr int LDS = BK + 16;  // its row stride: ldmatrix rows fall in distinct banks
constexpr int THREADS = 256;  // 8 warps, 4 along M by 2 along N
constexpr int BSTAGES = 3;    // cp.async ring of weight chunks
constexpr int MAX_SMEM = 232448;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16x32 int8, row) . b (32x8 int8, col)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// clip(rint(v / s), -127, 127).  v * (1/s) differs from the true quotient by
// under 3e-5 wherever the result is not clipped, so the two round alike
// unless the product lies within 1e-3 of a tie; there the division decides.
__device__ __forceinline__ int quant(float v, float s, float inv) {
  const float t = __fmul_rn(v, inv);
  float r = rintf(t);
  if (fabsf(fabsf(t - r) - 0.5f) < 1e-3f) r = rintf(__fdiv_rn(v, s));
  return (int)fminf(fmaxf(r, -127.0f), 127.0f);
}

// relu(acc * a + b), multiply and add unfused as in the plain version
__device__ __forceinline__ float affine_relu(int acc, float a, float b) {
  return fmaxf(__fadd_rn(__fmul_rn((float)acc, a), b), 0.0f);
}

// this lane's ldmatrix row within a 16-row A tile and its k offset
__device__ __forceinline__ int a_lane_row(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int a_lane_k(int lane) { return (lane >> 4) * 16; }
// the same within a pair of 8-column B tiles stored [n][k]
__device__ __forceinline__ int b_lane_row(int lane) { return (lane & 7) + (lane >> 4) * 8; }
__device__ __forceinline__ int b_lane_k(int lane) { return ((lane >> 3) & 1) * 16; }

// One 64-byte k chunk of a warp's MT x NT tiles.  a_lane[i]: this lane's
// ldmatrix row of m-tile i at the chunk's k = 0; b_lane: the same of the
// warp's first pair of n-tiles in a staged chunk (row stride LDS).
template <int MT, int NT>
__device__ __forceinline__ void warp_mma_chunk(int (&acc)[MT][NT][4],
                                               const int8_t* const (&a_lane)[MT],
                                               const int8_t* b_lane) {
#pragma unroll
  for (int ks = 0; ks < BK; ks += 32) {
    uint32_t a[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) ldmatrix_x4(a[i], a_lane[i] + ks);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, b_lane + j * 8 * LDS + ks);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_s8(acc[i][j], a[i], b[0], b[1]);
        mma_s8(acc[i][j + 1], a[i], b[2], b[3]);
      }
    }
  }
}

// NB rows of 64 bytes from a [n][k] weight (row stride ldb) into a stage
template <int NB>
__device__ __forceinline__ void load_b_chunk(int8_t* stage, const int8_t* src, int ldb, int tid) {
  for (int i = tid; i < NB * 4; i += THREADS) {
    const int r = i >> 2, s = i & 3;
    cp_async16(stage + r * LDS + s * 16, src + (size_t)r * ldb + s * 16);
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(int (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
}

// A product whose A operand already lies in shared memory.  a_row(i, kc):
// this lane's ldmatrix row of m-tile i for chunk kc; b_chunk(kc): where the
// chunk's 16*NT weight rows start in global memory.
template <int MT, int NT, class AFn, class BFn>
__device__ __forceinline__ void gemm_smem_a(int (&acc)[MT][NT][4], int nk, AFn a_row, BFn b_chunk,
                                            int ldb, int8_t* Bs, int tid, int b_lane) {
  constexpr int NB = 16 * NT;
  __syncthreads();  // every warp is done with the ring and sees what the last product stored
#pragma unroll
  for (int s = 0; s < BSTAGES - 1; ++s) {
    if (s < nk) load_b_chunk<NB>(Bs + s * NB * LDS, b_chunk(s), ldb, tid);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<BSTAGES - 2>();
    __syncthreads();
    const int nx = kc + BSTAGES - 1;
    if (nx < nk) load_b_chunk<NB>(Bs + (nx % BSTAGES) * NB * LDS, b_chunk(nx), ldb, tid);
    cp_async_commit();
    const int8_t* a[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) a[i] = a_row(i, kc);
    warp_mma_chunk<MT, NT>(acc, a, Bs + (kc % BSTAGES) * NB * LDS + b_lane);
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// conv3 + residual: out[M,C] = bf16(relu?(h2q[M,P] . w3 * a3 + b3 + res))
// ---------------------------------------------------------------------------
template <int NT>
__global__ void __launch_bounds__(THREADS)
conv3_residual_kernel(const int8_t* __restrict__ h2q, const __nv_bfloat16* __restrict__ res,
                      const int8_t* __restrict__ w3t, const float* __restrict__ a3,
                      const float* __restrict__ b3, __nv_bfloat16* __restrict__ out, long long M,
                      int P, int C, int relu) {
  constexpr int NB = 16 * NT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* As = reinterpret_cast<int8_t*>(smem_raw);  // BSTAGES x 128 x LDS
  int8_t* Bs = As + BSTAGES * 128 * LDS;             // BSTAGES x NB x LDS
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, tig = lane & 3;
  const int n_chunks = C / NB;  // the column chunk runs fastest: neighbours share rows of h2q
  const long long m0 = (long long)(blockIdx.x / n_chunks) * 128;
  const int n0 = (int)(blockIdx.x % n_chunks) * NB;
  const int nk = P / BK;

  auto load = [&](int kc, int st) {
    for (int i = tid; i < 128 * 4; i += THREADS) {
      const int r = i >> 2, s = i & 3;
      long long row = m0 + r;
      if (row >= M) row = M - 1;  // a tail row computes on the last row and is never stored
      cp_async16(As + (st * 128 + r) * LDS + s * 16, h2q + row * P + kc * BK + s * 16);
    }
    load_b_chunk<NB>(Bs + st * NB * LDS, w3t + (size_t)n0 * P + kc * BK, P, tid);
  };

  int acc[2][NT][4];
  zero_acc<2, NT>(acc);
#pragma unroll
  for (int s = 0; s < BSTAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  const int a_off = (wm * 32 + a_lane_row(lane)) * LDS + a_lane_k(lane);
  const int b_off = (wn * NT * 8 + b_lane_row(lane)) * LDS + b_lane_k(lane);
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<BSTAGES - 2>();
    __syncthreads();
    const int nx = kc + BSTAGES - 1;
    if (nx < nk) load(nx, nx % BSTAGES);
    cp_async_commit();
    const int st = kc % BSTAGES;
    const int8_t* a[2] = {As + st * 128 * LDS + a_off, As + st * 128 * LDS + a_off + 16 * LDS};
    warp_mma_chunk<2, NT>(acc, a, Bs + st * NB * LDS + b_off);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + wm * 32 + i * 16 + g + h * 8;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + wn * NT * 8 + j * 8 + tig * 2;
        const float2 a = *reinterpret_cast<const float2*>(a3 + col);
        const float2 b = *reinterpret_cast<const float2*>(b3 + col);
        const float2 r = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(res + row * C + col));
        float o0 = __fadd_rn(__fadd_rn(__fmul_rn((float)acc[i][j][2 * h], a.x), b.x), r.x);
        float o1 = __fadd_rn(__fadd_rn(__fmul_rn((float)acc[i][j][2 * h + 1], a.y), b.y), r.y);
        if (relu) {
          o0 = fmaxf(o0, 0.0f);
          o1 = fmaxf(o1, 0.0f);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + row * C + col) = __floats2bfloat162_rn(o0, o1);
      }
    }
}

// ---------------------------------------------------------------------------
// the whole bottleneck
// ---------------------------------------------------------------------------
struct BottleneckArgs {
  const __nv_bfloat16* x;
  const int8_t *w1t, *w2t, *w3t;  // [P][C], [9][P][P] (tap, out, in), [C][P]
  const float *a1, *b1, *a2, *b2, *a3, *b3;
  __nv_bfloat16* out;
  int B, H, W, C, P, d, relu, TH, TW, tiles_y, tiles_x;
  float s_x, s_h1, s_h2;
};

__device__ __forceinline__ uint32_t quant4(uint32_t lo, uint32_t hi, float s, float inv) {
  // four bf16 (two a word, the lower address in the low half) -> four int8
  const int q0 = quant(__uint_as_float(lo << 16), s, inv);
  const int q1 = quant(__uint_as_float(lo & 0xffff0000u), s, inv);
  const int q2 = quant(__uint_as_float(hi << 16), s, inv);
  const int q3 = quant(__uint_as_float(hi & 0xffff0000u), s, inv);
  return (uint32_t)(q0 & 0xff) | ((uint32_t)(q1 & 0xff) << 8) | ((uint32_t)(q2 & 0xff) << 16) |
         ((uint32_t)(q3 & 0xff) << 24);
}

// NT: n-tiles a warp in every product (block columns 16*NT); MT2: m-tiles a
// warp in conv2 and conv3 (block rows 64*MT2, which divides TH*TW)
template <int NT, int MT2>
__global__ void __launch_bounds__(THREADS) bottleneck_kernel(const BottleneckArgs p) {
  constexpr int NB = 16 * NT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, tig = lane & 3;
  const int C = p.C, P = p.P, d = p.d, TW = p.TW, TP = p.TH * p.TW;
  const int WP = TW + 2 * d, HP = (p.TH + 2 * d) * WP, LDH = P + 16;
  const int r2_bytes = max(2 * 128 * LDS, TP * LDH);
  int8_t* h1q = reinterpret_cast<int8_t*>(smem_raw);  // [HP][LDH]
  int8_t* h2q = h1q + (size_t)HP * LDH;               // [TP][LDH]; conv1 stages x here first
  int8_t* As = h2q;                                   // 2 x 128 x LDS
  int8_t* Bs = h2q + r2_bytes;                        // BSTAGES x NB x LDS

  int bid = blockIdx.x;
  const int tx0 = (bid % p.tiles_x) * TW;
  bid /= p.tiles_x;
  const int ty0 = (bid % p.tiles_y) * p.TH;
  const int img = bid / p.tiles_y;
  const __nv_bfloat16* ximg = p.x + (size_t)img * p.H * p.W * C;
  const int b_lane = (wn * NT * 8 + b_lane_row(lane)) * LDS + b_lane_k(lane);
  const int arow = a_lane_row(lane), akof = a_lane_k(lane);
  const float inv_x = __fdiv_rn(1.0f, p.s_x), inv_h1 = __fdiv_rn(1.0f, p.s_h1),
              inv_h2 = __fdiv_rn(1.0f, p.s_h2);

  // ---- phase 1: h1q over the halo'd footprint, 128 pixels at a time ----
  for (int mc = 0; mc < HP; mc += 128) {
    // the four rows of the x chunk this thread stages (8 channels of each)
    const int seg = tid & 7;
    const __nv_bfloat16* xrow[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int hp = mc + (tid >> 3) + i * 32;
      xrow[i] = nullptr;
      if (hp < HP) {
        const int hy = hp / WP, gy = ty0 - d + hy, gx = tx0 - d + (hp - hy * WP);
        if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W)
          xrow[i] = ximg + ((size_t)gy * p.W + gx) * C + seg * 8;
      }
    }
    // the rows this thread's accumulators hold, and whether they lie in the image
    int hp_of[2][2];
    bool inside[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int hp = mc + wm * 32 + i * 16 + g + h * 8;
        const int hy = hp / WP, gy = ty0 - d + hy, gx = tx0 - d + (hp - hy * WP);
        hp_of[i][h] = hp;
        inside[i][h] = hp < HP && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
      }

    for (int nc = 0; nc < P; nc += NB) {
      const int nk = C / BK;
      uint4 regs[4];
      auto gload = [&](int kc) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          regs[i] = xrow[i] ? __ldg(reinterpret_cast<const uint4*>(xrow[i] + kc * BK))
                            : make_uint4(0u, 0u, 0u, 0u);
      };
      auto qstore = [&](int st) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint2 q;
          q.x = quant4(regs[i].x, regs[i].y, p.s_x, inv_x);
          q.y = quant4(regs[i].z, regs[i].w, p.s_x, inv_x);
          *reinterpret_cast<uint2*>(As + (st * 128 + (tid >> 3) + i * 32) * LDS + seg * 8) = q;
        }
      };
      int acc[2][NT][4];
      zero_acc<2, NT>(acc);
      gload(0);
      __syncthreads();  // every warp is done with the stages of the last product
      qstore(0);
#pragma unroll
      for (int s = 0; s < BSTAGES - 1; ++s) {
        if (s < nk) load_b_chunk<NB>(Bs + s * NB * LDS, p.w1t + (size_t)nc * C + s * BK, C, tid);
        cp_async_commit();
      }
      for (int kc = 0; kc < nk; ++kc) {
        if (kc + 1 < nk) gload(kc + 1);  // in flight while this chunk is multiplied
        cp_async_wait<BSTAGES - 2>();
        __syncthreads();
        const int nx = kc + BSTAGES - 1;
        if (nx < nk)
          load_b_chunk<NB>(Bs + (nx % BSTAGES) * NB * LDS, p.w1t + (size_t)nc * C + nx * BK, C,
                           tid);
        cp_async_commit();
        const int8_t* abase = As + ((kc & 1) * 128 + wm * 32 + arow) * LDS + akof;
        const int8_t* a[2] = {abase, abase + 16 * LDS};
        warp_mma_chunk<2, NT>(acc, a, Bs + (kc % BSTAGES) * NB * LDS + b_lane);
        if (kc + 1 < nk) qstore((kc + 1) & 1);
      }
      cp_async_wait<0>();
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (hp_of[i][h] >= HP) continue;
          int8_t* dst = h1q + (size_t)hp_of[i][h] * LDH;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int col = nc + wn * NT * 8 + j * 8 + tig * 2;
            uint16_t v = 0;
            if (inside[i][h]) {
              const float2 a = *reinterpret_cast<const float2*>(p.a1 + col);
              const float2 b = *reinterpret_cast<const float2*>(p.b1 + col);
              const int q0 = quant(affine_relu(acc[i][j][2 * h], a.x, b.x), p.s_h1, inv_h1);
              const int q1 = quant(affine_relu(acc[i][j][2 * h + 1], a.y, b.y), p.s_h1, inv_h1);
              v = (uint16_t)((q0 & 0xff) | ((q1 & 0xff) << 8));
            }
            *reinterpret_cast<uint16_t*>(dst + col) = v;
          }
        }
    }
  }

  // ---- phase 2: h2q = requant(relu(conv3x3(h1q) * a2 + b2)) ----
  const int kpt = P / BK;  // chunks a tap
  for (int mc = 0; mc < TP; mc += 64 * MT2) {
    int a_pix[MT2];  // this lane's ldmatrix row of each m-tile, as an offset into h1q at tap (0, 0)
#pragma unroll
    for (int i = 0; i < MT2; ++i) {
      const int r = mc + wm * 16 * MT2 + i * 16 + arow;
      a_pix[i] = ((r / TW) * WP + r % TW) * LDH + akof;
    }
    for (int nc = 0; nc < P; nc += NB) {
      int acc[MT2][NT][4];
      zero_acc<MT2, NT>(acc);
      gemm_smem_a<MT2, NT>(
          acc, 9 * kpt,
          [&](int i, int kc) {
            const int tap = kc / kpt;
            return h1q + a_pix[i] + ((tap / 3) * d * WP + (tap % 3) * d) * LDH + (kc % kpt) * BK;
          },
          [&](int kc) {
            return p.w2t + ((size_t)(kc / kpt) * P + nc) * P + (kc % kpt) * BK;
          },
          P, Bs, tid, b_lane);
#pragma unroll
      for (int i = 0; i < MT2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int8_t* dst = h2q + (size_t)(mc + wm * 16 * MT2 + i * 16 + g + h * 8) * LDH;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int col = nc + wn * NT * 8 + j * 8 + tig * 2;
            const float2 a = *reinterpret_cast<const float2*>(p.a2 + col);
            const float2 b = *reinterpret_cast<const float2*>(p.b2 + col);
            const int q0 = quant(affine_relu(acc[i][j][2 * h], a.x, b.x), p.s_h2, inv_h2);
            const int q1 = quant(affine_relu(acc[i][j][2 * h + 1], a.y, b.y), p.s_h2, inv_h2);
            *reinterpret_cast<uint16_t*>(dst + col) = (uint16_t)((q0 & 0xff) | ((q1 & 0xff) << 8));
          }
        }
    }
  }

  // ---- phase 3: out = bf16(relu?(conv1x1(h2q) * a3 + b3 + x)) ----
  for (int mc = 0; mc < TP; mc += 64 * MT2) {
    for (int nc = 0; nc < C; nc += NB) {
      int acc[MT2][NT][4];
      zero_acc<MT2, NT>(acc);
      gemm_smem_a<MT2, NT>(
          acc, kpt,
          [&](int i, int kc) {
            return h2q + (size_t)(mc + wm * 16 * MT2 + i * 16 + arow) * LDH + akof + kc * BK;
          },
          [&](int kc) { return p.w3t + (size_t)nc * P + kc * BK; }, P, Bs, tid, b_lane);
#pragma unroll
      for (int i = 0; i < MT2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mc + wm * 16 * MT2 + i * 16 + g + h * 8;
          const int gy = ty0 + r / TW, gx = tx0 + r % TW;
          if (gy >= p.H || gx >= p.W) continue;
          const size_t off = ((size_t)gy * p.W + gx) * C;
          const __nv_bfloat16* res = ximg + off;
          __nv_bfloat16* dst = p.out + (size_t)img * p.H * p.W * C + off;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int col = nc + wn * NT * 8 + j * 8 + tig * 2;
            const float2 a = *reinterpret_cast<const float2*>(p.a3 + col);
            const float2 b = *reinterpret_cast<const float2*>(p.b3 + col);
            const float2 x2 =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + col));
            float o0 = __fadd_rn(__fadd_rn(__fmul_rn((float)acc[i][j][2 * h], a.x), b.x), x2.x);
            float o1 =
                __fadd_rn(__fadd_rn(__fmul_rn((float)acc[i][j][2 * h + 1], a.y), b.y), x2.y);
            if (p.relu) {
              o0 = fmaxf(o0, 0.0f);
              o1 = fmaxf(o1, 0.0f);
            }
            *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(o0, o1);
          }
        }
    }
  }
}

size_t bottleneck_smem(int th, int tw, int d, int P, int nb) {
  const size_t hp = (size_t)(th + 2 * d) * (tw + 2 * d), ldh = P + 16;
  const size_t r2 = (size_t)th * tw * ldh;
  return hp * ldh + (r2 > 2 * 128 * LDS ? r2 : 2 * 128 * LDS) + (size_t)BSTAGES * nb * LDS;
}

int columns_a_warp(int C, int P) { return (P % 128 == 0 && C % 128 == 0) ? 8 : 4; }

// the largest tile whose h1q and h2q fit a block's shared memory
bool pick_tile(int C, int P, int d, int* th, int* tw, size_t* smem) {
  const int cand[3][2] = {{16, 16}, {8, 16}, {8, 8}};
  const int nb = 16 * columns_a_warp(C, P);
  for (const auto& c : cand) {
    const size_t need = bottleneck_smem(c[0], c[1], d, P, nb);
    if (need <= (size_t)MAX_SMEM) {
      *th = c[0];
      *tw = c[1];
      *smem = need;
      return true;
    }
  }
  return false;
}

template <class K>
cudaError_t opt_in(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// The tile a bottleneck of these widths gets and the shared memory it
// takes; 0 when none fits.
extern "C" int segland_bottleneck_int8_tile(int C, int P, int d, int* th, int* tw, int* smem) {
  size_t need = 0;
  if (P < 64 || P % 64 || C < 64 || C % 64 || d < 1 || !pick_tile(C, P, d, th, tw, &need))
    return 0;
  *smem = (int)need;
  return 1;
}

// Returns a cudaError_t.  w1t [P][C], w2t [9][P][P] (tap, out, in), w3t [C][P].
extern "C" int segland_bottleneck_int8(const void* x, const void* w1t, const void* w2t,
                                       const void* w3t, const void* a1, const void* b1,
                                       const void* a2, const void* b2, const void* a3,
                                       const void* b3, void* out, int B, int H, int W, int C,
                                       int P, int d, int relu, float s_x, float s_h1, float s_h2,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int th = 0, tw = 0;
  size_t smem = 0;
  if (P < 64 || P % 64 || C < 64 || C % 64 || d < 1 || !pick_tile(C, P, d, &th, &tw, &smem))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H * W == 0) return (int)cudaSuccess;
  BottleneckArgs a;
  a.x = (const __nv_bfloat16*)x;
  a.w1t = (const int8_t*)w1t;
  a.w2t = (const int8_t*)w2t;
  a.w3t = (const int8_t*)w3t;
  a.a1 = (const float*)a1;
  a.b1 = (const float*)b1;
  a.a2 = (const float*)a2;
  a.b2 = (const float*)b2;
  a.a3 = (const float*)a3;
  a.b3 = (const float*)b3;
  a.out = (__nv_bfloat16*)out;
  a.B = B; a.H = H; a.W = W; a.C = C; a.P = P; a.d = d; a.relu = relu;
  a.TH = th; a.TW = tw;
  a.tiles_y = (H + th - 1) / th;
  a.tiles_x = (W + tw - 1) / tw;
  a.s_x = s_x; a.s_h1 = s_h1; a.s_h2 = s_h2;
  const long long blocks = (long long)B * a.tiles_y * a.tiles_x;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool wide = columns_a_warp(C, P) == 8, two = (th * tw) % 128 == 0;
  auto launch = [&](auto kernel) {
    cudaError_t e = opt_in(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(a);
    return cudaGetLastError();
  };
  if (wide && two) return (int)launch(bottleneck_kernel<8, 2>);
  if (wide) return (int)launch(bottleneck_kernel<8, 1>);
  if (two) return (int)launch(bottleneck_kernel<4, 2>);
  return (int)launch(bottleneck_kernel<4, 1>);
}

// Returns a cudaError_t.  h2q [M][P] int8, res and out [M][C] bf16, w3t [C][P].
extern "C" int segland_conv3_residual_int8(const void* h2q, const void* res, const void* w3t,
                                           const void* a3, const void* b3, void* out,
                                           long long M, int P, int C, int relu, int device,
                                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (P < 64 || P % 64 || C < 64 || C % 64) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  const bool wide = C % 128 == 0;
  const int nb = wide ? 128 : 64;
  const long long blocks = ((M + 127) / 128) * (C / nb);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)BSTAGES * (128 + nb) * LDS;
  auto launch = [&](auto kernel) {
    cudaError_t e = opt_in(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
        (const int8_t*)h2q, (const __nv_bfloat16*)res, (const int8_t*)w3t, (const float*)a3,
        (const float*)b3, (__nv_bfloat16*)out, M, P, C, relu);
    return cudaGetLastError();
  };
  return (int)(wide ? launch(conv3_residual_kernel<8>) : launch(conv3_residual_kernel<4>));
}
