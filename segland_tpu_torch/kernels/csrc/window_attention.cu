// Swin window attention: the core between the qkv product and the projection.
//
// Replaces: segland_tpu/ops/pallas_attn.py:window_attention_fused (body
// `_attn_kernel`) as `segland_window_attention`.
//
//   qkv  [NW, 49, 3C]  q heads | k heads | v heads, heads of 32; bf16 or fp32
//   bias [nW_img or 1, nh, 49, 49], bf16 or fp32; window w uses bias[w % nW_img]
//   s    = (q . k) * 32^-0.5 + bias            fp32
//   p    = T(softmax(s))                       fp32, rounded to qkv's dtype T
//   out  = T(p @ v)   [NW, 49, C]              fp32 accumulate, rounded once
//
// What bounds it on an H100: bytes.  At swin-s stage 2 of a batch of 8 1024^2
// tiles (800 windows, C = 384) it reads 90 MB of qkv and writes 30 MB of
// context: 36 us at 3.35 TB/s, against 2.95 GFLOP of products (3 us on the
// tensor cores).  So the design keeps loads in flight while it computes.
//
// Design of the bf16 ring body (window_attention_ring_kernel):
//  - A persistent grid of blocks of 4 warps, as many as fit on the card
//    (3 a SM with a bf16 bias, 2 with fp32) rounded down to a multiple of nh.
//    Each block walks work items (window, head), item i = block, + grid, ...;
//    items run head-fastest, then batch image, then window of the image, so
//    the items in flight on the card share their bias slices (read from L2).
//  - A ring of kRingStages stages filled by cp.async: q, k and v of an item
//    (3 x 64 rows of 64 bytes, 16-byte chunks XOR-swizzled so ldmatrix reads
//    hit distinct banks; rows 49-63 stay zero) and the item's bias slice.
//    Three items are in flight while the fourth computes.
//  - The bias is read in its own dtype.  A (window, head) slice of a bf16
//    bias is 4,802 bytes with a row stride of 98: neither 16-byte aligned nor
//    a multiple of 16, so TMA and 16-byte loads cannot take it; it is copied
//    4 bytes at a time from the aligned word at or before its start (the
//    offset, 0 or 2 bytes, is applied when it is read), and the word past the
//    tensor's end, where there is one, is copied by a 2-byte load.  A stage
//    copies a slice only when it does not hold it already: with a shared bias
//    (nW_img = 1) every item of a block has the same head, so each stage
//    copies its slice once and keeps it for the whole run.
//  - The core, one warp for each 16 query rows (49 padded to 64): S = Q K^T by
//    mma.sync m16n8k16 (bf16 in, fp32 accumulate) on ldmatrix fragments, 7
//    key tiles of 8 (keys 49-55 masked, 56-63 skipped); the softmax in
//    registers with quad shuffles; P rounded to bf16 in registers, where the
//    accumulators of two key tiles are the A fragment of one k16 step of the
//    PV product (no shared-memory strip); PV by mma.sync with V fragments from
//    ldmatrix.trans (the fragment helpers are mma_sync.cuh's, which K9's and
//    K11's section core shares).
//  - A warp's 16 context rows go through its own (consumed) q rows in the
//    stage and out as 16-byte stores, 64 bytes a row.
// It serves bf16 qkv at every width.  The fp32 body
// (window_attention_f32_kernel, exact FMA loops) is checked for correctness
// and serves no default.

#include "attn_common.cuh"
#include "mma_sync.cuh"

namespace {

constexpr int kRingThreads = 128;  // 4 warps: one a 16-row query tile
constexpr int kRingStages = 4;     // items a block holds: 3 in flight, 1 computing
constexpr int kTileBytes = 64 * kHD * 2;  // 64 rows of 64 bytes
constexpr int kQkvBytes = 3 * kTileBytes;
constexpr float kScale = 0.17677669529663687f;  // 32^-0.5

// A stage: q, k, v, then the bias slice with up to 2 bytes before its start
// and 2 after, to 16 bytes.  ops/fused_attn.py:window_attention_plan mirrors it.
template <typename BT>
__host__ __device__ constexpr int bias_bytes() {
  return (int)((kN * kN * sizeof(BT) + 4 + 15) / 16 * 16);
}
template <typename BT>
__host__ __device__ constexpr int stage_bytes() {
  return kQkvBytes + bias_bytes<BT>();
}
template <typename BT>
__host__ __device__ constexpr int ring_smem() {
  return kRingStages * stage_bytes<BT>();
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// Where item `it` lives: its window, head and bias slice.
struct Item {
  long long w, slice;
  int h;
};
__device__ __forceinline__ Item item_of(long long it, int nh, int nw_img, long long nb) {
  const int h = (int)(it % nh);
  const long long j = it / nh;
  const long long p = j / nb;  // window of the image: the bias slice's
  return {(j % nb) * nw_img + p, p * nh + h, h};
}

// Start the copies of item `it` into stage `st`; `held` is the bias slice the
// stage holds (every thread keeps the same copy of it).  One commit group an
// item, empty past the last.
template <typename BT>
__device__ __forceinline__ void issue_item(long long it, long long items, unsigned char* st,
                                           long long& held, const bf16* __restrict__ qkv,
                                           const BT* __restrict__ bias, int C, int nh, int nw_img,
                                           long long nb) {
  if (it < items) {
    const Item t = item_of(it, nh, nw_img, nb);
    const bf16* src = qkv + (size_t)t.w * kN * 3 * C + t.h * kHD;
    for (int i = threadIdx.x; i < 3 * kN * 4; i += kRingThreads) {
      const int which = i / (kN * 4), r = (i >> 2) % kN, ch = i & 3;
      cp_async16(st + which * kTileBytes + qkv_off(r, ch),
                 src + (size_t)r * 3 * C + which * C + ch * 8);
    }
    if (t.slice != held) {
      held = t.slice;
      const uintptr_t b0 = (uintptr_t)(bias + (size_t)t.slice * kN * kN);
      const uintptr_t a0 = b0 & ~(uintptr_t)3;
      const uintptr_t end = (uintptr_t)(bias + (size_t)nw_img * nh * kN * kN);
      const int words = (int)((b0 + kN * kN * sizeof(BT) - a0 + 3) / 4);
      const int whole = a0 + 4 * (uintptr_t)words > end ? words - 1 : words;
      unsigned char* dst = st + kQkvBytes;
      for (int i = threadIdx.x; i < whole; i += kRingThreads)
        cp_async4(dst + 4 * i, (const void*)(a0 + 4 * i));
      if (whole < words && threadIdx.x == 0)  // the last 2 bytes of the tensor
        *reinterpret_cast<uint16_t*>(dst + 4 * whole) =
            *reinterpret_cast<const uint16_t*>(a0 + 4 * whole);
    }
  }
  cp_async_commit();
}

// One warp: query rows 16 * warp .. + 15 of the item in stage `st`.
template <typename BT>
__device__ __forceinline__ void attend(unsigned char* st, const BT* bsl, bf16* __restrict__ sink,
                                       int C) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;
  const uint32_t sq = smem_addr(st), sk = sq + kTileBytes, sv = sq + 2 * kTileBytes;

  uint32_t qa[2][4];
  {
    const int r = row0 + (lane & 7) + (lane & 8);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) ldsm_x4(qa[kk], sq + qkv_off(r, 2 * kk + (lane >> 4)));
  }
  float s[7][4];
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    uint32_t kb[4];
    ldsm_x4(kb, sk + qkv_off(8 * j + (lane & 7), lane >> 3));
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    mma_bf16(s[j], qa[0], kb[0], kb[1]);
    mma_bf16(s[j], qa[1], kb[2], kb[3]);
  }

  // scores, softmax over the 49 keys; this thread holds rows ra and ra + 8,
  // keys 8j + 2t and 8j + 2t + 1
  const int ra = row0 + g;
  float inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = ra + 8 * hf;
    const bool live = r < kN;
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < 7; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        float v = -INFINITY;
        if (j < 6 || c < kN) v = s[j][2 * hf + e] * kScale + (live ? to_f32(bsl[r * kN + c]) : 0.0f);
        s[j][2 * hf + e] = v;
        m = fmaxf(m, v);
      }
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 7; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = __expf(s[j][2 * hf + e] - m);
        s[j][2 * hf + e] = p;
        sum += p;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[hf] = 1.0f / sum;
  }

  // P as the A fragments of the PV product: k16 step kk is key tiles 2kk and
  // 2kk + 1 (tile 7, keys 56-63, is zero)
  uint32_t pa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int j0 = 2 * kk, j1 = 2 * kk + 1;
    pa[kk][0] = pack2(s[j0][0] * inv[0], s[j0][1] * inv[0]);
    pa[kk][1] = pack2(s[j0][2] * inv[1], s[j0][3] * inv[1]);
    pa[kk][2] = j1 < 7 ? pack2(s[j1][0] * inv[0], s[j1][1] * inv[0]) : 0u;
    pa[kk][3] = j1 < 7 ? pack2(s[j1][2] * inv[1], s[j1][3] * inv[1]) : 0u;
  }
  float o[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int jn = 0; jn < 2; ++jn) {
      uint32_t vb[4];
      ldsm_x4_t(vb, sv + qkv_off(16 * kk + (lane & 7) + (lane & 8), 2 * jn + (lane >> 4)));
      mma_bf16(o[2 * jn], pa[kk], vb[0], vb[1]);
      mma_bf16(o[2 * jn + 1], pa[kk], vb[2], vb[3]);
    }
  }

  // the context rows over this warp's q rows, then 16 bytes a lane
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = ra + 8 * hf;
    if (r < kN) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
        *reinterpret_cast<uint32_t*>(st + qkv_off(r, n) + 4 * t) =
            pack2(o[n][2 * hf], o[n][2 * hf + 1]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = lane + 32 * i, r = row0 + (idx >> 2), ch = idx & 3;
    if (r < kN)
      *reinterpret_cast<uint4*>(sink + (size_t)r * C + ch * 8) =
          *reinterpret_cast<const uint4*>(st + qkv_off(r, ch));
  }
}

template <typename BT>
__global__ void __launch_bounds__(kRingThreads)
window_attention_ring_kernel(const bf16* __restrict__ qkv, const BT* __restrict__ bias,
                             bf16* __restrict__ out, long long items, int C, int nh, int nw_img,
                             long long nb) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int SB = stage_bytes<BT>();
  // rows 49-63 of every stage's q, k and v: zero, and never written again
  for (int i = threadIdx.x; i < kRingStages * 3 * (64 - kN) * 4; i += kRingThreads) {
    const int s = i / (3 * (64 - kN) * 4), rem = i % (3 * (64 - kN) * 4);
    const int which = rem / ((64 - kN) * 4), r = kN + (rem >> 2) % (64 - kN), ch = rem & 3;
    *reinterpret_cast<uint4*>(smem + s * SB + which * kTileBytes + qkv_off(r, ch)) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  const long long step = gridDim.x;
  // held[j]: the bias slice of stage (stage + j) % S, rotated with the ring
  long long held[kRingStages];
#pragma unroll
  for (int s = 0; s < kRingStages; ++s) held[s] = -1;
#pragma unroll
  for (int s = 0; s < kRingStages - 1; ++s)
    issue_item<BT>(blockIdx.x + s * step, items, smem + s * SB, held[s], qkv, bias, C, nh, nw_img,
                   nb);
  int stage = 0;
  for (long long it = blockIdx.x; it < items; it += step) {
    const int ahead = stage == 0 ? kRingStages - 1 : stage - 1;
    issue_item<BT>(it + (kRingStages - 1) * step, items, smem + ahead * SB,
                   held[kRingStages - 1], qkv, bias, C, nh, nw_img, nb);
    cp_async_wait<kRingStages - 1>();
    __syncthreads();
    const Item t = item_of(it, nh, nw_img, nb);
    unsigned char* st = smem + stage * SB;
    const uintptr_t b0 = (uintptr_t)(bias + (size_t)t.slice * kN * kN);
    attend<BT>(st, reinterpret_cast<const BT*>(st + kQkvBytes + (b0 & 3)),
               out + (size_t)t.w * kN * C + t.h * kHD, C);
    __syncthreads();
    const long long h0 = held[0];
#pragma unroll
    for (int s = 0; s < kRingStages - 1; ++s) held[s] = held[s + 1];
    held[kRingStages - 1] = h0;
    stage = stage == kRingStages - 1 ? 0 : stage + 1;
  }
  cp_async_wait<0>();
}

// ---- fp32: exact FMA loops --------------------------------------------------
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

// The ring body's occupancy on the card: SMs and blocks a SM, asked once (the
// port drives one card), with the dynamic shared memory set beforehand.
struct Occupancy {
  cudaError_t err;
  int sms, per_sm;
};
template <typename BT>
Occupancy ring_occupancy() {
  auto kernel = window_attention_ring_kernel<BT>;
  Occupancy o = {cudaSuccess, 0, 0};
  int dev = 0;
  o.err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ring_smem<BT>());
  if (o.err == cudaSuccess) o.err = cudaGetDevice(&dev);
  if (o.err == cudaSuccess)
    o.err = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, dev);
  if (o.err == cudaSuccess)
    o.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.per_sm, kernel, kRingThreads,
                                                          ring_smem<BT>());
  return o;
}

// The ring body's grid: the blocks that fit on the card, rounded down to a
// multiple of nh (a block then keeps one head), at most one an item.
template <typename BT>
cudaError_t ring_grid(long long items, int nh, int* per_sm, long long* grid) {
  static const Occupancy occ = ring_occupancy<BT>();
  if (occ.err != cudaSuccess) return occ.err;
  *per_sm = occ.per_sm;
  long long g = (long long)occ.sms * occ.per_sm;
  if (g >= nh) g -= g % nh;
  *grid = g < items ? g : items;
  return cudaSuccess;
}

template <typename BT>
cudaError_t launch_ring(const void* qkv, const void* bias, void* out, long long NW, int C,
                        int nh, int nw_img, cudaStream_t s) {
  if ((uintptr_t)bias % 4) return cudaErrorInvalidValue;
  int per_sm = 0;
  long long grid = 0;
  const long long items = NW * nh;
  cudaError_t err = ring_grid<BT>(items, nh, &per_sm, &grid);
  if (err != cudaSuccess) return err;
  window_attention_ring_kernel<BT><<<(unsigned)grid, kRingThreads, ring_smem<BT>(), s>>>(
      (const bf16*)qkv, (const BT*)bias, (bf16*)out, items, C, nh, nw_img, NW / nw_img);
  return cudaGetLastError();
}

bool bad_shape(long long NW, int C, int nh, int nw_img) {
  return nh * kHD != C || nw_img < 1 || NW % nw_img || NW * nh > 2147483647LL;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (qkv and out); bias_dtype the same for the
// bias.  bf16 qkv runs the ring body with either bias dtype; fp32 qkv runs
// the fp32 body and takes an fp32 bias.  qkv
// [NW, 49, 3C] and out [NW, 49, C]; bias [nw_img, nh, 49, 49], 4-byte aligned,
// window w using bias[w % nw_img]; nw_img divides NW.  Heads of 32.  Returns
// a cudaError_t.
extern "C" int segland_window_attention(int dtype, const void* qkv, int bias_dtype,
                                        const void* bias, void* out, long long NW, int C, int nh,
                                        int nw_img, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(NW, C, nh, nw_img) || bias_dtype < 0 || bias_dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (NW <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    if (bias_dtype != 0) return (int)cudaErrorInvalidValue;
    window_attention_f32_kernel<<<(unsigned)(NW * nh), 128, 0, s>>>(
        (const float*)qkv, (const float*)bias, (float*)out, C, nh, nw_img);
    return (int)cudaGetLastError();
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  return (int)(bias_dtype ? launch_ring<bf16>(qkv, bias, out, NW, C, nh, nw_img, s)
                          : launch_ring<float>(qkv, bias, out, NW, C, nh, nw_img, s));
}

// The ring body's plan for these shapes and bias dtype, as launched:
// plan[0..6) = ring stages, stage bytes, dynamic shared memory, blocks a SM,
// grid, items.  ops/fused_attn.py:window_attention_plan computes the same.
extern "C" int segland_window_attention_plan(long long NW, int C, int nh, int nw_img,
                                             int bias_dtype, int* plan) {
  if (bad_shape(NW, C, nh, nw_img) || NW <= 0) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  long long grid = 0;
  const long long items = NW * nh;
  cudaError_t err = bias_dtype ? ring_grid<bf16>(items, nh, &per_sm, &grid)
                               : ring_grid<float>(items, nh, &per_sm, &grid);
  if (err != cudaSuccess) return (int)err;
  plan[0] = kRingStages;
  plan[1] = bias_dtype ? stage_bytes<bf16>() : stage_bytes<float>();
  plan[2] = bias_dtype ? ring_smem<bf16>() : ring_smem<float>();
  plan[3] = per_sm;
  plan[4] = (int)grid;
  plan[5] = (int)items;
  return 0;
}

// Registers a thread, local (spill) bytes and dynamic shared memory of the
// ring body's build for a bias dtype (0 = float32, 1 = bfloat16).
extern "C" int segland_window_attention_attrs(int bias_dtype, int* regs, int* local_bytes,
                                              int* smem) {
  cudaFuncAttributes a;
  const cudaError_t err = bias_dtype
                              ? cudaFuncGetAttributes(&a, window_attention_ring_kernel<bf16>)
                              : cudaFuncGetAttributes(&a, window_attention_ring_kernel<float>);
  *smem = bias_dtype ? ring_smem<bf16>() : ring_smem<float>();
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}
