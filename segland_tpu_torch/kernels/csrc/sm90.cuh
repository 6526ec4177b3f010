// Hopper (sm_90a) building blocks of the port's wgmma kernels: K1 (ln_mlp.cu),
// K3 (attn_section.cu), K4 (swin_block.cu) and K5 (attn_section_v1.cu), whose
// shared bodies are mlp_sm90.cuh and section_sm90.cuh, and the int8 kernels
// K7 and K8 (bottleneck_int8.cu).
//
//  - mbarrier init, arrive, expect-tx and wait with phase parity;
//  - the TMA 2-D tile load (and K7's 4-D load and store, K8's 2-D store), and the host-side
//    tensor-map encoding
//    (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
//    library links against the runtime alone);
//  - wgmma descriptors of the 128-byte-swizzled K-major layout, the fences and
//    group waits, and the instruction wrappers (m64 x N x k16, bf16 in, fp32
//    accumulate; A from shared memory or from registers);
//  - named barriers, setmaxnreg, and the swizzled address of an element;
//  - for int8 operands: the 4-D TMA load, the 64-byte-swizzled layout and its
//    descriptor, s8 wgmma wrappers with int32 accumulators (m64 x N x k32) and
//    their fences, and tensor maps of 2 to 4 dimensions (int8, or bf16 rows
//    that the int8 kernels read back: x, and K7's residual).
//
// The operand layout.  Every wgmma operand here is K-major and cut into tiles
// of 64 K-columns (128 bytes a row).  A tile of R rows is R x 128 bytes at a
// 1024-byte aligned address, row r at r * 128, its 16-byte chunk j stored at
// chunk j ^ (r % 8): what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B for a box
// of {64, R}, and what a descriptor with layout SWIZZLE_128B and a stride of
// 1024 bytes between 8-row groups reads.  The k-th 16-column step of a tile
// is the same descriptor with its start address 32 * k bytes further on.
//
// The int8 layout.  An int8 operand is cut into tiles of 64 K-columns (64
// bytes a row): row r at r * 64, its 16-byte chunk j stored at chunk
// j ^ ((r / 2) % 4), the tile 512-byte aligned.  That is what TMA writes with
// CU_TENSOR_MAP_SWIZZLE_64B for a box 64 bytes wide, and what a descriptor
// with layout SWIZZLE_64B and 512 bytes between 8-row groups reads.  A k32
// step is 32 bytes, so the second step of a tile is desc_step(d, 1).  One
// layout serves every width a multiple of 64, P = 64 included, whose rows of
// h1q are 64 bytes long.
// Everything lives in an anonymous namespace, so each source gets its own copy.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {
namespace sm90 {

constexpr int kTileCols = 64;  // K-columns of an operand tile (128 bytes of bf16)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// byte offset of element (r, c), c < 64, of a swizzled [rows, 64] bf16 tile
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (uint32_t)(r * 128 + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1));
}

// round to bf16 and back: the kernels' rounding points
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- mbarrier -----------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// makes the inits visible to the async proxy (TMA) and the other threads
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// arrive and expect `bytes` more of TMA traffic before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed; a wait that outlasts
// 2^32 clocks (about 2 s: an arrival that never comes) traps, failing the
// launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if ((spins & 1023u) == 1023u) {
      const long long now = clock64();
      if (t0 == 0) t0 = now;
      else if (now - t0 > (1ll << 32)) __trap();
    }
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ---- TMA ----------------------------------------------------------------------
// the box at (c0 = column, c1 = row) of `map` into dst, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// the box at (c0, c1, c2), innermost first, of a 3-D `map` into dst
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the box at (c0, c1, c2, c3), innermost first, of a 4-D `map` into dst
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// the 4-D box at (c0, c1, c2, c3) of `map` from src, as one bulk group of this thread
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// the 2-D box at (c0 = column, c1 = row) of `map` from src, as one bulk group of this thread
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
// all but this thread's last N bulk stores have read their shared memory (READ)
// or are done
template <bool READ, int N = 0>
__device__ __forceinline__ void tma_store_wait() {
  if constexpr (READ)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma and TMA reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// this thread's generic-proxy writes, to device memory too, made visible to
// the async proxy: a TMA load issued after a barrier that follows it reads them
__device__ __forceinline__ void fence_async_all() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// ---- barriers and registers -------------------------------------------------------
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// registers a thread keeps or gets by setmaxnreg with two consumer warpgroups
// beside a producer warpgroup: 128 * 24 + 256 * 240 = 64,512 of the SM's 65,536
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// clock64() time of a consumer warpgroup split by phase: lap<P>() adds the
// time since the last lap to phase P; flush() adds thread 0's sums of each
// warpgroup to out[0..N) and counts the warpgroup in out[N].  A kernel
// instantiated with ON = false (every launch of the served path) has none.
template <bool ON, int N>
struct PhaseClocks {
  long long t = 0, acc[N] = {};
  __device__ __forceinline__ void start() { t = clock64(); }
  template <int P>
  __device__ __forceinline__ void lap() {
    const long long now = clock64();
    acc[P] += now - t;
    t = now;
  }
  __device__ __forceinline__ void flush(unsigned long long* out) {
    if (threadIdx.x % 128 == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) atomicAdd(out + i, (unsigned long long)acc[i]);
      atomicAdd(out + N, 1ull);
    }
  }
};
template <int N>
struct PhaseClocks<false, N> {
  __device__ __forceinline__ void start() {}
  template <int P>
  __device__ __forceinline__ void lap() {}
  __device__ __forceinline__ void flush(unsigned long long*) {}
};
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ln_rows' default row scale: none
struct Unscaled {};

// One warp, NR rows at a time: row r0 + k * step (k < NR; those at or past
// `rows` skipped) gets T(LN(src(r)) * gamma + beta), or with a row scale
// T((LN(src(r)) * gamma + beta) * scale(r)), fp32 statistics and fast
// variance; sink(r, c, y, xv) takes columns c and c + 1 of row r, y the two
// values of T packed, xv the two inputs (src(r) null: zeros for both).  Every
// load of a batch is in flight before its first reduction, so a warp waits on
// memory once a batch, not once a row.
template <int C, int NR, typename Src, typename Sink, typename Scale = Unscaled>
__device__ __forceinline__ void ln_rows(Src src, int r0, int step, int rows,
                                        const float* __restrict__ gamma,
                                        const float* __restrict__ beta, float eps, Sink sink,
                                        Scale scale = Scale()) {
  constexpr bool SCALED = !std::is_same<Scale, Unscaled>::value;
  const int lane = threadIdx.x % 32;
  constexpr int NPAIR = C / 2, NI = (NPAIR + 31) / 32;
  for (int rb = r0; rb < rows; rb += NR * step) {
    float2 v[NR][NI];
    const __nv_bfloat16* p[NR];
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const int r = rb + k * step;
      p[k] = r < rows ? src(r) : nullptr;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int c2 = lane + 32 * i;
        v[k][i] = make_float2(0.0f, 0.0f);
        if (p[k] && c2 < NPAIR)
          v[k][i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p[k] + 2 * c2));
      }
    }
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const int r = rb + k * step;
      if (r >= rows) break;
      float s = 0.0f, ss = 0.0f;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        s += v[k][i].x + v[k][i].y;
        ss += v[k][i].x * v[k][i].x + v[k][i].y * v[k][i].y;
      }
      s = warp_sum(s);
      ss = warp_sum(ss);
      const float mu = s / C;
      const float var = fmaxf(ss / C - mu * mu, 0.0f);
      const float rs = rsqrtf(var + eps);
      float m = 1.0f;
      if constexpr (SCALED) m = p[k] ? scale(r) : 0.0f;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int c = 2 * (lane + 32 * i);
        if (c < C) {
          uint32_t val = 0u;
          if (p[k]) {
            float lo = ((v[k][i].x - mu) * rs) * gamma[c] + beta[c];
            float hi = ((v[k][i].y - mu) * rs) * gamma[c + 1] + beta[c + 1];
            if constexpr (SCALED) {
              lo *= m;
              hi *= m;
            }
            val = pack_bf16(lo, hi);
          }
          sink(r, c, val, v[k][i]);
        }
      }
    }
  }
}

// ln_rows into the rows of a swizzled operand of C columns whose 64-column
// tiles lie `tile_bytes` apart
template <int C, int NR, typename Src, typename Scale = Unscaled>
__device__ __forceinline__ void ln_rows_sw128(Src src, int r0, int step, int rows,
                                              const float* __restrict__ gamma,
                                              const float* __restrict__ beta, float eps,
                                              unsigned char* dst, int tile_bytes,
                                              Scale scale = Scale()) {
  ln_rows<C, NR>(
      src, r0, step, rows, gamma, beta, eps,
      [&](int r, int c, uint32_t val, float2) {
        *reinterpret_cast<uint32_t*>(dst + (c / kTileCols) * tile_bytes +
                                     sw128(r, c % kTileCols)) = val;
      },
      scale);
}

// rows a batch of ln_rows that keep its loads within 32 registers a lane
template <int C>
constexpr int kLnBatch = 16 / ((C / 2 + 31) / 32) > 0 ? 16 / ((C / 2 + 31) / 32) : 1;

// ---- wgmma --------------------------------------------------------------------
// descriptor of a swizzled K-major tile at p: start >> 4, leading offset 1
// (unused by this layout), 1024 bytes between 8-row groups, SWIZZLE_128B
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFFull) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
// the same descriptor k 16-column steps further along K
__device__ __forceinline__ uint64_t desc_step(uint64_t d, int k) { return d + (uint64_t)(2 * k); }

// byte offset of element (r, c), c < 64, of a 64-byte-swizzled int8 tile
__device__ __forceinline__ uint32_t sw64(int r, int c) {
  return (uint32_t)(r * 64 + ((((c >> 4) ^ (r >> 1)) & 3) << 4) + (c & 15));
}
// descriptor of a 64-byte-swizzled K-major int8 tile at p: start >> 4, leading
// offset 1 (unused), 512 bytes between 8-row groups, SWIZZLE_64B
__device__ __forceinline__ uint64_t desc_sw64(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFFull) >> 4) | (1ull << 16) | ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void reg_fence(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// Accumulator layout of m64nN (fp32): thread t of the warpgroup holds d[i],
// i < N / 2, at row 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2) and
// column 8 * (i / 4) + 2 * (t % 4) + i % 2.  The A-register fragment of a
// k16 step is the same layout over 16 columns, two bf16 a register:
// a[j] = {d[8 s + 2 j], d[8 s + 2 j + 1]} for the step s of those columns.

// d[0..48) += A (descriptor) x B (descriptor), m64n96k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void wgmma_ss_n96(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0..32) += A (descriptor) x B (descriptor), m64n64k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0..24) += A (descriptor) x B (descriptor), m64n48k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void wgmma_ss_n48(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0..16) += A (descriptor) x B (descriptor), m64n32k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0..8) += A (descriptor) x B (descriptor), m64n16k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void wgmma_ss_n16(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0..32) += A (registers, a[4]) x B (descriptor), m64n64k16
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[0..16) += A (registers, a[4]) x B (descriptor), m64n32k16
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// The s32 accumulator layout of m64nN is the fp32 one above.
// d[0..32) += A (descriptor) x B (descriptor), m64n64k32, s8 in, s32 accumulate
__device__ __forceinline__ void wgmma_s8_n64(int* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0..64) += A (descriptor) x B (descriptor), m64n128k32, s8 in, s32 accumulate
__device__ __forceinline__ void wgmma_s8_n128(int* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0..128) += A (descriptor) x B (descriptor), m64n256k32, s8 in, s32 accumulate
__device__ __forceinline__ void wgmma_s8_n256(int* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A x B over one k32 step, m64 x N x k32, N in 64, 128, 256
template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db) {
  if constexpr (N == 64) {
    wgmma_s8_n64(d, da, db, 1);
  } else if constexpr (N == 128) {
    wgmma_s8_n128(d, da, db, 1);
  } else {
    static_assert(N == 256, "an s8 wgmma width of 64, 128 or 256");
    wgmma_s8_n256(d, da, db, 1);
  }
}

// ---- a ring of weight tiles, as its producer sees it ---------------------------------
// One thread fills slot after slot in the order the consumers take them: it
// waits for the slot's `empty` barrier, expects the bytes of the slot's TMA
// loads on its `full` barrier and starts them.  A slot may hold less than
// BYTES (K4's section tiles are 12 KB, its MLP tiles 8 KB).
template <int BYTES, int SLOTS>
struct RingFill {
  unsigned char* base;  // slot 0
  uint64_t* full;       // SLOTS full barriers, then SLOTS empty ones
  int slot;
  uint32_t phase;
  // the next slot, once its consumers have handed it back, expecting `bytes`
  __device__ __forceinline__ unsigned char* next(uint32_t bytes) {
    mbar_wait(&full[SLOTS + slot], phase ^ 1u);
    mbar_expect_tx(&full[slot], bytes);
    return base + (size_t)slot * BYTES;
  }
  __device__ __forceinline__ uint64_t* bar() { return &full[slot]; }
  __device__ __forceinline__ void advance() {
    if (++slot == SLOTS) {
      slot = 0;
      phase ^= 1u;
    }
  }
  // one box of `map` at (c0 = column, c1 = row), `bytes` long, as a slot of its own
  __device__ __forceinline__ void load(const CUtensorMap* map, int c0, int c1, uint32_t bytes) {
    unsigned char* dst = next(bytes);
    tma_load_2d(dst, map, bar(), c0, c1);
    advance();
  }
};

// ---- a ring of weight tiles, as its consumer warpgroups see it --------------------
// One producer thread fills slot after slot (wait `empty`, expect the bytes on
// `full`, start the TMA loads); every consumer warpgroup takes every slot in
// the same order and hands it back with one arrival on its `empty` barrier
// (whose count is the number of consumer warpgroups), also a slot it does not
// read.  Around each slot's wgmmas: the operand fences and wgmma.fence, as a
// CUTLASS mainloop has them.
template <int BYTES, int SLOTS>
struct Ring {
  unsigned char* base;  // slot 0
  uint64_t* full;       // SLOTS full barriers, then SLOTS empty ones
  int slot, pend;       // the slot taken next; the slot whose wgmma group may still read it
  uint32_t phase;
};

template <int B, int S>
__device__ __forceinline__ unsigned char* ring_take(Ring<B, S>& q) {
  mbar_wait(&q.full[q.slot], q.phase);
  return q.base + (size_t)q.slot * B;
}
template <int B, int S>
__device__ __forceinline__ void ring_next(Ring<B, S>& q) {
  if (++q.slot == S) {
    q.slot = 0;
    q.phase ^= 1u;
  }
}
// one thread of the warpgroup hands a slot back to the producer
template <int B, int S>
__device__ __forceinline__ void ring_release(Ring<B, S>& q, int slot) {
  if (slot >= 0 && threadIdx.x % 128 == 0) mbar_arrive(&q.full[S + slot]);
}
// after the current slot's wgmma group is committed: every older group is
// done, so the slot read before goes back
template <int B, int S>
__device__ __forceinline__ void ring_used(Ring<B, S>& q) {
  wgmma_wait<1>();
  ring_release(q, q.pend);
  q.pend = q.slot;
}
// n slots this warpgroup does not read: taken (so that the producer cannot
// lap it) and handed back at once
template <int B, int S>
__device__ __forceinline__ void ring_skip(Ring<B, S>& q, int n) {
  for (int i = 0; i < n; ++i) {
    mbar_wait(&q.full[q.slot], q.phase);
    ring_release(q, q.slot);
    ring_next(q);
  }
}
// every group done; the last slot read goes back
template <int B, int S>
__device__ __forceinline__ void ring_drain(Ring<B, S>& q) {
  wgmma_wait<0>();
  ring_release(q, q.pend);
  q.pend = -1;
}

// ---- host: tensor maps ------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once at run time
inline cudaError_t tiled_encoder(EncodeTiled* out) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || !fn) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  *out = encode;
  return cudaSuccess;
}

// A map over a row-major bf16 matrix [rows, cols] (cols contiguous, a row a
// multiple of 16 bytes) that loads boxes of {64 columns, box_rows rows} into
// the swizzled layout above; a box reaching past the matrix is zero-filled.
inline cudaError_t tile_map(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                            uint32_t box_rows) {
  EncodeTiled encode;
  cudaError_t err = tiled_encoder(&encode);
  if (err != cudaSuccess) return err;
  if ((cols * 2) % 16 || reinterpret_cast<uintptr_t>(base) % 16 || box_rows > 256)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kTileCols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A map over a dense row-major tensor of 2 to 4 dimensions, dims[0]
// contiguous (a multiple of 16 bytes), whose boxes are 64 or 128 bytes wide
// (box[0] * elem_bytes): a 64-byte box lands in the 64-byte-swizzled int8
// layout above, a 128-byte one in the 128-byte-swizzled layout.  Whatever a
// box reaches outside the tensor, at negative coordinates too, is zero-filled.
inline cudaError_t tile_map_nd(CUtensorMap* map, const void* base, CUtensorMapDataType dtype,
                               int elem_bytes, int rank, const uint64_t* dims,
                               const uint32_t* box) {
  EncodeTiled encode;
  cudaError_t err = tiled_encoder(&encode);
  if (err != cudaSuccess) return err;
  const uint32_t width = box[0] * (uint32_t)elem_bytes;
  if (rank < 2 || rank > 4 || (dims[0] * elem_bytes) % 16 ||
      reinterpret_cast<uintptr_t>(base) % 16 || (width != 64 && width != 128))
    return cudaErrorInvalidValue;
  cuuint64_t gdims[4], strides[3];
  cuuint32_t gbox[4], elem[4];
  uint64_t stride = (uint64_t)elem_bytes;
  for (int i = 0; i < rank; ++i) {
    if (box[i] < 1 || box[i] > 256) return cudaErrorInvalidValue;
    gdims[i] = dims[i];
    gbox[i] = box[i];
    elem[i] = 1;
    if (i) strides[i - 1] = stride;
    stride *= dims[i];
  }
  const CUresult r = encode(map, dtype, (cuuint32_t)rank, const_cast<void*>(base), gdims,
                            strides, gbox, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            width == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace
