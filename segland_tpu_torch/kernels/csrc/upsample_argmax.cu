// Eval epilogue: argmax over K of the bilinear (align_corners=True) fp32
// upsample of (B, h, w, K) logits to (oh, ow); only the uint8 class map is
// written.
//
// Replaces: segland_tpu/ops/fused_epilogue.py:upsample_argmax (body
// `_kernel`).  The TPU kernel ran both interpolation axes as split-bf16
// matrix products to reach fp32 accuracy on its matrix unit; here each
// output pixel is a plain fp32 lerp of lerps, so no split is needed.
//
// What bounds it on an H100: bytes.  At the serving shape (8, 256, 256, 8)
// -> (8, 1024, 1024) it reads 16.8 MB of logits and writes 8.4 MB of classes
// (7.5 us at 3.35 TB/s); the 268 MB of upsampled fp32 logits that an unfused
// resize + argmax would write and read back never exist.  Its operations in
// the order below (a row lerp per output row, source column and class, a
// column lerp and a compare per output pixel and class) take 4.8 us at the
// fp32 peak.  In practice it is bound by instruction issue and latency: about
// six instructions an output pixel and class, and a chain of dependent loads
// (tables, then the patch) in front of every tile.
//
// Design.  A tile is kPx * txt output columns by ty * groups output rows of
// one image; a block has txt * ty threads (a multiple of 32, at most
// kThreads), each owning kPx adjacent output pixels of one row of a row group,
// so a warp owns 32 / txt whole rows of it.  A persistent grid (the blocks
// that fit on the card; a multiple of the column tiles where it can be, so a
// block keeps its columns' tables) walks the tiles, a pass of kc classes at a
// time, and stages the next pass's source patch in a second buffer while it
// computes this one's: one __syncthreads a pass.  For each pass:
//  1. the source patch in shared memory: source rows rlo[y0] to rhi[y1],
//     columns clo[x0] to chi[x1], the pass's classes; with all K classes a
//     patch row is one contiguous run of logits, copied as 16-byte cp.async
//     from the aligned float at or before its start;
//  2. each warp row-lerps every row it owns in the tile (its rows of each row
//     group), once per patch column and class, into its own strip rows,
//     lerp(x[rlo[y]], x[rhi[y]], rw[y]), four rows at once, 4 classes a lane
//     where K allows; then (after a __syncwarp) each thread column-lerps its
//     pixels row by row and keeps the running (best, class), replaced only by
//     a strictly greater value: the first maximum wins.  Where a thread's
//     pixels use at most three strip columns (any upsampling by 4/3 or more)
//     it loads those three once per 4 classes and gives each pixel weights
//     over them, (1 - wx) on its left column and wx on its right one, 0 on the
//     third: c0 * a + c1 * b + c2 * d, whose zero term adds nothing, so each
//     value is lerp(left, right, wx); else it reads each pixel's two columns.
// After the last pass the kPx classes go out as one 4-byte store.  A lerp is
// fma(hi, w, lo * (1 - w)): the rows first, per source column, then the
// columns, with the host's fp32 weights, as the plain version orders them.
// The row and column (lo, hi, w) tables come from the host (float64 -> fp32,
// as ops/resize.py builds them); the host's plan (ops/fused_epilogue.py:
// upsample_plan) picks txt, ty, groups and kc from the largest patch of any
// tile so that two patches and the strip fit in kSmemBudget at every shape,
// downsampling included.  Any K <= 255 is taken.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;       // the most threads a block
constexpr int kPx = 4;              // adjacent output pixels a thread
constexpr int kWin = 3;             // strip columns a thread's window holds
constexpr int kRows = 4;            // rows a warp row-lerps at once
constexpr int kSmemBudget = 98304;  // bytes of patches + strip a block: at least two a SM

// The plan of a launch; ops/fused_epilogue.py:upsample_plan computes the same.
struct Plan {
  int txt;     // threads across a tile: the tile is kPx * txt columns wide
  int ty;      // rows of a row group: a thread a row and kPx columns
  int groups;  // row groups a tile (1 where a tile takes several passes)
  int kc;      // classes a pass
  int prows;   // the largest patch of any tile: source rows
  int pcols;   //   and source columns
  int ppitch;  // floats a patch row: pcols * kc + 3 (a misaligned start), to 4
  int cs;      // floats between two strip columns: kc to 4, + 4 if a multiple of 8
  int smem;    // bytes: 2 patch buffers of prows * ppitch, ty * groups * pcols * cs of strip
};

Plan make_plan(int txt, int ty, int groups, int kc, int prows, int pcols) {
  Plan p;
  p.txt = txt;
  p.ty = ty;
  p.groups = groups;
  p.kc = kc;
  p.prows = prows;
  p.pcols = pcols;
  p.ppitch = (pcols * kc + 3 + 3) / 4 * 4;
  p.cs = (kc + 3) / 4 * 4;
  if (p.cs % 8 == 0) p.cs += 4;  // a quarter-warp's 16-byte column reads in distinct banks
  p.smem = 4 * (2 * prows * p.ppitch + p.ty * groups * pcols * p.cs);
  return p;
}

__device__ __forceinline__ float lerp(float lo, float hi, float w) {
  return __fmaf_rn(hi, w, __fmul_rn(lo, 1.0f - w));
}

// A tile, (column tile, row tile, image), and the extent of its source patch.
struct Tile {
  int b, xt, yt, nrow, r0, nr, c0, nc;
};

__device__ __forceinline__ Tile tile_at(int tx, int tyi, int b, const Plan& pl, int oh, int ow,
                                        const int* __restrict__ rlo,
                                        const int* __restrict__ rhi,
                                        const int* __restrict__ clo,
                                        const int* __restrict__ chi) {
  Tile u;
  u.xt = tx * kPx * pl.txt;
  u.yt = tyi * pl.ty * pl.groups;
  u.b = b;
  u.nrow = min(pl.ty * pl.groups, oh - u.yt);
  const int xend = min(u.xt + kPx * pl.txt, ow);
  u.r0 = rlo[u.yt];
  u.nr = rhi[u.yt + u.nrow - 1] - u.r0 + 1;
  u.c0 = clo[u.xt];
  u.nc = chi[xend - 1] - u.c0 + 1;
  return u;
}

// Offset of the first float of patch row pr in its shared-memory row: a run of
// all K classes is copied from the aligned float at or before its start.
__device__ __forceinline__ int lead_of(const Tile& u, int pr, int h, int w, int K) {
  return (int)(((((long long)u.b * h + u.r0 + pr) * w + u.c0) * K) & 3);
}

// Start the copies of the patch of tile u, classes k0 .. k0 + kc, into
// `patch`; one commit group.
__device__ __forceinline__ void issue_patch(const Tile& u, int k0, float* patch,
                                            const float* __restrict__ logits, int h, int w,
                                            int K, const Plan& pl) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int kc = min(pl.kc, K - k0);
  const int run = u.nc * kc;  // floats of a patch row
  for (int pr = warp; pr < u.nr; pr += warps) {
    float* dst = patch + pr * pl.ppitch;
    const float* row = logits + (((size_t)u.b * h + u.r0 + pr) * w + u.c0) * K;
    if (kc == K) {
      const int lead = lead_of(u, pr, h, w, K);
      const float* base = row - lead;  // 16-byte aligned
      const int n = run + lead;
      for (int v = lane; 4 * v < n; v += 32) {
        if (4 * v >= lead && 4 * v + 4 <= n) {
          cp_async16(dst + 4 * v, base + 4 * v);
        } else {
          for (int e = max(4 * v, lead); e < min(4 * v + 4, n); ++e) cp_async4(dst + e, base + e);
        }
      }
    } else {
      for (int e = lane; e < run; e += 32) {
        const int pc = e / kc;
        cp_async4(dst + e, row + (size_t)pc * K + k0 + (e - pc * kc));
      }
    }
  }
  cp_async_commit();
}

// The row lerps of every row this warp owns in tile u, classes k0 .. k0 + kc:
// strip slot s = g * rpw + i holds tile row g * ty + warp * rpw + i, and
// strip[s][pc][k] = lerp(patch[rlo[y]][pc][k], patch[rhi[y]][pc][k], rw[y]).
// Lanes go along the patch row (4 classes a lane where K and kc allow), kRows
// rows at once so that their loads overlap.
__device__ __forceinline__ void row_lerps(const Tile& u, int kc, const float* patch,
                                          float* strip, const int* __restrict__ rlo,
                                          const int* __restrict__ rhi,
                                          const float* __restrict__ rw, int h, int w, int K,
                                          const Plan& pl) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rpw = 32 / pl.txt, slots = pl.groups * rpw;
  const int rpitch = pl.pcols * pl.cs;
  const bool vec = (K & 3) == 0 && (kc & 3) == 0;  // every patch row starts 16-byte aligned
  const int kv = vec ? kc >> 2 : kc, run = u.nc * kv;  // float4s or floats of a patch row
  const int q32 = 32 / kv, m32 = 32 % kv;  // (pc, k) of e + 32 from those of e
  const int pc1 = lane / kv, k1 = lane - pc1 * kv;
  for (int s0 = 0; s0 < slots; s0 += kRows) {
    const float* pa[kRows];
    const float* pb[kRows];
    float* dst[kRows];
    float wy[kRows];
    bool ok[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int sl = s0 + j, g = sl / rpw, r = g * pl.ty + warp * rpw + (sl - g * rpw);
      ok[j] = sl < slots && r < u.nrow;
      const int y = u.yt + (ok[j] ? r : 0);
      const int a = rlo[y] - u.r0, c = rhi[y] - u.r0;
      const bool lead = kc == K && !vec;
      pa[j] = patch + a * pl.ppitch + (lead ? lead_of(u, a, h, w, K) : 0);
      pb[j] = patch + c * pl.ppitch + (lead ? lead_of(u, c, h, w, K) : 0);
      dst[j] = strip + sl * rpitch;
      wy[j] = rw[y];
    }
    int pc = pc1, k = k1;
    for (int e = lane; e < run; e += 32) {
      if (vec) {
        const int off = pc * pl.cs + 4 * k;
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          if (ok[j]) {
            const float4 x = reinterpret_cast<const float4*>(pa[j])[e];
            const float4 y = reinterpret_cast<const float4*>(pb[j])[e];
            *reinterpret_cast<float4*>(dst[j] + off) =
                make_float4(lerp(x.x, y.x, wy[j]), lerp(x.y, y.y, wy[j]), lerp(x.z, y.z, wy[j]),
                            lerp(x.w, y.w, wy[j]));
          }
        }
      } else {
        const int off = pc * pl.cs + k;
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          if (ok[j]) dst[j][off] = lerp(pa[j][e], pb[j][e], wy[j]);
      }
      pc += q32;
      k += m32;
      if (k >= kv) {
        k -= kv;
        ++pc;
      }
    }
  }
}

// A thread's kPx output columns: the first one's left strip column, and where
// all use at most kWin strip columns from it (win), their weights over them.
struct Pixels {
  int cb;
  bool win;
  float wa[kPx], wb[kPx], wd[kPx];
};

// The running (best, class) of a thread's kPx pixels in one row.
struct Best {
  float v[kPx];
  int k[kPx];
  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      v[j] = -INFINITY;
      k[j] = 0;
    }
  }
  __device__ __forceinline__ void update(int j, float x, int cls) {
    if (x > v[j]) {
      v[j] = x;
      k[j] = cls;
    }
  }
};

__device__ __forceinline__ void pixels_at(Pixels& p, int x0, int c0, int ow,
                                          const int* __restrict__ clo,
                                          const int* __restrict__ chi,
                                          const float* __restrict__ cw) {
  int lo[kPx], hi[kPx];
  float wx[kPx];
#pragma unroll
  for (int j = 0; j < kPx; ++j) {
    const int x = min(x0 + j, ow - 1);  // past ow: computed, never stored
    lo[j] = clo[x] - c0;
    hi[j] = chi[x] - c0;
    wx[j] = cw[x];
  }
  p.cb = lo[0];
  p.win = hi[kPx - 1] - p.cb < kWin;
#pragma unroll
  for (int j = 0; j < kPx; ++j) {
    const float l = 1.0f - wx[j], r = wx[j];
    p.wa[j] = (lo[j] == p.cb ? l : 0.0f) + (hi[j] == p.cb ? r : 0.0f);
    p.wb[j] = (lo[j] == p.cb + 1 ? l : 0.0f) + (hi[j] == p.cb + 1 ? r : 0.0f);
    p.wd[j] = (lo[j] == p.cb + 2 ? l : 0.0f) + (hi[j] == p.cb + 2 ? r : 0.0f);
  }
}

// The column lerps of a thread's strip row over classes k0 .. k0 + kc, and
// the running argmax: replaced only by a strictly greater value.  Pixels that
// span more than kWin strip columns (downsampling) read their own two columns,
// from the tables at x0 .. x0 + kPx - 1 (patch column c0 first).
__device__ __forceinline__ void column_lerps(const Pixels& p, Best& best, const float* srow,
                                             int nc, int k0, int kc, int cs, int x0, int c0,
                                             int ow, const int* __restrict__ clo,
                                             const int* __restrict__ chi,
                                             const float* __restrict__ cw) {
  if (p.win) {
    const float* s0 = srow + p.cb * cs;
    const float* s1 = srow + min(p.cb + 1, nc - 1) * cs;
    const float* s2 = srow + min(p.cb + 2, nc - 1) * cs;
    auto step = [&](int k, int kmax) {
      const float4 v0 = *reinterpret_cast<const float4*>(s0 + k);
      const float4 v1 = *reinterpret_cast<const float4*>(s1 + k);
      const float4 v2 = *reinterpret_cast<const float4*>(s2 + k);
      const float a0[4] = {v0.x, v0.y, v0.z, v0.w}, a1[4] = {v1.x, v1.y, v1.z, v1.w},
                  a2[4] = {v2.x, v2.y, v2.z, v2.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < kmax) {
#pragma unroll
          for (int j = 0; j < kPx; ++j)
            best.update(j,
                        __fmaf_rn(a2[i], p.wd[j],
                                  __fmaf_rn(a1[i], p.wb[j], __fmul_rn(a0[i], p.wa[j]))),
                        k0 + k + i);
        }
      }
    };
    int k = 0;
    for (; k + 4 <= kc; k += 4) step(k, 4);
    if (k < kc) step(k, kc - k);
    return;
  }
#pragma unroll
  for (int j = 0; j < kPx; ++j) {
    const int x = min(x0 + j, ow - 1);
    const float* sl = srow + (clo[x] - c0) * cs;
    const float* sh = srow + (chi[x] - c0) * cs;
    const float wx = cw[x];
    for (int k = 0; k < kc; ++k) best.update(j, lerp(sl[k], sh[k], wx), k0 + k);
  }
}

// Three blocks a SM where the plan's shared memory allows: 80 registers a
// thread, without spills; the column lerps want warps to hide their latency.
__global__ void __launch_bounds__(kThreads, 3)
upsample_argmax_kernel(const float* __restrict__ logits, const int* __restrict__ rlo,
                       const int* __restrict__ rhi, const float* __restrict__ rw,
                       const int* __restrict__ clo, const int* __restrict__ chi,
                       const float* __restrict__ cw, uint8_t* __restrict__ out, int B, int h,
                       int w, int K, int oh, int ow, Plan pl) {
  extern __shared__ __align__(16) float smem[];
  const int pbuf = pl.prows * pl.ppitch;  // floats of a patch buffer; two, then the strip
  const int rpitch = pl.pcols * pl.cs;    // floats of a strip row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rpw = 32 / pl.txt;  // rows a warp owns in a row group
  float* strip = smem + 2 * pbuf + warp * pl.groups * rpw * rpitch;  // this warp's rows
  const int ntx = (ow + kPx * pl.txt - 1) / (kPx * pl.txt);
  const int nty = (oh + pl.ty * pl.groups - 1) / (pl.ty * pl.groups);
  const int passes = (K + pl.kc - 1) / pl.kc;
  const int yl = lane / pl.txt, gx = threadIdx.x % pl.txt;  // this thread's row in its warp's
  // tile t = tx + ntx * (tyi + nty * b); block i walks t = i, i + grid, ...,
  // stepping (tx, tyi, b) by the grid's own decomposition
  const int g_tx = gridDim.x % ntx, g_rest = gridDim.x / ntx;
  const int g_ty = g_rest % nty, g_b = g_rest / nty;
  int tx = blockIdx.x % ntx, tyi = (blockIdx.x / ntx) % nty, b = blockIdx.x / ntx / nty;

  issue_patch(tile_at(tx, tyi, b, pl, oh, ow, rlo, rhi, clo, chi), 0, smem, logits, h, w, K,
              pl);
  Pixels p;
  Best best;
  int xt_have = -1;
  int pass = 0, buf = 0;
  for (;;) {
    const Tile u = tile_at(tx, tyi, b, pl, oh, ow, rlo, rhi, clo, chi);
    if (u.nr > pl.prows || u.nc > pl.pcols) __trap();  // the host's plan covers every tile
    cp_async_wait<0>();
    __syncthreads();  // this pass's patch is in; the other buffer is free
    // the next unit: this tile's next pass, or the next tile's first
    const bool last = pass == passes - 1;
    int nx_tx = tx, nx_ty = tyi, nx_b = b;
    if (last) {
      nx_tx += g_tx;
      nx_ty += g_ty + (nx_tx >= ntx);
      nx_tx -= nx_tx >= ntx ? ntx : 0;
      nx_b += g_b + (nx_ty >= nty);
      nx_ty -= nx_ty >= nty ? nty : 0;
    }
    const bool more = nx_b < B;
    if (more)
      issue_patch(last ? tile_at(nx_tx, nx_ty, nx_b, pl, oh, ow, rlo, rhi, clo, chi) : u,
                  last ? 0 : (pass + 1) * pl.kc, smem + (buf ^ 1) * pbuf, logits, h, w, K, pl);

    const int x0 = u.xt + kPx * gx;
    if (x0 < ow && u.xt != xt_have) {
      pixels_at(p, x0, u.c0, ow, clo, chi, cw);
      xt_have = u.xt;
    }
    const int k0 = pass * pl.kc, kc = min(pl.kc, K - k0);
    const float* patch = smem + buf * pbuf;
    row_lerps(u, kc, patch, strip, rlo, rhi, rw, h, w, K, pl);
    __syncwarp();
    for (int g = 0; g < pl.groups; ++g) {
      const int r = g * pl.ty + warp * rpw + yl;  // this thread's row of group g in the tile
      if (r >= u.nrow || x0 >= ow) break;
      if (pass == 0) best.reset();
      column_lerps(p, best, strip + (g * rpw + yl) * rpitch, u.nc, k0, kc, pl.cs, x0, u.c0, ow,
                   clo, chi, cw);
      if (last) {
        uint8_t* o = out + ((size_t)u.b * oh + u.yt + r) * ow + x0;
        if (x0 + kPx <= ow && ((uintptr_t)o & 3) == 0) {
          *reinterpret_cast<uint32_t*>(o) = (uint32_t)best.k[0] | ((uint32_t)best.k[1] << 8) |
                                            ((uint32_t)best.k[2] << 16) |
                                            ((uint32_t)best.k[3] << 24);
        } else {
          for (int j = 0; j < kPx && x0 + j < ow; ++j) o[j] = (uint8_t)best.k[j];
        }
      }
    }
    if (!more) break;
    tx = nx_tx;
    tyi = nx_ty;
    b = nx_b;
    pass = last ? 0 : pass + 1;
    buf ^= 1;
  }
}

// The persistent grid: as many blocks as fit on the card, rounded down to a
// multiple of the column tiles where that leaves any, at most one a tile.
cudaError_t grid_of(const Plan& p, int B, int oh, int ow, int* per_sm, int* grid) {
  static const cudaError_t set = cudaFuncSetAttribute(
      upsample_argmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
  if (set != cudaSuccess) return set;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, upsample_argmax_kernel,
                                                        p.txt * p.ty, p.smem);
  if (err != cudaSuccess) return err;
  const long long ntx = (ow + kPx * p.txt - 1) / (kPx * p.txt);
  const long long nty = (oh + p.ty * p.groups - 1) / (p.ty * p.groups);
  const long long tiles = ntx * nty * B;
  if (tiles > 2147483647LL) return cudaErrorInvalidValue;  // the kernel counts tiles in int
  long long g = (long long)sms * *per_sm;
  if (g >= ntx) g -= g % ntx;
  *grid = (int)(g < tiles ? g : tiles);
  return cudaSuccess;
}

bool bad_plan(int K, int txt, int ty, int groups, int kc, int prows, int pcols) {
  return K < 1 || K > 255 || txt < 1 || 32 % txt || ty < 1 || txt * ty > kThreads ||
         (txt * ty) % 32 || groups < 1 || (groups > 1 && kc < K) || kc < 1 || kc > K ||
         prows < 1 || pcols < 1;
}

}  // namespace

// The layout of (K, txt, ty, groups, kc, prows, pcols) and its launch for B
// images of (oh, ow): plan[0..5) = ppitch, cs, smem bytes, blocks a SM, grid.
// Returns a cudaError_t.
extern "C" int segland_upsample_argmax_plan(int K, int txt, int ty, int groups, int kc,
                                            int prows, int pcols, int B, int oh, int ow,
                                            int* plan) {
  if (bad_plan(K, txt, ty, groups, kc, prows, pcols) || (long long)B * oh * ow == 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(txt, ty, groups, kc, prows, pcols);
  plan[0] = p.ppitch;
  plan[1] = p.cs;
  plan[2] = p.smem;
  return (int)grid_of(p, B, oh, ow, &plan[3], &plan[4]);
}

// logits (B, h, w, K) fp32, 16-byte aligned; the (lo, hi, w) tables of rows
// (oh) and columns (ow); out (B, oh, ow) uint8.  txt, ty, groups, kc, prows,
// pcols: the host's plan (ops/fused_epilogue.py:upsample_plan), whose patch
// must cover every tile.  Returns a cudaError_t.
extern "C" int segland_upsample_argmax(const void* logits, const void* rlo, const void* rhi,
                                       const void* rw, const void* clo, const void* chi,
                                       const void* cw, void* out, int B, int h, int w, int K,
                                       int oh, int ow, int txt, int ty, int groups, int kc,
                                       int prows, int pcols, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_plan(K, txt, ty, groups, kc, prows, pcols) || ((uintptr_t)logits & 15))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * oh * ow == 0) return (int)cudaSuccess;
  const Plan p = make_plan(txt, ty, groups, kc, prows, pcols);
  if (p.smem > kSmemBudget) return (int)cudaErrorInvalidValue;
  int per_sm = 0, grid = 0;
  err = grid_of(p, B, oh, ow, &per_sm, &grid);
  if (err != cudaSuccess) return (int)err;
  upsample_argmax_kernel<<<grid, txt * ty, p.smem, (cudaStream_t)stream>>>(
      (const float*)logits, (const int*)rlo, (const int*)rhi, (const float*)rw, (const int*)clo,
      (const int*)chi, (const float*)cw, (uint8_t*)out, B, h, w, K, oh, ow, p);
  return (int)cudaGetLastError();
}
