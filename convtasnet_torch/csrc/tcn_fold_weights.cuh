// KFW tcn_fold_weights: the per-block weight terms of the norm2 -> out_w
// fold (K3 fold, the whole-TCN forward), for all NB blocks in one launch:
//
//   Wr           = round_dt(out_w[nb])                (out_w f32 [NB, H, B])
//   wp[nb, h, b] = round_dt(g2[nb, h] * Wr[h, b])     (activation type)
//   g2w[nb, b]   = sum_h g2[nb, h] * Wr[h, b]         (f32)
//   b2w[nb, b]   = sum_h b2[nb, h] * Wr[h, b]         (f32)
//
// The TPU kernel computes these per block in its own body
// (convtasnet_tpu/ops/pallas/whole_tcn.py:189-196, :212-215, with the
// wrapper's cast of out_w, :374); the plain version is
// tcn_block.fold_weights. Wr is rounded in registers, so the f32 leaf is
// read once and wp written once.
//
// Bound on the H100 by bytes: at the paper config (NB=32, H=512, B=256)
// 16.8 MB of f32 weights read and 8.4 MB of bf16 operand written, 7.6 us
// at 3.35 TB/s, against 5 flops per weight. Streaming 25 MB at that rate
// needs ~3.35 TB/s x ~1 us of latency in flight, ~25 KB per SM. So:
//
// - a CTA takes FW_COLS columns of one block and one of `splits` slices
//   of H (tcn_block.fold_plan: CTAs for every SM resident at once, at
//   least two per SM, each slice at least FW_MIN_ROWS rows);
// - within the CTA, 16 column threads read four adjacent columns each
//   (16-byte loads, 256 contiguous bytes of a row per half-warp) and its
//   FW_LANES row lanes split the slice, lane l taking rows l, l +
//   FW_LANES, ...; a thread issues FW_UNROLL row loads before it uses
//   any, so 256 threads hold 16 KB in flight per CTA, 32 KB or more per SM;
// - the lanes' sums are added by a fixed shared-memory tree; with several
//   slices, each CTA stores its sums, and the last CTA to arrive at its
//   column tile, decided by a device ticket, adds the slices' sums in slice
//   order, writes g2w and b2w, and resets the ticket for the next launch.
//
// No cluster barrier and no float atomic: the order of every sum depends
// only on the shapes and the plan, so the terms repeat bit for bit, eager
// or replayed in a CUDA graph, and one launch per forward stays one. The
// ticket and the slices' sums are the wrapper's per-shape buffers; launches
// that share them run on one stream, one after another.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tcn_block.cuh"

namespace tcn {

constexpr int FW_COLS = 64;                     // columns per CTA: 16 threads x 4
constexpr int FW_CTHREADS = FW_COLS / 4;        // column threads of a row lane
constexpr int FW_LANES = 16;                    // row lanes per CTA
constexpr int FW_THREADS = FW_CTHREADS * FW_LANES;
constexpr int FW_UNROLL = 4;                    // row loads in flight per thread
constexpr int FW_MIN_ROWS = FW_LANES * FW_UNROLL;  // rows of a slice, at least

struct FwArgs {
  const float* out_w;
  const float* g2;
  const float* b2;
  void* wp;
  float* g2w;
  float* b2w;
  float* part;        // [NB * tiles, splits, 2, FW_COLS] slice sums
  unsigned* ticket;   // [NB * tiles], zero between launches
  int H, B, splits, rows;  // rows per slice
};

__device__ __forceinline__ void store4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(bf16* p, const float4& v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T>
__device__ __forceinline__ void fold_weights_body(const FwArgs& a) {
  __shared__ float4 red[2][FW_THREADS];
  __shared__ bool last;
  const int tiles = a.B / FW_COLS;
  const int tile = blockIdx.x, nb = blockIdx.y, s = blockIdx.z;
  const int ct = threadIdx.x % FW_CTHREADS;
  const int lane = threadIdx.x / FW_CTHREADS;
  const int col = tile * FW_COLS + 4 * ct;
  const int r0 = s * a.rows;
  const int r1 = min(a.H, r0 + a.rows);
  const float* w = a.out_w + (size_t)nb * a.H * a.B + col;
  T* wp = static_cast<T*>(a.wp) + (size_t)nb * a.H * a.B + col;
  const float* gv = a.g2 + (size_t)nb * a.H;
  const float* bv = a.b2 + (size_t)nb * a.H;
  float4 sg = make_float4(0.f, 0.f, 0.f, 0.f), sb = sg;
  for (int h0 = r0 + lane; h0 < r1; h0 += FW_LANES * FW_UNROLL) {
    float4 x[FW_UNROLL];
    float g[FW_UNROLL], b[FW_UNROLL];
#pragma unroll
    for (int i = 0; i < FW_UNROLL; ++i) {
      const int h = h0 + i * FW_LANES;
      if (h < r1) {
        x[i] = __ldg(reinterpret_cast<const float4*>(w + (size_t)h * a.B));
        g[i] = __ldg(gv + h);
        b[i] = __ldg(bv + h);
      } else {
        x[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        g[i] = b[i] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < FW_UNROLL; ++i) {
      const int h = h0 + i * FW_LANES;
      const float4 r = make_float4(round_dt<T>(x[i].x), round_dt<T>(x[i].y),
                                   round_dt<T>(x[i].z), round_dt<T>(x[i].w));
      const float4 p = make_float4(g[i] * r.x, g[i] * r.y, g[i] * r.z, g[i] * r.w);
      if (h < r1) store4(wp + (size_t)h * a.B, p);
      sg.x += p.x;
      sg.y += p.y;
      sg.z += p.z;
      sg.w += p.w;
      sb.x += b[i] * r.x;
      sb.y += b[i] * r.y;
      sb.z += b[i] * r.z;
      sb.w += b[i] * r.w;
    }
  }
  red[0][threadIdx.x] = sg;
  red[1][threadIdx.x] = sb;
  __syncthreads();
  for (int h = FW_LANES / 2; h > 0; h >>= 1) {
    if (lane < h) {
      for (int k = 0; k < 2; ++k) {
        const float4 o = red[k][threadIdx.x + h * FW_CTHREADS];
        float4& r = red[k][threadIdx.x];
        r.x += o.x;
        r.y += o.y;
        r.z += o.z;
        r.w += o.w;
      }
    }
    __syncthreads();
  }
  const size_t out = (size_t)nb * a.B + col;
  if (a.splits == 1) {
    if (lane == 0) {
      store4(a.g2w + out, red[0][ct]);
      store4(a.b2w + out, red[1][ct]);
    }
    return;
  }
  // This slice's sums, then the ticket of the column tile.
  const int t = nb * tiles + tile;
  float* part = a.part + (size_t)t * a.splits * 2 * FW_COLS;
  if (lane == 0) {
    store4(part + ((size_t)s * 2 + 0) * FW_COLS + 4 * ct, red[0][ct]);
    store4(part + ((size_t)s * 2 + 1) * FW_COLS + 4 * ct, red[1][ct]);
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.ticket + t, 1u) == (unsigned)(a.splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (lane == 0) {
    // every slice's sums, in slice order
    float4 g = make_float4(0.f, 0.f, 0.f, 0.f), b = g;
    for (int k = 0; k < a.splits; ++k) {
      const float4 u = __ldcg(reinterpret_cast<const float4*>(part + ((size_t)k * 2 + 0) * FW_COLS + 4 * ct));
      const float4 v = __ldcg(reinterpret_cast<const float4*>(part + ((size_t)k * 2 + 1) * FW_COLS + 4 * ct));
      g.x += u.x;
      g.y += u.y;
      g.z += u.z;
      g.w += u.w;
      b.x += v.x;
      b.y += v.y;
      b.z += v.z;
      b.w += v.w;
    }
    store4(a.g2w + out, g);
    store4(a.b2w + out, b);
    if (ct == 0) a.ticket[t] = 0u;
  }
}

template <typename T>
__global__ void __launch_bounds__(FW_THREADS, 4) fold_weights_kernel(const FwArgs a) {
  fold_weights_body<T>(a);
}

// The skip mode (out_w = [out_w | skip_w], the paper's final version): the
// same work under a name of its own, so that its records can be told apart.
template <typename T>
__global__ void __launch_bounds__(FW_THREADS, 4) fold_weights_skip_kernel(const FwArgs a) {
  fold_weights_body<T>(a);
}

template <typename T, bool SKIP = false>
static cudaError_t fold_weights(const FwArgs& a, int NB, cudaStream_t s) {
  if (NB < 1 || a.H < 1 || a.B < FW_COLS || a.B % FW_COLS || a.splits < 1 || a.rows < 1 ||
      (long long)a.splits * a.rows < a.H || (a.splits > 1 && (!a.part || !a.ticket)) ||
      reinterpret_cast<uintptr_t>(a.out_w) % 16 || reinterpret_cast<uintptr_t>(a.wp) % 16 ||
      reinterpret_cast<uintptr_t>(a.g2w) % 16 || reinterpret_cast<uintptr_t>(a.b2w) % 16)
    return cudaErrorInvalidValue;
  dim3 grid(a.B / FW_COLS, NB, a.splits);
  if constexpr (SKIP)
    fold_weights_skip_kernel<T><<<grid, FW_THREADS, 0, s>>>(a);
  else
    fold_weights_kernel<T><<<grid, FW_THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

// CTAs of fold_weights_kernel<T> resident per SM.
template <typename T>
static int fold_weights_resident() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fold_weights_kernel<T>, FW_THREADS, 0) !=
      cudaSuccess)
    return -1;
  return n;
}

}  // namespace tcn
