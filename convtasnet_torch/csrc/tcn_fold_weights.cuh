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
// A CTA takes FW_COLS columns of one block: its 32 column threads read two
// adjacent columns each (a warp reads 256 contiguous bytes of a row), and
// its FW_LANES warps split H, warp l taking rows l, l + FW_LANES, ... in
// order; the warps' sums are then added by a fixed shared-memory tree. The
// order of every sum depends only on the shapes: the terms repeat bit for
// bit, eager or replayed in a CUDA graph. Bound on the H100 by bytes: at
// the paper config (NB=32, H=512, B=256) 16.8 MB of f32 weights read and
// 8.4 MB of bf16 operand written, 7.6 us at 3.35 TB/s, against 5 flops per
// weight; so the design reads each weight once, in 256-byte rows per warp,
// with no tensor core and no TMA.
#pragma once

#include <cstddef>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tcn_block.cuh"

namespace tcn {

constexpr int FW_LANES = 16;               // warps per CTA, each a slice of H
constexpr int FW_THREADS = 32 * FW_LANES;
constexpr int FW_COLS = 64;                // columns per CTA: 32 threads x 2

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(FW_THREADS)
fold_weights_kernel(const float* __restrict__ out_w, const float* __restrict__ g2,
                    const float* __restrict__ b2, T* __restrict__ wp, float* __restrict__ g2w,
                    float* __restrict__ b2w, int H, int B) {
  __shared__ float4 red[FW_THREADS];
  const int nb = blockIdx.y;
  const int ct = threadIdx.x & 31;
  const int lane = threadIdx.x >> 5;
  const int col = blockIdx.x * FW_COLS + 2 * ct;
  const size_t base = (size_t)nb * H * B + col;
  const float* gv = g2 + (size_t)nb * H;
  const float* bv = b2 + (size_t)nb * H;
  float sg0 = 0.f, sg1 = 0.f, sb0 = 0.f, sb1 = 0.f;
#pragma unroll 8
  for (int h = lane; h < H; h += FW_LANES) {
    const size_t at = base + (size_t)h * B;
    const float2 w = __ldg(reinterpret_cast<const float2*>(out_w + at));
    const float w0 = round_dt<T>(w.x), w1 = round_dt<T>(w.y);
    const float g = __ldg(gv + h), b = __ldg(bv + h);
    store2(wp + at, g * w0, g * w1);
    sg0 += g * w0;
    sg1 += g * w1;
    sb0 += b * w0;
    sb1 += b * w1;
  }
  red[threadIdx.x] = make_float4(sg0, sg1, sb0, sb1);
  __syncthreads();
  for (int s = FW_LANES / 2; s > 0; s >>= 1) {
    if (lane < s) {
      const float4 o = red[threadIdx.x + s * 32];
      float4& r = red[threadIdx.x];
      r.x += o.x;
      r.y += o.y;
      r.z += o.z;
      r.w += o.w;
    }
    __syncthreads();
  }
  if (lane == 0) {
    const float4 r = red[ct];
    const size_t at = (size_t)nb * B + col;
    g2w[at] = r.x;
    g2w[at + 1] = r.y;
    b2w[at] = r.z;
    b2w[at + 1] = r.w;
  }
}

template <typename T>
static cudaError_t fold_weights(const float* out_w, const float* g2, const float* b2, void* wp,
                                float* g2w, float* b2w, int NB, int H, int B, cudaStream_t s) {
  if (NB < 1 || H < 1 || B < FW_COLS || B % FW_COLS) return cudaErrorInvalidValue;
  dim3 grid(B / FW_COLS, NB);
  fold_weights_kernel<T><<<grid, FW_THREADS, 0, s>>>(out_w, g2, b2, static_cast<T*>(wp), g2w,
                                                     b2w, H, B);
  return cudaGetLastError();
}

}  // namespace tcn
