// Shared definitions of the TCN-block kernels (tcn_block.cu).
//
// Tile sizes are mirrored in convtasnet_torch/ops/kernels/tcn_block.py,
// which checks every shape against them before a launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tcn {

constexpr int BM = 64;            // GEMM rows (frames) per CTA
constexpr int BN = 128;           // GEMM output columns per CTA
constexpr int BK = 32;            // GEMM depth per main-loop step
constexpr int GEMM_THREADS = 256;
constexpr int DW_ROWS = 32;       // depthwise-kernel rows per CTA
constexpr int DW_THREADS = 256;
constexpr float EPS = 1e-8f;      // inside the power, as the reference

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// Rounds v to the activation type and back: the dt rounding points of the
// JAX kernels (y1, b, e, o and the residual sum).
template <typename T> __device__ __forceinline__ float round_dt(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float prelu(float v, float alpha) {
  return v >= 0.f ? v : alpha * v;
}

// Sum of (a, b) over the CTA in a fixed order (xor-shuffle tree inside each
// warp, then warp totals in index order), so results repeat bit for bit.
// `red` holds one float2 per warp. The total is returned to every thread.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
  const int nw = blockDim.x >> 5;
  for (int i = 0; i < nw; ++i) {
    t.x += red[i].x;
    t.y += red[i].y;
  }
  __syncthreads();  // red may be reused right after
  return t;
}

// Sum of n (sum, sum of squares) partials, stride 2 floats, over the CTA.
__device__ __forceinline__ float2 reduce_partials(const float* p, int n, float2* red) {
  float s = 0.f, ss = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s += p[2 * i];
    ss += p[2 * i + 1];
  }
  return block_sum2(s, ss, red);
}

// (mean, 1/sqrt(var + EPS)) from a sum and a sum of squares over n values:
// one-pass variance clamped at 0, as whole_tcn's gLN.
__device__ __forceinline__ float2 moments(float s, float ss, float n) {
  const float mean = s / n;
  const float var = fmaxf(ss / n - mean * mean, 0.f);
  return make_float2(mean, 1.f / sqrtf(var + EPS));
}

}  // namespace tcn
