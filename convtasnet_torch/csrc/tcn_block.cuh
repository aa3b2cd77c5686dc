// Shared definitions of the TCN-block kernels (tcn_block.cu, the forward,
// and tcn_block_bwd.cu, the backward).
//
// Tile sizes are mirrored in convtasnet_torch/ops/kernels/tcn_block.py,
// which checks every shape against them before a launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tcn {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;            // GEMM rows (frames) per CTA
constexpr int BN = 128;           // GEMM output columns per CTA
constexpr int BK = 32;            // GEMM depth per main-loop step
constexpr int GEMM_THREADS = 256;
constexpr int DW_THREADS = 256;   // K2 / KB2 threads per CTA (tile rows: dw_plan)
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

__device__ __forceinline__ float dprelu(float v, float alpha) {
  return v >= 0.f ? 1.f : alpha;
}

// Sum of n (a, b) pairs in index order (per-row partials).
__device__ __forceinline__ float2 sum_pairs(const float* p, int n) {
  float s = 0.f, ss = 0.f;
  for (int i = 0; i < n; ++i) {
    s += p[2 * i];
    ss += p[2 * i + 1];
  }
  return make_float2(s, ss);
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

template <typename T> struct Tiles {
  static constexpr int PAD = 16 / sizeof(T);  // keeps 16-byte row alignment
  static constexpr int LDA = BK + PAD;
  static constexpr int LDB = BN + PAD;
  static constexpr int LDC = BN + 4;
  static constexpr int AB_BYTES = (BM * LDA + BK * LDB) * sizeof(T);
  static constexpr int C_BYTES = BM * LDC * sizeof(float);
  static constexpr int BYTES = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;
  static constexpr int VEC = 16 / sizeof(T);
};

// Accumulates the CTA's [BM, BN] tile of A @ W into Cs (f32, row stride
// LDC), from As [BM, BK] (row stride LDA) and Bs [BK, BN] (row stride LDB):
// SIMT FMA, each thread 4 rows x 8 columns. f32 only: every bf16 GEMM runs
// on the wgmma pipelines (tcn_gemm_sm90.cuh, tcn_wgrad_sm90.cuh).
template <typename T> struct TileMma;

template <> struct TileMma<float> {
  using Tl = Tiles<float>;
  float acc[4][8];
  __device__ void init() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  __device__ void step(const float* As, const float* Bs) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[(ty * 4 + i) * Tl::LDA + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[kk * Tl::LDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __device__ void store(float* Cs) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) Cs[(ty * 4 + i) * Tl::LDC + tx + 16 * j] = acc[i][j];
  }
};

}  // namespace tcn
