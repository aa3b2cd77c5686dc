// KF tcn_bwd_finish: the last step of one block's backward. It sums the
// f32 partials that KB1, KW (both forms), KB2 and KB3 write over their
// first axis and stores the nine finished weight gradients into row nb of
// the stacked [NB, ...] f32 gradients:
//
//   din_w  = sum_s KW din [s, B, H]      dout_w = sum_s KW z [s, H, B]
//   dw     = sum_t KB2 chpart[t, 0:P, H]  dg1 = sum_t chpart[t, P, H]
//   db1    = sum_t chpart[t, P + 1, H]    dg2 / db2 = sum_t KB1 colpart[t, 0 / 1, H]
//   da1    = sum_t KB3 da1part[t]         da2 = sum_t KB2 da2part[t]
//
// The TPU kernels (convtasnet_tpu/ops/pallas/whole_tcn_hybrid.py:161-233,
// ops/pallas/whole_block_vjp.py:182-282) add these into f32 accumulators
// that stay resident across their sequential batch grid; here the CTAs of
// the producing kernels run in no order, so each wrote its own partial and
// this kernel finishes the sums.
//
// Every output column is one job's column: a job is a [parts, stride]
// array of partials whose columns [0, cols) are summed into dst. A CTA
// covers `cw` columns of one job with FIN_THREADS / cw lanes over the
// parts: lane l sums parts l, l + lanes, ... in order, then the lanes are
// added by a fixed shared-memory tree. The columns per CTA are chosen per
// job so that a thread sums at most FIN_PARTS partials (tall jobs get many
// lanes, wide ones many columns), and a job narrower than a CTA gets
// narrower CTAs; so every reduction is spread over the grid. No float
// atomic is used, and the order of every sum depends only on the shapes:
// the gradients repeat bit for bit, eager or replayed in a CUDA graph.
//
// The partials are f32 whatever the activation type, so one kernel serves
// the f32 and the bf16 chains.
#pragma once

#include <cstddef>

#include <cuda_runtime.h>

namespace tcn {

constexpr int FIN_THREADS = 256;
constexpr int FIN_JOBS = 9;
// Partials summed serially by one thread, at most. In the graphed train
// step the partials come from device memory (KB2 and KB3 run between KW z
// and KF), so the tall jobs are latency-bound: 4 took KF from 0.322 to
// 0.278 ms per step against 16, where unrolling by 16 did nothing (H100,
// tools/profile_forward.py --train in turns).
constexpr int FIN_PARTS = 4;

struct FinJob {
  const float* src;  // part p, column j at src[p * stride + j]
  float* dst;        // column j at dst[j]
  int parts, stride, cols;
  int cw_log2;       // 1 << cw_log2 columns per CTA
  int first;         // the job's first CTA
};

struct FinArgs {
  FinJob job[FIN_JOBS];
  int n_jobs;
};

__global__ void __launch_bounds__(FIN_THREADS) bwd_finish_kernel(FinArgs a) {
  __shared__ float red[FIN_THREADS];
  // The job of this CTA (jobs in CTA order); constant indices only, so the
  // arguments stay in the parameter space.
  FinJob jb = a.job[0];
#pragma unroll
  for (int i = 1; i < FIN_JOBS; ++i)
    if (i < a.n_jobs && (int)blockIdx.x >= a.job[i].first) jb = a.job[i];
  const int cw = 1 << jb.cw_log2;
  const int lanes = FIN_THREADS >> jb.cw_log2;
  const int lane = threadIdx.x >> jb.cw_log2;
  const int col = ((int)blockIdx.x - jb.first) * cw + (threadIdx.x & (cw - 1));
  float s = 0.f;
  if (col < jb.cols) {
    const float* p = jb.src + col;
#pragma unroll 4
    for (int q = lane; q < jb.parts; q += lanes) s += __ldg(p + (size_t)q * jb.stride);
  }
  red[threadIdx.x] = s;
  __syncthreads();
  // Lane l's value of column c sits at red[l * cw + c]: halve the lanes.
  for (int h = lanes >> 1; h > 0; h >>= 1) {
    if (lane < h) red[threadIdx.x] += red[threadIdx.x + h * cw];
    __syncthreads();
  }
  if (lane == 0 && col < jb.cols) jb.dst[col] = red[threadIdx.x];
}

// Columns per CTA (log2) of a job: lanes enough that no thread sums more
// than FIN_PARTS partials, the rest of the CTA's threads over columns, and
// no more columns than the job has (rounded up to a power of two).
inline int fin_cw_log2(int parts, int cols) {
  int lanes = 1;
  while (lanes < FIN_THREADS && lanes * FIN_PARTS < parts) lanes *= 2;
  int cw = FIN_THREADS / lanes;
  while (cw > 1 && cw / 2 >= cols) cw /= 2;
  int l = 0;
  while ((1 << l) < cw) ++l;
  return l;
}

// Appends a job; returns false on a bad shape.
inline bool fin_add(FinArgs* a, int* ctas, const float* src, int parts, int stride, int cols,
                    float* dst) {
  if (!src || !dst || parts < 1 || cols < 1 || stride < cols || a->n_jobs >= FIN_JOBS)
    return false;
  FinJob& j = a->job[a->n_jobs++];
  j.src = src;
  j.dst = dst;
  j.parts = parts;
  j.stride = stride;
  j.cols = cols;
  j.cw_log2 = fin_cw_log2(parts, cols);
  j.first = *ctas;
  const int cw = 1 << j.cw_log2;
  *ctas += (cols + cw - 1) / cw;
  return true;
}

}  // namespace tcn
