// KF tcn_bwd_finish: the last step of the backward of a group of blocks.
// Each block's backward leaves f32 partials in its slot of the group's
// buffers (KB1, KW in both forms, KB2 and KB3 write them there); one
// launch sums every slot's partials over their first axis and stores the
// nine finished weight gradients of slot j into row nb0 + j of the stacked
// [NB, ...] f32 gradients:
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
// The work is bound by the bytes of the partials (about 9 MB per block at
// the paper config, batch 5 x 4 s). One launch per block spent as long in
// its ramp and tail as in those bytes, so a launch takes a group of blocks
// (tcn_block_bwd.finish_group: 32 at the paper config, one launch per
// step) and its grid covers every SM for the whole launch: CTAs resident
// on every SM loop over the group's units of work, each a tile of columns
// of one gradient of one slot. A thread of a unit loads FIN_PARTS partials
// of its columns before it adds any (16-byte loads where the columns
// allow), so a CTA has up to 32 KB in flight and an SM several CTAs' worth:
// Little's law asks for ~3.35 TB/s x ~1 us / 132 SMs, ~25 KB per SM.
//
// A unit's CTA splits its columns over cw threads and the partials over
// 256 / cw lanes: lane l sums parts l, l + lanes, ... in order, and the
// lanes are added by a fixed shared-memory tree. The lanes are chosen from
// the most partials any slot of the chain holds (`cap`, fixed by the
// shapes), so that no thread loads more than FIN_PARTS of them per round.
// No float atomic is used, and the order of every sum depends only on the
// shapes, not on the group or the grid: the gradients repeat bit for bit,
// eager or replayed in a CUDA graph, whatever the group size.
//
// The partials are f32 whatever the activation type, so one kernel serves
// the f32 and the bf16 chains.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace tcn {

constexpr int FIN_THREADS = 256;
constexpr int FIN_KINDS = 9;      // the nine weight gradients of a block
constexpr int FIN_MAX_GROUP = 64;  // slots of one launch (kernel parameters)
constexpr int FIN_PARTS = 8;      // partials a thread loads before it adds

// One weight gradient over the group's slots. The host fills the first
// seven fields and `parts`; tcn_bwd_finish plans the rest.
struct FinKind {
  const float* src;  // slot j, part p, column c at src[j * slot + p * stride + c]
  float* dst;        // slot j's column c at dst[j * row + c]
  long long slot, row;
  int stride, cols;
  int cap;           // the most parts any slot of the chain holds
  int vec;           // columns taken four at a time (16-byte loads)
  int lanes_log2, cw_log2;  // lanes over the parts, threads over the columns
  int units;         // units of work per slot
  int first;         // the kind's first unit
  int parts[FIN_MAX_GROUP];  // parts of slot j
};

struct FinGroup {
  FinKind kind[FIN_KINDS];
  int n;      // slots in use
  int units;  // units of work in all
};

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__device__ __forceinline__ void bwd_finish_body(const FinGroup& g) {
  __shared__ float4 red[FIN_THREADS];
  for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
    int k = 0;
#pragma unroll
    for (int i = 1; i < FIN_KINDS; ++i)
      if (u >= g.kind[i].first) k = i;
    const FinKind& kd = g.kind[k];
    const int v = u - kd.first;
    const int j = v / kd.units;
    const int cw = 1 << kd.cw_log2;
    const int lanes = 1 << kd.lanes_log2;
    const int lane = threadIdx.x >> kd.cw_log2;
    const int col = ((v - j * kd.units) * cw + (threadIdx.x & (cw - 1))) * (kd.vec ? 4 : 1);
    const int parts = kd.parts[j];
    const bool ok = col < kd.cols;
    const float* src = kd.src + (size_t)j * kd.slot + col;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q0 = lane; q0 < parts; q0 += lanes * FIN_PARTS) {
      float4 x[FIN_PARTS];
#pragma unroll
      for (int i = 0; i < FIN_PARTS; ++i) {
        const int q = q0 + i * lanes;
        x[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok && q < parts) {
          const float* p = src + (size_t)q * kd.stride;
          if (kd.vec)
            x[i] = __ldcs(reinterpret_cast<const float4*>(p));
          else
            x[i].x = __ldcs(p);
        }
      }
#pragma unroll
      for (int i = 0; i < FIN_PARTS; ++i) add4(acc, x[i]);
    }
    if (lanes > 1) {
      // Lane l's value of column c sits at red[l * cw + c]: halve the lanes.
      red[threadIdx.x] = acc;
      __syncthreads();
      for (int h = lanes >> 1; h > 0; h >>= 1) {
        if (lane < h) add4(red[threadIdx.x], red[threadIdx.x + h * cw]);
        __syncthreads();
      }
      acc = red[threadIdx.x];
    }
    if (lane == 0 && ok) {
      float* d = kd.dst + (size_t)j * kd.row + col;
      if (kd.vec)
        *reinterpret_cast<float4*>(d) = acc;
      else
        *d = acc.x;
    }
  }
}

__global__ void __launch_bounds__(FIN_THREADS) bwd_finish_kernel(const __grid_constant__ FinGroup g) {
  bwd_finish_body(g);
}

// A chain with a skip path (dout_w = d[out_w | skip_w]): the same sums under
// a name of their own, so that their records can be told apart.
__global__ void __launch_bounds__(FIN_THREADS)
    bwd_finish_skip_kernel(const __grid_constant__ FinGroup g) {
  bwd_finish_body(g);
}

inline int fin_log2(int x) {
  int l = 0;
  while ((2 << l) <= x) ++l;
  return l;
}

// Plans one kind: 16-byte columns where the strides and pointers allow;
// lanes enough that no thread loads more than FIN_PARTS of `cap` partials
// per round; the rest of the CTA's threads over the columns, and no more
// threads over the columns than the kind has (rounded up to a power of
// two). Returns false on a bad shape.
inline bool fin_plan(FinKind& k, int n) {
  if (!k.src || !k.dst || k.cols < 1 || k.stride < k.cols || k.cap < 1) return false;
  for (int j = 0; j < n; ++j)
    if (k.parts[j] < 1 || k.parts[j] > k.cap) return false;
  k.vec = k.cols % 4 == 0 && k.stride % 4 == 0 && k.slot % 4 == 0 && k.row % 4 == 0 &&
          reinterpret_cast<uintptr_t>(k.src) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(k.dst) % 16 == 0;
  const int vcols = k.vec ? k.cols / 4 : k.cols;
  int lanes = 1;
  while (lanes < FIN_THREADS && lanes * FIN_PARTS < k.cap) lanes *= 2;
  int cw = FIN_THREADS / lanes;
  while (cw > 1 && cw / 2 >= vcols) cw /= 2;
  k.cw_log2 = fin_log2(cw);
  k.lanes_log2 = fin_log2(FIN_THREADS / cw);
  k.units = (vcols + cw - 1) / cw;
  return true;
}

}  // namespace tcn
