// Hopper kernels of the backward of one Conv-TasNet temporal block (sm_90a).
//
// Forward of the block (tcn_block.cu), with a = PReLU1(y1), b = norm1(a)
// (rows outside [0, K) zero), c = dwconv(b), e = PReLU2(c),
// z = norm2(e) and out = x + z @ out_w. Given the upstream cotangent g
// [rows, B], the block input x, y1 and the norm1 partials (K1 rerun on x),
// the saved c and the norm2 partials (K2 in save mode), one block's
// backward is five launches:
//
//   KB1 tcn_bwd_dz      dz = round(g @ out_w^T) (g rows >= K read as 0);
//                       epilogue: e, ehat from c; per-tile column partials
//                       of dg2 = sum dz*ehat and db2 = sum dz; partials of
//                       the norm2 backward sums sum dz*g2 and sum dz*g2*ehat
//                       (per item for gLN, per row for cLN)
//   KW  tcn_wgrad (z)   dout_w = z^T g, z = round(g2*ehat + b2) formed from
//                       c; split over ranges of rows
//   KB2 tcn_bwd_dwconv  de = round(inv2*(dz*g2 - mean(dz*g2)
//                       - ehat*mean(dz*g2*ehat))), dc = round(de*PReLU2'(c))
//                       (converted once per row of the strip's ring), the
//                       depthwise transpose db[j] = round(sum_p w[p]*
//                       dc[j+left-p*d]), partials of dw[p] = sum_j b[j]*
//                       dc[j+left-p*d] (b from the own rows of y1), dg1, db1,
//                       d_alpha2 and of the norm1 backward sums
//   KB3 tcn_bwd_dx      da and dy1 = round(da*PReLU1'(y1)) formed in the
//                       A-operand prologue (stored, with the d_alpha1
//                       partials), dx = round(round(dy1 @ in_w^T) + g), rows
//                       >= K exactly zero
//   KW  tcn_wgrad       din_w = x^T dy1, split over ranges of rows
//
// each writing its weight-gradient partials into the block's slot of its
// group's buffers; then KF tcn_bwd_finish (tcn_bwd_finish.cuh) sums every
// slot's partials of a group of blocks into their rows of the stacked f32
// gradients, one launch per group.
//
// Replaces the TPU kernels convtasnet_tpu/ops/pallas/whole_tcn_hybrid.py
// (_bwd_block_kernel, :64) and ops/pallas/whole_block_vjp.py (_bwd_kernel,
// :69). Those hold a whole item's [K, H] slabs in VMEM and carry the f32
// weight-gradient sums across the sequential grid; an SM has 227 KB and
// CTAs run in no order, so here the block's backward passes dz, db and dy1
// [rows, H] through device memory, every cross-CTA sum (the gLN backward
// means over all K*H elements of an item, the weight gradients over all
// M*K rows) is written as per-tile partials that the next kernel or KF
// sums in a fixed order, and no float atomic is used: gradients repeat bit
// for bit.
//
// Rounding points follow the TPU kernel: the wide streams dz, de, dc, db,
// da, dy1 and dx are rounded to the activation type; statistics,
// reductions, GEMM accumulators and parameter gradients are f32; EPS sits
// inside the rsqrt; PReLU and its derivative compare in f32; rows >= K of
// c, g, de, db, da and dx are masked where the TPU kernel masks them.
//
// Bound on the H100 at the paper config, batch 5 (16,000 rows): every
// launch is bound by device-memory bytes (KB1 ~41 MB, KB2 ~66 MB, KB3
// ~57 MB at 3.35 TB/s, against 8.4 GFLOP per GEMM pair at 989 TFLOP/s).
// KB1 and KB3 in bf16 run on the TMA + wgmma pipeline of tcn_gemm_sm90.cuh
// (modes H_DZ and H_DX: KB1 prefetches c into the epilogue's tile and
// reduces its column partials from the accumulator registers; one KB3 CTA
// covers all B columns of its rows, so dy1 is formed once per row), KW in
// bf16 on its own TMA + wgmma kernel (tcn_wgrad_sm90.cuh: reduction over
// the rows, split partials summed inside a cluster). In f32, KB1, KB3 and
// KW keep the SIMT shared-memory tiles of the forward, with no pipeline.
// KB2, in both types, is the streaming stencil of tcn_dwconv_sm90.cuh: one
// producer warp feeds a ring of TMA stages down a strip of rows.
#include <cstdint>
#include <type_traits>

#include "tcn_block.cuh"
#include "tcn_bwd_finish.cuh"
#include "tcn_dwconv_sm90.cuh"
#include "tcn_gemm_sm90.cuh"
#include "tcn_wgrad_sm90.cuh"

namespace tcn {

constexpr int MAX_CHUNK = 1024;   // rows per split of tcn_wgrad

// ---------------------------------------------------------------------------
// KB1 in f32: dz = round(g @ out_w^T) with the norm2-backward partials
// (bf16 KB1 is hgemm_kernel in H_DZ mode). Grid (rows / BM, H / BN),
// GEMM_THREADS threads.
// ---------------------------------------------------------------------------
struct DzArgs {
  const void* g;         // [rows, B] upstream cotangent
  const void* wt;        // out_w^T [B, H], activation type
  const void* c;         // saved conv output [rows, H]
  const float* stats2;   // K2 partials of e: n2 pairs per item (gLN) / row (cLN)
  int n2;
  const float* alpha2;
  const float* g2;       // [H]
  void* dz;              // [rows, H]
  float* colpart;        // [rows / BM, 2, H]: sum dz*ehat, sum dz over the tile
  float* npart;          // gLN [rows / BM * H / BN] pairs; cLN [rows, H / BN] pairs
  int kpad, k_valid, B, H, gln;
};

template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS) bwd_dz_kernel(DzArgs g) {
  static_assert(std::is_same<T, float>::value, "bf16 KB1 runs on the wgmma pipeline");
  using Tl = Tiles<T>;
  constexpr int VEC = Tl::VEC;
  constexpr int NW = GEMM_THREADS / 32;
  __shared__ __align__(128) unsigned char smem[Tl::BYTES];
  __shared__ float2 red[NW];
  __shared__ float2 rowmom[BM];
  __shared__ float2 colred[NW][BN];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + BM * Tl::LDA;
  float* Cs = reinterpret_cast<float*>(smem);

  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int item = row0 / g.kpad;
  if (g.gln) {
    const float2 t = reduce_partials(g.stats2 + 2 * (size_t)item * g.n2, g.n2, red);
    const float2 mm = moments(t.x, t.y, (float)g.k_valid * (float)g.H);
    for (int r = threadIdx.x; r < BM; r += blockDim.x) rowmom[r] = mm;
  } else {
    for (int r = threadIdx.x; r < BM; r += blockDim.x) {
      const float2 t = sum_pairs(g.stats2 + 2 * (size_t)(row0 + r) * g.n2, g.n2);
      rowmom[r] = moments(t.x, t.y, (float)g.H);
    }
  }
  __syncthreads();

  const T* A = static_cast<const T*>(g.g);
  const T* W = static_cast<const T*>(g.wt);
  TileMma<T> mma;
  mma.init();
  for (int k0 = 0; k0 < g.B; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK / VEC; i += blockDim.x) {
      const int r = i / (BK / VEC), cv = (i % (BK / VEC)) * VEC;
      const int grow = row0 + r;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (grow % g.kpad < g.k_valid)  // upstream rows >= K are meaningless
        u = *reinterpret_cast<const uint4*>(A + (size_t)grow * g.B + k0 + cv);
      *reinterpret_cast<uint4*>(As + r * Tl::LDA + cv) = u;
    }
    for (int i = threadIdx.x; i < BK * BN / VEC; i += blockDim.x) {
      const int r = i / (BN / VEC), cv = (i % (BN / VEC)) * VEC;
      *reinterpret_cast<uint4*>(Bs + r * Tl::LDB + cv) =
          *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * g.H + col0 + cv);
    }
    __syncthreads();
    mma.step(As, Bs);
    __syncthreads();
  }
  mma.store(Cs);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* cin = static_cast<const T*>(g.c);
  T* dz = static_cast<T*>(g.dz);
  const float a2 = *g.alpha2;
  float cdze[BN / 32], cdz[BN / 32];
#pragma unroll
  for (int j = 0; j < BN / 32; ++j) cdze[j] = cdz[j] = 0.f;
  float ts = 0.f, tss = 0.f;
  for (int r = warp; r < BM; r += NW) {
    const size_t grow = (size_t)row0 + r;
    const bool valid = (int)(grow % g.kpad) < g.k_valid;
    const float2 mm = rowmom[r];
    float rs = 0.f, rss = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      const int col = col0 + lane + 32 * j;
      const size_t idx = grow * g.H + col;
      const float d = valid ? round_dt<T>(Cs[r * Tl::LDC + lane + 32 * j]) : 0.f;
      dz[idx] = from_f<T>(d);
      const float cf = valid ? to_f(cin[idx]) : 0.f;  // stored c pad rows are unmasked
      const float ehat = (prelu(cf, a2) - mm.x) * mm.y;
      cdze[j] += d * ehat;
      cdz[j] += d;
      const float dzg = d * g.g2[col];
      rs += dzg;
      rss += dzg * ehat;
    }
    if (g.gln) {
      ts += rs;
      tss += rss;
    } else {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
        rss += __shfl_xor_sync(0xffffffffu, rss, off);
      }
      if (lane == 0) {
        float* p = g.npart + 2 * (grow * gridDim.y + blockIdx.y);
        p[0] = rs;
        p[1] = rss;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < BN / 32; ++j) colred[warp][lane + 32 * j] = make_float2(cdze[j], cdz[j]);
  if (g.gln) {
    const float2 t = block_sum2(ts, tss, red);  // syncs: colred is complete after it
    if (threadIdx.x == 0) {
      float* p = g.npart + 2 * ((size_t)blockIdx.x * gridDim.y + blockIdx.y);
      p[0] = t.x;
      p[1] = t.y;
    }
  } else {
    __syncthreads();
  }
  for (int cc = threadIdx.x; cc < BN; cc += blockDim.x) {
    float s = 0.f, s1 = 0.f;
    for (int w = 0; w < NW; ++w) {
      s += colred[w][cc].x;
      s1 += colred[w][cc].y;
    }
    float* p = g.colpart + (size_t)blockIdx.x * 2 * g.H + col0 + cc;
    p[0] = s;
    p[g.H] = s1;
  }
}

// ---------------------------------------------------------------------------
// KW in f32: part[split] = A^T @ Bm over one chunk of rows (bf16 KW is
// wgrad_sm90_kernel, tcn_wgrad_sm90.cuh).
// Grid (n1 / BM, n2 / BN, rows / chunk), GEMM_THREADS threads; chunk is a
// multiple of BK that divides kpad, so a chunk lies in one batch item.
// ZMODE: A is the saved c and the operand is z = round(g2*ehat + b2).
// Bm rows >= K are read as zero.
// ---------------------------------------------------------------------------
struct WgArgs {
  const void* A;         // [rows, n1]
  const void* Bm;        // [rows, n2]
  float* part;           // [rows / chunk, n1, n2]
  const float* stats2;   // ZMODE: K2 partials (norm2 moments)
  int n2s;
  const float* alpha2;
  const float* g2;       // ZMODE: [n1]
  const float* b2;       // ZMODE: [n1]
  int kpad, k_valid, n1, n2, chunk, gln;
};

template <typename T, bool ZMODE>
__global__ void __launch_bounds__(GEMM_THREADS) wgrad_kernel(WgArgs g) {
  static_assert(std::is_same<T, float>::value, "bf16 KW runs on wgrad_sm90_kernel");
  using Tl = Tiles<T>;
  constexpr int VEC = Tl::VEC;
  __shared__ __align__(128) unsigned char smem[Tl::BYTES];
  __shared__ float2 red[GEMM_THREADS / 32];
  __shared__ float2 rowmom[ZMODE ? MAX_CHUNK : 1];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + BM * Tl::LDA;
  float* Cs = reinterpret_cast<float*>(smem);

  const int i0 = blockIdx.x * BM, j0 = blockIdx.y * BN;
  const size_t rbase = (size_t)blockIdx.z * g.chunk;
  const int item = (int)(rbase / g.kpad);
  float a2 = 0.f;
  if (ZMODE) {
    a2 = *g.alpha2;
    if (g.gln) {
      const float2 t = reduce_partials(g.stats2 + 2 * (size_t)item * g.n2s, g.n2s, red);
      const float2 mm = moments(t.x, t.y, (float)g.k_valid * (float)g.n1);
      for (int r = threadIdx.x; r < g.chunk; r += blockDim.x) rowmom[r] = mm;
    } else {
      for (int r = threadIdx.x; r < g.chunk; r += blockDim.x) {
        const float2 t = sum_pairs(g.stats2 + 2 * (rbase + r) * g.n2s, g.n2s);
        rowmom[r] = moments(t.x, t.y, (float)g.n1);
      }
    }
    __syncthreads();
  }

  const T* A = static_cast<const T*>(g.A);
  const T* Bm = static_cast<const T*>(g.Bm);
  TileMma<T> mma;
  mma.init();
  for (int k0 = 0; k0 < g.chunk; k0 += BK) {
    // A^T tile: As[i][r] = A[row r][i0 + i] (transposed in the store).
    for (int t = threadIdx.x; t < BK * BM / VEC; t += blockDim.x) {
      const int r = t / (BM / VEC), iv = (t % (BM / VEC)) * VEC;
      const size_t grow = rbase + k0 + r;
      uint4 u = *reinterpret_cast<const uint4*>(A + grow * g.n1 + i0 + iv);
      T* v = reinterpret_cast<T*>(&u);
      if (ZMODE) {
        const float2 mm = rowmom[k0 + r];
        const bool valid = (int)(grow % g.kpad) < g.k_valid;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const int ch = i0 + iv + j;
          const float cf = valid ? to_f(v[j]) : 0.f;
          v[j] = from_f<T>(g.g2[ch] * ((prelu(cf, a2) - mm.x) * mm.y) + g.b2[ch]);
        }
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) As[(iv + j) * Tl::LDA + r] = v[j];
    }
    for (int t = threadIdx.x; t < BK * BN / VEC; t += blockDim.x) {
      const int r = t / (BN / VEC), cv = (t % (BN / VEC)) * VEC;
      const size_t grow = rbase + k0 + r;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if ((int)(grow % g.kpad) < g.k_valid)
        u = *reinterpret_cast<const uint4*>(Bm + grow * g.n2 + j0 + cv);
      *reinterpret_cast<uint4*>(Bs + r * Tl::LDB + cv) = u;
    }
    __syncthreads();
    mma.step(As, Bs);
    __syncthreads();
  }
  mma.store(Cs);
  __syncthreads();
  float* out = g.part + (size_t)blockIdx.z * g.n1 * g.n2;
  for (int t = threadIdx.x; t < BM * BN; t += blockDim.x) {
    const int r = t / BN, cc = t % BN;
    out[(size_t)(i0 + r) * g.n2 + j0 + cc] = Cs[r * Tl::LDC + cc];
  }
}

// ---------------------------------------------------------------------------
// KB3 in f32: dx = round(round(dy1 @ in_w^T) + g), dy1 formed in the A
// load. Grid (rows / BM, B / BN), GEMM_THREADS threads (bf16 KB3 is
// hgemm_kernel in H_DX mode).
// ---------------------------------------------------------------------------
struct DxArgs {
  const void* db;        // [rows, H]
  const void* y1;        // [rows, H]
  const void* wt;        // in_w^T [H, B]
  const void* g;         // [rows, B] upstream cotangent
  const float* stats1;   // K1 partials
  int n1;
  const float* gs1;      // KB2 partials of (sum db*g1, sum db*g1*ahat)
  int ng1;
  const float* alpha1;
  const float* g1;
  void* dx;              // [rows, B]
  void* dy1;             // [rows, H], written by the blockIdx.y == 0 CTAs
  float* da1part;        // [rows / BM]
  int kpad, k_valid, B, H, gln;
};

__global__ void __launch_bounds__(GEMM_THREADS) bwd_dx_kernel(DxArgs g) {
  using T = float;
  using Tl = Tiles<T>;
  constexpr int VEC = Tl::VEC;
  __shared__ __align__(128) unsigned char smem[Tl::BYTES];
  __shared__ float2 red[GEMM_THREADS / 32];
  __shared__ float4 rowmom[BM];  // (mean1, inv1, mean(db*g1), mean(db*g1*ahat))
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + BM * Tl::LDA;
  float* Cs = reinterpret_cast<float*>(smem);

  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int item = row0 / g.kpad;
  if (g.gln) {
    const float n = (float)g.k_valid * (float)g.H;
    const float2 t1 = reduce_partials(g.stats1 + 2 * (size_t)item * g.n1, g.n1, red);
    const float2 tg = reduce_partials(g.gs1 + 2 * (size_t)item * g.ng1, g.ng1, red);
    const float2 m1 = moments(t1.x, t1.y, n);
    for (int r = threadIdx.x; r < BM; r += blockDim.x)
      rowmom[r] = make_float4(m1.x, m1.y, tg.x / n, tg.y / n);
  } else {
    const float n = (float)g.H;
    for (int r = threadIdx.x; r < BM; r += blockDim.x) {
      const size_t row = (size_t)row0 + r;
      const float2 t1 = sum_pairs(g.stats1 + 2 * row * g.n1, g.n1);
      const float2 tg = sum_pairs(g.gs1 + 2 * row * g.ng1, g.ng1);
      const float2 m1 = moments(t1.x, t1.y, n);
      rowmom[r] = make_float4(m1.x, m1.y, tg.x / n, tg.y / n);
    }
  }
  __syncthreads();

  const T* dbp = static_cast<const T*>(g.db);
  const T* y1 = static_cast<const T*>(g.y1);
  const T* W = static_cast<const T*>(g.wt);
  T* dy1 = static_cast<T*>(g.dy1);
  const float a1 = *g.alpha1;
  const bool store_dy1 = blockIdx.y == 0;
  float da1acc = 0.f;
  TileMma<T> mma;
  mma.init();
  for (int k0 = 0; k0 < g.H; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK / VEC; i += blockDim.x) {
      const int r = i / (BK / VEC), cv = (i % (BK / VEC)) * VEC;
      const size_t grow = (size_t)row0 + r;
      const size_t idx = grow * g.H + k0 + cv;
      const bool valid = (int)(grow % g.kpad) < g.k_valid;
      uint4 u = *reinterpret_cast<const uint4*>(dbp + idx);
      const uint4 uy = *reinterpret_cast<const uint4*>(y1 + idx);
      T* v = reinterpret_cast<T*>(&u);
      const T* yv = reinterpret_cast<const T*>(&uy);
      const float4 mm = rowmom[r];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float y = to_f(yv[j]);
        const float ahat = (prelu(y, a1) - mm.x) * mm.y;
        const float dbg = to_f(v[j]) * g.g1[k0 + cv + j];
        const float da = valid ? round_dt<T>(mm.y * (dbg - mm.z - ahat * mm.w)) : 0.f;
        da1acc += da * fminf(y, 0.f);
        v[j] = from_f<T>(da * dprelu(y, a1));
      }
      *reinterpret_cast<uint4*>(As + r * Tl::LDA + cv) = u;
      if (store_dy1) *reinterpret_cast<uint4*>(dy1 + idx) = u;
    }
    for (int i = threadIdx.x; i < BK * BN / VEC; i += blockDim.x) {
      const int r = i / (BN / VEC), cv = (i % (BN / VEC)) * VEC;
      *reinterpret_cast<uint4*>(Bs + r * Tl::LDB + cv) =
          *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * g.B + col0 + cv);
    }
    __syncthreads();
    mma.step(As, Bs);
    __syncthreads();
  }
  mma.store(Cs);
  const float2 t = block_sum2(da1acc, 0.f, red);  // also syncs Cs
  if (store_dy1 && threadIdx.x == 0) g.da1part[blockIdx.x] = t.x;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* gin = static_cast<const T*>(g.g);
  T* dx = static_cast<T*>(g.dx);
  for (int r = warp; r < BM; r += GEMM_THREADS / 32) {
    const size_t grow = (size_t)row0 + r;
    const bool valid = (int)(grow % g.kpad) < g.k_valid;
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      const int c = lane + 32 * j;
      const size_t idx = grow * g.B + col0 + c;
      dx[idx] = valid ? from_f<T>(round_dt<T>(Cs[r * Tl::LDC + c]) + to_f(gin[idx]))
                      : from_f<T>(0.f);
    }
  }
}

}  // namespace tcn

using namespace tcn;

// dtype: 0 = float32, 1 = bfloat16. Every function returns the
// cudaGetLastError() of its launch (0 = success); nothing synchronises.

// bf16: (bm, bn) is the tile of the wgmma kernel, from tcn_block.gemm_plan;
// colpart holds rows / bm rows, npart H / bn pairs per row (cLN) or per row
// tile (gLN). f32: the SIMT tiles (BM, BN).
// Sc > 0 (bf16 only): the skip mode, dz = [g | gs] @ wt with wt = [out_w |
// skip_w]^T [B + Sc, H] and gs [rows, Sc], the skip sum's cotangent.
extern "C" int tcn_bwd_dz(int device, int dtype, const void* g, const void* wt,
                          const void* c, const float* stats2, int n2, const float* alpha2,
                          const float* g2, void* dz, float* colpart, float* npart,
                          const void* gs, int rows, int kpad, int k_valid, int B, int Sc, int H,
                          int gln, int bm, int bn, void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sc && (!dtype || !gs)) return cudaErrorInvalidValue;
  if (dtype) {
    HMaps m;
    if (!hop::tensor_map(&m.a, g, rows, B, bm) || !hop::tensor_map(&m.w, wt, B + Sc, H, 64) ||
        !hop::tensor_map(&m.res, c, rows, H, 64) || !hop::tensor_map(&m.out, dz, rows, H, 64))
      return cudaErrorInvalidValue;
    m.a2 = m.dy1 = m.res2 = m.out2 = m.a;  // unused
    if (Sc && !hop::tensor_map(&m.a2, gs, rows, Sc, bm)) return cudaErrorInvalidValue;
    HArgs h{};
    h.stats = stats2;
    h.n_stats = n2;
    h.alpha = alpha2;
    h.vec_a = g2;
    h.part = npart;
    h.colpart = colpart;
    h.kpad = kpad;
    h.k_valid = k_valid;
    h.kdim = B + Sc;
    h.ncols = H;
    h.gln = gln;
    h.nsplit = B;
    return Sc ? hgemm<H_DZ, true>(m, h, rows, bm, bn, s) : hgemm<H_DZ>(m, h, rows, bm, bn, s);
  }
  DzArgs a{g, wt, c, stats2, n2, alpha2, g2, dz, colpart, npart, kpad, k_valid, B, H, gln};
  bwd_dz_kernel<float><<<dim3(rows / BM, H / BN), GEMM_THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

// CTAs of the bf16 wgmma kernel in `mode` (tcn_gemm_sm90.cuh HMode: 2 KB3,
// 4 KB1) with tile (bm, bn) resident per SM; -1 if not built here.
extern "C" int tcn_gemm_resident(int device, int mode, int bm, int bn) {
  cudaSetDevice(device);
  if (mode == H_DX) return hgemm_resident<H_DX>(bm, bn);
  if (mode == H_DZ) return hgemm_resident<H_DZ>(bm, bn);
  if (mode == (H_DZ | 8)) return hgemm_resident<H_DZ, true>(bm, bn);
  return -1;
}

// bf16: `splits` ranges of 64-row slices in clusters of `cluster` CTAs
// (tcn_block_bwd.wgrad_plan), part [splits / cluster, n1, n2]; f32: `splits`
// is the chunk of rows per split, part [rows / chunk, n1, n2].
// Sc > 0 (bf16 z form only): the skip mode, N side [Bm | gs] (gs [rows, Sc],
// the skip sum's cotangent), partials [.., n1, n2 + Sc].
extern "C" int tcn_wgrad(int device, int dtype, int zmode, const void* A, const void* Bm,
                         const void* gs, float* part, const float* stats2, int n2s,
                         const float* alpha2, const float* g2, const float* b2, int rows,
                         int kpad, int k_valid, int n1, int n2, int Sc, int splits, int cluster,
                         int gln, void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sc && (!dtype || !zmode || !gs)) return cudaErrorInvalidValue;
  if (dtype) {
    // z form: M side c, N side g; din form: M side dy1 (= Bm), N side x.
    const void* mside = zmode ? A : Bm;
    const void* nside = zmode ? Bm : A;
    WArgs w{part, stats2, n2s, alpha2, g2, b2, kpad, k_valid, zmode ? n1 : n2,
            zmode ? n2 + Sc : n1, rows / 64, splits, cluster, gln, Sc ? n2 : 0};
    WMaps m;
    if (!hop::tensor_map(&m.m, mside, rows, w.m_cols, 64) ||
        !hop::tensor_map(&m.n, nside, rows, zmode ? n2 : n1, 64))
      return cudaErrorInvalidValue;
    m.n2 = m.n;
    if (Sc && !hop::tensor_map(&m.n2, gs, rows, Sc, 64)) return cudaErrorInvalidValue;
    return wgrad_sm90(m, w, rows, zmode != 0, s);
  }
  WgArgs a{A, Bm, part, stats2, n2s, alpha2, g2, b2, kpad, k_valid, n1, n2, splits, gln};
  dim3 grid(n1 / BM, n2 / BN, rows / splits);
  if (zmode)
    wgrad_kernel<float, true><<<grid, GEMM_THREADS, 0, s>>>(a);
  else
    wgrad_kernel<float, false><<<grid, GEMM_THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

// Clusters of `cluster` CTAs of bf16 KW that can be resident at once, for
// N-side width n_cols; -1 if the query fails.
extern "C" int tcn_wgrad_max_clusters(int device, int n_cols, int cluster) {
  cudaSetDevice(device);
  int n = -1;
  const cudaError_t e = wgrad_bn(n_cols) == 256 ? wgrad_max_clusters<256>(cluster, &n)
                                                : wgrad_max_clusters<128>(cluster, &n);
  return e == cudaSuccess ? n : -1;
}

// (chunk, stages, ring, strip, bands, smem): the strip plan of
// tcn_block.kb2_plan; P <= 8.
extern "C" int tcn_bwd_dwconv(int device, int dtype, const void* y1, const void* c,
                              const void* dz, const float* stats1, int n1,
                              const float* stats2, int n2, const float* gs2, int ng2,
                              const float* alpha1, const float* g1, const float* b1,
                              const float* w, const float* alpha2, const float* g2,
                              void* db, float* chpart, float* gs1, float* da2part, int M,
                              int kpad, int k_valid, int H, int P, int dilation, int causal,
                              int gln, int chunk, int stages, int ring, int strip, int bands,
                              int smem, void* stream) {
  cudaSetDevice(device);
  const int span = (P - 1) * dilation;
  const int bc = KB2_VECS * (dtype ? 8 : 4), rows = M * kpad;
  if (P < 1 || P > 8 || stages < 2 || stages > KB2_MAX_STAGES || chunk < 1 || chunk > 256 ||
      H % bc || kpad % chunk || strip % chunk || strip < chunk ||
      ring < (span + chunk - 1) / chunk + 1 || bands != (kpad + strip - 1) / strip ||
      chunk % (KB2_CONSUMERS / KB2_VECS) || smem > hop::SMEM_LIMIT)
    return cudaErrorInvalidValue;
  DwbArgs a{stats1, n1, stats2, n2, gs2, ng2, alpha1, g1, b1, w, alpha2, g2,
            db, chpart, gs1, da2part, M, kpad, k_valid, H, P, dilation,
            causal ? span : span / 2, gln, StripPlan{chunk, stages, ring, strip, bands}};
  DwMaps m;
  if (!hop::tensor_map_rows(&m.a, c, dtype == 0, rows, H, chunk, bc) ||
      !hop::tensor_map_rows(&m.b, dz, dtype == 0, rows, H, chunk, bc) ||
      !hop::tensor_map_rows(&m.c, y1, dtype == 0, rows, H, chunk, bc))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype ? bwd_dwconv_sm90<bf16>(m, a, smem, s) : bwd_dwconv_sm90<float>(m, a, smem, s);
}

// bf16: (bm, bn) is the tile of the wgmma kernel, from tcn_block.gemm_plan;
// da1part holds rows / bm partials (rows / BM in f32).
extern "C" int tcn_bwd_dx(int device, int dtype, const void* db, const void* y1,
                          const void* wt, const void* g, const float* stats1, int n1,
                          const float* gs1, int ng1, const float* alpha1, const float* g1,
                          void* dx, void* dy1, float* da1part, int rows, int kpad,
                          int k_valid, int B, int H, int gln, int bm, int bn, void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype) {
    HMaps m;
    if (!hop::tensor_map(&m.a, db, rows, H, bm) || !hop::tensor_map(&m.a2, y1, rows, H, bm) ||
        !hop::tensor_map(&m.w, wt, H, B, 64) || !hop::tensor_map(&m.res, g, rows, B, 64) ||
        !hop::tensor_map(&m.out, dx, rows, B, 64) || !hop::tensor_map(&m.dy1, dy1, rows, H, 64))
      return cudaErrorInvalidValue;
    HArgs h{};
    h.stats = stats1;
    h.n_stats = n1;
    h.gs = gs1;
    h.n_gs = ng1;
    h.alpha = alpha1;
    h.vec_a = g1;
    h.da1part = da1part;
    h.kpad = kpad;
    h.k_valid = k_valid;
    h.kdim = H;
    h.ncols = B;
    h.gln = gln;
    return hgemm<H_DX>(m, h, rows, bm, bn, s);
  }
  DxArgs a{db, y1, wt, g, stats1, n1, gs1, ng1, alpha1, g1, dx, dy1, da1part,
           kpad, k_valid, B, H, gln};
  bwd_dx_kernel<<<dim3(rows / BM, B / BN), GEMM_THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

// KF: the nine weight gradients of the group's n slots, rows nb0 ...
// nb0 + n - 1 of the stacked gradients, from the kinds the host filled
// (tcn_bwd_finish.cuh FinKind; tcn_block_bwd.py builds them once per
// shape and pointers). The grid is the CTAs resident on every SM, or the
// units of work if fewer.
// skip: KF's skip kernel (a chain with a skip path: dout_w is d[out_w |
// skip_w], [NB, H, B + Sc]); the same sums under a name of their own.
extern "C" int tcn_bwd_finish(int device, const FinGroup* host, int skip, void* stream) {
  cudaSetDevice(device);
  if (!host || host->n < 1 || host->n > FIN_MAX_GROUP) return cudaErrorInvalidValue;
  FinGroup g = *host;
  int units = 0;
  for (int i = 0; i < FIN_KINDS; ++i) {
    FinKind& k = g.kind[i];
    if (!fin_plan(k, g.n)) return cudaErrorInvalidValue;
    k.first = units;
    units += k.units * g.n;
  }
  g.units = units;
  static int ctas[64] = {0};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!ctas[device]) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bwd_finish_kernel, FIN_THREADS, 0);
    ctas[device] = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  const int grid = units < ctas[device] ? units : ctas[device];
  if (skip)
    bwd_finish_skip_kernel<<<grid, FIN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(g);
  else
    bwd_finish_kernel<<<grid, FIN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(g);
  return cudaGetLastError();
}

// sizeof(FinGroup), held against the ctypes mirror when the library loads.
extern "C" int tcn_bwd_finish_args_bytes() { return (int)sizeof(FinGroup); }
