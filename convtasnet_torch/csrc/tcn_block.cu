// Hopper kernels of one Conv-TasNet temporal block (sm_90a), three per block:
//
//   K1 tcn_in_gemm   y1 = round(x @ in_w); f32 partial sums of a = PReLU(y1)
//   K2 tcn_dwconv    b = round(norm1(a)) with rows outside [0, K) zero,
//                    c = P-tap dilated depthwise conv (f32), e = PReLU(c);
//                    stores round(e) and f32 partial sums of e (rows < K)
//   K3 tcn_out_gemm  o = round(norm2(e) @ out_w), x' = round(x + o), rows
//                    >= K exactly zero. x' may be x itself: the chain
//                    updates the residual stream IN PLACE after its first
//                    block. Two forms:
//                      fold   (whole_tcn)   t = e @ round(g2 * out_w),
//                             o = inv * t + (b2 @ W - inv * mean * g2 @ W)
//                      unfold (whole_block) z = round(norm2(e)) is formed
//                             in the A-operand load, o = z @ out_w
//
// Replaces the TPU kernels convtasnet_tpu/ops/pallas/whole_tcn.py
// (_tcn_kernel, whole_tcn_pallas) and ops/pallas/fused_whole_block.py
// (_block_kernel, whole_block_pallas). Those keep a whole [K, B] residual
// stream and a [K + 2 span, H] slab in VMEM (about 100 MB at the paper
// config); an SM has 227 KB, so here each block is three launches that
// pass y1 and e through device memory, and the gLN statistics, which span
// all K rows of an item, cross CTAs as partial sums reduced in a fixed
// order by the next kernel (no float atomics: results repeat bit for bit).
//
// Bound on the H100 at the paper config, batch 8 (25,600 rows): every
// kernel is bound by device-memory bytes (K1 39 MB, K2 52 MB, K3 52 MB per
// block at 3.35 TB/s, against 6.7 GFLOP for each GEMM at 989 TFLOP/s).
// This first version is simple rather than fast: the GEMMs are plain
// shared-memory tiles with WMMA (mma.sync) for bf16 and SIMT FMA for f32,
// no cp.async / TMA pipeline, and K2 reads each y1 row P times through L1.
// Making them reach the bound (wgmma, TMA, fusing K2 into K3) is later work.
#include <mma.h>

#include <cstdint>

#include "tcn_block.cuh"

namespace tcn {

using bf16 = __nv_bfloat16;

struct GemmArgs {
  const void* A;          // IN: x [rows, kdim];  OUT: e [rows, kdim]
  const void* W;          // [kdim, ncols] in the activation type
  void* out;              // IN: y1 [rows, ncols]; OUT: new x [rows, ncols]
  const void* res;        // OUT: residual x [rows, ncols]; may equal out
  float* stats_out;       // IN: partial sums of a (see tcn_in_gemm)
  const float* stats_in;  // OUT: K2's partial sums of e
  int n_in;               // OUT: partial pairs per item (gLN) or per row (cLN)
  const float* alpha;     // IN: PReLU slope (1 float on the device)
  const float* vec_a;     // OUT fold: g2 @ W [ncols]; unfold: g2 [kdim]
  const float* vec_b;     // OUT fold: b2 @ W [ncols]; unfold: b2 [kdim]
  int kpad, k_valid, kdim, ncols, gln;
};

enum Mode { IN_GEMM = 0, OUT_FOLD = 1, OUT_UNFOLD = 2 };

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
// LDC). bf16: WMMA 16x16x16 fragments, 8 warps of 32x32. f32: SIMT FMA,
// each thread 4 rows x 8 columns.
template <typename T> struct TileMma;

template <> struct TileMma<bf16> {
  using Tl = Tiles<bf16>;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[2][2];
  __device__ void init() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.f);
  }
  __device__ void step(const bf16* As, const bf16* Bs) {
    using namespace nvcuda;
    const int warp = threadIdx.x >> 5, wr = warp >> 2, wc = warp & 3;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wr * 32 + i * 16) * Tl::LDA + kk, Tl::LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * Tl::LDB + wc * 32 + j * 16, Tl::LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  __device__ void store(float* Cs) {
    const int warp = threadIdx.x >> 5, wr = warp >> 2, wc = warp & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        nvcuda::wmma::store_matrix_sync(Cs + (wr * 32 + i * 16) * Tl::LDC + wc * 32 + j * 16,
                                        acc[i][j], Tl::LDC, nvcuda::wmma::mem_row_major);
  }
};

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

// Grid (rows / BM, ncols / BN), GEMM_THREADS threads. kpad % BM == 0, so a
// CTA's rows belong to one batch item.
template <typename T, int MODE>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(GemmArgs g) {
  using Tl = Tiles<T>;
  constexpr int VEC = Tl::VEC;
  __shared__ __align__(128) unsigned char smem[Tl::BYTES];
  __shared__ float2 red[GEMM_THREADS / 32];
  __shared__ float2 rowmom[BM];  // OUT: (mean, inv) of norm2 per tile row
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + BM * Tl::LDA;
  float* Cs = reinterpret_cast<float*>(smem);

  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int item = row0 / g.kpad;
  const T* A = static_cast<const T*>(g.A);
  const T* W = static_cast<const T*>(g.W);

  if (MODE != IN_GEMM) {
    // norm2 moments of e: one pair per item (gLN, n = K * H valid values)
    // or per row (cLN, n = H), from K2's partial sums.
    if (g.gln) {
      const float2 t = reduce_partials(g.stats_in + 2 * (size_t)item * g.n_in, g.n_in, red);
      const float2 mm = moments(t.x, t.y, (float)g.k_valid * (float)g.kdim);
      for (int r = threadIdx.x; r < BM; r += blockDim.x) rowmom[r] = mm;
    } else {
      for (int r = threadIdx.x; r < BM; r += blockDim.x) {
        const float* p = g.stats_in + 2 * (size_t)(row0 + r) * g.n_in;
        float s = 0.f, ss = 0.f;
        for (int i = 0; i < g.n_in; ++i) {
          s += p[2 * i];
          ss += p[2 * i + 1];
        }
        rowmom[r] = moments(s, ss, (float)g.kdim);
      }
    }
    __syncthreads();
  }

  TileMma<T> mma;
  mma.init();
  for (int k0 = 0; k0 < g.kdim; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK / VEC; i += blockDim.x) {
      const int r = i / (BK / VEC), cv = (i % (BK / VEC)) * VEC;
      uint4 u = *reinterpret_cast<const uint4*>(A + (size_t)(row0 + r) * g.kdim + k0 + cv);
      if (MODE == OUT_UNFOLD) {
        // A-operand prologue: z = round(g2 * ((e - mean) * inv) + b2).
        T* v = reinterpret_cast<T*>(&u);
        const float2 mm = rowmom[r];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const int h = k0 + cv + j;
          v[j] = from_f<T>(g.vec_a[h] * ((to_f(v[j]) - mm.x) * mm.y) + g.vec_b[h]);
        }
      }
      *reinterpret_cast<uint4*>(As + r * Tl::LDA + cv) = u;
    }
    for (int i = threadIdx.x; i < BK * BN / VEC; i += blockDim.x) {
      const int r = i / (BN / VEC), cv = (i % (BN / VEC)) * VEC;
      *reinterpret_cast<uint4*>(Bs + r * Tl::LDB + cv) =
          *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * g.ncols + col0 + cv);
    }
    __syncthreads();
    mma.step(As, Bs);
    __syncthreads();
  }
  mma.store(Cs);
  __syncthreads();

  // Epilogue: warp w takes tile rows w, w + 8, ...; lane l columns
  // l, l + 32, l + 64, l + 96 (coalesced along the channel axis).
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* out = static_cast<T*>(g.out);
  const T* res = static_cast<const T*>(g.res);
  if (MODE == IN_GEMM) {
    const float alpha = *g.alpha;
    float ts = 0.f, tss = 0.f;
    for (int r = warp; r < BM; r += GEMM_THREADS / 32) {
      const size_t grow = (size_t)row0 + r;
      float rs = 0.f, rss = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 32; ++j) {
        const int c = lane + 32 * j;
        const T y = from_f<T>(Cs[r * Tl::LDC + c]);
        out[grow * g.ncols + col0 + c] = y;
        const float a = prelu(to_f(y), alpha);
        rs += a;
        rss += a * a;
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
          float* p = g.stats_out + 2 * (grow * gridDim.y + blockIdx.y);
          p[0] = rs;
          p[1] = rss;
        }
      }
    }
    if (g.gln) {
      // x's pad rows are zero, so their a is zero and adds nothing here.
      const float2 t = block_sum2(ts, tss, red);
      if (threadIdx.x == 0) {
        float* p = g.stats_out + 2 * ((size_t)blockIdx.x * gridDim.y + blockIdx.y);
        p[0] = t.x;
        p[1] = t.y;
      }
    }
  } else {
    for (int r = warp; r < BM; r += GEMM_THREADS / 32) {
      const size_t grow = (size_t)row0 + r;
      const bool valid = (int)(grow % g.kpad) < g.k_valid;
      const float2 mm = rowmom[r];
#pragma unroll
      for (int j = 0; j < BN / 32; ++j) {
        const int c = lane + 32 * j, col = col0 + c;
        const float t = Cs[r * Tl::LDC + c];
        float o;
        if (MODE == OUT_FOLD) {
          o = g.gln ? mm.y * t + (g.vec_b[col] - (mm.y * mm.x) * g.vec_a[col])
                    : mm.y * (t - mm.x * g.vec_a[col]) + g.vec_b[col];
        } else {
          o = t;
        }
        // Residual add in the activation type, in place when out == res
        // (each element is read and written by the same thread); pad rows
        // stay exact zeros (norm2's bias makes o non-zero there).
        const size_t idx = grow * g.ncols + col;
        out[idx] = valid ? from_f<T>(to_f(res[idx]) + round_dt<T>(o)) : from_f<T>(0.f);
      }
    }
  }
}

struct DwArgs {
  const void* y1;         // [M, kpad, H]
  const float* stats1;    // K1 partials: n1 pairs per item (gLN) / per row (cLN)
  int n1;
  const float* alpha1;
  const float* g1;        // [H]
  const float* b1;        // [H]
  const float* w;         // [P, H] f32
  const float* alpha2;
  void* e;                // [M, kpad, H]
  float* stats2;          // gLN: [M, kpad / DW_ROWS] pairs; cLN: [M * kpad] pairs
  int kpad, k_valid, H, P, dilation, left, gln;
};

// Grid M * kpad / DW_ROWS, DW_THREADS threads; dynamic shared memory holds
// the norm1 moments of the CTA's rows plus the conv halo.
template <typename T>
__global__ void __launch_bounds__(DW_THREADS) dwconv_kernel(DwArgs g) {
  extern __shared__ float2 mom[];  // [DW_ROWS + span]
  __shared__ float2 red[DW_THREADS / 32];
  const int row0 = blockIdx.x * DW_ROWS;
  const int item = row0 / g.kpad, k0 = row0 % g.kpad;
  const int span = (g.P - 1) * g.dilation;
  const int nhalo = DW_ROWS + span;
  const size_t ibase = (size_t)item * g.kpad;

  if (g.gln) {
    const float2 t = reduce_partials(g.stats1 + 2 * (size_t)item * g.n1, g.n1, red);
    const float2 mm = moments(t.x, t.y, (float)g.k_valid * (float)g.H);
    for (int i = threadIdx.x; i < nhalo; i += blockDim.x) mom[i] = mm;
  } else {
    for (int i = threadIdx.x; i < nhalo; i += blockDim.x) {
      const int src = k0 - g.left + i;
      float2 mm = make_float2(0.f, 0.f);
      if (src >= 0 && src < g.k_valid) {
        const float* p = g.stats1 + 2 * (ibase + src) * g.n1;
        float s = 0.f, ss = 0.f;
        for (int q = 0; q < g.n1; ++q) {
          s += p[2 * q];
          ss += p[2 * q + 1];
        }
        mm = moments(s, ss, (float)g.H);
      }
      mom[i] = mm;
    }
  }
  __syncthreads();

  const T* y1 = static_cast<const T*>(g.y1);
  T* e = static_cast<T*>(g.e);
  const float a1 = *g.alpha1, a2 = *g.alpha2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float ts = 0.f, tss = 0.f;
  for (int rr = warp; rr < DW_ROWS; rr += DW_THREADS / 32) {
    const int k = k0 + rr;
    const bool valid = k < g.k_valid;
    float rs = 0.f, rss = 0.f;
    for (int c = lane; c < g.H; c += 32) {
      const float gc = g.g1[c], bc = g.b1[c];
      float acc = 0.f;
      for (int p = 0; p < g.P; ++p) {
        const int src = k - g.left + p * g.dilation;
        if (src < 0 || src >= g.k_valid) continue;  // zero halo / pad rows
        const float2 mm = mom[rr + p * g.dilation];
        const float a = prelu(to_f(y1[(ibase + src) * g.H + c]), a1);
        const float b = round_dt<T>(gc * ((a - mm.x) * mm.y) + bc);
        acc += b * g.w[p * g.H + c];
      }
      const float ev = prelu(acc, a2);
      e[(ibase + k) * g.H + c] = from_f<T>(ev);
      if (valid) {
        rs += ev;
        rss += ev * ev;
      }
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
        float* p = g.stats2 + 2 * (ibase + k);
        p[0] = rs;
        p[1] = rss;
      }
    }
  }
  if (g.gln) {
    const float2 t = block_sum2(ts, tss, red);
    if (threadIdx.x == 0) {
      g.stats2[2 * blockIdx.x] = t.x;
      g.stats2[2 * blockIdx.x + 1] = t.y;
    }
  }
}

template <typename T, int MODE>
static cudaError_t launch_gemm(const GemmArgs& g, int rows, cudaStream_t s) {
  dim3 grid(rows / BM, g.ncols / BN);
  gemm_kernel<T, MODE><<<grid, GEMM_THREADS, 0, s>>>(g);
  return cudaGetLastError();
}

}  // namespace tcn

using namespace tcn;

// dtype: 0 = float32, 1 = bfloat16. Every function returns the
// cudaGetLastError() of its launch (0 = success); nothing synchronises.

extern "C" int tcn_in_gemm(int device, int dtype, const void* x, const void* in_w,
                           const float* alpha1, void* y1, float* stats1, int rows,
                           int kpad, int B, int H, int gln, void* stream) {
  cudaSetDevice(device);
  GemmArgs g{};
  g.A = x;
  g.W = in_w;
  g.out = y1;
  g.stats_out = stats1;
  g.alpha = alpha1;
  g.kpad = kpad;
  g.k_valid = kpad;
  g.kdim = B;
  g.ncols = H;
  g.gln = gln;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype ? launch_gemm<bf16, IN_GEMM>(g, rows, s) : launch_gemm<float, IN_GEMM>(g, rows, s);
}

extern "C" int tcn_dwconv(int device, int dtype, const void* y1, const float* stats1,
                          int n1, const float* alpha1, const float* g1, const float* b1,
                          const float* w, const float* alpha2, void* e, float* stats2,
                          int M, int kpad, int k_valid, int H, int P, int dilation,
                          int causal, int gln, void* stream) {
  cudaSetDevice(device);
  DwArgs g{y1, stats1, n1, alpha1, g1, b1, w, alpha2, e, stats2,
           kpad, k_valid, H, P, dilation, 0, gln};
  const int span = (P - 1) * dilation;
  g.left = causal ? span : span / 2;
  const size_t smem = (DW_ROWS + span) * sizeof(float2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = M * kpad / DW_ROWS;
  if (dtype)
    dwconv_kernel<bf16><<<grid, DW_THREADS, smem, s>>>(g);
  else
    dwconv_kernel<float><<<grid, DW_THREADS, smem, s>>>(g);
  return cudaGetLastError();
}

extern "C" int tcn_out_gemm(int device, int dtype, int fold, const void* e,
                            const float* stats2, int n2, const void* wmat,
                            const float* vec_a, const float* vec_b, const void* res,
                            void* out, int rows,
                            int kpad, int k_valid, int H, int B, int gln, void* stream) {
  cudaSetDevice(device);
  GemmArgs g{};
  g.A = e;
  g.W = wmat;
  g.out = out;
  g.res = res;
  g.stats_in = stats2;
  g.n_in = n2;
  g.vec_a = vec_a;
  g.vec_b = vec_b;
  g.kpad = kpad;
  g.k_valid = k_valid;
  g.kdim = H;
  g.ncols = B;
  g.gln = gln;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fold)
    return dtype ? launch_gemm<bf16, OUT_FOLD>(g, rows, s) : launch_gemm<float, OUT_FOLD>(g, rows, s);
  return dtype ? launch_gemm<bf16, OUT_UNFOLD>(g, rows, s) : launch_gemm<float, OUT_UNFOLD>(g, rows, s);
}
