// Hopper kernels of one Conv-TasNet temporal block (sm_90a), three per block:
//
//   K1 tcn_in_gemm   y1 = round(x @ in_w); f32 partial sums of a = PReLU(y1)
//   K2 tcn_dwconv    b = round(norm1(a)) with rows outside [0, K) zero,
//                    c = P-tap dilated depthwise conv (f32), e = PReLU(c);
//                    stores round(e) and f32 partial sums of e (rows < K);
//                    in save mode (training) also round(c), pad rows not
//                    masked, the residual the backward (tcn_block_bwd.cu)
//                    needs for dPReLU2 and d_alpha2
//   K3 tcn_out_gemm  o = round(norm2(e) @ out_w), x' = round(x + o), rows
//                    >= K exactly zero. x' may be x itself: the chain
//                    updates the residual stream IN PLACE after its first
//                    block. Two forms:
//                      fold   (whole_tcn)   t = e @ round(g2 * out_w),
//                             o = inv * t + (b2 @ W - inv * mean * g2 @ W)
//                      unfold (whole_block) z = round(norm2(e)) is formed
//                             in the A-operand load, o = z @ out_w
//                    With a skip path (the paper's final version, Sc > 0),
//                    K3's skip mode: o over [out_w | skip_w], its last Sc
//                    columns added into the skip sum s in place (bf16).
//
// and, once per whole-TCN forward over all NB blocks, KFW tcn_fold_weights
// (tcn_fold_weights.cuh): K3 fold's operand round(g2 * out_w) and its
// vectors g2 @ W, b2 @ W, with W = out_w rounded to the activation type.
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
// K1 and K3 (both forms) in bf16 run on the TMA + wgmma pipeline of
// tcn_gemm_sm90.cuh (modes H_IN, H_FOLD, H_UNFOLD): a ring of TMA loads in
// flight, the epilogue from the accumulator registers, the tile leaving by
// TMA store. In f32 both keep plain shared-memory tiles (SIMT FMA, no
// pipeline), so f32 stays exact where TF32 would not be. K2, in both types,
// is the staged stencil of tcn_dwconv_sm90.cuh: the y1 rows its taps reach
// arrive as TMA boxes, become b once per row in shared memory, and every
// access is a 16-byte vector.
#include <cstdint>
#include <type_traits>

#include "tcn_block.cuh"
#include "tcn_dwconv_sm90.cuh"
#include "tcn_fold_weights.cuh"
#include "tcn_gemm_sm90.cuh"

namespace tcn {

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

// Grid (rows / BM, ncols / BN), GEMM_THREADS threads. kpad % BM == 0, so a
// CTA's rows belong to one batch item. f32 only (bf16 K1 and K3 are
// hgemm_kernel).
template <typename T, int MODE>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(GemmArgs g) {
  static_assert(std::is_same<T, float>::value,
                "bf16 K1 and K3 run on the wgmma pipeline (tcn_gemm_sm90.cuh)");
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

// bf16: (bm, bn) is the tile of the wgmma kernel, from tcn_block.gemm_plan;
// f32 ignores them.
extern "C" int tcn_in_gemm(int device, int dtype, const void* x, const void* in_w,
                           const float* alpha1, void* y1, float* stats1, int rows,
                           int kpad, int B, int H, int gln, int bm, int bn, void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype) {
    HMaps m;
    if (!hop::tensor_map(&m.a, x, rows, B, bm) || !hop::tensor_map(&m.w, in_w, B, H, 64) ||
        !hop::tensor_map(&m.out, y1, rows, H, 64))
      return cudaErrorInvalidValue;
    m.a2 = m.res = m.dy1 = m.a;  // unused
    HArgs h{};
    h.alpha = alpha1;
    h.part = stats1;
    h.kpad = kpad;
    h.k_valid = kpad;
    h.kdim = B;
    h.ncols = H;
    h.gln = gln;
    return hgemm<H_IN>(m, h, rows, bm, bn, s);
  }
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
  return launch_gemm<float, IN_GEMM>(g, rows, s);
}

// CTAs of the bf16 wgmma kernel in `mode` (tcn_gemm_sm90.cuh HMode: 0 fold,
// 1 unfold, 3 K1; or-ed with 8, the skip kernel of fold / unfold) with tile
// (bm, bn) resident per SM; -1 if not built here.
extern "C" int tcn_gemm_resident(int device, int mode, int bm, int bn) {
  cudaSetDevice(device);
  if (mode == H_FOLD) return hgemm_resident<H_FOLD>(bm, bn);
  if (mode == H_UNFOLD) return hgemm_resident<H_UNFOLD>(bm, bn);
  if (mode == H_IN) return hgemm_resident<H_IN>(bm, bn);
  if (mode == (H_FOLD | 8)) return hgemm_resident<H_FOLD, true>(bm, bn);
  if (mode == (H_UNFOLD | 8)) return hgemm_resident<H_UNFOLD, true>(bm, bn);
  return -1;
}

// (br, lanes, staged, chunk, stages, smem): the tile plan of
// tcn_block.dw_plan.
extern "C" int tcn_dwconv(int device, int dtype, const void* y1, const float* stats1,
                          int n1, const float* alpha1, const float* g1, const float* b1,
                          const float* w, const float* alpha2, void* e, void* c,
                          float* stats2, int M, int kpad, int k_valid, int H, int P,
                          int dilation, int causal, int gln, int br, int lanes, int staged,
                          int chunk, int stages, int smem, void* stream) {
  cudaSetDevice(device);
  const int span = (P - 1) * dilation;
  DwArgs g{stats1, n1, alpha1, g1, b1, w, alpha2, e, c, stats2, M, kpad, k_valid, H, P,
           dilation, causal ? span : span / 2, gln,
           DwTile{br, lanes, staged, chunk, stages}};
  if (stages < 1 || stages > DW_MAX_STAGES) return cudaErrorInvalidValue;
  DwMaps m;
  if (!hop::tensor_map_rows(&m.a, y1, dtype == 0, M * kpad, H, DW_BOX, lanes * (dtype ? 8 : 4)))
    return cudaErrorInvalidValue;
  m.b = m.c = m.a;  // unused
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype ? dwconv_sm90<bf16>(m, g, smem, s) : dwconv_sm90<float>(m, g, smem, s);
}

// bf16: (bm, bn) is the tile of the wgmma kernel, from tcn_block.gemm_plan;
// f32 ignores them. Sc > 0 (bf16 only): the skip mode, wmat [H, B + Sc]
// (fold: vec_a / vec_b [B + Sc]) and the skip sum `skip` [rows, Sc]
// updated in place.
extern "C" int tcn_out_gemm(int device, int dtype, int fold, const void* e,
                            const float* stats2, int n2, const void* wmat,
                            const float* vec_a, const float* vec_b, const void* res,
                            void* out, void* skip, int rows, int kpad, int k_valid, int H,
                            int B, int Sc, int gln, int bm, int bn, void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sc && (!dtype || !skip)) return cudaErrorInvalidValue;
  if (dtype) {
    HMaps m;
    if (!hop::tensor_map(&m.a, e, rows, H, bm) || !hop::tensor_map(&m.w, wmat, H, B + Sc, 64) ||
        !hop::tensor_map(&m.res, res, rows, B, 64) || !hop::tensor_map(&m.out, out, rows, B, 64))
      return cudaErrorInvalidValue;
    m.a2 = m.dy1 = m.a;
    m.res2 = m.out2 = m.res;
    if (Sc && !hop::tensor_map(&m.res2, skip, rows, Sc, 64)) return cudaErrorInvalidValue;
    if (Sc) m.out2 = m.res2;
    HArgs h{};
    h.stats = stats2;
    h.n_stats = n2;
    h.vec_a = vec_a;
    h.vec_b = vec_b;
    h.kpad = kpad;
    h.k_valid = k_valid;
    h.kdim = H;
    h.ncols = B + Sc;
    h.gln = gln;
    h.nsplit = B;
    if (Sc)
      return fold ? hgemm<H_FOLD, true>(m, h, rows, bm, bn, s)
                  : hgemm<H_UNFOLD, true>(m, h, rows, bm, bn, s);
    return fold ? hgemm<H_FOLD>(m, h, rows, bm, bn, s) : hgemm<H_UNFOLD>(m, h, rows, bm, bn, s);
  }
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
  return fold ? launch_gemm<float, OUT_FOLD>(g, rows, s) : launch_gemm<float, OUT_UNFOLD>(g, rows, s);
}

// out_w f32 [NB, H, B], g2 / b2 f32 [NB, H] -> wp [NB, H, B] in the
// activation type, g2w / b2w f32 [NB, B] (B a multiple of FW_COLS), over
// `splits` slices of `rows` rows of H; with splits > 1, part [NB * B /
// FW_COLS, splits, 2, FW_COLS] f32 and ticket [NB * B / FW_COLS] (zero
// between launches) are the slices' sums and the last-arrival tickets;
// `reset` zeroes the tickets first (buffers new to this launch).
template <bool SKIP>
static int fold_weights_entry(int device, int dtype, const float* out_w, const float* g2,
                              const float* b2, void* wp, float* g2w, float* b2w, float* part,
                              unsigned* ticket, int reset, int splits, int rows, int NB, int H,
                              int B, void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (reset && splits > 1) {
    const cudaError_t e =
        cudaMemsetAsync(ticket, 0, sizeof(unsigned) * (size_t)NB * (B / FW_COLS), s);
    if (e != cudaSuccess) return e;
  }
  const FwArgs a{out_w, g2, b2, wp, g2w, b2w, part, ticket, H, B, splits, rows};
  return dtype ? fold_weights<bf16, SKIP>(a, NB, s) : fold_weights<float, SKIP>(a, NB, s);
}

extern "C" int tcn_fold_weights(int device, int dtype, const float* out_w, const float* g2,
                                const float* b2, void* wp, float* g2w, float* b2w, float* part,
                                unsigned* ticket, int reset, int splits, int rows, int NB, int H,
                                int B, void* stream) {
  return fold_weights_entry<false>(device, dtype, out_w, g2, b2, wp, g2w, b2w, part, ticket,
                                   reset, splits, rows, NB, H, B, stream);
}

// The skip mode (a block with a skip path): out_w = [out_w | skip_w], B its
// B + Sc columns, in KFW's skip kernel.
extern "C" int tcn_fold_weights_skip(int device, int dtype, const float* out_w, const float* g2,
                                     const float* b2, void* wp, float* g2w, float* b2w,
                                     float* part, unsigned* ticket, int reset, int splits,
                                     int rows, int NB, int H, int B, void* stream) {
  return fold_weights_entry<true>(device, dtype, out_w, g2, b2, wp, g2w, b2w, part, ticket,
                                  reset, splits, rows, NB, H, B, stream);
}

// CTAs of KFW resident per SM on `device` (-1 if the query fails).
extern "C" int tcn_fold_resident(int device, int dtype) {
  cudaSetDevice(device);
  return dtype ? fold_weights_resident<bf16>() : fold_weights_resident<float>();
}
