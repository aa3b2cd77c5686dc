// KW tcn_wgrad in bf16 on Hopper: the weight-gradient GEMM A^T @ Bm, with
// the reduction over the row axis, on a TMA ring and wgmma, and its split
// partials summed in a fixed order inside a thread-block cluster.
//
//   z form (dout_w = z^T g):   wgmma A = z, formed in registers from the
//                              saved c: z = round(g2*ehat + b2); B = g.
//                              D [c cols, g cols] is dout_w as stored.
//   din form (din_w = x^T dy1): wgmma A = dy1, B = x; D = din_w^T, stored
//                              transposed.
//
// Rows >= K of Bm (g in the z form, dy1 in the din form) are zeroed in
// shared memory before the product, whatever they hold (NaN included); z's
// rows >= K are zero too.
//
// Replaces the weight-gradient sums of the TPU kernels
// convtasnet_tpu/ops/pallas/whole_tcn_hybrid.py (_bwd_block_kernel, :64) and
// ops/pallas/whole_block_vjp.py (_bwd_kernel, :69), which carry f32 sums of
// x^T dy1 and z^T g across their sequential grid.
//
// Bound on the H100 at the paper config, batch 5 (16,000 rows): device
// memory, 24.6 MB of operands (7.3 us at 3.35 TB/s) against 4.2 GFLOP
// (4.2 us at 989 TFLOP/s), so the tensor cores must run above ~55 % of
// peak not to set the pace. Design:
// - Both operands come straight from TMA boxes of [64 rows, 64 cols] with
//   the 128-byte swizzle. Both are MN-major for this product: the din
//   form's A operand (dy1, M = its columns) is read by wgmma SS with the
//   transpose bit, the B operand as W is read in tcn_gemm_sm90.cuh. No
//   transpose by hand.
// - A CTA takes 128 columns of the M side (two consumer warpgroups x 64)
//   and BN = 256 (or 128) columns of the N side, 128 f32 accumulators a
//   thread (setmaxnreg 232 / 40). With M side 512 wide and N side 256, the
//   M-side stream is read once and the N side 4x over L2.
// - The row axis is cut into `splits` contiguous ranges of whole 64-row
//   slices (tcn_block_bwd.wgrad_plan): about one wave of CTAs. One producer
//   warp keeps STAGES slices in flight and (z form) stages each slice's
//   norm2 row moments beside it; a consumer keeps one slice's wgmma in
//   flight while it waits for and prepares the next.
// - z form: z is formed in registers. ldmatrix.trans of the MN-major c box
//   gives the K-major A fragments of wgmma RS, the transform runs on them,
//   rows >= K become 0; two fragment buffers let a slice's product overlap
//   the next slice's prologue. (Rewriting z in place in shared memory for
//   wgmma SS, by the consumers or by the producer warpgroup's idle warps,
//   measured slower on the H100.)
// - Split partials: a cluster of CS CTAs along the split axis writes its
//   accumulators into its own shared memory (the ring is free by then);
//   after a cluster barrier CTA rank r sums its 1/CS of the tile's rows
//   over ranks 0..CS-1 in rank order (distributed shared memory), and the
//   cluster stores one partial. No float atomics: results repeat bit for
//   bit. CS = 1 is a cluster of one: each CTA stores its own partial.
// - Skip mode (wgrad_skip_kernel, the same body with SKIP; z form, a block
//   with a skip path): the N side is [g | g_s], N-side tiles < nsplit (= B)
//   from g and the rest from g_s (map n2), every tile wholly on one side.
// - Tried and dropped: multicasting the N-side boxes over a cluster of the
//   M tiles that share them (half the L2-to-SM bytes at 4 tiles) measured
//   1.4-2.4x slower on the H100.
#pragma once

#include "hopper_gemm.cuh"
#include "tcn_block.cuh"

namespace tcn {

struct WArgs {
  float* part;           // [splits / cluster, out rows, out cols], f32
  const float* stats2;   // z form: K2 partials of e (norm2 moments)
  int n2s;
  const float* alpha2;   // z form
  const float* g2;       // z form: [m_cols]
  const float* b2;       // z form: [m_cols]
  int kpad, k_valid;
  int m_cols, n_cols;    // widths of the wgmma A (M side) and B (N side) operands
  int slices, splits, cluster, gln;
  int nsplit;            // skip mode: the N-side column where g_s starts (B)
};

// m: the M-side operand [rows, m_cols]; n: the N side [rows, n_cols]
// (skip mode: n [rows, nsplit] and n2 [rows, n_cols - nsplit]); all with
// boxes of [64 rows, 64 cols].
struct WMaps {
  CUtensorMap m, n, n2;
};

template <int BN> struct WCfg {
  static constexpr int NC = 2;             // consumer warpgroups
  static constexpr int BMW = 64 * NC;      // M-side columns per CTA
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int STAGE_BYTES = (BMW / 64 + BN / 64) * hop::BOX_BYTES;
  static constexpr int STAGES = 4;
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int MOM_BYTES = STAGES * 64 * 8;  // row moments per stage
  static constexpr int SMEM = 1024 /* alignment */ + RING + MOM_BYTES + 16 * STAGES;
  // The f32 tile after the main loop, in the ring: z form [BMW, BN] (row
  // stride LD_Z), din form transposed [BN, BMW] (LD_T); padded against
  // bank conflicts of the accumulator stores.
  static constexpr int LD_Z = BN + 8, LD_T = BMW + 4;
  static_assert(SMEM <= hop::SMEM_LIMIT, "shared memory");
  static_assert(BMW * LD_Z * 4 <= RING && BN * LD_T * 4 <= RING, "the tile fits the ring");
};

template <bool ZMODE, int BN, bool SKIP>
__device__ __forceinline__ void wgrad_body(const WMaps& maps, const WArgs& g) {
  using C = WCfg<BN>;
  using namespace hop;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float2* mom_s = reinterpret_cast<float2*>(base + C::RING);  // [STAGES][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + C::RING + C::MOM_BYTES);

  const int tid = threadIdx.x, wg = tid / 128;
  const int ntn = g.n_cols / BN;
  const int m0 = (blockIdx.x / ntn) * C::BMW, n0 = (blockIdx.x % ntn) * BN;
  const bool n_skip = SKIP && n0 >= g.nsplit;  // this tile's N side is g_s
  const CUtensorMap* n_map = n_skip ? &maps.n2 : &maps.n;
  const int ncol0 = n_skip ? n0 - g.nsplit : n0;
  const int lo = (int)((long long)blockIdx.y * g.slices / g.splits);
  const int nk = (int)((long long)(blockIdx.y + 1) * g.slices / g.splits) - lo;
  const uint32_t sbase = smem_u32(base), full0 = smem_u32(bars), empty0 = full0 + 8 * C::STAGES;

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, ZMODE ? 2 : 1);  // z: the TMA's and the moments' arrivals
      mbar_init(empty0 + 8 * s, C::NC);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == C::NC) {
    // ---- producer: one warp loads the ring and stages the row moments ----
    setmaxnreg_dec40();
    if (tid < C::NC * 128 + 32) {
      const int lane = tid & 31;
      int item_have = -1;
      float2 m_lo = make_float2(0.f, 0.f), m_hi = m_lo;
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % C::STAGES;
        const int row0 = (lo + kb) * 64;
        if constexpr (ZMODE) {
          // norm2 (mean, inv) of rows row0 + lane (+ 32), before the wait
          // for the slot: per item (gLN; a slice lies in one item), the same
          // on every lane, or per row (cLN).
          if (g.gln) {
            const int item = row0 / g.kpad;
            if (item != item_have) {
              const float* p = g.stats2 + 2 * (size_t)item * g.n2s;
              float a = 0.f, b = 0.f;
              for (int i = lane; i < g.n2s; i += 32) {
                a += p[2 * i];
                b += p[2 * i + 1];
              }
#pragma unroll
              for (int off = 16; off > 0; off >>= 1) {
                a += __shfl_xor_sync(0xffffffffu, a, off);
                b += __shfl_xor_sync(0xffffffffu, b, off);
              }
              m_lo = m_hi = moments(a, b, (float)g.k_valid * (float)g.m_cols);
              item_have = item;
            }
          } else {
            const float2 t0 = sum_pairs(g.stats2 + 2 * (size_t)(row0 + lane) * g.n2s, g.n2s);
            const float2 t1 = sum_pairs(g.stats2 + 2 * (size_t)(row0 + lane + 32) * g.n2s, g.n2s);
            m_lo = moments(t0.x, t0.y, (float)g.m_cols);
            m_hi = moments(t1.x, t1.y, (float)g.m_cols);
          }
        }
        if (kb >= C::STAGES) mbar_wait(empty0 + 8 * s, ((kb / C::STAGES) - 1) & 1);
        if (lane == 0) {
          const uint32_t st = sbase + s * C::STAGE_BYTES, bar = full0 + 8 * s;
          mbar_expect_tx(bar, C::STAGE_BYTES);
#pragma unroll
          for (int c = 0; c < C::BMW / 64; ++c)
            tma_load(st + c * BOX_BYTES, &maps.m, bar, m0 + 64 * c, row0);
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            tma_load(st + (C::BMW / 64 + c) * BOX_BYTES, n_map, bar, ncol0 + 64 * c, row0);
        }
        if constexpr (ZMODE) {
          mom_s[s * 64 + lane] = m_lo;
          mom_s[s * 64 + lane + 32] = m_hi;
          __threadfence_block();
          __syncwarp();
          if (lane == 0) mbar_arrive(full0 + 8 * s);
        }
      }
    }
    cluster_sync();  // the cluster's tiles are written
    cluster_sync();  // and read
  } else {
    // ---- consumers: warpgroup wg takes M-side columns m0 + 64 wg .. +63 ---
    setmaxnreg_inc232();
    const int t = tid & 127, warp = t >> 5, lane = t & 31, gq = lane >> 2, q = lane & 3;
    // z form: this thread's fragment rows of M are 16 warp + gq (+ 8).
    float glo = 0.f, ghi = 0.f, blo = 0.f, bhi = 0.f, a2 = 0.f;
    if constexpr (ZMODE) {
      const int m = m0 + 64 * wg + 16 * warp + gq;
      a2 = *g.alpha2;
      glo = g.g2[m];
      ghi = g.g2[m + 8];
      blo = g.b2[m];
      bhi = g.b2[m + 8];
    }
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    // z fragments, two buffers: a slice's wgmma RS reads its buffer while
    // the next slice's is formed.
    uint32_t fa[4][4], fb[4][4];

    auto step = [&](int kb, uint32_t (&af)[4][4], uint32_t (&other)[4][4]) {
      const int s = kb % C::STAGES;
      mbar_wait(full0 + 8 * s, (kb / C::STAGES) & 1);
      uint8_t* stp = base + s * C::STAGE_BYTES;
      const uint32_t abox = smem_u32(stp) + wg * BOX_BYTES;
      const uint32_t nbox = smem_u32(stp) + (C::BMW / 64) * BOX_BYTES;
      // Local rows < vrows are rows < K of their item; the rest are zeroed.
      const int vrows = min(64, max(0, g.k_valid - ((lo + kb) * 64) % g.kpad));
      if (vrows < 64) {
        // Bm's rows >= K: g (z form, shared by both warpgroups, each zeroes
        // half its boxes) or dy1 (din form, this warpgroup's own box).
        constexpr int NBX = ZMODE ? BN / 128 : 1;
        const int n = (64 - vrows) * 8;
        for (int b = 0; b < NBX; ++b) {
          uint8_t* zb = stp + (ZMODE ? C::BMW / 64 + wg * NBX + b : wg) * BOX_BYTES + vrows * 128;
          for (int i = t; i < n; i += 128)
            reinterpret_cast<uint4*>(zb)[i] = make_uint4(0u, 0u, 0u, 0u);
        }
        fence_proxy_async();
        if (ZMODE)
          named_sync(1, C::NC * 128);
        else
          named_sync(2 + wg, 128);
      }
      if constexpr (ZMODE) {
        // z = round(g2 * ehat + b2) on the A fragments: ldmatrix.trans of
        // the MN-major c box gives register i rows m = 16 warp + gq (+ 8 if i
        // odd) and data rows r, r + 1 with r = 16 kk + 8 (i / 2) + 2 q.
        const float4* ms = reinterpret_cast<const float4*>(mom_s + s * 64);
        const int j = lane >> 3;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int ra = 16 * kk + 8 * (j >> 1) + (lane & 7);
          ldsm_x4_t(af[kk], abox + ra * 128 + (((2 * warp + (j & 1)) ^ (ra & 7)) << 4));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = 16 * kk + 8 * (i >> 1) + 2 * q;
            const float4 mm = ms[r >> 1];  // (mean, inv) of rows r and r + 1
            const float gm = (i & 1) ? ghi : glo, bm = (i & 1) ? bhi : blo;
            const float2 x = unpack_bf16(af[kk][i]);
            const float z0 = r < vrows ? gm * ((prelu(x.x, a2) - mm.x) * mm.y) + bm : 0.f;
            const float z1 = r + 1 < vrows ? gm * ((prelu(x.y, a2) - mm.z) * mm.w) + bm : 0.f;
            af[kk][i] = pack_bf16(z0, z1);
          }
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) Wgmma<BN>::rs(acc, af[kk], desc_b(nbox, kk));
      } else {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) Wgmma<BN>::ss_ta(acc, desc_mn(abox, kk), desc_b(nbox, kk));
      }
      wgmma_commit();
      // Slice kb's product stays in flight; kb - 1's is done: release its
      // stage (and, z form, its fragments).
      wgmma_wait1();
      fence_regs(acc);
      if constexpr (ZMODE) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(other[kk]);
      }
      if (kb > 0 && t == 0) mbar_arrive(empty0 + 8 * ((kb - 1) % C::STAGES));
    };
    int kb = 0;
    for (; kb + 1 < nk; kb += 2) {
      step(kb, fa, fb);
      step(kb + 1, fb, fa);
    }
    if (kb < nk) step(kb, fa, fb);
    wgmma_wait0();
    fence_regs(acc);
    if constexpr (ZMODE) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(fa[kk]);
        fence_regs(fb[kk]);
      }
    }
    named_sync(1, C::NC * 128);  // both warpgroups are done with the ring

    // ---- the CTA's f32 tile into its own shared memory -------------------
    float* tile = reinterpret_cast<float*>(base);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = 8 * j + 2 * q;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = 64 * wg + 16 * warp + gq + 8 * hh;
        const float v0 = acc[4 * j + 2 * hh], v1 = acc[4 * j + 2 * hh + 1];
        if constexpr (ZMODE) {
          *reinterpret_cast<float2*>(tile + m * C::LD_Z + n) = make_float2(v0, v1);
        } else {
          tile[n * C::LD_T + m] = v0;
          tile[(n + 1) * C::LD_T + m] = v1;
        }
      }
    }
    cluster_sync();

    // ---- rank r sums rows [r, r + 1) * TR / CS of the cluster's tiles, in
    // rank order, and stores them as the cluster's partial ----------------
    constexpr int TR = ZMODE ? C::BMW : BN, TC = ZMODE ? BN : C::BMW;
    constexpr int LD = ZMODE ? C::LD_Z : C::LD_T;
    const int cs = g.cluster, rows_per = TR / cs;
    const int r0 = (int)cluster_rank() * rows_per;
    const int orow0 = ZMODE ? m0 : n0, ocol0 = ZMODE ? n0 : m0;
    const int ldo = ZMODE ? g.n_cols : g.m_cols;
    float* out = g.part + (size_t)(blockIdx.y / cs) * (size_t)g.m_cols * g.n_cols;
#pragma unroll 2
    for (int u = tid; u < rows_per * (TC / 4); u += C::NC * 128) {
      const int r = r0 + u / (TC / 4), c4 = 4 * (u % (TC / 4));
      const uint32_t a = sbase + (uint32_t)(r * LD + c4) * 4u;
      float4 w[8];  // every rank's value in flight at once, then summed in rank order
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k < cs) w[k] = ld_cluster_f4(mapa(a, k));
      float4 v = w[0];
#pragma unroll
      for (int k = 1; k < 8; ++k)
        if (k < cs) {
          v.x += w[k].x;
          v.y += w[k].y;
          v.z += w[k].z;
          v.w += w[k].w;
        }
      *reinterpret_cast<float4*>(out + (size_t)(orow0 + r) * ldo + ocol0 + c4) = v;
    }
    cluster_sync();  // no CTA leaves while another reads its tile
  }
}

template <bool ZMODE, int BN>
__global__ void __launch_bounds__(WCfg<BN>::THREADS, 1)
    wgrad_sm90_kernel(const __grid_constant__ WMaps maps, const WArgs g) {
  wgrad_body<ZMODE, BN, false>(maps, g);
}

// The skip mode (z form), a kernel of its own so that its records carry its
// own name.
template <int BN>
__global__ void __launch_bounds__(WCfg<BN>::THREADS, 1)
    wgrad_skip_kernel(const __grid_constant__ WMaps maps, const WArgs g) {
  wgrad_body<true, BN, true>(maps, g);
}

template <bool ZMODE, int BN, bool SKIP> constexpr auto wgrad_fn() {
  if constexpr (SKIP)
    return wgrad_skip_kernel<BN>;
  else
    return wgrad_sm90_kernel<ZMODE, BN>;
}

template <bool ZMODE, int BN, bool SKIP = false> static cudaError_t wgrad_opt_in() {
  // The shared-memory opt-in, once per device (a host call of its own).
  static bool opted[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    cudaError_t e = cudaFuncSetAttribute(wgrad_fn<ZMODE, BN, SKIP>(),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         WCfg<BN>::SMEM);
    if (e != cudaSuccess) return e;
    opted[dev] = true;
  }
  return cudaSuccess;
}

template <bool ZMODE, int BN>
static cudaLaunchConfig_t wgrad_config(int ctas, int splits, int cluster, cudaStream_t s,
                                       cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, splits, 1);
  cfg.blockDim = dim3(WCfg<BN>::THREADS, 1, 1);
  cfg.dynamicSmemBytes = WCfg<BN>::SMEM;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = cluster;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool ZMODE, int BN, bool SKIP = false>
static cudaError_t wgrad_launch(const WMaps& m, const WArgs& g, cudaStream_t s) {
  cudaError_t e = wgrad_opt_in<ZMODE, BN, SKIP>();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = wgrad_config<ZMODE, BN>(
      (g.m_cols / WCfg<BN>::BMW) * (g.n_cols / BN), g.splits, g.cluster, s, &attr);
  e = cudaLaunchKernelEx(&cfg, wgrad_fn<ZMODE, BN, SKIP>(), m, g);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// N-side columns per CTA (tcn_block_bwd.wgrad_bn): 256 where they tile
// n_cols and a tile starts at the skip mode's seam, else 128.
static inline int wgrad_bn(int n_cols, int seam = 0) {
  return n_cols % 256 == 0 && seam % 256 == 0 ? 256 : 128;
}

// Checks the plan (tcn_block_bwd.wgrad_plan) and launches; anything the
// kernel does not tile is refused before a launch.
static cudaError_t wgrad_sm90(const WMaps& m, const WArgs& g, int rows, bool z, cudaStream_t s) {
  const int cs = g.cluster;
  if (rows <= 0 || rows % 64 || g.kpad % 64 || rows % g.kpad || g.m_cols % 128 ||
      g.n_cols % 128 || g.slices != rows / 64 || g.splits < 1 || g.splits > g.slices ||
      (cs != 1 && cs != 2 && cs != 4 && cs != 8) || g.splits % cs)
    return cudaErrorInvalidValue;
  if (g.nsplit) {
    if (!z || g.nsplit < 0 || g.nsplit >= g.n_cols || g.nsplit % 128) return cudaErrorInvalidValue;
    return wgrad_bn(g.n_cols, g.nsplit) == 256 ? wgrad_launch<true, 256, true>(m, g, s)
                                               : wgrad_launch<true, 128, true>(m, g, s);
  }
  if (wgrad_bn(g.n_cols) == 256)
    return z ? wgrad_launch<true, 256>(m, g, s) : wgrad_launch<false, 256>(m, g, s);
  return z ? wgrad_launch<true, 128>(m, g, s) : wgrad_launch<false, 128>(m, g, s);
}

// How many clusters of `cluster` CTAs of the kernel can be resident at once
// (cudaOccupancyMaxActiveClusters at its shared-memory size).
template <int BN> static cudaError_t wgrad_max_clusters(int cluster, int* out) {
  cudaError_t e = wgrad_opt_in<true, BN>();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = wgrad_config<true, BN>(1, cluster, cluster, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(out, wgrad_sm90_kernel<true, BN>, &cfg);
}

}  // namespace tcn
