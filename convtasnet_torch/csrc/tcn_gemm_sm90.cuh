// The bf16 GEMM pipeline of K1 tcn_in_gemm and K3 tcn_out_gemm (fold and
// unfold, tcn_block.cu), KB1 tcn_bwd_dz and KB3 tcn_bwd_dx (tcn_block_bwd.cu)
// on Hopper: one kernel template, five modes.
//
//   H_FOLD    out = round(res + round(inv * (e @ W') + (b2W - inv*mean*g2W)))
//             (cLN: inv * (t - mean * g2W) + b2W); A = e straight from shared
//             memory (wgmma SS)
//   H_UNFOLD  out = round(res + round(z @ W)), z = round(g2*(e-mean)*inv + b2)
//             formed in registers from the e tile (wgmma RS)
//   H_DX      da = round(inv1*(db*g1 - mean(db*g1) - ahat*mean(db*g1*ahat))),
//             dy1 = round(da * PReLU1'(y1)) formed in registers from the db
//             and y1 tiles (wgmma RS) and stored; dx = round(round(dy1 @ W)
//             + g); per-tile partial of d_alpha1 = sum da * min(y1, 0)
//   H_IN      y1 = round(x @ in_w) (A = x, wgmma SS); partial sums of
//             a = PReLU1(y1) and a^2 per row and column tile (cLN) or per
//             CTA (gLN); x's pad rows are zero, so they add nothing
//   H_DZ      dz = round(g @ out_w^T) (A = g, wgmma SS), exactly 0 on rows
//             >= K (selected, not multiplied: g may hold anything there);
//             ehat = (PReLU2(c) - mean2) * inv2 with c read as 0 on rows
//             >= K; per row tile the column partials sum dz*ehat and sum
//             dz; the norm2-backward partials sum dz*g2 and sum dz*g2*ehat
//             per row and column tile (cLN) or per CTA (gLN)
//
// Rows >= K (per item) of out / dz come out exactly zero; the rounding
// points are those of the SIMT versions in tcn_block.cu / tcn_block_bwd.cu.
//
// Skip modes (hgemm_skip_kernel, the same body with SKIP; a block with a
// skip path, the paper's final version): FOLD and UNFOLD over the columns
// of [out_w | skip_w], those < nsplit (= B) added into res / out as above
// and those >= nsplit into the skip sum (res2 = out2 = s) in place, so e
// is read once for both; every column tile lies wholly on one side. DZ
// with a depth of B + Sc from two operands: slices < nsplit from a (g),
// the rest from a2 (g_s, the skip sum's cotangent).
//
// Design (bound: device-memory bytes, ~40-57 MB per launch at the paper
// config, against 6.7-8.4 GFLOP):
// - A CTA takes BM = 64 * NC rows and BN output columns: BN is all of B
//   when B <= 256, so the A stream (e, or db and y1) is read once and KB3
//   forms dy1 once per row; K1 and KB1 (H = 512 columns) take two column
//   tiles of 256 per row tile, and their A (x, g: depth B = 256, 4 ring
//   slices) is read twice, the second time mostly from L2. The wrapper
//   picks (BM, BN) from the row count (tcn_block.gemm_plan) to limit the
//   last wave's idle SMs.
// - Warp specialised: NC consumer warpgroups (64 rows each, f32 accumulators
//   in registers, wgmma m64nBNk16) and one producer warp that keeps a ring
//   of STAGES [BM, 64] A slices and [64, BN] W slices in flight with TMA,
//   signalled on mbarriers. W (256 KB) streams from L2 with the A tiles.
// - The producer first loads the epilogue's residual tile (res for K3, g
//   for KB3, c for KB1), so it is in shared memory when the product is done.
//   K1 has none: it stages y1 in the ring once the main loop is done, which
//   leaves room for all four slices of its depth in flight at once.
// - The epilogue works from the accumulator registers: it reads the
//   residual from shared memory, writes the result over it and stores the
//   tile with TMA. An in-place K3 (out == res) reads each tile's rows before
//   any write to them, and no other CTA touches them.
// - KB1's column partials replace the accumulators they are formed from
//   (two rows per thread), then fold over the 8 row lanes of a warp by
//   halving exchanges (each lane keeps half the columns per step: 7/8 fewer
//   shuffles than a full tree), then over warps in index order through
//   shared memory (the ring, free by then).
// - Statistics are reduced in a fixed order: no float atomics, results
//   repeat bit for bit.
#pragma once

#include "hopper_gemm.cuh"
#include "tcn_block.cuh"

namespace tcn {

enum HMode { H_FOLD = 0, H_UNFOLD = 1, H_DX = 2, H_IN = 3, H_DZ = 4 };

struct HArgs {
  const float* stats;   // FOLD / UNFOLD / DZ: K2's partials of e; DX: K1's of a
  int n_stats;          // pairs per item (gLN) or per row (cLN)
  const float* gs;      // DX: KB2's partials of (sum db*g1, sum db*g1*ahat)
  int n_gs;
  const float* alpha;   // DX, IN: PReLU1 slope; DZ: PReLU2 slope
  const float* vec_a;   // FOLD: g2 @ W [ncols]; UNFOLD: g2 [kdim]; DX: g1 [kdim];
                        // DZ: g2 [ncols]
  const float* vec_b;   // FOLD: b2 @ W [ncols]; UNFOLD: b2 [kdim]
  float* da1part;       // DX: [rows / BM], written by the blockIdx.y == 0 CTAs
  float* part;          // IN: partials of a; DZ: of the norm2 backward. cLN
                        // [rows, ncols / BN] pairs, gLN [rows / BM * ncols / BN]
  float* colpart;       // DZ: [rows / BM, 2, ncols]: sum dz*ehat, sum dz
  int kpad, k_valid, kdim, ncols, gln;
  int nsplit;           // skip modes: B, the column (FOLD / UNFOLD) or depth (DZ) of the seam
};

// a: the A stream [rows, kdim] (e; db in DX; x in IN; g in DZ), box [BM, 64];
// a2: y1 (DX); g_s (DZ skip); w: [kdim, ncols], box [64, 64]; res, out:
// [rows, ncols], box [64, 64] (res: c in DZ, unused in IN); dy1: [rows,
// kdim], box [64, 64] (DX); res2, out2: the skip sum [rows, ncols - nsplit]
// (FOLD / UNFOLD skip).
struct HMaps {
  CUtensorMap a, a2, w, res, out, dy1, res2, out2;
};

template <int MODE, int BN, int NC> struct HCfg {
  static constexpr int BM = 64 * NC;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int NA = MODE == H_DX ? 2 : 1;
  static constexpr int A_BYTES = BM * 128;
  static constexpr int W_BYTES = (BN / 64) * hop::BOX_BYTES;
  static constexpr int STAGE_BYTES = NA * A_BYTES + W_BYTES;
  static constexpr int TILE_BYTES = BM * BN * 2;
  static constexpr int RES_BYTES = MODE == H_IN ? 0 : TILE_BYTES;  // IN: y1 in the ring
  static constexpr int STG_BYTES = MODE == H_DX ? NC * hop::BOX_BYTES : 0;
  static constexpr int MOM_BYTES = BM * 16;
  static constexpr int FIXED =
      1024 /* alignment */ + RES_BYTES + STG_BYTES + hop::VEC_BYTES + MOM_BYTES + 512;
  static constexpr int S0 = (hop::SMEM_LIMIT - FIXED) / STAGE_BYTES;
  static constexpr int STAGES = S0 > 4 ? 4 : S0;
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert(MODE != H_IN || STAGES * STAGE_BYTES >= TILE_BYTES, "IN stages y1 in the ring");
  static_assert(MODE != H_DZ || STAGES * STAGE_BYTES >= NC * 4 * 2 * BN * 4,
                "DZ sums its column partials in the ring");
  static constexpr int SMEM = FIXED + STAGES * STAGE_BYTES;
};

// v[0 .. HALF) += the partner lane's v[HALF .. 2 HALF) (lane bit `mask`
// clear) or v[HALF ..) + the partner's v[0 ..) into v[0 ..) (bit set): one
// step of a fold over lanes in which each lane keeps half the values.
template <int HALF, int N>
__device__ __forceinline__ void fold_half(float (&v)[N], int mask, bool up) {
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? v[i] : v[i + HALF];
    const float keep = up ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

template <int MODE, int BN, int NC, bool SKIP>
__device__ __forceinline__ void hgemm_body(const HMaps& maps, const HArgs& g) {
  using C = HCfg<MODE, BN, NC>;
  using namespace hop;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* fixed_s = base + C::STAGES * C::STAGE_BYTES;
  uint8_t* res_s = MODE == H_IN ? base : fixed_s;
  uint8_t* stg_s = fixed_s + C::RES_BYTES;
  float* vec_s = reinterpret_cast<float*>(stg_s + C::STG_BYTES);
  float4* mom_s = reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(vec_s) + VEC_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(mom_s) + C::MOM_BYTES);
  float2* red = reinterpret_cast<float2*>(bars + 2 * C::STAGES + 2);  // [16]
  float* red2 = reinterpret_cast<float*>(red + 16);                    // [8]

  const int tid = threadIdx.x, wg = tid / 128;
  const int row0 = blockIdx.x * C::BM, col0 = blockIdx.y * BN;
  const int item = row0 / g.kpad;
  const int nk = g.kdim / HBK;
  const uint32_t sbase = smem_u32(base), sres = smem_u32(res_s);
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * C::STAGES;
  const uint32_t resbar = full0 + 16 * C::STAGES;
  const bool leader = tid == NC * 128;  // the producer's issuing thread
  // The residual / output tile's map and column: the skip sum's past the
  // seam (FOLD / UNFOLD skip).
  const bool to_skip = SKIP && MODE != H_DZ && col0 >= g.nsplit;
  const CUtensorMap* res_map = to_skip ? &maps.res2 : &maps.res;
  const CUtensorMap* out_map = to_skip ? &maps.out2 : &maps.out;
  const int ocol0 = to_skip ? col0 - g.nsplit : col0;

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NC);
    }
    mbar_init(resbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  auto issue_stage = [&](int kb) {
    const int s = kb % C::STAGES;
    const uint32_t st = sbase + s * C::STAGE_BYTES, bar = full0 + 8 * s;
    mbar_expect_tx(bar, C::STAGE_BYTES);
    if (SKIP && MODE == H_DZ && kb * HBK >= g.nsplit)
      tma_load(st, &maps.a2, bar, kb * HBK - g.nsplit, row0);
    else
      tma_load(st, &maps.a, bar, kb * HBK, row0);
    if constexpr (MODE == H_DX) tma_load(st + C::A_BYTES, &maps.a2, bar, kb * HBK, row0);
#pragma unroll
    for (int c = 0; c < BN / 64; ++c)
      tma_load(st + C::NA * C::A_BYTES + c * BOX_BYTES, &maps.w, bar, col0 + 64 * c, kb * HBK);
  };
  if (leader) {
    // The residual tile first, then the first STAGES slices (the ring
    // starts empty), all while the CTA reduces its statistics below.
    if constexpr (MODE != H_IN) {
      mbar_expect_tx(resbar, C::RES_BYTES);
      for (int w = 0; w < NC; ++w)
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load(sres + (w * (BN / 64) + c) * BOX_BYTES, res_map, resbar, ocol0 + 64 * c,
                   row0 + 64 * w);
    }
    for (int kb = 0; kb < C::STAGES && kb < nk; ++kb) issue_stage(kb);
  }

  // Per-column vectors and per-row norm terms, by every thread.
  if constexpr (MODE == H_FOLD || MODE == H_DZ) {
    for (int c = tid; c < BN; c += blockDim.x) {
      vec_s[c] = g.vec_a[col0 + c];
      if constexpr (MODE == H_FOLD) vec_s[BN + c] = g.vec_b[col0 + c];
    }
  } else if constexpr (MODE != H_IN) {
    for (int h = tid; h < g.kdim; h += blockDim.x) {
      vec_s[h] = g.vec_a[h];
      if constexpr (MODE == H_UNFOLD) vec_s[g.kdim + h] = g.vec_b[h];
    }
  }
  if constexpr (MODE == H_FOLD || MODE == H_UNFOLD || MODE == H_DZ) {
    // norm2 moments of e (mean, inv) over its H channels (kdim; ncols in
    // DZ): one pair per item (gLN) or per row.
    const float nch = (float)(MODE == H_DZ ? g.ncols : g.kdim);
    if (g.gln) {
      const float2 t = reduce_partials(g.stats + 2 * (size_t)item * g.n_stats, g.n_stats, red);
      const float2 mm = moments(t.x, t.y, (float)g.k_valid * nch);
      for (int r = tid; r < C::BM; r += blockDim.x) mom_s[r] = make_float4(mm.x, mm.y, 0.f, 0.f);
    } else {
      for (int r = tid; r < C::BM; r += blockDim.x) {
        const float2 t = sum_pairs(g.stats + 2 * (size_t)(row0 + r) * g.n_stats, g.n_stats);
        const float2 mm = moments(t.x, t.y, nch);
        mom_s[r] = make_float4(mm.x, mm.y, 0.f, 0.f);
      }
    }
  } else if constexpr (MODE == H_DX) {
    // (mean1, inv1, mean(db*g1), mean(db*g1*ahat)) per row.
    if (g.gln) {
      const float n = (float)g.k_valid * (float)g.kdim;
      const float2 t1 = reduce_partials(g.stats + 2 * (size_t)item * g.n_stats, g.n_stats, red);
      const float2 tg = reduce_partials(g.gs + 2 * (size_t)item * g.n_gs, g.n_gs, red);
      const float2 m1 = moments(t1.x, t1.y, n);
      for (int r = tid; r < C::BM; r += blockDim.x)
        mom_s[r] = make_float4(m1.x, m1.y, tg.x / n, tg.y / n);
    } else {
      const float n = (float)g.kdim;
      for (int r = tid; r < C::BM; r += blockDim.x) {
        const size_t row = (size_t)row0 + r;
        const float2 t1 = sum_pairs(g.stats + 2 * row * g.n_stats, g.n_stats);
        const float2 tg = sum_pairs(g.gs + 2 * row * g.n_gs, g.n_gs);
        const float2 m1 = moments(t1.x, t1.y, n);
        mom_s[r] = make_float4(m1.x, m1.y, tg.x / n, tg.y / n);
      }
    }
  }
  __syncthreads();

  if (wg == NC) {
    // ---- producer ----------------------------------------------------------
    if (NC == 2) setmaxnreg_dec40();
    if (leader) {
      for (int kb = C::STAGES; kb < nk; ++kb) {
        const int s = kb % C::STAGES;
        mbar_wait(empty0 + 8 * s, ((kb / C::STAGES) - 1) & 1);
        issue_stage(kb);
      }
    }
  } else {
    // ---- consumers: warpgroup wg takes tile rows 64 wg .. 64 wg + 63 --------
    if (NC == 2) setmaxnreg_inc232();
    const int warp = (tid >> 5) & 3, lane = tid & 31, gq = lane >> 2, q = lane & 3;
    const int rl0 = 16 * warp + gq;  // this thread's rows in the warpgroup: rl0, rl0 + 8
    const float4 m0 = mom_s[64 * wg + rl0], m1 = mom_s[64 * wg + rl0 + 8];
    const bool v0 = (row0 + 64 * wg + rl0) % g.kpad < g.k_valid;
    const bool v1 = (row0 + 64 * wg + rl0 + 8) % g.kpad < g.k_valid;
    const bool store_dy1 = MODE == H_DX && blockIdx.y == 0;
    const float slope = MODE == H_DX || MODE == H_IN || MODE == H_DZ ? *g.alpha : 0.f;
    const uint32_t stg = smem_u32(stg_s) + wg * BOX_BYTES;
    float da1acc = 0.f;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    // Per k-slice: wait for its stage, form the A fragments (RS), run four
    // wgmma k16 steps, wait for them and release the stage. (Keeping one
    // slice's wgmma in flight across the next slice's prologue measured no
    // faster for K3 and slower for KB3 on the H100.)
    for (int kb = 0; kb < nk; ++kb) {
      const int s = kb % C::STAGES;
      mbar_wait(full0 + 8 * s, (kb / C::STAGES) & 1);
      const uint32_t st = sbase + s * C::STAGE_BYTES;
      const uint32_t abox = st + wg * 64 * 128, wbox = st + C::NA * C::A_BYTES;
      if constexpr (MODE == H_FOLD || MODE == H_IN || MODE == H_DZ) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) Wgmma<BN>::ss(acc, desc_a(abox, kk), desc_b(wbox, kk));
        wgmma_commit();
        wgmma_wait0();
        fence_regs(acc);
      } else {
        // A-operand prologue: the raw tile(s) to registers, the elementwise
        // transform in f32, rounded to bf16 as the wgmma A fragment.
        uint32_t af[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          ldsm_x4(af[kk], frag_addr(abox, 16 * warp, kk, lane));
          uint32_t yf[4];
          if constexpr (MODE == H_DX) ldsm_x4(yf, frag_addr(abox + C::A_BYTES, 16 * warp, kk, lane));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // register i: row rl0 (+8 if i odd), columns h, h+1
            const int h = kb * HBK + kk * 16 + 2 * q + (i >= 2 ? 8 : 0);
            const float4 m = (i & 1) ? m1 : m0;
            const float2 x = unpack_bf16(af[kk][i]);
            if constexpr (MODE == H_UNFOLD) {
              const float2 ga = *reinterpret_cast<const float2*>(vec_s + h);
              const float2 gb = *reinterpret_cast<const float2*>(vec_s + g.kdim + h);
              af[kk][i] = pack_bf16(ga.x * ((x.x - m.x) * m.y) + gb.x,
                                    ga.y * ((x.y - m.x) * m.y) + gb.y);
            } else {
              const bool v = (i & 1) ? v1 : v0;
              const float2 y = unpack_bf16(yf[i]);
              const float2 g1 = *reinterpret_cast<const float2*>(vec_s + h);
              const float ah0 = (prelu(y.x, slope) - m.x) * m.y;
              const float ah1 = (prelu(y.y, slope) - m.x) * m.y;
              const float da0 = v ? round_dt<bf16>(m.y * (x.x * g1.x - m.z - ah0 * m.w)) : 0.f;
              const float da1 = v ? round_dt<bf16>(m.y * (x.y * g1.y - m.z - ah1 * m.w)) : 0.f;
              da1acc += da0 * fminf(y.x, 0.f);
              da1acc += da1 * fminf(y.y, 0.f);
              af[kk][i] = pack_bf16(da0 * dprelu(y.x, slope), da1 * dprelu(y.y, slope));
            }
          }
        }
        if (store_dy1) {
          // dy1 slice [64 rows, 64 cols]: registers -> staging box -> TMA
          // store; the previous slice's store must have read the box.
          if ((tid & 127) == 0) bulk_wait_read();
          named_sync(1 + wg, 128);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) stsm_x4(frag_addr(stg, 16 * warp, kk, lane), af[kk]);
          fence_proxy_async();
          named_sync(1 + wg, 128);
          if ((tid & 127) == 0) {
            tma_store(&maps.dy1, stg, kb * HBK, row0 + 64 * wg);
            bulk_commit();
          }
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) Wgmma<BN>::rs(acc, af[kk], desc_b(wbox, kk));
        wgmma_commit();
        wgmma_wait0();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(af[kk]);
      }
      if ((tid & 127) == 0) mbar_arrive(empty0 + 8 * s);
    }

    // ---- epilogue: accumulators + residual tile in shared memory ----------
    // The word of (row rl, columns 8 j + 2 q, + 1) in a warpgroup's [64, BN]
    // tile of swizzled boxes (rl % 8 == gq for this thread's rows).
    auto word = [&](uint8_t* box, int j, int rl) {
      return reinterpret_cast<uint32_t*>(box + (j / 8) * BOX_BYTES + rl * 128 +
                                         (((j & 7) ^ gq) << 4) + 4 * q);
    };
    // The warpgroup's tile leaves by TMA once every thread's writes are
    // visible to the async proxy; the issuing thread waits for the read
    // before the CTA exits (bulk_wait_read).
    auto store_tile = [&](uint8_t* box) {
      fence_proxy_async();
      named_sync(1 + wg, 128);
      if ((tid & 127) == 0) {
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_store(out_map, smem_u32(box) + c * BOX_BYTES, ocol0 + 64 * c, row0 + 64 * wg);
        bulk_commit();
      }
    };
    // (s, ss) over the CTA's columns of this thread's rows rl0, rl0 + 8 ->
    // g.part: per row and column tile (cLN: the row's 4 lanes in xor order)
    // or per CTA (gLN: lanes, then warps in index order). Syncs the
    // consumers (barrier 15).
    auto norm_partials = [&](float (&s)[2], float (&ss)[2]) {
      if (g.gln) {
        float t = s[0] + s[1], tt = ss[0] + ss[1];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          t += __shfl_xor_sync(0xffffffffu, t, off);
          tt += __shfl_xor_sync(0xffffffffu, tt, off);
        }
        if (lane == 0) red[wg * 4 + warp] = make_float2(t, tt);
        named_sync(15, NC * 128);
        if (tid == 0) {
          float2 sum = make_float2(0.f, 0.f);
          for (int w = 0; w < NC * 4; ++w) {
            sum.x += red[w].x;
            sum.y += red[w].y;
          }
          float* p = g.part + 2 * ((size_t)blockIdx.x * gridDim.y + blockIdx.y);
          p[0] = sum.x;
          p[1] = sum.y;
        }
      } else {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            s[hh] += __shfl_xor_sync(0xffffffffu, s[hh], off);
            ss[hh] += __shfl_xor_sync(0xffffffffu, ss[hh], off);
          }
          if (q == 0) {
            const size_t row = (size_t)row0 + 64 * wg + rl0 + 8 * hh;
            float* p = g.part + 2 * (row * gridDim.y + blockIdx.y);
            p[0] = s[hh];
            p[1] = ss[hh];
          }
        }
        named_sync(15, NC * 128);
      }
    };

    if constexpr (MODE == H_IN) {
      // y1 = round(acc) into the ring, once both warpgroups are past their
      // last wgmma; partials of a = PReLU1(y1) and a^2 from the rounded y1.
      named_sync(15, NC * 128);
      uint8_t* ybox = res_s + wg * (BN / 64) * BOX_BYTES;
      float rs[2] = {0.f, 0.f}, rss[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const uint32_t y = pack_bf16(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
          *word(ybox, j, rl0 + 8 * hh) = y;
          const float2 yf = unpack_bf16(y);
          const float a0 = prelu(yf.x, slope), a1 = prelu(yf.y, slope);
          rs[hh] += a0 + a1;
          rss[hh] += a0 * a0 + a1 * a1;
        }
      }
      store_tile(ybox);
      // x's pad rows are zero, so their y1 and a are zero and add nothing.
      norm_partials(rs, rss);
      if ((tid & 127) == 0) bulk_wait_read();
    } else if constexpr (MODE == H_DZ) {
      mbar_wait(resbar, 0);
      uint8_t* rbox = res_s + wg * (BN / 64) * BOX_BYTES;
      float ns[2] = {0.f, 0.f}, nss[2] = {0.f, 0.f};  // sum dz*g2, sum dz*g2*ehat
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 gv = *reinterpret_cast<const float2*>(vec_s + 8 * j + 2 * q);
        float2 d[2], e[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float4 m = hh ? m1 : m0;
          const bool v = hh ? v1 : v0;
          uint32_t* p = word(rbox, j, rl0 + 8 * hh);
          // Rows >= K: c (saved unmasked) reads as 0 and dz is 0, both by
          // selection, so whatever g or c hold there stays out.
          const float2 cv = v ? unpack_bf16(*p) : make_float2(0.f, 0.f);
          const uint32_t dzw = v ? pack_bf16(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]) : 0u;
          *p = dzw;  // dz over c
          d[hh] = unpack_bf16(dzw);
          e[hh] = make_float2((prelu(cv.x, slope) - m.x) * m.y, (prelu(cv.y, slope) - m.x) * m.y);
          const float z0 = d[hh].x * gv.x, z1 = d[hh].y * gv.y;
          ns[hh] += z0 + z1;
          nss[hh] += z0 * e[hh].x + z1 * e[hh].y;
        }
        // Column partials over the thread's two rows, in the slots of the
        // accumulators they came from: 4 j + 0 / 1 sum dz*ehat of columns
        // 8 j + 2 q / + 1, 4 j + 2 / 3 sum dz.
        acc[4 * j] = d[0].x * e[0].x + d[1].x * e[1].x;
        acc[4 * j + 1] = d[0].y * e[0].y + d[1].y * e[1].y;
        acc[4 * j + 2] = d[0].x + d[1].x;
        acc[4 * j + 3] = d[0].y + d[1].y;
      }
      store_tile(rbox);
      // Fold over the warp's 8 row lanes (lane bits 4, 8, 16): then acc[i]
      // holds slot i + NF * sel of the order above, over the warp's 16 rows.
      constexpr int NV = BN / 2, NF = BN / 16;
      fold_half<NV / 2>(acc, 4, lane & 4);
      fold_half<NV / 4>(acc, 8, lane & 8);
      fold_half<NV / 8>(acc, 16, lane & 16);
      const int sel = ((lane >> 2) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 4) & 1);
      // Warp totals [4 NC warps][2][BN] in the ring (free once both
      // warpgroups are past their last wgmma), summed in warp order.
      float* colred = reinterpret_cast<float*>(base);
      named_sync(15, NC * 128);
      float* mine = colred + (wg * 4 + warp) * 2 * BN;
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        const int o = i + NF * sel;
        mine[((o & 2) ? BN : 0) + 8 * (o >> 2) + 2 * q + (o & 1)] = acc[i];
      }
      norm_partials(ns, nss);  // also makes colred complete
      for (int t = tid; t < 2 * BN; t += NC * 128) {
        float sum = 0.f;
        for (int w = 0; w < NC * 4; ++w) sum += colred[w * 2 * BN + t];
        g.colpart[(size_t)blockIdx.x * 2 * g.ncols + (t >= BN ? g.ncols : 0) + col0 + t % BN] =
            sum;
      }
      if ((tid & 127) == 0) bulk_wait_read();
    } else {
      mbar_wait(resbar, 0);
      uint8_t* rbox = res_s + wg * (BN / 64) * BOX_BYTES;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int cl = 8 * j + 2 * q;  // column within the CTA's BN
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          uint32_t* p = word(rbox, j, rl0 + 8 * hh);
          const float t0 = acc[4 * j + 2 * hh], t1 = acc[4 * j + 2 * hh + 1];
          const float4 m = hh ? m1 : m0;
          const bool v = hh ? v1 : v0;
          const float2 r = unpack_bf16(*p);
          float o0, o1;
          if constexpr (MODE == H_FOLD) {
            const float2 va = *reinterpret_cast<const float2*>(vec_s + cl);
            const float2 vb = *reinterpret_cast<const float2*>(vec_s + BN + cl);
            if (g.gln) {
              o0 = m.y * t0 + (vb.x - (m.y * m.x) * va.x);
              o1 = m.y * t1 + (vb.y - (m.y * m.x) * va.y);
            } else {
              o0 = m.y * (t0 - m.x * va.x) + vb.x;
              o1 = m.y * (t1 - m.x * va.y) + vb.y;
            }
          } else {
            o0 = t0;
            o1 = t1;
          }
          // K3: round(res + round(o)); KB3: round(round(acc) + g). Rows >= K
          // are exact zeros (norm2's bias makes o non-zero there).
          *p = v ? pack_bf16(r.x + round_dt<bf16>(o0), r.y + round_dt<bf16>(o1)) : 0u;
        }
      }
      store_tile(rbox);
      if ((tid & 127) == 0) bulk_wait_read();
      if constexpr (MODE == H_DX) {
        // d_alpha1 partial of the tile: warps in index order.
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) da1acc += __shfl_xor_sync(0xffffffffu, da1acc, off);
        if (lane == 0) red2[wg * 4 + warp] = da1acc;
        named_sync(15, NC * 128);
        if (tid == 0 && store_dy1) {
          float t = 0.f;
          for (int w = 0; w < NC * 4; ++w) t += red2[w];
          g.da1part[blockIdx.x] = t;
        }
      }
    }
  }
}

template <int MODE, int BN, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    hgemm_kernel(const __grid_constant__ HMaps maps, const HArgs g) {
  hgemm_body<MODE, BN, NC, false>(maps, g);
}

// The skip modes, a kernel of their own so that their records carry
// their own name.
template <int MODE, int BN, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    hgemm_skip_kernel(const __grid_constant__ HMaps maps, const HArgs g) {
  hgemm_body<MODE, BN, NC, true>(maps, g);
}

template <int MODE, int BN, int NC, bool SKIP> constexpr auto hgemm_fn() {
  if constexpr (SKIP)
    return hgemm_skip_kernel<MODE, BN, NC>;
  else
    return hgemm_kernel<MODE, BN, NC>;
}

// The shared-memory opt-in, once per device (a host call of its own).
template <int MODE, int BN, int NC, bool SKIP> static cudaError_t hgemm_opt_in() {
  static bool opted[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    cudaError_t e = cudaFuncSetAttribute(hgemm_fn<MODE, BN, NC, SKIP>(),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         HCfg<MODE, BN, NC>::SMEM);
    if (e != cudaSuccess) return e;
    opted[dev] = true;
  }
  return cudaSuccess;
}

template <int MODE, int BN, int NC, bool SKIP>
static cudaError_t hgemm_launch(const HMaps& m, const HArgs& g, int rows, cudaStream_t s) {
  using C = HCfg<MODE, BN, NC>;
  cudaError_t e = hgemm_opt_in<MODE, BN, NC, SKIP>();
  if (e != cudaSuccess) return e;
  const dim3 grid(rows / C::BM, g.ncols / BN);
  if constexpr (SKIP)
    hgemm_skip_kernel<MODE, BN, NC><<<grid, C::THREADS, C::SMEM, s>>>(m, g);
  else
    hgemm_kernel<MODE, BN, NC><<<grid, C::THREADS, C::SMEM, s>>>(m, g);
  return cudaGetLastError();
}

// CTAs of the (bm, bn) kernel resident per SM at its shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), for tcn_block.gemm_plan;
// -1 for a tile the kernels do not take or a failed query.
template <int MODE, int BN, int NC, bool SKIP> static int hgemm_resident_t() {
  int n = -1;
  if (hgemm_opt_in<MODE, BN, NC, SKIP>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, hgemm_fn<MODE, BN, NC, SKIP>(),
                                                    HCfg<MODE, BN, NC>::THREADS,
                                                    HCfg<MODE, BN, NC>::SMEM) != cudaSuccess)
    return -1;
  return n;
}
template <int MODE, bool SKIP = false> static int hgemm_resident(int bm, int bn) {
  if (bm == 128 && bn == 256) return hgemm_resident_t<MODE, 256, 2, SKIP>();
  if (bm == 64 && bn == 256) return hgemm_resident_t<MODE, 256, 1, SKIP>();
  if (bm == 128 && bn == 128) return hgemm_resident_t<MODE, 128, 2, SKIP>();
  if (bm == 64 && bn == 128) return hgemm_resident_t<MODE, 128, 1, SKIP>();
  return -1;
}

// (bm, bn) as chosen by the wrapper (tcn_block.gemm_plan); anything the
// kernels do not tile is refused before a launch. SKIP: the skip modes of
// FOLD, UNFOLD (no column tile across the seam) and DZ (a seam between
// whole depth slices, and depth on both sides of it).
template <int MODE, bool SKIP = false>
static cudaError_t hgemm(const HMaps& m, const HArgs& g, int rows, int bm, int bn,
                         cudaStream_t s) {
  static_assert(!SKIP || MODE == H_FOLD || MODE == H_UNFOLD || MODE == H_DZ,
                "no skip mode of this kernel");
  const int vec = MODE == H_FOLD  ? 2 * bn
                : MODE == H_DZ  ? bn
                : MODE == H_IN  ? 0
                                : (MODE == H_UNFOLD ? 2 : 1) * g.kdim;
  if ((bm != 64 && bm != 128) || (bn != 128 && bn != 256) || rows % bm || g.kpad % bm ||
      g.ncols % bn || g.kdim % hop::HBK || vec * 4 > hop::VEC_BYTES)
    return cudaErrorInvalidValue;
  if (SKIP && (MODE == H_DZ ? g.nsplit <= 0 || g.nsplit >= g.kdim || g.nsplit % hop::HBK
                            : g.nsplit <= 0 || g.nsplit >= g.ncols || g.nsplit % bn))
    return cudaErrorInvalidValue;
  if (bm == 128 && bn == 256) return hgemm_launch<MODE, 256, 2, SKIP>(m, g, rows, s);
  if (bm == 64 && bn == 256) return hgemm_launch<MODE, 256, 1, SKIP>(m, g, rows, s);
  if (bm == 128 && bn == 128) return hgemm_launch<MODE, 128, 2, SKIP>(m, g, rows, s);
  if (bm == 64 && bn == 128) return hgemm_launch<MODE, 128, 1, SKIP>(m, g, rows, s);
  return cudaErrorInvalidValue;
}

}  // namespace tcn
