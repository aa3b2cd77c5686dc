// The depthwise kernels of a temporal block on Hopper (sm_90a): K2
// tcn_dwconv (forward, inference and save modes; tcn_block.cu) and KB2
// tcn_bwd_dwconv (its backward; tcn_block_bwd.cu). Both are staged stencils
// over tiles of `br` rows x `bc` channels of one batch item.
//
// Replaces the depthwise part of the TPU kernels
// convtasnet_tpu/ops/pallas/whole_tcn.py (_tcn_kernel, norm1 -> dilated
// depthwise conv -> PReLU2 and its gLN statistics, :139-188),
// ops/pallas/fused_whole_block.py (_block_kernel) and the depthwise backward
// of ops/pallas/whole_tcn_hybrid.py (_bwd_block_kernel, :186-209) and
// ops/pallas/whole_block_vjp.py (_bwd_kernel). The TPU kernels hold an
// item's [K + 2 span, H] slab in VMEM; here a CTA stages only the rows its
// taps reach.
//
// Bound: device-memory bytes. The conv is diagonal in the channels, so there
// is no product for tensor cores; at the paper config (H=512, bf16) K2 moves
// y1 in and e (and c) out, KB2 c, dz and y1 in and db out, a few operations
// per byte. What the design does about it:
//   - every global access is a 16-byte vector: a thread owns VEC = 8 (bf16)
//     or 4 (f32) consecutive channels, `lanes` threads a row's bc channels;
//   - the rows a tile's taps reach arrive as TMA boxes of DW_BOX rows x bc
//     channels (no swizzle: dense rows), completing on one mbarrier per
//     stage of `chunk` boxes, so the CTA converts one stage while the next
//     lands. The window is br + span rows when span <= (P-1)*br
//     ("contiguous": slot s holds row base + s), else P disjoint windows of
//     br rows ("disjoint": slot s holds row base + (s / br) * d + s % br);
//     either way at most P*br rows. Rows outside [0, K) stage as zero by
//     mask, not by the load (norm1's bias makes b non-zero there, a row past
//     the item's K_pad belongs to the next item, and TMA reads zeros only
//     outside the whole [M * K_pad, H] matrix);
//   - CTAs are persistent, as many as fit the card, each walking a
//     contiguous range of tiles (one item mostly, so its gLN moments are
//     reduced once). Its window buffer is reloaded as soon as the tile is
//     done; the loads of one CTA overlap the compute of the others on the
//     SM. (A second buffer, to prefetch the next tile inside the CTA,
//     measured slower on the H100: it halves the CTAs per SM.);
//   - each staged row is converted once, in place and in the working type,
//     which is exactly where the reference rounds: K2 b = round(g1 *
//     norm1(PReLU1(y1)) + b1), KB2 dc = round(round(de) * PReLU2'(c)). The P
//     taps of an output row then read the staged row P times from shared
//     memory, not device memory;
//   - per-channel parameters live in registers or come through L1;
//     statistics fold per thread, then in a fixed order (lanes by
//     xor-shuffle, then warps or row groups in index order), one partial per
//     tile, and no float atomic is used: two runs give the same bytes,
//     whatever the grid.
// The tile plan (br, lanes, staged rows, chunk, stages, shared memory) comes
// from tcn_block.dw_plan on the host.
#pragma once

#include <cstdint>
#include <map>

#include "hopper_gemm.cuh"
#include "tcn_block.cuh"

namespace tcn {

constexpr int DW_HEAD = 128;       // bytes of mbarriers ahead of the window buffer
constexpr int DW_MAX_STAGES = 8;   // KB2 has one more barrier, for its own y1 rows
constexpr int DW_BOX = 16;         // rows per TMA box (divides every br)

// Tile plan, from tcn_block.dw_plan.
struct DwTile {
  int br;       // rows per tile (divides K_pad)
  int lanes;    // threads per row: bc = lanes * VEC channels per tile
  int staged;   // window slots (rows) per staged stream
  int chunk;    // boxes of DW_BOX rows per stage (one mbarrier each)
  int stages;   // ceil(ceil(staged / DW_BOX) / chunk) <= DW_MAX_STAGES
};

// The CTA's tiles: a contiguous range [first, last) of the ntiles, so that
// consecutive tiles share their item (and its gLN moments).
struct TileRange {
  int first, last;
  __device__ TileRange(int ntiles) {
    first = (int)((long long)ntiles * blockIdx.x / gridDim.x);
    last = (int)((long long)ntiles * (blockIdx.x + 1) / gridDim.x);
  }
};

// Sums of (a, b, c) over the CTA in a fixed order, as block_sum2.
__device__ __forceinline__ float3 block_sum3(float a, float b, float c, float4* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
    c += __shfl_xor_sync(0xffffffffu, c, off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = make_float4(a, b, c, 0.f);
  __syncthreads();
  float3 t = make_float3(0.f, 0.f, 0.f);
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
    t.x += red[i].x;
    t.y += red[i].y;
    t.z += red[i].z;
  }
  __syncthreads();
  return t;
}

// Tensor maps over [M * kpad, H] with a box of DW_BOX rows x bc channels: K2
// y1 (a); KB2 c (a), dz (b) and y1 (c).
struct DwMaps {
  CUtensorMap a, b, c;
};

// A 16-byte vector to floats and back (rounding to nearest even, as
// from_f). The vector is taken by value: one 128-bit load, then register
// bit operations (a reference into shared memory would compile to one
// 16-bit load per element).
template <typename T> __device__ __forceinline__ void unpack(uint4 u, float* f);
template <> __device__ __forceinline__ void unpack<float>(uint4 u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void unpack<bf16>(uint4 u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T> __device__ __forceinline__ uint4 pack(const float* f);
template <> __device__ __forceinline__ uint4 pack<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
template <> __device__ __forceinline__ uint4 pack<bf16>(const float* f) {
  return make_uint4(hop::pack_bf16(f[0], f[1]), hop::pack_bf16(f[2], f[3]),
                    hop::pack_bf16(f[4], f[5]), hop::pack_bf16(f[6], f[7]));
}

// n consecutive floats (n a multiple of 4, 16-byte aligned).
template <int N> __device__ __forceinline__ void load_f(const float* p, float* f) {
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p + j));
    f[j] = v.x;
    f[j + 1] = v.y;
    f[j + 2] = v.z;
    f[j + 3] = v.w;
  }
}

// Slot <-> row arithmetic of a staged window (mirrored in Python by
// tcn_block.dw_window, dw_stride and dw_slot_of, which the CPU tests hold
// against the plain versions).
struct Window {
  int base, br, d;
  bool contig;
  __device__ __forceinline__ int row(int s) const {
    return contig ? base + s : base + (s / br) * d + s % br;
  }
  // The slot holding row j (j >= base), or -1 when no window holds it.
  __device__ __forceinline__ int slot_of(int j, int P) const {
    const int off = j - base;
    if (contig) return off;
    const int q = off / d, rem = off - q * d;
    return (q < P && rem < br) ? q * br + rem : -1;
  }
};

// Coordinates of tile `tile`: row tile rt (item-major), channel tile ct;
// this thread's lane in its row group rg (RG groups per CTA), first channel c0.
struct TilePos {
  int ct, rt, item, k0, lane, rg, RG, c0;
  __device__ TilePos(const DwTile& t, int kpad, int nct, int vec, int tile) {
    ct = tile % nct;
    rt = tile / nct;
    const int per_item = kpad / t.br;
    item = rt / per_item;
    k0 = (rt % per_item) * t.br;
    lane = threadIdx.x % t.lanes;
    rg = threadIdx.x / t.lanes;
    RG = blockDim.x / t.lanes;
    c0 = ct * t.lanes * vec + lane * vec;
  }
};

// Sum of (a, b) over the `lanes` threads of a row (consecutive lanes of one
// warp), xor-shuffle tree: fixed order. Every lane of the warp calls it.
__device__ __forceinline__ float2 row_sum2(float a, float b, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  return make_float2(a, b);
}

// Thread 0: every box of the window, stage by stage, from `map` (and from
// `map2` into `dst2` on the same barriers, KB2's dz beside c).
__device__ __forceinline__ void load_window(uint64_t* bars, const DwTile& t, const Window& w,
                                            const CUtensorMap* map, uint4* dst,
                                            const CUtensorMap* map2, uint4* dst2, int col,
                                            int row0) {
  const int nbox = (t.staged + DW_BOX - 1) / DW_BOX;
  const uint32_t box_bytes = DW_BOX * t.lanes * 16;
  for (int st = 0; st < t.stages; ++st) {
    const int b0 = st * t.chunk, b1 = min(nbox, b0 + t.chunk);
    const uint32_t bar = hop::smem_u32(&bars[st]);
    hop::mbar_expect_tx(bar, (b1 - b0) * box_bytes * (map2 ? 2 : 1));
    for (int b = b0; b < b1; ++b) {
      // a box never straddles two disjoint windows: DW_BOX divides br
      const size_t off = (size_t)b * DW_BOX * t.lanes;
      const int row = row0 + w.row(b * DW_BOX);
      hop::tma_load(hop::smem_u32(dst + off), map, bar, col, row);
      if (map2) hop::tma_load(hop::smem_u32(dst2 + off), map2, bar, col, row);
    }
  }
}

// ---------------------------------------------------------------------------
// K2: e = round(PReLU2(c)), c = sum_p w[p] * b[k - left + p*d] (f32), b
// staged; save mode also stores round(c). Rows >= K of e and c are the conv
// of the masked b (not zeroed), as the reference; the statistics of e cover
// rows < K: gLN one pair per tile, cLN one pair per row and channel tile.
// Persistent grid (dw_launch), DW_THREADS threads.
// ---------------------------------------------------------------------------
struct DwArgs {
  const float* stats1;    // K1 partials: n1 pairs per item (gLN) / per row (cLN)
  int n1;
  const float* alpha1;
  const float* g1;        // [H]
  const float* b1;        // [H]
  const float* w;         // [P, H] f32
  const float* alpha2;
  void* e;                // [M, kpad, H]
  void* c;                // save mode: conv output before PReLU2, rounded; else null
  float* stats2;          // gLN [M, kpad / br * H / bc] pairs; cLN [M * kpad, H / bc] pairs
  int M, kpad, k_valid, H, P, dilation, left, gln;
  DwTile t;
};

template <typename T>
__global__ void __launch_bounds__(DW_THREADS, 2)
    dwconv_sm90_kernel(const __grid_constant__ DwMaps maps, const DwArgs g) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int RB = 4;  // output rows per thread in flight
  extern __shared__ __align__(128) unsigned char dsm[];
  __shared__ float2 red[DW_THREADS / 32];
  uint64_t* bars = reinterpret_cast<uint64_t*>(dsm);  // [DW_MAX_STAGES]
  uint4* win = reinterpret_cast<uint4*>(dsm + DW_HEAD);  // [staged][lanes]
  const DwTile& t = g.t;
  const int nct = g.H / (t.lanes * VEC);
  const int ntiles = g.M * (g.kpad / t.br) * nct;
  const int stride = g.dilation <= t.br ? g.dilation : t.br;
  const float a1 = *g.alpha1, a2 = *g.alpha2;
  T* e = static_cast<T*>(g.e);
  T* cout = static_cast<T*>(g.c);
  const TileRange tr(ntiles);
  // Thread 0: the window of the CTA's i-th tile.
  auto issue = [&](int i) {
    const int tile = tr.first + i;
    if (tile >= tr.last) return;
    const TilePos tp(t, g.kpad, nct, VEC, tile);
    const Window wb{tp.k0 - g.left, t.br, g.dilation, g.dilation <= t.br};
    load_window(bars, t, wb, &maps.a, win, nullptr, nullptr, tp.ct * t.lanes * VEC,
                tp.item * g.kpad);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < DW_MAX_STAGES; ++i) hop::mbar_init(hop::smem_u32(&bars[i]), 1);
    hop::fence_barrier_init();
    issue(0);
  }
  __syncthreads();
  int item_m = -1;  // the item whose gLN moments mg holds
  float2 mg = make_float2(0.f, 0.f);
  for (int i = 0; tr.first + i < tr.last; ++i) {
    const int tile = tr.first + i;
    const TilePos tp(t, g.kpad, nct, VEC, tile);
    const size_t ibase = (size_t)tp.item * g.kpad;
    const Window wb{tp.k0 - g.left, t.br, g.dilation, g.dilation <= t.br};
    const uint32_t parity = i & 1;

    if (g.gln && tp.item != item_m) {  // uniform across the CTA
      const float2 s = reduce_partials(g.stats1 + 2 * (size_t)tp.item * g.n1, g.n1, red);
      mg = moments(s.x, s.y, (float)g.k_valid * (float)g.H);
      item_m = tp.item;
    }
    float gv[VEC], bv[VEC];
    load_f<VEC>(g.g1 + tp.c0, gv);
    load_f<VEC>(g.b1 + tp.c0, bv);

    // b = round(g1 * norm1(PReLU1(y1)) + b1) in place, stage by stage; rows
    // outside [0, K) zero by mask.
    for (int st = 0; st < t.stages; ++st) {
      hop::mbar_wait(hop::smem_u32(&bars[st]), parity);
      const int s_end = min(t.staged, (st + 1) * t.chunk * DW_BOX);
      for (int s = st * t.chunk * DW_BOX + tp.rg; s < s_end; s += tp.RG) {
        const int src = wb.row(s);
        uint4* p = win + (size_t)s * t.lanes + tp.lane;
        float f[VEC];
        if (src >= 0 && src < g.k_valid) {
          float2 mm = mg;
          if (!g.gln) {
            const float2 q = sum_pairs(g.stats1 + 2 * (ibase + src) * g.n1, g.n1);
            mm = moments(q.x, q.y, (float)g.H);
          }
          unpack<T>(*p, f);
#pragma unroll
          for (int j = 0; j < VEC; ++j) f[j] = gv[j] * ((prelu(f[j], a1) - mm.x) * mm.y) + bv[j];
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) f[j] = 0.f;
        }
        *p = pack<T>(f);
      }
    }
    __syncthreads();

    float ts = 0.f, tss = 0.f;
    for (int r0 = tp.rg; r0 < t.br; r0 += RB * tp.RG) {
      float acc[RB][VEC];
#pragma unroll
      for (int q = 0; q < RB; ++q)
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[q][j] = 0.f;
      for (int p = 0; p < g.P; ++p) {
        float wv[VEC];
        load_f<VEC>(g.w + (size_t)p * g.H + tp.c0, wv);
#pragma unroll
        for (int q = 0; q < RB; ++q) {
          const int r = r0 + q * tp.RG;
          if (r < t.br) {
            float f[VEC];
            unpack<T>(win[(size_t)(r + p * stride) * t.lanes + tp.lane], f);
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[q][j] = fmaf(f[j], wv[j], acc[q][j]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        const int r = r0 + q * tp.RG;
        if (r >= t.br) continue;  // uniform across a warp (see dw_plan)
        const int k = tp.k0 + r;
        const size_t idx = (ibase + k) * g.H + tp.c0;
        float ev[VEC];
        float rs = 0.f, rss = 0.f;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          ev[j] = prelu(acc[q][j], a2);
          rs += ev[j];
          rss += ev[j] * ev[j];
        }
        *reinterpret_cast<uint4*>(e + idx) = pack<T>(ev);
        if (cout) *reinterpret_cast<uint4*>(cout + idx) = pack<T>(acc[q]);
        if (k >= g.k_valid) rs = rss = 0.f;
        if (g.gln) {
          ts += rs;
          tss += rss;
        } else {
          const float2 s = row_sum2(rs, rss, t.lanes);
          if (tp.lane == 0) {
            float* o = g.stats2 + 2 * ((ibase + k) * nct + tp.ct);
            o[0] = s.x;
            o[1] = s.y;
          }
        }
      }
    }
    if (g.gln) {
      const float2 s = block_sum2(ts, tss, red);
      if (threadIdx.x == 0) {
        g.stats2[2 * (size_t)tile] = s.x;
        g.stats2[2 * (size_t)tile + 1] = s.y;
      }
    }
    // The buffer is free: the next window (TMA, the async proxy) may land.
    hop::fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0) issue(i + 1);
  }
}

// Raises kernel K's dynamic shared-memory limit to `smem` when a launch
// needs more than the last one set, and returns the persistent grid: the
// CTAs that fit the card at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// at most `tiles`.
template <auto K> static cudaError_t dw_launch(int smem, int tiles, int* grid) {
  static int set = 48 * 1024;
  static std::map<int, int> per_sm;
  if (smem > set) {
    const cudaError_t e =
        cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    set = smem;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  auto it = per_sm.find(smem);
  if (it == per_sm.end()) {
    int n = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, K, DW_THREADS, smem);
    if (e != cudaSuccess) return e;
    it = per_sm.emplace(smem, n > 0 ? n : 1).first;
  }
  *grid = max(1, min(tiles, sms * it->second));
  return cudaSuccess;
}

template <typename T>
static cudaError_t dwconv_sm90(const DwMaps& m, const DwArgs& g, int smem, cudaStream_t s) {
  const int tiles = g.M * (g.kpad / g.t.br) * (g.H / (g.t.lanes * (16 / (int)sizeof(T))));
  int grid = 0;
  const cudaError_t e = dw_launch<dwconv_sm90_kernel<T>>(smem, tiles, &grid);
  if (e != cudaSuccess) return e;
  dwconv_sm90_kernel<T><<<grid, DW_THREADS, smem, s>>>(m, g);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// KB2: de = round(inv2 * (dz*g2 - mean(dz*g2) - ehat*mean(dz*g2*ehat))),
// dc = round(de * PReLU2'(c)) (rows outside [0, K) zero) staged once per row
// of the window k + left - p*d; then for each own row k < K:
//   db[k]  = round(sum_p w[p] * dc[k + left - p*d])   (rows >= K: 0)
//   b[k]   = round(g1 * ahat[k] + b1), ahat from y1[k] (own rows, staged)
//   dw[p] += b[k] * dc[k + left - p*d]
// which is dw[p] = sum_k dc[k] * b[k - left + p*d] summed over the b index:
// the same taps feed db and dw, so no b window is needed. dg1, db1 and dw
// stay in registers across the tile's rows and are summed over the row
// groups in a fixed order into chpart [M*kpad/br, P+2, H]; d_alpha2 =
// sum de * min(c, 0) over the own rows (from the window, or from one more
// load of c and dz where no window holds the row: P even, non-causal,
// dilation > br); the norm1 backward sums of db*g1 and db*g1*ahat per row
// and channel tile (cLN) or per tile (gLN).
// Persistent grid (dw_launch), DW_THREADS threads; NP = P taps.
// ---------------------------------------------------------------------------
struct DwbArgs {
  const void* c;         // [rows, H]
  const void* dz;        // [rows, H]
  const float* stats1;   // K1 partials of a: n1 pairs per item / row
  int n1;
  const float* stats2;   // K2 partials of e
  int n2;
  const float* gs2;      // KB1 partials of (sum dz*g2, sum dz*g2*ehat)
  int ng2;
  const float* alpha1;
  const float* g1;
  const float* b1;
  const float* w;        // [P, H]
  const float* alpha2;
  const float* g2;
  void* db;              // [rows, H]
  float* chpart;         // [rows / br, P + 2, H]: dw[0..P), dg1, db1
  float* gs1;            // gLN [M, kpad / br * H / bc] pairs; cLN [rows, H / bc] pairs
  float* da2part;        // [tiles]
  int M, kpad, k_valid, H, P, dilation, left, gln;
  DwTile t;
};

template <typename T, int NP>
__global__ void __launch_bounds__(DW_THREADS, NP <= 4 ? 2 : 1)
    bwd_dwconv_sm90_kernel(const __grid_constant__ DwMaps maps, const DwbArgs g) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NB = DW_MAX_STAGES + 1;  // barriers: stages, own y1 rows
  extern __shared__ __align__(128) unsigned char dsm[];
  __shared__ float2 red[DW_THREADS / 32];
  __shared__ float4 red4[DW_THREADS / 32];
  uint64_t* bars = reinterpret_cast<uint64_t*>(dsm);  // [NB]
  const DwTile& t = g.t;
  const int nct = g.H / (t.lanes * VEC);
  const int ntiles = g.M * (g.kpad / t.br) * nct;
  const int span = (NP - 1) * g.dilation;
  const int stride = g.dilation <= t.br ? g.dilation : t.br;
  const int nslot = (t.staged + DW_BOX - 1) / DW_BOX * DW_BOX;  // whole boxes
  const float n_g = (float)g.k_valid * (float)g.H;
  const float a1 = *g.alpha1, a2 = *g.alpha2;
  const T* cin = static_cast<const T*>(g.c);
  const T* dzin = static_cast<const T*>(g.dz);
  T* dbout = static_cast<T*>(g.db);
  // window buffer: [nslot][lanes] c then dc, [nslot][lanes] dz, [br][lanes]
  // own rows of y1
  uint4* cw = reinterpret_cast<uint4*>(dsm + DW_HEAD);
  uint4* zw = cw + (size_t)nslot * t.lanes;
  uint4* yw = zw + (size_t)nslot * t.lanes;
  const TileRange tr(ntiles);
  auto issue = [&](int i) {
    const int tile = tr.first + i;
    if (tile >= tr.last) return;
    const TilePos tp(t, g.kpad, nct, VEC, tile);
    const Window wd{tp.k0 + g.left - span, t.br, g.dilation, g.dilation <= t.br};
    const int col = tp.ct * t.lanes * VEC, row0 = tp.item * g.kpad;
    const uint32_t bar = hop::smem_u32(&bars[DW_MAX_STAGES]);
    hop::mbar_expect_tx(bar, t.br * t.lanes * 16);
    for (int r = 0; r < t.br; r += DW_BOX)
      hop::tma_load(hop::smem_u32(yw + (size_t)r * t.lanes), &maps.c, bar, col, row0 + tp.k0 + r);
    load_window(bars, t, wd, &maps.a, cw, &maps.b, zw, col, row0);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < NB; ++i) hop::mbar_init(hop::smem_u32(&bars[i]), 1);
    hop::fence_barrier_init();
    issue(0);
  }
  __syncthreads();
  int item_m = -1;  // the item whose gLN moments m1g, m2g hold
  float4 m2g = make_float4(0.f, 0.f, 0.f, 0.f);  // (mean2, inv2, mean(dz*g2), mean(dz*g2*ehat))
  float2 m1g = make_float2(0.f, 0.f);
  for (int i = 0; tr.first + i < tr.last; ++i) {
    const int tile = tr.first + i;
    const TilePos tp(t, g.kpad, nct, VEC, tile);
    const size_t ibase = (size_t)tp.item * g.kpad;
    const Window wd{tp.k0 + g.left - span, t.br, g.dilation, g.dilation <= t.br};
    const uint32_t parity = i & 1;

    if (g.gln && tp.item != item_m) {  // uniform across the CTA
      item_m = tp.item;
      const float2 s1 = reduce_partials(g.stats1 + 2 * (size_t)tp.item * g.n1, g.n1, red);
      const float2 s2 = reduce_partials(g.stats2 + 2 * (size_t)tp.item * g.n2, g.n2, red);
      const float2 sg = reduce_partials(g.gs2 + 2 * (size_t)tp.item * g.ng2, g.ng2, red);
      m1g = moments(s1.x, s1.y, n_g);
      const float2 m2 = moments(s2.x, s2.y, n_g);
      m2g = make_float4(m2.x, m2.y, sg.x / n_g, sg.y / n_g);
    }
    // dc of row src (in [0, K)) from its c and dz vectors; d_alpha2 terms of
    // an own row added to da2.
    auto dc_row = [&](int src, uint4 cu, uint4 zu, const float* g2v, float* dcv, float& da2,
                      bool own) {
      float4 m = m2g;
      if (!g.gln) {
        const float2 s2 = sum_pairs(g.stats2 + 2 * (ibase + src) * g.n2, g.n2);
        const float2 sg = sum_pairs(g.gs2 + 2 * (ibase + src) * g.ng2, g.ng2);
        const float2 m2 = moments(s2.x, s2.y, (float)g.H);
        m = make_float4(m2.x, m2.y, sg.x / (float)g.H, sg.y / (float)g.H);
      }
      float cf[VEC], dzf[VEC];
      unpack<T>(cu, cf);
      unpack<T>(zu, dzf);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float ehat = (prelu(cf[j], a2) - m.x) * m.y;
        const float de = round_dt<T>(m.y * (dzf[j] * g2v[j] - m.z - ehat * m.w));
        dcv[j] = de * dprelu(cf[j], a2);
        if (own) da2 += de * fminf(cf[j], 0.f);
      }
    };

    float da2 = 0.f;
    {
      float g2v[VEC];
      load_f<VEC>(g.g2 + tp.c0, g2v);
      for (int st = 0; st < t.stages; ++st) {
        hop::mbar_wait(hop::smem_u32(&bars[st]), parity);
        const int s_end = min(t.staged, (st + 1) * t.chunk * DW_BOX);
        for (int s = st * t.chunk * DW_BOX + tp.rg; s < s_end; s += tp.RG) {
          const int src = wd.row(s);
          uint4* p = cw + (size_t)s * t.lanes + tp.lane;
          float f[VEC];
          if (src >= 0 && src < g.k_valid) {
            const bool own = src >= tp.k0 && src < tp.k0 + t.br;
            dc_row(src, *p, zw[(size_t)s * t.lanes + tp.lane], g2v, f, da2, own);
          } else {
#pragma unroll
            for (int j = 0; j < VEC; ++j) f[j] = 0.f;
          }
          *p = pack<T>(f);
        }
      }
      // Own rows < K that no window holds: d_alpha2 from their c and dz.
      if (!wd.contig) {
        for (int r = tp.rg; r < t.br && tp.k0 + r < g.k_valid; r += tp.RG) {
          const int k = tp.k0 + r;
          if (wd.slot_of(k, NP) >= 0) continue;
          const size_t idx = (ibase + k) * g.H + tp.c0;
          float f[VEC];
          dc_row(k, *reinterpret_cast<const uint4*>(cin + idx),
                 *reinterpret_cast<const uint4*>(dzin + idx), g2v, f, da2, true);
        }
      }
    }
    hop::mbar_wait(hop::smem_u32(&bars[DW_MAX_STAGES]), parity);
    __syncthreads();

    float gv[VEC], bv[VEC];
    load_f<VEC>(g.g1 + tp.c0, gv);
    load_f<VEC>(g.b1 + tp.c0, bv);
    float dw[NP][VEC], dg1[VEC], db1[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      dg1[j] = db1[j] = 0.f;
#pragma unroll
      for (int p = 0; p < NP; ++p) dw[p][j] = 0.f;
    }
    float ts = 0.f, tss = 0.f;
    for (int r = tp.rg; r < t.br; r += tp.RG) {
      const int k = tp.k0 + r;
      const bool valid = k < g.k_valid;
      float ahat[VEC], bb[VEC], acc[VEC];
      if (valid) {
        float2 m1 = m1g;
        if (!g.gln) {
          const float2 q = sum_pairs(g.stats1 + 2 * (ibase + k) * g.n1, g.n1);
          m1 = moments(q.x, q.y, (float)g.H);
        }
        unpack<T>(yw[(size_t)r * t.lanes + tp.lane], ahat);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          ahat[j] = (prelu(ahat[j], a1) - m1.x) * m1.y;
          bb[j] = round_dt<T>(gv[j] * ahat[j] + bv[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        float wv[VEC], dcv[VEC];
        load_f<VEC>(g.w + (size_t)p * g.H + tp.c0, wv);
        unpack<T>(cw[(size_t)(r + (NP - 1 - p) * stride) * t.lanes + tp.lane], dcv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          acc[j] = fmaf(wv[j], dcv[j], acc[j]);
          if (valid) dw[p][j] = fmaf(bb[j], dcv[j], dw[p][j]);
        }
      }
      float dbv[VEC];
      float rs = 0.f, rss = 0.f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        dbv[j] = valid ? round_dt<T>(acc[j]) : 0.f;
        if (valid) {
          dg1[j] += dbv[j] * ahat[j];
          db1[j] += dbv[j];
          const float dbg = dbv[j] * gv[j];
          rs += dbg;
          rss += dbg * ahat[j];
        }
      }
      *reinterpret_cast<uint4*>(dbout + (ibase + k) * g.H + tp.c0) = pack<T>(dbv);
      if (g.gln) {
        ts += rs;
        tss += rss;
      } else {
        const float2 s = row_sum2(rs, rss, t.lanes);
        if (tp.lane == 0) {
          float* o = g.gs1 + 2 * ((ibase + k) * nct + tp.ct);
          o[0] = s.x;
          o[1] = s.y;
        }
      }
    }

    // Tile partials: d_alpha2 and the gLN sums over the CTA; the channel
    // partials over the row groups in index order, through this buffer
    // (block_sum3 syncs first: every read of the window is done).
    const float3 q = block_sum3(da2, ts, tss, red4);
    if (threadIdx.x == 0) {
      g.da2part[tile] = q.x;
      if (g.gln) {
        g.gs1[2 * (size_t)tile] = q.y;
        g.gs1[2 * (size_t)tile + 1] = q.z;
      }
    }
    const int bc = t.lanes * VEC;
    float* rbuf = reinterpret_cast<float*>(cw);  // [groups][NP + 2][bc]
    if (tp.rg < t.br) {
      float* o = rbuf + (size_t)tp.rg * (NP + 2) * bc + tp.lane * VEC;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
#pragma unroll
        for (int p = 0; p < NP; ++p) o[p * bc + j] = dw[p][j];
        o[NP * bc + j] = dg1[j];
        o[(NP + 1) * bc + j] = db1[j];
      }
    }
    __syncthreads();
    const int groups = min(tp.RG, t.br);
    for (int x = threadIdx.x; x < (NP + 2) * bc; x += blockDim.x) {
      float s = 0.f;
      for (int r = 0; r < groups; ++r) s += rbuf[(size_t)r * (NP + 2) * bc + x];
      const int qd = x / bc, ch = x % bc;
      g.chpart[((size_t)tp.rt * (NP + 2) + qd) * g.H + tp.ct * bc + ch] = s;
    }
    // The buffer is free: the next window (TMA, the async proxy) may land.
    hop::fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0) issue(i + 1);
  }
}

template <typename T, int NP>
static cudaError_t bwd_dwconv_sm90_np(const DwMaps& m, const DwbArgs& g, int tiles, int smem,
                                      cudaStream_t s) {
  int grid = 0;
  const cudaError_t e = dw_launch<bwd_dwconv_sm90_kernel<T, NP>>(smem, tiles, &grid);
  if (e != cudaSuccess) return e;
  bwd_dwconv_sm90_kernel<T, NP><<<grid, DW_THREADS, smem, s>>>(m, g);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t bwd_dwconv_sm90(const DwMaps& m, const DwbArgs& g, int smem, cudaStream_t s) {
  const int tiles = g.M * (g.kpad / g.t.br) * (g.H / (g.t.lanes * (16 / (int)sizeof(T))));
  switch (g.P) {
    case 1: return bwd_dwconv_sm90_np<T, 1>(m, g, tiles, smem, s);
    case 2: return bwd_dwconv_sm90_np<T, 2>(m, g, tiles, smem, s);
    case 3: return bwd_dwconv_sm90_np<T, 3>(m, g, tiles, smem, s);
    case 4: return bwd_dwconv_sm90_np<T, 4>(m, g, tiles, smem, s);
    case 5: return bwd_dwconv_sm90_np<T, 5>(m, g, tiles, smem, s);
    case 6: return bwd_dwconv_sm90_np<T, 6>(m, g, tiles, smem, s);
    case 7: return bwd_dwconv_sm90_np<T, 7>(m, g, tiles, smem, s);
    case 8: return bwd_dwconv_sm90_np<T, 8>(m, g, tiles, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tcn
