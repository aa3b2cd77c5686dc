// The depthwise kernels of a temporal block on Hopper (sm_90a): K2
// tcn_dwconv (forward, inference and save modes; tcn_block.cu), a staged
// stencil over tiles of `br` rows x `bc` channels of one batch item, and KB2
// tcn_bwd_dwconv (its backward; tcn_block_bwd.cu), a streaming stencil down
// strips of rows (see KB2 below).
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
// per byte. What K2's design does about it:
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
//     which is exactly where the reference rounds: b = round(g1 *
//     norm1(PReLU1(y1)) + b1). The P taps of an output row then read the
//     staged row P times from shared memory, not device memory;
//   - per-channel parameters live in registers or come through L1;
//     statistics fold per thread, then in a fixed order (lanes by
//     xor-shuffle, then warps or row groups in index order), one partial per
//     tile, and no float atomic is used: two runs give the same bytes,
//     whatever the grid.
// K2's tile plan (br, lanes, staged rows, chunk, stages, shared memory)
// comes from tcn_block.dw_plan on the host, KB2's strip plan from
// tcn_block.kb2_plan.
#pragma once

#include <cstdint>
#include <map>

#include "hopper_gemm.cuh"
#include "tcn_block.cuh"

namespace tcn {

constexpr int DW_HEAD = 128;       // bytes of mbarriers ahead of the window buffer
constexpr int DW_MAX_STAGES = 8;   // K2's barriers
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

// Tensor maps over [M * kpad, H] with a box of DW_BOX rows x bc channels (K2:
// y1, a) or of chunk rows x bc channels (KB2: c, a; dz, b; y1, c).
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

// n consecutive floats from shared memory (n a multiple of 4, 16-byte aligned).
template <int N> __device__ __forceinline__ void load_fs(const float* p, float* f) {
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + j);
    f[j] = v.x;
    f[j + 1] = v.y;
    f[j + 2] = v.z;
    f[j + 3] = v.w;
  }
}

// n consecutive floats stored (n a multiple of 4, 16-byte aligned).
template <int N> __device__ __forceinline__ void store_f(float* p, const float* f) {
#pragma unroll
  for (int j = 0; j < N; j += 4)
    *reinterpret_cast<float4*>(p + j) = make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
}

// Slot <-> row arithmetic of K2's staged window (mirrored in Python by
// tcn_block.dw_window and dw_stride, which the CPU tests hold against the
// plain version).
struct Window {
  int base, br, d;
  bool contig;
  __device__ __forceinline__ int row(int s) const {
    return contig ? base + s : base + (s / br) * d + s % br;
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
// `map2` into `dst2` on the same barriers where one is given; K2 gives none).
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
// dc = round(de * PReLU2'(c)) (rows outside [0, K) zero); then for each own
// row k:
//   db[k]  = round(sum_p w[p] * dc[k + left - p*d])   (rows >= K: 0)
//   b[k]   = round(g1 * ahat[k] + b1), ahat from y1[k]
//   dw[p] += b[k] * dc[k + left - p*d]
// which is dw[p] = sum_k dc[k] * b[k - left + p*d] summed over the b index:
// the same taps feed db and dw, so no b window is needed.
//
// A streaming stencil. A CTA owns one item x bc = KB2_VECS * VEC channels
// (rows of 128 bytes) x one strip of `strip` rows [k_begin, k_end) (StripPlan, from
// tcn_block.kb2_plan) and walks it in increasing k, `chunk` rows at a time.
// Its load stream is the rows j0 = k_begin + left - span onwards: `pre` =
// ceil(span / chunk) chunks ahead of the first own chunk, then one chunk of
// c and dz per own chunk. One producer warp keeps the loads in flight
// through a ring of `stages` stages, each one TMA box per stream (c, dz and
// the own chunk's y1), on full / empty mbarriers. Each of the four consumer
// warps owns a quarter of the channels of every row: it converts its part
// of each chunk of c and dz once into dc, in the working type, in a ring of
// `ring` = pre + 1 chunks (the span behind the own chunk and the own
// chunk), and reads the P taps of its own rows from it. A warp reads only
// what it wrote, so the ring needs no barrier across warps (__syncwarp
// orders it), and the warps drift apart as far as the stages allow. Only
// the pre chunks at a strip's start are loaded by two CTAs.
//
// dw, dg1, db1 stay in registers over the strip and are summed over a
// warp's row groups by xor-shuffles in a fixed order into chpart [M *
// bands, P + 2, H]; d_alpha2 = sum de * min(c, 0) over the own rows (taken
// where they are converted); the norm1 backward sums of db*g1 and
// db*g1*ahat per row and warp's share of a channel tile (cLN) or per strip
// (gLN). One partial per strip, no float atomic.
// Grid: M * bands * H / bc CTAs of KB2_THREADS threads, three resident per
// SM up to four taps (two above), so that each thread keeps 128 registers
// (168): nine warps a CTA at two CTAs an SM would leave 96 and spill.
// NP = P taps.
// ---------------------------------------------------------------------------
constexpr int KB2_CONSUMERS = 128;                  // four warps convert and compute,
constexpr int KB2_THREADS = KB2_CONSUMERS + 32;     // one producer warp issues the loads
constexpr int KB2_WARPS = KB2_CONSUMERS / 32;
// 16-byte vectors a row: rows of 128 bytes, two vectors a row for each
// consumer warp. Wider rows halve the CTAs, narrower ones meet bank
// conflicts (both measured slower on the H100).
constexpr int KB2_VECS = 8;
constexpr int KB2_MAX_STAGES = 8;                   // full and empty barriers fit DW_HEAD
constexpr int KB2_SYNC = 1;                         // the consumers' named barrier

// Strip plan, from tcn_block.kb2_plan.
struct StripPlan {
  int chunk;    // rows per stage and per TMA box
  int stages;   // stages of the load ring, <= KB2_MAX_STAGES
  int ring;     // chunks of the dc ring: ceil(span / chunk) + 1
  int strip;    // own rows per CTA, a multiple of chunk
  int bands;    // strips per item: ceil(kpad / strip)
};

struct DwbArgs {
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
  float* chpart;         // [M * bands, P + 2, H]: dw[0..P), dg1, db1
  float* gs1;            // gLN [M, bands * H / bc] pairs; cLN [rows, H / bc] pairs
  float* da2part;        // [M * bands * H / bc]
  int M, kpad, k_valid, H, P, dilation, left, gln;
  StripPlan t;
};

// Sums of (a, b, c) over the consumer threads in a fixed order (xor-shuffle
// tree inside each warp, then warps in index order) on the consumers' named
// barrier; every consumer gets the totals.
__device__ __forceinline__ float3 consumer_sum3(float a, float b, float c, float4* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
    c += __shfl_xor_sync(0xffffffffu, c, off);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = make_float4(a, b, c, 0.f);
  hop::named_sync(KB2_SYNC, KB2_CONSUMERS);
  float3 t = make_float3(0.f, 0.f, 0.f);
  for (int i = 0; i < KB2_WARPS; ++i) {
    t.x += red[i].x;
    t.y += red[i].y;
    t.z += red[i].z;
  }
  hop::named_sync(KB2_SYNC, KB2_CONSUMERS);
  return t;
}

template <typename T, int NP>
__global__ void __launch_bounds__(KB2_THREADS, NP <= 4 ? 3 : 2)
    bwd_dwconv_sm90_kernel(const __grid_constant__ DwMaps maps, const DwbArgs g) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char dsm[];
  __shared__ float4 red[KB2_WARPS];
  const StripPlan& t = g.t;
  uint64_t* full = reinterpret_cast<uint64_t*>(dsm);  // [stages]
  uint64_t* empty = full + KB2_MAX_STAGES;            // [stages]
  constexpr int lanes = KB2_VECS, bc = lanes * VEC;
  const int ch = t.chunk;
  const int nct = g.H / bc;
  const int ct = blockIdx.x % nct;
  const int band = blockIdx.x / nct % t.bands;
  const int item = blockIdx.x / (nct * t.bands);
  const int k_begin = band * t.strip, k_end = min(g.kpad, k_begin + t.strip);
  const int span = (NP - 1) * g.dilation;
  const int pre = t.ring - 1;                 // load chunks ahead of the first own chunk
  const int nq = (k_end - k_begin) / ch + pre;  // load chunks of the strip
  const int j0 = k_begin + g.left - span;     // the load stream's first row
  const int R = t.ring * ch;                  // rows of the dc ring
  const int col = ct * bc;
  const int box = ch * lanes;                 // 16-byte vectors of one box
  // [stages][c, dz, y1][chunk][lanes], the dc ring [R][lanes], the taps
  uint4* stage0 = reinterpret_cast<uint4*>(dsm + DW_HEAD);
  uint4* ring = stage0 + t.stages * 3 * box;
  float* wsm = reinterpret_cast<float*>(ring + t.ring * ch * lanes);  // [NP][bc] taps

  if (threadIdx.x == 0) {
    for (int s = 0; s < t.stages; ++s) {
      hop::mbar_init(hop::smem_u32(&full[s]), 1);
      hop::mbar_init(hop::smem_u32(&empty[s]), KB2_WARPS);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= KB2_CONSUMERS) {  // the producer warp: one thread issues
    if (threadIdx.x == KB2_CONSUMERS) {
      const int row0 = item * g.kpad;
      const uint32_t box_bytes = (uint32_t)box * 16;
      for (int q = 0; q < nq; ++q) {
        const int s = q % t.stages, use = q / t.stages;
        if (use > 0) hop::mbar_wait(hop::smem_u32(&empty[s]), (use - 1) & 1);
        const bool own = q >= pre;
        const uint32_t bar = hop::smem_u32(&full[s]);
        uint4* dst = stage0 + s * 3 * box;
        hop::mbar_expect_tx(bar, box_bytes * (own ? 3 : 2));
        hop::tma_load(hop::smem_u32(dst), &maps.a, bar, col, row0 + j0 + q * ch);
        hop::tma_load(hop::smem_u32(dst + box), &maps.b, bar, col, row0 + j0 + q * ch);
        if (own)
          hop::tma_load(hop::smem_u32(dst + 2 * box), &maps.c, bar, col,
                        row0 + k_begin + (q - pre) * ch);
      }
    }
    return;
  }

  // Each warp owns the vectors [warp * L, warp * L + L) of every row: lane
  // `sub` of a row group `rg`; a chunk's rows rg, rg + RG, ...
  constexpr int L = lanes / KB2_WARPS, RG = 32 / L;
  const int warp = threadIdx.x >> 5;
  const int sub = (threadIdx.x & 31) % L, rg = (threadIdx.x & 31) / L;
  const int v = warp * L + sub;                // this thread's vector of a row
  const int c0 = col + v * VEC;
  // The ring's rows are swizzled: vector v of ring row r lies at v ^ ((r &
  // 3) * L), so that the 4 consecutive rows of a quarter-warp's access fall
  // on distinct banks (5 % faster than plain rows on the H100).
  auto ring_at = [&](int r) { return r * lanes + (v ^ ((r & 3) * L)); };
  const size_t ibase = (size_t)item * g.kpad;
  const float a1 = *g.alpha1, a2 = *g.alpha2;
  // The tile's taps into shared memory once: read there with 32-bit
  // addresses, P times a row, they cost fewer instructions than from L1.
  for (int i = threadIdx.x; i < NP * bc; i += KB2_CONSUMERS)
    wsm[i] = g.w[(size_t)(i / bc) * g.H + col + i % bc];
  hop::named_sync(KB2_SYNC, KB2_CONSUMERS);
  // gLN moments of the item (the first loads land meanwhile)
  float2 m1g = make_float2(0.f, 0.f);
  float4 m2g = make_float4(0.f, 0.f, 0.f, 0.f);  // (mean2, inv2, mean(dz*g2), mean(dz*g2*ehat))
  if (g.gln) {
    const float* p1 = g.stats1 + 2 * (size_t)item * g.n1;
    const float* p2 = g.stats2 + 2 * (size_t)item * g.n2;
    const float* pg = g.gs2 + 2 * (size_t)item * g.ng2;
    float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = threadIdx.x; i < g.n1; i += KB2_CONSUMERS) {
      s[0] += p1[2 * i];
      s[1] += p1[2 * i + 1];
    }
    for (int i = threadIdx.x; i < g.n2; i += KB2_CONSUMERS) {
      s[2] += p2[2 * i];
      s[3] += p2[2 * i + 1];
    }
    for (int i = threadIdx.x; i < g.ng2; i += KB2_CONSUMERS) {
      s[4] += pg[2 * i];
      s[5] += pg[2 * i + 1];
    }
    const float3 u = consumer_sum3(s[0], s[1], s[2], red);
    const float3 u2 = consumer_sum3(s[3], s[4], s[5], red);
    const float n_g = (float)g.k_valid * (float)g.H;
    m1g = moments(u.x, u.y, n_g);
    const float2 m2 = moments(u.z, u2.x, n_g);
    m2g = make_float4(m2.x, m2.y, u2.y / n_g, u2.z / n_g);
  }

  float dw[NP][VEC], dg1[VEC], db1[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    dg1[e] = db1[e] = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) dw[p][e] = 0.f;
  }
  float da2 = 0.f, ts = 0.f, tss = 0.f;
  T* dbout = static_cast<T*>(g.db);
  int conv_slot = 0;    // ring row of load chunk q's first row
  int own_slot = span;  // ring row of tap 0 of own chunk i's first row
  for (int q = 0; q < nq; ++q) {
    const int s = q % t.stages;
    hop::mbar_wait(hop::smem_u32(&full[s]), (q / t.stages) & 1);
    const uint4* cs = stage0 + s * 3 * box;

    // this warp's part of the dc of load chunk q into the ring; d_alpha2 of
    // the own rows < K
    {
      float g2v[VEC];
      load_f<VEC>(g.g2 + c0, g2v);
      for (int x = rg; x < ch; x += RG) {
        const int j = j0 + q * ch + x;
        float f[VEC];
        if (j >= 0 && j < g.k_valid) {
          float4 m = m2g;
          if (!g.gln) {
            const float2 s2 = sum_pairs(g.stats2 + 2 * (ibase + j) * g.n2, g.n2);
            const float2 sg = sum_pairs(g.gs2 + 2 * (ibase + j) * g.ng2, g.ng2);
            const float2 m2 = moments(s2.x, s2.y, (float)g.H);
            m = make_float4(m2.x, m2.y, sg.x / (float)g.H, sg.y / (float)g.H);
          }
          float cf[VEC], dzf[VEC];
          unpack<T>(cs[x * lanes + v], cf);
          unpack<T>(cs[box + x * lanes + v], dzf);
          const bool own = j >= k_begin && j < k_end;
          // de = inv2 * (dz*g2 - mean(dz*g2) - ehat * mean(dz*g2*ehat)), ehat =
          // (PReLU2(c) - mean2) * inv2, in the plain version's order and
          // roundings (no fused multiply-add): de is rounded to the working
          // type next, and d_alpha2 sums it against min(c, 0) with much
          // cancellation, so a different f32 order flips more of its ulps.
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float ehat = __fmul_rn(__fsub_rn(prelu(cf[e], a2), m.x), m.y);
            f[e] = __fmul_rn(m.y, __fsub_rn(__fsub_rn(__fmul_rn(dzf[e], g2v[e]), m.z),
                                            __fmul_rn(ehat, m.w)));
          }
          unpack<T>(pack<T>(f), f);  // de = round(...)
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            if (own) da2 += f[e] * fminf(cf[e], 0.f);
            f[e] *= dprelu(cf[e], a2);
          }
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) f[e] = 0.f;
        }
        const int r = conv_slot + x;
        ring[ring_at(r)] = pack<T>(f);
      }
      conv_slot += ch;
      if (conv_slot == R) conv_slot = 0;
    }
    __syncwarp();  // this warp's ring rows through chunk q are written

    if (q >= pre) {  // own chunk q - pre: its taps reach load chunks q - pre .. q
      const int k0 = k_begin + (q - pre) * ch;
      const uint4* ys = cs + 2 * box;
      float gv[VEC], bv[VEC];
      load_f<VEC>(g.g1 + c0, gv);
      load_f<VEC>(g.b1 + c0, bv);
      for (int r = rg; r < ch; r += RG) {
        const int k = k0 + r;
        const bool valid = k < g.k_valid;
        float ahat[VEC], bb[VEC], acc[VEC];
        if (valid) {
          float2 m1 = m1g;
          if (!g.gln) {
            const float2 q1 = sum_pairs(g.stats1 + 2 * (ibase + k) * g.n1, g.n1);
            m1 = moments(q1.x, q1.y, (float)g.H);
          }
          unpack<T>(ys[r * lanes + v], ahat);
          const float nb = -m1.x * m1.y;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            ahat[e] = fmaf(prelu(ahat[e], a1), m1.y, nb);
            bb[e] = gv[e] * ahat[e] + bv[e];
          }
          unpack<T>(pack<T>(bb), bb);  // b = round(g1 * ahat + b1)
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
        int slot = own_slot + r;  // tap 0: row k + left
        if (slot >= R) slot -= R;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          int sp = slot - p * g.dilation;  // row k + left - p*d
          if (sp < 0) sp += R;
          float wv[VEC], dcv[VEC];
          load_fs<VEC>(wsm + p * bc + v * VEC, wv);
          unpack<T>(ring[ring_at(sp)], dcv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            acc[e] = fmaf(wv[e], dcv[e], acc[e]);
            if (valid) dw[p][e] = fmaf(bb[e], dcv[e], dw[p][e]);
          }
        }
        uint4 dbu = make_uint4(0u, 0u, 0u, 0u);  // rows >= K: zero
        float rs = 0.f, rss = 0.f;
        if (valid) {
          dbu = pack<T>(acc);  // db = round(acc), two at a time in bf16
          float dbv[VEC];
          unpack<T>(dbu, dbv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            dg1[e] += dbv[e] * ahat[e];
            db1[e] += dbv[e];
          }
          if (!g.gln) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              const float dbg = dbv[e] * gv[e];
              rs += dbg;
              rss += dbg * ahat[e];
            }
          }
        }
        *reinterpret_cast<uint4*>(dbout + (ibase + k) * g.H + c0) = dbu;
        if (!g.gln) {
          const float2 sm = row_sum2(rs, rss, L);
          if (sub == 0) {
            float* o = g.gs1 + 2 * (((ibase + k) * nct + ct) * KB2_WARPS + warp);
            o[0] = sm.x;
            o[1] = sm.y;
          }
        }
      }
      own_slot += ch;
      if (own_slot >= R) own_slot -= R;
    }
    // this warp is done with stage s: the producer may refill it
    __syncwarp();
    if ((threadIdx.x & 31) == 0) hop::mbar_arrive(hop::smem_u32(&empty[s]));
  }

  // Strip partials. Each warp's channel sums over its row groups by
  // xor-shuffles (the lanes of one vector differ in the bits above
  // log2(L)), in a fixed order; gLN's norm1 backward sums of the strip,
  // sum db*g1 = sum_c g1[c] * db1[c] and sum db*g1*ahat = sum_c g1[c] *
  // dg1[c], and d_alpha2 over the consumers.
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
#pragma unroll
      for (int p = 0; p < NP; ++p) dw[p][e] += __shfl_xor_sync(0xffffffffu, dw[p][e], off);
      dg1[e] += __shfl_xor_sync(0xffffffffu, dg1[e], off);
      db1[e] += __shfl_xor_sync(0xffffffffu, db1[e], off);
    }
  }
  if (g.gln && rg == 0) {
    float gv[VEC];
    load_f<VEC>(g.g1 + c0, gv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      ts = fmaf(gv[e], db1[e], ts);
      tss = fmaf(gv[e], dg1[e], tss);
    }
  }
  const float3 tot = consumer_sum3(da2, ts, tss, red);
  if (threadIdx.x == 0) {
    g.da2part[blockIdx.x] = tot.x;
    if (g.gln) {
      g.gs1[2 * (size_t)blockIdx.x] = tot.y;
      g.gs1[2 * (size_t)blockIdx.x + 1] = tot.z;
    }
  }
  if (rg == 0) {
    float* out = g.chpart + (size_t)(item * t.bands + band) * (NP + 2) * g.H + c0;
#pragma unroll
    for (int p = 0; p < NP; ++p) store_f<VEC>(out + (size_t)p * g.H, dw[p]);
    store_f<VEC>(out + (size_t)NP * g.H, dg1);
    store_f<VEC>(out + (size_t)(NP + 1) * g.H, db1);
  }
}

template <typename T, int NP>
static cudaError_t bwd_dwconv_sm90_np(const DwMaps& m, const DwbArgs& g, int grid, int smem,
                                      cudaStream_t s) {
  static int set = 48 * 1024;  // the dynamic shared memory this instantiation admits
  if (smem > set) {
    const cudaError_t e = cudaFuncSetAttribute(
        bwd_dwconv_sm90_kernel<T, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    set = smem;
  }
  bwd_dwconv_sm90_kernel<T, NP><<<grid, KB2_THREADS, smem, s>>>(m, g);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t bwd_dwconv_sm90(const DwMaps& m, const DwbArgs& g, int smem, cudaStream_t s) {
  const int grid = g.M * g.t.bands * (g.H / (KB2_VECS * (16 / (int)sizeof(T))));
  switch (g.P) {
    case 1: return bwd_dwconv_sm90_np<T, 1>(m, g, grid, smem, s);
    case 2: return bwd_dwconv_sm90_np<T, 2>(m, g, grid, smem, s);
    case 3: return bwd_dwconv_sm90_np<T, 3>(m, g, grid, smem, s);
    case 4: return bwd_dwconv_sm90_np<T, 4>(m, g, grid, smem, s);
    case 5: return bwd_dwconv_sm90_np<T, 5>(m, g, grid, smem, s);
    case 6: return bwd_dwconv_sm90_np<T, 6>(m, g, grid, smem, s);
    case 7: return bwd_dwconv_sm90_np<T, 7>(m, g, grid, smem, s);
    case 8: return bwd_dwconv_sm90_np<T, 8>(m, g, grid, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tcn
