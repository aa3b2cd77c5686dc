// The stream chunk step's TCN block (convtasnet_torch/models/streaming.py
// stream_step; wrapper and plain version ops/kernels/stream_block.py) as one
// launch. For each stream's Kc new frames x [Kc, B] (bf16):
//   y = bf16(x @ in_w), f32 accumulation;  a = PReLU1(y) in bf16;
//   b = bf16(cLN1(a)), f32 statistics;
//   c = the causal dilated depthwise conv over [history; b]: each tap
//       product rounded to bf16, the taps summed in bf16 in tap order;
//   history <- the last span rows of [history; b], written in place;
//   d = PReLU2(c) in bf16;  e = bf16(cLN2(d));
//   x' = bf16(x + bf16(e @ out_w)), f32 accumulation.
// These are the plain step's rounding points (stream_block_plain).
//
// One cluster of CL = 8 CTAs per stream. CTA c owns H / 8 channels: its
// columns of in_w, its depthwise taps and norm affines, and its channels of
// the stream's history ring, so the depthwise conv and the ring never leave
// the CTA: the history is read at the start and written back as soon as the
// ring is final, by the CTA alone (no other CTA reads those rows: the
// update is in place).
// It also owns B / 8 output columns (its columns of out_w). The frames run
// in tiles of ROWS = 16, the row count of mma.sync m16n8k16 (wgmma's 64-row
// minimum would waste three quarters of a tile at one stream's 16 frames),
// one tile after another inside the cluster, so a chunk of any length keeps
// its whole causal window in the CTA's ring of span + 16 rows.
// cLN's statistics over H are exchanged through distributed shared memory:
// each CTA sends the sum and the sum of squared deviations about its own
// mean of its channels (8 lanes of a row, one pair to each CTA), and every
// CTA combines the 8 pairs in rank order (Chan's parallel variance), so all
// of them normalise a row with the same mean and variance. e is gathered the
// same way: each CTA writes its channels of e into the tile buffer of all 8
// CTAs, which then multiply all H channels by their B / 8 columns of out_w.
// Each exchange is one-way: st.async writes that complete a transaction
// count on the receiver's mbarrier (one barrier per exchange, one phase a
// tile), which the receiver waits on; no cluster barrier is crossed after
// the one at the start (every CTA running, its barriers initialised). A
// CTA's next write into a buffer comes after it has received what every
// CTA sent next (the chain of exchanges), so no buffer is overwritten while
// it is read, and no CTA leaves while a write to it is in flight.
// Launched with programmatic dependent launch: a block's kernel starts while
// the previous one runs and loads its weights, taps and affines, then waits
// for it (griddepcontrol.wait) before it reads x and the history.

#include "hopper_gemm.cuh"

namespace tcn {
namespace stream {

using bf16 = __nv_bfloat16;
using hop::cluster_rank;
using hop::fence_barrier_init;
using hop::ldsm_x4;
using hop::ldsm_x4_t;
using hop::mapa;
using hop::mbar_expect_tx;
using hop::mbar_init;
using hop::mbar_wait;
using hop::pack_bf16;
using hop::smem_u32;
using hop::unpack_bf16;

constexpr int CL = 8;          // CTAs per stream (cluster size)
constexpr int THREADS = 128;   // 4 warps
constexpr int ROWS = 16;       // frames per tile
constexpr int PAD = 8;         // bf16 elements of padding per staged row (16 bytes)
constexpr float LN_EPS = 1e-8f;
constexpr int KB = 8;          // k steps of MMA fragments loaded ahead
constexpr int CHAINS = 4;      // accumulators a GEMM's MMAs go to in turn

struct Args {
  const bf16* x;
  bf16* out;
  const bf16* in_w;
  const bf16* alpha1;
  const float* g1;
  const float* b1;
  const bf16* dw;
  const bf16* alpha2;
  const float* g2;
  const float* b2;
  const bf16* out_w;
  bf16* hist;
  int Kc, P, dil, span, ring;
};

// Byte offsets of the shared-memory regions, each a multiple of 16 bytes:
// in_w's [B, H/8] and out_w's [H, B/8] column slices and the tile's x
// [16, B] and gathered e [16, H], rows padded by 16 bytes (ldmatrix reads 8
// rows at once without bank conflicts); the ring [span + 16, H/8]; the taps
// [P, H/8]; g1, b1, g2, b2 [H/8] f32; the two norms' exchanged pairs
// [2][CL][16] float2; the three exchanges' mbarriers.
struct Layout {
  int w1, w2, x, e, ring, dw, aff, stat, bar, total;
  __host__ __device__ Layout(int B, int H, int P, int ring_rows) {
    const int hc = H / CL, bc = B / CL;
    w1 = 0;
    w2 = w1 + B * (hc + PAD) * 2;
    x = w2 + H * (bc + PAD) * 2;
    e = x + ROWS * (B + PAD) * 2;
    ring = e + ROWS * (H + PAD) * 2;
    dw = ring + ring_rows * hc * 2;
    aff = dw + P * hc * 2;
    stat = aff + 4 * hc * 4;
    bar = stat + 2 * CL * ROWS * 8;
    total = bar + 3 * 8 + 8;
  }
};

__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}
// D[16, 8] += A[16, 16] @ B[16, 8], bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}
// Writes into the shared memory of a CTA of the cluster (addr and bar in
// that CTA, from mapa), completing the bytes on its mbarrier `bar`.
__device__ __forceinline__ void st_async_f2(uint32_t addr, float a, float b, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];" ::"r"(
          addr),
      "f"(a), "f"(b), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async_u4(uint32_t addr, uint4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}
// Programmatic dependent launch: let the next kernel of the stream start;
// wait until the previous one has finished and its writes are visible.
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

// The sum of a GEMM's chains of accumulators, in a fixed order.
template <int NT>
__device__ __forceinline__ float chain_sum(const float (&acc)[CHAINS][NT][4], int j, int i) {
  return (acc[0][j][i] + acc[1][j][i]) + (acc[2][j][i] + acc[3][j][i]);
}

// Rounds to the nearest bf16 (ties to even), back in f32.
__device__ __forceinline__ float bfr(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
// PReLU of a bf16 value with a bf16 slope, the product rounded to bf16.
__device__ __forceinline__ float prelu_bf(float y, float a) { return y >= 0.f ? y : bfr(a * y); }

__device__ __forceinline__ void unpack8(uint4 r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = unpack_bf16(w[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                    pack_bf16(f[6], f[7]));
}

// cLN of one row over H channels, in place on this thread's V * 8 values
// (8 threads a row, the CTA's H / CL channels): the pair (sum, sum of
// squared deviations about the CTA's mean) goes from lane l8 to CTA l8's
// `stat` slot [rank][row], completing on its mbarrier `bar`; once this
// CTA's `bar` has all 8 CTAs' pairs (phase `parity`) they are combined in
// rank order. y = bf16((gamma * (v - mean)) * rsqrt(var + eps) +
// beta), the plain version's order of operations, with no fused multiply-add.
template <int V, int HC>
__device__ __forceinline__ void layer_norm(float (&v)[V][8], const float* gam, const float* bet,
                                           uint32_t stat, const float2* stat_local,
                                           uint32_t bar, uint32_t parity, int row, int l8,
                                           uint32_t rank) {
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < V; ++u)
#pragma unroll
    for (int k = 0; k < 8; ++k) s += v[u][k];
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  const float mc = s / HC;
  float q = 0.f;
#pragma unroll
  for (int u = 0; u < V; ++u)
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float d = v[u][k] - mc;
      q += d * d;
    }
  q += __shfl_xor_sync(0xffffffffu, q, 1);
  q += __shfl_xor_sync(0xffffffffu, q, 2);
  q += __shfl_xor_sync(0xffffffffu, q, 4);
  st_async_f2(mapa(stat + (rank * ROWS + row) * 8, l8), s, q, mapa(bar, l8));
  mbar_wait(bar, parity);
  constexpr float H = float(HC * CL);
  float S = 0.f;
#pragma unroll
  for (int k = 0; k < CL; ++k) S += stat_local[k * ROWS + row].x;
  const float mean = S / H;
  float M2 = 0.f;
#pragma unroll
  for (int k = 0; k < CL; ++k) {
    const float2 p = stat_local[k * ROWS + row];
    const float d = p.x / HC - mean;
    M2 += p.y + HC * d * d;
  }
  const float rstd = rsqrtf(M2 / H + LN_EPS);
#pragma unroll
  for (int u = 0; u < V; ++u)
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int ch = (u * 8 + l8) * 8 + k;
      v[u][k] = bfr(__fadd_rn(__fmul_rn(__fmul_rn(gam[ch], __fsub_rn(v[u][k], mean)), rstd),
                              bet[ch]));
    }
}

// NT1 = H / 256 and NT2 = B / 256: the n8 tiles of each warp's columns in
// the in GEMM (H / 8 per CTA) and the out GEMM (B / 8 per CTA).
template <int NT1, int NT2>
__global__ void __launch_bounds__(THREADS) stream_block_kernel(const Args g) {
  constexpr int HC = 32 * NT1, BC = 32 * NT2;  // channels, output columns of this CTA
  constexpr int H = HC * CL, B = BC * CL;
  constexpr int V = HC / 64;  // 8-channel vectors a thread holds in the row phases
  extern __shared__ __align__(128) uint8_t smem[];
  const Layout L(B, H, g.P, g.ring);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t rank = cluster_rank();
  const int m = blockIdx.x / CL;
  const uint32_t s0 = smem_u32(smem);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  const bf16* sx = reinterpret_cast<const bf16*>(smem + L.x);
  const bf16* sdw = reinterpret_cast<const bf16*>(smem + L.dw);
  const float* aff = reinterpret_cast<const float*>(smem + L.aff);
  const float2* stat = reinterpret_cast<const float2*>(smem + L.stat);
  const uint32_t stat_s = s0 + L.stat;

  // The exchanges' mbarriers: one arrival (this CTA's expect_tx) and the
  // bytes of all 8 CTAs a phase, one phase a tile.
  const uint32_t bars = s0 + L.bar;
  constexpr uint32_t STAT_BYTES = CL * ROWS * 8, E_BYTES = ROWS * H * 2;
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i, 1);
    fence_barrier_init();
    mbar_expect_tx(bars, STAT_BYTES);
    mbar_expect_tx(bars + 8, STAT_BYTES);
    mbar_expect_tx(bars + 16, E_BYTES);
  }
  cluster_arrive_relaxed();  // waited on before the first exchange
  pdl_launch_dependents();

  // Loads: group 0 (in_w's slice, taps, affines) and group 1 (out_w's
  // slice) ahead of the previous kernel's end; then group 2 (x tile 0) and
  // group 3 (the history), waited on as each is needed.
  const bf16* xs = g.x + (size_t)m * g.Kc * B;
  auto load_x = [&](int t0) {
    for (int i = tid; i < ROWS * (B / 8); i += THREADS) {
      const int r = i / (B / 8), ch = i % (B / 8);
      const bool ok = t0 + r < g.Kc;
      cp16(s0 + L.x + (r * (B + PAD) + ch * 8) * 2, xs + (size_t)(ok ? t0 + r : 0) * B + ch * 8,
           ok);
    }
  };
  for (int i = tid; i < B * (HC / 8); i += THREADS) {
    const int k = i / (HC / 8), ch = i % (HC / 8);
    cp16(s0 + L.w1 + (k * (HC + PAD) + ch * 8) * 2, g.in_w + (size_t)k * H + rank * HC + ch * 8,
         true);
  }
  for (int i = tid; i < g.P * (HC / 8); i += THREADS) {
    const int p = i / (HC / 8), ch = i % (HC / 8);
    cp16(s0 + L.dw + (p * HC + ch * 8) * 2, g.dw + (size_t)p * H + rank * HC + ch * 8, true);
  }
  for (int i = tid; i < HC; i += THREADS) {  // 4 vectors of HC floats, 4 a copy
    const int v = i / (HC / 4), ch = i % (HC / 4);
    const float* src = v == 0 ? g.g1 : v == 1 ? g.b1 : v == 2 ? g.g2 : g.b2;
    cp16(s0 + L.aff + (v * HC + ch * 4) * 4, src + rank * HC + ch * 4, true);
  }
  cp_commit();
  for (int i = tid; i < H * (BC / 8); i += THREADS) {
    const int k = i / (BC / 8), ch = i % (BC / 8);
    cp16(s0 + L.w2 + (k * (BC + PAD) + ch * 8) * 2, g.out_w + (size_t)k * B + rank * BC + ch * 8,
         true);
  }
  cp_commit();
  pdl_wait();  // x is the previous kernel's output
  load_x(0);
  cp_commit();
  bf16* hist = g.hist + (size_t)m * g.span * H + rank * HC;
  for (int i = tid; i < g.span * (HC / 8); i += THREADS) {
    const int j = i / (HC / 8), ch = i % (HC / 8);
    cp16(s0 + L.ring + (j * HC + ch * 8) * 2, hist + (size_t)j * H + ch * 8, true);
  }
  cp_commit();

  const float a1 = __bfloat162float(*g.alpha1), a2 = __bfloat162float(*g.alpha2);
  const int row = tid >> 3, l8 = tid & 7;  // the row phases: 8 threads a row
  // ldmatrix lane addressing: rows (or k) 0-15 over lanes 0-15, the second
  // 8 columns (or n) from lane 16 on.
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;
  const int g8 = lane >> 2, q4 = lane & 3;  // mma accumulator rows g8, g8 + 8; columns 2 * q4

  for (int t0 = 0; t0 < g.Kc; t0 += ROWS) {
    const uint32_t parity = (t0 / ROWS) & 1;
    if (t0 == 0) {
      cp_wait<1>();  // all but the history
    } else {
      __syncthreads();  // the last tile's residual reads of x are done
      load_x(t0);
      cp_commit();
      cp_wait<0>();
    }
    __syncthreads();
    const int nr = min(ROWS, g.Kc - t0);
    const bool live = row < nr;
    const bool more = t0 + ROWS < g.Kc;

    // ---- in GEMM: y = x @ in_w[:, this CTA's channels]; a = PReLU1(bf16(y)) into the ring
    {
      // KB k steps' fragments are loaded before their MMAs, which go to
      // CHAINS accumulators in turn (independent chains of dependent MMAs).
      float acc[CHAINS][NT1][4] = {};
      const uint32_t xa = s0 + L.x + (lr * (B + PAD) + lc) * 2;
      const uint32_t wb = s0 + L.w1 + (lr * (HC + PAD) + warp * 8 * NT1 + lc) * 2;
      for (int k0 = 0; k0 < B / 16; k0 += KB) {
        uint32_t a[KB][4], b[KB][NT1 / 2][4];
#pragma unroll
        for (int u = 0; u < KB; ++u) {
          ldsm_x4(a[u], xa + (k0 + u) * 32);
#pragma unroll
          for (int j = 0; j < NT1 / 2; ++j)
            ldsm_x4_t(b[u][j], wb + ((k0 + u) * 16 * (HC + PAD) + j * 16) * 2);
        }
#pragma unroll
        for (int u = 0; u < KB; ++u)
#pragma unroll
          for (int j = 0; j < NT1 / 2; ++j) {
            mma16816(acc[u % CHAINS][2 * j], a[u], b[u][j][0], b[u][j][1]);
            mma16816(acc[u % CHAINS][2 * j + 1], a[u], b[u][j][2], b[u][j][3]);
          }
      }
#pragma unroll
      for (int j = 0; j < NT1; ++j) {
        const int n = warp * 8 * NT1 + j * 8 + 2 * q4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = g8 + h * 8;
          if (r < nr) {
            const float v0 = prelu_bf(bfr(chain_sum(acc, j, 2 * h)), a1);
            const float v1 = prelu_bf(bfr(chain_sum(acc, j, 2 * h + 1)), a1);
            *reinterpret_cast<uint32_t*>(ring + (size_t)((g.span + t0 + r) % g.ring) * HC + n) =
                pack_bf16(v0, v1);
          }
        }
      }
    }
    __syncthreads();

    // ---- cLN1 in place in the ring
    float v[V][8];
    bf16* rrow = ring + (size_t)((g.span + t0 + row) % g.ring) * HC;
#pragma unroll
    for (int u = 0; u < V; ++u)
      unpack8(live ? *reinterpret_cast<const uint4*>(rrow + (u * 8 + l8) * 8) : make_uint4(0, 0, 0, 0),
              v[u]);
    if (t0 == 0) cluster_wait();  // every CTA of the cluster is running
    layer_norm<V, HC>(v, aff, aff + HC, stat_s, stat, bars, parity, row, l8, rank);
    if (tid == 0 && more) mbar_expect_tx(bars, STAT_BYTES);  // the next tile's phase
    if (live) {
#pragma unroll
      for (int u = 0; u < V; ++u) *reinterpret_cast<uint4*>(rrow + (u * 8 + l8) * 8) = pack8(v[u]);
    }
    if (t0 == 0) cp_wait<0>();  // the history
    __syncthreads();
    if (!more) {
      // The ring is final: the new history, the last span rows of
      // [history; b], goes back in place while the block runs on.
      for (int i = tid; i < g.span * (HC / 8); i += THREADS) {
        const int j = i / (HC / 8), ch = i % (HC / 8);
        *reinterpret_cast<uint4*>(hist + (size_t)j * H + ch * 8) =
            *reinterpret_cast<const uint4*>(ring + (size_t)((g.Kc + j) % g.ring) * HC + ch * 8);
      }
    }

    // ---- causal depthwise conv over the ring, PReLU2, cLN2
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int ch = (u * 8 + l8) * 8;
      float acc[8];
      for (int p = 0; p < g.P; ++p) {
        float xe[8], we[8];
        unpack8(*reinterpret_cast<const uint4*>(ring + (size_t)((t0 + row + p * g.dil) % g.ring) *
                                                           HC + ch),
                xe);
        unpack8(*reinterpret_cast<const uint4*>(sdw + p * HC + ch), we);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float tap = bfr(xe[k] * we[k]);
          acc[k] = p == 0 ? tap : bfr(acc[k] + tap);
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) v[u][k] = live ? prelu_bf(acc[k], a2) : 0.f;
    }
    layer_norm<V, HC>(v, aff + 2 * HC, aff + 3 * HC, stat_s + CL * ROWS * 8, stat + CL * ROWS,
                      bars + 8, parity, row, l8, rank);
    if (tid == 0 && more) mbar_expect_tx(bars + 8, STAT_BYTES);
    // ---- gather e: this CTA's channels into the tile buffer of every CTA
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const uint4 pk = live ? pack8(v[u]) : make_uint4(0, 0, 0, 0);
      const uint32_t at = s0 + L.e + (row * (H + PAD) + rank * HC + (u * 8 + l8) * 8) * 2;
#pragma unroll
      for (int k = 0; k < CL; ++k) st_async_u4(mapa(at, k), pk, mapa(bars + 16, k));
    }
    mbar_wait(bars + 16, parity);
    if (tid == 0 && more) mbar_expect_tx(bars + 16, E_BYTES);

    // ---- out GEMM: z = e @ out_w[:, this CTA's columns]; x' = bf16(x + bf16(z))
    {
      float acc[CHAINS][NT2][4] = {};
      const uint32_t ea = s0 + L.e + (lr * (H + PAD) + lc) * 2;
      const uint32_t wb = s0 + L.w2 + (lr * (BC + PAD) + warp * 8 * NT2) * 2;
      for (int k0 = 0; k0 < H / 16; k0 += KB) {
        uint32_t a[KB][4], b[KB][NT2][2];
#pragma unroll
        for (int u = 0; u < KB; ++u) {
          ldsm_x4(a[u], ea + (k0 + u) * 32);
#pragma unroll
          for (int j = 0; j < NT2; ++j)
            ldsm_x2_t(b[u][j], wb + ((k0 + u) * 16 * (BC + PAD) + j * 8) * 2);
        }
#pragma unroll
        for (int u = 0; u < KB; ++u)
#pragma unroll
          for (int j = 0; j < NT2; ++j) mma16816(acc[u % CHAINS][j], a[u], b[u][j][0], b[u][j][1]);
      }
      bf16* outs = g.out + ((size_t)m * g.Kc + t0) * B;
#pragma unroll
      for (int j = 0; j < NT2; ++j) {
        const int n = rank * BC + warp * 8 * NT2 + j * 8 + 2 * q4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = g8 + h * 8;
          if (r < nr) {
            const float2 xr = unpack_bf16(*reinterpret_cast<const uint32_t*>(sx + r * (B + PAD) + n));
            const float z0 = bfr(chain_sum(acc, j, 2 * h));
            const float z1 = bfr(chain_sum(acc, j, 2 * h + 1));
            *reinterpret_cast<uint32_t*>(outs + (size_t)r * B + n) = pack_bf16(xr.x + z0, xr.y + z1);
          }
        }
      }
    }
  }
}

template <int NT1, int NT2>
static cudaError_t launch(const Args& a, int M, int smem, int pdl, cudaStream_t s) {
  // The shared-memory opt-in, once per device (a host call of its own).
  static bool opted[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(stream_block_kernel<NT1, NT2>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               hop::SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    opted[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(M * CL, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 2 : 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, stream_block_kernel<NT1, NT2>, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace stream
}  // namespace tcn

using tcn::stream::Layout;

// Shared memory of one CTA (ops/kernels/limits.stream_smem computes the same).
extern "C" int tcn_stream_block_smem(int B, int H, int P, int dilation) {
  return Layout(B, H, P, (P - 1) * dilation + tcn::stream::ROWS).total;
}

// x, out [M, Kc, B] bf16; in_w [B, H], dw [P, H], out_w [H, B] bf16; alpha1,
// alpha2 one bf16 each; g1, b1, g2, b2 [H] f32; hist [M, (P - 1) * dilation,
// H] bf16, updated in place. (B, H) = (256, 512) (limits.STREAM_WIDTHS);
// anything else, or shared memory past the limit, is refused before a launch. pdl: launch
// as a programmatic dependent of the stream's previous kernel (0: after it,
// as any launch; the kernel alone, for timing it).
extern "C" int tcn_stream_block(int device, const void* x, void* out, const void* in_w,
                                const void* alpha1, const float* g1, const float* b1,
                                const void* dw, const void* alpha2, const float* g2,
                                const float* b2, const void* out_w, void* hist, int M, int Kc,
                                int B, int H, int P, int dilation, int pdl, void* stream) {
  using namespace tcn::stream;
  cudaSetDevice(device);
  if (M < 1 || Kc < 1 || P < 1 || dilation < 1) return cudaErrorInvalidValue;
  const int span = (P - 1) * dilation;
  const Layout L(B, H, P, span + ROWS);
  if (L.total > tcn::hop::SMEM_LIMIT) return cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(x), static_cast<bf16*>(out),
               static_cast<const bf16*>(in_w), static_cast<const bf16*>(alpha1), g1, b1,
               static_cast<const bf16*>(dw), static_cast<const bf16*>(alpha2), g2, b2,
               static_cast<const bf16*>(out_w), static_cast<bf16*>(hist), Kc, P, dilation,
               span, span + ROWS};
  const auto s = static_cast<cudaStream_t>(stream);
  if (H == 512 && B == 256) return launch<2, 1>(a, M, L.total, pdl, s);
  return cudaErrorInvalidValue;
}
