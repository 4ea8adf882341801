// GQA flash attention backward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention's
// backward, which the Pallas kernel never had: the JAX package trains
// through the custom VJP repro/kernels/xla_flash.py::_vjp_bwd, and this
// computes its equations.  From the forward's q [B,Sq,H,D], k [B,Sk,K,D],
// v [B,Sk,K,Dv], out [B,Sq,H,Dv], its fp32 log-sum-exp lse [B,Sq,H]
// (csrc/flash_attention.cu) and dout = dL/dout:
//   Dsum = sum_d dO * O (fp32), p = exp(s - lse) recomputed from the scores,
//   dV = P^T dO, dP = dO V^T, dS = P * (dP - Dsum),
//   dQ = scale * dS K, dK = scale * dS^T Q,
// the G query heads of a group summed into their KV head's dK and dV, the
// same causal diagonal (q_offset) and ragged Sq/Sk tails as the forward.
// bf16 rounds P before dV and dS before dQ and dK, as the reference does.
//
// What bounds it on this card: five products of 2*Sq*Sk*D flops per head
// (halved when causal) against O(S*D) bytes, so at training lengths it is
// bound by operations (at [2,4096], H 15, D 64: 161 GFLOP, 0.16 ms at the
// bf16 tensor-core rate, against ~84 MB, 0.025 ms).
//
// bf16 design: three launches on the stream, deterministic (no atomics:
// two calls give the same bits).
//   (a) dsum_lse_kernel: Dsum per (token, head), and the lse in the log2
//       domain, both written head-major [2][B*H][Sqp] (Sqp = Sq rounded up
//       to 128, the pad zeroed) so that a tile's values are one TMA box.
//   (b) bwd_dkdv_wgmma: one block per (64-key tile, KV head, batch), the
//       blocks numbered heaviest first (under causal masking key tile 0
//       walks every row tile, the last tile only the diagonal), so the
//       grid's tail holds the short walks.  It walks (row tile, head in
//       group) pairs past the causal diagonal; a row tile is W tokens of
//       ONE query head, so no (token, head) row arithmetic is needed.
//   (c) bwd_dq_wgmma: one block per (64-token tile, query head, batch),
//       heaviest (last, under causal) tiles first, walking W-key tiles.
// W = 128 at D, Dv <= 64 (64 at D = 96 and 128 and at the MLA widths (192, 128),
// where the accumulators leave no registers for wider tiles).  Each block
// is two warpgroups, two blocks an SM (one at (192, 128), whose 122.5 KB
// of shared memory leave no room for a second).  One thread of the
// producer warpgroup keeps a ring of two stages in flight by TMA, each
// stage's arrival and release on an mbarrier pair: (Q, dO, lse, Dsum) row
// tiles in (b), (K, V) key tiles in (c); the block's fixed tiles arrive the
// same way once.  With two blocks an SM the producer gives up its
// registers (setmaxnreg 24) to the consumer (setmaxnreg 232); with one,
// every thread may hold 255, which (b) needs at (192, 128) for dK's 64 x
// 192 and dV's 64 x 128 fp32 accumulators (160 a thread) beside S^T and
// dP^T.  The consumer warpgroup runs every product as a wgmma with fp32
// accumulators in registers:
//   (b) S^T = K Q^T and dP^T = V dO^T from shared memory (both K-major,
//       m64nWk16), then dV += P^T dO and dK += dS^T Q with P^T and dS^T as
//       the register A operand (the accumulator layout is the A layout)
//       and dO, Q as the transposed (MN-major) B operand;
//   (c) S = Q K^T and dP = dO V^T, then dQ += dS K (K MN-major).
// exp(S - lse) is computed while the dP product runs.  Tiles are 64-column
// bf16 panels with the 128-byte swizzle that TMA writes and wgmma reads;
// a head dim below 64 is padded to one panel by the tensor map's zero
// fill (D 32 and 48, Dv 32), 128 is two panels, 192 three (dK and dQ
// then take m64n192 products); 96 (phi-3-vision) is two panels whose last
// 32 columns the zero fill pads, so (96, 96) runs (128, 128)'s bodies and
// a quarter of its products are on zeros.  Rows past Sq and keys
// past Sk arrive as zeros and are masked.  (b) and (c) both recompute S
// and dP: seven products for the five the bound counts, the price of no
// atomics.  Tried and dropped (NVIDIA H100, PERF.md): K/V or Q/dO as
// register A operands, two consumer warpgroups sharing each stage, a
// product left running across walk steps (ptxas then serializes every
// wgmma), (b) and (c) in one launch.
// fp32 takes CUDA-core bodies of the same grids (32 rows or keys per block,
// four threads each), kept for the fp32 tolerance of 1e-4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// (a) Dsum = sum over Dv of dO * O, one warp per (b, token, head) row (fp32)
// ---------------------------------------------------------------------------
constexpr int kDsumWarps = 8;

__global__ void __launch_bounds__(kDsumWarps * 32)
dsum_kernel(const float* __restrict__ out, const float* __restrict__ dout,
            float* __restrict__ dsum, long long rows, int DV) {
  const long long row = (long long)blockIdx.x * kDsumWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp leaves together
  const float* o = out + row * DV;
  const float* g = dout + row * DV;
  float acc = 0.f;
  for (int d = lane; d < DV; d += 32) acc = fmaf(o[d], g[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dsum[row] = acc;
}

// Dsum and lse * log2(e) of the bf16 path, head-major: stats[0][bh][t] =
// lse2, stats[1][bh][t] = Dsum for t < Sq, 0 for Sq <= t < Sqp.
// dsum_lanes(Dv) threads per (b * H + h, t) row, 16 bytes of O and dO
// each: Dv / 8 rounded up to a power of two (4, 8 or 16), so that a row's
// lanes lie in one aligned group of a warp and the xor tree below never
// mixes two rows; the spare lanes (4 of 16 at Dv 96) add 0.  At Dv 32, 64
// and 128 there are none, and the sums run in the same order as with
// exactly Dv / 8 lanes.
constexpr int kDsumThreads = 256;

__host__ __device__ constexpr int dsum_lanes(int DV) {
  return DV <= 32 ? 4 : DV <= 64 ? 8 : 16;
}

__global__ void __launch_bounds__(kDsumThreads)
dsum_lse_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ stats, int Sq, int Sqp,
                int H, int DV, long long rows) {
  const int lanes = dsum_lanes(DV);
  const long long row = ((long long)blockIdx.x * kDsumThreads + threadIdx.x) / lanes;
  const int sub = threadIdx.x % lanes;
  const int t = (int)(row % Sqp);
  const long long bh = row / Sqp;
  const long long src = ((bh / H) * Sq + t) * H + bh % H;
  float acc = 0.f;
  if (row < rows && t < Sq && 8 * sub < DV) {
    const uint4 o = *reinterpret_cast<const uint4*>(out + src * DV + 8 * sub);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + src * DV + 8 * sub);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 of = __bfloat1622float2(o2[i]), gf = __bfloat1622float2(g2[i]);
      acc = fmaf(of.x, gf.x, fmaf(of.y, gf.y, acc));
    }
  }
  for (int off = lanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (sub == 0 && row < rows) {
    stats[row] = t < Sq ? lse[src] * kLog2e : 0.f;
    stats[rows + row] = acc;
  }
}

// ---------------------------------------------------------------------------
// bf16 bodies: TMA, mbarriers, wgmma
// ---------------------------------------------------------------------------
constexpr int kTile = 64;         // keys of a dK/dV block, tokens of a dQ block
constexpr int kWThreads = 256;    // consumer warpgroup, then producer warpgroup
constexpr int kStatsPad = 128;    // the stats' token axis is padded to the widest walk tile

// Shared memory of one block: the fixed tiles ([64][DP] and [64][DVP]: K
// and V in (b), Q and dO in (c)), a ring of stages of walk tiles ([W][DP]
// and [W][DVP]: Q and dO in (b), K and V in (c)), the (lse2, Dsum) stats
// (the fixed slot, then one per stage), the barriers.  A tile is D / 64
// panels of 64 columns with 128-byte swizzled rows.  Two blocks fit an
// SM with two stages (a third would not fit: 2 x 117 KB at D = 64) up to
// D = Dv = 128; at (192, 128) one block of 122.5 KB does (kBlocks).
template <int DP, int DVP, int W>
struct WShape {
  static constexpr int kStages = 2;
  static constexpr int kFixedPanel = kTile * kRowBytes;
  static constexpr int kWalkPanel = W * kRowBytes;
  static constexpr int kFixedBytes = (DP + DVP) / 64 * kFixedPanel;
  static constexpr int kStageBytes = (DP + DVP) / 64 * kWalkPanel;
  static constexpr int kStatsSlot = 2 * W * (int)sizeof(float);
  static constexpr int kStatsOff = kFixedBytes + kStages * kStageBytes;
  static constexpr int kBarOff = kStatsOff + (1 + kStages) * kStatsSlot;
  static constexpr int kSmem = kBarOff + (2 * kStages + 1) * 8 + 1024;  // + alignment
  // blocks an SM holds (233,472 bytes of shared memory, 1 KB of it
  // reserved per block).  With two, the producer gives its registers to
  // the consumer (setmaxnreg: 24 + 232 = 2 x 128 a thread); with one, no
  // register is moved and every thread may take up to 255.
  static constexpr int kBlocks = 2 * (kSmem + 1024) <= 233472 ? 2 : 1;
};

template <int kBlocks>
__device__ __forceinline__ void producer_registers() {
  if constexpr (kBlocks == 2) setmaxnreg_producer();
}
template <int kBlocks>
__device__ __forceinline__ void consumer_registers() {
  if constexpr (kBlocks == 2) setmaxnreg_consumer();
}

// the (lse2, Dsum) box of a tile's tokens of one (batch, head) row
__device__ __forceinline__ void tma_load_stats(void* dst, const CUtensorMap* map, uint64_t* bar,
                                               int t0, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(t0), "r"(bh), "r"(0)
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the tensor maps of one kernel: its fixed tiles (boxes of 64 tokens), its
// walk tiles (boxes of W tokens), the stats (boxes of its walk's W tokens
// in (b), of the fixed 64 in (c))
struct Maps {
  CUtensorMap fixed_a, fixed_b, walk_a, walk_b, stats;
};

struct Dims {
  int B, Sq, Sk, H, K, D, DV;
  float scale;
  int causal, q_offset;
};

template <int DP, int DVP, int W>
struct Smem {
  using S = WShape<DP, DVP, W>;
  unsigned char* base;
  __device__ explicit Smem(unsigned char* raw)
      : base(reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                              ~uintptr_t(1023))) {}
  __device__ unsigned char* fixed_a() const { return base; }
  __device__ unsigned char* fixed_b() const { return base + DP / 64 * S::kFixedPanel; }
  __device__ unsigned char* walk_a(int st) const {
    return base + S::kFixedBytes + st * S::kStageBytes;
  }
  __device__ unsigned char* walk_b(int st) const { return walk_a(st) + DP / 64 * S::kWalkPanel; }
  __device__ float* stats(int slot) const {  // slot 0: the fixed tiles', 1 + st: a stage's
    return reinterpret_cast<float*>(base + S::kStatsOff + slot * S::kStatsSlot);
  }
  __device__ uint64_t* full() const { return reinterpret_cast<uint64_t*>(base + S::kBarOff); }
  __device__ uint64_t* empty() const { return full() + S::kStages; }
  __device__ uint64_t* fixed() const { return full() + 2 * S::kStages; }
  __device__ void init_barriers() const {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full()[s], 1);
      mbar_init(&empty()[s], 4);  // one arrival per consumer warp
    }
    mbar_init(fixed(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// (b) dK, dV for one 64-key tile of one KV head, walking W-token row tiles
template <int DP, int DVP, int W>
__global__ void __launch_bounds__(kWThreads, WShape<DP, DVP, W>::kBlocks)
bwd_dkdv_wgmma(const __grid_constant__ Maps maps, bf16* __restrict__ dk, bf16* __restrict__ dv,
               const Dims a) {
  using S = WShape<DP, DVP, W>;
  extern __shared__ unsigned char smem_raw[];
  const Smem<DP, DVP, W> sm(smem_raw);

  const int G = a.H / a.K;
  // work item blockIdx.x: key tile major, so the longest causal walks come first
  const int kh = blockIdx.x % a.K;
  const int b = blockIdx.x / a.K % a.B;
  const int k0 = blockIdx.x / (a.K * a.B) * kTile;
  const int n_wt = (a.Sq + W - 1) / W;
  // the row tiles whose tokens see a key of this tile (causal: t + q_offset >= k0)
  const int t_first = a.causal ? max(0, k0 - a.q_offset) : 0;
  const int wt_begin = t_first < a.Sq ? t_first / W : n_wt;
  const int n_items = (n_wt - wt_begin) * G;

  if (threadIdx.x == 0) sm.init_barriers();
  __syncthreads();

  if (threadIdx.x >= 128) {  // producer warpgroup: one thread issues every copy
    producer_registers<S::kBlocks>();
    if (threadIdx.x == 128) {
      mbar_expect_tx(sm.fixed(), S::kFixedBytes);
      tma_tile<DP>(sm.fixed_a(), S::kFixedPanel, &maps.fixed_a, sm.fixed(), kh, k0, b);
      tma_tile<DVP>(sm.fixed_b(), S::kFixedPanel, &maps.fixed_b, sm.fixed(), kh, k0, b);
      for (int it = 0; it < n_items; ++it) {
        const int st = it % S::kStages;
        mbar_wait(&sm.empty()[st], ((it / S::kStages) & 1) ^ 1);
        const int h = kh * G + it % G;
        const int t0 = (wt_begin + it / G) * W;
        uint64_t* bar = &sm.full()[st];
        mbar_expect_tx(bar, S::kStageBytes + 2 * W * (int)sizeof(float));
        tma_tile<DP>(sm.walk_a(st), S::kWalkPanel, &maps.walk_a, bar, h, t0, b);
        tma_tile<DVP>(sm.walk_b(st), S::kWalkPanel, &maps.walk_b, bar, h, t0, b);
        tma_load_stats(sm.stats(1 + st), &maps.stats, bar, t0, b * a.H + h);
      }
    }
  } else {  // consumer warpgroup
    consumer_registers<S::kBlocks>();
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int c = lane % 4;
    const int key_lo = k0 + warp * 16 + lane / 4;  // this thread's keys: key_lo, key_lo + 8
    const float sl2 = a.scale * kLog2e;

    float dka[DP / 2], dva[DVP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dka[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DVP / 2; ++i) dva[i] = 0.f;
    const uint64_t kdesc = sw128_desc(sm.fixed_a(), S::kFixedPanel);
    const uint64_t vdesc = sw128_desc(sm.fixed_b(), S::kFixedPanel);
    mbar_wait(sm.fixed(), 0);

    for (int it = 0; it < n_items; ++it) {
      const int st = it % S::kStages;
      const int t0 = (wt_begin + it / G) * W;
      const uint64_t qdesc = sw128_desc(sm.walk_a(st), S::kWalkPanel);
      const uint64_t odesc = sw128_desc(sm.walk_b(st), S::kWalkPanel);
      mbar_wait(&sm.full()[st], (it / S::kStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x W rows
      float s[W / 2], dp[W / 2];
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < DP / 16; ++k)
        wgmma_ss<W>(s, kdesc + kmajor_step(k, S::kFixedPanel),
                    qdesc + kmajor_step(k, S::kWalkPanel), k > 0);
      wgmma_commit();
#pragma unroll
      for (int k = 0; k < DVP / 16; ++k)
        wgmma_ss<W>(dp, vdesc + kmajor_step(k, S::kFixedPanel),
                    odesc + kmajor_step(k, S::kWalkPanel), k > 0);
      wgmma_commit();

      // P^T = exp(S^T * scale - lse) while dP^T runs, then dS^T = P^T * (dP^T - Dsum)
      wgmma_wait<1>();
      acc_fence(s);
      const float* lt = sm.stats(1 + st);
      const bool need_mask = t0 + W > a.Sq || (a.causal && t0 + a.q_offset < k0 + kTile - 1);
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lt + 8 * j + 2 * c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e] * sl2 - ((e & 1) ? l2.y : l2.x);
          if (need_mask) {
            const int t = t0 + 8 * j + 2 * c + (e & 1);
            const bool live = t < a.Sq && (!a.causal || key_lo + 8 * (e >> 1) <= t + a.q_offset);
            x = live ? x : -INFINITY;
          }
          s[4 * j + e] = ex2(x);
        }
      }
      wgmma_wait<0>();
      acc_fence(dp);
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        const float2 ds = *reinterpret_cast<const float2*>(lt + W + 8 * j + 2 * c);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? ds.y : ds.x));
      }
      uint32_t pa[W / 16][4], dsa[W / 16][4];
      acc_to_a<W>(pa, s);
      acc_to_a<W>(dsa, dp);

      // dV += P^T dO and dK += dS^T Q (dO and Q MN-major)
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < W / 16; ++k) wgmma_rs<DVP>(dva, pa[k], odesc + mnmajor_step(k));
#pragma unroll
      for (int k = 0; k < W / 16; ++k) wgmma_rs<DP>(dka, dsa[k], qdesc + mnmajor_step(k));
      wgmma_commit();
      wgmma_wait<0>();
      acc_fence(dva);
      acc_fence(dka);
      release(&sm.empty()[st], lane);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key_lo + 8 * h;
      if (key < a.Sk) {
        const long long row = ((long long)b * a.Sk + key) * a.K + kh;
        bf16* kp = dk + row * a.D + 2 * c;
        bf16* vp = dv + row * a.DV + 2 * c;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j)
          if (8 * j < a.D)
            *reinterpret_cast<uint32_t*>(kp + 8 * j) =
                pack_bf16(dka[4 * j + 2 * h] * a.scale, dka[4 * j + 2 * h + 1] * a.scale);
#pragma unroll
        for (int j = 0; j < DVP / 8; ++j)
          if (8 * j < a.DV)
            *reinterpret_cast<uint32_t*>(vp + 8 * j) =
                pack_bf16(dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
      }
    }
  }
}

// (c) dQ for one 64-token tile of one query head, walking W-key tiles
template <int DP, int DVP, int W>
__global__ void __launch_bounds__(kWThreads, WShape<DP, DVP, W>::kBlocks)
bwd_dq_wgmma(const __grid_constant__ Maps maps, bf16* __restrict__ dq, const Dims a) {
  using S = WShape<DP, DVP, W>;
  extern __shared__ unsigned char smem_raw[];
  const Smem<DP, DVP, W> sm(smem_raw);

  const int G = a.H / a.K;
  const int n_rt = (a.Sq + kTile - 1) / kTile;
  // work item blockIdx.x: the last row tiles (the longest causal walks) first
  const int t0 = (n_rt - 1 - (int)(blockIdx.x / (a.H * a.B))) * kTile;
  const int h = blockIdx.x % a.H;
  const int b = blockIdx.x / a.H % a.B;
  int k_end = a.Sk;
  if (a.causal) k_end = min(a.Sk, max(0, min(t0 + kTile, a.Sq) + a.q_offset));
  const int n_wt = (k_end + W - 1) / W;

  if (threadIdx.x == 0) sm.init_barriers();
  __syncthreads();

  if (threadIdx.x >= 128) {
    producer_registers<S::kBlocks>();
    if (threadIdx.x == 128) {
      mbar_expect_tx(sm.fixed(), S::kFixedBytes + 2 * kTile * (int)sizeof(float));
      tma_tile<DP>(sm.fixed_a(), S::kFixedPanel, &maps.fixed_a, sm.fixed(), h, t0, b);
      tma_tile<DVP>(sm.fixed_b(), S::kFixedPanel, &maps.fixed_b, sm.fixed(), h, t0, b);
      tma_load_stats(sm.stats(0), &maps.stats, sm.fixed(), t0, b * a.H + h);
      const int kh = h / G;
      for (int it = 0; it < n_wt; ++it) {
        const int st = it % S::kStages;
        mbar_wait(&sm.empty()[st], ((it / S::kStages) & 1) ^ 1);
        uint64_t* bar = &sm.full()[st];
        mbar_expect_tx(bar, S::kStageBytes);
        tma_tile<DP>(sm.walk_a(st), S::kWalkPanel, &maps.walk_a, bar, kh, it * W, b);
        tma_tile<DVP>(sm.walk_b(st), S::kWalkPanel, &maps.walk_b, bar, kh, it * W, b);
      }
    }
  } else {
    consumer_registers<S::kBlocks>();
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int c = lane % 4;
    const int t_lo = t0 + warp * 16 + lane / 4;  // this thread's tokens: t_lo, t_lo + 8
    const float sl2 = a.scale * kLog2e;

    float dqa[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dqa[i] = 0.f;
    const uint64_t qdesc = sw128_desc(sm.fixed_a(), S::kFixedPanel);
    const uint64_t odesc = sw128_desc(sm.fixed_b(), S::kFixedPanel);
    mbar_wait(sm.fixed(), 0);
    const float* lt = sm.stats(0);  // [lse2 of 64 tokens][Dsum of 64 tokens]
    float lse2[2], dsm[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      lse2[h2] = lt[t_lo - t0 + 8 * h2];
      dsm[h2] = lt[kTile + t_lo - t0 + 8 * h2];
    }

    for (int it = 0; it < n_wt; ++it) {
      const int st = it % S::kStages;
      const int k0 = it * W;
      const uint64_t kdesc = sw128_desc(sm.walk_a(st), S::kWalkPanel);
      const uint64_t vdesc = sw128_desc(sm.walk_b(st), S::kWalkPanel);
      mbar_wait(&sm.full()[st], (it / S::kStages) & 1);

      // S = Q K^T and dP = dO V^T: 64 rows x W keys
      float s[W / 2], dp[W / 2];
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < DP / 16; ++k)
        wgmma_ss<W>(s, qdesc + kmajor_step(k, S::kFixedPanel),
                    kdesc + kmajor_step(k, S::kWalkPanel), k > 0);
      wgmma_commit();
#pragma unroll
      for (int k = 0; k < DVP / 16; ++k)
        wgmma_ss<W>(dp, odesc + kmajor_step(k, S::kFixedPanel),
                    vdesc + kmajor_step(k, S::kWalkPanel), k > 0);
      wgmma_commit();

      // P = exp(S * scale - lse) while dP runs, then dS = P * (dP - Dsum)
      wgmma_wait<1>();
      acc_fence(s);
      const bool need_mask = k0 + W > a.Sk || (a.causal && k0 + W - 1 > t0 + a.q_offset);
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e] * sl2 - lse2[e >> 1];
          if (need_mask) {
            const int key = k0 + 8 * j + 2 * c + (e & 1);
            const bool live = key < a.Sk && (!a.causal || key <= t_lo + 8 * (e >> 1) + a.q_offset);
            x = live ? x : -INFINITY;
          }
          s[4 * j + e] = ex2(x);
        }
      }
      wgmma_wait<0>();
      acc_fence(dp);
#pragma unroll
      for (int i = 0; i < W / 2; ++i) dp[i] = s[i] * (dp[i] - dsm[(i >> 1) & 1]);
      uint32_t dsa[W / 16][4];
      acc_to_a<W>(dsa, dp);

      // dQ += dS K (K MN-major)
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < W / 16; ++k) wgmma_rs<DP>(dqa, dsa[k], kdesc + mnmajor_step(k));
      wgmma_commit();
      wgmma_wait<0>();
      acc_fence(dqa);
      release(&sm.empty()[st], lane);
    }

#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int t = t_lo + 8 * h2;
      if (t < a.Sq) {
        bf16* qp = dq + (((long long)b * a.Sq + t) * a.H + h) * a.D + 2 * c;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j)
          if (8 * j < a.D)
            *reinterpret_cast<uint32_t*>(qp + 8 * j) =
                pack_bf16(dqa[4 * j + 2 * h2] * a.scale, dqa[4 * j + 2 * h2 + 1] * a.scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 CUDA-core bodies: 32 rows (dQ) or 32 keys (dK/dV) per block, four
// threads each holding a quarter of the head dims
// ---------------------------------------------------------------------------
constexpr int kRows = 32;
constexpr int kLanes = 4;
constexpr int kThreads = kRows * kLanes;

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D, int DV, int BK>
__global__ void __launch_bounds__(kThreads)
bwd_dq_simt(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dsum,
            float* __restrict__ dq, int Sq, int Sk, int H, int K, float scale, int causal,
            int q_offset) {
  constexpr int DQ = D / kLanes;
  constexpr int DVQ = DV / kLanes;
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][DV];

  const int G = H / K;
  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int rows_total = Sq * G;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int lane = threadIdx.x % kLanes;
  const int r = r0 + threadIdx.x / kLanes;
  const bool active = r < rows_total;
  const int rr = active ? r : rows_total - 1;  // inactive rows compute, never store
  const int t = rr / G;
  const int h = kh * G + rr % G;
  const long long qpos = (long long)t + q_offset;
  const long long row = ((long long)b * Sq + t) * H + h;

  float qr[DQ], gr[DVQ], acc[DQ];
#pragma unroll
  for (int i = 0; i < DQ; ++i) {
    qr[i] = q[row * D + i * kLanes + lane];
    acc[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < DVQ; ++i) gr[i] = dout[row * DV + i * kLanes + lane];
  const float lse_r = lse[row];
  const float dsum_r = dsum[row];

  int k_end = Sk;
  if (causal) {
    const int r_last = min(r0 + kRows, rows_total) - 1;
    const long long q_last = (long long)(r_last / G) + q_offset;
    k_end = (int)min((long long)Sk, q_last + 1 > 0 ? q_last + 1 : 0LL);
  }
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = threadIdx.x; idx < BK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      ks[j][d] = k0 + j < Sk ? k[(((long long)b * Sk + k0 + j) * K + kh) * D + d] : 0.f;
    }
    for (int idx = threadIdx.x; idx < BK * DV; idx += kThreads) {
      const int j = idx / DV, d = idx % DV;
      vs[j][d] = k0 + j < Sk ? v[(((long long)b * Sk + k0 + j) * K + kh) * DV + d] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DQ; ++i) s = fmaf(qr[i], ks[j][i * kLanes + lane], s);
#pragma unroll
      for (int i = 0; i < DVQ; ++i) dp = fmaf(gr[i], vs[j][i * kLanes + lane], dp);
      s = quad_sum(s);
      dp = quad_sum(dp);
      const int kp = k0 + j;
      const bool live = kp < Sk && (!causal || kp <= qpos);
      const float p = live ? expf(s * scale - lse_r) : 0.f;
      const float ds = p * (dp - dsum_r);
#pragma unroll
      for (int i = 0; i < DQ; ++i) acc[i] = fmaf(ds, ks[j][i * kLanes + lane], acc[i]);
    }
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < DQ; ++i) dq[row * D + i * kLanes + lane] = acc[i] * scale;
  }
}

template <int D, int DV, int BQ>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_simt(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dsum,
              float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H, int K,
              float scale, int causal, int q_offset) {
  constexpr int DQ = D / kLanes;
  constexpr int DVQ = DV / kLanes;
  __shared__ float qs[BQ][D];
  __shared__ float gs[BQ][DV];
  __shared__ float ls[BQ];
  __shared__ float dss[BQ];

  const int G = H / K;
  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int rows_total = Sq * G;
  const int kb0 = blockIdx.x * kRows;
  const int lane = threadIdx.x % kLanes;
  const int key = kb0 + threadIdx.x / kLanes;
  const bool active = key < Sk;
  const long long kvrow = ((long long)b * Sk + (active ? key : Sk - 1)) * K + kh;
  const long long head0 = (long long)b * Sq * H + (long long)kh * G;

  float kr[DQ], vr[DVQ], dka[DQ], dva[DVQ];
#pragma unroll
  for (int i = 0; i < DQ; ++i) {
    kr[i] = k[kvrow * D + i * kLanes + lane];
    dka[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < DVQ; ++i) {
    vr[i] = v[kvrow * DV + i * kLanes + lane];
    dva[i] = 0.f;
  }

  // rows whose token sees a key of this block (causal: token + q_offset >= kb0)
  const long long t_first = causal ? max(0LL, (long long)kb0 - q_offset) : 0LL;
  const int r_begin = t_first < Sq ? (int)(t_first * G) : rows_total;
  for (int r0 = r_begin; r0 < rows_total; r0 += BQ) {
    const int nr = min(BQ, rows_total - r0);
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = threadIdx.x; idx < BQ * D; idx += kThreads) {
      const int i = idx / D, d = idx % D;
      qs[i][d] = i < nr ? q[(head0 + row_offset(r0 + i, G, H, 1)) * D + d] : 0.f;
    }
    for (int idx = threadIdx.x; idx < BQ * DV; idx += kThreads) {
      const int i = idx / DV, d = idx % DV;
      gs[i][d] = i < nr ? dout[(head0 + row_offset(r0 + i, G, H, 1)) * DV + d] : 0.f;
    }
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const long long off = head0 + (i < nr ? row_offset(r0 + i, G, H, 1) : 0);
      ls[i] = lse[off];
      dss[i] = dsum[off];
    }
    __syncthreads();
    for (int j = 0; j < nr; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DQ; ++i) s = fmaf(kr[i], qs[j][i * kLanes + lane], s);
#pragma unroll
      for (int i = 0; i < DVQ; ++i) dp = fmaf(vr[i], gs[j][i * kLanes + lane], dp);
      s = quad_sum(s);
      dp = quad_sum(dp);
      const bool live = !causal || key <= (long long)((r0 + j) / G) + q_offset;
      const float p = live ? expf(s * scale - ls[j]) : 0.f;
      const float ds = p * (dp - dss[j]);
#pragma unroll
      for (int i = 0; i < DVQ; ++i) dva[i] = fmaf(p, gs[j][i * kLanes + lane], dva[i]);
#pragma unroll
      for (int i = 0; i < DQ; ++i) dka[i] = fmaf(ds, qs[j][i * kLanes + lane], dka[i]);
    }
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < DQ; ++i) dk[kvrow * D + i * kLanes + lane] = dka[i] * scale;
#pragma unroll
    for (int i = 0; i < DVQ; ++i) dv[kvrow * DV + i * kLanes + lane] = dva[i];
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
struct Args {
  const void *q, *k, *v, *out, *lse, *dout;
  float* dsum;
  void *dq, *dk, *dv;
  int B, Sq, Sk, H, K;
  float scale;
  int causal, q_offset;
  cudaStream_t stream;
};

cudaError_t launch_dsum(const Args& a, int DV) {
  const long long rows = (long long)a.B * a.Sq * a.H;
  if (rows == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((rows + kDsumWarps - 1) / kDsumWarps);
  dsum_kernel<<<blocks, kDsumWarps * 32, 0, a.stream>>>(
      static_cast<const float*>(a.out), static_cast<const float*>(a.dout), a.dsum, rows, DV);
  return cudaGetLastError();
}

// fp32 stats [2][BH][Sqp] as (Sqp, BH, 2), boxes of `rows` tokens x 1 x 2
bool stats_map(CUtensorMap* m, const float* base, int Sqp, int BH, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)Sqp, (cuuint64_t)BH, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)Sqp * 4, (cuuint64_t)BH * Sqp * 4};
  const cuuint32_t box[3] = {(cuuint32_t)rows, 1, 2};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, int DVP, int W>
cudaError_t launch_wgmma(const Args& a, int D, int DV) {
  using S = WShape<DP, DVP, W>;
  bf16* dq = static_cast<bf16*>(a.dq);
  bf16* dk = static_cast<bf16*>(a.dk);
  bf16* dv = static_cast<bf16*>(a.dv);
  // no query or no key: the gradients that exist are zero
  if (a.Sq == 0 || a.Sk == 0) {
    const size_t kv_rows = (size_t)a.B * a.Sk * a.K;
    cudaMemsetAsync(dq, 0, (size_t)a.B * a.Sq * a.H * D * 2, a.stream);
    cudaMemsetAsync(dk, 0, kv_rows * D * 2, a.stream);
    cudaMemsetAsync(dv, 0, kv_rows * DV * 2, a.stream);
    return cudaGetLastError();
  }
  if (encode_tiled() == nullptr) return cudaErrorSymbolNotFound;
  const int Sqp = (a.Sq + kStatsPad - 1) / kStatsPad * kStatsPad;
  const long long rows = (long long)a.B * a.H * Sqp;
  const long long threads = rows * dsum_lanes(DV);
  dsum_lse_kernel<<<(unsigned)((threads + kDsumThreads - 1) / kDsumThreads), kDsumThreads, 0,
                    a.stream>>>(static_cast<const bf16*>(a.out), static_cast<const bf16*>(a.dout),
                                static_cast<const float*>(a.lse), a.dsum, a.Sq, Sqp, a.H, DV,
                                rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // (b): fixed K, V; walk Q, dO and their stats.  (c): fixed Q, dO and
  // their stats; walk K, V.
  Maps kv, rq;
  if (!rows_map(&kv.fixed_a, a.k, D, a.K, a.Sk, a.B, kTile) ||
      !rows_map(&kv.fixed_b, a.v, DV, a.K, a.Sk, a.B, kTile) ||
      !rows_map(&kv.walk_a, a.q, D, a.H, a.Sq, a.B, W) ||
      !rows_map(&kv.walk_b, a.dout, DV, a.H, a.Sq, a.B, W) ||
      !stats_map(&kv.stats, a.dsum, Sqp, a.B * a.H, W) ||
      !rows_map(&rq.fixed_a, a.q, D, a.H, a.Sq, a.B, kTile) ||
      !rows_map(&rq.fixed_b, a.dout, DV, a.H, a.Sq, a.B, kTile) ||
      !rows_map(&rq.walk_a, a.k, D, a.K, a.Sk, a.B, W) ||
      !rows_map(&rq.walk_b, a.v, DV, a.K, a.Sk, a.B, W) ||
      !stats_map(&rq.stats, a.dsum, Sqp, a.B * a.H, kTile))
    return cudaErrorInvalidValue;
  const Dims dims{a.B, a.Sq, a.Sk, a.H, a.K, D, DV, a.scale, a.causal, a.q_offset};

  err = cudaFuncSetAttribute(bwd_dkdv_wgmma<DP, DVP, W>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (err != cudaSuccess) return err;
  const unsigned n_kt = (unsigned)((a.Sk + kTile - 1) / kTile);
  bwd_dkdv_wgmma<DP, DVP, W><<<n_kt * a.K * a.B, kWThreads, S::kSmem, a.stream>>>(kv, dk, dv,
                                                                                   dims);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(bwd_dq_wgmma<DP, DVP, W>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (err != cudaSuccess) return err;
  const unsigned n_rt = (unsigned)((a.Sq + kTile - 1) / kTile);
  bwd_dq_wgmma<DP, DVP, W><<<n_rt * a.H * a.B, kWThreads, S::kSmem, a.stream>>>(rq, dq, dims);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t launch_simt(const Args& a) {
  // largest power-of-two tile whose fp32 operands fit 48 KB of static smem
  constexpr int BT = (D + DV) * 64 * 4 + 2 * 64 * 4 <= 48 * 1024 ? 64 : 32;
  cudaError_t err = launch_dsum(a, DV);
  if (err != cudaSuccess) return err;
  const int G = a.H / a.K;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* g = static_cast<const float*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  if (a.Sk > 0) {
    const dim3 grid((a.Sk + kRows - 1) / kRows, a.K, a.B);
    bwd_dkdv_simt<D, DV, BT><<<grid, kThreads, 0, a.stream>>>(
        q, k, v, g, lse, a.dsum, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.Sq,
        a.Sk, a.H, a.K, a.scale, a.causal, a.q_offset);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.Sq > 0) {
    const dim3 grid((a.Sq * G + kRows - 1) / kRows, a.K, a.B);
    bwd_dq_simt<D, DV, BT><<<grid, kThreads, 0, a.stream>>>(
        q, k, v, g, lse, a.dsum, static_cast<float*>(a.dq), a.Sq, a.Sk, a.H, a.K, a.scale,
        a.causal, a.q_offset);
    err = cudaGetLastError();
  }
  return err;
}

template <int D, int DV>
cudaError_t launch(const Args& a, int dtype) {
  if (dtype == 0) return launch_simt<D, DV>(a);
  // bf16: head dims padded to whole 64-column panels; walk tiles of 128
  // where the registers allow
  constexpr int DP = (D + 63) / 64 * 64, DVP = (DV + 63) / 64 * 64;
  if (dtype == 1) return launch_wgmma<DP, DVP, (DP + DVP <= 128 ? 128 : 64)>(a, D, DV);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (CUDA-core bodies), 1 = bfloat16 (TMA/wgmma bodies;
// q, k, v, out and dout 16-byte aligned).  lse: the forward's fp32
// [B, Sq, H]; dsum: fp32 scratch of 2 * B * H * Sqp floats, Sqp = Sq
// rounded up to a multiple of 128.  dq, dk, dv in the inputs' dtype; every
// element is written (dk, dv of keys no query sees are 0).  Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* lse, const void* dout,
                                   void* dsum, void* dq, void* dk, void* dv, int B, int Sq,
                                   int Sk, int H, int K, int D, int DV, float scale,
                                   int causal, int q_offset, int dtype, void* stream) {
  if (B == 0) return 0;
  if (K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  const Args a{q,  k,  v,  out, lse,   dout,  static_cast<float*>(dsum), dq,
               dk, dv, B,  Sq,  Sk,    H,     K,
               scale, causal, q_offset, static_cast<cudaStream_t>(stream)};
#define REPRO_FLASH_BWD_CASE(d, dv_) \
  if (D == d && DV == dv_) return launch<d, dv_>(a, dtype);
  // keep in step with SUPPORTED_DIMS_BWD in flash_attention.py
  REPRO_FLASH_BWD_CASE(32, 32)
  REPRO_FLASH_BWD_CASE(48, 32)
  REPRO_FLASH_BWD_CASE(64, 64)
  REPRO_FLASH_BWD_CASE(96, 96)
  REPRO_FLASH_BWD_CASE(128, 128)
  REPRO_FLASH_BWD_CASE(192, 128)
#undef REPRO_FLASH_BWD_CASE
  return cudaErrorInvalidValue;
}
