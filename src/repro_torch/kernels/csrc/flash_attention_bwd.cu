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
// Design: three launches, deterministic (no atomics: two calls give the
// same bits), not a block-by-block copy of the XLA scan.
//   (a) dsum_kernel: Dsum per (token, head), one warp per row.
//   (b) dK/dV: one block per (64-key tile, KV head, batch), 4 warps of 16
//       keys.  The K and V tiles stay in shared memory; the block walks the
//       query-row tiles at or past the causal diagonal through a 2-stage
//       cp.async ring of (Q, dO, lse, Dsum) tiles and keeps dK and dV in
//       fp32 registers.  Rows are (token, head-in-group) pairs, as in the
//       forward, so the G heads of a group are summed by the same walk.
//   (c) dQ: one block per (64-row tile, KV head, batch), the forward's
//       shape: Q and dO tiles stay in shared memory, K/V tiles stream
//       through a 2-stage ring, dQ in fp32 registers; heaviest (last,
//       under causal) tiles first.
// Each block computes the transposed products it needs (S^T = K Q^T and
// dP^T = V dO^T in (b)), so every product is an m16n8k16 mma.sync whose
// result feeds the next one from registers (P^T and dS^T as A fragments).
// (b) and (c) both recompute S and dP: seven products for the five the
// bound counts, the price of no atomics.  Why mma.sync and not wgmma/TMA:
// this is the first, simple-and-right kernel; the Hopper-only instructions
// are the redesign's work.
// fp32 takes CUDA-core bodies of the same grids (32 rows or keys per block,
// four threads each), kept for the fp32 tolerance of 1e-4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// 4 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// (a) Dsum = sum over Dv of dO * O, one warp per (b, token, head) row
// ---------------------------------------------------------------------------
constexpr int kDsumWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kDsumWarps * 32)
dsum_kernel(const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ dsum,
            long long rows, int DV) {
  const long long row = (long long)blockIdx.x * kDsumWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp leaves together
  const T* o = out + row * DV;
  const T* g = dout + row * DV;
  float acc = 0.f;
  for (int d = lane; d < DV; d += 32) acc = fmaf(to_float(o[d]), to_float(g[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dsum[row] = acc;
}

// ---------------------------------------------------------------------------
// bf16 tensor-core bodies
// ---------------------------------------------------------------------------
constexpr int kBRows = 64;   // query rows per tile
constexpr int kBKeys = 64;   // keys per tile
constexpr int kBThreads = 128;
constexpr int kBStages = 2;

template <int D, int DV>
struct BwdShape {
  static_assert(D % 16 == 0 && DV % 16 == 0, "head dims are multiples of 16");
  static constexpr int kQs = D + kPad;  // smem row strides, in elements
  static constexpr int kOs = DV + kPad;
  static constexpr int kKs = D + kPad;
  static constexpr int kVs = DV + kPad;
  static constexpr int kRowTileBytes = kBRows * (kQs + kOs) * (int)sizeof(bf16);
  static constexpr int kKeyTileBytes = kBKeys * (kKs + kVs) * (int)sizeof(bf16);
  // dK/dV: the K/V tile, then a ring of {Q, dO, lse, Dsum} row tiles
  static constexpr int kRowStageBytes = kRowTileBytes + 2 * kBRows * (int)sizeof(float);
  static constexpr int kDkvSmem = kKeyTileBytes + kBStages * kRowStageBytes;
  // dQ: the Q/dO tile, then a ring of K/V key tiles
  static constexpr int kDqSmem = kRowTileBytes + kBStages * kKeyTileBytes;
};

// c (16 x 8) += a (16 x 16) * b for the n-tiles 2j and 2j+1 of one ldsm pair
__device__ __forceinline__ void mma_pair(float (&c0)[4], float (&c1)[4],
                                         const uint32_t (&a)[4], const uint32_t (&b)[4]) {
  mma_bf16(c0, a, b[0], b[1]);
  mma_bf16(c1, a, b[2], b[3]);
}

// A fragment (rows 16, k 16) of the k-step kk from two adjacent C tiles
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// acc[16 x 64] = A[16 x KD] (rows `arow0`.. of an [.][stride_a] smem tile) *
// B^T, B the 64 rows of an [n][k] smem tile of row stride stride_b
template <int KD>
__device__ __forceinline__ void product_nt(float (&acc)[8][4], const bf16* a_tile, int stride_a,
                                           int arow0, const bf16* b_tile, int stride_b,
                                           int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_tile + (arow0 + lane % 16) * stride_a + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, b_tile + (np * 16 + (lane / 16) * 8 + lane % 8) * stride_b + kk * 16 +
                     ((lane / 8) % 2) * 8);
      mma_pair(acc[2 * np], acc[2 * np + 1], a, b);
    }
  }
}

// out[16 x N] += P[16 x 64] (C fragments, rounded to bf16) * T, T the 64
// rows of a [k][n] smem tile of row stride stride_t
template <int N>
__device__ __forceinline__ void product_cn(float (&out)[N / 8][4], const float (&p)[8][4],
                                           const bf16* t_tile, int stride_t, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    c_to_a(a, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int dp = 0; dp < N / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, t_tile + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * stride_t +
                           dp * 16 + (lane / 16) * 8);
      mma_pair(out[2 * dp], out[2 * dp + 1], a, b);
    }
  }
}

// (b) dK, dV for one 64-key tile of one KV head
template <int D, int DV>
__global__ void __launch_bounds__(kBThreads)
bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dsum,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int H, int K,
            float scale, int causal, int q_offset) {
  using S = BwdShape<D, DV>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kBKeys][kKs]
  bf16* vs = ks + kBKeys * S::kKs;               // [kBKeys][kVs]
  unsigned char* ring = smem_raw + S::kKeyTileBytes;

  const int G = H / K;
  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int k0 = blockIdx.x * kBKeys;
  const int rows_total = Sq * G;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tid = threadIdx.x;

  const long long head0 = (long long)b * Sq * H + (long long)kh * G;
  const bf16* qb = q + head0 * D;
  const bf16* ob = dout + head0 * DV;
  const float* lb = lse + head0;
  const float* db = dsum + head0;
  const long long kv_step_k = (long long)K * D;
  const long long kv_step_v = (long long)K * DV;
  const bf16* kb = k + ((long long)b * Sk * K + kh) * D;
  const bf16* vb = v + ((long long)b * Sk * K + kh) * DV;

  // the row tiles whose tokens see a key of this tile (causal: token + q_offset >= k0)
  const long long t_first = causal ? max(0LL, (long long)k0 - q_offset) : 0LL;
  const int n_row_tiles = (rows_total + kBRows - 1) / kBRows;
  const int rt_begin = t_first < Sq ? (int)(t_first * G / kBRows) : n_row_tiles;
  const int n_rt = n_row_tiles - rt_begin;

  // the K/V tile (keys past Sk zero-filled), in the first copy group
  for (int c = tid; c < kBKeys * (D / 8); c += kBThreads) {
    const int j = c / (D / 8), col = (c % (D / 8)) * 8;
    const bool ok = k0 + j < Sk;
    cp_async16(ks + j * S::kKs + col, ok ? kb + (k0 + j) * kv_step_k + col : kb, ok);
  }
  for (int c = tid; c < kBKeys * (DV / 8); c += kBThreads) {
    const int j = c / (DV / 8), col = (c % (DV / 8)) * 8;
    const bool ok = k0 + j < Sk;
    cp_async16(vs + j * S::kVs + col, ok ? vb + (k0 + j) * kv_step_v + col : vb, ok);
  }
  auto q_of = [&](int st) { return reinterpret_cast<bf16*>(ring + st * S::kRowStageBytes); };
  auto o_of = [&](int st) { return q_of(st) + kBRows * S::kQs; };
  auto l_of = [&](int st) { return reinterpret_cast<float*>(o_of(st) + kBRows * S::kOs); };
  auto d_of = [&](int st) { return l_of(st) + kBRows; };
  auto load_rows = [&](int tile, int st) {
    const int r0 = tile * kBRows;
    bf16* qd = q_of(st);
    bf16* od = o_of(st);
    for (int c = tid; c < kBRows * (D / 8); c += kBThreads) {
      const int i = c / (D / 8), col = (c % (D / 8)) * 8;
      const bool ok = r0 + i < rows_total;
      cp_async16(qd + i * S::kQs + col, ok ? qb + row_offset(r0 + i, G, H, D) + col : qb, ok);
    }
    for (int c = tid; c < kBRows * (DV / 8); c += kBThreads) {
      const int i = c / (DV / 8), col = (c % (DV / 8)) * 8;
      const bool ok = r0 + i < rows_total;
      cp_async16(od + i * S::kOs + col, ok ? ob + row_offset(r0 + i, G, H, DV) + col : ob,
                 ok);
    }
    for (int i = tid; i < kBRows; i += kBThreads) {
      const bool ok = r0 + i < rows_total;
      const long long off = ok ? row_offset(r0 + i, G, H, 1) : 0;
      cp_async4(l_of(st) + i, lb + off, ok);
      cp_async4(d_of(st) + i, db + off, ok);
    }
  };
#pragma unroll
  for (int t = 0; t < kBStages - 1; ++t) {
    if (t < n_rt) load_rows(rt_begin + t, t);
    cp_async_commit();
  }

  float dka[D / 8][4], dva[DV / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  const float sl2 = scale * kLog2e;
  const int key_lo = k0 + warp * 16 + lane / 4;  // this thread's keys: key_lo, key_lo + 8

  for (int it = 0; it < n_rt; ++it) {
    const int ahead = it + kBStages - 1;
    if (ahead < n_rt) load_rows(rt_begin + ahead, ahead % kBStages);
    cp_async_commit();
    cp_async_wait<kBStages - 1>();
    __syncthreads();
    const int st = it % kBStages;
    const bf16* qt = q_of(st);
    const bf16* ot = o_of(st);
    const float* lt = l_of(st);
    const float* dt = d_of(st);
    const int r0 = (rt_begin + it) * kBRows;

    // P^T = exp(K Q^T * scale - lse): 16 keys x 64 rows per warp
    float p[8][4];
    product_nt<D>(p, ks, S::kKs, warp * 16, qt, S::kQs, lane);
    const bool need_mask = r0 + kBRows > rows_total ||
                           (causal && (long long)(r0 / G) + q_offset < k0 + kBKeys - 1);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = n * 8 + (lane % 4) * 2 + (e & 1);
        float x = p[n][e] * sl2 - lt[rl] * kLog2e;
        if (need_mask) {
          const int r = r0 + rl;
          const bool live = r < rows_total &&
                            (!causal || key_lo + 8 * (e >> 1) <= (long long)(r / G) + q_offset);
          x = live ? x : -INFINITY;
        }
        p[n][e] = exp2f(x);
      }
    }
    // dV += P^T dO
    product_cn<DV>(dva, p, ot, S::kOs, lane);
    // dS^T = P^T * (V dO^T - Dsum)
    float ds[8][4];
    product_nt<DV>(ds, vs, S::kVs, warp * 16, ot, S::kOs, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = n * 8 + (lane % 4) * 2 + (e & 1);
        ds[n][e] = p[n][e] * (ds[n][e] - dt[rl]);
      }
    }
    // dK += dS^T Q
    product_cn<D>(dka, ds, qt, S::kQs, lane);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key_lo + 8 * h;
    if (key < Sk) {
      bf16* kp = dk + ((long long)b * Sk * K + (long long)key * K + kh) * D + (lane % 4) * 2;
      bf16* vp = dv + ((long long)b * Sk * K + (long long)key * K + kh) * DV + (lane % 4) * 2;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(kp + n * 8) =
            pack_bf16(dka[n][2 * h] * scale, dka[n][2 * h + 1] * scale);
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
        *reinterpret_cast<uint32_t*>(vp + n * 8) = pack_bf16(dva[n][2 * h], dva[n][2 * h + 1]);
    }
  }
}

// (c) dQ for one 64-row tile of one KV head
template <int D, int DV>
__global__ void __launch_bounds__(kBThreads)
bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ dsum, bf16* __restrict__ dq, int Sq, int Sk, int H, int K,
          float scale, int causal, int q_offset) {
  using S = BwdShape<D, DV>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kBRows][kQs]
  bf16* os = qs + kBRows * S::kQs;               // [kBRows][kOs]
  unsigned char* ring = smem_raw + S::kRowTileBytes;

  const int G = H / K;
  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int rows_total = Sq * G;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kBRows;  // causal: heaviest tiles first
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tid = threadIdx.x;

  const long long head0 = (long long)b * Sq * H + (long long)kh * G;
  const bf16* qb = q + head0 * D;
  const bf16* ob = dout + head0 * DV;
  const long long kv_step_k = (long long)K * D;
  const long long kv_step_v = (long long)K * DV;
  const bf16* kb = k + ((long long)b * Sk * K + kh) * D;
  const bf16* vb = v + ((long long)b * Sk * K + kh) * DV;

  const int r_last = min(r0 + kBRows, rows_total) - 1;
  int k_end = Sk;
  if (causal) {
    const long long q_last = (long long)(r_last / G) + q_offset;
    k_end = (int)min((long long)Sk, q_last + 1 > 0 ? q_last + 1 : 0LL);
  }
  const int n_tiles = (k_end + kBKeys - 1) / kBKeys;
  const long long q_first = (long long)(r0 / G) + q_offset;

  // the Q and dO tiles (rows past rows_total zero-filled), in the first group
  for (int c = tid; c < kBRows * (D / 8); c += kBThreads) {
    const int i = c / (D / 8), col = (c % (D / 8)) * 8;
    const bool ok = r0 + i < rows_total;
    cp_async16(qs + i * S::kQs + col, ok ? qb + row_offset(r0 + i, G, H, D) + col : qb, ok);
  }
  for (int c = tid; c < kBRows * (DV / 8); c += kBThreads) {
    const int i = c / (DV / 8), col = (c % (DV / 8)) * 8;
    const bool ok = r0 + i < rows_total;
    cp_async16(os + i * S::kOs + col, ok ? ob + row_offset(r0 + i, G, H, DV) + col : ob, ok);
  }
  auto k_of = [&](int st) { return reinterpret_cast<bf16*>(ring + st * S::kKeyTileBytes); };
  auto v_of = [&](int st) { return k_of(st) + kBKeys * S::kKs; };
  auto load_keys = [&](int tile, int st) {
    const int kt0 = tile * kBKeys;
    bf16* kd = k_of(st);
    bf16* vd = v_of(st);
    for (int c = tid; c < kBKeys * (D / 8); c += kBThreads) {
      const int j = c / (D / 8), col = (c % (D / 8)) * 8;
      const bool ok = kt0 + j < Sk;
      cp_async16(kd + j * S::kKs + col, ok ? kb + (kt0 + j) * kv_step_k + col : kb, ok);
    }
    for (int c = tid; c < kBKeys * (DV / 8); c += kBThreads) {
      const int j = c / (DV / 8), col = (c % (DV / 8)) * 8;
      const bool ok = kt0 + j < Sk;
      cp_async16(vd + j * S::kVs + col, ok ? vb + (kt0 + j) * kv_step_v + col : vb, ok);
    }
  };
#pragma unroll
  for (int t = 0; t < kBStages - 1; ++t) {
    if (t < n_tiles) load_keys(t, t);
    cp_async_commit();
  }

  // this thread's two rows: lane / 4 and lane / 4 + 8 of the warp's 16
  long long qpos[2];
  float lse2[2], dsm[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = min(r0 + warp * 16 + lane / 4 + 8 * h, rows_total - 1);
    qpos[h] = (long long)(r / G) + q_offset;
    lse2[h] = lse[head0 + row_offset(r, G, H, 1)] * kLog2e;
    dsm[h] = dsum[head0 + row_offset(r, G, H, 1)];
  }
  float dqa[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
  const float sl2 = scale * kLog2e;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int ahead = tile + kBStages - 1;
    if (ahead < n_tiles) load_keys(ahead, ahead % kBStages);
    cp_async_commit();
    cp_async_wait<kBStages - 1>();
    __syncthreads();
    const bf16* kt = k_of(tile % kBStages);
    const bf16* vt = v_of(tile % kBStages);
    const int k0 = tile * kBKeys;

    // P = exp(Q K^T * scale - lse): 16 rows x 64 keys per warp
    float p[8][4];
    product_nt<D>(p, qs, S::kQs, warp * 16, kt, S::kKs, lane);
    const bool need_mask = k0 + kBKeys > Sk || (causal && k0 + kBKeys - 1 > q_first);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = p[n][e] * sl2 - lse2[e >> 1];
        if (need_mask) {
          const int key = k0 + n * 8 + (lane % 4) * 2 + (e & 1);
          const bool live = key < Sk && (!causal || key <= qpos[e >> 1]);
          x = live ? x : -INFINITY;
        }
        p[n][e] = exp2f(x);
      }
    }
    // dS = P * (dO V^T - Dsum)
    float ds[8][4];
    product_nt<DV>(ds, os, S::kOs, warp * 16, vt, S::kVs, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[n][e] = p[n][e] * (ds[n][e] - dsm[e >> 1]);
    }
    // dQ += dS K
    product_cn<D>(dqa, ds, kt, S::kKs, lane);
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + warp * 16 + lane / 4 + 8 * h;
    if (r < rows_total) {
      bf16* qp = dq + head0 * D + row_offset(r, G, H, D) + (lane % 4) * 2;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(qp + n * 8) =
            pack_bf16(dqa[n][2 * h] * scale, dqa[n][2 * h + 1] * scale);
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

template <typename T>
cudaError_t launch_dsum(const Args& a, int DV) {
  const long long rows = (long long)a.B * a.Sq * a.H;
  if (rows == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((rows + kDsumWarps - 1) / kDsumWarps);
  dsum_kernel<T><<<blocks, kDsumWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.out), static_cast<const T*>(a.dout), a.dsum, rows, DV);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t launch_tc(const Args& a) {
  using S = BwdShape<D, DV>;
  cudaError_t err = launch_dsum<bf16>(a, DV);
  if (err != cudaSuccess) return err;
  const int G = a.H / a.K;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* g = static_cast<const bf16*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  if (a.Sk > 0) {
    err = cudaFuncSetAttribute(bwd_dkdv_tc<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               S::kDkvSmem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sk + kBKeys - 1) / kBKeys, a.K, a.B);
    bwd_dkdv_tc<D, DV><<<grid, kBThreads, S::kDkvSmem, a.stream>>>(
        q, k, v, g, lse, a.dsum, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.Sq,
        a.Sk, a.H, a.K, a.scale, a.causal, a.q_offset);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.Sq > 0) {
    err = cudaFuncSetAttribute(bwd_dq_tc<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               S::kDqSmem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sq * G + kBRows - 1) / kBRows, a.K, a.B);
    bwd_dq_tc<D, DV><<<grid, kBThreads, S::kDqSmem, a.stream>>>(
        q, k, v, g, lse, a.dsum, static_cast<bf16*>(a.dq), a.Sq, a.Sk, a.H, a.K, a.scale,
        a.causal, a.q_offset);
    err = cudaGetLastError();
  }
  return err;
}

template <int D, int DV>
cudaError_t launch_simt(const Args& a) {
  // largest power-of-two tile whose fp32 operands fit 48 KB of static smem
  constexpr int BT = (D + DV) * 64 * 4 + 2 * 64 * 4 <= 48 * 1024 ? 64 : 32;
  cudaError_t err = launch_dsum<float>(a, DV);
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
  if (dtype == 1) return launch_tc<D, DV>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (CUDA-core bodies), 1 = bfloat16 (tensor-core bodies;
// q, k, v, out and dout 16-byte aligned).  lse: the forward's fp32
// [B, Sq, H]; dsum: fp32 [B, Sq, H] scratch.  dq, dk, dv in the inputs'
// dtype; every element is written (dk, dv of keys no query sees are 0).
// Returns cudaGetLastError() after the launches (0 on success).
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
  // keep in step with SUPPORTED_DIMS in flash_attention.py
  REPRO_FLASH_BWD_CASE(32, 32)
  REPRO_FLASH_BWD_CASE(48, 32)
  REPRO_FLASH_BWD_CASE(64, 64)
  REPRO_FLASH_BWD_CASE(128, 128)
#undef REPRO_FLASH_BWD_CASE
  return cudaErrorInvalidValue;
}
