// GQA flash attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (Pallas; body `_kernel`).  Same contract: q [B,Sq,H,D], k [B,Sk,K,D],
// v [B,Sk,K,Dv] -> out [B,Sq,H,Dv], causal or full, KV head = h / G, scalar
// q_offset shifts the causal diagonal, fp32 online softmax, a row with no
// live key outputs 0.  Optionally (training) it also writes each row's
// log-sum-exp, fp32 [B,Sq,H], from the running max and sum it keeps anyway:
// the residual csrc/flash_attention_bwd.cu recomputes the probabilities
// from, as repro/kernels/xla_flash.py::_vjp_fwd saves it.  Superset of the
// Pallas contract: Sq and Sk need not divide any tile; ragged tails are
// masked in-kernel and nothing is copied.
//
// What bounds it on this card: at prefill lengths attention does
// O(S^2 * (D + Dv)) work on O(S * (D + Dv)) bytes, so at long S it is bound
// by operations; at the prefill the port serves ([4, 256], 0.5 GFLOP) the
// whole call is a few microseconds, so latency (load round trips,
// instruction count) bounds it before either rate does.
//
// Rows: a row is a (token, head-in-group) pair.  The G query heads that
// share a KV head are flattened into the row axis (row r is token r / G,
// head kh*G + r % G), so each K/V tile is read once per KV head and serves
// all G heads, never replicated; G = 3 for smollm is no obstacle because
// rows are not tied to a power of two.  The G rows of one token are
// contiguous in q and out.
//
// Two bodies, chosen by dtype:
//
// bf16, tensor cores (`flash_tc_kernel`):
//   * One block per (batch, kv head, tile of 64 rows); 4 warps, 16 rows
//     each.
//   * The Q tile is staged once in shared memory with 16-byte `cp.async`
//     and kept in registers as `ldmatrix` A-fragments.
//   * K and V tiles of 64 keys stay bf16 in shared memory, in a `cp.async`
//     ring (commit_group / wait_group) of 4 stages (2 at D >= 96, where
//     shared memory is short): the next tiles' copies are in flight while
//     this tile's math runs, and a block of the port's prefill has all its
//     tiles in flight from the start.  Rows are padded by 16 bytes so that
//     `ldmatrix`'s eight row addresses fall in distinct banks.
//   * Q.K^T and P.V are `mma.sync.m16n8k16` bf16 x bf16 -> fp32 (`ldmatrix`
//     for K, `ldmatrix.trans` for V); the accumulators stay in registers.
//   * P goes straight from the Q.K^T accumulators into the P.V
//     A-fragments (the m16n8 C layout of two adjacent key tiles is the
//     m16k16 A layout), so it never goes through shared memory.  It goes
//     as two bf16 fragments, P's rounding and what that rounding left
//     over, each multiplied by the same V fragments: P rounded to bf16
//     alone moved full-width prefill logits past the 5e-2 bound.
//   * Online softmax in fp32, in the log2 domain; a row's max and sum are
//     finished with two shuffles inside the quad that holds the row.
//   * Causal: tiles wholly above the block's last row are never loaded; the
//     mask is applied only on tiles that cross the diagonal or the ragged
//     Sk tail (out-of-range K/V rows are zero-filled by the copy).
//   Why `mma.sync` + `cp.async` and not `wgmma` + TMA: at the port's
//   prefill sizes the call is bound by latency, not by the tensor-core
//   rate; `mma.sync` reaches the tensor cores without `wgmma`'s
//   shared-memory descriptors and warpgroup synchronisation, and `cp.async`
//   needs no `mbarrier`.  `wgmma` is the path for long sequences.
//
// fp32, CUDA cores (`flash_simt_kernel`): the first port's body, kept for
// fp32 inputs, which are not on the serving path (a TF32 tensor-core body
// would miss the fp32 tolerance of 1e-4).  One block per 32 rows, four
// threads per row each holding a quarter of the head dims; K/V tiles staged
// in shared memory as fp32; the same causal skip and masking.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16 tensor-core body
// ---------------------------------------------------------------------------
constexpr int kTcRows = 64;     // flattened rows per block
constexpr int kTcKeys = 64;     // keys per K/V tile
constexpr int kTcWarps = 4;     // 16 rows each
constexpr int kTcThreads = kTcWarps * 32;

template <int D, int DV>
struct TcShape {
  static_assert(D % 16 == 0 && DV % 16 == 0, "head dims are multiples of 16");
  static constexpr int kQs = D + kPad;    // smem row strides, in elements
  static constexpr int kKs = D + kPad;
  static constexpr int kVs = DV + kPad;
  static constexpr int kQElems = kTcRows * kQs;
  static constexpr int kKElems = kTcKeys * kKs;
  static constexpr int kVElems = kTcKeys * kVs;
  // K/V ring depth: 4 tiles (256 keys in flight) while two blocks still fit
  // an SM, else 2
  static constexpr int kStageBytes = (kKElems + kVElems) * (int)sizeof(__nv_bfloat16);
  static constexpr int kQBytes = kQElems * (int)sizeof(__nv_bfloat16);
  static constexpr int kStages = kQBytes + 4 * kStageBytes <= 100 * 1024 ? 4 : 2;
  static constexpr int kSmemBytes = kQBytes + kStages * kStageBytes;
};

template <int D, int DV>
__global__ void __launch_bounds__(kTcThreads)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                float* __restrict__ lse, int Sq, int Sk, int H, int K, float scale,
                int causal, int q_offset) {
  using S = TcShape<D, DV>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + S::kQElems;              // [kStages][kTcKeys][kKs]
  __nv_bfloat16* vs = ks + S::kStages * S::kKElems; // [kStages][kTcKeys][kVs]

  const int G = H / K;
  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int rows_total = Sq * G;
  const int r0 = blockIdx.x * kTcRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tid = threadIdx.x;

  const long long head0 = ((long long)b * Sq * H + (long long)kh * G);
  const __nv_bfloat16* qb = q + head0 * D;
  __nv_bfloat16* ob = out + head0 * DV;
  const long long k_step = (long long)K * D;          // elements between keys
  const long long v_step = (long long)K * DV;
  const __nv_bfloat16* kb = k + ((long long)b * Sk * K + kh) * D;
  const __nv_bfloat16* vb = v + ((long long)b * Sk * K + kh) * DV;

  // keys past the block's last query position are never live (causal)
  const int r_last = min(r0 + kTcRows, rows_total) - 1;
  int k_end = Sk;
  if (causal) {
    const long long q_last = (long long)(r_last / G) + q_offset;
    k_end = (int)min((long long)Sk, q_last + 1 > 0 ? q_last + 1 : 0LL);
  }
  const int n_tiles = (k_end + kTcKeys - 1) / kTcKeys;
  const long long q_first = (long long)(r0 / G) + q_offset;

  // stage the Q tile (rows past rows_total are zero-filled)
  {
    constexpr int kChunks = D / 8;  // 16-byte pieces per row
    for (int c = tid; c < kTcRows * kChunks; c += kTcThreads) {
      const int i = c / kChunks, col = (c % kChunks) * 8;
      const int r = r0 + i;
      const bool ok = r < rows_total;
      const __nv_bfloat16* src = ok ? qb + row_offset(r, G, H, D) + col : qb;
      cp_async16(qs + i * S::kQs + col, src, ok);
    }
  }
  auto load_tile = [&](int tile, int stage) {
    const int k0 = tile * kTcKeys;
    constexpr int kKc = D / 8, kVc = DV / 8;
    __nv_bfloat16* kd = ks + stage * S::kKElems;
    __nv_bfloat16* vd = vs + stage * S::kVElems;
    for (int c = tid; c < kTcKeys * kKc; c += kTcThreads) {
      const int j = c / kKc, col = (c % kKc) * 8;
      const bool ok = k0 + j < Sk;
      cp_async16(kd + j * S::kKs + col, ok ? kb + (k0 + j) * k_step + col : kb,
                 ok);
    }
    for (int c = tid; c < kTcKeys * kVc; c += kTcThreads) {
      const int j = c / kVc, col = (c % kVc) * 8;
      const bool ok = k0 + j < Sk;
      cp_async16(vd + j * S::kVs + col,
                 ok ? vb + (k0 + j) * v_step + col : vb, ok);
    }
  };
  // prologue: Q with tile 0, then tiles 1 .. kStages-2, one group each
#pragma unroll
  for (int t = 0; t < S::kStages - 1; ++t) {
    if (t < n_tiles) load_tile(t, t);
    cp_async_commit();
  }

  // this thread's two rows within the warp's 16: lane/4 and lane/4 + 8
  const int row_in_warp = lane / 4;
  long long qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = min(r0 + warp * 16 + row_in_warp + 8 * h, rows_total - 1);
    qpos[h] = (long long)(r / G) + q_offset;
  }

  uint32_t qf[D / 16][4];
  float o[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  const float sl2 = scale * kLog2e;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int ahead = tile + S::kStages - 1;  // refills the stage freed last round
    if (ahead < n_tiles) load_tile(ahead, ahead % S::kStages);
    cp_async_commit();
    cp_async_wait<S::kStages - 1>();  // all but the newest groups: this tile (and Q)
    __syncthreads();
    if (tile == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qf[kk], qs + (warp * 16 + (lane % 16)) * S::kQs + kk * 16 + (lane / 16) * 8);
    }
    const __nv_bfloat16* kt = ks + (tile % S::kStages) * S::kKElems;
    const __nv_bfloat16* vt = vs + (tile % S::kStages) * S::kVElems;
    const int k0 = tile * kTcKeys;

    // S = Q K^T: 16 rows x 64 keys per warp, eight m16n8 accumulators
    float s[kTcKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kTcKeys / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kTcKeys / 16; ++np) {
        uint32_t bf[4];  // keys np*16 + [0,8) and [8,16), dims kk*16 + [0,16)
        ldsm_x4(bf, kt + (np * 16 + (lane / 16) * 8 + lane % 8) * S::kKs + kk * 16 +
                        ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // scale into the log2 domain; mask only where the tile crosses the
    // diagonal or the ragged end of the keys
    const bool need_mask = k0 + kTcKeys > Sk || (causal && k0 + kTcKeys - 1 > q_first);
#pragma unroll
    for (int n = 0; n < kTcKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (need_mask) {
          const int key = k0 + n * 8 + (lane % 4) * 2 + (e & 1);
          const bool live = key < Sk && (!causal || key <= qpos[e >> 1]);
          x = live ? x : -INFINITY;
        }
        s[n][e] = x;
      }
    }

    // online softmax, per row half h (elements 2h, 2h+1 of each accumulator)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < kTcKeys / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no live key yet
      const float alpha = exp2f(m[h] - m_use);               // 0 on the first live tile
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kTcKeys / 8; ++n) {
        const float p0 = exp2f(s[n][2 * h] - m_use);         // 0 where masked
        const float p1 = exp2f(s[n][2 * h + 1] - m_use);
        s[n][2 * h] = p0;
        s[n][2 * h + 1] = p1;
        sum += p0 + p1;
      }
      l[h] = l[h] * alpha + sum;  // this thread's columns; summed over the quad at the end
      m[h] = m_new;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        o[n][2 * h] *= alpha;
        o[n][2 * h + 1] *= alpha;
      }
    }

    // O += P V: P's A-fragments come straight from the S accumulators, as
    // a bf16 head and tail
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk) {
      uint32_t a[4], at[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], a[0], at[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], a[1], at[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], a[2], at[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], a[3], at[3]);
#pragma unroll
      for (int dp = 0; dp < DV / 16; ++dp) {
        uint32_t bf[4];  // keys kk*16 + [0,16), dims dp*16 + [0,8) and [8,16)
        ldsm_x4_trans(bf, vt + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * S::kVs +
                              dp * 16 + (lane / 16) * 8);
        mma_bf16(o[2 * dp], a, bf[0], bf[1]);
        mma_bf16(o[2 * dp + 1], a, bf[2], bf[3]);
        mma_bf16(o[2 * dp], at, bf[0], bf[1]);
        mma_bf16(o[2 * dp + 1], at, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    const int r = r0 + warp * 16 + row_in_warp + 8 * h;
    if (r < rows_total) {
      // natural-log lse from the log2-domain running max and sum; a row
      // with no live key gets 0 (its l is taken as 1, as the reference does)
      if (lse != nullptr && lane % 4 == 0)
        lse[head0 + row_offset(r, G, H, 1)] =
            sum > 0.f ? (m[h] + log2f(sum)) * kLn2 : 0.f;
      __nv_bfloat16* op = ob + row_offset(r, G, H, DV) + (lane % 4) * 2;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
        *reinterpret_cast<uint32_t*>(op + n * 8) =
            pack_bf16(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
    }
  }
}

template <int D, int DV>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, float* lse,
                      int B, int Sq, int Sk, int H, int K, float scale, int causal,
                      int q_offset, cudaStream_t stream) {
  constexpr int kSmem = TcShape<D, DV>::kSmemBytes;
  if (kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
  }
  const int G = H / K;
  const dim3 grid((Sq * G + kTcRows - 1) / kTcRows, K, B);
  flash_tc_kernel<D, DV><<<grid, kTcThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, Sq,
      Sk, H, K, scale, causal, q_offset);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 CUDA-core body
// ---------------------------------------------------------------------------
constexpr int kRows = 32;   // flattened (token, head-in-group) rows per block
constexpr int kLanes = 4;   // threads that share one row
constexpr int kThreads = kRows * kLanes;

template <int D, int DV, int BK>
__global__ void __launch_bounds__(kThreads)
flash_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ lse, int Sq, int Sk, int H, int K, float scale,
                  int causal, int q_offset) {
  static_assert(D % kLanes == 0 && DV % kLanes == 0, "head dims split by 4");
  constexpr int DQ = D / kLanes;
  constexpr int DVQ = DV / kLanes;
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][DV];

  const int G = H / K;
  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int rows_total = Sq * G;
  const int r0 = blockIdx.x * kRows;
  const int row = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int r = r0 + row;
  const bool active = r < rows_total;
  const int rr = active ? r : rows_total - 1;  // inactive rows compute, never store
  const int t = rr / G;
  const int h = kh * G + rr % G;
  const long long qpos = (long long)t + q_offset;

  float qr[DQ];
  const float* qp = q + (((long long)b * Sq + t) * H + h) * D;
#pragma unroll
  for (int i = 0; i < DQ; ++i) qr[i] = qp[i * kLanes + lane];

  float acc[DVQ];
#pragma unroll
  for (int i = 0; i < DVQ; ++i) acc[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  // keys past the block's last query position are never live (causal)
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
      const int kp = k0 + j;
      ks[j][d] = kp < Sk ? k[(((long long)b * Sk + kp) * K + kh) * D + d] : 0.f;
    }
    for (int idx = threadIdx.x; idx < BK * DV; idx += kThreads) {
      const int j = idx / DV, d = idx % DV;
      const int kp = k0 + j;
      vs[j][d] = kp < Sk ? v[(((long long)b * Sk + kp) * K + kh) * DV + d] : 0.f;
    }
    __syncthreads();

    float s[BK];
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DQ; ++i) part = fmaf(qr[i], ks[j][i * kLanes + lane], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kp = k0 + j;
      const bool live = kp < Sk && (!causal || kp <= qpos);
      s[j] = live ? part * scale : -INFINITY;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    if (m_new == -INFINITY) continue;  // no live key for this row yet
    const float alpha = expf(m - m_new);  // 0 on the first live tile
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DVQ; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);  // 0 where masked
      l += p;
#pragma unroll
      for (int i = 0; i < DVQ; ++i) acc[i] = fmaf(p, vs[j][i * kLanes + lane], acc[i]);
    }
    m = m_new;
  }

  if (active) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    if (lse != nullptr && lane == 0)
      lse[((long long)b * Sq + t) * H + h] = l > 0.f ? m + logf(l) : 0.f;
    float* op = out + (((long long)b * Sq + t) * H + h) * DV;
#pragma unroll
    for (int i = 0; i < DVQ; ++i) op[i * kLanes + lane] = acc[i] * inv;
  }
}

template <int D, int DV>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* out,
                        float* lse, int B, int Sq, int Sk, int H, int K, float scale,
                        int causal, int q_offset, cudaStream_t stream) {
  // largest power-of-two KV tile whose fp32 K and V fit 48 KB of static smem
  constexpr int BK = (D + DV) * 64 * 4 <= 48 * 1024 ? 64 : 32;
  const int G = H / K;
  const dim3 grid((Sq * G + kRows - 1) / kRows, K, B);
  flash_simt_kernel<D, DV, BK><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, Sq, Sk, H, K, scale,
      causal, q_offset);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   int B, int Sq, int Sk, int H, int K, float scale, int causal,
                   int q_offset, int dtype, cudaStream_t stream) {
  if (dtype == 0)
    return launch_simt<D, DV>(q, k, v, out, lse, B, Sq, Sk, H, K, scale, causal,
                              q_offset, stream);
  if (dtype == 1)
    return launch_tc<D, DV>(q, k, v, out, lse, B, Sq, Sk, H, K, scale, causal,
                            q_offset, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (CUDA-core body), 1 = bfloat16 (tensor-core body; q,
// k, v and out 16-byte aligned).  lse: null, or fp32 [B, Sq, H] that gets
// each row's natural-log log-sum-exp of its scaled scores (the residual of
// the backward, csrc/flash_attention_bwd.cu).  Returns cudaGetLastError()
// after the launch (0 on success); an empty problem launches nothing.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* lse, int B, int Sq, int Sk, int H,
                                   int K, int D, int DV, float scale, int causal,
                                   int q_offset, int dtype, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_CASE(d, dv)                                                       \
  if (D == d && DV == dv)                                                             \
    return launch<d, dv>(q, k, v, out, static_cast<float*>(lse), B, Sq, Sk, H, K, scale, \
                         causal, q_offset, dtype, s);
  // keep in step with SUPPORTED_DIMS in flash_attention.py
  REPRO_FLASH_CASE(32, 32)
  REPRO_FLASH_CASE(48, 32)
  REPRO_FLASH_CASE(64, 64)
  REPRO_FLASH_CASE(96, 96)
  REPRO_FLASH_CASE(128, 128)
  REPRO_FLASH_CASE(192, 128)
#undef REPRO_FLASH_CASE
  return cudaErrorInvalidValue;
}
