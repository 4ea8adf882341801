// GQA flash attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (Pallas; body `_kernel`).  Same contract: q [B,Sq,H,D], k [B,Sk,K,D],
// v [B,Sk,K,Dv] -> out [B,Sq,H,Dv], causal or full, KV head = h / G, scalar
// q_offset shifts the causal diagonal, fp32 online softmax, a row with no
// live key outputs 0.  Superset of the Pallas contract: Sq and Sk need not
// divide any tile; ragged tails are masked in-kernel and nothing is copied.
//
// What bounds it on this card: at prefill lengths attention does
// O(S^2 * (D + Dv)) work on O(S * (D + Dv)) bytes, so it is bound by
// operations.  This first version computes in fp32 on the CUDA cores
// (no wgmma, no TMA, no pipelining), so it is far from the bf16 tensor-core
// peak; making it fast is later work.
//
// Design:
//   * One block per (batch, kv head, tile of 32 query rows), where a row is
//     a (token, head-in-group) pair: the G query heads that share a KV head
//     are flattened into the row axis, so each K/V tile is read once per KV
//     head and serves all G heads (never replicated; G = 3 for smollm is no
//     obstacle because rows are not tied to a power of two).
//   * Four threads own one row, each holding a quarter of the head dims
//     (dim d = 4*i + lane) of q and of the fp32 accumulator; a dot product
//     is finished with two shuffles inside the quad.
//   * The KV axis, a sequential "arbitrary" grid axis on the TPU, is a loop
//     inside the block: K/V tiles of BK rows are staged in shared memory as
//     fp32, and the online softmax state (m, l, acc) stays in registers.
//   * Causal: tiles wholly above the block's last query are never loaded;
//     partial tiles and the ragged Sk tail are masked per element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kRows = 32;   // flattened (token, head-in-group) rows per block
constexpr int kLanes = 4;   // threads that share one row
constexpr int kThreads = kRows * kLanes;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D, int DV, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
                 int H, int K, float scale, int causal, int q_offset) {
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
  const T* qp = q + (((long long)b * Sq + t) * H + h) * D;
#pragma unroll
  for (int i = 0; i < DQ; ++i) qr[i] = to_f32(qp[i * kLanes + lane]);

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
      ks[j][d] = kp < Sk ? to_f32(k[(((long long)b * Sk + kp) * K + kh) * D + d]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < BK * DV; idx += kThreads) {
      const int j = idx / DV, d = idx % DV;
      const int kp = k0 + j;
      vs[j][d] = kp < Sk ? to_f32(v[(((long long)b * Sk + kp) * K + kh) * DV + d]) : 0.f;
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
    T* op = out + (((long long)b * Sq + t) * H + h) * DV;
#pragma unroll
    for (int i = 0; i < DVQ; ++i) op[i * kLanes + lane] = from_f32<T>(acc[i] * inv);
  }
}

template <typename T, int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B,
                   int Sq, int Sk, int H, int K, float scale, int causal,
                   int q_offset, cudaStream_t stream) {
  // largest power-of-two KV tile whose fp32 K and V fit 48 KB of static smem
  constexpr int BK = (D + DV) * 64 * 4 <= 48 * 1024 ? 64 : 32;
  const int G = H / K;
  const dim3 grid((Sq * G + kRows - 1) / kRows, K, B);
  flash_fwd_kernel<T, D, DV, BK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, H, K, scale, causal, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int B,
                     int Sq, int Sk, int H, int K, int D, int DV, float scale,
                     int causal, int q_offset, cudaStream_t stream) {
#define REPRO_FLASH_CASE(d, dv)                                                   \
  if (D == d && DV == dv)                                                         \
    return launch<T, d, dv>(q, k, v, out, B, Sq, Sk, H, K, scale, causal, q_offset, \
                            stream);
  // keep in step with SUPPORTED_DIMS in flash_attention.py
  REPRO_FLASH_CASE(32, 32)
  REPRO_FLASH_CASE(48, 32)
  REPRO_FLASH_CASE(64, 64)
  REPRO_FLASH_CASE(128, 128)
#undef REPRO_FLASH_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); an empty problem launches nothing.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, int B, int Sq, int Sk, int H, int K,
                                   int D, int DV, float scale, int causal,
                                   int q_offset, int dtype, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, B, Sq, Sk, H, K, D, DV, scale, causal, q_offset, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, K, D, DV, scale, causal,
                                   q_offset, s);
  return cudaErrorInvalidValue;
}
