// Sq=1 GQA decode attention over a ragged dense KV cache, for Hopper
// (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention
// (Pallas; body `_kernel`).  Same contract: q [B,H,D], k [B,Sk,K,D],
// v [B,Sk,K,Dv], kv_len [B] int32 -> out [B,H,Dv]; position p is attended
// iff p < kv_len[b]; fp32 softmax and accumulation; kv_len = 0 gives 0.
// Sk need not divide any tile: the kernel stops at kv_len and copies nothing.
//
// What bounds it on this card: each cache row is used for G multiply-adds
// per head dim, far below the ~295 operations per byte where the H100 stops
// being bound by memory, so it is bound by the bytes of the live cache,
// B * kv_len * K * (D + Dv) * sizeof(T).
//
// Design:
//   * One block per (batch, kv head).  The G query heads of the group sit in
//     shared memory, and every K/V row is read once and serves all G heads.
//   * The block loops over the cache only up to kv_len[b]: the dead tail of a
//     slot's max_seq stripe is never read.
//   * Each of the 8 warps takes chunks of 32 keys in turn.  For scores a lane
//     owns one key and reads its K row with 16-byte loads; for P.V the warp
//     walks the chunk's V rows, each a coalesced read with lanes on
//     consecutive dims, eight rows' loads in flight at once (a first version
//     that waited on one V row at a time was bound by load latency).  Each warp keeps its own online-softmax state in
//     registers, and the warps' states are merged through shared memory.
//   * Limits: G <= 8, D % 8 == 0, D <= 256, Dv <= 128 (checked by the
//     wrapper); larger groups and heads are later work, as is splitting the
//     KV axis across blocks to fill more SMs at small B*K.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGMax = 8;        // query heads per KV head
constexpr int kDMax = 256;      // q/k head dim
constexpr int kDvPerLane = 4;   // Dv <= 32 * 4
constexpr int kVRows = 8;       // V rows loaded together in P.V

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// eight consecutive elements from a 16-byte-aligned address
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ kv_len,
              T* __restrict__ out, int Sk, int H, int K, int D, int Dv,
              float scale) {
  __shared__ float qs[kGMax * kDMax];
  __shared__ float m_w[kWarps][kGMax];
  __shared__ float l_w[kWarps][kGMax];
  __shared__ float acc_w[kWarps][kGMax][kDvPerLane * 32];

  const int G = H / K;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const T* qg = q + ((long long)b * H + (long long)kh * G) * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) qs[i] = to_f32(qg[i]);
  __syncthreads();

  const int len = max(0, min(kv_len[b], Sk));
  float m[kGMax], l[kGMax], acc[kGMax][kDvPerLane];
#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int t = 0; t < kDvPerLane; ++t) acc[g][t] = 0.f;
  }

  for (int j0 = warp * 32; j0 < len; j0 += kWarps * 32) {
    // scores: lane owns key j0 + lane (lane 0 is always live here)
    const int j = j0 + lane;
    const bool valid = j < len;
    float s[kGMax];
#pragma unroll
    for (int g = 0; g < kGMax; ++g) s[g] = 0.f;
    if (valid) {
      const T* kr = k + (((long long)b * Sk + j) * K + kh) * D;
      for (int d0 = 0; d0 < D; d0 += 32) {
        float kv[4][8];  // four 16-byte loads in flight before any is used
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (d0 + 8 * u < D) load8(kr + d0 + 8 * u, kv[u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (d0 + 8 * u < D) {
#pragma unroll
            for (int g = 0; g < kGMax; ++g) {
              if (g < G) {
#pragma unroll
                for (int e = 0; e < 8; ++e)
                  s[g] = fmaf(qs[g * D + d0 + 8 * u + e], kv[u][e], s[g]);
              }
            }
          }
        }
      }
    }
    float p[kGMax];
#pragma unroll
    for (int g = 0; g < kGMax; ++g) {
      p[g] = 0.f;
      if (g < G) {
        const float sg = valid ? s[g] * scale : -INFINITY;
        const float m_new = fmaxf(m[g], warp_max(sg));  // finite: lane 0 is live
        const float alpha = expf(m[g] - m_new);
        p[g] = expf(sg - m_new);
        l[g] = l[g] * alpha + warp_sum(p[g]);
#pragma unroll
        for (int t = 0; t < kDvPerLane; ++t) acc[g][t] *= alpha;
        m[g] = m_new;
      }
    }
    // P.V in groups of kVRows rows: every V load of a group is issued before
    // any is used, so their latencies overlap; lanes hold consecutive dims
    const int n = min(32, len - j0);
    for (int i0 = 0; i0 < n; i0 += kVRows) {
      float vv[kVRows][kDvPerLane];
#pragma unroll
      for (int r = 0; r < kVRows; ++r) {
        const T* vr = v + (((long long)b * Sk + j0 + i0 + r) * K + kh) * Dv;
#pragma unroll
        for (int t = 0; t < kDvPerLane; ++t) {
          const int d = t * 32 + lane;
          vv[r][t] = (i0 + r < n && d < Dv) ? to_f32(vr[d]) : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kVRows; ++r) {
#pragma unroll
        for (int g = 0; g < kGMax; ++g) {
          if (g < G) {
            // p of a key past len is 0, so rows past n add nothing
            const float pi = __shfl_sync(0xffffffffu, p[g], i0 + r);
#pragma unroll
            for (int t = 0; t < kDvPerLane; ++t) acc[g][t] = fmaf(pi, vv[r][t], acc[g][t]);
          }
        }
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
    if (g < G) {
      if (lane == 0) {
        m_w[warp][g] = m[g];
        l_w[warp][g] = l[g];
      }
#pragma unroll
      for (int t = 0; t < kDvPerLane; ++t) acc_w[warp][g][t * 32 + lane] = acc[g][t];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * Dv; idx += kThreads) {
    const int g = idx / Dv, d = idx % Dv;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_w[w][g]);
    float o = 0.f;
    if (mx != -INFINITY) {  // kv_len == 0 leaves every warp empty: output 0
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = expf(m_w[w][g] - mx);  // 0 for a warp that saw no key
        den += l_w[w][g] * c;
        num += acc_w[w][g][d] * c;
      }
      o = num / den;
    }
    out[((long long)b * H + (long long)kh * G + g) * Dv + d] = from_f32<T>(o);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success).  k must be 16-byte aligned with D % 8 == 0.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* kv_len, void* out, int B, int Sk,
                                    int H, int K, int D, int Dv, float scale,
                                    int dtype, void* stream) {
  if (B == 0) return 0;
  if (K <= 0 || H % K != 0 || H / K > kGMax || D % 8 != 0 || D > kDMax ||
      Dv > kDvPerLane * 32)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(K, B);
  const int* lens = static_cast<const int*>(kv_len);
  if (dtype == 0) {
    decode_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), lens, static_cast<float*>(out), Sk, H, K, D, Dv,
        scale);
  } else if (dtype == 1) {
    decode_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), lens, static_cast<__nv_bfloat16*>(out), Sk,
        H, K, D, Dv, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
