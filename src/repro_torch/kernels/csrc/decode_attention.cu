// Sq=1 GQA decode attention over a ragged KV cache, dense or paged, for
// Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention
// (Pallas; body `_kernel`) and its paged twin ::decode_attention_paged
// (`_paged_kernel`): one body, templated on how key row j of slot b is
// addressed:
//   dense  q [B,H,D], k [B,Sk,K,D], v [B,Sk,K,Dv]:  row = b*Sk + j
//   paged  q [B,H,D], k [P,ps,K,D], v [P,ps,K,Dv], page_table [B,W] int32:
//          row = table[b][j / ps] * ps + j % ps
// kv_len [B] int32 -> out [B,H,Dv]; position p is attended iff
// p < kv_len[b]; fp32 softmax and accumulation; kv_len = 0 gives 0.  The
// kernel stops at kv_len, so nothing is padded and no row past it (nor any
// page past it) is read.  ps need not be a power of two.
//
// Paged addressing: the TPU kernel had the table scalar-prefetched into
// SMEM to steer its DMA.  Here each block copies its slot's table row into
// shared memory itself and clamps every entry to [0, P-1] before any load:
// unmapped entries hold the sentinel P, and on CUDA an unclamped entry is an
// illegal address, not a masked row.
//
// What bounds it on this card: each cache row is used for G multiply-adds
// per head dim, far below the ~295 operations per byte where the H100 stops
// being bound by memory, so it is bound by the bytes of the live cache,
// B * kv_len * K * (D + Dv) * sizeof(T) (plus the table row, paged).
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
//   * Limits: G <= 8, D % 8 == 0, D <= 256, Dv <= 128, paged W <= 1024
//     (checked by the wrapper); larger groups and heads are later work, as
//     is splitting the KV axis across blocks to fill more SMs at small B*K.

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
constexpr int kWMax = 1024;     // page-table entries per slot (paged)

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

// Where the rows live.  Dense: Sk rows per slot (table is null).  Paged:
// the [B, W] page table, P the pool's pages and ps the rows per page.
struct Rows {
  int Sk;                          // dense rows per slot
  const int* table;                // paged: [B, W] int32, else nullptr
  int W, P, ps;
};

// flat row index of key j of slot b (its K/V row is row * K + kh); pt_s is
// the slot's clamped table row in shared memory (paged only)
template <bool kPaged>
__device__ __forceinline__ long long row_of(Rows rows, const int* pt_s, int b, int j) {
  if constexpr (kPaged) {
    return (long long)pt_s[j / rows.ps] * rows.ps + j % rows.ps;
  } else {
    return (long long)b * rows.Sk + j;
  }
}

template <typename T, bool kPaged>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ kv_len,
              T* __restrict__ out, Rows rows, int H, int K, int D, int Dv,
              float scale) {
  __shared__ float qs[kGMax * kDMax];
  __shared__ float m_w[kWarps][kGMax];
  __shared__ float l_w[kWarps][kGMax];
  __shared__ float acc_w[kWarps][kGMax][kDvPerLane * 32];
  __shared__ int pt_s[kPaged ? kWMax : 1];

  const int G = H / K;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const T* qg = q + ((long long)b * H + (long long)kh * G) * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) qs[i] = to_f32(qg[i]);
  int len;
  if constexpr (kPaged) {
    // the slot's table row, every entry clamped into the pool
    const int* tb = rows.table + (long long)b * rows.W;
    for (int i = threadIdx.x; i < rows.W; i += kThreads)
      pt_s[i] = min(max(tb[i], 0), rows.P - 1);
    len = max(0, min(kv_len[b], rows.W * rows.ps));
  } else {
    len = max(0, min(kv_len[b], rows.Sk));
  }
  __syncthreads();

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
      const T* kr = k + (row_of<kPaged>(rows, pt_s, b, j) * K + kh) * D;
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
        const bool live = i0 + r < n;
        const long long vrow = live ? row_of<kPaged>(rows, pt_s, b, j0 + i0 + r) : 0;
        const T* vr = v + (vrow * K + kh) * Dv;
#pragma unroll
        for (int t = 0; t < kDvPerLane; ++t) {
          const int d = t * 32 + lane;
          vv[r][t] = (live && d < Dv) ? to_f32(vr[d]) : 0.f;
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

template <bool kPaged>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* out, Rows rows, int B, int H, int K, int D, int Dv,
           float scale, int dtype, void* stream) {
  if (B == 0) return 0;
  if (K <= 0 || H % K != 0 || H / K > kGMax || D % 8 != 0 || D > kDMax ||
      Dv > kDvPerLane * 32)
    return cudaErrorInvalidValue;
  if (kPaged && (rows.W <= 0 || rows.W > kWMax || rows.P <= 0 || rows.ps <= 0))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(K, B);
  const int* lens = static_cast<const int*>(kv_len);
  if (dtype == 0) {
    decode_kernel<float, kPaged><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), lens, static_cast<float*>(out), rows, H, K,
        D, Dv, scale);
  } else if (dtype == 1) {
    decode_kernel<__nv_bfloat16, kPaged><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), lens, static_cast<__nv_bfloat16*>(out),
        rows, H, K, D, Dv, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each entry point returns
// cudaGetLastError() after the launch (0 on success).  k must be 16-byte
// aligned with D % 8 == 0.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* kv_len, void* out, int B, int Sk,
                                    int H, int K, int D, int Dv, float scale,
                                    int dtype, void* stream) {
  const Rows rows{Sk, nullptr, 0, 0, 0};
  return launch<false>(q, k, v, kv_len, out, rows, B, H, K, D, Dv, scale, dtype,
                       stream);
}

// k_pool [P,ps,K,D], v_pool [P,ps,K,Dv], page_table [B,W] int32.
extern "C" int decode_attention_paged_fwd(const void* q, const void* k_pool,
                                          const void* v_pool,
                                          const void* page_table,
                                          const void* kv_len, void* out, int B,
                                          int P, int ps, int W, int H, int K,
                                          int D, int Dv, float scale, int dtype,
                                          void* stream) {
  const Rows rows{0, static_cast<const int*>(page_table), W, P, ps};
  return launch<true>(q, k_pool, v_pool, kv_len, out, rows, B, H, K, D, Dv,
                      scale, dtype, stream);
}
