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
// p < kv_len[b]; fp32 softmax and accumulation; kv_len = 0 gives 0.  No row
// at or past kv_len (nor any page past it) is read, so nothing is padded.
// ps need not be a power of two.
//
// Paged addressing: the TPU kernel had the table scalar-prefetched into
// SMEM to steer its DMA.  Here each block copies the few table entries its
// keys need into shared memory and clamps every one to [0, P-1] before any
// load: unmapped entries hold the sentinel P, and on CUDA an unclamped entry
// is an illegal address, not a masked row.
//
// What bounds it on this card: each cache row is used for G multiply-adds
// per head dim, far below the ~295 operations per byte where the H100 stops
// being bound by memory, so it is bound by the bytes of the live cache,
// B * kv_len * K * (D + Dv) * sizeof(T) (plus the table entries, paged).  At
// the port's decode step those bytes are ~5 MB, a microsecond and a half, so
// what decides the time is how many blocks the key axis is spread over and
// how many dependent load round trips each block makes.
//
// Design (split-K, "flash-decoding"), one launch:
//   * The key axis of each slot is cut into S splits of L keys (L a multiple
//     of 64, the least with S <= 64; the wrapper's `split_plan` picks them
//     from shapes alone: Sk dense, W*ps paged).  Grid (K, B, S): one block
//     per (kv head, slot, split).  Split s is live iff s < n_b =
//     max(1, ceil(kv_len[b] / L)); a block whose split is not live returns
//     at once.
//   * A live block stages its split's K and V rows, 64 keys at a time, in
//     shared memory with 16-byte `cp.async` (K and V in two groups, so the
//     scores start while V is still in flight), computes the G heads'
//     scores, and keeps an online-softmax partial (m, l, acc[Dv]) per head.
//   * With n_b = 1 the block writes the output itself.  Otherwise it writes
//     its partial to an fp32 scratch [B, K, S, G, Dv + 2], fences, and bumps
//     a per-(b, kh) int32 counter; the block that brings it to n_b merges
//     the n_b partials (per head, weights from one warp's fixed shuffle
//     tree; per output, a sum in split order), writes the output, and
//     resets the counter to 0.  The merge order is fixed, so the
//     output is bit-identical from run to run whichever block finishes
//     last, and the dense and paged kernels (which split by logical key
//     index with the same L) stay bit-equal on the same rows.
//   * Limits: G <= 8, D % 8 == 0, D <= 256, Dv <= 128, paged W <= 1024
//     (checked by the wrapper); L and S are checked here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;         // keys staged per round; L is a multiple of it
constexpr int kGMax = 8;          // query heads per KV head
constexpr int kDMax = 256;        // q/k head dim
constexpr int kDvMax = 128;
constexpr int kWMax = 1024;       // page-table entries per slot (paged)
constexpr int kSplitsMax = 64;
constexpr int kTableMax = 66;     // table entries one split can span (checked)
constexpr int kItems = kGMax * kDvMax / kThreads;  // (head, dim) outputs per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// eight consecutive elements from a 16-byte-aligned shared address
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Where the rows live.  Dense: Sk rows per slot (table is null).  Paged:
// the [B, W] page table, P the pool's pages and ps the rows per page.
struct Rows {
  int Sk;                          // dense rows per slot
  const int* table;                // paged: [B, W] int32, else nullptr
  int W, P, ps;
};

// flat row index of key j of slot b (its K/V row is row * K + kh); pt_s holds
// the clamped table entries from page `page0` on (paged only)
template <bool kPaged>
__device__ __forceinline__ long long row_of(const Rows& rows, const int* pt_s, int page0,
                                            int b, int j) {
  if constexpr (kPaged) {
    return (long long)pt_s[j / rows.ps - page0] * rows.ps + j % rows.ps;
  } else {
    return (long long)b * rows.Sk + j;
  }
}

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// dynamic shared memory: q [G*D] fp32, K tile [kTile][D + 16 bytes], V tile
// [kTile][Dv rounded to 16 bytes]
template <typename T>
struct SmemLayout {
  int k_stride, v_stride;          // elements per staged row
  int q_bytes, k_bytes, v_bytes;
  __host__ __device__ SmemLayout(int G, int D, int Dv)
      : k_stride(D + 16 / (int)sizeof(T)),
        v_stride(align16(Dv * (int)sizeof(T)) / (int)sizeof(T)),
        q_bytes(align16(G * D * 4)),
        k_bytes(kTile * k_stride * (int)sizeof(T)),
        v_bytes(kTile * v_stride * (int)sizeof(T)) {}
  __host__ __device__ int total() const { return q_bytes + k_bytes + v_bytes; }
};

template <typename T, bool kPaged>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    T* __restrict__ out, float* __restrict__ part,
                    int* __restrict__ counters, Rows rows, int H, int K, int D, int Dv,
                    float scale, int L, int S, int v_vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float sc[kGMax][kTile];            // scores, then probabilities
  __shared__ float m_s[kGMax], l_s[kGMax], alpha_s[kGMax], den_s[kGMax];
  __shared__ float wt_s[kGMax][kSplitsMax];     // merge weights
  __shared__ int pt_s[kPaged ? kTableMax : 1];
  __shared__ int last_s;

  const int G = H / K;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const SmemLayout<T> lay(G, D, Dv);
  float* qs = reinterpret_cast<float*>(smem_raw);
  T* ks = reinterpret_cast<T*>(smem_raw + lay.q_bytes);
  T* vs = reinterpret_cast<T*>(smem_raw + lay.q_bytes + lay.k_bytes);

  // q's load does not wait on kv_len's
  const T* qg = q + ((long long)b * H + (long long)kh * G) * D;
  for (int i = tid; i < G * D; i += kThreads) qs[i] = to_f32(qg[i]);
  if (tid < kGMax) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  const int cap = kPaged ? rows.W * rows.ps : rows.Sk;
  const int len = max(0, min(kv_len[b], cap));
  const int n_b = max(1, (len + L - 1) / L);
  if (s >= n_b) return;                         // split past kv_len: nothing to do
  const int j_begin = s * L;
  const int j_end = min(len, j_begin + L);

  int page0 = 0;
  if constexpr (kPaged) {
    // the table entries this split's keys fall in, each clamped into the pool
    if (j_end > j_begin) {
      page0 = j_begin / rows.ps;
      const int n_pages = (j_end - 1) / rows.ps - page0 + 1;
      const int* tb = rows.table + (long long)b * rows.W + page0;
      for (int i = tid; i < n_pages; i += kThreads) pt_s[i] = min(max(tb[i], 0), rows.P - 1);
    }
  }
  __syncthreads();

  float acc[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) acc[i] = 0.f;

  const int k_chunks = D * (int)sizeof(T) / 16;        // 16-byte pieces per K row
  const int v_chunks = Dv * (int)sizeof(T) / 16;
  for (int t0 = j_begin; t0 < j_end; t0 += kTile) {
    const int n = min(kTile, j_end - t0);
    // stage the K rows (group 1) and the V rows (group 2)
    for (int c = tid; c < n * k_chunks; c += kThreads) {
      const int i = c / k_chunks, off = (c % k_chunks) * 16;
      const long long row = row_of<kPaged>(rows, pt_s, page0, b, t0 + i);
      cp_async16(reinterpret_cast<char*>(ks + i * lay.k_stride) + off,
                 reinterpret_cast<const char*>(k + (row * K + kh) * D) + off);
    }
    cp_async_commit();
    if (v_vec) {
      for (int c = tid; c < n * v_chunks; c += kThreads) {
        const int i = c / v_chunks, off = (c % v_chunks) * 16;
        const long long row = row_of<kPaged>(rows, pt_s, page0, b, t0 + i);
        cp_async16(reinterpret_cast<char*>(vs + i * lay.v_stride) + off,
                   reinterpret_cast<const char*>(v + (row * K + kh) * Dv) + off);
      }
    } else {  // V rows not 16-byte aligned: element by element
      for (int c = tid; c < n * Dv; c += kThreads) {
        const int i = c / Dv, d = c % Dv;
        const long long row = row_of<kPaged>(rows, pt_s, page0, b, t0 + i);
        vs[i * lay.v_stride + d] = v[(row * K + kh) * Dv + d];
      }
    }
    cp_async_commit();
    cp_async_wait<1>();  // K has landed
    __syncthreads();

    // scores: two threads per key, each over one half of the 8-wide pieces
    {
      const int j = tid / 2, half = tid % 2;
      const int nc = D / 8;
      const int c_lo = half ? (nc + 1) / 2 : 0;
      const int c_hi = half ? nc : (nc + 1) / 2;
      float sg[kGMax];
#pragma unroll
      for (int g = 0; g < kGMax; ++g) sg[g] = 0.f;
      if (j < n) {
        const T* kr = ks + j * lay.k_stride;
        for (int c = c_lo; c < c_hi; ++c) {
          float kv[8];
          load8(kr + c * 8, kv);
#pragma unroll
          for (int g = 0; g < kGMax; ++g) {
            if (g < G) {
              float qv[8];
              load8(qs + g * D + c * 8, qv);
#pragma unroll
              for (int e = 0; e < 8; ++e) sg[g] = fmaf(qv[e], kv[e], sg[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kGMax; ++g) {
        const float full = sg[g] + __shfl_xor_sync(0xffffffffu, sg[g], 1);
        if (g < G && half == 0 && j < n) sc[g][j] = full * scale;
      }
    }
    __syncthreads();

    // online softmax per head: warp w takes heads w and w + 4
    for (int g = warp; g < G; g += kThreads / 32) {
      const float x0 = lane < n ? sc[g][lane] : -INFINITY;
      const float x1 = lane + 32 < n ? sc[g][lane + 32] : -INFINITY;
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));  // finite: n >= 1
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);  // 0 past n
      sc[g][lane] = p0;
      sc[g][lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first round
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    cp_async_wait<0>();  // V has landed
    __syncthreads();

    // P.V: thread owns outputs (g, d) = divmod(tid + i * kThreads, Dv)
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < G * Dv) {
        const int g = idx / Dv, d = idx % Dv;
        const float* p = sc[g];
        const T* vc = vs + d;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        int jj = 0;
        for (; jj + 4 <= n; jj += 4) {
          a0 = fmaf(p[jj], to_f32(vc[jj * lay.v_stride]), a0);
          a1 = fmaf(p[jj + 1], to_f32(vc[(jj + 1) * lay.v_stride]), a1);
          a2 = fmaf(p[jj + 2], to_f32(vc[(jj + 2) * lay.v_stride]), a2);
          a3 = fmaf(p[jj + 3], to_f32(vc[(jj + 3) * lay.v_stride]), a3);
        }
        for (; jj < n; ++jj) a0 = fmaf(p[jj], to_f32(vc[jj * lay.v_stride]), a0);
        acc[i] = acc[i] * alpha_s[g] + ((a0 + a1) + (a2 + a3));
      }
    }
    __syncthreads();  // the tile and the probabilities are free again
  }

  if (n_b == 1) {  // the only live split: finish here (kv_len = 0 gives 0)
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < G * Dv) {
        const int g = idx / Dv, d = idx % Dv;
        const float o = l_s[g] > 0.f ? acc[i] / l_s[g] : 0.f;
        out[((long long)b * H + (long long)kh * G + g) * Dv + d] = from_f32<T>(o);
      }
    }
    return;
  }

  // write this split's partial, then count it in
  const int row_w = Dv + 2;
  float* mine = part + (((long long)b * K + kh) * S + s) * G * row_w;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < G * Dv) mine[(idx / Dv) * row_w + idx % Dv] = acc[i];
  }
  if (tid < G) {
    mine[tid * row_w + Dv] = m_s[tid];
    mine[tid * row_w + Dv + 1] = l_s[tid];
  }

  // count the partial in: every writer fences its own writes, then one
  // atomic per block; the last block fences again before it reads
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* counter = counters + (long long)b * K + kh;
    const int done = atomicAdd(counter, 1) + 1;
    last_s = done == n_b;
    if (done == n_b) *counter = 0;  // every live split has counted in: ready for the next call
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();

  // the last block merges the n_b partials in a fixed order: per head, a
  // warp turns the splits' (m, l) into weights with one fixed shuffle tree;
  // per output, one thread sums the splits in split order
  const float* slot = part + ((long long)b * K + kh) * S * G * row_w;
  const long long step = (long long)G * row_w;
  for (int g = warp; g < G; g += kThreads / 32) {
    float m[2], l[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = lane + 32 * u;
      const float* pr = slot + i * step + (long long)g * row_w;
      m[u] = i < n_b ? __ldcg(pr + Dv) : -INFINITY;
      l[u] = i < n_b ? __ldcg(pr + Dv + 1) : 0.f;
    }
    const float mx = warp_max(fmaxf(m[0], m[1]));  // finite: every live split has a key
    const float w0 = expf(m[0] - mx), w1 = expf(m[1] - mx);  // 0 past n_b
    wt_s[g][lane] = w0;
    wt_s[g][lane + 32] = w1;
    const float den = warp_sum(l[0] * w0 + l[1] * w1);
    if (lane == 0) den_s[g] = den;
  }
  __syncthreads();
  for (int idx = tid; idx < G * Dv; idx += kThreads) {
    const int g = idx / Dv, d = idx % Dv;
    const float* pr = slot + (long long)g * row_w + d;
    float num = 0.f;
    int i = 0;
    for (; i + 4 <= n_b; i += 4) {  // four loads in flight, summed in order
      const float x0 = __ldcg(pr + i * step), x1 = __ldcg(pr + (i + 1) * step);
      const float x2 = __ldcg(pr + (i + 2) * step), x3 = __ldcg(pr + (i + 3) * step);
      num = fmaf(x0, wt_s[g][i], num);
      num = fmaf(x1, wt_s[g][i + 1], num);
      num = fmaf(x2, wt_s[g][i + 2], num);
      num = fmaf(x3, wt_s[g][i + 3], num);
    }
    for (; i < n_b; ++i) num = fmaf(__ldcg(pr + i * step), wt_s[g][i], num);
    out[((long long)b * H + (long long)kh * G + g) * Dv + d] = from_f32<T>(num / den_s[g]);
  }
}

template <typename T, bool kPaged>
cudaError_t launch_typed(const void* q, const void* k, const void* v, const void* kv_len,
                         void* out, void* part, void* counters, Rows rows, int B, int H,
                         int K, int D, int Dv, float scale, int L, int S,
                         cudaStream_t stream) {
  const SmemLayout<T> lay(H / K, D, Dv);
  const int smem = lay.total();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<T, kPaged>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int v_vec = (Dv * (int)sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const dim3 grid(K, B, S);
  decode_split_kernel<T, kPaged><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_len), static_cast<T*>(out), static_cast<float*>(part),
      static_cast<int*>(counters), rows, H, K, D, Dv, scale, L, S, v_vec);
  return cudaGetLastError();
}

template <bool kPaged>
int launch(const void* q, const void* k, const void* v, const void* kv_len, void* out,
           void* part, void* counters, Rows rows, int B, int H, int K, int D, int Dv,
           float scale, int L, int S, int dtype, void* stream) {
  if (B == 0) return 0;
  if (K <= 0 || H % K != 0 || H / K > kGMax || D % 8 != 0 || D <= 0 || D > kDMax ||
      Dv <= 0 || Dv > kDvMax)
    return cudaErrorInvalidValue;
  if (kPaged && (rows.W <= 0 || rows.W > kWMax || rows.P <= 0 || rows.ps <= 0))
    return cudaErrorInvalidValue;
  // the split plan: L keys per split, S splits covering the key axis
  const long long cap = kPaged ? (long long)rows.W * rows.ps : rows.Sk;
  if (L <= 0 || L % kTile != 0 || S < 1 || S > kSplitsMax ||
      (long long)S * L < cap || (long long)(S - 1) * L >= (cap > 0 ? cap : 1))
    return cudaErrorInvalidValue;
  if (kPaged && (L - 1) / rows.ps + 2 > kTableMax) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float, kPaged>(q, k, v, kv_len, out, part, counters, rows, B, H, K,
                                       D, Dv, scale, L, S, s);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16, kPaged>(q, k, v, kv_len, out, part, counters, rows,
                                               B, H, K, D, Dv, scale, L, S, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  part: fp32 scratch of B*K*S*G*(Dv+2)
// elements; counters: B*K int32, all 0 on entry and left 0 on exit.  L, S:
// the split plan (keys per split, splits).  Each entry point returns
// cudaGetLastError() after the launch (0 on success).  k must be 16-byte
// aligned with D % 8 == 0.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* kv_len, void* out, void* part,
                                    void* counters, int B, int Sk, int H, int K, int D,
                                    int Dv, float scale, int L, int S, int dtype,
                                    void* stream) {
  const Rows rows{Sk, nullptr, 0, 0, 0};
  return launch<false>(q, k, v, kv_len, out, part, counters, rows, B, H, K, D, Dv, scale,
                       L, S, dtype, stream);
}

// k_pool [P,ps,K,D], v_pool [P,ps,K,Dv], page_table [B,W] int32.
extern "C" int decode_attention_paged_fwd(const void* q, const void* k_pool,
                                          const void* v_pool, const void* page_table,
                                          const void* kv_len, void* out, void* part,
                                          void* counters, int B, int P, int ps, int W,
                                          int H, int K, int D, int Dv, float scale, int L,
                                          int S, int dtype, void* stream) {
  const Rows rows{0, static_cast<const int*>(page_table), W, P, ps};
  return launch<true>(q, k_pool, v_pool, kv_len, out, part, counters, rows, B, H, K, D,
                      Dv, scale, L, S, dtype, stream);
}
