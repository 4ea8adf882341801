// Mamba-2 SSD chunked scan with state carry, for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (Pallas; body
// `_kernel`).  Same contract: x [B,S,H,P], dt [B,S,H] fp32 (softplus'ed),
// A [H] fp32 (negative), Bm/Cm [B,S,G,N] in x's dtype (head h reads group
// h / (H/G)), optional h0 [B,H,P,N] fp32 -> y [B,S,H,P] in x's dtype and,
// optionally, the final state hT [B,H,P,N] fp32.  Per chunk of L tokens:
//   y_l   = sum_{s<=l} (C_l . B_s) exp(cum_l - cum_s) dt_s x_s      (intra)
//         + exp(cum_l) C_l . h_in                                   (inter)
//   h_out = exp(cum_L) h_in + sum_s exp(cum_L - cum_s) dt_s x_s B_s^T
// with cum the inclusive cumsum of dt*A over the chunk.  All decay math and
// the state are fp32.  S need not divide the chunk: the last chunk is
// shorter, which is what the reference's dt = 0 padding computes (padded
// rows add nothing and decay by 1), and nothing is copied.
//
// What bounds it on this card: per (b, h, chunk) the intra term costs
// about L^2 (N + P) / 2 multiply-adds and the inter term and state update
// 2 L P N, against L (2P + 2N) + 4L bytes read and L P written: some 60-120
// operations per byte at the full width (L 256, P 64, N 128), above the
// fp32 CUDA-core ridge (67 TFLOP/s over 3.35 TB/s = 20), so it is bound by
// fp32 operations.  This first kernel uses CUDA cores, not tensor cores.
//
// Design:
//   * The TPU kernel walks the chunks as a sequential grid axis carrying h
//     in VMEM.  Here one block per (b, h) loops over the chunks, and the
//     [P, N] fp32 state (32 KB at full width) stays in shared memory.
//   * A [L, L] fp32 C.B^T tile does not fit (256 KB at L 256), so the
//     intra term is tiled: 64-row query tiles against the 64-row key tiles
//     at or below the diagonal; the scores of one tile pair go through
//     shared memory to the scores.x product.
//   * Each thread owns a 4-row by P/16-column (or 4 by 4, or P/16 by N/16)
//     register tile of every product, so each shared load feeds several
//     multiply-adds; rows of the [., N] tiles are padded by one float so
//     16 lanes reading 16 rows hit 16 banks.
//   * Instantiated for (P, N) in {(32, 16), (64, 128)} (the reduced and
//     full mamba2-130m heads), fp32 and bf16; the wrapper refuses other
//     pairs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;          // rows of a query or key tile
constexpr int kLMax = 1024;     // longest chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ constexpr int round_up(int a, int m) { return (a + m - 1) / m * m; }

// shared floats: state [P][N+1], C and B tiles [kT][N+1], x tile [kT][P],
// scores [kT][kT+1], and cum / dt / state weights over the padded chunk
__host__ __device__ constexpr int smem_floats(int P, int N, int L) {
  return P * (N + 1) + 2 * kT * (N + 1) + kT * P + kT * (kT + 1) +
         3 * round_up(L, kT);
}

// rows [r0, r0 + kT) of a [S, *, width] slab into a [kT][ld] tile, zero
// past `rows`
template <typename T, int width, int ld>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long stride,
                                          int r0, int rows) {
  for (int i = threadIdx.x; i < kT * width; i += kThreads) {
    const int r = i / width, c = i % width;
    dst[r * ld + c] = (r0 + r < rows) ? to_f32(src[(r0 + r) * stride + c]) : 0.f;
  }
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ h0,
           T* __restrict__ y, float* __restrict__ hT, int S, int H, int G,
           int L) {
  static_assert(P % 16 == 0 && N % 16 == 0 && (P * N) % kThreads == 0, "tile");
  constexpr int NP = N + 1;      // padded row of an [., N] tile
  constexpr int SP = kT + 1;     // padded row of the scores tile
  constexpr int RY = kT / 16;    // query rows per thread
  constexpr int CP = P / 16;     // y columns (or state rows) per thread
  constexpr int CN = N / 16;     // state columns per thread
  constexpr int CS = kT / 16;    // score columns per thread

  extern __shared__ float smem[];
  const int Lpad = round_up(L, kT);
  float* hs = smem;                  // [P][NP] the carried state
  float* cq = hs + P * NP;           // [kT][NP] C rows of the query tile
  float* bk = cq + kT * NP;          // [kT][NP] B rows of the key tile
  float* xk = bk + kT * NP;          // [kT][P]  x rows of the key tile
  float* sc = xk + kT * P;           // [kT][SP] scores of the tile pair
  float* cum = sc + kT * SP;         // [Lpad]   inclusive cumsum of dt*A
  float* dts = cum + Lpad;           // [Lpad]   dt (0 past the chunk)
  float* wst = dts + Lpad;           // [Lpad]   exp(cum_L - cum_s) dt_s

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int g = h / (H / G);
  const float a = A[h];
  const long long tok = (long long)H * P;   // x / y stride between tokens
  const long long tokbc = (long long)G * N; // B / C stride between tokens
  const T* xb = x + (long long)b * S * tok + (long long)h * P;
  T* yb = y + (long long)b * S * tok + (long long)h * P;
  const T* Bb = Bm + (long long)b * S * tokbc + (long long)g * N;
  const T* Cb = Cm + (long long)b * S * tokbc + (long long)g * N;
  const float* dtb = dt + (long long)b * S * H + h;
  const long long hoff = ((long long)b * H + h) * P * N;

  for (int i = tid; i < P * N; i += kThreads)
    hs[(i / N) * NP + i % N] = h0 ? h0[hoff + i] : 0.f;

  for (int c0 = 0; c0 < S; c0 += L) {
    const int Lc = min(L, S - c0);
    const int ntiles = (Lc + kT - 1) / kT;
    __syncthreads();  // the previous chunk is done with every buffer
    for (int i = tid; i < Lpad; i += kThreads)
      dts[i] = i < Lc ? dtb[(long long)(c0 + i) * H] : 0.f;
    __syncthreads();
    if (tid < 32) {  // inclusive cumsum of dt*A: a run per lane, then a scan
      const int per = Lpad / 32;
      const int i0 = tid * per;
      float run = 0.f;
      for (int i = i0; i < i0 + per; ++i) {
        run += dts[i] * a;
        cum[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      const float off = incl - run;
      for (int i = i0; i < i0 + per; ++i) cum[i] += off;
    }
    __syncthreads();
    const float cum_last = cum[Lc - 1];
    for (int i = tid; i < Lpad; i += kThreads)
      wst[i] = i < Lc ? expf(cum_last - cum[i]) * dts[i] : 0.f;

    for (int lt = 0; lt < ntiles; ++lt) {
      const int l0 = lt * kT;
      __syncthreads();
      load_tile<T, N, NP>(cq, Cb + (long long)c0 * tokbc, tokbc, l0, Lc);
      __syncthreads();
      // inter-chunk: acc[l][p] = exp(cum_l) * sum_n C[l][n] h_in[p][n]
      float acc[RY][CP];
#pragma unroll
      for (int i = 0; i < RY; ++i)
#pragma unroll
        for (int j = 0; j < CP; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[RY], hv[CP];
#pragma unroll
        for (int i = 0; i < RY; ++i) cv[i] = cq[(ty * RY + i) * NP + n];
#pragma unroll
        for (int j = 0; j < CP; ++j) hv[j] = hs[(tx + 16 * j) * NP + n];
#pragma unroll
        for (int i = 0; i < RY; ++i)
#pragma unroll
          for (int j = 0; j < CP; ++j) acc[i][j] = fmaf(cv[i], hv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RY; ++i) {
        const int l = l0 + ty * RY + i;
        const float e = l < Lc ? expf(cum[l]) : 0.f;
#pragma unroll
        for (int j = 0; j < CP; ++j) acc[i][j] *= e;
      }
      // intra-chunk: the key tiles at or below the diagonal
      for (int st = 0; st <= lt; ++st) {
        const int s0 = st * kT;
        __syncthreads();
        load_tile<T, N, NP>(bk, Bb + (long long)c0 * tokbc, tokbc, s0, Lc);
        load_tile<T, P, P>(xk, xb + (long long)c0 * tok, tok, s0, Lc);
        __syncthreads();
        float s[RY][CS];
#pragma unroll
        for (int i = 0; i < RY; ++i)
#pragma unroll
          for (int j = 0; j < CS; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[RY], bv[CS];
#pragma unroll
          for (int i = 0; i < RY; ++i) cv[i] = cq[(ty * RY + i) * NP + n];
#pragma unroll
          for (int j = 0; j < CS; ++j) bv[j] = bk[(tx + 16 * j) * NP + n];
#pragma unroll
          for (int i = 0; i < RY; ++i)
#pragma unroll
            for (int j = 0; j < CS; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < RY; ++i) {
          const int l = l0 + ty * RY + i;
#pragma unroll
          for (int j = 0; j < CS; ++j) {
            const int sg = s0 + tx + 16 * j;
            // s <= l < Lc only: above the diagonal the decay would overflow
            sc[(ty * RY + i) * SP + tx + 16 * j] =
                (sg <= l && l < Lc) ? s[i][j] * expf(cum[l] - cum[sg]) * dts[sg] : 0.f;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int ss = 0; ss < kT; ++ss) {
          float sv[RY], xv[CP];
#pragma unroll
          for (int i = 0; i < RY; ++i) sv[i] = sc[(ty * RY + i) * SP + ss];
#pragma unroll
          for (int j = 0; j < CP; ++j) xv[j] = xk[ss * P + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < RY; ++i)
#pragma unroll
            for (int j = 0; j < CP; ++j) acc[i][j] = fmaf(sv[i], xv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < RY; ++i) {
        const int l = l0 + ty * RY + i;
        if (l < Lc) {
#pragma unroll
          for (int j = 0; j < CP; ++j)
            yb[(long long)(c0 + l) * tok + tx + 16 * j] = from_f32<T>(acc[i][j]);
        }
      }
    }

    // state update: h_out[p][n] = exp(cum_L) h_in[p][n] + sum_s w_s x_s[p] B_s[n]
    float hr[CP][CN];
    const float dec = expf(cum_last);
#pragma unroll
    for (int i = 0; i < CP; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) hr[i][j] = dec * hs[(ty * CP + i) * NP + tx + 16 * j];
    for (int st = 0; st < ntiles; ++st) {
      const int s0 = st * kT;
      __syncthreads();
      load_tile<T, N, NP>(bk, Bb + (long long)c0 * tokbc, tokbc, s0, Lc);
      load_tile<T, P, P>(xk, xb + (long long)c0 * tok, tok, s0, Lc);
      __syncthreads();
#pragma unroll 4
      for (int ss = 0; ss < kT; ++ss) {
        const float w = wst[s0 + ss];
        float xv[CP], bv[CN];
#pragma unroll
        for (int i = 0; i < CP; ++i) xv[i] = xk[ss * P + ty * CP + i] * w;
#pragma unroll
        for (int j = 0; j < CN; ++j) bv[j] = bk[ss * NP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < CP; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) hr[i][j] = fmaf(xv[i], bv[j], hr[i][j]);
      }
    }
    // each thread writes back only the entries it alone read above
#pragma unroll
    for (int i = 0; i < CP; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) hs[(ty * CP + i) * NP + tx + 16 * j] = hr[i][j];
  }

  if (hT) {
    __syncthreads();
    for (int i = tid; i < P * N; i += kThreads) hT[hoff + i] = hs[(i / N) * NP + i % N];
  }
}

template <typename T, int P, int N>
int launch_one(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, const void* h0, void* y, void* hT, int Bsz, int S,
               int H, int G, int L, cudaStream_t s) {
  auto kernel = ssd_kernel<T, P, N>;
  const int bytes = smem_floats(P, N, L) * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, Bsz), kThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const float*>(h0), static_cast<T*>(y), static_cast<float*>(hT), S, H,
      G, L);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* h0, void* y, void* hT, int Bsz, int S, int H,
           int P, int G, int N, int L, cudaStream_t s) {
  if (P == 32 && N == 16)
    return launch_one<T, 32, 16>(x, dt, A, Bm, Cm, h0, y, hT, Bsz, S, H, G, L, s);
  if (P == 64 && N == 128)
    return launch_one<T, 64, 128>(x, dt, A, Bm, Cm, h0, y, hT, Bsz, S, H, G, L, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (of x, Bm, Cm, y): 0 = float32, 1 = bfloat16.  h0 and hT may be
// null.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, const void* h0, void* y,
                            void* hT, int Bsz, int S, int H, int P, int G, int N,
                            int chunk, int dtype, void* stream) {
  if (Bsz == 0 || S == 0) return 0;
  if (G <= 0 || H % G != 0 || chunk <= 0 || chunk > kLMax) return cudaErrorInvalidValue;
  const int L = chunk < S ? chunk : S;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, dt, A, Bm, Cm, h0, y, hT, Bsz, S, H, P, G, N, L, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, h0, y, hT, Bsz, S, H, P, G, N, L, s);
  return cudaErrorInvalidValue;
}
