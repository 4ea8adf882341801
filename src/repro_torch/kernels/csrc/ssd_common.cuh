// Helpers shared by the SSD scan kernels (csrc/ssd_scan.cu, the forward,
// and csrc/ssd_scan_bwd.cu, its backward), for sm_90a, on top of
// mma_common.cuh's cp.async, ldmatrix, mma.sync and bf16 helpers: the tile
// and chunk limits, the in-chunk cumsum of dt * A in the log2 domain, fp32
// row tiles loaded from fp32 or bf16 slabs, and bf16 cp.async tile copies.
//
// Fragment layouts (m16n8k16): an A fragment (16 x 16, row-major) comes
// from ldsm_x4 at row lane % 16, column (lane / 16) * 8 of its tile; a C
// fragment holds rows lane / 4 (c[0], c[1]) and lane / 4 + 8 (c[2], c[3])
// at columns (lane % 4) * 2 and + 1, so two adjacent C tiles are one A
// fragment of the next product.  A B fragment pair for n-tiles 2j, 2j+1
// comes from ldsm_x4 on an [n][k] tile, or ldsm_x4_trans on a [k][n] one.
#pragma once

#include "mma_common.cuh"

namespace {

constexpr int kT = 64;              // tokens of a query or key tile
constexpr int kStages = 2;          // depth of the cp.async tile rings
constexpr int kLMax = 1024;         // longest chunk
constexpr int kSimtThreads = 256;   // a 16 x 16 grid of threads (CUDA-core bodies)

__host__ __device__ constexpr int round_up(int a, int m) { return (a + m - 1) / m * m; }

// the inclusive cumsum of dts[i] * a over [Lpad] (a multiple of 32) into
// cum, by one warp: a run per lane over its Lpad / 32 entries, then a
// shuffle scan
template <typename Acc>
__device__ __forceinline__ void warp_cumsum(const float* dts, Acc a, int Lpad, Acc* cum) {
  const int lane = threadIdx.x % 32;
  const int per = Lpad / 32;
  const int i0 = lane * per;
  Acc run = 0;
  for (int i = i0; i < i0 + per; ++i) {
    run += dts[i] * a;
    cum[i] = run;
  }
  Acc incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Acc v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const Acc off = incl - run;
  for (int i = i0; i < i0 + per; ++i) cum[i] += off;
}

// dt * A * log2(e), the rate of cum, in Acc
template <typename Acc>
__device__ __forceinline__ Acc log2_rate(float A) {
  if constexpr (sizeof(Acc) == sizeof(float))
    return A * kLog2e;
  else
    return A * 1.4426950408889634;
}

// inclusive cumsum of dt*A*log2(e) over the chunk's first Lc tokens into
// cum (the log2 domain: exp(x) is exp2f of it), and dt (0 past Lc) into
// dts, both [Lpad] with Lpad a multiple of 64: warp 0 runs warp_cumsum.
// Every thread calls it.  Acc is float (the forward) or double (the
// backward, whose decay gradient is a sum of terms each scaled by
// exp(cum_l - cum_s): a long chunk's cum reaches some -200, where one
// float ulp is a relative error of 1e-5 in such a decay).
template <typename Acc>
__device__ __forceinline__ void chunk_cumsum(const float* dtb, long long stride, float A,
                                             int Lc, int Lpad, float* dts, Acc* cum) {
  for (int i = threadIdx.x; i < Lpad; i += blockDim.x)
    dts[i] = i < Lc ? dtb[i * stride] : 0.f;
  __syncthreads();
  if (threadIdx.x < 32) warp_cumsum(dts, log2_rate<Acc>(A), Lpad, cum);
  __syncthreads();
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// rows [r0, r0 + kT) of a [tokens, *, width] slab (fp32 or bf16) into a
// [kT][ld] fp32 tile, zero past `rows`; a block of kSimtThreads threads
template <int width, int ld, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long stride, int r0,
                                          int rows) {
  for (int i = threadIdx.x; i < kT * width; i += kSimtThreads) {
    const int r = i / width, c = i % width;
    dst[r * ld + c] = (r0 + r < rows) ? to_f32(src[(r0 + r) * stride + c]) : 0.f;
  }
}

// rows [r0, r0 + kT) of a [tokens, *, width] bf16 slab into a [kT][ld]
// smem tile by 16-byte cp.async; rows at or past `rows` are zero-filled
template <int width, int ld>
__device__ __forceinline__ void cp_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                        long long stride, int r0, int rows) {
  constexpr int kPieces = width / 8;
  for (int i = threadIdx.x; i < kT * kPieces; i += blockDim.x) {
    const int r = i / kPieces, col = (i % kPieces) * 8;
    const bool ok = r0 + r < rows;
    cp_async16(dst + r * ld + col, ok ? src + (long long)(r0 + r) * stride + col : src, ok);
  }
}

}  // namespace
