// Helpers shared by the SSD scan kernels (csrc/ssd_scan.cu, the forward,
// and csrc/ssd_scan_bwd.cu, its backward), for sm_90a: the tile and chunk
// limits, the in-chunk cumsum of dt * A in the log2 domain, fp32 row tiles
// loaded from fp32 or bf16 slabs, and for the bf16 tensor-core bodies
// cp.async tile copies, ldmatrix loads, the mma.sync.m16n8k16 bf16
// product with fp32 accumulators and the bf16 head-and-remainder split.
//
// Fragment layouts (m16n8k16): an A fragment (16 x 16, row-major) comes
// from ldsm_x4 at row lane % 16, column (lane / 16) * 8 of its tile; a C
// fragment holds rows lane / 4 (c[0], c[1]) and lane / 4 + 8 (c[2], c[3])
// at columns (lane % 4) * 2 and + 1, so two adjacent C tiles are one A
// fragment of the next product.  A B fragment pair for n-tiles 2j, 2j+1
// comes from ldsm_x4 on an [n][k] tile, or ldsm_x4_trans on a [k][n] one.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kT = 64;              // tokens of a query or key tile
constexpr int kPad = 8;             // bf16 elements of padding per smem row
constexpr int kStages = 2;          // depth of the cp.async tile rings
constexpr int kLMax = 1024;         // longest chunk
constexpr int kSimtThreads = 256;   // a 16 x 16 grid of threads (CUDA-core bodies)
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int round_up(int a, int m) { return (a + m - 1) / m * m; }

// inclusive cumsum of dt*A*log2(e) over the chunk's first Lc tokens into
// cum (the log2 domain: exp(x) is exp2f of it), and dt (0 past Lc) into
// dts, both [Lpad] with Lpad a multiple of 64: warp 0 runs a run per lane,
// then a shuffle scan.  Every thread calls it.  Acc is float (the forward)
// or double (the backward, whose decay gradient is a sum of terms each
// scaled by exp(cum_l - cum_s): a long chunk's cum reaches some -200, where
// one float ulp is a relative error of 1e-5 in such a decay).
template <typename Acc>
__device__ __forceinline__ void chunk_cumsum(const float* dtb, long long stride, float A,
                                             int Lc, int Lpad, float* dts, Acc* cum) {
  Acc a;
  if constexpr (sizeof(Acc) == sizeof(float))
    a = A * kLog2e;
  else
    a = A * 1.4426950408889634;
  for (int i = threadIdx.x; i < Lpad; i += blockDim.x)
    dts[i] = i < Lc ? dtb[i * stride] : 0.f;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src is
// then not read, but must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col); bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two floats -> one bf16x2 register, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}

// two floats -> bf16x2 `head` plus bf16x2 `tail` (what rounding left over):
// head + tail carries ~16 significant bits
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& head,
                                           uint32_t& tail) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  head = bits(h);
  tail = pack_bf16(x - hf.x, y - hf.y);
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
