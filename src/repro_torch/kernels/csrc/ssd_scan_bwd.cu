// Mamba-2 SSD chunked scan, backward, for Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan's backward,
// which the Pallas kernel never had: the JAX package trains through the
// autodiff of repro/kernels/ref.py::ssd_chunked_ref, and this computes its
// gradient.  In: x [B,S,H,P], dt [B,S,H] fp32, A [H] fp32, Bm/Cm
// [B,S,G,N] (head h reads group h / (H/G)), optional h0 [B,H,P,N] fp32,
// the forward call's fp32 state scratch (slot c - 1 holds h_in[c], the
// state entering chunk c), dy [B,S,H,P] in x's dtype and an optional dhT
// [B,H,P,N] fp32 (zero when null).  Out: dx, dB, dC in x's dtype, ddt
// [B,S,H] and dA [H] fp32, and dh0 fp32 when h0 is given.
//
// What bounds it on this card: per (b, h, chunk of L tokens) L^2 (3N + 2P)
// flops over the causal (query, key) pairs (C.B^T, dy.x^T and their uses
// in dx, dB, dC) and 8 L P N for the state terms, against some 6 L P bytes
// (x, dy, dx; B, C and their gradients are shared by a group's heads): at
// full width (L 256, P 64, N 128, bf16) ~450 flops per byte, over the bf16
// tensor-core ridge (~295), so it is bound by operations.  The bf16 body
// runs phases 1, 3 and 4 on the tensor cores with `wgmma`, fed by TMA, the
// fp32 score and state operands as a bf16 head and remainder (which
// doubles those products); fp32 runs them on CUDA cores (TF32 would miss
// the fp32 bound of 2e-3).
//
// Per chunk c of Lc tokens, with cum the inclusive cumsum of dt*A over the
// chunk, L its last token, D_ls = exp(cum_l - cum_s) for s <= l (0 above
// the diagonal), CB_ls = C_l.B_s, G_ls = dy_l.x_s, and dh[c] the gradient
// of h_in[c] (dh[nc] = dhT):
//   dh[c]  = exp(cum_L) dh[c+1] + Q_c,  Q_c = sum_l exp(cum_l) dy_l C_l^T
//   dx_s   = dt_s [ sum_{l>=s} CB_ls D_ls dy_l + w_s dh[c+1] B_s ]
//   dB_s   = dt_s [ sum_{l>=s} G_ls D_ls C_l  + w_s dh[c+1]^T x_s ]    (per head)
//   dC_l   = sum_{s<=l} G_ls D_ls dt_s B_s + exp(cum_l) h_in[c]^T dy_l   (per head)
// with w_s = exp(cum_L - cum_s); dB and dC are then summed over the H/G
// heads of a group.  The decay: with U_s = sum_l CB_ls D_ls G_ls, V_s =
// w_s x_s.dh[c+1] B_s, R_l = sum_s CB_ls D_ls dt_s G_ls and I_l =
// exp(cum_l) dy_l.h_in[c] C_l, the gradient of cum is
//   dcum_t = R_t + I_t - dt_t (U_t + V_t)
//            + [t = L] (sum_s dt_s V_s + exp(cum_L) <dh[c+1], h_in[c]>),
// d(dt*A)_t = sum_{t'>=t} dcum_t' (a reverse cumsum in the chunk), then
//   ddt_t = U_t + V_t + A d(dt*A)_t,   dA = sum_{b,t} dt_t d(dt*A)_t.
// Every exponent is a difference with s <= l, or cum itself (<= 0), in the
// log2 domain: nothing overflows.  A shorter last chunk is the
// reference's dt = 0 padding, as in the forward.
//
// Precision: ddt_t is a small difference of sums whose terms reach 1e3
// (products C.B times dy.x), and every one of those terms carries a decay
// exp(cum_l - cum_s) whose exponent, as a difference of two fp32 cumsums
// near -200, is off by an fp32 ulp of 200.  So cum is kept in fp64 (each
// exponent is rounded to fp32 only after the subtraction), and U, V, R, I,
// dcum, its reverse cumsum, ddt's sum and dA are fp64; the products stay
// fp32.  U and R take each term z_ls = C.B D dy.x from the same fp64
// product, made once (on the key side), so sum_t R_t - dt_t U_t cancels to
// fp64 rounding and d(dt*A)_t holds only the pairs (l >= t > s) that
// straddle t, as it does in exact arithmetic; without that the rounding of
// the terms late in a chunk reaches dA multiplied by the sum of dt before
// them.
//
// Design: the forward's chunk-parallel phases, in reverse.
//   1. Chunk state gradients (`ssd_bwd_dstates*`), one block per (head,
//      chunk, batch): the chunk's cumsum, exp(cum_L) to `decay`, and Q_c,
//      a [P, L].[L, N] product, to scratch (chunk 0 only for dh0; with one
//      chunk it writes dh0 = exp(cum_L) dhT + Q_0 itself).
//   2. Reverse state pass (`ssd_bwd_state_pass`), one thread per 4 state
//      entries of a (batch, head): walks the chunks from the last,
//      dh = decay_c dh + Q_c, and leaves dh[c] in slot c (and dh0).
//   3. Key side (`ssd_bwd_keys*`), one block per 64-key tile of a chunk:
//      the state terms from dh[c+1], then over the query tiles at or below
//      the diagonal C.B^T and dy.x^T, decayed, into dx, dB, U, V and this
//      key tile's terms of R for each query.  The heaviest tiles (first in
//      the chunk) first.
//   4. Query side (`ssd_bwd_queries*`), one block per 64-query tile of a
//      chunk: the inter term from h_in[c], then over the key tiles at or
//      below the diagonal, into dC and I.  It recomputes dy.x^T (a tenth of
//      the flops) rather than carry the score tiles through device memory.
//   5. Decay gradient (`ssd_bwd_decay`), one block per (head, chunk,
//      batch): R from its key tiles' terms in order, dcum, its reverse
//      cumsum by one warp, ddt and the chunk's term of dA.
//   6. Reduction (`ssd_bwd_reduce`): dB and dC summed over the partials of
//      a group, and dA over (batch, chunk), each in a fixed order.
// Phases 1, 3 and 4 have two bodies, chosen by dtype:
//   fp32 on CUDA cores (a 16 x 16 grid of threads on register tiles), one
//     head per block, dB and dC partials per head;
//   bf16 (`*_wgmma`) on the tensor cores.  Phase 1 is one warpgroup whose
//     thread 0 keeps a ring of (dy, C) tiles in flight by TMA; it also
//     writes each chunk's fp64 cum and its dt to scratch (chunk 0 too),
//     which phases 3 and 4 then copy rather than make again.  Phases 3
//     and 4 are warp-specialized, two blocks an SM: a producer warpgroup
//     (setmaxnreg 24) whose thread 0 streams the walk's tiles by TMA
//     through a ring of two mbarrier stages and whose thread 32 fetches
//     each head's cum, dt and fp32 state (dh[c+1] or h_in[c]) by bulk
//     copies while the last head walks, and one consumer warpgroup
//     (setmaxnreg 232) that runs every product as a wgmma with fp32
//     accumulators.  A block takes a run of up to kHpb = 4 heads of one
//     group (runs never cross a group; a group's last run may be shorter):
//     it loads the group's B (keys) or C (queries) tile once and sums the
//     run's dB (or dC) in registers, in a fixed order, into one fp32
//     partial, so phase 6 sums H / G / 4 partials per group, not H / G.
//     The register budget: one consumer warpgroup holds dB (64 fp32) and a
//     head's dx (32) across the walk, and per query tile the two score
//     tiles (32 each), which become M and W in place during the fp64 pass
//     and only then the head and tail A fragments of the next products
//     (the accumulator layout is wgmma's A layout); the fp64 decay work
//     runs while the other block of the SM is in its products.  Nothing
//     else lives across a head's walk (each head makes its geometry and
//     pointers anew, from `fresh` values the compiler cannot hoist), so
//     ptxas spills nothing.  The decay of two different tiles is a product
//     of a row and a column factor from a per-head table (decay_factors);
//     only the diagonal tile takes an exp2 per pair.
// The other phases are one body for both.  Launches per call: 6 with
// several chunks; with one chunk 5 when h0 is given (phase 2 skipped), 4
// without (phases 1 and 2 skipped).  Scratch comes from the caller;
// nothing is allocated or zeroed here.  No atomics: two calls give the
// same bits.
// Instantiated for (P, N) in {(32, 16), (64, 128), (64, 16)}, as the
// forward.  N 16 pads to one 64-column panel that the tensor maps fill with
// zeros past column 16 (a 32-byte global row at G 1), so the products over
// N run one live 16-wide k-step and three on zeros; P 32 fills half of a
// 64-row tile the same way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_common.cuh"
#include "ssd_common.cuh"

namespace {

constexpr int kDecayThreads = 128;   // phase 5
constexpr int kRed = kSimtThreads / 32;

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// sum over the 16 threads of a row of the 16 x 16 thread grid (tx = lane % 16)
__device__ __forceinline__ double sum16(double v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the block's sum, in a fixed order, returned to thread 0; red holds one
// double per warp; every thread calls it
__device__ __forceinline__ double block_sum(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  double t = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)blockDim.x / 32; ++w) t += red[w];
  __syncthreads();
  return t;
}

// ---------------------------------------------------------------------------
// phase 1: chunk state gradients Q_c = sum_l exp(cum_l) dy_l C_l^T
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int dstates_floats(int P, int N, int Lpad) {
  return 3 * Lpad + kT * (N + 1) + kT * P;
}

// each thread owns a P/16 x N/16 register tile; `direct` (one chunk):
// dh0 = exp(cum_L) dhT + Q_0 instead of the scratch slot
template <int P, int N, typename T>
__global__ void __launch_bounds__(kSimtThreads)
ssd_bwd_dstates(const T* __restrict__ dy, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Cm,
                const float* __restrict__ dhT, float* __restrict__ dstates,
                float* __restrict__ decay, float* __restrict__ dh0, int S, int H, int G,
                int L, int nc, int direct) {
  constexpr int NP = N + 1, CP = P / 16, CN = N / 16;
  extern __shared__ __align__(16) float smem[];
  const int Lpad = round_up(L, kT);
  double* cum = reinterpret_cast<double*>(smem);     // [Lpad]
  float* wst = reinterpret_cast<float*>(cum + Lpad);  // [Lpad] dt, then exp(cum_l)
  float* ck = wst + Lpad;                             // [kT][NP] C rows
  float* yk = ck + kT * NP;                           // [kT][P]  dy rows

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  if (c == 0 && !dh0) return;  // only dh0 needs chunk 0's term
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int g = h / (H / G);
  const int c0 = c * L, Lc = min(L, S - c0);
  const long long tok = (long long)H * P, tokbc = (long long)G * N;
  const long long row0 = (long long)b * S + c0;
  const T* yb = dy + row0 * tok + (long long)h * P;
  const T* Cb = Cm + row0 * tokbc + (long long)g * N;

  chunk_cumsum(dt + row0 * H + h, H, A[h], Lc, Lpad, wst, cum);
  const double cum_last = cum[Lc - 1];
  for (int i = tid; i < Lpad; i += kSimtThreads) wst[i] = i < Lc ? exp2f((float)cum[i]) : 0.f;
  const float dec = exp2f((float)cum_last);
  if (!direct && tid == 0) decay[((long long)b * nc + c) * H + h] = dec;

  float hr[CP][CN];
#pragma unroll
  for (int i = 0; i < CP; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) hr[i][j] = 0.f;
  for (int s0 = 0; s0 < Lc; s0 += kT) {
    __syncthreads();
    load_tile<N, NP>(ck, Cb, tokbc, s0, Lc);
    load_tile<P, P>(yk, yb, tok, s0, Lc);
    __syncthreads();
#pragma unroll 4
    for (int ss = 0; ss < kT; ++ss) {
      const float w = wst[s0 + ss];
      float yv[CP], cv[CN];
#pragma unroll
      for (int i = 0; i < CP; ++i) yv[i] = yk[ss * P + ty * CP + i] * w;
#pragma unroll
      for (int j = 0; j < CN; ++j) cv[j] = ck[ss * NP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < CP; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) hr[i][j] = fmaf(yv[i], cv[j], hr[i][j]);
    }
  }
  const long long hoff = ((long long)b * H + h) * P * N;
  float* out = direct ? dh0 + hoff : dstates + (((long long)b * nc + c) * H + h) * P * N;
#pragma unroll
  for (int i = 0; i < CP; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int e = (ty * CP + i) * N + tx + 16 * j;
      out[e] = direct && dhT ? fmaf(dec, dhT[hoff + e], hr[i][j]) : hr[i][j];
    }
}

// ---------------------------------------------------------------------------
// phase 2: the reverse state pass
// ---------------------------------------------------------------------------

// one thread per 4 entries of one (b, h) state; slots [B][nc][H][P*N]
__global__ void __launch_bounds__(256)
ssd_bwd_state_pass(float* __restrict__ dstates, const float* __restrict__ decay,
                   const float* __restrict__ dhT, float* __restrict__ dh0, int Bsz, int H,
                   int PN, int nc) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;  // float4 index
  const int per = PN / 4;
  if (q >= (long long)Bsz * H * per) return;
  const int e = (int)(q % per);
  const long long bh = q / per;
  const int h = (int)(bh % H), b = (int)(bh / H);
  float4 v = dhT ? reinterpret_cast<const float4*>(dhT + bh * PN)[e]
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = nc - 1; c >= (dh0 ? 0 : 1); --c) {
    const long long slot = ((long long)b * nc + c) * H + h;
    float4* sp = reinterpret_cast<float4*>(dstates + slot * PN) + e;
    const float d = decay[slot];
    const float4 s = *sp;
    v = make_float4(fmaf(d, v.x, s.x), fmaf(d, v.y, s.y), fmaf(d, v.z, s.z),
                    fmaf(d, v.w, s.w));
    if (c > 0)
      *sp = v;  // dh[c], the gradient of the state leaving chunk c - 1
    else
      reinterpret_cast<float4*>(dh0 + bh * PN)[e] = v;
  }
}

// ---------------------------------------------------------------------------
// phases 3 and 4: the key side and the query side of each chunk
// ---------------------------------------------------------------------------
// shared floats of phase 3: cum [Lpad], one per warp and the R terms of
// each row of threads [16][kT] (doubles), dt [Lpad], B and x rows of the
// key tile, C and dy rows of the query tile (dh[c+1] [P][N+1] before the
// first), M^T and W^T score tiles [kT][kT+1]
__host__ __device__ constexpr int keys_floats(int P, int N, int Lpad) {
  return 3 * Lpad + 2 * kRed + 2 * 16 * kT + 2 * kT * (N + 1) + 2 * kT * (P + 1) +
         2 * kT * (kT + 1);
}
// phase 4: cum (doubles) and dt, C and dy rows of the query tile, B and x
// rows of the key tile (h_in [P][N+1] before the first), the W score tile
__host__ __device__ constexpr int queries_floats(int P, int N, int Lpad) {
  return 3 * Lpad + 2 * kT * (N + 1) + 2 * kT * (P + 1) + kT * (kT + 1);
}

struct Scr {       // the caller's scratch; the decay terms in fp64
  double* U;        // [B, S, H]
  double* V;        // [B, S, H]
  double* E;        // [B, S, H]         I
  double* csc;      // [B, nc, H]        exp(cum_L) <dh[c+1], h_in[c]>
  double* dAp;      // [B, nc, H]        each chunk's term of dA
  double* Rp;       // [L / 64][B, S, H] R's terms from each key tile
  double* cum;      // [B, nc, H, Lpad]  each chunk's cum, from phase 1 (bf16)
  long long rows;   // B S H, Rp's stride
  float* dts;       // [B, nc, H, Lpad]  each chunk's dt, 0 past its end (bf16)
  float* dstates;   // [B, nc, H, P, N]  (more than one chunk)
  float* decay;     // [B, nc, H]        (more than one chunk)
  float* dBp;       // [B, S, G * runs, N]  dB of each run of a group's heads
  float* dCp;       // [B, S, G * runs, N]  dC of each run
};

// Phase 3: one 64-key tile of one chunk; each thread owns 4 keys (rows
// ty*4..) by P/16 dx columns and N/16 dB columns (tx + 16 j), and 4 x 4 of
// each score tile (queries tx + 16 j)
template <int P, int N, typename T>
__global__ void __launch_bounds__(kSimtThreads)
ssd_bwd_keys(const T* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const T* __restrict__ Bm, const T* __restrict__ Cm,
             const T* __restrict__ dy, const float* __restrict__ h0,
             const float* __restrict__ states, const float* __restrict__ dhT, Scr sc,
             T* __restrict__ dx, int S, int H, int G, int L, int nc, int ns) {
  constexpr int NP = N + 1, PP = P + 1, SP = kT + 1;
  constexpr int CP = P / 16, CN = N / 16, CS = kT / 16, RK = kT / 16;
  static_assert(P * NP <= kT * (NP + PP), "dh fits the query tiles' space");
  extern __shared__ __align__(16) float smem[];
  const int Lpad = round_up(L, kT);
  double* cum = reinterpret_cast<double*>(smem);      // [Lpad]
  double* red = cum + Lpad;                            // [kRed]
  double* rred = red + kRed;                           // [16][kT]
  float* dts = reinterpret_cast<float*>(rred + 16 * kT);  // [Lpad]
  float* bk = dts + Lpad;     // [kT][NP]
  float* xk = bk + kT * NP;   // [kT][PP]
  float* cq = xk + kT * PP;   // [kT][NP]
  float* yq = cq + kT * NP;   // [kT][PP]
  float* dh = cq;             // [P][NP], until the first query tile
  float* mt = yq + kT * PP;   // [kT][SP] CB D dt_s, keys x queries
  float* wt = mt + kT * SP;   // [kT][SP] G D dt_s

  const int st = blockIdx.x;  // key tile: the first has the most query tiles
  const int h = blockIdx.y, b = blockIdx.z / nc, c = blockIdx.z % nc;
  const int c0 = c * L, Lc = min(L, S - c0), s0 = st * kT;
  if (s0 >= Lc) return;  // past a short last chunk
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int g = h / (H / G);
  const long long tok = (long long)H * P, tokbc = (long long)G * N;
  const long long row0 = (long long)b * S + c0, bh = (long long)b * H + h;
  const T* xb = x + row0 * tok + (long long)h * P;
  const T* yb = dy + row0 * tok + (long long)h * P;
  const T* Bb = Bm + row0 * tokbc + (long long)g * N;
  const T* Cb = Cm + row0 * tokbc + (long long)g * N;
  // the gradient of the state leaving this chunk (the pass's slot of the
  // next chunk, or dhT), and the state entering it (h0 or the forward's slot)
  const float* dho = c < nc - 1 ? sc.dstates + (((long long)b * nc + c + 1) * H + h) * P * N
                                : (dhT ? dhT + bh * P * N : nullptr);
  const float* hin = c == 0 ? (h0 ? h0 + bh * P * N : nullptr)
                            : states + (((long long)b * ns + c - 1) * H + h) * P * N;

  load_tile<N, NP>(bk, Bb, tokbc, s0, Lc);
  load_tile<P, PP>(xk, xb, tok, s0, Lc);
  if (dho)
    for (int i = tid; i < P * N; i += kSimtThreads) dh[(i / N) * NP + i % N] = dho[i];
  chunk_cumsum(dt + row0 * H + h, H, A[h], Lc, Lpad, dts, cum);  // syncs the loads
  const double cum_last = cum[Lc - 1];

  float ax[RK][CP], ab[RK][CN];
  double u[RK], v[RK];
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    u[i] = v[i] = 0.0;
#pragma unroll
    for (int j = 0; j < CP; ++j) ax[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < CN; ++j) ab[i][j] = 0.f;
  }
  if (dho) {  // the state terms: dh.B_s and dh^T x_s, weighted by w_s dt_s
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float bv[RK], hv[CP];
#pragma unroll
      for (int i = 0; i < RK; ++i) bv[i] = bk[(ty * RK + i) * NP + n];
#pragma unroll
      for (int j = 0; j < CP; ++j) hv[j] = dh[(tx + 16 * j) * NP + n];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < CP; ++j) ax[i][j] = fmaf(bv[i], hv[j], ax[i][j]);
    }
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      float xv[RK], hv[CN];
#pragma unroll
      for (int i = 0; i < RK; ++i) xv[i] = xk[(ty * RK + i) * PP + p];
#pragma unroll
      for (int j = 0; j < CN; ++j) hv[j] = dh[p * NP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) ab[i][j] = fmaf(xv[i], hv[j], ab[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RK; ++i) {
      const int k = ty * RK + i, s = s0 + k;
      const float w = s < Lc ? exp2f((float)(cum_last - cum[s])) : 0.f;
      float part = 0.f;  // x_s . (dh B_s), over this thread's columns
#pragma unroll
      for (int j = 0; j < CP; ++j) part = fmaf(xk[k * PP + tx + 16 * j], ax[i][j], part);
      v[i] = (double)w * part;
      const float wd = w * dts[s];
#pragma unroll
      for (int j = 0; j < CP; ++j) ax[i][j] *= wd;
#pragma unroll
      for (int j = 0; j < CN; ++j) ab[i][j] *= wd;
    }
  }
  if (st == 0) {  // the chunk decay's term: exp(cum_L) <dh[c+1], h_in[c]>
    double part = 0.0;
    if (dho && hin)
      for (int i = tid; i < P * N; i += kSimtThreads)
        part += (double)dh[(i / N) * NP + i % N] * hin[i];
    const double tot = block_sum(part, red);
    if (tid == 0) sc.csc[((long long)b * nc + c) * H + h] = exp2((double)cum_last) * tot;
  }
  __syncthreads();  // dh is no longer read: the query tiles overwrite it

  for (int l0 = s0; l0 < Lc; l0 += kT) {  // the query tiles at or below the diagonal
    load_tile<N, NP>(cq, Cb, tokbc, l0, Lc);
    load_tile<P, PP>(yq, yb, tok, l0, Lc);
    __syncthreads();
    float cb[RK][CS], gg[RK][CS];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < CS; ++j) cb[i][j] = gg[i][j] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float bv[RK], cv[CS];
#pragma unroll
      for (int i = 0; i < RK; ++i) bv[i] = bk[(ty * RK + i) * NP + n];
#pragma unroll
      for (int j = 0; j < CS; ++j) cv[j] = cq[(tx + 16 * j) * NP + n];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < CS; ++j) cb[i][j] = fmaf(bv[i], cv[j], cb[i][j]);
    }
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      float xv[RK], yv[CS];
#pragma unroll
      for (int i = 0; i < RK; ++i) xv[i] = xk[(ty * RK + i) * PP + p];
#pragma unroll
      for (int j = 0; j < CS; ++j) yv[j] = yq[(tx + 16 * j) * PP + p];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < CS; ++j) gg[i][j] = fmaf(xv[i], yv[j], gg[i][j]);
    }
    double rp[CS] = {};  // R's terms of this thread's keys, per query
#pragma unroll
    for (int i = 0; i < RK; ++i) {
      const int k = ty * RK + i, s = s0 + k;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        const int q = tx + 16 * j, l = l0 + q;
        // s <= l < Lc only: above the diagonal the decay would overflow
        const float d = (s <= l && l < Lc) ? exp2f((float)(cum[l] - cum[s])) : 0.f;
        const float cd = cb[i][j] * d;
        mt[k * SP + q] = cd * dts[s];
        wt[k * SP + q] = gg[i][j] * d * dts[s];
        const double z = (double)cb[i][j] * d * (double)gg[i][j];  // C.B D dy.x
        u[i] += z;
        rp[j] = fma(z, (double)dts[s], rp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < CS; ++j) rred[ty * kT + tx + 16 * j] = rp[j];
    __syncthreads();
    if (tid < kT && l0 + tid < Lc) {  // this key tile's share of R, in a fixed order
      double rs = 0.0;
      for (int y = 0; y < 16; ++y) rs += rred[y * kT + tid];
      sc.Rp[st * sc.rows + (row0 + l0 + tid) * H + h] = rs;
    }
#pragma unroll 4
    for (int q = 0; q < kT; ++q) {
      float mv[RK], wv[RK], yv[CP], cv[CN];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        mv[i] = mt[(ty * RK + i) * SP + q];
        wv[i] = wt[(ty * RK + i) * SP + q];
      }
#pragma unroll
      for (int j = 0; j < CP; ++j) yv[j] = yq[q * PP + tx + 16 * j];
#pragma unroll
      for (int j = 0; j < CN; ++j) cv[j] = cq[q * NP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
#pragma unroll
        for (int j = 0; j < CP; ++j) ax[i][j] = fmaf(mv[i], yv[j], ax[i][j]);
#pragma unroll
        for (int j = 0; j < CN; ++j) ab[i][j] = fmaf(wv[i], cv[j], ab[i][j]);
      }
    }
    __syncthreads();  // every thread is done with this query tile
  }
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const double ui = sum16(u[i]), vi = sum16(v[i]);
    const int s = s0 + ty * RK + i;
    if (s < Lc) {
      const long long r = (row0 + s) * H + h;  // (token, head) row
      T* dxp = dx + r * P;
#pragma unroll
      for (int j = 0; j < CP; ++j) dxp[tx + 16 * j] = from_f32<T>(ax[i][j]);
#pragma unroll
      for (int j = 0; j < CN; ++j) sc.dBp[r * N + tx + 16 * j] = ab[i][j];
      if (tx == 0) {
        sc.U[r] = ui;
        sc.V[r] = vi;
      }
    }
  }
}

// Phase 4: one 64-query tile of one chunk; each thread owns 4 queries
// (rows ty*4..) by N/16 dC columns, and 4 x 4 of the score tiles (keys
// tx + 16 j)
template <int P, int N, typename T>
__global__ void __launch_bounds__(kSimtThreads)
ssd_bwd_queries(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const T* __restrict__ dy,
                const float* __restrict__ h0, const float* __restrict__ states, Scr sc, int S,
                int H, int G, int L, int nc, int ns) {
  constexpr int NP = N + 1, PP = P + 1, SP = kT + 1;
  constexpr int CN = N / 16, CS = kT / 16, RQ = kT / 16;
  static_assert(P * NP <= kT * (NP + PP), "h_in fits the key tiles' space");
  extern __shared__ __align__(16) float smem[];
  const int Lpad = round_up(L, kT);
  double* cum = reinterpret_cast<double*>(smem);      // [Lpad]
  float* dts = reinterpret_cast<float*>(cum + Lpad);  // [Lpad]
  float* cq = dts + Lpad;     // [kT][NP]
  float* yq = cq + kT * NP;   // [kT][PP]
  float* bk = yq + kT * PP;   // [kT][NP]
  float* xk = bk + kT * NP;   // [kT][PP]
  float* hs = bk;             // [P][NP] h_in, until the first key tile
  float* wq = xk + kT * PP;   // [kT][SP] G D dt_s, queries x keys

  const int lt = gridDim.x - 1 - blockIdx.x;  // the heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z / nc, c = blockIdx.z % nc;
  const int c0 = c * L, Lc = min(L, S - c0), l0 = lt * kT;
  if (l0 >= Lc) return;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int g = h / (H / G);
  const long long tok = (long long)H * P, tokbc = (long long)G * N;
  const long long row0 = (long long)b * S + c0, bh = (long long)b * H + h;
  const T* xb = x + row0 * tok + (long long)h * P;
  const T* yb = dy + row0 * tok + (long long)h * P;
  const T* Bb = Bm + row0 * tokbc + (long long)g * N;
  const T* Cb = Cm + row0 * tokbc + (long long)g * N;
  const float* hin = c == 0 ? (h0 ? h0 + bh * P * N : nullptr)
                            : states + (((long long)b * ns + c - 1) * H + h) * P * N;

  load_tile<N, NP>(cq, Cb, tokbc, l0, Lc);
  load_tile<P, PP>(yq, yb, tok, l0, Lc);
  if (hin)
    for (int i = tid; i < P * N; i += kSimtThreads) hs[(i / N) * NP + i % N] = hin[i];
  chunk_cumsum(dt + row0 * H + h, H, A[h], Lc, Lpad, dts, cum);  // syncs the loads

  float ac[RQ][CN];
  double e[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    e[i] = 0.0;
#pragma unroll
    for (int j = 0; j < CN; ++j) ac[i][j] = 0.f;
  }
  if (hin) {  // inter: h_in^T dy_l, weighted by exp(cum_l)
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      float yv[RQ], hv[CN];
#pragma unroll
      for (int i = 0; i < RQ; ++i) yv[i] = yq[(ty * RQ + i) * PP + p];
#pragma unroll
      for (int j = 0; j < CN; ++j) hv[j] = hs[p * NP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) ac[i][j] = fmaf(yv[i], hv[j], ac[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int q = ty * RQ + i, l = l0 + q;
      const float ex = l < Lc ? exp2f((float)cum[l]) : 0.f;
      float part = 0.f;  // C_l . (h_in^T dy_l), over this thread's columns
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        part = fmaf(cq[q * NP + tx + 16 * j], ac[i][j], part);
        ac[i][j] *= ex;
      }
      e[i] = (double)ex * part;
    }
  }
  __syncthreads();  // h_in is no longer read: the key tiles overwrite it

  for (int s0 = 0; s0 <= l0; s0 += kT) {  // the key tiles at or below the diagonal
    load_tile<N, NP>(bk, Bb, tokbc, s0, Lc);
    load_tile<P, PP>(xk, xb, tok, s0, Lc);
    __syncthreads();
    float gg[RQ][CS];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CS; ++j) gg[i][j] = 0.f;
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      float yv[RQ], xv[CS];
#pragma unroll
      for (int i = 0; i < RQ; ++i) yv[i] = yq[(ty * RQ + i) * PP + p];
#pragma unroll
      for (int j = 0; j < CS; ++j) xv[j] = xk[(tx + 16 * j) * PP + p];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CS; ++j) gg[i][j] = fmaf(yv[i], xv[j], gg[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int q = ty * RQ + i, l = l0 + q;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        const int k = tx + 16 * j, s = s0 + k;
        const float d = (s <= l && l < Lc) ? exp2f((float)(cum[l] - cum[s])) : 0.f;
        wq[q * SP + k] = gg[i][j] * d * dts[s];
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kT; ++k) {
      float wv[RQ], bv[CN];
#pragma unroll
      for (int i = 0; i < RQ; ++i) wv[i] = wq[(ty * RQ + i) * SP + k];
#pragma unroll
      for (int j = 0; j < CN; ++j) bv[j] = bk[k * NP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) ac[i][j] = fmaf(wv[i], bv[j], ac[i][j]);
    }
    __syncthreads();  // every thread is done with this key tile
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const double ei = sum16(e[i]);
    const int l = l0 + ty * RQ + i;
    if (l < Lc) {
      const long long rw = (row0 + l) * H + h;
#pragma unroll
      for (int j = 0; j < CN; ++j) sc.dCp[rw * N + tx + 16 * j] = ac[i][j];
      if (tx == 0) sc.E[rw] = ei;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 bodies of phases 1, 3 and 4: TMA, mbarriers, wgmma
// ---------------------------------------------------------------------------
// Tiles arrive by TMA as 64-column bf16 panels with the 128-byte swizzle
// that wgmma reads (hopper_common.cuh); P 32 and N 16 are padded to one
// panel by the tensor maps' zero fill, N 128 is two.  A box of 64 tokens
// may reach into the next chunk (L 100): every score and state term is
// masked by s < Lc and l < Lc, never by zeros in the tile.  The fp32
// operands (the weighted dy of phase 1, the decayed score tiles, dh[c+1]
// and h_in[c]) go in as a bf16 head plus its bf16 remainder.
using bf16 = __nv_bfloat16;

constexpr int kHpb = 4;                 // heads per key- or query-side block
constexpr int kWThreads = 256;          // consumer warpgroup, then producer warpgroup
constexpr int kPanel = kT * kRowBytes;  // one [64 tokens][64 columns] bf16 panel

// x, dy [B,S,H,P] and B, C [B,S,G,N], each a 4-d map of 64 x 64 boxes
struct SsdMaps {
  CUtensorMap x, dy, B, C;
};

// runs: head runs per group (of up to kHpb heads; H / G need not be a multiple)
struct BwdDims {
  int Bsz, S, H, G, L, nc, ns, runs;
};

template <int P, int N>
struct Tiles {
  static_assert(P % 16 == 0 && P <= 64 && N % 16 == 0 && N <= 128, "P <= 64, N <= 128");
  static constexpr int NP = N <= 64 ? 64 : 128;     // N as whole panels
  static constexpr int kX = kPanel;                  // an x or dy tile [64][64]
  static constexpr int kBC = NP / 64 * kPanel;       // a B or C tile, or a state, [64][NP]
  static constexpr int kStage = kX + kBC;
  // phases 3, 4: the fixed B or C tile, the head's own x or dy tile, a
  // state's head and tail, two stages; then the R terms and a block sum
  // (doubles), cum [Lpad] (doubles), dt and a decay factor [Lpad], six
  // barriers
  static constexpr int kSideTiles = kBC + kX + 2 * kBC + 2 * kStage;
  static int side_bytes(int Lpad) { return 1024 + kSideTiles + (4 * kT + 4) * 8 + Lpad * 16 + 80; }
  // phase 1: two stages, the weighted dy's head and tail, cum, exp(cum), two
  // barriers (~68 KB at L 256: three blocks an SM)
  static int dstates_bytes(int Lpad) { return 1024 + 2 * kStage + 2 * kX + Lpad * 12 + 16; }
};

// the first 1024-byte boundary at or after p (by pointer arithmetic, so
// that what is derived from it stays a shared-memory address)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

// named barrier 1: the consumer warpgroup of a warp-specialized block
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// byte offset of element (row, col) of a 64-row tile of 64-column panels:
// 16-byte chunk j of row r sits at chunk j ^ (r % 8) (the 128-byte swizzle)
__device__ __forceinline__ int sw128_offset(int row, int col) {
  return col / 64 * kPanel + row * kRowBytes + ((((col % 64) / 8) ^ (row % 8)) << 4) +
         (col % 8) * 2;
}

// v, opaque to the compiler: what is derived from it is made where it is
// used, not hoisted out of the head loop or shared across setmaxnreg,
// where it would only be spilled
__device__ __forceinline__ int fresh(int v) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(v));
  return v;
}
__device__ __forceinline__ int tid_here() { return fresh((int)threadIdx.x); }
__device__ __forceinline__ int block_here() { return fresh((int)blockIdx.x); }

// two bf16 of a swizzled tile, at an even column
__device__ __forceinline__ float2 tile_pair(const unsigned char* tile, int row, int col) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(tile + sw128_offset(row, col)));
}

// The fp32 state [P][N] that the bulk copy left at `head` into bf16 head
// and tail panels [64][NP] at `head` and `tail` (zero past P and N), in
// place: the consumer warpgroup reads all of it, syncs, then writes, and
// fences the panels for the wgmmas that read them.
template <int P, int N>
__device__ __forceinline__ void convert_state(unsigned char* head, unsigned char* tail) {
  constexpr int NP = Tiles<P, N>::NP, kIt = kT * NP / 8 / 128;
  const int tid = tid_here();
  const float* raw = reinterpret_cast<const float*>(head);
  float4 v[2 * kIt];
#pragma unroll
  for (int k = 0; k < kIt; ++k) {
    const int i = tid + 128 * k, p = i / (NP / 8), n = i % (NP / 8) * 8;
    const bool in = p < P && n < N;
    v[2 * k] = in ? *reinterpret_cast<const float4*>(raw + p * N + n) : make_float4(0, 0, 0, 0);
    v[2 * k + 1] =
        in ? *reinterpret_cast<const float4*>(raw + p * N + n + 4) : make_float4(0, 0, 0, 0);
  }
  consumer_sync();  // every fp32 value is read before the panels overwrite them
#pragma unroll
  for (int k = 0; k < kIt; ++k) {
    const int i = tid + 128 * k, p = i / (NP / 8), n = i % (NP / 8) * 8;
    const float4 &u = v[2 * k], &w = v[2 * k + 1];
    uint32_t hd[4], tl[4];
    split_bf16(u.x, u.y, hd[0], tl[0]);
    split_bf16(u.z, u.w, hd[1], tl[1]);
    split_bf16(w.x, w.y, hd[2], tl[2]);
    split_bf16(w.z, w.w, hd[3], tl[3]);
    const int o = sw128_offset(p, n);
    *reinterpret_cast<uint4*>(head + o) = make_uint4(hd[0], hd[1], hd[2], hd[3]);
    *reinterpret_cast<uint4*>(tail + o) = make_uint4(tl[0], tl[1], tl[2], tl[3]);
  }
  fence_proxy_async();
}

// this thread's part of <raw, dot> in fp64, raw the fp32 state [P][N] in
// shared memory and dot [P][N] in global memory
template <int P, int N>
__device__ __forceinline__ double state_dot(const unsigned char* raw_bytes,
                                            const float* __restrict__ dot) {
  static_assert(P * N % 512 == 0, "whole float4s for every thread");
  const float4* raw = reinterpret_cast<const float4*>(raw_bytes);
  const float4* g = reinterpret_cast<const float4*>(dot);
  const int tid = tid_here();
  double part = 0.0;
#pragma unroll
  for (int k = 0; k < P * N / 4 / 128; ++k) {
    const float4 d = g[tid + 128 * k], r = raw[tid + 128 * k];
    part += (double)r.x * d.x + (double)r.y * d.y + (double)r.z * d.z + (double)r.w * d.w;
  }
  return part;
}

// four fp32 values of one n8 column tile of an accumulator (rows r, r + 8)
// into the A fragments of the next product: head and tail of k-slice j / 2
__device__ __forceinline__ void frag_pair(const float (&v)[4], int j, uint32_t (&hd)[4][4],
                                          uint32_t (&tl)[4][4]) {
  const int k = j / 2, i = j % 2 * 2;
  split_bf16(v[0], v[1], hd[k][i], tl[k][i]);
  split_bf16(v[2], v[3], hd[k][i + 1], tl[k][i + 1]);
}

// Phase 1, bf16: one warpgroup per (head, chunk, batch).  It writes the
// chunk's cum and dt to scratch for phases 3 and 4 (chunk 0 too), then
// Q_c [P, N] = (exp(cum) dy)^T . C on the tensor cores: the weighted dy
// rows, written by the warpgroup as bf16 head and tail panels in dy's
// swizzled layout, an MN-major A; C an MN-major B from the TMA tile.  One
// thread keeps a ring of two (dy, C) stages in flight.
template <int P, int N>
__global__ void __launch_bounds__(128)
ssd_bwd_dstates_wgmma(const __grid_constant__ SsdMaps maps, const float* __restrict__ dt,
                      const float* __restrict__ A, const float* __restrict__ dhT,
                      float* __restrict__ dstates, float* __restrict__ decay,
                      float* __restrict__ dh0, Scr sc, const BwdDims a, int direct) {
  using Tl = Tiles<P, N>;
  constexpr int NP = Tl::NP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int Lpad = round_up(a.L, kT);
  unsigned char* wyh = base + 2 * Tl::kStage;  // the weighted dy: head, then tail
  unsigned char* wyt = wyh + Tl::kX;
  double* cum = reinterpret_cast<double*>(wyt + Tl::kX);  // [Lpad]
  float* wst = reinterpret_cast<float*>(cum + Lpad);       // [Lpad] dt, then exp(cum_l)
  uint64_t* full = reinterpret_cast<uint64_t*>(wst + Lpad);

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, cq = lane % 4;
  const int g = h / (a.H / a.G);
  const int c0 = c * a.L, Lc = min(a.L, a.S - c0), n_t = (Lc + kT - 1) / kT;
  const long long row0 = (long long)b * a.S + c0;
  auto load = [&](int t) {  // (dy, C) tokens t * 64.. of the chunk into stage t % 2
    unsigned char* st = base + t % 2 * Tl::kStage;
    mbar_expect_tx(&full[t % 2], Tl::kStage);
    tma_tile<64>(st, kPanel, &maps.dy, &full[t % 2], h, c0 + t * kT, b);
    tma_tile<NP>(st + Tl::kX, kPanel, &maps.C, &full[t % 2], g, c0 + t * kT, b);
  };
  const bool q_c = c > 0 || dh0;  // only dh0 needs chunk 0's term
  if (tid == 0 && q_c) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load(0);
    if (n_t > 1) load(1);
  }
  chunk_cumsum(dt + row0 * a.H + h, a.H, A[h], Lc, Lpad, wst, cum);
  const long long chunk = ((long long)b * a.nc + c) * a.H + h;
  for (int i = tid; i < Lpad; i += 128) {  // cum and dt for phases 3 and 4
    sc.cum[chunk * Lpad + i] = cum[i];
    sc.dts[chunk * Lpad + i] = wst[i];
  }
  if (!q_c) return;
  __syncthreads();  // dt is read before it becomes exp(cum)
  for (int i = tid; i < Lpad; i += 128) wst[i] = i < Lc ? exp2f((float)cum[i]) : 0.f;
  const float dec = exp2f((float)cum[Lc - 1]);
  if (!direct && tid == 0) decay[chunk] = dec;
  __syncthreads();

  float acc[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
  const uint64_t hdesc = sw128_desc(wyh, kPanel), tdesc = sw128_desc(wyt, kPanel);
  for (int t = 0; t < n_t; ++t) {
    const unsigned char* ys = base + t % 2 * Tl::kStage;
    const unsigned char* cs = ys + Tl::kX;
    mbar_wait(&full[t % 2], t / 2 & 1);
    // exp(cum_l) dy_l, as head and tail at the same swizzled places (a row
    // of a panel is 128 bytes whatever its chunks' order)
    for (int i = tid; i < Tl::kX / 16; i += 128) {
      const int o = i * 16;
      const float w = wst[t * kT + o / kRowBytes];
      const uint4 v = *reinterpret_cast<const uint4*>(ys + o);
      const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&v);
      uint32_t hd[4], tl[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(v2[q]);
        split_bf16(f.x * w, f.y * w, hd[q], tl[q]);
      }
      *reinterpret_cast<uint4*>(wyh + o) = make_uint4(hd[0], hd[1], hd[2], hd[3]);
      *reinterpret_cast<uint4*>(wyt + o) = make_uint4(tl[0], tl[1], tl[2], tl[3]);
    }
    fence_proxy_async();
    __syncthreads();
    const uint64_t cdesc = sw128_desc(cs, kPanel);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kT / 16; ++k)
      wgmma_ss<NP, 1, 1>(acc, hdesc + mnmajor_step(k), cdesc + mnmajor_step(k), t > 0 || k > 0);
#pragma unroll
    for (int k = 0; k < kT / 16; ++k)
      wgmma_ss<NP, 1, 1>(acc, tdesc + mnmajor_step(k), cdesc + mnmajor_step(k), 1);
    wgmma_commit();
    wgmma_wait<0>();
    acc_fence(acc);
    __syncthreads();  // the stage and the weighted dy are free
    if (tid == 0 && t + 2 < n_t) {
      fence_proxy_async();
      load(t + 2);
    }
  }
  const long long hoff = ((long long)b * a.H + h) * P * N;
  float* out = direct ? dh0 + hoff : dstates + (((long long)b * a.nc + c) * a.H + h) * P * N;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int p = warp * 16 + lane / 4 + 8 * hf;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int e = p * N + 8 * j + 2 * cq;
      float2 q = make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
      if (direct && dhT) {
        q.x = fmaf(dec, dhT[hoff + e], q.x);
        q.y = fmaf(dec, dhT[hoff + e + 1], q.y);
      }
      *reinterpret_cast<float2*>(out + e) = q;
    }
  }
}

// Shared memory of a key-side or query-side block: the fixed tile (B on the
// key side, C on the query side: one group's, shared by the run's heads),
// the current head's own tile (x, or dy), a state's head and tail panels
// (dh[c+1], or h_in[c]; the bulk copy of the next head's fp32 state lands
// there first), two stages of walk tiles ((dy, C), or (x, B)), then the
// doubles (the key side's R terms, where the query side keeps its
// diagonal tile's cum and dt), cum, dt, the decay factors and the
// barriers.  About 111 KB at L 256: two blocks an SM.
template <int P, int N>
struct SideSmem {
  using Tl = Tiles<P, N>;
  unsigned char* base;
  int Lpad;
  __device__ SideSmem(unsigned char* raw, int lpad) : base(align1024(raw)), Lpad(lpad) {}
  __device__ unsigned char* fixed() const { return base; }
  __device__ unsigned char* own() const { return base + Tl::kBC; }
  __device__ unsigned char* state(int tail) const { return own() + Tl::kX + tail * Tl::kBC; }
  __device__ unsigned char* walk_a(int st) const {
    return base + 3 * Tl::kBC + Tl::kX + st * Tl::kStage;
  }
  __device__ unsigned char* walk_b(int st) const { return walk_a(st) + Tl::kX; }
  __device__ double* rred() const { return reinterpret_cast<double*>(base + Tl::kSideTiles); }
  __device__ double* dcum() const { return rred(); }  // [64] (query side)
  __device__ float* ddts() const { return reinterpret_cast<float*>(rred() + kT); }  // [64]
  __device__ double* red() const { return rred() + 4 * kT; }
  __device__ double* cum() const { return red() + 4; }
  __device__ float* dts() const { return reinterpret_cast<float*>(cum() + Lpad); }
  __device__ float* xt() const { return dts() + Lpad; }  // one decay factor per token
  __device__ uint64_t* full() const { return reinterpret_cast<uint64_t*>(xt() + Lpad); }
  __device__ uint64_t* empty() const { return full() + 2; }
  // the fixed tile, then each head's own tile
  __device__ uint64_t* own_full() const { return full() + 4; }
  __device__ uint64_t* own_empty() const { return full() + 5; }  // a head is done with its own tile
  __device__ uint64_t* cum_full() const { return full() + 6; }     // a head's cum and dt are in
  __device__ uint64_t* cum_empty() const { return full() + 7; }    // ... and read for the last time
  __device__ uint64_t* state_full() const { return full() + 8; }   // a head's fp32 state is in
  __device__ uint64_t* state_empty() const { return full() + 9; }  // ... and its panels read
  __device__ void init_barriers() const {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full()[s], 1);
      mbar_init(&empty()[s], 4);  // one arrival per consumer warp
    }
    mbar_init(own_full(), 1);
    mbar_init(own_empty(), 4);
    mbar_init(cum_full(), 1);
    mbar_init(cum_empty(), 4);
    mbar_init(state_full(), 1);
    mbar_init(state_empty(), 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// The start of head `hi` in a key- or query-side block, once the
// warpgroup is done with the last head: cum and dt from phase 1, by the
// producer's bulk copy (`cum_ready`), or with one chunk and no h0 (phase 1
// did not run) made here by warp 0 from dt; with `state`, the head's fp32
// state (dh[c+1] or h_in[c]), by the bulk copy too, turned into bf16 head
// and tail panels in place.  With `dot` (the key side's first tile) it
// returns this thread's part of <state, dot>.
template <int P, int N>
__device__ __forceinline__ double head_setup(const SideSmem<P, N>& sm, int hi, bool cum_ready,
                                             const float* __restrict__ dtb, int stride,
                                             float A, int Lc, bool state,
                                             const float* __restrict__ dot) {
  consumer_sync();  // the last head's walk no longer reads the decay factors
  if (cum_ready) {
    mbar_wait(sm.cum_full(), hi & 1);
  } else if (threadIdx.x < 32) {
    float* dts = sm.dts();
    for (int i0 = threadIdx.x; i0 < sm.Lpad; i0 += 8 * 32) {
      float v[8];  // loaded first, then stored
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i = i0 + 32 * k;
        v[k] = i < Lc ? dtb[(long long)i * stride] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (i0 + 32 * k < sm.Lpad) dts[i0 + 32 * k] = v[k];
    }
    __syncwarp();
    warp_cumsum(dts, log2_rate<double>(A), sm.Lpad, sm.cum());
  }
  double part = 0.0;
  if (state) {
    mbar_wait(sm.state_full(), hi & 1);
    if (dot) part = state_dot<P, N>(sm.state(0), dot);
    convert_state<P, N>(sm.state(0), sm.state(1));
  }
  consumer_sync();
  return part;
}

// The decay of the pairs of two different 64-token tiles as a product of
// a row factor and a column factor, each the exp2 of an fp64 difference of
// cums rounded to fp32 (ref a token between the two tiles, so both
// exponents are <= 0 and nothing overflows): exp(cum_l - cum_s) =
// exp(cum_l - cum_ref) exp(cum_ref - cum_s).  xt[t] = exp(cum_t - cum_ref)
// for t in [lo, hi) (later), or exp(cum_ref - cum_t) (earlier); 0 past Lc.
// With `scale`, xt[t] is multiplied by scale[t].
__device__ __forceinline__ void decay_factors(float* xt, const double* cum, int lo, int hi,
                                              int Lc, double ref, bool later,
                                              const float* scale = nullptr) {
  for (int t = lo + tid_here(); t < hi; t += 128) {
    const float x = t < Lc ? exp2f((float)(later ? cum[t] - ref : ref - cum[t])) : 0.f;
    xt[t] = scale ? x * scale[t] : x;
  }
}

// the call's sizes are positive (the entry point checks them): 64-bit
// index arithmetic then needs no sign word for them
__device__ __forceinline__ void assume_positive(const BwdDims& a) {
  __builtin_assume(a.Bsz > 0 && a.S > 0 && a.H > 0 && a.G > 0 && a.L > 0 && a.nc > 0 &&
                   a.ns >= 0 && a.runs > 0);
}

// the (tile, head run, batch, chunk) of a key- or query-side block: tile
// major, so the heaviest tiles of every chunk start first; the runs of one
// (batch, chunk) are neighbours (they read the same B and C rows)
struct SideItem {
  int tile, run, b, c, g, h_begin, nh;
  __device__ SideItem(const BwdDims& a, int block) {
    const int G = fresh(a.G), runs = fresh(a.runs), nc = fresh(a.nc);
    const int n_runs = G * runs, per_tile = n_runs * fresh(a.Bsz) * nc;
    tile = block / per_tile;
    run = block % n_runs;
    const int bc = block % per_tile / n_runs;
    b = bc / nc;
    c = bc % nc;
    const int rep = fresh(a.H) / G;
    g = run / runs;
    h_begin = g * rep + run % runs * kHpb;
    nh = min(kHpb, (g + 1) * rep - h_begin);
  }
};

// One producer thread: each head's cum and dt (from phase 1's scratch,
// when it ran) and its fp32 state (when there is one) by bulk copies, a
// head ahead of the consumer, each once the last head has read its own.
// Everything is made anew for each head (this warpgroup has 24 registers).
template <int P, int N>
__device__ __forceinline__ void prefetch_heads(unsigned char* smem_raw, const Scr& sc,
                                               const BwdDims& a, bool keys, const float* h0,
                                               const float* states, const float* dhT) {
  for (int hi = 0;; ++hi) {
    const SideItem w(a, block_here());
    if (hi >= w.nh) break;
    const SideSmem<P, N> sm(smem_raw, round_up(fresh(a.L), kT));
    const int h = w.h_begin + hi;
    const long long chunk = ((long long)w.b * a.nc + w.c) * a.H + h;
    if (a.nc > 1 || h0) {  // phase 1 ran
      if (hi > 0) mbar_wait(sm.cum_empty(), (hi - 1) & 1);
      mbar_expect_tx(sm.cum_full(), sm.Lpad * 12);
      bulk_load(sm.cum(), sc.cum + chunk * sm.Lpad, sm.Lpad * 8, sm.cum_full());
      bulk_load(sm.dts(), sc.dts + chunk * sm.Lpad, sm.Lpad * 4, sm.cum_full());
    }
    const long long bh = (long long)w.b * a.H + h;
    // the key side's dh[c+1] (the state pass's slot of the next chunk, or
    // dhT); the query side's h_in[c] (h0, or the forward's slot)
    const float* st =
        keys ? (w.c < a.nc - 1 ? sc.dstates + (chunk + a.H) * P * N
                               : (dhT ? dhT + bh * P * N : nullptr))
             : (w.c == 0 ? (h0 ? h0 + bh * P * N : nullptr)
                         : states + (((long long)w.b * a.ns + w.c - 1) * a.H + h) * P * N);
    if (st) {
      if (hi > 0) mbar_wait(sm.state_empty(), (hi - 1) & 1);
      mbar_expect_tx(sm.state_full(), P * N * 4);
      bulk_load(sm.state(0), st, P * N * 4, sm.state_full());
    }
  }
}

// sum over the 4 threads of a quad (the columns of an accumulator row)
__device__ __forceinline__ double quad_sum(double v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// v[q]: this thread's terms of 4 accumulator columns.  Returns the sum
// over the 8 lanes of one lane % 4 (a warp's 16 rows) of column q = 2 bit4
// + bit3 of the lane (lanes that differ in bit 2 get the same sum): a
// reduce-scatter in 4 shuffles
__device__ __forceinline__ double row_sum4(const double (&v)[4], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8;
  double a[2];
#pragma unroll
  for (int k = 0; k < 2; ++k)
    a[k] = (b4 ? v[k + 2] : v[k]) + __shfl_xor_sync(0xffffffffu, b4 ? v[k] : v[k + 2], 16);
  const double c = (b3 ? a[1] : a[0]) + __shfl_xor_sync(0xffffffffu, b3 ? a[0] : a[1], 8);
  return c + __shfl_xor_sync(0xffffffffu, c, 4);
}

// Phase 3, bf16: one 64-key tile of `nh` heads of one group.  The producer
// warpgroup streams the (dy, C) query tiles of each head's walk; the
// consumer warpgroup (thread rows: keys warp * 16 + lane / 4, + 8) keeps
// the run's dB in registers across its heads, and per head dx, U and V.
template <int P, int N>
__global__ void __launch_bounds__(kWThreads, 2)
ssd_bwd_keys_wgmma(const __grid_constant__ SsdMaps maps, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ h0,
                   const float* __restrict__ states, const float* __restrict__ dhT, Scr sc,
                   bf16* __restrict__ dx, const BwdDims a) {
  using Tl = Tiles<P, N>;
  constexpr int NP = Tl::NP;
  extern __shared__ unsigned char smem_raw[];
  const int Lpad = round_up(a.L, kT);
  {
    const SideItem w(a, blockIdx.x);
    if (w.tile * kT >= min(a.L, a.S - w.c * a.L)) return;  // past a short last chunk
  }
  if (threadIdx.x == 0) SideSmem<P, N>(smem_raw, Lpad).init_barriers();
  __syncthreads();

  // each warpgroup makes its own item, geometry and pointers: nothing is
  // carried across setmaxnreg (the producer's 24 registers would spill it)
  if (threadIdx.x >= 128) {  // producer warpgroup: one thread issues every copy
    setmaxnreg_producer();
    if (threadIdx.x == 128) {
      const SideSmem<P, N> sm(smem_raw, round_up(a.L, kT));
      const SideItem w(a, block_here());
      const int c0 = w.c * a.L, Lc = min(a.L, a.S - c0), s0 = w.tile * kT;
      // query tiles of the walk: the key tile's, then the later ones
      const int nt = (Lc - s0 + kT - 1) / kT;
      const int n_items = w.nh * nt;
      mbar_expect_tx(sm.own_full(), Tl::kBC + Tl::kX);
      tma_tile<NP>(sm.fixed(), kPanel, &maps.B, sm.own_full(), w.g, c0 + s0, w.b);
      tma_tile<64>(sm.own(), kPanel, &maps.x, sm.own_full(), w.h_begin, c0 + s0, w.b);
      for (int it = 0; it < n_items; ++it) {
        const int st = it % 2, hi = it / nt, l0 = c0 + s0 + it % nt * kT;
        mbar_wait(&sm.empty()[st], (it / 2 & 1) ^ 1);
        uint64_t* bar = &sm.full()[st];
        mbar_expect_tx(bar, Tl::kStage);
        tma_tile<64>(sm.walk_a(st), kPanel, &maps.dy, bar, w.h_begin + hi, l0, w.b);
        tma_tile<NP>(sm.walk_b(st), kPanel, &maps.C, bar, w.g, l0, w.b);
        if (it % nt == 0 && hi > 0) {  // x of head hi, once head hi - 1 is done with its own
          mbar_wait(sm.own_empty(), (hi - 1) & 1);
          mbar_expect_tx(sm.own_full(), Tl::kX);
          tma_tile<64>(sm.own(), kPanel, &maps.x, sm.own_full(), w.h_begin + hi, c0 + s0, w.b);
        }
      }
    } else if (threadIdx.x == 160) {
      prefetch_heads<P, N>(smem_raw, sc, a, true, h0, states, dhT);
    }
  } else {  // consumer warpgroup
    setmaxnreg_consumer();
    assume_positive(a);
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, cq = lane % 4;
    float db[NP / 2];  // the run's dB: its heads' terms, in order
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) db[i] = 0.f;
    for (int hi = 0;; ++hi) {
      // the item, its geometry and pointers, made anew for each head: only
      // hi and dB are carried across a head's walk
      const SideItem wv(a, block_here());
      if (hi >= wv.nh) break;
      const SideItem& w = wv;
      const int Lpad = round_up(fresh(a.L), kT);
      const SideSmem<P, N> sm(smem_raw, Lpad);
      const int c0 = w.c * a.L, Lc = min(a.L, a.S - c0), s0 = w.tile * kT;
      const int nt = (Lc - s0 + kT - 1) / kT;
      const long long row0 = (long long)w.b * a.S + c0;
      double* cum = sm.cum();
      float* dts = sm.dts();
      double* rred = sm.rred();
      const float* xt = sm.xt();
      const uint64_t fdesc = sw128_desc(sm.fixed(), kPanel), odesc = sw128_desc(sm.own(), kPanel);
      const uint64_t hdesc = sw128_desc(sm.state(0), kPanel);
      const uint64_t tdesc = sw128_desc(sm.state(1), kPanel);
      int srow[2];  // this thread's two keys (chunk positions)
      srow[0] = s0 + warp * 16 + lane / 4;
      srow[1] = srow[0] + 8;
      const int h = wv.h_begin + hi;
      const long long bh = (long long)wv.b * a.H + h;
      // the gradient of the state leaving this chunk (the pass's slot of the
      // next chunk, or dhT), and the state entering it (h0 or the forward's slot)
      const float* dho = wv.c < a.nc - 1
                             ? sc.dstates + (((long long)wv.b * a.nc + wv.c + 1) * a.H + h) * P * N
                             : (dhT ? dhT + bh * P * N : nullptr);
      const long long slot = ((long long)wv.b * fresh(a.ns) + wv.c - 1) * a.H + h;
      const float* hin = wv.c == 0 ? (h0 ? h0 + bh * P * N : nullptr) : states + slot * P * N;
      const long long chunk = ((long long)wv.b * a.nc + wv.c) * a.H + h;
      const bool cum_ready = a.nc > 1 || h0;
      const double dot =
          head_setup<P, N>(sm, hi, cum_ready, dt + ((long long)wv.b * a.S + c0) * a.H + h, a.H,
                           A[h], Lc, dho != nullptr, w.tile == 0 ? hin : nullptr);
      const double cum_last = cum[Lc - 1];
      if (w.tile == 0) {  // the chunk decay's term: exp(cum_L) <dh[c+1], h_in[c]>
        double part = dot;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        if (lane == 0) sm.red()[warp] = part;
        consumer_sync();
        if (tid == 0)
          sc.csc[chunk] =
              exp2((double)cum_last) * (sm.red()[0] + sm.red()[1] + sm.red()[2] + sm.red()[3]);
      }
      // the decay of a later query tile: xt[l] xt[s], through the key
      // tile's last token e
      const double cum_e = cum[min(s0 + kT, Lc) - 1];
      decay_factors(sm.xt(), cum, s0, s0 + kT, Lc, cum_e, false);
      decay_factors(sm.xt(), cum, s0 + kT, Lpad, Lc, cum_e, true);
      float dts_row[2], w_row[2];  // dt_s, w_s = exp(cum_L - cum_s)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        dts_row[hf] = dts[srow[hf]];
        w_row[hf] = srow[hf] < Lc ? exp2f((float)(cum_last - cum[srow[hf]])) : 0.f;
      }
      float dxa[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dxa[i] = 0.f;
      double u[2] = {0.0, 0.0}, v[2] = {0.0, 0.0};
      mbar_wait(sm.own_full(), hi & 1);  // B (with head 0) and this head's x
      if (dho) {  // the state terms: dh.B_s (p) and dh^T x_s (n)
        float tmp[NP / 2];
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < NP / 16; ++k)
          wgmma_ss<64>(dxa, fdesc + kmajor_step(k, kPanel), hdesc + kmajor_step(k, kPanel), k > 0);
#pragma unroll
        for (int k = 0; k < NP / 16; ++k)
          wgmma_ss<64>(dxa, fdesc + kmajor_step(k, kPanel), tdesc + kmajor_step(k, kPanel), 1);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_ss<NP, 0, 1>(tmp, odesc + kmajor_step(k, kPanel), hdesc + mnmajor_step(k), k > 0);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_ss<NP, 0, 1>(tmp, odesc + kmajor_step(k, kPanel), tdesc + mnmajor_step(k), 1);
        wgmma_commit();
        wgmma_wait<0>();
        acc_fence(dxa);
        acc_fence(tmp);
        release(sm.state_empty(), lane);  // the panels are read: the next head's state may come
        // V_s = w_s x_s . (dh B_s); then both terms times w_s dt_s
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          double part = 0.0;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 xv = tile_pair(sm.own(), srow[hf] - s0, 8 * j + 2 * cq);
            part += (double)xv.x * dxa[4 * j + 2 * hf] + (double)xv.y * dxa[4 * j + 2 * hf + 1];
          }
          v[hf] = (double)w_row[hf] * quad_sum(part);
          const float wd = w_row[hf] * dts_row[hf];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            dxa[4 * j + 2 * hf] *= wd;
            dxa[4 * j + 2 * hf + 1] *= wd;
          }
#pragma unroll
          for (int j = 0; j < NP / 8; ++j) {
            db[4 * j + 2 * hf] = fmaf(tmp[4 * j + 2 * hf], wd, db[4 * j + 2 * hf]);
            db[4 * j + 2 * hf + 1] = fmaf(tmp[4 * j + 2 * hf + 1], wd, db[4 * j + 2 * hf + 1]);
          }
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int s = s0 + tid_here() / 32 * 16 + tid_here() % 32 / 4 + 8 * hf;  // srow[hf]
        if (cq == 0 && s < Lc) sc.V[(row0 + s) * a.H + h] = v[hf];
      }
      consumer_sync();  // the decay factors are in

      for (int t = 0; t < nt; ++t) {  // the query tiles at or below the diagonal
        const int it = hi * nt + t, st = it % 2, l0 = s0 + t * kT;
        const uint64_t ydesc = sw128_desc(sm.walk_a(st), kPanel);
        const uint64_t cdesc = sw128_desc(sm.walk_b(st), kPanel);
        mbar_wait(&sm.full()[st], it / 2 & 1);
        float cb[32], gg[32];  // B_s . C_l and x_s . dy_l: 64 keys x 64 queries
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < NP / 16; ++k)
          wgmma_ss<64>(cb, fdesc + kmajor_step(k, kPanel), cdesc + kmajor_step(k, kPanel), k > 0);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_ss<64>(gg, odesc + kmajor_step(k, kPanel), ydesc + kmajor_step(k, kPanel), k > 0);
        wgmma_commit();
        wgmma_wait<0>();
        acc_fence(cb);
        acc_fence(gg);
        if (t == nt - 1) release(sm.own_empty(), lane);  // this head's x is read no more
        // decay; z = C.B D dy.x into U (this row) and R (this column); M =
        // C.B D dt_s and W = dy.x D dt_s in place of the score tiles
        auto decay = [&](auto diag) {
#pragma unroll
          for (int quarter = 0; quarter < 4; ++quarter) {
            // R's terms of the quarter's columns 8 (2 quarter + q / 2) + 2 cq + q % 2
            double rc[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) rc[q] = 0.0;
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const int j = 2 * quarter + jj;
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int hf = e >> 1, s = srow[hf];
                const int l = l0 + 8 * j + 2 * cq + (e & 1);
                float d;
                if constexpr (decltype(diag)::value)  // s <= l < Lc only: above, it would overflow
                  d = (s <= l && l < Lc) ? exp2f((float)(cum[l] - cum[s])) : 0.f;
                else
                  d = xt[l] * xt[s];
                const double z = (double)cb[4 * j + e] * d * (double)gg[4 * j + e];
                u[hf] += z;
                rc[2 * jj + (e & 1)] = fma(z, (double)dts_row[hf], rc[2 * jj + (e & 1)]);
                cb[4 * j + e] *= d * dts_row[hf];
                gg[4 * j + e] *= d * dts_row[hf];
              }
            }
            const int ln = tid_here() % 32;  // made here, not carried: lane
            const int q = (ln >> 4 & 1) * 2 + (ln >> 3 & 1);
            const double r = row_sum4(rc, ln);
            if (!(ln & 4))
              rred[tid_here() / 32 * kT + 8 * (2 * quarter + q / 2) + 2 * (ln % 4) + q % 2] = r;
          }
        };
        if (t == 0) {
          decay(std::true_type{});
          if (cum_ready) release(sm.cum_empty(), lane);  // cum and dt are read no more
        } else {
          decay(std::false_type{});
        }
        uint32_t wh[4][4], wt[4][4], mh[4][4], mt[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float w4[4] = {gg[4 * j], gg[4 * j + 1], gg[4 * j + 2], gg[4 * j + 3]};
          frag_pair(w4, j, wh, wt);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float m4[4] = {cb[4 * j], cb[4 * j + 1], cb[4 * j + 2], cb[4 * j + 3]};
          frag_pair(m4, j, mh, mt);
        }
        wgmma_fence();  // dx += M . dy and dB += W . C (dy and C MN-major)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          wgmma_rs<64>(dxa, mh[k], ydesc + mnmajor_step(k));
          wgmma_rs<64>(dxa, mt[k], ydesc + mnmajor_step(k));
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          wgmma_rs<NP>(db, wh[k], cdesc + mnmajor_step(k));
          wgmma_rs<NP>(db, wt[k], cdesc + mnmajor_step(k));
        }
        wgmma_commit();
        consumer_sync();  // every warp's R terms are in
        if (tid < kT && l0 + tid < Lc) {  // this key tile's share of R, warps in order
          const SideItem wr(a, block_here());  // made here: nothing carried across the walk
          sc.Rp[wr.tile * sc.rows + ((long long)wr.b * a.S + wr.c * a.L + l0 + tid) * a.H + h] =
              rred[tid] + rred[kT + tid] + rred[2 * kT + tid] + rred[3 * kT + tid];
        }
        wgmma_wait<0>();
        acc_fence(dxa);
        acc_fence(db);
        release(&sm.empty()[st], lane);
        consumer_sync();  // R is read before the next item writes it
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const double uh = quad_sum(u[hf]);
        const int s = s0 + tid_here() / 32 * 16 + tid_here() % 32 / 4 + 8 * hf;  // srow[hf]
        if (s < Lc) {
          const long long r = (row0 + s) * a.H + h;  // (token, head) row
#pragma unroll
          for (int j = 0; j < P / 8; ++j)
            *reinterpret_cast<uint32_t*>(dx + r * P + 8 * j + 2 * cq) =
                pack_bf16(dxa[4 * j + 2 * hf], dxa[4 * j + 2 * hf + 1]);
          if (cq == 0) sc.U[r] = uh;
        }
      }
    }
    // the run's dB, fp32 [B, S, G * runs, N]
    const SideItem we(a, block_here());  // made here: nothing carried across the walk
    const int n_runs = a.G * a.runs;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int s = we.tile * kT + tid_here() / 32 * 16 + tid_here() % 32 / 4 + 8 * hf;  // srow[hf]
      if (s >= min(a.L, a.S - we.c * a.L)) continue;
      float* out =
          sc.dBp + (((long long)we.b * a.S + we.c * a.L + s) * n_runs + we.run) * N + 2 * cq;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
        *reinterpret_cast<float2*>(out + 8 * j) =
            make_float2(db[4 * j + 2 * hf], db[4 * j + 2 * hf + 1]);
    }
  }
}

// Phase 4, bf16: one 64-query tile of `nh` heads of one group.  The
// producer streams the (x, B) key tiles of each head's walk; the consumer
// (thread rows: queries warp * 16 + lane / 4, + 8) keeps the run's dC in
// registers across its heads, and per head I.
template <int P, int N>
__global__ void __launch_bounds__(kWThreads, 2)
ssd_bwd_queries_wgmma(const __grid_constant__ SsdMaps maps, const float* __restrict__ dt,
                      const float* __restrict__ A, const float* __restrict__ h0,
                      const float* __restrict__ states, Scr sc, const BwdDims a) {
  using Tl = Tiles<P, N>;
  constexpr int NP = Tl::NP;
  extern __shared__ unsigned char smem_raw[];
  const int Lpad = round_up(a.L, kT);
  {
    const SideItem w(a, blockIdx.x);  // the heaviest (last) query tiles first
    if ((Lpad / kT - 1 - w.tile) * kT >= min(a.L, a.S - w.c * a.L)) return;
  }
  if (threadIdx.x == 0) SideSmem<P, N>(smem_raw, Lpad).init_barriers();
  __syncthreads();

  if (threadIdx.x >= 128) {  // as on the key side, each warpgroup makes its own item
    setmaxnreg_producer();
    if (threadIdx.x == 128) {
      const SideSmem<P, N> sm(smem_raw, round_up(a.L, kT));
      const SideItem w(a, block_here());
      const int lt = round_up(a.L, kT) / kT - 1 - w.tile;
      const int c0 = w.c * a.L, l0 = lt * kT;
      const int n_items = w.nh * (lt + 1);
      mbar_expect_tx(sm.own_full(), Tl::kBC + Tl::kX);
      tma_tile<NP>(sm.fixed(), kPanel, &maps.C, sm.own_full(), w.g, c0 + l0, w.b);
      tma_tile<64>(sm.own(), kPanel, &maps.dy, sm.own_full(), w.h_begin, c0 + l0, w.b);
      for (int it = 0; it < n_items; ++it) {
        const int st = it % 2, hi = it / (lt + 1), s0 = c0 + it % (lt + 1) * kT;
        mbar_wait(&sm.empty()[st], (it / 2 & 1) ^ 1);
        uint64_t* bar = &sm.full()[st];
        mbar_expect_tx(bar, Tl::kStage);
        tma_tile<64>(sm.walk_a(st), kPanel, &maps.x, bar, w.h_begin + hi, s0, w.b);
        tma_tile<NP>(sm.walk_b(st), kPanel, &maps.B, bar, w.g, s0, w.b);
        if (it % (lt + 1) == 0 && hi > 0) {  // dy of head hi, once head hi - 1 is done with its own
          mbar_wait(sm.own_empty(), (hi - 1) & 1);
          mbar_expect_tx(sm.own_full(), Tl::kX);
          tma_tile<64>(sm.own(), kPanel, &maps.dy, sm.own_full(), w.h_begin + hi, c0 + l0, w.b);
        }
      }
    } else if (threadIdx.x == 160) {
      prefetch_heads<P, N>(smem_raw, sc, a, false, h0, states, nullptr);
    }
  } else {
    setmaxnreg_consumer();
    assume_positive(a);
    const SideSmem<P, N> sm(smem_raw, Lpad);
    const SideItem w(a, block_here());
    const int lt = Lpad / kT - 1 - w.tile;
    const int c0 = w.c * a.L, Lc = min(a.L, a.S - c0), l0 = lt * kT;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, cq = lane % 4;
    const long long row0 = (long long)w.b * a.S + c0;
    double* cum = sm.cum();
    float* dts = sm.dts();
    const float* xt = sm.xt();
    const double* dcum = sm.dcum();
    const float* ddts = sm.ddts();
    const uint64_t odesc = sw128_desc(sm.own(), kPanel);
    const uint64_t hdesc = sw128_desc(sm.state(0), kPanel);
    const uint64_t tdesc = sw128_desc(sm.state(1), kPanel);
    int lrow[2];  // this thread's two queries (chunk positions)
    lrow[0] = l0 + warp * 16 + lane / 4;
    lrow[1] = lrow[0] + 8;
    float dc[NP / 2];  // the run's dC: its heads' terms, in order
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) dc[i] = 0.f;
    int it = 0;
    for (int hi = 0; hi < w.nh; ++hi) {
      const SideItem wv(a, block_here());  // the head's addresses are made here, not hoisted
      const int h = wv.h_begin + hi;
      const long long bh = (long long)wv.b * a.H + h;
      const long long slot = ((long long)wv.b * fresh(a.ns) + wv.c - 1) * a.H + h;
      const float* hin = wv.c == 0 ? (h0 ? h0 + bh * P * N : nullptr) : states + slot * P * N;
      const bool cum_ready = a.nc > 1 || h0;
      head_setup<P, N>(sm, hi, cum_ready, dt + ((long long)wv.b * a.S + c0) * a.H + h, a.H, A[h],
                       Lc, hin != nullptr, nullptr);
      // the decay from an earlier key tile: a_row xt[s] (dt_s folded in),
      // through the query tile's first token q; the diagonal tile's own cum
      // and dt are kept, so the next head's may come in
      const double cum_q = cum[l0];
      decay_factors(sm.xt(), cum, 0, l0, Lc, cum_q, false, dts);
      if (tid < kT) {
        sm.dcum()[tid] = cum[l0 + tid];
        sm.ddts()[tid] = dts[l0 + tid];
      }
      double cum_row[2];
      float a_row[2];  // exp(cum_l - cum_q)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        cum_row[hf] = cum[min(lrow[hf], Lc - 1)];
        a_row[hf] = lrow[hf] < Lc ? exp2f((float)(cum_row[hf] - cum_q)) : 0.f;
      }
      if (cum_ready) release(sm.cum_empty(), lane);  // cum and dt are read no more
      double e[2] = {0.0, 0.0};
      mbar_wait(sm.own_full(), hi & 1);  // C (with head 0) and this head's dy
      if (hin) {  // inter: h_in^T dy_l (h_in MN-major), weighted by exp(cum_l)
        float tmp[NP / 2];
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_ss<NP, 0, 1>(tmp, odesc + kmajor_step(k, kPanel), hdesc + mnmajor_step(k), k > 0);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_ss<NP, 0, 1>(tmp, odesc + kmajor_step(k, kPanel), tdesc + mnmajor_step(k), 1);
        wgmma_commit();
        wgmma_wait<0>();
        acc_fence(tmp);
        release(sm.state_empty(), lane);  // the panels are read: the next head's state may come
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float ex = lrow[hf] < Lc ? exp2f((float)cum_row[hf]) : 0.f;
          double part = 0.0;  // C_l . (h_in^T dy_l)
#pragma unroll
          for (int j = 0; j < NP / 8; ++j) {
            const float2 cv = tile_pair(sm.fixed(), lrow[hf] - l0, 8 * j + 2 * cq);
            part += (double)cv.x * tmp[4 * j + 2 * hf] + (double)cv.y * tmp[4 * j + 2 * hf + 1];
            dc[4 * j + 2 * hf] = fmaf(tmp[4 * j + 2 * hf], ex, dc[4 * j + 2 * hf]);
            dc[4 * j + 2 * hf + 1] = fmaf(tmp[4 * j + 2 * hf + 1], ex, dc[4 * j + 2 * hf + 1]);
          }
          e[hf] = (double)ex * quad_sum(part);
        }
      }
      consumer_sync();  // the decay factors are in

      for (int t = 0; t <= lt; ++t, ++it) {  // the key tiles at or below the diagonal
        const int st = it % 2, s0 = t * kT;
        const uint64_t xdesc = sw128_desc(sm.walk_a(st), kPanel);
        const uint64_t bdesc = sw128_desc(sm.walk_b(st), kPanel);
        mbar_wait(&sm.full()[st], it / 2 & 1);
        float gg[32];  // dy_l . x_s: 64 queries x 64 keys
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_ss<64>(gg, odesc + kmajor_step(k, kPanel), xdesc + kmajor_step(k, kPanel), k > 0);
        wgmma_commit();
        wgmma_wait<0>();
        acc_fence(gg);
        if (t == lt) release(sm.own_empty(), lane);  // this head's dy is read no more
        uint32_t wh[4][4], wt[4][4];  // W = dy.x D dt_s
        auto decay = [&](auto diag) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float w4[4];
#pragma unroll
            for (int e2 = 0; e2 < 4; ++e2) {
              const int hf = e2 >> 1, sk = s0 + 8 * j + 2 * cq + (e2 & 1), l = lrow[hf];
              if constexpr (decltype(diag)::value)
                w4[e2] = (sk <= l && l < Lc) ? gg[4 * j + e2] *
                                                   exp2f((float)(cum_row[hf] - dcum[sk - l0])) *
                                                   ddts[sk - l0]
                                             : 0.f;
              else
                w4[e2] = gg[4 * j + e2] * (a_row[hf] * xt[sk]);
            }
            frag_pair(w4, j, wh, wt);
          }
        };
        if (t == lt)
          decay(std::true_type{});
        else
          decay(std::false_type{});
        wgmma_fence();  // dC += W . B (B MN-major)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          wgmma_rs<NP>(dc, wh[k], bdesc + mnmajor_step(k));
          wgmma_rs<NP>(dc, wt[k], bdesc + mnmajor_step(k));
        }
        wgmma_commit();
        wgmma_wait<0>();
        acc_fence(dc);
        release(&sm.empty()[st], lane);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        if (lrow[hf] < Lc && cq == 0) sc.E[(row0 + lrow[hf]) * a.H + h] = e[hf];
    }
    // the run's dC, fp32 [B, S, G * runs, N]
    const int n_runs = a.G * a.runs;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (lrow[hf] >= Lc) continue;
      float* out = sc.dCp + ((row0 + lrow[hf]) * n_runs + w.run) * N + 2 * cq;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
        *reinterpret_cast<float2*>(out + 8 * j) =
            make_float2(dc[4 * j + 2 * hf], dc[4 * j + 2 * hf + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// phase 5: the decay gradient of each chunk
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kDecayThreads, 8)  // 64 registers: no spill, full occupancy
ssd_bwd_decay(const float* __restrict__ dt, const float* __restrict__ A, Scr sc,
              float* __restrict__ ddt, int S, int H, int L, int nc) {
  extern __shared__ __align__(16) float smem[];
  const int Lpad = round_up(L, kT);
  double* uv = reinterpret_cast<double*>(smem);  // [Lpad] U + V
  double* dc = uv + Lpad;     // [Lpad] dcum, then its reverse cumsum
  double* dv = dc + Lpad;     // [Lpad] dt V
  double* red = dv + Lpad;    // [kDecayThreads / 32]
  float* dts = reinterpret_cast<float*>(red + kDecayThreads / 32);  // [Lpad]
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int c0 = c * L, Lc = min(L, S - c0);
  const long long row0 = (long long)b * S + c0;
  const long long chunk = ((long long)b * nc + c) * H + h;
  for (int t = threadIdx.x; t < Lpad; t += kDecayThreads) {
    float d = 0.f;
    double s = 0.0, e = 0.0, vv = 0.0;
    if (t < Lc) {
      const long long r = (row0 + t) * H + h;
      d = dt[r];
      vv = sc.V[r];
      s = sc.U[r] + vv;
      e = sc.E[r];
      for (int st = 0; st <= t / kT; ++st) e += sc.Rp[st * sc.rows + r];  // R, in order
    }
    dts[t] = d;
    uv[t] = s;
    dc[t] = e - d * s;
    dv[t] = d * vv;
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // one warp: the chunk-end term, then the reverse cumsum
    const int lane = threadIdx.x, per = Lpad / 32, i0 = lane * per;
    double sv = 0.0;
    for (int i = i0; i < i0 + per; ++i) sv += dv[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sv += __shfl_xor_sync(0xffffffffu, sv, o);
    if (lane == 0) dc[Lc - 1] += sv + sc.csc[chunk];
    __syncwarp();
    double seg = 0.0;
    for (int i = i0; i < i0 + per; ++i) seg += dc[i];
    double incl = seg;  // this lane's segment and every one after it
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double n = __shfl_down_sync(0xffffffffu, incl, o);
      if (lane + o < 32) incl += n;
    }
    double run = incl - seg;
    for (int i = i0 + per - 1; i >= i0; --i) {
      run += dc[i];
      dc[i] = run;
    }
  }
  __syncthreads();
  const double a = A[h];
  double part = 0.0;
  for (int t = threadIdx.x; t < Lc; t += kDecayThreads) {
    ddt[(row0 + t) * H + h] = (float)fma(a, dc[t], uv[t]);
    part = fma((double)dts[t], dc[t], part);
  }
  const double tot = block_sum(part, red);
  if (threadIdx.x == 0) sc.dAp[chunk] = tot;
}

// ---------------------------------------------------------------------------
// phase 6: dB and dC over the partials of each group, dA over (batch, chunk)
// ---------------------------------------------------------------------------
// one thread per (token, group, n) of dB and dC, summing the group's `runs`
// partials (a head each in fp32, a run of kHpb heads in bf16); the last
// block sums dA
template <typename T>
__global__ void __launch_bounds__(256)
ssd_bwd_reduce(Scr sc, T* __restrict__ dB, T* __restrict__ dC, float* __restrict__ dA,
               long long n_out, int H, int G, int N, int nbc, int runs) {
  if (blockIdx.x == gridDim.x - 1) {
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      double s = 0.0;
      for (int r = 0; r < nbc; ++r) s += sc.dAp[(long long)r * H + h];
      dA[h] = (float)s;
    }
    return;
  }
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const int n = (int)(i % N);
  const long long tg = i / N;  // (token, group)
  const long long base = tg * runs * N + n;
  float sb = 0.f, scc = 0.f;
  for (int j = 0; j < runs; ++j) {
    sb += sc.dBp[base + (long long)j * N];
    scc += sc.dCp[base + (long long)j * N];
  }
  dB[i] = from_f32<T>(sb);
  dC[i] = from_f32<T>(scc);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
struct BwdCall {
  const void *x, *dt, *A, *Bm, *Cm, *h0, *states, *dy, *dhT;
  void *dx, *ddt, *dA, *dB, *dC, *dh0;
  Scr sc;
  int Bsz, S, H, G, L, nc, ns, runs;
  cudaStream_t s;
};

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// heads per dB / dC partial: a run of kHpb in bf16, one in fp32
int heads_per_run(int dtype) { return dtype == 1 ? kHpb : 1; }

// bf16 phases 1, 3 and 4 (TMA and wgmma)
template <int P, int N>
cudaError_t run_bwd_wgmma(const BwdCall& a) {
  using Tl = Tiles<P, N>;
  const int Lpad = round_up(a.L, kT);
  const float* dt = static_cast<const float*>(a.dt);
  const float* A = static_cast<const float*>(a.A);
  const float* h0 = static_cast<const float*>(a.h0);
  const float* states = static_cast<const float*>(a.states);
  const float* dhT = static_cast<const float*>(a.dhT);
  float* dh0 = static_cast<float*>(a.dh0);
  if (encode_tiled() == nullptr) return cudaErrorSymbolNotFound;
  SsdMaps maps;
  if (!rows_map(&maps.x, a.x, P, a.H, a.S, a.Bsz, kT) ||
      !rows_map(&maps.dy, a.dy, P, a.H, a.S, a.Bsz, kT) ||
      !rows_map(&maps.B, a.Bm, N, a.G, a.S, a.Bsz, kT) ||
      !rows_map(&maps.C, a.Cm, N, a.G, a.S, a.Bsz, kT))
    return cudaErrorInvalidValue;
  const BwdDims dims{a.Bsz, a.S, a.H, a.G, a.L, a.nc, a.ns, a.runs};
  cudaError_t err;
  if (a.nc > 1 || dh0) {  // phase 1 (with one chunk: straight to dh0)
    const int bytes = Tl::dstates_bytes(Lpad);
    if ((err = allow_smem(ssd_bwd_dstates_wgmma<P, N>, bytes)) != cudaSuccess) return err;
    ssd_bwd_dstates_wgmma<P, N><<<dim3(a.H, a.nc, a.Bsz), 128, bytes, a.s>>>(
        maps, dt, A, dhT, a.sc.dstates, a.sc.decay, dh0, a.sc, dims, a.nc == 1);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (a.nc > 1) {  // phase 2
    const long long n4 = (long long)a.Bsz * a.H * P * N / 4;
    ssd_bwd_state_pass<<<(unsigned)((n4 + 255) / 256), 256, 0, a.s>>>(
        a.sc.dstates, a.sc.decay, dhT, dh0, a.Bsz, a.H, P * N, a.nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)(Lpad / kT * a.G * a.runs * a.Bsz * a.nc);
  const int bytes = Tl::side_bytes(Lpad);
  if ((err = allow_smem(ssd_bwd_keys_wgmma<P, N>, bytes)) != cudaSuccess) return err;
  ssd_bwd_keys_wgmma<P, N><<<blocks, kWThreads, bytes, a.s>>>(
      maps, dt, A, h0, states, dhT, a.sc, static_cast<bf16*>(a.dx), dims);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(ssd_bwd_queries_wgmma<P, N>, bytes)) != cudaSuccess) return err;
  ssd_bwd_queries_wgmma<P, N><<<blocks, kWThreads, bytes, a.s>>>(maps, dt, A, h0, states,
                                                                  a.sc, dims);
  return cudaGetLastError();
}

// fp32 phases 1, 3 and 4 (CUDA cores)
template <int P, int N>
cudaError_t run_bwd_simt(const BwdCall& a) {
  using T = float;
  const int Lpad = round_up(a.L, kT);
  const T* x = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.Bm);
  const T* Cm = static_cast<const T*>(a.Cm);
  const T* dy = static_cast<const T*>(a.dy);
  const float* dt = static_cast<const float*>(a.dt);
  const float* A = static_cast<const float*>(a.A);
  const float* h0 = static_cast<const float*>(a.h0);
  const float* states = static_cast<const float*>(a.states);
  const float* dhT = static_cast<const float*>(a.dhT);
  float* dh0 = static_cast<float*>(a.dh0);
  cudaError_t err;
  if (a.nc > 1 || dh0) {  // phase 1 (with one chunk: straight to dh0)
    const int bytes = dstates_floats(P, N, Lpad) * (int)sizeof(float);
    if ((err = allow_smem(ssd_bwd_dstates<P, N, T>, bytes)) != cudaSuccess) return err;
    ssd_bwd_dstates<P, N, T><<<dim3(a.H, a.nc, a.Bsz), kSimtThreads, bytes, a.s>>>(
        dy, dt, A, Cm, dhT, a.sc.dstates, a.sc.decay, dh0, a.S, a.H, a.G, a.L, a.nc,
        a.nc == 1);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (a.nc > 1) {  // phase 2
    const long long n4 = (long long)a.Bsz * a.H * P * N / 4;
    ssd_bwd_state_pass<<<(unsigned)((n4 + 255) / 256), 256, 0, a.s>>>(
        a.sc.dstates, a.sc.decay, dhT, dh0, a.Bsz, a.H, P * N, a.nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const dim3 tiles(Lpad / kT, a.H, a.Bsz * a.nc);
  int bytes = keys_floats(P, N, Lpad) * (int)sizeof(float);
  if ((err = allow_smem(ssd_bwd_keys<P, N, T>, bytes)) != cudaSuccess) return err;
  ssd_bwd_keys<P, N, T><<<tiles, kSimtThreads, bytes, a.s>>>(
      x, dt, A, Bm, Cm, dy, h0, states, dhT, a.sc, static_cast<T*>(a.dx), a.S, a.H, a.G, a.L,
      a.nc, a.ns);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bytes = queries_floats(P, N, Lpad) * (int)sizeof(float);
  if ((err = allow_smem(ssd_bwd_queries<P, N, T>, bytes)) != cudaSuccess) return err;
  ssd_bwd_queries<P, N, T><<<tiles, kSimtThreads, bytes, a.s>>>(
      x, dt, A, Bm, Cm, dy, h0, states, a.sc, a.S, a.H, a.G, a.L, a.nc, a.ns);
  return cudaGetLastError();
}

template <int P, int N, typename T>
cudaError_t run_bwd(const BwdCall& a) {
  const int Lpad = round_up(a.L, kT);
  cudaError_t err;
  if constexpr (std::is_same_v<T, bf16>)
    err = run_bwd_wgmma<P, N>(a);
  else
    err = run_bwd_simt<P, N>(a);
  if (err != cudaSuccess) return err;
  const int bytes = (7 * Lpad + 2 * (kDecayThreads / 32)) * (int)sizeof(float);  // phase 5
  ssd_bwd_decay<<<dim3(a.H, a.nc, a.Bsz), kDecayThreads, bytes, a.s>>>(
      static_cast<const float*>(a.dt), static_cast<const float*>(a.A), a.sc,
      static_cast<float*>(a.ddt), a.S, a.H, a.L, a.nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n_out = (long long)a.Bsz * a.S * a.G * N;  // phase 6
  ssd_bwd_reduce<T><<<(unsigned)((n_out + 255) / 256 + 1), 256, 0, a.s>>>(
      a.sc, static_cast<T*>(a.dB), static_cast<T*>(a.dC), static_cast<float*>(a.dA), n_out,
      a.H, a.G, N, a.Bsz * a.nc, a.runs);
  return cudaGetLastError();
}

}  // namespace

// dtype (of x, Bm, Cm, dy, dx, dB, dC): 0 = float32, 1 = bfloat16 (x, Bm,
// Cm and dy 16-byte aligned: they are read by TMA).  h0, dhT and dh0 may be
// null (dh0 is written iff h0 is given).  With L = min(chunk, S) and nc =
// ceil(S / L) chunks, `states` is the forward call's scratch of ns slots
// ([B, ns, H, P, N] fp32; slot c - 1 holds the state entering chunk c),
// needed when nc > 1.  `scratch` (16-byte aligned) holds, in this order:
// three [B, S, H], two [B, nc, H] and ceil(L / 64) [B, S, H] fp64; from
// the next 16-byte boundary one [B, nc, H, Lpad] fp64 (Lpad = L rounded up
// to 64); from the next, [B, nc, H, Lpad] fp32, with nc > 1 [B, nc, H, P,
// N] and [B, nc, H] fp32, and two [B, S, G * R, N] fp32, the dB and dC partials of
// each run of heads, with R = ceil(H / G / heads) runs per group of
// `heads` = 4 heads in bf16, 1 in fp32.  Returns the first CUDA error of
// the launches (0 on success).
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* h0, const void* states, int ns,
                            const void* dy, const void* dhT, void* dx, void* ddt, void* dA,
                            void* dB, void* dC, void* dh0, void* scratch, int Bsz, int S,
                            int H, int P, int G, int N, int chunk, int dtype, void* stream) {
  if (Bsz <= 0 || S <= 0 || G <= 0 || H % G != 0 || chunk <= 0 || chunk > kLMax)
    return cudaErrorInvalidValue;
  if ((h0 == nullptr) != (dh0 == nullptr)) return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  BwdCall a{x, dt, A, Bm, Cm, h0, states, dy, dhT, dx, ddt, dA, dB, dC, dh0, {},
            Bsz, S, H, G, 0, 0, ns, 0, static_cast<cudaStream_t>(stream)};
  a.L = chunk < S ? chunk : S;
  a.nc = (S + a.L - 1) / a.L;
  a.runs = (H / G + heads_per_run(dtype) - 1) / heads_per_run(dtype);
  if (a.nc > 1 && (!states || ns < a.nc - 1)) return cudaErrorInvalidValue;
  const long long rows = (long long)Bsz * S * H, chunks = (long long)Bsz * a.nc * H;
  double* d = static_cast<double*>(scratch);
  a.sc.U = d;
  a.sc.V = d + rows;
  a.sc.E = d + 2 * rows;
  a.sc.csc = d + 3 * rows;
  a.sc.dAp = d + 3 * rows + chunks;
  const int Lpad = round_up(a.L, kT);
  a.sc.Rp = d + 3 * rows + 2 * chunks;
  a.sc.cum = reinterpret_cast<double*>(  // 16-byte aligned for the bulk copies
      (reinterpret_cast<uintptr_t>(a.sc.Rp + Lpad / kT * rows) + 15) & ~uintptr_t(15));
  a.sc.rows = rows;
  float* f = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(a.sc.cum + chunks * Lpad) + 15) & ~uintptr_t(15));
  a.sc.dts = f;
  f += chunks * Lpad;
  if (a.nc > 1) {
    a.sc.dstates = f;
    f += chunks * P * N;
    a.sc.decay = f;
    f += chunks;
  }
  a.sc.dBp = f;
  a.sc.dCp = f + (long long)Bsz * S * G * a.runs * N;
  if (dtype == 1) {
    if (P == 32 && N == 16) return run_bwd<32, 16, bf16>(a);
    if (P == 64 && N == 128) return run_bwd<64, 128, bf16>(a);
    if (P == 64 && N == 16) return run_bwd<64, 16, bf16>(a);
  } else {
    if (P == 32 && N == 16) return run_bwd<32, 16, float>(a);
    if (P == 64 && N == 128) return run_bwd<64, 128, float>(a);
    if (P == 64 && N == 16) return run_bwd<64, 16, float>(a);
  }
  return cudaErrorInvalidValue;
}
