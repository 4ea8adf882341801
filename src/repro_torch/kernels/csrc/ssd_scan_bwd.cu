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
// runs its two heavy phases (3, 4) on the tensor cores with `mma.sync`,
// the fp32 score and state operands as a bf16 head and remainder (which
// doubles those products); fp32 runs them on CUDA cores (TF32 would miss
// the fp32 bound of 2e-3); phase 1 runs on CUDA cores for both.
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
//   1. Chunk state gradients (`ssd_bwd_dstates`), one block per (head,
//      chunk, batch): the chunk's cumsum, exp(cum_L) to `decay`, and Q_c,
//      a [P, L].[L, N] product, to scratch (chunk 0 only for dh0; with one
//      chunk it writes dh0 = exp(cum_L) dhT + Q_0 itself).
//   2. Reverse state pass (`ssd_bwd_state_pass`), one thread per 4 state
//      entries of a (batch, head): walks the chunks from the last,
//      dh = decay_c dh + Q_c, and leaves dh[c] in slot c (and dh0).
//   3. Key side (`ssd_bwd_keys`), one block per (64-key tile, head, chunk
//      and batch): the state terms from dh[c+1], then over the query tiles
//      at or below the diagonal C.B^T and dy.x^T, decayed, into dx, the
//      head's dB, U, V and this key tile's terms of R for each query.  The
//      heaviest tiles (first in the chunk) first.
//   4. Query side (`ssd_bwd_queries`), one block per (64-query tile, head,
//      chunk and batch): the inter term from h_in[c], then over the key
//      tiles at or below the diagonal, into the head's dC and I.  It
//      recomputes dy.x^T (a tenth of the flops) rather than carry the
//      score tiles through device memory.
//   5. Decay gradient (`ssd_bwd_decay`), one block per (head, chunk,
//      batch): R from its key tiles' terms in order, dcum, its reverse
//      cumsum by one warp, ddt and the chunk's term of dA.
//   6. Reduction (`ssd_bwd_reduce`): dB and dC summed over the heads of a
//      group, and dA over (batch, chunk), each in a fixed order.
// Phases 3 and 4 have two bodies, chosen by dtype: bf16 on the tensor
// cores (`*_tc`, 4 warps of 16 rows), fp32 on CUDA cores (a 16 x 16 grid of
// threads on register tiles); the other phases are one body for both.
// Launches per call: 6 with several chunks; with one chunk 5 when h0 is
// given (phase 2 skipped), 4 without (phases 1 and 2 skipped).  Scratch
// comes from the caller; nothing is allocated or zeroed here.  No
// atomics: two calls give the same bits.
// Instantiated for (P, N) in {(32, 16), (64, 128)}, as the forward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include <type_traits>

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
  long long rows;   // B S H, Rp's stride
  float* dstates;   // [B, nc, H, P, N]  (more than one chunk)
  float* decay;     // [B, nc, H]        (more than one chunk)
  float* dBp;       // [B, S, H, N]      dB of each head
  float* dCp;       // [B, S, H, N]      dC of each head
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
// phases 3 and 4, bf16: tensor cores
// ---------------------------------------------------------------------------
// mma.sync.m16n8k16 bf16 x bf16 -> fp32, 4 warps of 16 rows per 64-row
// tile.  C.B^T and dy.x^T take exact bf16 operands; the fp32 operands (the
// decayed score tiles, dh[c+1] and h_in[c]) go in as a bf16 head plus its
// bf16 remainder, two mma.syncs on the same fragments of the other operand
// (~16 significant bits), as in the forward.  Tiles are bf16 in shared
// memory (rows padded by 16 bytes) and arrive by cp.async, the other
// side's tiles through a ring of two stages; dh[c+1] and h_in[c] arrive as
// fp32 in the ring's space and are used up before its first tile.
template <int P, int N>
struct BwdTc {
  static_assert(P % 16 == 0 && N % 16 == 0, "P and N are multiples of 16");
  static constexpr int kThreads = 128;
  static constexpr int kXs = P + kPad;  // bf16 row strides of x / dy and B / C tiles
  static constexpr int kNs = N + kPad;
  static constexpr int kHs = N + 8;     // fp32 row stride of dh / h_in
  static constexpr int kTile = kT * (kXs + kNs);  // bf16 elements of an (x|dy, B|C) pair
  static_assert(P * kHs * 4 <= kStages * kTile * 2, "the state fits the ring");
  // doubles: cum [Lpad], the R terms of each warp [4][kT], one per warp;
  // then dt [Lpad] fp32, the fixed tile pair and the ring (bf16)
  static int bytes(int Lpad) {
    return (Lpad + 4 * kT + 4) * 8 + Lpad * 4 + (1 + kStages) * kTile * 2;
  }
};

// an [rows][stride] fp32 state into shared memory rows of kHs floats
template <int P, int N>
__device__ __forceinline__ void cp_state(float* dst, const float* src) {
  for (int i = threadIdx.x; i < P * N / 4; i += BwdTc<P, N>::kThreads) {
    const int p = i / (N / 4), n = i % (N / 4) * 4;
    cp_async16(dst + p * BwdTc<P, N>::kHs + n, src + p * N + n, true);
  }
}

// B fragments of a [k][n] fp32 shared tile (row stride ld) at rows k0.. and
// column n0 + lane / 4, split into bf16 head and tail: b[0..1] head, t[0..1]
// tail (rows k0 + 2 (lane % 4) + {0, 1}, then + 8)
__device__ __forceinline__ void state_b_kn(const float* s, int ld, int k0, int n0,
                                           uint32_t (&hd)[2], uint32_t (&tl)[2]) {
  const int lane = threadIdx.x % 32;
  const float* p = s + (k0 + 2 * (lane % 4)) * ld + n0 + lane / 4;
  split_bf16(p[0], p[ld], hd[0], tl[0]);
  split_bf16(p[8 * ld], p[9 * ld], hd[1], tl[1]);
}

// the A fragments (head, tail) of a 16 x 16 block of fp32 accumulators: n8
// tiles 2 kk and 2 kk + 1 of `acc`
template <int M>
__device__ __forceinline__ void acc_a(const float (&acc)[M][4], int kk, uint32_t (&a)[4],
                                      uint32_t (&at)[4]) {
  split_bf16(acc[2 * kk][0], acc[2 * kk][1], a[0], at[0]);
  split_bf16(acc[2 * kk][2], acc[2 * kk][3], a[1], at[1]);
  split_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1], a[2], at[2]);
  split_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3], a[3], at[3]);
}

// acc [16 rows][8 M] += A (rows of `a_tile`, k over K) . B, B from an
// [n][k] bf16 tile (row stride ldb): the products of two token tiles
template <int K, int M>
__device__ __forceinline__ void mma_abt(float (&acc)[M][4], const __nv_bfloat16* a_tile,
                                        int lda, const __nv_bfloat16* b_tile, int ldb) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_tile + (warp * 16 + lane % 16) * lda + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < M / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, b_tile + (np * 16 + (lane / 16) * 8 + lane % 8) * ldb + kk * 16 +
                      ((lane / 8) % 2) * 8);
      mma_bf16(acc[2 * np], a, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], a, bf[2], bf[3]);
    }
  }
}

// acc [16 rows][M n8 tiles] += S (the fp32 scores [16][kT], as head and
// tail) . T, T a [kT][n] bf16 tile (row stride ldt)
template <int M>
__device__ __forceinline__ void mma_scores(float (&acc)[M][4], const float (&sc)[kT / 8][4],
                                           const __nv_bfloat16* t_tile, int ldt) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk) {
    uint32_t a[4], at[4];
    acc_a(sc, kk, a, at);
#pragma unroll
    for (int dp = 0; dp < M / 2; ++dp) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, t_tile + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * ldt + dp * 16 +
                            (lane / 16) * 8);
      mma_bf16(acc[2 * dp], a, bf[0], bf[1]);
      mma_bf16(acc[2 * dp + 1], a, bf[2], bf[3]);
      mma_bf16(acc[2 * dp], at, bf[0], bf[1]);
      mma_bf16(acc[2 * dp + 1], at, bf[2], bf[3]);
    }
  }
}

// sum over the 4 threads of a quad (the columns of a C fragment's row)
__device__ __forceinline__ double quad_sum(double v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Phase 3, bf16: one 64-key tile; warp w owns keys 16 w.. of it
template <int P, int N>
__global__ void __launch_bounds__(BwdTc<P, N>::kThreads)
ssd_bwd_keys_tc(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
                const __nv_bfloat16* __restrict__ Cm, const __nv_bfloat16* __restrict__ dy,
                const float* __restrict__ h0, const float* __restrict__ states,
                const float* __restrict__ dhT, Scr sc, __nv_bfloat16* __restrict__ dx, int S,
                int H, int G, int L, int nc, int ns) {
  using Sh = BwdTc<P, N>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int Lpad = round_up(L, kT);
  double* cum = reinterpret_cast<double*>(smem_raw);  // [Lpad]
  double* rred = cum + Lpad;                          // [4][kT]
  double* red = rred + 4 * kT;                        // [4]
  float* dts = reinterpret_cast<float*>(red + 4);     // [Lpad]
  __nv_bfloat16* xk = reinterpret_cast<__nv_bfloat16*>(dts + Lpad);  // [kT][kXs]
  __nv_bfloat16* bk = xk + kT * Sh::kXs;                               // [kT][kNs]
  __nv_bfloat16* ring = bk + kT * Sh::kNs;  // stages of (dy [kT][kXs], C [kT][kNs])
  float* dh = reinterpret_cast<float*>(ring);  // [P][kHs], until the first query tile

  const int st = blockIdx.x;  // key tile: the first has the most query tiles
  const int h = blockIdx.y, b = blockIdx.z / nc, c = blockIdx.z % nc;
  const int c0 = c * L, Lc = min(L, S - c0), s0 = st * kT;
  if (s0 >= Lc) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = h / (H / G);
  const long long tok = (long long)H * P, tokbc = (long long)G * N;
  const long long row0 = (long long)b * S + c0, bh = (long long)b * H + h;
  const __nv_bfloat16* xb = x + row0 * tok + (long long)h * P;
  const __nv_bfloat16* yb = dy + row0 * tok + (long long)h * P;
  const __nv_bfloat16* Bb = Bm + row0 * tokbc + (long long)g * N;
  const __nv_bfloat16* Cb = Cm + row0 * tokbc + (long long)g * N;
  const float* dho = c < nc - 1 ? sc.dstates + (((long long)b * nc + c + 1) * H + h) * P * N
                                : (dhT ? dhT + bh * P * N : nullptr);
  const float* hin = c == 0 ? (h0 ? h0 + bh * P * N : nullptr)
                            : states + (((long long)b * ns + c - 1) * H + h) * P * N;

  cp_tile<P, Sh::kXs>(xk, xb, tok, s0, Lc);
  cp_tile<N, Sh::kNs>(bk, Bb, tokbc, s0, Lc);
  if (dho) cp_state<P, N>(dh, dho);
  cp_async_commit();
  chunk_cumsum(dt + row0 * H + h, H, A[h], Lc, Lpad, dts, cum);
  cp_async_wait<0>();
  __syncthreads();
  const double cum_last = cum[Lc - 1];

  // this thread's two key rows and their weights dt_s and w_s = exp(cum_L - cum_s)
  int srow[2];
  float dts_row[2], w_row[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    srow[hf] = s0 + warp * 16 + lane / 4 + 8 * hf;
    dts_row[hf] = dts[srow[hf]];
    w_row[hf] = srow[hf] < Lc ? exp2f((float)(cum_last - cum[srow[hf]])) : 0.f;
  }
  float ax[P / 8][4], ab[N / 8][4];
#pragma unroll
  for (int i = 0; i < P / 8; ++i) ax[i][0] = ax[i][1] = ax[i][2] = ax[i][3] = 0.f;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) ab[i][0] = ab[i][1] = ab[i][2] = ab[i][3] = 0.f;
  double u[2] = {0.0, 0.0}, v[2] = {0.0, 0.0};
  if (dho) {  // the state terms: dh.B_s (p) and dh^T x_s (n)
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {  // dh B_s: k = n; B[n][p] = dh[p][n]
      uint32_t a[4];
      ldsm_x4(a, bk + (warp * 16 + lane % 16) * Sh::kNs + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int pp = 0; pp < P / 16; ++pp) {
        const float* hp = dh + (pp * 16 + lane / 4) * Sh::kHs + kk * 16 + 2 * (lane % 4);
        uint32_t bh4[4], bl4[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const float2 q = *reinterpret_cast<const float2*>(hp + (f / 2) * 8 * Sh::kHs +
                                                            (f % 2) * 8);
          split_bf16(q.x, q.y, bh4[f], bl4[f]);
        }
        mma_bf16(ax[2 * pp], a, bh4[0], bh4[1]);
        mma_bf16(ax[2 * pp + 1], a, bh4[2], bh4[3]);
        mma_bf16(ax[2 * pp], a, bl4[0], bl4[1]);
        mma_bf16(ax[2 * pp + 1], a, bl4[2], bl4[3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk) {  // dh^T x_s: k = p; B[p][n] = dh[p][n]
      uint32_t a[4];
      ldsm_x4(a, xk + (warp * 16 + lane % 16) * Sh::kXs + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt) {
        uint32_t hd[2], tl[2];
        state_b_kn(dh, Sh::kHs, kk * 16, nt * 8, hd, tl);
        mma_bf16(ab[nt], a, hd[0], hd[1]);
        mma_bf16(ab[nt], a, tl[0], tl[1]);
      }
    }
    // V_s = w_s x_s . (dh B_s); then both terms times w_s dt_s
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int k = warp * 16 + lane / 4 + 8 * hf;
      double part = 0.0;
#pragma unroll
      for (int pt = 0; pt < P / 8; ++pt) {
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            xk + k * Sh::kXs + pt * 8 + 2 * (lane % 4)));
        part += (double)xv.x * ax[pt][2 * hf] + (double)xv.y * ax[pt][2 * hf + 1];
      }
      v[hf] = (double)w_row[hf] * quad_sum(part);
      const float wd = w_row[hf] * dts_row[hf];
#pragma unroll
      for (int pt = 0; pt < P / 8; ++pt) {
        ax[pt][2 * hf] *= wd;
        ax[pt][2 * hf + 1] *= wd;
      }
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt) {
        ab[nt][2 * hf] *= wd;
        ab[nt][2 * hf + 1] *= wd;
      }
    }
  }
  if (st == 0) {  // the chunk decay's term: exp(cum_L) <dh[c+1], h_in[c]>
    double part = 0.0;
    if (dho && hin)
      for (int i = tid; i < P * N; i += Sh::kThreads)
        part += (double)dh[(i / N) * Sh::kHs + i % N] * hin[i];
    const double tot = block_sum(part, red);
    if (tid == 0) sc.csc[((long long)b * nc + c) * H + h] = exp2((double)cum_last) * tot;
  }
  __syncthreads();  // dh is no longer read: the ring overwrites it

  const int nt_q = (Lc - s0 + kT - 1) / kT;  // query tiles st .. st + nt_q - 1
  auto load = [&](int t) {
    __nv_bfloat16* ys = ring + (t % kStages) * Sh::kTile;
    cp_tile<P, Sh::kXs>(ys, yb, tok, s0 + t * kT, Lc);
    cp_tile<N, Sh::kNs>(ys + kT * Sh::kXs, Cb, tokbc, s0 + t * kT, Lc);
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nt_q) load(t);
    cp_async_commit();
  }
  for (int t = 0; t < nt_q; ++t) {
    if (t + kStages - 1 < nt_q) load(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();  // query tile t is in
    const __nv_bfloat16* ys = ring + (t % kStages) * Sh::kTile;
    const __nv_bfloat16* cs = ys + kT * Sh::kXs;
    const int l0 = s0 + t * kT;
    float cb[kT / 8][4], gg[kT / 8][4];
#pragma unroll
    for (int i = 0; i < kT / 8; ++i) {
      cb[i][0] = cb[i][1] = cb[i][2] = cb[i][3] = 0.f;
      gg[i][0] = gg[i][1] = gg[i][2] = gg[i][3] = 0.f;
    }
    mma_abt<N>(cb, bk, Sh::kNs, cs, Sh::kNs);  // B_s . C_l
    mma_abt<P>(gg, xk, Sh::kXs, ys, Sh::kXs);  // x_s . dy_l
    // decay; z = C.B D dy.x into U (this row) and R (this column); then
    // cb -> M = C.B D dt_s and gg -> W = dy.x D dt_s
#pragma unroll
    for (int n8 = 0; n8 < kT / 8; ++n8) {
      double rc[2] = {0.0, 0.0};  // R's terms of this thread's two columns
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1, s = srow[hf];
        const int l = l0 + n8 * 8 + 2 * (lane % 4) + (e & 1);
        const float d = (s <= l && l < Lc) ? exp2f((float)(cum[l] - cum[s])) : 0.f;
        const double z = (double)cb[n8][e] * d * (double)gg[n8][e];
        u[hf] += z;
        rc[e & 1] = fma(z, (double)dts_row[hf], rc[e & 1]);
        cb[n8][e] *= d * dts_row[hf];
        gg[n8][e] *= d * dts_row[hf];
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {  // over the warp's 16 rows
        rc[0] += __shfl_xor_sync(0xffffffffu, rc[0], o);
        rc[1] += __shfl_xor_sync(0xffffffffu, rc[1], o);
      }
      if (lane < 4) {
        rred[warp * kT + n8 * 8 + 2 * lane] = rc[0];
        rred[warp * kT + n8 * 8 + 2 * lane + 1] = rc[1];
      }
    }
    mma_scores<P / 8>(ax, cb, ys, Sh::kXs);  // dx += M . dy
    mma_scores<N / 8>(ab, gg, cs, Sh::kNs);  // dB += W . C
    __syncthreads();  // every warp is done with this stage and its R terms are in
    if (tid < kT && l0 + tid < Lc) {  // this key tile's share of R, warps in order
      double rs = 0.0;
#pragma unroll
      for (int w = 0; w < 4; ++w) rs += rred[w * kT + tid];
      sc.Rp[st * sc.rows + (row0 + l0 + tid) * H + h] = rs;
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const double uh = quad_sum(u[hf]);
    const int s = srow[hf];
    if (s < Lc) {
      const long long r = (row0 + s) * H + h;
#pragma unroll
      for (int pt = 0; pt < P / 8; ++pt)
        *reinterpret_cast<uint32_t*>(dx + r * P + pt * 8 + 2 * (lane % 4)) =
            pack_bf16(ax[pt][2 * hf], ax[pt][2 * hf + 1]);
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt)
        *reinterpret_cast<float2*>(sc.dBp + r * N + nt * 8 + 2 * (lane % 4)) =
            make_float2(ab[nt][2 * hf], ab[nt][2 * hf + 1]);
      if (lane % 4 == 0) {
        sc.U[r] = uh;
        sc.V[r] = v[hf];
      }
    }
  }
}

// Phase 4, bf16: one 64-query tile; warp w owns queries 16 w.. of it
template <int P, int N>
__global__ void __launch_bounds__(BwdTc<P, N>::kThreads)
ssd_bwd_queries_tc(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
                   const __nv_bfloat16* __restrict__ Cm, const __nv_bfloat16* __restrict__ dy,
                   const float* __restrict__ h0, const float* __restrict__ states, Scr sc,
                   int S, int H, int G, int L, int nc, int ns) {
  using Sh = BwdTc<P, N>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int Lpad = round_up(L, kT);
  double* cum = reinterpret_cast<double*>(smem_raw);  // [Lpad]
  float* dts = reinterpret_cast<float*>(cum + Lpad + 4 * kT + 4);  // [Lpad]
  __nv_bfloat16* yq = reinterpret_cast<__nv_bfloat16*>(dts + Lpad);  // [kT][kXs]
  __nv_bfloat16* cq = yq + kT * Sh::kXs;                               // [kT][kNs]
  __nv_bfloat16* ring = cq + kT * Sh::kNs;  // stages of (x [kT][kXs], B [kT][kNs])
  float* hs = reinterpret_cast<float*>(ring);  // [P][kHs] h_in, until the first key tile

  const int lt = gridDim.x - 1 - blockIdx.x;  // the heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z / nc, c = blockIdx.z % nc;
  const int c0 = c * L, Lc = min(L, S - c0), l0 = lt * kT;
  if (l0 >= Lc) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = h / (H / G);
  const long long tok = (long long)H * P, tokbc = (long long)G * N;
  const long long row0 = (long long)b * S + c0, bh = (long long)b * H + h;
  const __nv_bfloat16* xb = x + row0 * tok + (long long)h * P;
  const __nv_bfloat16* yb = dy + row0 * tok + (long long)h * P;
  const __nv_bfloat16* Bb = Bm + row0 * tokbc + (long long)g * N;
  const __nv_bfloat16* Cb = Cm + row0 * tokbc + (long long)g * N;
  const float* hin = c == 0 ? (h0 ? h0 + bh * P * N : nullptr)
                            : states + (((long long)b * ns + c - 1) * H + h) * P * N;

  cp_tile<P, Sh::kXs>(yq, yb, tok, l0, Lc);
  cp_tile<N, Sh::kNs>(cq, Cb, tokbc, l0, Lc);
  if (hin) cp_state<P, N>(hs, hin);
  cp_async_commit();
  chunk_cumsum(dt + row0 * H + h, H, A[h], Lc, Lpad, dts, cum);
  cp_async_wait<0>();
  __syncthreads();

  int lrow[2];
  double cum_row[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    lrow[hf] = l0 + warp * 16 + lane / 4 + 8 * hf;
    cum_row[hf] = cum[min(lrow[hf], Lc - 1)];
  }
  uint32_t ya[P / 16][4];  // this warp's dy rows as A fragments, for every product
#pragma unroll
  for (int kk = 0; kk < P / 16; ++kk)
    ldsm_x4(ya[kk], yq + (warp * 16 + lane % 16) * Sh::kXs + kk * 16 + (lane / 16) * 8);
  float ac[N / 8][4];
#pragma unroll
  for (int i = 0; i < N / 8; ++i) ac[i][0] = ac[i][1] = ac[i][2] = ac[i][3] = 0.f;
  double e[2] = {0.0, 0.0};
  if (hin) {  // inter: h_in^T dy_l (k = p; B[p][n] = h_in[p][n]), weighted by exp(cum_l)
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt) {
        uint32_t hd[2], tl[2];
        state_b_kn(hs, Sh::kHs, kk * 16, nt * 8, hd, tl);
        mma_bf16(ac[nt], ya[kk], hd[0], hd[1]);
        mma_bf16(ac[nt], ya[kk], tl[0], tl[1]);
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int q = warp * 16 + lane / 4 + 8 * hf;
      const float ex = lrow[hf] < Lc ? exp2f((float)cum_row[hf]) : 0.f;
      double part = 0.0;  // C_l . (h_in^T dy_l)
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt) {
        const float2 cv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            cq + q * Sh::kNs + nt * 8 + 2 * (lane % 4)));
        part += (double)cv.x * ac[nt][2 * hf] + (double)cv.y * ac[nt][2 * hf + 1];
        ac[nt][2 * hf] *= ex;
        ac[nt][2 * hf + 1] *= ex;
      }
      e[hf] = (double)ex * quad_sum(part);
    }
  }
  __syncthreads();  // h_in is no longer read: the ring overwrites it

  auto load = [&](int t) {
    __nv_bfloat16* xs = ring + (t % kStages) * Sh::kTile;
    cp_tile<P, Sh::kXs>(xs, xb, tok, t * kT, Lc);
    cp_tile<N, Sh::kNs>(xs + kT * Sh::kXs, Bb, tokbc, t * kT, Lc);
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t <= lt) load(t);
    cp_async_commit();
  }
  for (int t = 0; t <= lt; ++t) {  // the key tiles at or below the diagonal
    if (t + kStages - 1 <= lt) load(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();  // key tile t is in
    const __nv_bfloat16* xs = ring + (t % kStages) * Sh::kTile;
    const __nv_bfloat16* bs = xs + kT * Sh::kXs;
    const int s0 = t * kT;
    float gg[kT / 8][4];
#pragma unroll
    for (int i = 0; i < kT / 8; ++i) gg[i][0] = gg[i][1] = gg[i][2] = gg[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk) {  // dy_l . x_s
#pragma unroll
      for (int np = 0; np < kT / 16; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, xs + (np * 16 + (lane / 16) * 8 + lane % 8) * Sh::kXs + kk * 16 +
                        ((lane / 8) % 2) * 8);
        mma_bf16(gg[2 * np], ya[kk], bf[0], bf[1]);
        mma_bf16(gg[2 * np + 1], ya[kk], bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int n8 = 0; n8 < kT / 8; ++n8) {  // W = dy.x D dt_s
      const int s = s0 + n8 * 8 + 2 * (lane % 4);
#pragma unroll
      for (int e2 = 0; e2 < 4; ++e2) {
        const int hf = e2 >> 1, sk = s + (e2 & 1), l = lrow[hf];
        gg[n8][e2] = (sk <= l && l < Lc)
                         ? gg[n8][e2] * exp2f((float)(cum_row[hf] - cum[sk])) * dts[sk]
                         : 0.f;
      }
    }
    mma_scores<N / 8>(ac, gg, bs, Sh::kNs);  // dC += W . B
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int l = lrow[hf];
    if (l < Lc) {
      const long long rw = (row0 + l) * H + h;
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt)
        *reinterpret_cast<float2*>(sc.dCp + rw * N + nt * 8 + 2 * (lane % 4)) =
            make_float2(ac[nt][2 * hf], ac[nt][2 * hf + 1]);
      if (lane % 4 == 0) sc.E[rw] = e[hf];
    }
  }
}

// ---------------------------------------------------------------------------
// phase 5: the decay gradient of each chunk
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kDecayThreads)
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
// phase 6: dB and dC over the heads of each group, dA over (batch, chunk)
// ---------------------------------------------------------------------------
// one thread per (token, group, n) of dB and dC; the last block sums dA
template <typename T>
__global__ void __launch_bounds__(256)
ssd_bwd_reduce(Scr sc, T* __restrict__ dB, T* __restrict__ dC, float* __restrict__ dA,
               long long n_out, int H, int G, int N, int nbc) {
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
  const int n = (int)(i % N), rep = H / G;
  const long long tg = i / N;                 // (token, group)
  const long long tok = tg / G;
  const int g = (int)(tg % G);
  const long long base = (tok * H + (long long)g * rep) * N + n;
  float sb = 0.f, scc = 0.f;
  for (int j = 0; j < rep; ++j) {
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
  int Bsz, S, H, G, L, nc, ns;
  cudaStream_t s;
};

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int P, int N, typename T>
cudaError_t run_bwd(const BwdCall& a) {
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
  int bytes;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {  // phases 3 and 4, tensor cores
    using Sh = BwdTc<P, N>;
    bytes = Sh::bytes(Lpad);
    if ((err = allow_smem(ssd_bwd_keys_tc<P, N>, bytes)) != cudaSuccess) return err;
    ssd_bwd_keys_tc<P, N><<<tiles, Sh::kThreads, bytes, a.s>>>(
        x, dt, A, Bm, Cm, dy, h0, states, dhT, a.sc, static_cast<T*>(a.dx), a.S, a.H, a.G,
        a.L, a.nc, a.ns);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = allow_smem(ssd_bwd_queries_tc<P, N>, bytes)) != cudaSuccess) return err;
    ssd_bwd_queries_tc<P, N><<<tiles, Sh::kThreads, bytes, a.s>>>(
        x, dt, A, Bm, Cm, dy, h0, states, a.sc, a.S, a.H, a.G, a.L, a.nc, a.ns);
  } else {  // phases 3 and 4, CUDA cores
    bytes = keys_floats(P, N, Lpad) * (int)sizeof(float);
    if ((err = allow_smem(ssd_bwd_keys<P, N, T>, bytes)) != cudaSuccess) return err;
    ssd_bwd_keys<P, N, T><<<tiles, kSimtThreads, bytes, a.s>>>(
        x, dt, A, Bm, Cm, dy, h0, states, dhT, a.sc, static_cast<T*>(a.dx), a.S, a.H, a.G,
        a.L, a.nc, a.ns);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    bytes = queries_floats(P, N, Lpad) * (int)sizeof(float);
    if ((err = allow_smem(ssd_bwd_queries<P, N, T>, bytes)) != cudaSuccess) return err;
    ssd_bwd_queries<P, N, T><<<tiles, kSimtThreads, bytes, a.s>>>(
        x, dt, A, Bm, Cm, dy, h0, states, a.sc, a.S, a.H, a.G, a.L, a.nc, a.ns);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bytes = (7 * Lpad + 2 * (kDecayThreads / 32)) * (int)sizeof(float);  // phase 5
  ssd_bwd_decay<<<dim3(a.H, a.nc, a.Bsz), kDecayThreads, bytes, a.s>>>(
      dt, A, a.sc, static_cast<float*>(a.ddt), a.S, a.H, a.L, a.nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n_out = (long long)a.Bsz * a.S * a.G * N;  // phase 6
  ssd_bwd_reduce<T><<<(unsigned)((n_out + 255) / 256 + 1), 256, 0, a.s>>>(
      a.sc, static_cast<T*>(a.dB), static_cast<T*>(a.dC), static_cast<float*>(a.dA), n_out,
      a.H, a.G, N, a.Bsz * a.nc);
  return cudaGetLastError();
}

}  // namespace

// dtype (of x, Bm, Cm, dy, dx, dB, dC): 0 = float32, 1 = bfloat16.  h0,
// dhT and dh0 may be null (dh0 is written iff h0 is given).  With L =
// min(chunk, S) and nc = ceil(S / L) chunks, `states` is the forward
// call's scratch of ns slots ([B, ns, H, P, N] fp32; slot c - 1 holds the
// state entering chunk c), needed when nc > 1.  `scratch` (8-byte
// aligned) holds, in this order: three [B, S, H], two [B, nc, H] and
// ceil(L / 64) [B, S, H] fp64; with nc > 1, [B, nc, H, P, N] and
// [B, nc, H] fp32; two [B, S, H, N] fp32.  Returns the first CUDA error of the launches (0 on success).
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* h0, const void* states, int ns,
                            const void* dy, const void* dhT, void* dx, void* ddt, void* dA,
                            void* dB, void* dC, void* dh0, void* scratch, int Bsz, int S,
                            int H, int P, int G, int N, int chunk, int dtype, void* stream) {
  if (Bsz <= 0 || S <= 0 || G <= 0 || H % G != 0 || chunk <= 0 || chunk > kLMax)
    return cudaErrorInvalidValue;
  if ((h0 == nullptr) != (dh0 == nullptr)) return cudaErrorInvalidValue;
  BwdCall a{x, dt, A, Bm, Cm, h0, states, dy, dhT, dx, ddt, dA, dB, dC, dh0, {},
            Bsz, S, H, G, 0, 0, ns, static_cast<cudaStream_t>(stream)};
  a.L = chunk < S ? chunk : S;
  a.nc = (S + a.L - 1) / a.L;
  if (a.nc > 1 && (!states || ns < a.nc - 1)) return cudaErrorInvalidValue;
  const long long rows = (long long)Bsz * S * H, chunks = (long long)Bsz * a.nc * H;
  double* d = static_cast<double*>(scratch);
  a.sc.U = d;
  a.sc.V = d + rows;
  a.sc.E = d + 2 * rows;
  a.sc.csc = d + 3 * rows;
  a.sc.dAp = d + 3 * rows + chunks;
  a.sc.Rp = d + 3 * rows + 2 * chunks;
  a.sc.rows = rows;
  float* f = reinterpret_cast<float*>(a.sc.Rp + round_up(a.L, kT) / kT * rows);
  if (a.nc > 1) {
    a.sc.dstates = f;
    f += chunks * P * N;
    a.sc.decay = f;
    f += chunks;
  }
  a.sc.dBp = f;
  a.sc.dCp = f + rows * N;
  if (dtype == 1) {
    if (P == 32 && N == 16) return run_bwd<32, 16, __nv_bfloat16>(a);
    if (P == 64 && N == 128) return run_bwd<64, 128, __nv_bfloat16>(a);
  } else if (dtype == 0) {
    if (P == 32 && N == 16) return run_bwd<32, 16, float>(a);
    if (P == 64 && N == 128) return run_bwd<64, 128, float>(a);
  }
  return cudaErrorInvalidValue;
}
