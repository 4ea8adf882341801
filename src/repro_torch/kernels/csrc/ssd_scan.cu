// Mamba-2 SSD chunked scan with state carry, for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (Pallas; body
// `_kernel`).  Same contract: x [B,S,H,P], dt [B,S,H] fp32 (softplus'ed),
// A [H] fp32 (negative), Bm/Cm [B,S,G,N] in x's dtype (head h reads group
// h / (H/G)), optional h0 [B,H,P,N] fp32 -> y [B,S,H,P] in x's dtype and,
// optionally, the final state hT [B,H,P,N] fp32.  Per chunk c of L tokens,
// with cum the inclusive cumsum of dt*A over the chunk:
//   y_l   = sum_{s<=l} (C_l . B_s) exp(cum_l - cum_s) dt_s x_s      (intra)
//         + exp(cum_l) C_l . h_in[c]                                (inter)
//   S_c   = sum_s exp(cum_L - cum_s) dt_s x_s B_s^T                 (state)
//   h_in[c+1] = exp(cum_L) h_in[c] + S_c,   h_in[0] = h0 (or 0)
// All decay math, every accumulation and the state are fp32 (cum is taken
// in the log2 domain, so each decay is one exp2f).  S need not divide the
// chunk: the last chunk is shorter, which is what the reference's dt = 0
// padding computes, and nothing is copied.
//
// What bounds it on this card: per (b, h, chunk) the intra term costs
// about L^2 (N + P) / 2 multiply-adds and the inter term and the chunk
// state 2 L P N, against L (2P + 2N) bytes read and L P written: some
// 60-120 operations per byte at full width (L 256, P 64, N 128), under the
// bf16 tensor-core ridge (~295), so the call is bound by bytes in
// principle.  At the port's sizes (a few MB, 4 GFLOP) the chunk scan is
// bound by how fast 12 warps per SM issue `mma.sync` (the head-and-
// remainder operands below double three of the products), and the chunk
// states, one wave of blocks, by one block's latency.
//
// Design: the Mamba-2 paper's chunked SSD, as chunk-parallel phases with a
// thin sequential pass between them.  The TPU kernel walks the chunks as a
// sequential grid axis; here only the state recurrence is sequential.
//   1. Chunk states (`ssd_states_*`), one block per (head, chunk, batch):
//      the chunk's cumsum (one warp scan), exp(cum_L) to `decay`, and S_c,
//      a [P, L].[L, N] product, to the fp32 scratch `states`.
//   2. State pass (`ssd_state_pass`), one thread per 4 state entries of a
//      (batch, head): walks the chunks in order, h = decay_c h + S_c, and
//      writes h over S_c's slot (slot c then holds h_in[c+1]), or to hT
//      after the last chunk.  Elementwise, coalesced, mostly in L2.
//   3. Chunk scan (`ssd_scan_*`), one block per (64-row query tile, head,
//      chunk and batch): the inter term from h_in (h0 or the slot of the
//      chunk before), then the intra term over the key tiles at or below
//      the diagonal, then one store of y.  Heavier tiles (further down the
//      chunk) are scheduled first.  h_in is staged in the space of the
//      key-tile ring and used up before the first key tile arrives, so at
//      full width a block needs 71 KB and three fit an SM (768 blocks of 4
//      warps at the main shape).
// Launches per call: 3 when the sequence has several chunks; with one
// chunk, phase 1 writes hT = exp(cum_L) h0 + S_0 itself and phase 2 is
// skipped (2 launches), and with one chunk and no hT only phase 3 runs
// (1 launch).  Phase 1 skips the last chunk when hT is not asked for.
// Scratch (`states` [B, slots, H, P, N] and `decay` [B, slots, H], fp32)
// comes from the caller; nothing is allocated or zeroed here.  No atomics:
// two calls give the same bits.
//
// Two bodies for phases 1 and 3, chosen by dtype:
//   bf16, tensor cores (`*_tc`): `mma.sync.m16n8k16` bf16 x bf16 -> fp32.
//     Tiles of 64 tokens stay bf16 in shared memory (rows padded by 16
//     bytes, so `ldmatrix`'s eight row addresses hit distinct banks) and
//     arrive by 16-byte `cp.async` in a ring of two stages; h_in arrives
//     the same way as fp32.  C.B^T takes exact bf16 operands.  The three
//     fp32 operands (dt-weighted x in phase 1; the decayed scores and h_in
//     in phase 3) each go in as a bf16 head plus its bf16 rounding
//     remainder, split in registers as the fragments are read, two
//     `mma.sync`s on the same fragments of the other operand (~16
//     significant bits; one rounding alone is ~8).  The scores
//     go from the C.B^T accumulators straight into the A fragments of
//     scores.x (the m16n8 C layout of two key tiles is the m16k16 A
//     layout); x^T comes from `ldmatrix.trans` of the [token][p] tile.
//   fp32, CUDA cores (`*_simt`): fp32 FMAs on register tiles (TF32 would
//     miss the fp32 bound of 2e-3), the same grid and scratch.
// Instantiated for (P, N) in {(32, 16), (64, 128), (64, 16)} (the reduced
// and full mamba2-130m heads, the full jamba-v0.1-52b head); the wrapper
// refuses other pairs.  At N 16, C.B^T is one k-step and the state two
// n-tiles; the fp32 h_in (P rows of N + 8 floats) takes 6 KB of the 24 KB
// ring, and a phase-3 block needs 30 KB at chunk 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "ssd_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// shared helpers
// ---------------------------------------------------------------------------

// a bf16x2 register times (w.x, w.y), split into head and tail
__device__ __forceinline__ void scale_split(uint32_t v, float2 w, uint32_t& head,
                                            uint32_t& tail) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  split_bf16(f.x * w.x, f.y * w.y, head, tail);
}

// ---------------------------------------------------------------------------
// phase 2: the state pass (both dtypes)
// ---------------------------------------------------------------------------

// one thread per 4 entries of one (b, h) state; slots [B][ns][H][P*N]
__global__ void __launch_bounds__(256)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ decay,
               const float* __restrict__ h0, float* __restrict__ hT, int Bsz, int H,
               int PN, int ns, int nc) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;  // float4 index
  const int per = PN / 4;
  if (q >= (long long)Bsz * H * per) return;
  const int e = (int)(q % per);
  const long long bh = q / per;
  const int h = (int)(bh % H), b = (int)(bh / H);
  float4 v = h0 ? reinterpret_cast<const float4*>(h0 + bh * PN)[e]
                : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < ns; ++c) {
    const long long slot = ((long long)b * ns + c) * H + h;
    float4* sp = reinterpret_cast<float4*>(states + slot * PN) + e;
    const float d = decay[slot];
    const float4 s = *sp;
    v = make_float4(fmaf(d, v.x, s.x), fmaf(d, v.y, s.y), fmaf(d, v.z, s.z),
                    fmaf(d, v.w, s.w));
    if (c < nc - 1)
      *sp = v;  // h_in of chunk c + 1
    else
      reinterpret_cast<float4*>(hT + bh * PN)[e] = v;
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core bodies
// ---------------------------------------------------------------------------
template <int P, int N>
struct TcShape {
  static_assert(P % 16 == 0 && N % 16 == 0, "P and N are multiples of 16");
  static constexpr int kXs = P + kPad;  // smem row strides, in elements
  static constexpr int kNs = N + kPad;
  static constexpr int kStageElems = kT * (kXs + kNs);  // x tile + B tile
  // phase 1: one warp per 16 state rows (p)
  static constexpr int kStWarps = P / 16;
  static constexpr int kStThreads = kStWarps * 32;
  // phase 3: 4 warps of 16 query rows; bf16 C tile and ring, fp32 h_in
  // staged in the ring's space before the first key tile
  static constexpr int kScThreads = 128;
  static constexpr int kHs = N + 8;  // fp32 h_in row stride: 8-byte reads of 16 lanes hit 32 banks
  static_assert(P * kHs * 4 <= kStages * kStageElems * 2, "h_in fits the ring");
  static int st_bytes(int Lpad) {
    return 2 * Lpad * (int)sizeof(float) + kStages * kStageElems * 2;
  }
  static int sc_bytes(int Lpad) {
    return (kT * kNs + kStages * kStageElems) * 2 + 2 * Lpad * (int)sizeof(float);
  }
};

// Phase 1, bf16: S_c[p][n] = sum_s (w_s x_s[p]) B_s[n], w_s = exp(cum_L -
// cum_s) dt_s.  A = (w x)^T from `ldmatrix.trans` of the x tile, scaled
// and split in registers; B = the B tile by `ldmatrix.trans`.  `direct`
// (one chunk): hT = exp(cum_L) h0 + S_0 instead of the scratch slot.
template <int P, int N>
__global__ void __launch_bounds__(TcShape<P, N>::kStThreads)
ssd_states_tc(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
              const float* __restrict__ h0, float* __restrict__ states,
              float* __restrict__ decay, float* __restrict__ hT, int S, int H, int G,
              int L, int ns, int direct) {
  using Sh = TcShape<P, N>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int Lpad = round_up(L, kT);
  float* cum = reinterpret_cast<float*>(smem_raw);  // [Lpad]
  float* wst = cum + Lpad;                           // [Lpad] dt, then weights
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(wst + Lpad);

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = h / (H / G);
  const int c0 = c * L, Lc = min(L, S - c0);
  const long long tok = (long long)H * P, tokbc = (long long)G * N;
  const __nv_bfloat16* xb = x + ((long long)b * S + c0) * tok + (long long)h * P;
  const __nv_bfloat16* Bb = Bm + ((long long)b * S + c0) * tokbc + (long long)g * N;
  const int ntiles = (Lc + kT - 1) / kT;

  auto load = [&](int t) {
    __nv_bfloat16* xs = ring + (t % kStages) * Sh::kStageElems;
    cp_tile<P, Sh::kXs>(xs, xb, tok, t * kT, Lc);
    cp_tile<N, Sh::kNs>(xs + kT * Sh::kXs, Bb, tokbc, t * kT, Lc);
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) load(t);
    cp_async_commit();
  }

  chunk_cumsum(dt + ((long long)b * S + c0) * H + h, H, A[h], Lc, Lpad, wst, cum);
  const float cum_last = cum[Lc - 1];
  for (int i = threadIdx.x; i < Lpad; i += blockDim.x)
    wst[i] = i < Lc ? exp2f(cum_last - cum[i]) * wst[i] : 0.f;
  const float dec = exp2f(cum_last);
  if (!direct && threadIdx.x == 0) decay[((long long)b * ns + c) * H + h] = dec;

  float acc[N / 8][4];
#pragma unroll
  for (int n = 0; n < N / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    if (t + kStages - 1 < ntiles) load(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();  // this tile has landed; on t = 0 the weights are in too
    const __nv_bfloat16* xs = ring + (t % kStages) * Sh::kStageElems;
    const __nv_bfloat16* bs = xs + kT * Sh::kXs;
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      uint32_t a[4], ah[4], at[4];  // x^T: rows p = warp*16.., columns s
      ldsm_x4_trans(a, xs + (kk * 16 + lane % 8 + (lane / 16) * 8) * Sh::kXs + warp * 16 +
                           ((lane / 8) % 2) * 8);
      const int s = t * kT + kk * 16 + 2 * (lane % 4);
      const float2 w0 = make_float2(wst[s], wst[s + 1]);
      const float2 w1 = make_float2(wst[s + 8], wst[s + 9]);
      scale_split(a[0], w0, ah[0], at[0]);
      scale_split(a[1], w0, ah[1], at[1]);
      scale_split(a[2], w1, ah[2], at[2]);
      scale_split(a[3], w1, ah[3], at[3]);
#pragma unroll
      for (int np = 0; np < N / 16; ++np) {
        uint32_t bf[4];  // tokens kk*16 + [0,16), n np*16 + [0,8) and [8,16)
        ldsm_x4_trans(bf, bs + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * Sh::kNs +
                              np * 16 + (lane / 16) * 8);
        mma_bf16(acc[2 * np], ah, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], ah, bf[2], bf[3]);
        mma_bf16(acc[2 * np], at, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], at, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  const long long hoff = ((long long)b * H + h) * P * N;
  float* out = direct ? hT + hoff : states + (((long long)b * ns + c) * H + h) * P * N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = warp * 16 + lane / 4 + 8 * half;
#pragma unroll
    for (int n8 = 0; n8 < N / 8; ++n8) {
      const int n = n8 * 8 + 2 * (lane % 4);
      float2 v = make_float2(acc[n8][2 * half], acc[n8][2 * half + 1]);
      if (direct && h0) {
        const float2 hv = *reinterpret_cast<const float2*>(h0 + hoff + p * N + n);
        v.x = fmaf(dec, hv.x, v.x);
        v.y = fmaf(dec, hv.y, v.y);
      }
      *reinterpret_cast<float2*>(out + p * N + n) = v;
    }
  }
}

// Phase 3, bf16: one 64-row query tile of one chunk.  Each warp owns 16
// query rows; C's A fragments stay in registers for both C.h_in^T and
// C.B^T.
template <int P, int N>
__global__ void __launch_bounds__(TcShape<P, N>::kScThreads)
ssd_scan_tc(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
            const __nv_bfloat16* __restrict__ Cm, const float* __restrict__ h0,
            const float* __restrict__ states, __nv_bfloat16* __restrict__ y, int S, int H,
            int G, int L, int nc, int ns) {
  using Sh = TcShape<P, N>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int Lpad = round_up(L, kT);
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kT][kNs] C tile
  __nv_bfloat16* ring = cs + kT * Sh::kNs;  // kStages x (x tile, B tile)
  float* hs = reinterpret_cast<float*>(ring);  // [P][kHs] h_in, until the first key tile
  float* cum = reinterpret_cast<float*>(ring + kStages * Sh::kStageElems);  // [Lpad]
  float* dts = cum + Lpad;                                                // [Lpad]

  const int lt = gridDim.x - 1 - blockIdx.x;  // the heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z / nc, c = blockIdx.z % nc;
  const int c0 = c * L, Lc = min(L, S - c0), l0 = lt * kT;
  if (l0 >= Lc) return;  // past a short last chunk
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = h / (H / G);
  const long long tok = (long long)H * P, tokbc = (long long)G * N;
  const __nv_bfloat16* xb = x + ((long long)b * S + c0) * tok + (long long)h * P;
  __nv_bfloat16* yb = y + ((long long)b * S + c0) * tok + (long long)h * P;
  const __nv_bfloat16* Bb = Bm + ((long long)b * S + c0) * tokbc + (long long)g * N;
  const __nv_bfloat16* Cb = Cm + ((long long)b * S + c0) * tokbc + (long long)g * N;
  // the state entering this chunk: h0 (or none) for the first, else the
  // slot the state pass left for the chunk before
  const float* hin = c == 0 ? (h0 ? h0 + ((long long)b * H + h) * P * N : nullptr)
                            : states + (((long long)b * ns + c - 1) * H + h) * P * N;

  auto load = [&](int t) {
    __nv_bfloat16* xs = ring + (t % kStages) * Sh::kStageElems;
    cp_tile<P, Sh::kXs>(xs, xb, tok, t * kT, Lc);
    cp_tile<N, Sh::kNs>(xs + kT * Sh::kXs, Bb, tokbc, t * kT, Lc);
  };
  cp_tile<N, Sh::kNs>(cs, Cb, tokbc, l0, Lc);
  if (hin) {
    for (int i = threadIdx.x; i < P * N / 4; i += blockDim.x) {
      const int p = i / (N / 4), n = i % (N / 4) * 4;
      cp_async16(hs + p * Sh::kHs + n, hin + p * N + n, true);
    }
  }
  cp_async_commit();
  chunk_cumsum(dt + ((long long)b * S + c0) * H + h, H, A[h], Lc, Lpad, dts, cum);

  // this thread's two query rows (chunk positions) and their cum
  int row[2];
  float cum_row[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    row[hf] = l0 + warp * 16 + lane / 4 + 8 * hf;
    cum_row[hf] = cum[min(row[hf], Lc - 1)];
  }

  uint32_t cf[N / 16][4];
  float acc[P / 8][4];
#pragma unroll
  for (int n = 0; n < P / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  cp_async_wait<0>();
  __syncthreads();  // the C tile and h_in are in
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    ldsm_x4(cf[kk], cs + (warp * 16 + lane % 16) * Sh::kNs + kk * 16 + (lane / 16) * 8);
  if (hin) {  // inter: acc = exp(cum_l) * C . h_in^T, h_in as bf16 head and tail
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
      for (int pp = 0; pp < P / 16; ++pp) {
        // B fragments: n kk*16 + [0,16) by p pp*16 + [0,8) and [8,16)
        const float* hp = hs + (pp * 16 + lane / 4) * Sh::kHs + kk * 16 + 2 * (lane % 4);
        uint32_t bh[4], bl[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const float2 v =
              *reinterpret_cast<const float2*>(hp + (f / 2) * 8 * Sh::kHs + (f % 2) * 8);
          split_bf16(v.x, v.y, bh[f], bl[f]);
        }
        mma_bf16(acc[2 * pp], cf[kk], bh[0], bh[1]);
        mma_bf16(acc[2 * pp + 1], cf[kk], bh[2], bh[3]);
        mma_bf16(acc[2 * pp], cf[kk], bl[0], bl[1]);
        mma_bf16(acc[2 * pp + 1], cf[kk], bl[2], bl[3]);
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float e = row[hf] < Lc ? exp2f(cum_row[hf]) : 0.f;
#pragma unroll
      for (int n = 0; n < P / 8; ++n) {
        acc[n][2 * hf] *= e;
        acc[n][2 * hf + 1] *= e;
      }
    }
    __syncthreads();  // every warp is done with h_in before the key tiles overwrite it
  }

  // intra: the key tiles at or below the diagonal, through the ring
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t <= lt) load(t);
    cp_async_commit();
  }
  for (int st = 0; st <= lt; ++st) {
    if (st + kStages - 1 <= lt) load(st + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();  // key tile st is in
    const __nv_bfloat16* xs = ring + (st % kStages) * Sh::kStageElems;
    const __nv_bfloat16* bs = xs + kT * Sh::kXs;
    const int s0 = st * kT;

    // scores = C . B^T: 16 rows x 64 keys per warp
    float sc[kT / 8][4];
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kT / 16; ++np) {
        uint32_t bf[4];  // keys np*16 + [0,8) and [8,16), n kk*16 + [0,16)
        ldsm_x4(bf, bs + (np * 16 + (lane / 16) * 8 + lane % 8) * Sh::kNs + kk * 16 +
                        ((lane / 8) % 2) * 8);
        mma_bf16(sc[2 * np], cf[kk], bf[0], bf[1]);
        mma_bf16(sc[2 * np + 1], cf[kk], bf[2], bf[3]);
      }
    }
    // decay and dt; keys above the diagonal (or queries past the chunk) are
    // masked before the exp, which would overflow there
    const bool need_mask = st == lt || l0 + kT > Lc;
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
      const int s = s0 + n * 8 + 2 * (lane % 4);  // this thread's keys s, s + 1
      const float2 ck = *reinterpret_cast<const float2*>(cum + s);
      const float2 dk = *reinterpret_cast<const float2*>(dts + s);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        const bool live = !need_mask || (s + (e & 1) <= row[hf] && row[hf] < Lc);
        sc[n][e] = live ? sc[n][e] * exp2f(cum_row[hf] - (e & 1 ? ck.y : ck.x)) *
                              (e & 1 ? dk.y : dk.x)
                        : 0.f;
      }
    }
    // acc += scores . x, the scores as a bf16 head and tail
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      uint32_t a[4], at[4];
      split_bf16(sc[2 * kk][0], sc[2 * kk][1], a[0], at[0]);
      split_bf16(sc[2 * kk][2], sc[2 * kk][3], a[1], at[1]);
      split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], a[2], at[2]);
      split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], a[3], at[3]);
#pragma unroll
      for (int dp = 0; dp < P / 16; ++dp) {
        uint32_t bf[4];  // keys kk*16 + [0,16), p dp*16 + [0,8) and [8,16)
        ldsm_x4_trans(bf, xs + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * Sh::kXs +
                              dp * 16 + (lane / 16) * 8);
        mma_bf16(acc[2 * dp], a, bf[0], bf[1]);
        mma_bf16(acc[2 * dp + 1], a, bf[2], bf[3]);
        mma_bf16(acc[2 * dp], at, bf[0], bf[1]);
        mma_bf16(acc[2 * dp + 1], at, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (row[hf] < Lc) {
      __nv_bfloat16* yp = yb + (long long)row[hf] * tok + 2 * (lane % 4);
#pragma unroll
      for (int n = 0; n < P / 8; ++n)
        *reinterpret_cast<uint32_t*>(yp + n * 8) =
            pack_bf16(acc[n][2 * hf], acc[n][2 * hf + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 CUDA-core bodies
// ---------------------------------------------------------------------------
// shared floats of phase 1: B tile [kT][N+1], x tile [kT][P], cum and
// weights [Lpad]
__host__ __device__ constexpr int st_simt_floats(int P, int N, int Lpad) {
  return kT * (N + 1) + kT * P + 2 * Lpad;
}
// shared floats of phase 3: h_in [P][N+1], C and B tiles [kT][N+1], x tile
// [kT][P], scores [kT][kT+1], cum and dt [Lpad]
__host__ __device__ constexpr int sc_simt_floats(int P, int N, int Lpad) {
  return P * (N + 1) + 2 * kT * (N + 1) + kT * P + kT * (kT + 1) + 2 * Lpad;
}

// Phase 1, fp32: each thread owns a P/16 x N/16 register tile of S_c
template <int P, int N>
__global__ void __launch_bounds__(kSimtThreads)
ssd_states_simt(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ h0, float* __restrict__ states,
                float* __restrict__ decay, float* __restrict__ hT, int S, int H, int G,
                int L, int ns, int direct) {
  static_assert(P % 16 == 0 && N % 16 == 0, "tile");
  constexpr int NP = N + 1, CP = P / 16, CN = N / 16;
  extern __shared__ float smem[];
  const int Lpad = round_up(L, kT);
  float* bk = smem;             // [kT][NP]
  float* xk = bk + kT * NP;     // [kT][P]
  float* cum = xk + kT * P;     // [Lpad]
  float* wst = cum + Lpad;      // [Lpad] dt, then weights

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int g = h / (H / G);
  const int c0 = c * L, Lc = min(L, S - c0);
  const long long tok = (long long)H * P, tokbc = (long long)G * N;
  const float* xb = x + ((long long)b * S + c0) * tok + (long long)h * P;
  const float* Bb = Bm + ((long long)b * S + c0) * tokbc + (long long)g * N;

  chunk_cumsum(dt + ((long long)b * S + c0) * H + h, H, A[h], Lc, Lpad, wst, cum);
  const float cum_last = cum[Lc - 1];
  for (int i = tid; i < Lpad; i += kSimtThreads)
    wst[i] = i < Lc ? exp2f(cum_last - cum[i]) * wst[i] : 0.f;
  const float dec = exp2f(cum_last);
  if (!direct && tid == 0) decay[((long long)b * ns + c) * H + h] = dec;

  float hr[CP][CN];
#pragma unroll
  for (int i = 0; i < CP; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) hr[i][j] = 0.f;
  for (int s0 = 0; s0 < Lc; s0 += kT) {
    __syncthreads();
    load_tile<N, NP>(bk, Bb, tokbc, s0, Lc);
    load_tile<P, P>(xk, xb, tok, s0, Lc);
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
  const long long hoff = ((long long)b * H + h) * P * N;
  float* out = direct ? hT + hoff : states + (((long long)b * ns + c) * H + h) * P * N;
#pragma unroll
  for (int i = 0; i < CP; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int e = (ty * CP + i) * N + tx + 16 * j;
      out[e] = direct && h0 ? fmaf(dec, h0[hoff + e], hr[i][j]) : hr[i][j];
    }
}

// Phase 3, fp32: one 64-row query tile; each thread owns a 4-row by
// P/16-column tile of y (and 4 by 4 of the scores)
template <int P, int N>
__global__ void __launch_bounds__(kSimtThreads)
ssd_scan_simt(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const float* __restrict__ Bm,
              const float* __restrict__ Cm, const float* __restrict__ h0,
              const float* __restrict__ states, float* __restrict__ y, int S, int H, int G,
              int L, int nc, int ns) {
  static_assert(P % 16 == 0 && N % 16 == 0, "tile");
  constexpr int NP = N + 1;      // padded row of an [., N] tile
  constexpr int SP = kT + 1;     // padded row of the scores tile
  constexpr int RY = kT / 16;    // query rows per thread
  constexpr int CP = P / 16;     // y columns per thread
  constexpr int CS = kT / 16;    // score columns per thread
  extern __shared__ float smem[];
  const int Lpad = round_up(L, kT);
  float* hs = smem;                  // [P][NP] h_in
  float* cq = hs + P * NP;           // [kT][NP] C rows of the query tile
  float* bk = cq + kT * NP;          // [kT][NP] B rows of the key tile
  float* xk = bk + kT * NP;          // [kT][P]  x rows of the key tile
  float* sc = xk + kT * P;           // [kT][SP] scores of the tile pair
  float* cum = sc + kT * SP;         // [Lpad]
  float* dts = cum + Lpad;           // [Lpad]

  const int lt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z / nc, c = blockIdx.z % nc;
  const int c0 = c * L, Lc = min(L, S - c0), l0 = lt * kT;
  if (l0 >= Lc) return;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int g = h / (H / G);
  const long long tok = (long long)H * P, tokbc = (long long)G * N;
  const float* xb = x + ((long long)b * S + c0) * tok + (long long)h * P;
  float* yb = y + ((long long)b * S + c0) * tok + (long long)h * P;
  const float* Bb = Bm + ((long long)b * S + c0) * tokbc + (long long)g * N;
  const float* Cb = Cm + ((long long)b * S + c0) * tokbc + (long long)g * N;
  const float* hin = c == 0 ? (h0 ? h0 + ((long long)b * H + h) * P * N : nullptr)
                            : states + (((long long)b * ns + c - 1) * H + h) * P * N;

  if (hin)
    for (int i = tid; i < P * N; i += kSimtThreads) hs[(i / N) * NP + i % N] = hin[i];
  load_tile<N, NP>(cq, Cb, tokbc, l0, Lc);
  chunk_cumsum(dt + ((long long)b * S + c0) * H + h, H, A[h], Lc, Lpad, dts, cum);

  // inter: acc[l][p] = exp(cum_l) * sum_n C[l][n] h_in[p][n]
  float acc[RY][CP];
#pragma unroll
  for (int i = 0; i < RY; ++i)
#pragma unroll
    for (int j = 0; j < CP; ++j) acc[i][j] = 0.f;
  if (hin) {
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
      const float e = l < Lc ? exp2f(cum[l]) : 0.f;
#pragma unroll
      for (int j = 0; j < CP; ++j) acc[i][j] *= e;
    }
  }
  // intra: the key tiles at or below the diagonal
  for (int st = 0; st <= lt; ++st) {
    const int s0 = st * kT;
    __syncthreads();
    load_tile<N, NP>(bk, Bb, tokbc, s0, Lc);
    load_tile<P, P>(xk, xb, tok, s0, Lc);
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
            (sg <= l && l < Lc) ? s[i][j] * exp2f(cum[l] - cum[sg]) * dts[sg] : 0.f;
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
      for (int j = 0; j < CP; ++j) yb[(long long)l * tok + tx + 16 * j] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
struct Call {
  const void *x, *dt, *A, *Bm, *Cm, *h0;
  void *y, *hT;
  float *states, *decay;
  int Bsz, S, H, G, L, nc, ns;
  cudaStream_t s;
};

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int P, int N>
cudaError_t phases_tc(const Call& a) {
  using Sh = TcShape<P, N>;
  using bf = __nv_bfloat16;
  const int Lpad = round_up(a.L, kT);
  cudaError_t err;
  if (a.ns > 0) {  // phase 1 (with one chunk: straight to hT)
    const int bytes = Sh::st_bytes(Lpad);
    if ((err = allow_smem(ssd_states_tc<P, N>, bytes)) != cudaSuccess) return err;
    ssd_states_tc<P, N><<<dim3(a.H, a.ns, a.Bsz), Sh::kStThreads, bytes, a.s>>>(
        static_cast<const bf*>(a.x), static_cast<const float*>(a.dt),
        static_cast<const float*>(a.A), static_cast<const bf*>(a.Bm),
        static_cast<const float*>(a.h0), a.states, a.decay, static_cast<float*>(a.hT), a.S,
        a.H, a.G, a.L, a.ns, a.nc == 1);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (a.nc > 1) {  // phase 2
    const long long n4 = (long long)a.Bsz * a.H * P * N / 4;
    ssd_state_pass<<<(unsigned)((n4 + 255) / 256), 256, 0, a.s>>>(
        a.states, a.decay, static_cast<const float*>(a.h0), static_cast<float*>(a.hT), a.Bsz,
        a.H, P * N, a.ns, a.nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int bytes = Sh::sc_bytes(Lpad);  // phase 3
  if ((err = allow_smem(ssd_scan_tc<P, N>, bytes)) != cudaSuccess) return err;
  ssd_scan_tc<P, N><<<dim3(Lpad / kT, a.H, a.Bsz * a.nc), Sh::kScThreads, bytes, a.s>>>(
      static_cast<const bf*>(a.x), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const bf*>(a.Bm),
      static_cast<const bf*>(a.Cm), static_cast<const float*>(a.h0), a.states,
      static_cast<bf*>(a.y), a.S, a.H, a.G, a.L, a.nc, a.ns);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t phases_simt(const Call& a) {
  const int Lpad = round_up(a.L, kT);
  cudaError_t err;
  if (a.ns > 0) {
    const int bytes = st_simt_floats(P, N, Lpad) * (int)sizeof(float);
    if ((err = allow_smem(ssd_states_simt<P, N>, bytes)) != cudaSuccess) return err;
    ssd_states_simt<P, N><<<dim3(a.H, a.ns, a.Bsz), kSimtThreads, bytes, a.s>>>(
        static_cast<const float*>(a.x), static_cast<const float*>(a.dt),
        static_cast<const float*>(a.A), static_cast<const float*>(a.Bm),
        static_cast<const float*>(a.h0), a.states, a.decay, static_cast<float*>(a.hT), a.S,
        a.H, a.G, a.L, a.ns, a.nc == 1);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (a.nc > 1) {
    const long long n4 = (long long)a.Bsz * a.H * P * N / 4;
    ssd_state_pass<<<(unsigned)((n4 + 255) / 256), 256, 0, a.s>>>(
        a.states, a.decay, static_cast<const float*>(a.h0), static_cast<float*>(a.hT), a.Bsz,
        a.H, P * N, a.ns, a.nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int bytes = sc_simt_floats(P, N, Lpad) * (int)sizeof(float);
  if ((err = allow_smem(ssd_scan_simt<P, N>, bytes)) != cudaSuccess) return err;
  ssd_scan_simt<P, N><<<dim3(Lpad / kT, a.H, a.Bsz * a.nc), kSimtThreads, bytes, a.s>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const float*>(a.Bm),
      static_cast<const float*>(a.Cm), static_cast<const float*>(a.h0), a.states,
      static_cast<float*>(a.y), a.S, a.H, a.G, a.L, a.nc, a.ns);
  return cudaGetLastError();
}

}  // namespace

// dtype (of x, Bm, Cm, y): 0 = float32, 1 = bfloat16.  h0 and hT may be
// null.  With L = min(chunk, S), nc = ceil(S / L) chunks and slots = nc if
// hT is asked for, else nc - 1: when nc > 1, states holds [B, slots, H, P,
// N] and decay [B, slots, H] fp32 (unused, and may be null, when nc = 1).
// Returns the first CUDA error of the launches (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, const void* h0, void* y,
                            void* hT, void* states, void* decay, int Bsz, int S, int H,
                            int P, int G, int N, int chunk, int dtype, void* stream) {
  if (Bsz == 0 || S == 0) return 0;
  if (G <= 0 || H % G != 0 || chunk <= 0 || chunk > kLMax) return cudaErrorInvalidValue;
  Call a{x, dt, A, Bm, Cm, h0, y, hT, static_cast<float*>(states),
         static_cast<float*>(decay), Bsz, S, H, G, 0, 0, 0,
         static_cast<cudaStream_t>(stream)};
  a.L = chunk < S ? chunk : S;
  a.nc = (S + a.L - 1) / a.L;
  a.ns = hT ? a.nc : a.nc - 1;
  if (a.nc > 1 && (!states || !decay)) return cudaErrorInvalidValue;
  if (dtype == 1) {
    if (P == 32 && N == 16) return phases_tc<32, 16>(a);
    if (P == 64 && N == 128) return phases_tc<64, 128>(a);
    if (P == 64 && N == 16) return phases_tc<64, 16>(a);
  } else if (dtype == 0) {
    if (P == 32 && N == 16) return phases_simt<32, 16>(a);
    if (P == 64 && N == 128) return phases_simt<64, 128>(a);
    if (P == 64 && N == 16) return phases_simt<64, 16>(a);
  }
  return cudaErrorInvalidValue;
}
