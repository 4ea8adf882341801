"""The chunk-parallel SSD scan's plan and arithmetic, on the CPU.

``csrc/ssd_scan.cu`` computes the Mamba-2 scan in three phases: the chunk
states S_c (phase 1), a sequential pass h_in[c+1] = exp(cum_L) h_in[c] +
S_c over them (phase 2), and for each 64-row query tile of a chunk the
inter term exp(cum_l) C_l . h_in[c] plus the intra term over the 64-key
tiles at or below the diagonal (phase 3).  Its bf16 body feeds each of the
three fp32 operands (the dt-weighted x, h_in and the decayed scores) to a
bf16 tensor-core product as a bf16 head plus the bf16 rounding remainder.
The CUDA kernel runs only on the card (``tests/test_torch_cuda.py``); here
a small torch model of those phases, kept in this file, is held against
the JAX package's ``ssd_chunked_ref``, its Pallas kernel in interpret mode
and the port's ``ssd_chunked_ref`` on the same numpy inputs: ragged S,
chunk 100 (partial 64-row tiles), G 2, with and without h0.

Tolerances: fp32 2e-3, the JAX package's own SSD bound
(``tests/test_kernels.py``: the chunked form reassociates long sums of
decayed terms); the emulated bf16 split against the fp32 reference on the
same bf16-valued inputs 1e-1, the JAX package's bf16 SSD bound.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread a process: pytest-xdist's workers share the host's
# cores, and each would otherwise start a pool as wide as the host
torch.set_num_threads(1)

from repro.kernels.ref import ssd_chunked_ref as jax_chunked_ref
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_kernel
from repro_torch.kernels.ref import ssd_chunked_ref
from repro_torch.kernels.ssd_scan import chunk_plan

TOL = dict(atol=2e-3, rtol=2e-3)
BF16_TOL = dict(atol=1e-1, rtol=1e-1)
TILE = 64       # kT in csrc/ssd_scan.cu: query and key tile rows


def _parts(a, bf16: str | None) -> list:
    """An fp32 operand as the kernel feeds it: whole (fp32 body), a bf16
    head and the bf16 rounding remainder (``bf16="split"``, the bf16
    body), or the head alone (``bf16="round"``, one rounding)."""
    if bf16 is None:
        return [a]
    head = a.to(torch.bfloat16).float()
    if bf16 == "round":
        return [head]
    return [head, (a - head).to(torch.bfloat16).float()]


def ssd_phases(x, dt, A, Bm, Cm, *, chunk, h0=None, bf16=None):
    """The kernel's three phases in torch.  x [B,S,H,P], dt [B,S,H],
    A [H], Bm/Cm [B,S,G,N], h0 [B,H,P,N] -> (y [B,S,H,P], hT [B,H,P,N]),
    fp32; ``bf16`` emulates how the bf16 body feeds its fp32 operands."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L, nc, slots, _ = chunk_plan(S, chunk, True)
    rep = H // G
    x, dt, Bm, Cm = x.float(), dt.float(), Bm.float(), Cm.float()
    states = torch.zeros(Bsz, slots, H, P, N)
    decay = torch.zeros(Bsz, slots, H)
    cums = {}
    for b in range(Bsz):                     # phase 1: chunk states
        for c in range(nc):
            c0 = c * L
            Lc = min(L, S - c0)
            for h in range(H):
                d = dt[b, c0:c0 + Lc, h]
                cum = torch.cumsum(d * A[h], 0)
                cums[b, c, h] = cum
                w = torch.exp(cum[-1] - cum) * d
                xw = (x[b, c0:c0 + Lc, h] * w[:, None]).T    # [P, Lc]
                bm = Bm[b, c0:c0 + Lc, h // rep]              # [Lc, N]
                states[b, c, h] = sum(p @ bm for p in _parts(xw, bf16))
                decay[b, c, h] = torch.exp(cum[-1])
    hin = torch.zeros(Bsz, nc, H, P, N)      # phase 2: the state pass
    state = torch.zeros(Bsz, H, P, N) if h0 is None else h0.float()
    for c in range(nc):
        hin[:, c] = state
        state = decay[:, c, :, None, None] * state + states[:, c]
    y = torch.zeros(Bsz, S, H, P)
    for b in range(Bsz):                     # phase 3: the chunk scan
        for c in range(nc):
            c0 = c * L
            Lc = min(L, S - c0)
            for h in range(H):
                g, cum = h // rep, cums[b, c, h]
                d = dt[b, c0:c0 + Lc, h]
                for l0 in range(0, Lc, TILE):
                    l1 = min(Lc, l0 + TILE)
                    cq = Cm[b, c0 + l0:c0 + l1, g]             # [nl, N]
                    acc = torch.exp(cum[l0:l1])[:, None] * sum(
                        cq @ p.T for p in _parts(hin[b, c, h], bf16))
                    for s0 in range(0, l1, TILE):
                        s1 = min(Lc, s0 + TILE)
                        sc = cq @ Bm[b, c0 + s0:c0 + s1, g].T  # [nl, ns]
                        live = (torch.arange(s0, s1)[None, :]
                                <= torch.arange(l0, l1)[:, None])
                        diff = torch.where(live, cum[l0:l1, None]
                                           - cum[None, s0:s1], -torch.inf)
                        sc = sc * torch.exp(diff) * d[None, s0:s1]
                        xs = x[b, c0 + s0:c0 + s1, h]          # [ns, P]
                        acc = acc + sum(p @ xs for p in _parts(sc, bf16))
                    y[b, c0 + l0:c0 + l1, h] = acc
    return y, state


def _inputs(seed, B, S, H, P, G, N, h0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, H, P), np.float32),
            np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32),
            -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32),
            rng.standard_normal((B, S, G, N), np.float32),
            rng.standard_normal((B, S, G, N), np.float32)]
    h = rng.standard_normal((B, H, P, N), np.float32) if h0 else None
    return arrs, h


def _pallas(arrs, h, chunk):
    """The Pallas kernel in interpret mode; it needs S % chunk == 0, so the
    inputs are padded with dt = 0 (state-neutral) and y is cut back."""
    S = arrs[0].shape[1]
    L = min(chunk, S)
    pad = (-S) % L
    padded = [np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
              if i != 2 else a for i, a in enumerate(arrs)]
    y, hT = jax_ssd_kernel(*(jnp.asarray(a) for a in padded), chunk=L,
                           h0=None if h is None else jnp.asarray(h),
                           return_final_state=True, interpret=True)
    return np.asarray(y)[:, :S], np.asarray(hT)


@pytest.mark.parametrize("S,chunk,H,P,G,N,h0", [
    (250, 100, 4, 32, 2, 16, True),     # ragged S, chunk 100, G 2, h0
    (250, 100, 4, 32, 2, 16, False),
    (300, 256, 2, 64, 1, 128, True),    # full head, a 44-token last chunk
    (64, 64, 4, 64, 1, 128, True),      # one chunk from h0 (serving)
    (40, 64, 4, 32, 1, 16, False),      # chunk longer than S
])
def test_phases_match_references(S, chunk, H, P, G, N, h0):
    arrs, h = _inputs(S + N + G, 2, S, H, P, G, N, h0)
    kw = dict(chunk=chunk, return_final_state=True)
    th = None if h is None else torch.from_numpy(h)
    y, hT = ssd_phases(*(torch.from_numpy(a) for a in arrs), chunk=chunk,
                       h0=th)
    plain_y, plain_h = ssd_chunked_ref(*(torch.from_numpy(a) for a in arrs),
                                       h0=th, **kw)
    jax_y, jax_h = jax_chunked_ref(*(jnp.asarray(a) for a in arrs),
                                   h0=None if h is None else jnp.asarray(h),
                                   **kw)
    pallas_y, pallas_h = _pallas(arrs, h, chunk)
    for want_y, want_h in ((plain_y.numpy(), plain_h.numpy()),
                           (np.asarray(jax_y), np.asarray(jax_h)),
                           (pallas_y, pallas_h)):
        np.testing.assert_allclose(y.numpy(), want_y, **TOL)
        np.testing.assert_allclose(hT.numpy(), want_h, **TOL)


@pytest.mark.parametrize("S,chunk,H,P,G,N,h0", [
    (250, 100, 4, 32, 2, 16, True),
    (300, 256, 2, 64, 1, 128, False),
    (64, 64, 4, 64, 1, 128, True),
])
def test_bf16_split_stays_within_bound(S, chunk, H, P, G, N, h0):
    """x, B and C rounded to bf16 (the kernel's inputs); the emulated
    head-and-tail products, y rounded to bf16 as the kernel stores it,
    against the fp32 reference on the same bf16 values.  The split lands
    nearer the reference than one bf16 rounding of each operand does."""
    arrs, h = _inputs(S + N, 2, S, H, P, G, N, h0)
    t = [torch.from_numpy(a) for a in arrs]
    for i in (0, 3, 4):
        t[i] = t[i].to(torch.bfloat16).float()
    th = None if h is None else torch.from_numpy(h)
    want_y, want_h = ssd_chunked_ref(*t, chunk=chunk, h0=th,
                                     return_final_state=True)
    err = {}
    for mode in ("split", "round"):
        y, hT = ssd_phases(*t, chunk=chunk, h0=th, bf16=mode)
        y = y.to(torch.bfloat16).float()
        torch.testing.assert_close(y, want_y, **BF16_TOL)
        torch.testing.assert_close(hT, want_h, **BF16_TOL)
        err[mode] = (hT - want_h).abs().max().item()
    assert err["split"] < err["round"]


@pytest.mark.parametrize("S,chunk,final,plan", [
    (1024, 256, True, (256, 4, 4, 3)),     # the mamba prefill
    (1024, 256, False, (256, 4, 3, 3)),
    (64, 64, True, (64, 1, 1, 2)),         # the serving prefill: no pass
    (64, 64, False, (64, 1, 0, 1)),        # only the chunk scan
    (1000, 100, True, (100, 10, 10, 3)),
    (40, 64, True, (40, 1, 1, 2)),         # chunk longer than S
])
def test_chunk_plan(S, chunk, final, plan):
    assert chunk_plan(S, chunk, final) == plan
