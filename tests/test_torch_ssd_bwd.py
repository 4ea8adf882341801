"""The SSD scan's backward on the CPU: a torch model of the backward
kernel's phases, the plain backward, the ``SSDScan`` Function and the
dispatch rules, against ``jax.vjp`` of the JAX package's
``ssd_chunked_ref`` (the scan JAX trains through; its Pallas kernel has no
VJP).

``csrc/ssd_scan_bwd.cu`` runs six phases: the chunk state gradients Q_c =
sum_l exp(cum_l) dy_l C_l^T (1), a reverse pass dh[c] = exp(cum_L) dh[c+1]
+ Q_c over them (2), for each 64-key tile of a chunk the state terms and
the decayed C.B^T and dy.x^T tiles into dx, dB and the decay terms U, V
and the tile's terms of R (3), for each 64-query tile the inter term and
the decayed dy.x^T tiles into dC and the decay term I (4), the reverse
cumsum of d cum into ddt and each chunk's term of dA (5), and the sums of
the dB, dC partials of a group and of dA over (batch, chunk) (6).  A block
of phases 3 and 4 takes a run of heads of one group (4 in the bf16 body,
one in the fp32 body; runs never cross a group) and sums their dB (or dC)
into one partial.  The CUDA kernel runs only on the card
(``tests/test_torch_cuda.py``); here ``ssd_bwd_phases``, kept in this
file, computes those phases tile by tile in fp32 (the kernel keeps cum and
the decay terms in fp64, which the model leaves to fp32), and emulates how
the bf16 body feeds each fp32 operand (the weighted dy of phase 1, the
decayed score tiles, dh[c+1], h_in[c]) to a bf16 tensor-core product as a
bf16 head plus its bf16 rounding remainder.

Tolerances: fp32 2e-3, the JAX package's own SSD bound
(``tests/test_kernels.py``: the chunked form reassociates long sums of
decayed terms); the emulated bf16 split against the JAX vjp on the same
bf16-valued inputs 1e-1, the JAX package's bf16 SSD bound.  Same numpy
inputs from a seed for both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread a process: pytest-xdist's workers share the host's
# cores, and each would otherwise start a pool as wide as the host
torch.set_num_threads(1)

from repro.kernels.ref import ssd_chunked_ref as jax_chunked_ref
from repro_torch.kernels import cuda_build
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ref import ssd_chunked_ref, ssd_scan_bwd_ref

TOL = dict(atol=2e-3, rtol=2e-3)
BF16_TOL = dict(atol=1e-1, rtol=1e-1)
TILE = 64       # kT in csrc/ssd_common.cuh: query and key tile rows
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dh0")


def _parts(a, bf16: str | None) -> list:
    """An fp32 operand as a product takes it: whole (fp32 body), a bf16
    head and the bf16 rounding remainder (``bf16="split"``, the bf16
    tensor-core body), or the head alone (``bf16="round"``, one
    rounding)."""
    if bf16 is None:
        return [a]
    head = a.to(torch.bfloat16).float()
    if bf16 == "round":
        return [head]
    return [head, (a - head).to(torch.bfloat16).float()]


def head_runs(H, G, heads_per_run):
    """The head runs of phases 3 and 4: (group, first head, end), up to
    ``heads_per_run`` heads of one group each, in the kernel's order."""
    rep = H // G
    return [(g, h0, min(h0 + heads_per_run, (g + 1) * rep))
            for g in range(G) for h0 in range(g * rep, (g + 1) * rep,
                                              heads_per_run)]


def ssd_bwd_phases(x, dt, A, Bm, Cm, h0, dy, dhT, *, chunk, bf16=None,
                   heads_per_run=None):
    """The backward kernel's phases in torch, fp32.  Returns (dx, ddt, dA,
    dB, dC, dh0); dh0 is None without h0.  The states entering each chunk,
    which the kernel reads from the forward's scratch, are made here by
    the forward's recurrence.  ``bf16`` emulates how the tensor-core body
    feeds its fp32 operands (the weighted dy of phase 1, the decayed score
    tiles, dh[c+1] and h_in[c]) to bf16 products.  dB and dC are summed
    per run of ``heads_per_run`` heads (the body's: 4 in bf16, 1 in fp32),
    each run's heads in order, then over the runs of each group."""

    def mul(eq, a, b):               # a product with fp32 operand a
        return sum(torch.einsum(eq, part, b) for part in _parts(a, bf16))

    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L, nc, _ = ssd.bwd_plan(S, chunk, h0 is not None)
    rep = H // G
    if heads_per_run is None:
        heads_per_run = ssd.HEADS_PER_RUN[torch.bfloat16 if bf16 else
                                          torch.float32]
    x, dy, dt, A = x.float(), dy.float(), dt.float(), A.float()
    Bh = Bm.float().repeat_interleave(rep, 2)          # [B, S, H, N]
    Ch = Cm.float().repeat_interleave(rep, 2)
    spans = [(c * L, min(L, S - c * L)) for c in range(nc)]
    cums = [torch.cumsum(dt[:, c0:c0 + n] * A, 1) for c0, n in spans]  # [B,n,H]

    hin = [torch.zeros(Bsz, H, P, N) if h0 is None else h0.float()]
    for (c0, n), cum in zip(spans, cums, strict=True):   # the forward's states
        w = torch.exp(cum[:, -1:] - cum) * dt[:, c0:c0 + n]
        hin.append(torch.exp(cum[:, -1])[..., None, None] * hin[-1]
                   + torch.einsum("bsh,bshp,bshn->bhpn", w, x[:, c0:c0 + n],
                                  Bh[:, c0:c0 + n]))

    # phases 1-2: Q_c, then dh[c] = exp(cum_L) dh[c+1] + Q_c from the last
    dh = [None] * nc + [torch.zeros(Bsz, H, P, N) if dhT is None
                        else dhT.float()]
    for c in range(nc - 1, -1, -1):
        (c0, n), cum = spans[c], cums[c]
        q = mul("bshp,bshn->bhpn", torch.exp(cum)[..., None]
                * dy[:, c0:c0 + n], Ch[:, c0:c0 + n])
        dh[c] = torch.exp(cum[:, -1])[..., None, None] * dh[c + 1] + q

    dx = torch.zeros(Bsz, S, H, P)
    dBh, dCh = torch.zeros(Bsz, S, H, N), torch.zeros(Bsz, S, H, N)
    U, V, R, E = (torch.zeros(Bsz, S, H) for _ in range(4))
    ddt, dA = torch.zeros(Bsz, S, H), torch.zeros(H)

    def tile(t, c0, a, b):           # rows [a, b) of chunk c0 of a [B,S,H,*]
        return t[:, c0 + a:c0 + b]

    def decay(cum, l0, l1, s0, s1):  # D [B, H, l, s], 0 above the diagonal
        live = (torch.arange(s0, s1)[None, :] <= torch.arange(l0, l1)[:, None])
        diff = cum[:, l0:l1, None, :] - cum[:, None, s0:s1, :]   # [B,l,s,H]
        return torch.where(live[None, :, :, None], torch.exp(diff),
                           0.0).permute(0, 3, 1, 2)

    for c, ((c0, n), cum) in enumerate(zip(spans, cums, strict=True)):
        d = dt[:, c0:c0 + n]
        for s0 in range(0, n, TILE):                 # phase 3: key tiles
            s1 = min(n, s0 + TILE)
            xk, bk = tile(x, c0, s0, s1), tile(Bh, c0, s0, s1)
            w = torch.exp(cum[:, -1:] - cum[:, s0:s1])           # [B, s, H]
            dhb = mul("bhpn,bshn->bshp", dh[c + 1], bk)
            ax = (w * d[:, s0:s1])[..., None] * dhb
            ab = (w * d[:, s0:s1])[..., None] * mul("bhpn,bshp->bshn",
                                                    dh[c + 1], xk)
            V[:, c0 + s0:c0 + s1] = w * (xk * dhb).sum(-1)
            u = torch.zeros_like(w)
            for l0 in range(s0, n, TILE):
                l1 = min(n, l0 + TILE)
                cq, yq = tile(Ch, c0, l0, l1), tile(dy, c0, l0, l1)
                D = decay(cum, l0, l1, s0, s1)                   # [B,H,l,s]
                cd = torch.einsum("bshn,blhn->bhls", bk, cq) * D
                gg = torch.einsum("bshp,blhp->bhls", xk, yq)
                ds = d[:, s0:s1].permute(0, 2, 1)[:, :, None, :]  # [B,H,1,s]
                ax = ax + mul("bhls,blhp->bshp", cd * ds, yq)
                ab = ab + mul("bhls,blhn->bshn", gg * D * ds, cq)
                u = u + (cd * gg).sum(2).permute(0, 2, 1)
                R[:, c0 + l0:c0 + l1] += (cd * gg * ds).sum(3).permute(0, 2, 1)
            dx[:, c0 + s0:c0 + s1] = ax
            dBh[:, c0 + s0:c0 + s1] = ab
            U[:, c0 + s0:c0 + s1] = u
        for l0 in range(0, n, TILE):                 # phase 4: query tiles
            l1 = min(n, l0 + TILE)
            cq, yq = tile(Ch, c0, l0, l1), tile(dy, c0, l0, l1)
            ex = torch.exp(cum[:, l0:l1])[..., None]             # [B, l, H, 1]
            hd = mul("bhpn,blhp->blhn", hin[c], yq)
            ac = ex * hd
            for s0 in range(0, l1, TILE):
                s1 = min(n, s0 + TILE)
                xk, bk = tile(x, c0, s0, s1), tile(Bh, c0, s0, s1)
                D = decay(cum, l0, l1, s0, s1)
                ds = d[:, s0:s1].permute(0, 2, 1)[:, :, None, :]
                wq = torch.einsum("blhp,bshp->bhls", yq, xk) * D * ds
                ac = ac + mul("bhls,bshn->blhn", wq, bk)
            dCh[:, c0 + l0:c0 + l1] = ac
            E[:, c0 + l0:c0 + l1] = ex[..., 0] * (cq * hd).sum(-1)
        # phase 5: dcum, its reverse cumsum, ddt and the chunk's dA
        sl = slice(c0, c0 + n)
        dcum = E[:, sl] + R[:, sl] - d * (U[:, sl] + V[:, sl])
        dcum[:, -1] += (d * V[:, sl]).sum(1) + torch.exp(cum[:, -1]) * (
            dh[c + 1] * hin[c]).sum((-1, -2))
        dadt = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
        ddt[:, sl] = U[:, sl] + V[:, sl] + A * dadt
        dA = dA + (d * dadt).sum((0, 1))
    # phases 3-4 sum each run's heads in order; phase 6 a group's runs
    runs = head_runs(H, G, heads_per_run)
    dB, dC = torch.zeros(Bsz, S, G, N), torch.zeros(Bsz, S, G, N)
    for part, whole in ((dBh, dB), (dCh, dC)):
        for g, a, b in runs:
            run = torch.zeros(Bsz, S, N)
            for h in range(a, b):
                run = run + part[:, :, h]
            whole[:, :, g] += run
    return dx, ddt, dA, dB, dC, None if h0 is None else dh[0]


def _inputs(seed, B, S, H, P, G, N, h0, dhT):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, H, P), np.float32),
            np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32),
            -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32),
            rng.standard_normal((B, S, G, N), np.float32),
            rng.standard_normal((B, S, G, N), np.float32)]
    h = rng.standard_normal((B, H, P, N), np.float32) if h0 else None
    dy = rng.standard_normal((B, S, H, P), np.float32)
    dh = rng.standard_normal((B, H, P, N), np.float32) if dhT else None
    return arrs, h, dy, dh


def _jax_vjp(arrs, h, dy, dh, chunk, dtype=jnp.float32):
    """(dx, ddt, dA, dB, dC, dh0) of the JAX reference, as numpy; x, B, C
    and dy in ``dtype``."""
    args = [jnp.asarray(a) for a in arrs]
    for i in (0, 3, 4):
        args[i] = args[i].astype(dtype)
    if h is not None:
        args.append(jnp.asarray(h))

    def f(x, dt, A, Bm, Cm, *h0):
        return jax_chunked_ref(x, dt, A, Bm, Cm, chunk=chunk,
                               h0=h0[0] if h0 else None,
                               return_final_state=dh is not None)

    _, vjp = jax.vjp(f, *args)
    cot = jnp.asarray(dy).astype(dtype)
    got = vjp((cot, jnp.asarray(dh)) if dh is not None else cot)
    got = [np.asarray(g.astype(jnp.float32)) for g in got]
    return got + ([None] if h is None else [])


def _torch(arrs, h, dy, dh, dtype=torch.float32):
    t = [torch.from_numpy(a) for a in arrs]
    for i in (0, 3, 4):
        t[i] = t[i].to(dtype)
    return (*t, None if h is None else torch.from_numpy(h),
            torch.from_numpy(dy).to(dtype),
            None if dh is None else torch.from_numpy(dh))


def _assert_grads(got, want, tol):
    for name, g, w in zip(NAMES, got, want, strict=True):
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(g.detach().float().numpy(), w, **tol,
                                   err_msg=name)


CASES = [   # S, chunk, H, P, G, N, h0, dhT
    (250, 100, 4, 32, 2, 16, True, True),     # ragged S, chunk 100, G 2
    (250, 100, 4, 32, 2, 16, False, False),   # dropped final state
    (250, 100, 4, 32, 2, 16, True, False),
    (250, 100, 4, 32, 2, 16, False, True),
    (300, 256, 2, 64, 1, 128, False, False),  # full head, a 44-token tail
    (64, 64, 4, 32, 1, 16, False, False),     # one chunk
    (64, 64, 4, 32, 1, 16, True, True),       # one chunk, h0 and dhT
    (40, 64, 4, 32, 1, 16, False, True),      # chunk longer than S
    (250, 100, 6, 32, 1, 16, True, True),     # 6 heads: runs of 4 and 2
    (250, 100, 10, 32, 2, 16, False, True),   # groups of 5: runs of 4, 1
    (300, 256, 4, 64, 1, 16, False, False),   # jamba's head, a 44-token tail
]


@pytest.mark.parametrize("S,chunk,H,P,G,N,h0,dhT", CASES)
def test_phases_match_jax_vjp(S, chunk, H, P, G, N, h0, dhT):
    arrs, h, dy, dh = _inputs(S + P + 7 * h0 + 3 * dhT, 2, S, H, P, G, N,
                              h0, dhT)
    got = ssd_bwd_phases(*_torch(arrs, h, dy, dh), chunk=chunk)
    _assert_grads(got, _jax_vjp(arrs, h, dy, dh, chunk), TOL)


@pytest.mark.parametrize("S,chunk,H,P,G,N,h0,dhT", [CASES[0], CASES[4],
                                                CASES[8], CASES[9]])
def test_phases_in_runs_of_four_heads_match_jax_vjp(S, chunk, H, P, G, N, h0,
                                                    dhT):
    """The bf16 body's order of the dB and dC sums, runs of up to 4 heads
    of a group then the group's runs, at the fp32 bound."""
    arrs, h, dy, dh = _inputs(S + P + 5, 2, S, H, P, G, N, h0, dhT)
    got = ssd_bwd_phases(*_torch(arrs, h, dy, dh), chunk=chunk,
                         heads_per_run=4)
    _assert_grads(got, _jax_vjp(arrs, h, dy, dh, chunk), TOL)


@pytest.mark.parametrize("S,chunk,H,P,G,N,h0,dhT", [CASES[0], CASES[4],
                                                CASES[6]])
def test_phases_in_bf16_stay_within_bound(S, chunk, H, P, G, N, h0, dhT):
    """bf16 x, B, C and dy (the kernel's inputs); the emulated head-and-
    remainder products, dx, dB, dC rounded to bf16 once as the kernel
    stores them, against the JAX vjp on the same bf16 inputs (which rounds
    its gradients the same way).  Before that rounding, the split lands
    nearer the fp32 phases than one bf16 rounding of each operand does."""
    arrs, h, dy, dh = _inputs(S + 1, 2, S, H, P, G, N, h0, dhT)
    args = _torch(arrs, h, dy, dh, torch.bfloat16)
    want = _jax_vjp(arrs, h, dy, dh, chunk, jnp.bfloat16)
    exact = ssd_bwd_phases(*args, chunk=chunk)
    err = {}
    for mode in ("split", "round"):
        got = list(ssd_bwd_phases(*args, chunk=chunk, bf16=mode))
        err[mode] = max((g - e).abs().max().item() for g, e in
                        zip(got[:5], exact[:5], strict=True))
        for i in (0, 3, 4):
            got[i] = got[i].to(torch.bfloat16)
        _assert_grads(got, want, BF16_TOL)
    assert err["split"] < err["round"]


@pytest.mark.parametrize("S,chunk,H,P,G,N,h0,dhT",
                         CASES[:4] + [CASES[6], CASES[10]])
def test_plain_backward_and_function_match_jax_vjp(S, chunk, H, P, G, N, h0,
                                                   dhT):
    """``ssd_scan_bwd_ref`` directly, and the ``SSDScan`` Function through
    ``ssd_scan`` and autograd (its CPU backward is that plain version)."""
    arrs, h, dy, dh = _inputs(S + 11, 2, S, H, P, G, N, h0, dhT)
    want = _jax_vjp(arrs, h, dy, dh, chunk)
    args = _torch(arrs, h, dy, dh)
    _assert_grads(ssd_scan_bwd_ref(*args, chunk=chunk), want, TOL)

    leaves = [t.clone().requires_grad_() for t in args[:6] if t is not None]
    before = ssd.ssd_scan_bwd.launches
    y, hT = ssd.ssd_scan(*leaves[:5], chunk=chunk,
                         h0=leaves[5] if h0 else None, return_final_state=True)
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    outs = (y, hT) if dhT else (y,)
    torch.autograd.backward(outs, args[6:8] if dhT else args[6:7])
    assert ssd.ssd_scan_bwd.launches == before      # the CPU runs no kernel
    _assert_grads([t.grad for t in leaves] + ([] if h0 else [None]), want,
                  TOL)


@pytest.mark.parametrize("final", [True, False])
def test_function_passes_gradcheck(final):
    """The backward against finite differences, fp64, tiny size: G 2,
    three chunks with a short last one, h0."""
    gen = torch.Generator().manual_seed(1)
    shapes = ((1, 7, 4, 3), (1, 7, 4), (4,), (1, 7, 2, 5), (1, 7, 2, 5),
              (1, 4, 3, 5))
    x, dt, A, Bm, Cm, h0 = (torch.randn(s, dtype=torch.float64, generator=gen)
                            for s in shapes)
    dt, A = dt.abs() + 0.1, -A.abs() - 0.2
    inputs = tuple(t.requires_grad_() for t in (x, dt, A, Bm, Cm, h0))
    assert torch.autograd.gradcheck(
        lambda *a: ssd.SSDScan.apply(*a, 3, final), inputs)


def test_dropped_final_state_equals_zero_dhT():
    arrs, h, dy, _ = _inputs(5, 2, 130, 4, 32, 2, 16, True, False)
    args = _torch(arrs, h, dy, None)
    leaves = [t.clone().requires_grad_() for t in args[:6]]
    y, _ = ssd.ssd_scan(*leaves[:5], chunk=64, h0=leaves[5],
                        return_final_state=True)
    y.backward(args[6])                 # hT dropped: its gradient is None
    zeros = ssd_scan_bwd_ref(*args[:7], torch.zeros_like(args[5]), chunk=64)
    for name, t, z in zip(NAMES, leaves, zeros, strict=True):
        assert torch.equal(t.grad, z), name


@pytest.mark.parametrize("H,G,runs", [
    (24, 1, [(0, 0, 4), (0, 4, 8), (0, 8, 12), (0, 12, 16), (0, 16, 20),
             (0, 20, 24)]),                # mamba2-130m: 6 partials, not 24
    (6, 1, [(0, 0, 4), (0, 4, 6)]),
    (10, 2, [(0, 0, 4), (0, 4, 5), (1, 5, 9), (1, 9, 10)]),
    (7, 7, [(g, g, g + 1) for g in range(7)]),
])
def test_head_runs_stay_inside_a_group(H, G, runs):
    """The bf16 body's runs of up to 4 heads, as the kernel numbers them
    (``SideItem``), and the scratch's partials per token
    (``bwd_partials``): one per run, the fp32 body's one per head."""
    assert head_runs(H, G, 4) == runs
    assert ssd.bwd_partials(H, G, torch.bfloat16) == len(runs)
    assert ssd.bwd_partials(H, G, torch.float32) == H


@pytest.mark.parametrize("S,chunk,h0,launches", [
    (4096, 256, False, 6),      # the training shape
    (1000, 100, True, 6),
    (64, 64, True, 5),          # one chunk: no state pass
    (64, 64, False, 4),         # one chunk, no h0: no chunk state gradients
    (40, 64, False, 4),
])
def test_bwd_plan(S, chunk, h0, launches):
    L, nc, n = ssd.bwd_plan(S, chunk, h0)
    assert (L, nc, n) == (min(chunk, S), -(-S // min(chunk, S)), launches)


def _meta(*shapes, dtype=torch.float32):
    return [torch.zeros(s, device="meta", dtype=dtype) for s in shapes]


def test_cuda_tensors_never_take_the_plain_path(monkeypatch):
    """Any tensor off the CPU goes to the kernels' checks, with grad and
    without, forward and backward; the plain versions are never called:
    a meta tensor then takes the shape-and-count branch, and one on two
    devices is refused by the checks."""
    def boom(*a, **k):
        raise AssertionError("the plain version was called")

    monkeypatch.setattr(ssd, "ssd_scan_plain", boom)
    monkeypatch.setattr(ssd, "ssd_scan_bwd_plain", boom)
    x, dt, A, bc = _meta((1, 8, 2, 32), (1, 8, 2), (2,), (1, 8, 1, 16))
    assert ssd.ssd_scan(x, dt, A, bc, bc, chunk=8).device.type == "meta"
    y = ssd.ssd_scan(x.requires_grad_(), dt, A, bc, bc, chunk=8)
    y.backward(torch.zeros_like(y))
    assert x.grad.device.type == "meta"
    dx = ssd.ssd_scan_bwd(x.detach(), dt, A, bc, bc, None, x.detach(),
                          chunk=8)[0]
    assert dx.device.type == "meta"
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan(x.detach(), torch.zeros(dt.shape), A, bc, bc, chunk=8)
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan_bwd(x.detach(), torch.zeros(dt.shape), A, bc, bc, None,
                         x.detach(), chunk=8)


def test_a_failing_build_raises_and_never_falls_back(monkeypatch):
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(ssd, "ssd_scan_bwd_plain", None)
    monkeypatch.setattr(ssd, "_check", lambda *a: None)
    monkeypatch.setattr(ssd, "_check_bwd", lambda *a: 0)
    monkeypatch.setattr(cuda_build, "library", no_nvcc)
    # meta tensors routed as CUDA tensors, to reach the launch
    monkeypatch.setattr(ssd.work, "route", lambda what, t: "cuda")
    x, dt, A, bc = _meta((1, 8, 2, 32), (1, 8, 2), (2,), (1, 8, 1, 16))
    with pytest.raises(RuntimeError, match="nvcc"):
        ssd.ssd_scan_bwd(x, dt, A, bc, bc, None, x, chunk=8)


def test_only_the_decode_kernels_refuse_grad():
    """The decode kernels still refuse a call autograd would record on a
    device other than the CPU; ``ssd_scan`` records it (on meta tensors
    its Function takes the shape-and-count branch, past any guard)."""
    q, kv = _meta((2, 4, 64), (2, 16, 2, 64))
    lens = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no backward"):
        da.decode_attention(q.requires_grad_(), kv, kv, lens)
    table = torch.zeros((2, 2), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no backward"):
        da.decode_attention_paged(q, kv, kv, table, lens)
    x, dt, A, bc = _meta((1, 8, 2, 32), (1, 8, 2), (2,), (1, 8, 1, 16))
    y = ssd.ssd_scan(x.requires_grad_(), dt, A, bc, bc, chunk=8)
    assert y.requires_grad and y.device.type == "meta"


def test_plain_forward_is_unchanged_by_the_wide_dtype():
    """``ssd_chunked_ref`` widens to fp64 for fp64 inputs (gradcheck) and
    still computes bf16 and fp32 inputs in fp32."""
    arrs, h, _, _ = _inputs(9, 1, 70, 2, 32, 1, 16, True, False)
    t = _torch(arrs, h, arrs[0], None, torch.bfloat16)
    y, hT = ssd_chunked_ref(*t[:5], chunk=32, h0=t[5], return_final_state=True)
    assert y.dtype == torch.bfloat16 and hT.dtype == torch.float32
    t64 = [a.double() for a in t[:6]]
    y64, hT64 = ssd_chunked_ref(*t64[:5], chunk=32, h0=t64[5],
                                return_final_state=True)
    assert y64.dtype == hT64.dtype == torch.float64
    torch.testing.assert_close(y64.float(), y.float(), **BF16_TOL)
