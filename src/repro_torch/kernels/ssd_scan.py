"""Mamba-2 SSD chunked scan, forward and backward: the wrappers around the
CUDA kernels ``csrc/ssd_scan.cu`` (which replaces the Pallas TPU kernel
``repro/kernels/ssd_scan.py::ssd_scan``) and ``csrc/ssd_scan_bwd.cu``
(the scan's backward, which JAX takes by autodiff of
``repro/kernels/ref.py::ssd_chunked_ref``; the Pallas kernel has none),
with their plain PyTorch versions.

``ssd_scan`` takes the plain version for tensors on the CPU, and only
then; for CUDA tensors it launches the kernel or raises.  Unlike the
Pallas wrapper it needs no ``S % chunk == 0``: the kernel's last chunk is
shorter, which computes what the plain version's dt = 0 padding does.

The forward runs in chunk-parallel phases (chunk states, a sequential
pass over the states, the chunk scan; see the source): ``chunk_plan``
gives the chunks, the state slots of the fp32 scratch this wrapper
allocates, and the launches of one call.  When autograd would record the
call (grad mode on and an input requiring grad) it goes through
``SSDScan``, which keeps that scratch (the states entering each chunk)
for its backward, ``ssd_scan_bwd``: the plain ``ssd_scan_bwd_ref`` on the
CPU, the kernel on the card (``bwd_plan`` gives its launches).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.ref import ssd_chunked_ref, ssd_scan_bwd_ref

# (P, N) = (head dim, state dim) pairs the forward and the backward kernel
# are instantiated for (csrc/ssd_scan.cu, csrc/ssd_scan_bwd.cu): the reduced
# and the full mamba2-130m heads and the full jamba-v0.1-52b head; another
# pair is one more line in each file
SUPPORTED_DIMS = frozenset({(32, 16), (64, 128), (64, 16)})
MAX_CHUNK = 1024
# the chunk ``ops.ssd_scan`` takes when its caller names none (the Pallas
# kernel's default); models pass their config's chunk
DEFAULT_CHUNK = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# heads whose dB and dC the backward sums into one fp32 partial: a block of
# the bf16 body takes a run of up to 4 heads of a group (csrc/ssd_scan_bwd.cu
# kHpb), the fp32 body one head
HEADS_PER_RUN = {torch.float32: 1, torch.bfloat16: 4}

# the plain PyTorch versions the kernels are held against
ssd_scan_plain = ssd_chunked_ref
ssd_scan_bwd_plain = ssd_scan_bwd_ref


def chunk_plan(S: int, chunk: int, final_state: bool) -> tuple:
    """(L, chunks, slots, launches) of one kernel call: chunks of L =
    min(chunk, S) tokens; a state slot per chunk whose outgoing state is
    needed (all but the last, and the last too for the final state); one
    launch per phase that runs (chunk states when any slot is needed, the
    state pass with more than one chunk, the chunk scan always)."""
    L = min(chunk, S)
    nc = -(-S // L)
    slots = nc if final_state else nc - 1
    return L, nc, slots, 1 + (slots > 0) + (nc > 1)


def chunk_ok(chunk: int) -> bool:
    """Whether the kernel takes chunks of ``chunk`` tokens: 0 < chunk <=
    ``MAX_CHUNK`` (any S; the last chunk may be shorter).  The wrapper
    checks it on both devices and ``repro_torch.tune.space.valid`` mirrors
    it."""
    return 0 < int(chunk) <= MAX_CHUNK


def _check_chunk(chunk) -> None:
    if not chunk_ok(chunk):
        raise ValueError(f"ssd_scan kernel: chunk={chunk} outside "
                         f"(0, {MAX_CHUNK}]")


def _check(x, dt, A, Bm, Cm, h0, chunk):
    dev = x.device
    ts = [t for t in (dt, A, Bm, Cm, h0) if t is not None]
    if not (x.is_cuda and all(t.device == dev for t in ts)):
        raise ValueError("ssd_scan kernel: all inputs must be on one CUDA "
                         "device")
    if x.dtype not in _DTYPE_CODE or Bm.dtype != x.dtype \
            or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan kernel takes float32 or bfloat16 x/B/C of "
                        f"one dtype, got {x.dtype}/{Bm.dtype}/{Cm.dtype}")
    if any(t.dtype != torch.float32 for t in (dt, A) + ((h0,) if h0 is not
                                                         None else ())):
        raise TypeError("ssd_scan kernel: dt, A and h0 must be float32")
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or Bm.ndim != 4:
        raise ValueError("ssd_scan: x [B,S,H,P], dt [B,S,H], A [H], "
                         "B/C [B,S,G,N]")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,) \
            or Bm.shape[:2] != (Bsz, S) or Cm.shape != Bm.shape \
            or (h0 is not None and tuple(h0.shape) != (Bsz, H, P, N)):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bm.shape)}, C {tuple(Cm.shape)} disagree")
    if G == 0 or H % G:
        raise ValueError(f"ssd_scan: H={H} not a multiple of G={G}")
    if (P, N) not in SUPPORTED_DIMS:
        raise ValueError(f"ssd_scan kernel: (P, N)=({P}, {N}) not in "
                         f"{sorted(SUPPORTED_DIMS)}")
    _check_chunk(chunk)
    if not all(t.is_contiguous() for t in (x, *ts)):
        raise ValueError("ssd_scan kernel: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, Bm, Cm, h0) if t is not None):
        raise ValueError("ssd_scan kernel: x, B, C and h0 must start on a "
                         "16-byte boundary (the tiles are copied in 16-byte "
                         "pieces)")


def _check_bwd(x, dy, dhT, states, N, chunk) -> int:
    """Checks what only the backward takes; returns the state slots of the
    forward's scratch (0 without one)."""
    Bsz, S, H, P = x.shape
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} {dy.dtype} must "
                         f"match x {tuple(x.shape)} {x.dtype}")
    if dhT is not None and (tuple(dhT.shape) != (Bsz, H, P, N)
                            or dhT.dtype != torch.float32):
        raise ValueError(f"ssd_scan_bwd: dhT must be float32 "
                         f"{(Bsz, H, P, N)}")
    if not all(t.device == x.device and t.is_contiguous()
               for t in (dy, dhT, states) if t is not None):
        raise ValueError("ssd_scan_bwd kernel: dy, dhT and the states must be "
                         "contiguous on x's device")
    if any(t.data_ptr() % 16 for t in (dy, dhT) if t is not None):
        raise ValueError("ssd_scan_bwd kernel: dy and dhT must start on a "
                         "16-byte boundary")
    nc = chunk_plan(S, chunk, True)[1]
    if nc == 1:
        return 0
    slots, rest = divmod(0 if states is None else states.numel(),
                         Bsz * H * (P * N + 1))
    if states is None or states.dtype != torch.float32 or rest \
            or slots not in (nc - 1, nc):
        raise ValueError("ssd_scan_bwd kernel: more than one chunk needs the "
                         "forward call's fp32 state scratch")
    return slots


def bwd_plan(S: int, chunk: int, h0: bool) -> tuple:
    """(L, chunks, launches) of one backward call: chunk state gradients
    when any is needed (a chunk after the first, or dh0), the reverse state
    pass with more than one chunk, then the key side, the query side, the
    decay gradient and the head reduction always."""
    L = min(chunk, S)
    nc = -(-S // L)
    return L, nc, 4 + (nc > 1 or h0) + (nc > 1)


def bwd_partials(H: int, G: int, dtype) -> int:
    """The dB (and dC) partials of each token in the backward's scratch:
    a group's H / G heads in runs of ``HEADS_PER_RUN[dtype]``, the last run
    of a group shorter when they do not divide."""
    return G * -(-(H // G) // HEADS_PER_RUN[dtype])


def _forward(x, dt, A, Bm, Cm, h0, chunk: int, final: bool):
    """One kernel call: (y, hT or None, the fp32 scratch or None).  With
    more than one chunk the scratch holds the chunk states [B, slots, H,
    P, N] (after the state pass, slot c holds the state entering chunk
    c + 1), then the chunk decays [B, slots, H]."""
    _check(x, dt, A, Bm, Cm, h0, chunk)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.empty_like(x)
    hT = (torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
          if final else None)
    _, nc, slots, _ = chunk_plan(S, chunk, final)
    scratch = states = decay = None
    if nc > 1:
        scratch = torch.empty(Bsz * slots * H * (P * N + 1),
                              dtype=torch.float32, device=x.device)
        states = scratch.data_ptr()
        decay = states + Bsz * slots * H * P * N * scratch.element_size()
    lib = cuda_build.library()
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), None if hT is None else hT.data_ptr(), states,
            decay, Bsz, S, H, P, G, N, int(chunk), _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "ssd_scan")
    ssd_scan.launches += 1
    return y, hT, scratch


def ssd_scan_bwd(x, dt, A, Bm, Cm, h0, dy, dhT=None, *, chunk: int,
                 states=None):
    """(dx, ddt, dA, dB, dC, dh0) of the scan from its inputs, the
    gradient ``dy`` of y (x's dtype) and ``dhT`` of the final state (fp32,
    None when the caller dropped it).  dx, dB, dC come in x's dtype, ddt,
    dA and dh0 in fp32; dh0 is None without h0.  ``states`` is the scratch
    of the forward call (``_forward``), which the kernel reads the states
    entering each chunk from; it is needed with more than one chunk."""
    if x.device.type == "cpu":
        return ssd_scan_bwd_plain(x, dt, A, Bm, Cm, h0, dy, dhT, chunk=chunk)
    _check(x, dt, A, Bm, Cm, h0, chunk)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    slots = _check_bwd(x, dy, dhT, states, N, chunk)
    L, nc, _ = bwd_plan(S, chunk, h0 is not None)
    dx = torch.empty_like(x)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    dh0 = None if h0 is None else torch.empty_like(h0)
    # in float32 words: the per-token decay terms, the per-chunk sums and
    # each 64-key tile's terms of R (fp64), each chunk's cum (fp64) and dt
    # (each 16-byte aligned: 6 words of slack), the chunk state gradients
    # and decays (more than one chunk), the dB and dC partials of each run
    # of heads
    rows, chunks, lpad = Bsz * S * H, Bsz * nc * H, -(-L // 64) * 64
    parts = Bsz * S * bwd_partials(H, G, x.dtype) * N
    scratch = torch.empty(2 * (3 * rows + 2 * chunks + lpad // 64 * rows
                               + chunks * lpad) + 6 + chunks * lpad
                          + (nc > 1) * chunks * (P * N + 1) + 2 * parts,
                          dtype=torch.float32, device=x.device)
    lib = cuda_build.library()
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), None if h0 is None else h0.data_ptr(),
            None if states is None else states.data_ptr(), slots,
            dy.data_ptr(), None if dhT is None else dhT.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), None if dh0 is None else dh0.data_ptr(),
            scratch.data_ptr(), Bsz, S, H, P, G, N, int(chunk),
            _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1
    return dx, ddt, dA, dB, dC, dh0


ssd_scan_bwd.launches = 0   # kernel calls (plain-version calls excluded)


class SSDScan(torch.autograd.Function):
    """Differentiable SSD scan: saves the inputs and, on the card, the
    forward's state scratch, so the backward re-runs no forward phase.
    A dropped final state reaches the backward as None (no zeros are
    made for it)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, h0, chunk, final):
        ctx.set_materialize_grads(False)
        if x.device.type == "cpu":
            out = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk, h0=h0,
                                 return_final_state=final)
            y, hT = out if final else (out, None)
            states = None
        else:
            y, hT, states = _forward(x, dt, A, Bm, Cm, h0, chunk, final)
        ctx.save_for_backward(x, dt, A, Bm, Cm, h0, states)
        ctx.chunk = chunk
        return (y, hT) if final else y

    @staticmethod
    def backward(ctx, dy, dhT=None):
        x, dt, A, Bm, Cm, h0, states = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        grads = ssd_scan_bwd(x, dt, A, Bm, Cm, h0, dy,
                             None if dhT is None else dhT.contiguous(),
                             chunk=ctx.chunk, states=states)
        return (*grads, None, None)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int, h0=None,
             return_final_state: bool = False):
    """x: [B, S, H, P]; dt: [B, S, H] fp32; A: [H] fp32; Bm, Cm: [B, S, G, N];
    h0: optional [B, H, P, N] fp32.  Returns y [B, S, H, P] in x's dtype,
    and the final state [B, H, P, N] fp32 if ``return_final_state``.
    Differentiable on both devices (the backward is a kernel on the card).
    A ``chunk`` the kernel cannot take (``chunk_ok``) is refused on either
    device."""
    _check_chunk(chunk)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, A, Bm, Cm, h0)):
        return SSDScan.apply(x, dt, A, Bm, Cm, h0, chunk, return_final_state)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk, h0=h0,
                              return_final_state=return_final_state)
    y, hT, _ = _forward(x, dt, A, Bm, Cm, h0, chunk, return_final_state)
    return (y, hT) if return_final_state else y


ssd_scan.launches = 0   # kernel calls (plain-version calls excluded)
