"""Mamba-2 SSD chunked scan: the wrapper around the CUDA kernel
``csrc/ssd_scan.cu`` (which replaces the Pallas TPU kernel
``repro/kernels/ssd_scan.py::ssd_scan``) and its plain PyTorch version.

``ssd_scan`` takes the plain version for tensors on the CPU, and only
then; for CUDA tensors it launches the kernel or raises.  Unlike the
Pallas wrapper it needs no ``S % chunk == 0``: the kernel's last chunk is
shorter, which computes what the plain version's dt = 0 padding does.

The kernel runs in chunk-parallel phases (chunk states, a sequential pass
over the states, the chunk scan; see the source): ``chunk_plan`` gives
the chunks, the state slots of the fp32 scratch this wrapper allocates,
and the launches of one call.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.grad_guard import refuse_grad
from repro_torch.kernels.ref import ssd_chunked_ref

# (P, N) = (head dim, state dim) pairs the kernel is instantiated for
# (csrc/ssd_scan.cu): the reduced and the full mamba2-130m heads; another
# pair is one more line in each file
SUPPORTED_DIMS = frozenset({(32, 16), (64, 128)})
MAX_CHUNK = 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the plain PyTorch version the kernel is held against
ssd_scan_plain = ssd_chunked_ref


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
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan kernel: chunk={chunk} outside "
                         f"(0, {MAX_CHUNK}]")
    if not all(t.is_contiguous() for t in (x, *ts)):
        raise ValueError("ssd_scan kernel: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, Bm, Cm, h0) if t is not None):
        raise ValueError("ssd_scan kernel: x, B, C and h0 must start on a "
                         "16-byte boundary (the tiles are copied in 16-byte "
                         "pieces)")


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int, h0=None,
             return_final_state: bool = False):
    """x: [B, S, H, P]; dt: [B, S, H] fp32; A: [H] fp32; Bm, Cm: [B, S, G, N];
    h0: optional [B, H, P, N] fp32.  Returns y [B, S, H, P] in x's dtype,
    and the final state [B, H, P, N] fp32 if ``return_final_state``."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk, h0=h0,
                              return_final_state=return_final_state)
    refuse_grad("ssd_scan", "ROADMAP Next slices: Mamba training brings "
                "the ssd_scan backward", x, dt, A, Bm, Cm, h0)
    _check(x, dt, A, Bm, Cm, h0, chunk)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.empty_like(x)
    hT = (torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
          if return_final_state else None)
    _, nc, slots, _ = chunk_plan(S, chunk, return_final_state)
    states = decay = None
    if nc > 1:   # chunk states [B, slots, H, P, N], then decays [B, slots, H]
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
    return (y, hT) if return_final_state else y


ssd_scan.launches = 0   # kernel calls (plain-version calls excluded)
