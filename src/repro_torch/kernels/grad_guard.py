"""The rule for CUDA kernels that have no backward kernel yet: the two
decode kernels (``decode_attention``, ``decode_attention_paged``; decoding
is never trained through).  Flash attention and the SSD scan have
backward kernels and autograd Functions.

Their wrappers fill an output through ctypes, which autograd cannot see:
the output would have no ``grad_fn`` and the inputs would silently get no
gradient through it.  So such a wrapper refuses, on a CUDA tensor, a call
that autograd would record.  (On the CPU the plain versions are
differentiable and need no guard.)
"""
from __future__ import annotations

import torch


def refuse_grad(what: str, roadmap: str, *tensors) -> None:
    """Raise if grad mode is on and any of ``tensors`` requires grad.

    ``roadmap`` names the ROADMAP item that brings ``what``'s backward."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward ({roadmap}); call it "
            "under torch.no_grad() or with inputs that do not require grad")
