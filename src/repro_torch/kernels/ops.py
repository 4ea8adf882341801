"""Public attention ops the models call, dispatched by the tensors' device.

* a CPU tensor goes to the kernel's plain PyTorch version;
* a CUDA tensor goes to the hand-written CUDA kernel, or the call raises.

No environment variable or flag selects the plain version for a CUDA
tensor.  The block/chunk knobs of ``repro.kernels.ops`` (tune-cache
lookups) have no counterpart yet: each kernel uses its built-in tiles.
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                    q_offset: int = 0):
    """GQA flash attention. q: [B,Sq,H,D], k/v: [B,Sk,K,D|Dv] -> [B,Sq,H,Dv]."""
    return _flash.flash_attention(q, k, v, causal=causal, scale=scale,
                                  q_offset=q_offset)


def decode_attention(q, k, v, kv_len, *, scale: float | None = None):
    """Sq=1 GQA decode attention over a ragged KV cache.

    q: [B,H,D], k/v: [B,Sk,K,D|Dv], kv_len: [B] int32 -> [B,H,Dv]."""
    return _decode.decode_attention(q, k, v, kv_len, scale=scale)
