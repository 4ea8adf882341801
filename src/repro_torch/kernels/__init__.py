# Hand-written CUDA kernels (sm_90a) for the port's hot spots, each beside
# its plain PyTorch version:
#   flash_attention.py  — GQA flash attention, forward and backward, an
#                         autograd Function (csrc/flash_attention.cu,
#                         csrc/flash_attention_bwd.cu)
#   decode_attention.py — Sq=1 GQA decode over a ragged KV cache, dense or
#                         paged (csrc/decode_attention.cu)
#   ssd_scan.py         — Mamba-2 SSD chunked scan, forward and backward,
#                         an autograd Function (csrc/ssd_scan.cu,
#                         csrc/ssd_scan_bwd.cu)
#   ops.py              — the ops the models call, dispatched by device
#   work.py             — each kernel's bytes and flops, the H100's peaks,
#                         and the dry-run's count that the meta branches
#                         record into
#   ref.py              — plain PyTorch oracles
#   grad_guard.py       — the no-grad rule of the decode kernels (no backward)
#   cuda_build.py       — nvcc build at first use + ctypes binding
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
