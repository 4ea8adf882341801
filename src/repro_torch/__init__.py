"""PyTorch/CUDA port of the ``repro`` model substrate, for one NVIDIA H100.

Imports ``torch`` and numpy only, never JAX and nothing of ``repro``.  Each
module mirrors the reference module of the same relative path; the Pallas
TPU kernels on the ported path are hand-written CUDA C++ for ``sm_90a``
under ``kernels/csrc/``.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""
