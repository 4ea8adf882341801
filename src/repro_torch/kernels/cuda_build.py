"""Builds the port's CUDA kernels (``kernels/csrc/*.cu``) into one shared
library with a plain C interface and loads it with ctypes.

The build runs at first use, on the machine with the card: one ``nvcc -c``
per source, all started together, then one link.  The library lands in
``build/repro_torch/`` at the root of the checkout, named by a hash of the
sources, their headers and the flags, so a changed source is rebuilt and
an unchanged one is loaded as it is.  Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu",
           "decode_attention.cu", "ssd_scan.cu", "ssd_scan_bwd.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> argtypes (every one returns a cudaError_t as int)
SIGNATURES = {
    # q, k, v, out, lse (or null), B, Sq, Sk, H, K, D, Dv, scale, causal,
    # q_offset, block_q, block_k, dtype, stream
    "flash_attention_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _F, _I, _I, _I, _I, _I, _P),
    # q, k, v, out, lse, dout, dsum (scratch), dq, dk, dv, B, Sq, Sk, H, K,
    # D, Dv, scale, causal, q_offset, dtype, stream
    "flash_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                            _I, _I, _I, _I, _I, _F, _I, _I, _I, _P),
    # q, k, v, kv_len, out, part, counters, B, Sk, H, K, D, Dv, scale, L, S,
    # dtype, stream
    "decode_attention_fwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _F, _I, _I, _I, _P),
    # q, k_pool, v_pool, page_table, kv_len, out, part, counters, B, P, ps,
    # W, H, K, D, Dv, scale, L, S, dtype, stream
    "decode_attention_paged_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                   _I, _I, _I, _I, _I, _I, _F, _I, _I, _I,
                                   _P),
    # x, dt, A, Bm, Cm, h0 (or null), y, hT (or null), states, decay (both
    # null with one chunk), B, S, H, P, G, N, chunk, dtype, stream
    "ssd_scan_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                     _I, _I, _I, _I, _P),
    # x, dt, A, Bm, Cm, h0 (or null), states (or null), slots, dy, dhT (or
    # null), dx, ddt, dA, dB, dC, dh0 (or null), scratch, B, S, H, P, G, N,
    # chunk, dtype, stream
    "ssd_scan_bwd": (_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                     _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(p.name for p in CSRC.glob("*.cuh"))
    for name in (*SOURCES, *headers):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_{_digest()}.so"


def build_log_path() -> Path:
    return library_path().with_suffix(".log")


def _build(target: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        failed = [n for n, p in zip(SOURCES, procs, strict=True) if p.returncode]
        log = "".join(f"== {n}\n{t}" for n, t in zip(SOURCES, logs, strict=True))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        so = Path(tmp) / target.name
        link = subprocess.run([nvcc, "-shared", *map(str, objs), "-o", str(so)],
                              capture_output=True, text=True, check=False)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        (Path(tmp) / "build.log").write_text(log)
        os.replace(Path(tmp) / "build.log", target.with_suffix(".log"))
        os.replace(so, target)


def build() -> Path:
    """Build the kernels' shared library unless it is built already, and
    return its path.  Needs ``nvcc``, not a card: a process that will fork
    workers builds here without initialising CUDA or loading anything."""
    target = library_path()
    if not target.exists():
        _build(target)
    return target


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
