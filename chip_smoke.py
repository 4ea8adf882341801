#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version, then drives the port's three
main paths at full width (bf16, random weights from a seed), each with the
kernel launch counts set to 0 just before it and read just after:

1. dense ``smollm-360m``: ``lm.prefill`` on a [4, 256] batch, and
   ``DecodeEngine`` serving 12 greedy requests (fused and host modes);
2. paged ``smollm-360m``: the same 12 requests with ``kv_layout="paged"``
   (page size 16) in fused and host modes with the default pool, and in
   fused mode with a 64-page pool that forces preemption; tokens must
   equal the dense run's;
3. ``mamba2-130m``: ``lm.prefill`` on a [2, 1024] batch against the
   all-plain path, and ``DecodeEngine`` serving 12 greedy requests, fused
   tokens equal to host tokens.

Each phase prints one JSON line; any failure raises and the script exits
non-zero.  The line before the last is ``{"kernels": [...]}``, the last
line ``{"ok": true, "device": {...}}``.  It imports nothing of JAX or of
the JAX package, and exits non-zero without a result when no CUDA device
is present.

Numerics: fp32 matmuls run in full fp32 (TF32 off for matmuls and cuDNN).
Tolerances, kernel vs plain version on the same inputs: attention fp32
atol = rtol = 1e-4 (the kernels sum in another order than the plain
version), bf16 5e-2 (the JAX package's own bound for its kernels); SSD
scan fp32 2e-3 and bf16 1e-1 (the JAX package's own bound for its SSD
kernel: the chunked sums of decayed terms are reassociated).
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=5e-2, rtol=5e-2)}
SSD_TOL = {torch.float32: dict(atol=2e-3, rtol=2e-3),
           torch.bfloat16: dict(atol=1e-1, rtol=1e-1)}
# H100 SXM published peaks (dense), for the bound of each kernel
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
L2_BYTES = 50 * 2**20
DEVICE = "cuda"     # every tensor and engine of the run lives here


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------
def _dev_us(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def _device_events(prof) -> list:
    """The profile's device-side activities (kernels, copies, memsets); the
    host ops that launched them are left out so no time counts twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _dev_us(e) > 0]


def time_ms(fn, argsets, iters: int = 30) -> tuple[float, float]:
    """(device ms, call ms) of one call of ``fn``, cycling through
    ``argsets`` (distinct copies of the inputs, so that consecutive calls do
    not find their operands in L2).  Device ms is the summed time of every
    kernel the call runs, from the profiler; call ms is CUDA-event time per
    call of back-to-back calls, which includes the host's launch gaps when
    the host is slower than the device."""
    from torch.profiler import ProfilerActivity, profile

    for a in argsets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*argsets[i % len(argsets)])
    end.record()
    end.synchronize()
    call_ms = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*argsets[i % len(argsets)])
        torch.cuda.synchronize()
    device_us = sum(_dev_us(e) for e in _device_events(prof))
    return device_us / 1e3 / iters, call_ms


def timed(kernel, plain, library, argsets) -> dict:
    """Kernel, plain-version and library-call times on the same inputs, in
    turns (kernel, plain, library, library, plain, kernel); each is the
    mean of its two turns.  ``library`` None (no single PyTorch call
    computes the function) gives ``library_ms`` None."""
    order = [("", kernel), ("plain_", plain)]
    if library is not None:
        order.append(("library_", library))
    runs: dict = {}
    for prefix, fn in order + order[::-1]:
        dev, call = time_ms(fn, argsets)
        runs.setdefault(prefix, []).append((dev, call))
    out = {f"{p}{k}": sum(r[i] for r in rs) / len(rs)
           for p, rs in runs.items() for i, k in ((0, "ms"), (1, "call_ms"))}
    if library is None:
        out["library_ms"] = out["library_call_ms"] = None
    return out


def copies(tensors, nbytes_each: int) -> list:
    """Enough copies of ``tensors`` to exceed twice the L2 cache."""
    n = max(2, min(16, math.ceil(2 * L2_BYTES / max(nbytes_each, 1))))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(dtype, n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = n_flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def flash_work(q, k, v, q_offset: int) -> tuple[int, int]:
    """Bytes (inputs read once, output written once) and flops of causal
    attention: 2 * (D + Dv) per live (query head, key) pair."""
    B, Sq, H, D = q.shape
    Sk, Dv = k.shape[1], v.shape[3]
    live = sum(min(Sk, max(0, t + q_offset + 1)) for t in range(Sq))
    out_bytes = B * Sq * H * Dv * q.element_size()
    return nbytes(q, k, v) + out_bytes, 2 * B * H * (D + Dv) * live


def decode_work(q, k, v, kv_len) -> tuple[int, int]:
    """Bytes of the live cache rows, q, kv_len and the output; flops
    2 * (D + Dv) per live (query head, key) pair."""
    B, H, D = q.shape
    K, Dv = k.shape[2], v.shape[3]
    live = int(kv_len.clamp(0, k.shape[1]).sum())
    row_bytes = K * (D + Dv) * k.element_size()
    out_bytes = B * H * Dv * q.element_size()
    return (live * row_bytes + nbytes(q, kv_len) + out_bytes,
            2 * H * (D + Dv) * live)


def paged_work(q, k_pool, v_pool, page_table, kv_len) -> tuple[int, int]:
    """Bytes of the live rows (read through the table), q, the table,
    kv_len and the output; flops 2 * (D + Dv) per live (query head, key)
    pair."""
    B, H, D = q.shape
    K, Dv = k_pool.shape[2], v_pool.shape[3]
    cap = page_table.shape[1] * k_pool.shape[1]
    live = int(kv_len.clamp(0, cap).sum())
    row_bytes = K * (D + Dv) * k_pool.element_size()
    out_bytes = B * H * Dv * q.element_size()
    return (live * row_bytes + nbytes(q, page_table, kv_len) + out_bytes,
            2 * H * (D + Dv) * live)


def ssd_work(x, dt, Bm, chunk: int, h0=None) -> tuple[int, int]:
    """Bytes of x, dt, B, C, y, h0 and hT (each once); flops per (b, h,
    chunk of L tokens): C.B^T and scores.x over the L(L+1)/2 causal pairs
    (2N and 2P each), C.h and the state update (2LPN each)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[3]
    state = Bsz * H * P * N * 4
    n_bytes = (2 * nbytes(x) + nbytes(dt) + 2 * nbytes(Bm) + state
               + (state if h0 is not None else 0))
    L = min(chunk, S)
    lens = [L] * (S // L) + ([S % L] if S % L else [])
    per_bh = sum(n * (n + 1) // 2 * 2 * (N + P) + 4 * n * P * N
                 for n in lens)
    return n_bytes, Bsz * H * per_bh


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_device() -> tuple[str, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "capability": list(torch.cuda.get_device_capability(0))})
    return smi, name


def phase_build(cuda_build) -> None:
    t0 = time.perf_counter()
    cuda_build.library()
    seconds = time.perf_counter() - t0
    log = cuda_build.build_log_path()
    # each kernel's name (mangled), then its registers and spills
    keep = ("Compiling entry function", "registers", "spill")
    ptxas = ([ln.strip() for ln in log.read_text().splitlines()
              if any(w in ln for w in keep)] if log.exists() else [])
    emit({"phase": "build", "seconds": seconds,
          "library": str(cuda_build.library_path().name), "ptxas": ptxas})


def rand(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device=DEVICE,
                       dtype=torch.float32).to(dtype)


def check_close(name, got, want, dtype) -> float:
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output has non-finite values")
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype],
                               msg=lambda m: f"{name}: {m}")
    return err


def phase_kernels(fa, da) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    F = torch.nn.functional
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    errs = {"flash_attention": 0.0, "decode_attention": 0.0}
    H, K, D = 15, 5, 64
    # flash: (B, Sq, Sk, q_offset, H, K, D, Dv); causal; smollm's heads,
    # G 1 and 8, D != Dv, and a short chunk at the end with D 128
    for dtype in (torch.float32, torch.bfloat16):
        cases = [(2, 512, 512, 0, H, K, D, D), (2, 333, 333, 0, H, K, D, D),
                 (2, 64, 512, 448, H, K, D, D), (1, 100, 100, 0, 4, 2, 48, 32),
                 (2, 256, 256, 0, K, K, D, D), (2, 200, 200, 0, 8 * K, K, D, D),
                 (1, 7, 300, 293, 24, 3, 128, 128)]
        for B, Sq, Sk, off, h, kh, d, dv in cases:
            q = rand((B, Sq, h, d), dtype, gen)
            k = rand((B, Sk, kh, d), dtype, gen)
            v = rand((B, Sk, kh, dv), dtype, gen)
            got = fa.flash_attention(q, k, v, causal=True, q_offset=off)
            want = fa.flash_attention_plain(q, k, v, causal=True, q_offset=off)
            torch.cuda.synchronize()
            err = check_close(f"flash {dtype} {(B, Sq, Sk, off, h, kh, d, dv)}",
                              got, want, dtype)
            errs["flash_attention"] = max(errs["flash_attention"], err)
            emit({"phase": "kernels", "kernel": "flash_attention",
                  "dtype": str(dtype), "B": B, "Sq": Sq, "Sk": Sk,
                  "q_offset": off, "H": h, "K": kh, "D": d, "Dv": dv,
                  "max_abs_err": err})
    # decode: ragged kv_len including 1 and Sk, poisoned tail; then the
    # split edges (L 64: 1, L-1, L, L+1, Sk) with a kv_len = 0 slot, also
    # at an Sk that L does not divide; a second call must be bit-identical
    B = 8
    edge = [0, 1, 63, 64, 65, 128, 129]
    for Sk, lens in ((1024, [1, 1024, 17, 300, 513, 777, 64, 1000]),
                     (1024, edge + [1024]), (1000, edge + [1000])):
        kv_len = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            q = rand((B, H, D), dtype, gen)
            k = rand((B, Sk, K, D), dtype, gen)
            v = rand((B, Sk, K, D), dtype, gen)
            got = da.decode_attention(q, k, v, kv_len)
            again = da.decode_attention(q, k, v, kv_len)
            want = da.decode_attention_plain(q, k, v, kv_len)
            dead = torch.arange(Sk, device=DEVICE)[None, :] >= kv_len[:, None]
            k[dead], v[dead] = 1e4, 1e4
            poisoned = da.decode_attention(q, k, v, kv_len)
            torch.cuda.synchronize()
            live = kv_len > 0     # the plain version gives NaN at kv_len 0
            err = check_close(f"decode {dtype} Sk={Sk} {lens}", got[live],
                              want[live], dtype)
            if not torch.equal(got[~live], torch.zeros_like(got[~live])):
                raise AssertionError("decode: kv_len = 0 did not give 0")
            if not torch.equal(again, got):
                raise AssertionError("decode: two calls differ")
            if not torch.equal(poisoned, got):
                raise AssertionError("decode: rows past kv_len changed the "
                                     "output")
            errs["decode_attention"] = max(errs["decode_attention"], err)
            emit({"phase": "kernels", "kernel": "decode_attention",
                  "dtype": str(dtype), "B": B, "Sk": Sk, "H": H, "K": K,
                  "D": D, "split": list(da.split_plan(Sk)), "kv_len": lens,
                  "max_abs_err": err, "repeat_identical": True,
                  "poisoned_tail_identical": True})
    kv_len = torch.tensor([1, 1024, 17, 300, 513, 777, 64, 1000],
                          dtype=torch.int32, device=DEVICE)

    # times at the main path's shapes, bf16
    dt = torch.bfloat16
    rows = {}
    B, S = 4, 256                       # phase-4 prefill batch
    q, k, v = (rand((B, S, H, D), dt, gen), rand((B, S, K, D), dt, gen),
               rand((B, S, K, D), dt, gen))
    argsets = copies((q, k, v), nbytes(q, k, v))
    n_bytes, n_flops = flash_work(q, k, v, 0)
    b_ms, b_by = bound(dt, n_bytes, n_flops)
    rows["flash_attention"] = {
        "shape": {"B": B, "Sq": S, "Sk": S, "H": H, "K": K, "D": D,
                  "dtype": "bfloat16", "causal": True},
        **timed(lambda a, b, c: fa.flash_attention(a, b, c),
                lambda a, b, c: fa.flash_attention_plain(a, b, c),
                lambda a, b, c: F.scaled_dot_product_attention(
                    a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
                    is_causal=True, enable_gqa=True), argsets),
        "bound_ms": b_ms, "bound_by": b_by}
    B, Sk = 8, 1024                     # phase-5 engine: 8 slots, max_seq 1024
    q, k, v = (rand((B, H, D), dt, gen), rand((B, Sk, K, D), dt, gen),
               rand((B, Sk, K, D), dt, gen))
    argsets = [a + (kv_len,) for a in copies((q, k, v), nbytes(q, k, v))]
    mask = (torch.arange(Sk, device=DEVICE)[None, :]
            < kv_len[:, None])[:, None, None, :]
    n_bytes, n_flops = decode_work(q, k, v, kv_len)
    b_ms, b_by = bound(dt, n_bytes, n_flops)
    rows["decode_attention"] = {
        "shape": {"B": B, "Sk": Sk, "H": H, "K": K, "D": D,
                  "dtype": "bfloat16", "kv_len": kv_len.tolist()},
        **timed(lambda a, b, c, n: da.decode_attention(a, b, c, n),
                lambda a, b, c, n: da.decode_attention_plain(a, b, c, n),
                lambda a, b, c, n: F.scaled_dot_product_attention(
                    a[:, :, None], b.transpose(1, 2), c.transpose(1, 2),
                    attn_mask=mask, enable_gqa=True), argsets),
        "bound_ms": b_ms, "bound_by": b_by}
    for name, row in rows.items():
        row["max_abs_err"] = errs[name]
        row["library_ratio"] = row["ms"] / row["library_ms"]
        emit({"phase": "kernel_times", "kernel": name, **row})
    # decode device time against a uniform kv_len (the dead tail is skipped)
    sweep = {}
    for n in (1, 256, 1024):
        lens = torch.full((B,), n, dtype=torch.int32, device=DEVICE)
        sets = [a[:3] + (lens,) for a in argsets]
        sweep[n] = time_ms(lambda a, b, c, m: da.decode_attention(a, b, c, m),
                           sets)[0]
    emit({"phase": "kernel_times", "kernel": "decode_attention",
          "kv_len_sweep_ms": sweep})
    return rows


def paged_case(gen, dtype, B, W, ps, kv_len, H=15, K=5, D=64):
    """Pool, shuffled table (sentinel past each slot's kv_len) and inputs
    for the paged decode; the pool has B*W + 1 pages, as an engine's pool
    with its sink page."""
    P = B * W + 1
    q = rand((B, H, D), dtype, gen)
    kp = rand((P, ps, K, D), dtype, gen)
    vp = rand((P, ps, K, D), dtype, gen)
    table = torch.randperm(P, generator=gen, device=DEVICE)[:B * W]
    table = table.reshape(B, W).int()
    used = (kv_len.long() + ps - 1) // ps
    table[torch.arange(W, device=DEVICE)[None, :] >= used[:, None]] = P
    return q, kp, vp, table.contiguous()


def phase_kernels_paged(da) -> dict:
    """The paged decode kernel against its plain version: B 8, shuffled
    table, page sizes 16 and 7, ragged kv_len from 1 to W*ps, sentinel
    entries past kv_len, and every row no slot attends poisoned."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1)
    B, max_seq = 8, 1024
    err = 0.0
    for ps in (16, 7):
        W = -(-max_seq // ps)
        kv_len = torch.tensor([1, W * ps, 17, 300, 513, 777, 64, 1000],
                              dtype=torch.int32, device=DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, table = paged_case(gen, dtype, B, W, ps, kv_len)
            got = da.decode_attention_paged(q, kp, vp, table, kv_len)
            want = da.decode_attention_paged_plain(q, kp, vp, table, kv_len)
            dead = torch.ones(kp.shape[:2], dtype=torch.bool, device=DEVICE)
            for b, n in enumerate(kv_len.tolist()):
                for j in range(-(-n // ps)):
                    dead[table[b, j], :min(ps, n - j * ps)] = False
            kp[dead], vp[dead] = 1e4, -1e4
            poisoned = da.decode_attention_paged(q, kp, vp, table, kv_len)
            torch.cuda.synchronize()
            e = check_close(f"paged decode {dtype} ps={ps}", got, want, dtype)
            if not torch.equal(poisoned, got):
                raise AssertionError(f"paged decode ps={ps}: rows past "
                                     "kv_len changed the output")
            err = max(err, e)
            emit({"phase": "kernels", "kernel": "decode_attention_paged",
                  "dtype": str(dtype), "B": B, "page_size": ps, "W": W,
                  "pages": kp.shape[0], "kv_len": kv_len.tolist(),
                  "sentinel_entries": int((table == kp.shape[0]).sum()),
                  "max_abs_err": e, "poisoned_tail_identical": True})

    # time at the main path's shapes: 8 slots, max_seq 1024, page size 16
    dt, ps = torch.bfloat16, 16
    W = max_seq // ps
    kv_len = torch.tensor([1, 1024, 17, 300, 513, 777, 64, 1000],
                          dtype=torch.int32, device=DEVICE)
    q, kp, vp, table = paged_case(gen, dt, B, W, ps, kv_len)
    argsets = [a + (table, kv_len) for a in copies((q, kp, vp),
                                                   nbytes(q, kp, vp))]
    b_ms, b_by = bound(dt, *paged_work(q, kp, vp, table, kv_len))
    row = {"shape": {"B": B, "H": 15, "K": 5, "D": 64, "page_size": ps,
                     "W": W, "pages": kp.shape[0], "dtype": "bfloat16",
                     "kv_len": kv_len.tolist()},
           **timed(da.decode_attention_paged, da.decode_attention_paged_plain,
                   None, argsets),
           "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
           "library_ratio": None}
    emit({"phase": "kernel_times", "kernel": "decode_attention_paged", **row})
    return {"decode_attention_paged": row}


def ssd_case(gen, dtype, B, S, H=24, P=64, G=1, N=128, h0=False):
    x = rand((B, S, H, P), dtype, gen)
    dt = torch.nn.functional.softplus(rand((B, S, H), torch.float32, gen))
    A = -torch.exp(0.3 * rand((H,), torch.float32, gen))
    Bm, Cm = rand((B, S, G, N), dtype, gen), rand((B, S, G, N), dtype, gen)
    h = rand((B, H, P, N), torch.float32, gen) if h0 else None
    return x, dt, A, Bm, Cm, h


def phase_kernels_ssd(ssd) -> dict:
    """The SSD scan kernel against ssd_chunked_ref at the full mamba2-130m
    head (H 24, P 64, N 128, one group): S 1024 in chunks of 256, a ragged
    S 1000, and S 64 in one chunk of 64 from an h0; y and the final state."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2)
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for S, chunk, h0 in ((1024, 256, False), (1000, 256, False),
                             (64, 64, True)):
            x, dt, A, Bm, Cm, h = ssd_case(gen, dtype, 2, S, h0=h0)
            y, hT = ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h,
                                 return_final_state=True)
            y_ref, hT_ref = ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk,
                                               h0=h, return_final_state=True)
            torch.cuda.synchronize()
            for what, got, want in (("y", y, y_ref), ("state", hT, hT_ref)):
                if not torch.isfinite(got.float()).all():
                    raise AssertionError(f"ssd {what}: non-finite values")
                torch.testing.assert_close(
                    got.float(), want.float(), **SSD_TOL[dtype],
                    msg=lambda m, w=f"ssd {dtype} S={S} {what}": f"{w}: {m}")
            e_y = (y.float() - y_ref.float()).abs().max().item()
            e_h = (hT - hT_ref).abs().max().item()
            err = max(err, e_y)
            emit({"phase": "kernels", "kernel": "ssd_scan",
                  "dtype": str(dtype), "B": 2, "S": S, "chunk": chunk,
                  "H": 24, "P": 64, "N": 128, "G": 1, "h0": h0,
                  "max_abs_err_y": e_y, "max_abs_err_state": e_h,
                  "max_abs_y": y_ref.float().abs().max().item(),
                  "max_abs_state": hT_ref.abs().max().item()})

    # time at the main path's shape: the mamba prefill [2, 1024], bf16
    dt_ = torch.bfloat16
    x, dt, A, Bm, Cm, _ = ssd_case(gen, dt_, 2, 1024)
    argsets = [(a[0], a[1], A, a[2], a[3]) for a in copies(
        (x, dt, Bm, Cm), nbytes(x, dt, Bm, Cm))]
    b_ms, b_by = bound(dt_, *ssd_work(x, dt, Bm, 256))
    row = {"shape": {"B": 2, "S": 1024, "H": 24, "P": 64, "N": 128, "G": 1,
                     "chunk": 256, "dtype": "bfloat16"},
           **timed(lambda *a: ssd.ssd_scan(*a, chunk=256,
                                           return_final_state=True),
                   lambda *a: ssd.ssd_scan_plain(*a, chunk=256,
                                                 return_final_state=True),
                   None, argsets),
           "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
           "library_ratio": None}
    emit({"phase": "kernel_times", "kernel": "ssd_scan", **row})
    return {"ssd_scan": row}


@contextlib.contextmanager
def plain_attention(ops, ref):
    """Route the models' attention ops through the plain versions (the
    comparison run only; the port has no such switch)."""
    saved = ops.flash_attention, ops.decode_attention
    ops.flash_attention = ref.attention_ref
    ops.decode_attention = ref.decode_attention_ref
    try:
        yield
    finally:
        ops.flash_attention, ops.decode_attention = saved


def phase_prefill(cfg, params, lm, ops, ref, fa) -> None:
    B, S = 4, 256
    rng = np.random.default_rng(0)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                          device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = lm.prefill(cfg, params, {"tokens": tokens})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    if launches <= 0:
        raise AssertionError("prefill did not launch the flash kernel")
    want_shape = (B, cfg.vocab_size)
    if tuple(logits.shape) != want_shape or not torch.isfinite(
            logits.float()).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             f"finite {want_shape}")
    kv_shape = (cfg.num_layers, B, S, cfg.num_kv_heads, cfg.head_dim)
    if tuple(caches[0]["k"].shape) != kv_shape:
        raise AssertionError(f"prefill cache {tuple(caches[0]['k'].shape)}")
    with plain_attention(ops, ref):
        plain, _ = lm.prefill(cfg, params, {"tokens": tokens})
    torch.cuda.synchronize()
    diff = (logits.float() - plain.float()).abs()
    err = diff.max().item()
    # how much of the bound the worst logit uses (the check passes at <= 1)
    margin = (diff / (5e-2 + 5e-2 * plain.float().abs())).max().item()
    agree = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    emit({"phase": "prefill", "batch": [B, S], "layers": cfg.num_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "seconds": seconds, "flash_launches": launches,
          "max_abs_err_vs_plain": err, "bound_used": margin,
          "max_abs_logit": plain.float().abs().max().item(),
          "top1_agreement": agree})
    # bf16 through 32 layers: the JAX package's bf16 kernel bound
    torch.testing.assert_close(logits.float(), plain.float(), atol=5e-2,
                               rtol=5e-2)


def no_host_sync(fn):
    """``fn`` with torch's sync debug mode at "error": any call in it that
    waits for the device raises."""
    def wrapped(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return wrapped


def prompts_for(cfg, seed: int = 0, n: int = 12):
    """``n`` prompts of 16-300 tokens from a seed."""
    rng = np.random.default_rng(seed)
    plens = rng.integers(16, 301, n)
    return [rng.integers(0, cfg.vocab_size, int(k)).astype(np.int32)
            for k in plens]


def serve(cfg, params, DecodeEngine, Request, prompts, counter, label: str,
          mode: str, **engine_kw) -> list:
    """Serve ``prompts`` (32 greedy tokens each) through a ``DecodeEngine``
    with 8 slots, max_seq 1024, 8 steps per sync and prefill chunk 64;
    check every request completes with 32 tokens and ``counter``'s kernel
    launched.  Returns (tokens, the engine's ``kv_stats()``)."""
    eng = DecodeEngine(cfg, params, batch_slots=8, max_seq=1024, mode=mode,
                       steps_per_sync=8, prefill_chunk=64, device=DEVICE,
                       **engine_kw)
    if mode == "fused":
        eng._fused_steps = no_host_sync(eng._fused_steps)
    reqs = [Request(prompt=p, max_new_tokens=32) for p in prompts]
    for r in reqs:
        eng.submit(r)
    before = counter.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = [i for i, r in enumerate(reqs)
           if r.failed or not r.done or len(r.output) != 32]
    if bad:
        raise AssertionError(f"{label} {mode}: requests {bad} did not "
                             "complete with 32 tokens")
    launches = counter.launches - before
    if launches <= 0:
        raise AssertionError(f"{label} {mode}: no {counter.__name__} launch")
    total = sum(len(r.output) for r in reqs)
    emit({"phase": "serve", "path": label, "mode": mode,
          "requests": len(reqs),
          "host_syncs_in_fused_loop": 0 if mode == "fused" else None,
          "prompt_lens": [len(p) for p in prompts], "tokens": total,
          "steps": steps, "wall_s": wall, "tokens_per_s": total / wall,
          f"{counter.__name__}_launches": launches,
          "kv_stats": eng.kv_stats()})
    return [list(r.output) for r in reqs], eng.kv_stats()


def differ(a, b) -> list:
    return [i for i, (x, y) in enumerate(zip(a, b, strict=True)) if x != y]


def phase_serve(cfg, params, DecodeEngine, Request, da) -> list:
    """Dense smollm-360m serving, fused and host; the tokens must agree."""
    prompts = prompts_for(cfg)
    out = {mode: serve(cfg, params, DecodeEngine, Request, prompts,
                       da.decode_attention, "dense", mode)[0]
           for mode in ("fused", "host")}
    if out["fused"] != out["host"]:
        raise AssertionError(f"dense: fused and host tokens differ for "
                             f"requests {differ(out['fused'], out['host'])}")
    emit({"phase": "serve", "path": "dense", "host_equals_fused": True})
    return out["fused"]


def phase_serve_paged(cfg, params, DecodeEngine, Request, da, dense) -> None:
    """Paged smollm-360m serving, page size 16: the default pool (capacity
    parity, 512 pages) in fused and host modes, and a 64-page pool (1,024
    rows against the dense layout's 8,192; the least the engine takes) in
    fused mode, which must preempt.  Every run's tokens equal ``dense``."""
    prompts = prompts_for(cfg)
    for mode, kw in (("fused", {}), ("host", {}),
                     ("fused", {"num_pages": 64})):
        got, stats = serve(cfg, params, DecodeEngine, Request, prompts,
                           da.decode_attention_paged,
                           "paged" if not kw else "paged_small_pool", mode,
                           kv_layout="paged", page_size=16, **kw)
        if got != dense:
            raise AssertionError(f"paged {mode} {kw}: tokens differ from "
                                 f"dense for requests {differ(got, dense)}")
        if stats["used_pages"] or (kw and stats["preemptions"] < 1):
            raise AssertionError(f"paged {mode} {kw}: pool stats {stats}")
    emit({"phase": "serve", "path": "paged", "tokens_equal_dense": True})


@contextlib.contextmanager
def plain_ssd(ops, ref):
    """Route the models' SSD scan through its plain version (the
    comparison run only; the port has no such switch)."""
    saved = ops.ssd_scan
    ops.ssd_scan = ref.ssd_chunked_ref
    try:
        yield
    finally:
        ops.ssd_scan = saved


def phase_mamba(lm, ops, ref, ssd, DecodeEngine, Request) -> None:
    """Full-width mamba2-130m (bf16, random weights from a seed):
    ``lm.prefill`` on [2, 1024] through the kernel, held against the
    all-plain path, then 12 greedy requests served in fused and host modes,
    whose tokens must agree.

    The prefill check has two parts, because this random-weight model
    amplifies rounding noise through its 24 layers: the bf16 plain path
    itself lands far from the same weights' fp32 logits (the line reports
    how far), so a fixed bf16 bound between two paths that round in
    different places says little.  (1) An fp32 copy of the weights, through
    the kernel and through the plain path, must agree within atol = rtol =
    1e-2: the scan's own fp32 error (within the JAX package's 2e-3 SSD
    bound per call) carried through 24 layers.  (2) The bf16 kernel path
    may be no further from the fp32 plain logits than twice the bf16 plain
    path is.  The measurements are printed before either check raises."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import cast_tree

    cfg = get_config("mamba2-130m")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    params = lm.init_lm(cfg, gen, DEVICE)
    B, S = 2, 1024
    rng = np.random.default_rng(0)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                          device=DEVICE)
    lm.prefill(cfg, params, {"tokens": tokens[:, :64]})       # warm-up
    before = ssd.ssd_scan.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = lm.prefill(cfg, params, {"tokens": tokens})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ssd.ssd_scan.launches - before
    if launches != cfg.num_layers:
        raise AssertionError(f"mamba prefill: {launches} ssd_scan launches")
    if tuple(logits.shape) != (B, cfg.vocab_size) or not torch.isfinite(
            logits.float()).all():
        raise AssertionError(f"mamba prefill logits {tuple(logits.shape)}")
    H, P, N = cfg.ssm.n_heads(cfg.d_model), cfg.ssm.head_dim, cfg.ssm.d_state
    if tuple(caches[0]["ssm"].shape) != (cfg.num_layers, B, H, P, N):
        raise AssertionError(f"mamba state {tuple(caches[0]['ssm'].shape)}")
    p32 = cast_tree(params, torch.float32)
    logits32, _ = lm.prefill(cfg, p32, {"tokens": tokens})
    with plain_ssd(ops, ref):
        plain, _ = lm.prefill(cfg, params, {"tokens": tokens})
        plain32, _ = lm.prefill(cfg, p32, {"tokens": tokens})
    torch.cuda.synchronize()
    del p32
    err32 = (logits32 - plain32).abs().max().item()
    err = (logits.float() - plain.float()).abs().max().item()
    kernel_off = (logits.float() - plain32).abs().max().item()
    plain_off = (plain.float() - plain32).abs().max().item()
    agree = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    emit({"phase": "mamba_prefill", "batch": [B, S], "layers": cfg.num_layers,
          "d_model": cfg.d_model, "heads": H, "P": P, "N": N,
          "chunk": cfg.ssm.chunk, "vocab": cfg.vocab_size,
          "seconds": seconds, "tokens_per_s": B * S / seconds,
          "ssd_launches": launches,
          "fp32_max_abs_err_vs_plain": err32,
          "fp32_bound": "atol = rtol = 1e-2",
          "bf16_max_abs_err_vs_plain": err,
          "bf16_kernel_vs_fp32_plain": kernel_off,
          "bf16_plain_vs_fp32_plain": plain_off,
          "bf16_bound": "kernel path within 2x the plain path's distance "
                        "from the fp32 logits",
          "max_abs_logit": plain32.abs().max().item(),
          "top1_agreement_bf16": agree,
          "top1_agreement_fp32": (logits32.argmax(-1)
                                  == plain32.argmax(-1)).float().mean().item()})
    torch.testing.assert_close(logits32, plain32, atol=1e-2, rtol=1e-2)
    if not kernel_off <= 2 * plain_off:
        raise AssertionError(f"mamba bf16 prefill: kernel path {kernel_off} "
                             f"from the fp32 logits, plain path {plain_off}")
    prompts = prompts_for(cfg, seed=1)
    out = {mode: serve(cfg, params, DecodeEngine, Request, prompts,
                       ssd.ssd_scan, "mamba", mode)[0]
           for mode in ("fused", "host")}
    if out["fused"] != out["host"]:
        raise AssertionError(f"mamba: fused and host tokens differ for "
                             f"requests {differ(out['fused'], out['host'])}")
    emit({"phase": "serve", "path": "mamba", "host_equals_fused": True})
    phase_profile(cfg, params, DecodeEngine, Request, "mamba")


def phase_profile(cfg, params, DecodeEngine, Request, label: str,
                  **engine_kw) -> None:
    """Where a steady fused decode sync spends its time: 8 slots at prompt
    length 200, after prefill.  Two syncs (16 steps) are timed without the
    profiler, the next two profiled; the idle share is 1 - device busy time
    (profiled) over the unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(1)
    eng = DecodeEngine(cfg, params, batch_slots=8, max_seq=1024, mode="fused",
                       steps_per_sync=8, prefill_chunk=64, device=DEVICE,
                       **engine_kw)
    for _ in range(8):
        eng.submit(Request(prompt=rng.integers(0, cfg.vocab_size, 200)
                           .astype(np.int32), max_new_tokens=64))
    while eng.pf_done.max() < eng.pf_target.max() or eng.steps == 0:
        eng.step()                      # admission, chunked prefill, warm-up
    torch.cuda.synchronize()
    steps0 = eng.steps
    t0 = time.perf_counter()
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    plain_steps = eng.steps - steps0
    steps0 = eng.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = eng.steps - steps0

    events = prof.key_averages()
    kernels = sorted(_device_events(prof), key=_dev_us,
                     reverse=True)
    busy_us = sum(_dev_us(e) for e in kernels)
    host = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)
    busy_ms = busy_us / 1e3 / steps
    wall_ms = plain_wall * 1e3 / plain_steps
    emit({"phase": "profile", "path": label,
          "what": "fused decode, 8 slots, 2 syncs",
          "steps": steps, "wall_ms_per_step": wall_ms,
          "profiled_wall_ms_per_step": wall * 1e3 / steps,
          "device_busy_ms_per_step": busy_ms,
          "device_idle_share": 1 - busy_ms / wall_ms,
          "top_device": [(e.key[:60], _dev_us(e) / 1e3 / steps, e.count // steps)
                         for e in kernels[:10]],
          "top_host_self": [(e.key[:60], e.self_cpu_time_total / 1e3 / steps,
                             e.count // steps) for e in host[:10]]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    sys.path.insert(0, str(src))
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_build, ops, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import lm
    from repro_torch.serve.engine import DecodeEngine, Request

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi, name = phase_device()
    phase_build(cuda_build)
    rows = phase_kernels(fa, da)
    rows.update(phase_kernels_paged(da))
    rows.update(phase_kernels_ssd(ssd))

    counters = {"flash_attention": fa.flash_attention,
                "decode_attention": da.decode_attention,
                "decode_attention_paged": da.decode_attention_paged,
                "ssd_scan": ssd.ssd_scan}

    def drive(path: str, kernels: tuple, fn, *args):
        """Run one main path with every launch count set to 0 just before
        it; read its kernels' counts just after, and fail on one that never
        launched."""
        for c in counters.values():
            c.launches = 0
        out = fn(*args)
        got = {k: counters[k].launches for k in kernels}
        emit({"phase": "main_path", "path": path, "launches": got,
              "other_launches": {k: c.launches for k, c in counters.items()
                                 if k not in kernels}})
        for kernel, n in got.items():
            if n <= 0:
                raise AssertionError(f"{kernel} never launched on the {path} "
                                     "path")
        launches.update(got)
        return out

    launches: dict = {}
    cfg = get_config("smollm-360m")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    params = lm.init_lm(cfg, gen, DEVICE)

    def dense_path():
        phase_prefill(cfg, params, lm, ops, ref, fa)
        return phase_serve(cfg, params, DecodeEngine, Request, da)

    dense = drive("dense smollm-360m", ("flash_attention", "decode_attention"),
                  dense_path)
    drive("paged smollm-360m", ("decode_attention_paged",), phase_serve_paged,
          cfg, params, DecodeEngine, Request, da, dense)
    phase_profile(cfg, params, DecodeEngine, Request, "dense")
    phase_profile(cfg, params, DecodeEngine, Request, "paged",
                  kv_layout="paged", page_size=16)
    del params
    torch.cuda.empty_cache()
    drive("mamba2-130m", ("ssd_scan",), phase_mamba, lm, ops, ref, ssd,
          DecodeEngine, Request)

    src_of = {"flash_attention": "flash_attention.cu",
              "decode_attention": "decode_attention.cu",
              "decode_attention_paged": "decode_attention.cu",
              "ssd_scan": "ssd_scan.cu"}
    replaces = {"flash_attention": "src/repro/kernels/flash_attention.py:106",
                "decode_attention": "src/repro/kernels/decode_attention.py:115",
                "decode_attention_paged":
                    "src/repro/kernels/decode_attention.py:236",
                "ssd_scan": "src/repro/kernels/ssd_scan.py:94"}
    kernels = [{"name": k, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{src_of[k]}",
                "replaces": replaces[k], "launches": launches[k],
                "max_abs_err": rows[k]["max_abs_err"], "ms": rows[k]["ms"],
                "plain_ms": rows[k]["plain_ms"], "bound_ms": rows[k]["bound_ms"],
                "bound_by": rows[k]["bound_by"],
                "library_ms": rows[k]["library_ms"],
                "library_ratio": rows[k]["library_ratio"]} for k in counters]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
