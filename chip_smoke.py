#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version, then drives the port's main
path at the full width of ``smollm-360m`` (bf16, random weights from a
seed): ``lm.prefill`` on a [4, 256] batch, and ``DecodeEngine`` serving 12
greedy requests (dense KV, fused and host modes).  Each phase prints one
JSON line; any failure raises and the script exits non-zero.  The line
before the last is ``{"kernels": [...]}``, the last line
``{"ok": true, "device": {...}}``.  It imports nothing of JAX or of the
JAX package, and exits non-zero without a result when no CUDA device is
present.

Numerics: fp32 matmuls run in full fp32 (TF32 off for matmuls and cuDNN).
Tolerances, kernel vs plain version on the same inputs: fp32 atol = rtol =
1e-4 (the kernels sum in another order than the plain version); bf16
atol = rtol = 5e-2 (the JAX package's own bound for its kernels).
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
# H100 SXM published peaks (dense), for the bound of each kernel
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
L2_BYTES = 50 * 2**20


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
    mean of its two turns."""
    order = [("", kernel), ("plain_", plain), ("library_", library)]
    runs: dict = {}
    for prefix, fn in order + order[::-1]:
        dev, call = time_ms(fn, argsets)
        runs.setdefault(prefix, []).append((dev, call))
    return {f"{p}{k}": sum(r[i] for r in rs) / len(rs)
            for p, rs in runs.items() for i, k in ((0, "ms"), (1, "call_ms"))}


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
    ptxas = ([ln.strip() for ln in log.read_text().splitlines()
              if "registers" in ln or "spill" in ln] if log.exists() else [])
    emit({"phase": "build", "seconds": seconds,
          "library": str(cuda_build.library_path().name), "ptxas": ptxas})


def rand(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda",
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
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = {"flash_attention": 0.0, "decode_attention": 0.0}
    H, K, D = 15, 5, 64
    # flash: (B, Sq, Sk, q_offset); causal; plus one D != Dv case
    for dtype in (torch.float32, torch.bfloat16):
        cases = [(2, 512, 512, 0, H, K, D, D), (2, 333, 333, 0, H, K, D, D),
                 (2, 64, 512, 448, H, K, D, D), (1, 100, 100, 0, 4, 2, 48, 32)]
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
    # decode: ragged kv_len including 1 and Sk, poisoned tail
    B, Sk = 8, 1024
    kv_len = torch.tensor([1, Sk, 17, 300, 513, 777, 64, 1000],
                          dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        q = rand((B, H, D), dtype, gen)
        k = rand((B, Sk, K, D), dtype, gen)
        v = rand((B, Sk, K, D), dtype, gen)
        got = da.decode_attention(q, k, v, kv_len)
        want = da.decode_attention_plain(q, k, v, kv_len)
        dead = torch.arange(Sk, device="cuda")[None, :] >= kv_len[:, None]
        k[dead], v[dead] = 1e4, 1e4
        poisoned = da.decode_attention(q, k, v, kv_len)
        torch.cuda.synchronize()
        err = check_close(f"decode {dtype}", got, want, dtype)
        if not torch.equal(poisoned, got):
            raise AssertionError("decode: rows past kv_len changed the output")
        errs["decode_attention"] = max(errs["decode_attention"], err)
        emit({"phase": "kernels", "kernel": "decode_attention",
              "dtype": str(dtype), "B": B, "Sk": Sk, "H": H, "K": K, "D": D,
              "kv_len": kv_len.tolist(), "max_abs_err": err,
              "poisoned_tail_identical": True})

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
    mask = (torch.arange(Sk, device="cuda")[None, :]
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
        emit({"phase": "kernel_times", "kernel": name, **row})
    # decode device time against a uniform kv_len (the dead tail is skipped)
    sweep = {}
    for n in (1, 256, 1024):
        lens = torch.full((B,), n, dtype=torch.int32, device="cuda")
        sets = [a[:3] + (lens,) for a in argsets]
        sweep[n] = time_ms(lambda a, b, c, m: da.decode_attention(a, b, c, m),
                           sets)[0]
    emit({"phase": "kernel_times", "kernel": "decode_attention",
          "kv_len_sweep_ms": sweep})
    return rows


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
                          device="cuda")
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
    err = (logits.float() - plain.float()).abs().max().item()
    # bf16 through 32 layers: the JAX package's bf16 kernel bound
    torch.testing.assert_close(logits.float(), plain.float(), atol=5e-2,
                               rtol=5e-2)
    agree = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    emit({"phase": "prefill", "batch": [B, S], "layers": cfg.num_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "seconds": seconds, "flash_launches": launches,
          "max_abs_err_vs_plain": err,
          "max_abs_logit": plain.float().abs().max().item(),
          "top1_agreement": agree})


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


def phase_serve(cfg, params, DecodeEngine, Request, da) -> dict:
    rng = np.random.default_rng(0)
    plens = rng.integers(16, 301, 12)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in plens]
    out = {}
    for mode in ("fused", "host"):
        eng = DecodeEngine(cfg, params, batch_slots=8, max_seq=1024,
                           mode=mode, steps_per_sync=8, prefill_chunk=64,
                           device="cuda")
        if mode == "fused":
            eng._fused_steps = no_host_sync(eng._fused_steps)
        reqs = [Request(prompt=p, max_new_tokens=32) for p in prompts]
        for r in reqs:
            eng.submit(r)
        before = da.decode_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bad = [i for i, r in enumerate(reqs)
               if r.failed or not r.done or len(r.output) != 32]
        if bad:
            raise AssertionError(f"{mode}: requests {bad} did not complete "
                                 "with 32 tokens")
        launches = da.decode_attention.launches - before
        if launches <= 0:
            raise AssertionError(f"{mode}: no decode kernel launch")
        total = sum(len(r.output) for r in reqs)
        out[mode] = [list(r.output) for r in reqs]
        emit({"phase": "serve", "mode": mode, "requests": len(reqs),
              "host_syncs_in_fused_loop": 0 if mode == "fused" else None,
              "prompt_lens": plens.tolist(), "tokens": total, "steps": steps,
              "wall_s": wall, "tokens_per_s": total / wall,
              "decode_launches": launches, "kv_stats": eng.kv_stats()})
    if out["fused"] != out["host"]:
        diff = [i for i, (a, b) in enumerate(zip(out["fused"], out["host"],
                                                  strict=True)) if a != b]
        raise AssertionError(f"fused and host tokens differ for requests "
                             f"{diff}")
    emit({"phase": "serve", "host_equals_fused": True})
    return out


def phase_profile(cfg, params, DecodeEngine, Request) -> None:
    """Where a steady fused decode sync spends its time: 8 slots at prompt
    length 200, after prefill.  Two syncs (16 steps) are timed without the
    profiler, the next two profiled; the idle share is 1 - device busy time
    (profiled) over the unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(1)
    eng = DecodeEngine(cfg, params, batch_slots=8, max_seq=1024, mode="fused",
                       steps_per_sync=8, prefill_chunk=64, device="cuda")
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
    emit({"phase": "profile", "what": "fused decode, 8 slots, 2 syncs",
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
    from repro_torch.models import lm
    from repro_torch.serve.engine import DecodeEngine, Request

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi, name = phase_device()
    phase_build(cuda_build)
    rows = phase_kernels(fa, da)

    cfg = get_config("smollm-360m")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = lm.init_lm(cfg, gen, "cuda")
    # the main path: every launch count starts at 0 here
    fa.flash_attention.launches = 0
    da.decode_attention.launches = 0
    phase_prefill(cfg, params, lm, ops, ref, fa)
    phase_serve(cfg, params, DecodeEngine, Request, da)
    launches = {"flash_attention": fa.flash_attention.launches,
                "decode_attention": da.decode_attention.launches}
    for kernel, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{kernel} never launched on the main path")
    phase_profile(cfg, params, DecodeEngine, Request)

    src_of = {"flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
              "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu"}
    replaces = {"flash_attention": "src/repro/kernels/flash_attention.py:106",
                "decode_attention": "src/repro/kernels/decode_attention.py:115"}
    kernels = [{"name": k, "route": "cuda", "source": src_of[k],
                "replaces": replaces[k], "launches": launches[k],
                "max_abs_err": rows[k]["max_abs_err"], "ms": rows[k]["ms"],
                "plain_ms": rows[k]["plain_ms"], "bound_ms": rows[k]["bound_ms"],
                "bound_by": rows[k]["bound_by"],
                "library_ms": rows[k]["library_ms"]} for k in rows]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
