#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version, then drives the port's
main paths at full width (bf16, random weights from a seed), each with the
kernel launch counts set to 0 just before it and read just after:

1. dense ``smollm-360m``: ``lm.prefill`` on a [4, 256] batch, and
   ``DecodeEngine`` serving 8 requests: greedy with the fused loop as one
   CUDA graph per sync (captured once per engine, every replay in
   sync-debug "error" mode), the same loop run eagerly, and host mode,
   whose tokens must all agree; then the same three at temperature 1.0,
   whose tokens must agree too;
2. paged ``smollm-360m``: the same with ``kv_layout="paged"`` (page size
   16) and the default pool, and in graph mode with a 64-page pool that
   forces preemption; greedy tokens must equal the dense run's;
3. ``mamba2-130m``: ``lm.prefill`` on a [2, 1024] batch against the
   all-plain path, and ``DecodeEngine`` serving as in 1;
4. training ``smollm-360m`` cut to 16 of its 32 layers: ``run_training``
   (AdamW, remat) for 8 steps at [2, 4096] through the flash forward and
   backward kernels, with the
   step as one CUDA graph (a warm-up step, one capture, one replay per
   later step) and, in turns with it, the same body run eagerly, whose
   final params the graph's must equal bit for bit; then one step on the
   kernel path, the bf16 plain path and the fp32 plain path;
5. training ``mamba2-130m`` cut to 12 of its 24 layers: the same at
   [2, 4096] through the SSD scan's forward and backward kernels;
5a. the reference's three examples through the port's entry points
   (``phase_examples``): serve_lm at its defaults (reduced mamba2-130m),
   and in fp32 with prefill chunks through the SSD kernel against the
   plain version (equal greedy tokens); train_lm with one injected
   failure and its rerun; quickstart's sweep, train and dry-run sections;
   train_lm at full width (mamba2-130m, [4, 256]) uninterrupted here, then
   through ExpoCloud (``--expocloud --fail-once``) in a process of its
   own, whose re-assigned task must resume from its checkpoint and end
   with the uninterrupted run's last loss;
5b.-5d. training ``qwen3-4b``, ``chatglm3-6b`` and ``granite-20b`` as 4,
   through the flash kernels at (128, 128) with G 4, 16 and 48, cut to 2,
   2 and 2 layers (``TRAIN_DENSE``) for the run's time, the three-path
   step at [1, 1024];
6.-8. ``qwen3-4b`` (qk-norm, vocab 151936), ``chatglm3-6b`` (half-width
   interleaved RoPE, G 16) and ``granite-20b`` (GELU MLP, MQA: G 48), one
   at a time: ``lm.prefill`` on [4, 256] against the all-plain path (every
   flash call of it also held against the plain version on its own inputs,
   and the fp32 logits through the kernel against the fp32 plain ones) and
   serving as in 1, each cut in depth (2 of 36, 2 of 28 and 2 of 52
   layers, ``SERVE_LAYERS``) to keep the run inside its time limit;
   granite-20b also through the paged layout (the default pool and a
   64-page pool that must preempt, graph mode), whose greedy tokens must
   equal its dense run's;
9. ``olmoe-1b-7b`` (MoE: 64 experts, top-8, cut to 2 of its 16 layers):
   as 6-8 with 8
   requests, also paged with the default pool in the three modes, whose
   greedy tokens must equal the dense run's, and a 64-page pool that must
   preempt and drain, whose tokens are reported against the dense run's,
   not held to them; an MoE's host mode is held to the graph at one step
   a sync.  The expert capacity couples the rows of a prefill chunk, idle
   slots' rows included, whose cache reads differ with the layout, with
   the decode steps run between chunks and with which slots preemption
   puts in a chunk; the reference engine's tokens differ in the same ways
   (``tests/test_torch_moe.py::test_capacity_drops_part_modes_and_layouts_in_both_engines``;
   ``serve_modes``, ``phase_arch``);
10. ``deepseek-v3-671b`` (MLA + MoE: 256 experts, top-8, one shared, sigmoid
   scoring) at full width cut to 4 layers (its 3 dense layers and its
   first MoE layer, with the MTP module's parameters): the prefill through
   the flash kernel at (D, Dv) = (192, 128), and serving dense and paged
   (default pool) in the three modes.  Its decode and chunked prefill are
   the weight-absorbed MLA, torch ops, and launch no kernel;
11. ``jamba-v0.1-52b`` (the Jamba hybrid: super-blocks of 8 layers, 7
   Mamba-2 layers of 128 heads of (P, N) = (64, 16) and one attention
   layer of 32/8 heads with no position encoding; MoE on odd layers, 16
   experts, top-2) at full width cut to one super-block of 4 layers (the
   published block's positions 4-7: attention, then Mamba layers, two
   with the MoE; a full super-block is 8 layers, 13.27 B parameters): as
   9, every
   SSD scan call of the prefill also held against its plain version on
   its own inputs, the all-plain path through the plain SSD scan too;
12. training ``olmoe-1b-7b`` at full width cut to 2 layers: as 4 (AdamW,
   remat, [2, 4096]) in one graph and one eager turn, through the MoE
   dispatch's backward; the three-path step with the bf16 paths replaying
   the fp32 path's expert ids;
13. training ``deepseek-v3-671b`` at full width cut to one dense layer
   and the MTP block (the MoE stack empty): as 12 with
   Adafactor, through
   the flash backward at (D, Dv) = (192, 128), 2L + 1 forward and L + 1
   backward launches a step (the MTP block runs outside remat); the
   three-path step at [1, 1024], where the fp32 plain attention fits;
14. ``musicgen-medium`` (4 codebooks, 3 of 48 layers, 24 heads of 64, GELU;
   run after 11): as 9 with tokens of 4 codebooks: a [4, 256, 4] prefill
   whose logits are [4, 4, 2048], prompts of (plen, 4) tokens, one
   token per codebook a step; paged in the three modes and a 64-page pool
   that must preempt, all held to the dense tokens;
15. ``phi-3-vision-4.2b`` (4 of 32 layers, 32 heads of 96): the prefill on a
   [2, 1024] batch whose first 576 positions are image embeds, through the
   flash kernel at (D, Dv) = (96, 96), held to the fp32 reference on the
   same merged input; text serving as in 6-8 and paged in graph mode.

First, after the build, the ``dryrun`` phase (``phase_dryrun``) runs the
port's dry-run sweep on the card: ``repro_torch.launch.sweep_dryrun``'s
``build_tasks`` and ``Experiment(engine="local")`` (one client, one worker,
each cell a ``python -m repro_torch.launch.dryrun`` process of its own,
300 s a cell) over six one-card cells (``DRYRUN_GRID``): smollm-360m
prefill_32k at 2 layers, decode_32k at 2 and 3 layers and mamba2-130m
prefill_32k at 2 layers, each lowered on the ``meta`` device and captured
on the card as one CUDA graph through the flash, decode and SSD kernels,
and smollm-360m train_4k at 2 layers and decode_32k at full depth, whose
estimated peaks exceed the card (``exceeds_device``, lower only); and two
mesh cells (``DRYRUN_MESH_GRID``), rank 0 of a fake world of 8 on the
(2, 4) (data, model) mesh at 2 layers: musicgen-medium decode_32k (6 of
24 heads, a quarter of each codebook table) through the decode kernel and
qwen3-4b prefill_32k (8 / 2 heads) through the flash kernel, each kernel
once a layer a replay, collectives counted, not run (above 0; qwen3-4b's
at its closed form), the allocator's peak within ``DRYRUN_PEAK_MARGIN`` of
the estimate; then ``aggregate.assemble``'s decode_32k row extrapolated to
full depth from the two probes, whose MODEL / counted FLOPs must lie in
[0.9, 1.1].

After each serving path, ``profile_run`` times a steady decode sync (8
slots at prompt 200) with the graph, then with the eager loop (the graph
alone on paths 1-3, whose eager turns made room for the dry-run): wall and
device busy ms per step, idle share, tokens/s, the CUDA runtime calls per
sync, the capture's ms and the graph pool's MiB; the decode kernel
launches the engine counts per replay must equal those the profiler saw
the replays run (a graph turn that lost an event is followed by another,
at most two; no turn may see more).  After the
smollm paths, and again after the dense configs', the split-K decode
kernels' counters must all read 0.  The ``kernels`` phases also hold the
flash kernel at the heads of paths 6-8 (G 4, 16 and 48, D 128, [4, 256])
and of paths 14-15 (24 heads of 64; 32 of 96 at [2, 1024], timed), and
the decode kernels at their heads (D 128 at G 1, 4, 16 and 48; G 1 at
D 64 and D 96; B 8, Sk 1024, dense and paged) against their plain
versions, and time the decode kernels (``phase_kernels_wide``); the SSD scan is held and timed at path 11's
head too (``phase_kernels_ssd``).

After the train paths, the ``dist`` phase (``phase_dist``) trains
smollm-360m at full width cut to 2 layers (AdamW, remat, [2, 4096], 3
steps) data-parallel on ``torch.distributed``: at world 1 over NCCL in
this process (``--mesh 1``, ZeRO-1 on), the step and its collectives
captured as one CUDA graph, in a graph and an eager turn whose final
params must equal ``run_training(rules=None)``'s bit for bit; then at
world 2, two rank processes sharing the card through gloo (eagerly):
losses within 5e-2 of world 1's and params within 3e-2 (the reference's
sharded-parity bounds), each rank's optimizer-state bytes equal to what
the ZeRO-1 specs lay out, ``allreduce_int8`` bit-equal to the same
arithmetic on one rank, three steps through the error-feedback
compression within 5e-2 with every residual at most one quantisation
step, and one fp32 step whose loss and grad norm lie within 1e-5
(relative) of world 1's.  The rank processes load the library the build
made.

Then the ``tp`` phase (``phase_tp``) trains on the ``model`` axis
(tensor-parallel attention, MLA, the Mamba-2 mixer's SSD heads, FFN and
vocabulary, and the MoE's experts split), each config at full width cut
in depth (ZeRO-1, remat, [2, 4096], 2 steps): a (1, 1) (data, model)
mesh over NCCL in this process, captured and bit-equal to the unsharded
run; qwen3-4b on (2, 2) (16 query and 4 KV heads a rank), granite-20b on
(1, 2) (24 query heads a rank on the one replicated KV head),
olmoe-1b-7b on (1, 2) (32 of 64 experts a rank), all 1 layer under
AdamW; mamba2-130m (2 layers, AdamW, 12 SSD heads a rank) on (2, 2),
jamba-v0.1-52b (its super-block cut to 2 layers: 64 SSD heads, 16 / 4
attention heads and 8 experts a rank) and deepseek-v3-671b (one dense
layer and the MTP block: 64 MLA heads and half the vocabulary a rank)
on (1, 2) under Adafactor, musicgen-medium (2 layers, AdamW: 12 heads
and half of each codebook table a rank) and phi-3-vision-4.2b (2
layers, Adafactor, 576 image rows: 16 heads of 96 a rank) on (1, 2), as
six rank processes sharing the card through gloo: losses within 5e-2 of
the unsharded run's and params within 3e-2, an fp32 step within 1e-5
(relative) of the unsharded one (an MoE config's held by
``REPRO_MOE=ep`` == ``gather`` instead), each rank's param and optimizer
bytes equal to the specs' count, and each rank's flash and SSD launches
at its local heads; qwen3-4b (on (2, 2)) and musicgen-medium (on (1, 2))
are then served in fp32 on the params the ranks trained: a [2, 1024]
prefill, its cache warmed by a prefill chunk, 8 greedy decode steps at
the rank's heads and part of the cache, the logits within 1e-5 of the
unsharded run's on the same params and the tokens equal.

Last, the ``tune`` phase (``phase_tune``) runs the port's autotuner
(``repro_torch.tune``) against a fresh cache the script makes at its start
(``REPRO_TORCH_TUNE_CACHE``, so every path above runs the kernels'
defaults): a call naming no knob equals the explicit default bit for bit;
a simulator-engine sweep of each of the four forward kernels at its
main-path shape in bf16, every config of every grid held against the
plain version and timed; one local-engine sweep of the decode kernel
through ``python -m repro_torch.tune`` in a subprocess (forked workers,
each with its own CUDA context); then a call naming no knob resolves to
the cached best, and a paged smollm-360m engine built with
``page_size=None`` serves at the tuned page size with greedy tokens equal
to path 1's.  The train paths run one graph and one eager turn each
(``TRAIN_TURNS``), which makes room for it.

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
kernel: the chunked sums of decayed terms are reassociated); flash backward
fp32 1e-4, bf16 gradients no further from the fp32 plain gradients than
twice the bf16 plain version is (both round P and dS to bf16, at different
places), or within 5e-2 of it where that is looser; SSD backward fp32
within 2e-3 of the plain version evaluated in fp64, bf16 by the flash
backward's rule with the SSD bound 1e-1.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))
# the kernels' work and the card's peaks (one NVIDIA H100 SXM), shared
# with the tuner's predicted cost and the dry-run's count
from repro_torch.kernels.work import (bound, decode_work,  # noqa: E402
                                      flash_bwd_work, flash_work,
                                      live_pairs, nbytes, paged_work,
                                      ssd_bwd_work, ssd_work)

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=5e-2, rtol=5e-2)}
SSD_TOL = {torch.float32: dict(atol=2e-3, rtol=2e-3),
           torch.bfloat16: dict(atol=1e-1, rtol=1e-1)}
L2_BYTES = 50 * 2**20
DEVICE = "cuda"     # every tensor and engine of the run lives here


T0 = time.perf_counter()


def emit(obj) -> None:
    """Print ``obj`` as one JSON line; a phase line also gets ``t``, the
    seconds since the script started."""
    if "phase" in obj:
        obj = {**obj, "t": round(time.perf_counter() - T0, 1)}
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
    the host is slower than the device.  A call slower than
    ``TIMED_LOOP_MS / iters`` (the plain versions at training shapes) runs
    fewer calls a loop, at least 3, about ``TIMED_LOOP_MS`` of them."""
    from torch.profiler import ProfilerActivity, profile

    for a in argsets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn(*argsets[0])
    end.record()
    end.synchronize()
    iters = max(3, min(iters, math.ceil(
        TIMED_LOOP_MS / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for i in range(iters):
        fn(*argsets[i % len(argsets)])
    end.record()
    end.synchronize()
    call_ms = start.elapsed_time(end) / iters
    # the profiler now and then hands back a trace with no device activity
    # (lost CUPTI records): profile again, and if it stays empty take the
    # queue-primed CUDA-event time
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(*argsets[i % len(argsets)])
            torch.cuda.synchronize()
        device_us = sum(_dev_us(e) for e in _device_events(prof))
        if device_us > 0:
            return device_us / 1e3 / iters, call_ms
    primed = primed_event_ms(fn, argsets, iters)
    emit({"warning": "the profiler saw no device time in three traces; "
                     "device ms is the queue-primed CUDA-event time",
          "primed_ms": primed, "call_ms": call_ms})
    return primed, call_ms


# the device ms that one timed loop of a slow call is cut to
TIMED_LOOP_MS = 300.0


def primed_event_ms(fn, argsets, iters: int = 30) -> float:
    """Device ms per call of ``fn`` from CUDA events, with the stream held
    busy by a sleep kernel while the host queues the events and the calls,
    so that the host's launch gaps fall inside the sleep and not between
    the events (a call that waits on the host, as ``.item()`` does, still
    adds its gap)."""
    for a in argsets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # ~10 ms at the H100's 1.98 GHz
    start.record()
    for i in range(iters):
        fn(*argsets[i % len(argsets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_breakdown(fn, argsets, iters: int = 30) -> dict:
    """Device ms per call of the kernels that one call of ``fn`` runs, by
    the first 60 characters of the profiler's kernel name (kernels whose
    names share them are summed), cycling through ``argsets``."""
    from torch.profiler import ProfilerActivity, profile

    fn(*argsets[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*argsets[i % len(argsets)])
        torch.cuda.synchronize()
    out: dict = {}
    for e in _device_events(prof):
        out[e.key[:60]] = out.get(e.key[:60], 0.0) + _dev_us(e) / 1e3 / iters
    return out


def kernel_name(key: str) -> str:
    """The bare name of a profiler kernel key: "void (anonymous
    namespace)::ssd_scan_tc<64, 128>(..." -> "ssd_scan_tc" (the argument
    list, which may name the anonymous namespace again, is dropped
    first)."""
    key = key.replace("(anonymous namespace)::", "")
    return key.split("(")[0].split("<")[0].split("::")[-1].split()[-1]


def is_gemm(name: str) -> bool:
    """A cuBLAS matrix-product kernel, by the profiler's kernel name."""
    return any(w in name.lower() for w in ("gemm", "nvjet", "xmma"))


def timed(kernel, plain, library, argsets, iters: int = 30) -> dict:
    """Kernel, plain-version and library-call times on the same inputs, in
    turns (kernel, plain, library, library, plain, kernel); each is the
    mean of its two turns, of ``iters`` calls each.  ``library`` None (no
    single PyTorch call computes the function) gives ``library_ms``
    None."""
    order = [("", kernel), ("plain_", plain)]
    if library is not None:
        order.append(("library_", library))
    runs: dict = {}
    for prefix, fn in order + order[::-1]:
        dev, call = time_ms(fn, argsets, iters)
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


def ptxas_usage(cuda_build, pattern: str) -> dict:
    """Registers and spill bytes of each kernel whose (mangled) name
    matches ``pattern``, from the build log's ptxas lines: {"kernel<P, N>"
    (or the bare name): {"registers", "spill_stores", "spill_loads"}}.  The
    registers are the kernel's, as ptxas reports them (for a
    warp-specialized kernel, its launch bound's share; setmaxnreg moves
    them between warpgroups)."""
    log = cuda_build.build_log_path()
    out, name = {}, None
    for ln in log.read_text().splitlines() if log.exists() else []:
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            found = re.search(r"\d+(" + pattern
                              + r")(I(?:Li\d+E|Lb\dE|13__nv_bfloat16|f)+E)?E",
                              m.group(1))
            name = None
            if found:
                args = re.findall(r"Li(\d+)E|Lb(\d)E|(13__nv_bfloat16)|(f)",
                                  found.group(2) or "")
                args = [a or ({"0": "false", "1": "true"}[b] if b else
                              "bf16" if c else "float") for a, b, c, _ in args]
                name = found.group(1) + (f"<{', '.join(args)}>" if args else "")
                out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def rand(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device=DEVICE,
                       dtype=torch.float32).to(dtype)


def check_close(name, got, want, dtype, tol=TOL) -> float:
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output has non-finite values")
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **tol[dtype],
                               msg=lambda m: f"{name}: {m}")
    return err


def phase_kernels(fa, da, cuda_build) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    F = torch.nn.functional
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    errs = {"flash_attention": 0.0, "flash_attention_mla": 0.0,
            "flash_attention_96": 0.0, "decode_attention": 0.0}
    H, K, D = 15, 5, 64
    # flash: (B, Sq, Sk, q_offset, H, K, D, Dv); causal; smollm's heads,
    # G 1 and 8, D != Dv, a short chunk at the end with D 128, the heads
    # of qwen3-4b, chatglm3-6b and granite-20b (G 4, 16, 48) at D 128 at
    # their main path's prefill shape [4, 256] and in a short chunk, and
    # deepseek-v3's MLA widths (D 192 = nope 128 + rope 64, Dv 128, G 1)
    # at its prefill shape and in a short chunk; musicgen-medium's heads
    # (24 of 64, G 1) at its [4, 256] prefill, and phi-3-vision's (32 of
    # 96, G 1) at its [2, 1024] prefill and in a short chunk
    for dtype in (torch.float32, torch.bfloat16):
        cases = [(2, 512, 512, 0, H, K, D, D), (2, 333, 333, 0, H, K, D, D),
                 (2, 64, 512, 448, H, K, D, D), (1, 100, 100, 0, 4, 2, 48, 32),
                 (2, 256, 256, 0, K, K, D, D), (2, 200, 200, 0, 8 * K, K, D, D),
                 (1, 7, 300, 293, 24, 3, 128, 128),
                 (4, 256, 256, 0, 32, 8, 128, 128),
                 (4, 256, 256, 0, 32, 2, 128, 128),
                 (1, 9, 200, 191, 32, 2, 128, 128),
                 (4, 256, 256, 0, 48, 1, 128, 128),
                 (1, 5, 130, 125, 48, 1, 128, 128),
                 (4, 256, 256, 0, 128, 128, 192, 128),
                 (1, 9, 200, 191, 16, 16, 192, 128),
                 (4, 256, 256, 0, 24, 24, 64, 64),
                 (2, 1024, 1024, 0, 32, 32, 96, 96),
                 (1, 9, 200, 191, 32, 32, 96, 96)]
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
            for dims, name in (((192, 128), "flash_attention_mla"),
                               ((96, 96), "flash_attention_96")):
                if (d, dv) == dims:
                    errs[name] = max(errs[name], err)
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
    # deepseek-v3's MLA prefill: [4, 256], 128 heads, (D, Dv) = (192, 128)
    B, S, Hm, Dm, Dvm = 4, 256, 128, 192, 128
    q, k, v = (rand((B, S, Hm, Dm), dt, gen), rand((B, S, Hm, Dm), dt, gen),
               rand((B, S, Hm, Dvm), dt, gen))
    argsets = copies((q, k, v), nbytes(q, k, v))
    b_ms, b_by = bound(dt, *flash_work(q, k, v, 0))
    rows["flash_attention_mla"] = {
        "shape": {"B": B, "Sq": S, "Sk": S, "H": Hm, "K": Hm, "D": Dm,
                  "Dv": Dvm, "dtype": "bfloat16", "causal": True},
        **timed(lambda a, b, c: fa.flash_attention(a, b, c),
                lambda a, b, c: fa.flash_attention_plain(a, b, c),
                lambda a, b, c: F.scaled_dot_product_attention(
                    a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
                    is_causal=True), argsets),
        "bound_ms": b_ms, "bound_by": b_by}
    # phi-3-vision's prefill: [2, 1024], 32 heads, (D, Dv) = (96, 96)
    B, S, Hp, Dp = 2, 1024, 32, 96
    q, k, v = (rand((B, S, Hp, Dp), dt, gen), rand((B, S, Hp, Dp), dt, gen),
               rand((B, S, Hp, Dp), dt, gen))
    argsets = copies((q, k, v), nbytes(q, k, v))
    b_ms, b_by = bound(dt, *flash_work(q, k, v, 0))
    rows["flash_attention_96"] = {
        "shape": {"B": B, "Sq": S, "Sk": S, "H": Hp, "K": Hp, "D": Dp,
                  "Dv": Dp, "dtype": "bfloat16", "causal": True},
        **timed(lambda a, b, c: fa.flash_attention(a, b, c),
                lambda a, b, c: fa.flash_attention_plain(a, b, c),
                lambda a, b, c: F.scaled_dot_product_attention(
                    a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
                    is_causal=True), argsets),
        "bound_ms": b_ms, "bound_by": b_by}
    emit({"phase": "kernel_registers", "kernel": "flash_attention",
          "ptxas": {k: v for k, v in ptxas_usage(
              cuda_build, "flash_tc_kernel|flash_simt_kernel").items()
              if "<96, 96" in k}})
    del argsets
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
    # the profiler-less fallback of time_ms, held beside the profiler's time
    emit({"phase": "kernel_times", "kernel": "decode_attention",
          "what": "queue-primed CUDA-event ms against the profiler's ms",
          "primed_ms": primed_event_ms(
              lambda a, b, c, n: da.decode_attention(a, b, c, n), argsets),
          "profiler_ms": rows["decode_attention"]["ms"]})
    for name, row in rows.items():
        row["max_abs_err"] = errs[name]
        row["library_ratio"] = row["ms"] / row["library_ms"]
        emit({"phase": "kernel_times",
              "kernel": name.replace("_mla", "").replace("_96", ""), **row})
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


def flash_bwd_launch_work(q, k, v, q_offset: int) -> dict:
    """Flops of the backward's two product launches per live (query head,
    key) pair: dK/dV runs S^T, dP^T, dV and dK, 2 * (2 D + 2 Dv); dQ runs
    S, dP and dQ, 2 * (2 D + Dv).  Keyed by a piece of each kernel's name."""
    B, Sq, H, D = q.shape
    Sk, Dv = k.shape[1], v.shape[3]
    live = live_pairs(Sq, Sk, q_offset)
    return {"bwd_dkdv": 2 * B * H * (2 * D + 2 * Dv) * live,
            "bwd_dq": 2 * B * H * (2 * D + Dv) * live}


def phase_kernels_bwd(fa, cuda_build) -> dict:
    """The flash backward kernel against its plain version, and the
    forward's lse against ``attention_lse_ref``: the training shape [2,
    4096] (H 15 / K 5, D 64, causal), a ragged Sq = Sk = 1000, a chunk at
    the end (q_offset > 0), full attention, (D, Dv) = (48, 32) and (128,
    128), a long causal walk with Sq != Sk and q_offset > 0 (Sq 2048,
    Sk 2560), the MLA widths (192, 128) at G 1: Sq 40 / Sk 60 with
    q_offset 20, and a causal walk of 4,095 tokens (the MTP block's length
    at [2, 4096]), and phi-3-vision's (96, 96): its training shape [2,
    4096] at H = K = 32 and a ragged full Sq 150 / Sk 333 at G 3 with
    q_offset 100, and jamba-v0.1-52b's attention layer, (128, 128) at H 32
    / K 8 (G 4) at [2, 4096], and chatglm3-6b's H 32 / K 2 (G 16) and
    granite-20b's H 48 / K 1 (G 48) at (128, 128), each at [1, 4096] and
    in a 64-row chunk at the end of 600 keys (q_offset 536).  fp32 within
    atol = rtol = 1e-4 of the plain version; bf16 dq, dk, dv each no
    further from the fp32 plain gradients than twice the bf16 plain
    version is, or within 5e-2 of the bf16 plain version where that is
    looser.  Two calls must give the same bits.
    Then the times, bf16 at [2, 4096], with each launch's device ms and
    achieved TFLOP/s, at smollm-360m's heads, at deepseek-v3's (H = K =
    128, (192, 128)), at phi-3-vision's (H = K = 32, (96, 96)) and at
    jamba's (H 32 / K 8, (128, 128)), chatglm3-6b's (H 32 / K 2) and
    granite-20b's (H 48 / K 1), with the forward and its lse there too
    (rows 1e-1g, 5c-5e), and the backward kernels' registers and spills
    (``kernel_registers``)."""
    F = torch.nn.functional
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(3)
    # the largest error of each timed row: the wide heads apart, and
    # (128, 128) also in a row of its own (jamba's, row 5c)
    wide = ((192, 128), (96, 96))
    errs = dict.fromkeys(("base", *wide, (128, 128), ("G", 16), ("G", 48)),
                         0.0)

    def err_keys(D, Dv, G):
        if (D, Dv) in wide:
            return [(D, Dv)]
        if ("G", G) in errs:            # chatglm3-6b's and granite-20b's
            return [("G", G)]
        return ["base"] + [(D, Dv)] * ((D, Dv) == (128, 128))
    # (B, Sq, Sk, q_offset, H, K, D, Dv, causal)
    cases = [(2, 4096, 4096, 0, 15, 5, 64, 64, True),
             (1, 1000, 1000, 0, 15, 5, 64, 64, True),
             (2, 64, 512, 448, 15, 5, 64, 64, True),
             (2, 300, 500, 0, 15, 5, 64, 64, False),
             (1, 100, 100, 0, 4, 2, 48, 32, True),
             (1, 520, 520, 0, 8, 2, 128, 128, True),
             (1, 2048, 2560, 512, 15, 5, 64, 64, True),
             (1, 40, 60, 20, 4, 4, 192, 128, True),
             (1, 4095, 4095, 0, 4, 4, 192, 128, True),
             (2, 4096, 4096, 0, 32, 32, 96, 96, True),
             (2, 150, 333, 100, 6, 2, 96, 96, False),
             (2, 4096, 4096, 0, 32, 8, 128, 128, True),
             (1, 4096, 4096, 0, 32, 2, 128, 128, True),
             (1, 64, 600, 536, 32, 2, 128, 128, True),
             (1, 4096, 4096, 0, 48, 1, 128, 128, True),
             (1, 64, 600, 536, 48, 1, 128, 128, True)]
    for dtype in (torch.float32, torch.bfloat16):
        for B, Sq, Sk, off, H, K, D, Dv, causal in cases:
            q, k, v = (rand((B, Sq, H, D), dtype, gen),
                       rand((B, Sk, K, D), dtype, gen),
                       rand((B, Sk, K, Dv), dtype, gen))
            dout = rand((B, Sq, H, Dv), dtype, gen)
            kw = dict(causal=causal, q_offset=off)
            # the plain lse is a view laid out by the group size; the
            # kernel takes the contiguous [B, Sq, H] its forward writes
            out, lse = (t.contiguous() for t in
                        fa.flash_attention_lse_plain(q, k, v, **kw))
            _, lse_k = fa._forward(q, k, v, causal, None, off, True)
            got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
            again = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
            want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
            torch.cuda.synchronize()
            what = f"flash bwd {dtype} {(B, Sq, Sk, off, H, K, D, Dv, causal)}"
            torch.testing.assert_close(lse_k, lse, atol=1e-4, rtol=1e-4,
                                       msg=lambda m, w=what: f"{w} lse: {m}")
            line = {"phase": "kernels", "kernel": "flash_attention_bwd",
                    "dtype": str(dtype), "B": B, "Sq": Sq, "Sk": Sk,
                    "q_offset": off, "H": H, "K": K, "D": D, "Dv": Dv,
                    "causal": causal,
                    "lse_max_abs_err": (lse_k - lse).abs().max().item(),
                    "repeat_identical": all(torch.equal(a, b) for a, b in
                                            zip(got, again, strict=True))}
            if dtype == torch.float32:
                for name, g, w in zip("qkv", got, want, strict=True):
                    e = check_close(f"{what} d{name}", g, w, dtype)
                    line[f"d{name}_max_abs_err"] = e
                    for key in err_keys(D, Dv, H // K):
                        errs[key] = max(errs[key], e)
            else:
                f32 = [t.float() for t in (q, k, v, out, dout)]
                want32 = fa.flash_attention_bwd_plain(*f32[:4], lse, f32[4],
                                                      **kw)
                del f32
                for name, g, w, w32 in zip("qkv", got, want, want32,
                                           strict=True):
                    if not torch.isfinite(g.float()).all():
                        raise AssertionError(f"{what} d{name}: non-finite")
                    kern = (g.float() - w32).abs().max().item()
                    plain = (w.float() - w32).abs().max().item()
                    e = (g.float() - w.float()).abs().max().item()
                    line[f"d{name}_vs_fp32"] = [kern, plain]
                    line[f"d{name}_max_abs_err"] = e
                    for key in err_keys(D, Dv, H // K):
                        errs[key] = max(errs[key], e)
                    if kern > 2 * plain:
                        torch.testing.assert_close(
                            g.float(), w.float(), **TOL[dtype],
                            msg=lambda m, w_=f"{what} d{name}": f"{w_}: {m}")
                del want32
            emit(line)
            if not line["repeat_identical"]:
                raise AssertionError(f"{what}: two calls differ")
            del q, k, v, dout, out, lse, got, again, want
    torch.cuda.empty_cache()

    # times, bf16, at the training shape
    dt = torch.bfloat16
    B, S, H, K, D = 2, 4096, 15, 5, 64
    q, k, v = (rand((B, S, H, D), dt, gen), rand((B, S, K, D), dt, gen),
               rand((B, S, K, D), dt, gen))
    dout = rand((B, S, H, D), dt, gen)
    out, lse = fa._forward(q, k, v, True, None, 0, True)
    argsets = copies((q, k, v, out, lse, dout), nbytes(q, k, v, out, lse, dout))
    # the library's backward: SDPA's graph built once per copy, only its
    # backward timed (a yardstick the port never calls)
    graphs = {}
    for a in argsets:
        leaves = [t.transpose(1, 2).detach().requires_grad_() for t in a[:3]]
        graphs[a[0].data_ptr()] = (leaves, F.scaled_dot_product_attention(
            *leaves, is_causal=True, enable_gqa=True))

    def library(q_, k_, v_, o_, l_, g_):
        leaves, o = graphs[q_.data_ptr()]
        return torch.autograd.grad(o, leaves, g_.transpose(1, 2),
                                   retain_graph=True)

    b_ms, b_by = bound(dt, *flash_bwd_work(q, k, v, 0))
    phases = device_breakdown(fa.flash_attention_bwd, argsets)
    launch_flops = flash_bwd_launch_work(q, k, v, 0)
    row = {"shape": {"B": B, "Sq": S, "Sk": S, "H": H, "K": K, "D": D,
                     "dtype": "bfloat16", "causal": True},
           **timed(fa.flash_attention_bwd, fa.flash_attention_bwd_plain,
                   library, argsets),
           "phases_ms": phases,
           "phases_tflops": {name: f / ms / 1e9 for name, ms in phases.items()
                             for key, f in launch_flops.items() if key in name},
           "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": errs["base"]}
    row["library_ratio"] = row["ms"] / row["library_ms"]
    row["bound_ratio"] = row["ms"] / b_ms
    emit({"phase": "kernel_times", "kernel": "flash_attention_bwd", **row})
    del graphs
    # the forward with its lse at the same shape (the training forward)
    flash_fwd_lse_times(fa, [a[:3] for a in argsets])
    del argsets
    torch.cuda.empty_cache()
    # rows 5a (deepseek-v3-671b), 5b (phi-3-vision-4.2b), 5c
    # (jamba-v0.1-52b, G 4, with its forward: row 1e), 5d and 5e
    # (chatglm3-6b's G 16 and granite-20b's G 48, with their forwards:
    # rows 1f and 1g)
    for H, K, (D, Dv), iters, key in (
            (128, 128, (192, 128), 5, (192, 128)),
            (32, 32, (96, 96), 10, (96, 96)),
            (32, 8, (128, 128), 10, (128, 128)),
            (32, 2, (128, 128), 5, ("G", 16)),
            (48, 1, (128, 128), 5, ("G", 48))):
        wide_row = flash_bwd_wide_times(fa, gen, H, D, Dv, iters, K=K)
        wide_row["max_abs_err"] = errs[key]
        emit({"phase": "kernel_times", "kernel": "flash_attention_bwd",
              **wide_row})
    emit({"phase": "kernel_registers", "kernel": "flash_attention_bwd",
          "ptxas": ptxas_usage(cuda_build, "bwd_dkdv_wgmma|bwd_dq_wgmma|"
                               "bwd_dkdv_simt|bwd_dq_simt")})
    return {"flash_attention_bwd": row}


def flash_fwd_lse_times(fa, argsets) -> dict:
    """The training forward (the kernel writing its lse) on ``argsets`` of
    bf16 (q, k, v), causal, beside the plain version with lse and SDPA's
    forward (GQA); prints its ``kernel_times`` line and returns it."""
    F = torch.nn.functional
    q, k, v = argsets[0]
    B, S, H, D = q.shape
    K = k.shape[2]
    n_bytes, n_flops = flash_work(q, k, v, 0)
    b_ms, b_by = bound(q.dtype, n_bytes + B * S * H * 4, n_flops)
    fwd = {"shape": {"B": B, "Sq": S, "Sk": S, "H": H, "K": K, "D": D,
                     "Dv": v.shape[3], "dtype": "bfloat16", "causal": True,
                     "lse": True},
           **timed(lambda a, b_, c: fa._forward(a, b_, c, True, None, 0, True),
                   lambda a, b_, c: fa.flash_attention_lse_plain(a, b_, c),
                   lambda a, b_, c: F.scaled_dot_product_attention(
                       a.transpose(1, 2), b_.transpose(1, 2),
                       c.transpose(1, 2), is_causal=True, enable_gqa=True),
                   argsets),
           "bound_ms": b_ms, "bound_by": b_by}
    fwd["library_ratio"] = fwd["ms"] / fwd["library_ms"]
    fwd["bound_ratio"] = fwd["ms"] / b_ms
    emit({"phase": "kernel_times", "kernel": "flash_attention", **fwd})
    return fwd


def flash_bwd_wide_times(fa, gen, H: int, D: int, Dv: int,
                         iters: int, K: int | None = None) -> dict:
    """The backward at a wide head's training shape: [2, 4096], H query
    heads over ``K`` (default H) KV heads, causal, bf16, the scale
    D**-0.5: deepseek-v3's H 128 at (D, Dv) = (192, 128), whose (nope +
    rope)**-0.5 is 192**-0.5, phi-3-vision's H 32 at (96, 96), and
    jamba-v0.1-52b's H 32 over K 8 at (128, 128), whose forward with lse
    is timed too (``flash_fwd_lse_times``), as are chatglm3-6b's H 32
    over K 2 (G 16) and granite-20b's H 48 over K 1 (G 48) at (128, 128).
    The plain version runs 16 query heads (and their KV heads) at a time,
    or one group where a group is wider (at once deepseek's fp32
    scores and their gradients would take ~70 GB; the slices are
    independent and the same work); the library column is SDPA's backward
    on its fused backends (cuDNN, memory-efficient, flash), null if none
    takes these widths.  ``iters`` calls a turn."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    F = torch.nn.functional
    K = H if K is None else K
    G = H // K
    dt, B, S = torch.bfloat16, 2, 4096
    q, k = rand((B, S, H, D), dt, gen), rand((B, S, K, D), dt, gen)
    v, dout = rand((B, S, K, Dv), dt, gen), rand((B, S, H, Dv), dt, gen)
    out, lse = fa._forward(q, k, v, True, None, 0, True)
    argsets = copies((q, k, v, out, lse, dout),
                     nbytes(q, k, v, out, lse, dout))
    del q, k, v, dout, out, lse
    if G > 1:
        flash_fwd_lse_times(fa, [a[:3] for a in argsets])

    # 16 query heads a slice, or one group where a group is wider
    n = G * max(1, 16 // G)

    def plain(q_, k_, v_, o_, l_, g_):
        parts = [fa.flash_attention_bwd_plain(
            q_[:, :, h:h + n], k_[:, :, h // G:(h + n) // G],
            v_[:, :, h // G:(h + n) // G],
            *(t[:, :, h:h + n] for t in (o_, l_, g_)))
            for h in range(0, H, n)]
        return tuple(torch.cat(p, dim=2) for p in zip(*parts))

    fused = [SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.FLASH_ATTENTION]
    graphs = {}

    def library(q_, k_, v_, o_, l_, g_):
        leaves, o = graphs[q_.data_ptr()]
        return torch.autograd.grad(o, leaves, g_.transpose(1, 2),
                                   retain_graph=True)

    # the yardstick only: if no fused backend takes (D, Dv), the library
    # column is null and says why
    refused = None
    try:
        with sdpa_kernel(fused):
            for a in argsets:
                leaves = [t.transpose(1, 2).detach().requires_grad_()
                          for t in a[:3]]
                graphs[a[0].data_ptr()] = (
                    leaves, F.scaled_dot_product_attention(
                        *leaves, is_causal=True, enable_gqa=G > 1))
            library(*argsets[0])
        torch.cuda.synchronize()
    except RuntimeError as e:
        graphs, library = {}, None
        refused = str(e).splitlines()[0][:200]
    a0 = argsets[0]
    b_ms, b_by = bound(dt, *flash_bwd_work(*a0[:3], 0))
    launch_flops = flash_bwd_launch_work(*a0[:3], 0)
    phases = device_breakdown(fa.flash_attention_bwd, argsets, iters=iters)
    row = {"shape": {"B": B, "Sq": S, "Sk": S, "H": H, "K": K, "D": D,
                     "Dv": Dv, "dtype": "bfloat16", "causal": True},
           **timed(fa.flash_attention_bwd, plain, library, argsets,
                   iters=iters),
           "plain_runs": f"{n} query heads at a time",
           "library": "SDPA backward, fused backends" if refused is None
           else f"none: {refused}",
           "phases_ms": phases,
           "phases_tflops": {name: f / ms / 1e9 for name, ms in phases.items()
                             for key, f in launch_flops.items() if key in name},
           "bound_ms": b_ms, "bound_by": b_by}
    row["library_ratio"] = (None if row["library_ms"] is None
                            else row["ms"] / row["library_ms"])
    row["bound_ratio"] = row["ms"] / b_ms
    del graphs, argsets
    torch.cuda.empty_cache()
    return row


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


# (H, K, D) of each full config whose decode heads the kernels are held at
WIDE_GROUPS = {"olmoe-1b-7b": (16, 16, 128), "qwen3-4b": (32, 8, 128),
               "chatglm3-6b": (32, 2, 128), "granite-20b": (48, 1, 128),
               "musicgen-medium": (24, 24, 64),
               "phi-3-vision-4.2b": (32, 32, 96)}


def phase_kernels_wide(da, cuda_build) -> dict:
    """The decode kernels at the full configs' heads: olmoe-1b-7b's (H 16,
    K 16), G 1, qwen3-4b's (H 32, K 8), G 4, chatglm3-6b's (H 32, K 2),
    G 16, and granite-20b's (H 48, K 1), G 48, the group caps 8, 8, 16 and
    64, all at D 128; musicgen-medium's (H 24, K 24) at D 64 and
    phi-3-vision's (H 32, K 32) at D 96, both G 1 (cap 8); B 8, Sk 1024
    (paged: page size 16, W 64, shuffled table), ragged kv_len, fp32 and
    bf16, at the existing bounds.  Each is held against its plain
    version (a second call bit-equal, rows past kv_len poisoned, paged
    bit-equal to the dense kernel on the gathered rows), then timed against
    its bound, its plain version and, dense, masked SDPA: once with the KV
    heads expanded to H before the call (the library's MHA path on
    inputs G times larger) and once with ``enable_gqa`` on the same
    inputs.  Registers and spills of every instantiation come from the
    build log."""
    F = torch.nn.functional
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(3)
    B, Sk, ps = 8, 1024, 16
    W = Sk // ps
    lens = [1, 1024, 17, 300, 513, 777, 64, 1000]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
    mask = (torch.arange(Sk, device=DEVICE)[None, :]
            < kv_len[:, None])[:, None, None, :]
    rows = {}
    for arch, (H, K, D) in WIDE_GROUPS.items():
        G = H // K
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            q = rand((B, H, D), dtype, gen)
            k = rand((B, Sk, K, D), dtype, gen)
            v = rand((B, Sk, K, D), dtype, gen)
            got = da.decode_attention(q, k, v, kv_len)
            again = da.decode_attention(q, k, v, kv_len)
            want = da.decode_attention_plain(q, k, v, kv_len)
            kd, vd = k.clone(), v.clone()
            dead = torch.arange(Sk, device=DEVICE)[None, :] >= kv_len[:, None]
            kd[dead], vd[dead] = 1e4, 1e4
            poisoned = da.decode_attention(q, kd, vd, kv_len)
            del kd, vd
            torch.cuda.synchronize()
            err = check_close(f"decode {arch} {dtype}", got, want, dtype)
            if not (torch.equal(again, got) and torch.equal(poisoned, got)):
                raise AssertionError(f"decode {arch} {dtype}: a repeat or a "
                                     "poisoned tail changed the output")
            argsets = [a + (kv_len,) for a in copies((q, k, v),
                                                     nbytes(q, k, v))]
            b_ms, b_by = bound(dtype, *decode_work(q, k, v, kv_len))
            t = timed(lambda a, b, c, n: da.decode_attention(a, b, c, n),
                      lambda a, b, c, n: da.decode_attention_plain(a, b, c, n),
                      lambda a, b, c, n: F.scaled_dot_product_attention(
                          a[:, :, None], b.transpose(1, 2), c.transpose(1, 2),
                          attn_mask=mask, enable_gqa=True), argsets)
            wide = [(a[0], a[1].repeat_interleave(G, dim=2)
                     .transpose(1, 2).contiguous(),
                     a[2].repeat_interleave(G, dim=2)
                     .transpose(1, 2).contiguous()) for a in argsets[:2]]
            expanded = time_ms(lambda a, b, c: F.scaled_dot_product_attention(
                a[:, :, None], b, c, attn_mask=mask), wide)
            del wide
            row = {"shape": {"arch": arch, "B": B, "Sk": Sk, "H": H, "K": K,
                             "G": G, "D": D, "dtype": dname, "kv_len": lens},
                   **t, "library_expanded_ms": expanded[0],
                   "library_expanded_call_ms": expanded[1],
                   "library_gqa_ms": t["library_ms"],
                   "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                   "library_ratio": t["ms"] / t["library_ms"],
                   "expanded_ratio": t["ms"] / expanded[0]}
            emit({"phase": "kernel_times", "kernel": "decode_attention",
                  **row})
            rows[f"decode_attention {arch} {dname}"] = row

            # paged, through a shuffled table, sentinels past kv_len
            q, kp, vp, table = paged_case(gen, dtype, B, W, ps, kv_len, H, K,
                                          D)
            got = da.decode_attention_paged(q, kp, vp, table, kv_len)
            want = da.decode_attention_paged_plain(q, kp, vp, table, kv_len)
            P = kp.shape[0]
            kg = kp[table.clamp(max=P - 1)].reshape(B, Sk, K, D).contiguous()
            vg = vp[table.clamp(max=P - 1)].reshape(B, Sk, K, D).contiguous()
            dense = da.decode_attention(q, kg, vg, kv_len)
            torch.cuda.synchronize()
            err = check_close(f"paged decode {arch} {dtype}", got, want,
                              dtype)
            if not torch.equal(got, dense):
                raise AssertionError(f"paged decode {arch} {dtype}: differs "
                                     "from the dense kernel on its rows")
            argsets = [a + (table, kv_len) for a in copies((q, kp, vp),
                                                           nbytes(q, kp, vp))]
            b_ms, b_by = bound(dtype, *paged_work(q, kp, vp, table, kv_len))
            row = {"shape": {"arch": arch, "B": B, "H": H, "K": K, "G": G,
                             "D": D, "page_size": ps, "W": W, "pages": P,
                             "dtype": dname, "kv_len": lens},
                   **timed(da.decode_attention_paged,
                           da.decode_attention_paged_plain, None, argsets),
                   "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                   "library_ratio": None}
            emit({"phase": "kernel_times", "kernel": "decode_attention_paged",
                  **row})
            rows[f"decode_attention_paged {arch} {dname}"] = row
            del argsets
    emit({"phase": "kernel_registers", "kernel": "decode_split_kernel",
          "ptxas": ptxas_usage(cuda_build, "decode_split_kernel")})
    torch.cuda.empty_cache()
    return rows


def ssd_case(gen, dtype, B, S, H=24, P=64, G=1, N=128, h0=False):
    """SSD inputs from ``gen``: x, dt (softplus'ed), A (negative), B, C and
    an optional h0."""
    x = rand((B, S, H, P), dtype, gen)
    dt = torch.nn.functional.softplus(rand((B, S, H), torch.float32, gen))
    A = -torch.exp(0.3 * rand((H,), torch.float32, gen))
    Bm, Cm = rand((B, S, G, N), dtype, gen), rand((B, S, G, N), dtype, gen)
    h = rand((B, H, P, N), torch.float32, gen) if h0 else None
    return x, dt, A, Bm, Cm, h


def ssd_checked(ssd, gen, dtype, B, S, chunk, h0, H=24, P=64, N=128):
    """One SSD case from ``gen`` against ssd_chunked_ref, y and the final
    state at ``SSD_TOL``, and a second call giving the same bits; prints
    its ``kernels`` line and returns y's max abs error."""
    x, dt, A, Bm, Cm, h = ssd_case(gen, dtype, B, S, H=H, P=P, N=N, h0=h0)
    y, hT = ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h,
                         return_final_state=True)
    y2, hT2 = ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h,
                           return_final_state=True)
    y_ref, hT_ref = ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk, h0=h,
                                       return_final_state=True)
    torch.cuda.synchronize()
    what_case = f"ssd {dtype} B={B} S={S} H={H} P={P} N={N} chunk={chunk}"
    for what, got, want in (("y", y, y_ref), ("state", hT, hT_ref)):
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{what_case} {what}: non-finite values")
        torch.testing.assert_close(
            got.float(), want.float(), **SSD_TOL[dtype],
            msg=lambda m, w=f"{what_case} {what}": f"{w}: {m}")
    if not (torch.equal(y2, y) and torch.equal(hT2, hT)):
        raise AssertionError(f"{what_case}: two calls differ")
    e_y = (y.float() - y_ref.float()).abs().max().item()
    emit({"phase": "kernels", "kernel": "ssd_scan",
          "dtype": str(dtype), "B": B, "S": S, "chunk": chunk,
          "H": H, "P": P, "N": N, "G": 1, "h0": h0,
          "max_abs_err_y": e_y,
          "max_abs_err_state": (hT - hT_ref).abs().max().item(),
          "max_abs_y": y_ref.float().abs().max().item(),
          "max_abs_state": hT_ref.abs().max().item(),
          "repeat_identical": True})
    return e_y


def ssd_call(fn, chunk: int):
    """``fn`` (the kernel or its plain version) as a call on one argset
    (x, dt, A, B, C[, h0]), the final state returned."""
    return lambda x, dt, A, Bm, Cm, h=None: fn(
        x, dt, A, Bm, Cm, chunk=chunk, h0=h, return_final_state=True)


def ssd_timed(ssd, gen, B, S, chunk, h0, err, H=24, P=64, N=128) -> tuple:
    """The bf16 kernel's, the plain version's and the phases' device ms at
    one shape, beside its bound; prints its ``kernel_times`` line and
    returns (the row, the argsets it cycled through)."""
    dt_ = torch.bfloat16
    x, dt, A, Bm, Cm, h = ssd_case(gen, dt_, B, S, H=H, P=P, N=N, h0=h0)
    ins = (x, dt, Bm, Cm) + ((h,) if h0 else ())
    sets = [(a[0], a[1], A, a[2], a[3]) + a[4:]
            for a in copies(ins, nbytes(*ins))]
    b_ms, b_by = bound(dt_, *ssd_work(x, dt, Bm, chunk, h))
    row = {"shape": {"B": B, "S": S, "H": H, "P": P, "N": N, "G": 1,
                     "chunk": chunk, "h0": h0, "dtype": "bfloat16"},
           **timed(ssd_call(ssd.ssd_scan, chunk),
                   ssd_call(ssd.ssd_scan_plain, chunk), None, sets),
           "phases_ms": device_breakdown(ssd_call(ssd.ssd_scan, chunk), sets),
           "launches_per_call": ssd.chunk_plan(S, chunk, True)[3],
           "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
           "library_ratio": None}
    emit({"phase": "kernel_times", "kernel": "ssd_scan", **row})
    return row, sets


def phase_kernels_ssd(ssd) -> dict:
    """The SSD scan kernel against ssd_chunked_ref (``ssd_checked``) at the
    full mamba2-130m head (H 24, P 64, N 128, one group): (B, S, chunk,
    h0) = the prefill [2, 1024] in chunks of 256, a ragged S 1000, S 64 in
    one chunk of 64 from an h0, 16 chunks (S 4096), a chunk of 100
    (partial 64-row tiles), and the serving shape [8, 64] from an h0; and
    at the full jamba-v0.1-52b head (H 128, P 64, N 16): its prefill [4,
    256] in one chunk, the serving chunk [8, 64] from an h0, and [2, 1024]
    in chunks of 256.  Then the bf16 times (``ssd_timed``) at the mamba
    prefill's and serving prefill's shapes, the chunk sweep, and the Jamba
    prefill's shape.  Returns the mamba prefill's row, the ``kernels``
    line's."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2)
    err = err16 = 0.0
    cases = ((2, 1024, 256, False), (2, 1000, 256, False), (2, 64, 64, True),
             (2, 4096, 256, False), (2, 1000, 100, False), (8, 64, 64, True))
    jamba = ((4, 256, 256, False), (8, 64, 64, True), (2, 1024, 256, False))
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, chunk, h0 in cases:
            err = max(err, ssd_checked(ssd, gen, dtype, B, S, chunk, h0))
        for B, S, chunk, h0 in jamba:
            err16 = max(err16, ssd_checked(ssd, gen, dtype, B, S, chunk, h0,
                                           H=128, N=16))

    # times, bf16: the main path's shape (the mamba prefill [2, 1024] in
    # chunks of 256), then the serving prefill's (8 slots, one chunk of 64
    # from the cached state), which most of the path's launches have
    rows = []
    for B, S, chunk, h0 in ((2, 1024, 256, False), (8, 64, 64, True)):
        rows.append(ssd_timed(ssd, gen, B, S, chunk, h0, err))
    # device ms of each phase against the chunk length, at the prefill's
    # shape: where the time goes as chunks, tiles and state slots change
    sweep = {}
    for chunk in (64, 128, 256, 512, 1024):
        phases = device_breakdown(ssd_call(ssd.ssd_scan, chunk), rows[0][1])
        sweep[chunk] = {kernel_name(k): v for k, v in phases.items()}
    emit({"phase": "kernel_times", "kernel": "ssd_scan",
          "chunk_sweep_ms": sweep})
    ssd_timed(ssd, gen, 4, 256, 256, False, err16, H=128, N=16)
    return {"ssd_scan": rows[0][0]}


def phase_kernels_ssd_bwd(ssd, cuda_build) -> dict:
    """The SSD backward kernel (from the forward kernel's state scratch)
    against its plain version, autograd through ``ssd_chunked_ref``: the
    training shape [2, 4096] (H 24, P 64, N 128, G 1, chunk 256, the final
    state dropped), a ragged S 1000 in chunks of 100 with G 2 and h0 at
    (P, N) = (32, 16) and with dhT, one chunk of 64 without and with dhT,
    and at full (P, N) the bf16 body's runs of 4 heads where they do not
    divide a group: 10 heads in 2 groups (runs of 4 and 1 that end at the
    group boundary) and 6 heads in one (runs of 4 and 2); and at
    jamba-v0.1-52b's head (P, N) = (64, 16): its training shape [2, 4096]
    (H 128 at G 1: 32 runs of 4 heads in bf16, 128 partials in fp32) and a
    ragged S 1000 in chunks of 100 with G 2, h0 and dhT.  fp32 within
    2e-3 of the plain version evaluated in fp64 on the
    same inputs (the fp32 plain version's own rounding in the decay
    gradient's long sums is of the bound's size at [2, 4096], so the
    distance from it is printed, not bounded); bf16 dx, ddt, dA, dB, dC and
    dh0 each no further from the fp32 plain gradients than twice the bf16
    plain version is, or within 1e-1 of the bf16 plain version where that
    is looser.  Two calls must give the same bits.  Then the times, bf16
    at [2, 4096], with each launch's device ms (``ssd_bwd_timed``), at both
    full heads (rows 6 and 6a)."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(4)
    names = ("dx", "ddt", "dA", "dB", "dC", "dh0")
    errs = {(64, 128): 0.0, (64, 16): 0.0, (32, 16): 0.0}
    # (B, S, chunk, H, P, N, G, h0, dhT)
    cases = [(2, 4096, 256, 24, 64, 128, 1, False, False),
             (2, 1000, 100, 8, 32, 16, 2, True, True),
             (2, 64, 64, 24, 64, 128, 1, False, False),
             (2, 64, 64, 24, 64, 128, 1, True, True),
             (2, 1000, 256, 10, 64, 128, 2, True, True),
             (1, 600, 256, 6, 64, 128, 1, False, False),
             (2, 4096, 256, 128, 64, 16, 1, False, False),
             (2, 1000, 100, 8, 64, 16, 2, True, True)]
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, chunk, H, P, N, G, h0, dhT in cases:
            x, dt, A, Bm, Cm, h = ssd_case(gen, dtype, B, S, H, P, G, N, h0)
            dy = rand((B, S, H, P), dtype, gen)
            dh = rand((B, H, P, N), torch.float32, gen) if dhT else None
            _, _, states = ssd._forward(x, dt, A, Bm, Cm, h, chunk, True)
            got = ssd.ssd_scan_bwd(x, dt, A, Bm, Cm, h, dy, dh, chunk=chunk,
                                   states=states)
            again = ssd.ssd_scan_bwd(x, dt, A, Bm, Cm, h, dy, dh, chunk=chunk,
                                     states=states)
            want = ssd.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, h, dy, dh,
                                          chunk=chunk)
            wide = torch.float64 if dtype == torch.float32 else torch.float32
            exact = ssd.ssd_scan_bwd_plain(
                *(t.to(wide) for t in (x, dt, A, Bm, Cm)),
                None if h is None else h.to(wide), dy.to(wide),
                None if dh is None else dh.to(wide), chunk=chunk)
            torch.cuda.synchronize()
            what = f"ssd bwd {dtype} {(B, S, chunk, H, P, N, G, h0, dhT)}"
            line = {"phase": "kernels", "kernel": "ssd_scan_bwd",
                    "dtype": str(dtype), "B": B, "S": S, "chunk": chunk,
                    "H": H, "P": P, "N": N, "G": G, "h0": h0, "dhT": dhT,
                    "launches_per_call": ssd.bwd_plan(S, chunk, h0)[2],
                    "repeat_identical": all(
                        (a is None and b is None) or torch.equal(a, b)
                        for a, b in zip(got, again, strict=True))}
            checks = []     # (got, want, name): held after the line prints
            for name, g, w, w_ex in zip(names, got, want, exact, strict=True):
                if w is None:
                    continue
                if not torch.isfinite(g.float()).all():
                    raise AssertionError(f"{what} {name}: non-finite")
                e = (g.double() - w.double()).abs().max().item()
                line[f"{name}_max_abs_err"] = e
                line[f"{name}_max_abs"] = w_ex.abs().max().item()
                if dtype == torch.float32:      # against the fp64 plain
                    e_ex = (g.double() - w_ex).abs().max().item()
                    line[f"{name}_vs_fp64"] = [
                        e_ex, (w.double() - w_ex).abs().max().item()]
                    errs[P, N] = max(errs[P, N], e_ex)
                    checks.append((g.double(), w_ex, name))
                    continue
                kern = (g.float() - w_ex).abs().max().item()
                plain = (w.float() - w_ex).abs().max().item()
                line[f"{name}_vs_fp32"] = [kern, plain]
                errs[P, N] = max(errs[P, N], e)
                if kern > 2 * plain:
                    checks.append((g.float(), w.float(), name))
            emit(line)
            for g, w, name in checks:
                torch.testing.assert_close(
                    g, w, **SSD_TOL[dtype],
                    msg=lambda m, w_=f"{what} {name}": f"{w_}: {m}")
            if not line["repeat_identical"]:
                raise AssertionError(f"{what}: two calls differ")
            del checks
            del x, dy, states, got, again, want, exact
    torch.cuda.empty_cache()

    # times, bf16, at the training shapes (the final state dropped); the
    # error of the mamba row takes the (32, 16) cases too, as it did
    row = ssd_bwd_timed(ssd, gen, 24, 128, max(errs[64, 128], errs[32, 16]),
                        cuda_build)
    ssd_bwd_timed(ssd, gen, 128, 16, errs[64, 16])
    return {"ssd_scan_bwd": row}


def ssd_bwd_timed(ssd, gen, H: int, N: int, err: float,
                  cuda_build=None) -> dict:
    """The bf16 backward's, the plain version's and each launch's device
    ms at a training shape, [2, 4096], H heads at (P, N) = (64, N), G 1,
    chunk 256, the final state dropped, beside its bound; with
    ``cuda_build`` the registers and spills of the bf16 path's kernels.
    Prints its ``kernel_times`` line and returns it."""
    dt_ = torch.bfloat16
    B, S, chunk = 2, 4096, 256
    x, dt, A, Bm, Cm, _ = ssd_case(gen, dt_, B, S, H=H, N=N)
    dy = rand(x.shape, dt_, gen)
    _, _, states = ssd._forward(x, dt, A, Bm, Cm, None, chunk, True)
    argsets = [(a[0], a[1], A, a[2], a[3], a[4], a[5]) for a in
               copies((x, dt, Bm, Cm, dy, states),
                      nbytes(x, dt, Bm, Cm, dy, states))]

    def kernel(x_, dt_, A_, B_, C_, dy_, st_):
        return ssd.ssd_scan_bwd(x_, dt_, A_, B_, C_, None, dy_, chunk=chunk,
                                states=st_)

    def plain(x_, dt_, A_, B_, C_, dy_, st_):
        return ssd.ssd_scan_bwd_plain(x_, dt_, A_, B_, C_, None, dy_,
                                      chunk=chunk)

    b_ms, b_by = bound(dt_, *ssd_bwd_work(x, dt, Bm, chunk))
    phases = device_breakdown(kernel, argsets)
    row = {"shape": {"B": B, "S": S, "H": H, "P": 64, "N": N, "G": 1,
                     "chunk": chunk, "h0": False, "dhT": False,
                     "dtype": "bfloat16"},
           **timed(kernel, plain, None, argsets),
           "phases_ms": {kernel_name(k): v for k, v in phases.items()},
           "launches_per_call": ssd.bwd_plan(S, chunk, False)[2],
           "heads_per_run": ssd.HEADS_PER_RUN[dt_],
           "partials_per_token": ssd.bwd_partials(H, 1, dt_),
           "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
           "library_ratio": None,
           "library": "none: no PyTorch call computes the SSD backward"}
    if cuda_build is not None:
        # the kernels of the bf16 path: the wgmma phases, and the state
        # pass, decay gradient and reduction that both dtypes run
        row["ptxas"] = {k: v for k, v in ptxas_usage(
            cuda_build,
            r"ssd_bwd_(?:\w+_wgmma|state_pass|decay|reduce)").items()
            if "float" not in k}
    row["bound_ratio"] = row["ms"] / b_ms
    emit({"phase": "kernel_times", "kernel": "ssd_scan_bwd", **row})
    del argsets, states
    torch.cuda.empty_cache()
    return row


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


@contextlib.contextmanager
def checked_flash(ops, ref, errs: list):
    """Hold every flash call of the model against the plain version on the
    same inputs (the model's own q, k and v at its own shapes) at the
    kernel bound; each call's max abs error goes to ``errs``."""
    kernel = ops.flash_attention

    def checked(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        errs.append(check_close(f"flash in the model, q {tuple(q.shape)} k "
                                f"{tuple(k.shape)}", out,
                                ref.attention_ref(q, k, v, **kw), q.dtype))
        return out
    ops.flash_attention = checked
    try:
        yield
    finally:
        ops.flash_attention = kernel


@contextlib.contextmanager
def checked_ssd(ops, ref, errs: list):
    """Hold every SSD scan call of the model against the plain version on
    the same inputs (the model's own x, dt, A, B, C and h0 at its own
    shapes) at the SSD bound, y and the final state; each call's max abs
    error of y goes to ``errs``."""
    kernel = ops.ssd_scan

    def checked(x, dt, A, Bm, Cm, **kw):
        out = kernel(x, dt, A, Bm, Cm, **kw)
        want = ref.ssd_chunked_ref(x, dt, A, Bm, Cm, **kw)
        pairs = zip(out, want, strict=True) if kw.get("return_final_state") \
            else ((out, want),)
        name = f"ssd scan in the model, x {tuple(x.shape)}"
        errs.append(max(check_close(name, got, w, x.dtype, SSD_TOL)
                        for got, w in pairs))
        return out
    ops.ssd_scan = checked
    try:
        yield
    finally:
        ops.ssd_scan = kernel


def model_layers(lm, cfg, params):
    """(mixer, ffn, layer params) of every layer in order: a block
    segment's layers, and each super-block's in its plan's order."""
    from repro_torch.models import blocks

    for seg, seg_p in zip(lm.segments(cfg), params["segments"], strict=True):
        for i in range(seg.count):
            unit = blocks.take_layer(seg_p, i)
            if seg.kind == "hybrid":
                for group, idx, mixer, ffn in seg.plan.entries:
                    yield mixer, ffn, blocks.take_layer(unit[group], idx)
            else:
                yield seg.mixer, seg.ffn, unit


@contextlib.contextmanager
def sliced_experts(moe, n: int = 32):
    """Run the MoE experts ``n`` at a time with their weights cast to the
    buffer's dtype slice by slice (the fp32 reference only: deepseek-v3's
    256 experts of one layer are 42 GiB in fp32).  Exact: each expert's
    products meet only its own rows."""
    full = moe.expert_ffn

    def sliced(p, buf):
        return torch.cat([full({k: p[k][e:e + n].to(buf.dtype)
                                for k in ("wi", "wg", "wo")}, buf[e:e + n])
                          for e in range(0, buf.shape[0], n)])
    moe.expert_ffn = sliced
    try:
        yield
    finally:
        moe.expert_ffn = full


@contextlib.contextmanager
def recorded_routing(log: list):
    """Append each MoE call's routing to ``log``: (the chosen expert ids
    [T, k] and the kept ones, -1 where dropped, each row sorted).  The
    comparison runs only; the dispatch is unchanged."""
    from repro_torch.models import moe

    dispatch = moe._dispatch

    def recording(ids, E, C):
        plan = dispatch(ids, E, C)
        kept = torch.empty_like(plan[1])
        kept[plan[0]] = plan[1]             # back to token order
        log.append((ids.sort(dim=-1).values,
                    torch.where(kept.view_as(ids), ids, -1)
                    .sort(dim=-1).values))
        return plan
    moe._dispatch = recording
    try:
        yield
    finally:
        moe._dispatch = dispatch


def routing_vs(log: list, want: list, B: int, S: int) -> dict:
    """How far the routing in ``log`` lies from ``want`` (both from
    ``recorded_routing``, one entry a MoE layer, T = B*S tokens): the
    (token, layer) pairs whose chosen experts differ, those whose kept
    experts differ, and for each sequence's last token (the row of the
    logits compared) whether any layer kept other experts for it."""
    chosen = sum(int((a[0] != b[0]).any(-1).sum()) for a, b in
                 zip(log, want, strict=True))
    kept = [(a[1] != b[1]).any(-1) for a, b in zip(log, want, strict=True)]
    last = torch.arange(B, device=DEVICE) * S + S - 1
    return {"moe_layers": len(log), "tokens": B * S,
            "chosen_differ": chosen,
            "kept_differ": sum(int(k.sum()) for k in kept),
            "last_token_kept_differs": [
                bool(torch.stack([k[t] for k in kept]).any()) for t in last]}


def prefill_fp32(cfg, params, lm, batch):
    """``lm.prefill``'s last-token logits on ``batch`` (tokens, and image
    embeds for the vision stub) with every weight in fp32, one
    layer cast at a time (granite-20b's weights in fp32, 76 GiB, would not
    fit beside its bf16 ones), in order (``model_layers``: a Jamba
    super-block's in its plan's order), an MoE layer's experts 32 at a
    time (``sliced_experts``; Jamba's 16 of one layer are 11.3 GB in
    fp32): the reference that the bf16 paths are measured against.  The
    caller picks the attention and the SSD scan (the plain versions)."""
    from repro_torch.models import blocks, moe
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.params import tree_map

    experts = ("wi", "wg", "wo")
    tokens, emb = batch["tokens"], params["embed"]
    positions = torch.arange(tokens.shape[1], device=DEVICE)[None, :]
    h = (sum(emb[c][tokens[..., c]].float()
             for c in range(cfg.num_codebooks))
         if cfg.num_codebooks else emb[tokens].float())
    if "image_embeds" in batch:     # the merge of lm.embed_tokens, in fp32
        h = lm._merge_image(h, batch["image_embeds"],
                            batch["image_positions"])
    with sliced_experts(moe):
        for mixer, ffn, bf16 in model_layers(lm, cfg, params):
            layer = tree_map(lambda t: t.float(), {
                k: v for k, v in bf16.items() if k != "ffn"})
            if "ffn" in bf16:   # the experts stay bf16 until sliced
                layer["ffn"] = {
                    k: v if ffn == "moe" and k in experts
                    else tree_map(lambda t: t.float(), v)
                    for k, v in bf16["ffn"].items()}
            h, _ = blocks.apply_block(cfg, layer, h, positions, mixer, ffn)
            del layer
    h = rmsnorm(h, params["final_norm"].float(), cfg.norm_eps)[:, -1]
    w = lm.head_weights(cfg, params).float()
    return (torch.einsum("...d,cdv->...cv", h, w) if cfg.num_codebooks
            else h @ w)


def prefill_batch(cfg) -> dict:
    """The prefill phase's batch on the card: [4, 256] tokens from a seed
    ([4, 256, cb] with codebooks); for the vision stub [2, 1024] with
    ``num_image_tokens`` image embeds at positions 0.. (576 for
    phi-3-vision), the synthetic batch of ``repro_torch.data``."""
    from repro_torch.data.synthetic import batch_at, data_config_for

    if cfg.vision_stub:
        host = batch_at(data_config_for(cfg, 1024, 2), 0)
    else:
        rng = np.random.default_rng(0)
        host = {"tokens": rng.integers(0, cfg.vocab_size,
                                       (4, *token_shape(cfg, 256)))}
    return {k: torch.tensor(v, device=DEVICE) for k, v in host.items()}


def phase_prefill(cfg, params, lm, ops, ref, fa, fp32_rule: bool = False):
    """``lm.prefill`` on ``prefill_batch`` ([4, 256] tokens; the vision
    stub's [2, 1024] with its image embeds) through the flash kernel against the same
    call with the plain attention, in bf16, at the JAX package's bf16
    kernel bound (5e-2).  A second run of the same prefill holds every
    flash call against the plain version on that call's inputs, at the
    same bound (``checked_flash``), and every SSD scan call of a model
    with Mamba layers (Jamba) at the SSD bound (``checked_ssd``); the
    plain path routes both through their plain versions.  With
    ``fp32_rule`` (the configs deeper and wider than smollm-360m, through
    whose random-weight layers two bf16 paths that round in different
    places drift apart by more than the bound; the line reports how much
    of it the worst logit uses) the logits' gate is instead the rule the mamba phase uses: the
    kernel path may be no further from the fp32 logits (``prefill_fp32``,
    plain attention) than twice the bf16 plain path is; and the fp32
    logits through the kernel (its fp32 body) must lie within the bound of
    the fp32 plain ones.  For an MoE model the line also says, for each
    bf16 path, how many tokens' experts differ from the fp32 path's
    (``routing_vs``): a token whose kept experts differ lies far from the
    fp32 logits however exact the attention.  The comparison runs'
    launches are not counted."""
    from repro_torch.kernels import ssd_scan as ssd

    batch = prefill_batch(cfg)
    B, S = batch["tokens"].shape[:2]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = lm.prefill(cfg, params, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    ssd_launches = ssd.ssd_scan.launches
    if launches <= 0:
        raise AssertionError("prefill did not launch the flash kernel")
    mixers = [m for m, _, _ in model_layers(lm, cfg, params)]
    n_attn, n_mamba = len(mixers) - mixers.count("mamba"), \
        mixers.count("mamba")
    if ssd_launches != n_mamba:
        raise AssertionError(f"prefill: {ssd_launches} ssd_scan launches, "
                             f"{n_mamba} Mamba layers")
    want_shape = (B, *token_shape(cfg, 1)[1:], cfg.vocab_size)
    if tuple(logits.shape) != want_shape or not torch.isfinite(
            logits.float()).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             f"finite {want_shape}")
    seg = lm.segments(cfg)[0]
    first, kv = (seg.count,), caches[0]
    if seg.kind == "hybrid":              # the attention group's stack
        first, kv = (seg.count, seg.plan.group_sizes["attn_dense"]), \
            kv["attn_dense"]
    if cfg.attention_kind == "mla":       # the latents of the first segment
        name, kv_shape = "ckv", (*first, B, S, cfg.mla.kv_lora_rank)
    else:
        name, kv_shape = "k", (*first, B, S, cfg.num_kv_heads, cfg.head_dim)
    if tuple(kv[name].shape) != kv_shape:
        raise AssertionError(f"prefill cache {tuple(kv[name].shape)}")
    routes = {"plain": [], "fp32": [], "kernel": []}
    with plain_attention(ops, ref), plain_ssd(ops, ref):
        with recorded_routing(routes["plain"]):
            plain, _ = lm.prefill(cfg, params, batch)
        with recorded_routing(routes["fp32"]):
            plain32 = (prefill_fp32(cfg, params, lm, batch) if fp32_rule
                       else None)
    calls: list = []
    ssd_calls: list = []
    with checked_flash(ops, ref, calls), checked_ssd(ops, ref, ssd_calls), \
            recorded_routing(routes["kernel"]):
        lm.prefill(cfg, params, batch)
    kernel32 = prefill_fp32(cfg, params, lm, batch) if fp32_rule else None
    torch.cuda.synchronize()
    fa.flash_attention.launches = launches
    ssd.ssd_scan.launches = ssd_launches
    diff = (logits.float() - plain.float()).abs()
    err = diff.max().item()
    # how much of the bound the worst logit uses (the check passes at <= 1)
    margin = (diff / (5e-2 + 5e-2 * plain.float().abs())).max().item()
    agree = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    row = {"phase": "prefill", "arch": cfg.name,
           "batch": list(batch["tokens"].shape),
           "image_tokens": (batch["image_embeds"].shape[1]
                            if "image_embeds" in batch else 0),
           "layers": cfg.num_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "seconds": seconds, "flash_launches": launches,
           "max_abs_err_vs_plain": err, "bound_used": margin,
           "max_abs_logit": plain.float().abs().max().item(),
           "top1_agreement": agree, "flash_calls_checked": len(calls),
           "flash_max_abs_err_in_model": max(calls)}
    if n_mamba:
        row.update({"ssd_launches": ssd_launches,
                    "ssd_calls_checked": len(ssd_calls),
                    "ssd_max_abs_err_in_model": max(ssd_calls)})
    if plain32 is not None:
        kernel_off = (logits.float() - plain32).abs().max().item()
        plain_off = (plain.float() - plain32).abs().max().item()
        row.update({"bf16_kernel_vs_fp32_plain": kernel_off,
                    "bf16_plain_vs_fp32_plain": plain_off,
                    "top1_agreement_fp32": (logits.argmax(-1) == plain32
                                            .argmax(-1)).float().mean().item(),
                    "fp32_kernel_vs_fp32_plain": (kernel32 - plain32).abs()
                    .max().item(),
                    "bf16_vs_fp32_by_row": {
                        name: (x.float() - plain32).abs().amax(-1).tolist()
                        for name, x in (("kernel", logits),
                                        ("plain", plain))},
                    "gate": "kernel path within 2x the bf16 plain path's "
                            "distance from the fp32 logits; fp32 kernel "
                            "logits within 5e-2 of the fp32 plain ones"})
        if cfg.moe is not None:
            row["routing_vs_fp32"] = {
                name: routing_vs(routes[name], routes["fp32"], B, S)
                for name in ("kernel", "plain")}
    emit(row)
    if len(calls) != n_attn or len(ssd_calls) != n_mamba:
        raise AssertionError(f"{cfg.name}: {len(calls)} flash and "
                             f"{len(ssd_calls)} ssd calls checked")
    if plain32 is not None:
        torch.testing.assert_close(kernel32, plain32, atol=5e-2, rtol=5e-2)
        if not kernel_off <= 2 * plain_off:
            raise AssertionError(f"{cfg.name} bf16 prefill: kernel path "
                                 f"{kernel_off} from the fp32 logits, plain "
                                 f"path {plain_off}")
        return
    # bf16 through every layer: the JAX package's bf16 kernel bound
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


# the depth of the serving paths that were cut to make room in the run's
# time limit for later paths (the dense configs and olmoe for serving
# musicgen-medium and phi-3-vision-4.2b, those two for training them, all
# six again for training jamba-v0.1-52b, and again for the tune phase; a
# serving path costs 1.4-4.4 s a layer, most of it the eager and host runs
# and the eager profile, and twice that on a slow host); their widths are
# published, and their decode kernels are held at full width in
# phase_kernels_wide whatever the depth
SERVE_LAYERS = {"qwen3-4b": 2, "chatglm3-6b": 2, "granite-20b": 2,
                "olmoe-1b-7b": 2, "musicgen-medium": 3,
                "phi-3-vision-4.2b": 4,
                # cut from full depth for the tp phase (PR 33)
                "smollm-360m": 16, "mamba2-130m": 12}
# (qwen3-4b, chatglm3-6b and granite-20b: 3 layers until the tp phase's
# h-j and the dryrun phase's mesh cells joined the run)

# requests every serving path serves (the dense configs' 12 were cut to
# this when jamba-v0.1-52b joined the run): few enough that the whole run
# stays inside its time limit on a slow host
SMALL_MODEL_REQUESTS = 8


def token_shape(cfg, n: int) -> tuple:
    """The shape of ``n`` tokens: (n,), or (n, cb) with codebooks."""
    return (n, cfg.num_codebooks) if cfg.num_codebooks else (n,)


def prompts_for(cfg, seed: int = 0, n: int = 12):
    """``n`` prompts of 16-300 tokens (each of cb codebooks for a codebook
    model) from a seed."""
    rng = np.random.default_rng(seed)
    plens = rng.integers(16, 301, n)
    return [rng.integers(0, cfg.vocab_size, token_shape(cfg, int(k)))
            .astype(np.int32) for k in plens]


@contextlib.contextmanager
def eager_fused(DecodeEngine):
    """Run the engines' three graphed bodies eagerly on the card, with no
    CUDA graph and no host sync inside them: the fused decode loop, the
    chunked prefill and host mode's decode step (the comparison runs only;
    the port has no such switch)."""
    saved = (DecodeEngine._run_fused, DecodeEngine._run_prefill,
             DecodeEngine._run_host_step)
    DecodeEngine._run_fused = lambda self: no_host_sync(self._fused_steps)(
        self.steps_per_sync)
    DecodeEngine._run_prefill = lambda self: no_host_sync(
        self._prefill_body)()
    DecodeEngine._run_host_step = lambda self: no_host_sync(
        self._host_step_body)()
    try:
        yield
    finally:
        (DecodeEngine._run_fused, DecodeEngine._run_prefill,
         DecodeEngine._run_host_step) = saved


def no_sync_replays(eng) -> None:
    """Hold every replay of ``eng``'s graphs to no host sync."""
    eng._replay_graph = no_host_sync(eng._replay_graph)


def time_pumps(eng, pumps: list) -> None:
    """Append to ``pumps`` one pair of CUDA events around each run of
    ``eng``'s prefill runner (one per pump that takes a slot)."""
    run = eng._run_prefill

    def timed():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        pumps.append((start, end))
    eng._run_prefill = timed


def check_graph_counts(graph: dict, label: str, mode: str, syncs: int,
                       steps: int, pumps: int) -> None:
    """The exact captures and replays of each of the engine's graphs: in
    mode "graph" one fused-loop capture replayed once a sync, in "host" one
    host-step capture replayed once a step, in both one chunked-prefill
    capture replayed once per pump that took a slot (``pumps``, at least
    one); in "eager" no capture and no replay."""
    want = {k: 0 for k in graph if k.endswith(("captures", "replays"))}
    if mode == "graph":
        want.update(captures=1, replays=syncs)
    if mode == "host":
        want.update(host_step_captures=1, host_step_replays=steps)
    if mode != "eager":
        want.update(prefill_captures=1, prefill_replays=pumps)
    got = {k: graph[k] for k in want}
    if got != want or pumps < 1:
        raise AssertionError(f"{label} {mode}: graphs {got}, want {want} "
                             f"({pumps} pumps)")


def serve(cfg, params, DecodeEngine, Request, prompts, counter, label: str,
          mode: str, temperature: float = 0.0, steps_per_sync: int = 8,
          **engine_kw) -> list:
    """Serve ``prompts`` (32 tokens each, greedy unless ``temperature``)
    through a ``DecodeEngine`` with 8 slots, max_seq 1024,
    ``steps_per_sync`` steps per sync and prefill chunk 64; mode "graph" is
    the fused loop as the port runs it on the card (the loop and the
    chunked prefill each one CUDA graph, captured once, each replay in
    sync-debug "error" mode), "eager" the same without the graphs, and
    "host" the per-step host mode (its decode step and the chunked prefill
    graphed, as in "graph").  Checks every request completes with 32
    tokens, ``counter``'s kernel launched (``counter`` None: a path that
    launches no kernel) and each graph's exact captures and replays
    (``check_graph_counts``).  Returns (tokens, the engine's
    ``kv_stats()``)."""
    eng = DecodeEngine(cfg, params, batch_slots=8, max_seq=1024,
                       mode="host" if mode == "host" else "fused",
                       steps_per_sync=steps_per_sync, prefill_chunk=64,
                       device=DEVICE, **engine_kw)
    pumps: list = []
    reqs = [Request(prompt=p, max_new_tokens=32, temperature=temperature)
            for p in prompts]
    for r in reqs:
        eng.submit(r)
    before = counter.launches if counter is not None else 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with eager_fused(DecodeEngine) if mode == "eager" \
            else contextlib.nullcontext():
        if mode != "eager":
            no_sync_replays(eng)
        time_pumps(eng, pumps)
        steps = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = [i for i, r in enumerate(reqs)
           if r.failed or not r.done or len(r.output) != 32]
    if bad:
        raise AssertionError(f"{label} {mode}: requests {bad} did not "
                             "complete with 32 tokens")
    launches = counter.launches - before if counter is not None else 0
    if counter is not None and launches <= 0:
        raise AssertionError(f"{label} {mode}: no {counter.__name__} launch")
    graph = eng.graph_stats()
    check_graph_counts(graph, label, mode, steps // steps_per_sync, steps,
                       len(pumps))
    if eng.pool is not None and eng.pool.used_pages:
        raise AssertionError(f"{label} {mode}: {eng.pool.used_pages} pages "
                             "still held after every request completed")
    total = sum(len(r.output) for r in reqs)
    # a codebook model's tokens are (cb,) arrays: compared as lists
    tokens = [[np.asarray(t).tolist() for t in r.output] for r in reqs]
    emit({"phase": "serve", "path": label, "mode": mode,
          "steps_per_sync": steps_per_sync,
          "temperature": temperature, "requests": len(reqs),
          "host_syncs_in_fused_loop": None if mode == "host" else 0,
          "prompt_lens": [len(p) for p in prompts], "tokens": total,
          "steps": steps, "wall_s": wall, "tokens_per_s": total / wall,
          "prefill_pumps": len(pumps),
          "kernel_launches": {} if counter is None
          else {counter.__name__: launches}, "graph": graph,
          "launches_per_replay": {w.__name__: n
                                  for w, n in eng._per_replay.items()},
          "kv_stats": eng.kv_stats()})
    return tokens, eng.kv_stats()


def differ(a, b) -> list:
    return [i for i, (x, y) in enumerate(zip(a, b, strict=True)) if x != y]


def serve_modes(cfg, params, DecodeEngine, Request, prompts, counter,
                label: str, **engine_kw) -> list:
    """Greedy tokens in graph, eager and host modes, which must all agree,
    then a temperature-1.0 batch in the same three modes whose tokens
    must agree too (the same keys and counters, the same kernels).
    Returns the greedy tokens.

    An MoE model's host mode is held instead to the graph at one step a
    sync, whose prefill chunks fall between the same decode steps as host
    mode's.  The expert capacity couples the rows of one prefill chunk,
    the idle slots' rows included, and an idle slot's rows attend to its
    own cache rows, which the decode steps run since the last chunk have
    written; so 8 steps a sync and host mode may legitimately drop
    different assignments: the JAX engine's host and fused tokens differ
    alike under capacity drops on the CPU
    (``tests/test_torch_moe.py::test_capacity_drops_part_modes_and_layouts_in_both_engines``).
    The line reports how many requests of host mode differ from the graph
    at 8 steps a sync."""
    moe = cfg.moe is not None
    out, hot = {}, {}
    for temperature, got in ((0.0, out), (1.0, hot)):
        for mode in ("graph", "eager", "host"):
            got[mode] = serve(cfg, params, DecodeEngine, Request, prompts,
                              counter, label, mode, temperature=temperature,
                              **engine_kw)[0]
        if moe:
            got["graph_1"] = serve(cfg, params, DecodeEngine, Request,
                                   prompts, counter, label, "graph",
                                   temperature=temperature, steps_per_sync=1,
                                   **engine_kw)[0]
        for mode, want in (("eager", "graph"),
                           ("host", "graph_1" if moe else "graph")):
            if got[mode] != got[want]:
                raise AssertionError(
                    f"{label} temperature {temperature}: {mode} and {want} "
                    f"tokens differ for requests "
                    f"{differ(got[mode], got[want])}")
    if hot["graph"] == out["graph"]:
        raise AssertionError(f"{label}: temperature 1.0 drew the greedy "
                             "tokens")
    line = {"phase": "serve", "path": label, "host_equals_graph": True,
            "eager_equals_graph": True, "sampled_host_equals_graph": True,
            "sampled_eager_equals_graph": True}
    if moe:
        line.update({
            "host_held_to": "graph at 1 step a sync",
            "host_requests_differing_from_graph_8": [
                len(differ(got["host"], got["graph"]))
                for got in (out, hot)]})
    emit(line)
    return out["graph"]


def phase_serve(cfg, params, DecodeEngine, Request, da) -> list:
    """Dense smollm-360m serving, graph, eager and host; the tokens must
    agree; the prefill graph's cache must equal the eager body's."""
    check_prefill_bits(cfg, params, DecodeEngine, Request, "dense")
    return serve_modes(cfg, params, DecodeEngine, Request,
                       prompts_for(cfg, n=SMALL_MODEL_REQUESTS),
                       da.decode_attention, "dense")


def phase_serve_paged(cfg, params, DecodeEngine, Request, da, dense) -> None:
    """Paged smollm-360m serving, page size 16: the default pool (capacity
    parity, 512 pages) in graph, eager and host modes, and a 64-page pool
    (1,024 rows against the dense layout's 8,192; the least the engine
    takes) in graph mode, which must preempt.  Every run's greedy tokens
    equal ``dense``; the prefill graph's cache must equal the eager
    body's."""
    check_prefill_bits(cfg, params, DecodeEngine, Request, "paged",
                       kv_layout="paged", page_size=16)
    prompts = prompts_for(cfg, n=SMALL_MODEL_REQUESTS)
    got = serve_modes(cfg, params, DecodeEngine, Request, prompts,
                      da.decode_attention_paged, "paged", kv_layout="paged",
                      page_size=16)
    if got != dense:
        raise AssertionError(f"paged: tokens differ from dense for requests "
                             f"{differ(got, dense)}")
    got, stats = serve(cfg, params, DecodeEngine, Request, prompts,
                       da.decode_attention_paged, "paged_small_pool", "graph",
                       kv_layout="paged", page_size=16, num_pages=64)
    if got != dense:
        raise AssertionError(f"paged, 64 pages: tokens differ from dense for "
                             f"requests {differ(got, dense)}")
    if stats["preemptions"] < 1:
        raise AssertionError(f"paged, 64 pages: no preemption {stats}")
    emit({"phase": "serve", "path": "paged", "tokens_equal_dense": True})


def cache_leaves(eng) -> list:
    """Every cache leaf of ``eng``, a paged pool without its sink page
    (inactive rows write there, in no fixed order, and no read reaches
    it)."""
    from repro_torch.models.params import tree_leaves

    pools = {id(leaf): ax for leaf, ax in eng._pool_leaves}
    return [leaf.narrow(pools[id(leaf)], 0, leaf.shape[pools[id(leaf)]] - 1)
            if id(leaf) in pools else leaf for leaf in tree_leaves(eng.cache)]


def check_prefill_bits(cfg, params, DecodeEngine, Request, label: str,
                       **engine_kw) -> None:
    """One prefill pump (8 slots, chunk 64; prompts from ``prompts_for``,
    those longer than 64 tokens take a chunk) through the captured graph
    and one through the eager body, from equal fresh engines: every cache
    leaf the two leave must be equal bit for bit."""
    prompts = prompts_for(cfg, seed=3, n=8)
    engines = []
    for mode in ("graph", "eager"):
        with eager_fused(DecodeEngine) if mode == "eager" \
                else contextlib.nullcontext():
            eng = DecodeEngine(cfg, params, batch_slots=8, max_seq=1024,
                               prefill_chunk=64, device=DEVICE, **engine_kw)
            if mode == "graph":
                no_sync_replays(eng)
            for p in prompts:
                eng.submit(Request(prompt=p, max_new_tokens=32))
            eng._admit()
            eng._pump_prefill()
        engines.append(eng)
    torch.cuda.synchronize()
    graph, eager = engines
    stats = graph.graph_stats()
    if stats["prefill_replays"] != 1 or eager.graph_stats()[
            "prefill_captures"]:
        raise AssertionError(f"{label} prefill bits: {stats}")
    pairs = list(zip(cache_leaves(graph), cache_leaves(eager), strict=True))
    differ = [i for i, (a, b) in enumerate(pairs) if not torch.equal(a, b)]
    emit({"phase": "prefill_graph_bits", "path": label,
          "slots_in_pump": int(graph.pf_done.astype(bool).sum()),
          "leaves": len(pairs), "bytes": nbytes(*(a for a, _ in pairs)),
          "leaves_differing": differ, "bit_equal": not differ})
    if differ:
        raise AssertionError(f"{label}: the prefill graph's cache leaves "
                             f"{differ} differ from the eager body's")
    del engines, graph, eager, pairs


TTFT_REQUESTS = 8


def ttft_run(cfg, params, DecodeEngine, Request, poisson_trace, label: str,
             mode: str, **engine_kw) -> dict:
    """Time to first token under ``TTFT_REQUESTS`` requests of
    ``poisson_trace`` (seed 0, 20 a second, prompts of 129-300 tokens: 2-4
    chunks of 64, 32 new tokens each), each submitted at its arrival time
    to a fused engine of 8 slots (8 steps a sync, chunk 64), in mode
    "graph" (the engine as it runs on the card) or "eager".  One request
    of 65 tokens first warms the engine up (one pump and one sync: the
    graphs' captures) outside the timing.
    A request's time to first token is the wall from its arrival to the
    return of the engine step after which its first token is on the host;
    each prefill pump is timed by CUDA events around the prefill runner."""
    trace = poisson_trace(n_requests=TTFT_REQUESTS, rate_per_s=20.0,
                          vocab_size=cfg.vocab_size, seed=0,
                          prompt_lens=(129, 300), output_lens=(32, 32),
                          codebooks=cfg.num_codebooks)
    pumps: list = []
    with eager_fused(DecodeEngine) if mode == "eager" \
            else contextlib.nullcontext():
        eng = DecodeEngine(cfg, params, batch_slots=8, max_seq=1024,
                           steps_per_sync=8, prefill_chunk=64, device=DEVICE,
                           **engine_kw)
        if mode == "graph":
            no_sync_replays(eng)
        # one chunk, one decode step: each graph captured, kernels loaded
        eng.submit(Request(prompt=trace[0].prompt[:65], max_new_tokens=1))
        eng.run_until_drained()
        time_pumps(eng, pumps)          # the trace's pumps, not the warm-up's
        graph0 = eng.graph_stats()
        reqs = [Request(prompt=t.prompt, max_new_tokens=t.max_new_tokens)
                for t in trace]
        first = [None] * len(reqs)
        steps0, i = eng.steps, 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while i < len(reqs) or eng.queue or any(
                r is not None for r in eng.slot_req):
            now = time.perf_counter() - t0
            while i < len(reqs) and trace[i].arrival_s <= now:
                eng.submit(reqs[i])
                i += 1
            if not eng.queue and all(r is None for r in eng.slot_req):
                time.sleep(trace[i].arrival_s - now)
                continue
            eng.step()
            seen = time.perf_counter() - t0
            for k in range(i):
                if first[k] is None and reqs[k].output:
                    first[k] = (seen - trace[k].arrival_s) * 1e3
        wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    bad = [k for k, r in enumerate(reqs) if not r.done or len(r.output) != 32]
    if bad:
        raise AssertionError(f"ttft {label} {mode}: requests {bad} did not "
                             "complete with 32 tokens")
    graph = eng.graph_stats()
    captures = {k: v for k, v in graph.items() if k.endswith("captures")}
    if captures != {k: v for k, v in graph0.items() if k.endswith("captures")}:
        raise AssertionError(f"ttft {label} {mode}: captured during the "
                             f"trace {graph0} -> {graph}")
    if mode == "graph" and (captures["captures"] != 1
                            or captures["prefill_captures"] != 1):
        raise AssertionError(f"ttft {label}: {graph}")
    if mode == "eager" and any(captures.values()):
        raise AssertionError(f"ttft {label} eager: captured {graph}")
    pump_ms = [a.elapsed_time(b) for a, b in pumps]
    ttft = sorted(first)
    row = {"phase": "ttft", "path": label, "mode": mode,
           "requests": len(reqs), "prompt_lens": [len(t.prompt)
                                                  for t in trace],
           "arrival_s": [t.arrival_s for t in trace],
           "ttft_ms": first, "ttft_p50_ms": float(np.median(ttft)),
           "ttft_max_ms": ttft[-1], "wall_s": wall,
           "steps": eng.steps - steps0, "prefill_pumps": len(pump_ms),
           "prefill_pump_event_ms": pump_ms,
           "prefill_pump_event_ms_median": float(np.median(pump_ms)),
           "prefill_capture_ms": graph["prefill_capture_ms"],
           "prefill_graph_pool_mib": graph["prefill_graph_pool_bytes"] / 2**20,
           "decode_graph_pool_mib": graph["graph_pool_bytes"] / 2**20,
           "tokens": [[np.asarray(t).tolist() for t in r.output]
                      for r in reqs]}
    emit({k: v for k, v in row.items() if k != "tokens"})
    return row


def host_step_wall(cfg, params, DecodeEngine, Request, label: str, mode: str,
                   **engine_kw) -> dict:
    """Host mode's wall per decode step, in mode "graph" (the step and the
    chunk as the port runs them on the card) or "eager": 8 requests of
    prompt 200 (three chunks of 64, then forced decode), 16 steps timed
    once every slot decodes, each ending in its host sync."""
    rng = np.random.default_rng(1)
    with eager_fused(DecodeEngine) if mode == "eager" \
            else contextlib.nullcontext():
        eng = DecodeEngine(cfg, params, batch_slots=8, max_seq=1024,
                           mode="host", prefill_chunk=64, device=DEVICE,
                           **engine_kw)
        if mode == "graph":
            no_sync_replays(eng)
        for _ in range(8):
            eng.submit(Request(prompt=rng.integers(
                0, cfg.vocab_size, token_shape(cfg, 200)).astype(np.int32),
                max_new_tokens=64))
        while not eng.live.all() or eng.steps < 2:
            eng.step()                  # admission, chunks, captures
        torch.cuda.synchronize()
        steps0, n = eng.steps, 16
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        wall = time.perf_counter() - t0
    graph = eng.graph_stats()
    if eng.steps - steps0 != n or (mode == "graph" and (
            graph["host_step_captures"] != 1
            or graph["host_step_replays"] != eng.steps)):
        raise AssertionError(f"host step {label} {mode}: {graph}, "
                             f"{eng.steps} steps")
    row = {"phase": "host_mode", "path": label, "mode": mode, "steps": n,
           "wall_ms_per_step": wall * 1e3 / n,
           "host_step_capture_ms": graph["host_step_capture_ms"],
           "host_step_graph_pool_mib":
               graph["host_step_graph_pool_bytes"] / 2**20}
    emit(row)
    return row


def profile_pump(cfg, params, DecodeEngine, Request, label: str, mode: str,
                 **engine_kw) -> dict:
    """Where one prefill pump spends its time, in mode "graph" or "eager":
    8 slots, each with a prompt of 200 tokens (three chunks of 64).  The
    first pump captures (graph), the second is timed (host clock, ending
    in a sync), the third profiled; the idle share is 1 - device busy time
    over the second pump's wall."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(2)
    with eager_fused(DecodeEngine) if mode == "eager" \
            else contextlib.nullcontext():
        eng = DecodeEngine(cfg, params, batch_slots=8, max_seq=1024,
                           prefill_chunk=64, device=DEVICE, **engine_kw)
        if mode == "graph":
            no_sync_replays(eng)
        for _ in range(8):
            eng.submit(Request(prompt=rng.integers(
                0, cfg.vocab_size, token_shape(cfg, 200)).astype(np.int32),
                max_new_tokens=8))
        eng._admit()
        eng._pump_prefill()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._pump_prefill()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng._pump_prefill()
            torch.cuda.synchronize()
    if not (eng.pf_done == 192).all():
        raise AssertionError(f"profile pump {label}: {eng.pf_done}")
    kernels = sorted(_device_events(prof), key=_dev_us, reverse=True)
    busy_ms = sum(_dev_us(e) for e in kernels) / 1e3
    graph = eng.graph_stats()
    row = {"phase": "profile_prefill", "path": label, "mode": mode,
           "what": "one pump: 8 slots x 64 tokens, the second timed, the "
                   "third profiled",
           "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1 - busy_ms / wall_ms,
           "kernels": sum(e.count for e in kernels),
           "prefill_capture_ms": graph["prefill_capture_ms"],
           "prefill_graph_pool_mib": graph["prefill_graph_pool_bytes"] / 2**20,
           "top_device": [(e.key[:60], _dev_us(e) / 1e3, e.count)
                          for e in kernels[:8]]}
    emit(row)
    return row


def phase_ttft(cfg, params, DecodeEngine, Request, label: str,
               modes=("graph", "eager"), **engine_kw) -> None:
    """Time to first token (``ttft_run``), host mode's wall per step
    (``host_step_wall``) and one profiled prefill pump (``profile_pump``),
    each in a turn of each of ``modes`` (a graph and an eager turn on
    mamba; the graph alone on dense and paged smollm since the dry-run
    phase joined the run), and a summary line."""
    from repro_torch.serve.trace import poisson_trace

    rows = {}
    for mode in modes:
        rows[mode] = (
            ttft_run(cfg, params, DecodeEngine, Request, poisson_trace,
                     label, mode, **engine_kw),
            host_step_wall(cfg, params, DecodeEngine, Request, label, mode,
                           **engine_kw),
            profile_pump(cfg, params, DecodeEngine, Request, label, mode,
                         **engine_kw))
    emit({"phase": "ttft_summary", "path": label, **{
        mode: {"ttft_p50_ms": t["ttft_p50_ms"],
               "ttft_max_ms": t["ttft_max_ms"],
               "prefill_pump_event_ms_median":
                   t["prefill_pump_event_ms_median"],
               "host_wall_ms_per_step": h["wall_ms_per_step"],
               "pump_wall_ms": p["wall_ms"],
               "pump_device_busy_ms": p["device_busy_ms"],
               "pump_device_idle_share": p["device_idle_share"]}
        for mode, (t, h, p) in rows.items()},
        "prefill_capture_ms": rows["graph"][0]["prefill_capture_ms"],
        "prefill_graph_pool_mib": rows["graph"][0]["prefill_graph_pool_mib"],
        "decode_graph_pool_mib": rows["graph"][0]["decode_graph_pool_mib"],
        "host_step_graph_pool_mib":
            rows["graph"][1]["host_step_graph_pool_mib"],
        "ttft_tokens_equal_across_turns":
            rows["graph"][0]["tokens"] == rows["eager"][0]["tokens"]
            if "eager" in rows else None})


def check_split_counters(da) -> None:
    """The split-K decode kernels leave their counters at 0 after every
    call, replayed ones included."""
    nonzero = {str(k): int(v.count_nonzero()) for k, v in da._COUNTERS.items()}
    emit({"phase": "split_k_counters", "buffers": len(nonzero),
          "nonzero": nonzero})
    if any(nonzero.values()):
        raise AssertionError(f"split-K counters not 0: {nonzero}")


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


@contextlib.contextmanager
def plain_hybrid(ops, ref):
    """Both the attention ops and the SSD scan through their plain
    versions (a hybrid's comparison run)."""
    with plain_attention(ops, ref), plain_ssd(ops, ref):
        yield


def phase_mamba(lm, ops, ref, ssd, DecodeEngine, Request) -> None:
    """Full-width mamba2-130m (bf16, random weights from a seed):
    ``lm.prefill`` on [2, 1024] through the kernel, held against the
    all-plain path, then 8 greedy requests served in fused and host modes,
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

    cfg = get_config("mamba2-130m").replace(
        num_layers=SERVE_LAYERS["mamba2-130m"])
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
    device = device_breakdown(
        lambda: lm.prefill(cfg, params, {"tokens": tokens}), [()], iters=3)
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
          "device_ms": sum(device.values()),
          "ssd_device_ms": sum(v for k, v in device.items() if "ssd_" in k),
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
    check_prefill_bits(cfg, params, DecodeEngine, Request, "mamba")
    serve_modes(cfg, params, DecodeEngine, Request,
                prompts_for(cfg, seed=1, n=SMALL_MODEL_REQUESTS),
                ssd.ssd_scan, "mamba")
    phase_profile(cfg, params, DecodeEngine, Request, "mamba",
                  turns=("graph",))
    phase_ttft(cfg, params, DecodeEngine, Request, "mamba")


def memory_gib() -> dict:
    """Peak allocated and reserved device memory since the last reset, and
    what is allocated now, in GiB."""
    return {"peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
            "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
            "allocated_gib": torch.cuda.memory_allocated() / 2**30}


def phase_arch(arch: str, lm, ops, ref, fa, da, DecodeEngine, Request, *,
               paged: str | None = None, small_pool: bool = False,
               layers: int | None = None,
               requests: int = SMALL_MODEL_REQUESTS,
               prefill_bits: bool = False) -> None:
    """One of the configs added after smollm-360m at full width (bf16,
    random weights from a seed; the only model on the card while it runs;
    ``layers`` cuts the depth, printed on the ``init`` line):
    ``lm.prefill`` on [4, 256] against the all-plain path (``phase_prefill``
    with the fp32 rule), ``requests`` requests through ``serve_modes``
    (graph, eager and host, greedy and at temperature 1.0), the paged
    layout at page size 16, then ``phase_profile`` of the dense loop, one
    graph and one eager turn.  Prints the init time and the peak allocated
    and reserved memory, and frees the model.

    ``paged``: None, no paged run; "graph", the default pool in graph
    mode; "modes", the default pool through ``serve_modes``.
    ``small_pool``: also a 64-page pool in graph mode, which must preempt;
    every request must finish and every page come back (``serve``).  The
    paged runs' greedy tokens must equal the dense run's, except for an
    MoE model's preempting pool, where the line reports how many requests
    differ: the expert capacity couples the rows of one prefill chunk,
    idle slots' rows included, and preemption changes which slots share a
    chunk, so an assignment may be dropped in one run and kept in the
    other (the JAX engine's tokens differ alike between layouts and modes
    under capacity drops, ``serve_modes``).  An MLA model's decode and chunked
    prefill launch no kernel (the absorbed attention is torch ops, as the
    reference's einsums are), so its serving runs count none.
    ``prefill_bits``: first hold one prefill pump's cache through the
    graph to the eager body's, dense and paged (``check_prefill_bits``)."""
    import gc

    from repro_torch.models.params import tree_leaves

    cfg, cut = cut_config(arch, layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, gen, DEVICE)
    torch.cuda.synchronize()
    emit({"phase": "init", "arch": arch, "seconds": time.perf_counter() - t0,
          **arch_line(cfg, cut), **memory_gib()})
    phase_prefill(cfg, params, lm, ops, ref, fa, fp32_rule=True)
    if prefill_bits:
        check_prefill_bits(cfg, params, DecodeEngine, Request, arch)
        check_prefill_bits(cfg, params, DecodeEngine, Request,
                           f"{arch} paged", kv_layout="paged", page_size=16)
    prompts = prompts_for(cfg, seed=2, n=requests)
    mla = cfg.attention_kind == "mla"
    dense = serve_modes(cfg, params, DecodeEngine, Request, prompts,
                        None if mla else da.decode_attention, arch)
    counter = None if mla else da.decode_attention_paged
    runs = {}
    if paged == "modes":
        runs["paged"] = serve_modes(cfg, params, DecodeEngine, Request,
                                    prompts, counter, f"{arch} paged",
                                    kv_layout="paged", page_size=16)
    elif paged == "graph":
        runs["paged"] = serve(cfg, params, DecodeEngine, Request, prompts,
                              counter, f"{arch} paged", "graph",
                              kv_layout="paged", page_size=16)[0]
    if small_pool:
        got, stats = serve(cfg, params, DecodeEngine, Request, prompts,
                           counter, f"{arch} paged_small_pool", "graph",
                           kv_layout="paged", page_size=16, num_pages=64)
        if stats["preemptions"] < 1:
            raise AssertionError(f"{arch} small pool: no preemption {stats}")
        runs["paged_small_pool"] = got
    if runs:
        gated = [k for k in runs
                 if cfg.moe is None or k != "paged_small_pool"]
        emit({"phase": "serve", "path": f"{arch} paged",
              "requests_differing_from_dense": {
                  k: len(differ(v, dense)) for k, v in runs.items()},
              "held_to_dense": gated,
              "reported_only": [k for k in runs if k not in gated]})
        for label in gated:
            got = runs[label]
            if got != dense:
                raise AssertionError(f"{arch} {label}: tokens differ from "
                                     f"dense for requests {differ(got, dense)}")
    phase_profile(cfg, params, DecodeEngine, Request, arch)
    emit({"phase": "memory", "arch": arch,
          "weights_gib": nbytes(*tree_leaves(params)) / 2**30,
          **memory_gib()})
    del params
    gc.collect()
    torch.cuda.empty_cache()


def tree_distance(a, b) -> float:
    """||a - b|| / ||b|| over every leaf of two parameter trees (on the
    host), 2**26 elements at a time: a jamba-v0.1-52b expert stack is 3.76
    G elements, 15 GB for each fp32 temporary of it."""
    from repro_torch.models.params import tree_leaves

    num = den = 0.0
    n = 2**26
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        x, y = x.reshape(-1), y.reshape(-1)
        for i in range(0, y.numel(), n):
            yf = y[i:i + n].float()
            num += float((x[i:i + n].float() - yf).square().sum())
            den += float(yf.square().sum())
    return math.sqrt(num / den)


def host_available_gib() -> float:
    """The host's available memory (``MemAvailable``), GiB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


def token_nll(lm, cfg, params, batch):
    """Per-position next-token losses [B, S-1] ([B, S-1, cb] with
    codebooks), fp32, of the model's forward on ``batch`` (its image
    embeds merged; the terms ``lm.train_loss`` averages), 512 positions of
    logits at a time."""
    from repro_torch.models.layers import rmsnorm

    tokens = batch["tokens"]
    S = tokens.shape[1]
    h = lm.embed_tokens(cfg, params, tokens, batch)
    h, _, _ = lm.backbone(cfg, params, h,
                          torch.arange(S, device=tokens.device)[None])
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)[:, :-1]
    out = []
    for i in range(0, S - 1, 512):
        logits = lm.apply_head(cfg, params, h[:, i:i + 512]).float()
        tgt = tokens[:, i + 1:i + 513].long()
        out.append(torch.logsumexp(logits, dim=-1)
                   - logits.gather(-1, tgt[..., None])[..., 0])
    return torch.cat(out, dim=1)


# the train paths' kernel families: each one's kernels by the profiler's
# kernel name, and the kernel that each wrapper call (the forward and the
# backward wrapper) launches exactly once, by its bare profiler name
TRAIN_FAMILIES = {
    "flash": {"kernels": {"flash_fwd": lambda k: "flash_tc" in k,
                          "flash_bwd": lambda k: kernel_name(k).startswith(
                              ("bwd_", "dsum"))},
              "markers": ("flash_tc_kernel", "bwd_dq_wgmma")},
    "ssd": {"kernels": {"ssd_fwd": lambda k: kernel_name(k) in (
                            "ssd_states_tc", "ssd_state_pass", "ssd_scan_tc"),
                        "ssd_bwd": lambda k: "ssd_bwd_" in k},
            "markers": ("ssd_scan_tc", "ssd_bwd_reduce")},
}
TRAIN_STEPS = 8         # a warm-up, a capture, 4 timed steps, 2 profiled
# the turns of every train path: one of each mode, to keep the script
# inside its time limit (smollm-360m and mamba2-130m ran graph, eager,
# eager, graph until the tune phase joined the run)
TRAIN_TURNS = ("graph", "eager")
# the three dense configs trained at full width: (arch, layers kept, the
# memory plan); each is cut in depth for the run's time, the full depth's
# step estimated on meta by ``phase_memory_plans``
TRAIN_DENSE = (
    ("qwen3-4b", 2,
     "AdamW, 2 of 36 layers (cut for the run's time): 0.98 B params at 16 "
     "bytes (bf16 params and grads, fp32 master, m, v) ~15.7 GB; at full "
     "depth 4.41 B params, ~70.6 GB; the full depth's step estimated on "
     "meta (remat): 85.8 GiB with AdamW, 36.5 GiB with Adafactor, against "
     "the card's 79.2"),
    ("chatglm3-6b", 2,
     "AdamW, 2 of 28 layers (cut for the run's time): 0.94 B params at 16 "
     "bytes ~15.0 GB; at full depth 6.24 B params, ~99.9 GB; the full "
     "depth's step estimated on meta (remat): 128.1 GiB with AdamW, 58.4 "
     "GiB with Adafactor"),
    ("granite-20b", 2,
     "AdamW, 2 of 52 layers (cut for the run's time): 1.36 B params at 16 "
     "bytes ~21.8 GB; at full depth 20.3 B params, ~325 GB, its bf16 "
     "params and grads alone 81.3 GB; the full depth's step estimated on "
     "meta (remat): 478.2 GiB with AdamW, 142.6 GiB with Adafactor: no "
     "optimizer fits one card"),
)


@contextlib.contextmanager
def train_steps(mode: str, made: list):
    """``run_training`` with each ``GraphedStep`` it makes appended to
    ``made``; in mode "eager" every step runs the step's body eagerly on
    the graph's input buffers, as the graph's warm-up runs the first (the
    port has no such switch)."""
    from repro_torch.train.train_step import GraphedStep

    init, call = GraphedStep.__init__, GraphedStep.__call__

    def recording(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    def eager(self, batch, step):
        with torch.cuda.device(self.device):
            self._push(batch, step)
            return self._body()

    GraphedStep.__init__ = recording
    if mode == "eager":
        GraphedStep.__call__ = eager
    try:
        yield
    finally:
        GraphedStep.__init__, GraphedStep.__call__ = init, call


def train_turn(cfg, dc, mode: str, kernels: dict,
               optimizer: str) -> tuple[dict, dict]:
    """One ``run_training`` of ``TRAIN_STEPS`` steps (``optimizer``, remat,
    warmup 1, a log line each step, which waits for the device) in ``mode``
    "graph" (the port's own path: a warm-up step, one capture, a replay per
    later step) or "eager" (the same body run eagerly every step), through
    ``kernels`` ({family of ``TRAIN_FAMILIES``: (forward, backward
    wrapper)}).  Wall
    ms of each step from the host's clock at each log line, peak allocated
    and reserved memory of each step; steps 2-5 are timed without the
    profiler, steps 6-7 profiled (device busy ms, CUDA runtime calls and
    the families' marker kernels per step).  Returns the turn's
    row and its final params, on the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.params import tree_map
    from repro_torch.train.loop import TrainJob, run_training

    steps = TRAIN_STEPS
    marks, made = [], []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def log(line):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), torch.cuda.max_memory_allocated(),
                      torch.cuda.max_memory_reserved()))
        torch.cuda.reset_peak_memory_stats()
        if len(marks) == steps - 2:
            prof.start()
        elif len(marks) == steps:
            prof.stop()

    job = TrainJob(total_steps=steps, warmup=1, log_every=1, remat=True,
                   optimizer=optimizer)
    wrappers = [w for pair in kernels.values() for w in pair]
    before = [w.launches for w in wrappers]
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with train_steps(mode, made):
        hist, final, params = run_training(cfg, dc, job, device=DEVICE,
                                           log=log)
    counts = {f"{w.__name__}_launches": w.launches - n
              for w, n in zip(wrappers, before, strict=True)}
    params = tree_map(lambda t: t.cpu(), params)
    walls = [(m[0] - p[0]) * 1e3 for p, m in zip([(t0,)] + marks, marks,
                                                 strict=False)]
    events = prof.key_averages()
    device = _device_events(prof)
    dev = {}
    for e in device:
        dev[e.key[:60]] = dev.get(e.key[:60], 0.0) + _dev_us(e) / 1e3 / 2
    parts = {label: {kernel_name(k): v for k, v in dev.items() if hit(k)}
             for family in kernels
             for label, hit in TRAIN_FAMILIES[family]["kernels"].items()}
    runtime = {e.key: e.count / 2 for e in events
               if e.device_type == DeviceType.CPU and e.key.startswith("cu")}
    markers = {m: sum(e.count for e in device if kernel_name(e.key) == m) / 2
               for family in kernels
               for m in TRAIN_FAMILIES[family]["markers"]}
    B, S = dc.batch_size, dc.seq_len
    wall = sum(walls[2:steps - 2]) / (steps - 4)
    busy = sum(dev.values())
    run = made[0]
    row = {"phase": "train", "arch": cfg.name, "mode": mode, "batch": [B, S],
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "optimizer": optimizer, "remat": True,
           "steps": final,
           "per_step": [{"step": h["step"], "loss": h["loss"],
                         "grad_norm": h["grad_norm"], "lr": h["lr"],
                         "wall_ms": w, "peak_alloc_gib": m[1] / 2**30,
                         "peak_reserved_gib": m[2] / 2**30}
                        for h, w, m in zip(hist, walls, marks, strict=True)],
           "first_step_includes": "parameter and optimizer init",
           "second_step_includes": "the capture" if mode == "graph" else "",
           **counts,
           "wall_ms_per_step": wall,
           "device_ms_per_step": busy,
           "device_idle_share": 1 - busy / wall,
           "tokens_per_s": B * S * 1e3 / wall,
           "peak_alloc_gib": max(m[1] for m in marks[2:]) / 2**30,
           "peak_reserved_gib": max(m[2] for m in marks[2:]) / 2**30,
           "graph": dict(run.stats, graph_pool_mib=run.stats[
               "graph_pool_bytes"] / 2**20),
           "graph_launch_calls_per_step": sum(
               n for k, n in runtime.items() if "GraphLaunch" in k),
           "kernel_launch_calls_per_step": sum(
               n for k, n in runtime.items()
               if "Launch" in k and "GraphLaunch" not in k),
           "runtime_calls_per_step": runtime,
           "per_replay": {w.__name__: n for w, n in run.per_replay.items()},
           "marker_kernels_per_step": markers,
           "kernel_device_ms_per_step": parts,
           **{f"{label}_device_ms_per_step": sum(p.values())
              for label, p in parts.items()},
           "gemm_device_ms_per_step": sum(v for k, v in dev.items()
                                          if is_gemm(k)),
           "top_device_ms_per_step": sorted(dev.items(),
                                            key=lambda kv: -kv[1])[:12]}
    emit(row)
    return row, params


def train_launches(cfg) -> dict:
    """{family: (forward, backward) kernel launches of one train step}: 2
    forward and 1 backward a backbone layer of the family's mixer (remat
    runs each layer's forward again; attention and MLA layers take the
    flash kernels, Mamba layers, a hybrid's among them, the SSD scan),
    and 1 flash launch of each an MTP block, which runs outside remat, as
    in the reference."""
    from repro_torch.models import lm

    mixers = []
    for seg in lm.segments(cfg):
        mixers += seg.count * ([m for _, _, m, _ in seg.plan.entries]
                               if seg.kind == "hybrid" else [seg.mixer])
    ssm = mixers.count("mamba")
    attn = len(mixers) - ssm
    out = {}
    if attn or cfg.mtp_depth:
        out["flash"] = (2 * attn + cfg.mtp_depth, attn + cfg.mtp_depth)
    if ssm:
        out["ssd"] = (2 * ssm, ssm)
    return out


def check_turn(row: dict, cfg, kernels: dict) -> None:
    """A train turn's launch counts per step of each family's forward and
    backward wrapper (``train_launches``), finite losses and grad norms
    and, for the graph, one capture, a replay a step after the first, one
    ``cudaGraphLaunch`` and at most one kernel launch (the step counter's
    fill) per steady step."""
    steps, mode = row["steps"], row["mode"]
    want = {w.__name__: n for family, pair in kernels.items()
            for w, n in zip(pair, train_launches(cfg)[family], strict=True)}
    got = {name: row[f"{name}_launches"] / steps for name in want}
    if got != want or set(kernels) != set(train_launches(cfg)):
        raise AssertionError(f"train {cfg.name} {mode}: launches a step "
                             f"{got}, want {want}")
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in row["per_step"]):
        raise AssertionError(f"train: non-finite loss or grad norm {row}")
    graph = row["graph"]
    if mode == "graph" and (
            graph["captures"] != 1 or graph["replays"] != steps - 1
            or row["per_replay"] != want
            or row["graph_launch_calls_per_step"] != 1
            or row["kernel_launch_calls_per_step"] > 1):
        raise AssertionError(f"train {cfg.name} graph: {graph}, per replay "
                             f"{row['per_replay']}, runtime calls per step "
                             f"{row['runtime_calls_per_step']}")


def same_bits(a, b) -> bool:
    from repro_torch.models.params import tree_leaves

    return all(torch.equal(x, y) for x, y in zip(
        tree_leaves(a), tree_leaves(b), strict=True))


def arch_line(cfg, cut: dict) -> dict:
    """A config's shape for an ``init`` line, with the cut of its depth."""
    from repro_torch.models import lm
    from repro_torch.models.params import param_count

    return {"params": param_count(lm.make_lm(cfg)),
            "layers": cfg.num_layers, **cut, "d_model": cfg.d_model,
            "heads": [cfg.num_heads, cfg.num_kv_heads],
            "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
            "vocab": cfg.vocab_size,
            "segments": [[g.count, g.mixer, g.ffn] if g.kind == "blocks"
                         else [g.count, "super-block", [
                             f"{m}_{f}" for _, _, m, f in g.plan.entries]]
                         for g in lm.segments(cfg)],
            "ssm": None if cfg.ssm is None else [
                cfg.ssm.n_heads(cfg.d_model), cfg.ssm.head_dim,
                cfg.ssm.d_state, cfg.ssm.chunk],
            "moe": None if cfg.moe is None else [
                cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_ff_expert,
                cfg.moe.num_shared_experts, cfg.moe.scoring,
                cfg.moe.capacity_factor],
            "mla": None if cfg.mla is None else [
                cfg.mla.q_lora_rank, cfg.mla.kv_lora_rank,
                cfg.mla.qk_nope_head_dim, cfg.mla.qk_rope_head_dim,
                cfg.mla.v_head_dim],
            "mtp_depth": cfg.mtp_depth, "codebooks": cfg.num_codebooks,
            "image_tokens": cfg.num_image_tokens}


def cut_config(arch: str, layers: int | None):
    """(the published config, cut to ``layers`` if given; the cut, for the
    ``init`` line).  Where ``layers`` is below an MoE config's leading
    dense layers, those are cut too (deepseek-v3-671b's 3: its MoE stack
    is then empty).  A hybrid's super-block shorter than the published
    one is the published block's ``layers`` positions from its attention
    layer on (jamba-v0.1-52b's attention at position 4, even, so the MoE
    layers stay on the odd positions): one super-block."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if layers is None:
        return cfg, {}
    cut = cfg.replace(num_layers=layers)
    text = f"num_layers {cfg.num_layers} -> {layers}"
    hb, at = cfg.hybrid_block, cfg.hybrid_attn_index
    if hb and layers < hb:
        cut = cut.replace(hybrid_block=layers, hybrid_attn_index=0)
        text += (f", hybrid_block {hb} -> {layers}, hybrid_attn_index {at}"
                 f" -> 0: the published super-block's positions {at}-"
                 f"{at + layers - 1}")
    if cfg.moe is not None and cfg.moe.first_k_dense > layers:
        cut = cut.replace(moe=dataclasses.replace(cfg.moe,
                                                  first_k_dense=layers))
        text += f", first_k_dense {cfg.moe.first_k_dense} -> {layers}"
    return cut, {"published_layers": cfg.num_layers, "cut": text}


def meta_peak_gib(cfg, optimizer: str, remat: str = "dots",
                  batch: tuple[int, int] = (2, 4096)) -> float:
    """The estimated peak of one train step of ``cfg`` at ``batch`` (B, S),
    GiB: ``launch/dryrun.py::lower`` traces it on the ``meta`` device (no
    memory) and reads the peak of live tensor bytes, the inputs (params,
    optimizer state, batch) included; ``remat`` "dots" (the port's policy)
    or "none"."""
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch.dryrun import lower, parse_variant

    v = parse_variant([f"optimizer={optimizer}", f"remat={remat}"])
    shape = ShapeConfig(f"train_{batch[0]}x{batch[1]}", batch[1], batch[0],
                        "train")
    return lower(cfg, shape, v)["peak_estimate_bytes"] / 2**30


def phase_memory_plans(archs: tuple | None = None) -> dict:
    """Each config's full-depth train step at [2, 4096] on ``meta``
    (``meta_peak_gib``), with AdamW and Adafactor, remat on and off: a
    ``memory_plan`` line a config (by default ``TRAIN_DENSE``'s), beside
    the card's memory.  Not part of the run (~40 s of tracing); a dev
    script calls it alone."""
    from repro_torch.configs import get_config

    archs = archs or tuple(a for a, _, _ in TRAIN_DENSE)
    card = torch.cuda.get_device_properties(0).total_memory / 2**30
    out = {}
    for arch in archs:
        cfg = get_config(arch)
        t0 = time.perf_counter()
        out[arch] = {f"{opt}, remat {remat}": meta_peak_gib(cfg, opt, remat)
                     for opt in ("adamw", "adafactor")
                     for remat in ("dots", "none")}
        emit({"phase": "memory_plan", "arch": arch, "batch": [2, 4096],
              "layers": cfg.num_layers, "peak_estimate_gib": out[arch],
              "card_gib": card, "seconds": time.perf_counter() - t0})
    return out


def phase_train(lm, arch: str, kernels: dict, plain_path, *,
                layers: int | None = None, optimizer: str = "adamw",
                turns: tuple = TRAIN_TURNS,
                paths_batch: tuple[int, int] = (2, 4096),
                memory: str | None = None,
                frozen: str | None = None, plan: bool = False) -> None:
    """Full-width training of ``arch`` (smollm-360m: 32 layers, d 960,
    vocab 49152, through the flash kernels; mamba2-130m: 24 layers, d 768,
    vocab 50280, through the SSD scan kernels; olmoe-1b-7b and
    deepseek-v3-671b through the flash kernels, the second at (D, Dv) =
    (192, 128); musicgen-medium's 4 codebooks, and phi-3-vision-4.2b's 576
    image rows of every sequence, at (96, 96); jamba-v0.1-52b's super-block
    through both: flash at (128, 128) with G 4 in its attention layer, the
    SSD scan at (64, 16) in its Mamba layers (5 of the 6 the run trains,
    the published pattern's positions 4-9); qwen3-4b's q/k norms,
    chatglm3-6b's half-width interleaved RoPE at G 16 and granite-20b's
    GELU MLP at G 48, through the flash kernels at (128, 128)), ``layers``
    cutting the depth (printed on the ``init`` line, with the ``memory`` plan and the
    host's available memory), bf16 params from a seed, ``optimizer``, remat
    on:
    ``run_training`` on ``batch_at`` data at [2, 4096] (the repo's
    train_4k sequence length as a one-chip micro-batch), as ``train_turn``
    runs it, in ``turns`` (graph and eager) from the same seed, through
    ``kernels`` ({family of ``TRAIN_FAMILIES``: (forward, backward
    wrapper)}).  Each turn: per step the launches of ``train_launches``
    (2 of a family's forward kernel and 1 of its backward per layer of its
    mixer, as remat keeps only the projections and runs each layer's
    forward again, and 1 flash launch of each per MTP block), losses and
    grad norms finite; a graph turn makes one capture, replays once a step
    (one ``cudaGraphLaunch`` per steady step and at most one kernel
    launch, the step counter's fill), and each replay's launches of every
    wrapper are held against the profiler's marker kernels of the profiled
    replays (it may lose an event but never adds one: no turn sees more,
    one turn sees exactly the count).  The graph's final params must equal
    the eager body's bit for bit (or, with two eager turns that differ, be
    no further from an eager turn than the eager turns are from each
    other).  Then ``phase_remat`` and ``train_step_paths`` (``frozen``:
    its leaves held out) at ``paths_batch``.  With ``plan`` the ``init``
    line also gives the cut config's step peak estimated on ``meta``
    (``meta_peak_gib``), which the turns' peaks are read against."""
    from repro_torch.data.synthetic import batch_at, data_config_for
    from repro_torch.train.optimizer import get_optimizer
    from repro_torch.train.schedule import warmup_cosine

    cfg, cut = cut_config(arch, layers)
    emit({"phase": "init", "arch": arch, "what": "train", **arch_line(cfg, cut),
          "optimizer": optimizer, "memory_plan": memory,
          **({"meta_peak_estimate_gib": meta_peak_gib(cfg, optimizer)}
             if plan else {}),
          "host_available_gib": host_available_gib()})
    B, S, steps = 2, 4096, TRAIN_STEPS
    dc = data_config_for(cfg, seq_len=S, batch_size=B)
    rows, finals = {"graph": [], "eager": []}, {"graph": [], "eager": []}
    for mode in turns:
        row, params = train_turn(cfg, dc, mode, kernels, optimizer)
        check_turn(row, cfg, kernels)
        rows[mode].append(row)
        finals[mode].append(params)
    seen = [r["marker_kernels_per_step"] for r in rows["graph"]]
    want = {m: n for family, counts in train_launches(cfg).items()
            for m, n in zip(TRAIN_FAMILIES[family]["markers"], counts,
                            strict=True)}
    eager_equal = (len(finals["eager"]) == 1
                   or same_bits(*finals["eager"]))
    graph_equal = all(same_bits(g, e) for g in finals["graph"]
                      for e in finals["eager"])
    eager_gap = (0.0 if eager_equal else tree_distance(*finals["eager"]))
    graph_gap = (0.0 if graph_equal else
                 max(tree_distance(g, e) for g in finals["graph"]
                     for e in finals["eager"]))
    keys = ("wall_ms_per_step", "device_ms_per_step", "device_idle_share",
            "tokens_per_s", "peak_alloc_gib", "peak_reserved_gib",
            "graph_launch_calls_per_step", "kernel_launch_calls_per_step")
    mean = {mode: {k: sum(r[k] for r in rs) / len(rs) for k in keys}
            for mode, rs in rows.items()}
    mean["graph"]["capture_ms"] = [r["graph"]["capture_ms"]
                                   for r in rows["graph"]]
    mean["graph"]["graph_pool_mib"] = [r["graph"]["graph_pool_mib"]
                                       for r in rows["graph"]]
    emit({"phase": "train_summary", "arch": arch, "batch": [B, S],
          "layers": cfg.num_layers, "optimizer": optimizer, "steps": steps,
          "turns": list(turns), **mean,
          "eager_over_graph_wall": mean["eager"]["wall_ms_per_step"]
          / mean["graph"]["wall_ms_per_step"],
          "graph_wall_over_device": mean["graph"]["wall_ms_per_step"]
          / mean["graph"]["device_ms_per_step"],
          "marker_kernels_per_step": {"counted": want, "profiled": seen},
          "final_params_graph_equal_eager": graph_equal,
          "final_params_eager_equal_eager": eager_equal,
          "distance_graph_eager": graph_gap,
          "distance_eager_eager": eager_gap})
    if any(d[m] > n for d in seen for m, n in want.items()) or not any(
            d == want for d in seen):
        raise AssertionError(f"train {arch}: marker kernels per replay "
                             f"{seen}, counted {want}")
    if not (graph_equal if eager_equal else graph_gap <= eager_gap):
        raise AssertionError(f"train {arch}: graph params {graph_gap} from "
                             f"eager's, eager turns {eager_gap} apart")
    del finals
    torch.cuda.empty_cache()

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    params = lm.init_lm(cfg, gen, DEVICE)
    dc = data_config_for(cfg, seq_len=paths_batch[1],
                         batch_size=paths_batch[0])
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in batch_at(dc, 0).items()}
    phase_remat(lm, cfg, params, batch, [f for f, _ in kernels.values()])
    train_step_paths(lm, cfg, params, batch, get_optimizer(optimizer),
                     warmup_cosine(3e-4, 1, steps), plain_path, frozen)
    del params, batch
    torch.cuda.empty_cache()


def routed_at(cfg, p, x2d, ids):
    """``moe._route`` with its top-k replaced by ``ids``: the weights and
    the aux loss from this call's own scores at those experts, by
    ``_route``'s ops."""
    m = cfg.moe
    idx = ids.long()
    logits = x2d.float() @ p["router"]
    if m.scoring == "sigmoid":
        scores = torch.sigmoid(logits)
        w = scores.gather(1, idx)
        w = w / (w.sum(dim=1, keepdim=True) + 1e-20)
        probs = scores / (scores.sum(dim=1, keepdim=True) + 1e-20)
    else:
        probs = torch.softmax(logits, dim=-1)
        w = probs.gather(1, idx)
    T = x2d.shape[0]
    ones = torch.full((T * m.top_k,), 1.0 / (T * m.top_k),
                      dtype=torch.float32, device=x2d.device)
    frac_tokens = torch.zeros(m.num_experts, dtype=torch.float32,
                              device=x2d.device).index_add_(
                                  0, idx.reshape(-1), ones)
    aux = m.num_experts * (frac_tokens * probs.mean(dim=0)).sum()
    return w, ids, aux


@contextlib.contextmanager
def pinned_routing(log: list, differ: list | None):
    """The three-path step's routing (the comparison runs only): with
    ``differ`` None each ``moe._route`` call runs as it is and appends its
    expert ids to ``log`` (the fp32 path); otherwise each call takes the
    next ids of ``log`` in place of its own top-k (``routed_at``), so a
    bf16 path dispatches exactly as the fp32 path did, and appends to
    ``differ`` how many of its own (token, slot) picks differ from them,
    in how many tokens, in how many tokens its set of experts differs, and
    the call's assignments and tokens."""
    from repro_torch.models import moe

    route, calls = moe._route, iter(list(log))

    def recording(cfg, p, x2d):
        w, ids, aux = route(cfg, p, x2d)
        log.append(ids)
        return w, ids, aux

    def replaying(cfg, p, x2d):
        ids = next(calls)
        with torch.no_grad():
            own = route(cfg, p, x2d)[1]
        other_set = (own.sort(-1).values != ids.sort(-1).values).any(-1)
        differ.append((int((own != ids).sum()),
                       int((own != ids).any(-1).sum()), int(other_set.sum()),
                       ids.numel(), ids.shape[0]))
        return routed_at(cfg, p, x2d, ids)

    moe._route = recording if differ is None else replaying
    try:
        yield
    finally:
        moe._route = route


def leaf_paths(tree, prefix: str = "") -> list:
    """The paths of a tree's leaves ("segments/0/mamba_moe/ffn/wi"), in
    ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in leaf_paths(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in leaf_paths(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def move_tree_(tree, device) -> None:
    """Every leaf of ``tree`` (dicts and lists) to ``device``, in place:
    the containers stay, so whoever holds the tree sees the moved leaves
    and the old copies are freed."""
    for k, v in list(tree.items() if isinstance(tree, dict)
                     else enumerate(tree)):
        if isinstance(v, (dict, list)):
            move_tree_(v, device)
        else:
            tree[k] = v.to(device)


def train_step_paths(lm, cfg, params, batch, opt, lr_fn, plain_path,
                     frozen: str | None = None) -> None:
    """One train step (step 1, lr > 0) from the same bf16 weights
    ``params`` and ``batch`` on three paths: the plain versions of the
    kernels (``plain_path()``) on the weights cast to fp32, the kernel
    path in bf16 and the plain path in bf16.  For an MoE model each bf16
    path replays the fp32 path's expert ids (``pinned_routing``; how many
    of its own picks differ is printed), so the three dispatch alike and
    a routing flip does not stand in for the kernels' error.  The kernel
    path's per-token losses, gradients, updated params and update (of the
    fp32 master weights with AdamW, of the params with Adafactor, which
    keeps none) may be no further from the fp32 path's than twice the
    bf16 plain path's, each distance ||a - b|| / ||b|| over all its
    elements.  The mean loss and the grad norm are printed beside them:
    each is one number, and two bf16 paths land at a distance from fp32
    that is noise (on an H100 smollm-360m's bf16 plain path's mean loss
    came 4.8e-6 from fp32, the kernel path's 9.6e-5, both under 1e-5 of
    the loss), so a bound of 2x between two single draws says little; the
    per-token losses and the gradients hold the same quantities element
    by element.

    ``frozen`` (a regular expression over leaf paths) holds those leaves
    constant in all three paths: no gradient and no update (the step is
    ``make_train_step``'s body over the other leaves: their loss, clip by
    their global norm and optimizer update), so no distance covers them;
    the line names them.  jamba-v0.1-52b's expert stacks are held so:
    their products are cuBLAS's batched ones, not a kernel of the port,
    and their gradients are held by the CPU parity against JAX and by the
    train turns' graph == eager bit for bit.

    Memory: the fp32 path steps its weights in place, its gradients wait
    on the host, and each bf16 path is compared leaf by leaf as it ends,
    so at most the bf16 weights, the fp32 path's new weights (and master
    update) and one path's step are on the card (deepseek-v3-671b's 4.3 B
    parameters are 17 GB in fp32).  With frozen leaves the bf16 weights
    also wait on the host while the fp32 path runs (jamba's 13.27 B
    parameters are 53 GB in fp32 beside 26.5 GB in bf16), and a bf16 path
    steps a copy of the other leaves only."""
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.train.optimizer import clip_by_global_norm
    from repro_torch.train.train_step import make_train_step

    step_fn = make_train_step(cfg, opt, lr_fn, remat=True)
    paths = leaf_paths(params)
    held_out = [p for p in paths if frozen and re.search(frozen, p)]
    held = [i for i, p in enumerate(paths) if p not in held_out]

    def loss_and_grads(p):
        """The remat loss of ``p`` and the gradients of its leaves but the
        held-out ones (zeros where none reaches a leaf, as the train step
        takes them)."""
        leaves = tree_map(lambda t: t.detach(), p)
        flat = tree_leaves(leaves)
        for i in held:
            flat[i].requires_grad_()
        loss = lm.train_loss(cfg, leaves, batch, remat=True)[0]
        loss.backward()
        return loss.detach(), [torch.zeros_like(flat[i]) if flat[i].grad
                               is None else flat[i].grad for i in held]

    def grads_and_nll(p):
        grads = loss_and_grads(p)[1]
        with torch.no_grad():
            nll = token_nll(lm, cfg, p, batch)
        return grads, nll

    def held_out_step(p):
        """``make_train_step``'s body with the ``frozen`` leaves held
        constant: (the state of the other leaves, loss, grad norm)."""
        loss, grads = loss_and_grads(p)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        own = [tree_leaves(p)[i] for i in held]
        state = opt.init(own)
        opt.update(grads, state, own, lr_fn(torch.ones(
            (), dtype=torch.int32, device=DEVICE)))
        return state, float(loss), float(gnorm)

    update_of = "params"

    def step(p):
        """Step ``p`` in place: (its new leaves, the updated leaves, the
        step's loss and grad norm), the held-out leaves left out."""
        nonlocal update_of
        if held_out:
            state, loss, gnorm = held_out_step(p)
        else:
            state = opt.init(p)
            _, state, m = step_fn(p, state, batch, 1)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        new = [tree_leaves(p)[i] for i in held]
        if "master" in state:
            update_of = "master"
            return new, tree_leaves(state["master"]), loss, gnorm
        return new, new, loss, gnorm

    def copy_held(p):
        """``p`` with every leaf but the held-out ones cloned."""
        flat = tree_leaves(p)
        out = [t.clone() if i in held else t for i, t in enumerate(flat)]
        it = iter(out)
        return tree_map(lambda _: next(it), p)

    def dist(pairs) -> float:
        num = den = 0.0
        for a, b, base in pairs:
            b = b.to(DEVICE).float()
            num += float((a.float() - b).square().sum())
            den += float((b if base is None else b - base.float())
                         .square().sum())
        return math.sqrt(num / den)

    log, differ = [], {"kernel_bf16": [], "plain_bf16": []}
    if held_out:        # the bf16 weights wait on the host
        move_tree_(params, "cpu")
        torch.cuda.empty_cache()
        p32 = tree_map(lambda t: t.to(DEVICE, torch.float32), params)
    else:
        # a copy of every leaf, fp32 ones too (the router, Mamba's A_log):
        # the fp32 path's step updates it in place
        p32 = tree_map(lambda t: t.to(torch.float32, copy=True), params)
    with plain_path(), pinned_routing(log, None):
        g32, nll32 = grads_and_nll(p32)
        g32 = [g.cpu() for g in g32]
        torch.cuda.empty_cache()
        new32, upd32, loss32, gn32 = step(p32)
    del p32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    if held_out:
        move_tree_(params, DEVICE)
    old = [tree_leaves(params)[i] for i in held]
    got, scalars = {}, {}
    for name, ctx in (("kernel_bf16", contextlib.nullcontext()),
                      ("plain_bf16", plain_path())):
        with ctx, pinned_routing(log, differ[name]):
            g, nll = grads_and_nll(params)
            got.setdefault("token_losses", []).append(
                dist([(nll, nll32, None)]))
            got.setdefault("grads", []).append(
                dist(zip(g, g32, [None] * len(g), strict=True)))
            del g
            torch.cuda.empty_cache()
            new, upd, loss, gn = step(copy_held(params))
        got.setdefault("params", []).append(
            dist(zip(new, new32, [None] * len(new), strict=True)))
        got.setdefault("update", []).append(
            dist(zip(upd, upd32, old, strict=True)))
        scalars[name] = (loss, gn)
        del new, upd
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    del g32, new32, upd32
    torch.cuda.empty_cache()
    (lk, gk), (lp, gp) = scalars["kernel_bf16"], scalars["plain_bf16"]
    emit({"phase": "train_step_paths", "arch": cfg.name,
          "layers": cfg.num_layers, "batch": list(batch["tokens"].shape),
          "optimizer": type(opt).__name__, "step": 1,
          "loss": {"kernel_bf16": lk, "plain_bf16": lp, "plain_fp32": loss32},
          "grad_norm": {"kernel_bf16": gk, "plain_bf16": gp,
                        "plain_fp32": gn32},
          "distance_from_fp32_kernel_vs_plain": got,
          "update_of": update_of,
          "held_out": {"leaves": held_out, "params": sum(
              tree_leaves(params)[i].numel() for i, p in enumerate(paths)
              if p in held_out), "why": "constants in all three paths: "
              "cuBLAS's batched products, no kernel of the port"}
          if held_out else None,
          "distance": "||a - b|| / ||b|| over all elements",
          "scalar_distance_from_fp32_kernel_vs_plain": {
              "loss": [abs(lk - loss32), abs(lp - loss32)],
              "grad_norm": [abs(gk - gn32), abs(gp - gn32)]},
          "routing_pinned_to_fp32": {
              name: None if not d else {
                  "calls": len(d),
                  "own_picks_differ": sum(x[0] for x in d),
                  "own_tokens_differ": sum(x[1] for x in d),
                  "own_expert_sets_differ": sum(x[2] for x in d),
                  "own_expert_sets_differ_by_call": [x[2] for x in d],
                  "assignments": sum(x[3] for x in d),
                  "tokens": sum(x[4] for x in d)}
              for name, d in differ.items()},
          "bound": "kernel path within 2x the bf16 plain path's distance"})
    for what, (k_off, p_off) in got.items():
        if not k_off <= 2 * p_off:
            raise AssertionError(f"train step {cfg.name} {what}: kernel "
                                 f"path {k_off} from fp32, bf16 plain path "
                                 f"{p_off}")


class CountProducts(TorchDispatchMode):
    """Counts the matrix products (``mm``, ``addmm``, ``bmm``, ``baddbmm``)
    dispatched while it is active, and apart the batched ones."""

    BATCHED = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)
    PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                *BATCHED)

    def __init__(self):
        super().__init__()
        self.n = self.batched = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in self.PRODUCTS
        self.batched += func in self.BATCHED
        return func(*args, **(kwargs or {}))


def phase_remat(lm, cfg, params, batch, fwds: list) -> None:
    """Remat against none on one loss-and-gradient pass at full width: the
    selective policy saves the products with no batch dims (``mm``,
    ``addmm``: the projections), so the backward with remat dispatches as
    many of them as without it, and reruns at most the batched products of
    the layers' forward (``bmm``, ``baddbmm``: the MoE experts'; a dense
    or Mamba model has none on the kernel path), as JAX's policy does;
    counted by ``CountProducts`` (the profiler's GEMM launches and ms are
    printed beside them, and lose an event now and then).  The forward
    kernels ``fwds`` (flash attention, the SSD scan, whose state scratch
    the recompute makes anew for each layer's backward, or both) and the
    elementwise ops run again; its peak memory lies between the layer
    inputs alone and every activation."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.params import tree_map

    out = {}
    for remat in (True, False):
        leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
        before = [f.launches for f in fwds]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with CountProducts() as forward:
                loss = lm.train_loss(cfg, leaves, batch, remat=remat)[0]
            with CountProducts() as products:
                loss.backward()
            torch.cuda.synchronize()
        events = _device_events(prof)
        out["remat" if remat else "no_remat"] = {
            "device_ms": sum(_dev_us(e) for e in events) / 1e3,
            "gemm_device_ms": sum(_dev_us(e) for e in events
                                  if is_gemm(e.key)) / 1e3,
            "gemm_launches": sum(e.count for e in events if is_gemm(e.key)),
            "forward_batched_products": forward.batched,
            "backward_products": products.n,
            "backward_batched_products": products.batched,
            **{f"{f.__name__}_launches": f.launches - n
               for f, n in zip(fwds, before, strict=True)},
            "peak_gib_above_params": (torch.cuda.max_memory_allocated()
                                      - base) / 2**30}
        del leaves, loss
        torch.cuda.empty_cache()
    emit({"phase": "train_remat", "arch": cfg.name,
          "batch": list(batch["tokens"].shape),
          "what": "one train_loss forward and backward, no optimizer",
          **out})
    r, n = out["remat"], out["no_remat"]
    rerun = r["backward_batched_products"] - n["backward_batched_products"]
    if (r["backward_products"] - r["backward_batched_products"]
            != n["backward_products"] - n["backward_batched_products"]
            or not 0 <= rerun <= n["forward_batched_products"]):
        raise AssertionError(f"remat reruns other matrix products than "
                             f"the forward's batched ones: {out}")


def profile_run(cfg, params, DecodeEngine, Request, label: str, mode: str,
                **engine_kw) -> dict:
    """Where a steady fused decode sync spends its time, in ``mode``
    "graph" (the replayed CUDA graph) or "eager" (the same loop without
    it): 8 slots at prompt length 200, after prefill.  Two syncs (16
    steps) are timed without the profiler, the next one profiled (the
    profile of an eager sync, 10,000-37,000 launches, takes most of a
    turn's time); the idle
    share is 1 - device busy time over the unprofiled wall time.  Device
    busy time is the profiler's kernel time; for the graph, the CUDA-event
    time of its replays (which run back to back on the device) is printed
    beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(1)
    eng = DecodeEngine(cfg, params, batch_slots=8, max_seq=1024, mode="fused",
                       steps_per_sync=8, prefill_chunk=64, device=DEVICE,
                       **engine_kw)
    replays: list = []
    if mode == "graph":
        replay = eng._replay_graph

        def timed_replay(name):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            replay(name)
            end.record()
            if name == "decode":
                replays.append((start, end))
        eng._replay_graph = no_host_sync(timed_replay)
    for _ in range(8):
        eng.submit(Request(prompt=rng.integers(
            0, cfg.vocab_size, token_shape(cfg, 200)).astype(np.int32),
            max_new_tokens=64))
    with eager_fused(DecodeEngine) if mode == "eager" \
            else contextlib.nullcontext():
        while eng.pf_done.max() < eng.pf_target.max() or eng.steps == 0:
            eng.step()                  # admission, chunked prefill, capture
        torch.cuda.synchronize()
        del replays[:]
        steps0 = eng.steps
        t0 = time.perf_counter()
        eng.step()
        eng.step()
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        plain_steps = eng.steps - steps0
        replay_ms = sum(a.elapsed_time(b) for a, b in replays)
        steps0 = eng.steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        steps = eng.steps - steps0

    events = prof.key_averages()
    kernels = sorted(_device_events(prof), key=_dev_us, reverse=True)
    busy_ms = sum(_dev_us(e) for e in kernels) / 1e3 / steps
    host = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)
    wall_ms = plain_wall * 1e3 / plain_steps
    syncs = steps // eng.steps_per_sync
    runtime = {e.key: e.count / syncs for e in events
               if e.device_type == DeviceType.CPU and e.key.startswith("cu")}
    graph = eng.graph_stats()
    row = {"phase": "profile", "path": label, "mode": mode,
           "what": "fused decode, 8 slots, 2 syncs timed, 1 profiled",
           "steps": steps, "wall_ms_per_step": wall_ms,
           "tokens_per_s": 8 * 1e3 / wall_ms,
           "profiled_wall_ms_per_step": wall * 1e3 / steps,
           "device_busy_ms_per_step": busy_ms,
           "device_idle_share": 1 - busy_ms / wall_ms,
           "launch_calls_per_sync": sum(
               n for k, n in runtime.items() if "Launch" in k),
           "runtime_calls_per_sync": runtime,
           "capture_ms": graph["capture_ms"],
           "graph_pool_mib": graph["graph_pool_bytes"] / 2**20,
           "top_device": [(e.key[:60], _dev_us(e) / 1e3 / steps,
                           e.count // steps) for e in kernels[:10]],
           "top_host_self": [(e.key[:60],
                              e.self_cpu_time_total / 1e3 / steps,
                              e.count // steps) for e in host[:10]]}
    if mode == "graph":
        row["replay_event_ms_per_step"] = replay_ms / plain_steps
        if graph["captures"] != 1:
            raise AssertionError(f"profile {label}: {graph}")
        # the launches the engine adds per replay, against the decode
        # kernel nodes the profiler saw the replays run
        counted = sum(n for w, n in eng._per_replay.items()
                      if w.__name__.startswith("decode_attention"))
        seen = sum(e.count for e in kernels
                   if "decode_split_kernel" in e.key)
        row["decode_launches_per_replay"] = {"counted": counted,
                                             "profiled": seen / syncs}
    emit(row)
    return row


def phase_profile(cfg, params, DecodeEngine, Request, label: str,
                  turns=("graph", "eager"), **engine_kw) -> None:
    """``profile_run`` in ``turns``: one graph and one eager turn, or the
    graph turn alone (dense and paged smollm-360m and mamba2-130m), to keep
    the run inside its time limit.  The line gives each mode's mean and,
    with both, the eager / graph ratio of the wall ms per step.  The
    engine's per-replay decode count is held
    against the kernel nodes the profiler saw the replays run: the
    profiler may lose an event but never adds one, so no graph turn may
    see more than the count and one must see exactly it; if every graph
    turn lost one, another graph turn follows (at most two more)."""
    rows = {"graph": [], "eager": []}
    for mode in turns:
        rows[mode].append(profile_run(cfg, params, DecodeEngine, Request,
                                      label, mode, **engine_kw))
    seen = [r["decode_launches_per_replay"] for r in rows["graph"]]
    extra = 0
    while not any(d["profiled"] == d["counted"] for d in seen) and extra < 2:
        extra += 1
        rows["graph"].append(profile_run(cfg, params, DecodeEngine, Request,
                                         label, "graph", **engine_kw))
        seen.append(rows["graph"][-1]["decode_launches_per_replay"])
    if any(d["profiled"] > d["counted"] for d in seen) or not any(
            d["profiled"] == d["counted"] for d in seen):
        raise AssertionError(f"profile {label}: decode launches per replay "
                             f"{seen}")
    keys = ("wall_ms_per_step", "device_busy_ms_per_step",
            "device_idle_share", "tokens_per_s", "launch_calls_per_sync")
    mean = {mode: {k: sum(r[k] for r in rs) / len(rs) for k in keys}
            for mode, rs in rows.items() if rs}
    mean["graph"]["replay_event_ms_per_step"] = sum(
        r["replay_event_ms_per_step"] for r in rows["graph"]) / len(
            rows["graph"])
    mean["graph"]["capture_ms"] = [r["capture_ms"] for r in rows["graph"]]
    mean["graph"]["graph_pool_mib"] = rows["graph"][0]["graph_pool_mib"]
    emit({"phase": "profile_summary", "path": label, "turns": list(turns),
          **mean,
          "eager_over_graph_wall": mean["eager"]["wall_ms_per_step"]
          / mean["graph"]["wall_ms_per_step"] if "eager" in mean else None})


# ---------------------------------------------------------------------------
# the dist phase: data-parallel training on torch.distributed
# ---------------------------------------------------------------------------
DIST_LAYERS = 2          # smollm-360m's 32 layers cut to 2 (full width)
DIST_STEPS = 3
DIST_BATCH = (2, 4096)
DIST_INT8_SHAPE = (2, 1 << 20)
# the reference's own sharded-parity bounds (tests/test_sharding.py:88-93)
DIST_LOSS_TOL, DIST_PARAM_TOL = 5e-2, 3e-2
DIST_FP32_REL = 1e-5


def dist_setup():
    """(config cut to ``DIST_LAYERS``, its cut, data config, job)."""
    from repro_torch.data.synthetic import data_config_for
    from repro_torch.train.loop import TrainJob

    cfg, cut = cut_config("smollm-360m", DIST_LAYERS)
    dc = data_config_for(cfg, seq_len=DIST_BATCH[1],
                         batch_size=DIST_BATCH[0])
    job = TrainJob(total_steps=DIST_STEPS, warmup=1, log_every=1,
                   remat=True, optimizer="adamw", zero1=True)
    return cfg, cut, dc, job


def state_bytes(state, shardings, whole=None) -> dict:
    """This rank's bytes of ``state`` as held, and as the specs lay them
    out: each leaf's whole bytes over its parts (the model axis's and the
    data axes'), the whole shapes from ``whole`` ({path: shape}, the
    descriptors') where given, else from the held shapes."""
    from repro_torch.checkpoint.checkpointer import _flatten

    sh = _flatten(shardings)
    held = counted = 0
    for key, t in _flatten(state).items():
        shape, n = list(t.shape), 1
        for part in (sh[key].model_part(), sh[key].part()):
            if part is not None:
                shape[part.dim] *= part.parts
                n *= part.parts
        if whole is not None:
            shape = whole[key]
        held += t.numel() * t.element_size()
        counted += math.prod(shape) * t.element_size() // n
    return {"held": held, "counted_from_specs": counted}


def whole_shapes(descr, optimizer: str) -> tuple[dict, dict]:
    """({path: shape} of the params, of the optimizer's state) from the
    descriptors: the whole leaves the specs split (AdamW's m, v and
    master; Adafactor's factored row and column moments, or v)."""
    from repro_torch.checkpoint.checkpointer import _flatten

    params = {k: tuple(p.shape) for k, p in _flatten(descr).items()}
    if optimizer == "adamw":
        state = {f"{m}/{k}": v for m in ("m", "v", "master")
                 for k, v in params.items()}
    elif optimizer == "adafactor":
        state = {}
        for k, v in params.items():
            if len(v) >= 2:
                state[f"v/{k}/vr"] = v[:-1]
                state[f"v/{k}/vc"] = v[:-2] + v[-1:]
            else:
                state[f"v/{k}/v"] = v
    else:
        raise ValueError(optimizer)
    return params, dict(state, count=())


def dist_fp32_step(cfg, dc, job, dev, rules=None) -> dict:
    """One fp32 step (``cast_tree``) of the job's AdamW from the seed's
    weights on batch 0 (with ``rules``: this rank's rows, and its parts of
    the weights on a model axis): loss and grad norm."""
    from repro_torch import distributed
    from repro_torch.data.synthetic import batch_at
    from repro_torch.models import lm
    from repro_torch.models.params import cast_tree, init_params
    from repro_torch.sharding import tp
    from repro_torch.sharding.rules import NamedSharding, use_rules
    from repro_torch.train.optimizer import get_optimizer
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.train_step import make_train_step

    gen = torch.Generator(device=dev)
    gen.manual_seed(job.seed)
    descr = lm.make_lm(cfg)
    opt = get_optimizer(job.optimizer)
    group = layout = parts = None
    split = False
    batch = batch_at(dc, 0)
    if rules is not None:
        group = distributed.data_group(rules.mesh)
        descr = tp.layout_descr(cfg, descr, rules)
        parts = tp.param_parts(cfg, descr, rules)
        layout = opt.layout(descr, rules)
        part = NamedSharding(rules.mesh, rules.spec(
            ("batch",), (dc.batch_size,))).part()
        batch = {k: part.take(v) for k, v in batch.items()}
        split = part.parts > 1
    params = cast_tree(init_params(descr, gen, dev, parts), torch.float32)
    state = opt.init(params, layout)
    step = make_train_step(cfg, opt, warmup_cosine(job.base_lr, job.warmup,
                                                   job.total_steps),
                           clip_norm=job.clip_norm, remat=True, group=group,
                           layout=layout, model_parts=parts,
                           rows_split=split)
    with use_rules(rules):
        _, _, m = step(params, state, {k: torch.from_numpy(v).to(dev)
                                       for k, v in batch.items()}, 0)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}


def dist_turn(cfg, dc, job, rules, mode: str, fa,
              device=DEVICE, wrappers=None) -> tuple[dict, dict]:
    """One ``run_training`` of the job under ``rules`` (None: unsharded)
    in ``mode`` (``train_steps``): its row (losses, wall ms a step from the
    host's clock at each log line, which waits for the device, launches of
    ``wrappers`` (default the flash forward and backward), the step's mode
    and backend, state bytes, peak allocated memory) and its final params
    on the host."""
    from repro_torch import distributed
    from repro_torch.models import lm
    from repro_torch.models.params import tree_map
    from repro_torch.sharding import tp
    from repro_torch.sharding.zero import opt_state_shardings
    from repro_torch.train.loop import run_training

    marks, made = [], []

    def log(line):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    wrappers = wrappers or (fa.flash_attention, fa.flash_attention_bwd)
    before = [w.launches for w in wrappers]
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with train_steps(mode, made):
        hist, _, params = run_training(cfg, dc, job, device=device,
                                       rules=rules, log=log)
    run = made[0]
    walls = [(b - a) * 1e3 for a, b in zip([t0] + marks, marks,
                                           strict=False)]
    row = {"mode": run.mode if mode == "graph" else "eager",
           "backend": (None if rules is None
                       else distributed.backend(distributed.data_group(
                           rules.mesh))),
           "losses": [h["loss"] for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist],
           "wall_ms_per_step": walls,
           "launches": {w.__name__: w.launches - n
                        for w, n in zip(wrappers, before, strict=True)},
           "graph": dict(run.stats),
           "peak_alloc_gib": torch.cuda.max_memory_allocated() / 2**30}
    if rules is not None:
        descr = tp.layout_descr(cfg, lm.make_lm(cfg), rules)
        p_whole, s_whole = whole_shapes(descr, job.optimizer)
        row["state_bytes"] = state_bytes(run.opt_state, opt_state_shardings(
            job.optimizer, descr, rules, zero1=job.zero1), s_whole)
        row["param_bytes"] = state_bytes(
            params, tp.param_shardings(cfg, descr, rules), p_whole)
    params = tree_map(lambda t: t.cpu(), params)
    del made, run
    return row, params


_DIST_RANK = r"""
import json, math, os, sys, time
import torch
sys.path.insert(0, sys.argv[5])
import chip_smoke as cs
from repro_torch import distributed
from repro_torch.data.synthetic import batch_at
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.sharding.compression import (allreduce_int8,
                                              make_error_feedback_compress)
from repro_torch.sharding.rules import NamedSharding, make_rules, use_rules
from repro_torch.train.optimizer import get_optimizer
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.train_step import make_train_step

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
cs.tp_warm_up()         # the first step's imports, while the parent runs a
while not os.path.exists(sys.argv[7]):     # the card is a's until then
    time.sleep(0.05)
t_start = time.perf_counter()
dev = distributed.init(sys.argv[6], init_method="file://" + store, rank=rank,
                       world_size=world)
mesh = make_mesh((world,), ("data",), device=dev.type)
rules = make_rules(mesh)
group = distributed.data_group(mesh)
cfg, _, dc, job = cs.dist_setup()
res = {"rank": rank, "backend": distributed.backend(group),
       "device": str(dev),
       "ready_s": time.perf_counter() - t_start}

# b: three bf16 steps through the port's loop (eager: a gloo group)
row, params = cs.dist_turn(cfg, dc, job, rules, "graph", fa, dev.type)
res["b"] = row
if rank == 0:
    torch.save(params, out + ".params.pt")
del params

# the compressed run: the same steps with the error-feedback transform on
# the reduced gradients, through the reference's contract compress(grads,
# opt_state); the transform's second argument is a residual tree, which
# this adapter keeps (the reference passes opt_state there)
gen = torch.Generator(device=dev)
gen.manual_seed(job.seed)
params = lm.init_lm(cfg, gen, dev)
opt = get_optimizer(job.optimizer)
layout = opt.layout(lm.make_lm(cfg), rules)
state = opt.init(params, layout)
init_r, transform = make_error_feedback_compress(None)
residuals = init_r(params)
worst = []


def compress(grads, opt_state):
    global residuals
    carried = [g.float() + r for g, r in zip(tree_leaves(grads),
                                             tree_leaves(residuals),
                                             strict=True)]
    grads, residuals = transform(grads, residuals)
    worst.append(max(float(r.abs().max()) / float(
        (c.abs().max() + 1e-12) / 127) for c, r in zip(
            carried, tree_leaves(residuals), strict=True)))
    return grads, opt_state


step_fn = make_train_step(cfg, opt, warmup_cosine(job.base_lr, job.warmup,
                                                  job.total_steps),
                          clip_norm=job.clip_norm, remat=True,
                          compress=compress, group=group, layout=layout)
part = NamedSharding(mesh, rules.spec(("batch",), (dc.batch_size,))).part()
losses, walls = [], []
for step in range(job.total_steps):
    t0 = time.perf_counter()
    batch = {k: torch.from_numpy(part.take(v)).to(dev)
             for k, v in batch_at(dc, step).items()}
    with use_rules(rules):
        _, _, m = step_fn(params, state, batch, step)
    losses.append(float(m["loss"]))
    walls.append((time.perf_counter() - t0) * 1e3)
res["compressed"] = {"losses": losses, "wall_ms_per_step": walls,
                     "residual_over_step": worst}
del params, state, residuals
torch.cuda.empty_cache()

# b, fp32: one step
res["fp32"] = cs.dist_fp32_step(cfg, dc, job, dev, rules)

# allreduce_int8 over the ranks against the same arithmetic on one rank
xs = []
for r in range(world):
    g = torch.Generator(device=dev)
    g.manual_seed(100 + r)
    xs.append(torch.randn(cs.DIST_INT8_SHAPE, generator=g, device=dev))
torch.cuda.synchronize()
t0 = time.perf_counter()
y = allreduce_int8(xs[rank], group)
torch.cuda.synchronize()
ms = (time.perf_counter() - t0) * 1e3
scale = max((x.abs().max() + 1e-12) / 127.0 for x in xs)
total = sum(torch.clamp(torch.round(x / scale), -127, 127).to(torch.int32)
            for x in xs)
want = total.to(torch.float32) * scale / float(world)
res["int8"] = {"equal": bool(torch.equal(y, want)),
               "max_abs_diff": float((y - want).abs().max()),
               "max_abs_from_mean": float((y - sum(xs) / world).abs().max()),
               "wall_ms": ms}
res["seconds"] = time.perf_counter() - t_start
with open(out + f".{rank}.json", "w") as f:
    json.dump(res, f)
distributed.shutdown()
"""


def phase_dist(fa) -> dict:
    """Data-parallel training of smollm-360m at full width cut to
    ``DIST_LAYERS`` layers, AdamW, remat, [2, 4096], bf16 weights from the
    seed, ``DIST_STEPS`` steps, in three setups:

    a. world 1 over NCCL in this process (``--mesh 1``, ZeRO-1 on): one
       graph turn (the step with its collectives captured) and one eager
       turn; both final params equal ``run_training(rules=None)``'s on the
       same seed and batches bit for bit (an all-reduce over one rank is
       the identity; ZeRO-1's slices are whole);
    b. world 2, two rank processes sharing the card through gloo (the rule:
       two local ranks, one card), eagerly: each step's loss within 5e-2 of
       a's and the params after the steps within 3e-2 (the reference's
       sharded-parity bounds); each rank's optimizer-state bytes equal
       those the ZeRO-1 specs lay out; ``allreduce_int8`` of a [2, 1 << 20]
       fp32 tensor a rank equal, bit for bit, to the same arithmetic done on
       one rank over both inputs; three steps through
       ``make_error_feedback_compress`` with finite losses within 5e-2 of
       b's and every residual at most one quantisation step of its leaf
       (the max of |g + carried residual| over 127);
    b, fp32: one fp32 step (``cast_tree``) at world 2 against world 1's:
       loss and grad norm within 1e-5 relative.

    The two ranks of b share one card, so their step time says nothing of
    scaling.  Returns the flash launches of b's ranks, by wrapper."""
    import os
    import tempfile

    from repro_torch import distributed
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.rules import make_rules

    t_phase = time.perf_counter()
    cfg, cut, dc, job = dist_setup()
    emit({"phase": "init", "arch": cfg.name, "what": "dist",
          **arch_line(cfg, cut), "optimizer": job.optimizer,
          "steps": job.total_steps, "batch": list(DIST_BATCH)})
    # b's two ranks start now: they import and make a first step's imports
    # on the CPU (``tp_warm_up``) while a runs, then wait on the go file
    root = str(Path(__file__).resolve().parent)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        out = os.path.join(tmp, "rank")
        go = os.path.join(tmp, "go")
        env = {**os.environ, "PYTHONPATH": str(SRC), "LOCAL_WORLD_SIZE": "2"}
        procs = [subprocess.Popen(
            [sys.executable, "-c", _DIST_RANK, str(r), "2",
             os.path.join(tmp, "store"), out, root, DEVICE, go],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env) for r in range(2)]
        try:
            # a: world 1 over NCCL in this process
            distributed.init(DEVICE)    # a world of one on a file:// store
            rules = make_rules(make_mesh((1,), ("data",), device=DEVICE))
            rows, finals = {}, {}
            for name, r, mode in (("graph", rules, "graph"),
                                  ("eager", rules, "eager"),
                                  ("unsharded", None, "graph")):
                rows[name], finals[name] = dist_turn(cfg, dc, job, r, mode,
                                                     fa)
            fp32_1 = dist_fp32_step(cfg, dc, job, torch.device(DEVICE))
            distributed.shutdown()
            torch.cuda.empty_cache()
            a = {"phase": "dist", "setup": "a", "world": 1, **rows["graph"],
                 "eager": rows["eager"], "unsharded": rows["unsharded"],
                 "graph_equal_eager": same_bits(finals["graph"],
                                                finals["eager"]),
                 "graph_equal_unsharded": same_bits(finals["graph"],
                                                    finals["unsharded"]),
                 "fp32_step": fp32_1}
            emit(a)
            g = rows["graph"]
            if g["mode"] != "graph" or g["backend"] != "nccl" \
                    or g["graph"]["captures"] != 1:
                raise AssertionError(f"dist a: the world-1 NCCL step was "
                                     f"not captured: {g}")
            if not (a["graph_equal_eager"] and a["graph_equal_unsharded"]):
                raise AssertionError("dist a: final params differ between "
                                     "graph, eager and unsharded")
            fwd, bwd = train_launches(cfg)["flash"]
            per_run = {"flash_attention": fwd * job.total_steps,
                       "flash_attention_bwd": bwd * job.total_steps}
            for name, row in rows.items():
                if row["launches"] != per_run:
                    raise AssertionError(f"dist a {name}: launches "
                                         f"{row['launches']}, want {per_run}")
            sb = rows["graph"]["state_bytes"]
            if sb["held"] != sb["counted_from_specs"]:
                raise AssertionError(f"dist a: state bytes {sb}")

            # b: two ranks on the card through gloo
            open(go, "w").close()
            done = []
            for p in procs:
                so, se = p.communicate(timeout=300)
                done.append((p.returncode, so, se))
            for rc, so, se in done:
                if rc:
                    raise AssertionError(f"dist b: a rank exited {rc}\n"
                                         f"{so[-3000:]}\n{se[-5000:]}")
            ranks = [json.load(open(f"{out}.{r}.json")) for r in range(2)]
            params_b = torch.load(f"{out}.params.pt")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    want = finals["graph"]
    param_gap = tree_distance(params_b, want)
    from repro_torch.models.params import tree_leaves

    param_ok = all(torch.allclose(x.float(), y.float(), atol=DIST_PARAM_TOL,
                                  rtol=DIST_PARAM_TOL)
                   for x, y in zip(tree_leaves(params_b), tree_leaves(want),
                                   strict=True))
    loss_a = rows["graph"]["losses"]
    b = {"phase": "dist", "setup": "b", "world": 2,
         "note": "two ranks share one card: the step time says nothing of "
                 "scaling",
         "ranks": [{k: v for k, v in r.items() if k not in ("compressed",
                                                            "fp32", "int8")}
                   for r in ranks],
         "loss_vs_a": [max(abs(r["b"]["losses"][i] - loss_a[i])
                           for r in ranks) for i in range(len(loss_a))],
         "param_distance_vs_a": param_gap,
         "params_within": DIST_PARAM_TOL if param_ok else None,
         "state_bytes_world1": sb,
         "peak_alloc_gib_world1": rows["graph"]["peak_alloc_gib"],
         "compressed": [r["compressed"] for r in ranks],
         "int8_allreduce": [r["int8"] for r in ranks],
         "seconds": time.perf_counter() - t_phase}
    emit(b)
    fp32 = {"phase": "dist", "setup": "b_fp32", "world": 2,
            "world1": fp32_1, "ranks": [r["fp32"] for r in ranks],
            "rel": {k: max(abs(r["fp32"][k] - fp32_1[k]) / abs(fp32_1[k])
                           for r in ranks) for k in ("loss", "grad_norm")}}
    emit(fp32)
    for r in ranks:
        if r["b"]["launches"] != per_run:
            raise AssertionError(f"dist b: rank {r['rank']} launches "
                                 f"{r['b']['launches']}, want {per_run}")
        if r["backend"] != "gloo" or r["b"]["mode"] != "eager":
            raise AssertionError(f"dist b: rank {r['rank']} ran "
                                 f"{r['backend']} {r['b']['mode']}")
        sbr = r["b"]["state_bytes"]
        if sbr["held"] != sbr["counted_from_specs"] or not (
                sbr["held"] < 0.51 * sb["held"]):
            raise AssertionError(f"dist b: rank {r['rank']} state bytes "
                                 f"{sbr} against world 1's {sb}")
        if not r["int8"]["equal"]:
            raise AssertionError(f"dist b: allreduce_int8 {r['int8']}")
        comp = r["compressed"]
        if not all(math.isfinite(x) for x in comp["losses"]) or max(
                abs(x - y) for x, y in zip(comp["losses"], loss_a,
                                           strict=True)) > DIST_LOSS_TOL \
                or max(comp["residual_over_step"]) > 1.0:
            raise AssertionError(f"dist b: compressed run {comp}")
    if max(b["loss_vs_a"]) > DIST_LOSS_TOL or not param_ok:
        raise AssertionError(f"dist b: losses {b['loss_vs_a']} from a's, "
                             f"params within {DIST_PARAM_TOL}: {param_ok}")
    if max(fp32["rel"].values()) > DIST_FP32_REL:
        raise AssertionError(f"dist b fp32: {fp32['rel']}")
    return {k: sum(r["b"]["launches"][k] for r in ranks)
            for k in ranks[0]["b"]["launches"]}


# ---------------------------------------------------------------------------
# the tp phase: the model axis (tensor- and expert-parallel training)
# ---------------------------------------------------------------------------
# full width, cut in depth: (layers kept, the (data, model) mesh of the
# rank processes, the optimizer)
TP_ARCHS = {"qwen3-4b": (1, (2, 2), "adamw"),
            "granite-20b": (1, (1, 2), "adamw"),
            "olmoe-1b-7b": (1, (1, 2), "adamw"),
            "mamba2-130m": (2, (2, 2), "adamw"),
            "jamba-v0.1-52b": (2, (1, 2), "adafactor"),
            "deepseek-v3-671b": (1, (1, 2), "adafactor"),
            "musicgen-medium": (2, (1, 2), "adamw"),
            "phi-3-vision-4.2b": (2, (1, 2), "adafactor")}
# each config's setup letter on its line, and the rank processes that run
# it: group b's four ranks (2, 2), group cd's two (1, 2)
TP_SETUPS = {"qwen3-4b": "b", "granite-20b": "c", "olmoe-1b-7b": "d",
             "mamba2-130m": "e", "jamba-v0.1-52b": "f",
             "deepseek-v3-671b": "g", "musicgen-medium": "i",
             "phi-3-vision-4.2b": "j"}
TP_GROUPS = {"b": ["qwen3-4b", "mamba2-130m"],
             "cd": ["granite-20b", "olmoe-1b-7b", "musicgen-medium",
                    "phi-3-vision-4.2b", "jamba-v0.1-52b",
                    "deepseek-v3-671b"]}
# serving on the model axis after the steps, on the params the ranks
# trained (setup h: qwen3-4b in b's ranks; i: musicgen-medium after its
# steps), in fp32: a prefill of TP_SERVE_BATCH, the cache warmed by one
# prefill chunk of the prompt, TP_SERVE_STEPS greedy decode steps
TP_SERVE = {"qwen3-4b": "h", "musicgen-medium": "i"}
TP_SERVE_BATCH = (2, 1024)
TP_SERVE_STEPS = 8
# the configs whose ranks start only once group b's ranks have exited:
# their fp32 steps take 23-25 GiB a rank (on an H100 80GB HBM3), which
# beside b's four ranks would come near the card's 80 GB
TP_AFTER_B = ("jamba-v0.1-52b", "deepseek-v3-671b")
TP_STEPS = 2
TP_BATCH = (2, 4096)
TP_FP32_REL = 1e-5
TP_KERNELS = ("flash_attention", "flash_attention_bwd", "ssd_scan",
              "ssd_scan_bwd")
# elements of a leaf that the parent compares at a time on the card, while
# the ranks of the next configs run (jamba's expert stacks are 0.94 G)
TP_CHECK_CHUNK = 1 << 26


def tp_setup(arch: str):
    """(config cut to its ``TP_ARCHS`` depth, its cut, data config, job
    with the config's ``TP_ARCHS`` optimizer).  jamba-v0.1-52b's
    super-block is cut from 8 layers to 2, the published block's positions
    4 (attention, dense FFN) and 5 (Mamba, MoE), so every mixer and FFN
    kind stays; deepseek-v3-671b to one dense layer (no MoE layer: one is
    11.3 B parameters) and its MTP block (``cut_config``)."""
    from repro_torch.data.synthetic import data_config_for
    from repro_torch.train.loop import TrainJob

    cfg, cut = cut_config(arch, TP_ARCHS[arch][0])
    dc = data_config_for(cfg, seq_len=TP_BATCH[1], batch_size=TP_BATCH[0])
    job = TrainJob(total_steps=TP_STEPS, warmup=1, log_every=1, remat=True,
                   optimizer=TP_ARCHS[arch][2], zero1=True)
    return cfg, cut, dc, job


def moe_layers(cfg) -> int:
    """The MoE layers the config builds (deepseek's cut builds none)."""
    from repro_torch.models import lm

    n = 0
    for seg in lm.segments(cfg):
        n += seg.count * (sum(f == "moe" for _, _, _, f in seg.plan.entries)
                          if seg.kind == "hybrid" else seg.ffn == "moe")
    return n


def tp_wrappers():
    """The four training kernels' wrappers, in ``TP_KERNELS``' order."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    return (fa.flash_attention, fa.flash_attention_bwd, ssd.ssd_scan,
            ssd.ssd_scan_bwd)


@contextlib.contextmanager
def call_shapes(seen: dict):
    """Add the (q, k, v) shapes of each ``ops.flash_attention`` call to
    ``seen["flash"]`` and the x shape of each ``ops.ssd_scan`` call to
    ``seen["ssd"]``."""
    from repro_torch.kernels import ops

    flash, scan = ops.flash_attention, ops.ssd_scan

    def flash_recording(q, k, v, **kwargs):
        seen["flash"].add((tuple(q.shape), tuple(k.shape), tuple(v.shape)))
        return flash(q, k, v, **kwargs)

    def ssd_recording(x, *args, **kwargs):
        seen["ssd"].add((tuple(x.shape),))
        return scan(x, *args, **kwargs)

    ops.flash_attention, ops.ssd_scan = flash_recording, ssd_recording
    try:
        yield
    finally:
        ops.flash_attention, ops.ssd_scan = flash, scan


def tp_serve_batch(cfg) -> dict:
    """The serving check's prompts (``TP_SERVE_BATCH``), from a seed."""
    B, S = TP_SERVE_BATCH
    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    rng = np.random.default_rng(11)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S, *cb)).astype(
        np.int32)}


def tp_serve(cfg, params, dev, rules=None) -> dict:
    """fp32 serving from ``params`` (host tensors; with ``rules`` this
    rank's parts, its rows of the prompts and its part of the cache):
    ``lm.prefill``, the cache warmed by ``lm.prefill_chunk`` of the
    prompt, then ``TP_SERVE_STEPS`` greedy ``lm.decode_step``s.  Returns
    the logits of each (whole over the vocabulary; this rank's rows), the
    flash and decode launches, and the cache's bytes held, by its layout
    and whole."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm
    from repro_torch.models.params import (cast_tree, init_params,
                                           tree_leaves, tree_map)
    from repro_torch.sharding.rules import NamedSharding, use_rules

    cfg32 = cfg.replace(dtype="float32")
    p32 = cast_tree(tree_map(lambda t: t.to(dev), params), torch.float32)
    batch = tp_serve_batch(cfg)
    B, S = TP_SERVE_BATCH
    if rules is not None:
        rows = NamedSharding(rules.mesh, rules.spec(("batch",), (B,))).part()
        batch = {k: rows.take(v) for k, v in batch.items()}
    batch = {k: torch.from_numpy(v.copy()).to(dev) for k, v in batch.items()}
    b = batch["tokens"].shape[0]
    before = (fa.flash_attention.launches, da.decode_attention.launches)
    with torch.no_grad(), use_rules(rules):
        logits, _ = lm.prefill(cfg32, p32, batch)
        cache = lm.make_cache(cfg32, B, S + TP_SERVE_STEPS, device=dev,
                              rules=rules)
        lm.prefill_chunk(cfg32, p32, dict(
            batch, start=torch.zeros(b, dtype=torch.int32, device=dev)),
            cache)
        got = [logits.cpu()]
        tok = logits.argmax(-1)
        for i in range(TP_SERVE_STEPS):
            logits, cache = lm.decode_step(cfg32, p32, {
                "tokens": tok[:, None],
                "pos": torch.full((b,), S + i, dtype=torch.int32,
                                  device=dev)}, cache)
            got.append(logits.cpu())
            tok = logits.argmax(-1)
    torch.cuda.synchronize()

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    whole = init_params(lm.cache_descr(cfg32, B, S + TP_SERVE_STEPS), None,
                        "meta")
    return {"logits": got,
            "launches": {"flash_attention": fa.flash_attention.launches
                         - before[0],
                         "decode_attention": da.decode_attention.launches
                         - before[1]},
            "cache_bytes": {"held": nbytes(cache),
                            "counted_from_specs": nbytes(init_params(
                                lm.cache_descr(cfg32, B, S + TP_SERVE_STEPS,
                                               rules=rules), None, "meta")),
                            "whole": nbytes(whole)}}


def tp_rank_run(arch: str, rules, dev, out: str) -> dict:
    """One rank's share of the ``tp`` phase for ``arch`` on ``rules``'
    mesh: the job's bf16 steps through ``run_training`` (gloo: eager),
    with the flash and SSD calls' shapes; the fp32 step; on a config with
    MoE layers the fp32 step again under ``REPRO_MOE=ep``.  A rank at data
    coordinate 0 saves its params' model parts, with the dim each splits,
    to ``{out}.{arch}.{model coordinate}.pt``."""
    import os

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm
    from repro_torch.sharding import tp

    os.environ["REPRO_MOE"] = "gather"
    cfg, _, dc, job = tp_setup(arch)
    seen: dict = {"flash": set(), "ssd": set()}
    t0 = time.perf_counter()
    with call_shapes(seen):
        row, params = dist_turn(cfg, dc, job, rules, "graph", fa, dev.type,
                                tp_wrappers())
    row["shapes"] = {k: sorted(v) for k, v in seen.items()}
    row["turn_s"] = time.perf_counter() - t0
    data, model = rules.mesh.get_coordinate()
    if data == 0:
        from repro_torch.checkpoint.checkpointer import _flatten

        parts = _flatten(tp.param_parts(cfg, tp.layout_descr(
            cfg, lm.make_lm(cfg), rules), rules))
        torch.save({k: (None if parts[k] is None else parts[k].dim, v)
                    for k, v in _flatten(params).items()},
                   f"{out}.{arch}.{model}.pt")
    if arch in TP_SERVE:
        t_serve = time.perf_counter()
        served = tp_serve(cfg, params, dev, rules)
        if model == 0:      # each data coordinate's rows, whole logits
            torch.save(served.pop("logits"), f"{out}.{arch}.serve.{data}.pt")
        else:
            served.pop("logits")
        row["serve"] = dict(served, seconds=time.perf_counter() - t_serve)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    row["save_s"] = t1 - t0 - row["turn_s"]
    row["fp32"] = dist_fp32_step(cfg, dc, job, dev, rules)
    if moe_layers(cfg):
        os.environ["REPRO_MOE"] = "ep"
        row["fp32_ep"] = dist_fp32_step(cfg, dc, job, dev, rules)
        os.environ["REPRO_MOE"] = "gather"
    row["fp32_peak_alloc_gib"] = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    row["fp32_s"] = time.perf_counter() - t1
    row["seconds"] = time.perf_counter() - t0
    return row


_TP_RANK = r"""
import json, os, sys, time
import torch
sys.path.insert(0, sys.argv[5])
import chip_smoke as cs
from repro_torch import distributed
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding.rules import make_rules

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
shape = tuple(int(x) for x in sys.argv[6].split("x"))
archs, go, device = sys.argv[7].split(","), sys.argv[8], sys.argv[9]
from repro_torch.kernels import cuda_build

t_start = time.perf_counter()
# the CUDA context, cuBLAS's handle and the kernels' library, while the
# parent runs the references: a few hundred MiB of the card a rank; and
# the imports of a first train step, on the CPU
x = torch.ones((64, 64), dtype=torch.bfloat16, device=device)
x = x @ x
torch.cuda.synchronize()
del x
cuda_build.library()
cs.tp_warm_up()
t_warm = time.perf_counter()
while not os.path.exists(go):      # the card is the parent's until then
    time.sleep(0.05)
t_go = time.perf_counter()
dev = distributed.init(device, init_method="file://" + store, rank=rank,
                       world_size=world)
mesh = make_mesh(shape, ("data", "model"), device=dev.type)
rules = make_rules(mesh)
res = {"rank": rank, "coordinate": list(mesh.get_coordinate()),
       "backend": distributed.backend(), "device": str(dev),
       "warm_s": t_warm - t_start, "wait_s": t_go - t_warm}
for arch in archs:
    while arch in cs.TP_AFTER_B and not os.path.exists(go + ".b_done"):
        time.sleep(0.05)
    res[arch] = cs.tp_rank_run(arch, rules, dev, out)
    # each config's row as soon as it is done, for the parent to check
    # while this rank runs on
    name = f"{out}.{arch}.{rank}.json"
    with open(name + ".tmp", "w") as f:
        json.dump({k: res[k] for k in ("rank", "coordinate", "backend")}
                  | {"row": res[arch]}, f)
    os.replace(name + ".tmp", name)
res["seconds"] = time.perf_counter() - t_go
with open(out + f".{rank}.json", "w") as f:
    json.dump(res, f)
distributed.shutdown()
"""


def tp_warm_up() -> None:
    """Import ``torch._dynamo``, as a first train step does: its first
    checkpointed layer (``torch.utils.checkpoint``'s selective recompute)
    imports it and ~840 modules with it, which took a rank process 10-20
    s of its first step while six ranks imported at once on an H100
    80GB HBM3's host (a rank's first step 19-25 s, its second 2-5 s).  A
    rank process makes the imports while it waits for the card
    (the pure imports start no thread and touch no device, so a CUDA-free
    parent may also fork after them)."""
    import torch._dynamo  # noqa: F401


def tp_whole_params(out: str, arch: str, model: int) -> dict:
    """{path: whole leaf} from the ``model`` rank files of ``arch``: each
    leaf's model parts concatenated along the dim they split."""
    files = [torch.load(f"{out}.{arch}.{m}.pt") for m in range(model)]
    whole = {}
    for key, (dim, t) in files[0].items():
        whole[key] = t if dim is None else torch.cat(
            [f[key][1] for f in files], dim=dim)
    return whole


def tp_references(fa) -> dict:
    """a. World 1 over NCCL in this process on a (1, 1) (data, model)
    mesh: qwen3-4b's steps captured as one graph, equal bit for bit to
    ``run_training(rules=None)``'s; and every config's unsharded run and
    fp32 step, the references of b-g."""
    from repro_torch import distributed
    from repro_torch.checkpoint.checkpointer import _flatten
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.rules import make_rules

    import os
    os.environ["REPRO_MOE"] = "gather"
    distributed.init(DEVICE)
    rules = make_rules(make_mesh((1, 1), ("data", "model"), device=DEVICE))
    refs = {}
    for arch in TP_ARCHS:
        cfg, cut, dc, job = tp_setup(arch)
        t0 = time.perf_counter()
        emit({"phase": "init", "arch": arch, "what": "tp",
              "setup": TP_SETUPS[arch], **arch_line(cfg, cut),
              "optimizer": job.optimizer, "steps": job.total_steps,
              "batch": list(TP_BATCH), "mesh": list(TP_ARCHS[arch][1])})
        row, final = dist_turn(cfg, dc, job, None, "graph", fa, DEVICE,
                               tp_wrappers())
        ref = {"unsharded": row, "final": _flatten(final),
               "fp32": dist_fp32_step(cfg, dc, job, torch.device(DEVICE))}
        if arch == "qwen3-4b":
            a_row, a_final = dist_turn(cfg, dc, job, rules, "graph", fa,
                                       DEVICE)
            ref["a"] = a_row
            ref["a_equal_unsharded"] = same_bits(a_final, final)
            del a_final
        ref["seconds"] = time.perf_counter() - t0
        refs[arch] = ref
        del final
        torch.cuda.empty_cache()
    distributed.shutdown()
    torch.cuda.empty_cache()
    a = refs["qwen3-4b"]["a"]
    emit({"phase": "tp", "setup": "a", "world": 1, "mesh": [1, 1],
          **{k: v for k, v in a.items() if k != "launches"},
          "launches": a["launches"],
          "graph_equal_unsharded": refs["qwen3-4b"]["a_equal_unsharded"]})
    if a["mode"] != "graph" or a["backend"] != "nccl" \
            or a["graph"]["captures"] != 1:
        raise AssertionError(f"tp a: the world-1 NCCL step was not "
                             f"captured: {a}")
    if not refs["qwen3-4b"]["a_equal_unsharded"]:
        raise AssertionError("tp a: the (1, 1) mesh's params differ from "
                             "run_training(rules=None)'s")
    return refs


def phase_tp(fa) -> dict:
    """Training on the ``model`` axis (``sharding/tp.py``), each config at
    full width cut in depth (``tp_setup``), remat, [2, 4096], bf16 weights
    from the seed, ``TP_STEPS`` steps, ZeRO-1, under the config's
    ``TP_ARCHS`` optimizer:

    a. world 1 over NCCL on a (1, 1) mesh in this process (``tp_references``);
    b. qwen3-4b on (2, 2), AdamW: four rank processes sharing the card
       through gloo (eagerly), 16 query heads and 4 KV heads a rank, the
       vocabulary split;
    c. granite-20b on (1, 2), AdamW: 24 query heads a rank on the one
       replicated KV head;
    d. olmoe-1b-7b on (1, 2), AdamW: 32 of the 64 experts a rank;
    e. mamba2-130m, 2 of 24 layers, on (2, 2) in b's ranks after qwen3-4b,
       AdamW: 12 of the 24 SSD heads a rank (``in_proj`` and the conv
       whole);
    f. jamba-v0.1-52b, the super-block cut from 8 layers to 2 (attention
       with the dense FFN, Mamba with the MoE), on (1, 2) in c and d's
       ranks, Adafactor: 64 of 128 SSD heads, 16 / 4 attention heads and 8
       of 16 experts a rank;
    g. deepseek-v3-671b cut to one dense layer and its MTP block, on (1, 2)
       in c and d's ranks, Adafactor: 64 of 128 MLA heads and half the
       vocabulary a rank;
    h. qwen3-4b served on (2, 2) in b's ranks, on the params b trained, in
       fp32 (``tp_serve``): a prefill of [2, 1024] (one row a data rank),
       the cache warmed by a prefill chunk, 8 greedy decode steps, 16 query
       and 4 KV heads a rank, its part of the cache;
    i. musicgen-medium, 2 of 48 layers, on (1, 2) in c and d's ranks,
       AdamW: 12 of 24 heads and 1,024 of each codebook table's 2,048
       rows a rank; then served as h, prompts of [2, 1024, 4];
    j. phi-3-vision-4.2b, 2 of 32 layers, on (1, 2) in c and d's ranks,
       Adafactor, with its 576 image rows a sequence: 16 of 32 heads a
       rank at D 96.

    b-e run beside c, d, i and j: six rank processes share the card; f and
    g start once b's and e's ranks have exited (``TP_AFTER_B``).
    Gates of b-g: each step's loss within 5e-2 of the unsharded run on the
    same seed and batches and the params after the steps within 3e-2 (the
    reference's sharded-parity bounds); one fp32 step within 1e-5
    (relative) in loss and grad norm of the unsharded fp32 step (the
    configs without MoE layers: b, c, e, g; d's and f's is printed, their
    routing may flip on a near tie); each rank's param and optimizer-state
    bytes equal to the specs' count; each rank's flash and SSD launches
    those of its layers (``train_launches``) at its local heads; and, on
    d and f, the fp32 step under ``REPRO_MOE=ep`` within 1e-5 of
    ``gather``'s (at data 1 they are one function).  The rank processes
    start (import) while this process runs a; the ranks share one card, so
    their step times say nothing of scaling.  h and i hold the ranks'
    serving to the unsharded run on the same params (``tp_serve_check``).
    Returns the ranks' flash, SSD and decode launches."""
    import os
    import tempfile

    t_phase = time.perf_counter()
    root = str(Path(__file__).resolve().parent)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        procs, logs = {}, {}
        for name, archs in TP_GROUPS.items():
            shape = TP_ARCHS[archs[0]][1]
            world = shape[0] * shape[1]
            env = {**os.environ, "PYTHONPATH": str(SRC),
                   "LOCAL_WORLD_SIZE": str(world)}
            logs[name] = [open(os.path.join(tmp, f"{name}.{r}.log"), "w+")
                          for r in range(world)]
            procs[name] = [subprocess.Popen(
                [sys.executable, "-c", _TP_RANK, str(r), str(world),
                 os.path.join(tmp, f"store_{name}"), os.path.join(tmp, name),
                 root, f"{shape[0]}x{shape[1]}", ",".join(archs),
                 os.path.join(tmp, f"go_{name}"), DEVICE],
                stdout=log, stderr=subprocess.STDOUT, env=env)
                for r, log in enumerate(logs[name])]

        def exited(name: str) -> bool:
            """Whether every rank of the group has exited; raise for one
            that failed."""
            for p, log in zip(procs[name], logs[name], strict=True):
                if p.poll() not in (None, 0):
                    log.seek(0)
                    raise AssertionError(f"tp {name}: a rank exited "
                                         f"{p.returncode}\n"
                                         f"{log.read()[-8000:]}")
            return all(p.poll() == 0 for p in procs[name])

        def written(name: str, arch: str) -> list:
            """The ranks' rows of ``arch`` once each has written it; the
            card's memory is TP_AFTER_B's once b's ranks have exited."""
            paths = [os.path.join(tmp, f"{name}.{arch}.{r}.json")
                     for r in range(len(procs[name]))]
            deadline = time.perf_counter() + 600
            while not all(os.path.exists(q) for q in paths):
                if exited("b") and not os.path.exists(b_done[0]):
                    for q in b_done:
                        open(q, "w").close()
                if exited(name) or time.perf_counter() > deadline:
                    raise AssertionError(f"tp {name}: no {arch} from "
                                         f"every rank")
                time.sleep(0.1)
            return [json.load(open(q)) for q in paths]

        b_done = [os.path.join(tmp, f"go_{name}.b_done")
                  for name in TP_GROUPS]
        launched, ranks = {}, {}
        try:
            t_refs = time.perf_counter()
            refs = tp_references(fa)
            t_refs = time.perf_counter() - t_refs
            for name in TP_GROUPS:      # both groups share the card at once
                open(os.path.join(tmp, f"go_{name}"), "w").close()
            # each config is checked as soon as its ranks have written it,
            # while the ranks run on
            for name, archs in TP_GROUPS.items():
                for arch in archs:
                    rows = written(name, arch)
                    whole = tp_whole_params(os.path.join(tmp, name), arch,
                                            TP_ARCHS[arch][1][1])
                    for k, n in tp_check(arch, refs[arch], whole,
                                         [r["row"] for r in rows],
                                         rows).items():
                        launched[k] = launched.get(k, 0) + n
                    if arch in TP_SERVE:
                        for k, n in tp_serve_check(
                                arch, whole, [r["row"] for r in rows], rows,
                                os.path.join(tmp, name)).items():
                            launched[k] = launched.get(k, 0) + n
                    del whole
                for p in procs[name]:
                    p.wait(timeout=600)
                if exited(name) and name == "b":
                    for q in b_done:
                        open(q, "w").close()
                ranks[name] = [json.load(open(os.path.join(
                    tmp, f"{name}.{r}.json")))
                    for r in range(len(procs[name]))]
        finally:
            for ps in procs.values():
                for p in ps:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            for ls in logs.values():
                for log in ls:
                    log.close()
    emit({"phase": "tp", "setup": "summary",
          "seconds": time.perf_counter() - t_phase,
          "references_seconds": t_refs,
          "reference_seconds": {a: r["seconds"] for a, r in refs.items()},
          "rank_seconds": {name: [r["seconds"] for r in rs]
                           for name, rs in ranks.items()},
          "rank_arch_seconds": {a: [r[a]["seconds"] for r in ranks[name]]
                                for name, archs in TP_GROUPS.items()
                                for a in archs},
          "rank_warm_s": {name: [r["warm_s"] for r in rs]
                          for name, rs in ranks.items()},
          "rank_wait_s": {name: [r["wait_s"] for r in rs]
                          for name, rs in ranks.items()}})
    return launched


def tp_serve_check(arch: str, whole: dict, rows: list, ranks: list,
                   out: str) -> dict:
    """The gates of setups h and i: the ranks' fp32 logits (prefill and
    each decode step, gathered over the data coordinates) within
    ``TP_FP32_REL`` of the largest logit of the unsharded run on the same
    params (the ranks' parts gathered whole), in this process; the greedy
    tokens equal; each rank's flash launches one a layer and decode
    launches one a layer and step; each rank's cache bytes those of its
    layout, less than the whole cache.  Returns the ranks' launches."""
    from repro_torch.checkpoint.checkpointer import _unflatten
    from repro_torch.models import lm

    cfg, _, _, _ = tp_setup(arch)
    D = TP_ARCHS[arch][1][0]
    t0 = time.perf_counter()
    want = tp_serve(cfg, _unflatten(lm.make_lm(cfg), whole), DEVICE)
    ref_s = time.perf_counter() - t0
    parts = [torch.load(f"{out}.{arch}.serve.{d}.pt") for d in range(D)]
    got = [torch.cat([p[i] for p in parts]) for i in range(len(parts[0]))]
    rel = [float((g - w).abs().max() / w.abs().max())
           for g, w in zip(got, want["logits"], strict=True)]
    same_tokens = all(torch.equal(g.argmax(-1), w.argmax(-1))
                      for g, w in zip(got, want["logits"], strict=True))
    layers = train_launches(cfg)["flash"][1]      # attention layers
    per_rank = {"flash_attention": layers,
                "decode_attention": layers * TP_SERVE_STEPS}
    emit({"phase": "tp", "setup": TP_SERVE[arch], "arch": arch,
          "what": "serve", "mesh": list(TP_ARCHS[arch][1]), "dtype": "fp32",
          "batch": list(TP_SERVE_BATCH), "decode_steps": TP_SERVE_STEPS,
          "logits_rel_vs_unsharded": rel, "tokens_equal": same_tokens,
          "unsharded_launches": want["launches"],
          "unsharded_seconds": ref_s,
          "ranks": [{"rank": rk["rank"], "coordinate": rk["coordinate"],
                     **r["serve"]} for rk, r in zip(ranks, rows,
                                                    strict=True)]})
    if max(rel) > TP_FP32_REL or not same_tokens:
        raise AssertionError(f"tp {TP_SERVE[arch]} {arch}: logits {rel} "
                             f"from the unsharded run's, tokens equal "
                             f"{same_tokens}")
    for rk, r in zip(ranks, rows, strict=True):
        sv = r["serve"]
        b = sv["cache_bytes"]
        if sv["launches"] != per_rank or b["held"] != b["counted_from_specs"] \
                or b["held"] >= b["whole"]:
            raise AssertionError(f"tp {TP_SERVE[arch]} {arch}: rank "
                                 f"{rk['rank']} launched {sv['launches']}, "
                                 f"want {per_rank}; cache bytes {b}")
    return {k: sum(r["serve"]["launches"][k] for r in rows)
            for k in per_rank}


def tp_local_shapes(cfg, mesh: tuple) -> dict:
    """{"flash": [(q, k, v) shapes], "ssd": [(x shape,)]}: what one rank of
    ``mesh`` passes the flash kernel and the SSD scan, its rows of the
    batch at its local heads (GQA's query and KV heads; MLA's heads at
    (D, Dv) = (nope + rope, v); the SSD heads), the MTP block's flash on
    the S - 1 positions after the first."""
    from repro_torch.sharding.tp import heads_split, ssm_heads_split

    m, b, S = mesh[1], TP_BATCH[0] // mesh[0], TP_BATCH[1]
    fam = train_launches(cfg)
    out: dict = {"flash": [], "ssd": []}
    if "flash" in fam:
        q_split, kv_split = heads_split(cfg, m)
        h = cfg.num_heads // m if q_split else cfg.num_heads
        if cfg.attention_kind == "mla":
            ml = cfg.mla
            qk = ml.qk_nope_head_dim + ml.qk_rope_head_dim
            dims = ((h, qk), (h, qk), (h, ml.v_head_dim))
        else:
            k = (cfg.num_kv_heads // m if kv_split
                 else max(1, h // (cfg.num_heads // cfg.num_kv_heads)))
            dims = ((h, cfg.head_dim), (k, cfg.head_dim), (k, cfg.head_dim))
        lengths = [S] + ([S - 1] if cfg.mtp_depth else [])
        out["flash"] = sorted(tuple((b, n, *d) for d in dims)
                              for n in lengths)
    if "ssd" in fam:
        s = cfg.ssm
        h = s.n_heads(cfg.d_model)
        if ssm_heads_split(cfg, m):
            h //= m
        out["ssd"] = [((b, S, h, s.head_dim),)]
    return out


def tp_check(arch: str, ref: dict, whole: dict, rows: list,
             ranks: list) -> dict:
    """The gates of ``phase_tp`` for one config; returns the ranks' flash
    and SSD launches."""
    cfg, _, _, job = tp_setup(arch)
    shape = TP_ARCHS[arch][1]
    want_shapes = {k: [[list(t) for t in c] for c in v]
                   for k, v in tp_local_shapes(cfg, shape).items()}
    fam = train_launches(cfg)
    per_run = dict.fromkeys(TP_KERNELS, 0)
    for family, names in (("flash", TP_KERNELS[:2]), ("ssd", TP_KERNELS[2:])):
        for name, n in zip(names, fam.get(family, (0, 0)), strict=True):
            per_run[name] = n * job.total_steps
    base = ref["unsharded"]["losses"]
    loss_gap = [max(abs(r["losses"][i] - base[i]) for r in rows)
                for i in range(len(base))]
    gaps, ok, num, den = {}, True, 0.0, 0.0
    for key, w in ref["final"].items():
        if tuple(whole[key].shape) != tuple(w.shape):
            raise AssertionError(f"tp {arch}: {key} gathered to "
                                 f"{tuple(whole[key].shape)}, not "
                                 f"{tuple(w.shape)}")
        if w.numel() == 0:      # deepseek's cut: the empty MoE stack
            continue
        # on the card, ``TP_CHECK_CHUNK`` elements at a time: the ranks of
        # the next configs hold most of it meanwhile
        gf, wf, gaps[key] = whole[key].reshape(-1), w.reshape(-1), 0.0
        for i in range(0, wf.numel(), TP_CHECK_CHUNK):
            g = gf[i:i + TP_CHECK_CHUNK].to(DEVICE).float()
            x = wf[i:i + TP_CHECK_CHUNK].to(DEVICE).float()
            gaps[key] = max(gaps[key], float((g - x).abs().max()))
            ok = ok and bool(torch.allclose(g, x, atol=DIST_PARAM_TOL,
                                            rtol=DIST_PARAM_TOL))
            num += float((g - x).square().sum())
            den += float(x.square().sum())
            del g, x
    fp32_rel = {k: max(abs(r["fp32"][k] - ref["fp32"][k]) / abs(
        ref["fp32"][k]) for r in rows) for k in ("loss", "grad_norm")}
    moe = moe_layers(cfg) > 0
    line = {"phase": "tp", "setup": TP_SETUPS[arch], "arch": arch,
            "mesh": list(shape), "optimizer": job.optimizer,
            "local_shapes": want_shapes,
            "ranks": [{"rank": rk["rank"], "coordinate": rk["coordinate"],
                       "backend": rk["backend"], "mode": r["mode"],
                       "losses": r["losses"],
                       "wall_ms_per_step": r["wall_ms_per_step"],
                       "peak_alloc_gib": r["peak_alloc_gib"],
                       "fp32_peak_alloc_gib": r["fp32_peak_alloc_gib"],
                       "param_bytes": r["param_bytes"],
                       "state_bytes": r["state_bytes"],
                       "launches": r["launches"],
                       "shapes": r["shapes"], "seconds": r["seconds"],
                       "turn_s": r["turn_s"], "save_s": r["save_s"],
                       "fp32_s": r["fp32_s"]}
                      for rk, r in zip(ranks, rows, strict=True)],
            "unsharded": {k: ref["unsharded"][k] for k in (
                "losses", "wall_ms_per_step", "peak_alloc_gib", "mode",
                "launches")},
            "loss_vs_unsharded": loss_gap,
            "param_max_abs_vs_unsharded": max(gaps.values()),
            "param_distance_vs_unsharded": math.sqrt(num / den),
            "params_within": DIST_PARAM_TOL if ok else None,
            "fp32": {"unsharded": ref["fp32"],
                     "ranks": [r["fp32"] for r in rows], "rel": fp32_rel}}
    if moe:
        line["fp32_ep_vs_gather"] = {k: max(abs(r["fp32_ep"][k]
                                                - r["fp32"][k])
                                            / abs(r["fp32"][k]) for r in rows)
                                     for k in ("loss", "grad_norm")}
    emit(line)
    if ref["unsharded"]["launches"] != per_run:
        raise AssertionError(f"tp {arch}: the unsharded run launched "
                             f"{ref['unsharded']['launches']}, want "
                             f"{per_run}")
    for rk, r in zip(ranks, rows, strict=True):
        if rk["backend"] != "gloo" or r["mode"] != "eager":
            raise AssertionError(f"tp {arch}: rank {rk['rank']} ran "
                                 f"{rk['backend']} {r['mode']}")
        if r["launches"] != per_run or r["shapes"] != want_shapes:
            raise AssertionError(f"tp {arch}: rank {rk['rank']} launched "
                                 f"{r['launches']} at {r['shapes']}, "
                                 f"want {per_run} at {want_shapes}")
        for what in ("param_bytes", "state_bytes"):
            b = r[what]
            if b["held"] != b["counted_from_specs"]:
                raise AssertionError(f"tp {arch}: rank {rk['rank']} {what} "
                                     f"{b}")
        if not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"tp {arch}: losses {r['losses']}")
    if max(loss_gap) > DIST_LOSS_TOL or not ok:
        raise AssertionError(f"tp {arch}: losses {loss_gap} from the "
                             f"unsharded run's, params within "
                             f"{DIST_PARAM_TOL}: {ok} (max {max(gaps.values())})")
    # (an MoE config's fp32 step is held by ep == gather instead: the sum
    # over the model axis rounds its layers' outputs in another order, so
    # a near-tie routing choice may flip, which moves its loss by more)
    if not moe and max(fp32_rel.values()) > TP_FP32_REL:
        raise AssertionError(f"tp {arch} fp32: {fp32_rel}")
    if moe and max(line["fp32_ep_vs_gather"].values()) > TP_FP32_REL:
        raise AssertionError(f"tp {arch}: ep vs gather "
                             f"{line['fp32_ep_vs_gather']}")
    return {k: sum(r["launches"][k] for r in rows) for k in TP_KERNELS}


# ---------------------------------------------------------------------------
# the dryrun phase: the ExpoCloud sweep of dry-run cells on the card
# ---------------------------------------------------------------------------
# (arch, shape, probe: the segment counts built, None for full depth;
# expected status; the kernel a captured cell must launch at least once per
# layer of its family, "attn" or "mamba")
DRYRUN_GRID = (
    ("smollm-360m", "prefill_32k", (2,), "ok", ("flash_attention", "attn")),
    ("smollm-360m", "decode_32k", (2,), "ok", ("decode_attention", "attn")),
    ("smollm-360m", "decode_32k", (3,), "ok", ("decode_attention", "attn")),
    ("mamba2-130m", "prefill_32k", (2,), "ok", ("ssd_scan", "mamba")),
    ("smollm-360m", "train_4k", (2,), "exceeds_device", None),
    ("smollm-360m", "decode_32k", None, "exceeds_device", None),
)
# the mesh cells: (arch, shape, probe, mesh shape over (data, model),
# expected status, the kernel each replay launches once a layer built);
# rank 0 of a fake world of 8 (``launch/dryrun.py``), its collectives
# counted, not run
DRYRUN_MESH_GRID = (
    ("musicgen-medium", "decode_32k", (2,), (2, 4), "ok",
     ("decode_attention", "attn")),
    ("qwen3-4b", "prefill_32k", (2,), (2, 4), "ok",
     ("flash_attention", "attn")),
)
# a captured cell's ``max_memory_allocated`` may lie this far from the meta
# trace's estimate (a share of the estimate, and GiB): the one-card cells come
# within 0.03 GiB
DRYRUN_PEAK_MARGIN = (0.05, 0.25)
DRYRUN_DEADLINE_S = 300.0
# the extrapolated full-depth decode_32k row's MODEL / counted FLOPs
USEFUL_RATIO_BAND = (0.9, 1.1)

# the sweep, run in a process that never touches CUDA: the local engine
# forks its client and worker processes, and each cell's dry-run runs in a
# process of its own, with its own CUDA context
_DRYRUN_SWEEP = r"""
import json, sys
from repro_torch.core.experiment import Experiment
from repro_torch.core.server import ServerConfig
from repro_torch.launch.sweep_dryrun import build_tasks

from repro_torch.core.sweep import DryRunCellTask

grid, mesh_grid, out, deadline, device = json.loads(sys.argv[1])
want = {(a, s, None if p is None else tuple(p)) for a, s, p in grid}
tasks = [t for t in build_tasks(sorted({a for a, _, _ in grid}),
                                sorted({s for _, s, _ in grid}), ["single"],
                                ["full", "probe"], deadline, out,
                                device=device)
         if (t.arch, t.shape, t.seg_counts) in want]
assert len(tasks) == len(want), [t.parameters() for t in tasks]
tasks += [DryRunCellTask(a, s, "single", tuple(p), {"unroll": 1}, deadline,
                         out, tag="x".join(map(str, m)), mesh_shape=m,
                         mesh_axes=("data", "model"), device=device)
          for a, s, p, m in mesh_grid]
config = ServerConfig(max_clients=1, use_backup=False,
                      health_update_limit=60.0,
                      instance_max_non_active_time=120.0, out_dir=None,
                      workers_hint=1)
exp = Experiment(tasks, engine="local",
                 engine_cfg={"n_workers_per_client": 1}, config=config)
with exp.run() as run:
    table = run.results(poll_sleep=0.2)
print(json.dumps({"parameter_titles": list(table.parameter_titles),
                  "result_titles": list(table.result_titles),
                  "rows": [[list(p), None if r is None else list(r), st]
                           for p, r, st in table.rows]}))
"""


def dryrun_mesh_closed_form(rec) -> float:
    """A dense prefill cell's collective bytes a chip: per layer an
    all-reduce (2x its payload) of the rank's [B, S, d] bf16 activations
    after attention and after the FFN, one after the embedding, and the
    all-gather of the last position's [B, V] bf16 logits (the closed form
    ``tests/test_torch_mesh_dryrun.py`` holds)."""
    from repro_torch.configs import get_config, get_shape

    cfg, shape = get_config(rec["arch"]), get_shape(rec["shape"])
    L = sum(rec["seg_counts"])
    B = shape.global_batch // rec["coordinate_sizes"]["data"]
    act = B * shape.seq_len * cfg.d_model * 2
    return 2.0 * (2 * L + 1) * act + B * cfg.vocab_size * 2


def dryrun_mesh_gates(rec, key) -> None:
    """A mesh cell's gates beyond the one-card cells': collective bytes
    above 0 (qwen3-4b's prefill at its closed form), and the allocator's
    peak within ``DRYRUN_PEAK_MARGIN`` of the estimate."""
    roof = rec["roofline"]
    if roof["collective_bytes_per_chip"] <= 0:
        raise AssertionError(f"dryrun {key}: no collective bytes counted")
    if rec["arch"] == "qwen3-4b" and rec["shape"] == "prefill_32k":
        sizes = dict(zip(("data", "model"),
                         (int(x) for x in re.findall(r"\d+", rec["mesh"])),
                         strict=True))
        want = dryrun_mesh_closed_form(dict(rec, coordinate_sizes=sizes))
        if roof["collective_bytes_per_chip"] != want:
            raise AssertionError(f"dryrun {key}: collective bytes "
                                 f"{roof['collective_bytes_per_chip']}, "
                                 f"closed form {want}")
    share, gib = DRYRUN_PEAK_MARGIN
    est, got = rec["peak_estimate_bytes"], rec["max_memory_allocated"]
    if got is None or abs(got - est) > max(share * est, gib * 2.0 ** 30):
        raise AssertionError(f"dryrun {key}: max_memory_allocated {got} "
                             f"against the estimate {est}")


def phase_dryrun() -> dict:
    """The port's dry-run sweep (``repro_torch.launch.sweep_dryrun``'s
    ``build_tasks`` and ``Experiment(engine="local")``: one client, one
    worker, each cell in its own subprocess, ``DRYRUN_DEADLINE_S`` a cell)
    over ``DRYRUN_GRID`` and the mesh cells of ``DRYRUN_MESH_GRID`` (rank
    0 of a fake world of 8, built at its local heads and rows): a line per
    cell (status, lower and compile s, the meta trace's peak estimate
    beside the allocator's peaks in GiB, counted FLOPs and bytes, the
    roofline terms, the kernels' launches per replay; a mesh cell's
    collectives by kind), then ``aggregate.assemble``'s row that
    extrapolates decode_32k to full depth from its two probes.  Gates:
    each cell's expected status; each captured cell's kernel launched at
    least once per layer it built (a mesh cell's exactly once); a mesh
    cell's collective bytes above 0 (at the closed form for qwen3-4b's
    prefill) and its allocator's peak within ``DRYRUN_PEAK_MARGIN`` of the
    estimate; the extrapolated row's useful ratio in
    ``USEFUL_RATIO_BAND``.  Returns the launches the cells' card stages
    ran, by kernel."""
    import os
    import tempfile

    from repro_torch.launch import aggregate

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()        # the cells' processes take the card
    gib = 2.0 ** 30
    ran: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as out:
        grid = [[a, s, None if p is None else list(p)]
                for a, s, p, _, _ in DRYRUN_GRID]
        mesh_grid = [[a, s, list(p), list(m)]
                     for a, s, p, m, _, _ in DRYRUN_MESH_GRID]
        proc = subprocess.run(
            [sys.executable, "-c", _DRYRUN_SWEEP,
             json.dumps([grid, mesh_grid, out, DRYRUN_DEADLINE_S, DEVICE])],
            capture_output=True, text=True, timeout=900, check=False,
            env={**os.environ, "PYTHONPATH": str(SRC)})
        if proc.returncode:
            raise AssertionError(f"dryrun sweep: rc {proc.returncode}\n"
                                 f"{proc.stdout[-4000:]}\n"
                                 f"{proc.stderr[-4000:]}")
        table = json.loads(proc.stdout.strip().splitlines()[-1])
        sweep_s = time.perf_counter() - t_phase
        titles = table["parameter_titles"]
        by_cell = {}
        for params, result, status in table["rows"]:
            p = dict(zip(titles, params, strict=True))
            by_cell[(p["arch"], p["shape"], p["probe"], p["id"])] = (
                result, status)
        cells = [(a, s, p, None, w, k) for a, s, p, w, k in DRYRUN_GRID] \
            + list(DRYRUN_MESH_GRID)
        for arch, shape, probe, mesh, want, kernel in cells:
            key = (arch, shape, "full" if probe is None
                   else "L" + "-".join(map(str, probe)),
                   "" if mesh is None else "x".join(map(str, mesh)))
            result, status = by_cell[key]
            if status != "done" or result is None or result[0] != want:
                raise AssertionError(f"dryrun {key}: {status} {result}, "
                                     f"expected {want}")
            rec = json.loads(Path(result[-1]).read_text())
            roof = rec["roofline"]

            def in_gib(name, rec=rec):
                return None if rec[name] is None else rec[name] / gib

            line = {"phase": "dryrun", "arch": arch, "shape": shape,
                    "probe": key[2], "status": rec["status"],
                    "lower_s": rec["lower_s"], "compile_s": rec["compile_s"],
                    "peak_estimate_gib": in_gib("peak_estimate_bytes"),
                    "max_memory_allocated_gib":
                        in_gib("max_memory_allocated"),
                    "max_memory_reserved_gib": in_gib("max_memory_reserved"),
                    "budget_gib": in_gib("budget_bytes"),
                    "inputs_gib": in_gib("bytes_per_device_inputs"),
                    "flops": roof["hlo_flops"], "bytes": roof["hlo_bytes"],
                    "counted": rec["counted"],
                    "model_flops": roof["model_flops"],
                    "compute_ms": roof["compute_s"] * 1e3,
                    "memory_ms": roof["memory_s"] * 1e3,
                    "collective_ms": roof["collective_s"] * 1e3,
                    "dominant": roof["dominant"],
                    "useful_ratio": roof["useful_ratio"],
                    "kernels_counted": rec["kernels"],
                    "kernel_launches": rec["kernel_launches"],
                    "launches_run": rec["launches_run"],
                    "layers_built": rec["layers_built"], "mesh": rec["mesh"],
                    "chips": rec["chips"]}
            if mesh is not None:
                line.update(rank=rec["rank"], coordinate=rec["coordinate"],
                            collectives=rec["collectives"],
                            collective_bytes_per_chip=roof[
                                "collective_bytes_per_chip"],
                            collectives_by_kind=roof["collectives"],
                            collective_counts=roof["collective_counts"])
            emit(line)
            if mesh is not None:
                dryrun_mesh_gates(rec, key)
            if kernel is not None:
                name, family = kernel
                n = rec["kernel_launches"].get(name, 0)
                if n < rec["layers_built"][family] or (
                        mesh is not None
                        and n != rec["layers_built"][family]):
                    raise AssertionError(
                        f"dryrun {key}: {name} launched "
                        f"{rec['kernel_launches']} a replay for "
                        f"{rec['layers_built']} layers")
            for k, n in rec["launches_run"].items():
                ran[k] = ran.get(k, 0) + n
        rows = aggregate.assemble(out)
    row = next(r for r in rows
               if r["arch"] == "smollm-360m" and r["shape"] == "decode_32k")
    emit({"phase": "dryrun", "what": "aggregate.assemble, decode_32k "
          "extrapolated to full depth from the probes (2,) and (3,)",
          **{k: row.get(k) for k in ("arch", "shape", "status",
                                     "status_roofline", "compute_s",
                                     "memory_s", "collective_s", "dominant",
                                     "useful_ratio", "roofline_fraction",
                                     "model_flops", "hlo_flops")},
          "sweep_s": sweep_s, "seconds": time.perf_counter() - t_phase})
    lo, hi = USEFUL_RATIO_BAND
    if row.get("status_roofline") != "extrapolated" \
            or not lo <= row["useful_ratio"] <= hi:
        raise AssertionError(f"dryrun: the extrapolated decode_32k row "
                             f"{row}, useful ratio outside {USEFUL_RATIO_BAND}")
    return ran


# ---------------------------------------------------------------------------
# the tune phase: sweeps of the four ported kernels' tiles
# ---------------------------------------------------------------------------
TUNE_KERNELS = ("flash_attention", "decode_attention",
                "decode_attention_paged", "ssd_scan")


def tune_call(kernel: str, shape: dict, config: dict | None):
    """(fn, args, plain, tol): one call of ``kernel`` through ``ops`` at
    ``shape`` in bf16 with ``config``'s knobs named (None: none named, the
    dispatch resolves them), its plain version on the same rows, and the
    tolerance.  Inputs come from seed 0, so every config of a kernel sees
    the same rows; the paged call cuts them into a pool of the config's
    page size (the pool the engine would build), held against the dense
    plain version."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    bf, knobs = torch.bfloat16, dict(config or {})
    if kernel == "flash_attention":
        b, s, h, kvh, d = (shape[k] for k in ("b", "s", "h", "kvh", "d"))
        q, k, v = (rand((b, s, n, d), bf, gen) for n in (h, kvh, kvh))
        return ((lambda q, k, v: ops.flash_attention(q, k, v, **knobs)),
                (q, k, v), lambda: fa.flash_attention_plain(q, k, v), TOL)
    if kernel == "ssd_scan":
        b, s, h, p, g, n = (shape[k] for k in ("b", "s", "h", "p", "g", "n"))
        x = rand((b, s, h, p), bf, gen)
        dt = torch.nn.functional.softplus(rand((b, s, h), torch.float32, gen))
        A = -torch.exp(rand((h,), torch.float32, gen) * 0.3)
        Bm, Cm = rand((b, s, g, n), bf, gen), rand((b, s, g, n), bf, gen)
        chunk = knobs.get("chunk", 64)
        return ((lambda *a: ops.ssd_scan(*a, **knobs)), (x, dt, A, Bm, Cm),
                lambda: ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk),
                SSD_TOL)
    b, sk, d = shape["b"], shape["sk"], shape["d"]
    kvh = shape["kvh"]
    h = shape["h"] if "h" in shape else kvh * shape["g"]
    q = rand((b, h, d), bf, gen)
    k, v = rand((b, sk, kvh, d), bf, gen), rand((b, sk, kvh, d), bf, gen)
    kv_len = torch.tensor([sk - (i * sk // (2 * b)) for i in range(b)],
                          dtype=torch.int32, device=DEVICE)

    def plain():
        return da.decode_attention_plain(q, k, v, kv_len)
    if kernel == "decode_attention":
        return ((lambda *a: ops.decode_attention(*a, **knobs)),
                (q, k, v, kv_len), plain, TOL)
    ps = knobs.get("page_size", 16)
    w = -(-sk // ps)

    def pool(t):
        t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, w * ps - sk))
        return t.reshape(b * w, ps, kvh, d).contiguous()
    table = torch.arange(b * w, dtype=torch.int32,
                         device=DEVICE).reshape(b, w)
    return (ops.decode_attention_paged, (q, pool(k), pool(v), table, kv_len),
            plain, TOL)


@contextlib.contextmanager
def recorded_knobs(kernel: str, seen: list):
    """The keyword arguments ``ops`` hands ``kernel``'s wrapper, appended
    to ``seen``; the wrapper does not run (its launch count is its
    module's global, which the stand-in would shadow)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    mod = {"flash_attention": fa, "decode_attention": da,
           "ssd_scan": ssd}[kernel]
    wrapper = getattr(mod, kernel)

    def spy(*args, **kwargs):
        seen.append(kwargs)
    setattr(mod, kernel, spy)
    try:
        yield
    finally:
        setattr(mod, kernel, wrapper)


def tuned_resolution(kernel: str, shape: dict) -> dict:
    """The knobs a call with none named resolves to, read where they
    reach the wrapper (the paged kernel's page size: where the engine
    builds its pool, at smollm-360m's serving geometry)."""
    if kernel == "decode_attention_paged":
        from repro_torch.configs import get_config
        from repro_torch.serve.engine import _resolve_page_size

        return {"page_size": _resolve_page_size(get_config("smollm-360m"),
                                                shape["b"], shape["sk"],
                                                DEVICE)}
    from repro_torch.tune.space import SPECS

    fn, args, _, _ = tune_call(kernel, shape, None)
    seen: list = []
    with recorded_knobs(kernel, seen):
        fn(*args)
    got = {k: seen[-1][k] for k in SPECS[kernel].tunables}
    if kernel == "decode_attention" and got["block_k"] is None:
        got["block_k"] = SPECS[kernel].default_config(shape)["block_k"]
    return got


# a worker as the LocalEngine makes one: forked from a process that has
# imported torch and not touched CUDA; it times its own start-up
_WORKER_PROBE = r"""
import json, multiprocessing as mp, sys, time
import torch

def worker(q, t_fork):
    from repro_torch.kernels import cuda_build, ops
    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")
    t1 = time.perf_counter()
    cuda_build.library()
    t2 = time.perf_counter()
    q_ = torch.randn(8, 15, 64, device="cuda", dtype=torch.bfloat16)
    k = torch.randn(8, 1024, 5, 64, device="cuda", dtype=torch.bfloat16)
    n = torch.full((8,), 1024, dtype=torch.int32, device="cuda")
    ops.decode_attention(q_, k, k, n)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    q.put({"fork_s": t0 - t_fork, "cuda_context_s": t1 - t0,
           "library_s": t2 - t1, "first_call_s": t3 - t2,
           "total_s": t3 - t_fork})

if __name__ == "__main__":
    ctx = mp.get_context("fork")
    q, runs = ctx.Queue(), []
    for _ in range(3):
        p = ctx.Process(target=worker, args=(q, time.perf_counter()))
        p.start()
        runs.append(q.get(timeout=120))
        p.join()
    print(json.dumps(runs))
"""


def phase_tune(cfg, DecodeEngine, Request, da, lm, dense) -> dict:
    """The tuner on the card (``repro_torch.tune``), after every other path,
    with the run's fresh cache (``REPRO_TORCH_TUNE_CACHE``):

    * with the cache empty, a call naming no knob launches what it did
      before the knobs (bit for bit the explicit default's output; the
      engine's page size 16);
    * a simulator-engine sweep of each kernel at its ``full_shape`` in
      bf16 with the pathological values (``adversarial``), the survivors
      measured in this process; every config of every grid held against
      the plain version and timed (the profiler's device ms and
      queue-primed CUDA-event ms);
    * one ``engine="local"`` sweep of the decode kernel through the CLI in
      a subprocess (forked workers, each with its own CUDA context);
    * after the sweeps a call naming no knob resolves to the cached best,
      and a paged smollm-360m engine built with ``page_size=None`` serves
      at the tuned page size with greedy tokens equal to ``dense``.

    Returns the per-kernel lines."""
    import os
    import tempfile

    from repro_torch.tune import cache as tune_cache
    from repro_torch.tune.space import SPECS, build_space
    from repro_torch.tune.tuner import LOCAL_COMPILE_MARGIN_S, tune

    t_phase = time.perf_counter()
    # no knob, empty cache: today's launch
    for kernel in TUNE_KERNELS:
        shape = SPECS[kernel].full_shape
        default = SPECS[kernel].default_config(shape)
        got = tuned_resolution(kernel, shape)
        if got != default:
            raise AssertionError(f"tune {kernel}: an empty cache resolved "
                                 f"{got}, not the default {default}")
        if kernel != "decode_attention_paged":
            fn, args, _, _ = tune_call(kernel, shape, None)
            fe, ea, _, _ = tune_call(kernel, shape, default)
            if not torch.equal(fn(*args), fe(*ea)):
                raise AssertionError(f"tune {kernel}: no knob and the "
                                     f"explicit default {default} differ")
    emit({"phase": "tune", "what": "empty cache", "cache":
          tune_cache.get_cache().path, "no_knob_equals_default": True})

    lines = {}
    for kernel in TUNE_KERNELS:
        spec = SPECS[kernel]
        shape = spec.full_shape
        t0 = time.perf_counter()
        rep = tune(kernel, engine="sim", dtype="bfloat16", adversarial=4,
                   device=DEVICE)
        seconds = time.perf_counter() - t0
        # every config of the grid against the plain version, and its
        # device time from the profiler and from queue-primed CUDA events
        # (the sweep measures wall time per blocked call, which at these
        # shapes is mostly the host's; a trace that lost some of a call's
        # kernels reads low, which the events show)
        errs, device_ms, event_ms = {}, {}, {}
        for cell in build_space(kernel, shape, dtype="bfloat16",
                                adversarial=4).cells():
            config = {k: cell[k] for k in spec.tunables}
            fn, args, plain, tol = tune_call(kernel, shape, config)
            key = json.dumps(config)
            errs[key] = check_close(f"tune {kernel} {config}", fn(*args),
                                    plain(), torch.bfloat16, tol)
            tensors = [a for a in args if a.dtype != torch.int32]
            fixed = tuple(a for a in args if a.dtype == torch.int32)
            argsets = [c + fixed for c in copies(tensors, nbytes(*tensors))]
            device_ms[key] = time_ms(fn, argsets)[0]
            event_ms[key] = primed_event_ms(fn, argsets)
        if len(errs) != rep.explored:
            raise AssertionError(f"tune {kernel}: checked {len(errs)} of "
                                 f"{rep.explored} configs")
        default_key = json.dumps(rep.default_config)
        best_key = json.dumps(rep.best_config)
        default_ms, best_ms = device_ms[default_key], device_ms[best_key]
        got = tuned_resolution(kernel, shape)
        if got != rep.best_config:
            raise AssertionError(f"tune {kernel}: no knob resolved {got}, "
                                 f"the cache holds {rep.best_config}")
        if kernel != "decode_attention_paged":
            fn, args, _, _ = tune_call(kernel, shape, None)
            fb, ba, _, _ = tune_call(kernel, shape, rep.best_config)
            if not torch.equal(fn(*args), fb(*ba)):
                raise AssertionError(f"tune {kernel}: no knob and the "
                                     "cached best differ")
        lines[kernel] = {
            "phase": "tune", "kernel": kernel, "shape": shape,
            "dtype": "bfloat16", "engine": "sim",
            "default_config": rep.default_config,
            "default_us": rep.default_us, "best_config": rep.best_config,
            "best_us": rep.best_us, "speedup": rep.speedup,
            "default_device_ms": default_ms, "best_device_ms": best_ms,
            "device_speedup": default_ms / best_ms,
            "device_ms_by_config": device_ms,
            "default_event_ms": event_ms[default_key],
            "best_event_ms": event_ms[best_key],
            "event_ms_by_config": event_ms,
            "explored": rep.explored, "measured": rep.measured,
            "pruned": rep.pruned, "timed_out": rep.timed_out,
            "sweep_seconds": seconds, "backend": rep.backend,
            "configs": rep.configs, "max_abs_err_by_config": errs,
            "no_knob_resolves_best": True}
        emit(lines[kernel])

    # the local engine: forked workers on the card, through the CLI; first
    # what a forked worker's start costs (LOCAL_COMPILE_MARGIN_S covers it)
    env = {**os.environ,
           "PYTHONPATH": str(SRC)}
    probe = subprocess.run([sys.executable, "-c", _WORKER_PROBE],
                           capture_output=True, text=True, timeout=300,
                           check=True, env=env)
    runs = json.loads(probe.stdout.strip().splitlines()[-1])
    emit({"phase": "tune", "what": "forked worker start-up", "runs": runs,
          "max_total_s": max(r["total_s"] for r in runs),
          "local_margin_s": LOCAL_COMPILE_MARGIN_S})
    if max(r["total_s"] for r in runs) > LOCAL_COMPILE_MARGIN_S:
        raise AssertionError(f"tune: a forked worker took longer to start "
                             f"than LOCAL_COMPILE_MARGIN_S: {runs}")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "local.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.tune", "--kernel",
             "decode_attention", "--engine", "local", "--dtype", "bfloat16",
             "--max-clients", "1", "--device", DEVICE, "--cache",
             os.path.join(tmp, "local_cache.json"), "--json", out],
            capture_output=True, text=True, timeout=300, check=False,
            env=env)
        seconds = time.perf_counter() - t0
        if proc.returncode:
            raise AssertionError(f"tune CLI, local engine: rc "
                                 f"{proc.returncode}\n{proc.stdout}\n"
                                 f"{proc.stderr[-4000:]}")
        (rep,) = json.loads(Path(out).read_text())
    statuses = [c["status"] for c in rep["configs"]]
    emit({"phase": "tune", "kernel": "decode_attention", "engine": "local",
          "cli": "python -m repro_torch.tune --kernel decode_attention "
                 "--engine local --dtype bfloat16 --max-clients 1",
          "seconds": seconds, "elapsed_s": rep["elapsed_s"],
          "timeout_s": rep["timeout_s"], "statuses": statuses,
          "default_us": rep["default_us"], "best_us": rep["best_us"],
          "best_config": rep["best_config"], "explored": rep["explored"],
          "measured": rep["measured"], "backend": rep["backend"],
          "runtime_us": [c.get("runtime_us") for c in rep["configs"]]})
    if "done" not in statuses:
        raise AssertionError(f"tune CLI, local engine: no config done "
                             f"{statuses}")

    # the engine builds its pool at the tuned page size
    ps = lines["decode_attention_paged"]["best_config"]["page_size"]
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    params = lm.init_lm(cfg, gen, DEVICE)
    tokens, stats = serve(cfg, params, DecodeEngine, Request,
                          prompts_for(cfg, n=SMALL_MODEL_REQUESTS),
                          da.decode_attention_paged, "tuned_paged", "graph",
                          kv_layout="paged", page_size=None)
    if stats["page_size"] != ps:
        raise AssertionError(f"tune: the engine built pages of "
                             f"{stats['page_size']}, the cache holds {ps}")
    if tokens != dense:
        raise AssertionError(f"tune: paged tokens at page size {ps} differ "
                             f"from dense for requests {differ(tokens, dense)}")
    del params
    torch.cuda.empty_cache()
    emit({"phase": "tune", "what": "tuned paged serving", "page_size": ps,
          "tokens_equal_dense": True,
          "seconds": time.perf_counter() - t_phase})
    return lines


# ---------------------------------------------------------------------------
# the reference's examples on the port
# ---------------------------------------------------------------------------
# train_lm's run at full width (mamba2-130m, [4, 256], AdamW, a checkpoint
# every 25 steps), EXAMPLE_STEPS steps and not the example docstring's 300:
# the injected failure after step 25 then resumes from the step-25
# checkpoint, and each run writes its 1.8 GB checkpoint 4 times, not 13
EXAMPLE_STEPS = 75
EXAMPLE_TRAIN = ["--preset", "full", "--arch", "mamba2-130m", "--seq", "256",
                 "--batch", "4", "--steps", str(EXAMPLE_STEPS)]
EXAMPLE_TIMEOUT_S = 400
_EXAMPLE_PRELUDE = ("import runpy, torch._dynamo; runpy.run_module("
                    "'repro_torch.examples.train_lm', run_name='__main__', "
                    "alter_sys=True)")


@contextlib.contextmanager
def captured_stdout(box: list):
    """This process's standard output, file descriptor 1 (so a child
    process's too), appended to ``box`` as text when the block ends."""
    import os
    import tempfile

    sys.stdout.flush()
    saved = os.dup(1)
    with tempfile.TemporaryFile() as f:
        os.dup2(f.fileno(), 1)
        try:
            yield
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
            f.seek(0)
            box.append(f.read().decode(errors="replace"))


def example_part(part: str, smi: str, counters: dict, fn, *args, **kwargs):
    """Run one example entry point with its output captured; print its
    line (wall seconds, what it printed, its kernel launches, the card's
    name and power limit) and return (its value, its printed lines)."""
    before = {k: c.launches for k, c in counters.items()}
    box: list = []
    t0 = time.perf_counter()
    with captured_stdout(box):
        out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    printed = box[0].splitlines()
    emit({"phase": "examples", "part": part, "seconds": seconds,
          "printed": printed,
          "launches": {k: c.launches - before[k] for k, c in counters.items()
                       if c.launches != before[k]},
          "card": smi})
    return out, printed


def printed_result(printed: list, part: str) -> tuple:
    """The tuple of train_lm's ``[train_lm] result:`` line."""
    import ast

    lines = [ln for ln in printed if ln.startswith("[train_lm] result:")]
    if len(lines) != 1:
        raise AssertionError(f"{part}: no single result line in {printed}")
    return ast.literal_eval(lines[0].split(":", 1)[1].strip())


def first_token_difference(lm, cfg, params, got: list, want: list) -> dict:
    """The first (request, position) whose greedy tokens differ between
    two serves of the same prompts, and the top-2 logit margin there of
    ``params`` through ``lm.prefill`` on the prompt and the tokens before
    it (call it under the path whose margin is wanted)."""
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        for j, (a, b) in enumerate(zip(g.output, w.output, strict=True)):
            if int(np.asarray(a).flat[0]) == int(np.asarray(b).flat[0]):
                continue
            seq = np.concatenate([np.asarray(g.prompt).reshape(-1),
                                  [int(np.asarray(t).flat[0])
                                   for t in w.output[:j]]])
            tokens = torch.tensor(seq, dtype=torch.int32, device=DEVICE)
            with torch.no_grad():
                logits, _ = lm.prefill(cfg, params, {"tokens": tokens[None]})
            top = logits.float()[0].topk(2).values
            return {"request": i, "position": j,
                    "got": int(np.asarray(a).flat[0]),
                    "want": int(np.asarray(b).flat[0]),
                    "top2_margin": (top[0] - top[1]).item()}
    return {}


def phase_examples(lm, ops, ref, counters: dict, smi: str) -> dict:
    """The reference's three examples through the port's entry points
    (``repro_torch.examples``) on the card, each part's line with its wall
    seconds, what it printed, its launches by kernel and the card's name
    and power limit.

    First ``python -m repro_torch.examples.train_lm --expocloud
    --fail-once`` at full width (``EXAMPLE_TRAIN``: mamba2-130m, [4, 256],
    through the SSD scan's forward and backward kernels) starts in a
    process of its own (``LocalEngine`` forks the client and its workers,
    whose CUDA needs a parent that never initialised it; each worker
    loads the built library) and runs while this process runs the rest,
    in order:

    - serve_lm's ``serve`` at the example's defaults (reduced mamba2-130m,
      weights from ``lm.init_lm`` at seed 0, 3 slots, 6 requests, 12 new
      tokens, greedy) in bf16; its prompts go one token a decode step, as
      the reference's, so no kernel runs there.  Then in fp32
      (``cast_tree``) with 2-token prefill chunks, whose chunks go through
      the SSD scan at (P, N) = (32, 16), once through the kernel and once
      through the plain version (``plain_ssd``): the greedy tokens must be
      equal (on a mismatch the line names the first position that differs
      and its top-2 logit margin on the plain path first);
    - train_lm's ``main --fail-once`` at its defaults (reduced
      smollm-360m, 300 steps of [4, 64], the flash kernels at D 32): the
      injected failure after step 100, then the rerun restores the
      step-100 checkpoint and ends at step 300;
    - quickstart's sweep (the simulated cloud) and train sections;
    - train_lm's ``main`` with ``EXAMPLE_TRAIN``, uninterrupted;
    - quickstart's dry-run section, which runs in its own process as the
      reference's does: mamba2-130m's train_4k cell lowered on ``meta``
      and compiled on the card where it fits.

    Then the ExpoCloud run's CSV row must end at ``EXAMPLE_STEPS``, done,
    with the uninterrupted run's last loss and below its own first loss,
    after the failed worker's task was re-assigned and restored the
    step-25 checkpoint.  The parts' walls overlap the subprocess's; its
    launches are its own, not counted here."""
    import os
    import tempfile

    t_phase = time.perf_counter()
    out = {}
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=str(SRC) + (os.pathsep + path
                                                  if path else ""))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_expocloud_") as cd, \
            open(os.path.join(cd, "stdout"), "w+") as so, \
            open(os.path.join(cd, "stderr"), "w+") as se:
        ckpt_dir = os.path.join(cd, "ckpt")
        # the example's module run as ``-m`` runs it, after the first
        # train step's imports (``tp_warm_up``), which the forked workers
        # then find made
        proc = subprocess.Popen(
            [sys.executable, "-c", _EXAMPLE_PRELUDE, "--expocloud",
             "--fail-once", *EXAMPLE_TRAIN, "--device", "cuda",
             "--ckpt-dir", ckpt_dir], stdout=so, stderr=se, env=env)
        try:
            out.update(examples_in_process(lm, ops, ref, counters, smi))
            proc.wait(timeout=EXAMPLE_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        seconds = time.perf_counter() - t_phase
        marker = os.path.exists(os.path.join(ckpt_dir, ".failed_once"))
        so.seek(0)
        se.seek(0)
        printed, stderr = so.read().splitlines(), se.read()
    straight = out["train_lm_uninterrupted"]
    rows = [i for i, ln in enumerate(printed)
            if ln.startswith("arch,preset,steps,id,final_step,")]
    rec = (dict(zip(printed[rows[-1]].split(","),
                    printed[rows[-1] + 1].split(","), strict=True))
           if rows and rows[-1] + 1 < len(printed) else {})
    emit({"phase": "examples", "part": "train_lm --expocloud --fail-once "
          + " ".join(EXAMPLE_TRAIN), "seconds": seconds,
          "seconds_include": "the phase's in-process parts, run meanwhile",
          "rc": proc.returncode, "printed": printed,
          "stderr_tail": stderr[-2000:], "csv_row": rec,
          "uninterrupted_result": straight,
          "steps_note": f"{EXAMPLE_STEPS} steps, not the docstring's 300",
          "launches": "the subprocess's workers' own, not counted here",
          "card": smi})
    if proc.returncode != 0 or not rec:
        raise AssertionError(f"train_lm --expocloud: rc {proc.returncode}: "
                             f"{stderr[-2000:]}")
    if not (marker and rec["status"] == "done"
            and int(rec["final_step"]) == EXAMPLE_STEPS
            and "[train] restored checkpoint at step 25" in printed):
        raise AssertionError(f"train_lm --expocloud: {rec}, marker {marker}")
    if float(rec["last_loss"]) != straight[2]:
        raise AssertionError(f"train_lm --expocloud: last loss "
                             f"{rec['last_loss']}, uninterrupted {straight}")
    if not float(rec["last_loss"]) < float(rec["first_loss"]):
        raise AssertionError(f"train_lm --expocloud: the loss did not fall: "
                             f"{rec}")
    out["train_lm_expocloud"] = rec
    emit({"phase": "examples", "part": "all", "card": smi,
          "seconds": time.perf_counter() - t_phase})
    return out


def examples_in_process(lm, ops, ref, counters: dict, smi: str) -> dict:
    """``phase_examples``'s parts in this process, in its order; returns
    serve_lm's bf16 tokens and train_lm's results."""
    import tempfile

    from repro_torch.configs import reduced_config
    from repro_torch.examples import quickstart, serve_lm, train_lm
    from repro_torch.models.params import cast_tree

    out = {}
    cfg = reduced_config("mamba2-130m")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    params = lm.init_lm(cfg, gen, DEVICE)
    bf16, _ = example_part("serve_lm bf16, the example's defaults", smi,
                           counters, serve_lm.serve, cfg, params,
                           device=DEVICE)
    if not all(r.done and len(r.output) == 12 and all(
            0 <= int(t) < cfg.vocab_size for t in r.output) for r in bf16):
        raise AssertionError("serve_lm bf16: a request not served whole")
    cfg32, p32 = cfg.replace(dtype="float32"), cast_tree(params,
                                                         torch.float32)
    before = counters["ssd_scan"].launches
    kern, _ = example_part("serve_lm fp32, prefill chunk 2, kernels", smi,
                           counters, serve_lm.serve, cfg32, p32,
                           prefill_chunk=2, device=DEVICE)
    if counters["ssd_scan"].launches == before:
        raise AssertionError("serve_lm fp32: the SSD scan never launched")
    with plain_ssd(ops, ref):
        plain, _ = example_part("serve_lm fp32, prefill chunk 2, plain", smi,
                                counters, serve_lm.serve, cfg32, p32,
                                prefill_chunk=2, device=DEVICE)
        diff = first_token_difference(lm, cfg32, p32, kern, plain)
    emit({"phase": "examples", "part": "serve_lm fp32 tokens",
          "kernel_equal_plain": not diff, "first_difference": diff,
          "card": smi})
    if diff:
        raise AssertionError(f"serve_lm fp32: kernel tokens differ from the "
                             f"plain path's: {diff}")
    out["serve_lm"] = [[int(t) for t in r.output] for r in bf16]
    del params, p32
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_lm_") as td:
        _, printed = example_part("train_lm --fail-once, the defaults", smi,
                                  counters, train_lm.main,
                                  ["--fail-once", "--ckpt-dir", td])
    res = printed_result(printed, "train_lm --fail-once")
    if not (any(ln.startswith("[train_lm] injected failure") for ln in printed)
            and "[train] restored checkpoint at step 100" in printed
            and res[0] == 300 and all(map(math.isfinite, res[1:]))):
        raise AssertionError(f"train_lm --fail-once: {printed}")
    out["train_lm"] = res
    example_part("quickstart sweep", smi, counters, quickstart.sweep)
    _, printed = example_part("quickstart train", smi, counters,
                              quickstart.train)
    if not printed[-1].startswith("[2] trained reduced smollm: loss "):
        raise AssertionError(f"quickstart train: {printed}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_lm_") as td:
        _, printed = example_part(
            f"train_lm {' '.join(EXAMPLE_TRAIN)}, uninterrupted", smi,
            counters, train_lm.main, EXAMPLE_TRAIN + ["--ckpt-dir", td])
    out["train_lm_uninterrupted"] = printed_result(printed,
                                                   "train_lm uninterrupted")
    torch.cuda.empty_cache()
    _, printed = example_part("quickstart dryrun", smi, counters,
                              quickstart.dryrun)
    if not any(ln.startswith("[dryrun] mamba2-130m x train_4k on ")
               for ln in printed):
        raise AssertionError(f"quickstart dryrun: {printed}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_build, ops, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import lm
    from repro_torch.serve.engine import DecodeEngine, Request

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a fresh tune cache: no run reads one from ~/.cache, and every path
    # before the tune phase runs the kernels' defaults
    import os
    import shutil
    import tempfile

    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    os.environ["REPRO_TORCH_TUNE_CACHE"] = os.path.join(tune_dir,
                                                        "tune_cache.json")
    t_start = time.perf_counter()
    smi, name = phase_device()
    phase_build(cuda_build)
    # first, while this process holds next to nothing on the card: each
    # cell's process takes up to 90% of the free memory
    t0 = time.perf_counter()
    dryrun_launches = phase_dryrun()
    emit({"phase": "main_path", "path": "dryrun",
          "seconds": time.perf_counter() - t0, "launches": dryrun_launches,
          "counted_in": "each cell's process (the card stage's warm-up and "
                        "one replay)"})
    rows = phase_kernels(fa, da, cuda_build)
    rows.update(phase_kernels_paged(da))
    rows.update(phase_kernels_ssd(ssd))
    rows.update(phase_kernels_bwd(fa, cuda_build))
    rows.update(phase_kernels_ssd_bwd(ssd, cuda_build))
    wide_rows = phase_kernels_wide(da, cuda_build)

    counters = {"flash_attention": fa.flash_attention,
                "flash_attention_bwd": fa.flash_attention_bwd,
                "decode_attention": da.decode_attention,
                "decode_attention_paged": da.decode_attention_paged,
                "ssd_scan": ssd.ssd_scan,
                "ssd_scan_bwd": ssd.ssd_scan_bwd}

    def drive(path: str, kernels: tuple, fn, *args, **kwargs):
        """Run one main path with every launch count set to 0 just before
        it; read its kernels' counts just after (printed with the path's
        seconds), and fail on one that never launched."""
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        got = {k: counters[k].launches for k in kernels}
        emit({"phase": "main_path", "path": path,
              "seconds": time.perf_counter() - t0, "launches": got,
              "other_launches": {k: c.launches for k, c in counters.items()
                                 if k not in kernels}})
        for kernel, n in got.items():
            if n <= 0:
                raise AssertionError(f"{kernel} never launched on the {path} "
                                     "path")
        for kernel, n in got.items():
            launches[kernel] = launches.get(kernel, 0) + n
        return out

    launches: dict = {}
    # the train paths' kernel families: {family: (forward, backward)}
    flash = {"flash": (fa.flash_attention, fa.flash_attention_bwd)}
    scan = {"ssd": (ssd.ssd_scan, ssd.ssd_scan_bwd)}
    cfg = get_config("smollm-360m").replace(
        num_layers=SERVE_LAYERS["smollm-360m"])
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
    # the graph turns alone on the first three paths' profiles and on
    # dense and paged time to first token (the eager turns run on the later
    # paths, and mamba's time to first token), to make room for the dryrun
    # phase
    phase_profile(cfg, params, DecodeEngine, Request, "dense",
                  turns=("graph",))
    phase_profile(cfg, params, DecodeEngine, Request, "paged",
                  turns=("graph",), kv_layout="paged", page_size=16)
    phase_ttft(cfg, params, DecodeEngine, Request, "dense", modes=("graph",))
    phase_ttft(cfg, params, DecodeEngine, Request, "paged", modes=("graph",),
               kv_layout="paged", page_size=16)
    check_split_counters(da)
    del params
    torch.cuda.empty_cache()
    drive("mamba2-130m", ("ssd_scan",), phase_mamba, lm, ops, ref, ssd,
          DecodeEngine, Request)
    torch.cuda.empty_cache()
    # smollm-360m, mamba2-130m, musicgen-medium and phi-3-vision-4.2b train
    # cut to a quarter of their depth, olmoe-1b-7b to 2 layers, to make
    # room for the tp phase (PR 33)
    drive("train smollm-360m", ("flash_attention", "flash_attention_bwd"),
          phase_train, lm, "smollm-360m", flash,
          lambda: plain_attention(ops, ref), layers=8)
    torch.cuda.empty_cache()
    drive("train mamba2-130m", ("ssd_scan", "ssd_scan_bwd"), phase_train, lm,
          "mamba2-130m", scan, lambda: plain_ssd(ops, ref), layers=6)
    torch.cuda.empty_cache()
    drive("examples", ("flash_attention", "flash_attention_bwd", "ssd_scan",
                       "ssd_scan_bwd"), phase_examples, lm, ops, ref,
          counters, smi)
    # the dense configs trained at full width, cut in depth for the run's
    # time (the init lines give the cut, and the meta trace's estimate of
    # the cut config's step)
    for arch, layers, memory in TRAIN_DENSE:
        torch.cuda.empty_cache()
        drive(f"train {arch}", ("flash_attention", "flash_attention_bwd"),
              phase_train, lm, arch, flash,
              lambda: plain_attention(ops, ref), layers=layers,
              paths_batch=(1, 1024), memory=memory, plan=True)
    for arch in ("qwen3-4b", "chatglm3-6b", "granite-20b"):
        paths = ("flash_attention", "decode_attention") + (
            ("decode_attention_paged",) if arch == "granite-20b" else ())
        drive(arch, paths, phase_arch, arch, lm, ops, ref, fa, da,
              DecodeEngine, Request, layers=SERVE_LAYERS[arch],
              **(dict(paged="graph", small_pool=True)
                 if arch == "granite-20b" else {}))
    drive("olmoe-1b-7b", ("flash_attention", "decode_attention",
                          "decode_attention_paged"), phase_arch,
          "olmoe-1b-7b", lm, ops, ref, fa, da, DecodeEngine, Request,
          paged="modes", small_pool=True, layers=SERVE_LAYERS["olmoe-1b-7b"],
          requests=SMALL_MODEL_REQUESTS)
    drive("deepseek-v3-671b", ("flash_attention",), phase_arch,
          "deepseek-v3-671b", lm, ops, ref, fa, da, DecodeEngine, Request,
          paged="modes", layers=4, requests=SMALL_MODEL_REQUESTS)
    # jamba-v0.1-52b serves its super-block cut to 4 layers (the published
    # positions 4-7: attention, Mamba with the MoE, Mamba, Mamba with the
    # MoE), to keep the run inside its time limit with the tp phase
    drive("jamba-v0.1-52b", ("flash_attention", "decode_attention",
                             "decode_attention_paged", "ssd_scan"),
          phase_arch, "jamba-v0.1-52b", lm, ops, ref, fa, da, DecodeEngine,
          Request, paged="modes", small_pool=True, layers=4,
          requests=SMALL_MODEL_REQUESTS, prefill_bits=True)
    drive("musicgen-medium", ("flash_attention", "decode_attention",
                              "decode_attention_paged"),
          phase_arch, "musicgen-medium", lm, ops, ref, fa, da, DecodeEngine,
          Request, paged="modes", small_pool=True,
          layers=SERVE_LAYERS["musicgen-medium"])
    drive("phi-3-vision-4.2b", ("flash_attention", "decode_attention",
                                "decode_attention_paged"),
          phase_arch, "phi-3-vision-4.2b", lm, ops, ref, fa, da,
          DecodeEngine, Request, paged="graph",
          layers=SERVE_LAYERS["phi-3-vision-4.2b"])
    check_split_counters(da)
    drive("train olmoe-1b-7b", ("flash_attention", "flash_attention_bwd"),
          phase_train, lm, "olmoe-1b-7b", flash,
          lambda: plain_attention(ops, ref), layers=2)
    torch.cuda.empty_cache()
    # deepseek-v3-671b trains cut to one dense layer and its MTP block (3
    # dense layers before), to keep the run inside its time limit
    drive("train deepseek-v3-671b", ("flash_attention", "flash_attention_bwd"),
          phase_train, lm, "deepseek-v3-671b", flash,
          lambda: plain_attention(ops, ref),
          layers=1, optimizer="adafactor", paths_batch=(1, 1024))
    torch.cuda.empty_cache()
    drive("train musicgen-medium", ("flash_attention", "flash_attention_bwd"),
          phase_train, lm, "musicgen-medium", flash,
          lambda: plain_attention(ops, ref),
          layers=6, paths_batch=(1, 1024),
          memory="AdamW, 6 of 48 layers (cut to make room for the tune "
                 "and tp phases; the 48 fit in 46 GiB reserved): ~0.20 B "
                 "params at 16 bytes (bf16 params and grads, fp32 master, "
                 "m, v) ~3.1 GB; remat's saved products 6 x 8192 tokens "
                 "x 13,824 columns x 2 bytes ~1.4 GB; the graph's pool on "
                 "top")
    torch.cuda.empty_cache()
    drive("train phi-3-vision-4.2b", ("flash_attention",
                                      "flash_attention_bwd"),
          phase_train, lm, "phi-3-vision-4.2b", flash,
          lambda: plain_attention(ops, ref),
          layers=4, optimizer="adafactor", paths_batch=(1, 1024),
          memory="Adafactor, 4 of 32 layers (cut to make room for the "
                 "tune and tp phases; the 32 fit in 62 GiB reserved): "
                 "bf16 params and grads ~1.3 + 1.3 GB, factored moments; "
                 "remat's saved products 4 x 8192 tokens x 31,744 "
                 "columns x 2 bytes ~2.1 GB; the graph's pool on top")
    torch.cuda.empty_cache()
    drive("train jamba-v0.1-52b", ("flash_attention", "flash_attention_bwd",
                                   "ssd_scan", "ssd_scan_bwd"),
          phase_train, lm, "jamba-v0.1-52b", {**flash, **scan},
          lambda: plain_hybrid(ops, ref), layers=6, optimizer="adafactor",
          paths_batch=(1, 1024),
          frozen=r"moe/ffn/w[igo]$",
          memory="Adafactor, one super-block cut to 6 layers (the "
                 "published pattern's positions 4-9, 10.07 B parameters; "
                 "8 until the tp phase's h-j and the dryrun phase's "
                 "mesh cells joined the run; at 4 the expert "
                 "stacks fall under SLICED_UPDATE_ELEMS and Adafactor's "
                 "whole-leaf fp32 update runs out of the card): bf16 "
                 "params and grads 20.1 + 20.1 GB; the optimizer side "
                 "slices the three expert stacks [1, 3, 16, 4096, 14336] "
                 "(2.82 G elements, 11.3 GB in fp32) 4 experts at a time; "
                 "remat's saved products ~214,000 columns x 8192 tokens x "
                 "2 bytes ~3.5 GB, the chunked head's logits ~3.2, one MoE "
                 "layer's recompute and gradients ~2.5; the three-path "
                 "step holds the expert stacks (8.46 B) frozen and parks "
                 "the bf16 weights on the host while its fp32 path runs")

    torch.cuda.empty_cache()
    ranks_launched = drive("dist", ("flash_attention", "flash_attention_bwd"),
                           phase_dist, fa)
    for kernel, n in ranks_launched.items():
        launches[kernel] += n
    torch.cuda.empty_cache()
    ranks_launched = drive("tp", TP_KERNELS, phase_tp, fa)
    for kernel, n in ranks_launched.items():
        launches[kernel] += n
    torch.cuda.empty_cache()
    tune_lines = phase_tune(cfg, DecodeEngine, Request, da, lm, dense)
    shutil.rmtree(tune_dir, ignore_errors=True)
    for kernel, n in dryrun_launches.items():
        launches[kernel] = launches.get(kernel, 0) + n

    src_of = {"flash_attention": "flash_attention.cu",
              "flash_attention_bwd": "flash_attention_bwd.cu",
              "decode_attention": "decode_attention.cu",
              "decode_attention_paged": "decode_attention.cu",
              "ssd_scan": "ssd_scan.cu",
              "ssd_scan_bwd": "ssd_scan_bwd.cu"}
    replaces = {"flash_attention": "src/repro/kernels/flash_attention.py:106",
                "flash_attention_bwd": "src/repro/kernels/xla_flash.py:95",
                "decode_attention": "src/repro/kernels/decode_attention.py:115",
                "decode_attention_paged":
                    "src/repro/kernels/decode_attention.py:236",
                "ssd_scan": "src/repro/kernels/ssd_scan.py:94",
                # not a pallas_call: JAX takes the vjp of this reference
                "ssd_scan_bwd": "src/repro/kernels/ref.py:121"}
    kernels = [{"name": k, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{src_of[k]}",
                "replaces": replaces[k], "launches": launches[k],
                "max_abs_err": rows[k]["max_abs_err"], "ms": rows[k]["ms"],
                "plain_ms": rows[k]["plain_ms"], "bound_ms": rows[k]["bound_ms"],
                "bound_by": rows[k]["bound_by"],
                "library_ms": rows[k]["library_ms"],
                "library_ratio": rows[k]["library_ratio"]} for k in counters]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "wide_group_rows": sorted(wide_rows),
          "tuned": {k: v["best_config"] for k, v in tune_lines.items()}})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
