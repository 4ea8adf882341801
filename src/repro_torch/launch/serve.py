"""Serving launcher: continuous-batching decode over synthetic requests,
on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --preset full --requests 8 --slots 4 --max-new 16 \
        --mode fused --steps-per-sync 8 --prefill-chunk 16 \
        --kv-layout paged --page-size 16 --num-pages 64

``--arch`` takes any arch of ``repro_torch.configs.ARCH_IDS``: the dense
``qwen3-4b``, ``chatglm3-6b`` and ``granite-20b`` as smollm,
``mamba2-130m`` the Mamba-2 model, ``olmoe-1b-7b`` (MoE),
``deepseek-v3-671b`` (MLA + MoE) and ``jamba-v0.1-52b`` (the hybrid of
Mamba-2 and attention super-blocks, with MoE), ``musicgen-medium`` (4
codebooks: prompts of [plen, 4] tokens, one token per codebook a step)
and ``phi-3-vision-4.2b`` (its text backbone; the engine serves no image
path).  ``--preset reduced`` (the
default) is the CPU-sized config, ``--preset full`` the published widths
(one at a time on an 80 GB card: granite-20b's bf16 weights take 37.8 GiB,
olmoe-1b-7b's 12.9 GiB; deepseek-v3-671b's 1.3 TB and jamba-v0.1-52b's
96 GiB fit no card, ``--layers`` cuts their depth: jamba at 8, one
super-block, is 24.7 GiB).  In
fused mode it prints the engine's CUDA-graph statistics beside the
throughput.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--preset", choices=["reduced", "full"],
                    default="reduced")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mode", choices=["fused", "host"], default="fused",
                    help="fused: N decode steps per host sync; "
                         "host: sync every step")
    ap.add_argument("--steps-per-sync", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="batched prefill chunk size (0 = sequential "
                         "one-token-per-step prompt forcing)")
    ap.add_argument("--max-prefill-tokens-per-sync", type=int, default=None,
                    help="admission budget on prefill work per sync")
    ap.add_argument("--kv-layout", choices=["dense", "paged"],
                    default="dense",
                    help="dense: per-slot max_seq KV stripes; paged: "
                         "shared page pool with memory-aware admission")
    ap.add_argument("--page-size", type=int, default=None,
                    help="KV rows per page (paged layout; default 16)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="pool size in pages (paged layout; default "
                         "slots * ceil(max_seq/page_size))")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers (a multiple "
                         "of a hybrid config's super-block)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; never falls back)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.device import resolve_device
    from repro_torch.models import lm
    from repro_torch.serve.engine import DecodeEngine, Request

    device = resolve_device(args.device)
    cfg = (reduced_config(args.arch) if args.preset == "reduced"
           else get_config(args.arch))
    if args.layers is not None:
        cfg = cfg.replace(num_layers=args.layers)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = lm.init_lm(cfg, gen, device)
    eng = DecodeEngine(
        cfg, params, batch_slots=args.slots, max_seq=args.max_seq,
        rng_seed=args.seed, mode=args.mode,
        steps_per_sync=args.steps_per_sync,
        prefill_chunk=args.prefill_chunk,
        max_prefill_tokens_per_sync=args.max_prefill_tokens_per_sync,
        kv_layout=args.kv_layout, page_size=args.page_size,
        num_pages=args.num_pages, device=device)
    rng = np.random.default_rng(args.seed)
    reqs = []
    for _ in range(args.requests):
        plen = int(rng.integers(2, 9))
        shape = (plen, cfg.num_codebooks) if cfg.num_codebooks else plen
        prompt = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        reqs.append(Request(prompt=prompt, max_new_tokens=args.max_new,
                            temperature=args.temperature,
                            top_k=args.top_k))
        eng.submit(reqs[-1])
    t0 = time.time()
    steps = eng.run_until_drained()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    total = sum(len(r.output) for r in reqs)
    print(f"[launch.serve] {args.arch}: {args.requests} requests, "
          f"{total} tokens in {steps} steps / {dt:.1f}s "
          f"({total/dt:.1f} tok/s, {args.slots} slots, {args.mode} mode)")
    gs = eng.graph_stats()      # all 0 on the CPU, where the bodies are eager
    graphs = {"fused loop": "" if args.mode == "fused" else None,
              "chunked prefill": "prefill_" if args.prefill_chunk else None,
              "host-mode step": "host_step_" if args.mode == "host" else None}
    for what, pre in graphs.items():
        if pre is not None:
            print(f"[launch.serve] {what}: {gs[f'{pre}captures']} CUDA graph "
                  f"capture(s) in {gs[f'{pre}capture_ms']:.0f} ms, "
                  f"{gs[f'{pre}replays']} replays, graph pool "
                  f"{gs[f'{pre}graph_pool_bytes'] / 2**20:.1f} MiB")
    if args.kv_layout == "paged":
        ks = eng.kv_stats()
        print(f"[launch.serve] paged KV: {ks['num_pages']} pages x "
              f"{ks['page_size']} rows, high water {ks['high_water']}, "
              f"{ks['preemptions']} preemptions, "
              f"{ks['rejected']} rejected")


if __name__ == "__main__":
    main()
