"""Serving example: continuous-batching decode engine over batched requests
(a port of ``examples/serve_lm.py``), on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm \
        --arch mamba2-130m --requests 6 --max-new 12 [--device cpu]

The flags and prints are the reference's.  Two additions: ``--device``,
and ``--prefill-chunk`` (default 0, the reference's sequential prompt
forcing: every prompt token goes through a decode step); a chunk of C > 0
runs each prompt's full C-token chunks through ``lm.prefill_chunk``, which
is where a Mamba model calls the SSD scan.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.serve.engine import DecodeEngine, Request


def prompts(cfg, n: int) -> list:
    """The reference's prompts (``examples/serve_lm.py:34-42``): request i
    has 3 + i % 3 tokens; with codebooks every token of it is i + 1."""
    out = []
    for i in range(n):
        if cfg.num_codebooks:
            out.append(np.ones((3 + i % 3, cfg.num_codebooks), np.int32)
                       * (i + 1))
        else:
            out.append((np.arange(3 + i % 3, dtype=np.int32) + 1 + i)
                       % cfg.vocab_size)
    return out


def serve(cfg, params, *, slots: int = 3, requests: int = 6,
          max_new: int = 12, temperature: float = 0.0,
          prefill_chunk: int = 0, device: str | torch.device = "cuda") -> list:
    """Serve ``requests`` of the reference's prompts on an engine of
    ``slots`` slots (max_seq 128) over ``params``, print the reference's
    lines, and return the requests (their ``output`` filled)."""
    eng = DecodeEngine(cfg, params, batch_slots=slots, max_seq=128,
                       prefill_chunk=prefill_chunk, device=device)
    reqs = []
    for prompt in prompts(cfg, requests):
        reqs.append(Request(prompt=prompt, max_new_tokens=max_new,
                            temperature=temperature))
        eng.submit(reqs[-1])

    t0 = time.time()
    steps = eng.run_until_drained()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.time() - t0
    total_tokens = sum(len(r.output) for r in reqs)
    print(f"served {len(reqs)} requests in {steps} decode steps, "
          f"{dt:.1f}s -> {total_tokens/dt:.1f} tok/s "
          f"({slots} slots, continuous batching)")
    for i, r in enumerate(reqs[:4]):
        toks = [int(np.asarray(t).flat[0]) for t in r.output]
        print(f"  req{i}: {toks}")
    return reqs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="batched prefill chunk (0: one prompt token a "
                         "decode step, as the reference)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; never falls back)")
    args = ap.parse_args(argv)

    from repro_torch.configs import reduced_config
    from repro_torch.device import resolve_device
    from repro_torch.models import lm

    device = resolve_device(args.device)
    cfg = reduced_config(args.arch)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = lm.init_lm(cfg, gen, device)
    serve(cfg, params, slots=args.slots, requests=args.requests,
          max_new=args.max_new, temperature=args.temperature,
          prefill_chunk=args.prefill_chunk, device=device)


if __name__ == "__main__":
    main()
