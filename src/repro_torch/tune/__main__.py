"""CLI: ``python -m repro_torch.tune --kernel decode_attention``.

Runs the autotuning sweep of one of the port's kernels (or ``all``)
through the Experiment facade on the card (``--device cpu`` for the plain
versions) and persists the winning config into the best-config cache
(``REPRO_TORCH_TUNE_CACHE`` or ``~/.cache/repro_torch/tune_cache.json``)
that ``kernels/ops.py`` consults at dispatch.  Exit status 1 if any sweep
finished over its budget cap.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.tune.space import SPECS
from repro_torch.tune.tuner import tune


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="Autotune the port's Hopper kernel configs through the "
                    "Experiment facade.")
    ap.add_argument("--kernel", required=True,
                    choices=[*sorted(SPECS), "all"],
                    help="kernel to tune, or 'all'")
    ap.add_argument("--engine", default="sim", choices=["sim", "local"],
                    help="sim: virtual-time domino pruning from the cost "
                         "model; local: wall-clock timeouts in worker "
                         "processes (default: sim)")
    ap.add_argument("--smoke", action="store_true",
                    help="small CPU-test shapes")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--k", type=float, default=4.0, dest="k_timeout",
                    help="timeout = k x incumbent (default 4.0)")
    ap.add_argument("--budget-cap", type=float, default=None,
                    help="CostMeter spend cap for the sweep")
    ap.add_argument("--max-clients", type=int, default=2)
    ap.add_argument("--adversarial", type=int, default=0,
                    help="seeded runnable-but-bad values per knob "
                         "(exercises the domino/timeout rule)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache", default=None,
                    help="cache file override (else REPRO_TORCH_TUNE_CACHE "
                         "/ default path)")
    ap.add_argument("--no-store", action="store_true",
                    help="report only; do not persist the winner")
    ap.add_argument("--json", default=None, dest="json_out",
                    help="also write the full reports to this file")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the configs are measured: the card "
                         "(default) or the CPU's plain versions")
    args = ap.parse_args(argv)

    kernels = sorted(SPECS) if args.kernel == "all" else [args.kernel]
    reports = []
    for kern in kernels:
        rep = tune(kern, engine=args.engine, smoke=args.smoke,
                   dtype=args.dtype, k_timeout=args.k_timeout,
                   budget_cap=args.budget_cap,
                   max_clients=args.max_clients,
                   adversarial=args.adversarial, seed=args.seed,
                   cache_path=args.cache, store=not args.no_store,
                   device=args.device)
        reports.append(rep)
        print(rep.summary())
        if rep.cache_key:
            print(f"  -> cached as {rep.cache_key} in {rep.cache_path}")
    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as fh:
            json.dump([r.to_dict() for r in reports], fh, indent=2,
                      default=float)
            fh.write("\n")
        print(f"wrote {args.json_out}")
    return 1 if any(r.under_cap is False for r in reports) else 0


if __name__ == "__main__":
    sys.exit(main())
