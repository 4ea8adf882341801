"""§Perf hillclimbing driver: run the unrolled probe set for one cell under
a variant, extrapolate to the full config, and print the roofline row —
the measure step of the hypothesis -> change -> measure -> validate loop.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch deepseek-v3-671b \
        --shape train_4k --variant moe=ep --out dryrun_results_perf
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config, get_shape
from repro_torch.configs.analysis import model_flops
from repro_torch.configs.registry import segment_counts
from repro_torch.core.sweep import DryRunCellTask, probe_plans
from repro_torch.launch.aggregate import METRICS, extrapolate_linear
from repro_torch.launch.roofline import Roofline


def run_variant(arch: str, shape: str, variant: dict, out_dir: str,
                deadline: float = 1800.0, devices: int = 512) -> dict:
    cfg = get_config(arch)
    plans = probe_plans(arch)
    recs = []
    for plan in plans:
        task = DryRunCellTask(arch, shape, "single", plan,
                              dict(variant, unroll=1), deadline, out_dir,
                              devices=devices)
        res = task.run()
        assert res[0] == "ok", res
        with open(res[-1]) as f:
            recs.append(json.load(f))
    base, bumped = recs[0], recs[1:]
    base_m = {m: base["roofline"][m] for m in METRICS}
    bump_m = [{m: b["roofline"][m] for m in METRICS} for b in bumped]
    full_counts = tuple(segment_counts(cfg))
    base_counts = tuple(plans[0])
    full_m = extrapolate_linear(base_m, bump_m, base_counts, full_counts)
    mf = model_flops(cfg, get_shape(shape))
    r = Roofline(
        arch=arch, shape=shape, mesh="data16xmodel16",
        chips=base["roofline"]["chips"],
        hlo_flops=max(full_m["hlo_flops"], 0.0),
        hlo_bytes=max(full_m["hlo_bytes"], 0.0),
        collective_bytes_per_chip=max(full_m["collective_bytes_per_chip"],
                                      0.0),
        collectives={}, collective_counts={}, model_flops=mf,
    ).finalize()
    return {
        "arch": arch, "shape": shape, "variant": variant,
        "compute_s": r.compute_s, "memory_s": r.memory_s,
        "collective_s": r.collective_s, "dominant": r.dominant,
        "useful_ratio": r.useful_ratio,
        "roofline_fraction": r.roofline_fraction,
        "probe_compile_s": [x["compile_s"] for x in recs],
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", nargs="*", default=[])
    ap.add_argument("--out", default="dryrun_results_perf")
    ap.add_argument("--devices", type=int, default=512)
    args = ap.parse_args(argv)
    variant = {}
    for kv in args.variant:
        k, v = kv.split("=", 1)
        variant[k] = int(v) if v.isdigit() else v
    row = run_variant(args.arch, args.shape, variant, args.out,
                      devices=args.devices)
    print(json.dumps(row, indent=1, default=float))


if __name__ == "__main__":
    main()
