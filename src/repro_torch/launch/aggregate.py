"""Aggregate dry-run sweep records into the §Roofline table.

Why extrapolation: ``cost_analysis()`` counts a ``while`` (lax.scan) body
once, so full-config scanned compiles under-report FLOPs/bytes by ~L x.
The probes compile UNROLLED modules at small segment counts (base and
base+1 per segment); every per-chip metric is affine in the segment counts
(layers are homogeneous within a segment), so

    m(counts) = intercept + sum_i slope_i * counts_i

is exact, and evaluating at the full counts reconstructs the true whole-step
metric.  The full-config compile still provides the lower/compile *proof*
and the sharding-derived bytes/device.

    PYTHONPATH=src python -m repro_torch.launch.aggregate --dir dryrun_results \
        --markdown EXPERIMENTS_roofline.md
"""
from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
from collections import defaultdict

from repro_torch.configs import cells, get_config, get_shape
from repro_torch.configs.analysis import model_flops, param_counts
from repro_torch.configs.registry import segment_counts
from repro_torch.launch.roofline import HBM_BW, ICI_BW, PEAK_FLOPS, Roofline

METRICS = ("hlo_flops", "hlo_bytes", "collective_bytes_per_chip")


def extrapolate_linear(base: dict, bumped: list[dict], base_counts: tuple,
                       full_counts: tuple) -> dict:
    """base measured at base_counts; bumped[i] at base_counts + e_i."""
    out = {}
    for m in base:
        if not isinstance(base[m], (int, float)):
            continue
        slopes = [b[m] - base[m] for b in bumped]
        val = base[m]
        for s, c0, cf in zip(slopes, base_counts, full_counts,
                             strict=False):
            val += s * (cf - c0)
        out[m] = val
    return out


def load_records(directory: str) -> dict:
    recs = {}
    for path in glob.glob(os.path.join(directory, "*.json")):
        with open(path) as f, \
                contextlib.suppress(json.JSONDecodeError):
            recs[os.path.basename(path)] = json.load(f)
    return recs


def probe_key(arch, shape, counts):
    return f"{arch}__{shape}__single__L{'-'.join(map(str, counts))}_unroll-1.json"


def full_key(arch, shape, mesh):
    return f"{arch}__{shape}__{mesh}__full.json"


def assemble(directory: str, mesh: str = "single"):
    """Returns list of row dicts (one per runnable cell)."""
    recs = load_records(directory)
    rows = []
    for arch, shape_name in cells():
        cfg = get_config(arch)
        shape = get_shape(shape_name)
        full_counts = tuple(segment_counts(cfg))
        if cfg.hybrid_block:
            base_counts = (1,)
        elif len(full_counts) == 2:
            base_counts = (1, 2)
        else:
            base_counts = (2,)
        bump_keys = []
        for i in range(len(base_counts)):
            b = list(base_counts)
            b[i] += 1
            bump_keys.append(probe_key(arch, shape_name, b))
        base_rec = recs.get(probe_key(arch, shape_name, base_counts))
        bump_recs = [recs.get(k) for k in bump_keys]
        full_rec = recs.get(full_key(arch, shape_name, mesh))
        row = {"arch": arch, "shape": shape_name, "mesh": mesh,
               "status": "missing"}
        if full_rec is not None and full_rec.get("status") == "ok":
            row["status"] = "ok"
            row["compile_s"] = full_rec["compile_s"]
            row["bytes_per_device"] = full_rec["bytes_per_device_inputs"]
            row["memory_analysis"] = full_rec["memory_analysis"][:200]
        if base_rec and all(bump_recs) \
                and base_rec.get("status") == "ok" \
                and all(b.get("status") == "ok" for b in bump_recs):
            chips = base_rec["roofline"]["chips"]
            base_m = {m: base_rec["roofline"][m] for m in METRICS}
            bump_m = [{m: b["roofline"][m] for m in METRICS}
                      for b in bump_recs]
            full_m = extrapolate_linear(base_m, bump_m, base_counts,
                                        full_counts)
            mf = model_flops(cfg, shape)
            r = Roofline(
                arch=arch, shape=shape_name, mesh=mesh, chips=chips,
                hlo_flops=max(full_m["hlo_flops"], 0.0),
                hlo_bytes=max(full_m["hlo_bytes"], 0.0),
                collective_bytes_per_chip=max(
                    full_m["collective_bytes_per_chip"], 0.0),
                collectives={}, collective_counts={},
                model_flops=mf,
            ).finalize()
            row.update(
                compute_s=r.compute_s, memory_s=r.memory_s,
                collective_s=r.collective_s, dominant=r.dominant,
                useful_ratio=r.useful_ratio,
                roofline_fraction=r.roofline_fraction,
                model_flops=mf,
                hlo_flops=r.hlo_flops,
                status_roofline="extrapolated",
            )
        rows.append(row)
    return rows


def to_markdown(rows) -> str:
    hdr = ("| arch | shape | chips | compute s | memory s | collective s | "
           "dominant | MODEL/HLO | roofline frac | inputs GB/dev |")
    sep = "|" + "---|" * 10
    lines = [hdr, sep]
    for r in rows:
        if "compute_s" in r:
            lines.append(
                f"| {r['arch']} | {r['shape']} | 256 "
                f"| {r['compute_s']:.3f} | {r['memory_s']:.3f} "
                f"| {r['collective_s']:.3f} | **{r['dominant']}** "
                f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.3f} "
                f"| {r.get('bytes_per_device', 0)/1e9:.2f} |")
        else:
            lines.append(f"| {r['arch']} | {r['shape']} | 256 "
                         f"| - | - | - | {r['status']} | - | - | - |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="dryrun_results")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--markdown", default=None)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    rows = assemble(args.dir, args.mesh)
    md = to_markdown(rows)
    print(md)
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write(md + "\n")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1, default=float)


if __name__ == "__main__":
    main()
