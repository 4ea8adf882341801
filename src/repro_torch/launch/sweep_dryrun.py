"""Drive the full (arch x shape x mesh) dry-run grid through ExpoCloud, on
one card (the port of ``repro/launch/sweep_dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.sweep_dryrun \
        --mesh single --mode probe --out dryrun_results [--archs a b ...] \
        [--device cuda|meta]

The grid is exactly the paper's use case: tasks ordered easiest->hardest by
static hardness, a deadline per cell, timeouts domino-pruning dominating
cells, results in a tabular report.  Cells run as subprocesses via the
unified Experiment facade on the local engine (one worker per client:
one card takes one cell at a time); ``--shards`` runs the schedule on the
simulator.  ``--device meta`` lowers every cell on the CPU and builds
nothing; ``cuda`` (the default) also compiles each cell that fits the
card.  ``--mesh multi`` is refused by every cell (ROADMAP Queue A item 9c).

mode=full   full-config lower+compile per cell (the dry-run proof)
mode=probe  small-layer-count probes (roofline extrapolation)
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import cells, get_config
from repro_torch.core.experiment import Experiment
from repro_torch.core.server import ServerConfig
from repro_torch.core.sweep import DryRunCellTask, probe_plans


def build_tasks(archs, shapes, meshes, modes, deadline, out_dir,
                variant=None, device: str = "cuda"):
    tasks = []
    for arch, shape in cells():
        if archs and arch not in archs:
            continue
        if shapes and shape not in shapes:
            continue
        for mesh in meshes:
            if "full" in modes:
                tasks.append(DryRunCellTask(
                    arch, shape, mesh, None, variant, deadline, out_dir,
                    device=device))
            if "probe" in modes and mesh == "single":
                for plan in probe_plans(arch):
                    tasks.append(DryRunCellTask(
                        arch, shape, mesh, plan,
                        dict(variant or {}, unroll=1), deadline, out_dir,
                        device=device))
    return tasks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--mode", choices=["full", "probe", "both"],
                    default="both")
    ap.add_argument("--archs", nargs="*", default=None)
    ap.add_argument("--shapes", nargs="*", default=None)
    ap.add_argument("--deadline", type=float, default=1800.0)
    ap.add_argument("--out", default="dryrun_results")
    ap.add_argument("--variant", nargs="*", default=[])
    ap.add_argument("--device", choices=["cuda", "meta"], default="cuda")
    ap.add_argument("--max-clients", type=int, default=1)
    ap.add_argument("--scale", choices=["fixed", "demand"], default="fixed",
                    help="fleet-scaling policy (see repro_torch.core.policy)")
    ap.add_argument("--budget-cap", type=float, default=None,
                    help="stop creating instances when the projected spend "
                         "(wall-clock-proxy instance-seconds) nears the cap")
    ap.add_argument("--shards", type=int, default=1,
                    help="split the sweep across K scheduler shards on the "
                         "virtual-clock simulator (cells still execute, at "
                         "their virtual completion instants, modelled as "
                         "--sim-cell-s seconds each); per-shard CostMeter "
                         "summaries are merged into one ResultsTable cost "
                         "account.  shards=1 keeps the local engine")
    ap.add_argument("--sim-cell-s", type=float, default=60.0,
                    help="virtual seconds one cell occupies a worker in the "
                         "sharded (simulator) schedule, for makespan/cost "
                         "accounting")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    modes = ["full", "probe"] if args.mode == "both" else [args.mode]
    variant = dict(kv.split("=", 1) for kv in args.variant) \
        if args.variant else None

    tasks = build_tasks(args.archs, args.shapes, meshes, modes,
                        args.deadline, args.out, variant, args.device)
    print(f"[sweep] {len(tasks)} cells queued")
    config = ServerConfig(
        max_clients=args.max_clients,
        use_backup=False,                  # paper: no backup locally
        health_update_limit=60.0,
        instance_max_non_active_time=120.0,
        out_dir=args.out + "/expocloud",
        workers_hint=1,
        scale_policy=args.scale,
        budget_cap=args.budget_cap,
    )
    if args.shards > 1:
        # sharded sweep: K scheduler shards on one virtual clock.  Cells
        # still execute (the simulated worker pool runs each task at its
        # virtual completion instant); the clock models every cell as
        # --sim-cell-s seconds, so makespan and the merged cost summary
        # are schedule estimates, not wall measurements
        import dataclasses

        from repro_torch.core.sim import SimParams
        for t in tasks:
            t.sim_duration = args.sim_cell_s
        # per-shard servers must not race on one out_dir (each would
        # write its partial table over the others') — the merged table
        # below is the authoritative sharded output
        config = dataclasses.replace(config, out_dir=None)
        exp = Experiment(tasks, engine="sim",
                         sim=SimParams(client_workers=1, seed=0),
                         shards=args.shards, config=config)
    else:
        exp = Experiment(tasks, engine="local",
                         engine_cfg={"n_workers_per_client": 1},
                         config=config)
    t0 = time.time()
    with exp.run() as run:
        table = run.results(poll_sleep=0.2)
    print(f"[sweep] done in {time.time()-t0:.0f}s")
    print(table.to_csv())
    if table.cost is not None:
        shard_note = f", {args.shards} shards" if args.shards > 1 else ""
        print(f"[sweep] cost: {table.cost['total']:.0f} instance-seconds "
              f"(wall-clock proxy, {table.cost['instances']} instances"
              f"{shard_note})")


if __name__ == "__main__":
    main()
