"""Quickstart: the three layers of the framework (a port of
``examples/quickstart.py``), on the card unless ``--device cpu``.

 1. ExpoCloud (the paper): a parameter sweep through the unified
    Experiment facade — declare a ParamSpace, decorate a function with
    @task, run it on the simulated cloud (``repro_torch.core`` is a copy
    of the reference's core, so this section prints the reference's
    lines).
 2. Substrate: train a reduced LM for a few steps with checkpointing.
 3. Dry-run: lower one cell on the ``meta`` device and, on the card,
    compile it where it fits; print its roofline terms.  The port's
    dry-run runs on one device: the reference's 2 x 4 ``data`` /
    ``model`` host mesh waits for a mesh of more than one device.

    PYTHONPATH=src python -m repro_torch.examples.quickstart \
        [--section sweep|train|dryrun] [--device cpu]

With ``--device cpu`` the training runs on the CPU and the dry-run lowers
on ``meta`` only.
"""
import argparse
import os
import subprocess
import sys
import tempfile

from repro_torch.core import (Experiment, InstanceType, ParamSpace, SpotWave,
                              axis, task)

# the package's parent directory, for the dry-run's own process
SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@task(result_titles=("n_squared",), timeout=3.0,
      sim_duration=lambda n, **_: 0.4 * n)
def square(n, id):
    return (n * n,)


# ---------------------------------------------------------------- 1. sweep
def sweep():
    space = ParamSpace.grid(n=axis(range(1, 11), hardness="asc"), id=[0])
    exp = Experiment(
        space.bind(square), engine="sim", max_clients=2,
        sim=dict(client_workers=1, latency_jitter=0.002, seed=0,
                 instance_types={"client": InstanceType(
                     creation_delay=1.0, cost_per_instance_second=2.0)}),
        chaos=[SpotWave(at=5.0, fraction=0.5)])  # spot wave takes half the
    with exp.run() as run:                       # fleet at t=5s
        table = run.results(until=600)

    print("[1] ExpoCloud sweep:")
    print("    solved:",
          [p[0] for p, r, s in table.rows if r is not None],
          "| pruned by domino:",
          [p[0] for p, r, s in table.rows if s == "pruned"])
    cost = table.cost   # CostMeter summary, engine -> results
    cluster = run.cluster
    print(f"    makespan {cluster.clock.now():.1f}s simulated in "
          f"{cluster.loop.processed} events, "
          f"cost {cost['total']:.0f} (rate-weighted instance-seconds, "
          f"by kind: {cost['by_kind']})")


# ---------------------------------------------------------------- 2. train
def train(device: str = "cuda"):
    from repro_torch.configs import reduced_config
    from repro_torch.data.synthetic import data_config_for
    from repro_torch.train.loop import TrainJob, run_training

    cfg = reduced_config("smollm-360m")
    dc = data_config_for(cfg, seq_len=64, batch_size=4)
    with tempfile.TemporaryDirectory() as td:
        hist, _, _ = run_training(
            cfg, dc, TrainJob(total_steps=20, ckpt_every=10, ckpt_dir=td,
                              log_every=10, warmup=5), device=device)
    print(f"[2] trained reduced smollm: loss {hist[0]['loss']:.3f} -> "
          f"{hist[-1]['loss']:.3f}")


# ---------------------------------------------------------------- 3. dryrun
def dryrun(device: str = "cuda", seg_counts=None):
    """The reference's cell (mamba2-130m, train_4k on the 2 x 4 (data,
    model) mesh) in a process of its own: rank 0 of a fake world of 8,
    lowered on ``meta`` when ``device`` is the CPU, and on the card also
    compiled (that rank's step captured) where it fits.  ``seg_counts``
    cuts the depth (the CPU tests)."""
    dev = "meta" if device == "cpu" else device
    print(f"[3] dry-run one cell on an 8-device mesh (rank 0 of a fake "
          f"world, {dev}):", flush=True)
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=SRC + (os.pathsep + path if path
                                             else ""))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "mamba2-130m", "--shape", "train_4k", "--mesh-shape", "2", "4",
           "--mesh-axes", "data", "model", "--device", dev]
    if seg_counts:
        cmd += ["--seg-counts", *map(str, seg_counts)]
    subprocess.run(cmd, env=env, check=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--section", choices=["all", "sweep", "train", "dryrun"],
                    default="all")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; never falls back); "
                         "cpu lowers the dry-run on meta")
    args = ap.parse_args()
    if args.section in ("all", "sweep"):
        sweep()
    if args.section in ("all", "train"):
        train(args.device)
    if args.section in ("all", "dryrun"):
        dryrun(args.device)
