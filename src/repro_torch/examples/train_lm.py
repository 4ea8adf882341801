"""End-to-end training driver (a port of ``examples/train_lm.py``): train an
LM for a few hundred steps with checkpoint/restart, optionally through
ExpoCloud (so a worker crash or preemption resumes from the latest
checkpoint when the task is re-assigned).  On the card unless
``--device cpu``.

CPU-sized run (reduced config; ~1M params):
    PYTHONPATH=src python -m repro_torch.examples.train_lm \
        --arch smollm-360m --steps 300 --preset reduced --device cpu

Full-config run (mamba2-130m, the ~130M-param assigned arch, on the card):
    PYTHONPATH=src python -m repro_torch.examples.train_lm \
        --arch mamba2-130m --steps 300 --preset full --seq 256 --batch 4

Through ExpoCloud with a simulated mid-run failure:
    PYTHONPATH=src python -m repro_torch.examples.train_lm --expocloud \
        --fail-once

With ``--expocloud`` this process only hands the device's name to the
task: ``LocalEngine`` forks the client and its workers, and a forked
worker can use the card only if its parent never initialised CUDA.  Each
worker, the re-assigned one too, is a new process that opens the card and
loads the built kernels itself.

The default checkpoint directory is the port's own,
``<tempdir>/repro_torch_train_lm``: ``run_training`` resumes from any
checkpoint it finds there, and checkpoints cross frameworks both ways, so
a directory shared with the reference's example would resume the other
package's run.  ``--fail-once`` makes the directory if it is missing (the
reference opens its marker file in a directory that may not exist yet).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.task import AbstractTask
from repro_torch.data.synthetic import data_config_for
from repro_torch.train.loop import TrainJob, run_training


class TrainLMTask(AbstractTask):
    """Training as an ExpoCloud task: re-assignment after a failure resumes
    from the checkpoint directory (at-least-once -> exactly-resumed)."""

    def __init__(self, arch, preset, steps, seq, batch, ckpt_dir,
                 fail_once=False, device="cuda"):
        self.arch, self.preset = arch, preset
        self.steps, self.seq, self.batch = steps, seq, batch
        self.ckpt_dir = ckpt_dir
        self.fail_once = fail_once
        self.device = device
        self.sim_duration = 1.0

    def parameter_titles(self):
        return ("arch", "preset", "steps", "id")

    def parameters(self):
        return (self.arch, self.preset, self.steps, 0)

    def hardness_parameters(self):
        return (self.steps * self.seq * self.batch,)

    def result_titles(self):
        return ("final_step", "first_loss", "last_loss")

    def run(self):
        cfg = (reduced_config(self.arch) if self.preset == "reduced"
               else get_config(self.arch))
        dc = data_config_for(cfg, seq_len=self.seq, batch_size=self.batch)
        fail_marker = os.path.join(self.ckpt_dir, ".failed_once")
        fail_after = None
        if self.fail_once and not os.path.exists(fail_marker):
            os.makedirs(self.ckpt_dir, exist_ok=True)
            open(fail_marker, "w").close()
            fail_after = self.steps // 3
        job = TrainJob(total_steps=self.steps, ckpt_every=25,
                       ckpt_dir=self.ckpt_dir, log_every=25, warmup=10,
                       fail_after_step=fail_after)
        hist, final, _ = run_training(cfg, dc, job, device=self.device)
        return (final, round(hist[0]["loss"], 4), round(hist[-1]["loss"], 4))

    def timeout(self):
        return None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--preset", choices=["reduced", "full"],
                    default="reduced")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--expocloud", action="store_true")
    ap.add_argument("--fail-once", action="store_true",
                    help="inject one failure to demo checkpoint restart")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; never falls back)")
    args = ap.parse_args(argv)

    task = TrainLMTask(args.arch, args.preset, args.steps, args.seq,
                       args.batch, args.ckpt_dir, args.fail_once, args.device)
    if not args.expocloud:
        if args.fail_once:
            try:
                task.run()
            except RuntimeError as e:
                print(f"[train_lm] injected failure: {e}; restarting ...")
        print("[train_lm] result:", task.run())
        return

    from repro_torch.core.engine import LocalEngine
    from repro_torch.core.server import Server, ServerConfig

    engine = LocalEngine(n_workers_per_client=1)
    srv = Server([task], engine,
                 ServerConfig(max_clients=1, use_backup=False,
                              health_update_limit=600.0))
    table = srv.run(poll_sleep=0.2)
    engine.shutdown()
    print(table.to_csv())


if __name__ == "__main__":
    main()
