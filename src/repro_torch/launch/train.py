"""Training launcher, on the card unless ``--device cpu``.  On the card
``run_training`` runs the train step as one CUDA graph, captured after the
run's first step and replayed once per step (no flag: the device decides).

    # CPU-sized smoke runs (mamba2-130m trains through the SSD scan's
    # backward, the plain version on the CPU):
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --preset reduced --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
        --preset reduced --steps 20 --device cpu
    # the modality stubs: 4 codebooks (tokens [B, S, 4]), and image embeds
    # written over the first positions of every sequence
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch musicgen-medium --preset reduced --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch phi-3-vision-4.2b --preset reduced --steps 20 --device cpu
    # the Jamba hybrid (two super-blocks of 4 layers, Mamba-2 and attention,
    # MoE on odd layers), under Adafactor as on the card
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch jamba-v0.1-52b --preset reduced --steps 20 --optimizer adafactor \
        --device cpu

    # full width on the card, resuming from --ckpt-dir if it holds a step:
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --preset full --seq 4096 --batch 2 --steps 100 --ckpt-dir ckpt/
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
        --preset full --seq 4096 --batch 2 --steps 100 --ckpt-dir ckpt/
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch musicgen-medium --preset full --seq 4096 --batch 2 --steps 100
    # phi-3-vision-4.2b at full depth fits 80 GB under Adafactor, not AdamW
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch phi-3-vision-4.2b --preset full --seq 4096 --batch 2 \
        --steps 100 --optimizer adafactor

jamba-v0.1-52b at full width holds 13.27 B parameters in each of its four
super-blocks, so the whole model fits no card; ``chip_smoke.py`` trains it
cut to one super-block (8 layers) under Adafactor.

A restart with the same arguments resumes from ``--ckpt-dir``, which is
what lets an ExpoCloud worker re-run a failed training task.

Training on a mesh (``--mesh``) runs one process a rank under
``torch.distributed.run`` (torchrun, part of torch); the axes follow the
reference's rule, ``("data", "model")[:n]`` or ``("pod", "data",
"model")``.  A ``model`` entry above 1 splits attention and MLA heads,
SSD heads, FFN columns, the vocabulary and MoE experts over its ranks
(``sharding/tp.py``; ``REPRO_MOE=ep`` picks the expert-parallel
dispatch), and musicgen's codebook tables and heads over V; a config the
rules refuse is refused before any process group starts.  The backend
follows a rule
(``distributed.py``): NCCL where each rank has a card of its own, gloo
where ranks share one or run on the CPU:

    # two gloo ranks on the CPU
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --mesh 2 --preset reduced --steps 20 --device cpu
    # 2 x 2 (data, model) on the CPU, and olmoe-1b-7b's experts split
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --mesh 2 2 --preset reduced --steps 20 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch olmoe-1b-7b --mesh 1 2 --preset reduced --steps 20 --device cpu
    # the SSD heads split (Mamba-2, the Jamba hybrid), MLA's heads
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch mamba2-130m --mesh 2 2 --preset reduced --steps 20 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch jamba-v0.1-52b --mesh 1 2 --preset reduced --steps 20 \
        --optimizer adafactor --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch deepseek-v3-671b --mesh 1 2 --preset reduced --steps 20 \
        --optimizer adafactor --device cpu
    # full width, one rank a card (NCCL; a gloo pair on a single card)
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --mesh 2 --preset full --seq 4096 --batch 2 --steps 20

A checkpoint holds whole leaves, so ``--ckpt-dir`` resumes on any number
of ranks; ``--no-zero1`` keeps every rank's optimizer state whole.
"""
from __future__ import annotations

import argparse

import torch


def main(argv=None):
    from repro_torch import distributed

    distributed.refuse_fake("training")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--preset", choices=["reduced", "full"],
                    default="reduced")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; never falls back)")
    ap.add_argument("--mesh", type=int, nargs="*", default=None,
                    help="e.g. --mesh 2 for two data-parallel ranks, "
                         "--mesh 2 2 for (data, model) = (2, 2)")
    ap.add_argument("--no-zero1", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.synthetic import data_config_for
    from repro_torch.train.loop import TrainJob, run_training

    cfg = (reduced_config(args.arch) if args.preset == "reduced"
           else get_config(args.arch))
    dc = data_config_for(cfg, seq_len=args.seq, batch_size=args.batch)
    rules = None
    if args.mesh:
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.sharding.rules import make_rules

        axes = ("data", "model")[:len(args.mesh)] if len(args.mesh) <= 2 \
            else ("pod", "data", "model")
        make_rules(_Shape(tuple(args.mesh), axes)).check_supported(cfg)
        rules = make_rules(make_mesh(tuple(args.mesh), axes,
                                     device=args.device))
    job = TrainJob(total_steps=args.steps, ckpt_every=args.ckpt_every,
                   ckpt_dir=args.ckpt_dir, base_lr=args.lr,
                   optimizer=args.optimizer, zero1=not args.no_zero1,
                   log_every=max(1, args.steps // 10))
    hist, final, _ = run_training(cfg, dc, job, device=args.device,
                                  rules=rules)
    if rules is None or torch.distributed.get_rank() == 0:
        print(f"[launch.train] {args.arch} ({args.preset}) done at step "
              f"{final}; loss {hist[0]['loss']:.4f} -> "
              f"{hist[-1]['loss']:.4f}", flush=True)
    if rules is not None:
        from repro_torch import distributed

        distributed.shutdown()


class _Shape:
    """A mesh's axis names and sizes alone, to check a config against
    before any process group starts."""

    def __init__(self, shape: tuple, axes: tuple):
        self.axis_names, self.shape = axes, dict(zip(axes, shape,
                                                     strict=True))


if __name__ == "__main__":
    main()
