"""The ML bridge: ExpoCloud tasks whose "parameter setting" is a cell of
the (architecture x input-shape x mesh x variant) exploration grid (the
port of ``repro/core/sweep.py``).

Each task runs ``repro_torch.launch.dryrun`` in a fresh subprocess (its
own process group, its own CUDA context and memory) with the cell's
config, parses the JSON record and returns the roofline terms; a cell
whose estimated peak exceeds the card returns ``exceeds_device`` with its
estimated terms, as a result.  ``mesh``: ``single`` is one card (the
port's meaning since its first dry-run; the reference's 16 x 16 pod is a
``mesh_shape`` of (16, 16)), ``multi`` the 2 x 16 x 16 (pod, data, model)
mesh, and ``mesh_shape`` / ``mesh_axes`` any mesh, each traced as one rank
of a fake world of its size.  Hardness is the static-analysis tuple from
configs.analysis (params, step FLOPs, cache bytes, seq, tokens), scaled
by the layers built, plus the chip term (the cell's chips) — all
monotone proxies for lower+compile cost — so a timeout on one cell
domino-prunes every cell that dominates it (the paper's mechanism,
applied to our own experiment).
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import signal
import subprocess
import sys
from pathlib import Path

from repro_torch.configs import get_config, get_shape
from repro_torch.configs.analysis import hardness_tuple
from repro_torch.configs.registry import segment_counts
from repro_torch.core.task import AbstractTask

RESULT_TITLES = ("status", "dominant", "compute_s", "memory_s",
                 "collective_s", "useful_ratio", "roofline_frac",
                 "compile_s", "json_path")


class DryRunCellTask(AbstractTask):
    def __init__(self, arch: str, shape: str, mesh: str = "single",
                 seg_counts: tuple | None = None, variant: dict | None = None,
                 deadline: float = 1800.0, out_dir: str = "dryrun_results",
                 devices: int = 512, tag: str = "", mesh_shape=None,
                 mesh_axes=None, device: str = "cuda"):
        self.arch = arch
        self.shape = shape
        self.mesh = mesh                    # 'single' | 'multi'
        self.seg_counts = tuple(seg_counts) if seg_counts else None
        self.variant = dict(variant or {})
        self.deadline = deadline
        self.out_dir = out_dir
        # the reference's count of XLA host devices, kept for its callers
        # (hillclimb): the port's meshes are fake worlds of their size
        self.devices = devices
        self.tag = tag
        # test-sized override (must fit `devices` host devices)
        self.mesh_shape = tuple(mesh_shape) if mesh_shape else None
        self.mesh_axes = tuple(mesh_axes) if mesh_axes else None
        self.device = device                # cuda, or meta: the lower stage

    # --- ExpoCloud interface -------------------------------------------
    def parameter_titles(self):
        return ("arch", "shape", "mesh", "probe", "variant", "id")

    def parameters(self):
        probe = "full" if self.seg_counts is None else \
            "L" + "-".join(map(str, self.seg_counts))
        vstr = ",".join(f"{k}={v}" for k, v in sorted(self.variant.items())) \
            or "base"
        return (self.arch, self.shape, self.mesh, probe, vstr, self.tag)

    def hardness_parameters(self):
        cfg = get_config(self.arch)
        shape = get_shape(self.shape)
        h = hardness_tuple(cfg, shape)
        chips = (math.prod(self.mesh_shape) if self.mesh_shape
                 else 512 if self.mesh == "multi" else 1)
        full = sum(segment_counts(cfg))
        layers = sum(self.seg_counts) if self.seg_counts else full
        # scale the static tuple by the fraction of layers actually built
        frac = layers / full
        return tuple(int(x * frac) for x in h) + (chips,)

    def result_titles(self):
        return RESULT_TITLES

    def timeout(self):
        return self.deadline

    def group_parameter_titles(self):
        return ("arch", "shape", "mesh")

    # --- execution -------------------------------------------------------
    def _json_name(self) -> str:
        probe = "full" if self.seg_counts is None else \
            "L" + "-".join(map(str, self.seg_counts))
        v = "_".join(f"{k}-{val}" for k, val in sorted(self.variant.items()))
        v = ("_" + v) if v else ""
        return f"{self.arch}__{self.shape}__{self.mesh}__{probe}{v}.json"

    def run(self):
        os.makedirs(self.out_dir, exist_ok=True)
        json_path = os.path.join(self.out_dir, self._json_name())
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", self.arch, "--shape", self.shape,
               "--json", json_path, "--device", self.device]
        if self.mesh_shape is not None:
            cmd += ["--mesh-shape"] + [str(x) for x in self.mesh_shape]
            cmd += ["--mesh-axes"] + list(self.mesh_axes)
        elif self.mesh == "multi":
            cmd.append("--multi-pod")
        if self.seg_counts is not None:
            cmd += ["--seg-counts"] + [str(c) for c in self.seg_counts]
        if self.variant:
            cmd += ["--variant"] + [f"{k}={v}"
                                    for k, v in self.variant.items()]
        env = dict(os.environ)
        src = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = os.pathsep.join(
            [src] + [p for p in [env.get("PYTHONPATH")] if p])

        # run in its own process group so a worker-level kill reaps it
        proc = subprocess.Popen(cmd, env=env, start_new_session=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

        def _kill(*_):
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            sys.exit(1)

        signal.signal(signal.SIGTERM, _kill)
        try:
            out, _ = proc.communicate(timeout=self.deadline + 120)
        except subprocess.TimeoutExpired:
            _kill()
        if proc.returncode != 0:
            tail = "\n".join(out.splitlines()[-15:]) if out else ""
            raise RuntimeError(
                f"dryrun failed rc={proc.returncode}:\n{tail}")
        with open(json_path) as f:
            rec = json.load(f)
        if rec.get("status") == "inapplicable":
            return ("inapplicable", "", 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                    json_path)
        roof = rec["roofline"]
        return (rec["status"], roof["dominant"], roof["compute_s"], roof["memory_s"],
                roof["collective_s"], roof["useful_ratio"],
                roof["roofline_fraction"], rec["compile_s"], json_path)


def probe_plans(arch: str) -> list[tuple]:
    """Unrolled probe seg-count combos for linear extrapolation: a base
    point and +1 along each segment."""
    cfg = get_config(arch)
    counts = segment_counts(cfg)
    base = tuple(min(c, 2) if len(counts) == 1 else (1 if i == 0 else 2)
                 for i, c in enumerate(counts))
    if cfg.hybrid_block:
        base = (1,)
    plans = [base]
    for i in range(len(counts)):
        bumped = list(base)
        bumped[i] += 1
        plans.append(tuple(bumped))
    return plans
