"""The port stands alone: no JAX, nothing of the JAX package ``repro``, no
library attention kernel, and no silent CPU fallback."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None            # any import of jax now fails
import torch

# one intra-op thread a process: pytest-xdist's workers share the host's
# cores, and each would otherwise start a pool as wide as the host
torch.set_num_threads(1)

import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
# the autotuner and its copy of the ExpoCloud core, named explicitly
import repro_torch.core.experiment
import repro_torch.tune.cache
import repro_torch.tune.tuner
from repro_torch.configs import reduced_config
from repro_torch.models import lm
from repro_torch.models.params import init_params
from repro_torch.serve.engine import DecodeEngine
cfg = reduced_config("smollm-360m")
params = init_params(lm.make_lm(cfg), torch.Generator().manual_seed(0),
                     device="cpu")
try:
    DecodeEngine(cfg, params, device="cuda")
    cuda = "constructed"
except RuntimeError as e:
    cuda = "raised: " + str(e)
from repro_torch.data.synthetic import data_config_for
from repro_torch.train.loop import TrainJob, run_training
try:
    run_training(cfg, data_config_for(cfg, 16, 2), TrainJob(total_steps=1),
                 device="cuda", log=lambda *a: None)
    train = "ran"
except RuntimeError as e:
    train = "raised: " + str(e)
print(json.dumps({
    "imported": names,
    "repro": sorted(m for m in sys.modules
                    if m == "repro" or m.startswith("repro.")),
    "jax": sorted(m for m in sys.modules
                  if (m == "jax" or m.startswith("jax.")) and sys.modules[m]),
    "cuda_available": torch.cuda.is_available(),
    "cuda_engine": cuda,
    "cuda_train": train,
}))
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                          text=True, env=env, timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("serve.engine", "serve.kv_pool", "kernels.flash_attention",
                 "kernels.ssd_scan", "models.mamba", "train.loop",
                 "train.optimizer", "train.schedule", "train.train_step",
                 "checkpoint.checkpointer", "data.synthetic",
                 "launch.train", "core.experiment", "tune.tuner",
                 "tune.cache"):
        assert f"repro_torch.{name}" in out["imported"]
    assert out["repro"] == [] and out["jax"] == []
    if not out["cuda_available"]:
        # asked for the card on a box without one: raise, never run on CPU
        for what in ("cuda_engine", "cuda_train"):
            assert out[what].startswith("raised:")
            assert "torch.cuda.is_available() is False" in out[what]


_FORBIDDEN = {
    "imports jax": re.compile(r"^\s*(import|from)\s+jax\b", re.M),
    "imports repro": re.compile(r"^\s*(import|from)\s+repro(\.|\s|$)", re.M),
    "calls torch.compile": re.compile(r"torch\.compile\b"),
    "calls a library attention kernel": re.compile(
        r"scaled_dot_product_attention|flash_attn"),
}


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_stay_independent(path):
    text = path.read_text()
    for what, pattern in _FORBIDDEN.items():
        if path.name == "chip_smoke.py" and what.startswith("calls a library"):
            continue    # chip_smoke times the library call as a yardstick only
        assert not pattern.search(text), f"{path.name} {what}"


def test_cuda_sources_target_hopper():
    from repro_torch.kernels import cuda_build
    srcs = sorted((PORT / "kernels" / "csrc").glob("*.cu"))
    assert [p.name for p in srcs] == ["decode_attention.cu",
                                      "flash_attention.cu",
                                      "flash_attention_bwd.cu", "ssd_scan.cu",
                                      "ssd_scan_bwd.cu"]
    assert sorted(cuda_build.SOURCES) == [p.name for p in srcs]
    for p in srcs:
        head = p.read_text()[:1500]
        assert "Replaces the TPU kernel repro/kernels/" in head
        assert "What bounds it on this card" in head
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    assert cuda_build.BUILD_DIR == ROOT / "build" / "repro_torch"
