"""The port's dry-run on a mesh (``repro_torch.launch.dryrun`` with
``--mesh-shape`` / ``--multi-pod``), on the CPU: one rank of a fake world
of the mesh's size (``distributed.fake_world``) traced on ``meta``.

* the reference's small-mesh cells (``tests/test_dryrun_small.py``) with
  its assertions: smollm-360m x train_4k, mamba2-130m x long_500k and
  musicgen-medium x decode_32k on (2, 4) (data, model), qwen3-4b x
  long_500k inapplicable, smollm-360m x decode_32k on (2, 2, 2) (pod, data,
  model);
* ``input_specs``' per-leaf local shapes against the reference's
  ``input_specs(cfg, shape, rules)`` shard shapes on an Auto-axes host
  mesh of 8 devices in a JAX subprocess, for configs whose heads divide
  the model axis; the leaves where the port's layout differs by design
  (``MAMBA_WHOLE``: GSPMD cuts ``in_proj``'s and the conv's columns
  mid-head; the port holds them whole and each rank's Mamba cache at its
  own heads and channels) are listed and held to that layout;
* one dense prefill cell's collective bytes at (1, 2) against their closed
  form: an all-reduce after each layer's attention and FFN and after the
  embedding, and the logits' all-gather;
* the rank's FLOPs times the chips no less than the one-card count; a
  (1, 1) mesh equal to one card in FLOPs, bytes and estimate;
* the production meshes (16 x 16, 2 x 16 x 16), ``dp_only`` and
  ``moe=ep``;
* ``seq_shard``, ``kv_shard_model`` and ``sp_model`` refused, naming item
  9c part 2; and no process group left behind.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

from repro_torch import distributed
from repro_torch.configs import ShapeConfig, get_config, get_shape
from repro_torch.launch import dryrun
from repro_torch.launch.inputs import input_specs
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding.rules import make_rules
from repro_torch.train.optimizer import get_optimizer

ROOT = Path(__file__).resolve().parents[1]
MESH = dict(mesh_shape=(2, 4), mesh_axes=("data", "model"))
META = dict(device="meta", verbose=False)


@pytest.fixture(autouse=True)
def no_world_left():
    yield
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# the reference's small-mesh cells
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape", [
    ("smollm-360m", "train_4k"),
    ("mamba2-130m", "long_500k"),
    ("musicgen-medium", "decode_32k"),
])
def test_dryrun_cell_small_mesh(arch, shape):
    rec = dryrun.run_cell(arch, shape, **MESH, **META)
    assert rec["status"] == "ok"
    roof = rec["roofline"]
    assert roof["hlo_flops"] > 0
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert rec["chips"] == 8 and rec["mesh"] == "data2xmodel4"
    assert "estimate (meta trace)" in rec["memory_analysis"]
    assert rec["collectives"] == "counted, not run"
    assert rec["rank"] == 0 and rec["coordinate"] == [0, 0]
    assert roof["collective_bytes_per_chip"] > 0
    assert roof["collective_counts"]["all-reduce"] > 0


def test_dryrun_inapplicable_cell():
    rec = dryrun.run_cell("qwen3-4b", "long_500k", **MESH, **META)
    assert rec["status"] == "inapplicable"


def test_dryrun_multipod_axes_small():
    rec = dryrun.run_cell("smollm-360m", "decode_32k", mesh_shape=(2, 2, 2),
                          mesh_axes=("pod", "data", "model"), **META)
    assert rec["status"] == "ok"
    assert rec["mesh"] == "pod2xdata2xmodel2" and rec["chips"] == 8


def test_the_cli_lowers_a_mesh_cell(tmp_path):
    out = tmp_path / "cell.json"
    dryrun.main(["--arch", "musicgen-medium", "--shape", "decode_32k",
                 "--mesh-shape", "2", "4", "--mesh-axes", "data", "model",
                 "--seg-counts", "2", "--device", "meta", "--json", str(out)])
    rec = json.loads(out.read_text())
    assert (rec["status"], rec["chips"], rec["mesh"]) == ("ok", 8,
                                                          "data2xmodel4")
    assert rec["roofline"]["collective_s"] > 0


# ---------------------------------------------------------------------------
# the rank's input trees against the reference's shard shapes
# ---------------------------------------------------------------------------
SPEC_ARCHS = ("qwen3-4b", "olmoe-1b-7b", "deepseek-v3-671b",
              "phi-3-vision-4.2b", "musicgen-medium", "mamba2-130m",
              "jamba-v0.1-52b")
SPEC_SHAPES = [ShapeConfig("t", 64, 8, "train"),
               ShapeConfig("p", 64, 8, "prefill"),
               ShapeConfig("d", 64, 8, "decode")]
# the leaves a Mamba-2 mixer holds otherwise than GSPMD: ``in_proj`` and
# the conv whole (params and their optimizer state), the cache at the
# rank's heads (``ssm``, which the reference replicates) and channels
# (``conv``, which it cuts contiguously)
MAMBA_WHOLE = ("in_proj", "conv_w", "conv_b", "conv", "ssm")

_REF_SPECS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import numpy as np
from repro.configs import get_config
from repro.configs.shapes import ShapeConfig
from repro.launch.inputs import input_specs
from repro.models.params import _path_str
from repro.sharding.rules import make_rules
from repro.train.optimizer import get_optimizer

archs, shapes = json.loads(sys.argv[1])
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 4),
                         ("data", "model"))
rules = make_rules(mesh)
out = {}
for arch in archs:
    for name, seq, batch, kind in shapes:
        for opt_name in (("adamw", "adafactor") if kind == "train"
                         else ("adamw",)):
            args = input_specs(get_config(arch),
                               ShapeConfig(name, seq, batch, kind), rules,
                               opt=get_optimizer(opt_name), opt_name=opt_name)
            leaves = jax.tree_util.tree_flatten_with_path(args)[0]
            out[f"{arch}/{kind}/{opt_name}"] = {
                _path_str(p): list(x.sharding.shard_shape(x.shape)
                                   if x.sharding is not None else x.shape)
                for p, x in leaves}
print(json.dumps(out))
"""


def _port_flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: list(tree.shape)}
    out = {}
    for k, v in items:
        out.update(_port_flat(v, f"{prefix}/{k}" if prefix else k))
    return out


def test_input_specs_are_the_reference_shard_shapes():
    shapes = [[s.name, s.seq_len, s.global_batch, s.kind] for s in SPEC_SHAPES]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF_SPECS,
                        json.dumps([SPEC_ARCHS, shapes])],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    with distributed.fake_world(8):
        rules = make_rules(make_mesh((2, 4), ("data", "model"),
                                     device="meta"))
        for key, ref in want.items():
            arch, kind, opt_name = key.split("/")
            shape = next(s for s in SPEC_SHAPES if s.kind == kind)
            got = _port_flat(input_specs(get_config(arch), shape, rules,
                                         opt=get_optimizer(opt_name),
                                         opt_name=opt_name))
            assert sorted(got) == sorted(ref), key
            differ = {p for p in ref if got[p] != ref[p]}
            mamba = {p for p in ref
                     if set(p.split("/")) & set(MAMBA_WHOLE)}
            has_ssm = get_config(arch).ssm is not None
            assert differ <= (mamba if has_ssm else set()), \
                (key, sorted(differ))
            for p in differ:        # held whole, or at the rank's heads
                name = p.rsplit("/", 1)[-1]
                if name in ("in_proj", "conv_w", "conv_b"):
                    assert all(g >= w for g, w in zip(got[p], ref[p],
                                                      strict=True)), (key, p)
            if has_ssm and kind == "decode":
                # the cache at the rank's heads and channels, which GSPMD
                # lays out otherwise
                assert any(p.endswith("/ssm") for p in differ), key


# ---------------------------------------------------------------------------
# the counts
# ---------------------------------------------------------------------------
def test_prefill_collectives_have_their_closed_form():
    """qwen3-4b prefill_32k, 2 layers, at (1, 2): an all-reduce of the
    rank's [B, S, d] bf16 activations after each layer's attention and FFN
    and after the embedding (2L + 1, each weighted 2x), and the all-gather
    of the last position's logits over the vocabulary's halves."""
    rec = dryrun.run_cell("qwen3-4b", "prefill_32k", seg_counts=(2,),
                          mesh_shape=(1, 2), mesh_axes=("data", "model"),
                          **META)
    cfg, shape = get_config("qwen3-4b"), get_shape("prefill_32k")
    L, B, S = 2, shape.global_batch, shape.seq_len
    act = B * S * cfg.d_model * 2
    logits = B * cfg.vocab_size * 2
    roof = rec["roofline"]
    assert rec["collectives_counted"] == {
        "all-reduce": {"bytes": (2 * L + 1) * act, "calls": 2 * L + 1},
        "all-gather": {"bytes": logits, "calls": 1}}
    assert roof["collective_bytes_per_chip"] == 2 * (2 * L + 1) * act \
        + logits
    assert roof["collective_counts"] == {"all-reduce": 2 * L + 1,
                                         "all-gather": 1}


@pytest.mark.parametrize("arch,shape", [("smollm-360m", "decode_32k"),
                                        ("qwen3-4b", "train_4k"),
                                        ("mamba2-130m", "prefill_32k")])
def test_rank_flops_times_chips_cover_one_card(arch, shape):
    one = dryrun.run_cell(arch, shape, seg_counts=(2,), **META)
    mesh = dryrun.run_cell(arch, shape, seg_counts=(2,), **MESH, **META)
    assert mesh["roofline"]["hlo_flops"] >= one["roofline"]["hlo_flops"]
    assert mesh["bytes_per_device_inputs"] < one["bytes_per_device_inputs"]


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_a_one_by_one_mesh_is_one_card(shape):
    one = dryrun.run_cell("olmoe-1b-7b", shape, seg_counts=(2,), **META)
    mesh = dryrun.run_cell("olmoe-1b-7b", shape, seg_counts=(2,),
                           mesh_shape=(1, 1), mesh_axes=("data", "model"),
                           **META)
    assert mesh["chips"] == 1 and mesh["mesh"] == "data1xmodel1"
    for key in ("counted", "peak_estimate_bytes", "bytes_per_device_inputs",
                "kernels"):
        assert mesh[key] == one[key], key
    assert mesh["roofline"]["collective_bytes_per_chip"] == 0.0


# ---------------------------------------------------------------------------
# production meshes and variants
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw,want", [
    (dict(mesh_shape=(16, 16), mesh_axes=("data", "model")),
     "data16xmodel16"),
    (dict(multi_pod=True), "pod2xdata16xmodel16"),
])
def test_production_meshes_lower(kw, want):
    rec = dryrun.run_cell("musicgen-medium", "decode_32k", seg_counts=(2,),
                          **kw, **META)
    assert rec["status"] == "ok" and rec["mesh"] == want
    assert rec["chips"] == (512 if "multi_pod" in kw else 256)
    # decode_32k's 128 rows over the data axes, 24 heads whole at 16
    assert rec["bytes_per_device_inputs"] < dryrun.run_cell(
        "musicgen-medium", "decode_32k", seg_counts=(2,),
        **META)["bytes_per_device_inputs"]


def test_dp_only_and_moe_ep_lower():
    kw = dict(seg_counts=(2,), mesh_shape=(16, 16),
              mesh_axes=("data", "model"), **META)
    base = dryrun.run_cell("olmoe-1b-7b", "train_4k", **kw)
    dp = dryrun.run_cell("olmoe-1b-7b", "train_4k",
                         variant={"dp_only": 1}, **kw)
    ep = dryrun.run_cell("olmoe-1b-7b", "train_4k", variant={"moe": "ep"},
                         **kw)
    for rec in (base, dp, ep):
        assert rec["status"] == "ok"
    # dp_only: the params whole on every rank, the batch over all 256
    assert dp["bytes_per_device_inputs"] > base["bytes_per_device_inputs"]
    # ep routes each data shard's tokens alone: no gather of the rows
    assert ep["roofline"]["collectives"] != base["roofline"]["collectives"]
    assert os.environ.get("REPRO_MOE") is None
    # zero1=0 holds the whole optimizer state on each rank
    whole = dryrun.run_cell("olmoe-1b-7b", "train_4k",
                            variant={"zero1": 0}, **kw)
    assert whole["bytes_per_device_inputs"] > base["bytes_per_device_inputs"]


@pytest.mark.parametrize("k", ["seq_shard", "kv_shard_model", "sp_model"])
def test_sequence_sharding_is_refused(k):
    with pytest.raises(NotImplementedError, match="item 9c part 2"):
        dryrun.run_cell("smollm-360m", "decode_32k", variant={k: 1}, **MESH,
                        **META)
