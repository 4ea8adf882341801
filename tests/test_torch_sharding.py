"""The port's sharding rules, ZeRO-1 specs and int8 compression against the
JAX package's (``repro/sharding/*``), and its production meshes.

The specs need no devices: both packages' rules take the same stand-in
mesh (``jax.sharding.AbstractMesh``: axis names and a shape mapping), and
are compared entry by entry for every parameter leaf of every registry
arch at its full config.  The compression transform runs in both
frameworks on the same seeded gradients; ``allreduce_int8`` runs on 2 and
4 gloo CPU ranks against the reference under ``jax.vmap(...,
axis_name="data")``, whose ``pmax``/``psum`` reduce over the stacked
ranks.  Both are held to the last bit: every op is the same IEEE fp32 op
in the same order, and both round half to even.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

# one intra-op thread a process: pytest-xdist's workers share the host's
# cores, and each would otherwise start a pool as wide as the host
torch.set_num_threads(1)

from jax.sharding import AbstractMesh
from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as jax_get_config
from repro.models import lm as jlm
from repro.models.params import _path_str, is_param
from repro.sharding import compression as jax_comp
from repro.sharding import rules as jax_rules
from repro.sharding import zero as jax_zero
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import check_one_card
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.models.params import abstract_params, param_specs
from repro_torch.sharding import compression, rules, zero

ROOT = Path(__file__).resolve().parents[1]

MESHES = {
    "1": ((1,), ("data",)),
    "2x4": ((2, 4), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def _mesh(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes)


def _jax_leaves(tree):
    return {_path_str(p): x for p, x in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_param)[0]}


def _port_leaves(tree, prefix=""):
    """Leaves by path; a spec (a tuple) or a sharding is a leaf."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_port_leaves(v, f"{prefix}/{k}" if prefix else k))
    return out


def _spec(s) -> tuple:
    """Entries of a spec or of a sharding's spec, trailing Nones dropped
    (a spec of fewer entries than dims leaves the rest unsharded)."""
    entries = list(getattr(s, "spec", s))
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


@pytest.mark.parametrize("seq_shard", [False, True], ids=["dp", "seq"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_specs_match_jax_for_every_arch(mesh, seq_shard):
    """``spec``, ``zero1_spec`` and both optimizers' ``opt_state_shardings``
    leaf by leaf, every registry arch at its full config."""
    m = _mesh(mesh)
    rj = jax_rules.make_rules(m, seq_shard=seq_shard)
    rt = rules.make_rules(m, seq_shard=seq_shard)
    assert rt.table == rj.table
    n = 0
    for arch in ARCH_IDS:
        dj = jlm.make_lm(jax_get_config(arch))
        dt = lm.make_lm(get_config(arch))
        pj, pt = _jax_leaves(dj), _port_leaves(dt)
        assert sorted(pj) == sorted(pt), arch
        specs = _port_leaves(param_specs(dt, rt))
        for path, p in pj.items():
            want = rj.spec(p.logical, p.shape)
            got = rt.spec(pt[path].logical, pt[path].shape)
            assert isinstance(got, rules.PartitionSpec)
            assert tuple(got) == tuple(want), (arch, path)
            assert tuple(specs[path]) == tuple(want), (arch, path)
            assert tuple(zero.zero1_spec(got, p.shape, rt)) == tuple(
                jax_zero.zero1_spec(want, p.shape, rj)), (arch, path)
            n += 1
        for opt in ("adamw", "adafactor"):
            for zero1 in (True, False):
                sj = _jax_leaves(jax_zero.opt_state_shardings(
                    opt, dj, rj, zero1=zero1))
                st = _port_leaves(zero.opt_state_shardings(
                    opt, dt, rt, zero1=zero1))
                assert sorted(sj) == sorted(st), (arch, opt)
                for path, s in sj.items():
                    assert _spec(st[path]) == _spec(s), (arch, opt, path)
    assert n > 100


def test_overrides_unknown_names_and_the_repeated_axis_guard():
    m = _mesh("2x16x16")
    cases = [((("batch", "seq", "embed")), (32, 4096, 6144)),
             (("batch", "heads"), (3, 48)),           # batch indivisible
             (("nope", "ffn"), (8, 24576)),            # unknown name
             (("heads", "ffn"), (64, 64)),             # model used twice
             (("batch", "seq_kv", "kv_heads", None), (64, 4096, 1, 128)),
             (("experts", "embed", None, None), (64, 2048)),  # more names
             ((None, "vocab"), (2, 49152))]
    for over in ({}, {"heads": ("data", "model")},
                 {"seq": ("data",), "batch": ("pod",)},
                 {"ffn": ("pod", "data")}, {"vocab": ()}):
        rj = jax_rules.make_rules(m, **over)
        rt = rules.make_rules(m, **over)
        for logical, shape in cases:
            assert tuple(rt.spec(logical, shape)) == tuple(
                rj.spec(logical, shape)), (over, logical)
            assert tuple(rt.spec(logical)) == tuple(rj.spec(logical))
    # the guard: heads and ffn both on 'model' -> the second drops to None
    assert tuple(rules.make_rules(m).spec(("heads", "ffn"), (64, 64))) == (
        "model", None)


def test_abstract_params_and_shard_refusals():
    m = _mesh("2x4")
    rt = rules.make_rules(m)
    descr = lm.make_lm(get_config("smollm-360m"))
    ab = _port_leaves(abstract_params(descr, rt))
    for path, p in _port_leaves(descr).items():
        assert ab[path].value.device.type == "meta"
        assert tuple(ab[path].value.shape) == p.shape
        assert tuple(ab[path].spec) == tuple(rt.spec(p.logical, p.shape))
    x = torch.ones(2, 3)
    assert rules.shard(x, "batch", None) is x          # no rules
    dp = rules.make_rules(AbstractMesh((4, 1), ("data", "model")))
    for held in (dp, rt):       # each rank holds its part already
        with rules.use_rules(held):
            assert rules.shard(x, "batch", None) is x
    with rules.use_rules(rules.make_rules(AbstractMesh((4,), ("data",)),
                                          seq_shard=True)), \
            pytest.raises(NotImplementedError, match="Queue A item 9c"):
        rules.shard(x, "batch", None)
    for arch in ("mamba2-130m", "deepseek-v3-671b"):
        with pytest.raises(NotImplementedError, match="Queue A item 9b"):
            rt.check_supported(get_config(arch))
    rt.check_supported(get_config("olmoe-1b-7b"))
    with pytest.raises(NotImplementedError, match="Queue A item 9b"):
        rules.make_rules(m, embed=("model",)).check_supported()
    with pytest.raises(NotImplementedError, match="Queue A item 9c"):
        check_one_card({}, mesh_shape=(2, 4))


def test_production_mesh_needs_its_ranks():
    for multi_pod, need in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"device_count_required"
                           f"\\(multi_pod={multi_pod}\\) = {need}"):
            make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert not torch.distributed.is_initialized()


def _grads(dtype, step: int) -> dict:
    rng = np.random.default_rng([7, step])
    out = {"w": rng.standard_normal((64, 48)).astype(np.float32) * 0.01,
           "b": rng.standard_normal((48,)).astype(np.float32),
           "s": (rng.standard_normal((3, 5, 7)) * 10.0 ** rng.integers(
               -6, 3, (3, 5, 7))).astype(np.float32)}
    if dtype == "bfloat16":
        out = {k: v.astype(ml_dtypes.bfloat16) for k, v in out.items()}
    return out


def _torch(arr):
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.uint16).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32)
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 \
        else x.view(np.uint32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_error_feedback_compress_matches_jax_bit_for_bit(dtype):
    """Five steps of the error-feedback transform from the same grads:
    the compressed grads and the residuals equal the reference's bits."""
    init_j, tf_j = jax_comp.make_error_feedback_compress(None)
    init_t, tf_t = compression.make_error_feedback_compress(None)
    g0 = _grads(dtype, 0)
    rj = init_j({k: jnp.asarray(v) for k, v in g0.items()})
    rt = init_t({k: _torch(v) for k, v in g0.items()})
    for step in range(5):
        g = _grads(dtype, step)
        gj, rj = tf_j({k: jnp.asarray(v) for k, v in g.items()}, rj)
        gt, rt = tf_t({k: _torch(v) for k, v in g.items()}, rt)
        for k in g:
            assert gt[k].dtype == _torch(g[k]).dtype
            np.testing.assert_array_equal(_bits(gt[k]), _bits(gj[k]))
            np.testing.assert_array_equal(_bits(rt[k]), _bits(rj[k]))


_RANKS = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch import distributed
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding import rules
from repro_torch.sharding.compression import allreduce_int8

rank, world, store, inp, out = sys.argv[1:6]
rank, world = int(rank), int(world)
distributed.init("cpu", init_method="file://" + store, rank=rank,
                 world_size=world)
mesh = make_mesh((world,), ("data",), device="cpu")
assert distributed.data_group(mesh) is torch.distributed.group.WORLD
assert mesh.get_coordinate() == [rank] or mesh.get_coordinate() == (rank,)
rt = rules.make_rules(mesh)
assert tuple(rt.spec(("batch", None), (4 * world, 3))) == ("data", None)
xs = np.load(inp)
# all_gather along a dim and reduce_scatter along a dim, against their sums
x = torch.arange(12.0).reshape(3, 4) * (rank + 1)
got = distributed.all_gather(x, 1)
assert torch.equal(got, torch.cat([x / (rank + 1) * (r + 1)
                                   for r in range(world)], 1))
whole = torch.arange(6.0 * world).reshape(3, 2 * world) * (rank + 1)
part = distributed.reduce_scatter(whole, 1)
total = whole / (rank + 1) * sum(range(1, world + 1))
assert torch.equal(part, total[:, 2 * rank:2 * rank + 2])
res = {}
for dtype in ("float32", "bfloat16"):
    x = torch.from_numpy(xs[rank]).to(getattr(torch, dtype))
    y = allreduce_int8(x, None)
    assert y.dtype == x.dtype
    res[dtype] = y.float().numpy()
np.savez(out + f".{rank}.npz", **res)
distributed.shutdown()
"""


def run_ranks(script: str, world: int, tmp_path, *args,
              timeout: int = 240) -> list:
    """``script`` in ``world`` processes on a ``file://`` store; returns
    their CompletedProcess results, each asserted to exit 0."""
    store = tmp_path / f"store_{world}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(world), str(store),
         *map(str, args)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=ROOT) for r in range(world)]
    outs = []
    for p in procs:
        so, se = p.communicate(timeout=timeout)
        outs.append((p.returncode, so, se))
    for rc, so, se in outs:
        assert rc == 0, so[-2000:] + se[-4000:]
    return outs


@pytest.mark.parametrize("world", [2, 4])
def test_allreduce_int8_matches_jax_vmap_bit_for_bit(world, tmp_path):
    rng = np.random.default_rng(world)
    scales = np.array([1.0, 1e-3, 40.0, 0.5])[:world, None, None]
    xs = (rng.standard_normal((world, 3, 257)) * scales).astype(np.float32)
    xs[0, 0, :4] = [0.0, -0.0, 1e-30, -1e-30]
    np.save(tmp_path / "xs.npy", xs)
    run_ranks(_RANKS, world, tmp_path, tmp_path / "xs.npy", tmp_path / "y")
    for dtype in ("float32", "bfloat16"):
        xj = jnp.asarray(xs).astype(getattr(jnp, dtype))
        want = jax.vmap(lambda x: jax_comp.allreduce_int8(x, "data"),
                        axis_name="data")(xj)
        want = np.asarray(want.astype(jnp.float32))
        for r in range(world):
            got = np.load(tmp_path / f"y.{r}.npz")[dtype]
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want[r].view(np.uint32))
    # the mean, within the quantisation step of the common scale
    assert np.abs(want[0] - xs.mean(0)).max() <= np.abs(xs).max() / 127
