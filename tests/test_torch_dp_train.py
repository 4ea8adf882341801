"""Data-parallel training of the port (``torch.distributed``, gloo CPU
ranks) against the JAX package's single-device step on the same global
batch (``tests/test_sharding.py`` holds the reference's own sharded step
to its single-device one the same way).

Reduced smollm-360m and mamba2-130m in fp32, weights made by the JAX
initialiser, two steps of AdamW and of Adafactor at 2, 3 and 4 ranks,
with ZeRO-1 on and off: at 3 ranks the batch of 4 does not divide, so
the batch is replicated, as the reference's spec drops the data axis.
The loss mask gives each rank a different count of positions (one row
wholly masked).  Bounds: the loss, cross-entropy and grad norm within
``TOL`` = 1e-4 (``tests/test_torch_train.py``'s training bound); params
and optimizer state leaf by leaf within 1e-3 of the leaf's largest
magnitude, ``tests/test_torch_train.py::test_train_step_matches_jax``'s
bound for a step (AdamW's first steps are about lr * sign(g), so a
gradient near 0 moves its update by a share of lr).  ZeRO-1 changes no
bit of AdamW's update (elementwise over the rank's slice) and only the
order of Adafactor's sums (held within 1e-5 of each leaf's largest
magnitude).

Each test spawns its ranks once (a process a rank on a ``file://`` store)
and runs its cases inside them.
"""
import functools
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread a process: pytest-xdist's workers share the host's
# cores, and each would otherwise start a pool as wide as the host
torch.set_num_threads(1)

from jax.sharding import AbstractMesh
from repro.configs import reduced_config as jax_reduced_config
from repro.models import lm as jlm
from repro.models.params import _path_str, cast_tree, init_params
from repro.train import optimizer as jax_opt
from repro.train.schedule import warmup_cosine as jax_warmup_cosine
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import reduced_config
from repro_torch.data import synthetic
from repro_torch.launch import train as launch_train
from repro_torch.sharding.rules import make_rules
from repro_torch.train.loop import TrainJob, run_training

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
LEAF_TOL = 1e-3
ARCHS = ("smollm-360m", "mamba2-130m")
OPTS = ("adamw", "adafactor")
B, S = 4, 40
STEPS = (3, 4)      # warmup 2 of 10: both steps at lr > 0


def _flat(tree) -> dict:
    return {_path_str(p): np.asarray(x, np.float32) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(step: int) -> dict:
    dc = synthetic.DataConfig(vocab_size=256, seq_len=S, batch_size=B,
                              seed=1)
    tokens = synthetic.batch_at(dc, step)["tokens"]
    mask = np.ones(tokens.shape, np.float32)
    mask[0, -5:] = 0.0
    mask[2, :20] = 0.0
    mask[3] = 0.0                 # a rank of 4 with no position counted
    return {"tokens": tokens, "loss_mask": mask}


@functools.cache
def _jax_params(arch: str):
    cfg = jax_reduced_config(arch).replace(dtype="float32")
    return cfg, cast_tree(init_params(jlm.make_lm(cfg),
                                      jax.random.PRNGKey(0)), jnp.float32)


@functools.cache
def _jax_run(arch: str, name: str):
    """(per-step metrics, params and state after the steps) of the JAX
    single-device step on the global batches."""
    cfg, params = _jax_params(arch)
    opt = jax_opt.get_optimizer(name)
    step_fn = jax.jit(jax_make_train_step(cfg, opt,
                                          jax_warmup_cosine(1e-3, 2, 10),
                                          clip_norm=1.0, remat=True))
    p, state, metrics = params, opt.init(params), []
    for step in STEPS:
        p, state, m = step_fn(p, state, {k: jnp.asarray(v) for k, v in
                                         _batch(step).items()},
                              jnp.asarray(step))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _flat(p), _flat(state)


_WORKER = r"""
import pickle
import sys

import numpy as np
import torch

torch.set_num_threads(1)
from repro_torch import distributed
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import reduced_config
from repro_torch.data.synthetic import data_config_for
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.params import Param, init_params
from repro_torch.sharding.rules import NamedSharding, make_rules, use_rules
from repro_torch.sharding.zero import opt_state_shardings
from repro_torch.train.loop import TrainJob, run_training
from repro_torch.train.optimizer import get_optimizer
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.train_step import make_train_step

rank, world, store, inp, out = sys.argv[1:6]
rank, world = int(rank), int(world)
distributed.init("cpu", init_method="file://" + store, rank=rank,
                 world_size=world)
mesh = make_mesh((world,), ("data",), device="cpu")
rules = make_rules(mesh)
group = distributed.data_group(mesh)


def full_state(state, shardings):
    sh = ckpt._flatten(shardings)
    return {k: sh[k].full(v).numpy().copy()
            for k, v in ckpt._flatten(state).items()}


def local_bytes(state):
    return sum(t.numel() * t.element_size()
               for t in ckpt._flatten(state).values())


def rows(v):
    part = NamedSharding(mesh, rules.spec(("batch",), v.shape)).part()
    return v if part is None else part.take(v)


def steps(case):
    cfg = reduced_config(case["arch"]).replace(dtype="float32")
    descr = lm.make_lm(cfg)
    params = params_from_numpy(case["params"], device="cpu")
    opt = get_optimizer(case["optimizer"])
    layout = opt.layout(descr, rules, zero1=case["zero1"])
    state = opt.init(params, layout)
    fn = make_train_step(cfg, opt, warmup_cosine(1e-3, 2, 10), clip_norm=1.0,
                         remat=True, group=group, layout=layout)
    metrics = []
    for step, batch in case["batches"]:
        local = {k: torch.from_numpy(rows(v).copy()) for k, v in batch.items()}
        with use_rules(rules):
            params, state, m = fn(params, state, local, step)
        metrics.append({k: float(v) for k, v in m.items()})
    sh = opt_state_shardings(case["optimizer"], descr, rules,
                             zero1=case["zero1"])
    full = full_state(state, sh)
    parts = {k: s.part() for k, s in ckpt._flatten(sh).items()}
    return {"metrics": metrics, "params": params_to_numpy(params),
            "state": full, "state_bytes": local_bytes(state),
            "spec_bytes": sum(v.nbytes // (1 if parts[k] is None
                                           else parts[k].parts)
                              for k, v in full.items()),
            "whole_bytes": sum(v.nbytes for v in full.values())}


def leaves(case):
    descr = {k: Param(tuple(v.shape), (None,) * v.ndim, dtype="float32")
             for k, v in case["params"].items()}
    params = {k: torch.from_numpy(v.copy()) for k, v in case["params"].items()}
    opt = get_optimizer(case["optimizer"])
    layout = opt.layout(descr, rules)
    state = opt.init(params, layout)
    for grads, lr in case["grads"]:
        opt.update({k: torch.from_numpy(v.copy()) for k, v in grads.items()},
                   state, params, torch.tensor(lr), layout=layout)
    sh = opt_state_shardings(case["optimizer"], descr, rules)
    dims = {k: (v if not isinstance(v, dict) else v["p"])
            for k, v in layout.items()}
    return {"params": {k: v.numpy().copy() for k, v in params.items()},
            "state": full_state(state, sh),
            "dims": {k: None if v is None else v.dim for k, v in dims.items()}}


def refused(case):
    # run_training's refusal of the case, None where it trains
    cfg = reduced_config(case["arch"])
    try:
        run_training(cfg, data_config_for(cfg, 16, 2 * world),
                     TrainJob(total_steps=1), device="cpu", rules=rules,
                     log=lambda *a: None)
    except NotImplementedError as e:
        return str(e)
    return None


def train(case):
    cfg = reduced_config(case["arch"]).replace(dtype="float32")
    dc = data_config_for(cfg, S, B)
    try:
        hist, final, params = run_training(cfg, dc, TrainJob(**case["job"]),
                                           device="cpu", rules=rules,
                                           log=lambda *a: None)
    except RuntimeError as e:
        return {"raised": str(e)}
    return {"history": hist, "final": final,
            "params": params_to_numpy(params)}


def restored(case):
    cfg = reduced_config(case["arch"]).replace(dtype="float32")
    descr = lm.make_lm(cfg)
    opt = get_optimizer(case["optimizer"])
    like_p = init_params(descr, None, "meta")
    like = {"params": like_p,
            "opt": opt.init(like_p, opt.layout(descr, rules))}
    sh = {"opt": opt_state_shardings(case["optimizer"], descr, rules)}
    state, step, _ = ckpt.restore(case["dir"], like, device="cpu",
                                  shardings=sh)
    full = {f"opt/{k}": v for k, v in full_state(state["opt"],
                                                 sh["opt"]).items()}
    full.update({f"params/{k}": v
                 for k, v in params_to_numpy(state["params"]).items()})
    return {"step": step, "state": full}


B, S = int(sys.argv[6]), int(sys.argv[7])
cases = pickle.load(open(inp, "rb"))
results = [globals()[case["kind"]](case) for case in cases]
if rank == 0:
    with open(out, "wb") as f:
        pickle.dump(results, f)
distributed.shutdown()
"""


def run_ranks(world: int, cases: list, tmp_path, name: str) -> list:
    """The cases in ``world`` rank processes; rank 0's results."""
    return start_ranks(world, cases, tmp_path, name)()


def start_ranks(world: int, cases: list, tmp_path, name: str):
    """Start the cases in ``world`` rank processes; returns a function
    that waits for them and returns rank 0's results."""
    inp, out = tmp_path / f"{name}.in", tmp_path / f"{name}.out"
    inp.write_bytes(pickle.dumps(cases))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world),
         str(tmp_path / f"{name}.store"), str(inp), str(out), str(B),
         str(S)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=ROOT) for r in range(world)]

    def wait() -> list:
        done = [p.communicate(timeout=300) + (p.returncode,) for p in procs]
        for so, se, rc in done:
            assert rc == 0, so[-2000:] + se[-4000:]
        return pickle.loads(out.read_bytes())

    return wait


def assert_close_leaves(got: dict, want: dict, leaf_tol: float):
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = np.asarray(got[path], np.float32)
        assert g.shape == w.shape, path
        err = float(np.abs(g - w).max())
        assert err <= leaf_tol * float(np.abs(w).max()), (path, err)


def _step_cases(world: int) -> list:
    combos = [(a, o, z) for a in ARCHS for o in OPTS for z in (True, False)]
    if world == 3:
        combos = [(a, o, True) for a in ARCHS for o in OPTS]
    return [{"kind": "steps", "arch": a, "optimizer": o, "zero1": z,
             "params": _flat(_jax_params(a)[1]),
             "batches": [(s, _batch(s)) for s in STEPS]} for a, o, z in combos]


def _leaf_case(name: str) -> dict:
    rng = np.random.default_rng(5)
    shapes = {"a": (3, 8), "b": (8, 3), "c": (4, 6, 5), "d": (5,),
              "e": (6,), "f": (12, 12)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [({k: (rng.standard_normal(s) * 1e-2).astype(np.float32)
               for k, s in shapes.items()}, lr) for lr in (1e-2, 3e-3)]
    return {"kind": "leaves", "optimizer": name, "params": params,
            "grads": grads}


def _jax_leaves(case: dict):
    opt = jax_opt.get_optimizer(case["optimizer"])
    p = {k: jnp.asarray(v) for k, v in case["params"].items()}
    state = opt.init(p)
    for grads, lr in case["grads"]:
        p, state = opt.update({k: jnp.asarray(v) for k, v in grads.items()},
                              state, p, jnp.float32(lr))
    return _flat(p), _flat(state)


@pytest.mark.parametrize("world", [2, 3, 4])
def test_dp_steps_match_the_jax_single_device_step(world, tmp_path):
    """Each (arch, optimizer, ZeRO-1) case: two steps at ``world`` ranks
    against JAX's two steps on the whole batch; the optimizer alone on
    leaves whose ZeRO dim is a stack dim, the rows (which Adafactor's
    column statistic and row normaliser reduce over) or the columns
    (which its row statistic reduces over), against JAX's update; at 2
    ranks an MoE config trains (it routes over the global token set, held
    to JAX in ``tests/test_torch_tp_train.py``)."""
    cases = _step_cases(world) + [_leaf_case(o) for o in OPTS]
    if world == 2:
        cases.append({"kind": "refused", "arch": "olmoe-1b-7b"})
    wait = start_ranks(world, cases, tmp_path, "dp")
    for arch in ARCHS:          # while the ranks run
        for name in OPTS:
            _jax_run(arch, name)
    results = wait()
    by_zero = {}
    for case, res in zip(cases, results, strict=True):
        if case["kind"] == "steps":
            want_m, want_p, want_s = _jax_run(case["arch"],
                                              case["optimizer"])
            for got, want in zip(res["metrics"], want_m, strict=True):
                for key in ("loss", "ce", "grad_norm", "lr"):
                    np.testing.assert_allclose(got[key], want[key], **TOL,
                                               err_msg=f"{case['arch']} "
                                               f"{case['optimizer']} {key}")
            assert_close_leaves(res["params"], want_p, LEAF_TOL)
            assert_close_leaves(res["state"], want_s, LEAF_TOL)
            # each rank keeps the slices the specs lay out, and no more
            assert res["state_bytes"] == res["spec_bytes"]
            if case["zero1"] and world in (2, 4):
                assert res["state_bytes"] < 1.01 * res["whole_bytes"] / world
            if not case["zero1"]:
                assert res["state_bytes"] == res["whole_bytes"]
            by_zero[case["arch"], case["optimizer"], case["zero1"]] = res
        elif case["kind"] == "leaves":
            want_p, want_s = _jax_leaves(case)
            assert_close_leaves(res["params"], want_p, 1e-5)
            assert_close_leaves(res["state"], want_s, 1e-5)
            dims = res["dims"]
            if world == 2:
                assert dims == {"a": 1, "b": 0, "c": 0, "d": None, "e": 0,
                                "f": 0}
            if world == 3:
                assert dims["a"] == 0 and dims["b"] == 1
        else:
            assert res is None, res
    for (arch, opt, zero1), res in by_zero.items():
        if zero1 and (arch, opt, False) in by_zero:
            off = by_zero[arch, opt, False]
            if opt == "adamw":      # elementwise: the same bits
                for k in res["params"]:
                    np.testing.assert_array_equal(res["params"][k],
                                                  off["params"][k])
            # Adafactor: the sums over a sliced dim in another order;
            # the second step's gradients carry it (3.5e-6 of the leaf's
            # largest magnitude measured, mamba's embed, whose distance
            # from JAX is 6.9e-6 either way)
            assert_close_leaves(res["params"], off["params"], 1e-5)


def test_elastic_restore_from_2_ranks_onto_1_and_4(tmp_path):
    """A 2-rank run (ZeRO-1, AdamW, bf16 params) fails after step 3 with a
    checkpoint at step 3.  Resumed on 2 ranks, it ends on the bits of the
    uninterrupted 2-rank run.  Restored onto 1 and onto 4 ranks, the state
    each rank holds gathers back to the checkpoint's leaves bit for bit,
    and the history goes on as the uninterrupted run's within the
    reference's sharded-parity bounds for bf16 (``tests/test_sharding.py``:
    loss 5e-2, params 3e-2): the gradients are summed in another order."""
    job = dict(total_steps=6, ckpt_every=3, log_every=1, warmup=2,
               async_ckpt=False, base_lr=1e-3)
    d = tmp_path / "ckpt"
    first = run_ranks(2, [
        {"kind": "train", "arch": "smollm-360m", "job": job},
        {"kind": "train", "arch": "smollm-360m",
         "job": dict(job, ckpt_dir=str(d), fail_after_step=3)},
        {"kind": "train", "arch": "smollm-360m",
         "job": dict(job, ckpt_dir=str(d))}], tmp_path, "two")
    straight, resumed = first[0], first[2]
    assert [h["step"] for h in straight["history"]] == list(range(6))
    assert "injected failure at step 3" in first[1]["raised"]
    assert resumed["history"] == straight["history"][3:]
    for k, v in straight["params"].items():
        np.testing.assert_array_equal(resumed["params"][k], v, err_msg=k)
    with np.load(d / "step_3" / "arrays.npz") as f:
        saved = {k: f[k] for k in f.files}
    waits = {}
    for world in (1, 4):        # both worlds at once
        dw = tmp_path / f"ckpt{world}"
        shutil.copytree(d, dw)
        shutil.rmtree(dw / "step_6")
        waits[world] = start_ranks(world, [
            {"kind": "restored", "arch": "smollm-360m", "optimizer": "adamw",
             "dir": str(dw)},
            {"kind": "train", "arch": "smollm-360m",
             "job": dict(job, ckpt_dir=str(dw))}], tmp_path, f"w{world}")
    for world, wait in waits.items():
        dw = tmp_path / f"ckpt{world}"
        res = wait()
        assert res[0]["step"] == 3
        assert sorted(res[0]["state"]) == sorted(saved)
        for k, v in saved.items():
            np.testing.assert_array_equal(res[0]["state"][k], v, err_msg=k)
        hist = res[1]["history"]
        assert [h["step"] for h in hist] == [3, 4, 5]
        for h in hist:
            want = straight["history"][h["step"]]
            assert abs(h["loss"] - want["loss"]) < 5e-2, (world, h, want)
            assert h["lr"] == want["lr"]
        for k, v in straight["params"].items():
            np.testing.assert_allclose(_f32(res[1]["params"][k]), _f32(v),
                                       atol=3e-2, rtol=3e-2, err_msg=k)
        # the checkpoint is the same file at any world size
        with np.load(dw / "step_6" / "arrays.npz") as f:
            assert {k: f[k].shape for k in f.files} == {
                k: v.shape for k, v in saved.items()}


def _f32(a: np.ndarray) -> np.ndarray:
    """A leaf as fp32 (bf16 leaves come as their uint16 bits)."""
    if a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def test_refusals_name_item_9b():
    """What a model axis does not split yet names Queue A item 9b (Mamba-2
    and MLA at a model axis of 2), and sequence sharding names item 9c,
    before any process group starts."""
    on_model = make_rules(AbstractMesh((2, 2), ("data", "model")))
    for arch in ("mamba2-130m", "deepseek-v3-671b"):
        cfg = reduced_config(arch)
        dc = synthetic.data_config_for(cfg, 16, 4)
        with pytest.raises(NotImplementedError, match="Queue A item 9b"):
            run_training(cfg, dc, TrainJob(total_steps=1), device="cpu",
                         rules=on_model)
    cfg = reduced_config("smollm-360m")
    with pytest.raises(NotImplementedError, match="Queue A item 9c"):
        run_training(cfg, synthetic.data_config_for(cfg, 16, 4),
                     TrainJob(total_steps=1), device="cpu",
                     rules=make_rules(AbstractMesh((4,), ("data",)),
                                      seq_shard=True))
    with pytest.raises(NotImplementedError, match="Queue A item 9b"):
        launch_train.main(["--arch", "mamba2-130m", "--mesh", "2", "4",
                           "--device", "cpu"])
    assert not torch.distributed.is_initialized()


def test_launcher_runs_under_torchrun():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--standalone",
         "-m", "repro_torch.launch.train", "--mesh", "2", "--preset",
         "reduced", "--steps", "3", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert r.stdout.count("done at step 3") == 1     # rank 0 alone prints
