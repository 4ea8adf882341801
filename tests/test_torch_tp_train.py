"""Training of the port on a (data, model) mesh (``torch.distributed``,
gloo CPU ranks) against the JAX package's single-device step on the same
global batch: the ``model`` axis's tensor-parallel attention, FFN and
vocabulary and its experts split over the ranks, with the data axis
above it (``sharding/tp.py``).

GSPMD changes the layout of the reference's step, not its arithmetic, so
the single-device step on the whole batch is the oracle for every mesh
(``REPRO_MOE=gather``, whose routing and capacity rank the global token
set; the expert-parallel dispatch has its own semantics and its own
oracle, ``tests/test_torch_ep.py``).  Reduced configs in fp32, weights
made by the JAX initialiser and cut to each rank's parts by the bridge:

  * smollm-360m: 3 query heads, which split over no model axis here, so
    attention stays whole on every rank; the FFN and the vocabulary
    split; the head is tied to the embedding;
  * qwen3-4b: 4 query heads over one KV head, so the query heads split
    and the KV head is replicated; qk-norm;
  * olmoe-1b-7b: 8 experts split over the model axis; the MoE under a
    data axis of 2 at (2, 2).

Two steps of AdamW and of Adafactor at (1, 2), (2, 2) and (1, 4), ZeRO-1
on and off at (2, 2) (at data 1 it slices nothing), against
``tests/test_torch_dp_train.py``'s bounds: the loss, cross-entropy and
grad norm within ``TOL``, params and optimizer state leaf by leaf within
``LEAF_TOL`` of the leaf's largest magnitude; and each rank holds the
bytes its layout's specs count, less than the whole where the axes split.
"""
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from test_torch_dp_train import (B, LEAF_TOL, OPTS, ROOT, S, STEPS, TOL,
                                 _batch, _f32, _flat, _jax_leaves,
                                 _jax_params, _jax_run, _leaf_case,
                                 assert_close_leaves)

ARCHS = ("smollm-360m", "qwen3-4b", "olmoe-1b-7b")

_WORKER = r"""
import os
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
from repro_torch.models.params import cast_tree, init_params, tree_map2
from repro_torch.sharding import tp
from repro_torch.sharding.rules import NamedSharding, make_rules, use_rules
from repro_torch.sharding.zero import opt_state_shardings
from repro_torch.train.loop import TrainJob, run_training
from repro_torch.train.optimizer import get_optimizer
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.train_step import make_train_step

rank, world, store, inp, out = sys.argv[1:6]
rank, world = int(rank), int(world)
D, M, B, S = (int(a) for a in sys.argv[6:10])
distributed.init("cpu", init_method="file://" + store, rank=rank,
                 world_size=world)
mesh = make_mesh((D, M), ("data", "model"), device="cpu")
rules = make_rules(mesh)
group = distributed.data_group(mesh)


def whole(tree, shardings) -> dict:
    sh = ckpt._flatten(shardings)
    return {k: sh[k].full(v) for k, v in ckpt._flatten(tree).items()}


def counted(tree, shardings) -> tuple[int, int, int]:
    # (bytes held, the whole leaves' bytes over the parts the specs lay
    # them out in, whole bytes)
    sh = ckpt._flatten(shardings)
    held = spec = full = 0
    for k, v in ckpt._flatten(tree).items():
        n = 1
        for part in (sh[k].model_part(), sh[k].part()):
            n *= 1 if part is None else part.parts
        size = sh[k].full(v).numel() * v.element_size()
        held += v.numel() * v.element_size()
        spec += size // n
        full += size
    return held, spec, full


def setup(case):
    os.environ["REPRO_MOE"] = case.get("moe", "gather")
    cfg = reduced_config(case["arch"]).replace(dtype="float32")
    descr = tp.layout_descr(cfg, lm.make_lm(cfg), rules)
    return cfg, descr


def steps(case):
    cfg, descr = setup(case)
    psh = tp.param_shardings(cfg, descr, rules)
    parts = tp.param_parts(cfg, descr, rules)
    params = params_from_numpy(case["params"], "cpu", ckpt._flatten(parts))
    opt = get_optimizer(case["optimizer"])
    layout = opt.layout(descr, rules, zero1=case["zero1"])
    state = opt.init(params, layout)
    rows = NamedSharding(mesh, rules.spec(("batch",), (B,))).part()
    fn = make_train_step(cfg, opt, warmup_cosine(1e-3, 2, 10), clip_norm=1.0,
                         remat=True, group=group, layout=layout,
                         model_parts=parts,
                         rows_split=rows is not None and rows.parts > 1)
    metrics = []
    for step, batch in case["batches"]:
        local = {k: torch.from_numpy(
            (v if rows is None else rows.take(v)).copy())
            for k, v in batch.items()}
        with use_rules(rules):
            params, state, m = fn(params, state, local, step)
        metrics.append({k: float(v) for k, v in m.items()})
    osh = opt_state_shardings(case["optimizer"], descr, rules,
                              zero1=case["zero1"])
    if case.get("save"):
        # the steps' state as a checkpoint of whole leaves (rank 0 writes)
        ckpt.save(case["save"], len(metrics), {"params": params,
                                               "opt": state},
                  shardings={"params": psh, "opt": osh})
    p_held, p_spec, p_full = counted(params, psh)
    s_held, s_spec, s_full = counted(state, osh)
    return {"metrics": metrics,
            "params": {k: v.numpy().copy()
                       for k, v in whole(params, psh).items()},
            "state": {k: v.numpy().copy()
                      for k, v in whole(state, osh).items()},
            "bytes": {"params": (p_held, p_spec, p_full),
                      "state": (s_held, s_spec, s_full)}}


def train(case):
    cfg, _ = setup(case)
    dc = data_config_for(cfg, S, B)
    try:
        hist, final, params = run_training(cfg, dc, TrainJob(**case["job"]),
                                           device="cpu", rules=rules,
                                           log=lambda *a: None)
    except RuntimeError as e:
        return {"raised": str(e)}
    psh = tp.param_shardings(cfg, tp.layout_descr(cfg, lm.make_lm(cfg),
                                                  rules), rules)
    full = tree_map2(lambda x, sh: sh.full(x), params, psh)
    return {"history": hist, "final": final,
            "params": params_to_numpy(full)}


def restored(case):
    cfg, descr = setup(case)
    opt = get_optimizer(case["optimizer"])
    layout = opt.layout(descr, rules)
    like_p = init_params(descr, None, "meta",
                         tp.param_parts(cfg, descr, rules))
    if case.get("float32"):     # a checkpoint of fp32 steps, kept fp32
        like_p = cast_tree(like_p, torch.float32)
    like = {"params": like_p, "opt": opt.init(like_p, layout)}
    sh = {"params": tp.param_shardings(cfg, descr, rules),
          "opt": opt_state_shardings(case["optimizer"], descr, rules)}
    state, step, _ = ckpt.restore(case["dir"], like, device="cpu",
                                  shardings=sh)
    full = {k: v.detach() for k, v in whole(state, sh).items()}
    return {"step": step, "state": params_to_numpy(full)}


def thread_backward(case):
    # the remat backward run on another thread, as autograd's device
    # thread runs it on the card: the same gradients as on this one
    import threading

    from repro_torch.models.params import tree_leaves, tree_map

    cfg, descr = setup(case)
    parts = tp.param_parts(cfg, descr, rules)
    params = params_from_numpy(case["params"], "cpu", ckpt._flatten(parts))
    batch = {k: torch.from_numpy(v) for k, v in case["batches"][0][1].items()}
    grads = []
    for threaded in (False, True):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        with use_rules(rules):
            loss, _ = lm.train_loss(cfg, leaves, batch, remat=True)
        if threaded:
            t = threading.Thread(target=loss.backward)
            t.start()
            t.join()
        else:
            loss.backward()
        grads.append([p.grad for p in tree_leaves(leaves)])
    return all(torch.equal(a, b) for a, b in zip(*grads, strict=True))


def leaves(case):
    # the optimizer alone on whole leaves with the stack-slice threshold
    # set low, so that the leaves it cuts take ZeRO-1's sliced path
    from repro_torch.models import params as P
    from repro_torch.models.params import Param, stack_slices

    P.SLICED_UPDATE_ELEMS, P.SLICED_DRAW_ELEMS = case["sliced"]
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
    cut = {k: len(stack_slices(
        v.shape if layout[k]["p"] is None else layout[k]["p"].take(v).shape))
        for k, v in params.items()}
    return {"params": {k: v.numpy().copy() for k, v in params.items()},
            "state": {k: v.numpy().copy()
                      for k, v in whole(state, sh).items()},
            "cut": cut}


cases = pickle.load(open(inp, "rb"))
results = [globals()[case["kind"]](case) for case in cases]
if rank == 0:
    with open(out, "wb") as f:
        pickle.dump(results, f)
distributed.shutdown()
"""


def start_ranks(mesh: tuple, cases: list, tmp_path, name: str,
                env: dict | None = None):
    """Start the cases in one rank process a rank of ``mesh`` (data,
    model); returns a function that waits for them and returns rank 0's
    results."""
    world = mesh[0] * mesh[1]
    inp, out = tmp_path / f"{name}.in", tmp_path / f"{name}.out"
    inp.write_bytes(pickle.dumps(cases))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               **(env or {}))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world),
         str(tmp_path / f"{name}.store"), str(inp), str(out), *map(str, mesh),
         str(B), str(S)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=ROOT) for r in range(world)]

    def wait() -> list:
        done = [p.communicate(timeout=300) + (p.returncode,) for p in procs]
        for so, se, rc in done:
            assert rc == 0, so[-2000:] + se[-4000:]
        return pickle.loads(out.read_bytes())

    return wait


def step_case(arch: str, optimizer: str, zero1: bool = True,
              moe: str = "gather") -> dict:
    return {"kind": "steps", "arch": arch, "optimizer": optimizer,
            "zero1": zero1, "moe": moe, "params": _flat(_jax_params(arch)[1]),
            "batches": [(s, _batch(s)) for s in STEPS]}


def check_steps(res: dict, want: tuple, label: str, mesh: tuple) -> None:
    want_m, want_p, want_s = want
    for got, w in zip(res["metrics"], want_m, strict=True):
        for key in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(got[key], w[key], **TOL,
                                       err_msg=f"{label} {key}")
    assert_close_leaves(res["params"], want_p, LEAF_TOL)
    assert_close_leaves(res["state"], want_s, LEAF_TOL)
    for what, (held, spec, full) in res["bytes"].items():
        # each rank holds what its layout's specs count, and less than
        # the whole where the axes split something (the params over the
        # model axis alone)
        assert held == spec, (label, what, held, spec)
        if mesh[1] > 1 or what == "state":
            assert held < full, (label, what, held, full)


MESHES = [(1, 2), (2, 2), (1, 4)]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_tp_steps_match_the_jax_single_device_step(mesh, tmp_path):
    combos = [(a, o, True) for a in ARCHS for o in OPTS]
    if mesh[0] > 1:
        combos += [(a, o, False) for a in ARCHS for o in OPTS]
    cases = [step_case(a, o, z) for a, o, z in combos]
    wait = start_ranks(mesh, cases, tmp_path, "tp")
    for arch in ARCHS:          # while the ranks run
        for name in OPTS:
            _jax_run(arch, name)
    results = wait()
    by = {}
    for case, res in zip(cases, results, strict=True):
        label = f"{case['arch']} {case['optimizer']} zero1={case['zero1']}"
        check_steps(res, _jax_run(case["arch"], case["optimizer"]), label,
                    mesh)
        by[case["arch"], case["optimizer"], case["zero1"]] = res
    for (arch, opt, zero1), res in by.items():
        if not zero1:
            on = by[arch, opt, True]
            # ZeRO-1 slices the state over the data axis, and only there
            assert on["bytes"]["state"][0] < res["bytes"]["state"][0]
            assert on["bytes"]["params"] == res["bytes"]["params"]


def test_remat_backward_on_another_thread(tmp_path):
    """The backward's recompute of a checkpointed layer runs on autograd's
    device thread on the card, outside the forward's context: it must see
    the forward's rules (``lm._in_context``), or the recomputed layer
    would drop its model-axis collectives."""
    case = dict(step_case("olmoe-1b-7b", "adamw"), kind="thread_backward")
    assert start_ranks((1, 2), [case], tmp_path, "thread")() == [True]


def test_adafactor_zero1_over_stack_slices_matches_jax(tmp_path):
    """Adafactor with ZeRO-1 on leaves that the optimizer side takes a
    stack slice at a time (``params.stack_slices``, its threshold set low
    in the ranks): each rank steps its ZeRO-1 slice slice by slice, the
    update's RMS summed over the ranks, against JAX's update on the whole
    leaves."""
    case = dict(_leaf_case("adafactor"), sliced=(16, 30))
    res, = start_ranks((2, 1), [dict(case, kind="leaves")], tmp_path,
                       "sliced")()
    want_p, want_s = _jax_leaves(case)
    assert_close_leaves(res["params"], want_p, 1e-5)
    assert_close_leaves(res["state"], want_s, 1e-5)
    assert res["cut"]["c"] > 1 and res["cut"]["f"] == 1


def test_checkpoint_saved_at_2x2_restores_at_1x1_and_1x4(tmp_path):
    """A (2, 2) run of reduced qwen3-4b (AdamW, ZeRO-1, bf16 params, split
    query heads and vocabulary) checkpoints at step 3; restored onto (1, 1)
    and onto (1, 4), the state each rank holds gathers back to the
    checkpoint's leaves bit for bit, and the run goes on as the
    uninterrupted one within the reference's sharded-parity bounds for bf16
    (loss 5e-2, params 3e-2)."""
    job = dict(total_steps=6, ckpt_every=3, log_every=1, warmup=2,
               async_ckpt=False, base_lr=1e-3)
    d = tmp_path / "ckpt"
    arch = "qwen3-4b"
    first = start_ranks((2, 2), [
        {"kind": "train", "arch": arch, "job": job},
        {"kind": "train", "arch": arch,
         "job": dict(job, ckpt_dir=str(d), fail_after_step=3)}],
        tmp_path, "two")()
    straight = first[0]
    assert [h["step"] for h in straight["history"]] == list(range(6))
    assert "injected failure at step 3" in first[1]["raised"]
    with np.load(d / "step_3" / "arrays.npz") as f:
        saved = {k: f[k] for k in f.files}
    waits = {}
    for mesh in ((1, 1), (1, 4)):       # both meshes at once
        dw = tmp_path / f"ckpt{mesh[1]}"
        shutil.copytree(d, dw)
        waits[mesh] = start_ranks(mesh, [
            {"kind": "restored", "arch": arch, "optimizer": "adamw",
             "dir": str(dw)},
            {"kind": "train", "arch": arch,
             "job": dict(job, ckpt_dir=str(dw))}], tmp_path,
            f"m{mesh[1]}")
    for mesh, wait in waits.items():
        res = wait()
        assert res[0]["step"] == 3
        assert sorted(res[0]["state"]) == sorted(saved)
        for k, v in saved.items():
            np.testing.assert_array_equal(res[0]["state"][k], v,
                                          err_msg=f"{mesh} {k}")
        hist = res[1]["history"]
        assert [h["step"] for h in hist] == [3, 4, 5]
        for h in hist:
            want = straight["history"][h["step"]]
            assert abs(h["loss"] - want["loss"]) < 5e-2, (mesh, h, want)
        for k, v in straight["params"].items():
            np.testing.assert_allclose(_f32(res[1]["params"][k]), _f32(v),
                                       atol=3e-2, rtol=3e-2,
                                       err_msg=f"{mesh} {k}")
        dw = tmp_path / f"ckpt{mesh[1]}"
        with np.load(dw / "step_6" / "arrays.npz") as f:
            assert {k: f[k].shape for k in f.files} == {
                k: v.shape for k, v in saved.items()}


def test_launcher_runs_a_model_axis_under_torchrun():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--standalone", "-m", "repro_torch.launch.train", "--mesh", "1",
         "2", "--arch", "olmoe-1b-7b", "--preset", "reduced", "--steps", "3",
         "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert r.stdout.count("done at step 3") == 1     # rank 0 alone prints
