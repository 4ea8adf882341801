"""The port's train step as a body a CUDA graph can replay, on the CPU:
params and optimizer state are donated buffers that each step updates in
place, as ``jax.jit(train_step, donate_argnums=(0, 1))`` lets XLA update
JAX's (``repro/train/loop.py:92``).

Reduced smollm-360m and mamba2-130m in fp32, weights made by the JAX
initialiser and carried across with the weight bridge; batches from
``batch_at`` (numpy, identical in both).  Tolerances are those of
``tests/test_torch_train.py``: losses, norms and lr within 1e-4; each leaf
of the params and the optimizer state within 1e-3 of its largest
magnitude.  On the card the same body is captured once and replayed
(``tests/test_torch_cuda.py`` holds the replays to the eager body, bit
for bit).
"""
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread a process: pytest-xdist's workers share the host's
# cores, and each would otherwise start a pool as wide as the host
torch.set_num_threads(1)

from repro.configs import reduced_config as jax_reduced_config
from repro.models import lm as jlm
from repro.models.params import _path_str, cast_tree, init_params
from repro.train import optimizer as jax_opt
from repro.train.schedule import warmup_cosine as jax_warmup_cosine
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import reduced_config
from repro_torch.data import synthetic
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.train import optimizer
from repro_torch.train.loop import TrainJob, run_training
from repro_torch.train.schedule import constant, warmup_cosine
from repro_torch.train.train_step import GraphedStep, make_train_step

TOL = dict(atol=1e-4, rtol=1e-4)
LEAF_TOL = 1e-3


def _flat_numpy(tree) -> dict:
    return {_path_str(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_torch(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree.detach()}
    out = {}
    for k, v in items:
        out.update(_flat_torch(v, f"{prefix}/{k}" if prefix else k))
    return out


@functools.cache
def _model(arch: str):
    """(jax cfg, port cfg, jax fp32 params, port fp32 params)."""
    cfg_j = jax_reduced_config(arch).replace(dtype="float32")
    pj = cast_tree(init_params(jlm.make_lm(cfg_j), jax.random.PRNGKey(0)),
                   jnp.float32)
    pt = params_from_numpy(_flat_numpy(pj), device="cpu")
    return cfg_j, reduced_config(arch).replace(dtype="float32"), pj, pt


def _batches(n: int) -> list[dict]:
    dc = synthetic.DataConfig(vocab_size=256, seq_len=40, batch_size=2,
                              seed=2)
    return [synthetic.batch_at(dc, step) for step in range(n)]


@pytest.mark.parametrize("name,arch", [
    pytest.param("adamw", "smollm-360m", id="adamw"),
    pytest.param("adafactor", "smollm-360m", id="adafactor"),
    pytest.param("adamw", "mamba2-130m", id="adamw-mamba2-130m"),
    pytest.param("adafactor", "mamba2-130m", id="adafactor-mamba2-130m")])
def test_donated_steps_keep_addresses_and_match_jitted_jax(name, arch):
    """Three steps with warmup 2 (lr 0, then 5e-4, then 1e-3): the body
    returns the trees it was given, every param and state leaf keeps its
    ``data_ptr``, and loss, ce, grad norm and lr at each step and the
    final params and state match JAX's jitted step with donated
    (params, opt_state) at ``test_torch_train.py``'s bounds (largest leaf
    error measured: AdamW 3.3e-6 smollm, 3.4e-5 mamba; Adafactor 1.5e-6
    and 1.7e-5)."""
    cfg_j, cfg_t, pj, pt = _model(arch)
    oj, ot = jax_opt.get_optimizer(name), optimizer.get_optimizer(name)
    jstep = jax.jit(jax_make_train_step(cfg_j, oj,
                                        jax_warmup_cosine(1e-3, 2, 10),
                                        clip_norm=1.0, remat=True),
                    donate_argnums=(0, 1))
    step_t = make_train_step(cfg_t, ot, warmup_cosine(1e-3, 2, 10),
                             clip_norm=1.0, remat=True)
    # copies: the cached weights stay, and fp32 params are their own AdamW
    # master in JAX, which one call cannot donate twice
    pj = jax.tree_util.tree_map(jnp.copy, pj)
    sj = jax.tree_util.tree_map(jnp.copy, oj.init(pj))
    pt = tree_map(torch.clone, pt)
    st = ot.init(pt)
    ptrs = [t.data_ptr() for t in tree_leaves((pt, st))]
    for step, batch in enumerate(_batches(3)):
        pj, sj, mj = jstep(pj, sj, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                           jnp.asarray(step))
        out = step_t(pt, st, {k: torch.from_numpy(v)
                              for k, v in batch.items()}, step)
        assert out[0] is pt and out[1] is st
        assert [t.data_ptr() for t in tree_leaves((pt, st))] == ptrs
        for key in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(float(out[2][key]), float(mj[key]),
                                       err_msg=f"{key} at step {step}", **TOL)
    assert int(st["count"]) == 3
    for got, want in ((pt, pj), (st, sj)):
        got, want = _flat_torch(got), _flat_numpy(want)
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            w = w.astype(np.float32)
            err = float(np.abs(got[path].float().numpy() - w).max())
            assert err <= LEAF_TOL * float(np.abs(w).max()), (path, err)


def test_lr_from_a_step_tensor_matches_jax():
    """The lr computed from an int32 step tensor equals JAX's
    ``warmup_cosine`` at steps 0-5 (warmup 2: ramp, peak, decay; rel 1e-6,
    one fp32 rounding of the cosine), from one buffer rewritten in place,
    as a graph's step counter is; both schedules stay on the step's
    device (a meta tensor here: no CPU scalar is mixed in)."""
    ours, ref = warmup_cosine(1e-3, 2, 6), jax_warmup_cosine(1e-3, 2, 6)
    counter = torch.zeros((), dtype=torch.int32)
    for step in range(6):
        counter.fill_(step)
        assert float(ours(counter)) == pytest.approx(
            float(ref(jnp.asarray(step))), rel=1e-6, abs=1e-12)
    meta = torch.zeros((), dtype=torch.int32, device="meta")
    for lr in (ours(meta), constant(1e-3)(meta)):
        assert lr.device.type == "meta" and lr.dtype == torch.float32


def test_graphed_step_on_the_cpu_runs_the_body():
    """On the CPU ``GraphedStep`` calls the body on numpy batches: the same
    bits as the body called directly, and nothing captured."""
    cfg = reduced_config("smollm-360m").replace(dtype="float32")
    _, _, _, pt = _model("smollm-360m")
    opt = optimizer.AdamW()
    step_fn = make_train_step(cfg, opt, warmup_cosine(1e-3, 2, 10))
    a, b = tree_map(torch.clone, pt), tree_map(torch.clone, pt)
    sa, sb = opt.init(a), opt.init(b)
    run = GraphedStep(step_fn, a, sa)
    for step, batch in enumerate(_batches(2)):
        got = run(batch, step)
        want = step_fn(b, sb, {k: torch.from_numpy(v)
                               for k, v in batch.items()}, step)[2]
        assert float(got["loss"]) == float(want["loss"])
    for x, y in zip(tree_leaves((a, sa)), tree_leaves((b, sb)), strict=True):
        assert torch.equal(x, y)
    assert run.stats["captures"] == 0 and run.per_replay == {}


def test_async_checkpoint_holds_its_step_after_the_next_update(tmp_path,
                                                               monkeypatch):
    """The checkpoint saved at step 3 holds step 3's params and optimizer
    state, bit for bit (those of the same run checkpointed inline),
    although its writer thread writes only after step 4 has updated them in
    place: ``save`` copies every leaf, CPU leaves too, before it returns."""
    cfg = reduced_config("smollm-360m")
    dc = synthetic.data_config_for(cfg, seq_len=32, batch_size=2)
    k = 3
    stepped = threading.Event()
    savez = np.savez

    def late_savez(*args, **kwargs):
        stepped.wait(timeout=60)
        return savez(*args, **kwargs)

    def log(line):
        if line.startswith(f"[train] step {k} "):
            stepped.set()

    def job(path, async_ckpt):
        return TrainJob(total_steps=k + 1, ckpt_every=k, ckpt_dir=str(path),
                        log_every=1, warmup=2, async_ckpt=async_ckpt)

    run_training(cfg, dc, job(tmp_path / "inline", False), device="cpu",
                 log=lambda *a: None)
    monkeypatch.setattr(ckpt.np, "savez", late_savez)
    run_training(cfg, dc, job(tmp_path / "async", True), device="cpu",
                 log=log)
    assert stepped.is_set()
    like_p = lm.init_lm(cfg, device="meta")
    like = {"params": like_p, "opt": optimizer.AdamW().init(like_p)}
    got, step, _ = ckpt.restore(str(tmp_path / "async"), like, step=k,
                                device="cpu")
    want, _, _ = ckpt.restore(str(tmp_path / "inline"), like, step=k,
                              device="cpu")
    last, _, _ = ckpt.restore(str(tmp_path / "async"), like, step=k + 1,
                              device="cpu")
    assert step == k
    assert not torch.equal(last["params"]["embed"], want["params"]["embed"])
    for path, w in _flat_torch(want).items():
        assert torch.equal(_flat_torch(got)[path], w), path
