"""Training of the Jamba hybrid in the port against the JAX package, on the
CPU in fp32: reduced ``jamba-v0.1-52b`` (8 layers in two super-blocks of
4, attention at in-block index 2, Mamba-2 elsewhere at (P, N) = (32, 16),
MoE on odd indices, 8 experts top-2).

``train_loss``'s ce, aux and loss and the gradients leaf by leaf against
``jax.value_and_grad`` (the reference checkpoints one super-block as the
scan body; the port one layer of it at a time, under the same policy);
the same gradients with remat on and off; one ``make_train_step`` step
with AdamW and with Adafactor against JAX's jitted step (params and
optimizer state); the optimizer side's slices (``params.stack_slices``,
its threshold monkeypatched low): the global norm, the clip and
Adafactor's update of a sliced leaf against the whole-leaf arithmetic and
against JAX's step, and at the real threshold only jamba's expert stacks
sliced; a resumed ``run_training`` ending on the bits of an unbroken one,
through checkpoints that carry the two-axis group stacks and Adafactor's
factored state; the launcher; and eight Adafactor steps of reduced
deepseek-v3-671b and jamba under the card run's warmup-then-cosine
schedule, loss and grad norm at every step against JAX's (ROADMAP Queue C
item C1).

Weights, batches and bounds are ``tests/test_torch_moe_train.py``'s: 1e-4
for values of order 1, updated params and optimizer state within 1e-3 of
a leaf's largest magnitude; gradient leaves within 5e-5 of theirs, the
bound ``tests/test_torch_train.py`` holds reduced mamba2-130m's to (the
Mamba scalars' gradients are sums of decay terms over every token; here
through 8 layers, 1.9e-5 measured at A_log, ~1e-5 elsewhere).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread a process: pytest-xdist's workers share the host's
# cores, and each would otherwise start a pool as wide as the host
torch.set_num_threads(1)

from repro.models import lm as jlm
from repro.train import optimizer as jax_opt
from repro.train.schedule import warmup_cosine as jax_warmup_cosine
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import get_config, reduced_config
from repro_torch.data import synthetic
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.models import params as tparams
from repro_torch.models.params import tree_map
from repro_torch.train import optimizer
from repro_torch.train.loop import TrainJob, run_training
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.train_step import make_train_step
from test_torch_moe_train import (TOL, _batch, _flat, _flat_bits,
                                  _flat_tensors, _model, assert_trees_close,
                                  eight_adafactor_steps)

ARCH = "jamba-v0.1-52b"
EXPERTS = ("ffn/wi", "ffn/wg", "ffn/wo")


def _grads(remat: bool):
    """(metrics, gradient tree) of the port's train_loss on reduced Jamba;
    a leaf that gets no gradient reads as zeros, as the train step treats
    it."""
    _, tcfg, _, pt = _model(ARCH)
    _, bt = _batch(tcfg.vocab_size)
    leaves = tree_map(lambda p: p.clone().requires_grad_(), pt)
    loss, metrics = lm.train_loss(tcfg, leaves, bt, remat=remat)
    loss.backward()
    return ({k: v.detach() for k, v in metrics.items()},
            tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                     else p.grad, leaves))


def test_train_loss_and_gradients_match_jax():
    """ce, aux and loss within 1e-4 under remat; every gradient leaf (the
    two-axis group stacks of both super-blocks, the Mamba scalars, the
    routers and experts) within 5e-5 of its largest magnitude, and none
    all zero."""
    jcfg, _, pj, _ = _model(ARCH)
    bj, _ = _batch(jcfg.vocab_size)
    (_, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: jlm.train_loss(jcfg, p, bj, remat=True), has_aux=True))(pj)
    mt, gt = _grads(remat=True)
    assert sorted(mt) == sorted(mj) == ["aux", "ce", "loss"]
    for key in mj:
        np.testing.assert_allclose(float(mt[key]), float(mj[key]), **TOL)
    assert float(mt["aux"]) > 0
    assert_trees_close(gt, gj, 5e-5)
    flat = _flat(gt)
    assert {p.split("/")[2] for p in flat if p.startswith("segments/")} == {
        "mamba_dense", "mamba_moe", "attn_dense"}
    for path, g in flat.items():
        assert np.abs(g).max() > 0, path


def test_remat_gives_the_same_gradients():
    """Remat reruns each layer of a super-block in the backward, the SSD
    scan and the experts' products included, picking the same experts
    (the router's product is saved): the gradients with and without it
    are the same bits."""
    _, g_remat = _grads(remat=True)
    _, g_plain = _grads(remat=False)
    for (path, a), b in zip(_flat(g_remat).items(), _flat(g_plain).values(),
                            strict=True):
        np.testing.assert_array_equal(a, b, err_msg=path)


# the card run's schedule shape: base lr 3e-4, warmup 1, then cosine over
# 8 steps (``chip_smoke.py``'s train turns)
SCHEDULE = (3e-4, 1, 8)


@functools.cache
def _jax_step_fn(arch: str, name: str):
    jcfg = _model(arch)[0]
    return jax.jit(jax_make_train_step(
        jcfg, jax_opt.get_optimizer(name), jax_warmup_cosine(*SCHEDULE),
        clip_norm=1.0, remat=True))


@functools.cache
def _jax_step(name: str):
    """(params, state, metrics) of JAX's jitted step at step 3 from reduced
    Jamba's weights and batch."""
    jcfg, _, pj, _ = _model(ARCH)
    bj, _ = _batch(jcfg.vocab_size)
    oj = jax_opt.get_optimizer(name)
    return _jax_step_fn(ARCH, name)(pj, oj.init(pj), bj, jnp.asarray(3))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_train_step_matches_jax(name):
    """One step at step 3 of ``SCHEDULE`` from identical weights and batch
    against JAX's jitted step: loss, ce, aux, grad norm and lr within
    1e-4; each leaf of the params and of the optimizer state within 1e-3
    of its largest magnitude; the fp32 Mamba scalars and routers stay
    fp32."""
    _, tcfg, _, pt = _model(ARCH)
    _, bt = _batch(tcfg.vocab_size)
    ot = optimizer.get_optimizer(name)
    step_t = make_train_step(tcfg, ot, warmup_cosine(*SCHEDULE),
                             clip_norm=1.0, remat=True)
    pj2, sj, mj = _jax_step(name)
    pt = tree_map(torch.clone, pt)      # the step updates it in place
    pt2, st, mt = step_t(pt, ot.init(pt), bt, 3)
    assert sorted(mt) == sorted(mj)
    for key in mj:
        np.testing.assert_allclose(float(mt[key]), float(mj[key]), **TOL)
    assert float(mt["grad_norm"]) > 1.0     # the clip is exercised
    _assert_step_close(name, (pt2, st), (pj2, sj), float(mt["lr"]))
    for path, t in _flat_tensors(pt2).items():
        if path.endswith(("A_log", "/D", "dt_bias", "ffn/router")):
            assert t.dtype == torch.float32, path


def _assert_step_close(name, got, want, lr: float):
    """Params and optimizer state after one step, (params, state) each,
    within 1e-3 of each leaf's largest magnitude; AdamW's params and
    fp32 master weights by ``_assert_adamw_params_close``."""
    (gp, gs), (wp, ws) = got, want
    if name != "adamw":
        assert_trees_close(gp, wp, 1e-3)
        assert_trees_close(gs, ws, 1e-3)
        return
    assert sorted(gs) == sorted(ws)
    _assert_adamw_params_close(gp, wp, lr)
    _assert_adamw_params_close(gs["master"], ws["master"], lr)
    assert_trees_close({k: v for k, v in gs.items() if k != "master"},
                       {k: v for k, v in ws.items() if k != "master"}, 1e-3)


def _assert_adamw_params_close(got, want, lr: float):
    """AdamW's first step moves an element by about lr * g / (|g| + eps):
    where the gradient is within its bound of zero (5e-5 of the leaf's
    largest magnitude; these elements' gradients sit near 1e-7 of it), the
    direction is as much noise as the gradient's sign, and an element may
    land up to 2 lr from JAX's.  Those elements are held to 2 lr (plus the
    weight decay's share); every other element to 1e-3 of the leaf's
    largest magnitude, as ``assert_trees_close`` holds them."""
    grads = _flat(_grads(remat=True)[1])
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g, err = grads[path], np.abs(got[path] - w)
        noise = np.abs(g) <= 5e-5 * np.abs(g).max()
        assert err[~noise].max(initial=0.0) <= 1e-3 * np.abs(w).max(), path
        assert err[noise].max(initial=0.0) <= 2 * lr * 1.01, path


def _lowered(monkeypatch):
    """The slicing thresholds cut low enough that reduced Jamba's expert
    stacks [2, 2, 8, 128, 64] (262,144 elements) are sliced at two levels:
    per super-block, then two experts of a layer at a time."""
    monkeypatch.setattr(tparams, "SLICED_UPDATE_ELEMS", 2**16)
    monkeypatch.setattr(tparams, "SLICED_DRAW_ELEMS", 2**14)


def test_stack_slices_cover_each_element_once(monkeypatch):
    """Each element of a sliced leaf lies in exactly one slice, no slice
    reaches into the last two axes, and each slice fits the draw limit;
    a leaf at or under the threshold, or of two axes, is one piece."""
    _lowered(monkeypatch)
    for shape in ((2, 2, 8, 128, 64), (3, 5, 128, 64), (40, 64, 32),
                  (2, 3, 4, 128, 256)):
        hits = torch.zeros(shape, dtype=torch.int32)
        parts = tparams.stack_slices(shape)
        assert len(parts) > 1, shape
        for i in parts:
            assert len(i) <= len(shape) - 2
            hits[i] += 1
            assert hits[i].numel() <= max(tparams.SLICED_DRAW_ELEMS,
                                          math.prod(shape[-2:])), (shape, i)
        assert (hits == 1).all(), shape
    assert tparams.stack_slices((2**16,)) == [()]
    assert tparams.stack_slices((512, 256)) == [()]        # two axes
    assert tparams.stack_slices((4, 128, 128)) == [()]     # at the threshold


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_sliced_optimizer_side_matches_whole_leaves_and_jax(name,
                                                            monkeypatch):
    """With the thresholds monkeypatched low, reduced Jamba's expert
    stacks go slice by slice: the global norm within 1e-6 of the
    whole-leaf one (a different summation order only), the clipped
    gradients, the Adafactor update (its RMS over the whole leaf taken in
    a first pass) and the moments within 1e-6 of the whole-leaf step's,
    and the step still within 1e-3 of JAX's jitted step.  AdamW's update
    is elementwise and is not sliced: its step is unchanged."""
    _, tcfg, _, pt = _model(ARCH)
    _, bt = _batch(tcfg.vocab_size)
    shapes = {p: tuple(t.shape) for p, t in _flat_tensors(pt).items()}
    sliced = sorted(p for p, s in shapes.items()
                    if len(tparams.stack_slices(s)) > 1)
    assert sliced == []
    ot = optimizer.get_optimizer(name)
    step_t = make_train_step(tcfg, ot, warmup_cosine(*SCHEDULE),
                             clip_norm=1.0, remat=True)
    whole = tree_map(torch.clone, pt)
    whole_state = ot.init(whole)
    _, _, m_whole = step_t(whole, whole_state, bt, 3)
    grads = _grads(remat=True)[1]
    norm_whole = optimizer.global_norm(grads)
    clipped_whole, _ = optimizer.clip_by_global_norm(
        tree_map(torch.clone, grads), 1.0)

    _lowered(monkeypatch)
    sliced = sorted(p for p, s in shapes.items()
                    if len(tparams.stack_slices(s)) > 1)
    assert {f"segments/0/mamba_moe/{e}" for e in EXPERTS} < set(sliced)
    norm = optimizer.global_norm(grads)
    np.testing.assert_allclose(float(norm), float(norm_whole), rtol=1e-6)
    clipped, _ = optimizer.clip_by_global_norm(tree_map(torch.clone, grads),
                                               1.0)
    assert_trees_close(clipped, clipped_whole, 1e-6)
    got = tree_map(torch.clone, pt)
    got_state = ot.init(got)
    _, _, m = step_t(got, got_state, bt, 3)
    for key in m_whole:
        np.testing.assert_allclose(float(m[key]), float(m_whole[key]),
                                   rtol=1e-6)
    assert_trees_close(got, whole, 1e-6)
    assert_trees_close(got_state, whole_state, 1e-6)
    pj2, sj, _ = _jax_step(name)
    _assert_step_close(name, (got, got_state), (pj2, sj), float(m["lr"]))


def test_only_jambas_expert_stacks_are_sliced_at_the_real_threshold():
    """At ``SLICED_UPDATE_ELEMS`` every leaf of the configs that train
    today (at the depth the card trains them, and olmoe-1b-7b and
    phi-3-vision-4.2b whole) keeps the whole-leaf arithmetic, and so its
    bits; jamba-v0.1-52b cut to one super-block slices its three expert
    stacks only, each into 16 slices of 4 experts."""
    for arch, layers in (("smollm-360m", None), ("mamba2-130m", None),
                         ("olmoe-1b-7b", None), ("deepseek-v3-671b", 3),
                         ("musicgen-medium", None),
                         ("phi-3-vision-4.2b", None), (ARCH, 8)):
        cfg = get_config(arch)
        if layers:
            cfg = cfg.replace(num_layers=layers)
        descr = _flat_descr(lm.make_lm(cfg))
        sliced = {p: tparams.stack_slices(d.shape) for p, d in descr.items()
                  if len(tparams.stack_slices(d.shape)) > 1}
        if arch != ARCH:
            assert not sliced, arch
            continue
        assert sorted(sliced) == [f"segments/0/mamba_moe/{e}"
                                  for e in sorted(EXPERTS)]
        for path, parts in sliced.items():
            assert sorted(descr[path].shape) == [1, 4, 16, 4096, 14336]
            assert len(parts) == 16
            assert parts[0] == (0, 0, slice(0, 4))


def _flat_descr(tree, prefix: str = "") -> dict:
    if isinstance(tree, tparams.Param):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out: dict = {}
    for k, v in items:
        out.update(_flat_descr(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def test_run_training_resumes_after_injected_failure(tmp_path):
    """bf16, as the launcher trains, Adafactor: a run cut by an injected
    failure after step 7, resumed from its step-6 checkpoint, ends on the
    same bits as a run that never failed; the checkpoint holds the
    two-axis group stacks, the fp32 Mamba scalars and the factored second
    moments (vr, vc) of the expert stacks."""
    cfg = reduced_config(ARCH)
    dc = synthetic.data_config_for(cfg, seq_len=40, batch_size=2)

    def job(path, **kw):
        return TrainJob(total_steps=12, ckpt_every=3, ckpt_dir=str(path),
                        log_every=3, warmup=2, async_ckpt=False,
                        optimizer="adafactor", **kw)

    with pytest.raises(RuntimeError, match="injected failure"):
        run_training(cfg, dc, job(tmp_path / "a", fail_after_step=7),
                     device="cpu", log=lambda *a: None)
    assert max(ckpt.available_steps(str(tmp_path / "a"))) == 6
    with np.load(tmp_path / "a" / "step_6" / "arrays.npz") as arrays:
        keys = set(arrays.files)
        assert arrays["params/segments/0/mamba_moe/ffn/wi"].shape == (
            2, 2, 8, 128, 64)
        assert arrays["params/segments/0/mamba_dense/mixer/A_log"].dtype \
            == np.float32
        assert arrays["opt/v/segments/0/mamba_moe/ffn/wi/vr"].shape == (
            2, 2, 8, 128)
    assert {"opt/v/segments/0/mamba_moe/ffn/wi/vc",
            "params/segments/0/attn_dense/mixer/wq"} <= keys
    logs = []
    hist, final, params = run_training(cfg, dc, job(tmp_path / "a"),
                                       device="cpu", log=logs.append)
    assert final == 12 and hist[0]["step"] == 6
    assert logs[0] == "[train] restored checkpoint at step 6"
    _, _, straight = run_training(cfg, dc, job(tmp_path / "b"), device="cpu",
                                  log=lambda *a: None)
    for (path, a), b in zip(_flat_bits(params).items(),
                            _flat_bits(straight).values(), strict=True):
        np.testing.assert_array_equal(a, b, err_msg=path)
    assert _flat_tensors(params)["embed"].dtype == torch.bfloat16


def test_launcher_trains_the_reduced_hybrid_on_the_cpu(capsys):
    launch_train.main(["--arch", ARCH, "--preset", "reduced", "--steps", "4",
                       "--seq", "40", "--batch", "2", "--optimizer",
                       "adafactor", "--device", "cpu"])
    assert "done at step 4" in capsys.readouterr().out


def test_eight_adafactor_steps_track_jax():
    """ROADMAP Queue C item C1, for reduced jamba
    (``tests/test_torch_moe_train.py`` holds deepseek-v3-671b's):
    ``eight_adafactor_steps`` under ``SCHEDULE``, the port's loss and grad
    norm within 1e-4 (relative) of JAX's at every step."""
    eight_adafactor_steps(ARCH, _jax_step_fn(ARCH, "adafactor"))
