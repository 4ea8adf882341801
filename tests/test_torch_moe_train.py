"""Training of the MoE and MLA families in the port against the JAX
package, on the CPU in fp32: reduced ``olmoe-1b-7b`` (softmax scoring,
MHA) and reduced ``deepseek-v3-671b`` (MLA at (D, Dv) = (48, 32), sigmoid
scoring with a selection bias and a shared expert, one MTP module).

``train_loss``'s ce, aux, mtp and loss; the gradients leaf by leaf
against ``jax.value_and_grad`` (the selection bias gets a zero gradient,
the aux loss reaches the router only through ``frac_probs``); the same
gradients with remat on and off; one ``make_train_step`` step with AdamW
and with Adafactor against JAX's jitted step (params and optimizer state;
the bias left as JAX leaves it); the MoE layer at capacity factor 0.25
(the same assignments dropped, a dropped assignment's routing weight
gets no gradient, the layer's gradients equal JAX's); the empty MoE stack
of deepseek-v3-671b cut to its dense layers; a resumed ``run_training``
ending on the bits of an unbroken one, through checkpoints that carry the
MTP subtree, the fp32 router and bias and Adafactor's factored state; and
the launcher on both reduced configs.

Weights are drawn with numpy from the JAX parameter descriptors'
distributions (the norms away from their ones, the bias away from its
zeros) and carried across with the weight bridge; batches come from
numpy seeds.  Bounds are ``tests/test_torch_train.py``'s: 1e-4 for values
of order 1, gradient leaves within 1e-5 of their largest magnitude,
updated params and optimizer state within 1e-3.
"""
import dataclasses
import functools

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
from repro.models import moe as jmoe
from repro.models.params import _path_str, is_param
from repro.train import optimizer as jax_opt
from repro.train.schedule import warmup_cosine as jax_warmup_cosine
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import reduced_config
from repro_torch.data import synthetic
from repro_torch.launch import train as launch_train
from repro_torch.models import lm, moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.params import tree_map
from repro_torch.train import optimizer
from repro_torch.train.loop import TrainJob, run_training
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.train_step import make_train_step

ARCHS = ("olmoe-1b-7b", "deepseek-v3-671b")
TOL = dict(atol=1e-4, rtol=1e-4)


def _flat(tree) -> dict:
    """``{path: numpy leaf}`` (fp32 for a port tree) of a JAX tree or of
    a port tree."""
    if isinstance(jax.tree_util.tree_leaves(tree)[0], torch.Tensor):
        return {k: t.float().numpy() for k, t in _flat_tensors(tree).items()}
    return {_path_str(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_tensors(tree, prefix="") -> dict:
    """``{path: tensor}`` of a port tree, with the JAX tree's paths."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree.detach()}
    out = {}
    for k, v in items:
        out.update(_flat_tensors(v, f"{prefix}/{k}" if prefix else k))
    return out


def assert_trees_close(got, want, leaf_tol: float):
    """Each leaf's largest difference within ``leaf_tol`` of the leaf's
    largest magnitude (``tests/test_torch_train.py``'s bound).  NaN must
    stand where the reference has it: Adafactor's column moment of a
    leaf with an empty row axis (an empty layer stack) is the mean of
    nothing, in both frameworks."""
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g, w = got[path], w.astype(np.float32)
        assert g.shape == w.shape, path
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=path)
        g, w = g[~np.isnan(w)], w[~np.isnan(w)]
        if w.size == 0:
            continue
        err = float(np.abs(g - w).max())
        assert err <= leaf_tol * float(np.abs(w).max()), (path, err)


def _draw(descr, seed: int):
    """fp32 arrays for a JAX descriptor tree, drawn with numpy: scaled and
    normal leaves as the initialiser's distributions, the RMSNorm weights
    drawn away from their ones and the sigmoid scoring's selection bias
    away from its zeros (so that it moves the selection)."""
    rng = np.random.default_rng(seed)

    def one(p):
        if p.init == "zeros":
            return jnp.asarray(0.05 * rng.standard_normal(p.shape),
                               jnp.float32)
        if p.init == "ones":
            return jnp.asarray(1 + 0.3 * rng.standard_normal(p.shape),
                               jnp.float32)
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        std = fan_in ** -0.5 if p.init == "scaled" else (p.scale or 0.02)
        return jnp.asarray(std * rng.standard_normal(p.shape), jnp.float32)
    return jax.tree_util.tree_map(one, descr, is_leaf=is_param)


def _cfgs(arch: str, **kw):
    kw.setdefault("dtype", "float32")
    return (jax_reduced_config(arch).replace(**kw),
            reduced_config(arch).replace(**kw))


@functools.cache
def _model(arch: str, num_layers: int | None = None):
    """(JAX cfg, port cfg, JAX params, port params), fp32."""
    kw = {} if num_layers is None else {"num_layers": num_layers}
    jcfg, tcfg = _cfgs(arch, **kw)
    pj = _draw(jlm.make_lm(jcfg), 0)
    return jcfg, tcfg, pj, params_from_numpy(_flat(pj), device="cpu")


def _batch(vocab: int, seed: int = 3, S: int = 40):
    """tokens [2, S] and a loss mask with zeros at the end of row 0."""
    tokens = np.random.default_rng(seed).integers(0, vocab, (2, S)).astype(
        np.int32)
    mask = np.ones(tokens.shape, np.float32)
    mask[0, -5:] = 0.0
    return ({"tokens": jnp.asarray(tokens), "loss_mask": jnp.asarray(mask)},
            {"tokens": torch.from_numpy(tokens),
             "loss_mask": torch.from_numpy(mask)})


@functools.cache
def _jax_value_and_grad(arch: str):
    jcfg, _, pj, _ = _model(arch)
    bj, _ = _batch(jcfg.vocab_size)
    fn = jax.jit(jax.value_and_grad(
        lambda p: jlm.train_loss(jcfg, p, bj, remat=True), has_aux=True))
    (_, metrics), grads = fn(pj)
    return metrics, grads


def _port_grads(arch: str, remat: bool):
    """(metrics, gradient tree) of the port's train_loss; a leaf that gets
    no gradient reads as zeros, as the train step treats it."""
    _, tcfg, _, pt = _model(arch)
    _, bt = _batch(tcfg.vocab_size)
    leaves = tree_map(lambda p: p.clone().requires_grad_(), pt)
    loss, metrics = lm.train_loss(tcfg, leaves, bt, remat=remat)
    loss.backward()
    return {k: v.detach() for k, v in metrics.items()}, tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                             else p.grad, leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match_jax(arch):
    """ce, aux, mtp (deepseek) and loss within 1e-4 under remat; every
    gradient leaf within 1e-5 of its largest magnitude (4e-6 measured at
    deepseek-v3-671b's MLA leaves); the router's gradient is not zero and
    the selection bias's is exactly zero in both frameworks."""
    mj, gj = _jax_value_and_grad(arch)
    mt, gt = _port_grads(arch, remat=True)
    assert sorted(mt) == sorted(mj)
    assert ("mtp" in mt) == (arch == "deepseek-v3-671b")
    for key in mj:
        np.testing.assert_allclose(float(mt[key]), float(mj[key]), **TOL)
    assert float(mt["aux"]) > 0
    assert_trees_close(gt, gj, 1e-5)
    flat_t, flat_j = _flat(gt), _flat(gj)
    routers = [p for p in flat_j if p.endswith("ffn/router")]
    assert routers and all(np.abs(flat_t[p]).max() > 0 for p in routers)
    biases = [p for p in flat_j if p.endswith("ffn/bias")]
    assert bool(biases) == (arch == "deepseek-v3-671b")
    for p in biases:
        assert not flat_t[p].any() and not flat_j[p].any(), p


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_gradients(arch):
    """Remat reruns each backbone layer's dispatch in the backward, picking
    the same experts (the router's product is saved): the gradients with
    and without it are the same bits."""
    _, g_remat = _port_grads(arch, remat=True)
    _, g_plain = _port_grads(arch, remat=False)
    for (path, a), b in zip(_flat(g_remat).items(), _flat(g_plain).values(),
                            strict=True):
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, name):
    """One step at step 3 of warmup 2 from identical weights and batch
    against JAX's jitted step: loss, ce, aux, mtp, grad norm and lr within
    1e-4; each leaf of the params and of the optimizer state within 1e-3
    of its largest magnitude.  The fp32 router and bias stay fp32, the
    bias's moments stay zero (AdamW) and its update is its weight decay
    alone, as in JAX."""
    jcfg, tcfg, pj, pt = _model(arch)
    bj, bt = _batch(jcfg.vocab_size)
    oj, ot = jax_opt.get_optimizer(name), optimizer.get_optimizer(name)
    step_j = jax.jit(jax_make_train_step(
        jcfg, oj, jax_warmup_cosine(1e-3, 2, 10), clip_norm=1.0, remat=True))
    step_t = make_train_step(tcfg, ot, warmup_cosine(1e-3, 2, 10),
                             clip_norm=1.0, remat=True)
    pj2, sj, mj = step_j(pj, oj.init(pj), bj, jnp.asarray(3))
    pt = tree_map(torch.clone, pt)      # the step updates it in place
    pt2, st, mt = step_t(pt, ot.init(pt), bt, 3)
    assert sorted(mt) == sorted(mj)
    for key in mj:
        np.testing.assert_allclose(float(mt[key]), float(mj[key]), **TOL)
    assert float(mt["grad_norm"]) > 1.0     # the clip is exercised
    assert_trees_close(pt2, pj2, 1e-3)
    assert_trees_close(st, sj, 1e-3)
    assert int(st["count"]) == 1
    for path, t in _flat_tensors(pt2).items():
        if path.endswith(("ffn/router", "ffn/bias")):
            assert t.dtype == torch.float32, path
    if name == "adamw" and arch == "deepseek-v3-671b":
        m, v = _flat(st["m"]), _flat(st["v"])
        for path in (p for p in m if p.endswith("ffn/bias")):
            assert not m[path].any() and not v[path].any(), path


def _jax_kept(cfg, ids, T: int) -> np.ndarray:
    """[T, k] bool: which assignments the reference's sorted-capacity
    dispatch keeps (its lines, ``repro/models/moe.py:159-167``)."""
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    C = jmoe._capacity(cfg, T)
    flat_ids = ids.reshape(-1)
    order = jnp.argsort(flat_ids, stable=True)
    sorted_eid = flat_ids[order]
    counts = jnp.zeros((E,), jnp.int32).at[flat_ids].add(1)
    offsets = jnp.cumsum(counts) - counts
    rank = jnp.arange(T * k, dtype=jnp.int32) - offsets[sorted_eid]
    kept = jnp.zeros((T * k,), bool).at[order].set(rank < C)
    return np.asarray(kept).reshape(T, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_and_their_gradients_match_jax(arch, monkeypatch):
    """One MoE layer at capacity factor 0.25, 40 tokens (C = 8 of 80 or
    20 assignments an expert): the same assignments dropped as the
    reference drops (some, not all); the routing weight of a dropped
    assignment gets exactly no gradient, a kept one's does; the output
    and the gradients of the input, the router and the experts (and the
    shared expert) within 1e-5 of ``jax.vjp``'s, the bias's exactly 0."""
    jcfg, tcfg = _cfgs(arch)
    m = dataclasses.replace(jcfg.moe, capacity_factor=0.25)
    jcfg, tcfg = jcfg.replace(moe=m), tcfg.replace(moe=m)
    pj = _draw(jmoe.make_moe(jcfg), 7)
    pt = tree_map(lambda t: t.requires_grad_(),
                  params_from_numpy(_flat(pj), device="cpu"))
    rng = np.random.default_rng(11)
    x = rng.standard_normal((40, jcfg.d_model)).astype(np.float32)
    r = rng.standard_normal((40, jcfg.d_model)).astype(np.float32)

    def loss_j(p, xx):
        y, aux = jmoe.apply_moe_gather(jcfg, p, xx)
        return jnp.sum(y * r) + aux
    (lj, (gpj, gxj)) = jax.value_and_grad(loss_j, argnums=(0, 1))(
        pj, jnp.asarray(x))
    _, ids_j, _ = jmoe._route(jcfg, pj, jnp.asarray(x))
    kept_j = _jax_kept(jcfg, ids_j, 40)

    routed = []
    route = moe._route

    def keep_weights(cfg, p, x2d):
        w, ids, aux = route(cfg, p, x2d)
        w.retain_grad()
        routed.append((w, ids))
        return w, ids, aux
    monkeypatch.setattr(moe, "_route", keep_weights)
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe.apply_moe_gather(tcfg, pt, xt)
    lt = (y * torch.from_numpy(r)).sum() + aux
    lt.backward()
    (w, ids), = routed
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    order, keep, _ = moe._dispatch(ids, m.num_experts, moe._capacity(tcfg, 40))
    kept = torch.zeros(keep.shape, dtype=torch.bool)
    kept[order] = keep
    kept = kept.reshape(ids.shape).numpy()
    np.testing.assert_array_equal(kept, kept_j)
    assert 0 < (~kept).sum() < kept.size
    assert not w.grad.numpy()[~kept].any()
    assert np.abs(w.grad.numpy()[kept]).min() > 0
    np.testing.assert_allclose(float(lt.detach()), float(lj), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gxj), atol=1e-5,
                               rtol=1e-5)
    grads = tree_map(lambda t: torch.zeros_like(t) if t.grad is None
                     else t.grad, pt)
    assert_trees_close(grads, gpj, 1e-5)
    if "bias" in pt:
        assert pt["bias"].grad is None and not np.asarray(gpj["bias"]).any()


def test_aux_gradient_goes_only_through_frac_probs():
    """The switch loss E * sum_e f_e * p_e: f_e (the share of assignments)
    is a count and carries no gradient, so the router's gradient of aux is
    that of E * sum_e stop_gradient(f_e) * p_e, in the port as in JAX."""
    jcfg, tcfg = _cfgs("olmoe-1b-7b")
    pj = _draw(jmoe.make_moe(jcfg), 5)
    x = np.random.default_rng(2).standard_normal((24, jcfg.d_model)).astype(
        np.float32)
    gj = jax.grad(lambda p: jmoe._route(jcfg, p, jnp.asarray(x))[2])(pj)
    pt = params_from_numpy(_flat(pj), device="cpu")
    router = pt["router"].requires_grad_()
    _, ids, aux = moe._route(tcfg, pt, torch.from_numpy(x))
    aux.backward()
    E, k = tcfg.moe.num_experts, tcfg.moe.top_k
    frac_tokens = torch.bincount(ids.reshape(-1).long(), minlength=E) / (
        24 * k)
    want = torch.func.grad(lambda rw: E * (frac_tokens * torch.softmax(
        torch.from_numpy(x) @ rw, dim=-1).mean(0)).sum())(router.detach())
    np.testing.assert_allclose(router.grad.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(router.grad.numpy(), np.asarray(gj["router"]),
                               atol=1e-6, rtol=1e-5)


def test_deepseek_cut_to_its_dense_layers_trains_with_an_empty_moe_stack():
    """deepseek-v3-671b's reduced config cut to 1 layer (its first_k_dense):
    the MoE segment has 0 layers and stays in the tree as an empty stack
    with the reference's keys and shapes; the loss and one Adafactor step
    match JAX's (1e-4; params and state within 1e-3)."""
    jcfg, tcfg, pj, pt = _model("deepseek-v3-671b", num_layers=1)
    assert jcfg.moe.first_k_dense == 1
    flat_j, flat_t = _flat(pj), _flat(pt)
    assert {p: a.shape for p, a in flat_t.items()} == {
        p: a.shape for p, a in flat_j.items()}
    assert flat_t["segments/1/ffn/wi"].shape[0] == 0
    bj, bt = _batch(jcfg.vocab_size, S=24)
    oj, ot = jax_opt.Adafactor(), optimizer.Adafactor()
    step_j = jax.jit(jax_make_train_step(
        jcfg, oj, jax_warmup_cosine(1e-3, 1, 4), remat=True))
    step_t = make_train_step(tcfg, ot, warmup_cosine(1e-3, 1, 4), remat=True)
    pj2, sj, mj = step_j(pj, oj.init(pj), bj, jnp.asarray(1))
    pt = tree_map(torch.clone, pt)
    pt2, st, mt = step_t(pt, ot.init(pt), bt, 1)
    for key in mj:
        np.testing.assert_allclose(float(mt[key]), float(mj[key]), **TOL)
    assert float(mt["aux"]) == 0.0
    assert_trees_close(pt2, pj2, 1e-3)
    assert_trees_close(st, sj, 1e-3)


@pytest.mark.parametrize("arch,opt", [("olmoe-1b-7b", "adamw"),
                                      ("deepseek-v3-671b", "adafactor")])
def test_run_training_resumes_after_injected_failure(arch, opt, tmp_path):
    """bf16, as the launcher trains: a run cut by an injected failure after
    step 7, resumed from its step-6 checkpoint, ends on the same bits as a
    run that never failed; the checkpoint holds the MTP subtree (deepseek),
    the fp32 router and bias and, with Adafactor, the factored second
    moments (vr, vc) of the stacked expert leaves."""
    cfg = reduced_config(arch)
    dc = synthetic.data_config_for(cfg, seq_len=24, batch_size=2)

    def job(path, **kw):
        return TrainJob(total_steps=12, ckpt_every=3, ckpt_dir=str(path),
                        log_every=3, warmup=2, async_ckpt=False,
                        optimizer=opt, **kw)

    with pytest.raises(RuntimeError, match="injected failure"):
        run_training(cfg, dc, job(tmp_path / "a", fail_after_step=7),
                     device="cpu", log=lambda *a: None)
    assert max(ckpt.available_steps(str(tmp_path / "a"))) == 6
    moe_seg = f"segments/{len(lm.segments(cfg)) - 1}/ffn"
    with np.load(tmp_path / "a" / "step_6" / "arrays.npz") as arrays:
        keys = set(arrays.files)
        assert arrays[f"params/{moe_seg}/router"].dtype == np.float32
    if arch == "deepseek-v3-671b":
        assert "params/mtp/0/proj" in keys
        assert "params/segments/1/ffn/bias" in keys
        assert {"opt/v/segments/1/ffn/wi/vr",
                "opt/v/segments/1/ffn/wi/vc"} <= keys
    else:
        assert "opt/master/segments/0/ffn/wo" in keys
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
    leaves = _flat_tensors(params)
    assert leaves[f"{moe_seg}/router"].dtype == torch.float32
    assert leaves["embed"].dtype == torch.bfloat16


def _flat_bits(tree) -> dict:
    return {k: v.view(torch.int16).numpy() if v.dtype == torch.bfloat16
            else v.numpy()
            for k, v in _flat_tensors(tree).items()}


@pytest.mark.parametrize("argv", [
    ["--arch", "olmoe-1b-7b"],
    ["--arch", "deepseek-v3-671b", "--optimizer", "adafactor"]])
def test_launcher_trains_the_reduced_configs_on_the_cpu(argv, capsys):
    launch_train.main([*argv, "--preset", "reduced", "--steps", "4",
                       "--seq", "24", "--batch", "2", "--device", "cpu"])
    assert "done at step 4" in capsys.readouterr().out


def eight_adafactor_steps(arch: str, step_j) -> None:
    """ROADMAP Queue C item C1: eight Adafactor steps of reduced ``arch``
    from the same fp32 weights and a new batch each step, through the
    port's ``make_train_step`` and JAX's jitted step ``step_j``, both under
    the card run's schedule shape (base lr 3e-4, warmup 1, then cosine
    over 8 steps): the loss and grad norm within 1e-4 (relative) at every
    step, and the port's params finite at the end."""
    jcfg, tcfg, pj, pt = _model(arch)
    oj, ot = jax_opt.Adafactor(), optimizer.Adafactor()
    step_t = make_train_step(tcfg, ot, warmup_cosine(3e-4, 1, 8),
                             clip_norm=1.0, remat=True)
    pt = tree_map(torch.clone, pt)
    sj, st = oj.init(pj), ot.init(pt)
    seen = []
    for step in range(8):
        bj, bt = _batch(jcfg.vocab_size, seed=100 + step)
        pj, sj, mj = step_j(pj, sj, bj, jnp.asarray(step))
        _, _, mt = step_t(pt, st, bt, step)
        seen.append([(float(mt[k]), float(mj[k]))
                     for k in ("loss", "grad_norm")])
    for step, pairs in enumerate(seen):
        for got, want in pairs:
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       err_msg=f"step {step}: {seen}")
    for path, t in _flat(pt).items():
        assert np.isfinite(t).all(), path


def test_eight_adafactor_steps_track_jax():
    """ROADMAP Queue C item C1 for reduced deepseek-v3-671b (its cut model
    spiked at step 5 on the card): ``eight_adafactor_steps``."""
    jcfg = _model("deepseek-v3-671b")[0]
    eight_adafactor_steps("deepseek-v3-671b", jax.jit(jax_make_train_step(
        jcfg, jax_opt.Adafactor(), jax_warmup_cosine(3e-4, 1, 8),
        clip_norm=1.0, remat=True)))
