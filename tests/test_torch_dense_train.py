"""Training of the three dense GQA configs that the port served before it
trained them (qwen3-4b: q/k norm weights under gradient; chatglm3-6b:
half-width interleaved RoPE and G 16; granite-20b: the GELU MLP and MQA
with G 48) against the JAX package, on the CPU in fp32.

Each arch runs at JAX's ``reduced_config`` (G 4 for all three, the
reference's cap), and chatglm3-6b and granite-20b also at a narrow size
with the published query and KV heads (32 / 2 and 48 / 1) at 2 layers,
head_dim 32 and d_model 128: the flash backward's plain version sums
16 and 48 query heads into their KV head there.  ``train_loss``'s ce,
aux and loss and every gradient leaf against ``jax.value_and_grad``;
remat on == off; one ``make_train_step`` step against JAX's jitted step,
with AdamW in every case and Adafactor on granite-20b; the launcher on
the reduced configs.

Weights are drawn with numpy from the JAX descriptors' distributions,
the RMSNorm weights (q/k norms among them) away from their ones, and
carried across with the weight bridge; batches come from numpy seeds.
Bounds are ``tests/test_torch_modality_train.py``'s: 1e-4 for values of
order 1, gradient leaves within 1e-5 of their largest magnitude, updated
params and optimizer state within 1e-3.
"""
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
from repro.models.params import _path_str, is_param
from repro.train import optimizer as jax_opt
from repro.train.schedule import warmup_cosine as jax_warmup_cosine
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import reduced_config
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.params import tree_map
from repro_torch.train import optimizer
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.train_step import make_train_step

ARCHS = ("qwen3-4b", "chatglm3-6b", "granite-20b")
# the published (query heads, KV heads) of the two wide groups
NARROW_HEADS = {"chatglm3-6b": (32, 2), "granite-20b": (48, 1)}
CASES = [(a, "reduced") for a in ARCHS] + [(a, "narrow")
                                           for a in NARROW_HEADS]
TOL = dict(atol=1e-4, rtol=1e-4)
S = 40


def _flat(tree) -> dict:
    """``{path: numpy leaf}`` (fp32) of a JAX tree or of a port tree."""
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
    largest magnitude."""
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g, w = got[path], w.astype(np.float32)
        assert g.shape == w.shape, path
        err = float(np.abs(g - w).max())
        assert err <= leaf_tol * float(np.abs(w).max()), (path, err)


def _draw(descr, seed: int):
    """fp32 arrays for a JAX descriptor tree, drawn with numpy as the
    initialiser's distributions, the RMSNorm weights away from their
    ones."""
    rng = np.random.default_rng(seed)

    def one(p):
        if p.init == "ones":
            return jnp.asarray(1 + 0.3 * rng.standard_normal(p.shape),
                               jnp.float32)
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        std = fan_in ** -0.5 if p.init == "scaled" else (p.scale or 0.02)
        return jnp.asarray(std * rng.standard_normal(p.shape), jnp.float32)
    return jax.tree_util.tree_map(one, descr, is_leaf=is_param)


@functools.cache
def _model(arch: str, variant: str = "reduced"):
    """(JAX cfg, port cfg, JAX params, port params), fp32."""
    kw: dict = {"dtype": "float32"}
    if variant == "narrow":
        H, K = NARROW_HEADS[arch]
        kw.update(num_layers=2, num_heads=H, num_kv_heads=K, head_dim=32)
    jcfg = jax_reduced_config(arch).replace(**kw)
    tcfg = reduced_config(arch).replace(**kw)
    pj = _draw(jlm.make_lm(jcfg), 0)
    return jcfg, tcfg, pj, params_from_numpy(_flat(pj), device="cpu")


def _batch(cfg, seed: int = 3) -> dict:
    """numpy: tokens [2, S] and a loss mask with zeros at the end of row 0."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, S)).astype(
        np.int32), "loss_mask": np.ones((2, S), np.float32)}
    batch["loss_mask"][0, -5:] = 0.0
    return batch


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_grads(arch: str, variant: str, remat: bool):
    """(metrics, gradient tree) of the port's train_loss; a leaf that gets
    no gradient reads as zeros, as the train step treats it."""
    _, tcfg, _, pt = _model(arch, variant)
    leaves = tree_map(lambda p: p.clone().requires_grad_(), pt)
    loss, metrics = lm.train_loss(tcfg, leaves, _port_batch(_batch(tcfg)),
                                  remat=remat)
    loss.backward()
    return ({k: v.detach() for k, v in metrics.items()},
            tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                     else p.grad, leaves))


def test_the_configs_keep_their_features():
    """What each case puts under gradient: qwen3-4b's q/k norm weights,
    chatglm3-6b's half-width interleaved RoPE, granite-20b's GELU, and the
    groups 4 (reduced) and 16 and 48 (narrow)."""
    groups = {(a, v): _model(a, v)[1].num_heads // _model(a, v)[1].num_kv_heads
              for a, v in CASES}
    assert groups == {("qwen3-4b", "reduced"): 4,
                      ("chatglm3-6b", "reduced"): 4,
                      ("granite-20b", "reduced"): 4,
                      ("chatglm3-6b", "narrow"): 16,
                      ("granite-20b", "narrow"): 48}
    qwen = _model("qwen3-4b")[1]
    assert qwen.qk_norm and "segments/0/mixer/q_norm" in _flat(
        _model("qwen3-4b")[3])
    glm = _model("chatglm3-6b")[1]
    assert glm.rotary_pct == 0.5 and glm.rope_interleaved
    assert _model("granite-20b")[1].act == "gelu"


@pytest.mark.parametrize("arch,variant", CASES)
def test_train_loss_and_gradients_match_jax(arch, variant):
    """ce, aux and loss within 1e-4 under remat; every gradient leaf within
    1e-5 of its largest magnitude (the q/k norm weights, the embedding and
    head, each layer's projections and norms)."""
    jcfg, _, pj, _ = _model(arch, variant)
    bj = _jax_batch(_batch(jcfg))
    (_, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: jlm.train_loss(jcfg, p, bj, remat=True), has_aux=True))(pj)
    mt, gt = _port_grads(arch, variant, remat=True)
    assert sorted(mt) == sorted(mj) == ["aux", "ce", "loss"]
    for key in mj:
        np.testing.assert_allclose(float(mt[key]), float(mj[key]), **TOL)
    assert_trees_close(gt, gj, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_gradients(arch):
    """Remat reruns each layer's forward in the backward: the gradients
    with and without it are the same bits."""
    _, g_remat = _port_grads(arch, "reduced", remat=True)
    _, g_plain = _port_grads(arch, "reduced", remat=False)
    for (path, a), b in zip(_flat(g_remat).items(), _flat(g_plain).values(),
                            strict=True):
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("arch,variant,name",
                         [(a, v, "adamw") for a, v in CASES]
                         + [("granite-20b", "reduced", "adafactor")])
def test_train_step_matches_jax(arch, variant, name):
    """One step at step 3 of warmup 2 from identical weights and batch
    against JAX's jitted step: loss, ce, aux, grad norm and lr within
    1e-4; each leaf of the params and of the optimizer state within 1e-3
    of its largest magnitude."""
    jcfg, tcfg, pj, pt = _model(arch, variant)
    batch = _batch(jcfg)
    oj, ot = jax_opt.get_optimizer(name), optimizer.get_optimizer(name)
    step_j = jax.jit(jax_make_train_step(
        jcfg, oj, jax_warmup_cosine(1e-3, 2, 10), clip_norm=1.0, remat=True))
    step_t = make_train_step(tcfg, ot, warmup_cosine(1e-3, 2, 10),
                             clip_norm=1.0, remat=True)
    pj2, sj, mj = step_j(pj, oj.init(pj), _jax_batch(batch), jnp.asarray(3))
    pt = tree_map(torch.clone, pt)      # the step updates it in place
    pt2, st, mt = step_t(pt, ot.init(pt), _port_batch(batch), 3)
    assert sorted(mt) == sorted(mj)
    for key in mj:
        np.testing.assert_allclose(float(mt[key]), float(mj[key]), **TOL)
    assert float(mt["grad_norm"]) > 1.0     # the clip is exercised
    assert_trees_close(pt2, pj2, 1e-3)
    assert_trees_close(st, sj, 1e-3)
    assert int(st["count"]) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_the_reduced_configs_on_the_cpu(arch, capsys):
    launch_train.main(["--arch", arch, "--preset", "reduced", "--steps", "2",
                       "--seq", "24", "--batch", "2", "--device", "cpu"])
    assert "done at step 2" in capsys.readouterr().out
