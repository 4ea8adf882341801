"""Training of the modality stubs in the port against the JAX package, on
the CPU in fp32: reduced ``musicgen-medium`` (4 codebooks: tokens
[B, S, 4], the loss the mean over codebooks) and reduced
``phi-3-vision-4.2b`` (8 image embeds written over the token embeddings),
plus the narrow phi-3 at the published head dim 96.

``train_loss``'s ce, aux and loss and its gradients leaf by leaf against
``jax.value_and_grad``; the same gradients with remat on and off; one
``make_train_step`` step with AdamW and with Adafactor against JAX's
jitted step (params and optimizer state); image positions past S,
negative and repeated, under autograd (the loss and the gradients of the
weights and of the image embeds equal JAX's: the last write of a row
wins it and alone gets a gradient); the codebook loss as the mean of the
per-codebook losses computed by hand; and the launcher on both reduced
configs.

Weights are drawn with numpy from the JAX parameter descriptors'
distributions (the norms away from their ones) and carried across with
the weight bridge; batches come from numpy seeds.  Bounds are
``tests/test_torch_moe_train.py``'s: 1e-4 for values of order 1,
gradient leaves within 1e-5 of their largest magnitude, updated params
and optimizer state within 1e-3.
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
from repro_torch.models.layers import rmsnorm
from repro_torch.models.params import tree_map
from repro_torch.train import optimizer
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.train_step import make_train_step

MUSIC, VISION = "musicgen-medium", "phi-3-vision-4.2b"
ARCHS = (MUSIC, VISION)
# the narrow phi-3 around the published head: 2 heads of 96
NARROW = dict(num_heads=2, num_kv_heads=2, head_dim=96)
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
def _model(arch: str, narrow: bool = False):
    """(JAX cfg, port cfg, JAX params, port params), fp32."""
    kw = dict(NARROW if narrow else {}, dtype="float32")
    jcfg = jax_reduced_config(arch).replace(**kw)
    tcfg = reduced_config(arch).replace(**kw)
    pj = _draw(jlm.make_lm(jcfg), 0)
    return jcfg, tcfg, pj, params_from_numpy(_flat(pj), device="cpu")


def _batch(cfg, seed: int = 3, positions=None) -> dict:
    """numpy: tokens [2, S] ([2, S, 4] with codebooks) and a loss mask
    with zeros at the end of row 0; with the vision stub image embeds
    [2, 8, d] at ``positions`` (by default 8 distinct positions of each
    row)."""
    rng = np.random.default_rng(seed)
    shape = (2, S, cfg.num_codebooks) if cfg.num_codebooks else (2, S)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32),
             "loss_mask": np.ones((2, S), np.float32)}
    batch["loss_mask"][0, -5:] = 0.0
    if cfg.vision_stub:
        N = cfg.num_image_tokens
        batch["image_embeds"] = (0.5 * rng.standard_normal(
            (2, N, cfg.d_model))).astype(np.float32)
        if positions is None:
            positions = np.stack([rng.permutation(S)[:N] for _ in range(2)])
        batch["image_positions"] = np.asarray(positions, np.int32)
    return batch


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.cache
def _jax_value_and_grad(arch: str, narrow: bool = False):
    jcfg, _, pj, _ = _model(arch, narrow)
    bj = _jax_batch(_batch(jcfg))
    fn = jax.jit(jax.value_and_grad(
        lambda p: jlm.train_loss(jcfg, p, bj, remat=True), has_aux=True))
    (_, metrics), grads = fn(pj)
    return metrics, grads


def _port_grads(arch: str, remat: bool, narrow: bool = False):
    """(metrics, gradient tree) of the port's train_loss; a leaf that gets
    no gradient reads as zeros, as the train step treats it."""
    _, tcfg, _, pt = _model(arch, narrow)
    leaves = tree_map(lambda p: p.clone().requires_grad_(), pt)
    loss, metrics = lm.train_loss(tcfg, leaves, _port_batch(_batch(tcfg)),
                                  remat=remat)
    loss.backward()
    return ({k: v.detach() for k, v in metrics.items()},
            tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                     else p.grad, leaves))


@pytest.mark.parametrize("arch,narrow", [(MUSIC, False), (VISION, False),
                                         (VISION, True)])
def test_train_loss_and_gradients_match_jax(arch, narrow):
    """ce, aux and loss within 1e-4 under remat; every gradient leaf
    within 1e-5 of its largest magnitude: the codebook tables and heads,
    and with image embeds the embedding rows they replace (no gradient
    from those positions in either framework); phi-3 also narrowed to
    heads of 96."""
    mj, gj = _jax_value_and_grad(arch, narrow)
    mt, gt = _port_grads(arch, remat=True, narrow=narrow)
    assert sorted(mt) == sorted(mj) == ["aux", "ce", "loss"]
    for key in mj:
        np.testing.assert_allclose(float(mt[key]), float(mj[key]), **TOL)
    assert_trees_close(gt, gj, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_gradients(arch):
    """Remat reruns each layer's forward in the backward; the codebook
    sum and the image merge lie outside it: the gradients with and
    without remat are the same bits."""
    _, g_remat = _port_grads(arch, remat=True)
    _, g_plain = _port_grads(arch, remat=False)
    for (path, a), b in zip(_flat(g_remat).items(), _flat(g_plain).values(),
                            strict=True):
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, name):
    """One step at step 3 of warmup 2 from identical weights and batch
    against JAX's jitted step: loss, ce, aux, grad norm and lr within
    1e-4; each leaf of the params and of the optimizer state within 1e-3
    of its largest magnitude."""
    jcfg, tcfg, pj, pt = _model(arch)
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


def test_image_positions_past_s_negative_and_repeated_under_autograd():
    """Row 0 names rows 3 and 7 twice and two positions at or past S; row
    1 names S - 2 and then -2 (the same row), 5 three times and two
    positions that stay out of range after the wrap.  The loss, every
    weight's gradient and the image embeds' gradient equal JAX's: a
    repeated row is the last write's, which alone gets a gradient, and a
    dropped embed gets none."""
    jcfg, tcfg, pj, pt = _model(VISION)
    positions = [[3, 7, 3, S + 2, 1, 7, 0, S],
                 [S - 2, 5, 5, -2, 2, S, 5, -S - 3]]
    batch = _batch(jcfg, seed=5, positions=positions)

    def jax_loss(p, img):
        return jlm.train_loss(jcfg, p, dict(_jax_batch(batch),
                                            image_embeds=img))[0]
    lj, (gj, gij) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        pj, jnp.asarray(batch["image_embeds"]))
    leaves = tree_map(lambda p: p.clone().requires_grad_(), pt)
    bt = _port_batch(batch)
    img = bt["image_embeds"].clone().requires_grad_()
    lt, _ = lm.train_loss(tcfg, leaves, dict(bt, image_embeds=img))
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), **TOL)
    assert_trees_close(tree_map(lambda p: p.grad, leaves), gj, 1e-5)
    gi, gij = img.grad.numpy(), np.asarray(gij)
    np.testing.assert_allclose(gi, gij, atol=1e-5 * np.abs(gij).max())
    # the overwritten and the dropped embeds get no gradient
    dead = [(0, 0), (0, 1), (0, 3), (0, 7), (1, 0), (1, 1), (1, 2), (1, 5),
            (1, 7)]
    for b, n in dead:
        assert not gi[b, n].any() and not gij[b, n].any(), (b, n)
    live = [(b, n) for b in range(2) for n in range(8) if (b, n) not in dead]
    assert all(np.abs(gi[b, n]).max() > 0 for b, n in live)


def test_codebook_loss_is_the_mean_of_the_per_codebook_losses():
    """The codebook ce equals the mean over the 4 codebooks of each
    codebook's masked next-token loss, computed here from the full
    logits; in whole chunks and in chunks of 16 positions with a
    remainder of 7 alike."""
    _, cfg, _, params = _model(MUSIC)
    batch = _port_batch(_batch(cfg))
    tokens, mask = batch["tokens"], batch["loss_mask"][:, 1:]
    with torch.no_grad():
        h = lm.embed_tokens(cfg, params, tokens)
        h, _, _ = lm.backbone(cfg, params, h, torch.arange(S)[None])
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        logits = lm.apply_head(cfg, params, h[:, :-1])   # [2, S-1, 4, V]
        assert logits.shape == (2, S - 1, 4, cfg.vocab_size)
        per_codebook = []
        for c in range(cfg.num_codebooks):
            lc = logits[:, :, c]
            nll = (torch.logsumexp(lc, -1)
                   - lc.gather(-1, tokens[:, 1:, c, None].long())[..., 0])
            per_codebook.append(float((nll * mask).sum() / mask.sum()))
        want = sum(per_codebook) / len(per_codebook)
        for chunk in (512, 16):
            _, metrics = lm.train_loss(cfg, params, batch, xent_chunk=chunk)
            np.testing.assert_allclose(float(metrics["ce"]), want, rtol=1e-6)
    assert len(set(per_codebook)) == cfg.num_codebooks


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_the_reduced_configs_on_the_cpu(arch, capsys):
    launch_train.main(["--arch", arch, "--preset", "reduced", "--steps", "2",
                       "--seq", "24", "--batch", "2", "--device", "cpu"])
    assert "done at step 2" in capsys.readouterr().out
