"""The port's training path (reduced smollm-360m and mamba2-130m, fp32, on
the CPU) against the JAX package on the same weights and batches: the loss
and chunked cross-entropy, the gradients leaf by leaf, one train step with
AdamW and with Adafactor, the LR schedule and the synthetic data; then the
port's resumable loop and checkpoints that cross frameworks both ways.
The mamba cases train through the SSD scan's ``SSDScan`` Function, whose
CPU backward is the plain ``ssd_scan_bwd_ref``.

Weights are made by the JAX initialiser and carried across with the
weight bridge; batches come from ``batch_at`` (numpy, identical in both).
Tolerances, each stated where it is used: fp32 through 4 layers sums in
another order in each framework (the entry-point bound of
``tests/test_torch_model.py``, 1e-4, for values of order 1).
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

from jax.sharding import AbstractMesh
from repro.checkpoint import checkpointer as jax_ckpt
from repro.configs import reduced_config as jax_reduced_config
from repro.data import synthetic as jax_data
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
from repro_torch.models.params import tree_map
from repro_torch.sharding.rules import make_rules
from repro_torch.train import optimizer
from repro_torch.train.loop import TrainJob, run_training
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.train_step import make_train_step

# values of order 1 (losses, norms, parameters)
TOL = dict(atol=1e-4, rtol=1e-4)


def flat_numpy(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {_path_str(p): np.asarray(x) for p, x in leaves}


def _flat_tensors(tree, prefix="") -> dict:
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


def flat_torch(tree) -> dict:
    return {k: t.float().numpy() for k, t in _flat_tensors(tree).items()}


def assert_trees_close(got, want, leaf_tol: float):
    """Each leaf's largest difference within ``leaf_tol`` of the leaf's
    largest magnitude (a bound that still bites on leaves of tiny values,
    such as second moments)."""
    got, want = flat_torch(got), flat_numpy(want)
    assert sorted(got) == sorted(want)
    for path in want:
        w = want[path].astype(np.float32)
        err = float(np.abs(got[path] - w).max())
        assert err <= leaf_tol * float(np.abs(w).max()), (path, err)


@functools.cache
def _model(arch: str):
    """(jax cfg, port cfg, jax fp32 params, port fp32 params) of a reduced
    config, the weights made by the JAX initialiser."""
    cfg_j = jax_reduced_config(arch).replace(dtype="float32")
    pj = cast_tree(init_params(jlm.make_lm(cfg_j), jax.random.PRNGKey(0)),
                   jnp.float32)
    pt = params_from_numpy(flat_numpy(pj), device="cpu")
    return cfg_j, reduced_config(arch).replace(dtype="float32"), pj, pt


@pytest.fixture(scope="module")
def model():
    return _model("smollm-360m")


def _batch(seq_len=40, step=3):
    dc = synthetic.DataConfig(vocab_size=256, seq_len=seq_len, batch_size=2,
                              seed=1)
    tokens = synthetic.batch_at(dc, step)["tokens"]
    mask = np.ones(tokens.shape, np.float32)
    mask[0, -5:] = 0.0            # a loss mask with zeros
    return ({"tokens": jnp.asarray(tokens), "loss_mask": jnp.asarray(mask)},
            {"tokens": torch.from_numpy(tokens),
             "loss_mask": torch.from_numpy(mask)})


@pytest.mark.parametrize("seed,step,codebooks,image", [
    (0, 0, 0, 0), (3, 17, 0, 0), (1, 5, 2, 0), (2, 9, 0, 4)])
def test_batch_at_equals_jax(seed, step, codebooks, image):
    kw = dict(vocab_size=300, seq_len=24, batch_size=3, seed=seed,
              num_codebooks=codebooks, num_image_tokens=image, d_model=8)
    got = synthetic.batch_at(synthetic.DataConfig(**kw), step)
    want = jax_data.batch_at(jax_data.DataConfig(**kw), step)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    it = synthetic.SyntheticIterator(synthetic.DataConfig(**kw), step)
    np.testing.assert_array_equal(next(it)["tokens"], want["tokens"])
    assert it.state() == step + 1


def test_warmup_cosine_matches_jax():
    for args in ((3e-4, 20, 100), (1e-3, 0, 10), (5e-4, 7, 7)):
        ours, ref = warmup_cosine(*args), jax_warmup_cosine(*args)
        for step in (0, 1, 6, 7, 8, 20, 50, 99, 100, 150):
            assert float(ours(step)) == pytest.approx(float(ref(step)),
                                                      rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("chunk,arch", [   # 16: S-1 = 39 = 2*16 + 7
    pytest.param(512, "smollm-360m", id="512"),
    pytest.param(16, "smollm-360m", id="16"),
    pytest.param(512, "mamba2-130m", id="512-mamba2-130m"),
    pytest.param(16, "mamba2-130m", id="16-mamba2-130m")])
def test_train_loss_and_chunked_xent_match_jax(chunk, arch, monkeypatch):
    cfg_j, cfg_t, pj, pt = _model(arch)
    bj, bt = _batch()
    monkeypatch.setenv("REPRO_XENT_CHUNK", str(chunk))   # the JAX knob
    loss_j, m_j = jlm.train_loss(cfg_j, pj, bj, remat=False)
    loss_t, m_t = lm.train_loss(cfg_t, pt, bt, remat=False, xent_chunk=chunk)
    np.testing.assert_allclose(float(loss_t), float(loss_j), **TOL)
    np.testing.assert_allclose(float(m_t["ce"]), float(m_j["ce"]), **TOL)
    # chunked_xent alone, on hidden states of order 1
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, 39, 128), np.float32)
    tgt = rng.integers(0, 256, (2, 39)).astype(np.int32)
    mask = (rng.random((2, 39)) > 0.2).astype(np.float32)
    want = jlm.chunked_xent(cfg_j, pj, jnp.asarray(h), jnp.asarray(tgt),
                            jnp.asarray(mask))
    got = lm.chunked_xent(cfg_t, pt, torch.from_numpy(h), torch.from_numpy(tgt),
                          torch.from_numpy(mask), chunk)
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_gradients_match_jax_leaf_by_leaf(model):
    """Each gradient leaf within 1e-5 of its largest magnitude: fp32 sums
    in another order leave ~1e-7 relative noise, grown through 4 layers of
    backward (2e-6 measured)."""
    cfg_j, cfg_t, pj, pt = model
    bj, bt = _batch()
    gj = jax.grad(lambda p: jlm.train_loss(cfg_j, p, bj, remat=True)[0])(pj)
    leaves = tree_map(lambda p: p.clone().requires_grad_(), pt)
    lm.train_loss(cfg_t, leaves, bt, remat=True)[0].backward()
    assert_trees_close(tree_map(lambda p: p.grad, leaves), gj, 1e-5)
    # remat recomputes each layer: the gradients are the same bits
    _assert_same_bits(leaves, _grads(cfg_t, pt, bt, remat=False))


def _grads(cfg, params, batch, remat):
    """The port's gradient leaves (tensors with ``.grad``) of train_loss."""
    leaves = tree_map(lambda p: p.clone().requires_grad_(), params)
    lm.train_loss(cfg, leaves, batch, remat=remat)[0].backward()
    return leaves


def _assert_same_bits(a, b):
    for x, y in zip(flat_torch(tree_map(lambda p: p.grad, a)).values(),
                    flat_torch(tree_map(lambda p: p.grad, b)).values(),
                    strict=True):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("remat", [True, False])
def test_mamba_gradients_match_jax_leaf_by_leaf(remat):
    """Reduced mamba2-130m (4 layers, chunk 32, so the 40-token batch runs
    a short last chunk) through the SSD scan's backward, against
    ``jax.grad``: each leaf within 5e-5 of its largest magnitude (1.4e-5
    measured, at dt_bias; A_log, the other leaf whose gradient is a sum
    of decay terms over every token, 1.3e-5).  Every leaf gets a gradient,
    and the gradients with and without remat are the same bits."""
    cfg_j, cfg_t, pj, pt = _model("mamba2-130m")
    bj, bt = _batch()
    gj = jax.grad(lambda p: jlm.train_loss(cfg_j, p, bj, remat=remat)[0])(pj)
    leaves = _grads(cfg_t, pt, bt, remat)
    for path, g in _flat_tensors(tree_map(lambda p: p.grad, leaves)).items():
        assert bool(g.abs().max() > 0), path
    assert_trees_close(tree_map(lambda p: p.grad, leaves), gj, 5e-5)
    _assert_same_bits(leaves, _grads(cfg_t, pt, bt, remat=not remat))


@pytest.mark.parametrize("name,arch", [
    pytest.param("adamw", "smollm-360m", id="adamw"),
    pytest.param("adafactor", "smollm-360m", id="adafactor"),
    pytest.param("adamw", "mamba2-130m", id="adamw-mamba2-130m"),
    pytest.param("adafactor", "mamba2-130m", id="adafactor-mamba2-130m")])
def test_train_step_matches_jax(name, arch):
    """One step at step 3 of warmup 2 (lr > 0) from identical weights and
    batch: loss and grad norm within 1e-4; each leaf of the updated params
    and optimizer state within 1e-3 of its largest magnitude (1.5e-4
    measured for AdamW: its first step is about lr * sign(g), so where a
    gradient is near 0 the gradients' ~1e-7 relative noise moves the update
    by a share of lr; 3e-6 for Adafactor).  Reduced mamba2-130m: 2.1e-4
    for AdamW, 2.0e-5 for Adafactor (at A_log's second moment), grad norm
    1.1e-5 apart."""
    cfg_j, cfg_t, pj, pt = _model(arch)
    bj, bt = _batch()
    oj, ot = jax_opt.get_optimizer(name), optimizer.get_optimizer(name)
    step_j = jax_make_train_step(cfg_j, oj, jax_warmup_cosine(1e-3, 2, 10),
                                 clip_norm=1.0, remat=True)
    step_t = make_train_step(cfg_t, ot, warmup_cosine(1e-3, 2, 10),
                             clip_norm=1.0, remat=True)
    pj2, sj, mj = step_j(pj, oj.init(pj), bj, jnp.asarray(3))
    # the port's step updates its params in place (donated, as JAX's
    # jitted step's are): give it a copy of the shared weights
    pt = tree_map(torch.clone, pt)
    pt2, st, mt = step_t(pt, ot.init(pt), bt, 3)
    for key in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(float(mt[key]), float(mj[key]), **TOL)
    assert float(mt["grad_norm"]) > 1.0     # the clip is exercised
    assert_trees_close(pt2, pj2, 1e-3)
    assert_trees_close(st, sj, 1e-3)
    assert int(st["count"]) == 1


def test_run_training_resumes_after_injected_failure(tmp_path):
    """Shaped like ``tests/test_checkpoint.py``'s JAX test; a resumed run
    also ends on the same bits as one that never failed."""
    cfg = reduced_config("smollm-360m")
    _check_resume(cfg, tmp_path)
    # rules on a data and a model axis train (tests/test_torch_dp_train.py,
    # tests/test_torch_tp_train.py, tests/test_torch_tp_hybrid.py, the
    # modality stubs in tests/test_torch_tp_modality.py); a table that
    # splits a logical axis the model axis does not cover is refused,
    # before any process group starts
    rules = make_rules(AbstractMesh((1, 2), ("data", "model")),
                       embed=("model",))
    stub = reduced_config("musicgen-medium")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_training(stub, synthetic.data_config_for(stub, 32, 2),
                     TrainJob(total_steps=20, ckpt_dir=str(tmp_path / "c")),
                     device="cpu", rules=rules)


def test_a_failure_waits_for_the_checkpoint_write_it_follows(
        tmp_path, monkeypatch):
    """An injected failure in the step right after an asynchronous
    checkpoint (its write slowed by 0.5 s here): the run joins the writer
    before the failure propagates, so the checkpoint is whole on disk and
    the rerun resumes from it (an ExpoCloud worker that fails exits, which
    would otherwise kill its writer thread mid-write)."""
    import dataclasses
    import time

    savez = np.savez

    def slow_savez(*args, **kwargs):
        time.sleep(0.5)
        return savez(*args, **kwargs)

    monkeypatch.setattr(np, "savez", slow_savez)
    cfg = reduced_config("smollm-360m")
    dc = synthetic.data_config_for(cfg, seq_len=16, batch_size=2)
    job = TrainJob(total_steps=8, ckpt_every=4, ckpt_dir=str(tmp_path),
                   log_every=4, warmup=1, fail_after_step=4)
    assert job.async_ckpt
    with pytest.raises(RuntimeError, match="injected failure at step 4"):
        run_training(cfg, dc, job, device="cpu", log=lambda *a: None)
    assert ckpt.available_steps(str(tmp_path)) == [4]
    logs = []
    _, final, _ = run_training(cfg, dc, dataclasses.replace(
        job, fail_after_step=None), device="cpu", log=logs.append)
    assert final == 8 and logs[0] == "[train] restored checkpoint at step 4"


def test_mamba_run_training_resumes_after_injected_failure(tmp_path):
    """The same for reduced mamba2-130m in bf16 (48 tokens, chunk 32: a
    short last chunk); the fp32 leaves A_log, D and dt_bias stay fp32
    through the optimizer's steps, as in JAX (``make_mamba``)."""
    cfg = reduced_config("mamba2-130m")
    params = _check_resume(cfg, tmp_path)
    for path, t in _flat_tensors(params).items():
        want = (torch.float32 if path.rsplit("/", 1)[-1] in ("A_log", "D",
                                                             "dt_bias")
                else torch.bfloat16)
        assert t.dtype == want, path


def _check_resume(cfg, tmp_path):
    """A run cut by an injected failure after step 11, resumed from its
    step-10 checkpoint, ends on the same bits as a run that never failed;
    returns its final params."""
    dc = synthetic.data_config_for(cfg, seq_len=32 if cfg.ssm is None else 48,
                                   batch_size=2)

    def job(path, **kw):
        return TrainJob(total_steps=20, ckpt_every=5, ckpt_dir=str(path),
                        log_every=5, warmup=2, async_ckpt=False, **kw)

    with pytest.raises(RuntimeError, match="injected failure"):
        run_training(cfg, dc, job(tmp_path / "a", fail_after_step=11),
                     device="cpu", log=lambda *a: None)
    assert max(ckpt.available_steps(str(tmp_path / "a"))) >= 10
    logs = []
    hist, final, params = run_training(cfg, dc, job(tmp_path / "a"),
                                       device="cpu", log=logs.append)
    assert final == 20 and hist[0]["step"] == 10
    assert logs[0] == "[train] restored checkpoint at step 10"
    assert ckpt.available_steps(str(tmp_path / "a"))[-1] == 20
    _, _, straight = run_training(cfg, dc, job(tmp_path / "b"), device="cpu",
                                  log=lambda *a: None)
    for a, b in zip(flat_torch(params).values(), flat_torch(straight).values(),
                    strict=True):
        np.testing.assert_array_equal(a, b)
    return params


def _train_state_jax():
    """A bf16 JAX train state: params, AdamW state (fp32, int32 count)."""
    cfg = jax_reduced_config("smollm-360m")
    pj = init_params(jlm.make_lm(cfg), jax.random.PRNGKey(3))
    oj = jax_opt.AdamW()
    state = oj.init(pj)
    state["m"] = jax.tree_util.tree_map(lambda x: x + 0.25, state["m"])
    return {"params": pj, "opt": dict(state, count=jnp.asarray(7, jnp.int32))}


def _bits(tree) -> dict:
    """path -> (the leaf's bits, bf16 as uint16; its dtype name), for a JAX
    or a port tree."""
    if isinstance(jax.tree_util.tree_leaves(tree)[0], torch.Tensor):
        out = {}
        for k, t in _flat_tensors(tree).items():
            bits = (t.view(torch.int16).numpy().view(np.uint16)
                    if t.dtype == torch.bfloat16 else t.numpy())
            out[k] = (bits, str(t.dtype).removeprefix("torch."))
        return out
    return {k: (v.view(np.uint16) if v.dtype.name == "bfloat16" else v,
                v.dtype.name) for k, v in flat_numpy(tree).items()}


def test_checkpoint_from_jax_restores_in_the_port(tmp_path):
    state = _train_state_jax()
    jax_ckpt.save(str(tmp_path), 7, state, metadata={"data_state": 7})
    like_p = lm.init_lm(reduced_config("smollm-360m"), device="meta")
    like = {"params": like_p, "opt": optimizer.AdamW().init(like_p)}
    got, step, meta = ckpt.restore(str(tmp_path), like, device="cpu")
    assert step == 7 and meta["data_state"] == 7
    assert got["params"]["embed"].dtype == torch.bfloat16
    assert got["opt"]["count"].dtype == torch.int32
    want = _bits(state)
    have = _bits(got)
    assert sorted(have) == sorted(want)
    for path, (bits, name) in want.items():
        assert have[path][1] == name, path
        np.testing.assert_array_equal(have[path][0], bits, err_msg=path)


def test_checkpoint_from_the_port_restores_in_jax(tmp_path):
    cfg = reduced_config("smollm-360m")
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = {"params": params, "opt": optimizer.AdamW().init(params)}
    state["opt"]["count"] = torch.tensor(4, dtype=torch.int32)
    ckpt.save(str(tmp_path), 4, state, metadata={"data_state": 4},
              async_write=True).join()
    like = jax.tree_util.tree_map(lambda x: jax.ShapeDtypeStruct(x.shape,
                                                                 x.dtype),
                                  _train_state_jax())
    got, step, meta = jax_ckpt.restore(str(tmp_path), like)
    assert step == 4 and meta["dtypes"]["params/embed"] == "bfloat16"
    want = _bits(state)
    have = _bits(got)
    assert sorted(have) == sorted(want)
    for path, (bits, name) in want.items():
        assert have[path][1] == name, path
        np.testing.assert_array_equal(have[path][0], bits, err_msg=path)
