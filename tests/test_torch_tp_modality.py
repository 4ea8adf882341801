"""The modality stubs on a (data, model) mesh (``torch.distributed``, gloo
CPU ranks) against the JAX package's single-device functions on the same
global batch:

  * musicgen-medium: the [cb, V, d] tables and the [cb, d, V] heads split
    over V; each codebook's masked lookup summed in fp32 in codebook
    order, then one sum over the group; the split log-sum-exp and target
    pick per codebook, then the mean over the codebooks;
  * phi-3-vision-4.2b: the image rows written over the whole embedding
    output, after the sum over the group (their gradient reaches no table
    row and is not summed twice).

At (1, 2) and (2, 2), reduced configs in fp32 (4 codebooks; 8 image rows
a sequence, at positions that differ by row): the loss within
``tests/test_torch_dp_train.py``'s ``TOL``, every gradient leaf and the
params after one AdamW step within its ``LEAF_TOL`` of the leaf's largest
magnitude; and prefill and eight greedy decode steps as
``tests/test_torch_tp_serve.py`` holds them.
"""
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.models import lm as jlm
from repro.train import optimizer as jax_opt
from repro.train.schedule import warmup_cosine as jax_warmup_cosine
from repro.train.train_step import make_train_step as jax_make_train_step
from test_torch_dp_train import (LEAF_TOL, TOL, _flat, _jax_params,
                                 assert_close_leaves)
from test_torch_tp_serve import (check_serve, jax_serve, once, serve_batch,
                                 serve_case, start_ranks)

ARCHS = ("musicgen-medium", "phi-3-vision-4.2b")
MESHES = [(1, 2), (2, 2)]
STEP = 3            # warmup 2 of 10: the step's lr > 0


def train_batch(cfg) -> dict:
    batch = serve_batch(cfg, seed=7)
    mask = np.ones(batch["tokens"].shape[:2], np.float32)
    mask[0, -3:] = 0.0
    mask[3, :4] = 0.0
    batch["loss_mask"] = mask
    return batch


@functools.cache
def jax_train(arch: str) -> dict:
    """JAX's loss and gradients, and the params after one jitted AdamW
    step, on the global batch."""
    cfg, params = _jax_params(arch)
    batch = {k: jnp.asarray(v) for k, v in train_batch(cfg).items()}
    (loss, _), grads = jax.value_and_grad(
        lambda p: jlm.train_loss(cfg, p, batch, remat=True),
        has_aux=True)(params)
    opt = jax_opt.get_optimizer("adamw")
    step_fn = jax.jit(jax_make_train_step(cfg, opt,
                                          jax_warmup_cosine(1e-3, 2, 10),
                                          clip_norm=1.0, remat=True))
    stepped, _, metrics = step_fn(params, opt.init(params), batch,
                                  jnp.asarray(STEP))
    return {"loss": float(loss), "grads": _flat(grads),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "params": _flat(stepped)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("modality")
    with ThreadPoolExecutor(len(ARCHS)) as ex:
        list(ex.map(_jax_params, ARCHS))
    started = {}
    for mesh in MESHES:
        cases = [serve_case(a) for a in ARCHS] + [
            {"kind": "grads", "arch": a, "params": _flat(_jax_params(a)[1]),
             "batch": train_batch(_jax_params(a)[0]), "step": STEP}
            for a in ARCHS]
        started[mesh] = (cases, once(start_ranks(
            mesh, cases, tmp, f"m{mesh[0]}x{mesh[1]}")))
    with ThreadPoolExecutor(2 * len(ARCHS)) as ex:
        list(ex.map(jax_serve, ARCHS))
        list(ex.map(jax_train, ARCHS))
    return started


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_modality_steps_match_the_jax_single_device_step(mesh, runs):
    cases, results = runs[mesh]
    for case, res in zip(cases, results(), strict=True):
        label = f"{case['arch']} {case['kind']} at {mesh}"
        if case["kind"] == "serve":
            check_serve(res, jax_serve(case["arch"]), case["arch"], mesh)
            continue
        want = jax_train(case["arch"])
        np.testing.assert_allclose(res["loss"], want["loss"], **TOL,
                                   err_msg=label)
        for key in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(res["metrics"][key],
                                       want["metrics"][key], **TOL,
                                       err_msg=f"{label} {key}")
        assert_close_leaves(res["grads"], want["grads"], LEAF_TOL)
        assert_close_leaves(res["params"], want["params"], LEAF_TOL)
