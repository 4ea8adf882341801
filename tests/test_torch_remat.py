"""Remat in the port (``repro_torch/models/lm.py::backbone``) against
JAX's (``repro/models/lm.py:155-157``): each layer's products with no batch
dims are saved (``dots_with_no_batch_dims_saveable``), everything else is
recomputed in the backward.  Reduced smollm-360m in fp32 on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread a process: pytest-xdist's workers share the host's
# cores, and each would otherwise start a pool as wide as the host
torch.set_num_threads(1)

from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import reduced_config as jax_reduced_config
from repro.models import lm as jlm
from repro.models.params import _path_str, cast_tree, init_params
from repro_torch.configs import reduced_config
from repro_torch.data import synthetic
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.params import tree_leaves, tree_map


class _CountOps(TorchDispatchMode):
    """Counts the aten ops dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.ops: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] = self.ops.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def model():
    """(jax cfg, port cfg, jax fp32 params, port fp32 params)."""
    cfg_j = jax_reduced_config("smollm-360m").replace(dtype="float32")
    pj = cast_tree(init_params(jlm.make_lm(cfg_j), jax.random.PRNGKey(1)),
                   jnp.float32)
    cfg_t = reduced_config("smollm-360m").replace(dtype="float32")
    return cfg_j, cfg_t, pj, params_from_numpy(_flat(pj), device="cpu")


def _tokens(seq_len=40, step=2):
    dc = synthetic.DataConfig(vocab_size=256, seq_len=seq_len, batch_size=2,
                              seed=4)
    return synthetic.batch_at(dc, step)["tokens"]


def _flat(tree) -> dict:
    return {_path_str(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _backward(cfg, params, tokens, remat):
    """(gradient tree, the ops the backward dispatched)."""
    leaves = tree_map(lambda p: p.clone().requires_grad_(), params)
    loss = lm.train_loss(cfg, leaves, {"tokens": torch.from_numpy(tokens)},
                         remat=remat)[0]
    with _CountOps() as count:
        loss.backward()
    return tree_map(lambda p: p.grad, leaves), count.ops


def test_remat_recomputes_no_product_without_batch_dims(model):
    """The backward under remat issues exactly the ``mm``s of the backward
    without it (the saved projections are not run again), yet recomputes
    the rest of each layer (more ops in all), and the gradients are the
    same bits."""
    _, cfg, _, params = model
    tokens = _tokens()
    g_remat, ops_remat = _backward(cfg, params, tokens, True)
    g_plain, ops_plain = _backward(cfg, params, tokens, False)
    mm = torch.ops.aten.mm.default
    assert ops_remat.get(mm, 0) == ops_plain.get(mm, 0) > 0
    assert sum(ops_remat.values()) > sum(ops_plain.values())
    for a, b in zip(tree_leaves(g_remat), tree_leaves(g_plain), strict=True):
        assert torch.equal(a, b)


def test_remat_gradients_match_jax(model):
    """Gradients under remat in both frameworks, each leaf within 1e-5 of
    its largest magnitude (the bound of ``test_torch_train.py``: fp32 sums
    in another order, through 4 layers of backward)."""
    cfg_j, cfg_t, pj, pt = model
    tokens = _tokens(seq_len=24, step=5)
    gj = jax.grad(lambda p: jlm.train_loss(
        cfg_j, p, {"tokens": jnp.asarray(tokens)}, remat=True)[0])(pj)
    got = params_to_numpy(_backward(cfg_t, pt, tokens, True)[0])
    want = _flat(gj)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        err = float(np.abs(got[path] - w).max())
        assert err <= 1e-5 * float(np.abs(w).max()), (path, err)
