"""The port's model (reduced smollm-360m: 4 layers, d_model 128, vocab 256)
against the JAX package on the same weights and inputs, on the CPU.

Weights are built by the JAX initialiser and carried across with the
weight bridge; inputs come from numpy seeds.  Entry points are compared in
fp32 at atol = rtol = 1e-4; single layers at the JAX tests' bounds.
"""
import dataclasses
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread a process: pytest-xdist's workers share the host's
# cores, and each would otherwise start a pool as wide as the host
torch.set_num_threads(1)

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import lm as jlm
from repro.models.layers import apply_dense_ffn as jax_ffn
from repro.models.layers import rmsnorm as jax_rmsnorm
from repro.models.params import _path_str, cast_tree, init_params
from repro.models.params import param_count as jax_param_count
from repro.models.rope import apply_rope as jax_rope
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models import params as params_mod
from repro_torch.models.layers import apply_dense_ffn, rmsnorm
from repro_torch.models.params import init_params as torch_init_params
from repro_torch.models.params import param_count, tree_leaves
from repro_torch.models.rope import apply_rope

TOL = dict(atol=1e-4, rtol=1e-4)


def flat_numpy(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {_path_str(p): np.asarray(x) for p, x in leaves}


def flat_torch(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat_torch(v, f"{prefix}/{k}" if prefix else k))
    return out


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


@pytest.fixture(scope="module")
def model():
    """(cfg, jax fp32 params, port fp32 params) with an fp32 KV cache."""
    cfg = jax_reduced_config("smollm-360m").replace(dtype="float32")
    pj = cast_tree(init_params(jlm.make_lm(cfg), jax.random.PRNGKey(0)),
                   jnp.float32)
    pt = params_from_numpy(flat_numpy(pj), device="cpu")
    return cfg, pj, pt


def test_configs_are_copies():
    cfg_t = reduced_config("smollm-360m")
    cfg_j = jax_reduced_config("smollm-360m")
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    assert get_config("smollm-360m").num_layers == 32
    # the configs copied after smollm: full and reduced, and each
    # file is the JAX package's with only its import and docstring changed
    root = Path(__file__).resolve().parents[1] / "src"
    for arch, name in (("qwen3-4b", "qwen3_4b"),
                       ("chatglm3-6b", "chatglm3_6b"),
                       ("granite-20b", "granite_20b"),
                       ("olmoe-1b-7b", "olmoe_1b_7b"),
                       ("deepseek-v3-671b", "deepseek_v3_671b"),
                       ("jamba-v0.1-52b", "jamba_v0_1_52b"),
                       ("musicgen-medium", "musicgen_medium"),
                       ("phi-3-vision-4.2b", "phi3_vision_4_2b")):
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jax_get_config(arch))
        assert dataclasses.asdict(reduced_config(arch)) == \
            dataclasses.asdict(jax_reduced_config(arch))
        ours = (root / "repro_torch" / "configs" / f"{name}.py").read_text()
        theirs = (root / "repro" / "configs" / f"{name}.py").read_text()
        body = ours.split('"""', 2)[2].replace("repro_torch.configs",
                                                "repro.configs")
        assert body == theirs.split('"""', 2)[2]


def test_bridge_round_trip_bf16_bit_exact():
    cfg = jax_reduced_config("smollm-360m")
    pj = init_params(jlm.make_lm(cfg), jax.random.PRNGKey(1))   # bf16
    flat = flat_numpy(pj)
    pt = params_from_numpy(flat, device="cpu")
    # the port's own tree has the JAX tree's paths and shapes
    own = torch_init_params(lm.make_lm(reduced_config("smollm-360m")),
                            device="meta")
    assert {k: v.shape for k, v in params_to_numpy(pt).items()} == \
        {k: v.shape for k, v in flat.items()}
    assert {k: tuple(v.shape) for k, v in flat_torch(own).items()} == \
        {k: v.shape for k, v in flat.items()}
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(pt))
    back = params_to_numpy(pt)
    for path, arr in flat.items():
        assert back[path].dtype == np.uint16
        np.testing.assert_array_equal(back[path], arr.view(np.uint16))
    assert pt["segments"][0]["mixer"]["wq"].shape == (4, 128, 96)   # H=3, hd=32
    # and back into a bf16 port tree from the uint16 form
    again = params_from_numpy(back, device="cpu")
    assert torch.equal(again["embed"], pt["embed"])


def test_init_params_shapes_and_distributions():
    cfg = reduced_config("smollm-360m")
    gen = torch.Generator().manual_seed(0)
    pt = torch_init_params(lm.make_lm(cfg), gen, device="cpu")
    assert param_count(lm.make_lm(cfg)) == \
        jax_param_count(jlm.make_lm(jax_reduced_config("smollm-360m")))
    assert float(pt["embed"].float().std()) == pytest.approx(0.02, rel=0.05)
    wq = pt["segments"][0]["mixer"]["wq"].float()
    assert float(wq.std()) == pytest.approx(128 ** -0.5, rel=0.05)
    assert torch.equal(pt["final_norm"], torch.ones(128, dtype=torch.bfloat16))


def test_init_params_draws_a_large_leaf_in_slices(monkeypatch):
    """A normal leaf past ``SLICED_DRAW_ELEMS`` is drawn a leading-axis
    slice at a time straight into its final dtype: shapes, dtypes and each
    leaf's std stay as above, and each slice is a fresh draw.  A leaf below
    the threshold is one slice: the bits of a single draw."""
    cfg = reduced_config("smollm-360m").replace(d_ff=1024)
    descr = lm.make_lm(cfg)
    whole = torch_init_params(descr, torch.Generator().manual_seed(0),
                              device="cpu")
    monkeypatch.setattr(params_mod, "SLICED_DRAW_ELEMS", 128 * 1024)
    sliced = torch_init_params(descr, torch.Generator().manual_seed(0),
                               device="cpu")
    ffn = sliced["segments"][0]["ffn"]
    assert ffn["wi"].shape == (4, 128, 1024)       # 4 slices of 128 K each
    for name, fan_in in (("wi", 128), ("wg", 128), ("wo", 1024)):
        leaf = ffn[name]
        assert leaf.dtype == torch.bfloat16
        assert float(leaf.float().std()) == pytest.approx(fan_in ** -0.5,
                                                          rel=0.05)
        for i in range(1, 4):       # a fresh draw for each slice
            assert not torch.equal(leaf[i], leaf[0])
    assert float(sliced["embed"].float().std()) == pytest.approx(0.02,
                                                                 rel=0.05)
    for a, b in zip(tree_leaves(whole), tree_leaves(sliced), strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype
    # below the threshold: the bits of one fp32 draw, scaled, cast
    x = params_mod._normal((3, 5), 0.5, torch.bfloat16,
                           torch.Generator().manual_seed(1), "cpu")
    ref = (torch.randn((3, 5), generator=torch.Generator().manual_seed(1))
           * 0.5).bfloat16()
    assert torch.equal(x, ref)


def test_sliced_draw_descends_an_axis_where_one_slice_does_not_fit(
        monkeypatch):
    """No fp32 draw exceeds ``SLICED_DRAW_ELEMS``: a leaf whose leading
    slice alone is larger (a stack of MoE experts) is drawn slice by slice
    of the next axis down.  A leaf whose leading slices fit keeps the bits
    it had: its leading-axis runs drawn in order."""
    limit = 64
    monkeypatch.setattr(params_mod, "SLICED_DRAW_ELEMS", limit)
    drawn = []
    randn = torch.randn

    def recording(shape, *args, **kwargs):
        drawn.append(tuple(shape))
        return randn(shape, *args, **kwargs)
    monkeypatch.setattr(torch, "randn", recording)
    for shape, want in (((2, 3, 4, 8), [(2, 4, 8), (1, 4, 8)] * 2),
                        ((1, 2, 3, 32), [(2, 32), (1, 32)] * 2),
                        ((5, 16), [(4, 16), (1, 16)]),
                        ((4, 4, 4), [(4, 4, 4)]),
                        ((150,), [(64,), (64,), (22,)])):
        drawn.clear()
        x = params_mod._normal(shape, 0.5, torch.bfloat16,
                               torch.Generator().manual_seed(2), "cpu")
        assert x.shape == shape and drawn == want, shape
        assert max(math.prod(d) for d in drawn) <= limit
    # a leaf that fits keeps its bits: its runs of leading-axis slices
    gen = torch.Generator().manual_seed(3)
    x = params_mod._normal((5, 16), 0.5, torch.bfloat16,
                           torch.Generator().manual_seed(3), "cpu")
    ref = torch.cat([randn((4, 16), generator=gen), randn((1, 16),
                                                          generator=gen)])
    assert torch.equal(x, (ref * 0.5).bfloat16())
    # a stack of experts below the limit's descent draws every expert once
    big = params_mod._normal((1, 2, 3, 32), 1.0, torch.float32,
                             torch.Generator().manual_seed(4), "cpu")
    assert len({tuple(r.tolist()) for r in big.reshape(6, 32)}) == 6


def test_rmsnorm_bf16_order_of_operations():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64), np.float32)
    w = rng.standard_normal((64,), np.float32)
    got = rmsnorm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16())
    want = jax_rmsnorm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("interleaved,rotary_dim", [(False, 32), (True, 16),
                                                    (False, 16)])
@pytest.mark.parametrize("pos_shape", ["S", "BS"])
def test_rope_matches(interleaved, rotary_dim, pos_shape):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32), np.float32)
    pos = np.arange(7, dtype=np.int32) + 5
    if pos_shape == "BS":
        pos = np.stack([pos, pos + 11])
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta=500.0,
                     rotary_dim=rotary_dim, interleaved=interleaved)
    want = jax_rope(jnp.asarray(x), jnp.asarray(pos), theta=500.0,
                    rotary_dim=rotary_dim, interleaved=interleaved)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_dense_ffn_matches(act):
    cfg = jax_reduced_config("smollm-360m").replace(act=act)
    rng = np.random.default_rng(2)
    names = ("wi", "wg", "wo") if act == "silu" else ("wi", "wo")
    shapes = {"wi": (128, 256), "wg": (128, 256), "wo": (256, 128)}
    p = {n: rng.standard_normal(shapes[n], np.float32) * 0.1 for n in names}
    x = rng.standard_normal((2, 3, 128), np.float32)
    got = apply_dense_ffn(cfg, {n: torch.from_numpy(a) for n, a in p.items()},
                          torch.from_numpy(x))
    want = jax_ffn(cfg, {n: jnp.asarray(a) for n, a in p.items()},
                   jnp.asarray(x))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_prefill_logits_and_caches(model):
    cfg, pj, pt = model
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 13))
    lj, cj = jlm.prefill(cfg, pj, {"tokens": jnp.asarray(tokens, jnp.int32)})
    lt, ct = lm.prefill(cfg, pt, {"tokens": torch.from_numpy(tokens)})
    assert lt.shape == (2, cfg.vocab_size)
    np.testing.assert_allclose(_np(lt), _np(lj), **TOL)
    for name in ("k", "v"):
        assert ct[0][name].shape == (4, 2, 13, cfg.num_kv_heads, cfg.head_dim)
        np.testing.assert_allclose(_np(ct[0][name]), _np(cj[0][name]), **TOL)


def test_prefill_chunk_then_decode_step(model):
    """Two chunks per slot at different offsets (one slot inactive for the
    second), then a decode step with one slot inactive: caches and logits
    against the JAX entry points."""
    cfg, pj, pt = model
    B, C, max_seq = 3, 8, 24
    rng = np.random.default_rng(4)
    cache_j = init_params(jlm.make_cache(cfg, B, max_seq),
                          jax.random.PRNGKey(0))
    cache_t = lm.make_cache(cfg, B, max_seq, device="cpu")
    steps = [(np.array([0, 4, 16]), np.array([True, True, True])),
             (np.array([8, 12, 0]), np.array([True, True, False]))]
    for start, active in steps:
        tok = rng.integers(0, cfg.vocab_size, (B, C)).astype(np.int32)
        bj = {"tokens": jnp.asarray(tok), "start": jnp.asarray(start, jnp.int32),
              "active": jnp.asarray(active)}
        bt = {"tokens": torch.from_numpy(tok),
              "start": torch.from_numpy(start.astype(np.int32)),
              "active": torch.from_numpy(active)}
        cache_j = jlm.prefill_chunk(cfg, pj, bj, cache_j)
        out = lm.prefill_chunk(cfg, pt, bt, cache_t)
        assert out is cache_t                    # updated in place
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache_t[0][name]),
                                   _np(cache_j[0][name]), **TOL)
    tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.array([16, 20, 23], np.int32)
    active = np.array([True, False, True])
    lj, cache_j = jlm.decode_step(
        cfg, pj, {"tokens": jnp.asarray(tok), "pos": jnp.asarray(pos),
                  "active": jnp.asarray(active)}, cache_j)
    lt, _ = lm.decode_step(
        cfg, pt, {"tokens": torch.from_numpy(tok), "pos": torch.from_numpy(pos),
                  "active": torch.from_numpy(active)}, cache_t)
    np.testing.assert_allclose(_np(lt[active]), _np(lj[active]), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache_t[0][name]),
                                   _np(cache_j[0][name]), **TOL)


def test_decode_step_at_the_last_row_drops_out_of_range(model):
    """pos = max_seq - 1 writes the last row; an inactive slot writes
    nothing — never an index outside the cache."""
    cfg, pj, pt = model
    B, max_seq = 2, 6
    cache_j = init_params(jlm.make_cache(cfg, B, max_seq),
                          jax.random.PRNGKey(0))
    cache_t = lm.make_cache(cfg, B, max_seq, device="cpu")
    tok = np.array([[3], [9]], np.int32)
    pos = np.array([max_seq - 1, 2], np.int32)
    active = np.array([True, False])
    lj, cache_j = jlm.decode_step(
        cfg, pj, {"tokens": jnp.asarray(tok), "pos": jnp.asarray(pos),
                  "active": jnp.asarray(active)}, cache_j)
    lt, _ = lm.decode_step(
        cfg, pt, {"tokens": torch.from_numpy(tok), "pos": torch.from_numpy(pos),
                  "active": torch.from_numpy(active)}, cache_t)
    np.testing.assert_allclose(_np(lt[:1]), _np(lj[:1]), **TOL)
    np.testing.assert_allclose(_np(cache_t[0]["k"]), _np(cache_j[0]["k"]),
                               **TOL)
    assert not cache_t[0]["k"][:, 1].any()


def test_unported_paths_raise_not_implemented():
    """Every path that once raised here runs now.  The hybrid trains: a
    remat ``train_loss`` of reduced jamba-v0.1-52b gives a finite loss
    with ce and aux, and gradients for both super-blocks' expert stacks
    (its parity with JAX: ``tests/test_torch_jamba_train.py``).  The
    modality stubs train: musicgen's codebook loss and phi-3-vision's
    loss with image embeds give finite losses and gradients, and the
    image merge changes phi-3's loss from its text-only one; the MTP loss
    (item 5b) gives a finite loss with its ``mtp`` term."""
    for arch, batch in (
            ("musicgen-medium",
             {"tokens": torch.zeros(1, 4, 4, dtype=torch.long)}),
            ("phi-3-vision-4.2b",
             {"tokens": torch.zeros(1, 4, dtype=torch.long),
              "image_embeds": torch.zeros(1, 2, 128),
              "image_positions": torch.zeros(1, 2, dtype=torch.long)})):
        cfg = reduced_config(arch)
        params = lm.init_lm(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
        params["embed"].requires_grad_()
        loss, metrics = lm.train_loss(cfg, params, batch)
        loss.backward()
        assert sorted(metrics) == ["aux", "ce", "loss"]
        assert torch.isfinite(loss) and float(metrics["ce"].detach()) > 0
        assert torch.isfinite(params["embed"].grad).all()
    with torch.no_grad():
        text, _ = lm.train_loss(cfg, params, {"tokens": batch["tokens"]})
    assert torch.isfinite(text) and float(text) != float(loss.detach())
    cfg = reduced_config("deepseek-v3-671b")
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        loss, metrics = lm.train_loss(
            cfg, params, {"tokens": torch.zeros(1, 4, dtype=torch.long)})
    assert sorted(metrics) == ["aux", "ce", "loss", "mtp"]
    assert torch.isfinite(loss) and float(metrics["mtp"]) > 0
    cfg = reduced_config("jamba-v0.1-52b")
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    experts = params["segments"][0]["mamba_moe"]["ffn"]["wi"]
    experts.requires_grad_()
    tokens = torch.arange(8, dtype=torch.long)[None] * 5
    loss, metrics = lm.train_loss(cfg, params, {"tokens": tokens}, remat=True)
    loss.backward()
    assert sorted(metrics) == ["aux", "ce", "loss"]
    assert torch.isfinite(loss) and float(metrics["aux"]) > 0
    assert experts.grad.shape == experts.shape == (2, 2, 8, 128, 64)
    assert all(experts.grad[i].abs().max() > 0 for i in range(2))
