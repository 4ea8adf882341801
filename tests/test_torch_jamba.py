"""The port's Jamba hybrid (``blocks.HybridPlan`` super-blocks) against the
JAX package, on the CPU.

Reduced ``jamba-v0.1-52b``: 8 layers in two super-blocks of 4 (attention
at in-block index 2, Mamba elsewhere; MoE on odd indices, 8 experts top-2,
softmax), Mamba heads of (P, N) = (32, 16), chunk 32; and one narrow
variant at the full model's SSM head (P, N) = (64, 16).  Checked: the plan
and the parameter and cache descriptor trees (paths, shapes, logical
axes), ``lm.prefill`` logits and every collected cache leaf,
``prefill_chunk`` then ``decode_step`` dense and paged with an inactive
slot whose state stays as it was, the engine's greedy tokens in fused and
host mode, dense and paged, against the JAX engine's, a preempting pool,
and a slot's state zeroed at admission (its training:
``tests/test_torch_jamba_train.py``).  The MoE runs at capacity factor
4.0 (= experts / top-k), where no assignment is dropped, so every layout
and mode serves the same tokens.  Weights come from the JAX initialiser in
fp32, carried across with the weight bridge, with the Mamba scalars drawn
away from their constant inits; model tolerance 1e-4, tokens exactly.
"""
import dataclasses

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
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models.params import Param as JaxParam
from repro.models.params import _path_str, cast_tree, init_params
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import blocks, lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.params import Param
from repro_torch.serve.engine import DecodeEngine, Request

MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "jamba-v0.1-52b"
MAMBA_GROUPS = ("mamba_dense", "mamba_moe")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _flat(tree) -> dict:
    return {_path_str(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _descr_jax(tree) -> dict:
    """``{path: (shape, logical)}`` of a JAX descriptor tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JaxParam))[0]
    return {_path_str(p): (tuple(d.shape), tuple(d.logical))
            for p, d in leaves}


def _descr_port(tree, prefix: str = "") -> dict:
    """``{path: (shape, logical)}`` of a port descriptor tree."""
    if isinstance(tree, Param):
        return {prefix: (tuple(tree.shape), tuple(tree.logical))}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out: dict = {}
    for k, v in items:
        out.update(_descr_port(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _cfgs(head_dim: int | None = None):
    """(JAX cfg, port cfg): reduced Jamba in fp32 at capacity factor 4.0,
    with the Mamba head dim ``head_dim`` if given."""
    jcfg = jax_reduced_config(ARCH)
    kw: dict = {"dtype": "float32",
                "moe": dataclasses.replace(jcfg.moe, capacity_factor=4.0)}
    if head_dim is not None:
        kw["ssm"] = dataclasses.replace(jcfg.ssm, head_dim=head_dim)
    return jcfg.replace(**kw), reduced_config(ARCH).replace(**kw)


def _weights(jcfg, seed: int):
    """JAX fp32 params with random Mamba scalars, and the port's copy."""
    pj = cast_tree(init_params(jlm.make_lm(jcfg), jax.random.PRNGKey(seed)),
                   jnp.float32)
    rng = np.random.default_rng(seed)
    flat = _flat(pj)
    for group in MAMBA_GROUPS:
        for name, scale in (("A_log", 0.5), ("D", 1.0), ("dt_bias", 0.5),
                            ("conv_b", 0.1)):
            key = f"segments/0/{group}/mixer/{name}"
            flat[key] = (flat[key] + scale * rng.standard_normal(
                flat[key].shape)).astype(np.float32)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(pj)
    pj = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(flat[_path_str(p)]) for p, _ in leaves])
    return pj, params_from_numpy(flat, device="cpu")


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    return (jcfg, tcfg, *_weights(jcfg, 11))


def test_plan_and_descriptor_trees():
    """The plan's entries and group sizes (reduced and published), the
    parameter tree and the dense and paged cache trees: the JAX package's
    paths, shapes and logical axes."""
    for jcfg, tcfg in (_cfgs(), (jax_get_config(ARCH), get_config(ARCH))):
        jp, tp = jblocks.HybridPlan.build(jcfg), blocks.HybridPlan.build(tcfg)
        assert tp.entries == jp.entries
        assert tp.group_sizes == jp.group_sizes
    assert tp.group_sizes == {"mamba_dense": 3, "mamba_moe": 4,
                              "attn_dense": 1}
    assert [e[2] for e in tp.entries].index("attn") == 4
    jcfg, tcfg = _cfgs()
    assert _descr_port(lm.make_lm(tcfg)) == _descr_jax(jlm.make_lm(jcfg))
    for paged in (None, (12, 4)):
        ours = _descr_port(lm.cache_descr(tcfg, 3, 24, paged))
        if paged:       # the port's pools carry one more page, the sink
            for key in ("0/attn_dense/k", "0/attn_dense/v"):
                shape, logical = ours[key]
                assert shape[-4] == 13
                ours[key] = ((*shape[:-4], 12, *shape[-3:]), logical)
        assert ours == _descr_jax(jlm.make_cache(jcfg, 3, 24, paged=paged))
    seg = lm.segments(tcfg)[0]
    assert (seg.kind, seg.count) == ("hybrid", 2)


def test_apply_super_block_matches_jax(model):
    """One super-block's full-sequence path: h and the MoE aux loss summed
    over its MoE layers, against ``repro.models.blocks``."""
    jcfg, tcfg, pj, pt = model
    plan_j, plan_t = (jblocks.HybridPlan.build(jcfg),
                      blocks.HybridPlan.build(tcfg))
    sb_j = jax.tree_util.tree_map(lambda a: a[1], pj["segments"][0])
    sb_t = blocks.take_layer(pt["segments"][0], 1)
    h = np.random.default_rng(4).standard_normal((2, 21, tcfg.d_model)) \
        .astype(np.float32)
    pos = np.arange(21)[None, :]
    hj, aj = jblocks.apply_super_block(jcfg, sb_j, jnp.asarray(h),
                                       jnp.asarray(pos), plan_j)
    ht, at = blocks.apply_super_block(tcfg, sb_t, torch.from_numpy(h),
                                      torch.from_numpy(pos), plan_t)
    np.testing.assert_allclose(_np(ht), _np(hj), **MODEL_TOL)
    np.testing.assert_allclose(float(at), float(aj), **MODEL_TOL)
    assert float(at) > 0


@pytest.mark.parametrize("head_dim", [None, 64])
def test_prefill_matches_jax(model, head_dim):
    """Logits and every collected cache leaf; ``head_dim`` 64 runs the
    Mamba layers at the published head (P, N) = (64, 16)."""
    if head_dim is None:
        jcfg, tcfg, pj, pt = model
    else:
        jcfg, tcfg = _cfgs(head_dim)
        pj, pt = _weights(jcfg, 12)
        assert (tcfg.ssm.head_dim, tcfg.ssm.d_state) == (64, 16)
    tokens = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 45))
    lj, cj = jlm.prefill(jcfg, pj, {"tokens": jnp.asarray(tokens, jnp.int32)})
    lt, ct = lm.prefill(tcfg, pt, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(_np(lt), _np(lj), **MODEL_TOL)
    got, want = _flat_t(ct), _flat(cj)
    assert sorted(got) == sorted(want)
    for key, v in want.items():
        assert got[key].shape == v.shape, key
        np.testing.assert_allclose(got[key], v.astype(np.float32),
                                   **MODEL_TOL, err_msg=key)


def _flat_t(tree, prefix: str = "") -> dict:
    """``{path: ndarray}`` of a tree of tensors, as copies."""
    if isinstance(tree, torch.Tensor):
        return {prefix: _np(tree).copy()}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out: dict = {}
    for k, v in items:
        out.update(_flat_t(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_chunk_then_decode_step_match_jax(model, paged):
    """Two prefill chunks per slot (slot 2 inactive for the second), then a
    decode step with slot 1 inactive: the logits, and every cache leaf
    against JAX's; the inactive slot's conv and SSM state and its KV rows
    (dense stripe, or its pages) are as they were before the step."""
    jcfg, tcfg, pj, pt = model
    B, C, max_seq, P, ps = 3, 8, 24, 20, 4
    lay = (P, ps) if paged else None
    rng = np.random.default_rng(9)
    table = None
    if paged:
        table = rng.permutation(P)[:B * (max_seq // ps)].reshape(B, -1)
        table = table.astype(np.int32)
    cache_j = init_params(jlm.make_cache(jcfg, B, max_seq, paged=lay),
                          jax.random.PRNGKey(0))
    cache_t = lm.make_cache(tcfg, B, max_seq, paged=lay, device="cpu")

    def batch(d):
        out_j = {k: jnp.asarray(v) for k, v in d.items()}
        out_t = {k: torch.from_numpy(v) for k, v in d.items()}
        if table is not None:
            out_j["page_table"] = jnp.asarray(table)
            out_t["page_table"] = torch.from_numpy(table)
        return out_j, out_t

    for start, active in ((np.array([0, 4, 16], np.int32), np.ones(3, bool)),
                          (np.array([8, 12, 0], np.int32),
                           np.array([True, True, False]))):
        tok = rng.integers(0, tcfg.vocab_size, (B, C)).astype(np.int32)
        bj, bt = batch({"tokens": tok, "start": start, "active": active})
        cache_j = jlm.prefill_chunk(jcfg, pj, bj, cache_j)
        lm.prefill_chunk(tcfg, pt, bt, cache_t)
    before = _flat_t(cache_t)
    tok = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
    active = np.array([True, False, True])
    bj, bt = batch({"tokens": tok, "pos": np.array([16, 20, 23], np.int32),
                    "active": active})
    lj, cache_j = jlm.decode_step(jcfg, pj, bj, cache_j)
    lt, out = lm.decode_step(tcfg, pt, bt, cache_t)
    assert out is cache_t
    np.testing.assert_allclose(_np(lt[active]), _np(lj[active]), **MODEL_TOL)
    got, want = _flat_t(cache_t), _flat(cache_j)
    for key, v in want.items():
        g = got[key]
        if paged and key.endswith(("/k", "/v")):
            g = g[..., :P, :, :, :]          # the sink page is the port's own
        np.testing.assert_allclose(g, v.astype(np.float32), **MODEL_TOL,
                                   err_msg=key)
    for key, v in got.items():
        if paged and key.endswith(("/k", "/v")):
            rows = np.sort(table[1])          # slot 1's pages, axis -4
            np.testing.assert_array_equal(v[..., rows, :, :, :],
                                          before[key][..., rows, :, :, :])
        else:                                 # [count, n, batch, ...]
            np.testing.assert_array_equal(v[:, :, 1], before[key][:, :, 1])
        assert not np.array_equal(v, before[key]), key


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, n).astype(np.int32) for n in lens]


def _serve(cfg, pt, prompts, max_new=5, **kw):
    eng = DecodeEngine(cfg, pt, device="cpu", **kw)
    reqs = [Request(prompt=p, max_new_tokens=max_new) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done and not r.failed and len(r.output) == max_new
               for r in reqs)
    return [list(r.output) for r in reqs], eng


ENGINE_KW = dict(batch_slots=3, max_seq=40, steps_per_sync=4,
                 prefill_chunk=4)
ENGINE_PROMPTS = (4, 13, 7, 18, 9)


@pytest.fixture(scope="module")
def jax_tokens(model):
    """The JAX fused engine's greedy tokens and steps, dense layout."""
    jcfg, _, pj, _ = model
    jeng = JaxEngine(jcfg, pj, mode="fused", **ENGINE_KW)
    jreqs = [JaxRequest(prompt=p, max_new_tokens=5)
             for p in _prompts(7, ENGINE_PROMPTS)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_drained()
    return [[int(t) for t in r.output] for r in jreqs], jeng.steps


@pytest.mark.parametrize("layout,mode", [("dense", "fused"),
                                         ("dense", "host"),
                                         ("paged", "fused"),
                                         ("paged", "host")])
def test_engine_matches_jax_engine(model, jax_tokens, layout, mode):
    """More requests than slots, prompts through chunked prefill and forced
    decode: the port's engine gives the JAX engine's greedy tokens in each
    (layout, mode) (no assignment dropped, so the JAX engine's own tokens
    agree across them), and the fused dense run its step count."""
    _, tcfg, _, pt = model
    kw = dict(ENGINE_KW, mode=mode)
    if layout == "paged":
        kw.update(kv_layout="paged", page_size=8)
    got, eng = _serve(tcfg, pt, _prompts(7, ENGINE_PROMPTS), **kw)
    assert got == jax_tokens[0]
    if (layout, mode) == ("dense", "fused"):
        assert eng.steps == jax_tokens[1]
    if layout == "paged":
        assert eng.pool.used_pages == 0
        # the attention group's k and v pools, page axis before seq_kv
        assert [ax for _, ax in eng._pool_leaves] == [2, 2]


@pytest.mark.parametrize("mode", ["host", "fused"])
def test_preempting_pool_finishes_every_request(model, mode):
    """Six pages of eight rows cannot back the slots at once: the youngest
    is preempted and re-admitted from zero state, every request finishes
    with the dense layout's tokens and every page comes back."""
    _, tcfg, _, pt = model
    prompts = _prompts(8, (14, 6, 12, 9, 13))
    kw = dict(ENGINE_KW, mode=mode, max_seq=48)
    dense, _ = _serve(tcfg, pt, prompts, max_new=12, **kw)
    paged, eng = _serve(tcfg, pt, prompts, max_new=12, kv_layout="paged",
                        page_size=8, num_pages=6, **kw)
    assert eng.stats["preemptions"] >= 1
    assert paged == dense
    stats = eng.kv_stats()
    assert eng.pool.used_pages == 0 and stats["slot_footprint"] == [0] * 3


def test_admission_zeroes_the_slot_state(model):
    """A request served in a slot that two earlier requests used equals the
    same request served alone: admission zeroes the slot's conv and SSM
    rows of every Mamba group (and only the state leaves: 6 Mamba layers
    of the two super-blocks, no KV leaf)."""
    _, tcfg, _, pt = model
    a, b, r = _prompts(1, (7, 15, 10))
    kw = dict(max_seq=40, steps_per_sync=3, prefill_chunk=4)
    reused, eng = _serve(tcfg, pt, [a, b, r], batch_slots=1, mode="fused",
                         **kw)
    solo, _ = _serve(tcfg, pt, [r], batch_slots=1, mode="fused", **kw)
    assert reused[2] == solo[0]
    s = tcfg.ssm
    nheads, conv_ch = s.n_heads(tcfg.d_model), \
        s.d_inner(tcfg.d_model) + 2 * s.n_groups * s.d_state
    per_layer = (s.d_conv - 1) * conv_ch + nheads * s.head_dim * s.d_state
    assert [ax for _, ax in eng._state_leaves] == [2, 2, 2, 2]
    assert eng.stats["admit_cache_elems"] == 3 * 6 * per_layer


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_serve_launcher_runs_the_hybrid(layout, capsys):
    """``launch/serve.py --arch jamba-v0.1-52b`` on the CPU, reduced
    preset, cut to one super-block with ``--layers``."""
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                "--prefill-chunk", "4", "--layers", "4",
                "--kv-layout", layout])
    out = capsys.readouterr().out
    assert f"{ARCH}: 3 requests, 48 tokens" in out
    assert ("paged KV" in out) == (layout == "paged")
