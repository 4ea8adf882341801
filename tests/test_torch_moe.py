"""The port's MoE FFN and the MoE model olmoe-1b-7b against the JAX
package, on the CPU.

The MoE layer runs on reduced ``olmoe-1b-7b`` (softmax scoring) and on
reduced ``deepseek-v3-671b``'s MoE config (sigmoid scoring with a bias that
steers only the selection, one shared expert): ``_route`` (ids equal,
weights and aux within 1e-5) and ``apply_moe_gather`` (1e-5, fp32), also
at a capacity factor small enough that assignments are dropped, where the
same assignments must be dropped; and the capacity's coupling of the
tokens of one call: a token's output changes with another token of the
same call, in both frameworks alike.  Then the reduced model: the
parameter paths, ``lm.prefill`` logits, ``prefill_chunk`` and
``decode_step``, ``train_loss``'s ce and aux (forward only) at 1e-4, and
the engine's greedy tokens equal to the JAX engine's, dense and paged,
also under a capacity factor that drops assignments in the prefill
chunks (where the idle slots' rows take expert capacity too).  Weights come from the JAX initialiser in fp32 (``cast_tree``),
carried across with the weight bridge; inputs from numpy seeds.
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
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models.params import (_path_str, abstract_params, cast_tree,
                                 init_params)
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import lm, moe
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.params import tree_leaves
from repro_torch.serve.engine import DecodeEngine, Request

TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
# (name, arch whose reduced MoE config the layer takes)
LAYERS = (("softmax", "olmoe-1b-7b"), ("sigmoid_shared", "deepseek-v3-671b"))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _flat(tree) -> dict:
    """``{path: leaf}``, arrays as numpy (shape-dtype structs as they
    are)."""
    return {_path_str(p): x if isinstance(x, jax.ShapeDtypeStruct)
            else np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _layer_cfg(arch: str, cf: float | None = None):
    """(JAX cfg, port cfg) in fp32 at the arch's reduced MoE config, with
    capacity factor ``cf`` if given."""
    jcfg, tcfg = jax_reduced_config(arch), reduced_config(arch)
    kw: dict = {"dtype": "float32"}
    if cf is not None:
        kw["moe"] = dataclasses.replace(jcfg.moe, capacity_factor=cf)
    return jcfg.replace(**kw), tcfg.replace(**kw)


@pytest.fixture(scope="module")
def layers():
    """Per layer kind: (JAX params, port params) of one MoE FFN, fp32; the
    sigmoid layer's bias drawn away from its zeros so that selection and
    weights differ."""
    out = {}
    for i, (name, arch) in enumerate(LAYERS):
        jcfg, _ = _layer_cfg(arch)
        pj = cast_tree(init_params(jmoe.make_moe(jcfg), jax.random.PRNGKey(i)),
                       jnp.float32)
        if "bias" in pj:
            pj["bias"] = jnp.asarray(np.random.default_rng(i).standard_normal(
                pj["bias"].shape).astype(np.float32) * 0.05)
        out[name] = (pj, params_from_numpy(_flat(pj), device="cpu"))
    return out


def _x(T: int, d: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((T, d)).astype(
        np.float32)


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


def _port_kept(tcfg, ids) -> np.ndarray:
    T, k = ids.shape
    order, keep, _ = moe._dispatch(ids, tcfg.moe.num_experts,
                                   moe._capacity(tcfg, T))
    kept = torch.zeros(T * k, dtype=torch.bool)
    kept[order] = keep
    return kept.reshape(T, k).numpy()


@pytest.mark.parametrize("name,arch", LAYERS)
def test_route_matches_jax(layers, name, arch):
    """Top-k ids (in their order), weights and the aux loss."""
    jcfg, tcfg = _layer_cfg(arch)
    pj, pt = layers[name]
    x = _x(40, jcfg.d_model, 1)
    wj, idj, auxj = jmoe._route(jcfg, pj, jnp.asarray(x))
    wt, idt, auxt = moe._route(tcfg, pt, torch.from_numpy(x))
    assert idt.dtype == torch.int32
    np.testing.assert_array_equal(idt.numpy(), np.asarray(idj))
    np.testing.assert_allclose(_np(wt), _np(wj), **TOL)
    np.testing.assert_allclose(float(auxt), float(auxj), **TOL)
    if name == "sigmoid_shared":     # normalised weights, biased selection
        np.testing.assert_allclose(wt.sum(1).numpy(), 1.0, **TOL)
        scores = torch.sigmoid(torch.from_numpy(x) @ pt["router"])
        assert not torch.equal(torch.topk(scores, tcfg.moe.top_k).indices,
                               idt.long())


@pytest.mark.parametrize("cf", [None, 0.25])
@pytest.mark.parametrize("name,arch", LAYERS)
def test_apply_moe_gather_matches_jax(layers, name, arch, cf):
    """The layer's output and scaled aux; at capacity factor 0.25 (C = 8
    slots an expert against 16 assignments on average) assignments are
    dropped, the same ones in both frameworks."""
    jcfg, tcfg = _layer_cfg(arch, cf)
    pj, pt = layers[name]
    T = 64
    x = _x(T, jcfg.d_model, 2)
    yj, auxj = jmoe.apply_moe_gather(jcfg, pj, jnp.asarray(x))
    yt, auxt = moe.apply_moe(tcfg, pt, torch.from_numpy(x))
    np.testing.assert_allclose(_np(yt), _np(yj), **TOL)
    np.testing.assert_allclose(float(auxt), float(auxj), **TOL)
    _, idj, _ = jmoe._route(jcfg, pj, jnp.asarray(x))
    kept_j = _jax_kept(jcfg, idj, T)
    kept_t = _port_kept(tcfg, torch.from_numpy(np.array(idj)))
    np.testing.assert_array_equal(kept_t, kept_j)
    assert moe._capacity(tcfg, T) == jmoe._capacity(jcfg, T)
    assert kept_t.all() == (cf is None)


@pytest.mark.parametrize("name,arch", LAYERS)
def test_capacity_couples_the_tokens_of_a_call(layers, name, arch):
    """The last token of a call ranks last in each of its experts.  At
    capacity factor 0.25 and 16 tokens (8 slots an expert), random other
    rows leave it its slots; once every other row is a copy of it (each
    of its experts then gets 16 assignments), all its assignments are
    dropped and its output changes, in both frameworks alike.  At
    capacity factor 4 (16 slots an expert) nothing is dropped and its
    output stays."""
    pj, pt = layers[name]
    T, d = 16, jax_reduced_config(arch).d_model
    x = _x(T, d, 3)
    x2 = x.copy()
    x2[:-1] = x[-1]
    for cf in (0.25, 4.0):
        jcfg, tcfg = _layer_cfg(arch, cf)
        outs = []
        for rows in (x, x2):
            yj, _ = jmoe.apply_moe_gather(jcfg, pj, jnp.asarray(rows))
            yt, _ = moe.apply_moe(tcfg, pt, torch.from_numpy(rows))
            np.testing.assert_allclose(_np(yt), _np(yj), **TOL)
            outs.append((_np(yj)[-1], _np(yt)[-1]))
            kept = _port_kept(tcfg, moe._route(tcfg, pt,
                                               torch.from_numpy(rows))[1])
            assert kept[-1].all() == (cf == 4.0 or rows is x)
        (j1, t1), (j2, t2) = outs
        if cf == 0.25:
            assert np.abs(j1 - j2).max() > 1e-3
            np.testing.assert_allclose(t1 - t2, j1 - j2, **TOL)
        else:
            np.testing.assert_allclose(t1, t2, **TOL)
            np.testing.assert_allclose(j1, j2, **TOL)


def test_expert_parallel_path_raises(layers, monkeypatch):
    """``REPRO_MOE=ep`` takes the expert-parallel dispatch only under rules
    whose mesh has a model axis (``tests/test_torch_ep.py``); with no rules
    installed it is the gather dispatch, as the reference's ``apply_moe``
    picks it, and raises nothing."""
    monkeypatch.setenv("REPRO_MOE", "ep")
    jcfg, tcfg = _layer_cfg("olmoe-1b-7b")
    pj, pt = layers["softmax"]
    x = np.random.default_rng(3).standard_normal(
        (40, tcfg.d_model)).astype(np.float32)
    yj, auxj = jmoe.apply_moe(jcfg, pj, jnp.asarray(x))
    y, aux = moe.apply_moe(tcfg, pt, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), _np(yj), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(auxj), atol=1e-5, rtol=1e-5)
    g, gaux = moe.apply_moe_gather(tcfg, pt, torch.from_numpy(x))
    assert torch.equal(y, g) and torch.equal(aux, gaux)


# ---------------------------------------------------------------------------
# the model: reduced olmoe-1b-7b
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduced_config("olmoe-1b-7b").replace(dtype="float32")
    tcfg = reduced_config("olmoe-1b-7b").replace(dtype="float32")
    pj = cast_tree(init_params(jlm.make_lm(jcfg), jax.random.PRNGKey(7)),
                   jnp.float32)
    return jcfg, tcfg, pj, params_from_numpy(_flat(pj), device="cpu")


def test_config_and_param_paths(model):
    """The port's config is the JAX package's; the port's own tree has the
    JAX tree's paths, shapes and dtypes (the fp32 router), and the bridge
    carries a JAX tree across and back bit for bit."""
    jcfg, tcfg, pj, pt = model
    assert dataclasses.asdict(get_config("olmoe-1b-7b")) == \
        dataclasses.asdict(jax_get_config("olmoe-1b-7b"))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    own = lm.init_lm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    ours = params_to_numpy(own)
    theirs = _flat(abstract_params(jlm.make_lm(
        jax_reduced_config("olmoe-1b-7b"))))
    assert sorted(ours) == sorted(theirs)
    assert "segments/0/ffn/router" in ours
    for k, v in theirs.items():
        assert ours[k].shape == v.shape, k
        assert (ours[k].dtype == np.float32) == (v.dtype == np.float32), k
    back = params_to_numpy(pt)
    for k, v in _flat(pj).items():
        np.testing.assert_array_equal(back[k], v)
    assert len(tree_leaves(own)) == len(theirs)


def test_prefill_matches_jax(model):
    jcfg, tcfg, pj, pt = model
    tokens = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 11))
    lj, cj = jlm.prefill(jcfg, pj, {"tokens": jnp.asarray(tokens, jnp.int32)})
    lt, ct = lm.prefill(tcfg, pt, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(_np(lt), _np(lj), **MODEL_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(ct[0][name]), _np(cj[0][name]),
                                   **MODEL_TOL)


def test_train_loss_forward_matches_jax(model):
    """ce and the MoE aux summed over layers (forward only, no remat)."""
    jcfg, tcfg, pj, pt = model
    tokens = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 16))
    _, mj = jlm.train_loss(jcfg, pj, {"tokens": jnp.asarray(tokens,
                                                            jnp.int32)},
                           remat=False)
    with torch.no_grad():
        _, mt = lm.train_loss(tcfg, pt, {"tokens": torch.from_numpy(tokens)},
                              remat=False)
    for key in ("ce", "aux", "loss"):
        np.testing.assert_allclose(float(mt[key]), float(mj[key]), **MODEL_TOL)
    assert float(mt["aux"]) > 0


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_chunk_then_decode_step_match_jax(model, paged):
    """Two prefill chunks per slot (one slot inactive for the second),
    then a decode step with a slot inactive: logits and the caches."""
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

    def batch(d, tbl):
        out_j = {k: jnp.asarray(v) for k, v in d.items()}
        out_t = {k: torch.from_numpy(v) for k, v in d.items()}
        if tbl is not None:
            out_j["page_table"] = jnp.asarray(tbl)
            out_t["page_table"] = torch.from_numpy(tbl)
        return out_j, out_t

    for start, active in ((np.array([0, 4, 16], np.int32), np.ones(3, bool)),
                          (np.array([8, 12, 0], np.int32),
                           np.array([True, True, False]))):
        tok = rng.integers(0, tcfg.vocab_size, (B, C)).astype(np.int32)
        bj, bt = batch({"tokens": tok, "start": start, "active": active},
                       table)
        cache_j = jlm.prefill_chunk(jcfg, pj, bj, cache_j)
        lm.prefill_chunk(tcfg, pt, bt, cache_t)
    tok = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
    active = np.array([True, False, True])
    bj, bt = batch({"tokens": tok, "pos": np.array([16, 20, 23], np.int32),
                    "active": active}, table)
    lj, cache_j = jlm.decode_step(jcfg, pj, bj, cache_j)
    lt, _ = lm.decode_step(tcfg, pt, bt, cache_t)
    np.testing.assert_allclose(_np(lt[active]), _np(lj[active]), **MODEL_TOL)
    for name in ("k", "v"):
        got = cache_t[0][name][:, :P] if paged else cache_t[0][name]
        np.testing.assert_allclose(_np(got), _np(cache_j[0][name]),
                                   **MODEL_TOL)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_fused_engine_matches_jax_engine(model, layout):
    """More requests than slots, prompts through chunked prefill (chunks
    of 3 slots x 4 tokens, the rows of idle slots zeros in both) and
    forced decode: the port's fused loop (eager on the CPU) gives the JAX fused
    engine's greedy tokens and step count."""
    jcfg, tcfg, pj, pt = model
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, tcfg.vocab_size, n).astype(np.int32)
               for n in (4, 13, 7, 18, 9)]
    kw = dict(batch_slots=3, max_seq=40, mode="fused", steps_per_sync=4,
              prefill_chunk=4)
    if layout == "paged":
        kw.update(kv_layout="paged", page_size=8)
    jeng = JaxEngine(jcfg, pj, **kw)
    jreqs = [JaxRequest(prompt=p, max_new_tokens=5) for p in prompts]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_drained()
    eng = DecodeEngine(tcfg, pt, device="cpu", **kw)
    reqs = [Request(prompt=p, max_new_tokens=5) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done and not r.failed and len(r.output) == 5 for r in reqs)
    assert [list(r.output) for r in reqs] == \
        [[int(t) for t in r.output] for r in jreqs]
    assert eng.steps == jeng.steps


@pytest.mark.parametrize("layout,mode", [("dense", "host"),
                                         ("paged", "fused")])
def test_engine_under_capacity_drops_matches_jax_engine(model, layout, mode,
                                                        monkeypatch):
    """At capacity factor 0.25 the prefill chunks drop assignments, so the
    rows the engine feeds for idle slots (zero tokens, attending to what
    their own cache or their table's pages hold: an unmapped entry reads
    the last real page, as the reference's clamp does) decide which live
    assignments are kept: the port's engine gives the JAX engine's greedy
    tokens all the same (the fused engine dense and the host engine
    paged run in ``test_fused_engine_matches_jax_engine`` and
    ``test_torch_paged.py``)."""
    dropped = []
    dispatch = moe._dispatch

    def recording(ids, E, C):
        plan = dispatch(ids, E, C)
        dropped.append(int((~plan[1]).sum()))
        return plan
    monkeypatch.setattr(moe, "_dispatch", recording)
    jax_tokens, port_tokens = _tokens_under_drops(model, layout, mode)
    assert sum(dropped) > 0
    assert port_tokens == jax_tokens


def _tokens_under_drops(model, layout: str, mode: str):
    """Greedy tokens of the JAX engine and of the port's, reduced olmoe at
    capacity factor 0.25: 8 requests through 4 slots, chunks of 4 tokens,
    4 steps a fused sync."""
    jcfg, tcfg, pj, pt = model
    moe_cf = dataclasses.replace(jcfg.moe, capacity_factor=0.25)
    jcfg, tcfg = jcfg.replace(moe=moe_cf), tcfg.replace(moe=moe_cf)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, tcfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(2, 30, 8)]
    kw = dict(batch_slots=4, max_seq=48, mode=mode, steps_per_sync=4,
              prefill_chunk=4)
    if layout == "paged":
        kw.update(kv_layout="paged", page_size=8)
    jeng = JaxEngine(jcfg, pj, **kw)
    jreqs = [JaxRequest(prompt=p, max_new_tokens=6) for p in prompts]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_drained()
    eng = DecodeEngine(tcfg, pt, device="cpu", **kw)
    reqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return ([[int(t) for t in r.output] for r in jreqs],
            [list(r.output) for r in reqs])


def test_capacity_drops_part_modes_and_layouts_in_both_engines(model):
    """Under capacity drops the reference engine's own greedy tokens differ
    between host mode and a fused sync of 4 steps (paged layout: the idle
    slots' rows of a prefill chunk attend to cache rows that different
    decode steps wrote) and between the dense and the paged layout (fused:
    an idle slot reads its stale stripe or the pages its table maps).  The
    port's engine gives the reference's tokens in all four (layout, mode)
    pairs, so it differs in the same places.  This is why an MoE model's
    host mode is held to a fused sync of one step, not of 8, and a
    preempting pool is not held to the dense layout, on the card."""
    runs = {(layout, mode): _tokens_under_drops(model, layout, mode)
            for layout in ("dense", "paged") for mode in ("host", "fused")}
    for key, (jax_tokens, port_tokens) in runs.items():
        assert port_tokens == jax_tokens, key
    jax = {key: tokens for key, (tokens, _) in runs.items()}
    assert jax["paged", "host"] != jax["paged", "fused"]
    assert jax["dense", "fused"] != jax["paged", "fused"]
