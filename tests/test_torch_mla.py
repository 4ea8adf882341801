"""The port's Multi-head Latent Attention and the MLA + MoE model
deepseek-v3-671b against the JAX package, on the CPU.

MLA on reduced ``deepseek-v3-671b`` (q_lora 64, kv_lora 32, nope 32, rope
16, v 32, 4 heads): ``apply_mla`` (through the flash kernel's plain
version at (D, Dv) = (48, 32) with the scale (nope + rope)**-0.5) and the
four weight-absorbed cache paths, chunked prefill and decode, dense and
paged: outputs and latent caches within 2e-5 (fp32, the JAX package's
attention bound).  Then the reduced model (a dense layer, MoE layers with
sigmoid scoring and a shared expert, the MTP module's parameters): the
parameter paths (``mtp`` included), ``lm.prefill`` logits and latents,
``prefill_chunk`` and ``decode_step``, ``train_loss``'s ce, aux and MTP
loss (forward only; training is ``tests/test_torch_moe_train.py``'s) at
1e-4, and the fused engine's greedy tokens equal to the JAX engine's,
dense and paged (as ``tests/test_serve.py``'s paged == dense on this
arch).  Weights are fp32, drawn with numpy from the JAX parameter
descriptors' distributions (the norms away from their ones), carried
across with the weight bridge; inputs from numpy seeds.
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
from repro.models import mla as jmla
from repro.models.params import (_path_str, abstract_params, init_params,
                                 is_param)
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import lm, mla
from repro_torch.models.attention import clamped_table
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.params import init_params as torch_init_params
from repro_torch.serve.engine import DecodeEngine, Request
from repro_torch.train.optimizer import AdamW
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.train_step import make_train_step

ARCH = "deepseek-v3-671b"
TOL = dict(atol=2e-5, rtol=2e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


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


def _draw(descr, seed: int):
    """fp32 arrays for a JAX descriptor tree, drawn with numpy (quicker
    than the JAX initialiser, which compiles a draw per leaf): the scaled
    and normal leaves as the initialiser's distributions, the RMSNorm
    weights (init ones) drawn away from their ones, zeros kept."""
    rng = np.random.default_rng(seed)

    def one(p):
        if p.init == "zeros":
            return jnp.zeros(p.shape, jnp.float32)
        if p.init == "ones":
            return jnp.asarray(1 + 0.3 * rng.standard_normal(p.shape),
                               jnp.float32)
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        std = fan_in ** -0.5 if p.init == "scaled" else (p.scale or 0.02)
        return jnp.asarray(std * rng.standard_normal(p.shape), jnp.float32)
    return jax.tree_util.tree_map(one, descr, is_leaf=is_param)


def _cfgs(**kw):
    kw.setdefault("dtype", "float32")
    return (jax_reduced_config(ARCH).replace(**kw),
            reduced_config(ARCH).replace(**kw))


@pytest.fixture(scope="module")
def layer():
    jcfg, tcfg = _cfgs()
    pj = _draw(jmla.make_mla(jcfg), 1)
    return jcfg, tcfg, pj, params_from_numpy(_flat(pj), device="cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_apply_mla_matches_jax(layer):
    """Full-sequence MLA: the output and the latents it collects."""
    jcfg, tcfg, pj, pt = layer
    x = _x((2, 13, jcfg.d_model), 0)
    pos = np.arange(13)[None, :]
    oj, (ckv_j, kpe_j) = jmla.apply_mla(jcfg, pj, jnp.asarray(x),
                                        jnp.asarray(pos))
    ot, (ckv_t, kpe_t) = mla.apply_mla(tcfg, pt, torch.from_numpy(x),
                                       torch.from_numpy(pos))
    np.testing.assert_allclose(_np(ot), _np(oj), **TOL)
    np.testing.assert_allclose(_np(ckv_t), _np(ckv_j), **TOL)
    np.testing.assert_allclose(_np(kpe_t), _np(kpe_j), **TOL)
    assert tuple(kpe_t.shape) == (2, 13, jcfg.mla.qk_rope_head_dim)


def _cache_pair(jcfg, tcfg, B, max_seq, paged):
    """(JAX cache, port cache) of one MLA layer: dense [B, S, *] or paged
    pools of P pages of ps rows (the port's with its sink page)."""
    if paged:
        jc = init_params(jmla.make_mla_cache_paged(jcfg, *paged),
                         jax.random.PRNGKey(0))
        tc = torch_init_params(mla.make_mla_cache_paged(tcfg, *paged),
                               device="cpu")
        assert {k: tuple(v.shape) for k, v in tc.items()} == {
            k: (paged[0] + 1, *v.shape[1:]) for k, v in jc.items()}
        return jc, tc
    jc = init_params(jmla.make_mla_cache(jcfg, B, max_seq),
                     jax.random.PRNGKey(0))
    tc = torch_init_params(mla.make_mla_cache(tcfg, B, max_seq),
                           device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == {
        k: v.shape for k, v in jc.items()}
    return jc, tc


@pytest.mark.parametrize("paged", [False, True])
def test_absorbed_cache_paths_match_jax(layer, paged):
    """Two prefill chunks per slot at different offsets (slot 2 inactive
    for the second), then a decode step with slot 1 inactive, through
    the weight-absorbed paths: outputs of the live slots and the latent
    caches (paged: a shuffled table, slot 2's unused pages unmapped)."""
    jcfg, tcfg, pj, pt = layer
    B, C, max_seq = 3, 8, 24
    P, ps = 20, 4
    rng = np.random.default_rng(2)
    table = None
    if paged:
        table = rng.permutation(P)[:B * (max_seq // ps)].reshape(B, -1)
        table = table.astype(np.int32)
        table[2, 4:] = P
    jc, tc = _cache_pair(jcfg, tcfg, B, max_seq, (P, ps) if paged else None)
    for i, (start, active) in enumerate((
            (np.array([0, 4, 8], np.int32), np.ones(3, bool)),
            (np.array([8, 12, 0], np.int32), np.array([True, True, False])))):
        x = _x((B, C, jcfg.d_model), 10 + i)
        args_j = (jnp.asarray(x), jc, jnp.asarray(start))
        args_t = (torch.from_numpy(x), tc, torch.from_numpy(start))
        if paged:
            oj, jc = jmla.apply_mla_prefill_chunk_paged(
                jcfg, pj, *args_j, jnp.asarray(table), jnp.asarray(active))
            ot, tc2 = mla.apply_mla_prefill_chunk_paged(
                tcfg, pt, *args_t, torch.from_numpy(table),
                clamped_table(torch.from_numpy(table), P),
                torch.from_numpy(active))
        else:
            oj, jc = jmla.apply_mla_prefill_chunk(jcfg, pj, *args_j,
                                                  jnp.asarray(active))
            ot, tc2 = mla.apply_mla_prefill_chunk(tcfg, pt, *args_t,
                                                  torch.from_numpy(active))
        assert tc2 is tc                        # written in place
        np.testing.assert_allclose(_np(ot)[active], _np(oj)[active], **TOL)
    x = _x((B, 1, jcfg.d_model), 20)
    pos = np.array([16, 20, 15], np.int32)
    active = np.array([True, False, True])
    if paged:
        oj, jc = jmla.apply_mla_decode_paged(
            jcfg, pj, jnp.asarray(x), jc, jnp.asarray(pos),
            jnp.asarray(table), jnp.asarray(active))
        ot, _ = mla.apply_mla_decode_paged(
            tcfg, pt, torch.from_numpy(x), tc, torch.from_numpy(pos),
            torch.from_numpy(table), clamped_table(torch.from_numpy(table), P),
            torch.from_numpy(active))
    else:
        oj, jc = jmla.apply_mla_decode(jcfg, pj, jnp.asarray(x), jc,
                                       jnp.asarray(pos), jnp.asarray(active))
        ot, _ = mla.apply_mla_decode(tcfg, pt, torch.from_numpy(x), tc,
                                     torch.from_numpy(pos),
                                     torch.from_numpy(active))
    np.testing.assert_allclose(_np(ot)[active], _np(oj)[active], **TOL)
    for name in ("ckv", "kpe"):
        got = tc[name][:P] if paged else tc[name]
        np.testing.assert_allclose(_np(got), _np(jc[name]), **TOL)


def test_dense_writes_past_the_cache_are_dropped(layer):
    """A position at or past max_seq and an inactive slot write nothing,
    as the reference's ``mode="drop"``."""
    jcfg, tcfg, pj, pt = layer
    B, max_seq = 2, 8
    jc, tc = _cache_pair(jcfg, tcfg, B, max_seq, None)
    x = _x((B, 1, jcfg.d_model), 30)
    pos = np.array([max_seq, 3], np.int32)
    active = np.array([True, False])
    _, jc = jmla.apply_mla_decode(jcfg, pj, jnp.asarray(x), jc,
                                  jnp.asarray(pos), jnp.asarray(active))
    mla.apply_mla_decode(tcfg, pt, torch.from_numpy(x), tc,
                         torch.from_numpy(pos), torch.from_numpy(active))
    for name in ("ckv", "kpe"):
        assert not tc[name].any()
        np.testing.assert_array_equal(_np(tc[name]), _np(jc[name]))


# ---------------------------------------------------------------------------
# the model: reduced deepseek-v3-671b
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    pj = _draw(jlm.make_lm(jcfg), 5)
    # the router bias away from its zeros: it steers the selection only
    for seg in pj["segments"]:
        if "bias" in seg["ffn"]:
            seg["ffn"]["bias"] = jnp.asarray(_x(seg["ffn"]["bias"].shape, 6)
                                             * 0.05)
    return jcfg, tcfg, pj, params_from_numpy(_flat(pj), device="cpu")


def test_config_and_param_paths(model):
    """The port's config is the JAX package's, full and reduced; the port's
    own tree has the JAX tree's paths (the MTP module's included), shapes
    and dtypes (the fp32 router and bias), and the bridge carries a JAX
    tree across and back bit for bit."""
    jcfg, tcfg, pj, pt = model
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jax_get_config(ARCH))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    own = params_to_numpy(lm.init_lm(reduced_config(ARCH),
                                     torch.Generator().manual_seed(0),
                                     device="cpu"))
    theirs = _flat(abstract_params(jlm.make_lm(jax_reduced_config(ARCH))))
    assert sorted(own) == sorted(theirs)
    assert any(k.startswith("mtp/0/block/mixer/") for k in own)
    assert own["segments/1/ffn/bias"].dtype == np.float32
    for k, v in theirs.items():
        assert own[k].shape == v.shape, k
        assert (own[k].dtype == np.float32) == (v.dtype == np.float32), k
    back = params_to_numpy(pt)
    for k, v in _flat(pj).items():
        np.testing.assert_array_equal(back[k], v)
    assert isinstance(pt["mtp"], list) and len(pt["mtp"]) == tcfg.mtp_depth


def test_prefill_matches_jax(model):
    jcfg, tcfg, pj, pt = model
    tokens = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 11))
    lj, cj = jlm.prefill(jcfg, pj, {"tokens": jnp.asarray(tokens, jnp.int32)})
    lt, ct = lm.prefill(tcfg, pt, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(_np(lt), _np(lj), **MODEL_TOL)
    assert len(ct) == 2                         # dense, then MoE layers
    for seg_t, seg_j in zip(ct, cj, strict=True):
        for name in ("ckv", "kpe"):
            np.testing.assert_allclose(_np(seg_t[name]), _np(seg_j[name]),
                                       **MODEL_TOL)


def test_train_loss_forward_matches_jax(model):
    """ce, the MoE aux, the MTP module's loss and the total (forward only,
    no remat), with the MTP module and without it; the train step takes an
    MoE or MLA model (``tests/test_torch_moe_train.py`` holds its
    gradients and steps to JAX's)."""
    jcfg, tcfg, pj, pt = model
    tokens = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 16))
    for depth in (0, 1):
        jc, tc = jcfg.replace(mtp_depth=depth), tcfg.replace(mtp_depth=depth)
        _, mj = jlm.train_loss(jc, pj, {"tokens": jnp.asarray(tokens,
                                                             jnp.int32)},
                               remat=False)
        with torch.no_grad():
            _, mt = lm.train_loss(tc, pt, {"tokens": torch.from_numpy(tokens)},
                                  remat=False)
        assert sorted(mt) == sorted(mj)
        for key in mj:
            np.testing.assert_allclose(float(mt[key]), float(mj[key]),
                                       **MODEL_TOL)
        assert float(mt["aux"]) > 0
    assert float(mt["mtp"]) > 0
    for cfg in (tcfg, reduced_config("olmoe-1b-7b")):
        assert callable(make_train_step(cfg, AdamW(),
                                        warmup_cosine(1e-3, 1, 2)))


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_chunk_then_decode_step_match_jax(model, paged):
    """Two prefill chunks per slot (one slot inactive for the second),
    then a decode step with a slot inactive: logits and the latents."""
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
        bj = {k: jnp.asarray(v) for k, v in d.items()}
        bt = {k: torch.from_numpy(v) for k, v in d.items()}
        if table is not None:
            bj["page_table"] = jnp.asarray(table)
            bt["page_table"] = torch.from_numpy(table)
        return bj, bt

    for start, active in ((np.array([0, 4, 16], np.int32), np.ones(3, bool)),
                          (np.array([8, 12, 0], np.int32),
                           np.array([True, True, False]))):
        tok = rng.integers(0, tcfg.vocab_size, (B, C)).astype(np.int32)
        bj, bt = batch({"tokens": tok, "start": start, "active": active})
        cache_j = jlm.prefill_chunk(jcfg, pj, bj, cache_j)
        lm.prefill_chunk(tcfg, pt, bt, cache_t)
    tok = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
    active = np.array([True, False, True])
    bj, bt = batch({"tokens": tok, "pos": np.array([16, 20, 23], np.int32),
                    "active": active})
    lj, cache_j = jlm.decode_step(jcfg, pj, bj, cache_j)
    lt, _ = lm.decode_step(tcfg, pt, bt, cache_t)
    np.testing.assert_allclose(_np(lt[active]), _np(lj[active]), **MODEL_TOL)
    for seg_t, seg_j in zip(cache_t, cache_j, strict=True):
        for name in ("ckv", "kpe"):
            got = seg_t[name][:, :P] if paged else seg_t[name]
            np.testing.assert_allclose(_np(got), _np(seg_j[name]),
                                       **MODEL_TOL)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_fused_engine_matches_jax_engine(model, layout):
    """More requests than slots, ragged prompts through chunked prefill and
    forced decode: the port's fused loop (eager on the CPU) gives the JAX
    fused engine's greedy tokens and step count, dense and paged."""
    jcfg, tcfg, pj, pt = model
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, tcfg.vocab_size, int(rng.integers(2, 14)))
               .astype(np.int32) for _ in range(5)]
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
    if layout == "paged":
        assert eng.pool.used_pages == 0
