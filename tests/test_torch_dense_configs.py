"""The three dense configs the port added after smollm-360m (qwen3-4b:
qk-norm, head_dim apart from d_model / H; chatglm3-6b: half-width
interleaved RoPE, G 16; granite-20b: GELU MLP, MQA with G 48) against the
JAX package on the same weights and inputs, on the CPU.

Each arch runs at two sizes: JAX's ``reduced_config`` (G = 4 for all
three) and a narrow variant that keeps the full config's query and KV
heads (qwen3 32 / 8, chatglm 32 / 2, granite 48 / 1) at 2 layers, head_dim
32 and d_model 128, so H * head_dim differs from d_model in all three.
Weights come from the JAX initialiser in fp32 (KV cache fp32 too), with
``q_norm`` / ``k_norm`` drawn away from their init of ones so that a
swapped or skipped norm shows, and cross with the weight bridge.  Entry
points compare at atol = rtol = 1e-4 (fp32; the two frameworks sum in
different orders); the port's fused ``DecodeEngine`` must give the JAX
engine's greedy tokens exactly, dense and paged.
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
from repro.models.params import _path_str, cast_tree, init_params
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.engine import DecodeEngine, Request

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("qwen3-4b", "chatglm3-6b", "granite-20b")
# the full configs' (query heads, KV heads)
FULL_HEADS = {"qwen3-4b": (32, 8), "chatglm3-6b": (32, 2),
              "granite-20b": (48, 1)}
CASES = [(a, v) for a in ARCHS for v in ("reduced", "narrow")]


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _configs(arch: str, variant: str):
    """(JAX cfg, port cfg) in fp32, reduced or narrow."""
    kw: dict = {"dtype": "float32"}
    if variant == "narrow":
        H, K = FULL_HEADS[arch]
        kw.update(num_layers=2, num_heads=H, num_kv_heads=K, head_dim=32)
    return (jax_reduced_config(arch).replace(**kw),
            reduced_config(arch).replace(**kw))


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, port cfg, JAX params, port params) per case; norms off 1."""
    out = {}
    for i, (arch, variant) in enumerate(CASES):
        jcfg, tcfg = _configs(arch, variant)
        pj = cast_tree(init_params(jlm.make_lm(jcfg), jax.random.PRNGKey(i)),
                       jnp.float32)
        rng = np.random.default_rng(100 + i)

        def perturb(path, x, rng=rng):
            name = _path_str(path)
            if name.endswith(("q_norm", "k_norm")):
                x = x + 0.5 * jnp.asarray(
                    rng.standard_normal(x.shape, np.float32))
            return x

        pj = jax.tree_util.tree_map_with_path(perturb, pj)
        leaves = jax.tree_util.tree_flatten_with_path(pj)[0]
        pt = params_from_numpy({_path_str(p): np.asarray(x)
                                for p, x in leaves}, device="cpu")
        out[(arch, variant)] = (jcfg, tcfg, pj, pt)
    return out


def test_configs_and_variants(models):
    """The port's configs equal the JAX package's; the narrow variants keep
    the full group and q_dim != d_model; qwen3's norms left their ones."""
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jax_get_config(arch))
    for (arch, variant), (jcfg, tcfg, _, pt) in models.items():
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        G = tcfg.num_heads // tcfg.num_kv_heads
        if variant == "narrow":
            assert (tcfg.num_heads, tcfg.num_kv_heads) == FULL_HEADS[arch]
            assert tcfg.q_dim != tcfg.d_model
        else:
            assert G == 4
        mixer = pt["segments"][0]["mixer"]
        assert ("q_norm" in mixer) == (arch == "qwen3-4b")
        if "q_norm" in mixer:
            assert not torch.allclose(mixer["q_norm"], torch.ones(()))
            assert not torch.allclose(mixer["q_norm"], mixer["k_norm"])


@pytest.mark.parametrize("arch,variant", CASES)
def test_entry_points_match_jax(models, arch, variant):
    """prefill (last-token logits and every layer's K/V), then two
    prefill_chunk calls per slot at different offsets (one slot inactive
    for the second), then a decode step with one slot inactive."""
    jcfg, tcfg, pj, pt = models[(arch, variant)]
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 11))
    lj, cj = jlm.prefill(jcfg, pj, {"tokens": jnp.asarray(tokens, jnp.int32)})
    lt, ct = lm.prefill(tcfg, pt, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(_np(lt), _np(lj), **TOL)
    for name in ("k", "v"):
        assert ct[0][name].shape == (tcfg.num_layers, 2, 11,
                                     tcfg.num_kv_heads, tcfg.head_dim)
        np.testing.assert_allclose(_np(ct[0][name]), _np(cj[0][name]), **TOL)

    B, C, max_seq = 3, 8, 24
    cache_j = init_params(jlm.make_cache(jcfg, B, max_seq),
                          jax.random.PRNGKey(0))
    cache_t = lm.make_cache(tcfg, B, max_seq, device="cpu")
    for start, active in ((np.array([0, 4, 16]), np.array([True] * 3)),
                          (np.array([8, 12, 0]), np.array([True, True, False]))):
        tok = rng.integers(0, tcfg.vocab_size, (B, C)).astype(np.int32)
        cache_j = jlm.prefill_chunk(jcfg, pj, {
            "tokens": jnp.asarray(tok), "start": jnp.asarray(start, jnp.int32),
            "active": jnp.asarray(active)}, cache_j)
        lm.prefill_chunk(tcfg, pt, {
            "tokens": torch.from_numpy(tok),
            "start": torch.from_numpy(start.astype(np.int32)),
            "active": torch.from_numpy(active)}, cache_t)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache_t[0][name]),
                                   _np(cache_j[0][name]), **TOL)
    tok = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.array([16, 20, 23], np.int32)
    active = np.array([True, False, True])
    lj, cache_j = jlm.decode_step(jcfg, pj, {
        "tokens": jnp.asarray(tok), "pos": jnp.asarray(pos),
        "active": jnp.asarray(active)}, cache_j)
    lt, _ = lm.decode_step(tcfg, pt, {
        "tokens": torch.from_numpy(tok), "pos": torch.from_numpy(pos),
        "active": torch.from_numpy(active)}, cache_t)
    np.testing.assert_allclose(_np(lt[active]), _np(lj[active]), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache_t[0][name]),
                                   _np(cache_j[0][name]), **TOL)


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("arch,variant", CASES)
def test_fused_engine_matches_jax_engine(models, arch, variant, layout):
    """More requests than slots, prompts through chunked prefill and forced
    decode: the port's fused loop (eager on the CPU) gives the JAX fused
    engine's greedy tokens and step count."""
    jcfg, tcfg, pj, pt = models[(arch, variant)]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, tcfg.vocab_size, n).astype(np.int32)
               for n in (4, 13, 7, 18)]
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
