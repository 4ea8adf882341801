"""The port's DecodeEngine against the JAX package's, on the CPU.

Reduced smollm-360m with fp32 weights (built by the JAX initialiser, cast
with ``cast_tree`` and carried across with the weight bridge) and the
config's bf16 KV cache, as the reference engine tests run it.  Greedy
outputs must agree token for token.
"""
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
from repro.models.params import _path_str, cast_tree, init_params
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro.serve.sampler import sample_batch as jax_sample_batch
from repro_torch.configs import reduced_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.engine import DecodeEngine, Request
from repro_torch.serve.sampler import _greedy, sample_batch, vocab_hash

PROMPT_LENS = (5, 12, 3, 20, 9)


@pytest.fixture(scope="module")
def weights():
    cfg = jax_reduced_config("smollm-360m")
    pj = cast_tree(init_params(jlm.make_lm(cfg), jax.random.PRNGKey(0)),
                   jnp.float32)
    leaves = jax.tree_util.tree_flatten_with_path(pj)[0]
    pt = params_from_numpy({_path_str(p): np.asarray(x) for p, x in leaves},
                           device="cpu")
    return cfg, pj, pt


def _prompts(seed=0, lens=PROMPT_LENS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lens]


def _serve(pt, prompts, max_new=6, temperature=0.0, **kw):
    eng = DecodeEngine(reduced_config("smollm-360m"), pt, device="cpu", **kw)
    reqs = [Request(prompt=p, max_new_tokens=max_new, temperature=temperature)
            for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done and not r.failed for r in reqs)
    return [list(r.output) for r in reqs], eng


@pytest.mark.parametrize("mode,chunk", [("host", 0), ("fused", 0),
                                        ("host", 8), ("fused", 8)])
def test_greedy_tokens_match_jax_engine(weights, mode, chunk):
    """More requests than slots; prompts longer than a chunk go through
    chunked prefill."""
    cfg, pj, pt = weights
    prompts = _prompts()
    kw = dict(batch_slots=2, max_seq=48, mode=mode, steps_per_sync=4,
              prefill_chunk=chunk)
    jeng = JaxEngine(cfg, pj, **kw)
    jreqs = [JaxRequest(prompt=p, max_new_tokens=6) for p in prompts]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_drained()
    got, eng = _serve(pt, prompts, **kw)
    assert got == [[int(t) for t in r.output] for r in jreqs]
    assert all(len(o) == 6 for o in got)
    assert eng.steps == jeng.steps


def test_batched_equals_solo_and_host_equals_fused(weights):
    _, _, pt = weights
    prompts = _prompts(1, (7, 15, 4))
    kw = dict(batch_slots=3, max_seq=40, steps_per_sync=3, prefill_chunk=4)
    batched, _ = _serve(pt, prompts, mode="fused", **kw)
    solo, _ = _serve(pt, prompts[1:2], mode="fused", **kw)
    host, _ = _serve(pt, prompts, mode="host", **kw)
    assert solo[0] == batched[1]
    assert host == batched


def test_rejected_prompts_keep_serving(weights):
    _, _, pt = weights
    eng = DecodeEngine(reduced_config("smollm-360m"), pt, batch_slots=2,
                       max_seq=16, device="cpu")
    good = [Request(prompt=p, max_new_tokens=3) for p in _prompts(2, (4, 6))]
    empty = Request(prompt=np.zeros((0,), np.int32))
    too_long = Request(prompt=np.ones((16,), np.int32))
    for r in (good[0], empty, too_long, good[1]):
        eng.submit(r)
    eng.run_until_drained()
    assert empty.failed and too_long.failed
    assert "outside [1, max_seq=16)" in too_long.fail_reason
    assert all(r.done and not r.failed and len(r.output) == 3 for r in good)
    stats = eng.kv_stats()
    assert stats["rejected"] == 2 and stats["admissions"] == 2
    assert stats["kv_layout"] == "dense"
    assert stats["cache_elems"] == 2 * 4 * 2 * 16 * 1 * 32   # k,v L B S K hd


@pytest.mark.parametrize("mode", ["host", "fused"])
def test_sampled_stream_independent_of_slot_and_neighbours(weights, mode):
    """The third admitted request draws the same tokens whether it lands
    in slot 2 beside two running neighbours or in slot 0 after a short
    request retires."""
    _, _, pt = weights
    a, b, r = _prompts(3, (3, 10, 6))

    def run(slots, first_new):
        eng = DecodeEngine(reduced_config("smollm-360m"), pt,
                           batch_slots=slots, max_seq=40, mode=mode,
                           steps_per_sync=2, rng_seed=7, device="cpu")
        reqs = [Request(prompt=a, max_new_tokens=first_new),
                Request(prompt=b, max_new_tokens=12),
                Request(prompt=r, max_new_tokens=8, temperature=1.0)]
        for q in reqs:
            eng.submit(q)
        eng.run_until_drained()
        return reqs[2].output

    wide, narrow = run(3, 5), run(2, 1)
    assert len(wide) == 8 and wide == narrow
    greedy, _ = _serve(pt, [r], max_new=8, batch_slots=1, max_seq=40,
                       mode=mode, steps_per_sync=2)
    assert wide != greedy[0]


def test_greedy_tie_break_lowest_index():
    logits = np.array([[0.1, 5.0, -1.0, 2.0],
                       [1.0, 5.0, 5.0, 0.0],      # exact tie
                       [7.0, 7.0, 7.0, 7.0]], np.float32)
    want = jax_sample_batch(jnp.asarray(logits),
                            jax.vmap(jax.random.PRNGKey)(jnp.arange(3)),
                            jnp.zeros(3), jnp.zeros(3, jnp.int32))
    keys = torch.arange(3, dtype=torch.int64)
    got = sample_batch(torch.from_numpy(logits), keys, torch.zeros_like(keys),
                       torch.zeros(3), torch.zeros(3, dtype=torch.int32),
                       vocab_hash(4, "cpu"))
    assert got.tolist() == [1, 1, 0] == want.tolist()
    assert _greedy(torch.from_numpy(logits)).dtype == torch.int32
    for c in range(20):
        t = int(sample_batch(torch.from_numpy(logits[:1]), keys[:1],
                             torch.full((1,), c), torch.ones(1),
                             torch.full((1,), 2, dtype=torch.int32),
                             vocab_hash(4, "cpu"))[0])
        assert t in (1, 3)
    distinct = torch.tensor([[0.1, 5.0, -1.0, 2.0], [3.0, 1.0, 0.0, 2.0]])
    topk1 = sample_batch(distinct, keys[:2], torch.zeros_like(keys[:2]),
                         torch.full((2,), 5.0), torch.ones(2, dtype=torch.int32),
                         vocab_hash(4, "cpu"))
    assert topk1.tolist() == [1, 0]


def test_engine_refuses_params_on_another_device(weights):
    _, _, pt = weights
    meta = {k: v for k, v in pt.items()}
    meta["embed"] = pt["embed"].to("meta")
    with pytest.raises(ValueError, match="params live on"):
        DecodeEngine(reduced_config("smollm-360m"), meta, device="cpu")
    with pytest.raises(ValueError, match="kv_layout"):
        DecodeEngine(reduced_config("smollm-360m"), pt, kv_layout="ragged",
                     device="cpu")
