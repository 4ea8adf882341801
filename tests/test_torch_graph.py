"""The fused decode loop that the port captures as a CUDA graph on the card,
run eagerly on the CPU: its device buffers, its counter-based draws, and
its tokens against host mode and the JAX engine.

Reduced smollm-360m (dense and paged KV, fp32 weights with the config's
bf16 KV cache, as the JAX engine tests run it) and reduced mamba2-130m
(fp32), weights from the JAX initialiser carried across with the weight
bridge.  Greedy tokens must agree exactly.  The draw's frequencies over
20,000 counters must lie within 0.015 of softmax(logits / T): the
binomial standard deviation there is at most 0.0035, so the bound is
about 4 of them.
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
from repro_torch.configs import reduced_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.engine import DecodeEngine, Request, request_key
from repro_torch.serve.sampler import hash_bits, sample_batch, vocab_hash

M32 = 0xFFFFFFFF
DRAWS = 20_000
FREQ_TOL = 0.015


def _mix32(x: int) -> int:
    """The sampler's mixing function on Python integers (no overflow)."""
    x ^= x >> 16
    x = (x * 0x7FEB352D) & M32
    x ^= x >> 15
    x = (x * 0x1B873593) & M32
    return x ^ (x >> 16)


def _hash(key: int, counter: int, v: int) -> int:
    return _mix32(_mix32(key ^ _mix32(counter & M32)) ^ _mix32(v))


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ("smollm-360m", "mamba2-130m"):
        cfg = jax_reduced_config(arch)
        if arch == "mamba2-130m":
            cfg = cfg.replace(dtype="float32")
        pj = cast_tree(init_params(jlm.make_lm(cfg), jax.random.PRNGKey(0)),
                       jnp.float32)
        leaves = jax.tree_util.tree_flatten_with_path(pj)[0]
        pt = params_from_numpy({_path_str(p): np.asarray(x)
                                for p, x in leaves}, device="cpu")
        tcfg = reduced_config(arch)
        if arch == "mamba2-130m":
            tcfg = tcfg.replace(dtype="float32")
        out[arch] = (cfg, tcfg, pj, pt)
    return out


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, n).astype(np.int32) for n in lens]


def _serve(cfg, pt, prompts, max_new=6, temperature=0.0, **kw):
    eng = DecodeEngine(cfg, pt, device="cpu", **kw)
    reqs = [Request(prompt=p, max_new_tokens=max_new, temperature=temperature)
            for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done and not r.failed for r in reqs)
    return [list(r.output) for r in reqs], eng


# ---------------------------------------------------------------------------
# the counter-based draw
# ---------------------------------------------------------------------------
def test_hash_bits_are_pinned_and_fit_int64():
    """The bits for fixed (key, counter) pairs, the extremes included,
    equal the same hash on Python integers, which cannot overflow."""
    keys = torch.tensor([0x12345678, M32, 0], dtype=torch.int64)
    counters = torch.tensor([7, 2**31 - 1, 0], dtype=torch.int64)
    got = hash_bits(keys, counters, vocab_hash(8, "cpu")).tolist()
    assert got[0] == [76827266, 3007166522, 905529953, 3595942531,
                      1109161797, 1939715852, 715631060, 369687695]
    assert got == [[_hash(int(k), int(c), v) for v in range(8)]
                   for k, c in zip(keys, counters, strict=True)]
    big = hash_bits(torch.full((4,), M32, dtype=torch.int64),
                    torch.arange(4, dtype=torch.int64),
                    vocab_hash(50_000, "cpu"))
    assert int(big.min()) >= 0 and int(big.max()) <= M32


def _freqs(logits, temperature, top_k, key=request_key(0, 3)):
    V = logits.shape[0]
    keys = torch.full((DRAWS,), key, dtype=torch.int64)
    counters = torch.arange(DRAWS, dtype=torch.int64)
    toks = sample_batch(logits.expand(DRAWS, V), keys, counters,
                        torch.full((DRAWS,), temperature),
                        torch.full((DRAWS,), top_k, dtype=torch.int32),
                        vocab_hash(V, "cpu"))
    return torch.bincount(toks.long(), minlength=V).double() / DRAWS


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_hash_draw_frequencies_follow_softmax(temperature):
    logits = torch.tensor([1.0, 0.2, -0.5, 2.0, 0.0, -1.5])
    want = torch.softmax(logits.double() / temperature, dim=0)
    got = _freqs(logits, temperature, 0)
    assert (got - want).abs().max() < FREQ_TOL, (got, want)


def test_hash_draw_respects_top_k():
    logits = torch.tensor([1.0, 0.2, -0.5, 2.0, 0.0, -1.5])
    got = _freqs(logits, 1.0, 2)
    top = torch.tensor([0, 3])
    want = torch.zeros(6, dtype=torch.float64)
    want[top] = torch.softmax(logits[top].double(), dim=0)
    assert got[[1, 2, 4, 5]].sum() == 0
    assert (got - want).abs().max() < FREQ_TOL, (got, want)


def test_greedy_slots_ignore_the_noise():
    logits = torch.randn(5, 40, generator=torch.Generator().manual_seed(1))
    keys = torch.arange(5, dtype=torch.int64) * 977
    for c in range(20):
        toks = sample_batch(logits, keys, torch.full((5,), c), torch.zeros(5),
                            torch.zeros(5, dtype=torch.int32),
                            vocab_hash(40, "cpu"))
        assert toks.tolist() == logits.argmax(-1).tolist()


# ---------------------------------------------------------------------------
# the engine's buffers and counters
# ---------------------------------------------------------------------------
def _buffers(eng) -> dict:
    bufs = {"slots": eng._slots.dev, "temp": eng._temp.dev,
            "keys": eng._keys.dev, "prompts": eng._prompts.dev,
            "out": eng._out}
    if eng._table is not None:
        bufs["table"] = eng._table.dev
    return {name: t.data_ptr() for name, t in bufs.items()}


def test_buffers_keep_their_address_through_preemption(models):
    """A 6-page pool of 8 rows that must preempt: every device buffer the
    fused loop reads keeps its address through admissions, retirements and
    preemptions, and the tokens equal the dense layout's."""
    _, cfg, _, pt = models["smollm-360m"]
    prompts = _prompts(7, (6, 13, 9, 11, 7, 12, 8, 10))
    kw = dict(batch_slots=4, max_seq=40, steps_per_sync=4, prefill_chunk=4)
    eng = DecodeEngine(cfg, pt, device="cpu", kv_layout="paged", page_size=8,
                       num_pages=6, **kw)
    reqs = [Request(prompt=p, max_new_tokens=12) for p in prompts]
    for r in reqs:
        eng.submit(r)
    ptrs = _buffers(eng)
    while eng.queue or any(r is not None for r in eng.slot_req):
        eng.step()
        assert _buffers(eng) == ptrs
        if not eng._pt_stale:
            assert torch.equal(eng._table.dev,
                               torch.from_numpy(eng.pool.table))
    assert eng.stats["preemptions"] >= 1 and eng.stats["admissions"] > 8
    assert eng.pool.used_pages == 0
    # the fused loop's keys, then the chunked prefill's and the host step's
    zero = {"captures": 0, "capture_ms": 0.0, "replays": 0,
            "graph_pool_bytes": 0}
    assert eng.graph_stats() == {f"{pre}{k}": v
                                 for pre in ("", "prefill_", "host_step_")
                                 for k, v in zero.items()}
    dense, _ = _serve(cfg, pt, prompts, max_new=12, **kw)
    assert [list(r.output) for r in reqs] == dense


def test_counter_advances_only_while_live(models):
    """A request still in chunked prefill at a sync's start draws nothing
    and keeps its counter at 0; a live one advances once per step."""
    _, cfg, _, pt = models["smollm-360m"]
    short, long_ = _prompts(5, (3, 17))
    eng = DecodeEngine(cfg, pt, device="cpu", batch_slots=2, max_seq=48,
                       steps_per_sync=4, prefill_chunk=4,
                       max_prefill_tokens_per_sync=4, rng_seed=3)
    eng.submit(Request(prompt=short, max_new_tokens=30, temperature=1.0))
    eng.submit(Request(prompt=long_, max_new_tokens=12, temperature=1.0))
    prefilling = 0
    while True:
        live0 = eng.counters[0]
        eng.step()
        assert eng.counters[0] == live0 + 4
        if eng.live[1]:
            break
        prefilling += 1
        assert eng.slot_req[1] is not None and eng.counters[1] == 0
    assert prefilling >= 2          # 16 prompt tokens, 4 a sync
    assert eng.keys[1] == request_key(3, 1) and eng.keys[0] == request_key(3, 0)
    c1 = eng.counters[1]
    eng.step()
    assert eng.counters[1] == c1 + 4


# ---------------------------------------------------------------------------
# the fused body against host mode and the JAX engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("path", ["dense", "paged", "mamba"])
def test_fused_body_matches_host_and_jax(models, path):
    arch = "mamba2-130m" if path == "mamba" else "smollm-360m"
    jcfg, cfg, pj, pt = models[arch]
    prompts = _prompts(11, (4, 14, 7, 19, 5))
    kw = dict(batch_slots=3, max_seq=48, steps_per_sync=4, prefill_chunk=4)
    if path == "paged":
        kw.update(kv_layout="paged", page_size=8)
    fused, eng = _serve(cfg, pt, prompts, max_new=7, mode="fused", **kw)
    host, _ = _serve(cfg, pt, prompts, max_new=7, mode="host", **kw)
    assert fused == host
    jeng = JaxEngine(jcfg, pj, mode="fused", **kw)
    jreqs = [JaxRequest(prompt=p, max_new_tokens=7) for p in prompts]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_drained()
    assert fused == [[int(t) for t in r.output] for r in jreqs]
    assert eng.steps == jeng.steps


@pytest.mark.parametrize("path", ["dense", "paged", "mamba"])
def test_sampled_host_equals_fused(models, path):
    """At temperature 1.0 host mode and the fused body draw the same
    tokens: the same keys and counters, advanced once per live step."""
    arch = "mamba2-130m" if path == "mamba" else "smollm-360m"
    _, cfg, _, pt = models[arch]
    prompts = _prompts(13, (4, 14, 7, 19, 5))
    kw = dict(batch_slots=3, max_seq=48, steps_per_sync=4, prefill_chunk=4,
              rng_seed=2)
    if path == "paged":
        kw.update(kv_layout="paged", page_size=8)
    fused, _ = _serve(cfg, pt, prompts, max_new=7, temperature=1.0,
                      mode="fused", **kw)
    host, _ = _serve(cfg, pt, prompts, max_new=7, temperature=1.0,
                     mode="host", **kw)
    greedy, _ = _serve(cfg, pt, prompts, max_new=7, mode="fused", **kw)
    assert fused == host
    assert fused != greedy
