"""The port's paged KV layout against the JAX package's, on the CPU.

Covers the copied page allocator, the paged decode oracle (the plain
version of the CUDA kernel, held against the JAX oracle and the Pallas
kernel in interpret mode), the paged row writes, the model entry points
with a page table, and the paged ``DecodeEngine``.  Inputs come from numpy
seeds; weights from the JAX initialiser, carried across with the weight
bridge.

Tolerances: attention 2e-5 fp32 and 5e-2 bf16, the JAX package's own
(``tests/test_decode_attention.py``); model entry points 1e-4 fp32, as in
``tests/test_torch_model.py`` (32-bit sums taken in another order through
several layers); greedy tokens exactly.
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
from repro.kernels.decode_attention import \
    decode_attention_paged as jax_paged_kernel
from repro.kernels.ref import decode_attention_paged_ref as jax_paged_ref
from repro.models import lm as jlm
from repro.models.attention import paged_write_rows as jax_paged_write_rows
from repro.models.params import _path_str, cast_tree, init_params
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro.serve.kv_pool import KVPool as JaxKVPool
from repro.serve.kv_pool import PoolExhausted as JaxPoolExhausted
from repro_torch.configs import reduced_config
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_paged
from repro_torch.models import lm
from repro_torch.models.attention import paged_write_rows
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.engine import DecodeEngine, Request
from repro_torch.serve.kv_pool import KVPool, PoolExhausted

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(arr: np.ndarray, dtype: str = "float32"):
    return jnp.asarray(arr).astype(dtype), torch.from_numpy(arr).to(
        TORCH_DT[dtype])


# ---------------------------------------------------------------------------
# the allocator: the cases of tests/test_kv_pool.py, run on both copies
# ---------------------------------------------------------------------------
def _pool_case(name, Pool, Exhausted) -> list:
    """Run one scenario; return everything it observed."""
    seen = []

    def obs(pool):
        seen.append((pool.used_pages, pool.free_pages, pool.table.tolist(),
                     pool.stats()))

    if name == "geometry":
        pool = Pool(num_pages=8, page_size=4, slots=2, max_seq=16)
        seen.append(pool.width)
        obs(pool)
    elif name == "width_rounds_up":
        seen.append(Pool(num_pages=10, page_size=6, slots=1, max_seq=16).width)
    elif name == "lazy_idempotent":
        pool = Pool(num_pages=8, page_size=4, slots=2, max_seq=16)
        for slot, pos in ((0, 5), (0, 5), (0, 6), (0, 8), (1, 0)):
            seen.append((pool.alloc(slot, pos), pool.needed(slot, pos),
                         pool.footprint(slot)))
        obs(pool)
    elif name == "pages_for_can_admit":
        pool = Pool(num_pages=4, page_size=4, slots=4, max_seq=16)
        seen.append([pool.pages_for(n) for n in (0, 1, 4, 5, 16)])
        seen.append(pool.can_admit(16))
        pool.alloc(0, 11)
        seen.append((pool.can_admit(4), pool.can_admit(5)))
    elif name == "exhaustion_rolls_back":
        pool = Pool(num_pages=3, page_size=4, slots=2, max_seq=16)
        pool.alloc(0, 7)
        with pytest.raises(Exhausted):
            pool.alloc(1, 7)
        obs(pool)
        seen.append((pool.footprint(1), pool.alloc(1, 3)))
    elif name == "free_slot":
        pool = Pool(num_pages=8, page_size=4, slots=2, max_seq=16)
        pool.alloc(0, 10)
        pool.alloc(1, 2)
        seen.append((pool.free_slot(0), pool.free_slot(0)))
        obs(pool)
    elif name == "freed_pages_reused":
        pool = Pool(num_pages=2, page_size=4, slots=2, max_seq=8)
        a = pool.alloc(0, 7)
        pool.free_slot(0)
        seen.append((a, pool.alloc(1, 7)))
    elif name == "stats_high_water":
        pool = Pool(num_pages=8, page_size=4, slots=2, max_seq=16)
        pool.alloc(0, 11)
        pool.free_slot(0)
        pool.alloc(1, 3)
        obs(pool)
    return seen


@pytest.mark.parametrize("case", [
    "geometry", "width_rounds_up", "lazy_idempotent", "pages_for_can_admit",
    "exhaustion_rolls_back", "free_slot", "freed_pages_reused",
    "stats_high_water"])
def test_kv_pool_matches_jax(case):
    got = _pool_case(case, KVPool, PoolExhausted)
    want = _pool_case(case, JaxKVPool, JaxPoolExhausted)
    assert got and got == want


# ---------------------------------------------------------------------------
# the paged decode oracle (the CUDA kernel's plain version)
# ---------------------------------------------------------------------------
def _paged_inputs(seed, B, W, ps, H, K, D, num_pages, dtype="float32"):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D), np.float32)
    kp = rng.standard_normal((num_pages, ps, K, D), np.float32)
    vp = rng.standard_normal((num_pages, ps, K, D), np.float32)
    table = rng.permutation(num_pages)[:B * W].reshape(B, W).astype(np.int32)
    return _pair(q, dtype), _pair(kp, dtype), _pair(vp, dtype), table


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,K", [(4, 4), (8, 2), (6, 2)])    # G = 1, 4, 3
def test_paged_matches_jax_ref_and_pallas(H, K, dtype):
    """Shuffled table, one full slot and one with a partial last page."""
    B, W, ps, D = 2, 4, 8, 32
    (qj, qt), (kj, kt), (vj, vt), table = _paged_inputs(H + K, B, W, ps, H, K,
                                                        D, 16, dtype)
    lens = np.array([W * ps, 11], np.int32)
    got = decode_attention_paged(qt, kt, vt, torch.from_numpy(table),
                                 torch.from_numpy(lens))
    ref = jax_paged_ref(qj, kj, vj, jnp.asarray(table), jnp.asarray(lens))
    pallas = jax_paged_kernel(qj, kj, vj, jnp.asarray(table),
                              jnp.asarray(lens), interpret=True)
    assert got.shape == (B, H, D) and got.dtype == TORCH_DT[dtype]
    np.testing.assert_allclose(_np(got), _np(ref), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])


@pytest.mark.parametrize("ps", [4, 7])
def test_paged_sentinel_entries_are_clamped(ps):
    """Unmapped entries hold the sentinel num_pages; they sit past kv_len
    and are clamped, never NaN-filled (a page size of 7 divides nothing)."""
    B, W, H, K, D, P = 2, 4, 4, 2, 16, 8
    (qj, qt), (kj, kt), (vj, vt), table = _paged_inputs(3, B, W, ps, H, K, D,
                                                        P)
    table[0, 1:] = P
    table[1, 2:] = P
    lens = np.array([ps - 1, ps + 2], np.int32)
    got = ops.decode_attention_paged(qt, kt, vt, torch.from_numpy(table),
                                     torch.from_numpy(lens))
    ref = jax_paged_ref(qj, kj, vj, jnp.asarray(table), jnp.asarray(lens))
    pallas = jax_paged_kernel(qj, kj, vj, jnp.asarray(table),
                              jnp.asarray(lens), interpret=True)
    assert np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), _np(ref), **TOL["float32"])
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL["float32"])


def test_paged_poisoned_tail_is_never_attended():
    """Every row past kv_len (the tail of the last page and whole unread
    pages) poisoned to +-1e4: the output stays bit-identical."""
    B, W, ps, H, K, D, P = 2, 4, 8, 4, 2, 16, 16
    (qj, qt), (kj, kt), (vj, vt), table = _paged_inputs(2, B, W, ps, H, K, D,
                                                        P)
    lens = np.array([5, 13], np.int32)
    base = decode_attention_paged(qt, kt, vt, torch.from_numpy(table),
                                  torch.from_numpy(lens))
    kp, vp = kt.clone(), vt.clone()
    for b in range(B):
        for j in range(W):
            live = max(0, min(ps, int(lens[b]) - j * ps))
            kp[table[b, j], live:] = 1e4
            vp[table[b, j], live:] = -1e4
    got = decode_attention_paged(qt, kp, vp, torch.from_numpy(table),
                                 torch.from_numpy(lens))
    assert torch.equal(got, base)
    ref = jax_paged_ref(qj, kj, vj, jnp.asarray(table), jnp.asarray(lens))
    np.testing.assert_allclose(_np(got), _np(ref), **TOL["float32"])


# ---------------------------------------------------------------------------
# paged row writes: the trap of inactive slots
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunked", [False, True])
def test_paged_write_rows_matches_jax(chunked):
    """Slot 0 writes; slot 1 is inactive with an all-sentinel table; slot 2
    is inactive with a stale table naming slot 0's pages at the very rows
    slot 0 writes.  Only slot 0's rows may land, and the sentinel pages
    are never written; the port's pool carries the sink page beyond the
    JAX pool's P pages and receives every dropped row."""
    P, ps, W, K, D = 8, 4, 3, 2, 8
    rng = np.random.default_rng(5)
    pool = rng.standard_normal((P, ps, K, D), np.float32)
    table = np.array([[5, 2, 7], [P, P, P], [5, 2, 7]], np.int32)
    active = np.array([True, False, False])
    if chunked:
        positions = np.array([[2, 3, 4, 5], [0, 1, 2, 3], [2, 3, 4, 5]],
                             np.int32)
    else:
        positions = np.array([6, 1, 6], np.int32)
    values = rng.standard_normal((*positions.shape, K, D), np.float32)
    want = jax_paged_write_rows(jnp.asarray(pool), jnp.asarray(table),
                                jnp.asarray(positions), jnp.asarray(values),
                                jnp.asarray(active))
    sink = np.zeros((1, ps, K, D), np.float32)
    got = torch.from_numpy(np.concatenate([pool, sink]))
    out = paged_write_rows(got, torch.from_numpy(table),
                           torch.from_numpy(positions),
                           torch.from_numpy(values), torch.from_numpy(active))
    assert out is got                                   # in place
    np.testing.assert_array_equal(got[:P].numpy(), np.asarray(want))
    flat = got[:P].reshape(P * ps, K, D).numpy()
    for c, p in enumerate(np.atleast_1d(positions[0])):
        np.testing.assert_array_equal(
            flat[table[0, p // ps] * ps + p % ps],
            values[0, c] if chunked else values[0])
    assert got[P, 1:].eq(0).all()           # only the sink's first row used
    assert got[P, 0].ne(0).any()


def test_positions_past_the_table_are_dropped():
    """A position at or past W*ps has no row: the port drops it, as the
    dense layout drops a position past max_seq.  The JAX package's
    ``paged_write_rows`` clips the logical page to W-1 instead and writes
    the position's ``pos % ps`` row of the slot's last page, a live row
    (ROADMAP Queue C); the engine never sends such a position."""
    P, ps, W, K, D = 4, 4, 2, 1, 8
    pool = np.zeros((P, ps, K, D), np.float32)
    table = np.array([[2, 0]], np.int32)
    positions = np.array([W * ps + 1], np.int32)           # one past the end
    values = np.ones((1, K, D), np.float32)
    jax_pool = np.asarray(jax_paged_write_rows(
        jnp.asarray(pool), jnp.asarray(table), jnp.asarray(positions),
        jnp.asarray(values)))
    assert jax_pool[0, 1].any()            # JAX overwrote row 5 = page 0, row 1
    got = torch.from_numpy(np.concatenate([pool, np.zeros((1, ps, K, D),
                                                          np.float32)]))
    paged_write_rows(got, torch.from_numpy(table), torch.from_numpy(positions),
                     torch.from_numpy(values))
    assert not got[:P].any() and got[P, 0].eq(1).all()    # to the sink only


# ---------------------------------------------------------------------------
# model entry points with a page table
# ---------------------------------------------------------------------------
def _flat(tree) -> dict:
    return {_path_str(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def fp32_model():
    cfg = jax_reduced_config("smollm-360m").replace(dtype="float32")
    pj = cast_tree(init_params(jlm.make_lm(cfg), jax.random.PRNGKey(0)),
                   jnp.float32)
    return cfg, pj, params_from_numpy(_flat(pj), device="cpu")


def test_prefill_chunk_then_decode_step_paged(fp32_model):
    """Two chunks per slot at different offsets through a shuffled table
    (slot 2 inactive for the second chunk, its unused pages unmapped), then
    a decode step with slot 1 inactive: logits and pool contents."""
    cfg, pj, pt = fp32_model
    B, C, P, ps = 3, 8, 20, 4
    W = 6                                       # max_seq 24
    table = np.random.default_rng(6).permutation(P)[:B * W].reshape(B, W)
    table = table.astype(np.int32)
    table[2, 4:] = P
    cache_j = init_params(jlm.make_cache(cfg, B, W * ps, paged=(P, ps)),
                          jax.random.PRNGKey(0))
    cache_t = lm.make_cache(cfg, B, W * ps, paged=(P, ps), device="cpu")
    assert cache_t[0]["k"].shape == (4, P + 1, ps, cfg.num_kv_heads,
                                     cfg.head_dim)
    rng = np.random.default_rng(4)
    for start, active in ((np.array([0, 4, 8]), np.array([True] * 3)),
                          (np.array([8, 12, 0]), np.array([True, True, False]))):
        tok = rng.integers(0, cfg.vocab_size, (B, C)).astype(np.int32)
        cache_j = jlm.prefill_chunk(cfg, pj, {
            "tokens": jnp.asarray(tok), "start": jnp.asarray(start, jnp.int32),
            "active": jnp.asarray(active), "page_table": jnp.asarray(table)},
            cache_j)
        out = lm.prefill_chunk(cfg, pt, {
            "tokens": torch.from_numpy(tok),
            "start": torch.from_numpy(start.astype(np.int32)),
            "active": torch.from_numpy(active),
            "page_table": torch.from_numpy(table)}, cache_t)
        assert out is cache_t
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache_t[0][name][:, :P]),
                                   _np(cache_j[0][name]), **MODEL_TOL)
    tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.array([16, 20, 15], np.int32)
    active = np.array([True, False, True])
    lj, cache_j = jlm.decode_step(cfg, pj, {
        "tokens": jnp.asarray(tok), "pos": jnp.asarray(pos),
        "active": jnp.asarray(active), "page_table": jnp.asarray(table)},
        cache_j)
    lt, _ = lm.decode_step(cfg, pt, {
        "tokens": torch.from_numpy(tok), "pos": torch.from_numpy(pos),
        "active": torch.from_numpy(active),
        "page_table": torch.from_numpy(table)}, cache_t)
    np.testing.assert_allclose(_np(lt[active]), _np(lj[active]), **MODEL_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache_t[0][name][:, :P]),
                                   _np(cache_j[0][name]), **MODEL_TOL)


# ---------------------------------------------------------------------------
# the paged engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engine_weights():
    """fp32 weights with the config's bf16 KV cache, as the JAX engine
    tests run it."""
    cfg = jax_reduced_config("smollm-360m")
    pj = cast_tree(init_params(jlm.make_lm(cfg), jax.random.PRNGKey(0)),
                   jnp.float32)
    return cfg, pj, params_from_numpy(_flat(pj), device="cpu")


def _work(seed, n, lo, hi, new):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 256, int(rng.integers(lo, hi))).astype(np.int32),
             new) for _ in range(n)]


def _run(pt, work, **kw):
    eng = DecodeEngine(reduced_config("smollm-360m"), pt, device="cpu", **kw)
    reqs = [Request(prompt=p, max_new_tokens=m) for p, m in work]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done and not r.failed for r in reqs)
    return [list(r.output) for r in reqs], eng


@pytest.mark.parametrize("mode,chunk", [("host", 0), ("fused", 0),
                                        ("host", 8), ("fused", 8)])
def test_paged_greedy_tokens_match_jax_engine(engine_weights, mode, chunk):
    cfg, pj, pt = engine_weights
    work = _work(0, 5, 3, 21, 6)
    kw = dict(batch_slots=2, max_seq=48, mode=mode, steps_per_sync=4,
              prefill_chunk=chunk, kv_layout="paged", page_size=8)
    jeng = JaxEngine(cfg, pj, **kw)
    jreqs = [JaxRequest(prompt=p, max_new_tokens=m) for p, m in work]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_drained()
    got, eng = _run(pt, work, **kw)
    assert got == [[int(t) for t in r.output] for r in jreqs]
    assert eng.steps == jeng.steps
    want_stats, stats = jeng.kv_stats(), eng.kv_stats()
    for key in ("num_pages", "page_size", "high_water", "total_allocs",
                "total_frees", "preemptions", "admit_cache_elems"):
        assert stats[key] == want_stats[key], key


@pytest.mark.parametrize("mode", ["host", "fused"])
def test_paged_equals_dense_non_dividing_page(engine_weights, mode):
    _, _, pt = engine_weights
    work = _work(4, 4, 2, 20, 6)
    kw = dict(batch_slots=2, max_seq=60, steps_per_sync=4, mode=mode,
              prefill_chunk=4)
    dense, _ = _run(pt, work, **kw)
    paged, eng = _run(pt, work, kv_layout="paged", page_size=7, **kw)
    assert dense == paged
    assert eng.pool.used_pages == 0 and eng.pool.width == 9


@pytest.mark.parametrize("mode", ["host", "fused"])
def test_paged_pool_exhaustion_preempts_and_completes(engine_weights, mode):
    """Six pages of eight rows cannot back two long slots at once: the
    youngest is preempted, yet every request completes exactly once with
    the dense layout's tokens and every page comes back."""
    _, _, pt = engine_weights
    work = _work(7, 8, 6, 14, 12)
    kw = dict(batch_slots=4, max_seq=40, steps_per_sync=4, mode=mode)
    dense, _ = _run(pt, work, **kw)
    paged, eng = _run(pt, work, kv_layout="paged", page_size=8, num_pages=6,
                      **kw)
    assert eng.stats["preemptions"] >= 1
    assert [len(o) for o in paged] == [m for _, m in work]
    assert dense == paged
    assert eng.pool.used_pages == 0
    stats = eng.kv_stats()
    assert stats["high_water"] <= 6 and stats["slot_footprint"] == [0] * 4


@pytest.mark.parametrize("mode", ["host", "fused"])
def test_prefill_pump_skips_a_slot_preempted_in_the_same_pump(engine_weights,
                                                              mode):
    """Four slots prefilling at once from a 13-page pool: an older slot's
    chunk preempts a younger one that is still later in the same pump's
    list.  The port skips it; the JAX engine goes on to allocate pages to
    the now empty slot, which it never frees (ROADMAP Queue C)."""
    cfg, pj, pt = engine_weights
    rng = np.random.default_rng(8)
    work = [(rng.integers(1, 256, n).astype(np.int32), m)
            for n, m in ((12, 7), (16, 6), (20, 5), (16, 8), (26, 8), (19, 5))]
    kw = dict(batch_slots=4, max_seq=48, kv_layout="paged", page_size=4,
              num_pages=13, prefill_chunk=8, steps_per_sync=4)
    got, eng = _run(pt, work, mode=mode, **kw)
    assert [len(o) for o in got] == [m for _, m in work]
    assert eng.stats["preemptions"] >= 1 and eng.pool.used_pages == 0
    dense, _ = _run(pt, work, mode=mode, batch_slots=4, max_seq=48,
                    prefill_chunk=8, steps_per_sync=4)
    assert got == dense
    if mode == "host":
        jeng = JaxEngine(cfg, pj, mode=mode, **kw)
        for p, m in work:
            jeng.submit(JaxRequest(prompt=p, max_new_tokens=m))
        jeng.run_until_drained()
        assert jeng.pool.used_pages > 0          # the reference leaks pages


def test_paged_engine_refuses_a_pool_too_small_and_bad_prompts(engine_weights):
    _, _, pt = engine_weights
    cfg = reduced_config("smollm-360m")
    with pytest.raises(ValueError, match="cannot back one full sequence"):
        DecodeEngine(cfg, pt, batch_slots=2, max_seq=40, kv_layout="paged",
                     page_size=8, num_pages=4, device="cpu")
    eng = DecodeEngine(cfg, pt, batch_slots=2, max_seq=16, kv_layout="paged",
                       page_size=8, device="cpu")
    assert eng.kv_stats()["num_pages"] == 4         # capacity parity: 2 x 2
    empty = Request(prompt=np.zeros((0,), np.int32))
    good = Request(prompt=np.array([3, 4, 5], np.int32), max_new_tokens=4)
    too_long = Request(prompt=np.ones((16,), np.int32))
    for r in (empty, good, too_long):
        eng.submit(r)
    eng.run_until_drained()
    assert empty.failed and too_long.failed and eng.stats["rejected"] == 2
    assert good.done and not good.failed and len(good.output) == 4
