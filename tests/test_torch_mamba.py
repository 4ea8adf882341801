"""The port's Mamba-2 path against the JAX package's, on the CPU.

Covers the SSD oracles (the chunked one is the plain version of the CUDA
``ssd_scan`` kernel, also held against the Pallas kernel in interpret
mode), the Mamba block's three entry points, ``lm.prefill`` of reduced
mamba2-130m (4 layers, d_model 128, 8 heads of P 32, N 16, chunk 32), and
``DecodeEngine`` serving it.  Inputs come from numpy seeds; weights from
the JAX initialiser, carried across with the weight bridge.

Tolerances:
* ref against JAX ref, same algorithm and chunk: 1e-5 fp32 (the same
  fp32 operations, summed in another order);
* chunked against sequential or Pallas, and two chained calls against one:
  2e-3 fp32 and 1e-1 bf16, the JAX package's own SSD bound
  (``tests/test_kernels.py``): the chunked form reassociates long sums of
  decayed terms;
* model entry points: 1e-4 fp32, as in ``tests/test_torch_model.py``;
* greedy tokens exactly.
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
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_kernel
from repro.models import lm as jlm
from repro.models import mamba as jmamba
from repro.models.params import _path_str, cast_tree, init_params
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import ref
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import lm, mamba
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.params import init_params as torch_init_params
from repro_torch.serve.engine import DecodeEngine, Request

REF_TOL = dict(atol=1e-5, rtol=1e-5)
SSD_TOL = {"float32": dict(atol=2e-3, rtol=2e-3),
           "bfloat16": dict(atol=1e-1, rtol=1e-1)}
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ssd_inputs(seed, B, S, H, P, G, N, dtype="float32", h0=False):
    """(jax tuple, torch tuple) of x, dt, A, Bm, Cm (+ h0)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N), np.float32)
    Cm = rng.standard_normal((B, S, G, N), np.float32)
    arrs = [x, dt, A, Bm, Cm]
    if h0:
        arrs.append(rng.standard_normal((B, H, P, N), np.float32))
    lowp = {0, 3, 4}                     # x, B, C in the working dtype
    j = tuple(jnp.asarray(a).astype(dtype if i in lowp else "float32")
              for i, a in enumerate(arrs))
    t = tuple(torch.from_numpy(a).to(TORCH_DT[dtype] if i in lowp
                                     else torch.float32)
              for i, a in enumerate(arrs))
    return j, t


# ---------------------------------------------------------------------------
# the SSD oracles
# ---------------------------------------------------------------------------
def test_segsum_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 9)).astype(np.float32)
    got = ref._segsum(torch.from_numpy(x))
    want = jref._segsum(jnp.asarray(x))
    np.testing.assert_allclose(_np(got), _np(want), **REF_TOL)


@pytest.mark.parametrize("S,chunk,G,h0", [
    (64, 16, 1, False), (64, 16, 2, True), (50, 16, 1, True),   # ragged S
    (7, 16, 1, False)])                                         # S < chunk
def test_ssd_chunked_ref_matches_jax(S, chunk, G, h0):
    (xj, dtj, Aj, Bj, Cj, *hj), (xt, dtt, At, Bt, Ct, *ht) = _ssd_inputs(
        S + G, 2, S, 4, 8, G, 16, h0=h0)
    yj, hTj = jref.ssd_chunked_ref(xj, dtj, Aj, Bj, Cj, chunk=chunk,
                                   h0=hj[0] if h0 else None,
                                   return_final_state=True)
    yt, hTt = ref.ssd_chunked_ref(xt, dtt, At, Bt, Ct, chunk=chunk,
                                  h0=ht[0] if h0 else None,
                                  return_final_state=True)
    assert yt.shape == (2, S, 4, 8) and hTt.shape == (2, 4, 8, 16)
    np.testing.assert_allclose(_np(yt), _np(yj), **REF_TOL)
    np.testing.assert_allclose(_np(hTt), _np(hTj), **REF_TOL)


@pytest.mark.parametrize("h0", [False, True])
def test_ssd_sequential_ref_matches_jax(h0):
    (xj, dtj, Aj, Bj, Cj, *hj), (xt, dtt, At, Bt, Ct, *ht) = _ssd_inputs(
        11, 2, 24, 4, 8, 2, 16, h0=h0)
    yj, hTj = jref.ssd_sequential_ref(xj, dtj, Aj, Bj, Cj,
                                      h0=hj[0] if h0 else None)
    yt, hTt = ref.ssd_sequential_ref(xt, dtt, At, Bt, Ct,
                                     h0=ht[0] if h0 else None)
    np.testing.assert_allclose(_np(yt), _np(yj), **REF_TOL)
    np.testing.assert_allclose(_np(hTt), _np(hTj), **REF_TOL)


def test_ssd_decode_step_ref_matches_jax():
    (xj, dtj, Aj, Bj, Cj, hj), (xt, dtt, At, Bt, Ct, ht) = _ssd_inputs(
        12, 3, 1, 4, 8, 2, 16, h0=True)
    yj, h1j = jref.ssd_decode_step_ref(xj[:, 0], dtj[:, 0], Aj, Bj[:, 0],
                                       Cj[:, 0], hj)
    yt, h1t = ref.ssd_decode_step_ref(xt[:, 0], dtt[:, 0], At, Bt[:, 0],
                                      Ct[:, 0], ht)
    np.testing.assert_allclose(_np(yt), _np(yj), **REF_TOL)
    np.testing.assert_allclose(_np(h1t), _np(h1j), **REF_TOL)


@pytest.mark.parametrize("S", [64, 50])
def test_ssd_chunked_equals_sequential_and_chains_through_h0(S):
    """The chunked form equals the definition, and two calls chained
    through h0 equal one call over the whole sequence."""
    _, (x, dt, A, Bm, Cm, h0) = _ssd_inputs(21, 2, S, 4, 8, 1, 16, h0=True)
    y, hT = ssd_scan(x, dt, A, Bm, Cm, chunk=16, h0=h0,
                     return_final_state=True)
    y_seq, hT_seq = ref.ssd_sequential_ref(x, dt, A, Bm, Cm, h0=h0)
    np.testing.assert_allclose(_np(y), _np(y_seq), **SSD_TOL["float32"])
    np.testing.assert_allclose(_np(hT), _np(hT_seq), **SSD_TOL["float32"])
    cut = 24
    y1, h1 = ssd_scan(x[:, :cut], dt[:, :cut], A, Bm[:, :cut], Cm[:, :cut],
                      chunk=16, h0=h0, return_final_state=True)
    y2, h2 = ssd_scan(x[:, cut:], dt[:, cut:], A, Bm[:, cut:], Cm[:, cut:],
                      chunk=16, h0=h1, return_final_state=True)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(y),
                               **SSD_TOL["float32"])
    np.testing.assert_allclose(_np(h2), _np(hT), **SSD_TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,h0", [(1, False), (2, True)])
def test_ssd_scan_plain_matches_pallas(G, h0, dtype):
    (xj, dtj, Aj, Bj, Cj, *hj), (xt, dtt, At, Bt, Ct, *ht) = _ssd_inputs(
        G, 2, 64, 4, 32, G, 16, dtype=dtype, h0=h0)
    got, hT = ssd_scan(xt, dtt, At, Bt, Ct, chunk=32,
                       h0=ht[0] if h0 else None, return_final_state=True)
    want, hTj = jax_ssd_kernel(xj, dtj, Aj, Bj, Cj, chunk=32,
                               h0=hj[0] if h0 else None,
                               return_final_state=True, interpret=True)
    assert got.dtype == TORCH_DT[dtype] and hT.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **SSD_TOL[dtype])
    np.testing.assert_allclose(_np(hT), _np(hTj), **SSD_TOL[dtype])


# ---------------------------------------------------------------------------
# the Mamba block and the model
# ---------------------------------------------------------------------------
def _flat(tree) -> dict:
    return {_path_str(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def fp32_model():
    cfg = jax_reduced_config("mamba2-130m").replace(dtype="float32")
    pj = cast_tree(init_params(jlm.make_lm(cfg), jax.random.PRNGKey(0)),
                   jnp.float32)
    # random A_log, D, dt_bias and conv bias, so no term is trivially 1 or 0
    rng = np.random.default_rng(9)
    flat = _flat(pj)
    for name, scale in (("A_log", 0.5), ("D", 1.0), ("dt_bias", 0.5),
                        ("conv_b", 0.1)):
        key = f"segments/0/mixer/{name}"
        flat[key] = (flat[key] + scale * rng.standard_normal(
            flat[key].shape)).astype(np.float32)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(pj)
    pj = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(flat[_path_str(p)]) for p, _ in leaves])
    return cfg, pj, params_from_numpy(flat, device="cpu")


def _layer0(pj, pt):
    return (jax.tree_util.tree_map(lambda a: a[0], pj["segments"][0]["mixer"]),
            {k: v[0] for k, v in pt["segments"][0]["mixer"].items()})


def test_config_is_a_copy_with_float32_leaves():
    assert dataclasses.asdict(get_config("mamba2-130m")) == \
        dataclasses.asdict(jax_get_config("mamba2-130m"))
    assert dataclasses.asdict(reduced_config("mamba2-130m")) == \
        dataclasses.asdict(jax_reduced_config("mamba2-130m"))
    full = get_config("mamba2-130m")
    assert (full.num_layers, full.d_model, full.ssm.d_state, full.ssm.chunk,
            full.ssm.n_heads(full.d_model), full.vocab_size,
            full.tie_embeddings) == (24, 768, 128, 256, 24, 50280, False)
    cfg = reduced_config("mamba2-130m")
    pj = init_params(jlm.make_lm(cfg), jax.random.PRNGKey(1))   # bf16 model
    pt = params_from_numpy(_flat(pj), device="cpu")
    mixer = pt["segments"][0]["mixer"]
    assert all(mixer[n].dtype == torch.float32
               for n in ("A_log", "D", "dt_bias"))
    assert mixer["in_proj"].dtype == torch.bfloat16


def test_apply_mamba_matches_jax(fp32_model):
    cfg, pj, pt = fp32_model
    mj, mt = _layer0(pj, pt)
    x = np.random.default_rng(1).standard_normal((2, 45, 128)) \
        .astype(np.float32) * 0.5
    yj, (cj, sj) = jmamba.apply_mamba(cfg, mj, jnp.asarray(x))
    yt, (ct, st) = mamba.apply_mamba(cfg, mt, torch.from_numpy(x))
    np.testing.assert_allclose(_np(yt), _np(yj), **MODEL_TOL)
    np.testing.assert_allclose(_np(ct), _np(cj), **MODEL_TOL)
    np.testing.assert_allclose(_np(st), _np(sj), **MODEL_TOL)


def test_apply_mamba_prefill_chunk_and_decode_match_jax(fp32_model):
    """Two chunks (slot 1 inactive for the second), then two decode steps
    (slot 0 inactive for the first): outputs and states, in place."""
    cfg, pj, pt = fp32_model
    mj, mt = _layer0(pj, pt)
    B = 2
    cache_j = init_params(jmamba.make_mamba_cache(cfg, B),
                          jax.random.PRNGKey(0))
    cache_t = torch_init_params(mamba.make_mamba_cache(cfg, B), None, "cpu")
    rng = np.random.default_rng(2)
    for C, active in ((16, [True, True]), (12, [True, False])):
        x = rng.standard_normal((B, C, 128)).astype(np.float32) * 0.5
        a = np.array(active)
        yj, cache_j = jmamba.apply_mamba_prefill_chunk(
            cfg, mj, jnp.asarray(x), cache_j, active=jnp.asarray(a))
        yt, out = mamba.apply_mamba_prefill_chunk(
            cfg, mt, torch.from_numpy(x), cache_t,
            active=torch.from_numpy(a))
        assert out is cache_t
        np.testing.assert_allclose(_np(yt[a]), _np(yj[a]), **MODEL_TOL)
    for active in ([False, True], [True, True]):
        x = rng.standard_normal((B, 1, 128)).astype(np.float32) * 0.5
        a = np.array(active)
        yj, cache_j = jmamba.apply_mamba_decode(
            cfg, mj, jnp.asarray(x), cache_j, active=jnp.asarray(a))
        yt, _ = mamba.apply_mamba_decode(cfg, mt, torch.from_numpy(x),
                                         cache_t, active=torch.from_numpy(a))
        np.testing.assert_allclose(_np(yt[a]), _np(yj[a]), **MODEL_TOL)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(_np(cache_t[name]), _np(cache_j[name]),
                                   **MODEL_TOL)


@pytest.mark.parametrize("S", [13, 80])       # 80 spans three 32-chunks
def test_prefill_logits_and_caches(fp32_model, S):
    cfg, pj, pt = fp32_model
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, S))
    lj, cj = jlm.prefill(cfg, pj, {"tokens": jnp.asarray(tokens, jnp.int32)})
    lt, ct = lm.prefill(cfg, pt, {"tokens": torch.from_numpy(tokens)})
    assert lt.shape == (2, cfg.vocab_size)
    np.testing.assert_allclose(_np(lt), _np(lj), **MODEL_TOL)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(_np(ct[0][name]), _np(cj[0][name]),
                                   **MODEL_TOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lens]


def _serve(cfg, pt, prompts, max_new=6, **kw):
    eng = DecodeEngine(cfg, pt, device="cpu", **kw)
    reqs = [Request(prompt=p, max_new_tokens=max_new) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done and not r.failed for r in reqs)
    return [list(r.output) for r in reqs], eng


@pytest.mark.parametrize("mode,chunk", [("host", 0), ("fused", 0),
                                        ("host", 8), ("fused", 8)])
def test_greedy_tokens_match_jax_engine(fp32_model, mode, chunk):
    """More requests than slots, so slots are reused; prompts longer than
    a chunk go through chunked prefill."""
    cfg, pj, pt = fp32_model
    prompts = _prompts(0, (5, 12, 3, 20, 9))
    kw = dict(batch_slots=2, max_seq=48, mode=mode, steps_per_sync=4,
              prefill_chunk=chunk)
    jeng = JaxEngine(cfg, pj, **kw)
    jreqs = [JaxRequest(prompt=p, max_new_tokens=6) for p in prompts]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_drained()
    got, eng = _serve(cfg, pt, prompts, **kw)
    assert got == [[int(t) for t in r.output] for r in jreqs]
    assert eng.steps == jeng.steps


def test_batched_equals_solo_on_reused_slots(fp32_model):
    """A request served in a slot that two earlier requests used (one
    slot, three requests) equals the same request served alone: the
    admission zeroes the slot's conv and SSM state."""
    cfg, _, pt = fp32_model
    a, b, r = _prompts(1, (7, 15, 10))
    kw = dict(max_seq=40, steps_per_sync=3, prefill_chunk=4)
    reused, eng = _serve(cfg, pt, [a, b, r], batch_slots=1, mode="fused", **kw)
    solo, _ = _serve(cfg, pt, [r], batch_slots=1, mode="fused", **kw)
    mixed, _ = _serve(cfg, pt, [b, r, a], batch_slots=2, mode="host", **kw)
    assert reused[2] == solo[0] == mixed[1]
    # three admissions, each zeroing one slot's rows of 4 layers' state
    per_slot = 4 * (3 * (256 + 2 * 16) + 8 * 32 * 16)
    assert eng.stats["admit_cache_elems"] == 3 * per_slot


@pytest.mark.parametrize("mode", ["host", "fused"])
def test_paged_equals_dense(fp32_model, mode):
    """The pure-SSM model has no pool leaves: the paged layout keeps its
    dense per-slot state and serves the same tokens."""
    cfg, _, pt = fp32_model
    prompts = _prompts(2, (6, 14, 3, 11))
    kw = dict(batch_slots=2, max_seq=40, steps_per_sync=4, mode=mode,
              prefill_chunk=4)
    dense, _ = _serve(cfg, pt, prompts, **kw)
    paged, eng = _serve(cfg, pt, prompts, kv_layout="paged", page_size=8,
                        **kw)
    assert dense == paged
    assert eng.pool.used_pages == 0 and eng._pool_leaves == []
