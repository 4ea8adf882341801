"""The chunked prefill and host mode's decode step over their staged device
buffers, the two bodies besides the fused loop that the port captures as
CUDA graphs on the card, run eagerly on the CPU.

Against the JAX engine with the same weights (built by the JAX initialiser
in fp32 and carried across with the weight bridge): reduced smollm-360m
(dense and paged KV), mamba2-130m, jamba-v0.1-52b, olmoe-1b-7b and
musicgen-medium, with the MoE configs at a capacity factor that drops no
assignment (host and fused mode then agree in both engines).  Greedy
tokens must agree exactly.  At temperature 1.0 the JAX engine's draws
(``jax.random``) cannot be reproduced, so there the port is held to the
JAX engine's greedy tokens with top-k 1 (one token survives the cut, the
draw takes it), and host mode to the fused loop without top-k.

The warm-up a capture runs first (every slot inactive) must leave the cache
bit for bit as it was; the paged pools' sink page, which inactive rows
write and no read reaches, is left out.  A body that read a tensor back to
the host could not be captured: the bodies are run under a dispatch mode
that records every such op.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# one intra-op thread a process: pytest-xdist's workers share the host's
# cores, and each would otherwise start a pool as wide as the host
torch.set_num_threads(1)

from repro.configs import reduced_config as jax_reduced_config
from repro.models import lm as jlm
from repro.models.params import _path_str, cast_tree, init_params
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import reduced_config
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.params import tree_leaves
from repro_torch.serve.engine import DecodeEngine, Request

ARCHS = {"dense": "smollm-360m", "paged": "smollm-360m",
         "mamba": "mamba2-130m", "jamba": "jamba-v0.1-52b",
         "olmoe": "olmoe-1b-7b", "musicgen": "musicgen-medium",
         "mla": "deepseek-v3-671b"}
# 3 slots, chunks of 4 tokens: the prompts below take 0-4 chunks each
ENGINE_KW = dict(batch_slots=3, max_seq=48, steps_per_sync=4,
                 prefill_chunk=4)
PROMPT_LENS = (4, 14, 7, 19, 5, 11)
MAX_NEW = 6
PAGED = dict(kv_layout="paged", page_size=8)
# ops whose result the host must read before it can go on: none may run
# in a body the card captures
HOST_READS = ("_local_scalar_dense", "nonzero", "masked_select",
              "repeat_interleave", "unique")


def _cfgs(arch: str):
    """(JAX cfg, port cfg): the reduced config in fp32; an MoE at a
    capacity factor that drops no assignment."""
    jcfg = jax_reduced_config(arch)
    kw: dict = {"dtype": "float32"}
    if jcfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            jcfg.moe, capacity_factor=jcfg.moe.num_experts / jcfg.moe.top_k)
    return jcfg.replace(**kw), reduced_config(arch).replace(**kw)


@pytest.fixture(scope="module")
def weights():
    """arch -> (JAX cfg, port cfg, JAX params, port params), built once."""
    made: dict = {}

    def get(arch: str):
        if arch not in made:
            jcfg, tcfg = _cfgs(arch)
            pj = cast_tree(init_params(jlm.make_lm(jcfg),
                                       jax.random.PRNGKey(3)), jnp.float32)
            leaves = jax.tree_util.tree_flatten_with_path(pj)[0]
            pt = params_from_numpy({_path_str(p): np.asarray(x)
                                    for p, x in leaves}, device="cpu")
            made[arch] = (jcfg, tcfg, pj, pt)
        return made[arch]
    return get


def _prompts(cfg, seed: int = 7, lens=PROMPT_LENS):
    rng = np.random.default_rng(seed)
    tail = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    return [rng.integers(1, cfg.vocab_size, (n, *tail)).astype(np.int32)
            for n in lens]


def _tokens(reqs) -> list:
    """Each request's tokens as lists (a codebook token is a (cb,) list)."""
    return [[np.asarray(t).tolist() for t in r.output] for r in reqs]


def _jax_serve(jcfg, pj, prompts, **kw):
    eng = JaxEngine(jcfg, pj, **kw)
    reqs = [JaxRequest(prompt=p, max_new_tokens=MAX_NEW) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return _tokens(reqs)


def _serve(cfg, pt, prompts, temperature=0.0, top_k=0, **kw):
    """The port's tokens, the engine, and each prefill pump's count of
    active slots (read from the staged mask as the pump runs)."""
    eng = DecodeEngine(cfg, pt, device="cpu", rng_seed=5, **kw)
    pumps: list = []
    run = eng._run_prefill

    def counted():
        pumps.append(int(eng._pf_active.dev.sum()))
        run()
    eng._run_prefill = counted
    reqs = [Request(prompt=p, max_new_tokens=MAX_NEW,
                    temperature=temperature, top_k=top_k) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done and not r.failed and len(r.output) == MAX_NEW
               for r in reqs)
    return _tokens(reqs), eng, pumps


@pytest.mark.parametrize("case", ["dense", "paged", "mamba", "jamba",
                                  "olmoe", "musicgen", "dense_budget",
                                  "paged_small_pool"])
def test_staged_prefill_tokens_match_jax_engine(weights, case):
    """More requests than slots, prompts of up to five chunks through the
    staged prefill and forced decode: fused and host mode give the JAX
    fused engine's greedy tokens, and the fused loop at temperature 1.0
    with top-k 1 too; at temperature 1.0 host mode draws the fused loop's
    tokens, which are not the greedy ones.  ``dense_budget``:
    ``max_prefill_tokens_per_sync`` 4 lets one slot's chunk through a pump;
    ``paged_small_pool``: four pages of 8 rows, the least that backs
    max_seq 32, which must preempt (a preempted prompt's chunks run
    again; host and fused mode preempt at different steps, and a
    re-admitted request draws a fresh stream, so there the sampled tokens
    of the two modes are not compared)."""
    path = case.split("_")[0]
    jcfg, tcfg, pj, pt = weights(ARCHS[path])
    kw = dict(ENGINE_KW)
    if path == "paged":
        kw.update(PAGED)
    if case == "dense_budget":
        kw["max_prefill_tokens_per_sync"] = 4
    if case == "paged_small_pool":
        kw.update(max_seq=32, num_pages=4)
    prompts = _prompts(tcfg)
    want = _jax_serve(jcfg, pj, prompts, mode="fused", **kw)
    chunks = sum((n - 1) // 4 for n in PROMPT_LENS)
    hot = {}
    for mode in ("fused", "host"):
        got, eng, pumps = _serve(tcfg, pt, prompts, mode=mode, **kw)
        assert got == want, mode
        if case == "paged_small_pool":
            assert eng.stats["preemptions"] >= 1 and sum(pumps) > chunks
        else:
            assert sum(pumps) == chunks
        if case == "dense_budget":
            assert pumps == [1] * chunks
        else:
            assert max(pumps) > 1
        if eng.pool is not None:
            assert eng.pool.used_pages == 0
        hot[mode], _, _ = _serve(tcfg, pt, prompts, mode=mode,
                                 temperature=1.0, **kw)
    top1, _, _ = _serve(tcfg, pt, prompts, mode="fused", temperature=1.0,
                        top_k=1, **kw)
    assert top1 == want
    if case != "paged_small_pool":
        assert hot["host"] == hot["fused"]
    assert hot["fused"] != want


@pytest.mark.parametrize("path", ["dense", "paged", "mamba"])
def test_host_mode_matches_jax_host_mode(weights, path):
    """Host mode through the staged step gives the JAX engine's host-mode
    greedy tokens and step count."""
    jcfg, tcfg, pj, pt = weights(ARCHS[path])
    kw = dict(ENGINE_KW, mode="host", **(PAGED if path == "paged" else {}))
    prompts = _prompts(tcfg, seed=8)
    jeng = JaxEngine(jcfg, pj, **kw)
    jreqs = [JaxRequest(prompt=p, max_new_tokens=MAX_NEW) for p in prompts]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_drained()
    got, eng, _ = _serve(tcfg, pt, prompts, **kw)
    assert got == _tokens(jreqs)
    assert eng.steps == jeng.steps


def _own_engine(path: str, mode: str):
    """A host- or fused-mode engine of the reduced config (its own dtypes)
    with random weights from a seed, and prompts of 2-5 chunks."""
    cfg = reduced_config(ARCHS[path])
    params = lm.init_lm(cfg, torch.Generator().manual_seed(1), "cpu")
    eng = DecodeEngine(cfg, params, device="cpu", mode=mode,
                       **dict(ENGINE_KW, **(PAGED if path == "paged" else {})))
    for p in _prompts(cfg, seed=9, lens=(9, 18, 13)):
        eng.submit(Request(prompt=p, max_new_tokens=MAX_NEW))
    return eng


def _cache_view(eng) -> list:
    """Clones of every cache leaf, a pool leaf without its sink page."""
    pools = {id(leaf): ax for leaf, ax in eng._pool_leaves}
    out = []
    for leaf in tree_leaves(eng.cache):
        ax = pools.get(id(leaf))
        if ax is not None:
            leaf = leaf.narrow(ax, 0, leaf.shape[ax] - 1)
        out.append(leaf.clone())
    return out


@pytest.mark.parametrize("path", ["dense", "paged", "mamba", "jamba", "mla"])
def test_warm_up_with_every_slot_inactive_leaves_the_cache(path):
    """A capture's warm-up: the chunk and the host step with every slot
    inactive, over chunk tokens and starts that would write rows, leave
    every cache leaf (KV stripes or pages, SSM and conv states) bit for
    bit as two real pumps and steps left it."""
    eng = _own_engine(path, "host")
    for _ in range(3):
        eng.step()
    before = _cache_view(eng)
    assert any(bool(t.float().abs().sum()) for t in before)
    B, C = eng.B, eng.prefill_chunk
    rng = np.random.default_rng(2)
    tokens = rng.integers(1, eng.cfg.vocab_size,
                          (B, C, *eng.cb_tail)).astype(np.int32)
    eng._push((eng._pf_tokens, tokens),
              (eng._pf_start, np.array([0, 4, 8], np.int32)),
              (eng._pf_active, np.zeros(B, bool)))
    eng._prefill_body()
    eng._push((eng._st_tokens, tokens[:, :1]),
              (eng._st_pos, np.array([3, 9, 16], np.int32)),
              (eng._st_live, np.zeros(B, bool)))
    eng._host_step_body()
    for got, want in zip(_cache_view(eng), before, strict=True):
        assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["fused", "host"])
def test_staged_buffers_keep_their_addresses(weights, mode):
    """Through admissions, pumps, retirements and preemptions (a 6-page
    pool of 8 rows) every staged buffer of the chunk and of the host step,
    device side and host staging, and the logits buffer keep their
    addresses, and the tokens equal the dense layout's."""
    _, cfg, _, pt = weights("smollm-360m")
    prompts = _prompts(cfg, seed=10, lens=(6, 13, 9, 11, 7, 12, 8, 10))
    kw = dict(ENGINE_KW, max_seq=40, mode=mode)
    eng = DecodeEngine(cfg, pt, device="cpu", num_pages=6, **PAGED, **kw)
    staged = [eng._pf_tokens, eng._pf_start, eng._pf_active]
    fixed = []
    if mode == "host":
        staged += [eng._st_tokens, eng._st_pos, eng._st_live]
        fixed.append(eng._logits)
    else:
        assert eng._st_tokens is None and eng._logits is None

    def ptrs():
        return ([(s.dev.data_ptr(), s.host.data_ptr()) for s in staged]
                + [t.data_ptr() for t in fixed])
    reqs = [Request(prompt=p, max_new_tokens=12) for p in prompts]
    for r in reqs:
        eng.submit(r)
    want = ptrs()
    while eng.queue or any(r is not None for r in eng.slot_req):
        eng.step()
        assert ptrs() == want
    assert eng.stats["preemptions"] >= 1
    dense = DecodeEngine(cfg, pt, device="cpu", **kw)
    dreqs = [Request(prompt=p, max_new_tokens=12) for p in prompts]
    for r in dreqs:
        dense.submit(r)
    dense.run_until_drained()
    assert _tokens(reqs) == _tokens(dreqs)


class _HostReads(TorchDispatchMode):
    """Records every op of ``HOST_READS`` dispatched under it."""

    def __init__(self):
        super().__init__()
        self.seen: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name.startswith(HOST_READS):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("path", ["dense", "paged", "mamba", "jamba",
                                  "olmoe", "musicgen", "mla"])
def test_bodies_read_nothing_back_to_the_host(path):
    """The chunk's body and the host step's run no op whose result the
    host must read (``.item()``, ``nonzero``, boolean-mask indexing, ...),
    so the card can capture them; the engine's own pump and step around
    them do."""
    eng = _own_engine(path, "host")
    eng._admit()
    eng._pump_prefill()                # pushes a real chunk
    eng._pump_prefill()
    with _HostReads() as reads:
        eng._prefill_body()
    eng._host_step()                   # pushes a real step
    with _HostReads() as step_reads:
        eng._host_step_body()
    assert reads.seen == [] and step_reads.seen == []
