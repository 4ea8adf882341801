"""The port's modality stubs against the JAX package, on the CPU.

Reduced ``musicgen-medium`` (4 codebooks: tokens [B, S, 4], an embedding
table and a head per codebook, logits [B, 4, V]) and reduced
``phi-3-vision-4.2b`` (precomputed image embeds written over the token
embeddings at their positions), plus a narrow phi-3 variant at the
published head dim 96.  Checked: the parameter trees (paths, shapes,
logical axes) and the weight bridge, ``lm.prefill`` logits and caches with
and without image embeds, image positions past S dropped in both
packages, ``prefill_chunk`` then ``decode_step`` dense and paged with
[B, 1, 4] tokens, the engine's greedy tokens in fused and host mode,
dense and paged, against the JAX engine's, ``sample_batch`` on codebook
logits, the codebook hash, and the launcher.  Weights come from the JAX
initialiser in fp32, carried across with the weight bridge; model
tolerance 1e-4, tokens exactly.
"""
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
from repro.models.params import Param as JaxParam
from repro.models.params import _path_str, cast_tree, init_params
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro.serve.sampler import sample_batch as jax_sample_batch
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.params import Param
from repro_torch.serve.engine import DecodeEngine, Request
from repro_torch.serve.sampler import hash_bits, sample_batch, vocab_hash

MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
MUSIC, VISION = "musicgen-medium", "phi-3-vision-4.2b"


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _flat(tree) -> dict:
    return {_path_str(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_t(tree, prefix: str = "") -> dict:
    if isinstance(tree, torch.Tensor):
        return {prefix: _np(tree).copy()}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out: dict = {}
    for k, v in items:
        out.update(_flat_t(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _descr_jax(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JaxParam))[0]
    return {_path_str(p): (tuple(d.shape), tuple(d.logical))
            for p, d in leaves}


def _descr_port(tree, prefix: str = "") -> dict:
    if isinstance(tree, Param):
        return {prefix: (tuple(tree.shape), tuple(tree.logical))}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out: dict = {}
    for k, v in items:
        out.update(_descr_port(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _cfgs(arch: str, **kw):
    """(JAX cfg, port cfg): the reduced config in fp32, with ``kw``."""
    kw["dtype"] = "float32"
    return (jax_reduced_config(arch).replace(**kw),
            reduced_config(arch).replace(**kw))


def _weights(jcfg, seed: int):
    pj = cast_tree(init_params(jlm.make_lm(jcfg), jax.random.PRNGKey(seed)),
                   jnp.float32)
    return pj, params_from_numpy(_flat(pj), device="cpu")


@pytest.fixture(scope="module")
def music():
    jcfg, tcfg = _cfgs(MUSIC)
    return (jcfg, tcfg, *_weights(jcfg, 21))


@pytest.fixture(scope="module")
def vision():
    jcfg, tcfg = _cfgs(VISION)
    return (jcfg, tcfg, *_weights(jcfg, 22))


@pytest.fixture(scope="module")
def vision96():
    """phi-3 narrowed around the published head: 2 heads of 96."""
    jcfg, tcfg = _cfgs(VISION, num_heads=2, num_kv_heads=2, head_dim=96)
    return (jcfg, tcfg, *_weights(jcfg, 23))


def _image_batch(cfg, B, S, N, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    img = (rng.standard_normal((B, N, cfg.d_model)) * 0.5).astype(np.float32)
    pos = np.stack([rng.permutation(N + 2)[:N] for _ in range(B)])
    return {"tokens": tokens, "image_embeds": img,
            "image_positions": pos.astype(np.int32)}


def _both(batch: dict):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# descriptors and the bridge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [MUSIC, VISION])
def test_descriptor_trees_and_bridge(arch):
    """The parameter trees, reduced and published, have the JAX package's
    paths, shapes and logical axes (the codebook embedding [cb, V, d] and
    head [cb, d, V]); the bridge carries a bf16 tree across and back bit
    for bit, unchanged."""
    for jcfg, tcfg in ((jax_reduced_config(arch), reduced_config(arch)),
                       (jax_get_config(arch), get_config(arch))):
        assert _descr_port(lm.make_lm(tcfg)) == _descr_jax(jlm.make_lm(jcfg))
    tree = _descr_port(lm.make_lm(get_config(arch)))
    if arch == MUSIC:
        assert tree["embed"] == ((4, 2048, 1536),
                                 ("codebooks", "vocab", "embed"))
        assert tree["lm_head"] == ((4, 1536, 2048),
                                   ("codebooks", "embed", "vocab"))
    else:
        assert tree["embed"] == ((32064, 3072), ("vocab", "embed"))
    flat = _flat(init_params(jlm.make_lm(jax_reduced_config(arch)),
                             jax.random.PRNGKey(5)))
    back = params_to_numpy(params_from_numpy(flat, device="cpu"))
    assert sorted(back) == sorted(flat)
    for key, v in flat.items():
        np.testing.assert_array_equal(back[key].view(np.uint16),
                                      np.asarray(v).view(np.uint16))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def _check_prefill(model, batch):
    jcfg, tcfg, pj, pt = model
    bj, bt = _both(batch)
    lj, cj = jlm.prefill(jcfg, pj, bj)
    lt, ct = lm.prefill(tcfg, pt, bt)
    assert lt.shape == lj.shape
    np.testing.assert_allclose(_np(lt), _np(lj), **MODEL_TOL)
    got, want = _flat_t(ct), _flat(cj)
    assert sorted(got) == sorted(want)
    for key, v in want.items():
        np.testing.assert_allclose(got[key], v.astype(np.float32),
                                   **MODEL_TOL, err_msg=key)
    return lt


@pytest.mark.parametrize("case", ["music", "text", "image", "image96"])
def test_prefill_matches_jax(case, request):
    """Logits and caches: musicgen on [2, 19, 4] tokens (logits [2, 4, V]);
    phi-3 text only, with 8 image embeds over 10 positions, and with them
    at head dim 96."""
    model = request.getfixturevalue(
        {"music": "music", "text": "vision", "image": "vision",
         "image96": "vision96"}[case])
    cfg = model[1]
    rng = np.random.default_rng(4)
    if case == "music":
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 19, 4))
                 .astype(np.int32)}
        lt = _check_prefill(model, batch)
        assert lt.shape == (2, 4, cfg.vocab_size)
        return
    batch = _image_batch(cfg, 2, 19, cfg.num_image_tokens, 5)
    if case == "text":
        batch = {"tokens": batch["tokens"]}
    lt = _check_prefill(model, batch)
    if case != "text":      # the image rows changed the logits
        text, _ = lm.prefill(cfg, model[3],
                             {"tokens": torch.from_numpy(batch["tokens"])})
        assert not torch.allclose(lt, text)
    if case == "image96":
        assert cfg.head_dim == 96


def test_image_positions_past_the_sequence_are_dropped(vision):
    """S 6 < N 8: the positions at or past S (and below -S) write nothing
    in either package, a negative one counts from the end, and the rows
    below S hold their image embeds."""
    jcfg, tcfg, pj, pt = vision
    batch = _image_batch(tcfg, 2, 6, 8, 6)
    batch["image_positions"] = np.array([[7, 0, 6, 3, 9, 1, 8, -1],
                                         [2, 11, 4, 6, 0, -9, 10, 1]],
                                        np.int32)
    bj, bt = _both(batch)
    hj = jlm.embed_tokens(jcfg, pj, bj["tokens"], bj)
    ht = lm.embed_tokens(tcfg, pt, bt["tokens"], bt)
    np.testing.assert_array_equal(_np(ht), _np(hj))
    np.testing.assert_array_equal(_np(ht[0, 3]), batch["image_embeds"][0, 3])
    np.testing.assert_array_equal(_np(ht[0, 5]), batch["image_embeds"][0, 7])
    np.testing.assert_array_equal(_np(ht[1, 3]),      # no image there
                                  _np(pt["embed"][batch["tokens"][1, 3]]))
    _check_prefill(vision, batch)


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_chunk_then_decode_step_match_jax(music, paged):
    """Two [3, 4, 4] prefill chunks (slot 2 inactive for the second), then
    a decode step on [3, 1, 4] tokens with slot 1 inactive: the [B, 4, V]
    logits and every cache leaf against JAX's."""
    jcfg, tcfg, pj, pt = music
    B, C, max_seq, P, ps = 3, 4, 24, 20, 4
    lay = (P, ps) if paged else None
    rng = np.random.default_rng(9)
    extra = {}
    if paged:
        extra["page_table"] = rng.permutation(P)[:B * (max_seq // ps)] \
            .reshape(B, -1).astype(np.int32)
    cache_j = init_params(jlm.make_cache(jcfg, B, max_seq, paged=lay),
                          jax.random.PRNGKey(0))
    cache_t = lm.make_cache(tcfg, B, max_seq, paged=lay, device="cpu")
    for start, active in ((np.array([0, 4, 16], np.int32), np.ones(3, bool)),
                          (np.array([4, 8, 0], np.int32),
                           np.array([True, True, False]))):
        tok = rng.integers(0, tcfg.vocab_size, (B, C, 4)).astype(np.int32)
        bj, bt = _both({"tokens": tok, "start": start, "active": active,
                        **extra})
        cache_j = jlm.prefill_chunk(jcfg, pj, bj, cache_j)
        lm.prefill_chunk(tcfg, pt, bt, cache_t)
    active = np.array([True, False, True])
    bj, bt = _both({"tokens": rng.integers(0, tcfg.vocab_size, (B, 1, 4))
                    .astype(np.int32),
                    "pos": np.array([8, 12, 20], np.int32), "active": active,
                    **extra})
    lj, cache_j = jlm.decode_step(jcfg, pj, bj, cache_j)
    lt, _ = lm.decode_step(tcfg, pt, bt, cache_t)
    assert lt.shape == (B, 4, tcfg.vocab_size)
    np.testing.assert_allclose(_np(lt[active]), _np(lj[active]), **MODEL_TOL)
    got, want = _flat_t(cache_t), _flat(cache_j)
    for key, v in want.items():
        g = got[key][..., :P, :, :, :] if paged else got[key]
        np.testing.assert_allclose(g, v.astype(np.float32), **MODEL_TOL,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
ENGINE_KW = dict(batch_slots=3, max_seq=40, steps_per_sync=4,
                 prefill_chunk=4)
PROMPT_LENS = (4, 13, 7, 9)


def _prompts(cfg, seed):
    rng = np.random.default_rng(seed)
    tail = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    return [rng.integers(1, cfg.vocab_size, (n, *tail)).astype(np.int32)
            for n in PROMPT_LENS]


def _serve(cfg, pt, prompts, **kw):
    eng = DecodeEngine(cfg, pt, device="cpu", **kw)
    reqs = [Request(prompt=p, max_new_tokens=5) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done and not r.failed and len(r.output) == 5 for r in reqs)
    return [[np.asarray(t).tolist() for t in r.output] for r in reqs], eng


@pytest.fixture(scope="module")
def jax_tokens(music, vision):
    """The JAX fused engine's greedy tokens for each model, dense."""
    out = {}
    for name, (jcfg, tcfg, pj, _) in (("music", music), ("vision", vision)):
        jeng = JaxEngine(jcfg, pj, mode="fused", **ENGINE_KW)
        reqs = [JaxRequest(prompt=p, max_new_tokens=5)
                for p in _prompts(tcfg, 7)]
        for r in reqs:
            jeng.submit(r)
        jeng.run_until_drained()
        if name == "music":
            assert all(t.shape == (4,) for r in reqs for t in r.output)
        out[name] = [[np.asarray(t).tolist() for t in r.output]
                     for r in reqs]
    return out


@pytest.mark.parametrize("model,layout,mode", [
    ("music", "dense", "fused"), ("music", "dense", "host"),
    ("music", "paged", "fused"), ("music", "paged", "host"),
    ("vision", "dense", "fused")])
def test_engine_matches_jax_engine(jax_tokens, model, layout, mode, request):
    """More requests than slots, prompts through chunked prefill and forced
    decode: the port's engine gives the JAX engine's greedy tokens, one
    (4,) array an entry for musicgen."""
    _, tcfg, _, pt = request.getfixturevalue(model)
    kw = dict(ENGINE_KW, mode=mode)
    if layout == "paged":
        kw.update(kv_layout="paged", page_size=8)
    got, eng = _serve(tcfg, pt, _prompts(tcfg, 7), **kw)
    assert got == jax_tokens[model]
    req = Request(prompt=_prompts(tcfg, 8)[0], max_new_tokens=2)
    eng.submit(req)
    eng.run_until_drained()
    want = (tcfg.num_codebooks,) if model == "music" else ()
    assert [np.shape(t) for t in req.output] == [want, want]
    if layout == "paged":
        assert eng.pool.used_pages == 0


def test_engine_temperature_host_equals_fused_and_rejects_bad_prompts(music):
    """At temperature 1.0 host and fused mode draw the same codebook
    tokens; a prompt without the codebook axis is a typed rejection."""
    _, tcfg, _, pt = music
    outs = []
    for mode in ("host", "fused"):
        eng = DecodeEngine(tcfg, pt, device="cpu", mode=mode, **ENGINE_KW)
        reqs = [Request(prompt=p, max_new_tokens=5, temperature=1.0)
                for p in _prompts(tcfg, 3)]
        bad = Request(prompt=np.ones(5, np.int32))
        for r in (*reqs, bad):
            eng.submit(r)
        eng.run_until_drained()
        assert bad.failed and "trailing shape (4,)" in bad.fail_reason
        outs.append([[t.tolist() for t in r.output] for r in reqs])
    assert outs[0] == outs[1]


def test_sample_batch_on_codebook_logits():
    """[B, cb, V]: greedy is the JAX package's per-codebook argmax (ties to
    the lowest index), top-k 1 at temperature 1 is greedy (where no tie
    is), and a draw of
    codebook c equals the [B, V] draw of its logits with codebook c's
    hash half."""
    B, cb, V = 3, 4, 50
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((B, cb, V)).astype(np.float32)
    logits[0, 1, [3, 7]] = 9.0                       # a tie
    lt = torch.from_numpy(logits)
    keys = torch.tensor([1, 2**31 + 5, 77], dtype=torch.int64)
    counters = torch.tensor([0, 4, 9], dtype=torch.int64)
    vhash = vocab_hash(cb * V, "cpu").reshape(cb, V)
    zeros = torch.zeros(B, dtype=torch.int32)
    greedy = sample_batch(lt, keys, counters, torch.zeros(B), zeros, vhash)
    want = jax_sample_batch(jnp.asarray(logits),
                            jax.random.split(jax.random.PRNGKey(0), B),
                            jnp.zeros(B), jnp.zeros(B, jnp.int32))
    assert greedy.shape == (B, cb) and greedy.dtype == torch.int32
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(want))
    assert int(greedy[0, 1]) == 3
    temp = torch.ones(B)
    top1 = sample_batch(lt, keys, counters, temp,
                        torch.ones(B, dtype=torch.int32), vhash)
    assert int(top1[0, 1]) in (3, 7)                 # both pass top-1
    top1[0, 1] = 3
    np.testing.assert_array_equal(top1.numpy(), greedy.numpy())
    drawn = sample_batch(lt, keys, counters, temp, zeros, vhash)
    for c in range(cb):
        np.testing.assert_array_equal(
            drawn[:, c].numpy(),
            sample_batch(lt[:, c], keys, counters, temp, zeros,
                         vhash[c]).numpy())
    assert not torch.equal(drawn, greedy)


def test_codebook_zero_keeps_the_single_codebook_bits():
    """Codebook 0's hash bits equal ``vocab_hash(V)``'s, so every model
    without codebooks keeps its draws; the other codebooks differ."""
    cb, V = 4, 2048
    keys = torch.tensor([0, 12345, 2**32 - 1], dtype=torch.int64)
    counters = torch.tensor([0, 1, 2**20], dtype=torch.int64)
    wide = hash_bits(keys, counters, vocab_hash(cb * V, "cpu")
                     .reshape(cb, V))
    one = hash_bits(keys, counters, vocab_hash(V, "cpu"))
    assert wide.shape == (3, cb, V)
    assert torch.equal(wide[:, 0], one)
    assert not torch.equal(wide[:, 1], one)


def test_serve_launcher_runs_musicgen(capsys):
    """``launch/serve.py --arch musicgen-medium --preset reduced --device
    cpu``: prompts of (plen, 4) tokens, 16 sampled steps a request."""
    from repro_torch.launch import serve

    serve.main(["--arch", MUSIC, "--preset", "reduced", "--device", "cpu",
                "--requests", "3", "--prefill-chunk", "4"])
    assert f"{MUSIC}: 3 requests, 48 tokens" in capsys.readouterr().out
