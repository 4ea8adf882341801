"""Serving on a (data, model) mesh (``torch.distributed``, gloo CPU ranks)
against the JAX package's single-device entry points on the same global
batch: ``lm.prefill``, the cache warmed by ``lm.prefill_chunk`` and eight
greedy ``lm.decode_step``s, each rank at its rows of the batch, its heads
and its part of the decode cache (``sharding/tp.py::cache_layout``), the
logits gathered whole over the model group (``lm.whole_logits``).

Reduced configs in fp32, weights made by the JAX initialiser and cut to
each rank's parts by the bridge (``tests/test_torch_dp_train.py``'s
``_jax_params``):

  * qwen3-4b and granite-20b: 4 query heads over one KV head, which every
    rank holds (the KV head replicated, as granite-20b's at full width);
  * olmoe-1b-7b: 8 experts split over the model axis, the MoE routing the
    global token set over the data axis (``tp.use_data_rows``);
  * mamba2-130m: 8 SSD heads, the conv channels and the SSM state rows of
    each rank's heads;
  * jamba-v0.1-52b: the hybrid super-block, Mamba, attention and MoE;
  * deepseek-v3-671b: MLA at 4 heads (the latent cache whole on every
    rank) and the MoE with a shared expert.

At (1, 2), (2, 2) and (1, 4): the prefill's and each decode step's logits
within ``TP_FP32_REL`` (1e-5) of the reference's largest magnitude, the
greedy tokens equal, and each rank's cache bytes those of its layout,
less than the whole cache where the mesh splits it.  The paged layout
refuses a model axis, naming item 9b.
"""
import functools
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.models import lm as jlm
from repro.models.params import init_params as jax_init_params
from test_torch_dp_train import ROOT, _flat, _jax_params

ARCHS = ("qwen3-4b", "granite-20b", "olmoe-1b-7b", "mamba2-130m",
         "jamba-v0.1-52b", "deepseek-v3-671b")
MESHES = [(1, 2), (2, 2), (1, 4)]
# the configs whose cache a model axis leaves whole: one KV head (held by
# every rank) or MLA's latents
WHOLE_CACHE = ("qwen3-4b", "granite-20b", "deepseek-v3-671b")
B, S, MAX_SEQ, STEPS = 4, 12, 24, 8
TP_FP32_REL = 1e-5

_WORKER = r"""
import pickle
import sys

import numpy as np
import torch

torch.set_num_threads(1)
from repro_torch import distributed
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import reduced_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.params import init_params, tree_leaves, tree_map
from repro_torch.sharding import tp
from repro_torch.sharding.rules import NamedSharding, make_rules, use_rules
from repro_torch.train.optimizer import get_optimizer
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.train_step import make_train_step

rank, world, store, inp, out = sys.argv[1:6]
rank, world = int(rank), int(world)
D, M = int(sys.argv[6]), int(sys.argv[7])
distributed.init("cpu", init_method="file://" + store, rank=rank,
                 world_size=world)
mesh = make_mesh((D, M), ("data", "model"), device="cpu")
rules = make_rules(mesh)
data = distributed.data_group(mesh)


def setup(case):
    cfg = reduced_config(case["arch"]).replace(dtype="float32")
    descr = tp.layout_descr(cfg, lm.make_lm(cfg), rules)
    parts = tp.param_parts(cfg, descr, rules)
    params = params_from_numpy(case["params"], "cpu", ckpt._flatten(parts))
    return cfg, descr, params


def rows_of(n):
    return NamedSharding(mesh, rules.spec(("batch",), (n,))).part()


def local(batch):
    rows = rows_of(next(iter(batch.values())).shape[0])
    return {k: torch.from_numpy((v if rows is None else rows.take(v)).copy())
            for k, v in batch.items()}, rows


def whole_rows(x, rows):
    return x if rows is None else distributed.all_gather(x, 0, data)


def nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def serve(case):
    cfg, _, params = setup(case)
    batch, rows = local(case["batch"])
    Bl = batch["tokens"].shape[0]
    split = rows is not None and rows.parts > 1
    with torch.no_grad(), use_rules(rules), \
            tp.use_data_rows(data if split else None):
        logits, _ = lm.prefill(cfg, params, batch)
        # the global batch: each rank holds its rows of it
        cache = lm.make_cache(cfg, case["batch"]["tokens"].shape[0],
                              case["max_seq"], device="cpu", rules=rules)
        S = batch["tokens"].shape[1]
        lm.prefill_chunk(cfg, params, dict(
            batch, start=torch.zeros(Bl, dtype=torch.int32)), cache)
        got = [whole_rows(logits, rows)]
        tok = logits.argmax(-1)
        for i in range(case["steps"]):
            step = {"tokens": tok[:, None],
                    "pos": torch.full((Bl,), S + i, dtype=torch.int32)}
            logits, cache = lm.decode_step(cfg, params, step, cache)
            got.append(whole_rows(logits, rows))
            tok = logits.argmax(-1)
    whole = lm.cache_descr(cfg, case["batch"]["tokens"].shape[0],
                           case["max_seq"])
    mine = lm.cache_descr(cfg, case["batch"]["tokens"].shape[0],
                          case["max_seq"], rules=rules)
    return {"logits": [x.numpy() for x in got],
            "bytes": (nbytes(cache), nbytes(init_params(mine, None, "meta")),
                      nbytes(init_params(whole, None, "meta")))}


def paged(case):
    cfg, _, params = setup(case)
    try:
        lm.cache_descr(cfg, 2, 16, (4, 8), rules=rules)
    except NotImplementedError as e:
        return str(e)
    return None


def grads(case):
    # the loss and every gradient leaf (whole), then one AdamW step
    cfg, descr, params = setup(case)
    batch, rows = local(case["batch"])
    split = rows is not None and rows.parts > 1

    def count(n):
        return distributed.all_reduce(n.detach().clone(), "sum", data)

    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with use_rules(rules), tp.use_data_rows(data if split else None):
        loss, _ = lm.train_loss(cfg, leaves, batch, remat=True, count=count)
        loss.backward()
    loss = distributed.all_reduce(loss.detach().clone(), "sum", data)
    psh = tp.param_shardings(cfg, descr, rules)
    g = tree_map(lambda p: distributed.all_reduce(p.grad, "sum", data),
                 leaves)
    whole = {k: ckpt._flatten(psh)[k].full(v)
             for k, v in ckpt._flatten(g).items()}
    opt = get_optimizer("adamw")
    layout = opt.layout(descr, rules)
    state = opt.init(params, layout)
    fn = make_train_step(cfg, opt, warmup_cosine(1e-3, 2, 10), clip_norm=1.0,
                         remat=True, group=data, layout=layout,
                         model_parts=tp.param_parts(cfg, descr, rules),
                         rows_split=split)
    with use_rules(rules):
        params, state, m = fn(params, state, batch, case["step"])
    stepped = {k: ckpt._flatten(psh)[k].full(v)
               for k, v in ckpt._flatten(params).items()}
    return {"loss": float(loss),
            "grads": params_to_numpy(whole),
            "metrics": {k: float(v) for k, v in m.items()},
            "params": params_to_numpy(stepped)}


cases = pickle.load(open(inp, "rb"))
results = [globals()[case["kind"]](case) for case in cases]
if rank == 0:
    with open(out, "wb") as f:
        pickle.dump(results, f)
distributed.shutdown()
"""


def start_ranks(mesh: tuple, cases: list, tmp_path, name: str):
    """The cases in one rank process a rank of ``mesh`` (data, model);
    returns a function that waits for them and returns rank 0's
    results."""
    world = mesh[0] * mesh[1]
    inp, out = tmp_path / f"{name}.in", tmp_path / f"{name}.out"
    inp.write_bytes(pickle.dumps(cases))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world),
         str(tmp_path / f"{name}.store"), str(inp), str(out), *map(str, mesh)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for r in range(world)]

    def wait() -> list:
        done = [p.communicate(timeout=300) + (p.returncode,) for p in procs]
        for so, se, rc in done:
            assert rc == 0, so[-2000:] + se[-4000:]
        return pickle.loads(out.read_bytes())

    return wait


def serve_batch(cfg, seed: int = 5) -> dict:
    rng = np.random.default_rng(seed)
    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S, *cb)
                                    ).astype(np.int32)}
    if cfg.vision_stub:
        N = cfg.num_image_tokens
        batch["image_embeds"] = rng.standard_normal(
            (B, N, cfg.d_model)).astype(np.float32)
        batch["image_positions"] = np.stack(
            [rng.permutation(S)[:N] for _ in range(B)]).astype(np.int32)
    return batch


def serve_case(arch: str) -> dict:
    cfg, params = _jax_params(arch)
    return {"kind": "serve", "arch": arch, "params": _flat(params),
            "batch": serve_batch(cfg), "max_seq": MAX_SEQ, "steps": STEPS}


@functools.cache
def jax_serve(arch: str) -> list:
    """JAX's single-device prefill logits and each greedy decode step's,
    the cache warmed by one prefill_chunk of the prompt."""
    cfg, params = _jax_params(arch)
    batch = {k: jnp.asarray(v) for k, v in serve_batch(cfg).items()}
    logits, _ = jlm.prefill(cfg, params, batch)
    cache = jax_init_params(jlm.make_cache(cfg, B, MAX_SEQ),
                            jax.random.PRNGKey(0))
    cache = jlm.prefill_chunk(cfg, params, dict(
        batch, start=jnp.zeros((B,), jnp.int32)), cache)
    out = [np.asarray(logits)]
    tok = jnp.argmax(logits, -1)
    for i in range(STEPS):
        logits, cache = jlm.decode_step(cfg, params, {
            "tokens": tok[:, None],
            "pos": jnp.full((B,), S + i, jnp.int32)}, cache)
        out.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1)
    return out


def check_serve(res: dict, want: list, label: str, mesh: tuple) -> None:
    assert len(res["logits"]) == len(want) == STEPS + 1
    for i, (g, w) in enumerate(zip(res["logits"], want, strict=True)):
        assert g.shape == w.shape, (label, i, g.shape, w.shape)
        rel = float(np.abs(g - w).max()) / float(np.abs(w).max())
        assert rel <= TP_FP32_REL, (label, i, rel)
        # the greedy tokens
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1),
                                      err_msg=f"{label} step {i}")
    held, spec, whole = res["bytes"]
    assert held == spec, (label, held, spec)
    if mesh[0] > 1 or label not in WHOLE_CACHE:
        assert held < whole, (label, held, whole)
    else:
        assert held == whole, (label, held, whole)


def once(wait):
    box = []

    def get():
        if not box:
            box.append(wait())
        return box[0]

    return get


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: (cases, a function returning rank 0's results once)}: every
    mesh's ranks start at once and run while this process makes the JAX
    references, in threads (XLA leaves the GIL while it runs)."""
    tmp = tmp_path_factory.mktemp("serve")
    with ThreadPoolExecutor(len(ARCHS)) as ex:
        list(ex.map(_jax_params, ARCHS))
    started = {}
    for mesh in MESHES:
        cases = [serve_case(a) for a in ARCHS]
        cases.append(dict(serve_case("qwen3-4b"), kind="paged"))
        started[mesh] = (cases, once(start_ranks(
            mesh, cases, tmp, f"m{mesh[0]}x{mesh[1]}")))
    with ThreadPoolExecutor(len(ARCHS)) as ex:
        list(ex.map(jax_serve, ARCHS))
    return started


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_prefill_and_decode_match_the_jax_single_device_steps(mesh, runs):
    cases, results = runs[mesh]
    *results, refused = results()
    for case, res in zip(cases, results, strict=False):
        check_serve(res, jax_serve(case["arch"]), case["arch"], mesh)
    assert "Queue A item 9b" in refused
