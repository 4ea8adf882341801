"""``repro_torch.tune``, the port's kernel autotuning, on the CPU: the
persistent best-config cache, its wiring into ``kernels/ops.py`` dispatch
and the serving engine's page size, the search spaces (the kernels' own
tile checks), the measurement utilities, and sweeps through the port's
copy of ``Experiment`` on the simulator and on the LocalEngine.  The
first 18 tests port ``tests/test_tune.py``; then parity of the shared
arithmetic with ``repro.tune`` on seeded inputs, and what only the port
has.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.tune import cache as ref_cache
from repro.tune import measure as ref_measure
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.tune import cache as tc
from repro_torch.tune import space as tspace
from repro_torch.tune.measure import robust_mean_us

# one intra-op thread a process: pytest-xdist's workers share the host's
# cores, and each would otherwise start a pool as wide as the host
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SHAPE = {"b": 1, "s": 256, "h": 4, "kvh": 2, "d": 64}


@pytest.fixture
def cache_file(tmp_path, monkeypatch):
    """Fresh cache file + env override; singleton reset around the test."""
    path = str(tmp_path / "tune_cache.json")
    monkeypatch.setenv(tc.ENV_VAR, path)
    tc.reset()
    yield path
    tc.reset()


def _flash_qkv(s=256, dtype=torch.float32):
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.standard_normal(shape, np.float32))
                 .to(dtype) for shape in ((1, s, 4, 64), (1, s, 2, 64),
                                          (1, s, 2, 64)))


def _ssd_inputs(S=128, H=2, P=16, N=16, seed=1):
    rng = np.random.default_rng(seed)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32))

    x = f(1, S, H, P)
    dt = torch.nn.functional.softplus(f(1, S, H))
    A = -torch.exp(f(H) * 0.3)
    return x, dt, A, f(1, S, 1, N), f(1, S, 1, N)


# ---------------------------------------------------------------------------
# cache semantics
# ---------------------------------------------------------------------------
def test_cache_round_trip(cache_file):
    cache = tc.TuneCache(cache_file)
    key = cache.store("flash_attention", SHAPE, "bfloat16", "cpu",
                      {"block_q": 128, "block_k": 64}, runtime_us=10.0,
                      default_us=20.0)
    assert key in cache.entries()
    # a second instance reads the same file from scratch
    got = tc.TuneCache(cache_file).lookup(
        "flash_attention", SHAPE, "bfloat16", "cpu")
    assert got == {"block_q": 128, "block_k": 64}
    # other route / dtype / kernel are misses
    assert tc.TuneCache(cache_file).lookup(
        "flash_attention", SHAPE, "bfloat16",
        "cuda:NVIDIA H100 80GB HBM3") is None
    assert tc.TuneCache(cache_file).lookup(
        "flash_attention", SHAPE, "float32", "cpu") is None
    assert tc.TuneCache(cache_file).lookup(
        "decode_attention", SHAPE, "bfloat16", "cpu") is None


def test_cache_atomic_write_crash_safety(cache_file, monkeypatch):
    cache = tc.TuneCache(cache_file)
    cache.store("flash_attention", SHAPE, "bfloat16", "cpu",
                {"block_q": 128, "block_k": 64}, runtime_us=10.0)
    before = json.load(open(cache_file, encoding="utf-8"))

    def boom(*a, **kw):
        raise OSError("disk full mid-serialise")

    monkeypatch.setattr(json, "dump", boom)
    with pytest.raises(OSError):
        cache.store("ssd_scan", {"b": 1, "s": 128}, "float32", "cpu",
                    {"chunk": 32}, runtime_us=5.0)
    monkeypatch.undo()
    # the crash never touched the good file, and left no temp droppings
    assert json.load(open(cache_file, encoding="utf-8")) == before
    leftovers = [f for f in os.listdir(os.path.dirname(cache_file))
                 if f.endswith(".tmp")]
    assert leftovers == []


def test_cache_stale_hash_invalidation(cache_file):
    cache = tc.TuneCache(cache_file)
    cache.store("flash_attention", SHAPE, "bfloat16", "cpu",
                {"block_q": 128, "block_k": 64}, runtime_us=10.0)
    # simulate the kernel having been edited since tuning
    payload = json.load(open(cache_file, encoding="utf-8"))
    for e in payload["entries"].values():
        e["src_hash"] = "deadbeef0000"
    with open(cache_file, "w", encoding="utf-8") as fh:
        json.dump(payload, fh)
    assert tc.TuneCache(cache_file).lookup(
        "flash_attention", SHAPE, "bfloat16", "cpu") is None


def test_cache_shape_bucket_fallback(cache_file):
    cache = tc.TuneCache(cache_file)
    cache.store("flash_attention", SHAPE, "bfloat16", "cpu",
                {"block_q": 128, "block_k": 64}, runtime_us=10.0)
    # nearby shape, same field set -> nearest-bucket fallback hit
    near = dict(SHAPE, s=512)
    assert cache.lookup("flash_attention", near, "bfloat16",
                        "cpu") == {"block_q": 128, "block_k": 64}
    # different field set -> no fallback across workload identities
    other = {"b": 1, "sk": 256, "h": 4, "kvh": 2, "d": 64}
    assert cache.lookup("flash_attention", other, "bfloat16",
                        "cpu") is None


def test_cache_corrupt_file_treated_as_empty(cache_file):
    with open(cache_file, "w", encoding="utf-8") as fh:
        fh.write("{not json")
    cache = tc.TuneCache(cache_file)
    assert cache.lookup("flash_attention", SHAPE, "bfloat16", "cpu") is None
    # and storing over the corpse works
    cache.store("flash_attention", SHAPE, "bfloat16", "cpu",
                {"block_q": 64, "block_k": 128}, runtime_us=1.0)
    assert cache.lookup("flash_attention", SHAPE, "bfloat16",
                        "cpu") == {"block_q": 64, "block_k": 128}


def test_cache_disabled_via_env(monkeypatch):
    monkeypatch.setenv(tc.ENV_VAR, "")
    tc.reset()
    try:
        assert tc.best_config("flash_attention", SHAPE, torch.bfloat16,
                              "cpu") is None
        with pytest.raises(RuntimeError):
            tc.get_cache().store("flash_attention", SHAPE, "bfloat16",
                                 "cpu", {}, runtime_us=1.0)
    finally:
        tc.reset()


def test_shape_bucket_rounds_up_pow2():
    assert tc.shape_bucket({"s": 300, "b": 1, "h": 3}) == "b1-h4-s512"
    assert tc.shape_bucket({"s": 256}) == "s256"


# ---------------------------------------------------------------------------
# ops dispatch wiring (explicit arg > cache hit > default)
# ---------------------------------------------------------------------------
@pytest.fixture
def flash_spy(monkeypatch):
    """Record the kwargs ops dispatch hands the flash wrapper (the wrapper
    itself is stubbed out — these tests probe the wiring, not the math)."""
    seen = {}

    def spy(q, k, v, **kw):
        seen.clear()
        seen.update(kw)
        return torch.zeros_like(q)

    monkeypatch.setattr(fa, "flash_attention", spy)
    return seen


def test_ops_flash_miss_uses_defaults(cache_file, flash_spy):
    from repro_torch.kernels import ops

    ops.flash_attention(*_flash_qkv(dtype=torch.bfloat16))
    assert flash_spy["block_q"] == 64 and flash_spy["block_k"] == 64


def test_ops_flash_hit_uses_tuned_blocks(cache_file, flash_spy):
    tc.get_cache().store("flash_attention", SHAPE, "bfloat16", "cpu",
                         {"block_q": 128, "block_k": 128}, runtime_us=10.0)
    from repro_torch.kernels import ops

    ops.flash_attention(*_flash_qkv(dtype=torch.bfloat16))
    assert flash_spy["block_q"] == 128 and flash_spy["block_k"] == 128
    # explicit argument always beats the cache
    ops.flash_attention(*_flash_qkv(dtype=torch.bfloat16), block_q=64)
    assert flash_spy["block_q"] == 64 and flash_spy["block_k"] == 128
    # the entry is bf16's: fp32 inputs (one tile) miss it
    ops.flash_attention(*_flash_qkv())
    assert flash_spy["block_q"] == 64 and flash_spy["block_k"] == 64


def test_ops_invalid_cached_config_falls_back(cache_file, flash_spy):
    # no tensor-core body has 96-row tiles -> dispatch degrades to the
    # default tile
    tc.get_cache().store("flash_attention", SHAPE, "bfloat16", "cpu",
                         {"block_q": 96, "block_k": 128}, runtime_us=10.0)
    from repro_torch.kernels import ops

    ops.flash_attention(*_flash_qkv(dtype=torch.bfloat16))
    assert flash_spy["block_q"] == 64 and flash_spy["block_k"] == 64


def test_ops_ssd_chunk_none_matches_default(monkeypatch):
    """No cache: ``chunk=None`` is bit-identical to the built-in 64."""
    monkeypatch.setenv(tc.ENV_VAR, "")
    tc.reset()
    try:
        from repro_torch.kernels import ops

        args = _ssd_inputs()
        auto = ops.ssd_scan(*args)
        manual = ops.ssd_scan(*args, chunk=64)
        assert torch.equal(auto, manual)
    finally:
        tc.reset()


def test_engine_resolve_page_size(cache_file):
    from repro_torch.configs import reduced_config
    from repro_torch.serve.engine import DEFAULT_PAGE_SIZE, _resolve_page_size

    cfg = reduced_config("smollm-360m")
    # miss -> default
    assert _resolve_page_size(cfg, 4, 256, "cpu") == DEFAULT_PAGE_SIZE
    shape = {"b": 4, "sk": 256, "kvh": cfg.num_kv_heads,
             "g": cfg.num_heads // cfg.num_kv_heads, "d": cfg.head_dim}
    tc.get_cache().store("decode_attention_paged", shape, cfg.dtype,
                         tc.dispatch_backend("cpu"), {"page_size": 32},
                         runtime_us=10.0)
    assert _resolve_page_size(cfg, 4, 256, "cpu") == 32
    # a stale/out-of-range tuned value degrades to the default
    tc.get_cache().store("decode_attention_paged", shape, cfg.dtype,
                         tc.dispatch_backend("cpu"), {"page_size": 4096},
                         runtime_us=10.0)
    assert _resolve_page_size(cfg, 4, 256, "cpu") == DEFAULT_PAGE_SIZE
    # MLA and attention-free configs never consult the cache
    for arch in ("deepseek-v3-671b", "mamba2-130m"):
        other = reduced_config(arch)
        tc.get_cache().store("decode_attention_paged", shape, other.dtype,
                             "cpu", {"page_size": 32}, runtime_us=10.0)
        assert _resolve_page_size(other, 4, 256, "cpu") == DEFAULT_PAGE_SIZE


# ---------------------------------------------------------------------------
# search space + measurement utilities
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_space_grid_static_validity(dtype):
    for kernel, spec in tspace.SPECS.items():
        shape = dict(spec.smoke_shape)
        sp = tspace.build_space(kernel, shape, dtype=dtype, adversarial=4,
                                seed=0)
        cells = list(sp.cells())
        assert cells, kernel
        for cell in cells:
            assert tspace.valid(kernel, cell), (kernel, cell)
        # the dispatch default is always in the grid (the incumbent)
        assert any(all(c[k] == v for k, v in
                       spec.default_config(shape).items())
                   for c in cells), kernel


def test_runner_rejects_invalid_config_statically():
    from repro_torch.tune import runner

    cell = dict(SHAPE, dtype="bfloat16", block_q=96, block_k=64)
    with pytest.raises(ValueError, match="no body"):
        runner.measure_cell("flash_attention", cell)


def test_runner_tasks_default_to_the_card():
    """A measurement task called without a device runs on the card, as
    every entry point of the port does: with no card it raises, and
    ``device="cpu"`` measures the plain version."""
    import inspect

    from repro_torch.tune import runner

    for kernel, t in runner.MEASURE_TASKS.items():
        assert inspect.signature(t.fn).parameters["device"].default \
            == "cuda", kernel
    cell = dict(SHAPE, s=64, dtype="float32", block_q=64, block_k=64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            runner.measure_cell("flash_attention", cell)
    us, kept, n = runner.measure_cell("flash_attention",
                                      dict(cell, device="cpu"))
    assert us > 0 and 0 < kept <= n


def test_robust_mean_rejects_outliers():
    mean, kept = robust_mean_us([10.0, 11.0, 12.0, 500.0],
                                outlier_frac=0.25)
    assert kept == 3
    assert mean == pytest.approx(11.0)
    with pytest.raises(ValueError):
        robust_mean_us([])


def test_predicted_cost_orders_pathological_last():
    # the kernels' runnable-but-bad values: SSD chunks of 2, 4 and 8, and
    # one decode split holding every key
    for kernel in ("ssd_scan", "decode_attention", "decode_attention_paged"):
        spec = tspace.SPECS[kernel]
        shape = {**spec.full_shape, "dtype": "bfloat16"}
        (name,) = spec.tunables
        sane = [tspace.predicted_cost_us(kernel, {**shape, name: v})
                for v in spec.tunables[name]]
        for bad in spec.pathological[name]:
            cell = {**shape, name: bad}
            assert tspace.predicted_cost_us(kernel, cell) > max(sane), cell
            assert tspace.hardness_of(kernel, cell) > \
                tspace.hardness_of(kernel, {**shape, **spec.default_config(
                    shape)})


# ---------------------------------------------------------------------------
# the dogfood sweep: Experiment-driven tuning, domino pruning live
# ---------------------------------------------------------------------------
def test_sim_sweep_dogfood(cache_file, monkeypatch):
    """End-to-end: sim-engine sweep on an adversarial grid prunes via the
    paper's timeout/domino rule, stays under its budget cap, persists the
    winner, and ops dispatch picks the tuned value up afterwards."""
    from repro_torch.core.scheduler import DONE
    from repro_torch.tune.tuner import tune

    # the smoke grid: deterministic on the sim engine, and sized so the
    # pathological configs outlast the sane queue (>= one task is still
    # pending when the first timeout fires -> a provable domino prune)
    shape = dict(tspace.SPECS["ssd_scan"].smoke_shape)
    rep = tune("ssd_scan", shape=shape, engine="sim", adversarial=4,
               seed=0, budget_cap=150.0, cache_path=cache_file, device="cpu")
    assert rep.explored == len(rep.configs) > 0
    assert rep.pruned >= 1, rep.summary()         # domino rule fired
    assert rep.timed_out >= 1, rep.summary()
    assert rep.measured >= 1, rep.summary()
    assert rep.speedup >= 1.0 - 1e-9              # incumbent is the floor
    assert rep.under_cap is True
    assert rep.cost_total is not None and rep.cost_total <= 150.0
    # per-config CostMeter attribution present on the records
    assert any(c.get("cost") is not None for c in rep.configs)
    # pruned configs never ran: no runtime on their records
    assert all("runtime_us" not in c for c in rep.configs
               if c["status"] != DONE)
    # winner persisted under the CPU route
    entry = tc.TuneCache(cache_file).lookup("ssd_scan", shape, "float32",
                                            "cpu")
    assert entry == rep.best_config

    # ...and dispatch actually consumes it (chunk=None -> tuned chunk)
    from repro_torch.kernels import ops

    seen = {}
    orig = ssd.ssd_scan

    def spy(*a, **kw):
        seen.update(kw)
        return orig(*a, **kw)

    monkeypatch.setattr(ssd, "ssd_scan", spy)
    tc.reset()
    ops.ssd_scan(*_ssd_inputs())
    assert seen["chunk"] == rep.best_config["chunk"]


_PICKUP = r"""
import json, sys
import torch
from repro_torch.kernels import flash_attention as fa, ops
seen = {}
fa.flash_attention = lambda q, k, v, **kw: (seen.update(kw),
                                            torch.zeros_like(q))[1]
s = json.loads(sys.argv[1])
q = torch.zeros(s["b"], s["s"], s["h"], s["d"], dtype=torch.bfloat16)
k = torch.zeros(s["b"], s["s"], s["kvh"], s["d"], dtype=torch.bfloat16)
ops.flash_attention(q, k, k.clone())
print(json.dumps(seen))
"""


def test_env_cache_pickup(cache_file):
    """Handoff across processes: a cache this process wrote (as ``python
    -m repro_torch.tune`` would) steers ops dispatch in a fresh one that
    finds it through ``REPRO_TORCH_TUNE_CACHE``."""
    tc.get_cache().store("flash_attention", SHAPE, "bfloat16", "cpu",
                         {"block_q": 128, "block_k": 64}, runtime_us=10.0)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env[tc.ENV_VAR] = cache_file
    proc = subprocess.run([sys.executable, "-c", _PICKUP, json.dumps(SHAPE)],
                          capture_output=True, text=True, env=env,
                          timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (seen["block_q"], seen["block_k"]) == (128, 64)


# ---------------------------------------------------------------------------
# parity of the shared arithmetic with repro.tune
# ---------------------------------------------------------------------------
def _seeded_shapes(n=200, seed=0):
    rng = np.random.default_rng(seed)
    fields = ("b", "s", "sk", "h", "kvh", "d", "g", "n", "p")
    for _ in range(n):
        keys = rng.choice(fields, size=rng.integers(1, 6), replace=False)
        yield {str(k): int(rng.integers(0, 5000)) for k in keys}


def test_shape_bucket_and_distance_match_reference():
    shapes = list(_seeded_shapes())
    for a, b in zip(shapes, shapes[1:] + shapes[:1], strict=True):
        assert tc.shape_bucket(a) == ref_cache.shape_bucket(a)
        assert tc._bucket_distance(a, b) == ref_cache._bucket_distance(a, b)
        same = {k: v + 1 for k, v in a.items()}
        assert tc._bucket_distance(a, same) == \
            ref_cache._bucket_distance(a, same)


def test_robust_mean_matches_reference():
    rng = np.random.default_rng(3)
    for _ in range(100):
        samples = list(rng.exponential(50.0, rng.integers(1, 20)))
        frac = float(rng.uniform(0.0, 0.9))
        assert robust_mean_us(samples, frac) == \
            ref_measure.robust_mean_us(samples, frac)


# ---------------------------------------------------------------------------
# what only the port has
# ---------------------------------------------------------------------------
def test_ops_decode_split_resolution(cache_file, monkeypatch):
    """The decode knob ``block_k`` (keys a split): a miss passes None (the
    wrapper's ``split_plan``), a hit its L, a split the kernel cannot take
    falls back, an explicit value wins."""
    from repro_torch.kernels import ops

    seen = {}

    def spy(q, k, v, kv_len, **kw):
        seen.clear()
        seen.update(kw)
        return torch.zeros(q.shape[0], q.shape[1], v.shape[3])

    monkeypatch.setattr(da, "decode_attention", spy)
    q = torch.zeros(2, 4, 64)
    k = torch.zeros(2, 1024, 2, 64)
    kv_len = torch.full((2,), 1024, dtype=torch.int32)
    ops.decode_attention(q, k, k, kv_len)
    assert seen["block_k"] is None
    shape = {"b": 2, "sk": 1024, "h": 4, "kvh": 2, "d": 64}
    tc.get_cache().store("decode_attention", shape, "float32", "cpu",
                         {"block_k": 256}, runtime_us=1.0)
    ops.decode_attention(q, k, k, kv_len)
    assert seen["block_k"] == 256
    ops.decode_attention(q, k, k, kv_len, block_k=128)
    assert seen["block_k"] == 128
    tc.get_cache().store("decode_attention", shape, "float32", "cpu",
                         {"block_k": 100}, runtime_us=1.0)
    ops.decode_attention(q, k, k, kv_len)
    assert seen["block_k"] is None


def test_wrappers_refuse_configs_the_kernels_cannot_run():
    """The tile checks run before the device branch: what the card would
    refuse, the CPU refuses too; the knobs it takes leave the plain
    versions' results alone."""
    q, k, v = _flash_qkv(dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no torch.bfloat16 body"):
        fa.flash_attention(q, k, v, block_q=96)
    with pytest.raises(ValueError, match="no torch.float32 body"):
        fa.flash_attention(*_flash_qkv(), block_q=128)
    assert torch.equal(fa.flash_attention(q, k, v, block_q=128, block_k=128),
                       fa.flash_attention(q, k, v))
    dq = torch.zeros(2, 4, 64)
    dk = torch.zeros(2, 1024, 2, 64)
    kv_len = torch.full((2,), 1000, dtype=torch.int32)
    for bad in (100, 0, 8):         # not a tile multiple; 128 splits of 8
        with pytest.raises(ValueError, match="no split"):
            da.decode_attention(dq, dk, dk, kv_len, block_k=bad)
    assert torch.equal(da.decode_attention(dq, dk, dk, kv_len, block_k=1024),
                       da.decode_attention(dq, dk, dk, kv_len))
    for bad in (0, ssd.MAX_CHUNK + 1):
        with pytest.raises(ValueError, match="chunk"):
            ssd.ssd_scan(*_ssd_inputs(), chunk=bad)
    assert tspace.valid("decode_attention_paged",
                        {"sk": 1024, "page_size": 1})
    assert not tspace.valid("decode_attention_paged",
                            {"sk": 2048, "page_size": 1})   # W > 1024
    assert not tspace.valid("decode_attention_paged",
                            {"sk": 256, "page_size": 512})  # ps > sk


def test_kernel_source_hash_follows_headers(tmp_path, monkeypatch):
    """An edit to the wrapper, the CUDA source or a header it includes
    (transitively) makes the kernel's old tunings stale."""
    pkg = tmp_path / "fakekern"
    (pkg / "csrc").mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "wrap.py").write_text("x = 1\n")
    (pkg / "csrc" / "k.cu").write_text('#include "a.cuh"\nint k;\n')
    (pkg / "csrc" / "a.cuh").write_text('#include "b.cuh"\n')
    (pkg / "csrc" / "b.cuh").write_text("int b;\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setitem(tc.KERNEL_SOURCES, "fake", ("fakekern.wrap", "k.cu"))
    hashes = []
    for path, text in ((None, None), ("csrc/b.cuh", "int b2;\n"),
                       ("csrc/k.cu", '#include "a.cuh"\nint k2;\n'),
                       ("wrap.py", "x = 2\n")):
        if path is not None:
            (pkg / path).write_text(text)
        tc.reset()
        hashes.append(tc.kernel_source_hash("fake"))
    assert len(set(hashes)) == 4
    tc.reset()
    names = [p.name for p in tc._with_includes(
        ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu")]
    assert names == ["flash_attention.cu", "flash_common.cuh",
                     "mma_common.cuh"]
    assert tc.kernel_source_hash("decode_attention") == \
        tc.kernel_source_hash("decode_attention_paged")
    assert tc.kernel_source_hash("flash_attention") != \
        tc.kernel_source_hash("ssd_scan")


def test_engine_builds_its_pool_at_the_tuned_page_size(cache_file):
    from repro_torch.configs import reduced_config
    from repro_torch.models import lm
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import DEFAULT_PAGE_SIZE, DecodeEngine

    cfg = reduced_config("smollm-360m")
    params = init_params(lm.make_lm(cfg), torch.Generator().manual_seed(0),
                         device="cpu")
    shape = {"b": 2, "sk": 64, "kvh": cfg.num_kv_heads,
             "g": cfg.num_heads // cfg.num_kv_heads, "d": cfg.head_dim}

    def pool_page_size(**kw):
        eng = DecodeEngine(cfg, params, batch_slots=2, max_seq=64,
                           kv_layout="paged", device="cpu", **kw)
        return eng.pool.page_size

    assert pool_page_size() == DEFAULT_PAGE_SIZE
    tc.get_cache().store("decode_attention_paged", shape, cfg.dtype, "cpu",
                         {"page_size": 8}, runtime_us=1.0)
    assert pool_page_size() == 8
    assert pool_page_size(page_size=32) == 32


def test_local_engine_sweep_on_the_cpu(cache_file):
    """One sweep through the LocalEngine: real worker processes under a
    wall-clock timeout, the incumbent measured in a spawned process."""
    from repro_torch.tune.tuner import tune

    rep = tune("ssd_scan", smoke=True, engine="local", max_clients=1,
               cache_path=cache_file, device="cpu")
    assert rep.explored == len(rep.configs) == 4, rep.summary()
    assert rep.measured == 4 and rep.pruned == rep.timed_out == 0
    assert all(c["runtime_us"] > 0 for c in rep.configs)
    assert rep.best_us <= rep.default_us
    assert tc.TuneCache(cache_file).lookup(
        "ssd_scan", rep.shape, "float32", "cpu") == rep.best_config


_CLI_ALONE = r"""
import runpy, sys
sys.modules["jax"] = None            # any import of jax now fails
sys.modules["repro"] = None          # and of the JAX package
sys.argv = ["python -m repro_torch.tune", "--kernel", "ssd_scan", "--smoke",
            "--device", "cpu", "--adversarial", "4", "--cache",
            sys.argv[1]]
try:
    runpy.run_module("repro_torch.tune", run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
assert not any(m == "repro" or m.startswith(("repro.", "jax"))
               for m, v in sys.modules.items() if v is not None)
"""


def test_cli_runs_without_the_reference(tmp_path):
    path = str(tmp_path / "cli_cache.json")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _CLI_ALONE, path],
                          capture_output=True, text=True, env=env,
                          timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr
    assert "ssd_scan" in proc.stdout and "pruned=" in proc.stdout
    entries = tc.TuneCache(path).entries()
    assert [e["backend"] for e in entries.values()] == ["cpu"]
