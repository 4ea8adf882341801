"""Measurement tasks: time one kernel config on the sweep's device.

One module-level ``@task`` function per kernel (module-level so
``FunctionTask`` pickles by reference and the sweep can run on the
LocalEngine's worker processes).  Each task:

* statically re-validates the config (``space.valid``) and raises
  ``ValueError`` *before* building any inputs — a config that slipped
  past the grid filter is rejected loudly instead of failing inside a
  client;
* builds inputs for the cell's shape from a ``torch.Generator`` seeded on
  the sweep's device, then times the call **through
  ``kernels/ops.py`` dispatch** with the knob named explicitly (never
  bypassing it — the measurement exercises exactly the code path a model
  would hit: the CUDA kernel for tensors on the card, the plain version
  on the CPU); the paged task builds its pool at the cell's
  ``page_size``;
* warms up exactly once and takes repeated outlier-rejected samples
  (:func:`repro_torch.tune.measure.time_fn`).

``device`` is an axis of the grid like the shape fields (``tune`` fixes
it), so a worker process knows where to build its inputs; a task called
without one runs on the card, as every entry point of the port does, and
raises where there is none.  Every task
declares ``hardness`` and ``sim_duration`` from the roofline predicted
cost (``repro_torch.tune.space``), which is what lets the sweep run
through ``Experiment(engine="sim")`` with the paper's timeout/domino
pruning fully active.

Returns ``(runtime_us, n_kept, n_samples)`` per config.
"""
from __future__ import annotations

import functools

from repro_torch.core.space import task
from repro_torch.tune import space as _space
from repro_torch.tune.measure import time_fn

RESULT_TITLES = ("runtime_us", "n_kept", "n_samples")
MEASURE_ITERS = 5
INPUT_SEED = 0


def _check(kernel: str, cell: dict) -> None:
    cell = {k: v for k, v in cell.items() if k != "device"}
    if not _space.valid(kernel, cell):
        raise ValueError(
            f"invalid {kernel} config {cell!r}: the kernel has no body for "
            f"it (should have been filtered statically by "
            f"repro_torch.tune.space.build_space)")


def _hard(kernel):
    def h(device=None, **cell):
        return _space.hardness_of(kernel, cell)
    return h


def _simdur(kernel):
    def s(device=None, **cell):
        return _space.sim_duration_s(kernel, cell)
    return s


def _gen(device):
    import torch

    from repro_torch.device import resolve_device

    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(INPUT_SEED)
    return gen


def _normal(gen, shape, dtype, device):
    import torch

    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).to(getattr(torch, dtype))


def _kv_len(b: int, sk: int, device):
    """Ragged fill levels, the serving steady state (deterministic)."""
    import torch

    return torch.tensor([sk - (i * sk // (2 * b)) for i in range(b)],
                        dtype=torch.int32, device=device)


def _timed(fn, *args):
    mean_us, kept, samples = time_fn(fn, *args, iters=MEASURE_ITERS)
    return mean_us, kept, len(samples)


@task(result_titles=RESULT_TITLES, hardness=_hard("flash_attention"),
      sim_duration=_simdur("flash_attention"))
def measure_flash_attention(b, s, h, kvh, d, dtype, block_q, block_k,
                            device="cuda"):
    cell = dict(b=b, s=s, h=h, kvh=kvh, d=d, dtype=dtype,
                block_q=block_q, block_k=block_k)
    _check("flash_attention", cell)
    from repro_torch.kernels import ops

    gen = _gen(device)
    q = _normal(gen, (b, s, h, d), dtype, device)
    k = _normal(gen, (b, s, kvh, d), dtype, device)
    v = _normal(gen, (b, s, kvh, d), dtype, device)
    fn = functools.partial(ops.flash_attention, causal=True,
                           block_q=block_q, block_k=block_k)
    return _timed(fn, q, k, v)


@task(result_titles=RESULT_TITLES, hardness=_hard("ssd_scan"),
      sim_duration=_simdur("ssd_scan"))
def measure_ssd_scan(b, s, h, p, g, n, dtype, chunk, device="cuda"):
    cell = dict(b=b, s=s, h=h, p=p, g=g, n=n, dtype=dtype, chunk=chunk)
    _check("ssd_scan", cell)
    import torch

    from repro_torch.kernels import ops

    gen = _gen(device)
    x = _normal(gen, (b, s, h, p), dtype, device)
    dt = torch.nn.functional.softplus(
        _normal(gen, (b, s, h), "float32", device))
    A = -torch.exp(_normal(gen, (h,), "float32", device) * 0.3)
    Bm = _normal(gen, (b, s, g, n), dtype, device)
    Cm = _normal(gen, (b, s, g, n), dtype, device)
    fn = functools.partial(ops.ssd_scan, chunk=chunk)
    return _timed(fn, x, dt, A, Bm, Cm)


@task(result_titles=RESULT_TITLES, hardness=_hard("decode_attention"),
      sim_duration=_simdur("decode_attention"))
def measure_decode_attention(b, sk, h, kvh, d, dtype, block_k,
                             device="cuda"):
    cell = dict(b=b, sk=sk, h=h, kvh=kvh, d=d, dtype=dtype,
                block_k=block_k)
    _check("decode_attention", cell)
    from repro_torch.kernels import ops

    gen = _gen(device)
    q = _normal(gen, (b, h, d), dtype, device)
    k = _normal(gen, (b, sk, kvh, d), dtype, device)
    v = _normal(gen, (b, sk, kvh, d), dtype, device)
    fn = functools.partial(ops.decode_attention, block_k=block_k)
    return _timed(fn, q, k, v, _kv_len(b, sk, device))


@task(result_titles=RESULT_TITLES,
      hardness=_hard("decode_attention_paged"),
      sim_duration=_simdur("decode_attention_paged"))
def measure_decode_attention_paged(b, sk, kvh, g, d, dtype, page_size,
                                   device="cuda"):
    cell = dict(b=b, sk=sk, kvh=kvh, g=g, d=d, dtype=dtype,
                page_size=page_size)
    _check("decode_attention_paged", cell)
    import torch

    from repro_torch.kernels import ops

    w = -(-sk // page_size)                 # pages per slot
    n_pages = b * w
    gen = _gen(device)
    q = _normal(gen, (b, kvh * g, d), dtype, device)
    k_pool = _normal(gen, (n_pages, page_size, kvh, d), dtype, device)
    v_pool = _normal(gen, (n_pages, page_size, kvh, d), dtype, device)
    # each slot owns a contiguous page run: the geometry's cost is the
    # question here, shuffled tables are the serving tests'
    page_table = torch.arange(n_pages, dtype=torch.int32,
                              device=device).reshape(b, w)
    return _timed(ops.decode_attention_paged, q, k_pool, v_pool,
                  page_table, _kv_len(b, sk, device))


MEASURE_TASKS = {
    "flash_attention": measure_flash_attention,
    "ssd_scan": measure_ssd_scan,
    "decode_attention": measure_decode_attention,
    "decode_attention_paged": measure_decode_attention_paged,
}


def measure_cell(kernel: str, cell: dict):
    """Measure one fully-specified cell inline (the tuner's incumbent
    measurement) — same code path as the sweep tasks."""
    return MEASURE_TASKS[kernel].fn(**cell)


__all__ = ["MEASURE_TASKS", "measure_cell", "RESULT_TITLES",
           "MEASURE_ITERS", "measure_flash_attention", "measure_ssd_scan",
           "measure_decode_attention", "measure_decode_attention_paged"]
