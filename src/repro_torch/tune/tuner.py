"""Kernel autotuning of the port driven through the ``Experiment`` facade.

The sweep over the Hopper kernels' configs is just another parameter-space
exploration, so it runs through the port's own copy of the machinery the
paper built for them (``repro_torch.core``):

* the grid is a ``ParamSpace`` (``repro_torch.tune.space``), hardness =
  the roofline predicted cost on an H100 (a total order — the JobPruner
  shape);
* every config is a ``@task`` (``repro_torch.tune.runner``) with
  ``timeout = k x incumbent``, so the paper's timeout/domino rule prunes
  configs that cannot beat the incumbent — on ``engine="sim"`` the
  virtual runtime *is* the predicted cost, so pruning costs the host
  nothing and the survivors are measured in this process; on
  ``engine="local"`` the timeout is wall-clock and kills the measurement
  process for real;
* ``budget_cap=`` flows straight into ``BudgetPolicy``/``CostMeter``,
  and the per-config attributed cost comes back on the results table;
* the winner is persisted into the :mod:`repro_torch.tune.cache` store,
  which ``kernels/ops.py`` consults at dispatch — every later call on this
  route and shape bucket picks the tuned config up.

CUDA and ``fork``: the LocalEngine forks its client processes and each
client forks a worker per task; a parent that has initialised CUDA hands
every forked child a dead context.  So with ``engine="local"`` the parent
stays CUDA-free until the sweep is over: it builds the kernels' library
first (``nvcc`` only: no worker compiles or races to build), measures the
incumbent in a *spawned* process, and names the card (the cache key's
route) only after the sweep.  Each worker then initialises CUDA itself.
"""
from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field

from repro_torch.core.experiment import Experiment
from repro_torch.core.scheduler import DONE, PRUNED, TIMED_OUT
from repro_torch.core.space import ParamSpace
from repro_torch.tune import cache as _cache
from repro_torch.tune import runner as _runner
from repro_torch.tune import space as _space

# wall-clock slack added to local-engine timeouts: a forked worker pays for
# its CUDA context, the kernels' library load and its first launch before
# its first sample, which the incumbent's measurement had behind it (torch
# is imported before the fork).  On an NVIDIA H100 80GB HBM3 that start
# takes well under a second, most of it the CUDA context; chip_smoke.py's
# tune phase measures it and fails if it ever exceeds this margin
LOCAL_COMPILE_MARGIN_S = 5.0
# seconds the spawned incumbent measurement may take (a fresh interpreter
# imports torch and starts CUDA before it measures)
INCUMBENT_TIMEOUT_S = 300.0


@dataclass
class TuneReport:
    """Typed outcome of one tuning sweep."""

    kernel: str
    backend: str
    dtype: str
    shape: dict
    shape_bucket: str
    engine: str
    k_timeout: float
    timeout_s: float
    explored: int                    # grid cells submitted
    measured: int                    # DONE: actually run + timed
    timed_out: int
    pruned: int                      # domino-pruned, never ran
    default_config: dict
    default_us: float
    best_config: dict
    best_us: float
    speedup: float                   # default_us / best_us (>= 1.0)
    pruned_fraction: float           # (pruned + timed_out) / explored
    budget_cap: float | None
    cost_total: float | None         # CostMeter total for the sweep
    under_cap: bool | None           # None when no cap was set
    cache_path: str | None
    cache_key: str | None
    elapsed_s: float
    configs: list = field(default_factory=list)   # per-config records

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=float)

    def summary(self) -> str:
        cap = ("n/a" if self.budget_cap is None else
               f"{self.cost_total:.2f}/{self.budget_cap:.0f} "
               f"({'under' if self.under_cap else 'OVER'} cap)")
        return (f"{self.kernel:24s} [{self.backend}/{self.dtype}] "
                f"{self.shape_bucket}: best={self.best_config} "
                f"{self.best_us:.1f}us vs default {self.default_us:.1f}us "
                f"({self.speedup:.2f}x) | explored={self.explored} "
                f"measured={self.measured} timed_out={self.timed_out} "
                f"pruned={self.pruned} | cost {cap}")


def _config_of(cell: dict, tunables: tuple) -> dict:
    return {k: cell[k] for k in tunables}


def _measure_entry(kernel: str, cell: dict, q) -> None:
    """Spawned-subprocess target: measure one cell, ship the result back."""
    from repro_torch.tune import runner

    q.put(runner.measure_cell(kernel, cell))


def _measure_incumbent(kernel: str, cell: dict, engine: str):
    """Measure the incumbent config.  On ``engine="local"`` this runs in a
    *spawned* subprocess, so this process stays CUDA-free for the forks
    that follow (see the module docstring)."""
    if engine != "local":
        return _runner.measure_cell(kernel, cell)
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=_measure_entry, args=(kernel, cell, q))
    p.start()
    try:
        result = q.get(timeout=INCUMBENT_TIMEOUT_S)
    finally:
        p.join(timeout=10.0)
        if p.is_alive():
            p.kill()
    return result


def tune(kernel: str, *, shape: dict | None = None, dtype: str = "float32",
         engine: str = "sim", k_timeout: float = 4.0,
         budget_cap: float | None = None, max_clients: int = 2,
         smoke: bool = False, adversarial: int = 0, seed: int = 0,
         cache_path: str | None = None, store: bool = True,
         device: str = "cuda") -> TuneReport:
    """Tune one kernel on ``device`` and (optionally) persist the winner.

    ``engine="sim"`` runs the sweep on the simulator: virtual runtimes
    are the predicted costs, so timeout/domino pruning is decided by the
    cost model and only surviving configs are actually measured, in this
    process.  ``engine="local"`` runs each measurement in a worker process
    (one a client, so one client's measurements never overlap) under a
    real wall-clock timeout.  ``adversarial`` injects that many seeded
    runnable-but-bad values per knob (the CPU tests use this to prove the
    domino rule fires).  ``store=False`` skips cache persistence.
    ``device`` is the card (``cuda``) unless the caller asks for ``cpu``,
    whose plain versions ignore the tiles.
    """
    t_wall = time.time()
    if kernel not in _space.SPECS:
        raise ValueError(
            f"unknown kernel {kernel!r}; tunable kernels: "
            f"{sorted(_space.SPECS)}")
    spec = _space.SPECS[kernel]
    shape = dict(shape or (spec.smoke_shape if smoke else spec.full_shape))
    cache = (_cache.TuneCache(cache_path) if cache_path is not None
             else _cache.get_cache())
    if device != "cpu":
        from repro_torch.kernels import cuda_build

        cuda_build.build()

    # ---- incumbent: the current dispatch default ----------------------
    default_config = spec.default_config(shape)
    default_cell = {**shape, "dtype": dtype, **default_config,
                    "device": device}
    default_us, _, _ = _measure_incumbent(kernel, default_cell, engine)

    # ---- the sweep, through the facade --------------------------------
    sp = _space.build_space(kernel, shape, dtype=dtype,
                            adversarial=adversarial, seed=seed)
    sp = ParamSpace({**sp.axes, "device": (device,)})
    if engine == "sim":
        # virtual seconds: timeout is k x the incumbent's *predicted*
        # cost, in the same unit as every task's sim_duration
        timeout_s = k_timeout * _space.sim_duration_s(kernel, default_cell)
    else:
        timeout_s = k_timeout * default_us / 1e6 + LOCAL_COMPILE_MARGIN_S
    tasks = sp.bind(_runner.MEASURE_TASKS[kernel]).tasks(timeout=timeout_s)
    # easiest-first, the paper's execution order for the domino rule
    tasks.sort(key=lambda t: t.hardness_parameters())

    exp = Experiment(tasks, engine=engine, max_clients=max_clients,
                     budget_cap=budget_cap,
                     **({"engine_cfg": {"n_workers_per_client": 1}}
                        if engine == "local" else {}))
    with exp.run() as run:
        table = run.results()
    backend = _cache.dispatch_backend(device)

    # ---- results ------------------------------------------------------
    titles = table.parameter_titles
    tunables = spec.tunable_names
    configs = []
    best_us, best_config = default_us, dict(default_config)
    n_done = n_pruned = n_timed = 0
    for i, (params, result, status) in enumerate(table.rows):
        cell = dict(zip(titles, params, strict=True))
        cell.pop("device")
        cfg = _config_of(cell, tunables)
        row_cost = (table.row_costs[i]
                    if table.row_costs is not None else None)
        rec = {"config": cfg, "status": status,
               "predicted_us": round(
                   _space.predicted_cost_us(kernel, cell), 3),
               "cost": row_cost}
        if status == DONE and result is not None:
            n_done += 1
            rt = float(result[0])
            rec["runtime_us"] = round(rt, 3)
            if rt < best_us:
                best_us, best_config = rt, cfg
        elif status == TIMED_OUT:
            n_timed += 1
        elif status == PRUNED:
            n_pruned += 1
        configs.append(rec)

    cost_total = (table.cost or {}).get("total")
    under_cap = (None if budget_cap is None
                 else (cost_total is not None and cost_total <= budget_cap))
    cache_key = None
    if store and cache.path:
        cache_key = cache.store(
            kernel, shape, dtype, backend, best_config,
            runtime_us=best_us, default_us=default_us,
            meta={"engine": engine, "explored": len(tasks),
                  "pruned": n_pruned, "timed_out": n_timed})
    explored = len(tasks)
    return TuneReport(
        kernel=kernel, backend=backend, dtype=dtype, shape=shape,
        shape_bucket=_cache.shape_bucket(shape), engine=engine,
        k_timeout=k_timeout, timeout_s=timeout_s, explored=explored,
        measured=n_done, timed_out=n_timed, pruned=n_pruned,
        default_config=dict(default_config), default_us=default_us,
        best_config=best_config, best_us=best_us,
        speedup=(default_us / best_us if best_us > 0 else 1.0),
        pruned_fraction=((n_pruned + n_timed) / explored
                         if explored else 0.0),
        budget_cap=budget_cap, cost_total=cost_total, under_cap=under_cap,
        cache_path=(cache.path or None) if store else None,
        cache_key=cache_key, elapsed_s=round(time.time() - t_wall, 3),
        configs=configs,
    )


def tune_all(kernels=None, **kw) -> list[TuneReport]:
    """Tune several kernels with shared options (CLI ``--kernel all``)."""
    return [tune(k, **kw) for k in (kernels or sorted(_space.SPECS))]


__all__ = ["tune", "tune_all", "TuneReport", "LOCAL_COMPILE_MARGIN_S"]
