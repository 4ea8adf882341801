"""``repro_torch.tune`` — autotuning of the port's Hopper kernels driven
through the Experiment facade (the port's copy, ``repro_torch.core``),
with a persistent best-config cache wired into ops dispatch.

Submodules: ``space`` (per-kernel tunable grids + the H100 roofline cost
model), ``runner`` (measurement ``@task``s), ``cache`` (persistent
best-config store), ``tuner`` (the sweep orchestration), ``measure``
(timing utilities).  CLI: ``python -m repro_torch.tune --kernel
decode_attention`` (``--device cpu`` for the plain versions).

Heavy submodules load lazily: ``kernels/ops.py`` imports
``repro_torch.tune.cache`` on its dispatch path, which must not drag the
Experiment facade in behind it.
"""
from __future__ import annotations

_LAZY = {
    "tune": ("repro_torch.tune.tuner", "tune"),
    "tune_all": ("repro_torch.tune.tuner", "tune_all"),
    "TuneReport": ("repro_torch.tune.tuner", "TuneReport"),
    "TuneCache": ("repro_torch.tune.cache", "TuneCache"),
    "best_config": ("repro_torch.tune.cache", "best_config"),
    "SPECS": ("repro_torch.tune.space", "SPECS"),
    "build_space": ("repro_torch.tune.space", "build_space"),
    "predicted_cost_us": ("repro_torch.tune.space", "predicted_cost_us"),
    "retry_measurement": ("repro_torch.tune.measure", "retry_measurement"),
    "time_fn": ("repro_torch.tune.measure", "time_fn"),
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    try:
        mod, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib

    return getattr(importlib.import_module(mod), attr)
