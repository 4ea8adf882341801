"""Engine registry — one name -> engine factory table, so simulation and
real cloud backends are configured identically (paper: "provide an
extension class with methods to create, terminate and list compute
instances"; here the extension class also registers itself by name).

    engines.make("sim", client_workers=4, seed=1)      -> SimSpec
    engines.make("local", n_workers_per_client=2)      -> LocalEngine
    engines.make("gce", project=..., zone=..., ...)    -> GCEEngine
    engines.make("tpu", accelerator_type=..., ...)     -> TPUPodEngine

``"sim"`` returns a :class:`SimSpec` (the simulator needs a shared
virtual clock, so the Experiment facade builds the actual ``SimEngine``
inside a ``SimCluster``); every other name returns a ready
``AbstractEngine``.  Third-party backends plug in via ``register``.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.engine import GCEEngine, LocalEngine, TPUPodEngine
from repro_torch.core.sim import SimParams


@dataclass
class SimSpec:
    """Deferred simulator construction: carries the ``SimParams`` until a
    run materializes the clock + ``SimEngine`` (see ``Experiment``)."""

    params: SimParams


def _make_sim(params: SimParams | None = None, **kwargs) -> SimSpec:
    if params is not None:
        if kwargs:
            raise ValueError(
                f"pass either params=SimParams(...) or keyword fields, "
                f"not both: {sorted(kwargs)}")
        return SimSpec(params)
    return SimSpec(SimParams(**kwargs))


def _make_local(n_workers_per_client: int | None = None) -> LocalEngine:
    return LocalEngine(n_workers_per_client=n_workers_per_client)


def _make_gce(runner=None, **config) -> GCEEngine:
    return GCEEngine(config, runner=runner)


def _make_tpu(runner=None, **config) -> TPUPodEngine:
    return TPUPodEngine(config, runner=runner)


_REGISTRY: dict[str, object] = {}


def register(name: str, factory) -> None:
    """Register (or replace) an engine factory under ``name``.  The
    factory receives ``make``'s keyword config and returns an
    ``AbstractEngine`` (or a ``SimSpec``-like deferred spec)."""
    if not callable(factory):
        raise TypeError(f"engine factory for {name!r} must be callable")
    _REGISTRY[name] = factory


def names() -> list[str]:
    return sorted(_REGISTRY)


def make(name: str, **cfg):
    """Build the engine registered under ``name`` with ``cfg``."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown engine {name!r}; known engines: {names()}") from None
    return factory(**cfg)


register("sim", _make_sim)
register("local", _make_local)
register("gce", _make_gce)
register("tpu", _make_tpu)

__all__ = ["SimSpec", "register", "make", "names"]
