"""Declarative parameter spaces — the researcher-facing front half of the
unified experiment API.

The paper's workflow is "write nested loops that build Task objects"; this
module replaces the loops with a declarative grid:

    space = ParamSpace.grid(
        alg=axis(["brute", "bnb", "bnb+h"], hardness=lambda v: RANK[v]),
        n_tasks=axis(range(2, 9), hardness="asc"),
        n_agents=axis(lambda c: range(c["n_tasks"], 9), hardness="asc"),
        id=range(3),
    )

    @task(result_titles=("optimal", "nodes"), timeout=5.0)
    def solve(alg, n_tasks, n_agents, id):
        ...
        return optimal, nodes

    tasks = space.bind(solve).tasks()      # full AbstractTask objects

Axes declare their **hardness direction** (``"asc"``: larger value ==
longer runtime, ``"desc"``: the opposite, or a callable mapping the value
to a monotone rank) so the domino-pruning partial order is derived from
the spec instead of hand-written per Task subclass.  Axes may be
**conditional** (``when=`` predicate over the earlier axes of the cell)
or **dependent** (a callable domain producing the axis values from the
earlier axes of the cell).
"""
from __future__ import annotations

import functools
import importlib
from dataclasses import dataclass

from repro_torch.core.task import AbstractTask, filter_out

_DIRECTIONS = ("asc", "desc")


@dataclass(frozen=True)
class Axis:
    """One grid dimension.  ``values`` is an iterable, or a callable
    ``cell -> iterable`` for domains that depend on earlier axes.
    ``hardness`` declares the axis' monotone relation to runtime
    (``"asc"`` / ``"desc"`` / callable / None = not a hardness axis).
    ``when`` (predicate over the partial cell) gates the axis: inactive
    cells take ``default`` and do not multiply the grid."""

    values: object
    hardness: object = None
    when: object = None
    default: object = None

    def __post_init__(self):
        if self.hardness is not None and self.hardness not in _DIRECTIONS \
                and not callable(self.hardness):
            raise ValueError(
                f"hardness must be 'asc', 'desc' or a callable, "
                f"got {self.hardness!r}")

    def domain(self, cell: dict) -> tuple:
        vals = self.values(cell) if callable(self.values) else self.values
        return tuple(vals)

    def hardness_of(self, value, cell: dict):
        """Monotone hardness component for ``value`` (None if this axis
        does not participate in the partial order)."""
        if self.hardness is None:
            return None
        dom = self.domain(cell)
        if value not in dom:
            # conditional default outside the domain: easier than every
            # declared value, uniformly (callables only ever see declared
            # values, so a {value: rank} mapping need not handle it)
            return float("-inf")
        if callable(self.hardness):
            return self.hardness(value)
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            return value if self.hardness == "asc" else -value
        if callable(self.values):
            # a per-cell domain gives the same value different ranks in
            # different cells — the partial order would be inconsistent
            raise ValueError(
                "rank-based hardness ('asc'/'desc') on a dependent "
                "(callable) domain with non-numeric values is ambiguous; "
                "pass hardness=<callable mapping value -> rank> instead")
        rank = dom.index(value)
        return rank if self.hardness == "asc" else -rank


def axis(values, hardness=None, when=None, default=None) -> Axis:
    """Declare a grid axis (see ``Axis``)."""
    return Axis(values, hardness=hardness, when=when, default=default)


def _as_axis(spec) -> Axis:
    if isinstance(spec, Axis):
        return spec
    if not isinstance(spec, (str, bytes)) \
            and (callable(spec) or hasattr(spec, "__iter__")):
        return Axis(spec)
    return Axis((spec,))        # scalar: a fixed single-value axis


class ParamSpace:
    """An ordered set of named axes; iterating yields cells (dicts)."""

    def __init__(self, axes: dict, factory: TaskFactory | None = None):
        if not axes:
            raise ValueError("ParamSpace needs at least one axis")
        self.axes: dict[str, Axis] = {n: _as_axis(a) for n, a in axes.items()}
        self.factory = factory
        self._expanded: list[dict] | None = None   # cells() cache

    @classmethod
    def grid(cls, **axes) -> ParamSpace:
        """Build a space from keyword axes; declaration order is the
        nesting order (first axis is the outermost loop) and the
        parameter-title order of the generated tasks."""
        return cls(axes)

    # ------------------------------------------------------------------
    @property
    def names(self) -> tuple:
        return tuple(self.axes)

    def _expand(self) -> list[dict]:
        """The grid, expanded once per space and cached (axes are frozen
        after construction, so the expansion never changes)."""
        if self._expanded is None:
            cells = [{}]
            for name, ax in self.axes.items():
                nxt = []
                for cell in cells:
                    if ax.when is not None and not ax.when(cell):
                        nxt.append({**cell, name: ax.default})
                        continue
                    for v in ax.domain(cell):
                        nxt.append({**cell, name: v})
                cells = nxt
            self._expanded = cells
        return self._expanded

    def cells(self) -> list[dict]:
        return [dict(c) for c in self._expand()]   # caller-owned copies

    def __iter__(self):
        return iter(self.cells())

    def __len__(self):
        return len(self._expand())

    # ------------------------------------------------------------------
    def hardness_titles(self) -> tuple:
        return tuple(n for n, ax in self.axes.items()
                     if ax.hardness is not None)

    def hardness_of(self, cell: dict) -> tuple:
        """The cell's hardness tuple — one monotone component per axis
        that declared a hardness direction, in axis order."""
        out = []
        for name, ax in self.axes.items():
            h = ax.hardness_of(cell[name], cell)
            if h is not None:
                out.append(h)
        return tuple(out)

    # ------------------------------------------------------------------
    def bind(self, factory) -> ParamSpace:
        """Attach a ``@task``-decorated function (or plain callable) the
        cells will be run through; returns a new bound space."""
        if not isinstance(factory, TaskFactory):
            factory = task(factory)
        return ParamSpace(dict(self.axes), factory=factory)

    def tasks(self, factory=None, timeout=None) -> list:
        """Materialize one ``AbstractTask`` per cell.

        ``timeout`` overrides the factory's per-cell deadline (scalar or
        ``callable(cell)``); the resolved float is baked into each task so
        tasks stay picklable regardless of where the override came from.
        """
        factory = factory or self.factory
        if factory is None:
            raise ValueError("unbound space: pass a @task function or "
                             "call .bind(fn) first")
        if not isinstance(factory, TaskFactory):
            factory = task(factory)
        out = []
        for cell in self._expand():
            hardness = factory.resolve_hardness(cell, self)
            t = factory.resolve_timeout(cell) if timeout is None \
                else (timeout(cell) if callable(timeout) else timeout)
            if t is not None and not hardness:
                raise ValueError(
                    "a timeout needs a hardness order to prune against: "
                    "declare hardness= on at least one axis (or on @task)")
            out.append(FunctionTask(
                factory=factory,
                cell=cell,
                hardness_values=hardness,
                timeout=t,
                sim_duration=factory.resolve_sim_duration(cell),
            ))
        return out


# ---------------------------------------------------------------------------
# the @task decorator
# ---------------------------------------------------------------------------
def _load_factory(module: str, qualname: str):
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    if not isinstance(obj, TaskFactory):
        raise TypeError(f"{module}.{qualname} is not a @task function")
    return obj


class TaskFactory:
    """A plain function elevated to a task template (see ``task``).

    Instances pickle by reference (module + qualname), exactly like
    functions do — define ``@task`` functions at module level when tasks
    must cross process boundaries (LocalEngine workers, backup
    snapshots)."""

    def __init__(self, fn, result_titles=None, timeout=None,
                 sim_duration=None, hardness=None, group_by=None):
        functools.update_wrapper(self, fn)
        self.fn = fn
        self.result_titles = tuple(result_titles) if result_titles else None
        self.timeout = timeout
        self.sim_duration = sim_duration
        self.hardness = hardness        # callable(cell) -> tuple override
        self.group_by = tuple(group_by) if group_by else None

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)

    def __reduce__(self):
        return (_load_factory, (self.__module__, self.__qualname__))

    # --- per-cell resolution (called at build time by ParamSpace) -----
    @staticmethod
    def _resolve(spec, cell):
        return spec(**cell) if callable(spec) else spec

    def resolve_timeout(self, cell):
        return self._resolve(self.timeout, cell)

    def resolve_sim_duration(self, cell):
        return self._resolve(self.sim_duration, cell)

    def resolve_hardness(self, cell, space: ParamSpace) -> tuple:
        if self.hardness is not None:
            return tuple(self.hardness(**cell))
        return space.hardness_of(cell)


def task(fn=None, *, result_titles=None, timeout=None, sim_duration=None,
         hardness=None, group_by=None):
    """Decorator: turn a plain function into a task template.

    The function's keyword arguments are the space's axis names; its
    return value is the result tuple (a scalar is wrapped).  Options:

    * ``result_titles`` — column names of the returned tuple,
    * ``timeout``       — per-cell deadline, scalar or ``fn(**cell)``,
    * ``sim_duration``  — virtual runtime for the simulator, scalar or
      ``fn(**cell)`` (required to run this task under ``engine="sim"``),
    * ``hardness``      — ``fn(**cell) -> tuple`` overriding the
      axis-derived hardness,
    * ``group_by``      — parameter titles forming the retention group
      (default: every title except ``id``).
    """
    def wrap(f):
        return TaskFactory(f, result_titles=result_titles, timeout=timeout,
                           sim_duration=sim_duration, hardness=hardness,
                           group_by=group_by)
    return wrap if fn is None else wrap(fn)


class FunctionTask(AbstractTask):
    """AbstractTask over a ``@task`` function and one space cell.  All
    per-cell quantities (hardness, timeout, sim duration) are resolved at
    build time, so instances are plain picklable data + a by-reference
    function."""

    def __init__(self, factory: TaskFactory, cell: dict,
                 hardness_values: tuple, timeout: float | None = None,
                 sim_duration: float | None = None):
        self._factory = factory
        self._cell = dict(cell)
        self._hard = tuple(hardness_values)
        self._timeout = timeout
        if sim_duration is not None:
            # attribute protocol of SimWorkerPool
            self.sim_duration = float(sim_duration)

    # --- identity / reporting -----------------------------------------
    def parameter_titles(self):
        return tuple(self._cell)

    def parameters(self):
        return tuple(self._cell.values())

    def result_titles(self):
        return self._factory.result_titles or ("value",)

    def hardness_parameters(self):
        return self._hard

    # --- execution -----------------------------------------------------
    def run(self):
        out = self._factory.fn(**self._cell)
        if isinstance(out, (tuple, list)):
            return tuple(out)
        return (out,)

    def timeout(self):
        return self._timeout

    def group_parameter_titles(self):
        if self._factory.group_by is not None:
            return self._factory.group_by
        return filter_out(self.parameter_titles(), ("id",))


__all__ = ["Axis", "axis", "ParamSpace", "task", "TaskFactory",
           "FunctionTask"]
