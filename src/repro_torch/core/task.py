"""AbstractTask — the researcher-facing task interface (paper §example).

Subclasses provide parameters / hardness / run / result titles; the
framework owns ordering, assignment, timeout and the domino effect.
"""
from __future__ import annotations

from repro_torch.core.hardness import Hardness


def filter_out(titles, excluded):
    return tuple(t for t in titles if t not in excluded)


class AbstractTask:
    """Subclass and override. A task must be picklable (it crosses process
    boundaries to workers and, serialized, to the backup server)."""

    Hardness = Hardness

    # --- identity / reporting ------------------------------------------
    def parameter_titles(self) -> tuple:
        raise NotImplementedError

    def parameters(self) -> tuple:
        raise NotImplementedError

    def result_titles(self) -> tuple:
        raise NotImplementedError

    # --- hardness -------------------------------------------------------
    def hardness_parameters(self) -> tuple:
        """Subset of parameters that correlates with execution time."""
        raise NotImplementedError

    def hardness(self) -> Hardness:
        # cached: hardness parameters are immutable for a task's lifetime
        # and hot paths (assignment scans, domino checks, timeout sweeps)
        # ask repeatedly
        h = getattr(self, "_hardness", None)
        if h is None:
            h = self.Hardness(tuple(self.hardness_parameters()))
            self._hardness = h
        return h

    # --- execution -------------------------------------------------------
    def run(self) -> tuple:
        """Execute; return the tuple matching result_titles()."""
        raise NotImplementedError

    def timeout(self) -> float | None:
        """Per-task deadline in seconds (None = no deadline)."""
        return None

    # --- grouping (min_group_size retention) ------------------------------
    def group_parameter_titles(self) -> tuple:
        return filter_out(self.parameter_titles(), ("id",))

    def group_key(self) -> tuple:
        titles = self.parameter_titles()
        params = self.parameters()
        gset = set(self.group_parameter_titles())
        return tuple(
            v for t, v in zip(titles, params, strict=False) if t in gset)
