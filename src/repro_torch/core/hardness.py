"""Task hardness — the paper's pruning data structures.

A task's hardness is a tuple of parameter values that correlate with
execution time.  The default comparison (paper, AbstractTask): T1 is as
hard or harder than T2 iff *all* hardness parameters of T1 are >= the
corresponding parameters of T2 — a componentwise partial order.

``MinHardSet`` is the paper's ``min_hard`` list: the set of hardnesses of
timed-out tasks, "kept small by only storing the minimal elements" — i.e. a
Pareto-minimal antichain.  A task is disqualified iff its hardness
dominates (>=) any stored element.
"""
from __future__ import annotations

from bisect import bisect_left, bisect_right, insort
from dataclasses import dataclass


@dataclass(frozen=True)
class Hardness:
    values: tuple

    def geq(self, other: Hardness) -> bool:
        """self as hard or harder than other (componentwise >=).

        Raises ValueError on arity mismatch — an ``assert`` would vanish
        under ``python -O`` and silently compare truncated tuples."""
        if len(self.values) != len(other.values):
            raise ValueError(
                f"incomparable hardness arities: {len(self.values)} "
                f"vs {len(other.values)}")
        return all(a >= b
                   for a, b in zip(self.values, other.values, strict=True))

    def __le__(self, other):
        return other.geq(self)

    def __ge__(self, other):
        return self.geq(other)


# sentinel sort key: greater than every real insertion key, so
# bisect over (value, key) pairs can bracket "all entries with this value"
_KEY_MAX = float("inf")


class MinHardSet:
    """Pareto-minimal antichain of timed-out hardnesses.

    Beyond the ordered ``_items`` list (whose insertion order is part of
    the snapshot format and must stay byte-identical to the historical
    naive implementation), a *dominance index* of per-dimension sorted
    projections answers ``disqualifies``/``add`` without scanning the
    whole frontier: dimension ``d`` holds a sorted list of
    ``(value, key)`` pairs, so the stored elements with ``m[d] <= h[d]``
    form a prefix found by bisection.  ``h`` dominates a stored element
    only if every dimension's prefix is non-empty, and only the smallest
    prefix's candidates need the full componentwise check — on a frontier
    of n elements in d dimensions a query costs O(d log n + c) for c
    surviving candidates instead of O(n d).
    """

    def __init__(self):
        self._items: list[Hardness] = []
        self._rebuild_index()

    def __len__(self):
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    # -- dominance index -------------------------------------------------
    def _rebuild_index(self):
        # _keys runs parallel to _items; _by_key resolves a projection
        # entry back to its element; _proj[d] is the sorted d-th projection
        self._keys = list(range(len(self._items)))
        self._next_key = len(self._items)
        self._by_key = dict(zip(self._keys, self._items))
        if self._items:
            self._proj = [[] for _ in self._items[0].values]
            for key, m in zip(self._keys, self._items):
                for d, v in enumerate(m.values):
                    self._proj[d].append((v, key))
            for col in self._proj:
                col.sort()
        else:
            self._proj = None

    def _index_append(self, h: Hardness):
        key = self._next_key
        self._next_key += 1
        self._items.append(h)
        self._keys.append(key)
        self._by_key[key] = h
        if self._proj is None:
            self._proj = [[] for _ in h.values]
        for d, v in enumerate(h.values):
            insort(self._proj[d], (v, key))

    def _index_remove(self, doomed: set):
        for key in doomed:
            m = self._by_key.pop(key)
            for d, v in enumerate(m.values):
                col = self._proj[d]
                del col[bisect_left(col, (v, key))]
        keep = [i for i, k in enumerate(self._keys) if k not in doomed]
        self._items = [self._items[i] for i in keep]
        self._keys = [self._keys[i] for i in keep]
        if not self._items:
            self._proj = None

    def _check_arity(self, h: Hardness):
        if len(h.values) != len(self._proj):
            raise ValueError(
                f"incomparable hardness arities: {len(h.values)} "
                f"vs {len(self._proj)}")

    def _dominated_keys(self, h: Hardness) -> set:
        """Keys of stored elements m with m.geq(h) (to evict on add)."""
        hv = h.values
        best_d, best_n = 0, len(self._items) + 1
        for d, col in enumerate(self._proj):
            # suffix of entries with m[d] >= h[d]
            n = len(col) - bisect_left(col, (hv[d], -1))
            if n == 0:
                return set()
            if n < best_n:
                best_d, best_n = d, n
        col = self._proj[best_d]
        by_key = self._by_key
        return {key for _, key in col[len(col) - best_n:]
                if by_key[key].geq(h)}

    # -- public API (semantics identical to the naive list scan) ---------
    def add(self, h: Hardness) -> bool:
        """Insert h; keep only minimal elements. Returns True if h was
        retained (i.e. it was not already dominated-from-below)."""
        if self._items:
            if self.disqualifies(h):
                return False
            doomed = self._dominated_keys(h)
            if doomed:
                self._index_remove(doomed)
        self._index_append(h)
        return True

    def disqualifies(self, h: Hardness) -> bool:
        """True iff h is as hard or harder than some timed-out hardness."""
        if not self._items:
            return False
        self._check_arity(h)
        hv = h.values
        best_d, best_n = 0, len(self._items) + 1
        for d, col in enumerate(self._proj):
            # prefix of entries with m[d] <= h[d]
            n = bisect_right(col, (hv[d], _KEY_MAX))
            if n == 0:
                return False
            if n < best_n:
                best_d, best_n = d, n
        col = self._proj[best_d]
        by_key = self._by_key
        return any(h.geq(by_key[key]) for _, key in col[:best_n])

    def snapshot(self) -> list[tuple]:
        return [m.values for m in self._items]

    def restore(self, values: list[tuple]):
        self._items = [Hardness(tuple(v)) for v in values]
        self._rebuild_index()
