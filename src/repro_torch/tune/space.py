"""Per-kernel tunable search spaces of the port's autotuner.

Each ported kernel declares a :class:`KernelSpec`: the shape axes that
identify a workload, the tunable knobs with their candidate values (the
Hopper kernels' real choices: template instantiations or launch
arguments), the current dispatch defaults (``kernels/ops.py`` falls back
to these on a cache miss, so they mirror the ops layer; the decode split's
depends on the shape), and a static validity predicate.  Validity is the
kernels' own tile checks (``flash_attention.tiles_ok``,
``decode_attention.split_ok`` / ``pages_ok``, ``ssd_scan.chunk_ok``),
the functions the wrappers run before a launch, so the grid holds no
config the kernel would refuse, on the CPU or on the card.

Hardness for the domino partial order is the **predicted cost**: a
roofline estimate of one call on an H100 collapsed to a single scalar,
which makes the order total (the JobPruner shape from PAPERS.md): one
config timing out prunes every config predicted to be at least as
expensive.  The same estimate drives ``sim_duration`` when the sweep runs
on the simulator engine (virtual seconds proportional to predicted
microseconds), so the paper's timeout/domino machinery applies unchanged.
"""
from __future__ import annotations

import random
from dataclasses import dataclass

import torch

from repro_torch.core.space import ParamSpace, axis
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import work as _work

# hardware model: one NVIDIA H100 SXM (``kernels/work.py``'s peaks, which
# chip_smoke.py's bounds and the dry-run use too), plus overhead terms fitted to chip_smoke.py's kernel times on an NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md, kernel table rows 1-3): the flash forward at
# smollm-360m's prefill ran 11.87 us over a bound of 1.57 (240 blocks, the
# longest walking 4 key tiles), the dense decode at B 8, Sk 1024 12.39 us
# over 1.42 (640 blocks of one tile): 240 b + 4 t = 10.30 and 640 b + t =
# 10.97 give b = 0.0145 us a block and t = 1.71 us a tile on the longest
# chain of one block; the paged decode at the same shape (512 pages of 16)
# ran 12.94 us, 0.55 us more for 512 pages: 0.00107 us a page
PEAK_FLOPS = {"bfloat16": _work.PEAK_FLOPS_BF16,       # FLOP/s
              "float32": _work.PEAK_FLOPS_FP32}
HBM_BW = _work.HBM_BW                                   # bytes/s
BLOCK_US = 0.0145            # per block of a launch
TILE_US = 1.71               # per tile step on a block's longest chain
PAGE_US = 0.00107            # per page a paged call maps

# virtual seconds per predicted microsecond when the sweep runs on the
# simulator engine.  A scale factor (timeouts are k x incumbent in the same
# unit), but it sets how long tasks run against the simulator's fixed
# instance boot and message latencies: 0.0125 puts the SSD smoke grid's
# virtual runtimes (0.2-0.4 s sane, 1.5-5.7 s pathological) where
# repro.tune's v5e model puts them, and the domino rule prunes there as in
# the reference's run (at 0.05 the three time out together, none pruned)
SIM_SECONDS_PER_US = 0.0125

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}
_KEY_TILE = _decode.SPLIT_TILE      # keys a decode or SSD tile step stages


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class KernelSpec:
    """Tunable surface of one kernel (see module docstring)."""

    name: str
    shape_axes: tuple               # ordered workload-identity fields
    smoke_shape: dict               # small CPU-test shape
    full_shape: dict                # the main path's shape
    defaults: dict                  # tunable -> default, or fn(shape) -> it
    tunables: dict                  # tunable -> candidate values
    pathological: dict              # tunable -> runnable but bad values

    @property
    def tunable_names(self) -> tuple:
        return tuple(self.tunables)

    def default_config(self, shape: dict) -> dict:
        """The dispatch default for ``shape`` (what a cache miss launches)."""
        return {k: (v(shape) if callable(v) else v)
                for k, v in self.defaults.items()}


def _decode_default(shape: dict) -> int:
    return _decode.split_plan(shape["sk"])[0]


SPECS: dict[str, KernelSpec] = {
    # tiles of the tensor-core body (bf16); the fp32 body has one
    "flash_attention": KernelSpec(
        name="flash_attention",
        shape_axes=("b", "s", "h", "kvh", "d"),
        smoke_shape={"b": 1, "s": 256, "h": 4, "kvh": 2, "d": 64},
        full_shape={"b": 4, "s": 256, "h": 15, "kvh": 5, "d": 64},
        defaults={"block_q": _flash.DEFAULT_BLOCK_Q,
                  "block_k": _flash.DEFAULT_BLOCK_K},
        tunables={"block_q": (64, 128), "block_k": (64, 128)},
        pathological={},
    ),
    "ssd_scan": KernelSpec(
        name="ssd_scan",
        shape_axes=("b", "s", "h", "p", "g", "n"),
        smoke_shape={"b": 1, "s": 512, "h": 2, "p": 32, "g": 1, "n": 16},
        full_shape={"b": 2, "s": 1024, "h": 24, "p": 64, "g": 1, "n": 128},
        defaults={"chunk": _ssd.DEFAULT_CHUNK},
        # >= 3 pathological values: with max_clients concurrent timeouts
        # at least one is still queued when the first fires, so the
        # domino rule provably prunes (not just times out) on the
        # adversarial grid
        tunables={"chunk": (32, 64, 128, 256)},
        pathological={"chunk": (2, 4, 8)},
    ),
    # block_k is L, the keys of a split; one split holding every key (L =
    # Sk) is runnable and bad
    "decode_attention": KernelSpec(
        name="decode_attention",
        shape_axes=("b", "sk", "h", "kvh", "d"),
        smoke_shape={"b": 2, "sk": 1024, "h": 4, "kvh": 2, "d": 64},
        full_shape={"b": 8, "sk": 1024, "h": 15, "kvh": 5, "d": 64},
        defaults={"block_k": _decode_default},
        tunables={"block_k": (64, 128, 256)},
        pathological={"block_k": (512, 1024)},
    ),
    "decode_attention_paged": KernelSpec(
        name="decode_attention_paged",
        shape_axes=("b", "sk", "kvh", "g", "d"),
        smoke_shape={"b": 2, "sk": 256, "kvh": 2, "g": 2, "d": 64},
        full_shape={"b": 8, "sk": 1024, "kvh": 5, "g": 3, "d": 64},
        defaults={"page_size": 16},
        tunables={"page_size": (8, 16, 32, 64, 128)},
        pathological={"page_size": (1, 2)},
    ),
}


# ---------------------------------------------------------------------------
# static validity (the kernels' own tile checks)
# ---------------------------------------------------------------------------
def valid(kernel: str, cell: dict) -> bool:
    """True iff the kernel can run the config: the same check its wrapper
    makes before a launch, so bad configs are rejected before any client
    process touches them."""
    if kernel == "flash_attention":
        return _flash.tiles_ok(cell["d"], cell.get("dv", cell["d"]),
                               cell.get("dtype", "float32"),
                               cell["block_q"], cell["block_k"])
    if kernel == "ssd_scan":
        return _ssd.chunk_ok(cell["chunk"])
    if kernel == "decode_attention":
        return _decode.split_ok(cell["sk"], cell["block_k"])
    if kernel == "decode_attention_paged":
        return _decode.pages_ok(cell["sk"], cell["page_size"])
    raise KeyError(f"unknown kernel {kernel!r} (have {sorted(SPECS)})")


# ---------------------------------------------------------------------------
# predicted cost (roofline estimate, microseconds)
# ---------------------------------------------------------------------------
def _meta(shape, dtype: str):
    """A ``meta`` tensor of ``shape`` in ``dtype`` (a name): what the work
    formulas of ``kernels/work.py`` reckon from."""
    return torch.empty(shape, dtype=getattr(torch, dtype), device="meta")


def _decode_terms(b, keys, kvh, g, d, eb, L, dtype):
    """(flops, bytes, blocks, chain) of one split-K decode call over a key
    axis of ``keys`` rows in splits of ``L``."""
    S = _ceil_div(keys, L)
    kv = _meta((b, keys, kvh, d), dtype)
    flops = _work.decode_work(_meta((b, kvh * g, d), dtype), kv, kv,
                              None)[1]
    nbytes = (2.0 * b * keys * kvh * d * eb + 2.0 * b * kvh * g * d * eb
              + (2.0 * b * kvh * S * g * (d + 2) * 4 if S > 1 else 0.0))
    return flops, nbytes, b * kvh * S, _ceil_div(L, _KEY_TILE)


def predicted_cost_us(kernel: str, cell: dict) -> float:
    """Roofline cost estimate in microseconds for one kernel call on an H100.

    compute = FLOPs / peak (the operations of ``kernels/work.py``'s
    formulas, which the kernel table's bounds and the dry-run's count
    reckon too; a decode call with every row live), memory = device
    bytes (K/V re-read per row
    block, split partials, padding waste), overhead = blocks x
    ``BLOCK_US`` + the longest serial chain of tile steps in one block x
    ``TILE_US`` (+ pages x ``PAGE_US``).  Monotone in the right
    directions: one split holding every key or tiny SSD chunks blow up the
    chain, more row blocks re-read K/V, which is what makes it a usable
    hardness ordering.
    """
    dtype = cell.get("dtype", "float32")
    eb = _DTYPE_BYTES.get(dtype, 4)
    pages = 0
    if kernel == "flash_attention":
        b, s, h, kvh, d = (cell[k] for k in ("b", "s", "h", "kvh", "d"))
        dv = cell.get("dv", d)
        nrb = _ceil_div(s * (h // kvh), cell["block_q"])   # row blocks
        kv = _meta((b, s, kvh, d), dtype)
        flops = _work.flash_work(_meta((b, s, h, d), dtype), kv,
                                 _meta((b, s, kvh, dv), dtype))[1]
        # causal: row block i reads (i + 1) / nrb of the keys
        nbytes = (b * s * h * (d + dv) * eb
                  + b * kvh * s * (d + dv) * eb * (nrb + 1) / 2)
        blocks = b * kvh * nrb
        chain = _ceil_div(s, cell["block_k"])
    elif kernel == "ssd_scan":
        b, s, h, p, g, n = (cell[k] for k in
                            ("b", "s", "h", "p", "g", "n"))
        length = min(cell["chunk"], s)
        nc = _ceil_div(s, length)
        flops = _work.ssd_work(_meta((b, s, h, p), dtype),
                               _meta((b, s, h), "float32"),
                               _meta((b, s, g, n), dtype), length)[1]
        nbytes = (2.0 * b * s * h * p * eb + 2.0 * b * s * g * n * eb
                  + b * h * nc * p * n * 4 * 2.0)         # fp32 states
        # chunk states and chunk scan: a block per (batch, head, chunk),
        # each walking its chunk's tiles; the state pass walks the chunks
        tiles = _ceil_div(length, _KEY_TILE)
        blocks = 2 * b * h * nc + (b * h if nc > 1 else 0)
        chain = 2 * tiles + (nc if nc > 1 else 0)
    elif kernel == "decode_attention":
        b, sk, h, kvh, d = (cell[k] for k in ("b", "sk", "h", "kvh", "d"))
        flops, nbytes, blocks, chain = _decode_terms(
            b, sk, kvh, h // kvh, d, eb, cell["block_k"], dtype)
    elif kernel == "decode_attention_paged":
        b, sk, kvh, g, d = (cell[k] for k in ("b", "sk", "kvh", "g", "d"))
        ps = cell["page_size"]
        w = _ceil_div(sk, ps)
        keys = w * ps                                  # padding waste
        flops, nbytes, blocks, chain = _decode_terms(
            b, keys, kvh, g, d, eb, _decode.split_plan(keys)[0], dtype)
        nbytes += 4.0 * b * w                          # the page table
        pages = b * w
    else:
        raise KeyError(f"unknown kernel {kernel!r} (have {sorted(SPECS)})")
    peak = PEAK_FLOPS.get(dtype, PEAK_FLOPS["float32"])
    return (flops / peak * 1e6 + nbytes / HBM_BW * 1e6
            + blocks * BLOCK_US + chain * TILE_US + pages * PAGE_US)


def hardness_of(kernel: str, cell: dict) -> tuple:
    """1-tuple hardness: predicted cost.  A total order — one timeout
    domino-prunes everything predicted at least as expensive."""
    return (predicted_cost_us(kernel, cell),)


def sim_duration_s(kernel: str, cell: dict) -> float:
    """Virtual runtime on the simulator engine (predicted microseconds
    scaled to virtual seconds)."""
    return predicted_cost_us(kernel, cell) * SIM_SECONDS_PER_US


# ---------------------------------------------------------------------------
# grid construction
# ---------------------------------------------------------------------------
def candidate_values(spec: KernelSpec, shape: dict, *, adversarial: int = 0,
                     seed: int = 0) -> dict:
    """Per-tunable candidate lists: the declared candidates filtered for
    static validity against ``shape`` (defaults always included), plus
    ``adversarial`` seeded draws from the pathological pool — the
    deliberately bad configs the smoke grid uses to prove the
    domino/timeout rule fires."""
    rnd = random.Random(seed)
    defaults = spec.default_config(shape)
    out = {}
    for name, cands in spec.tunables.items():
        vals = list(dict.fromkeys((defaults[name], *cands)))
        if adversarial:
            pool = list(spec.pathological.get(name, ()))
            rnd.shuffle(pool)
            vals.extend(pool[:adversarial])
        kept = []
        for v in vals:
            cell = {**shape, **defaults, name: v}
            if valid(spec.name, cell):
                kept.append(v)
        out[name] = tuple(dict.fromkeys(kept))
    return out


def build_space(kernel: str, shape: dict | None = None, *, smoke: bool = False,
                dtype: str = "float32", adversarial: int = 0,
                seed: int = 0) -> ParamSpace:
    """The sweep grid for one kernel: shape fields are fixed single-value
    axes (they appear in the results table, so every row is
    self-describing), tunables are real axes.  Cross-knob validity is
    enforced with a dependent domain on the last tunable axis, so the
    expanded grid contains no statically-invalid cell."""
    spec = SPECS[kernel]
    shape = dict(shape or (spec.smoke_shape if smoke else spec.full_shape))
    missing = [a for a in spec.shape_axes if a not in shape]
    if missing:
        raise ValueError(f"shape for {kernel} is missing axes {missing}")
    cands = candidate_values(spec, {**shape, "dtype": dtype},
                             adversarial=adversarial, seed=seed)
    axes: dict = {a: (shape[a],) for a in spec.shape_axes}
    axes["dtype"] = (dtype,)
    names = list(spec.tunable_names)
    for name in names[:-1]:
        axes[name] = axis(cands[name])
    last = names[-1]

    def _last_domain(cell, _k=kernel, _last=last, _vals=cands[last]):
        return tuple(v for v in _vals if valid(_k, {**cell, _last: v}))

    axes[last] = axis(_last_domain)
    return ParamSpace.grid(**axes)


__all__ = ["KernelSpec", "SPECS", "valid", "predicted_cost_us",
           "hardness_of", "sim_duration_s", "candidate_values",
           "build_space", "SIM_SECONDS_PER_US"]
