"""The work of each hand-written kernel, and the card it is reckoned on.

One home for the numbers that three readers reckon with: the bound of
each row of the kernel table (``chip_smoke.py``), the tuner's predicted
cost (``repro_torch.tune.space``) and the dry-run's count of a traced
step (``repro_torch.launch.dryrun``, through the kernels' ``meta``
branches, which ``record`` here).

Each ``*_work`` function gives (bytes, flops) of one call from its
tensors' shapes and dtypes: the bytes the call must move (each input read
once, each output written once) and the operations of its products.
Only a decode call reads data, its ``kv_len``: without values (None, or a
tensor on the ``meta`` device) every cache row counts as live, as
``configs.analysis.model_flops``'s decode term counts them.

The card: one NVIDIA H100 SXM, its published dense peaks.
"""
from __future__ import annotations

import contextlib
from collections import Counter

import torch

PEAK_FLOPS_BF16 = 989e12     # FLOP/s, bf16 tensor cores, dense
PEAK_FLOPS_FP32 = 67e12      # FLOP/s, fp32
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s, one direction


def peak_flops(dtype) -> float:
    """The card's peak for ``dtype`` (a torch dtype or its name): bf16's
    tensor-core rate for 16-bit types, fp32's otherwise."""
    name = str(dtype).removeprefix("torch.")
    return PEAK_FLOPS_BF16 if name in ("bfloat16", "float16") \
        else PEAK_FLOPS_FP32


def bound(dtype, n_bytes: float, n_flops: float) -> tuple[float, str]:
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and the flops over ``dtype``'s peak."""
    t_bytes = n_bytes / HBM_BW
    t_ops = n_flops / peak_flops(dtype)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def live_pairs(Sq: int, Sk: int, q_offset: int = 0,
               causal: bool = True) -> int:
    """(query, key) pairs one head attends: all Sq * Sk without the causal
    mask; with it, query t sees keys [0, t + q_offset], at most Sk (the
    closed form of summing min(Sk, max(0, t + q_offset + 1)) over t)."""
    if not causal:
        return Sq * Sk

    def below(m: int) -> int:      # sum of min(j, Sk) over j in [0, m)
        c = min(m, Sk + 1)
        return c * (c - 1) // 2 + max(0, m - c) * Sk

    a = q_offset + 1
    return below(max(0, a + Sq)) - below(max(0, a))


def flash_work(q, k, v, q_offset: int = 0, causal: bool = True,
               with_lse: bool = False) -> tuple[int, int]:
    """Bytes (inputs read once, output and the fp32 lse, ``with_lse``,
    written once) and flops of attention: 2 * (D + Dv) per live (query
    head, key) pair."""
    B, Sq, H, D = q.shape
    Sk, Dv = k.shape[1], v.shape[3]
    live = live_pairs(Sq, Sk, q_offset, causal)
    out_bytes = B * Sq * H * (Dv * q.element_size() + 4 * with_lse)
    return nbytes(q, k, v) + out_bytes, 2 * B * H * (D + Dv) * live


def flash_bwd_work(q, k, v, q_offset: int = 0,
                   causal: bool = True) -> tuple[int, int]:
    """Bytes of the backward (q, k, v, out, dout and the fp32 lse read once;
    dq, dk, dv written once) and its flops: five products per live (query
    head, key) pair, S = Q K^T, dP = dO V^T, dV = P^T dO, dQ = dS K and
    dK = dS^T Q, i.e. 2 * (3 D + 2 Dv)."""
    B, Sq, H, D = q.shape
    Sk, Dv = k.shape[1], v.shape[3]
    live = live_pairs(Sq, Sk, q_offset, causal)
    o_bytes = B * Sq * H * Dv * q.element_size()
    n_bytes = 2 * nbytes(q, k, v) + 2 * o_bytes + B * Sq * H * 4
    return n_bytes, 2 * B * H * (3 * D + 2 * Dv) * live


def _live_rows(kv_len, B: int, cap: int) -> int:
    """Rows a decode call of B slots reads: each slot's kv_len clamped to
    ``cap``, or all B * cap when the values are not known (None or
    ``meta``)."""
    if kv_len is None or kv_len.device.type == "meta":
        return B * cap
    return int(kv_len.clamp(0, cap).sum())


def decode_work(q, k, v, kv_len) -> tuple[int, int]:
    """Bytes of the live cache rows, q, kv_len and the output; flops
    2 * (D + Dv) per live (query head, key) pair."""
    B, H, D = q.shape
    K, Dv = k.shape[2], v.shape[3]
    live = _live_rows(kv_len, B, k.shape[1])
    row_bytes = K * (D + Dv) * k.element_size()
    out_bytes = B * H * Dv * q.element_size()
    return (live * row_bytes + nbytes(q, kv_len) + out_bytes,
            2 * H * (D + Dv) * live)


def paged_work(q, k_pool, v_pool, page_table, kv_len) -> tuple[int, int]:
    """Bytes of the live rows (read through the table), q, the table,
    kv_len and the output; flops 2 * (D + Dv) per live (query head, key)
    pair."""
    B, H, D = q.shape
    K, Dv = k_pool.shape[2], v_pool.shape[3]
    cap = page_table.shape[1] * k_pool.shape[1]
    live = _live_rows(kv_len, B, cap)
    row_bytes = K * (D + Dv) * k_pool.element_size()
    out_bytes = B * H * Dv * q.element_size()
    return (live * row_bytes + nbytes(q, page_table, kv_len) + out_bytes,
            2 * H * (D + Dv) * live)


def _chunk_lens(S: int, chunk: int) -> list:
    L = min(chunk, S)
    return [L] * (S // L) + ([S % L] if S % L else [])


def ssd_work(x, dt, Bm, chunk: int, h0=None) -> tuple[int, int]:
    """Bytes of x, dt, B, C, y, h0 and hT (each once); flops per (b, h,
    chunk of L tokens): C.B^T and scores.x over the L(L+1)/2 causal pairs
    (2N and 2P each), C.h and the state update (2LPN each)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[3]
    state = Bsz * H * P * N * 4
    n_bytes = (2 * nbytes(x) + nbytes(dt) + 2 * nbytes(Bm) + state
               + (state if h0 is not None else 0))
    per_bh = sum(n * (n + 1) // 2 * 2 * (N + P) + 4 * n * P * N
                 for n in _chunk_lens(S, chunk))
    return n_bytes, Bsz * H * per_bh


def ssd_bwd_work(x, dt, Bm, chunk: int, h0=None,
                 dhT=None) -> tuple[int, int]:
    """Bytes of the backward (x, dt, B, C, dy, h0 and dhT read once; dx,
    ddt, dB, dC, dA and dh0 written once) and its flops per (b, h, chunk of
    L tokens): over the L(L+1)/2 causal pairs C.B^T, dy.x^T and their uses
    in dB, dC (2N each) and dx (2P), i.e. 2 (3N + 2P); per token the state
    terms Q = dy C^T, dh B, dh^T x and h_in^T dy (2PN each)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[3]
    state = Bsz * H * P * N * 4
    n_bytes = (3 * nbytes(x) + 2 * nbytes(dt) + 4 * nbytes(Bm) + H * 8
               + (2 * state if h0 is not None else 0)
               + (state if dhT is not None else 0))
    per_bh = sum(n * (n + 1) // 2 * 2 * (3 * N + 2 * P) + 8 * n * P * N
                 for n in _chunk_lens(S, chunk))
    return n_bytes, Bsz * H * per_bh


# ---------------------------------------------------------------------------
# the dry-run's counter
# ---------------------------------------------------------------------------
class Tally:
    """Calls, bytes and flops of each kernel that a ``meta`` branch met
    while the tally was open."""

    def __init__(self):
        self.calls: Counter = Counter()
        self.bytes: Counter = Counter()
        self.flops: Counter = Counter()

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes.values())

    @property
    def total_flops(self) -> int:
        return sum(self.flops.values())

    def as_dict(self) -> dict:
        return {k: {"calls": self.calls[k], "bytes": self.bytes[k],
                    "flops": self.flops[k]} for k in sorted(self.calls)}


# the tallies open now: the meta branches run deep in a model's call tree,
# where no argument reaches them, so, as a dispatch mode is, an open tally
# is found by the calls made inside its ``counting`` block
_OPEN: list = []


@contextlib.contextmanager
def counting():
    """A fresh ``Tally`` that every ``record`` adds to until the block
    ends."""
    tally = Tally()
    _OPEN.append(tally)
    try:
        yield tally
    finally:
        _OPEN.remove(tally)


def record(kernel: str, work: tuple[int, int]) -> None:
    """Add one call of ``kernel`` doing ``work`` (bytes, flops) to every
    open tally."""
    n_bytes, n_flops = work
    for tally in _OPEN:
        tally.calls[kernel] += 1
        tally.bytes[kernel] += int(n_bytes)
        tally.flops[kernel] += int(n_flops)


def route(what: str, t: torch.Tensor) -> str:
    """The branch a kernel wrapper takes for ``t``'s device: ``cpu`` (the
    plain version), ``cuda`` (the kernel) or ``meta`` (output shapes and a
    ``record``, no computation); any other device raises."""
    kind = t.device.type
    if kind not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{what}: tensors on {kind!r}; the port dispatches "
                         "cpu (the plain version), cuda (the kernel) and "
                         "meta (shapes and the dry-run's count)")
    return kind
