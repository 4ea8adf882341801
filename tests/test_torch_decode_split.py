"""The split-K decode kernel's plan and arithmetic, on the CPU.

``csrc/decode_attention.cu`` cuts each slot's key axis into S splits of L
keys (``split_plan``), computes an online-softmax partial (m, l, acc) per
split in 64-key rounds, and merges the partials in split order.  The CUDA
kernel runs only on the card (``tests/test_torch_cuda.py``); here a small
torch model of that arithmetic, kept in this file, is held against the JAX
package's ``decode_attention_ref`` and the port's ``decode_attention_plain``
on the same numpy inputs, in fp32 to 2e-5 (the JAX tests' own fp32 bound:
the splits sum in another order).  The JAX reference gives NaN at
kv_len = 0, so it is compared only where kv_len >= 1; the model, like the
kernel, gives 0 there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread a process: pytest-xdist's workers share the host's
# cores, and each would otherwise start a pool as wide as the host
torch.set_num_threads(1)

from repro.kernels.ref import decode_attention_ref as jax_decode_ref
from repro_torch.kernels.decode_attention import (MAX_SPLITS, SPLIT_TILE,
                                                  decode_attention_plain,
                                                  split_plan)

TOL = dict(atol=2e-5, rtol=2e-5)
TABLE_SPAN_MAX = 66     # kTableMax in csrc/decode_attention.cu


@pytest.mark.parametrize("keys,L,S", [
    (1, 64, 1), (63, 64, 1), (64, 64, 1), (1024, 64, 16), (4096, 64, 64),
    (32768, 512, 64),
])
def test_split_plan(keys, L, S):
    assert split_plan(keys) == (L, S)


def test_split_plan_is_the_least_tile_multiple_within_max_splits():
    for keys in [0, *range(1, 9000, 37), 65536, 131072]:
        L, S = split_plan(keys)
        assert L % SPLIT_TILE == 0 and 1 <= S <= MAX_SPLITS
        assert S * L >= keys and (S - 1) * L < max(keys, 1)
        smaller = L - SPLIT_TILE
        assert smaller == 0 or -(-keys // smaller) > MAX_SPLITS


def test_a_split_spans_few_table_entries():
    """A paged split's keys fall in at most (L - 1) // ps + 2 table
    entries, which the kernel stages in a fixed shared-memory array."""
    for W in (1, 2, 16, 64, 65, 257, 1000, 1024):
        for ps in (1, 2, 3, 4, 5, 7, 8, 16, 33, 64, 100, 1000):
            L, _ = split_plan(W * ps)
            assert (L - 1) // ps + 2 <= TABLE_SPAN_MAX, (W, ps)


def split_merge(q, k, v, kv_len, *, scale=None):
    """The kernel's arithmetic in torch: per split, 64-key rounds of an
    online softmax (m, l, acc); a lone split divides by its own l, more
    are weighted by exp(m - max m) and summed in split order.  kv_len = 0
    gives 0."""
    B, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    Dv, G = v.shape[3], H // K
    L, _ = split_plan(Sk)
    scale = D ** -0.5 if scale is None else scale
    out = torch.zeros(B, K, G, Dv)
    for b in range(B):
        n = min(max(int(kv_len[b]), 0), Sk)
        qb = q[b].reshape(K, G, D).float()
        parts = []
        for lo in range(0, n, L):           # live splits only
            m = torch.full((K, G), float("-inf"))
            l = torch.zeros(K, G)
            acc = torch.zeros(K, G, Dv)
            for t0 in range(lo, min(n, lo + L), SPLIT_TILE):
                t1 = min(n, lo + L, t0 + SPLIT_TILE)
                s = torch.einsum("kgd,jkd->kgj", qb, k[b, t0:t1].float()) * scale
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "kgj,jkd->kgd", p, v[b, t0:t1].float())
                m = m_new
            parts.append((m, l, acc))
        if not parts:                        # kv_len = 0
            continue
        if len(parts) == 1:                  # the split finishes itself
            m, l, acc = parts[0]
            out[b] = acc / l[..., None]
            continue
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        num, den = torch.zeros(K, G, Dv), torch.zeros(K, G)
        for m, l, acc in parts:              # split order
            w = torch.exp(m - mx)
            num = num + acc * w[..., None]
            den = den + l * w
        out[b] = num / den[..., None]
    return out.reshape(B, H, Dv)


@pytest.mark.parametrize("Sk,lens,H,K", [
    (200, [0, 1, 63, 64, 65, 200, 128, 129], 6, 2),       # L 64, S 4
    (1000, [0, 1, 63, 64, 65, 1000, 999, 640], 15, 5),    # L 64, S 16
    (5000, [0, 1, 127, 128, 129, 5000, 4999, 2560], 8, 1),  # L 128, S 40
    # chatglm3-6b's and granite-20b's groups (the kernel's caps 16 and 64)
    (1000, [0, 1, 63, 64, 65, 1000, 999, 640], 32, 2),   # G 16
    (1024, [1, 1024, 17, 300, 513, 777, 64, 1000], 48, 1),  # G 48
])
def test_split_merge_matches_references(Sk, lens, H, K):
    rng = np.random.default_rng(Sk)
    B, D = len(lens), 16
    q = rng.standard_normal((B, H, D), np.float32)
    k = rng.standard_normal((B, Sk, K, D), np.float32)
    v = rng.standard_normal((B, Sk, K, D), np.float32)
    kv_len = np.asarray(lens, np.int32)
    got = split_merge(*(torch.from_numpy(a) for a in (q, k, v, kv_len)))
    plain = decode_attention_plain(*(torch.from_numpy(a)
                                     for a in (q, k, v, kv_len)))
    ref = np.asarray(jax_decode_ref(*(jnp.asarray(a)
                                      for a in (q, k, v, kv_len))))
    live = kv_len > 0
    np.testing.assert_allclose(got.numpy()[live], ref[live], **TOL)
    np.testing.assert_allclose(got.numpy()[live], plain.numpy()[live], **TOL)
    assert not got.numpy()[~live].any()
