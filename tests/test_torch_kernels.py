"""The port's attention kernels (plain PyTorch versions on the CPU) against
the JAX package's Pallas kernels in interpret mode and its jnp oracles.

Same inputs for both packages, made with numpy from a seed.  Tolerances are
the JAX tests' own: 2e-5 in fp32, 5e-2 in bf16.  The CUDA kernels
themselves are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread a process: pytest-xdist's workers share the host's
# cores, and each would otherwise start a pool as wide as the host
torch.set_num_threads(1)

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro.kernels.ref import decode_attention_ref as jax_decode_ref
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(arr: np.ndarray, dtype: str):
    """One float32 numpy array as (jax array, torch tensor) of ``dtype``."""
    j = jnp.asarray(arr).astype(dtype)
    t = torch.from_numpy(arr).to(TORCH_DT[dtype])
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _qkv(rng, B, Sq, Sk, H, K, D, Dv, dtype):
    q = rng.standard_normal((B, Sq, H, D), np.float32)
    k = rng.standard_normal((B, Sk, K, D), np.float32)
    v = rng.standard_normal((B, Sk, K, Dv), np.float32)
    return _pair(q, dtype), _pair(k, dtype), _pair(v, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,K", [(4, 4), (6, 2), (8, 2)])   # G = 1, 3, 4
def test_flash_matches_pallas_and_ref(H, K, causal, dtype):
    rng = np.random.default_rng(H * 10 + K)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 2, 64, 64, H, K, 32, 32, dtype)
    got = flash_attention(qt, kt, vt, causal=causal)
    pallas = jax_flash(qj, kj, vj, causal=causal, block_q=32, block_k=32,
                       interpret=True)
    ref = jax_attention_ref(qj, kj, vj, causal=causal)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (2, 64, H, 32)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(ref), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_q_offset_and_d_ne_dv(dtype):
    """A 32-query chunk at the end of a 96-key context (q_offset=64) with
    head dims D=48, Dv=32 (the reduced MLA widths)."""
    rng = np.random.default_rng(7)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 2, 32, 96, 6, 2, 48, 32, dtype)
    got = flash_attention(qt, kt, vt, causal=True, q_offset=64)
    pallas = jax_flash(qj, kj, vj, causal=True, q_offset=64, block_q=32,
                       block_k=32, interpret=True)
    ref = jax_attention_ref(qj, kj, vj, causal=True, q_offset=64)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(ref), **TOL[dtype])


@pytest.mark.parametrize("Sq,Sk,q_offset", [(37, 37, 0), (13, 50, 37),
                                            (50, 50, 0)])
def test_flash_ragged_lengths(Sq, Sk, q_offset):
    """Lengths that divide no block: the port takes them (the Pallas
    wrapper asserts divisibility), held against the jnp oracle."""
    rng = np.random.default_rng(Sq + Sk)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 1, Sq, Sk, 6, 2, 32, 32,
                                        "float32")
    got = ops.flash_attention(qt, kt, vt, causal=True, q_offset=q_offset)
    ref = jax_attention_ref(qj, kj, vj, causal=True, q_offset=q_offset)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL["float32"])


def _decode_inputs(rng, B, Sk, H, K, D, dtype):
    q = rng.standard_normal((B, H, D), np.float32)
    k = rng.standard_normal((B, Sk, K, D), np.float32)
    v = rng.standard_normal((B, Sk, K, D), np.float32)
    return _pair(q, dtype), _pair(k, dtype), _pair(v, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,K", [(4, 4), (6, 2), (8, 2)])   # G = 1, 3, 4
def test_decode_matches_pallas_and_ref(H, K, dtype):
    B, Sk, D = 4, 80, 32       # Sk does not divide the Pallas block (32)
    rng = np.random.default_rng(H + K)
    (qj, qt), (kj, kt), (vj, vt) = _decode_inputs(rng, B, Sk, H, K, D, dtype)
    lens = np.array([1, 17, 64, 80], np.int32)
    got = decode_attention(qt, kt, vt, torch.from_numpy(lens))
    pallas = jax_decode(qj, kj, vj, jnp.asarray(lens), block_k=32,
                        interpret=True)
    ref = jax_decode_ref(qj, kj, vj, jnp.asarray(lens))
    assert got.shape == (B, H, D) and got.dtype == TORCH_DT[dtype]
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(ref), **TOL[dtype])


def test_decode_poisoned_tail_is_never_attended():
    B, Sk, H, K, D = 3, 50, 6, 2, 32
    rng = np.random.default_rng(3)
    (qj, qt), (kj, kt), (vj, vt) = _decode_inputs(rng, B, Sk, H, K, D,
                                                  "float32")
    lens = np.array([1, 29, 50], np.int32)
    clean = ops.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    dead = torch.arange(Sk)[None, :] >= torch.from_numpy(lens)[:, None]
    kt[dead], vt[dead] = 1e4, 1e4
    poisoned = ops.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    ref = jax_decode_ref(qj, kj, vj, jnp.asarray(lens))
    np.testing.assert_allclose(poisoned.numpy(), clean.numpy(), rtol=0,
                               atol=0)
    np.testing.assert_allclose(poisoned.numpy(), _np(ref), **TOL["float32"])


def test_wrappers_refuse_other_devices(monkeypatch):
    """Only a CPU tensor takes the plain version: a meta tensor takes the
    kernel's checks and its shape-and-count branch (a dry-run's trace),
    inputs on two devices are refused by those checks, and any device but
    cpu, cuda and meta is refused; the plain versions are never called."""
    def boom(*a, **k):
        raise AssertionError("the plain version was called")

    monkeypatch.setattr(fa, "flash_attention_plain", boom)
    monkeypatch.setattr(da, "decode_attention_plain", boom)
    q = torch.zeros((1, 4, 2, 32), device="meta")
    assert flash_attention(q, q, q).device.type == "meta"
    qd = torch.zeros((1, 2, 32), device="meta")
    kd = torch.zeros((1, 8, 2, 32), device="meta")
    lens = torch.ones(1, dtype=torch.int32, device="meta")
    assert decode_attention(qd, kd, kd, lens).device.type == "meta"
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, torch.zeros(q.shape), q)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention(qd, kd, kd, torch.ones(1, dtype=torch.int32))

    class Elsewhere:
        """A tensor on a device the port does not dispatch."""
        shape, dtype, ndim, requires_grad = q.shape, q.dtype, 4, False
        device = torch.device("xpu")

    with pytest.raises(ValueError, match="'xpu'"):
        flash_attention(Elsewhere(), Elsewhere(), Elsewhere())

