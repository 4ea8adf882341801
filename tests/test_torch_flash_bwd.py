"""The port's differentiable flash attention on the CPU against the JAX
package's ``blockwise_attention`` and its custom VJP (``xla_flash.py``,
``_vjp_bwd``), which is what JAX trains through off the TPU.

The port's ``FlashAttention`` runs the same plumbing on the CPU as on the
card (saved lse, ``flash_attention_bwd`` with the GQA reduction, scale,
dtypes and ``q_offset``), with the plain versions in place of the kernels.
Same inputs for both packages, made with numpy from a seed.  Tolerances:
fp32 2e-5 (the attention bound of ``tests/test_kernels.py:16``), bf16 5e-2
(``tests/test_kernels.py:17``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread a process: pytest-xdist's workers share the host's
# cores, and each would otherwise start a pool as wide as the host
torch.set_num_threads(1)

from repro.kernels.xla_flash import blockwise_attention
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.grad_guard import refuse_grad
from repro_torch.kernels.ref import attention_lse_ref

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,K,D,Dv,causal,q_offset,block", [
    (2, 64, 64, 6, 2, 32, 32, True, 0, 32),     # GQA G = 3
    (1, 50, 50, 4, 2, 32, 32, True, 0, 32),     # Sk 50 not a multiple of 32
    (1, 16, 80, 4, 1, 32, 32, True, 64, 32),    # q_offset > 0 (a chunk)
    (2, 40, 56, 8, 2, 32, 32, False, 0, 32),    # non-causal
    (1, 33, 33, 6, 2, 48, 32, True, 0, 16),     # (D, Dv) = (48, 32)
])
def test_flash_vjp_matches_jax(dtype, B, Sq, Sk, H, K, D, Dv, causal,
                               q_offset, block):
    rng = np.random.default_rng(B * 1000 + Sq + Sk + H + D)
    arrs = [rng.standard_normal(s, np.float32) for s in
            ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, Dv), (B, Sq, H, Dv))]
    qj, kj, vj, dj = (jnp.asarray(a).astype(dtype) for a in arrs)
    out_j, vjp = jax.vjp(lambda q, k, v: blockwise_attention(
        q, k, v, causal, None, q_offset, block), qj, kj, vj)
    dq_j, dk_j, dv_j = vjp(dj)

    q, k, v = (torch.from_numpy(a).to(TORCH_DT[dtype]).requires_grad_()
               for a in arrs[:3])
    before = fa.flash_attention_bwd.launches
    out = fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(arrs[3]).to(TORCH_DT[dtype]))
    assert fa.flash_attention_bwd.launches == before   # the CPU runs no kernel
    for got, want in ((out, out_j), (q.grad, dq_j), (k.grad, dk_j),
                      (v.grad, dv_j)):
        assert got.dtype == TORCH_DT[dtype]
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_lse_matches_the_jax_forward_residual():
    """The lse the Function saves is JAX's ``_vjp_fwd`` residual."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s, np.float32) for s in
               ((2, 24, 6, 32), (2, 40, 2, 32), (2, 40, 2, 32)))
    _, (_, _, _, _, lse_j) = blockwise_attention.fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, None, 16, 16)
    _, lse = attention_lse_ref(*map(torch.from_numpy, (q, k, v)),
                               causal=True, q_offset=16)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j).reshape(
        lse.shape), atol=2e-5, rtol=2e-5)


def test_plain_backward_passes_gradcheck():
    """The analytic backward against finite differences, fp64, tiny size:
    GQA G = 2, causal with q_offset, D != Dv."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 5, 4, 6, dtype=torch.float64, generator=gen)
    k = torch.randn(1, 7, 2, 6, dtype=torch.float64, generator=gen)
    v = torch.randn(1, 7, 2, 3, dtype=torch.float64, generator=gen)
    inputs = tuple(t.requires_grad_() for t in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.FlashAttention.apply(a, b, c, True, 0.7, 2),
        inputs)


def test_no_grad_call_keeps_the_plain_forward():
    q = torch.randn(1, 8, 2, 32)
    out = fa.flash_attention(q, q[:, :, :1], q[:, :, :1])
    assert out.grad_fn is None
    with torch.no_grad():
        out = fa.flash_attention(q.requires_grad_(), q[:, :, :1],
                                 q[:, :, :1])
    assert out.grad_fn is None


def test_grad_guard_refuses_a_recorded_call():
    """Section 0 of the port's rule: a CUDA wrapper with no backward kernel
    refuses a call autograd would record; the guard is the same helper
    those wrappers call, tried here on CPU tensors."""
    x = torch.ones(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward .*ROADMAP"):
        refuse_grad("decode_attention", "ROADMAP item", x, None)
    with torch.no_grad():
        refuse_grad("decode_attention", "ROADMAP item", x)
    refuse_grad("decode_attention", "ROADMAP item", x.detach(), None)


def test_plain_versions_stay_differentiable_on_the_cpu():
    """On the CPU the decode kernels' plain versions are differentiable
    (only a CUDA call of those kernels refuses grad), and ``ssd_scan``
    records through its ``SSDScan`` Function, whose CPU backward is the
    plain ``ssd_scan_bwd_ref``."""
    q = torch.randn(2, 4, 8, requires_grad=True)
    kv = torch.randn(2, 6, 2, 8, requires_grad=True)
    da.decode_attention(q, kv, kv, torch.tensor([6, 3],
                                                dtype=torch.int32)).sum().backward()
    assert q.grad is not None and kv.grad is not None
    x = torch.randn(1, 8, 2, 4, requires_grad=True)
    bm = torch.randn(1, 8, 1, 4)
    y = ssd.ssd_scan(x, torch.rand(1, 8, 2) + 0.1, -torch.ones(2), bm, bm,
                     chunk=4)
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    y.sum().backward()
    assert x.grad is not None
