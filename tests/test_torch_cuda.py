"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with CUDA and ``nvcc`` (the kernels build at first
use); skips elsewhere.  Imports no JAX, so it runs where the JAX package is
not installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

fp32 atol = rtol = 1e-4 (the kernels sum in another order than the plain
versions); bf16 atol = rtol = 5e-2 (the JAX package's bound).
"""
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=5e-2, rtol=5e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,K,D,Dv,causal,q_offset", [
    (2, 128, 128, 15, 5, 64, 64, True, 0),     # smollm heads
    (2, 77, 77, 6, 2, 64, 64, True, 0),        # ragged S
    (1, 40, 200, 8, 2, 128, 128, True, 160),   # chunk at the end (q_offset)
    (2, 64, 96, 4, 1, 32, 32, False, 0),       # full attention, MQA
    (1, 50, 50, 4, 4, 48, 32, True, 0),        # D != Dv
])
def test_flash_kernel_matches_plain(cuda, dtype, B, Sq, Sk, H, K, D, Dv,
                                    causal, q_offset):
    q = _rand(cuda, (B, Sq, H, D), dtype)
    k = _rand(cuda, (B, Sk, K, D), dtype)
    v = _rand(cuda, (B, Sk, K, Dv), dtype)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    want = fa.flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,K", [(15, 5), (4, 4), (8, 1)])
def test_decode_kernel_matches_plain_and_skips_dead_tail(cuda, dtype, H, K):
    B, Sk, D = 5, 300, 64
    q = _rand(cuda, (B, H, D), dtype)
    k = _rand(cuda, (B, Sk, K, D), dtype)
    v = _rand(cuda, (B, Sk, K, D), dtype)
    kv_len = torch.tensor([1, 300, 33, 129, 255], dtype=torch.int32,
                          device="cuda")
    got = da.decode_attention(q, k, v, kv_len)
    want = da.decode_attention_plain(q, k, v, kv_len)
    dead = torch.arange(Sk, device="cuda")[None, :] >= kv_len[:, None]
    k[dead], v[dead] = 1e4, 1e4
    poisoned = da.decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.equal(poisoned, got)


def test_decode_kernel_zero_length_gives_zero(cuda):
    q = _rand(cuda, (2, 4, 32), torch.float32)
    k = _rand(cuda, (2, 16, 2, 32), torch.float32)
    out = da.decode_attention(q, k, k, torch.tensor([0, 16], dtype=torch.int32,
                                                    device="cuda"))
    torch.cuda.synchronize()
    assert torch.equal(out[0], torch.zeros_like(out[0]))


def test_kernels_raise_on_what_they_do_not_take(cuda):
    q = _rand(cuda, (1, 8, 2, 40), torch.float32)      # D=40 not built
    with pytest.raises(ValueError, match="not in"):
        fa.flash_attention(q, q, q)
    q16 = q.half()
    with pytest.raises(TypeError):
        fa.flash_attention(q16, q16, q16)
    qd = _rand(cuda, (1, 18, 64), torch.float32)        # G = 9 > 8
    kd = _rand(cuda, (1, 8, 2, 64), torch.float32)
    with pytest.raises(ValueError, match="H // K"):
        da.decode_attention(qd, kd, kd, torch.ones(1, dtype=torch.int32,
                                                   device="cuda"))
    kt = _rand(cuda, (1, 2, 8, 64), torch.float32).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention(qd[:, :4], kt, kt, torch.ones(
            1, dtype=torch.int32, device="cuda"))
