"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with CUDA and ``nvcc`` (the kernels build at first
use); skips elsewhere.  Imports no JAX, so it runs where the JAX package is
not installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Attention: fp32 atol = rtol = 1e-4 (the kernels sum in another order than
the plain versions); bf16 atol = rtol = 5e-2 (the JAX package's bound).
SSD scan: 2e-3 fp32 and 1e-1 bf16, the JAX package's own bound for its SSD
kernel (the chunked sums of decayed terms are reassociated).
"""
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=5e-2, rtol=5e-2)}
SSD_TOL = {torch.float32: dict(atol=2e-3, rtol=2e-3),
           torch.bfloat16: dict(atol=1e-1, rtol=1e-1)}


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
    # the bf16 tensor-core body's 64-row tiles: G 1, 3, 4, 8; row counts
    # that are not a multiple of 64; Sq < 16; q_offset > 0; every (D, Dv)
    (1, 5, 5, 3, 1, 64, 64, True, 0),          # G 3, 15 rows
    (2, 10, 10, 16, 2, 64, 64, True, 0),       # G 8, 80 rows
    (1, 13, 50, 8, 8, 128, 128, True, 37),     # G 1, Sq < 16, q_offset
    (2, 33, 100, 8, 2, 32, 32, True, 67),      # G 4, 132 rows, q_offset
    (1, 70, 70, 12, 4, 48, 32, True, 0),       # G 3, D != Dv
    (2, 100, 100, 16, 2, 128, 128, False, 0),  # G 8, full, D 128
    (1, 8, 300, 24, 3, 64, 64, True, 292),     # G 8, a chunk at the end
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
@pytest.mark.parametrize("H,K,Sk,lens,Dv", [
    (15, 5, 300, [1, 300, 33, 129, 255], 64),
    (4, 4, 300, [1, 300, 33, 129, 255], 64),
    (8, 1, 300, [1, 300, 33, 129, 255], 64),
    # split edges (L 64 at Sk 1000, L 128 at Sk 5000; neither divides Sk),
    # one batch with a kv_len = 0 slot
    (15, 5, 1000, [0, 1, 63, 64, 65, 1000, 128, 129], 64),
    (16, 2, 5000, [0, 1, 127, 128, 129, 5000, 4999, 257], 64),
    # V rows of 20 elements: not whole 16-byte pieces, copied one by one
    (6, 2, 300, [0, 1, 63, 64, 65, 300], 20),
])
def test_decode_kernel_matches_plain_and_skips_dead_tail(cuda, dtype, H, K,
                                                         Sk, lens, Dv):
    """Within tolerance of the plain version where kv_len >= 1, 0 where
    kv_len = 0, bit-identical on a second call (the split merge is
    deterministic) and with every row past kv_len poisoned."""
    B, D = len(lens), 64
    q = _rand(cuda, (B, H, D), dtype)
    k = _rand(cuda, (B, Sk, K, D), dtype)
    v = _rand(cuda, (B, Sk, K, Dv), dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = da.decode_attention(q, k, v, kv_len)
    again = da.decode_attention(q, k, v, kv_len)
    want = da.decode_attention_plain(q, k, v, kv_len)
    dead = torch.arange(Sk, device="cuda")[None, :] >= kv_len[:, None]
    k[dead], v[dead] = 1e4, 1e4
    poisoned = da.decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    live = kv_len > 0
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               **TOL[dtype])
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))
    assert torch.equal(again, got)
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
    flat = _rand(cuda, (1 + 8 * 2 * 64,), torch.bfloat16)
    shifted = flat[1:].view(1, 8, 2, 64)                # contiguous, 2 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention(shifted, shifted, shifted)
    qd = _rand(cuda, (1, 18, 64), torch.float32)        # G = 9 > 8
    kd = _rand(cuda, (1, 8, 2, 64), torch.float32)
    with pytest.raises(ValueError, match="H // K"):
        da.decode_attention(qd, kd, kd, torch.ones(1, dtype=torch.int32,
                                                   device="cuda"))
    kt = _rand(cuda, (1, 2, 8, 64), torch.float32).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention(qd[:, :4], kt, kt, torch.ones(
            1, dtype=torch.int32, device="cuda"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps", [16, 7])
@pytest.mark.parametrize("W", [12, 700])    # W * ps = 4900: L 128, not 64
def test_paged_decode_kernel_matches_plain(cuda, dtype, ps, W):
    """Shuffled table, sentinel entries past kv_len, kv_len from 1 to W*ps,
    and every row past kv_len poisoned: the output stays bit-identical and
    equals the dense kernel's on the gathered view."""
    B, H, K, D = 5, 15, 5, 64
    P = B * W + 3
    q = _rand(cuda, (B, H, D), dtype)
    kp = _rand(cuda, (P, ps, K, D), dtype)
    vp = _rand(cuda, (P, ps, K, D), dtype)
    perm = torch.randperm(P, generator=cuda, device="cuda")[:B * W]
    table = perm.reshape(B, W).int()
    kv_len = torch.tensor([1, W * ps, ps + 3, 5 * ps, 2 * ps - 1],
                          dtype=torch.int32, device="cuda")
    used = (kv_len.long() + ps - 1) // ps
    table[torch.arange(W, device="cuda")[None, :] >= used[:, None]] = P
    got = da.decode_attention_paged(q, kp, vp, table, kv_len)
    again = da.decode_attention_paged(q, kp, vp, table, kv_len)
    want = da.decode_attention_paged_plain(q, kp, vp, table, kv_len)
    kg = kp[table.clamp(max=P - 1)].reshape(B, W * ps, K, D)
    vg = vp[table.clamp(max=P - 1)].reshape(B, W * ps, K, D)
    dense = da.decode_attention(q, kg.contiguous(), vg.contiguous(), kv_len)
    dead = torch.ones((P, ps), dtype=torch.bool, device="cuda")
    for b in range(B):                   # every row no slot attends
        for j in range(int(used[b])):
            dead[table[b, j], :min(ps, int(kv_len[b]) - j * ps)] = False
    kp[dead], vp[dead] = 1e4, -1e4
    poisoned = da.decode_attention_paged(q, kp, vp, table, kv_len)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.equal(got, dense)
    assert torch.equal(again, got)
    assert torch.equal(poisoned, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,chunk,P,N,G,h0", [
    (512, 256, 64, 128, 1, False),     # full mamba2-130m head, two chunks
    (300, 128, 64, 128, 1, True),      # ragged S, h0
    (64, 32, 32, 16, 2, True),         # reduced head, two groups
    (40, 64, 32, 16, 1, False),        # chunk longer than S
])
def test_ssd_kernel_matches_plain(cuda, dtype, S, chunk, P, N, G, h0):
    B, H = 2, 4
    x = _rand(cuda, (B, S, H, P), dtype)
    dt = torch.nn.functional.softplus(_rand(cuda, (B, S, H), torch.float32))
    A = -torch.exp(0.3 * _rand(cuda, (H,), torch.float32))
    Bm = _rand(cuda, (B, S, G, N), dtype)
    Cm = _rand(cuda, (B, S, G, N), dtype)
    h = _rand(cuda, (B, H, P, N), torch.float32) if h0 else None
    before = ssd.ssd_scan.launches
    y, hT = ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h,
                         return_final_state=True)
    y_only = ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h)
    y_ref, hT_ref = ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk, h0=h,
                                       return_final_state=True)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.launches == before + 2
    assert y.dtype == dtype and hT.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_ref.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(hT, hT_ref, **SSD_TOL[dtype])
    assert torch.equal(y_only, y)


def test_new_kernels_raise_on_what_they_do_not_take(cuda):
    x = _rand(cuda, (1, 8, 2, 48), torch.float32)       # P = 48 not built
    dt = torch.ones((1, 8, 2), device="cuda")
    A = -torch.ones(2, device="cuda")
    bc = _rand(cuda, (1, 8, 1, 16), torch.float32)
    with pytest.raises(ValueError, match="not in"):
        ssd.ssd_scan(x, dt, A, bc, bc, chunk=8)
    with pytest.raises(TypeError, match="float32"):
        ssd.ssd_scan(x[..., :32].contiguous(), dt.double(), A, bc, bc, chunk=8)
    q = _rand(cuda, (1, 4, 64), torch.float32)
    pool = _rand(cuda, (4, 2, 2, 64), torch.float32)
    lens = torch.ones(1, dtype=torch.int32, device="cuda")
    wide = torch.zeros((1, 2000), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="pages per slot"):
        da.decode_attention_paged(q, pool, pool, wide, lens)
    with pytest.raises(TypeError, match="int32"):
        da.decode_attention_paged(q, pool, pool, wide[:, :2].long(), lens)
