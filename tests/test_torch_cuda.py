"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with CUDA and ``nvcc`` (the kernels build at first
use); skips elsewhere.  Imports no JAX, so it runs where the JAX package is
not installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Attention: fp32 atol = rtol = 1e-4 (the kernels sum in another order than
the plain versions); bf16 atol = rtol = 5e-2 (the JAX package's bound).
SSD scan: 2e-3 fp32 and 1e-1 bf16, the JAX package's own bound for its SSD
kernel (the chunked sums of decayed terms are reassociated).  Flash
backward: fp32 1e-4; bf16 gradients no further from the fp32 plain version
than twice the bf16 plain version is (both round P and dS to bf16, at
different places), or within 5e-2 of it where that is looser.  SSD
backward: fp32 2e-3; bf16 by the same rule, with the SSD bound 1e-1.
"""
import pytest
import torch

# one intra-op thread a process: pytest-xdist's workers share the host's
# cores, and each would otherwise start a pool as wide as the host
torch.set_num_threads(1)

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
    # the full dense configs' groups at D 128: qwen3-4b G 4 at its
    # [4, 256] prefill, chatglm3-6b G 16, granite-20b G 48 (MQA), prefill
    # and a chunk at the end
    (4, 256, 256, 32, 8, 128, 128, True, 0),   # G 4, 8192 rows
    (2, 77, 77, 32, 2, 128, 128, True, 0),     # G 16, 1232 rows
    (1, 9, 200, 32, 2, 128, 128, True, 191),   # G 16, q_offset
    (2, 45, 45, 48, 1, 128, 128, True, 0),     # G 48, 2160 rows
    (1, 5, 130, 48, 1, 128, 128, True, 125),   # G 48, q_offset
    # the full MLA widths (nope 128 + rope 64, v 128), G 1: deepseek-v3's
    # [4, 256] prefill, and ragged Sq != Sk with q_offset > 0
    (4, 256, 256, 128, 128, 192, 128, True, 0),
    (2, 70, 150, 8, 8, 192, 128, True, 80),
    (1, 33, 33, 4, 2, 192, 128, False, 0),     # full, G 2
    # musicgen-medium's heads (24 of 64, G 1) at its [4, 256] prefill, and
    # phi-3-vision's (32 of 96, G 1) at its [2, 1024] prefill, in a chunk
    # at the end, ragged and full
    (4, 256, 256, 24, 24, 64, 64, True, 0),
    (2, 1024, 1024, 32, 32, 96, 96, True, 0),
    (1, 9, 200, 32, 32, 96, 96, True, 191),
    (2, 77, 77, 6, 2, 96, 96, False, 0),       # full, G 3
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,K", [(16, 16), (32, 2), (48, 1)])
@pytest.mark.parametrize("Sk,lens", [
    (1024, [1, 1024, 17, 300, 513, 777, 64, 1000]),     # ragged, L 64
    (1000, [0, 1, 63, 64, 65, 1000, 128, 129]),         # split edges
    (5000, [0, 1, 127, 128, 129, 5000, 4999, 257]),     # L 128
])
def test_decode_kernel_wide_groups(cuda, dtype, H, K, Sk, lens):
    """olmoe-1b-7b's G 1, chatglm3-6b's G 16 and granite-20b's G 48 at
    D 128 (the group caps 8, 16 and 64): within tolerance of the plain
    version, 0 at kv_len 0, bit-identical on a second call and with every
    row past kv_len poisoned."""
    B, D = len(lens), 128
    q = _rand(cuda, (B, H, D), dtype)
    k = _rand(cuda, (B, Sk, K, D), dtype)
    v = _rand(cuda, (B, Sk, K, D), dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = da.decode_attention.launches
    got = da.decode_attention(q, k, v, kv_len)
    again = da.decode_attention(q, k, v, kv_len)
    want = da.decode_attention_plain(q, k, v, kv_len)
    dead = torch.arange(Sk, device="cuda")[None, :] >= kv_len[:, None]
    k[dead], v[dead] = 1e4, 1e4
    poisoned = da.decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 3
    live = kv_len > 0
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               **TOL[dtype])
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))
    assert torch.equal(again, got)
    assert torch.equal(poisoned, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,D", [(24, 64), (32, 96)])
@pytest.mark.parametrize("Sk,lens", [
    (1024, [1, 1024, 17, 300, 513, 777, 64, 1000]),     # ragged, L 64
    (1000, [0, 1, 63, 64, 65, 1000, 128, 129]),         # split edges
])
def test_decode_kernel_modality_heads(cuda, dtype, H, D, Sk, lens):
    """musicgen-medium's heads (24 of 64) and phi-3-vision's (32 of 96),
    both G 1: within tolerance of the plain version, 0 at kv_len 0,
    bit-identical on a second call and with every row past kv_len
    poisoned; paged, equal to the dense kernel on the gathered rows."""
    B = len(lens)
    q = _rand(cuda, (B, H, D), dtype)
    k = _rand(cuda, (B, Sk, H, D), dtype)
    v = _rand(cuda, (B, Sk, H, D), dtype)
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
    _check_paged(cuda, dtype, 16, Sk // 16, H, H, D)


def test_init_params_slices_a_granite_leaf(cuda):
    """One granite-20b-shaped stacked FFN leaf [52, 6144, 24576] in bf16
    (15.7 GB) is drawn a layer at a time: the allocator's peak stays below
    the leaf plus one layer's fp32 slice (0.6 GB), where one fp32 draw of
    the whole leaf would add 29 GiB."""
    from repro_torch.models.params import Param, init_params

    shape = (52, 6144, 24576)
    leaf_bytes = 52 * 6144 * 24576 * 2
    slice_bytes = 6144 * 24576 * 4
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = init_params({"wi": Param(shape, ("layers", "embed", "ffn"),
                                   init="scaled")}, cuda, "cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    std = float(out["wi"][51, :256].float().std())
    del out
    torch.cuda.empty_cache()
    assert peak <= leaf_bytes + slice_bytes, (peak, leaf_bytes, slice_bytes)
    assert std == pytest.approx(6144 ** -0.5, rel=0.02)


def test_decode_kernel_zero_length_gives_zero(cuda):
    q = _rand(cuda, (2, 4, 32), torch.float32)
    k = _rand(cuda, (2, 16, 2, 32), torch.float32)
    out = da.decode_attention(q, k, k, torch.tensor([0, 16], dtype=torch.int32,
                                                    device="cuda"))
    torch.cuda.synchronize()
    assert torch.equal(out[0], torch.zeros_like(out[0]))


@pytest.mark.parametrize("dims,tile", sorted(
    (dims, tile) for dims, tiles in fa.TC_TILES.items() for tile in tiles
    if tile != (fa.DEFAULT_BLOCK_Q, fa.DEFAULT_BLOCK_K)))
@pytest.mark.parametrize("B,Sq,Sk,H,K,causal,q_offset", [
    (4, 256, 256, 15, 5, True, 0),      # smollm-360m's prefill, G 3
    (2, 77, 200, 8, 2, True, 123),      # ragged rows, a chunk at the end
    (1, 100, 100, 4, 4, False, 0),      # full attention, G 1
])
def test_flash_kernel_tuned_tiles_match_plain(cuda, dims, tile, B, Sq, Sk, H,
                                              K, causal, q_offset):
    """Every non-default tile of the bf16 tensor-core body (the tuner's
    ``block_q`` / ``block_k``) against the plain version, with its lse."""
    D, Dv = dims
    q = _rand(cuda, (B, Sq, H, D), torch.bfloat16)
    k = _rand(cuda, (B, Sk, K, D), torch.bfloat16)
    v = _rand(cuda, (B, Sk, K, Dv), torch.bfloat16)
    before = fa.flash_attention.launches
    got, lse = fa._forward(q, k, v, causal, None, q_offset, True, *tile)
    want, want_lse = fa.flash_attention_lse_plain(q, k, v, causal=causal,
                                                  q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])
    torch.testing.assert_close(lse, want_lse.float(), **TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [128, 256, 512, 1024])
def test_decode_kernel_tuned_splits_match_plain(cuda, dtype, L):
    """Every split the tuner's decode ``block_k`` takes at Sk 1024 (the
    default is 64), dense and paged views of the same rows; ragged lengths
    that end inside and on split edges; bit-equal on a second call."""
    B, H, K, D, Sk = 8, 15, 5, 64, 1024
    q = _rand(cuda, (B, H, D), dtype)
    k = _rand(cuda, (B, Sk, K, D), dtype)
    v = _rand(cuda, (B, Sk, K, D), dtype)
    kv_len = torch.tensor([1, 63, 64, 129, 511, 512, 1000, 1024],
                          dtype=torch.int32, device="cuda")
    got = da.decode_attention(q, k, v, kv_len, block_k=L)
    again = da.decode_attention(q, k, v, kv_len, block_k=L)
    want = da.decode_attention_plain(q, k, v, kv_len)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.equal(again, got)
    with pytest.raises(ValueError, match="no split"):
        da.decode_attention(q, k, v, kv_len, block_k=L + 32)


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
    qd = _rand(cuda, (1, 130, 64), torch.float32)       # G = 65 > 64
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
    _check_paged(cuda, dtype, ps, W, 15, 5, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,K", [(16, 16), (32, 2), (48, 1)])
@pytest.mark.parametrize("ps,W", [(16, 64), (7, 700)])
def test_paged_decode_kernel_wide_groups(cuda, dtype, H, K, ps, W):
    """The same at olmoe-1b-7b's G 1, chatglm3-6b's G 16 and granite-20b's
    G 48, D 128: the instantiations for group caps 8, 16 and 64."""
    _check_paged(cuda, dtype, ps, W, H, K, 128)


def _check_paged(cuda, dtype, ps, W, H, K, D):
    B = 5
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
@pytest.mark.parametrize("B,S,chunk,P,N,G,h0", [
    (2, 512, 256, 64, 128, 1, False),  # full mamba2-130m head, two chunks
    (2, 300, 128, 64, 128, 1, True),   # ragged S, h0
    (2, 64, 32, 32, 16, 2, True),      # reduced head, two groups
    (2, 40, 64, 32, 16, 1, False),     # chunk longer than S
    (2, 4096, 256, 64, 128, 1, False),  # 16 chunks
    (2, 1000, 100, 64, 128, 1, False),  # chunk not a multiple of 64
    (2, 1000, 100, 32, 16, 2, True),
    (8, 64, 64, 64, 128, 1, True),     # the serving prefill: one chunk, h0
    # the full jamba-v0.1-52b head: its [4, 256] prefill, the serving
    # chunk from an h0, and several chunks
    (4, 256, 256, 64, 16, 1, False),
    (8, 64, 64, 64, 16, 1, True),
    (2, 1024, 256, 64, 16, 1, False),
    (2, 300, 128, 64, 16, 1, True),    # ragged S, h0
])
def test_ssd_kernel_matches_plain(cuda, dtype, B, S, chunk, P, N, G, h0):
    H = 4
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
    y2, hT2 = ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h,
                           return_final_state=True)
    y_ref, hT_ref = ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk, h0=h,
                                       return_final_state=True)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.launches == before + 3
    assert y.dtype == dtype and hT.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_ref.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(hT, hT_ref, **SSD_TOL[dtype])
    assert torch.equal(y_only, y)
    assert torch.equal(y2, y) and torch.equal(hT2, hT)   # no atomics


def test_new_kernels_raise_on_what_they_do_not_take(cuda):
    x = _rand(cuda, (1, 8, 2, 48), torch.float32)       # P = 48 not built
    dt = torch.ones((1, 8, 2), device="cuda")
    A = -torch.ones(2, device="cuda")
    bc = _rand(cuda, (1, 8, 1, 16), torch.float32)
    with pytest.raises(ValueError, match="not in"):
        ssd.ssd_scan(x, dt, A, bc, bc, chunk=8)
    with pytest.raises(TypeError, match="float32"):
        ssd.ssd_scan(x[..., :32].contiguous(), dt.double(), A, bc, bc, chunk=8)
    off = _rand(cuda, (8 * 2 * 32 + 1,), torch.float32)[1:].view(1, 8, 2, 32)
    with pytest.raises(ValueError, match="16-byte"):        # 4 bytes off
        ssd.ssd_scan(off, dt, A, bc, bc, chunk=8)
    q = _rand(cuda, (1, 4, 64), torch.float32)
    pool = _rand(cuda, (4, 2, 2, 64), torch.float32)
    lens = torch.ones(1, dtype=torch.int32, device="cuda")
    wide = torch.zeros((1, 2000), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="pages per slot"):
        da.decode_attention_paged(q, pool, pool, wide, lens)
    with pytest.raises(TypeError, match="int32"):
        da.decode_attention_paged(q, pool, pool, wide[:, :2].long(), lens)


def _assert_bf16_rule(got, plain, plain32, tol=TOL[torch.bfloat16]):
    """The bf16 rule for gradients: no further from the fp32 plain version
    than twice the bf16 plain version is, or within ``tol`` (5e-2 for
    attention, 1e-1 for the SSD scan) of the bf16 plain version where that
    bound is the looser."""
    err = (got.float() - plain32.float()).abs().max().item()
    ref = (plain.float() - plain32.float()).abs().max().item()
    if err > 2 * ref:
        torch.testing.assert_close(got.float(), plain.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,K,D,Dv,causal,q_offset", [
    (2, 128, 128, 15, 5, 64, 64, True, 0),     # smollm heads
    (1, 1000, 1000, 6, 2, 64, 64, True, 0),    # ragged: no tile divides S
    (1, 40, 200, 8, 2, 128, 128, True, 160),   # a chunk at the end (q_offset)
    (2, 64, 96, 4, 1, 32, 32, False, 0),       # full attention, MQA
    (1, 70, 70, 12, 4, 48, 32, True, 0),       # G 3, D != Dv
    (2, 33, 100, 8, 2, 32, 32, True, 67),      # G 4, q_offset
    # the full dense configs' wide groups at D 128, as the forward's cases:
    # chatglm3-6b G 16 and granite-20b G 48 (MQA), causal from the start
    # and a chunk at the end
    (2, 77, 77, 32, 2, 128, 128, True, 0),     # G 16, 1232 rows
    (1, 9, 200, 32, 2, 128, 128, True, 191),   # G 16, q_offset
    (2, 45, 45, 48, 1, 128, 128, True, 0),     # G 48, 2160 rows
    (1, 5, 130, 48, 1, 128, 128, True, 125),   # G 48, q_offset
])
def test_flash_bwd_kernel_matches_plain(cuda, dtype, B, Sq, Sk, H, K, D, Dv,
                                        causal, q_offset):
    """The forward's lse and the backward kernel against the plain
    versions on the same residuals; fp32 at 1e-4, bf16 by the rule above;
    two calls give the same bits (no atomics)."""
    _check_flash_bwd(cuda, dtype, B, Sq, Sk, H, K, D, Dv, causal, q_offset)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D,Dv", sorted(fa.SUPPORTED_DIMS_BWD))
def test_flash_bwd_kernel_every_dims_pair(cuda, dtype, D, Dv, causal):
    """Every (D, Dv) pair the backward kernel takes, B > 1 and K > 1,
    ragged Sq != Sk (no tile divides either) and q_offset > 0."""
    _check_flash_bwd(cuda, dtype, 2, 150, 333, 6, 2, D, Dv, causal, 100)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_mla_widths_forward_only(cuda, dtype):
    """(192, 128), the MLA widths: the forward with its lse and an
    explicit scale, and since the training slice the backward too, with
    that scale, ragged Sq 40 / Sk 60 and q_offset 20."""
    q = _rand(cuda, (1, 40, 4, 192), dtype)
    k = _rand(cuda, (1, 60, 4, 192), dtype)
    v = _rand(cuda, (1, 60, 4, 128), dtype)
    kw = dict(causal=True, scale=0.1, q_offset=20)
    out, lse = fa._forward(q, k, v, True, 0.1, 20, True)
    want, want_lse = fa.flash_attention_lse_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    assert (192, 128) in fa.SUPPORTED_DIMS_BWD
    _check_flash_bwd(cuda, dtype, 1, 40, 60, 4, 4, 192, 128, True, 20,
                     scale=0.1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,K,q_offset", [
    (2, 150, 333, 6, 2, 100),    # G 3, ragged, a chunk at the end
    (1, 4095, 4095, 4, 4, 0),    # the MTP block's causal walk (S - 1)
    (2, 77, 77, 16, 16, 0),      # G 1 as deepseek-v3, ragged tails
])
def test_flash_bwd_kernel_mla_widths(cuda, dtype, B, Sq, Sk, H, K, q_offset):
    """The backward at (D, Dv) = (192, 128) (three 64-column panels for Q
    and K, one block an SM) with deepseek-v3's scale (nope + rope)**-0.5:
    fp32 within 1e-4 of the plain version, bf16 by the 2x rule, two calls
    bit-equal; tails that no 64-row tile divides, and 4,095 tokens, the
    MTP block's length at [2, 4096]."""
    _check_flash_bwd(cuda, dtype, B, Sq, Sk, H, K, 192, 128, True, q_offset,
                     scale=192 ** -0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_long_causal_walk(cuda, dtype):
    """A causal walk of 2048 rows past 2300 keys (q_offset 252): the first
    key tiles walk every row tile, so the heaviest-first order and the
    ring's reuse of its stages run many rounds."""
    _check_flash_bwd(cuda, dtype, 1, 2048, 2300, 8, 2, 64, 64, True, 252)


def _check_flash_bwd(cuda, dtype, B, Sq, Sk, H, K, D, Dv, causal, q_offset,
                     scale=None):
    q = _rand(cuda, (B, Sq, H, D), dtype)
    k = _rand(cuda, (B, Sk, K, D), dtype)
    v = _rand(cuda, (B, Sk, K, Dv), dtype)
    dout = _rand(cuda, (B, Sq, H, Dv), dtype)
    kw = dict(causal=causal, scale=scale, q_offset=q_offset)
    # the plain version's lse is a view whose layout follows the group
    # size; the kernel takes the contiguous [B, Sq, H] its forward writes
    out, lse = (t.contiguous() for t in fa.flash_attention_lse_plain(
        q, k, v, **kw))
    out_k, lse_k = fa._forward(q, k, v, causal, scale, q_offset, True)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 2
    torch.testing.assert_close(lse_k, lse, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(out_k.float(), out.float(), **TOL[dtype])
    if dtype == torch.float32:
        for g, w in zip(got, want, strict=True):
            torch.testing.assert_close(g, w, **TOL[dtype])
    else:
        f32 = [t.float() for t in (q, k, v, out, dout)]
        want32 = fa.flash_attention_bwd_plain(*f32[:4], lse, f32[4], **kw)
        for g, w, w32 in zip(got, want, want32, strict=True):
            assert g.dtype == dtype
            _assert_bf16_rule(g, w, w32)
    for g, a in zip(got, again, strict=True):
        assert torch.equal(g, a)


def test_flash_attention_is_differentiable_on_the_card(cuda):
    q = _rand(cuda, (2, 96, 6, 64), torch.bfloat16).requires_grad_()
    k = _rand(cuda, (2, 96, 2, 64), torch.bfloat16).requires_grad_()
    v = _rand(cuda, (2, 96, 2, 64), torch.bfloat16).requires_grad_()
    fwd, bwd = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    out = fa.flash_attention(q, k, v, causal=True)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == fwd + 1
    assert fa.flash_attention_bwd.launches == bwd + 1
    for t in (q, k, v):
        assert t.grad is not None and torch.isfinite(t.grad.float()).all()
        assert t.grad.abs().max() > 0


def test_kernels_without_a_backward_refuse_grad(cuda):
    q = _rand(cuda, (2, 4, 64), torch.float32).requires_grad_()
    kv = _rand(cuda, (2, 16, 2, 64), torch.float32)
    lens = torch.tensor([16, 3], dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        da.decode_attention(q, kv, kv, lens)
    table = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device="cuda")
    pool = _rand(cuda, (4, 8, 2, 64), torch.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        da.decode_attention_paged(q, pool, pool, table, lens)
    with torch.no_grad():
        da.decode_attention(q, kv, kv, lens)
    # the SSD scan has its backward kernel now: the same call records a
    # gradient through the card
    x = _rand(cuda, (1, 8, 2, 32), torch.float32).requires_grad_()
    dt = torch.ones((1, 8, 2), device="cuda")
    A = -torch.ones(2, device="cuda")
    bc = _rand(cuda, (1, 8, 1, 16), torch.float32)
    bwd = ssd.ssd_scan_bwd.launches
    ssd.ssd_scan(x, dt, A, bc, bc, chunk=8).sum().backward()
    torch.cuda.synchronize()
    assert ssd.ssd_scan_bwd.launches == bwd + 1
    assert torch.isfinite(x.grad).all() and x.grad.abs().max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,chunk,P,N,G,h0,dhT,final", [
    (2, 512, 256, 64, 128, 1, False, False, True),   # full head, dropped hT
    (2, 300, 100, 32, 16, 2, True, True, True),      # ragged S, G 2, h0, dhT
    (2, 300, 100, 64, 128, 2, True, False, True),
    (2, 1000, 100, 64, 128, 1, True, False, False),  # forward kept nc-1 slots
    (2, 1000, 100, 32, 16, 1, False, True, True),
    (2, 64, 64, 32, 16, 2, True, True, True),        # one chunk, h0, dhT
    (2, 64, 64, 64, 128, 1, True, False, True),      # one chunk, h0
    (2, 64, 64, 64, 128, 1, False, False, True),     # one chunk only
    (2, 40, 64, 32, 16, 1, False, True, True),       # chunk longer than S
    (1, 4096, 256, 64, 128, 1, False, False, True),  # 16 chunks
])
def test_ssd_bwd_kernel_matches_plain(cuda, dtype, B, S, chunk, P, N, G, h0,
                                      dhT, final):
    """The backward kernel, from the forward kernel's state scratch,
    against the plain backward (autograd through ``ssd_chunked_ref``) on
    the same inputs: fp32 within the SSD bound of the plain version
    evaluated in fp64 (the fp32 plain version's own rounding, in the
    decay gradient's long sums, is of the bound's size); bf16 dx, dB, dC,
    ddt, dA and dh0 each no further from the fp32 plain gradients than
    twice the bf16 plain version is, or within 1e-1 of it; two calls give
    the same bits (no atomics)."""
    _check_ssd_bwd(cuda, dtype, B, S, chunk, 4, P, N, G, h0, dhT, final)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,chunk,H,P,N,G,h0,dhT", [
    (2, 300, 100, 6, 64, 128, 1, True, True),    # runs of 4 and 2 heads
    (2, 300, 100, 10, 64, 128, 2, True, False),  # groups of 5: runs of 4, 1
    (1, 1000, 256, 24, 64, 128, 4, False, True),  # groups of 6: runs of 4, 2
    (2, 200, 64, 12, 32, 16, 3, False, True),    # groups of 4: one run each
    (2, 64, 64, 7, 64, 128, 7, True, True),      # a head per group, one chunk
])
def test_ssd_bwd_kernel_head_runs(cuda, dtype, B, S, chunk, H, P, N, G, h0,
                                  dhT):
    """The bf16 body sums dB and dC over runs of up to 4 heads of a group
    in one block: H / G not a multiple of 4, and runs that end at a group
    boundary, held as ``test_ssd_bwd_kernel_matches_plain`` holds them."""
    _check_ssd_bwd(cuda, dtype, B, S, chunk, H, P, N, G, h0, dhT, True)


def _check_ssd_bwd(cuda, dtype, B, S, chunk, H, P, N, G, h0, dhT, final):
    x = _rand(cuda, (B, S, H, P), dtype)
    dt = torch.nn.functional.softplus(_rand(cuda, (B, S, H), torch.float32))
    A = -torch.exp(0.3 * _rand(cuda, (H,), torch.float32))
    Bm = _rand(cuda, (B, S, G, N), dtype)
    Cm = _rand(cuda, (B, S, G, N), dtype)
    h = _rand(cuda, (B, H, P, N), torch.float32) if h0 else None
    dy = _rand(cuda, (B, S, H, P), dtype)
    dh = _rand(cuda, (B, H, P, N), torch.float32) if dhT else None
    _, _, states = ssd._forward(x, dt, A, Bm, Cm, h, chunk, final)
    before = ssd.ssd_scan_bwd.launches
    got = ssd.ssd_scan_bwd(x, dt, A, Bm, Cm, h, dy, dh, chunk=chunk,
                           states=states)
    again = ssd.ssd_scan_bwd(x, dt, A, Bm, Cm, h, dy, dh, chunk=chunk,
                             states=states)
    torch.cuda.synchronize()
    assert ssd.ssd_scan_bwd.launches == before + 2
    assert (got[5] is None) == (h is None)
    for g, a in zip(got, again, strict=True):
        assert (g is None and a is None) or torch.equal(g, a)
    if dtype == torch.float32:
        want64 = ssd.ssd_scan_bwd_plain(
            *(t.double() for t in (x, dt, A, Bm, Cm)),
            None if h is None else h.double(), dy.double(),
            None if dh is None else dh.double(), chunk=chunk)
        for g, w in zip(got, want64, strict=True):
            if w is not None:
                assert g.dtype == torch.float32
                torch.testing.assert_close(g.double(), w, **SSD_TOL[dtype])
        return
    want = ssd.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, h, dy, dh, chunk=chunk)
    f32 = [t.float() for t in (x, Bm, Cm, dy)]
    want32 = ssd.ssd_scan_bwd_plain(f32[0], dt, A, f32[1], f32[2], h, f32[3],
                                    dh, chunk=chunk)
    for g, w, w32 in zip(got, want, want32, strict=True):
        if w is not None:
            assert g.dtype == w.dtype
            _assert_bf16_rule(g, w, w32, SSD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,K,causal,q_offset", [
    (2, 150, 333, 32, 32, True, 100),   # phi-3's H = K = 32, a chunk at the end
    (1, 1000, 1000, 32, 32, True, 0),   # ragged: no tile divides S
    (2, 77, 77, 6, 2, True, 0),         # G 3
    (2, 100, 170, 8, 2, False, 0),      # G 4, full attention, Sq != Sk
    (1, 45, 200, 12, 3, False, 30),     # G 4, full, q_offset
])
def test_flash_bwd_refuses_the_phi3_head(cuda, dtype, B, Sq, Sk, H, K, causal,
                                         q_offset):
    """phi-3-vision's head, (D, Dv) = (96, 96), which the backward once
    refused: the forward's lse and the backward kernel against the plain
    versions, fp32 at 1e-4, bf16 by the 2x rule (two 64-column panels, the
    last 32 columns zero-filled, and Dsum over 12 of 16 lanes a row), two
    calls bit-equal; ragged Sq and Sk, causal and full, H = K and G > 1;
    and through autograd."""
    assert (96, 96) in fa.SUPPORTED_DIMS_BWD
    _check_flash_bwd(cuda, dtype, B, Sq, Sk, H, K, 96, 96, causal, q_offset)
    q = _rand(cuda, (1, 40, 4, 96), dtype).requires_grad_()
    bwd = fa.flash_attention_bwd.launches
    fa.flash_attention(q, q, q).float().sum().backward()
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == bwd + 1
    assert torch.isfinite(q.grad.float()).all() and q.grad.abs().max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,chunk,H,G,h0,dhT", [
    (1, 4096, 256, 128, 1, False, False),  # jamba's training heads, 16 chunks
    (2, 300, 100, 6, 2, True, True),       # ragged S, G 2: runs of 3 heads
    (2, 64, 64, 4, 1, True, False),        # one chunk, h0
    (2, 40, 64, 4, 1, False, True),        # chunk longer than S
])
def test_ssd_bwd_refuses_the_jamba_head(cuda, dtype, B, S, chunk, H, G, h0,
                                        dhT):
    """jamba-v0.1-52b's head, (P, N) = (64, 16), which the backward once
    refused: the backward kernel from the forward's scratch against the
    plain backward as ``test_ssd_bwd_kernel_matches_plain`` holds it (fp32
    within 2e-3 of the plain version in fp64, bf16 by the 2x rule, two
    calls bit-equal), N 16 zero-filled to a 64-column panel, H 128 at G 1
    in 32 runs of 4 heads; and through ``ssd_scan`` and autograd."""
    assert (64, 16) in ssd.SUPPORTED_DIMS
    _check_ssd_bwd(cuda, dtype, B, S, chunk, H, 64, 16, G, h0, dhT, True)
    x = _rand(cuda, (1, 64, 2, 64), dtype).requires_grad_()
    dt = torch.nn.functional.softplus(_rand(cuda, (1, 64, 2), torch.float32))
    A = -torch.ones(2, device="cuda")
    bc = _rand(cuda, (1, 64, 1, 16), dtype)
    bwd = ssd.ssd_scan_bwd.launches
    ssd.ssd_scan(x, dt, A, bc, bc, chunk=32).float().sum().backward()
    torch.cuda.synchronize()
    assert ssd.ssd_scan_bwd.launches == bwd + 1
    assert torch.isfinite(x.grad.float()).all() and x.grad.abs().max() > 0


def test_hybrid_prefill_kernel_path_matches_plain(cuda):
    """A narrow Jamba (reduced depth and heads, width 512, the published
    SSM head (P, N) = (64, 16)) in bf16: ``lm.prefill`` through the flash
    and SSD kernels against the same call through their plain versions;
    the logits by the bf16 rule against the fp32 plain logits."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import reduced_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import lm
    from repro_torch.models.params import cast_tree

    base = reduced_config("jamba-v0.1-52b")
    cfg = base.replace(d_model=512, ssm=dataclasses.replace(base.ssm,
                                                            head_dim=64))
    params = lm.init_lm(cfg, cuda, "cuda")
    tokens = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 256)), device="cuda")
    fwd, scan = fa.flash_attention.launches, ssd.ssd_scan.launches
    got, caches = lm.prefill(cfg, params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert fa.flash_attention.launches - fwd == 2          # 2 attention
    assert ssd.ssd_scan.launches - scan == 6               # 6 Mamba layers
    assert caches[0]["mamba_moe"]["ssm"].shape == (2, 2, 2, 16, 64, 16)
    saved = ops.flash_attention, ops.ssd_scan
    ops.flash_attention, ops.ssd_scan = ref.attention_ref, ref.ssd_chunked_ref
    try:
        plain, _ = lm.prefill(cfg, params, {"tokens": tokens})
        plain32, _ = lm.prefill(cfg, cast_tree(params, torch.float32),
                                {"tokens": tokens})
    finally:
        ops.flash_attention, ops.ssd_scan = saved
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    _assert_bf16_rule(got, plain, plain32, SSD_TOL[torch.bfloat16])


def test_ssd_scan_is_differentiable_on_the_card(cuda):
    """Through ``ssd_scan`` and autograd, with the final state dropped as
    training drops it: one forward and one backward launch, the gradients
    those of the backward kernel with dhT = None."""
    B, S, H, P, N = 2, 600, 24, 64, 128
    x = _rand(cuda, (B, S, H, P), torch.bfloat16).requires_grad_()
    dt = torch.nn.functional.softplus(_rand(cuda, (B, S, H), torch.float32))
    A = -torch.exp(0.3 * _rand(cuda, (H,), torch.float32))
    bc = [_rand(cuda, (B, S, 1, N), torch.bfloat16) for _ in range(2)]
    dy = _rand(cuda, (B, S, H, P), torch.bfloat16)
    leaves = [t.detach().requires_grad_() for t in (x, dt, A, *bc)]
    fwd, bwd = ssd.ssd_scan.launches, ssd.ssd_scan_bwd.launches
    y, _ = ssd.ssd_scan(*leaves, chunk=256, return_final_state=True)
    y.backward(dy)
    _, _, states = ssd._forward(x, dt, A, *bc, None, 256, True)
    want = ssd.ssd_scan_bwd(x, dt, A, *bc, None, dy, chunk=256, states=states)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.launches == fwd + 2
    assert ssd.ssd_scan_bwd.launches == bwd + 2
    for t, w in zip(leaves, want, strict=False):
        assert torch.equal(t.grad, w)
        assert torch.isfinite(t.grad.float()).all()


# ---------------------------------------------------------------------------
# the fused decode loop as a CUDA graph (reduced configs, random weights)
# ---------------------------------------------------------------------------
def _graph_engine(cuda, arch, **kw):
    import dataclasses

    import numpy as np

    from repro_torch.configs import reduced_config
    from repro_torch.models import lm
    from repro_torch.serve.engine import DecodeEngine, Request

    cfg = reduced_config(arch)
    if cfg.moe is not None:     # no assignment dropped: host mode agrees
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    params = lm.init_lm(cfg, cuda, "cuda")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 23, 9, 31, 14, 3)]

    def run(temperature, eager=False, mode="fused"):
        eng = DecodeEngine(cfg, params, batch_slots=4, max_seq=64,
                           steps_per_sync=4, prefill_chunk=8, rng_seed=5,
                           mode=mode, device="cuda", **kw)
        if eager:       # the bodies without the graphs (no such switch)
            eng._run_fused = lambda: eng._fused_steps(eng.steps_per_sync)
            eng._run_prefill = eng._prefill_body
            eng._run_host_step = eng._host_step_body
        reqs = [Request(prompt=p, max_new_tokens=10, temperature=temperature)
                for p in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        assert all(r.done and len(r.output) == 10 for r in reqs)
        return [list(r.output) for r in reqs], eng

    return cfg, run


@pytest.mark.parametrize("path", ["dense", "paged", "mamba", "jamba",
                                  "jamba_paged"])
def test_graph_replay_matches_eager_body(cuda, path):
    """Graph-replayed tokens equal the eager loop's and host mode's on the
    card, greedy and at temperature 1.0; one capture per engine, one
    replay per sync;
    the decode kernel's count takes each replay's launches; its split-K
    counters are all 0 after the replays.  The reduced Jamba (two
    attention layers among eight) runs at a capacity factor that drops no
    assignment."""
    arch = {"mamba": "mamba2-130m", "jamba": "jamba-v0.1-52b",
            "jamba_paged": "jamba-v0.1-52b"}.get(path, "smollm-360m")
    paged = path.endswith("paged")
    kw = dict(kv_layout="paged", page_size=8) if paged else {}
    cfg, run = _graph_engine(cuda, arch, **kw)
    wrapper = (None if path == "mamba" else
               da.decode_attention_paged if paged else da.decode_attention)
    attn_layers = (cfg.num_layers // cfg.hybrid_block if cfg.hybrid_block
                   else cfg.num_layers)
    for temperature in (0.0, 1.0):
        before = wrapper.launches if wrapper else 0
        got, eng = run(temperature)
        stats = eng.graph_stats()
        assert stats["captures"] == 1
        assert stats["replays"] == eng.steps // 4 > 1
        assert stats["graph_pool_bytes"] > 0
        if wrapper is not None:
            per_replay = 4 * attn_layers
            assert eng._per_replay == {wrapper: per_replay}
            # the warm-up launches too; the capture launches nothing
            assert wrapper.launches - before == \
                (stats["replays"] + 1) * per_replay
        else:
            assert eng._per_replay == {}
        want, eager = run(temperature, eager=True)
        assert not any(eager.graph_stats().values())
        assert got == want, temperature
        host, _ = run(temperature, mode="host")
        assert got == host, temperature
    torch.cuda.synchronize()
    for buf in da._COUNTERS.values():
        assert int(buf.count_nonzero()) == 0


def test_failed_capture_raises_without_eager_fallback(cuda, monkeypatch):
    """A decode step that waits for the device cannot be captured: the
    engine raises, serves nothing eagerly and records no capture."""
    import numpy as np

    from repro_torch.configs import reduced_config
    from repro_torch.models import lm
    from repro_torch.serve import engine as engine_mod

    decode_step = lm.decode_step

    def syncing(*args, **kwargs):
        logits, cache = decode_step(*args, **kwargs)
        logits.sum().item()
        return logits, cache

    cfg = reduced_config("smollm-360m")
    eng = engine_mod.DecodeEngine(cfg, lm.init_lm(cfg, cuda, "cuda"),
                                  batch_slots=2, max_seq=32, device="cuda")
    req = engine_mod.Request(prompt=np.arange(1, 6, dtype=np.int32))
    eng.submit(req)
    monkeypatch.setattr(engine_mod.lm, "decode_step", syncing)
    with pytest.raises(RuntimeError, match="capturing the fused decode loop"):
        eng.run_until_drained()
    torch.cuda.synchronize()
    assert req.output == [] and eng._graphs["decode"] is None
    assert eng.graph_stats()["captures"] == 0


def _cache_leaves(eng) -> list:
    """Every cache leaf, a paged pool without its sink page (inactive rows
    write there, in no fixed order, and no read reaches it)."""
    from repro_torch.models.params import tree_leaves

    pools = {id(leaf): ax for leaf, ax in eng._pool_leaves}
    return [leaf.narrow(pools[id(leaf)], 0, leaf.shape[pools[id(leaf)]] - 1)
            if id(leaf) in pools else leaf for leaf in tree_leaves(eng.cache)]


@pytest.mark.parametrize("path", ["dense", "paged", "mamba"])
def test_prefill_and_host_step_graphs_equal_their_eager_bodies(cuda, path):
    """Host mode with chunked prefill, one engine through its graphs and
    one through the eager bodies, step by step: after every step (its
    pump and its decode step) every cache leaf of the two is equal bit for
    bit, and so are the tokens.  The graphed engine captures the prefill
    and the host step once each and replays them once per pump that takes
    a slot and once per step, with no host sync inside a replay."""
    import numpy as np

    from repro_torch.configs import reduced_config
    from repro_torch.models import lm
    from repro_torch.serve.engine import DecodeEngine, Request

    cfg = reduced_config("mamba2-130m" if path == "mamba" else "smollm-360m")
    params = lm.init_lm(cfg, cuda, "cuda")
    kw = dict(kv_layout="paged", page_size=8) if path == "paged" else {}
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 23, 9, 31, 14, 3)]
    engines, reqs, pumps = [], [], [0]
    for eager in (False, True):
        eng = DecodeEngine(cfg, params, batch_slots=4, max_seq=64,
                           prefill_chunk=8, mode="host", device="cuda", **kw)
        if eager:       # the bodies without the graphs (no such switch)
            eng._run_prefill = eng._prefill_body
            eng._run_host_step = eng._host_step_body
        else:
            run = eng._run_prefill

            def counted(run=run):
                pumps[0] += 1
                run()
            eng._run_prefill = counted
            replay = eng._replay_graph

            def no_sync(name, replay=replay):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    replay(name)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            eng._replay_graph = no_sync
        reqs.append([Request(prompt=p, max_new_tokens=10) for p in prompts])
        for r in reqs[-1]:
            eng.submit(r)
        engines.append(eng)
    graphed, eager = engines
    while graphed.queue or any(r is not None for r in graphed.slot_req):
        graphed.step()
        eager.step()
        for a, b in zip(_cache_leaves(graphed), _cache_leaves(eager),
                        strict=True):
            assert torch.equal(a, b)
    assert not eager.queue and all(r is None for r in eager.slot_req)
    assert [r.output for r in reqs[0]] == [r.output for r in reqs[1]]
    assert all(r.done and len(r.output) == 10 for r in reqs[0])
    stats = graphed.graph_stats()
    assert stats["prefill_captures"] == 1 and pumps[0] > 1
    assert stats["prefill_replays"] == pumps[0]
    assert stats["host_step_captures"] == 1
    assert stats["host_step_replays"] == graphed.steps == eager.steps
    assert stats["captures"] == 0
    assert stats["prefill_graph_pool_bytes"] > 0
    assert not any(eager.graph_stats().values())


@pytest.mark.parametrize("graph", ["prefill", "host_step"])
def test_failed_prefill_or_host_step_capture_raises(cuda, monkeypatch, graph):
    """A chunk or a host-mode step that waits for the device cannot be
    captured: the engine raises, runs nothing of it eagerly in its place,
    serves no token and records no capture."""
    import numpy as np

    from repro_torch.configs import reduced_config
    from repro_torch.models import lm
    from repro_torch.serve import engine as engine_mod

    name = "prefill_chunk" if graph == "prefill" else "decode_step"
    body = getattr(lm, name)

    def syncing(cfg, params, batch, cache):
        out = body(cfg, params, batch, cache)
        float(batch["active"].sum())
        return out

    cfg = reduced_config("smollm-360m")
    eng = engine_mod.DecodeEngine(cfg, lm.init_lm(cfg, cuda, "cuda"),
                                  batch_slots=2, max_seq=32, mode="host",
                                  prefill_chunk=4, device="cuda")
    req = engine_mod.Request(prompt=np.arange(1, 11, dtype=np.int32))
    eng.submit(req)
    monkeypatch.setattr(engine_mod.lm, name, syncing)
    what = ("the chunked prefill" if graph == "prefill"
            else "the host-mode decode step")
    with pytest.raises(RuntimeError, match=f"capturing {what}"):
        eng.run_until_drained()
    torch.cuda.synchronize()
    assert req.output == [] and eng._graphs[graph] is None
    assert eng.graph_stats()[f"{graph}_captures"] == 0
    if graph == "host_step":        # the prefill before it went through
        assert eng.graph_stats()["prefill_captures"] == 1


def test_capture_survives_cyclic_garbage(cuda):
    """An earlier engine that only a reference cycle keeps (its graph, its
    pool, its pinned staging) is freed before the next capture, not inside
    it, where freeing device or pinned memory would invalidate the
    capture; the collector runs after every few allocations here."""
    import gc

    _, run = _graph_engine(cuda, "smollm-360m")
    _, first = run(0.0)
    first.itself = first
    del first
    threshold = gc.get_threshold()
    gc.set_threshold(10)
    try:
        _, second = run(0.0)
    finally:
        gc.set_threshold(*threshold)
    assert second.graph_stats()["captures"] == 1


def test_hash_bits_on_the_card_equal_the_cpu(cuda):
    """The sampling hash gives the same bits on the card as on the CPU, at
    the pinned (key, counter) pairs, the extremes and a full vocabulary."""
    from repro_torch.serve.sampler import hash_bits, vocab_hash

    M32 = 0xFFFFFFFF
    keys = torch.tensor([0x12345678, M32, 0, M32], dtype=torch.int64)
    counters = torch.tensor([7, 2**31 - 1, 0, M32], dtype=torch.int64)
    for vocab in (8, 49_152):
        want = hash_bits(keys, counters, vocab_hash(vocab, "cpu"))
        got = hash_bits(keys.cuda(), counters.cuda(),
                        vocab_hash(vocab, "cuda"))
        assert torch.equal(got.cpu(), want)
    assert want[0, :8].tolist() == [76827266, 3007166522, 905529953,
                                    3595942531, 1109161797, 1939715852,
                                    715631060, 369687695]


# ---------------------------------------------------------------------------
# the train step as a CUDA graph (reduced configs, random weights)
# ---------------------------------------------------------------------------
def _train_setup(cuda, arch, name, warmup=4, total=10):
    """(cfg, the step body, params, a copy of them, numpy batches of 4
    steps) for a reduced config in its own dtypes."""
    from repro_torch.configs import reduced_config
    from repro_torch.data.synthetic import batch_at, data_config_for
    from repro_torch.models import lm
    from repro_torch.models.params import tree_map
    from repro_torch.train.optimizer import get_optimizer
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.train_step import make_train_step

    cfg = reduced_config(arch)
    opt = get_optimizer(name)
    step_fn = make_train_step(cfg, opt, warmup_cosine(1e-3, warmup, total))
    params = lm.init_lm(cfg, cuda, "cuda")
    dc = data_config_for(cfg, seq_len=64 if cfg.ssm is None else 48,
                         batch_size=2)
    return (cfg, opt, step_fn, params, tree_map(torch.clone, params),
            [batch_at(dc, s) for s in range(4)])


def _step_launches(cfg) -> dict:
    """{kernel wrapper: launches a train step}: 2 forwards and 1 backward a
    layer of its mixer's kernel (remat runs each layer's forward again),
    and 1 of each of the flash kernels an MTP block (outside remat)."""
    from repro_torch.models import lm

    mixers = []
    for seg in lm.segments(cfg):
        mixers += seg.count * ([m for _, _, m, _ in seg.plan.entries]
                               if seg.kind == "hybrid" else [seg.mixer])
    ssm = mixers.count("mamba")
    attn = len(mixers) - ssm
    want = {}
    if attn or cfg.mtp_depth:
        want.update({fa.flash_attention: 2 * attn + cfg.mtp_depth,
                     fa.flash_attention_bwd: attn + cfg.mtp_depth})
    if ssm:
        want.update({ssd.ssd_scan: 2 * ssm, ssd.ssd_scan_bwd: ssm})
    return want


def _counts() -> dict:
    from repro_torch.kernels.ops import COUNTED

    return {w: w.launches for w in COUNTED}


@pytest.mark.parametrize("arch,name", [
    ("smollm-360m", "adamw"), ("smollm-360m", "adafactor"),
    ("mamba2-130m", "adamw"), ("mamba2-130m", "adafactor"),
    ("olmoe-1b-7b", "adamw"), ("deepseek-v3-671b", "adafactor"),
    ("musicgen-medium", "adamw"), ("phi-3-vision-4.2b", "adafactor"),
    ("jamba-v0.1-52b", "adafactor")])
def test_train_graph_replays_equal_eager_body(cuda, arch, name):
    """Reduced smollm-360m, mamba2-130m, olmoe-1b-7b, deepseek-v3-671b,
    musicgen-medium, phi-3-vision-4.2b and jamba-v0.1-52b (two
    super-blocks: flash and SSD kernels in one step) in their own dtypes
    (bf16; fp32 SSM leaves, routers and bias), AdamW and Adafactor: a warm-up step,
    one capture and 3 replays give the eager body's metrics at every step
    and its params and optimizer state, bit for bit, from the same weights
    and batches (the MoE dispatch's backward, the codebook embeddings'
    and the image merge's included), with the step read from the device on every
    replay (the lr of warmup 4 differs at each replay); one capture, 3
    replays, and a replay's launches of each kernel wrapper equal an eager
    step's (2 forward and 1 backward per layer, remat on, and one of each
    for an MTP block, which runs outside remat)."""
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.train_step import GraphedStep

    cfg, opt, step_fn, params, copy, batches = _train_setup(cuda, arch, name)
    state, eager_state = opt.init(params), opt.init(copy)
    run = GraphedStep(step_fn, params, state)
    lrs = []
    for step, batch in enumerate(batches):
        got = {k: v.clone() for k, v in run(batch, step).items()}
        before = _counts()
        dev_batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
        want = step_fn(copy, eager_state, dev_batch,
                       torch.tensor(step, dtype=torch.int32, device="cuda"))[2]
        eager_launches = {w: w.launches - n for w, n in before.items()
                          if w.launches != n}
        for key, v in want.items():
            assert torch.equal(got[key], v), (key, step)
        lrs.append(float(got["lr"]))
    assert run.stats["captures"] == 1 and run.stats["replays"] == 3
    assert run.stats["graph_pool_bytes"] > 0
    assert len(set(lrs)) == 4 and lrs[0] == 0.0
    assert run.per_replay == eager_launches == _step_launches(cfg)
    torch.cuda.synchronize()
    for a, b in zip(tree_leaves((params, state)),
                    tree_leaves((copy, eager_state)), strict=True):
        assert torch.equal(a, b)


def test_failed_train_capture_raises_without_eager_fallback(cuda,
                                                            monkeypatch):
    """A loss that waits for the device cannot be captured: the second
    step raises, no replay and no eager step run in its place (the params
    stay as the warm-up step left them), and no capture is recorded."""
    from repro_torch.models import lm
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.train_step import GraphedStep

    _, opt, step_fn, params, _, batches = _train_setup(cuda, "smollm-360m",
                                                       "adamw")
    train_loss = lm.train_loss

    def syncing(*args, **kwargs):
        loss, metrics = train_loss(*args, **kwargs)
        loss.item()
        return loss, metrics

    monkeypatch.setattr(lm, "train_loss", syncing)
    run = GraphedStep(step_fn, params, opt.init(params))
    run(batches[0], 0)
    torch.cuda.synchronize()
    warm = [t.clone() for t in tree_leaves(params)]
    with pytest.raises(RuntimeError, match="capturing the train step"):
        run(batches[1], 1)
    torch.cuda.synchronize()
    assert run._graph is None and run.stats["captures"] == 0
    assert run.stats["replays"] == 0
    for a, b in zip(tree_leaves(params), warm, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-130m"])
def test_run_training_through_the_graph_resumes(cuda, arch, tmp_path):
    """``run_training`` on the card (a warm-up step, then replays) cut by an
    injected failure after step 11 and resumed from its step-10
    checkpoint (a new warm-up and capture after the restore) ends on the
    same bits as a run that never failed."""
    from repro_torch.configs import reduced_config
    from repro_torch.data.synthetic import data_config_for
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.loop import TrainJob, run_training

    cfg = reduced_config(arch)
    dc = data_config_for(cfg, seq_len=64 if cfg.ssm is None else 48,
                         batch_size=2)

    def job(path, **kw):   # inline writes: the step-10 file is on disk
        return TrainJob(total_steps=20, ckpt_every=5, ckpt_dir=str(path),
                        log_every=5, warmup=2, async_ckpt=False, **kw)

    with pytest.raises(RuntimeError, match="injected failure"):
        run_training(cfg, dc, job(tmp_path / "a", fail_after_step=11),
                     device="cuda", log=lambda *a: None)
    logs = []
    hist, final, params = run_training(cfg, dc, job(tmp_path / "a"),
                                       device="cuda", log=logs.append)
    assert logs[0] == "[train] restored checkpoint at step 10"
    assert final == 20 and hist[0]["step"] == 10
    _, _, straight = run_training(cfg, dc, job(tmp_path / "b"),
                                  device="cuda", log=lambda *a: None)
    for a, b in zip(tree_leaves(params), tree_leaves(straight), strict=True):
        assert torch.equal(a, b)


def test_dist_step_at_world_one_is_the_unsharded_step(cuda):
    """Data-parallel training at world 1 over NCCL (``--mesh 1``, ZeRO-1
    on): the step and its collectives are captured as one CUDA graph, and
    the run ends on the bits of ``run_training(rules=None)`` (an all-reduce
    over one rank is the identity; ZeRO-1's slices are whole)."""
    from repro_torch import distributed
    from repro_torch.configs import reduced_config
    from repro_torch.data.synthetic import data_config_for
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.params import tree_leaves
    from repro_torch.sharding.rules import make_rules
    from repro_torch.train import train_step
    from repro_torch.train.loop import TrainJob, run_training

    cfg = reduced_config("smollm-360m")
    dc = data_config_for(cfg, seq_len=64, batch_size=2)
    job = TrainJob(total_steps=4, warmup=1, log_every=1)
    made = []
    init = train_step.GraphedStep.__init__

    def recording(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    distributed.init("cuda")
    try:
        rules = make_rules(make_mesh((1,), ("data",), device="cuda"))
        assert distributed.backend() == "nccl"
        train_step.GraphedStep.__init__ = recording
        hist, _, params = run_training(cfg, dc, job, device="cuda",
                                       rules=rules, log=lambda *a: None)
    finally:
        train_step.GraphedStep.__init__ = init
        distributed.shutdown()
    run = made[0]
    assert run.mode == "graph" and run.stats["captures"] == 1
    assert run.stats["replays"] == 3
    hist1, _, straight = run_training(cfg, dc, job, device="cuda",
                                      log=lambda *a: None)
    assert [h["loss"] for h in hist] == [h["loss"] for h in hist1]
    for a, b in zip(tree_leaves(params), tree_leaves(straight), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch,moe", [("qwen3-4b", "gather"),
                                      ("olmoe-1b-7b", "ep"),
                                      ("mamba2-130m", "gather"),
                                      ("deepseek-v3-671b", "ep")])
def test_model_axis_of_one_rank_is_the_unsharded_step(cuda, arch, moe,
                                                      monkeypatch):
    """Training on a (1, 1) (data, model) mesh over NCCL: the model axis's
    code paths run (olmoe-1b-7b's and deepseek-v3-671b's through the
    expert-parallel dispatch, which a mesh with a model axis selects; the
    SSD scan of mamba2-130m; MLA and the MTP block) with every leaf whole,
    the step and its collectives are captured as one CUDA graph, and the
    run ends on the bits of ``run_training(rules=None)``."""
    from repro_torch import distributed
    from repro_torch.configs import reduced_config
    from repro_torch.data.synthetic import data_config_for
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.params import tree_leaves
    from repro_torch.sharding.rules import make_rules
    from repro_torch.train import train_step
    from repro_torch.train.loop import TrainJob, run_training

    monkeypatch.setenv("REPRO_MOE", moe)
    cfg = reduced_config(arch)
    dc = data_config_for(cfg, seq_len=64, batch_size=2)
    job = TrainJob(total_steps=4, warmup=1, log_every=1)
    made = []
    init = train_step.GraphedStep.__init__

    def recording(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    distributed.init("cuda")
    try:
        rules = make_rules(make_mesh((1, 1), ("data", "model"),
                                     device="cuda"))
        train_step.GraphedStep.__init__ = recording
        hist, _, params = run_training(cfg, dc, job, device="cuda",
                                       rules=rules, log=lambda *a: None)
    finally:
        train_step.GraphedStep.__init__ = init
        distributed.shutdown()
    run = made[0]
    assert run.mode == "graph" and run.stats["captures"] == 1
    hist1, _, straight = run_training(cfg, dc, job, device="cuda",
                                      log=lambda *a: None)
    assert [h["loss"] for h in hist] == [h["loss"] for h in hist1]
    for a, b in zip(tree_leaves(params), tree_leaves(straight), strict=True):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# MoE and MLA decode steps under a CUDA graph (reduced configs)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
def test_moe_and_mla_decode_step_graph_equals_eager(cuda, arch, paged):
    """``lm.decode_step`` of an MoE model (olmoe: sort, capacity scatter,
    batched experts) and of an MLA + MoE model (deepseek: the absorbed
    fp32 einsums) captured with ``torch.cuda.graph`` and replayed gives
    the eager call's logits and cache bit for bit, with a slot inactive
    and (paged) a shuffled table."""
    import numpy as np

    from repro_torch.configs import reduced_config
    from repro_torch.models import lm
    from repro_torch.models.params import tree_leaves, tree_map

    cfg = reduced_config(arch)
    params = lm.init_lm(cfg, cuda, "cuda")
    B, max_seq, P, ps = 8, 64, 72, 8
    lay = (P, ps) if paged else None
    cache0 = lm.make_cache(cfg, B, max_seq, paged=lay, device="cuda")
    for leaf in tree_leaves(cache0):
        leaf.copy_(_rand(cuda, leaf.shape, leaf.dtype))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (B, 1)),
                                    device="cuda"),
             "pos": torch.tensor(rng.integers(0, max_seq, B), device="cuda",
                                 dtype=torch.int32),
             "active": torch.tensor([True] * (B - 1) + [False],
                                    device="cuda")}
    if paged:       # every position of every slot mapped, pages distinct
        table = rng.permutation(P)[:B * (max_seq // ps)].reshape(B, -1)
        batch["page_table"] = torch.tensor(table, dtype=torch.int32,
                                           device="cuda")
    eager_cache = tree_map(torch.clone, cache0)
    with torch.no_grad():
        want, _ = lm.decode_step(cfg, params, batch, eager_cache)
    cache = tree_map(torch.clone, cache0)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.no_grad():
        lm.decode_step(cfg, params, batch, cache)          # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph), torch.no_grad():
        got, _ = lm.decode_step(cfg, params, batch, cache)
    for leaf, leaf0 in zip(tree_leaves(cache), tree_leaves(cache0),
                           strict=True):
        leaf.copy_(leaf0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(cache), tree_leaves(eager_cache), strict=True))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
def test_moe_and_embedding_backward_is_deterministic(cuda, arch):
    """The index ops of an MoE model's backward, twice from the same
    inputs: the embedding's gather of 4,096 tokens over 256 ids (every id
    repeated) and one MoE layer's dispatch, experts and combine in bf16 at
    capacity factor 0.25 (assignments dropped to the sink row): every
    gradient is the same bits both times."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.models import lm, moe
    from repro_torch.models.params import init_params, tree_leaves, tree_map

    cfg = reduced_config(arch)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=0.25))
    p = init_params(moe.make_moe(cfg), cuda, "cuda")
    embed = _rand(cuda, (cfg.vocab_size, cfg.d_model), torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (2, 2048), generator=cuda,
                           device="cuda")
    r = _rand(cuda, (4096, cfg.d_model), torch.bfloat16)

    def grads():
        leaves = tree_map(lambda t: t.detach().requires_grad_(),
                          {"moe": p, "embed": embed})
        x = lm.embed_tokens(cfg, leaves, tokens).reshape(4096, cfg.d_model)
        y, aux = moe.apply_moe_gather(cfg, leaves["moe"], x)
        ((y * r).float().sum() + aux).backward()
        return [t.grad for t in tree_leaves(leaves) if t.grad is not None]

    first, second = grads(), grads()
    torch.cuda.synchronize()
    assert len(first) == len(second) >= 5
    for a, b in zip(first, second, strict=True):
        assert torch.equal(a, b)


def test_dryrun_captures_a_decode_probe_cell(cuda, capsys):
    """The dry-run's card stage on a decode_32k probe (smollm-360m, 2
    layers, B 128 over 32,768 cached rows): lowered on meta, built, captured
    as one CUDA graph and replayed, each replay launching the decode kernel
    once per layer."""
    from repro_torch.launch import dryrun

    torch.cuda.empty_cache()
    rec = dryrun.run_cell("smollm-360m", "decode_32k", seg_counts=(2,),
                          verbose=False)
    assert rec["status"] == "ok" and rec["chips"] == 1
    assert rec["kernel_launches"] == {"decode_attention": 2}
    assert rec["launches_run"]["decode_attention"] >= 2
    assert rec["max_memory_allocated"] >= rec["bytes_per_device_inputs"]
    gib = 2.0 ** 30
    with capsys.disabled():
        print(f"\n[dryrun card] {rec['mesh']}: peak estimate "
              f"{rec['peak_estimate_bytes'] / gib:.2f} GiB, "
              f"max_memory_allocated {rec['max_memory_allocated'] / gib:.2f}"
              f" GiB, max_memory_reserved "
              f"{rec['max_memory_reserved'] / gib:.2f} GiB, compile "
              f"{rec['compile_s']:.2f} s")


def test_dryrun_one_by_one_mesh_is_the_one_card_cell(cuda):
    """A (1, 1) (data, model) mesh in a fake world of one traces what one
    card does: the same counted FLOPs and bytes, inputs and peak estimate,
    and the same kernel launches a replay on the card."""
    from repro_torch.launch import dryrun

    torch.cuda.empty_cache()
    one = dryrun.run_cell("smollm-360m", "decode_32k", seg_counts=(2,),
                          verbose=False)
    mesh = dryrun.run_cell("smollm-360m", "decode_32k", seg_counts=(2,),
                           mesh_shape=(1, 1), mesh_axes=("data", "model"),
                           verbose=False)
    assert mesh["status"] == one["status"] == "ok"
    assert mesh["chips"] == 1 and mesh["mesh"] == "data1xmodel1"
    for key in ("counted", "peak_estimate_bytes", "bytes_per_device_inputs",
                "kernels", "kernel_launches"):
        assert mesh[key] == one[key], key
    assert mesh["roofline"]["hlo_flops"] == one["roofline"]["hlo_flops"]
    assert not torch.distributed.is_initialized()


def test_dryrun_mesh_cell_captures_the_rank_step(cuda):
    """qwen3-4b prefill_32k, 2 layers, on (2, 4): rank 0's part (16 of
    32 rows, 8 query and 2 KV heads, a quarter of the vocabulary) built on
    the card and its prefill captured as one graph with the fake group's
    collectives in it; one replay, finite logits, the flash kernel once a
    layer at the local heads."""
    from repro_torch.launch import dryrun

    torch.cuda.empty_cache()
    rec = dryrun.run_cell("qwen3-4b", "prefill_32k", seg_counts=(2,),
                          mesh_shape=(2, 4), mesh_axes=("data", "model"),
                          verbose=False)
    assert rec["status"] == "ok" and rec["chips"] == 8
    assert rec["collectives"] == "counted, not run"
    assert rec["kernel_launches"] == {"flash_attention": 2}
    assert rec["roofline"]["collective_bytes_per_chip"] > 0
    assert not torch.distributed.is_initialized()
