"""Plain PyTorch oracles for the ported kernels (a port of
``repro/kernels/ref.py``: attention, paged attention and the Mamba-2 SSD).

They are the compute path for CPU tensors and the versions the CUDA
kernels are held against on the card.  fp32 softmax and SSD state; fp32
matmuls here never run in TF32.
"""
from __future__ import annotations

import torch


def _full_fp32(t: torch.Tensor):
    # explicit, not the defaults: the plain versions are the fp32 yardstick
    if t.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def attention_ref(q, k, v, *, causal: bool = True, scale: float | None = None,
                  q_offset: int = 0):
    """Grouped-query attention, fp32 softmax.

    q [B, Sq, H, D], k [B, Sk, K, D], v [B, Sk, K, Dv] -> [B, Sq, H, Dv]."""
    _full_fp32(q)
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Sq, K, G, D).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    if causal:
        qpos = torch.arange(Sq, device=q.device) + q_offset
        kpos = torch.arange(Sk, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def _wide(t):
    """``t`` in fp32, or in fp64 if it is fp64 (for gradcheck)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _grouped_scores(q, k, causal: bool, scale: float, q_offset: int):
    """fp32 scores [B, Sq, K, G, Sk], -inf where masked, from operands in
    their own dtype (products of bf16 values are exact in fp32, so this is
    JAX's ``preferred_element_type=float32``)."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    qg = _wide(q.reshape(B, Sq, K, H // K, D))
    s = torch.einsum("bqkgd,bskd->bqkgs", qg, _wide(k)) * scale
    if causal:
        qpos = torch.arange(Sq, device=q.device) + q_offset
        live = torch.arange(Sk, device=q.device)[None, :] <= qpos[:, None]
        s = s.masked_fill(~live[None, :, None, None, :], float("-inf"))
    return s


def attention_lse_ref(q, k, v, *, causal: bool = True,
                      scale: float | None = None, q_offset: int = 0):
    """Attention and its log-sum-exp, the residual the backward recomputes
    ``p`` from (``repro/kernels/xla_flash.py:86``).

    q [B, Sq, H, D], k [B, Sk, K, D], v [B, Sk, K, Dv] -> (out [B, Sq, H, Dv]
    in q's dtype, lse [B, Sq, H] fp32; fp64 for fp64 inputs).  A row with
    no live key keeps l = 1 (``xla_flash.py:84``): its output is 0 and its
    lse is 0, so the backward's ``exp(s - lse)`` is 0 on its masked
    scores."""
    _full_fp32(q)
    B, Sq, H, D = q.shape
    Dv = v.shape[-1]
    scale = D ** -0.5 if scale is None else scale
    s = _grouped_scores(q, k, causal, scale, q_offset)
    m = s.amax(dim=-1)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    l = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bqkgs,bskd->bqkgd", p, _wide(v)) / l[..., None]
    return (out.reshape(B, Sq, H, Dv).to(q.dtype),
            (m + torch.log(l)).reshape(B, Sq, H))


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True,
                            scale: float | None = None, q_offset: int = 0):
    """The FlashAttention backward of ``repro/kernels/xla_flash.py:95-131``
    (``_vjp_bwd``), unblocked: ``p = exp(s - lse)`` from the saved lse,
    ``Dsum = sum(dO * O)`` in fp32, ``ds = p * (dp - Dsum)``.  As in JAX, p
    is rounded to q's dtype before ``dV = p^T dO`` and ds before ``dQ = ds
    K`` and ``dK = ds^T Q``; the G query heads of a group sum into their
    KV head's dk and dv.

    q, k, v, out, dout as in ``attention_lse_ref``; lse [B, Sq, H] fp32 ->
    (dq, dk, dv) in the dtypes of q, k, v.  fp64 inputs are computed in
    fp64 throughout."""
    _full_fp32(q)
    B, Sq, H, D = q.shape
    K, Dv = k.shape[2], v.shape[-1]
    G = H // K
    scale = D ** -0.5 if scale is None else scale
    s = _grouped_scores(q, k, causal, scale, q_offset)
    p = torch.exp(s - lse.reshape(B, Sq, K, G, 1).to(s.dtype))
    do = _wide(dout.reshape(B, Sq, K, G, Dv))
    dsum = (do * _wide(out.reshape(B, Sq, K, G, Dv))).sum(dim=-1)
    dv = torch.einsum("bqkgs,bqkgd->bskd", _wide(p.to(q.dtype)), do)
    dp = torch.einsum("bqkgd,bskd->bqkgs", do, _wide(v))
    ds = _wide((p * (dp - dsum[..., None])).to(q.dtype))
    dq = torch.einsum("bqkgs,bskd->bqkgd", ds, _wide(k)) * scale
    dk = torch.einsum("bqkgs,bqkgd->bskd", ds,
                      _wide(q.reshape(B, Sq, K, G, D))) * scale
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def decode_attention_ref(q, k, v, kv_len, *, scale: float | None = None):
    """Single-token (Sq=1) GQA decode attention over a ragged KV cache.

    q [B, H, D], k [B, Sk, K, D], v [B, Sk, K, Dv], kv_len [B] int32
    (position p attended iff p < kv_len) -> [B, H, Dv].  Every slot must
    have ``kv_len >= 1`` (an all-masked row softmaxes to NaN; the kernel
    returns 0 there)."""
    _full_fp32(q)
    B, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = D ** -0.5 if scale is None else scale
    qg = q.reshape(B, K, G, D).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    mask = torch.arange(Sk, device=q.device)[None, :] < kv_len[:, None]
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v.float())
    return out.reshape(B, H, v.shape[-1]).to(q.dtype)


def gather_pages(pool, page_table):
    """Slot-major view of a paged pool.

    pool [P, ps, ...], page_table [B, W] int32 (physical page backing each
    slot's logical page) -> [B, W*ps, ...]: row ``j`` of slot ``b`` is token
    position ``j``.  Rows past a slot's live length are stale; callers mask
    them by kv_len.  Unmapped entries hold the sentinel ``P`` and are
    clamped to ``P - 1`` before the gather."""
    B, W = page_table.shape
    pt = page_table.clamp(max=pool.shape[0] - 1)
    g = pool[pt]                                    # [B, W, ps, ...]
    return g.reshape(B, W * pool.shape[1], *pool.shape[2:])


def decode_attention_paged_ref(q, k_pool, v_pool, page_table, kv_len, *,
                               scale: float | None = None):
    """Paged Sq=1 decode attention: gather the slots' pages into a dense
    [B, W*ps, ...] view, then the ragged dense reference.

    q [B, H, D], k_pool [P, ps, K, D], v_pool [P, ps, K, Dv], page_table
    [B, W] int32, kv_len [B] int32 -> [B, H, Dv]."""
    k = gather_pages(k_pool, page_table)
    v = gather_pages(v_pool, page_table)
    return decode_attention_ref(q, k, v, kv_len, scale=scale)


# ---------------------------------------------------------------------------
# Mamba-2 SSD (state-space duality)
# ---------------------------------------------------------------------------
def _segsum(x):
    """Stable segment sum: out[..., i, j] = sum_{j < t <= i} x[..., t]
    (-inf above the diagonal).  x [..., L] -> [..., L, L]."""
    L = x.shape[-1]
    cum = torch.cumsum(x, dim=-1)
    out = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def _pad_seq(a, pad: int):
    """Zero-pad axis 1 of ``a`` by ``pad`` rows."""
    z = torch.zeros((a.shape[0], pad, *a.shape[2:]), dtype=a.dtype,
                    device=a.device)
    return torch.cat([a, z], dim=1)


def ssd_chunked_ref(x, dt, A, Bm, Cm, *, chunk: int = 64, h0=None,
                    return_final_state: bool = False):
    """Chunked SSD: y_t = C_t . h_t,  h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t.

    x [B, S, H, P]; dt [B, S, H] (softplus'ed, > 0); A [H] (negative);
    Bm, Cm [B, S, G, N] (head h reads group h // (H/G)); h0 [B, H, P, N].
    fp32 throughout (fp64 for fp64 inputs, for gradcheck); y is cast back
    to x's dtype, the final state [B, H, P, N] stays fp32.  S need not
    divide ``chunk``: the tail is padded with dt = 0, which leaves the
    state unchanged."""
    _full_fp32(x)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    S_orig = S
    if pad:
        x, dt, Bm, Cm = (_pad_seq(a, pad) for a in (x, dt, Bm, Cm))
        S = S + pad
    nc = S // chunk
    rep = H // G

    xf = _wide(x).reshape(Bsz, nc, chunk, H, P)
    dtf = _wide(dt).reshape(Bsz, nc, chunk, H)
    Bh = _wide(Bm).reshape(Bsz, nc, chunk, G, N).repeat_interleave(rep, 3)
    Ch = _wide(Cm).reshape(Bsz, nc, chunk, G, N).repeat_interleave(rep, 3)

    dA = dtf * _wide(A)[None, None, None, :]           # [B, nc, L, H]
    dAc = torch.cumsum(dA, dim=2)
    # intra-chunk (quadratic within the chunk)
    Lmat = torch.exp(_segsum(dA.transpose(2, 3)))       # [B, nc, H, L, L]
    scores = torch.einsum("bclhn,bcshn->bchls", Ch, Bh) * Lmat
    scores = scores * dtf.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchls,bcshp->bclhp", scores, xf)
    # chunk states
    decay_to_end = torch.exp(dAc[:, :, -1:, :] - dAc)   # [B, nc, L, H]
    Sc = torch.einsum("bclhn,bclh,bclhp->bchnp", Bh, decay_to_end * dtf, xf)
    # inter-chunk recurrence over the chunks, in order
    chunk_decay = torch.exp(dAc[:, :, -1, :])           # [B, nc, H]
    h = (torch.zeros((Bsz, H, N, P), dtype=xf.dtype, device=x.device)
         if h0 is None else _wide(h0).transpose(-1, -2))
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + Sc[:, c]
    h_prev = torch.stack(h_prev, dim=1)                 # state entering chunk
    y_inter = torch.einsum("bclhn,bchnp->bclhp",
                           Ch * torch.exp(dAc)[..., None], h_prev)
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)[:, :S_orig]
    if return_final_state:
        return y.to(x.dtype), h.transpose(-1, -2).contiguous()
    return y.to(x.dtype)


def ssd_scan_bwd_ref(x, dt, A, Bm, Cm, h0, dy, dhT=None, *, chunk: int):
    """The SSD scan's backward: (dx, ddt, dA, dB, dC, dh0) of
    ``ssd_chunked_ref`` from the gradients of y (``dy``, x's dtype) and of
    the final state (``dhT`` [B, H, P, N] fp32, None for a dropped state),
    by autograd through the plain forward.  Each gradient has its input's
    dtype; dh0 is None without h0.  The counterpart of ``jax.vjp`` of
    ``repro/kernels/ref.py::ssd_chunked_ref``."""
    leaves = [t.detach().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    if h0 is not None:
        leaves.append(h0.detach().requires_grad_())
    with torch.enable_grad():
        out = ssd_chunked_ref(*leaves[:5], chunk=chunk,
                              h0=leaves[5] if h0 is not None else None,
                              return_final_state=dhT is not None)
        outs, grads = (out, (dy, dhT)) if dhT is not None else ((out,), (dy,))
        got = torch.autograd.grad(outs, leaves, grads)
    return (*got[:5], got[5] if h0 is not None else None)


def ssd_sequential_ref(x, dt, A, Bm, Cm, h0=None):
    """O(S) sequential oracle (the definition).  Returns (y, h_final) with
    h [B, H, P, N] fp32 and y_t = C_t . h_t."""
    _full_fp32(x)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bh = Bm.float().repeat_interleave(rep, 2)
    Ch = Cm.float().repeat_interleave(rep, 2)
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        dA = torch.exp(dtf[:, t] * Af[None, :])          # [B, H]
        dBx = torch.einsum("bh,bhn,bhp->bhpn", dtf[:, t], Bh[:, t], xf[:, t])
        h = h * dA[..., None, None] + dBx
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    y = torch.stack(ys, dim=1)
    return y.to(x.dtype), h


def ssd_decode_step_ref(x, dt, A, Bm, Cm, h):
    """Single-token SSD update.  x [B, H, P], dt [B, H], Bm/Cm [B, G, N],
    h [B, H, P, N] -> (y [B, H, P] in x's dtype, h' fp32)."""
    _full_fp32(x)
    G = Bm.shape[1]
    rep = x.shape[1] // G
    Bh = Bm.float().repeat_interleave(rep, 1)
    Ch = Cm.float().repeat_interleave(rep, 1)
    xf, dtf = x.float(), dt.float()
    dA = torch.exp(dtf * A.float()[None, :])
    h_new = h * dA[..., None, None] + torch.einsum("bh,bhn,bhp->bhpn", dtf,
                                                   Bh, xf)
    y = torch.einsum("bhpn,bhn->bhp", h_new, Ch)
    return y.to(x.dtype), h_new
