"""Static analysis of configs: parameter counts, per-step model FLOPs,
cache bytes.  Used for (a) ExpoCloud task hardness of exploration cells,
(b) MODEL_FLOPS in the roofline report (6·N·D dense / 6·N_active·D MoE),
(c) sanity checks in tests.

All counts are exact from the config algebra — no arrays are built.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig


def _attn_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    if cfg.attention_kind == "mla":
        m = cfg.mla
        qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
        n = 0
        n += d * m.q_lora_rank + m.q_lora_rank  # q down (+norm)
        n += m.q_lora_rank * cfg.num_heads * qk_head  # q up
        n += d * (m.kv_lora_rank + m.qk_rope_head_dim) + m.kv_lora_rank
        n += m.kv_lora_rank * cfg.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
        n += cfg.num_heads * m.v_head_dim * d  # o proj
        return n
    if cfg.attention_kind == "none":
        return 0
    n = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
    if cfg.qk_norm:
        n += 2 * cfg.head_dim
    return n


def _mamba_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.d_inner(d)
    nheads = s.n_heads(d)
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    n = d * (2 * d_in + 2 * s.n_groups * s.d_state + nheads)  # in_proj
    n += conv_ch * s.d_conv + conv_ch  # conv1d + bias
    n += 2 * nheads  # A_log, D
    n += nheads  # dt_bias
    n += d_in  # gated norm
    n += d_in * d  # out_proj
    return n


def _dense_ffn_params(cfg: ModelConfig, width: int) -> int:
    # silu -> gated SwiGLU (gate+up+down); gelu -> classic 2-matrix MLP
    mats = 3 if cfg.act == "silu" else 2
    return mats * cfg.d_model * width


def _moe_ffn_params(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active) params of one MoE FFN layer."""
    m = cfg.moe
    per_exp = 3 * cfg.d_model * m.d_ff_expert
    router = cfg.d_model * m.num_experts
    shared = m.num_shared_experts * per_exp
    total = m.num_experts * per_exp + router + shared
    active = m.top_k * per_exp + router + shared
    return total, active


def _layer_kinds(cfg: ModelConfig):
    """Yield (mixer, ffn) per layer: mixer in {attn,mamba,none},
    ffn in {dense,moe,none}."""
    for i in range(cfg.num_layers):
        if cfg.hybrid_block:
            mixer = "attn" if (i % cfg.hybrid_block) == cfg.hybrid_attn_index else "mamba"
        elif cfg.attention_free:
            mixer = "mamba"
        else:
            mixer = "attn"
        if cfg.family == "ssm":
            ffn = "none"
        elif cfg.is_moe_layer(i):
            ffn = "moe"
        else:
            ffn = "dense"
        yield mixer, ffn


@dataclass(frozen=True)
class ParamCounts:
    total: int
    active: int           # per-token active params (MoE top-k)
    embedding: int


def param_counts(cfg: ModelConfig) -> ParamCounts:
    d = cfg.d_model
    emb = cfg.vocab_size * d * max(cfg.num_codebooks, 1)
    head = 0 if cfg.tie_embeddings else cfg.vocab_size * d * max(cfg.num_codebooks, 1)
    total = emb + head + d  # final norm
    active = emb + head + d
    dense_w = cfg.d_ff_dense or cfg.d_ff
    for mixer, ffn in _layer_kinds(cfg):
        lt = la = 2 * d  # two norms
        if mixer == "attn":
            p = _attn_params(cfg)
            lt += p
            la += p
        elif mixer == "mamba":
            p = _mamba_params(cfg)
            lt += p
            la += p
        if ffn == "dense":
            p = _dense_ffn_params(cfg, dense_w)
            lt += p
            la += p
        elif ffn == "moe":
            t, a = _moe_ffn_params(cfg)
            lt += t
            la += a
        total += lt
        active += la
    if cfg.mtp_depth:
        # each MTP module: 1 transformer layer + projection (2d -> d)
        per = _attn_params(cfg) + _dense_ffn_params(cfg, dense_w) + 2 * d * d + 3 * d
        total += cfg.mtp_depth * per
        active += cfg.mtp_depth * per
    return ParamCounts(total=total, active=active, embedding=emb + head)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) per assignment,
    where D is tokens processed by the step.

    train counts fwd+bwd (the 6x); prefill/decode count forward only (2x).
    Decode steps process global_batch tokens (one new token each).
    """
    pc = param_counts(cfg)
    n = pc.active - pc.embedding  # FLOPs-relevant params exclude embed gather
    # logits matmul params do contribute:
    n += cfg.vocab_size * cfg.d_model * max(cfg.num_codebooks, 1)
    if shape.kind == "train":
        tokens = shape.tokens
        mult = 6.0
    elif shape.kind == "prefill":
        tokens = shape.tokens
        mult = 2.0
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        mult = 2.0
    flops = mult * n * tokens
    # attention score/value FLOPs (not in 6ND); count for honesty
    if not cfg.attention_free:
        attn_layers = sum(1 for m, _ in _layer_kinds(cfg) if m == "attn")
        if cfg.attention_kind == "mla":
            qk_head = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
            per_tok = cfg.num_heads * (qk_head + cfg.mla.v_head_dim)
        else:
            per_tok = cfg.num_heads * 2 * cfg.head_dim
        if shape.kind == "train":
            # causal: S/2 average context
            sc = shape.seq_len / 2
            flops += 6.0 * attn_layers * per_tok * sc * shape.tokens
        elif shape.kind == "prefill":
            sc = shape.seq_len / 2
            flops += 2.0 * attn_layers * per_tok * sc * shape.tokens
        else:
            flops += 2.0 * attn_layers * per_tok * shape.seq_len * shape.global_batch
    return flops


def kv_cache_bytes(cfg: ModelConfig, shape: ShapeConfig, dtype_bytes: int = 2) -> int:
    """Decode-path cache bytes (KV cache + SSM/conv states), global."""
    b, s = shape.global_batch, shape.seq_len
    total = 0
    for mixer, _ in _layer_kinds(cfg):
        if mixer == "attn":
            per_tok = (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
                       if cfg.attention_kind == "mla"
                       else 2 * cfg.num_kv_heads * cfg.head_dim)
            total += b * s * per_tok * dtype_bytes
        elif mixer == "mamba":
            ssm = cfg.ssm
            d_in = ssm.d_inner(cfg.d_model)
            nheads = ssm.n_heads(cfg.d_model)
            conv_ch = d_in + 2 * ssm.n_groups * ssm.d_state
            total += b * (ssm.d_conv - 1) * conv_ch * dtype_bytes
            total += b * nheads * ssm.head_dim * ssm.d_state * 4  # fp32 state
    return total


def hardness_tuple(cfg: ModelConfig, shape: ShapeConfig) -> tuple:
    """The ExpoCloud hardness of an exploration cell: componentwise-comparable
    proxies for how expensive the cell is to lower/compile/run.
    (total params, step model-FLOPs, cache bytes, seq_len, tokens)
    """
    pc = param_counts(cfg)
    return (
        pc.total,
        int(model_flops(cfg, shape)),
        kv_cache_bytes(cfg, shape),
        shape.seq_len,
        shape.tokens,
    )
