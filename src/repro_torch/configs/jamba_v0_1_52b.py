"""jamba-v0.1-52b — hybrid Mamba/attention 7:1 interleave with MoE (16e top-2)
on every other layer.  [arXiv:2403.19887]

Layout: 4 super-blocks x 8 layers; the attention mixer sits at in-block
index 4, all other mixers are Mamba.  MoE FFN on odd in-block indices.
Jamba uses Mamba-1 cells; we express them in the SSD (state-space duality)
formulation of Mamba-2 [arXiv:2405.21060] with d_state=16 — see
DESIGN.md "What changed vs. the paper".

A verbatim copy of ``repro.configs.jamba_v0_1_52b``: the port never
imports the JAX package.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    hybrid_block=8,
    hybrid_attn_index=4,
    moe=MoEConfig(
        num_experts=16,
        num_shared_experts=0,
        top_k=2,
        d_ff_expert=14336,
        first_k_dense=1,   # MoE on odd layer indices
        every=2,
        scoring="softmax",
        aux_loss_coef=0.01,
    ),
    ssm=SSMConfig(d_state=16, head_dim=64, n_groups=1, d_conv=4, expand=2),
    rope_theta=10000.0,  # Jamba has no positional encoding on attn; harmless
    rotary_pct=0.0,      # -> NoPE on the attention layers
    act="silu",
)
