"""olmoe-1b-7b — 64-expert top-8 MoE, MHA. [arXiv:2409.02060]

A verbatim copy of ``repro.configs.olmoe_1b_7b``: the port never imports the
JAX package.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,           # per-expert width
    vocab_size=50304,
    qk_norm=True,        # OLMoE uses QK-Norm
    moe=MoEConfig(
        num_experts=64,
        num_shared_experts=0,
        top_k=8,
        d_ff_expert=1024,
        first_k_dense=0,
        every=1,
        scoring="softmax",
        aux_loss_coef=0.01,
    ),
    rope_theta=10000.0,
    act="silu",
)
