"""deepseek-v3-671b — MLA + fine-grained MoE (1 shared + 256 routed, top-8)
+ MTP. First 3 layers dense.  [arXiv:2412.19437]

A verbatim copy of ``repro.configs.deepseek_v3_671b``: the port never
imports the JAX package.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,    # MLA: all heads share the compressed latent
    head_dim=128,        # qk_nope head dim; see MLAConfig for the full split
    d_ff=18432,          # dense-layer FFN width (first 3 layers)
    d_ff_dense=18432,
    vocab_size=129280,
    attention_kind="mla",
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=256,
        num_shared_experts=1,
        top_k=8,
        d_ff_expert=2048,
        first_k_dense=3,
        every=1,
        scoring="sigmoid",   # DeepSeek-V3 sigmoid scoring + normalised top-k
        aux_loss_coef=0.0001,
    ),
    rope_theta=10000.0,
    act="silu",
    mtp_depth=1,
)
