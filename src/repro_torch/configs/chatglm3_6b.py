"""chatglm3-6b — dense, 2d (partial, interleaved) RoPE, GQA kv=2.
[arXiv:2406.12793]

A verbatim copy of ``repro.configs.chatglm3_6b``: the port never imports the
JAX package.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    rotary_pct=0.5,          # rotary applied to half the head dim
    rope_interleaved=True,   # GLM 2d-RoPE pairing
    rope_theta=10000.0,
    act="silu",
)
