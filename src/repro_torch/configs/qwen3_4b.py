"""qwen3-4b — dense, qk-norm, GQA kv=8, large vocab. [hf:Qwen/Qwen3-4B]

A verbatim copy of ``repro.configs.qwen3_4b``: the port never imports the
JAX package.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,     # decoupled from d_model/num_heads in Qwen3
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    act="silu",
)
