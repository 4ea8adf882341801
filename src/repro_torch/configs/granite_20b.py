"""granite-20b — llama-arch code model, MQA (kv=1). [arXiv:2405.04324]

A verbatim copy of ``repro.configs.granite_20b``: the port never imports the
JAX package.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,   # MQA
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    rope_theta=10000.0,
    act="gelu",
)
