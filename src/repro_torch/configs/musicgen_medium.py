"""musicgen-medium — decoder-only LM over EnCodec tokens (4 codebooks,
delay pattern).  The EnCodec frontend is a STUB per the assignment; the
backbone consumes/predicts codebook token ids.  [arXiv:2306.05284]

A verbatim copy of ``repro.configs.musicgen_medium``: the port never
imports the JAX package.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    num_codebooks=4,
    rope_theta=10000.0,
    act="gelu",
)
