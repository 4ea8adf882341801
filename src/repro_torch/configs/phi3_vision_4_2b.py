"""phi-3-vision-4.2b — phi3-mini backbone + CLIP frontend (STUB: the
assignment specifies the transformer backbone only; ``input_specs`` provides
precomputed patch embeddings).  [hf:microsoft/Phi-3-vision-128k-instruct]

A verbatim copy of ``repro.configs.phi3_vision_4_2b``: the port never
imports the JAX package.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10000.0,
    act="silu",
    vision_stub=True,
    num_image_tokens=576,   # one 336px CLIP tile worth of patch embeddings
)
