"""smollm-360m — llama-arch small dense LM. [hf:HuggingFaceTB/SmolLM-360M]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    rope_theta=10000.0,
    act="silu",
    tie_embeddings=True,
)
