"""mamba2-130m — attention-free SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,              # no FFN: the Mamba block is the whole layer
    vocab_size=50280,
    attention_kind="none",
    ssm=SSMConfig(d_state=128, head_dim=64, n_groups=1, d_conv=4, expand=2),
    act="silu",
)
