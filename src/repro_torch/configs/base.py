"""Config dataclasses for the model zoo.

A verbatim copy of ``repro.configs.base`` (the port keeps its own copy so
that it never imports the JAX package).  Every architecture is a single
``ModelConfig``; the model-builder in :mod:`repro_torch.models.lm`
interprets the flags.  Configs are frozen dataclasses, so they hash.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    # Which layers are MoE: layer i is MoE iff i >= first_k_dense and
    # (i - first_k_dense) % every == 0.
    first_k_dense: int = 0
    every: int = 1
    aux_loss_coef: float = 0.01
    capacity_factor: float = 1.25
    # 'softmax' (classic top-k) or 'sigmoid' (DeepSeek-V3 style scoring with
    # normalised top-k weights).
    scoring: str = "softmax"
    router_dtype: str = "float32"


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    n_groups: int = 1
    d_conv: int = 4
    expand: int = 2
    chunk: int = 256  # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention dims."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | hybrid | ssm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention options -------------------------------------------------
    attention_kind: str = "gqa"  # gqa | mla | none
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0      # fraction of head_dim that is rotary
    rope_interleaved: bool = False  # GLM-style 2d/interleaved RoPE pairs

    # --- sub-configs --------------------------------------------------------
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    mla: MLAConfig | None = None

    # --- hybrid (Jamba) -----------------------------------------------------
    # If >0: layers are grouped into super-blocks of this many layers; the
    # attention layer sits at ``hybrid_attn_index`` within each block and all
    # other mixers are Mamba.
    hybrid_block: int = 0
    hybrid_attn_index: int = 4

    # --- modality frontends (STUBS per assignment) ---------------------------
    num_codebooks: int = 0       # musicgen: EnCodec codebooks
    vision_stub: bool = False    # phi-3-vision: precomputed patch embeds
    num_image_tokens: int = 0    # stand-in image token count per sample

    # --- misc ---------------------------------------------------------------
    act: str = "silu"            # silu | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    mtp_depth: int = 0           # DeepSeek multi-token-prediction modules
    mtp_loss_weight: float = 0.3
    # Dense FFN width for dense layers when the MoE config only covers a
    # subset of layers (DeepSeek first-k-dense).  0 -> use d_ff.
    d_ff_dense: int = 0

    # ------------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def rotary_dim(self) -> int:
        d = int(self.head_dim * self.rotary_pct)
        return d - (d % 2)

    def is_moe_layer(self, idx: int) -> bool:
        if self.moe is None:
            return False
        if idx < self.moe.first_k_dense:
            return False
        return (idx - self.moe.first_k_dense) % self.moe.every == 0

    @property
    def attention_free(self) -> bool:
        return self.attention_kind == "none"

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch has a long-context (500k) path: SSM or hybrid."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> ModelConfig:
        return dataclasses.replace(self, **kw)
