"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs.

Lists only the architectures the port runs; ``cells``, the reduction
rules and the segment counts are copies of ``repro.configs.registry``'s.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.configs.shapes import SHAPES, ShapeConfig, shape_applicable

_ARCH_MODULES = {
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "granite-20b": "repro_torch.configs.granite_20b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "phi-3-vision-4.2b": "repro_torch.configs.phi3_vision_4_2b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; the port has: "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name]).CONFIG


def cells(include_inapplicable: bool = False):
    """All (arch, shape) cells of the assigned grid, in registry order."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if include_inapplicable or shape_applicable(cfg, shape):
                out.append((arch, shape.name))
    return out


def reduced_config(name: str) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests.

    Keeps every structural feature of the full config (GQA ratio, MLA, MoE
    top-k, hybrid interleave, codebooks ...) at toy width/depth.
    """
    cfg = get_config(name)
    kw: dict = dict(
        num_layers=min(cfg.num_layers, 4),
        d_model=128,
        vocab_size=256,
        tie_embeddings=cfg.tie_embeddings,
    )
    if cfg.attention_kind == "gqa":
        # preserve the q:kv ratio where possible
        ratio = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
        kv = max(1, 4 // ratio) if ratio <= 4 else 1
        kw.update(num_heads=kv * min(ratio, 4), num_kv_heads=kv, head_dim=32)
    if cfg.d_ff:
        kw.update(d_ff=256)
    if cfg.d_ff_dense:
        kw.update(d_ff_dense=256)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 8),
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64,
            first_k_dense=min(cfg.moe.first_k_dense, 1),
        )
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=32, chunk=32
        )
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(
            q_lora_rank=64,
            kv_lora_rank=32,
            qk_nope_head_dim=32,
            qk_rope_head_dim=16,
            v_head_dim=32,
        )
        kw.update(num_heads=4, num_kv_heads=4, head_dim=32)
    if cfg.hybrid_block:
        kw.update(num_layers=8, hybrid_block=4, hybrid_attn_index=2)
        kw["moe"] = dataclasses.replace(kw["moe"], first_k_dense=1, every=2)
    if cfg.num_image_tokens:
        kw.update(num_image_tokens=8)
    if cfg.mtp_depth:
        kw.update(mtp_depth=1)
    return cfg.replace(**kw)


REDUCED_SHAPE = ShapeConfig("smoke", seq_len=64, global_batch=2, kind="train")


def segment_counts(cfg) -> list[int]:
    """Scanned-unit counts per segment (layers, or super-blocks for hybrid).
    Mirrors repro_torch.models.lm.segments."""
    if cfg.hybrid_block:
        return [cfg.num_layers // cfg.hybrid_block]
    if cfg.moe is not None and cfg.moe.first_k_dense:
        return [cfg.moe.first_k_dense,
                cfg.num_layers - cfg.moe.first_k_dense]
    return [cfg.num_layers]


def with_segment_counts(cfg: ModelConfig, counts: list[int]) -> ModelConfig:
    """Rebuild the config with new scanned-unit counts per segment (for
    the dry-run's probes — see launch/sweep_dryrun.py)."""
    cur = segment_counts(cfg)
    assert len(counts) == len(cur), (counts, cur)
    if cfg.hybrid_block:
        return cfg.replace(num_layers=counts[0] * cfg.hybrid_block)
    if cfg.moe is not None and cfg.moe.first_k_dense:
        fk, nm = counts
        return cfg.replace(
            num_layers=fk + nm,
            moe=dataclasses.replace(cfg.moe, first_k_dense=fk))
    return cfg.replace(num_layers=counts[0])


__all__ = ["ARCH_IDS", "REDUCED_SHAPE", "cells", "get_config",
           "reduced_config", "segment_counts", "with_segment_counts"]
