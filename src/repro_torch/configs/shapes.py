"""Assigned input shapes.

Each LM shape is seq_len x global_batch.  ``decode_*`` / ``long_*`` lower
``serve_step`` (one new token against a KV cache of seq_len), NOT
``train_step``.  ``long_500k`` requires a sub-quadratic architecture and is
skipped (by design, recorded) for pure full-attention archs.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def shape_applicable(cfg, shape: ShapeConfig) -> bool:
    """long_500k only runs for sub-quadratic (SSM / hybrid) families."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True
