"""Deterministic synthetic LM data (a copy of ``repro/data/synthetic.py``;
the port imports nothing of ``repro``, and the stream must be the same
bits: ``np.random.default_rng([seed, step])``).

The stream is a *function of (seed, step)* — no files, no cursors — so the
iterator's checkpoint state is a single integer and restore-after-failure
reproduces the exact batch sequence (a requirement for deterministic
elastic restarts).  Tokens follow a noisy autoregressive walk so small
models show a real, monotone loss decrease (unlike uniform noise).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    num_codebooks: int = 0
    # VLM stub
    num_image_tokens: int = 0
    d_model: int = 0


def _rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng([cfg.seed, step])


def batch_at(cfg: DataConfig, step: int) -> dict:
    """Deterministic batch for a given step."""
    rng = _rng(cfg, step)
    B, S, V = cfg.batch_size, cfg.seq_len, cfg.vocab_size
    shape = (B, S, cfg.num_codebooks) if cfg.num_codebooks else (B, S)
    start = rng.integers(0, V, size=shape[:1] + shape[2:])
    stride = rng.integers(1, 7, size=shape[:1] + shape[2:])
    noise = (rng.random(shape) < 0.05) * rng.integers(0, V, size=shape)
    t = np.arange(S)
    walk = ((start[:, None, :] + stride[:, None, :] * t[None, :, None]) % V
            if cfg.num_codebooks
            else (start[:, None] + stride[:, None] * t[None, :]) % V)
    tokens = np.where(noise > 0, noise, walk).astype(np.int32)
    batch = {"tokens": tokens}
    if cfg.num_image_tokens:
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32) * 0.02
        batch["image_positions"] = np.tile(
            np.arange(cfg.num_image_tokens, dtype=np.int32), (B, 1))
    return batch


class SyntheticIterator:
    """Checkpointable iterator: state == next step index."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = batch_at(self.cfg, self.step)
        self.step += 1
        return b

    def state(self) -> int:
        return self.step

    def restore(self, state: int):
        self.step = int(state)


def data_config_for(model_cfg, seq_len: int, batch_size: int,
                    seed: int = 0) -> DataConfig:
    return DataConfig(
        vocab_size=model_cfg.vocab_size,
        seq_len=seq_len,
        batch_size=batch_size,
        seed=seed,
        num_codebooks=model_cfg.num_codebooks,
        num_image_tokens=(model_cfg.num_image_tokens
                          if model_cfg.vision_stub else 0),
        d_model=model_cfg.d_model,
    )
