"""``input_specs`` on the ``meta`` device: stand-ins (shapes and dtypes, no
memory) for every model input of every (arch x shape) cell, plus the
param, optimizer and cache trees, with the JAX package's leaf paths,
shapes and dtypes (``repro/launch/inputs.py`` with ``rules=None``).

There is no ``rules`` argument: the dry-run on a mesh is ROADMAP Queue A
item 9c, and the port's cells run on one card.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ShapeConfig
from repro_torch.models import lm
from repro_torch.models.params import init_params

META = torch.device("meta")


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg, shape: ShapeConfig):
    """The data batch for a cell (train/prefill: full sequences;
    decode: one new token per sequence + positions)."""
    B, S = shape.global_batch, shape.seq_len
    specs = {}
    if shape.kind in ("train", "prefill"):
        tok_shape = (B, S, cfg.num_codebooks) if cfg.num_codebooks else (B, S)
        specs["tokens"] = _meta(tok_shape, torch.int32)
        if cfg.vision_stub:
            N = cfg.num_image_tokens
            specs["image_embeds"] = _meta((B, N, cfg.d_model),
                                          torch.bfloat16)
            specs["image_positions"] = _meta((B, N), torch.int32)
    else:  # decode
        tok_shape = (B, 1, cfg.num_codebooks) if cfg.num_codebooks else (B, 1)
        specs["tokens"] = _meta(tok_shape, torch.int32)
        specs["pos"] = _meta((B,), torch.int32)
    return specs


def cache_specs(cfg, shape: ShapeConfig):
    assert shape.kind == "decode"
    return lm.make_cache(cfg, shape.global_batch, shape.seq_len, device=META)


def param_specs_abstract(cfg):
    return init_params(lm.make_lm(cfg), None, META)


def opt_specs_abstract(cfg, opt, params=None):
    """The optimizer state of ``params`` (``param_specs_abstract``'s when
    None); one card holds all of it, so ZeRO-1 has nothing to shard."""
    return opt.init(param_specs_abstract(cfg) if params is None else params)


def input_specs(cfg, shape: ShapeConfig, opt=None):
    """Everything the step needs, as meta tensors.

    train  -> (params, opt_state, batch, step)
    prefill-> (params, batch)
    decode -> (params, batch, cache)
    """
    params = param_specs_abstract(cfg)
    batch = batch_specs(cfg, shape)
    if shape.kind == "train":
        assert opt is not None
        opt_state = opt_specs_abstract(cfg, opt, params)
        step = _meta((), torch.int32)
        return (params, opt_state, batch, step)
    if shape.kind == "prefill":
        return (params, batch)
    return (params, batch, cache_specs(cfg, shape))
