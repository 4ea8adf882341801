"""``input_specs`` on the ``meta`` device: stand-ins (shapes and dtypes, no
memory) for every model input of every (arch x shape) cell, plus the
param, optimizer and cache trees, with the JAX package's leaf paths and
dtypes (``repro/launch/inputs.py``).

With ``rules`` (a mesh) each leaf is this rank's local shape, where the
reference gives a global ``ShapeDtypeStruct`` and its sharding: the params
by ``tp.layout_descr`` (their model-axis parts), the optimizer state by
ZeRO-1's slices of that layout, the batch's rows by the data axes (every
row where they do not divide the batch, as the reference's spec drops the
axis), and the decode cache by ``tp.cache_layout``.  ``tree_local_bytes``
of such a tree is the reference's per-device byte count.  Sequence
sharding is ROADMAP Queue A item 9c part 2.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ShapeConfig
from repro_torch.models import lm
from repro_torch.models.params import init_params
from repro_torch.sharding import tp
from repro_torch.sharding.rules import ShardingRules, _names

META = torch.device("meta")


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def local_rows(rules: ShardingRules | None, n: int) -> int:
    """The rows of a batch of ``n`` one rank holds: ``n`` over the axes the
    rules map ``batch`` to, where they divide it, else all ``n``."""
    if rules is None:
        return n
    return n // rules.axis_size(_names(rules.spec(("batch",), (n,))[0]))


def batch_specs(cfg, shape: ShapeConfig, rules: ShardingRules | None = None):
    """The data batch for a cell (train/prefill: full sequences;
    decode: one new token per sequence + positions), this rank's rows."""
    B, S = local_rows(rules, shape.global_batch), shape.seq_len
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


def cache_specs(cfg, shape: ShapeConfig, rules: ShardingRules | None = None):
    assert shape.kind == "decode"
    return lm.make_cache(cfg, shape.global_batch, shape.seq_len, device=META,
                         rules=rules)


def layout(cfg, rules: ShardingRules | None):
    """(the params' descriptor tree, each leaf's model-axis part or None)
    as this rank holds them."""
    descr = lm.make_lm(cfg)
    if rules is None:
        return descr, None
    descr = tp.layout_descr(cfg, descr, rules)
    return descr, tp.param_parts(cfg, descr, rules)


def param_specs_abstract(cfg, rules: ShardingRules | None = None):
    descr, parts = layout(cfg, rules)
    return init_params(descr, None, META, parts)


def opt_specs_abstract(cfg, opt, rules: ShardingRules | None = None,
                       zero1: bool = True, params=None):
    """The optimizer state of ``params`` (``param_specs_abstract``'s when
    None): this rank's ZeRO-1 slices with ``rules``, whole on one card."""
    if params is None:
        params = param_specs_abstract(cfg, rules)
    if rules is None:
        return opt.init(params)
    return opt.init(params, opt.layout(layout(cfg, rules)[0], rules,
                                       zero1=zero1))


def input_specs(cfg, shape: ShapeConfig, rules: ShardingRules | None = None,
                opt=None, opt_name: str = "adamw", zero1: bool = True):
    """Everything the step needs, as meta tensors (this rank's with
    ``rules``).  ``opt_name`` is taken for the reference's signature: the
    state's structure is ``opt``'s.

    train  -> (params, opt_state, batch, step)
    prefill-> (params, batch)
    decode -> (params, batch, cache)
    """
    del opt_name
    params = param_specs_abstract(cfg, rules)
    batch = batch_specs(cfg, shape, rules)
    if shape.kind == "train":
        assert opt is not None
        opt_state = opt_specs_abstract(cfg, opt, rules, zero1, params)
        step = _meta((), torch.int32)
        return (params, opt_state, batch, step)
    if shape.kind == "prefill":
        return (params, batch)
    return (params, batch, cache_specs(cfg, shape, rules))
