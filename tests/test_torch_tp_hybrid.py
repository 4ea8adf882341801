"""Training of Mamba-2, the Jamba hybrid and MLA (deepseek-v3-671b) on a
(data, model) mesh (``torch.distributed``, gloo CPU ranks) against the JAX
package's single-device step on the same global batch, as
``tests/test_torch_tp_train.py`` holds the dense and MoE configs (its rank
worker, cases and gates; ``tests/test_torch_dp_train.py``'s ``TOL`` and
``LEAF_TOL``).

Reduced configs in fp32, weights made by the JAX initialiser and cut to
each rank's parts by the bridge:

  * mamba2-130m: 8 SSD heads of 32 columns, one group of B/C columns;
    ``in_proj`` and the conv whole on every rank, ``out_proj``'s rows and
    the vocabulary split;
  * jamba-v0.1-52b: two super-blocks of 4 layers (Mamba with the dense
    FFN, Mamba with the MoE, attention with 4 query heads over one KV
    head), 8 experts, under Adafactor as on the card;
  * deepseek-v3-671b: MLA at 4 heads, a dense layer then MoE layers with
    sigmoid scoring and a shared expert, and the MTP block, under
    Adafactor.

Two steps at (1, 2), (2, 2) (ZeRO-1 over the data axis, the MoE routing
the rows of both data ranks) and (1, 4); AdamW on mamba2-130m, Adafactor
on all three.  The loss, cross-entropy, MoE aux and MTP loss and the grad
norm within ``TOL``, params and optimizer state leaf by leaf within
``LEAF_TOL`` of the leaf's largest magnitude, and each rank's param and
state bytes equal to its specs' count.  A checkpoint of the jamba steps at
(1, 2) restores at (1, 1) onto JAX's leaves.

Every rank group starts at once (a module fixture) and runs while this
process makes the JAX references, in threads.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from jax.sharding import AbstractMesh
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.models.params import Param
from repro_torch.sharding import tp
from repro_torch.sharding.rules import make_rules
from test_torch_dp_train import (LEAF_TOL, TOL, _jax_params, _jax_run,
                                 assert_close_leaves)
from test_torch_tp_train import check_steps, start_ranks, step_case

MAMBA, JAMBA, DEEPSEEK = "mamba2-130m", "jamba-v0.1-52b", "deepseek-v3-671b"
CASES = {
    (1, 2): [(MAMBA, "adamw"), (MAMBA, "adafactor"), (JAMBA, "adafactor"),
             (DEEPSEEK, "adafactor")],
    (2, 2): [(MAMBA, "adamw"), (JAMBA, "adafactor"), (DEEPSEEK, "adafactor")],
    (1, 4): [(MAMBA, "adafactor"), (JAMBA, "adafactor"),
             (DEEPSEEK, "adafactor")],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: (cases, a function returning rank 0's results once)} and the
    directory of the jamba checkpoint the (1, 2) ranks write."""
    tmp = tmp_path_factory.mktemp("hybrid")
    ckpt_dir = tmp / "ckpt"
    combos = sorted({c for cs in CASES.values() for c in cs})
    # the JAX initialiser and steps in threads (XLA leaves the GIL while
    # it compiles and runs): the weights first, which the ranks take
    with ThreadPoolExecutor(len(combos)) as ex:
        list(ex.map(_jax_params, sorted({a for a, _ in combos})))
    started = {}
    for mesh, combos in CASES.items():
        cases = [step_case(a, o) for a, o in combos]
        if mesh == (1, 2):
            i = combos.index((JAMBA, "adafactor"))
            cases[i] = dict(cases[i], save=str(ckpt_dir))
        started[mesh] = (cases, _once(start_ranks(
            mesh, cases, tmp, f"m{mesh[0]}x{mesh[1]}")))
    with ThreadPoolExecutor(len(combos)) as ex:     # while the ranks run
        list(ex.map(lambda c: _jax_run(*c), combos))
    return started, ckpt_dir, tmp


def _once(wait):
    box = []

    def get():
        if not box:
            box.append(wait())
        return box[0]

    return get


@pytest.mark.parametrize("mesh", list(CASES), ids=lambda m: f"{m[0]}x{m[1]}")
def test_hybrid_steps_match_the_jax_single_device_step(mesh, runs):
    cases, results = runs[0][mesh]
    for case, res in zip(cases, results(), strict=True):
        label = f"{case['arch']} {case['optimizer']} at {mesh}"
        want = _jax_run(case["arch"], case["optimizer"])
        check_steps(res, want, label, mesh)
        if case["arch"] == DEEPSEEK:
            for got, w in zip(res["metrics"], want[0], strict=True):
                np.testing.assert_allclose(got["mtp"], w["mtp"], **TOL,
                                           err_msg=f"{label} mtp")


def test_hybrid_checkpoint_saved_at_1x2_restores_at_1x1(runs):
    """The jamba steps' params and Adafactor state, written at (1, 2) from
    each rank's parts (the SSD heads' ``out_proj`` rows, the experts, the
    vocabulary), restore whole at (1, 1) onto JAX's leaves after the same
    steps."""
    started, ckpt_dir, tmp = runs
    started[(1, 2)][1]()            # the checkpoint is written
    res, = start_ranks((1, 1), [{"kind": "restored", "arch": JAMBA,
                                 "optimizer": "adafactor", "float32": True,
                                 "dir": str(ckpt_dir)}], tmp, "m1x1")()
    _, want_p, want_s = _jax_run(JAMBA, "adafactor")
    assert res["step"] == 2
    got = res["state"]
    assert_close_leaves({k[len("params/"):]: v for k, v in got.items()
                         if k.startswith("params/")}, want_p, LEAF_TOL)
    assert_close_leaves({k[len("opt/"):]: v for k, v in got.items()
                         if k.startswith("opt/")}, want_s, LEAF_TOL)


def _mixer_logical(descr, seg: int, group: str | None = None) -> dict:
    layer = descr["segments"][seg]
    if group is not None:
        layer = layer[group]
    return {k: p.logical for k, p in layer["mixer"].items()}


@pytest.mark.parametrize("model", [2, 4, 16])
def test_mamba_layout_splits_whole_ssd_heads(model):
    """At the published widths: ``in_proj`` and the conv whole on every
    rank, ``out_proj``'s rows split where the SSD heads divide the axis
    (mamba2-130m's 24 heads at 2 and 4, jamba's 128 at all three), and
    the whole mixer whole where they do not (24 heads at 16, though its
    1,536 rows would split); the attention group keeps its heads."""
    rules = make_rules(AbstractMesh((1, model), ("data", "model")))
    for arch, seg, group in ((MAMBA, 0, None),
                             (JAMBA, 0, "mamba_moe")):
        cfg = get_config(arch)
        descr = tp.layout_descr(cfg, lm.make_lm(cfg), rules)
        got = _mixer_logical(descr, seg, group)
        split = cfg.ssm.n_heads(cfg.d_model) % model == 0
        assert split == tp.ssm_heads_split(cfg, model)
        for name in ("in_proj", "conv_w", "conv_b"):
            assert "ffn" not in got[name], (arch, name)
            assert rules.spec(got[name]) == (None,) * len(got[name])
        want = ("layers", "ffn", "embed") if split \
            else ("layers", None, "embed")
        if group is not None:
            want = ("layers",) + want
        assert got["out_proj"] == want, (arch, got["out_proj"])
        if group is not None:       # the attention group keeps its heads
            attn = _mixer_logical(descr, seg, "attn_dense")
            assert attn["wq"][-1] == "heads"


def test_ssd_heads_over_groups():
    """With more than one group of B/C columns a rank's SSD heads take
    whole groups or lie in one group (``local_groups``), else the split
    is refused naming item 9b."""
    base = get_config(MAMBA)            # 24 heads
    cfg2 = base.replace(ssm=dataclasses.replace(base.ssm, n_groups=2))
    assert tp.ssm_heads_split(cfg2, 2) and tp.local_groups(cfg2, 2, 1) == (
        1, 2)
    assert tp.local_groups(cfg2, 4, 1) == (0, 1)
    assert tp.local_groups(cfg2, 4, 2) == (1, 2)
    cfg8 = base.replace(ssm=dataclasses.replace(base.ssm, n_groups=8))
    # (3 heads a group)
    assert tp.local_groups(cfg8, 2, 1) == (4, 8)
    with pytest.raises(NotImplementedError, match="Queue A item 9b"):
        tp.ssm_heads_split(cfg8, 3)     # 8 heads a rank over groups of 3
    assert not tp.ssm_heads_split(cfg8, 5)      # 24 heads do not divide


def test_mla_layout_splits_the_heads_not_the_low_rank():
    """deepseek-v3-671b's MLA at a model axis of 8: ``wuq``, ``wuk``,
    ``wuv`` by columns and ``wo`` by rows over its 128 heads, the
    low-rank ``wdq``, ``wdkv``, ``wkr`` and the norms whole; the shared
    expert's columns split as the dense FFN's."""
    rules = make_rules(AbstractMesh((1, 8), ("data", "model")))
    cfg = get_config(DEEPSEEK)
    descr = tp.layout_descr(cfg, lm.make_lm(cfg), rules)
    layer = descr["segments"][1]
    mixer = layer["mixer"]

    def spec(p: Param):
        return tuple(rules.spec(p.logical, p.shape))

    for name in ("wuq", "wuk", "wuv"):
        assert spec(mixer[name]) == (None, None, "model"), name
    assert spec(mixer["wo"]) == (None, "model", None)
    for name in ("wdq", "wdkv", "wkr", "q_norm", "kv_norm"):
        assert "model" not in spec(mixer[name]), name
    assert spec(layer["ffn"]["shared"]["wi"]) == (None, None, "model")
    assert spec(descr["mtp"][0]["proj"]) == (None, None)
