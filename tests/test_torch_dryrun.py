"""The port's one-card dry-run (``repro_torch.launch.dryrun``) and what it
stands on, on the CPU, against the JAX package:

* the copies: ``configs/shapes.py``, ``configs/analysis.py``,
  ``launch/aggregate.py`` and ``launch/hillclimb.py`` equal their twins
  once ``repro.`` is rewritten to ``repro_torch.`` (``aggregate`` imports
  ``PEAK_FLOPS``, ``HBM_BW`` and ``ICI_BW`` from the port's ``roofline``,
  which names the H100's constants so, and so differs nowhere), and
  ``cells()`` equals the reference's;
* the ``meta`` input trees: leaf paths, shapes and dtypes of JAX's
  ``input_specs(cfg, shape, None)`` for every reduced config, and the bytes
  of every full config x production shape equal to the JAX package's
  ``tree_local_bytes``, exactly;
* counted FLOPs against JAX's ``cost_analysis()`` of the same unrolled
  step, lowered on one CPU device with no mesh: the port's count lies in
  ``FLOP_BAND`` of XLA's (the port counts products and its kernels' live
  work; XLA also counts the elementwise ops and the plain attention's
  masked half), and a decode step's within ``DECODE_BAND`` of
  ``model_flops`` less the MTP modules a decode step does not run, plus
  the MoE experts' capacity padding (every expert computes its C slots);
* the six kernel wrappers' ``meta`` branches: the plain versions' output
  shapes and dtypes, and exactly the shared work formula's record;
* the peak estimate, the roofline arithmetic (the reference's module
  constants monkeypatched to the port's, in the test only), what the
  distribution variants and meshes do (they lower on a fake world;
  sequence sharding is refused, ROADMAP Queue A item 9c part 2;
  ``tests/test_torch_mesh_dryrun.py`` holds the mesh cells).
"""
from __future__ import annotations

import importlib
import os
from dataclasses import asdict
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import repro.launch.roofline as ref_roofline
from repro.configs import cells as ref_cells
from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.configs.shapes import ShapeConfig as RefShape
from repro.launch.inputs import input_specs as ref_input_specs
from repro.models import lm as jlm
from repro.models.params import _path_str
from repro.train.optimizer import get_optimizer as ref_get_optimizer
from repro.train.schedule import warmup_cosine as ref_warmup_cosine
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeConfig, cells
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.analysis import _layer_kinds, _attn_params
from repro_torch.configs.analysis import _dense_ffn_params, model_flops
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels import work
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.inputs import input_specs
from repro_torch.models.moe import _capacity
from repro_torch.train.optimizer import get_optimizer

# one intra-op thread a process: pytest-xdist's workers share the host's
# cores, and each would otherwise start a pool as wide as the host
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"
# the port's count / XLA's, prefill and train cells
FLOP_BAND = (0.80, 1.00)
# the port's count / the expected decode FLOPs
DECODE_BAND = (0.95, 1.05)
FLOP_ARCHS = ("smollm-360m", "mamba2-130m", "olmoe-1b-7b",
              "deepseek-v3-671b", "jamba-v0.1-52b")
META = torch.device("meta")


def _ref_dryrun():
    """``repro.launch.dryrun``, whose import sets ``XLA_FLAGS``: imported
    with the environment put back as it was."""
    with mock.patch.dict(os.environ):
        return importlib.import_module("repro.launch.dryrun")


# ---------------------------------------------------------------------------
# the copies
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rel", ["configs/shapes.py", "configs/analysis.py",
                                 "launch/aggregate.py", "launch/hillclimb.py"])
def test_copy_equals_its_twin_after_the_rewrite(rel):
    want = (REF / rel).read_text().replace("repro.", "repro_torch.")
    assert (PORT / rel).read_text() == want


@pytest.mark.parametrize("inapplicable", [False, True])
def test_cells_equal_the_reference(inapplicable):
    assert cells(inapplicable) == ref_cells(inapplicable)
    assert len(cells(True)) == len(ARCH_IDS) * len(SHAPES)


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------
def _jax_flat(tree) -> dict:
    return {_path_str(p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        assert tree.device == META
        return {prefix: (tuple(tree.shape),
                         str(tree.dtype).removeprefix("torch."))}
    out = {}
    for k, v in items:
        out.update(_port_flat(v, f"{prefix}/{k}" if prefix else k))
    return out


SMALL = [ShapeConfig("t", 32, 2, "train"), ShapeConfig("p", 32, 2, "prefill"),
         ShapeConfig("d", 64, 2, "decode")]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_trees_match_jax_input_specs(arch):
    for shape in SMALL:
        ref_shape = RefShape(shape.name, shape.seq_len, shape.global_batch,
                             shape.kind)
        for opt_name in (("adamw", "adafactor") if shape.kind == "train"
                         else ("adamw",)):
            want = _jax_flat(ref_input_specs(
                ref_reduced_config(arch), ref_shape, None,
                opt=ref_get_optimizer(opt_name), opt_name=opt_name))
            got = _port_flat(input_specs(reduced_config(arch), shape,
                                         opt=get_optimizer(opt_name)))
            assert got == want, (arch, shape.kind, opt_name)


def test_input_bytes_equal_jax_for_every_full_cell():
    ref_bytes = _ref_dryrun().tree_local_bytes
    adamw, ref_adamw = get_optimizer("adamw"), ref_get_optimizer("adamw")
    for arch in ARCH_IDS:
        for name, shape in SHAPES.items():
            want = ref_bytes(ref_input_specs(ref_get_config(arch),
                                             REF_SHAPES[name], None,
                                             opt=ref_adamw))
            got = dryrun.tree_local_bytes(input_specs(get_config(arch), shape,
                                                      opt=adamw))
            assert got == want, (arch, name)


# ---------------------------------------------------------------------------
# counted FLOPs
# ---------------------------------------------------------------------------
def _xla_flops(arch: str, shape: ShapeConfig) -> float:
    """``cost_analysis()`` of JAX's unrolled step, lowered on one CPU
    device with no mesh (the traced program, before XLA's passes)."""
    cfg = ref_reduced_config(arch)
    ref_shape = RefShape("x", shape.seq_len, shape.global_batch, shape.kind)
    if shape.kind == "train":
        opt = ref_get_optimizer("adamw")
        fn = ref_make_train_step(cfg, opt, ref_warmup_cosine(3e-4, 100, 10_000),
                                 remat=True, unroll=True)
        args = ref_input_specs(cfg, ref_shape, None, opt=opt)
    else:
        def fn(p, b):
            return jlm.prefill(cfg, p, b, unroll=True)
        args = ref_input_specs(cfg, ref_shape, None)
    return float(jax.jit(fn).lower(*args).cost_analysis()["flops"])


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_counted_flops_track_xla(arch, kind):
    shape = ShapeConfig("x", 128, 2, kind)
    low = dryrun.lower(reduced_config(arch), shape, dryrun.parse_variant([]))
    assert low["flops"] == low["flops_products"] + low["flops_kernels"]
    assert low["flops_kernels"] > 0        # the kernels' work is counted
    ratio = low["flops"] / _xla_flops(arch, shape)
    assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1], ratio


def _expected_decode_flops(cfg, shape) -> float:
    """``model_flops`` of a decode step, less the MTP modules (which a
    decode step does not run), plus each MoE layer's padding: its experts
    compute E x C rows (``moe._capacity``) where ``model_flops`` counts the
    tokens' top-k."""
    flops = model_flops(cfg, shape)
    B = shape.global_batch
    if cfg.mtp_depth:
        d = cfg.d_model
        per = (_attn_params(cfg)
               + _dense_ffn_params(cfg, cfg.d_ff_dense or cfg.d_ff)
               + 2 * d * d + 3 * d)
        flops -= 2.0 * cfg.mtp_depth * per * B
    moe_layers = sum(f == "moe" for _, f in _layer_kinds(cfg))
    if moe_layers:
        m = cfg.moe
        rows = m.num_experts * _capacity(cfg, B) - B * m.top_k
        flops += 2.0 * moe_layers * 3 * cfg.d_model * m.d_ff_expert * rows
    return flops


@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_decode_flops_track_model_flops(arch):
    cfg, shape = reduced_config(arch), ShapeConfig("x", 256, 2, "decode")
    low = dryrun.lower(cfg, shape, dryrun.parse_variant([]))
    ratio = low["flops"] / _expected_decode_flops(cfg, shape)
    assert DECODE_BAND[0] <= ratio <= DECODE_BAND[1], ratio


# ---------------------------------------------------------------------------
# the kernel wrappers' meta branches
# ---------------------------------------------------------------------------
def _rand(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape)).to(dtype)


def _meta(*ts):
    return [None if t is None else t.to(META) for t in ts]


def _same_kind(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert [None if t is None else (t.shape, t.dtype, t.device.type)
            for t in got] == [None if t is None else
                              (t.shape, t.dtype, "meta") for t in want]


def _record_of(fn):
    with work.counting() as tally:
        out = fn()
    return out, tally.as_dict()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_meta_branches(dtype):
    rng = np.random.default_rng(0)
    q, k, v = (_rand(rng, 2, 40, 4, 32, dtype=dtype),
               _rand(rng, 2, 40, 2, 32, dtype=dtype),
               _rand(rng, 2, 40, 2, 32, dtype=dtype))
    for causal, q_offset in ((True, 0), (True, 7), (False, 0)):
        want = fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
        mq, mk, mv = _meta(q, k, v)
        got, rec = _record_of(lambda mq=mq, mk=mk, mv=mv, c=causal,
                              o=q_offset: fa.flash_attention(
                                  mq, mk, mv, causal=c, q_offset=o))
        _same_kind(got, want)
        n_bytes, n_flops = work.flash_work(mq, mk, mv, q_offset, causal)
        assert rec == {"flash_attention": {"calls": 1, "bytes": n_bytes,
                                           "flops": n_flops}}
    # the autograd Function: forward with its lse, then the backward
    out, lse = fa.flash_attention_lse_plain(q, k, v)
    dout = _rand(rng, *out.shape, dtype=dtype)
    want = fa.flash_attention_bwd(q, k, v, out, lse, dout)
    mq, mk, mv = (t.requires_grad_() for t in _meta(q, k, v))

    def fwd_bwd():
        o = fa.flash_attention(mq, mk, mv)
        o.backward(dout.to(META))
        return mq.grad, mk.grad, mv.grad

    got, rec = _record_of(fwd_bwd)
    _same_kind(got, want)
    f_bytes, f_flops = work.flash_work(mq, mk, mv, with_lse=True)
    b_bytes, b_flops = work.flash_bwd_work(mq, mk, mv)
    assert rec == {"flash_attention": {"calls": 1, "bytes": f_bytes,
                                       "flops": f_flops},
                   "flash_attention_bwd": {"calls": 1, "bytes": b_bytes,
                                           "flops": b_flops}}
    # and the backward wrapper alone
    got, rec = _record_of(lambda: fa.flash_attention_bwd(
        *_meta(q, k, v, out, lse, dout)))
    _same_kind(got, want)
    assert rec["flash_attention_bwd"]["flops"] == b_flops


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_meta_branches_count_every_row(dtype):
    rng = np.random.default_rng(1)
    B, H, K, D, Sk = 3, 8, 2, 64, 96
    q = _rand(rng, B, H, D, dtype=dtype)
    k, v = (_rand(rng, B, Sk, K, D, dtype=dtype) for _ in range(2))
    kv_len = torch.tensor([5, 96, 40], dtype=torch.int32)
    want = da.decode_attention(q, k, v, kv_len)
    mq, mk, mv, ml = _meta(q, k, v, kv_len)
    got, rec = _record_of(lambda: da.decode_attention(mq, mk, mv, ml))
    _same_kind(got, want)
    n_bytes, n_flops = work.decode_work(mq, mk, mv, ml)
    assert n_flops == 2 * H * 2 * D * B * Sk       # every row, no kv_len
    assert n_flops > work.decode_work(q, k, v, kv_len)[1]
    assert rec == {"decode_attention": {"calls": 1, "bytes": n_bytes,
                                        "flops": n_flops}}
    # paged: a pool of 16 pages of 16 rows, 4 table entries a slot
    P, ps, W = 16, 16, 4
    kp, vp = (_rand(rng, P, ps, K, D, dtype=dtype) for _ in range(2))
    table = torch.from_numpy(rng.permutation(P)[:B * W].reshape(B, W)
                             ).to(torch.int32)
    kv_len = torch.tensor([1, 64, 33], dtype=torch.int32)
    want = da.decode_attention_paged(q, kp, vp, table, kv_len)
    margs = _meta(q, kp, vp, table, kv_len)
    got, rec = _record_of(lambda: da.decode_attention_paged(*margs))
    _same_kind(got, want)
    n_bytes, n_flops = work.paged_work(*margs)
    assert n_flops == 2 * H * 2 * D * B * W * ps
    assert rec == {"decode_attention_paged": {"calls": 1, "bytes": n_bytes,
                                              "flops": n_flops}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_meta_branches(dtype):
    rng = np.random.default_rng(2)
    B, S, H, P, G, N, chunk = 2, 100, 4, 32, 2, 16, 32
    x = _rand(rng, B, S, H, P, dtype=dtype)
    dt = torch.from_numpy(rng.uniform(0.01, 0.1, (B, S, H))).float()
    A = -torch.from_numpy(rng.uniform(0.5, 1.5, (H,))).float()
    Bm, Cm = (_rand(rng, B, S, G, N, dtype=dtype) for _ in range(2))
    h0 = _rand(rng, B, H, P, N)
    want = ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h0,
                        return_final_state=True)
    margs = _meta(x, dt, A, Bm, Cm, h0)
    got, rec = _record_of(lambda: ssd.ssd_scan(
        *margs[:5], chunk=chunk, h0=margs[5], return_final_state=True))
    _same_kind(got, want)
    n_bytes, n_flops = work.ssd_work(margs[0], margs[1], margs[3], chunk,
                                     margs[5])
    assert rec == {"ssd_scan": {"calls": 1, "bytes": n_bytes,
                                "flops": n_flops}}
    # the backward wrapper, with the forward's scratch, and through autograd
    dy, dhT = _rand(rng, B, S, H, P, dtype=dtype), _rand(rng, B, H, P, N)
    want = ssd.ssd_scan_bwd(x, dt, A, Bm, Cm, h0, dy, dhT, chunk=chunk)
    _, _, states = ssd._forward(*margs, chunk, True)
    got, rec = _record_of(lambda: ssd.ssd_scan_bwd(
        *margs, dy.to(META), dhT.to(META), chunk=chunk, states=states))
    _same_kind(got, want)
    b_bytes, b_flops = work.ssd_bwd_work(margs[0], margs[1], margs[3], chunk,
                                         margs[5], dhT)
    assert rec == {"ssd_scan_bwd": {"calls": 1, "bytes": b_bytes,
                                    "flops": b_flops}}
    mx = margs[0].requires_grad_()

    def fwd_bwd():
        y = ssd.ssd_scan(mx, *margs[1:5], chunk=chunk)
        y.backward(dy.to(META))
        return mx.grad

    got, rec = _record_of(fwd_bwd)
    _same_kind(got, x)
    assert sorted(rec) == ["ssd_scan", "ssd_scan_bwd"]
    assert rec["ssd_scan_bwd"]["flops"] == work.ssd_bwd_work(
        mx, margs[1], margs[3], chunk)[1]


class _Elsewhere:
    """A stand-in for a tensor on a device the port does not dispatch."""

    def __init__(self, t):
        self.shape, self.dtype, self.ndim = t.shape, t.dtype, t.ndim
        self.device = torch.device("xpu")
        self.requires_grad = False


def test_another_device_raises():
    q, k = torch.zeros(1, 8, 2, 32), torch.zeros(1, 8, 1, 32)
    x, dt, A = torch.zeros(1, 8, 2, 32), torch.zeros(1, 8, 2), torch.zeros(2)
    Bm, kv = torch.zeros(1, 8, 1, 16), torch.zeros(1, dtype=torch.int32)
    e = _Elsewhere
    calls = [
        lambda: fa.flash_attention(e(q), e(k), e(k)),
        lambda: fa.flash_attention_bwd(e(q), e(k), e(k), e(q), e(q), e(q)),
        lambda: da.decode_attention(e(q[:, 0]), e(k), e(k), e(kv)),
        lambda: da.decode_attention_paged(e(q[:, 0]), e(k), e(k), e(kv),
                                          e(kv)),
        lambda: ssd.ssd_scan(e(x), e(dt), e(A), e(Bm), e(Bm), chunk=4),
        lambda: ssd.ssd_scan_bwd(e(x), e(dt), e(A), e(Bm), e(Bm), None,
                                 e(x), chunk=4),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="'xpu'"):
            call()


def test_live_pairs_is_the_sum_it_replaces():
    for Sq in (1, 7, 64):
        for Sk in (1, 9, 64, 100):
            for q_offset in (-3, 0, 5, 90):
                want = sum(min(Sk, max(0, t + q_offset + 1))
                           for t in range(Sq))
                assert work.live_pairs(Sq, Sk, q_offset) == want
                assert work.live_pairs(Sq, Sk, q_offset, False) == Sq * Sk


# ---------------------------------------------------------------------------
# the peak estimate, the roofline, the refusals
# ---------------------------------------------------------------------------
def test_peak_estimate_lies_between_inputs_and_all_traced_bytes():
    low = dryrun.lower(reduced_config("smollm-360m"),
                       ShapeConfig("t", 64, 2, "train"),
                       dryrun.parse_variant([]))
    inputs = low["bytes_per_device_inputs"]
    assert inputs < low["peak_estimate_bytes"] < low["allocated_bytes"]
    # donate=0 keeps the old params and optimizer state beside the new
    kept = dryrun.lower(reduced_config("smollm-360m"),
                        ShapeConfig("t", 64, 2, "train"),
                        dryrun.parse_variant(["donate=0"]))
    assert kept["peak_estimate_bytes"] > low["peak_estimate_bytes"]


def test_a_cell_over_the_budget_exceeds_the_device():
    kw = dict(seg_counts=(2,), device="meta", verbose=False)
    free = dryrun.run_cell("smollm-360m", "decode_32k", **kw)
    peak = free["peak_estimate_bytes"]
    assert free["status"] == "ok" and free["chips"] == 1
    assert free["bytes_per_device_inputs"] <= peak
    assert dryrun.run_cell("smollm-360m", "decode_32k", budget_bytes=peak,
                           **kw)["status"] == "ok"
    over = dryrun.run_cell("smollm-360m", "decode_32k",
                           budget_bytes=peak - 1, **kw)
    assert over["status"] == "exceeds_device"
    assert over["roofline"] == free["roofline"]
    assert over["kernel_launches"] == {} and over["compile_s"] == 0.0
    assert dryrun.run_cell("smollm-360m", "long_500k", **kw)["status"] \
        == "inapplicable"


@pytest.mark.parametrize("chips", [1, 4])
@pytest.mark.parametrize("flops,nbytes,coll", [
    (3.3e12, 1.0e9, 0.0), (1.0e9, 6.7e11, 0.0), (1.0e6, 1.0e6, 2.0e12)])
def test_roofline_terms_equal_the_reference(monkeypatch, chips, flops,
                                            nbytes, coll):
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(ref_roofline, name, getattr(roofline, name))
    kw = dict(arch="a", shape="s", mesh_desc="m", chips=chips,
              model_flops=2.5e12, bytes_per_device=7.0)
    got = roofline.analyze(cost={"flops": flops, "bytes accessed": nbytes},
                           hlo_text="", **kw)
    want = ref_roofline.analyze(cost={"flops": flops,
                                      "bytes accessed": nbytes},
                                hlo_text="", **kw)
    assert asdict(got) == asdict(want)
    fields = dict(arch="a", shape="s", mesh="m", chips=chips,
                  hlo_flops=flops, hlo_bytes=nbytes,
                  collective_bytes_per_chip=coll, collectives={},
                  collective_counts={}, model_flops=2.5e12)
    assert asdict(roofline.Roofline(**fields).finalize()) == asdict(
        ref_roofline.Roofline(**fields).finalize())
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.ICI_BW) == (
        989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("kw", [
    dict(multi_pod=True), dict(mesh_shape=(2, 4)),
    dict(variant={"seq_shard": 1}), dict(variant={"kv_shard_model": 1}),
    dict(variant={"sp_model": 1}), dict(variant={"dp_only": 1}),
    dict(variant={"moe": "ep"})])
def test_distribution_is_refused(kw):
    """Sequence sharding alone is refused (item 9c part 2); the meshes
    and the other variants lower, on a fake world of the mesh's size."""
    run = dict(device="meta", verbose=False, seg_counts=(2,), **kw)
    if any(k in kw.get("variant", {}) for k in dryrun.SEQUENCE_VARIANTS):
        with pytest.raises(NotImplementedError, match="Queue A item 9c"):
            dryrun.run_cell("olmoe-1b-7b", "decode_32k", **run)
        return
    rec = dryrun.run_cell("olmoe-1b-7b", "decode_32k", **run)
    assert rec["status"] == "ok"
    assert rec["chips"] == {"multi_pod": 512, "mesh_shape": 8}.get(
        next(iter(kw)), 1)
    assert not torch.distributed.is_initialized()


def test_the_cli_refuses_and_needs_the_card(tmp_path):
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                     "--multi-pod", "--variant", "seq_shard=1",
                     "--device", "meta"])
    with pytest.raises(ValueError, match="unknown variants"):
        dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                     "--variant", "flash_block=64", "--device", "meta"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                         "--seg-counts", "2"])
    out = tmp_path / "cell.json"
    dryrun.main(["--arch", "mamba2-130m", "--shape", "decode_32k",
                 "--seg-counts", "2", "--device", "meta",
                 "--variant", "unroll=1", "zero1=0", "remat=none",
                 "--json", str(out)])
    assert out.exists()


def test_moe_cf_replaces_the_capacity_factor():
    v = dryrun.parse_variant(["moe_cf=0.25"])
    cfg = dryrun.cell_config("deepseek-v3-671b", v, (1, 2))
    assert cfg.moe.capacity_factor == 0.25 and cfg.num_layers == 3
    assert cfg.moe.first_k_dense == 1
    assert dryrun.cell_config("smollm-360m", v).moe is None


def test_a_full_width_cell_lowers_on_meta():
    """The meta trace allocates nothing, whatever the width: deepseek-v3's
    61-layer decode step over a 32k latent cache, which no card holds."""
    low = dryrun.lower(get_config("deepseek-v3-671b"), SHAPES["decode_32k"],
                       dryrun.parse_variant([]))
    assert low["peak_estimate_bytes"] > 80e9
    assert low["flops_products"] > 0 and low["kernels"] == {}
