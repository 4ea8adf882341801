"""The port's three examples (``repro_torch.examples``) against the
reference's (``examples/serve_lm.py``, ``train_lm.py``, ``quickstart.py``)
on the CPU.

- serve_lm: the reference's own ``main`` (its prompts, its JAX engine) and
  the port's ``serve`` on the same fp32 weights, made by the JAX
  initialiser from ``PRNGKey(0)`` as the reference makes them and carried
  across with the weight bridge: equal greedy tokens and decode steps,
  and equal printed token lines, for reduced mamba2-130m, smollm-360m and
  musicgen-medium (4 codebooks).
- train_lm: both packages' ``TrainLMTask`` resume one step-0 checkpoint
  that the JAX checkpointer wrote (fp32, so that the bound of
  ``tests/test_torch_train.py``, 1e-4, holds): equal ``final_step``, the
  logged losses within 1e-4.  Then the port's ``--expocloud --fail-once``
  in a process of its own: one injected failure, the task re-assigned by
  the server and resumed from its step-25 checkpoint, ending at
  ``final_step == steps`` with the last loss of an uninterrupted run.
- quickstart: the sweep section prints the reference's lines; the train
  and dry-run sections run on the CPU and on ``meta``.
- isolation: each example's ``--help`` and a tiny run in a process where
  neither ``jax`` nor ``repro`` can be imported.
"""
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread a process: pytest-xdist's workers share the host's
# cores, and each would otherwise start a pool as wide as the host
torch.set_num_threads(1)

from repro.checkpoint import checkpointer as jax_ckpt
from repro.configs import reduced_config as jax_reduced_config
from repro.models import lm as jlm
from repro.models.params import _path_str, cast_tree, init_params
from repro.serve.engine import Request as JaxRequest
from repro.train import optimizer as jax_opt
from repro_torch.configs import reduced_config
from repro_torch.examples import quickstart, serve_lm, train_lm
from repro_torch.models.convert import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
# values of order 1 (losses), fp32 (tests/test_torch_train.py)
TOL = dict(atol=1e-4, rtol=1e-4)
# the subprocesses' environment: the port on the path, one thread each
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")


def _reference(name: str):
    """The reference's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fp32(arch: str, cfg_fn):
    return cfg_fn(arch).replace(dtype="float32")


def _flat(tree) -> dict:
    return {_path_str(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _token_lines(out: str) -> list:
    return [line for line in out.splitlines() if line.startswith("  req")]


@pytest.mark.parametrize("arch", ["mamba2-130m", "smollm-360m",
                                  "musicgen-medium"])
def test_serve_lm_greedy_tokens_equal_the_reference(arch, monkeypatch):
    """The reference's ``main`` at its defaults (3 slots, 6 requests, 12
    new tokens, greedy) with its config and weights in fp32, against the
    port's ``serve`` on the bridged weights: every request's tokens (a
    (4,) array a step with codebooks), the decode steps and the printed
    token lines equal."""
    ref = _reference("serve_lm")
    jcfg = _fp32(arch, jax_reduced_config)
    pj = cast_tree(init_params(jlm.make_lm(jcfg), jax.random.PRNGKey(0)),
                   jnp.float32)
    made = []

    def request(**kw):
        made.append(JaxRequest(**kw))
        return made[-1]

    monkeypatch.setattr(ref, "reduced_config", lambda a: jcfg)
    monkeypatch.setattr(ref, "init_params", lambda *a, **k: pj)
    monkeypatch.setattr(ref, "Request", request)
    monkeypatch.setattr(sys, "argv", ["serve_lm.py", "--arch", arch])
    want_out = io.StringIO()
    with contextlib.redirect_stdout(want_out):
        ref.main()
    got_out = io.StringIO()
    with contextlib.redirect_stdout(got_out):
        reqs = serve_lm.serve(_fp32(arch, reduced_config),
                              params_from_numpy(_flat(pj), device="cpu"),
                              device="cpu")
    assert len(reqs) == len(made) == 6
    for r, w in zip(reqs, made, strict=True):
        np.testing.assert_array_equal(np.asarray(r.prompt),
                                      np.asarray(w.prompt))
        assert r.done and len(r.output) == len(w.output) == 12
        for a, b in zip(r.output, w.output, strict=True):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    want, got = want_out.getvalue(), got_out.getvalue()
    assert _token_lines(got) == _token_lines(want) and len(_token_lines(got)) == 4
    assert got.split(",")[0] == want.split(",")[0]     # "... in N decode steps"


def _recording(monkeypatch, module, hists: list):
    """Record the unrounded history of each ``run_training`` the module's
    task calls."""
    inner = module.run_training

    def run_training(*args, **kwargs):
        out = inner(*args, **kwargs)
        hists.append(out[0])
        return out
    monkeypatch.setattr(module, "run_training", run_training)


def test_train_lm_task_resumes_a_jax_checkpoint_as_the_reference(
        tmp_path, monkeypatch):
    """Both tasks (reduced smollm-360m in fp32, 30 steps of [2, 32]) find
    the same step-0 checkpoint, written by the JAX checkpointer, and
    resume it: equal final steps, and the losses they log (steps 0 and
    24) within 1e-4."""
    ref = _reference("train_lm")
    jcfg = _fp32("smollm-360m", jax_reduced_config)
    pj = init_params(jlm.make_lm(jcfg), jax.random.PRNGKey(0))
    state = {"params": pj, "opt": jax_opt.AdamW().init(pj)}
    for who in ("reference", "port"):
        jax_ckpt.save(str(tmp_path / who), 0, state,
                      metadata={"data_state": 0})
    monkeypatch.setattr(ref, "reduced_config",
                        lambda a: _fp32(a, jax_reduced_config))
    monkeypatch.setattr(train_lm, "reduced_config",
                        lambda a: _fp32(a, reduced_config))
    want_h, got_h = [], []
    _recording(monkeypatch, ref, want_h)
    _recording(monkeypatch, train_lm, got_h)
    want = ref.TrainLMTask("smollm-360m", "reduced", 30, 32, 2,
                           str(tmp_path / "reference")).run()
    got = train_lm.TrainLMTask("smollm-360m", "reduced", 30, 32, 2,
                               str(tmp_path / "port"), device="cpu").run()
    assert got[0] == want[0] == 30
    assert [h["step"] for h in got_h[0]] == [h["step"] for h in want_h[0]] \
        == [0, 24]
    for g, w in zip(got_h[0], want_h[0], strict=True):
        np.testing.assert_allclose(g["loss"], w["loss"], **TOL)
    assert got[1:] == (round(got_h[0][0]["loss"], 4),
                       round(got_h[0][-1]["loss"], 4))


def test_train_lm_through_expocloud_resumes_after_one_failure(tmp_path):
    """``--expocloud --fail-once`` (75 steps of [2, 32], a checkpoint every
    25): the first worker fails after step 25, the server re-assigns the
    task, and a new worker resumes from the step-25 checkpoint; the CSV
    row ends at step 75 with the last loss of an uninterrupted run, and
    below its own first loss."""
    args = ["--steps", "75", "--seq", "32", "--batch", "2", "--device",
            "cpu"]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.train_lm", "--expocloud",
         "--fail-once", "--ckpt-dir", str(tmp_path / "a"), *args],
        capture_output=True, text=True, env=ENV, timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr
    assert "[train] restored checkpoint at step 25" in proc.stdout
    assert (tmp_path / "a" / ".failed_once").exists()
    header, row = proc.stdout.strip().splitlines()[-2:]
    assert header.startswith("arch,preset,steps,id,final_step,first_loss,"
                             "last_loss,status")
    rec = dict(zip(header.split(","), row.split(","), strict=True))
    assert rec["status"] == "done" and int(rec["final_step"]) == 75
    straight = train_lm.TrainLMTask("smollm-360m", "reduced", 75, 32, 2,
                                    str(tmp_path / "b"), device="cpu").run()
    assert straight[0] == 75
    assert float(rec["last_loss"]) == straight[2]
    assert float(rec["last_loss"]) < float(rec["first_loss"])


def test_quickstart_sweep_prints_the_reference_lines(capsys):
    _reference("quickstart").sweep()
    want = capsys.readouterr().out
    quickstart.sweep()
    got = capsys.readouterr().out
    assert got == want and got.startswith("[1] ExpoCloud sweep:")


def test_quickstart_train_and_dryrun_sections_on_the_cpu(capfd):
    """The train section on the CPU (20 steps, the loss falls) and the
    dry-run section on ``meta`` (cut to 2 layers here): the reference's
    cell on its 2 x 4 (data, model) mesh, one rank of a fake world of 8
    with its collectives counted."""
    quickstart.train("cpu")
    line = capfd.readouterr().out.splitlines()[-1]
    first, last = (float(x) for x in line.split("loss ")[1].split(" -> "))
    assert line.startswith("[2] trained reduced smollm:") and last < first
    quickstart.dryrun("cpu", seg_counts=(2,))
    out = capfd.readouterr().out
    assert "[3] dry-run one cell on an 8-device mesh" in out
    line = next(x for x in out.splitlines() if x.startswith(
        "[dryrun] mamba2-130m x train_4k on data2xmodel4: ok"))
    assert "GB/device" in line and "collective=0.00ms" not in line


_ISOLATED = r"""
import contextlib, io, json, runpy, sys
sys.modules["jax"] = None            # any import of jax now fails
sys.modules["repro"] = None          # and of the JAX package
import torch

torch.set_num_threads(1)
runs = {"serve_lm": ["--device", "cpu", "--requests", "2", "--max-new", "2"],
        "train_lm": ["--device", "cpu", "--steps", "2", "--seq", "16",
                     "--batch", "2", "--ckpt-dir", sys.argv[1]],
        "quickstart": ["--section", "sweep"]}
out = {}
for name, argv in runs.items():
    for args in (["--help"], argv):
        sys.argv = [name] + args
        buf = io.StringIO()
        code = 0
        with contextlib.redirect_stdout(buf):
            try:
                runpy.run_module(f"repro_torch.examples.{name}",
                                 run_name="__main__")
            except SystemExit as e:
                code = e.code
        out[f"{name} {args[0]}"] = [code, buf.getvalue()]
out["loaded"] = sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "repro")
                       and sys.modules[m] is not None)
print(json.dumps(out))
"""


def test_examples_run_where_neither_jax_nor_repro_imports(tmp_path):
    proc = subprocess.run([sys.executable, "-c", _ISOLATED,
                           str(tmp_path / "ckpt")], capture_output=True,
                          text=True, env=ENV, timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out.pop("loaded") == []
    for name in ("serve_lm", "train_lm", "quickstart"):
        code, text = out[f"{name} --help"]
        assert code == 0 and text.startswith("usage:"), name
    assert out["serve_lm --device"][1].startswith("served 2 requests in ")
    assert "[train_lm] result: (2, " in out["train_lm --device"][1]
    assert out["quickstart --section"][1].startswith("[1] ExpoCloud sweep:")
    assert all(code in (0, None) for code, _ in out.values())
