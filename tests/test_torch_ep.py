"""The expert-parallel MoE dispatch (``REPRO_MOE=ep``) of the port on a
(data, model) mesh of gloo CPU ranks against the reference's
``apply_moe_ep`` on a host mesh.

Under ``ep`` each data shard routes and ranks capacity over its own
tokens, and the aux loss is the mean over the shards, so no single-device
step is its oracle: the reference's own step is, run in a JAX subprocess
on ``jax.sharding.Mesh(devices, ("data", "model"))`` over
``--xla_force_host_platform_device_count=8`` host devices.  That mesh's
axes are Auto: ``jax.make_mesh`` gives Explicit axes in this JAX version,
under which the reference's embedding gather raises, which is why the
reference's own multi-device tests fail here; the reference's code is
unchanged.  The subprocess runs while the ranks run.

Reduced olmoe-1b-7b in fp32, two steps of AdamW and of Adafactor
(ZeRO-1 on) at (2, 2) (experts split over the model axis, two data
shards) and (4, 1) (four data shards, every expert on every rank), with
``tests/test_torch_dp_train.py``'s bounds.  At data 1 the two dispatches
are one function: at (1, 2) the port's ``ep`` and ``gather`` steps agree
within 1e-5.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from test_torch_dp_train import (OPTS, ROOT, STEPS, _batch,
                                 assert_close_leaves)
from test_torch_tp_train import check_steps, start_ranks, step_case

ARCH = "olmoe-1b-7b"
EP_MESHES = ((2, 2), (4, 1))

_JAX_EP = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["REPRO_MOE"] = "ep"
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from repro.configs import reduced_config
from repro.models import lm
from repro.models.params import (_path_str, cast_tree, init_params,
                                 param_shardings)
from repro.sharding.rules import make_rules, use_rules
from repro.sharding.zero import opt_state_shardings
from repro.train import optimizer as jax_opt
from repro.train.schedule import warmup_cosine
from repro.train.train_step import make_train_step

inp, out = sys.argv[1:3]
job = pickle.load(open(inp, "rb"))
cfg = reduced_config(job["arch"]).replace(dtype="float32")
descr = lm.make_lm(cfg)
params = cast_tree(init_params(descr, jax.random.PRNGKey(0)), jnp.float32)


def flat(tree):
    return {_path_str(p): np.asarray(x, np.float32) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


results = {}
for shape in job["meshes"]:
    devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    mesh = jax.sharding.Mesh(devs, ("data", "model"))
    rules = make_rules(mesh)
    psh = param_shardings(descr, rules)
    for name in job["optimizers"]:
        opt = jax_opt.get_optimizer(name)
        osh = opt_state_shardings(name, descr, rules, zero1=True)
        step_fn = make_train_step(cfg, opt, warmup_cosine(1e-3, 2, 10),
                                  clip_norm=1.0, remat=True)

        def wrapped(p, s, b, t):
            with use_rules(rules):
                return step_fn(p, s, b, t)

        fn = jax.jit(wrapped, in_shardings=(psh, osh, None, None),
                     out_shardings=(psh, osh, None))
        p = jax.tree_util.tree_map(jax.device_put, params, psh)
        s = jax.tree_util.tree_map(jax.device_put, opt.init(params), osh)
        metrics = []
        with mesh:
            for step, batch in job["batches"]:
                p, s, m = fn(p, s, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                             jnp.int32(step))
                metrics.append({k: float(v) for k, v in m.items()})
        results[tuple(shape), name] = (metrics, flat(p), flat(s))
with open(out, "wb") as f:
    pickle.dump(results, f)
"""


def start_jax_ep(tmp_path):
    """The reference's ``ep`` steps on the host meshes, in a subprocess;
    returns a function that waits for it: {(mesh, optimizer): (metrics,
    params, state)}."""
    inp, out = tmp_path / "jax_ep.in", tmp_path / "jax_ep.out"
    inp.write_bytes(pickle.dumps({
        "arch": ARCH, "meshes": [list(m) for m in EP_MESHES],
        "optimizers": list(OPTS),
        "batches": [(s, _batch(s)) for s in STEPS]}))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", _JAX_EP, str(inp),
                             str(out)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)

    def wait() -> dict:
        so, se = proc.communicate(timeout=400)
        assert proc.returncode == 0, so[-2000:] + se[-4000:]
        return pickle.loads(out.read_bytes())

    return wait


def test_ep_steps_match_the_reference_on_auto_host_meshes(tmp_path):
    want = start_jax_ep(tmp_path)
    waits = {mesh: start_ranks(mesh, [step_case(ARCH, o, moe="ep")
                                      for o in OPTS], tmp_path,
                               f"ep{mesh[0]}{mesh[1]}")
             for mesh in EP_MESHES}
    got = {mesh: wait() for mesh, wait in waits.items()}
    ref = want()
    for mesh, results in got.items():
        for name, res in zip(OPTS, results, strict=True):
            check_steps(res, ref[mesh, name], f"ep {mesh} {name}", mesh)
    # per-shard capacity and aux: not the single-device step's
    assert ref[(4, 1), "adamw"][0][0]["aux"] != pytest.approx(
        ref[(2, 2), "adamw"][0][0]["aux"], rel=1e-3)


def test_ep_equals_gather_at_data_1(tmp_path):
    cases = [step_case(ARCH, "adamw", moe=moe) for moe in ("ep", "gather")]
    ep, gather = start_ranks((1, 2), cases, tmp_path, "ep_gather")()
    for a, b in zip(ep["metrics"], gather["metrics"], strict=True):
        for key in ("loss", "ce", "aux", "grad_norm"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5, atol=1e-5,
                                       err_msg=key)
    assert_close_leaves(ep["params"], gather["params"], 1e-5)
    assert_close_leaves(ep["state"], gather["state"], 1e-5)
