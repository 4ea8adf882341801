"""The port's dry-run bridge into ExpoCloud (``repro_torch.core.sweep``,
``launch/sweep_dryrun.py``, ``launch/aggregate.py``), on the CPU, against
the reference's ``repro.core.sweep``:

* ``DryRunCellTask``'s parameter, result and group titles, parameters,
  timeout and JSON names equal the reference's; its hardness is the
  reference's static tuple scaled by the layers built, with the chip term
  1 (one card); ``probe_plans`` and ``build_tasks`` give the reference's
  cells;
* the port's ``Server`` and ``LocalEngine`` drive two real cells, each a
  subprocess of ``python -m repro_torch.launch.dryrun --device meta``
  (the lower stage), as ``tests/test_system.py``'s
  ``test_expocloud_drives_real_dryrun_cells`` does in the reference; with
  the cells' second probes the reference's ``aggregate.assemble`` reads
  the port's records and gives the port's rows (the reference's roofline
  constants monkeypatched to the H100's, in the test only);
* a cell on the multi-pod mesh fails, naming ROADMAP Queue A item 9.
"""
from __future__ import annotations

import json
import os

import pytest
import torch

import repro.launch.roofline as ref_roofline
from repro.core.sweep import DryRunCellTask as RefTask
from repro.core.sweep import probe_plans as ref_probe_plans
from repro.launch import aggregate as ref_aggregate
from repro.launch import sweep_dryrun as ref_sweep_dryrun
from repro_torch.configs import ARCH_IDS
from repro_torch.core.engine import LocalEngine
from repro_torch.core.server import Server, ServerConfig
from repro_torch.core.sweep import RESULT_TITLES, DryRunCellTask, probe_plans
from repro_torch.launch import aggregate, dryrun, roofline, sweep_dryrun

# one intra-op thread a process: pytest-xdist's workers share the host's
# cores, and each would otherwise start a pool as wide as the host
torch.set_num_threads(1)

CASES = [
    ("smollm-360m", "train_4k", "single", None, None),
    ("smollm-360m", "decode_32k", "single", (2,), {"unroll": 1}),
    ("deepseek-v3-671b", "prefill_32k", "multi", (1, 3),
     {"unroll": 1, "remat": "none"}),
    ("jamba-v0.1-52b", "long_500k", "single", (1,), {"optimizer": "adafactor"}),
    ("mamba2-130m", "decode_32k", "single", None, {"zero1": 0}),
]


@pytest.mark.parametrize("arch,shape,mesh,seg,variant", CASES)
def test_task_matches_the_reference(arch, shape, mesh, seg, variant):
    kw = dict(seg_counts=seg, variant=variant, deadline=123.0, out_dir="o",
              tag="t")
    got, want = (DryRunCellTask(arch, shape, mesh, **kw),
                 RefTask(arch, shape, mesh, **kw))
    for name in ("parameter_titles", "parameters", "result_titles",
                 "group_parameter_titles", "timeout", "_json_name"):
        assert getattr(got, name)() == getattr(want, name)(), name
    assert got.result_titles() == RESULT_TITLES
    hard, ref_hard = got.hardness_parameters(), want.hardness_parameters()
    assert hard[:-1] == ref_hard[:-1] and hard[-1] == 1
    assert got.device == "cuda"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_probe_plans_equal_the_reference(arch):
    assert probe_plans(arch) == ref_probe_plans(arch)


@pytest.mark.parametrize("archs,shapes,meshes,modes", [
    (None, None, ["single"], ["full", "probe"]),
    (["jamba-v0.1-52b", "olmoe-1b-7b"], ["long_500k", "decode_32k"],
     ["single", "multi"], ["full", "probe"]),
    (["deepseek-v3-671b"], None, ["multi"], ["probe"]),
])
def test_build_tasks_yields_the_reference_cells(archs, shapes, meshes, modes):
    got = sweep_dryrun.build_tasks(archs, shapes, meshes, modes, 60.0, "o",
                                   {"remat": "none"}, device="meta")
    want = ref_sweep_dryrun.build_tasks(archs, shapes, meshes, modes, 60.0,
                                        "o", {"remat": "none"})
    assert [t.parameters() for t in got] == [t.parameters() for t in want]
    assert [t._json_name() for t in got] == [t._json_name() for t in want]
    assert {t.device for t in got} <= {"meta"}


def _rows(rows) -> list:
    return json.loads(json.dumps(rows, default=float))


def test_expocloud_drives_real_dryrun_cells(tmp_path, monkeypatch):
    out = str(tmp_path)
    tasks = [
        DryRunCellTask("smollm-360m", "prefill_32k", "single",
                       seg_counts=(2,), variant={"unroll": 1}, deadline=300,
                       out_dir=out, device="meta"),
        DryRunCellTask("mamba2-130m", "decode_32k", "single",
                       seg_counts=(2,), variant={"unroll": 1}, deadline=300,
                       out_dir=out, device="meta"),
    ]
    engine = LocalEngine(n_workers_per_client=1)
    srv = Server(tasks, engine,
                 ServerConfig(max_clients=1, use_backup=False,
                              health_update_limit=300.0,
                              instance_max_non_active_time=300.0))
    table = srv.run(poll_sleep=0.2)
    engine.shutdown()
    assert all(s == "done" for _, _, s in table.rows), table.rows
    for _params, result, _status in table.rows:
        assert result[0] == "ok"
        assert result[1] in ("compute", "memory", "collective")
        assert os.path.exists(result[-1])
        rec = json.loads(open(result[-1]).read())
        assert rec["chips"] == 1 and rec["mesh"] == "meta"
        assert rec["roofline"]["collective_bytes_per_chip"] == 0.0
    # the second probes, in this process, beside the sweep's records
    for arch, shape in (("smollm-360m", "prefill_32k"),
                        ("mamba2-130m", "decode_32k")):
        task = DryRunCellTask(arch, shape, "single", (3,), {"unroll": 1},
                              out_dir=out, device="meta")
        rec = dryrun.run_cell(arch, shape, variant={"unroll": 1},
                              seg_counts=[3], device="meta", verbose=False)
        with open(os.path.join(out, task._json_name()), "w") as f:
            json.dump(rec, f)
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(ref_roofline, name, getattr(roofline, name))
    got = aggregate.assemble(out)
    assert _rows(got) == _rows(ref_aggregate.assemble(out))
    done = {(r["arch"], r["shape"]): r for r in got
            if r.get("status_roofline") == "extrapolated"}
    assert sorted(done) == [("mamba2-130m", "decode_32k"),
                            ("smollm-360m", "prefill_32k")]
    for row in done.values():
        assert row["dominant"] in ("compute", "memory", "collective")
        assert row["useful_ratio"] > 0


def test_a_multi_pod_cell_fails_naming_a9(tmp_path):
    task = DryRunCellTask("smollm-360m", "decode_32k", "multi", (2,),
                          deadline=120, out_dir=str(tmp_path), device="meta")
    with pytest.raises(RuntimeError, match="Queue A item 9"):
        task.run()
