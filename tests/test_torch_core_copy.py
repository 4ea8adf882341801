"""``repro_torch.core`` is a copy of the ExpoCloud core ``repro.core``
(everything but ``sweep.py``, the dry-run bridge): each module equals its
twin once ``repro.`` is rewritten to ``repro_torch.``, and one task list
run through both packages' ``Experiment(engine="sim")`` gives the same
results table.
"""
from __future__ import annotations

from pathlib import Path

import pytest
import torch

import repro.core.experiment as ref_experiment
import repro.core.scheduler as ref_scheduler
import repro.core.space as ref_space
import repro_torch.core.experiment as port_experiment
import repro_torch.core.scheduler as port_scheduler
import repro_torch.core.space as port_space
from repro_torch.tune import space as tspace

# one intra-op thread a process: pytest-xdist's workers share the host's
# cores, and each would otherwise start a pool as wide as the host
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro" / "core"
PORT = ROOT / "src" / "repro_torch" / "core"


def test_the_copy_holds_every_module_but_sweep():
    assert sorted(p.name for p in PORT.glob("*.py")) == sorted(
        p.name for p in REF.glob("*.py") if p.name != "sweep.py")
    assert len(list(PORT.glob("*.py"))) == 18


@pytest.mark.parametrize("name", sorted(p.name for p in REF.glob("*.py")
                                        if p.name != "sweep.py"))
def test_module_equals_its_twin_after_the_rewrite(name):
    want = (REF / name).read_text().replace("repro.", "repro_torch.")
    assert (PORT / name).read_text() == want


def _predicted(b, s, h, p, g, n, dtype, chunk):
    """A deterministic stand-in for the measurement: the predicted cost."""
    return (tspace.predicted_cost_us(
        "ssd_scan", dict(b=b, s=s, h=h, p=p, g=g, n=n, dtype=dtype,
                         chunk=chunk)),)


def _run(pkg_space, pkg_experiment, cells, timeout):
    """The SSD smoke grid's cells as tasks of one package, run through its
    ``Experiment`` on the simulator: (rows, statuses, costs)."""
    factory = pkg_space.task(_predicted, result_titles=("predicted_us",))
    tasks = [pkg_space.FunctionTask(
        factory=factory, cell=cell,
        hardness_values=tspace.hardness_of("ssd_scan", cell),
        timeout=timeout, sim_duration=tspace.sim_duration_s("ssd_scan", cell))
        for cell in cells]
    tasks.sort(key=lambda t: t.hardness_parameters())
    exp = pkg_experiment.Experiment(tasks, engine="sim", max_clients=2,
                                    budget_cap=150.0)
    with exp.run() as run:
        table = run.results()
    return (table.parameter_titles, [tuple(r) for r in table.rows],
            table.row_costs, table.cost)


def test_one_task_list_gives_one_table_in_both_packages():
    spec = tspace.SPECS["ssd_scan"]
    cells = tspace.build_space("ssd_scan", smoke=True, adversarial=4,
                               seed=0).cells()
    default = {**spec.smoke_shape, "dtype": "float32",
               **spec.default_config(spec.smoke_shape)}
    timeout = 4.0 * tspace.sim_duration_s("ssd_scan", default)
    port = _run(port_space, port_experiment, cells, timeout)
    ref = _run(ref_space, ref_experiment, cells, timeout)
    assert port == ref
    statuses = [status for _, _, status in port[1]]
    assert port_scheduler.DONE == ref_scheduler.DONE
    assert statuses.count(port_scheduler.DONE) == 4
    assert statuses.count(port_scheduler.TIMED_OUT) >= 1
    assert statuses.count(port_scheduler.PRUNED) >= 1     # the domino rule
    assert set(statuses) == {port_scheduler.DONE, port_scheduler.TIMED_OUT,
                             port_scheduler.PRUNED}
