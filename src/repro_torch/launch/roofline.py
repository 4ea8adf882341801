"""Roofline terms of a dry-run cell on one NVIDIA H100.

    compute term    = HLO_FLOPs / (chips x peak_FLOP/s)
    memory term     = HLO_bytes / (chips x HBM_bw)
    collective term = collective_bytes / (chips x link_bw)

The port compiles no HLO: "hlo" in a record's keys (``hlo_flops``,
``hlo_bytes``) names the dry-run's count of the traced step, kept under
the reference's keys so that ``aggregate.py`` stays a copy.  FLOPs are
``torch.utils.flop_counter.FlopCounterMode``'s count of the step's
products plus the hand-written kernels' own work, and bytes each aten
op's inputs and outputs, unfused, plus the kernels' bytes (see
``launch/dryrun.py``).  Collective bytes are the dry-run's own count,
which is zero on one card: the port's cells run unsharded.

Hardware model: one NVIDIA H100 SXM (``kernels/work.py``, the home of the
constants the kernel table's bounds and the tuner use too): 989 TFLOP/s
bf16 dense, 3.35 TB/s HBM, NVLink 450 GB/s a direction.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass

from repro_torch.kernels.work import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

PEAK_FLOPS = PEAK_FLOPS_BF16     # bf16 / chip
ICI_BW = NVLINK_BW               # bytes/s / link, the reference's name


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float             # whole-step, all chips
    hlo_bytes: float
    collective_bytes_per_chip: float
    collectives: dict
    collective_counts: dict
    model_flops: float
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    useful_ratio: float = 0.0
    roofline_fraction: float = 0.0
    bytes_per_device: float = 0.0
    note: str = ""

    def finalize(self):
        self.compute_s = self.hlo_flops / (self.chips * PEAK_FLOPS)
        self.memory_s = self.hlo_bytes / (self.chips * HBM_BW)
        self.collective_s = self.collective_bytes_per_chip / ICI_BW
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.dominant = max(terms, key=terms.get)
        self.useful_ratio = (self.model_flops / self.hlo_flops
                             if self.hlo_flops else 0.0)
        bound = max(self.compute_s, self.memory_s, self.collective_s)
        ideal = self.model_flops / (self.chips * PEAK_FLOPS)
        self.roofline_fraction = ideal / bound if bound > 0 else 0.0
        return self

    def to_json(self) -> str:
        return json.dumps(asdict(self), default=float)


def analyze(*, arch, shape, mesh_desc, chips, cost, hlo_text, model_flops,
            bytes_per_device=0.0, note="") -> Roofline:
    """cost: the dry-run's count, ``{"flops", "bytes accessed",
    "collective bytes"}`` for one card (scaled to all chips, as the
    reference scales ``cost_analysis()``); ``hlo_text`` has no HLO to
    parse here and is taken for the reference's signature only."""
    del hlo_text
    flops = float(cost.get("flops", 0.0))
    acc_bytes = float(cost.get("bytes accessed", 0.0))
    coll = float(cost.get("collective bytes", 0.0))
    r = Roofline(
        arch=arch, shape=shape, mesh=mesh_desc, chips=chips,
        hlo_flops=flops * chips,
        hlo_bytes=acc_bytes * chips,
        collective_bytes_per_chip=coll,
        collectives={},
        collective_counts={},
        model_flops=model_flops,
        bytes_per_device=bytes_per_device,
        note=note,
    )
    return r.finalize()
