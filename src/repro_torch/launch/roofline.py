"""Roofline terms of a dry-run cell on NVIDIA H100s.

    compute term    = HLO_FLOPs / (chips x peak_FLOP/s)
    memory term     = HLO_bytes / (chips x HBM_bw)
    collective term = collective_bytes / (chips x link_bw)

The port compiles no HLO: "hlo" in a record's keys (``hlo_flops``,
``hlo_bytes``) names the dry-run's count of the traced step, kept under
the reference's keys so that ``aggregate.py`` stays a copy.  FLOPs are
``torch.utils.flop_counter.FlopCounterMode``'s count of the step's
products plus the hand-written kernels' own work, and bytes each aten
op's inputs and outputs, unfused, plus the kernels' bytes (see
``launch/dryrun.py``).  Collective bytes are the dry-run's count of the
traced rank's collectives (``c10d`` ops under a fake process group), by
kind, each weighted by the reference's ring factor (an all-reduce moves
about twice its payload; an all-gather counts its gathered output, a
reduce-scatter its scattered piece), as ``repro/launch/roofline.py``
weighs the collectives it parses from the partitioned HLO; one card
counts none.

Hardware model: one NVIDIA H100 SXM a chip (``kernels/work.py``, the home
of the constants the kernel table's bounds and the tuner use too): 989
TFLOP/s bf16 dense, 3.35 TB/s HBM, NVLink 450 GB/s a direction for every
collective.  A group wider than one 8-card node would cross the NIC,
which this model leaves out, as the reference models one ICI link
whatever the group.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass

from repro_torch.kernels.work import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

PEAK_FLOPS = PEAK_FLOPS_BF16     # bf16 / chip
ICI_BW = NVLINK_BW               # bytes/s / link, the reference's name

# traffic factor per kind (ring algorithms, bytes on the wire per chip
# relative to the buffer counted), the reference's
FACTOR = {
    "all-gather": 1.0,        # the gathered output
    "all-reduce": 2.0,        # reduce-scatter + all-gather
    "reduce-scatter": 1.0,    # the scattered piece
    "all-to-all": 1.0,
    "collective-permute": 1.0,
    "broadcast": 1.0,
}


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
            bytes_per_device=0.0, note="", collectives=None) -> Roofline:
    """cost: the dry-run's count, ``{"flops", "bytes accessed"}`` for one
    rank (scaled to all chips, as the reference scales
    ``cost_analysis()``); ``collectives``: that rank's ``{kind: {"bytes":
    payload, "calls": n}}`` (``launch/dryrun.py``'s ``Traffic``), weighted
    by ``FACTOR``; ``hlo_text`` has no HLO to parse here and is taken for
    the reference's signature only."""
    del hlo_text
    flops = float(cost.get("flops", 0.0))
    acc_bytes = float(cost.get("bytes accessed", 0.0))
    weighted = {k: float(c["bytes"]) * FACTOR[k]
                for k, c in (collectives or {}).items()}
    r = Roofline(
        arch=arch, shape=shape, mesh=mesh_desc, chips=chips,
        hlo_flops=flops * chips,
        hlo_bytes=acc_bytes * chips,
        collective_bytes_per_chip=sum(weighted.values()),
        collectives=weighted,
        collective_counts={k: int(c["calls"])
                           for k, c in (collectives or {}).items()},
        model_flops=model_flops,
        bytes_per_device=bytes_per_device,
        note=note,
    )
    return r.finalize()
