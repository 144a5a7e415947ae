"""Roofline terms of a cell's step on one NVIDIA H100.

A copy of ``repro.launch.roofline`` at the card's rates, per rank (one
rank a card):

  compute    = flops_chip / 989e12      (dense bf16 peak)
  memory     = bytes_chip / 3.35e12     (HBM bandwidth)
  collective = coll_bytes_chip / 450e9  (NVLink, one direction)

The reference parses its collective bytes out of a compiled step's HLO
text; the port has no HLO. Its :func:`collective_bytes` takes the bytes
per op that ``repro_torch.core.distributed.ShardComm.bytes_by_op``
records (or ``lpa_collective_bytes`` counts) in the reference's
convention: the bytes of each op's result on a rank, an all-reduce
counted twice (ring: reduce-scatter + all-gather volume), and their
``"total"``. A step here is Python that runs once per call, so there is
no loop-resident collective to scale.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

__all__ = ["PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "RooflineTerms",
           "roofline", "collective_bytes"]

#: H100 SXM5 dense bf16 tensor-core peak, FLOP/s (NVIDIA H100 data sheet;
#: the counterpart of the reference's bf16 peak per chip)
PEAK_FLOPS = 989e12
#: H100 SXM5 HBM3 bandwidth, bytes/s (NVIDIA H100 data sheet)
HBM_BW = 3.35e12
#: NVLink 4 bandwidth per GPU in one direction, bytes/s (900 GB/s both
#: ways, NVIDIA H100 data sheet); it stands in for the reference's ICI_BW
#: (TPU inter-chip link)
NVLINK_BW = 450e9


def collective_bytes(bytes_by_op: Mapping[str, float]) -> Dict[str, float]:
    """``{op: bytes, ..., "total": sum}`` of per-rank collective bytes by
    op (a ``"total"`` already in the mapping is recomputed)."""
    out = {op: float(b) for op, b in bytes_by_op.items() if op != "total"}
    out["total"] = sum(out.values())
    return out


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def bottleneck(self) -> str:
        vals = {"compute": self.compute_s, "memory": self.memory_s,
                "collective": self.collective_s}
        return max(vals, key=vals.get)

    @property
    def step_time_s(self) -> float:
        """Lower-bound step time: max of the three (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self):
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s,
                "bottleneck": self.bottleneck,
                "step_time_lb_s": self.step_time_s}


def roofline(flops_chip: float, bytes_chip: float, coll_bytes_chip: float
             ) -> RooflineTerms:
    return RooflineTerms(
        compute_s=flops_chip / PEAK_FLOPS,
        memory_s=bytes_chip / HBM_BW,
        collective_s=coll_bytes_chip / NVLINK_BW,
    )
