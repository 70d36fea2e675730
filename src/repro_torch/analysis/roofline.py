"""Roofline model of one step on NVIDIA H100 80GB HBM3 (SXM5, 700 W) cards,
from the dry run's per-rank op counts (`op_trace.StepCost`).

compute term    = dot FLOPs a rank / PEAK_FLOPS
memory term     = dot bytes a rank / HBM_BW
collective term = sum over collectives of wire bytes / the rate of its link

The peaks are NVIDIA's data-sheet values for the SXM5 part at its 700 W
power limit (dense, no sparsity), not measurements: a card set below 700 W
runs slower. A collective whose group lies within 8 consecutive ranks (one
node of 8 cards) runs over NVLink 4, 450 GB/s each way a card; any other
over the network, 400 Gb/s NDR InfiniBand, 50 GB/s a card. On the 16 x 16
production mesh of 8-card nodes, then, the `model` axis (16 consecutive
ranks) spans two nodes, and `data` and `pod` cross nodes: every collective
of a production cell takes the network.

The wire bytes are what the port sends: each collective an all-reduce of
the buffer it reduces (`distributed/ctx.py`), 2 P (n - 1) / n a mesh
axis. `logical_wire_bytes_per_chip` beside them is what the collectives
they implement would send by the JAX package's ring formulas, so the cost
of the all-reduce-only design shows; `t_collective_logical` times it.

The JAX package's `parse_collectives`, which reads HLO text, has no
counterpart here: `op_trace` records each collective where the port calls
it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

# NVIDIA H100 80GB HBM3 (SXM5, 700 W) data-sheet peaks
PEAK_FLOPS = 989e12        # dense bf16 tensor-core FLOP/s
FP32_FLOPS = 67e12         # fp32 FLOP/s on the CUDA cores
HBM_BW = 3.35e12           # HBM3 bytes/s
NVLINK_BW = 450e9          # NVLink 4 bytes/s each way a card, within a node of 8
NETWORK_BW = 50e9          # 400 Gb/s NDR InfiniBand bytes/s a card, between nodes
LINK_BW = {"nvlink": NVLINK_BW, "network": NETWORK_BW}


def _t_links(by_link: Dict[str, float]) -> float:
    return sum(b / LINK_BW[link] for link, b in by_link.items())


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float               # dot FLOPs over all ranks (the JAX record's name)
    hlo_bytes: float               # dot bytes over all ranks
    wire_bytes_per_chip: float     # what a rank sends (all-reduces)
    model_flops: float
    collectives: Dict[str, int]
    peak_memory_per_device: float = 0.0
    wire_by_link: Dict[str, float] = field(default_factory=dict)
    logical_wire_bytes_per_chip: float = 0.0
    logical_wire_by_link: Dict[str, float] = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return _t_links(self.wire_by_link)

    @property
    def t_collective_logical(self) -> float:
        return _t_links(self.logical_wire_by_link)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Model FLOPs at peak over the bound step time (dominant term)."""
        if self.t_bound == 0:
            return 0.0
        return (self.model_flops / (self.chips * PEAK_FLOPS)) / self.t_bound

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "wire_bytes_per_chip": self.wire_bytes_per_chip,
            "model_flops": self.model_flops,
            "collectives": self.collectives,
            "peak_memory_per_device": self.peak_memory_per_device,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "t_bound": self.t_bound,
            "wire_by_link": self.wire_by_link,
            "logical_wire_bytes_per_chip": self.logical_wire_bytes_per_chip,
            "logical_wire_by_link": self.logical_wire_by_link,
            "t_collective_logical": self.t_collective_logical,
        }


def model_flops_for(cfg, shape) -> float:
    """6 N D (train) / 2 N D (a serve forward), N the active parameters (an
    MoE's experts at top_k / n_experts), D the tokens of the step."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # one token a sequence


def build_report(cfg, shape, mesh_name: str, chips: int, cost) -> RooflineReport:
    """The report of a cell from one rank's `op_trace.StepCost`. The counts
    are a rank's, so the compute and memory terms divide the totals over
    `chips` ranks by `chips`: a rank's own counts over the peaks."""
    return RooflineReport(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_flops=cost.dot_flops * chips, hlo_bytes=cost.dot_bytes * chips,
        wire_bytes_per_chip=cost.wire_bytes, model_flops=model_flops_for(cfg, shape),
        collectives={k: int(v) for k, v in cost.collective_counts.items()},
        peak_memory_per_device=cost.bytes_per_device,
        wire_by_link=dict(cost.wire_by_link),
        logical_wire_bytes_per_chip=cost.logical_wire_bytes,
        logical_wire_by_link=dict(cost.logical_wire_by_link))
