"""MIG pod slicing: the slice accounting of the fleet (serving/multislice.py).

NVIDIA MIG partitions one GPU into instances at GPC granularity from a fixed
menu of profiles. On an H100 80GB (NVIDIA's MIG user guide) the profiles
are 1g.10gb (7x), 2g.20gb (3x), 3g.40gb (2x), 4g.40gb (1x) and 7g.80gb
(1x); like 2g.20gb (3x), which leaves one of the seven compute slices
unused, a partitioning may strand capacity, and stranded units are
reported, not hidden (`menu_for_pod`).

The fleet itself partitions a list of devices into disjoint slices, each
hosting an independent serving replica (`partition_pod`). A process sees
one CUDA device per GPU (or per MIG instance), so on one card N slices are
N logical replicas sharing that device; each `PodSlice` carries the
`torch.device` it serves on and its own CUDA stream. `PlacementAsk`,
`plan_placement` and `rebalance_slices` are the device-agnostic tenant
accounting: which tenant gets how many slices, and what is stranded.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class SliceSpec:
    name: str               # e.g. "2g.20gb(3x)" or "1gpu(4x)"
    chips_per_slice: int    # devices a slice spans (menu: compute slices)
    n_slices: int

    def stranded(self, pod_chips: int) -> int:
        """Units this partitioning leaves unused on a `pod_chips` pod (MIG:
        2g.20gb(3x) strands one compute slice of an H100's seven)."""
        return pod_chips - self.n_slices * self.chips_per_slice


def slice_name(chips_per_slice: int, n_slices: int) -> str:
    """Canonical name of a device partitioning, shared by `partition_pod`
    and the fleet so the same partitioning is never labelled two ways."""
    return f"{max(1, chips_per_slice)}gpu({n_slices}x)"


# H100 80GB MIG profiles: (profile, compute slices of 7, instances per GPU)
H100_MIG_PROFILES: Tuple[Tuple[str, int, int], ...] = (
    ("1g.10gb", 1, 7),
    ("2g.20gb", 2, 3),
    ("3g.40gb", 3, 2),
    ("4g.40gb", 4, 1),
    ("7g.80gb", 7, 1),
)
H100_COMPUTE_SLICES = 7


def menu_for_pod(pod_gpus: int = 1) -> List[SliceSpec]:
    """The uniform MIG partitionings of `pod_gpus` H100 80GB cards, one
    profile on every card; chips_per_slice counts compute slices, so
    `spec.stranded(7 * pod_gpus)` is the capacity the profile leaves idle."""
    return [SliceSpec(f"{name}({n * pod_gpus}x)", g, n * pod_gpus)
            for name, g, n in H100_MIG_PROFILES]


@dataclass
class PodSlice:
    slice_id: int
    devices: np.ndarray       # flat device array for this slice
    healthy: bool = True
    stream: Optional[torch.cuda.Stream] = None  # the slice's CUDA stream

    @property
    def device(self) -> torch.device:
        """The device the slice's engine serves on (its first device)."""
        return torch.device(self.devices.reshape(-1)[0])


@dataclass
class SlicedPod:
    spec: SliceSpec
    slices: List[PodSlice]
    stranded_chips: int = 0

    def healthy_slices(self) -> List[PodSlice]:
        return [s for s in self.slices if s.healthy]

    def fail(self, slice_id: int) -> None:
        self.slices[slice_id].healthy = False

    def recover(self, slice_id: int) -> None:
        self.slices[slice_id].healthy = True


def partition_pod(devices: Sequence, chips_per_slice: int) -> SlicedPod:
    """Partition a flat device list into disjoint slices (elastic: call again
    with a different granularity to re-slice, the MIG reconfiguration)."""
    arr = np.asarray(devices, dtype=object).reshape(-1)
    n = arr.size
    cps = min(chips_per_slice, n)
    n_slices = n // cps
    stranded = n - n_slices * cps
    slices = [
        PodSlice(i, arr[i * cps : (i + 1) * cps]) for i in range(n_slices)
    ]
    spec = SliceSpec(slice_name(cps, n_slices), cps, n_slices)
    return SlicedPod(spec=spec, slices=slices, stranded_chips=stranded)


# ---------------------------------------------------------------------------
# Multi-tenant placement: right-sized, fragmentation-aware
# ---------------------------------------------------------------------------
#
# MIGPerf (arxiv 2301.00407): MIG wins when slices are right-sized PER
# MODEL — a tenant asks for a slice size (chips_per_slice) or a replica
# count (n_slices). ParvaGPU (arxiv 2409.14447): what makes multi-tenant
# GPU sharing viable at scale is fragmentation-aware placement — pack the
# biggest slice asks first (best-fit decreasing over one contiguous pool)
# and account for every stranded unit instead of hiding it.


@dataclass(frozen=True)
class PlacementAsk:
    """One tenant's slice ask: `n_slices` replicas of `chips_per_slice`
    units each (chips_per_slice=0 = "whatever the pod's uniform slice size
    is" — the replicated case where slices are logical)."""

    tenant: str
    n_slices: int = 1
    chips_per_slice: int = 0


@dataclass
class Placement:
    """Result of a placement pass: per-tenant contiguous runs (one
    (start, chips) span per slice, in slice order), plus the fragmentation
    accounting the pass optimized for."""

    assignments: Dict[str, List[Tuple[int, int]]]
    stranded_chips: int
    pod_chips: int

    @property
    def fragmentation(self) -> float:
        """Stranded fraction of the pod — the ParvaGPU packing objective;
        0.0 is a perfect pack."""
        return self.stranded_chips / self.pod_chips if self.pod_chips else 0.0

    def slice_counts(self) -> Dict[str, int]:
        return {t: len(spans) for t, spans in self.assignments.items()}


def plan_placement(pod_chips: int,
                   asks: Sequence[PlacementAsk]) -> Placement:
    """Fragmentation-aware placement of tenant slice asks onto one pod.

    Best-fit decreasing: tenants with the LARGEST chips_per_slice place
    first, each taking contiguous runs from a single free pool. Ask order
    breaks ties deterministically. Raises when the asks cannot all fit —
    the caller must shrink an ask rather than silently over-subscribe the
    pod. Units no ask covers are stranded and REPORTED."""
    order = sorted(
        range(len(asks)),
        key=lambda i: (-max(1, asks[i].chips_per_slice), i),
    )
    total_ask = sum(max(1, a.chips_per_slice) * max(0, a.n_slices)
                    for a in asks)
    if total_ask > pod_chips:
        raise ValueError(
            f"placement asks need {total_ask} chips; pod has {pod_chips}"
        )
    assignments: Dict[str, List[Tuple[int, int]]] = {
        a.tenant: [] for a in asks
    }
    cursor = 0
    for i in order:
        a = asks[i]
        cps = max(1, a.chips_per_slice)
        for _ in range(max(0, a.n_slices)):
            assignments[a.tenant].append((cursor, cps))
            cursor += cps
    return Placement(assignments=assignments,
                     stranded_chips=pod_chips - cursor,
                     pod_chips=pod_chips)


def rebalance_slices(n_slices: int, asks: Dict[str, int]) -> Dict[str, int]:
    """Re-balance `n_slices` uniform slices between tenants proportionally
    to their original asks (largest-remainder apportionment), every tenant
    keeping at least one slice — the elastic-resize path. Deterministic:
    ties break by larger ask, then tenant-name order."""
    names = sorted(asks, key=lambda t: (-asks[t], t))
    if not names:
        return {}
    if n_slices < len(names):
        raise ValueError(
            f"cannot place {len(names)} tenants on {n_slices} slices"
        )
    total = sum(max(1, asks[t]) for t in names)
    quotas = {t: max(1, asks[t]) * n_slices / total for t in names}
    counts = {t: max(1, int(quotas[t])) for t in names}
    # largest remainder fills what the floors (and the >=1 floor) left
    while sum(counts.values()) < n_slices:
        t = sorted(names,
                   key=lambda x: (-(quotas[x] - counts[x]), -asks[x], x))[0]
        counts[t] += 1
    # the >=1 floor can over-fill on tiny pods: shave the largest holders
    while sum(counts.values()) > n_slices:
        t = sorted((x for x in names if counts[x] > 1),
                   key=lambda x: (-(counts[x] - quotas[x]), -counts[x], x))[0]
        counts[t] -= 1
    return counts
