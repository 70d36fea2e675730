"""Slice accounting of the multi-slice fleet: partitions, the H100 MIG
menu, and tenant placement (see mig.py)."""
from repro_torch.core.slicing.mig import (  # noqa: F401
    H100_MIG_PROFILES,
    Placement,
    PlacementAsk,
    PodSlice,
    SliceSpec,
    SlicedPod,
    menu_for_pod,
    partition_pod,
    plan_placement,
    rebalance_slices,
    slice_name,
)
