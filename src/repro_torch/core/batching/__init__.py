from repro_torch.core.batching.knee import (  # noqa: F401
    KneeProfile,
    analytical_decode_latency,
    analytical_knee,
    find_knee,
    kv_bytes_per_token,
    profile_knee,
)
from repro_torch.core.batching.policy import (  # noqa: F401
    BatchPolicy,
    derive_policy,
    pick_chunk_len,
    pick_segment_len,
)
from repro_torch.core.batching.buckets import BucketedBatcher, Bucket  # noqa: F401
from repro_torch.core.batching.scheduler import (  # noqa: F401
    BatchSliceScheduler,
    SliceScheduler,
    SlotPlan,
    SlotScheduler,
)
