"""Radix prefix KV cache: cross-request reuse of shared-prefix prefill
over the serving slot pool (see store.py for invariants)."""
from repro_torch.core.prefix.store import (PrefixLease, PrefixStore,
                                           tree_concat_positions,
                                           tree_pad_positions)

__all__ = ["PrefixLease", "PrefixStore", "tree_concat_positions",
           "tree_pad_positions"]
