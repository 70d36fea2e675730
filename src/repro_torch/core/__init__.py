"""Serving core: batching policy and schedulers, the DPU, metrics."""
