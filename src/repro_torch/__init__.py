"""PREBA's serving system in PyTorch for NVIDIA Hopper: the DPU audio
front-end as hand-written CUDA kernels, a continuous-batching engine and the
stage-pipelined runtime. The JAX package `repro` is its reference; this
package imports nothing from it."""
