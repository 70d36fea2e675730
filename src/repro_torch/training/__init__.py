"""Training: AdamW with global-norm clipping, int8 error-feedback gradient
compression, atomic checkpoints, and the train loop."""
