"""Host-side data: audio and image preprocessing (numpy) and the synthetic
training batches."""
