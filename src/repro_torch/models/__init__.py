"""The dense decoder family: layers, the LM functions, weights."""
