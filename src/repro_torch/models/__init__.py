"""The served model families (dense, SSM): layers, the LM functions, weights."""
