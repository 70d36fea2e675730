"""Audio preprocessing on the host (numpy)."""
