"""DPU preprocessing: the CU pipeline model, the CU pool and its service."""
