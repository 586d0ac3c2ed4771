"""Metrics and the CUDA kernel build loader."""
