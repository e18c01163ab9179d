"""Kernel wrappers: each CUDA kernel beside its plain PyTorch version."""
