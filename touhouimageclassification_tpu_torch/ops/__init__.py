"""Compute ops: slab attention (CUDA kernel + plain version), GELU,
resize/normalize, and the kernel build."""
