"""Tensor primitives shared by the port's modules (no kernels here)."""
