"""Spatial structures and force kernels of the particle engines."""
