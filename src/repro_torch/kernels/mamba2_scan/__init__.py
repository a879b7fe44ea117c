"""Mamba2 SSD scan: CUDA kernel wrapper (``ops``) and plain version (``ref``)."""
