"""Causal GQA flash attention: CUDA kernel wrapper (``ops``) and plain version (``ref``)."""
