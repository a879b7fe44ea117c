"""RWKV6 WKV recurrence: CUDA kernel wrapper (``ops``) and plain version (``ref``)."""
