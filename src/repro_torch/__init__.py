"""PyTorch + CUDA port of the SplitMe O-RAN split-federated-learning system.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``configs/``, ``data/``, ``core/``, ``kernels/<name>/``) so each module sits
beside its counterpart.  It imports ``torch`` and numpy only, never ``jax``
and nothing of ``repro``.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; every Pallas kernel on the ported path is a
hand-written CUDA kernel under ``kernels/csrc/``.
"""
