"""Hand-written CUDA kernels for Hopper (``sm_90a``) replacing the JAX
package's Pallas kernels, plus the dispatch layer that routes the hot path
through them.

Each kernel package holds ``ops.py`` (the wrapper: checks, launch on the
current stream, a plain integer ``launches`` counter) and ``ref.py`` (the
plain PyTorch version).  On a CPU tensor a wrapper runs the plain version;
on a CUDA tensor it launches the kernel or raises.  The CUDA sources live in
``csrc/`` and are built by ``build.py`` into one shared library at first use.

The kernels: ``kl_mutual`` and ``ridge_gram`` (the SplitMe path, through
``dispatch``), ``rwkv6_wkv`` and ``mamba2_scan`` (the zoo models' prefill,
through ``dispatch``), and ``flash_attention`` (causal GQA attention, an op of
its own: no model calls it, as no JAX model calls the JAX package's).
"""
