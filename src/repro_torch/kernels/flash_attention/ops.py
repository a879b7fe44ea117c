"""Wrapper of the CUDA flash-attention kernels (``csrc/flash_attention_mma.cu``
and ``csrc/flash_attention_tf32.cu``).

Replaces ``repro/kernels/flash_attention/flash_attention.py``
(``_flash_kernel`` / ``flash_attention_pallas``) and its wrapper
``repro/kernels/flash_attention/ops.py`` (``flash_attention``).  The TPU
kernel visits every (query block, KV block) pair of a (B, H, nq, nk) grid
with the online-softmax state in VMEM scratch; here one block per (query
tile of 64 rows, head, batch) loops over only the KV tiles that hold a
visible key, and any S is taken without padding.  Bound on an H100 SXM at
Zamba2-2.7B's shared attention (B 4, H = KV = 32, S 2048, D 80): 8.6e10
operations over the visible (query, key) pairs, 0.087 ms at the bf16
tensor-core rate and 0.52 ms at the f32-accurate 3xTF32 rate (495 / 3
TFLOP/s), against 168 MB of bf16 bytes (0.050 ms).

A CUDA call takes one of two tensor-core kernels, by its dtype alone
(``_route``), for every head size D in [1, 128] and every element-aligned
pointer:

* ``"mma"``: bfloat16.  ``mma.sync`` bf16 with f32 accumulation, K/V
  through a ring of asynchronous copies, P split into two bf16 halves so
  that P·V keeps ~16 bits of p.
* ``"tf32x3"``: float32.  3xTF32 (each f32 operand split into TF32 high and
  low parts, three ``mma.sync`` m16n8k8 products), each 8-key step of P·V
  summed from zero and added to O with rounded FP32 adds, so that O does
  not drift with the number of keys (the tensor core truncates its sums).

Both pad D up to a multiple of 16 with zeros.  Their copies of Q, K and V
are W bytes wide, a template parameter of the kernel that ``_route``
returns with it: 16 where q, k, v and a row of D elements are 16-byte
aligned and o takes pair stores (every model width, 32, 64, 80, 128, on
fresh tensors), else 4 where k, v and the row allow (Q in bfloat16 then in
pairs or, at an odd offset, single elements), else (bfloat16 with an odd D
or an odd element offset of k or v) 2-byte loads through registers.

It has no backward, as the JAX package's has none.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention

# kernel launches since the last reset (plain counters; callers set them to
# 0): all of them, and those of each route
launches = 0
launches_mma = 0
launches_tf32x3 = 0

MAX_D = 128          # the head size the kernel's register tiles allow

_DTYPES = (torch.float32, torch.bfloat16)
# the C entries of the two routes, one signature: q, k, v, o, B, H, KV, S,
# D, scale, window, the copy width, stream
_ENTRIES = {"mma": "flash_attention_mma_fwd",
            "tf32x3": "flash_attention_tf32_fwd"}
_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5
             + (ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p))


def _route(dtype: torch.dtype, D: int, ptrs) -> tuple:
    """(kernel, copy width in bytes) of a CUDA call with ``ptrs`` (q, k,
    v, o): ``"mma"`` for bfloat16, ``"tf32x3"`` for float32.  16-byte
    copies need q, k, v and a row of D elements 16-byte aligned and o
    aligned for pair stores; else 4-byte copies (cp.async), where k, v and
    the row allow, else 2 (bfloat16 through registers)."""
    route = "mma" if dtype == torch.bfloat16 else "tf32x3"
    q, k, v, o = ptrs
    row = D * dtype.itemsize
    if (q | k | v | row) % 16 == 0 and o % (2 * dtype.itemsize) == 0:
        return route, 16
    return route, 4 if (k | v | row) % 4 == 0 else 2


def _check(q, k, v, causal, window) -> None:
    if not causal:
        raise ValueError("flash_attention is causal only (as the JAX "
                         "package's kernel is)")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention needs q (B, H, S, D) and k, v "
                         f"(B, KV, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, D = q.shape
    KV = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, S, D):
        raise ValueError(f"flash_attention needs k, v of shape (B, KV, S, D)"
                         f" = ({B}, KV, {S}, {D}), got {tuple(k.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention needs H a multiple of KV, got H "
                         f"{H}, KV {KV}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16, all "
                        f"three alike, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention needs all inputs on one device")
    if not all(a.is_contiguous() for a in (q, k, v)):
        raise ValueError("flash_attention needs contiguous inputs")
    if not 1 <= D <= MAX_D:
        raise ValueError(f"flash_attention takes a head size D in "
                         f"[1, {MAX_D}], got {D}")
    if q.numel() >= 2 ** 31 or B >= 2 ** 16 or H >= 2 ** 16:
        raise ValueError(f"flash_attention cannot take shape "
                         f"{tuple(q.shape)}")
    if window is not None and (isinstance(window, bool)
                               or int(window) != window or window < 1):
        raise ValueError(f"flash_attention takes a window of at least 1 key "
                         f"or None, got {window!r}")
    if torch.is_grad_enabled() and any(a.requires_grad for a in (q, k, v)):
        raise RuntimeError("flash_attention has no backward (nor has the "
                           "JAX package's kernel); call it under "
                           "torch.no_grad()")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, S, D); k, v: (B, KV, S, D), float32 or bfloat16 alike ->
    (B, H, S, D) in q.dtype.  Causal GQA attention: query head h reads KV
    head h // (H / KV), and key j is visible to query i iff
    i - window < j <= i.  ``scale`` defaults to 1/sqrt(D).  The JAX op's
    ``bq``/``bk`` are TPU tile sizes and have no counterpart here.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    that ``_route`` picks, on the current stream."""
    global launches, launches_mma, launches_tf32x3
    _check(q, k, v, causal, window)
    B, H, S, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return attention(q, k, v, scale=scale, causal=True, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    # a window of S keys or more masks nothing; 0 tells the kernel "none"
    win = 0 if window is None or window >= S else int(window)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    route, width = _route(q.dtype, D, ptrs)
    with torch.cuda.device(q.device):
        err = build.function(_ENTRIES[route], _ARGTYPES)(
            *ptrs, B, H, k.shape[1], S, D, float(scale), win, width,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, f"flash_attention ({route})")
    launches += 1
    if route == "mma":
        launches_mma += 1
    else:
        launches_tf32x3 += 1
    return o
