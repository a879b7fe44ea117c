"""Wrapper of the CUDA RWKV6 WKV kernel (``csrc/rwkv6_wkv.cu``).

Replaces ``repro/kernels/rwkv6_wkv/rwkv6_wkv.py`` (``_wkv_kernel`` /
``rwkv6_wkv_pallas``) and its wrapper ``repro/kernels/rwkv6_wkv/ops.py``
(``rwkv6_wkv``).  The TPU kernel walks the sequence in a sequential grid
axis of Q-step chunks with the (P, P) state in VMEM; here one block per
(batch, head) walks the whole sequence in the recurrence's own order, the
state spread over the block in 4 x 4 tiles (256 threads at P ≤ 64), the
r, k, v, w tiles double-buffered by cp.async, and any L is taken without
padding.  Bound on an H100 SXM at RWKV6-1.6B (nh 32, P 64), b 4, L 2048:
bytes — r, k, v, w read and y written once are 336 MB, 100 µs at 3.35
TB/s, against 5.4 GFLOP of FP32 (80 µs at 67 TFLOP/s).  It has no
backward, as the JAX package's has none.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rwkv6_wkv.ref import rwkv6_wkv_ref

# kernel launches since the last reset (plain counter; callers set it to 0)
launches = 0

MAX_P = 128          # the head size the kernel's layout takes

_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)


def _check(r, k, v, w, u) -> None:
    if r.dim() != 4 or any(a.shape != r.shape for a in (k, v, w)):
        raise ValueError(f"rwkv6_wkv needs r, k, v, w of one (b, L, nh, P) "
                         f"shape, got {[tuple(a.shape) for a in (r, k, v, w)]}")
    b, L, nh, P = r.shape
    if tuple(u.shape) != (nh, P):
        raise ValueError(f"rwkv6_wkv needs u of shape {(nh, P)}, got "
                         f"{tuple(u.shape)}")
    if any(a.dtype != torch.float32 for a in (r, k, v, w, u)):
        raise TypeError(f"rwkv6_wkv takes float32, got "
                        f"{[a.dtype for a in (r, k, v, w, u)]}")
    if any(a.device != r.device for a in (k, v, w, u)):
        raise ValueError("rwkv6_wkv needs all inputs on one device")
    if not all(a.is_contiguous() for a in (r, k, v, w, u)):
        raise ValueError("rwkv6_wkv needs contiguous inputs")
    if not 1 <= P <= MAX_P:
        raise ValueError(f"rwkv6_wkv takes a head size P in [1, {MAX_P}], "
                         f"got {P}")
    if r.numel() >= 2 ** 31 or b >= 2 ** 16:
        raise ValueError(f"rwkv6_wkv cannot take shape {tuple(r.shape)}")
    if torch.is_grad_enabled() and any(a.requires_grad
                                       for a in (r, k, v, w, u)):
        raise RuntimeError("rwkv6_wkv has no backward (nor has the JAX "
                           "package's kernel); call it under torch.no_grad()")


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r, k, v, w: (b, L, nh, P) f32; u: (nh, P) f32 -> y (b, L, nh, P) f32.
    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream."""
    global launches
    _check(r, k, v, w, u)
    if r.device.type == "cpu":
        return rwkv6_wkv_ref(r, k, v, w, u)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_wkv runs on cuda or cpu, not {r.device}")
    y = torch.empty_like(r)
    if r.numel() == 0:
        return y
    b, L, nh, P = r.shape
    fn = build.function("rwkv6_wkv_f32", _ARGTYPES)
    with torch.cuda.device(r.device):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), y.data_ptr(), b, L, nh, P,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "rwkv6_wkv")
    launches += 1
    return y
