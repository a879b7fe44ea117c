"""Wrapper of the CUDA Mamba2 SSD scan kernel (``csrc/mamba2_scan.cu``).

Replaces ``repro/kernels/mamba2_scan/mamba2_scan.py`` (``_ssd_kernel`` /
``mamba2_scan_pallas``) and its wrapper ``repro/kernels/mamba2_scan/ops.py``
(``mamba2_scan``).  Like the TPU kernel, this one computes the chunked SSD
form, its products on the tensor cores in 3xTF32: one block of 4 warps per
(batch, head) walks chunks of 32 tokens with the (N, P) state in shared
memory and the decay weights as running products
(``ref.mamba2_scan_chunked_ref`` is the same order in f32).  Any L is taken
without padding.  Bound on an H100 SXM at Zamba2-2.7B (nh 80, N 64, P 64),
b 4, L 2048: bytes, 345 MB moved, 103 µs at 3.35 TB/s (the chunked form's
operations take 79 µs, the sequential form's 13.4 GFLOP of FP32 200 µs).
It has no backward, as the JAX package's has none.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mamba2_scan.ref import mamba2_scan_ref

# kernel launches since the last reset (plain counter; callers set it to 0)
launches = 0

MAX_N = 128          # the state sizes the kernel's shared-memory
MAX_P = 128          # layout takes

_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


def _check(decay, dt, B, C, x) -> None:
    if x.dim() != 4 or decay.dim() != 3 or B.dim() != 3:
        raise ValueError(f"mamba2_scan needs decay, dt (b, L, nh), B, C "
                         f"(b, L, N) and x (b, L, nh, P), got "
                         f"{[tuple(a.shape) for a in (decay, dt, B, C, x)]}")
    b, L, nh, P = x.shape
    N = B.shape[-1]
    if (tuple(decay.shape) != (b, L, nh) or dt.shape != decay.shape
            or tuple(B.shape) != (b, L, N) or C.shape != B.shape):
        raise ValueError(f"mamba2_scan shapes disagree: "
                         f"{[tuple(a.shape) for a in (decay, dt, B, C, x)]}")
    if any(a.dtype != torch.float32 for a in (decay, dt, B, C, x)):
        raise TypeError(f"mamba2_scan takes float32, got "
                        f"{[a.dtype for a in (decay, dt, B, C, x)]}")
    if any(a.device != x.device for a in (decay, dt, B, C)):
        raise ValueError("mamba2_scan needs all inputs on one device")
    if not all(a.is_contiguous() for a in (decay, dt, B, C, x)):
        raise ValueError("mamba2_scan needs contiguous inputs")
    if not (1 <= N <= MAX_N and 1 <= P <= MAX_P):
        raise ValueError(f"mamba2_scan takes N in [1, {MAX_N}] and P in "
                         f"[1, {MAX_P}], got N={N}, P={P}")
    if x.numel() >= 2 ** 31 or b >= 2 ** 16:
        raise ValueError(f"mamba2_scan cannot take shape {tuple(x.shape)}")
    if torch.is_grad_enabled() and any(a.requires_grad
                                       for a in (decay, dt, B, C, x)):
        raise RuntimeError("mamba2_scan has no backward (nor has the JAX "
                           "package's kernel); call it under torch.no_grad()")


def mamba2_scan(decay: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """decay, dt: (b, L, nh); B, C: (b, L, N); x: (b, L, nh, P), all f32 ->
    y (b, L, nh, P) f32.  CPU tensors take the plain version; CUDA tensors
    launch the kernel on the current stream."""
    global launches
    _check(decay, dt, B, C, x)
    if x.device.type == "cpu":
        return mamba2_scan_ref(decay, dt, B, C, x)
    if x.device.type != "cuda":
        raise ValueError(f"mamba2_scan runs on cuda or cpu, not {x.device}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    b, L, nh, P = x.shape
    fn = build.function("mamba2_scan_f32", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(decay.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
                 x.data_ptr(), y.data_ptr(), b, L, nh, B.shape[-1], P,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "mamba2_scan")
    launches += 1
    return y
