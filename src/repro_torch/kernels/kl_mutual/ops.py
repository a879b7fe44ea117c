"""Wrapper of the CUDA mutual-KL kernel (``csrc/kl_mutual.cu``) and its
``autograd.Function``.

Replaces ``repro/kernels/kl_mutual/kl_mutual.py`` (``_kl_kernel`` /
``kl_rows_pallas``) and ``repro/kernels/kl_mutual/ops.py`` (``_kl_mean``
custom_vjp).  The Pallas wrapper vmaps one (32, 256) call per client; here
the rows of the whole cohort go to ONE launch over an (R, d) layout, one warp
per row.  Bound on an H100 SXM: memory — 3.3 MB read at (1600, 256), about
1 µs at 3.35 TB/s, so launch overhead dominates at that size.

The backward is the closed form ∂x = g·(softmax(x/T) − softmax(y/T))/T per
row, in plain PyTorch ops, as the JAX package also computes it outside
Pallas; y is the stop-gradient target and gets no gradient.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.kl_mutual.ref import kl_rows_ref

# kernel launches since the last reset (plain counter; callers set it to 0)
launches = 0

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_void_p)


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape != y.shape:
        raise ValueError(f"kl_rows needs two (R, d) tensors of one shape, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"kl_rows takes float32, got {x.dtype}, {y.dtype}")
    if x.device != y.device:
        raise ValueError(f"x on {x.device} but y on {y.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("kl_rows needs contiguous inputs")
    if x.shape[1] == 0 or x.shape[0] >= 2 ** 31:
        raise ValueError(f"kl_rows cannot take shape {tuple(x.shape)}")


def kl_rows(x: torch.Tensor, y: torch.Tensor,
            temperature: float = 1.0) -> torch.Tensor:
    """Per-row D_KL(x ‖ y); (R, d) f32 -> (R,) f32.  CPU tensors take the
    plain version; CUDA tensors launch the kernel on the current stream."""
    global launches
    _check(x, y)
    if x.device.type == "cpu":
        return kl_rows_ref(x, y, temperature)
    if x.device.type != "cuda":
        raise ValueError(f"kl_rows runs on cuda or cpu, not {x.device}")
    rows, d = x.shape
    out = torch.empty(rows, dtype=torch.float32, device=x.device)
    fn = build.function("kl_mutual_rows_f32", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), rows, d,
                 1.0 / temperature, torch.cuda.current_stream().cuda_stream)
    build.check(err, "kl_mutual")
    launches += 1
    return out


class KLRows(torch.autograd.Function):
    """Per-row KL with the closed-form gradient in x; y is a target."""

    @staticmethod
    def forward(ctx, x, y, temperature):
        ctx.save_for_backward(x, y)
        ctx.temperature = temperature
        return kl_rows(x, y, temperature)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        t = ctx.temperature
        p_x = torch.softmax(x / t, -1)
        p_y = torch.softmax(y / t, -1)
        return g[:, None] * (p_x - p_y) / t, None, None
