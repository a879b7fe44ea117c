"""Wrapper of the CUDA mutual-KL kernels (``csrc/kl_mutual.cu``) and their
``autograd.Function``.

Replaces ``repro/kernels/kl_mutual/kl_mutual.py`` (``_kl_kernel`` /
``kl_rows_pallas``) and ``repro/kernels/kl_mutual/ops.py`` (``_kl_mean``
custom_vjp).  The Pallas wrapper vmaps one (32, 256) call per client; here
the rows of the whole cohort go to ONE launch over an (R, d) layout, one warp
per row.  Bound on an H100 SXM: memory — 3.28 MB at (1600, 256), 0.98 µs at
3.35 TB/s, so launch overhead dominates at that size.

x and y are each f32 or bf16, as the Pallas kernel widens each operand in
its body: the kernels read bf16 rows themselves (no widened copy is made
before the launch) and compute in f32; the f32 pair keeps its entries
``kl_mutual_rows_f32`` / ``kl_mutual_grad_f32``, every other pair has its
own (``kl_mutual_rows_bf16_f32`` …), and the gradient is stored in x's
dtype.  Under the bf16 policy the client phase gives (bf16 x, f32 y), the
server phase (f32 x, bf16 y).

The backward is the closed form ∂x = g·(softmax(x/T) − softmax(y/T))/T per
row, as the JAX package computes it outside Pallas (where XLA fuses it into
one pass): on the card ONE launch of ``kl_mutual_grad_f32``, which reads g
at its own stride (0 where autograd hands one value over for every row)
instead of copying it, on the CPU its plain version ``kl_grad_ref``.  y is the stop-gradient target and gets
no gradient.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.kl_mutual.ref import kl_grad_ref, kl_rows_ref

# kernel launches since the last reset (plain counters; callers set them to
# 0 and clear the dict): the forward's and the backward's, and per C entry
launches = 0
launches_bwd = 0
launches_by_entry: dict = {}

_TYPE = {torch.float32: "f32", torch.bfloat16: "bf16"}

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_void_p)
# x, y, g, g's stride, gx, rows, d, 1 / T, stream
_BWD_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int64, ctypes.c_void_p,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p))


def _launch(name: str, argtypes, device: torch.device, *args) -> None:
    """Call the C entry ``name`` with ``args`` and the current stream of
    ``device``, entering the device only when it is not the current one;
    raises on the launch's error."""
    fn = build.function(name, argtypes)
    if device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    build.check(err, name)


def entry(kind: str, x: torch.Tensor, y: torch.Tensor) -> str:
    """The C entry of ``kind`` ("rows" or "grad") for x's and y's dtypes."""
    tx, ty = _TYPE[x.dtype], _TYPE[y.dtype]
    suffix = "f32" if tx == ty == "f32" else f"{tx}_{ty}"
    return f"kl_mutual_{kind}_{suffix}"


def _count(name: str) -> None:
    launches_by_entry[name] = launches_by_entry.get(name, 0) + 1


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape != y.shape:
        raise ValueError(f"kl_rows needs two (R, d) tensors of one shape, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype not in _TYPE or y.dtype not in _TYPE:
        raise TypeError(f"kl_rows takes float32 or bfloat16, got {x.dtype}, "
                        f"{y.dtype}")
    if x.device != y.device:
        raise ValueError(f"x on {x.device} but y on {y.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("kl_rows needs contiguous inputs")
    if x.shape[1] == 0 or x.shape[0] >= 2 ** 31:
        raise ValueError(f"kl_rows cannot take shape {tuple(x.shape)}")


def kl_rows(x: torch.Tensor, y: torch.Tensor,
            temperature: float = 1.0) -> torch.Tensor:
    """Per-row D_KL(x ‖ y); (R, d) f32 or bf16 each -> (R,) f32.  CPU
    tensors take the plain version; CUDA tensors launch the kernel of their
    dtypes on the current stream."""
    global launches
    _check(x, y)
    if x.device.type == "cpu":
        return kl_rows_ref(x, y, temperature)
    if x.device.type != "cuda":
        raise ValueError(f"kl_rows runs on cuda or cpu, not {x.device}")
    rows, d = x.shape
    out = torch.empty(rows, dtype=torch.float32, device=x.device)
    name = entry("rows", x, y)
    _launch(name, _ARGTYPES, x.device, x.data_ptr(), y.data_ptr(),
            out.data_ptr(), rows, d, 1.0 / temperature)
    launches += 1
    _count(name)
    return out


def kl_grad(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
            temperature: float = 1.0) -> torch.Tensor:
    """∂/∂x of Σ_r g[r]·D_KL(x_r ‖ y_r): (R, d) x and y (f32 or bf16
    each), (R,) f32 g at any stride -> (R, d) in x's dtype.  CPU tensors
    take the plain version; CUDA tensors launch the kernel of their dtypes
    on the current stream."""
    global launches_bwd
    _check(x, y)
    if g.shape != x.shape[:1] or g.dtype != torch.float32:
        raise ValueError(f"kl_grad needs g of shape ({x.shape[0]},) in "
                         f"float32, got {tuple(g.shape)} {g.dtype}")
    if g.device != x.device:
        raise ValueError(f"x on {x.device} but g on {g.device}")
    if x.device.type == "cpu":
        return kl_grad_ref(x, y, g, temperature)
    if x.device.type != "cuda":
        raise ValueError(f"kl_grad runs on cuda or cpu, not {x.device}")
    rows, d = x.shape
    gx = torch.empty_like(x)
    name = entry("grad", x, y)
    _launch(name, _BWD_ARGTYPES, x.device, x.data_ptr(), y.data_ptr(),
            g.data_ptr(), g.stride(0), gx.data_ptr(), rows, d,
            1.0 / temperature)
    launches_bwd += 1
    _count(name)
    return gx


class KLRows(torch.autograd.Function):
    """Per-row KL with the closed-form gradient in x (in x's dtype); y is a
    target."""

    @staticmethod
    def forward(ctx, x, y, temperature):
        ctx.save_for_backward(x, y)
        ctx.temperature = temperature
        return kl_rows(x, y, temperature)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return kl_grad(x, y, g, ctx.temperature), None, None
