"""Wrapper of the CUDA ridge Gram kernel (``csrc/ridge_gram.cu``).

Replaces ``repro/kernels/ridge_gram/ridge_gram.py`` (``_gram_kernel`` /
``gram_pallas``) and its wrapper ``repro/kernels/ridge_gram/ops.py``
(``gram``).  The TPU kernel accumulates over n in a sequential grid axis;
here n is split over ``gridDim.z`` so the few 32 × 32 output tiles still fill
the card, and the per-split partials are summed in a fixed order by a second
kernel (deterministic, no atomics).  Bound on an H100 SXM: FP32 operations —
the 16 Grams of one DNN10 evaluation at n = 4800 are 1.7 GFLOP, about 26 µs
at 67 TFLOP/s without tensor cores.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ridge_gram.ref import gram_ref

# kernel launches since the last reset (plain counter; callers set it to 0)
launches = 0

TILE = 32            # output tile edge and n-chunk of the kernel
BLOCKS_PER_SM = 4    # split-K target: enough blocks in flight per SM

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.dim() != 2 or y.dim() != 2 or x.shape[0] != y.shape[0]:
        raise ValueError(f"gram needs x (n, d1) and y (n, d2), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"gram takes float32, got {x.dtype}, {y.dtype}")
    if x.device != y.device:
        raise ValueError(f"x on {x.device} but y on {y.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("gram needs contiguous inputs")
    n, d1, d2 = x.shape[0], x.shape[1], y.shape[1]
    if min(n, d1, d2) == 0 or max(n, d1 * d2) >= 2 ** 31:
        raise ValueError(f"gram cannot take n={n}, d1={d1}, d2={d2}")


def split_plan(n: int, d1: int, d2: int, sms: int):
    """(splits, rows_per_split) of the split over n: about BLOCKS_PER_SM
    blocks per SM in all, each split a whole number of TILE-row chunks."""
    tiles = -(-d1 // TILE) * -(-d2 // TILE)
    chunks = -(-n // TILE)
    want = max(1, min(chunks, -(-BLOCKS_PER_SM * sms // tiles)))
    rows = -(-chunks // want) * TILE
    return -(-n // rows), rows


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """SMs of CUDA device ``index``, queried once per device."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def gram(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """G = XᵀY in f32; x: (n, d1), y: (n, d2) f32 -> (d1, d2).  CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    global launches
    _check(x, y)
    if x.device.type == "cpu":
        return gram_ref(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"gram runs on cuda or cpu, not {x.device}")
    n, d1, d2 = x.shape[0], x.shape[1], y.shape[1]
    splits, rows = split_plan(n, d1, d2, _sm_count(x.device.index))
    part = torch.empty((splits, d1, d2), dtype=torch.float32, device=x.device)
    out = torch.empty((d1, d2), dtype=torch.float32, device=x.device)
    fn = build.function("ridge_gram_f32", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), part.data_ptr(), out.data_ptr(),
                 n, d1, d2, splits, rows,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "ridge_gram")
    launches += 1
    return out
