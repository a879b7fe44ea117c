"""Wrapper of the CUDA ridge Gram kernel (``csrc/ridge_gram.cu``).

Replaces ``repro/kernels/ridge_gram/ridge_gram.py`` (``_gram_kernel`` /
``gram_pallas``) and its wrapper ``repro/kernels/ridge_gram/ops.py``
(``gram``).  The TPU kernel accumulates over n in a sequential grid axis;
here n is split over ``gridDim.z`` so the few 64 × 64 output tiles still
fill the card, and the last block of each tile sums the per-split partials
in a fixed order (deterministic, no atomics on the values, one launch).  The
products run on the tensor cores in 3xTF32, which keeps f32 accuracy; the
tiles of a symmetric xᵀx below its diagonal are mirrored, not computed.
``gram_pair(o, z)`` computes a Step-4 layer's OᵀO and OᵀZ in one launch;
``gram(x, y)`` is the twin of the JAX op.  A bf16 operand (the smashed data
of the mixed policy) is widened to f32 before the launch, where the JAX op
widens it (``gram_pallas``'s ``astype(float32)``): bf16 values are exact in
f32, so the f32 kernel serves both.  Bound on an H100 SXM: the
operations; the 8 pairs of one DNN10 evaluation at n = 4800 need 1.16e9
operations (n·d1·(d1 + 1) for the symmetric OᵀO, 2·n·d1·d2 for OᵀZ), 7.0
µs at 495 / 3 TFLOP/s.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ridge_gram.ref import gram_ref

# kernel launches since the last reset (plain counter; callers set it to 0)
launches = 0

TILE = 64            # output tile edge of the kernel
CHUNK = 32           # rows of n a shared-memory stage holds
BLOCKS_PER_SM = 2    # split-K target: the blocks an SM holds (the kernel's
                     # launch bounds); the splits fill one wave of them
MIN_CHUNKS = 4       # chunks a split takes at least, so that small Grams are
                     # not cut into more partials than they have work

_ARGTYPES = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 6
             + (ctypes.c_void_p,))

# per (device, stream): the kernel's per-tile counters, zeros between
# launches (each launch's last blocks reset them)
_counters = {}


def _widened(t: torch.Tensor) -> torch.Tensor:
    """A bf16 operand widened to f32 (exact); any other dtype as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


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
    if min(n, d1, d2) == 0 or max(n, d1 * (d1 + d2)) >= 2 ** 31:
        raise ValueError(f"gram cannot take n={n}, d1={d1}, d2={d2}")


@functools.lru_cache(maxsize=1024)
def split_plan(n: int, rows: int, cols: int, sms: int, sym: bool = False):
    """(splits, rows_per_split) of the split over n for a (rows, cols)
    result: at most BLOCKS_PER_SM blocks per SM in all (one wave) where
    the tiles allow, each split a whole number of CHUNK-row chunks and at
    least MIN_CHUNKS of them.  ``sym``: the first ``rows`` columns are a
    symmetric xᵀx, whose tiles below the diagonal the kernel leaves out."""
    t = -(-rows // TILE)
    tiles = t * -(-cols // TILE) - (t * (t - 1) // 2 if sym else 0)
    chunks = -(-n // CHUNK)
    want = max(1, min(chunks // MIN_CHUNKS, BLOCKS_PER_SM * sms // tiles))
    per = -(-chunks // want) * CHUNK
    return -(-n // per), per


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """SMs of CUDA device ``index``, queried once per device."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tile_counters(device: torch.device, stream: int, tiles: int):
    """The zeroed per-tile counters of ``stream`` on ``device``, at least
    ``tiles`` of them."""
    key = (device.index, stream)
    c = _counters.get(key)
    if c is None or c.numel() < tiles:
        c = torch.zeros(max(tiles, 64), dtype=torch.int32, device=device)
        _counters[key] = c
    return c


def _launch(x: torch.Tensor, y1: torch.Tensor, y2) -> tuple:
    """xᵀy1 and (when ``y2`` is a tensor) xᵀy2 from one launch of the
    kernel on the current stream; raises on the launch's error."""
    global launches
    n, da, d1 = x.shape[0], x.shape[1], y1.shape[1]
    d2 = 0 if y2 is None else y2.shape[1]
    dev = x.device
    splits, rows = split_plan(n, da, d1 + d2, _sm_count(dev.index),
                              y1 is x)
    tiles = -(-da // TILE) * -(-(d1 + d2) // TILE)
    # outputs and the scratch of whole partial tiles in one allocation, the
    # scratch from a 16-byte boundary
    at = -(-da * (d1 + d2) // 4) * 4
    buf = torch.empty(at + (splits * tiles * TILE * TILE if splits > 1
                            else 0), dtype=torch.float32, device=dev)
    # (as_strided takes less host time than slicing and viewing)
    out1 = buf.as_strided((da, d1), (d1, 1))
    out2 = buf.as_strided((da, d2), (d2, 1), da * d1)
    fn = build.function("ridge_gram_pair_f32", _ARGTYPES)
    with _on(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), y1.data_ptr(),
                 None if y2 is None else y2.data_ptr(), out1.data_ptr(),
                 out2.data_ptr(),
                 buf.data_ptr() + 4 * at if splits > 1 else None,
                 _tile_counters(dev, stream, tiles).data_ptr(), n, da, d1,
                 d2, splits, rows, stream)
    build.check(err, "ridge_gram")
    launches += 1
    return out1, out2


def _on(device: torch.device):
    """A context that makes ``device`` current, only where it is not."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _placed(x: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version), False for a CUDA one (the
    kernel); raises for any other device."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"gram runs on cuda or cpu, not {x.device}")
    return False


def gram(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """G = XᵀY in f32; x: (n, d1), y: (n, d2) f32 or bf16 -> (d1, d2).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    once."""
    x, y = _widened(x), _widened(y)
    _check(x, y)
    if _placed(x):
        return gram_ref(x, y)
    return _launch(x, y, None)[0]


def gram_pair(o: torch.Tensor, z: torch.Tensor) -> tuple:
    """(OᵀO, OᵀZ) in f32; o: (n, d1), z: (n, d2) f32 or bf16 -> (d1, d1),
    (d1, d2).  CPU tensors take the plain version; CUDA tensors launch the
    kernel once for both."""
    o, z = _widened(o), _widened(z)
    _check(o, z)
    if _placed(o):
        return gram_ref(o, o), gram_ref(o, z)
    return _launch(o, o, z)
