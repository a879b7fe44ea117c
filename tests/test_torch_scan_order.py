"""The order in which the port's CUDA SSD kernel sums the Mamba2 scan.

``csrc/mamba2_scan.cu`` computes the chunked SSD form (chunks of 32 tokens,
the decay weights as running products, the products on the tensor cores);
it runs only on the card.  ``mamba2_scan_chunked_ref`` is that order in f32
on the CPU.  Here it is held against the sequential plain version (the
kernel's yardstick on the card, within ``SCAN_TOL`` = 1e-5 of max|y|) at
5e-7 of max|y| at the main path's length, against the JAX package's Pallas
kernel in interpret mode at that package's own 1e-3, and at the edges of
the form: decays exactly 0 or 1, where a log-cumsum form gives NaN or loses
digits, and lengths that are not a multiple of the chunk.  Last, the
kernel's arithmetic is emulated: each operand split into its TF32 parts as
``csrc/tf32x3.cuh``'s ``split_tf32_fast`` splits it, and each product
summed in runs of k8 steps from zero (two steps over the state, four over a
chunk's tokens), every mma's sum truncated as the tensor core truncates it
(modelled as the exact sum of a k8 step's products, rounded toward zero),
each run added to an f32 sum.  Inputs come from seeded numpy generators
(``chip_smoke.ssd_inputs``' distributions).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2_scan import ops as jssd_ops
from repro_torch.kernels.mamba2_scan.ref import (mamba2_scan_chunked_ref,
                                                 mamba2_scan_ref)

# |chunked − sequential| / max|y|: the sequential f32 recurrence is itself
# ~1.7e-7 from an f64 evaluation at L 2048
ORDER_TOL = 5e-7


def _inputs(seed, b, L, nh, N, P, decay=None):
    g = np.random.default_rng(seed)
    if decay is None:
        decay = 0.35 + 0.6 / (1.0 + np.exp(-g.normal(size=(b, L, nh))))
    dt = np.logaddexp(g.normal(size=(b, L, nh)), 0.0)
    B, C = g.normal(size=(b, L, N)), g.normal(size=(b, L, N))
    x = g.normal(size=(b, L, nh, P))
    return [np.asarray(a, np.float32) for a in (decay, dt, B, C, x)]


def _rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("chunk", [32, 64])
def test_chunked_order_matches_sequential_at_main_path_length(chunk):
    """b 1, L 2048, 4 of Zamba2-2.7B's heads (N = P = 64): the kernel's
    chunk (32) and the reference kernel's 64."""
    args = [torch.from_numpy(a) for a in _inputs(0, 1, 2048, 4, 64, 64)]
    got = mamba2_scan_chunked_ref(*args, chunk=chunk)
    want = mamba2_scan_ref(*args)
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) <= ORDER_TOL


@pytest.mark.parametrize("b,L,nh,N,P,chunk", [
    (2, 64, 3, 16, 32, 32), (1, 256, 2, 8, 16, 64), (1, 96, 2, 64, 64, 32)])
def test_chunked_order_matches_pallas_interpret(b, L, nh, N, P, chunk):
    args = _inputs(1, b, L, nh, N, P)
    want = jssd_ops.mamba2_scan(*map(jnp.asarray, args), chunk=chunk)
    got = mamba2_scan_chunked_ref(*map(torch.from_numpy, args))
    # the JAX package's bound for its SSD kernel (tests/test_kernels.py)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("L", [1, 31, 100, 2048 + 17])
def test_chunked_order_at_exact_zero_and_one_decays(L):
    """Decays of exactly 0 (the state is reset: log 0 − log 0 is NaN in a
    log-cumsum form) and exactly 1 (no decay) among the usual ones, and a
    last chunk shorter than 32."""
    g = np.random.default_rng(2)
    decay = (0.35 + 0.6 / (1.0 + np.exp(-g.normal(size=(1, L, 4)))))
    pick = g.random(size=decay.shape)
    decay[pick < 0.05] = 0.0
    decay[pick > 0.9] = 1.0
    args = [torch.from_numpy(a)
            for a in _inputs(3, 1, L, 4, 64, 64, decay=decay)]
    got = mamba2_scan_chunked_ref(*args)
    want = mamba2_scan_ref(*args)
    assert got.shape == want.shape == (1, L, 4, 64)
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) <= ORDER_TOL


def test_chunked_order_of_an_empty_sequence():
    args = [torch.from_numpy(a) for a in _inputs(4, 2, 0, 3, 4, 8)]
    assert mamba2_scan_chunked_ref(*args).shape == (2, 0, 3, 8)


def _rna_tf32(a):
    """float32 rounded to TF32 (the low 13 bits zero), to nearest with ties
    away from zero (tests/test_torch_tf32x3.py)."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _rz(x):
    """float64 -> float32 rounded toward zero, as the tensor core rounds the
    sum of its accumulator and its products."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    y[over] = np.nextafter(y[over], np.float32(0))
    return y


def _trunc_tf32(a):
    """float32 with its low 13 bits cleared: how the tensor core reads a TF32
    operand that was not rounded to TF32."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def _mm_3xtf32(a, b, run, init=None):
    """a @ b over the last two axes as the kernel forms it: each operand
    split into hi = rna(a) and lo = a − hi, lo read by the tensor core
    truncated (split_tf32_fast); per run of ``run`` k8 steps (the kernel's
    kRun) the products lo·hi, hi·lo, hi·hi of each step from zero, each mma
    truncated, then the run added to the f32 sum (from ``init``, or 0) with
    a rounded add."""
    ah = _rna_tf32(a)
    al = _trunc_tf32(a - ah)
    bh = _rna_tf32(b)
    bl = _trunc_tf32(b - bh)
    f = lambda z: z.astype(np.float64)
    out = np.zeros(np.matmul(a[..., :1], b[..., :1, :]).shape, np.float32)
    if init is not None:
        out = out + init
    K = a.shape[-1]
    for k0 in range(0, K, 8 * run):
        acc = None
        for k in range(k0, min(K, k0 + 8 * run), 8):
            s = slice(k, k + 8)
            for x, y in ((al, bh), (ah, bl), (ah, bh)):
                p = f(x[..., s]) @ f(y[..., s, :])
                acc = _rz(p if acc is None else f(acc) + p)
        out = out + acc
    return out


def _emulated_kernel(decay, dt, B, C, x, chunk=32):
    """The SSD kernel's arithmetic in numpy: mamba2_scan_chunked_ref's order
    (dt folded into the decay weights) with its four matrix products (C Bᵀ,
    C h, (C Bᵀ ∘ W) x and the state update) taken by _mm_3xtf32, in runs of
    two k8 steps over the state and of four over the chunk's tokens (the
    kernel's kRunN, kRunT)."""
    b, L, nh = decay.shape
    X = x.transpose(0, 2, 1, 3)                             # (b, nh, L, P)
    a_all = decay.transpose(0, 2, 1)
    dt_all = dt.transpose(0, 2, 1)
    h = np.zeros((b, nh, B.shape[-1], x.shape[-1]), np.float32)
    ys = []
    for t0 in range(0, L, chunk):
        a = a_all[..., t0:t0 + chunk]
        q = a.shape[-1]
        cum = np.cumprod(a, axis=-1, dtype=np.float32)
        W = np.zeros((b, nh, q, q), np.float32)
        col = np.zeros((b, nh, q), np.float32)
        for t in range(q):
            col = col * a[..., t, None]
            col[..., t] = 1.0
            W[..., t, :] = col
        W = W * dt_all[..., None, t0:t0 + q]
        Bc, Cc, Xc = B[:, t0:t0 + q], C[:, t0:t0 + q], X[:, :, t0:t0 + q]
        M = _mm_3xtf32(Cc, Bc.transpose(0, 2, 1), run=2)[:, None] * W
        yh = _mm_3xtf32(np.broadcast_to(Cc[:, None], (b, nh) + Cc.shape[1:]),
                        h, run=2)
        ys.append(_mm_3xtf32(M, Xc, run=4, init=cum[..., None] * yh))
        Bw = Bc[:, None] * W[..., q - 1, :, None]
        h = cum[..., q - 1, None, None] * h + _mm_3xtf32(
            Bw.transpose(0, 1, 3, 2), Xc, run=4)
    return np.concatenate(ys, axis=2).transpose(0, 2, 1, 3)


def test_emulated_kernel_arithmetic_matches_sequential():
    """The card compares the kernel with the sequential plain version at
    SCAN_TOL = 1e-5 of max|y|; the kernel's own arithmetic stays at the
    order's 5e-7 at the main path's length, so the full-width f32 prefill
    of Zamba2-2.7B, which amplifies the scan's error ~230x, keeps its 1e-4
    check (chip_smoke.PRESET_TOL)."""
    args = _inputs(0, 1, 2048, 4, 64, 64)
    got = torch.from_numpy(_emulated_kernel(*args))
    want = mamba2_scan_ref(*map(torch.from_numpy, args))
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) <= ORDER_TOL


def test_log_cumsum_form_of_the_reference_is_less_accurate():
    """Why the port's order departs from the reference kernel's formula:
    the Pallas kernel's decay weights exp(l_t − l_s) of a log cumsum
    (interpret mode, chunks of 64) sit further from the sequential
    recurrence than the running products do, and a decay of exactly 0
    makes them NaN (log 0 − log 0)."""
    args = _inputs(0, 1, 2048, 4, 64, 64)
    want = mamba2_scan_ref(*map(torch.from_numpy, args))
    ref_kernel = torch.from_numpy(np.array(
        jssd_ops.mamba2_scan(*map(jnp.asarray, args), chunk=64)))
    chunked = mamba2_scan_chunked_ref(*map(torch.from_numpy, args))
    assert _rel_err(ref_kernel, want) > 2 * _rel_err(chunked, want)
    args[0][0, 5, 1] = 0.0
    nan_case = np.asarray(jssd_ops.mamba2_scan(
        *map(jnp.asarray, (a[:, :128] for a in args)), chunk=64))
    assert not np.isfinite(nan_case).all()
    assert torch.isfinite(mamba2_scan_chunked_ref(
        *(torch.from_numpy(a[:, :128]) for a in args))).all()
