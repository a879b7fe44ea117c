"""The 3xTF32 tolerance argument, emulated on the CPU.

The port's Gram kernel and its f32 attention kernel (``csrc/ridge_gram.cu``,
``csrc/flash_attention_tf32.cu``) take f32 products on the tensor cores as
three TF32 products, hi·hi + hi·lo + lo·hi, with hi = rna(a) and lo =
rna(a − hi) (``csrc/tf32x3.cuh``).  The CUDA kernels run only on the card;
here numpy emulates the split bit for bit (TF32 keeps 10 of float32's 23
mantissa bits; ``rna`` rounds to nearest, ties away from zero) and shows
that the arithmetic meets the bounds the card holds the kernels to:
``GRAM_TOL`` = 1e-5 of the summation scale max(|X|ᵀ|Y|) for the Grams and
2e-4 per element for f32 attention (``chip_smoke.py``).  The tensor core
also truncates each sum it forms (rounds toward zero); emulating that shows
why the kernels form each k8 step's products from zero and add them to
their long sums with rounded f32 adds, and why attention's scores, with q
and k of one sign, can keep one accumulator.  Inputs come from seeded numpy
generators.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ref import attention

GRAM_TOL = 1e-5          # chip_smoke.GRAM_TOL
FLASH_F32_TOL = 2e-4     # chip_smoke.FLASH_TOL["float32"] (atol)


def rna_tf32(a: np.ndarray) -> np.ndarray:
    """float32 -> float32 rounded to TF32 (the low 13 bits zero), to nearest
    with ties away from zero, as ``cvt.rna.tf32.f32``: add half of the
    dropped field to the magnitude bits, then clear it."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(a: np.ndarray):
    a = np.asarray(a, dtype=np.float32)
    hi = rna_tf32(a)
    return hi, rna_tf32(a - hi)   # a - hi is exact in float32


def _f64(a):
    return np.asarray(a, dtype=np.float64)


def matmul_3xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b with each f32 product taken as hi·hi + hi·lo + lo·hi of the
    TF32 parts, summed in f64: the error of the split alone."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return _f64(al) @ _f64(bh) + _f64(ah) @ _f64(bl) + _f64(ah) @ _f64(bh)


def test_rna_rounds_to_nearest_ties_away_and_splits_exactly():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)              # TF32 unit in the last place
    vals = np.array([one + ulp / 4, one + ulp / 2, one + 3 * ulp / 4,
                     -(one + ulp / 2), one + ulp + ulp / 2], np.float32)
    want = np.array([one, one + ulp, one + ulp, -(one + ulp),
                     one + 2 * ulp], np.float32)
    np.testing.assert_array_equal(rna_tf32(vals), want)
    a = np.random.default_rng(0).normal(size=1000).astype(np.float32)
    hi, lo = split_tf32(a)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    # hi + lo is a to ~2^-22: a one-part TF32 value misses it by ~2^-11
    rel = np.abs(_f64(hi) + _f64(lo) - _f64(a)) / np.abs(_f64(a))
    assert rel.max() <= 2.0 ** -21
    assert (np.abs(_f64(hi) - _f64(a)) / np.abs(_f64(a))).max() > 2.0 ** -13


@pytest.mark.parametrize("d1,d2", [(257, 257), (257, 128)])
def test_emulated_gram_is_inside_the_card_bound(d1, d2):
    """At the main path's largest Grams (n = 4800): the split's own error is
    100x inside GRAM_TOL; with the kernel's f32 accumulators (one f32 sum
    per m16n8k8 product, the three products in the kernel's order, over
    all of n in one split, the longest sum the kernel can take) it is still
    inside GRAM_TOL; one TF32 product alone misses GRAM_TOL."""
    g = np.random.default_rng(1)
    x = g.normal(size=(4800, d1)).astype(np.float32)
    y = g.normal(size=(4800, d2)).astype(np.float32)
    exact = _f64(x).T @ _f64(y)
    scale = (np.abs(_f64(x)).T @ np.abs(_f64(y))).max()

    err3 = np.abs(matmul_3xtf32(x.T, y) - exact).max() / scale
    assert err3 <= GRAM_TOL / 100, err3

    xh, xl = split_tf32(x)
    yh, yl = split_tf32(y)
    acc = np.zeros((d1, d2), np.float32)
    for k in range(0, len(x), 8):
        s = slice(k, k + 8)
        for a, b in ((xl, yh), (xh, yl), (xh, yh)):
            acc = (_f64(acc) + _f64(a[s]).T @ _f64(b[s])).astype(np.float32)
    err_acc = np.abs(_f64(acc) - exact).max() / scale
    assert err_acc <= GRAM_TOL, err_acc

    err1 = np.abs(_f64(xh).T @ _f64(yh) - exact).max() / scale
    assert err1 > GRAM_TOL, err1


def _emulated_attention(q, k, v, scale, window):
    """Causal GQA attention with S = QKᵀ and O = PV in 3xTF32 and the
    softmax in f32, P split into TF32 hi and lo as the kernel splits it."""
    B, H, S, D = q.shape
    group = H // k.shape[1]
    out = np.empty((B, H, S, D), np.float32)
    i = np.arange(S)[:, None]
    j = np.arange(S)[None, :]
    vis = j <= i
    if window is not None:
        vis &= j > i - window
    for b in range(B):
        for h in range(H):
            kv = h // group
            s = matmul_3xtf32(q[b, h], k[b, kv].T).astype(np.float32)
            s = np.where(vis, s * np.float32(scale), -np.inf)
            p = np.exp(s - s.max(-1, keepdims=True)).astype(np.float32)
            o = matmul_3xtf32(p, v[b, kv]) / _f64(p).sum(-1, keepdims=True)
            out[b, h] = o.astype(np.float32)
    return out


@pytest.mark.parametrize("shape,window", [((1, 4, 2, 128, 64), None),
                                          ((2, 3, 3, 96, 80), 32),
                                          ((1, 2, 1, 65, 128), None)])
def test_emulated_attention_is_inside_the_f32_bound(shape, window):
    B, H, KV, S, D = shape
    g = np.random.default_rng(2)
    q = g.normal(size=(B, H, S, D)).astype(np.float32)
    k = g.normal(size=(B, KV, S, D)).astype(np.float32)
    v = g.normal(size=(B, KV, S, D)).astype(np.float32)
    got = _emulated_attention(q, k, v, D ** -0.5, window)
    want = attention(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), scale=D ** -0.5,
                     window=window).numpy()
    err = np.abs(got - want).max()
    # 100x inside the bound, as for the Grams
    assert err <= FLASH_F32_TOL / 100, err


def _rz(x) -> np.ndarray:
    """float64 -> float32 rounded toward zero, as the tensor core rounds the
    sum of its accumulator and its products."""
    x = _f64(x)
    y = x.astype(np.float32)
    over = np.abs(_f64(y)) > np.abs(x)
    y[over] = np.nextafter(y[over], np.float32(0))
    return y


@pytest.mark.parametrize("keys,D", [(2048, 80), (8192, 128)])
def test_emulated_pv_sum_from_zero_does_not_drift_with_one_sign_v(keys, D):
    """One query row's O = P V over all its keys (Zamba2-2.7B's 2048, and
    Qwen3-14B's window of 8192), V a normal plus 2, so that the terms p v
    have one sign.  Three mma a k8 step straight into O's accumulator, each
    truncated, drift one way with the number of keys, to a share of the
    2e-4 bound; each tile of 32 keys (the kernel's tile at these head
    sizes) summed from zero and added to O with a rounded f32 add
    (flash_attention_tf32.cu) stay 50x inside it."""
    tile = 32
    g = np.random.default_rng(3)
    s = g.normal(size=keys).astype(np.float32)
    p = np.exp2(s - s.max()).astype(np.float32)
    v = (g.normal(size=(keys, D)) + 2).astype(np.float32)
    exact = _f64(p) @ _f64(v) / _f64(p).sum()
    ph, pl = split_tf32(p)
    vh, vl = split_tf32(v)
    into_acc = np.zeros(D, np.float32)
    by_tile = np.zeros(D, np.float32)
    for k0 in range(0, keys, tile):
        d = np.zeros(D, np.float32)
        for k in range(k0, k0 + tile, 8):
            s8 = slice(k, k + 8)
            for a, b in ((pl, vh), (ph, vl), (ph, vh)):
                prod = _f64(a[s8]) @ _f64(b[s8])
                into_acc = _rz(_f64(into_acc) + prod)
                d = _rz(_f64(d) + prod)
        by_tile = by_tile + d                # f32, rounded to nearest
    l = np.float32(_f64(p).sum())
    err_into = np.abs(_f64(into_acc / l) - exact).max()
    err_tile = np.abs(_f64(by_tile / l) - exact).max()
    assert err_tile <= FLASH_F32_TOL / 50, err_tile
    assert err_into >= 10 * err_tile, (err_into, err_tile)


@pytest.mark.parametrize("keys,D", [(2048, 80), (8192, 128)])
def test_emulated_scores_with_one_sign_qk_stay_inside_the_f32_bound(keys, D):
    """Query rows against all their keys (Zamba2-2.7B's 2048 at D 80, and
    Qwen3-14B's window of 8192 at D 128), q and k each a normal plus 2, so
    that the terms of S = q Kᵀ have one sign and |S| reaches ~600 before
    the scale.  The attention kernel forms S in one accumulator, three mma
    a k8 step over D (flash_attention_tf32.cu), each truncated; the drift
    is nearly the same for every key, the softmax cancels what is common,
    and the emulated O stays 50x inside the 2e-4 bound.  (The model covers
    only the accumulator's truncation; on the card the same cases come
    within a fifth of the bound, tests/test_torch_cuda.py.)"""
    g = np.random.default_rng(4)
    worst = 0.0
    for _ in range(4):
        q = (g.normal(size=D) + 2).astype(np.float32)
        k = (g.normal(size=(keys, D)) + 2).astype(np.float32)
        v = g.normal(size=(keys, D)).astype(np.float32)
        qh, ql = split_tf32(q)
        kh, kl = split_tf32(k)
        s = np.zeros(keys, np.float32)
        for d0 in range(0, D, 8):
            s8 = slice(d0, d0 + 8)
            for a, b in ((ql, kh), (qh, kl), (qh, kh)):
                s = _rz(_f64(s) + _f64(b[:, s8]) @ _f64(a[s8]))
        scale = D ** -0.5
        exact = _f64(k) @ _f64(q) * scale
        p = np.exp(_f64(s) * scale - (_f64(s) * scale).max())
        pe = np.exp(exact - exact.max())
        err = np.abs(p @ _f64(v) / p.sum() - pe @ _f64(v) / pe.sum()).max()
        worst = max(worst, err)
    assert worst <= FLASH_F32_TOL / 50, worst
