"""The port's causal GQA flash attention against the JAX package's.

On the CPU the port's wrapper runs its plain PyTorch version (a CUDA kernel
has no interpret mode); the JAX op runs its Pallas kernel in interpret mode,
as the JAX package's own tests run it.  Inputs come from seeded numpy
generators; bf16 inputs are the same f32 draws rounded to bf16 on both
sides.  Tolerances, per element: in f32 the JAX package's own bound
(``tests/test_kernels.py``), 2e-4; in bf16 one bf16 unit in the last place
of the JAX output (2^-7 of its magnitude, plus 1e-5), since both sides
round an f32 result to nearest; the two plain versions agree to 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention import ref as jfa_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention

# (rtol, atol)
_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (2 ** -7, 1e-5)}

# (B, H, KV, S, D): tests/test_kernels.py's four shapes
_KERNEL_SHAPES = [(2, 4, 2, 128, 64), (1, 8, 1, 256, 64), (2, 3, 3, 96, 32),
                  (1, 2, 2, 64, 128)]


def _inputs(seed, B, H, KV, S, D):
    g = np.random.default_rng(seed)
    return (g.normal(size=(B, H, S, D)).astype(np.float32),
            g.normal(size=(B, KV, S, D)).astype(np.float32),
            g.normal(size=(B, KV, S, D)).astype(np.float32))


def _both(arrays, dtype):
    """The same arrays as JAX and torch inputs of ``dtype``."""
    jx = tuple(jnp.asarray(a, getattr(jnp, dtype)) for a in arrays)
    tx = tuple(torch.tensor(a).to(getattr(torch, dtype)) for a in arrays)
    return jx, tx


def _compare_op(shape, window, dtype, scale=None, seed=0):
    jx, tx = _both(_inputs(seed, *shape), dtype)
    want = jfa_ops.flash_attention(*jx, scale=scale, window=window)
    before = fa_ops.launches
    got = fa_ops.flash_attention(*tx, scale=scale, window=window)
    assert fa_ops.launches == before          # the CPU runs no kernel
    assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
    rtol, atol = _TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape", _KERNEL_SHAPES)
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_matches_jax_op(shape, window, dtype):
    _compare_op(shape, window, dtype)


@pytest.mark.parametrize("shape,window,scale", [
    ((1, 4, 2, 1, 64), None, None),          # one token
    ((1, 4, 2, 17, 64), None, None),         # ragged, shorter than a tile
    ((2, 4, 2, 100, 64), 64, None),          # ragged, windowed
    ((1, 4, 2, 100, 64), 1, None),           # each row sees itself only
    ((1, 32, 32, 64, 80), None, None),       # Zamba2-2.7B heads, D 80
    ((1, 40, 8, 100, 128), None, None),      # Qwen3-14B heads, group 5
    ((1, 40, 8, 100, 128), 64, None),
    ((1, 4, 2, 128, 64), None, 0.3),         # a scale other than 1/sqrt(D)
])
def test_op_matches_jax_op_at_edge_shapes(shape, window, scale):
    _compare_op(shape, window, "float32", scale=scale, seed=1)


@pytest.mark.parametrize("shape", [(1, 32, 32, 64, 80), (1, 40, 8, 100, 128)])
def test_op_matches_jax_op_in_bf16_at_model_heads(shape):
    _compare_op(shape, None, "bfloat16", seed=2)


@pytest.mark.parametrize("shape,window,scale", [
    ((2, 4, 2, 128, 64), None, 0.125), ((2, 4, 2, 128, 64), 64, 0.125),
    ((1, 40, 8, 100, 128), 7, 0.3), ((1, 3, 1, 17, 80), None, 1.0)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_matches_jax_ref(shape, window, scale, causal):
    q, k, v = _inputs(3, *shape)
    want = jfa_ref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             scale=scale, causal=causal, window=window)
    got = attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                    scale=scale, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_window_wider_than_the_sequence_is_no_window():
    _, tx = _both(_inputs(4, 1, 4, 2, 50, 32), "float32")
    torch.testing.assert_close(fa_ops.flash_attention(*tx, window=50),
                               fa_ops.flash_attention(*tx), rtol=0, atol=0)
    torch.testing.assert_close(fa_ops.flash_attention(*tx, window=10 ** 9),
                               fa_ops.flash_attention(*tx), rtol=0, atol=0)


def _t(*shape, dtype=torch.float32, device="cpu"):
    return torch.zeros(shape, dtype=dtype, device=device)


@pytest.mark.parametrize("call,error", [
    (lambda: fa_ops.flash_attention(_t(1, 2, 4, 8), _t(1, 2, 4, 8),
                                    _t(1, 2, 4, 8), causal=False),
     ValueError),
    (lambda: fa_ops.flash_attention(_t(1, 2, 4, 8), _t(1, 2, 4, 8),
                                    _t(1, 2, 4, 8, dtype=torch.bfloat16)),
     TypeError),
    (lambda: fa_ops.flash_attention(_t(1, 2, 4, 8, dtype=torch.float16),
                                    _t(1, 2, 4, 8, dtype=torch.float16),
                                    _t(1, 2, 4, 8, dtype=torch.float16)),
     TypeError),
    (lambda: fa_ops.flash_attention(_t(1, 2, 4, 8), _t(1, 2, 4, 8),
                                    _t(1, 2, 4, 8, device="meta")),
     ValueError),
    (lambda: fa_ops.flash_attention(_t(1, 3, 4, 8), _t(1, 2, 4, 8),
                                    _t(1, 2, 4, 8)), ValueError),
    (lambda: fa_ops.flash_attention(_t(1, 2, 4, 136), _t(1, 2, 4, 136),
                                    _t(1, 2, 4, 136)), ValueError),
    (lambda: fa_ops.flash_attention(_t(1, 2, 4, 8), _t(1, 2, 5, 8),
                                    _t(1, 2, 5, 8)), ValueError),
    (lambda: fa_ops.flash_attention(_t(1, 2, 4, 8), _t(1, 2, 4, 8),
                                    _t(1, 2, 4, 8), window=0), ValueError),
    (lambda: fa_ops.flash_attention(_t(1, 2, 4, 8).transpose(2, 3),
                                    _t(1, 2, 8, 4), _t(1, 2, 8, 4)),
     ValueError),
    (lambda: fa_ops.flash_attention(_t(1, 2, 4, 8).requires_grad_(),
                                    _t(1, 2, 4, 8), _t(1, 2, 4, 8)),
     RuntimeError),
], ids=["causal_false", "mixed_dtypes", "float16", "mixed_devices",
        "heads_not_a_multiple", "head_size_over_128", "kv_length_differs",
        "window_0", "not_contiguous", "requires_grad"])
def test_wrapper_rejects_bad_inputs(call, error):
    before = fa_ops.launches
    with pytest.raises(error):
        call()
    assert fa_ops.launches == before


def test_wrapper_runs_without_grad_and_at_the_size_limits():
    q = _t(1, 2, 3, 128).requires_grad_()
    with torch.no_grad():
        assert fa_ops.flash_attention(q, _t(1, 1, 3, 128),
                                      _t(1, 1, 3, 128)).shape == q.shape
    assert fa_ops.flash_attention(_t(1, 2, 3, 1), _t(1, 2, 3, 1),
                                  _t(1, 2, 3, 1)).shape == (1, 2, 3, 1)
    assert fa_ops.flash_attention(_t(0, 2, 3, 8), _t(0, 1, 3, 8),
                                  _t(0, 1, 3, 8)).shape == (0, 2, 3, 8)


# the kernel a CUDA call takes and its copy width in bytes, from dtype, head
# size and pointers alone: every input goes to a tensor-core kernel; 16-byte
# copies where q, k, v and the row are 16-byte aligned and o takes pair
# stores, else 4 where k, v and the row allow, else 2
_ALIGNED = (1 << 20, 2 << 20, 3 << 20, 4 << 20)


@pytest.mark.parametrize("dtype,D,ptrs,route", [
    *[(torch.bfloat16, D, _ALIGNED, ("mma", 16))
      for D in (32, 64, 80, 128, 16, 40, 96, 112)],
    *[(torch.float32, D, _ALIGNED, ("tf32x3", 16)) for D in (32, 80, 128)],
    *[(torch.bfloat16, D, _ALIGNED, ("mma", w))
      for D, w in ((1, 2), (20, 4), (127, 2))],
    *[(torch.bfloat16, 80, tuple(p + 2 * (i == at) for i, p in
                                 enumerate(_ALIGNED)), ("mma", w))
      for at, w in enumerate((4, 2, 2, 4))],
    (torch.bfloat16, 64, tuple(p + 8 for p in _ALIGNED), ("mma", 4)),
    *[(torch.float32, D, _ALIGNED, ("tf32x3", w))
      for D, w in ((1, 4), (20, 16), (127, 4))],
    *[(torch.float32, 80, tuple(p + 4 * (i == at) for i, p in
                                enumerate(_ALIGNED)), ("tf32x3", w))
      for at, w in enumerate((4, 4, 4, 4))],
    (torch.float32, 64, tuple(p + 8 for p in _ALIGNED), ("tf32x3", 4)),
], ids=["bf16_d32", "bf16_d64", "bf16_d80", "bf16_d128", "bf16_d16",
        "bf16_d40", "bf16_d96", "bf16_d112", "f32_d32",
        "f32_d80", "f32_d128", "bf16_d1", "bf16_d20", "bf16_d127",
        "q_unaligned", "k_unaligned", "v_unaligned", "o_unaligned",
        "all_8_byte_aligned", "f32_d1", "f32_d20", "f32_d127",
        "f32_q_unaligned", "f32_k_unaligned", "f32_v_unaligned",
        "f32_o_unaligned", "f32_all_8_byte_aligned"])
def test_route_by_dtype_head_size_and_alignment(dtype, D, ptrs, route):
    assert fa_ops._route(dtype, D, ptrs) == route


def test_cpu_call_launches_neither_route():
    before = (fa_ops.launches, fa_ops.launches_mma, fa_ops.launches_tf32x3)
    for dtype in ("bfloat16", "float32"):
        _, tx = _both(_inputs(5, 1, 4, 2, 33, 80), dtype)
        fa_ops.flash_attention(*tx)
    assert (fa_ops.launches, fa_ops.launches_mma,
            fa_ops.launches_tf32x3) == before
