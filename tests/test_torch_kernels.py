"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the port's kernel wrappers run their plain PyTorch versions (a
CUDA kernel has no interpret mode); the Pallas kernels run in interpret mode,
as the JAX package's own tests run them.  The CUDA kernels themselves are
held against the same plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Inputs come from seeded numpy generators.
"""
import ctypes
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import inversion as jinversion
from repro.kernels.kl_mutual import ops as jkl_ops
from repro.kernels.kl_mutual.kl_mutual import kl_rows_pallas
from repro.kernels.ridge_gram import ops as jrg_ops
from repro.kernels.ridge_gram.ridge_gram import gram_pallas
from repro_torch.configs.splitme_dnn import DNNConfig
from repro_torch.core import dnn, inversion
from repro_torch.kernels import build, dispatch
from repro_torch.kernels.kl_mutual import ops as kl_ops
from repro_torch.kernels.kl_mutual.ref import kl_grad_ref, kl_rows_ref
from repro_torch.kernels.ridge_gram import ops as rg_ops
from repro_torch.kernels.ridge_gram.ref import gram_ref


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# kl_mutual
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,bq", [(96, 256, 32), (40, 37, 8), (8, 3, 8)])
@pytest.mark.parametrize("temp", [1.0, 2.0])
def test_kl_rows_plain_matches_pallas_interpret(n, d, bq, temp):
    x, y = _normal(0, (n, d), 3.0), _normal(1, (n, d), 3.0)
    # the JAX result is fetched before torch runs: with JAX's asynchronous
    # dispatch still computing beside it, after a JAX campaign in the same
    # process, torch's CPU threads now and then returned one thread's block
    # of rows ~6e-4 off (an f64 evaluation puts the JAX side at 3.5e-6)
    want = np.asarray(kl_rows_pallas(jnp.asarray(x), jnp.asarray(y),
                                     temperature=temp, bq=bq,
                                     interpret=True))
    got = kl_rows_ref(torch.from_numpy(x), torch.from_numpy(y), temp)
    # atol 1e-6 plus 1e-6 relative: rows reach KL ≈ 12 at T = 1, where one
    # f32 ulp is already 1e-6
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the CPU wrapper is the plain version
    np.testing.assert_array_equal(
        kl_ops.kl_rows(torch.from_numpy(x), torch.from_numpy(y), temp).numpy(),
        got.numpy())


@pytest.mark.parametrize("n,d", [(32, 256), (17, 33)])
@pytest.mark.parametrize("temp", [1.0, 2.0])
def test_kl_autograd_function_grad_matches_jax(n, d, temp):
    """The port's autograd.Function (closed-form backward) vs jax.grad of
    repro.kernels.kl_mutual.ops.kl_loss (custom_vjp over the Pallas kernel,
    interpret mode on the CPU); y gets no gradient."""
    x, y = _normal(2, (n, d), 2.0), _normal(3, (n, d), 2.0)
    jy = jnp.asarray(y)
    jval, jgx = jax.value_and_grad(
        lambda a: jkl_ops.kl_loss(a, jy, temperature=temp))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    loss = dispatch.kl_loss(tx, ty, temperature=temp, policy="kernel")
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=1e-6)
    assert ty.grad is None


def test_kl_loss_policies_agree_per_client():
    """(M, B, d) stacked cohort: per-client means, kernel path (one call
    over all M·B rows) == plain path, values and gradients."""
    x, y = _normal(4, (5, 8, 24), 2.0), _normal(5, (5, 8, 24), 2.0)
    out = {}
    for pol in ("kernel", "reference"):
        tx = torch.from_numpy(x).requires_grad_(True)
        loss = dispatch.kl_loss(tx, torch.from_numpy(y), temperature=2.0,
                                policy=pol)
        assert loss.shape == (5,)
        loss.sum().backward()
        out[pol] = (loss.detach().numpy(), tx.grad.numpy())
    np.testing.assert_allclose(out["kernel"][0], out["reference"][0],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["kernel"][1], out["reference"][1],
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("shape", [(50, 32, 256), (7, 3)])
@pytest.mark.parametrize("temp", [1.0, 2.0])
def test_kl_grad_ref_matches_jax_grad(shape, temp):
    """The plain closed-form gradient (the backward kernel's plain version)
    against jax.grad of repro.kernels.kl_mutual.ops.kl_loss, whose forward
    runs the Pallas kernel in interpret mode on the CPU: per client m a
    weight w_m times the mean over its B rows, so g = w_m / B per row."""
    x, y = _normal(18, shape, 2.0), _normal(19, shape, 2.0)
    x3, y3 = x.reshape(-1, *shape[-2:]), y.reshape(-1, *shape[-2:])
    w = np.random.default_rng(20).uniform(0.5, 2.0, len(x3)).astype(
        np.float32)
    jy = jnp.asarray(y3)

    def loss(a):
        per = jax.vmap(lambda xm, ym: jkl_ops.kl_loss(
            xm, ym, temperature=temp))(a, jy)
        return jnp.sum(jnp.asarray(w) * per)
    want = np.asarray(jax.grad(loss)(jnp.asarray(x3))).reshape(shape)
    B, d = shape[-2:]
    g = torch.from_numpy(np.repeat(w / B, B))
    got = kl_grad_ref(torch.from_numpy(x.reshape(-1, d)),
                      torch.from_numpy(y.reshape(-1, d)), g, temp)
    np.testing.assert_allclose(got.numpy().reshape(shape), want, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("g_kind", ["mean", "stride_0"])
def test_kl_backward_on_cpu_is_the_plain_gradient(g_kind):
    """KLRows.backward on CPU tensors returns kl_grad_ref's gradient exactly
    and launches neither kernel: g from the cohort mean of dispatch.kl_loss,
    or one value at stride 0 from a sum over the rows."""
    x, y = _normal(21, (5, 8, 24), 2.0), _normal(22, (5, 8, 24), 2.0)
    before = kl_ops.launches, kl_ops.launches_bwd
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y)
    if g_kind == "mean":
        dispatch.kl_loss(tx, ty, temperature=2.0).sum().backward()
        g = torch.full((40,), 1.0 / 8)
    else:
        kl_ops.KLRows.apply(tx.reshape(40, 24), ty.reshape(40, 24),
                            2.0).sum().backward()
        g = torch.ones(1).expand(40)
    want = kl_grad_ref(torch.from_numpy(x).reshape(40, 24),
                       ty.reshape(40, 24), g, 2.0)
    np.testing.assert_array_equal(tx.grad.reshape(40, 24).numpy(),
                                  want.numpy())
    assert (kl_ops.launches, kl_ops.launches_bwd) == before


@pytest.mark.parametrize("bad", ["g_shape", "g_dtype", "g_device"])
def test_kl_grad_wrapper_rejects_a_bad_g(bad):
    x = y = torch.zeros(8, 6)
    g = torch.zeros(8)
    if bad == "g_shape":
        g = torch.zeros(8, 1)
    elif bad == "g_dtype":
        g = g.double()
    else:
        g = g.to("meta")
    with pytest.raises(ValueError):
        kl_ops.kl_grad(x, y, g, 1.0)


def test_kl_paper_matches_jax():
    from repro.core import mutual as jmutual
    from repro_torch.core import mutual
    x, y = _normal(6, (16, 20)), _normal(7, (16, 20))
    want = jmutual.kl_paper(jnp.asarray(x), jnp.asarray(y), 2.0)
    got = mutual.kl_paper(torch.from_numpy(x), torch.from_numpy(y), 2.0)
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        mutual.client_loss(torch.from_numpy(x), torch.from_numpy(y)).item(),
        float(jmutual.client_loss(jnp.asarray(x), jnp.asarray(y))), atol=1e-6)
    np.testing.assert_allclose(
        mutual.server_loss(torch.from_numpy(y), torch.from_numpy(x)).item(),
        float(jmutual.server_loss(jnp.asarray(y), jnp.asarray(x))), atol=1e-6)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "rank"])
def test_kl_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros(8, 6)
    y = torch.zeros(8, 6)
    if bad == "dtype":
        x = x.double()
    elif bad == "shape":
        y = torch.zeros(8, 5)
    elif bad == "contiguous":
        x = torch.zeros(6, 8).T
    else:
        x, y = torch.zeros(2, 4, 6), torch.zeros(2, 4, 6)
    with pytest.raises((TypeError, ValueError)):
        kl_ops.kl_rows(x, y, 1.0)


# ---------------------------------------------------------------------------
# ridge_gram
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d1,d2", [(100, 257, 3), (33, 7, 17),
                                     (777, 45, 19), (200, 65, 64)])
def test_gram_plain_matches_pallas_interpret(n, d1, d2):
    x, y = _normal(8, (n, d1)), _normal(9, (n, d2))
    # gram_pallas takes block multiples; the JAX wrapper pads to them
    want = jrg_ops.gram(jnp.asarray(x), jnp.asarray(y))
    got = gram_ref(torch.from_numpy(x), torch.from_numpy(y))
    scale = np.abs(x).T @ np.abs(y)         # f32 summation-error scale
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * scale.max())
    np.testing.assert_array_equal(
        rg_ops.gram(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        got.numpy())


def test_gram_plain_matches_gram_pallas_direct():
    """gram_pallas itself (interpret mode) on block-multiple shapes."""
    x, y = _normal(10, (256, 128)), _normal(11, (256, 128))
    want = gram_pallas(jnp.asarray(x), jnp.asarray(y), bm=128, bn=128,
                       bk=128, interpret=True)
    got = gram_ref(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("n,d1,d2", [(100, 257, 128), (777, 17, 3),
                                     (33, 65, 64), (1, 1, 1)])
def test_gram_pair_plain_matches_jax_inversion_gram(n, d1, d2):
    """The port's (OᵀO, OᵀZ) against the JAX inversion's ``_gram`` with its
    kernel policy, which runs the Pallas kernel in interpret mode."""
    o, z = _normal(14, (n, d1)), _normal(15, (n, d2))
    want = jinversion._gram(jnp.asarray(o), jnp.asarray(z), "kernel")
    to, tz = torch.from_numpy(o), torch.from_numpy(z)
    before = rg_ops.launches
    got = rg_ops.gram_pair(to, tz)
    assert rg_ops.launches == before        # the CPU runs no kernel
    for g, w, y in zip(got, want, (o, z)):
        scale = (np.abs(o).T @ np.abs(y)).max()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * scale)
    for pol in ("kernel", "reference"):
        for g, w in zip(dispatch.gram_pair(to, tz, policy=pol), got):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
    got_inv = inversion._gram(to, tz)
    for g, w in zip(got_inv, got):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_inversion_through_gram_pair_is_unchanged_on_cpu():
    """invert_inverse_model, whose layers now take both Grams from one
    gram_pair call, gives on the CPU exactly the weights of the same
    inversion with one gram call per Gram."""
    cfg = DNNConfig(hidden=(24, 16, 16, 8))
    gen = torch.Generator().manual_seed(0)
    inv = dnn.init_inverse_server(gen, cfg, "cpu")
    smashed = torch.from_numpy(_normal(16, (200, cfg.layer_dims[
        cfg.split_index])))
    labels = torch.nn.functional.one_hot(
        torch.from_numpy(np.random.default_rng(17).integers(0, 3, 200)),
        3).float()
    got = inversion.invert_inverse_model(inv, smashed, labels, cfg,
                                         gamma=1.0)
    # the same walk with two separate Gram calls
    acts = dnn.mlp_activations(inv, labels, cfg.activation)
    L = len(inv)
    targets = [acts[L - 1 - l] for l in range(1, L)] + [labels]
    o = smashed
    for l, (z, layer) in enumerate(zip(targets, got)):
        oa = inversion._augment(o)
        a0, a1 = dispatch.gram(oa, oa), dispatch.gram(oa, z)
        w_aug = inversion.ridge_solve(a0, a1, 1.0)
        np.testing.assert_array_equal(layer["w"].numpy(),
                                      w_aug[:-1].numpy())
        np.testing.assert_array_equal(layer["b"].numpy(), w_aug[-1].numpy())
        o = o @ layer["w"] + layer["b"]
        if l < L - 1:
            o = torch.relu(o)


@pytest.mark.parametrize("n,d1,d2,sms", [
    (4800, 257, 257, 132), (4800, 17, 3, 132), (777, 45, 19, 132),
    (31, 5, 5, 132), (4800, 129, 64, 1)])
def test_gram_split_plan_covers_n(n, d1, d2, sms):
    splits, rows = rg_ops.split_plan(n, d1, d2, sms)
    assert rows % rg_ops.CHUNK == 0
    assert splits * rows >= n > (splits - 1) * rows
    tiles = -(-d1 // rg_ops.TILE) * -(-d2 // rg_ops.TILE)
    assert splits == 1 or tiles * splits <= 2 * rg_ops.BLOCKS_PER_SM * sms
    assert splits == 1 or rows >= rg_ops.MIN_CHUNKS * rg_ops.CHUNK


# as gram_pair's launch calls it: rows = d1, cols = d1 + d2, and OᵀO
# symmetric, its tiles below the diagonal left out of the grid
@pytest.mark.parametrize("n,d1,cols,sms", [
    (4800, 257, 385, 132), (4800, 17, 20, 132), (4800, 129, 193, 132),
    (777, 45, 64, 132), (4800, 257, 385, 1)])
def test_gram_split_plan_fills_one_wave_of_the_pair_grid(n, d1, cols, sms):
    splits, rows = rg_ops.split_plan(n, d1, cols, sms, True)
    assert rows % rg_ops.CHUNK == 0
    assert splits * rows >= n > (splits - 1) * rows
    t, c = -(-d1 // rg_ops.TILE), -(-cols // rg_ops.TILE)
    blocks = t * c - t * (t - 1) // 2      # the tiles the kernel computes
    if blocks <= rg_ops.BLOCKS_PER_SM * sms:
        assert splits * blocks <= rg_ops.BLOCKS_PER_SM * sms
    else:
        assert splits == 1
    assert splits == 1 or rows >= rg_ops.MIN_CHUNKS * rg_ops.CHUNK


@pytest.mark.parametrize("bad", ["dtype", "rows", "contiguous", "empty"])
def test_gram_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, y = torch.zeros(10, 4), torch.zeros(10, 3)
    if bad == "dtype":
        y = y.half()
    elif bad == "rows":
        y = torch.zeros(9, 3)
    elif bad == "contiguous":
        x = torch.zeros(4, 10).T
    else:
        x, y = torch.zeros(0, 4), torch.zeros(0, 3)
    with pytest.raises((TypeError, ValueError)):
        rg_ops.gram(x, y)


# ---------------------------------------------------------------------------
# dispatch + build
# ---------------------------------------------------------------------------

def test_policy_presets_and_later_slices():
    """The presets, as the reference's: "kernel_bf16" is a bf16 request,
    bf16 on a CUDA device and f32 on the CPU; an explicit BF16 precision
    is bf16 on any device."""
    assert dispatch.get_policy(None) == dispatch.KERNEL
    assert dispatch.get_policy("reference") == dispatch.REFERENCE
    assert dispatch.get_policy("kernel").kl_mutual is True
    assert dispatch.policy_names() == ("reference", "kernel", "kernel_bf16")
    req = dispatch.get_policy("kernel_bf16")
    assert req.auto_precision and req.kl_mutual and req.ridge_gram
    assert req.resolved("cpu") == dispatch.KERNEL
    assert req.resolved("cuda").precision == dispatch.BF16
    assert not req.resolved("cuda").auto_precision
    assert (req.resolved().precision.is_mixed
            is torch.cuda.is_available())
    forced = dispatch.KernelPolicy(precision=dispatch.BF16)
    assert forced.resolved("cpu") is forced
    assert dispatch.BF16.compute_dtype == torch.bfloat16
    assert dispatch.BF16.accum_dtype == torch.float32
    assert not dispatch.F32.is_mixed and dispatch.BF16.is_mixed
    with pytest.raises(KeyError):
        dispatch.get_policy("tpu")


def test_gram_dispatch_policies_agree():
    x, y = _normal(12, (50, 9)), _normal(13, (50, 4))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_array_equal(
        dispatch.gram(tx, ty, policy="kernel").numpy(),
        dispatch.gram(tx, ty, policy="reference").numpy())


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").rglob("*.so"))


def test_build_root_is_the_checkout_or_a_user_cache(monkeypatch, tmp_path):
    root = pathlib.Path(__file__).resolve().parents[1]
    assert build.BUILD_ROOT == root / "build" / "repro_torch"
    installed = tmp_path / "lib" / "site-packages" / "repro_torch"
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert build._build_root(installed) == tmp_path / "cache" / "repro_torch"
    monkeypatch.delenv("XDG_CACHE_HOME")
    assert build._build_root(installed) == (pathlib.Path.home() / ".cache"
                                            / "repro_torch")


def test_build_digest_covers_the_shared_header(monkeypatch, tmp_path):
    """tf32x3.cuh is compiled only through the sources that include it, and
    an edit to it changes the digest (so the library is rebuilt)."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in build.CSRC.iterdir():
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    assert "tf32x3.cuh" not in {p.name for p in build.sources()}
    before = build.digest()
    with open(csrc / "tf32x3.cuh", "a") as f:
        f.write("// edited\n")
    assert build.digest() != before


def test_build_digest_covers_every_source():
    names = {p.name for p in build.sources()}
    assert {"kl_mutual.cu", "ridge_gram.cu", "flash_attention_tf32.cu"} \
        <= names
    assert len(build.digest()) == 16
    # the C entries pass pointers and the stream as 64-bit c_void_p
    assert kl_ops._ARGTYPES.count(ctypes.c_void_p) == 4
    assert kl_ops._BWD_ARGTYPES.count(ctypes.c_void_p) == 5
    assert kl_ops._BWD_ARGTYPES[3] == ctypes.c_int64    # g's stride
    assert rg_ops._ARGTYPES.count(ctypes.c_void_p) == 8
