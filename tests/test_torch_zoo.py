"""The port's model-zoo serving slice against the JAX package: the WKV and
SSD kernels' plain versions, the RWKV6 / Mamba2 / attention modules, the
RWKV6 and Zamba2 facades (forward, decode replay, prefill), the parameter
converter, the configs and the serve driver.

On the CPU the port's kernel wrappers run their plain PyTorch versions (a
CUDA kernel has no interpret mode); the Pallas kernels run in interpret
mode, as the JAX package's own tests run them.  Everything is float32 at
reduced widths; weights are the JAX package's, carried across with
``convert.model_params_from_numpy``; inputs come from seeded numpy
generators.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.kernels.mamba2_scan import ops as jssd_ops
from repro.kernels.rwkv6_wkv import ops as jwkv_ops
from repro.models import attention as jattn
from repro.models import mamba2 as jmamba2
from repro.models import rwkv6 as jrwkv6
from repro.models.transformer import build_model as jax_build_model
from repro.runtime.steps import make_prefill_step as jax_prefill_step
from repro_torch.configs.base import get_config, list_configs
from repro_torch.convert import model_params_from_numpy, model_params_to_numpy
from repro_torch.kernels import dispatch
from repro_torch.kernels.mamba2_scan import ops as ssd_ops
from repro_torch.kernels.mamba2_scan.ref import mamba2_scan_ref
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.kernels.rwkv6_wkv.ref import rwkv6_wkv_ref
from repro_torch.models import attention, mamba2, rwkv6
from repro_torch.models.transformer import build_model
from repro_torch.runtime.steps import make_prefill_step, make_serve_step

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("rwkv6-1.6b", "zamba2-2.7b")
# every zoo config the serve CLI takes (the DNN alias is not a zoo model)
ZOO_ARCHS = tuple(a for a in list_configs() if a != "splitme-dnn10")
MODULE_TOL = 1e-5      # f32 module parity
MODEL_TOL = 1e-4       # f32 whole-model parity (2 layers, logits of O(1))


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(seed, shape, scale=1.0):
    return (_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _sigmoid(a):
    return (1.0 / (1.0 + np.exp(-a))).astype(np.float32)


def _softplus(a):
    return np.logaddexp(a, 0.0).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), jax.device_get(tree))


def _torch_tree(tree):
    """A JAX param dict with numpy leaves -> the same dict of CPU tensors
    (the port's functional modules index dicts and modules alike)."""
    return jax.tree.map(lambda a: _t(np.asarray(a)), tree)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# kernels: plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _wkv_inputs(seed, b, L, nh, P):
    r, k, v = (_normal(seed + i, (b, L, nh, P)) for i in range(3))
    w = _sigmoid(_normal(seed + 3, (b, L, nh, P)))
    u = _normal(seed + 4, (nh, P))
    return r, k, v, w, u


def _ssd_inputs(seed, b, L, nh, N, P, decay=None):
    if decay is None:
        decay = _sigmoid(_normal(seed, (b, L, nh))) * 0.6 + 0.35
    dt = _softplus(_normal(seed + 1, (b, L, nh)))
    B = _normal(seed + 2, (b, L, N))
    C = _normal(seed + 3, (b, L, N))
    x = _normal(seed + 4, (b, L, nh, P))
    return decay.astype(np.float32), dt, B, C, x


@pytest.mark.parametrize("b,L,nh,P,chunk", [(2, 64, 2, 16, 32),
                                            (1, 100, 3, 32, 64),
                                            (1, 16, 1, 64, 16)])
def test_wkv_plain_matches_pallas_interpret(b, L, nh, P, chunk):
    args = _wkv_inputs(0, b, L, nh, P)
    want = jwkv_ops.rwkv6_wkv(*map(jnp.asarray, args), chunk=chunk)
    got = rwkv6_wkv_ref(*map(_t, args))
    _close(got, want, 1e-4)      # the JAX package's bound for the WKV kernel
    # the CPU wrapper and the kernel preset are the plain version
    before = wkv_ops.launches
    np.testing.assert_array_equal(wkv_ops.rwkv6_wkv(*map(_t, args)).numpy(),
                                  got.numpy())
    np.testing.assert_array_equal(
        dispatch.rwkv6_wkv(*map(_t, args), policy="kernel").numpy(),
        got.numpy())
    assert wkv_ops.launches == before


@pytest.mark.parametrize("b,L,nh,N,P,chunk,strong", [
    (2, 64, 3, 16, 32, 32, False), (1, 200, 2, 8, 16, 64, False),
    (1, 32, 1, 64, 64, 8, False), (1, 128, 2, 8, 16, 64, True)])
def test_ssd_plain_matches_pallas_interpret(b, L, nh, N, P, chunk, strong):
    decay = np.full((b, L, nh), 1e-4, np.float32) if strong else None
    args = _ssd_inputs(1, b, L, nh, N, P, decay)
    want = jssd_ops.mamba2_scan(*map(jnp.asarray, args), chunk=chunk)
    got = mamba2_scan_ref(*map(_t, args))
    assert torch.isfinite(got).all()
    _close(got, want, 1e-3)      # the JAX package's bound for the SSD kernel
    before = ssd_ops.launches
    np.testing.assert_array_equal(ssd_ops.mamba2_scan(*map(_t, args)).numpy(),
                                  got.numpy())
    np.testing.assert_array_equal(
        dispatch.mamba2_scan(*map(_t, args), policy="kernel").numpy(),
        got.numpy())
    assert ssd_ops.launches == before


def test_plain_versions_take_an_empty_sequence():
    r, k, v, w, u = map(_t, _wkv_inputs(2, 2, 0, 3, 8))
    assert rwkv6_wkv_ref(r, k, v, w, u).shape == (2, 0, 3, 8)
    args = map(_t, _ssd_inputs(2, 2, 0, 3, 4, 8))
    assert mamba2_scan_ref(*args).shape == (2, 0, 3, 8)


def _wkv_cases():
    ok = lambda: list(map(_t, _wkv_inputs(3, 1, 4, 2, 8)))

    def edit(i, f):
        a = ok()
        a[i] = f(a[i])
        return a
    return [
        ("shape", edit(1, lambda t: t[:, :3]), ValueError),
        ("u shape", edit(4, lambda t: t[:1]), ValueError),
        ("dtype", edit(0, lambda t: t.double()), TypeError),
        ("strided", edit(2, lambda t: t.transpose(2, 3).contiguous()
                         .transpose(2, 3)), ValueError),
        ("P > 128", list(map(_t, _wkv_inputs(3, 1, 2, 1, 129))), ValueError),
        ("grad", edit(0, lambda t: t.requires_grad_(True)), RuntimeError),
        ("meta", [t.to("meta") for t in ok()], ValueError),
    ]


def _ssd_cases():
    ok = lambda: list(map(_t, _ssd_inputs(4, 1, 4, 2, 8, 8)))

    def edit(i, f):
        a = ok()
        a[i] = f(a[i])
        return a
    return [
        ("shape", edit(2, lambda t: t[:, :, :4]), ValueError),
        ("x rank", edit(4, lambda t: t[..., 0]), ValueError),
        ("dtype", edit(1, lambda t: t.half()), TypeError),
        ("strided", edit(4, lambda t: t.transpose(2, 3).contiguous()
                         .transpose(2, 3)), ValueError),
        ("N > 128", list(map(_t, _ssd_inputs(4, 1, 2, 1, 129, 8))),
         ValueError),
        ("grad", edit(4, lambda t: t.requires_grad_(True)), RuntimeError),
        ("meta", [t.to("meta") for t in ok()], ValueError),
    ]


@pytest.mark.parametrize("case", _wkv_cases(), ids=lambda c: c[0])
def test_wkv_wrapper_rejects_bad_inputs(case):
    _, args, err = case
    with pytest.raises(err):
        wkv_ops.rwkv6_wkv(*args)


@pytest.mark.parametrize("case", _ssd_cases(), ids=lambda c: c[0])
def test_ssd_wrapper_rejects_bad_inputs(case):
    _, args, err = case
    with pytest.raises(err):
        ssd_ops.mamba2_scan(*args)


def test_dispatch_presets_and_strided_operands():
    """``reference`` and ``kernel`` compute the same function; dispatch
    hands the wrapper contiguous operands (the model's B and C are strided
    slices of the conv output)."""
    assert not dispatch.get_policy("reference").rwkv6_wkv
    assert not dispatch.get_policy("reference").mamba2_scan
    assert dispatch.get_policy(None).rwkv6_wkv
    assert dispatch.get_policy("kernel").mamba2_scan
    decay, dt, B, C, x = map(_t, _ssd_inputs(5, 2, 9, 3, 4, 8))
    BC = torch.cat([B, C], -1)
    Bs, Cs = BC[..., :4], BC[..., 4:]
    assert not Bs.is_contiguous()
    got = dispatch.mamba2_scan(decay, dt, Bs, Cs, x, policy="kernel")
    want = dispatch.mamba2_scan(decay, dt, B, C, x, policy="reference")
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_common_blocks_match_jax():
    """Norms (computed in f32, cast back to the input dtype), RoPE,
    softplus (``logaddexp(x, 0)`` also above 20, where torch's softplus
    switches to x) and both FFNs."""
    from repro.models import common as jc
    from repro_torch.models import common as tc
    x = _normal(60, (2, 5, 3, 64), 3.0)
    s, bias = _normal(61, (64,)), _normal(62, (64,))
    _close(tc.rms_norm(_t(x), _t(s)), jc.rms_norm(jnp.asarray(x),
                                                    jnp.asarray(s)), 1e-6)
    _close(tc.layer_norm(_t(x), _t(s), _t(bias)),
           jc.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(bias)),
           1e-6)
    xb = _t(x).to(torch.bfloat16)
    assert tc.rms_norm(xb, _t(s)).dtype == torch.bfloat16
    assert tc.layer_norm(xb, _t(s), _t(bias)).dtype == torch.bfloat16
    pos = np.arange(5)[None] + 7
    _close(tc.apply_rope(_t(x), _t(pos), 1e4),
           jc.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4), 1e-5)
    z = np.linspace(-30, 30, 41, dtype=np.float32)
    _close(tc.softplus(_t(z)), jax.nn.softplus(jnp.asarray(z)), 1e-6)
    for act in ("swiglu", "squared_relu"):
        p = _np_tree(jc.init_ffn(jax.random.PRNGKey(3), 64, 96, act,
                                 jnp.float32))
        h = _normal(63, (2, 5, 64))
        _close(tc.apply_ffn(_torch_tree(p), _t(h), act),
               jc.apply_ffn(p, jnp.asarray(h), act), MODULE_TOL)
    with pytest.raises(ValueError):
        tc.activation_fn("swiglu")


@pytest.fixture(scope="module")
def rwkv_cfg():
    return get_config("rwkv6-1.6b").reduced(), \
        jax_get_config("rwkv6-1.6b").reduced()


@pytest.fixture(scope="module")
def zamba_cfg():
    return get_config("zamba2-2.7b").reduced(), \
        jax_get_config("zamba2-2.7b").reduced()


def _rwkv_params(jcfg, seed=0):
    p = jrwkv6.init_rwkv6(jax.random.PRNGKey(seed), jcfg.d_model, jcfg.d_ff,
                          jcfg.ssm, jnp.float32)
    # the JAX init leaves u = 0 and all mixes at 0.5: perturb them so the
    # bonus term and the token shift are exercised
    p["u"] = jnp.asarray(_normal(seed + 10, p["u"].shape))
    p["mu"] = jnp.asarray(_rng(seed + 11).uniform(size=p["mu"].shape)
                          .astype(np.float32))
    return _np_tree(p)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_rwkv6_time_mix_matches_jax(rwkv_cfg, use_kernel):
    cfg, jcfg = rwkv_cfg
    p = _rwkv_params(jcfg)
    x = _normal(20, (2, 24, cfg.d_model))
    x0 = _normal(21, (2, cfg.d_model))
    want = jrwkv6.rwkv6_time_mix(p, jnp.asarray(x), jcfg.ssm, jnp.asarray(x0),
                                 use_kernel=use_kernel)
    for policy in ("kernel", "reference"):
        got = rwkv6.rwkv6_time_mix(_torch_tree(p), _t(x), cfg.ssm, _t(x0),
                                   policy=policy)
        _close(got, want, MODULE_TOL)


def test_rwkv6_channel_mix_matches_jax(rwkv_cfg):
    cfg, jcfg = rwkv_cfg
    p = _rwkv_params(jcfg, 1)
    x = _normal(22, (2, 16, cfg.d_model))
    for x0 in (None, _normal(23, (2, cfg.d_model))):
        want = jrwkv6.rwkv6_channel_mix(
            p, jnp.asarray(x), None if x0 is None else jnp.asarray(x0))
        got = rwkv6.rwkv6_channel_mix(_torch_tree(p), _t(x),
                                      None if x0 is None else _t(x0))
        _close(got, want, MODULE_TOL)


def test_rwkv6_steps_match_jax(rwkv_cfg):
    cfg, jcfg = rwkv_cfg
    p = _rwkv_params(jcfg, 2)
    tp = _torch_tree(p)
    jc = jrwkv6.init_rwkv_cache(2, jcfg.d_model, jcfg.ssm, jnp.float32)
    tc = rwkv6.init_rwkv_cache(2, cfg.d_model, cfg.ssm, torch.float32)
    xs = _normal(24, (2, 6, cfg.d_model))
    for t in range(xs.shape[1]):
        x = xs[:, t:t + 1]
        jy, jc = jrwkv6.rwkv6_step(p, jnp.asarray(x), jc, jcfg.ssm)
        jy2, jc = jrwkv6.rwkv6_channel_step(p, jnp.asarray(x), jc)
        ty, tc = rwkv6.rwkv6_step(tp, _t(x), tc, cfg.ssm)
        ty2, tc = rwkv6.rwkv6_channel_step(tp, _t(x), tc)
        _close(ty, jy, MODULE_TOL)
        _close(ty2, jy2, MODULE_TOL)
    for got, want in zip(tc, jc):
        _close(got, want, MODULE_TOL)


def _mamba_params(jcfg, seed=0):
    p = jmamba2.init_mamba2(jax.random.PRNGKey(seed), jcfg.d_model, jcfg.ssm,
                            jnp.float32)
    nh = p["A_log"].shape[0]
    # non-trivial A, D and dt bias (the JAX init has 0, 1 and 0)
    p["A_log"] = jnp.asarray(_normal(seed + 10, (nh,), 0.5))
    p["D"] = jnp.asarray(_normal(seed + 11, (nh,)))
    p["dt_bias"] = jnp.asarray(_normal(seed + 12, (nh,), 0.5))
    p["conv_b"] = jnp.asarray(_normal(seed + 13, p["conv_b"].shape, 0.1))
    return _np_tree(p)


@pytest.mark.parametrize("use_kernel,tol", [(False, MODULE_TOL),
                                            (True, 2e-3)])
def test_mamba2_forward_matches_jax(zamba_cfg, use_kernel, tol):
    """Against JAX's scan path at the f32 module bound, and against its
    chunked Pallas path at the JAX package's own bound between the two
    (tests/test_kernels.py::test_model_paths_use_kernels_consistently)."""
    cfg, jcfg = zamba_cfg
    p = _mamba_params(jcfg)
    x = _normal(30, (2, 24, cfg.d_model))
    want = jmamba2.mamba2_forward(p, jnp.asarray(x), jcfg.ssm,
                                  use_kernel=use_kernel)
    for policy in ("kernel", "reference"):
        got = mamba2.mamba2_forward(_torch_tree(p), _t(x), cfg.ssm,
                                    policy=policy)
        _close(got, want, tol)


def test_mamba2_steps_match_jax(zamba_cfg):
    cfg, jcfg = zamba_cfg
    p = _mamba_params(jcfg, 1)
    tp = _torch_tree(p)
    jc = jmamba2.init_mamba_cache(2, jcfg.d_model, jcfg.ssm, jnp.float32)
    tc = mamba2.init_mamba_cache(2, cfg.d_model, cfg.ssm, torch.float32)
    xs = _normal(31, (2, 7, cfg.d_model))
    for t in range(xs.shape[1]):
        jy, jc = jmamba2.mamba2_step(p, jnp.asarray(xs[:, t:t + 1]), jc,
                                     jcfg.ssm)
        ty, tc = mamba2.mamba2_step(tp, _t(xs[:, t:t + 1]), tc, cfg.ssm)
        _close(ty, jy, MODULE_TOL)
    _close(tc.conv, jc.conv, MODULE_TOL)
    _close(tc.ssm, jc.ssm, MODULE_TOL)


def _attn_params(cfg, seed=0, qk_norm=False):
    return _np_tree(jattn.init_attention(
        jax.random.PRNGKey(seed), cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
        cfg.resolved_head_dim, qk_norm, jnp.float32))


def _attn_kw(cfg, qk_norm=False):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, theta=cfg.rope_theta,
                qk_norm=qk_norm)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("gqa", [False, True])
def test_attention_matches_jax(zamba_cfg, window, gqa):
    cfg, jcfg = zamba_cfg
    if gqa:      # 4 query heads on 2 KV heads, with qk-norm
        cfg = dataclasses.replace(cfg, n_kv_heads=2)
        jcfg = dataclasses.replace(jcfg, n_kv_heads=2)
    p = _attn_params(jcfg, 3, qk_norm=gqa)
    x = _normal(40, (2, 12, cfg.d_model))
    want = jattn.attention(p, jnp.asarray(x), window=window,
                           **_attn_kw(jcfg, gqa))
    got = attention.attention(_torch_tree(p), _t(x), window=window,
                              **_attn_kw(cfg, gqa))
    _close(got, want, MODULE_TOL)


@pytest.mark.parametrize("window", [None, 3])
def test_decode_attention_ring_buffer_wrap_matches_jax(zamba_cfg, window):
    """A 4-slot ring buffer driven for 9 steps (two wraps), positions from
    the cache (the default) and given explicitly."""
    cfg, jcfg = zamba_cfg
    p = _attn_params(jcfg, 4)
    tp = _torch_tree(p)
    W, b = 4, 2
    jc = jattn.init_kv_cache(b, W, jcfg.n_kv_heads, jcfg.resolved_head_dim,
                             jnp.float32, prefill_len=2)
    tc = attention.init_kv_cache(b, W, cfg.n_kv_heads, cfg.resolved_head_dim,
                                 torch.float32, prefill_len=2)
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    xs = _normal(41, (b, 9, cfg.d_model))
    for t in range(xs.shape[1]):
        position = None if t % 2 else 2 + t
        jy, jc = jattn.decode_attention(
            p, jnp.asarray(xs[:, t:t + 1]), jc, window=window,
            position=None if position is None else jnp.asarray(position),
            **_attn_kw(jcfg))
        ty, tc = attention.decode_attention(
            tp, _t(xs[:, t:t + 1]), tc, window=window, position=position,
            **_attn_kw(cfg))
        _close(ty, jy, MODULE_TOL)
        np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
        assert tc.index == int(jc.index)
        assert tc.last == int(jnp.max(jc.pos))
    _close(tc.k, jc.k, MODULE_TOL)
    _close(tc.v, jc.v, MODULE_TOL)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def _models(arch, seed=0, **kw):
    """The JAX reduced model with its params, and the port's model holding
    the same weights."""
    jcfg = jax_get_config(arch).reduced()
    jm = jax_build_model(jcfg, remat=False, **kw)
    params = jm.init(jax.random.PRNGKey(seed))
    if arch == "rwkv6-1.6b":     # exercise the bonus term
        u = params["layers"]["tm"]["u"]
        params["layers"]["tm"]["u"] = jnp.asarray(_normal(seed, u.shape))
    tree = _np_tree(params)
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu", **kw)
    model.load_state_dict(model_params_from_numpy(cfg, tree, device="cpu"))
    return jm, params, model


@pytest.fixture(scope="module", params=ARCHS)
def zoo(request):
    return (request.param,) + _models(request.param)


def test_forward_matches_jax(zoo):
    arch, jm, params, model = zoo
    tok = _rng(50).integers(0, model.cfg.vocab_size, (2, 12))
    want, _ = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(tok)})
    with torch.no_grad():
        got, aux = model.forward({"tokens": _t(tok)})
    assert got.shape == (2, 12, model.cfg.vocab_size)
    assert float(aux["aux"]) == 0.0
    _close(got, want, MODEL_TOL)


def test_decode_replay_matches_jax_and_prefill(zoo):
    """12 tokens replayed through decode_step on both sides (each step's
    logits against JAX), and the port's prefill logits against the last
    replay logits."""
    arch, jm, params, model = zoo
    B, S = 2, 12
    tok = _rng(51).integers(0, model.cfg.vocab_size, (B, S))
    jstep = jax.jit(jm.decode_step)
    jc = jm.init_cache(params, B, prefill_len=0)
    tc = model.init_cache(B, prefill_len=0)
    with torch.no_grad():
        for t in range(S):
            jl, jc = jstep(params, jnp.asarray(tok[:, t:t + 1]), jc,
                           jnp.asarray(t, jnp.int32))
            tl, tc = model.decode_step(_t(tok[:, t:t + 1]), tc, position=t)
            _close(tl, jl, MODEL_TOL)
        prefill = make_prefill_step(model)({"tokens": _t(tok)})
    _close(prefill, tl[:, -1], MODEL_TOL)
    want = jax_prefill_step(jm)(params, {"tokens": jnp.asarray(tok)})
    _close(prefill, want, MODEL_TOL)


def test_serve_step_continues_the_replay(zoo):
    """make_serve_step takes its position from the cache: greedy decoding
    after a replay matches the JAX serve step's tokens and logits."""
    from repro.runtime.steps import make_serve_step as jax_serve_step
    arch, jm, params, model = zoo
    B, S = 2, 5
    tok = _rng(52).integers(0, model.cfg.vocab_size, (B, S))
    jstep, jserve = jax.jit(jm.decode_step), jax.jit(jax_serve_step(jm))
    jc = jm.init_cache(params, B, prefill_len=0)
    tc = model.init_cache(B, prefill_len=0)
    serve = make_serve_step(model)
    with torch.no_grad():
        for t in range(S):
            jl, jc = jstep(params, jnp.asarray(tok[:, t:t + 1]), jc,
                           jnp.asarray(t, jnp.int32))
            tl, tc = model.decode_step(_t(tok[:, t:t + 1]), tc, position=t)
        jt = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
        tt = torch.argmax(tl[:, -1:], -1)
        for _ in range(4):
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
            jl, jc = jserve(params, jt, jc)
            tl, tc = serve(tt, tc)
            _close(tl, jl, MODEL_TOL)
            jt = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
            tt = torch.argmax(tl, -1)[:, None]


def test_kernel_and_reference_presets_agree_on_cpu(zoo):
    arch, _, _, model = zoo
    tok = _t(_rng(53).integers(0, model.cfg.vocab_size, (2, 9)))
    ref = build_model(model.cfg, device="cpu", policy="reference")
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        a, _ = model.forward({"tokens": tok})
        b, _ = ref.forward({"tokens": tok})
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_model_follows_the_f32_model(arch):
    """The served dtype: a bf16 model keeps bf16 activations and logits and
    hands the scans f32 (the wrappers refuse anything else), and its logits
    stay within bf16 rounding of the f32 model with the same weights."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    m16 = build_model(cfg, device="cpu")
    m32 = build_model(get_config(arch).reduced(), device="cpu")
    m32.load_state_dict({k: v.float() for k, v in m16.state_dict().items()})
    tok = _t(_rng(54).integers(0, cfg.vocab_size, (2, 12)))
    with torch.no_grad():
        l16, _ = m16.forward({"tokens": tok})
        l32, _ = m32.forward({"tokens": tok})
        d16, _ = m16.decode_step(tok[:, :1], m16.init_cache(2))
    assert l16.dtype == d16.dtype == torch.bfloat16
    assert torch.isfinite(l16).all()
    # bf16 keeps 8 bits: 2e-2 was measured through the two layers
    err = (l16.float() - l32).abs().max().item()
    assert err <= 5e-2 * l32.abs().max().item(), err


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trip_is_exact_in_bf16(arch):
    """A bf16 JAX tree goes into the port model and back unchanged; every
    leaf keeps its JAX dtype (w0, u, A_log, D and dt_bias stay f32)."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    jparams = jax_build_model(jcfg, remat=False).init(jax.random.PRNGKey(1))
    tree = jax.device_get(jparams)
    sd = model_params_from_numpy(cfg, tree, device="cpu")
    model = build_model(cfg, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    want_dtypes = {k: v.dtype for k, v in model.state_dict().items()}
    assert {k: v.dtype for k, v in sd.items()} == want_dtypes
    f32 = {k.rsplit(".", 1)[-1] for k, v in want_dtypes.items()
           if v == torch.float32}
    assert f32 == ({"w0", "u"} if arch == "rwkv6-1.6b"
                   else {"A_log", "D", "dt_bias"})
    model.load_state_dict(sd)
    back = model_params_to_numpy(model)
    flat_want = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path],
                                      np.asarray(leaf, np.float32))
    # and the model itself round-trips exactly through numpy
    sd2 = model_params_from_numpy(cfg, back, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(sd2[k].to(v.dtype), v)


# ---------------------------------------------------------------------------
# configs, facade, serve driver
# ---------------------------------------------------------------------------

_FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
           "d_ff", "vocab_size", "head_dim", "qk_norm", "activation",
           "tie_embeddings", "ssm", "attention_kind", "shared_attn_every",
           "rope_theta", "norm_eps", "sliding_window", "source", "dtype")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_match_jax(arch, reduced):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    for f in _FIELDS:
        want = getattr(jcfg, f)
        got = getattr(cfg, f)
        if f == "ssm":
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f
    assert cfg.n_params() == jcfg.n_params()
    assert cfg.resolved_head_dim == jcfg.resolved_head_dim


def test_full_configs_have_the_published_dims():
    r = get_config("rwkv6-1.6b")
    assert (r.n_layers, r.d_model, r.d_model // r.ssm.head_dim, r.ssm.head_dim,
            r.d_ff, r.vocab_size) == (24, 2048, 32, 64, 7168, 65536)
    z = get_config("zamba2-2.7b")
    assert (z.n_layers, z.d_model, z.shared_attn_every,
            z.ssm.expand * z.d_model // z.ssm.head_dim, z.ssm.state_dim,
            z.n_heads, z.d_ff, z.vocab_size) == (54, 2560, 6, 80, 64, 32,
                                                 10240, 32000)


def test_unported_archs_and_families_raise():
    """Every family of the JAX package is ported: an unknown family raises
    ValueError, as the JAX package's build_model does, and an unknown arch
    KeyError."""
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("qwen3-15b")
    cfg = dataclasses.replace(get_config("rwkv6-1.6b").reduced(),
                              family="mlp")
    with pytest.raises(ValueError, match="unsupported family"):
        build_model(cfg, device="cpu")
    assert isinstance(cfg.n_params(), int)


@pytest.mark.parametrize("arch", ZOO_ARCHS)
def test_serve_cli_on_cpu(arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve", "--device", "cpu",
         "--arch", arch, "--requests", "2", "--prompt-len", "6",
         "--new-tokens", "5"], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("prefill 6 tokens x 2 requests: ")
    assert lines[1].startswith("decoded 5 tokens x 2 requests in ")
    ids = eval(lines[2].split(":", 1)[1])
    assert len(ids) == 5
    assert all(0 <= i < get_config(arch).reduced().vocab_size for i in ids)
