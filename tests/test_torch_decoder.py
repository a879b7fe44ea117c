"""The port's decoder and enc-dec zoo families against the JAX package: the
gelu / relu FFNs, the MoE layer (capacity drops, router ties, local
dispatch), MLA (forward and the latent ring buffer), cross-attention, and
the eight dense / vlm / moe / audio configs as whole reduced models
(forward with MTP logits and aux, decode replay, greedy serving, the vision
prefix, the enc-dec memory), their configs and their parameter trees.

Everything is float32 at reduced widths unless a test says otherwise;
weights are the JAX package's, carried across with
``convert.model_params_from_numpy``; inputs come from seeded numpy
generators.  No Pallas kernel lies on these paths (the JAX models call
``attention._sdpa``; ``moe`` and ``mla`` call no kernel).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models.transformer import build_model as jax_build_model
from repro.runtime.steps import make_prefill_step as jax_prefill_step
from repro.runtime.steps import make_serve_step as jax_serve_step
from repro_torch import serve
from repro_torch.configs.base import MoEConfig, get_config, list_configs
from repro_torch.convert import model_params_from_numpy, model_params_to_numpy
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mamba2_scan import ops as ssd_ops
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.models import attention, common, mla, moe
from repro_torch.models.transformer import build_model
from repro_torch.runtime.steps import make_prefill_step, make_serve_step

from torch_parity import one_torch_thread  # noqa: F401

ARCHS = ("smollm-135m", "qwen3-14b", "granite-20b", "nemotron-4-15b",
         "internvl2-1b", "granite-moe-3b-a800m", "deepseek-v3-671b",
         "seamless-m4t-medium")
MODULE_TOL = 1e-5      # f32 module parity
MODEL_TOL = 1e-4       # f32 whole-model parity, relative to max|logits|


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(seed, shape, scale=1.0):
    return (_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), jax.device_get(tree))


def _torch_tree(tree):
    return jax.tree.map(lambda a: _t(np.asarray(a)), tree)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _close_scaled(got, want, tol):
    """|got − want| within tol of max|want| (the whole-model bound)."""
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * np.abs(want).max(), err


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_gelu_and_relu_ffn_match_jax(act):
    """jax.nn.gelu is the tanh approximation: the port's gelu is too (the
    exact erf form differs by 1.5e-4 at 1.0)."""
    p = _np_tree(jcommon.init_ffn(jax.random.PRNGKey(3), 64, 96, act,
                                  jnp.float32))
    h = _normal(63, (2, 5, 64), 2.0)
    _close(common.apply_ffn(_torch_tree(p), _t(h), act),
           jcommon.apply_ffn(p, jnp.asarray(h), act), MODULE_TOL)
    z = np.linspace(-6, 6, 49, dtype=np.float32)
    _close(common.activation_fn(act)(_t(z)),
           jcommon.activation_fn(act)(jnp.asarray(z)), 1e-6)


def _moe_cfg(**kw):
    base = dict(n_experts=4, top_k=2, d_ff_expert=64, n_shared=1)
    base.update(kw)
    return MoEConfig(**base)


def _jmoe_cfg(cfg):
    from repro.configs.base import MoEConfig as JMoEConfig
    return JMoEConfig(**dataclasses.asdict(cfg))


def _moe_case(cfg, act, d=48, shape=(2, 9), seed=0, dtype=jnp.float32):
    p = jmoe.init_moe(jax.random.PRNGKey(seed), d, _jmoe_cfg(cfg), act,
                      dtype)
    x = _normal(70 + seed, shape + (d,)).astype(np.float32)
    return _np_tree(p), x


@pytest.mark.parametrize("act", ["swiglu", "squared_relu", "gelu"])
@pytest.mark.parametrize("cf,n_shared", [(1.25, 1), (0.5, 0), (4.0, 0)])
def test_moe_matches_jax(act, cf, n_shared):
    """Output and aux, with a shared expert or none, at a capacity that
    drops tokens (cf 0.5: which ones depends on the stable sort) and at
    one that keeps them all (cf 4.0 = E / top_k... and more)."""
    cfg = _moe_cfg(capacity_factor=cf, n_shared=n_shared)
    p, x = _moe_case(cfg, act)
    want, waux = jmoe.apply_moe(p, jnp.asarray(x), _jmoe_cfg(cfg), act)
    got, aux = moe.apply_moe(_torch_tree(p), _t(x), cfg, act)
    _close(got, want, MODULE_TOL)
    _close(aux, waux, MODULE_TOL)
    T = x.shape[0] * x.shape[1]
    cap = moe.capacity(T, cfg)
    assert cap == int(max(1, (T * cfg.top_k * cf) // cfg.n_experts))
    if cf == 0.5:
        # tokens were dropped: the expert part of some outputs is 0
        _, _, idx = moe.route(_torch_tree(p), _t(x).reshape(T, -1), cfg)
        _, _, keep = moe.dispatch_slots(idx.reshape(-1), cfg.n_experts, cap)
        assert 0 < int((~keep).sum()) < keep.numel()


def test_moe_drops_follow_the_token_order():
    """With one expert of capacity 2 fed by every token, the first two
    tokens (in flat order) are kept and the others get only their other
    expert, as JAX's stable argsort gives."""
    cfg = _moe_cfg(n_experts=4, top_k=1, capacity_factor=2.0, n_shared=0)
    p, x = _moe_case(cfg, "swiglu", shape=(1, 4), seed=3)
    # route every token to expert 2
    p["router"] = np.zeros_like(p["router"])
    p["router"][:, 2] = 1.0
    x = np.abs(x)
    want, _ = jmoe.apply_moe(p, jnp.asarray(x), _jmoe_cfg(cfg), "swiglu")
    got, _ = moe.apply_moe(_torch_tree(p), _t(x), cfg, "swiglu")
    _close(got, want, MODULE_TOL)
    assert moe.capacity(4, cfg) == 2
    assert np.abs(np.asarray(want)[0, :2]).max() > 0
    np.testing.assert_array_equal(np.asarray(want)[0, 2:], 0.0)


def test_moe_local_dispatch_matches_jax():
    cfg = _moe_cfg(capacity_factor=1.0)
    p, x = _moe_case(cfg, "swiglu", shape=(3, 7), seed=1)
    want, waux = jmoe.apply_moe(p, jnp.asarray(x), _jmoe_cfg(cfg), "swiglu",
                                local_dispatch=True)
    got, aux = moe.apply_moe(_torch_tree(p), _t(x), cfg, "swiglu",
                             local_dispatch=True)
    _close(got, want, MODULE_TOL)
    _close(aux, waux, MODULE_TOL)
    # per-example capacity is not the global one
    glob, _ = moe.apply_moe(_torch_tree(p), _t(x), cfg, "swiglu")
    assert not torch.equal(glob, got)


def test_moe_bf16_router_ties_pick_the_lower_expert():
    """A bf16 model's router runs in bf16: equal bf16 logits give equal f32
    probabilities.  Experts 1 and 2 get one router column, so every token
    ties them; ``jax.lax.top_k`` takes the lower index first, and the port
    does too (``torch.topk`` promises no order).  The bf16 layer output
    then agrees with JAX's within two bf16 units of its scale."""
    cfg = _moe_cfg(n_experts=4, top_k=2, capacity_factor=1.0, n_shared=0)
    p, x = _moe_case(cfg, "swiglu", shape=(4, 16), seed=2,
                     dtype=jnp.bfloat16)
    p["router"] = np.array(p["router"])
    p["router"][:, 2] = p["router"][:, 1]
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = xb.reshape(-1, xb.shape[-1])
    probs = jax.nn.softmax((xt @ jnp.asarray(p["router"]).astype(xt.dtype))
                           .astype(jnp.float32), axis=-1)
    _, widx = jax.lax.top_k(probs, cfg.top_k)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a, np.float32))
                      .to(torch.bfloat16 if a.dtype == jnp.bfloat16
                          else torch.float32), p)
    assert tp["router"].dtype == torch.float32
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tprobs, _, tidx = moe.route(tp, tx.reshape(-1, x.shape[-1]), cfg)
    _close(tprobs, probs, 1e-6)
    assert torch.equal(tprobs[:, 1], tprobs[:, 2])
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(widx))
    widx = np.asarray(widx)
    # ties at the top-k boundary (another expert first, then 1 or 2): expert
    # 1 is taken and expert 2 is not
    boundary = ~np.isin(widx[:, 0], (1, 2)) & np.isin(widx[:, 1], (1, 2))
    assert boundary.any() and (widx[boundary, 1] == 1).all()
    want, _ = jmoe.apply_moe(p, xb, _jmoe_cfg(cfg), "swiglu")
    got, _ = moe.apply_moe(tp, tx, cfg, "swiglu")
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2 * 2.0 ** -7 * np.abs(want).max(), err


def _mla_setup(seed=0):
    jcfg = jax_get_config("deepseek-v3-671b").reduced()
    cfg = get_config("deepseek-v3-671b").reduced()
    p = _np_tree(jmla.init_mla(jax.random.PRNGKey(seed), jcfg.d_model,
                               jcfg.n_heads, jcfg.mla, jnp.float32))
    return cfg, jcfg, p


@pytest.mark.parametrize("window", [None, 5])
def test_mla_attention_matches_jax(window):
    cfg, jcfg, p = _mla_setup()
    x = _normal(80, (2, 12, cfg.d_model))
    want = jmla.mla_attention(p, jnp.asarray(x), n_heads=jcfg.n_heads,
                              m=jcfg.mla, theta=jcfg.rope_theta,
                              window=window)
    got = mla.mla_attention(_torch_tree(p), _t(x), n_heads=cfg.n_heads,
                            m=cfg.mla, theta=cfg.rope_theta, window=window)
    _close(got, want, MODULE_TOL)


@pytest.mark.parametrize("window", [None, 3])
def test_mla_decode_ring_buffer_wrap_matches_jax(window):
    """A 4-slot latent ring buffer driven for 9 steps after a prefill of 2
    (two wraps), positions from the cache and given explicitly."""
    cfg, jcfg, p = _mla_setup(1)
    tp = _torch_tree(p)
    W, b = 4, 2
    jc = jmla.init_mla_cache(b, W, jcfg.mla, jnp.float32, prefill_len=2)
    tc = mla.init_mla_cache(b, W, cfg.mla, torch.float32, prefill_len=2)
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    xs = _normal(81, (b, 9, cfg.d_model))
    for t in range(xs.shape[1]):
        position = None if t % 2 else 2 + t
        jy, jc = jmla.decode_mla_attention(
            p, jnp.asarray(xs[:, t:t + 1]), jc, n_heads=jcfg.n_heads,
            m=jcfg.mla, theta=jcfg.rope_theta, window=window,
            position=None if position is None else jnp.asarray(position))
        ty, tc = mla.decode_mla_attention(
            tp, _t(xs[:, t:t + 1]), tc, n_heads=cfg.n_heads, m=cfg.mla,
            theta=cfg.rope_theta, window=window, position=position)
        _close(ty, jy, MODULE_TOL)
        np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
        assert tc.index == int(jc.index)
        assert tc.last == int(jnp.max(jc.pos))
    _close(tc.c_kv, jc.c_kv, MODULE_TOL)
    _close(tc.k_rope, jc.k_rope, MODULE_TOL)


def test_mla_cache_is_the_latent():
    """DeepSeek-V3's cache holds kv_lora_rank + rope_dim values a token, a
    57th of GQA's 2·heads·head_dim (tests/test_models_extra.py's claim)."""
    cfg = get_config("deepseek-v3-671b")
    c = mla.init_mla_cache(4, 16, cfg.mla, torch.bfloat16)
    g = attention.init_kv_cache(4, 16, cfg.n_kv_heads, 128, torch.bfloat16)
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    ratio = nbytes((g.k, g.v)) / nbytes((c.c_kv, c.k_rope))
    assert ratio == 2 * 128 * 128 / (512 + 64)


def test_cross_attention_matches_jax():
    """attention(memory=) (no RoPE, no mask, memory longer than the
    queries) and the decode path: K/V of the memory once, then one query
    at a time."""
    jcfg = jax_get_config("seamless-m4t-medium").reduced()
    p = _np_tree(jattn.init_attention(
        jax.random.PRNGKey(5), jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads,
        jcfg.resolved_head_dim, False, jnp.float32))
    tp = _torch_tree(p)
    kw = dict(n_heads=jcfg.n_heads, n_kv_heads=jcfg.n_kv_heads,
              head_dim=jcfg.resolved_head_dim, theta=jcfg.rope_theta)
    x = _normal(90, (2, 5, jcfg.d_model))
    mem = _normal(91, (2, 7, jcfg.d_model))
    want = jattn.attention(p, jnp.asarray(x), memory=jnp.asarray(mem), **kw)
    got = attention.attention(tp, _t(x), memory=_t(mem), **kw)
    _close(got, want, MODULE_TOL)
    hd = dict(n_kv_heads=jcfg.n_kv_heads, head_dim=jcfg.resolved_head_dim)
    jk, jv = jattn.cross_attention_kv(p, jnp.asarray(mem), **hd)
    tk, tv = attention.cross_attention_kv(tp, _t(mem), **hd)
    _close(tk, jk, MODULE_TOL)
    _close(tv, jv, MODULE_TOL)
    for t in range(x.shape[1]):
        jy = jattn.decode_cross_attention(
            p, jnp.asarray(x[:, t:t + 1]), jk, jv, n_heads=jcfg.n_heads,
            head_dim=jcfg.resolved_head_dim)
        ty = attention.decode_cross_attention(
            tp, _t(x[:, t:t + 1]), tk, tv, n_heads=jcfg.n_heads,
            head_dim=jcfg.resolved_head_dim)
        _close(ty, jy, MODULE_TOL)
        _close(ty, got[:, t:t + 1], MODULE_TOL)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def _models(arch, seed=0, **kw):
    jcfg = jax_get_config(arch).reduced()
    jm = jax_build_model(jcfg, remat=False, **kw)
    params = jm.init(jax.random.PRNGKey(seed))
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu", **kw)
    model.load_state_dict(model_params_from_numpy(cfg, _np_tree(params),
                                                  device="cpu"))
    return jm, params, model


@pytest.fixture(scope="module", params=ARCHS)
def zoo(request):
    return (request.param,) + _models(request.param)


def _batches(cfg, seed, B=2, S=12):
    """The same tokens (and frontend embeddings) for JAX and the port."""
    tok = _rng(seed).integers(0, cfg.vocab_size, (B, S))
    jb, tb = {"tokens": jnp.asarray(tok)}, {"tokens": _t(tok)}
    if cfg.frontend:
        e = _normal(seed + 1, (B, cfg.frontend_positions, cfg.d_model))
        jb["embeds"], tb["embeds"] = jnp.asarray(e), _t(e)
    return tok, jb, tb


def test_forward_matches_jax(zoo):
    """Logits (over the vision prefix and the tokens for a vlm), aux and
    DeepSeek-V3's MTP logits."""
    arch, jm, params, model = zoo
    cfg = model.cfg
    _, jb, tb = _batches(cfg, 100)
    want, wx = jax.jit(jm.forward)(params, jb)
    fa, wkv, ssd = fa_ops.launches, wkv_ops.launches, ssd_ops.launches
    with torch.no_grad():
        got, extras = model.forward(tb)
    assert (fa, wkv, ssd) == (fa_ops.launches, wkv_ops.launches,
                              ssd_ops.launches)
    prefix = cfg.frontend_positions if cfg.family == "vlm" else 0
    assert got.shape == (2, prefix + 12, cfg.vocab_size)
    _close_scaled(got, want, MODEL_TOL)
    assert set(extras) == set(wx)
    _close(extras["aux"], wx["aux"], MODULE_TOL)
    if cfg.family == "moe":
        assert float(extras["aux"]) > 0
    if cfg.mtp:
        assert extras["mtp_logits"].shape == got.shape
        _close_scaled(extras["mtp_logits"], wx["mtp_logits"], MODEL_TOL)


def test_vlm_prefix_changes_only_through_the_prefix():
    """The patch embeddings are a prefix: without them the logits are the
    token part of a text-only forward pass, and with them every token's
    logits move."""
    jm, params, model = _models("internvl2-1b", 1)
    cfg = model.cfg
    tok, jb, tb = _batches(cfg, 101)
    with torch.no_grad():
        with_prefix, _ = model.forward(tb)
        text, _ = model.forward({"tokens": tb["tokens"]})
    want, _ = jax.jit(jm.forward)(params, {"tokens": jb["tokens"]})
    _close_scaled(text, want, MODEL_TOL)
    assert text.shape[1] == tok.shape[1]
    P = cfg.frontend_positions
    assert (with_prefix[:, P:] - text).abs().max() > 1e-3


def _jax_cache(jm, params, cfg, B, memory=None):
    if cfg.is_enc_dec:
        return jm.init_cache(params, B, prefill_len=0, memory=memory)
    return jm.init_cache(params, B, prefill_len=0)


def _port_cache(model, B, memory=None):
    if model.cfg.is_enc_dec:
        return model.init_cache(B, prefill_len=0, memory=memory)
    return model.init_cache(B, prefill_len=0)


def test_decode_replay_matches_jax_and_prefill(zoo):
    """12 tokens replayed through decode_step on both sides (every step's
    logits against JAX); the port's prefill against the last replay logits
    and against JAX's prefill step.  The enc-dec replays with the memory of
    its frame embeddings on both sides, and its prefill reads the same
    embeddings; a vlm replays tokens only, as the JAX example does."""
    arch, jm, params, model = zoo
    cfg = model.cfg
    tok, jb, tb = _batches(cfg, 102)
    B, S = tok.shape
    jmem = tmem = None
    if cfg.is_enc_dec:
        # JAX's encoder output, carried across: both caches hold one memory
        jmem = jax.jit(lambda p, e: _encode(jm, p, e, cfg))(params,
                                                            jb["embeds"])
        with torch.no_grad():
            tmem = model.encode(tb["embeds"])
        _close_scaled(tmem, jmem, MODEL_TOL)
    jc = _jax_cache(jm, params, cfg, B, jmem)
    with torch.no_grad():
        tc = _port_cache(model, B, tmem)
        jstep = jax.jit(jm.decode_step)
        for t in range(S):
            jl, jc = jstep(params, jnp.asarray(tok[:, t:t + 1]), jc,
                           jnp.asarray(t, jnp.int32))
            tl, tc = model.decode_step(_t(tok[:, t:t + 1]), tc, position=t)
            _close_scaled(tl, jl, MODEL_TOL)
        pb = tb if cfg.is_enc_dec else {"tokens": tb["tokens"]}
        prefill = make_prefill_step(model)(pb)
    if cfg.moe is None:
        # an MoE prefill routes B·S tokens together, a decode step B: their
        # capacities differ, and so may the tokens they drop
        # (test_moe_prefill_without_drops_matches_the_replay)
        _close_scaled(prefill, tl[:, -1], MODEL_TOL)
    jpb = jb if cfg.is_enc_dec else {"tokens": jb["tokens"]}
    _close_scaled(prefill, jax_prefill_step(jm)(params, jpb), MODEL_TOL)
    if cfg.frontend and not cfg.is_enc_dec:
        with torch.no_grad():
            full = make_prefill_step(model)(tb)
        _close_scaled(full, jax_prefill_step(jm)(params, jb), MODEL_TOL)


def _encode(jm, params, embeds, cfg):
    """The JAX enc-dec's memory: its encoder, run through the layers of
    ``params["enc_layers"]`` as ``_build_encdec``'s encode does."""
    from repro.models.transformer import _apply_dense_block
    x = embeds.astype(jnp.float32) @ params["frontend_proj"]
    pos = jnp.arange(x.shape[1])[None, :]

    def body(x, lp):
        return _apply_dense_block(lp, x, cfg, positions=pos,
                                  causal=False), None
    x, _ = jax.lax.scan(body, x, params["enc_layers"])
    return x


def test_greedy_serving_matches_jax(zoo):
    """``repro_torch.serve.generate`` (prompt replay, then make_serve_step
    greedily) gives the tokens of the JAX example's loop, and its logits
    step by step."""
    arch, jm, params, model = zoo
    cfg = model.cfg
    B, S, new = 2, 6, 5
    prompts = _rng(103).integers(0, cfg.vocab_size, (B, S))
    jstep, jserve = jax.jit(jm.decode_step), jax.jit(jax_serve_step(jm))
    jc = _jax_cache(jm, params, cfg, B)
    for t in range(S):
        jl, jc = jstep(params, jnp.asarray(prompts[:, t:t + 1]), jc,
                       jnp.asarray(t, jnp.int32))
    tok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    want, wlogits = [tok], []
    for _ in range(new - 1):
        jl, jc = jserve(params, tok, jc)
        wlogits.append(jl)
        tok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        want.append(tok)
    want = np.concatenate([np.asarray(w) for w in want], axis=1)
    served = serve.generate(model, _t(prompts), new)
    np.testing.assert_array_equal(served.tokens.numpy(), want)
    # and the serve step's logits along the same tokens
    tc = _port_cache(model, B)
    step = make_serve_step(model)
    with torch.no_grad():
        for t in range(S):
            _, tc = model.decode_step(_t(prompts[:, t:t + 1]), tc,
                                      position=t)
        for i, wl in enumerate(wlogits):
            tl, tc = step(_t(want[:, i:i + 1]), tc)
            _close_scaled(tl, wl, MODEL_TOL)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-v3-671b"])
def test_moe_prefill_without_drops_matches_the_replay(arch):
    """At capacity_factor = n_experts / top_k no expert can overflow, at
    any T: the prefill's last logits are the replay's."""
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    model = build_model(cfg, device="cpu")
    tok = _t(_rng(106).integers(0, cfg.vocab_size, (2, 12)))
    cache = model.init_cache(2)
    with torch.no_grad():
        for t in range(tok.shape[1]):
            logits, cache = model.decode_step(tok[:, t:t + 1], cache)
        prefill = make_prefill_step(model)({"tokens": tok})
    _close_scaled(prefill, logits[:, -1], MODEL_TOL)


@pytest.mark.parametrize("arch", ["qwen3-14b", "deepseek-v3-671b",
                                  "seamless-m4t-medium"])
def test_windowed_decode_matches_jax(arch):
    """A 5-slot decode window (``build_model(decode_window=)``) over a
    12-token replay after a prefill of 3: the GQA, MLA and enc-dec ring
    buffers wrap twice, every step's logits against JAX's."""
    jm, params, model = _models(arch, 4, decode_window=5)
    cfg = model.cfg
    tok = _rng(107).integers(0, cfg.vocab_size, (2, 12))
    jc = jm.init_cache(params, 2, prefill_len=3)
    tc = model.init_cache(2, prefill_len=3)
    jstep = jax.jit(jm.decode_step)
    with torch.no_grad():
        for t in range(tok.shape[1]):
            jl, jc = jstep(params, jnp.asarray(tok[:, t:t + 1]), jc)
            tl, tc = model.decode_step(_t(tok[:, t:t + 1]), tc)
            _close_scaled(tl, jl, MODEL_TOL)


def test_moe_model_local_dispatch_matches_jax():
    jcfg = jax_get_config("granite-moe-3b-a800m").reduced()
    cfg = get_config("granite-moe-3b-a800m").reduced()
    jm = jax_build_model(jcfg, remat=False, moe_local_dispatch=True)
    params = jm.init(jax.random.PRNGKey(2))
    model = build_model(cfg, device="cpu", moe_local_dispatch=True)
    model.load_state_dict(model_params_from_numpy(cfg, _np_tree(params),
                                                  device="cpu"))
    _, jb, tb = _batches(cfg, 104, B=3)
    want, wx = jax.jit(jm.forward)(params, jb)
    with torch.no_grad():
        got, extras = model.forward(tb)
    _close_scaled(got, want, MODEL_TOL)
    _close(extras["aux"], wx["aux"], MODULE_TOL)


def test_enc_dec_default_memory_is_zeros():
    """init_cache without a memory holds the cross K/V of a zero memory of
    frontend_positions frames, as the JAX package's does."""
    jm, params, model = _models("seamless-m4t-medium", 3)
    cfg = model.cfg
    zeros = torch.zeros((2, cfg.frontend_positions, cfg.d_model))
    a, b = model.init_cache(2), model.init_cache(2, memory=zeros)
    for k in ("cross_k", "cross_v"):
        assert len(a[k]) == cfg.n_layers
        for x, y in zip(a[k], b[k]):
            assert x.shape == (2, cfg.frontend_positions, cfg.n_kv_heads,
                               cfg.resolved_head_dim)
            assert torch.equal(x, y)
    jc = jm.init_cache(params, 2)
    _close(torch.stack(a["cross_k"]), jc["cross_k"], MODULE_TOL)


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------

def test_registry_matches_jax():
    from repro.configs.base import list_configs as jax_list
    assert list_configs() == jax_list()
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", list_configs())
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_match_jax(arch, reduced):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.n_params() == jcfg.n_params()
    assert cfg.n_active_params() == jcfg.n_active_params()
    assert cfg.resolved_head_dim == jcfg.resolved_head_dim


@pytest.mark.parametrize("arch", ARCHS + ("rwkv6-1.6b", "zamba2-2.7b"))
def test_full_config_dims_exact(arch):
    """The published dims, as the JAX package's smoke test holds them."""
    spec = {
        "zamba2-2.7b": (54, 2560, 32, 32, 10240, 32000),
        "qwen3-14b": (40, 5120, 40, 8, 17408, 151936),
        "deepseek-v3-671b": (61, 7168, 128, 128, 2048, 129280),
        "granite-moe-3b-a800m": (32, 1536, 24, 8, 512, 49155),
        "nemotron-4-15b": (32, 6144, 48, 8, 24576, 256000),
        "granite-20b": (52, 6144, 48, 1, 24576, 49152),
        "internvl2-1b": (24, 896, 14, 2, 4864, 151655),
        "seamless-m4t-medium": (12, 1024, 16, 16, 4096, 256206),
        "smollm-135m": (30, 576, 9, 3, 1536, 49152),
        "rwkv6-1.6b": (24, 2048, 32, 32, 7168, 65536),
    }[arch]
    cfg = get_config(arch)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab_size) == spec
    if arch == "deepseek-v3-671b":
        assert cfg.moe.n_experts == 256 and cfg.moe.top_k == 8
        assert cfg.moe.n_shared == 1 and cfg.mtp
        assert cfg.attention_kind == "mla" and cfg.mla.kv_lora_rank == 512
    if arch == "granite-moe-3b-a800m":
        assert cfg.moe.n_experts == 40 and cfg.moe.top_k == 8
    if arch == "seamless-m4t-medium":
        assert cfg.is_enc_dec and cfg.enc_layers == 12
        assert cfg.frontend_positions == 512
    if arch == "internvl2-1b":
        assert cfg.frontend == "vision" and cfg.frontend_positions == 256


def test_param_counts_of_the_served_models():
    """n_params() of the models the card serves at full width, and the
    active count of the two MoE models (billions)."""
    counts = {a: round(get_config(a).n_params() / 1e9, 2)
              for a in ("qwen3-14b", "granite-moe-3b-a800m",
                        "deepseek-v3-671b")}
    assert counts == {"qwen3-14b": 14.77, "granite-moe-3b-a800m": 3.3,
                      "deepseek-v3-671b": 703.8}
    assert round(get_config("granite-moe-3b-a800m").n_active_params() / 1e9,
                 2) == 0.88
    assert round(get_config("deepseek-v3-671b").n_active_params() / 1e9,
                 2) == 37.56


@pytest.mark.parametrize("arch", ARCHS)
def test_built_model_holds_n_params(arch):
    """The reduced model's parameters are the analytic count plus what the
    count leaves out (norm scales, the frontend projection, the MTP head)."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    held = sum(p.numel() for p in model.parameters())
    extra = sum(p.numel() for k, p in model.named_parameters()
                if k.rsplit(".", 1)[-1] in ("ln1", "ln2", "ln_x", "ln_f",
                                            "q_norm", "k_norm", "kv_norm")
                or k.startswith(("mtp_", "frontend_proj")))
    assert held - extra == cfg.n_params()


def test_unknown_family_raises_value_error():
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                              family="mlp")
    with pytest.raises(ValueError, match="unsupported family"):
        build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="unsupported family"):
        build_model(get_config("splitme-dnn10"), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trip_is_exact_in_bf16(arch):
    """A bf16 JAX tree goes into the port model and back unchanged: the
    expert stacks keep their (E, …) dim inside each layer, the router stays
    f32, and mtp_*, frontend_proj and the enc/dec stacks come back whole."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    tree = jax.device_get(jax_build_model(jcfg, remat=False).init(
        jax.random.PRNGKey(1)))
    sd = model_params_from_numpy(cfg, tree, device="cpu")
    model = build_model(cfg, device="cpu")
    want_dtypes = {k: v.dtype for k, v in model.state_dict().items()}
    assert {k: v.dtype for k, v in sd.items()} == want_dtypes
    f32 = {k for k, v in want_dtypes.items() if v == torch.float32}
    assert f32 == ({f"layers.{i}.moe.router" for i in range(cfg.n_layers)}
                   | ({"mtp_block.moe.router"} if cfg.mtp else set())
                   if cfg.moe else set())
    if cfg.moe:
        w = sd["layers.1.moe.experts.w_gate"]
        assert w.shape == (cfg.moe.n_experts, cfg.d_model,
                           cfg.moe.d_ff_expert)
    if cfg.is_enc_dec:
        assert {k.split(".")[0] for k in sd} >= {"enc_layers", "dec_layers"}
    model.load_state_dict(sd)
    back = model_params_to_numpy(model)
    flat_want = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path],
                                      np.asarray(leaf, np.float32))
    sd2 = model_params_from_numpy(cfg, back, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(sd2[k].to(v.dtype), v)


@pytest.mark.parametrize("arch", ["qwen3-14b", "granite-moe-3b-a800m",
                                  "deepseek-v3-671b", "seamless-m4t-medium"])
def test_bf16_model_follows_the_f32_model(arch):
    """The served dtype: bf16 activations and logits (MTP's too), the
    router in f32, and logits within bf16 rounding of the f32 model with
    the same weights."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    m16 = build_model(cfg, device="cpu")
    m32 = build_model(get_config(arch).reduced(), device="cpu")
    m32.load_state_dict({k: v.float() for k, v in m16.state_dict().items()})
    tok, _, tb = _batches(cfg, 105)
    tb32 = dict(tb)
    if "embeds" in tb:
        tb["embeds"] = tb["embeds"].to(torch.bfloat16)
    with torch.no_grad():
        l16, x16 = m16.forward(tb)
        l32, _ = m32.forward(tb32)
        d16, _ = m16.decode_step(tb["tokens"][:, :1], m16.init_cache(2))
    assert l16.dtype == d16.dtype == torch.bfloat16
    if cfg.mtp:
        assert x16["mtp_logits"].dtype == torch.bfloat16
    assert torch.isfinite(l16).all()
    err = (l16.float() - l32).abs().max().item()
    assert err <= 5e-2 * l32.abs().max().item(), err
