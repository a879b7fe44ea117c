"""RWKV6 "Finch" block — attention-free, data-dependent decay
[arXiv:2404.05892]; twin of ``repro.models.rwkv6``.

Time-mix per head (head size P):
    y_t = S_tᵀ r_t + (r_t · (u ∘ k_t)) v_t
    S_{t+1} = diag(w_t) S_t + k_t v_tᵀ          (w_t data-dependent, per channel)
Channel-mix: squared-ReLU MLP with token shift.  The recurrence of a whole
sequence goes through ``dispatch.rwkv6_wkv`` (the CUDA kernel on the card
under the ``kernel`` preset, the plain recurrence otherwise).  Decode state
is O(1): (S, shift buffers).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import dispatch
from repro_torch.models.common import dense_init, rms_norm


def init_rwkv6(gen: torch.Generator, d_model: int, d_ff: int, s: SSMConfig,
               dtype: torch.dtype) -> dict:
    P = s.head_dim
    nh = d_model // P
    lora = max(32, d_model // 32)
    dev = gen.device
    return {
        # time-mix
        "mu": torch.full((5, d_model), 0.5, dtype=dtype, device=dev),  # r,k,v,g,w
        "w_r": dense_init(gen, d_model, d_model, dtype),
        "w_k": dense_init(gen, d_model, d_model, dtype),
        "w_v": dense_init(gen, d_model, d_model, dtype),
        "w_g": dense_init(gen, d_model, d_model, dtype),
        "w0": torch.full((d_model,), -6.0, dtype=torch.float32, device=dev),
        "w_a": dense_init(gen, d_model, lora, dtype),
        "w_b": dense_init(gen, lora, d_model, dtype),
        "u": torch.zeros((nh, P), dtype=torch.float32, device=dev),  # bonus
        "ln_x": torch.ones((d_model,), dtype=dtype, device=dev),  # output norm
        "w_o": dense_init(gen, d_model, d_model, dtype),
        # channel-mix
        "mu_cm": torch.full((2, d_model), 0.5, dtype=dtype, device=dev),
        "cm_k": dense_init(gen, d_model, d_ff, dtype),
        "cm_v": dense_init(gen, d_ff, d_model, dtype),
    }


def _shift(x: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """token shift: prepend x0 (b, d) and drop last."""
    return torch.cat([x0[:, None], x[:, :-1]], dim=1)


def _decay(params, xw: torch.Tensor) -> torch.Tensor:
    w = params["w0"] + (torch.tanh(xw @ params["w_a"]) @ params["w_b"]).float()
    return torch.exp(-torch.exp(w))        # (…, d_model) in (0,1)


def rwkv6_time_mix(params, x: torch.Tensor, s: SSMConfig, x0=None,
                   policy: dispatch.PolicyLike = None) -> torch.Tensor:
    b, L, d = x.shape
    P = s.head_dim
    nh = d // P
    if x0 is None:
        x0 = x.new_zeros(b, d)
    xs = _shift(x, x0)
    mu = params["mu"]
    mix = lambda i: x + mu[i] * (xs - x)
    r = (mix(0) @ params["w_r"]).reshape(b, L, nh, P).float()
    k = (mix(1) @ params["w_k"]).reshape(b, L, nh, P).float()
    v = (mix(2) @ params["w_v"]).reshape(b, L, nh, P).float()
    g = F.silu(mix(3) @ params["w_g"])
    w = _decay(params, mix(4)).reshape(b, L, nh, P)
    y = dispatch.rwkv6_wkv(r, k, v, w, params["u"], policy=policy)
    y = y.reshape(b, L, d).to(x.dtype)
    y = rms_norm(y, params["ln_x"]) * g
    return y @ params["w_o"]


def rwkv6_channel_mix(params, x: torch.Tensor, x0=None) -> torch.Tensor:
    b, L, d = x.shape
    if x0 is None:
        x0 = x.new_zeros(b, d)
    xs = _shift(x, x0)
    mu = params["mu_cm"]
    xk = x + mu[0] * (xs - x)
    k = torch.square(torch.relu(xk @ params["cm_k"]))
    return k @ params["cm_v"]


class RWKVCache(NamedTuple):
    S: torch.Tensor        # (b, nh, P, P) f32
    x_tm: torch.Tensor     # (b, d) last input seen by time-mix
    x_cm: torch.Tensor     # (b, d) last input seen by channel-mix


def init_rwkv_cache(batch: int, d_model: int, s: SSMConfig,
                    dtype: torch.dtype, device=None) -> RWKVCache:
    nh = d_model // s.head_dim
    return RWKVCache(
        torch.zeros((batch, nh, s.head_dim, s.head_dim), dtype=torch.float32,
                    device=device),
        torch.zeros((batch, d_model), dtype=dtype, device=device),
        torch.zeros((batch, d_model), dtype=dtype, device=device))


def rwkv6_step(params, x: torch.Tensor, cache: RWKVCache, s: SSMConfig
               ) -> Tuple[torch.Tensor, RWKVCache]:
    """One token through time-mix; returns (y_tm, cache')."""
    b, _, d = x.shape
    P = s.head_dim
    nh = d // P
    xt = x[:, 0]
    mu = params["mu"]
    mix = lambda i: xt + mu[i] * (cache.x_tm - xt)
    r = (mix(0) @ params["w_r"]).reshape(b, nh, P).float()
    k = (mix(1) @ params["w_k"]).reshape(b, nh, P).float()
    v = (mix(2) @ params["w_v"]).reshape(b, nh, P).float()
    g = F.silu(mix(3) @ params["w_g"])
    w = _decay(params, mix(4)).reshape(b, nh, P)
    u = params["u"]
    rk = torch.sum(r * u * k, dim=-1)
    y = torch.einsum("bhp,bhpq->bhq", r, cache.S) + rk[..., None] * v
    S = cache.S * w[..., None] + k[..., None] * v[..., None, :]
    y = y.reshape(b, d).to(x.dtype)
    y = rms_norm(y, params["ln_x"]) * g
    y = (y @ params["w_o"])[:, None]
    return y, RWKVCache(S, xt, cache.x_cm)


def rwkv6_channel_step(params, x: torch.Tensor, cache: RWKVCache
                       ) -> Tuple[torch.Tensor, RWKVCache]:
    xt = x[:, 0]
    mu = params["mu_cm"]
    xk = xt + mu[0] * (cache.x_cm - xt)
    k = torch.square(torch.relu(xk @ params["cm_k"]))
    y = (k @ params["cm_v"])[:, None]
    return y, RWKVCache(cache.S, cache.x_tm, xt)
