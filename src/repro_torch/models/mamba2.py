"""Mamba2 (SSD) block — used by zamba2's backbone [arXiv:2411.15242]; twin
of ``repro.models.mamba2``.

State-space recurrence per head (head_dim P, state N):
    h_t = exp(A·dt_t) · h_{t-1} + dt_t · B_t ⊗ x_t        (N×P outer product)
    y_t = C_t · h_t + D · x_t
with a depthwise causal conv in front of (x, B, C) and a gated RMSNorm before
out_proj.  The scan of a whole sequence goes through ``dispatch.mamba2_scan``
(the CUDA kernel on the card under the ``kernel`` preset, the plain
recurrence otherwise).  Decode carries O(1) state: (conv_state, ssm_state).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import dispatch
from repro_torch.models.common import dense_init, rms_norm, softplus


def init_mamba2(gen: torch.Generator, d_model: int, s: SSMConfig,
                dtype: torch.dtype) -> dict:
    d_in = s.expand * d_model
    nh = d_in // s.head_dim
    conv_ch = d_in + 2 * s.state_dim
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "w_in": dense_init(gen, d_model, 2 * d_in + 2 * s.state_dim + nh, dtype),
        "conv_w": (torch.randn(s.conv_kernel, conv_ch, generator=gen, **f32)
                   * (1.0 / math.sqrt(s.conv_kernel))).to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.zeros((nh,), **f32),
        "D": torch.ones((nh,), **f32),
        "dt_bias": torch.zeros((nh,), **f32),
        "norm": torch.ones((d_in,), dtype=dtype, device=dev),
        "w_out": dense_init(gen, d_in, d_model, dtype),
    }


def _split_proj(proj, d_in, N, nh):
    z = proj[..., :d_in]
    xc = proj[..., d_in:2 * d_in]
    B = proj[..., 2 * d_in:2 * d_in + N]
    C = proj[..., 2 * d_in + N:2 * d_in + 2 * N]
    dt = proj[..., 2 * d_in + 2 * N:]
    return z, xc, B, C, dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """x: (b, s, ch); depthwise causal conv, kernel K."""
    K = w.shape[0]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + x.shape[1]] * w[i] for i in range(K))
    return F.silu(out + b)


def mamba2_forward(params, x: torch.Tensor, s: SSMConfig,
                   policy: dispatch.PolicyLike = None) -> torch.Tensor:
    b, L, d_model = x.shape
    d_in = s.expand * d_model
    nh = d_in // s.head_dim
    N, P = s.state_dim, s.head_dim
    proj = x @ params["w_in"]
    z, xc, B, C, dt = _split_proj(proj, d_in, N, nh)
    conv_in = torch.cat([xc, B, C], dim=-1)
    conv_out = _causal_conv(conv_in, params["conv_w"], params["conv_b"])
    xc, B, C = (conv_out[..., :d_in], conv_out[..., d_in:d_in + N],
                conv_out[..., d_in + N:])
    dt = softplus(dt.float() + params["dt_bias"])                   # (b,L,nh)
    A = -torch.exp(params["A_log"])                                 # (nh,)
    xh = xc.reshape(b, L, nh, P).float()
    decay = torch.exp(A * dt)                                       # (b,L,nh)
    y = dispatch.mamba2_scan(decay, dt, B.float(), C.float(), xh,
                             policy=policy)                         # (b,L,nh,P)
    y = y + params["D"][:, None] * xh
    y = y.reshape(b, L, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"])
    return y @ params["w_out"]


class MambaCache(NamedTuple):
    conv: torch.Tensor   # (b, K-1, conv_ch) last inputs
    ssm: torch.Tensor    # (b, nh, N, P) float32


def init_mamba_cache(batch: int, d_model: int, s: SSMConfig,
                     dtype: torch.dtype, device=None) -> MambaCache:
    d_in = s.expand * d_model
    nh = d_in // s.head_dim
    conv_ch = d_in + 2 * s.state_dim
    return MambaCache(
        torch.zeros((batch, s.conv_kernel - 1, conv_ch), dtype=dtype,
                    device=device),
        torch.zeros((batch, nh, s.state_dim, s.head_dim), dtype=torch.float32,
                    device=device))


def mamba2_step(params, x: torch.Tensor, cache: MambaCache,
                s: SSMConfig) -> Tuple[torch.Tensor, MambaCache]:
    """One-token decode.  x: (b, 1, d_model)."""
    b, _, d_model = x.shape
    d_in = s.expand * d_model
    nh = d_in // s.head_dim
    N, P = s.state_dim, s.head_dim
    proj = x[:, 0] @ params["w_in"]
    z, xc, B, C, dt = _split_proj(proj, d_in, N, nh)
    conv_in = torch.cat([xc, B, C], dim=-1)                         # (b, ch)
    window = torch.cat([cache.conv, conv_in[:, None]], dim=1)       # (b,K,ch)
    conv_out = F.silu(
        torch.einsum("bkc,kc->bc", window.float(), params["conv_w"].float())
        + params["conv_b"].float()).to(x.dtype)
    xc, B, C = (conv_out[..., :d_in], conv_out[..., d_in:d_in + N],
                conv_out[..., d_in + N:])
    dt = softplus(dt.float() + params["dt_bias"])                   # (b,nh)
    A = -torch.exp(params["A_log"])
    xh = xc.reshape(b, nh, P).float()
    dec = torch.exp(A * dt)                                         # (b,nh)
    h = (cache.ssm * dec[:, :, None, None]
         + (dt[:, :, None] * B.float()[:, None, :])[..., None]
         * xh[:, :, None, :])
    y = torch.einsum("bn,bhnp->bhp", C.float(), h)
    y = y + params["D"][:, None] * xh
    y = y.reshape(b, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"])
    out = (y @ params["w_out"])[:, None]
    return out, MambaCache(window[:, 1:], h)
