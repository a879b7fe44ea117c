"""Shared building blocks: norms, RoPE, activations, init helpers; twin of
``repro.models.common``.

Parameters are plain tensors, drawn from an explicit ``torch.Generator`` on
the generator's device.  The dtype flow is the JAX package's: norms and RoPE
compute in float32 and cast back to the input's dtype; matmuls keep the
input dtype.
"""
from __future__ import annotations

import math

import torch


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    scale = 1.0 / math.sqrt(in_dim)
    return (torch.randn(in_dim, out_dim, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    return (torch.randn(vocab, dim, generator=gen, device=gen.device,
                        dtype=torch.float32) * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + eˣ) as ``logaddexp(x, 0)`` everywhere
    (``torch.nn.functional.softplus`` switches to x above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def activation_fn(name: str):
    if name == "swiglu":
        raise ValueError("swiglu is handled by the gated FFN path")
    if name == "squared_relu":
        return lambda x: torch.square(torch.relu(x))
    if name == "gelu":
        # jax.nn.gelu is the tanh approximation by default
        return lambda x: torch.nn.functional.gelu(x, approximate="tanh")
    if name == "relu":
        return torch.relu
    raise ValueError(name)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: torch.device = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # (hd/2,)
    angles = positions.float()[..., None] * freqs              # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def init_ffn(gen: torch.Generator, d_model: int, d_ff: int, activation: str,
             dtype: torch.dtype) -> dict:
    if activation == "swiglu":
        return {"w_gate": dense_init(gen, d_model, d_ff, dtype),
                "w_up": dense_init(gen, d_model, d_ff, dtype),
                "w_down": dense_init(gen, d_ff, d_model, dtype)}
    return {"w_up": dense_init(gen, d_model, d_ff, dtype),
            "w_down": dense_init(gen, d_ff, d_model, dtype)}


def apply_ffn(params, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "swiglu":
        g = torch.nn.functional.silu(x @ params["w_gate"])
        return (g * (x @ params["w_up"])) @ params["w_down"]
    h = activation_fn(activation)(x @ params["w_up"])
    return h @ params["w_down"]
