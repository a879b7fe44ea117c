"""Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437); twin of
``repro.models.mla``.

Queries go through a low-rank bottleneck (q_lora_rank); keys and values
are compressed into one latent c_kv (kv_lora_rank) plus one shared RoPE key
a position.  The decode cache holds only (c_kv, k_rope), the latent:
(kv_lora_rank + rope_dim) values a token instead of 2·n_heads·head_dim,
the paper's memory saving, in a ring buffer written in place.  Scores are
the JAX package's plain float32 einsum-softmax, with the scale
1/sqrt(qk_nope + qk_rope).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import MLAConfig
from repro_torch.models.common import apply_rope, dense_init, rms_norm

NEG_INF = -1e30


def init_mla(gen: torch.Generator, d_model: int, n_heads: int, m: MLAConfig,
             dtype: torch.dtype) -> dict:
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    ones = lambda n: torch.ones((n,), dtype=dtype, device=gen.device)
    return {
        "w_dq": dense_init(gen, d_model, m.q_lora_rank, dtype),
        "q_norm": ones(m.q_lora_rank),
        "w_uq": dense_init(gen, m.q_lora_rank, n_heads * qk_head, dtype),
        "w_dkv": dense_init(gen, d_model, m.kv_lora_rank + m.qk_rope_head_dim,
                            dtype),
        "kv_norm": ones(m.kv_lora_rank),
        "w_ukv": dense_init(gen, m.kv_lora_rank,
                            n_heads * (m.qk_nope_head_dim + m.v_head_dim),
                            dtype),
        "wo": dense_init(gen, n_heads * m.v_head_dim, d_model, dtype),
    }


def _project(params, x, n_heads, m: MLAConfig, positions, theta):
    """Per-head q (b,s,h,qk), latent c_kv (b,s,r), roped k_rope (b,s,rd)."""
    b, s, _ = x.shape
    q = rms_norm(x @ params["w_dq"], params["q_norm"]) @ params["w_uq"]
    q = q.reshape(b, s, n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim],
                                 dim=-1)
    q_rope = apply_rope(q_rope, positions, theta)
    c_kv, k_rope = torch.split(x @ params["w_dkv"],
                               [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_kv = rms_norm(c_kv, params["kv_norm"])
    k_rope = apply_rope(k_rope[:, :, None, :], positions, theta)[:, :, 0]
    return torch.cat([q_nope, q_rope], dim=-1), c_kv, k_rope


def _expand_kv(params, c_kv, n_heads, m: MLAConfig):
    """The latent -> per-head k_nope (b,t,h,nope) and v (b,t,h,v)."""
    b, t = c_kv.shape[:2]
    kv = (c_kv @ params["w_ukv"]).reshape(
        b, t, n_heads, m.qk_nope_head_dim + m.v_head_dim)
    return torch.split(kv, [m.qk_nope_head_dim, m.v_head_dim], dim=-1)


def _mla_sdpa(q, k_nope, k_rope, v, mask, m: MLAConfig):
    b, s, h, _ = q.shape
    t = k_nope.shape[1]
    k_rope_h = k_rope[:, :, None, :].expand(b, t, h, m.qk_rope_head_dim)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    scores = scores + torch.where(mask, 0.0, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.float())
    return out.to(v.dtype)


def mla_attention(params, x: torch.Tensor, *, n_heads: int, m: MLAConfig,
                  theta: float, causal: bool = True,
                  window: Optional[int] = None,
                  positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, c_kv, k_rope = _project(params, x, n_heads, m, positions, theta)
    k_nope, v = _expand_kv(params, c_kv, n_heads, m)
    qi, ki = positions[:, :, None], positions[:, None, :]
    if causal:
        mask = ki <= qi
    else:
        mask = torch.ones((1, s, s), dtype=torch.bool, device=x.device)
    if window is not None:
        mask = mask & (ki > qi - window)
    out = _mla_sdpa(q, k_nope, k_rope, v, mask[:, None], m)
    return out.reshape(b, s, -1) @ params["wo"]


class MLACache(NamedTuple):
    """The latent ring buffer.  ``decode_mla_attention`` writes ``c_kv``,
    ``k_rope`` and ``pos`` in place; ``index`` (next write offset, mod
    window) and ``last`` (largest position written, -1 when empty) are
    host integers, as in ``attention.KVCache``."""
    c_kv: torch.Tensor       # (b, window, kv_lora_rank): the latent
    k_rope: torch.Tensor     # (b, window, rope_dim)
    pos: torch.Tensor        # (window,) int32, -1 empty
    index: int
    last: int


def init_mla_cache(batch: int, window: int, m: MLAConfig, dtype: torch.dtype,
                   prefill_len: int = 0, device=None) -> MLACache:
    c_kv = torch.zeros((batch, window, m.kv_lora_rank), dtype=dtype,
                       device=device)
    k_rope = torch.zeros((batch, window, m.qk_rope_head_dim), dtype=dtype,
                         device=device)
    slots = torch.arange(window, dtype=torch.int32, device=device)
    if prefill_len:
        n = min(prefill_len, window)
        pos = torch.where(slots < n, prefill_len - n + slots, -1)
        return MLACache(c_kv, k_rope, pos.to(torch.int32), n % window,
                        prefill_len - 1)
    return MLACache(c_kv, k_rope, torch.full_like(slots, -1), 0, -1)


def decode_mla_attention(params, x: torch.Tensor, cache: MLACache, *,
                         n_heads: int, m: MLAConfig, theta: float,
                         position: Optional[int] = None,
                         window: Optional[int] = None):
    """One-token decode.  x: (b, 1, d_model).  Returns (y, new_cache)."""
    b = x.shape[0]
    if position is None:
        position = cache.last + 1
    position = int(position)
    pos_b = torch.full((b, 1), position, dtype=torch.int32, device=x.device)
    q, c_kv, k_rope = _project(params, x, n_heads, m, pos_b, theta)
    slot = cache.index % cache.c_kv.shape[1]
    cache.c_kv[:, slot] = c_kv[:, 0]
    cache.k_rope[:, slot] = k_rope[:, 0]
    cache.pos[slot] = position
    k_nope, v = _expand_kv(params, cache.c_kv, n_heads, m)
    valid = cache.pos >= 0
    if window is not None:
        valid = valid & (cache.pos > position - window)
    out = _mla_sdpa(q, k_nope, cache.k_rope, v, valid[None, None, None], m)
    y = out.reshape(b, 1, -1) @ params["wo"]
    return y, cache._replace(index=cache.index + 1,
                             last=max(cache.last, position))
