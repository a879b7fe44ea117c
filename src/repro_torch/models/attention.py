"""GQA / MQA / MHA attention with RoPE, qk-norm, sliding windows and a
ring-buffer KV cache for decode; twin of ``repro.models.attention``.

Shapes: activations are (batch, seq, d_model); caches are
(batch, window, n_kv_heads, head_dim) ring buffers.  ``_sdpa`` is the JAX
package's plain float32 einsum-softmax; no fused attention kernel is called
(the JAX models call none either).  ``memory=`` turns ``attention`` into the
encoder-decoder's cross-attention, whose decode path reads K/V computed
once from the memory (``cross_attention_kv``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.models.common import apply_rope, dense_init, rms_norm

NEG_INF = -1e30


def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, qk_norm: bool,
                   dtype: torch.dtype) -> dict:
    p = {
        "wq": dense_init(gen, d_model, n_heads * head_dim, dtype),
        "wk": dense_init(gen, d_model, n_kv_heads * head_dim, dtype),
        "wv": dense_init(gen, d_model, n_kv_heads * head_dim, dtype),
        "wo": dense_init(gen, n_heads * head_dim, d_model, dtype),
    }
    if qk_norm:
        p["q_norm"] = torch.ones((head_dim,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.ones((head_dim,), dtype=dtype, device=gen.device)
    return p


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    """q: (b,s,h,hd)  k,v: (b,t,kv,hd)  mask: (b,1,s,t) or (1,1,s,t)."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    groups = h // kv
    q = q.reshape(b, s, kv, groups, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", q.float(),
                          k.float()) / math.sqrt(hd)
    scores = scores + torch.where(mask[:, :, None], 0.0, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(b, s, h, hd).to(v.dtype)


def attention(params, x: torch.Tensor, *, n_heads: int, n_kv_heads: int,
              head_dim: int, theta: float, qk_norm: bool = False,
              causal: bool = True, window: Optional[int] = None,
              positions: Optional[torch.Tensor] = None,
              memory: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention (training / prefill).  ``memory`` switches to
    cross-attention (no RoPE and no causal mask on the memory; the enc-dec
    decoder's)."""
    b, s, _ = x.shape
    q = _split_heads(x @ params["wq"], n_heads, head_dim)
    src = memory if memory is not None else x
    t = src.shape[1]
    k = _split_heads(src @ params["wk"], n_kv_heads, head_dim)
    v = _split_heads(src @ params["wv"], n_kv_heads, head_dim)
    if qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if memory is None:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
        qi = positions[:, :, None]          # (b,s,1)
        ki = positions[:, None, :]          # (b,1,t)
        if causal:
            mask = ki <= qi
        else:
            mask = torch.ones((1, s, t), dtype=torch.bool, device=x.device)
        if window is not None:
            mask = mask & (ki > qi - window)
        mask = mask[:, None]                 # (b,1,s,t)
    else:
        mask = torch.ones((1, 1, s, t), dtype=torch.bool, device=x.device)
    out = _sdpa(q, k, v, mask)
    return out.reshape(b, s, n_heads * head_dim) @ params["wo"]


# ---------------------------------------------------------------------------
# Decode path: ring-buffer KV cache
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """The ring buffer.  ``decode_attention`` writes ``k``, ``v`` and ``pos``
    in place and returns the cache with ``index`` and ``last`` advanced.
    ``index`` (next write offset, mod window) and ``last`` (the largest
    position written, -1 when empty: the JAX package's ``max(pos)``) are
    host integers, so a decode step needs no device-to-host copy."""
    k: torch.Tensor          # (b, window, n_kv, hd)
    v: torch.Tensor          # (b, window, n_kv, hd)
    pos: torch.Tensor        # (window,) int32 absolute position of each slot, -1 empty
    index: int
    last: int


def init_kv_cache(batch: int, window: int, n_kv_heads: int, head_dim: int,
                  dtype: torch.dtype, prefill_len: int = 0,
                  device=None) -> KVCache:
    """An (optionally pre-filled-to-`prefill_len`) ring-buffer cache."""
    k = torch.zeros((batch, window, n_kv_heads, head_dim), dtype=dtype,
                    device=device)
    v = torch.zeros_like(k)
    slots = torch.arange(window, dtype=torch.int32, device=device)
    if prefill_len:
        # slots [0, min(prefill, window)) hold the last prefill positions
        n = min(prefill_len, window)
        pos = torch.where(slots < n, prefill_len - n + slots, -1)
        return KVCache(k, v, pos.to(torch.int32), n % window, prefill_len - 1)
    return KVCache(k, v, torch.full_like(slots, -1), 0, -1)


def decode_attention(params, x: torch.Tensor, cache: KVCache, *,
                     n_heads: int, n_kv_heads: int, head_dim: int,
                     theta: float, qk_norm: bool = False,
                     position: Optional[int] = None,
                     window: Optional[int] = None):
    """One-token decode.  x: (b, 1, d_model).  Returns (y, new_cache)."""
    b = x.shape[0]
    if position is None:
        position = cache.last + 1
    position = int(position)
    q = _split_heads(x @ params["wq"], n_heads, head_dim)
    k = _split_heads(x @ params["wk"], n_kv_heads, head_dim)
    v = _split_heads(x @ params["wv"], n_kv_heads, head_dim)
    if qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    pos_b = torch.full((b, 1), position, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos_b, theta)
    k = apply_rope(k, pos_b, theta)
    # ring-buffer write, in place
    slot = cache.index % cache.k.shape[1]
    cache.k[:, slot] = k[:, 0]
    cache.v[:, slot] = v[:, 0]
    cache.pos[slot] = position
    valid = cache.pos >= 0
    if window is not None:
        valid = valid & (cache.pos > position - window)
    mask = valid[None, None, None, :]        # (1,1,1,W)
    out = _sdpa(q, cache.k, cache.v, mask)
    y = out.reshape(b, 1, n_heads * head_dim) @ params["wo"]
    return y, cache._replace(index=cache.index + 1,
                             last=max(cache.last, position))


def cross_attention_kv(params, memory: torch.Tensor, *, n_kv_heads: int,
                       head_dim: int):
    """Cross-attention K/V of the encoder memory, computed once for the
    enc-dec decode."""
    k = _split_heads(memory @ params["wk"], n_kv_heads, head_dim)
    v = _split_heads(memory @ params["wv"], n_kv_heads, head_dim)
    return k, v


def decode_cross_attention(params, x: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, n_heads: int,
                           head_dim: int) -> torch.Tensor:
    b = x.shape[0]
    q = _split_heads(x @ params["wq"], n_heads, head_dim)
    mask = torch.ones((1, 1, 1, k.shape[1]), dtype=torch.bool,
                      device=x.device)
    out = _sdpa(q, k, v, mask)
    return out.reshape(b, 1, n_heads * head_dim) @ params["wo"]
