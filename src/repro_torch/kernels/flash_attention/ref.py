"""Plain PyTorch version of the flash-attention kernel: the causal GQA
attention of ``repro.kernels.flash_attention.ref``."""
from typing import Optional

import torch


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float, causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, S, D); k, v: (B, KV, S, D) -> (B, H, S, D) in q.dtype.

    Query head h reads KV head h // (H / KV); key j is visible to query i
    iff j <= i (causal) and j > i - window (window); masked scores are
    -1e30 before the softmax; all math in float32."""
    B, H, S, D = q.shape
    group = H // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
