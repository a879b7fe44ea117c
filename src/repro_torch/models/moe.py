"""Mixture-of-Experts FFN with sort-based capacity dispatch; twin of
``repro.models.moe``.

Tokens are sorted by expert id and scattered into per-expert capacity
buffers, so the expert matmuls cost E × capacity ≈ tokens × top_k ×
capacity_factor rows.  What decides which tokens a full expert drops is
the JAX package's, step for step: the router's ``top_k`` puts the lower
expert first on equal probabilities, the sort by expert is stable, and the
capacity is ``max(1, ⌊T·top_k·cf / E⌋)`` of the T tokens routed together
(at decode T is the batch, so requests of one batch compete for it).  Each
token sums its experts' outputs in ascending expert order in the
activation dtype, as the JAX scatter-add does, with no atomics: two runs
on the card agree bit for bit.

Aux loss: the load-balance term E · Σ_e mean(routed to e) · mean(p_e).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.models.common import (activation_fn, apply_ffn, dense_init,
                                       init_ffn)
from repro_torch.sharding.partition import (fsdp_gathered, replicated_like,
                                            reshape)


def _expert_stack(gen: torch.Generator, n: int, in_dim: int, out_dim: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """(n, in_dim, out_dim) of ``dense_init`` draws, one expert at a time:
    a float32 draw of a whole stack would need 4 bytes an element on top of
    the weights (15 GB for one of DeepSeek-V3's)."""
    out = torch.empty((n, in_dim, out_dim), dtype=dtype, device=gen.device)
    if out.is_meta:              # an abstract model draws nothing
        return out
    for e in range(n):
        out[e] = dense_init(gen, in_dim, out_dim, dtype)
    return out


def init_moe(gen: torch.Generator, d_model: int, cfg: MoEConfig,
             activation: str, dtype: torch.dtype) -> dict:
    names = (["w_gate", "w_up", "w_down"] if activation == "swiglu"
             else ["w_up", "w_down"])
    dims = ([(d_model, cfg.d_ff_expert)] * (len(names) - 1)
            + [(cfg.d_ff_expert, d_model)])
    p = {"router": dense_init(gen, d_model, cfg.n_experts, torch.float32),
         "experts": {name: _expert_stack(gen, cfg.n_experts, di, do, dtype)
                     for name, (di, do) in zip(names, dims)}}
    if cfg.n_shared:
        p["shared"] = init_ffn(gen, d_model, cfg.n_shared * cfg.d_ff_expert,
                               activation, dtype)
    return p


def _expert_ffn(experts, buf: torch.Tensor, activation: str) -> torch.Tensor:
    """buf: (E, C, d_model) -> (E, C, d_model); batched expert matmuls."""
    def w(name):
        return fsdp_gathered(experts[name])
    if activation == "swiglu":
        g = torch.nn.functional.silu(torch.bmm(buf, w("w_gate")))
        h = g * torch.bmm(buf, w("w_up"))
    else:
        h = torch.bmm(buf, w("w_up"))
        # as in the JAX package: every non-gated activation but squared ReLU
        # runs gelu in the experts
        h = activation_fn("squared_relu" if activation == "squared_relu"
                          else "gelu")(h)
    return torch.bmm(h, w("w_down"))


def route(params, xt: torch.Tensor, cfg: MoEConfig):
    """Router probabilities (T, E) in f32 and the top-k gates (renormalised)
    and experts (T, k), the larger probability first and, on equal ones,
    the lower expert (``jax.lax.top_k``'s order; ``torch.topk`` promises
    none)."""
    logits = (xt @ params["router"].to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate, expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert_idx = gate[:, :cfg.top_k], expert_idx[:, :cfg.top_k]
    return probs, gate / gate.sum(dim=-1, keepdim=True), expert_idx


def capacity(T: int, cfg: MoEConfig) -> int:
    """Rows each expert's buffer holds for T tokens routed together."""
    return int(max(1, (T * cfg.top_k * cfg.capacity_factor) // cfg.n_experts))


def dispatch_slots(flat_e: torch.Tensor, n_experts: int, cap: int):
    """The (token, expert) pairs sorted by expert, stably: ``order`` into
    the flat pairs, each pair's buffer row ``slot`` (``n_experts · cap`` for
    a pair its full expert drops) and ``keep``."""
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    # the first sorted pair of each pair's expert: its slot counts from there
    first = torch.searchsorted(se, se)
    pos = torch.arange(se.numel(), device=se.device) - first
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos,
                       torch.full_like(pos, n_experts * cap))
    return order, slot, keep


def apply_moe(params, x: torch.Tensor, cfg: MoEConfig, activation: str,
              local_dispatch: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (batch, seq, d_model).  Returns (y, aux_loss).

    local_dispatch: route, sort and scatter each example on its own (the
    capacity then counts one example's tokens), as the JAX package's vmap
    over the batch does."""
    if local_dispatch and x.shape[0] > 1:
        outs = [apply_moe(params, xb[None], cfg, activation) for xb in x]
        return (torch.cat([y for y, _ in outs]),
                torch.stack([a for _, a in outs]).mean())
    b, s, d = x.shape
    T, k, E = b * s, cfg.top_k, cfg.n_experts
    xt = x.reshape(T, d)
    probs, gate, expert_idx = route(params, xt, cfg)
    cap = capacity(T, cfg)
    # ---- sort-based dispatch ----
    flat_e = expert_idx.reshape(-1)                              # (T*k,)
    order, slot, keep = dispatch_slots(flat_e, E, cap)
    st = order // k                                              # token of each sorted pair
    buf = replicated_like(xt, torch.zeros((E * cap + 1, d), dtype=x.dtype,
                                          device=x.device))
    buf[slot] = xt[st]                   # the dropped pairs share the last row
    y_buf = reshape(_expert_ffn(params["experts"],
                                reshape(buf[:-1], E, cap, d), activation),
                    E * cap, d)
    y_tok = torch.where(keep[:, None], y_buf[slot.clamp(max=E * cap - 1)],
                        torch.zeros((), dtype=x.dtype, device=x.device))
    contrib = replicated_like(y_tok, torch.empty(
        y_tok.shape, dtype=y_tok.dtype, device=y_tok.device))
    contrib[order] = y_tok * gate.reshape(-1)[order][:, None].to(x.dtype)
    # each token's k contributions in ascending expert order, summed one
    # after another in x.dtype (the JAX scatter-add's order)
    by_expert = torch.argsort(expert_idx, dim=-1)
    contrib = contrib.reshape(T, k, d).gather(
        1, by_expert[:, :, None].expand(T, k, d))
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]

    if "shared" in params:
        out = out + apply_ffn(params["shared"], xt, activation)

    # load-balance auxiliary loss (Switch/DeepSeek style)
    routed = torch.zeros_like(probs).scatter_(1, expert_idx, 1.0)
    aux = E * torch.sum(routed.mean(dim=0) * probs.mean(dim=0))
    return reshape(out, b, s, d), aux
