"""Model assembly for the ported families; twin of
``repro.models.transformer``.

One ``nn.Module`` facade per family, built by :func:`build_model`:

    model = build_model(cfg, device="cuda")        # weights from seed 0
    logits, aux = model.forward({"tokens": tokens})  # train / prefill
    cache = model.init_cache(batch, prefill_len)     # decode
    logits, cache = model.decode_step(tokens, cache)

Ported: ``ssm`` (RWKV6) and ``hybrid`` (Zamba2: Mamba2 layers with ONE
shared attention block after every ``shared_attn_every`` of them).  The
parameters keep the JAX package's tree and names (``model["layers"][3]["tm"]
["w_r"]``, state-dict key ``layers.3.tm.w_r``, is the JAX leaf
``["layers"]["tm"]["w_r"][3]``); the layers, which JAX stacks on a
leading dim for ``lax.scan``, are an ``nn.ModuleList`` looped over in
Python.  They are held without gradients: this slice serves, and training
comes with a later one.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import dispatch
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, rwkv6
from repro_torch.models.common import (apply_ffn, dense_init, embed_init,
                                       init_ffn, layer_norm, rms_norm)


class Params(nn.Module):
    """A tree of parameters addressed like the JAX package's dict tree:
    ``p["tm"]["w_r"]``.  Dicts become ``Params``, lists ``nn.ModuleList``s,
    tensors parameters without gradients."""

    def __init__(self, tree: Dict[str, object]):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, Params(value))
            elif isinstance(value, list):
                self.add_module(name, nn.ModuleList(Params(t) for t in value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _init_dense_block(gen, cfg: ArchConfig, dt) -> dict:
    ones = lambda: torch.ones((cfg.d_model,), dtype=dt, device=gen.device)
    return {
        "ln1": ones(),
        "attn": attn.init_attention(gen, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.resolved_head_dim,
                                    cfg.qk_norm, dt),
        "ln2": ones(),
        "ffn": init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.activation, dt),
    }


def _apply_dense_block(p, x, cfg: ArchConfig, *, positions=None, causal=True,
                       window=None):
    h = attn.attention(p["attn"], rms_norm(x, p["ln1"]),
                       n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                       head_dim=cfg.resolved_head_dim, theta=cfg.rope_theta,
                       qk_norm=cfg.qk_norm, causal=causal, window=window,
                       positions=positions)
    x = x + h
    return x + apply_ffn(p["ffn"], rms_norm(x, p["ln2"]), cfg.activation)


def _init_rwkv_block(gen, cfg: ArchConfig, dt) -> dict:
    d = cfg.d_model
    full = lambda v: torch.full((d,), v, dtype=dt, device=gen.device)
    return {"ln1": full(1.0), "ln1b": full(0.0),
            "ln2": full(1.0), "ln2b": full(0.0),
            "tm": rwkv6.init_rwkv6(gen, d, cfg.d_ff, cfg.ssm, dt)}


def _init_mamba_block(gen, cfg: ArchConfig, dt) -> dict:
    return {"ln": torch.ones((cfg.d_model,), dtype=dt, device=gen.device),
            "mix": mamba2.init_mamba2(gen, cfg.d_model, cfg.ssm, dt)}


def _logits_out(p, x):
    return rms_norm(x, p["ln_f"]) @ p["unembed"]


class _ZooModel(Params):
    """What the two facades share: the parameter tree (``model["embed"]``),
    config, kernel policy, dtype and the JAX facade's ``Model`` methods."""

    def __init__(self, cfg: ArchConfig, tree: dict,
                 policy: dispatch.PolicyLike,
                 decode_window: Optional[int]):
        super().__init__(tree)
        self.cfg = cfg
        self.policy = dispatch.get_policy(policy)
        self.decode_window = decode_window
        self.dtype = _dtype(cfg)

    @property
    def device(self) -> torch.device:
        return self["embed"].device


# ----- rwkv6 ---------------------------------------------------------------

class RWKVModel(_ZooModel):
    """The ``ssm`` family (``repro.models.transformer._build_rwkv``)."""

    @staticmethod
    def init_tree(gen, cfg: ArchConfig, dt) -> dict:
        return {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
                "layers": [_init_rwkv_block(gen, cfg, dt)
                           for _ in range(cfg.n_layers)],
                "ln_f": torch.ones((cfg.d_model,), dtype=dt, device=gen.device),
                "unembed": dense_init(gen, cfg.d_model, cfg.vocab_size, dt)}

    def forward(self, batch):
        cfg, p = self.cfg, self
        x = p["embed"][batch["tokens"]]
        for lp in p["layers"]:
            h = rwkv6.rwkv6_time_mix(lp["tm"],
                                     layer_norm(x, lp["ln1"], lp["ln1b"]),
                                     cfg.ssm, policy=self.policy)
            x = x + h
            h = rwkv6.rwkv6_channel_mix(lp["tm"],
                                        layer_norm(x, lp["ln2"], lp["ln2b"]))
            x = x + h
        return _logits_out(p, x), {"aux": x.new_zeros((), dtype=torch.float32)}

    def init_cache(self, batch: int, prefill_len: int = 0):
        return [rwkv6.init_rwkv_cache(batch, self.cfg.d_model, self.cfg.ssm,
                                      self.dtype, self.device)
                for _ in range(self.cfg.n_layers)]

    def decode_step(self, tokens, cache, position=None):
        cfg, p = self.cfg, self
        x = p["embed"][tokens]
        new_cache = []
        for lp, lc in zip(p["layers"], cache):
            h, lc = rwkv6.rwkv6_step(lp["tm"],
                                     layer_norm(x, lp["ln1"], lp["ln1b"]),
                                     lc, cfg.ssm)
            x = x + h
            h, lc = rwkv6.rwkv6_channel_step(
                lp["tm"], layer_norm(x, lp["ln2"], lp["ln2b"]), lc)
            x = x + h
            new_cache.append(lc)
        return _logits_out(p, x), new_cache


# ----- zamba2 hybrid --------------------------------------------------------

class ZambaModel(_ZooModel):
    """The ``hybrid`` family (``repro.models.transformer._build_zamba``).
    The JAX package reshapes its stacked Mamba2 layers to (groups, group);
    here ``mamba`` lists all ``n_layers`` and layer i belongs to group
    i // group."""

    def __init__(self, cfg, tree, policy, decode_window):
        super().__init__(cfg, tree, policy, decode_window)
        self.group = cfg.shared_attn_every or cfg.n_layers
        self.n_groups = cfg.n_layers // self.group
        if self.n_groups * self.group != cfg.n_layers:
            raise ValueError(f"{cfg.n_layers} layers do not split into "
                             f"groups of {self.group}")

    @staticmethod
    def init_tree(gen, cfg: ArchConfig, dt) -> dict:
        return {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
                "mamba": [_init_mamba_block(gen, cfg, dt)
                          for _ in range(cfg.n_layers)],
                "shared": _init_dense_block(gen, cfg, dt),  # ONE shared block
                "ln_f": torch.ones((cfg.d_model,), dtype=dt, device=gen.device),
                "unembed": dense_init(gen, cfg.d_model, cfg.vocab_size, dt)}

    def _group(self, g: int) -> range:
        """Indices of the Mamba2 layers of group g."""
        return range(g * self.group, (g + 1) * self.group)

    def forward(self, batch):
        cfg, p = self.cfg, self
        x = p["embed"][batch["tokens"]]
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        shared = p["shared"]
        for g in range(self.n_groups):
            for i in self._group(g):
                lp = p["mamba"][i]
                x = x + mamba2.mamba2_forward(lp["mix"], rms_norm(x, lp["ln"]),
                                              cfg.ssm, policy=self.policy)
            # shared attention block (same params every group)
            x = _apply_dense_block(shared, x, cfg, positions=positions,
                                   window=cfg.sliding_window)
        return _logits_out(p, x), {"aux": x.new_zeros((), dtype=torch.float32)}

    def init_cache(self, batch: int, prefill_len: int = 0):
        cfg = self.cfg
        W = min(self.decode_window or (prefill_len + 128), prefill_len + 128)
        return {
            "mamba": [mamba2.init_mamba_cache(batch, cfg.d_model, cfg.ssm,
                                              self.dtype, self.device)
                      for _ in range(cfg.n_layers)],
            "attn": [attn.init_kv_cache(batch, W, cfg.n_kv_heads,
                                        cfg.resolved_head_dim, self.dtype,
                                        prefill_len, self.device)
                     for _ in range(self.n_groups)]}

    def decode_step(self, tokens, cache, position=None):
        cfg, p = self.cfg, self
        x = p["embed"][tokens]
        if position is None:
            position = max(c.last for c in cache["attn"]) + 1
        shared = p["shared"]
        new_m, new_a = list(cache["mamba"]), []
        for g in range(self.n_groups):
            for i in self._group(g):
                lp = p["mamba"][i]
                h, new_m[i] = mamba2.mamba2_step(
                    lp["mix"], rms_norm(x, lp["ln"]), cache["mamba"][i],
                    cfg.ssm)
                x = x + h
            h, gc_a = attn.decode_attention(
                shared["attn"], rms_norm(x, shared["ln1"]), cache["attn"][g],
                n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, theta=cfg.rope_theta,
                qk_norm=cfg.qk_norm, position=position,
                window=self.decode_window)
            new_a.append(gc_a)
            x = x + h
            x = x + apply_ffn(shared["ffn"], rms_norm(x, shared["ln2"]),
                              cfg.activation)
        return _logits_out(p, x), {"mamba": new_m, "attn": new_a}


_FAMILIES = {"ssm": RWKVModel, "hybrid": ZambaModel}


def build_model(cfg: ArchConfig, *, decode_window: Optional[int] = None,
                policy: dispatch.PolicyLike = None,
                device: DeviceLike = None) -> _ZooModel:
    """The facade of ``cfg``'s family, with weights drawn from a generator
    seeded with 0 on ``device`` (the card unless ``device="cpu"``);
    ``policy`` picks kernel or plain scans (``dispatch``);
    ``decode_window`` caps the decode ring buffer (None: the prefill length
    + 128)."""
    cls = _FAMILIES.get(cfg.family)
    if cls is None:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; the port builds "
            f"{sorted(_FAMILIES)} (ROADMAP queue A, item 13)")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    return cls(cfg, cls.init_tree(gen, cfg, _dtype(cfg)), policy,
               decode_window)
