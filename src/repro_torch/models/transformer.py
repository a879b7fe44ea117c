"""Model assembly for the ported families; twin of
``repro.models.transformer``.

One ``nn.Module`` facade per family, built by :func:`build_model`:

    model = build_model(cfg, device="cuda")        # weights from seed 0
    logits, aux = model.forward({"tokens": tokens})  # train / prefill
    init_state, train_step = make_train_step(model)  # runtime.steps
    cache = model.init_cache(batch, prefill_len)     # decode
    logits, cache = model.decode_step(tokens, cache)

Every family of the JAX package: ``dense``, ``vlm`` and ``moe`` (one
decoder: GQA or MLA attention, a dense or MoE FFN, tied embeddings, a
vision prefix, DeepSeek-V3's multi-token-prediction head), ``ssm`` (RWKV6),
``hybrid`` (Zamba2: Mamba2 layers with ONE shared attention block after
every ``shared_attn_every`` of them) and ``audio`` (the Seamless
encoder-decoder, ``model.encode(embeds)`` and ``init_cache(...,
memory=)``).  The parameters keep the JAX package's tree and names
(``model["layers"][3]["tm"]["w_r"]``, state-dict key ``layers.3.tm.w_r``,
is the JAX leaf ``["layers"]["tm"]["w_r"][3]``); the layers, which JAX
stacks on a leading dim for ``lax.scan``, are an ``nn.ModuleList`` looped
over in Python.  They are held without gradients until a train step's
``init_state`` turns them on.

Remat (``build_model(remat=True)``, the JAX package's default) recomputes
the bodies the JAX package wraps in ``jax.checkpoint`` in the backward
pass: each decoder, encoder and RWKV layer and each Zamba2 Mamba2 layer
(not its shared attention block), through ``torch.utils.checkpoint``.
``remat_policy="dots"`` (the decoder's only, as in the JAX package) keeps
the weight GEMMs' outputs and recomputes the rest, the batched attention
products among it: ``checkpoint_dots_with_no_batch_dims``.  Remat acts
only under autograd with the parameters' gradients on, so serving runs as
without it.  The JAX package's ``unroll=`` has no counterpart: the layers
here are a Python loop already.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch import nn
from torch.utils import checkpoint as _checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import dispatch
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, mla, moe, rwkv6
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

    def __contains__(self, name: str) -> bool:
        return name in self._modules or name in self._parameters

    def tree(self) -> dict:
        """The parameters as a nested dict of tensors (layers as lists),
        for ``repro_torch.checkpoint.io.save`` / ``restore``."""
        out = dict(self._parameters)
        for name, mod in self._modules.items():
            out[name] = ([m.tree() for m in mod]
                         if isinstance(mod, nn.ModuleList) else mod.tree())
        return out


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


def _init_moe_block(gen, cfg: ArchConfig, dt) -> dict:
    ones = lambda: torch.ones((cfg.d_model,), dtype=dt, device=gen.device)
    if cfg.attention_kind == "mla":
        a = mla.init_mla(gen, cfg.d_model, cfg.n_heads, cfg.mla, dt)
    else:
        a = attn.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.resolved_head_dim, cfg.qk_norm, dt)
    return {"ln1": ones(), "ln2": ones(), "attn": a,
            "moe": moe.init_moe(gen, cfg.d_model, cfg.moe, cfg.activation,
                                dt)}


def _apply_moe_block(p, x, cfg: ArchConfig, *, positions=None, window=None,
                     moe_local: bool = False):
    xin = rms_norm(x, p["ln1"])
    if cfg.attention_kind == "mla":
        h = mla.mla_attention(p["attn"], xin, n_heads=cfg.n_heads, m=cfg.mla,
                              theta=cfg.rope_theta, window=window,
                              positions=positions)
    else:
        h = attn.attention(p["attn"], xin, n_heads=cfg.n_heads,
                           n_kv_heads=cfg.n_kv_heads,
                           head_dim=cfg.resolved_head_dim,
                           theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
                           window=window, positions=positions)
    x = x + h
    y, aux = moe.apply_moe(p["moe"], rms_norm(x, p["ln2"]), cfg.moe,
                           cfg.activation, local_dispatch=moe_local)
    return x + y, aux


def _init_rwkv_block(gen, cfg: ArchConfig, dt) -> dict:
    d = cfg.d_model
    full = lambda v: torch.full((d,), v, dtype=dt, device=gen.device)
    return {"ln1": full(1.0), "ln1b": full(0.0),
            "ln2": full(1.0), "ln2b": full(0.0),
            "tm": rwkv6.init_rwkv6(gen, d, cfg.d_ff, cfg.ssm, dt)}


def _init_mamba_block(gen, cfg: ArchConfig, dt) -> dict:
    return {"ln": torch.ones((cfg.d_model,), dtype=dt, device=gen.device),
            "mix": mamba2.init_mamba2(gen, cfg.d_model, cfg.ssm, dt)}


def _logits_out(p, x, tied: bool = False):
    w = p["embed"].T if tied else p["unembed"]
    return rms_norm(x, p["ln_f"]) @ w


# remat_policy="dots": save what the weight GEMMs (x @ W, no batch dims)
# return, recompute everything else
_DOTS = functools.partial(_checkpoint.create_selective_checkpoint_contexts,
                          [torch.ops.aten.mm.default,
                           torch.ops.aten.addmm.default])
REMAT_POLICIES = (None, "dots")


def _window(prefill_len: int, decode_window: Optional[int]) -> int:
    """Slots of a decode ring buffer: the prefill + 128, or the window."""
    return min(decode_window or (prefill_len + 128), prefill_len + 128)


class _ZooModel(Params):
    """What the two facades share: the parameter tree (``model["embed"]``),
    config, kernel policy, dtype and the JAX facade's ``Model`` methods."""

    def __init__(self, cfg: ArchConfig, tree: dict,
                 policy: dispatch.PolicyLike,
                 decode_window: Optional[int], remat: bool = True,
                 remat_policy: Optional[str] = None):
        super().__init__(tree)
        self.cfg = cfg
        self.policy = dispatch.get_policy(policy)
        self.decode_window = decode_window
        self.dtype = _dtype(cfg)
        self.remat = remat
        self.remat_policy = remat_policy

    @property
    def device(self) -> torch.device:
        return self["embed"].device

    def _remat(self, fn, *args, policy: Optional[str] = None):
        """fn(*args), recomputed in the backward pass when remat is on and
        autograd records the parameters; ``policy="dots"`` saves the
        weight GEMMs."""
        if not (self.remat and torch.is_grad_enabled()
                and self["embed"].requires_grad):
            return fn(*args)
        kw = {"context_fn": _DOTS} if policy == "dots" else {}
        return _checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                      preserve_rng_state=False, **kw)


# ----- dense / vlm / moe decoder ------------------------------------------

class DecoderModel(_ZooModel):
    """The ``dense``, ``vlm`` and ``moe`` families
    (``repro.models.transformer._build_decoder``): full causal attention in
    the forward pass, a ring-buffer cache (GQA's K/V or MLA's latent) in
    decode.  ``forward`` returns ``{"aux": …}`` (the MoE load-balance term
    summed over the layers, 0 for a dense model) and, with ``cfg.mtp``,
    ``"mtp_logits"``."""

    def __init__(self, cfg, tree, policy, decode_window,
                 moe_local_dispatch: bool = False, **remat):
        super().__init__(cfg, tree, policy, decode_window, **remat)
        self.moe_local = moe_local_dispatch

    @staticmethod
    def init_tree(gen, cfg: ArchConfig, dt) -> dict:
        block = _init_moe_block if cfg.family == "moe" else _init_dense_block
        p = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
             "layers": [block(gen, cfg, dt) for _ in range(cfg.n_layers)],
             "ln_f": torch.ones((cfg.d_model,), dtype=dt, device=gen.device)}
        if not cfg.tie_embeddings:
            p["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt)
        if cfg.frontend:
            p["frontend_proj"] = dense_init(gen, cfg.d_model, cfg.d_model, dt)
        if cfg.mtp:
            p["mtp_block"] = block(gen, cfg, dt)
            p["mtp_proj"] = dense_init(gen, 2 * cfg.d_model, cfg.d_model, dt)
        return p

    def _block(self, lp, x, positions):
        """One layer of the forward pass: (x, its aux term)."""
        if self.cfg.family == "moe":
            return _apply_moe_block(lp, x, self.cfg, positions=positions,
                                    moe_local=self.moe_local)
        return _apply_dense_block(lp, x, self.cfg, positions=positions), None

    def forward(self, batch):
        cfg, p = self.cfg, self
        tokens = batch["tokens"]
        x = p["embed"][tokens]
        embeds = batch.get("embeds")
        if cfg.frontend and embeds is not None:
            # the stub frontend's patch embeddings, a prefix of the tokens
            x = torch.cat([embeds.to(x.dtype) @ p["frontend_proj"], x], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        aux = x.new_zeros((), dtype=torch.float32)
        for lp in p["layers"]:
            x, a = self._remat(self._block, lp, x, positions,
                               policy=self.remat_policy)
            if a is not None:
                aux = aux + a
        logits = _logits_out(p, x, cfg.tie_embeddings)
        if not cfg.mtp:
            return logits, {"aux": aux}
        # DeepSeek-V3 multi-token prediction: one extra block predicts t+2
        # from [h_t ; emb(tok_{t+1})] (the last position wraps to token 0)
        emb_next = torch.roll(p["embed"][tokens], -1, dims=1)
        pad = x.shape[1] - emb_next.shape[1]
        if pad:
            emb_next = torch.nn.functional.pad(emb_next, (0, 0, pad, 0))
        h = torch.cat([x, emb_next], dim=-1) @ p["mtp_proj"]
        h, a = self._block(p["mtp_block"], h, positions)
        if a is not None:
            aux = aux + a
        return logits, {"aux": aux,
                        "mtp_logits": _logits_out(p, h, cfg.tie_embeddings)}

    def init_cache(self, batch: int, prefill_len: int = 0):
        cfg = self.cfg
        W = _window(prefill_len, self.decode_window)
        if cfg.attention_kind == "mla":
            return [mla.init_mla_cache(batch, W, cfg.mla, self.dtype,
                                       prefill_len, self.device)
                    for _ in range(cfg.n_layers)]
        return [attn.init_kv_cache(batch, W, cfg.n_kv_heads,
                                   cfg.resolved_head_dim, self.dtype,
                                   prefill_len, self.device)
                for _ in range(cfg.n_layers)]

    def decode_step(self, tokens, cache, position=None):
        cfg, p = self.cfg, self
        x = p["embed"][tokens]                      # (b, 1, d)
        if position is None:
            position = max(c.last for c in cache) + 1
        new_cache = []
        for lp, lc in zip(p["layers"], cache):
            xin = rms_norm(x, lp["ln1"])
            if cfg.attention_kind == "mla":
                h, lc = mla.decode_mla_attention(
                    lp["attn"], xin, lc, n_heads=cfg.n_heads, m=cfg.mla,
                    theta=cfg.rope_theta, position=position,
                    window=self.decode_window)
            else:
                h, lc = attn.decode_attention(
                    lp["attn"], xin, lc, n_heads=cfg.n_heads,
                    n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
                    theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
                    position=position, window=self.decode_window)
            new_cache.append(lc)
            x = x + h
            xin = rms_norm(x, lp["ln2"])
            if cfg.family == "moe":
                y, _ = moe.apply_moe(lp["moe"], xin, cfg.moe, cfg.activation)
            else:
                y = apply_ffn(lp["ffn"], xin, cfg.activation)
            x = x + y
        return _logits_out(p, x, cfg.tie_embeddings), new_cache


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

    def _block(self, lp, x):
        h = rwkv6.rwkv6_time_mix(lp["tm"], layer_norm(x, lp["ln1"], lp["ln1b"]),
                                 self.cfg.ssm, policy=self.policy)
        x = x + h
        h = rwkv6.rwkv6_channel_mix(lp["tm"],
                                    layer_norm(x, lp["ln2"], lp["ln2b"]))
        return x + h

    def forward(self, batch):
        p = self
        x = p["embed"][batch["tokens"]]
        for lp in p["layers"]:
            x = self._remat(self._block, lp, x)
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

    def __init__(self, cfg, tree, policy, decode_window, **remat):
        super().__init__(cfg, tree, policy, decode_window, **remat)
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

    def _mamba_body(self, lp, x):
        return x + mamba2.mamba2_forward(lp["mix"], rms_norm(x, lp["ln"]),
                                         self.cfg.ssm, policy=self.policy)

    def forward(self, batch):
        cfg, p = self.cfg, self
        x = p["embed"][batch["tokens"]]
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        shared = p["shared"]
        for g in range(self.n_groups):
            for i in self._group(g):
                x = self._remat(self._mamba_body, p["mamba"][i], x)
            # shared attention block (same params every group)
            x = _apply_dense_block(shared, x, cfg, positions=positions,
                                   window=cfg.sliding_window)
        return _logits_out(p, x), {"aux": x.new_zeros((), dtype=torch.float32)}

    def init_cache(self, batch: int, prefill_len: int = 0):
        cfg = self.cfg
        W = _window(prefill_len, self.decode_window)
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


# ----- seamless enc-dec -----------------------------------------------------

def _init_dec_block(gen, cfg: ArchConfig, dt) -> dict:
    ones = lambda: torch.ones((cfg.d_model,), dtype=dt, device=gen.device)
    a = lambda qk_norm: attn.init_attention(
        gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
        qk_norm, dt)
    return {"ln1": ones(), "self": a(cfg.qk_norm),
            "ln_x": ones(), "cross": a(False),
            "ln2": ones(),
            "ffn": init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.activation, dt)}


class EncDecModel(_ZooModel):
    """The ``audio`` family (``repro.models.transformer._build_encdec``):
    the stub frontend's frame embeddings through ``frontend_proj`` and a
    non-causal encoder make the memory; each decoder layer runs causal
    self-attention, cross-attention on the memory and the FFN.  The decode
    cache holds the self-attention ring buffers and each layer's cross K/V,
    computed once from the memory (zeros unless one is given, as in the
    JAX package)."""

    @staticmethod
    def init_tree(gen, cfg: ArchConfig, dt) -> dict:
        return {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
                "frontend_proj": dense_init(gen, cfg.d_model, cfg.d_model,
                                            dt),
                "enc_layers": [_init_dense_block(gen, cfg, dt)
                               for _ in range(cfg.enc_layers)],
                "dec_layers": [_init_dec_block(gen, cfg, dt)
                               for _ in range(cfg.n_layers)],
                "ln_f": torch.ones((cfg.d_model,), dtype=dt, device=gen.device),
                "unembed": dense_init(gen, cfg.d_model, cfg.vocab_size, dt)}

    def _attn_kw(self) -> dict:
        cfg = self.cfg
        return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.resolved_head_dim, theta=cfg.rope_theta)

    def encode(self, embeds: torch.Tensor) -> torch.Tensor:
        """Frame embeddings (b, frames, d_model) -> the memory."""
        x = embeds.to(self.dtype) @ self["frontend_proj"]
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        body = functools.partial(_apply_dense_block, cfg=self.cfg,
                                 positions=pos, causal=False)
        for lp in self["enc_layers"]:
            x = self._remat(body, lp, x)
        return x

    def _dec_body(self, lp, x, memory, pos):
        x = x + attn.attention(lp["self"], rms_norm(x, lp["ln1"]),
                               positions=pos, **self._attn_kw())
        x = x + attn.attention(lp["cross"], rms_norm(x, lp["ln_x"]),
                               memory=memory, **self._attn_kw())
        return x + apply_ffn(lp["ffn"], rms_norm(x, lp["ln2"]),
                             self.cfg.activation)

    def forward(self, batch):
        p = self
        memory = self.encode(batch["embeds"])
        x = p["embed"][batch["tokens"]]
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        for lp in p["dec_layers"]:
            x = self._remat(self._dec_body, lp, x, memory, pos)
        return _logits_out(p, x), {"aux": x.new_zeros((), dtype=torch.float32)}

    def init_cache(self, batch: int, prefill_len: int = 0,
                   memory: Optional[torch.Tensor] = None):
        cfg = self.cfg
        W = _window(prefill_len, self.decode_window)
        if memory is None:
            memory = torch.zeros((batch, cfg.frontend_positions, cfg.d_model),
                                 dtype=self.dtype, device=self.device)
        kv = [attn.cross_attention_kv(lp["cross"], memory,
                                      n_kv_heads=cfg.n_kv_heads,
                                      head_dim=cfg.resolved_head_dim)
              for lp in self["dec_layers"]]
        return {"self": [attn.init_kv_cache(batch, W, cfg.n_kv_heads,
                                            cfg.resolved_head_dim, self.dtype,
                                            prefill_len, self.device)
                         for _ in range(cfg.n_layers)],
                "cross_k": [k for k, _ in kv], "cross_v": [v for _, v in kv]}

    def decode_step(self, tokens, cache, position=None):
        cfg, p = self.cfg, self
        x = p["embed"][tokens]
        if position is None:
            position = max(c.last for c in cache["self"]) + 1
        new_self = []
        for lp, lc, ck, cv in zip(p["dec_layers"], cache["self"],
                                  cache["cross_k"], cache["cross_v"]):
            h, lc = attn.decode_attention(
                lp["self"], rms_norm(x, lp["ln1"]), lc, position=position,
                window=self.decode_window, **self._attn_kw())
            new_self.append(lc)
            x = x + h
            x = x + attn.decode_cross_attention(
                lp["cross"], rms_norm(x, lp["ln_x"]), ck, cv,
                n_heads=cfg.n_heads, head_dim=cfg.resolved_head_dim)
            x = x + apply_ffn(lp["ffn"], rms_norm(x, lp["ln2"]),
                              cfg.activation)
        return _logits_out(p, x), {**cache, "self": new_self}


_FAMILIES = {"dense": DecoderModel, "vlm": DecoderModel, "moe": DecoderModel,
             "ssm": RWKVModel, "hybrid": ZambaModel, "audio": EncDecModel}


def build_model(cfg: ArchConfig, *, remat: bool = True,
                remat_policy: Optional[str] = None,
                decode_window: Optional[int] = None,
                policy: dispatch.PolicyLike = None,
                device: DeviceLike = None,
                moe_local_dispatch: bool = False) -> _ZooModel:
    """The facade of ``cfg``'s family, with weights drawn from a generator
    seeded with 0 on ``device`` (the card unless ``device="cpu"``);
    ``remat`` / ``remat_policy`` (None or ``"dots"``, the decoder's) set
    the backward pass's recomputation (see the module); ``policy`` picks
    kernel or plain scans (``dispatch``; training needs the plain ones,
    ``policy="reference"``); ``decode_window`` caps the decode ring buffer
    (None: the prefill length + 128); ``moe_local_dispatch`` routes each
    example of an MoE forward pass on its own
    (``moe.apply_moe(local_dispatch=)``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    return _assemble(cfg, gen, remat, remat_policy, decode_window, policy,
                     moe_local_dispatch)


def _assemble(cfg, gen, remat, remat_policy, decode_window, policy,
              moe_local_dispatch):
    cls = _FAMILIES.get(cfg.family)
    if cls is None:
        raise ValueError(f"unsupported family {cfg.family!r} for the "
                         f"transformer zoo")
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {remat_policy!r}; have "
                         f"{REMAT_POLICIES}")
    tree = cls.init_tree(gen, cfg, _dtype(cfg))
    kw = dict(remat=remat, remat_policy=remat_policy)
    if cls is DecoderModel:
        return cls(cfg, tree, policy, decode_window, moe_local_dispatch, **kw)
    return cls(cfg, tree, policy, decode_window, **kw)


class _MetaGenerator(torch.Generator):
    """A CPU generator that says it lives on the ``meta`` device: the
    initializers then make meta tensors (shapes and dtypes, no storage)
    and draw nothing."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def build_abstract_model(cfg: ArchConfig, *, remat: bool = True,
                         remat_policy: Optional[str] = None,
                         decode_window: Optional[int] = None,
                         moe_local_dispatch: bool = False) -> _ZooModel:
    """``build_model`` on the ``meta`` device: every parameter has its
    shape and dtype and no storage, so a full-size config costs nothing
    (the twin of ``jax.eval_shape`` over ``model.init``).  The scans take
    their plain versions (``policy="reference"``; ``dispatch.mamba2_scan``
    its chunked form outside autograd): the CUDA ops take no meta
    tensors.  Only the dry-run's specs build here; the entry points build
    on a real device."""
    return _assemble(cfg, _MetaGenerator(), remat, remat_policy,
                     decode_window, "reference", moe_local_dispatch)
