"""The paper's model substrate: an MLP ("ten-layer DNN", §V-A) split into
the client-side model c(·), the server-side model s(·) and the *inverse*
server-side model s⁻¹(·); port of ``repro.core.dnn``.

Parameters are a list of ``{"w", "b"}`` dicts per layer.  A layer's weights
are either global — ``w`` (d_in, d_out), ``b`` (d_out,) — or stacked over a
client axis — ``w`` (M, d_in, d_out), ``b`` (M, d_out) with inputs
(M, batch, d_in) — which stands in for the JAX package's vmap over clients.

Under a mixed ``Precision`` (``repro_torch.kernels.dispatch.BF16``) each
layer multiplies its bf16 input by its bf16-cast weight with f32
accumulation and an f32 result, adds the bias in f32, and hands on its
activation in bf16; master parameters stay f32.  The backward rounds where
the reference's autodiff does: each weight gradient and each layer input's
cotangent to bf16, the bias gradient not (``_MixedLinear``).
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from repro_torch.configs.splitme_dnn import DNNConfig
from repro_torch.models.common import activation_fn

Layers = List[dict]


def init_mlp(generator: torch.Generator, dims: Sequence[int],
             device: torch.device) -> Layers:
    """Stack of {w, b} with He init, drawn from ``generator`` (a CPU
    generator, so the same seed gives the same weights on every device)."""
    layers = []
    for i in range(len(dims) - 1):
        w = torch.randn(dims[i], dims[i + 1], generator=generator)
        w = w * math.sqrt(2.0 / dims[i])
        layers.append({"w": w.to(device),
                       "b": torch.zeros(dims[i + 1], device=device)})
    return layers


def _linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    w, b = p["w"], p["b"]
    if w.dim() == 3:                  # per-client stacked weights
        return torch.baddbmm(b.unsqueeze(1), x, w)
    return x @ w + b


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of two bf16 operands, accumulated in f32 with an f32 result
    (a (n, k) or (C, n, k), b (k, m) or (C, k, m)).  On the card one GEMM
    with an f32 output (``out_dtype``); on the CPU, which has no such GEMM,
    the operands widened to f32 (exact) and multiplied in f32.  A plain
    bf16 @ bf16 would round its OUTPUT to bf16, which the reference never
    does."""
    if a.device.type != "cuda":
        return a.float() @ b.float()
    if b.dim() == 3:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.mm(a.reshape(-1, a.shape[-1]), b,
                    out_dtype=torch.float32).reshape(*a.shape[:-1],
                                                     b.shape[-1])


def _t(t: torch.Tensor) -> torch.Tensor:
    return t.transpose(-1, -2)


class _MixedLinear(torch.autograd.Function):
    """z = h @ bf16(w) + b in f32 for a bf16 input h and f32 master w, b
    (global or client-stacked).  Its backward is the reference's autodiff
    through ``dot(h, w.astype(bf16), preferred_element_type=f32) + b``:
    from the f32 cotangent dz, dw = bf16(hᵀ dz) widened to f32 (the
    transpose of the weight's cast), db = Σ dz in f32, and dh = bf16(dz ·
    bf16(w)ᵀ) (h's dtype); the products run in f32 on the exact widened
    bf16 values."""

    @staticmethod
    def forward(ctx, h, w, b):
        wc = w.to(h.dtype)
        ctx.save_for_backward(h, wc)
        ctx.stacked = w.dim() == 3
        z = _matmul_f32(h, wc)
        return z + (b.unsqueeze(1) if ctx.stacked else b)

    @staticmethod
    def backward(ctx, dz):
        h, wc = ctx.saved_tensors
        dh = dw = db = None
        if ctx.needs_input_grad[0]:
            dh = (dz @ _t(wc).float()).to(h.dtype)
        if ctx.needs_input_grad[1]:
            hf = h.float()
            if ctx.stacked:
                dw = _t(hf) @ dz
            else:
                dw = (hf.reshape(-1, hf.shape[-1]).T
                      @ dz.reshape(-1, dz.shape[-1]))
            dw = dw.to(wc.dtype).float()
        if ctx.needs_input_grad[2]:
            db = dz.sum(-2) if ctx.stacked else dz.reshape(
                -1, dz.shape[-1]).sum(0)
        return dh, dw, db


def mlp_forward(layers: Layers, x: torch.Tensor, activation: str = "relu",
                final_linear: bool = True, precision=None) -> torch.Tensor:
    """Forward pass; the last layer stays linear when ``final_linear``
    (logits, in f32), else it is activated too (smashed data: in the
    compute dtype under a mixed ``precision``, the 16-bit payload that
    crosses the split).  ``precision`` None or f32: all in f32."""
    act = activation_fn(activation)
    if precision is None or not precision.is_mixed:
        for i, p in enumerate(layers):
            x = _linear(p, x)
            if i < len(layers) - 1 or not final_linear:
                x = act(x)
        return x
    cdt = precision.compute_dtype
    h = x.to(cdt)
    for i, p in enumerate(layers):
        h = _MixedLinear.apply(h, p["w"], p["b"])
        if i < len(layers) - 1 or not final_linear:
            h = act(h).to(cdt)
    return h


def mlp_activations(layers: Layers, x: torch.Tensor,
                    activation: str = "relu") -> List[torch.Tensor]:
    """All post-layer activations [a_1 … a_L] (last one linear)."""
    act = activation_fn(activation)
    outs = []
    for i, p in enumerate(layers):
        x = _linear(p, x)
        if i < len(layers) - 1:
            x = act(x)
        outs.append(x)
    return outs


def client_dims(cfg: DNNConfig) -> Tuple[int, ...]:
    return cfg.layer_dims[: cfg.split_index + 1]


def server_dims(cfg: DNNConfig) -> Tuple[int, ...]:
    return cfg.layer_dims[cfg.split_index:]


def inverse_server_dims(cfg: DNNConfig) -> Tuple[int, ...]:
    return tuple(reversed(server_dims(cfg)))


def init_client(generator, cfg: DNNConfig, device) -> Layers:
    return init_mlp(generator, client_dims(cfg), device)


def init_server(generator, cfg: DNNConfig, device) -> Layers:
    return init_mlp(generator, server_dims(cfg), device)


def init_inverse_server(generator, cfg: DNNConfig, device) -> Layers:
    return init_mlp(generator, inverse_server_dims(cfg), device)


def client_forward(params: Layers, x: torch.Tensor, cfg: DNNConfig,
                   precision=None) -> torch.Tensor:
    """c(X): features at the split layer (post-activation)."""
    return mlp_forward(params, x, cfg.activation, final_linear=False,
                       precision=precision)


def server_forward(params: Layers, h: torch.Tensor, cfg: DNNConfig,
                   precision=None) -> torch.Tensor:
    """s(h): logits over slice classes."""
    return mlp_forward(params, h, cfg.activation, final_linear=True,
                       precision=precision)


def inverse_server_forward(params: Layers, y_onehot: torch.Tensor,
                           cfg: DNNConfig, precision=None) -> torch.Tensor:
    """s⁻¹(Y): label → split-layer feature space."""
    return mlp_forward(params, y_onehot, cfg.activation, final_linear=True,
                       precision=precision)


def full_forward(client: Layers, server: Layers, x: torch.Tensor,
                 cfg: DNNConfig, precision=None) -> torch.Tensor:
    return server_forward(server, client_forward(client, x, cfg, precision),
                          cfg, precision)


def param_count_dims(dims: Sequence[int]) -> int:
    """Parameter count of an MLP stack without materializing it."""
    return sum(dims[i] * dims[i + 1] + dims[i + 1]
               for i in range(len(dims) - 1))
