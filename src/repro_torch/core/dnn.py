"""The paper's model substrate: an MLP ("ten-layer DNN", §V-A) split into
the client-side model c(·), the server-side model s(·) and the *inverse*
server-side model s⁻¹(·); port of ``repro.core.dnn`` (f32 path).

Parameters are a list of ``{"w", "b"}`` dicts per layer.  A layer's weights
are either global — ``w`` (d_in, d_out), ``b`` (d_out,) — or stacked over a
client axis — ``w`` (M, d_in, d_out), ``b`` (M, d_out) with inputs
(M, batch, d_in) — which stands in for the JAX package's vmap over clients.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from repro_torch.configs.splitme_dnn import DNNConfig

Layers = List[dict]


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def activation_fn(name: str):
    if name == "relu":
        return relu
    raise NotImplementedError(f"activation {name!r} is not ported yet")


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


def mlp_forward(layers: Layers, x: torch.Tensor, activation: str = "relu",
                final_linear: bool = True) -> torch.Tensor:
    """Forward pass in f32; the last layer stays linear when
    ``final_linear`` (logits), else it is activated too (smashed data)."""
    act = activation_fn(activation)
    for i, p in enumerate(layers):
        x = _linear(p, x)
        if i < len(layers) - 1 or not final_linear:
            x = act(x)
    return x


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


def client_forward(params: Layers, x: torch.Tensor,
                   cfg: DNNConfig) -> torch.Tensor:
    """c(X): features at the split layer (post-activation)."""
    return mlp_forward(params, x, cfg.activation, final_linear=False)


def server_forward(params: Layers, h: torch.Tensor,
                   cfg: DNNConfig) -> torch.Tensor:
    """s(h): logits over slice classes."""
    return mlp_forward(params, h, cfg.activation, final_linear=True)


def inverse_server_forward(params: Layers, y_onehot: torch.Tensor,
                           cfg: DNNConfig) -> torch.Tensor:
    """s⁻¹(Y): label → split-layer feature space."""
    return mlp_forward(params, y_onehot, cfg.activation, final_linear=True)


def full_forward(client: Layers, server: Layers, x: torch.Tensor,
                 cfg: DNNConfig) -> torch.Tensor:
    return server_forward(server, client_forward(client, x, cfg), cfg)


def param_count_dims(dims: Sequence[int]) -> int:
    """Parameter count of an MLP stack without materializing it."""
    return sum(dims[i] * dims[i + 1] + dims[i + 1]
               for i in range(len(dims) - 1))
