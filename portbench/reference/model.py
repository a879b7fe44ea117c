"""The paper's DNN in plain PyTorch, batched over a lead of (seed, client)
dims: He-initialised layers drawn from a seed's CPU generator, the forward
with ReLU between layers, the per-row mutual KL of SplitMe's two phases,
the cross-entropy of the full-model frameworks, and the Step-4 inversion.

Weights are lists of ``{"w": (..., d_in, d_out), "b": (..., d_out)}``;
inputs are ``(..., rows, d_in)`` with the same leading dims.  Float32
throughout; the caller decides whether matmuls may use TF32.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import torch

Layers = List[dict]


def init_layers(gen: torch.Generator, dims: Sequence[int]) -> Layers:
    """One run's layers as its generator draws them: for each layer in
    order a standard normal (d_in, d_out) block scaled by sqrt(2 / d_in),
    and a zero bias."""
    out = []
    for i in range(len(dims) - 1):
        w = torch.randn(dims[i], dims[i + 1], generator=gen)
        out.append({"w": w * math.sqrt(2.0 / dims[i]),
                    "b": torch.zeros(dims[i + 1])})
    return out


def stack(runs: Sequence[Layers], device) -> Layers:
    """Runs' layers stacked on a new leading dim, on ``device``."""
    return [{k: torch.stack([r[l][k] for r in runs]).to(device)
             for k in ("w", "b")} for l in range(len(runs[0]))]


def expand(layers: Layers, k: int) -> Layers:
    """(S, ...) weights onto k client slots each: (S, k, ...)."""
    return [{n: v.unsqueeze(1).expand(v.shape[0], k, *v.shape[1:])
             .contiguous() for n, v in p.items()} for p in layers]


def forward(layers: Layers, x: torch.Tensor,
            final_linear: bool = True) -> torch.Tensor:
    """ReLU MLP; the last layer stays linear when ``final_linear``."""
    for i, p in enumerate(layers):
        x = x @ p["w"] + p["b"].unsqueeze(-2)
        if i < len(layers) - 1 or not final_linear:
            x = torch.relu(x)
    return x


def activations(layers: Layers, x: torch.Tensor) -> List[torch.Tensor]:
    """Every layer's output, ReLU'd but the last."""
    out = []
    for i, p in enumerate(layers):
        x = x @ p["w"] + p["b"].unsqueeze(-2)
        if i < len(layers) - 1:
            x = torch.relu(x)
        out.append(x)
    return out


def kl_rows(x: torch.Tensor, y: torch.Tensor, temperature: float):
    """Per-row Σ p_y (log p_y − log p_x), p = softmax(·/T): the paper's
    D_KL(x ‖ y) of eq. 5, y the target."""
    logp_x = torch.log_softmax(x / temperature, -1)
    logp_y = torch.log_softmax(y / temperature, -1)
    return torch.sum(logp_y.exp() * (logp_y - logp_x), -1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """Mean over the rows of −log softmax(logits)[label]."""
    logp = torch.log_softmax(logits, -1)
    return -torch.take_along_dim(logp, labels[..., None], -1)[..., 0].mean(-1)


def sgd(layers: Layers, loss_fn, lr: float):
    """One SGD step of every slot's weights on its own loss: returns the
    updated layers and the (...,) losses before the step."""
    leaves = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
              for p in layers]
    with torch.enable_grad():
        loss = loss_fn(leaves)
        flat = [v for p in leaves for v in p.values()]
        grads = iter(torch.autograd.grad(loss.sum(), flat))
    new = [{k: v.detach() - lr * next(grads) for k, v in p.items()}
           for p in leaves]
    return new, loss.detach()


def invert(client: Layers, inverse: Layers, x_all: torch.Tensor,
           y1_all: torch.Tensor, gamma: float) -> Layers:
    """Step 4 (paper eq. 8-9) for S seeds at once: each server layer l is
    the ridge solution W = (OᵀO + γI)⁻¹ OᵀZ over all client samples, O the
    layer's input with a ones column (the bias), Z the inverse model's
    activation at the matching depth (the labels for the last layer).  The
    Grams are float32 sums; the system is formed in float32 and solved in
    float64 (at γ 1e-3 the float32 system of a trained DNN is nearly
    singular), W rounded to float32."""
    S = client[0]["w"].shape[0]
    o = forward(client, x_all.expand(S, *x_all.shape), final_linear=False)
    y1 = y1_all.expand(S, *y1_all.shape)
    acts = activations(inverse, y1)
    L = len(inverse)
    targets = [acts[L - 1 - l] for l in range(1, L)] + [y1]
    server = []
    for l in range(L):
        aug = torch.cat([o, o.new_ones(*o.shape[:-1], 1)], -1)
        a0 = aug.transpose(-1, -2) @ aug
        a1 = aug.transpose(-1, -2) @ targets[l]
        eye = torch.eye(a0.shape[-1], dtype=a0.dtype, device=a0.device)
        w_aug = torch.linalg.solve_ex((a0 + gamma * eye).double(),
                                      a1.double()).result.float()
        server.append({"w": w_aug[:, :-1], "b": w_aug[:, -1]})
        o = o @ server[-1]["w"] + server[-1]["b"].unsqueeze(-2)
        if l < L - 1:
            o = torch.relu(o)
    return server


def accuracy(layers: Layers, x_test: torch.Tensor,
             y_test: torch.Tensor) -> torch.Tensor:
    """(S,) share of test rows whose largest logit is the label."""
    S = layers[0]["w"].shape[0]
    logits = forward(layers, x_test.expand(S, *x_test.shape))
    return (logits.argmax(-1) == y_test).float().mean(-1)
