"""Analytic layer-wise inversion of the inverse server-side model (paper
§III-B Step 4, eq. 8-9); port of ``repro.core.inversion`` on one device.

For each layer l of the server-side model s(·):

    W_l = ( Σ_m O_l^(m)ᵀ O_l^(m) + γI )⁻¹ ( Σ_m O_l^(m)ᵀ Z_l^(m) )

where O_l is the input of layer l (starting from the smashed data c(X_m)) and
Z_l is the matching-depth activation of the trained inverse model s⁻¹ fed
with the labels.  The Gram products go through the kernel dispatch layer
(the CUDA ridge_gram kernel on the card); the ridge solve is an f32 LU
solve (``torch.linalg.solve_ex``).  Smashed data in bf16 (the mixed
policy) are widened to f32 where they meet f32: in the Grams and in the
first layer's ``o @ w + b`` (bf16 × f32 promotes to f32 in the reference).
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.configs.splitme_dnn import DNNConfig
from repro_torch.core import dnn
from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import PolicyLike


def _gram(o: torch.Tensor, z: torch.Tensor, policy: PolicyLike = None):
    """Returns (OᵀO, OᵀZ) in float32 via the kernel dispatch layer (one
    kernel launch for both on the card)."""
    return dispatch.gram_pair(o, z, policy=policy)


def _augment(o: torch.Tensor) -> torch.Tensor:
    """Append a ones column so the ridge solve also recovers the bias."""
    return torch.cat([o, o.new_ones(*o.shape[:-1], 1)], -1)


def invert_inverse_model(inverse_params: List[dict],
                         smashed: torch.Tensor,
                         labels_onehot: torch.Tensor,
                         cfg: DNNConfig,
                         gamma: float = 1e-3,
                         policy: PolicyLike = None) -> List[dict]:
    """Recover the server-side model s(·) from the trained s⁻¹(·).

    smashed: c(X) for all client samples, (n, d_split), f32 or bf16.
    labels_onehot: (n, n_classes).
    ``policy`` picks the Gram path, e.g. ``KernelPolicy(ridge_gram=False)``.
    """
    pol = dispatch.get_policy(policy)
    act = dnn.activation_fn(cfg.activation)
    # supervised targets: activations of s⁻¹ on the labels, deepest first;
    # target for s's layer l (1-based) is a_{L-l}, the last layer the labels
    inv_acts = dnn.mlp_activations(inverse_params, labels_onehot,
                                   cfg.activation)
    L = len(inverse_params)
    targets = [inv_acts[L - 1 - l] for l in range(1, L)] + [labels_onehot]

    server_params: List[dict] = []
    o = smashed
    for l, z in enumerate(targets):
        a0, a1 = _gram(_augment(o), z, pol)
        eye = torch.eye(a0.shape[0], dtype=a0.dtype, device=a0.device)
        # like jnp.linalg.solve: an exactly singular pivot gives inf/nan
        # rather than an exception (and on the card, no host sync)
        w_aug = torch.linalg.solve_ex(a0 + gamma * eye, a1).result
        w, b = w_aug[:-1], w_aug[-1]
        server_params.append({"w": w, "b": b})
        o = o.float() @ w + b
        if l < len(targets) - 1:
            o = act(o)
    return server_params
