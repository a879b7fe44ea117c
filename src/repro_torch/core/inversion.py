"""Analytic layer-wise inversion of the inverse server-side model (paper
§III-B Step 4, eq. 8-9); port of ``repro.core.inversion`` on one device.

For each layer l of the server-side model s(·):

    W_l = ( Σ_m O_l^(m)ᵀ O_l^(m) + γI )⁻¹ ( Σ_m O_l^(m)ᵀ Z_l^(m) )

where O_l is the input of layer l (starting from the smashed data c(X_m)) and
Z_l is the matching-depth activation of the trained inverse model s⁻¹ fed
with the labels.  The Gram products go through the kernel dispatch layer
(the CUDA ridge_gram kernel on the card); the ridge solve
(``ridge_solve``) forms A0 + γI in f32, as the reference does, and solves
it by LU in f64 (``torch.linalg.solve_ex``), rounding W to f32.  Smashed
data in bf16 (the mixed policy) are widened to f32 where they meet f32:
in the Grams and in the first layer's ``o @ w + b`` (bf16 × f32 promotes
to f32 in the reference).

On a client mesh (``mesh=``) each rank holds its slab of the samples: it
makes its Gram partials with the same kernel, and per layer ONE all-reduce
carries the concatenated [A0 | A1] of every seed inverted together (eq. 9's
sums are exact elementwise), after which every rank solves the same
systems.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.configs.splitme_dnn import DNNConfig
from repro_torch.core import dnn
from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import PolicyLike


def _gram(o: torch.Tensor, z: torch.Tensor, policy: PolicyLike = None):
    """Returns (OᵀO, OᵀZ) in float32 via the kernel dispatch layer (one
    kernel launch for both on the card)."""
    return dispatch.gram_pair(o, z, policy=policy)


def ridge_solve(a0: torch.Tensor, a1: torch.Tensor,
                gamma: float) -> torch.Tensor:
    """W = (A0 + γI)⁻¹ A1 in f32: the system formed in f32, as the
    reference forms it, and solved by LU with partial pivoting in f64.

    At the default γ = 1e-3 the f32 system of a trained DNN10 is nearly
    singular (dead units, and γ below the rounding of the large
    diagonal), and whether an f32 LU meets an exactly zero pivot, and
    returns inf / NaN weights, depends on the library's elimination
    order: on the same trained params MKL's f32 LU did on 2 (8 threads) to
    9 (1 thread) of 32 seeds, collapsing the evaluated accuracy to chance,
    where the reference's LAPACK LU (``jnp.linalg.solve``) did on none
    (tests/torch_horizon_check.py).  The f64 elimination of the same f32
    system meets no such pivot and agrees with the reference's accuracy on
    every seed; like ``jnp.linalg.solve`` it raises nothing (and on the
    card syncs nothing): an exactly singular system still gives inf / NaN."""
    eye = torch.eye(a0.shape[0], dtype=a0.dtype, device=a0.device)
    a = (a0 + gamma * eye).double()
    return torch.linalg.solve_ex(a, a1.double()).result.float()


def _augment(o: torch.Tensor) -> torch.Tensor:
    """Append a ones column so the ridge solve also recovers the bias."""
    return torch.cat([o, o.new_ones(*o.shape[:-1], 1)], -1)


def invert_inverse_model(inverse_params: List[dict],
                         smashed: torch.Tensor,
                         labels_onehot: torch.Tensor,
                         cfg: DNNConfig,
                         gamma: float = 1e-3,
                         policy: PolicyLike = None,
                         mesh=None) -> List[dict]:
    """Recover the server-side model s(·) from the trained s⁻¹(·).

    smashed: c(X) for all client samples, (n, d_split), f32 or bf16.
    labels_onehot: (n, n_classes).
    ``policy`` picks the Gram path, e.g. ``KernelPolicy(ridge_gram=False)``.
    ``mesh``: a client mesh; ``smashed`` and the labels are then this
    rank's samples, and each layer's Grams are all-reduced before the
    solve.
    """
    return invert_inverse_models([inverse_params], [smashed], labels_onehot,
                                 cfg, gamma, policy, mesh)[0]


def invert_inverse_models(inverse_params: Sequence[List[dict]],
                          smashed: Sequence[torch.Tensor],
                          labels_onehot: torch.Tensor, cfg: DNNConfig,
                          gamma: float = 1e-3, policy: PolicyLike = None,
                          mesh=None) -> List[List[dict]]:
    """``invert_inverse_model`` for several seeds' models (each with its
    smashed data, on the same samples and labels) layer by layer: on a
    ``mesh`` one all-reduce a layer carries every seed's [A0 | A1]."""
    pol = dispatch.get_policy(policy)
    act = dnn.activation_fn(cfg.activation)
    L = len(inverse_params[0])
    # supervised targets: activations of s⁻¹ on the labels, deepest first;
    # target for s's layer l (1-based) is a_{L-l}, the last layer the labels
    targets = []
    for w_inv in inverse_params:
        inv_acts = dnn.mlp_activations(w_inv, labels_onehot, cfg.activation)
        targets.append([inv_acts[L - 1 - l] for l in range(1, L)]
                       + [labels_onehot])
    server = [[] for _ in inverse_params]
    o = list(smashed)
    for l in range(L):
        grams = [_gram(_augment(o[s]), targets[s][l], pol)
                 for s in range(len(o))]
        if mesh is not None:
            from repro_torch.core.engine import all_reduce_bundle
            both = all_reduce_bundle(
                [torch.cat(g, 1) for g in grams], mesh)
            d = grams[0][0].shape[1]
            grams = [(b[:, :d], b[:, d:]) for b in both]
        for s, (a0, a1) in enumerate(grams):
            w_aug = ridge_solve(a0, a1, gamma)
            w, b = w_aug[:-1], w_aug[-1]
            server[s].append({"w": w, "b": b})
            o[s] = o[s].float() @ w + b
            if l < L - 1:
                o[s] = act(o[s])
    return server
