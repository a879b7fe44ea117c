"""Mutual-learning KL objectives (paper eq. 5); port of
``repro.core.mutual``, the plain reference graph.

The paper's convention: D_KL(x ‖ y) = Σ y·log(y/x), i.e. the SECOND argument
is the (stop-gradient) target distribution.  Both sides exchange roles:

    client:  min_{w_C} D_KL( c(X) ‖ sg[s⁻¹(Y)] )
    server:  min_{w_S} D_KL( s⁻¹(Y) ‖ sg[c(X)] )

The CUDA kernel (``repro_torch.kernels.kl_mutual``) computes the same
quantity on the card.
"""
from __future__ import annotations

import torch


def kl_paper(x_logits: torch.Tensor, y_logits: torch.Tensor,
             temperature: float = 1.0) -> torch.Tensor:
    """D_KL(x ‖ y) = Σ y log(y/x), y = target (paper's order).  Mean over
    all rows."""
    logp_x = torch.log_softmax(x_logits.float() / temperature, -1)
    logp_y = torch.log_softmax(y_logits.detach().float() / temperature, -1)
    p_y = logp_y.exp()
    return torch.mean(torch.sum(p_y * (logp_y - logp_x), -1))


def client_loss(c_feat: torch.Tensor, inv_feat: torch.Tensor,
                temperature: float = 1.0) -> torch.Tensor:
    """f_C = D_KL(c(X) ‖ s⁻¹(Y))."""
    return kl_paper(c_feat, inv_feat, temperature)


def server_loss(inv_feat: torch.Tensor, c_feat: torch.Tensor,
                temperature: float = 1.0) -> torch.Tensor:
    """f_S = D_KL(s⁻¹(Y) ‖ c(X))."""
    return kl_paper(inv_feat, c_feat, temperature)
