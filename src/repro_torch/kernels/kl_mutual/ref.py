"""Plain PyTorch versions of the fused mutual-KL kernels."""
import torch


def kl_rows_ref(x: torch.Tensor, y: torch.Tensor,
                temperature: float = 1.0) -> torch.Tensor:
    """Per-row D_KL(x ‖ y) = Σ p_y (log p_y − log p_x), p = softmax(·/T);
    (..., d) -> (...) in f32."""
    logp_x = torch.log_softmax(x.float() / temperature, -1)
    logp_y = torch.log_softmax(y.float() / temperature, -1)
    return torch.sum(logp_y.exp() * (logp_y - logp_x), -1)


def kl_grad_ref(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                temperature: float = 1.0) -> torch.Tensor:
    """The gradient in x of Σ_r g[r]·D_KL(x_r ‖ y_r), the closed form
    g[r]·(softmax(x_r/T) − softmax(y_r/T))/T (y is a target and gets none);
    x, y: (R, d), each f32 or bf16, g: (R,) -> (R, d), computed in f32 and
    returned in x's dtype (as the JAX package's ``_kl_bwd`` casts it)."""
    p_x = torch.softmax(x.float() / temperature, -1)
    p_y = torch.softmax(y.float() / temperature, -1)
    return (g[:, None] * (p_x - p_y) / temperature).to(x.dtype)
