"""Plain PyTorch version of the fused mutual-KL kernel."""
import torch


def kl_rows_ref(x: torch.Tensor, y: torch.Tensor,
                temperature: float = 1.0) -> torch.Tensor:
    """Per-row D_KL(x ‖ y) = Σ p_y (log p_y − log p_x), p = softmax(·/T);
    (..., d) -> (...) in f32."""
    logp_x = torch.log_softmax(x.float() / temperature, -1)
    logp_y = torch.log_softmax(y.float() / temperature, -1)
    return torch.sum(logp_y.exp() * (logp_y - logp_x), -1)
