"""Plain PyTorch version of the ridge Gram kernel."""
import torch


def gram_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """G = XᵀY in f32; x: (n, d1), y: (n, d2)."""
    return x.float().T @ y.float()
