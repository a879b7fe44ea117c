"""Plain PyTorch version of the Mamba2 SSD kernel: the sequential
recurrence of ``repro.kernels.mamba2_scan.ref`` (and of the JAX model's own
scan path, ``repro.models.mamba2.mamba2_forward``)."""
import torch


def mamba2_scan_ref(decay: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """decay, dt: (b, L, nh); B, C: (b, L, N); x: (b, L, nh, P) -> y
    (b, L, nh, P) float32.

    h_t = a_t h_{t−1} + dt_t B_t ⊗ x_t (an (N, P) state per head), y_t = C_t h_t,
    from h = 0."""
    b, L, nh = decay.shape
    N, P = B.shape[-1], x.shape[-1]
    decay, dt, B, C, x = (a.float() for a in (decay, dt, B, C, x))
    h = x.new_zeros(b, nh, N, P)
    ys = []
    for t in range(L):
        dec_t, dt_t, B_t, C_t, x_t = (decay[:, t], dt[:, t], B[:, t], C[:, t],
                                      x[:, t])
        h = (h * dec_t[:, :, None, None]
             + (dt_t[:, :, None] * B_t[:, None, :])[..., None]
             * x_t[:, :, None, :])
        ys.append(torch.einsum("bn,bhnp->bhp", C_t, h))
    if not ys:
        return x.new_zeros(b, 0, nh, P)
    return torch.stack(ys, dim=1)
