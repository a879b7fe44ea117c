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


def mamba2_scan_chunked_ref(decay: torch.Tensor, dt: torch.Tensor,
                            B: torch.Tensor, C: torch.Tensor, x: torch.Tensor,
                            chunk: int = 32) -> torch.Tensor:
    """The CUDA kernel's order of the same function, in f32, for the tests:
    the SSD block decomposition over chunks of ``chunk`` tokens with the
    decay weights as running products (never exp of log differences).  Per
    chunk,

        cum_t  = Π_{r≤t} a_r                      (a chain from a_0)
        W[t,s] = Π_{r=s+1..t} a_r · dt_s, s ≤ t   (column s: a chain from 1)
        y      = cum ⊙ (C h) + ((C Bᵀ) ⊙ W) x
        h     ← cum_{Q−1} h + (B ⊙ W[Q−1, :]ᵀ)ᵀ x

    which is the reference's (C Bᵀ ∘ W) U with U = dt ⊙ x, dt folded into
    the weights.  A last chunk shorter than ``chunk`` is taken as it is."""
    b, L, nh = decay.shape
    N, P = B.shape[-1], x.shape[-1]
    decay, dt, B, C, x = (a.float() for a in (decay, dt, B, C, x))
    X = x.permute(0, 2, 1, 3)                               # (b, nh, L, P)
    a_all = decay.permute(0, 2, 1)                          # (b, nh, L)
    dt_all = dt.permute(0, 2, 1)
    h = x.new_zeros(b, nh, N, P)
    ys = []
    for t0 in range(0, L, chunk):
        a = a_all[..., t0:t0 + chunk]
        q = a.shape[-1]
        cum = torch.empty_like(a)
        W = x.new_zeros(b, nh, q, q)
        c = x.new_ones(b, nh)
        col = x.new_zeros(b, nh, q)          # row t of W, built from row t−1
        for t in range(q):
            c = c * a[..., t]
            cum[..., t] = c
            col = col * a[..., t, None]
            col[..., t] = 1.0
            W[..., t, :] = col
        W = W * dt_all[..., None, t0:t0 + q]
        Bc, Cc = B[:, t0:t0 + q], C[:, t0:t0 + q]           # (b, q, N)
        Xc = X[:, :, t0:t0 + q]                             # (b, nh, q, P)
        G = (Cc @ Bc.transpose(-1, -2))[:, None]            # (b, 1, q, q)
        y = cum[..., None] * (Cc[:, None] @ h) + (G * W) @ Xc
        ys.append(y)
        Bw = Bc[:, None] * W[..., q - 1, :, None]           # (b, nh, q, N)
        h = cum[..., q - 1, None, None] * h + Bw.transpose(-1, -2) @ Xc
    if not ys:
        return x.new_zeros(b, 0, nh, P)
    return torch.cat(ys, dim=2).permute(0, 2, 1, 3).contiguous()
