"""Plain PyTorch version of the RWKV6 WKV kernel: the sequential recurrence
of ``repro.kernels.rwkv6_wkv.ref``."""
import torch


def rwkv6_wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r, k, v, w: (b, L, nh, P); u: (nh, P) -> y (b, L, nh, P) float32.

    y_t = r_tᵀ S + (r_t · (u ∘ k_t)) v_t, then S ← diag(w_t) S + k_t v_tᵀ,
    from S = 0."""
    b, L, nh, P = r.shape
    r, k, v, w, u = (a.float() for a in (r, k, v, w, u))
    S = r.new_zeros(b, nh, P, P)
    ys = []
    for t in range(L):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]   # (b, nh, P)
        rk = torch.sum(r_t * u * k_t, dim=-1)
        ys.append(torch.einsum("bhp,bhpq->bhq", r_t, S) + rk[..., None] * v_t)
        S = S * w_t[..., None] + k_t[..., None] * v_t[..., None, :]
    if not ys:
        return r.new_zeros(b, 0, nh, P)
    return torch.stack(ys, dim=1)
