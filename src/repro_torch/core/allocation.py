"""P2 — computational & communication resource allocation (paper §IV-D);
numpy copy of ``repro.core.allocation``.

    min_{b, E}  K_ε(E) · cost(t)     s.t. (22a)-(22f)

For fixed E the continuous subproblem is the min-max uplink epigraph, whose
optimum equalizes finish times b_m(τ) = (S_m+ωd)/(B(τ − E·Q_C,m)); bisection
on τ gives it exactly, then the b_min box is enforced by waterfilling.  E is
swept over {1..E_max} with the paper's guard E ← min(Ê, E_last).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.cost import SystemParams, objective


def solve_bandwidth(a: np.ndarray, E: int, sp: SystemParams) -> np.ndarray:
    """Exact min-max bandwidth split for the selected set (fixed E); a
    client's rate is ``b_m B G_m``."""
    sel = np.where(a > 0)[0]
    b = np.zeros(sp.M)
    if len(sel) == 0:
        return b
    size = (sp.S_m[sel] + sp.omega * sp.d_model_bits) / sp.G_m[sel]  # bits
    offs = E * sp.Q_C[sel]                                # s

    def excess(tau: float) -> float:
        denom = np.maximum(tau - offs, 1e-12)
        return float(np.sum(size / (sp.B * denom)) - 1.0)

    lo = float(np.max(offs)) + 1e-9
    hi = lo + float(np.sum(size)) / sp.B + 1.0
    while excess(hi) > 0:
        hi *= 2.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if excess(mid) > 0:
            lo = mid
        else:
            hi = mid
    tau = hi
    bs = size / (sp.B * np.maximum(tau - offs, 1e-12))
    # enforce b_min by clip + renormalise the rest (waterfilling step)
    for _ in range(len(sel)):
        low = bs < sp.b_min
        if not low.any():
            break
        fixed = np.sum(np.where(low, sp.b_min, 0.0))
        free = ~low
        if fixed >= 1.0 or not free.any():
            bs = np.full(len(sel), 1.0 / len(sel))
            break
        bs = np.where(low, sp.b_min, bs * (1.0 - fixed) / np.sum(bs[free]))
    bs = bs / bs.sum()
    b[sel] = bs
    return b


def solve_p2(a: np.ndarray, E_last: int, sp: SystemParams
             ) -> Tuple[np.ndarray, int, float]:
    """Sweep integer E, exact bandwidth per E; apply the paper's guard
    E ← Ê only if Ê ≤ E_last.  Returns (b, E, objective)."""
    best = None
    for E in range(1, sp.E_max + 1):
        b = solve_bandwidth(a, E, sp)
        val = objective(a, b, E, sp)
        if best is None or val < best[2]:
            best = (b, E, val)
    b_hat, e_hat, val = best
    if e_hat > E_last:           # guard (paper §IV-D): never increase E
        e_hat = E_last
        b_hat = solve_bandwidth(a, e_hat, sp)
        val = objective(a, b_hat, e_hat, sp)
    return b_hat, e_hat, val
