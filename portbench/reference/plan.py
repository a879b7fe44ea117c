"""The host plan of the paper's deployment, written out plainly: Table III's
per-client draws, Alg. 1's deadline-aware selection, P2's bandwidth split
and adaptive E (SplitMe), SFL's K random clients a round, and the rule by
which a campaign buckets its rounds' cohort sizes and E into shapes (which
fixes how many batch indices each seed's generator draws a round).

numpy only; the arithmetic follows the paper's equations in the order the
program is specified to use, so that a schedule compares exactly.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Sequence, Tuple

import numpy as np


def table3(deploy: dict) -> SimpleNamespace:
    """Table III of the paper for ``deploy`` (``M``, ``B``, ``system_seed``
    and optional overrides): compute times Q_C ~ U(0.34, 0.46) ms, Q_S ~
    U(1.2, 1.6) ms and deadlines ~ U(50, 100) ms a client, drawn in that
    order from ``default_rng(system_seed)``."""
    M = int(deploy["M"])
    rng = np.random.default_rng(int(deploy.get("system_seed", 0)))
    sp = SimpleNamespace(
        M=M, B=float(deploy.get("B", 1e9)), p_c=1.0, p_tr=1.0,
        b_min=1.0 / 50, omega=1.0 / 5, rho=0.8, alpha=0.7, eps=0.1,
        E_max=int(deploy.get("E_max", 20)), d_model_bits=8e6)
    sp.Q_C = rng.uniform(0.34e-3, 0.46e-3, M)
    sp.Q_S = rng.uniform(1.2e-3, 1.6e-3, M)
    sp.t_round = rng.uniform(50e-3, 100e-3, M)
    sp.S_m = np.full(M, 1e6)
    sp.G_m = np.ones(M)
    return sp


def _uplink_time(a, b, sp):
    """eq. 19 for the selected clients, 0 elsewhere."""
    with np.errstate(divide="ignore"):
        t = (sp.S_m + sp.omega * sp.d_model_bits) \
            / np.maximum(b * sp.B * sp.G_m, 1e-12)
    return np.where(a > 0, t, 0.0)


def _objective(a, b, E, sp) -> float:
    """eq. 22: K_eps(E) times the eq. 20 round cost."""
    k_eps = (E + 1) ** 2 / (E ** 2 * sp.eps ** 2)
    r_co = float(np.sum(a * b) * sp.B * sp.p_c)
    r_cp = float(np.sum(a * E * (sp.Q_C + sp.Q_S)) * sp.p_tr)
    if a.sum() == 0:
        t = 0.0
    else:
        t_co = _uplink_time(a, b, sp)
        t = float(np.max(np.where(a > 0, E * sp.Q_C + t_co, -np.inf))
                  + np.max(np.where(a > 0, E * sp.Q_S, -np.inf)))
    return k_eps * (sp.rho * (r_co / sp.B + r_cp) + (1 - sp.rho) * t)


def _bandwidth(a, E, sp) -> np.ndarray:
    """The min-max uplink split for fixed E: bisection on the common finish
    time, then the b_min floor by waterfilling."""
    sel = np.where(a > 0)[0]
    b = np.zeros(sp.M)
    if len(sel) == 0:
        return b
    size = (sp.S_m[sel] + sp.omega * sp.d_model_bits) / sp.G_m[sel]
    offs = E * sp.Q_C[sel]

    def excess(tau):
        return float(np.sum(size / (sp.B * np.maximum(tau - offs, 1e-12)))
                     - 1.0)

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
    bs = size / (sp.B * np.maximum(hi - offs, 1e-12))
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
    b[sel] = bs / bs.sum()
    return b


def _param_count(dims: Sequence[int]) -> int:
    return sum(dims[i] * dims[i + 1] + dims[i + 1]
               for i in range(len(dims) - 1))


def plan_splitme(sp, rounds: int, e_initial: int, n_per_client: int,
                 client_dims, inverse_dims) -> Dict[str, np.ndarray]:
    """SplitMe's plan: Alg. 1's estimate seeded from the generic sizes, then
    the split model's real sizes; each round selects, solves P2 over E in
    1..E_max (E never grows) and updates the estimate."""
    t0 = float(np.max(sp.M * (sp.S_m + sp.omega * sp.d_model_bits) / sp.B))
    t_k = t_km1 = t0
    pc_c, pc_i = _param_count(client_dims), _param_count(inverse_dims)
    sp.S_m = np.full(sp.M, n_per_client * client_dims[-1] * 32.0)
    sp.d_model_bits = 32.0 * (pc_c + pc_i)
    sp.omega = pc_c / (pc_c + pc_i)
    E = int(e_initial)
    a_l, b_l, e_l = [], [], []
    for _ in range(rounds):
        est = sp.alpha * t_k + (1 - sp.alpha) * t_km1
        a = (E * (sp.Q_C + sp.Q_S) + est <= sp.t_round).astype(np.float64)
        if a.sum() == 0:
            a[np.argmin(E * (sp.Q_C + sp.Q_S) - sp.t_round)] = 1.0
        best = None
        for e in range(1, sp.E_max + 1):
            b = _bandwidth(a, e, sp)
            val = _objective(a, b, e, sp)
            if best is None or val < best[2]:
                best = (b, e, val)
        b, e_hat, _ = best
        if e_hat > E:
            e_hat = E
            b = _bandwidth(a, e_hat, sp)
        E = e_hat
        t = _uplink_time(a, b, sp)
        realized = float(np.max(t)) if a.sum() else t_k
        t_k, t_km1 = sp.alpha * t_k + (1 - sp.alpha) * realized, t_k
        a_l.append(a), b_l.append(b), e_l.append(E)
    return {"a": np.stack(a_l), "b": np.stack(b_l),
            "E": np.asarray(e_l, np.int32)}


def plan_fixed_k(sp, rounds: int, K: int, E: int, policy_seed: int
                 ) -> Dict[str, np.ndarray]:
    """SFL's (and FedAvg's) plan: K clients drawn without replacement from
    ``default_rng(policy_seed)`` each round, the band split evenly."""
    rng = np.random.default_rng(policy_seed)
    a_l, b_l = [], []
    for _ in range(rounds):
        a = np.zeros(sp.M)
        k = min(K, sp.M)
        a[rng.choice(sp.M, k, replace=False)] = 1.0
        a_l.append(a)
        b_l.append(np.where(a > 0, 1.0 / k, 0.0))
    return {"a": np.stack(a_l), "b": np.stack(b_l),
            "E": np.full(rounds, E, np.int32)}


def buckets(values, cap: int, max_exact: int = 8) -> Dict[int, int]:
    """A campaign's shape buckets: up to ``max_exact`` distinct values keep
    their own shape; more round up to powers of two, capped at ``cap``."""
    distinct = sorted(set(int(c) for c in values))
    if len(distinct) <= max_exact:
        return {k: k for k in distinct}
    steps, b = [], 1
    while b < cap:
        steps.append(b)
        b *= 2
    steps.append(cap)
    return {k: next(x for x in steps if x >= k) for k in distinct}


def round_shapes(counts, es, M: int, e_cap: int
                 ) -> Tuple[List[int], List[int]]:
    """Each round's (cohort bucket, E bucket); a bucket is at least 1."""
    counts = np.asarray(counts).astype(int)
    size_of, e_of = buckets(counts, M), buckets(es, e_cap)
    return ([max(1, size_of[int(c)]) for c in counts],
            [max(1, e_of[int(e)]) for e in es])
