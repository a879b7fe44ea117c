"""O-RAN SFL resource & latency cost model (paper §IV-A/B, eq. 16-21) —
numpy copy of the per-round parts of ``repro.core.cost`` and of its
vectorized ``schedule_metrics`` over a schedule and a scenario trace.

All quantities are per global round; the optimization target is
K_ε(E) · cost(t) with K_ε from Corollary 4.  ``G_m`` (channel gain on the
uplink rate ``b_m B``) and ``avail`` (selection-time availability) default to
all-ones, the static model; a scenario (``repro_torch.core.scenario``)
rewrites them and rescales ``Q_C`` / ``Q_S`` / ``t_round`` round by round.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field

import numpy as np


@dataclass
class SystemParams:
    """Table III of the paper."""
    M: int = 50                       # max number of local trainers
    B: float = 1e9                    # total uplink bandwidth (bits/s)
    p_c: float = 1.0                  # per-unit communication cost
    p_tr: float = 1.0                 # per-unit computation cost
    b_min: float = 1.0 / 50           # minimum bandwidth fraction
    omega: float = 1.0 / 5            # client-side fraction of model params
    rho: float = 0.8                  # Pareto trade-off
    alpha: float = 0.7                # heuristic factor (Alg. 1)
    eps: float = 0.1                  # target accuracy level for K_eps
    E_max: int = 20                   # largest admissible local updates
    seed: int = 0
    # drawn per-client (paper: U(0.34,0.46) ms and U(1.2,1.6) ms)
    Q_C: np.ndarray = field(default=None, repr=False)
    Q_S: np.ndarray = field(default=None, repr=False)
    t_round: np.ndarray = field(default=None, repr=False)  # U(50,100) ms
    S_m: np.ndarray = field(default=None, repr=False)      # smashed bits/client
    d_model_bits: float = 8e6          # entire-model size in bits
    # per-client energy accounting (radio + CPU draw)
    p_tx_w: float = 0.2                # uplink transmit power (W)
    p_cpu_w: float = 5.0               # local-training compute power (W)
    G_m: np.ndarray = field(default=None, repr=False)    # channel gain on b_m B
    avail: np.ndarray = field(default=None, repr=False)  # 1 = selectable

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        if self.Q_C is None:
            self.Q_C = rng.uniform(0.34e-3, 0.46e-3, self.M)
        if self.Q_S is None:
            self.Q_S = rng.uniform(1.2e-3, 1.6e-3, self.M)
        if self.t_round is None:
            self.t_round = rng.uniform(50e-3, 100e-3, self.M)
        if self.S_m is None:
            # placeholder; the trainer derives the real smashed-data size
            self.S_m = np.full(self.M, 1e6)
        if self.G_m is None:
            self.G_m = np.ones(self.M)
        if self.avail is None:
            self.avail = np.ones(self.M)

    def copy(self) -> "SystemParams":
        """Independent copy (own arrays): trainers derive omega/S_m on a
        private copy and never write to the caller's instance."""
        new = copy.copy(self)
        for name in ("Q_C", "Q_S", "t_round", "S_m", "G_m", "avail"):
            arr = getattr(new, name)
            if arr is not None:
                setattr(new, name, np.array(arr, copy=True))
        return new


def k_eps(E: int, eps: float) -> float:
    """Corollary 4: K_ε >= O((E+1)^2 / (E^2 ε^2))."""
    return (E + 1) ** 2 / (E ** 2 * eps ** 2)


def comm_cost(a: np.ndarray, b: np.ndarray, sp: SystemParams) -> float:
    """eq. 16: R_co = Σ a_m b_m B p_c."""
    return float(np.sum(a * b) * sp.B * sp.p_c)


def comp_cost(a: np.ndarray, E: int, sp: SystemParams) -> float:
    """eq. 17: R_cp = Σ a_m E (Q_C,m + Q_S,m) p_tr."""
    return float(np.sum(a * E * (sp.Q_C + sp.Q_S)) * sp.p_tr)


def uplink_time(a: np.ndarray, b: np.ndarray, sp: SystemParams) -> np.ndarray:
    """eq. 19: T_co,m = (S_m + ω d) / (b_m B G_m), for selected clients."""
    with np.errstate(divide="ignore"):
        t = (sp.S_m + sp.omega * sp.d_model_bits) \
            / np.maximum(b * sp.B * sp.G_m, 1e-12)
    return np.where(a > 0, t, 0.0)


def total_time(a: np.ndarray, b: np.ndarray, E: int,
               sp: SystemParams) -> float:
    """eq. 18: max{E Q_C,m + T_co,m} + max{E Q_S,m} over selected."""
    if a.sum() == 0:
        return 0.0
    t_co = uplink_time(a, b, sp)
    t1 = np.max(np.where(a > 0, E * sp.Q_C + t_co, -np.inf))
    t2 = np.max(np.where(a > 0, E * sp.Q_S, -np.inf))
    return float(t1 + t2)


def round_cost(a: np.ndarray, b: np.ndarray, E: int, sp: SystemParams) -> float:
    """eq. 20."""
    return (sp.rho * (comm_cost(a, b, sp) / sp.B + comp_cost(a, E, sp))
            + (1 - sp.rho) * total_time(a, b, E, sp))


def objective(a: np.ndarray, b: np.ndarray, E: int, sp: SystemParams) -> float:
    """eq. 22: K_ε · cost(t)."""
    return k_eps(E, sp.eps) * round_cost(a, b, E, sp)


def round_energy(a: np.ndarray, b: np.ndarray, E: int,
                 sp: SystemParams) -> float:
    """Per-round energy (J) of the selected set: transmit power over the
    uplink time plus CPU power over the E local updates."""
    t_up = uplink_time(a, b, sp)
    return float(np.sum(a * (sp.p_tx_w * t_up
                             + sp.p_cpu_w * E * (sp.Q_C + sp.Q_S))))


def schedule_metrics(a: np.ndarray, b: np.ndarray, E: np.ndarray,
                     sp: SystemParams, trace=None, rows=None):
    """Eq. 18 latency, eq. 20 cost and the per-round energy for a whole
    stacked schedule in one vectorized pass: ``a``/``b`` are ``(R, M)``,
    ``E`` is ``(R,)``.  ``trace`` (a ``scenario.ScenarioTrace`` or None)
    supplies the per-round channel gains and Q_C / Q_S rescalings, ``sp``
    the round-invariant base values.  Without a trace every row equals the
    scalar ``total_time`` / ``round_cost`` / ``round_energy`` of that
    round.  Returns ``(sim_time, cost, energy)``, each ``(R,)``.

    ``rows`` (exclusive with ``trace``) gives absolute per-round rows,
    ``{"q_c", "q_s", "gain"}`` each ``(R, M)``, for schedules whose rounds
    sample different cohorts (population mode: row m of round t is the
    client round t sampled at position m, so there is no round-invariant
    base); ``sp`` still gives the scalar fields and S_m."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    E = np.asarray(E, np.float64)[:, None]                     # (R, 1)
    if rows is not None:
        if trace is not None:
            raise ValueError("pass either trace= or rows=, not both")
        q_c = np.asarray(rows["q_c"], np.float64)
        q_s = np.asarray(rows["q_s"], np.float64)
        gain = np.asarray(rows["gain"], np.float64)
    elif trace is None:
        q_c, q_s, gain = sp.Q_C[None], sp.Q_S[None], sp.G_m[None]
    else:
        q_c = sp.Q_C[None] * trace.qc_scale
        q_s = sp.Q_S[None] * trace.qs_scale
        gain = sp.G_m[None] * trace.gain
    size = sp.S_m[None] + sp.omega * sp.d_model_bits           # (1|R, M)
    with np.errstate(divide="ignore"):
        t_co = size / np.maximum(b * sp.B * gain, 1e-12)
    t_co = np.where(a > 0, t_co, 0.0)
    sel = a.sum(axis=1) > 0                                    # (R,)
    t1 = np.max(np.where(a > 0, E * q_c + t_co, -np.inf), axis=1)
    t2 = np.max(np.where(a > 0, E * q_s, -np.inf), axis=1)
    sim = np.where(sel, t1 + t2, 0.0)
    r_co = np.sum(a * b, axis=1) * sp.B * sp.p_c               # eq. 16
    r_cp = np.sum(a * E * (q_c + q_s), axis=1) * sp.p_tr       # eq. 17
    cost = sp.rho * (r_co / sp.B + r_cp) + (1 - sp.rho) * sim  # eq. 20
    energy = np.sum(a * (sp.p_tx_w * t_co
                         + sp.p_cpu_w * E * (q_c + q_s)), axis=1)
    return sim, cost, energy
