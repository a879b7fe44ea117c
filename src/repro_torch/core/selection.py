"""Algorithm 1 — deadline-aware selection of local trainers (P1); numpy copy
of ``repro.core.selection``.

Greedy: select every client whose local compute time plus the *estimated*
max communication time fits inside its slice-specific O-RAN control-loop
deadline.  The estimate is the α-weighted average of the max uplink time of
the previous two rounds, seeded with the pessimistic uniform-allocation time
t_max^0 = max_m M(S_m + ωd)/B.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.cost import SystemParams, uplink_time


@dataclass
class SelectionState:
    t_max_k: float       # max comm time of previous round
    t_max_km1: float     # … of the round before


def initial_state(sp: SystemParams) -> SelectionState:
    t0 = float(np.max(sp.M * (sp.S_m + sp.omega * sp.d_model_bits) / sp.B))
    return SelectionState(t_max_k=t0, t_max_km1=t0)


def select_trainers(E: int, sp: SystemParams,
                    state: SelectionState) -> np.ndarray:
    """Returns the binary selection vector a_t (Alg. 1 lines 2-7); clients
    with ``sp.avail == 0`` are never admitted."""
    t_estimate = sp.alpha * state.t_max_k + (1 - sp.alpha) * state.t_max_km1
    t_overall = E * (sp.Q_C + sp.Q_S) + t_estimate
    a = ((t_overall <= sp.t_round) & (sp.avail > 0)).astype(np.float64)
    if a.sum() == 0:
        # never stall: admit the single fastest (available) client
        slack = E * (sp.Q_C + sp.Q_S) - sp.t_round
        if np.any(sp.avail > 0):
            slack = np.where(sp.avail > 0, slack, np.inf)
        a[np.argmin(slack)] = 1.0
    return a


def update_state(state: SelectionState, a: np.ndarray, b: np.ndarray,
                 sp: SystemParams) -> SelectionState:
    """Alg. 1 line 8, read as an α-damped (EMA) update of the realized max
    uplink time."""
    t = uplink_time(a, b, sp)
    realized = float(np.max(t)) if a.sum() else state.t_max_k
    t_max = sp.alpha * state.t_max_k + (1 - sp.alpha) * realized
    return SelectionState(t_max_k=t_max, t_max_km1=state.t_max_k)
