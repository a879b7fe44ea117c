"""Learning-rate schedules; twin of ``repro.optim.schedules`` (pure Python,
the same formulas, so the same floats).

Includes the paper's theoretical rates: Corollary 2/3 prescribe
η = 1 / (√(T·E) · (2L·Σ q_m B + L·Σ q_m B²)) with B = B₁ (client) or
B₂ (server), B₁ < B₂ ⇒ η_C > η_S (the trainer asserts this ordering).
"""
from __future__ import annotations

import math
from typing import Callable


def constant(lr: float) -> Callable[[int], float]:
    return lambda step: lr


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1) -> Callable[[int], float]:
    def f(step: int) -> float:
        if step < warmup_steps:
            return peak_lr * (step + 1) / max(warmup_steps, 1)
        frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        frac = min(max(frac, 0.0), 1.0)
        return peak_lr * (floor + (1 - floor) * 0.5
                          * (1 + math.cos(math.pi * frac)))
    return f


def corollary2_rate(T: int, E: int, L: float, B: float,
                    q_weights=None) -> float:
    """Paper Corollary 2/3: the O(1/√T)-convergent local learning rate.

    T: total local iterations, E: local updates per round, L: smoothness,
    B: the distribution-distance lower bound (B₁ client / B₂ server),
    q_weights: client sampling probabilities (default uniform ⇒ Σ q_m = 1).
    """
    qsum = 1.0 if q_weights is None else float(sum(q_weights))
    denom = math.sqrt(T * E) * (2 * L * qsum * B + L * qsum * B * B)
    return 1.0 / max(denom, 1e-12)


def splitme_rates(T: int, E: int, L: float = 1.0, b1: float = 0.1,
                  b2: float = 0.3) -> tuple:
    """(η_C, η_S) with the paper's ordering η_C > η_S (since B₁ < B₂)."""
    assert b1 < b2, "Assumption 3: B1 < B2"
    return corollary2_rate(T, E, L, b1), corollary2_rate(T, E, L, b2)
