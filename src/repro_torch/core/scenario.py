"""Time-varying O-RAN scenarios — named generators of per-round RAN traces
plus tunable data heterogeneity; numpy copy of ``repro.core.scenario``
(every generator, so the same ``(name, level, seed)`` gives the same trace,
pinned by tests/test_torch_scenario.py).

A ``ScenarioTrace`` holds, for R rounds × M clients:

* ``gain``      — AR(1) log-normal fade of each client's uplink rate
                  (``SystemParams.G_m``),
* ``qc_scale`` / ``qs_scale`` — AR(1) fade of the compute times ``Q_C`` /
                  ``Q_S``,
* ``avail``     — Gilbert-Elliott availability the RIC sees at selection
                  (``SystemParams.avail``),
* ``drop``      — mid-round survival unknown at selection: the realized
                  mask is ``a * drop``,
* ``deadline_scale`` — jitter on the slice deadlines ``t_round``,
* ``data_alpha`` — Dirichlet α of the client partition (``partition_for``),

and, for the ``faults`` family, the fault channels ``poison`` (R, M),
``crash`` (R,) and ``wire_gain`` (R, M).  The planning channels act on the
host plan and the metrics only (``apply_round``, ``realized_mask``,
``cost.schedule_metrics(trace=)``).  The planner never reads the fault
channels: the scanned campaign injects them inside its rounds and guards
against them there (``engine.RoundGuards``, ``launch/resilience.py``), and
the serial trainers ignore them, as the reference's do.

Registry: ``static`` | ``fading`` | ``straggler`` | ``noniid`` |
``faults`` | ``churn``, each with an optional level suffix
(``"straggler:0.4"``).  ``static`` is all-ones: schedules and metrics are
byte-identical to runs without a scenario.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np

from repro_torch.core.cost import SystemParams


@dataclass(frozen=True)
class ScenarioTrace:
    """RAN state for ``rounds`` rounds × M clients, drawn deterministically
    from ``(name, level, seed)``."""
    name: str
    seed: int
    gain: np.ndarray            # (R, M) channel gain on the uplink rate
    qc_scale: np.ndarray        # (R, M) multiplier on Q_C
    qs_scale: np.ndarray        # (R, M) multiplier on Q_S
    avail: np.ndarray           # (R, M) 1 = selectable this round
    drop: np.ndarray            # (R, M) 1 = survives the round if selected
    deadline_scale: np.ndarray  # (R, M) multiplier on t_round
    data_alpha: Optional[float] = None   # Dirichlet α (None = seed split)
    level: Optional[float] = None
    # fault channels (None outside the faults family)
    poison: Optional[np.ndarray] = None     # (R, M) 1 = NaN-poisoned update
    crash: Optional[np.ndarray] = None      # (R,)   1 = server-crash round
    wire_gain: Optional[np.ndarray] = None  # (R, M) payload corruption gain
    # churn: registered population size per round (folded into avail)
    m_t: Optional[np.ndarray] = None        # (R,)

    @property
    def rounds(self) -> int:
        return int(self.gain.shape[0])

    @property
    def n_clients(self) -> int:
        return int(self.gain.shape[1])

    def is_static(self) -> bool:
        """True when every planning channel is all-ones (the planner then
        skips the per-round SystemParams rewrites)."""
        return all(np.all(arr == 1.0) for arr in (
            self.gain, self.qc_scale, self.qs_scale, self.avail, self.drop,
            self.deadline_scale))

    def has_faults(self) -> bool:
        """True when any fault channel is armed."""
        return ((self.poison is not None and np.any(self.poison != 0))
                or (self.crash is not None and np.any(self.crash != 0))
                or (self.wire_gain is not None
                    and np.any(self.wire_gain != 1.0)))


@dataclass
class TraceBase:
    """Round-invariant SystemParams arrays captured after the framework's
    derivation; ``apply_round`` rescales these, never rescaled values."""
    Q_C: np.ndarray
    Q_S: np.ndarray
    t_round: np.ndarray
    G_m: np.ndarray
    avail: np.ndarray


def capture_base(sp: SystemParams) -> TraceBase:
    return TraceBase(Q_C=sp.Q_C.copy(), Q_S=sp.Q_S.copy(),
                     t_round=sp.t_round.copy(), G_m=sp.G_m.copy(),
                     avail=sp.avail.copy())


def apply_round(sp: SystemParams, base: TraceBase, trace: ScenarioTrace,
                t: int) -> SystemParams:
    """Write round ``t``'s RAN state into ``sp`` (the policy's private
    derived copy) before the policy's next step.  Returns ``sp``."""
    if t >= trace.rounds:
        raise ValueError(
            f"round {t} is past the scenario trace horizon "
            f"({trace.rounds} rounds, scenario {trace.name!r}); build a "
            f"longer trace with scenario.make_trace")
    sp.Q_C = base.Q_C * trace.qc_scale[t]
    sp.Q_S = base.Q_S * trace.qs_scale[t]
    sp.t_round = base.t_round * trace.deadline_scale[t]
    sp.G_m = base.G_m * trace.gain[t]
    sp.avail = base.avail * trace.avail[t]
    return sp


def restore_base(sp: SystemParams, base: TraceBase) -> SystemParams:
    """Undo ``apply_round``: put the round-invariant arrays back."""
    sp.Q_C, sp.Q_S = base.Q_C.copy(), base.Q_S.copy()
    sp.t_round = base.t_round.copy()
    sp.G_m, sp.avail = base.G_m.copy(), base.avail.copy()
    return sp


def realized_mask(a: np.ndarray, trace: ScenarioTrace, t: int) -> np.ndarray:
    """Fold round ``t``'s mid-round dropout into the selected mask.  If
    every selected client drops, the first selected one is kept."""
    a_real = a * trace.drop[t]
    if a_real.sum() == 0 and a.sum() > 0:
        a_real = np.zeros_like(a)
        a_real[np.argmax(a > 0)] = 1.0
    return a_real


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------

def _ar1(rng: np.random.Generator, rounds: int, m: int, rho: float,
         sigma: float) -> np.ndarray:
    """Stationary AR(1) series per client: x_0 ~ N(0, σ²),
    x_t = ρ x_{t-1} + σ√(1-ρ²) ε_t."""
    eps = rng.normal(size=(rounds, m))
    x = np.empty((rounds, m))
    x[0] = sigma * eps[0]
    innov = sigma * np.sqrt(max(1.0 - rho * rho, 0.0))
    for t in range(1, rounds):
        x[t] = rho * x[t - 1] + innov * eps[t]
    return x


def _markov_onoff(rng: np.random.Generator, rounds: int, m: int,
                  p_fail: float, p_recover: float) -> np.ndarray:
    """Gilbert-Elliott two-state availability per client, started from the
    stationary distribution."""
    p_down = p_fail / max(p_fail + p_recover, 1e-12)
    up = np.empty((rounds, m))
    up[0] = (rng.random(m) >= p_down).astype(np.float64)
    for t in range(1, rounds):
        u = rng.random(m)
        stay_up = up[t - 1] * (u >= p_fail)
        come_up = (1.0 - up[t - 1]) * (u < p_recover)
        up[t] = (stay_up + come_up > 0).astype(np.float64)
    return up


def _ones(rounds: int, m: int) -> np.ndarray:
    return np.ones((rounds, m))


def _gen_static(rounds: int, m: int, seed: int,
                level: Optional[float] = None) -> Dict[str, np.ndarray]:
    return {}


def _gen_fading(rounds: int, m: int, seed: int,
                level: Optional[float] = None) -> Dict[str, np.ndarray]:
    """AR(1) log-normal fading of the uplink gain (σ = ``level``, default
    0.5), milder compute fade and deadline jitter."""
    sigma = 0.5 if level is None else float(level)
    rng = np.random.default_rng(seed)
    gain = np.exp(_ar1(rng, rounds, m, rho=0.8, sigma=sigma))
    qc = np.exp(np.abs(_ar1(rng, rounds, m, rho=0.9, sigma=0.25)))
    qs = np.exp(np.abs(_ar1(rng, rounds, m, rho=0.9, sigma=0.25)))
    deadline = np.exp(_ar1(rng, rounds, m, rho=0.5, sigma=0.08))
    return {"gain": gain, "qc_scale": qc, "qs_scale": qs,
            "deadline_scale": deadline}


def _gen_straggler(rounds: int, m: int, seed: int,
                   level: Optional[float] = None) -> Dict[str, np.ndarray]:
    """A persistent slow cohort (3× compute), availability blackouts
    (entry probability ``level``, default 0.25) and rare mid-round
    dropouts."""
    p_fail = 0.25 if level is None else float(level)
    rng = np.random.default_rng(seed)
    slow = rng.random(m) < 0.3
    qc = np.where(slow, 3.0, 1.0)[None] * np.exp(
        np.abs(_ar1(rng, rounds, m, rho=0.9, sigma=0.2)))
    qs = np.exp(np.abs(_ar1(rng, rounds, m, rho=0.9, sigma=0.2)))
    avail = _markov_onoff(rng, rounds, m, p_fail=p_fail, p_recover=0.5)
    drop = (rng.random((rounds, m)) >= 0.05).astype(np.float64)
    return {"qc_scale": qc, "qs_scale": qs, "avail": avail, "drop": drop}


def _gen_noniid(rounds: int, m: int, seed: int,
                level: Optional[float] = None) -> Dict[str, np.ndarray]:
    """Static RAN, Dirichlet(α) data (α = ``level``, default 0.3)."""
    alpha = 0.3 if level is None else float(level)
    return {"data_alpha": alpha}


def churn_m_t(rounds: int, m: int, seed: int,
              level: Optional[float] = None) -> np.ndarray:
    """Registered population per round: a sinusoid of period 8 rounds
    (random phase) with mild noise; ``level`` is the fraction gone at the
    trough (default 0.5)."""
    amp = 0.5 if level is None else float(level)
    amp = min(max(amp, 0.0), 0.95)
    rng = np.random.default_rng([int(seed), 0x43485552])       # "CHUR"
    phase = rng.uniform(0.0, 2.0 * np.pi)
    noise = rng.normal(0.0, 0.03, rounds)
    cycle = 0.5 + 0.5 * np.sin(2.0 * np.pi * np.arange(rounds) / 8.0 + phase)
    frac = np.clip(1.0 - amp * cycle + noise, 0.02, 1.0)
    return np.clip(np.round(m * frac), 1, m).astype(np.int64)


def _gen_churn(rounds: int, m: int, seed: int,
               level: Optional[float] = None) -> Dict[str, np.ndarray]:
    """Population churn: client ids at or above the round's ``m_t`` are
    not registered (``avail`` 0)."""
    m_t = churn_m_t(rounds, m, seed, level=level)
    avail = (np.arange(m)[None, :] < m_t[:, None]).astype(np.float64)
    return {"avail": avail, "m_t": m_t}


# a flipped exponent bit multiplies a float by 2^±12: finite but huge
WIRE_FLIP_GAIN = 2.0 ** 12


def _gen_faults(rounds: int, m: int, seed: int,
                level: Optional[float] = None) -> Dict[str, np.ndarray]:
    """Fault channels at intensity p = ``level`` (default 0.1): NaN
    updates w.p. p/10 a client, server crashes w.p. p/4 a round, exponent
    flips of the wire payload w.p. p/20 a client; the RAN stays static."""
    p = 0.1 if level is None else float(level)
    rng = np.random.default_rng(seed)
    poison = (rng.random((rounds, m)) < p / 10).astype(np.float64)
    crash = (rng.random(rounds) < p / 4).astype(np.float64)
    flip = rng.random((rounds, m)) < p / 20
    sign = np.where(rng.random((rounds, m)) < 0.5, -1.0, 1.0)
    wire_gain = np.where(flip, sign * WIRE_FLIP_GAIN, 1.0)
    return {"poison": poison, "crash": crash, "wire_gain": wire_gain}


_REGISTRY: Dict[str, Callable[..., Dict[str, np.ndarray]]] = {
    "static": _gen_static,
    "fading": _gen_fading,
    "straggler": _gen_straggler,
    "noniid": _gen_noniid,
    "faults": _gen_faults,
    "churn": _gen_churn,
}

ScenarioLike = Union[None, str, ScenarioTrace]


def scenario_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def make_trace(name: str, rounds: int, n_clients: int, *,
               seed: int = 0, level: Optional[float] = None
               ) -> ScenarioTrace:
    """The named scenario's trace for ``rounds`` × ``n_clients``; unset
    channels are all-ones."""
    base, _, suffix = name.partition(":")
    if suffix:
        if level is not None:
            raise ValueError(f"level given twice: {name!r} and {level}")
        level = float(suffix)
    try:
        gen = _REGISTRY[base]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; have "
                       f"{scenario_names()}") from None
    ch = gen(rounds, n_clients, seed, level=level)
    ones = _ones(rounds, n_clients)
    return ScenarioTrace(
        name=base, seed=seed, level=level,
        gain=ch.get("gain", ones).copy(),
        qc_scale=ch.get("qc_scale", ones).copy(),
        qs_scale=ch.get("qs_scale", ones).copy(),
        avail=ch.get("avail", ones).copy(),
        drop=ch.get("drop", ones).copy(),
        deadline_scale=ch.get("deadline_scale", ones).copy(),
        data_alpha=ch.get("data_alpha"),
        poison=ch.get("poison"), crash=ch.get("crash"),
        wire_gain=ch.get("wire_gain"), m_t=ch.get("m_t"))


def get_trace(scenario: ScenarioLike, rounds: int, n_clients: int, *,
              seed: int = 0) -> Optional[ScenarioTrace]:
    """None → None; a name (``"name:level"``) → ``make_trace``; a
    ``ScenarioTrace`` → checked (at least ``rounds`` rounds, exactly
    ``n_clients`` clients) and cut to its first ``rounds`` rounds."""
    if scenario is None:
        return None
    if isinstance(scenario, str):
        return make_trace(scenario, rounds, n_clients, seed=seed)
    if not isinstance(scenario, ScenarioTrace):
        raise TypeError(f"scenario must be None, a name or a ScenarioTrace, "
                        f"got {type(scenario).__name__}")
    if scenario.n_clients != n_clients:
        raise ValueError(f"trace covers {scenario.n_clients} clients, "
                         f"need {n_clients}")
    if scenario.rounds < rounds:
        raise ValueError(f"trace covers {scenario.rounds} rounds, "
                         f"need {rounds}")
    if scenario.rounds > rounds:
        def cut(arr):
            return None if arr is None else arr[:rounds]
        return ScenarioTrace(
            name=scenario.name, seed=scenario.seed, level=scenario.level,
            gain=scenario.gain[:rounds],
            qc_scale=scenario.qc_scale[:rounds],
            qs_scale=scenario.qs_scale[:rounds],
            avail=scenario.avail[:rounds], drop=scenario.drop[:rounds],
            deadline_scale=scenario.deadline_scale[:rounds],
            data_alpha=scenario.data_alpha,
            poison=cut(scenario.poison), crash=cut(scenario.crash),
            wire_gain=cut(scenario.wire_gain), m_t=cut(scenario.m_t))
    return scenario


def partition_for(trace: Optional[ScenarioTrace], X: np.ndarray,
                  y: np.ndarray, n_clients: int, samples_per_client: int,
                  seed: int = 0) -> Dict[str, np.ndarray]:
    """The client partition a scenario asks for: Dirichlet(α) when the
    trace carries ``data_alpha``, else the paper's one-class split."""
    from repro_torch.data import oran
    if trace is not None and trace.data_alpha is not None:
        return oran.partition_dirichlet(X, y, n_clients, samples_per_client,
                                        alpha=trace.data_alpha, seed=seed)
    return oran.partition_non_iid(X, y, n_clients, samples_per_client,
                                  seed=seed)

