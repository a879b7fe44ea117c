"""Client population of O(cohort) campaigns over millions of virtual
near-RT-RICs; numpy copy of ``repro.core.population`` (the same hashes,
samplers, rows, shards and traces, pinned equal to it by
tests/test_torch_population.py).

A ``Population`` replaces the materialized per-client tables (one
``SystemParams`` row a client, an (R, M) scenario trace, a full data
partition) with the distributions they were drawn from.  Every per-client
attribute is a pure function of ``(population seed, client id, field
tag)`` through a stateless splitmix64 hash, so a campaign evaluates it only
for the ids it touches:

* ``rows(ids)`` / ``system_params(ids)``: the cohort's ``SystemParams`` rows
  (compute times, slice deadlines, static channel gain), drawn from Table
  III's U(a, b) marginals but addressable by id: ``rows([7])`` equals row 7
  of ``rows(arange(10**6))`` without drawing the others;
* ``sample_cohort(seed, t, m_t, cohort)``: uniform (or stratified by anchor
  class) sampling without replacement in O(cohort), deterministic in
  ``(seed, t)`` alone, so a resumed campaign replans the same cohorts;
* ``sample_shards(X, y, ids, n)``: each client's local dataset, a fixed
  per-id draw (anchored Dirichlet, or the paper's one class a client) from
  its own ``default_rng([seed, tag, id])`` stream;
* ``PopulationTrace``: the scenario families ``static | fading | straggler
  | churn | noniid`` evaluated per (round, id) on demand, at the
  stationary marginals of the materialized generators; under ``churn`` the
  registered population ``m_t`` varies round to round
  (``scenario.churn_m_t``) and cohorts are sampled from ``[0, m_t)``.  The
  fault families need the full (R, M) channels and are rejected.

Exactness: a population campaign whose cohort is the whole population
(``cohort >= size``, no scenario) equals the materialized ``run_campaign``
on ``system_params(arange(size))`` and ``sample_shards(..., arange(size))``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.cost import SystemParams
from repro_torch.core.scenario import churn_m_t
from repro_torch.data import oran

__all__ = ["Population", "PopulationTrace", "make_population_trace",
           "get_population_trace", "population_scenario_names",
           "sample_cohort"]

_U64 = np.uint64

# field tags: one independent hash stream per per-client attribute
_TAG_QC, _TAG_QS, _TAG_TROUND = 0x51C0, 0x51C1, 0x51C2
_TAG_GAIN_U1, _TAG_GAIN_U2 = 0x51C3, 0x51C4
_TAG_SLOW, _TAG_AVAIL, _TAG_DROP = 0x51C5, 0x51C6, 0x51C7
_TAG_FADE_G, _TAG_FADE_QC, _TAG_FADE_QS, _TAG_FADE_DL = (
    0x51C8, 0x51C9, 0x51CA, 0x51CB)
_TAG_COHORT = 0x51D0
_TAG_DATA = 0x51D1


def _mix(x):
    """splitmix64 finalizer — full-avalanche uint64 -> uint64 (vectorized)."""
    with np.errstate(over="ignore"):
        x = x + _U64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
        return x ^ (x >> _U64(31))


def _u01(ids, *key_ints) -> np.ndarray:
    """Deterministic U[0, 1) per client id for the hash stream named by
    ``key_ints`` (population seed, field tag, optionally the round).
    Pure and vectorized: O(len(ids)) regardless of the population size,
    and ``_u01([7], k)`` equals element 7 of ``_u01(arange(M), k)``."""
    k = _U64(0)
    for v in key_ints:
        k = _mix(k ^ _U64(int(v) & 0xFFFFFFFFFFFFFFFF))
    h = _mix(np.asarray(ids, np.uint64) ^ k)
    h = _mix(h + k)
    # top 53 bits -> float64 mantissa
    return (h >> _U64(11)).astype(np.float64) * (2.0 ** -53)


def _normal01(ids, *key_ints) -> np.ndarray:
    """Standard normal per id (Box-Muller over two hash streams)."""
    u1 = np.maximum(_u01(ids, *key_ints, 0), 1e-300)
    u2 = _u01(ids, *key_ints, 1)
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)


# ---------------------------------------------------------------------------
# Cohort sampling
# ---------------------------------------------------------------------------

def _distinct_uniform(rng: np.random.Generator, k: int, m: int) -> np.ndarray:
    """k distinct uniform draws from [0, m) in O(k) expected work.

    Dense case (k > m/2): a permutation prefix — O(m) <= O(2k).  Sparse
    case: rejection with dedup; each redraw keeps every id already
    accepted, so the accepted set only grows and the loop terminates with
    expected < 2 passes when k << m."""
    if k >= m:
        return np.arange(m, dtype=np.int64)
    if 2 * k >= m:
        return np.sort(rng.permutation(m)[:k]).astype(np.int64)
    ids = np.unique(rng.integers(0, m, size=k))
    while ids.size < k:
        extra = rng.integers(0, m, size=2 * (k - ids.size))
        ids = np.unique(np.concatenate([ids, extra]))
    return np.sort(ids[:k]).astype(np.int64)


def sample_cohort(seed: int, t: int, m_t: int, cohort: int, *,
                  stratified: bool = False, n_strata: int = 3) -> np.ndarray:
    """Round t's cohort: ``min(cohort, m_t)`` distinct client ids from the
    round-t registered population ``[0, m_t)``, sorted ascending.

    Deterministic in ``(seed, t)`` ALONE — no sampler state is carried
    between rounds, so a resumed campaign replans byte-identical cohorts
    (test-pinned across a checkpoint/resume boundary).

    ``stratified=True`` samples per anchor-class stratum (``id %
    n_strata``, the round-robin slice assignment of the data partition),
    splitting the cohort as evenly as the strata allow — a cheap guarantee
    that every slice class is represented in small cohorts."""
    m_t, cohort = int(m_t), int(cohort)
    if m_t < 1:
        raise ValueError(f"m_t must be >= 1, got {m_t}")
    k = min(cohort, m_t)
    rng = np.random.default_rng([int(seed), _TAG_COHORT, int(t)])
    if not stratified or k >= m_t:
        return _distinct_uniform(rng, k, m_t)
    # stratum s holds ids {s, s + S, s + 2S, ...} below m_t
    counts = [(m_t - s + n_strata - 1) // n_strata for s in range(n_strata)]
    quota = [k // n_strata + (1 if s < k % n_strata else 0)
             for s in range(n_strata)]
    # clamp to stratum size; hand surplus to strata with headroom
    surplus = 0
    for s in range(n_strata):
        if quota[s] > counts[s]:
            surplus += quota[s] - counts[s]
            quota[s] = counts[s]
    for s in range(n_strata):
        if surplus == 0:
            break
        room = counts[s] - quota[s]
        take = min(room, surplus)
        quota[s] += take
        surplus -= take
    parts = [s + n_strata * _distinct_uniform(rng, quota[s], counts[s])
             for s in range(n_strata) if quota[s] > 0]
    return np.sort(np.concatenate(parts)).astype(np.int64)


# ---------------------------------------------------------------------------
# The population
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Population:
    """A parameterized client population: Table III's marginals plus an
    optional static log-normal gain spread and a data profile, evaluated
    lazily per client id.

    ``data_alpha`` is the population's Dirichlet concentration for
    ``sample_shards`` (None = the paper's one-class-per-client split); a
    ``noniid:α`` population trace overrides it per campaign.
    ``sp_overrides`` forwards scalar ``SystemParams`` fields (``B``,
    ``E_max``, ``rho``, ...) into every ``system_params`` cohort."""
    size: int
    seed: int = 0
    qc_range: Tuple[float, float] = (0.34e-3, 0.46e-3)
    qs_range: Tuple[float, float] = (1.2e-3, 1.6e-3)
    t_round_range: Tuple[float, float] = (50e-3, 100e-3)
    gain_sigma: float = 0.0
    data_alpha: Optional[float] = None
    sp_overrides: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(f"population size must be >= 1, got {self.size}")

    def rows(self, ids) -> Dict[str, np.ndarray]:
        """The per-client SystemParams rows for ``ids`` — O(len(ids))."""
        ids = np.asarray(ids, np.int64)
        out = {}
        for name, (lo, hi), tag in (("Q_C", self.qc_range, _TAG_QC),
                                    ("Q_S", self.qs_range, _TAG_QS),
                                    ("t_round", self.t_round_range,
                                     _TAG_TROUND)):
            out[name] = lo + (hi - lo) * _u01(ids, self.seed, tag)
        if self.gain_sigma > 0:
            u1 = np.maximum(_u01(ids, self.seed, _TAG_GAIN_U1), 1e-300)
            u2 = _u01(ids, self.seed, _TAG_GAIN_U2)
            z = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)
            out["G_m"] = np.exp(self.gain_sigma * z)
        else:
            out["G_m"] = np.ones(ids.shape)
        return out

    def system_params(self, ids) -> SystemParams:
        """A cohort-sized ``SystemParams`` (M = len(ids)) whose rows are
        the addressed clients' — the object the framework policies consume
        (``engine.make_policy`` derives S_m/omega/Q folding on a copy)."""
        ids = np.asarray(ids, np.int64)
        r = self.rows(ids)
        return SystemParams(M=len(ids), seed=self.seed, Q_C=r["Q_C"],
                            Q_S=r["Q_S"], t_round=r["t_round"],
                            G_m=r["G_m"], avail=np.ones(len(ids)),
                            **self.sp_overrides)

    def anchor_class(self, ids, n_classes: int) -> np.ndarray:
        """Round-robin slice-class anchor per client (the data partition's
        and the stratified sampler's stratum assignment)."""
        return np.asarray(ids, np.int64) % n_classes

    def sample_shards(self, X: np.ndarray, y: np.ndarray, ids,
                      samples_per_client: int,
                      alpha: Optional[float] = "population"
                      ) -> Dict[str, np.ndarray]:
        """Each addressed client's local dataset, drawn lazily.

        A client's shard is a FIXED per-id property: client ``cid`` draws
        from its own ``default_rng([pop.seed, tag, cid])`` stream, so the
        same id yields the same shard in every round, campaign and resume.
        ``alpha="population"`` uses the population's ``data_alpha``."""
        if alpha == "population":
            alpha = self.data_alpha
        ids = np.asarray(ids, np.int64)
        by_class = [np.where(y == c)[0] for c in range(oran.N_CLASSES)]
        n = int(samples_per_client)
        Xc = np.zeros((len(ids), n, X.shape[1]), np.float32)
        yc = np.zeros((len(ids), n), np.int32)
        cache: Dict[int, np.ndarray] = {}
        for i, cid in enumerate(ids):
            cid = int(cid)
            take = cache.get(cid)
            if take is None:
                rng = np.random.default_rng([self.seed, _TAG_DATA, cid])
                take = oran.draw_client_shard(
                    rng, by_class, n, alpha, cid % oran.N_CLASSES)
                cache[cid] = take
            Xc[i], yc[i] = X[take], y[take]
        return {"x": Xc, "y": yc}


# ---------------------------------------------------------------------------
# Population traces (the scenario engine's lazy counterpart)
# ---------------------------------------------------------------------------

_ONES_CHANNELS = ("gain", "qc_scale", "qs_scale", "avail", "drop",
                  "deadline_scale")


@dataclass(frozen=True)
class PopulationTrace:
    """A scenario trace over a population: the round-level state (``m_t``)
    is materialized O(R); the per-client channels are evaluated lazily for
    the cohorts the campaign actually samples (``channels(t, ids)``).

    Population traces draw the STATIONARY MARGINALS of the materialized
    generators (``scenario.make_trace``): AR(1) fades become their N(0,σ²)
    marginal, the Gilbert-Elliott availability its stationary up
    probability — per-client temporal correlation is unobservable when
    cohorts resample every round."""
    name: str
    seed: int
    rounds: int
    population: int
    m_t: np.ndarray                       # (R,) registered population size
    level: Optional[float] = None
    data_alpha: Optional[float] = None

    def channels(self, t: int, ids) -> Dict[str, np.ndarray]:
        """Round t's channel realizations for the addressed ids — each a
        ``(len(ids),)`` array keyed like ``ScenarioTrace``'s channels."""
        ids = np.asarray(ids, np.int64)
        ones = np.ones(ids.shape)
        ch = {k: ones for k in _ONES_CHANNELS}
        s, t = self.seed, int(t)
        if self.name == "fading":
            sigma = 0.5 if self.level is None else float(self.level)
            ch["gain"] = np.exp(sigma * _normal01(ids, s, _TAG_FADE_G, t))
            ch["qc_scale"] = np.exp(
                np.abs(0.25 * _normal01(ids, s, _TAG_FADE_QC, t)))
            ch["qs_scale"] = np.exp(
                np.abs(0.25 * _normal01(ids, s, _TAG_FADE_QS, t)))
            ch["deadline_scale"] = np.exp(
                0.08 * _normal01(ids, s, _TAG_FADE_DL, t))
        elif self.name == "straggler":
            p_fail = 0.25 if self.level is None else float(self.level)
            slow = _u01(ids, s, _TAG_SLOW) < 0.3      # persistent (no t)
            ch["qc_scale"] = np.where(slow, 3.0, 1.0) * np.exp(
                np.abs(0.2 * _normal01(ids, s, _TAG_FADE_QC, t)))
            ch["qs_scale"] = np.exp(
                np.abs(0.2 * _normal01(ids, s, _TAG_FADE_QS, t)))
            p_down = p_fail / max(p_fail + 0.5, 1e-12)
            ch["avail"] = (_u01(ids, s, _TAG_AVAIL, t)
                           >= p_down).astype(np.float64)
            ch["drop"] = (_u01(ids, s, _TAG_DROP, t)
                          >= 0.05).astype(np.float64)
        return ch

    def is_static(self) -> bool:
        """True when every per-client channel is the all-ones constant
        (static / churn / noniid — churn varies ``m_t``, not the rows)."""
        return self.name in ("static", "churn", "noniid")


def _pop_static(rounds, population, seed, level):
    return {}


def _pop_churn(rounds, population, seed, level):
    return {"m_t": churn_m_t(rounds, population, seed, level=level)}


def _pop_noniid(rounds, population, seed, level):
    return {"data_alpha": 0.3 if level is None else float(level)}


_POP_REGISTRY = {
    "static": _pop_static,
    "fading": _pop_static,      # per-client channels live in channels()
    "straggler": _pop_static,
    "churn": _pop_churn,
    "noniid": _pop_noniid,
}


def population_scenario_names() -> Tuple[str, ...]:
    return tuple(_POP_REGISTRY)


def make_population_trace(name: str, rounds: int, population: int, *,
                          seed: int = 0, level: Optional[float] = None
                          ) -> PopulationTrace:
    """Build the named population trace (same ``name:level`` grammar as
    ``scenario.make_trace``; the fault families are materialized-only —
    in-scan fault injection needs the full (R, M) channels)."""
    base, _, suffix = name.partition(":")
    if suffix:
        if level is not None:
            raise ValueError(f"level given twice: {name!r} and {level}")
        level = float(suffix)
    try:
        gen = _POP_REGISTRY[base]
    except KeyError:
        raise KeyError(
            f"unknown population scenario {name!r}; have "
            f"{population_scenario_names()} (fault injection is "
            f"materialized-only)") from None
    ch = gen(rounds, population, seed, level)
    m_t = ch.get("m_t")
    if m_t is None:
        m_t = np.full(rounds, population, np.int64)
    return PopulationTrace(name=base, seed=seed, rounds=rounds,
                           population=population, m_t=np.asarray(m_t),
                           level=level, data_alpha=ch.get("data_alpha"))


def get_population_trace(scenario, rounds: int, population: int, *,
                         seed: int = 0) -> Optional[PopulationTrace]:
    """Resolve a population-scenario argument: None → None (static fast
    path), a name → ``make_population_trace``, a ``PopulationTrace`` →
    validated pass-through."""
    if scenario is None:
        return None
    if isinstance(scenario, str):
        return make_population_trace(scenario, rounds, population, seed=seed)
    if not isinstance(scenario, PopulationTrace):
        raise TypeError(
            f"population scenario must be None, a name or a "
            f"PopulationTrace, got {type(scenario).__name__}")
    if scenario.population != population:
        raise ValueError(f"trace covers a population of "
                         f"{scenario.population}, need {population}")
    if scenario.rounds < rounds:
        raise ValueError(f"trace covers {scenario.rounds} rounds, "
                         f"need {rounds}")
    return scenario
