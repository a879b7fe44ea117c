"""The port's population mode (``repro_torch.core.population``,
``engine.build_cohort_round_fn``, ``campaign.plan_population_schedule`` and
``run_population_campaign``) against the JAX package on the CPU.

The size of tests/test_population.py: DNN 30→32→16→3 split after layer 1,
``oran.generate(n_per_class=300)``, 24 samples a client, seeds 0 and 1, K 4,
E 3.  Both sides get the JAX campaign's initial parameters and its batches
(and int8 uniforms), replayed from its key chains (``torch_parity``): the
population key chain is the materialized campaign's over the C cohort
positions.  Each JAX campaign runs once (module-scoped fixtures).

Bounds:

* exact for the hashes, cohorts, rows, shards, trace channels, plans,
  ``schedule_metrics(rows=)``, the schedule fingerprint and the system
  metrics (numpy copies of numpy code);
* 1e-5 of scale for f32 params and losses (each leaf's largest magnitude,
  at least 1: the JAX package's own f32 bound for values of order 1), and
  SplitMe's accuracy, evaluated at γ 10 (a well-conditioned ridge), within
  1e-5;
* 1e-3 under the bf16 precision (the reference's bf16 bound,
  tests/test_kernel_dispatch.py) and 6e-2 on the int8 wire
  (tests/test_torch_quantcomm.py's ``WIRE_TOL["int8"]``);
* the full-population cohort against the port's own materialized
  ``run_campaign`` on the same rows and shards at 1e-5 (the reference's
  population parity bound), and a resumed campaign against the
  uninterrupted one bit for bit.
"""
import tracemalloc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.splitme_dnn import DNNConfig as JDNNConfig
from repro.core import cost as jcost
from repro.core import engine as jengine
from repro.core import population as jpopn
from repro.kernels.dispatch import BF16 as JBF16
from repro.kernels.dispatch import KernelPolicy as JKernelPolicy
from repro.launch import campaign as jcampaign
from repro.launch import resilience as jresilience
from repro_torch.configs.splitme_dnn import DNNConfig
from repro_torch.core import cost, engine, population as popn, quantcomm
from repro_torch.core.engine import RoundGuards
from repro_torch.data import oran
from repro_torch.kernels.dispatch import BF16, KernelPolicy
from repro_torch.launch import campaign, resilience
from torch_parity import (CampaignIndexReplay, CampaignUniformReplay,
                          jax_initial_params, jax_to_torch, one_torch_thread,
                          replay_round_indices, replay_round_uniforms)

_CFG = dict(hidden=(32, 16), split_index=1)
CFG, JCFG = DNNConfig(**_CFG), JDNNConfig(**_CFG)
N, B = 24, 32
SEEDS = (0, 1)
F32_TOL, BF16_TOL, INT8_TOL = 1e-5, 1e-3, 6e-2
FRAMEWORKS = ("splitme", "fedavg", "sfl", "oranfed", "fedora", "ecofl")
PLAN_SCENARIOS = (None, "churn:0.5", "fading", "straggler:0.4", "noniid:0.3")
TRACE_NAMES = ("static", "fading", "fading:0.8", "straggler",
               "straggler:0.4", "churn", "churn:0.5", "noniid",
               "noniid:0.1")
SP_FIELDS = ("M", "B", "E_max", "rho", "seed", "omega", "d_model_bits",
             "Q_C", "Q_S", "t_round", "G_m", "avail", "S_m")


@pytest.fixture(scope="module")
def pools():
    X, y = oran.generate(n_per_class=300, seed=0)
    return oran.train_test_split(X, y)


# ---------------------------------------------------------------------------
# repro_torch.core.population against repro.core.population, exactly
# ---------------------------------------------------------------------------

def test_hashes_are_bit_identical():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2 ** 63, 4096, dtype=np.uint64) * np.uint64(2) \
        + rng.integers(0, 2, 4096, dtype=np.uint64)
    np.testing.assert_array_equal(popn._mix(x), jpopn._mix(x))
    ids = np.concatenate([np.arange(100), [10 ** 6 - 1, 2 ** 40 + 7]])
    for key in ((0,), (3, 0x51C0), (7, 0x51C8, 12), (2 ** 62, 1, 2, 3)):
        got, want = popn._u01(ids, *key), jpopn._u01(ids, *key)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype and (got >= 0).all() and (got < 1).all()
        np.testing.assert_array_equal(popn._normal01(ids, *key),
                                      jpopn._normal01(ids, *key))


# (seed, t, m_t, cohort, stratified, n_strata): sparse, dense (2k >= m),
# k >= m, one client, and strata clamped by their size
COHORT_CASES = [(0, 0, 10 ** 6, 32, False, 3), (7, 3, 10_000, 64, False, 3),
                (1, 5, 10, 7, False, 3), (0, 0, 5, 8, False, 3),
                (4, 2, 1, 1, False, 3), (9, 11, 60, 29, False, 3),
                (3, 0, 9_999, 30, True, 3), (3, 4, 10 ** 6, 32, True, 3),
                (5, 1, 4, 3, True, 3), (5, 2, 7, 6, True, 3),
                (6, 0, 50, 50, True, 3), (2, 9, 11, 5, True, 4),
                (8, 1, 1001, 17, True, 2)]


@pytest.mark.parametrize("case", COHORT_CASES, ids=str)
def test_sample_cohort_matches_reference(case):
    seed, t, m_t, cohort, stratified, n_strata = case
    got = popn.sample_cohort(seed, t, m_t, cohort, stratified=stratified,
                             n_strata=n_strata)
    want = jpopn.sample_cohort(seed, t, m_t, cohort, stratified=stratified,
                               n_strata=n_strata)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.int64
    assert len(np.unique(got)) == min(cohort, m_t) and got.max() < m_t


def test_sample_cohort_rejects_an_empty_population():
    for mod in (popn, jpopn):
        with pytest.raises(ValueError):
            mod.sample_cohort(0, 0, 0, 4)


@pytest.mark.parametrize("gain_sigma", [0.0, 0.3])
def test_rows_and_system_params_match_reference_at_a_million(gain_sigma):
    kw = dict(size=10 ** 6, seed=5, gain_sigma=gain_sigma,
              sp_overrides={"E_max": 8, "B": 2e9})
    pop, jpop = popn.Population(**kw), jpopn.Population(**kw)
    ids = popn.sample_cohort(1, 0, 10 ** 6, 64)
    ids = np.concatenate([ids, [0, 999_999, ids[3]]])
    got, want = pop.rows(ids), jpop.rows(ids)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    sp, jsp = pop.system_params(ids), jpop.system_params(ids)
    for f in SP_FIELDS:
        np.testing.assert_array_equal(getattr(sp, f), getattr(jsp, f))
    np.testing.assert_array_equal(pop.anchor_class(ids, 3),
                                  jpop.anchor_class(ids, 3))
    # id-addressable: one id alone is its row of the cohort
    one = pop.rows(ids[5:6])
    for k in want:
        assert one[k][0] == want[k][5]


@pytest.mark.parametrize("alpha", [None, 0.3, "population"])
def test_sample_shards_match_reference(pools, alpha):
    (X, y), _ = pools
    kw = dict(size=10 ** 6, seed=2, data_alpha=0.5)
    ids = np.array([5, 900, 123_456, 5, 999_999, 2], np.int64)
    got = popn.Population(**kw).sample_shards(X, y, ids, N, alpha=alpha)
    want = jpopn.Population(**kw).sample_shards(X, y, ids, N, alpha=alpha)
    for k in ("x", "y"):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    np.testing.assert_array_equal(got["x"][0], got["x"][3])


@pytest.mark.parametrize("name", TRACE_NAMES)
@pytest.mark.parametrize("seed", [0, 4])
def test_trace_channels_match_reference(name, seed):
    R, P = 9, 10 ** 6
    got = popn.make_population_trace(name, R, P, seed=seed)
    want = jpopn.make_population_trace(name, R, P, seed=seed)
    assert (got.name, got.seed, got.rounds, got.population, got.level,
            got.data_alpha) == (want.name, want.seed, want.rounds,
                                want.population, want.level, want.data_alpha)
    np.testing.assert_array_equal(got.m_t, want.m_t)
    assert got.m_t.dtype == want.m_t.dtype
    assert got.is_static() == want.is_static()
    for t in range(R):
        ids = jpopn.sample_cohort(seed, t, want.m_t[t], 16)
        g, w = got.channels(t, ids), want.channels(t, ids)
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_trace_registry_and_resolution_match_reference():
    assert popn.population_scenario_names() == \
        jpopn.population_scenario_names()
    for bad in ("faults:0.3", "faults", "nope"):
        for mod in (popn, jpopn):
            with pytest.raises(KeyError):
                mod.make_population_trace(bad, 4, 100)
    for mod in (popn, jpopn):
        with pytest.raises(ValueError):
            mod.make_population_trace("churn:0.5", 4, 100, level=0.3)
        assert mod.get_population_trace(None, 4, 100) is None
        tr = mod.get_population_trace("fading", 4, 100, seed=2)
        assert mod.get_population_trace(tr, 3, 100) is tr
        with pytest.raises(ValueError):
            mod.get_population_trace(tr, 5, 100)
        with pytest.raises(ValueError):
            mod.get_population_trace(tr, 4, 101)
        with pytest.raises(TypeError):
            mod.get_population_trace(3, 4, 100)


# ---------------------------------------------------------------------------
# the host plan, its metrics and its fingerprint
# ---------------------------------------------------------------------------

def _plans(fw, scenario, stratified=False, size=10 ** 6, cohort=16,
           rounds=8, **kw):
    args = dict(rounds=rounds, cohort=cohort, policy_seed=0, K=4, E=3,
                n_samples_per_client=N, scenario=scenario, scenario_seed=2,
                stratified=stratified, **kw)
    got = campaign.plan_population_schedule(
        fw, popn.Population(size, seed=3), CFG, **args)
    want = jcampaign.plan_population_schedule(
        fw, jpopn.Population(size, seed=3), JCFG, **args)
    return got, want


def _same_plan(got, want):
    (sp, sched), (jsp, jsched) = got, want
    for f in SP_FIELDS:
        np.testing.assert_array_equal(getattr(sp, f), getattr(jsp, f))
    for f in ("ids", "a", "b", "E", "m_t", "cohort_sizes"):
        g, w = getattr(sched, f), getattr(jsched, f)
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype, f
    assert set(sched.rows) == set(jsched.rows)
    for k in jsched.rows:
        np.testing.assert_array_equal(sched.rows[k], jsched.rows[k])
    assert (sched.trace is None) == (jsched.trace is None)


@pytest.mark.parametrize("scenario", PLAN_SCENARIOS)
@pytest.mark.parametrize("fw", FRAMEWORKS)
def test_plan_matches_reference(fw, scenario):
    _same_plan(*_plans(fw, scenario))


@pytest.mark.parametrize("fw", FRAMEWORKS)
def test_stratified_plan_matches_reference(fw):
    _same_plan(*_plans(fw, "churn:0.5", stratified=True))


@pytest.mark.parametrize("quant", [None, "int8"])
def test_schedule_metrics_rows_match_reference(quant):
    (sp, sched), (jsp, jsched) = _plans("splitme", "straggler:0.4",
                                        quant=quant)
    got = cost.schedule_metrics(sched.a, sched.b, sched.E, sp,
                                rows=sched.rows)
    want = jcost.schedule_metrics(jsched.a, jsched.b, jsched.E, jsp,
                                  rows=jsched.rows)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        cost.schedule_metrics(sched.a, sched.b, sched.E, sp,
                              rows=sched.rows, trace=object())


def test_fingerprint_extra_matches_reference():
    (_, sched), (_, jsched) = _plans("fedavg", "churn:0.5")
    do_eval = np.zeros(sched.rounds, bool)
    do_eval[-1] = True
    kw = dict(do_eval=do_eval, quant_mode="none", checkpoint_every=2)
    plain = resilience.schedule_fingerprint("fedavg", SEEDS, sched, **kw)
    got = resilience.schedule_fingerprint(
        "fedavg", SEEDS, sched, extra=(sched.ids, sched.m_t), **kw)
    want = jresilience.schedule_fingerprint(
        "fedavg", SEEDS, jsched, extra=(jsched.ids, jsched.m_t), **kw)
    assert got == want != plain
    assert plain == jresilience.schedule_fingerprint("fedavg", SEEDS,
                                                     jsched, **kw)


def test_million_client_plan_is_cohort_sized():
    """30 rounds at 10^6 clients: every array is (rounds, cohort) or
    (rounds,), and the plan's host memory stays far below one O(10^6)
    float64 array (8 MB)."""
    tracemalloc.start()
    sp, sched = campaign.plan_population_schedule(
        "splitme", popn.Population(10 ** 6, seed=0), CFG, 30, cohort=32,
        n_samples_per_client=96, scenario="churn:0.5")
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    assert sp.M == 32 and sched.ids.shape == sched.a.shape == (30, 32)
    assert all(v.shape == (30, 32) for v in sched.rows.values())
    assert sched.E.shape == sched.m_t.shape == (30,)
    assert len(np.unique(sched.m_t)) > 1
    assert (sched.ids.max(axis=1) < sched.m_t).all()
    assert sched.ids.max() > 10 ** 5             # sampled deep
    assert peak < 2e6, f"plan peak {peak} bytes"


# ---------------------------------------------------------------------------
# build_cohort_round_fn against the reference's cohort round
# ---------------------------------------------------------------------------

C_ROUND, E_ROUND = 6, 3
ROUND_VARIANTS = {"f32": (dict(), dict(), F32_TOL),
                  "bf16": (dict(policy=JKernelPolicy(precision=JBF16)),
                           dict(policy=KernelPolicy(precision=BF16)),
                           BF16_TOL),
                  "int8": (dict(quant="int8"), dict(quant="int8"),
                           INT8_TOL)}


def _cohort_round(pools, fw, variant, guards):
    (X, y), _ = pools
    jkw, kw, tol = ROUND_VARIANTS[variant]
    ids = np.array([3, 17, 400, 401, 9_000, 3], np.int64)
    sh = popn.Population(10 ** 4, seed=1).sample_shards(X, y, ids, N)
    a = np.array([1, 0, 1, 1, 1, 0], np.float32)
    jg = None if guards is None else jengine.RoundGuards(clip_norm=guards)
    tg = None if guards is None else RoundGuards(clip_norm=guards)
    jspec = jengine.make_spec(fw, JCFG, masked_loss_metric=True, **jkw)
    jround = jengine.build_cohort_round_fn(jspec, JCFG, e_max=E_ROUND + 1,
                                           donate=False, guards=jg)
    key = jax.random.PRNGKey(4)
    init = jspec.init_fn(jax.random.PRNGKey(1))
    jq = jengine.init_quant_state(jspec, init)
    want = jround(init, jnp.asarray(sh["x"]), jnp.asarray(sh["y"]),
                  jnp.asarray(a), jnp.asarray(E_ROUND), key, jq)
    spec = engine.make_spec(fw, CFG, masked_loss_metric=True, device="cpu",
                            **kw)
    n_ph = len(spec.phases)
    params = tuple(jax_to_torch(p) for p in init)
    u = None
    if variant == "int8":
        u = torch.from_numpy(replay_round_uniforms(
            key, {i: init[i] for i in range(n_ph)}))
    fn = engine.build_cohort_round_fn(spec, CFG, e_max=E_ROUND + 1,
                                      guards=tg)
    idx = torch.from_numpy(replay_round_indices(key, n_ph, len(ids),
                                                E_ROUND + 1, B, N))
    got = fn(params, torch.from_numpy(sh["x"]), torch.from_numpy(sh["y"]),
             torch.from_numpy(a), E_ROUND, idx,
             engine.init_quant_state(spec, params), u)
    return got, want, tol, (spec, params, sh, a, idx, u)


def _tree_err(got, want) -> float:
    return max(float(np.abs(np.asarray(g) - np.asarray(w)).max())
               / max(1.0, float(np.abs(np.asarray(w)).max()))
               for g, w in zip(quantcomm.tree_leaves(got),
                               jax.tree.leaves(jax.device_get(want))))


@pytest.mark.parametrize("guards", [None, 1.0], ids=["noguards", "clip1"])
@pytest.mark.parametrize("variant", list(ROUND_VARIANTS))
@pytest.mark.parametrize("fw", ["splitme", "fedavg"])
def test_cohort_round_matches_jax(pools, fw, variant, guards):
    """One cohort round (6 positions, 4 selected, a pad repeating the first
    id, E 3 of 4 steps) with the reference's batches and uniforms: params,
    losses and the error-feedback state within the variant's bound, the
    guard flags exactly."""
    got, want, tol, _ = _cohort_round(pools, fw, variant, guards)
    assert len(got) == len(want) == (3 if guards is None else 4)
    assert _tree_err(got[0], want[0]) <= tol
    for g, w in zip(got[1], want[1]):
        assert abs(float(g) - float(w)) <= tol * max(1.0, abs(float(w)))
    if variant == "int8":
        assert _tree_err(got[2], want[2]) <= tol
    else:
        assert got[2] == () and want[2] == ()
    if guards is not None:
        for k in ("skipped", "quorum"):
            assert float(got[3][k]) == float(want[3][k])


@pytest.mark.parametrize("variant", list(ROUND_VARIANTS))
def test_gathered_cohort_round_equals_the_full_one(pools, variant):
    """``gather=True`` over the selected slots, two seeds folded, equals
    the full-C round of each seed (the same draws gathered by position):
    params and losses within 1e-6 of scale (the masked sums add in another
    order; on the int8 wire that may move a stochastic rounding by a grid
    step: ``INT8_TOL``)."""
    tol = INT8_TOL if variant == "int8" else 1e-6
    _, _, _, (spec, params, sh, a, idx, u) = _cohort_round(
        pools, "splitme", variant, None)
    full = engine.build_cohort_round_fn(spec, CFG, e_max=E_ROUND + 1)
    gathered = engine.build_cohort_round_fn(spec, CFG, e_max=E_ROUND + 1,
                                            gather=True)
    sel = np.concatenate([np.nonzero(a)[0], [0]])       # one pad slot
    mask = torch.tensor([1.0] * int(a.sum()) + [0.0])
    other = quantcomm.tree_map(lambda v: v * 0.5 + 0.01, params)
    stack = quantcomm.tree_map(lambda p, q: torch.stack([p, q]), params,
                               other)
    idx2 = torch.stack([idx, idx.flip(0)])
    u2 = None if u is None else torch.stack([u, u.flip(0)])
    xs, ys = torch.from_numpy(sh["x"][sel]), torch.from_numpy(sh["y"][sel])
    gp, gl, gq = gathered(stack, xs, ys, torch.from_numpy(sel), mask, E_ROUND,
                          idx2, engine.init_quant_state(spec, stack), u2)
    for i, (p, ix) in enumerate(((params, idx), (other, idx.flip(0)))):
        wp, wl, wq = full(p, torch.from_numpy(sh["x"]),
                          torch.from_numpy(sh["y"]), torch.from_numpy(a),
                          E_ROUND, ix, engine.init_quant_state(spec, p),
                          None if u2 is None else u2[i])
        mine = quantcomm.tree_map(lambda v: v[i], (gp, gq))
        for g, w in zip(quantcomm.tree_leaves(mine),
                        quantcomm.tree_leaves((wp, wq))):
            assert (g - w).abs().max() <= tol * max(1.0, w.abs().max())
        for g, w in zip(gl, wl):
            assert abs(float(g[i]) - float(w)) <= tol


def test_cohort_round_checks_its_arguments(pools):
    _, _, _, (spec, params, sh, a, idx, _) = _cohort_round(
        pools, "splitme", "f32", None)
    fn = engine.build_cohort_round_fn(spec, CFG, e_max=E_ROUND + 1)
    x, yl = torch.from_numpy(sh["x"]), torch.from_numpy(sh["y"])
    with pytest.raises(ValueError):                     # idx of another C
        fn(params, x, yl, torch.from_numpy(a), E_ROUND, idx[:, 1:])
    with pytest.raises(ValueError):                     # labels' shape
        fn(params, x, yl[:, 1:], torch.from_numpy(a), E_ROUND, idx)
    with pytest.raises(TypeError):                      # bf16 under f32
        fn(params, x.bfloat16(), yl, torch.from_numpy(a), E_ROUND, idx)
    with pytest.raises(ValueError):                     # uniforms, no int8
        fn(params, x, yl, torch.from_numpy(a), E_ROUND, idx, (),
           torch.zeros(3))
    with pytest.raises(TypeError):
        engine.build_cohort_round_fn(spec, CFG, e_max=2, guards=1.0)


# ---------------------------------------------------------------------------
# whole population campaigns against the reference's
# ---------------------------------------------------------------------------

CAMPAIGN = dict(rounds=4, seeds=SEEDS, cohort=8, samples_per_client=N,
                K=4, E=3, eval_every=2, eval_gamma=10.0)


def _pair(fw, pools, size=1000, jkw=None, tkw=None, **kw):
    """The JAX population campaign and the port's on the same draws
    (``kw`` to both, ``jkw`` to JAX's, ``tkw`` to the port's), with the
    port's host transfers under strict_transfers."""
    (X, y), test = pools
    kw = dict(CAMPAIGN, test_data=test, **kw)
    want = jcampaign.run_population_campaign(
        fw, JCFG, jpopn.Population(size, seed=3), (X, y), **kw,
        **(jkw or {}))
    init = jax_initial_params(fw, JCFG, SEEDS)
    n_ph = 2 if fw == "splitme" else 1
    C = min(kw["cohort"], size)
    us = None
    if kw.get("quant") == "int8":
        us = CampaignUniformReplay(SEEDS, {i: init[0][i]
                                           for i in range(n_ph)})
    campaign.HOST_TRANSFERS = 0
    got = campaign.run_population_campaign(
        fw, CFG, popn.Population(size, seed=3), (X, y), device="cpu",
        params=init, strict_transfers=True, uniform_source=us,
        index_source=CampaignIndexReplay(SEEDS, C, B, N, n_phases=n_ph),
        **kw, **(tkw or {}))
    return want, got, campaign.HOST_TRANSFERS


def _assert_campaign_matches(want, got, tol):
    for f in ("ids", "a", "b", "E", "m_t", "cohort_sizes"):
        np.testing.assert_array_equal(getattr(got.schedule, f),
                                      getattr(want.schedule, f))
    for mg, mw in zip(got.metrics, want.metrics):
        for f in ("n_selected", "E", "comm_bits", "sim_time", "cost",
                  "energy", "skipped", "quorum_held"):
            assert getattr(mg, f) == getattr(mw, f), f
    assert _tree_err(got.params, want.params) <= tol
    np.testing.assert_array_equal(np.isnan(got.losses), np.isnan(want.losses))
    ok = ~np.isnan(want.losses)
    assert (np.abs(got.losses[ok] - want.losses[ok])
            <= tol * np.maximum(1.0, np.abs(want.losses[ok]))).all()
    np.testing.assert_array_equal(np.isnan(got.accuracy_per_round),
                                  np.isnan(want.accuracy_per_round))
    np.testing.assert_allclose(got.accuracy_per_round,
                               want.accuracy_per_round, atol=1e-5, rtol=0)


@pytest.fixture(scope="module", params=FRAMEWORKS)
def f32_runs(request, pools):
    return request.param, _pair(request.param, pools)


def test_population_campaign_matches_jax(f32_runs):
    """Population 1000, cohort 8, 4 rounds, Step 4 (γ 10) after rounds 1
    and 3: schedules and metrics exactly, params and losses at 1e-5 of
    scale, per-round accuracy at 1e-5, one host transfer."""
    fw, (want, got, transfers) = f32_runs
    assert transfers == 1
    assert got.losses.shape == want.losses.shape
    assert got.graphs is None                   # the CPU runs no graphs
    _assert_campaign_matches(want, got, F32_TOL)


@pytest.mark.parametrize("case", ["churn_million", "bf16", "int8_clip"])
def test_population_campaign_variants_match_jax(pools, case):
    """SplitMe under ``churn:0.5`` at 10^6 clients (cohort 8); under the
    bf16 precision (1e-3); FedAvg on the int8 wire with
    ``RoundGuards(clip_norm=1.0)`` (6e-2; the flags exactly)."""
    if case == "churn_million":
        want, got, transfers = _pair("splitme", pools, size=10 ** 6,
                                     scenario="churn:0.5")
        assert got.schedule.ids.max() > 10 ** 4
        assert len(np.unique(got.schedule.m_t)) > 1
        tol = F32_TOL
    elif case == "bf16":
        want, got, transfers = _pair(
            "splitme", pools, jkw=dict(policy=JKernelPolicy(precision=JBF16)),
            tkw=dict(policy=KernelPolicy(precision=BF16)))
        tol = BF16_TOL
    else:
        want, got, transfers = _pair(
            "fedavg", pools, quant="int8", scenario="straggler:0.4",
            jkw=dict(guards=jengine.RoundGuards(clip_norm=1.0)),
            tkw=dict(guards=RoundGuards(clip_norm=1.0)))
        np.testing.assert_array_equal(got.skipped_per_round,
                                      want.skipped_per_round)
        np.testing.assert_array_equal(got.quorum_per_round,
                                      want.quorum_per_round)
        assert len(quantcomm.tree_leaves(got.qstate)) > 0
        tol = INT8_TOL
    assert transfers == 1
    _assert_campaign_matches(want, got, tol)


def test_faults_are_rejected_in_population_mode(pools):
    (X, y), _ = pools
    with pytest.raises(KeyError):
        campaign.run_population_campaign(
            "splitme", CFG, popn.Population(100), (X, y), rounds=2,
            seeds=(0,), cohort=4, scenario="faults:0.3", device="cpu")


# ---------------------------------------------------------------------------
# the full-population cohort against the port's materialized campaign
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fw", FRAMEWORKS)
def test_full_population_cohort_matches_materialized(pools, fw):
    """Population 10 with cohort 10, no scenario: the plan equals
    ``plan_schedule`` on ``system_params(arange(10))``, and the campaign
    the materialized ``run_campaign`` on those rows and on
    ``sample_shards(arange(10))`` at 1e-5 (default draws on both sides:
    position m is client m)."""
    (X, y), test = pools
    M = 10
    pop = popn.Population(M, seed=3)
    kw = dict(rounds=3, seeds=SEEDS, test_data=test, K=4, E=3,
              eval_every=2, eval_gamma=10.0, device="cpu")
    res_p = campaign.run_population_campaign(fw, CFG, pop, (X, y), cohort=M,
                                             samples_per_client=N, **kw)
    ids = np.arange(M)
    res_m = campaign.run_campaign(fw, CFG, pop.system_params(ids),
                                  pop.sample_shards(X, y, ids, N), **kw)
    for f in ("a", "b", "E"):
        np.testing.assert_array_equal(getattr(res_p.schedule, f),
                                      getattr(res_m.schedule, f))
    np.testing.assert_array_equal(res_p.schedule.ids, np.tile(ids, (3, 1)))
    for mp, mm in zip(res_p.metrics, res_m.metrics):
        assert mp.n_selected == mm.n_selected and mp.E == mm.E
        assert mp.comm_bits == mm.comm_bits
        np.testing.assert_allclose([mp.sim_time, mp.cost, mp.energy],
                                   [mm.sim_time, mm.cost, mm.energy],
                                   rtol=1e-12)
    for p, q in zip(quantcomm.tree_leaves(res_p.params),
                    quantcomm.tree_leaves(res_m.params)):
        assert (p - q).abs().max() <= F32_TOL
    np.testing.assert_allclose(res_p.losses, res_m.losses, atol=F32_TOL,
                               rtol=0)
    np.testing.assert_allclose(res_p.accuracy_per_round,
                               res_m.accuracy_per_round, atol=F32_TOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# checkpoints and resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fw,quant", [("fedavg", None), ("splitme", "int8")])
def test_population_resume_is_bitwise(pools, tmp_path, fw, quant):
    """Checkpoints every 2 rounds, an abort at round 2, a resume: params,
    losses, accuracy, the error-feedback state and the metrics equal the
    uninterrupted run bit for bit, and the checkpoint's fingerprint is the
    reference's for the same plan (cohort ids and m_t included)."""
    (X, y), test = pools
    pop = popn.Population(5_000, seed=1)
    kw = dict(rounds=4, seeds=SEEDS, cohort=6, samples_per_client=16,
              test_data=test, scenario="churn:0.5", eval_every=2,
              checkpoint_every=2, quant=quant, device="cpu")
    full = campaign.run_population_campaign(fw, CFG, pop, (X, y),
                                            checkpoint_dir=tmp_path / "a",
                                            **kw)

    def abort(cursor):
        if cursor == 2:
            raise resilience.CampaignAborted("abort")

    d = tmp_path / "b"
    with pytest.raises(resilience.CampaignAborted):
        campaign.run_population_campaign(fw, CFG, pop, (X, y),
                                         checkpoint_dir=d,
                                         _checkpoint_hook=abort, **kw)
    latest = resilience.latest_checkpoint(d)
    assert latest.name == resilience.checkpoint_tag(2)
    resumed = campaign.run_population_campaign(fw, CFG, pop, (X, y),
                                               checkpoint_dir=d, resume=True,
                                               **kw)
    for a, b in zip(quantcomm.tree_leaves((resumed.params, resumed.qstate)),
                    quantcomm.tree_leaves((full.params, full.qstate))):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(resumed.losses, full.losses)
    np.testing.assert_array_equal(resumed.accuracy_per_round,
                                  full.accuracy_per_round)
    assert [repr(m) for m in resumed.metrics] == [repr(m)
                                                  for m in full.metrics]
    assert np.isnan(resumed.round_ms[:2]).all()
    # the reference's digest of the same plan
    _, jsched = jcampaign.plan_population_schedule(
        fw, jpopn.Population(5_000, seed=1), JCFG, 4, cohort=6,
        policy_seed=0, n_samples_per_client=16, quant=quant,
        scenario="churn:0.5")
    do_eval = np.zeros(4, np.float32)
    do_eval[1::2] = 1.0
    want = jresilience.schedule_fingerprint(
        fw, SEEDS, jsched, do_eval=do_eval, quant_mode=quant or "none",
        checkpoint_every=2, extra=(jsched.ids, jsched.m_t))
    assert resilience.load_checkpoint_meta(latest)["fingerprint"] == want
    # a drifted cohort plan is refused
    with pytest.raises(ValueError, match="fingerprint"):
        campaign.run_population_campaign(
            fw, CFG, pop, (X, y), checkpoint_dir=d, resume=True,
            scenario_seed=1, **{k: v for k, v in kw.items()})


def test_default_draws_are_deterministic_and_checked(pools):
    """Without sources each seed's generator draws the weights and the
    batches over the cohort positions: two runs are equal bit for bit; an
    index source of the wrong shape is refused."""
    (X, y), test = pools
    kw = dict(rounds=3, seeds=SEEDS, cohort=8, samples_per_client=N,
              test_data=test, device="cpu", scenario="churn:0.5")
    pop = popn.Population(10 ** 6, seed=0)
    a = campaign.run_population_campaign("splitme", CFG, pop, (X, y), **kw)
    b = campaign.run_population_campaign("splitme", CFG, pop, (X, y), **kw)
    for p, q in zip(quantcomm.tree_leaves(a.params),
                    quantcomm.tree_leaves(b.params)):
        assert torch.equal(p, q)
    np.testing.assert_array_equal(a.losses, b.losses)
    assert np.isfinite(a.losses).all() and np.isfinite(a.accuracy).all()
    with pytest.raises(ValueError):
        campaign.run_population_campaign(
            "splitme", CFG, pop, (X, y),
            index_source=lambda i, r, eb: np.zeros((2, 9, eb, B), np.int64),
            **kw)
