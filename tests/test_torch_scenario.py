"""The port's time-varying RAN (``repro_torch.core.scenario``) against the
JAX package's ``repro.core.scenario`` on the CPU: the traces of every
generator, their resolution and application, the Dirichlet partition, the
schedules every framework plans under a trace, the trace-aware system
metrics, and campaigns and trainers under a scenario.

Bounds: exact for traces, partitions, schedules and metrics (numpy copies
of numpy code); 1e-5 for params and losses (the JAX package's own f32
bound), with the reference's own initial parameters and batches replayed
from its key chains (tests/torch_parity.py).  A trace with fault channels
is a later slice of the port and raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.splitme_dnn import DNN10 as JDNN10
from repro.configs.splitme_dnn import DNNConfig as JDNNConfig
from repro.core import baselines as jbaselines
from repro.core import cost as jcost
from repro.core import engine as jengine
from repro.core import scenario as jscenario
from repro.core.cost import SystemParams as JSystemParams
from repro.core.splitme import SplitMeTrainer as JSplitMeTrainer
from repro.data import oran as joran
from repro.launch import campaign as jcampaign
from repro_torch.configs.splitme_dnn import DNN10, DNNConfig
from repro_torch.core import baselines, cost, engine, scenario
from repro_torch.core.cost import SystemParams
from repro_torch.core.splitme import SplitMeTrainer
from repro_torch.data import oran
from repro_torch.launch import campaign
from torch_parity import (CampaignIndexReplay, TrainerIndexReplay,
                          assert_params_close, one_torch_thread)

# each registry name at its default level and at one other
LEVELS = {"static": None, "fading": 0.8, "straggler": 0.4, "noniid": 0.1,
          "faults": 0.2, "churn": 0.5}
CHANNELS = ("gain", "qc_scale", "qs_scale", "avail", "drop",
            "deadline_scale", "poison", "crash", "wire_gain", "m_t")
FIELDS = ("Q_C", "Q_S", "t_round", "G_m", "avail", "S_m")
PLAN_SCENARIOS = ("fading", "straggler:0.4", "churn:0.5", "static")


def _same_trace(got, want):
    assert (got.name, got.seed, got.level, got.data_alpha) == \
        (want.name, want.seed, want.level, want.data_alpha)
    for ch in CHANNELS:
        g, w = getattr(got, ch), getattr(want, ch)
        assert (g is None) == (w is None), ch
        if w is not None:
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype, ch
    assert got.is_static() == want.is_static()
    assert got.has_faults() == want.has_faults()


def test_registry_matches_reference():
    assert scenario.scenario_names() == jscenario.scenario_names()
    assert set(LEVELS) == set(scenario.scenario_names())
    assert scenario.WIRE_FLIP_GAIN == jscenario.WIRE_FLIP_GAIN


@pytest.mark.parametrize("name", list(LEVELS))
@pytest.mark.parametrize("levelled", [False, True])
@pytest.mark.parametrize("seed", [0, 5])
def test_make_trace_matches_reference(name, levelled, seed):
    full = f"{name}:{LEVELS[name]}" if levelled and LEVELS[name] else name
    got = scenario.make_trace(full, 9, 13, seed=seed)
    want = jscenario.make_trace(full, 9, 13, seed=seed)
    _same_trace(got, want)
    if name != "churn":
        return
    for lvl in (None, 0.3):
        np.testing.assert_array_equal(
            scenario.churn_m_t(9, 13, seed, level=lvl),
            jscenario.churn_m_t(9, 13, seed, level=lvl))


def test_make_trace_errors_match_reference():
    for mod in (scenario, jscenario):
        with pytest.raises(KeyError):
            mod.make_trace("nope", 3, 4)
        with pytest.raises(ValueError, match="twice"):
            mod.make_trace("fading:0.3", 3, 4, level=0.2)


def test_get_trace_resolves_truncates_and_checks():
    assert scenario.get_trace(None, 4, 6) is None
    _same_trace(scenario.get_trace("straggler:0.4", 4, 6, seed=2),
                jscenario.get_trace("straggler:0.4", 4, 6, seed=2))
    for name in ("faults:0.3", "churn", "fading"):
        long_ = scenario.make_trace(name, 10, 6, seed=1)
        jlong = jscenario.make_trace(name, 10, 6, seed=1)
        _same_trace(scenario.get_trace(long_, 4, 6),
                    jscenario.get_trace(jlong, 4, 6))
        assert scenario.get_trace(long_, 10, 6) is long_
        with pytest.raises(ValueError, match="clients"):
            scenario.get_trace(long_, 4, 7)
        with pytest.raises(ValueError, match="rounds"):
            scenario.get_trace(long_, 11, 6)
    with pytest.raises(TypeError):
        scenario.get_trace(object(), 4, 6)


def test_apply_restore_and_realized_mask_match_reference():
    """``apply_round`` rewrites the derived copy round by round from the
    captured base, ``restore_base`` puts it back; ``realized_mask`` drops
    the failed clients and keeps the first when all drop."""
    sp, _ = engine.make_policy("fedora", SystemParams(M=10, seed=2), DNN10)
    jsp, _ = jengine.make_policy("fedora", JSystemParams(M=10, seed=2),
                                 JDNN10)
    trace = scenario.make_trace("fading", 6, 10, seed=3)
    jtrace = jscenario.make_trace("fading", 6, 10, seed=3)
    base, jbase = scenario.capture_base(sp), jscenario.capture_base(jsp)
    for t in range(6):
        scenario.apply_round(sp, base, trace, t)
        jscenario.apply_round(jsp, jbase, jtrace, t)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(sp, f), getattr(jsp, f))
    with pytest.raises(ValueError, match="horizon"):
        scenario.apply_round(sp, base, trace, 6)
    scenario.restore_base(sp, base)
    jscenario.restore_base(jsp, jbase)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(sp, f), getattr(jsp, f))
    for f in ("Q_C", "Q_S", "t_round", "G_m", "avail"):
        np.testing.assert_array_equal(getattr(sp, f), getattr(base, f))
    strag = scenario.make_trace("straggler:0.9", 40, 10, seed=1)
    jstrag = jscenario.make_trace("straggler:0.9", 40, 10, seed=1)
    rng = np.random.default_rng(0)
    for t in range(40):
        a = (rng.random(10) < 0.3).astype(np.float64)
        got = scenario.realized_mask(a, strag, t)
        np.testing.assert_array_equal(got, jscenario.realized_mask(a, jstrag,
                                                                   t))
    one = np.zeros(10)
    one[4] = 1.0
    drop_all = scenario.ScenarioTrace(**{**strag.__dict__,
                                         "drop": np.zeros((40, 10))})
    np.testing.assert_array_equal(scenario.realized_mask(one, drop_all, 0),
                                  one)


@pytest.mark.parametrize("alpha", [0.0, 1e-7, 0.1, 0.3, 5.0])
def test_partition_dirichlet_and_partition_for_match_reference(alpha):
    X, y = oran.generate(n_per_class=200, seed=1)
    got = oran.partition_dirichlet(X, y, 9, 24, alpha=alpha, seed=3)
    want = joran.partition_dirichlet(X, y, 9, 24, alpha=alpha, seed=3)
    for k in ("x", "y"):
        np.testing.assert_array_equal(got[k], want[k])
    name = f"noniid:{alpha}" if alpha else "static"
    trace = scenario.make_trace(name, 2, 9)
    jtrace = jscenario.make_trace(name, 2, 9)
    for tr, jtr in ((trace, jtrace), (None, None)):
        got = scenario.partition_for(tr, X, y, 9, 24, seed=4)
        want = jscenario.partition_for(jtr, X, y, 9, 24, seed=4)
        for k in ("x", "y"):
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError):
        oran.partition_dirichlet(X, y, 9, 24, alpha=-1.0)


# ---------------------------------------------------------------------------
# the host plan under a scenario: exactly the reference
# ---------------------------------------------------------------------------

def _plan_pair(name, scen, rounds=8, M_=20, **kw):
    t_round = np.random.default_rng(7).uniform(25e-3, 100e-3, M_)
    args = dict(policy_seed=3, K=6, E=5, n_samples_per_client=32,
                scenario_seed=2, **kw)
    got = campaign.plan_schedule(
        name, SystemParams(M=M_, seed=1, t_round=t_round.copy()), DNN10,
        rounds, scenario=scen, **args)
    want = jcampaign.plan_schedule(
        name, JSystemParams(M=M_, seed=1, t_round=t_round.copy()), JDNN10,
        rounds, scenario=scen, **args)
    return got, want


@pytest.mark.parametrize("scen", PLAN_SCENARIOS)
@pytest.mark.parametrize("name", engine.framework_names())
def test_plan_schedule_under_scenario_matches_reference(name, scen):
    (sp, sched), (jsp, jsched) = _plan_pair(name, scen)
    np.testing.assert_array_equal(sched.a, jsched.a)
    np.testing.assert_array_equal(sched.b, jsched.b)
    np.testing.assert_array_equal(sched.E, jsched.E)
    assert sched.E.dtype == jsched.E.dtype
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(sp, f), getattr(jsp, f))
    assert (sp.omega, sp.d_model_bits) == (jsp.omega, jsp.d_model_bits)
    _same_trace(sched.trace, jsched.trace)
    spec = engine.make_spec(name, DNN10, masked_loss_metric=True)
    jspec = jengine.make_spec(name, JDNN10, masked_loss_metric=True)
    for g, w in zip(campaign._schedule_system_metrics(spec, sched, sp),
                    jcampaign._schedule_system_metrics(jspec, jsched, jsp)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", engine.framework_names())
def test_static_scenario_is_byte_identical_to_none(name):
    (sp, sched), _ = _plan_pair(name, "static")
    (sp0, sched0), _ = _plan_pair(name, None)
    for f in ("a", "b", "E"):
        got, want = getattr(sched, f), getattr(sched0, f)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    for f in FIELDS:
        assert getattr(sp, f).tobytes() == getattr(sp0, f).tobytes()
    assert sched.trace is not None and sched.trace.is_static()
    assert sched0.trace is None


@pytest.mark.parametrize("quant", [None, "int8"])
def test_plan_under_faults_trace_is_blind_to_them(quant):
    """Planning never reads the fault channels (the reference plans blind
    to them): the plan equals the reference's, and the static plan."""
    (_, sched), (_, jsched) = _plan_pair("oranfed", "faults:0.2",
                                         quant=quant)
    (_, sched0), _ = _plan_pair("oranfed", None, quant=quant)
    np.testing.assert_array_equal(sched.a, jsched.a)
    np.testing.assert_array_equal(sched.a, sched0.a)
    assert sched.trace.has_faults()


@pytest.mark.parametrize("scen", ["fading", "straggler:0.4"])
def test_schedule_metrics_with_trace_match_reference(scen):
    """``cost.schedule_metrics(trace=)`` exactly, and each row equals the
    per-round scalars against the round's applied trace."""
    (sp, sched), (jsp, jsched) = _plan_pair("splitme", scen, rounds=10)
    got = cost.schedule_metrics(sched.a, sched.b, sched.E, sp,
                                trace=sched.trace)
    want = jcost.schedule_metrics(jsched.a, jsched.b, jsched.E, jsp,
                                  trace=jsched.trace)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    base = scenario.capture_base(sp)
    for r in range(sched.rounds):
        scenario.apply_round(sp, base, sched.trace, r)
        a, b, e = sched.a[r], sched.b[r], int(sched.E[r])
        np.testing.assert_allclose(got[0][r], cost.total_time(a, b, e, sp),
                                   rtol=1e-12)
        np.testing.assert_allclose(got[2][r],
                                   cost.round_energy(a, b, e, sp),
                                   rtol=1e-12)
    scenario.restore_base(sp, base)


# ---------------------------------------------------------------------------
# campaigns and trainers under a scenario
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_data():
    X, y = oran.generate(n_per_class=300, seed=0)
    (Xtr, ytr), test = oran.train_test_split(X, y)
    cd = oran.partition_non_iid(Xtr, ytr, 12, samples_per_client=32, seed=0)
    return cd, test


def _jax_initial_params(name, seeds):
    jspec = jengine.make_spec(name, JDNN10)
    init = jax.device_get(jax.vmap(jspec.init_fn)(jnp.stack(
        [jax.random.PRNGKey(s + jspec.init_key_offset) for s in seeds])))
    return [tuple([{k: v[i] for k, v in layer.items()} for layer in half]
                  for half in init) for i in range(len(seeds))]


@pytest.mark.parametrize("name,kw", [("splitme", {"e_initial": 6}),
                                     ("fedora", {"E": 3})])
def test_straggler_campaign_matches_jax(small_data, name, kw):
    """3 rounds, 2 seeds under ``straggler:0.4``: the realized schedule and
    metrics exactly, params and losses at 1e-5 (FedORA in both modes, which
    agree bit for bit; SplitMe graphed, its loop being the same code)."""
    cd, test = small_data
    seeds = (0, 1)
    args = dict(rounds=3, seeds=seeds, scenario="straggler:0.4",
                scenario_seed=1, **kw)
    want = jcampaign.run_campaign(name, JDNN10, JSystemParams(M=12, seed=0),
                                  cd, **args)
    n_ph = len(engine.make_spec(name, DNN10).phases)
    runs = [campaign.run_campaign(
        name, DNN10, SystemParams(M=12, seed=0), cd, scan=scan, device="cpu",
        params=_jax_initial_params(name, seeds),
        index_source=CampaignIndexReplay(seeds, 12, 32, 32, n_phases=n_ph),
        **args) for scan in ((True,) if name == "splitme" else (True, False))]
    assert not want.schedule.trace.is_static()
    for got in runs:
        np.testing.assert_array_equal(got.schedule.a, want.schedule.a)
        np.testing.assert_array_equal(got.schedule.E, want.schedule.E)
        _same_trace(got.schedule.trace, want.schedule.trace)
        for mg, mw in zip(got.metrics, want.metrics):
            for f in ("n_selected", "E", "comm_bits", "sim_time", "cost",
                      "energy"):
                assert getattr(mg, f) == getattr(mw, f), f
        np.testing.assert_allclose(got.losses, want.losses, rtol=0,
                                   atol=1e-5)
        for i in range(len(seeds)):
            for g, w in zip(got.params_for(i), want.params_for(i)):
                assert_params_close(g, w, atol=1e-5)
    if len(runs) == 2:
        np.testing.assert_array_equal(runs[0].losses, runs[1].losses)


HIDDEN = (32, 32, 16, 16, 8)
CFG = DNNConfig(hidden=HIDDEN)
JCFG = JDNNConfig(hidden=HIDDEN)
M, N, B, E_MAX = 8, 16, 8, 4


def test_splitme_trainer_under_fading_matches_jax():
    """SplitMeTrainer with a ``fading`` trace: the per-round re-selection
    and the realized masks exactly, params and losses at 1e-5."""
    X, y = oran.generate(n_per_class=100, seed=0)
    train, test = oran.train_test_split(X, y)
    clients = oran.partition_non_iid(*train, M, N, seed=0)
    t_round = np.random.default_rng(5).uniform(20e-3, 100e-3, M)
    jt = JSplitMeTrainer(
        JCFG, JSystemParams(M=M, E_max=E_MAX, t_round=t_round.copy()),
        clients, test, batch_size=B, e_initial=E_MAX,
        kernel_policy="reference", seed=0,
        scenario=jscenario.make_trace("fading", 4, M, seed=2))
    init = (jax.device_get(jt.w_c), jax.device_get(jt.w_s_inv))
    tt = SplitMeTrainer(
        CFG, SystemParams(M=M, E_max=E_MAX, t_round=t_round.copy()),
        clients, test, batch_size=B, e_initial=E_MAX, seed=0, device="cpu",
        params=init, scenario=scenario.make_trace("fading", 4, M, seed=2),
        index_source=TrainerIndexReplay(0, M, E_MAX, B, N))
    for _ in range(4):
        jt.run_round()
        tt.run_round()
    for mj, mt in zip(jt.fetch_history(), tt.fetch_history()):
        for f in ("n_selected", "E", "comm_bits", "sim_time", "cost",
                  "energy"):
            assert getattr(mt, f) == getattr(mj, f), f
        assert abs(mt.client_loss - mj.client_loss) <= 1e-5
        assert abs(mt.server_loss - mj.server_loss) <= 1e-5
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tt.sp, f), getattr(jt.sp, f))
    assert_params_close(tt.w_c, jt.w_c, atol=1e-5)
    assert_params_close(tt.w_s_inv, jt.w_s_inv, atol=1e-5)


def test_fedavg_trainer_under_fading_matches_jax(small_data):
    cd, test = small_data
    jt = jbaselines.FedAvgTrainer(
        JDNN10, JSystemParams(M=12, seed=0), cd, test, E=3, seed=1,
        scenario=jscenario.make_trace("fading:0.8", 5, 12, seed=4))
    tt = baselines.FedAvgTrainer(
        DNN10, SystemParams(M=12, seed=0), cd, test, E=3, seed=1,
        device="cpu", params=(jax.device_get(jt.params),),
        scenario=scenario.make_trace("fading:0.8", 5, 12, seed=4),
        index_source=TrainerIndexReplay(1, 12, 3, 32, 32, n_phases=1))
    for _ in range(3):
        jt.run_round()
        tt.run_round()
    for mj, mt in zip(jt.fetch_history(), tt.fetch_history()):
        for f in ("n_selected", "E", "comm_bits", "sim_time", "cost",
                  "energy"):
            assert getattr(mt, f) == getattr(mj, f), f
        assert abs(mt.client_loss - mj.client_loss) <= 1e-5
    assert_params_close(tt.params, jt.params, atol=1e-5)


def test_fault_traces_raise_later_slice(small_data):
    """A fault trace runs in the trainers (which ignore its channels, as the
    reference's do) and in the scanned campaign; without the scan it is
    refused with the reference's ValueError."""
    cd, test = small_data
    faults = scenario.make_trace("faults:0.2", 3, 12)
    for name in ("fedavg", "splitme"):
        with pytest.raises(ValueError, match="scan=True"):
            campaign.run_campaign(name, DNN10, SystemParams(M=12), cd,
                                  rounds=3, seeds=(0,), device="cpu",
                                  scenario="faults:0.2", scan=False)
    res = campaign.run_campaign("splitme", DNN10, SystemParams(M=12), cd,
                                rounds=3, seeds=(0,), device="cpu",
                                scenario=faults)
    assert res.skipped_per_round is not None     # guards armed
    tr = baselines.EcoFLTrainer(DNN10, SystemParams(M=12), cd, test,
                                device="cpu", scenario=faults, E=2)
    assert np.isfinite(float(tr.run_round().client_loss))
    with pytest.raises(TypeError, match="ScenarioTrace"):
        baselines.EcoFLTrainer(DNN10, SystemParams(M=12), cd, test,
                               device="cpu", scenario="fading")
    # a faults family at level 0 arms nothing, and runs
    quiet = scenario.make_trace("faults:0", 2, 12)
    assert not quiet.has_faults()
    res = campaign.run_campaign("fedavg", DNN10, SystemParams(M=12), cd,
                                rounds=2, seeds=(0,), device="cpu",
                                scenario=quiet, E=2)
    assert np.isfinite(res.losses).all()
