"""The port's five baseline frameworks (FedAvg, SFL, O-RANFed, FedORA,
EcoFL) against the JAX package on the CPU: the host policies and derived
SystemParams, the comm models, one round of the engine, the trainers of
``repro_torch.core.baselines`` and the full-model evaluation (bf16 and the
wire formats: tests/test_torch_baseline_precision.py).

Both packages get the same inputs: seeded numpy data, the JAX package's
own initial parameters (``PRNGKey(seed + 1)``, its ``init_key_offset``)
and its batches and int8 uniforms, replayed from its key chains
(tests/torch_parity.py, one phase).  Bounds: exact for schedules, derived
SystemParams and system metrics; 1e-5 for f32 params and losses (the JAX
package's own bound); 1e-3 for bf16; the wire formats within the bounds of
tests/test_torch_quantcomm.py; accuracy within one test sample.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.splitme_dnn import DNN10 as JDNN10
from repro.configs.splitme_dnn import DNNConfig as JDNNConfig
from repro.core import baselines as jbaselines
from repro.core import engine as jengine
from repro.core.cost import SystemParams as JSystemParams
from repro.kernels.dispatch import BF16 as JBF16
from repro.kernels.dispatch import KernelPolicy as JKernelPolicy
from repro_torch.configs.splitme_dnn import DNN10, DNNConfig
from repro_torch.core import baselines, engine
from repro_torch.core.cost import (SystemParams, round_energy,
                                   uplink_time)
from repro_torch.data import oran
from repro_torch.kernels.dispatch import BF16, KernelPolicy
from torch_parity import (TrainerIndexReplay, TrainerUniformReplay,
                          assert_params_close, jax_to_torch,
                          one_torch_thread, replay_round_indices)

BASELINES = ("fedavg", "sfl", "oranfed", "fedora", "ecofl")
TRAINERS = {"fedavg": ("FedAvgTrainer", {"K": 10}),
            "sfl": ("SFLTrainer", {"K": 20}),
            "oranfed": ("ORANFedTrainer", {}),
            "fedora": ("FedORATrainer", {}),
            "ecofl": ("EcoFLTrainer", {"K": 10})}
HIDDEN = (32, 32, 16, 16, 8)
CFG = DNNConfig(hidden=HIDDEN)
JCFG = JDNNConfig(hidden=HIDDEN)
M, N, B, E_R = 8, 16, 8, 4
DERIVED = ("S_m", "Q_C", "Q_S", "t_round", "G_m", "avail")


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def small_data():
    """The reference's small_data: DNN10, M 12, 32 samples a client."""
    X, y = oran.generate(n_per_class=300, seed=0)
    (Xtr, ytr), test = oran.train_test_split(X, y)
    cd = oran.partition_non_iid(Xtr, ytr, 12, samples_per_client=32, seed=0)
    return cd, test


def test_registry_lists_the_reference_frameworks_in_order():
    assert engine.framework_names() == jengine.framework_names() == (
        "splitme", "fedavg", "sfl", "oranfed", "fedora", "ecofl")


# ---------------------------------------------------------------------------
# host policies and derived SystemParams: exactly the reference
# ---------------------------------------------------------------------------

def _sp_pair(M_=20, seed=3):
    """SystemParams with deadlines tight enough for partial cohorts."""
    t_round = np.random.default_rng(seed).uniform(20e-3, 100e-3, M_)
    return (SystemParams(M=M_, seed=seed, t_round=t_round.copy()),
            JSystemParams(M=M_, seed=seed, t_round=t_round.copy()))


@pytest.mark.parametrize("quant", [None, "bf16", "int8"])
@pytest.mark.parametrize("name", ("splitme",) + BASELINES)
def test_make_policy_matches_reference(name, quant):
    """Each of the six make_policy calls: (a, b, E) over 5 rounds and the
    derived copy's S_m, d_model_bits, omega, Q_C, Q_S exactly equal; the
    caller's SystemParams untouched."""
    sp, jsp = _sp_pair()
    kw = dict(seed=4, K=6, E=5, n_samples_per_client=32, quant=quant)
    tsp, tpol = engine.make_policy(name, sp, DNN10, **kw)
    jtsp, jpol = jengine.make_policy(name, jsp, JDNN10, **kw)
    assert type(tpol).__name__ == type(jpol).__name__
    for f in DERIVED:
        np.testing.assert_array_equal(getattr(tsp, f), getattr(jtsp, f))
        np.testing.assert_array_equal(getattr(sp, f), getattr(jsp, f))
    assert (tsp.omega, tsp.d_model_bits) == (jtsp.omega, jtsp.d_model_bits)
    assert (sp.omega, sp.d_model_bits) == (jsp.omega, jsp.d_model_bits)
    sizes = set()
    for _ in range(5):
        (a, b, E), (ja, jb, jE) = tpol.step(), jpol.step()
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(b, jb)
        assert E == jE
        sizes.add(int(a.sum()))
    assert min(sizes) >= 1


def test_fedora_policy_admits_deadline_feasible_cohort():
    """Every admitted client's realized round time fits its deadline, the
    allocation normalizes, and the rule is deterministic."""
    sp, pol = engine.make_policy("fedora", SystemParams(M=20, seed=0), DNN10,
                                 E=5)
    a, b, E = pol.step()
    assert a.sum() >= 1
    np.testing.assert_allclose(b.sum(), 1.0, atol=1e-9)
    t = E * (sp.Q_C + sp.Q_S) + uplink_time(a, b, sp)
    sel = a > 0
    assert np.all(t[sel] <= sp.t_round[sel] + 1e-9)
    a2, b2, _ = pol.step()
    np.testing.assert_array_equal(a, a2)
    np.testing.assert_allclose(b, b2)


def test_fedora_admits_at_least_as_many_under_quantization():
    _, p32 = engine.make_policy("fedora", SystemParams(M=30, seed=0), DNN10,
                                E=5)
    _, p16 = engine.make_policy("fedora", SystemParams(M=30, seed=0), DNN10,
                                E=5, quant="bf16")
    assert p16.step()[0].sum() >= p32.step()[0].sum()


def test_ecofl_policy_selects_lowest_energy_clients():
    sp, pol = engine.make_policy("ecofl", SystemParams(M=20, seed=0), DNN10,
                                 K=6, E=5)
    a, b, E = pol.step()
    assert int(a.sum()) == 6
    np.testing.assert_allclose(b.sum(), 1.0, atol=1e-9)
    t_up_est = (sp.S_m + sp.omega * sp.d_model_bits) / (sp.B / 6)
    energy = sp.p_tx_w * t_up_est + sp.p_cpu_w * E * (sp.Q_C + sp.Q_S)
    want = np.zeros(sp.M)
    want[np.argsort(energy, kind="stable")[:6]] = 1.0
    np.testing.assert_array_equal(a, want)
    e32 = round_energy(a, b, E, sp)
    sp16, pol16 = engine.make_policy("ecofl", SystemParams(M=20, seed=0),
                                     DNN10, K=6, E=5, quant="bf16")
    a16, b16, E16 = pol16.step()
    assert 0 < round_energy(a16, b16, E16, sp16) < e32


@pytest.mark.parametrize("quant", [None, "bf16", "int8"])
@pytest.mark.parametrize("name", ("splitme",) + BASELINES)
def test_comm_models_match_reference(name, quant):
    """Each framework's comm model on a single round and on a stacked
    schedule, exactly."""
    sp, jsp = _sp_pair(M_=12)
    tsp, _ = engine.make_policy(name, sp, DNN10, n_samples_per_client=32,
                                quant=quant)
    jtsp, _ = jengine.make_policy(name, jsp, JDNN10, n_samples_per_client=32,
                                  quant=quant)
    spec = engine.make_spec(name, DNN10, quant=quant, batch_size=16)
    jspec = jengine.make_spec(name, JDNN10, quant=quant, batch_size=16)
    rng = np.random.default_rng(1)
    a = (rng.random((6, 12)) < 0.5).astype(np.float64)
    E = rng.integers(1, 15, 6).astype(np.int32)
    got = spec.comm_model(a, E, tsp)
    want = jspec.comm_model(a, E, jtsp)
    np.testing.assert_array_equal(got, want)
    for r in range(6):
        g = spec.comm_model(a[r], int(E[r]), tsp)
        assert isinstance(g, float)
        assert g == jspec.comm_model(a[r], int(E[r]), jtsp) == got[r]


# ---------------------------------------------------------------------------
# one round of the engine
# ---------------------------------------------------------------------------

def _round_data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(M, N, 30)).astype(np.float32)
    y = rng.integers(0, 3, (M, N)).astype(np.int32)
    a = np.zeros(M, np.float32)
    a[[0, 2, 3, 6]] = 1.0
    return x, y, a


def _jax_round(name, x, y, a, *, e_steps, key, init, policy="reference",
               quant=None, qstate=()):
    jspec = jengine.make_spec(name, JCFG, policy=policy, batch_size=B,
                              quant=quant)
    jround = jengine.build_round_fn(jspec, JCFG, jnp.asarray(x),
                                    jnp.asarray(y), e_max=E_R, donate=False)
    return jround(init, jnp.asarray(a), jnp.asarray(e_steps), key, qstate)


@pytest.mark.parametrize("name", BASELINES)
@pytest.mark.parametrize("full", [True, False])
def test_round_matches_jax_engine(name, full):
    """The full-M round of each baseline (every client selected, or a
    partial mask with a frozen tail E < e_max) against
    ``repro.core.engine.build_round_fn``: params and loss at 1e-5."""
    x, y, a = _round_data()
    if full:
        a = np.ones(M, np.float32)
    e_steps = E_R if full else 3
    key = jax.random.PRNGKey(11)
    jspec = jengine.make_spec(name, JCFG, batch_size=B)
    init = jspec.init_fn(jax.random.PRNGKey(2))
    (jw,), (jl,), _ = _jax_round(name, x, y, a, e_steps=e_steps, key=key,
                                 init=init)
    spec = engine.make_spec(name, CFG, batch_size=B)
    assert [ph.name for ph in spec.phases] == ["local"]
    fn = engine.build_round_fn(spec, CFG, _t(x), _t(y), e_max=E_R)
    idx = _t(replay_round_indices(key, 1, M, E_R, B, N))
    (w,), (loss,), q = fn((jax_to_torch(init[0]),), _t(a), e_steps, idx)
    assert q == ()
    assert_params_close(w, jw, atol=1e-5)
    assert abs(float(loss) - float(jl)) <= 1e-5


def test_empty_mask_zeroes_the_params_as_the_reference():
    """The reference caveat, mirrored: a round whose realized mask is
    empty divides zero numerators by max(|A_t|, 1) and sets the params to
    zero.  A hand-built trace drops every client of a round that selected
    none (``realized_mask`` keeps it empty in both packages); the full
    round and the gathered round (a padded cohort; the reference's empty
    cohort) give zero params and a zero loss."""
    from repro.core import scenario as jscenario
    from repro_torch.core import scenario
    x, y, _ = _round_data()
    trace = scenario.make_trace("static", 2, M)
    drop = np.ones((2, M))
    drop[1] = 0.0
    trace = scenario.ScenarioTrace(**{**trace.__dict__, "drop": drop})
    jtrace = jscenario.ScenarioTrace(**{**trace.__dict__})
    a = scenario.realized_mask(np.zeros(M), trace, 1)
    np.testing.assert_array_equal(
        a, jscenario.realized_mask(np.zeros(M), jtrace, 1))
    assert a.sum() == 0
    key = jax.random.PRNGKey(5)
    for name in ("fedavg", "splitme"):
        jspec = jengine.make_spec(name, JCFG, batch_size=B,
                                  masked_loss_metric=True)
        init = jspec.init_fn(jax.random.PRNGKey(2))
        jround = jengine.build_round_fn(jspec, JCFG, jnp.asarray(x),
                                        jnp.asarray(y), e_max=E_R,
                                        donate=False)
        jp, jl, _ = jround(init, jnp.asarray(a, jnp.float32),
                           jnp.asarray(E_R), key, ())
        jg = jengine.build_round_fn(jspec, JCFG, jnp.asarray(x),
                                    jnp.asarray(y), e_max=E_R, donate=False,
                                    gather=True)
        jgp, jgl, _ = jg(init, jnp.zeros(0, jnp.int32), jnp.zeros(0),
                         jnp.asarray(E_R), key, ())
        spec = engine.make_spec(name, CFG, batch_size=B,
                                masked_loss_metric=True)
        params = tuple(jax_to_torch(p) for p in init)
        n_ph = len(spec.phases)
        idx = _t(replay_round_indices(key, n_ph, M, E_R, B, N))
        p, losses, _ = engine.build_round_fn(spec, CFG, _t(x), _t(y),
                                             e_max=E_R)(
            params, _t(a).float(), E_R, idx)
        stacked = tuple([{k: v[None] for k, v in l.items()} for l in ps]
                        for ps in params)
        gp, gl, _ = engine.build_round_fn(spec, CFG, _t(x), _t(y), e_max=E_R,
                                          gather=True)(
            stacked, torch.zeros(1, dtype=torch.int64), torch.zeros(1), E_R,
            idx[None])
        for got, want, jwant in zip(p, jp, jgp):
            assert_params_close(got, want, atol=0.0)
            assert_params_close(got, jwant, atol=0.0)
            assert all(float(v.abs().max()) == 0.0 for l in got
                       for v in l.values())
        for got in gp:
            assert all(float(v.abs().max()) == 0.0 for l in got
                       for v in l.values())
        for l, jl_, g, jg_ in zip(losses, jl, gl, jgl):
            assert float(l) == float(jl_) == float(g) == float(jg_) == 0.0


def test_full_model_evaluation_matches_jax(small_data):
    """``build_eval_fn`` of a baseline: the aggregated MLP's accuracy on
    the test split, f32 and forced bf16, within one test sample of the
    reference's (the same params)."""
    _, (xt, yt) = small_data
    jspec = jengine.make_spec("fedora", JDNN10)
    init = jspec.init_fn(jax.random.PRNGKey(9))
    for jpol, pol in ((None, None),
                      (JKernelPolicy(precision=JBF16),
                       KernelPolicy(precision=BF16))):
        want = float(jengine.build_eval_fn(
            jengine.make_spec("fedora", JDNN10, policy=jpol), JDNN10, xt,
            yt)(init))
        spec = engine.make_spec("fedora", DNN10, policy=pol)
        got = float(engine.build_eval_fn(spec, DNN10, _t(xt), _t(yt))(
            (jax_to_torch(init[0]),)))
        assert abs(got - want) <= 1.0 / len(yt) + 1e-6
    with pytest.raises(ValueError, match="client_data"):
        engine.build_eval_fn(engine.make_spec("splitme", DNN10), DNN10,
                             _t(xt), _t(yt))


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------

TRAINER_E = 3


def _trainer_pair(name, small_data, seed=0, **kw):
    """The reference trainer and the port's, from the same initial params
    and batches (and int8 uniforms), E = TRAINER_E."""
    cd, test = small_data
    cls, defaults = TRAINERS[name]
    args = dict(defaults, E=TRAINER_E, seed=seed)
    jt = getattr(jbaselines, cls)(JDNN10, JSystemParams(M=12, seed=0), cd,
                                  test, **args, **kw)
    init = jax.device_get(jt.params)
    more = {}
    if kw.get("comm_quant") == "int8":
        more["uniform_source"] = TrainerUniformReplay(seed, {0: init})
    tt = getattr(baselines, cls)(
        DNN10, SystemParams(M=12, seed=0), cd, test, **args, **kw,
        device="cpu", params=(init,),
        index_source=TrainerIndexReplay(seed, 12, TRAINER_E, 32, 32,
                                        n_phases=1), **more)
    return jt, tt


@pytest.fixture(scope="module", params=BASELINES)
def trainers(request, small_data):
    name = request.param
    jt, tt = _trainer_pair(name, small_data)
    for r in range(3):
        jt.run_round(eval_acc=r == 2)
        tt.run_round(eval_acc=r == 2)
    return name, jt, tt


def test_trainer_matches_jax_trainer(trainers):
    """3 rounds of each trainer: params and losses at 1e-5, n_selected, E,
    comm_bits, sim_time, cost and energy exactly, accuracy within one test
    sample (the last round's evaluation and ``evaluate``)."""
    name, jt, tt = trainers
    jh, th = jt.fetch_history(), tt.fetch_history()
    assert len(jh) == len(th) == 3
    for mj, mt in zip(jh, th):
        for f in ("round", "n_selected", "E", "comm_bits", "sim_time",
                  "cost", "energy"):
            assert getattr(mt, f) == getattr(mj, f), (name, f)
        assert abs(mt.client_loss - mj.client_loss) <= 1e-5
        assert np.isnan(mt.server_loss) and np.isnan(mj.server_loss)
    assert_params_close(tt.params, jt.params, atol=1e-5)
    n_test = len(tt.y_test)
    assert abs(th[-1].accuracy - jh[-1].accuracy) <= 1.0 / n_test + 1e-6
    assert abs(tt.evaluate() - jt.evaluate()) <= 1.0 / n_test + 1e-6
    assert np.isnan(th[0].accuracy)
    assert (tt.E, getattr(tt, "K", None)) == (TRAINER_E,
                                              TRAINERS[name][1].get("K"))


def test_trainer_defaults_and_interactive(small_data):
    """The reference's K / E defaults; ``interactive`` pulls floats."""
    cd, test = small_data
    for name, (cls, _) in TRAINERS.items():
        jsig, tsig = (inspect.signature(getattr(mod, cls).__init__)
                      .parameters for mod in (jbaselines, baselines))
        for p in ("K", "E", "lr", "batch_size", "seed"):
            assert (p in jsig) == (p in tsig), (name, p)
            if p in jsig:
                assert tsig[p].default == jsig[p].default, (name, p)
    t = baselines.FedAvgTrainer(DNN10, SystemParams(M=12, seed=0), cd, test,
                                E=2, device="cpu", interactive=True)
    m = t.run_round(eval_acc=True)
    assert isinstance(m.client_loss, float) and isinstance(m.accuracy, float)
    t = baselines.FedAvgTrainer(DNN10, SystemParams(M=12, seed=0), cd, test,
                                E=2, device="cpu")
    m = t.run_round()
    assert isinstance(m.client_loss, torch.Tensor)
    assert isinstance(t.fetch_history()[0].client_loss, float)
