"""The port's SplitMe slice against the JAX package on the CPU.

Same inputs, made from seeds with numpy, go through the JAX functions and
their counterparts in ``repro_torch``; batch indices replay the JAX key
chain (tests/torch_parity.py).  Bounds: exact for the host-side numpy copies
and the (a, b, E) schedule, 1e-6 for single forwards, 1e-5 for trained
parameters and losses (the JAX package's own f32 parity bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.splitme_dnn import DNNConfig as JDNNConfig
from repro.core import dnn as jdnn
from repro.core import engine as jengine
from repro.core import inversion as jinversion
from repro.core.cost import SystemParams as JSystemParams
from repro.core.splitme import SplitMeTrainer as JSplitMeTrainer
from repro.data import oran as joran
from repro_torch.configs.splitme_dnn import DNN10, DNNConfig
from repro_torch.core import dnn, engine, inversion
from repro_torch.core.cost import SystemParams
from repro_torch.core.splitme import SplitMeTrainer
from repro_torch.data import oran
from torch_parity import (TrainerIndexReplay, assert_params_close,
                          jax_to_torch, one_torch_thread,
                          replay_round_indices)

HIDDEN = (32, 32, 16, 16, 8)
CFG = DNNConfig(hidden=HIDDEN)
JCFG = JDNNConfig(hidden=HIDDEN)
M, N, B, E_MAX = 8, 16, 8, 4


def _t(a):
    return torch.tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# host-side numpy copies: exactly the reference
# ---------------------------------------------------------------------------

def test_config_copy_matches_reference():
    from repro.configs.splitme_dnn import DNN10 as JDNN10
    assert DNN10.layer_dims == JDNN10.layer_dims
    assert DNN10.n_layers == JDNN10.n_layers == 10
    assert DNN10.split_index == JDNN10.split_index
    assert dnn.client_dims(CFG) == jdnn.client_dims(JCFG)
    assert dnn.inverse_server_dims(CFG) == jdnn.inverse_server_dims(JCFG)


@pytest.mark.parametrize("seed", [0, 7])
def test_oran_copy_matches_reference(seed):
    X, y = oran.generate(n_per_class=300, seed=seed)
    jX, jy = joran.generate(n_per_class=300, seed=seed)
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(y, jy)
    tr, te = oran.train_test_split(X, y, seed=seed)
    jtr, jte = joran.train_test_split(jX, jy, seed=seed)
    for a, b in zip(tr + te, jtr + jte):
        np.testing.assert_array_equal(a, b)
    part = oran.partition_non_iid(*tr, 10, 12, seed=seed)
    jpart = joran.partition_non_iid(*jtr, 10, 12, seed=seed)
    for k in ("x", "y"):
        np.testing.assert_array_equal(part[k], jpart[k])
    by_class = [np.where(tr[1] == c)[0] for c in range(3)]
    for alpha in (None, 0.5):
        got = oran.draw_client_shard(np.random.default_rng(seed), by_class,
                                     20, alpha, 1)
        want = joran.draw_client_shard(np.random.default_rng(seed),
                                       by_class, 20, alpha, 1)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 3])
def test_system_params_copy_matches_reference(seed):
    sp, jsp = SystemParams(seed=seed), JSystemParams(seed=seed)
    for name in ("Q_C", "Q_S", "t_round", "S_m", "G_m", "avail"):
        np.testing.assert_array_equal(getattr(sp, name), getattr(jsp, name))
    c = sp.copy()
    c.S_m[0] = -1.0
    assert sp.S_m[0] == jsp.S_m[0]


@pytest.mark.parametrize("M_,t_lo", [(50, 50e-3), (12, 20e-3)])
def test_splitme_schedule_matches_reference_exactly(M_, t_lo):
    """Alg. 1 + P2 over 12 rounds: identical (a, b, E), derived sp and
    selection state.  t_lo < the deadline estimate admits a partial,
    changing cohort."""
    rng = np.random.default_rng(M_)
    t_round = rng.uniform(t_lo, 100e-3, M_)
    sp = SystemParams(M=M_, seed=1, t_round=t_round.copy())
    jsp = JSystemParams(M=M_, seed=1, t_round=t_round.copy())
    tsp, tpol = engine.make_policy("splitme", sp, DNN10,
                                   n_samples_per_client=96)
    from repro.configs.splitme_dnn import DNN10 as JDNN10
    jtsp, jpol = jengine.make_policy("splitme", jsp, JDNN10,
                                     n_samples_per_client=96)
    np.testing.assert_array_equal(sp.S_m, jsp.S_m)     # caller untouched
    assert tsp.omega == jtsp.omega
    assert tsp.d_model_bits == jtsp.d_model_bits
    sizes = set()
    for _ in range(12):
        a, b, E = tpol.step()
        ja, jb, jE = jpol.step()
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(b, jb)
        assert E == jE
        assert tpol.state.t_max_k == jpol.state.t_max_k
        sizes.add(int(a.sum()))
    if t_lo < 50e-3:
        assert min(sizes) < M_


def test_later_frameworks_and_options_raise():
    """What used to be a later slice runs now: a trace with fault channels
    in a trainer of either kind (its channels ignored), fault injection
    and guards in the round builders; unknown names and a non-guard still
    raise."""
    from repro_torch.core import scenario
    from repro_torch.core.baselines import FedAvgTrainer
    rng = np.random.default_rng(0)
    clients = {"x": rng.normal(size=(M, N, 30)).astype(np.float32),
               "y": rng.integers(0, 3, (M, N)).astype(np.int32)}
    test = (clients["x"][0], clients["y"][0])
    faults = scenario.make_trace("faults:0.2", 4, M)
    assert faults.has_faults()
    tr = SplitMeTrainer(CFG, SystemParams(M=M, E_max=2), clients, test,
                        batch_size=B, e_initial=2, device="cpu",
                        scenario=faults)
    assert np.isfinite(float(tr.run_round().client_loss))
    tr = FedAvgTrainer(CFG, SystemParams(M=M), clients, test, K=4, E=2,
                       batch_size=B, device="cpu", scenario=faults)
    assert np.isfinite(float(tr.run_round().client_loss))
    with pytest.raises(KeyError):
        engine.make_spec("nope", CFG)
    with pytest.raises(KeyError):
        engine.make_policy("nope", SystemParams(M=4), CFG)
    x, y = torch.zeros(M, N, 30), torch.zeros(M, N, dtype=torch.long)
    for name in ("splitme", "fedavg"):
        spec = engine.make_spec(name, CFG)
        assert callable(engine.build_round_fn(spec, CFG, x, y, e_max=2,
                                              gather=True, with_faults=True))
        assert callable(engine.build_round_fn(
            spec, CFG, x, y, e_max=2, guards=engine.RoundGuards()))
        with pytest.raises(TypeError, match="RoundGuards"):
            engine.build_round_fn(spec, CFG, x, y, e_max=2, guards=object())
    spec = engine.make_spec("splitme", CFG)
    with pytest.raises(ValueError, match="policy"):
        engine.build_round_fn(spec, CFG, x, y, e_max=2, policy="reference")


# ---------------------------------------------------------------------------
# forwards on converted parameters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jparams():
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    return (jdnn.init_client(k1, JCFG), jdnn.init_server(k2, JCFG),
            jdnn.init_inverse_server(k3, JCFG))


def test_dnn_forwards_match_reference(jparams):
    jc, js, ji = jparams
    c, s, i = (jax_to_torch(p) for p in jparams)
    x = np.random.default_rng(0).normal(size=(24, 30)).astype(np.float32)
    y1 = np.eye(3, dtype=np.float32)[np.random.default_rng(1)
                                      .integers(0, 3, 24)]
    h = jdnn.client_forward(jc, jnp.asarray(x), JCFG)
    pairs = [
        (dnn.client_forward(c, _t(x), CFG), h),
        (dnn.server_forward(s, _t(np.asarray(h)), CFG),
         jdnn.server_forward(js, h, JCFG)),
        (dnn.inverse_server_forward(i, _t(y1), CFG),
         jdnn.inverse_server_forward(ji, jnp.asarray(y1), JCFG)),
        (dnn.full_forward(c, s, _t(x), CFG),
         jdnn.full_forward(jc, js, jnp.asarray(x), JCFG)),
    ]
    pairs += list(zip(dnn.mlp_activations(i, _t(y1)),
                      jdnn.mlp_activations(ji, jnp.asarray(y1))))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


def test_stacked_forward_is_per_client_forward(jparams):
    """(M, d_in, d_out) weights over (M, B, d_in) batches == the forward of
    each client's own weights (the port's stand-in for vmap)."""
    c = jax_to_torch(jparams[0])
    g = torch.Generator().manual_seed(0)
    stacked = [{k: v.expand(3, *v.shape) + 0.01 * torch.randn(
        3, *v.shape, generator=g) for k, v in p.items()} for p in c]
    x = torch.randn(3, 5, 30, generator=g)
    out = dnn.client_forward(stacked, x, CFG)
    for m in range(3):
        own = [{k: v[m] for k, v in p.items()} for p in stacked]
        torch.testing.assert_close(out[m], dnn.client_forward(own, x[m], CFG),
                                   rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# one round vs engine.build_round_fn
# ---------------------------------------------------------------------------

def _round_data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(M, N, 30)).astype(np.float32)
    y = rng.integers(0, 3, (M, N)).astype(np.int32)
    a = np.array([1, 0, 1, 1, 0, 1, 1, 0], np.float32)
    return x, y, a


@pytest.mark.parametrize("policy", ["reference", "kernel"])
@pytest.mark.parametrize("e_steps", [3, E_MAX])
def test_one_round_matches_jax_engine(policy, e_steps):
    """Partial a_mask, e_steps ≤ e_max (frozen tail in the loss metric):
    both halves of the parameters and both phase losses at 1e-5."""
    x, y, a = _round_data()
    jspec = jengine.make_spec("splitme", JCFG, policy="reference",
                              batch_size=B)
    jround = jengine.build_round_fn(jspec, JCFG, jnp.asarray(x),
                                    jnp.asarray(y), e_max=E_MAX, donate=False)
    key = jax.random.PRNGKey(3)
    init = jspec.init_fn(jax.random.PRNGKey(1))
    (jc, js), (jcl, jsl), _ = jround(init, jnp.asarray(a),
                                     jnp.asarray(e_steps), key, ())

    spec = engine.make_spec("splitme", CFG, policy=policy, batch_size=B)
    round_fn = engine.build_round_fn(spec, CFG, _t(x), _t(y), e_max=E_MAX)
    idx = _t(replay_round_indices(key, 2, M, E_MAX, B, N))
    params = (jax_to_torch(init[0]), jax_to_torch(init[1]))
    (c, s), (cl, sl), _ = round_fn(params, _t(a), e_steps, idx)
    assert_params_close(c, jc, atol=1e-5)
    assert_params_close(s, js, atol=1e-5)
    np.testing.assert_allclose(cl.item(), float(jcl), rtol=0, atol=1e-5)
    np.testing.assert_allclose(sl.item(), float(jsl), rtol=0, atol=1e-5)


def test_round_rejects_bad_indices():
    x, y, a = _round_data()
    spec = engine.make_spec("splitme", CFG, batch_size=B)
    round_fn = engine.build_round_fn(spec, CFG, _t(x), _t(y), e_max=E_MAX)
    params = spec.init_fn(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="indices"):
        round_fn(params, _t(a), 2, torch.zeros(2, M, E_MAX, B + 1,
                                               dtype=torch.int64))
    with pytest.raises(ValueError, match="indices"):
        round_fn(params, _t(a), 2, torch.zeros(2, M, E_MAX, B,
                                               dtype=torch.int32))


def test_unselected_round_leaves_nothing_nan():
    """|A_t| = 0 clamps the FedAvg denominator to 1: zeros, not NaN."""
    x, y, _ = _round_data()
    spec = engine.make_spec("splitme", CFG, batch_size=B)
    round_fn = engine.build_round_fn(spec, CFG, _t(x), _t(y), e_max=2)
    params = spec.init_fn(torch.Generator().manual_seed(0), "cpu")
    idx = torch.zeros(2, M, 2, B, dtype=torch.int64)
    (c, s), losses, _ = round_fn(params, torch.zeros(M), 2, idx)
    assert all(float(v.abs().max()) == 0.0 for p in c + s
               for v in p.values())
    assert all(float(l) == 0.0 for l in losses)


# ---------------------------------------------------------------------------
# trainer vs repro.core.splitme.SplitMeTrainer
# ---------------------------------------------------------------------------

def _trainer_setup():
    X, y = oran.generate(n_per_class=100, seed=0)
    train, test = oran.train_test_split(X, y)
    clients = oran.partition_non_iid(*train, M, N, seed=0)
    # a spread of deadlines below the first estimate: partial cohorts
    t_round = np.random.default_rng(5).uniform(20e-3, 100e-3, M)
    return clients, test, t_round


@pytest.fixture(scope="module")
def trained_pair():
    clients, test, t_round = _trainer_setup()
    jt = JSplitMeTrainer(JCFG, JSystemParams(M=M, E_max=E_MAX,
                                             t_round=t_round.copy()),
                         clients, test, batch_size=B, e_initial=E_MAX,
                         kernel_policy="reference", seed=0)
    init = (jax.device_get(jt.w_c), jax.device_get(jt.w_s_inv))
    tt = SplitMeTrainer(CFG, SystemParams(M=M, E_max=E_MAX,
                                          t_round=t_round.copy()),
                        clients, test, batch_size=B, e_initial=E_MAX, seed=0,
                        device="cpu", params=init,
                        index_source=TrainerIndexReplay(0, M, E_MAX, B, N))
    hist = []
    for r in range(3):
        hist.append((jt.run_round(eval_acc=r == 2),
                     tt.run_round(eval_acc=r == 2)))
    jt.fetch_history()
    tt.fetch_history()
    return jt, tt, hist


def test_trainer_schedule_matches_exactly(trained_pair):
    _, _, hist = trained_pair
    for mj, mt in hist:
        assert (mt.round, mt.n_selected, mt.E) == (mj.round, mj.n_selected,
                                                   mj.E)
        assert mt.comm_bits == mj.comm_bits
        assert mt.sim_time == mj.sim_time
        assert mt.cost == mj.cost
        assert mt.energy == mj.energy
    assert min(mj.n_selected for mj, _ in hist) < M


def test_trainer_params_and_losses_match(trained_pair):
    jt, tt, hist = trained_pair
    assert_params_close(tt.w_c, jt.w_c, atol=1e-5)
    assert_params_close(tt.w_s_inv, jt.w_s_inv, atol=1e-5)
    for mj, mt in hist:
        assert isinstance(mt.client_loss, float)
        np.testing.assert_allclose(mt.client_loss, mj.client_loss, atol=1e-5)
        np.testing.assert_allclose(mt.server_loss, mj.server_loss, atol=1e-5)


def test_inversion_grams_match_reference_on_the_same_inputs(trained_pair):
    """Walk the server layers on the JAX inversion's own path and hold the
    port's Grams (and targets) to the reference's at rtol 1e-5.  The solved
    weights themselves are NOT compared at γ = 1e-3: that solve is
    ill-conditioned in the reference (a 1e-6 change in a Gram moves the
    layer-1 weights by up to 2.5e-2), a property of the reference, not a
    looser check of the port."""
    jt, tt, _ = trained_pair
    smashed = jax.vmap(lambda x: jdnn.client_forward(jt.w_c, x, JCFG))(jt.x)
    o = smashed.reshape(-1, smashed.shape[-1])
    y1 = jax.nn.one_hot(jt.y, 3).reshape(-1, 3)
    w_s = jinversion.invert_inverse_model(jt.w_s_inv, o, y1, JCFG,
                                          policy="reference")
    acts = jdnn.mlp_activations(jt.w_s_inv, y1)
    tacts = dnn.mlp_activations(tt.w_s_inv, _t(y1))
    L = len(acts)
    targets = [acts[L - 1 - l] for l in range(1, L)] + [y1]
    for l, z in enumerate(targets):
        o_aug = jinversion._augment(o)
        ja0, ja1 = jinversion._gram(o_aug, z, "reference")
        a0, a1 = inversion._gram(inversion._augment(_t(o)), _t(z), "kernel")
        for got, want in ((a0, ja0), (a1, ja1)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
        if l < L - 1:
            np.testing.assert_allclose(tacts[L - 2 - l].numpy(),
                                       np.asarray(z), rtol=0, atol=1e-5)
        o = o @ w_s[l]["w"] + w_s[l]["b"]
        if l < L - 1:
            o = jax.nn.relu(o)


def test_inversion_weights_match_when_well_conditioned(trained_pair):
    """With a larger ridge the solve is well conditioned, so the solved
    weights themselves agree at 1e-5.  γ = 10, not 1: at γ = 1 this small
    model's (A0 + γI) has condition numbers up to ~900, and two f32 LU
    solves (LAPACK's and XLA's) of the SAME Grams already differ by ~2e-5
    there (about cond · 2^-24 · |w|); at γ = 10 the condition numbers stay
    at or below ~210."""
    jt, tt, _ = trained_pair
    smashed = jax.vmap(lambda x: jdnn.client_forward(jt.w_c, x, JCFG))(jt.x)
    y1 = jax.nn.one_hot(jt.y, 3).reshape(-1, 3)
    want = jinversion.invert_inverse_model(
        jt.w_s_inv, smashed.reshape(-1, smashed.shape[-1]), y1, JCFG,
        gamma=10.0, policy="reference")
    ts = dnn.client_forward(tt.w_c, tt.x, CFG)
    got = inversion.invert_inverse_model(
        tt.w_s_inv, ts.reshape(-1, ts.shape[-1]),
        torch.nn.functional.one_hot(tt.y, 3).float().reshape(-1, 3), CFG,
        gamma=10.0)
    assert_params_close(got, want, atol=1e-5)


def test_accuracy_at_production_gamma_matches(trained_pair):
    jt, tt, hist = trained_pair
    mj, mt = hist[-1]
    assert abs(mt.accuracy - mj.accuracy) <= 0.02
    assert abs(tt.evaluate(tt.finalize()) - jt.evaluate(jt.finalize())) \
        <= 0.02
    assert abs(tt.evaluate() - jt.evaluate()) <= 0.02


def test_finalize_matches_reference_when_well_conditioned(trained_pair):
    """The trainer's own Step 4 (smashed data of every client, one-hot
    labels, its kernel policy) against the JAX trainer's, at γ = 10 where
    the f32 solve is well conditioned (see the test above), and the
    stitched forward of the recovered server on the test split."""
    jt, tt, _ = trained_pair
    gammas = (jt.gamma, tt.gamma)
    try:
        jt.gamma = tt.gamma = 10.0
        want, got = jt.finalize(), tt.finalize()
    finally:
        jt.gamma, tt.gamma = gammas
    assert_params_close(got, want, atol=1e-5)
    # the same count of correct test predictions (the two f32 means of it
    # may round apart in the last bit)
    n_test = len(tt.y_test)
    assert round(tt.evaluate(got) * n_test) == round(jt.evaluate(want)
                                                     * n_test)


def test_fetch_history_resolves_device_metrics_once():
    clients, test, t_round = _trainer_setup()
    tt = SplitMeTrainer(CFG, SystemParams(M=M, E_max=2), clients, test,
                        batch_size=B, e_initial=2, seed=1, device="cpu")
    want = []
    for r in range(2):
        m = tt.run_round(eval_acc=r == 1)
        assert isinstance(m.client_loss, torch.Tensor)
        assert isinstance(m.server_loss, torch.Tensor)
        assert isinstance(m.accuracy, torch.Tensor) == (r == 1)
        want.append((float(m.client_loss), float(m.server_loss),
                     float(m.accuracy)))
    hist = tt.fetch_history()
    for m, (cl, sl, acc) in zip(hist, want):
        assert isinstance(m.client_loss, float)
        assert (m.client_loss, m.server_loss) == (cl, sl)
        assert np.isnan(m.accuracy) == np.isnan(acc)
    assert hist[-1].accuracy == want[-1][2]


def test_default_trainer_is_seeded_and_device_independent_inputs():
    """The trainer's own CPU generator: one seed, one run."""
    clients, test, _ = _trainer_setup()
    runs = []
    for _ in range(2):
        t = SplitMeTrainer(CFG, SystemParams(M=M, E_max=2), clients, test,
                           batch_size=B, e_initial=2, seed=4, device="cpu")
        for _ in range(2):
            t.run_round()
        runs.append([m.client_loss for m in t.fetch_history()])
    assert runs[0] == runs[1]
    assert all(np.isfinite(runs[0]))
