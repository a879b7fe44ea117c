"""The SplitMe DNN's activations other than ReLU (``DNNConfig(activation=
"gelu" | "squared_relu")``) through the port against the JAX package on the
CPU: one engine round, the trainer with its Step-4 inversion, and a 3-round
scanned campaign.

The same inputs go through both packages (numpy seeds; batch indices
replay the JAX key chain, tests/torch_parity.py).  Bounds, as in
tests/test_torch_splitme.py and tests/test_torch_campaign.py: 1e-6 for a
forward, 1e-5 for trained parameters and losses (the JAX package's f32
parity bound), Step 4 compared at γ = 10, where the f32 ridge solve is
well conditioned (at the production γ = 1e-3 two correct solves of the same
Grams part far), and one test sample for the accuracy.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.splitme_dnn import DNN10 as JDNN10
from repro.configs.splitme_dnn import DNNConfig as JDNNConfig
from repro.core import dnn as jdnn
from repro.core import engine as jengine
from repro.core.cost import SystemParams as JSystemParams
from repro.core.splitme import SplitMeTrainer as JSplitMeTrainer
from repro.launch import campaign as jcampaign
from repro_torch.configs.splitme_dnn import DNN10, DNNConfig
from repro_torch.core import dnn, engine
from repro_torch.core.cost import SystemParams
from repro_torch.core.splitme import SplitMeTrainer
from repro_torch.data import oran
from repro_torch.launch import campaign
from torch_parity import (CampaignIndexReplay, TrainerIndexReplay,
                          assert_params_close, jax_to_torch,
                          one_torch_thread, replay_round_indices)

ACTS = ("gelu", "squared_relu")
HIDDEN = (32, 32, 16, 16, 8)
M, N, B, E_MAX = 8, 16, 8, 4
# squared ReLU raises the scale of its input to the power 2^depth: at the
# default rates (lr_c 0.05, lr_s 0.02) the small model's client loss goes
# 1.5e2 -> 3.3e8 -> NaN in three steps in both packages, where f32
# comparisons mean nothing; the round and the trainer compare it at rates
# that keep it finite, and test_squared_relu_diverges_in_both_packages
# holds the default rates to the same verdict
LRS = {"gelu": {}, "squared_relu": {"lr_c": 1e-3, "lr_s": 5e-4}}
PARITY_TOL = 1e-5        # trained params and losses (the JAX f32 bound)
FORWARD_TOL = 1e-6
STEP4_GAMMA = 10.0


def _t(a):
    return torch.tensor(np.asarray(a))


def _cfgs(act):
    return (DNNConfig(hidden=HIDDEN, activation=act),
            JDNNConfig(hidden=HIDDEN, activation=act))


def test_activation_fn_is_the_reference_one():
    z = np.linspace(-6, 6, 97, dtype=np.float32)
    for act in ("relu",) + ACTS:
        np.testing.assert_allclose(
            dnn.activation_fn(act)(_t(z)).numpy(),
            np.asarray(jdnn.activation_fn(act)(jnp.asarray(z))),
            rtol=FORWARD_TOL, atol=FORWARD_TOL)
    with pytest.raises(ValueError, match="swiglu is handled by the gated"):
        dnn.activation_fn("swiglu")
    with pytest.raises(ValueError):
        dnn.activation_fn("tanh")
    with pytest.raises(ValueError):
        dnn.mlp_forward([], torch.zeros(2, 3), "nope")


@pytest.mark.parametrize("act", ACTS)
def test_forwards_match_jax(act):
    cfg, jcfg = _cfgs(act)
    key = jax.random.PRNGKey(4)
    c = jdnn.init_client(key, jcfg)
    s_inv = jdnn.init_inverse_server(key, jcfg)
    x = np.random.default_rng(1).normal(size=(16, 30)).astype(np.float32)
    y1 = np.eye(3, dtype=np.float32)[np.arange(16) % 3]
    np.testing.assert_allclose(
        dnn.client_forward(jax_to_torch(c), _t(x), cfg).numpy(),
        np.asarray(jdnn.client_forward(c, jnp.asarray(x), jcfg)),
        rtol=FORWARD_TOL, atol=FORWARD_TOL)
    got = dnn.mlp_activations(jax_to_torch(s_inv), _t(y1), act)
    want = jdnn.mlp_activations(s_inv, jnp.asarray(y1), act)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=FORWARD_TOL, atol=FORWARD_TOL)


def _rounds(act, policy, lrs, e_steps=3):
    """One SplitMe round of each package from the same weights and
    batches (partial cohort, E below E_max): (JAX params, JAX losses, port
    params, port losses)."""
    cfg, jcfg = _cfgs(act)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(M, N, 30)).astype(np.float32)
    y = rng.integers(0, 3, (M, N)).astype(np.int32)
    a = np.array([1, 0, 1, 1, 0, 1, 1, 0], np.float32)
    jspec = jengine.make_spec("splitme", jcfg, policy="reference",
                              batch_size=B, **lrs)
    jround = jengine.build_round_fn(jspec, jcfg, jnp.asarray(x),
                                    jnp.asarray(y), e_max=E_MAX, donate=False)
    key = jax.random.PRNGKey(3)
    init = jspec.init_fn(jax.random.PRNGKey(1))
    jp, jl, _ = jround(init, jnp.asarray(a), jnp.asarray(e_steps), key, ())
    spec = engine.make_spec("splitme", cfg, policy=policy, batch_size=B,
                            **lrs)
    round_fn = engine.build_round_fn(spec, cfg, _t(x), _t(y), e_max=E_MAX)
    idx = _t(replay_round_indices(key, 2, M, E_MAX, B, N))
    params = (jax_to_torch(init[0]), jax_to_torch(init[1]))
    tp, tl, _ = round_fn(params, _t(a), e_steps, idx)
    return jp, jl, tp, tl


@pytest.mark.parametrize("policy", ["reference", "kernel"])
@pytest.mark.parametrize("act", ACTS)
def test_one_round_matches_jax_engine(act, policy):
    """Both halves of the parameters and both phase losses."""
    (jc, js), (jcl, jsl), (c, s), (cl, sl) = _rounds(act, policy, LRS[act])
    assert np.isfinite(float(jcl)) and np.isfinite(float(jsl))
    assert_params_close(c, jc, atol=PARITY_TOL)
    assert_params_close(s, js, atol=PARITY_TOL)
    np.testing.assert_allclose(cl.item(), float(jcl), rtol=0, atol=PARITY_TOL)
    np.testing.assert_allclose(sl.item(), float(jsl), rtol=0, atol=PARITY_TOL)


@pytest.mark.parametrize("policy", ["reference", "kernel"])
def test_squared_relu_diverges_in_both_packages(policy):
    """At the default rates both packages' round ends non-finite."""
    _, jl, _, tl = _rounds("squared_relu", policy, {}, e_steps=E_MAX)
    assert not np.isfinite([float(v) for v in jl]).all()
    assert not np.isfinite([float(v) for v in tl]).all()


@pytest.fixture(scope="module", params=ACTS)
def trained(request):
    """Three trainer rounds of both packages from the JAX weights, then
    Step 4 of each at γ = 10."""
    cfg, jcfg = _cfgs(request.param)
    X, y = oran.generate(n_per_class=100, seed=0)
    train, test = oran.train_test_split(X, y)
    clients = oran.partition_non_iid(*train, M, N, seed=0)
    t_round = np.random.default_rng(5).uniform(20e-3, 100e-3, M)
    jt = JSplitMeTrainer(jcfg, JSystemParams(M=M, E_max=E_MAX,
                                             t_round=t_round.copy()),
                         clients, test, batch_size=B, e_initial=E_MAX,
                         kernel_policy="reference", seed=0,
                         **LRS[request.param])
    init = (jax.device_get(jt.w_c), jax.device_get(jt.w_s_inv))
    tt = SplitMeTrainer(cfg, SystemParams(M=M, E_max=E_MAX,
                                          t_round=t_round.copy()),
                        clients, test, batch_size=B, e_initial=E_MAX, seed=0,
                        device="cpu", params=init,
                        index_source=TrainerIndexReplay(0, M, E_MAX, B, N),
                        **LRS[request.param])
    hist = [(jt.run_round(), tt.run_round()) for _ in range(3)]
    jt.fetch_history()
    tt.fetch_history()
    jt.gamma = tt.gamma = STEP4_GAMMA
    return jt, tt, hist, jt.finalize(), tt.finalize()


def test_trainer_rounds_match_jax(trained):
    jt, tt, hist, _, _ = trained
    assert all(np.isfinite(mj.client_loss) for mj, _ in hist)
    assert_params_close(tt.w_c, jt.w_c, atol=PARITY_TOL)
    assert_params_close(tt.w_s_inv, jt.w_s_inv, atol=PARITY_TOL)
    for mj, mt in hist:
        assert (mt.n_selected, mt.E) == (mj.n_selected, mj.E)
        np.testing.assert_allclose(mt.client_loss, mj.client_loss,
                                   atol=PARITY_TOL)
        np.testing.assert_allclose(mt.server_loss, mj.server_loss,
                                   atol=PARITY_TOL)


def test_step4_matches_jax_when_well_conditioned(trained):
    """The Step-4 inversion (Gram kernel policy, the activation between the
    recovered layers) at γ = 10, and the stitched model's test count."""
    jt, tt, _, want, got = trained
    assert_params_close(got, want, atol=PARITY_TOL)
    n_test = len(tt.y_test)
    assert round(tt.evaluate(got) * n_test) == round(jt.evaluate(want)
                                                     * n_test)


@pytest.fixture(scope="module")
def campaign_data():
    X, y = oran.generate(n_per_class=300, seed=0)
    (Xtr, ytr), test = oran.train_test_split(X, y)
    cd = oran.partition_non_iid(Xtr, ytr, 12, samples_per_client=32, seed=0)
    return cd, test


@pytest.mark.parametrize("act", ACTS)
def test_scanned_campaign_matches_jax(campaign_data, act):
    """DNN10 with the activation: 3 scanned rounds of 2 seeds from the JAX
    campaign's own initial weights and batches, evaluated every 2 rounds
    at γ = 10.  Under squared ReLU DNN10 diverges in the JAX package at
    any rate (its losses are NaN from round 0's server phase on, its
    weights reach O(1e27), next to f32 overflow, where one ulp decides
    whether a square overflows): there the port must give NaN losses where
    the JAX package does and its finite losses, O(10), at 1e-5 relative;
    the weights are compared for gelu."""
    cd, test = campaign_data
    seeds = (0, 1)
    kw = dict(rounds=3, eval_gamma=STEP4_GAMMA, eval_every=2, **LRS[act])
    jspec = jengine.make_spec("splitme", dataclasses.replace(
        JDNN10, activation=act))
    init = jax.device_get(jax.vmap(jspec.init_fn)(
        jnp.stack([jax.random.PRNGKey(s) for s in seeds])))
    init = [tuple([{k: v[i] for k, v in layer.items()} for layer in half]
                  for half in init) for i in range(len(seeds))]
    want = jcampaign.run_campaign(
        "splitme", dataclasses.replace(JDNN10, activation=act),
        JSystemParams(M=12, seed=0), cd, test_data=test, seeds=seeds, **kw)
    got = campaign.run_campaign(
        "splitme", dataclasses.replace(DNN10, activation=act),
        SystemParams(M=12, seed=0), cd, test_data=test, seeds=seeds,
        scan=True, device="cpu", params=init,
        index_source=CampaignIndexReplay(seeds, 12, 32, 32), **kw)
    if act == "gelu":
        assert np.isfinite(want.losses).all()
    np.testing.assert_allclose(got.losses, want.losses,
                               rtol=PARITY_TOL if act != "gelu" else 0.0,
                               atol=PARITY_TOL)
    if act == "squared_relu":
        assert np.isnan(want.losses[:, 1:]).all()
        return
    for i in range(len(seeds)):
        for g, w in zip(got.params_for(i), want.params_for(i)):
            assert_params_close(g, w, atol=PARITY_TOL)
    n_test = len(test[1])
    np.testing.assert_allclose(got.accuracy, want.accuracy, rtol=0,
                               atol=1.0 / n_test + 1e-6)
