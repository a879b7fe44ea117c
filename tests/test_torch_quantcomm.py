"""The port's wire formats (``repro_torch.core.quantcomm``) and their thread
through the SplitMe round, trainer and campaign, against the JAX package
on the CPU.

Both sides get the same inputs: the payload trees and residuals from
seeded numpy, the int8 uniforms replayed from the reference's key chain
(``torch_parity.replay_round_uniforms``: the round key's
``fold_in(fold_in(key, 0x5157), 0)``, one key per leaf in
``jax.tree.flatten`` order), the batches from its round keys.  Bounds:
``fake_quant_int8`` bit for bit (the same f32 elementwise chain), the
error-feedback identity at 1e-6 a round (the reference's own test);
schedules, S_m, d_model_bits and the system metrics exactly; a quantized
round per element within one wire step of the reference (one bf16 unit in
the last place of the aggregated numerator, or the leaf's int8 grid step,
both divided by |A_t|) plus 1e-5, because a 1e-7 difference before a
rounding can move it by one step; quantized campaigns within the
reference's documented bounds against f32, 2e-2 (bf16) and 6e-2 (int8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.splitme_dnn import DNN10 as JDNN10
from repro.configs.splitme_dnn import DNNConfig as JDNNConfig
from repro.core import engine as jengine
from repro.core import quantcomm as jquantcomm
from repro.core.cost import SystemParams as JSystemParams
from repro.core.splitme import SplitMeTrainer as JSplitMeTrainer
from repro.launch import campaign as jcampaign
from repro_torch.configs.splitme_dnn import DNN10, DNNConfig
from repro_torch.core import engine, quantcomm
from repro_torch.core.cost import SystemParams
from repro_torch.core.quantcomm import CommQuant
from repro_torch.core.splitme import SplitMeTrainer
from repro_torch.data import oran
from repro_torch.launch import campaign
from torch_parity import (CampaignIndexReplay, CampaignUniformReplay,
                          TrainerIndexReplay, TrainerUniformReplay,
                          assert_params_close, bf16_ulp, jax_to_torch,
                          one_torch_thread, replay_round_indices,
                          replay_round_uniforms)

HIDDEN = (32, 32, 16, 16, 8)
CFG = DNNConfig(hidden=HIDDEN)
JCFG = JDNNConfig(hidden=HIDDEN)
M, N, B, E_MAX = 8, 16, 8, 4
WIRE_TOL = {"bf16": 2e-2, "int8": 6e-2}


def _t(a):
    return torch.tensor(np.asarray(a))


def _tree(seed, shapes=((3, 5), (5, 2), (2, 4))):
    """{0: layers, 1: layers} of seeded normal numpy arrays: the shape of
    a SplitMe aggregation payload."""
    rng = np.random.default_rng(seed)

    def layers(dims):
        return [{"w": rng.normal(size=dims).astype(np.float32),
                 "b": rng.normal(size=dims[1:]).astype(np.float32)}
                for dims in dims]
    return {0: layers(shapes[:2]), 1: layers(shapes[1:])}


def _np_to_torch(tree):
    return quantcomm.tree_map(torch.from_numpy, tree)


def _uniforms(key, tree) -> np.ndarray:
    """What the reference's fake_quant_int8 draws from ``key``: one
    subkey a leaf in flatten order."""
    leaves = jax.tree.leaves(tree)
    keys = jax.random.split(key, len(leaves))
    return np.concatenate([np.asarray(jax.random.uniform(
        k, l.shape, dtype=jnp.float32)).ravel()
        for k, l in zip(keys, leaves)])


# ---------------------------------------------------------------------------
# the quantizer
# ---------------------------------------------------------------------------

def test_quant_resolution_matches_reference():
    assert quantcomm.quant_names() == jquantcomm.quant_names()
    for name in quantcomm.quant_names():
        q, jq = quantcomm.get_quant(name), jquantcomm.get_quant(name)
        assert (q.wire_bits, q.wire_scale, q.stochastic, q.stateful) == \
            (jq.wire_bits, jq.wire_scale, jq.stochastic, jq.stateful)
    assert quantcomm.get_quant(None) is quantcomm.NONE
    assert not CommQuant("int8", error_feedback=False).stateful
    with pytest.raises(KeyError):
        quantcomm.get_quant("fp4")
    with pytest.raises(KeyError):
        CommQuant("fp4")


def test_tree_leaves_is_jax_flatten_order():
    tree = _tree(0)
    got = quantcomm.tree_leaves(tree)
    want = jax.tree.leaves(tree)
    assert len(got) == len(want)
    assert all(g is w for g, w in zip(got, want))


@pytest.mark.parametrize("with_state", [True, False])
def test_fake_quant_int8_bit_identical_to_reference(with_state):
    """The same payload, residual and uniforms: the same f32 chain (tot,
    scale, floor, clip, deq, residual), bit for bit."""
    tree = _tree(1)
    state = quantcomm.tree_map(lambda a: a * np.float32(0.01), _tree(2))
    quant = quantcomm.INT8 if with_state else CommQuant(
        "int8", error_feedback=False)
    jquant = jquantcomm.INT8 if with_state else jquantcomm.CommQuant(
        "int8", error_feedback=False)
    key = jax.random.PRNGKey(9)
    jtree = jax.tree.map(jnp.asarray, tree)
    jstate = jax.tree.map(jnp.asarray, state) if with_state else ()
    jdeq, jnew = jquantcomm.fake_quant_int8(jtree, jstate, key, jquant)
    deq, new = quantcomm.fake_quant_int8(
        _np_to_torch(tree), _np_to_torch(state) if with_state else (),
        torch.from_numpy(_uniforms(key, tree)), quant)
    for g, w in zip(quantcomm.tree_leaves(deq), jax.tree.leaves(jdeq)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if with_state:
        for g, w in zip(quantcomm.tree_leaves(new), jax.tree.leaves(jnew)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    else:
        assert new == () and jnew == ()


def test_error_feedback_telescopes():
    """Twin of the reference's test: each round deq + ef_new == v + ef_old
    (1e-6), and over 5 rounds the wire sum plus the last residual equals
    the true sum (1e-5), the residual under one grid step."""
    tree = quantcomm.tree_map(torch.zeros_like, _np_to_torch(_tree(3)))
    state = quantcomm.tree_map(torch.zeros_like, tree)
    total_v = quantcomm.tree_map(torch.zeros_like, tree)
    total_deq = quantcomm.tree_map(torch.zeros_like, tree)
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        v = quantcomm.tree_map(lambda z: torch.from_numpy(
            rng.normal(size=tuple(z.shape)).astype(np.float32)), tree)
        old = state
        u = torch.rand(quantcomm.n_elements(tree), generator=gen)
        deq, state = quantcomm.fake_quant_int8(v, state, u, quantcomm.INT8)
        for d, e_new, vv, e_old in zip(*(quantcomm.tree_leaves(t) for t in
                                         (deq, state, v, old))):
            torch.testing.assert_close(d + e_new, vv + e_old, rtol=0,
                                       atol=1e-6)
        total_v = quantcomm.tree_map(torch.add, total_v, v)
        total_deq = quantcomm.tree_map(torch.add, total_deq, deq)
    for s, d, e in zip(*(quantcomm.tree_leaves(t) for t in
                         (total_v, total_deq, state))):
        torch.testing.assert_close(d + e, s, rtol=0, atol=1e-5)
        assert float(e.abs().max()) < 0.2


def test_int8_stochastic_rounding_unbiased():
    quant = CommQuant("int8", error_feedback=False)
    v = torch.from_numpy(np.random.default_rng(1).normal(size=64)
                         .astype(np.float32))
    gen = torch.Generator().manual_seed(2)
    mean = torch.stack([quantcomm.fake_quant_int8(
        v, (), torch.rand(64, generator=gen), quant)[0]
        for _ in range(256)]).mean(0)
    scale = float(v.abs().max()) / quant.levels
    torch.testing.assert_close(mean, v, rtol=0, atol=scale / 4)


def test_seed_stacked_payload_quantizes_each_seed_alone():
    """``lead=1``: each seed's slice has its own scale and residual, bit
    for bit what quantizing that seed's payload alone gives."""
    S = 3
    trees = [_np_to_torch(_tree(10 + s)) for s in range(S)]
    states = [quantcomm.tree_map(lambda a: a * 0.01,
                                 _np_to_torch(_tree(20 + s)))
              for s in range(S)]
    stack = (lambda *ls: torch.stack(ls))
    n = quantcomm.n_elements(trees[0])
    u = torch.rand(S, n, generator=torch.Generator().manual_seed(3))
    deq, new = quantcomm.fake_quant_int8(
        quantcomm.tree_map(stack, *trees), quantcomm.tree_map(stack, *states),
        u, quantcomm.INT8, lead=1)
    assert quantcomm.n_elements(quantcomm.tree_map(stack, *trees), 1) == n
    for s in range(S):
        d1, n1 = quantcomm.fake_quant_int8(trees[s], states[s], u[s],
                                           quantcomm.INT8)
        for a, b in zip(quantcomm.tree_leaves(deq), quantcomm.tree_leaves(d1)):
            assert torch.equal(a[s], b)
        for a, b in zip(quantcomm.tree_leaves(new), quantcomm.tree_leaves(n1)):
            assert torch.equal(a[s], b)
    with pytest.raises(ValueError, match="uniforms"):
        quantcomm.fake_quant_int8(trees[0], states[0], u[0, :-1],
                                  quantcomm.INT8)


def test_simulate_cast_gain_and_clip_match_reference():
    rng = np.random.default_rng(4)
    tree = {0: [{"w": rng.normal(size=(6, 3, 5)).astype(np.float32),
                 "b": rng.normal(size=(6, 5)).astype(np.float32)}]}
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = _np_to_torch(tree)
    for g, w in zip(
            quantcomm.tree_leaves(quantcomm.simulate_cast(ttree,
                                                          torch.bfloat16)),
            jax.tree.leaves(jquantcomm.simulate_cast(jtree, jnp.bfloat16))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    gain = rng.uniform(-4, 4, 6).astype(np.float32)
    for g, w in zip(
            quantcomm.tree_leaves(quantcomm.apply_client_gain(
                ttree, torch.from_numpy(gain))),
            jax.tree.leaves(jquantcomm.apply_client_gain(
                jtree, jnp.asarray(gain)))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for max_norm in (0.5, 3.0, 1e3):
        for g, w in zip(
                quantcomm.tree_leaves(quantcomm.clip_client_norm(ttree,
                                                                 max_norm)),
                jax.tree.leaves(jquantcomm.clip_client_norm(jtree,
                                                            max_norm))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
    # a NaN-poisoned client stays NaN, the others are clipped finite
    poisoned = quantcomm.apply_client_gain(
        ttree, torch.tensor([float("nan")] + [1.0] * 5))
    out = quantcomm.clip_client_norm(poisoned, 0.5)
    assert torch.isnan(out[0][0]["w"][0]).all()
    assert torch.isfinite(out[0][0]["w"][1:]).all()


# ---------------------------------------------------------------------------
# schedules and system metrics under a wire format: exactly the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["bf16", "int8"])
@pytest.mark.parametrize("M_,n_m,rounds", [(50, 96, 30), (12, 32, 9)])
def test_schedule_and_system_metrics_match_reference(quant, M_, n_m, rounds):
    """make_policy(quant=) scales S_m and d_model_bits before Alg. 1's
    initial state, so the schedule itself changes: the port's equals the
    reference's exactly, with the comm bits, latency, cost and energy."""
    sp, sched = campaign.plan_schedule(
        "splitme", SystemParams(M=M_), DNN10, rounds,
        n_samples_per_client=n_m, quant=quant)
    jsp, jsched = jcampaign.plan_schedule(
        "splitme", JSystemParams(M=M_), JDNN10, rounds,
        n_samples_per_client=n_m, quant=quant)
    np.testing.assert_array_equal(sched.a, jsched.a)
    np.testing.assert_array_equal(sched.b, jsched.b)
    np.testing.assert_array_equal(sched.E, jsched.E)
    np.testing.assert_array_equal(sp.S_m, jsp.S_m)
    assert (sp.omega, sp.d_model_bits) == (jsp.omega, jsp.d_model_bits)
    spec = engine.make_spec("splitme", DNN10, quant=quant,
                            masked_loss_metric=True)
    jspec = jengine.make_spec("splitme", JDNN10, quant=quant,
                              masked_loss_metric=True)
    assert spec.quant.mode == jspec.quant.mode == quant
    for g, w in zip(campaign._schedule_system_metrics(spec, sched, sp),
                    jcampaign._schedule_system_metrics(jspec, jsched, jsp)):
        np.testing.assert_array_equal(g, w)
    # the narrower payload: fewer bits than the f32 plan's each round
    sp32, _ = campaign.plan_schedule("splitme", SystemParams(M=M_), DNN10, 1,
                                     n_samples_per_client=n_m)
    assert sp.d_model_bits == sp32.d_model_bits * spec.quant.wire_scale


def test_make_policy_scales_the_payload_before_the_initial_state():
    """The trainer's private SystemParams and policy under each wire
    format step exactly as the reference's."""
    for quant in (None, "none", "bf16", "int8"):
        tsp, tpol = engine.make_policy("splitme", SystemParams(M=12), DNN10,
                                       n_samples_per_client=32, quant=quant)
        jsp, jpol = jengine.make_policy("splitme", JSystemParams(M=12),
                                        JDNN10, n_samples_per_client=32,
                                        quant=quant)
        assert tpol.state.t_max_k == jpol.state.t_max_k
        np.testing.assert_array_equal(tsp.S_m, jsp.S_m)
        for _ in range(4):
            a, b, E = tpol.step()
            ja, jb, jE = jpol.step()
            np.testing.assert_array_equal(a, ja)
            np.testing.assert_array_equal(b, jb)
            assert E == jE


# ---------------------------------------------------------------------------
# one quantized round against engine.build_round_fn
# ---------------------------------------------------------------------------

def _round_data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(M, N, 30)).astype(np.float32)
    y = rng.integers(0, 3, (M, N)).astype(np.int32)
    a = np.array([1, 0, 1, 1, 0, 1, 1, 0], np.float32)
    return x, y, a


def _wire_step(quant, want: np.ndarray, wsum: float) -> np.ndarray:
    """One wire step at each element of an aggregated leaf ``want`` (the
    numerator divided by |A_t| = ``wsum``): a bf16 ulp of the numerator, or
    the leaf's int8 grid step, divided by |A_t|."""
    if quant == "bf16":
        return bf16_ulp(want * wsum) / wsum
    return np.full(want.shape, np.abs(want).max() * (1 + 1 / 127) / 127)


def _within_a_wire_step(quant, got, want, wsum, shares):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want)
    assert (err <= _wire_step(quant, want, wsum) + 1e-5).all(), \
        f"{quant}: max err {err.max()}"
    shares.append(((err > 1e-5).sum(), err.size))


@pytest.mark.parametrize("quant", ["bf16", "int8"])
@pytest.mark.parametrize("gather", [False, True])
def test_quantized_round_matches_jax_engine(quant, gather, capsys):
    """One SplitMe round under each wire format, with the reference's
    batches and int8 uniforms: params, losses and the EF state within one
    wire step + 1e-5 per element; the share of elements beyond 1e-5 is
    printed (a rounding moved by a 1e-7 difference)."""
    x, y, a = _round_data()
    sel = np.nonzero(a)[0]
    wsum = float(len(sel))
    jspec = jengine.make_spec("splitme", JCFG, policy="reference",
                              batch_size=B, quant=quant,
                              masked_loss_metric=gather)
    jround = jengine.build_round_fn(jspec, JCFG, jnp.asarray(x),
                                    jnp.asarray(y), e_max=E_MAX,
                                    donate=False, gather=gather)
    key = jax.random.PRNGKey(3)
    init = jspec.init_fn(jax.random.PRNGKey(1))
    jq = jengine.init_quant_state(jspec, init)
    spec = engine.make_spec("splitme", CFG, batch_size=B, quant=quant,
                            masked_loss_metric=gather)
    fn = engine.build_round_fn(spec, CFG, _t(x), _t(y), e_max=E_MAX,
                               gather=gather)
    params = (jax_to_torch(init[0]), jax_to_torch(init[1]))
    q = engine.init_quant_state(spec, params)
    idx = _t(replay_round_indices(key, 2, M, E_MAX, B, N))
    u = None
    if quant == "int8":
        u = torch.from_numpy(replay_round_uniforms(
            key, {0: init[0], 1: init[1]}))
        assert u.shape == (quantcomm.n_elements(
            engine.trained_params(spec, params)),)
    if gather:
        (jc, js), jl, jnq = jround(init, jnp.asarray(sel, jnp.int32),
                                   jnp.ones(len(sel)), jnp.asarray(3), key,
                                   jq)
        one = (lambda t: quantcomm.tree_map(lambda v: v[None], t))
        (c, s), losses, nq = fn(one(params), _t(sel).long(),
                                torch.ones(len(sel)), 3, idx[None], one(q),
                                None if u is None else u[None])
        unstack = (lambda t: quantcomm.tree_map(lambda v: v[0], t))
        c, s, nq = unstack(c), unstack(s), unstack(nq)
    else:
        (jc, js), jl, jnq = jround(init, jnp.asarray(a), jnp.asarray(3), key,
                                   jq)
        (c, s), losses, nq = fn(params, _t(a), 3, idx, q, u)
    shares = []
    for got, want in ((c, jc), (s, js)):
        for gp, wp in zip(got, jax.device_get(want)):
            for k in gp:
                _within_a_wire_step(quant, gp[k].numpy(), wp[k], wsum, shares)
    for g, w in zip(losses, jl):
        step = bf16_ulp(np.asarray(float(w) * wsum)) / wsum \
            if quant == "bf16" else 0.0
        assert abs(float(g.reshape(())) - float(w)) <= step + 1e-5
    if quant == "int8":
        # the residual tot − deq moves by one grid step of its numerator
        # where a rounding moved
        params_j = jax.tree.leaves(jax.device_get({0: jc, 1: js}))
        resid_j = jax.tree.leaves(jax.device_get(jnq))
        assert len(resid_j) == len(quantcomm.tree_leaves(nq)) == len(params_j)
        for g, w, p in zip(quantcomm.tree_leaves(nq), resid_j, params_j):
            step = np.abs(p).max() * wsum * (1 + 1 / 127) / 127
            assert np.abs(g.numpy() - np.asarray(w)).max() <= step + 1e-5
    else:
        assert nq == () and jnq == ()
    beyond = sum(b for b, _ in shares) / sum(n for _, n in shares)
    with capsys.disabled():
        print(f"\n{quant} round (gather={gather}): {beyond:.2e} of the "
              f"params beyond 1e-5 of the reference")
    assert beyond <= 1e-2


def test_round_checks_uniforms_and_qstate():
    x, y, a = _round_data()
    spec = engine.make_spec("splitme", CFG, batch_size=B, quant="int8")
    fn = engine.build_round_fn(spec, CFG, _t(x), _t(y), e_max=2)
    params = spec.init_fn(torch.Generator().manual_seed(0), "cpu")
    q = engine.init_quant_state(spec, params)
    idx = torch.zeros(2, M, 2, B, dtype=torch.int64)
    with pytest.raises(ValueError, match="uniforms"):
        fn(params, _t(a), 2, idx, q, None)
    with pytest.raises(ValueError, match="uniforms"):
        fn(params, _t(a), 2, idx, q, torch.rand(5))
    with pytest.raises(ValueError, match="qstate"):
        fn(params, _t(a), 2, idx, (), engine.quant_uniforms(
            spec, params, torch.Generator()))
    none = engine.make_spec("splitme", CFG, batch_size=B)
    assert engine.init_quant_state(none, params) == ()
    with pytest.raises(ValueError, match="uniforms"):
        engine.build_round_fn(none, CFG, _t(x), _t(y), e_max=2)(
            params, _t(a), 2, idx, (), torch.rand(3))


def test_unselected_quantized_round_leaves_nothing_nan():
    """|A_t| = 0 under int8: zero numerators quantize to zero (the 1e-12
    scale floor), so the round gives zeros, as the f32 one does."""
    x, y, _ = _round_data()
    spec = engine.make_spec("splitme", CFG, batch_size=B, quant="int8")
    params = spec.init_fn(torch.Generator().manual_seed(0), "cpu")
    (c, s), losses, q = engine.build_round_fn(
        spec, CFG, _t(x), _t(y), e_max=2)(
        params, torch.zeros(M), 2, torch.zeros(2, M, 2, B, dtype=torch.int64),
        engine.init_quant_state(spec, params),
        engine.quant_uniforms(spec, params, torch.Generator()))
    assert all(float(v.abs().max()) == 0.0 for p in c + s
               for v in p.values())
    assert all(float(l) == 0.0 for l in losses)
    assert all(float(v.abs().max()) == 0.0
               for v in quantcomm.tree_leaves(q))


# ---------------------------------------------------------------------------
# quantized campaigns and the trainer
# ---------------------------------------------------------------------------

SEEDS = (0, 1)


@pytest.fixture(scope="module")
def campaign_data():
    X, y = oran.generate(n_per_class=300, seed=0)
    (Xtr, ytr), test = oran.train_test_split(X, y)
    cd = oran.partition_non_iid(Xtr, ytr, 12, samples_per_client=32, seed=0)
    return cd, test


def _jax_initial_params(seeds):
    jspec = jengine.make_spec("splitme", JDNN10)
    init = jax.device_get(jax.vmap(jspec.init_fn)(
        jnp.stack([jax.random.PRNGKey(s) for s in seeds])))
    return [tuple([{k: v[i] for k, v in layer.items()} for layer in half]
                  for half in init) for i in range(len(seeds))]


@pytest.fixture(scope="module", params=["bf16", "int8"])
def quant_campaigns(request, campaign_data):
    quant = request.param
    cd, test = campaign_data
    kw = dict(rounds=3, seeds=SEEDS, test_data=test, quant=quant)
    want = jcampaign.run_campaign("splitme", JDNN10,
                                  JSystemParams(M=12, seed=0), cd, **kw)
    init = _jax_initial_params(SEEDS)
    runs = {scan: campaign.run_campaign(
        "splitme", DNN10, SystemParams(M=12, seed=0), cd, scan=scan,
        device="cpu", params=init,
        index_source=CampaignIndexReplay(SEEDS, 12, 32, 32),
        uniform_source=CampaignUniformReplay(
            SEEDS, {0: init[0][0], 1: init[0][1]}), **kw)
        for scan in (True, False)}
    return quant, want, runs


def test_quantized_campaign_matches_jax(quant_campaigns):
    """A 3-round, 2-seed campaign under the wire format, with the
    reference's batches and uniforms: the schedule and system metrics
    exactly, params and losses within the reference's documented bound,
    the EF state finite, graphed (the same bodies on the CPU) equal to
    eager bit for bit."""
    quant, want, runs = quant_campaigns
    tol = WIRE_TOL[quant]
    for got in runs.values():
        np.testing.assert_array_equal(got.schedule.a, want.schedule.a)
        np.testing.assert_array_equal(got.schedule.E, want.schedule.E)
        for mg, mw in zip(got.metrics, want.metrics):
            for f in ("n_selected", "E", "comm_bits", "sim_time", "cost",
                      "energy"):
                assert getattr(mg, f) == getattr(mw, f), f
        np.testing.assert_allclose(got.losses, want.losses, rtol=0, atol=tol)
        for i in range(len(SEEDS)):
            for g, w in zip(got.params_for(i), want.params_for(i)):
                assert_params_close(g, w, atol=tol)
    assert np.isfinite(runs[True].accuracy).all()
    np.testing.assert_array_equal(runs[True].losses, runs[False].losses)
    for i in range(len(SEEDS)):
        for g, w in zip(runs[True].params_for(i), runs[False].params_for(i)):
            for gp, wp in zip(g, w):
                assert all(torch.equal(gp[k], wp[k]) for k in gp)
    qs = [quantcomm.tree_leaves(r.qstate) for r in runs.values()]
    if quant == "int8":
        assert len(qs[0]) == 4 + 16 and all(
            torch.isfinite(v).all() and v.shape[0] == len(SEEDS)
            for v in qs[0])
        assert all(torch.equal(a, b) for a, b in zip(*qs))
    else:
        assert qs == [[], []]


def test_quantized_campaign_default_draws(campaign_data):
    """Without the hooks: each seed's own generators; one seed, one run,
    and an int8 campaign draws the same batches as the f32 one (its
    uniforms come from a generator of their own)."""
    cd, _ = campaign_data
    runs = [campaign.run_campaign("splitme", DNN10,
                                  SystemParams(M=12, seed=0), cd, rounds=2,
                                  seeds=(4, 5), device="cpu", quant=q)
            for q in ("int8", "int8", "none")]
    np.testing.assert_array_equal(runs[0].losses, runs[1].losses)
    assert (runs[0].losses[0] != runs[0].losses[1]).any()
    spec = engine.make_spec("splitme", DNN10, quant="int8")
    init = spec.init_fn(torch.Generator().manual_seed(4), "cpu")
    u = engine.quant_uniforms(spec, init, engine.uniform_generator(4))
    assert u.shape == (139520,) and float(u.min()) >= 0 and float(u.max()) < 1
    # the int8 campaign draws the f32 campaign's batches (and params)
    states = [campaign._initial_state(
        engine.make_spec("splitme", DNN10, quant=q), (4, 5), None, None,
        None, [3, 2], 12, 32, torch.device("cpu")) for q in ("int8", "none")]
    for a, b in zip(states[0][2], states[1][2]):
        assert torch.equal(a, b)
    assert states[0][3][0].shape == (2, 139520) and states[1][3] is None
    assert len(quantcomm.tree_leaves(states[0][1])) == 20


@pytest.fixture(scope="module")
def int8_trainers():
    X, y = oran.generate(n_per_class=100, seed=0)
    train, test = oran.train_test_split(X, y)
    clients = oran.partition_non_iid(*train, M, N, seed=0)
    t_round = np.random.default_rng(5).uniform(20e-3, 100e-3, M)
    jt = JSplitMeTrainer(JCFG, JSystemParams(M=M, E_max=E_MAX,
                                             t_round=t_round.copy()),
                         clients, test, batch_size=B, e_initial=E_MAX,
                         kernel_policy="reference", comm_quant="int8",
                         seed=0)
    init = (jax.device_get(jt.w_c), jax.device_get(jt.w_s_inv))
    tt = SplitMeTrainer(
        CFG, SystemParams(M=M, E_max=E_MAX, t_round=t_round.copy()),
        clients, test, batch_size=B, e_initial=E_MAX, seed=0, device="cpu",
        params=init, comm_quant="int8",
        index_source=TrainerIndexReplay(0, M, E_MAX, B, N),
        uniform_source=TrainerUniformReplay(0, {0: init[0], 1: init[1]}))
    hist = [(jt.run_round(), tt.run_round()) for _ in range(3)]
    jt.fetch_history()
    tt.fetch_history()
    return jt, tt, hist


def test_int8_trainer_matches_jax_trainer(int8_trainers):
    """SplitMeTrainer(comm_quant="int8") carries its EF state from round
    to round: 3 rounds with the reference's batches and uniforms, the
    schedule exactly, params and losses within the int8 bound."""
    jt, tt, hist = int8_trainers
    for mj, mt in hist:
        assert (mt.n_selected, mt.E, mt.comm_bits, mt.sim_time) == \
            (mj.n_selected, mj.E, mj.comm_bits, mj.sim_time)
        assert abs(mt.client_loss - mj.client_loss) <= WIRE_TOL["int8"]
    assert_params_close(tt.w_c, jt.w_c, atol=WIRE_TOL["int8"])
    assert_params_close(tt.w_s_inv, jt.w_s_inv, atol=WIRE_TOL["int8"])
    for g, w in zip(quantcomm.tree_leaves(tt._qstate),
                    jax.tree.leaves(jt._qstate)):
        assert g.shape == tuple(np.shape(w)) and torch.isfinite(g).all()


def test_quantized_trainer_draws_the_f32_batches():
    """The int8 trainer's uniforms come from a generator of its own: after
    a round its batch generator is where the f32 trainer's is."""
    X, y = oran.generate(n_per_class=60, seed=1)
    train, test = oran.train_test_split(X, y)
    clients = oran.partition_non_iid(*train, 4, 8, seed=0)
    gens = []
    for q in ("none", "bf16", "int8"):
        t = SplitMeTrainer(CFG, SystemParams(M=4, E_max=2), clients, test,
                           batch_size=4, e_initial=2, seed=7, device="cpu",
                           comm_quant=q)
        t.run_round()
        gens.append(t.generator.get_state())
    assert torch.equal(gens[0], gens[1]) and torch.equal(gens[0], gens[2])
