"""The port's bf16 mixed precision against the JAX package on the CPU.

The same inputs, made from seeds with numpy, go through both packages:
``kl_mutual`` with mixed operands (its plain forward and gradient, against
``kl_rows_pallas`` in interpret mode and the custom_vjp's ``_kl_bwd``), the
mixed MLP forward and its gradients (``dnn.mlp_forward(precision=BF16)``),
one bf16 SplitMe round (full and gathered) and a 3-round, 2-seed bf16
campaign.  bf16 operands start from the same bf16 values on both sides
(rounded once in numpy by ``ml_dtypes``).  Bounds: the f32 KL rows' 1e-6
for the mixed forward; one bf16 unit in the last place for a bf16 gradient
(plus the f32 rounding of the closed form, 2^-23 of the largest element:
the two packages evaluate it in another order before rounding); 1e-3 for
bf16 params and losses, the reference's own bf16 bound
(tests/test_kernel_dispatch.py).  On the CPU the mixed products run in
f32 on the widened bf16 values, as XLA's CPU computes them.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.splitme_dnn import DNN10 as JDNN10
from repro.configs.splitme_dnn import DNNConfig as JDNNConfig
from repro.core import dnn as jdnn
from repro.core import engine as jengine
from repro.core.cost import SystemParams as JSystemParams
from repro.kernels.dispatch import BF16 as JBF16
from repro.kernels.dispatch import KernelPolicy as JKernelPolicy
from repro.kernels.kl_mutual import ops as jkl_ops
from repro.kernels.kl_mutual.kl_mutual import kl_rows_pallas
from repro.launch import campaign as jcampaign
from repro_torch.configs.splitme_dnn import DNN10, DNNConfig
from repro_torch.core import dnn, engine
from repro_torch.core.cost import SystemParams
from repro_torch.data import oran
from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import BF16, KernelPolicy
from repro_torch.kernels.kl_mutual import ops as kl_ops
from repro_torch.kernels.kl_mutual.ref import kl_grad_ref, kl_rows_ref
from repro_torch.launch import campaign
from torch_parity import (CampaignIndexReplay, assert_params_close,
                          bf16_ulp, jax_to_torch, one_torch_thread,
                          replay_round_indices)

HIDDEN = (32, 32, 16, 16, 8)
CFG = DNNConfig(hidden=HIDDEN)
JCFG = JDNNConfig(hidden=HIDDEN)
M, N, B, E_MAX = 8, 16, 8, 4
BF16_TOL = 1e-3
JBF16_POLICY = JKernelPolicy(precision=JBF16)
TBF16_POLICY = KernelPolicy(precision=BF16)
DTYPES = {"f32": (np.float32, torch.float32),
          "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _normal(seed, shape, scale=1.0, dtype="f32"):
    """Seeded normal values, rounded once to ``dtype`` in numpy; returned
    as the numpy array (for JAX) and the tensor holding the same values."""
    a = (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32).astype(DTYPES[dtype][0])
    return a, torch.from_numpy(a.astype(np.float32)).to(DTYPES[dtype][1])


def assert_within_one_bf16_ulp(got: np.ndarray, want: np.ndarray):
    got, want = got.astype(np.float64), want.astype(np.float64)
    slack = 2.0 ** -23 * np.abs(want).max()
    err = np.abs(got - want)
    bad = err > bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + slack
    assert not bad.any(), (f"{bad.sum()} of {bad.size} elements beyond one "
                           f"bf16 ulp: {got[bad][:4]} vs {want[bad][:4]}")


# ---------------------------------------------------------------------------
# kl_mutual with mixed operands
# ---------------------------------------------------------------------------

PAIRS = [("bf16", "f32"), ("f32", "bf16"), ("bf16", "bf16")]


@pytest.mark.parametrize("tx,ty", PAIRS)
@pytest.mark.parametrize("n,d,bq", [(96, 256, 32), (40, 37, 8)])
def test_kl_mixed_rows_match_pallas_interpret(tx, ty, n, d, bq):
    (xa, x), (ya, y) = (_normal(30, (n, d), 3.0, tx),
                        _normal(31, (n, d), 3.0, ty))
    # JAX's result is fetched before torch runs (ROADMAP C 1)
    want = np.asarray(kl_rows_pallas(jnp.asarray(xa), jnp.asarray(ya),
                                     temperature=2.0, bq=bq, interpret=True))
    got = kl_rows_ref(x, y, 2.0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the CPU wrapper is the plain version, for every pair of dtypes
    np.testing.assert_array_equal(kl_ops.kl_rows(x, y, 2.0).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("tx,ty", PAIRS)
@pytest.mark.parametrize("n,d", [(96, 256), (17, 33)])
def test_kl_mixed_grad_matches_kl_bwd(tx, ty, n, d):
    """The plain closed-form gradient in x's dtype against the reference's
    custom_vjp backward on the same bf16 values: g the cotangent of the
    mean over n rows, so g / n a row."""
    (xa, x), (ya, y) = (_normal(32, (n, d), 2.0, tx),
                        _normal(33, (n, d), 2.0, ty))
    g = 0.75
    gx, gy = jkl_ops._kl_bwd(2.0, 8, (jnp.asarray(xa), jnp.asarray(ya)),
                             jnp.asarray(g, jnp.float32))
    want = np.asarray(gx)
    assert want.dtype == DTYPES[tx][0] and not np.asarray(gy).any()
    got = kl_grad_ref(x, y, torch.full((n,), g / n), 2.0)
    assert got.dtype == DTYPES[tx][1]
    assert_within_one_bf16_ulp(got.float().numpy(), want.astype(np.float32))
    if tx == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("tx,ty", PAIRS)
def test_kl_loss_gradient_in_x_dtype_both_policies(tx, ty):
    """dispatch.kl_loss over a stacked (M, B, d) cohort: the kernel policy
    (closed-form backward) and the reference policy (autograd through the
    widening) give the loss in f32 and the gradient in x's dtype, within
    one bf16 ulp of each other."""
    (_, x), (_, y) = (_normal(34, (5, 8, 24), 2.0, tx),
                      _normal(35, (5, 8, 24), 2.0, ty))
    out = {}
    for pol in ("kernel", "reference"):
        tx_ = x.clone().requires_grad_(True)
        loss = dispatch.kl_loss(tx_, y, temperature=2.0, policy=pol)
        assert loss.dtype == torch.float32 and loss.shape == (5,)
        loss.sum().backward()
        assert tx_.grad.dtype == x.dtype
        out[pol] = (loss.detach().numpy(), tx_.grad.float().numpy())
    np.testing.assert_allclose(out["kernel"][0], out["reference"][0],
                               rtol=0, atol=1e-6)
    assert_within_one_bf16_ulp(out["kernel"][1], out["reference"][1])


# ---------------------------------------------------------------------------
# the mixed forward and its gradients
# ---------------------------------------------------------------------------

DIMS = (10, 32, 16, 3)


def _layers(seed, dims=DIMS):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.normal(size=(dims[i], dims[i + 1]))
                   * np.sqrt(2.0 / dims[i])).astype(np.float32),
             "b": rng.normal(size=dims[i + 1]).astype(np.float32) * 0.1}
            for i in range(len(dims) - 1)]


@pytest.mark.parametrize("final_linear", [True, False])
def test_mixed_forward_matches_jax(final_linear):
    layers = _layers(40)
    x, _ = _normal(41, (64, DIMS[0]))
    want = np.asarray(jdnn.mlp_forward(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in layers],
        jnp.asarray(x), final_linear=final_linear, precision=JBF16))
    got = dnn.mlp_forward(jax_to_torch(layers), torch.from_numpy(x),
                          final_linear=final_linear, precision=BF16)
    # logits stay f32, the smashed data (activated last layer) are bf16
    assert got.dtype == (torch.float32 if final_linear else torch.bfloat16)
    assert want.dtype == (np.float32 if final_linear else ml_dtypes.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=0, atol=BF16_TOL)


@pytest.mark.parametrize("final_linear", [True, False])
def test_mixed_gradients_round_like_jax(final_linear):
    """jax.grad through the mixed forward rounds each weight gradient and
    each layer input's cotangent to bf16 and keeps the bias gradients f32:
    the port's weight gradients are bf16 values, its bias gradients are
    not, and all are f32 tensors within one bf16 ulp of JAX's."""
    layers = _layers(42)
    x, _ = _normal(43, (64, DIMS[0]))

    def jloss(w):
        return jnp.sum(jdnn.mlp_forward(w, jnp.asarray(x),
                                        final_linear=final_linear,
                                        precision=JBF16).astype(jnp.float32))
    want = jax.device_get(jax.grad(jloss)(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in layers]))
    w = [{k: v.requires_grad_(True) for k, v in p.items()}
         for p in jax_to_torch(layers)]
    dnn.mlp_forward(w, torch.from_numpy(x), final_linear=final_linear,
                    precision=BF16).float().sum().backward()
    bias_not_bf16 = False
    for p, q in zip(w, want):
        gw, gb = p["w"].grad, p["b"].grad
        assert gw.dtype == gb.dtype == torch.float32
        assert torch.equal(gw, gw.bfloat16().float())
        bias_not_bf16 |= not torch.equal(gb, gb.bfloat16().float())
        assert_within_one_bf16_ulp(gw.numpy(), np.asarray(q["w"]))
        np.testing.assert_allclose(gb.numpy(), np.asarray(q["b"]), rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(q["b"]).max()))
    assert bias_not_bf16


def test_mixed_stacked_forward_and_grads_are_per_client():
    """Client-stacked (C, d_in, d_out) weights give each client's own
    mixed forward and gradients, bit for bit."""
    layers = jax_to_torch(_layers(44))
    x, _ = _normal(45, (3, 8, DIMS[0]))
    x = torch.from_numpy(x)
    stacked = [{k: v.expand(3, *v.shape).clone().requires_grad_(True)
                for k, v in p.items()} for p in layers]
    dnn.mlp_forward(stacked, x, final_linear=False,
                    precision=BF16).float().sum().backward()
    for c in range(3):
        one = [{k: v.clone().requires_grad_(True) for k, v in p.items()}
               for p in layers]
        out = dnn.mlp_forward(one, x[c], final_linear=False, precision=BF16)
        out.float().sum().backward()
        for p, q in zip(stacked, one):
            for k in p:
                torch.testing.assert_close(p[k].grad[c], q[k].grad, rtol=0,
                                           atol=0)


def test_mixed_precision_forward_close_and_f32_grads():
    """Twin of the reference's test: the mixed forward within 5e-2 of the
    f32 one, its logits f32, and f32 gradients for the f32 master
    parameters."""
    layers = jax_to_torch(_layers(46))
    x = torch.from_numpy(_normal(47, (64, DIMS[0]))[0])
    full = dnn.mlp_forward(layers, x)
    mixed = dnn.mlp_forward(layers, x, precision=BF16)
    assert mixed.dtype == torch.float32
    torch.testing.assert_close(mixed, full, rtol=5e-2, atol=5e-2)
    w = [{k: v.requires_grad_(True) for k, v in p.items()} for p in layers]
    dnn.mlp_forward(w, x, precision=BF16).sum().backward()
    assert all(v.grad.dtype == torch.float32 for p in w for v in p.values())


def test_f32_precision_is_the_plain_forward():
    layers = jax_to_torch(_layers(48))
    x = torch.from_numpy(_normal(49, (16, DIMS[0]))[0])
    for prec in (None, dispatch.F32):
        assert torch.equal(dnn.mlp_forward(layers, x, precision=prec),
                           dnn.mlp_forward(layers, x))


# ---------------------------------------------------------------------------
# one bf16 round and a bf16 campaign
# ---------------------------------------------------------------------------

def _round_data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(M, N, 30)).astype(np.float32)
    y = rng.integers(0, 3, (M, N)).astype(np.int32)
    a = np.array([1, 0, 1, 1, 0, 1, 1, 0], np.float32)
    return x, y, a


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("gather", [False, True])
def test_bf16_round_matches_jax_engine(gather):
    """One SplitMe round under BF16 (a partial cohort, e_steps < e_max):
    params and losses within 1e-3 of the reference's bf16 round."""
    x, y, a = _round_data()
    jspec = jengine.make_spec("splitme", JCFG, policy=JBF16_POLICY,
                              batch_size=B, masked_loss_metric=gather)
    jround = jengine.build_round_fn(jspec, JCFG, jnp.asarray(x),
                                    jnp.asarray(y), e_max=E_MAX,
                                    donate=False, gather=gather)
    key = jax.random.PRNGKey(3)
    init = jspec.init_fn(jax.random.PRNGKey(1))
    spec = engine.make_spec("splitme", CFG, policy=TBF16_POLICY,
                            batch_size=B, masked_loss_metric=gather)
    assert spec.policy.precision == BF16
    fn = engine.build_round_fn(spec, CFG, _t(x), _t(y), e_max=E_MAX,
                               gather=gather)
    idx = _t(replay_round_indices(key, 2, M, E_MAX, B, N))
    params = (jax_to_torch(init[0]), jax_to_torch(init[1]))
    if gather:
        sel = np.nonzero(a)[0]
        (jc, js), jl, _ = jround(init, jnp.asarray(sel, jnp.int32),
                                 jnp.ones(len(sel)), jnp.asarray(3), key, ())
        stacked = tuple([{k: v[None] for k, v in p.items()} for p in ps]
                        for ps in params)
        (c, s), losses, q = fn(stacked, _t(sel).long(), torch.ones(len(sel)),
                               3, idx[None])
        c, s = ([{k: v[0] for k, v in p.items()} for p in ps]
                for ps in (c, s))
    else:
        (jc, js), jl, _ = jround(init, jnp.asarray(a), jnp.asarray(3), key,
                                 ())
        (c, s), losses, q = fn(params, _t(a), 3, idx)
    assert q == ()
    assert all(v.dtype == torch.float32 for p in c + s for v in p.values())
    assert_params_close(c, jc, atol=BF16_TOL)
    assert_params_close(s, js, atol=BF16_TOL)
    for g, w in zip(losses, jl):
        assert abs(float(g.reshape(())) - float(w)) <= BF16_TOL


def test_bf16_round_takes_bf16_client_data():
    """Client data already in bf16 go in as they are; f32 data are cast
    once; either gives the same round.  f32 rounds refuse bf16 data."""
    x, y, a = _round_data()
    spec = engine.make_spec("splitme", CFG, policy=TBF16_POLICY,
                            batch_size=B)
    params = spec.init_fn(torch.Generator().manual_seed(0), "cpu")
    idx = torch.randint(0, N, (2, M, E_MAX, B),
                        generator=torch.Generator().manual_seed(1))
    outs = [engine.build_round_fn(spec, CFG, xx, _t(y), e_max=E_MAX)(
        params, _t(a), E_MAX, idx) for xx in (_t(x), _t(x).bfloat16())]
    for g, w in zip(outs[0][0], outs[1][0]):
        for gp, wp in zip(g, w):
            for k in gp:
                assert torch.equal(gp[k], wp[k])
    f32 = engine.make_spec("splitme", CFG, batch_size=B)
    with pytest.raises(TypeError, match="float32"):
        engine.build_round_fn(f32, CFG, _t(x).bfloat16(), _t(y), e_max=2)


@pytest.fixture(scope="module")
def campaign_data():
    X, y = oran.generate(n_per_class=300, seed=0)
    (Xtr, ytr), test = oran.train_test_split(X, y)
    cd = oran.partition_non_iid(Xtr, ytr, 12, samples_per_client=32, seed=0)
    return cd, test


SEEDS = (0, 1)
CAMPAIGN_KW = dict(rounds=3, seeds=SEEDS, e_initial=6, eval_gamma=10.0)


def _jax_initial_params(seeds):
    jspec = jengine.make_spec("splitme", JDNN10)
    init = jax.device_get(jax.vmap(jspec.init_fn)(
        jnp.stack([jax.random.PRNGKey(s) for s in seeds])))
    return [tuple([{k: v[i] for k, v in layer.items()} for layer in half]
                  for half in init) for i in range(len(seeds))]


def _port_campaign(cd, test, policy, scan=True):
    return campaign.run_campaign(
        "splitme", DNN10, SystemParams(M=12, seed=0), cd, test_data=test,
        policy=policy, scan=scan, eval_every=1 if scan else None,
        device="cpu", params=_jax_initial_params(SEEDS),
        index_source=CampaignIndexReplay(SEEDS, 12, 32, 32), **CAMPAIGN_KW)


@pytest.fixture(scope="module")
def bf16_campaigns(campaign_data):
    cd, test = campaign_data
    want = jcampaign.run_campaign(
        "splitme", JDNN10, JSystemParams(M=12, seed=0), cd, test_data=test,
        policy=JBF16_POLICY, eval_every=1, **CAMPAIGN_KW)
    runs = {(prec, scan): _port_campaign(
        cd, test, TBF16_POLICY if prec == "bf16" else None, scan)
        for prec, scan in (("bf16", True), ("bf16", False), ("f32", True))}
    return want, runs


def test_bf16_campaign_matches_jax_bf16(bf16_campaigns):
    want, runs = bf16_campaigns
    for scan in (True, False):
        got = runs["bf16", scan]
        np.testing.assert_array_equal(got.schedule.E, want.schedule.E)
        np.testing.assert_allclose(got.losses, want.losses, rtol=0,
                                   atol=BF16_TOL)
        for i in range(len(SEEDS)):
            for g, w in zip(got.params_for(i), want.params_for(i)):
                assert_params_close(g, w, atol=BF16_TOL)
    # graphed (on the CPU: the same bodies) equals eager bit for bit
    np.testing.assert_array_equal(runs["bf16", True].losses,
                                  runs["bf16", False].losses)


def test_bf16_campaign_close_to_port_f32(bf16_campaigns):
    _, runs = bf16_campaigns
    bf, f32 = runs["bf16", True], runs["f32", True]
    np.testing.assert_allclose(bf.losses, f32.losses, rtol=0, atol=BF16_TOL)
    for i in range(len(SEEDS)):
        for g, w in zip(bf.params_for(i), f32.params_for(i)):
            for p, q in zip(g, w):
                for k in p:
                    assert float((p[k] - q[k]).abs().max()) <= BF16_TOL


def test_bf16_campaign_accuracy_at_gamma_10(bf16_campaigns, campaign_data):
    """Step 4 on bf16 smashed data, per round at γ = 10 (where the f32
    ridge is well conditioned, ROADMAP C): within one test sample of the
    reference's bf16 campaign, and the loop's post-hoc evaluation agrees."""
    want, runs = bf16_campaigns
    n_test = len(campaign_data[1][1])
    got = runs["bf16", True]
    np.testing.assert_allclose(got.accuracy_per_round,
                               want.accuracy_per_round, rtol=0,
                               atol=1.0 / n_test + 1e-6)
    np.testing.assert_allclose(runs["bf16", False].accuracy, want.accuracy,
                               rtol=0, atol=1.0 / n_test + 1e-6)


def test_kernel_bf16_preset_resolves_by_device(campaign_data):
    """The preset is bf16 only where the run's device is a card: on the
    CPU a "kernel_bf16" campaign is the f32 campaign, bit for bit."""
    cd, test = campaign_data
    kw = dict(rounds=2, seeds=(0,), device="cpu", test_data=test)
    a = campaign.run_campaign("splitme", DNN10, SystemParams(M=12, seed=0),
                              cd, policy="kernel_bf16", **kw)
    b = campaign.run_campaign("splitme", DNN10, SystemParams(M=12, seed=0),
                              cd, **kw)
    np.testing.assert_array_equal(a.losses, b.losses)
    np.testing.assert_array_equal(a.accuracy, b.accuracy)
    spec = engine.make_spec("splitme", DNN10, policy="kernel_bf16",
                            device="cpu")
    assert spec.policy == dispatch.KERNEL
    spec = engine.make_spec("splitme", DNN10, policy="kernel_bf16",
                            device="cuda")
    assert spec.policy.precision == BF16 and not spec.policy.auto_precision
