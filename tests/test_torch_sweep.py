"""The port's config sweep (``repro_torch.launch.campaign.run_config_sweep``)
and the gathered round with a cohort per pair (``engine._paired_core``)
against the JAX package on the CPU.

The size of tests/test_torch_population.py: DNN 30→32→16→3 split after
layer 1, ``oran.generate(n_per_class=300)``, M 12 clients of 24 samples,
4 rounds, seeds 0 and 1, K 4, E 3, the evaluation after rounds 1 and 3 at
γ 10 (a well-conditioned ridge); three variants whose bandwidth B is
halved, kept and doubled, which give the variants different cohorts and E.
Both sides get the JAX sweep's initial parameters and its batches (and int8
uniforms), replayed from its key chains (``torch_parity``): the reference's
variants share a seed's chain, and an E-bucket draw is the prefix of the
sweep-wide E_max draw.  Each JAX sweep runs once (module-scoped fixtures).

Bounds:

* exact for the schedules and the system metrics (numpy copies of numpy
  code);
* 1e-5 of scale for f32 params and losses (each leaf's largest magnitude,
  at least 1), accuracy per round within one test sample;
* 1e-3 under the bf16 precision (the reference's bf16 bound,
  tests/test_kernel_dispatch.py) and 6e-2 on the int8 wire
  (tests/test_torch_quantcomm.py's ``WIRE_TOL["int8"]``);
* the sweep against its own per-variant campaigns (``vmap_configs=False``)
  with the bounds of the reference's own test (tests/test_campaign.py):
  losses 1e-5, accuracy 1e-6, comm_bits exactly, params 2e-3;
* the per-pair round against one shared-cohort round per pair at 1e-6.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.splitme_dnn import DNNConfig as JDNNConfig
from repro.core.cost import SystemParams as JSystemParams
from repro.kernels.dispatch import BF16 as JBF16
from repro.kernels.dispatch import KernelPolicy as JKernelPolicy
from repro.launch import campaign as jcampaign
from repro_torch.configs.splitme_dnn import DNNConfig
from repro_torch.core import engine, quantcomm
from repro_torch.core.cost import SystemParams
from repro_torch.core.engine import RoundGuards
from repro_torch.data import oran
from repro_torch.kernels.dispatch import BF16, KernelPolicy
from repro_torch.launch import campaign
from torch_parity import (CampaignIndexDraws, CampaignIndexReplay,
                          CampaignUniformReplay, jax_initial_params,
                          one_torch_thread)

_CFG = dict(hidden=(32, 16), split_index=1)
CFG, JCFG = DNNConfig(**_CFG), JDNNConfig(**_CFG)
M, N, B = 12, 24, 32
SEEDS = (0, 1)
ROUNDS = 4
BANDWIDTHS = (0.5e9, 1e9, 2e9)
F32_TOL, BF16_TOL, INT8_TOL = 1e-5, 1e-3, 6e-2
SWEEP = dict(rounds=ROUNDS, seeds=SEEDS, eval_every=2, eval_gamma=10.0,
             K=4, E=3)


@pytest.fixture(scope="module")
def data():
    X, y = oran.generate(n_per_class=300, seed=0)
    (Xtr, ytr), test = oran.train_test_split(X, y)
    cd = oran.partition_non_iid(Xtr, ytr, M, samples_per_client=N, seed=0)
    return cd, test


def _variants(sp_cls, bandwidths=BANDWIDTHS, **kw):
    return [sp_cls(M=M, seed=0, B=b, **kw) for b in bandwidths]


def _n_phases(fw: str) -> int:
    return 2 if fw == "splitme" else 1


def _pair(fw, data, jkw=None, tkw=None, **kw):
    """The JAX sweep and the port's on the same draws (``kw`` to both,
    ``jkw`` to JAX's, ``tkw`` to the port's), and the port's host
    transfers under strict_transfers."""
    cd, test = data
    kw = dict(SWEEP, test_data=test, **kw)
    want = jcampaign.run_config_sweep(fw, JCFG, _variants(JSystemParams), cd,
                                      **kw, **(jkw or {}))
    init = jax_initial_params(fw, JCFG, SEEDS)
    us = None
    if kw.get("quant") == "int8":
        us = CampaignUniformReplay(SEEDS, {i: init[0][i]
                                           for i in range(_n_phases(fw))})
    campaign.HOST_TRANSFERS = 0
    got = campaign.run_config_sweep(
        fw, CFG, _variants(SystemParams), cd, device="cpu", params=init,
        strict_transfers=True, uniform_source=us,
        index_source=CampaignIndexReplay(SEEDS, M, B, N,
                                         n_phases=_n_phases(fw)),
        **kw, **(tkw or {}))
    return want, got, campaign.HOST_TRANSFERS


def _tree_err(got, want) -> float:
    return max(float(np.abs(np.asarray(g) - np.asarray(w)).max())
               / max(1.0, float(np.abs(np.asarray(w)).max()))
               for g, w in zip(quantcomm.tree_leaves(got),
                               jax.tree.leaves(jax.device_get(want))))


def _assert_sweep_matches(want, got, tol, n_test):
    assert len(got) == len(want) == len(BANDWIDTHS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.schedule.a, w.schedule.a)
        np.testing.assert_array_equal(g.schedule.b, w.schedule.b)
        np.testing.assert_array_equal(g.schedule.E, w.schedule.E)
        for mg, mw in zip(g.metrics, w.metrics):
            for f in ("round", "n_selected", "E", "comm_bits", "sim_time",
                      "cost", "energy"):
                assert getattr(mg, f) == getattr(mw, f), f
        assert g.losses.shape == w.losses.shape
        assert _tree_err(g.params, w.params) <= tol
        np.testing.assert_array_equal(np.isnan(g.losses),
                                      np.isnan(w.losses))
        ok = ~np.isnan(w.losses)
        assert (np.abs(g.losses[ok] - w.losses[ok])
                <= tol * np.maximum(1.0, np.abs(w.losses[ok]))).all()
        np.testing.assert_array_equal(np.isnan(g.accuracy_per_round),
                                      np.isnan(w.accuracy_per_round))
        np.testing.assert_allclose(g.accuracy_per_round,
                                   w.accuracy_per_round, rtol=0,
                                   atol=1.0 / n_test + 1e-6)
        np.testing.assert_array_equal(g.accuracy,
                                      g.accuracy_per_round[ROUNDS - 1])


@pytest.fixture(scope="module", params=["splitme", "oranfed", "fedavg"])
def f32_runs(request, data):
    return request.param, _pair(request.param, data)


def test_sweep_matches_jax(f32_runs, data):
    """SplitMe, O-RANFed (the reference's own sweep test) and FedAvg over
    three bandwidths: schedules and system metrics exactly, params and
    losses at 1e-5 of scale, accuracy per round within one test sample,
    one host transfer for the sweep."""
    fw, (want, got, transfers) = f32_runs
    assert transfers == 1
    assert got[0].graphs is None                # the CPU runs no graphs
    _assert_sweep_matches(want, got, F32_TOL, len(data[1][1]))


def test_sweep_variants_differ(f32_runs):
    """The bandwidths move SplitMe's and O-RANFed's cohorts (and SplitMe's
    E), so the pairs do train their own cohorts in one round."""
    fw, (_, got, _) = f32_runs
    cohorts = {tuple(map(tuple, r.schedule.a)) for r in got}
    if fw == "fedavg":              # K random clients, whatever the B
        assert len(cohorts) == 1
        return
    assert len(cohorts) == len(BANDWIDTHS)
    if fw == "splitme":
        assert len({tuple(r.schedule.E) for r in got}) > 1


@pytest.mark.parametrize("case", ["bf16", "int8", "straggler"])
def test_sweep_variants_match_jax(data, case):
    """SplitMe under the bf16 precision (1e-3); FedAvg on the int8 wire,
    a scale and an error-feedback state per (variant, seed) pair (6e-2);
    SplitMe under ``straggler:0.4`` (1e-5)."""
    if case == "bf16":
        want, got, transfers = _pair(
            "splitme", data, jkw=dict(policy=JKernelPolicy(precision=JBF16)),
            tkw=dict(policy=KernelPolicy(precision=BF16)))
        tol = BF16_TOL
    elif case == "int8":
        want, got, transfers = _pair("fedavg", data, quant="int8")
        for r in got:
            leaves = quantcomm.tree_leaves(r.qstate)
            assert leaves and all(l.shape[0] == len(SEEDS) for l in leaves)
        tol = INT8_TOL
    else:
        want, got, transfers = _pair("splitme", data,
                                     scenario="straggler:0.4")
        assert got[0].schedule.trace is not None
        tol = F32_TOL
    assert transfers == 1
    _assert_sweep_matches(want, got, tol, len(data[1][1]))


@pytest.mark.parametrize("fw", ["splitme", "oranfed"])
def test_sweep_matches_its_per_variant_campaigns(data, fw):
    """The vmapped sweep against ``vmap_configs=False`` on the same draws
    (a table both read at their own E buckets), at the reference test's
    bounds: losses 1e-5, accuracy 1e-6, comm_bits exactly, params 2e-3."""
    cd, test = data
    init = jax_initial_params(fw, JCFG, SEEDS)
    table = CampaignIndexDraws(SEEDS, ROUNDS, M, B, N,
                               e_max=SystemParams().E_max,
                               n_phases=_n_phases(fw))
    runs = [campaign.run_config_sweep(
        fw, CFG, _variants(SystemParams), cd, test_data=test, device="cpu",
        params=init, index_source=table, vmap_configs=vmap, **SWEEP)
        for vmap in (True, False)]
    sweep, serial = runs
    assert len(sweep) == len(serial) == len(BANDWIDTHS)
    for s, c in zip(sweep, serial):
        np.testing.assert_allclose(s.losses, c.losses, atol=1e-5, rtol=0)
        np.testing.assert_allclose(s.accuracy, c.accuracy, atol=1e-6)
        for r in range(ROUNDS):
            assert s.metrics[r].comm_bits == c.metrics[r].comm_bits
        for i in range(len(SEEDS)):
            for g, w in zip(s.params_for(i), c.params_for(i)):
                for gp, wp in zip(g, w):
                    for k in gp:
                        torch.testing.assert_close(gp[k], wp[k], rtol=0,
                                                   atol=2e-3)


@pytest.mark.parametrize("fw,quant", [("splitme", None), ("oranfed", None),
                                      ("fedavg", "int8")])
def test_sweep_matches_its_per_variant_campaigns_on_default_draws(data, fw,
                                                                  quant):
    """The same on the default draws (each seed's generator, no
    ``index_source``, no ``params``): every (variant, seed) pair draws as
    its variant's ``run_campaign`` does, at the variant's own E buckets,
    so the two modes read the same batches, as the reference's do
    (tests/test_campaign.py's bounds: losses 1e-5, accuracy 1e-6, comm_bits
    exactly, params 2e-3)."""
    cd, test = data
    runs = [campaign.run_config_sweep(
        fw, CFG, _variants(SystemParams), cd, test_data=test, device="cpu",
        quant=quant, vmap_configs=vmap, **SWEEP) for vmap in (True, False)]
    sweep, serial = runs
    if fw == "splitme":        # the variants' E buckets differ
        assert len({tuple(r.schedule.E) for r in serial}) > 1
    for s, c in zip(sweep, serial):
        np.testing.assert_allclose(s.losses, c.losses, atol=1e-5, rtol=0)
        np.testing.assert_allclose(s.accuracy_per_round,
                                   c.accuracy_per_round, atol=1e-6)
        assert [m.comm_bits for m in s.metrics] == [m.comm_bits
                                                    for m in c.metrics]
        for a, b in zip(quantcomm.tree_leaves((s.params, s.qstate)),
                        quantcomm.tree_leaves((c.params, c.qstate))):
            torch.testing.assert_close(a, b, rtol=0, atol=2e-3)


@pytest.mark.parametrize("fw,quant", [("splitme", None), ("fedavg", "int8")])
def test_one_variant_sweep_equals_run_campaign(data, fw, quant):
    """A sweep of one variant is that variant's campaign: the same round
    shapes and, with the default generators, the same draws (1e-5 losses,
    1e-6 accuracy, comm_bits exactly, 2e-3 params)."""
    cd, test = data
    kw = dict(SWEEP, test_data=test, device="cpu", quant=quant)
    (s,) = campaign.run_config_sweep(fw, CFG, _variants(SystemParams)[:1],
                                     cd, **kw)
    c = campaign.run_campaign(fw, CFG, _variants(SystemParams)[0], cd, **kw)
    np.testing.assert_array_equal(s.schedule.a, c.schedule.a)
    np.testing.assert_allclose(s.losses, c.losses, atol=1e-5, rtol=0)
    np.testing.assert_allclose(s.accuracy_per_round, c.accuracy_per_round,
                               atol=1e-6)
    assert [m.comm_bits for m in s.metrics] == [m.comm_bits
                                                for m in c.metrics]
    for a, b in zip(quantcomm.tree_leaves((s.params, s.qstate)),
                    quantcomm.tree_leaves((c.params, c.qstate))):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-3)


def test_one_host_fetch_per_sweep(data, monkeypatch):
    cd, test = data
    calls = []
    real = campaign._host_fetch
    monkeypatch.setattr(campaign, "_host_fetch",
                        lambda tree: (calls.append(1), real(tree))[1])
    res = campaign.run_config_sweep("splitme", CFG, _variants(SystemParams),
                                    cd, test_data=test, device="cpu",
                                    strict_transfers=True, **SWEEP)
    assert len(calls) == 1
    assert all(np.isfinite(r.losses).all() for r in res)
    assert all(r.accuracy.shape == (len(SEEDS),) for r in res)


@pytest.mark.parametrize("variants,kw,err,match", [
    ("unequal_m", {}, ValueError, "M=12"),
    ("same", dict(scenario="faults:0.3"), ValueError, "fault"),
    ("same", dict(mesh=object()), ValueError, "vmap_configs=False"),
    ("same", dict(mesh=object(), vmap_configs=False), TypeError,
     "DeviceMesh"),
])
def test_sweep_raises_as_the_reference(data, variants, kw, err, match):
    """Unequal M, a fault scenario and ``mesh=`` under the vmapped sweep
    raise the reference's ValueErrors; ``mesh=`` on the per-variant path
    reaches ``run_campaign``, which takes a DeviceMesh only (its sharded
    campaigns: tests/test_torch_sharded.py)."""
    cd, _ = data
    sps = _variants(SystemParams)
    if variants == "unequal_m":
        sps = sps[:1] + [SystemParams(M=M - 2, seed=0)]
    with pytest.raises(err, match=match):
        campaign.run_config_sweep("splitme", CFG, sps, cd, rounds=1,
                                  seeds=(0,), device="cpu", **kw)


# ---------------------------------------------------------------------------
# the gathered round with a cohort per pair
# ---------------------------------------------------------------------------

RM, RN, RB, R_EMAX, R_KB = 8, 16, 8, 4, 4
R_SEEDS, R_COHORTS = 2, (([1, 4, 6], 3), ([0, 7], 1), ([], 4))


def _stack(inits):
    return tuple([{k: torch.stack([ps[i][l][k] for ps in inits])
                   for k in inits[0][i][l]}
                  for l in range(len(inits[0][i]))]
                 for i in range(len(inits[0])))


def _round_setup(fw, quant=None):
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(RM, RN, 30)).astype(np.float32))
    y = torch.tensor(rng.integers(0, 3, (RM, RN)))
    spec = engine.make_spec(fw, CFG, batch_size=RB, masked_loss_metric=True,
                            quant=quant, device="cpu")
    fn = engine.build_round_fn(spec, CFG, x, y, e_max=R_EMAX, gather=True)
    inits = [spec.init_fn(torch.Generator().manual_seed(s), "cpu")
             for s in range(R_SEEDS)]
    idx = torch.randint(0, RN, (R_SEEDS, len(spec.phases), RM, R_EMAX, RB),
                        generator=torch.Generator().manual_seed(5))
    u = None
    if quant == "int8":
        n = quantcomm.n_elements(engine.trained_params(spec, _stack(inits)),
                                 1)
        u = torch.rand(R_SEEDS, n, generator=torch.Generator().manual_seed(9))
    sel = np.zeros((len(R_COHORTS), R_KB), np.int64)
    mask = np.zeros((len(R_COHORTS), R_KB), np.float32)
    for v, (c, _) in enumerate(R_COHORTS):
        sel[v, :len(c)], mask[v, :len(c)] = c, 1.0
    es = [e for _, e in R_COHORTS]
    return spec, fn, inits, idx, u, sel, mask, es


@pytest.mark.parametrize("fw,quant", [
    ("splitme", None), ("fedavg", None), ("splitme", "bf16"),
    ("fedavg", "int8")],
    ids=["splitme", "fedavg", "splitme-bf16wire", "fedavg-int8"])
def test_paired_round_equals_one_shared_round_per_pair(fw, quant):
    """Three variants' cohorts (three clients at E 3, two at E 1, an empty
    one at E 4) over two seeds, variant-major: each pair's params, losses
    and error-feedback state equal its own shared-cohort round
    at 1e-6; the empty cohort aggregates zeros, as the reference's does."""
    spec, fn, inits, idx, u, sel, mask, es = _round_setup(fw, quant)
    V, S = len(R_COHORTS), R_SEEDS
    params = _stack(inits * V)
    got = fn(params, torch.from_numpy(np.repeat(sel, S, 0)),
             torch.from_numpy(np.repeat(mask, S, 0)),
             torch.tensor(np.repeat(es, S)), idx,
             engine.init_quant_state(spec, params), u)
    for v in range(V):
        one = _stack(inits)
        want = fn(one, torch.from_numpy(sel[v]), torch.from_numpy(mask[v]),
                  es[v], idx, engine.init_quant_state(spec, one), u)
        part = slice(v * S, (v + 1) * S)
        for g, w in zip(quantcomm.tree_leaves(got), quantcomm.tree_leaves(
                want)):
            torch.testing.assert_close(g[part], w, rtol=0, atol=1e-6)
    empty = slice((V - 1) * S, V * S)
    for p in got[0]:
        for layer in p:
            for v in layer.values():
                assert not v[empty].any()


def test_paired_round_checks_its_arguments():
    spec, fn, inits, idx, u, sel, mask, es = _round_setup("splitme")
    S = R_SEEDS
    params = _stack(inits * 3)
    sel_p = torch.from_numpy(np.repeat(sel, S, 0))
    mask_p = torch.from_numpy(np.repeat(mask, S, 0))
    with pytest.raises(ValueError, match="e_steps"):      # E not per pair
        fn(params, sel_p, mask_p, 3, idx)
    with pytest.raises(ValueError, match="pairs"):        # params per seed
        fn(_stack(inits), sel_p, mask_p, torch.tensor(np.repeat(es, S)), idx)
    with pytest.raises(ValueError, match="sel_mask"):
        fn(params, sel_p, mask_p[:, :1], torch.tensor(np.repeat(es, S)), idx)


@pytest.mark.parametrize("option", ["with_faults", "guards"])
def test_paired_round_takes_no_faults_or_guards(option):
    """The sweep's round has no fault channels and no guards (the
    reference's sweep has neither): pairs of their own cohorts raise."""
    spec, _, inits, idx, _, sel, mask, es = _round_setup("splitme")
    S = R_SEEDS
    x, y = torch.zeros(RM, RN, 30), torch.zeros(RM, RN, dtype=torch.int64)
    fn = engine.build_round_fn(
        spec, CFG, x, y, e_max=R_EMAX, gather=True,
        **({"with_faults": True} if option == "with_faults"
           else {"guards": RoundGuards()}))
    with pytest.raises(ValueError, match="fault channels and no guards"):
        fn(_stack(inits * 3), torch.from_numpy(np.repeat(sel, S, 0)),
           torch.from_numpy(np.repeat(mask, S, 0)),
           torch.tensor(np.repeat(es, S)), idx)
