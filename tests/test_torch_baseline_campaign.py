"""The port's campaign (``repro_torch.launch.campaign.run_campaign``) for the
five baseline frameworks against the JAX package's on the CPU, and against
the port's own serial trainers.

Same inputs go through both packages: the reference's small_data (DNN10,
M 12, 32 samples a client), 3 rounds, seeds 0 and 1, E 3, the JAX
campaign's own initial parameters (``vmap(spec.init_fn)`` over
``PRNGKey(seed + 1)``) and its batches, replayed from its key chains
(``torch_parity.CampaignIndexReplay``, one phase).  The JAX side runs once
per framework.  Bounds: the schedule and system metrics exactly; params and
losses at 1e-5 (the JAX package's own f32 bound); per-round accuracy within
one test sample; the port's graphed (here: the same bodies run eagerly) and
eager modes bit for bit; a campaign's seed against the serial trainer with
that seed at 1e-5 (a gathered cohort against the full masked round).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.splitme_dnn import DNN10 as JDNN10
from repro.core import engine as jengine
from repro.core.cost import SystemParams as JSystemParams
from repro.launch import campaign as jcampaign
from repro_torch.configs.splitme_dnn import DNN10
from repro_torch.core import baselines
from repro_torch.core.cost import SystemParams
from repro_torch.data import oran
from repro_torch.launch import campaign
from torch_parity import (CampaignIndexReplay, TrainerIndexReplay,
                          assert_params_close, one_torch_thread)

SEEDS = (0, 1)
ROUNDS = 3
M_C, N_C, B_C = 12, 32, 32
KE = {"fedavg": {"K": 10, "E": 3}, "sfl": {"K": 20, "E": 3},
      "oranfed": {"E": 3}, "fedora": {"E": 3}, "ecofl": {"K": 10, "E": 3}}
TRAINERS = {"fedavg": baselines.FedAvgTrainer, "sfl": baselines.SFLTrainer,
            "oranfed": baselines.ORANFedTrainer,
            "fedora": baselines.FedORATrainer,
            "ecofl": baselines.EcoFLTrainer}
METRICS = ("round", "n_selected", "E", "comm_bits", "sim_time", "cost",
           "energy")


@pytest.fixture(scope="module")
def campaign_data():
    X, y = oran.generate(n_per_class=300, seed=0)
    (Xtr, ytr), test = oran.train_test_split(X, y)
    cd = oran.partition_non_iid(Xtr, ytr, M_C, samples_per_client=N_C,
                                seed=0)
    return cd, test


def _jax_initial_params(name, seeds):
    """The JAX campaign's initial params: PRNGKey(seed + init_key_offset)."""
    jspec = jengine.make_spec(name, JDNN10)
    init = jax.device_get(jax.vmap(jspec.init_fn)(jnp.stack(
        [jax.random.PRNGKey(s + jspec.init_key_offset) for s in seeds])))
    return [tuple([{k: v[i] for k, v in layer.items()} for layer in half]
                  for half in init) for i in range(len(seeds))]


@pytest.fixture(scope="module", params=list(KE))
def campaigns(request, campaign_data):
    name = request.param
    cd, test = campaign_data
    kw = dict(rounds=ROUNDS, seeds=SEEDS, test_data=test, **KE[name])
    want = jcampaign.run_campaign(name, JDNN10, JSystemParams(M=M_C, seed=0),
                                  cd, eval_every=2, **kw)
    runs = {scan: campaign.run_campaign(
        name, DNN10, SystemParams(M=M_C, seed=0), cd, scan=scan,
        eval_every=2 if scan else None, device="cpu",
        params=_jax_initial_params(name, SEEDS),
        index_source=CampaignIndexReplay(SEEDS, M_C, B_C, N_C, n_phases=1),
        **kw) for scan in (True, False)}
    return name, want, runs


def test_campaign_schedule_and_metrics_match_exactly(campaigns):
    name, want, runs = campaigns
    for got in runs.values():
        assert got.framework == name
        np.testing.assert_array_equal(got.schedule.a, want.schedule.a)
        np.testing.assert_array_equal(got.schedule.b, want.schedule.b)
        np.testing.assert_array_equal(got.schedule.E, want.schedule.E)
        for mg, mw in zip(got.metrics, want.metrics):
            for f in METRICS:
                assert getattr(mg, f) == getattr(mw, f), f
            assert np.isnan(mg.server_loss) and np.isnan(mw.server_loss)


@pytest.mark.parametrize("scan", [True, False])
def test_campaign_params_and_losses_match_jax(campaigns, scan):
    _, want, runs = campaigns
    got = runs[scan]
    assert got.losses.shape == want.losses.shape == (len(SEEDS), ROUNDS, 1)
    np.testing.assert_allclose(got.losses, want.losses, rtol=0, atol=1e-5)
    for i in range(len(SEEDS)):
        (g,), (w,) = got.params_for(i), want.params_for(i)
        assert_params_close(g, w, atol=1e-5)
    for mg, mw in zip(got.metrics, want.metrics):
        assert abs(mg.client_loss - mw.client_loss) <= 1e-5


def test_campaign_accuracy_within_one_test_sample(campaigns, campaign_data):
    _, want, runs = campaigns
    n_test = len(campaign_data[1][1])
    got = runs[True]
    assert got.accuracy_per_round.shape == (ROUNDS, len(SEEDS))
    assert np.isnan(got.accuracy_per_round[0]).all()
    np.testing.assert_allclose(got.accuracy_per_round[1:],
                               want.accuracy_per_round[1:], rtol=0,
                               atol=1.0 / n_test + 1e-6)
    for acc in (got.accuracy, runs[False].accuracy):
        np.testing.assert_allclose(acc, want.accuracy, rtol=0,
                                   atol=1.0 / n_test + 1e-6)


def test_scanned_campaign_equals_loop(campaigns):
    _, _, runs = campaigns
    np.testing.assert_array_equal(runs[True].losses, runs[False].losses)
    for i in range(len(SEEDS)):
        (g,), (w,) = runs[True].params_for(i), runs[False].params_for(i)
        for gp, wp in zip(g, w):
            assert all(torch.equal(gp[k], wp[k]) for k in gp)
    assert runs[True].qstate == runs[False].qstate == ()


def test_campaign_equals_its_serial_trainer(campaigns, campaign_data):
    """The port's trainer from the campaign's initial params and batches
    (the same replayed chain) is that seed of the campaign: losses and
    params at 1e-5, metrics exactly.  FedAvg's and SFL's random cohort is
    drawn from the campaign's policy seed, so their check runs at seed 0."""
    name, _, runs = campaigns
    cd, test = campaign_data
    res = runs[True]
    init = _jax_initial_params(name, SEEDS)
    seeds = (0,) if name in ("fedavg", "sfl") else SEEDS
    for i, s in enumerate(seeds):
        tr = TRAINERS[name](
            DNN10, SystemParams(M=M_C, seed=0), cd, test, seed=s,
            device="cpu", interactive=True, params=init[i],
            index_source=TrainerIndexReplay(s, M_C, KE[name]["E"], B_C, N_C,
                                            n_phases=1), **KE[name])
        serial = [tr.run_round().client_loss for _ in range(ROUNDS)]
        np.testing.assert_allclose(res.losses[i, :, 0], serial, atol=1e-5,
                                   rtol=0)
        (g,) = res.params_for(i)
        for gp, wp in zip(g, tr.params):
            for k in gp:
                torch.testing.assert_close(gp[k], wp[k], rtol=0, atol=1e-5)
        for r in range(ROUNDS):
            for f in METRICS:
                assert getattr(res.metrics[r], f) == getattr(tr.history[r],
                                                             f), f


def test_default_draws_campaign_equals_trainer(campaign_data):
    """With the default draws, seed s of a campaign is the trainer with
    ``seed=s``: one rule, the seed's generator draws the weights and then
    each round's batches.  Different seeds train different models."""
    cd, test = campaign_data
    res = campaign.run_campaign("fedora", DNN10, SystemParams(M=M_C, seed=0),
                                cd, rounds=2, seeds=SEEDS, device="cpu", E=3)
    for i, s in enumerate(SEEDS):
        tr = baselines.FedORATrainer(DNN10, SystemParams(M=M_C, seed=0), cd,
                                     test, seed=s, device="cpu", E=3,
                                     interactive=True)
        serial = [tr.run_round().client_loss for _ in range(2)]
        np.testing.assert_allclose(res.losses[i, :, 0], serial, atol=1e-5,
                                   rtol=0)
        (g,) = res.params_for(i)
        for gp, wp in zip(g, tr.params):
            for k in gp:
                torch.testing.assert_close(gp[k], wp[k], rtol=0, atol=1e-5)
    (p0,), (p1,) = res.params_for(0), res.params_for(1)
    assert any(not torch.equal(a[k], b[k]) for a, b in zip(p0, p1)
               for k in a)


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_quantized_baseline_campaign_modes_agree(campaign_data, quant):
    """O-RANFed's campaign under each wire format: graphed (eager bodies
    on the CPU) equals the loop bit for bit, the EF state included."""
    cd, _ = campaign_data
    runs = [campaign.run_campaign("oranfed", DNN10,
                                  SystemParams(M=M_C, seed=0), cd,
                                  rounds=2, seeds=SEEDS, device="cpu",
                                  quant=quant, scan=scan, E=2)
            for scan in (True, False)]
    np.testing.assert_array_equal(runs[0].losses, runs[1].losses)
    q = [[v for p in (r.qstate or {}).values() for l in p
          for v in l.values()] for r in runs]
    assert len(q[0]) == (20 if quant == "int8" else 0)
    assert all(torch.equal(a, b) for a, b in zip(*q))
    assert all(v.shape[0] == len(SEEDS) for v in q[0])
