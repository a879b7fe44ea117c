"""The port's multi-seed SplitMe campaign (``repro_torch.launch.campaign``)
and the engine's gathered round against the JAX package on the CPU.

Same inputs go through both packages: the campaign fixture of
tests/test_campaign.py (DNN10, M 12, 32 samples per client, 3 rounds,
seeds 0 and 1), the JAX campaign's own initial parameters
(``vmap(spec.init_fn)`` over ``PRNGKey(seed)``) and its batches, replayed
from its key chains (``torch_parity.CampaignIndexReplay``).  Bounds: exact
for the host-side numpy copies (schedules, buckets, segments, system
metrics), 1e-6 for the gathered round against the port's own full masked
round, 1e-5 for params and losses against JAX (the JAX package's own f32
parity bound), and one test sample for the per-round accuracy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.splitme_dnn import DNN10 as JDNN10
from repro.configs.splitme_dnn import DNNConfig as JDNNConfig
from repro.core import cost as jcost
from repro.core import engine as jengine
from repro.core.cost import SystemParams as JSystemParams
from repro.launch import campaign as jcampaign
from repro_torch.configs.splitme_dnn import DNN10, DNNConfig
from repro_torch.core import cost, engine
from repro_torch.core.cost import SystemParams
from repro_torch.data import oran
from repro_torch.launch import campaign
from torch_parity import (CampaignIndexReplay, assert_params_close,
                          jax_to_torch, one_torch_thread,
                          replay_round_indices)

SEEDS = (0, 1)
ROUNDS = 3
M_C, N_C, B_C = 12, 32, 32

HIDDEN = (32, 32, 16, 16, 8)
CFG = DNNConfig(hidden=HIDDEN)
JCFG = JDNNConfig(hidden=HIDDEN)
M, N, B, E_MAX = 8, 16, 8, 4


def _t(a):
    return torch.tensor(np.asarray(a))


def _stack(inits):
    """Params tuples of several seeds, each leaf stacked on a seed axis."""
    return tuple([{k: torch.stack([ps[i][l][k] for ps in inits])
                   for k in inits[0][i][l]}
                  for l in range(len(inits[0][i]))]
                 for i in range(len(inits[0])))


# ---------------------------------------------------------------------------
# host plan: exactly the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def paper_schedules():
    """The paper's 30-round SplitMe schedule (M 50, E_max 20, 96 samples a
    client) from both packages."""
    got = campaign.plan_schedule("splitme", SystemParams(), DNN10, 30,
                                 n_samples_per_client=96)
    want = jcampaign.plan_schedule("splitme", JSystemParams(), JDNN10, 30,
                                   n_samples_per_client=96)
    return got, want


def test_plan_schedule_matches_reference(paper_schedules):
    (sp, sched), (jsp, jsched) = paper_schedules
    np.testing.assert_array_equal(sched.a, jsched.a)
    np.testing.assert_array_equal(sched.b, jsched.b)
    np.testing.assert_array_equal(sched.E, jsched.E)
    assert sched.E.dtype == jsched.E.dtype
    assert sched.rounds == jsched.rounds == 30
    assert sched.trace is None and jsched.trace is None
    np.testing.assert_array_equal(sp.S_m, jsp.S_m)
    assert (sp.omega, sp.d_model_bits) == (jsp.omega, jsp.d_model_bits)


def test_paper_schedule_buckets_and_segments_match(paper_schedules):
    """Power-of-two cohort buckets (more than 8 distinct cohort sizes),
    exact E buckets: the paper's four round shapes."""
    (sp, sched), (jsp, jsched) = paper_schedules
    counts = sched.a.sum(axis=1).astype(int)
    size_of = campaign._bucket_cohorts(counts, sp.M)
    assert size_of == jcampaign._bucket_cohorts(counts, jsp.M)
    e_of = campaign._bucket_cohorts(sched.E, sp.E_max)
    assert e_of == jcampaign._bucket_cohorts(jsched.E, jsp.E_max)
    kb_r = [size_of[int(c)] for c in counts]
    eb_r = [e_of[int(e)] for e in sched.E]
    segs = campaign._plan_segments(kb_r, eb_r)
    assert segs == jcampaign._plan_segments(kb_r, eb_r)
    assert segs == [(1, 20, 0, 3), (16, 9, 3, 1), (50, 6, 4, 1),
                    (32, 6, 5, 25)]
    assert campaign._round_shapes(sched, sp) == (kb_r, eb_r)
    for every in (None, 4, 10):
        assert (campaign._split_at_checkpoints(segs, every)
                == jcampaign._split_at_checkpoints(segs, every))


@pytest.mark.parametrize("seed", range(4))
def test_bucket_cohorts_matches_reference_on_random_values(seed):
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(9, 200))
    for n_vals in (3, 8, 9, 40):
        vals = rng.integers(1, cap + 1, n_vals)
        assert (campaign._bucket_cohorts(vals, cap)
                == jcampaign._bucket_cohorts(vals, cap))
    lens = rng.integers(1, 30, 12)
    kb_r = rng.choice([1, 4, 8], 20).tolist()
    eb_r = rng.choice([6, 20], 20).tolist()
    assert (campaign._plan_segments(kb_r, eb_r)
            == jcampaign._plan_segments(kb_r, eb_r))
    segs = campaign._plan_segments(kb_r, eb_r)
    every = int(lens[0])
    assert (campaign._split_at_checkpoints(segs, every)
            == jcampaign._split_at_checkpoints(segs, every))


@pytest.mark.parametrize("M_,t_lo,rounds", [(50, 50e-3, 30), (12, 20e-3, 9),
                                            (20, 30e-3, 12)])
def test_schedule_metrics_and_system_metrics_match_reference(M_, t_lo,
                                                             rounds):
    """``cost.schedule_metrics`` (trace None), the campaign's vectorized
    comm/latency/cost/energy and ``_make_metrics`` equal the reference, on
    schedules with partial cohorts."""
    rng = np.random.default_rng(M_)
    t_round = rng.uniform(t_lo, 100e-3, M_)
    sp, sched = campaign.plan_schedule(
        "splitme", SystemParams(M=M_, seed=2, t_round=t_round.copy()), DNN10,
        rounds, n_samples_per_client=64)
    jsp, jsched = jcampaign.plan_schedule(
        "splitme", JSystemParams(M=M_, seed=2, t_round=t_round.copy()),
        JDNN10, rounds, n_samples_per_client=64)
    np.testing.assert_array_equal(sched.a, jsched.a)
    got = cost.schedule_metrics(sched.a, sched.b, sched.E, sp)
    want = jcost.schedule_metrics(jsched.a, jsched.b, jsched.E, jsp)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for r in range(rounds):          # and the per-round scalar forms
        a, b, e = sched.a[r], sched.b[r], int(sched.E[r])
        assert got[0][r] == cost.total_time(a, b, e, sp)
        np.testing.assert_allclose(got[1][r], cost.round_cost(a, b, e, sp),
                                   rtol=1e-12)
        np.testing.assert_allclose(got[2][r],
                                   cost.round_energy(a, b, e, sp),
                                   rtol=1e-12)
    spec = engine.make_spec("splitme", DNN10, masked_loss_metric=True)
    jspec = jengine.make_spec("splitme", JDNN10, masked_loss_metric=True)
    sysm = campaign._schedule_system_metrics(spec, sched, sp)
    jsysm = jcampaign._schedule_system_metrics(jspec, jsched, jsp)
    for g, w in zip(sysm, jsysm):
        np.testing.assert_array_equal(g, w)
    losses = np.random.default_rng(1).normal(size=(2, rounds, 2))
    acc = np.full((rounds, 2), np.nan)
    acc[rounds - 1] = (0.5, 0.75)
    for mg, mw in zip(campaign._make_metrics(sched, *sysm, losses, acc),
                      jcampaign._make_metrics(jsched, *jsysm, losses, acc)):
        for f in ("round", "n_selected", "E", "comm_bits", "sim_time",
                  "cost", "energy", "client_loss", "server_loss"):
            assert getattr(mg, f) == getattr(mw, f), f
        assert (mg.accuracy == mw.accuracy
                or (np.isnan(mg.accuracy) and np.isnan(mw.accuracy)))


def test_schedule_metrics_scenario_trace_raises():
    """Traces are ported (tests/test_torch_scenario.py pins their metrics);
    one that does not fit the schedule, or that is no trace, raises in the
    port as in the reference."""
    from repro.core import scenario as jscenario
    from repro_torch.core import scenario
    z = np.zeros((2, 4))
    for scen_mod, cost_mod, sp in ((scenario, cost, SystemParams(M=4)),
                                   (jscenario, jcost, JSystemParams(M=4))):
        with pytest.raises(ValueError):
            cost_mod.schedule_metrics(z, z, np.ones(2), sp,
                                      trace=scen_mod.make_trace("fading", 2,
                                                                5))
        with pytest.raises(AttributeError):
            cost_mod.schedule_metrics(z, z, np.ones(2), sp, trace=object())


# ---------------------------------------------------------------------------
# the gathered round
# ---------------------------------------------------------------------------

def _round_data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(M, N, 30)).astype(np.float32)
    y = rng.integers(0, 3, (M, N)).astype(np.int32)
    return x, y


def _cohort(selected, kb):
    idx = np.zeros(kb, np.int64)
    idx[:len(selected)] = selected
    mask = np.zeros(kb, np.float32)
    mask[:len(selected)] = 1.0
    return idx, mask


# (selected clients, cohort bucket, E): a cohort of 1, padded slots, every
# client, and a masked tail (E < e_max)
COHORTS = [([5], 1, E_MAX), ([1, 2, 6], 4, 3), (list(range(M)), M, E_MAX),
           ([0, 7], 4, 1)]


@pytest.mark.parametrize("selected,kb,e_steps", COHORTS)
@pytest.mark.parametrize("e_as_tensor", [False, True])
def test_gathered_round_equals_full_masked_round(selected, kb, e_steps,
                                                 e_as_tensor):
    x, y = _round_data()
    spec = engine.make_spec("splitme", CFG, batch_size=B,
                            masked_loss_metric=True)
    full = engine.build_round_fn(spec, CFG, _t(x), _t(y), e_max=E_MAX)
    gath = engine.build_round_fn(spec, CFG, _t(x), _t(y), e_max=E_MAX,
                                 gather=True)
    params = spec.init_fn(torch.Generator().manual_seed(3), "cpu")
    idx = torch.randint(0, N, (2, M, E_MAX, B),
                        generator=torch.Generator().manual_seed(4))
    a = np.zeros(M, np.float32)
    a[selected] = 1.0
    want, wl, _ = full(params, _t(a), e_steps, idx)
    sel, mask = _cohort(selected, kb)
    e = torch.tensor(e_steps) if e_as_tensor else e_steps
    got, gl, _ = gath(_stack([params]), _t(sel), _t(mask), e, idx[None])
    for g, w in zip(got, want):
        for gp, wp in zip(g, w):
            for k in gp:
                torch.testing.assert_close(gp[k][0], wp[k], rtol=0,
                                           atol=1e-6)
    for g, w in zip(gl, wl):
        assert g.shape == (1,) and abs(g.item() - w.item()) <= 1e-6


@pytest.mark.parametrize("selected,kb,e_steps", COHORTS)
def test_gathered_round_matches_jax_gathered_round(selected, kb, e_steps):
    x, y = _round_data()
    jspec = jengine.make_spec("splitme", JCFG, policy="reference",
                              batch_size=B, masked_loss_metric=True)
    jround = jengine.build_round_fn(jspec, JCFG, jnp.asarray(x),
                                    jnp.asarray(y), e_max=E_MAX,
                                    donate=False, gather=True)
    key = jax.random.PRNGKey(7)
    init = jspec.init_fn(jax.random.PRNGKey(2))
    sel, mask = _cohort(selected, kb)
    (jc, js), (jcl, jsl), _ = jround(init, jnp.asarray(sel, jnp.int32),
                                     jnp.asarray(mask),
                                     jnp.asarray(e_steps), key, ())
    spec = engine.make_spec("splitme", CFG, batch_size=B,
                            masked_loss_metric=True)
    gath = engine.build_round_fn(spec, CFG, _t(x), _t(y), e_max=E_MAX,
                                 gather=True)
    idx = _t(replay_round_indices(key, 2, M, E_MAX, B, N))
    (c, s), (cl, sl), _ = gath(
        _stack([(jax_to_torch(init[0]), jax_to_torch(init[1]))]),
        _t(sel), _t(mask), e_steps, idx[None])
    assert_params_close([{k: v[0] for k, v in p.items()} for p in c], jc,
                        atol=1e-5)
    assert_params_close([{k: v[0] for k, v in p.items()} for p in s], js,
                        atol=1e-5)
    assert abs(cl.item() - float(jcl)) <= 1e-5
    assert abs(sl.item() - float(jsl)) <= 1e-5


def test_seed_stacked_round_equals_one_round_per_seed():
    """Three seeds folded into one client axis give each seed's own
    gathered round."""
    x, y = _round_data()
    spec = engine.make_spec("splitme", CFG, batch_size=B,
                            masked_loss_metric=True)
    gath = engine.build_round_fn(spec, CFG, _t(x), _t(y), e_max=E_MAX,
                                 gather=True)
    inits = [spec.init_fn(torch.Generator().manual_seed(s), "cpu")
             for s in range(3)]
    idx = torch.randint(0, N, (3, 2, M, E_MAX, B),
                        generator=torch.Generator().manual_seed(5))
    sel, mask = _cohort([1, 4, 6], 4)
    got, gl, _ = gath(_stack(inits), _t(sel), _t(mask), 3, idx)
    for s in range(3):
        want, wl, _ = gath(_stack(inits[s:s + 1]), _t(sel), _t(mask), 3,
                        idx[s:s + 1])
        for g, w in zip(got, want):
            for gp, wp in zip(g, w):
                for k in gp:
                    torch.testing.assert_close(gp[k][s], wp[k][0], rtol=0,
                                               atol=1e-6)
        for g, w in zip(gl, wl):
            assert abs(g[s].item() - w.item()) <= 1e-6


def test_gathered_round_checks_shapes():
    x, y = _round_data()
    spec = engine.make_spec("splitme", CFG, batch_size=B)
    gath = engine.build_round_fn(spec, CFG, _t(x), _t(y), e_max=2,
                                 gather=True)
    params = _stack([spec.init_fn(torch.Generator().manual_seed(0), "cpu")])
    sel, mask = _cohort([1], 2)
    with pytest.raises(ValueError, match="indices"):
        gath(params, _t(sel), _t(mask), 2,
             torch.zeros(2, M, 2, B, dtype=torch.int64))
    with pytest.raises(ValueError, match="sel_idx"):
        gath(params, _t(sel).int(), _t(mask), 2,
             torch.zeros(2, 2, M, 2, B, dtype=torch.int64))
    with pytest.raises(ValueError, match="sel_mask"):
        gath(params, _t(sel), _t(mask)[:1], 2,
             torch.zeros(1, 2, M, 2, B, dtype=torch.int64))


# ---------------------------------------------------------------------------
# run_campaign against the JAX run_campaign
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def campaign_data():
    X, y = oran.generate(n_per_class=300, seed=0)
    (Xtr, ytr), test = oran.train_test_split(X, y)
    cd = oran.partition_non_iid(Xtr, ytr, M_C, samples_per_client=N_C,
                                seed=0)
    return cd, test


def _jax_initial_params(seeds):
    jspec = jengine.make_spec("splitme", JDNN10)
    init = jax.device_get(jax.vmap(jspec.init_fn)(
        jnp.stack([jax.random.PRNGKey(s) for s in seeds])))
    return [tuple([{k: v[i] for k, v in layer.items()} for layer in half]
                  for half in init) for i in range(len(seeds))]


# eval at γ = 10: at the production γ = 1e-3 this small model's f32 ridge
# is ill-conditioned (tests/test_torch_splitme.py), so two correct solves
# of the same Grams can classify differently
CAMPAIGN_KW = dict(rounds=ROUNDS, seeds=SEEDS, eval_gamma=10.0)


@pytest.fixture(scope="module")
def campaigns(campaign_data):
    cd, test = campaign_data
    want = jcampaign.run_campaign("splitme", JDNN10,
                                  JSystemParams(M=M_C, seed=0), cd,
                                  test_data=test, eval_every=2, **CAMPAIGN_KW)
    runs = {}
    for scan in (True, False):
        runs[scan] = campaign.run_campaign(
            "splitme", DNN10, SystemParams(M=M_C, seed=0), cd,
            test_data=test, eval_every=2 if scan else None, scan=scan,
            device="cpu", params=_jax_initial_params(SEEDS),
            index_source=CampaignIndexReplay(SEEDS, M_C, B_C, N_C),
            **CAMPAIGN_KW)
    return want, runs


def test_campaign_schedule_and_system_metrics_match_exactly(campaigns):
    want, runs = campaigns
    for got in runs.values():
        np.testing.assert_array_equal(got.schedule.a, want.schedule.a)
        np.testing.assert_array_equal(got.schedule.b, want.schedule.b)
        np.testing.assert_array_equal(got.schedule.E, want.schedule.E)
        for mg, mw in zip(got.metrics, want.metrics):
            for f in ("round", "n_selected", "E", "comm_bits", "sim_time",
                      "cost", "energy"):
                assert getattr(mg, f) == getattr(mw, f), f


@pytest.mark.parametrize("scan", [True, False])
def test_campaign_params_and_losses_match_jax(campaigns, scan):
    want, runs = campaigns
    got = runs[scan]
    assert got.losses.shape == want.losses.shape == (len(SEEDS), ROUNDS, 2)
    np.testing.assert_allclose(got.losses, want.losses, rtol=0, atol=1e-5)
    for i in range(len(SEEDS)):
        for g, w in zip(got.params_for(i), want.params_for(i)):
            assert_params_close(g, w, atol=1e-5)
        for r in range(ROUNDS):
            assert got.metrics[r].client_loss == pytest.approx(
                want.metrics[r].client_loss, abs=1e-5)


def test_campaign_accuracy_per_round_within_one_test_sample(campaigns,
                                                           campaign_data):
    want, runs = campaigns
    n_test = len(campaign_data[1][1])
    got = runs[True]
    assert got.accuracy_per_round.shape == (ROUNDS, len(SEEDS))
    assert np.isnan(got.accuracy_per_round[0]).all()          # no eval
    assert np.isnan(want.accuracy_per_round[0]).all()
    np.testing.assert_allclose(got.accuracy_per_round[1:],
                               want.accuracy_per_round[1:], rtol=0,
                               atol=1.0 / n_test + 1e-6)
    np.testing.assert_allclose(got.accuracy, want.accuracy, rtol=0,
                               atol=1.0 / n_test + 1e-6)
    # the loop's post-hoc evaluation of the same final params
    np.testing.assert_allclose(runs[False].accuracy, want.accuracy, rtol=0,
                               atol=1.0 / n_test + 1e-6)


def test_scanned_campaign_equals_loop(campaigns):
    _, runs = campaigns
    np.testing.assert_array_equal(runs[True].losses, runs[False].losses)
    for i in range(len(SEEDS)):
        for g, w in zip(runs[True].params_for(i), runs[False].params_for(i)):
            for gp, wp in zip(g, w):
                for k in gp:
                    assert torch.equal(gp[k], wp[k])


def test_host_fetch_once_per_scanned_campaign(campaign_data, monkeypatch):
    """Exactly one device→host transfer for the scanned campaign (also
    under strict_transfers, which has no effect on the CPU), and one per
    round for the loop."""
    cd, test = campaign_data
    calls = []
    real = campaign._host_fetch
    monkeypatch.setattr(campaign, "_host_fetch",
                        lambda tree: (calls.append(1), real(tree))[1])
    res = campaign.run_campaign(
        "splitme", DNN10, SystemParams(M=M_C, seed=0), cd, rounds=ROUNDS,
        seeds=(3,), test_data=test, strict_transfers=True, device="cpu")
    assert len(calls) == 1
    assert np.isfinite(res.losses).all()
    assert res.accuracy.shape == (1,)
    calls.clear()
    campaign.run_campaign("splitme", DNN10, SystemParams(M=M_C, seed=0), cd,
                          rounds=ROUNDS, seeds=(3,), scan=False,
                          device="cpu")
    assert len(calls) == ROUNDS


def test_default_campaign_is_seeded(campaign_data):
    """Each seed's own CPU generator: one seed, one run; seeds differ."""
    cd, _ = campaign_data
    runs = [campaign.run_campaign("splitme", DNN10,
                                  SystemParams(M=M_C, seed=0), cd, rounds=2,
                                  seeds=seeds, device="cpu")
            for seeds in ((4, 5), (4, 5))]
    np.testing.assert_array_equal(runs[0].losses, runs[1].losses)
    assert (runs[0].losses[0] != runs[0].losses[1]).any()


@pytest.mark.parametrize("kw,err,match", [
    (dict(mesh=object()), TypeError, "DeviceMesh"),
    (dict(scenario="faults:0.2", scan=False), ValueError, "scan=True"),
    (dict(guards=engine.RoundGuards(), scan=False), ValueError, "scan=True"),
    (dict(checkpoint_every=2), ValueError, "BOTH"),
    (dict(resume=True), ValueError, "BOTH"),
])
def test_unported_campaign_options_raise(campaign_data, kw, err, match):
    """``mesh=`` takes a torch.distributed DeviceMesh (the sharded
    campaign, tests/test_torch_sharded.py) and refuses anything else; the
    fault and checkpoint options raise the reference's own ValueErrors:
    faults or guards without the scan, checkpoints without a directory, a
    resume alone."""
    cd, _ = campaign_data
    with pytest.raises(err, match=match):
        campaign.run_campaign("splitme", DNN10, SystemParams(M=M_C, seed=0),
                              cd, rounds=1, seeds=(0,), device="cpu", **kw)


@pytest.mark.parametrize("framework,kw,err", [
    ("fedavg", dict(checkpoint_every=2, strict_transfers=True),
     ValueError),
    ("oranfed", dict(checkpoint_every=2, scan=False), ValueError),
    ("nope", {}, KeyError)])
def test_other_frameworks_raise(campaign_data, tmp_path, framework, kw,
                                err):
    """An unknown framework, and the baselines' checkpoints with
    ``strict_transfers`` or without the scan (the reference's
    ValueErrors)."""
    cd, _ = campaign_data
    if "checkpoint_every" in kw:
        kw = dict(kw, checkpoint_dir=tmp_path)
    with pytest.raises(err):
        campaign.run_campaign(framework, DNN10, SystemParams(M=M_C, seed=0),
                              cd, rounds=1, seeds=(0,), device="cpu", **kw)
    assert not list(tmp_path.iterdir())


def test_loop_rejects_eval_every_and_bad_indices(campaign_data):
    cd, _ = campaign_data
    with pytest.raises(ValueError, match="eval_every"):
        campaign.run_campaign("splitme", DNN10, SystemParams(M=M_C, seed=0),
                              cd, rounds=1, seeds=(0,), device="cpu",
                              scan=False, eval_every=1)
    with pytest.raises(ValueError, match="lie in"):
        campaign.run_campaign(
            "splitme", DNN10, SystemParams(M=M_C, seed=0), cd, rounds=1,
            seeds=(0,), device="cpu",
            index_source=lambda i, r, eb: torch.full((2, M_C, eb, B_C), N_C))
