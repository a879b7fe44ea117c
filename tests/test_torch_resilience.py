"""The port's fault channels and in-round guards (``engine.RoundGuards``,
the fault block of ``engine._round_core`` / ``_gathered_core``, the scanned
campaign's crash hold-round) against the JAX package on the CPU.

The size of tests/test_resilience.py: DNN 30→16→16→8→3 split after layer 1,
M 8 clients of 16 samples, seeds 0 and 1, K 4, E 3.  Both sides get the
JAX campaign's initial parameters and its batches (and int8 uniforms),
replayed from its key chains (``torch_parity``); each JAX campaign runs
once.

Bounds: the guard flags (``skipped``, ``quorum``, ``crashed``), the NaN
loss rows of the crash rounds and the schedules exactly; params at 1e-5 of
each leaf's largest magnitude (at least 1) and losses at 1e-5 of their
magnitude (at least 1), the JAX package's f32 bound for values of order 1.
Under ``faults:0.3`` an exponent flip multiplies a client's update by
±2^12 and no default guard clips it: FedAvg's params reach ~1e9 and its
SGD amplifies any last-bit difference, so its bound there is
``CHAOS_TOL`` = 1e-4 of scale, set from two readings: the port is 4.0e-5
of a leaf's magnitude from JAX, and 4.4e-5 from itself when every initial
weight moves one ulp up.  Every other
campaign here holds 1e-5 of scale, the unclipped one-round flip of every
client too (params ~3e12, 3.9e-6 apart).  The int8 wire holds
tests/test_torch_quantcomm.py's bound, 6e-2, likewise scaled.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.splitme_dnn import DNNConfig as JDNNConfig
from repro.core import baselines as jbaselines
from repro.core import engine as jengine
from repro.core import scenario as jscenario
from repro.core.cost import SystemParams as JSystemParams
from repro.core.splitme import SplitMeTrainer as JSplitMeTrainer
from repro.launch import campaign as jcampaign
from repro_torch.configs.splitme_dnn import DNNConfig
from repro_torch.core import baselines, engine, quantcomm, scenario
from repro_torch.core.cost import SystemParams
from repro_torch.core.engine import RoundGuards
from repro_torch.core.splitme import SplitMeTrainer
from repro_torch.data import oran
from repro_torch.launch import campaign
from torch_parity import (CampaignIndexReplay, CampaignUniformReplay,
                          TrainerIndexReplay, jax_initial_params,
                          one_torch_thread, replay_round_indices)

_CFG = dict(name="resilience-dnn", n_features=30, n_classes=3,
            hidden=(16, 16, 8), split_index=1)
CFG, JCFG = DNNConfig(**_CFG), JDNNConfig(**_CFG)
M, N, B = 8, 16, 32
SEEDS = (0, 1)
FLAGS = ("skipped_per_round", "quorum_per_round", "crashed_per_round")
INT8_TOL = 6e-2          # tests/test_torch_quantcomm.py's WIRE_TOL["int8"]
CHAOS_TOL = 1e-4         # FedAvg under faults:0.3 (module docstring)


@pytest.fixture(scope="module")
def clients():
    X, y = oran.generate(n_per_class=120, seed=0)
    (Xtr, ytr), test = oran.train_test_split(X, y)
    return oran.partition_non_iid(Xtr, ytr, M, samples_per_client=N, seed=0)


def _pair(name, clients, **kw):
    """The JAX campaign and the port's on the same draws (``kw`` to both),
    and the port's host transfers under strict_transfers."""
    kw = dict(dict(K=4, E=3, seeds=SEEDS), **kw)
    want = jcampaign.run_campaign(name, JCFG, JSystemParams(M=M, seed=0),
                                  clients, **kw)
    init = jax_initial_params(name, JCFG, SEEDS)

    n_ph = 2 if name == "splitme" else 1
    us = None
    if kw.get("quant") == "int8":
        one = init[0]
        us = CampaignUniformReplay(SEEDS, {i: one[i] for i in range(n_ph)})
    campaign.HOST_TRANSFERS = 0
    got = campaign.run_campaign(
        name, CFG, SystemParams(M=M, seed=0), clients, device="cpu",
        params=init, index_source=CampaignIndexReplay(SEEDS, M, B, N,
                                                      n_phases=n_ph),
        uniform_source=us, strict_transfers=True, **kw)
    return want, got, campaign.HOST_TRANSFERS


def _leaves(res):
    return [np.asarray(v) for v in quantcomm.tree_leaves(res.params)]


def _param_err(a, b):
    """Largest |a − b| of two campaigns' params over each leaf's largest
    magnitude (at least 1)."""
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               / max(1.0, float(np.abs(np.asarray(y)).max()))
               for x, y in zip(quantcomm.tree_leaves(a.params),
                               jax.tree.leaves(b.params)))


def _loss_err(a, b):
    """Largest |a − b| of two campaigns' losses over their magnitude (at
    least 1); the NaN rows must match."""
    np.testing.assert_array_equal(np.isnan(a.losses), np.isnan(b.losses))
    ok = ~np.isnan(b.losses)
    return float((np.abs(a.losses[ok] - b.losses[ok])
                  / np.maximum(1.0, np.abs(b.losses[ok]))).max(initial=0.0))


def _assert_matches(want, got, tol=1e-5):
    """Flags and metrics exactly, NaN crash rows; params and losses within
    ``tol`` of their scale."""
    for f in FLAGS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for mg, mw in zip(got.metrics, want.metrics):
        for f in ("n_selected", "E", "comm_bits", "sim_time", "cost",
                  "skipped", "quorum_held", "crashed"):
            assert getattr(mg, f) == getattr(mw, f), f
    assert _param_err(got, want) <= tol and _loss_err(got, want) <= tol


# ---------------------------------------------------------------------------
# guarded fault campaigns
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["splitme", "fedavg"])
def faults_runs(request, clients):
    name = request.param
    return name, _pair(name, clients, rounds=8, scenario="faults:0.3",
                       scenario_seed=1)


def test_guarded_fault_campaign_matches_jax(faults_runs):
    """``faults:0.3`` (scenario seed 1, 8 rounds): guards armed by the
    faults, one host transfer under strict_transfers, rollbacks counted,
    the flags exactly and the trajectory at the bound of the docstring."""
    name, (want, got, transfers) = faults_runs
    assert transfers == 1
    assert got.skipped_rounds == want.skipped_rounds > 0
    trace = scenario.get_trace("faults:0.3", 8, M, seed=1)
    assert got.crashed_rounds == int((trace.crash > 0).sum())
    for leaf in _leaves(got):
        assert np.isfinite(leaf).all()
    crashed = trace.crash > 0
    assert np.isnan(got.losses[:, crashed]).all()
    assert np.isfinite(got.losses[:, ~crashed]).all()
    assert sum(m.skipped for m in got.metrics) > 0
    # a wire flip makes FedAvg's trajectory chaotic (module docstring)
    _assert_matches(want, got, CHAOS_TOL if name == "fedavg" else 1e-5)


@pytest.mark.parametrize("name", ["sfl", "oranfed", "fedora", "ecofl"])
def test_other_frameworks_under_faults_match_jax(clients, name):
    want, got, transfers = _pair(name, clients, rounds=4,
                                    scenario="faults:0.3", scenario_seed=1)
    assert transfers == 1 and got.skipped_per_round is not None
    _assert_matches(want, got)


def test_crash_round_holds_as_the_reference(clients):
    """A trace whose round 2 crashes and rounds 2 and 3 poison every
    client: the crash round holds params (NaN loss row, counted once, its
    flags zeroed), the poisoned round 3 rolls back; both as the
    reference."""
    ones = np.ones((8, M))
    crash = np.zeros(8)
    crash[2] = 1.0
    poison = np.zeros((8, M))
    poison[2:4] = 1.0

    def trace(mod):
        return mod.ScenarioTrace(name="crash", seed=0, gain=ones,
                                 qc_scale=ones, qs_scale=ones, avail=ones,
                                 drop=ones, deadline_scale=ones,
                                 poison=poison, crash=crash,
                                 wire_gain=ones)
    # FedAvg's campaign of test_guarded_fault_campaign_matches_jax: the
    # same shapes, so JAX reuses that compile
    kw = dict(K=4, E=3, seeds=SEEDS, rounds=8)
    want = jcampaign.run_campaign("fedavg", JCFG, JSystemParams(M=M, seed=0),
                                  clients, scenario=trace(jscenario), **kw)
    got = campaign.run_campaign(
        "fedavg", CFG, SystemParams(M=M, seed=0), clients, device="cpu",
        scenario=trace(scenario),
        params=jax_initial_params("fedavg", JCFG, SEEDS),
        index_source=CampaignIndexReplay(SEEDS, M, B, N, n_phases=1), **kw)
    assert got.crashed_per_round.tolist() == [0, 0, 1, 0, 0, 0, 0, 0]
    assert np.isnan(got.losses[:, 2]).all()
    assert got.skipped_per_round[:, 0].tolist() == [0, 0, 0, 1, 0, 0, 0, 0]
    assert got.skipped_per_round[2].tolist() == [0, 0]
    _assert_matches(want, got)


def test_guards_off_control_diverges(clients):
    """The same poisoned campaign with the guards forced off lets NaN reach
    the aggregated params (and records no flags)."""
    res = campaign.run_campaign("splitme", CFG, SystemParams(M=M, seed=0),
                                clients, rounds=8, seeds=SEEDS, K=4, E=3,
                                scenario="faults:0.9", scenario_seed=3,
                                guards=False, device="cpu")
    assert not all(np.isfinite(leaf).all() for leaf in _leaves(res))
    assert res.skipped_per_round is None and res.skipped_rounds == 0


def test_quorum_guard_holds_rounds(clients):
    """min_clients above the cohort holds every round: 4- and 8-round
    campaigns end identically, at their initial params."""
    kw = dict(seeds=SEEDS, K=4, E=3, device="cpu",
              guards=RoundGuards(min_clients=M + 1))
    a, b = (campaign.run_campaign("fedavg", CFG, SystemParams(M=M, seed=0),
                                  clients, rounds=r, **kw) for r in (4, 8))
    for x, y in zip(_leaves(a), _leaves(b)):
        np.testing.assert_array_equal(x, y)
    assert a.quorum_rounds == 4 * len(SEEDS)
    assert b.quorum_rounds == 8 * len(SEEDS)
    assert a.skipped_rounds == 0
    assert all(m.quorum_held == 1.0 for m in b.metrics)


def test_clip_norm_bounds_wire_corruption(clients):
    """A ±2^12 wire flip of every client in round 2: with the per-client
    norm clip the run stays closer to the clean one than without, nothing
    rolls back; the port equals JAX in both runs."""
    wire = np.ones((8, M))
    wire[2, :] = scenario.WIRE_FLIP_GAIN
    ones = np.ones((8, M))

    def trace(mod):
        return mod.ScenarioTrace(name="wireflip", seed=0, gain=ones,
                                 qc_scale=ones, qs_scale=ones, avail=ones,
                                 drop=ones, deadline_scale=ones,
                                 wire_gain=wire)
    clean = campaign.run_campaign("fedavg", CFG, SystemParams(M=M, seed=0),
                                  clients, rounds=8, seeds=SEEDS, K=4, E=3,
                                  device="cpu",
                                  params=jax_initial_params("fedavg", JCFG,
                                                            SEEDS),
                                  index_source=CampaignIndexReplay(
                                      SEEDS, M, B, N, n_phases=1))
    runs = {}
    for clip in (1.0, None):
        jkw = dict(K=4, E=3, seeds=SEEDS, rounds=8)
        want = jcampaign.run_campaign(
            "fedavg", JCFG, JSystemParams(M=M, seed=0), clients,
            scenario=trace(jscenario),
            guards=jengine.RoundGuards(clip_norm=clip), **jkw)

        def port(params):
            return campaign.run_campaign(
                "fedavg", CFG, SystemParams(M=M, seed=0), clients,
                device="cpu", scenario=trace(scenario),
                guards=RoundGuards(clip_norm=clip), params=params,
                index_source=CampaignIndexReplay(SEEDS, M, B, N,
                                                 n_phases=1), **jkw)
        got = port(jax_initial_params("fedavg", JCFG, SEEDS))
        _assert_matches(want, got)
        runs[clip] = got
    assert runs[1.0].skipped_rounds == 0

    def dist(a, b):
        return sum(float(np.abs(x - y).sum())
                   for x, y in zip(_leaves(a), _leaves(b)))
    d_clip, d_raw = dist(runs[1.0], clean), dist(runs[None], clean)
    assert 0 < d_clip < d_raw


def test_int8_wire_under_faults_matches_jax(clients):
    """FedAvg on the int8 wire under ``faults:0.3``: the error-feedback
    state is held with the params on a rollback; the port against JAX at
    the int8 bound, scaled."""
    want, got, transfers = _pair("fedavg", clients, rounds=8,
                                    quant="int8", scenario="faults:0.3",
                                    scenario_seed=1)
    assert transfers == 1 and got.skipped_rounds > 0
    for v in quantcomm.tree_leaves(got.qstate):
        assert torch.isfinite(v).all() and v.shape[0] == len(SEEDS)
    _assert_matches(want, got, tol=INT8_TOL)


# ---------------------------------------------------------------------------
# the round builders
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def round_data(clients):
    return (torch.from_numpy(np.asarray(clients["x"], np.float32)),
            torch.from_numpy(np.asarray(clients["y"], np.int64)))


# every guard armed in one setting (one JAX compile a framework and mode)
ROUND_GUARDS = dict(clip_norm=0.5, min_clients=3)
A_MASK = np.array([0, 1, 1, 1, 0, 1, 0, 0], np.float32)
# (selection, poison, wire gain): a poisoned selected client rolls back; a
# poisoned unselected one is harmless; a flipped client is clipped; a
# cohort of 2 below the quorum of 3 is held
ROUND_CASES = {
    "poison": (A_MASK, {1: 1.0}, {}),
    "poison-unselected": (A_MASK, {0: 1.0}, {}),
    "clip": (A_MASK, {}, {2: -4096.0}),
    "quorum": (np.array([0, 1, 0, 0, 0, 1, 0, 0], np.float32), {}, {}),
}
KB = 5                   # the gathered cohort: the selected, then pads
_JAX_ROUNDS = {}


def _faults(poison, wire, idx=None):
    p, w = np.zeros(M, np.float32), np.ones(M, np.float32)
    for m, v in poison.items():
        p[m] = v
    for m, v in wire.items():
        w[m] = v
    if idx is not None:
        p, w = p[idx], w[idx]
    return p, w


def _flat(tree):
    return [np.asarray(v) for v in jax.tree.leaves(tree)]


@pytest.mark.parametrize("case", list(ROUND_CASES))
@pytest.mark.parametrize("name", ["splitme", "fedavg"])
@pytest.mark.parametrize("gather", [False, True])
def test_guarded_round_fn_matches_jax(round_data, name, case, gather):
    """``build_round_fn(guards=, with_faults=)``, full-M and gathered, against
    JAX's: params and losses at 1e-5, flags exactly."""
    x, y = round_data
    a_mask, poison, wire = ROUND_CASES[case]
    spec = engine.make_spec(name, CFG, device="cpu")
    n_ph, e_max = len(spec.phases), 3
    if (name, gather) not in _JAX_ROUNDS:       # one compile for the cases
        _JAX_ROUNDS[name, gather] = jengine.build_round_fn(
            jengine.make_spec(name, JCFG), JCFG, jnp.asarray(x.numpy()),
            jnp.asarray(y.numpy()), e_max=e_max, gather=gather,
            donate=False, guards=jengine.RoundGuards(**ROUND_GUARDS),
            with_faults=True)
    jfn = _JAX_ROUNDS[name, gather]
    fn = engine.build_round_fn(spec, CFG, x, y, e_max=e_max, gather=gather,
                               guards=RoundGuards(**ROUND_GUARDS),
                               with_faults=True)
    init = jax_initial_params(name, JCFG, (0,))[0]
    key = jax.random.PRNGKey(7)
    idx = torch.from_numpy(replay_round_indices(key, n_ph, M, e_max,
                                                spec.batch_size, N))
    tparams = tuple([{k: torch.tensor(v) for k, v in l.items()} for l in h]
                    for h in init)
    if gather:
        sel = np.flatnonzero(a_mask)
        sel_idx = np.zeros(KB, np.int64)
        sel_idx[:len(sel)] = sel
        mask = np.zeros(KB, np.float32)
        mask[:len(sel)] = 1.0
        p, w = _faults(poison, wire, sel_idx)
        p[len(sel):], w[len(sel):] = 0.0, 1.0
        wp, wl, _, wf = jfn(init, jnp.asarray(sel_idx), jnp.asarray(mask),
                            jnp.asarray(2), key, (),
                            {"poison": jnp.asarray(p),
                             "wire_gain": jnp.asarray(w)})
        stacked = tuple([{k: v[None] for k, v in l.items()} for l in h]
                        for h in tparams)
        gp, gl, _, gf = fn(stacked, torch.from_numpy(sel_idx),
                           torch.from_numpy(mask), 2, idx[None], (), None,
                           {"poison": torch.from_numpy(p),
                            "wire_gain": torch.from_numpy(w)})
        gp = tuple([{k: v[0] for k, v in l.items()} for l in h] for h in gp)
        gl = [v[0] for v in gl]
        gf = {k: v[0] for k, v in gf.items()}
    else:
        p, w = _faults(poison, wire)
        wp, wl, _, wf = jfn(init, jnp.asarray(a_mask), jnp.asarray(2), key,
                            (), {"poison": jnp.asarray(p),
                                 "wire_gain": jnp.asarray(w)})
        gp, gl, _, gf = fn(tparams, torch.from_numpy(a_mask), 2, idx, (),
                           None, {"poison": torch.from_numpy(p),
                                  "wire_gain": torch.from_numpy(w)})
    for k in ("skipped", "quorum"):
        assert float(gf[k]) == float(wf[k]), k
    want_flags = {"poison": (1.0, 0.0), "quorum": (0.0, 1.0)}.get(case,
                                                                (0.0, 0.0))
    assert (float(gf["skipped"]), float(gf["quorum"])) == want_flags
    for g, v in zip(_flat([[{k: t.numpy() for k, t in l.items()} for l in h]
                           for h in gp]), _flat(wp)):
        np.testing.assert_allclose(g, v, rtol=0, atol=1e-5)
    for g, v in zip(gl, wl):
        assert abs(float(g) - float(v)) <= 1e-5
    if case in ("poison", "quorum"):            # held: the input params
        for g, v in zip(_flat([[{k: t.numpy() for k, t in l.items()}
                                for l in h] for h in gp]), _flat(init)):
            np.testing.assert_array_equal(g, v)


def test_gathered_round_rolls_back_per_seed(round_data):
    """Two seeds in one gathered round, seed 1's params holding an inf: only
    seed 1 rolls back (its params held, skipped [0, 1]); seed 0 equals its
    own single-seed round bit for bit."""
    x, y = round_data
    spec = engine.make_spec("splitme", CFG, device="cpu")
    fn = engine.build_round_fn(spec, CFG, x, y, e_max=2, gather=True,
                               guards=RoundGuards())
    init = jax_initial_params("splitme", JCFG, SEEDS)
    bad = [[{k: v.copy() for k, v in l.items()} for l in h] for h in init[1]]
    bad[0][0]["w"][0, 0] = np.inf
    per_seed = [init[0], bad]
    stacked = tuple([{k: torch.tensor(np.stack([ps[h][l][k]
                                                for ps in per_seed]))
                      for k in init[0][h][l]} for l in range(len(init[0][h]))]
                    for h in range(2))
    sel_idx = torch.tensor([1, 2, 3, 5], dtype=torch.int64)
    mask = torch.ones(4)
    idx = torch.from_numpy(np.stack([replay_round_indices(
        jax.random.PRNGKey(s), 2, M, 2, B, N) for s in SEEDS]))
    new, losses, _, flags = fn(stacked, sel_idx, mask, 2, idx)
    assert flags["skipped"].tolist() == [0.0, 1.0]
    assert flags["quorum"].tolist() == [0.0, 0.0]
    one = tuple([{k: v[:1] for k, v in l.items()} for l in h]
                for h in stacked)
    alone, _, _, f0 = fn(one, sel_idx, mask, 2, idx[:1])
    assert f0["skipped"].tolist() == [0.0]
    for h_new, h_alone, h_in in zip(new, alone, stacked):
        for l_new, l_alone, l_in in zip(h_new, h_alone, h_in):
            for k in l_new:
                assert torch.equal(l_new[k][0], l_alone[k][0])
                assert torch.equal(l_new[k][1], l_in[k][1])
                assert torch.isfinite(l_new[k][0]).all()


# ---------------------------------------------------------------------------
# the trainers: fault channels ignored, as the reference's trainers do
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["splitme", "fedavg"])
def test_trainers_ignore_fault_channels(clients, name):
    """A trainer under a ``faults:0.3`` trace equals the same trainer with
    the trace's fault channels cleared, bit for bit, and JAX's trainer
    under the same trace at 1e-5 over 3 rounds."""
    X, y = oran.generate(n_per_class=120, seed=0)
    _, test = oran.train_test_split(X, y)
    faults = scenario.make_trace("faults:0.3", 3, M, seed=1)
    cleared = dataclasses.replace(faults, poison=None, crash=None,
                                  wire_gain=None)
    jtrace = jscenario.make_trace("faults:0.3", 3, M, seed=1)
    assert faults.has_faults() and not cleared.has_faults()
    if name == "splitme":
        jt = JSplitMeTrainer(JCFG, JSystemParams(M=M, E_max=3), clients,
                             test, batch_size=B, e_initial=3, seed=0,
                             kernel_policy="reference", scenario=jtrace)
        init = (jax.device_get(jt.w_c), jax.device_get(jt.w_s_inv))

        def port(trace):
            return SplitMeTrainer(
                CFG, SystemParams(M=M, E_max=3), clients, test,
                batch_size=B, e_initial=3, seed=0, device="cpu",
                params=init, scenario=trace,
                index_source=TrainerIndexReplay(0, M, 3, B, N))
    else:
        jt = jbaselines.FedAvgTrainer(JCFG, JSystemParams(M=M, seed=0),
                                      clients, test, K=4, E=3, seed=1,
                                      batch_size=B, scenario=jtrace)
        init = (jax.device_get(jt.params),)

        def port(trace):
            return baselines.FedAvgTrainer(
                CFG, SystemParams(M=M, seed=0), clients, test, K=4, E=3,
                seed=1, batch_size=B, device="cpu", params=init,
                scenario=trace,
                index_source=TrainerIndexReplay(1, M, 3, B, N, n_phases=1))
    trainers = [port(faults), port(cleared)]
    for _ in range(3):
        jt.run_round()
        for t in trainers:
            t.run_round()
    hist = [t.fetch_history() for t in trainers]
    for ma, mb, mj in zip(*hist, jt.fetch_history()):
        assert repr(ma) == repr(mb)
        assert ma.n_selected == mj.n_selected and ma.E == mj.E
        assert abs(ma.client_loss - mj.client_loss) <= 1e-5
    got = [quantcomm.tree_leaves(t._params()) for t in trainers]
    for a, b, w in zip(*got, jax.tree.leaves(jax.device_get(
            (jt.w_c, jt.w_s_inv) if name == "splitme" else (jt.params,)))):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
