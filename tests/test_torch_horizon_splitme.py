"""The port's SplitMe campaign against the JAX package's over the paper's
whole horizon, on the reference's draws (tests/torch_horizon_check.py holds
the setting and both sides' runs; the reference's runs in a subprocess
beside the port's).

The example's setting: ``oran.generate(n_per_class=2000, seed=0)``, M 50
clients of 96 samples, ``SystemParams(seed=0)``, DNN10, batch 32, 30
rounds, seeds 0 and 1, an evaluation every 10 rounds at γ = 10 (at the
default 1e-3 the f32 ridge is ill-conditioned).  The port's
``run_campaign`` takes the JAX campaign's initial params and its key
chains' batch indices (``torch_parity.CampaignIndexDraws``: one compiled
call a campaign, held bit for bit against the round-by-round
``CampaignIndexReplay`` below).

Bounds (``torch_horizon_check.bound``): the schedule and the system
metrics exactly; each round's losses, and the params and the accuracy at
rounds 10, 20 and 30, within twice the reference's own envelope by that
round, or within 1e-5 where the envelope is at most 1e-5 (the port's
difference is one more draw from the same sensitivity).  The envelope
(``tests/data/horizon_envelope.json``, ``torch_horizon_check.py
envelope``) is the largest difference, up to that round, between the
reference's campaign and the same campaign from its initial weights moved
by one f32 ulp (every element up, down, every other element up, the first
layer up), over seeds 0 and 1: the upper hull, since a parted trajectory's
difference rises and falls with each round's batches.  Measured on an x86
CPU (8 cores, torch 2.13.0+cpu, jax 0.9.0; the reference's envelope / the
port's difference, the largest share of its bound a round used):

* splitme loss (round: envelope / port): 1: 8.34e-07 / 2.24e-07, 2:
  8.34e-07 / 4.54e-07, 3: 8.34e-07 / 4.47e-07, 10: 8.34e-07 / 8.94e-08,
  20: 3.42e-06 / 1.77e-06, 30: 3.42e-06 / 8.57e-07; largest share of the
  bound 0.332
* splitme params (round: envelope / port): 10: 4.20e-06 / 8.94e-07, 20:
  1.16e-04 / 1.17e-04, 30: 1.16e-04 / 1.17e-04; largest share of the
  bound 0.5
* splitme accuracy (round: envelope / port): 10: 0.00e+00 / 0.00e+00,
  20: 8.33e-04 / 0.00e+00, 30: 8.33e-04 / 0.00e+00; largest share of the
  bound 0
"""
import numpy as np
import pytest

import torch_horizon_check as hc
from torch_parity import (CampaignIndexDraws, CampaignIndexReplay,
                          one_torch_thread)  # noqa: F401  (autouse)

FRAMEWORKS = ("splitme",)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("horizon"))
    proc = hc.start_reference(FRAMEWORKS, d)
    yield proc, d
    proc.kill()
    proc.wait()


@pytest.fixture(scope="module", params=FRAMEWORKS)
def runs(request, reference, tmp_path_factory):
    fw, (proc, d) = request.param, reference
    got = hc.port_replayed(fw, *hc.campaign_data(),
                           str(tmp_path_factory.mktemp(f"port-{fw}")))
    return fw, hc.reference_result(proc, fw, d), got


def test_schedule_and_metrics_match_exactly(runs):
    _, want, got = runs
    hc.check_schedule(want, got)


@pytest.mark.parametrize("what", ["loss", "params", "accuracy"])
def test_within_the_reference_envelope(runs, what):
    fw, want, got = runs
    hc.check_curve(fw, what, want, got)


@pytest.mark.parametrize("n_phases", [2, 1])
def test_one_call_draws_equal_the_round_by_round_replay(n_phases):
    """Every round of the paper's SplitMe schedule at its E bucket, as the
    campaign reads them, in two phases (SplitMe's) and in one (a
    baseline's), bit for bit; the last round at the cap."""
    from repro_torch.configs.splitme_dnn import DNN10
    from repro_torch.core.cost import SystemParams
    from repro_torch.launch import campaign
    sp, sched = campaign.plan_schedule("splitme", SystemParams(seed=0),
                                       DNN10, hc.SPLITME_ROUNDS,
                                       n_samples_per_client=hc.SAMPLES)
    _, eb_r = campaign._round_shapes(sched, sp)
    assert max(eb_r) <= hc.E_CAP == sp.E_max
    draws = CampaignIndexDraws(hc.HORIZON_SEEDS, hc.SPLITME_ROUNDS,
                               hc.M, hc.B, hc.SAMPLES, e_max=hc.E_CAP,
                               n_phases=n_phases)
    replay = CampaignIndexReplay(hc.HORIZON_SEEDS, hc.M, hc.B, hc.SAMPLES,
                                 n_phases=n_phases)
    last = hc.SPLITME_ROUNDS - 1
    for r, eb in enumerate(eb_r[:last] + [hc.E_CAP]):
        for i in range(len(hc.HORIZON_SEEDS)):
            want = replay(i, r, eb).numpy()
            got = draws(i, r, eb).numpy()
            assert got.shape == want.shape == (n_phases, hc.M, eb, hc.B)
            np.testing.assert_array_equal(got, want)
