"""The port's O-RANFed campaign against the JAX package's over the paper's
whole horizon, on the reference's draws (tests/torch_horizon_check.py holds
the setting and both sides' runs; the reference's runs in a subprocess
beside the port's).

The example's setting: ``oran.generate(n_per_class=2000, seed=0)``, M 50
clients of 96 samples, ``SystemParams(seed=0)``, DNN10, batch 32, 60
rounds with the example's K and E, seeds 0 and 1, an evaluation every 10
rounds.  The port's ``run_campaign`` takes the JAX campaign's initial
params (``PRNGKey(seed + 1)``) and its key chains' batch indices, one
phase (``torch_parity.CampaignIndexDraws``).

Bounds as tests/test_torch_horizon_splitme.py's: the schedule and the
system metrics exactly; each round's losses, and the params and the
accuracy at rounds 10, 20, ..., 60, within twice the reference's own
one-ulp envelope by that round (``tests/data/horizon_envelope.json``), or
within 1e-5 where the envelope is at most 1e-5.  Measured on an x86
CPU (8 cores, torch 2.13.0+cpu, jax 0.9.0; the reference's envelope / the
port's difference, the largest share of its bound a round used):

* oranfed loss (round: envelope / port): 1: 8.66e-05 / 5.96e-08, 2:
  8.66e-05 / 6.98e-10, 3: 8.66e-05 / 1.51e-09, 10: 3.80e-03 / 2.02e-05,
  20: 1.28e-02 / 1.42e-03, 30: 2.53e-02 / 2.24e-03, 40: 3.87e-02 /
  1.13e-03, 50: 3.87e-02 / 4.42e-04, 60: 3.87e-02 / 2.67e-03; largest
  share of the bound 0.085
* oranfed params (round: envelope / port): 10: 1.00e-02 / 9.68e-05, 20:
  2.15e-02 / 2.60e-03, 30: 3.13e-02 / 6.01e-03, 40: 3.55e-02 / 5.82e-03,
  50: 3.55e-02 / 6.84e-03, 60: 3.84e-02 / 8.39e-03; largest share of the
  bound 0.109
* oranfed accuracy (round: envelope / port): 10: 1.00e-02 / 0.00e+00,
  20: 5.33e-02 / 4.17e-03, 30: 1.30e-01 / 7.50e-03, 40: 1.30e-01 /
  5.00e-03, 50: 1.30e-01 / 2.50e-03, 60: 1.30e-01 / 8.33e-03; largest
  share of the bound 0.0391
"""
import pytest

import torch_horizon_check as hc
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

FRAMEWORKS = ("oranfed",)


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
