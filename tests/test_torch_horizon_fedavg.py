"""The port's FedAvg, FedORA and EcoFL campaigns against the JAX
package's over the paper's whole horizon, on the reference's draws
(tests/torch_horizon_check.py holds the setting and both sides' runs; the
reference's runs in a subprocess beside the port's).

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

* fedavg loss (round: envelope / port): 1: 9.39e-07 / 2.98e-08, 2:
  3.48e-05 / 2.98e-08, 3: 1.69e-04 / 1.94e-07, 10: 1.79e-02 / 5.62e-04,
  20: 4.41e-02 / 1.10e-03, 30: 1.90e-01 / 2.38e-02, 40: 1.90e-01 /
  2.51e-03, 50: 1.90e-01 / 1.11e-03, 60: 1.90e-01 / 6.91e-03; largest
  share of the bound 0.51
* fedavg params (round: envelope / port): 10: 2.04e-02 / 2.63e-03, 20:
  3.93e-02 / 9.50e-03, 30: 1.46e-01 / 3.88e-02, 40: 1.81e-01 / 3.47e-02,
  50: 1.81e-01 / 4.44e-02, 60: 1.81e-01 / 5.91e-02; largest share of the
  bound 0.164
* fedavg accuracy (round: envelope / port): 10: 5.50e-02 / 1.67e-02, 20:
  1.32e-01 / 3.50e-02, 30: 1.57e-01 / 3.50e-02, 40: 1.57e-01 / 5.00e-03,
  50: 1.57e-01 / 3.75e-02, 60: 1.57e-01 / 1.33e-02; largest share of the
  bound 0.152
* fedora loss (round: envelope / port): 1: 2.09e-07 / 1.49e-08, 2:
  4.17e-07 / 4.47e-08, 3: 1.45e-06 / 2.98e-08, 10: 5.98e-03 / 2.24e-08,
  20: 4.49e-02 / 6.71e-08, 30: 6.67e-02 / 6.71e-08, 40: 1.40e-01 /
  1.17e-05, 50: 3.22e-01 / 1.18e-03, 60: 3.25e-01 / 1.80e-03; largest
  share of the bound 0.0565
* fedora params (round: envelope / port): 10: 9.94e-03 / 2.38e-07, 20:
  5.59e-02 / 2.38e-07, 30: 7.61e-02 / 3.58e-07, 40: 1.22e-01 / 1.55e-04,
  50: 2.22e-01 / 3.29e-03, 60: 2.22e-01 / 1.07e-02; largest share of the
  bound 0.0242
* fedora accuracy (round: envelope / port): 10: 1.17e-02 / 0.00e+00, 20:
  1.32e-01 / 0.00e+00, 30: 2.82e-01 / 0.00e+00, 40: 3.44e-01 / 0.00e+00,
  50: 3.61e-01 / 1.92e-02, 60: 4.21e-01 / 1.42e-02; largest share of the
  bound 0.0266
* ecofl loss (round: envelope / port): 1: 8.87e-06 / 2.98e-08, 2:
  2.73e-04 / 2.98e-08, 3: 1.31e-03 / 4.47e-08, 10: 2.11e-02 / 5.48e-05,
  20: 1.04e-01 / 9.33e-03, 30: 1.21e-01 / 4.08e-02, 40: 1.32e-01 /
  1.59e-02, 50: 1.32e-01 / 5.14e-02, 60: 1.86e-01 / 1.81e-02; largest
  share of the bound 0.448
* ecofl params (round: envelope / port): 10: 4.64e-02 / 3.80e-04, 20:
  7.84e-02 / 1.17e-02, 30: 1.51e-01 / 1.32e-01, 40: 1.75e-01 / 1.71e-01,
  50: 1.87e-01 / 1.59e-01, 60: 2.06e-01 / 1.95e-01; largest share of the
  bound 0.489
* ecofl accuracy (round: envelope / port): 10: 9.92e-02 / 1.67e-03, 20:
  2.45e-01 / 4.67e-02, 30: 3.24e-01 / 9.42e-02, 40: 3.89e-01 / 7.50e-02,
  50: 3.89e-01 / 1.08e-02, 60: 3.89e-01 / 4.17e-02; largest share of the
  bound 0.145
"""
import pytest

import torch_horizon_check as hc
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

FRAMEWORKS = ("fedavg", "fedora", "ecofl")


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
