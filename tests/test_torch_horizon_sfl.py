"""The port's SFL campaign against the JAX package's over the paper's whole
horizon, on the reference's draws (tests/torch_horizon_check.py holds the
setting and both sides' runs; the reference's runs in a subprocess beside
the port's).

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

* sfl loss (round: envelope / port): 1: 3.00e-06 / 1.49e-08, 2: 9.06e-05
  / 0.00e+00, 3: 1.83e-04 / 0.00e+00, 10: 2.53e-02 / 1.45e-06, 20:
  4.02e-02 / 1.31e-03, 30: 1.14e-01 / 6.58e-03, 40: 1.14e-01 / 2.14e-03,
  50: 1.19e-01 / 3.30e-03, 60: 1.19e-01 / 6.06e-03; largest share of the
  bound 0.264
* sfl params (round: envelope / port): 10: 5.71e-02 / 4.63e-06, 20:
  8.08e-02 / 1.13e-03, 30: 1.41e-01 / 3.98e-02, 40: 1.41e-01 / 4.99e-02,
  50: 1.41e-01 / 4.69e-02, 60: 1.41e-01 / 5.16e-02; largest share of the
  bound 0.183
* sfl accuracy (round: envelope / port): 10: 1.37e-01 / 0.00e+00, 20:
  1.40e-01 / 1.67e-03, 30: 3.21e-01 / 8.33e-04, 40: 3.21e-01 / 3.08e-02,
  50: 3.21e-01 / 1.33e-02, 60: 3.21e-01 / 6.67e-03; largest share of the
  bound 0.0481
"""
import pytest

import torch_horizon_check as hc
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

FRAMEWORKS = ("sfl",)


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
