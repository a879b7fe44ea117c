"""The plain reference against the program on the CPU at a small size, the
comparison's verdict on a timed path broken underneath, the harness's
refusal without a card, and (on the card) the control and a run's device
line.

    PYTHONPATH=src python -m pytest portbench/tests -q
    python -m pytest -q -m cuda portbench/tests      # on the card
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from portbench import compare, harness, reference as ref  # noqa: E402
from portbench.inputs import Inputs  # noqa: E402

CELLS = ("splitme-dnn10.seeds32", "sfl-dnn10.seeds32",
         "splitme-dnn10.curve32", "splitme-dnn10.sweep16")
# M 8 clients of 32 samples, 2 seeds a call, 3 rounds; 1200 test samples,
# so that an answer off by 1 % of them is 12 samples
SMALL = {"deployment": {"M": 8},
         "data": {"n_per_class": 2000, "samples_per_client": 32},
         "traffic": {"seeds_per_call": 2, "rounds": 3, "check_per_call": 2}}


def small_run(workload: str, seed: int = 11) -> dict:
    overrides = {k: dict(v) for k, v in SMALL.items()}
    return harness.run_cell(workload, seed, 0.0, False,
                            t_start=time.perf_counter(), device="cpu",
                            overrides=overrides, log=lambda *a, **k: None)


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_program_on_the_cpu(workload):
    """The schedule exactly; every loss and the final params to float32
    rounding over 3 rounds (1e-5: no trajectory has parted yet); the
    accuracies within the cell's limits (Step 4's solve amplifies the
    Grams' rounding into a sample or two)."""
    out = small_run(workload)
    assert out["correct"], out["checks"]
    assert out["checks"]["schedule"]["value"] == 0.0
    assert out["checks"]["loss"]["value"] < 1e-5


@pytest.mark.parametrize("workload", CELLS[:2])
def test_params_and_losses_agree_lane_by_lane(workload):
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    _, cfg, traffic, checks = harness.find_cell(bench, workload)
    for key, val in SMALL.items():
        (traffic if key == "traffic" else cfg[key]).update(val)
    inputs = Inputs(5, cfg["data"], cfg["deployment"]["M"])
    camp = harness.Campaigns(cfg, traffic, inputs, "cpu")
    seeds = inputs.seeds(2)
    call = harness.summarize(camp.call(seeds), seeds, camp.do_eval,
                             [(0, 0), (0, 1)])
    got = compare.readings(cfg, traffic, inputs, [call], "cpu", {})
    assert max(got["schedule"]) == 0.0
    assert max(got["loss"]) < 1e-5 and max(got["params"]) < 1e-5
    if "acc_judged" in checks["numbers"]:
        assert max(got["acc_judged"]) <= 1


def _frozen(monkeypatch):
    """A step that returns its state unchanged."""
    from repro_torch.core import engine
    make = engine._phase_runner

    def phase_runner(phase, e_max):
        run = make(phase, e_max)
        return lambda w, *a: (w, run(w, *a)[1])
    monkeypatch.setattr(engine, "_phase_runner", phase_runner)


def _half(monkeypatch):
    """Each step's loss over the first half of its batch."""
    from repro_torch.core import engine
    from repro_torch.kernels import dispatch
    kl, ce = dispatch.kl_loss, engine._ce_step

    def kl_loss(x, y, **kw):
        h = x.shape[-2] // 2
        return kl(x[..., :h, :].contiguous(), y[..., :h, :].contiguous(),
                  **kw)

    def ce_step(cfg, pol):
        loss = ce(cfg, pol)
        return lambda w, x, y: loss(w, x[..., :x.shape[-2] // 2, :],
                                    y[..., :y.shape[-1] // 2])
    monkeypatch.setattr(dispatch, "kl_loss", kl_loss)
    monkeypatch.setattr(engine, "_ce_step", ce_step)


def _answer(monkeypatch):
    """The evaluation's answer off by 1 % of the test set."""
    from repro_torch.core import engine
    build = engine.build_eval_fn

    def build_eval_fn(*a, **k):
        acc = build(*a, **k)
        return lambda params: acc(params) + 0.01
    monkeypatch.setattr(engine, "build_eval_fn", build_eval_fn)


def compares_an_answer(workload: str) -> bool:
    """Whether the cell's checks compare an accuracy: the SplitMe cells'
    Step 4 at the program's ridge gamma 1e-3 is decided by rounding, so
    they compare none, and an altered answer passes there (PERF.md)."""
    with open(ROOT / "portbench" / "checks" / f"{workload}.json") as f:
        numbers = json.load(f)["numbers"]
    return bool({"acc_judged", "acc_traj"} & set(numbers))


FAULTS = {"state_unchanged": _frozen, "half_batch": _half,
          "answer": _answer}


@pytest.mark.parametrize("workload,fault", [
    pytest.param(w, f, id=f"{w}-{f}") for w in CELLS for f in FAULTS
    if f != "answer" or compares_an_answer(w)])
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault = FAULTS[fault]
    fault(monkeypatch)
    out = small_run(workload)
    assert not out["correct"], out["checks"]


def test_the_harness_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    run = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode != 0 and run.stdout.strip() == ""
    assert "CUDA card" in run.stderr


@pytest.mark.cuda
def test_a_run_names_the_device_and_its_power_limit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[1],
         "--seed", "2", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["kind"] == torch.cuda.get_device_name(0)
    assert dev["memory_peak_bytes"] > 0 and "W" in dev["power"]
    assert list(out)[-1] == "checks" and out["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS[:2])
def test_the_control_is_not_correct_on_the_card(workload):
    """The reference with its float32 matmuls in TF32, in the program's
    place, at the cell's own size on 4 seeds: its loss number is over the
    cell's limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    _, cfg, traffic, checks = harness.find_cell(bench, workload)
    inputs = Inputs(3, cfg["data"], cfg["deployment"]["M"])
    data = ref.device_data({"clients": inputs.clients, "test": inputs.test},
                           cfg["model"]["n_classes"], "cuda")
    seeds, R = inputs.seeds(4), traffic["rounds"]
    runs = [ref.campaign(cfg, cfg["deployment"], R, seeds, data, tf32=tf32,
                         eval_rounds=[R - 1]) for tf32 in (False, True)]
    want, got = (compare.lanes_of_reference(r, seeds, R) for r in runs)
    judged = ref.evaluate(cfg, runs[1]["params"], data)
    gaps = compare.lane_gaps(got, want, judged, len(inputs.test[1]),
                             compare.rounds_of(checks))
    assert np.median(gaps["loss"]) > checks["numbers"]["loss"]["limit"]
