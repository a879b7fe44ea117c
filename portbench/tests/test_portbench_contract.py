"""The benchmark's files against its contract, without a card: what the
harness imports, the manifest, the yardstick's counts against hand
counts, the metric readers on synthetic runs, and that a new traffic mix
is found by name.

    PYTHONPATH=src python -m pytest portbench/tests -q
"""
from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def run_py(code: str, cwd=ROOT) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                         capture_output=True, text=True, timeout=600,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_imports_leave_no_jax_or_the_reference_package():
    """Every module the benchmark runs, and the program it drives, loaded
    in one process: no top-level module name is JAX's or the JAX
    package's (compared whole: ``repro_torch`` starts with ``repro``)."""
    code = f"""
import importlib.util, json, sys
sys.path[:0] = [{str(ROOT)!r}]
from portbench import harness, compare, trace, yardstick, inputs, calibrate
from portbench import reference
from portbench.reference import model, plan, splitme, sfl
import repro_torch.launch.campaign
for p in sorted(({str(BENCH)!r} + "/metrics/" + m) for m in
                __import__("os").listdir({str(BENCH)!r} + "/metrics")):
    if p.endswith(".py"):
        harness.metric_reader(p.rsplit("/", 1)[1][:-3])
for d in ("configs", "traffic", "checks"):
    for p in __import__("pathlib").Path({str(BENCH)!r}, d).glob("*.json"):
        json.loads(p.read_text())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    names = set(json.loads(run_py(code).splitlines()[-1]))
    assert not names & FORBIDDEN, names & FORBIDDEN
    assert "repro_torch" in names


def imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for name in imported_roots(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN | {"repro_torch"}, (path.name, name)
        assert root in {"torch", "numpy", "portbench", "__future__",
                        "math", "typing", "types", "contextlib",
                        "importlib"}, (path.name, name)
        if root == "portbench":
            assert name.startswith("portbench.reference"), name


def test_manifest_keys_names_and_units():
    b = manifest()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    assert b["command"] == ["python3", "portbench/run.py"]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    names = [x["name"] for x in b["configs"] + b["workloads"]
             + b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for x in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"]), x
        assert x["better"] in ("lower", "higher")
    for c in b["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "checks" / f"{w['name']}.json").is_file()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(b["workloads"])
    assert {w["config"] for w in b["workloads"]} == {c["name"]
                                                      for c in b["configs"]}
    assert len(json.dumps(b)) <= 64 * 1024


def test_per_layer_metrics_move_an_end_to_end_metric_of_their_cells():
    b = manifest()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in b["end_to_end"]}
    layers = {}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert 1 <= len(m["layer"]) <= 200
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for cell in cells:
        assert any(cell in m.get("workloads", cells) for m in b["per_layer"])


def test_yardstick_counts_against_hand_counts():
    from portbench import yardstick as y
    # a Gram pair of a (10, 3) O and a (10, 2) Z: OᵀO's 6 distinct entries
    # and OᵀZ's 6, each 10 multiply-adds
    assert y.gram_pair(10, 3, 2) == (10 * 3 * 4 + 2 * 10 * 3 * 2,
                                     4 * (10 * 5 + 3 * 5))
    # 5 rows of 4 f32: the forward reads x and y and writes a float a row,
    # the backward reads x, y and g and writes gx
    assert y.kl_rows(5, 4) == 5 * 4 * 8 + 20 + 5 * 4 * 12 + 20
    cfg = {"model": {"n_features": 2, "hidden": [3, 4], "n_classes": 2,
                     "split_index": 1},
           "campaign": {"batch_size": 2}}
    a = np.array([[1, 1, 0], [0, 1, 0]], float)        # 2 rounds, M 3
    E = np.array([2, 1])
    ev = np.array([False, True])
    w = y.splitme(cfg, a, E, ev, n=5, n_test=7)
    w_c, w_s = 2 * 3, 3 * 4 + 4 * 2                      # weights
    steps = 2 * 2 + 1 * 1                                # client-steps
    N = 3 * 5
    grams = sum(y.gram_pair(N, d + 1, o)[0] for d, o in ((3, 4), (4, 2)))
    assert w.flops == (3 * 2 * 5 * (w_s + w_c) + steps * 2 * 6 * (w_c + w_s)
                       + 2 * N * (w_c + 2 * w_s) + 2 * 7 * (w_c + w_s)
                       + grams)
    assert w.gram_ops == grams
    assert w.kl_bytes == 2 * y.kl_rows(steps * 2, 3)
    full = y.full_model(cfg, a, E, ev, n=5, n_test=7)
    w_f = 2 * 3 + 3 * 4 + 4 * 2
    assert full.flops == steps * 2 * 6 * w_f + 2 * 7 * w_f


def synthetic_run():
    """Two calls of a 2-lane campaign of 3 rounds with a fake trace."""
    from portbench import trace as tr, yardstick as y
    a = np.array([[1, 1, 0, 0]] * 3, float)
    E = np.array([4, 2, 2])
    call = {"lanes": 2, "rounds": 3, "capture_s": 0.5,
            "shapes": {(2, 4): [0], (2, 2): [1, 2]},
            "round_ms": np.array([1.0, 2.0, 30.0]),
            "do_eval": np.array([False, False, True]),
            "schedules": [(a, None, E, 2)]}
    device = [("kl_rows_kernel<4,1,float,float>", 1000, 1000),
              ("kl_grad_kernel<4,1,float,float>", 1500, 500),
              ("gram_tf32_kernel", 3000, 2000),
              ("other", 10_000, 1000)]
    trace = tr.Trace(device=device, window=(0, 20_000), idle_by_label={})
    work = y.Work(flops=6.7e9, kl_bytes=3.35e-3 * 1000, gram_ops=1.0,
                  gram_bytes=3.35e-3 * 1000)
    return SimpleNamespace(calls=[call, dict(call)], window_s=2.0,
                           trace=trace, work=work, peak=67e9,
                           live_slots=(24.0, 32.0))


@pytest.mark.parametrize("name,want", [
    ("campaign.capture_share", 50.0),
    ("engine.live_slot_share", 75.0),
    ("engine.ops_per_round", 4 / 6),
    ("step4.eval_round_ms", 30.0),
    ("kl_mutual_roofline", 100.0 * 1e-15 * 1000 / 1500e-9),
    ("ridge_gram_roofline", 100.0 * 1e-15 * 1000 / 2000e-9),
    ("device.idle_share", 100.0 * (1 - 4000 / 20_000)),
    ("mfu", 100.0 * 6.7e9 / (2.0 * 67e9)),
])
def test_metric_readers_on_a_synthetic_run(name, want):
    from portbench import harness
    got = harness.metric_reader(name)(synthetic_run())
    assert got == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", ["engine.ops_per_round",
                                  "kl_mutual_roofline",
                                  "ridge_gram_roofline", "device.idle_share"])
def test_metric_readers_without_a_trace_read_nothing(name):
    from portbench import harness
    run = synthetic_run()
    run.trace = None
    assert harness.metric_reader(name)(run) is None


def test_busy_union_and_idle_labels():
    from portbench import trace as tr
    # two streams overlap in [5, 8) µs; the host is in a span over both
    # long gaps, and inside it in an operation during the first
    dev = [("a", 0, 8000), ("b", 5000, 7000), ("c", 200_000, 10_000)]
    assert tr.union(dev) == [(0, 12_000), (200_000, 210_000)]
    host = [(0, 400_000, 1, "campaign.plan_schedule", True),
            (100_000, 150_000, 1, "aten::cat", False)]
    idle = tr.idle_by_label(tr.union(dev), (0, 400_000), host)
    assert idle == {"campaign.plan_schedule: aten::cat": pytest.approx(188e-6),
                    "campaign.plan_schedule": pytest.approx(190e-6)}
    t = tr.Trace(device=dev, window=(0, 400_000), idle_by_label=idle)
    assert t.busy_s() == pytest.approx(22e-6)
    assert tr.kernel_name("_Z14kl_rows_kernelILi4EEvPKf") == "kl_rows_kernel"
    assert tr.top_device_ops(dev, 2) == [["c", 1e-05], ["a", 8e-06]]


def test_a_new_traffic_file_is_found_by_name(tmp_path):
    """A copy of the benchmark with one more traffic file and one more
    workload entry: the harness runs the new cell with no file edited."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    b = manifest()
    b["workloads"].append({"name": "splitme-dnn10.new", "config":
                           "splitme-dnn10", "traffic": "new", "chips": 1,
                           "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    (tmp_path / "portbench/traffic/new.json").write_text(json.dumps(
        {"entry": "run_campaign", "seeds_per_call": 2, "rounds": 2,
         "eval_every": 1, "check_per_call": 1}))
    (tmp_path / "portbench/checks/splitme-dnn10.new.json").write_text(
        json.dumps({"numbers": {"schedule": {"limit": 0}}}))
    code = f"""
import json, sys, time
sys.path[:0] = [{str(tmp_path)!r}]
from portbench import harness
assert harness.HERE == __import__("pathlib").Path({str(tmp_path)!r}, "portbench")
out = harness.run_cell("splitme-dnn10.new", 7, 0.0, False,
                       t_start=time.perf_counter(), device="cpu",
                       overrides={{"deployment": {{"M": 6}},
                                  "data": {{"n_per_class": 60,
                                           "samples_per_client": 16}}}},
                       log=lambda *a, **k: None)
print(json.dumps(out))
"""
    out = json.loads(run_py(code).splitlines()[-1])
    assert out["correct"] and out["attempted"] == 2
    assert out["checks"]["schedule"]["value"] == 0.0


def test_loss_worst_spans_the_rounds_its_check_gives():
    """A lane that parts from the reference after round 1 passes a
    ``loss_worst`` over round 1 and fails one over every round."""
    from portbench import compare
    want = {"losses": np.ones((3, 2)), "acc_rounds": np.full(3, np.nan),
            "accuracy": 0.5, "params": ([{"w": _t([1.0]), "b": _t([1.0])}],)}
    got = dict(want, losses=np.array([[1.0, 1.0], [1.5, 1.0], [2.0, 1.0]]))
    first = compare.lane_gaps([got], [want], [0.5], 1200,
                              {"loss_worst": 1})
    every = compare.lane_gaps([got], [want], [0.5], 1200, {})
    assert first["loss_worst"] == [0.0] and every["loss_worst"] == [1.0]


def _t(values):
    import torch
    return torch.tensor(values)


@pytest.mark.parametrize("workload", ["splitme-dnn10.seeds32",
                                      "splitme-dnn10.sweep16"])
def test_step4_runs_the_programs_ridge_gamma(workload):
    """The SplitMe cells run Step 4 at the program's default ridge gamma,
    the one its users run, and not one chosen to make the comparison
    pass."""
    import inspect
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import harness
    from repro_torch.launch import campaign
    cell, cfg, traffic, _ = harness.find_cell(manifest(), workload)
    entry = getattr(campaign, traffic["entry"])
    default = inspect.signature(entry).parameters["eval_gamma"].default
    assert cfg["campaign"]["eval_gamma"] == default


def test_an_untraced_run_leaves_the_program_unwrapped(monkeypatch):
    """The harness's spans wrap the program's functions only in a traced
    run: an untraced window runs the program as it stands."""
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import time
    from portbench import harness, trace

    def refuse(host_s):
        raise AssertionError("the spans were entered in an untraced run")
    monkeypatch.setattr(trace, "spans", refuse)
    out = harness.run_cell(
        "splitme-dnn10.seeds32", 3, 0.0, False, t_start=time.perf_counter(),
        device="cpu", log=lambda *a, **k: None,
        overrides={"deployment": {"M": 6},
                   "data": {"n_per_class": 60, "samples_per_client": 16},
                   "traffic": {"seeds_per_call": 2, "rounds": 2,
                               "check_per_call": 1}})
    assert out["correct"] and out["calls"]["host_s"] == {}
