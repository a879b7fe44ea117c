"""The port's entry points (``repro_torch.examples.oran_splitfl_campaign``
and ``repro_torch.examples.quickstart``) against the reference's
``examples/oran_splitfl_campaign.py`` and ``examples/quickstart.py``.

For the README's four command lines and the verify skill's ones (at
``--rounds`` 2; one serial line at 10 rounds to reach the checkpoint save),
both examples run with stand-ins for the campaign runners, the trainers and
``checkpoint.io.save``, so no JAX campaign runs: each makes the same calls
with equal arguments and exactly equal data arrays (configs, SystemParams,
client partitions, test splits, scenario traces, populations), the port
adding only ``device``.  The argument checks fail alike.  Then each mode
of the port's example and its quickstart run for real on the CPU
(``--device cpu``, 1-2 rounds) and print the reference's line formats.
"""
import dataclasses
import importlib.util
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from repro_torch.examples import oran_splitfl_campaign as port_example
from repro_torch.examples import quickstart as port_quickstart
from torch_parity import one_torch_thread

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_example():
    return _load("oran_splitfl_campaign")


@pytest.fixture(scope="module")
def ref_quickstart():
    return _load("quickstart")


def _norm(v):
    """A comparable form of a call argument: dataclasses by class name and
    fields, arrays by dtype, shape and bytes."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,
                {f.name: _norm(getattr(v, f.name))
                 for f in dataclasses.fields(v)})
    if isinstance(v, np.ndarray):
        return ("array", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, [_norm(x) for x in v])
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise TypeError(f"no comparable form for {type(v).__name__}")


class _Recorder:
    """Stand-ins for the runners, trainers and checkpoint saves of one
    example run; every call lands in ``calls`` as (name, args, kwargs),
    normalized when it is made."""

    def __init__(self):
        self.calls = []

    def record(self, name, args, kw):
        self.calls.append((name, _norm(list(args)), _norm(kw)))

    def runner(self, name):
        def run(*args, **kw):
            self.record(name, args, kw)
            S = len(kw["seeds"])
            metrics = [types.SimpleNamespace(round=r, comm_bits=8e6,
                                             sim_time=0.5,
                                             accuracy=float("nan"))
                       for r in range(kw["rounds"])]
            return types.SimpleNamespace(
                accuracy=np.full(S, 0.5), metrics=metrics,
                skipped_per_round=None, skipped_rounds=0, quorum_rounds=0,
                crashed_rounds=0)
        return run

    def trainer(self, name):
        rec = self

        class Trainer:
            def __init__(self, *args, **kw):
                rec.record(name, args, kw)
                self.history = []
                self.w_c = [{"w": np.ones((2, 2), np.float32)}]
                self.w_s_inv = [{"w": np.zeros((2, 2), np.float32)}]

            def run_round(self, eval_acc=False):
                rec.record(f"{name}.run_round", (), {"eval_acc": eval_acc})
                m = types.SimpleNamespace(round=len(self.history),
                                          n_selected=3, E=6, comm_bits=8e6,
                                          sim_time=0.5, accuracy=0.5,
                                          client_loss=0.25)
                self.history.append(m)
                return m

            def finalize(self):
                rec.record(f"{name}.finalize", (), {})
                return "w_server"

            def evaluate(self, w_server=None):
                rec.record(f"{name}.evaluate", (w_server,), {})
                return 0.5
        return Trainer

    def saver(self):
        def save(path, tree, metadata=None):
            self.record("checkpoint.save", (path, tree), {"metadata": metadata})
        return save


TRAINERS = ("SplitMeTrainer", "FedAvgTrainer", "SFLTrainer",
            "ORANFedTrainer", "FedORATrainer", "EcoFLTrainer")


def _stand_ins(monkeypatch, module, campaign_module, ckpt_module):
    rec = _Recorder()
    for name in ("run_campaign", "run_population_campaign"):
        if campaign_module is not None:
            monkeypatch.setattr(campaign_module, name, rec.runner(name))
    for name in TRAINERS:
        if hasattr(module, name):
            monkeypatch.setattr(module, name, rec.trainer(name))
    if ckpt_module is not None:
        monkeypatch.setattr(ckpt_module, "save", rec.saver())
    return rec


def _port_calls(calls):
    """The port's calls without its ``device="cpu"``, which every
    constructor and runner takes."""
    out = []
    for name, args, kw in calls:
        if "device" in kw:
            assert kw.pop("device") == "cpu", name
        out.append((name, args, kw))
    return out


# the README's four command lines (README.md, Quickstart) and the verify
# skill's, at 2 rounds; "{dir}" is a fresh temporary directory
README_LINES = [
    ["--rounds", "2", "--baselines", "--baseline-rounds", "2"],
    ["--rounds", "2", "--seeds", "4", "--eval-every", "5", "--quant",
     "bf16", "--scenario", "fading:0.8"],
    ["--rounds", "2", "--seeds", "4", "--checkpoint-every", "10",
     "--checkpoint-dir", "{dir}", "--resume"],
    ["--rounds", "2", "--seeds", "2", "--population", "1000000",
     "--cohort", "32", "--scenario", "churn:0.5"],
]
SKILL_LINES = [
    ["--rounds", "2"],
    ["--rounds", "2", "--seeds", "2", "--baselines", "--baseline-rounds",
     "2"],
    ["--rounds", "2", "--seeds", "2", "--eval-every", "4"],
    ["--rounds", "2", "--seeds", "2", "--scenario", "faults:0.3",
     "--checkpoint-every", "4", "--checkpoint-dir", "{dir}"],
    ["--rounds", "2", "--seeds", "2", "--scenario", "faults:0.3",
     "--checkpoint-every", "4", "--checkpoint-dir", "{dir}", "--resume"],
]
# the serial path's save every 10 rounds, the other flags of both modes
MORE_LINES = [
    ["--rounds", "10", "--policy", "kernel", "--quant", "int8",
     "--scenario", "noniid:0.1", "--ckpt-dir", "{dir}"],
    ["--rounds", "2", "--seeds", "3", "--baselines", "--baseline-rounds",
     "1", "--policy", "reference", "--scenario", "straggler:0.4",
     "--scenario-seed", "2"],
    ["--rounds", "2", "--seeds", "2", "--population", "5000", "--cohort",
     "8", "--eval-every", "1", "--quant", "int8", "--checkpoint-every", "1",
     "--checkpoint-dir", "{dir}"],
]


def _run_reference(monkeypatch, ref_module, argv, stand_ins):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    with monkeypatch.context() as m:
        rec = stand_ins(m)
        ref_module.main()
    return rec.calls


def _run_port(monkeypatch, port_module, argv, stand_ins):
    monkeypatch.setattr(sys, "argv", ["prog"])
    with monkeypatch.context() as m:
        rec = stand_ins(m)
        port_module.main(argv + ["--device", "cpu"])
    return _port_calls(rec.calls)


@pytest.mark.parametrize("line", README_LINES + SKILL_LINES + MORE_LINES,
                         ids=lambda a: " ".join(a))
def test_example_makes_the_reference_calls(monkeypatch, tmp_path, capsys,
                                           ref_example, line):
    from repro.checkpoint import io as ref_io
    from repro.launch import campaign as ref_campaign
    from repro_torch.checkpoint import io as port_io
    from repro_torch.launch import campaign as port_campaign
    argv = [a.replace("{dir}", str(tmp_path)) for a in line]
    want = _run_reference(monkeypatch, ref_example, argv,
                          lambda m: _stand_ins(m, ref_example, ref_campaign,
                                               ref_io))
    ref_out = capsys.readouterr().out
    got = _run_port(monkeypatch, port_example, argv,
                    lambda m: _stand_ins(m, port_example, port_campaign,
                                         port_io))
    port_out = capsys.readouterr().out
    assert [c[0] for c in got] == [c[0] for c in want]
    for g, w in zip(got, want):
        assert g == w, g[0]
    assert len(want) > 0
    strip = re.compile(r"wall=\d+s")     # the host clocks differ
    assert strip.sub("", port_out) == strip.sub("", ref_out)


def test_quickstart_makes_the_reference_calls(monkeypatch, capsys,
                                              ref_quickstart):
    want = _run_reference(monkeypatch, ref_quickstart, ["--rounds", "2"],
                          lambda m: _stand_ins(m, ref_quickstart, None, None))
    ref_out = capsys.readouterr().out
    got = _run_port(monkeypatch, port_quickstart, ["--rounds", "2"],
                    lambda m: _stand_ins(m, port_quickstart, None, None))
    assert got == want
    assert capsys.readouterr().out == ref_out


@pytest.mark.parametrize("argv", [
    ["--population", "1000"], ["--checkpoint-every", "2"], ["--resume"],
    ["--seeds", "2", "--resume"]], ids=lambda a: " ".join(a))
def test_example_refuses_what_the_reference_refuses(monkeypatch, capsys,
                                                    ref_example, argv):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    with pytest.raises(SystemExit) as ref_exit:
        ref_example.main()
    ref_err = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as port_exit:
        port_example.main(argv + ["--device", "cpu"])
    port_err = capsys.readouterr().err.strip().splitlines()[-1]
    assert port_exit.value.code == ref_exit.value.code == 2
    assert port_err == ref_err
    assert "error:" in port_err


# ---------------------------------------------------------------------------
# real runs on the CPU
# ---------------------------------------------------------------------------

NUM = r"\d+\.\d+"


def test_serial_example_runs_on_the_cpu(tmp_path, capsys):
    port_example.main(["--device", "cpu", "--rounds", "5", "--baselines",
                       "--baseline-rounds", "1", "--ckpt-dir",
                       str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(rf"\[splitme\] round 4: sel=\d+ E=\d+ acc={NUM} "
                        rf"cum_comm={NUM}MB", out[0]), out[0]
    assert re.fullmatch(rf"\[splitme\] FINAL acc={NUM} rounds=5 "
                        rf"sim_time={NUM}s wall=\d+s", out[1]), out[1]
    names = ["fedavg", "sfl", "oranfed", "fedora", "ecofl"]
    for name, line in zip(names, out[2:], strict=True):
        assert re.fullmatch(rf"\[{name}\] acc={NUM} rounds=1 "
                            rf"sim_time={NUM}s comm={NUM}MB", line), line
    assert not list(tmp_path.iterdir())       # the save comes at round 10


def test_campaign_example_runs_on_the_cpu(tmp_path, capsys):
    port_example.main(["--device", "cpu", "--rounds", "2", "--seeds", "2",
                       "--eval-every", "1", "--scenario", "faults:0.3",
                       "--checkpoint-every", "1", "--checkpoint-dir",
                       str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(rf"\[splitme\] 2 seeds x 2 rounds: acc={NUM}±{NUM}"
                        rf" \(per-seed \[.*\]\) comm={NUM}MB "
                        rf"sim_time={NUM}s wall=\d+s", out[0]), out[0]
    assert re.fullmatch(r"\[splitme\] guards: skipped_rounds=\d+ "
                        r"quorum_rounds=\d+ crashed_rounds=\d+", out[1])
    assert re.fullmatch(rf"\[splitme\] fused-eval accuracy curve: "
                        rf"\[\(0, {NUM}\), \(1, {NUM}\)\]", out[2]), out[2]
    assert (tmp_path / "splitme").is_dir()


def test_population_example_runs_on_the_cpu(capsys):
    port_example.main(["--device", "cpu", "--rounds", "2", "--seeds", "2",
                       "--population", "1000", "--cohort", "8",
                       "--scenario", "churn:0.5"])
    (line,) = capsys.readouterr().out.splitlines()
    assert re.fullmatch(rf"\[splitme/pop\] 1,000 clients, cohort 8, 2 seeds "
                        rf"x 2 rounds: acc={NUM}±{NUM} comm={NUM}MB "
                        rf"wall=\d+s", line), line


def test_quickstart_runs_on_the_cpu(capsys):
    port_quickstart.main(["--device", "cpu", "--rounds", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "round | selected | E | comm MB | latency ms | client KL"
    for r, line in enumerate(out[1:3]):
        assert re.fullmatch(rf"\s*{r} \|\s+\d+ \| \d+ \|\s+{NUM} \|\s+{NUM}"
                            rf" \| {NUM}", line), line
    assert out[3] == ""
    assert re.fullmatch(rf"final accuracy after inversion: {NUM}", out[4])


def test_examples_run_as_modules():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for name in ("quickstart", "oran_splitfl_campaign"):
        out = subprocess.run(
            [sys.executable, "-m", f"repro_torch.examples.{name}", "--help"],
            env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert "--device" in out.stdout
