"""The port's dry-run (``python -m repro_torch.launch.dryrun``) and the
sharding rules and reshards it runs on fake worlds, in subprocesses (a
process group is process-global; tests/torch_tooling_check.py):

* the CLI as a user runs it, a fake world of 256 ranks, meta DTensors:
  RWKV6-1.6B × decode_32k and SmolLM-135M × decode_32k (9 heads over 16
  ranks, resharded) run: ``ok``, the roofline terms, the per-rank bytes
  against the card's 80 GB; a second run skips what is written;
* a step calling an op DTensor has no rule for (``aten.renorm``) fails
  through the CLI naming the op, and the CLI exits 1: nothing is quietly
  replicated;
* (a) the ``searchsorted`` rule all-gathers a sharded sequence, and
  reduced MoE steps (GQA train, MLA decode) finish on a fake 2 × 2 world
  with all-gathers counted inside the dispatch; a train step under each
  expert layout gathers FSDP's split of the experts' weights and keeps
  Megatron's;
* (b) decode of a reduced config with 3 heads over "model" axes of 2 and 4
  reshards its head views, each reshard an all-gather the step counts;
* (c) the scan-step extrapolation (``dryrun.count_step``: RWKV6's WKV
  loop, Zamba2's sequential and chunked SSD loops cut to 3, 4 and 5 steps)
  equals the direct count: FLOPs, collectives and their bytes exactly,
  bytes within ``BYTES_REL``, as the depth extrapolation is held
  (tests/test_torch_roofline.py); the direct peak lies between the
  extrapolated peak's bounds and on its estimate (within ``BYTES_REL``).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import torch_tooling_check as ttc
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
BYTES_REL = 2e-2
CHECKS = ("rules", "scan-steps", "no-rule")


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The subprocess checks, started together; ``_result`` waits for
    one."""
    d = tmp_path_factory.mktemp("dryrun_checks")
    procs = {}
    for name in CHECKS:
        out = d / f"{name}.json"
        procs[name] = (out, subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_tooling_check.py"),
             name, str(out)], env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    yield procs
    for _, p in procs.values():
        if p.poll() is None:
            p.kill()


_RESULTS = {}


def _result(started, name):
    if name not in _RESULTS:
        out, proc = started[name]
        log = proc.communicate(timeout=900)[0].decode(errors="replace")
        assert proc.returncode == 0, log[-4000:]
        _RESULTS[name] = json.loads(out.read_text())
    return _RESULTS[name]


def _cli(*args, out):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--out", str(out)], env=_env(), timeout=600, capture_output=True,
        text=True)


def test_dryrun_cli(tmp_path, started):
    ok = _cli("--arch", "rwkv6-1.6b", "--shape", "decode_32k", out=tmp_path)
    assert ok.returncode == 0, ok.stderr[-4000:]
    r = json.loads((tmp_path / "rwkv6-1.6b__decode_32k__16x16.json")
                   .read_text())
    assert r["ok"] and r["chips"] == 256 and r["mesh"] == "16x16"
    assert r["hbm_bytes"] == 80e9 and r["fits"]
    assert r["per_device_bytes"]["argument"] > 0
    assert r["flops_per_device"] > 0 and r["collective_bytes"] > 0
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["scans"].startswith("reference")
    assert r["method"].startswith("direct")
    assert r["model_flops"] == 2.0 * r["n_active"] * 128
    again = _cli("--arch", "rwkv6-1.6b", "--shape", "decode_32k",
                 out=tmp_path)
    assert again.returncode == 0 and "[skip]" in again.stdout

    # 9 heads over 16 ranks: resharded, not refused
    heads = _cli("--arch", "smollm-135m", "--shape", "decode_32k",
                 out=tmp_path)
    assert heads.returncode == 0, heads.stdout[-4000:]
    r = json.loads((tmp_path / "smollm-135m__decode_32k__16x16.json")
                   .read_text())
    assert r["ok"] and r["fits"] and r["collective_counts"]["all-gather"]


def test_op_without_a_rule_fails_naming_it(started):
    r = _result(started, "no-rule")
    assert r["exit"] == 1
    res = r["result"]
    assert not res["ok"] and res["op"] == "aten.renorm.default"
    assert "does not have a sharding strategy" in res["error"]


def test_searchsorted_rule_gathers_the_sequence(started):
    r = _result(started, "rules")["searchsorted"]
    assert r["counts"] == {"all-gather": 1}
    assert r["placements"] == ["Shard(dim=0)", "Replicate()"]


@pytest.mark.parametrize("arch,kind", ttc.MOE_STEPS)
def test_moe_step_dispatch_on_a_fake_world(started, arch, kind):
    r = _result(started, "rules")["moe"][f"{arch}-{kind}"]
    cfg = ttc._reduced(arch)
    # one dispatch a layer, twice a layer in a train step (remat)
    layers = cfg.n_layers * (2 if kind == "train" else 1)
    assert len(r["dispatch"]) == layers
    assert all(d.get("all-gather", 0) >= 1 for d in r["dispatch"])
    total = sum(d["all-gather"] for d in r["dispatch"])
    assert r["counts"]["all-gather"] >= total


@pytest.mark.parametrize("mesh", sorted(ttc.RULE_MESHES))
def test_uneven_heads_decode_reshards(started, mesh):
    r = _result(started, "rules")["heads"][mesh]
    cfg = ttc._reduced("smollm-135m", **ttc.UNEVEN_HEADS)
    # the query view of every layer: 3 heads split no "model" axis > 1
    heads = [cfg.n_heads, cfg.resolved_head_dim]
    q = [s for s in r["reshards"] if s["shape"][-2:] == heads]
    assert len(q) == cfg.n_layers
    for s in q:
        assert s["counts"] == {"all-gather": 1}
        assert s["from"][1] == "Shard(dim=2)" and s["to"][1] == "Replicate()"
    assert r["counts"]["all-gather"] >= len(r["reshards"])


@pytest.mark.parametrize("case", ttc.SCAN_CASES, ids=ttc.scan_id)
def test_scan_extrapolation_equals_direct(started, case):
    r = _result(started, "scan-steps")[ttc.scan_id(case)]
    d, e = r["direct"], r["extrapolated"]
    assert e["method"].startswith("scan steps")
    assert e["flops"] == d["flops"] > 0
    assert e["collectives"] == d["collectives"]
    assert e["collective_bytes"] == d["collective_bytes"]
    assert abs(e["bytes"] - d["bytes"]) <= BYTES_REL * d["bytes"]
    # the peak: the direct one between the bounds that decide ``fits``,
    # and the estimate on it
    lo, hi = e["peak_bounds"]
    assert lo <= d["peak"] <= hi
    assert abs(e["peak"] - d["peak"]) <= BYTES_REL * d["peak"]


@pytest.mark.parametrize("ep", ttc.EXPERT_LAYOUTS, ids=str)
def test_moe_experts_gathered_by_their_layout(started, ep):
    """FSDP's row split of the experts' weights is gathered before the
    batched products; an expert-parallel split stays: Megatron's d_ff on
    "data" (column-parallel w_gate / w_up, row-parallel w_down) is never
    gathered away."""
    r = _result(started, "rules")["experts"][str(ep)]
    cfg = ttc._reduced("granite-moe-3b-a800m")
    assert r["flops"] > 0
    # two or three weights a layer, twice a layer in a train step (remat)
    assert len(r["calls"]) == 2 * cfg.n_layers * (
        3 if cfg.activation == "swiglu" else 2)
    for c in r["calls"]:
        rows = len(c["shape"]) - 2
        if ep == "megatron":
            assert c["to"] == c["from"]
            assert "Shard(dim=0)" in c["from"]
            assert c["from"][0] in (f"Shard(dim={rows})",
                                    f"Shard(dim={rows + 1})")
        else:
            assert c["from"][0] == f"Shard(dim={rows})"
            assert c["to"][0] == "Replicate()" and c["to"][1] == c["from"][1]
