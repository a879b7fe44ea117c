"""The port's dry-run CLI (``python -m repro_torch.launch.dryrun``) in a
subprocess, as a user runs it: a fake world of 256 ranks, meta DTensors.

* RWKV6-1.6B × decode_32k × 16 × 16 runs: ``ok``, the roofline terms, the
  per-rank bytes against the card's 80 GB and the scans it ran;
* SmolLM-135M × decode_32k fails where DTensor refuses a layout (its 9
  heads do not split 16 ways) and the result names the op: nothing is
  quietly replicated, and the CLI exits 1;
* a second run skips the combinations already written.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

from torch_parity import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _cli(*args, out):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--out", str(out)], env=env, timeout=600, capture_output=True,
        text=True)


def test_dryrun_cli(tmp_path):
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
    assert r["model_flops"] == 2.0 * r["n_active"] * 128
    again = _cli("--arch", "rwkv6-1.6b", "--shape", "decode_32k",
                 out=tmp_path)
    assert again.returncode == 0 and "[skip]" in again.stdout

    bad = _cli("--arch", "smollm-135m", "--shape", "decode_32k",
               out=tmp_path)
    assert bad.returncode == 1 and "failures: 1" in bad.stdout
    r = json.loads((tmp_path / "smollm-135m__decode_32k__16x16.json")
                   .read_text())
    assert not r["ok"] and r["op"] == "aten.view.default"
    assert "unevenly sharded" in r["error"]
