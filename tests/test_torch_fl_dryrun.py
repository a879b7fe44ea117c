"""The paper's headline claim as a structural check on the port:
``repro_torch.launch.fl_dryrun.lower_round`` on a fake world of 8
(``("data", "model")`` 4 × 2) against the reference's ``lower_round``
lowered onto 8 XLA CPU devices, the same mesh, M 16, n 16, E 1 and 3.

SplitMe (three wires), vanilla SFL and Step 4: the collectives' counts,
bytes and wire bits are EQUAL.  One exception is the reference's (ROADMAP
C): under the bf16 wire XLA's CPU passes widen the all-reduce back to
f32, so the reference's HLO prints f32 bytes while the port's all-reduce
carries bf16, half of them; the wire bits (elements × 16) agree.  Each
side runs once a module, in a subprocess (tests/torch_tooling_check.py).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.core import engine
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
import torch_tooling_check as chk

ROOT = Path(__file__).resolve().parents[1]
IDS = [chk.fl_case_id(*c) for c in chk.FL_CASES]


def _run(check, env):
    out = Path(os.environ.get("TMPDIR", "/tmp")) / f"{check}_{os.getpid()}.json"
    proc = subprocess.run([sys.executable, str(ROOT / "tests" /
                                               "torch_tooling_check.py"),
                           check, str(out)], env=env, timeout=600,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    try:
        return json.loads(out.read_text())
    finally:
        out.unlink()


@pytest.fixture(scope="module")
def both():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    jax_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
    return _run("fl-jax", jax_env), _run("fl-port", env)


@pytest.mark.parametrize("case", IDS)
def test_collectives_equal_the_reference(both, case):
    ref, port = both
    want, got = ref[case], port[case]
    assert got["counts"] == want["counts"]
    assert got["comm_bits"] == want["comm_bits"]
    assert got["quant"] == want["quant"]
    if want["quant"] == "bf16":
        # the reference caveat: XLA's CPU HLO prints the bf16 all-reduce
        # as f32; the port's carries bf16
        assert got["collective_bytes"] == want["collective_bytes"] / 2
    else:
        assert got["collective_bytes"] == want["collective_bytes"]


def test_the_claim(both):
    """SplitMe: one all-reduce a round, its bytes constant in E; SFL: 2E
    boundary permutes beside one bundled all-reduce of its 20 leaves, its
    bytes growing with E; Step 4: one all-reduce a server layer (8); the
    bf16 wire halves the bits and int8 quarters them."""
    _, p = both
    for E in (1, 3):
        assert p[f"splitme-E{E}-f32"]["counts"] == {"all-reduce": 1}
        assert p[f"sfl-E{E}-f32"]["counts"] == {"collective-permute": 2 * E,
                                                "all-reduce": 1}
    assert (p["splitme-E1-f32"]["collective_bytes"]
            == p["splitme-E3-f32"]["collective_bytes"])
    assert p["sfl-E3-f32"]["collective_bytes"] > p["sfl-E1-f32"][
        "collective_bytes"]
    assert p["inversion-E1-f32"]["counts"] == {"all-reduce": 8}
    base = p["splitme-E1-f32"]["comm_bits"]
    assert p["splitme-E1-bf16"]["comm_bits"] == base / 2
    assert p["splitme-E1-int8"]["comm_bits"] == base / 4
    # (4 clients, 32 samples, 256 smashed features) f32 a permute
    permute = (p["sfl-E3-f32"]["collective_bytes"]
               - p["sfl-E1-f32"]["collective_bytes"]) / 4
    assert permute == 4 * 32 * 256 * 4


def test_mesh_checks_take_a_model_axis():
    """The engine's mesh checks take a trailing ``model`` dim (the
    reference's rule); other dims are refused."""
    assert ("data", "model") in engine._MESH_DIMS
    assert ("pod", "data", "model") in engine._MESH_DIMS
    assert ("model", "data") not in engine._MESH_DIMS
