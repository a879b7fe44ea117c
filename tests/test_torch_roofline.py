"""The port's roofline (``repro_torch.roofline.analysis``) and its
finite-difference pass (``repro_torch.launch.roofline_run``) against the
JAX package's formulas.

* ``CollectiveOp.wire_time`` and ``analyze`` equal the reference's ring
  formulas and terms when given the reference's (TPU) constants; the
  port's own constants are the card's, and a group's link is NVLink
  within one node's 8 ranks, else the inter-node links;
* ``model_flops_estimate`` equals the reference's exactly;
* one rank's FLOPs of a sharded matmul are its local product's
  (``CostCounter`` under DTensor, a fake 16 × 16 world in a subprocess);
* the 1/2-unit extrapolation equals the direct full-depth count: FLOPs and
  collectives exactly, bytes within ``BYTES_REL`` (a few ops, such as the
  per-layer sums of the loss, are not linear in depth).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs.base import INPUT_SHAPES as REF_SHAPES
from repro.configs.base import get_config as ref_config
from repro.launch.mesh import HBM_BW, ICI_LINK_BW, PEAK_FLOPS_BF16
from repro.roofline import analysis as ra
from repro_torch.configs.base import INPUT_SHAPES, get_config, list_configs
from repro_torch.launch import mesh as tmesh
from repro_torch.roofline import analysis as ta
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
import torch_tooling_check as chk

ROOT = Path(__file__).resolve().parents[1]
KINDS = ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute"]
BYTES_REL = 2e-2


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("group", [1, 2, 8, 16, 256])
def test_wire_time_matches_reference(kind, group):
    for nbytes in (4, 1000, 558092, 10 ** 9):
        want = ra.CollectiveOp(kind, nbytes, group, nbytes // 4).wire_seconds
        got = ta.CollectiveOp(kind, nbytes, group, nbytes // 4).wire_time(
            ICI_LINK_BW)
        assert got == want


def test_links_of_a_group():
    """NVLink inside one node's block of 8 consecutive ranks, the
    inter-node links across blocks."""
    assert ta.link_bandwidth((0, 1, 2, 3, 4, 5, 6, 7), 8) == tmesh.NVLINK_BW
    assert ta.link_bandwidth((8, 12), 2) == tmesh.NVLINK_BW
    assert ta.link_bandwidth((7, 8), 2) == tmesh.INTER_NODE_BW
    assert ta.link_bandwidth(tuple(range(0, 256, 16)), 16) \
        == tmesh.INTER_NODE_BW
    assert ta.link_bandwidth(None, 8) == tmesh.NVLINK_BW
    assert ta.link_bandwidth(None, 16) == tmesh.INTER_NODE_BW
    op = ta.CollectiveOp("all-reduce", 2_232_368, 4, 558_092, (0, 1, 2, 3))
    assert op.wire_seconds == op.wire_time(tmesh.NVLINK_BW)
    # the data-sheet constants, not the TPU's
    assert (tmesh.PEAK_BF16, tmesh.PEAK_BYTES, tmesh.NVLINK_BW,
            tmesh.INTER_NODE_BW, tmesh.HBM_BYTES) == (
        989e12, 3.35e12, 450e9, 50e9, 80e9)


def _hlo(ops):
    """HLO lines the reference's parser reads back as ``ops``."""
    lines = []
    for i, (kind, n, group) in enumerate(ops):
        lines.append(f"  %c{i} = f32[{n}]{{0}} {kind}(f32[{n}]{{0}} %x), "
                     f"replica_groups=[{256 // group},{group}]<=[256]")
    return "\n".join(lines)


def test_analyze_matches_reference():
    ops = [("all-reduce", 139523, 16), ("all-gather", 4096, 16),
           ("reduce-scatter", 256, 2), ("all-to-all", 1024, 16),
           ("collective-permute", 32768, 2), ("all-reduce", 7, 256)]
    hlo = _hlo(ops)
    assert [(c.kind, c.result_bytes, c.group_size)
            for c in ra.parse_collectives(hlo)] == [
        (k, 4 * n, g) for k, n, g in ops]
    colls = [ta.CollectiveOp(k, 4 * n, g, n) for k, n, g in ops]
    cost = {"flops": 3.5e15, "bytes accessed": 2.25e12}
    mem = ta.MemoryStats(1e9, 2e9, 3e9)
    cfg, shape = ref_config("qwen3-14b"), REF_SHAPES["train_4k"]
    want = ra.analyze("qwen3-14b", "train_4k", "16x16", 256, cost, hlo,
                      model_flops=ra.model_flops_estimate(cfg, shape),
                      memory_stats=mem).to_dict()
    got = ta.analyze("qwen3-14b", "train_4k", "16x16", 256, cost, colls,
                     model_flops=ta.model_flops_estimate(
                         get_config("qwen3-14b"), INPUT_SHAPES["train_4k"]),
                     memory_stats=mem, peak_flops=PEAK_FLOPS_BF16,
                     mem_bw=HBM_BW, link_bw=ICI_LINK_BW).to_dict()
    assert got == want
    own = ta.analyze("q", "s", "m", 256, cost, colls)
    assert own.compute_s == 3.5e15 / tmesh.PEAK_BF16
    assert own.memory_s == 2.25e12 / tmesh.PEAK_BYTES
    assert ta.peak_flops_for("float32") == tmesh.PEAK_FP32
    assert ta.peak_flops_for("bfloat16") == tmesh.PEAK_BF16


@pytest.mark.parametrize("arch", list_configs())
def test_model_flops_estimate_matches_reference(arch):
    for name in INPUT_SHAPES:
        assert ta.model_flops_estimate(get_config(arch), INPUT_SHAPES[name]) \
            == ra.model_flops_estimate(ref_config(arch), REF_SHAPES[name])


def _run(check):
    out = Path(os.environ.get("TMPDIR", "/tmp")) / f"{check}_{os.getpid()}.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(ROOT / "tests" /
                                               "torch_tooling_check.py"),
                           check, str(out)], env=env, timeout=900,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    try:
        return json.loads(out.read_text())
    finally:
        out.unlink()


def test_sharded_matmul_counts_the_local_product():
    """(64, 1024) batch-sharded @ (1024, 512) on the 16 × 16 fake world:
    one rank's FLOPs are its local product's, 2·m·k·n of the local
    shapes, not the global 67,108,864."""
    r = _run("toy-matmul")
    (m, n) = r["local_out"]
    k = r["b_local"][0]
    assert r["flops"] == 2 * m * k * n < 2 * 64 * 1024 * 512
    assert r["flops"] == 2 * 64 * 64 * 32


@pytest.fixture(scope="module")
def extrapolated():
    return _run("extrapolate")


@pytest.mark.parametrize("case", [chk.extrap_id(c) for c in chk.EXTRAP_CASES])
def test_extrapolation_equals_full_depth(extrapolated, case):
    """A reduced config at 4-5 layers (2 × 2 fake world): the 1/2-unit
    extrapolation against the direct count of the same depth."""
    r = extrapolated[case]
    d, e = r["direct"], r["extrapolated"]
    assert e["flops"] == d["flops"] > 0
    assert e["coll_counts"] == d["coll_counts"]
    assert e["coll_bytes"] == d["coll_bytes"]
    assert abs(e["bytes"] - d["bytes"]) <= BYTES_REL * d["bytes"]
