"""The engine's sharded SplitMe round on a client mesh with a ``model``
dim: the clients shard over ("pod", "data") and the ranks along "model"
replicate them, their bundled all-reduce running over the client dims'
sub-group (``engine.client_group``), the reference's rule.

Three gloo jobs of CPU processes (tests/torch_tooling_check.py
``mesh-round``): ``("data",)`` of 2 ranks, ``("data", "model")`` 2 × 2
and ``("pod", "data", "model")`` 2 × 1 × 2.  Each has 2 client shards, so
every rank of the model-axis meshes must return the 2-rank round's params
at 1e-5 of each leaf's scale (the f32 parity bound), f32 and int8 wires,
with one all-reduce a round.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_parity import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
MESHES = {"data": ["data=2"], "data-model": ["data=2", "model=2"],
          "pod-data-model": ["pod=2", "data=1", "model=2"]}
QUANTS = ["none", "int8"]


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    d = tmp_path_factory.mktemp("model_axis")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = {}
    for q in QUANTS:            # the three jobs of a wire side by side
        procs = {}
        for name, dims in MESHES.items():
            out = d / f"{name}-{q}"
            procs[(name, q)] = (out, len(dims), subprocess.Popen(
                [sys.executable, str(ROOT / "tests" /
                                     "torch_tooling_check.py"),
                 "mesh-round", str(out), q, *dims], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        for key, (out, n_dims, p) in procs.items():
            log = p.communicate(timeout=600)[0]
            assert p.returncode == 0, log.decode()[-4000:]
            res[key] = []
            for r in range(2 if n_dims == 1 else 4):
                with open(f"{out}.{r}", "rb") as f:
                    res[key].append(pickle.load(f))
    return res


def _err(got, want) -> float:
    err = 0.0
    for gw, ww in zip(got, want):
        for gl, wl in zip(gw, ww):
            for k in wl:
                scale = max(1.0, float(np.abs(wl[k]).max()))
                err = max(err, float(np.abs(gl[k] - wl[k]).max()) / scale)
    return err


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("mesh", ["data-model", "pod-data-model"])
def test_model_axis_round_equals_the_data_round(jobs, mesh, quant):
    want = jobs[("data", quant)][0]["params"]
    for r, res in enumerate(jobs[(mesh, quant)]):
        assert res["n_shards"] == 2
        assert res["all_reduces"] == 1
        assert _err(res["params"], want) <= TOL, (mesh, r)
    # the two model replicas of a client shard hold the same slab
    shards = [res["shard"] for res in jobs[(mesh, quant)]]
    assert shards == [0, 0, 1, 1]
