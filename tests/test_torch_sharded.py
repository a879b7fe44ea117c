"""The port's sharded rounds (``engine.build_sharded_round_fn``,
``all_reduce_bundle``), Step 4 on the mesh (``inversion`` with ``mesh=``,
``core/distributed.py``) and the sharded campaign (``run_campaign(mesh=)``)
on gloo jobs of CPU processes, against the JAX package on a 4-device CPU
mesh (tests/torch_sharded_check.py runs both).

Each JAX configuration runs once a module, in two subprocesses under
``XLA_FLAGS=--xla_force_host_platform_device_count=4``; the port runs one
gloo job of 4 ranks (``("data",)``) and one of 2 x 2 (``("pod", "data")``),
one torch thread a rank.  Both sides read the JAX package's draws: the
batch indices of its round keys and each shard's int8 uniforms,
``fold_in(fold_in(key, _QSALT), shard)`` (``torch_parity``).

Bounds (the reference's own):

* f32 params at 1e-5 of each leaf's largest magnitude (at least 1), losses
  at 1e-5 of theirs: the sharded round against JAX's sharded round and
  against the port's single-device round (tests/sharded_parity_check.py),
  the mesh campaign against JAX's mesh campaign and the port's gathered
  one (tests/test_campaign.py), accuracy per round at 1e-6;
* the wire formats at ``WIRE_TOL`` of tests/test_torch_quantcomm.py
  (bf16 2e-2, int8 6e-2), likewise scaled.  Measured: the bf16 wire of 4
  shards sums in bf16 in ring order (gloo, NCCL), where XLA's CPU widens
  it; the JAX round is equal to the port's, its campaign 7.8e-3 of scale
  away (1.3e-3 in the losses), within 2e-2;
* ``faults:0.3``: the guard flags and crash rows exactly; an exponent flip
  (±2^12) of a client's update amplifies the last bits (ROADMAP C 5), so
  the trajectory is held to JAX at tests/test_torch_resilience.py's
  ``CHAOS_TOL`` (1e-4 of scale: measured 1.39e-5, and the port's
  single-device campaign is as far, 1.39e-5) and to the port's gathered
  campaign at 1e-5 (measured 1.6e-7);
* the mesh resume bit for bit; Step 4 on the mesh as a function on the
  data (tests/test_distributed.py's 5e-2 and argmax agreement);
* every rank the same params, losses and accuracy bit for bit; one
  all-reduce a round and one a server layer an evaluation; one host
  transfer a rank a campaign.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.splitme_dnn import DNNConfig
from repro_torch.convert import (params_from_numpy, qstate_shard_from_numpy,
                                 qstate_shards_to_numpy)
from repro_torch.core import engine, quantcomm
from repro_torch.launch import mesh as meshes
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
import torch_sharded_check as chk

ROOT = Path(__file__).resolve().parents[1]
F32_TOL, CHAOS_TOL = 1e-5, 1e-4
WIRE_TOL = {"bf16": 2e-2, "int8": 6e-2}
ACC_TOL = 1e-6
JOB_TIMEOUT = 600
RANKS = 4


def _start(args, log, env):
    return subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_sharded_check.py")]
        + [str(a) for a in args], env=env, stdout=log, stderr=subprocess.STDOUT)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two JAX parts and the two port jobs, side by side: (JAX results,
    the 4-rank job's results a rank, the 2 x 2 job's)."""
    d = tmp_path_factory.mktemp("sharded")
    src = str(ROOT / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                 if p]))
    jax_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jobs = []
    for part in (0, 1):
        log = open(d / f"jax{part}.log", "w")
        jobs.append((_start(["jax", d / f"jax{part}.pkl", part], log,
                            jax_env), log))
    inp = chk.campaign_inputs(chk.shared_inputs())
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    for name, shape in (("port", (RANKS,)), ("pod", (2, 2))):
        log = open(d / f"{name}.log", "w")
        jobs.append((_start(["port", d / f"{name}.pkl", d / "in.pkl",
                             *shape], log, env), log))
    for proc, log in jobs:
        rc = proc.wait(timeout=JOB_TIMEOUT)
        log.close()
        if rc != 0:
            pytest.fail(f"{proc.args[1:3]} exited {rc}:\n"
                        + Path(log.name).read_text()[-6000:])
    jax_out = {}
    for part in (0, 1):
        with open(d / f"jax{part}.pkl", "rb") as f:
            jax_out.update(pickle.load(f))

    def ranks(name):
        out = []
        for r in range(RANKS):
            with open(d / f"{name}.pkl.{r}", "rb") as f:
                out.append(pickle.load(f))
        return out
    return jax_out, ranks("port"), ranks("pod"), inp


def _leaves(tree):
    return [np.asarray(l) for l in quantcomm.tree_leaves(tree)]


def _scaled_err(got, want) -> float:
    """Largest |got − want| of a tree's leaves over the leaf's largest
    magnitude (at least 1)."""
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w) and all(a.shape == b.shape for a, b in zip(g, w))
    return max(float(np.abs(a - b).max(initial=0.0))
               / max(1.0, float(np.abs(b).max(initial=0.0)))
               for a, b in zip(g, w))


def _loss_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    return float((np.abs(got[ok] - want[ok])
                  / np.maximum(1.0, np.abs(want[ok]))).max(initial=0.0))


def _tol(quant) -> float:
    return F32_TOL if quant is None else WIRE_TOL[quant]


def _assert_same_on_every_rank(results, key):
    first = results[0][key]
    for other in results[1:]:
        for a, b in zip(_leaves(first["params"]),
                        _leaves(other[key]["params"])):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.asarray(first["losses"]),
                                      np.asarray(other[key]["losses"]))


# ---------------------------------------------------------------------------
# the sharded round
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fw,quant", chk.ROUND_CASES,
                         ids=[f"{fw}-{q}" for fw, q in chk.ROUND_CASES])
def test_sharded_round_matches_jax(runs, fw, quant):
    """4 shards, 2 of 8 clients each: the port's sharded round against
    JAX's, params and losses, and under int8 each rank's error-feedback
    residual against JAX's shard (both started from one nonzero state,
    ``convert.qstate_shard_from_numpy``); every rank the same result."""
    want, port, _, _ = runs
    key = ("round", fw, quant)
    got = port[0][key]
    assert _scaled_err(got["params"], want[key]["params"]) <= _tol(quant)
    assert _loss_err(got["losses"], want[key]["losses"]) <= _tol(quant)
    _assert_same_on_every_rank(port, key)
    if quant == "int8":
        for r in range(RANKS):
            shard = port[r]["shard"]
            jq = quantcomm.tree_map(lambda l: np.asarray(l)[shard],
                                    want[key]["qstate"])
            assert _scaled_err(port[r][key]["qstate"], jq) <= _tol(quant)


@pytest.mark.parametrize("fw", [fw for fw, q in chk.ROUND_CASES
                                if q is None])
def test_sharded_round_matches_single_device(runs, fw):
    """The port's sharded round against its own single-device round on the
    same draws at 1e-5 (tests/sharded_parity_check.py's bound)."""
    _, port, _, _ = runs
    got, want = port[0][("round", fw, None)], port[0][("single", fw)]
    assert _scaled_err(got["params"], want["params"]) <= F32_TOL
    assert _loss_err(got["losses"], want["losses"]) <= F32_TOL


def test_one_all_reduce_per_sharded_round(runs):
    """Every round case, every rank: ``engine.ALL_REDUCES`` moved by
    exactly one (the bundled numerators, |A_t| and loss sums, in every
    wire format)."""
    _, port, _, _ = runs
    for r in range(RANKS):
        for fw, quant in chk.ROUND_CASES:
            assert port[r][("round", fw, quant)]["all_reduces"] == 1


# ---------------------------------------------------------------------------
# the sharded campaign
# ---------------------------------------------------------------------------

CAMPAIGN_IDS = [chk.case_id(fw, kw) for fw, kw in chk.CAMPAIGN_CASES]
FLAGS = ("skipped_per_round", "quorum_per_round", "crashed_per_round")


def _campaign_tol(kw) -> float:
    if "scenario" in kw:
        return CHAOS_TOL
    return _tol(kw.get("quant"))


@pytest.mark.parametrize("fw,kw", chk.CAMPAIGN_CASES, ids=CAMPAIGN_IDS)
def test_mesh_campaign_matches_jax(runs, fw, kw):
    """``run_campaign(mesh=)`` on 4 ranks against JAX's mesh campaign on 4
    devices (3 rounds, seeds 0 and 1, the evaluation after rounds 1 and 2
    at γ 10): schedules exactly, params and losses at the bound of the
    module docstring, accuracy per round at 1e-6, the guard flags
    exactly."""
    want, port, _, _ = runs
    key = ("campaign", chk.case_id(fw, kw))
    got = port[0][key]
    np.testing.assert_array_equal(got["a"], want[key]["a"])
    np.testing.assert_array_equal(got["E"], want[key]["E"])
    assert _scaled_err(got["params"], want[key]["params"]) <= \
        _campaign_tol(kw)
    assert _loss_err(got["losses"], want[key]["losses"]) <= _campaign_tol(kw)
    np.testing.assert_allclose(got["accuracy_per_round"],
                               want[key]["accuracy_per_round"], rtol=0,
                               atol=ACC_TOL)
    for f in FLAGS:
        if want[key][f] is None:
            assert got[f] is None
        else:
            np.testing.assert_array_equal(got[f], want[key][f])
    if "scenario" in kw:
        assert got["crashed_per_round"].sum() > 0


@pytest.mark.parametrize("fw,kw", chk.CAMPAIGN_CASES, ids=CAMPAIGN_IDS)
def test_mesh_campaign_matches_gathered(runs, fw, kw):
    """The sharded campaign against the port's gathered single-device
    campaign on the same draws: f32 at 1e-5 of scale and accuracy at 1e-6
    (tests/test_campaign.py); the wire formats at ``WIRE_TOL`` (4 shards
    quantize or round 4 partial sums, one device the whole sum)."""
    _, port, _, _ = runs
    cid = chk.case_id(fw, kw)
    got, want = port[0][("campaign", cid)], port[0][("gathered", cid)]
    tol = _tol(kw.get("quant"))
    assert _scaled_err(got["params"], want["params"]) <= tol
    assert _loss_err(got["losses"], want["losses"]) <= tol
    if kw.get("quant") is None:
        np.testing.assert_allclose(got["accuracy_per_round"],
                                   want["accuracy_per_round"], rtol=0,
                                   atol=ACC_TOL)


@pytest.mark.parametrize("fw,kw", chk.CAMPAIGN_CASES, ids=CAMPAIGN_IDS)
def test_mesh_campaign_counts_and_ranks_agree(runs, fw, kw):
    """One all-reduce a round, one a server layer an evaluation (SplitMe's
    Step 4; the baselines' evaluation has none), one host transfer a rank;
    params, losses, accuracy and flags the same on every rank, bit for
    bit; each rank's own error-feedback residual under int8."""
    _, port, _, _ = runs
    key = ("campaign", chk.case_id(fw, kw))
    n_evals = 2                               # after rounds 1 and 2
    server_layers = len(DNNConfig(**chk.CFG_KW).layer_dims) \
        - DNNConfig(**chk.CFG_KW).split_index - 1
    want_ar = chk.CAMP["ROUNDS"] + (n_evals * server_layers
                                    if fw == "splitme" else 0)
    for r in range(RANKS):
        got = port[r][key]
        assert got["all_reduces"] == want_ar
        assert got["host_transfers"] == 1
        np.testing.assert_array_equal(got["accuracy_per_round"],
                                      port[0][key]["accuracy_per_round"])
        for f in FLAGS:
            np.testing.assert_array_equal(got[f], port[0][key][f])
    _assert_same_on_every_rank(port, key)
    if kw.get("quant") == "int8":
        residuals = [_leaves(port[r][key]["qstate"]) for r in range(RANKS)]
        assert all(l.shape[0] == len(chk.CAMP["SEEDS"])
                   for l in residuals[0])
        assert any(not np.array_equal(a, b)
                   for a, b in zip(residuals[0], residuals[1]))


POD_CASES = ([("round", fw, q) for fw, q in chk.POD_ROUNDS]
             + [("campaign", chk.case_id(*chk.CAMPAIGN_CASES[i]))
                for i in chk.POD_CAMPAIGNS])


@pytest.mark.parametrize("key", POD_CASES, ids=[k[1] + "-" + str(k[-1])
                                                for k in POD_CASES])
def test_pod_data_mesh_matches(runs, key):
    """A 2 x 2 ``("pod", "data")`` mesh: rank r is shard 2·pod + data = r,
    so its rounds and campaigns equal the 4-rank ``("data",)`` job's bit for
    bit and JAX's 4-shard results at the bounds above."""
    want, port, pod, _ = runs
    assert [p["axes"] for p in pod] == [("pod", "data")] * RANKS
    assert [p["shard"] for p in pod] == list(range(RANKS))
    assert all(p["n_shards"] == RANKS for p in pod)
    quant = key[2] if key[0] == "round" else (
        "int8" if "int8" in key[1] else None)
    for a, b in zip(_leaves(pod[0][key]["params"]),
                    _leaves(port[0][key]["params"])):
        np.testing.assert_array_equal(a, b)
    assert _scaled_err(pod[0][key]["params"], want[key]["params"]) \
        <= _tol(quant)
    _assert_same_on_every_rank(pod, key)


def test_mesh_resume_with_int8_state_is_bitwise(runs):
    """FedAvg on the int8 wire over the mesh, saved every 4 of 8 rounds,
    aborted at round 4 by its hook and resumed (each rank its slice of the
    gathered error-feedback state): params, losses and every rank's
    residual equal the campaign run through, bit for bit.  The checkpoint
    holds the reference's (S, n_shards, …) layout."""
    _, port, _, _ = runs
    for r in range(RANKS):
        got = port[r]
        assert got["aborted"].startswith("CampaignAborted")
        assert got["checkpoint"] == "ckpt-r000004"
        ref, res = got["resume"]["ref"], got["resume"]["resumed"]
        for a, b in zip(_leaves((ref["params"], ref["qstate"])),
                        _leaves((res["params"], res["qstate"]))):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ref["losses"], res["losses"])
    saved = port[0]["checkpoint_qstate"]
    q = {k: v for k, v in saved.items() if k.startswith("qstate/")}
    assert q and all(v.shape[:2] == (len(chk.CAMP["SEEDS"]), RANKS)
                     for v in q.values())


def test_distributed_inversion_matches_local_and_jax(runs):
    """Step 4 on the mesh (one client a shard, 640 samples > 257 dims, γ 1):
    the recovered server as a function on the data agrees with the local
    inversion and with JAX's ``make_distributed_inversion`` (5e-2, argmax
    > 0.99, tests/test_distributed.py's bounds); one all-reduce a layer."""
    want, port, _, inp = runs
    from repro_torch.core import dnn
    cfg = DNNConfig(**chk.CFG_KW)
    flat = torch.tensor(inp["inversion"]["smashed"]).reshape(-1, 32)

    def server(params):
        with torch.no_grad():
            return dnn.server_forward(params_from_numpy(params, "cpu"),
                                      flat, cfg).numpy()
    out_d = server(port[0]["inversion"])
    for other in (port[0]["inversion_local"], want["inversion"]):
        out = server(other)
        np.testing.assert_allclose(out_d, out, rtol=5e-2, atol=5e-2)
        assert (out_d.argmax(-1) == out.argmax(-1)).mean() > 0.99
    for r in range(RANKS):
        assert port[r]["inversion_all_reduces"] == len(cfg.layer_dims) \
            - cfg.split_index - 1
        for a, b in zip(_leaves(port[r]["inversion"]),
                        _leaves(port[0]["inversion"])):
            np.testing.assert_array_equal(a, b)


def test_splitme_round_adapter_matches_single_device(runs):
    """``distributed.make_splitme_round`` (every client, E steps) against
    the port's single-device round with every client selected, at 1e-5."""
    _, port, _, inp = runs
    cfg = DNNConfig(**chk.CFG_KW)
    rd, case = inp["round"], inp[("round", "splitme", None)]
    spec = engine.make_spec("splitme", cfg, batch_size=chk.ROUND["B"],
                            masked_loss_metric=True, device="cpu")
    rf = engine.build_round_fn(spec, cfg, torch.tensor(rd["x"]),
                               torch.tensor(rd["y"]).long(),
                               e_max=chk.ROUND["E_MAX"])
    params = tuple(params_from_numpy(p, "cpu") for p in case["params"])
    want, _, _ = rf(params, torch.ones(chk.ROUND["M"]), chk.ROUND["E_MAX"],
                    torch.tensor(case["idx"]))
    assert _scaled_err(port[0]["adapter"], want) <= F32_TOL


def test_per_variant_sweep_runs_over_the_mesh(runs):
    """``run_config_sweep(mesh=, vmap_configs=False)``: each variant's
    sharded campaign equals its single-device one (1e-5, accuracy 1e-6)."""
    _, port, _, _ = runs
    for got, want in zip(port[0]["sweep"], port[0]["sweep_gathered"]):
        assert _scaled_err(got["params"], want["params"]) <= F32_TOL
        assert _loss_err(got["losses"], want["losses"]) <= F32_TOL
        np.testing.assert_allclose(got["accuracy_per_round"],
                                   want["accuracy_per_round"], rtol=0,
                                   atol=ACC_TOL)
    assert len(port[0]["sweep"]) == 2


@pytest.mark.parametrize("case,match", [
    ("divisible_round", "ValueError: n_clients=10 not divisible by the 4"),
    ("divisible_campaign", "ValueError: n_clients=10 not divisible by the 4"),
    ("cuda_mesh", "RuntimeError: a 'cuda' mesh needs"),
    ("world_size", "ValueError: a ('data',) mesh of shape (5,) needs 5"),
    ("no_scan", "ValueError: mesh (sharded rounds) requires scan=True"),
    ("vmapped_sweep", "ValueError: mesh (sharded rounds) requires "
                      "vmap_configs=False"),
])
def test_mesh_raises_as_the_reference(runs, case, match):
    """Inside the gloo job: shards that do not divide the clients (the
    reference's message), a ``cuda`` mesh with no card, a mesh that is not
    the whole process group, a loop campaign or a vmapped sweep on a
    mesh."""
    _, port, _, _ = runs
    for r in range(RANKS):
        assert port[r]["raises"][case].startswith(match), \
            port[r]["raises"][case]


def test_mesh_needs_a_process_group_and_a_device_mesh():
    """Outside a process group the mesh raises, for either device type;
    what is not a DeviceMesh is refused by the campaign and the round."""
    with pytest.raises(RuntimeError, match="process group|CUDA device"):
        meshes.make_client_mesh(1, device_type="cuda")
    with pytest.raises(RuntimeError, match="process group"):
        meshes.make_client_mesh(1, device_type="cpu")
    with pytest.raises(ValueError, match="device_type"):
        meshes.make_client_mesh(1, device_type="tpu")
    cfg = DNNConfig(**chk.CFG_KW)
    spec = engine.make_spec("fedavg", cfg, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        engine.build_sharded_round_fn(spec, cfg, object(), n_clients=4,
                                      e_max=2)
    with pytest.raises(TypeError, match="DeviceMesh"):
        engine.all_reduce_bundle({"a": torch.zeros(2)}, object())


def test_sharded_qstate_converts_both_ways(runs):
    """``convert``: the ranks' residuals of the int8 mesh campaign to the
    reference's (S, n_shards, …) layout and each shard back, exactly; the
    layout of ``init_quant_state(n_shards=)``."""
    _, port, _, _ = runs
    key = ("campaign", "fedavg-int8")
    per_rank = [quantcomm.tree_map(torch.tensor, port[r][key]["qstate"])
                for r in range(RANKS)]
    full = qstate_shards_to_numpy(per_rank)
    for r in range(RANKS):
        back = qstate_shard_from_numpy(full, r, "cpu")
        for a, b in zip(quantcomm.tree_leaves(back),
                        quantcomm.tree_leaves(per_rank[r])):
            assert torch.equal(a, b)
    cfg = DNNConfig(**chk.CFG_KW)
    spec = engine.make_spec("fedavg", cfg, quant="int8", device="cpu")
    params = spec.init_fn(torch.Generator().manual_seed(0), "cpu")
    stacked = quantcomm.tree_map(lambda v: v.expand(2, *v.shape), params)
    for got, like in zip(
            quantcomm.tree_leaves(engine.init_quant_state(
                spec, stacked, n_shards=RANKS, lead=1)),
            _leaves(full)):
        assert tuple(got.shape) == like.shape and not got.any()
    one = engine.init_quant_state(spec, params, n_shards=RANKS)
    assert all(l.shape[0] == RANKS for l in quantcomm.tree_leaves(one))
