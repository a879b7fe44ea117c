"""The port's checkpoints (``repro_torch.checkpoint.io``) and checkpointed
campaigns (``repro_torch.launch.resilience``, ``run_campaign(
checkpoint_every=, checkpoint_dir=, resume=)``) on the CPU, against the
JAX package where it has the same thing.

At tests/test_resilience.py's size (DNN 30→16→16→8→3 split after layer 1,
M 8 clients of 16 samples, seeds 0 and 1, K 4, E 3).  Exact: the key
names, the schedule fingerprints (the reference's sha256 digests), the
checkpoint names and cursors, and a resumed campaign against the
uninterrupted one (params, losses, flags, error-feedback state, metrics).
The params a checkpoint holds against the reference checkpoint's at the
same cursor: 1e-5 (both npz read with numpy).
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs.splitme_dnn import DNNConfig as JDNNConfig
from repro.core.cost import SystemParams as JSystemParams
from repro.launch import campaign as jcampaign
from repro.launch import resilience as jresilience
from repro_torch.checkpoint import io
from repro_torch.configs.splitme_dnn import DNNConfig
from repro_torch.core import quantcomm
from repro_torch.core.cost import SystemParams
from repro_torch.data import oran
from repro_torch.launch import campaign, resilience
from torch_parity import (CampaignIndexReplay, jax_initial_params,
                          one_torch_thread)

_CFG = dict(name="resilience-dnn", n_features=30, n_classes=3,
            hidden=(16, 16, 8), split_index=1)
CFG, JCFG = DNNConfig(**_CFG), JDNNConfig(**_CFG)
M, N, B = 8, 16, 32
SEEDS = (0, 1)


@pytest.fixture(scope="module")
def clients():
    X, y = oran.generate(n_per_class=120, seed=0)
    (Xtr, ytr), _ = oran.train_test_split(X, y)
    return oran.partition_non_iid(Xtr, ytr, M, samples_per_client=N, seed=0)


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"params": ([{"w": torch.randn(3, 4, generator=g),
                         "b": torch.randn(4, generator=g)}],
                       [{"w": torch.randn(2, 2, generator=g)
                         .to(torch.bfloat16),
                         "b": torch.zeros(2, dtype=torch.bfloat16)}]),
            "qstate": {0: [{"w": torch.randn(5, generator=g)}]},
            "steps": torch.arange(6, dtype=torch.int64).reshape(2, 3),
            "empty": ()}


def _zeros_like(tree):
    return quantcomm.tree_map(torch.zeros_like, tree)


# ---------------------------------------------------------------------------
# io
# ---------------------------------------------------------------------------

def test_io_round_trip_and_key_names(tmp_path):
    """f32, bf16 (a uint16 view on disk), int64, nested tuples, lists and
    dicts: restored in place exactly; keys named as the reference names
    them."""
    tree = _tree()
    io.save(tmp_path / "ck", tree, metadata={"round_cursor": 3})
    like = _zeros_like(tree)
    ids = [id(t) for t in quantcomm.tree_leaves(like)]
    out = io.restore(tmp_path / "ck", like)
    assert out is like and [id(t) for t in quantcomm.tree_leaves(out)] == ids
    for a, b in zip(quantcomm.tree_leaves(out), quantcomm.tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    arrays = io.load_arrays(tmp_path / "ck")
    assert arrays["params/1/0/w"].dtype == np.uint16
    ref = jio._flatten(quantcomm.tree_map(
        lambda t: t.float().numpy() if t.dtype == torch.bfloat16
        else t.numpy(), tree))
    assert sorted(arrays) == sorted(ref) == sorted(
        ["params/0/0/b", "params/0/0/w", "params/1/0/b", "params/1/0/w",
         "qstate/0/0/w", "steps"])
    man = io.manifest(tmp_path / "ck")
    assert man["metadata"] == {"round_cursor": 3}
    assert man["keys"] == sorted(arrays)
    assert man["dtypes"]["params/1/0/w"] == "uint16"


def test_manifest_is_written_last(tmp_path, monkeypatch):
    """A save that fails after its npz leaves no manifest, and
    ``latest_checkpoint`` skips that boundary (and a ``.tmp`` sibling)."""
    tree = {"params": _tree()["params"], "qstate": ()}
    resilience.save_checkpoint(tmp_path, 2, tree, {"loss": torch.zeros(2)},
                               fingerprint="f", rounds=4, framework="x",
                               n_seeds=1)
    real = os.replace

    def fail_on_carry_manifest(src, dst):
        if str(dst).endswith("ckpt-r000004.json"):
            raise OSError("disk full")
        real(src, dst)
    monkeypatch.setattr(os, "replace", fail_on_carry_manifest)
    with pytest.raises(OSError):
        resilience.save_checkpoint(tmp_path, 4, tree,
                                   {"loss": torch.zeros(4)}, fingerprint="f",
                                   rounds=4, framework="x", n_seeds=1)
    monkeypatch.undo()
    assert (tmp_path / "ckpt-r000004.npz").exists()
    assert (tmp_path / "ckpt-r000004-buffers.json").exists()
    assert not (tmp_path / "ckpt-r000004.json").exists()
    assert resilience.latest_checkpoint(tmp_path).name == "ckpt-r000002"
    (tmp_path / "ckpt-r000006.tmp.json").write_text(json.dumps(
        {"metadata": {"round_cursor": 6}}))
    assert resilience.latest_checkpoint(tmp_path).name == "ckpt-r000002"
    assert resilience.latest_checkpoint(tmp_path / "none") is None


def test_restore_mismatch_errors_name_the_keys(tmp_path):
    tree = _tree()
    io.save(tmp_path / "ck", tree)
    other = _zeros_like(tree)
    other["extra"] = torch.zeros(1)
    del other["steps"]
    with pytest.raises(ValueError, match=r"missing keys \['extra'\], extra "
                                         r"keys \['steps'\]"):
        io.restore(tmp_path / "ck", other)
    other = _zeros_like(tree)
    other["steps"] = torch.zeros(3, 2, dtype=torch.int64)
    before = [t.clone() for t in quantcomm.tree_leaves(other)]
    with pytest.raises(ValueError, match="shape mismatch for steps"):
        io.restore(tmp_path / "ck", other)
    assert all(torch.equal(a, b) for a, b in
               zip(quantcomm.tree_leaves(other), before))


# ---------------------------------------------------------------------------
# the schedule fingerprint: the reference's digest
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,quant,trace", [
    ("splitme", None, None), ("fedavg", "int8", None),
    ("fedavg", None, "faults:0.2")])
def test_schedule_fingerprint_matches_reference(name, quant, trace):
    kw = dict(K=4, E=3, quant=quant, n_samples_per_client=N,
              scenario=trace, scenario_seed=1)
    _, sched = campaign.plan_schedule(name, SystemParams(M=M, seed=0), CFG,
                                      12, **kw)
    _, jsched = jcampaign.plan_schedule(name, JSystemParams(M=M, seed=0),
                                        JCFG, 12, **kw)
    do_eval = np.zeros(12, bool)
    do_eval[3::4] = True
    for every in (3, 4):
        got = resilience.schedule_fingerprint(
            name, (1, 0), sched, do_eval=do_eval, quant_mode=quant or "none",
            checkpoint_every=every)
        want = jresilience.schedule_fingerprint(
            name, (1, 0), jsched, do_eval=do_eval.astype(np.float32),
            quant_mode=quant or "none", checkpoint_every=every)
        assert got == want
    assert got != resilience.schedule_fingerprint(
        name, (0, 2), sched, do_eval=do_eval, quant_mode=quant or "none",
        checkpoint_every=4)


# ---------------------------------------------------------------------------
# checkpointed campaigns
# ---------------------------------------------------------------------------

def _run(clients, name="splitme", **kw):
    kw = dict(dict(rounds=8, seeds=SEEDS, K=4, E=3, device="cpu"), **kw)
    return campaign.run_campaign(name, CFG, SystemParams(M=M, seed=0),
                                 clients, **kw)


def test_checkpoints_match_the_reference(clients, tmp_path):
    """The same checkpointed campaign in both packages (SplitMe, 6 rounds,
    every 4: cursors 4 and 6) writes the same files, and each carry holds
    the reference's params (and loss rows) at 1e-5."""
    kw = dict(rounds=6, seeds=SEEDS, checkpoint_every=4, test_data=None)
    jcampaign.run_campaign("splitme", JCFG, JSystemParams(M=M, seed=0),
                           clients, checkpoint_dir=tmp_path / "jax", **kw)
    campaign.run_campaign(
        "splitme", CFG, SystemParams(M=M, seed=0), clients, device="cpu",
        checkpoint_dir=tmp_path / "port",
        params=jax_initial_params("splitme", JCFG, SEEDS),
        index_source=CampaignIndexReplay(SEEDS, M, B, N), **kw)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert [n for n in names if n.endswith(".json")
            and "buffers" not in n] == ["ckpt-r000004.json",
                                        "ckpt-r000006.json"]
    for tag in ("ckpt-r000004", "ckpt-r000006"):
        want = np.load(tmp_path / "jax" / f"{tag}.npz")
        got = np.load(tmp_path / "port" / f"{tag}.npz")
        params = sorted(k for k in got.files if k.startswith("params/"))
        assert params == sorted(k for k in want.files
                                if k.startswith("params/"))
        assert "params/0/0/w" in params and "params/1/0/b" in params
        for k in params:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)
        cursor = int(tag[-6:])
        meta = resilience.load_checkpoint_meta(tmp_path / "port" / tag)
        assert meta == {k: v for k, v in jresilience.load_checkpoint_meta(
            tmp_path / "jax" / tag).items()}
        wb = jio.load_arrays(tmp_path / "jax" / f"{tag}-buffers")
        gb = io.load_arrays(tmp_path / "port" / f"{tag}-buffers")
        assert gb["loss"].shape == wb["loss"].shape == (cursor, 2, 2)
        np.testing.assert_allclose(gb["loss"], wb["loss"], rtol=0, atol=1e-5)


def _abort_at(cursor):
    def hook(r):
        if r >= cursor:
            raise resilience.CampaignAborted(f"abort at round {r}")
    return hook


def _assert_same(a, b):
    for x, y in zip(quantcomm.tree_leaves(a.params),
                    quantcomm.tree_leaves(b.params)):
        assert torch.equal(x, y)
    qa, qb = quantcomm.tree_leaves(a.qstate), quantcomm.tree_leaves(b.qstate)
    assert len(qa) == len(qb) and all(torch.equal(x, y)
                                      for x, y in zip(qa, qb))
    np.testing.assert_array_equal(a.losses, b.losses)
    for f in ("skipped_per_round", "quorum_per_round", "crashed_per_round",
              "accuracy_per_round"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert [repr(m) for m in a.metrics] == [repr(m) for m in b.metrics]


@pytest.mark.parametrize("name,kw,every,abort", [
    ("splitme", {}, 3, 6),
    ("fedavg", dict(quant="int8"), 4, 4),
    # scripts/crash_resume_check_torch.py's campaign: 24 rounds, with
    # rollbacks and a crash round on both sides of the abort
    ("fedavg", dict(scenario="faults:0.2", scenario_seed=1, rounds=24), 4,
     12)],
    ids=["splitme-f32", "fedavg-int8", "fedavg-faults"])
def test_resume_equals_uninterrupted_bit_for_bit(clients, tmp_path, name,
                                                 kw, every, abort):
    """Aborted by the checkpoint hook at a boundary and resumed: params,
    losses, accuracy, flags, error-feedback state and metrics equal the
    uninterrupted campaign's bit for bit."""
    X, y = oran.generate(n_per_class=120, seed=0)
    _, test = oran.train_test_split(X, y)
    kw = dict(dict(rounds=8), **kw, name=name, test_data=test, eval_every=2,
              eval_gamma=10.0)
    ref = _run(clients, **kw)
    with pytest.raises(resilience.CampaignAborted):
        _run(clients, checkpoint_every=every, checkpoint_dir=tmp_path,
             _checkpoint_hook=_abort_at(abort), **kw)
    found = resilience.latest_checkpoint(tmp_path)
    assert found.name == resilience.checkpoint_tag(abort)
    kw.pop("name")
    res = resilience.resume_campaign(
        name, CFG, SystemParams(M=M, seed=0), clients,
        checkpoint_dir=tmp_path, checkpoint_every=every, seeds=SEEDS, K=4,
        E=3, device="cpu", **kw)
    _assert_same(res, ref)
    assert np.isnan(res.round_ms[:abort]).all()
    assert np.isfinite(res.round_ms[abort:]).all()
    if "scenario" in kw:
        assert ref.skipped_rounds > 0 and ref.crashed_rounds > 0
    if "quant" in kw:
        assert len(quantcomm.tree_leaves(ref.qstate)) > 0


def test_fingerprint_mismatch_refuses_resume(clients, tmp_path):
    _run(clients, name="fedavg", rounds=4, checkpoint_every=2,
         checkpoint_dir=tmp_path)
    with pytest.raises(ValueError, match="fingerprint"):
        resilience.resume_campaign(
            "fedavg", CFG, SystemParams(M=M, seed=0), clients,
            checkpoint_dir=tmp_path, checkpoint_every=2, rounds=4,
            seeds=(0, 2), K=4, E=3, device="cpu")
    # an empty directory: a fresh, still checkpointed, run
    res = resilience.resume_campaign(
        "fedavg", CFG, SystemParams(M=M, seed=0), clients,
        checkpoint_dir=tmp_path / "new", checkpoint_every=2, rounds=4,
        seeds=SEEDS, K=4, E=3, device="cpu")
    assert resilience.latest_checkpoint(tmp_path / "new").name == \
        "ckpt-r000004"
    assert np.isfinite(res.round_ms).all()


@pytest.mark.parametrize("kw,match", [
    (dict(strict_transfers=True), "strict_transfers"),
    (dict(scan=False), "scan=True")])
def test_checkpointing_excludes_strict_transfers_and_the_loop(
        clients, tmp_path, kw, match):
    with pytest.raises(ValueError, match=match):
        _run(clients, checkpoint_every=2, checkpoint_dir=tmp_path, **kw)
    assert not list(tmp_path.iterdir())
