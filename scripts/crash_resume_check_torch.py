"""Crash-resume check of the PyTorch port: SIGKILL a checkpointed campaign,
resume it, compare it with the uninterrupted one.

    PYTHONPATH=src python scripts/crash_resume_check_torch.py --device cpu
    PYTHONPATH=src python scripts/crash_resume_check_torch.py --device cuda

The parent process

1. runs the uninterrupted campaign in-process (FedAvg under ``faults:0.2``,
   24 rounds, 2 seeds, M 8, guards armed by the faults);
2. starts the same campaign as a ``--victim`` subprocess with
   ``checkpoint_every`` armed (the victim sleeps after each committed
   checkpoint, so the kill lands mid-run);
3. waits for the first committed checkpoint, then SIGKILLs the victim;
4. resumes with ``resilience.resume_campaign`` in-process and requires the
   params, losses, guard flags and per-round metrics to equal the
   uninterrupted run's bit for bit.

Exit code 0 on success; a difference or a timeout exits 1.  The victim is
this file run again with ``--victim DIR``, so both share one campaign.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROUNDS = 24
CHECKPOINT_EVERY = 4
SEEDS = (0, 1)
FRAMEWORK = "fedavg"
SCENARIO = "faults:0.2"          # crash-resume under fault injection too
SRC = Path(__file__).resolve().parents[1] / "src"


def _setup(device: str):
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.splitme_dnn import DNNConfig
    from repro_torch.core.cost import SystemParams
    from repro_torch.data import oran

    cfg = DNNConfig(name="crash-check", n_features=30, n_classes=3,
                    hidden=(16, 16, 8), split_index=1)
    sp = SystemParams(M=8, seed=0)
    X, y = oran.generate(n_per_class=120, seed=0)
    (Xtr, ytr), _ = oran.train_test_split(X, y)
    clients = oran.partition_non_iid(Xtr, ytr, sp.M, samples_per_client=16,
                                     seed=0)
    kw = dict(rounds=ROUNDS, seeds=SEEDS, K=4, E=3, scenario=SCENARIO,
              scenario_seed=1, device=device)
    return cfg, sp, clients, kw


def run_victim(ckpt_dir: str, device: str) -> None:
    """The process that is SIGKILLed: a checkpointed campaign that sleeps
    after each committed save."""
    cfg, sp, clients, kw = _setup(device)
    from repro_torch.launch import campaign
    campaign.run_campaign(FRAMEWORK, cfg, sp, clients,
                          checkpoint_every=CHECKPOINT_EVERY,
                          checkpoint_dir=ckpt_dir,
                          _checkpoint_hook=lambda r: time.sleep(0.5), **kw)


def _differences(res, ref) -> list:
    """What differs between two campaign results, bit for bit."""
    from repro_torch.core.quantcomm import tree_leaves
    bad = []
    for i, (g, w) in enumerate(zip(tree_leaves(res.params),
                                   tree_leaves(ref.params))):
        if not np.array_equal(g.cpu().numpy(), w.cpu().numpy()):
            bad.append(f"param leaf {i}")
    if not np.array_equal(res.losses, ref.losses, equal_nan=True):
        bad.append("losses")
    for name in ("skipped_per_round", "quorum_per_round",
                 "crashed_per_round"):
        if not np.array_equal(getattr(res, name), getattr(ref, name)):
            bad.append(name)
    for mr, mf in zip(res.metrics, ref.metrics):
        if repr(mr) != repr(mf):
            bad.append(f"metrics of round {mf.round}")
    return bad


def main(device: str) -> int:
    cfg, sp, clients, kw = _setup(device)
    from repro_torch.launch import campaign, resilience

    print(f"[crash-resume] uninterrupted campaign on {device} ...")
    ref = campaign.run_campaign(FRAMEWORK, cfg, sp, clients, **kw)

    with tempfile.TemporaryDirectory(prefix="crash_resume_") as ckpt_dir:
        print("[crash-resume] starting the victim subprocess ...")
        victim = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--device", device,
             "--victim", ckpt_dir])
        try:
            found = resilience.wait_for_checkpoint(ckpt_dir, timeout=300.0)
            if found is None:
                print("[crash-resume] FAIL: no checkpoint appeared in 300 s")
                return 1
            if victim.poll() is None:
                victim.send_signal(signal.SIGKILL)
                victim.wait()
                print(f"[crash-resume] SIGKILLed the victim after "
                      f"{found.name}")
            else:
                # the victim finished first: the resume then only restores
                print("[crash-resume] the victim finished before the kill; "
                      "the resume only restores")
        finally:
            if victim.poll() is None:
                victim.kill()
                victim.wait()

        cursor = int(resilience.load_checkpoint_meta(
            resilience.latest_checkpoint(ckpt_dir))["round_cursor"])
        print(f"[crash-resume] resuming from round {cursor} ...")
        res = resilience.resume_campaign(
            FRAMEWORK, cfg, sp, clients, checkpoint_dir=ckpt_dir,
            checkpoint_every=CHECKPOINT_EVERY, **kw)

    bad = _differences(res, ref)
    if bad:
        print(f"[crash-resume] FAIL: the resumed campaign differs from the "
              f"uninterrupted one: {bad}")
        return 1
    print(f"[crash-resume] OK: resumed == uninterrupted bit for bit "
          f"(params, losses, flags, metrics; skipped_rounds="
          f"{res.skipped_rounds}, crashed_rounds={res.crashed_rounds}, "
          f"resumed from round {cursor} of {ROUNDS})")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--victim", metavar="CKPT_DIR", default=None)
    ns = ap.parse_args()
    if ns.victim:
        run_victim(ns.victim, ns.device)
        sys.exit(0)
    sys.exit(main(ns.device))
