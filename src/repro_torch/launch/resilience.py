"""Fault-tolerant campaigns: the failure model, checkpoints and resume;
port of ``repro.launch.resilience``.

FAILURE MODEL
=============

* **Process death** (SIGKILL, preemption, power loss): checkpoints.  With
  ``checkpoint_every`` and ``checkpoint_dir`` the campaign persists its
  carry — the seed-stacked params, the int8 error-feedback ``qstate`` and
  the device metric buffers of the rounds done — after each round r with
  (r + 1) % every == 0 and after the last, through
  ``repro_torch.checkpoint.io`` (atomic: the json manifest is renamed into
  place last).  ``resume_campaign`` replans the schedule, checks it against
  the checkpoint's fingerprint, copies the carry into the campaign's state
  tensors and runs the remaining rounds.  The port has no key chain to
  save: every round's batch indices and int8 uniforms are drawn from the
  seeds before the first round, so a resumed campaign draws them again and
  skips the rounds done.  Resumed equals uninterrupted, bit for bit.
* **Poisoned client updates** (NaN uploads), from the ``faults:p`` trace
  (``repro_torch.core.scenario``): the non-finite rollback
  (``RoundGuards.nonfinite``) holds the previous params and error-feedback
  state of the seed whose aggregate is not finite
  (``CampaignResult.skipped_rounds``).
* **Corrupted wire payloads** (an exponent flip, a ±2^12 gain on a
  client's upload): bounded by the optional per-client norm clip
  (``RoundGuards.clip_norm``) where the update is quantized for the wire.
* **Server crashes** (the round's aggregate never lands), the trace's
  ``crash`` channel: the round is held (params and error-feedback state
  keep their values, the clients' draws are still consumed, the loss row
  is NaN; ``crashed_rounds``).
* **Cohort collapse**: ``RoundGuards.min_clients`` holds a round whose
  realized cohort is smaller (``quorum_rounds``).

The guards are tensor operations inside the round (``engine._round_core``
and ``_gathered_core``), so a guarded fault campaign is still one CUDA
graph a round shape with one device→host transfer.  A checkpoint save is
an explicit extra pull, which is why checkpoints exclude
``strict_transfers``.

CHECKPOINT FILES
================

In ``checkpoint_dir`` each boundary at round cursor r writes, in this
order:

* ``ckpt-r{r:06d}-buffers.npz`` / ``.json``: the flat metric buffers
  (``loss``, and ``acc`` / ``skipped`` / ``quorum`` where the campaign has
  them) of rounds ``[0, r)``;
* ``ckpt-r{r:06d}.npz`` / ``.json``: the carry ``{"params", "qstate"}``
  with the metadata ``{fingerprint, round_cursor, rounds, framework,
  n_seeds}``.  This manifest is the commit point: ``latest_checkpoint``
  only picks a boundary whose carry manifest exists, and the buffers are
  written before it.

The fingerprint hashes what the replanned schedule must reproduce
(framework, seeds, the realized A_t / b_t / E_t, the eval mask, the wire
format, the fault channels and ``checkpoint_every``), with the reference's
digest for the same plan.
"""
from __future__ import annotations

import hashlib
import json
import time
from pathlib import Path
from typing import Optional

import numpy as np

from repro_torch.checkpoint import io
from repro_torch.core.engine import RoundGuards  # re-export: the guard knobs

__all__ = ["RoundGuards", "CampaignAborted", "schedule_fingerprint",
           "checkpoint_tag", "latest_checkpoint", "save_checkpoint",
           "load_checkpoint_meta", "resume_campaign", "wait_for_checkpoint"]


class CampaignAborted(RuntimeError):
    """Raised by a checkpoint hook to stop a campaign in-process; the
    checkpoints on disk are complete and the campaign can resume."""


def checkpoint_tag(round_cursor: int) -> str:
    return f"ckpt-r{round_cursor:06d}"


def schedule_fingerprint(framework: str, seeds, sched, *, do_eval,
                         quant_mode: str, checkpoint_every: int,
                         extra=()) -> str:
    """sha256 of everything a resume must replan identically (module
    docstring); ``sched`` is a ``campaign.RoundSchedule`` or a
    ``campaign.PopulationSchedule`` (whose trace has no fault channels).
    ``extra`` appends further plan arrays, each hashed as f64: the
    population runner passes its per-round cohort ids and ``m_t``, so a
    resume against a drifted cohort plan is refused."""
    h = hashlib.sha256()
    h.update(framework.encode())
    h.update(np.asarray(sorted(int(s) for s in seeds), np.int64).tobytes())
    h.update(quant_mode.encode())
    h.update(np.asarray(int(checkpoint_every), np.int64).tobytes())
    for arr in (sched.a, sched.b, sched.E, do_eval):
        h.update(np.ascontiguousarray(np.asarray(arr, np.float64)).tobytes())
    tr = sched.trace
    for name in ("poison", "crash", "wire_gain"):
        ch = getattr(tr, name, None) if tr is not None else None
        h.update(b"\0" if ch is None else
                 np.ascontiguousarray(np.asarray(ch, np.float64)).tobytes())
    for arr in extra:
        h.update(np.ascontiguousarray(np.asarray(arr, np.float64)).tobytes())
    return h.hexdigest()


def save_checkpoint(checkpoint_dir, round_cursor: int, state, buffers,
                    *, fingerprint: str, rounds: int, framework: str,
                    n_seeds: int) -> Path:
    """Persist one boundary: the buffers first, the carry's manifest last.
    ``state`` is ``{"params", "qstate"}``, ``buffers`` a flat dict of metric
    rows of rounds ``[0, round_cursor)``.  Returns the carry's path
    (without suffix, as ``io`` takes it)."""
    d = Path(checkpoint_dir)
    tag = checkpoint_tag(round_cursor)
    io.save(d / (tag + "-buffers"), dict(buffers),
            metadata={"round_cursor": round_cursor})
    io.save(d / tag, state, metadata={
        "fingerprint": fingerprint, "round_cursor": round_cursor,
        "rounds": rounds, "framework": framework, "n_seeds": n_seeds})
    return d / tag


def latest_checkpoint(checkpoint_dir) -> Optional[Path]:
    """The committed checkpoint with the highest round cursor in
    ``checkpoint_dir``, or None.  A torn tail (a ``.tmp`` sibling, a
    missing payload or buffers file, an unreadable manifest) disqualifies
    only its own boundary."""
    d = Path(checkpoint_dir)
    if not d.is_dir():
        return None
    best = None
    for man in sorted(d.glob("ckpt-r*.json")):
        if man.stem.endswith("-buffers") or ".tmp" in man.name:
            continue
        base = man.with_suffix("")
        buf = base.with_name(base.name + "-buffers")
        if not (base.with_suffix(".npz").exists()
                and buf.with_suffix(".npz").exists()
                and buf.with_suffix(".json").exists()):
            continue
        try:
            cursor = int(io.manifest(base)["metadata"]["round_cursor"])
        except (json.JSONDecodeError, KeyError, ValueError):
            continue
        if best is None or cursor > best[0]:
            best = (cursor, base)
    return best[1] if best else None


def load_checkpoint_meta(path) -> dict:
    """The metadata of a carry checkpoint's manifest."""
    return io.manifest(path)["metadata"]


_POLL_S = 0.05


def wait_for_checkpoint(checkpoint_dir, *,
                        timeout: float = 120.0) -> Optional[Path]:
    """Wait until ``checkpoint_dir`` holds a committed checkpoint; None
    after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        found = latest_checkpoint(checkpoint_dir)
        if found is not None:
            return found
        time.sleep(_POLL_S)
    return None


def resume_campaign(framework, cfg, sp, client_data, *, checkpoint_dir,
                    checkpoint_every: int, **kwargs):
    """``campaign.run_campaign(..., resume=True)`` from ``checkpoint_dir``:
    the replan, the fingerprint check, the restore and the skip of the
    rounds done.  Without a committed checkpoint it is a fresh (still
    checkpointed) run."""
    from repro_torch.launch.campaign import run_campaign
    return run_campaign(framework, cfg, sp, client_data,
                        checkpoint_dir=checkpoint_dir,
                        checkpoint_every=checkpoint_every, resume=True,
                        **kwargs)
