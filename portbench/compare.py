"""The comparison that decides ``correct``: the sampled lanes of the window's
calls, as the timed path produced them, against the plain reference run on
the same inputs, seeds and plan.

Numbers, each over the sampled lanes:

* ``schedule``: the largest difference between the program's plan (every
  call's selection, bandwidth fractions and E) and the reference's.
* ``loss``: the median over the lanes of a lane's worst loss gap over its
  first ``rounds`` rounds (all without ``rounds``); a gap is a phase's
  round loss off the reference's, as a share of the larger of the
  reference's and the lane's median loss of that phase.  The median,
  because a lane's trajectory parts from the reference's now and then
  (a ReLU unit at 0 flips and the SGD amplifies it), and a median of the
  lanes stays steady where their maximum does not.
* ``loss_worst``: the worst lane's worst gap over its first ``rounds``
  rounds (all without ``rounds``), against faults that strike a few lanes.
* ``params``: the final params, the norm of a leaf's difference as a share
  of the larger of that leaf's and the median leaf's norm; the worst lane.
* ``acc_judged``: test samples by which the program's final accuracy
  differs from the reference's evaluation (Step 4 and the test forward)
  of the program's own final params; the worst lane.
* ``acc_traj``: test samples by which the program's accuracy at an
  evaluating round among the first ``rounds`` differs from the
  reference's at that round; the worst lane.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

NUMBERS = ("schedule", "loss", "loss_worst", "params", "acc_judged",
           "acc_traj")
# how a number's per-lane values make the run's value: the worst lane,
# but the loss's median
OVER = {"loss": np.median}


def lanes_of_reference(out: dict, seeds, rounds: int) -> List[dict]:
    """A reference campaign's outputs as lanes, in the program's form."""
    lanes = []
    for i, s in enumerate(seeds):
        acc_r = np.full(rounds, np.nan)
        for r, a in out["accuracy"].items():
            acc_r[r] = a[i]
        lanes.append({
            "seed": s, "losses": out["losses"][i], "acc_rounds": acc_r,
            "accuracy": acc_r[rounds - 1],
            "params": tuple([{k: t[i:i + 1].cpu() for k, t in layer.items()}
                             for layer in half] for half in out["params"])})
    return lanes


def round_gaps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Each round's worst phase gap of a lane's (rounds, phases) losses."""
    scale = np.maximum(np.abs(want), np.median(np.abs(want), axis=0))
    return (np.abs(got - want) / scale).max(-1)


def params_gap(got, want) -> float:
    """The worst leaf's norm of difference over the larger of the leaf's
    and the median leaf's norm."""
    g = [l[k].double() for half in got for l in half for k in ("w", "b")]
    w = [l[k].double() for half in want for l in half for k in ("w", "b")]
    scales = [float(t.norm()) for t in w]
    med = float(np.median(scales))
    return max(float((a - b).norm()) / max(s, med)
               for a, b, s in zip(g, w, scales))


def _samples(share: float, n_test: int) -> float:
    """A gap in accuracy as a count of test samples (inf or NaN kept)."""
    return float(round(share * n_test)) if np.isfinite(share) else share


def lane_gaps(got: List[dict], want: List[dict], judged: np.ndarray,
              n_test: int, rounds: Dict[str, int]) -> Dict[str, List[float]]:
    """Each number's value for each pair of lanes (``got`` the program's
    or the control's, ``want`` the reference's of the same seeds);
    ``judged`` the reference's accuracy of each ``got`` lane's params;
    ``rounds`` the first rounds that ``loss``, ``loss_worst`` and
    ``acc_traj`` span.
    ``loss_by_round`` holds each lane's gap a round, for the readings."""
    out = {k: [] for k in NUMBERS if k != "schedule"}
    out["loss_by_round"] = []
    for g, w, j in zip(got, want, judged):
        gaps = round_gaps(g["losses"], w["losses"])
        out["loss_by_round"].append(gaps.tolist())
        out["loss"].append(float(gaps[:rounds.get("loss")].max()))
        out["loss_worst"].append(
            float(gaps[:rounds.get("loss_worst")].max()))
        out["params"].append(params_gap(g["params"], w["params"]))
        out["acc_judged"].append(_samples(abs(g["accuracy"] - j), n_test))
        ev = np.isfinite(w["acc_rounds"])
        ev[rounds.get("acc_traj") or len(ev):] = False
        gr = np.asarray(g["acc_rounds"], np.float64)
        gap = float(np.max(np.abs(np.where(np.isfinite(gr[ev]), gr[ev],
                                           np.inf) - w["acc_rounds"][ev]),
                           initial=0.0))
        out["acc_traj"].append(_samples(gap, n_test))
    return out


def schedule_gap(got, want) -> float:
    a, b, E = got
    if a.shape != want["a"].shape or E.shape != want["E"].shape:
        return float("inf")
    return float(max(np.abs(a - want["a"]).max(), np.abs(b - want["b"]).max(),
                     np.abs(E.astype(np.int64) - want["E"]).max()))


def stacked(params_list):
    """Lanes' (1, ...) params stacked on their leading dim."""
    import torch
    return tuple([{k: torch.cat([p[h][l][k] for p in params_list])
                   for k in ("w", "b")} for l in range(len(params_list[0][h]))]
                 for h in range(len(params_list[0])))


def rounds_of(checks: dict) -> Dict[str, int]:
    """The round prefixes the checks give their numbers."""
    return {k: v["rounds"] for k, v in checks["numbers"].items()
            if "rounds" in v}


def readings(cfg: dict, traffic: dict, inputs, calls: List[dict], device,
             rounds: Dict[str, int]) -> Dict[str, List[float]]:
    """Every number's per-lane values over the window's sampled lanes."""
    import torch
    from portbench import reference as ref
    data = ref.device_data({"clients": inputs.clients, "test": inputs.test},
                           cfg["model"]["n_classes"], device)
    n_test, R = len(inputs.test[1]), traffic["rounds"]
    deploys = [dict(cfg["deployment"], **v)
               for v in traffic.get("variants", [{}])]
    n = inputs.clients["x"].shape[1]
    plans = [ref.schedule(cfg, d, R, n)[0] for d in deploys]
    out = {"schedule": [schedule_gap(s[:3], plans[v]) for c in calls
                        for v, s in enumerate(c["schedules"])]}
    # the reference evaluates only the rounds that acc_traj compares
    evals = [r for r in range(R) if calls[0]["do_eval"][r]
             and r < rounds.get("acc_traj", 0)]
    for v, dep in enumerate(deploys):
        got = [k for c in calls for k in c["kept"] if k["variant"] == v]
        if not got:
            continue
        seeds = [k["seed"] for k in got]
        mine = ref.campaign(cfg, dep, R, seeds, data, eval_rounds=evals)
        want = lanes_of_reference(mine, seeds, R)
        del mine
        judged = ref.evaluate(cfg, tuple(
            [{k: t.to(device) for k, t in l.items()} for l in half]
            for half in stacked([k["params"] for k in got])), data)
        for k, vals in lane_gaps(got, want, judged, n_test,
                                 rounds).items():
            out.setdefault(k, []).extend(vals)
        if device != "cpu":
            torch.cuda.empty_cache()
    return out


def check(cfg: dict, traffic: dict, checks: dict, inputs, calls, device
          ) -> Dict[str, dict]:
    """The numbers the cell's checks name, each beside its limit."""
    want = checks["numbers"]
    got = readings(cfg, traffic, inputs, calls, device, rounds_of(checks))
    return {k: {"value": float(OVER.get(k, np.max)(got.get(k) or [np.nan])),
                "limit": want[k]["limit"]} for k in NUMBERS if k in want}
