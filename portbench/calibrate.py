"""The readings that a cell's limits are set from (not run by the
benchmark's own runs): for each ``--seed``, one call of the cell's timed
path with every lane compared to the plain reference (the lower
readings), and the control and the planted faults in the program's place
on ``--control-lanes`` lanes (the upper readings):

* ``control``: the reference with its float32 matmuls in TF32, the
  precision below the configuration's (float32 with TF32 off);
* ``fault_frozen``: a step that returns its state unchanged (lr 0);
* ``fault_half``: each step's loss over half of its batch;
* ``fault_answer``: the evaluation's answer off by 1 % of the test set.

    python3 portbench/calibrate.py --workload <name> --seeds 1 2 3 \
        --out readings.json

Writes {workload, seeds, readings: {who: {number: [one value a lane]}}}.
Needs a CUDA card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def fault(name: str, cfg: dict):
    """The reference with one planted fault, for the block."""
    from portbench.reference import model
    saved = (model.kl_rows, model.cross_entropy, model.accuracy,
             dict(cfg["campaign"]))
    if name == "fault_frozen":
        for k in ("lr", "lr_c", "lr_s"):
            if k in cfg["campaign"]:
                cfg["campaign"][k] = 0.0
    elif name == "fault_half":
        kl, ce = model.kl_rows, model.cross_entropy
        model.kl_rows = lambda x, y, t: kl(x, y, t)[..., :x.shape[-2] // 2]
        model.cross_entropy = lambda lo, la: ce(
            lo[..., :lo.shape[-2] // 2, :], la[..., :la.shape[-1] // 2])
    elif name == "fault_answer":
        acc = model.accuracy
        model.accuracy = lambda w, x, y: acc(w, x, y) + 0.01
    try:
        yield
    finally:
        (model.kl_rows, model.cross_entropy, model.accuracy) = saved[:3]
        cfg["campaign"].clear()
        cfg["campaign"].update(saved[3])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-lanes", type=int, default=4)
    ap.add_argument("--who", nargs="+", default=[
        "port", "control", "fault_frozen", "fault_half", "fault_answer"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from portbench import compare, harness, reference as ref
    from portbench.inputs import Inputs
    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    _, cfg, traffic, checks = harness.find_cell(bench, args.workload)
    rounds = compare.rounds_of(checks)
    R = traffic["rounds"]
    out = {who: {} for who in args.who}
    t0 = time.perf_counter()
    for seed in args.seeds:
        inputs = Inputs(seed, cfg["data"], cfg["deployment"]["M"])
        camp = harness.Campaigns(cfg, traffic, inputs, args.device)
        S = traffic["seeds_per_call"]
        seeds = inputs.seeds(S)
        results = camp.call(seeds)
        call = harness.summarize(results, seeds, camp.do_eval,
                                 [(v, p) for v in range(len(results))
                                  for p in range(S)])
        do_eval = camp.do_eval
        del results, camp
        if "port" in out:
            for k, v in compare.readings(cfg, traffic, inputs, [call],
                                         args.device, rounds).items():
                out["port"].setdefault(k, []).extend(v)
        data = ref.device_data({"clients": inputs.clients,
                                "test": inputs.test},
                               cfg["model"]["n_classes"], args.device)
        evals = [r for r in range(R) if do_eval[r]]
        lanes = seeds[:args.control_lanes]
        dep = dict(cfg["deployment"], **traffic.get("variants", [{}])[0])
        want = compare.lanes_of_reference(
            ref.campaign(cfg, dep, R, lanes, data, eval_rounds=evals),
            lanes, R)
        for who in args.who:
            if who == "port":
                continue
            with fault(who, cfg):
                got = ref.campaign(cfg, dep, R, lanes, data,
                                   eval_rounds=evals, tf32=who == "control")
            lanes_got = compare.lanes_of_reference(got, lanes, R)
            judged = ref.evaluate(cfg, got["params"], data)
            for k, v in compare.lane_gaps(lanes_got, want, judged,
                                          len(inputs.test[1]),
                                          rounds).items():
                out[who].setdefault(k, []).extend(v)
        del data
        print(f"calibrate: seed {seed} done at {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"workload": args.workload, "seeds": args.seeds,
                   "readings": out}, f)
    for who, nums in out.items():
        print(who, {k: max(v) for k, v in nums.items()
                    if k != "loss_by_round"})
    return 0


if __name__ == "__main__":
    sys.exit(main())
