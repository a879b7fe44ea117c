"""How often a one-round torch.profiler window over the graphed SplitMe
campaign comes back without some of its round's kernels, with and without
the idle edges that ``chip_smoke.open_window`` / ``close_window`` keep.

Runs the paper's campaign of ``chip_smoke.py`` phase 3b (DNN10, M 50, 96
samples a client, 30 rounds, seeds 0-3, Step 4 every 10 rounds) graphed on
the card ``--campaigns`` times, alternating the two variants, and profiles
every round after its shape's first one as a window of its own.  A window is
short when its counts of ``chip_smoke.CAMPAIGN_KERNELS`` differ from the
round's: 2·E forward and 2·E backward KL launches, 8 Gram pairs a seed in an
evaluating round.  Prints one JSON line per short window and the totals as
the last line.  Needs a CUDA card:

    python3 scripts/chip_profile_edges.py --campaigns 10
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def counts(evts):
    return {name: sum(e.count for e in evts if any(k in e.key for k in keys))
            for name, keys in cs.CAMPAIGN_KERNELS.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--campaigns", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_profile_edges: no CUDA device", file=sys.stderr)
        return 2
    port = cs.import_port()
    port.build.library()
    X, yl = port.oran.generate(n_per_class=2000, seed=0)
    (Xtr, ytr), test = port.oran.train_test_split(X, yl)
    sp = port.SystemParams()
    clients = port.oran.partition_non_iid(Xtr, ytr, sp.M,
                                          samples_per_client=96, seed=0)
    S, every = len(cs.CAMPAIGN_SEEDS), cs.CAMPAIGN_EVAL_EVERY
    kw = dict(rounds=cs.CAMPAIGN_ROUNDS, seeds=cs.CAMPAIGN_SEEDS,
              test_data=test, device="cuda", eval_every=every)
    camp = port.campaign
    shapes = camp.run_campaign("splitme", port.DNN10, sp, clients,
                               **kw).graphs["shapes"]
    eb_of = {r: eb for (_, eb), rs in shapes.items() for r in rs}
    evals = [r for r in range(cs.CAMPAIGN_ROUNDS) if not (r + 1) % every]
    # a shape's first round and the first evaluating one run warm-ups
    skip = {rs[0] for rs in shapes.values()} | {evals[0]}
    rounds = [r for r in range(cs.CAMPAIGN_ROUNDS) if r not in skip]
    quiet = cs.PROFILE_QUIET_S
    total = {}
    for i in range(args.campaigns):
        variant = ("quiet", "bare")[i % 2]
        cs.PROFILE_QUIET_S = quiet if variant == "quiet" else 0.0
        win = {}

        def hook(r):
            if "prof" in win and r == win["r"]:
                close = time.time_ns()
                cs.close_window(torch, win["prof"], win["t0"])
                got = counts(win["prof"].key_averages())
                want = {"kl_mutual": 2 * eb_of[r],
                        "kl_mutual (backward)": 2 * eb_of[r],
                        "ridge_gram": 8 * S if r in evals else 0}
                short = got != want
                t = total.setdefault(variant, {"windows": 0, "short": 0})
                t["windows"] += 1
                t["short"] += short
                if short:
                    print(json.dumps({"variant": variant, "round": r,
                                      "got": got, "want": want,
                                      "host_ms": (close - win["ns"]) / 1e6}),
                          flush=True)
                del win["prof"]
            if r + 1 in rounds:
                win["ns"] = time.time_ns()
                win["prof"], win["t0"] = cs.open_window(torch)
                win["r"] = r + 1
        camp.run_campaign("splitme", port.DNN10, sp, clients,
                          _round_hook=hook, **kw)
    cs.PROFILE_QUIET_S = quiet
    print(json.dumps({"quiet_s": quiet, "windows": total}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
