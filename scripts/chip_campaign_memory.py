"""The card memory a campaign leaves held after it returns, with the
campaigns' one side stream per device (``campaign._side_stream``) and with
a new side stream per campaign.

cuBLAS keeps a workspace per (handle, stream) for as long as the process
lives, allocated through torch's caching allocator, so each new stream a
campaign runs on holds one more workspace.  This runs ``--campaigns``
campaigns of each kind, alternating the two stream rules in turns: the
paper's SplitMe campaign of ``chip_smoke.py`` phase 3b (graphed, and its
rounds uncaptured) and the population campaign of phase 3h; after each it
prints ``torch.cuda.memory_allocated`` once ``gc.collect()`` and
``empty_cache()`` have run.  The last line is a JSON object with each
rule's growth a campaign.  Needs a CUDA card:

    python3 scripts/chip_campaign_memory.py --campaigns 3
"""
import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--campaigns", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_campaign_memory: no CUDA device", file=sys.stderr)
        return 2
    port = cs.import_port()
    camp = port.campaign
    X, y = port.oran.generate(n_per_class=2000, seed=0)
    (Xtr, ytr), test = port.oran.train_test_split(X, y)
    sp = port.SystemParams()
    clients = port.oran.partition_non_iid(Xtr, ytr, sp.M,
                                          samples_per_client=96, seed=0)
    kw = dict(rounds=cs.CAMPAIGN_ROUNDS, seeds=cs.CAMPAIGN_SEEDS,
              test_data=test, eval_every=cs.CAMPAIGN_EVAL_EVERY,
              device="cuda")
    runs = {
        "run_campaign": lambda: camp.run_campaign(
            "splitme", port.DNN10, sp, clients, **kw),
        "run_campaign uncaptured": lambda: camp.run_campaign(
            "splitme", port.DNN10, sp, clients, _graphs=False, **kw),
        "run_population_campaign": lambda: camp.run_population_campaign(
            "splitme", port.DNN10, port.population.Population(cs.POP_SIZE),
            (Xtr, ytr), cohort=cs.POP_COHORT,
            samples_per_client=cs.POP_SAMPLES, scenario=cs.POP_SCENARIO,
            **kw)}
    shared = camp._side_stream
    rules = {"one stream a device": shared,
             "a stream a campaign": lambda dev: torch.cuda.Stream(device=dev)}

    def held_mb():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated() / 1e6

    growth = {rule: [] for rule in rules}
    try:
        for turn in range(args.campaigns):
            order = list(rules) if turn % 2 == 0 else list(rules)[::-1]
            for rule in order:
                camp._side_stream = rules[rule]
                for name, run in runs.items():
                    before = held_mb()
                    run()
                    after = held_mb()
                    growth[rule].append(after - before)
                    print(f"turn {turn}, {rule}, {name}: held "
                          f"{before:.2f} -> {after:.2f} MB", flush=True)
    finally:
        camp._side_stream = shared
    print(json.dumps({rule: {"campaigns": len(v),
                             "mb_per_campaign_max": max(v),
                             "mb_per_campaign_median": sorted(v)[len(v) // 2]}
                      for rule, v in growth.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
