"""End-to-end O-RAN SplitFL campaign on the card — the paper's full
experiment through the port.

    PYTHONPATH=src python -m repro_torch.examples.oran_splitfl_campaign
        [--rounds 30] [--baselines] [--ckpt-dir /tmp/splitme] [--seeds 4]
        [--quant bf16] [--scenario fading] [--checkpoint-every 10]
        [--resume] [--population 1000000 --cohort 32] [--device cpu]

The port's counterpart of ``examples/oran_splitfl_campaign.py``, with the
same flags, checks, modes and printed lines; ``--device`` (the card unless
``cpu``) is the one flag it adds.

Serially (``--seeds 1``, the default) it trains SplitMe on the COMMAG-style
slice data (30 rounds, as in §V-B) with ``SplitMeTrainer``, checkpoints
(w_C, w_S⁻¹) every 10 rounds (``repro_torch.checkpoint.io``), performs the
final analytic inversion and, with ``--baselines``, trains the five
baseline frameworks (fedavg, sfl, oranfed, fedora, ecofl) for the
wall-clock comparison of Fig. 4.

``--seeds N`` (N > 1) runs the scanned multi-seed campaign
(``repro_torch.launch.campaign.run_campaign``): one CUDA graph a round
shape, the evaluation fused every ``--eval-every`` rounds, one host
transfer, and the per-seed final accuracies (mean ± std).
``--checkpoint-every`` / ``--checkpoint-dir`` / ``--resume`` save and
resume its carry bit for bit.  ``--population M`` runs the population
campaign (``run_population_campaign``): M virtual clients of which each
round samples a ``--cohort``, in O(cohort) memory.

``--quant {none,bf16,int8}`` selects the wire format of the aggregation
payload, ``--policy`` the kernel dispatch and precision, and ``--scenario
NAME[:LEVEL]`` (``static``, ``fading``, ``straggler``, ``noniid``,
``faults``; ``churn`` in population mode) a time-varying O-RAN trace.
"""
import argparse
import copy
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.checkpoint import io as ckpt
from repro_torch.configs.splitme_dnn import DNN10
from repro_torch.core import population as popn
from repro_torch.core import scenario as scen
from repro_torch.core.baselines import (EcoFLTrainer, FedAvgTrainer,
                                        FedORATrainer, ORANFedTrainer,
                                        SFLTrainer)
from repro_torch.core.cost import SystemParams
from repro_torch.core.splitme import SplitMeTrainer
from repro_torch.data import oran
from repro_torch.launch import campaign


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="O-RAN SplitFL campaign over the six-framework registry "
                    "(splitme, fedavg, sfl, oranfed, fedora, ecofl)",
        epilog="CommQuant: --quant bf16|int8 narrows the aggregation wire "
               "format (comm volume, latency, cost and deadline/energy "
               "selection all respond); int8 uses stochastic rounding with "
               "an f32 error-feedback accumulator.")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--baseline-rounds", type=int, default=60)
    ap.add_argument("--baselines", action="store_true")
    ap.add_argument("--ckpt-dir", default="/tmp/splitme_ckpt")
    ap.add_argument("--seeds", type=int, default=1,
                    help="N>1: scanned multi-seed campaign instead of one "
                         "serial run")
    ap.add_argument("--eval-every", type=int, default=None,
                    help="campaign mode: evaluate every K rounds inside the "
                         "graphed campaign (accuracy curve, no extra host "
                         "transfers)")
    ap.add_argument("--policy", default=None,
                    choices=["reference", "kernel", "kernel_bf16"],
                    help="kernel dispatch / precision policy (default: the "
                         "CUDA kernels on the card, their plain versions "
                         "on the CPU)")
    ap.add_argument("--quant", default=None,
                    choices=["none", "bf16", "int8"],
                    help="CommQuant wire format of the masked-FedAvg "
                         "aggregation payload (default none/f32; bf16 = "
                         "deterministic 16-bit rounding, int8 = stochastic "
                         "rounding + f32 error feedback; comm_bits/latency/"
                         "cost and the selection policies account it)")
    ap.add_argument("--scenario", default=None,
                    help="time-varying scenario from the "
                         "repro_torch.core.scenario registry: static | "
                         "fading | straggler | noniid | faults, optionally "
                         "with a level suffix (fading:0.8, noniid:0.1); "
                         "default: the frozen network snapshot")
    ap.add_argument("--scenario-seed", type=int, default=0,
                    help="seed of the scenario trace draw")
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    help="campaign mode: persist the full campaign carry "
                         "(params/EF state/metric buffers) every K rounds "
                         "to --checkpoint-dir (atomic manifests)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="campaign checkpoint directory (default: "
                         "<--ckpt-dir>/campaign)")
    ap.add_argument("--resume", action="store_true",
                    help="resume the campaign from the newest committed "
                         "checkpoint in --checkpoint-dir (bit-exact; "
                         "fresh start when the directory is empty)")
    ap.add_argument("--population", type=int, default=None,
                    help="population mode: train over M virtual clients "
                         "(millions are fine) sampling a --cohort per "
                         "round; memory is O(cohort), not O(M)")
    ap.add_argument("--cohort", type=int, default=32,
                    help="population mode: clients sampled per round "
                         "(default 32)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.population is not None and args.seeds <= 1:
        ap.error("--population needs the scanned campaign runner "
                 "(--seeds N with N > 1)")
    if (args.resume or args.checkpoint_every) and args.seeds <= 1:
        ap.error("--checkpoint-every/--resume need the scanned campaign "
                 "runner (--seeds N with N > 1)")
    if args.resume and not args.checkpoint_every:
        ap.error("--resume needs --checkpoint-every (the resumed run "
                 "replans the same segment boundaries)")
    ckpt_dir = args.checkpoint_dir or f"{args.ckpt_dir}/campaign"

    X, y = oran.generate(n_per_class=2000, seed=0)
    (Xtr, ytr), (Xte, yte) = oran.train_test_split(X, y)
    sp = SystemParams()
    # the scenario decides the client partition (Dirichlet α for noniid,
    # the paper's one-class-per-client split otherwise); serial trainers
    # take a concrete pre-drawn trace, so build one long enough for the
    # longest loop below
    horizon = max(args.rounds, args.baseline_rounds)
    trace = None
    if args.scenario is not None:
        trace = scen.make_trace(args.scenario, horizon, sp.M,
                                seed=args.scenario_seed)
        clients = scen.partition_for(trace, Xtr, ytr, sp.M,
                                     samples_per_client=96, seed=0)
    else:
        clients = oran.partition_non_iid(Xtr, ytr, sp.M,
                                         samples_per_client=96, seed=0)

    if args.population is not None:
        seeds = tuple(range(args.seeds))
        pop = popn.Population(size=args.population, seed=0)
        t0 = time.time()
        res = campaign.run_population_campaign(
            "splitme", DNN10, pop, (Xtr, ytr), rounds=args.rounds,
            seeds=seeds, cohort=args.cohort, samples_per_client=96,
            test_data=(Xte, yte), eval_every=args.eval_every,
            policy=args.policy, quant=args.quant, scenario=args.scenario,
            scenario_seed=args.scenario_seed,
            checkpoint_every=args.checkpoint_every,
            checkpoint_dir=(f"{ckpt_dir}/population"
                            if args.checkpoint_every else None),
            resume=args.resume, device=args.device)
        acc = res.accuracy
        print(f"[splitme/pop] {args.population:,} clients, cohort "
              f"{args.cohort}, {len(seeds)} seeds x {args.rounds} rounds: "
              f"acc={acc.mean():.3f}±{acc.std():.3f} "
              f"comm={sum(m.comm_bits for m in res.metrics) / 8e6:.1f}MB "
              f"wall={time.time() - t0:.0f}s")
        return

    if args.seeds > 1:
        seeds = tuple(range(args.seeds))
        for name, kw in [("splitme", {})] + ([
                ("fedavg", {"K": 10, "E": 10}),
                ("sfl", {"K": 20, "E": 14}),
                ("oranfed", {"E": 10}),
                ("fedora", {"E": 10}),
                ("ecofl", {"K": 10, "E": 10}),
        ] if args.baselines else []):
            rounds = args.rounds if name == "splitme" else args.baseline_rounds
            t0 = time.time()
            # per-framework checkpoint subdir: each plan has its own
            # schedule fingerprint, so checkpoints must not interleave
            res = campaign.run_campaign(
                name, DNN10, SystemParams(seed=0), clients, rounds=rounds,
                seeds=seeds, test_data=(Xte, yte),
                eval_every=args.eval_every, policy=args.policy,
                quant=args.quant, scenario=trace,
                checkpoint_every=args.checkpoint_every,
                checkpoint_dir=(f"{ckpt_dir}/{name}"
                                if args.checkpoint_every else None),
                resume=args.resume, device=args.device, **kw)
            acc = res.accuracy
            print(f"[{name}] {len(seeds)} seeds x {rounds} rounds: "
                  f"acc={acc.mean():.3f}±{acc.std():.3f} "
                  f"(per-seed {np.round(acc, 3).tolist()}) "
                  f"comm={sum(m.comm_bits for m in res.metrics) / 8e6:.1f}MB "
                  f"sim_time={sum(m.sim_time for m in res.metrics):.2f}s "
                  f"wall={time.time() - t0:.0f}s")
            if res.skipped_per_round is not None or res.crashed_rounds:
                print(f"[{name}] guards: skipped_rounds="
                      f"{res.skipped_rounds} quorum_rounds="
                      f"{res.quorum_rounds} crashed_rounds="
                      f"{res.crashed_rounds}")
            if args.eval_every:
                curve = [(m.round, round(m.accuracy, 3))
                         for m in res.metrics if m.accuracy == m.accuracy]
                print(f"[{name}] fused-eval accuracy curve: {curve}")
        return

    tr = SplitMeTrainer(DNN10, sp, clients, (Xte, yte), seed=0,
                        kernel_policy=args.policy, comm_quant=args.quant,
                        scenario=trace, interactive=True,
                        device=args.device)
    t0 = time.time()
    for k in range(args.rounds):
        m = tr.run_round(eval_acc=(k % 5 == 4))
        if k % 5 == 4:
            print(f"[splitme] round {k}: sel={m.n_selected} E={m.E} "
                  f"acc={m.accuracy:.3f} cum_comm="
                  f"{sum(h.comm_bits for h in tr.history) / 8e6:.1f}MB")
        if (k + 1) % 10 == 0:
            ckpt.save(f"{args.ckpt_dir}/round{k + 1}",
                      {"w_c": tr.w_c, "w_s_inv": tr.w_s_inv},
                      metadata={"round": k + 1})
    w_server = tr.finalize()
    acc = tr.evaluate(w_server)
    total_time = sum(m.sim_time for m in tr.history)
    print(f"[splitme] FINAL acc={acc:.3f} rounds={args.rounds} "
          f"sim_time={total_time:.2f}s wall={time.time() - t0:.0f}s")

    if args.baselines:
        for name, cls, kw in [
            ("fedavg", FedAvgTrainer, {"K": 10, "E": 10}),
            ("sfl", SFLTrainer, {"K": 20, "E": 14}),
            ("oranfed", ORANFedTrainer, {"E": 10}),
            ("fedora", FedORATrainer, {"E": 10}),
            ("ecofl", EcoFLTrainer, {"K": 10, "E": 10}),
        ]:
            b = cls(DNN10, SystemParams(seed=0), copy.deepcopy(clients),
                    (Xte, yte), comm_quant=args.quant, scenario=trace,
                    device=args.device, **kw)
            for _ in range(args.baseline_rounds):
                b.run_round()
            print(f"[{name}] acc={b.evaluate():.3f} "
                  f"rounds={args.baseline_rounds} "
                  f"sim_time={sum(m.sim_time for m in b.history):.2f}s "
                  f"comm={sum(m.comm_bits for m in b.history) / 8e6:.1f}MB")


if __name__ == "__main__":
    main()
