"""Quickstart: SplitMe on synthetic O-RAN slice traffic, on the card.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--rounds N]
        [--device cpu]

The port's counterpart of ``examples/quickstart.py``: N global rounds
(default 10) of the full pipeline — deadline-aware selection (Alg. 1),
bandwidth/E allocation (P2), mutual-learning split training, and the final
analytic inversion (Step 4) — then the combined model's test accuracy.  It
runs on the card unless ``--device cpu`` is given.
"""
import argparse
from typing import Optional, Sequence

from repro_torch.configs.splitme_dnn import DNN10
from repro_torch.core.cost import SystemParams
from repro_torch.core.splitme import SplitMeTrainer
from repro_torch.data import oran


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=10,
                    help="global rounds to train (default 10)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    X, y = oran.generate(n_per_class=1000, seed=0)
    (Xtr, ytr), (Xte, yte) = oran.train_test_split(X, y)
    sp = SystemParams()
    clients = oran.partition_non_iid(Xtr, ytr, sp.M,
                                     samples_per_client=64, seed=0)
    # interactive=True: metrics come back as floats each round (this demo
    # prints them immediately)
    trainer = SplitMeTrainer(DNN10, sp, clients, (Xte, yte), seed=0,
                             interactive=True, device=args.device)
    print("round | selected | E | comm MB | latency ms | client KL")
    for k in range(args.rounds):
        m = trainer.run_round()
        print(f"{m.round:5d} | {m.n_selected:8d} | {m.E} |"
              f" {m.comm_bits / 8e6:7.2f} | {m.sim_time * 1e3:10.1f} |"
              f" {m.client_loss:.4f}")
    w_server = trainer.finalize()       # Step 4: one-shot analytic inversion
    print(f"\nfinal accuracy after inversion: {trainer.evaluate(w_server):.3f}")


if __name__ == "__main__":
    main()
