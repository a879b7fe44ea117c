"""End-to-end LM pretraining on a zoo architecture, on the card.

    PYTHONPATH=src python -m repro_torch.examples.lm_pretrain \
        --arch smollm-135m --steps 300 --batch 2 --seq 64   # full ~135M
    PYTHONPATH=src python -m repro_torch.examples.lm_pretrain --reduced \
        --steps 20 --device cpu                             # smoke

The port's counterpart of ``examples/lm_pretrain.py``, with the same
flags, token stream (the numpy Zipf draw: the same tokens), choices (f32
and no remat for a full-size model, ``default_optimizer``) and printed
lines; ``--device`` (the card unless ``cpu``) is the one flag it adds.
The weights come from the port's seed 0.  SSM and hybrid models train on
the plain scans (``policy="reference"``): the scan kernels have no
backward, as in the JAX package.  ``--ckpt PATH`` saves the parameters
(``repro_torch.checkpoint.io``, the model's tree, layers as lists) with
``{"arch", "steps"}``.
"""
import argparse
import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt
from repro_torch.configs.base import get_config
from repro_torch.models.transformer import build_model
from repro_torch.runtime.steps import default_optimizer, make_train_step


def token_stream(vocab: int, batch: int, seq: int, seed: int = 0):
    """Synthetic Zipf-ish token pipeline (deterministic)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    while True:
        yield rng.choice(vocab, size=(batch, seq), p=probs).astype(np.int32)


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    """Runs the steps and returns the loss of each (f32)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action="store_true",
                    help="2-layer reduced variant (CI smoke)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    else:
        cfg = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg, remat=False, policy="reference",
                        device=args.device)
    opt = default_optimizer(cfg)
    init_state, train_step = make_train_step(model, optimizer=opt, lr=args.lr)
    opt_state, step = init_state()
    n = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} params={n / 1e6:.1f}M optimizer={opt}")

    stream = token_stream(cfg.vocab_size, args.batch, args.seq)
    dev = model.device
    losses = []
    t0 = time.time()
    for i in range(args.steps):
        batch = {"tokens": torch.from_numpy(next(stream)).to(dev)}
        if cfg.frontend:
            batch["embeds"] = torch.zeros(
                (args.batch, cfg.frontend_positions, cfg.d_model),
                dtype=model.dtype, device=dev)
        opt_state, step, m = train_step(opt_state, step, batch)
        losses.append(m["loss"])
        if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={float(m['loss']):.4f} "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)")
    if args.ckpt:
        ckpt.save(args.ckpt, model.tree(), metadata={"arch": cfg.name,
                                                     "steps": args.steps})
        print(f"saved checkpoint to {args.ckpt}")
    return [float(v) for v in losses]


if __name__ == "__main__":
    main()
