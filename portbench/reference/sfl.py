"""SplitFed (SFL), the paper's baseline, for S seeds at once, plainly:
each round the K clients of the plan run E SGD steps of the whole DNN on
the cross-entropy of their own batches (the split only changes what
crosses the network, not the arithmetic), and the models are averaged
over them; the evaluation is the averaged model's test accuracy."""
from __future__ import annotations

import torch

from portbench.reference import model, plan as plans

PHASES = 1


def dims(cfg: dict):
    m = cfg["model"]
    return (m["n_features"], *m["hidden"], m["n_classes"])


def plan(cfg: dict, sp, rounds: int, n_per_client: int):
    hp = cfg["campaign"]
    return plans.plan_fixed_k(sp, rounds, hp["K"], hp["E"],
                              hp["policy_seed"])


def init(gen: torch.Generator, cfg: dict):
    return (model.init_layers(gen, dims(cfg)),)


def train_round(cfg: dict, params, data, sel, E: int, idx):
    """One round over the cohort ``sel`` (k,) for E steps; ``idx`` (S, 1,
    k, E, B).  Returns the new params and the (S, 1) round losses."""
    (w,) = params
    S, k = idx.shape[0], len(sel)
    xs, ys = data["x"][sel], data["y"][sel]
    slot = torch.arange(k, device=xs.device)[None, :, None]
    w = model.expand(w, k)
    losses = []
    for i in range(E):
        rows = idx[:, 0, :, i]
        xb, yb = xs[slot, rows], ys[slot, rows]
        w, loss = model.sgd(w, lambda v: model.cross_entropy(
            model.forward(v, xb), yb), cfg["campaign"]["lr"])
        losses.append(loss)
    new = ([{n: t.mean(1) for n, t in p.items()} for p in w],)
    return new, torch.stack(losses).mean(0).mean(1)[:, None]


def evaluate(cfg: dict, params, data) -> torch.Tensor:
    return model.accuracy(params[0], data["x_test"], data["y_test"])
