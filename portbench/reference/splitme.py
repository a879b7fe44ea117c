"""SplitMe (arXiv 2508.02534, Alg. 2) for S seeds at once, plainly: per
round, every selected client trains the client model c(·) on the mutual
KL against the global inverse model's s⁻¹(Y) (Step 1-2), then the inverse
server model s⁻¹(·) on the KL against its updated c(X) (Step 3), each for
the round's E SGD steps on batches of its own; both halves are averaged
over the selected clients.  Step 4 inverts s⁻¹ layer by layer into the
server model and evaluates the stitched network."""
from __future__ import annotations

import torch

from portbench.reference import model, plan as plans

PHASES = 2


def dims(cfg: dict):
    """(client dims, inverse server dims) of the configured DNN."""
    m = cfg["model"]
    d = [m["n_features"], *m["hidden"], m["n_classes"]]
    k = m["split_index"]
    return tuple(d[:k + 1]), tuple(reversed(d[k:]))


def plan(cfg: dict, sp, rounds: int, n_per_client: int):
    c, i = dims(cfg)
    return plans.plan_splitme(sp, rounds, cfg["campaign"]["e_initial"],
                              n_per_client, c, i)


def init(gen: torch.Generator, cfg: dict):
    """The client model's layers, then the inverse model's."""
    c, i = dims(cfg)
    return (model.init_layers(gen, c), model.init_layers(gen, i))


def train_round(cfg: dict, params, data, sel, E: int, idx):
    """One round over the cohort ``sel`` (k,) for E steps; ``idx`` (S,
    PHASES, k, E, B) holds each seed's batch rows of each selected client.
    Returns the new params and the (S, PHASES) round losses (each client's
    mean over its steps, averaged over the cohort)."""
    hp = cfg["campaign"]
    T = hp["temperature"]
    w_c, w_i = params
    S, k = idx.shape[0], len(sel)
    xs, y1s = data["x"][sel], data["y1"][sel]            # (k, n, ·)
    slot = torch.arange(k, device=xs.device)[None, :, None]
    seed = torch.arange(S, device=xs.device)[:, None, None]
    # s⁻¹(Y_m) of the global inverse model, fixed for the round
    target = model.forward([{n: v[:, None] for n, v in p.items()}
                            for p in w_i], y1s)            # (S, k, n, d)
    c = model.expand(w_c, k)
    losses = []
    for i in range(E):
        rows = idx[:, 0, :, i]                              # (S, k, B)
        xb, tb = xs[slot, rows], target[seed, slot, rows]
        c, loss = model.sgd(c, lambda w: model.kl_rows(
            model.forward(w, xb, final_linear=False), tb, T).mean(-1),
            hp["lr_c"])
        losses.append(loss)
    client_loss = torch.stack(losses).mean(0)               # (S, k)
    smashed = model.forward(c, xs.expand(S, *xs.shape), final_linear=False)
    v = model.expand(w_i, k)
    losses = []
    for i in range(E):
        rows = idx[:, 1, :, i]
        yb, tb = y1s[slot, rows], smashed[seed, slot, rows]
        v, loss = model.sgd(v, lambda w: model.kl_rows(
            model.forward(w, yb), tb, T).mean(-1), hp["lr_s"])
        losses.append(loss)
    server_loss = torch.stack(losses).mean(0)
    new = tuple([{n: t.mean(1) for n, t in p.items()} for p in half]
                for half in (c, v))
    return new, torch.stack([client_loss.mean(1), server_loss.mean(1)], -1)


def evaluate(cfg: dict, params, data) -> torch.Tensor:
    """(S,) test accuracy of the server model that Step 4 recovers from
    each seed's trained halves, stitched behind its client model."""
    w_c, w_i = params
    server = model.invert(w_c, w_i, data["x_all"], data["y1_all"],
                          cfg["campaign"]["eval_gamma"])
    return model.accuracy(list(w_c) + server, data["x_test"],
                          data["y_test"])
