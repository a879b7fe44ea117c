"""The plain reference the benchmark holds the port to.  Plain PyTorch and
numpy; it imports nothing of the program.  ``campaign`` runs one
framework's campaign for the sampled seeds from the benchmark's own
inputs: it plans the schedule, draws each seed's initial weights and
batches by the rule of the seed's generator, trains every round and
evaluates where asked.  The framework's rounds live in a module of this
package named after it (``splitme``, ``sfl``)."""
from __future__ import annotations

import contextlib
import importlib
from typing import Iterable, Sequence

import numpy as np
import torch

from portbench.reference import model, plan as plans


def framework(name: str):
    return importlib.import_module(f"portbench.reference.{name}")


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Float32 matmuls in full float32 (``tf32`` False) or in TF32."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def device_data(inputs: dict, n_classes: int, device) -> dict:
    """The benchmark's inputs as the rounds read them, on ``device``."""
    x = torch.as_tensor(inputs["clients"]["x"], dtype=torch.float32,
                        device=device)
    y = torch.as_tensor(inputs["clients"]["y"], dtype=torch.int64,
                        device=device)
    y1 = torch.nn.functional.one_hot(y, n_classes).float()
    return {"x": x, "y": y, "y1": y1,
            "x_all": x.reshape(-1, x.shape[-1]),
            "y1_all": y1.reshape(-1, n_classes),
            "x_test": torch.as_tensor(inputs["test"][0], dtype=torch.float32,
                                      device=device),
            "y_test": torch.as_tensor(inputs["test"][1], dtype=torch.int64,
                                      device=device)}


def schedule(cfg: dict, deploy: dict, rounds: int, n_per_client: int):
    """The framework's plan under ``deploy`` and its E buckets."""
    fw = framework(cfg["framework"])
    sp = plans.table3(deploy)
    sched = fw.plan(cfg, sp, rounds, n_per_client)
    _, eb = plans.round_shapes(sched["a"].sum(1), sched["E"], sp.M,
                               sp.E_max)
    return sched, eb


def campaign(cfg: dict, deploy: dict, rounds: int, seeds: Sequence[int],
             data: dict, *, eval_rounds: Iterable[int] = (),
             tf32: bool = False) -> dict:
    """Train ``seeds`` through ``rounds`` rounds.  Returns the schedule,
    the final params (S-stacked), the (S, rounds, phases) losses, and the
    (S,) accuracy of every round in ``eval_rounds``."""
    fw = framework(cfg["framework"])
    M, n = data["x"].shape[:2]
    B = cfg["campaign"]["batch_size"]
    sched, eb = schedule(cfg, deploy, rounds, n)
    sels = [np.nonzero(sched["a"][r])[0] for r in range(rounds)]
    inits, idx = [], []
    for s in seeds:
        gen = torch.Generator().manual_seed(int(s))
        inits.append(fw.init(gen, cfg))
        # the full-M draw of each round's E bucket; the reference keeps
        # the selected clients' executed steps
        idx.append([torch.randint(0, n, (fw.PHASES, M, e, B), generator=gen)
                    [:, sels[r], :int(sched["E"][r])]
                    for r, e in enumerate(eb)])
    dev = data["x"].device
    params = tuple(model.stack([i[h] for i in inits], dev)
                   for h in range(len(inits[0])))
    losses = torch.empty(len(seeds), rounds, fw.PHASES, device=dev)
    acc = {}
    want = set(eval_rounds)
    with matmul_precision(tf32), torch.no_grad():
        for r in range(rounds):
            sel = torch.as_tensor(sels[r], device=dev)
            rows = torch.stack([i[r] for i in idx]).to(dev)
            params, losses[:, r] = fw.train_round(
                cfg, params, data, sel, int(sched["E"][r]), rows)
            if r in want:
                acc[r] = fw.evaluate(cfg, params, data).cpu().numpy()
    return {"schedule": sched, "params": params,
            "losses": losses.cpu().numpy(), "accuracy": acc}


def evaluate(cfg: dict, params, data, *, tf32: bool = False) -> np.ndarray:
    """(S,) accuracy of S-stacked params, as the framework evaluates."""
    fw = framework(cfg["framework"])
    with matmul_precision(tf32), torch.no_grad():
        return fw.evaluate(cfg, params, data).cpu().numpy()
