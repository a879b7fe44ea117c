"""The benchmark's yardstick: the published peaks of one H100, and the
useful work of a campaign counted from its schedule and the model's
shapes — model FLOPs, the mutual-KL kernels' bytes and the Step-4 Grams'
operations.  The counts leave out what a run computes beyond the
schedule's need: padded cohort slots, masked steps, warm-up and
recomputation.  Formulas for the KL bytes and the Gram operations are
those of the kernels' bounds: KL forward R·d·(s_x + s_y) + 4·R bytes and
backward R·d·(2·s_x + s_y) + 4·R for R rows of width d; a Gram pair
(OᵀO, OᵀZ) of an (n, d1) O and (n, d2) Z n·d1·(d1 + 1) + 2·n·d1·d2
operations, reading n·(d1 + d2) and writing d1·(d1 + d2) floats."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Sequence

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BYTES = 3.35e12                 # HBM3 bytes/s
PEAK_FP32 = 67e12                    # FLOP/s, float32 outside the tensor cores
PEAK_TF32 = 495e12                   # FLOP/s, TF32 tensor cores
PEAK_F32_MMA = PEAK_TF32 / 3         # float32-accurate products as 3xTF32
PEAK_BF16 = 989e12
PEAK_OF_PRECISION = {"float32": PEAK_FP32, "bfloat16": PEAK_BF16}
F32 = 4                              # bytes


def weights(dims: Sequence[int]) -> int:
    """Multiply-adds a row takes through an MLP of ``dims``."""
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


@dataclass
class Work:
    """Useful work of a window, summed over its campaigns."""
    flops: float = 0.0
    kl_bytes: float = 0.0
    gram_ops: float = 0.0
    gram_bytes: float = 0.0
    lanes_rounds: int = 0
    detail: Dict[str, float] = field(default_factory=dict)

    def add(self, other: "Work") -> None:
        self.flops += other.flops
        self.kl_bytes += other.kl_bytes
        self.gram_ops += other.gram_ops
        self.gram_bytes += other.gram_bytes
        self.lanes_rounds += other.lanes_rounds


def gram_pair(n: int, d1: int, d2: int):
    """(operations, bytes) of one Gram pair."""
    ops = n * d1 * (d1 + 1) + 2 * n * d1 * d2
    return ops, F32 * (n * (d1 + d2) + d1 * (d1 + d2))


def kl_rows(rows: float, d: int, s_x: int = F32, s_y: int = F32) -> float:
    """Bytes of a forward and a backward over ``rows`` rows."""
    return (rows * d * (s_x + s_y) + 4 * rows
            + rows * d * (2 * s_x + s_y) + 4 * rows)


def splitme(cfg: dict, a: np.ndarray, E: np.ndarray, evals: np.ndarray,
            n: int, n_test: int) -> Work:
    """One lane's (a seed's, or a sweep pair's) useful work over its
    schedule: per round and selected client, the fixed targets of each
    phase over the client's n samples, and E forward-backward steps of B
    rows through each half; at each evaluation Step 4 over all M·n
    samples (both halves' forwards, the Grams, the recovered layers) and
    the stitched test forward."""
    m, hp = cfg["model"], cfg["campaign"]
    d = [m["n_features"], *m["hidden"], m["n_classes"]]
    k = m["split_index"]
    client, server = d[:k + 1], d[k:]
    w_c, w_s = weights(client), weights(server)
    B, dsplit = hp["batch_size"], client[-1]
    sel = a.sum(-1)
    steps = float(np.sum(sel * E))            # client-steps in the schedule
    out = Work(lanes_rounds=len(E))
    out.flops = (float(sel.sum()) * 2 * n * (w_s + w_c)   # the targets
                 + steps * B * 6 * (w_c + w_s))
    out.kl_bytes = 2 * kl_rows(steps * B, dsplit)
    N = a.shape[-1] * n
    for _ in range(int(np.sum(evals))):
        out.flops += 2 * N * (w_c + w_s + w_s) + 2 * n_test * (w_c + w_s)
        for d_in, d_out in zip(server[:-1], server[1:]):
            ops, nbytes = gram_pair(N, d_in + 1, d_out)
            out.flops += ops
            out.gram_ops += ops
            out.gram_bytes += nbytes
    return out


def full_model(cfg: dict, a: np.ndarray, E: np.ndarray, evals: np.ndarray,
               n: int, n_test: int) -> Work:
    """One lane's useful work in a full-model framework (SFL's arithmetic):
    E forward-backward steps of B rows a selected client a round, and the
    test forward at each evaluation."""
    m = cfg["model"]
    w = weights([m["n_features"], *m["hidden"], m["n_classes"]])
    steps = float(np.sum(a.sum(-1) * E))
    out = Work(lanes_rounds=len(E))
    out.flops = (steps * cfg["campaign"]["batch_size"] * 6 * w
                 + float(np.sum(evals)) * 2 * n_test * w)
    return out


COUNTERS = {"splitme": splitme, "sfl": full_model}


def least_kl_s(work: Work) -> float:
    return work.kl_bytes / PEAK_BYTES


def least_gram_s(work: Work) -> float:
    return max(work.gram_ops / PEAK_F32_MMA, work.gram_bytes / PEAK_BYTES)
