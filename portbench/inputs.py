"""The benchmark's inputs, made from its seed: the synthetic COMMAG-style
O-RAN slice-traffic data (30 KPIs a sample, eMBB / mMTC / URLLC with
class overlap and label noise), its test split, the paper's non-IID
partition (one slice class a client, round-robin), and each campaign's
block of run seeds.  The generator is a copy of the program's
``repro_torch.data.oran`` (``generate``, ``partition_non_iid``,
``train_test_split``), so that the program receives data it did not make.
numpy only."""
from __future__ import annotations

from typing import Dict

import numpy as np

N_FEATURES, N_CLASSES = 30, 3


def _class_means(rng: np.random.Generator) -> np.ndarray:
    base = rng.normal(0.0, 1.0, (1, N_FEATURES))
    means = np.repeat(base, N_CLASSES, axis=0)
    means[0, 0:6] += 2.0     # eMBB: throughput / PRB / buffer KPIs
    means[1, 6:12] += 2.0    # mMTC: connection density / small packets
    means[2, 12:18] += 2.0   # URLLC: latency / reliability KPIs
    means[0, 12:15] += 0.8   # cross-talk between the classes
    means[2, 0:3] += 0.8
    means[1, 12:15] += 0.6
    return means


def generate(n_per_class: int, seed: int, noise: float = 2.2,
             label_noise: float = 0.03):
    """(X, y), shuffled, X standardised."""
    rng = np.random.default_rng(seed)
    means = _class_means(rng)
    xs, ys = [], []
    for c in range(N_CLASSES):
        f = rng.normal(0.0, 1.0, (n_per_class, 1))   # shared load factor
        x = means[c] + noise * rng.normal(0.0, 1.0, (n_per_class, N_FEATURES))
        x += 0.5 * f
        lbl = np.full(n_per_class, c)
        flip = rng.random(n_per_class) < label_noise
        lbl = np.where(flip, rng.integers(0, N_CLASSES, n_per_class), lbl)
        xs.append(x)
        ys.append(lbl)
    X = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.int32)
    X = (X - X.mean(0)) / (X.std(0) + 1e-6)
    idx = rng.permutation(len(y))
    return X[idx], y[idx]


def train_test_split(X, y, test_frac: float, seed: int):
    idx = np.random.default_rng(seed).permutation(len(y))
    n_test = int(len(y) * test_frac)
    return (X[idx[n_test:]], y[idx[n_test:]]), (X[idx[:n_test]],
                                                 y[idx[:n_test]])


def partition_non_iid(X, y, n_clients: int, samples_per_client: int,
                      seed: int) -> Dict[str, np.ndarray]:
    """One slice class a client (client m holds class m mod 3), each
    client's samples drawn with replacement from its class."""
    rng = np.random.default_rng(seed)
    by_class = [np.where(y == c)[0] for c in range(N_CLASSES)]
    Xc = np.zeros((n_clients, samples_per_client, X.shape[1]), np.float32)
    yc = np.zeros((n_clients, samples_per_client), np.int32)
    for m in range(n_clients):
        take = rng.choice(by_class[m % N_CLASSES], samples_per_client,
                          replace=True)
        Xc[m], yc[m] = X[take], y[take]
    return {"x": Xc, "y": yc}


class Inputs:
    """Everything a run draws from ``--seed``: the data (``clients``,
    ``test``) and, call by call, the next block of run seeds and the
    positions in it that the comparison checks."""

    def __init__(self, seed: int, data: dict, M: int):
        self.rng = np.random.default_rng(int(seed) % 2 ** 64)
        data_seed = int(self.rng.integers(2 ** 31))
        X, y = generate(data["n_per_class"], data_seed)
        train, self.test = train_test_split(X, y, data["test_frac"],
                                            data_seed)
        self.clients = partition_non_iid(*train, M,
                                         data["samples_per_client"],
                                         data_seed)
        self.used = set()

    def seeds(self, n: int):
        """The next ``n`` run seeds, distinct from every earlier one.  Each
        is below 2**31: a CPU generator keeps 32 bits of its seed."""
        out = []
        while len(out) < n:
            s = int(self.rng.integers(2 ** 31))
            if s not in self.used:
                self.used.add(s)
                out.append(s)
        return out

    def sample(self, n: int, k: int):
        """``k`` of the positions ``0 .. n-1``, sorted."""
        return sorted(int(i) for i in self.rng.choice(n, min(k, n),
                                                      replace=False))
