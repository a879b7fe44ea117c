"""Synthetic COMMAG-style O-RAN slice-traffic dataset — numpy copy of
``repro.data.oran`` (``generate``, ``partition_non_iid``,
``draw_client_shard``, ``partition_dirichlet``, ``train_test_split``), kept
call for call so the same seed gives the same arrays (pinned by
tests/test_torch_splitme.py and tests/test_torch_scenario.py).

Each sample is a 30-KPI vector with class-conditional structure (eMBB =
throughput / buffers, mMTC = small sporadic packets, URLLC = latency) and
deliberate class overlap; the non-IID partition stores exactly ONE slice
class per near-RT-RIC (paper §V-A), assigned round-robin.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

N_FEATURES = 30
N_CLASSES = 3          # 0 = eMBB, 1 = mMTC, 2 = URLLC


def _class_stats(rng: np.random.Generator):
    """Class-conditional means with heavy overlap on shared KPI factors."""
    base = rng.normal(0.0, 1.0, (1, N_FEATURES))
    means = np.repeat(base, N_CLASSES, axis=0)
    # class-discriminative KPI groups
    means[0, 0:6] += 2.0     # eMBB: throughput / PRB / buffer KPIs
    means[1, 6:12] += 2.0    # mMTC: connection density / small-packet KPIs
    means[2, 12:18] += 2.0   # URLLC: latency / reliability KPIs
    # cross-talk between classes (overlap → imperfect separability)
    means[0, 12:15] += 0.8
    means[2, 0:3] += 0.8
    means[1, 12:15] += 0.6
    return means


def generate(n_per_class: int = 2000, seed: int = 0, noise: float = 2.2,
             label_noise: float = 0.03) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (X, y) shuffled; X standardised."""
    rng = np.random.default_rng(seed)
    means = _class_stats(rng)
    xs, ys = [], []
    for c in range(N_CLASSES):
        # temporal burst factor shared within a class (AR(1)-flavoured)
        f = rng.normal(0.0, 1.0, (n_per_class, 1))
        x = means[c] + noise * rng.normal(0.0, 1.0, (n_per_class, N_FEATURES))
        x += 0.5 * f                       # common-mode load factor
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


def partition_non_iid(X: np.ndarray, y: np.ndarray, n_clients: int,
                      samples_per_client: int, seed: int = 0
                      ) -> Dict[str, np.ndarray]:
    """One slice class per client (round-robin), as in the paper.

    Returns stacked arrays:  Xc (M, n, d), yc (M, n).
    """
    rng = np.random.default_rng(seed)
    by_class = [np.where(y == c)[0] for c in range(N_CLASSES)]
    Xc = np.zeros((n_clients, samples_per_client, X.shape[1]), np.float32)
    yc = np.zeros((n_clients, samples_per_client), np.int32)
    for m in range(n_clients):
        c = m % N_CLASSES
        take = rng.choice(by_class[c], samples_per_client, replace=True)
        Xc[m], yc[m] = X[take], y[take]
    return {"x": Xc, "y": yc}


# below this α the Dirichlet draw is numerically a point mass — use the
# exact one-class-per-client draw instead of sampling it
_ALPHA_SEED_EXACT = 1e-6


def draw_client_shard(rng: np.random.Generator, by_class, samples_per_client:
                      int, alpha, anchor: int) -> np.ndarray:
    """One client's shard draw — sample indices into (X, y) from the class
    pools ``by_class`` using the generator ``rng``.  ``alpha`` None (or below
    the point-mass threshold) is the paper's one-class-per-client draw from
    the ``anchor`` class pool; otherwise an anchored Dirichlet(α) mixture.
    Classes absent from ``y`` (empty pools) get probability zero."""
    n_classes = len(by_class)
    pool_ok = np.array([len(b) > 0 for b in by_class])
    if not pool_ok.any():
        raise ValueError("all class pools are empty; nothing to sample")
    if alpha is None or alpha <= _ALPHA_SEED_EXACT:
        if not pool_ok[anchor]:
            anchor = int(np.argmax(pool_ok))
        return rng.choice(by_class[anchor], samples_per_client, replace=True)
    p = rng.dirichlet(np.full(n_classes, float(alpha)))
    # swap the largest share onto the anchor class
    top = int(np.argmax(p))
    p[anchor], p[top] = p[top], p[anchor]
    if not pool_ok.all():
        p = np.where(pool_ok, p, 0.0)
        s = p.sum()
        p = p / s if s > 0 else pool_ok / pool_ok.sum()
    counts = rng.multinomial(samples_per_client, p)
    take = np.concatenate([
        rng.choice(by_class[c], counts[c], replace=True)
        for c in range(n_classes) if counts[c] > 0])
    return take[rng.permutation(samples_per_client)]


def partition_dirichlet(X: np.ndarray, y: np.ndarray, n_clients: int,
                        samples_per_client: int, alpha: float,
                        seed: int = 0) -> Dict[str, np.ndarray]:
    """Dirichlet(α) non-IID partition generalizing ``partition_non_iid``:
    client m draws class shares p_m ~ Dir(α·1), the largest swapped onto
    its anchor class m % C, and samples its points from the class pools
    accordingly.  α ≤ 1e-6 is the paper's one-class-per-client split
    exactly.  Returns stacked arrays:  Xc (M, n, d), yc (M, n)."""
    if alpha < 0:
        raise ValueError(f"alpha must be >= 0, got {alpha}")
    if alpha <= _ALPHA_SEED_EXACT:
        return partition_non_iid(X, y, n_clients, samples_per_client, seed)
    rng = np.random.default_rng(seed)
    by_class = [np.where(y == c)[0] for c in range(N_CLASSES)]
    Xc = np.zeros((n_clients, samples_per_client, X.shape[1]), np.float32)
    yc = np.zeros((n_clients, samples_per_client), np.int32)
    for m in range(n_clients):
        take = draw_client_shard(rng, by_class, samples_per_client, alpha,
                                 m % N_CLASSES)
        Xc[m], yc[m] = X[take], y[take]
    return {"x": Xc, "y": yc}


def train_test_split(X, y, test_frac: float = 0.2, seed: int = 0):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(y))
    n_test = int(len(y) * test_frac)
    te, tr = idx[:n_test], idx[n_test:]
    return (X[tr], y[tr]), (X[te], y[te])
