"""The baseline FL frameworks the paper compares SplitMe against (§V-A),
plus the registry's two resource-allocation baselines; port of
``repro.core.baselines``.

* **FedAvg** — K = 10 random clients, E = 10, full-model local training.
* **Vanilla SFL** — K = 20, E = 14; the smashed batch and its boundary
  gradients cross the split every local step (counted in comm_bits).
* **O-RANFed** — FedAvg with deadline-aware selection and min-max
  bandwidth (Alg. 1), the whole model on the client.
* **FedORA** (arXiv 2505.19211) — the RIC admits the largest fastest-first
  cohort whose min-max allocation meets every admitted deadline.
* **EcoFL** (arXiv 2507.21698) — the K lowest-energy clients, min-max
  bandwidth over them.

Each trains the whole DNN on cross-entropy through the engine's one-phase
round (``engine._mlp_spec``) and differs only in its comm model and host
policy.  Randomness is an input as in ``SplitMeTrainer``: one CPU generator
seeded with ``seed`` draws the initial weights (unless ``params`` gives
them) and then each round's batch indices (unless ``index_source`` gives
them), a second one the int8 uniforms (unless ``uniform_source`` gives
them); so a trainer with ``seed=s`` equals seed s of its framework's
campaign with the same K and E (for FedAvg and SFL, whose cohorts are
random, when the campaign's ``policy_seed`` is s too).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.configs.splitme_dnn import DNNConfig
from repro_torch.core import engine
from repro_torch.core.cost import SystemParams
from repro_torch.core.engine import RoundMetrics
from repro_torch.core.splitme import (IndexSource, UniformSource,
                                      _SerialTrainer)
from repro_torch.device import DeviceLike

__all__ = ["FedAvgTrainer", "SFLTrainer", "ORANFedTrainer", "FedORATrainer",
           "EcoFLTrainer"]


class _FLBase(_SerialTrainer):
    """Engine round + host policy + the paper's metrics, for one framework.

    The round is built with ``e_max = E`` (fixed E: every step runs).
    ``interactive=True`` pulls each round's loss (and accuracy) to the host
    as it ends; by default they stay device tensors until
    ``fetch_history``.  ``device`` defaults to the card; ``params`` is the
    initial ``(w,)``; ``index_source(round) -> (1, M, E, batch_size)``
    int64 and ``uniform_source(round) -> (U,)`` f32."""

    framework: str

    def __init__(self, cfg: DNNConfig, sp: SystemParams,
                 client_data: Dict[str, np.ndarray],
                 test_data: Tuple[np.ndarray, np.ndarray], lr: float,
                 E: int, batch_size: int, seed: int, K: int = 10,
                 kernel_policy=None, comm_quant=None, scenario=None,
                 interactive: bool = False, *, device: DeviceLike = None,
                 params=None, index_source: Optional[IndexSource] = None,
                 uniform_source: Optional[UniformSource] = None):
        self.E = E
        self.interactive = interactive
        (self.params,) = self._setup(
            self.framework, cfg, sp, client_data, test_data, seed=seed,
            device=device, params=params, index_source=index_source,
            uniform_source=uniform_source, scenario=scenario,
            policy_kw=dict(seed=seed, K=K, E=E, quant=comm_quant),
            spec_kw=dict(lr=lr, batch_size=batch_size, policy=kernel_policy,
                         quant=comm_quant))
        self._qstate = engine.init_quant_state(self._spec, (self.params,))
        self._round_fn = engine.build_round_fn(self._spec, cfg, self.x,
                                               self.y, e_max=E)
        self._eval_fn = engine.build_eval_fn(self._spec, cfg, self.x_test,
                                             self.y_test)

    def _params(self) -> tuple:
        return (self.params,)

    def _e_max(self) -> int:
        return self.E

    def run_round(self, eval_acc: bool = False) -> RoundMetrics:
        a, b, self.E = self._plan()
        a_mask, idx, uniforms = self._operands(a)
        (self.params,), (loss,), self._qstate = self._round_fn(
            (self.params,), a_mask, self.E, idx, self._qstate, uniforms)
        acc = self._eval_fn((self.params,)) if eval_acc else float("nan")
        if self.interactive:
            loss, acc = float(loss), float(acc)
        return self._metrics(a, b, client_loss=loss, accuracy=acc)

    def evaluate(self) -> float:
        return float(self._eval_fn((self.params,)))


class FedAvgTrainer(_FLBase):
    """K fixed random clients per round, uniform bandwidth."""

    framework = "fedavg"

    def __init__(self, cfg, sp, client_data, test_data, *, K: int = 10,
                 E: int = 10, lr: float = 0.05, batch_size: int = 32,
                 seed: int = 0, **kw):
        super().__init__(cfg, sp, client_data, test_data, lr, E, batch_size,
                         seed, K=K, **kw)
        self.K = K


class SFLTrainer(_FLBase):
    """Vanilla SplitFed: the same joint gradients, the boundary tensors
    crossing on every local batch (counted in comm_bits)."""

    framework = "sfl"

    def __init__(self, cfg, sp, client_data, test_data, *, K: int = 20,
                 E: int = 14, lr: float = 0.05, batch_size: int = 32,
                 seed: int = 0, **kw):
        super().__init__(cfg, sp, client_data, test_data, lr, E, batch_size,
                         seed, K=K, **kw)
        self.K = K


class ORANFedTrainer(_FLBase):
    """O-RANFed: deadline-aware selection + min-max bandwidth, full-model
    FL (no split)."""

    framework = "oranfed"

    def __init__(self, cfg, sp, client_data, test_data, *, E: int = 10,
                 lr: float = 0.05, batch_size: int = 32, seed: int = 0,
                 **kw):
        super().__init__(cfg, sp, client_data, test_data, lr, E, batch_size,
                         seed, **kw)


class FedORATrainer(_FLBase):
    """FedORA: full-model FL, the cohort set each round by the RIC's
    deadline-feasible min-max allocation."""

    framework = "fedora"

    def __init__(self, cfg, sp, client_data, test_data, *, E: int = 10,
                 lr: float = 0.05, batch_size: int = 32, seed: int = 0,
                 **kw):
        super().__init__(cfg, sp, client_data, test_data, lr, E, batch_size,
                         seed, **kw)


class EcoFLTrainer(_FLBase):
    """EcoFL: full-model FL, the K lowest-energy clients each round,
    min-max bandwidth over them."""

    framework = "ecofl"

    def __init__(self, cfg, sp, client_data, test_data, *, K: int = 10,
                 E: int = 10, lr: float = 0.05, batch_size: int = 32,
                 seed: int = 0, **kw):
        super().__init__(cfg, sp, client_data, test_data, lr, E, batch_size,
                         seed, K=K, **kw)
        self.K = K
