"""SplitMe with system optimization (paper Algorithm 2); port of
``repro.core.splitme.SplitMeTrainer``.

Per global round:
  1. Algorithm 1 decides the participant set A_t (deadline-aware).
  2. P2 allocates bandwidth + adapts the local-update count E.
  3. Each selected xApp runs E local SGD steps on D_KL(c(X) ‖ s⁻¹(Y)).
  4. Each rApp runs E SGD steps on D_KL(s⁻¹(Y) ‖ c(X)).
  5. The non-RT-RIC aggregates both sides (masked FedAvg over A_t).
  Final round: the server-side model is recovered analytically
  (``repro_torch.core.inversion``) — one shot, one communication round.

The round itself lives in ``repro_torch.core.engine``.  Randomness comes
from one CPU ``torch.Generator`` seeded with ``seed``: it draws the initial
weights (unless ``params=`` passes them in) and every round's batch indices
(unless ``index_source`` supplies them), so one seed gives one run on any
device.  The int8 wire format's uniforms come from a second generator of
their own, seeded from ``seed`` too (unless ``uniform_source`` supplies
them), so every other wire format draws exactly the same batches.

``kernel_policy`` (a preset name or a ``KernelPolicy``; ``"kernel_bf16"``
is bf16 on the card, f32 on the CPU) and ``comm_quant`` (``"none"`` /
``"bf16"`` / ``"int8"``) are bound into the trainer's spec; the int8
error-feedback state is carried from round to round.  ``scenario`` (a
``repro_torch.core.scenario.ScenarioTrace``; a serial trainer has no round
horizon to build one from a name) rewrites the derived SystemParams to each
round's RAN state before the policy steps, and the realized mask drops the
clients that fail mid-round; a trace's fault channels are ignored, as the
reference's trainers ignore them (the scanned campaign injects them).

``_SerialTrainer`` holds what the SplitMe trainer and the baselines'
(``repro_torch.core.baselines``) share: the device and data, the run's
generators, the per-round operands and the scenario.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.splitme_dnn import DNNConfig
from repro_torch.core import dnn, engine, scenario as scen
from repro_torch.core.cost import (SystemParams, round_cost, round_energy,
                                   total_time)
from repro_torch.core.engine import RoundMetrics, fetch_history
from repro_torch.core.inversion import invert_inverse_model
from repro_torch.device import DeviceLike, resolve_device

__all__ = ["RoundMetrics", "SplitMeTrainer"]

IndexSource = Callable[[int], torch.Tensor]
UniformSource = Callable[[int], torch.Tensor]


def _to_device(params, device: torch.device):
    """Initial parameters given as tensors or numpy arrays -> f32 on device."""
    return [{k: (v if isinstance(v, torch.Tensor) else torch.tensor(v))
             .to(device=device, dtype=torch.float32)
             for k, v in p.items()} for p in params]


class _SerialTrainer:
    """The parts of a serial trainer that do not depend on its framework.

    ``_setup`` takes the data onto ``device`` (the card unless ``"cpu"``),
    builds the policy and the spec, seeds the run's generator (which draws
    the initial weights, unless ``params`` gives them, and then each
    round's batch indices) and the int8 uniforms' own generator, and checks
    the scenario.  ``_plan`` steps the policy against the round's RAN
    state; ``_operands`` draws, checks and uploads a round's inputs."""

    def _setup(self, name, cfg, sp, client_data, test_data, *, seed, device,
               params, index_source, uniform_source, scenario, policy_kw,
               spec_kw):
        self.device = resolve_device(device)
        self.cfg = cfg
        dev = self.device
        self.x = torch.as_tensor(client_data["x"], dtype=torch.float32,
                                 device=dev)                 # (M, n, d)
        self.y = torch.as_tensor(client_data["y"], dtype=torch.int64,
                                 device=dev)                 # (M, n)
        self.x_test = torch.as_tensor(test_data[0], dtype=torch.float32,
                                      device=dev)
        self.y_test = torch.as_tensor(test_data[1], dtype=torch.int64,
                                      device=dev)
        # private SystemParams copy + the framework's policy (never mutates
        # `sp`); the policy reads this same copy, so a scenario's rewrites
        # reach its selection
        self.sp, self.policy = engine.make_policy(name, sp, cfg, **policy_kw)
        if isinstance(scenario, str):
            raise TypeError(
                "serial trainers need a concrete ScenarioTrace (the round "
                "horizon is open-ended): build one with scenario.make_trace("
                f"{scenario!r}, rounds, M) or run a campaign")
        self._trace = scenario
        self._trace_base = (scen.capture_base(self.sp)
                            if scenario is not None else None)
        self._spec = engine.make_spec(name, cfg, device=dev, **spec_kw)
        self.generator = torch.Generator().manual_seed(seed)
        if params is None:
            params = self._spec.init_fn(self.generator, dev)
        self._index_source = index_source or self._draw_indices
        self._uniform_gen = engine.uniform_generator(seed)
        self._uniform_source = uniform_source or self._draw_uniforms
        self.history: List[RoundMetrics] = []
        self._round = 0
        return tuple(_to_device(p, dev) for p in params)

    def _params(self) -> tuple:
        raise NotImplementedError

    def _e_max(self) -> int:
        raise NotImplementedError

    def _draw_indices(self, round_idx: int) -> torch.Tensor:
        """This round's batch indices from the trainer's CPU generator."""
        M, n = self.x.shape[0], self.x.shape[1]
        shape = (len(self._spec.phases), M, self._e_max(),
                 self._spec.batch_size)
        return torch.randint(0, n, shape, generator=self.generator)

    def _draw_uniforms(self, round_idx: int) -> torch.Tensor:
        """This round's int8 uniforms from the trainer's second generator."""
        return engine.quant_uniforms(self._spec, self._params(),
                                     self._uniform_gen)

    def _plan(self):
        """The policy's (a, b, E) against round t's RAN state; ``a`` is the
        realized mask under a scenario."""
        if self._trace is not None:
            scen.apply_round(self.sp, self._trace_base, self._trace,
                             self._round)
        a, b, e = self.policy.step()
        if self._trace is not None:
            a = scen.realized_mask(a, self._trace, self._round)
        return a, b, e

    def _operands(self, a):
        """(a_mask, batch indices, int8 uniforms or None) on the device."""
        idx = self._index_source(self._round)
        n = self.x.shape[1]
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n):
            raise ValueError(f"batch indices must lie in [0, {n})")
        idx = idx.to(self.device)
        a_mask = torch.as_tensor(a, dtype=torch.float32, device=self.device)
        uniforms = None
        if self._spec.quant.stochastic:
            uniforms = torch.as_tensor(self._uniform_source(self._round),
                                       dtype=torch.float32).to(self.device)
        return a_mask, idx, uniforms

    def _metrics(self, a, b, **values) -> RoundMetrics:
        sp, e = self.sp, self.E
        m = RoundMetrics(
            round=self._round, n_selected=int(a.sum()), E=e,
            comm_bits=self._spec.comm_model(a, e, sp),
            sim_time=total_time(a, b, e, sp),
            cost=round_cost(a, b, e, sp),
            energy=round_energy(a, b, e, sp), **values)
        self._round += 1
        self.history.append(m)
        return m

    def fetch_history(self) -> List[RoundMetrics]:
        """Resolve buffered device-tensor metrics to floats in ONE
        device→host transfer (call once at campaign end)."""
        return fetch_history(self.history)


class SplitMeTrainer(_SerialTrainer):
    """Runs the full Algorithm 2 over the partitioned O-RAN dataset.

    ``device`` defaults to the card and raises where there is none.
    ``interactive=True`` pulls each round's losses (and accuracy) to the
    host as it ends; by default they stay device tensors until
    ``fetch_history``.  ``params`` optionally gives the initial
    ``(w_c, w_s_inv)``.
    ``index_source(round) -> (2, M, E_max, batch_size)`` int64 optionally
    gives each round's batch indices, ``uniform_source(round) -> (U,)`` f32
    the int8 uniforms (``engine.quant_uniforms``'s layout)."""

    def __init__(self, cfg: DNNConfig, sp: SystemParams,
                 client_data: Dict[str, np.ndarray],
                 test_data: Tuple[np.ndarray, np.ndarray],
                 lr_c: float = 0.05, lr_s: float = 0.02,
                 temperature: float = 2.0, batch_size: int = 32,
                 e_initial: int = 20, gamma: float = 1e-3, seed: int = 0,
                 kernel_policy=None, comm_quant=None, scenario=None,
                 interactive: bool = False, *, device: DeviceLike = None,
                 params: Optional[Tuple[List[dict], List[dict]]] = None,
                 index_source: Optional[IndexSource] = None,
                 uniform_source: Optional[UniformSource] = None):
        if not lr_c > lr_s:
            raise ValueError("Corollary 3: η_C > η_S (B_1 < B_2)")
        n_m = int(np.shape(client_data["x"])[1])
        self.w_c, self.w_s_inv = self._setup(
            "splitme", cfg, sp, client_data, test_data, seed=seed,
            device=device, params=params, index_source=index_source,
            uniform_source=uniform_source, scenario=scenario,
            policy_kw=dict(e_initial=e_initial, n_samples_per_client=n_m,
                           quant=comm_quant),
            spec_kw=dict(lr_c=lr_c, lr_s=lr_s, temperature=temperature,
                         batch_size=batch_size, policy=kernel_policy,
                         quant=comm_quant))
        self.gamma = gamma
        self.interactive = interactive
        self._qstate = engine.init_quant_state(self._spec,
                                               (self.w_c, self.w_s_inv))
        self.E = e_initial
        self._round_fn = engine.build_round_fn(
            self._spec, cfg, self.x, self.y, e_max=self.sp.E_max)
        self._eval_fn = engine.build_eval_fn(
            self._spec, cfg, self.x_test, self.y_test,
            client_data={"x": self.x, "y": self.y}, gamma=gamma)

    def _params(self) -> tuple:
        return (self.w_c, self.w_s_inv)

    def _e_max(self) -> int:
        return self.sp.E_max

    # ------------------------------------------------------------------
    def run_round(self, eval_acc: bool = False) -> RoundMetrics:
        # P1 + P2: deadline-aware selection, bandwidth, adaptive E
        a, b, self.E = self._plan()
        a_mask, idx, uniforms = self._operands(a)
        (self.w_c, self.w_s_inv), (closs, sloss), self._qstate = \
            self._round_fn((self.w_c, self.w_s_inv), a_mask, self.E, idx,
                           self._qstate, uniforms)
        acc = (self._eval_fn((self.w_c, self.w_s_inv)) if eval_acc
               else float("nan"))
        if self.interactive:
            closs, sloss, acc = float(closs), float(sloss), float(acc)
        return self._metrics(a, b, client_loss=closs, server_loss=sloss,
                             accuracy=acc)

    # ------------------------------------------------------------------
    def finalize(self) -> List[dict]:
        """Step 4: analytic inversion using all clients' smashed data; the
        Gram products and the precision follow the trainer's kernel
        policy."""
        cfg = self.cfg
        with torch.no_grad():
            smashed = dnn.client_forward(self.w_c, self.x, cfg,
                                         precision=self._spec.policy.precision)
            y1 = torch.nn.functional.one_hot(self.y, cfg.n_classes).float()
            return invert_inverse_model(
                self.w_s_inv, smashed.reshape(-1, smashed.shape[-1]),
                y1.reshape(-1, cfg.n_classes), cfg, gamma=self.gamma,
                policy=self._spec.policy)

    def evaluate(self, w_server: Optional[List[dict]] = None) -> float:
        if w_server is not None:
            with torch.no_grad():
                logits = dnn.full_forward(
                    self.w_c, w_server, self.x_test, self.cfg,
                    precision=self._spec.policy.precision)
                return float((logits.argmax(-1) == self.y_test)
                             .float().mean())
        return float(self._eval_fn((self.w_c, self.w_s_inv)))
