"""Mesh adapters over the engine (port of ``repro.core.distributed``): the
paper's communication pattern as real collectives over a client mesh
(``repro_torch.launch.mesh``).

* ``make_splitme_round`` — one SplitMe round over every client, the
  reference's ``(w_c, w_s⁻¹, x, y1, …)`` signature, a thin adapter over
  ``engine.build_sharded_round_fn``: the E local steps on both sides cross
  no rank, the masked FedAvg is the round's one all-reduce;
* ``make_distributed_inversion`` — Step 4 on the mesh: each rank's Gram
  partials, one all-reduce of [A0 | A1] a layer (eq. 9 exactly), a thin
  adapter over ``inversion.invert_inverse_model(mesh=)``.

Randomness is an input, as everywhere in the port: the round takes the
(n_phases, M, E, B) batch indices the reference draws from its key, and
under the int8 wire this rank's uniforms.
"""
from __future__ import annotations

import torch

from repro_torch.configs.splitme_dnn import DNNConfig
from repro_torch.core import engine
from repro_torch.core.inversion import invert_inverse_model


def make_splitme_round(cfg: DNNConfig, mesh, *, n_clients: int,
                       samples_per_client: int, E: int, batch: int = 32,
                       lr_c: float = 0.05, lr_s: float = 0.02,
                       temperature: float = 2.0, quant=None, device=None):
    """One SplitMe global round over the client mesh, every client
    selected (the dry-run cohort).

    Returns ``round_fn(w_c, w_s_inv, x, y1, idx, uniforms=None) -> (w_c',
    w_s_inv')`` over the full-M operands on every rank: ``x`` (M, n, d),
    ``y1`` (M, n, n_classes) one-hot, ``idx`` (2, M, E, batch) int64.  As in
    the reference the int8 error-feedback state starts at zero every call
    (``uniforms``: this rank's, int8 only); carry it across rounds with
    ``engine.build_sharded_round_fn``."""
    del samples_per_client  # shapes come from the data argument
    spec = engine.make_spec("splitme", cfg, lr_c=lr_c, lr_s=lr_s,
                            temperature=temperature, batch_size=batch,
                            masked_loss_metric=True, quant=quant,
                            device=device)
    rf = engine.build_sharded_round_fn(spec, cfg, mesh, n_clients=n_clients,
                                       e_max=E)

    def round_fn(w_c, w_s_inv, x, y1, idx, uniforms=None):
        y = y1.argmax(-1)
        a_mask = torch.ones(n_clients, dtype=torch.float32, device=x.device)
        qstate = engine.init_quant_state(spec, (w_c, w_s_inv))
        (w_c2, w_s2), _, _ = rf((w_c, w_s_inv), x, y, a_mask, E, idx, qstate,
                                uniforms)
        return w_c2, w_s2

    return round_fn


def make_distributed_inversion(cfg: DNNConfig, mesh, gamma: float = 1e-3,
                               policy=None):
    """Step 4 on the mesh: ``fn(w_s_inv, smashed, y1) -> server params``
    over the full-M ``smashed`` (M, n, d_split) and ``y1`` (M, n,
    n_classes), on every rank: each rank makes the Grams of its slab of the
    clients, one all-reduce a layer sums them (eq. 9 exactly), and every
    rank solves the same system."""
    def fn(w_s_inv, smashed, y1):
        sl = engine.shard_slice(mesh, smashed.shape[0])
        s = smashed[sl]
        with torch.no_grad():
            return invert_inverse_model(
                w_s_inv, s.reshape(-1, s.shape[-1]),
                y1[sl].reshape(-1, y1.shape[-1]), cfg, gamma=gamma,
                policy=policy, mesh=mesh)

    return fn

