"""Federated round engine for the framework registry — SplitMe and the
five baselines (FedAvg, vanilla SFL, O-RANFed, FedORA, EcoFL); port of
``repro.core.engine``.

A framework contributes a ``FrameworkSpec``: one or more ``PhaseSpec``s (a
per-batch ``local_step`` loss plus how the phase's per-client inputs and
targets derive from the round state), a ``comm_model`` and a host-side
selection/allocation ``Policy``.  The engine owns the round:

* replication of the global parameters onto a written-out client axis —
  weights are held stacked as (C, d_in, d_out) / (C, d_out), standing in for
  the JAX package's vmap over clients,
* the masked local SGD: step i updates only while i < E, as
  ``p − lr·do·g`` with ``do = (i < E)``, and every step draws its batch and
  computes its loss.  The full round (the trainer's) runs no backward for
  the frozen tail after a host-side int E, where the reference computes the
  exact no-op p − lr·0·g,
* the loss metric: the mean over all E_max steps, frozen tail included (the
  reference SplitMe metric), or with ``loss_over_mask`` over the executed
  steps only (the campaign's),
* masked FedAvg over the selected set A_t, with |A_t| clamped to ≥ 1, its
  payload (the numerators, |A_t| and the loss sums) in the spec's wire
  format (``quantcomm``): int8 quantizes the numerators with error
  feedback carried in ``qstate``, bf16 rounds the whole payload.

``build_round_fn(gather=True)`` trains only a gathered, padded client
cohort, for one or more seeds at once: the seeds' stacked parameters are replicated onto their cohorts and the (seed, cohort) pairs
folded into the one client axis, so a kernel launch covers every seed.
``build_cohort_round_fn`` is the same round with the client data as
arguments (population mode: every round samples a new cohort).

Randomness is an input: JAX's threefry streams cannot be reproduced, so the
round takes the per-phase, per-client, per-step batch indices as an
``(n_phases, M, E_max, B)`` int64 tensor, and under int8 the stochastic
rounding's uniforms as an f32 tensor.  Per-client gradients come from one
backward of the sum of per-client losses (the clients are independent).

The spec's kernel policy carries the precision: under bf16 the client
dataset is cast once, when the round is built, and the forwards run mixed
(``dnn.mlp_forward``).

The baselines train the whole ``cfg.layer_dims`` MLP on cross-entropy in one
phase (``_mlp_spec``) and differ only in their comm model and host policy;
they call no kernel of their own (their forward, loss and backward are plain
PyTorch, as the reference's are plain jnp).

Fault injection and the in-round guards (``RoundGuards``) act on the
uploaded per-client deltas and on the aggregate, inside the round: the
wire-gain and NaN-poison channels of a ``faults:p`` trace, a per-client norm
clip, the non-finite rollback and the quorum hold (``_round_core``).

The sharded round (``build_sharded_round_fn``, and the campaign's rounds
under ``mesh=``) shards the clients over a ``torch.distributed`` device mesh
(``repro_torch.launch.mesh``): each rank trains its contiguous slab of the
clients and the masked-FedAvg payload crosses the mesh as ONE all-reduce a
round (``all_reduce_bundle``), the paper's "one communication per round".
int8 quantizes each rank's partial sums with that rank's residual and
uniforms before it; bf16 narrows the all-reduce itself.
"""
from __future__ import annotations

import functools
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.splitme_dnn import DNNConfig
from repro_torch.core import dnn, quantcomm
from repro_torch.core.allocation import solve_bandwidth, solve_p2
from repro_torch.core.cost import SystemParams, uplink_time
from repro_torch.core.inversion import (invert_inverse_model,
                                        invert_inverse_models)
from repro_torch.core.quantcomm import CommQuant
from repro_torch.core.selection import (SelectionState, initial_state,
                                        select_trainers, update_state)
from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import KernelPolicy, PolicyLike

Params = List[dict]                 # [{"w", "b"}] per layer
ParamsTuple = Tuple[Params, ...]

# the bundled all-reduces of the sharded rounds and of Step 4 on a mesh:
# ``all_reduce_bundle`` adds one where it calls ``dist.all_reduce`` (a CUDA
# graph's replays do not move it, as they do not move the kernels' counters)
ALL_REDUCES = 0


@dataclass(frozen=True)
class RoundGuards:
    """In-round fault guards (``repro_torch.launch.resilience``).

    ``nonfinite``   — a non-finite aggregate rolls the round back: the
                      previous params and error-feedback state are held
                      (counted in ``skipped_rounds``),
    ``min_clients`` — quorum: a realized cohort |A_t| below it holds the
                      round instead of averaging over a near-empty set
                      (counted in ``quorum_rounds``; 1 arms no hold),
    ``clip_norm``   — optional: each client's update clipped to this global
                      L2 norm where it is quantized for the wire (bounds a
                      finite corruption; a NaN update stays NaN and meets
                      the rollback).

    All three are tensor operations inside the round: a guarded campaign
    stays one CUDA graph a round shape with one host transfer."""
    nonfinite: bool = True
    min_clients: int = 1
    clip_norm: Optional[float] = None


@dataclass
class RoundMetrics:
    round: int
    n_selected: int
    E: int
    comm_bits: float          # uplink volume this round (all selected)
    sim_time: float           # eq. 18 latency (s)
    cost: float               # eq. 20
    energy: float = float("nan")
    # accuracy / losses hold 0-d DEVICE tensors while a trainer runs;
    # ``fetch_history`` resolves them in one transfer
    accuracy: float = float("nan")
    client_loss: float = float("nan")
    server_loss: float = float("nan")
    # a guarded campaign's accounting (0 without guards): the share of
    # seeds whose round was rolled back / held for quorum, and whether the
    # round was a server crash
    skipped: float = 0.0
    quorum_held: float = 0.0
    crashed: float = 0.0


def fetch_history(history) -> list:
    """Resolve the buffered device-tensor metrics of a trainer's history to
    python floats with ONE device→host transfer."""
    flat = [v for m in history
            for v in (m.client_loss, m.server_loss, m.accuracy)]
    dev = [v.detach().float().reshape(()) for v in flat
           if isinstance(v, torch.Tensor)]
    host = iter(torch.stack(dev).cpu().tolist() if dev else [])
    vals = [next(host) if isinstance(v, torch.Tensor) else float(v)
            for v in flat]
    for i, m in enumerate(history):
        m.client_loss, m.server_loss, m.accuracy = vals[3 * i: 3 * i + 3]
    return history


@dataclass(frozen=True)
class PhaseSpec:
    """One masked local-SGD phase of a round.

    ``loss_fn(w, x_batch, target_batch)`` maps stacked per-client weights
    and (M, B, ·) batches to the (M,) per-client losses; ``data_key`` picks
    the per-client input array from the round context ({"x", "y", "y1"});
    ``target_fn(params, updated, ctx)`` builds the (M, n, ·) targets, where
    ``updated`` maps param indices to the per-client (stacked) weights
    already trained by earlier phases this round.
    """
    name: str
    param_idx: int
    lr: float
    loss_fn: Callable[[Params, torch.Tensor, torch.Tensor], torch.Tensor]
    data_key: str
    target_fn: Callable[[ParamsTuple, Dict[int, Params],
                         Dict[str, torch.Tensor]], torch.Tensor]
    # False: the loss metric is the mean over all E_max steps (the seed
    # SplitMe metric); True: the mean over the executed steps only
    loss_over_mask: bool = True


@dataclass(frozen=True)
class FrameworkSpec:
    name: str
    # init_fn(generator, device) draws the initial parameters
    init_fn: Callable[[torch.Generator, torch.device], ParamsTuple]
    phases: Tuple[PhaseSpec, ...]
    comm_model: Callable[[np.ndarray, int, SystemParams], float]
    batch_size: int
    # the RESOLVED kernel policy (and precision) the phase losses were
    # built with
    policy: KernelPolicy = dispatch.KERNEL
    # the wire format of the masked-FedAvg payload
    quant: CommQuant = quantcomm.NONE


# ---------------------------------------------------------------------------
# The client mesh: one shard a rank, one bundled all-reduce a round
# ---------------------------------------------------------------------------

def client_axes(mesh) -> Tuple[str, ...]:
    """The mesh dims the client axis shards over: ``("pod", "data")`` on a
    mesh with a ``pod`` dim, else ``("data",)`` (the sharded rounds and
    Step 4 on the mesh agree on this).  A trailing ``model`` dim
    replicates the clients: the ranks along it hold the same slab."""
    return ("pod", "data") if "pod" in _dim_names(mesh) else ("data",)


_MESH_DIMS = (("data",), ("pod", "data"), ("data", "model"),
              ("pod", "data", "model"))


def _dim_names(mesh) -> Tuple[str, ...]:
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(launch.mesh.make_client_mesh), got "
                        f"{type(mesh).__name__}")
    names = tuple(mesh.mesh_dim_names or ())
    if names not in _MESH_DIMS:
        raise ValueError(f"mesh dims must be one of {_MESH_DIMS}, got "
                         f"{names}")
    return names


def _mesh_ranks(mesh) -> List[int]:
    """The mesh's ranks, row-major.  The mesh must hold every rank of the
    process group in order, so that its flattened client group is the
    default group (on a mesh with a ``model`` dim: the union of the
    client groups)."""
    _dim_names(mesh)
    ranks = mesh.mesh.flatten().tolist()
    if ranks != list(range(dist.get_world_size())):
        raise ValueError(f"the client mesh must hold the process group's "
                         f"ranks 0..{dist.get_world_size() - 1} in order, "
                         f"got {ranks}")
    return ranks


def n_client_shards(mesh) -> int:
    """Number of client shards on ``mesh``: the product of its client dims
    (the leading axis of the gathered error-feedback layout,
    ``init_quant_state(n_shards=)``)."""
    names = _dim_names(mesh)
    n = 1
    for a in client_axes(mesh):
        n *= int(mesh.mesh.shape[names.index(a)])
    return n


def shard_index(mesh) -> int:
    """This rank's client shard: its row-major position over the client
    dims, pod major (the reference's ``shard_index()`` inside
    ``shard_map``); the ranks along a ``model`` dim share it."""
    _mesh_ranks(mesh)
    names, coord = _dim_names(mesh), mesh.get_coordinate()
    idx = 0
    for a in client_axes(mesh):
        i = names.index(a)
        idx = idx * int(mesh.mesh.shape[i]) + int(coord[i])
    return idx


_CLIENT_GROUPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def client_group(mesh):
    """The process group over which this rank's client shards sum: None
    (the default group) on a mesh of client dims only; with a ``model``
    dim, the ranks that share this rank's ``model`` coordinate (the
    reference's ``psum`` over ``client_axes``).  Made once a mesh: every
    rank makes the same call."""
    names = _dim_names(mesh)
    if "model" not in names:
        return None
    group = _CLIENT_GROUPS.get(mesh)
    if group is None:
        axes = client_axes(mesh)
        sub = mesh[axes] if len(axes) > 1 else mesh[axes[0]]
        group = (sub._flatten() if len(axes) > 1 else sub).get_group()
        _CLIENT_GROUPS[mesh] = group
    return group


def shard_slice(mesh, n_clients: int) -> slice:
    """This rank's contiguous slab of ``n_clients`` clients (the
    reference's ``P(client_axes)`` placement); raises when the shards do
    not divide the clients."""
    n = n_client_shards(mesh)
    if n_clients % n:
        raise ValueError(f"n_clients={n_clients} not divisible by the {n} "
                         f"client shards of mesh axes {client_axes(mesh)}")
    m = n_clients // n
    i = shard_index(mesh)
    return slice(i * m, (i + 1) * m)


def all_reduce_bundle(tree, mesh, wire_dtype: Optional[torch.dtype] = None):
    """Sum a whole tree over the mesh's client shards as ONE all-reduce:
    ravel and concatenate the leaves, one ``dist.all_reduce`` over the
    mesh's client group (``client_group``), split back (port of ``psum_bundle``).  ``wire_dtype``
    (bf16) rounds the bundle to it before the all-reduce and widens it back
    after: NCCL and gloo then sum in that type.  Counts the call in
    ``ALL_REDUCES``."""
    global ALL_REDUCES
    group = client_group(mesh)
    _mesh_ranks(mesh)
    leaves = quantcomm.tree_leaves(tree)
    out_dtype = leaves[0].dtype
    vec = torch.cat([l.reshape(-1) for l in leaves])
    if wire_dtype is not None:
        vec = vec.to(wire_dtype)
    dist.all_reduce(vec, op=dist.ReduceOp.SUM, group=group)
    ALL_REDUCES += 1
    vec = vec.to(out_dtype)
    parts = torch.split(vec, [l.numel() for l in leaves])
    return quantcomm._unflatten_like(
        tree, [p.reshape(l.shape) for p, l in zip(parts, leaves)])


def replicate(params: Params, m: int) -> Params:
    """Broadcast global params onto the client axis (a view, no copy)."""
    return [{k: v.expand(m, *v.shape) for k, v in p.items()} for p in params]


def _fold(params: Params, kb: int) -> Params:
    """Seed-stacked (S, ...) params onto each seed's ``kb`` cohort slots:
    (S·kb, ...), seed-major (a view for one seed, a copy for more)."""
    return [{k: v.unsqueeze(1).expand(v.shape[0], kb, *v.shape[1:])
             .reshape(v.shape[0] * kb, *v.shape[1:]) for k, v in p.items()}
            for p in params]


def _phase_runner(phase: PhaseSpec, e_max: int):
    """Masked e_max-step SGD of the phase's loss over a stacked cohort.

    ``do`` is the (e_max,) f32 executed-step mask on the data's device,
    or a (C, e_max) mask of each slot's own steps; the first ``n_grad``
    steps run a backward and the update ``p − (lr·do_i)·g`` (the
    reference's order), the rest compute only their loss.  Returns the
    trained weights and the (C,) loss metric."""
    def run(w: Params, data, target, do, idx, n_grad: int):
        rows = torch.arange(data.shape[0], device=data.device)[:, None]
        per_slot = do.dim() == 2
        step = phase.lr * do
        losses = []
        for i in range(e_max):
            sel = idx[:, i]                             # (C, B)
            xb, tb = data[rows, sel], target[rows, sel]
            if i < n_grad:
                leaves = [{k: v.detach().requires_grad_(True)
                           for k, v in p.items()} for p in w]
                with torch.enable_grad():
                    loss = phase.loss_fn(leaves, xb, tb)
                    flat = [v for p in leaves for v in p.values()]
                    grads = iter(torch.autograd.grad(loss.sum(), flat))
                w = [{k: v.detach() - (quantcomm._per_client(step[:, i], v)
                                       if per_slot else step[i])
                      * next(grads) for k, v in p.items()} for p in leaves]
            else:
                loss = phase.loss_fn(w, xb, tb)
            losses.append(loss.detach())
        losses = torch.stack(losses)                    # (e_max, C)
        if phase.loss_over_mask:
            return w, ((losses * (do.T if per_slot else do[:, None])).sum(0)
                       / do.sum(-1).clamp(min=1.0))
        return w, losses.mean(0)

    return run


def _step_mask(e_max: int, e_steps, device) -> torch.Tensor:
    """(e_max,) f32: 1 for the executed steps i < e_steps (an int or a
    0-d tensor on ``device``); (P, e_max) for a (P,) tensor of per-pair
    counts."""
    if isinstance(e_steps, torch.Tensor) and e_steps.dim() == 1:
        e_steps = e_steps[:, None]
    return (torch.arange(e_max, device=device) < e_steps).float()


def _aggregate(spec: FrameworkSpec, params: ParamsTuple, weighted, msum,
               loss_sums, qstate, uniforms, lead: int, mesh=None):
    """The masked-FedAvg payload through the spec's wire format, in the
    reference's order: int8 quantizes the numerators ``weighted`` ({param
    index: layers}) with error feedback, bf16 rounds (weighted, |A_t|, the
    loss sums); then |A_t| is clamped to ≥ 1 and divides.  ``lead``: 1 for
    seed- or pair-stacked payloads (a scale and a residual per seed or
    pair; ``msum`` is 0-d, or (P,) for pairs of their own cohorts).  On a
    ``mesh`` the payload holds this rank's partial sums: int8 quantizes
    them with this rank's residual and uniforms, then (weighted, |A_t|,
    the loss sums) cross the mesh in one all-reduce, in bf16 under the
    bf16 wire.  Returns (new params, losses, new qstate, |A_t| as it
    crossed the wire)."""
    quant = spec.quant
    if quant.stochastic:
        weighted, qstate = quantcomm.fake_quant_int8(weighted, qstate,
                                                     uniforms, quant, lead)
    if mesh is not None:
        weighted, msum, loss_sums = all_reduce_bundle(
            (weighted, msum, loss_sums), mesh,
            wire_dtype=torch.bfloat16 if quant.mode == "bf16" else None)
    elif quant.mode == "bf16":
        weighted, msum, loss_sums = quantcomm.simulate_cast(
            (weighted, msum, loss_sums), torch.bfloat16)
    wsum = msum.clamp(min=1.0)

    def divide(v):
        return v / (quantcomm._per_client(wsum, v) if wsum.dim() else wsum)
    new_params = tuple(
        [{k: divide(v) for k, v in p.items()} for p in weighted[i]]
        if i in weighted else params[i] for i in range(len(params)))
    return new_params, tuple(s / wsum for s in loss_sums), qstate, msum


def _inject(updated: Dict[int, Params], old: Dict[int, Params], a_mask,
            faults, clip: Optional[float]) -> Dict[int, Params]:
    """The fault block on each client's uploaded delta ``new − old`` (``old``
    broadcasts over the client axis): the wire gain, then the NaN poison of
    the SELECTED clients only (a mask-0 NaN would leak through 0 × NaN in
    the masked sum), then the norm clip; returns ``old + delta``."""
    poison = faults.get("poison") if faults is not None else None
    wire = faults.get("wire_gain") if faults is not None else None
    out = {}
    for i, u in updated.items():
        delta = quantcomm.tree_map(lambda wn, wo: wn - wo, u, old[i])
        if wire is not None:
            delta = quantcomm.apply_client_gain(delta, wire)
        if poison is not None:
            bad = (poison > 0) & (a_mask > 0)
            delta = quantcomm.apply_client_gain(
                delta, torch.where(bad, float("nan"), 1.0))
        if clip is not None:
            delta = quantcomm.clip_client_norm(delta, clip)
        out[i] = quantcomm.tree_map(lambda d, wo: wo + d, delta, old[i])
    return out


def _guard(guards: RoundGuards, trained, params: ParamsTuple, new_params,
           qstate, new_qstate, msum, lead: int):
    """The guard block on the aggregate: a non-finite trained param rolls
    the round back and a cohort below ``min_clients`` holds it; params and
    error-feedback state keep their old values with ``torch.where``, per
    seed for seed-stacked trees (``lead`` 1).  Returns (params, qstate,
    flags ``{"skipped", "quorum"}``: f32, one per seed)."""
    dev = msum.device
    finite = torch.ones(params[0][0]["w"].shape[:lead], dtype=torch.bool,
                        device=dev)
    if guards.nonfinite:
        for i in trained:
            for leaf in quantcomm.tree_leaves(new_params[i]):
                finite = finite & (torch.isfinite(leaf.flatten(lead))
                                   .all(dim=lead))
    quorum_ok = (msum >= guards.min_clients if guards.min_clients > 1
                 else torch.ones((), dtype=torch.bool, device=dev))
    apply = finite & quorum_ok

    def hold(n, o):
        return torch.where(apply.reshape(apply.shape
                                         + (1,) * (n.dim() - lead)), n, o)
    new_params = quantcomm.tree_map(hold, new_params, params)
    qstate = quantcomm.tree_map(hold, new_qstate, qstate)
    ok = finite.float()
    return new_params, qstate, {"skipped": 1.0 - ok,
                                "quorum": ok * (1.0 - quorum_ok.float())}


def _finish(spec, params, updated, weighted, msum, loss_sums, qstate,
            uniforms, guards, lead, mesh=None):
    """Aggregate, then the guards if armed: the 3-tuple, or with guards the
    4-tuple ending in the flags.  The guards read the values after the
    all-reduce, so on a mesh every rank takes the same decision."""
    new_params, losses, new_q, msum = _aggregate(
        spec, params, weighted, msum, loss_sums, qstate, uniforms, lead,
        mesh)
    if guards is None:
        return new_params, losses, new_q
    new_params, new_q, flags = _guard(guards, updated, params, new_params,
                                      qstate, new_q, msum, lead)
    return new_params, losses, new_q, flags


def _round_core(spec: FrameworkSpec, runners, params: ParamsTuple, ctx,
                a_mask: torch.Tensor, e_steps: int, idx: torch.Tensor,
                qstate=(), uniforms=None, faults=None,
                guards: Optional[RoundGuards] = None, mesh=None):
    """One masked round over the full client axis (on a ``mesh``: this
    rank's slab of it).  ``faults`` ({"poison", "wire_gain"}: (M,) each)
    corrupts the uploaded updates; ``guards`` arms the clip, the rollback
    and the quorum hold and adds the flags to the return."""
    m, e_max = ctx["x"].shape[0], idx.shape[2]
    do = _step_mask(e_max, e_steps, ctx["x"].device)
    updated: Dict[int, Params] = {}
    phase_losses = []
    for pi, ph in enumerate(spec.phases):
        tgt = ph.target_fn(params, updated, ctx)
        w_rep = replicate(params[ph.param_idx], m)
        w_new, loss_m = runners[pi](w_rep, ctx[ph.data_key], tgt, do,
                                    idx[pi], e_steps)
        updated[ph.param_idx] = w_new
        phase_losses.append(loss_m)
    clip = guards.clip_norm if guards is not None else None
    if faults is not None or clip is not None:
        updated = _inject(updated, {i: replicate(params[i], m)
                                    for i in updated}, a_mask, faults, clip)
    # masked FedAvg numerators, |A_t| and the loss sums
    weighted = {i: [{k: torch.tensordot(a_mask, v, dims=1)
                     for k, v in p.items()} for p in u]
                for i, u in updated.items()}
    loss_sums = tuple((l * a_mask).sum() for l in phase_losses)
    return _finish(spec, params, updated, weighted, a_mask.sum(), loss_sums,
                   qstate, uniforms, guards, 0, mesh)


def _train_slots(spec: FrameworkSpec, runners, folded, ctx_c, do,
                 cohort_idx, lead: int):
    """Every phase over the folded client axis of ``lead`` seeds or pairs
    of kb slots each: the trained weights ({param index: layers}) and each
    phase's (lead, kb) losses."""
    updated: Dict[int, Params] = {}
    phase_losses = []
    for pi, ph in enumerate(spec.phases):
        tgt = ph.target_fn(folded, updated, ctx_c)
        w_new, loss_c = runners[pi](folded[ph.param_idx], ctx_c[ph.data_key],
                                    tgt, do, cohort_idx[pi],
                                    cohort_idx.shape[2])
        updated[ph.param_idx] = w_new
        phase_losses.append(loss_c.reshape(lead, -1))
    return updated, phase_losses


def _gathered_core(spec: FrameworkSpec, runners, params: ParamsTuple, ctx,
                   sel_idx: torch.Tensor, sel_mask: torch.Tensor, e_steps,
                   idx: torch.Tensor, qstate=(), uniforms=None, faults=None,
                   guards: Optional[RoundGuards] = None,
                   ctx_gathered: bool = False, mesh=None):
    """One masked round over the gathered cohort ``sel_idx`` (kb,) of every
    seed: ``params`` leaves are seed-stacked (S, ...), ``idx`` is the
    full-M draw (S, n_phases, M, e_max, B).  The (seed, slot) pairs form
    one client axis of S·kb, seed-major; masked FedAvg, the loss sums and
    the wire format run per seed (an int8 scale and residual per seed, as
    the reference's round vmapped over seeds quantizes), and so do the
    guards' decisions.  ``faults`` are the cohort's slices, (kb,) each,
    shared by the seeds.  ``ctx_gathered``: the context's rows are already
    the cohort's kb slots (population mode's per-round data), not the M
    clients ``sel_idx`` indexes.  On a ``mesh`` the context is this
    rank's slab of the clients and the cohort its slots.

    With ``sel_idx`` and ``sel_mask`` (P, kb) and ``e_steps`` (P,), each of
    P pairs has its own cohort and E (the config sweep's (variant, seed)
    pairs, variant-major): ``params`` are pair-stacked (P, ...), pair p
    reads ``idx[p % len(idx)]`` (its own draw, (P, n_phases, M, e_max, B),
    or its seed's, (S, ...)) and int8 ``uniforms[p % S]`` ((S, U): the
    variants of a seed share them); FedAvg, |A_t|, the loss sums, and the
    wire format run per pair."""
    if sel_idx.dim() == 2:
        return _paired_core(spec, runners, params, ctx, sel_idx, sel_mask,
                            e_steps, idx, qstate, uniforms)
    S, e_max, B = idx.shape[0], idx.shape[3], idx.shape[4]
    kb = sel_idx.shape[0]
    if ctx_gathered:
        ctx_c = {k: v.repeat((S,) + (1,) * (v.dim() - 1))
                 for k, v in ctx.items()}
    else:
        folded_sel = sel_idx.repeat(S)                  # client of each slot
        ctx_c = {k: v[folded_sel] for k, v in ctx.items()}
    folded = tuple(_fold(p, kb) for p in params)
    do = _step_mask(e_max, e_steps, sel_idx.device)
    # the full per-client streams, gathered: client m's batches are the
    # same whether or not the other clients are computed
    cohort_idx = idx[:, :, sel_idx].transpose(0, 1).reshape(
        len(spec.phases), S * kb, e_max, B)
    updated, phase_losses = _train_slots(spec, runners, folded, ctx_c, do,
                                         cohort_idx, S)
    clip = guards.clip_norm if guards is not None else None
    if faults is not None or clip is not None:
        updated = _inject(
            updated, {i: folded[i] for i in updated}, sel_mask.repeat(S),
            faults and {k: v.repeat(S) for k, v in faults.items()}, clip)
    weighted = {i: [{k: (sel_mask @ v.reshape(S, kb, -1))
                     .reshape(S, *v.shape[1:]) for k, v in p.items()}
                    for p in u]
                for i, u in updated.items()}
    loss_sums = tuple((l * sel_mask).sum(1) for l in phase_losses)
    return _finish(spec, params, updated, weighted, sel_mask.sum(), loss_sums,
                   qstate, uniforms, guards, 1, mesh)


def _paired_core(spec: FrameworkSpec, runners, params: ParamsTuple, ctx,
                 sel_idx, sel_mask, e_steps, idx, qstate, uniforms):
    """``_gathered_core`` for P pairs of their own cohorts (P, kb) and E
    (P,): the (pair, slot) pairs form one client axis of P·kb, pair-major,
    each slot stepping under its pair's E mask."""
    e_max, B = idx.shape[3], idx.shape[4]
    P, kb = sel_idx.shape
    lane = torch.arange(P, device=sel_idx.device)
    ctx_c = {k: v[sel_idx.reshape(-1)] for k, v in ctx.items()}
    folded = tuple(_fold(p, kb) for p in params)
    do = _step_mask(e_max, e_steps, sel_idx.device).repeat_interleave(kb, 0)
    # pair p's slots read its draw's full-M streams at its cohort
    cohort_idx = idx.transpose(0, 1)[:, (lane % idx.shape[0])[:, None],
                                     sel_idx].reshape(
        len(spec.phases), P * kb, e_max, B)
    updated, phase_losses = _train_slots(spec, runners, folded, ctx_c, do,
                                         cohort_idx, P)
    weighted = {i: [{k: torch.bmm(sel_mask[:, None], v.reshape(P, kb, -1))
                     .reshape(P, *v.shape[1:]) for k, v in p.items()}
                    for p in u]
                for i, u in updated.items()}
    loss_sums = tuple((l * sel_mask).sum(1) for l in phase_losses)
    return _finish(spec, params, updated, weighted, sel_mask.sum(1),
                   loss_sums, qstate,
                   None if uniforms is None
                   else uniforms[lane % uniforms.shape[0]], None, 1)


def _check_on(device, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} must be on {device}, not {t.device}")


def _check_idx(idx: torch.Tensor, shape: tuple) -> None:
    if tuple(idx.shape) != shape or idx.dtype != torch.int64:
        raise ValueError(f"batch indices must be int64 {shape}, got "
                         f"{idx.dtype} {tuple(idx.shape)}")


def _check_sel(sel_idx: torch.Tensor, sel_mask: torch.Tensor, e_steps=None,
               params=None, n_seeds: int = 0) -> None:
    """A shared cohort (kb,); or, where ``params`` is given, P pairs'
    cohorts (P, kb) with their E (P,), P a multiple of the seeds and the
    params pair-stacked."""
    pairs = params is not None and sel_idx.dim() == 2
    if sel_idx.dtype != torch.int64 or sel_idx.dim() != 1 + pairs \
            or tuple(sel_mask.shape) != tuple(sel_idx.shape):
        raise ValueError("sel_idx must be int64 (kb,), or (P, kb) for "
                         "pairs of their own cohorts, and sel_mask its shape")
    if pairs:
        P = sel_idx.shape[0]
        if not isinstance(e_steps, torch.Tensor) \
                or tuple(e_steps.shape) != (P,):
            raise ValueError(f"{P} pairs need e_steps as a ({P},) tensor")
        if P % n_seeds or params[0][0]["w"].shape[0] != P:
            raise ValueError(f"{P} pairs need params stacked over {P} "
                             f"pairs and a multiple of {n_seeds} seeds")


def _check_quant(spec: FrameworkSpec, params, qstate, uniforms, lead,
                 device) -> None:
    if spec.quant.stochastic:
        want = lead + (quantcomm.n_elements(
            trained_params(spec, params), len(lead)),)
        if uniforms is None or tuple(uniforms.shape) != want \
                or uniforms.dtype != torch.float32:
            raise ValueError(f"int8 rounds need f32 uniforms {want}")
        _check_on(device, uniforms=uniforms)
    elif uniforms is not None:
        raise ValueError(f"uniforms given to a {spec.quant.mode!r} round")
    if spec.quant.stateful != (qstate != ()):
        raise ValueError("qstate must come from init_quant_state(spec)")


def _check_spec_policy(spec: FrameworkSpec, policy, device) -> None:
    if policy is not None and (dispatch.get_policy(policy).resolved(device)
                               != spec.policy):
        raise ValueError("round builders cannot override the spec-bound "
                         f"kernel policy (spec has {spec.policy}); rebuild "
                         "via make_spec(..., policy=...)")


def _check_guards(guards) -> None:
    if guards is not None and not isinstance(guards, RoundGuards):
        raise TypeError(f"guards must be a RoundGuards, got "
                        f"{type(guards).__name__}")


def build_round_fn(spec: FrameworkSpec, cfg: DNNConfig,
                   x: torch.Tensor, y: torch.Tensor, *, e_max: int,
                   gather: bool = False,
                   policy: PolicyLike = None,
                   guards: Optional[RoundGuards] = None,
                   with_faults: bool = False, mesh=None):
    """One federated round for `spec` over the fixed client dataset
    ``x`` (M, n, d) and ``y`` (M, n) int labels, on their device.

    Returns ``round_fn(params_tuple, a_mask, e_steps, idx, qstate=(),
    uniforms=None) -> (params_tuple, per_phase_losses, qstate)``: ``a_mask``
    (M,) f32 selection, ``e_steps`` the int count of executed local steps
    (≤ ``e_max``, the number of steps run), ``idx`` the (n_phases, M,
    e_max, B) int64 batch indices.  ``qstate`` is the wire format's
    error-feedback state (``init_quant_state``; ``()`` when it has none)
    and ``uniforms`` the int8 rounding's f32 draws in [0, 1)
    (``quant_uniforms``; None unless the spec's wire format is int8).  The
    policy, its precision and the wire format are the ones bound into the
    spec: ``x`` is f32, or already in the compute dtype of a mixed policy,
    and an f32 ``x`` is cast to it here, once.

    ``gather=True`` returns ``round_fn(params, sel_idx, sel_mask, e_steps,
    idx, qstate=(), uniforms=None)`` over S seeds at once: the params'
    leaves are seed-stacked (S, ...), ``idx`` is the full-M draw (S,
    n_phases, M, e_max, B), the losses are (S,), the qstate leaves and the
    uniforms have the leading S too (an int8 scale per seed).  Only the
    cohort ``sel_idx`` (kb,) int64, shared by the seeds, is trained (pads
    index client 0 and carry ``sel_mask`` 0); ``idx`` is gathered by
    ``sel_idx``, and ``e_steps`` may be a 0-d tensor on the data's device (a
    CUDA graph's operand): every one of the e_max steps runs its backward
    and the masked update.  The gathered round checks no index values
    (that would wait on the card); its callers check them on the host.
    With ``sel_idx`` / ``sel_mask`` (P, kb) and ``e_steps`` a (P,) tensor,
    P pairs (variant-major) train their own cohorts for their own E: the
    params, losses and qstate are pair-stacked, ``idx`` is (P, …), a draw
    a pair, or (S, …) with P a multiple of S, and pair p reads ``idx[p %
    len(idx)]`` and the uniforms ``uniforms[p % S]`` of its seed
    (``_paired_core``); such a round takes no fault channels, no guards
    and no mesh.

    ``guards`` (a ``RoundGuards``) arms the in-round guards: the round then
    returns ``(params, losses, qstate, flags)`` with ``flags = {"skipped",
    "quorum"}`` f32 (0-d, or (S,) for the gathered round).
    ``with_faults=True`` adds a trailing ``faults`` argument, ``{"poison",
    "wire_gain"}`` f32 per client: (M,) each for the full round, the
    cohort's (kb,) slices (shared by the seeds; pads poison 0 and gain 1)
    for the gathered one.  Both default off, leaving the round as it
    was.

    ``mesh`` (a client mesh, ``gather=True`` with a shared cohort only):
    ``x`` and ``y`` are this rank's slab of the clients, the cohort and
    ``idx`` index that slab, ``qstate`` and ``uniforms`` are this rank's,
    and the payload of the seeds crosses the mesh in one all-reduce
    (``_aggregate``): the campaign's sharded round."""
    _check_spec_policy(spec, policy, x.device)
    if mesh is not None:
        _dim_names(mesh)
        if not gather:
            raise ValueError("a round over a mesh slab is gather=True; the "
                             "full-M sharded round is build_sharded_round_fn")
    _check_guards(guards)
    prec = spec.policy.precision
    if x.dtype != torch.float32 and not (prec.is_mixed
                                         and x.dtype == prec.compute_dtype):
        raise TypeError(f"client data must be float32 (or {prec.compute} "
                        f"under a mixed policy), got {x.dtype}")
    if prec.is_mixed:
        x = x.to(prec.compute_dtype)      # once a campaign, not a batch
    M = x.shape[0]
    y = y.long()
    ctx = {"x": x, "y": y, "y1": F.one_hot(y, cfg.n_classes).float()}
    runners = [_phase_runner(ph, e_max) for ph in spec.phases]
    idx_shape = (len(spec.phases), M, e_max, spec.batch_size)

    def check_faults(faults, m):
        if not with_faults:
            if faults is not None:
                raise ValueError("faults given to a round built without "
                                 "with_faults=True")
            return None
        if faults is None or set(faults) != {"poison", "wire_gain"}:
            raise ValueError("faults must be {'poison', 'wire_gain'}")
        for k, v in faults.items():
            if tuple(v.shape) != (m,) or v.dtype != torch.float32:
                raise ValueError(f"faults[{k!r}] must be f32 ({m},), got "
                                 f"{v.dtype} {tuple(v.shape)}")
            _check_on(x.device, **{k: v})
        return faults

    if gather:
        def round_fn(params: ParamsTuple, sel_idx, sel_mask, e_steps, idx,
                     qstate=(), uniforms=None, faults=None):
            _check_idx(idx, tuple(idx.shape[:1]) + idx_shape)
            _check_sel(sel_idx, sel_mask, e_steps, params, idx.shape[0])
            _check_on(x.device, idx=idx, sel_idx=sel_idx, sel_mask=sel_mask)
            lead = tuple(idx.shape[:1])
            if sel_idx.dim() == 2 and uniforms is not None:
                lead = tuple(uniforms.shape[:1])     # a seed's, shared
                if sel_idx.shape[0] % max(1, lead[0]):
                    raise ValueError(f"{sel_idx.shape[0]} pairs need "
                                     f"uniforms a seed, got {lead[0]}")
            _check_quant(spec, params, qstate, uniforms, lead, x.device)
            if sel_idx.dim() == 2 and (with_faults or guards is not None):
                raise ValueError("pairs of their own cohorts take no fault "
                                 "channels and no guards")
            if sel_idx.dim() == 2 and mesh is not None:
                raise ValueError("pairs of their own cohorts take no mesh")
            faults = check_faults(faults, sel_idx.shape[0])
            with torch.no_grad():
                return _gathered_core(spec, runners, params, ctx, sel_idx,
                                      sel_mask, e_steps, idx, qstate,
                                      uniforms, faults, guards, mesh=mesh)

        return round_fn

    def round_fn(params: ParamsTuple, a_mask, e_steps: int, idx, qstate=(),
                 uniforms=None, faults=None):
        _check_idx(idx, idx_shape)
        _check_on(x.device, idx=idx, a_mask=a_mask)
        _check_quant(spec, params, qstate, uniforms, (), x.device)
        faults = check_faults(faults, M)
        with torch.no_grad():
            return _round_core(spec, runners, params, ctx, a_mask,
                               int(e_steps), idx, qstate, uniforms, faults,
                               guards)

    return round_fn


def build_cohort_round_fn(spec: FrameworkSpec, cfg: DNNConfig, *,
                          e_max: int, gather: bool = False,
                          policy: PolicyLike = None,
                          guards: Optional[RoundGuards] = None):
    """One federated round whose client data arrive as arguments: the
    population-mode round (``repro_torch.core.population``), where every
    round samples a new cohort, so no dataset can be fixed when the round is
    built.

    Returns ``round_fn(params_tuple, xc, yc, a_mask, e_steps, idx,
    qstate=(), uniforms=None) -> (params_tuple, per_phase_losses, qstate)``:
    ``xc`` (C, n, d) f32 cohort data (or already in a mixed policy's compute
    dtype; f32 is cast inside the round), ``yc`` (C, n) int labels,
    ``a_mask`` (C,) f32 selection over cohort positions, ``idx`` the
    (n_phases, C, e_max, B) int64 batch indices, ``qstate`` and
    ``uniforms`` as in ``build_round_fn``.  It is ``build_round_fn``'s round
    over the data ``(xc, yc)`` (the same ``_round_core``): when the cohort
    is the whole population in id order, position m is client m and the
    round equals the materialized one.

    ``gather=True`` returns ``round_fn(params, xc, yc, sel_idx, sel_mask,
    e_steps, idx, qstate=(), uniforms=None)`` over S seed-stacked params:
    ``xc`` (kb, n, d) and ``yc`` (kb, n) are the data of the cohort slots
    ``sel_idx`` (kb,) int64 names (cohort positions; pads carry
    ``sel_mask`` 0), ``idx`` the (S, n_phases, C, e_max, B) draw over all C
    positions, gathered by ``sel_idx``; the rest as in ``build_round_fn(
    gather=True)``.  ``guards`` returns the flags as there; population
    traces carry no fault channels, so there is no ``faults`` argument."""
    _check_guards(guards)
    prec = spec.policy.precision
    n_ph = len(spec.phases)
    runners = [_phase_runner(ph, e_max) for ph in spec.phases]

    def context(xc, yc, lead_c: int):
        if policy is not None:
            _check_spec_policy(spec, policy, xc.device)
        if xc.dtype == torch.float32 and prec.is_mixed:
            xc = xc.to(prec.compute_dtype)
        elif xc.dtype != torch.float32 and not (
                prec.is_mixed and xc.dtype == prec.compute_dtype):
            raise TypeError(f"cohort data must be float32 (or "
                            f"{prec.compute} under a mixed policy), got "
                            f"{xc.dtype}")
        if xc.dim() != 3 or tuple(yc.shape) != tuple(xc.shape[:2]) \
                or xc.shape[0] != lead_c:
            raise ValueError(f"cohort data must be ({lead_c}, n, d) and "
                             f"labels ({lead_c}, n), got "
                             f"{tuple(xc.shape)} and {tuple(yc.shape)}")
        _check_on(xc.device, yc=yc)
        yc = yc.long()
        return {"x": xc, "y": yc,
                "y1": F.one_hot(yc, cfg.n_classes).float()}

    if gather:
        def round_fn(params: ParamsTuple, xc, yc, sel_idx, sel_mask, e_steps,
                     idx, qstate=(), uniforms=None):
            _check_sel(sel_idx, sel_mask)
            ctx = context(xc, yc, sel_idx.shape[0])
            _check_idx(idx, tuple(idx.shape[:1]) + (n_ph, idx.shape[2],
                                                    e_max, spec.batch_size))
            _check_on(xc.device, idx=idx, sel_idx=sel_idx,
                      sel_mask=sel_mask)
            _check_quant(spec, params, qstate, uniforms,
                         tuple(idx.shape[:1]), xc.device)
            with torch.no_grad():
                return _gathered_core(spec, runners, params, ctx, sel_idx,
                                      sel_mask, e_steps, idx, qstate,
                                      uniforms, None, guards,
                                      ctx_gathered=True)

        return round_fn

    def round_fn(params: ParamsTuple, xc, yc, a_mask, e_steps: int, idx,
                 qstate=(), uniforms=None):
        C = xc.shape[0]
        ctx = context(xc, yc, C)
        _check_idx(idx, (n_ph, C, e_max, spec.batch_size))
        _check_on(xc.device, idx=idx, a_mask=a_mask)
        _check_quant(spec, params, qstate, uniforms, (), xc.device)
        with torch.no_grad():
            return _round_core(spec, runners, params, ctx, a_mask,
                               int(e_steps), idx, qstate, uniforms, None,
                               guards)

    return round_fn


def build_sharded_round_fn(spec: FrameworkSpec, cfg: DNNConfig, mesh, *,
                           n_clients: int, e_max: int,
                           policy: PolicyLike = None,
                           guards: Optional[RoundGuards] = None,
                           with_faults: bool = False):
    """One federated round for `spec` with the client axis sharded over the
    ranks of ``mesh`` (port of the reference's ``shard_map`` round).

    Returns ``round_fn(params_tuple, x, y, a_mask, e_steps, idx, qstate=(),
    uniforms=None, faults=None) -> (params_tuple, per_phase_losses,
    qstate)`` over the reference's full-M operands, on every rank: ``x``
    (M, n, d), ``y`` (M, n), ``a_mask`` (M,), ``idx`` (n_phases, M, e_max,
    B) int64 and, with ``with_faults``, ``faults`` {"poison", "wire_gain"}
    (M,) f32 each.  Each rank trains only its contiguous slab of M / N
    clients (``shard_slice``; N not dividing M raises); ``qstate`` and
    ``uniforms`` are this rank's own (``init_quant_state(spec, params)``,
    and its int8 stream: ``uniform_generator(seed, shard)``), since each
    rank quantizes its own partial sums.  The round is ``_round_core``
    over the slab; its masked-FedAvg numerators, |A_t| and loss sums cross
    the mesh in one all-reduce, so every rank returns the same params and
    losses.  ``guards`` returns the flags as ``build_round_fn``'s, decided
    on the reduced values (the same on every rank)."""
    _check_guards(guards)
    sl = shard_slice(mesh, int(n_clients))
    M = int(n_clients)
    prec = spec.policy.precision
    runners = [_phase_runner(ph, e_max) for ph in spec.phases]
    n_ph = len(spec.phases)

    def round_fn(params: ParamsTuple, x, y, a_mask, e_steps, idx, qstate=(),
                 uniforms=None, faults=None):
        _check_spec_policy(spec, policy, x.device)
        if x.shape[0] != M or tuple(y.shape) != tuple(x.shape[:2]) \
                or tuple(a_mask.shape) != (M,):
            raise ValueError(f"the sharded round takes the full-M operands: "
                             f"x ({M}, n, d), y ({M}, n), a_mask ({M},); got "
                             f"{tuple(x.shape)}, {tuple(y.shape)}, "
                             f"{tuple(a_mask.shape)}")
        _check_idx(idx, (n_ph, M, e_max, spec.batch_size))
        _check_on(x.device, y=y, idx=idx, a_mask=a_mask)
        _check_quant(spec, params, qstate, uniforms, (), x.device)
        if with_faults != (faults is not None):
            raise ValueError("faults are given exactly when the round is "
                             "built with_faults=True")
        xs = x[sl]
        if prec.is_mixed and xs.dtype == torch.float32:
            xs = xs.to(prec.compute_dtype)
        ys = y[sl].long()
        ctx = {"x": xs, "y": ys, "y1": F.one_hot(ys, cfg.n_classes).float()}
        faults_s = None if faults is None else {
            k: v[sl] for k, v in faults.items()}
        with torch.no_grad():
            return _round_core(spec, runners, params, ctx, a_mask[sl],
                               int(e_steps), idx[:, sl], qstate, uniforms,
                               faults_s, guards, mesh=mesh)

    return round_fn


def trained_params(spec: FrameworkSpec, params: ParamsTuple) -> dict:
    """The trained part of ``params`` ({param index: layers}): the shape of
    the aggregation payload, its error-feedback state and its uniforms."""
    return {ph.param_idx: params[ph.param_idx] for ph in spec.phases}


def init_quant_state(spec: FrameworkSpec, params: ParamsTuple,
                     n_shards: Optional[int] = None, lead: int = 0):
    """Fresh error-feedback accumulator for ``spec``'s rounds: zeros shaped
    like each trained param index (seed-stacked params give the per-seed
    state; a rank of a sharded round keeps its own); ``()`` when the wire
    format carries no state.  ``n_shards`` gives the gathered layout of
    every shard's residual, a shard axis after the ``lead`` seed dims:
    (n_shards, …) for one params tuple (the reference's
    ``init_quant_state(n_shards=)``), (S, n_shards, …) for seed-stacked
    params with ``lead=1`` (its mesh campaign's)."""
    if not spec.quant.stateful:
        return ()
    state = quantcomm.tree_map(torch.zeros_like, trained_params(spec, params))
    return state if n_shards is None else shard_layout(state, n_shards, lead)


def shard_layout(tree, n_shards: int, lead: int = 0):
    """Zeros shaped like ``tree`` with a shard axis of ``n_shards`` after
    the ``lead`` leading dims of every leaf: the gathered layout of the
    shards' error-feedback residuals."""
    return quantcomm.tree_map(lambda z: z.new_zeros(
        tuple(z.shape[:lead]) + (int(n_shards),) + tuple(z.shape[lead:])),
        tree)


# the reference's quantization salt, mixed into the int8 uniforms' seed
UNIFORM_SALT = 0x5157


def uniform_generator(seed: int, shard: int = 0) -> torch.Generator:
    """The CPU generator of a run's int8 uniforms: a stream of (``seed``,
    ``shard``) apart from the run's batch-index generator (seeded with
    ``seed`` itself) and from every other shard's, as the reference's
    ``fold_in(fold_in(key, salt), shard)``; shard 0's is the single
    device's, so a 1-shard mesh is the single-device round.  Torch's CPU
    generator keeps only the low 32 bits of its seed, so (salt, seed,
    shard) are mixed into 32 bits by ``numpy.random.SeedSequence``
    (adding them above bit 32 gave every shard, and the batch indices,
    the same stream)."""
    word = np.random.SeedSequence(
        [UNIFORM_SALT, int(seed), int(shard)]).generate_state(1, np.uint32)
    return torch.Generator().manual_seed(int(word[0]))


def quant_uniforms(spec: FrameworkSpec, params: ParamsTuple,
                   generator: torch.Generator) -> torch.Tensor:
    """One round's int8 uniforms for one seed's ``params``, drawn from a
    CPU ``generator``: f32 in [0, 1), flat over the payload's leaves in
    ``quantcomm.tree_leaves`` order."""
    n = quantcomm.n_elements(trained_params(spec, params))
    return torch.rand(n, generator=generator)


# ---------------------------------------------------------------------------
# Host-side selection / allocation policies (Alg. 1, P2, fixed-K), numpy
# ---------------------------------------------------------------------------

class FixedKPolicy:
    """FedAvg / vanilla SFL: K uniformly random clients, uniform bandwidth.

    Scenario availability (``sp.avail``) bounds the draw: only available
    clients are candidates, and the cohort shrinks below K when fewer are
    up.  The all-available case consumes the same RNG stream as without a
    scenario."""

    def __init__(self, sp: SystemParams, K: int, E: int, seed: int):
        self.sp, self.K, self.E = sp, K, E
        self.rng = np.random.default_rng(seed)

    def step(self) -> Tuple[np.ndarray, np.ndarray, int]:
        cand = np.flatnonzero(self.sp.avail > 0)
        a = np.zeros(self.sp.M)
        if cand.size == self.sp.M:
            k = min(self.K, self.sp.M)
            a[self.rng.choice(self.sp.M, k, replace=False)] = 1.0
        else:
            if cand.size == 0:            # total blackout: never stall
                cand = np.arange(self.sp.M)
            k = min(self.K, cand.size)
            a[self.rng.choice(cand, k, replace=False)] = 1.0
        b = np.where(a > 0, 1.0 / k, 0.0)
        return a, b, self.E


class DeadlineFixedEPolicy:
    """O-RANFed: deadline-aware selection + min-max bandwidth, fixed E."""

    def __init__(self, sp: SystemParams, state: SelectionState, E: int):
        self.sp, self.state, self.E = sp, state, E

    def step(self) -> Tuple[np.ndarray, np.ndarray, int]:
        a = select_trainers(self.E, self.sp, self.state)
        b = solve_bandwidth(a, self.E, self.sp)
        self.state = update_state(self.state, a, b, self.sp)
        return a, b, self.E


class SplitMeAdaptivePolicy:
    """SplitMe: Alg. 1 selection + P2 bandwidth/adaptive-E (never increases)."""

    def __init__(self, sp: SystemParams, state: SelectionState, e_initial: int):
        self.sp, self.state, self.E = sp, state, e_initial

    def step(self) -> Tuple[np.ndarray, np.ndarray, int]:
        a = select_trainers(self.E, self.sp, self.state)
        b, self.E, _ = solve_p2(a, self.E, self.sp)
        self.state = update_state(self.state, a, b, self.sp)
        return a, b, self.E


class FedORAPolicy:
    """FedORA (arXiv 2505.19211): the RIC admits clients fastest-first
    while the exact min-max bandwidth allocation keeps every admitted
    client's round time inside its slice deadline; only clients it can
    reach this round (``sp.avail``) are candidates.  Fixed E,
    deterministic."""

    def __init__(self, sp: SystemParams, E: int):
        self.sp, self.E = sp, E

    def step(self) -> Tuple[np.ndarray, np.ndarray, int]:
        sp, E = self.sp, self.E
        order = np.argsort(E * (sp.Q_C + sp.Q_S), kind="stable")
        order = order[sp.avail[order] > 0]
        if order.size == 0:
            order = np.argsort(E * (sp.Q_C + sp.Q_S), kind="stable")
        a = np.zeros(sp.M)
        b = np.zeros(sp.M)
        for m in order:
            a[m] = 1.0
            b_try = solve_bandwidth(a, E, sp)
            t = E * (sp.Q_C + sp.Q_S) + uplink_time(a, b_try, sp)
            if np.all((a == 0) | (t <= sp.t_round)):
                b = b_try
            else:
                # admitted sets are nested along the fastest-first order
                a[m] = 0.0
                break
        if a.sum() == 0:                       # never stall
            a[order[0]] = 1.0
            b = solve_bandwidth(a, E, sp)
        return a, b, self.E


class EcoFLPolicy:
    """EcoFL (arXiv 2507.21698): the K clients of lowest estimated round
    energy (transmit power × uplink time at a uniform K-share + compute
    power × E local updates), then min-max bandwidth over them.
    Unavailable clients rank last; a total blackout falls back to the
    plain ranking.  Fixed E, deterministic."""

    def __init__(self, sp: SystemParams, K: int, E: int):
        self.sp, self.K, self.E = sp, K, E

    def step(self) -> Tuple[np.ndarray, np.ndarray, int]:
        sp = self.sp
        t_up_est = (sp.S_m + sp.omega * sp.d_model_bits) \
            / ((sp.B / self.K) * sp.G_m)
        energy = (sp.p_tx_w * t_up_est
                  + sp.p_cpu_w * self.E * (sp.Q_C + sp.Q_S))
        if np.any(sp.avail > 0):
            energy = np.where(sp.avail > 0, energy, np.inf)
        k = max(1, min(self.K, int(np.sum(np.isfinite(energy)))))
        a = np.zeros(sp.M)
        a[np.argsort(energy, kind="stable")[:k]] = 1.0
        b = solve_bandwidth(a, self.E, sp)
        return a, b, self.E


# ---------------------------------------------------------------------------
# Per-framework SystemParams derivation (on a private copy)
# ---------------------------------------------------------------------------

def _derive_splitme(sp: SystemParams, cfg: DNNConfig, n_m: int,
                    wire_bits: float = 32.0) -> None:
    """Smashed-data size, split-model bits and omega from the actual DNN."""
    d_split = dnn.client_dims(cfg)[-1]
    pc_c = dnn.param_count_dims(dnn.client_dims(cfg))
    pc_i = dnn.param_count_dims(dnn.inverse_server_dims(cfg))
    sp.S_m = np.full(sp.M, n_m * d_split * wire_bits)
    sp.d_model_bits = wire_bits * (pc_c + pc_i)
    sp.omega = pc_c / (pc_c + pc_i)


def _derive_full_model(sp: SystemParams) -> None:
    """Full-model FL upload: whole model, no smashed data."""
    sp.omega = 1.0
    sp.S_m = np.zeros(sp.M)


def _derive_no_offload(sp: SystemParams) -> None:
    """O-RANFed: the client computes BOTH halves locally."""
    _derive_full_model(sp)
    sp.Q_C = sp.Q_C + sp.Q_S
    sp.Q_S = np.zeros(sp.M)


def make_policy(name: str, sp: SystemParams, cfg: DNNConfig, *,
                seed: int = 0, K: int = 10, E: int = 10,
                e_initial: int = 20,
                n_samples_per_client: Optional[int] = None,
                quant=None) -> Tuple[SystemParams, Any]:
    """Copy `sp`, apply the framework's parameter derivation to the copy,
    and build its selection/allocation policy, in the reference's order:
    SplitMe seeds Alg. 1's pessimistic t_max^0 from the caller's generic
    S_m/omega BEFORE deriving the real sizes, O-RANFed derives first.
    ``quant`` scales the copy's generic wire payloads (S_m, d_model_bits)
    by ``wire_bits / 32`` before the framework's branch (``sfl`` keeps
    those scaled generic sizes), so Alg. 1, P2, the FedORA / EcoFL rules
    and the comm / latency / cost models all see the narrower format.
    ``seed`` drives FedAvg's and SFL's random cohorts."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown framework {name!r}; have {framework_names()}")
    sp = sp.copy()
    q = quantcomm.get_quant(quant)
    if q.mode != "none":
        sp.S_m = sp.S_m * q.wire_scale
        sp.d_model_bits = sp.d_model_bits * q.wire_scale
    if name == "splitme":
        if n_samples_per_client is None:
            raise ValueError("splitme needs n_samples_per_client for S_m")
        state = initial_state(sp)
        _derive_splitme(sp, cfg, n_samples_per_client,
                        wire_bits=float(q.wire_bits))
        return sp, SplitMeAdaptivePolicy(sp, state, e_initial)
    if name == "sfl":
        return sp, FixedKPolicy(sp, K, E, seed)
    if name == "oranfed":
        _derive_no_offload(sp)
        return sp, DeadlineFixedEPolicy(sp, initial_state(sp), E)
    _derive_full_model(sp)
    if name == "fedavg":
        return sp, FixedKPolicy(sp, K, E, seed)
    if name == "fedora":
        return sp, FedORAPolicy(sp, E)
    return sp, EcoFLPolicy(sp, K, E)


# ---------------------------------------------------------------------------
# Spec factories (the registry)
# ---------------------------------------------------------------------------

def _as_float(x: np.ndarray):
    """Scalar float for a single round, ndarray for a stacked schedule."""
    x = np.asarray(x, np.float64)
    return float(x) if x.ndim == 0 else x


def _ce_step(cfg: DNNConfig, pol: KernelPolicy):
    """Per-client cross-entropy of the whole MLP: the forward in the
    policy's precision, f32 logits, f32 ``log_softmax`` and the NLL
    averaged over the batch; stacked (C, ...) weights and (C, B, ·)
    batches give the (C,) losses."""
    prec = pol.precision

    def loss(w, x_b, y_b):
        logits = dnn.mlp_forward(w, x_b, cfg.activation, precision=prec)
        logp = torch.log_softmax(logits, -1)
        return -torch.take_along_dim(logp, y_b[..., None], -1)[..., 0] \
            .mean(-1)
    return loss


def _mlp_spec(name: str, cfg: DNNConfig, comm_model, *, lr: float,
              batch_size: int, pol: KernelPolicy,
              quant: CommQuant) -> FrameworkSpec:
    """A full-model framework: one phase ``"local"`` training param index
    0, the whole ``cfg.layer_dims`` MLP, on the client data ``"x"`` against
    the labels ``ctx["y"]``.  Its initial weights are the first draws of
    the run's generator; the reference's ``init_key_offset`` (which kept
    its init and round threefry streams apart) has no counterpart, since
    the port's one generator per run draws the weights and then the
    batches."""
    phase = PhaseSpec(
        name="local", param_idx=0, lr=lr, loss_fn=_ce_step(cfg, pol),
        data_key="x", target_fn=lambda params, updated, ctx: ctx["y"])
    return FrameworkSpec(
        name=name,
        init_fn=lambda generator, device: (
            dnn.init_mlp(generator, cfg.layer_dims, device),),
        phases=(phase,), comm_model=comm_model, batch_size=batch_size,
        policy=pol, quant=quant)


def _full_model_comm(a, E, sp):
    """Whole-model upload per selected client (fedavg / oranfed / fedora /
    ecofl); ``sp.d_model_bits`` already carries the wire scale."""
    return _as_float(np.sum(a, axis=-1) * sp.d_model_bits)


def _make_full_model(name: str, cfg: DNNConfig, *, lr: float = 0.05,
                     batch_size: int = 32,
                     policy: KernelPolicy = dispatch.KERNEL,
                     quant: CommQuant = quantcomm.NONE,
                     **_) -> FrameworkSpec:
    """FedAvg, O-RANFed, FedORA and EcoFL: the same local training and
    whole-model payload; they differ only in their host policies."""
    return _mlp_spec(name, cfg, _full_model_comm, lr=lr,
                     batch_size=batch_size, pol=policy, quant=quant)


def _make_sfl(cfg: DNNConfig, *, lr: float = 0.05, batch_size: int = 32,
              policy: KernelPolicy = dispatch.KERNEL,
              quant: CommQuant = quantcomm.NONE, **_) -> FrameworkSpec:
    """Vanilla SplitFed: per local step the smashed batch goes up and the
    boundary gradients come down, in the wire format too."""
    boundary_bits = (2 * batch_size * dnn.client_dims(cfg)[-1]
                     * float(quant.wire_bits))

    def comm(a, E, sp):
        return _as_float(np.sum(a, axis=-1)
                         * (np.asarray(E, np.float64) * boundary_bits
                            + sp.omega * sp.d_model_bits))
    return _mlp_spec("sfl", cfg, comm, lr=lr, batch_size=batch_size,
                     pol=policy, quant=quant)


def _make_splitme(cfg: DNNConfig, *, lr_c: float = 0.05, lr_s: float = 0.02,
                  temperature: float = 2.0, batch_size: int = 32,
                  masked_loss_metric: bool = False,
                  policy: KernelPolicy = dispatch.KERNEL,
                  quant: CommQuant = quantcomm.NONE, **_) -> FrameworkSpec:
    """SplitMe spec.  Both mutual-KL phase losses go through
    ``dispatch.kl_loss`` (the CUDA kernel on the card): with temperature 2
    the client phase's "logits" are the post-activation smashed data and
    the server phase's the linear output of s⁻¹.
    ``masked_loss_metric=False`` keeps the seed trainer's loss metric (the
    mean over all E_max steps); ``True`` averages over the executed steps
    only, which lets the campaign run exactly its E bucket's steps.  The
    trained parameters are the same either way.  The policy's precision
    casts the forwards (under bf16 the smashed data are bf16, the inverse
    model's outputs f32, so the KL kernels take mixed operands)."""
    tau, pol = temperature, policy
    prec = pol.precision

    def client_step(w, x_b, t_b):
        # f_C = D_KL(c(X) ‖ sg[s⁻¹(Y)])  (eq. 5, client side)
        feat = dnn.client_forward(w, x_b, cfg, precision=prec)
        return dispatch.kl_loss(feat, t_b, temperature=tau, policy=pol)

    def server_step(w, y1_b, t_b):
        # f_S = D_KL(s⁻¹(Y) ‖ sg[c(X)])  (eq. 5, server side)
        inv = dnn.inverse_server_forward(w, y1_b, cfg, precision=prec)
        return dispatch.kl_loss(inv, t_b, temperature=tau, policy=pol)

    def client_targets(params, updated, ctx):
        # Step 1: s⁻¹(Y_m) from the GLOBAL inverse model on each client's
        # full one-hot labels — fixed targets for the round
        return dnn.inverse_server_forward(params[1], ctx["y1"], cfg,
                                          precision=prec)

    def server_targets(params, updated, ctx):
        # Step 3: c(X_m) from each client's UPDATED weights on its full data
        return dnn.client_forward(updated[0], ctx["x"], cfg,
                                  precision=prec).detach()

    def init(generator, device):
        return (dnn.init_client(generator, cfg, device),
                dnn.init_inverse_server(generator, cfg, device))

    def comm(a, E, sp):
        return _as_float(np.sum(a * (sp.S_m + sp.omega * sp.d_model_bits),
                                axis=-1))

    return FrameworkSpec(
        name="splitme", init_fn=init,
        phases=(
            PhaseSpec("client", 0, lr_c, client_step, "x", client_targets,
                      loss_over_mask=masked_loss_metric),
            PhaseSpec("server", 1, lr_s, server_step, "y1", server_targets,
                      loss_over_mask=masked_loss_metric),
        ),
        comm_model=comm, batch_size=batch_size, policy=pol, quant=quant)


_REGISTRY: Dict[str, Callable[..., FrameworkSpec]] = {
    "splitme": _make_splitme,
    "fedavg": functools.partial(_make_full_model, "fedavg"),
    "sfl": _make_sfl,
    "oranfed": functools.partial(_make_full_model, "oranfed"),
    "fedora": functools.partial(_make_full_model, "fedora"),
    "ecofl": functools.partial(_make_full_model, "ecofl"),
}


def framework_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def make_spec(name: str, cfg: DNNConfig, *, policy: PolicyLike = None,
              quant: quantcomm.QuantLike = None, device=None,
              **hyper) -> FrameworkSpec:
    """Build a framework spec; ``policy`` (None / preset name /
    ``KernelPolicy``) selects kernels and precision for the phase losses,
    ``quant`` (None / "none" / "bf16" / "int8" / ``CommQuant``) the wire
    format of the aggregation payload; both are bound into the spec.  A
    precision request (``"kernel_bf16"``) is resolved for ``device``, the
    device the spec's rounds will run on (None: the default device, the
    card where there is one).  Pass the same ``quant`` to ``make_policy``.
    ``hyper`` goes to the factory, which ignores what it does not take
    (``masked_loss_metric`` means nothing to a one-phase framework, whose
    loss metric is always over its executed steps)."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown framework {name!r}; have {framework_names()}") from None
    return factory(cfg, policy=dispatch.get_policy(policy).resolved(device),
                   quant=quantcomm.get_quant(quant), **hyper)


# ---------------------------------------------------------------------------
# Test-set evaluation
# ---------------------------------------------------------------------------

def build_eval_fn(spec: FrameworkSpec, cfg: DNNConfig, x_test, y_test, *,
                  client_data: Optional[Dict[str, torch.Tensor]] = None,
                  gamma: float = 1e-3, policy: PolicyLike = None,
                  mesh=None):
    """Build ``accuracy(params_tuple) -> 0-d tensor`` for `spec`.

    The full-model frameworks evaluate their aggregated MLP on the test
    split.  SplitMe first recovers the server model by the Step-4 analytic
    inversion over all client samples (``client_data``; the Gram products
    through the ridge_gram kernel), then runs the stitched forward.  The
    forwards run in the policy's precision; the Grams, the ridge solve and
    the accuracy stay f32.

    With a client ``mesh`` the function evaluates a list of params tuples
    (the campaign's seeds) at once, ``accuracy(params_list) -> (S,)``:
    SplitMe's ``client_data`` is this rank's slab of the clients, and its
    Step 4 all-reduces each server layer's Grams of every seed in one
    call (``inversion.invert_inverse_models``), so every rank gets the same
    accuracies; the baselines' evaluation needs no collective."""
    y_test = y_test.long()
    if mesh is not None:
        _dim_names(mesh)
    if spec.name != "splitme":
        pol = dispatch.get_policy(policy if policy is not None
                                  else spec.policy).resolved(x_test.device)

        def accuracy_full(params: ParamsTuple) -> torch.Tensor:
            (w,) = params
            with torch.no_grad():
                logits = dnn.mlp_forward(w, x_test, cfg.activation,
                                         precision=pol.precision)
                return (logits.argmax(-1) == y_test).float().mean()

        if mesh is not None:
            return lambda params_list: torch.stack(
                [accuracy_full(p) for p in params_list])
        return accuracy_full
    if client_data is None:
        raise ValueError("splitme evaluation needs client_data for the "
                         "Step-4 Gram sums")
    pol = dispatch.get_policy(policy if policy is not None else spec.policy
                              ).resolved(client_data["x"].device)
    prec = pol.precision
    x = client_data["x"]
    flat_y = F.one_hot(client_data["y"].long(), cfg.n_classes).float()
    flat_y = flat_y.reshape(-1, cfg.n_classes)

    def accuracy(params: ParamsTuple) -> torch.Tensor:
        w_c, w_s_inv = params
        with torch.no_grad():
            smashed = dnn.client_forward(w_c, x, cfg, precision=prec)
            w_s = invert_inverse_model(
                w_s_inv, smashed.reshape(-1, smashed.shape[-1]), flat_y, cfg,
                gamma=gamma, policy=pol)
            logits = dnn.full_forward(w_c, w_s, x_test, cfg, precision=prec)
            return (logits.argmax(-1) == y_test).float().mean()

    def accuracy_mesh(params_list) -> torch.Tensor:
        with torch.no_grad():
            smashed = [dnn.client_forward(w_c, x, cfg, precision=prec)
                       for w_c, _ in params_list]
            w_s = invert_inverse_models(
                [w_s_inv for _, w_s_inv in params_list],
                [s.reshape(-1, s.shape[-1]) for s in smashed], flat_y, cfg,
                gamma=gamma, policy=pol, mesh=mesh)
            return torch.stack([
                (dnn.full_forward(w_c, w, x_test, cfg, precision=prec)
                 .argmax(-1) == y_test).float().mean()
                for (w_c, _), w in zip(params_list, w_s)])

    return accuracy if mesh is None else accuracy_mesh
