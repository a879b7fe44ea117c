"""Multi-seed campaign of any framework of the registry (SplitMe and the
five baselines) on one device; port of ``repro.launch.campaign``
(``run_campaign``, its host plan and ``evaluate_campaign``).

The system-side trajectory (A_t, b_t, E_t) of every framework does not
depend on the learned parameters, so it is planned on the host once
(``plan_schedule``) and shared by every seed; the schedule-derived metrics
(comm_bits, selected count, latency, cost, energy) are vectorized over it
up front.  Every round trains only its selected cohort (the engine's
gathered round), padded to a (cohort-bucket, E-bucket) shape, and all
seeds run in one program: their stacked parameters are folded into the
round's client axis, so one kernel launch covers every seed.

Execution modes:

* ``scan=True`` (default) — the counterpart of the reference's
  ``lax.scan`` over rounds.  On CUDA each (cohort-bucket, E-bucket) round
  shape is captured once as a CUDA graph, at its first round, after one
  eager warm-up on the capture stream whose effect is undone; every round
  of that shape, the first included, is a replay.  A round's operands (its
  number, E, |A_t|, the padded cohort and the full-M batch indices) sit in
  one int64 row of a table uploaded before the device phase, and under the
  int8 wire format its uniforms in one (S, U) f32 slice of a second table;
  a round costs the host one device-to-device copy of its row (and one of
  its uniforms) and one replay.  The evaluation (SplitMe's Step 4, or the
  baselines' full-model accuracy) is a second graph, replayed after the
  rounds that evaluate (every ``eval_every`` rounds and the last).  Losses
  and accuracies land in device buffers, fetched to the host once per
  campaign (``_host_fetch``).  The graphs share one memory pool: they run one after
  another, and every tensor that outlives a replay (the parameters, the
  metric buffers and the int8 error-feedback state) is allocated outside
  them.  On the CPU the same round
  bodies run without capture.  On CUDA a capture that fails raises; there
  is no fallback to the eager loop.
* ``scan=False`` — the per-round loop of eager gathered rounds, one host
  transfer per round, the baseline the graphs are measured against.

The spec's precision (``policy="kernel_bf16"``: bf16 on the card, f32 on
the CPU; ``KernelPolicy(precision=BF16)`` anywhere) and wire format
(``quant``: none / bf16 / int8) run through both modes and the evaluation;
``quant`` also narrows the payloads the host plan optimizes over.

A ``scenario`` (a ``repro_torch.core.scenario`` name such as ``"fading"``
or ``"straggler:0.4"``, or a ``ScenarioTrace``) makes the plan
time-varying: each round the policy re-selects against the round-t RAN
state and the recorded mask is the realized one; latency, cost and energy
vectorize over trace × schedule.  As in the reference, the planning
channels act on the host plan and the metrics only, so both modes run the
same device rounds, each a graph of its (cohort, E) shape; a schedule with
many shapes captures many graphs.

Fault tolerance (``repro_torch.launch.resilience`` has the failure model):
a ``faults:p`` trace's poison and wire-gain channels, gathered by each
round's cohort, and its crash channel make one more f32 operand row a round
(``[crash, poison (kb), wire gain (kb)]``), copied in before the replay;
the round injects the faults into the uploaded updates, a crash round holds
params and error-feedback state (``torch.where`` into the state tensors)
and records a NaN loss row, and ``engine.RoundGuards`` (armed by default on
a trace with faults) roll back a seed's non-finite aggregate and hold a
round below quorum.  Their per-seed flags land in device buffers fetched
with the losses, in the one transfer.  ``checkpoint_every`` /
``checkpoint_dir`` save the carry (params, error-feedback state and the
metric buffers of the rounds done) after every ``checkpoint_every``-th
round and the last, and ``resume=True`` copies the newest committed one
into the state tensors before the first capture and runs the rounds left.

Randomness is an input, as in the trainer: each seed's CPU
``torch.Generator(seed)`` draws its initial parameters (unless ``params=``
gives them) and then, round by round, its full-M batch indices (unless
``index_source=`` gives them); under int8 a second generator per seed
(``engine.uniform_generator``) draws each round's uniforms (unless
``uniform_source=`` gives them).  The port does not reproduce JAX's
threefry streams; the parity tests feed both packages the same
parameters, batches and uniforms.

Population mode (``run_population_campaign``): a ``core.population``
population of millions of virtual clients of which each round samples a
cohort; the host plan, the shards and the device operands are O(rounds ×
cohort), never O(population).  Its rounds run through the same scan (one
graph a round shape plus the evaluation's), with each round's selected
shards as one more operand (``_run_rounds_scan(data=)``).

Config sweeps (``run_config_sweep``): SystemParams variants of one client
count train all their (variant, seed) pairs through the same scan, each
pair with its own cohort and E in one gathered round a round shape, and
one host transfer for the whole sweep.

Sharded campaigns (``mesh=``, a ``launch.mesh.make_client_mesh`` client
mesh over a ``torch.distributed`` process group, one rank a shard): every
rank runs the same call with the full client data and keeps its contiguous
slab of the clients on its device; each round trains the full masked slab
(the reference's sharded rounds train the full masked M, never a gathered
cohort), the S seeds folded as above, and the masked-FedAvg payload of
every seed crosses the mesh in one all-reduce a round inside the round's
CUDA graph (NCCL, captured on the side stream after the eager warm-up that
starts the communicator).  Step 4 all-reduces each server layer's Grams
once an evaluation.  Params, losses, accuracy and guard flags come out the
same on every rank; the error-feedback state is each rank's own.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.splitme_dnn import DNNConfig
from repro_torch.core import engine, population as popn, quantcomm
from repro_torch.core import scenario as scen
from repro_torch.core.cost import SystemParams, schedule_metrics
from repro_torch.core.engine import RoundGuards, RoundMetrics
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.checkpoint import io
from repro_torch.launch import resilience

# Device→host transfer accounting: every metrics pull of a campaign goes
# through _host_fetch (the scanned campaign: exactly 1; the loop: 1 a round)
HOST_TRANSFERS = 0

# index_source(seed position, round, E bucket) -> (n_phases, M, E bucket, B)
IndexSource = Callable[[int, int, int], Any]
# uniform_source(seed position, round) -> (U,) f32 int8 uniforms; on a
# mesh uniform_source(seed position, round, client shard)
UniformSource = Callable[..., Any]


def _host_fetch(tree):
    """The single device→host transfer point for campaign metrics: a
    tensor, or a dict / list / tuple of them, to numpy."""
    global HOST_TRANSFERS
    HOST_TRANSFERS += 1
    return _to_numpy(tree)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()


@dataclass
class RoundSchedule:
    """Precomputed system-side trajectory, shared by every seed.  With a
    scenario, ``a`` is the realized mask (the policy's selection against
    the round-t trace times the mid-round survival) and ``trace`` the
    trace the metrics vectorize over."""
    a: np.ndarray      # (R, M) binary selection masks (trace-realized)
    b: np.ndarray      # (R, M) bandwidth fractions
    E: np.ndarray      # (R,)   local-update counts
    trace: Optional[scen.ScenarioTrace] = None

    @property
    def rounds(self) -> int:
        return len(self.E)


@dataclass
class CampaignResult:
    framework: str
    seeds: Tuple[int, ...]
    schedule: RoundSchedule
    params: Any               # params tuple, each leaf stacked over seeds
    losses: np.ndarray        # (n_seeds, rounds, n_phases)
    metrics: List[RoundMetrics]   # system metrics per round (seed-invariant)
    accuracy: Optional[np.ndarray] = None   # (n_seeds,) if test_data given
    accuracy_per_round: Optional[np.ndarray] = None  # (rounds, n_seeds), NaN
    # off eval rounds (scan mode with test_data / eval_every)
    # the port's own measurements: each round's wall time in ms (on CUDA
    # from events on the rounds' stream); for scan=True on CUDA
    # {"shapes": {(kb, eb): [rounds]}, "graphs": n, "capture_s": t}
    round_ms: Optional[np.ndarray] = None
    graphs: Optional[dict] = None
    # the final int8 error-feedback state, {param index: layers} with each
    # leaf stacked over seeds (() for the stateless wire formats); under
    # mesh= this rank's own
    qstate: Any = ()
    # a guarded campaign's accounting (None without guards): (R, S) 0/1
    # non-finite rollbacks and quorum holds, and the (R,) server crashes
    skipped_per_round: Optional[np.ndarray] = None
    quorum_per_round: Optional[np.ndarray] = None
    crashed_per_round: Optional[np.ndarray] = None

    def params_for(self, i: int):
        """The i-th seed's params tuple (unstacked)."""
        return _seed_params(self.params, i)

    @property
    def skipped_rounds(self) -> int:
        """Non-finite rollbacks, summed over seeds."""
        return (0 if self.skipped_per_round is None
                else int(self.skipped_per_round.sum()))

    @property
    def quorum_rounds(self) -> int:
        """Quorum hold-rounds, summed over seeds."""
        return (0 if self.quorum_per_round is None
                else int(self.quorum_per_round.sum()))

    @property
    def crashed_rounds(self) -> int:
        """Rounds lost to server crashes (the same for every seed)."""
        return (0 if self.crashed_per_round is None
                else int(self.crashed_per_round.sum()))


def _seed_params(params, i: int):
    return tuple([{k: v[i] for k, v in p.items()} for p in ps]
                 for ps in params)


def plan_schedule(framework: str, sp: SystemParams, cfg: DNNConfig,
                  rounds: int, *, policy_seed: int = 0, K: int = 10,
                  E: int = 10, e_initial: int = 20,
                  n_samples_per_client: Optional[int] = None,
                  quant=None, scenario: scen.ScenarioLike = None,
                  scenario_seed: int = 0
                  ) -> Tuple[SystemParams, RoundSchedule]:
    """Run the framework's host-side policy for `rounds` rounds.

    Returns the framework's derived SystemParams copy (its round-invariant
    base values) and the schedule.  ``scenario`` (None, a registry name or
    a ``ScenarioTrace``; names draw from ``scenario_seed``) writes each
    round's trace into the copy before the policy steps, and records the
    realized mask."""
    sp, policy = engine.make_policy(
        framework, sp, cfg, seed=policy_seed, K=K, E=E, e_initial=e_initial,
        n_samples_per_client=n_samples_per_client, quant=quant)
    trace = scen.get_trace(scenario, rounds, sp.M, seed=scenario_seed)
    # an all-ones trace ("static", or the data-side "noniid") needs no
    # per-round rewrites
    dynamic = trace is not None and not trace.is_static()
    base = scen.capture_base(sp) if dynamic else None
    a_l, b_l, e_l = [], [], []
    for t in range(rounds):
        if dynamic:
            scen.apply_round(sp, base, trace, t)
        a, b, e = policy.step()
        if dynamic:
            a = scen.realized_mask(a, trace, t)
        a_l.append(a), b_l.append(b), e_l.append(e)
    if dynamic:
        scen.restore_base(sp, base)
    return sp, RoundSchedule(a=np.stack(a_l), b=np.stack(b_l),
                             E=np.asarray(e_l, np.int32), trace=trace)


def _bucket_cohorts(values, cap: int, max_exact: int = 8) -> Dict[int, int]:
    """Map each schedule value (cohort size, E, or segment length) to a
    shape bucket: few distinct values → exact shapes (one graph each); many
    → powers of two up to ``cap`` (at most log2(cap) + 1 shapes)."""
    distinct = sorted(set(int(c) for c in values))
    if len(distinct) <= max_exact:
        return {k: k for k in distinct}
    buckets, b = [], 1
    while b < cap:
        buckets.append(b)
        b *= 2
    buckets.append(cap)
    return {k: next(x for x in buckets if x >= k) for k in distinct}


def _schedule_system_metrics(spec, sched: RoundSchedule, sp: SystemParams):
    """All schedule-derived metrics for every round in one vectorized pass:
    comm_bits via the spec's stacked-schedule comm_model, latency / cost /
    energy via ``cost.schedule_metrics``."""
    comm = np.atleast_1d(np.asarray(
        spec.comm_model(sched.a, sched.E, sp), np.float64))
    nsel = sched.a.sum(axis=1).astype(int)
    sim, cost, energy = schedule_metrics(sched.a, sched.b, sched.E, sp,
                                         trace=sched.trace)
    return comm, nsel, sim, cost, energy


def _plan_segments(kb_r: Sequence[int], eb_r: Sequence[int]
                   ) -> List[Tuple[int, int, int, int]]:
    """Contiguous maximal runs of rounds sharing a (cohort, E) shape bucket:
    [(kb, eb, start, length)] in round order."""
    segs, start = [], 0
    R = len(kb_r)
    for r in range(1, R + 1):
        if r == R or (kb_r[r], eb_r[r]) != (kb_r[start], eb_r[start]):
            segs.append((kb_r[start], eb_r[start], start, r - start))
            start = r
    return segs


def _split_at_checkpoints(segs, every: Optional[int]
                          ) -> List[Tuple[int, int, int, int]]:
    """Additionally split the (kb, eb, start, length) runs at global rounds
    divisible by ``every``: the reference's segment ends, which are the
    port's checkpoint cursors."""
    if not every:
        return segs
    out = []
    for kb, eb, start, length in segs:
        r, end = start, start + length
        while r < end:
            nxt = min(end, (r // every + 1) * every)
            out.append((kb, eb, r, nxt - r))
            r = nxt
    return out


def _make_metrics(sched, comm, nsel, sim, cost, energy, losses, acc_rounds,
                  skipped=None, quorum=None, crashed=None
                  ) -> List[RoundMetrics]:
    metrics = []
    for r in range(sched.rounds):
        acc_r = float("nan")
        if acc_rounds is not None and np.isfinite(acc_rounds[r]).any():
            acc_r = float(np.nanmean(acc_rounds[r]))
        metrics.append(RoundMetrics(
            round=r, n_selected=int(nsel[r]), E=int(sched.E[r]),
            comm_bits=float(comm[r]), sim_time=float(sim[r]),
            cost=float(cost[r]), energy=float(energy[r]), accuracy=acc_r,
            client_loss=float(losses[:, r, 0].mean()),
            server_loss=float(losses[:, r, 1].mean())
            if losses.shape[-1] > 1 else float("nan"),
            skipped=float(skipped[r].mean()) if skipped is not None else 0.0,
            quorum_held=float(quorum[r].mean()) if quorum is not None
            else 0.0,
            crashed=float(crashed[r]) if crashed is not None else 0.0))
    return metrics


def _round_shapes(sched: RoundSchedule, sp: SystemParams):
    """Each round's (cohort bucket, E bucket).  A round that selects no
    client gets a cohort of one padded slot (mask 0): it trains nothing
    and aggregates zeros, as the reference's empty cohort does."""
    return _shape_buckets(sched.a.sum(axis=1), sched.E, sp.M,
                          int(sp.E_max))


def _shape_buckets(counts, es, M: int, e_cap: int):
    """(cohort bucket, E bucket) of each round's cohort size and E."""
    counts = np.asarray(counts).astype(int)
    size_of = _bucket_cohorts(counts, M)
    e_of = _bucket_cohorts(es, e_cap)
    return ([max(1, size_of[int(c)]) for c in counts],
            [max(1, e_of[int(e)]) for e in es])


def _cohort(a_r: np.ndarray, kb: int):
    """Round r's selected clients padded to ``kb`` (pads index client 0
    and carry mask 0) and their count; for (P, M) pairs' masks, (P, kb)
    cohorts and (P,) counts."""
    if a_r.ndim == 2:
        sels, counts = zip(*(_cohort(a, kb) for a in a_r))
        return np.stack(sels), np.asarray(counts, np.int64)
    sel = np.nonzero(a_r)[0]
    idx = np.zeros(kb, np.int64)
    idx[:len(sel)] = sel
    return idx, len(sel)


def _initial_state(spec, seeds, params, index_source, uniform_source, eb_r,
                   M: int, n: int, device: torch.device, own_eb=None,
                   shard: Optional[int] = None):
    """Seed-stacked initial params and error-feedback state on ``device``,
    every round's (S, n_phases, M, E bucket, B) int64 batch indices on the
    host, checked to lie in [0, n), and (under int8; else None) every
    round's (S, U) f32 uniforms on the host.

    ``own_eb`` (the config sweep's default draws): one list of E buckets
    per variant; every (variant, seed) pair, variant-major, then draws its
    own indices, (P, n_phases, M, E bucket, B) a round, from a generator
    seeded as ``run_campaign``'s seed and at its variant's own buckets (so
    it reads its variant's campaign's batches), cut or zero-padded to the
    sweep's bucket: the steps it executes, E_t ≤ the bucket, are all
    drawn, and the rest are masked.  ``shard`` (a sharded campaign): the
    int8 uniforms are that client shard's stream
    (``engine.uniform_generator(seed, shard)``, ``uniform_source(i, r,
    shard)``)."""
    gens = [torch.Generator().manual_seed(int(s)) for s in seeds]
    drawn_init = params is None
    if params is None:
        params = [spec.init_fn(g, torch.device("cpu")) for g in gens]
    if len(params) != len(seeds):
        raise ValueError(f"params for {len(params)} seeds, campaign has "
                         f"{len(seeds)}")
    def leaf(v):
        return (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v, np.float32)))

    stacked = tuple(
        [{k: torch.stack([leaf(ps[i][l][k]) for ps in params])
          .to(device=device, dtype=torch.float32) for k in ps0[l]}
         for l in range(len(ps0))]
        for i, ps0 in enumerate(params[0]))
    shape = (len(spec.phases), M)
    B = spec.batch_size

    def draw(i, r, eb):
        if index_source is not None:
            return torch.as_tensor(index_source(i, r, eb), dtype=torch.int64)
        return torch.randint(0, n, shape + (eb, B), generator=gens[i])

    lanes = [(i, None) for i in range(len(seeds))]
    if own_eb is not None and index_source is None:
        lanes, gens = [], []
        for buckets in own_eb:
            for s in seeds:
                g = torch.Generator().manual_seed(int(s))
                if drawn_init:              # the campaign's first draws
                    spec.init_fn(g, torch.device("cpu"))
                gens.append(g)
                lanes.append((len(gens) - 1, buckets))

    def lane_draw(lane, r, eb):
        i, buckets = lane
        if buckets is None:
            return draw(i, r, eb)
        got = draw(i, r, buckets[r])[..., :eb, :]
        return torch.nn.functional.pad(got, (0, 0, 0, eb - got.shape[-2]))

    indices = []
    for r, eb in enumerate(eb_r):
        idx = torch.stack([lane_draw(lane, r, eb) for lane in lanes])
        if tuple(idx.shape[1:]) != shape + (eb, B):
            raise ValueError(f"round {r}: batch indices must be "
                             f"{shape + (eb, B)}, got {tuple(idx.shape[1:])}")
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n):
            raise ValueError(f"round {r}: batch indices must lie in [0, {n})")
        indices.append(idx)
    uniforms = None
    if spec.quant.stochastic:
        ugens = [engine.uniform_generator(s, shard or 0) for s in seeds]
        one = _seed_params(stacked, 0)

        def udraw(i, r):
            if uniform_source is not None:
                return torch.as_tensor(
                    uniform_source(i, r) if shard is None
                    else uniform_source(i, r, shard), dtype=torch.float32)
            return engine.quant_uniforms(spec, one, ugens[i])

        U = quantcomm.n_elements(engine.trained_params(spec, one))
        uniforms = []
        for r in range(len(eb_r)):
            u = torch.stack([udraw(i, r) for i in range(len(seeds))])
            if tuple(u.shape) != (len(seeds), U):
                raise ValueError(f"round {r}: uniforms must be ({U},) a "
                                 f"seed, got {tuple(u.shape[1:])}")
            uniforms.append(u)
    return stacked, engine.init_quant_state(spec, stacked), indices, uniforms


@contextlib.contextmanager
def _no_syncs(device: torch.device, on: bool):
    """``torch.cuda.set_sync_debug_mode("error")`` for the block on CUDA;
    nothing on the CPU."""
    if not on or device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def run_campaign(framework: str, cfg: DNNConfig, sp: SystemParams,
                 client_data: Dict[str, np.ndarray], *, rounds: int,
                 seeds: Sequence[int], test_data=None,
                 K: int = 10, E: int = 10, e_initial: int = 20,
                 policy_seed: Optional[int] = None, scan: bool = True,
                 mesh=None, eval_every: Optional[int] = None,
                 eval_gamma: float = 1e-3, strict_transfers: bool = False,
                 policy=None, quant=None, scenario=None,
                 scenario_seed: int = 0, guards=None,
                 checkpoint_every: Optional[int] = None,
                 checkpoint_dir=None, resume: bool = False,
                 device: DeviceLike = None, params=None,
                 index_source: Optional[IndexSource] = None,
                 uniform_source: Optional[UniformSource] = None,
                 _round_hook: Optional[Callable[[int], None]] = None,
                 _checkpoint_hook: Optional[Callable[[int], None]] = None,
                 _graphs: bool = True,
                 **hyper) -> CampaignResult:
    """Train ``len(seeds)`` independent runs of ``framework`` over one
    shared schedule (FedAvg's and SFL's random cohorts drawn from
    ``policy_seed``, default ``min(seeds)``), all seeds in one program (see
    the module docstring).  ``K`` and ``E`` are the baselines' cohort size
    and local steps, ``e_initial`` SplitMe's first E.  ``hyper`` forwards
    to the spec factory (lr / lr_c / lr_s / temperature / batch_size).

    ``scan=True`` graphs the rounds on CUDA and fetches the metrics once;
    the evaluation runs after every ``eval_every``-th round and the last
    (with ``test_data``).  ``scan=False`` is the eager per-round loop,
    with a post-hoc evaluation.  ``strict_transfers=True`` runs the scanned
    device phase under ``torch.cuda.set_sync_debug_mode("error")``, so any
    synchronizing call (a stray metric pull, ``.item()``, a pageable copy)
    raises; on the CPU it has no effect.

    The port's own keywords: ``device`` (the card unless ``"cpu"``);
    ``params``, one initial params tuple per seed (``(w_c, w_s_inv)`` for
    SplitMe, ``(w,)`` for the baselines) as numpy arrays or tensors; ``index_source(i, r, e_bucket)``, seed i's full-M batch
    indices of round r, ``(n_phases, M, e_bucket, batch_size)`` int64;
    ``uniform_source(i, r)``, seed i's int8 uniforms of round r, ``(U,)``
    f32 in ``engine.quant_uniforms``'s layout; ``_round_hook(r)``, called
    on the host once round r is queued; ``_graphs=False`` runs the scan's
    round bodies on CUDA without capturing them (to hold the graphs
    against the same bodies run uncaptured).  Each round's wall time lands
    in ``CampaignResult.round_ms``.  By default each seed's generator draws
    its initial weights and then its rounds' batches, the rule of the
    serial trainers: a baseline campaign's seed s equals its trainer with
    ``seed=s`` and the same K and E (FedAvg's and SFL's when ``policy_seed``
    is s too; SplitMe's trainer draws E_max steps a round where the
    campaign draws its E bucket's).

    ``scenario`` and ``scenario_seed`` make the plan time-varying (module
    docstring).  A trace's fault channels are injected inside the scanned
    rounds, and ``guards`` (an ``engine.RoundGuards``; None arms the
    defaults when the trace has faults, False disarms them) adds the
    rollback, the quorum hold and the optional norm clip; faults and guards
    need ``scan=True``.  ``checkpoint_every`` with ``checkpoint_dir`` saves
    the carry after every ``checkpoint_every``-th round and the last
    (``launch/resilience.py``; each save is a device→host pull, so not
    with ``strict_transfers``; ``scan=True`` only); ``resume=True`` checks
    the newest committed checkpoint's fingerprint against the replanned
    schedule, restores it and runs the rounds left.
    ``_checkpoint_hook(round_cursor)`` runs after each committed save.

    ``policy`` and ``quant`` are bound into the spec (the precision request
    of ``"kernel_bf16"`` resolved for ``device``); ``quant`` also scales
    the host plan's payloads, as in the reference.

    ``mesh`` (a client mesh, ``launch.mesh.make_client_mesh``; needs
    ``scan=True``) shards the clients over the ranks of the process group:
    every rank makes this same call, with the full ``client_data``, and
    trains its slab of ``sp.M / n_shards`` clients (module docstring);
    ``device`` is this rank's (an NCCL mesh: its card; a gloo mesh: the
    CPU, or a card uncaptured, ``_graphs=False``, since gloo cannot be
    captured).  Its default draws are the single-device campaign's; its
    int8 uniforms are each shard's own (``engine.uniform_generator(seed,
    shard)``, or ``uniform_source(i, r, shard)``).  Checkpoints: rank 0
    gathers the shards' error-feedback residuals into the reference's (S,
    n_shards, …) layout and writes, and a resume gives every rank its own
    slice.
    """
    if guards not in (None, False) and not isinstance(guards, RoundGuards):
        raise TypeError(f"guards must be None, False or a RoundGuards, got "
                        f"{type(guards).__name__}")
    dev = resolve_device(device)
    x_all = np.asarray(client_data["x"])
    if x_all.shape[0] != sp.M:
        raise ValueError(f"client_data has {x_all.shape[0]} clients but "
                         f"SystemParams.M={sp.M}")
    slab = slice(None)
    if mesh is not None:
        if not scan:
            raise ValueError("mesh (sharded rounds) requires scan=True")
        slab = engine.shard_slice(mesh, int(sp.M))
        _check_mesh_device(mesh, dev, _graphs)
    x = torch.as_tensor(x_all[slab], dtype=torch.float32, device=dev)
    y = torch.as_tensor(np.asarray(client_data["y"])[slab],
                        dtype=torch.int64, device=dev)
    n_m = int(x.shape[1])
    if policy_seed is None:
        policy_seed = min(seeds)
    sp, sched = plan_schedule(framework, sp, cfg, rounds, K=K, E=E,
                              e_initial=e_initial, policy_seed=policy_seed,
                              n_samples_per_client=n_m, quant=quant,
                              scenario=scenario, scenario_seed=scenario_seed)
    # the loss metric averages over the executed steps only, so a round
    # runs exactly its E bucket's steps; the trained params equal the
    # serial trainer's (masked updates are exact no-ops)
    spec = engine.make_spec(framework, cfg, masked_loss_metric=True,
                            policy=policy, quant=quant, device=dev, **hyper)
    comm, nsel, sim, cost, energy = _schedule_system_metrics(spec, sched, sp)

    trace = sched.trace
    has_faults = trace is not None and trace.has_faults()
    if guards is None and has_faults:
        guards = RoundGuards()              # faults arm the defaults
    elif guards is False:
        guards = None
    _check_checkpoint_args(checkpoint_every, checkpoint_dir, resume,
                           strict_transfers)
    if checkpoint_every and not scan:
        raise ValueError("checkpoint/resume requires scan=True (the loop "
                         "has no round buffers to save)")
    if not scan and eval_every:
        raise ValueError("eval_every (per-round eval) requires scan=True; "
                         "the loop only evaluates post-hoc")
    if not scan and (has_faults or guards is not None):
        raise ValueError("fault injection / RoundGuards require scan=True "
                         "(the guards live inside the scanned rounds)")
    kb_r, eb_r = _round_shapes(sched, sp)
    params, qstate, indices, uniforms = _initial_state(
        spec, seeds, params, index_source, uniform_source, eb_r, int(sp.M),
        n_m, dev, shard=None if mesh is None else engine.shard_index(mesh))
    faults = _fault_plan(trace, guards, rounds, int(sp.M))
    local = sched
    if mesh is not None:
        # the rank's slab: the full masked slab a round (its cohort lists
        # the slab's selected clients first, the rest as masked slots)
        kb_r = [x.shape[0]] * rounds
        indices = [i[:, :, slab] for i in indices]
        local = RoundSchedule(a=sched.a[:, slab], b=sched.b[:, slab],
                              E=sched.E, trace=trace)
        if faults is not None:
            faults = dict(faults, poison=faults["poison"][:, slab],
                          wire=faults["wire"][:, slab])
    fns = {s: engine.build_round_fn(
        spec, cfg, x, y, e_max=s[1], gather=True, guards=guards,
        with_faults=faults is not None and faults["with_faults"], mesh=mesh)
        for s in dict.fromkeys(zip(kb_r, eb_r))}

    if not scan:
        losses, params, qstate, round_ms = _run_rounds_loop(
            fns, sched, kb_r, eb_r, params, qstate, indices, uniforms)
        result = CampaignResult(
            framework=framework, seeds=tuple(seeds), schedule=sched,
            params=params, losses=losses,
            metrics=_make_metrics(sched, comm, nsel, sim, cost, energy,
                                  losses, None), round_ms=round_ms,
            qstate=qstate)
        if test_data is not None:
            result.accuracy = evaluate_campaign(
                result, cfg, test_data, client_data=client_data,
                gamma=eval_gamma, policy=spec.policy)
        return result

    eval_fn = None
    do_eval = np.zeros(rounds, bool)
    if test_data is not None:
        x_test = torch.as_tensor(test_data[0], dtype=torch.float32,
                                 device=dev)
        y_test = torch.as_tensor(test_data[1], dtype=torch.int64, device=dev)
        eval_fn = engine.build_eval_fn(
            spec, cfg, x_test, y_test, gamma=eval_gamma,
            client_data={"x": x, "y": y} if framework == "splitme" else None,
            mesh=mesh)
        if eval_every:
            do_eval[eval_every - 1::eval_every] = True
        do_eval[rounds - 1] = True

    ckpt = _checkpoint_plan(framework, seeds, sched, spec, do_eval,
                            checkpoint_every, checkpoint_dir, resume,
                            _checkpoint_hook)
    params, buffers, clock, graphs = _run_rounds_scan(
        fns, local, kb_r, eb_r, params, qstate, indices, uniforms, do_eval,
        eval_fn, strict=strict_transfers, round_hook=_round_hook,
        guards=guards, faults=faults, ckpt=ckpt, capture=_graphs, mesh=mesh)
    host = _host_fetch(buffers)            # THE per-campaign transfer
    round_ms = clock.round_ms()
    losses = np.transpose(host["loss"], (1, 0, 2))        # (S, R, n_ph)
    acc_rounds = host.get("acc")                           # (R, S)
    skipped, quorum = host.get("skipped"), host.get("quorum")
    crashed = None
    if trace is not None and trace.crash is not None:
        crashed = (np.asarray(trace.crash[:rounds]) > 0).astype(np.float64)
    result = CampaignResult(
        framework=framework, seeds=tuple(seeds), schedule=sched,
        params=params, losses=losses,
        metrics=_make_metrics(sched, comm, nsel, sim, cost, energy, losses,
                              acc_rounds, skipped, quorum, crashed),
        accuracy_per_round=acc_rounds, round_ms=round_ms, graphs=graphs,
        qstate=qstate, skipped_per_round=skipped, quorum_per_round=quorum,
        crashed_per_round=crashed)
    if test_data is not None:
        result.accuracy = acc_rounds[rounds - 1]
    return result


def _check_mesh_device(mesh, dev: torch.device, graphs: bool) -> None:
    """The campaign's device against the mesh's backend: an NCCL mesh
    carries card tensors only; a gloo mesh carries CPU tensors, or card
    tensors outside CUDA graphs (gloo's all-reduce waits on the host)."""
    backend = str(torch.distributed.get_backend()).lower()
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL mesh needs device='cuda'")
    if backend != "nccl" and dev.type == "cuda" and graphs:
        raise ValueError(f"a {backend!r} mesh's all-reduce cannot be "
                         f"captured in a CUDA graph: run its card rounds "
                         f"uncaptured (_graphs=False) or use an NCCL mesh")


def run_config_sweep(framework: str, cfg: DNNConfig,
                     system_params: Sequence[SystemParams],
                     client_data: Dict[str, np.ndarray], *, rounds: int,
                     seeds: Sequence[int], test_data=None,
                     vmap_configs: bool = True, K: int = 10, E: int = 10,
                     e_initial: int = 20, policy_seed: Optional[int] = None,
                     eval_gamma: float = 1e-3,
                     eval_every: Optional[int] = None, mesh=None,
                     strict_transfers: bool = False, policy=None,
                     quant=None, scenario=None, scenario_seed: int = 0,
                     device: DeviceLike = None, params=None,
                     index_source: Optional[IndexSource] = None,
                     uniform_source: Optional[UniformSource] = None,
                     _round_hook: Optional[Callable[[int], None]] = None,
                     _graphs: bool = True,
                     **hyper) -> List[CampaignResult]:
    """Multi-config campaign over SystemParams variants: one
    ``CampaignResult`` a variant, in order.

    With ``vmap_configs=True`` (default) every variant's schedule is planned
    on the host (``plan_schedule``, ``policy_seed`` default ``min(seeds)``)
    and the V·S (variant, seed) pairs, variant-major, train through one
    scan (``_run_rounds_scan``): a round's shape is the bucket of the
    largest variant's cohort and of its largest E, and each pair trains its
    own variant's cohort for its own E inside it (masked slots and steps are
    exact no-ops).  The variants of a seed start from the same params and
    share its int8 uniforms, as the reference's variant-free key chain
    does; each pair keeps its own error-feedback state.  The
    evaluation (every ``eval_every`` rounds and the last) is one graph over
    the pairs, and the metrics of the whole sweep come back in one host
    transfer.  Every variant must have the sweep's client count M, and a
    fault scenario or ``mesh`` raise ``ValueError`` here.
    ``vmap_configs=False`` runs one ``run_campaign`` a variant, sharded
    over ``mesh`` when one is given.

    The port's keywords are ``run_campaign``'s: ``device``, ``params`` (one
    tuple a seed, shared by the variants), ``index_source(i, r, e_bucket)``
    (seed i's batch indices of round r at the sweep's E bucket),
    ``uniform_source(i, r)``, ``_round_hook`` and ``_graphs``.  By default
    each (variant, seed) pair draws its batches as its variant's own
    ``run_campaign`` does (its seed's generator, after the weights, at the
    variant's own E buckets; ``_initial_state(own_eb=)``), so the two
    modes read the same batches; an ``index_source`` is read a seed at the
    sweep's buckets and shared by the variants, which gives both modes the
    same batches when its E-bucket draws are prefixes of one another (the
    reference's key chains are)."""
    if not vmap_configs:
        return [run_campaign(framework, cfg, sp, client_data, rounds=rounds,
                             seeds=seeds, test_data=test_data, K=K, E=E,
                             e_initial=e_initial, policy_seed=policy_seed,
                             eval_gamma=eval_gamma, eval_every=eval_every,
                             mesh=mesh, strict_transfers=strict_transfers,
                             policy=policy, quant=quant, scenario=scenario,
                             scenario_seed=scenario_seed, device=device,
                             params=params, index_source=index_source,
                             uniform_source=uniform_source,
                             _round_hook=_round_hook, _graphs=_graphs,
                             **hyper)
                for sp in system_params]
    if mesh is not None:
        raise ValueError("mesh (sharded rounds) requires vmap_configs=False")
    dev = resolve_device(device)
    x = torch.as_tensor(client_data["x"], dtype=torch.float32, device=dev)
    y = torch.as_tensor(client_data["y"], dtype=torch.int64, device=dev)
    M, n_m = int(x.shape[0]), int(x.shape[1])
    if policy_seed is None:
        policy_seed = min(seeds)
    planned = [plan_schedule(framework, sp, cfg, rounds, K=K, E=E,
                             e_initial=e_initial, policy_seed=policy_seed,
                             n_samples_per_client=n_m, quant=quant,
                             scenario=scenario, scenario_seed=scenario_seed)
               for sp in system_params]
    for sp_d, _ in planned:
        if sp_d.M != M:
            raise ValueError(f"all SystemParams variants must have M={M} "
                             f"to share one schedule shape")
    scheds = [sch for _, sch in planned]
    for sch in scheds:
        if sch.trace is not None and sch.trace.has_faults():
            raise ValueError("fault-injection scenarios are not supported "
                             "by the vmapped config sweep; use "
                             "vmap_configs=False (per-variant campaigns)")
    V, S = len(planned), len(seeds)
    spec = engine.make_spec(framework, cfg, masked_loss_metric=True,
                            policy=policy, quant=quant, device=dev, **hyper)
    # each round's shape: the largest variant's cohort and E, bucketed
    a_v = np.stack([sch.a for sch in scheds], 1)             # (R, V, M)
    e_v = np.stack([sch.E for sch in scheds], 1)             # (R, V)
    kb_r, eb_r = _shape_buckets(
        a_v.sum(-1).max(1), e_v.max(1), M,
        max(int(sp_d.E_max) for sp_d, _ in planned))
    pairs = RoundSchedule(a=np.repeat(a_v, S, 1),
                          b=np.repeat(np.stack([sch.b for sch in scheds], 1),
                                      S, 1),
                          E=np.repeat(e_v, S, 1))
    params, _, indices, uniforms = _initial_state(
        spec, seeds, params, index_source, uniform_source, eb_r, M, n_m, dev,
        own_eb=[_round_shapes(sch, sp_d)[1] for sp_d, sch in planned])
    params = quantcomm.tree_map(
        lambda v: v.repeat((V,) + (1,) * (v.dim() - 1)), params)
    qstate = engine.init_quant_state(spec, params)
    fns = {s: engine.build_round_fn(spec, cfg, x, y, e_max=s[1], gather=True)
           for s in dict.fromkeys(zip(kb_r, eb_r))}
    eval_fn = None
    do_eval = np.zeros(rounds, bool)
    if test_data is not None:
        eval_fn = engine.build_eval_fn(
            spec, cfg,
            torch.as_tensor(test_data[0], dtype=torch.float32, device=dev),
            torch.as_tensor(test_data[1], dtype=torch.int64, device=dev),
            gamma=eval_gamma,
            client_data={"x": x, "y": y} if framework == "splitme" else None)
        if eval_every:
            do_eval[eval_every - 1::eval_every] = True
        do_eval[rounds - 1] = True
    params, buffers, clock, graphs = _run_rounds_scan(
        fns, pairs, kb_r, eb_r, params, qstate, indices, uniforms, do_eval,
        eval_fn, strict=strict_transfers, round_hook=_round_hook,
        capture=_graphs)
    host = _host_fetch(buffers)            # THE per-sweep transfer
    round_ms = clock.round_ms()
    results = []
    for v, (sp_d, sched) in enumerate(planned):
        part = slice(v * S, (v + 1) * S)
        losses = np.transpose(host["loss"][:, part], (1, 0, 2))
        acc_rounds = host["acc"][:, part] if "acc" in host else None
        comm, nsel, sim, cost, energy = _schedule_system_metrics(
            spec, sched, sp_d)
        res = CampaignResult(
            framework=framework, seeds=tuple(seeds), schedule=sched,
            params=quantcomm.tree_map(lambda t: t[part], params),
            losses=losses,
            metrics=_make_metrics(sched, comm, nsel, sim, cost, energy,
                                  losses, acc_rounds),
            accuracy_per_round=acc_rounds, round_ms=round_ms, graphs=graphs,
            qstate=quantcomm.tree_map(lambda t: t[part], qstate))
        if acc_rounds is not None:
            res.accuracy = acc_rounds[rounds - 1]
        results.append(res)
    return results


def _check_checkpoint_args(checkpoint_every, checkpoint_dir, resume,
                           strict_transfers: bool) -> None:
    if not (checkpoint_every or checkpoint_dir is not None or resume):
        return
    if not (checkpoint_every and checkpoint_dir is not None):
        raise ValueError("checkpointing needs BOTH checkpoint_every "
                         "and checkpoint_dir (resume implies both)")
    if strict_transfers:
        raise ValueError("checkpoint_every is incompatible with "
                         "strict_transfers: each save is an explicit "
                         "device→host pull")


def _checkpoint_plan(framework: str, seeds, sched, spec, do_eval,
                     checkpoint_every, checkpoint_dir, resume: bool, hook,
                     extra=()) -> Optional[dict]:
    """The scan's ``ckpt`` (None without ``checkpoint_every``): the
    schedule's fingerprint (``extra`` appends plan arrays), and with
    ``resume`` the newest committed checkpoint, refused when another plan
    wrote it."""
    if not checkpoint_every:
        return None
    fp = resilience.schedule_fingerprint(
        framework, seeds, sched, do_eval=do_eval, quant_mode=spec.quant.mode,
        checkpoint_every=checkpoint_every, extra=extra)
    resume_from = None
    if resume:
        resume_from = resilience.latest_checkpoint(checkpoint_dir)
        if resume_from is not None and resilience.load_checkpoint_meta(
                resume_from).get("fingerprint") != fp:
            raise ValueError(
                f"checkpoint {resume_from} was written by a different "
                f"campaign plan (schedule fingerprint mismatch); "
                f"refusing to resume")
    return {"dir": checkpoint_dir, "every": int(checkpoint_every),
            "fingerprint": fp, "resume_from": resume_from, "hook": hook,
            "framework": framework, "n_seeds": len(seeds)}


def _fault_plan(trace, guards, rounds: int, M: int) -> Optional[dict]:
    """The scanned rounds' fault operands, as the reference arms them:
    None when neither guards nor a fault channel nor a crash is armed (the
    rounds stay as they are), else the (R, M) poison (zeros where the trace
    has none) and wire gain (ones), the (R,) crash flags, and whether the
    rounds take the poison and wire channels at all."""
    poison = trace.poison if trace is not None else None
    wire = trace.wire_gain if trace is not None else None
    crash = trace.crash if trace is not None else None
    with_faults = poison is not None or wire is not None
    has_crash = crash is not None and bool(np.any(np.asarray(crash) > 0))
    if guards is None and not with_faults and not has_crash:
        return None
    return {"with_faults": with_faults,
            "poison": (np.zeros((rounds, M), np.float32) if poison is None
                       else np.asarray(poison[:rounds], np.float32)),
            "wire": (np.ones((rounds, M), np.float32) if wire is None
                     else np.asarray(wire[:rounds], np.float32)),
            "crash": (np.asarray(crash[:rounds], np.float32) if has_crash
                      else np.zeros(rounds, np.float32))}


class _RoundClock:
    """Each round's wall time: CUDA events on ``stream`` (read once the
    campaign's fetch has synchronized), or the host clock on the CPU; NaN
    for the first ``skipped`` rounds (restored by a resume, not run)."""

    def __init__(self, stream=None):
        self.stream, self.marks, self.skipped = stream, [], 0
        self.mark()

    def mark(self) -> None:
        if self.stream is None:
            self.marks.append(time.perf_counter())
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        self.marks.append(ev)

    def round_ms(self) -> np.ndarray:
        if self.stream is None:
            ms = np.diff(self.marks) * 1e3
        else:
            ms = np.array([a.elapsed_time(b) for a, b
                           in zip(self.marks, self.marks[1:])])
        return np.concatenate([np.full(self.skipped, np.nan), ms])


def _run_rounds_loop(fns, sched, kb_r, eb_r, params, qstate, indices,
                     uniforms):
    """The eager per-round loop: one gathered round call per round, one
    host transfer per round when its loss row is pulled."""
    dev = params[0][0]["w"].device
    clock = _RoundClock(torch.cuda.current_stream(dev)
                        if dev.type == "cuda" else None)
    loss_rows = []
    for r in range(sched.rounds):
        kb, eb = kb_r[r], eb_r[r]
        sel, k = _cohort(sched.a[r], kb)
        mask = np.zeros(kb, np.float32)
        mask[:k] = 1.0
        params, loss_r, qstate = fns[kb, eb](
            params, torch.from_numpy(sel).to(dev),
            torch.from_numpy(mask).to(dev), int(sched.E[r]),
            indices[r].to(dev), qstate,
            None if uniforms is None else uniforms[r].to(dev))
        loss_rows.append(loss_r)
        clock.mark()
    losses = np.stack(
        [np.stack(_host_fetch(row), axis=-1) for row in loss_rows],
        axis=1)                                   # (S, R, n_phases)
    return losses, params, qstate, clock.round_ms()


def _run_rounds_scan(fns, sched, kb_r, eb_r, params, qstate, indices,
                     uniforms, do_eval, eval_fn, *, strict: bool,
                     round_hook, guards=None, faults=None, ckpt=None,
                     capture: bool = True, data=None, mesh=None):
    """All rounds, one graph replay each on CUDA (the same bodies without
    capture on the CPU, or with ``capture=False``); returns (params, device
    metric buffers, the rounds' ``_RoundClock``, graph stats).  ``params``
    and ``qstate`` are updated in place.  ``faults`` (``_fault_plan``) adds
    each round's f32 fault row; ``ckpt`` saves and restores the carry
    (``run_campaign``).  ``data`` (population mode) gives each round's
    cohort data, ``(x (kb, n, d) f32, y (kb, n) int)`` for its kb slots:
    the labels ride at the end of the round's int64 row, the features in
    one f32 operand a shape, and the rounds are ``build_cohort_round_fn(
    gather=True)``'s, which take them first.  A ``sched`` whose ``a`` is
    (R, P, M) and ``E`` (R, P) gives P pairs their own cohorts and E (the
    config sweep; ``params`` pair-stacked, ``indices`` per pair or per
    seed).  ``mesh`` (a sharded campaign): ``sched``, ``indices`` and the
    fault rows are this rank's slab's, ``eval_fn`` evaluates every seed in
    one call, and checkpoints gather the ranks' error-feedback state."""
    dev = params[0][0]["w"].device
    R = sched.rounds
    S, n_ph, M, _, B = indices[0].shape
    L = params[0][0]["w"].shape[0]             # seeds, or (variant, seed)
    P = L if sched.a.ndim == 3 else 0
    cuda = dev.type == "cuda"
    graphed = cuda and capture
    # every tensor a round writes and the next reads: the params and the
    # error-feedback state
    state = ([v for ps in params for p in ps for v in p.values()]
             + quantcomm.tree_leaves(qstate))
    buffers = {"loss": torch.full((R, L, n_ph), float("nan"), device=dev)}
    if eval_fn is not None:
        buffers["acc"] = torch.full((R, L), float("nan"), device=dev)
    if guards is not None:
        buffers["skipped"] = torch.zeros((R, L), device=dev)
        buffers["quorum"] = torch.zeros((R, L), device=dev)
    r_slot = torch.zeros(1, dtype=torch.int64, device=dev)
    start = _restore(ckpt, params, qstate, buffers, mesh)

    # one int64 operand row a round: [r, E, |A_t|, cohort (kb), indices,
    # and in population mode the cohort's labels (kb·n)], for pairs [r, E
    # (P), |A_t| (P), cohorts (P·kb), indices]; with faults one f32 row:
    # [crash, poison (kb), wire gain (kb)]; in population mode the cohort's
    # features, one (kb, n, d) f32 slice a round
    shapes = list(dict.fromkeys(zip(kb_r, eb_r)))
    rows: Dict[Tuple[int, int], list] = {s: [] for s in shapes}
    frows: Dict[Tuple[int, int], list] = {s: [] for s in shapes}
    drows: Dict[Tuple[int, int], list] = {s: [] for s in shapes}
    where, rounds_of = [], {s: [] for s in shapes}
    for r in range(R):
        s = (kb_r[r], eb_r[r])
        sel, k = _cohort(sched.a[r], s[0])
        row = [torch.tensor([r]),
               torch.from_numpy(np.asarray(sched.E[r], np.int64).reshape(-1)),
               torch.from_numpy(np.asarray(k, np.int64).reshape(-1)),
               torch.from_numpy(sel.reshape(-1)), indices[r].reshape(-1)]
        if data is not None:
            drows[s].append(torch.from_numpy(
                np.ascontiguousarray(data[r][0], np.float32)))
            row.append(torch.from_numpy(
                np.asarray(data[r][1], np.int64).reshape(-1)))
        rows[s].append(torch.cat(row))
        if faults is not None:
            # gathered by the cohort; pads stay neutral (poison 0, gain 1)
            pz, wg = np.zeros(s[0], np.float32), np.ones(s[0], np.float32)
            pz[:k], wg[:k] = faults["poison"][r, sel[:k]], \
                faults["wire"][r, sel[:k]]
            frows[s].append(torch.from_numpy(np.concatenate(
                [faults["crash"][r:r + 1], pz, wg])))
        where.append(len(rows[s]) - 1)
        rounds_of[s].append(r)
    tables = {s: torch.stack(v).to(dev) for s, v in rows.items()}
    ops = {s: torch.empty_like(t[0]) for s, t in tables.items()}
    ftables = fops = None
    if faults is not None:
        ftables = {s: torch.stack(v).to(dev) for s, v in frows.items()}
        fops = {s: torch.empty_like(t[0]) for s, t in ftables.items()}
    with_faults = faults is not None and faults["with_faults"]
    dtables = dops = None
    if data is not None:
        dtables = {s: torch.stack(v).to(dev) for s, v in drows.items()}
        dops = {s: torch.empty_like(t[0]) for s, t in dtables.items()}
    # the int8 uniforms: one (S, U) slice a round, copied into one operand
    utable = uop = None
    if uniforms is not None:
        utable = torch.stack(uniforms).to(dev)
        uop = torch.empty_like(utable[0])

    def round_body(s):
        kb, eb = s
        fn, op = fns[s], ops[s]
        fop = fops[s] if fops is not None else None

        head = 1 + 2 * P + P * kb if P else 3 + kb
        end = head + S * n_ph * M * eb * B

        def body():
            r = op[0:1]
            if P:
                mask = (torch.arange(kb, device=dev)
                        < op[1 + P:1 + 2 * P, None]).float()
                sel, e = op[1 + 2 * P:head].view(P, kb), op[1:1 + P]
            else:
                mask = (torch.arange(kb, device=dev) < op[2]).float()
                sel, e = op[3:3 + kb], op[1]
            args = (params, sel, mask, e,
                    op[head:end].view(S, n_ph, M, eb, B), qstate, uop)
            if dops is not None:
                args = (params, dops[s], op[end:].view(kb, -1)) + args[1:]
            if with_faults:
                args += ({"poison": fop[1:1 + kb],
                          "wire_gain": fop[1 + kb:]},)
            out = fn(*args)
            new, losses, nq = out[:3]
            loss_row = torch.stack(losses, -1)
            fresh = ([v for ps in new for p in ps for v in p.values()]
                     + quantcomm.tree_leaves(nq))
            if fop is None:
                for old, v in zip(state, fresh):
                    old.copy_(v)
            else:
                # a crash round is lost at the server: params and
                # error-feedback state hold, its loss row is NaN
                ran = fop[0] <= 0
                for old, v in zip(state, fresh):
                    old.copy_(torch.where(ran, v, old))
                loss_row = torch.where(ran, loss_row, float("nan"))
            buffers["loss"].index_copy_(0, r, loss_row[None])
            if guards is not None:
                for k, flag in out[3].items():
                    if fop is not None:
                        flag = torch.where(ran, flag, 0.0)
                    buffers[k].index_copy_(0, r, flag[None])
            r_slot.copy_(r)
        return body

    def eval_body():
        seeds = [_seed_params(params, i) for i in range(L)]
        acc = (eval_fn(seeds) if mesh is not None
               else torch.stack([eval_fn(p) for p in seeds]))
        buffers["acc"].index_copy_(0, r_slot, acc[None])

    bodies = {s: round_body(s) for s in shapes}
    bodies["eval"] = eval_body
    stream = _side_stream(dev) if cuda else None
    if cuda:
        stream.wait_stream(torch.cuda.current_stream(dev))
        pool = torch.cuda.graph_pool_handle()
    graphs: Dict[Any, torch.cuda.CUDAGraph] = {}
    capture_s = 0.0

    def run(key, restore=()):
        nonlocal capture_s
        if not graphed:
            bodies[key]()
            return
        if key not in graphs:
            graphs[key], secs = _capture(bodies[key], pool, restore)
            capture_s += secs
        graphs[key].replay()

    with _no_syncs(dev, strict), torch.cuda.stream(stream):
        clock = _RoundClock(stream)
        for r in range(start, R):
            s = (kb_r[r], eb_r[r])
            ops[s].copy_(tables[s][where[r]])
            if fops is not None:
                fops[s].copy_(ftables[s][where[r]])
            if dops is not None:
                dops[s].copy_(dtables[s][where[r]])
            if uop is not None:
                uop.copy_(utable[r])
            run(s, state)
            if do_eval[r]:
                run("eval")
            clock.mark()
            if round_hook is not None:
                round_hook(r)
            if ckpt is not None and ((r + 1) % ckpt["every"] == 0
                                     or r + 1 == R):
                _save(ckpt, r + 1, R, params, qstate, buffers, mesh)
    clock.skipped = start
    if not cuda:
        return params, buffers, clock, None
    torch.cuda.current_stream(dev).wait_stream(stream)
    stats = {"shapes": {s: rounds_of[s] for s in shapes},
             "graphs": len(graphs), "capture_s": capture_s}
    return params, buffers, clock, stats


_SIDE_STREAMS: Dict[int, Any] = {}


def _side_stream(dev: torch.device):
    """The campaigns' side stream on ``dev``, one per device for the
    process: cuBLAS keeps a workspace per (handle, stream) for as long as
    the process lives (~67 MB on the H100), so a new stream per campaign
    would hold one more workspace each, up to the 32 streams of torch's
    pool."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _SIDE_STREAMS:
        _SIDE_STREAMS[index] = torch.cuda.Stream(device=dev)
    return _SIDE_STREAMS[index]


def _gather_shards(qstate, mesh):
    """Every rank's error-feedback state in the reference's gathered layout,
    (S, n_shards, …) a leaf, on every rank: each rank writes its slice of a
    zero tensor and one all-reduce sums them (exact: the other slices add
    zeros), which every backend carries for card and CPU tensors alike."""
    full = engine.shard_layout(qstate, engine.n_client_shards(mesh), 1)
    leaves = quantcomm.tree_leaves(full)
    for f, l in zip(leaves, quantcomm.tree_leaves(qstate)):
        f[:, engine.shard_index(mesh)] = l
    if leaves:
        vec = torch.cat([f.reshape(-1) for f in leaves])
        torch.distributed.all_reduce(vec, group=engine.client_group(mesh))
        for f, p in zip(leaves, torch.split(vec, [f.numel()
                                                  for f in leaves])):
            f.copy_(p.reshape(f.shape))
    return full


def _save(ckpt, cursor: int, R: int, params, qstate, buffers,
          mesh=None) -> None:
    """Commit the carry after round ``cursor`` − 1 (the device→host pull
    waits for the rounds queued on the current stream), then run the hook.
    On a mesh rank 0 writes, with the ranks' error-feedback state gathered,
    and every rank waits for the commit before its hook."""
    if mesh is not None:
        qstate = _gather_shards(qstate, mesh)
    if mesh is None or torch.distributed.get_rank() == 0:
        resilience.save_checkpoint(
            ckpt["dir"], cursor, {"params": params, "qstate": qstate},
            {k: v[:cursor] for k, v in buffers.items()},
            fingerprint=ckpt["fingerprint"], rounds=R,
            framework=ckpt["framework"], n_seeds=ckpt["n_seeds"])
    if mesh is not None:
        torch.distributed.barrier()
    if ckpt["hook"] is not None:
        ckpt["hook"](cursor)


def _restore(ckpt, params, qstate, buffers, mesh=None) -> int:
    """Copy a resumed campaign's checkpoint into the state tensors and the
    buffers' first rows, in place; the round cursor to go on from (0 when
    there is nothing to resume).  On a mesh each rank takes its own slice
    of the gathered error-feedback state."""
    if ckpt is None or ckpt["resume_from"] is None:
        return 0
    path = Path(ckpt["resume_from"])
    if mesh is not None and qstate != ():
        full = engine.shard_layout(qstate, engine.n_client_shards(mesh), 1)
        io.restore(path, {"params": params, "qstate": full})
        for t, f in zip(quantcomm.tree_leaves(qstate),
                        quantcomm.tree_leaves(full)):
            t.copy_(f[:, engine.shard_index(mesh)])
    else:
        io.restore(path, {"params": params, "qstate": qstate})
    saved = io.load_arrays(path.with_name(path.name + "-buffers"))
    if set(saved) != set(buffers):
        raise ValueError(f"checkpoint {path} holds the buffers "
                         f"{sorted(saved)}, this campaign has "
                         f"{sorted(buffers)}")
    cursor = int(io.manifest(path)["metadata"]["round_cursor"])
    for k, v in saved.items():
        if v.shape[0] != cursor or v.shape[1:] != buffers[k].shape[1:]:
            raise ValueError(f"checkpoint {path}: buffer {k} is "
                             f"{v.shape}, want ({cursor}, "
                             f"{tuple(buffers[k].shape[1:])})")
        buffers[k][:cursor].copy_(torch.from_numpy(v))
    return cursor


def _capture(body, pool, restore):
    """A CUDA graph of ``body`` on the current (side) stream, after one
    eager warm-up (building the kernels, library handles and workspaces
    outside the graph) whose writes to ``restore`` are undone.  The LU
    solves of the evaluation are pinned to cuSOLVER, whose getrf/getrs are
    stream ordered: the default backend picks it for one matrix too, but a
    process-wide "magma" preference would make the capture fail (MAGMA's
    hybrid LU waits on the host).  Returns the graph and the seconds of the
    capture itself; a failed capture raises."""
    saved = [t.clone() for t in restore]
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        body()
        for t, v in zip(restore, saved):
            t.copy_(v)
        del saved
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        graph.capture_begin(pool=pool)
        try:
            body()
        except BaseException:
            with contextlib.suppress(Exception):
                graph.capture_end()
            raise
        graph.capture_end()
        return graph, time.perf_counter() - t0
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


# ---------------------------------------------------------------------------
# Population mode: O(cohort) campaigns over millions of virtual clients
# ---------------------------------------------------------------------------

@dataclass
class PopulationSchedule:
    """The host plan of a population campaign, cohort-shaped throughout:
    round t touches the ``cohort_sizes[t]`` distinct clients ``ids[t]``
    (pads repeat ``ids[t, 0]`` and are never selectable), and ``a`` / ``b``
    index cohort positions, not client ids.  ``rows`` holds the realized
    per-round Q_C / Q_S / gain of the sampled clients (framework derivation
    and trace channels applied), which ``cost.schedule_metrics(rows=)``
    vectorizes over."""
    ids: np.ndarray           # (R, C) int64 sampled client ids
    a: np.ndarray             # (R, C) realized selection over positions
    b: np.ndarray             # (R, C) bandwidth fractions
    E: np.ndarray             # (R,)   local-update counts
    m_t: np.ndarray           # (R,)   registered population per round
    cohort_sizes: np.ndarray  # (R,)   distinct sampled ids (<= C)
    rows: Dict[str, np.ndarray]           # {"q_c", "q_s", "gain"} (R, C)
    trace: Optional[popn.PopulationTrace] = None

    @property
    def rounds(self) -> int:
        return len(self.E)


def plan_population_schedule(framework: str, population: popn.Population,
                             cfg: DNNConfig, rounds: int, *, cohort: int,
                             policy_seed: int = 0, K: int = 10, E: int = 10,
                             e_initial: int = 20,
                             n_samples_per_client: Optional[int] = None,
                             quant=None, scenario=None,
                             scenario_seed: int = 0,
                             stratified: bool = False
                             ) -> Tuple[SystemParams, PopulationSchedule]:
    """The framework's host policy over per-round sampled cohorts, as the
    reference plans it.  Each round t: sample ``min(cohort, m_t)`` distinct
    ids of the round's registered population (uniform or stratified;
    deterministic in ``(scenario_seed, t)`` alone, so a resume replans the
    same cohorts), evaluate their rows and the trace's channels, write them
    into the framework's derived ``SystemParams`` copy, and let
    ``policy.step()`` select and allocate within the cohort.  Memory is
    O(rounds × cohort); the population's size enters only the samplers.

    With no scenario and ``cohort >= population.size`` every cohort is the
    whole population in id order, and the plan equals ``plan_schedule`` on
    ``population.system_params(arange(size))``."""
    ptrace = popn.get_population_trace(scenario, rounds, population.size,
                                       seed=scenario_seed)
    m_t = (ptrace.m_t if ptrace is not None
           else np.full(rounds, population.size, np.int64))
    C = int(min(cohort, population.size))
    if C < 1:
        raise ValueError(f"cohort must be >= 1, got {cohort}")
    ids = np.zeros((rounds, C), np.int64)
    csize = np.zeros(rounds, np.int64)
    for t in range(rounds):
        got = popn.sample_cohort(scenario_seed, t, m_t[t], C,
                                 stratified=stratified)
        csize[t] = got.size
        ids[t, :got.size] = got
        if got.size < C:
            ids[t, got.size:] = got[0]     # pads: real data, never selected
    sp, policy = engine.make_policy(
        framework, population.system_params(ids[0]), cfg, seed=policy_seed,
        K=K, E=E, e_initial=e_initial,
        n_samples_per_client=n_samples_per_client, quant=quant)
    fold_offload = framework == "oranfed"  # make_policy folded Q_S into Q_C
    pos = np.arange(C)
    a_l, b_l, e_l = [], [], []
    q_c_all = np.zeros((rounds, C))
    q_s_all = np.zeros((rounds, C))
    gain_all = np.zeros((rounds, C))
    for t in range(rounds):
        r = population.rows(ids[t])
        ch = ptrace.channels(t, ids[t]) if ptrace is not None else None
        q_c = r["Q_C"] * (ch["qc_scale"] if ch is not None else 1.0)
        q_s = r["Q_S"] * (ch["qs_scale"] if ch is not None else 1.0)
        if fold_offload:
            q_c, q_s = q_c + q_s, np.zeros_like(q_s)
        gain = r["G_m"] * (ch["gain"] if ch is not None else 1.0)
        pad_live = (pos < csize[t]).astype(np.float64)
        # the policies read sp's arrays on every step(); S_m, omega and
        # d_model_bits do not depend on the cohort, so only the per-client
        # rows are rewritten round to round
        sp.Q_C, sp.Q_S, sp.G_m = q_c, q_s, gain
        sp.t_round = r["t_round"] * (ch["deadline_scale"] if ch is not None
                                     else 1.0)
        sp.avail = (ch["avail"] if ch is not None else 1.0) * pad_live
        a, b, e = policy.step()
        if ch is not None:
            a_real = a * ch["drop"]
            if a_real.sum() == 0 and a.sum() > 0:   # never stall
                a_real = np.zeros_like(a)
                a_real[np.argmax(a > 0)] = 1.0
            a = a_real
        a_l.append(a), b_l.append(b), e_l.append(e)
        q_c_all[t], q_s_all[t], gain_all[t] = q_c, q_s, gain
    sched = PopulationSchedule(
        ids=ids, a=np.stack(a_l), b=np.stack(b_l),
        E=np.asarray(e_l, np.int32), m_t=np.asarray(m_t, np.int64),
        cohort_sizes=csize,
        rows={"q_c": q_c_all, "q_s": q_s_all, "gain": gain_all},
        trace=ptrace)
    return sp, sched


def run_population_campaign(framework: str, cfg: DNNConfig,
                            population: popn.Population, data, *,
                            rounds: int, seeds: Sequence[int], cohort: int,
                            samples_per_client: int = 64, test_data=None,
                            K: int = 10, E: int = 10, e_initial: int = 20,
                            policy_seed: Optional[int] = None,
                            eval_every: Optional[int] = None,
                            eval_gamma: float = 1e-3,
                            strict_transfers: bool = False, policy=None,
                            quant=None, scenario=None,
                            scenario_seed: int = 0,
                            stratified: bool = False, guards=None,
                            checkpoint_every: Optional[int] = None,
                            checkpoint_dir=None, resume: bool = False,
                            device: DeviceLike = None, params=None,
                            index_source: Optional[IndexSource] = None,
                            uniform_source: Optional[UniformSource] = None,
                            _round_hook: Optional[Callable[[int], None]]
                            = None,
                            _checkpoint_hook: Optional[Callable[[int], None]]
                            = None,
                            _graphs: bool = True,
                            **hyper) -> CampaignResult:
    """The scanned campaign over a ``Population``: O(cohort) in memory,
    never O(population).

    ``data`` is the raw ``(X, y)`` sample pool.  The plan
    (``plan_population_schedule``) samples each round's cohort; only the
    clients a round trains draw their shards (``Population.sample_shards``,
    a pure function of the id), and each round's selected shards, padded to
    its (cohort bucket, E bucket) shape, become that round's data operand
    (``build_cohort_round_fn(gather=True)``), uploaded with the other
    operand tables before the device phase: O(Σ_t kb_t · n · d) on the
    device.  The rest is ``run_campaign``'s scanned path (one CUDA graph a
    round shape plus the evaluation's, the seeds folded into the client
    axis, one host transfer, ``strict_transfers``, the wire formats,
    ``RoundGuards``, checkpoints and resume, with the cohort ids and
    ``m_t`` in the schedule fingerprint).  Population traces carry no fault
    channels (``"faults:p"`` raises ``KeyError``), so guards arm only when
    given.

    SplitMe's Step 4 takes the final round's cohort shards, pads included,
    as its client data; with ``cohort >= population.size`` that is the
    whole materialized dataset.  The baselines evaluate their full model.

    The port's own keywords are ``run_campaign``'s: ``device``, ``params``,
    ``index_source(i, r, e_bucket)`` (seed i's batch indices of round r
    over all C cohort positions, ``(n_phases, C, e_bucket, batch_size)``
    int64), ``uniform_source``, ``_round_hook``, ``_checkpoint_hook`` and
    ``_graphs``.  By default each seed's generator draws its initial
    weights and then, round by round, its indices over the C positions."""
    if guards not in (None, False) and not isinstance(guards, RoundGuards):
        raise TypeError(f"guards must be None, False or a RoundGuards, got "
                        f"{type(guards).__name__}")
    if guards is False:
        guards = None
    dev = resolve_device(device)
    X, y = np.asarray(data[0]), np.asarray(data[1])
    n = int(samples_per_client)
    if policy_seed is None:
        policy_seed = min(seeds)
    sp, sched = plan_population_schedule(
        framework, population, cfg, rounds, cohort=cohort,
        policy_seed=policy_seed, K=K, E=E, e_initial=e_initial,
        n_samples_per_client=n, quant=quant, scenario=scenario,
        scenario_seed=scenario_seed, stratified=stratified)
    spec = engine.make_spec(framework, cfg, masked_loss_metric=True,
                            policy=policy, quant=quant, device=dev, **hyper)
    comm = np.atleast_1d(np.asarray(
        spec.comm_model(sched.a, sched.E, sp), np.float64))
    nsel = sched.a.sum(axis=1).astype(int)
    sim, cost, energy = schedule_metrics(sched.a, sched.b, sched.E, sp,
                                         rows=sched.rows)
    _check_checkpoint_args(checkpoint_every, checkpoint_dir, resume,
                           strict_transfers)

    # each round's trained slots draw their shards (pads repeat slot 0's
    # position, as the materialized round's pads index client 0)
    alpha = "population"
    if sched.trace is not None and sched.trace.data_alpha is not None:
        alpha = sched.trace.data_alpha
    C = int(sched.ids.shape[1])
    kb_r, eb_r = _round_shapes(sched, sp)
    shards = []
    for t in range(rounds):
        sel, _ = _cohort(sched.a[t], kb_r[t])
        sh = population.sample_shards(X, y, sched.ids[t, sel], n,
                                      alpha=alpha)
        shards.append((sh["x"], sh["y"]))
    params, qstate, indices, uniforms = _initial_state(
        spec, seeds, params, index_source, uniform_source, eb_r, C, n, dev)
    fns = {s: engine.build_cohort_round_fn(spec, cfg, e_max=s[1],
                                           gather=True, guards=guards)
           for s in dict.fromkeys(zip(kb_r, eb_r))}

    eval_fn = None
    do_eval = np.zeros(rounds, bool)
    if test_data is not None:
        client_data = None
        if framework == "splitme":
            last = population.sample_shards(X, y, sched.ids[-1], n,
                                            alpha=alpha)
            client_data = {
                "x": torch.as_tensor(last["x"], dtype=torch.float32,
                                     device=dev),
                "y": torch.as_tensor(last["y"], dtype=torch.int64,
                                     device=dev)}
        eval_fn = engine.build_eval_fn(
            spec, cfg,
            torch.as_tensor(test_data[0], dtype=torch.float32, device=dev),
            torch.as_tensor(test_data[1], dtype=torch.int64, device=dev),
            gamma=eval_gamma, client_data=client_data)
        if eval_every:
            do_eval[eval_every - 1::eval_every] = True
        do_eval[rounds - 1] = True

    ckpt = _checkpoint_plan(framework, seeds, sched, spec, do_eval,
                            checkpoint_every, checkpoint_dir, resume,
                            _checkpoint_hook, extra=(sched.ids, sched.m_t))
    params, buffers, clock, graphs = _run_rounds_scan(
        fns, sched, kb_r, eb_r, params, qstate, indices, uniforms, do_eval,
        eval_fn, strict=strict_transfers, round_hook=_round_hook,
        guards=guards, ckpt=ckpt, capture=_graphs, data=shards)
    host = _host_fetch(buffers)            # THE per-campaign transfer
    losses = np.transpose(host["loss"], (1, 0, 2))        # (S, R, n_ph)
    acc_rounds = host.get("acc")                           # (R, S)
    skipped, quorum = host.get("skipped"), host.get("quorum")
    result = CampaignResult(
        framework=framework, seeds=tuple(seeds), schedule=sched,
        params=params, losses=losses,
        metrics=_make_metrics(sched, comm, nsel, sim, cost, energy, losses,
                              acc_rounds, skipped, quorum),
        accuracy_per_round=acc_rounds, round_ms=clock.round_ms(),
        graphs=graphs, qstate=qstate, skipped_per_round=skipped,
        quorum_per_round=quorum)
    if test_data is not None:
        result.accuracy = acc_rounds[rounds - 1]
    return result


def evaluate_campaign(result: CampaignResult, cfg: DNNConfig, test_data,
                      client_data=None, gamma: float = 1e-3,
                      policy=None) -> np.ndarray:
    """Per-seed test accuracy of a finished campaign (post-hoc; the scanned
    campaign replays the same evaluation after its eval rounds).  The
    baselines evaluate their aggregated MLP; SplitMe's Step 4 recovers each
    seed's server model from the client data's Grams (``client_data``),
    then the stitched forward runs on the test split.  One host
    transfer."""
    splitme = result.framework == "splitme"
    if splitme and client_data is None:
        raise ValueError("splitme evaluation needs client_data for Step 4")
    dev = result.params[0][0]["w"].device
    spec = engine.make_spec(result.framework, cfg, policy=policy, device=dev)
    eval_fn = engine.build_eval_fn(
        spec, cfg,
        torch.as_tensor(test_data[0], dtype=torch.float32, device=dev),
        torch.as_tensor(test_data[1], dtype=torch.int64, device=dev),
        client_data={k: torch.as_tensor(
            client_data[k], dtype=torch.float32 if k == "x" else torch.int64,
            device=dev) for k in ("x", "y")} if splitme else None,
        gamma=gamma)
    acc = torch.stack([eval_fn(result.params_for(i))
                       for i in range(len(result.seeds))])
    return np.asarray(_host_fetch(acc), dtype=np.float64)
