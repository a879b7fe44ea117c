"""Dry-run of the model zoo on the production mesh: one train, prefill or
decode step of every (architecture × input shape) on ``meta`` DTensors over
a fake world, its fit on one card and its roofline terms; twin of
``repro.launch.dryrun``.

The JAX package lowers and compiles each combination onto 256 or 512 fake
XLA devices.  Here rank 0 of a fake ``torch.distributed`` world of as many
ranks (``launch.mesh.make_production_mesh``) runs its share of the step:
the parameters, optimizer state, batch and cache are ``meta`` DTensors laid
out by ``sharding.partition``'s rules, so nothing is allocated, and
``roofline.analysis``'s ``CostCounter`` sees the rank's local ops and
the collectives DTensor inserts.  The zoo runs its plain scans
(``policy="reference"``): the CUDA ops take no meta tensors; RWKV6's and
Zamba2's loops are counted from a few steps (``count_step``: the result's
``method``).  The 2 × 16 × 16 mesh runs as ("pod", "data") one dim of 32
by "model" (``make_dryrun_mesh``).  The port's strategies
(``sharding.rules``) and reshards (``sharding.partition``) stand in for
what XLA does on its own; an op that DTensor still has no sharding rule
for fails its combination (``ok: false`` with the op's name): nothing is
quietly replicated.

A process group is process-global, so this is a process of its own:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Results are JSON files under ``--out`` (default ``build/dryrun_torch/``);
reruns skip the combinations already there (``--force`` redoes them).
"""
from __future__ import annotations

import argparse
import json
import re
import time
import traceback
from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import INPUT_SHAPES, list_configs
from repro_torch.launch.mesh import HBM_BYTES, make_dryrun_mesh
from repro_torch.launch.specs import (abstract_cache, batch_specs, build_for,
                                      META)
from repro_torch.kernels import dispatch
from repro_torch.roofline.analysis import (CollectiveOp, CollectiveTrace,
                                           CostCounter, MemoryStats, analyze,
                                           model_flops_estimate,
                                           peak_flops_for)
from repro_torch.runtime.steps import (default_optimizer, make_prefill_step,
                                       make_serve_step, make_train_step)
from repro_torch.sharding import partition, rules

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"

ARCHS = [a for a in list_configs() if a != "splitme-dnn10"]


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def local_bytes(tree) -> float:
    """Bytes of one rank's share of every tensor in ``tree`` (DTensors by
    their local shard; dicts, lists and tuples walked; host values 0)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, DTensor):
        t = tree.to_local()
        return float(t.numel() * t.element_size())
    if isinstance(tree, torch.Tensor):
        return float(tree.numel() * tree.element_size())
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    return 0.0


def shard_opt_state(state, mesh, *, fsdp: bool = True,
                    expert_parallel=False, path: str = ""):
    """The optimizer state with every tensor laid out by the param rules
    on its own shape and path (the reference's ``params_shardings`` over
    the optimizer's tree): a DTensor redistributed, a plain one (a state
    made from nothing, such as Adafactor's factored moments) distributed."""
    from torch.distributed.tensor import DTensor
    if isinstance(state, DTensor) or (isinstance(state, torch.Tensor)
                                      and state.dim()):
        spec = partition.param_spec(path, tuple(state.shape), mesh,
                                    fsdp=fsdp,
                                    expert_parallel=expert_parallel)
        if isinstance(state, DTensor):
            return state.redistribute(mesh, partition.placements(spec, mesh))
        return partition.distribute(state, spec, mesh)
    if isinstance(state, dict):
        return {k: shard_opt_state(v, mesh, fsdp=fsdp,
                                   expert_parallel=expert_parallel,
                                   path=re.sub(r"\.\d+\.", "/",
                                               f"{path}/{k}").strip("/"))
                for k, v in state.items()}
    return state


_ACTIVE_OP = [None]


class _Trace(CostCounter):
    """A ``CostCounter`` that leaves the DTensor op it last saw where a
    timed-out combination can read it."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        _ACTIVE_OP[0] = self.last_dtensor_op
        return out


def step_on_mesh(model, shape, mesh, overrides: dict):
    """Run one step of ``shape.kind`` of the meta ``model`` on ``mesh``
    under a ``CostCounter`` (which traces the collectives too): (the
    counter, MemoryStats, optimizer name or None).  The tensors a step makes from
    nothing (positions, masks, zeros) are replicated DTensors
    (``implicit_replication``), as a jitted JAX step's constants are."""
    from torch.distributed.tensor.experimental import implicit_replication
    rules.install()
    with implicit_replication():
        return _step_on_mesh(model, shape, mesh, overrides)


def _step_on_mesh(model, shape, mesh, overrides: dict):
    cfg = model.cfg
    # a one-rank mesh has nothing to shard: the step runs on plain meta
    # tensors (the same counts, without DTensor's dispatch)
    one_rank = mesh.size() == 1
    fsdp = overrides.get("fsdp", True)
    ep = overrides.get("expert_parallel", False)
    dpm = overrides.get("dp_over_model", False)

    def lay_batch(batch):
        return batch if one_rank else partition.shard_batch(
            batch, mesh, dp_over_model=dpm)

    # the cache is made from the plain parameters (an enc-dec's cross K / V
    # of its memory), then laid out by the cache rule
    cache = abstract_cache(model, shape) if shape.kind == "decode" else None
    if one_rank:
        pass
    elif overrides.get("pure_dp"):
        specs = {k: partition.replicated(p.dim())
                 for k, p in model.named_parameters()}
        partition.shard_params(model, mesh, specs=specs)
    else:
        partition.shard_params(model, mesh, fsdp=fsdp, expert_parallel=ep)
    opt_name = None
    gathered = CollectiveTrace()
    if overrides.get("zero3") and shape.kind == "train" and not one_rank:
        # ZeRO-3: parameters STORED row-sharded, GATHERED for compute (one
        # weight all-gather a step instead of partial-sum all-reduces of
        # the activations); the step runs on the gathered copies
        specs = partition.param_specs(cfg, model.named_parameters(), mesh,
                                      fsdp=False, expert_parallel=ep)
        with gathered:
            for key, p in list(model.named_parameters()):
                mod = model.get_submodule(key.rpartition(".")[0])
                mod.register_parameter(key.rpartition(".")[2],
                                       torch.nn.Parameter(p.redistribute(
                                           mesh, partition.placements(
                                               specs[key], mesh)),
                                           requires_grad=False))
    if shape.kind == "train":
        opt_name = overrides.get("optimizer") or default_optimizer(cfg)
        init_state, train_step = make_train_step(
            model, optimizer=opt_name,
            grad_dtype=overrides.get("grad_dtype"))
        opt_state, step = init_state()
        if not (overrides.get("pure_dp") or one_rank):
            opt_state = shard_opt_state(opt_state, mesh, fsdp=fsdp,
                                        expert_parallel=ep)
        batch = lay_batch(batch_specs(cfg, shape))
        args = (dict(model.named_parameters()), opt_state, batch)
        with _Trace("meta") as cc:
            opt_state, step, metrics = train_step(opt_state, step, batch)
        outs = (dict(model.named_parameters()), opt_state, metrics)
        cc.ops[:0] = gathered.ops
    elif shape.kind == "prefill":
        batch = lay_batch(batch_specs(cfg, shape))
        args = (dict(model.named_parameters()), batch)
        with torch.no_grad(), _Trace("meta") as cc:
            outs = make_prefill_step(model)(batch)
    else:
        tok = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                          device=META)
        if not one_rank:
            cache = partition.shard_cache(cache, mesh)
            tok = lay_batch({"t": tok})["t"]
        args = (dict(model.named_parameters()), tok, cache)
        with torch.no_grad(), _Trace("meta") as cc:
            outs = make_serve_step(model)(tok, cache)
    mem = MemoryStats(local_bytes(args), local_bytes(outs),
                      float(cc.peak_bytes))
    return cc, mem, opt_name


# the scan steps of the counted runs: the first steps differ (step 0 starts
# from a zero state; DTensor's layouts of the state settle over the next
# ones), so the runs start at step 3, and three runs show the counts grow
# by the same step each
SCAN_STEPS = (3, 4, 5)

DIRECT = "direct: one step, every op counted"


@dataclass
class StepCounts:
    """One rank's counts of a step, as a ``CostCounter`` holds them:
    FLOPs, bytes, the peak of live bytes, FLOPs by op, the collectives
    (``CollectiveOp``s, each with its ``count``) and how they were had.
    Where ``peak_bytes`` is extrapolated, ``peak_bounds`` holds the bounds
    it lies between."""
    flops: int
    bytes: int
    peak_bytes: float
    by_op: Dict[str, int]
    ops: List[CollectiveOp]
    method: str = DIRECT
    peak_bounds: Optional[Tuple[float, float]] = None


def _line(values: List[int], L: int, ns: Tuple[int, ...], what: str) -> int:
    """The count at L steps of a count measured at ``ns`` steps (evenly
    spaced), after checking it grows by the same amount each time."""
    gap = ns[1] - ns[0]
    steps = {b - a for a, b in zip(values, values[1:])}
    if len(steps) != 1 or next(iter(steps)) % gap:
        raise ValueError(f"{what} is not affine in the scan's steps: "
                         f"{values} at {list(ns)} steps")
    count = values[-1] + (L - ns[-1]) * (next(iter(steps)) // gap)
    if count < 0:
        raise ValueError(f"{what} extrapolates below 0: {values}")
    return count


def _extrapolated_ops(runs, ns, L: int) -> List[CollectiveOp]:
    """The collectives of the L-step loop from the runs' ``ops``: each
    collective (its kind, bytes and group) counted along its line."""
    def key(c):
        return (c.kind, c.result_bytes, c.group_size, c.result_elems,
                c.ranks)
    counts, first = [Counter() for _ in runs], {}
    for cnt, ops in zip(counts, runs):
        for c in ops:
            cnt[key(c)] += c.count
            first.setdefault(key(c), c)
    out = []
    for k, c in first.items():
        n = _line([cnt[k] for cnt in counts], L, ns,
                  f"the count of {c.kind}s of {c.result_bytes} bytes")
        if n:
            out.append(CollectiveOp(c.kind, c.result_bytes, c.group_size,
                                    c.result_elems, c.ranks, count=n))
    return out


def count_step(build, shape, mesh, overrides: dict):
    """One rank's counts of a step of the model ``build()`` makes
    (``step_on_mesh``): (``StepCounts``, ``MemoryStats``, optimizer name).

    A step whose plain scans loop over L steps, more than the first of
    ``SCAN_STEPS`` (RWKV6's WKV, Zamba2's SSD: ``dispatch.scan_limit``), is
    run once for each n of them with its loops cut to n steps; each count
    must grow by the same amount from run to run, and is taken to L along
    that line: exact for every count linear in L (FLOPs, bytes, bytes
    written, collectives), as ``tests/test_torch_dryrun.py`` holds it
    against the direct count.  The peak of live bytes is extrapolated from
    the last two runs, an estimate, between two bounds (``peak_bounds``):
    the largest peak measured, and that peak plus every byte the steps not
    run write (a byte alive in the whole loop and not in the cut one was
    written by a step the cut loop skipped).  A step without such a loop
    runs once."""
    ns = SCAN_STEPS
    with dispatch.scan_limit(ns[0]) as cut:
        cc, mem, opt = step_on_mesh(build(), shape, mesh, overrides)
    if not cut:
        return (StepCounts(cc.flops, cc.bytes, float(cc.peak_bytes),
                           dict(cc.by_op), list(cc.ops)), mem, opt)
    if len(cut) != 1:
        raise ValueError(f"scan loops of {sorted(cut)} steps in one step: "
                         f"one length is extrapolated")
    (L,) = cut
    runs = [cc]
    for n in ns[1:]:
        with dispatch.scan_limit(n):
            runs.append(step_on_mesh(build(), shape, mesh, overrides)[0])
    by_op = {k: _line([r.by_op.get(k, 0) for r in runs], L, ns,
                      f"the FLOPs of {k}")
             for k in set().union(*(r.by_op for r in runs))}
    p1, p2 = float(runs[-2].peak_bytes), float(runs[-1].peak_bytes)
    peak = p2 + (L - ns[-1]) * (p2 - p1) / (ns[-1] - ns[-2])
    written = _line([r.written for r in runs], L, ns, "the bytes written")
    upper = p2 + written - runs[-1].written
    counts = StepCounts(
        _line([r.flops for r in runs], L, ns, "the FLOPs"),
        _line([r.bytes for r in runs], L, ns, "the bytes"), peak, by_op,
        _extrapolated_ops([r.ops for r in runs], ns, L),
        method=(f"scan steps: the loops cut to {', '.join(map(str, ns))} "
                f"of {L} steps, each count grown by the same amount a step "
                f"and extrapolated to {L} (exact for counts linear in the "
                f"scan length; the peak an estimate between bounds)"),
        peak_bounds=(max(float(r.peak_bytes) for r in runs), float(upper)))
    mem = MemoryStats(mem.argument_size_in_bytes, mem.output_size_in_bytes,
                      peak)
    return counts, mem, opt


def lower_combo(arch: str, shape_name: str, multi_pod: bool,
                overrides: dict | None = None) -> dict:
    """One (arch, shape, mesh): the roofline terms, the per-rank bytes
    against the card's memory, and what ran."""
    overrides = overrides or {}
    mesh = make_dryrun_mesh(multi_pod=multi_pod)
    chips = 512 if multi_pod else 256
    t0 = time.time()

    def build():
        return built.pop() if built else build_for(
            arch, shape_name, remat=overrides.get("remat", True),
            remat_policy=overrides.get("remat_policy"),
            moe_local_dispatch=overrides.get("moe_local", False))[0]
    built = []
    built.append(build())          # the first run's model, timed here
    cfg, shape = built[0].cfg, INPUT_SHAPES[shape_name]
    t_build = time.time() - t0
    t0 = time.time()
    cc, mem, opt_name = count_step(build, shape, mesh, overrides)
    t_step = time.time() - t0
    roof = analyze(arch, shape_name, _mesh_name(multi_pod), chips,
                   {"flops": cc.flops, "bytes accessed": cc.bytes}, cc.ops,
                   model_flops=model_flops_estimate(cfg, shape),
                   memory_stats=mem, peak_flops=peak_flops_for(cfg.dtype))
    result = roof.to_dict()
    args = mem.argument_size_in_bytes
    per_device = args + mem.temp_size_in_bytes
    # where the peak is extrapolated, only its bounds decide: None where
    # they lie on both sides of the card's memory
    fits = per_device <= HBM_BYTES
    if cc.peak_bounds is not None:
        lo, hi = cc.peak_bounds
        fits = (True if args + hi <= HBM_BYTES
                else False if args + lo > HBM_BYTES else None)
    result.update(
        ok=True, build_s=round(t_build, 1), step_s=round(t_step, 1),
        optimizer=opt_name, n_params=cfg.n_params(),
        n_active=cfg.n_active_params(), overrides=dict(overrides),
        scans="reference (plain PyTorch; the CUDA ops take no meta tensors)",
        per_device_bytes=dict(argument=mem.argument_size_in_bytes,
                              output=mem.output_size_in_bytes,
                              temp=mem.temp_size_in_bytes),
        hbm_bytes=HBM_BYTES, fits=fits,
        flops_by_op=dict(cc.by_op), method=cc.method,
        mesh_layout=_mesh_layout(multi_pod))
    if cc.peak_bounds is not None:
        result["per_device_bytes"].update(
            temp_is="an estimate, extrapolated in the scan's steps; fits "
                    "from its bounds (null: they straddle the card's "
                    "memory)",
            temp_lower_bound=cc.peak_bounds[0],
            temp_upper_bound=cc.peak_bounds[1])
    return result


def _mesh_layout(multi_pod: bool) -> str:
    return ("('pod', 'data') as one dim of 32 ranks × 'model' 16 "
            "(make_dryrun_mesh)" if multi_pod else "'data' 16 × 'model' 16")


_NAMED_OP = (re.compile(r"Operator (\S+) does not have a sharding strategy"),
             re.compile(r"Sharding propagation failed for ([\w.]+)\("))


def failed_op(err: BaseException) -> str | None:
    """The op a DTensor failure names (no sharding rule, or a rule that
    refused the layout), if any."""
    for pat in _NAMED_OP:
        m = pat.search(str(err))
        if m:
            return m.group(1)
    return None


class ComboTimeout(Exception):
    pass


_TIMED_OUT = [False]


def _alarm(signum, frame):
    # DTensor may catch this and raise its own error naming the op it was
    # propagating: the flag says the combination ran out of time
    _TIMED_OUT[0] = True
    raise ComboTimeout()


def run_combo(arch, shape_name, multi_pod, force=False, overrides=None,
              tag="", out_dir: Path = RESULTS_DIR, timeout: int = 0):
    """``lower_combo`` with its result (or its failure, the op at fault
    named where DTensor named one) written to ``out_dir``; ``timeout``
    seconds (0: none) end a combination whose step is still running, as
    a failure naming the DTensor op it was in."""
    mesh_name = _mesh_name(multi_pod)
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"{arch}__{shape_name}__{mesh_name}{tag}.json"
    if out.exists() and not force:
        print(f"[skip] {out.name}")
        return json.loads(out.read_text())
    print(f"[dryrun] {arch} × {shape_name} × {mesh_name} …", flush=True)
    import signal
    if timeout:
        signal.signal(signal.SIGALRM, _alarm)
        signal.alarm(int(timeout))
    _ACTIVE_OP[0], _TIMED_OUT[0] = None, False
    try:
        result = lower_combo(arch, shape_name, multi_pod, overrides)
        signal.alarm(0)
        print(f"  ok: compute={result['compute_s']:.3e}s "
              f"memory={result['memory_s']:.3e}s "
              f"collective={result['collective_s']:.3e}s "
              f"dominant={result['dominant']} per-rank GB "
              f"{(result['argument_bytes'] + result['temp_bytes']) / 1e9:.2f}"
              f" (build {result['build_s']}s step {result['step_s']}s)",
              flush=True)
    except Exception as e:  # noqa: BLE001 — report, don't stop the sweep
        signal.alarm(0)
        op = failed_op(e) or _ACTIVE_OP[0]    # the DTensor op it failed in
        err = f"{type(e).__name__}: {e}"[:2000]
        if _TIMED_OUT[0]:
            err = (f"ComboTimeout: the step ran over {timeout} s, in "
                   f"DTensor's handling of {op}")
        result = dict(ok=False, arch=arch, shape=shape_name, mesh=mesh_name,
                      error=err, op=op,
                      traceback=traceback.format_exc()[-2000:])
        print(f"  FAIL: {result['error'][:200]}", flush=True)
    out.write_text(json.dumps(result, indent=1))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCHS + [None])
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR),
                    help="directory of the JSON results")
    ap.add_argument("--timeout", type=int, default=600,
                    help="seconds a combination may run (0: no limit)")
    args = ap.parse_args(argv)

    if args.mesh == "both":
        return each_mesh(__name__, argv)
    archs = ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = (list(INPUT_SHAPES) if (args.all or args.shape is None)
              else [args.shape])
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            r = run_combo(arch, shape, args.mesh == "multipod",
                          force=args.force, out_dir=Path(args.out),
                          timeout=args.timeout)
            n_fail += 0 if r.get("ok") else 1
    print(f"done; failures: {n_fail}")
    raise SystemExit(1 if n_fail else 0)


def each_mesh(module: str, argv=None):
    """``--mesh both``: the 16 × 16 and the 2 × 16 × 16 runs as two
    processes (a process holds one fake world, of 256 or of 512 ranks);
    exits 1 when either failed."""
    import subprocess
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    i = argv.index("--mesh")
    rcs = [subprocess.call([sys.executable, "-m", module]
                           + argv[:i] + ["--mesh", m] + argv[i + 2:])
           for m in ("single", "multipod")]
    raise SystemExit(1 if any(rcs) else 0)


if __name__ == "__main__":
    main()
