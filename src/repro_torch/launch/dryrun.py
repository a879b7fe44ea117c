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
(``policy="reference"``): the CUDA ops take no meta tensors.
An op that DTensor has no sharding rule for fails its combination
(``ok: false`` with the op's name); nothing is quietly replicated.

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
from pathlib import Path

import torch

from repro_torch.configs.base import INPUT_SHAPES, list_configs
from repro_torch.launch.mesh import HBM_BYTES, make_production_mesh
from repro_torch.launch.specs import (abstract_cache, batch_specs, build_for,
                                      META)
from repro_torch.roofline.analysis import (CollectiveTrace, CostCounter,
                                           MemoryStats, analyze,
                                           model_flops_estimate,
                                           peak_flops_for)
from repro_torch.runtime.steps import (default_optimizer, make_prefill_step,
                                       make_serve_step, make_train_step)
from repro_torch.sharding import partition

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
    """The optimizer state with every DTensor laid out by the param rules
    on its own shape and path (the reference's ``params_shardings`` over
    the optimizer's tree)."""
    from torch.distributed.tensor import DTensor
    if isinstance(state, DTensor):
        spec = partition.param_spec(path, tuple(state.shape), mesh,
                                    fsdp=fsdp,
                                    expert_parallel=expert_parallel)
        return state.redistribute(mesh, partition.placements(spec, mesh))
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


def lower_combo(arch: str, shape_name: str, multi_pod: bool,
                overrides: dict | None = None) -> dict:
    """One (arch, shape, mesh): the roofline terms, the per-rank bytes
    against the card's memory, and what ran."""
    overrides = overrides or {}
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = 512 if multi_pod else 256
    t0 = time.time()
    model, shape = build_for(arch, shape_name,
                             remat=overrides.get("remat", True),
                             remat_policy=overrides.get("remat_policy"),
                             moe_local_dispatch=overrides.get("moe_local",
                                                              False))
    cfg = model.cfg
    t_build = time.time() - t0
    t0 = time.time()
    cc, mem, opt_name = step_on_mesh(model, shape, mesh, overrides)
    t_step = time.time() - t0
    roof = analyze(arch, shape_name, _mesh_name(multi_pod), chips,
                   {"flops": cc.flops, "bytes accessed": cc.bytes}, cc.ops,
                   model_flops=model_flops_estimate(cfg, shape),
                   memory_stats=mem, peak_flops=peak_flops_for(cfg.dtype))
    result = roof.to_dict()
    per_device = mem.argument_size_in_bytes + mem.temp_size_in_bytes
    result.update(
        ok=True, build_s=round(t_build, 1), step_s=round(t_step, 1),
        optimizer=opt_name, n_params=cfg.n_params(),
        n_active=cfg.n_active_params(), overrides=dict(overrides),
        scans="reference (plain PyTorch; the CUDA ops take no meta tensors)",
        per_device_bytes=dict(argument=mem.argument_size_in_bytes,
                              output=mem.output_size_in_bytes,
                              temp=mem.temp_size_in_bytes),
        hbm_bytes=HBM_BYTES, fits=bool(per_device <= HBM_BYTES),
        flops_by_op=dict(cc.by_op))
    return result


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
