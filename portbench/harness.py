"""One run of one cell: set-up, the measured window of whole campaign calls
back to back, the comparison with the plain reference, and the result.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``; its files are
found by name: ``configs/<config>.json`` (the model, the framework's
keywords, the deployment, the data), ``traffic/<traffic>.json`` (the
entry point, seeds a call, rounds, evaluations, variants, seeds checked a
call), ``checks/<workload>.json`` (the numbers compared and their limits)
and, for each per-layer metric, ``metrics/<metric>.py``.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np

from portbench import compare, trace as tracing, yardstick
from portbench.inputs import Inputs

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, workload: str, here: Path = HERE):
    """The workload's entry and its configuration, traffic and checks."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = load_json(ROOT / conf["file"])
    traffic = load_json(here / "traffic" / f"{cell['traffic']}.json")
    checks = load_json(here / "checks" / f"{workload}.json")
    return cell, cfg, traffic, checks


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that are JAX or its package."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


class Campaigns:
    """The program under test: one call is one campaign (or one sweep) of
    the cell's shapes for a block of run seeds."""

    def __init__(self, cfg: dict, traffic: dict, inputs: Inputs, device):
        from repro_torch.configs.splitme_dnn import DNNConfig
        from repro_torch.core.cost import SystemParams
        from repro_torch.launch import campaign
        self.campaign, self.SystemParams = campaign, SystemParams
        self.cfg, self.traffic, self.device = cfg, traffic, device
        m = cfg["model"]
        self.dnn = DNNConfig(name=cfg["name"], n_features=m["n_features"],
                             n_classes=m["n_classes"],
                             hidden=tuple(m["hidden"]),
                             split_index=m["split_index"],
                             activation=m["activation"])
        self.inputs = inputs
        dep = cfg["deployment"]
        self.deploys = [dict(dep, **v) for v in traffic.get("variants",
                                                             [{}])]
        self.rounds = traffic["rounds"]
        every = traffic.get("eval_every")
        self.do_eval = np.zeros(self.rounds, bool)
        if every:
            self.do_eval[every - 1::every] = True
        self.do_eval[-1] = True

    def system(self, deploy: dict):
        return self.SystemParams(M=deploy["M"], B=deploy["B"],
                                 E_max=deploy["E_max"],
                                 seed=deploy["system_seed"])

    def call(self, seeds: List[int]) -> List:
        """One call of the traffic's entry for ``seeds``: its
        ``CampaignResult``s, one a variant."""
        kw = dict(self.cfg["campaign"], rounds=self.rounds, seeds=seeds,
                  test_data=self.inputs.test, device=self.device,
                  eval_every=self.traffic.get("eval_every"))
        fw = self.cfg["framework"]
        if self.traffic["entry"] == "run_config_sweep":
            return self.campaign.run_config_sweep(
                fw, self.dnn, [self.system(d) for d in self.deploys],
                self.inputs.clients, **kw)
        if self.traffic["entry"] == "run_campaign":
            (dep,) = self.deploys
            return [self.campaign.run_campaign(
                fw, self.dnn, self.system(dep), self.inputs.clients, **kw)]
        raise ValueError(f"unknown entry {self.traffic['entry']!r}")


def summarize(results, seeds, do_eval, sample) -> dict:
    """What the window keeps of one call: its counts, its graphs' and
    rounds' times, each variant's schedule, and host copies of the sampled
    lanes' outputs (``sample``: (variant, seed position) pairs)."""
    import torch
    first = results[0]
    graphs = first.graphs or {}
    kept = []
    for v, pos in sample:
        res = results[v]
        idx = torch.as_tensor([pos], device=res.params[0][0]["w"].device)
        kept.append({
            "variant": v, "seed": seeds[pos],
            "params": tuple([{k: t.index_select(0, idx).cpu()
                              for k, t in layer.items()} for layer in half]
                            for half in res.params),
            "losses": res.losses[pos],
            "accuracy": float(res.accuracy[pos]),
            "acc_rounds": (None if res.accuracy_per_round is None
                           else res.accuracy_per_round[:, pos])})
    return {
        "lanes": sum(len(r.seeds) for r in results),
        "rounds": len(first.schedule.E),
        "capture_s": float(graphs.get("capture_s", 0.0)),
        "shapes": {k: list(v) for k, v in graphs.get("shapes", {}).items()},
        "round_ms": np.asarray(first.round_ms, np.float64),
        "do_eval": do_eval,
        "schedules": [(r.schedule.a, r.schedule.b, r.schedule.E,
                       len(r.seeds)) for r in results],
        "finite": int(sum(np.isfinite(r.accuracy).sum() for r in results)),
        "kept": kept}


def useful_work(cfg: dict, calls: List[dict], n: int, n_test: int):
    counter = yardstick.COUNTERS[cfg["framework"]]
    work = yardstick.Work()
    for c in calls:
        for a, _, E, lanes in c["schedules"]:
            one = counter(cfg, a, E, c["do_eval"], n, n_test)
            for _ in range(lanes):
                work.add(one)
    return work


def live_slots(calls: List[dict]):
    """(slots the schedules call for, slots the round shapes provide):
    lanes × selected clients × executed steps, against lanes × cohort
    bucket × E bucket."""
    live = provided = 0.0
    for c in calls:
        for a, _, E, lanes in c["schedules"]:
            live += lanes * float(np.sum(a.sum(-1) * E))
        for (kb, eb), rounds in c["shapes"].items():
            provided += c["lanes"] * kb * eb * len(rounds)
    return live, provided


def metric_reader(name: str, here: Path = HERE):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}",
        here / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer(bench: dict, workload: str, run) -> Dict[str, dict]:
    out = {}
    for m in bench["per_layer"]:
        if workload not in m.get("workloads", [workload]):
            continue
        value = metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def memory_after_call(release_over: float) -> Dict[str, float]:
    """The card's memory after a call, in GB: allocated, and reserved by
    the caching allocator; where reserved passes ``release_over`` bytes the
    allocator's cached blocks are freed (``released`` 1).  The program
    leaves each call's CUDA-graph pool cached once its graphs are gone, and
    a capture, during which the allocator frees nothing, then runs out of
    card memory (PERF.md, section 7): a script that runs calls back to back
    has to free them, and the window counts the time that takes."""
    import torch
    out = {"allocated": torch.cuda.memory_allocated() / 1e9,
           "reserved": torch.cuda.memory_reserved() / 1e9, "released": 0.0}
    if torch.cuda.memory_reserved() > release_over:
        torch.cuda.empty_cache()
        out["released"] = 1.0
    return out


def graph_pool_gb() -> float:
    """GB that the caching allocator holds in private pools (the CUDA
    graphs')."""
    import torch
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0)) / 1e9


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *,
             t_start: float, device: str = "cuda", chips: int = 1,
             bench: Optional[dict] = None, overrides: Optional[dict] = None,
             log=print) -> Optional[dict]:
    """One run: the result object, or None after printing why there is
    none.  ``overrides`` (tests) updates the configuration's and the
    traffic's keys: {"deployment": {...}, "data": {...}, "traffic":
    {...}}."""
    import torch
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cell, cfg, traffic, checks = find_cell(bench, workload)
    for key, val in (overrides or {}).items():
        (traffic if key == "traffic" else cfg[key]).update(val)
    cuda = device == "cuda"
    inputs = Inputs(seed, cfg["data"], cfg["deployment"]["M"])
    camp = Campaigns(cfg, traffic, inputs, device)
    S, V = traffic["seeds_per_call"], len(camp.deploys)
    camp.call(inputs.seeds(S))               # the warm call: every shape
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    window = tracing.Window(traced) if cuda else None
    release_over = (torch.cuda.get_device_properties(0).total_memory / 2
                    if cuda else 0.0)
    calls = []
    host_s: Dict[str, float] = {}
    # the harness's spans around the program's layers only in a traced
    # run: an untraced window runs the program as it stands
    with tracing.spans(host_s) if traced else contextlib.nullcontext():
        if window:
            window.start()
        t0 = time.perf_counter()
        while True:
            seeds = inputs.seeds(S)
            pick = inputs.sample(V * S, traffic["check_per_call"])
            t_call = time.perf_counter()
            host_s.clear()
            with (torch.profiler.record_function("portbench.call")
                  if traced else contextlib.nullcontext()):
                results = camp.call(seeds)
            calls.append(summarize(results, seeds, camp.do_eval,
                                   [divmod(p, S) for p in pick]))
            calls[-1]["wall_s"] = time.perf_counter() - t_call
            calls[-1]["host_s"] = dict(host_s)
            del results
            calls[-1]["mem_gb"] = (memory_after_call(release_over)
                                   if cuda else {})
            if time.perf_counter() - t0 >= seconds:
                break
        wall = window.stop() if window else time.perf_counter() - t0
    found = forbidden_modules()
    if found:
        log(f"portbench: the process holds {found}", file=sys.stderr)
        return None
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    pools_gb = graph_pool_gb() if cuda else 0.0
    t_read = time.perf_counter()
    trace = window.trace() if window else None
    read_s = time.perf_counter() - t_read
    n = inputs.clients["x"].shape[1]
    n_test = len(inputs.test[1])
    work = useful_work(cfg, calls, n, n_test)
    run = SimpleNamespace(calls=calls, window_s=wall, trace=trace,
                          work=work, cfg=cfg, traffic=traffic,
                          live_slots=live_slots(calls),
                          peak=yardstick.PEAK_OF_PRECISION[cfg["precision"]])
    done = sum(c["lanes"] * c["rounds"] for c in calls)
    attempted = sum(c["lanes"] for c in calls)
    if traced:
        metrics = per_layer(bench, workload, run)
    else:
        metrics = {"seed_rounds_per_s": {"value": done / wall,
                                         "unit": "seed-rounds/s"},
                   "peak_mem_gb": {"value": peak / 1e9, "unit": "GB"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    del camp
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = compare.check(cfg, traffic, checks, inputs, calls, device)
    log(f"portbench: set-up {setup_s:.1f} s, window {wall:.1f} s, trace "
        f"read {read_s:.1f} s, reference {time.perf_counter() - t_ref:.1f} s",
        file=sys.stderr)
    bad = [k for k, v in numbers.items()
           if not (math.isfinite(v["value"]) and v["value"] <= v["limit"])]
    # lanes whose accuracy came back non-finite, and numbers over their
    # limits
    failed = attempted - sum(c["finite"] for c in calls) + len(bad)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    if cuda:
        dev["power"] = power_limit()
    out = {"correct": not bad and failed == 0, "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"], dev["window_s"] = trace.busy_s(), trace.window_s()
        out["breakdown"] = {
            "device_ops": tracing.top_device_ops(trace.device),
            "idle_gaps": [[k, v] for k, v in sorted(
                trace.idle_by_label.items(), key=lambda kv: -kv[1])[:10]]}
    out["calls"] = {"wall_s": [c["wall_s"] for c in calls],
                    "capture_s": [c["capture_s"] for c in calls],
                    "mem_gb": {k: [c["mem_gb"][k] for c in calls]
                               for k in calls[0]["mem_gb"]},
                    "graph_pools_gb_at_close": pools_gb,
                    "host_s": {k: [c["host_s"].get(k, 0.0) for c in calls]
                               for k in calls[0]["host_s"]}}
    out["checks"] = numbers
    for k, v in numbers.items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}",
            file=sys.stderr)
    return out

