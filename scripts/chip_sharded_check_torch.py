#!/usr/bin/env python3
"""The port's sharded rounds and sharded campaign on several ranks, against
the single-device port.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        scripts/chip_sharded_check_torch.py [--out FILE]
    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        scripts/chip_sharded_check_torch.py --backend gloo --quick

The first form needs one card a rank (NCCL; four H100s on one host; with
one rank it runs the 1-shard cases on one card).  Every rank makes the same calls; rank 0
prints and writes the JSON result (``--out``, and as the last line):

1. the six frameworks' sharded round (DNN10 at full width, M = 48 clients
   of 96 samples, a random mask, E 5 of 6 steps) against the single-card
   round on the same draws, at 1e-5, with one all-reduce a round;
2. the paper's campaign (``chip_smoke.py`` phase 3b: SplitMe, DNN10,
   ``SystemParams()``, 96 samples a client, 30 rounds, seeds 0-3, Step 4
   every 10 rounds and after the last, at γ 10 so that accuracy compares)
   on 4 shards at ``SystemParams(M=100)`` (a change of M: 50 does not
   divide by 4; ``oran.generate(n_per_class=4000)``, whose 9600 training
   samples fill the 100 clients), in f32 and on the bf16 and int8 wires,
   then at M = 50 on 2 shards (ranks 0 and 1 in a second process group):
   graphed (strict transfers, one host transfer a rank) against the same
   round bodies uncaptured, bit for bit; against the single-card gathered
   campaign at 1e-5 (params and losses) and accuracy within one test
   sample; every rank the same params; the steady round's ms beside the
   single-card campaign's, and under the profiler its device operations,
   NCCL kernels, their device time and the bytes of the bundle a round;
   Step 4's all-reduces an evaluation.

``--backend gloo --quick`` runs every rank on card 0 over gloo (NCCL
refuses two ranks on one card), so its rounds are not captured: the six
rounds of 1. and a 3-round campaign at M = 48 against the single-device
port at 1e-5 (``chip_smoke.py`` phase 3k).  ``--device cpu`` runs the same
on CPU processes (a rehearsal).
"""
import argparse
import json
import os
import statistics
import sys
import time
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from repro_torch.configs.splitme_dnn import DNN10  # noqa: E402
from repro_torch.core import engine, quantcomm  # noqa: E402
from repro_torch.core.cost import SystemParams  # noqa: E402
from repro_torch.data import oran  # noqa: E402
from repro_torch.launch import campaign, mesh as meshes  # noqa: E402

TOL = 1e-5                      # f32 params and losses (the parity bound)
# the wire formats' bound (tests/test_torch_quantcomm.py's WIRE_TOL) over
# the first rounds, as chip_smoke.py phase 3d holds chaotic trajectories.
# The reference parts as far: on the CPU its 4-device mesh against its
# single device, this campaign at M 100, params after 1 / 3 / 10 / 30
# rounds, bf16 0 / 0 / 4.1e-2 / 4.4e-2 and int8 1.7e-2 / 3.2e-2 / 3.0e-2 /
# 4.0e-2 (the port's 4 gloo ranks: 0 / 0 / 3.1e-2 / 4.4e-2 and 2.2e-2 /
# 2.2e-2 / 2.6e-2 / 3.1e-2; tests/torch_sharded_check.py wire)
WIRE_TOL = {"bf16": 2e-2, "int8": 6e-2}
WIRE_CMP_ROUNDS = 3
SINGLE_F32 = {}                 # M: the single-card f32 campaign (rank 0)
ACC_SAMPLES = 1                 # accuracy at γ 10, in test samples
ROUND_M, ROUND_N, ROUND_EMAX, ROUND_E = 48, 96, 6, 5
QUICK_ROUNDS, QUICK_SEEDS = 3, (0, 1, 2, 3)
ROUNDS, SEEDS, EVAL_EVERY, GAMMA = 30, (0, 1, 2, 3), 10, 10.0


T0 = time.perf_counter()


def log(msg: str) -> None:
    if dist.get_rank() == 0:
        print(f"[{time.perf_counter() - T0:.1f} s] {msg}", flush=True)


def _comm_device() -> torch.device:
    """Where this process group's checks reduce: the card for NCCL, the
    host for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def same_on_every_rank(tree) -> bool:
    """Every rank holds the same values, bit for bit (max = min over the
    ranks, element by element; NaN where NaN)."""
    flat = torch.cat([torch.as_tensor(l).reshape(-1).float().to(
        _comm_device()) for l in quantcomm.tree_leaves(tree)])
    flat = torch.cat([torch.nan_to_num(flat, nan=0.0), flat.isnan().float()])
    hi, lo = flat.clone(), flat.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return bool(torch.equal(hi, lo))


def check(cond: bool, msg: str) -> None:
    """Fail on every rank when ``cond`` fails on any."""
    t = torch.tensor([0.0 if cond else 1.0], device=_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    if t.item():
        where = "this rank" if not cond else "another rank"
        raise SystemExit(f"chip_sharded_check: FAILED on {where} (rank "
                         f"{dist.get_rank()}): {msg}")


def tree_diff(a, b) -> float:
    return max(float((x.float().cpu() - y.float().cpu()).abs().max())
               for x, y in zip(quantcomm.tree_leaves(a),
                               quantcomm.tree_leaves(b)))


def rounds_check(mesh, dev) -> dict:
    """1.: the six frameworks' sharded round against the single-device
    round on this rank's device."""
    X, y = oran.generate(n_per_class=2000, seed=0)
    (Xtr, ytr), _ = oran.train_test_split(X, y)
    cd = oran.partition_non_iid(Xtr, ytr, ROUND_M,
                                samples_per_client=ROUND_N, seed=0)
    x = torch.tensor(cd["x"], device=dev)
    yy = torch.tensor(cd["y"], device=dev).long()
    g = torch.Generator().manual_seed(0)
    a = (torch.rand(ROUND_M, generator=g) < 0.5).float()
    a[0] = 1.0
    a = a.to(dev)
    out = {}
    for fw in engine.framework_names():
        spec = engine.make_spec(fw, DNN10, masked_loss_metric=True,
                                device=dev)
        params = spec.init_fn(torch.Generator().manual_seed(3), dev)
        idx = torch.randint(0, ROUND_N, (len(spec.phases), ROUND_M,
                                         ROUND_EMAX, spec.batch_size),
                            generator=g).to(dev)
        single = engine.build_round_fn(spec, DNN10, x, yy, e_max=ROUND_EMAX)
        sharded = engine.build_sharded_round_fn(
            spec, DNN10, mesh, n_clients=ROUND_M, e_max=ROUND_EMAX)
        before = engine.ALL_REDUCES
        p2, l2, _ = sharded(params, x, yy, a, ROUND_E, idx)
        n_ar = engine.ALL_REDUCES - before
        p1, l1, _ = single(params, a, ROUND_E, idx)
        perr = tree_diff(p1, p2)
        lerr = max(abs(float(u) - float(v)) for u, v in zip(l1, l2))
        same = same_on_every_rank(p2)
        log(f"round {fw}: sharded ({engine.n_client_shards(mesh)} shards) vs "
            f"single device: params {perr:.3e}, losses {lerr:.3e} (tol "
            f"{TOL}); all-reduces {n_ar}; the same on every rank {same}")
        check(perr <= TOL and lerr <= TOL and n_ar == 1 and same,
              f"{fw}: sharded round disagrees")
        out[fw] = {"param_diff": perr, "loss_diff": lerr}
    return out


def bundle_elements(spec, params) -> int:
    """Elements of one round's bundle: the seeds' numerators, |A_t| and
    each phase's loss sums."""
    S = params[0][0]["w"].shape[0]
    return quantcomm.n_elements(engine.trained_params(spec, params)) \
        + 1 + S * len(spec.phases)


def kernel_window(evts, rounds: int) -> dict:
    """Per round of a profiled window: device ms, operations, and the
    all-reduce's kernels (count, device µs), with their names."""
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    n, us, names = smoke.nccl_window(evts, rounds)
    return {"busy_ms": sum(dev_us(e) for e in evts) / 1e3 / rounds,
            "ops": sum(e.count for e in evts if dev_us(e) > 0) / rounds,
            "nccl_kernels": n, "nccl_us": us, "nccl_names": names}


def aligned_window(window):
    """A ``_round_hook`` with the profiler open over the rounds of
    ``window`` on every rank, the ranks aligned by a barrier just outside
    both edges (so that no barrier kernel falls inside); returns (hook,
    result dict: "events", "kernels" (the raw device events), "wall_ms")."""
    from torch.profiler import ProfilerActivity, profile
    got = {}

    def hook(r):
        if r == window[0] - 1:
            torch.cuda.synchronize()
            dist.barrier()
            torch.cuda.synchronize()
            got["prof"] = profile(activities=[ProfilerActivity.CUDA])
            got["prof"].start()
            got["t0"] = time.perf_counter()
        elif r == window[-1]:
            torch.cuda.synchronize()
            got["wall_ms"] = (time.perf_counter() - got["t0"]) * 1e3
            prof = got.pop("prof")
            prof.stop()
            got["events"] = prof.key_averages()
            got["kernels"] = list(prof.events())
            dist.barrier()
    return hook, got


def nccl_median_us(kernels) -> float:
    """The median device µs of one all-reduce kernel in a window (the
    first round's absorbs the ranks' skew at the window's start)."""
    us = [e.time_range.elapsed_us() for e in kernels
          if any(k in e.name.lower() for k in smoke.NCCL_KERNELS)
          and str(getattr(e, "device_type", "")).endswith("CUDA")]
    return float(statistics.median(us)) if us else float("nan")


def all_reduce_us(n: int, dtype, reps: int = 50) -> float:
    """One all-reduce of ``n`` elements of ``dtype`` (a round's bundle),
    captured in a CUDA graph and replayed ``reps`` times after a barrier:
    µs a call by CUDA events (every rank's; the slowest rank's waits)."""
    buf = torch.ones(n, dtype=dtype, device="cuda")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        dist.all_reduce(buf)                 # starts the communicator
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        for _ in range(reps):
            dist.all_reduce(buf)
        graph.capture_end()
    torch.cuda.synchronize()
    dist.barrier()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with torch.cuda.stream(stream):
        graph.replay()                       # warm
        start.record(stream)
        graph.replay()
        end.record(stream)
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def campaign_check(label, mesh, dev, sp, clients, test, quant=None,
                   rounds=ROUNDS, seeds=SEEDS, graphs=True,
                   profile=True) -> dict:
    """2.: one configuration's sharded campaign, graphed against uncaptured,
    against the single-device campaign (rank 0), timed and profiled.  f32
    is held to the single-device campaign at 1e-5 over all rounds (and
    accuracy within ACC_SAMPLES); a wire format at ``WIRE_TOL`` over the
    first ``WIRE_CMP_ROUNDS`` rounds' losses, with the whole campaign's
    distance printed beside the wire's own distance from the f32 campaign
    (N shards round or quantize N partial sums where one device rounds
    the whole sum: the trajectories part, ``PERF.md`` §6)."""
    kw = dict(rounds=rounds, seeds=seeds, test_data=test, device=dev,
              eval_every=EVAL_EVERY, eval_gamma=GAMMA, quant=quant)
    run = lambda **more: campaign.run_campaign(  # noqa: E731
        "splitme", DNN10, sp, clients, **kw, **more)
    out = {"shards": engine.n_client_shards(mesh), "M": int(sp.M),
           "quant": quant or "none"}
    log(f"{label}: start")
    h0 = campaign.HOST_TRANSFERS
    res = run(mesh=mesh, strict_transfers=graphs and dev.type == "cuda",
              _graphs=graphs)
    check(campaign.HOST_TRANSFERS - h0 == 1,
          f"{label}: {campaign.HOST_TRANSFERS - h0} host transfers")
    check(same_on_every_rank((res.params, res.losses,
                              res.accuracy_per_round)),
          f"{label}: ranks disagree")
    if graphs:
        a0 = engine.ALL_REDUCES
        plain = run(mesh=mesh, _graphs=False)
        n_ar = engine.ALL_REDUCES - a0
        perr, lerr = smoke.campaign_max_diff(res, plain)
        log(f"{label}: graphed vs uncaptured: params {perr:.3e}, losses "
            f"{lerr:.3e} (bitwise expected); {res.graphs['graphs']} graphs, "
            f"capture {res.graphs['capture_s']:.3f} s")
        check(perr == 0.0 and lerr == 0.0,
              f"{label}: graphed and uncaptured campaigns differ")
        evals = sum(1 for r in range(rounds)
                    if (r + 1) % EVAL_EVERY == 0 or r == rounds - 1)
        out["step4_all_reduces_per_eval"] = (n_ar - rounds) / evals
        check(n_ar == rounds + 8 * evals,
              f"{label}: {n_ar} all-reduces, want {rounds} + 8 a Step 4")
    good = True
    if dist.get_rank() == 0:
        single = run()
        perr, lerr = smoke.campaign_max_diff(res, single)
        a, b = res.accuracy_per_round, single.accuracy_per_round
        ok = np.isfinite(b)
        aerr = float(np.abs(a[ok] - b[ok]).max()) * len(test[1])
        out.update(param_diff=perr, loss_diff=lerr, acc_samples=aerr)
        if quant is None:
            SINGLE_F32[int(sp.M)] = single
            log(f"{label}: sharded vs single-card campaign: params "
                f"{perr:.3e}, losses {lerr:.3e} (tol {TOL}); accuracy "
                f"{aerr:.2f} test samples apart (tol {ACC_SAMPLES})")
            good = perr <= TOL and lerr <= TOL and aerr <= ACC_SAMPLES + 1e-6
        else:
            first = slice(0, WIRE_CMP_ROUNDS)
            l_first = float(np.abs(res.losses[:, first]
                                   - single.losses[:, first]).max())
            f32 = SINGLE_F32.get(int(sp.M))
            wire = smoke.campaign_max_diff(single, f32)[0] \
                if f32 is not None else float("nan")
            shard = smoke.campaign_max_diff(res, f32)[0] \
                if f32 is not None else float("nan")
            out.update(loss_diff_first=l_first, single_vs_f32=wire,
                       sharded_vs_f32=shard)
            log(f"{label}: sharded vs single-card campaign: losses of the "
                f"first {WIRE_CMP_ROUNDS} rounds {l_first:.3e} (tol "
                f"{WIRE_TOL[quant]}); the whole {rounds} rounds (not "
                f"checked): params {perr:.3e}, losses {lerr:.3e}, accuracy "
                f"{aerr:.2f} test samples; from the f32 campaign: the "
                f"single card's {wire:.3e}, the sharded {shard:.3e}")
            good = l_first <= WIRE_TOL[quant]
        if graphs and dev.type == "cuda":
            out["single_round_ms"] = steady_ms(single)
    check(good, f"{label}: sharded and single-card campaigns disagree")
    if graphs and dev.type == "cuda":
        out["round_ms"] = steady_ms(res)
        if profile:
            _, window = smoke.steady_window(res.graphs["shapes"], rounds,
                                            EVAL_EVERY)
            hook, got = aligned_window(window)
            run(mesh=mesh, _round_hook=hook)
            k = kernel_window(got["events"], len(window))
            n = bundle_elements(engine.make_spec("splitme", DNN10,
                                                 device="cpu"), res.params)
            wire = torch.bfloat16 if quant == "bf16" else torch.float32
            out.update(k, wall_ms=got["wall_ms"] / len(window),
                       nccl_median_us=nccl_median_us(got["kernels"]),
                       bundle_bytes=n * (2 if quant == "bf16" else 4),
                       all_reduce_us=(all_reduce_us(n, wire)
                                      if dist.get_world_size() > 1
                                      else None))
            out["idle_share"] = 1 - k["busy_ms"] / out["wall_ms"]
            log(f"{label}: steady round {out['round_ms']:.3f} ms (single "
                f"card {out.get('single_round_ms', float('nan')):.3f}); "
                f"profiled rounds {window[0]}-{window[-1]}: wall "
                f"{out['wall_ms']:.3f} ms, busy {k['busy_ms']:.3f} ms, "
                f"{k['ops']:.1f} operations, NCCL kernels "
                f"{k['nccl_kernels']:.2f} a round ({k['nccl_us']:.2f} us a "
                f"round in all, median kernel {out['nccl_median_us']:.2f} "
                f"us; {k['nccl_names']}), bundle {out['bundle_bytes']} "
                f"bytes a round, its all-reduce alone "
                f"{out['all_reduce_us']} us (graph of 50, events)")
            want = 1.0 if dist.get_world_size() > 1 else 0.0
            check(k["nccl_kernels"] == want,
                  f"{label}: {k['nccl_kernels']} NCCL kernels a round, "
                  f"want {want}")
    return out


def steady_ms(res) -> float:
    """The median ms of the most frequent round shape's rounds after its
    first (captured) one, as phase 3b reads them."""
    shapes = res.graphs["shapes"]
    rounds = max(shapes.values(), key=len)[1:]
    return float(statistics.median(res.round_ms[rounds]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--rounds", type=int, default=ROUNDS,
                    help="rounds of the campaigns of 2. (a rehearsal's cut)")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_sharded_check: no CUDA device is available",
              file=sys.stderr)
        return 2
    if args.backend == "nccl" and args.device != "cuda":
        print("chip_sharded_check: NCCL needs --device cuda", file=sys.stderr)
        return 2
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ.get("WORLD_SIZE", "1"))))
    dist.init_process_group(args.backend, timeout=timedelta(seconds=600))
    rank, world = dist.get_rank(), dist.get_world_size()
    t0 = time.perf_counter()
    if args.backend == "nccl":
        mesh = meshes.make_client_mesh(world)
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        mesh = meshes.make_client_mesh(world, device_type="cpu")
        dev = torch.device(args.device, 0) if args.device == "cuda" \
            else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                       "--format=csv,noheader").read().strip().splitlines()
        log(f"ranks {world}, backend {args.backend}, device "
            f"{torch.cuda.get_device_name(dev)}, cards "
            f"{torch.cuda.device_count()} | nvidia-smi: {smi} | torch "
            f"{torch.__version__}")
    result = {"ranks": world, "backend": args.backend,
              "rounds": rounds_check(mesh, dev)}
    X, y = oran.generate(n_per_class=2000, seed=0)
    (Xtr, ytr), test = oran.train_test_split(X, y)
    graphs = args.backend == "nccl"
    if args.quick:
        sp = SystemParams(M=ROUND_M)
        clients = oran.partition_non_iid(Xtr, ytr, ROUND_M,
                                         samples_per_client=96, seed=0)
        result["campaign"] = campaign_check(
            f"campaign M {ROUND_M}", mesh, dev, sp, clients, test,
            rounds=QUICK_ROUNDS, seeds=QUICK_SEEDS, graphs=graphs)
    else:
        result["campaigns"] = {}
        if world % 4 == 0 or world == 1:
            X4, y4 = oran.generate(n_per_class=4000, seed=0)
            (Xtr4, ytr4), test4 = oran.train_test_split(X4, y4)
            sp = SystemParams(M=100)
            clients = oran.partition_non_iid(Xtr4, ytr4, 100,
                                             samples_per_client=96, seed=0)
            for quant in (None, "bf16", "int8"):
                label = f"campaign M 100, {world} shards, {quant or 'f32'}"
                result["campaigns"][label] = campaign_check(
                    label, mesh, dev, sp, clients, test4, quant=quant,
                    rounds=args.rounds, graphs=graphs)
        # 3b exactly: M 50 on 2 shards, ranks 0 and 1 in a group of their own
        if world >= 2:
            dist.barrier()
            dist.destroy_process_group()
            if rank >= 2:
                return 0
            # a store of its own: under torch.distributed.run a tcp://
            # init would join the launcher's store, which has no server there
            store = dist.TCPStore(
                "localhost", int(os.environ.get("MASTER_PORT", "29500")) + 1,
                2, rank == 0, timeout=timedelta(seconds=600))
            dist.init_process_group(args.backend, store=store, world_size=2,
                                    rank=rank,
                                    timeout=timedelta(seconds=600))
            mesh = meshes.make_client_mesh(
                2, device_type=None if graphs else "cpu")
        sp = SystemParams()
        clients = oran.partition_non_iid(Xtr, ytr, sp.M,
                                         samples_per_client=96, seed=0)
        label = f"campaign 3b (M 50), {engine.n_client_shards(mesh)} shards"
        result["campaigns"][label] = campaign_check(
            label, mesh, dev, sp, clients, test, rounds=args.rounds,
            graphs=graphs)
    result["seconds"] = time.perf_counter() - t0
    if dist.get_rank() == 0:
        line = json.dumps({"sharded": result})
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(line + "\n")
        print(line, flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
