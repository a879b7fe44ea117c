#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card and the CUDA
toolkit.  It imports neither jax nor the JAX package, and every phase's
failure ends the run with a non-zero exit code:

1. device: the card's name and power limit (nvidia-smi), and the build of
   the CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. kernels vs their plain PyTorch versions on the card, at the main-path
   shapes and at ragged ones, with times (CUDA events and the profiler),
   bounds, and the plain version's and (for the Gram) one library call's
   times: ``kl_mutual``'s forward and backward kernels (with the wrappers'
   host µs a call, and the plain backward's device operations), their
   mixed-dtype entries (bf16 x or y; a bf16 gradient within one bf16 unit
   in the last place) and
   ``ridge_gram`` (the SplitMe path: the 16 single
   Grams of one Step-4 evaluation, then its 8 ``gram_pair`` launches timed,
   with the wrapper's host µs a call and the matmul yardstick's events and
   device time), then ``rwkv6_wkv`` and ``mamba2_scan`` (the serving path)
   at b 4, L 2048, at a ragged length at full width, at small and odd
   shapes, with a long memory (decay 0.999) and with exact 0 and 1 decays;
   the SSD bound counts the least operations of the sequential and the
   chunked form, and the SSD kernel is also timed at one, two and three of
   its blocks on every SM;
2b. the ``flash_attention`` op at the attention widths of Zamba2-2.7B and
   Qwen3-14B (and of ``benchmarks/bench_kernels.py``): each full-width case
   once through the op with the launch counters set to 0 just before and
   read just after (its main path: no model calls it); bf16 cases must
   launch the bf16 tensor-core kernel and f32 cases the 3xTF32 kernel, by
   their per-route counters, those with q or k and v off 16-byte alignment
   too, with copies as wide as the offsets allow.  Then the kernels
   against the plain version at those and at ragged shapes in f32 and bf16
   (and the sliding-window case once more in f32, with V or with q and k of
   one sign, and with odd head sizes and inputs off alignment), per element
   within 2e-4 in f32 and one bf16 unit in the last place in bf16, with
   times, bounds and the times of the plain version and of
   ``scaled_dot_product_attention`` as a yardstick (on aligned copies of
   inputs off alignment);
3. the SplitMe path: ``SplitMeTrainer`` on DNN10 at full width, M = 50
   clients of 96 samples, 5 rounds with the Step-4 evaluation on the last,
   then ``finalize()`` + ``evaluate()``; the kernels' launch counters must
   show that every KL loss, every KL gradient of a training step and every
   Gram pair went through the kernels;
   one more round under the profiler gives the device's busy time and idle
   share;
3b. the SplitMe campaign: ``run_campaign("splitme", ...)`` over the
   paper's 30 rounds for 4 seeds in one program, Step 4 every 10 rounds
   and after the last, one CUDA graph per round shape and one for the
   evaluation, with ``strict_transfers`` (sync debug mode "error") held
   through the device phase and exactly one host transfer; its round
   shapes, graphs and capture seconds; ms per round graphed and eager
   (``scan=False``), medians of campaigns timed in turns; graphed
   against eager (bitwise expected); steady rounds and one evaluating
   round under the profiler (idle share, device operations, launches a
   round of the KL and Gram kernels by name: graph replays do not move
   the wrappers' counters); the whole 30-round campaign graphed (capture
   and evaluations included) against eager with its post-hoc evaluation;
   and the same campaign graphed on the card against the CPU: params,
   losses and per-round accuracy (at a well-conditioned gamma);
3c. precision and wire formats: the campaign of 3b under
   ``policy="kernel_bf16"`` (bf16 on the card), ``quant="int8"`` and
   ``quant="bf16"``: each graphed (strict transfers) against eager bit for
   bit with the error-feedback state, against the CPU over all rounds and
   seeds, the launch counters of the kernel_bf16 campaign (every mixed KL
   entry of its path launched), and a steady round's ms, the whole
   campaign, the idle share and the operations a round;
3d. the paper's framework comparison: the five baselines (FedAvg, SFL,
   O-RANFed, FedORA, EcoFL) as ``examples/oran_splitfl_campaign.py --seeds 4
   --baselines`` runs them, 30 of its 60 rounds of 4 seeds each: graphed
   (strict transfers, one host transfer) against eager bit for bit, against
   the CPU over the first rounds (the trajectories part by chaos later:
   FedAvg's whole-campaign difference is printed beside the card's own
   under a one-ulp change of the initial weights), the steady round graphed
   and eager, the whole campaign, the idle share and operations a round, final
   accuracy, comm, sim time and cost; FedAvg under the bf16 policy and the
   int8 wire too, and the bf16 policy against the CPU's three-round rule
   beside what a one-ulp change of the initial weights does; the KL and
   Gram counters stay 0 through all of it;
3e. a time-varying RAN: SplitMe under ``straggler:0.4`` (30 rounds) and
   FedORA under ``fading`` (30 rounds), 4 seeds each, graphed against eager
   bit for bit and against the CPU, with their round shapes, graphs,
   capture seconds and whole campaigns;
3f. fault channels and guards: the campaign of 3b under ``faults:0.3``
   (guards armed by the faults, strict transfers, one host transfer),
   its graphs against the same round bodies run uncaptured bit for bit
   (params, NaN crash rows, guard flags), rollbacks, crash rows and finite
   params checked, its flags against the CPU's exactly and params and
   losses by 3e's gates before the first wire flip, its steady round's
   ms, operations, idle share and in-graph KL and Gram launches beside
   3b's; then its int8 wire (graphed against uncaptured with the EF
   state), the guards-off control (params go non-finite), FedAvg's norm
   clip against a wire flip and its quorum hold;
3g. checkpoints: 3f's campaign saved every 10 rounds, aborted by its
   checkpoint hook at round 20 and resumed, bit for bit against 3f's run,
   with the ms of each save and of the restore; then
   ``scripts/crash_resume_check_torch.py --device cuda`` (SIGKILL and
   resume) as a subprocess;
3h. population mode: ``run_population_campaign("splitme", ...)`` over 10^6
   virtual near-RT-RICs, a cohort of 32 sampled a round under
   ``churn:0.5``, 30 rounds of 4 seeds (the README's population command at
   the example's sizes): strict transfers and one host transfer, graphed
   against uncaptured bit for bit, against the CPU by 3b's gates, its round
   shapes, graphs, capture seconds, steady round (ms, operations, idle
   share, in-graph KL and Gram launches) and whole campaign; the host
   plan's seconds and tracemalloc peak; the device's peak memory at 10^4
   and 10^6 clients (within 1.25x); the full-population cohort of 50
   against ``run_campaign`` on the same rows and shards; the int8 wire
   graphed against uncaptured; checkpoints, an abort and a bitwise resume;
3i. the config sweep: ``run_config_sweep("splitme", ...)`` over the
   bandwidth B of Table III halved, kept and doubled twice (4 variants x
   seeds 0-3 = 16 (variant, seed) pairs, 30 rounds, Step 4 every 10 rounds
   and after the last): strict transfers and one host transfer for the
   sweep, its round shapes and graphs, graphed against the same bodies
   uncaptured bit for bit, the steady round's ms, operations, idle share
   and in-graph KL and Gram launches, the whole sweep beside its four
   ``vmap_configs=False`` campaigns, the device peak; the sweep against
   its per-variant campaigns on the default draws and on draws both read
   alike, and against the CPU over its first rounds by 3d's gates;
3k. the sharded campaign: the campaign of 3b under a 1-shard NCCL mesh
   (``run_campaign(mesh=)``, a process group of this process): graphed
   against the same round bodies uncaptured bit for bit and against 3b's
   gathered campaign, its one all-reduce a round and one a server layer an
   evaluation (the counter uncaptured; the all-reduce's kernel and the KL
   and Gram launches inside the graphs by the profiler), its steady round's
   ms and operations beside 3b's; then a job of 4 ranks
   on this one card over gloo, uncaptured
   (``scripts/chip_sharded_check_torch.py --backend gloo --quick``): the six
   frameworks' sharded round and a short sharded campaign against the
   single-device port (it runs after 3i, before 3j);
3j. the port's entry points: the README's four command lines through
   ``repro_torch.examples.oran_splitfl_campaign.main(argv)`` on the card,
   in this process (the resumable line twice: the rerun resumes; the
   serial line's five baseline trainers at 5 of their 60 rounds), each
   printing the reference's lines;
3l. the paper's result at its full horizon: the six frameworks as the
   example's ``--seeds --baselines`` line runs them (SplitMe 30 rounds, the
   baselines 60) over 32 seeds, one graphed campaign each on the port's own
   draws, each framework's median, minimum and count below 0.70 printed
   and its finals held by rank against the reference's in
   ``tests/data/horizon_reference.json`` (two-sided Mann-Whitney p, and
   a Fisher exact p of the counts below 0.70, each at least 0.01; no JAX
   here: the file holds the numbers), the KL and Gram
   launches counted in SplitMe's and at 0 in the baselines'; then the bf16
   policy's campaign against itself from every initial weight one ulp up,
   its spread round by round beside phase 3c's card-vs-CPU difference;
4. the serving path, for RWKV6-1.6B and Zamba2-2.7B at full width and
   depth with weights from a seeded generator: in f32, the kernel-preset
   prefill against a ``decode_step`` replay of the same prompts and against
   the ``reference`` preset, with one scan launch per layer; then the
   served bf16 model: prefill through ``make_prefill_step`` at 4 × 2048 and
   ``repro_torch.serve``'s replay + greedy decode of 4 requests, with the
   launch counters set to 0 just before and read just after, and a
   profiled prefill and decode.  Then the decoder and enc-dec families,
   which run no kernel: Qwen3-14B, Granite-MoE-3B-A800M, InternVL2-1B
   (with its 256-patch prefix) and Seamless-M4T-medium (512 frames of
   memory) at full width and depth, DeepSeek-V3 at its published widths
   with one layer and the MTP block (prefilled 1 × 2048): the same
   prefill and serving runs in bf16 with every kernel counter held at 0,
   the MoE capacity drops, MLA's cache bytes a token, a profiled prefill
   and decode (the enc-dec's from its encoder's memory), and in f32 at
   full width the prefill against a decode replay (Qwen3-14B, InternVL2
   on tokens, Seamless with one memory, Granite-MoE at capacity_factor
   n_experts / top_k);
5. the card against the CPU: the same 2 SplitMe rounds from one seed on
   both, and every zoo config reduced: forward (and MTP) logits and 8
   decode steps;
6. zoo training (6a-6e): the README's ``lm_pretrain`` line, SmolLM-135M
   f32 at 4 × 2048 with and without remat, Granite-MoE-3B-A800M, the
   reduced configs card against the CPU, and the DNN's gelu and squared
   ReLU;
7. the zoo's tooling, each part a process of its own (a process group is
   process-global): (a) ``repro_torch.launch.fl_dryrun`` at the
   reference's settings (512 clients, 64 samples, E 1 and 10) on the fake
   16 × 16 and 2 × 16 × 16 worlds with the round's tensors on the card,
   checked against the paper's claim (SplitMe one all-reduce a round,
   its bytes constant in E; SFL 2E boundary permutes; Step 4 one
   all-reduce a server layer; the bf16 and int8 wires half and a quarter
   the bits) with the KL pair and the Gram launched; (b) the roofline
   terms, counted on meta tensors on a one-rank mesh, of the steps that
   6b and 4 time, beside their measured ms; (c) one dry-run combination
   (Qwen3-14B decode_32k on 16 × 16, its uneven head views resharded)
   through its CLI, against what the sweep gave on a host: ok, its
   dominant term and per-rank GB.  (b) and (c)
   need no card and run beside phases 2-6 at the lowest CPU priority;
8. a ``kernels`` JSON line, the nvidia-smi line, and last the result line.

Without a card, or outside the repository, it exits non-zero and prints no
result.
"""
import contextlib
import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, FP32
# FLOP/s without tensor cores, dense bf16 and TF32 FLOP/s of the tensor
# cores, and PEAK_F32_MMA = PEAK_TF32 / 3, the 3xTF32 rate of f32-accurate
# products.  Their one home is repro_torch.launch.mesh; import_port() binds
# them here (this script imports nothing of the port before it has checked
# for a card and a checkout)
PEAK_BYTES = PEAK_FP32 = PEAK_BF16 = PEAK_TF32 = PEAK_F32_MMA = None

KL_TOL = 1e-5            # |kernel − plain| on per-row KL values of O(1-10)
GRAM_TOL = 1e-5          # relative to max(|X|ᵀ|Y|), the f32 summation scale
CARD_CPU_TOL = 1e-5      # card vs CPU params and losses (the f32 parity bound)
# Step 4, kernel vs plain Grams on the card: the ridge of the comparison and
# the bound on each server layer's weight difference relative to its largest
# weight.  A Gram difference of ~1e-7 relative grows by cond(A0 + γI) per
# layer and compounds over the 8 layers: on an H100 the differences reached
# 8.8e-4 at γ = 10 (layer-1 cond 7.2e3) and 1.2e-4 at γ = 100 (cond 2.7e3)
STEP4_GAMMA = 100.0
STEP4_TOL = 1e-3
ROUNDS, CMP_ROUNDS = 5, 2
# WKV and SSD kernels vs their plain versions: |kernel − plain| relative to
# max|y| (both are f32 recurrences, summed in another order)
SCAN_TOL = 1e-5
# full-width f32 prefill through the kernels vs the last logits of a
# decode_step replay (every matmul at M = 4 instead of M = 4·96, through 24
# or 54 layers), and vs the reference preset (only the scans differ); both
# relative to max|logits|
REPLAY_TOL = 1e-3
PRESET_TOL = 1e-4
ZOO_CARD_CPU_TOL = 1e-5  # reduced f32 zoo models, relative to max|logits|
ZOO_ARCHS = ("rwkv6-1.6b", "zamba2-2.7b")
CONSIST_LEN = 96         # f32 replay check (the Zamba2 ring holds 128)
PREFILL_B, PREFILL_LEN, PREFILL_RUNS = 4, 2048, 4   # first run is a warm-up
SERVE_B, SERVE_PROMPT, SERVE_NEW = 4, 64, 32


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(torch, fn, reps: int = 50, inner: int = 10,
            warmup: int = 5) -> float:
    """Median over ``reps`` of (CUDA-event time of ``inner`` back-to-back
    calls) / ``inner``, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def host_us(torch, fn, calls: int = 100) -> float:
    """Host time per call of ``fn`` in µs: ``calls`` calls back to back with
    no synchronisation (the wrapper's checks, allocation and launch), after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return t


def key_averages(torch, prof):
    """The device's operations of a finished ``torch.profiler`` run, one
    row a name as ``prof.key_averages()`` gives them (``key``, ``count``,
    ``self_device_time_total`` and ``device_time_total`` in µs), read from
    the trace's own events: ``key_averages()`` builds a Python object an
    event, seconds for a few decode steps of a 40-layer model."""
    import types
    cuda = torch.autograd.DeviceType.CUDA
    rows = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            row = rows.setdefault(e.name(), types.SimpleNamespace(
                key=e.name(), count=0, self_device_time_total=0.0))
            row.count += 1
            row.self_device_time_total += e.duration_ns() / 1e3
    for row in rows.values():
        row.device_time_total = row.self_device_time_total
    return list(rows.values())


def device_ms(torch, fns, names, calls: int = 20, tries: int = 3):
    """Device time per call of each callable in ``fns`` from torch.profiler:
    the summed time of the kernels whose names contain one of ``names``, or
    of every kernel in the window when ``names`` is None.  A trace now and
    then comes back without the kernels' events; such a trace is taken
    again, up to ``tries`` times, and None stands where every try held
    none."""
    from torch.profiler import ProfilerActivity, profile
    out = []
    for fn in fns:
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            evts = key_averages(torch, prof)
            total = (device_busy_ms(evts) * 1e3 if names is None else
                     sum(getattr(e, "device_time_total",
                                 getattr(e, "cuda_time_total", 0.0))
                         for e in evts if any(n in e.key for n in names)))
            if total > 0:
                break
        out.append(total / calls / 1e3 if total > 0 else None)
    return out


def kernel_name(mangled: str) -> str:
    """The kernel's own name in an Itanium-mangled entry name: the
    length-prefixed identifier that ends in "kernel"."""
    import re
    for m in re.finditer(r"\d+", mangled):
        digits = m.group()
        for i in range(len(digits)):
            n = int(digits[i:])
            cand = mangled[m.end():m.end() + n]
            if len(cand) == n and cand.endswith("kernel"):
                return cand
    return mangled


def ptxas_summary(log: str) -> dict:
    """Per kernel of an ``-Xptxas -v`` log: (instances, registers of each,
    the largest spill stores in bytes)."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            name = kernel_name(m.group(1))
            n, regs, spill = out.get(name, (0, [], 0))
            out[name] = (n + 1, regs, spill)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            n, regs, spill = out[name]
            out[name] = (n, regs, max(spill, int(m.group(1))))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name][1].append(int(m.group(1)))
    return out


def main_path(torch, port, sp, clients, test, device):
    """ROUNDS rounds with the Step-4 evaluation on the last, then
    finalize() + evaluate(); the launch counters are set to 0 just before
    and read just after."""
    trainer = port.SplitMeTrainer(port.DNN10, sp, clients, test, seed=0,
                                  device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    port.kl_ops.launches = port.kl_ops.launches_bwd = 0
    port.rg_ops.launches = 0
    round_ms = []
    for r in range(ROUNDS):
        sync()
        t0 = time.perf_counter()
        trainer.run_round(eval_acc=r == ROUNDS - 1)
        sync()
        round_ms.append((time.perf_counter() - t0) * 1e3)
    hist = trainer.fetch_history()
    w_server = trainer.finalize()
    final_acc = trainer.evaluate(w_server)
    sync()
    launches = (port.kl_ops.launches, port.kl_ops.launches_bwd,
                port.rg_ops.launches)
    return trainer, hist, round_ms, w_server, final_acc, launches


def round_profile(torch, trainer, top: int = 6):
    """One more round under torch.profiler (CUDA activity only): its wall
    time, the device's busy time, its device operations, and the kernels
    taking the most device time (name, ms, calls)."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m = trainer.run_round()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    evts = key_averages(torch, prof)
    busy_ms = sum(dev_us(e) for e in evts) / 1e3
    n_ops = sum(e.count for e in evts if dev_us(e) > 0)
    heavy = sorted(evts, key=dev_us, reverse=True)[:top]
    return m, wall_ms, busy_ms, n_ops, [(e.key[:70], dev_us(e) / 1e3, e.count)
                                        for e in heavy]


def card_vs_cpu(torch, port, sp, clients, test, devices):
    """The same CMP_ROUNDS rounds from one seed on each of two devices, with
    batch indices drawn once on a CPU generator; max param and loss diffs."""
    gcpu = torch.Generator().manual_seed(1)
    n = clients["x"].shape[1]
    idx = [torch.randint(0, n, (2, sp.M, sp.E_max, 32), generator=gcpu)
           for _ in range(CMP_ROUNDS)]
    runs = []
    for d in devices:
        t = port.SplitMeTrainer(port.DNN10, sp, clients, test, seed=0,
                                device=d, index_source=lambda r: idx[r])
        for _ in range(CMP_ROUNDS):
            t.run_round()
        runs.append((t, t.fetch_history()))
    (ta, ha), (tb, hb) = runs
    perr = max((p[k].cpu() - q[k].cpu()).abs().max().item()
               for p, q in zip(ta.w_c + ta.w_s_inv, tb.w_c + tb.w_s_inv)
               for k in p)
    lerr = max(max(abs(a.client_loss - b.client_loss),
                   abs(a.server_loss - b.server_loss))
               for a, b in zip(ha, hb))
    return perr, lerr


def step4_vs_plain(torch, port, trainer, gamma):
    """The trainer's finalize() at ``gamma`` (Grams by the kernel) against
    the same inversion with the plain Grams, on the same card and trainer
    state: per server layer the largest weight difference relative to the
    layer's largest weight, the condition number of the first layer's
    (A0 + γI), and the stitched forward's accuracy of each."""
    cfg = trainer.cfg
    saved, trainer.gamma = trainer.gamma, gamma
    try:
        got = trainer.finalize()
    finally:
        trainer.gamma = saved
    with torch.no_grad():
        smashed = port.dnn.client_forward(trainer.w_c, trainer.x, cfg)
        smashed = smashed.reshape(-1, smashed.shape[-1])
        y1 = torch.nn.functional.one_hot(trainer.y, cfg.n_classes).float()
        want = port.invert_inverse_model(
            trainer.w_s_inv, smashed, y1.reshape(-1, cfg.n_classes), cfg,
            gamma=gamma, policy="reference")
        o = torch.cat([smashed, smashed.new_ones(len(smashed), 1)], -1)
        a0 = port.gram_ref(o, o).double()
        cond = torch.linalg.cond(
            a0 + gamma * torch.eye(len(a0), dtype=a0.dtype,
                                   device=a0.device)).item()
    rel = [max((p[k] - q[k]).abs().max().item() for k in p)
           / max(q[k].abs().max().item() for k in q)
           for p, q in zip(got, want)]
    return rel, cond, trainer.evaluate(got), trainer.evaluate(want)


# the SplitMe campaign (phase 3b): the paper's 30 rounds (§V-B, the horizon
# of examples/oran_splitfl_campaign.py) for 4 seeds in one program, the
# Step-4 evaluation every 10 rounds and after the last; graphed and eager
# campaigns timed in CAMPAIGN_TURNS turns; the steady rounds PROFILE_STEADY
# (no evaluation) and the evaluating round PROFILE_EVAL profiled; the same
# campaign graphed on the card and run on the CPU (every round shape, the
# seed fold, the eval graph): params and losses within CARD_CPU_TOL,
# accuracy per round within CMP_ACC_SAMPLES test samples at the
# well-conditioned CMP_EVAL_GAMMA (at the default 1e-3 the f32 ridge is
# ill-conditioned: its accuracy difference is printed, not checked)
CAMPAIGN_ROUNDS, CAMPAIGN_SEEDS, CAMPAIGN_EVAL_EVERY = 30, (0, 1, 2, 3), 10
# 1 turn since phase 6 (2 since phase 3k, 3 before): the script's time
CAMPAIGN_TURNS = 1
PROFILE_STEADY, PROFILE_EVAL = range(10, 19), 19
CMP_EVAL_GAMMA, CMP_ACC_SAMPLES = 10.0, 1
CAMPAIGN_KERNELS = {"kl_mutual": ("kl_rows_kernel", "kl_rows_online_kernel"),
                    "kl_mutual (backward)": ("kl_grad_kernel",
                                             "kl_grad_online_kernel"),
                    "ridge_gram": ("gram_tf32_kernel",)}


def campaign_max_diff(a, b):
    """Largest |difference| of two campaigns' params and finite losses
    (their non-finite losses, a crash round's NaN row or a diverged
    round's, must be the same: else inf)."""
    import numpy as np
    perr = max((p[k].cpu() - q[k].cpu()).abs().max().item()
               for i in range(len(a.seeds))
               for ha, hb in zip(a.params_for(i), b.params_for(i))
               for p, q in zip(ha, hb) for k in p)
    bad = ~np.isfinite(a.losses)
    if not ((bad == ~np.isfinite(b.losses)).all()
            and np.array_equal(a.losses[bad], b.losses[bad], equal_nan=True)):
        return perr, float("inf")
    return perr, float(abs(a.losses[~bad] - b.losses[~bad]).max(
        initial=0.0))


def timed(torch, fn):
    """fn() and its wall ms, the card synchronized at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


# idle seconds kept at both edges of a profiled window of campaign rounds.
# The profiler drops every device event whose host-clock time (converted
# from the card's clock) falls outside the window; the conversion is off by
# a few ms now and then, and with the first replay ~1 ms after the window
# opened, a window came back without the first ~100 events of its round
# (1 window in 46 on the H100; none in the same number with these edges).
PROFILE_QUIET_S = 0.1


def open_window(torch):
    """A started CUDA profiler, the card idle PROFILE_QUIET_S before and
    after its start; with the host time its window of rounds begins."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    time.sleep(PROFILE_QUIET_S)
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    torch.cuda.synchronize()
    time.sleep(PROFILE_QUIET_S)
    return prof, time.perf_counter()


def close_window(torch, prof, t0: float) -> float:
    """Stop ``prof`` PROFILE_QUIET_S after the card went idle; the wall ms
    since ``t0``."""
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    time.sleep(PROFILE_QUIET_S)
    prof.stop()
    return wall


def campaign_window(torch, evts, rounds: int):
    """Per round of a profiled window: device busy ms, device operations,
    and for each of CAMPAIGN_KERNELS (launches, device µs a launch)."""
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    busy_ms = sum(dev_us(e) for e in evts) / 1e3
    n_ops = sum(e.count for e in evts if dev_us(e) > 0)
    per = {}
    for name, keys in CAMPAIGN_KERNELS.items():
        hit = [e for e in evts if any(k in e.key for k in keys)]
        n = sum(e.count for e in hit)
        per[name] = (n / rounds, sum(dev_us(e) for e in hit) / n if n
                     else None)
    return busy_ms / rounds, n_ops / rounds, per


def steady_and_eval_windows(torch, run):
    """``run(_round_hook=...)`` with one profiler window over the rounds
    PROFILE_STEADY and one over the evaluating round PROFILE_EVAL: {"steady":
    (events, wall ms), "eval": (events, wall ms)}."""
    return profiled_windows(torch, run, {"steady": list(PROFILE_STEADY),
                                         "eval": [PROFILE_EVAL]})


def profiled_windows(torch, run, windows):
    """``run(_round_hook=...)`` with torch.profiler (CUDA) open over each
    window of ``windows`` ({name: consecutive rounds}, in round order, not
    overlapping): {name: (events, wall ms)}."""
    order = sorted(windows.items(), key=lambda kv: kv[1][0])
    win, out = {}, {}

    def hook(r):
        if "prof" in win and r == win["last"]:
            wall = close_window(torch, win["prof"], win["t0"])
            out[win.pop("name")] = (key_averages(torch, win.pop("prof")),
                                    wall)
        for name, rounds in order:
            if r == rounds[0] - 1:
                win["name"], win["last"] = name, rounds[-1]
                win["prof"], win["t0"] = open_window(torch)
    run(_round_hook=hook)
    return out


def campaign_phase(torch, port, sp, clients, test):
    """Phase 3b: the paper's campaign through run_campaign, graphed and
    eager; returns the per-kernel numbers of the graphed steady rounds."""
    import numpy as np
    camp = port.campaign
    kw = dict(rounds=CAMPAIGN_ROUNDS, seeds=CAMPAIGN_SEEDS, test_data=test,
              device="cuda")
    S = len(CAMPAIGN_SEEDS)

    def graphed(**more):
        return camp.run_campaign("splitme", port.DNN10, sp, clients,
                                 eval_every=CAMPAIGN_EVAL_EVERY,
                                 strict_transfers=True, **kw, **more)

    def eager():
        return camp.run_campaign("splitme", port.DNN10, sp, clients,
                                 scan=False, **kw)

    # the main path: strict transfers held through the device phase
    camp.HOST_TRANSFERS = 0
    res = graphed()
    check(camp.HOST_TRANSFERS == 1,
          f"scanned campaign made {camp.HOST_TRANSFERS} host transfers")
    shapes = res.graphs["shapes"]
    for (kb, eb), rs in shapes.items():
        print(f"campaign shape (cohort {kb}, E {eb}): rounds {rs[0]}-{rs[-1]}"
              f" ({len(rs)})")
    print(f"campaign: {res.graphs['graphs']} CUDA graphs ({len(shapes)} "
          f"round shapes + the evaluation), capture {res.graphs['capture_s']:.3f}"
          f" s; HOST_TRANSFERS {camp.HOST_TRANSFERS} with strict_transfers "
          f"(sync debug mode 'error') through the device phase")
    check(res.graphs["graphs"] == len(shapes) + 1, "one graph per shape + eval")
    check(bool(torch.isfinite(torch.as_tensor(res.losses)).all()),
          "non-finite campaign loss")
    steady_shape = max(shapes, key=lambda s: len(shapes[s]))
    steady = shapes[steady_shape][1:]          # its first round captures
    check(set(PROFILE_STEADY) | {PROFILE_EVAL} <= set(steady),
          f"profiled rounds outside the steady shape {steady_shape}")
    acc = res.accuracy_per_round
    for r in range(CAMPAIGN_ROUNDS):
        if not (r + 1) % CAMPAIGN_EVAL_EVERY or r == CAMPAIGN_ROUNDS - 1:
            print(f"campaign round {r}: accuracy per seed "
                  f"{[round(float(v), 4) for v in acc[r]]}")
            check(all(0.0 <= v <= 1.0 for v in acc[r]),
                  f"accuracy out of range at round {r}")
        else:
            check(bool(torch.isnan(torch.as_tensor(acc[r])).all()),
                  f"round {r} evaluated")

    # graphed against eager, and their ms per round in turns; the whole
    # campaign too: the graphed rounds with capture, warm-ups and the
    # evaluating rounds, against the eager rounds and the post-hoc
    # evaluation, and each run_campaign call's wall (host plan included)
    g_ms, e_ms, g_host, whole = [], [], [], []
    for turn in range(CAMPAIGN_TURNS):
        marks = []
        g, g_wall = timed(torch, lambda: graphed(
            _round_hook=lambda r: marks.append(time.perf_counter())))
        e, e_wall = timed(torch, eager)
        _, ev_ms = timed(torch, lambda: camp.evaluate_campaign(
            e, port.DNN10, test, client_data=clients))
        whole.append((float(sum(g.round_ms)), float(sum(e.round_ms)) + ev_ms))
        print(f"turn {turn}: whole campaign, graphed {whole[-1][0]:.1f} ms of "
              f"rounds (capture {g.graphs['capture_s'] * 1e3:.1f} ms, eval "
              f"rounds included; call {g_wall:.1f} ms), eager "
              f"{sum(e.round_ms):.1f} ms of rounds + {ev_ms:.1f} ms post-hoc "
              f"evaluation = {whole[-1][1]:.1f} ms (call {e_wall:.1f} ms): "
              f"{whole[-1][1] / whole[-1][0]:.2f}x")
        if turn == 0:
            perr, lerr = campaign_max_diff(g, e)
            print(f"graphed vs eager campaign: max param diff {perr:.3e}, "
                  f"max loss diff {lerr:.3e}, bitwise "
                  f"{perr == 0.0 and lerr == 0.0}")
            check(perr <= CARD_CPU_TOL and lerr <= CARD_CPU_TOL,
                  "graphed and eager campaigns disagree")
            rerr = campaign_max_diff(g, res)
            check(rerr == (0.0, 0.0), f"two graphed campaigns differ {rerr}")
        g_ms.append(statistics.median(g.round_ms[steady]))
        e_ms.append(statistics.median(e.round_ms[steady]))
        g_host.append(statistics.median(
            [(marks[r] - marks[r - 1]) * 1e3 for r in steady]))
        print(f"turn {turn}: graphed {g_ms[-1]:.3f} ms/round (host "
              f"{g_host[-1]:.3f} ms), eager {e_ms[-1]:.3f} ms/round "
              f"(medians over rounds {steady[0]}-{steady[-1]})")
    gm, em = statistics.median(g_ms), statistics.median(e_ms)
    print(f"campaign ms per round (cohort {steady_shape[0]}, E "
          f"{steady_shape[1]}, {S} seeds, medians of {CAMPAIGN_TURNS}): "
          f"graphed {gm:.3f} ms ({S * 1e3 / gm:.1f} seed-rounds/s; host "
          f"{statistics.median(g_host):.3f} ms a round), eager {em:.3f} ms "
          f"({S * 1e3 / em:.1f} seed-rounds/s): {em / gm:.1f}x")
    wg = statistics.median(w[0] for w in whole)
    we = statistics.median(w[1] for w in whole)
    print(f"campaign whole {CAMPAIGN_ROUNDS} rounds ({S} seeds, medians of "
          f"{CAMPAIGN_TURNS}): graphed {wg:.1f} ms, eager with its post-hoc "
          f"evaluation {we:.1f} ms: {we / wg:.2f}x")

    # the steady rounds and one evaluating round under the profiler
    win = steady_and_eval_windows(torch, lambda **more: camp.run_campaign(
        "splitme", port.DNN10, sp, clients, eval_every=CAMPAIGN_EVAL_EVERY,
        **kw, **more))
    n_steady = len(PROFILE_STEADY)
    evts, wall = win["steady"]
    busy, n_ops, per = campaign_window(torch, evts, n_steady)
    wall /= n_steady
    print(f"profiled graphed rounds {PROFILE_STEADY[0]}-{PROFILE_STEADY[-1]}"
          f": wall {wall:.3f} ms a round, device busy {busy:.3f} ms, idle "
          f"share {1 - busy / wall:.4f}, {n_ops:.1f} device operations a "
          f"round; " + "; ".join(
              f"{k} {n:.1f} launches a round, {us and round(us, 3)} us a "
              f"launch" for k, (n, us) in per.items()))
    eb = steady_shape[1]
    check(per["kl_mutual"][0] == 2 * eb
          and per["kl_mutual (backward)"][0] == 2 * eb
          and per["ridge_gram"][0] == 0,
          f"steady round launches {per} != 2 x E {eb} KL forward and "
          f"backward, no Gram")
    evts, wall_e = win["eval"]
    busy_e, n_ops_e, per_e = campaign_window(torch, evts, 1)
    print(f"profiled graphed round {PROFILE_EVAL} with the evaluation: wall "
          f"{wall_e:.3f} ms, device busy {busy_e:.3f} ms, {n_ops_e:.0f} "
          f"device operations; " + "; ".join(
              f"{k} {n:.0f} launches, {us and round(us, 3)} us a launch"
              for k, (n, us) in per_e.items()))
    check(per_e["kl_mutual"][0] == 2 * eb
          and per_e["kl_mutual (backward)"][0] == 2 * eb
          and per_e["ridge_gram"][0] == 8 * S,
          f"evaluating round launches {per_e} != 2 x E {eb} KL, 8 Gram "
          f"pairs a seed")

    # the campaign graphed on the card against the CPU: every round shape,
    # the seed fold and the eval graph
    runs = [camp.run_campaign("splitme", port.DNN10, sp, clients,
                              eval_every=CAMPAIGN_EVAL_EVERY,
                              eval_gamma=CMP_EVAL_GAMMA, **dict(kw, device=d))
            for d in ("cuda", "cpu")]
    check(runs[0].graphs["shapes"] == shapes,
          f"card vs CPU campaign shapes {runs[0].graphs['shapes']}")
    perr, lerr = campaign_max_diff(*runs)
    acc_a, acc_b = (r.accuracy_per_round for r in runs)
    evaluated = np.isfinite(acc_b).all(axis=1)
    check(bool((np.isfinite(acc_a) == np.isfinite(acc_b)).all())
          and evaluated.tolist() == np.isfinite(acc).all(axis=1).tolist(),
          "card and CPU campaigns evaluate different rounds")
    n_test = len(test[1])
    aerr = float(abs(acc_a[evaluated] - acc_b[evaluated]).max()) * n_test
    # at the default gamma: each device's own post-hoc evaluation
    acc_d = [camp.evaluate_campaign(r, port.DNN10, test, client_data=clients)
             for r in runs]
    aerr_d = float(abs(acc_d[0] - acc_d[1]).max()) * n_test
    print(f"campaign card (graphed) vs CPU, {S} seeds, {CAMPAIGN_ROUNDS} "
          f"rounds, shapes {sorted(shapes)}: max param diff {perr:.3e}, max "
          f"loss diff {lerr:.3e} (tol {CARD_CPU_TOL}); accuracy at rounds "
          f"{np.nonzero(evaluated)[0].tolist()}, gamma {CMP_EVAL_GAMMA}: "
          f"max diff {aerr:.2f} of {n_test} test samples (tol "
          f"{CMP_ACC_SAMPLES}), final {acc_a[-1].round(4).tolist()} vs "
          f"{acc_b[-1].round(4).tolist()}; at gamma 1e-3 (ill-conditioned, "
          f"not checked) {acc_d[0].round(4).tolist()} vs "
          f"{acc_d[1].round(4).tolist()}, {aerr_d:.0f} samples apart")
    check(perr <= CARD_CPU_TOL and lerr <= CARD_CPU_TOL,
          "campaign on the card and on the CPU disagree")
    check(aerr <= CMP_ACC_SAMPLES + 1e-6,
          "campaign accuracy on the card and on the CPU disagree")
    print(f"campaign final accuracy per seed: "
          f"{[round(float(v), 4) for v in res.accuracy]}")
    # the KL kernels run in every round; the Gram kernel only in the
    # evaluating ones (9 rounds in 10 launch none)
    out = {name: {"campaign_launches_per_round": n,
                  "campaign_device_us_per_launch": us}
           for name, (n, us) in list(per.items())[:2]}
    n, us = per_e["ridge_gram"]
    out["ridge_gram"] = {"campaign_launches_per_eval_round": n,
                         "campaign_device_us_per_launch": us}
    summary = {"round_ms": gm, "ops_per_round": n_ops,
               "idle_share": 1 - busy / wall, "graphs": res.graphs["graphs"],
               "capture_s": res.graphs["capture_s"],
               "launches_per_round": {k: v[0] for k, v in per.items()},
               "launches_per_eval_round": {k: v[0]
                                           for k, v in per_e.items()}}
    return out, n_ops, summary


# precision and wire formats (phase 3c): the paper's campaign of phase 3b
# under the bf16 policy ("kernel_bf16": bf16 on the card), the int8 wire
# (stochastic rounding with error feedback) and the bf16 wire.  Each
# variant: graphed (strict transfers, one transfer) against eager bit for
# bit (params, losses, error-feedback state); the card against the CPU over
# the first PRECISION_CMP_ROUNDS rounds (an evaluation included) of 4 seeds
# (the CPU forcing the bf16 precision the preset resolves to on the card;
# all 30 rounds until phase 6 came, the script's time), each side its own
# campaign of those rounds, params and losses within the CPU parity bounds
# of tests/test_torch_{precision,quantcomm}.py (1e-3 bf16 policy, 6e-2
# int8, 2e-2 bf16 wire) and accuracy per evaluated round at γ = 10 within
# CMP_ACC_SAMPLES_MIXED of 1200 test samples (1 %: bf16 roundings of
# activations and of the wire amplify the products' other summation order
# on the card); one timed turn, and one profiled window of steady rounds.
# The bf16 policy's gate, 1e-3, against the card's own spread (phase 3l,
# ROADMAP C 6; H100, 700 W): every initial weight one ulp up moves the
# card's bf16 campaign by 7.3e-6 after 1 round, 1.7e-4 after 10 and
# 1.4e-4 after 30, while card and CPU part by 4.2e-4 to 1.06e-3 after 10
# (other batches): the devices differ by more than the init's last bit,
# each step rounding differently summed products to bf16 anew.
PRECISION_VARIANTS = (
    ("kernel_bf16", dict(policy="kernel_bf16"), 1e-3),
    ("int8 wire", dict(quant="int8"), 6e-2),
    ("bf16 wire", dict(quant="bf16"), 2e-2),
)
CMP_ACC_SAMPLES_MIXED = 12
PRECISION_CMP_ROUNDS = 10
PROFILE_WINDOW = 9


def steady_window(shapes, rounds: int, every: int):
    """Up to PROFILE_WINDOW consecutive rounds of the most frequent round
    shape, after its first (captured) round and before an evaluating round;
    the shape and the rounds."""
    shape = max(shapes, key=lambda s: len(shapes[s]))
    evals = {r for r in range(rounds) if not (r + 1) % every}
    best = []
    for r0 in shapes[shape][1:]:
        run = []
        for r in range(r0, rounds):
            if r not in shapes[shape] or r in evals:
                break
            run.append(r)
            if len(run) == PROFILE_WINDOW:
                break
        if len(run) > len(best):
            best = run
    return shape, best


def profiled_campaign(torch, camp, window, run):
    """``run(_round_hook=...)`` with torch.profiler (CUDA) open over the
    rounds of ``window``: per round the wall ms, the device's busy ms, its
    operations, and the events."""
    win = {}

    def hook(r):
        if r == window[0] - 1:
            win["prof"], win["t0"] = open_window(torch)
        elif r == window[-1]:
            win["wall"] = close_window(torch, win["prof"], win["t0"])
    run(_round_hook=hook)
    evts = key_averages(torch, win["prof"])
    n = len(window)

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    busy = sum(dev_us(e) for e in evts) / 1e3 / n
    ops = sum(e.count for e in evts if dev_us(e) > 0) / n
    return win["wall"] / n, busy, ops, evts, dev_us


def precision_phase(torch, port, sp, clients, test, f32_ops):
    """Phase 3c: the paper's campaign under each of PRECISION_VARIANTS;
    returns the KL pairs' in-graph launches and device µs a launch (bf16
    policy), the main path's launch counts and each variant's numbers."""
    import numpy as np
    camp, kl_ops, rg_ops = port.campaign, port.kl_ops, port.rg_ops
    S = len(CAMPAIGN_SEEDS)
    n_test = len(test[1])
    kw = dict(rounds=CAMPAIGN_ROUNDS, seeds=CAMPAIGN_SEEDS)
    forced = port.dispatch.KernelPolicy(precision=port.dispatch.BF16)
    out = {"variants": {}}
    for name, opts, tol in PRECISION_VARIANTS:
        def graphed(**more):
            return camp.run_campaign(
                "splitme", port.DNN10, sp, clients, test_data=test,
                eval_every=CAMPAIGN_EVAL_EVERY, eval_gamma=CMP_EVAL_GAMMA,
                device="cuda", **kw, **opts, **more)

        # the main path of the variant: the launch counters set to 0 just
        # before and read just after (replays do not move them: the eager
        # warm-up and the capture of each graph do)
        kl_ops.launches = kl_ops.launches_bwd = rg_ops.launches = 0
        kl_ops.launches_by_entry.clear()
        camp.HOST_TRANSFERS = 0
        res, wall = timed(torch, lambda: graphed(strict_transfers=True))
        counts = dict(kl_ops.launches_by_entry, ridge_gram=rg_ops.launches)
        check(camp.HOST_TRANSFERS == 1,
              f"{name}: {camp.HOST_TRANSFERS} host transfers")
        shapes = res.graphs["shapes"]
        check(res.graphs["graphs"] == len(shapes) + 1,
              f"{name}: one graph per shape + eval")
        check(bool(np.isfinite(res.losses).all()), f"{name}: non-finite loss")
        q = port.quantcomm.tree_leaves(res.qstate)
        q_ok = all(bool(torch.isfinite(v).all()) for v in q)
        check(q_ok, f"{name}: non-finite error-feedback state")
        check(bool(q) == (opts.get("quant") == "int8"),
              f"{name}: error-feedback state {len(q)} leaves")
        print(f"{name}: launches in the graphed campaign's warm-ups and "
              f"captures {counts}; shapes "
              + ", ".join(f"({kb}, {eb}) rounds {rs[0]}-{rs[-1]}"
                          for (kb, eb), rs in shapes.items())
              + f"; {res.graphs['graphs']} graphs, capture "
              f"{res.graphs['capture_s']:.3f} s, HOST_TRANSFERS "
              f"{camp.HOST_TRANSFERS} under strict_transfers; error-feedback "
              f"state {len(q)} leaves, finite {q_ok}")
        if name == "kernel_bf16":
            for entry in ("kl_mutual_rows_bf16_f32", "kl_mutual_rows_f32_bf16",
                          "kl_mutual_grad_bf16_f32",
                          "kl_mutual_grad_f32_bf16"):
                check(counts.get(entry, 0) > 0,
                      f"kernel_bf16 campaign never launched {entry}")
            check(not counts.keys() & {"kl_mutual_rows_f32",
                                       "kl_mutual_grad_f32"},
                  f"kernel_bf16 campaign launched an f32 KL entry {counts}")
            out["launches"] = counts
        check(counts["ridge_gram"] > 0, f"{name}: no Gram launch")
        # graphed against eager, bit for bit
        eager, e_wall = timed(torch, lambda: camp.run_campaign(
            "splitme", port.DNN10, sp, clients, scan=False, device="cuda",
            **kw, **opts))
        perr, lerr = campaign_max_diff(res, eager)
        qerr = max([float((a - b).abs().max()) for a, b in zip(
            q, port.quantcomm.tree_leaves(eager.qstate))], default=0.0)
        print(f"{name}: graphed vs eager campaign: max param diff {perr:.3e}"
              f", loss {lerr:.3e}, error-feedback state {qerr:.3e}")
        check(perr == lerr == qerr == 0.0,
              f"{name}: graphed and eager campaigns differ")
        # times: a steady round, the whole campaign, idle share, operations
        shape, window = steady_window(shapes, CAMPAIGN_ROUNDS,
                                      CAMPAIGN_EVAL_EVERY)
        check(len(window) >= 3, f"{name}: steady window {window}")
        steady = [r for r in shapes[shape][1:]
                  if (r + 1) % CAMPAIGN_EVAL_EVERY]
        round_ms = statistics.median(res.round_ms[steady])
        whole = float(sum(res.round_ms))
        pwall, busy, ops, evts, dev_us = profiled_campaign(
            torch, camp, window, graphed)
        v = out["variants"][name] = {
            "shape": list(shape), "round_ms": round_ms, "whole_ms": whole,
            "call_ms": wall, "eager_whole_ms": float(sum(eager.round_ms)),
            "profiled_round_ms": pwall, "busy_ms": busy,
            "idle_share": 1 - busy / pwall, "ops_per_round": ops,
            "ops_vs_f32": ops - f32_ops}
        print(f"{name}: steady ({shape[0]}, {shape[1]}) round of {S} seeds "
              f"{round_ms:.3f} ms (median over {len(steady)} rounds); whole "
              f"{CAMPAIGN_ROUNDS} rounds graphed {whole:.1f} ms (capture and "
              f"evaluations included; call {wall:.1f} ms), eager "
              f"{v['eager_whole_ms']:.1f} ms of rounds; profiled rounds "
              f"{window[0]}-{window[-1]}: wall {pwall:.3f} ms a round, busy "
              f"{busy:.3f} ms, idle share {v['idle_share']:.4f}, {ops:.1f} "
              f"device operations a round ({ops - f32_ops:+.1f} against the "
              f"f32 campaign's {f32_ops:.1f})")
        if name == "kernel_bf16":
            kl_keys = sorted({e.key[:90] for e in evts if "kl_" in e.key})
            print(f"kernel_bf16: KL kernels in the profiled window: {kl_keys}")
            for tx, ty in KL_PAIRS:
                for key, base in (("fwd", "kl_rows_"), ("bwd", "kl_grad_")):
                    hit = [e for e in evts if base in e.key
                           and kl_pair_kernel(e.key, tx, ty)]
                    n = sum(e.count for e in hit)
                    out[(tx, ty, key)] = {
                        "campaign_launches_per_round": n / len(window),
                        "campaign_device_us_per_launch":
                            sum(dev_us(e) for e in hit) / n if n else None}
            # E steps of each phase: the client's (bf16 x, f32 y), the
            # server's (f32 x, bf16 y), a forward and a backward each
            check(all(out[(tx, ty, key)]["campaign_launches_per_round"]
                      == shape[1] for tx, ty in KL_PAIRS[:2]
                      for key in ("fwd", "bwd")),
                  f"kernel_bf16 steady round KL launches "
                  f"{[out[(tx, ty, k)] for tx, ty in KL_PAIRS[:2] for k in ('fwd', 'bwd')]} "
                  f"!= E {shape[1]} each")
        # the card against the CPU over the first PRECISION_CMP_ROUNDS
        cpu_opts = dict(opts, policy=forced) if "policy" in opts else opts
        short = dict(kw, rounds=PRECISION_CMP_ROUNDS)
        card = camp.run_campaign(
            "splitme", port.DNN10, sp, clients, test_data=test,
            eval_every=CAMPAIGN_EVAL_EVERY, eval_gamma=CMP_EVAL_GAMMA,
            device="cuda", **short, **opts)
        cpu = camp.run_campaign(
            "splitme", port.DNN10, sp, clients, test_data=test,
            eval_every=CAMPAIGN_EVAL_EVERY, eval_gamma=CMP_EVAL_GAMMA,
            device="cpu", **short, **cpu_opts)
        check(cpu.schedule.E.tolist() == card.schedule.E.tolist()
              and bool((cpu.schedule.a == card.schedule.a).all())
              and card.schedule.E.tolist()
              == res.schedule.E[:PRECISION_CMP_ROUNDS].tolist(),
              f"{name}: card and CPU schedules differ")
        perr, lerr = campaign_max_diff(card, cpu)
        acc_a, acc_b = card.accuracy_per_round, cpu.accuracy_per_round
        evaluated = np.isfinite(acc_b).all(axis=1)
        check(bool((np.isfinite(acc_a) == np.isfinite(acc_b)).all()),
              f"{name}: card and CPU evaluate different rounds")
        aerr = float(abs(acc_a[evaluated] - acc_b[evaluated]).max()) * n_test
        v.update(card_cpu_param_diff=perr, card_cpu_loss_diff=lerr,
                 card_cpu_acc_samples=aerr,
                 final_accuracy=[float(a) for a in res.accuracy_per_round[-1]])
        print(f"{name}: card (graphed) vs CPU, {S} seeds, the first "
              f"{PRECISION_CMP_ROUNDS} rounds: max param diff {perr:.3e}, loss "
              f"{lerr:.3e} (tol "
              f"{tol}); accuracy at rounds "
              f"{np.nonzero(evaluated)[0].tolist()}, gamma {CMP_EVAL_GAMMA}: "
              f"max diff {aerr:.0f} of {n_test} test samples (tol "
              f"{CMP_ACC_SAMPLES_MIXED}); at round {PRECISION_CMP_ROUNDS - 1} "
              f"{acc_a[-1].round(4).tolist()}"
              f" vs {acc_b[-1].round(4).tolist()}")
        check(perr <= tol and lerr <= tol,
              f"{name}: campaign on the card and on the CPU disagree")
        check(aerr <= CMP_ACC_SAMPLES_MIXED + 1e-6,
              f"{name}: accuracy on the card and on the CPU disagree")
        torch.cuda.empty_cache()
    return out


# the paper's framework comparison (phase 3d): the five baselines as
# examples/oran_splitfl_campaign.py --seeds 4 --baselines runs them
# (:194-200): per-framework K and E, BASELINE_ROUNDS of its 60 baseline
# rounds, 4 seeds,
# SystemParams(seed=0), DNN10 at full width, the data of phase 3b; the
# full-model evaluation (no ridge solve) every 10 rounds and after the last.
# Each: graphed (strict transfers, one transfer) against eager bit for bit,
# its steady round graphed and eager (medians of BASELINE_TURNS turns), the
# whole campaign, one profiled window, and the card against the CPU over
# the first BASELINE_CMP_ROUNDS rounds (CARD_CPU_TOL; accuracy after every
# round within CMP_ACC_SAMPLES test samples).  The baselines' SGD on the
# whole DNN10 amplifies a difference in the last bit round after round (on
# an H100 a 1-ulp change of every initial weight moved FedAvg's own params
# by 1.0e-1 over 60 rounds, the card and the CPU parted by 2.8e-2,
# after agreeing to 3e-7 over 3; the JAX reference on the CPU parts from
# itself alike: the same change moves its FedAvg params by 4.1e-7, 2.4e-6,
# 1.3e-3, 4.1e-2 and 1.1e-1 after 1, 3, 10, 30 and 60 rounds, seeds 0-1,
# tests/data/horizon_envelope.json), so no two summation orders agree at
# 1e-5 over many rounds: for FedAvg the whole campaign's card vs CPU
# difference is printed beside the card's own under that 1-ulp change.
# FedAvg also runs one turn under BASELINE_VARIANTS: (name, options, the
# bound of phase 3c, the rounds it is held over); the bf16 policy's round
# bound holds over one round, and bf16_rule holds it to the CPU's
# three-round rule.  The KL and Gram counters must stay at 0 through all
# of it.
BASELINES = (("fedavg", {"K": 10, "E": 10}), ("sfl", {"K": 20, "E": 14}),
             ("oranfed", {"E": 10}), ("fedora", {"E": 10}),
             ("ecofl", {"K": 10, "E": 10}))
# 30 of the example's 60 rounds since phase 3k (60 before; the script's
# time): the steady shapes and profiled windows of the five are those of
# the 60-round plan, whose first 30 rounds these are
BASELINE_ROUNDS = 30
# one turn, where 3b takes three: the phase is the script's longest (5
# frameworks x 30 rounds, graphed and eager, each turn)
BASELINE_TURNS = 1
BASELINE_CMP_ROUNDS = 3
# O-RANFed's cohort changes nearly every round: its most frequent round
# shape, (16, 10), runs at most 2 rounds in a row, so phase 3d profiles
# windows of 2 rounds or more (phase 3c's hold 3 or more)
BASELINE_MIN_WINDOW = 2
# even within those rounds a hidden unit whose pre-activation lies within
# rounding of 0 can fall on the other side of its ReLU on the card, and its
# weights' gradients then differ by O(lr x gradient) in that step (H100
# runs: EcoFL's 23 weights into one unit 3.0e-5 apart after 3 rounds,
# SplitMe's under the straggler trace of phase 3e 5 elements in 3 units up
# to 1.4e-5 after 30).  So the params of phases 3d and 3e hold
# CARD_CPU_TOL but for the weights of at most FLIP_UNITS hidden units a
# seed (flipped_units), which hold FLIP_TOL; losses and accuracy keep
# their bounds
FLIP_UNITS, FLIP_TOL = 4, 1e-4
BASELINE_VARIANTS = (("kernel_bf16", dict(policy="kernel_bf16"), 1e-3, 1),
                     ("int8 wire", dict(quant="int8"), 6e-2,
                      BASELINE_CMP_ROUNDS))
# FedAvg under the bf16 policy beyond one round.  The CPU's rule
# (tests/test_torch_baseline_precision.py, at its configuration: the small
# data of M 12 clients, 32 samples a client, E 3): the first round within
# the round bound 1e-3, and each of three rounds under BF16_RULE_SHARE of
# the distance between the CPU's own bf16 and f32 trainers.  On the card
# the mixed path is held to it for BF16_RULE_SEEDS with the one step that
# the CPU computes another way, the tensor cores' bf16 GEMM, replaced by
# the CPU's widened f32 product (widened_gemm); with the tensor cores the
# round bound is held, and the three-round distances are printed beside
# what a one-ulp change of the initial weights does on each device (the
# bf16 rounding of activations turns a last-bit difference into a 2^-8
# one, and the SGD amplifies it), at that configuration and at phase 3d's
BF16_RULE_SEEDS = tuple(range(8))
BF16_RULE_SHARE = 0.5
# a time-varying RAN (phase 3e): (framework, scenario, rounds, K / E); the
# card against the CPU over the first SCENARIO_CMP_ROUNDS rounds for
# SplitMe (its whole 30 until phase 6 came, the script's time; each side
# its own campaign of those rounds), over the first BASELINE_CMP_ROUNDS
# for FedORA (phase 3d's reason)
SCENARIO_CMP_ROUNDS = 10
SCENARIO_RUNS = (("splitme", "straggler:0.4", CAMPAIGN_ROUNDS, {}),
                 ("fedora", "fading", BASELINE_ROUNDS, {"E": 10}))


def flipped_units(torch, card, cpu, tol: float = CARD_CPU_TOL) -> int:
    """The hidden units (fewest found greedily, up to FLIP_UNITS + 1) whose
    weights hold every element of one seed's params (tuples of MLP layer
    lists) more than ``tol`` apart: w_l[i, j] belongs to unit j of layer l
    (with b_l[j]) and to unit i of layer l - 1, the two units a flipped
    ReLU's gradient moves."""
    import collections
    far = []
    for h, (ha, hb) in enumerate(zip(card, cpu)):
        for l, (p, q) in enumerate(zip(ha, hb)):
            for k in p:
                d = (p[k].cpu() - q[k].cpu()).abs() > tol
                for ij in d.nonzero().tolist():
                    units = {(h, l, ij[-1])}
                    if k == "w" and l > 0:
                        units.add((h, l - 1, ij[0]))
                    far.append(units)
    n = 0
    while far and n <= FLIP_UNITS:
        unit = collections.Counter(
            u for units in far for u in units).most_common(1)[0][0]
        far = [units for units in far if unit not in units]
        n += 1
    return n + bool(far)


def card_vs_cpu_campaign(torch, res, cpu, n_test: int):
    """Params and loss max diffs of two campaigns, the largest accuracy
    difference (in test samples) over the rounds both evaluated, and the
    most flipped_units of a seed."""
    import numpy as np
    check(cpu.schedule.E.tolist() == res.schedule.E.tolist()
          and bool((cpu.schedule.a == res.schedule.a).all()),
          f"{res.framework}: card and CPU schedules differ")
    perr, lerr = campaign_max_diff(res, cpu)
    acc_a, acc_b = res.accuracy_per_round, cpu.accuracy_per_round
    check(bool((np.isfinite(acc_a) == np.isfinite(acc_b)).all()),
          f"{res.framework}: card and CPU evaluate different rounds")
    evaluated = np.isfinite(acc_b).all(axis=1)
    aerr = float(abs(acc_a[evaluated] - acc_b[evaluated]).max()) * n_test
    units = max(flipped_units(torch, res.params_for(i), cpu.params_for(i))
                for i in range(len(res.seeds)))
    return perr, lerr, aerr, units


def check_card_cpu_flips(label, perr, lerr, aerr, units):
    """The card-vs-CPU bounds of phases 3d and 3e (see FLIP_UNITS)."""
    check(lerr <= CARD_CPU_TOL and perr <= FLIP_TOL and units <= FLIP_UNITS,
          f"{label}: campaign on the card and on the CPU disagree")
    check(aerr <= CMP_ACC_SAMPLES + 1e-6,
          f"{label}: accuracy on the card and on the CPU disagree")


def short_card_vs_cpu(torch, run, n_test: int,
                      rounds: int = BASELINE_CMP_ROUNDS, **opts):
    """``run`` over its first ``rounds`` rounds, evaluated after every
    round, graphed on the card and on the CPU (under ``cpu_policy`` if
    given): ``card_vs_cpu_campaign``'s differences."""
    cpu_policy = opts.pop("cpu_policy", None)
    card = run(rounds=rounds, eval_every=1, **opts)
    if cpu_policy is not None:
        opts["policy"] = cpu_policy
    cpu = run(device="cpu", rounds=rounds, eval_every=1, **opts)
    return card_vs_cpu_campaign(torch, card, cpu, n_test)


def initial_params(torch, port, name: str, seeds):
    """Each seed's initial weights, drawn as its run's generator draws
    them (on the CPU)."""
    spec = port.engine.make_spec(name, port.DNN10, device="cpu")
    return [spec.init_fn(torch.Generator().manual_seed(s), "cpu")
            for s in seeds]


def one_ulp_up(torch, params):
    """A params tuple with every element moved up by one ulp."""
    return tuple([{k: torch.nextafter(v, torch.full_like(v, float("inf")))
                   for k, v in layer.items()} for layer in half]
                 for half in params)


def param_dist(a, b) -> float:
    """max |a - b| over two params tuples (lists of MLP layers)."""
    return max(float((p[k].cpu() - q[k].cpu()).abs().max())
               for ha, hb in zip(a, b) for p, q in zip(ha, hb) for k in p)


def ulp_spread(torch, port, run, spec_name: str):
    """The card's own sensitivity: one graphed campaign from each seed's
    initial weights and one from the same weights moved up by one ulp; the
    max param difference of the two."""
    init = initial_params(torch, port, spec_name, CAMPAIGN_SEEDS)
    a = run(params=init)
    b = run(params=[one_ulp_up(torch, p) for p in init])
    return campaign_max_diff(a, b)[0]


@contextlib.contextmanager
def widened_gemm(port):
    """The mixed forward's bf16 GEMM (tensor cores, f32 sums) replaced by
    the CPU's: both operands widened to f32 (exactly) and one f32
    product."""
    mm = port.dnn._matmul_f32
    port.dnn._matmul_f32 = lambda a, b: a.float() @ b.float()
    try:
        yield
    finally:
        port.dnn._matmul_f32 = mm


def bf16_rule(torch, port, run):
    """FedAvg under the bf16 policy and the CPU's three-round rule (see
    BF16_RULE_SEEDS): at the CPU test's configuration through the trainers
    (the round bound checked on the tensor cores, the rule with the GEMM
    widened), and at phase 3d's through ``run`` (its campaign, printed).
    Per seed, each run's distance after three rounds, over the CPU's bf16
    vs f32 distance: the card's from the CPU's, and a one-ulp change of the
    initial weights' on each device."""
    forced = port.dispatch.KernelPolicy(precision=port.dispatch.BF16)
    X, y = port.oran.generate(n_per_class=300, seed=0)
    (Xtr, ytr), test = port.oran.train_test_split(X, y)
    cd = port.oran.partition_non_iid(Xtr, ytr, 12, samples_per_client=32,
                                     seed=0)
    inits = initial_params(torch, port, "fedavg", BF16_RULE_SEEDS)
    ups = [one_ulp_up(torch, p) for p in inits]
    pairs = (("tensor cores", "cpu"), ("widened GEMM", "cpu"),
             ("card one ulp up", "tensor cores"), ("CPU one ulp up", "cpu"))
    small = {k: [] for k, _ in pairs}
    first = 0.0
    for seed, init, up in zip(BF16_RULE_SEEDS, inits, ups):
        def trainer(device, policy, params=init):
            return port.baselines.FedAvgTrainer(
                port.DNN10, port.SystemParams(M=12, seed=0), cd, test, E=3,
                seed=seed, device=device, kernel_policy=policy,
                params=params)
        ts = {"tensor cores": trainer("cuda", "kernel_bf16"),
              "widened GEMM": trainer("cuda", "kernel_bf16"),
              "card one ulp up": trainer("cuda", "kernel_bf16", up),
              "cpu": trainer("cpu", forced),
              "CPU one ulp up": trainer("cpu", forced, up),
              "f32": trainer("cpu", None)}
        for r in range(3):
            loss = {}
            for key, t in ts.items():
                with (widened_gemm(port) if key == "widened GEMM"
                      else contextlib.nullcontext()):
                    loss[key] = t.run_round().client_loss
            gap = param_dist((ts["cpu"].params,), (ts["f32"].params,))
            d = {k: param_dist((ts[k].params,), (ts[ref].params,))
                 for k, ref in pairs}
            if r == 0:
                first = max(first, d["tensor cores"],
                            abs(loss["tensor cores"] - loss["cpu"]))
            check(d["widened GEMM"] <= BF16_RULE_SHARE * gap,
                  f"fedavg kernel_bf16 with the GEMM widened, seed {seed}, "
                  f"round {r + 1}: {d['widened GEMM']:.3e} from the CPU, "
                  f"over {BF16_RULE_SHARE} of the bf16 vs f32 {gap:.3e}")
        for k in small:
            small[k].append(d[k] / gap)
    check(first <= 1e-3, f"fedavg kernel_bf16 first round {first:.3e} from "
          f"the CPU (trainer)")
    # phase 3d's configuration: one campaign of BF16_RULE_SEEDS a run
    kw = dict(rounds=3, seeds=BF16_RULE_SEEDS)
    card = run(policy="kernel_bf16", params=inits, **kw)
    with widened_gemm(port):
        wide = run(policy="kernel_bf16", params=inits, **kw)
    runs = {"tensor cores": card, "widened GEMM": wide,
            "card one ulp up": run(policy="kernel_bf16", params=ups, **kw),
            "cpu": run(device="cpu", policy=forced, params=inits, **kw),
            "CPU one ulp up": run(device="cpu", policy=forced, params=ups,
                                  **kw)}
    f32 = run(device="cpu", params=inits, **kw)
    card_f32 = run(params=inits, **kw)
    full = {k: [] for k, _ in pairs}
    f32_dist = []
    for i in range(len(BF16_RULE_SEEDS)):
        gap = param_dist(runs["cpu"].params_for(i), f32.params_for(i))
        for k, ref in pairs:
            full[k].append(param_dist(runs[k].params_for(i),
                                      runs[ref].params_for(i)) / gap)
        f32_dist.append(param_dist(card_f32.params_for(i), f32.params_for(i)))

    def row(d):
        return "; ".join(f"{k} [{', '.join(f'{v:.2f}' for v in vs)}]"
                         for k, vs in d.items())
    print(f"fedavg kernel_bf16, seeds {list(BF16_RULE_SEEDS)}, three rounds "
          f"at the CPU test's configuration (M 12, 32 samples a client, E "
          f"3; trainers): first round {first:.3e} from the CPU (tol 1e-3); "
          f"after three rounds, over the CPU's bf16 vs f32 distance: "
          f"{row(small)} (widened GEMM: tol {BF16_RULE_SHARE} each round)")
    print(f"fedavg kernel_bf16, seeds {list(BF16_RULE_SEEDS)}, three rounds "
          f"at phase 3d's configuration (not checked): {row(full)}; f32 "
          f"card vs CPU [{', '.join(f'{v:.1e}' for v in f32_dist)}]")
    return {"bf16_rule_first_round": first, "bf16_rule_small": small,
            "bf16_rule_full": full, "f32_card_cpu_3_rounds": f32_dist}


GUARD_FLAGS = ("skipped_per_round", "quorum_per_round", "crashed_per_round")


def campaign_diffs(port, a, b):
    """Two campaigns' max param, loss and error-feedback state differences,
    and whether their guard flags (None without guards) are equal."""
    import numpy as np
    perr, lerr = campaign_max_diff(a, b)
    qerr = max([float((u - v).abs().max()) for u, v in zip(
        port.quantcomm.tree_leaves(a.qstate),
        port.quantcomm.tree_leaves(b.qstate))], default=0.0)
    flags = all(np.array_equal(getattr(a, f), getattr(b, f))
                for f in GUARD_FLAGS)
    return perr, lerr, qerr, flags


def graphed_vs_eager(torch, port, res, eager, label: str,
                     other: str = "eager"):
    """Check two campaigns equal bit for bit (params, losses, EF state,
    guard flags)."""
    perr, lerr, qerr, flags = campaign_diffs(port, res, eager)
    print(f"{label}: graphed vs {other}: max param diff {perr:.3e}, loss "
          f"{lerr:.3e}, error-feedback state {qerr:.3e}, flags equal "
          f"{flags}")
    check(perr == lerr == qerr == 0.0 and flags,
          f"{label}: graphed and {other} campaigns differ")


def baselines_phase(torch, port, clients, test):
    """Phase 3d: the paper's framework comparison; returns each
    framework's numbers."""
    import numpy as np
    camp = port.campaign
    S, n_test = len(CAMPAIGN_SEEDS), len(test[1])
    port.kl_ops.launches = port.kl_ops.launches_bwd = 0
    port.rg_ops.launches = 0
    out = {}

    def campaign(name, kw, device="cuda", rounds=BASELINE_ROUNDS,
                 seeds=CAMPAIGN_SEEDS, **more):
        return camp.run_campaign(
            name, port.DNN10, port.SystemParams(seed=0), clients,
            rounds=rounds, seeds=seeds, test_data=test, device=device,
            **kw, **more)

    for name, kw in BASELINES:
        run = functools.partial(campaign, name, kw)
        graphed = functools.partial(run, eval_every=CAMPAIGN_EVAL_EVERY)
        camp.HOST_TRANSFERS = 0
        res, call_ms = timed(torch, lambda: graphed(strict_transfers=True))
        check(camp.HOST_TRANSFERS == 1,
              f"{name}: {camp.HOST_TRANSFERS} host transfers")
        shapes = res.graphs["shapes"]
        check(res.graphs["graphs"] == len(shapes) + 1,
              f"{name}: one graph per shape + eval")
        check(bool(np.isfinite(res.losses).all()), f"{name}: non-finite loss")
        print(f"{name} ({kw}): {len(shapes)} round shapes "
              + ", ".join(f"({kb}, {eb}) x{len(rs)}"
                          for (kb, eb), rs in shapes.items())
              + f"; {res.graphs['graphs']} graphs, capture "
              f"{res.graphs['capture_s']:.3f} s; HOST_TRANSFERS "
              f"{camp.HOST_TRANSFERS} under strict_transfers")
        g_ms, e_ms, whole = [], [], []
        shape, window = steady_window(shapes, BASELINE_ROUNDS,
                                      CAMPAIGN_EVAL_EVERY)
        check(len(window) >= BASELINE_MIN_WINDOW,
              f"{name}: steady window {window}")
        steady = [r for r in shapes[shape][1:]
                  if (r + 1) % CAMPAIGN_EVAL_EVERY]
        for turn in range(BASELINE_TURNS):
            g = graphed() if turn else res
            e = run(scan=False)
            if turn == 0:
                graphed_vs_eager(torch, port, g, e, name)
            _, ev_ms = timed(torch, lambda: camp.evaluate_campaign(
                e, port.DNN10, test))
            g_ms.append(statistics.median(g.round_ms[steady]))
            e_ms.append(statistics.median(e.round_ms[steady]))
            whole.append((float(sum(g.round_ms)),
                          float(sum(e.round_ms)) + ev_ms))
        pwall, busy, ops, _, _ = profiled_campaign(torch, camp, window,
                                                   graphed)
        perr, lerr, aerr, units = short_card_vs_cpu(torch, run, n_test)
        acc = res.accuracy
        v = out[name] = {
            "K_E": kw, "shapes": len(shapes), "graphs": res.graphs["graphs"],
            "capture_s": res.graphs["capture_s"], "steady_shape": list(shape),
            "round_ms": statistics.median(g_ms),
            "eager_round_ms": statistics.median(e_ms),
            "whole_ms": statistics.median(w[0] for w in whole),
            "eager_whole_ms": statistics.median(w[1] for w in whole),
            "call_ms": call_ms, "profiled_round_ms": pwall, "busy_ms": busy,
            "idle_share": 1 - busy / pwall, "ops_per_round": ops,
            "accuracy_mean": float(acc.mean()),
            "accuracy_std": float(acc.std()),
            "comm_mb": sum(m.comm_bits for m in res.metrics) / 8e6,
            "sim_time_s": sum(m.sim_time for m in res.metrics),
            "cost": sum(m.cost for m in res.metrics),
            "card_cpu_rounds": BASELINE_CMP_ROUNDS,
            "card_cpu_param_diff": perr, "card_cpu_loss_diff": lerr,
            "card_cpu_acc_samples": aerr,
            "card_cpu_flipped_units": units}
        if name == "fedavg":
            whole_cpu = run(device="cpu", eval_every=CAMPAIGN_EVAL_EVERY)
            wp, wl, wa, _ = card_vs_cpu_campaign(torch, res, whole_cpu,
                                                 n_test)
            spread = ulp_spread(torch, port, graphed, name)
            v.update(whole_card_cpu_param_diff=wp, whole_card_cpu_loss_diff=wl,
                     whole_card_cpu_acc_samples=wa, card_ulp_spread=spread)
            print(f"{name}: the whole {BASELINE_ROUNDS} rounds, card vs CPU "
                  f"(not checked): max param diff {wp:.3e}, loss {wl:.3e}, "
                  f"accuracy {wa:.0f} of {n_test} samples apart; on the "
                  f"card, every initial weight one ulp up: max param diff "
                  f"{spread:.3e}")
        print(f"{name}: steady ({shape[0]}, {shape[1]}) round of {S} seeds "
              f"graphed {v['round_ms']:.3f} ms, eager "
              f"{v['eager_round_ms']:.3f} ms "
              f"({v['eager_round_ms'] / v['round_ms']:.1f}x; medians of "
              f"{BASELINE_TURNS}); whole {BASELINE_ROUNDS} rounds graphed "
              f"{v['whole_ms']:.1f} ms (capture and evaluations included; "
              f"call {call_ms:.1f} ms), eager {v['eager_whole_ms']:.1f} ms "
              f"with its post-hoc evaluation; profiled rounds "
              f"{window[0]}-{window[-1]}: wall {pwall:.3f} ms a round, busy "
              f"{busy:.3f} ms, idle share {v['idle_share']:.4f}, {ops:.1f} "
              f"device operations a round")
        print(f"{name}: card (graphed) vs CPU, {S} seeds, the first "
              f"{BASELINE_CMP_ROUNDS} rounds: max param diff {perr:.3e} "
              f"(beyond {CARD_CPU_TOL} in {units} units of a seed at most; "
              f"tol {FLIP_TOL} in at most {FLIP_UNITS}), loss {lerr:.3e} (tol "
              f"{CARD_CPU_TOL}); accuracy {aerr:.0f} of {n_test} test "
              f"samples apart (tol {CMP_ACC_SAMPLES}); final accuracy "
              f"{v['accuracy_mean']:.3f} +- {v['accuracy_std']:.3f} "
              f"({[round(float(a), 4) for a in acc]}), comm "
              f"{v['comm_mb']:.1f} MB, sim time {v['sim_time_s']:.3f} s, "
              f"cost {v['cost']:.3f}")
        check_card_cpu_flips(name, perr, lerr, aerr, units)
        torch.cuda.empty_cache()

    # FedAvg under the bf16 policy and the int8 wire: one turn each
    forced = port.dispatch.KernelPolicy(precision=port.dispatch.BF16)
    name, kw = BASELINES[0]
    run = functools.partial(campaign, name, kw)
    for label, opts, tol, cmp_rounds in BASELINE_VARIANTS:
        camp.HOST_TRANSFERS = 0
        res, wall = timed(torch, lambda: run(
            eval_every=CAMPAIGN_EVAL_EVERY, strict_transfers=True, **opts))
        check(camp.HOST_TRANSFERS == 1,
              f"{name} {label}: {camp.HOST_TRANSFERS} host transfers")
        check(bool(np.isfinite(res.losses).all()),
              f"{name} {label}: non-finite loss")
        eager = run(scan=False, **opts)
        graphed_vs_eager(torch, port, res, eager, f"{name} {label}")
        more = dict(opts, cpu_policy=forced) if "policy" in opts else opts
        perr, lerr, aerr, _ = short_card_vs_cpu(torch, run, n_test,
                                                rounds=cmp_rounds, **more)
        shapes = res.graphs["shapes"]
        shape = max(shapes, key=lambda s: len(shapes[s]))
        steady = [r for r in shapes[shape][1:]
                  if (r + 1) % CAMPAIGN_EVAL_EVERY]
        out[f"{name} {label}"] = {
            "round_ms": statistics.median(res.round_ms[steady]),
            "whole_ms": float(sum(res.round_ms)), "call_ms": wall,
            "eager_whole_ms": float(sum(eager.round_ms)),
            "card_cpu_rounds": cmp_rounds,
            "card_cpu_param_diff": perr, "card_cpu_loss_diff": lerr,
            "card_cpu_acc_samples": aerr}
        print(f"{name} {label}: steady round "
              f"{out[f'{name} {label}']['round_ms']:.3f} ms, whole "
              f"{sum(res.round_ms):.1f} ms; card vs CPU over the first "
              f"{cmp_rounds} rounds: max param diff "
              f"{perr:.3e}, loss {lerr:.3e} (tol {tol}), accuracy {aerr:.0f} "
              f"of {n_test} samples apart (tol {CMP_ACC_SAMPLES_MIXED})")
        check(perr <= tol and lerr <= tol,
              f"{name} {label}: card and CPU disagree")
        check(aerr <= CMP_ACC_SAMPLES_MIXED + 1e-6,
              f"{name} {label}: accuracy on the card and CPU disagree")
        if "policy" in opts:
            out[f"{name} {label}"].update(bf16_rule(torch, port, run))
    after = {"kl_mutual": port.kl_ops.launches,
             "kl_mutual (backward)": port.kl_ops.launches_bwd,
             "ridge_gram": port.rg_ops.launches}
    print(f"baselines: KL and Gram launch counters through the five "
          f"campaigns and FedAvg's variants: {after}")
    check(all(v == 0 for v in after.values()),
          f"a baseline campaign launched a SplitMe kernel {after}")
    return out


def scenario_phase(torch, port, clients, test):
    """Phase 3e: SCENARIO_RUNS graphed against eager (bit for bit) and
    against the CPU; round shapes, graphs, capture seconds and the whole
    campaign graphed and eager."""
    import numpy as np
    camp = port.campaign
    n_test = len(test[1])
    out = {}
    for name, scenario, rounds, kw in SCENARIO_RUNS:
        def run(device="cuda", rounds=rounds, **more):
            return camp.run_campaign(
                name, port.DNN10, port.SystemParams(seed=0), clients,
                rounds=rounds, seeds=CAMPAIGN_SEEDS, test_data=test,
                scenario=scenario, eval_gamma=CMP_EVAL_GAMMA, device=device,
                **kw, **more)
        label = f"{name} under {scenario!r}"
        camp.HOST_TRANSFERS = 0
        res, call_ms = timed(torch, lambda: run(
            eval_every=CAMPAIGN_EVAL_EVERY, strict_transfers=True))
        check(camp.HOST_TRANSFERS == 1,
              f"{label}: {camp.HOST_TRANSFERS} host transfers")
        check(bool(np.isfinite(res.losses).all()), f"{label}: non-finite loss")
        shapes = res.graphs["shapes"]
        check(res.graphs["graphs"] == len(shapes) + 1,
              f"{label}: one graph per shape + eval")
        check(res.schedule.trace is not None
              and not res.schedule.trace.is_static(), f"{label}: no trace")
        eager, e_call = timed(torch, lambda: run(scan=False))
        graphed_vs_eager(torch, port, res, eager, label)
        cmp_rounds = (SCENARIO_CMP_ROUNDS if name == "splitme"
                      else BASELINE_CMP_ROUNDS)
        perr, lerr, aerr, units = short_card_vs_cpu(torch, run, n_test,
                                                    rounds=cmp_rounds)
        v = out[label] = {
            "rounds": rounds, "shapes": len(shapes),
            "graphs": res.graphs["graphs"],
            "capture_s": res.graphs["capture_s"],
            "whole_ms": float(sum(res.round_ms)), "call_ms": call_ms,
            "eager_whole_ms": float(sum(eager.round_ms)),
            "eager_call_ms": e_call,
            "selected": res.schedule.a.sum(1).astype(int).tolist(),
            "accuracy_mean": float(res.accuracy.mean()),
            "card_cpu_rounds": cmp_rounds,
            "card_cpu_param_diff": perr, "card_cpu_loss_diff": lerr,
            "card_cpu_acc_samples": aerr,
            "card_cpu_flipped_units": units}
        print(f"{label}: {rounds} rounds, {len(shapes)} round shapes "
              + ", ".join(f"({kb}, {eb}) x{len(rs)}"
                          for (kb, eb), rs in shapes.items())
              + f"; {v['graphs']} graphs, capture {v['capture_s']:.3f} s; "
              f"whole campaign graphed {v['whole_ms']:.1f} ms (call "
              f"{call_ms:.1f} ms), eager {v['eager_whole_ms']:.1f} ms of "
              f"rounds (call {e_call:.1f} ms): "
              f"{v['eager_whole_ms'] / v['whole_ms']:.2f}x; selected per "
              f"round {v['selected']}")
        print(f"{label}: card (graphed) vs CPU over {cmp_rounds} rounds: "
              f"max param diff {perr:.3e} (beyond {CARD_CPU_TOL} in {units} "
              f"units of a seed at most; tol {FLIP_TOL} in at most "
              f"{FLIP_UNITS}), loss {lerr:.3e} (tol {CARD_CPU_TOL}); accuracy {aerr:.0f} "
              f"of {n_test} test samples apart (tol {CMP_ACC_SAMPLES}, gamma "
              f"{CMP_EVAL_GAMMA}); final accuracy {v['accuracy_mean']:.3f}")
        check_card_cpu_flips(label, perr, lerr, aerr, units)
        torch.cuda.empty_cache()
    return out


# fault channels and guards (phase 3f): the campaign of phase 3b (DNN10 at
# full width, SystemParams(), M 50, 96 samples a client, 30 rounds, seeds
# 0-3, Step 4 every 10 rounds, here at CMP_EVAL_GAMMA throughout, as its
# card-vs-CPU run) under FAULT_SCENARIO from scenario seed FAULT_SEED, the
# guards armed by the faults: strict transfers and one host transfer; its
# graphs against the same round bodies run without capture, bit for bit
# (params, NaN crash rows, guard flags); rollbacks counted, NaN loss rows on
# exactly the trace's crash rounds, finite params; against the CPU, the
# flags and crash rows of all rounds exactly and params, losses and
# accuracy by phase 3e's gates over the rounds before the first wire flip
# lands (no default guard bounds a x2^12 update, and the trajectory turns
# chaotic; the whole campaign's difference is printed beside the card's own
# one-ulp spread), and by the same gates over all its rounds, rollbacks and
# crash holds included, under the per-client norm clip FAULT_CLIP, which
# keeps the trajectory bounded (it lies above every clean update's norm:
# up to the first flip, the clipped run's losses are the unclipped run's);
# the steady round's ms (medians of CAMPAIGN_TURNS turns), operations and
# idle share, and the KL and Gram launches inside its graphs, beside phase
# 3b's.  Then one run each: the same campaign on the int8 wire (graphed
# against uncaptured, the error-feedback state included), the guards-off
# control under FAULT_OFF (its params go non-finite), FedAvg (phase 3d's K
# and E) under a wire flip of every client in round WIRE_FLIP_ROUND (the
# norm clip keeps it closer to the clean run than no clip, with no
# rollback) and FedAvg with a quorum above M (its params never move).
FAULT_SCENARIO, FAULT_SEED = "faults:0.3", 0
FAULT_OFF = "faults:0.9"
FAULT_CLIP = 1.0
WIRE_FLIP_ROUND, WIRE_ROUNDS, QUORUM_ROUNDS = 2, 8, 4
# the CPU sides of 3f (the flags of the unclipped campaign, the clipped
# campaign card against CPU) over the first FAULT_CMP_ROUNDS rounds, each
# side its own campaign of them (a depth cut: the script's time)
FAULT_CMP_ROUNDS = 10
# checkpoints (phase 3g): 3f's campaign saved every CKPT_EVERY rounds and
# aborted by its checkpoint hook at cursor CKPT_ABORT, then resumed
CKPT_EVERY, CKPT_ABORT = 10, 20


def fault_phase(torch, port, sp, clients, test, base):
    """Phase 3f; ``base`` is phase 3b's summary.  Returns its numbers and
    the run a resumed campaign must equal, with its keywords."""
    import numpy as np
    camp, kl_ops, rg_ops = port.campaign, port.kl_ops, port.rg_ops
    S, n_test = len(CAMPAIGN_SEEDS), len(test[1])
    kw = dict(rounds=CAMPAIGN_ROUNDS, seeds=CAMPAIGN_SEEDS, test_data=test,
              eval_every=CAMPAIGN_EVAL_EVERY, eval_gamma=CMP_EVAL_GAMMA,
              scenario=FAULT_SCENARIO, scenario_seed=FAULT_SEED)

    def run(device="cuda", **more):
        return camp.run_campaign("splitme", port.DNN10, sp, clients,
                                 device=device, **dict(kw, **more))

    label = f"splitme under {FAULT_SCENARIO!r}"
    kl_ops.launches = kl_ops.launches_bwd = rg_ops.launches = 0
    camp.HOST_TRANSFERS = 0
    res, call_ms = timed(torch, lambda: run(strict_transfers=True))
    counters = {"kl_mutual": kl_ops.launches,
                "kl_mutual (backward)": kl_ops.launches_bwd,
                "ridge_gram": rg_ops.launches}
    check(camp.HOST_TRANSFERS == 1,
          f"{label}: {camp.HOST_TRANSFERS} host transfers")
    shapes = res.graphs["shapes"]
    check(res.graphs["graphs"] == len(shapes) + 1,
          f"{label}: one graph per shape + eval")
    crashed = np.asarray(res.schedule.trace.crash) > 0
    nan_rows = np.isnan(res.losses).all(axis=(0, 2))
    finite = all(bool(torch.isfinite(v).all())
                 for v in port.quantcomm.tree_leaves(res.params))
    big = max(float(v.abs().max())
              for v in port.quantcomm.tree_leaves(res.params))
    print(f"{label}: {len(shapes)} round shapes, {res.graphs['graphs']} "
          f"graphs, capture {res.graphs['capture_s']:.3f} s, call "
          f"{call_ms:.1f} ms, HOST_TRANSFERS {camp.HOST_TRANSFERS} under "
          f"strict_transfers; launch counters (warm-ups and captures) "
          f"{counters}; skipped_rounds {res.skipped_rounds} (per round "
          f"{res.skipped_per_round.sum(1).astype(int).tolist()}), "
          f"quorum_rounds {res.quorum_rounds}, crashed_rounds "
          f"{res.crashed_rounds} at {np.flatnonzero(crashed).tolist()}, "
          f"NaN loss rows at {np.flatnonzero(nan_rows).tolist()}, "
          f"non-finite losses elsewhere "
          f"{int((~np.isfinite(res.losses[:, ~crashed])).sum())}; params "
          f"finite {finite}, largest |param| {big:.4e}")
    check(all(v > 0 for v in counters.values()),
          f"{label}: a kernel of the path never launched {counters}")
    check(res.skipped_rounds > 0, f"{label}: no round rolled back")
    check(res.crashed_rounds == int(crashed.sum())
          and nan_rows.tolist() == crashed.tolist(),
          f"{label}: crash rounds and NaN loss rows differ")
    check(finite, f"{label}: non-finite params")
    graphed_vs_eager(torch, port, res, run(_graphs=False), label,
                     "uncaptured")

    # the steady round (medians of CAMPAIGN_TURNS turns) and the launches
    # inside the graphs, by name in the profiler
    steady_shape = max(shapes, key=lambda s: len(shapes[s]))
    steady = [r for r in shapes[steady_shape][1:]
              if (r + 1) % CAMPAIGN_EVAL_EVERY]
    g_ms = [statistics.median(res.round_ms[steady])]
    for _ in range(CAMPAIGN_TURNS - 1):
        g_ms.append(statistics.median(run().round_ms[steady]))
    win = steady_and_eval_windows(torch, run)
    evts, wall = win["steady"]
    busy, n_ops, per = campaign_window(torch, evts, len(PROFILE_STEADY))
    wall /= len(PROFILE_STEADY)
    _, _, per_e = campaign_window(torch, win["eval"][0], 1)
    launches = {k: v[0] for k, v in per.items()}
    launches_e = {k: v[0] for k, v in per_e.items()}
    out = {"round_ms": statistics.median(g_ms), "ops_per_round": n_ops,
           "idle_share": 1 - busy / wall, "graphs": res.graphs["graphs"],
           "capture_s": res.graphs["capture_s"], "call_ms": call_ms,
           "whole_ms": float(sum(res.round_ms)),
           "launches_per_round": launches,
           "launches_per_eval_round": launches_e,
           "skipped_rounds": res.skipped_rounds,
           "crashed_rounds": res.crashed_rounds}
    for name, v in (("phase 3b", base), ("phase 3f", out)):
        print(f"{name}: steady ({steady_shape[0]}, {steady_shape[1]}) round "
              f"of {S} seeds graphed {v['round_ms']:.3f} ms (medians of "
              f"{CAMPAIGN_TURNS}), {v['ops_per_round']:.1f} device "
              f"operations a round, idle share {v['idle_share']:.4f}; "
              f"launches a steady round {v['launches_per_round']}, an "
              f"evaluating round {v['launches_per_eval_round']}; "
              f"{v['graphs']} graphs, capture {v['capture_s']:.3f} s")
    check(launches == base["launches_per_round"]
          and launches_e == base["launches_per_eval_round"]
          and launches["kl_mutual"] > 0 and launches_e["ridge_gram"] > 0,
          f"{label}: in-graph launches {launches} / {launches_e} differ "
          f"from phase 3b's")

    # the card against the CPU: the flags and crash rows of the whole
    # campaign exactly; params, losses and accuracy by phase 3e's gates over
    # the rounds before the first wire flip lands (no default guard clips
    # it: a x2^12 update makes the trajectory chaotic, and the whole
    # campaign's difference is printed beside the card's own under a one-ulp
    # change of the initial weights, as phase 3d does for FedAvg)
    R = FAULT_CMP_ROUNDS
    cpu = run(device="cpu", rounds=R)
    card_r = run(rounds=R)
    flags = all(np.array_equal(getattr(card_r, f), getattr(cpu, f))
                for f in GUARD_FLAGS)
    nan_same = bool((np.isnan(card_r.losses)
                     == np.isnan(cpu.losses)).all())
    trace, a = res.schedule.trace, res.schedule.a
    flipped = (((trace.wire_gain != 1.0) & (a > 0)).any(axis=1)
               & (trace.crash <= 0))
    first = int(np.argmax(flipped)) if flipped.any() else CAMPAIGN_ROUNDS
    wp, wl = campaign_max_diff(card_r, cpu)
    spread = ulp_spread(torch, port, run, "splitme")
    print(f"{label}: card vs CPU over the first {R} rounds: flags equal "
          f"{flags}, NaN loss entries equal {nan_same}; max param diff "
          f"{wp:.3e}, loss {wl:.3e} (not checked: the first wire flip "
          f"lands in round {first}); on the card, every initial weight one "
          f"ulp up: max param diff {spread:.3e}")
    check(flags and nan_same, f"{label}: card and CPU guard flags differ")
    check(first > 0, f"{label}: a wire flip lands in round 0")
    perr, lerr, aerr, units = short_card_vs_cpu(
        torch, functools.partial(run, scenario=trace), n_test, rounds=first)
    out.update(card_cpu_rounds=first, card_cpu_param_diff=perr,
               card_cpu_loss_diff=lerr, card_cpu_acc_samples=aerr,
               card_cpu_flipped_units=units, flags_card_cpu_rounds=R,
               card_cpu_param_diff_r=wp, card_cpu_loss_diff_r=wl,
               card_ulp_spread=spread)
    print(f"{label}: card (graphed) vs CPU over the first {first} rounds: "
          f"max param diff {perr:.3e} (beyond {CARD_CPU_TOL} in {units} "
          f"units of a seed at most; tol {FLIP_TOL} in at most "
          f"{FLIP_UNITS}), loss {lerr:.3e} (tol {CARD_CPU_TOL}); accuracy "
          f"{aerr:.0f} of {n_test} test samples apart (tol "
          f"{CMP_ACC_SAMPLES}, gamma {CMP_EVAL_GAMMA})")
    check_card_cpu_flips(label, perr, lerr, aerr, units)

    # the clipped campaign, card against CPU over its first R rounds
    clipped = functools.partial(
        run, scenario=trace, eval_every=1, rounds=R,
        guards=port.RoundGuards(clip_norm=FAULT_CLIP))
    card_c, cpu_c = clipped(), clipped(device="cpu")
    flags_c = all(np.array_equal(getattr(card_c, f), getattr(cpu_c, f))
                  for f in GUARD_FLAGS)
    perr, lerr, aerr, units = card_vs_cpu_campaign(torch, card_c, cpu_c,
                                                   n_test)
    label_c = f"{label}, clip_norm {FAULT_CLIP}"
    pre_a, pre_b = res.losses[:, :first + 1], card_c.losses[:, :first + 1]
    pre_nan = bool((np.isnan(pre_a) == np.isnan(pre_b)).all())
    pre = float(np.abs(pre_a - pre_b)[~np.isnan(pre_a)].max(initial=0.0))
    print(f"{label_c}: losses of rounds 0-{first} against the unclipped "
          f"run's: max diff {pre:.3e}, NaN rows equal {pre_nan}")
    check(pre_nan and pre <= CARD_CPU_TOL,
          f"{label_c}: the clip changed an update before the first flip")
    print(f"{label_c}: card (graphed) vs CPU over the first {R} rounds: "
          f"flags equal {flags_c}; skipped_rounds "
          f"{card_c.skipped_rounds}, crashed_rounds {card_c.crashed_rounds}; "
          f"max param diff {perr:.3e} (beyond {CARD_CPU_TOL} in {units} "
          f"units of a seed at most; tol {FLIP_TOL} in at most "
          f"{FLIP_UNITS}), loss {lerr:.3e} (tol {CARD_CPU_TOL}); accuracy "
          f"{aerr:.0f} of {n_test} test samples apart (tol "
          f"{CMP_ACC_SAMPLES}, gamma {CMP_EVAL_GAMMA})")
    check(flags_c, f"{label_c}: card and CPU guard flags differ")
    check(card_c.skipped_rounds > 0
          and card_c.crashed_rounds == int(crashed[:R].sum()),
          f"{label_c}: no rollback, or the crash rounds differ")
    check_card_cpu_flips(label_c, perr, lerr, aerr, units)
    out.update(clip_card_cpu_param_diff=perr, clip_card_cpu_loss_diff=lerr,
               clip_card_cpu_acc_samples=aerr,
               clip_card_cpu_flipped_units=units,
               clip_skipped_rounds=card_c.skipped_rounds)

    # the int8 wire: graphed against uncaptured, the EF state included
    r8 = run(quant="int8", strict_transfers=True)
    check(len(port.quantcomm.tree_leaves(r8.qstate)) > 0,
          "int8 wire: no error-feedback state")
    graphed_vs_eager(torch, port, r8, run(quant="int8", _graphs=False),
                     f"{label}, int8 wire", "uncaptured")
    out["int8_skipped_rounds"] = r8.skipped_rounds

    # the control: the guards off under FAULT_OFF
    off = run(scenario=FAULT_OFF, guards=False)
    off_finite = all(bool(torch.isfinite(v).all())
                     for v in port.quantcomm.tree_leaves(off.params))
    print(f"splitme under {FAULT_OFF!r} with guards=False: params finite "
          f"{off_finite}, flags {off.skipped_per_round}")
    check(not off_finite and off.skipped_per_round is None,
          "the guards-off control kept finite params")

    # FedAvg: a wire flip of every client in one round, and a quorum of M+1
    M = sp.M
    ones = np.ones((WIRE_ROUNDS, M))
    wire = ones.copy()
    wire[WIRE_FLIP_ROUND] = port.scenario.WIRE_FLIP_GAIN
    flip = port.scenario.ScenarioTrace(
        name="wireflip", seed=0, gain=ones, qc_scale=ones, qs_scale=ones,
        avail=ones, drop=ones, deadline_scale=ones, wire_gain=wire)
    K, E = dict(BASELINES)["fedavg"]["K"], dict(BASELINES)["fedavg"]["E"]

    def fedavg(rounds=WIRE_ROUNDS, **more):
        return camp.run_campaign("fedavg", port.DNN10,
                                 port.SystemParams(seed=0), clients,
                                 rounds=rounds, seeds=CAMPAIGN_SEEDS, K=K,
                                 E=E, device="cuda", **more)
    clean = fedavg()
    clipped = fedavg(scenario=flip, guards=port.RoundGuards(clip_norm=1.0))
    raw = fedavg(scenario=flip, guards=port.RoundGuards())

    def dist(a, b):
        return sum(float((u - v).abs().sum()) for u, v in zip(
            port.quantcomm.tree_leaves(a.params),
            port.quantcomm.tree_leaves(b.params)))
    d_clip, d_raw = dist(clipped, clean), dist(raw, clean)
    print(f"fedavg, every client's upload x{port.scenario.WIRE_FLIP_GAIN:g} "
          f"in round {WIRE_FLIP_ROUND}: L1 distance to the clean run with "
          f"the norm clip 1.0 {d_clip:.4e}, without {d_raw:.4e}; rollbacks "
          f"{clipped.skipped_rounds} / {raw.skipped_rounds}")
    check(clipped.skipped_rounds == 0 and 0 < d_clip < d_raw,
          "the norm clip does not bound the wire flip")
    held = fedavg(rounds=QUORUM_ROUNDS,
                  guards=port.RoundGuards(min_clients=M + 1))
    init = initial_params(torch, port, "fedavg", CAMPAIGN_SEEDS)
    same = all(torch.equal(p[k].cpu(), q[k])
               for i in range(len(CAMPAIGN_SEEDS))
               for hp, hq in zip(held.params_for(i), init[i])
               for p, q in zip(hp, hq) for k in p)
    print(f"fedavg with min_clients {M + 1}: quorum_rounds "
          f"{held.quorum_rounds} of {QUORUM_ROUNDS} x {S}, params at their "
          f"initial values {same}")
    check(same and held.quorum_rounds == QUORUM_ROUNDS * S
          and held.skipped_rounds == 0, "the quorum hold moved the params")
    out.update(wire_flip_d_clip=d_clip, wire_flip_d_raw=d_raw)
    torch.cuda.empty_cache()
    return out, res, dict(kw, device="cuda")


def checkpoint_phase(torch, port, sp, clients, ref, kw):
    """Phase 3g: 3f's campaign (``run_campaign`` keywords ``kw``)
    checkpointed every CKPT_EVERY rounds and aborted at CKPT_ABORT, resumed
    with ``resume_campaign``, against ``ref`` (3f's uninterrupted run) bit
    for bit; then the SIGKILL check on the card."""
    import tempfile
    camp, res_mod, io = port.campaign, port.resilience, port.ckpt_io
    saves, restores = [], []

    def timed_call(fn, into):
        def wrapped(*a, **k):
            torch.cuda.synchronize()        # the queued rounds first
            t0 = time.perf_counter()
            out = fn(*a, **k)
            into.append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapped

    def abort(cursor):
        if cursor >= CKPT_ABORT:
            raise res_mod.CampaignAborted(f"abort at round {cursor}")

    save, restore = res_mod.save_checkpoint, io.restore
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        res_mod.save_checkpoint = timed_call(save, saves)
        io.restore = timed_call(restore, restores)
        try:
            try:
                camp.run_campaign("splitme", port.DNN10, sp, clients,
                                  checkpoint_every=CKPT_EVERY,
                                  checkpoint_dir=d, _checkpoint_hook=abort,
                                  **kw)
                aborted = False
            except res_mod.CampaignAborted:
                aborted = True
            latest = res_mod.latest_checkpoint(d)
            n_saved = len(saves)
            resumed = res_mod.resume_campaign(
                "splitme", port.DNN10, sp, clients, checkpoint_dir=d,
                checkpoint_every=CKPT_EVERY, **kw)
        finally:
            res_mod.save_checkpoint, io.restore = save, restore
        size = sum(f.stat().st_size for f in Path(d).iterdir())
    check(n_saved == CKPT_ABORT // CKPT_EVERY
          and len(saves) == CAMPAIGN_ROUNDS // CKPT_EVERY
          and len(restores) == 1,
          f"checkpoints: {len(saves)} saves ({n_saved} before the abort) "
          f"and {len(restores)} restores timed")
    check(aborted and latest is not None
          and latest.name == res_mod.checkpoint_tag(CKPT_ABORT),
          f"checkpoint abort at {CKPT_ABORT}: aborted {aborted}, latest "
          f"{latest}")
    perr, lerr, qerr, flags = campaign_diffs(port, resumed, ref)
    metrics = [repr(m) for m in resumed.metrics] == [repr(m)
                                                     for m in ref.metrics]
    print(f"checkpoints every {CKPT_EVERY} rounds: saves "
          f"{[round(v, 3) for v in saves]} ms ({n_saved} before the abort at "
          f"{CKPT_ABORT}, then the resumed run's), {size / 1e6:.3f} MB on "
          f"disk; latest {latest.name}; restore "
          f"{[round(v, 3) for v in restores]} ms; the resumed run captured "
          f"{resumed.graphs['graphs']} graphs in "
          f"{resumed.graphs['capture_s']:.3f} s; resumed vs uninterrupted: "
          f"max param diff {perr:.3e}, loss {lerr:.3e}, error-feedback state "
          f"{qerr:.3e}, flags equal {flags}, metrics equal {metrics}")
    check(perr == lerr == qerr == 0.0 and flags and metrics,
          "the resumed campaign differs from the uninterrupted one")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "crash_resume_check_torch.py"),
         "--device", "cuda"], capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    print(f"scripts/crash_resume_check_torch.py --device cuda: exit "
          f"{proc.returncode} in {secs:.1f} s: "
          + " | ".join(proc.stdout.strip().splitlines()[-3:]))
    check(proc.returncode == 0,
          f"crash_resume_check_torch.py failed: {proc.stderr[-2000:]}")
    return {"save_ms": saves, "restore_ms": restores,
            "resumed_graphs": resumed.graphs["graphs"],
            "resumed_capture_s": resumed.graphs["capture_s"],
            "carry_mb_on_disk": size / 1e6, "crash_resume_check_s": secs}


# population mode (phase 3h): the README's population campaign at the
# example's sizes, SplitMe on DNN10 at full width over POP_SIZE virtual
# near-RT-RICs (Population(seed=0)), POP_COHORT sampled a round under
# POP_SCENARIO, 96 samples a client, 30 rounds, seeds 0-3, Step 4 every 10
# rounds and after the last, at CMP_EVAL_GAMMA throughout (as 3f): strict
# transfers and one host transfer; its graphs against the same round bodies
# run uncaptured, bit for bit; the card against the CPU by 3b's gates; the
# round shapes, graphs and capture seconds, the steady round's ms (medians
# of CAMPAIGN_TURNS turns), operations and idle share, the KL and Gram
# launches inside its graphs by name, and the whole campaign; the host
# plan's seconds and tracemalloc peak; the device's peak memory for the
# same campaign at POP_SMALL and POP_SIZE clients (within POP_MEM_RATIO);
# the full-population cohort (POP_FULL clients, cohort POP_FULL) against
# run_campaign on the same rows and shards; one int8-wire run graphed
# against uncaptured with its error-feedback state; and checkpoints every
# CKPT_EVERY rounds, an abort at CKPT_ABORT and a resume, bit for bit
POP_SIZE, POP_SMALL, POP_COHORT = 10 ** 6, 10 ** 4, 32
POP_SCENARIO, POP_SAMPLES, POP_FULL = "churn:0.5", 96, 50
POP_MEM_RATIO = 1.25


def population_phase(torch, port, data, test, base):
    """Phase 3h; ``data`` is the (X, y) pool the shards are drawn from and
    ``base`` phase 3b's summary.  Returns its numbers and the in-graph
    launches of the main-path kernels."""
    import gc
    import tempfile
    import tracemalloc
    import numpy as np
    camp, popn, kl_ops, rg_ops = (port.campaign, port.population,
                                  port.kl_ops, port.rg_ops)
    res_mod = port.resilience
    S, n_test = len(CAMPAIGN_SEEDS), len(test[1])
    kw = dict(rounds=CAMPAIGN_ROUNDS, seeds=CAMPAIGN_SEEDS,
              cohort=POP_COHORT, samples_per_client=POP_SAMPLES,
              test_data=test, eval_every=CAMPAIGN_EVAL_EVERY,
              eval_gamma=CMP_EVAL_GAMMA, scenario=POP_SCENARIO)
    label = (f"population {POP_SIZE}, cohort {POP_COHORT}, splitme under "
             f"{POP_SCENARIO!r}")

    def run(size=POP_SIZE, device="cuda", **more):
        return camp.run_population_campaign(
            "splitme", port.DNN10, popn.Population(size, seed=0), data,
            device=device, **dict(kw, **more))

    # the host plan alone: its seconds, then its tracemalloc peak
    plan_args = dict(cohort=POP_COHORT, n_samples_per_client=POP_SAMPLES,
                     scenario=POP_SCENARIO)
    t0 = time.perf_counter()
    sp, sched = camp.plan_population_schedule(
        "splitme", popn.Population(POP_SIZE, seed=0), port.DNN10,
        CAMPAIGN_ROUNDS, **plan_args)
    plan_s = time.perf_counter() - t0
    tracemalloc.start()
    camp.plan_population_schedule(
        "splitme", popn.Population(POP_SIZE, seed=0), port.DNN10,
        CAMPAIGN_ROUNDS, **plan_args)
    plan_peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    # the shards the campaign draws: each round's trained slots
    t0 = time.perf_counter()
    kb_r, _ = camp._round_shapes(sched, sp)
    for t in range(CAMPAIGN_ROUNDS):
        sel, _ = camp._cohort(sched.a[t], kb_r[t])
        popn.Population(POP_SIZE, seed=0).sample_shards(
            data[0], data[1], sched.ids[t, sel], POP_SAMPLES)
    shards_s = time.perf_counter() - t0
    print(f"{label}: host plan of {CAMPAIGN_ROUNDS} rounds {plan_s:.3f} s, "
          f"its shards {shards_s:.3f} s, "
          f"tracemalloc peak {plan_peak / 1e6:.3f} MB; cohort ids up to "
          f"{int(sched.ids.max())}, m_t {int(sched.m_t.min())}-"
          f"{int(sched.m_t.max())}, selected per round "
          f"{sched.a.sum(1).astype(int).tolist()}, E "
          f"{sched.E.tolist()}")
    check(sp.M == POP_COHORT and sched.ids.shape == (CAMPAIGN_ROUNDS,
                                                     POP_COHORT),
          f"{label}: the plan is not cohort-sized")

    # the main run: strict transfers, one host transfer, the device peak
    kl_ops.launches = kl_ops.launches_bwd = rg_ops.launches = 0
    camp.HOST_TRANSFERS = 0
    peaks = {}

    def peak_run(size, **more):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out, ms = timed(torch, lambda: run(size=size, **more))
        peaks[size] = (torch.cuda.max_memory_allocated(), before)
        return out, ms

    res, call_ms = peak_run(POP_SIZE, strict_transfers=True)
    counters = {"kl_mutual": kl_ops.launches,
                "kl_mutual (backward)": kl_ops.launches_bwd,
                "ridge_gram": rg_ops.launches}
    check(camp.HOST_TRANSFERS == 1,
          f"{label}: {camp.HOST_TRANSFERS} host transfers")
    shapes = res.graphs["shapes"]
    check(res.graphs["graphs"] == len(shapes) + 1,
          f"{label}: one graph per shape + eval")
    check(bool(np.isfinite(res.losses).all()), f"{label}: non-finite loss")
    check(bool(np.array_equal(res.schedule.ids, sched.ids))
          and bool(np.array_equal(res.schedule.a, sched.a)),
          f"{label}: the campaign's plan differs from the host plan's")
    print(f"{label}: {len(shapes)} round shapes "
          + ", ".join(f"({kb}, {eb}) x{len(rs)}"
                      for (kb, eb), rs in shapes.items())
          + f"; {res.graphs['graphs']} graphs, capture "
          f"{res.graphs['capture_s']:.3f} s; call {call_ms:.1f} ms "
          f"(host plan and shards included); HOST_TRANSFERS "
          f"{camp.HOST_TRANSFERS} under strict_transfers; launch counters "
          f"(warm-ups and captures) {counters}; final accuracy per seed "
          f"{[round(float(v), 4) for v in res.accuracy]}")
    check(all(v > 0 for v in counters.values()),
          f"{label}: a kernel of the path never launched {counters}")
    graphed_vs_eager(torch, port, res, run(_graphs=False), label,
                     "uncaptured")

    # the steady round (medians of CAMPAIGN_TURNS turns) and, under the
    # profiler, its operations, idle share and in-graph launches, and the
    # launches of an evaluating round
    steady_shape, window = steady_window(shapes, CAMPAIGN_ROUNDS,
                                         CAMPAIGN_EVAL_EVERY)
    check(len(window) >= 3, f"{label}: steady window {window}")
    eval_round = 2 * CAMPAIGN_EVAL_EVERY - 1
    g_ms = [statistics.median(res.round_ms[window])]
    whole = [float(sum(res.round_ms))]
    for _ in range(CAMPAIGN_TURNS - 1):
        again = run()
        g_ms.append(statistics.median(again.round_ms[window]))
        whole.append(float(sum(again.round_ms)))
    # steady_window leaves out the evaluating rounds: no overlap
    got = profiled_windows(torch, run, {"steady": window,
                                        "eval": [eval_round]})
    evts, wall = got["steady"]
    busy, n_ops, per = campaign_window(torch, evts, len(window))
    wall /= len(window)
    launches = {k: v[0] for k, v in per.items()}
    _, _, per_e = campaign_window(torch, got["eval"][0], 1)
    launches_e = {k: v[0] for k, v in per_e.items()}
    eb = steady_shape[1]
    out = {"round_ms": statistics.median(g_ms), "ops_per_round": n_ops,
           "idle_share": 1 - busy / wall, "steady_shape": list(steady_shape),
           "steady_rounds": window, "shapes": len(shapes),
           "graphs": res.graphs["graphs"],
           "capture_s": res.graphs["capture_s"], "call_ms": call_ms,
           "whole_ms": statistics.median(whole),
           "plan_s": plan_s, "shards_s": shards_s,
           "plan_peak_mb": plan_peak / 1e6,
           "launches_per_round": launches,
           "launches_per_eval_round": launches_e,
           "selected": res.schedule.a.sum(1).astype(int).tolist()}
    print(f"{label}: steady ({steady_shape[0]}, {eb}) round (rounds "
          f"{window[0]}-{window[-1]}) of {S} seeds graphed "
          f"{out['round_ms']:.3f} ms (medians of {CAMPAIGN_TURNS}: "
          f"{[round(v, 3) for v in g_ms]}), {n_ops:.1f} device operations "
          f"a round, idle share {out['idle_share']:.4f}; in-graph launches "
          f"a steady round {launches}, at the evaluating round {eval_round} "
          f"{launches_e}; whole campaign {out['whole_ms']:.1f} ms of rounds "
          f"(capture and evaluations included; medians of "
          f"{CAMPAIGN_TURNS}); phase 3b: ({base['launches_per_round']}) "
          f"{base['round_ms']:.3f} ms, {base['ops_per_round']:.1f} "
          f"operations, idle {base['idle_share']:.4f}")
    check(launches["kl_mutual"] == 2 * eb
          and launches["kl_mutual (backward)"] == 2 * eb
          and launches["ridge_gram"] == 0,
          f"{label}: steady round launches {launches} != 2 x E {eb} KL "
          f"forward and backward, no Gram")
    check(launches_e["ridge_gram"] == 8 * S,
          f"{label}: evaluating round launches {launches_e}: not 8 Gram "
          f"pairs a seed")

    # the card against the CPU by 3b's gates
    perr, lerr, aerr, _ = card_vs_cpu_campaign(torch, res, run(device="cpu"),
                                               n_test)
    print(f"{label}: card (graphed) vs CPU, {S} seeds, {CAMPAIGN_ROUNDS} "
          f"rounds: max param diff {perr:.3e}, loss {lerr:.3e} (tol "
          f"{CARD_CPU_TOL}); accuracy {aerr:.0f} of {n_test} test samples "
          f"apart (tol {CMP_ACC_SAMPLES}, gamma {CMP_EVAL_GAMMA})")
    check(perr <= CARD_CPU_TOL and lerr <= CARD_CPU_TOL
          and aerr <= CMP_ACC_SAMPLES + 1e-6,
          f"{label}: campaign on the card and on the CPU disagree")
    out.update(card_cpu_param_diff=perr, card_cpu_loss_diff=lerr,
               card_cpu_acc_samples=aerr)

    # the device peak at POP_SMALL clients against POP_SIZE's
    peak_run(POP_SMALL)
    (big, big0), (small, small0) = peaks[POP_SIZE], peaks[POP_SMALL]
    shards_gb = POP_SIZE * POP_SAMPLES * (data[0].shape[1] * 4 + 4) / 1e9
    print(f"{label}: torch.cuda.max_memory_allocated {big / 1e6:.2f} MB at "
          f"{POP_SIZE} clients ({(big - big0) / 1e6:.2f} MB above the "
          f"{big0 / 1e6:.2f} MB held before), {small / 1e6:.2f} MB at "
          f"{POP_SMALL} ({(small - small0) / 1e6:.2f} MB above "
          f"{small0 / 1e6:.2f}): {big / small:.3f}x (tol {POP_MEM_RATIO}); "
          f"a materialized {POP_SIZE}-client population's shards alone: "
          f"{shards_gb:.1f} GB")
    check(big <= POP_MEM_RATIO * small,
          f"{label}: the device peak grows with the population")
    out.update(peak_mb={str(k): v[0] / 1e6 for k, v in peaks.items()},
               peak_above_mb={str(k): (v[0] - v[1]) / 1e6
                              for k, v in peaks.items()})

    # the full-population cohort against the materialized campaign
    pop = popn.Population(POP_FULL, seed=0)
    ids = np.arange(POP_FULL)
    fkw = dict(rounds=CAMPAIGN_ROUNDS, seeds=CAMPAIGN_SEEDS, test_data=test,
               eval_every=CAMPAIGN_EVAL_EVERY, eval_gamma=CMP_EVAL_GAMMA,
               device="cuda")
    res_p = camp.run_population_campaign(
        "splitme", port.DNN10, pop, data, cohort=POP_FULL,
        samples_per_client=POP_SAMPLES, **fkw)
    res_m = camp.run_campaign(
        "splitme", port.DNN10, pop.system_params(ids),
        pop.sample_shards(data[0], data[1], ids, POP_SAMPLES), **fkw)
    same_plan = (bool(np.array_equal(res_p.schedule.a, res_m.schedule.a))
                 and res_p.schedule.E.tolist() == res_m.schedule.E.tolist())
    fp, fl = campaign_max_diff(res_p, res_m)
    fa = float(np.nanmax(np.abs(res_p.accuracy_per_round
                                - res_m.accuracy_per_round))) * n_test
    print(f"full population {POP_FULL}, cohort {POP_FULL} vs run_campaign "
          f"on the same rows and shards (card, graphed): schedules equal "
          f"{same_plan}; max param diff {fp:.3e}, loss {fl:.3e} (tol "
          f"{CARD_CPU_TOL}), accuracy {fa:.0f} test samples; bitwise "
          f"{fp == fl == fa == 0.0}")
    check(same_plan and fp <= CARD_CPU_TOL and fl <= CARD_CPU_TOL
          and fa <= CMP_ACC_SAMPLES + 1e-6,
          "the full-population cohort differs from the materialized "
          "campaign")
    out.update(full_population_param_diff=fp, full_population_loss_diff=fl,
               full_population_bitwise=fp == fl == fa == 0.0)

    # the int8 wire: graphed against uncaptured, the EF state included
    r8 = run(quant="int8", strict_transfers=True)
    check(len(port.quantcomm.tree_leaves(r8.qstate)) > 0,
          f"{label}, int8 wire: no error-feedback state")
    graphed_vs_eager(torch, port, r8, run(quant="int8", _graphs=False),
                     f"{label}, int8 wire", "uncaptured")

    # checkpoints every CKPT_EVERY rounds, an abort at CKPT_ABORT, a resume
    def abort(cursor):
        if cursor >= CKPT_ABORT:
            raise res_mod.CampaignAborted(f"abort at round {cursor}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_pop_") as d:
        try:
            run(checkpoint_every=CKPT_EVERY, checkpoint_dir=d,
                _checkpoint_hook=abort)
            aborted = False
        except res_mod.CampaignAborted:
            aborted = True
        latest = res_mod.latest_checkpoint(d)
        resumed = run(checkpoint_every=CKPT_EVERY, checkpoint_dir=d,
                      resume=True)
    perr, lerr, qerr, flags = campaign_diffs(port, resumed, res)
    metrics = [repr(m) for m in resumed.metrics] == [repr(m)
                                                     for m in res.metrics]
    print(f"{label}: checkpoints every {CKPT_EVERY} rounds, aborted "
          f"{aborted} at {CKPT_ABORT} (latest {latest and latest.name}), "
          f"resumed ({resumed.graphs['graphs']} graphs captured) vs "
          f"uninterrupted: max param diff {perr:.3e}, loss {lerr:.3e}, "
          f"metrics equal {metrics}")
    check(aborted and latest is not None
          and latest.name == res_mod.checkpoint_tag(CKPT_ABORT),
          f"{label}: no checkpoint at {CKPT_ABORT}")
    check(perr == lerr == qerr == 0.0 and flags and metrics,
          f"{label}: the resumed campaign differs from the uninterrupted "
          f"one")
    torch.cuda.empty_cache()
    graph_launches = {
        name: {"population_launches_per_round": launches[name],
               "population_launches_per_eval_round": launches_e[name]}
        for name in launches}
    return out, graph_launches


# the config sweep (phase 3i): the paper's SplitMe schedule (SystemParams(
# seed=0), DNN10 at full width, 96 samples a client, 30 rounds) at the
# bandwidths SWEEP_B (Table III's B halved, kept and doubled twice), seeds
# 0-3, Step 4 every 10 rounds and after the last at gamma 10: 16 (variant,
# seed) pairs in one scan, each pair training its own cohort for its own E
# in the round of the largest ones; held against its four
# vmap_configs=False campaigns on the default draws, then SWEEP_TURNS timed
# turns of both on draws both read alike (prefix_index_source), the first
# turn's held together, each at the reference test's bounds
# (tests/test_campaign.py: losses 1e-5, accuracy 1e-6, comm_bits exactly,
# params 2e-3), and against the CPU over its first BASELINE_CMP_ROUNDS
# rounds by phase 3d's gates
SWEEP_B = (0.5e9, 1e9, 2e9, 4e9)
SWEEP_LOSS_TOL, SWEEP_ACC_TOL, SWEEP_PARAM_TOL = 1e-5, 1e-6, 2e-3
SWEEP_TURNS = 1
# the sweep's card against CPU over its first SWEEP_CMP_ROUNDS rounds (3d's
# gates; 2, not 3d's 3: a depth cut for the script's time)
SWEEP_CMP_ROUNDS = 2
SWEEP_TOP = 8            # device operations listed of the steady round


def prefix_index_source(torch, seeds, M: int, B: int, n: int,
                        n_phases: int = 2):
    """An ``index_source`` whose E-bucket draws are prefixes of one
    another, as the reference's key chains are: step j of seed s's round r
    draws its (n_phases, M, B) batch indices from a generator of its own,
    so a sweep and its per-variant campaigns, which draw a round at
    different E buckets, read the same batches."""
    def source(i, r, eb):
        return torch.stack([torch.randint(
            0, n, (n_phases, M, B), generator=torch.Generator().manual_seed(
                (int(seeds[i]) * 10 ** 4 + r) * 100 + j))
            for j in range(eb)], 2)
    return source


def sweep_vs_campaigns(sweep, serial, label):
    """A sweep's results against its per-variant campaigns at the
    reference test's bounds; the largest param, loss and final accuracy
    differences."""
    import numpy as np
    perr = lerr = aerr = 0.0
    comm = True
    for a, b in zip(sweep, serial):
        p, l = campaign_max_diff(a, b)
        perr, lerr = max(perr, p), max(lerr, l)
        aerr = max(aerr, float(np.abs(a.accuracy - b.accuracy).max()))
        comm = comm and [m.comm_bits for m in a.metrics] == [
            m.comm_bits for m in b.metrics]
    print(f"{label}: max param diff {perr:.3e} (tol {SWEEP_PARAM_TOL}), loss "
          f"{lerr:.3e} (tol {SWEEP_LOSS_TOL}), final accuracy {aerr:.3e} "
          f"(tol {SWEEP_ACC_TOL}), comm_bits equal {comm}")
    check(perr <= SWEEP_PARAM_TOL and lerr <= SWEEP_LOSS_TOL
          and aerr <= SWEEP_ACC_TOL and comm,
          f"{label}: the sweep and its per-variant campaigns disagree")
    return perr, lerr, aerr


def sweep_phase(torch, port, clients, test, base):
    """Phase 3i; ``base`` is phase 3b's summary.  Returns its numbers and
    the in-graph launches of the main-path kernels."""
    import gc
    import numpy as np
    camp, kl_ops, rg_ops = port.campaign, port.kl_ops, port.rg_ops
    sps = [port.SystemParams(seed=0, B=b) for b in SWEEP_B]
    V, S, n_test = len(sps), len(CAMPAIGN_SEEDS), len(test[1])
    P, n = V * S, int(clients["x"].shape[1])
    kw = dict(rounds=CAMPAIGN_ROUNDS, seeds=CAMPAIGN_SEEDS, test_data=test,
              eval_every=CAMPAIGN_EVAL_EVERY, eval_gamma=CMP_EVAL_GAMMA)
    label = f"config sweep (splitme, {V} bandwidths x {S} seeds)"

    def run(device="cuda", **more):
        return camp.run_config_sweep("splitme", port.DNN10, sps, clients,
                                     device=device, **dict(kw, **more))

    # the main run: strict transfers, one host transfer, the device peak
    kl_ops.launches = kl_ops.launches_bwd = rg_ops.launches = 0
    camp.HOST_TRANSFERS = 0
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    res, call_ms = timed(torch, lambda: run(strict_transfers=True))
    peak = torch.cuda.max_memory_allocated()
    counters = {"kl_mutual": kl_ops.launches,
                "kl_mutual (backward)": kl_ops.launches_bwd,
                "ridge_gram": rg_ops.launches}
    check(camp.HOST_TRANSFERS == 1,
          f"{label}: {camp.HOST_TRANSFERS} host transfers")
    check(len(res) == V, f"{label}: {len(res)} results")
    for b, r in zip(SWEEP_B, res):
        print(f"{label}: B {b:.1e}: selected per round "
              f"{r.schedule.a.sum(1).astype(int).tolist()}, E "
              f"{r.schedule.E.tolist()}")
    stats = res[0].graphs
    shapes = stats["shapes"]
    check(stats["graphs"] == len(shapes) + 1,
          f"{label}: one graph per shape + eval")
    check(all(bool(np.isfinite(r.losses).all()) for r in res),
          f"{label}: non-finite loss")
    check(all(v > 0 for v in counters.values()),
          f"{label}: a kernel of the path never launched {counters}")
    print(f"{label}: {len(shapes)} round shapes "
          + ", ".join(f"({kb}, {eb}) x{len(rs)}"
                      for (kb, eb), rs in shapes.items())
          + f"; {stats['graphs']} graphs, capture {stats['capture_s']:.3f} "
          f"s; call {call_ms:.1f} ms; HOST_TRANSFERS {camp.HOST_TRANSFERS} "
          f"under strict_transfers; launch counters (warm-ups and captures) "
          f"{counters}; torch.cuda.max_memory_allocated {peak / 1e6:.2f} MB "
          f"({(peak - before) / 1e6:.2f} MB above the {before / 1e6:.2f} "
          f"MB held before); final accuracy per variant "
          f"{[[round(float(a), 4) for a in r.accuracy] for r in res]}")
    unc = run(_graphs=False)
    for b, r, u in zip(SWEEP_B, res, unc):
        graphed_vs_eager(torch, port, r, u, f"{label}, B {b:.1e}",
                         "uncaptured")
    # on the default draws too: each pair reads its variant's own campaign's
    # batches (ROADMAP C 6)
    sweep_vs_campaigns(res, run(vmap_configs=False),
                       f"{label} vs its vmap_configs=False campaigns (card, "
                       f"graphed, default draws)")

    # the steady round and the whole sweep beside its four per-variant
    # campaigns, in SWEEP_TURNS turns on draws both read alike
    # (prefix_index_source); the first turn's pair is also held together
    steady_shape, window = steady_window(shapes, CAMPAIGN_ROUNDS,
                                         CAMPAIGN_EVAL_EVERY)
    check(len(window) >= 3, f"{label}: steady window {window}")
    eval_round = 2 * CAMPAIGN_EVAL_EVERY - 1
    src = prefix_index_source(torch, CAMPAIGN_SEEDS, int(sps[0].M), 32, n)
    g_ms = [statistics.median(res[0].round_ms[window])]
    whole, calls, s_whole, s_calls = [], [], [], []
    for turn in range(SWEEP_TURNS):
        vm, ms = timed(torch, lambda: run(index_source=src))
        g_ms.append(statistics.median(vm[0].round_ms[window]))
        whole.append(float(sum(vm[0].round_ms)))
        calls.append(ms)
        se, ms = timed(torch, lambda: run(index_source=src,
                                          vmap_configs=False))
        s_whole.append(float(sum(sum(r.round_ms) for r in se)))
        s_calls.append(ms)
        print(f"{label}, turn {turn}: steady round {g_ms[-1]:.3f} ms; whole "
              f"sweep {whole[-1]:.1f} ms of rounds (call {calls[-1]:.1f} "
              f"ms), its {V} vmap_configs=False campaigns {s_whole[-1]:.1f} "
              f"ms of rounds (calls {s_calls[-1]:.1f} ms): "
              f"{s_whole[-1] / whole[-1]:.3f}x of rounds, "
              f"{s_calls[-1] / calls[-1]:.3f}x of calls")
        if turn == 0:
            perr, lerr, aerr = sweep_vs_campaigns(
                vm, se, f"{label} vs its vmap_configs=False campaigns (card, "
                f"graphed, prefix-consistent draws)")
        del vm, se
    got = profiled_windows(torch, run, {"steady": window,
                                        "eval": [eval_round]})
    evts, wall = got["steady"]
    busy, n_ops, per = campaign_window(torch, evts, len(window))
    wall /= len(window)
    launches = {k: v[0] for k, v in per.items()}
    _, n_ops_e, per_e = campaign_window(torch, got["eval"][0], 1)
    launches_e = {k: v[0] for k, v in per_e.items()}
    eb = steady_shape[1]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    heavy = sorted(evts, key=dev_us, reverse=True)[:SWEEP_TOP]
    for e in heavy:
        print(f"{label}: steady round, {dev_us(e) / 1e3 / len(window):8.3f} "
              f"ms {e.count / len(window):7.1f} calls  {e.key[:90]}")
    out = {"round_ms": statistics.median(g_ms), "ops_per_round": n_ops,
           "idle_share": 1 - busy / wall, "steady_shape": list(steady_shape),
           "steady_rounds": window, "pairs": P,
           "top_ms_per_round": {e.key[:60]: dev_us(e) / 1e3 / len(window)
                                for e in heavy}, "shapes": len(shapes),
           "graphs": stats["graphs"], "capture_s": stats["capture_s"],
           "whole_ms": statistics.median(whole),
           "serial_whole_ms": statistics.median(s_whole),
           "call_ms": statistics.median(calls),
           "serial_call_ms": statistics.median(s_calls),
           "peak_mb": peak / 1e6, "peak_above_mb": (peak - before) / 1e6,
           "launches_per_round": launches,
           "launches_per_eval_round": launches_e,
           "ops_per_eval_round": n_ops_e, "serial_param_diff": perr,
           "serial_loss_diff": lerr, "serial_acc_diff": aerr}
    print(f"{label}: steady ({steady_shape[0]}, {eb}) round (rounds "
          f"{window[0]}-{window[-1]}) of {P} pairs graphed "
          f"{out['round_ms']:.3f} ms (medians of {len(g_ms)}: "
          f"{[round(float(v), 3) for v in g_ms]}) = "
          f"{P * 1e3 / out['round_ms']:.1f} pair-rounds/s, {n_ops:.1f} "
          f"device operations a round, idle share {out['idle_share']:.4f}; "
          f"in-graph launches a steady round {launches}, at the evaluating "
          f"round {eval_round} {launches_e} ({n_ops_e:.0f} operations); "
          f"whole sweep {out['whole_ms']:.1f} ms of rounds against "
          f"{out['serial_whole_ms']:.1f} ms for its {V} campaigns "
          f"({out['serial_whole_ms'] / out['whole_ms']:.2f}x of rounds "
          f"only); calls {out['call_ms']:.1f} against "
          f"{out['serial_call_ms']:.1f} ms, host plans included "
          f"({out['serial_call_ms'] / out['call_ms']:.2f}x of calls); "
          f"phase 3b: ({base['launches_per_round']}) "
          f"{base['round_ms']:.3f} ms, {base['ops_per_round']:.1f} "
          f"operations, idle {base['idle_share']:.4f}")
    check(launches["kl_mutual"] == 2 * eb
          and launches["kl_mutual (backward)"] == 2 * eb
          and launches["ridge_gram"] == 0,
          f"{label}: steady round launches {launches} != 2 x E {eb} KL "
          f"forward and backward, no Gram")
    check(launches_e["ridge_gram"] == 8 * P,
          f"{label}: evaluating round launches {launches_e}: not 8 Gram "
          f"pairs a (variant, seed) pair")

    # the card against the CPU over the first rounds, by 3d's gates
    card = run(rounds=SWEEP_CMP_ROUNDS, eval_every=1)
    cpu = run(device="cpu", rounds=SWEEP_CMP_ROUNDS, eval_every=1)
    worst = (0.0, 0.0, 0.0, 0)
    for b, c, u in zip(SWEEP_B, card, cpu):
        d = card_vs_cpu_campaign(torch, c, u, n_test)
        check_card_cpu_flips(f"{label}, B {b:.1e}", *d)
        worst = tuple(max(x, y) for x, y in zip(worst, d))
    print(f"{label}: card (graphed) vs CPU over {SWEEP_CMP_ROUNDS} "
          f"rounds: max param diff {worst[0]:.3e} (tol {CARD_CPU_TOL}, "
          f"{FLIP_TOL} for at most {FLIP_UNITS} hidden units a seed: "
          f"{worst[3]}), loss {worst[1]:.3e}, accuracy {worst[2]:.0f} of "
          f"{n_test} test samples (gamma {CMP_EVAL_GAMMA})")
    out.update(card_cpu_param_diff=worst[0], card_cpu_loss_diff=worst[1],
               card_cpu_acc_samples=worst[2], card_cpu_flipped_units=worst[3])
    del res, unc, card, cpu
    torch.cuda.empty_cache()
    graph_launches = {
        name: {"sweep_launches_per_round": launches[name],
               "sweep_launches_per_eval_round": launches_e[name]}
        for name in launches}
    return out, graph_launches


# the sharded campaign (phase 3k): the campaign of phase 3b (kw of 3b's
# card-vs-CPU run: Step 4 at CMP_EVAL_GAMMA) under a 1-shard NCCL mesh, a
# process group of this process alone: graphed (strict transfers, one host
# transfer) against the same round bodies uncaptured bit for bit, against
# 3b's gathered campaign within CARD_CPU_TOL (params, losses) and
# CMP_ACC_SAMPLES (accuracy); its steady rounds and an evaluating round
# profiled (beside 3b's gathered steady round): operations, the
# all-reduce's kernels (at most one a round and one a server layer an
# evaluation; none with one rank, NCCL_KERNELS) and the KL and Gram
# launches inside the graphs.  Then a job of SHARDED_RANKS ranks on this
# one card over gloo (NCCL refuses two ranks on one card), uncaptured:
# scripts/chip_sharded_check_torch.py --backend gloo --quick, the six
# frameworks' round and a short campaign against the single-device port
SHARDED_RANKS = 4
SHARDED_TIMEOUT_S = 400
# the all-reduce's device kernels by name (ncclDevKernel_…): a one-rank
# NCCL all-reduce in place launches none (NVIDIA H100, NCCL 2.28.9: the
# profiler sees no kernel of it), so here the all-reduce is counted by
# engine.ALL_REDUCES uncaptured, and its kernel on several cards by
# scripts/chip_sharded_check_torch.py
NCCL_KERNELS = ("nccl",)


def nccl_window(evts, rounds: int):
    """The all-reduce's kernels of a profiled window: launches a round,
    device µs a round, names."""
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    hit = [e for e in evts if dev_us(e) > 0
           and any(k in e.key.lower() for k in NCCL_KERNELS)]
    return (sum(e.count for e in hit) / rounds,
            sum(dev_us(e) for e in hit) / rounds,
            sorted({e.key[:60] for e in hit}))


def sharded_phase(torch, port, sp, clients, test, base):
    """Phase 3k; ``base`` is phase 3b's summary.  Returns its numbers and
    the in-graph launches of the main-path kernels under the mesh."""
    import tempfile
    import numpy as np
    import torch.distributed as dist
    camp, eng = port.campaign, port.engine
    kl_ops, rg_ops = port.kl_ops, port.rg_ops
    S, n_test = len(CAMPAIGN_SEEDS), len(test[1])
    kw = dict(rounds=CAMPAIGN_ROUNDS, seeds=CAMPAIGN_SEEDS, test_data=test,
              device="cuda", eval_every=CAMPAIGN_EVAL_EVERY,
              eval_gamma=CMP_EVAL_GAMMA)
    label = "sharded campaign (1-shard NCCL mesh)"
    evals = [r for r in range(CAMPAIGN_ROUNDS)
             if not (r + 1) % CAMPAIGN_EVAL_EVERY or r == CAMPAIGN_ROUNDS - 1]

    def run(**more):
        return camp.run_campaign("splitme", port.DNN10, sp, clients,
                                 **dict(kw, **more))

    out = {}
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/pg",
                                world_size=1, rank=0)
        try:
            mesh = port.meshes.make_client_mesh(1)
            kl_ops.launches = kl_ops.launches_bwd = rg_ops.launches = 0
            camp.HOST_TRANSFERS = 0
            res, call_ms = timed(torch, lambda: run(mesh=mesh,
                                                    strict_transfers=True))
            counters = {"kl_mutual": kl_ops.launches,
                        "kl_mutual (backward)": kl_ops.launches_bwd,
                        "ridge_gram": rg_ops.launches}
            check(camp.HOST_TRANSFERS == 1,
                  f"{label}: {camp.HOST_TRANSFERS} host transfers")
            check(all(v > 0 for v in counters.values()),
                  f"{label}: a kernel of the path never launched "
                  f"{counters}")
            shapes = res.graphs["shapes"]
            check(res.graphs["graphs"] == len(shapes) + 1,
                  f"{label}: one graph per shape + eval")
            check(all(kb == sp.M for kb, _ in shapes),
                  f"{label}: shapes {sorted(shapes)} do not train the "
                  f"full masked M {sp.M}")
            a0 = eng.ALL_REDUCES
            unc = run(mesh=mesh, _graphs=False)
            n_ar = eng.ALL_REDUCES - a0
            check(n_ar == CAMPAIGN_ROUNDS + 8 * len(evals),
                  f"{label}: {n_ar} all-reduces uncaptured, want one a "
                  f"round and one a server layer an evaluation")
            graphed_vs_eager(torch, port, res, unc, label, "uncaptured")
            gathered = run()
            perr, lerr = campaign_max_diff(res, gathered)
            acc_a, acc_b = res.accuracy_per_round, gathered.accuracy_per_round
            ok = np.isfinite(acc_b)
            check(bool((np.isfinite(acc_a) == ok).all()),
                  f"{label}: evaluates other rounds than 3b's campaign")
            aerr = float(np.abs(acc_a[ok] - acc_b[ok]).max()) * n_test
            print(f"{label}: {len(shapes)} round shapes "
                  + ", ".join(f"({kb}, {eb}) x{len(rs)}"
                              for (kb, eb), rs in shapes.items())
                  + f"; {res.graphs['graphs']} graphs, capture "
                  f"{res.graphs['capture_s']:.3f} s; call {call_ms:.1f} ms; "
                  f"HOST_TRANSFERS 1 under strict_transfers; launch counters "
                  f"(warm-ups and captures) {counters}; all-reduces "
                  f"uncaptured {n_ar} ({CAMPAIGN_ROUNDS} rounds + 8 x "
                  f"{len(evals)} evaluations); vs 3b's gathered campaign: "
                  f"params {perr:.3e}, losses {lerr:.3e} (tol "
                  f"{CARD_CPU_TOL}), accuracy {aerr:.2f} of {n_test} test "
                  f"samples (tol {CMP_ACC_SAMPLES}, gamma {CMP_EVAL_GAMMA})")
            check(perr <= CARD_CPU_TOL and lerr <= CARD_CPU_TOL
                  and aerr <= CMP_ACC_SAMPLES + 1e-6,
                  f"{label}: the sharded and the gathered campaigns "
                  f"disagree")
            # the steady rounds and an evaluating round under the profiler,
            # the mesh's and the gathered campaign's
            _, window = steady_window(shapes, CAMPAIGN_ROUNDS,
                                      CAMPAIGN_EVAL_EVERY)
            eval_round = evals[1]
            check(len(window) >= 3, f"{label}: steady window {window}")
            g_ms = statistics.median(res.round_ms[window])
            win = profiled_windows(torch, lambda **m: run(mesh=mesh, **m),
                                   {"steady": window, "eval": [eval_round]})
        finally:
            dist.destroy_process_group()
    evts, wall = win["steady"]
    busy, n_ops, per = campaign_window(torch, evts, len(window))
    wall /= len(window)
    n_nccl, nccl_us, names = nccl_window(evts, len(window))
    per_e = campaign_window(torch, win["eval"][0], 1)[2]
    e_nccl = nccl_window(win["eval"][0], 1)[0]
    eb = max(shapes, key=lambda s: len(shapes[s]))[1]
    print(f"{label}: steady (50, {eb}) round graphed {g_ms:.3f} ms "
          f"(rounds {window[0]}-{window[-1]}), profiled wall {wall:.3f} ms, "
          f"busy {busy:.3f} ms, idle share {1 - busy / wall:.4f}, "
          f"{n_ops:.1f} operations a round (3b's gathered steady (32, 6), "
          f"the same rounds: {base['round_ms']:.3f} ms, "
          f"{base['ops_per_round']:.1f}); all-reduce kernels {n_nccl:.2f} a "
          f"round ({nccl_us:.2f} us; {names}), {e_nccl:.0f} at the "
          f"evaluating round {eval_round}; in-graph launches "
          f"{ {k: v[0] for k, v in per.items()} } a round, at the "
          f"evaluating round { {k: v[0] for k, v in per_e.items()} }")
    # one all-reduce a round and one a server layer an evaluation, each at
    # most one kernel (none with one rank: NCCL_KERNELS)
    check(n_nccl in (0.0, 1.0) and e_nccl == (1 + 8) * n_nccl,
          f"{label}: {n_nccl} all-reduce kernels a steady round, {e_nccl} "
          f"at an evaluating round")
    check(per["kl_mutual"][0] == 2 * eb
          and per["kl_mutual (backward)"][0] == 2 * eb
          and per["ridge_gram"][0] == 0 and per_e["ridge_gram"][0] == 8 * S,
          f"{label}: in-graph launches {per} / {per_e}")
    out.update(round_ms=g_ms, ops_per_round=n_ops, idle_share=1 - busy / wall,
               all_reduce_kernels=n_nccl,
               all_reduce_us=nccl_us, all_reduce_kernel_names=names,
               vs_gathered_param_diff=perr, vs_gathered_loss_diff=lerr,
               vs_gathered_acc_samples=aerr, capture_s=res.graphs["capture_s"],
               graphs=res.graphs["graphs"])
    del res, unc, gathered
    torch.cuda.empty_cache()

    # the gloo job on this card
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(SHARDED_RANKS),
             str(ROOT / "scripts" / "chip_sharded_check_torch.py"),
             "--backend", "gloo", "--quick", "--out", f"{d}/gloo.json"],
            capture_output=True, text=True, timeout=SHARDED_TIMEOUT_S,
            cwd=ROOT)
        secs = time.perf_counter() - t0
        lines = [l for l in proc.stdout.splitlines() if l.startswith("[")]
        for line in lines:
            print(f"  gloo job: {line}")
        check(proc.returncode == 0,
              f"gloo job of {SHARDED_RANKS} ranks on one card exited "
              f"{proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-3000:]}")
        gloo = json.loads(Path(f"{d}/gloo.json").read_text())["sharded"]
    worst = max([v["param_diff"] for v in gloo["rounds"].values()]
                + [gloo["campaign"]["param_diff"]])
    print(f"sharded rounds and campaign, {SHARDED_RANKS} gloo ranks on one "
          f"card (uncaptured) vs the single-device port: max param diff "
          f"{worst:.3e} (tol {CARD_CPU_TOL}), {secs:.1f} s")
    out.update(gloo_ranks=SHARDED_RANKS, gloo_max_param_diff=worst,
               gloo_seconds=secs)
    graph_launches = {
        name: {"sharded_launches_per_round": per[name][0],
               "sharded_device_us_per_launch": per[name][1]}
        for name in ("kl_mutual", "kl_mutual (backward)")}
    graph_launches["ridge_gram"] = {
        "sharded_launches_per_eval_round": per_e["ridge_gram"][0],
        "sharded_device_us_per_launch": per_e["ridge_gram"][1]}
    return out, graph_launches


# the paper's result at its full horizon (phase 3l): the six frameworks as
# examples/oran_splitfl_campaign.py --seeds --baselines runs them (SplitMe
# 30 rounds, the baselines 60 with the example's K and E, SystemParams(
# seed=0), DNN10, the data of phase 3b, an evaluation every 10 rounds and
# after the last, SplitMe's at the default ridge) over HORIZON_SEEDS seeds
# in one graphed campaign each, on the port's own draws; each framework's
# finals held by rank against the reference's finals at the same setting
# (HORIZON_REFERENCE, written by tests/torch_horizon_check.py on the CPU):
# a two-sided Mann-Whitney p of at least HORIZON_MIN_P, and the counts of
# seeds below HORIZON_LOW_ACC alike (a two-sided Fisher exact p of at least
# HORIZON_MIN_P: ranks alone missed Step 4 collapsing 9 of 32 seeds, p
# 0.40, ROADMAP C 9).  The card's graphed campaigns are deterministic, so
# the gates do not flip from run to run.
# Then ROADMAP C 6: SplitMe under the bf16 policy (phase 3c's campaign, 30
# rounds, 4 seeds) once as it is and once from every initial weight moved
# up by one f32 ulp, checkpointed after every round: the card's own
# spread, round by round, printed beside phase 3c's card-vs-CPU difference
HORIZON_SEEDS = tuple(range(32))
HORIZON_MIN_P = 0.01
HORIZON_LOW_ACC = 0.70
HORIZON_REFERENCE = ROOT / "tests" / "data" / "horizon_reference.json"
HORIZON_FRAMEWORKS = (("splitme", {}),) + BASELINES
HORIZON_BASELINE_ROUNDS = 60


def mann_whitney_p(a, b) -> float:
    from scipy.stats import mannwhitneyu
    return float(mannwhitneyu(a, b, alternative="two-sided").pvalue)


def fisher_low_p(a, b) -> float:
    """Two-sided Fisher exact p of the counts of a's and b's values below
    HORIZON_LOW_ACC."""
    from scipy.stats import fisher_exact
    lo_a, lo_b = sum(v < HORIZON_LOW_ACC for v in a), sum(
        v < HORIZON_LOW_ACC for v in b)
    return float(fisher_exact([[lo_a, len(a) - lo_a], [lo_b, len(b) - lo_b]],
                              alternative="two-sided").pvalue)


def checkpointed_params(port, ckpt_dir):
    """{round cursor: {leaf key: array}} of the params of every checkpoint
    of a campaign (``ckpt-r{cursor:06d}``)."""
    out = {}
    for path in sorted(Path(ckpt_dir).glob("ckpt-r*.npz")):
        if path.stem.endswith("-buffers"):
            continue
        arrays = port.ckpt_io.load_arrays(path.with_suffix(""))
        out[int(path.stem[len("ckpt-r"):])] = {
            k: v for k, v in arrays.items() if k.startswith("params/")}
    return out


def horizon_phase(torch, port, sp, clients, test, prec, smi):
    """Phase 3l: the six frameworks' seed distributions against the
    reference's, and the bf16 campaign's own one-ulp spread (C 6); returns
    the numbers and the KL and Gram launches of SplitMe's campaign."""
    import shutil
    import numpy as np
    camp, kl_ops, rg_ops = port.campaign, port.kl_ops, port.rg_ops
    check(HORIZON_REFERENCE.is_file(), f"no {HORIZON_REFERENCE}")
    ref = json.loads(HORIZON_REFERENCE.read_text())
    setting = ref["setting"]
    check(setting["seeds"] == list(HORIZON_SEEDS) and setting["M"] == sp.M
          and setting["samples_per_client"] == 96
          and setting["n_per_class"] == 2000,
          f"{HORIZON_REFERENCE.name} was made at another setting: {setting}")
    out = {"frameworks": {}}
    launches = {}
    for name, kw in HORIZON_FRAMEWORKS:
        rounds = (CAMPAIGN_ROUNDS if name == "splitme"
                  else HORIZON_BASELINE_ROUNDS)
        check(setting["rounds"][name] == rounds
              and setting["hyper"][name] == kw,
              f"{name}: the reference's file has another setting")
        kl_ops.launches = kl_ops.launches_bwd = rg_ops.launches = 0
        camp.HOST_TRANSFERS = 0
        res, wall = timed(torch, lambda: camp.run_campaign(
            name, port.DNN10, port.SystemParams(seed=0), clients,
            rounds=rounds, seeds=HORIZON_SEEDS, test_data=test,
            eval_every=CAMPAIGN_EVAL_EVERY, device="cuda",
            strict_transfers=True, **kw))
        counts = {"kl_mutual": kl_ops.launches,
                  "kl_mutual (backward)": kl_ops.launches_bwd,
                  "ridge_gram": rg_ops.launches}
        check(camp.HOST_TRANSFERS == 1,
              f"3l {name}: {camp.HOST_TRANSFERS} host transfers")
        check(bool(np.isfinite(res.losses).all()),
              f"3l {name}: non-finite loss")
        if name == "splitme":
            check(all(counts.values()),
                  f"3l splitme: a kernel of its path never launched {counts}")
            launches = counts
        else:
            check(not any(counts.values()),
                  f"3l {name}: launched a kernel its path does not run "
                  f"{counts}")
        acc = np.asarray(res.accuracy, np.float64)
        want = np.asarray(ref["finals"][name], np.float64)
        check(acc.shape == want.shape == (len(HORIZON_SEEDS),)
              and bool(np.isfinite(acc).all()),
              f"3l {name}: finals {acc.shape} against {want.shape}")
        p, p_low = mann_whitney_p(acc, want), fisher_low_p(acc, want)
        row = out["frameworks"][name] = {
            "median": float(np.median(acc)), "min": float(acc.min()),
            "below": int((acc < HORIZON_LOW_ACC).sum()),
            "reference_median": float(np.median(want)),
            "reference_min": float(want.min()),
            "reference_below": int((want < HORIZON_LOW_ACC).sum()),
            "mann_whitney_p": p, "fisher_low_p": p_low, "call_ms": wall,
            "whole_ms": float(sum(res.round_ms)),
            "finals": [round(float(v), 6) for v in acc], "launches": counts}
        print(f"3l {name}: {len(HORIZON_SEEDS)} seeds x {rounds} rounds, "
              f"one graphed campaign {wall:.1f} ms: median "
              f"{row['median']:.4f} (reference {row['reference_median']:.4f})"
              f", min {row['min']:.4f} ({row['reference_min']:.4f}), below "
              f"{HORIZON_LOW_ACC} {row['below']} ({row['reference_below']}, "
              f"Fisher p {p_low:.4g}); Mann-Whitney p {p:.4g} (gates >= "
              f"{HORIZON_MIN_P}) | {smi}")
        check(p >= HORIZON_MIN_P and p_low >= HORIZON_MIN_P,
              f"3l {name}: the card's finals differ from the reference's "
              f"(Mann-Whitney p {p:.4g}, Fisher p {p_low:.4g}, gate "
              f"{HORIZON_MIN_P})")
        del res
        torch.cuda.empty_cache()
    # C 6: the bf16 campaign's own spread on the card under one ulp
    base = TOOLING_DIR.parent / "chip_smoke_c6"
    shutil.rmtree(base, ignore_errors=True)
    init = initial_params(torch, port, "splitme", CAMPAIGN_SEEDS)
    runs = {}
    for label, params in (("as is", init),
                          ("one ulp up", [one_ulp_up(torch, q)
                                          for q in init])):
        d = base / label.replace(" ", "_")
        runs[label] = (camp.run_campaign(
            "splitme", port.DNN10, sp, clients, rounds=CAMPAIGN_ROUNDS,
            seeds=CAMPAIGN_SEEDS, test_data=test,
            eval_every=CAMPAIGN_EVAL_EVERY, eval_gamma=CMP_EVAL_GAMMA,
            device="cuda", policy="kernel_bf16", params=params,
            checkpoint_every=1, checkpoint_dir=d),
            checkpointed_params(port, d))
    (a, pa), (b, pb) = runs["as is"], runs["one ulp up"]
    check(sorted(pa) == sorted(pb) == list(range(1, CAMPAIGN_ROUNDS + 1)),
          f"C 6: checkpoints after rounds {sorted(pa)}")
    spread = [max(float(np.abs(pa[r][k] - pb[r][k]).max()) for k in pa[r])
              for r in range(1, CAMPAIGN_ROUNDS + 1)]
    loss_spread = np.abs(a.losses - b.losses).max(axis=(0, 2)).tolist()
    card_cpu = prec["variants"]["kernel_bf16"]["card_cpu_param_diff"]
    out["c6"] = {"param_spread": spread, "loss_spread": loss_spread,
                 "card_cpu_param_diff_3c": card_cpu,
                 "card_cpu_rounds_3c": PRECISION_CMP_ROUNDS}
    print(f"3l C 6, the bf16 policy's campaign against itself from every "
          f"initial weight one ulp up ({len(CAMPAIGN_SEEDS)} seeds), max "
          f"param diff after rounds 1..{CAMPAIGN_ROUNDS}: "
          f"{[float(f'{v:.3e}') for v in spread]}; phase 3c's card vs CPU "
          f"after {PRECISION_CMP_ROUNDS} rounds {card_cpu:.3e} (gate 1e-3), "
          f"the card's own spread then {spread[PRECISION_CMP_ROUNDS - 1]:.3e}"
          f" | {smi}")
    shutil.rmtree(base, ignore_errors=True)
    return out, launches


# the README's four command lines (README.md, Quickstart) through the port's
# example on the card (phase 3j): "{dir}" is a temporary directory; the
# resumable line runs twice, the rerun resuming from its last checkpoint.
# The serial line's five eager baseline trainers run README_BASELINE_ROUNDS
# of their 60 rounds (the script's time; each round is an eager trainer
# round; 5 since phase 3k, 10 before)
README_BASELINE_ROUNDS = 5
README_LINES = (
    ("serial", ["--rounds", "30", "--baselines", "--baseline-rounds",
                str(README_BASELINE_ROUNDS), "--ckpt-dir", "{dir}"]),
    ("campaign", ["--seeds", "4", "--eval-every", "5", "--quant", "bf16",
                  "--scenario", "fading:0.8"]),
    ("resumable", ["--seeds", "4", "--checkpoint-every", "10",
                   "--checkpoint-dir", "{dir}/ckpt", "--resume"]),
    ("population", ["--seeds", "2", "--population", "1000000", "--cohort",
                    "32", "--scenario", "churn:0.5"]),
)
_ACC = r"acc=(\d\.\d{3})"
README_OUTPUT = {
    "serial": [r"\[splitme\] round \d+: sel=\d+ E=\d+ " + _ACC
               + r" cum_comm=[\d.]+MB"] * 6
    + [r"\[splitme\] FINAL " + _ACC + r" rounds=30 sim_time=[\d.]+s "
       r"wall=\d+s"]
    + [rf"\[{f}\] " + _ACC + rf" rounds={README_BASELINE_ROUNDS} "
       r"sim_time=[\d.]+s comm=[\d.]+MB"
       for f in ("fedavg", "sfl", "oranfed", "fedora", "ecofl")],
    "campaign": [r"\[splitme\] 4 seeds x 30 rounds: " + _ACC
                 + r"±\d\.\d{3} \(per-seed \[.*\]\) comm=[\d.]+MB "
                 r"sim_time=[\d.]+s wall=\d+s",
                 r"\[splitme\] fused-eval accuracy curve: \[.*\]"],
    "resumable": [r"\[splitme\] 4 seeds x 30 rounds: " + _ACC
                  + r"±\d\.\d{3} \(per-seed \[.*\]\) comm=[\d.]+MB "
                  r"sim_time=[\d.]+s wall=\d+s"],
    "population": [r"\[splitme/pop\] 1,000,000 clients, cohort 32, 2 seeds "
                   r"x 30 rounds: " + _ACC + r"±\d\.\d{3} comm=[\d.]+MB "
                   r"wall=\d+s"],
}


def readme_phase(port):
    """Phase 3j: each README line through ``main(argv + ["--device",
    "cuda"])``; its printed lines must have the reference's formats and
    accuracies in [0, 1].  Returns each line's seconds."""
    import io
    import re
    import tempfile
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_readme_") as d:
        for name, line in README_LINES:
            argv = [a.replace("{dir}", d) for a in line] + ["--device",
                                                           "cuda"]
            printed = []
            for rep in range(2 if name == "resumable" else 1):
                buf = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    port.example_cli.main(argv)
                secs = time.perf_counter() - t0
                lines = buf.getvalue().splitlines()
                for text in lines:
                    print(f"3j {name}: {text}")
                want = README_OUTPUT[name]
                check(len(lines) == len(want)
                      and all(re.fullmatch(p, t)
                              for p, t in zip(want, lines)),
                      f"README line {name!r}: printed {lines}")
                accs = [float(m.group(1)) for p, t in zip(want, lines)
                        for m in [re.fullmatch(p, t)] if m.groups()]
                check(all(0.0 <= a <= 1.0 for a in accs),
                      f"README line {name!r}: accuracy out of range")
                printed.append([re.sub(r"wall=\d+s", "", t) for t in lines])
                out[name if rep == 0 else f"{name} (rerun)"] = secs
                print(f"3j {name}{' (rerun, resumed)' if rep else ''}: "
                      f"{secs:.1f} s: python -m "
                      f"repro_torch.examples.oran_splitfl_campaign "
                      f"{' '.join(argv)}")
            if name == "resumable":
                check(printed[0] == printed[1],
                      "the resumed README line printed other results")
    return out


# the kl_mutual kernels: (rows, d) of the main path (50 clients x 32 rows of
# 256), a ragged width, a tiny one in single floats (d % 4 != 0), 32 values
# a lane (d 1000), a row streamed (d > 1024), the campaign's cohorts of 32
# and 50 clients x 4 seeds x 32 rows, and the config sweep's 16 pairs x 50
# slots x 32 rows (phase 3i); the shapes of tests/test_torch_cuda.py's
# test_kl_kernel_matches_plain
KL_SHAPES = [(1600, 256), (1000, 200), (7, 3), (33, 1000), (5, 5000),
             (4096, 256), (6400, 256), (25600, 256)]
KL_T = 2.0               # the SplitMe temperature
KL_HOST_BLOCKS = 9       # blocks of 50 calls a wrapper, for the host time


def profile_ops(torch, fn, calls: int = 20):
    """(device ms, device operations) per call of ``fn`` from torch.profiler:
    every kernel (and copy) in the window."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evts = key_averages(torch, prof)
    ops = sum(e.count for e in evts if device_busy_ms([e]) > 0)
    return device_busy_ms(evts) / calls, ops / calls


def kl_rows_entering_the_device(torch, kl_ops, x, y, temperature):
    """The forward wrapper in its earlier form, which entered
    torch.cuda.device on every call: the yardstick of the lean wrapper's
    host time (same checks, allocation and C entry)."""
    kl_ops._check(x, y)
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    fn = kl_ops.build.function("kl_mutual_rows_f32", kl_ops._ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), *x.shape,
                 1.0 / temperature, torch.cuda.current_stream().cuda_stream)
    kl_ops.build.check(err, "kl_mutual")
    return out


def kl_phase(torch, port, normal):
    """The kl_mutual forward and backward kernels against their plain
    versions at KL_SHAPES (the backward with g at stride 0, one value for
    every row), the gradient of dispatch.kl_loss at (50, 32, 256) against
    the reference preset's autograd, then times at the main-path shape."""
    kl_ops = port.kl_ops
    fwd_err = bwd_err = bwd_rel = 0.0
    for rows, d in KL_SHAPES:
        x, y = normal(rows, d, scale=3.0), normal(rows, d, scale=3.0)
        err = (kl_ops.kl_rows(x, y, KL_T)
               - port.kl_rows_ref(x, y, KL_T)).abs().max().item()
        g = torch.full((1,), 1.0 / 32, device=x.device).expand(rows)
        want = port.kl_grad_ref(x, y, g, KL_T)
        got = kl_ops.kl_grad(x, y, g, KL_T)
        check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
              f"kl_mutual backward at ({rows}, {d}): {got.shape}")
        scale = want.abs().max().item()
        abs_err = (got - want).abs().max().item()
        rel = abs_err / scale
        print(f"kl_mutual ({rows}, {d}): forward max |kernel - plain| = "
              f"{err:.3e} (tol {KL_TOL}); backward (g at stride 0) "
              f"{rel:.3e} x max|grad| (tol {KL_TOL})")
        check(err <= KL_TOL, f"kl_mutual disagrees at ({rows}, {d})")
        check(rel <= KL_TOL, f"kl_mutual backward disagrees at ({rows}, {d})")
        fwd_err, bwd_rel = max(fwd_err, err), max(bwd_rel, rel)
        bwd_err = max(bwd_err, abs_err)
    # gradient: the backward kernel inside autograd vs autograd of the plain
    # graph
    x, y = normal(50, 32, 256), normal(50, 32, 256)
    grads = []
    for pol in ("kernel", "reference"):
        tx = x.clone().requires_grad_(True)
        before = kl_ops.launches_bwd
        port.dispatch.kl_loss(tx, y, temperature=KL_T,
                              policy=pol).sum().backward()
        check(kl_ops.launches_bwd == before + (pol == "kernel"),
              f"kl_mutual backward kernel launches under {pol}")
        grads.append(tx.grad)
    gerr = (grads[0] - grads[1]).abs().max().item()
    gtol = KL_TOL * grads[1].abs().max().item()
    print(f"kl_mutual grad (50, 32, 256) through dispatch.kl_loss: max err = "
          f"{gerr:.3e} (tol {gtol:.3e} = {KL_TOL} x max|grad|)")
    check(gerr <= gtol, "kl_mutual gradient disagrees")
    bwd_rel = max(bwd_rel, gerr / grads[1].abs().max().item())
    bwd_err = max(bwd_err, gerr)

    R, D = KL_SHAPES[0]
    x, y = normal(R, D, scale=3.0), normal(R, D, scale=3.0)
    # g: the cohort mean's 1/32 a row, at stride 0 (one value for every
    # row, as autograd hands over the gradient of a sum)
    g = torch.full((1,), 1.0 / 32, device=x.device).expand(R)
    def fwd():
        return kl_ops.kl_rows(x, y, KL_T)

    def bwd():
        return kl_ops.kl_grad(x, y, g, KL_T)
    out = {}
    # bytes: the forward reads x and y and writes one float a row, the
    # backward reads x, y and g and writes gx; operations: about 16 FP32
    # operations an element (scale, max, exp and sum for both rows, then
    # the contraction or the gradient)
    for key, call, plain, n_in, names in (
            ("fwd", fwd, lambda: port.kl_rows_ref(x, y, KL_T), 2,
             ("kl_rows_",)),
            ("bwd", bwd, lambda: port.kl_grad_ref(x, y, g, KL_T), 3,
             ("kl_grad_",))):
        ms = time_ms(torch, call)
        dev, = device_ms(torch, [call], names)
        plain_ms = time_ms(torch, plain)
        plain_dev, plain_ops = profile_ops(torch, plain)
        bytes_t = (n_in * R * D + R) * 4 / PEAK_BYTES * 1e3
        ops_t = 16 * R * D / PEAK_FP32 * 1e3
        out[key] = {"ms": ms, "device_ms": dev,
                    "plain_ms": plain_ms, "plain_device_ms": plain_dev,
                    "plain_device_ops": plain_ops,
                    "bound_ms": max(bytes_t, ops_t),
                    "bound_by": "bytes" if bytes_t >= ops_t else "operations",
                    "library_ms": None, "shape": [R, D]}
    out["fwd"]["max_abs_err"] = fwd_err
    out["bwd"]["max_abs_err"] = bwd_err
    out["bwd"]["max_rel_err"] = bwd_rel
    # host time a call: blocks of calls of the two wrappers and of the
    # forward in its earlier form, in turns, and the median of each
    # (a single block moves by 2x with the host's other work)
    calls = {"fwd": fwd, "bwd": bwd,
             "old": lambda: kl_rows_entering_the_device(torch, kl_ops, x, y,
                                                        KL_T)}
    blocks = {key: [] for key in calls}
    for i in range(KL_HOST_BLOCKS):
        for key in (calls if i % 2 == 0 else reversed(list(calls))):
            blocks[key].append(host_us(torch, calls[key], calls=50))
    host = {key: statistics.median(v) for key, v in blocks.items()}
    out["fwd"]["host_us_per_call"] = host["fwd"]
    out["bwd"]["host_us_per_call"] = host["bwd"]
    old_host = out["fwd"]["host_us_entering_the_device"] = host["old"]
    for key, what in (("fwd", "forward"), ("bwd", "backward")):
        o = out[key]
        dev = o["device_ms"] and round(o["device_ms"] * 1e3, 3)
        print(f"kl_mutual {what} ({R}, {D}): {o['ms'] * 1e3:.2f} us/call "
              f"(events), device {dev} us, host "
              f"{o['host_us_per_call']:.2f} us/call, plain "
              f"{o['plain_ms'] * 1e3:.2f} us (events), device "
              f"{o['plain_device_ms'] * 1e3:.3f} us in "
              f"{o['plain_device_ops']:.1f} device operations, bound "
              f"{o['bound_ms'] * 1e3:.3f} us ({o['bound_by']}); library: none"
              f" (no single PyTorch call computes the per-row softmax KL"
              f"{' or its gradient' if key == 'bwd' else ''})")
    print(f"kl_mutual forward wrapper host time: "
          f"{out['fwd']['host_us_per_call']:.2f} us/call; entering "
          f"torch.cuda.device on every call (the earlier form): {old_host:.2f} "
          f"us/call (medians of {KL_HOST_BLOCKS} blocks of 50 calls, in "
          f"turns; spread {min(blocks['fwd']):.2f}-{max(blocks['fwd']):.2f} "
          f"and {min(blocks['old']):.2f}-{max(blocks['old']):.2f})")
    return out


# the mixed-dtype kl_mutual entries (the bf16 policy's client phase gives
# bf16 x against f32 y, its server phase f32 x against bf16 y; bf16 against
# bf16 has no caller): held against their plain versions at KL_SHAPES (but
# the f32 config sweep's last one, which no bf16 path gives them), and
# at a width with d % 8 != 0, with x aligned and one element off (the
# kernels' single-element loads); a bf16 gradient within one bf16 unit in
# the last place of the plain version's (which rounds the same f32 value),
# plus 2^-23 of its largest element for the f32 rounding of the closed form
# in another order; timed at the bf16 campaign's steady launch, 32 clients
# x 4 seeds x 32 rows of 256
KL_PAIRS = (("bfloat16", "float32"), ("float32", "bfloat16"),
            ("bfloat16", "bfloat16"))
KL_MIXED_SHAPES = KL_SHAPES[:-1] + [(100, 37)]
KL_MIXED_TIME = (4096, 256)
KL_TYPE = {"float32": ("f32", "float"), "bfloat16": ("bf16", "__nv_bfloat16")}


def kl_pair_label(tx, ty):
    return f"{KL_TYPE[tx][0]} x, {KL_TYPE[ty][0]} y"


def kl_pair_kernel(key: str, tx, ty) -> bool:
    """Whether the profiler's kernel name ``key`` is a KL kernel of the
    pair (its template arguments end in the two element types)."""
    return ("kl_rows_" in key or "kl_grad_" in key) and \
        f"{KL_TYPE[tx][1]}, {KL_TYPE[ty][1]}>" in key


def bf16_ulps(torch, got, want) -> float:
    """The largest |got - want| in bf16 units in the last place at the
    larger magnitude, after 2^-23 of max|want| (the f32 rounding)."""
    got, want = got.double(), want.double()
    mag = torch.maximum(got.abs(), want.abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    slack = 2.0 ** -23 * want.abs().max()
    return float(((got - want).abs() - slack).clamp(min=0).div(ulp).max())


def kl_mixed_phase(torch, port, normal):
    """Phase 2: the mixed-dtype KL entries against their plain versions;
    per pair the forward's and the backward's errors, times and bounds."""
    kl_ops = port.kl_ops
    out = {}
    for tx, ty in KL_PAIRS:
        dx, dy = getattr(torch, tx), getattr(torch, ty)
        label = kl_pair_label(tx, ty)
        fwd_err = bwd_err = bwd_ulps = bwd_rel = 0.0
        for rows, d in KL_MIXED_SHAPES:
            for off in (0, 1):
                x = normal(rows, d, scale=3.0).to(dx)
                if off:
                    buf = torch.empty(off + x.numel(), dtype=dx,
                                      device=x.device)
                    x = buf[off:].view(x.shape).copy_(x)
                y = normal(rows, d, scale=3.0).to(dy)
                kl_ops.launches_by_entry.clear()
                err = (kl_ops.kl_rows(x, y, KL_T)
                       - port.kl_rows_ref(x, y, KL_T)).abs().max().item()
                g = torch.full((1,), 1.0 / 32, device=x.device).expand(rows)
                got = kl_ops.kl_grad(x, y, g, KL_T)
                want = port.kl_grad_ref(x, y, g, KL_T)
                check(kl_ops.launches_by_entry == {
                    kl_ops.entry("rows", x, y): 1,
                    kl_ops.entry("grad", x, y): 1},
                    f"kl_mutual ({label}) launched "
                    f"{kl_ops.launches_by_entry}")
                check(got.dtype == dx and bool(torch.isfinite(got).all()),
                      f"kl_mutual backward ({label}) at ({rows}, {d})")
                check(err <= KL_TOL, f"kl_mutual ({label}) disagrees at "
                      f"({rows}, {d}), x offset {off}: {err}")
                abs_err = (got.double() - want.double()).abs().max().item()
                rel = abs_err / want.abs().max().item()
                if dx == torch.bfloat16:
                    u = bf16_ulps(torch, got, want)
                    check(u <= 1.0, f"kl_mutual backward ({label}) at "
                          f"({rows}, {d}), x offset {off}: {u:.2f} bf16 ulps")
                    bwd_ulps = max(bwd_ulps, u)
                else:
                    check(rel <= KL_TOL, f"kl_mutual backward ({label}) at "
                          f"({rows}, {d}), x offset {off}: {rel:.3e}")
                fwd_err, bwd_err = max(fwd_err, err), max(bwd_err, abs_err)
                bwd_rel = max(bwd_rel, rel)
        print(f"kl_mutual ({label}) at {len(KL_MIXED_SHAPES)} shapes x 2 "
              f"offsets: forward max |kernel - plain| = {fwd_err:.3e} (tol "
              f"{KL_TOL}); backward max {bwd_err:.3e} ({bwd_rel:.3e} x "
              f"max|grad|" + (f", {bwd_ulps:.2f} bf16 ulps beyond 2^-23 of "
                              f"max|grad|, tol 1)" if dx == torch.bfloat16
                              else f", tol {KL_TOL})"))
        R, D = KL_MIXED_TIME
        x = normal(R, D, scale=3.0).to(dx)
        y = normal(R, D, scale=3.0).to(dy)
        g = torch.full((1,), 1.0 / 32, device=x.device).expand(R)
        sx, sy = x.element_size(), y.element_size()
        for key, call, plain, nbytes, kernels in (
                ("fwd", lambda: kl_ops.kl_rows(x, y, KL_T),
                 lambda: port.kl_rows_ref(x, y, KL_T),
                 R * D * (sx + sy) + 4 * R, ("kl_rows_",)),
                ("bwd", lambda: kl_ops.kl_grad(x, y, g, KL_T),
                 lambda: port.kl_grad_ref(x, y, g, KL_T),
                 R * D * (2 * sx + sy) + 4 * R, ("kl_grad_",))):
            ms = time_ms(torch, call)
            dev, = device_ms(torch, [call], kernels)
            plain_ms = time_ms(torch, plain)
            plain_dev, plain_ops = profile_ops(torch, plain)
            bytes_t = nbytes / PEAK_BYTES * 1e3
            ops_t = 16 * R * D / PEAK_FP32 * 1e3
            o = out[(tx, ty, key)] = {
                "ms": ms, "device_ms": dev, "plain_ms": plain_ms,
                "plain_device_ms": plain_dev, "plain_device_ops": plain_ops,
                "bound_ms": max(bytes_t, ops_t),
                "bound_by": "bytes" if bytes_t >= ops_t else "operations",
                "library_ms": None, "shape": [R, D],
                "max_abs_err": fwd_err if key == "fwd" else bwd_err}
            if key == "bwd":
                o["max_rel_err"] = bwd_rel
                if dx == torch.bfloat16:
                    o["max_bf16_ulps"] = bwd_ulps
            print(f"kl_mutual {'forward' if key == 'fwd' else 'backward'} "
                  f"({label}) ({R}, {D}): {ms * 1e3:.2f} us/call (events), "
                  f"device {dev and round(dev * 1e3, 3)} us, plain "
                  f"{plain_ms * 1e3:.2f} us (events), device "
                  f"{plain_dev * 1e3:.3f} us in {plain_ops:.1f} device "
                  f"operations, bound {o['bound_ms'] * 1e3:.3f} us "
                  f"({o['bound_by']}, {nbytes} bytes); library: none")
    return out


def main_path_gram_pairs(cfg, n):
    """(n, d1, d2) of the 8 Gram pairs of one Step-4 inversion: per server
    layer the bias-augmented layer input O (n, d1) and the target Z (n,
    d2), whose OᵀO and OᵀZ one gram_pair launch computes."""
    dims = cfg.layer_dims[cfg.split_index:]
    return [(n, dims[l] + 1, dims[l + 1]) for l in range(len(dims) - 1)]


def main_path_gram_shapes(cfg, n):
    """(n, d1, d2) of the 16 Grams of one Step-4 inversion: per server
    layer OᵀO and OᵀZ on the bias-augmented layer input."""
    shapes = []
    for _, d_in, d_out in main_path_gram_pairs(cfg, n):
        shapes += [(n, d_in, d_in), (n, d_in, d_out)]
    return shapes


# ---------------------------------------------------------------------------
# the serving path: WKV / SSD kernels, RWKV6-1.6B and Zamba2-2.7B
# ---------------------------------------------------------------------------

# (shape, decay): the decay is None for the random one of wkv_inputs /
# ssd_inputs, a number for a constant decay, or "0and1" for the random one
# with exact zeros (about 5 %) and exact ones (about 10 %) among it.  The
# first case is the main path's shape; then a ragged length at full width
# (a last chunk of 17 tokens), one step, small and odd shapes, a strong
# constant decay, a long memory across chunks (0.999) and the exact 0 / 1
# decays; the ragged length, the long memory and the exact 0 / 1 decays are
# also cases of tests/test_torch_cuda.py's test_wkv_kernel_matches_plain /
# test_ssd_kernel_matches_plain
WKV_CASES = [((4, 2048, 32, 64), None), ((4, 2048 + 17, 32, 64), None),
             ((1, 1, 32, 64), None), ((2, 100, 5, 64), None),
             ((1, 100, 2, 128), None), ((2, 50, 3, 16), None),
             ((1, 128, 2, 64), 1e-4), ((1, 2048, 32, 64), 0.999),
             ((1, 300, 8, 64), "0and1")]
SSD_CASES = [((4, 2048, 80, 64, 64), None), ((4, 2048 + 17, 80, 64, 64), None),
             ((1, 1, 80, 64, 64), None), ((2, 100, 5, 64, 64), None),
             ((1, 128, 2, 8, 16), 1e-4), ((2, 37, 3, 16, 32), None),
             ((1, 40, 2, 128, 96), None), ((1, 2048, 80, 64, 64), 0.999),
             ((1, 300, 8, 64, 64), "0and1")]
# tokens of a chunk of the SSD kernel (csrc/mamba2_scan.cu, kQ)
SSD_CHUNK = 32


def exact_0and1(normal, d):
    """d with about 5 % of its entries set to exactly 0 and 10 % to exactly
    1, picked by a normal draw."""
    pick = normal(*d.shape)
    return d.masked_fill(pick < -1.645, 0.0).masked_fill(pick > 1.2816, 1.0)


def wkv_inputs(torch, normal, shape, w_spec):
    """r, k, v, u unit normal; w = sigmoid(normal), a constant, or the
    sigmoid with exact 0s and 1s."""
    b, L, nh, P = shape
    r, k, v = (normal(b, L, nh, P) for _ in range(3))
    if isinstance(w_spec, float):
        w = torch.full((b, L, nh, P), w_spec, device=r.device)
    else:
        w = torch.sigmoid(normal(b, L, nh, P))
        if w_spec == "0and1":
            w = exact_0and1(normal, w)
    return r, k, v, w, normal(nh, P)


def ssd_inputs(torch, normal, shape, a_spec):
    """decay = 0.35 + 0.6·sigmoid(normal), a constant, or the former with
    exact 0s and 1s; dt = softplus of a normal; B, C, x unit normal
    (tests/test_kernels.py's inputs)."""
    b, L, nh, N, P = shape
    if isinstance(a_spec, float):
        decay = torch.full((b, L, nh), a_spec, device=normal(1).device)
    else:
        decay = torch.sigmoid(normal(b, L, nh)) * 0.6 + 0.35
        if a_spec == "0and1":
            decay = exact_0and1(normal, decay)
    dt = torch.nn.functional.softplus(normal(b, L, nh))
    return decay, dt, normal(b, L, N), normal(b, L, N), normal(b, L, nh, P)


def wkv_bound(b, L, nh, P):
    """(bound ms, what bounds it): r, k, v, w read and y written once, u
    read once; 5P² + 5P FP32 operations per (batch, head, step): y = rᵀS
    (2P²), r·(u∘k) and its product with v (5P), S ← S·w + k vᵀ (3P²)."""
    bytes_t = 4 * (5 * b * L * nh * P + nh * P) / PEAK_BYTES * 1e3
    ops_t = b * L * nh * (5 * P * P + 5 * P) / PEAK_FP32 * 1e3
    return max(bytes_t, ops_t), "bytes" if bytes_t >= ops_t else "operations"


def ssd_bound_terms(b, L, nh, N, P, Q=SSD_CHUNK):
    """The terms of the SSD bound, in ms: bytes (x read and y written once,
    decay and dt per (b, t, head), B and C per (b, t)); the sequential
    form's FP32 operations, 5NP + P per (batch, head, step): u = dt·x (P),
    h ← a·h + B u (3NP), y = C h (2NP); and the chunked form's, at Q-token
    chunks of q tokens each: matrix operations at the 3xTF32 rate, C Bᵀ on
    and below the diagonal once per (batch, chunk) (q(q+1)N), and per
    (batch, head, chunk) C h (2qNP), (C Bᵀ ∘ W) U (q(q+1)P) and the state
    update (2qNP); FP32 operations beside them, per (batch, head, chunk) U
    (qP), the decay weights, cum and the product with W (q² in all), y
    (2qP), h ← cum h + … (2NP) and B ∘ W (qN)."""
    bytes_t = 4 * (2 * b * L * nh * P + 2 * b * L * nh + 2 * b * L * N) \
        / PEAK_BYTES * 1e3
    seq_t = b * L * nh * (5 * N * P + P) / PEAK_FP32 * 1e3
    qs = [min(Q, L - t0) for t0 in range(0, L, Q)]
    mma = b * sum(q * (q + 1) * N + nh * (4 * q * N * P + q * (q + 1) * P)
                  for q in qs)
    rest = b * nh * sum(3 * q * P + q * q + 2 * N * P + q * N for q in qs)
    chunked_t = (mma / PEAK_F32_MMA + rest / PEAK_FP32) * 1e3
    return bytes_t, seq_t, chunked_t


def ssd_bound(b, L, nh, N, P):
    """(bound ms, what bounds it): the larger of the bytes and the least
    operations of either form, the sequential form at the FP32 rate or the
    chunked one (the kernel's) on the tensor cores in 3xTF32."""
    bytes_t, seq_t, chunked_t = ssd_bound_terms(b, L, nh, N, P)
    ops_t = min(seq_t, chunked_t)
    return max(bytes_t, ops_t), "bytes" if bytes_t >= ops_t else "operations"


def ssd_bound_sequential(b, L, nh, N, P):
    """The bound of the sequential form alone: the larger of the bytes and
    its FP32 operations."""
    bytes_t, seq_t, _ = ssd_bound_terms(b, L, nh, N, P)
    return max(bytes_t, seq_t)


def check_scan_kernel(torch, name, kernel, plain, cases, make_inputs, bound,
                      dev_names):
    """``kernel`` against ``plain`` at every case (max error within
    SCAN_TOL × max|y|), then times at the first (main-path) shape."""
    worst_abs = worst_rel = 0.0
    for shape, const in cases:
        args = make_inputs(shape, const)
        got, want = kernel(*args), plain(*args)
        check(bool(torch.isfinite(got).all()), f"{name} {shape}: not finite")
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        print(f"{name} {shape}{f' decay {const}' if const else ''}: "
              f"max |kernel - plain| = {err:.3e}, relative {err / scale:.3e}"
              f" (tol {SCAN_TOL} x max|y| = {SCAN_TOL * scale:.3e})")
        check(err <= SCAN_TOL * scale, f"{name} disagrees at {shape}")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel,
                                                        err / scale)
    shape = cases[0][0]
    args = make_inputs(*cases[0])
    ms = time_ms(torch, lambda: kernel(*args), reps=20, inner=5)
    plain_ms = time_ms(torch, lambda: plain(*args), reps=3, inner=1,
                       warmup=1)
    dev_ms, = device_ms(torch, [lambda: kernel(*args)], dev_names, calls=5)
    bound_ms, bound_by = bound(*shape)
    print(f"{name} {shape}: {ms * 1e3:.2f} us/call (events), device "
          f"{dev_ms and round(dev_ms * 1e3, 2)} us, plain "
          f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us "
          f"({bound_by}); library: none (no single PyTorch call computes "
          f"the recurrence)")
    return {"max_abs_err": worst_abs, "max_rel_err": worst_rel, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "device_ms": dev_ms, "shape": list(shape)}


# the flash_attention op.  Full width: (label, (B, H, KV, S, D), window,
# dtype, q offset, k and v offset), q (and k, v) lying that many elements
# past a 16-byte-aligned address (0: aligned, as a fresh tensor is); the
# first case of each route gives that route's headline numbers in the
# kernels line
FLASH_FULL = [
    ("zamba2-2.7b shared attention", (4, 32, 32, 2048, 80), None, "bfloat16",
     0, 0),
    ("zamba2-2.7b shared attention", (4, 32, 32, 2048, 80), None, "float32",
     0, 0),
    ("qwen3-14b attention", (4, 40, 8, 2048, 128), None, "bfloat16", 0, 0),
    ("qwen3-14b sliding window", (1, 40, 8, 16384, 128), 8192, "bfloat16",
     0, 0),
    ("bench_kernels.py shape", (1, 4, 2, 512, 64), None, "float32", 0, 0),
    ("zamba2-2.7b shared attention, q 4 bytes off 16-byte alignment",
     (4, 32, 32, 2048, 80), None, "float32", 1, 0),
    ("zamba2-2.7b shared attention, k and v 4 bytes off 16-byte alignment",
     (4, 32, 32, 2048, 80), None, "float32", 0, 1),
    ("zamba2-2.7b shared attention, q 2 bytes off 16-byte alignment",
     (4, 32, 32, 2048, 80), None, "bfloat16", 1, 0),
    ("zamba2-2.7b shared attention, k and v 2 bytes off 16-byte alignment",
     (4, 32, 32, 2048, 80), None, "bfloat16", 0, 1),
]
# correctness at other shapes, each in f32 and bf16: ((B, H, KV, S, D),
# window, scale, v_shift, qk_shift), V drawn from a normal plus v_shift, q
# and k each from a normal plus qk_shift; tests/test_kernels.py's four
# shapes with and without a window, S 1 / 17 / 100 / 1000, D 32 / 64 / 80 /
# 128, Qwen3-14B's and Zamba2-2.7B's heads, window 512 at S 2048, a window
# of 1, a scale other than 1/sqrt(D), D 40 (a multiple of 8, not of 16), D
# 20 (not a multiple of 8), Qwen3-14B's group of 5 at S 1000 with
# window 100, S 65 (one key past a tile), D 16, 96 and 112 (with 32-80 and
# 128 above, every padded head size of the tensor-core kernel); V of one
# sign (v_shift 2) at Zamba2-2.7B's shape and at Qwen3-14B's window of 8192
# on one KV head, where the terms of P V all have one sign and a truncating
# tensor-core sum would drift with the number of keys (256 tiles of keys in
# the window case); and q and k of one sign (qk_shift 2) at the same two
# shapes, where the terms of S = Q Kᵀ all have one sign (the kernels sum S
# over D in one accumulator).  The same cases as tests/test_torch_cuda.py's
# test_flash_kernel_matches_plain (qk_shift 0) and
# test_flash_kernel_one_sign_qk_matches_plain (qk_shift 2): keep the lists
# equal
FLASH_CASES = [
    ((2, 4, 2, 128, 64), None, None, 0.0, 0.0),
    ((2, 4, 2, 128, 64), 64, None, 0.0, 0.0),
    ((1, 8, 1, 256, 64), None, None, 0.0, 0.0),
    ((1, 8, 1, 256, 64), 64, None, 0.0, 0.0),
    ((2, 3, 3, 96, 32), None, None, 0.0, 0.0),
    ((2, 3, 3, 96, 32), 64, None, 0.0, 0.0),
    ((1, 2, 2, 64, 128), None, None, 0.0, 0.0),
    ((1, 2, 2, 64, 128), 64, None, 0.0, 0.0),
    ((1, 4, 2, 1, 64), None, None, 0.0, 0.0),
    ((1, 4, 2, 17, 80), None, None, 0.0, 0.0),
    ((2, 4, 2, 100, 80), 64, None, 0.0, 0.0),
    ((1, 4, 2, 1000, 128), None, None, 0.0, 0.0),
    ((1, 40, 8, 300, 128), None, None, 0.0, 0.0),
    ((1, 40, 8, 300, 128), 100, None, 0.0, 0.0),
    ((1, 32, 32, 200, 80), None, None, 0.0, 0.0),
    ((1, 4, 2, 2048, 64), 512, None, 0.0, 0.0),
    ((1, 4, 2, 100, 64), 1, None, 0.0, 0.0),
    ((1, 4, 2, 128, 64), None, 0.3, 0.0, 0.0),
    ((1, 4, 2, 100, 40), None, None, 0.0, 0.0),
    ((1, 4, 2, 100, 20), None, None, 0.0, 0.0),
    ((1, 40, 8, 1000, 128), 100, None, 0.0, 0.0),
    ((1, 4, 2, 65, 64), None, None, 0.0, 0.0),
    ((1, 4, 2, 100, 16), 64, None, 0.0, 0.0),
    ((1, 4, 2, 100, 96), 64, None, 0.0, 0.0),
    ((1, 4, 2, 65, 112), None, None, 0.0, 0.0),
    ((4, 32, 32, 2048, 80), None, None, 2.0, 0.0),
    ((1, 5, 1, 16384, 128), 8192, None, 2.0, 0.0),
    ((4, 32, 32, 2048, 80), None, None, 0.0, 2.0),
    ((1, 5, 1, 16384, 128), 8192, None, 0.0, 2.0),
]
# |kernel − plain| ≤ atol + rtol·|plain| per element, as (rtol, atol): in
# f32 the JAX package's own bound (tests/test_kernels.py), sums in another
# order; in bf16 one bf16 unit in the last place of the plain output (2^-7
# of its magnitude), since both sides round an f32 result to nearest, so
# the bound follows the output's scale
FLASH_TOL = {"float32": (0.0, 2e-4), "bfloat16": (2 ** -7, 1e-5)}


# odd head sizes and inputs off 16-byte alignment, each in f32 and bf16:
# ((B, H, KV, S, D), window, q offset, k and v offset) in elements; D 1, 20
# and 127 (2-byte, 4-byte and 2-byte bf16 rows), q, or k and v, or all
# three off alignment, k and v 2 elements off (4-byte copies in bf16), and
# an odd D over 16 KV tiles.  The same cases as tests/test_torch_cuda.py's
# test_flash_odd_d_and_unaligned_inputs_take_the_tensor_cores: keep the
# lists equal
FLASH_ODD = [
    ((1, 4, 2, 100, 1), None, 0, 0), ((1, 4, 2, 100, 20), 64, 0, 0),
    ((1, 4, 2, 100, 127), None, 0, 0), ((1, 4, 2, 100, 64), None, 1, 0),
    ((1, 4, 2, 100, 64), None, 0, 1), ((1, 4, 2, 100, 80), 64, 1, 1),
    ((1, 4, 2, 100, 127), None, 1, 1), ((2, 8, 2, 300, 80), None, 0, 2),
    ((1, 4, 2, 1000, 127), None, 0, 0),
]


# the kernel of each route of the op (ops._route): bf16 and 3xTF32 on the
# tensor cores
FLASH_KERNELS = {
    "mma": ("flash_attn_mma_kernel",
            "src/repro_torch/kernels/csrc/flash_attention_mma.cu"),
    "tf32x3": ("flash_attn_tf32_kernel",
               "src/repro_torch/kernels/csrc/flash_attention_tf32.cu"),
}


def flash_want_route(dtype, D, q_off, kv_off):
    """The (kernel, copy width in bytes) a case should take, by the op's
    documented rule written out independently of ops._route: bf16 on the
    bf16 tensor-core kernel and f32 on the 3xTF32 one; 16-byte copies where
    the offsets ``q_off`` and ``kv_off`` (in elements, from aligned
    addresses; o is a fresh allocation) and a row of D elements are
    multiples of 16 bytes, else 4 where the K/V offset and the row allow,
    else 2."""
    item = 2 if dtype == "bfloat16" else 4
    if (q_off * item % 16 == 0 and kv_off * item % 16 == 0
            and D * item % 16 == 0):
        width = 16
    else:
        width = 4 if kv_off * item % 4 == 0 and D * item % 4 == 0 else 2
    return ("mma" if dtype == "bfloat16" else "tf32x3"), width


def flash_route(fa, q, k, v):
    """The (kernel, copy width) the op takes for q, k, v, by its own rule;
    the output is a fresh allocation of torch's."""
    return fa._route(q.dtype, q.shape[-1],
                     (q.data_ptr(), k.data_ptr(), v.data_ptr(), q.data_ptr()))


def flash_plain_heads(H, KV, S):
    """The query heads the plain version runs on: all of them, or beyond S
    8192 (where 40 heads' f32 scores take about 43 GB) those of KV head 0."""
    return H // KV if S > 8192 else H


def flash_bound(B, H, KV, S, D, window, dtype):
    """(bound ms, what bounds it, operations, bound ms at the FP32 rate or
    None): 4·D operations per visible (query, key) pair at the tensor-core
    peak of the inputs' type (bf16, or f32-accurate 3xTF32 at PEAK_TF32 /
    3); q, k, v read once and o written once.  For f32 the bound at the
    FP32 rate without tensor cores is given beside."""
    w = S if window is None else min(window, S)
    pairs = w * (w + 1) // 2 + (S - w) * w           # per (batch, head)
    ops = 4 * D * pairs * B * H
    item = 2 if dtype == "bfloat16" else 4
    bytes_t = item * 2 * S * D * (B * H + B * KV) / PEAK_BYTES * 1e3
    ops_t = ops / (PEAK_BF16 if dtype == "bfloat16" else PEAK_F32_MMA) * 1e3
    fp32_t = (None if dtype == "bfloat16" else
              max(bytes_t, ops / PEAK_FP32 * 1e3))
    return (max(bytes_t, ops_t), "bytes" if bytes_t >= ops_t else "operations",
            ops, fp32_t)


def flash_phase(torch, port, normal):
    """Phase 2b: the op's main path, the kernel against its plain version,
    and the times at full width."""
    fa = port.fa_ops
    plain = port.flash_ref
    F = torch.nn.functional

    def placed(a, offset):
        """a copied ``offset`` elements past the start of a fresh (aligned)
        allocation (a itself at offset 0)."""
        if not offset:
            return a
        buf = torch.empty(offset + a.numel(), dtype=a.dtype, device=a.device)
        return buf[offset:].view(a.shape).copy_(a)

    def qkv(shape, dtype, q_off=0, kv_off=0):
        """q, k, v from the generator; q ``q_off`` and k, v ``kv_off``
        elements past the start of fresh (aligned) allocations."""
        B, H, KV, S, D = shape
        dt = getattr(torch, dtype)
        q = placed(normal(B, H, S, D).to(dt), q_off)
        return (q, placed(normal(B, KV, S, D).to(dt), kv_off),
                placed(normal(B, KV, S, D).to(dt), kv_off))

    inputs = [qkv(shape, dtype, qo, kvo)
              for _, shape, _, dtype, qo, kvo in FLASH_FULL]

    # the op's main path: each full-width case once, through the public op;
    # the plain version and SDPA are made to fail should the op reach them
    def tripwire(*args, **kwargs):
        fail("flash_attention reached a non-kernel path on a CUDA tensor")
    saved = fa.attention, F.scaled_dot_product_attention
    fa.attention = F.scaled_dot_product_attention = tripwire
    try:
        torch.cuda.synchronize()
        fa.launches = fa.launches_mma = fa.launches_tf32x3 = 0
        outs = [fa.flash_attention(q, k, v, window=c[2])
                for (q, k, v), c in zip(inputs, FLASH_FULL)]
        torch.cuda.synchronize()
        launches = {route: getattr(fa, f"launches_{route}")
                    for route in FLASH_KERNELS}
        total = fa.launches
    finally:
        fa.attention, F.scaled_dot_product_attention = saved
    # every case, aligned or not, takes its dtype's tensor-core kernel, with
    # copies as wide as the offsets allow
    want = [flash_want_route(dt, shape[-1], qo, kvo)
            for _, shape, _, dt, qo, kvo in FLASH_FULL]
    want_launches = {route: [w[0] for w in want].count(route)
                     for route in FLASH_KERNELS}
    print(f"flash_attention main path: {len(FLASH_FULL)} full-width calls, "
          f"{total} launches: {launches['mma']} of the bf16 tensor-core "
          f"kernel, {launches['tf32x3']} of the 3xTF32 kernel")
    check(total == len(FLASH_FULL) and launches == want_launches,
          f"flash_attention launched {total} times, by route {launches}, "
          f"want {len(FLASH_FULL)}, {want_launches}")
    got_routes = [flash_route(fa, *a) for a in inputs]
    check(got_routes == want, f"flash_attention routes {got_routes}, want "
          f"{want}")

    # worst |kernel - plain|, and worst share of the bound, by (route,
    # dtype), for the pairs compared
    worst, worst_share = {}, {}

    def compare(label, got, want, dtype, route):
        check(got.dtype == want.dtype and got.shape == want.shape
              and bool(torch.isfinite(got).all()),
              f"flash_attention {label}: output {got.dtype} {got.shape}")
        rtol, atol = FLASH_TOL[dtype]
        diff = (got.float() - want.float()).abs()
        bound = atol + rtol * want.float().abs()
        err, share = diff.max().item(), (diff / bound).max().item()
        print(f"flash_attention {label} [{route[0]}, copies of "
              f"{route[1]} bytes]: max |kernel - plain| = {err:.3e}, at most "
              f"{share:.3f} of atol {atol} + rtol {rtol} x |plain|")
        check(bool((diff <= bound).all()),
              f"flash_attention disagrees at {label}")
        key = route[0], dtype
        worst[key] = max(worst.get(key, 0.0), err)
        worst_share[key] = max(worst_share.get(key, 0.0), share)
        del diff, bound

    def launch_once(route, call):
        """call() through the op, checked to launch the ``route`` kernel
        once."""
        counter = f"launches_{route[0]}"
        before = fa.launches, getattr(fa, counter)
        out = call()
        check((fa.launches, getattr(fa, counter)) == (before[0] + 1,
                                                      before[1] + 1),
              f"flash_attention did not launch its {route[0]} kernel")
        return out

    for (label, shape, w, dtype, _, _), (q, k, v), o, route in zip(
            FLASH_FULL, inputs, outs, got_routes):
        B, H, KV, S, D = shape
        g = flash_plain_heads(H, KV, S)
        want = plain(q[:, :g], k[:, :g * KV // H], v[:, :g * KV // H],
                     scale=D ** -0.5, window=w)
        if g < H:
            label += f" (query heads 0-{g - 1}, KV head 0)"
        compare(f"{shape} window {w} {dtype} [{label}]", o[:, :g], want,
                dtype, route)
        del want
    del outs
    # the sliding-window case once more in f32, so that the config's own
    # window and its tile skipping are held at f32 precision
    label, shape, w = next(c[:3] for c in FLASH_FULL if c[2] is not None)
    B, H, KV, S, D = shape
    q, k, v = qkv(shape, "float32")
    route = flash_route(fa, q, k, v)
    got = launch_once(route, lambda: fa.flash_attention(q, k, v, window=w))
    g = flash_plain_heads(H, KV, S)
    want = plain(q[:, :g], k[:, :1], v[:, :1], scale=D ** -0.5, window=w)
    compare(f"{shape} window {w} float32 [{label} (query heads 0-{g - 1}, "
            f"KV head 0)]", got[:, :g], want, "float32", route)
    del q, k, v, got, want
    for shape, w, scale, v_shift, qk_shift in FLASH_CASES:
        for dtype in ("float32", "bfloat16"):
            q, k, v = qkv(shape, dtype)
            q, k, v = q + qk_shift, k + qk_shift, v + v_shift
            route = flash_route(fa, q, k, v)
            got = launch_once(route, lambda: fa.flash_attention(
                q, k, v, scale=scale, window=w))
            want = plain(q, k, v, scale=scale or shape[-1] ** -0.5, window=w)
            compare(f"{shape} window {w} scale {scale} v + {v_shift} "
                    f"q, k + {qk_shift} {dtype}", got, want, dtype, route)
            del q, k, v, got, want
    # odd head sizes and inputs off alignment, in both dtypes: the
    # tensor-core kernels with narrower copies
    for shape, w, q_off, kv_off in FLASH_ODD:
        for dtype in ("float32", "bfloat16"):
            q, k, v = qkv(shape, dtype, q_off, kv_off)
            route = flash_route(fa, q, k, v)
            check(route == flash_want_route(dtype, shape[-1], q_off, kv_off),
                  f"{shape} {dtype} offsets {q_off}, {kv_off} routed to "
                  f"{route}")
            got = launch_once(route, lambda: fa.flash_attention(q, k, v,
                                                                window=w))
            want = plain(q, k, v, scale=shape[-1] ** -0.5, window=w)
            compare(f"{shape} window {w} q {q_off} and k, v {kv_off} "
                    f"elements off alignment {dtype}", got, want, dtype,
                    route)
            del q, k, v, got, want
    torch.cuda.empty_cache()

    # times at full width
    from torch.nn.attention import SDPBackend, sdpa_kernel
    cases = []
    names = tuple(name for name, _ in FLASH_KERNELS.values())
    for (label, shape, w, dtype, q_off, kv_off), (q, k, v), route in zip(
            FLASH_FULL, inputs, got_routes):
        B, H, KV, S, D = shape
        big = S > 8192
        reps, inner = (3, 1) if big else (10, 2) if S >= 2048 else (50, 10)
        ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, window=w),
                     reps=reps, inner=inner, warmup=2)
        dev_ms, = device_ms(
            torch, [lambda: fa.flash_attention(q, k, v, window=w)],
            names, calls=3 if big else 10)
        g = flash_plain_heads(H, KV, S)
        kp, vp = k[:, :g * KV // H], v[:, :g * KV // H]
        plain_ms = time_ms(torch, lambda: plain(q[:, :g], kp, vp,
                                                scale=D ** -0.5, window=w),
                           reps=3, inner=1, warmup=1)
        torch.cuda.empty_cache()
        # the yardstick: one SDPA call (never called by the port); the
        # window needs a boolean mask, and the KV heads repeated beforehand
        # so that the memory-efficient kernel takes it; inputs off
        # alignment are given to it as aligned copies (its kernel faults on
        # the views)
        qs, ks, vs = ((a.clone() for a in (q, k, v)) if q_off or kv_off
                      else (q, k, v))
        if w is None:
            ctx = contextlib.nullcontext()
            kr, vr, mask, gqa = ks, vs, None, True
        else:
            ctx = sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION])
            kr, vr = (a.repeat_interleave(H // KV, 1) for a in (ks, vs))
            i = torch.arange(S, device=q.device)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
            gqa = False
        with ctx:
            lib_ms = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qs, kr, vr, attn_mask=mask, is_causal=w is None,
                    enable_gqa=gqa, scale=D ** -0.5),
                reps=reps, inner=inner, warmup=2)
        del qs, ks, vs, kr, vr, mask
        torch.cuda.empty_cache()
        bound_ms, bound_by, ops, fp32_ms = flash_bound(*shape, w, dtype)
        rate = ops / (dev_ms or ms) / 1e9
        print(f"flash_attention {shape} window {w} {dtype} [{label}] "
              f"[{route[0]}, copies of {route[1]} bytes]: "
              f"{ms * 1e3:.2f} us/call (events), device "
              f"{dev_ms and round(dev_ms * 1e3, 2)} us = {rate:.2f} TFLOP/s, "
              f"bound {bound_ms * 1e3:.2f} us ({bound_by}"
              + (f"; at the FP32 rate {fp32_ms * 1e3:.2f} us" if fp32_ms
                 else "") + "), plain "
              f"{plain_ms * 1e3:.1f} us"
              f"{f' (on {g} query heads of KV head 0)' if g < H else ''}, "
              f"SDPA {lib_ms * 1e3:.2f} us"
              f"{' (on aligned copies)' if q_off or kv_off else ''}")
        cases.append({"label": label, "shape": list(shape), "window": w,
                      "dtype": dtype, "route": route[0],
                      "copy_bytes": route[1], "q_offset": q_off,
                      "kv_offset": kv_off, "ms": ms, "device_ms": dev_ms,
                      "tflops": rate, "plain_ms": plain_ms,
                      "plain_heads": g, "library_ms": lib_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "bound_fp32_ms": fp32_ms})
    del inputs
    torch.cuda.empty_cache()
    out = {}
    for route in FLASH_KERNELS:
        mine = [c for c in cases if c["route"] == route]
        head = mine[0]
        # the errors of the dtype this route was compared in (each
        # tensor-core kernel takes one dtype)
        errs = {}
        for dt, short in (("float32", "f32"), ("bfloat16", "bf16")):
            if (route, dt) in worst:
                errs[f"max_abs_err_{short}"] = worst[route, dt]
                errs[f"max_share_of_tol_{short}"] = worst_share[route, dt]
        out[route] = {
            "launches": launches[route],
            "max_abs_err": max(worst[key] for key in worst
                               if key[0] == route),
            **errs,
            **{key: head[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "device_ms", "shape", "dtype")},
            "cases": mine}
    return out


def zoo_counter(port, cfg):
    """The launch counter of the scan kernel of ``cfg``'s family."""
    return port.wkv_ops if cfg.family == "ssm" else port.ssd_ops


def zoo_consistency(torch, port, arch, dev):
    """Full width and depth in f32: the kernel-preset prefill against the
    last logits of a decode_step replay of the same prompts and against the
    reference preset; one scan launch per layer, none in the replay."""
    cfg = dataclasses.replace(port.get_config(arch), dtype="float32")
    model = port.build_model(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (4, CONSIST_LEN),
                            generator=gen, device=dev)
    counter = zoo_counter(port, cfg)
    prefill = port.make_prefill_step(model)
    with torch.no_grad():
        counter.launches = 0
        got = prefill({"tokens": prompts})
        torch.cuda.synchronize()
        per_forward = counter.launches
        model.policy = port.dispatch.get_policy("reference")
        ref = prefill({"tokens": prompts})
        model.policy = port.dispatch.get_policy("kernel")
        cache = model.init_cache(4)
        for t in range(CONSIST_LEN):
            logits, cache = model.decode_step(prompts[:, t:t + 1], cache,
                                              position=t)
        replay = logits[:, -1]
        # the f32 noise floor of the plain network, with no kernel in it:
        # the reference preset on the first two prompts alone (its GEMMs
        # at another M) and the replay, each against the 4-prompt run
        model.policy = port.dispatch.get_policy("reference")
        ref2 = prefill({"tokens": prompts[:2]})
        model.policy = port.dispatch.get_policy("kernel")
        torch.cuda.synchronize()
    scale = ref.abs().max().item()
    e_replay = (got - replay).abs().max().item() / scale
    e_ref = (got - ref).abs().max().item() / scale
    floor = ((ref[:2] - ref2).abs().max().item() / scale,
             (ref - replay).abs().max().item() / scale)
    print(f"{arch} f32 full width, 4 x {CONSIST_LEN} tokens: prefill vs "
          f"replay {e_replay:.3e} x max|logits| (tol {REPLAY_TOL}), vs "
          f"reference preset {e_ref:.3e} (tol {PRESET_TOL}), max|logits| "
          f"{scale:.3f}; {per_forward} scan launches per forward; plain "
          f"network alone: batch 2 vs 4 {floor[0]:.3e}, reference vs replay "
          f"{floor[1]:.3e}")
    check(all(bool(torch.isfinite(a).all()) for a in (got, ref, replay)),
          f"{arch}: non-finite logits")
    check(per_forward == cfg.n_layers,
          f"{arch}: {per_forward} scan launches per forward, want "
          f"{cfg.n_layers}")
    check(counter.launches == cfg.n_layers,
          f"{arch}: the reference preset or the replay launched the kernel")
    check(e_replay <= REPLAY_TOL, f"{arch}: prefill and replay disagree")
    check(e_ref <= PRESET_TOL, f"{arch}: kernel and reference disagree")
    del model, cache
    torch.cuda.empty_cache()
    return e_replay, e_ref


def device_busy_ms(evts) -> float:
    return sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in evts) / 1e3


def zoo_serve(torch, port, arch, dev, smi):
    """The serving path of the bf16 model: PREFILL_RUNS prefills through
    make_prefill_step at PREFILL_B × PREFILL_LEN, then repro_torch.serve's
    replay + greedy decode of SERVE_B requests; the launch counters are set
    to 0 just before and read just after.  Then one profiled prefill and
    eight profiled decode steps."""
    cfg = port.get_config(arch)
    model = port.build_model(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    long = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_LEN),
                         generator=gen, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT),
                            generator=gen, device=dev)
    prefill = port.make_prefill_step(model)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        torch.cuda.synchronize()
        port.wkv_ops.launches = port.ssd_ops.launches = 0
        times = []
        for _ in range(PREFILL_RUNS):
            t0 = time.perf_counter()
            last = prefill({"tokens": long})
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        served = port.serve.generate(model, prompts, SERVE_NEW)
        torch.cuda.synchronize()
        launches = {"rwkv6_wkv": port.wkv_ops.launches,
                    "mamba2_scan": port.ssd_ops.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    own = "rwkv6_wkv" if cfg.family == "ssm" else "mamba2_scan"
    check(launches[own] == PREFILL_RUNS * cfg.n_layers,
          f"{arch}: {launches[own]} {own} launches, want "
          f"{PREFILL_RUNS * cfg.n_layers}")
    check(sum(launches.values()) == launches[own],
          f"{arch}: launched the other family's kernel: {launches}")
    check(bool(torch.isfinite(last).all()) and last.shape == (
        PREFILL_B, cfg.vocab_size), f"{arch}: prefill logits {last.shape}")
    toks = served.tokens
    check(toks.shape == (SERVE_B, SERVE_NEW) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab_size, f"{arch}: served {toks}")
    prefill_ms = statistics.median(times[1:])
    decode_steps = SERVE_NEW - 1
    step_ms = served.decode_s * 1e3 / decode_steps
    print(f"{arch} bf16 served | {smi}: prefill {PREFILL_B} x "
          f"{PREFILL_LEN} through make_prefill_step {prefill_ms:.2f} ms "
          f"(median of {PREFILL_RUNS - 1} after a warm-up {times[0]:.2f} "
          f"ms) = {PREFILL_B * PREFILL_LEN / prefill_ms * 1e3:.0f} tokens/s;"
          f" serve: replay of {SERVE_B} x {SERVE_PROMPT} prompt tokens "
          f"{served.prefill_s * 1e3:.1f} ms, {decode_steps} decode steps "
          f"{step_ms:.2f} ms/step = {SERVE_B / step_ms * 1e3:.1f} tokens/s;"
          f" launches {launches}; peak memory {peak_gb:.2f} GB; request 0 "
          f"tokens {toks[0, :8].tolist()}")

    # one profiled prefill: device busy time and the heaviest kernels
    with torch.no_grad():
        profiled(torch, lambda: prefill({"tokens": long}),
                 f"{arch} profiled prefill")
        # eight profiled decode steps after an 8-token replay
        _, _, cache = profiled_decode(torch, port, model, prompts,
                                      model.init_cache(SERVE_B), arch, top=0)
    del model, cache
    torch.cuda.empty_cache()
    return launches[own], prefill_ms, step_ms


def zoo_card_vs_cpu(torch, port, arch):
    """The reduced f32 model on the card (scan kernels) and on the CPU
    (plain scans), same weights, tokens and frontend embeddings: forward
    logits (and MTP logits) and 8 decode steps (an enc-dec's from its own
    encoder's memory), largest difference relative to max|logits|."""
    cfg = port.get_config(arch).reduced()
    mc = port.build_model(cfg, device="cuda")
    mp = port.build_model(cfg, device="cpu")
    mp.load_state_dict({k: v.cpu() for k, v in mc.state_dict().items()})
    cpu_gen = torch.Generator().manual_seed(2)
    tok = torch.randint(0, cfg.vocab_size, (2, 16), generator=cpu_gen)
    batch = {"tokens": tok}
    if cfg.frontend:
        batch["embeds"] = torch.randn(2, cfg.frontend_positions, cfg.d_model,
                                      generator=cpu_gen)
    on_card = {k: v.cuda() for k, v in batch.items()}
    with torch.no_grad():
        lc, xc = mc.forward(on_card)
        lp, xp = mp.forward(batch)
        scale = lp.abs().max().item()
        e_fwd = (lc.cpu() - lp).abs().max().item() / scale
        if "mtp_logits" in xp:
            e_fwd = max(e_fwd, (xc["mtp_logits"].cpu() - xp["mtp_logits"])
                        .abs().max().item() / scale)
        e_dec = 0.0
        if cfg.is_enc_dec:
            cc = mc.init_cache(2, memory=mc.encode(on_card["embeds"]))
            cp = mp.init_cache(2, memory=mp.encode(batch["embeds"]))
        else:
            cc, cp = mc.init_cache(2), mp.init_cache(2)
        for t in range(8):
            a, cc = mc.decode_step(tok[:, t:t + 1].cuda(), cc)
            b, cp = mp.decode_step(tok[:, t:t + 1], cp)
            e_dec = max(e_dec, (a.cpu() - b).abs().max().item() / scale)
    print(f"{arch} reduced f32, card vs CPU: forward {e_fwd:.3e}, 8 decode "
          f"steps {e_dec:.3e} x max|logits| (tol {ZOO_CARD_CPU_TOL})")
    check(e_fwd <= ZOO_CARD_CPU_TOL and e_dec <= ZOO_CARD_CPU_TOL,
          f"{arch}: card and CPU disagree")
    return e_fwd, e_dec


# the decoder and enc-dec families (phase 4), bf16 with weights from seed
# 0, at full width and depth: (arch, config cuts, prefill requests).
# DeepSeek-V3 keeps its published widths and MTP block with n_layers cut
# from 61 to 1 (~25 B parameters, ~50 GB in bf16) and prefills 1 request of
# PREFILL_LEN (the f32 scores of its 128 heads take 2.1 GB a request at
# each of its 3 softmax stages)
DECODER_ARCHS = (("qwen3-14b", {}, PREFILL_B),
                 ("granite-moe-3b-a800m", {}, PREFILL_B),
                 ("internvl2-1b", {}, PREFILL_B),
                 ("seamless-m4t-medium", {}, PREFILL_B),
                 ("deepseek-v3-671b", {"n_layers": 1}, 1))
DECODER_PREFILL_RUNS = 2    # a warm-up and a timed run
# the f32 prefill-vs-replay gate (REPLAY_TOL) at full width and depth:
# Qwen3-14B (59 GB in f32), InternVL2-1B on tokens alone (the replay
# carries no prefix, as in the JAX example), Seamless with one memory on
# both sides, Granite-MoE at capacity_factor = n_experts / top_k (a prefill
# routes 4 x DECODER_CONSIST_LEN tokens together and a decode step 4: their
# capacities, and so the tokens they drop, differ otherwise)
DECODER_GATES = ("qwen3-14b", "internvl2-1b", "seamless-m4t-medium",
                 "granite-moe-3b-a800m")
# replayed tokens (~65 ms a step at 40 layers; 48 until phase 6 came, the
# script's time)
DECODER_CONSIST_LEN = 32
# phase 5's reduced card-vs-CPU check: every zoo config
CARD_CPU_ARCHS = ZOO_ARCHS + tuple(a for a, _, _ in DECODER_ARCHS) + (
    "smollm-135m", "granite-20b", "nemotron-4-15b")


def scan_and_flash_launches(port) -> dict:
    return {"flash_attention (mma)": port.fa_ops.launches_mma,
            "flash_attention (tf32x3)": port.fa_ops.launches_tf32x3,
            "rwkv6_wkv": port.wkv_ops.launches,
            "mamba2_scan": port.ssd_ops.launches}


def zero_launches(port) -> None:
    port.fa_ops.launches = port.fa_ops.launches_mma = 0
    port.fa_ops.launches_tf32x3 = 0
    port.wkv_ops.launches = port.ssd_ops.launches = 0


@contextlib.contextmanager
def counting_drops(port):
    """Counts, on the device, the (token, expert) pairs that an expert's
    capacity dropped in each MoE dispatch while the block runs, and the
    fullest expert's load: a list of (dropped, pairs, most pairs an expert
    was routed, experts), one a dispatch."""
    plain = port.moe.dispatch_slots
    counts = []

    def counted(flat_e, n_experts, cap):
        order, slot, keep = plain(flat_e, n_experts, cap)
        load = flat_e.new_zeros(n_experts).scatter_add_(
            0, flat_e, flat_e.new_ones(flat_e.shape))
        counts.append(((~keep).sum(), keep.numel(), load.max(), n_experts))
        return order, slot, keep
    port.moe.dispatch_slots = counted
    try:
        yield counts
    finally:
        port.moe.dispatch_slots = plain


def drops(counts) -> tuple:
    """(pairs dropped, pairs routed, the largest load of an expert over its
    dispatch's mean, at most)."""
    return (int(sum(int(c[0]) for c in counts)),
            int(sum(c[1] for c in counts)),
            max((int(c[2]) * c[3] / c[1] for c in counts), default=0.0))


def frontend_batch(torch, cfg, tokens, gen):
    """The tokens and, for a vlm or an enc-dec, the stub frontend's
    embeddings (one request's frontend_positions x d_model from ``gen``)."""
    batch = {"tokens": tokens}
    if cfg.frontend:
        batch["embeds"] = torch.randn(
            tokens.shape[0], cfg.frontend_positions, cfg.d_model,
            generator=gen, device=tokens.device).to(getattr(torch, cfg.dtype))
    return batch


def profiled(torch, fn, label: str, steps: int = 1, top: int = 8):
    """fn under the profiler: wall and device-busy ms, idle share, device
    operations (a step) and the ``top`` heaviest operations, printed."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evts = key_averages(torch, prof)
    busy = device_busy_ms(evts)
    ops = sum(e.count for e in evts)
    print(f"{label}: wall {wall:.2f} ms, device busy {busy:.2f} ms, idle "
          f"share {1 - busy / wall:.4f}, {ops / steps:.0f} device operations"
          f"{' per step' if steps > 1 else ''}")
    for e in sorted(evts, key=lambda e: device_busy_ms([e]),
                    reverse=True)[:top]:
        print(f"  {device_busy_ms([e]):9.3f} ms {e.count:6d} calls  "
              f"{e.key[:80]}")
    return wall, busy


def profiled_decode(torch, port, model, prompts, cache, label: str,
                    top: int = 8):
    """Eight profiled serve steps of the prompts' requests after an 8-token
    replay into ``cache``: (wall ms, busy ms, the cache)."""
    for t in range(8):
        logits, cache = model.decode_step(prompts[:, t:t + 1], cache,
                                          position=t)
    serve_step = port.make_serve_step(model)
    state = {"tok": torch.argmax(logits[:, -1:], -1), "cache": cache}

    def steps():
        for _ in range(8):
            lg, state["cache"] = serve_step(state["tok"], state["cache"])
            state["tok"] = torch.argmax(lg, -1)[:, None]
    wall, busy = profiled(torch, steps, f"{label} profiled decode, 8 steps "
                          f"of {prompts.shape[0]} requests", steps=8, top=top)
    return wall, busy, state["cache"]


def decoder_serve(torch, port, arch, cuts, prefill_b, dev, smi):
    """The served bf16 model of a decoder or enc-dec family: prefills
    through make_prefill_step at prefill_b x PREFILL_LEN (with the vision
    prefix or the encoder's frames), then repro_torch.serve's replay +
    greedy decode of SERVE_B requests, with the kernels' counters set to 0
    just before and read just after (no kernel lies on these paths: each
    must stay 0); then one profiled prefill and eight profiled decode
    steps (an enc-dec's from the memory of its encoder)."""
    cfg = dataclasses.replace(port.get_config(arch), **cuts)
    torch.cuda.empty_cache()    # the last model's blocks
    t0 = time.perf_counter()
    model = port.build_model(cfg, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device=dev).manual_seed(1)
    long = frontend_batch(torch, cfg, torch.randint(
        0, cfg.vocab_size, (prefill_b, PREFILL_LEN), generator=gen,
        device=dev), gen)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT),
                            generator=gen, device=dev)
    prefill = port.make_prefill_step(model)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad(), counting_drops(port) as moe_counts:
        torch.cuda.synchronize()
        zero_launches(port)
        times = []
        for _ in range(DECODER_PREFILL_RUNS):
            t0 = time.perf_counter()
            last = prefill(long)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        n_prefill = len(moe_counts)
        served = port.serve.generate(model, prompts, SERVE_NEW)
        torch.cuda.synchronize()
        launches = scan_and_flash_launches(port)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(not any(launches.values()),
          f"{arch}: a kernel launched on a path that has none: {launches}")
    check(bool(torch.isfinite(last).all()) and last.shape == (
        prefill_b, cfg.vocab_size), f"{arch}: prefill logits {last.shape}")
    toks = served.tokens
    check(toks.shape == (SERVE_B, SERVE_NEW) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab_size, f"{arch}: served {toks}")
    prefill_ms = times[-1]
    seq = PREFILL_LEN + (cfg.frontend_positions
                         if cfg.frontend and not cfg.is_enc_dec else 0)
    decode_steps = SERVE_NEW - 1
    step_ms = served.decode_s * 1e3 / decode_steps
    out = {"params": n_params, "build_s": build_s, "prefill_ms": prefill_ms,
           "prefill_tokens_per_s": prefill_b * PREFILL_LEN / prefill_ms * 1e3,
           "decode_ms_per_step": step_ms, "peak_gb": peak_gb,
           "launches": launches}
    extra = ""
    if cfg.frontend:
        extra = (f" (+ {cfg.frontend_positions} frontend positions a request"
                 f"{', the encoder memory' if cfg.is_enc_dec else ''})")
    print(f"{arch} bf16 served{' ' + str(cuts) if cuts else ''} | {smi}: "
          f"{n_params / 1e9:.3f} B params built in {build_s:.1f} s; prefill "
          f"{prefill_b} x {PREFILL_LEN}{extra} through make_prefill_step "
          f"{prefill_ms:.2f} ms (after a warm-up {times[0]:.2f} ms) = "
          f"{out['prefill_tokens_per_s']:.0f} tokens/s ({seq} positions a "
          f"request); serve: replay of {SERVE_B} x {SERVE_PROMPT} prompt "
          f"tokens {served.prefill_s * 1e3:.1f} ms, {decode_steps} decode "
          f"steps {step_ms:.2f} ms/step = {SERVE_B / step_ms * 1e3:.1f} "
          f"tokens/s; kernel launches {launches}; peak memory {peak_gb:.2f} "
          f"GB; request 0 tokens {toks[0, :8].tolist()}")
    if cfg.moe:
        out["dropped_prefill"] = drops(moe_counts[:n_prefill])
        out["dropped_decode"] = drops(moe_counts[n_prefill:])
        dp, dd = out["dropped_prefill"], out["dropped_decode"]
        print(f"{arch} capacity drops ((token, expert) pairs dropped / "
              f"routed; capacity_factor {cfg.moe.capacity_factor}): "
              f"{DECODER_PREFILL_RUNS} prefills {dp[0]} / {dp[1]} "
              f"({dp[0] / dp[1]:.4f}) in {n_prefill} dispatches (capacity "
              f"{port.moe.capacity(prefill_b * seq, cfg.moe)} at T "
              f"{prefill_b * seq}; the fullest expert up to {dp[2]:.2f}x the "
              f"mean load), serve {dd[0]} / {dd[1]} ({dd[0] / dd[1]:.4f}; "
              f"capacity {port.moe.capacity(SERVE_B, cfg.moe)} at T "
              f"{SERVE_B}; up to {dd[2]:.2f}x)")

    with torch.no_grad():
        wall, busy = profiled(torch, lambda: prefill(long),
                              f"{arch} profiled prefill")
        out["prefill_idle_share"] = 1 - busy / wall
        if cfg.is_enc_dec:
            cache = model.init_cache(
                SERVE_B, memory=model.encode(long["embeds"][:SERVE_B]))
        else:
            cache = model.init_cache(SERVE_B)
        wall, busy, cache = profiled_decode(
            torch, port, model, prompts, cache,
            arch + (" (from the encoder memory)" if cfg.is_enc_dec else ""))
        out["decode_idle_share"] = 1 - busy / wall
    if cfg.attention_kind == "mla":
        c = cache[0]
        W = c.c_kv.shape[1]
        per_token = (c.c_kv[0, 0].numel() * c.c_kv.element_size()
                     + c.k_rope[0, 0].numel() * c.k_rope.element_size())
        # 2 · heads · head_dim (tests/test_models_extra.py's claim)
        gqa = (2 * cfg.n_kv_heads * cfg.mla.qk_nope_head_dim
               * c.c_kv.element_size())
        out["mla_cache_bytes_per_token"] = per_token
        print(f"{arch} MLA cache: {per_token} bytes a token and layer (the "
              f"latent {cfg.mla.kv_lora_rank} + rope {cfg.mla.qk_rope_head_dim}"
              f" in {cfg.dtype}; {SERVE_B} x {W} slots); a GQA cache of "
              f"{cfg.n_kv_heads} K and V heads of {cfg.mla.qk_nope_head_dim} "
              f"would hold {gqa} ({gqa / per_token:.1f}x)")
    return out


def decoder_consistency(torch, port, arch, dev):
    """Full width and depth in f32: the prefill's last logits against a
    decode_step replay of the same DECODER_CONSIST_LEN-token prompts (an
    enc-dec's from the memory of the prefill's frames), and the plain
    network's own floor: the first two prompts' prefill against the
    four's."""
    cfg = dataclasses.replace(port.get_config(arch), dtype="float32")
    torch.cuda.empty_cache()    # the bf16 model's blocks
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    model = port.build_model(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (4, DECODER_CONSIST_LEN),
                            generator=gen, device=dev)
    batch = {"tokens": prompts}
    if cfg.is_enc_dec:
        batch = frontend_batch(torch, cfg, prompts, gen)
    prefill = port.make_prefill_step(model)
    with torch.no_grad(), counting_drops(port) as moe_counts:
        zero_launches(port)
        got = prefill(batch)
        two = prefill({k: v[:2] for k, v in batch.items()})
        cache = (model.init_cache(4, memory=model.encode(batch["embeds"]))
                 if cfg.is_enc_dec else model.init_cache(4))
        for t in range(DECODER_CONSIST_LEN):
            logits, cache = model.decode_step(prompts[:, t:t + 1], cache,
                                              position=t)
        replay = logits[:, -1]
        torch.cuda.synchronize()
        launches = scan_and_flash_launches(port)
    scale = got.abs().max().item()
    e_replay = (got - replay).abs().max().item() / scale
    floor = (got[:2] - two).abs().max().item() / scale
    dropped = drops(moe_counts)
    print(f"{arch} f32 full width, 4 x {DECODER_CONSIST_LEN} tokens"
          f"{' (+ the memory of ' + str(cfg.frontend_positions) + ' frames)' if cfg.is_enc_dec else ''}: "
          f"prefill vs replay {e_replay:.3e} x max|logits| (tol "
          f"{REPLAY_TOL}), max|logits| {scale:.3f}; plain network alone: "
          f"batch 2 vs 4 {floor:.3e}"
          + (f"; capacity_factor {cfg.moe.capacity_factor}, pairs dropped "
             f"{dropped[0]} / {dropped[1]}" if cfg.moe else ""))
    check(all(bool(torch.isfinite(a).all()) for a in (got, replay)),
          f"{arch}: non-finite logits")
    check(not any(launches.values()),
          f"{arch}: a kernel launched on a path that has none: {launches}")
    check(dropped[0] == 0, f"{arch}: capacity dropped {dropped[0]} pairs")
    check(e_replay <= REPLAY_TOL, f"{arch}: prefill and replay disagree")
    return e_replay


# zoo training (phase 6).  The CPU tests' bounds (tests/test_torch_train.py,
# each with its reason there): losses at TRAIN_LOSS_TOL; AdamW's first-step
# moments at TRAIN_MOMENT_TOL of their leaf's max and its parameters within
# 2 lr a step (Adam's first steps are about -lr sign(g), so an element of
# |g| near eps may move either way); Adafactor's state at FACTOR_TOL and its
# parameters at FACTOR_PARAM_TOL of their leaf's move plus an f32 ulp a
# step; bf16 at BF16_TRAIN_TOL plus a bf16 ulp.  6a: the README line of the
# example at full size (SmolLM-135M, f32, AdamW) and its first
# TRAIN_CMP_STEPS steps on the card and the CPU from the same weights and
# tokens; 6b: SmolLM-135M at phase 4's prefill shape without remat, with it
# and with the "dots" policy (their loss and gradients at the same weights
# within REMAT_TOL of no remat's, relative: the embedding backward's atomics
# keep the card from bit equality); 6c: Granite-MoE-3B-A800M at full width
# and depth in bf16 with remat, MOE_TRAIN_STEPS AdamW steps on one
# memorisable batch of MOE_TRAIN_B x MOE_TRAIN_S (the last loss below the
# first, the JAX package's MoE rule); 6d: every reduced config card vs
# CPU; 6e: the DNN10 SplitMe campaign under gelu and squared ReLU
TRAIN_LR = 3e-4
TRAIN_CMP_STEPS = 3
TRAIN_README = ["--arch", "smollm-135m", "--steps", "20", "--batch", "2",
                "--seq", "64"]
TRAIN_LOSS_TOL = 1e-5
TRAIN_MOMENT_TOL = 1e-5
FACTOR_TOL, FACTOR_PARAM_TOL = 1e-5, 1e-4
BF16_TRAIN_TOL = 1e-3
REMAT_TOL = 1e-6
REMAT_MODES = (("no remat", False, None), ("remat", True, None),
               ("remat dots", True, "dots"))
REMAT_TIMED = 2
MOE_TRAIN_B, MOE_TRAIN_S, MOE_TRAIN_STEPS = 4, 512, 5
TRAIN_CARD_CPU_STEPS = 2
# the rates of tests/test_torch_activations.py: squared ReLU diverges at
# the default ones in both packages, and its DNN10 weights can reach the
# edge of f32 overflow (its CPU test's campaign is NaN from round 0's server
# phase on), so the card and the CPU are held on the losses: finite ones at
# CARD_CPU_TOL relative, NaN where NaN
A14_RUNS = (("gelu", {}), ("squared_relu", {"lr_c": 1e-3, "lr_s": 5e-4}))


def flat_leaves(tree, prefix=""):
    """{dotted path: numpy array} of a nested dict of numpy leaves."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def bf16_ulp_of(torch, w):
    """One bf16 unit in the last place of each |w| (f32's spacing x 2^16:
    bf16 keeps 7 of f32's 23 mantissa bits)."""
    import numpy as np
    return torch.from_numpy(np.spacing(w.abs().numpy()) * 2.0 ** 16)


def named_params(model) -> dict:
    return {n: p.detach().float().cpu() for n, p in model.named_parameters()}


def train_run(torch, port, model, batches, optimizer="adamw", lr=TRAIN_LR,
              grad_dtype=None, keep_first=True):
    """Steps of make_train_step on ``batches``: (losses, the optimizer
    state after the first step in the reference's layout on the host if
    ``keep_first``, wall ms a step)."""
    init_state, train_step = port.make_train_step(
        model, optimizer=optimizer, lr=lr, grad_dtype=grad_dtype)
    state, step = init_state()
    losses, first, ms = [], None, []
    for b in batches:
        t0 = time.perf_counter()
        state, step, m = train_step(state, step, b)
        losses.append(m["loss"].item())
        ms.append((time.perf_counter() - t0) * 1e3)
        if keep_first and first is None:
            first = flat_leaves(port.opt_state_to_numpy(model.cfg, optimizer,
                                                        state))
    return losses, first, ms


def train_card_vs_cpu(torch, port, cfg, batches, optimizer="adamw",
                      grad_dtype=None, card=None):
    """The same weights and batches through make_train_step on the card and
    on the CPU: the largest loss difference, the largest parameter
    difference over its bound, the largest first-step state difference
    over its leaf's max, and the card's losses and ms a step."""
    import numpy as np
    card = card or port.build_model(cfg, device="cuda", policy="reference")
    cpu = port.build_model(cfg, device="cpu", policy="reference")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    init = named_params(card)
    out = {}
    for name, model, dev in (("card", card, "cuda"), ("cpu", cpu, "cpu")):
        out[name] = train_run(
            torch, port, model,
            [{k: v.to(dev) for k, v in b.items()} for b in batches],
            optimizer, grad_dtype=grad_dtype) + (named_params(model),)
    (lc, sc, ms, pc), (lp, sp, _, pp) = out["card"], out["cpu"]
    n = len(batches)
    lerr = max(abs(a - b) for a, b in zip(lc, lp))
    worst = 0.0      # parameter difference over its bound, largest
    for k, w in pp.items():
        err = (pc[k] - w).abs()
        if optimizer == "adafactor":
            bound = (FACTOR_PARAM_TOL * (w - init[k]).abs().max()
                     + n * torch.from_numpy(np.spacing(w.abs().numpy())))
        else:
            bound = 2 * TRAIN_LR * n + (
                0.0 if grad_dtype is None and cfg.dtype == "float32"
                else bf16_ulp_of(torch, w))
        worst = max(worst, (err / bound).max().item())
    serr = float(max(np.abs(sc[k] - v).max() / max(np.abs(v).max(), 1e-30)
                     for k, v in sp.items()))
    return lerr, worst, serr, lc, ms


def train_batches(torch, cfg, n, B=2, S=32, seed=5):
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        b = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen)}
        if cfg.frontend:
            b["embeds"] = torch.randn(B, cfg.frontend_positions, cfg.d_model,
                                      generator=gen)
        out.append(b)
    return out


def pretrain_phase(torch, port, smi):
    """6a: the README line of the port's lm_pretrain example at full size
    on the card, then its first TRAIN_CMP_STEPS steps from the same seed-0
    weights and tokens on the card and the CPU."""
    import io
    import re
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        losses = port.lm_pretrain.main(TRAIN_README)
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"  lm_pretrain {' '.join(TRAIN_README)}: {line}")
    check(len(losses) == 20 and all(abs(v) < float("inf") for v in losses),
          f"lm_pretrain losses {losses}")
    check(lines[0].startswith("arch=smollm-135m params=134.5M "
                              "optimizer=adamw"), lines[0])
    cfg = dataclasses.replace(port.get_config("smollm-135m"),
                              dtype="float32")
    stream = port.lm_pretrain.token_stream(cfg.vocab_size, 2, 64)
    batches = [{"tokens": torch.from_numpy(next(stream))}
               for _ in range(TRAIN_CMP_STEPS)]
    card = port.build_model(cfg, remat=False, device="cuda",
                            policy="reference")
    lerr, worst, serr, lc, ms = train_card_vs_cpu(torch, port, cfg, batches,
                                                  card=card)
    same = max(abs(a - b) for a, b in zip(lc, losses))
    print(f"6a lm_pretrain README line: 20 steps in {wall:.2f} s (build "
          f"included), printed {re.findall(r'[0-9.]+s/step', lines[-1])}; "
          f"card vs CPU over {TRAIN_CMP_STEPS} steps (TF32 off): loss "
          f"{lerr:.3e} (tol {TRAIN_LOSS_TOL}), params {worst:.3f} of 2 lr a "
          f"step, first-step moments {serr:.3e} of their max (tol "
          f"{TRAIN_MOMENT_TOL}); the example's losses vs this run's "
          f"{same:.3e}; card ms a step {[round(v, 3) for v in ms]} | {smi}")
    check(lerr <= TRAIN_LOSS_TOL and worst <= 1.0 and serr <= TRAIN_MOMENT_TOL
          and same <= TRAIN_LOSS_TOL, "6a: card and CPU training disagree")
    del card
    torch.cuda.empty_cache()
    return {"losses": losses, "wall_s": wall, "card_cpu_loss": lerr,
            "card_cpu_param_of_bound": worst, "card_cpu_moments": serr,
            "card_ms_per_step": ms}


def remat_phase(torch, port, smi):
    """6b: SmolLM-135M (f32) at PREFILL_B x PREFILL_LEN: the loss and
    gradients with remat and "dots" against no remat at the same weights,
    then each mode's train step: ms a step, tokens/s, peak memory, idle
    share and its heaviest device operations."""
    cfg = dataclasses.replace(port.get_config("smollm-135m"),
                              dtype="float32")
    model = port.build_model(cfg, remat=False, device="cuda",
                             policy="reference")
    gen = torch.Generator(device="cuda").manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (PREFILL_B, PREFILL_LEN), generator=gen,
                                     device="cuda")}
    tokens = PREFILL_B * PREFILL_LEN
    for p in model.parameters():
        p.requires_grad_(True)
    ref, out = None, {}
    for label, remat, policy in REMAT_MODES:
        model.remat, model.remat_policy = remat, policy
        for p in model.parameters():
            p.grad = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        logits, extras = model.forward(batch)
        loss = port.lm_loss(cfg, logits, batch["tokens"], extras)
        del logits, extras
        loss.backward()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - held) / 1e9
        grads = {n: p.grad.detach().clone()
                 for n, p in model.named_parameters()}
        if ref is None:
            ref = (loss.item(), grads)
            lerr = gerr = 0.0
        else:
            lerr = abs(loss.item() - ref[0]) / abs(ref[0])
            gerr = max(((g - ref[1][n]).abs().max()
                        / ref[1][n].abs().max()).item()
                       for n, g in grads.items())
        del grads
        out[label] = {"loss_rel_err": lerr, "grad_rel_err": gerr,
                      "fwd_bwd_peak_gb": peak}
    for p in model.parameters():
        p.grad = None
    init_state, train_step = port.make_train_step(model, "adamw")
    state, step = init_state()
    for label, remat, policy in REMAT_MODES:
        model.remat, model.remat_policy = remat, policy
        state, step, _ = train_step(state, step, batch)      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(REMAT_TIMED + 1)]
        ev[0].record()
        for i in range(REMAT_TIMED):
            state, step, m = train_step(state, step, batch)
            ev[i + 1].record()
        torch.cuda.synchronize()
        ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(REMAT_TIMED)]
        peak = torch.cuda.max_memory_allocated() / 1e9
        box = {"s": (state, step)}

        def one():
            box["s"] = train_step(*box["s"], batch)[:2]
        wall, busy = profiled(torch, one, f"6b SmolLM-135M f32 train step "
                              f"{PREFILL_B} x {PREFILL_LEN}, {label}", top=6)
        state, step = box["s"]
        o = out[label]
        o.update(ms_per_step=statistics.median(ms), ms=ms,
                 tokens_per_s=tokens / statistics.median(ms) * 1e3,
                 peak_gb=peak, peak_above_held_gb=peak - held / 1e9,
                 idle_share=1 - busy / wall, loss=m["loss"].item())
        print(f"6b {label}: {o['ms_per_step']:.2f} ms a step "
              f"({[round(v, 2) for v in ms]}), {o['tokens_per_s']:.0f} "
              f"tokens/s, peak {peak:.2f} GB (a train step; "
              f"{o['peak_above_held_gb']:.2f} GB above the {held / 1e9:.2f} "
              f"GB held), forward+backward {o['fwd_bwd_peak_gb']:.2f} GB "
              f"above what it held; idle share {o['idle_share']:.4f}; loss "
              f"{o['loss_rel_err']:.3e} and gradients {o['grad_rel_err']:.3e}"
              f" of no remat's (relative, tol {REMAT_TOL}) | {smi}")
        check(o["loss_rel_err"] <= REMAT_TOL and o["grad_rel_err"]
              <= REMAT_TOL, f"6b: {label} departs from no remat")
    check(out["remat"]["fwd_bwd_peak_gb"]
          < out["no remat"]["fwd_bwd_peak_gb"],
          "6b: remat did not lower the peak")
    del model, state
    torch.cuda.empty_cache()
    return out


def moe_train_phase(torch, port, smi):
    """6c: Granite-MoE-3B-A800M at full width and depth, bf16, remat,
    default_optimizer, MOE_TRAIN_STEPS steps on one memorisable batch: the
    loss falls; ms a step, tokens/s, peak memory, the aux term and the
    capacity drops of the batch's forward pass after the steps."""
    cfg = port.get_config("granite-moe-3b-a800m")
    torch.cuda.empty_cache()
    model, build_ms = timed(torch, lambda: port.build_model(
        cfg, remat=True, device="cuda"))
    n = sum(p.numel() for p in model.parameters())
    opt = port.default_optimizer(cfg)
    gen = torch.Generator(device="cuda").manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (MOE_TRAIN_B, MOE_TRAIN_S),
                                     generator=gen, device="cuda")}
    torch.cuda.reset_peak_memory_stats()
    losses, _, ms = train_run(torch, port, model,
                              [batch] * MOE_TRAIN_STEPS, optimizer=opt,
                              keep_first=False)
    peak = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad(), counting_drops(port) as counts:
        _, extras = model.forward(batch)
        aux = extras["aux"].item()
    dropped, pairs, load = drops(counts)
    tokens = MOE_TRAIN_B * MOE_TRAIN_S
    steady = statistics.median(ms[1:])
    print(f"6c {cfg.name} ({n / 1e9:.2f} B params, {cfg.dtype}, remat, "
          f"{opt}, built in {build_ms / 1e3:.2f} s) {MOE_TRAIN_B} x "
          f"{MOE_TRAIN_S}: losses "
          f"{[round(v, 4) for v in losses]}; ms a step "
          f"{[round(v, 1) for v in ms]} (steady {steady:.1f}, "
          f"{tokens / steady * 1e3:.0f} tokens/s); peak {peak:.2f} GB; aux "
          f"{aux:.4f}; capacity drops {dropped} of {pairs} (token, expert) "
          f"pairs, fullest expert {load:.2f} x its mean | {smi}")
    check(all(abs(v) < float("inf") for v in losses)
          and losses[-1] < losses[0], f"6c: the MoE loss did not fall "
          f"{losses}")
    del model
    torch.cuda.empty_cache()
    return {"params": n, "losses": losses, "ms": ms,
            "tokens_per_s": tokens / steady * 1e3, "peak_gb": peak,
            "aux": aux, "dropped": dropped, "pairs": pairs}


def train_reduced_phase(torch, port, smi):
    """6d: every reduced config (f32, plain scans, remat on), AdamW; reduced
    DeepSeek-V3 under Adafactor; SmolLM with bf16 gradients: card vs CPU."""
    out = {}
    runs = [(a, "adamw", None) for a in CARD_CPU_ARCHS] + [
        ("deepseek-v3-671b", "adafactor", None),
        ("smollm-135m", "adamw", "bfloat16")]
    for arch, optimizer, gdt in runs:
        cfg = port.get_config(arch).reduced()
        lerr, worst, serr, _, _ = train_card_vs_cpu(
            torch, port, cfg, train_batches(torch, cfg, TRAIN_CARD_CPU_STEPS),
            optimizer, gdt)
        ltol = BF16_TRAIN_TOL if gdt else TRAIN_LOSS_TOL
        stol = FACTOR_TOL if optimizer == "adafactor" else TRAIN_MOMENT_TOL
        label = f"{arch} {optimizer}{' grad bf16' if gdt else ''}"
        print(f"6d {label}: card vs CPU over {TRAIN_CARD_CPU_STEPS} steps: "
              f"loss {lerr:.3e} (tol {ltol}), params {worst:.3f} of their "
              f"bound, first-step state {serr:.3e} of its max"
              f"{'' if gdt else f' (tol {stol})'} | {smi}")
        check(lerr <= ltol and worst <= 1.0 and (gdt or serr <= stol),
              f"6d: {label}: card and CPU disagree")
        out[label] = {"loss": lerr, "param_of_bound": worst, "state": serr}
    return out


def a14_phase(torch, port, sp, clients, test, smi):
    """6e: the DNN10 SplitMe campaign (phase 3b's data, 3 rounds, seed 0,
    graphed) under gelu and squared ReLU, card vs CPU; the KL and Gram
    kernels launch."""
    import numpy as np
    out = {}
    for act, lrs in A14_RUNS:
        cfg = dataclasses.replace(port.DNN10, activation=act)
        kl0, rg0 = port.kl_ops.launches, port.rg_ops.launches
        kw = dict(rounds=3, seeds=(0,), test_data=test,
                  eval_gamma=CMP_EVAL_GAMMA, **lrs)
        card = port.campaign.run_campaign("splitme", cfg, sp, clients,
                                          device="cuda", **kw)
        kl_n, rg_n = port.kl_ops.launches - kl0, port.rg_ops.launches - rg0
        cpu = port.campaign.run_campaign("splitme", cfg, sp, clients,
                                         device="cpu", **kw)
        if act == "gelu":
            perr, lerr = campaign_max_diff(card, cpu)
            ok = perr <= CARD_CPU_TOL and lerr <= CARD_CPU_TOL
            what = f"params {perr:.3e}, losses {lerr:.3e}"
        else:
            a, b = card.losses, cpu.losses
            fin = np.isfinite(b)
            lerr = float((np.abs(a[fin] - b[fin])
                          / np.maximum(np.abs(b[fin]), 1.0)).max(initial=0.0))
            ok = np.array_equal(fin, np.isfinite(a)) and lerr <= CARD_CPU_TOL
            perr = None
            what = (f"losses {lerr:.3e} relative where finite, NaN where the "
                    f"CPU's are ({int((~fin).sum())} of {fin.size})")
        print(f"6e DNN10 {act} campaign (3 rounds, graphed, "
              f"{card.graphs['graphs']} graphs): card vs CPU {what} (tol "
              f"{CARD_CPU_TOL}); launches kl_mutual {kl_n}, ridge_gram "
              f"{rg_n}; accuracy {card.accuracy} vs {cpu.accuracy} | {smi}")
        check(ok and kl_n > 0 and rg_n > 0,
              f"6e: the {act} campaign fails its gates")
        out[act] = {"param_diff": perr, "loss_diff": lerr,
                    "kl_mutual": kl_n, "ridge_gram": rg_n}
    return out


# -- phase 7: the zoo's tooling --------------------------------------------
# (a) fl_dryrun at the reference's settings on both fake worlds, the round's
# tensors on the card; (b) the roofline terms (a one-rank mesh, meta
# tensors) of what phases 6b and 4 time; (c) one dry-run combination through
# its CLI.  Each part is a process of its own (a process group is
# process-global): `python3 chip_smoke.py --tooling <part> <out.json>`.
# (b) and (c) run on the host only and start with the script, at the lowest
# CPU priority; (a) runs after phase 6.
FL_WORLDS = ("16x16", "2x16x16")
FL_CLIENTS, FL_SAMPLES = 512, 64
# (label, arch, step kind, dtype, model overrides, (phase, what it timed))
ROOFLINE_CELLS = (
    ("smollm-135m f32 train, no remat", "smollm-135m", "train", "float32",
     {"remat": False}, ("6b", "no remat")),
    ("smollm-135m f32 train, remat", "smollm-135m", "train", "float32",
     {"remat": True}, ("6b", "remat")),
    ("smollm-135m f32 train, remat dots", "smollm-135m", "train", "float32",
     {"remat": True, "remat_policy": "dots"}, ("6b", "remat dots")),
    ("qwen3-14b bf16 prefill", "qwen3-14b", "prefill", None, {},
     ("4", "qwen3-14b")),
    ("zamba2-2.7b bf16 prefill", "zamba2-2.7b", "prefill", None, {},
     ("4", "zamba2-2.7b")),
)
# the combination phase 7c runs through the CLI, and what the sweep on a
# host gave for it (40 heads and 8 KV heads over 16 ranks, resharded): the
# step is the same program on any host
DRYRUN_COMBO = ("qwen3-14b", "decode_32k")
DRYRUN_WANT = {"ok": True, "fits": True, "dominant": "memory",
               "method": "direct: one step, every op counted"}
TOOLING_TIMEOUT = 600
TOOLING_DIR = ROOT / "build" / "chip_smoke_tooling"
_BACKGROUND = []


def tooling_worker(part: str, out: str) -> int:
    """One part of phase 7, in this process: ``fl-16x16`` /
    ``fl-2x16x16`` (the card) or ``roofline`` (meta tensors)."""
    if part.startswith("fl-"):
        # only what the round needs: the parts start beside phase 6d
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.kernels import build
        from repro_torch.kernels.kl_mutual import ops as kl_ops
        from repro_torch.kernels.ridge_gram import ops as rg_ops
        from repro_torch.launch import fl_dryrun
        build.library()
        kl_ops.launches = kl_ops.launches_bwd = rg_ops.launches = 0
        t0 = time.perf_counter()
        res = fl_dryrun.run(part == "fl-2x16x16", FL_CLIENTS, FL_SAMPLES,
                            "cuda")
        res["seconds"] = time.perf_counter() - t0
        res["launches"] = {"kl_mutual": kl_ops.launches,
                           "kl_mutual (backward)": kl_ops.launches_bwd,
                           "ridge_gram": rg_ops.launches}
        Path(out).write_text(json.dumps(res, indent=1))
        return 0
    port = import_port()
    if part == "roofline":
        from repro_torch.configs.base import InputShape
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.launch.roofline_run import _measure, extrapolate
        from repro_torch.roofline.analysis import (model_flops_estimate,
                                                   peak_flops_for)
        mesh = make_host_mesh()
        res = {}
        for label, arch, kind, dt, over, _ in ROOFLINE_CELLS:
            cfg = port.get_config(arch)
            if dt is not None:
                cfg = dataclasses.replace(cfg, dtype=dt)
            shape = InputShape(f"{kind}_{PREFILL_B}x{PREFILL_LEN}",
                               PREFILL_LEN, PREFILL_B, kind)
            t0 = time.perf_counter()
            # Zamba2 from its 1- and 2-group variants: its scans step
            # through 2048 tokens an op at a time
            hybrid = cfg.family == "hybrid"
            m = (extrapolate(cfg, shape, mesh, over) if hybrid
                 else _measure(cfg, shape, mesh, over))
            peak = peak_flops_for(cfg.dtype)
            res[label] = {
                "flops": m["flops"], "bytes": m["bytes"],
                "compute_ms": m["flops"] / peak * 1e3,
                "memory_ms": m["bytes"] / PEAK_BYTES * 1e3,
                "peak_flops": peak,
                "model_flops": model_flops_estimate(cfg, shape),
                "method": ("1/2-group extrapolation" if hybrid
                           else "full depth") + (
                    "" if m.get("scan_method", m.get("method", "")
                                ).startswith("direct")
                    else ", the scan loops from 3, 4 and 5 steps"),
                "seconds": time.perf_counter() - t0}
    else:
        raise SystemExit(f"unknown tooling part {part!r}")
    Path(out).write_text(json.dumps(res, indent=1))
    return 0


def start_tooling(args, out: Path, low_priority: bool):
    """Start a phase-7 process (this script with ``--tooling``, or a
    module of the port) writing its log beside ``out``."""
    import os
    TOOLING_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if low_priority:        # one core at most beside the timed phases
        env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    log = open(out.with_suffix(".log"), "w")
    proc = subprocess.Popen(
        [sys.executable] + args, cwd=ROOT, env=env, stdout=log,
        stderr=subprocess.STDOUT,
        preexec_fn=(lambda: os.nice(19)) if low_priority else None)
    _BACKGROUND.append(proc)
    return proc, log


def stop_tooling() -> None:
    """End every phase-7 process still running (at exit, failed or not)."""
    for proc in _BACKGROUND:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def wait_tooling(proc, log, label: str, ok_rcs=(0,)) -> str:
    """Wait for a phase-7 process; fail with its log's tail unless it
    exits with one of ``ok_rcs``."""
    try:
        rc = proc.wait(timeout=TOOLING_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    log.close()
    text = Path(log.name).read_text()
    check(rc in ok_rcs, f"7: {label} exited {rc}:\n{text[-4000:]}")
    return text


def start_host_tooling():
    """Phase 7b and 7c, which need no card, started beside phase 2."""
    roof = TOOLING_DIR / "roofline.json"
    combo = TOOLING_DIR / "dryrun"
    arch, shape = DRYRUN_COMBO
    return {
        "roofline": (roof,) + start_tooling(
            [str(ROOT / "chip_smoke.py"), "--tooling", "roofline",
             str(roof)], roof, True),
        "dryrun": (combo / f"{arch}__{shape}__16x16.json",) + start_tooling(
            ["-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
             shape, "--force", "--out", str(combo)],
            TOOLING_DIR / "dryrun.json", True)}


def start_fl_tooling():
    """Phase 7a's two worlds, each a process of its own on the card,
    started together after 6c: they overlap 6d and 6e, which time
    nothing."""
    out = {}
    for world in FL_WORLDS:
        path = TOOLING_DIR / f"fl_{world}.json"
        out[world] = (path,) + start_tooling(
            [str(ROOT / "chip_smoke.py"), "--tooling", f"fl-{world}",
             str(path)], path, False)
    return out


def tooling_phase(host, fl, measured: dict, smi: str, t_wall0: float
                  ) -> dict:
    """Phase 7: (a) the two fl_dryrun worlds on the card, checked against
    the paper's claim; then (b) and (c), started with the script."""
    out = {"finished_at_s": {}}
    for world in FL_WORLDS:
        path, proc, log = fl[world]
        wait_tooling(proc, log, f"fl_dryrun {world}")
        out["finished_at_s"][f"7a {world}"] = path.stat().st_mtime - t_wall0
        r = json.loads(path.read_text())
        one = {"all-reduce": 1}
        for E in (1, 10):
            check(r[f"splitme_E{E}"]["counts"] == one,
                  f"7a {world}: SplitMe E={E} collectives "
                  f"{r[f'splitme_E{E}']['counts']}, want one all-reduce")
            check(r[f"sfl_E{E}"]["counts"] == {"collective-permute": 2 * E,
                                               "all-reduce": 1},
                  f"7a {world}: SFL E={E} collectives "
                  f"{r[f'sfl_E{E}']['counts']}, want {2 * E} permutes "
                  f"beside one bundled all-reduce")
        check(r["inversion"]["counts"] == {"all-reduce": 8},
              f"7a {world}: Step 4 {r['inversion']['counts']}")
        check(r["splitme_bytes_constant_in_E"]
              and r["sfl_bytes_scale_with_E"],
              f"7a {world}: bytes in E: SplitMe "
              f"{r['splitme_E1']['collective_bytes']} -> "
              f"{r['splitme_E10']['collective_bytes']}, SFL "
              f"{r['sfl_E1']['collective_bytes']} -> "
              f"{r['sfl_E10']['collective_bytes']}")
        check(r["quant_bf16_halves_comm_bits"]
              and r["quant_int8_quarters_comm_bits"],
              f"7a {world}: wire bits f32 {r['splitme_E1']['comm_bits']}, "
              f"bf16 {r['splitme_E1_bf16']['comm_bits']}, int8 "
              f"{r['splitme_E1_int8']['comm_bits']}")
        n = r["launches"]
        check(n["kl_mutual"] > 0 and n["ridge_gram"] > 0,
              f"7a {world}: kernels did not launch under the dry-run: {n}")
        print(f"7a fl_dryrun {world} (rank 0 of {256 if world == '16x16' else 512},"
              f" {FL_CLIENTS} clients, {FL_SAMPLES} samples, tensors on the "
              f"card) | {smi}: " + "; ".join(
                  f"{k} {r[k]['counts']} {r[k]['collective_bytes']:.0f} B "
                  f"{r[k]['comm_bits']:.0f} bits wire {r[k]['collective_s'] * 1e6:.3f} us"
                  for k in ("splitme_E1", "splitme_E10", "sfl_E1", "sfl_E10",
                            "splitme_E1_bf16", "splitme_E1_int8",
                            "inversion"))
              + f"; launches {n}; {r['seconds']:.1f} s")
        out[world] = r
    # the ring model of the sharded campaign's all-reduce on 4 cards of a
    # node: the 4 seeds' SplitMe bundles (7a's payload each) over NVLink
    from repro_torch.roofline.analysis import CollectiveOp
    one = out[FL_WORLDS[0]]["splitme_E1"]
    ring = CollectiveOp("all-reduce", 4 * int(one["collective_bytes"]), 4,
                        4 * int(one["comm_bits"] // 32), (0, 1, 2, 3))
    out["ring_4_cards_us"] = ring.wire_seconds * 1e6
    print(f"7a ring model: one all-reduce of 4 seeds' SplitMe bundles "
          f"({ring.result_bytes} B) over 4 NVLink ranks "
          f"{out['ring_4_cards_us']:.3f} us")
    path, proc, log = host["roofline"]
    wait_tooling(proc, log, "roofline terms")
    out["finished_at_s"]["7b"] = path.stat().st_mtime - t_wall0
    roof = json.loads(path.read_text())
    out["roofline"] = {}
    for label, _, _, _, _, (ph, key) in ROOFLINE_CELLS:
        r = roof[label]
        ms = measured[(ph, key)]
        bound = max(r["compute_ms"], r["memory_ms"])
        r.update(measured_ms=ms, share=bound / ms)
        check(r["flops"] > 0 and r["bytes"] > 0 and ms > 0,
              f"7b {label}: {r}")
        print(f"7b roofline {label} ({r['method']}, counted on meta) | {smi}"
              f": compute {r['compute_ms']:.3f} ms at "
              f"{r['peak_flops'] / 1e12:.0f} TFLOP/s, memory "
              f"{r['memory_ms']:.3f} ms, model_flops "
              f"{r['model_flops']:.4e} (counted {r['flops']:.4e}), "
              f"measured {ms:.3f} ms (phase {ph}), share max(terms) / "
              f"measured {r['share']:.4f}")
        out["roofline"][label] = r
    path, proc, log = host["dryrun"]
    wait_tooling(proc, log, "dry-run CLI", ok_rcs=(0, 1))
    out["finished_at_s"]["7c"] = path.stat().st_mtime - t_wall0
    r = json.loads(path.read_text())
    got = {k: r.get(k) for k in DRYRUN_WANT}
    check(got == DRYRUN_WANT, f"7c dry-run {DRYRUN_COMBO}: {got}, the host "
          f"sweep gave {DRYRUN_WANT}: {r.get('error', '')[:400]}")
    gb = (r["per_device_bytes"]["argument"]
          + r["per_device_bytes"]["temp"]) / 1e9
    print(f"7c dry-run {DRYRUN_COMBO[0]} x {DRYRUN_COMBO[1]} x 16x16 through "
          f"its CLI, counted on the host beside the card ({smi}): ok "
          f"{r['ok']}, dominant {r['dominant']} (compute "
          f"{r['compute_s']:.3e} s, memory {r['memory_s']:.3e} s, "
          f"collective {r['collective_s']:.3e} s), per-rank "
          f"{gb:.2f} GB of {r['hbm_bytes'] / 1e9:.0f}, fits {r['fits']}, "
          f"step {r['step_s']} s")
    out["dryrun"] = {k: r.get(k) for k in (
        "ok", "dominant", "fits", "method", "compute_s", "memory_s",
        "collective_s", "collective_counts", "step_s")}
    out["dryrun"]["per_rank_gb"] = gb
    print("7 parts finished at (s of the script): " + json.dumps(
        {k: round(v, 1) for k, v in out["finished_at_s"].items()}))
    return out


def import_port():
    """The port's modules, from ``src/`` beside this script; binds the
    card's peaks (``launch.mesh``) to this module's names."""
    sys.path.insert(0, str(ROOT / "src"))
    import types
    from repro_torch.launch import mesh as _mesh
    for name in ("PEAK_BYTES", "PEAK_FP32", "PEAK_BF16", "PEAK_TF32",
                 "PEAK_F32_MMA"):
        globals()[name] = getattr(_mesh, name)
    del _mesh, name
    from repro_torch import serve
    from repro_torch.configs.base import get_config
    from repro_torch.configs.splitme_dnn import DNN10
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.core import (baselines, dnn, engine, population,
                                  quantcomm, scenario)
    from repro_torch.core.engine import RoundGuards
    from repro_torch.core.inversion import invert_inverse_model
    from repro_torch.core.cost import SystemParams
    from repro_torch.core.splitme import SplitMeTrainer
    from repro_torch.data import oran
    from repro_torch.device import resolve_device
    from repro_torch.examples import oran_splitfl_campaign as example_cli
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (
        attention as flash_ref)
    from repro_torch.kernels.kl_mutual import ops as kl_ops
    from repro_torch.kernels.kl_mutual.ref import kl_grad_ref, kl_rows_ref
    from repro_torch.kernels.ridge_gram import ops as rg_ops
    from repro_torch.kernels.ridge_gram.ref import gram_ref
    from repro_torch.kernels.mamba2_scan import ops as ssd_ops
    from repro_torch.kernels.mamba2_scan.ref import mamba2_scan_ref
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.kernels.rwkv6_wkv.ref import rwkv6_wkv_ref
    from repro_torch.launch import campaign, mesh as meshes, resilience
    from repro_torch.models import moe
    from repro_torch.models.transformer import build_model
    from repro_torch.convert import opt_state_to_numpy
    from repro_torch.examples import lm_pretrain
    from repro_torch.runtime.steps import (default_optimizer, lm_loss,
                                           make_prefill_step, make_serve_step,
                                           make_train_step)
    return types.SimpleNamespace(**locals())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    port = import_port()
    rg_ops = port.rg_ops
    t_start = time.perf_counter()
    t_wall0 = time.time()
    import atexit
    atexit.register(stop_tooling)
    host_tooling = start_host_tooling()

    def phase(name):
        print(f"[{time.perf_counter() - t_start:.1f} s] {name}")

    # -- 1. device + build ---------------------------------------------------
    dev = port.resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    port.build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{port.build.last_build_seconds:.2f} s) -> {port.build.build()}")
    for src, log in sorted(port.build.last_build_log.items()):
        for name, (n, regs, spill) in ptxas_summary(log).items():
            print(f"  ptxas {src}: {name}: {n} instances, registers "
                  f"{min(regs)}-{max(regs)}, spill stores up to {spill} "
                  f"bytes")

    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    # -- 2. kernels vs plain versions ----------------------------------------
    phase("2. kernels vs plain versions")
    kl = kl_phase(torch, port, normal)
    kl_mixed = kl_mixed_phase(torch, port, normal)

    n = 4800
    shapes = main_path_gram_shapes(port.DNN10, n)
    pairs = main_path_gram_pairs(port.DNN10, n)
    check(len(shapes) == 16 and shapes[0] == (n, 257, 257)
          and shapes[-1] == (n, 17, 3) and len(pairs) == 8,
          f"main-path Gram shapes {shapes}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gram_err, gram_rel = 0.0, 0.0

    def gram_check(label, got, want, x, y):
        """got within GRAM_TOL of want, relative to max(|X|ᵀ|Y|); the
        absolute and relative errors."""
        scale = (x.abs().T @ y.abs()).max().item()
        err = (got - want).abs().max().item()
        check(bool(torch.isfinite(got).all()) and got.shape == want.shape
              and err <= GRAM_TOL * scale,
              f"ridge_gram disagrees at {label}: {err} > {GRAM_TOL} x "
              f"{scale}")
        return err, err / scale

    # the 16 single Grams (gram, the JAX op's twin) and a ragged one
    for nn, d1, d2 in shapes + [(777, 45, 19)]:
        x, y = normal(nn, d1), normal(nn, d2)
        got = rg_ops.gram(x, y)
        err, rel = gram_check((nn, d1, d2), got, port.gram_ref(x, y), x, y)
        check(torch.equal(got, rg_ops.gram(x, y)),
              f"ridge_gram not deterministic at {(nn, d1, d2)}")
        gram_err, gram_rel = max(gram_err, err), max(gram_rel, rel)
        print(f"ridge_gram gram {(nn, d1, d2)}: err {err:.3e} (relative "
              f"{rel:.3e}, tol {GRAM_TOL})")
    # the 8 layer pairs as the main path takes them: OᵀO and OᵀZ from one
    # gram_pair launch, timed beside the plain version and two matmuls
    g_ms = g_plain = g_lib = g_bound = g_bound_fp32 = 0.0
    g_ops_t = g_bytes_t = g_host = 0.0
    g_calls, lib_calls = [], []
    for nn, d1, d2 in pairs:
        o, z = normal(nn, d1), normal(nn, d2)
        got = rg_ops.gram_pair(o, z)
        again = rg_ops.gram_pair(o, z)
        err = 0.0
        for g, a, y in zip(got, again, (o, z)):
            e, rel = gram_check(f"pair {(nn, d1, d2)}", g,
                                port.gram_ref(o, y), o, y)
            check(torch.equal(g, a),
                  f"ridge_gram pair not deterministic at {(nn, d1, d2)}")
            err = max(err, e)
            gram_err, gram_rel = max(gram_err, e), max(gram_rel, rel)
        ms = time_ms(torch, lambda: rg_ops.gram_pair(o, z))
        plain = time_ms(torch, lambda: (port.gram_ref(o, o),
                                        port.gram_ref(o, z)))
        lib = time_ms(torch, lambda: (torch.matmul(o.T, o),
                                      torch.matmul(o.T, z)))
        host = host_us(torch, lambda: rg_ops.gram_pair(o, z))
        g_calls.append(lambda o=o, z=z: rg_ops.gram_pair(o, z))
        lib_calls.append(lambda o=o, z=z: (torch.matmul(o.T, o),
                                           torch.matmul(o.T, z)))
        # f32 products at the 3xTF32 rate: OᵀO is symmetric, so it needs
        # its d1·(d1 + 1)/2 distinct entries, 2·n operations each, and OᵀZ
        # 2·n·d1·d2; O read once, Z once, both results written once
        flops = nn * d1 * (d1 + 1) + 2 * nn * d1 * d2
        ops_t = flops / PEAK_F32_MMA * 1e3
        bytes_t = (nn * (d1 + d2) + d1 * (d1 + d2)) * 4 / PEAK_BYTES * 1e3
        splits, _ = rg_ops.split_plan(nn, d1, d1 + d2, sms, True)
        print(f"ridge_gram pair {(nn, d1, d2)}: err {err:.3e}, splits "
              f"{splits}, {ms * 1e3:.2f} us (events), host {host:.2f} "
              f"us/call, plain {plain * 1e3:.2f} us, 2 matmuls "
              f"{lib * 1e3:.2f} us, bound {max(ops_t, bytes_t) * 1e3:.3f} "
              f"us (at the FP32 rate {flops / PEAK_FP32 * 1e6:.3f} us)")
        g_ms, g_plain, g_lib = g_ms + ms, g_plain + plain, g_lib + lib
        g_bound += max(ops_t, bytes_t)
        g_bound_fp32 += max(flops / PEAK_FP32 * 1e3, bytes_t)
        g_ops_t, g_bytes_t = g_ops_t + ops_t, g_bytes_t + bytes_t
        g_host += host
    g_devs = device_ms(torch, g_calls, ("gram_tf32_kernel",))
    g_dev = None if None in g_devs else sum(g_devs)
    lib_devs = device_ms(torch, lib_calls, None)
    g_lib_dev = None if None in lib_devs else sum(lib_devs)
    print(f"ridge_gram device time per pair (us, profiler): "
          f"{[v and round(v * 1e3, 2) for v in g_devs]}; 2 matmuls: "
          f"{[v and round(v * 1e3, 2) for v in lib_devs]}")
    print(f"ridge_gram, the 16 main-path Grams of one evaluation in 8 pair "
          f"launches: {g_ms * 1e3:.2f} us (events), device "
          f"{g_dev and round(g_dev * 1e3, 2)} us, host "
          f"{g_host / len(pairs):.2f} us/call, plain {g_plain * 1e3:.2f} "
          f"us, 16 matmuls {g_lib * 1e3:.2f} us (events), device "
          f"{g_lib_dev and round(g_lib_dev * 1e3, 2)} us, bound "
          f"{g_bound * 1e3:.2f} us (operations {g_ops_t * 1e3:.2f} us, "
          f"bytes {g_bytes_t * 1e3:.2f} us; at the FP32 rate "
          f"{g_bound_fp32 * 1e3:.2f} us)")
    torch.cuda.synchronize()

    wkv = check_scan_kernel(
        torch, "rwkv6_wkv", port.wkv_ops.rwkv6_wkv, port.rwkv6_wkv_ref,
        WKV_CASES, lambda shape, c: wkv_inputs(torch, normal, shape, c),
        wkv_bound, ("wkv_kernel",))
    ssd = check_scan_kernel(
        torch, "mamba2_scan", port.ssd_ops.mamba2_scan, port.mamba2_scan_ref,
        SSD_CASES, lambda shape, c: ssd_inputs(torch, normal, shape, c),
        ssd_bound, ("ssd_kernel",))
    ssd["bound_sequential_ms"] = ssd_bound_sequential(*SSD_CASES[0][0])
    print(f"mamba2_scan {SSD_CASES[0][0]}: bound of the sequential form "
          f"{ssd['bound_sequential_ms'] * 1e3:.2f} us (bytes or its FP32 "
          f"operations)")
    # the SSD kernel with one, two and three of its blocks on every SM (b
    # rows of as many heads as the card has SMs): Zamba2's 320 blocks put
    # three on some SMs and two on the others
    ssd["ms_at_blocks_per_sm"] = {}
    for bb in (1, 2, 3):
        args = ssd_inputs(torch, normal, (bb, 2048, sms, 64, 64), None)
        ssd["ms_at_blocks_per_sm"][bb] = time_ms(
            torch, lambda: port.ssd_ops.mamba2_scan(*args), reps=10, inner=3)
        del args
    print(f"mamba2_scan at (b, 2048, {sms}, 64, 64), b blocks an SM: "
          + ", ".join(f"b {bb}: {ms * 1e3:.2f} us" for bb, ms
                      in ssd["ms_at_blocks_per_sm"].items()))
    torch.cuda.synchronize()

    # -- 2b. flash_attention vs plain ----------------------------------------
    phase("2b. flash_attention vs plain")
    flash = flash_phase(torch, port, normal)

    # -- 3. SplitMe path -----------------------------------------------------
    phase("3. SplitMe path")
    X, yl = port.oran.generate(n_per_class=2000, seed=0)
    (Xtr, ytr), test = port.oran.train_test_split(X, yl)
    sp = port.SystemParams()
    clients = port.oran.partition_non_iid(Xtr, ytr, sp.M,
                                          samples_per_client=96, seed=0)
    (trainer, hist, round_ms, w_server, final_acc,
     (kl_n, kl_bwd_n, rg_n)) = main_path(torch, port, sp, clients, test,
                                         "cuda")
    e_max = trainer.sp.E_max
    for m, ms in zip(hist, round_ms):
        print(f"round {m.round}: selected {m.n_selected} E {m.E} client KL "
              f"{m.client_loss:.6f} server KL {m.server_loss:.6f} accuracy "
              f"{m.accuracy:.4f} | {ms:.1f} ms")
    step4_finite = all(bool(torch.isfinite(p[k]).all())
                       for p in w_server for k in p)
    print(f"main path: {statistics.median(round_ms[1:]):.1f} ms per round "
          f"(median of rounds 1-{ROUNDS - 1}; round 0 {round_ms[0]:.1f} ms), "
          f"final accuracy {final_acc:.4f}, Step-4 weights finite: "
          f"{step4_finite}; launches kl_mutual {kl_n} (backward "
          f"{kl_bwd_n}) ridge_gram {rg_n}")
    check(kl_n == ROUNDS * 2 * e_max,
          f"kl_mutual launches {kl_n} != {ROUNDS * 2 * e_max}")
    # one backward launch per executed training step: E_t steps of each of
    # the two phases in round t (the steps after E_t run no backward)
    steps = sum(2 * m.E for m in hist)
    check(kl_bwd_n == steps,
          f"kl_mutual backward launches {kl_bwd_n} != {steps} training steps")
    # one gram_pair launch (OᵀO and OᵀZ) per server layer: 8 at the last
    # round's evaluation and 8 in finalize
    check(rg_n == 2 * 8, f"ridge_gram launches {rg_n} != 16 "
          f"(8 at the last round's evaluation, 8 in finalize)")
    losses = [m.client_loss for m in hist] + [m.server_loss for m in hist]
    check(all(abs(v) < float("inf") for v in losses), "non-finite loss")
    # the client loss falls while the cohort and E stay the same (the cohort
    # grows and E adapts between some rounds, which moves the mean)
    for a, b in zip(hist, hist[1:]):
        if (a.n_selected, a.E) == (b.n_selected, b.E):
            check(b.client_loss < a.client_loss,
                  f"client loss rose in round {b.round} at fixed cohort/E")
    for acc in (hist[-1].accuracy, final_acc):
        check(0.0 <= acc <= 1.0, f"accuracy {acc} out of range")
    # Step 4 on the card against its plain version.  At the trainer's
    # γ = 1e-3 the f32 ridge of DNN10 is numerically singular (a Gram change
    # in the last bit moves the weights far, or gives an exact zero pivot
    # and NaN weights), so whether those weights are finite is printed, not
    # checked; the comparison, and the finiteness check, run at STEP4_GAMMA
    # on the same trainer state
    for gamma in (1.0, 10.0, STEP4_GAMMA):
        rel, cond, acc_k, acc_p = step4_vs_plain(torch, port, trainer,
                                                 gamma)
        print(f"Step 4 at gamma {gamma}: kernel vs plain Grams, weight diff "
              f"per layer (relative) {[float(f'{v:.3e}') for v in rel]}, "
              f"cond(A0 + gamma I) of layer 1 {cond:.3e}, accuracy "
              f"{acc_k:.4f} vs {acc_p:.4f}")
        if gamma == STEP4_GAMMA:
            check(all(v <= STEP4_TOL for v in rel)
                  and abs(acc_k - acc_p) <= 1e-3,
                  f"Step 4 with the Gram kernel disagrees with the plain "
                  f"Grams at gamma {gamma} (tol {STEP4_TOL})")
    m, wall_ms, busy_ms, n_ops, heavy = round_profile(torch, trainer)
    print(f"profiled round {m.round} (selected {m.n_selected}, E {m.E}): "
          f"wall {wall_ms:.1f} ms, device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.4f}, {n_ops} device operations")
    for name, ms, calls in heavy:
        print(f"  {ms:8.3f} ms  {calls:5d} calls  {name}")

    del trainer
    torch.cuda.empty_cache()

    # -- 3b. SplitMe campaign ------------------------------------------------
    phase("3b. SplitMe campaign")
    graphed, f32_ops, base = campaign_phase(torch, port, sp, clients, test)
    torch.cuda.empty_cache()

    # -- 3c. precision and wire formats --------------------------------------
    phase("3c. precision and wire formats")
    prec = precision_phase(torch, port, sp, clients, test, f32_ops)

    # -- 3d. the framework comparison ----------------------------------------
    phase("3d. the paper's framework comparison")
    compared = baselines_phase(torch, port, clients, test)

    # -- 3e. a time-varying RAN ----------------------------------------------
    phase("3e. a time-varying RAN")
    scenarios = scenario_phase(torch, port, clients, test)

    # -- 3f. fault channels and guards ---------------------------------------
    phase("3f. fault channels and guards")
    faults, fault_ref, fault_kw = fault_phase(torch, port, sp, clients,
                                               test, base)

    # -- 3g. checkpoints -----------------------------------------------------
    phase("3g. checkpoints")
    faults["checkpoints"] = checkpoint_phase(torch, port, sp, clients,
                                             fault_ref, fault_kw)

    # -- 3h. population mode -------------------------------------------------
    phase("3h. population mode")
    population, pop_launches = population_phase(torch, port, (Xtr, ytr),
                                                test, base)

    # -- 3i. the config sweep ------------------------------------------------
    phase("3i. the config sweep")
    sweep, sweep_launches = sweep_phase(torch, port, clients, test, base)

    # -- 3k. the sharded campaign --------------------------------------------
    phase("3k. the sharded campaign")
    sharded, sharded_launches = sharded_phase(torch, port, sp, clients, test,
                                              base)

    # -- 3j. the port's entry points -----------------------------------------
    phase("3j. the README's command lines through the port's example")
    readme = readme_phase(port)

    # -- 3l. the paper's result at its full horizon ---------------------------
    phase("3l. six frameworks over 32 seeds against the reference; C 6")
    horizon, horizon_launches = horizon_phase(torch, port, sp, clients,
                                              test, prec, smi)
    torch.cuda.empty_cache()

    # -- 4. serving path -----------------------------------------------------
    phase("4. serving path")
    for arch in ZOO_ARCHS:
        zoo_consistency(torch, port, arch, dev)
    served = {arch: zoo_serve(torch, port, arch, dev, smi)
              for arch in ZOO_ARCHS}
    wkv["launches"] = served["rwkv6-1.6b"][0]
    ssd["launches"] = served["zamba2-2.7b"][0]
    # the decoder and enc-dec families: served in bf16, then the f32 gate
    decoders = {}
    for arch, cuts, b in DECODER_ARCHS:
        decoders[arch] = decoder_serve(torch, port, arch, cuts, b, dev, smi)
        if arch in DECODER_GATES:
            decoders[arch]["f32_replay_err"] = decoder_consistency(
                torch, port, arch, dev)

    # -- 5. card vs CPU ------------------------------------------------------
    phase("5. card vs CPU")
    perr, lerr = card_vs_cpu(torch, port, sp, clients, test, ("cuda", "cpu"))
    print(f"card vs CPU, {CMP_ROUNDS} rounds: max param diff {perr:.3e}, max "
          f"loss diff {lerr:.3e} (tol {CARD_CPU_TOL})")
    check(perr <= CARD_CPU_TOL and lerr <= CARD_CPU_TOL,
          "card and CPU runs disagree")
    for arch in CARD_CPU_ARCHS:
        zero_launches(port)
        zoo_card_vs_cpu(torch, port, arch)
        if arch not in ZOO_ARCHS:
            check(not any(scan_and_flash_launches(port).values()),
                  f"{arch}: a kernel launched on a path that has none")

    # -- 6. zoo training -----------------------------------------------------
    phase("6. zoo training")
    zero_launches(port)
    training = {"6a": pretrain_phase(torch, port, smi),
                "6b": remat_phase(torch, port, smi),
                "6c": moe_train_phase(torch, port, smi)}
    fl_tooling = start_fl_tooling()       # phase 7a, beside 6d and 6e
    training["6d"] = train_reduced_phase(torch, port, smi)
    scans = scan_and_flash_launches(port)
    print(f"6f flash / WKV / SSD launches through 6a-6d: {scans} | {smi}")
    check(not any(scans.values()), "6f: training launched a kernel that "
          "its path does not run")
    training["6e"] = a14_phase(torch, port, sp, clients, test, smi)

    # -- 7. the zoo's tooling ------------------------------------------------
    phase("7. the zoo's tooling: fl_dryrun, roofline terms, the dry-run")
    measured = {("6b", k): v["ms_per_step"]
                for k, v in training["6b"].items()}
    measured[("4", "qwen3-14b")] = decoders["qwen3-14b"]["prefill_ms"]
    measured[("4", "zamba2-2.7b")] = served["zamba2-2.7b"][1]
    tooling = tooling_phase(host_tooling, fl_tooling, measured, smi,
                            t_wall0)

    # -- 8. result -----------------------------------------------------------
    phase("8. result")
    kernels = [
        {"name": "kl_mutual", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/kl_mutual.cu",
         "replaces": "src/repro/kernels/kl_mutual/kl_mutual.py:38",
         "launches": kl_n, **kl["fwd"], **graphed["kl_mutual"],
         **pop_launches["kl_mutual"], **sweep_launches["kl_mutual"],
         **sharded_launches["kl_mutual"],
         "horizon_launches": horizon_launches["kl_mutual"]},
        # the closed-form backward beside the Pallas kernel (plain jnp in
        # the JAX package), one kernel here
        {"name": "kl_mutual (backward)", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/kl_mutual.cu",
         "replaces": "src/repro/kernels/kl_mutual/ops.py:33",
         "launches": kl_bwd_n, **kl["bwd"],
         **graphed["kl_mutual (backward)"],
         **pop_launches["kl_mutual (backward)"],
         **sweep_launches["kl_mutual (backward)"],
         **sharded_launches["kl_mutual (backward)"],
         "horizon_launches": horizon_launches["kl_mutual (backward)"]},
        {"name": "ridge_gram", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ridge_gram.cu",
         "replaces": "src/repro/kernels/ridge_gram/ridge_gram.py:40",
         "launches": rg_n, "max_abs_err": gram_err, "ms": g_ms,
         "plain_ms": g_plain, "bound_ms": g_bound,
         "bound_by": "operations" if g_ops_t >= g_bytes_t else "bytes",
         "library_ms": g_lib, "device_ms": g_dev,
         "library_device_ms": g_lib_dev, "host_us_per_call": g_host / 8,
         "bound_fp32_ms": g_bound_fp32, "max_rel_err": gram_rel,
         "shape": "16 Grams of one evaluation, 8 gram_pair calls",
         **graphed["ridge_gram"], **pop_launches["ridge_gram"],
         **sweep_launches["ridge_gram"], **sharded_launches["ridge_gram"],
         "horizon_launches": horizon_launches["ridge_gram"]},
        {"name": "rwkv6_wkv", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rwkv6_wkv.cu",
         "replaces": "src/repro/kernels/rwkv6_wkv/rwkv6_wkv.py:61", **wkv},
        {"name": "mamba2_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mamba2_scan.cu",
         "replaces": "src/repro/kernels/mamba2_scan/mamba2_scan.py:70",
         **ssd},
        # the mixed-dtype entries of csrc/kl_mutual.cu; launches: the
        # kernel_bf16 campaign's (phase 3c) counters, in-graph launches from
        # its profiled steady rounds; bf16 x against bf16 y has no caller
        *({"name": f"kl_mutual ({'backward, ' if key == 'bwd' else ''}"
                   f"{kl_pair_label(tx, ty)})", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/kl_mutual.cu",
           "replaces": ("src/repro/kernels/kl_mutual/ops.py:33" if key == "bwd"
                        else "src/repro/kernels/kl_mutual/kl_mutual.py:38"),
           "launches": prec["launches"].get(
               f"kl_mutual_{'grad' if key == 'bwd' else 'rows'}_"
               f"{KL_TYPE[tx][0]}_{KL_TYPE[ty][0]}", 0),
           **kl_mixed[(tx, ty, key)], **prec[(tx, ty, key)]}
          for tx, ty in KL_PAIRS for key in ("fwd", "bwd")),
        *({"name": f"flash_attention ({route})", "route": "cuda",
           "source": FLASH_KERNELS[route][1],
           "replaces": "src/repro/kernels/flash_attention/flash_attention.py"
                       ":77",
           **flash[route]} for route in FLASH_KERNELS),
    ]
    print("precision and wire formats (phase 3c): " + json.dumps(
        prec["variants"]))
    print("framework comparison (phase 3d): " + json.dumps(compared))
    print("time-varying RAN (phase 3e): " + json.dumps(scenarios))
    print("fault channels, guards and checkpoints (phases 3f, 3g): "
          + json.dumps(faults))
    print("population mode (phase 3h): " + json.dumps(population))
    print("config sweep (phase 3i): " + json.dumps(sweep))
    print("sharded campaign (phase 3k): " + json.dumps(sharded))
    print("README command lines (phase 3j), seconds: " + json.dumps(readme))
    print(f"the paper's result over {len(HORIZON_SEEDS)} seeds and C 6 "
          f"(phase 3l), {smi}: " + json.dumps(horizon))
    print("decoder and enc-dec families served (phase 4): "
          + json.dumps(decoders))
    print(f"zoo training (phase 6), {smi}: " + json.dumps(training))
    print(f"the zoo's tooling (phase 7), {smi}: " + json.dumps(
        {k: v for k, v in tooling.items() if k not in FL_WORLDS}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--tooling":
        sys.exit(tooling_worker(sys.argv[2], sys.argv[3]))
    sys.exit(main())
