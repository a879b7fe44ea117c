"""Subprocess side of the port's tooling tests (tests/test_torch_*.py of
the partition rules, the roofline, the dry-runs and the model-axis mesh):
a process group is process-global, so each check that needs one runs here,
in a process of its own, and writes its result as JSON.

    python tests/torch_tooling_check.py <check> <out.json> [args]

checks:
    fl-port        the port's ``lower_round`` on a fake (4, 2) world
    fl-jax         the reference's ``lower_round`` on 8 XLA CPU devices
    partition      placements and sharded meta models on fake worlds
    toy-matmul     one rank's FLOPs of a sharded matmul (fake 16 x 16)
    extrapolate    the 1/2-unit extrapolation against full depth
    rules          the port's sharding rules and reshards on fake worlds:
                   the MoE dispatch, uneven head views, an op with no rule
    scan-steps     the scan-step extrapolation against the direct count
    mesh-round     one SplitMe round on a gloo job of CPU processes
    rule-values    reduced zoo steps on a 2-rank gloo job, DTensor against
                   plain
"""
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# the fl_dryrun cases: (kind, E, wire)
FL_M, FL_N = 16, 16
FL_CASES = [("splitme", 1, None), ("splitme", 3, None),
            ("splitme", 1, "bf16"), ("splitme", 3, "bf16"),
            ("splitme", 1, "int8"), ("splitme", 3, "int8"),
            ("sfl", 1, None), ("sfl", 3, None), ("inversion", 1, None)]


def fl_case_id(kind, E, quant) -> str:
    return f"{kind}-E{E}-{quant or 'f32'}"


def fl_port():
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch.fl_dryrun import lower_round
    from repro_torch.launch.mesh import make_fake_mesh
    mesh = make_fake_mesh((4, 2), ("data", "model"))
    return {fl_case_id(*c): lower_round(c[0], mesh, FL_M, FL_N, c[1],
                                        quant=c[2]) for c in FL_CASES}


def fl_jax():
    import jax
    from repro.launch.fl_dryrun import lower_round
    mesh = jax.make_mesh((4, 2), ("data", "model"))
    return {fl_case_id(*c): lower_round(c[0], mesh, FL_M, FL_N, c[1],
                                        quant=c[2]) for c in FL_CASES}


def partition():
    """Placements of the rules' specs on a fake 2 x 16 x 16 world, and a
    reduced model sharded on it: each parameter's local shape."""
    import torch
    from torch.distributed.tensor import Replicate
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.transformer import build_abstract_model
    from repro_torch.sharding import partition as tp
    mesh = make_production_mesh(multi_pod=True)
    out = {"placements": {}}
    for spec in [(None, None), (("pod", "data"), "model"), ("data", None),
                 (None, ("pod", "data")), ("model", ("pod", "data"))]:
        out["placements"][repr(spec)] = [
            "R" if isinstance(p, Replicate) else f"S{p.dim}"
            for p in tp.placements(spec, mesh)]
    model = build_abstract_model(get_config("qwen3-14b"))
    full = {k: list(p.shape) for k, p in model.named_parameters()}
    specs = tp.shard_params(model, mesh)
    out["local"] = {k: list(p.to_local().shape)
                    for k, p in model.named_parameters()}
    out["full"] = full
    out["specs"] = {k: [list(a) if isinstance(a, tuple) else a for a in s]
                    for k, s in specs.items()}
    batch = tp.shard_batch({"tokens": torch.empty((256, 4096),
                                                  dtype=torch.int32,
                                                  device="meta")}, mesh)
    out["batch_local"] = list(batch["tokens"].to_local().shape)
    return out


def toy_matmul():
    import torch
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.roofline.analysis import CostCounter
    from repro_torch.sharding import partition as tp
    mesh = make_production_mesh()
    a = tp.distribute(torch.empty((64, 1024), device="meta"),
                      tp.batch_spec((64, 1024), mesh), mesh)
    b = tp.distribute(torch.empty((1024, 512), device="meta"),
                      tp.param_spec("w", (1024, 512), mesh), mesh)
    with CostCounter() as cc:
        c = a @ b
    return {"flops": cc.flops, "local_out": list(c.to_local().shape),
            "b_local": list(b.to_local().shape)}


# (arch, overrides of the reduced config, shape (name, seq, batch, kind))
EXTRAP_CASES = [
    ("smollm-135m", {"n_layers": 5}, ("t", 64, 4, "train")),
    ("smollm-135m", {"n_layers": 5}, ("d", 64, 4, "decode")),
    ("internvl2-1b", {"n_layers": 4}, ("p", 32, 4, "prefill")),
    ("rwkv6-1.6b", {"n_layers": 4}, ("p", 32, 4, "prefill")),
    ("zamba2-2.7b", {"n_layers": 4, "shared_attn_every": 2},
     ("t", 32, 4, "train")),
    ("seamless-m4t-medium", {"n_layers": 3, "enc_layers": 3},
     ("p", 32, 4, "prefill")),
]


def extrap_id(case) -> str:
    return f"{case[0]}-{case[2][3]}"


def extrapolate():
    import dataclasses
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.launch.roofline_run import _measure, extrapolate as ex
    mesh = make_fake_mesh((2, 2), ("data", "model"))
    out = {}
    for case in EXTRAP_CASES:
        arch, kw, (name, seq, b, kind) = case
        cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
        shape = InputShape(name, seq, b, kind)
        direct = _measure(cfg, shape, mesh, {})
        est = ex(cfg, shape, mesh, {})
        out[extrap_id(case)] = {"direct": direct, "extrapolated": est}
    return out


def _collectives(ops) -> dict:
    out = {}
    for c in ops:
        out[c.kind] = out.get(c.kind, 0) + c.count
    return out


def _reduced(arch, **kw):
    import dataclasses
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(arch).reduced(), **kw)


# the reduced configs whose 3 query heads (one KV head) split neither a
# "model" axis of 2 nor one of 4
UNEVEN_HEADS = {"n_heads": 3, "n_kv_heads": 1, "head_dim": 64}
RULE_MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
# the MoE steps of the rules check: GQA and a train step, MLA and decode
MOE_STEPS = [("granite-moe-3b-a800m", "train"), ("deepseek-v3-671b", "decode")]
# the expert layouts of the rules check's MoE train steps
EXPERT_LAYOUTS = [False, True, "megatron"]


def rules():
    """(a) The MoE dispatch of reduced Granite-MoE and DeepSeek-V3 steps on
    a fake 2 x 2 world, with the collectives run inside ``dispatch_slots``,
    the ``searchsorted`` rule alone on a sharded sequence, and Granite-MoE
    train steps under each expert layout, with the layouts of the experts'
    weights before and after ``fsdp_gathered``; (b) decode
    of a reduced config with 3 heads on "model" axes of 2 and 4, with every
    reshard of ``partition.reshape`` and the collectives it ran; an op with
    no rule through the CLI's ``main`` (its exit code)."""
    import torch
    torch.set_num_threads(1)
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.models import moe
    from repro_torch.models.transformer import build_abstract_model
    from repro_torch.roofline.analysis import CollectiveTrace
    from repro_torch.sharding import partition as tp, rules as tr
    out = {"moe": {}, "heads": {}}
    meshes = {k: make_fake_mesh(v, ("data", "model"))
              for k, v in RULE_MESHES.items()}
    mesh = meshes["2x2"]
    tr.install()
    seq = distribute_tensor(torch.arange(16), mesh, [Shard(0), Replicate()])
    q = distribute_tensor(torch.arange(8), mesh, [Shard(0), Replicate()])
    with implicit_replication(), CollectiveTrace() as ct:
        got = torch.searchsorted(seq, q)
    out["searchsorted"] = {"counts": ct.counts,
                           "placements": [repr(p) for p in got.placements]}

    dispatch = []
    plain_dispatch = moe.dispatch_slots

    def traced_dispatch(*a, **k):
        with CollectiveTrace() as t:
            res = plain_dispatch(*a, **k)
        dispatch.append(t.counts)
        return res
    moe.dispatch_slots = traced_dispatch
    for arch, kind in MOE_STEPS:
        cfg = _reduced(arch)
        dispatch.clear()
        cc, _, _ = dryrun.count_step(
            lambda: build_abstract_model(cfg), InputShape(kind, 8, 4, kind),
            mesh, {})
        out["moe"][f"{arch}-{kind}"] = {
            "counts": _collectives(cc.ops), "dispatch": list(dispatch)}
    moe.dispatch_slots = plain_dispatch

    # the experts' weights as the MoE uses them, by expert_parallel
    experts = []
    plain_gathered = moe.fsdp_gathered

    def traced_gathered(w):
        y = plain_gathered(w)
        experts.append({"shape": list(w.shape),
                        "from": [repr(p) for p in w.placements],
                        "to": [repr(p) for p in y.placements]})
        return y
    moe.fsdp_gathered = traced_gathered
    out["experts"] = {}
    for ep in EXPERT_LAYOUTS:
        experts.clear()
        cfg = _reduced("granite-moe-3b-a800m")
        cc, _, _ = dryrun.count_step(
            lambda: build_abstract_model(cfg),
            InputShape("train", 8, 4, "train"), mesh,
            {"expert_parallel": ep})
        out["experts"][str(ep)] = {"counts": _collectives(cc.ops),
                                   "flops": cc.flops,
                                   "calls": list(experts)}
    moe.fsdp_gathered = plain_gathered

    reshards = []
    plain_evened = tp._evened

    def traced_evened(x, shape):
        with CollectiveTrace() as t:
            y = plain_evened(x, shape)
        if y is not x:
            reshards.append({"shape": list(shape), "counts": t.counts,
                             "from": [repr(p) for p in x.placements],
                             "to": [repr(p) for p in y.placements]})
        return y
    tp._evened = traced_evened
    for name, m in meshes.items():
        reshards.clear()
        cfg = _reduced("smollm-135m", **UNEVEN_HEADS)
        cc, _, _ = dryrun.count_step(
            lambda: build_abstract_model(cfg), InputShape(
                "decode", 16, 4, "decode"), m, {})
        out["heads"][name] = {"counts": _collectives(cc.ops),
                              "reshards": list(reshards)}
    tp._evened = plain_evened
    return out


def _no_rule_step(model, shape, mesh, overrides):
    """A step on the fake world that calls ``aten.renorm``, an op DTensor
    has no sharding rule for."""
    import torch
    from repro_torch.sharding import partition as tp
    x = tp.distribute(torch.empty((8, 4), device="meta"), ("data", None),
                      mesh)
    return torch.renorm(x, 2, 0, 1.0)


def no_rule():
    """The dry-run CLI (``main``) on a step that calls an op with no rule:
    its exit code and result."""
    import tempfile
    from repro_torch.launch import dryrun
    dryrun.step_on_mesh = _no_rule_step
    with tempfile.TemporaryDirectory() as d:
        try:
            dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                         "--out", d])
            code = 0
        except SystemExit as e:
            code = e.code
        result = json.loads((Path(d) / "smollm-135m__decode_32k__16x16.json")
                            .read_text())
    return {"exit": code, "result": result}


# (arch, overrides of the reduced config, shape (name, seq, batch, kind)):
# the sequential scans at 8 tokens, the chunked SSD form (meta prefill) at
# 7 chunks of 32: more steps than the counted runs' 3, 4 and 5
SCAN_CASES = [
    ("rwkv6-1.6b", {"n_layers": 1}, ("t", 8, 4, "train")),
    ("rwkv6-1.6b", {"n_layers": 1}, ("p", 8, 4, "prefill")),
    ("zamba2-2.7b", {"n_layers": 2, "shared_attn_every": 2},
     ("t", 8, 4, "train")),
    ("zamba2-2.7b", {"n_layers": 2, "shared_attn_every": 2},
     ("p", 224, 4, "prefill")),
]


def scan_id(case) -> str:
    return f"{case[0]}-{case[2][3]}"


def scan_steps():
    """Each scan case's counts on a fake 2 x 2 world, direct (every step)
    and from the loops cut to 3, 4 and 5 steps (``dryrun.count_step``)."""
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.models.transformer import build_abstract_model
    mesh = make_fake_mesh((2, 2), ("data", "model"))
    out = {}
    for case in SCAN_CASES:
        arch, kw, shape = case
        cfg = _reduced(arch, **kw)
        shape = InputShape(*shape)

        def build():
            return build_abstract_model(cfg)
        direct, _, _ = dryrun.step_on_mesh(build(), shape, mesh, {})
        est, _, _ = dryrun.count_step(build, shape, mesh, {})
        out[scan_id(case)] = {
            k: {"flops": c.flops, "bytes": c.bytes, "peak": c.peak_bytes,
                "peak_bounds": getattr(c, "peak_bounds", None),
                "collectives": _collectives(c.ops),
                "collective_bytes": sum(o.result_bytes * o.count
                                        for o in c.ops),
                "method": getattr(c, "method", "")}
            for k, c in (("direct", direct), ("extrapolated", est))}
    return out


def _mesh_rank(rank, world, store, shape, names, quant, out):
    import pickle
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    from repro_torch.configs.splitme_dnn import DNN10
    from repro_torch.core import dnn, engine
    from repro_torch.core.distributed import make_splitme_round
    mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))
    M, n, E, B = 8, 24, 3, 8
    g = torch.Generator().manual_seed(11)
    w_c = dnn.init_client(g, DNN10, torch.device("cpu"))
    w_i = dnn.init_inverse_server(g, DNN10, torch.device("cpu"))
    x = torch.randn((M, n, DNN10.n_features), generator=g)
    y = torch.randint(0, DNN10.n_classes, (M, n), generator=g)
    idx = torch.randint(0, n, (2, M, E, B), generator=g)
    y1 = torch.nn.functional.one_hot(y, DNN10.n_classes).float()
    fn = make_splitme_round(DNN10, mesh, n_clients=M, samples_per_client=n,
                            E=E, batch=B, quant=quant, device="cpu")
    uniforms = None
    if quant == "int8":
        spec = engine.make_spec("splitme", DNN10, quant=quant, device="cpu")
        uniforms = engine.quant_uniforms(spec, (w_c, w_i),
                                         engine.uniform_generator(
                                             5, engine.shard_index(mesh)))
    before = engine.ALL_REDUCES
    w_c2, w_i2 = fn(w_c, w_i, x, y1, idx, uniforms)
    res = {"params": [[{k: v.numpy() for k, v in p.items()} for p in w]
                      for w in (w_c2, w_i2)],
           "shard": engine.shard_index(mesh),
           "n_shards": engine.n_client_shards(mesh),
           "all_reduces": engine.ALL_REDUCES - before}
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


def mesh_round(out, shape, names, quant):
    """One SplitMe round (DNN10, 8 clients, E 3) on a gloo job of
    prod(shape) CPU processes with mesh dims ``names``; each rank's result
    pickled to ``<out>.<rank>``."""
    import tempfile
    import torch.multiprocessing as mp
    world = 1
    for s in shape:
        world *= s
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_mesh_rank, args=(world, os.path.join(d, "pg"),
                                             shape, names, quant, out),
                           nprocs=world, start_method="spawn", join=True)
    return {"world": world}


def _values_rank(rank, world, store, out):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    from repro_torch.models.transformer import build_model
    from repro_torch.sharding import partition as tp, rules as tr
    tr.install()

    def err(got, want):
        return [float((got.full_tensor() - want).abs().max()),
                float(want.abs().max())]
    res = {}
    for shape in VALUE_MESHES:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data",
                                                              "model"))
        name = "x".join(map(str, shape))
        g = torch.Generator().manual_seed(3)
        # the MoE forward: the dispatch's rule, its buffers, the views
        model = build_model(_reduced("granite-moe-3b-a800m"), device="cpu")
        tokens = torch.randint(0, model.cfg.vocab_size, (2, 8), generator=g)
        with torch.no_grad():
            want, _ = model.forward({"tokens": tokens})
            tp.shard_params(model, mesh)
            with implicit_replication():
                got, _ = model.forward(tp.shard_batch({"tokens": tokens},
                                                      mesh))
        res[f"moe-forward-{name}"] = err(got, want)
        # decode with 3 heads on the "model" axis: the reshards of the
        # uneven head views, the sharded KV cache written in place
        model = build_model(_reduced("smollm-135m", **UNEVEN_HEADS),
                            device="cpu")
        steps = torch.randint(0, model.cfg.vocab_size, (3, 2, 1),
                              generator=g)
        with torch.no_grad():
            plain = model.init_cache(2, prefill_len=0)
            wants = []
            for tok in steps:
                logits, plain = model.decode_step(tok, plain)
                wants.append(logits)
            cache = tp.shard_cache(model.init_cache(2, prefill_len=0), mesh)
            tp.shard_params(model, mesh)
            with implicit_replication():
                for i, tok in enumerate(steps):
                    logits, cache = model.decode_step(
                        tp.shard_batch({"t": tok}, mesh)["t"], cache)
                    res[f"heads-decode-{name}-step{i}"] = err(logits,
                                                              wants[i])
    if rank == 0:
        Path(out).write_text(json.dumps(res, indent=1))
    dist.destroy_process_group()


# the 2-rank gloo meshes of the values check: the batch over 2, and the
# heads' "model" axis of 2
VALUE_MESHES = [(2, 1), (1, 2)]


def rule_values(out):
    """``_values_rank`` on a gloo job of 2 CPU processes; rank 0 writes
    {case: [max |DTensor - plain|, max |plain|]} to ``out``."""
    import tempfile
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_values_rank, args=(2, os.path.join(d, "pg"),
                                               out),
                           nprocs=2, start_method="spawn", join=True)
    return json.loads(Path(out).read_text())


CHECKS = {"fl-port": fl_port, "fl-jax": fl_jax, "partition": partition,
          "toy-matmul": toy_matmul, "extrapolate": extrapolate,
          "rules": rules, "no-rule": no_rule, "scan-steps": scan_steps}

if __name__ == "__main__":
    check, out_path = sys.argv[1:3]
    if check == "rule-values":
        rule_values(out_path)
        sys.exit(0)
    if check == "mesh-round":
        # mesh-round <out> <quant|none> <name=size> ...
        quant = None if sys.argv[3] == "none" else sys.argv[3]
        dims = [a.split("=") for a in sys.argv[4:]]
        result = mesh_round(out_path, [int(s) for _, s in dims],
                            [n for n, _ in dims], quant)
    else:
        result = CHECKS[check]()
    Path(out_path).write_text(json.dumps(result, indent=1, default=float))
