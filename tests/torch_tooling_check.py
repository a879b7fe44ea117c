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
    mesh-round     one SplitMe round on a gloo job of CPU processes
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


CHECKS = {"fl-port": fl_port, "fl-jax": fl_jax, "partition": partition,
          "toy-matmul": toy_matmul, "extrapolate": extrapolate}

if __name__ == "__main__":
    check, out_path = sys.argv[1:3]
    if check == "mesh-round":
        # mesh-round <out> <quant|none> <name=size> ...
        quant = None if sys.argv[3] == "none" else sys.argv[3]
        dims = [a.split("=") for a in sys.argv[4:]]
        result = mesh_round(out_path, [int(s) for _, s in dims],
                            [n for n, _ in dims], quant)
    else:
        result = CHECKS[check]()
    Path(out_path).write_text(json.dumps(result, indent=1, default=float))
