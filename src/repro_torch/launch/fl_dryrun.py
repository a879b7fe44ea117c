"""Dry-run of the paper's own technique on the production mesh; twin of
``repro.launch.fl_dryrun``.

Runs rank 0's share of one global round over a fake world
(``launch.mesh.make_production_mesh``) under ``roofline.analysis``'s
``CostCounter``, for

* SplitMe: the engine's sharded round (``core.distributed.
  make_splitme_round``), E local steps a side and one bundled all-reduce;
* vanilla SFL: the per-step boundary exchange made explicit
  (``make_sfl_round``, dry-run accounting, not a production path): each
  local step shifts the rank's smashed batch one step along the ``model``
  ring and its gradient one step back;
* Step 4: ``core.distributed.make_distributed_inversion``, one Gram
  all-reduce a server layer;

with M clients sharded over the mesh's client dims, E ∈ {1, 10}.  The
paper's claim ("reduce the multiple-communication-per-round level of SFL
to one-communication-per-round") is a structural property of the trace:

    SplitMe : collective bytes CONSTANT in E (one bundled all-reduce)
    SFL     : collective bytes ∝ E (two boundary permutes a local step)

    PYTHONPATH=src python -m repro_torch.launch.fl_dryrun [--multipod] \\
        [--device cpu] [--out build/fl_dryrun_torch/fl_dryrun_16x16.json]

A process group is process-global: run it as a process of its own.  The
round's tensors live on ``--device`` (the card by default, where the KL
and Gram kernels launch); the fake collectives move nothing.  Randomness
is an input: the batch indices and the int8 uniforms are drawn from
``--seed`` on the host and passed in.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs.splitme_dnn import DNN10, DNNConfig
from repro_torch.core import dnn, engine, quantcomm
from repro_torch.core.distributed import (make_distributed_inversion,
                                          make_splitme_round)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline.analysis import CostCounter, record

OUT = Path(__file__).resolve().parents[3] / "build" / "fl_dryrun_torch"


# ---------------------------------------------------------------------------
# Vanilla SFL with the per-step boundary exchange made explicit
# ---------------------------------------------------------------------------

def ring_shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """``x`` sent ``shift`` steps along the ring of ``group``'s ranks and
    what arrives from ``-shift`` steps back (``jax.lax.ppermute`` with the
    pairs (i, i + shift)); recorded as one ``collective-permute`` in the
    active ``CollectiveTrace``s.  On one rank, or a fake group whose
    receives write nothing, ``x`` comes back."""
    record("collective-permute", x, group)
    n = dist.get_world_size(group)
    out = x.clone()
    if n == 1:
        return out
    r = dist.get_rank(group)
    to = dist.get_global_rank(group, (r + shift) % n)
    frm = dist.get_global_rank(group, (r - shift) % n)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x.contiguous(), to, group=group),
        dist.P2POp(dist.irecv, out, frm, group=group)])
    for q in reqs:
        q.wait()
    return out


def _nll_per_client(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, -1)
    return -torch.gather(logp, -1, y[..., None])[..., 0].mean(-1)


def make_sfl_round(cfg: DNNConfig, mesh, *, n_clients: int,
                   samples_per_client: int, E: int, batch: int = 32,
                   lr: float = 0.05):
    """Vanilla SFL (SplitFed) round with the boundary exchange of every
    local step explicit: the smashed batch goes one step up the ``model``
    ring to the server tier and its gradient one step back, E times a
    round.  Both carry the rank's whole slab, (M_local, batch, d_split):
    one permute a direction a step, not one a client.

    Returns ``round_fn(w_c, w_s, x, y, idx) -> (w_c', w_s')`` over the
    full-M operands on every rank: ``x`` (M, n, d), ``y`` (M, n) labels,
    ``idx`` (M, E, batch) int64 batch indices.  Each rank trains its slab
    (``engine.shard_slice``); the client means cross the client group in
    one all-reduce (the reference's 20 per-leaf ``psum``s, which XLA's
    all-reduce combiner fuses into one)."""
    del samples_per_client  # shapes come from the data argument
    sl = engine.shard_slice(mesh, int(n_clients))
    ring = mesh.get_group("model")
    n_shards = engine.n_client_shards(mesh)

    def round_fn(w_c, w_s, x, y, idx):
        xs, ys, ids = x[sl], y[sl].long(), idx[sl]
        m = xs.shape[0]
        rows = torch.arange(m, device=xs.device)[:, None]
        wc = [{k: v.expand(m, *v.shape).clone() for k, v in p.items()}
              for p in w_c]
        ws = [{k: v.expand(m, *v.shape).clone() for k, v in p.items()}
              for p in w_s]
        for i in range(E):
            sel = ids[:, i]
            xb, yb = xs[rows, sel], ys[rows, sel]
            wc = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
                  for p in wc]
            ws = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
                  for p in ws]
            with torch.enable_grad():
                smashed = dnn.client_forward(wc, xb, cfg)
                # boundary exchange 1: smashed data -> server tier
                h = ring_shift(smashed.detach(), ring, 1).requires_grad_(True)
                loss = _nll_per_client(dnn.server_forward(ws, h, cfg), yb)
                flat_s = [v for p in ws for v in p.values()]
                *g_ws, g_h = torch.autograd.grad(loss.sum(), flat_s + [h])
                # boundary exchange 2: gradient -> client tier
                g_back = ring_shift(g_h, ring, -1)
                flat_c = [v for p in wc for v in p.values()]
                g_wc = torch.autograd.grad(smashed, flat_c, g_back)
            it_c, it_s = iter(g_wc), iter(g_ws)
            wc = [{k: v.detach() - lr * next(it_c) for k, v in p.items()}
                  for p in wc]
            ws = [{k: v.detach() - lr * next(it_s) for k, v in p.items()}
                  for p in ws]
        mean = lambda t: [{k: v.mean(0) / n_shards for k, v in p.items()}
                          for p in t]
        return tuple(engine.all_reduce_bundle([mean(wc), mean(ws)], mesh))

    return round_fn


# ---------------------------------------------------------------------------
# One traced round + its collective accounting
# ---------------------------------------------------------------------------

def collective_comm_bits(colls, quant=None) -> float:
    """Wire bits of the traced collectives under the ``CommQuant``
    accounting: payload ELEMENT count × the format's wire width (int8 is a
    simulated wire carried as f32, bf16 a real bf16 all-reduce)."""
    q = quantcomm.get_quant(quant)
    return float(sum(c.result_elems for c in colls)) * q.wire_bits


def _inputs(kind: str, cfg: DNNConfig, M: int, n: int, E: int, batch: int,
            seed: int, device):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((M, n, cfg.n_features), generator=g)
    y = torch.randint(0, cfg.n_classes, (M, n), generator=g)
    n_ph = 2 if kind == "splitme" else 1
    idx = torch.randint(0, n, (n_ph, M, E, batch), generator=g)
    return x.to(device), y.to(device), idx.to(device)


def lower_round(kind: str, mesh, M: int, n: int, E: int, quant=None, *,
                device="cpu", seed: int = 0, batch: int = 32) -> dict:
    """Run rank 0's share of one round of ``kind`` ("splitme", "sfl" or
    "inversion") on ``mesh`` under a ``CostCounter``: the reference's
    keys (``collective_bytes``, ``comm_bits``, ``quant``,
    ``collective_s``, ``counts``, ``flops``) and the round's ``bytes``."""
    dev = torch.device(device)
    cfg = DNN10
    gen = torch.Generator().manual_seed(seed)     # the weights' draws
    w_c = dnn.init_client(gen, cfg, dev)
    x, y, idx = _inputs(kind, cfg, M, n, E, batch, seed, dev)
    if kind == "splitme":
        fn = make_splitme_round(cfg, mesh, n_clients=M, samples_per_client=n,
                                E=E, batch=batch, quant=quant, device=dev)
        w_i = dnn.init_inverse_server(gen, cfg, dev)
        y1 = torch.nn.functional.one_hot(y, cfg.n_classes).float()
        uniforms = None
        if quantcomm.get_quant(quant).stochastic:
            spec = engine.make_spec("splitme", cfg, quant=quant, device=dev)
            uniforms = engine.quant_uniforms(
                spec, (w_c, w_i), engine.uniform_generator(
                    seed, engine.shard_index(mesh))).to(dev)
        call = lambda: fn(w_c, w_i, x, y1, idx, uniforms)
    elif kind == "sfl":
        fn = make_sfl_round(cfg, mesh, n_clients=M, samples_per_client=n,
                            E=E, batch=batch)
        w_s = dnn.init_server(gen, cfg, dev)
        call = lambda: fn(w_c, w_s, x, y, idx[0])
    elif kind == "inversion":
        fn = make_distributed_inversion(cfg, mesh)
        w_i = dnn.init_inverse_server(gen, cfg, dev)
        with torch.no_grad():
            smashed = dnn.client_forward(w_c, x, cfg)
        y1 = torch.nn.functional.one_hot(y, cfg.n_classes).float()
        call = lambda: fn(w_i, smashed, y1)
    else:
        raise ValueError(f"kind must be splitme, sfl or inversion, got "
                         f"{kind!r}")
    with CostCounter() as tr:
        out = call()
    colls = tr.ops
    # a fake all-reduce sums nothing, so the values are one rank's: the
    # rounds' stay finite, Step 4's ridge solve of one rank's Grams at
    # γ = 1e-3 may be singular (ROADMAP C), so only its shapes are checked
    leaves = quantcomm.tree_leaves(out)
    if kind == "inversion":
        dims = dnn.server_dims(cfg)
        if [tuple(p["w"].shape) for p in out] != list(zip(dims[:-1],
                                                          dims[1:])):
            raise ValueError(f"Step 4 gave {[p['w'].shape for p in out]}")
    elif not all(bool(torch.isfinite(t).all()) for t in leaves):
        raise FloatingPointError(f"{kind} E={E}: non-finite output")
    return {
        "collective_bytes": tr.collective_bytes,
        "comm_bits": collective_comm_bits(colls, quant),
        "quant": quantcomm.get_quant(quant).mode,
        "collective_s": tr.collective_s,
        "counts": tr.counts,
        "flops": float(tr.flops),
        "bytes": float(tr.bytes),
    }


def run(multi_pod: bool, clients: int, samples: int, device,
        Es=(1, 10)) -> dict:
    """The reference's ``main``: SplitMe and SFL at each E, SplitMe under
    the bf16 and int8 wires, Step 4, and the claim's flags."""
    dev = resolve_device(device)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=dev.type)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    out = {"mesh": mesh_name, "clients": clients,
           "samples_per_client": samples, "device": str(dev)}
    for kind in ("splitme", "sfl"):
        for E in Es:
            t0 = time.time()
            r = lower_round(kind, mesh, clients, samples, E, device=dev)
            out[f"{kind}_E{E}"] = r
            print(f"{kind} E={E}: collective_bytes="
                  f"{r['collective_bytes']:.3e} ({r['counts']}) "
                  f"[{time.time() - t0:.1f}s]", flush=True)
    e1 = Es[0]
    for qm in ("bf16", "int8"):
        r = lower_round("splitme", mesh, clients, samples, e1, quant=qm,
                        device=dev)
        out[f"splitme_E{e1}_{qm}"] = r
        print(f"splitme E={e1} quant={qm}: comm_bits={r['comm_bits']:.3e} "
              f"({r['counts']})", flush=True)
    base = out[f"splitme_E{e1}"]["comm_bits"]
    one = {"all-reduce": 1}
    out["quant_bf16_halves_comm_bits"] = bool(
        out[f"splitme_E{e1}_bf16"]["counts"] == one
        and out[f"splitme_E{e1}_bf16"]["comm_bits"] == 0.5 * base > 0)
    out["quant_int8_quarters_comm_bits"] = bool(
        out[f"splitme_E{e1}_int8"]["counts"] == one
        and out[f"splitme_E{e1}_int8"]["comm_bits"] == 0.25 * base > 0)
    out["inversion"] = lower_round("inversion", mesh, clients, samples, 1,
                                   device=dev)
    print(f"step4 inversion: collective_bytes="
          f"{out['inversion']['collective_bytes']:.3e} "
          f"({out['inversion']['counts']})", flush=True)
    s1 = out[f"splitme_E{Es[0]}"]["collective_bytes"]
    s2 = out[f"splitme_E{Es[-1]}"]["collective_bytes"]
    v1 = out[f"sfl_E{Es[0]}"]["collective_bytes"]
    v2 = out[f"sfl_E{Es[-1]}"]["collective_bytes"]
    out["splitme_bytes_constant_in_E"] = bool(s2 == s1)
    out["sfl_bytes_scale_with_E"] = bool(v2 > (Es[-1] / Es[0]) * v1 / 4)
    print(f"SplitMe bytes E{Es[0]}->E{Es[-1]}: {s1:.3e} -> {s2:.3e} "
          f"(constant: {out['splitme_bytes_constant_in_E']})")
    print(f"SFL bytes     E{Es[0]}->E{Es[-1]}: {v1:.3e} -> {v2:.3e} "
          f"(scales: {out['sfl_bytes_scale_with_E']})")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--clients", type=int, default=512)
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="where the round's tensors live (default: cuda)")
    ap.add_argument("--out", default=None,
                    help="JSON path (default build/fl_dryrun_torch/"
                         "fl_dryrun_<mesh>.json)")
    args = ap.parse_args(argv)
    out = run(args.multipod, args.clients, args.samples, args.device)
    path = (Path(args.out) if args.out else
            OUT / f"fl_dryrun_{out['mesh']}.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
