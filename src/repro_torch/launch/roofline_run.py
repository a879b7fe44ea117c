"""Finite-difference roofline at full width (companion to ``dryrun``);
twin of ``repro.launch.roofline_run``.

The JAX package measures two UNROLLED shallow variants (1 and 2 depth
units) at full width because XLA's cost analysis counts a while-loop body
once, and extrapolates to full depth:

    cost(L) ≈ cost(L1) + (L − L1) · [cost(L2) − cost(L1)] / (L2 − L1)

L1 / L2 are 1 / 2 layers (Zamba2: 1 / 2 groups of 6 + the shared block;
the enc-dec scales both stacks).  The port's step runs eagerly, one op at
a time, so a full-depth count has no loop to undercount; the shallow
variants stay because they are cheap and the extrapolation is exact for
every count that is linear in depth (``tests/test_torch_roofline.py``
holds it to the direct count).  Embedding, logits and optimizer overheads
land in the base term, per-layer collectives in the delta.  Results merge
with the dry-run's JSON into ``<arch>__<shape>__<mesh>__roofline.json``.

    PYTHONPATH=src python -m repro_torch.launch.roofline_run --all [--mesh both]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs.base import INPUT_SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.dryrun import ARCHS, RESULTS_DIR
from repro_torch.launch.mesh import PEAK_BYTES, make_dryrun_mesh
from repro_torch.launch.specs import decode_window_for
from repro_torch.models.transformer import build_abstract_model
from repro_torch.roofline.analysis import (model_flops_estimate,
                                           peak_flops_for)


def _depth_unit(cfg):
    """(unit_layers, n_units): the repeating depth unit."""
    if cfg.family == "hybrid":
        g = cfg.shared_attn_every
        return g, cfg.n_layers // g
    return 1, cfg.n_layers


def _shallow(cfg, units: int):
    unit, _ = _depth_unit(cfg)
    kw = {"n_layers": unit * units}
    if cfg.is_enc_dec:
        kw["enc_layers"] = units
        kw["n_layers"] = units
    return dataclasses.replace(cfg, **kw)


def _measure(cfg, shape, mesh, overrides: dict) -> dict:
    """One rank's counts of one step of ``cfg`` on ``mesh`` (a
    ``DeviceMesh``), meta tensors.  ``overrides``: remat, remat_policy,
    fsdp, expert_parallel, dp_over_model, pure_dp, zero3, grad_dtype,
    moe_local and optimizer (``dryrun.step_on_mesh``)."""
    def build():
        return build_abstract_model(
            cfg, remat=overrides.get("remat", True),
            remat_policy=overrides.get("remat_policy"),
            decode_window=decode_window_for(cfg, shape),
            moe_local_dispatch=overrides.get("moe_local", False))
    cc, _, _ = dryrun.count_step(build, shape, mesh, overrides)
    colls = cc.ops
    kinds = {c.kind for c in colls}
    return {
        "flops": float(cc.flops),
        "bytes": float(cc.bytes),
        "coll_bytes": float(sum(c.result_bytes * c.count for c in colls)),
        "coll_s": float(sum(c.wire_seconds * c.count for c in colls)),
        "coll_counts": {k: sum(c.count for c in colls if c.kind == k)
                        for k in kinds},
        "coll_s_by_kind": {k: float(sum(c.wire_seconds * c.count
                                        for c in colls if c.kind == k))
                           for k in kinds},
        "method": cc.method,
    }


def extrapolate(arch, shape_name: str, mesh, overrides: dict | None = None
                ) -> dict:
    """Counts at full depth from the 1- and 2-unit variants of ``arch``
    (a name or an ``ArchConfig``) on ``mesh``."""
    overrides = overrides or {}
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = (INPUT_SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    unit, n_units = _depth_unit(cfg)
    t0 = time.time()
    m1 = _measure(_shallow(cfg, 1), shape, mesh, overrides)
    m2 = _measure(_shallow(cfg, 2), shape, mesh, overrides)
    scale = n_units - 1
    out = {}
    for k in ("flops", "bytes", "coll_bytes", "coll_s"):
        out[k] = m1[k] + scale * (m2[k] - m1[k])
    counts, by_kind = {}, {}
    for k in set(m1["coll_counts"]) | set(m2["coll_counts"]):
        c1, c2 = m1["coll_counts"].get(k, 0), m2["coll_counts"].get(k, 0)
        counts[k] = c1 + scale * (c2 - c1)
        s1 = m1["coll_s_by_kind"].get(k, 0.0)
        s2 = m2["coll_s_by_kind"].get(k, 0.0)
        by_kind[k] = s1 + scale * (s2 - s1)
    out["coll_counts"] = counts
    out["coll_s_by_kind"] = by_kind
    out["scan_method"] = m2["method"]
    out["measure_s"] = round(time.time() - t0, 1)
    return out


def run_one(arch: str, shape_name: str, multi_pod: bool, force=False,
            overrides=None, tag="", out_dir: Path = RESULTS_DIR):
    mesh_name = "2x16x16" if multi_pod else "16x16"
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_name}{tag}__roofline.json"
    if out_path.exists() and not force:
        print(f"[skip] {out_path.name}")
        return json.loads(out_path.read_text())
    base_path = out_dir / f"{arch}__{shape_name}__{mesh_name}{tag}.json"
    base = json.loads(base_path.read_text()) if base_path.exists() else {}
    print(f"[roofline] {arch} × {shape_name} × {mesh_name} …", flush=True)
    try:
        mesh = make_dryrun_mesh(multi_pod=multi_pod)
        ex = extrapolate(arch, shape_name, mesh, overrides)
        cfg = get_config(arch)
        shape = INPUT_SHAPES[shape_name]
        peak = peak_flops_for(cfg.dtype)
        result = {
            "ok": True, "arch": arch, "shape": shape_name, "mesh": mesh_name,
            "chips": 512 if multi_pod else 256,
            "flops_per_device": ex["flops"],
            "bytes_per_device": ex["bytes"],
            "collective_bytes": ex["coll_bytes"],
            "compute_s": ex["flops"] / peak,
            "memory_s": ex["bytes"] / PEAK_BYTES,
            "collective_s": ex["coll_s"],
            "collective_counts": ex["coll_counts"],
            "collective_s_by_kind": ex.get("coll_s_by_kind", {}),
            "model_flops": model_flops_estimate(cfg, shape),
            "measure_s": ex["measure_s"],
            "method": "1/2-unit finite difference, eager meta DTensors"
                      + ("" if ex["scan_method"] == dryrun.DIRECT
                         else "; " + ex["scan_method"]),
            "full_dryrun": {k: base.get(k) for k in
                            ("ok", "per_device_bytes", "optimizer", "fits")},
        }
        terms = {"compute": result["compute_s"], "memory": result["memory_s"],
                 "collective": result["collective_s"]}
        result["dominant"] = max(terms, key=terms.get)
        result["overrides"] = overrides or {}
        tot = result["flops_per_device"] * result["chips"]
        result["useful_flops_ratio"] = (result["model_flops"] / tot
                                        if tot else 0.0)
        print(f"  ok: compute={result['compute_s']:.3e}s "
              f"memory={result['memory_s']:.3e}s "
              f"collective={result['collective_s']:.3e}s "
              f"dominant={result['dominant']} useful="
              f"{result['useful_flops_ratio']:.3f} "
              f"({ex['measure_s']}s)", flush=True)
    except Exception as e:  # noqa: BLE001
        result = dict(ok=False, arch=arch, shape=shape_name, mesh=mesh_name,
                      error=f"{type(e).__name__}: {e}"[:2000],
                      op=dryrun.failed_op(e),
                      traceback=traceback.format_exc()[-2000:])
        print(f"  FAIL: {result['error'][:200]}", flush=True)
    out_path.write_text(json.dumps(result, indent=1))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="suffix for hillclimb variants")
    ap.add_argument("--overrides", default="{}",
                    help="JSON dict, e.g. '{\"expert_parallel\": true}'")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    if args.mesh == "both":
        return dryrun.each_mesh(__name__, argv)
    overrides = json.loads(args.overrides)
    archs = ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = (list(INPUT_SHAPES) if (args.all or args.shape is None)
              else [args.shape])
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            r = run_one(arch, shape, args.mesh == "multipod",
                        force=args.force, overrides=overrides, tag=args.tag,
                        out_dir=Path(args.out))
            n_fail += 0 if r.get("ok") else 1
    print(f"done; failures: {n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
