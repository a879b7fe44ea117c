"""Probe of the port's plain KL rows (``kl_rows_ref``) for a flaky block of
rows on the CPU, stage by stage against an f64 evaluation.

    python tests/torch_kl_flake_probe.py [--calls N] [--jax] [--threads T]

On (1600, 256) inputs (``np.random.default_rng(0 / 1).normal`` × 3, the
KL test's draws at the main path's width) it calls ``kl_rows_ref`` N times
(600: ten times the 60 runs of the test that once failed) at T = 1 and 2
and checks every call's four stages, each from its own f32 inputs against
the same stage in f64: ``log_softmax`` of x and y, ``exp``, the product
``p_y (log p_y − log p_x)`` and the row ``sum``.  It counts the calls in
which a stage is off by more than 1e-5 anywhere, the rows so off, and the
calls whose result is not bit for bit the first call's.  ``--jax`` imports
JAX first and keeps a Pallas-interpret KL computation of the JAX package
dispatched beside every call (the setting in which the test failed).
Prints one JSON line.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
SHAPE = (1600, 256)


def stages(x, y, t, torch):
    """The four stages of ``kl_rows_ref`` as it computes them (f32)."""
    lx = torch.log_softmax(x / t, -1)
    ly = torch.log_softmax(y / t, -1)
    py = ly.exp()
    prod = py * (ly - lx)
    return lx, ly, py, prod, torch.sum(prod, -1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=600)
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--threads", type=int, default=0,
                    help="torch intra-op threads (0: torch's default)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    beside = None
    if args.jax:
        import jax.numpy as jnp
        from repro.kernels.kl_mutual.kl_mutual import kl_rows_pallas
    import torch
    from repro_torch.kernels.kl_mutual.ref import kl_rows_ref
    if args.threads:
        torch.set_num_threads(args.threads)
    rng0, rng1 = np.random.default_rng(0), np.random.default_rng(1)
    xn = (rng0.normal(size=SHAPE) * 3.0).astype(np.float32)
    yn = (rng1.normal(size=SHAPE) * 3.0).astype(np.float32)
    x, y = torch.from_numpy(xn), torch.from_numpy(yn)
    out = {"shape": list(SHAPE), "calls": args.calls, "jax": args.jax,
           "threads": torch.get_num_threads(),
           "torch": torch.__version__}
    t0 = time.time()
    for t in (1.0, 2.0):
        x64, y64 = x.double(), y.double()
        names = ("log_softmax_x", "log_softmax_y", "exp", "product", "sum")
        bad_calls = {n: 0 for n in names}
        bad_rows = {n: 0 for n in names}
        worst = {n: 0.0 for n in names}
        first, not_bitwise, final_err = None, 0, 0.0
        want = torch.sum(torch.softmax(y64 / t, -1)
                         * (torch.log_softmax(y64 / t, -1)
                            - torch.log_softmax(x64 / t, -1)), -1)
        for _ in range(args.calls):
            if args.jax:
                beside = kl_rows_pallas(jnp.asarray(xn), jnp.asarray(yn),
                                        temperature=t, bq=32, interpret=True)
            got = kl_rows_ref(x, y, t)
            lx, ly, py, prod, s = stages(x, y, t, torch)
            refs = (torch.log_softmax(x64 / t, -1),
                    torch.log_softmax(y64 / t, -1),
                    ly.double().exp(),
                    py.double() * (ly.double() - lx.double()),
                    prod.double().sum(-1))
            for n, v, r in zip(names, (lx, ly, py, prod, s), refs):
                err = (v.double() - r).abs()
                row_err = err if err.dim() == 1 else err.amax(-1)
                worst[n] = max(worst[n], float(row_err.max()))
                k = int((row_err > TOL).sum())
                bad_rows[n] += k
                bad_calls[n] += k > 0
            final_err = max(final_err, float((got.double() - want).abs()
                                             .max()))
            if first is None:
                first = got.clone()
            elif not torch.equal(got, first):
                not_bitwise += 1
            if beside is not None:
                beside.block_until_ready()
        out[f"T={t}"] = {"calls_off": bad_calls, "rows_off": bad_rows,
                         "worst_stage_err": worst,
                         "worst_result_err_vs_f64": final_err,
                         "calls_not_bitwise_equal_to_the_first": not_bitwise}
    out["seconds"] = round(time.time() - t0, 1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
