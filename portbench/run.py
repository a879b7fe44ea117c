"""The benchmark of the PyTorch port: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, the kernels' library, the inputs from ``--seed`` and one
warm call of the cell's shapes), then whole campaign calls back to back
for at least ``--seconds``, then the comparison of sampled lanes with the
plain reference.  The last line of standard output is the result as one
JSON object; the numbers compared go to standard error as its last lines.
Exits non-zero, printing no result, without enough CUDA cards.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache a run could fill stays inside the checkout, at fixed paths
    cache = ROOT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "extensions")
    # one host thread for torch's and numpy's pools: the host work of a
    # call is small operations on one thread, and idle pool threads that
    # spin take the shared host's cores from it
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import harness
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['chips']} CUDA card(s) needed, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), t_start=T_START,
                           chips=cell["chips"], bench=bench)
    if out is None:
        return 3
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
