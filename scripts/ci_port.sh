#!/usr/bin/env sh
# CI pipeline of the PyTorch port (src/repro_torch), on the CPU; the twin of
# stages 1-5 of scripts/ci.sh:
#   1. ruff lint of the port, its scripts and its tests (when installed)
#   2. the port's CPU tests, tests/test_torch_*.py (those that need a card
#      skip here)
#   3. crash-resume check: SIGKILL a checkpointed campaign mid-run, resume,
#      assert bit-identical results (scripts/crash_resume_check_torch.py)
#   4. docs checks: the repro_torch names and paths that README.md,
#      docs/*.md and PERF.md cite resolve (scripts/check_docs_torch.py),
#      and the quickstart's smoke run on the CPU
#   5. the paper's experiment at its full horizon, short: each framework's
#      campaign over 2 seeds in both packages, each on its own draws
#      (tests/torch_horizon_check.py seeds --seeds 2)
#
#     sh scripts/ci_port.sh
#
# The port's benchmark and its regression gate (stages 6-7 of
# scripts/ci.sh) wait for the port's benchmark.
set -eu
cd "$(dirname "$0")/.."

export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
export JAX_PLATFORMS=cpu
OUT="${TMPDIR:-/tmp}/ci_port"
mkdir -p "$OUT"

echo "== ruff lint (the port) =="
if command -v ruff >/dev/null 2>&1; then
    ruff check src/repro_torch scripts/*_torch.py \
        tests/test_torch_*.py tests/torch_*.py chip_smoke.py
else
    echo "ruff not installed; skipping lint stage"
fi

echo "== the port's CPU tests =="
python -m pytest -q -p no:cacheprovider tests/test_torch_*.py

echo "== crash-resume check (SIGKILL + resume, bit-identical) =="
python scripts/crash_resume_check_torch.py --device cpu

echo "== docs checks (references resolve + quickstart smoke) =="
python scripts/check_docs_torch.py
python -m repro_torch.examples.quickstart --rounds 2 --device cpu

echo "== the full horizon, 2 seeds a framework, both packages =="
python tests/torch_horizon_check.py seeds "$OUT/horizon_seeds.json" \
    --seeds 2
