#!/usr/bin/env python
"""Docs drift gate of the PyTorch port: every ``repro_torch`` name and
every repository path that README.md, docs/*.md and PERF.md cite must
exist.

    PYTHONPATH=src python scripts/check_docs_torch.py

The twin of scripts/check_docs.py for the port, with its checks:

1. every ``import`` / ``from X import Y`` line of ``repro_torch`` inside a
   fenced python code block must import, and the names must exist;
2. every backticked dotted reference like
   ``repro_torch.launch.campaign.run_campaign`` must resolve to a module or
   a module attribute;
3. every backticked path like ``src/repro_torch/kernels/csrc/kl_mutual.cu``
   must exist, written from the repository's root.  A path that exists
   only under ``src/repro_torch/`` (``models/moe.py``) is reported with the
   root-relative path it should have.

It imports nothing of the JAX package.  Exit code 0 = clean; nonzero
prints every failure.
"""
from __future__ import annotations

import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import check_docs as ref  # noqa: E402  (stdlib-only helpers)

PACKAGE = "repro_torch"
PORT = ROOT / "src" / PACKAGE
DOTTED = re.compile(r"`(%s(?:\.\w+)+)`" % PACKAGE)


def check_file(path: Path) -> list[str]:
    errors: list[str] = []
    text = path.read_text()
    rel = str(path.relative_to(ROOT))
    for lang, code in ref.FENCE.findall(text):
        if lang not in ("python", "py", ""):
            continue
        for m in ref.IMPORT.finditer(code):
            mod = m.group(1) or m.group(3)
            if mod.split(".")[0] != PACKAGE:
                continue
            names = (m.group(2) or "").split(",") if m.group(1) else [""]
            ref.check_import_line(mod, names, errors, rel)
    prose = ref.FENCE.sub("", text)
    for dotted in sorted(set(DOTTED.findall(prose))):
        ref.check_dotted(dotted, errors, rel)
    for p in sorted(set(ref.PATH_REF.findall(prose))):
        if (ROOT / p).exists():
            continue
        if (PORT / p).exists() or (PORT / "kernels" / p).exists():
            where = PORT / p if (PORT / p).exists() else PORT / "kernels" / p
            errors.append(f"{rel}: path `{p}` is relative to the package; "
                          f"write `{where.relative_to(ROOT)}`")
        else:
            errors.append(f"{rel}: referenced path `{p}` does not exist")
    return errors


def main() -> int:
    targets = ([ROOT / "README.md"] + sorted((ROOT / "docs").glob("*.md"))
               + [ROOT / "PERF.md"])
    errors: list[str] = []
    for t in targets:
        if t.exists():
            errors.extend(check_file(t))
    if errors:
        print(f"check_docs_torch: {len(errors)} problem(s)")
        for e in errors:
            print(f"  - {e}")
        return 1
    print(f"check_docs_torch: OK ({len(targets)} files, all references "
          f"resolve)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
