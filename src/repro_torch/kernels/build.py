"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together), then linked into one shared library with a
plain C interface that ``ctypes`` loads.  The library goes into
``build/repro_torch/<hash>/`` at the repository root when the package runs
from a checkout's ``src/`` tree, else (an installed copy) into
``repro_torch/<hash>/`` under ``$XDG_CACHE_HOME`` or ``~/.cache``.  It is
keyed by a hash of the sources and flags, so a fresh checkout builds once at
first use and an edit to any source rebuilds.  A failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"


def _build_root(package: Path = Path(__file__).resolve().parents[1]) -> Path:
    """Where the library of the ``repro_torch`` package at ``package`` is
    built."""
    if package.parent.name == "src":
        return package.parent.parent / "build" / "repro_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "repro_torch"


BUILD_ROOT = _build_root()
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_fns: Dict[str, ctypes._CFuncPtr] = {}
# seconds the last build() spent compiling (0.0 when the cached library was
# reused) and the compiler's resource report (-Xptxas -v), per source
last_build_seconds: Optional[float] = None
last_build_log: Dict[str, str] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels can only be built on a machine with the CUDA "
                       "toolkit")


def sources() -> Sequence[Path]:
    return sorted(CSRC.glob("*.cu"))


def digest() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (or reuse) the shared library and return its path."""
    global last_build_seconds
    out = BUILD_ROOT / digest() / LIB_NAME
    if out.is_file():
        last_build_seconds = 0.0
        return out
    compiler = nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [compiler, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, _, proc in procs:
            log, _ = proc.communicate()
            last_build_log[src.name] = log
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [compiler, "-shared", "-o", str(tmp_lib),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        # atomic publish: a concurrent builder either sees the finished
        # library or builds its own copy
        os.replace(tmp_lib, out)
    last_build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
            _lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            _lib.repro_cuda_error_string.restype = ctypes.c_char_p
        return _lib


def function(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry ``name`` with its argument types declared (pointers and
    the stream as ``c_void_p``, so ctypes never truncates them to 32 bits);
    every entry returns the ``cudaError_t`` of its launches."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
