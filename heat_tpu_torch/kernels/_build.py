"""Build and load the port's CUDA C++ kernels.

Each ``heat_tpu_torch/csrc/<name>.cu`` is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface and loaded with
``ctypes``. The library goes into ``build/heat_tpu_torch/`` at the root of
the checkout, named by a hash of the source, the ``csrc/*.cuh`` headers it
includes (followed through their own includes) and the flags, so a changed
source or header is rebuilt and an unchanged one is loaded as it is. Nothing is built
when a module is imported: the first wrapper call (or ``build_all``) builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["build_all", "build_dir", "load", "sources"]

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def build_dir() -> Path:
    """``build/heat_tpu_torch/`` beside the package (listed in .gitignore)."""
    return _PKG.parent / "build" / "heat_tpu_torch"


def sources() -> list:
    """Names of the kernel sources in ``csrc/``."""
    return sorted(p.stem for p in _CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built from csrc/ at first "
            "use and need the CUDA toolkit (nvcc on PATH or /usr/local/cuda/bin)"
        )
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _headers(src: bytes) -> list:
    """The ``csrc/`` headers that ``src`` includes with quotes, directly or
    through another header, each once, in the order first met."""
    seen, todo = [], [src]
    while todo:
        for inc in _INCLUDE.findall(todo.pop()):
            name = inc.decode()
            if name not in seen and (_CSRC / name).is_file():
                seen.append(name)
                todo.append((_CSRC / name).read_bytes())
    return seen


def _library_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    blob = src + b"".join((_CSRC / h).read_bytes() for h in _headers(src))
    digest = hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns the
    (process, target, temporary output) triple or None."""
    target = _library_path(name)
    if target.exists():
        return None
    nvcc = _nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    with open(target.with_suffix(".log"), "w") as log:
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")],
            stdout=log,
            stderr=subprocess.STDOUT,
        )
    return proc, target, tmp


def _finish(name: str, job) -> str:
    """Wait for one nvcc; returns its failure report, or '' on success."""
    proc, target, tmp = job
    rc = proc.wait()
    if rc != 0:
        log = target.with_suffix(".log").read_text()
        return f"nvcc failed for csrc/{name}.cu (exit {rc}):\n{log[-4000:]}"
    os.replace(tmp, target)
    return ""


def build_all(names: Iterable[str] = None) -> Dict[str, float]:
    """Compile every source that has no current library, one ``nvcc`` per
    source, all started together; waits for all of them before raising.
    Returns, for each source compiled, the seconds from the common start
    until its library was seen ready (waited for in name order)."""
    names = list(names) if names is not None else sources()
    ready, failures = {}, []
    with _lock:
        t0 = time.perf_counter()
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            if job is not None:
                failures.append(_finish(n, job))
                ready[n] = time.perf_counter() - t0
    failures = [f for f in failures if f]
    if failures:
        raise RuntimeError("\n".join(failures))
    return ready


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(_library_path(name)))
        return _loaded[name]
