"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each kernel family ``name`` keeps its sources in ``kernels/<name>/csrc/``
and becomes one shared library with a plain C interface,
``build/kernels/lib<name>-<hash>.so`` under the checkout, where the hash
covers the sources and the compiler flags.  A library is built once, at
its first use in a process (or not at all when a matching one exists),
and never when a module is imported.  No binary is committed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")        # register / spill report, in the log

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    return shutil.which("nvcc") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def _sources(name: str) -> list[Path]:
    srcs = sorted((KERNELS_DIR / name / "csrc").glob("*.cu"))
    if not srcs:
        raise FileNotFoundError(f"no CUDA sources for kernel family {name!r}")
    return srcs


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """What nvcc printed for ``name``'s library (ptxas' register report)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names) -> None:
    """Compile every family in ``names`` whose library is missing: one
    ``nvcc`` for each, all started together.  Raises if any fails."""
    jobs = []
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        log = so.with_suffix(".log")
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 *map(str, _sources(name))],
                stdout=fh, stderr=subprocess.STDOUT)
        jobs.append((name, proc, tmp, so, log))
    failed = []
    for name, proc, tmp, so, log in jobs:
        if proc.wait() != 0:
            failed.append(f"nvcc failed for {name!r} (exit {proc.returncode}):"
                          f"\n{log.read_text()}")
        else:
            os.replace(tmp, so)       # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel family ``name``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib
