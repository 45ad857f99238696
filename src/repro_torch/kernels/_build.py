"""Build the port's CUDA sources with ``nvcc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own into ``build/repro_torch/<name>-<hash>.so`` at the repository root
(git-ignored), at first use. The hash covers the source, every shared
header ``csrc/*.cuh`` and the flags, so an edited source or header builds
afresh. ``build(names)`` starts one ``nvcc`` per
source and waits for all of them, so a cold start pays for the slowest
source, not the sum.

A failed or impossible build raises; nothing is caught and nothing falls
back to the plain versions.

``build.compiles`` counts the sources compiled and ``load.opens`` the
libraries opened, so a guard can assert that steady-state serving builds
and loads nothing (``repro_torch.analysis.sync_guard``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("fused_amm", "flash_decode", "assign", "lut_gemm",
           "flash_decode_kvq", "flash_decode_hd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``. Raises when there is none."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built on this machine")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built: the name carries a hash of the
    source, of every header in ``csrc/`` (a source may include any of
    them) and of the flags."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source not built yet, all ``nvcc`` processes at
    once. Returns each name's compiler output (``-Xptxas=-v`` register and
    shared-memory report; empty when it was already built). Raises with
    the compiler's output when a build fails."""
    todo = {n: library_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    if not todo:
        return {}
    exe = nvcc()
    bump(build, "compiles", len(todo))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


build.compiles = 0


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it first if
    needed (one thread at a time: the rank threads of a tensor-parallel
    engine may ask for it together)."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                build([name])
                lib = ctypes.CDLL(str(library_path(name)))
                bump(load, "opens")
                _LIBS[name] = lib
    return lib


load.opens = 0


_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def bump(fn, attr: str = "launches", n: int = 1) -> None:
    """Add ``n`` to the counter ``fn.<attr>`` under one lock. The kernel
    wrappers and the plain versions count their calls this way: the rank
    threads of a tensor-parallel engine (``parallel/collectives.py``)
    launch at the same time, and ``+=`` on an attribute is not atomic."""
    with _COUNT_LOCK:
        setattr(fn, attr, getattr(fn, attr) + n)
