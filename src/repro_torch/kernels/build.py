"""Build and load the CUDA kernels of ``csrc/`` for Hopper (``sm_90a``).

Each ``.cu`` source has a plain C interface and is compiled by ``nvcc``
into a shared library of its own, loaded with ``ctypes`` -- no PyTorch
headers, so a build takes seconds.  Builds happen at first use (never
at import), all sources in parallel, into ``_build/`` beside this file;
a library's name carries a hash of its sources and flags, so an edited
source is rebuilt and an unchanged one is reused.  A failed build
raises with the compiler's output.

    python -m repro_torch.kernels.build     # build all, print ptxas info
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

#: library name -> its translation unit; headers are shared by all
SOURCES = {
    "paged_attention": "paged_attention.cu",
    "paged_append": "paged_append.cu",
    "paged_prefill": "paged_prefill.cu",
    "block_copy": "block_copy.cu",
    "tree_gather": "tree_gather.cu",
    "adamw": "adamw.cu",
}
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelCompileError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelCompileError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels are built on a machine with the "
            "CUDA toolkit")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / SOURCES[name]]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_all(names: List[str] = None) -> Dict[str, str]:
    """Compile every (or the named) source that has no up-to-date
    library yet, one ``nvcc`` per source, all started together.
    Returns ``{name: ptxas report}`` for the sources compiled now."""
    names = list(SOURCES) if names is None else names
    todo = [n for n in names if not lib_path(n).is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = lib_path(n).with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    reports, failed = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {SOURCES[n]} (exit {proc.returncode})\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, lib_path(n))
        reports[n] = out
    if failed:
        raise KernelCompileError("nvcc failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
        return lib


if __name__ == "__main__":
    for n, rep in build_all().items():
        print(f"== {n}\n{rep}")
    for n in SOURCES:
        print(n, lib_path(n))
