"""Build the port's CUDA kernels and load them through ctypes.

Each ``ccmh_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface (no PyTorch headers,
so a build takes seconds).  Builds happen at first use, from the sources
in the package only, into ``build/ccmh_torch_kernels/`` beside the package;
each library's file name carries a hash of its source, the shared headers
and the flags, so an edited source rebuilds and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "ccmh_torch_kernels")

KERNELS = ("attention", "attention_bwd", "hamming", "layernorm", "attention_savedp",
           "attention_fwd_stacked", "attention_merged", "attention_bwd_x")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the CUDA "
                       "kernels of ccmh_torch are built on first use")


def library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` lives for the current
    sources (the name carries their hash)."""
    h = hashlib.sha256()
    for path in [os.path.join(CSRC_DIR, f"{name}.cu")] + sorted(
            glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + b"\0" + fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _start(name: str, nvcc: str) -> Tuple[subprocess.Popen, str, str]:
    out = library_path(name)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Build every missing library, one ``nvcc`` process per source, all
    running together; returns name -> library path.  The compiler's
    report (``-Xptxas -v``: registers, shared memory, spills) is kept
    beside each library as ``<lib>.log``."""
    names = list(names)
    todo = [n for n in names if not os.path.exists(library_path(n))]
    if todo:
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        jobs: List[Tuple[str, subprocess.Popen, str, str]] = []
        try:
            for n in todo:
                jobs.append((n, *_start(n, nvcc)))
            failures = []
            for n, proc, tmp, out in jobs:
                log, _ = proc.communicate()
                with open(out + ".log", "w") as fh:
                    fh.write(log)
                if proc.returncode != 0:
                    failures.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
                else:
                    os.replace(tmp, out)   # atomic: readers never see a partial .so
        finally:
            for _, proc, tmp, _ in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if os.path.exists(tmp):
                    os.remove(tmp)
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return {n: library_path(n) for n in names}


def build_log(name: str) -> Optional[str]:
    path = library_path(name) + ".log"
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        return fh.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all([name])[name])
            _LIBS[name] = lib
        return lib


def raise_on_error(lib: ctypes.CDLL, entry: str, err: int) -> None:
    """Raise if a C entry returned a CUDA error (its cudaGetLastError()
    right after the launch: a refused launch never runs, and a later
    synchronize would not report it)."""
    if err != 0:
        fn = lib.ccmh_cuda_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{entry}: CUDA error {err} "
                           f"({fn(err).decode(errors='replace')})")
