"""Build the port's host C++ libraries with ``g++`` and load them.

The native BPE tokenizer (``tokenizer/native/bpe.cpp``) and the image
loader (``data/native/loader.cpp``) are compiled at first use, from the
sources in the package only, into ``build/ccmh_torch_host/`` beside the
package (git-ignored; never next to the source).  A library's file name
carries a hash of its source and its compile and link flags, so an
edited source or another decoder builds anew and an unchanged one is
reused.  Each builder writes a temporary file of its own and renames it
into place, so processes that build at once (pytest-xdist workers) never
load a partial library.  A failed build raises with the compiler's output.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from typing import Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "ccmh_torch_host")


def library_path(src: str, name: str, flags: Sequence[str]) -> str:
    h = hashlib.sha256()
    with open(src, "rb") as fh:
        h.update(fh.read())
    h.update("\0".join(flags).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(src: str, name: str, flags: Sequence[str]) -> str:
    """Path of the library of ``src`` built with ``flags`` (compile and
    link flags, libraries last), built first if missing."""
    out = library_path(src, name, flags)
    if os.path.exists(out):
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH; {os.path.basename(src)} of "
                           "ccmh_torch is built at first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [gxx, "-shared", "-fPIC", src, "-o", tmp, *flags]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {src} (exit {proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out
