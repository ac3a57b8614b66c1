"""ctypes binding of the port's native batch image loader (``loader.cpp``).

The library is built with ``g++`` at first use into the git-ignored
``build/ccmh_torch_host/`` (``utils/host_build.py``), with ``ccmh``'s
flags (``-O3 -march=native -std=c++17 -pthread``).  Its decoder is chosen
when it is built, never at run time:

1. ``"libjpeg"``: ``jpeglib.h`` and ``libjpeg`` are present.  The library
   is then the exact counterpart of ``ccmh``'s native loader.
2. ``"nvjpeg"``: no libjpeg, but the CUDA toolkit's ``nvjpeg.h`` and
   ``libnvjpeg``.  Only the decode and encode stages run on the card: it
   decodes to planar Y, Cb, Cr, copied back to the host, where libjpeg's
   chroma upsampling and colour conversion run (nvJPEG's own RGB output
   upsamples by replication, far from PIL), then the same resize, crop
   and normalization.  Only the IDCT then differs from PIL's decode.
3. Neither: the build raises and names what it looked for.

Every entry takes a batch, releases the GIL (ctypes) and fans out over
C++ threads.  Each returns ``(images, ok)``; ``ok[i]`` is False for an
item the loader could not decode (PNG, WebP, a corrupt file).  ``ccmh``
sends those to PIL; the port has no PIL, and its callers raise.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ccmh_torch.utils import host_build

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "loader.cpp")
FLAGS = ("-O3", "-march=native", "-std=c++17", "-pthread")    # ccmh's flags
JPEG_QUALITY = 92     # ccmh's synthetic writer: Image.save(p, quality=92)
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)


def _cuda_home() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return os.path.dirname(os.path.dirname(os.path.realpath(nvcc)))
    return os.environ.get("CUDA_HOME") or "/usr/local/cuda"


def _has_libjpeg() -> bool:
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    probe = subprocess.run([gxx, "-x", "c++", "-", "-o", os.devnull, "-ljpeg"],
                           input="#include <cstdio>\n#include <jpeglib.h>\n"
                                 "int main() { jpeg_std_error(nullptr); return 0; }\n",
                           capture_output=True, text=True, timeout=120)
    return probe.returncode == 0


def build_flags() -> Tuple[str, Tuple[str, ...]]:
    """(decoder, g++ flags) of this machine's build, by the rule above."""
    if _has_libjpeg():
        return "libjpeg", FLAGS + ("-ljpeg",)
    home = _cuda_home()
    inc, lib = os.path.join(home, "include"), os.path.join(home, "lib64")
    if (os.path.exists(os.path.join(inc, "nvjpeg.h"))
            and os.path.exists(os.path.join(lib, "libnvjpeg.so"))):
        return "nvjpeg", FLAGS + (
            "-DCCMH_NVJPEG", f"-I{inc}", f"-L{lib}", f"-Wl,-rpath,{lib}",
            "-lnvjpeg", "-lcudart_static", "-ldl", "-lrt")
    raise RuntimeError(
        "no JPEG decoder to build the ccmh_torch image loader with: looked for "
        "libjpeg (jpeglib.h and -ljpeg through g++) and for nvJPEG "
        f"({os.path.join(inc, 'nvjpeg.h')}, {os.path.join(lib, 'libnvjpeg.so')})")


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            decoder, flags = build_flags()
            lib = ctypes.CDLL(host_build.build(SRC, f"loader_{decoder}", flags))
            lib.ccmh_decoder_name.restype = ctypes.c_char_p
            lib.ccmh_decoder_name.argtypes = []
            lib.ccmh_loader_set_device.restype = None
            lib.ccmh_loader_set_device.argtypes = [ctypes.c_int]
            lib.ccmh_batch_load.restype = ctypes.c_int
            lib.ccmh_batch_load.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, _f32p, _u8p, ctypes.c_int]
            lib.ccmh_batch_load_u8.restype = ctypes.c_int
            lib.ccmh_batch_load_u8.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, _u8p, _u8p, ctypes.c_int]
            lib.ccmh_batch_load_mem.restype = ctypes.c_int
            lib.ccmh_batch_load_mem.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, _f32p, _u8p, ctypes.c_int]
            lib.ccmh_resize_u8.restype = ctypes.c_int
            lib.ccmh_resize_u8.argtypes = [_u8p, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int, _u8p]
            lib.ccmh_encode_jpeg_batch.restype = ctypes.c_int
            lib.ccmh_encode_jpeg_batch.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64), _u8p, ctypes.c_int]
            if decoder == "nvjpeg":
                import torch

                lib.ccmh_loader_set_device(
                    torch.cuda.current_device() if torch.cuda.is_available() else 0)
            _LIB = lib
        return _LIB


def decoder() -> str:
    """``"libjpeg"`` or ``"nvjpeg"``: the decoder the library was built with."""
    return _lib().ccmh_decoder_name().decode()


def _threads(n: int, n_threads: int) -> int:
    return max(1, n_threads if n_threads > 0 else min(n, os.cpu_count() or 8))


def _c_paths(paths: Sequence[str]):
    return (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])


def decode_batch(paths: Sequence[str], resolution: int, is_train: bool,
                 n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """JPEG paths -> ([N, R, R, 3] float32 CLIP-normalized NHWC, ok)."""
    lib, n = _lib(), len(paths)
    out = np.empty((n, resolution, resolution, 3), np.float32)
    ok = np.zeros(n, np.uint8)
    if n:
        lib.ccmh_batch_load(_c_paths(paths), n, resolution, int(is_train),
                            out.ctypes.data_as(_f32p), ok.ctypes.data_as(_u8p),
                            _threads(n, n_threads))
    return out, ok.astype(bool)


def decode_batch_u8(paths: Sequence[str], resolution: int, is_train: bool,
                    n_threads: int = 0, out: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """JPEG paths -> ([N, R, R, 3] uint8 after the resize, before the
    normalization, ok).  ``out`` may be the caller's C-contiguous uint8
    array (a memmap slice of the decoded-image cache) to decode into."""
    lib, n = _lib(), len(paths)
    if out is None:
        out = np.empty((n, resolution, resolution, 3), np.uint8)
    if (out.dtype != np.uint8 or not out.flags.c_contiguous
            or out.shape != (n, resolution, resolution, 3)):
        raise ValueError(f"out must be C-contiguous uint8 {(n, resolution, resolution, 3)}, "
                         f"got {out.dtype} {out.shape}")
    ok = np.zeros(n, np.uint8)
    if n:
        lib.ccmh_batch_load_u8(_c_paths(paths), n, resolution, int(is_train),
                               out.ctypes.data_as(_u8p), ok.ctypes.data_as(_u8p),
                               _threads(n, n_threads))
    return out, ok.astype(bool)


def decode_batch_mem(blobs: Sequence[bytes], resolution: int, is_train: bool = False,
                     n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """In-memory JPEG files -> ([N, R, R, 3] float32 CLIP-normalized, ok):
    the serving path's twin of :func:`decode_batch`."""
    lib, n = _lib(), len(blobs)
    out = np.empty((n, resolution, resolution, 3), np.float32)
    ok = np.zeros(n, np.uint8)
    if n:
        # c_char_p would stop at the first NUL byte: pass the buffers' addresses
        bufs = [np.frombuffer(b, np.uint8) if len(b) else None for b in blobs]
        c_ptrs = (ctypes.c_void_p * n)(*[b.ctypes.data if b is not None else None
                                         for b in bufs])
        c_lens = (ctypes.c_int64 * n)(*[len(b) for b in blobs])
        lib.ccmh_batch_load_mem(c_ptrs, c_lens, n, resolution, int(is_train),
                                out.ctypes.data_as(_f32p), ok.ctypes.data_as(_u8p),
                                _threads(n, n_threads))
    return out, ok.astype(bool)


def resize_u8(image: np.ndarray, resolution: int, is_train: bool) -> np.ndarray:
    """uint8 [H, W, 3] (or [H, W], replicated to RGB) -> [R, R, 3] uint8 by
    the loader's transform: ``ccmh``'s ``_transform_u8(_to_pil(image))``."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or (
            image.ndim == 3 and image.shape[2] != 3):
        raise ValueError(f"expected a uint8 [H, W, 3] or [H, W] image, got "
                         f"{image.dtype} {image.shape}")
    if image.ndim == 2:
        image = np.repeat(image[:, :, None], 3, axis=2)
    image = np.ascontiguousarray(image)
    out = np.empty((resolution, resolution, 3), np.uint8)
    h, w = image.shape[:2]
    if not _lib().ccmh_resize_u8(image.ctypes.data_as(_u8p), w, h, resolution,
                                 int(is_train), out.ctypes.data_as(_u8p)):
        raise ValueError(f"cannot resize a {image.shape} image")
    return out


def encode_jpeg(images: Sequence[np.ndarray], n_threads: int = 0) -> List[bytes]:
    """uint8 [H, W, 3] images -> baseline 4:2:0 JPEG files at quality 92
    (PIL's ``Image.save(path, quality=92)``, ``ccmh``'s synthetic writer)."""
    lib = _lib()
    imgs = [np.ascontiguousarray(a) for a in images]
    for i, a in enumerate(imgs):
        if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
            raise ValueError(f"image {i}: expected uint8 [H, W, 3], got {a.dtype} {a.shape}")
    n = len(imgs)
    if n == 0:
        return []
    caps = [a.size + 65536 for a in imgs]
    while True:
        outs = [np.empty(c, np.uint8) for c in caps]
        lens = (ctypes.c_int64 * n)()
        ok = np.zeros(n, np.uint8)
        lib.ccmh_encode_jpeg_batch(
            (ctypes.c_void_p * n)(*[a.ctypes.data for a in imgs]),
            (ctypes.c_int * n)(*[a.shape[1] for a in imgs]),
            (ctypes.c_int * n)(*[a.shape[0] for a in imgs]), n, JPEG_QUALITY,
            (ctypes.c_void_p * n)(*[o.ctypes.data for o in outs]),
            (ctypes.c_int64 * n)(*caps), lens, ok.ctypes.data_as(_u8p),
            _threads(n, n_threads))
        short = [i for i in range(n) if lens[i] < 0]
        if not short:
            break
        for i in short:
            caps[i] = -lens[i]
    bad = [i for i in range(n) if not ok[i]]
    if bad:
        raise RuntimeError(f"JPEG encoding failed for image {bad[0]} ({decoder()})")
    return [outs[i][:lens[i]].tobytes() for i in range(n)]
