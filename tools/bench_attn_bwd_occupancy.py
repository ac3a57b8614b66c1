#!/usr/bin/env python3
"""Kernel #2 (``ccmh_torch/csrc/attention_bwd.cu``) as committed against
the same source at another occupancy, in one process on one card.

    python3 tools/bench_attn_bwd_occupancy.py

The committed kernel asks for 3 blocks an SM (``__launch_bounds__(256,
3)``: 80 registers a thread, a few spilled).  The other build drops the
minimum (``__launch_bounds__(256)``), which leaves 2 blocks an SM at 128
registers.  Both are built with ``nvcc`` from the checkout's source (the
second by substituting that one line), checked against the plain version
and timed by CUDA events over 20 calls at the training path's shapes
(vision B=256 L=50 H=12 and text B=256 L=32 H=8 causal, fp32 and bf16), in
the order committed, other, other, committed.  One JSON line per case.
Exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

COMMITTED = "__global__ void __launch_bounds__(kWarps * 32, 3)"
OTHER = "__global__ void __launch_bounds__(kWarps * 32)"


def _build(src: str, workdir: str, name: str):
    from ccmh_torch.ops import build

    d = os.path.join(workdir, name)
    os.makedirs(d)
    with open(os.path.join(d, "k.cu"), "w") as fh:
        fh.write(src)
    shutil.copy(os.path.join(build.CSRC_DIR, "common.cuh"), d)
    lib = os.path.join(d, "lib.so")
    out = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib, os.path.join(d, "k.cu")],
                         capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{out.stdout}{out.stderr}")
    report = [ln.strip() for ln in (out.stdout + out.stderr).splitlines()
              if "registers" in ln or "spill" in ln][:2]
    fn = ctypes.CDLL(lib).ccmh_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return fn, report


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_attn_bwd_occupancy: needs a CUDA card", file=sys.stderr)
        return 2
    from ccmh_torch.clip.model import causal_mask
    from ccmh_torch.ops import attention as attn
    from ccmh_torch.ops import build

    with open(os.path.join(build.CSRC_DIR, "attention_bwd.cu")) as fh:
        src = fh.read()
    if COMMITTED not in src:
        raise SystemExit(f"the source no longer holds {COMMITTED!r}")
    with tempfile.TemporaryDirectory() as work:
        fns = {}
        for name, text in (("committed", src), ("two_blocks", src.replace(COMMITTED, OTHER))):
            fns[name], report = _build(text, work, name)
            print(json.dumps({"build": name, "ptxas": report}), flush=True)
        dev = torch.device("cuda")
        for case, L, H, causal in (("vision", 50, 12, False), ("text", 32, 8, True)):
            for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
                B, D, Dh = 256, H * 64, 64
                gen = torch.Generator(device=dev).manual_seed(L)
                qkv = torch.randn((B, L, 3 * D), generator=gen, device=dev).to(dtype)
                b = (0.1 * torch.randn((3 * D,), generator=gen, device=dev)).to(dtype)
                g = torch.randn((B, L, D), generator=gen, device=dev).to(dtype)
                mask = causal_mask(L, device=dev) if causal else None
                want = attn.attention_backward_reference(qkv, mask, b, g, H).float()
                out = torch.empty_like(qkv)
                row = {"case": f"{case} {str(dtype).split('.')[-1]}", "B": B, "L": L, "H": H}
                for name in ("committed", "two_blocks", "two_blocks", "committed"):
                    fn = fns[name]

                    def call():
                        err = fn(dev.index or 0, qkv.data_ptr(), b.data_ptr(),
                                 None if mask is None else mask.data_ptr(), g.data_ptr(),
                                 out.data_ptr(), B, L, H, Dh, 1.0 / math.sqrt(Dh), code,
                                 torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"{name}: CUDA error {err}")

                    call()
                    torch.cuda.synchronize()
                    row[f"{name}_max_abs_err"] = (out.float() - want).abs().max().item()
                    for _ in range(3):
                        call()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(20):
                        call()
                    end.record()
                    torch.cuda.synchronize()
                    row.setdefault(f"{name}_ms", []).append(start.elapsed_time(end) / 20)
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
