#!/usr/bin/env python3
"""Time the packed Hamming kernel #3 at its C entry, for this checkout and,
in turns, for another, beside the plain version and the one PyTorch call
that computes the same distances.

    python3 -m ccmh_torch.tools.time_hamming [--root DIR] [--ks 64,128,256,512,1024,2048]
                                             [--queries 512] [--gallery 262144] [--ragged]
                                             [--rate]

``--root`` names another checkout (unpack it under the git-ignored
``build/``: ``git archive <commit> | tar -x -C build/old``).  Its
``ccmh_torch/csrc/hamming.cu`` is compiled here with this checkout's
``nvcc`` flags into ``build/time_hamming/`` and called through its
``ccmh_hamming_packed`` entry (the same arguments in every version, and
this checkout's is timed through it too), so both run in one process on
one card, in turns at each K.

For each K (bits; W = K / 32 lanes) on seeded random lanes, Q queries
against N gallery rows (``--ragged`` adds Q = 500, N = 2^18 + 37, W = 17):

- ``ms``: this checkout's C entry by its fixed rule, the family it
  reports beside it; ``family_ms``: every family that takes these lanes,
  forced through ``ccmh_hamming_packed_as`` (which refuses ``tma`` for
  rows that are not of 16-byte multiples), which is how the cut-over in
  ``csrc/hamming_family.cuh`` was chosen;
  ``other_ms``: the other checkout's entry.  Each is a list of two times,
  taken in turns: every call in one order, then in the reverse order;
- ``plain_ms``: ``hamming_distance_packed_reference``;
- ``library_ms``: ``hamming_distance`` on the same codes unpacked to ±1
  int8 (the fp16 cuBLAS product, the casts and the shift);
- ``bound_ms``: the larger of the bytes (operands read once, the int32
  output written once, over 3.35 TB/s) and 2 Q N K' one-bit operations (K'
  = K rounded up to the 256-bit k-step) at the tensor cores' one-bit rate
  (``PEAK_OPS_PER_S["b1"]``), with ``bound_by``; ``popc_floor_ms``: Q N W
  popcounts at the SIMT ``__popc`` rate (16 a clock on each of 132 SMs at
  1.98 GHz), the least time of any XOR + ``__popc`` kernel, for the record.

``--rate`` adds one line: the one-bit AND-popcount product's rate alone
(``tools/hamming_rate.cu``, compiled here: m64n128k256 products back to
back on every SM, no loads, no stores), in one-bit operations a second.

Every result is checked bit for bit against the plain version.  A
kernel's time is the min over 3 of (t_n2 - t_n1) / (n2 - n1) chained
calls from CUDA events, the output preallocated (the operands stay in L2
between calls where they fit: warm); ``plain_ms`` and ``library_ms`` are
the mean of 3 calls after one.  One JSON line per K; the card's name and power
limit first.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import os
import subprocess
import sys

import torch

from ccmh_torch.ops import build
from ccmh_torch.ops import hamming as ham
from ccmh_torch.ops.packing import unpack_codes
# the card's rates: b1 is 8x int8, which `--rate` measured at 1.582e16 on
# an H100 80GB HBM3 at 700 W, 8.0x
from ccmh_torch.tools.floors import HBM_BYTES_PER_S, PEAK_OPS_PER_S

KSTEP_BITS = 256                         # one k-step of the tensor cores' one-bit product
LOOPS = (10, 60)
REPEATS = 3
RAGGED = (500, 2 ** 18 + 37, 17)         # Q, N, W


def bound(Q: int, N: int, W: int):
    """(bound ms, what bounds it, SIMT popcount floor ms) for Q x N
    distances of W-lane codes."""
    t_bytes = (Q * W + N * W + Q * N) * 4 / HBM_BYTES_PER_S
    k_padded = -(-32 * W // KSTEP_BITS) * KSTEP_BITS
    t_ops = 2.0 * Q * N * k_padded / PEAK_OPS_PER_S["b1"]
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            1e3 * Q * N * W / PEAK_OPS_PER_S["popc"])


def steady_ms(call) -> float:
    """Min over REPEATS of (t_n2 - t_n1) / (n2 - n1) chained calls."""
    def run(n):
        for _ in range(n):
            call()
    run(2)
    best = math.inf
    for _ in range(REPEATS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        run(LOOPS[0])
        ev[1].record()
        ev[2].record()
        run(LOOPS[1])
        ev[3].record()
        torch.cuda.synchronize()
        t = ev[2].elapsed_time(ev[3]) - ev[0].elapsed_time(ev[1])
        best = min(best, t / (LOOPS[1] - LOOPS[0]))
    return best


REFUSED = 801            # cudaErrorNotSupported: the forced family cannot take these lanes


def entry_call(fn, q, r, out, *extra):
    """A launch of a C entry into ``out`` that returns its CUDA error:
    ``fn`` is ``ccmh_hamming_packed`` or ``ccmh_hamming_packed_as``, whose
    family and where to write the family it launched are ``extra``."""
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.device.index, q.data_ptr(), r.data_ptr(), out.data_ptr(), q.shape[0],
            r.shape[0], q.shape[1], *extra, stream)
    return lambda: fn(*args)


def raising(call):
    """``call``, raising on a CUDA error."""
    def run():
        err = call()
        if err:
            raise RuntimeError(f"hamming entry: CUDA error {err}")
    return run


def compile_lib(src: str, include: str, tag: str) -> str:
    """``src`` compiled with this checkout's ``nvcc`` flags and ``-I
    include`` into ``build/time_hamming/``, once for each content of the
    source and of the headers in ``include``: the library's path."""
    h = hashlib.sha256()
    headers = sorted(p for p in os.listdir(include) if p.endswith(".cuh"))
    for path in [src] + [os.path.join(include, p) for p in headers]:
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + b"\0" + fh.read())
    out_dir = os.path.join(os.path.dirname(build.BUILD_DIR), "time_hamming")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, f"lib{tag}_{h.hexdigest()[:16]}.so")
    if not os.path.exists(lib_path):
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", include, "-o", lib_path, src],
                       check=True, capture_output=True)
    return lib_path


def lanes(rows: int, W: int, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(-2 ** 31, 2 ** 31, (rows, W), generator=gen, device="cuda",
                         dtype=torch.int32)


def other_entry(root: str):
    """The ``ccmh_hamming_packed`` entry of another checkout's source,
    compiled with this checkout's flags."""
    csrc = os.path.join(os.path.abspath(root), "ccmh_torch", "csrc")
    fn = ctypes.CDLL(compile_lib(os.path.join(csrc, "hamming.cu"), csrc, "hamming")
                     ).ccmh_hamming_packed
    fn.restype = ctypes.c_int
    fn.argtypes = ham._ENTRY_ARGS + [ctypes.c_void_p]
    return fn


def measure(q, r, other=None) -> dict:
    """Every time of the module's list for int32 lanes q [Q, W] and r [N, W]
    on the card; ``other`` the other checkout's entry (``other_entry``)."""
    (Q, W), N = q.shape, r.shape[0]
    out = torch.empty((Q, N), dtype=torch.int32, device="cuda")
    want = ham.hamming_distance_packed_reference(q, r)
    _, auto = ham._entry("ccmh_hamming_packed")
    _, forced = ham._entry()
    took = ctypes.c_int(-1)
    rule = entry_call(forced, q, r, out, -1, ctypes.pointer(took))
    calls = {"this": entry_call(auto, q, r, out)}
    if other is not None:
        calls["other"] = entry_call(other, q, r, out)
    calls.update({fam: entry_call(forced, q, r, out, i, None)
                  for i, fam in enumerate(ham.FAMILIES)})
    for name, call in [("rule", rule)] + list(calls.items()):
        out.fill_(-1)
        err = call()
        if name in ham.FAMILIES and err == REFUSED:
            del calls[name]
            continue
        if err:
            raise RuntimeError(f"time_hamming: {name}: CUDA error {err}")
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise SystemExit(f"time_hamming: {name} differs from the plain version at "
                             f"Q={Q} N={N} W={W}")
    names = list(calls)
    times = {}
    for name in names + names[::-1]:
        times.setdefault(name, []).append(steady_ms(raising(calls[name])))
    family_ms = {fam: times[fam] for fam in ham.FAMILIES if fam in calls}
    plain_ms = steady_ms_few(lambda: ham.hamming_distance_packed_reference(q, r))
    k = 32 * W
    q8, r8 = unpack_codes(q, k), unpack_codes(r, k)
    lib_out = ham.hamming_distance(q8, r8)
    if not torch.equal(lib_out, want):
        raise SystemExit(f"time_hamming: hamming_distance differs at Q={Q} N={N} W={W}")
    del lib_out, want
    library_ms = steady_ms_few(lambda: ham.hamming_distance(q8, r8))
    bound_ms, bound_by, popc_ms = bound(Q, N, W)
    row = {"K": k, "Q": Q, "N": N, "W": W, "family": ham.FAMILIES[took.value],
           "ms": times["this"], "family_ms": family_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "popc_floor_ms": popc_ms}
    if other is not None:
        row["other_ms"] = times["other"]
    return row


def tc_rate(blocks: int = 132 * 8, reps: int = 2000) -> dict:
    """One-bit operations a second of the tensor cores' AND-popcount
    product alone (``hamming_rate.cu``; min over REPEATS of one launch)."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hamming_rate.cu")
    fn = ctypes.CDLL(compile_lib(src, build.CSRC_DIR, "hamming_rate")).hamming_tc_rate
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = fn(out.device.index, out.data_ptr(), blocks, reps, stream)
        if err:
            raise RuntimeError(f"hamming_tc_rate: CUDA error {err}")
    ops = 2.0 * blocks * 2 * reps * 8 * 64 * 128 * 256
    best = math.inf
    call()
    for _ in range(REPEATS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return {"b1_and_popc_ops_per_s": ops / (best * 1e-3), "ms": best, "blocks": blocks,
            "reps": reps, "peak_ops_per_s": {k: PEAK_OPS_PER_S[k] for k in ("int8", "b1")}}


def steady_ms_few(fn, iters: int = 3) -> float:
    """Mean of ``iters`` calls after one (the plain versions take up to
    half a second a call)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None, help="another checkout to time in turns")
    ap.add_argument("--ks", default="64,128,256,512,1024,2048")
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--gallery", type=int, default=2 ** 18)
    ap.add_argument("--ragged", action="store_true")
    ap.add_argument("--rate", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_hamming: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"card": card.stdout.strip().splitlines()[0] if card.stdout else None,
                      "device": torch.cuda.get_device_name(0), "root": args.root}), flush=True)
    other = other_entry(args.root) if args.root else None
    shapes = [(args.queries, args.gallery, int(k) // 32) for k in args.ks.split(",")]
    if args.ragged:
        shapes.append(RAGGED)
    for Q, N, W in shapes:
        print(json.dumps(measure(lanes(Q, W, W), lanes(N, W, W + 1), other)), flush=True)
        torch.cuda.empty_cache()
    if args.rate:
        print(json.dumps(tc_rate()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
