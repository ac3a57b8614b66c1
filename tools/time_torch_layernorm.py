#!/usr/bin/env python3
"""Time the port's LayerNorm kernels #4 (LayerNorm) and #5 (residual add +
LayerNorm) beside ``F.layer_norm`` and a copy of the same bytes, at the
towers' shapes, for the ``ccmh_torch`` package of a checkout.

    python3 tools/time_torch_layernorm.py [--root DIR]

``--root`` (default: this checkout) is the directory holding the
``ccmh_torch`` to time, so two versions compare inside one call on one
card: unpack the other under ``build/`` (``git archive <commit> | tar -x
-C build/old``) and run old, new, new, old.  Shapes: vision rows 256·50 ×
768, text rows 256·32 × 512, fp32 and bf16, scale and bias in the input
type (as the towers cast them); inputs from a seed.  Every call reads a
fresh input set and writes fresh outputs, cycled over enough sets that
one cycle touches more than twice the 50 MB L2: in the towers the inputs
come from a matmul, not from a warm cache.

Each time is the min over 3 of (t_240 - t_40) / 200 chained calls from
CUDA events:

- ``ms``: the kernel at its C entry, outputs preallocated and the
  argument types set once (the kernel's own time unless launching a call
  takes the host longer than the card takes to run it);
- ``wrapper_ms``: through the Python wrapper (``ln_forward`` /
  ``add_ln_forward``: checks, allocation, launch);
- ``library_ms`` (#4): ``F.layer_norm`` with the 40 and the 240 calls each
  captured in one CUDA graph and replayed, so no host work lies between
  calls; ``add_then_layer_norm_ms`` (#5): ``x + d`` then ``F.layer_norm``
  the same way, for context (no single PyTorch call fuses the add);
- ``copy_floor_ms``: ``y.copy_(x)`` on the same bytes (#5: two copies, of
  x and d), CUDA graphs as above: the rate this card reaches at this size;
- ``plain_ms``: the plain PyTorch version;
- ``bound_ms``: bytes read once and written once over 3.35 TB/s, or fp32
  operations over 67 TFLOP/s, whichever is larger (bytes here).

One JSON line per kernel, shape and type, with the max abs error against
the plain version; then one line per case with ``entry_graph_ms``, the C
entry's calls captured in CUDA graphs as ``F.layer_norm``'s are; the
card's name and power limit first.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import itertools
import json
import math
import os
import subprocess
import sys

LOOPS = (40, 240)
REPEATS = 3
SHAPES = (("vision", 256 * 50, 768), ("text", 256 * 32, 512))
L2_BYTES = 50e6
EPS = 1e-5


def _events_ms(run) -> float:
    """Min over REPEATS of (t_240 - t_40) / 200, where ``run(n)`` issues n
    calls."""
    import torch

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


def steady_ms(fn) -> float:
    """Chained calls of ``fn``, launched one by one from the host."""
    def run(n):
        for _ in range(n):
            fn()
    run(LOOPS[0])
    return _events_ms(run)


def graph_ms(make) -> float:
    """Calls of ``make()``'s function captured in one CUDA graph per loop
    count and replayed: the card's time alone.  ``make`` is called inside
    the capture, so a call that names a stream gets the capturing one."""
    import torch

    fn = make()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graphs = {}
    for n in LOOPS:
        graphs[n] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[n]):
            fn = make()
            for _ in range(n):
                fn()
    for g in graphs.values():
        g.replay()
    return _events_ms(lambda n: graphs[n].replay())


def bound(rows: int, W: int, item: int, add: bool):
    """(bound ms, what bounds it, bytes) of one call."""
    n_bytes = ((4 if add else 2) * rows * W + 2 * W) * item
    n_ops = 8.0 * rows * W + (rows * W if add else 0)   # fp32 arithmetic per element
    return (*_floors().bound(n_bytes, n_ops, "float32"), n_bytes)


def _floors():
    """This checkout's ``ccmh_torch/tools/floors.py`` (the card's rates),
    loaded by its path: ``--root`` may name a checkout without it."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "ccmh_torch", "tools", "floors.py")
    spec = importlib.util.spec_from_file_location("_card_floors", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(rows: int, W: int, dtype, add: bool):
    """(input sets, output sets, scale, bias): each set [rows, W] in
    ``dtype``, as many as one cycle needs to exceed twice the L2."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(rows + W + add)
    item = torch.empty((), dtype=dtype).element_size()
    n_sets = max(2, math.ceil(2 * L2_BYTES / bound(rows, W, item, add)[2]) + 1)
    n = 2 if add else 1
    sets = [tuple(torch.randn((rows, W), generator=gen, device=dev).to(dtype) for _ in range(n))
            for _ in range(n_sets)]
    outs = [tuple(torch.empty((rows, W), dtype=dtype, device=dev) for _ in range(n))
            for _ in range(n_sets)]
    scale = (1.0 + 0.1 * torch.randn((W,), generator=gen, device=dev)).to(dtype)
    bias = (0.1 * torch.randn((W,), generator=gen, device=dev)).to(dtype)
    return sets, outs, scale, bias


def entry_call(ln, add: bool, sets, outs, scale, bias):
    """A zero-argument call of kernel #5 (``add``) or #4 at its C entry,
    cycling over the input sets and their preallocated outputs, on the
    stream current when it is made.  A wrapper with ``_vector_path`` passes
    the kernel its vector-path flag; an older one has no such argument."""
    import torch

    x0 = sets[0][0]
    rows, W = x0.shape
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    if hasattr(ln, "_vector_path"):
        _, fn = ln._c_entry(add)
    else:
        _, fn = ln._entry(add)
    calls = []
    for inp, out in zip(sets, outs):
        d, s = (inp[1], out[1]) if add else (None, None)
        flag = ([int(ln._vector_path(inp[0], d, out[0], s, scale, bias))]
                if hasattr(ln, "_vector_path") else [])
        ptrs = [t.data_ptr() for t in (inp[0], d, scale, bias, out[0], s) if t is not None]
        calls.append((x0.device.index, *ptrs, rows, W, ln._DTYPE_CODES[x0.dtype],
                      ln._DTYPE_CODES[scale.dtype], *flag, stream))
    cycle = itertools.cycle(calls)

    def call():
        if fn(*next(cycle)):
            raise RuntimeError(f"the {'add + ' if add else ''}LayerNorm C entry refused a launch")
    return call


def _cycling(sets, fn):
    """A zero-argument call of ``fn`` on the next input set; the last
    len(sets) results stay alive, so outputs cycle over fresh memory too."""
    cycle = itertools.cycle(sets)
    ring = collections.deque(maxlen=len(sets))
    return lambda: ring.append(fn(*next(cycle)))


def measure(ln, name: str, rows: int, W: int, dtype, add: bool) -> dict:
    """Kernel #4 (``add`` False) or #5 of the module ``ln`` at one shape
    and type: its error against the plain version and every time above."""
    import torch
    import torch.nn.functional as F

    sets, outs, scale, bias = inputs(rows, W, dtype, add)
    tname = "float32" if dtype == torch.float32 else "bfloat16"
    with torch.inference_mode():
        if add:
            (y, s), (want, want_s) = (ln.add_ln_forward(*sets[0], scale, bias),
                                      ln.add_layer_norm_reference(*sets[0], scale, bias))
        else:
            y, want = ln.ln_forward(sets[0][0], scale, bias), ln.layer_norm_reference(
                sets[0][0], scale, bias)
        torch.cuda.synchronize()
        err = (y.float() - want.float()).abs().max().item()
        case = {"kernel": "fused_add_layer_norm" if add else "fused_layer_norm",
                "case": f"{name} {tname}", "shape": [rows, W], "max_abs_err": err}
        if add:
            case["s_equal"] = bool(torch.equal(s, want_s))
        del y, want
        kernel = ln.add_ln_forward if add else ln.ln_forward
        plain = ln.add_layer_norm_reference if add else ln.layer_norm_reference
        if add:
            library = lambda x, d: F.layer_norm(x + d, (W,), scale, bias, EPS)  # noqa: E731
        else:
            library = lambda x: F.layer_norm(x, (W,), scale, bias, EPS)         # noqa: E731
        pairs = list(zip(sets, outs))

        def copies():
            cycle = itertools.cycle(pairs)

            def call():
                inp, out = next(cycle)
                for src, dst in zip(inp, out):
                    dst.copy_(src)
            return call

        case["ms"] = steady_ms(entry_call(ln, add, sets, outs, scale, bias))
        case["wrapper_ms"] = steady_ms(_cycling(sets, lambda *a: kernel(*a, scale, bias)))
        case["plain_ms"] = steady_ms(_cycling(sets, lambda *a: plain(*a, scale, bias)))
        lib_ms = graph_ms(lambda: _cycling(sets, library))
        case["library_ms"] = None if add else lib_ms
        if add:
            case["add_then_layer_norm_ms"] = lib_ms
        case["copy_floor_ms"] = graph_ms(copies)
    case["bound_ms"], case["bound_by"], _ = bound(rows, W, sets[0][0].element_size(), add)
    case["input_sets"] = len(sets)
    return case


def measure_entry_graph(ln, name: str, rows: int, W: int, dtype, add: bool) -> dict:
    """The C entry's calls captured in CUDA graphs, as ``F.layer_norm``'s."""
    import torch

    sets, outs, scale, bias = inputs(rows, W, dtype, add)
    tname = "float32" if dtype == torch.float32 else "bfloat16"
    with torch.inference_mode():
        ms = graph_ms(lambda: entry_call(ln, add, sets, outs, scale, bias))
    return {"kernel": "fused_add_layer_norm" if add else "fused_layer_norm",
            "case": f"{name} {tname}", "entry_graph_ms": ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="checkout whose ccmh_torch is timed")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("time_torch_layernorm: needs a CUDA card", file=sys.stderr)
        return 2
    from ccmh_torch.ops import layernorm as ln

    if not os.path.abspath(ln.__file__).startswith(root + os.sep):
        print(f"time_torch_layernorm: imported {ln.__file__}, not from {root}", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"root": root, "card": card.stdout.strip().splitlines()[0]}), flush=True)
    cases = [(name, rows, W, dtype, add) for add in (False, True)
             for dtype in (torch.float32, torch.bfloat16) for name, rows, W in SHAPES]
    for case in cases:
        print(json.dumps(measure(ln, *case)), flush=True)
        torch.cuda.empty_cache()
    for case in cases:
        print(json.dumps(measure_entry_graph(ln, *case)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
