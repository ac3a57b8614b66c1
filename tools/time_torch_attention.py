#!/usr/bin/env python3
"""Time the port's attention kernels #1 (forward) and #2 (backward), and
the ablation bench's #6 (``backward_x``), #7 (``forward_stacked``), #8
(``backward_savedp``), #9 (``backward_merged``) and #10
(``backward_headpair``), beside SDPA at the towers' shapes, for the
``ccmh_torch`` package of a checkout.

    python3 tools/time_torch_attention.py [--root DIR] [--kernels 1,2,6,7,8,9,10]
                                          [--merged-plans] [--bwd-x-plans]

``--root`` (default: this checkout) is the directory holding the
``ccmh_torch`` to time, so two versions compare inside one call on one
card: unpack the other under ``build/`` (``git archive <commit> | tar -x
-C build/old``) and run old, new, new, old.  Shapes: vision B=256 L=50
H=12, text B=256 L=32 H=8 causal, Dh=64, with the projection bias, bf16
and fp32; inputs from a seed.  Each time is the min over 3 of
(t_240 - t_40) / 200 chained calls from CUDA events, the kernels' at their
C entries (``fwd_ms``, ``bwd_ms``) and through their Python wrappers
(``*_wrapper_ms``, host-bound where the kernel is short); SDPA runs on the
same biased q, k, v (forward, and forward + backward minus forward).  One
JSON line per shape and type, with each kernel's max abs error against
its plain version; the card's name and power limit first.

``--kernels`` (default ``1,2``) picks what is timed: ``1,2`` as above;
``6``, ``7``, ``8``, ``9`` and ``10`` add one line per shape, type and
case for #6 in each of its eight modes at bb=4 and ``stacked`` at bb=8,
#7 at bb=16, #8 at bb=4 (from the probabilities ``savedp_probs`` saves,
built once), #9 at bb=2 and bb=4 (R = bb L merged rows under the
block-diagonal mask) and #10 at bb=4, no projection bias, the text shape
under the bench's -1e9 causal mask: ``entry_ms`` at the C entry,
``wrapper_ms``, the max abs error against the plain version (#6
``fewstores`` on the dk slot it writes), and SDPA's forward (#7) or
forward + backward minus forward (the backwards that compute its
function; none for #8, which no PyTorch call computes from saved
probabilities) on the same q, k, v.  A checkout whose entries take no
plan (#9 before ``_merged_plan``, #6 and #10 before ``_bwd_x_plan``, #8
before ``_savedp_plan``, each then in ``attention_variants``) is called
with its own argument list and library;
``--merged-plans`` adds a line for every path #9's entry takes at each
case (the [R, R] tiles kept, recomputed, or the operands streamed from
device memory), ``--bwd-x-plans`` one for every plan #6's and #10's entry
takes (the warp groups of ``pair``, #10 and ``stacked``), each checked
against the plain version.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

LOOPS = (40, 240)
REPEATS = 3
SHAPES = (("vision", 256, 50, 12, False), ("text", 256, 32, 8, True))
KERNELS = ("1", "2", "6", "7", "8", "9", "10")
BWD_X_MODES = ("full", "stacked", "pair", "nomax", "nosoftmax", "novjp", "bf16vjp", "fewstores")
# (kernel, bb, #6's mode)
VARIANT_CASES = tuple(("6", 4, m) for m in BWD_X_MODES) + (
    ("6", 8, "stacked"), ("7", 16, None), ("8", 4, None), ("9", 2, None), ("9", 4, None),
    ("10", 4, None))


def steady_ms(fn) -> float:
    import torch

    def run(n):
        for _ in range(n):
            fn()
    run(LOOPS[0])
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


def entry_call(attn, kind, qkv, mask, qkv_b, H, g=None):
    """A zero-argument call of the kernel at its C entry (``attn._entry``),
    with the wrapper's arguments and a preallocated output."""
    import torch

    B, L, D3 = qkv.shape
    Dh = D3 // 3 // H
    out = torch.empty((B, L, D3 // 3) if kind == "fwd" else (B, L, D3), dtype=qkv.dtype,
                      device=qkv.device)
    _, fn = attn._entry(kind)
    ptrs = [attn._ptr(qkv), attn._ptr(qkv_b), attn._ptr(mask)]
    ptrs += ([] if kind == "fwd" else [attn._ptr(g)]) + [attn._ptr(out)]
    args = (qkv.device.index, *ptrs, B, L, H, Dh, 1.0 / math.sqrt(Dh),
            attn._DTYPE_CODES[qkv.dtype], torch.cuda.current_stream(qkv.device).cuda_stream)

    def call():
        if fn(*args):
            raise RuntimeError(f"ccmh_attention_{kind} refused the launch")
    return call


def variant_entry_call(av, kernel, qkv, mask, g, H, bb, plan=None, out=None, mode=None):
    """A zero-argument call of #6 (in ``mode``), #7, #8, #9 or #10 at its
    C entry, with the arguments its wrapper passes (#6, #8, #9, #10: its
    plan, or ``plan``, where the checkout has one; #8: ``mask`` is the saved
    probabilities) and a preallocated output (or ``out``)."""
    import torch

    B, L, D3 = qkv.shape
    Dh = D3 // 3 // H
    if kernel in ("6", "10"):
        out = torch.empty_like(qkv) if out is None else out
        ptrs = (qkv, mask, g, out)
        if hasattr(av, "_bwd_x_entry"):
            lib, name, ints = av._bwd_x_entry(mode if kernel == "6" else "headpair", L, Dh,
                                              qkv.element_size(), bb, plan)
        else:   # a checkout from before the plan: #6 and #10 in attention_variants
            lib = "attention_variants"
            name = "ccmh_attention_bwd_x" if kernel == "6" else "ccmh_attention_bwd_headpair"
            ints = (bb, av.MODES.index(mode)) if kernel == "6" else (bb,)
    elif kernel == "8":
        out = torch.empty_like(qkv) if out is None else out
        ptrs = (qkv, mask, g, out)
        if hasattr(av, "_savedp_entry"):
            lib, name, ints = av._savedp_entry(L, Dh, qkv.element_size(), bb, mask.data_ptr(),
                                               plan)
        else:   # a checkout from before the plan: the CUDA-core #8 in attention_variants
            lib, name, ints = "attention_variants", "ccmh_attention_bwd_savedp", (bb,)
    elif kernel == "7":
        out = torch.empty((B, L, D3 // 3), dtype=qkv.dtype, device=qkv.device) if out is None \
            else out
        lib, name, ptrs, ints = ("attention_fwd_stacked", "ccmh_attention_fwd_stacked",
                                 (qkv, mask, out), (bb,))
    else:
        out = torch.empty_like(qkv) if out is None else out
        if plan is None:
            plan = tuple(av._merged_plan(bb * L, Dh, qkv.element_size())) if hasattr(
                av, "_merged_plan") else ()
        lib, name, ptrs, ints = ("attention_merged" if plan else "attention_variants",
                                 "ccmh_attention_bwd_merged", (qkv, mask, g, out), (bb, *plan))
    _, fn = av._entry(lib, name, len(ptrs), 4 + len(ints))
    args = (qkv.device.index, *(av._ptr(p) for p in ptrs), B, L, H, Dh, *ints,
            1.0 / math.sqrt(Dh), av._DTYPE_CODES[qkv.dtype],
            torch.cuda.current_stream(qkv.device).cuda_stream)

    def call():
        if fn(*args):
            raise RuntimeError(f"{name} refused the launch")
    return call


def time_plans(av, qkv, mask, g, H, bb, want, row) -> None:
    """One line per plan #9's entry takes at this case: C entry ms and its
    max abs error against the plain version."""
    import torch

    B, L, D3 = qkv.shape
    Dh = D3 // 3 // H
    for path in av.MERGED_PATHS:
        try:
            plan = av._merged_plan(bb * L, Dh, qkv.element_size(), path=path)
        except ValueError:       # does not fit shared memory
            continue
        out = torch.empty_like(qkv)
        call = variant_entry_call(av, "9", qkv, mask, g, H, bb, tuple(plan), out)
        try:
            call()
        except RuntimeError:     # a plan the entry does not take
            continue
        torch.cuda.synchronize()
        err = (out.float() - want).abs().max().item()
        print(json.dumps({**row, "plan": {"key_block": plan.key_block, "path": path,
                                          "smem_bytes": plan.smem_bytes},
                          "entry_ms": steady_ms(call), "max_abs_err": err}), flush=True)


def bwd_x_candidates(av, mode, L, Dh, itemsize, bb):
    """Every plan #6's (or #10's, ``mode="headpair"``) entry may take here:
    the warp groups its mode allows (``pair`` and #10: 1, 2 or 4;
    ``stacked``: 1-4 elements), those that fit shared memory."""
    if mode == "stacked":
        choices = (1, 2, 3, 4)
    elif mode in ("pair", "headpair"):
        choices = (1, 2, 4)
    else:
        choices = (1,)
    out = []
    for groups in choices:
        try:
            out.append(av._bwd_x_plan(mode, L, Dh, itemsize, bb, groups=groups))
        except ValueError:   # does not fit shared memory
            pass
    return out


def time_bwd_x_plans(av, kernel, mode, qkv, mask, g, H, bb, want, row) -> None:
    """One line per plan #6's or #10's entry takes at this case: C entry ms
    and its max abs error against the plain version."""
    import torch

    B, L, D3 = qkv.shape
    D = D3 // 3
    cols = slice(D, 2 * D) if mode == "fewstores" else slice(None)
    for plan in bwd_x_candidates(av, mode if kernel == "6" else "headpair", L, D // H,
                                 qkv.element_size(), bb):
        out = torch.empty_like(qkv)
        call = variant_entry_call(av, kernel, qkv, mask, g, H, bb, plan, out, mode)
        try:
            call()
        except RuntimeError:     # a plan the entry does not take
            continue
        torch.cuda.synchronize()
        err = (out[..., cols].float() - want[..., cols]).abs().max().item()
        print(json.dumps({**row, "plan": {"path": av.BWD_X_PATHS[plan.path],
                                          "groups": plan.groups,
                                          "smem_bytes": plan.smem_bytes},
                          "entry_ms": steady_ms(call), "max_abs_err": err}), flush=True)


def time_variants(kernels, dtype, tag, B, L, H, causal, plans=False, bwd_x_plans=False) -> None:
    """#6, #7, #8, #9 and #10 at one shape and type: one JSON line per case."""
    import torch

    from ccmh_torch.ops import attention_variants as av
    from ccmh_torch.tools import bench_attn_bwd as bench

    dev = torch.device("cuda")
    Dh = 64
    D = H * Dh
    gen = torch.Generator(device=dev).manual_seed(L * 1000 + H + 2)
    qkv = torch.randn((B, L, 3 * D), generator=gen, device=dev).to(dtype)
    g = torch.randn((B, L, D), generator=gen, device=dev).to(dtype)
    bias = bench.causal_bias(L, dev) if causal else None
    sdpa = bench.sdpa_yardstick(qkv, causal, H, LOOPS, REPEATS)
    for kernel, bb, mode in VARIANT_CASES:
        if kernel not in kernels:
            continue
        mask = bias
        cols = slice(D, 2 * D) if mode == "fewstores" else slice(None)
        with torch.no_grad():
            if kernel == "6":
                wrapper = lambda: av.backward_x(qkv, bias, g, H, bb, mode)          # noqa: E731
                want = av.backward_x_reference(qkv, bias, g, H, mode).float()
            elif kernel == "10":
                wrapper = lambda: av.backward_headpair(qkv, bias, g, H, bb)         # noqa: E731
                want = av.backward_headpair_reference(qkv, bias, g, H).float()
            elif kernel == "8":
                mask = av.savedp_probs(qkv, bias, H)
                wrapper = lambda: av.backward_savedp(qkv, bias, g, H, bb, probs=mask)  # noqa: E731
                want = av.backward_savedp_reference(qkv, mask, g, H).float()
            elif kernel == "7":
                wrapper = lambda: av.forward_stacked(qkv, bias, H, bb)        # noqa: E731
                want = av.forward_stacked_reference(qkv, bias, H).float()
            else:
                mask = av.merged_mask(bias, L, bb, device=dev)
                wrapper = lambda: av.backward_merged(qkv, bias, g, H, bb, mask=mask)  # noqa: E731
                want = av.backward_merged_reference(qkv, mask, g, H, bb).float()
            err = (wrapper()[..., cols].float() - want[..., cols]).abs().max().item()
            entry_ms = steady_ms(variant_entry_call(av, kernel, qkv, mask, g, H, bb, mode=mode))
            wrapper_ms = steady_ms(wrapper)
            row = {"kernel": f"#{kernel}", **({"mode": mode} if mode else {}), "bb": bb,
                   "shape": tag, "dtype": str(dtype).split(".")[-1]}
            if plans and kernel == "9":
                time_plans(av, qkv, mask, g, H, bb, want, row)
            if bwd_x_plans and kernel in ("6", "10"):
                time_bwd_x_plans(av, kernel, mode, qkv, mask, g, H, bb, want, row)
        print(json.dumps({
            **row, "B": B, "L": L, "H": H, "causal": causal, "entry_ms": entry_ms,
            "wrapper_ms": wrapper_ms,
            "sdpa": None if kernel == "8" else "fwd" if kernel == "7" else "fwd+bwd minus fwd",
            "sdpa_ms": (sdpa[0] if kernel == "7" else sdpa[1])
            if kernel != "8" and (mode is None or mode in av.SAME_FUNCTION_MODES) else None,
            "max_abs_err": err,
            "output_scale": want[..., cols].abs().max().item()}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="checkout whose ccmh_torch is timed")
    ap.add_argument("--kernels", default="1,2",
                    help="comma-separated kernel numbers out of 1, 2, 6, 7, 8, 9, 10 "
                         "(default 1,2)")
    ap.add_argument("--merged-plans", action="store_true",
                    help="with 9: time every plan #9's entry takes")
    ap.add_argument("--bwd-x-plans", action="store_true",
                    help="with 6 or 10: time every plan their entries take")
    args = ap.parse_args(argv)
    kernels = set(args.kernels.split(","))
    if not kernels <= set(KERNELS):
        ap.error(f"--kernels takes a comma-separated subset of {','.join(KERNELS)}")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_torch_attention: needs a CUDA card", file=sys.stderr)
        return 2
    from ccmh_torch.clip.model import causal_mask
    from ccmh_torch.ops import attention as attn

    if not os.path.abspath(attn.__file__).startswith(root + os.sep):
        print(f"time_torch_attention: imported {attn.__file__}, not from {root}", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"root": root, "card": card.stdout.strip().splitlines()[0]}), flush=True)
    dev = torch.device("cuda")
    for dtype in (torch.bfloat16, torch.float32):
        for tag, B, L, H, causal in SHAPES:
            if kernels & {"6", "7", "8", "9", "10"}:
                time_variants(kernels, dtype, tag, B, L, H, causal, args.merged_plans,
                              args.bwd_x_plans)
            if not kernels & {"1", "2"}:
                continue
            Dh = 64
            D = H * Dh
            gen = torch.Generator(device=dev).manual_seed(L * 1000 + H)
            qkv = torch.randn((B, L, 3 * D), generator=gen, device=dev).to(dtype)
            qkv_b = (0.1 * torch.randn((3 * D,), generator=gen, device=dev)).to(dtype)
            g = torch.randn((B, L, D), generator=gen, device=dev).to(dtype)
            mask = causal_mask(L, device=dev) if causal else None
            with torch.no_grad():
                fwd_err = (attn.fused_attention(qkv, mask, H, qkv_b=qkv_b).float()
                           - attn.attention_reference(qkv, mask, H, qkv_b=qkv_b).float()
                           ).abs().max().item()
                want = attn.attention_backward_reference(qkv, mask, qkv_b, g, H).float()
                bwd_err = (attn.attention_backward(qkv, mask, qkv_b, g, H).float() - want
                           ).abs().max().item()
                fwd_ms = steady_ms(entry_call(attn, "fwd", qkv, mask, qkv_b, H))
                bwd_ms = steady_ms(entry_call(attn, "bwd", qkv, mask, qkv_b, H, g))
                fwd_wrapper_ms = steady_ms(
                    lambda: attn.fused_attention(qkv, mask, H, qkv_b=qkv_b))
                bwd_wrapper_ms = steady_ms(
                    lambda: attn.attention_backward(qkv, mask, qkv_b, g, H))
            x = (qkv + qkv_b).detach().requires_grad_()
            g_heads = g.view(B, L, H, Dh).transpose(1, 2)

            def sdpa():
                q, k, v = x.view(B, L, 3, H, Dh).permute(2, 0, 3, 1, 4)
                return F.scaled_dot_product_attention(q, k, v, is_causal=causal)

            sdpa_fwd = steady_ms(lambda: sdpa().detach())
            sdpa_both = steady_ms(lambda: torch.autograd.grad(sdpa(), x, g_heads))
            print(json.dumps({
                "shape": tag, "dtype": str(dtype).split(".")[-1], "B": B, "L": L, "H": H,
                "causal": causal, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
                "fwd_wrapper_ms": fwd_wrapper_ms, "bwd_wrapper_ms": bwd_wrapper_ms,
                "sdpa_fwd_ms": sdpa_fwd, "sdpa_bwd_ms": sdpa_both - sdpa_fwd,
                "fwd_max_abs_err": fwd_err, "bwd_max_abs_err": bwd_err,
                "bwd_output_scale": want.abs().max().item()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
