"""Microbench: the attention-backward ablation variants at the CLIP tower
shapes, on the card.

    python -m ccmh_torch.tools.bench_attn_bwd [--device cuda|cpu] [--tiny] [--quick]

Port of ``tools/bench_attn_bwd.py``.  It times each variant of kernel #2
(``ccmh_torch/csrc/attention_bwd.cu``, "v0 shipped") that the TPU tool
defines, each a kernel of ``ccmh_torch.ops.attention_variants``:

  fwd stacked bb=16     #7, every head's logits stacked before one softmax
  stacked bb=4, bb=8    #6 mode ``stacked``: one softmax / VJP pass over a
                        head stack, then the output products
  <mode> bb=4           #6's other modes: ``full``, ``pair`` (two heads a
                        block), ``nomax`` and ``nosoftmax`` (the softmax
                        recompute cut back), ``novjp`` and ``bf16vjp`` (the
                        softmax VJP cut or in bf16), ``fewstores`` (dq only)
  savedp bb=4           #8, from saved probabilities: no softmax recompute
  merged bb=2, bb=4     #9, bb elements as merged rows, bb-fold operations
  headpair bb=4         #10, a (B / bb, H / 2) grid

beside the forward kernel #1 as the harness check and v0 itself, at the
vision shape (B=256, L=50, D=768, H=12, no mask) and the text shape (B=256,
L=32, D=512, H=8, causal), qkv = RandomState(0).randn * 0.05 in bf16 and,
on the card, fp32.

Timing, as the TPU tool: a loop of chained calls, each backward's next g
the dk slice of its last dqkv (each forward's next mask its last output's
[L, L] corner times 1e-30), so no call repeats another; per call the
minimum over 3 repeats of (t_240 - t_40) / 200, from CUDA events
(``--quick``: (t_24 - t_4) / 20, once).  Checks: each variant against its
plain version on one call, and each that computes kernel #2's function
against v0 (the forwards against #1), within 3e-2 of the output scale.
One JSON line per variant: its device time per call beside the bound (the
bytes read once and written once at 3.35 TB/s, the operations at 989
TFLOP/s bf16; fp32 at 495/3 TFLOP/s, the kernels taking their fp32
products on the tensor cores as 3xTF32; the larger), both errors, its
kernel's launches,
and SDPA forward + backward minus SDPA forward (the forwards: SDPA
forward) as the library yardstick, which the port never calls.

A failed check or variant raises: nothing is caught.  Without a card the
default device raises; ``--device cpu`` runs the plain versions and times
nothing.  ``--tiny`` takes small shapes (B=16, L=8, D=64, H=4) and a few
chained calls, for the tests.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ccmh_torch.device import resolve_device
from ccmh_torch.ops import attention as attn
from ccmh_torch.ops import attention_variants as av
from ccmh_torch.tools.floors import bound

# the kernels whose fp32 products run on the tensor cores as 3xTF32 (three
# TF32 products each): a third of the TF32 peak
TENSOR_CORE_KERNELS = ("fused_attention_fwd", "fused_attention_bwd", "backward_x",
                       "forward_stacked", "backward_savedp", "backward_merged",
                       "backward_headpair")
CHECK_TOL = 3e-2
SHAPES = (("vision ViT-B/32", 256, 50, 768, 12, False), ("text", 256, 32, 512, 8, True))
TINY_SHAPES = (("vision tiny", 16, 8, 64, 4, False), ("text tiny", 16, 8, 64, 4, True))
LOOPS, QUICK_LOOPS, TINY_LOOPS = (40, 240), (4, 24), (1, 3)
REPEATS = 3
FWD_BB = 16

# the launch counter of each kernel: (module, attribute)
COUNTERS = {
    "fused_attention_fwd": (attn, "launches"),
    "fused_attention_bwd": (attn, "backward_launches"),
    "backward_x": (av, "backward_x_launches"),
    "forward_stacked": (av, "forward_stacked_launches"),
    "backward_savedp": (av, "backward_savedp_launches"),
    "backward_merged": (av, "backward_merged_launches"),
    "backward_headpair": (av, "backward_headpair_launches"),
}


def causal_bias(L: int, device="cpu") -> torch.Tensor:
    """The text shape's fp32 [L, L] mask as the TPU tool builds it: -1e9
    above the diagonal (not -inf: ``nosoftmax`` scales the logits, and
    -inf would make its VJP NaN)."""
    return torch.triu(torch.full((L, L), -1e9, dtype=torch.float32, device=device), 1)


def launches(kernel: str) -> int:
    mod, attr = COUNTERS[kernel]
    return getattr(mod, attr)


def cost(kernel, B, L, H, Dh, item, masked, bb=1, mode="full"):
    """(bytes, operations) of one call of ``kernel`` (a key of
    :data:`COUNTERS`): each input read once and each output written once,
    and the operations of the products it does on these inputs (#9's
    merged rows do bb times #2's)."""
    qkv = B * L * 3 * H * Dh * item
    g = B * L * H * Dh * item                  # also the forward's output
    mask = L * L * 4 if masked else 0
    work = B * H * L * L * Dh                  # one [L, L] x Dh product is 2 work
    if kernel in ("fused_attention_fwd", "forward_stacked"):
        return qkv + g + mask, 4.0 * work
    if kernel == "backward_savedp":            # the probs in place of a mask
        return 2 * qkv + g + B * H * L * L * item, 8.0 * work
    if kernel == "backward_merged":
        return 2 * qkv + g + (bb * L) ** 2 * 4, 10.0 * bb * work
    if mode == "fewstores":                    # dq only, into a third of dqkv
        return qkv + 2 * g + mask, 6.0 * work
    return 2 * qkv + g + mask, 10.0 * work


class Variant(NamedTuple):
    name: str
    kernel: str                        # a key of COUNTERS
    fn: Callable                       # (qkv, bias, g) -> out
    plain: Callable                    # its plain version, same arguments
    forward: bool
    same_function: bool                # computes #2's (or #1's) function
    cost: tuple                        # (bytes, operations) of one call
    out_cols: Optional[slice] = None   # the slots it writes, if not all


def variants(qkv, bias, H) -> List[Variant]:
    """The TPU tool's variants at ``qkv`` [B, L, 3D] under ``bias``."""
    B, L, D3 = qkv.shape
    D, Dh = D3 // 3, D3 // 3 // H
    shape = (B, L, H, Dh, qkv.element_size())
    masked = bias is not None
    probs = av.savedp_probs(qkv, bias, H)      # setup, outside the timed calls
    masks = {bb: av.merged_mask(bias, L, bb, device=qkv.device) for bb in (2, 4)}

    def fwd_mask(b, g):
        # the chained output feeds the next mask at a vanishing magnitude
        b2 = g[0, :, :L].float() * 1e-30
        return b2 if b is None else b2 + b

    out = [
        Variant("fwd kernel (harness check)", "fused_attention_fwd",
                lambda q, b, g: attn.fused_attention(q, fwd_mask(b, g), H),
                lambda q, b, g: attn.attention_reference(q, fwd_mask(b, g), H),
                True, True, cost("fused_attention_fwd", *shape, True)),
        Variant(f"fwd stacked bb={FWD_BB}", "forward_stacked",
                lambda q, b, g: av.forward_stacked(q, fwd_mask(b, g), H, FWD_BB),
                lambda q, b, g: av.forward_stacked_reference(q, fwd_mask(b, g), H),
                True, True, cost("forward_stacked", *shape, True)),
        Variant("v0 shipped", "fused_attention_bwd",
                lambda q, b, g: attn.attention_backward(q, b, None, g, H),
                lambda q, b, g: attn.attention_backward_reference(q, b, None, g, H),
                False, True, cost("fused_attention_bwd", *shape, masked)),
    ]
    for bb, mode in ((4, "stacked"), (8, "stacked"), *((4, m) for m in av.MODES
                                                       if m != "stacked")):
        out.append(Variant(
            f"{mode} bb={bb}", "backward_x",
            lambda q, b, g, bb=bb, mode=mode: av.backward_x(q, b, g, H, bb, mode),
            lambda q, b, g, mode=mode: av.backward_x_reference(q, b, g, H, mode),
            False, mode in av.SAME_FUNCTION_MODES,
            cost("backward_x", *shape, masked, bb, mode),
            slice(D, 2 * D) if mode == "fewstores" else None))
    out.append(Variant(
        "savedp bb=4", "backward_savedp",
        lambda q, b, g: av.backward_savedp(q, b, g, H, 4, probs=probs),
        lambda q, b, g: av.backward_savedp_reference(q, probs, g, H),
        False, True, cost("backward_savedp", *shape, masked, 4)))
    for bb in (2, 4):
        out.append(Variant(
            f"merged bb={bb}", "backward_merged",
            lambda q, b, g, bb=bb: av.backward_merged(q, b, g, H, bb, mask=masks[bb]),
            lambda q, b, g, bb=bb: av.backward_merged_reference(q, masks[bb], g, H, bb),
            False, True, cost("backward_merged", *shape, True, bb)))
    out.append(Variant(
        "headpair bb=4", "backward_headpair",
        lambda q, b, g: av.backward_headpair(q, b, g, H, 4),
        lambda q, b, g: av.backward_headpair_reference(q, b, g, H),
        False, True, cost("backward_headpair", *shape, masked, 4)))
    return out


def bound_us(n_bytes, n_ops, dtype, kernel):
    """The least time the card could take, in us, and what sets it, for
    ``kernel`` (a key of :data:`COUNTERS`): its fp32 products at the rate
    of the path it takes."""
    if dtype == torch.float32:
        op_type = "3xtf32" if kernel in TENSOR_CORE_KERNELS else "float32"
    else:
        op_type = "bfloat16"
    ms, by = bound(n_bytes, n_ops, op_type)
    return 1e3 * ms, by


def _rel_err(got, want, cols) -> float:
    if cols is not None:
        got, want = got[..., cols], want[..., cols]
    want = want.float()
    scale = want.abs().max().item() + 1e-9
    return (got.float() - want).abs().max().item() / scale


def _events_ms(fn, n_small, n_large, repeats) -> float:
    """Min over repeats of (t_large - t_small) / (n_large - n_small), ms."""
    best = math.inf
    for _ in range(repeats):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        fn(n_small)
        ev[1].record()
        ev[2].record()
        fn(n_large)
        ev[3].record()
        torch.cuda.synchronize()
        t = ev[2].elapsed_time(ev[3]) - ev[0].elapsed_time(ev[1])
        best = min(best, t / (n_large - n_small))
    return best


def sdpa_yardstick(qkv, causal, H, loops, repeats):
    """SDPA forward, and forward + backward minus forward, in ms."""
    B, L, D3 = qkv.shape
    Dh = D3 // 3 // H
    x = qkv.detach().requires_grad_()
    g = torch.ones((B, H, L, Dh), dtype=qkv.dtype, device=qkv.device) * 0.01

    def fwd():
        q, k, v = x.view(B, L, 3, H, Dh).permute(2, 0, 3, 1, 4)
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal)

    def times(fn):
        def run(n):
            for _ in range(n):
                fn()
        run(loops[0])
        return _events_ms(run, loops[0], loops[1], repeats)

    t_fwd = times(lambda: fwd().detach())
    t_both = times(lambda: torch.autograd.grad(fwd(), x, g))
    return t_fwd, t_both - t_fwd


def run_shape(tag, B, L, D, H, causal, dtype, device, loops, repeats) -> None:
    """Every variant at one shape and type: checks, times, one JSON line each."""
    cuda = device.type == "cuda"
    rng = np.random.RandomState(0)
    qkv = torch.from_numpy(rng.randn(B, L, 3 * D) * 0.05).to(dtype).to(device)
    bias = causal_bias(L, device) if causal else None
    sdpa_fwd_ms = sdpa_bwd_ms = None
    if cuda:
        sdpa_fwd_ms, sdpa_bwd_ms = sdpa_yardstick(qkv, causal, H, loops, repeats)
    g0 = torch.ones((B, L, D), dtype=dtype, device=device) * 0.01
    with torch.no_grad():
        vs = variants(qkv, bias, H)
        refs = {}   # the forward and backward references at g0
        for v in vs:
            # the next g: the forward's output, or the dk slot of the dqkv
            chain = (lambda d: d) if v.forward else (
                lambda d: d[:, :, D:2 * D].contiguous())
            start = launches(v.kernel)
            got = v.fn(qkv, bias, g0)
            err_plain = _rel_err(got, v.plain(qkv, bias, g0), v.out_cols)
            if v.forward or v.name == "v0 shipped":
                refs.setdefault(v.forward, got)
            err_ref = _rel_err(got, refs[v.forward], v.out_cols) if v.same_function else None
            if not (math.isfinite(err_plain) and err_plain < CHECK_TOL):
                raise AssertionError(f"{tag} {v.name}: rel err {err_plain:.3e} against its "
                                     "plain version")
            if err_ref is not None and not (math.isfinite(err_ref) and err_ref < CHECK_TOL):
                raise AssertionError(f"{tag} {v.name}: rel err {err_ref:.3e} against "
                                     f"{'#1' if v.forward else 'v0'}")

            def loop(n, v=v, chain=chain):
                g = g0
                for _ in range(n):
                    g = chain(v.fn(qkv, bias, g))
                return g

            ref_key = "rel_err_vs_fwd_kernel" if v.forward else "rel_err_vs_v0"
            loop(loops[0])
            ms = _events_ms(loop, loops[0], loops[1], repeats) if cuda else None
            bound, bound_by = bound_us(*v.cost, dtype, v.kernel)
            row = {"variant": v.name, "kernel": v.kernel, "shape": tag,
                   "qkv": [B, L, 3 * D], "heads": H, "causal": causal,
                   "dtype": str(dtype).split(".")[-1], "device": str(device),
                   "us_per_call": None if ms is None else 1e3 * ms,
                   "bound_us": bound, "bound_by": bound_by,
                   "rel_err_vs_plain": err_plain, ref_key: err_ref,
                   "launches": launches(v.kernel) - start,
                   "library": "SDPA fwd" if v.forward else "SDPA fwd+bwd minus SDPA fwd",
                   "library_us": None if not cuda else
                   1e3 * (sdpa_fwd_ms if v.forward else sdpa_bwd_ms)}
            print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    """Every variant at both shapes, bf16 and, on the card, fp32."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true", help="small shapes, a few calls")
    ap.add_argument("--quick", action="store_true",
                    help="(t_24 - t_4) / 20 once instead of (t_240 - t_40) / 200, min of 3")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    loops = TINY_LOOPS if args.tiny else QUICK_LOOPS if args.quick else LOOPS
    repeats = 1 if (args.tiny or args.quick) else REPEATS
    dtypes = (torch.bfloat16, torch.float32) if dev.type == "cuda" else (torch.bfloat16,)
    if dev.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    for dtype in dtypes:
        for tag, B, L, D, H, causal in (TINY_SHAPES if args.tiny else SHAPES):
            run_shape(tag, B, L, D, H, causal, dtype, dev, loops, repeats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
