#!/usr/bin/env python3
"""Drive the ccmh_torch serving and training paths on one NVIDIA card and
check them: DCHMT serving, DCHMT training, LinearHash training with the
LayerNorm kernels, and the token-level methods (MITH, DPSIH, DHaPH).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and ``nvidia-smi``; run from the root of a
checkout.  It exits non-zero, printing no result, when there is no card or
the ``ccmh_torch`` package is not beside it.  Phases, one line each:

1. the card (``nvidia-smi`` name and power limit) and the build of every
   CUDA kernel from the sources in the checkout, one ``nvcc`` per source;
2. each kernel against its plain PyTorch version on the card, at the
   paths' shapes: the attention forward and backward (vision B=256 L=50
   D=768 H=12, text B=256 L=32 D=512 H=8 causal, MITH's concept
   transformers B=128 L=K in {16, 64} D=512 H=8, all with the projection
   bias; fp32 within 1e-4 and bf16 within 2e-2, the backward's relative to
   its output scale) and packed Hamming (Q=512, N=2^20, K=64, exactly
   equal), the LayerNorm and residual add + LayerNorm (vision rows
   256x50 W=768, text rows 256x32 W=512; fp32 within 1e-5, bf16 within
   2e-2, the sum exactly equal), each with ms per call beside its bound,
   the plain version's ms and a PyTorch library call's ms where one
   computes the same function (the kernels at their C entries and,
   beside, through their wrappers, as min over 3 of (t_240 - t_40) / 200
   chained calls; SDPA timed alike; ``F.layer_norm`` and a copy of the
   LayerNorm's bytes in CUDA graphs, host-free); edge shapes (L=77,
   L=Dh=128, Dh=30, L=1, L=64, a qkv view at an odd storage offset; one
   row, ragged row counts, W from 1 to 1024, views one element in, fp32
   parameters with bf16 activations, each LayerNorm case with the branch
   it took, 16-byte or scalar), gradients through
   ``fused_attention`` and the LayerNorm Functions against autograd
   through the plain versions, and the refusals of inputs the kernels do
   not take;
3. the serving path at full width through its entry points, with the
   kernels' launch counters set to 0 just before and read just after:
   a seeded random ViT-B/32 DCHMT K=64 model saved as a ccmh-format
   ``.npz`` and restored by ``Retriever.from_pretrained``; 2,048 random
   CLIP-normalized 224x224 images encoded at batch 256; a 2^20-code gallery
   saved with ``HashIndex.save`` and loaded as ``ccmh_torch.serve
   --gallery`` loads it; ``RetrievalService`` on an HTTP port answering
   /healthz, /v1/encode (texts, images_b64), eight concurrent /v1/search
   and one /v1/add, each held against the direct calls;
4. checks and rates beside it: packed and int8 indexes agree; the kernel
   path's codes against the plain path's; encode items/s in fp32 and bf16
   and search ms per 512 queries; the codes with the LayerNorm kernels
   against the plain LayerNorm's, and encode items/s with each;
5. the training path through ``ccmh_torch.cli.main`` in-process, counters
   set to 0 just before and read just after: ViT-B/32 DCHMT K=64 fp32 from
   a seeded ``--pretrained`` init on a seeded synthetic 224x224 npy dataset
   (1,024 items: query 256, train 512), batch 128, 2 epochs with ``valid``
   and ``--save-model``.  It checks that both attention kernels launched,
   every step's loss is finite, every parameter moved, ``train.log`` has
   both epochs' mAP lines, and the saved ``.npz`` serves: restored by
   ``Retriever.from_pretrained`` it encodes the query split to the
   trainer's own codes (bits may differ only at pair margins < 1e-3);
6. beside it: one full-width loss and gradient with the fused attention
   against the plain one at the same parameters and batch (losses within
   1e-5, gradients within a relative norm of 1e-3), and the train step's
   ms at batch 128 in fp32 and bf16 (and fp32 with the plain attention),
   split into forward, backward and optimizer device time by CUDA events;
7. the LinearHash path with ``set_ln_impl("fused")``: ``ccmh_torch.cli.main``
   with ``--method DSPH`` as in phase 5 (a seeded ``--pretrained`` init
   with its proxies), counters set to 0 just before and read just after;
   it checks that the attention and LayerNorm kernels launched, the losses
   are finite, every parameter and proxy moved, the mAP lines, and that
   the saved ``.npz`` serves the trainer's codes.  Then DNpH, DDBH,
   DMsH_LN, DScPH and DDWSH, 2 steps each through ``Trainer`` with the
   same checks;
8. beside it: the full-width DSPH loss and gradient with the LayerNorm
   kernels against the plain LayerNorm (losses within 1e-5, relative
   gradient norm within 1e-3), and the DSPH step's ms at batch 128, fp32
   and bf16, LayerNorm fused and plain in turns;
9. the attention ablation path: ``python -m
   ccmh_torch.tools.bench_attn_bwd --quick`` in-process, counters set to 0
   just before and read just after (every variant at vision B=256 L=50
   H=12 and text B=256 L=32 H=8 causal, bf16 and fp32, each checked
   against its plain version and v0); it checks that kernels #6-#10 and,
   as its harness check and v0, #1 and #2 launched.  Then each of #6-#10
   against its plain version at those shapes (#6 in all eight modes,
   fewstores on its dk slot; fp32 within 1e-4 and bf16 within 2e-2 of the
   output scale), with ms per call beside its bound, the plain version's
   ms and SDPA's where it computes the same function (all five on the
   tensor cores, timed at their C entries as min over 3 of (t_240 -
   t_40) / 200 chained calls, the wrapper and the plan of #6, #8, #9 and
   #10 beside); edge shapes (L=77 causal, Dh=30 at an odd bb, L=1 at bb=B;
   #9 at R = 256, 112 and 256 with Dh=128, #7 at L=77 with Dh=30, #6
   ``full``, #8 and #10 at L=Dh=128 and L=120 causal, each with its path,
   #8 with its probability copy width) and the
   refusals (odd H for ``pair`` and #10, R > 256 for #9, a bb that does
   not divide B, fp16);
10. the token-level path with ``set_ln_impl("fused")``: ``ccmh_torch.cli.main``
   with ``--method MITH`` (ViT-B/32 K=64 fp32, a seeded ``--pretrained``
   init with its four code buffers, phase 5's dataset, batch 128, 1 epoch
   with ``valid`` and ``--save-model``), counters set to 0 just before and
   read just after.  It checks the launches of #1, #2, #4 and #5 against
   the counts the code implies (vision layers 1-11 and both concept
   transformers take #1; the text tower's per-example key-padding bias
   and the last vision block's attention weights take the plain
   formulation), the finite losses, every parameter moved, every buffer
   row written, and that the saved ``.npz`` serves the trainer's codes with
   the text side masked.  Then DPSIH and DHaPH, 2 steps each through
   ``Trainer`` and ``valid``: DPSIH ranks through its ``dist_fn`` and a
   ``HashIndex`` built with it answers a search; DHaPH's HPmodel and LCAs
   move under AdamW.  Beside it: the full-width MITH loss and gradient
   with the kernels against plain attention and LayerNorm (losses within
   1e-5, relative gradient norm within 1e-3), and the MITH, DPSIH and
   DHaPH step ms at batch 128 in fp32 and bf16, split into forward,
   backward and optimizer device time by CUDA events.

The second-to-last line of standard output is a JSON object with one
entry per kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check ends the run with a non-zero exit.
"""

from __future__ import annotations

import base64
import io
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the peak rate of their type.  The data sheet gives no int32 ALU rate; the
# fp32 CUDA-core rate stands in (the popcount kernel is bound by bytes
# either way).  The attention kernels #1 and #2 run their fp32 products on
# the tensor cores as 3xTF32 (three TF32 products each), a third of the TF32
# peak.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "int32": 67e12,
                  "3xtf32": 495e12 / 3}
# the rate of the attention kernels' products, by input type
ATTN_OP_TYPE = {"float32": "3xtf32", "bfloat16": "bfloat16"}

ATTN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
STEADY_LOOPS = (40, 240)   # the attention kernels' and SDPA's steady timing
# LayerNorm kernels vs their plain versions on unit-variance rows: fp32
# (rsqrtf and the reduction order differ), bf16 one ulp at the output scale
LN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# fused vs plain attention, full-width DCHMT gradient: ||g_f - g_p|| / ||g_p||
# over all leaves (fp32; the two sum each attention product in other orders,
# ~1e-6 relative per call, carried through 12 + 12 layers)
GRAD_REL_TOL = 1e-3
MARGIN = 1e-3          # code pairs closer than this may flip between paths
N_IMAGES = 2048
GALLERY = 2 ** 20
SEARCH_Q = 512
K_BITS = 64
BATCH = 256            # encode batch of the serving path


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    from ccmh_torch.ops import attention as attn
    from ccmh_torch.ops import attention_variants as av
    from ccmh_torch.ops import hamming as ham
    from ccmh_torch.ops import layernorm as ln

    attn.launches = attn.backward_launches = ham.launches = 0
    ln.launches = ln.add_launches = 0
    av.backward_x_launches = av.forward_stacked_launches = av.backward_savedp_launches = 0
    av.backward_merged_launches = av.backward_headpair_launches = 0


def read_counts() -> dict:
    from ccmh_torch.ops import attention as attn
    from ccmh_torch.ops import attention_variants as av
    from ccmh_torch.ops import hamming as ham
    from ccmh_torch.ops import layernorm as ln

    return {"fused_attention_fwd": attn.launches,
            "fused_attention_bwd": attn.backward_launches,
            "hamming_distance_packed": ham.launches,
            "fused_layer_norm": ln.launches,
            "fused_add_layer_norm": ln.add_launches,
            "backward_x": av.backward_x_launches,
            "forward_stacked": av.forward_stacked_launches,
            "backward_savedp": av.backward_savedp_launches,
            "backward_merged": av.backward_merged_launches,
            "backward_headpair": av.backward_headpair_launches}


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, sort_keys=False), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time per call from CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def steady_ms(fn) -> float:
    """Device time per call as the ablation bench takes it: min over 3 of
    (t_240 - t_40) / 200 chained calls, CUDA events."""
    from ccmh_torch.tools import bench_attn_bwd as bench

    def run(n):
        for _ in range(n):
            fn()
    run(STEADY_LOOPS[0])
    return bench._events_ms(run, *STEADY_LOOPS, 3)


def attention_entry(kind, qkv, mask, qkv_b, H, g=None):
    """A zero-argument call of attention kernel ``kind`` ("fwd" or "bwd")
    through its C entry, with the arguments its wrapper passes and a
    preallocated output: the kernel's own time, without the wrapper's
    Python checks (which take longer than the text shape's kernel)."""
    import torch

    from ccmh_torch.ops import attention as attn

    B, L, D3 = qkv.shape
    Dh = D3 // 3 // H
    out = torch.empty((B, L, D3 // 3) if kind == "fwd" else (B, L, D3), dtype=qkv.dtype,
                      device=qkv.device)
    lib, fn = attn._entry(kind)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    ptrs = [attn._ptr(qkv), attn._ptr(qkv_b), attn._ptr(mask)]
    ptrs += ([] if kind == "fwd" else [attn._ptr(g)]) + [attn._ptr(out)]
    args = (qkv.device.index, *ptrs, B, L, H, Dh, 1.0 / math.sqrt(Dh),
            attn._DTYPE_CODES[qkv.dtype], stream)

    def call():
        code = fn(*args)
        if code:
            fail(f"ccmh_attention_{kind}: CUDA error {code}")
    return call


def host_s(fn, reps: int = 3) -> float:
    """Best host-clock seconds of ``fn`` (which ends in a host copy)."""
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def bound(n_bytes: float, n_ops: float, op_type: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[op_type]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_train_steps(loss_fn, st, batch, optimizers, steps: int, warm: int,
                     grad_clip: float = 0.0) -> dict:
    """Host ms per eager train step and its forward, backward and optimizer
    device ms by CUDA events, over ``steps`` steps after ``warm`` (the
    method's global gradient clip in the optimizer part, as in the step)."""
    import torch

    from ccmh_torch.train.state import clip_by_global_norm_

    parts = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}
    t_host = 0.0
    for i in range(warm + steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        ev[0].record()
        for opt in optimizers:
            opt.zero_grad(set_to_none=True)
        loss, _ = loss_fn(st.params, st.extra, st.aux, batch, st.generator)
        ev[1].record()
        loss.backward()
        ev[2].record()
        if grad_clip:
            clip_by_global_norm_([p.grad for g in optimizers[0].param_groups
                                  for p in g["params"] if p.grad is not None], grad_clip)
        for opt in optimizers:
            opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        if i >= warm:
            t_host += time.perf_counter() - h0
            for k, (a, b) in zip(parts, ((0, 1), (1, 2), (2, 3))):
                parts[k] += ev[a].elapsed_time(ev[b]) / steps
    return {"step_ms": 1e3 * t_host / steps, **{f"{k}_ms": v for k, v in parts.items()}}


# --------------------------------------------------------------------- phase 1

def phase_build():
    from ccmh_torch.ops import build

    t0 = time.perf_counter()
    paths = build.build_all()
    seconds = time.perf_counter() - t0
    for name in paths:
        report = [ln.strip() for ln in (build.build_log(name) or "").splitlines()
                  if "registers" in ln or "spill" in ln]
        say("build", kernel=name, ptxas=report)
    say("build", seconds=round(seconds, 3), libraries=sorted(os.path.basename(p)
                                                             for p in paths.values()))


# --------------------------------------------------------------------- phase 2

def attention_case(name, B, L, H, causal, dtype):
    import torch

    from ccmh_torch.clip.model import causal_mask
    from ccmh_torch.ops import attention as attn
    from ccmh_torch.tools import bench_attn_bwd as bench

    dev = torch.device("cuda")
    D, Dh = H * 64, 64
    gen = torch.Generator(device=dev).manual_seed(L * 1000 + H)
    qkv = torch.randn((B, L, 3 * D), generator=gen, device=dev).to(dtype)
    qkv_b = (0.1 * torch.randn((3 * D,), generator=gen, device=dev)).to(dtype)
    mask = causal_mask(L, device=dev) if causal else None
    with torch.inference_mode():
        got = attn.fused_attention(qkv, mask, H, qkv_b=qkv_b)
        want = attn.attention_reference(qkv, mask, H, qkv_b=qkv_b)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tname = "float32" if dtype == torch.float32 else "bfloat16"
        check(math.isfinite(err) and err <= ATTN_TOL[tname],
              f"attention {name} {tname}: max abs err {err} > {ATTN_TOL[tname]}")
        ms = steady_ms(attention_entry("fwd", qkv, mask, qkv_b, H))
        wrapper_ms = steady_ms(lambda: attn.fused_attention(qkv, mask, H, qkv_b=qkv_b))
        plain_ms = cuda_ms(lambda: attn.attention_reference(qkv, mask, H, qkv_b=qkv_b))
    # the library yardstick: SDPA on the same (biased) q, k, v, timed alike
    lib_ms = bench.sdpa_yardstick(qkv + qkv_b, causal, H, STEADY_LOOPS, 3)[0]
    item = qkv.element_size()
    n_bytes = (qkv.numel() + qkv_b.numel() + B * L * D) * item + (L * L * 4 if causal else 0)
    n_ops = 4.0 * B * H * L * L * Dh
    bound_ms, bound_by = bound(n_bytes, n_ops, ATTN_OP_TYPE[tname])
    case = {"case": f"{name} {tname}", "shape": [B, L, 3 * D], "heads": H,
            "causal": causal, "max_abs_err": err, "tol": ATTN_TOL[tname], "ms": ms,
            "wrapper_ms": wrapper_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}
    say("kernel", kernel="fused_attention_fwd", **case)
    return case


def attention_bwd_case(name, B, L, H, causal, dtype):
    """Kernel C against its plain version at the training path's shapes."""
    import torch

    from ccmh_torch.clip.model import causal_mask
    from ccmh_torch.ops import attention as attn
    from ccmh_torch.tools import bench_attn_bwd as bench

    dev = torch.device("cuda")
    D, Dh = H * 64, 64
    gen = torch.Generator(device=dev).manual_seed(L * 1000 + H + 1)
    qkv = torch.randn((B, L, 3 * D), generator=gen, device=dev).to(dtype)
    qkv_b = (0.1 * torch.randn((3 * D,), generator=gen, device=dev)).to(dtype)
    g = torch.randn((B, L, D), generator=gen, device=dev).to(dtype)
    mask = causal_mask(L, device=dev) if causal else None
    tname = "float32" if dtype == torch.float32 else "bfloat16"
    with torch.no_grad():
        got = attn.attention_backward(qkv, mask, qkv_b, g, H)
        want = attn.attention_backward_reference(qkv, mask, qkv_b, g, H)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = max(1.0, want.float().abs().max().item())
        del got, want
        check(math.isfinite(err) and err <= ATTN_TOL[tname] * scale,
              f"attention backward {name} {tname}: max abs err {err} > "
              f"{ATTN_TOL[tname]} x output scale {scale}")
        ms = steady_ms(attention_entry("bwd", qkv, mask, qkv_b, H, g))
        wrapper_ms = steady_ms(lambda: attn.attention_backward(qkv, mask, qkv_b, g, H))
        plain_ms = cuda_ms(lambda: attn.attention_backward_reference(qkv, mask, qkv_b, g, H),
                           iters=5)
    # the library yardstick: SDPA forward + backward through autograd on the
    # q, k, v views of the biased qkv, minus SDPA's forward alone, each as
    # min over 3 of (t_240 - t_40) / 200 chained calls (the ablation bench's)
    lib_ms = bench.sdpa_yardstick(qkv + qkv_b, causal, H, STEADY_LOOPS, 3)[1]
    item = qkv.element_size()
    n_bytes = (2 * qkv.numel() + g.numel() + qkv_b.numel()) * item + (L * L * 4 if causal else 0)
    n_ops = 10.0 * B * H * L * L * Dh
    bound_ms, bound_by = bound(n_bytes, n_ops, ATTN_OP_TYPE[tname])
    case = {"case": f"{name} {tname}", "shape": [B, L, 3 * D], "heads": H,
            "causal": causal, "max_abs_err": err, "output_scale": scale,
            "tol": ATTN_TOL[tname], "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library": "SDPA fwd+bwd minus SDPA fwd", "bound_ms": bound_ms,
            "bound_by": bound_by}
    say("kernel", kernel="fused_attention_bwd", **case)
    return case


def hamming_case():
    import torch

    from ccmh_torch.ops import hamming as ham

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    W = K_BITS // 32
    lo, hi = -2 ** 31, 2 ** 31
    q = torch.randint(lo, hi, (SEARCH_Q, W), generator=gen, device=dev, dtype=torch.int32)
    r = torch.randint(lo, hi, (GALLERY, W), generator=gen, device=dev, dtype=torch.int32)
    with torch.inference_mode():
        got = ham.hamming_distance_packed(q, r)
        want = ham.hamming_distance_packed_reference(q, r)
        torch.cuda.synchronize()
        check(torch.equal(got, want), "packed hamming differs from its plain version")
        err = (got - want).abs().max().item()
        del want
        ms = cuda_ms(lambda: ham.hamming_distance_packed(q, r))
        plain_ms = cuda_ms(lambda: ham.hamming_distance_packed_reference(q, r), iters=5)
    n_bytes = (q.numel() + r.numel() + SEARCH_Q * GALLERY) * 4
    n_ops = 3.0 * SEARCH_Q * GALLERY * W        # xor, popcount, add per lane
    bound_ms, bound_by = bound(n_bytes, n_ops, "int32")
    case = {"case": "search int32", "shape": [SEARCH_Q, GALLERY, W],
            "max_abs_err": err, "tol": 0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
    say("kernel", kernel="hamming_distance_packed", **case)
    return case


def layernorm_case(name, rows, W, dtype, add):
    """Kernel #4 (``add`` False) or #5 against its plain version at a
    tower's shape, [rows = B * L, W] with the weights in the input type (as
    the towers cast them), timed by ``tools/time_torch_layernorm.py``: at
    the C entry (``ms``) and through the wrapper, beside ``F.layer_norm``
    in CUDA graphs (host-free), a copy of the same bytes and the plain
    version.  The calls cycle over enough input and output sets that each
    reads inputs the L2 cache no longer holds: in the towers they come from
    a matmul's output, not from a warm cache."""
    import torch

    from ccmh_torch.ops import layernorm as ln
    from tools import time_torch_layernorm as timing

    case = timing.measure(ln, name, rows, W, dtype, add)
    kernel = case.pop("kernel")
    tname = "float32" if dtype == torch.float32 else "bfloat16"
    if add:
        check(case["s_equal"], f"{kernel} {name} {tname}: s is not x + d")
    err = case["max_abs_err"]
    check(math.isfinite(err) and err <= LN_TOL[tname],
          f"{kernel} {name} {tname}: max abs err {err} > {LN_TOL[tname]}")
    case["tol"] = LN_TOL[tname]
    say("kernel", kernel=kernel, **case)
    return case


def layernorm_edges():
    """Kernels #4 and #5 at edge shapes (one row, a ragged row count, W = 1,
    100, 128, 1000 and 1024; views whose data starts one element in, fp32
    and bf16; fp32 parameters with bf16 activations), each with the branch
    it took (16-byte or scalar), a gradient through the autograd Functions
    against autograd through the plain versions, and the refusals: an
    unsupported type or width raises, it never takes the plain path, and
    the C entry refuses the 16-byte branch on data one element in."""
    import torch

    from ccmh_torch.ops import layernorm as ln

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = ((1, 768), (1001, 512), (37, 1), (9, 100), (300, 128), (65, 1000), (1003, 1024))
    # (rows, W, activation type, parameter type, elements the data starts in)
    cases = [(rows, W, dt, dt, 0) for rows, W in shapes for dt in (f32, bf16)]
    cases += [(257, 768, f32, f32, 1), (257, 512, bf16, bf16, 1),
              (300, 768, bf16, f32, 0), (300, 100, bf16, f32, 0)]
    errs, branches = [], {}
    with torch.no_grad():
        for rows, W, dtype, pdtype, offset in cases:
            tname = "float32" if dtype == f32 else "bfloat16"
            x, d = (torch.randn((offset + rows * W,), generator=gen, device=dev).to(dtype)
                    [offset:].view(rows, W) for _ in range(2))
            sc = (1.0 + 0.1 * torch.randn((W,), generator=gen, device=dev)).to(pdtype)
            bi = (0.1 * torch.randn((W,), generator=gen, device=dev)).to(pdtype)
            vector = ln._vector_path(x, d, torch.empty_like(x), torch.empty_like(x), sc, bi)
            key = f"{rows}x{W} {tname}" + (" fp32 params" if pdtype != dtype else "") + (
                f" +{offset}" if offset else "")
            branches[key] = "16-byte" if vector else "scalar"
            err = (ln.ln_forward(x, sc, bi).float()
                   - ln.layer_norm_reference(x, sc, bi).float()).abs().max().item()
            y, s = ln.add_ln_forward(x, d, sc, bi)
            want_y, want_s = ln.add_layer_norm_reference(x, d, sc, bi)
            err = max(err, (y.float() - want_y.float()).abs().max().item())
            check(torch.equal(s, want_s), f"layer norm {key}: s != x + d")
            check(err <= LN_TOL[tname], f"layer norm {key}: err {err}")
            errs.append(err)
    for key in ("9x100 bfloat16", "300x100 bfloat16 fp32 params", "257x768 float32 +1",
                "257x512 bfloat16 +1"):
        check(branches[key] == "scalar", f"layer norm {key} took the {branches[key]} branch")
    for key in ("65x1000 bfloat16", "300x768 bfloat16 fp32 params", "1001x512 bfloat16",
                "1x768 float32"):
        check(branches[key] == "16-byte", f"layer norm {key} took the {branches[key]} branch")

    # autograd on the card: the kernels' forwards + the closed-form VJP
    # against autograd through the plain versions
    g = torch.Generator(device=dev).manual_seed(5)
    inputs = [torch.randn(shape, generator=g, device=dev) for shape in
              ((4, 50, 768), (4, 50, 768), (768,), (768,), (4, 50, 768), (4, 50, 768))]
    grads = {}
    for name in ("kernel", "plain"):
        x, d, sc, bi = (t.clone().requires_grad_() for t in inputs[:4])
        if name == "kernel":
            h = ln.fused_layer_norm(x, sc, bi)
            y, s = ln.fused_add_layer_norm(x, d, sc, bi)
        else:
            h = ln.layer_norm_reference(x, sc, bi)
            y, s = ln.add_layer_norm_reference(x, d, sc, bi)
        loss = (h * inputs[4]).sum() + (y * inputs[5]).sum() + (s * s).sum()
        grads[name] = torch.autograd.grad(loss, (x, d, sc, bi))
    grad_err = max((a - c).abs().max().item() / max(1.0, c.abs().max().item())
                   for a, c in zip(grads["kernel"], grads["plain"]))
    check(grad_err <= 1e-4, f"gradient through the LayerNorm kernels differs: {grad_err}")

    x = torch.zeros((4, 64), device=dev)
    w = torch.ones(64, device=dev)
    refusals = 0
    for call in (
        lambda: ln.fused_layer_norm(x.half(), w.half(), w.half()),
        lambda: ln.fused_layer_norm(torch.zeros((4, 1025), device=dev),
                                    torch.ones(1025, device=dev), torch.ones(1025, device=dev)),
        lambda: ln.fused_add_layer_norm(x, x.bfloat16(), w, w),
        lambda: ln.fused_layer_norm(x, w, w.bfloat16()),
    ):
        before = ln.launches + ln.add_launches
        try:
            call()
        except (ValueError, TypeError, RuntimeError):
            refusals += 1
        check(ln.launches + ln.add_launches == before, "a refused LayerNorm input launched")
    check(refusals == 4, f"only {refusals} of 4 unsupported LayerNorm inputs raised")
    # the C entry checks the wrapper's rule again: asked for the 16-byte
    # branch on data one element in, it returns cudaErrorInvalidValue (1)
    xo = torch.zeros((4 * 64 + 1,), device=dev)[1:].view(4, 64)
    yo = torch.empty_like(xo)
    _, fn = ln._c_entry(False)
    code = fn(dev.index or 0, xo.data_ptr(), w.data_ptr(), w.data_ptr(), yo.data_ptr(), 4, 64,
              0, 0, 1, torch.cuda.current_stream().cuda_stream)
    check(code == 1, f"the C entry took the 16-byte branch on data one element in ({code})")
    say("edges", layernorm_cases=[[r, W, str(t)[6:], str(p)[6:], o] for r, W, t, p, o in cases],
        layernorm_branches=branches, layernorm_max_abs_err=errs,
        layernorm_gradient_rel_err_vs_plain=grad_err, layernorm_refusals=refusals,
        layernorm_c_entry_refuses_unaligned_vector=True)


def edge_checks():
    """Ragged and large-shared-memory shapes for both attention kernels and
    the popcount kernel; a gradient through ``fused_attention`` on the card
    against autograd through the plain version; and the refusals: a CUDA
    tensor the kernels do not take raises, it never takes the plain path."""
    import torch

    from ccmh_torch.clip.model import causal_mask
    from ccmh_torch.ops import attention as attn
    from ccmh_torch.ops import hamming as ham

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    shapes = (  # (B, L, H, Dh, causal, offset): the longest text context,
        #         the L = Dh = 128 limit (203 KB of shared memory forward; the
        #         backward's recompute path in fp32, its tiles in bf16), an odd
        #         head dim, L = 1, L = 64 (full mma tiles, no padded key), and
        #         a view one element into its storage (not 16-byte aligned:
        #         the kernels' scalar loads and stores)
        (3, 77, 8, 64, True, 0), (2, 128, 2, 128, True, 0), (2, 13, 3, 30, False, 0),
        (5, 1, 2, 64, False, 0), (3, 64, 4, 64, True, 0), (4, 50, 12, 64, False, 1))
    errs, bwd_errs = [], []
    with torch.no_grad():
        for B, L, H, Dh, causal, offset in shapes:
            for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
                n = B * L * 3 * H * Dh
                flat = torch.randn((offset + n,), generator=gen, device=dev).to(dtype)
                qkv = flat[offset:].view(B, L, 3 * H * Dh)
                b = torch.randn((3 * H * Dh,), generator=gen, device=dev).to(dtype)
                g = torch.randn((B, L, H * Dh), generator=gen, device=dev).to(dtype)
                m = causal_mask(L, device=dev) if causal else None
                err = (attn.fused_attention(qkv, m, H, qkv_b=b).float()
                       - attn.attention_reference(qkv, m, H, qkv_b=b).float()
                       ).abs().max().item()
                check(err <= tol, f"attention {(B, L, H, Dh, causal, offset)} {dtype}: err {err}")
                errs.append(err)
                want = attn.attention_backward_reference(qkv, m, b, g, H).float()
                scale = max(1.0, want.abs().max().item())
                err = (attn.attention_backward(qkv, m, b, g, H).float() - want
                       ).abs().max().item()
                check(err <= tol * scale,
                      f"attention backward {(B, L, H, Dh, causal, offset)} {dtype}: "
                      f"err {err}")
                bwd_errs.append(err)
        q = torch.randint(-2 ** 31, 2 ** 31, (37, 3), generator=gen, device=dev, dtype=torch.int32)
        r = torch.randint(-2 ** 31, 2 ** 31, (1001, 3), generator=gen, device=dev, dtype=torch.int32)
        check(torch.equal(ham.hamming_distance_packed(q, r),
                          ham.hamming_distance_packed_reference(q, r)),
              "packed hamming differs on ragged shapes")

    # autograd on the card: kernel A forward + kernel C backward against
    # autograd through the plain formulation (d qkv and d qkv_b)
    grads = {}
    for name in ("kernel", "plain"):
        x = torch.randn((4, 50, 3 * 768), generator=torch.Generator(device=dev).manual_seed(3),
                        device=dev).requires_grad_()
        b = (0.1 * torch.ones(3 * 768, device=dev)).requires_grad_()
        out = (attn.fused_attention(x, None, 12, qkv_b=b) if name == "kernel"
               else attn.attention_reference(x, None, 12, qkv_b=b))
        grads[name] = torch.autograd.grad((out * out).sum(), (x, b))
    grad_err = max((a - c).abs().max().item() / max(1.0, c.abs().max().item())
                   for a, c in zip(grads["kernel"], grads["plain"]))
    check(grad_err <= 1e-4, f"gradient through fused_attention differs: {grad_err}")

    refusals = 0
    for call in (
        lambda: attn.fused_attention(torch.zeros((1, 129, 192), device=dev), None, 3),
        lambda: attn.fused_attention(torch.zeros((1, 5, 192), device=dev,
                                                 dtype=torch.float16), None, 3),
        lambda: ham.hamming_distance_packed(torch.zeros((2, 9), device=dev, dtype=torch.int32),
                                            torch.zeros((2, 9), device=dev, dtype=torch.int32)),
    ):
        try:
            call()
        except (ValueError, TypeError, RuntimeError):
            refusals += 1
    check(refusals == 3, f"only {refusals} of 3 unsupported CUDA inputs raised")
    say("edges", attention_shapes=[list(x) for x in shapes],
        attention_max_abs_err_fp32_bf16=errs, attention_bwd_max_abs_err_fp32_bf16=bwd_errs,
        gradient_rel_err_vs_plain=grad_err, hamming_ragged="ok", refusals=refusals)


# --------------------------------------------------------------------- phase 3

CAPTION_WORDS = (
    ("a", "two", "three", "the", "some"),
    ("small", "large", "red", "black", "white", "young", "old", "happy"),
    ("dog", "cat", "man", "woman", "child", "car", "bus", "bird", "horse", "boat"),
    ("runs", "sits", "stands", "plays", "jumps", "rides", "sleeps", "waits"),
    ("on the grass", "near the water", "in the street", "on a sofa",
     "under a tree", "at the beach", "in the snow", "next to a window"),
)


def captions(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [" ".join(ws[rng.integers(len(ws))] for ws in CAPTION_WORDS) for _ in range(n)]


def random_images(n: int, res: int, seed: int) -> np.ndarray:
    """Random uint8 pixels, CLIP-normalized to float32 NHWC on the host."""
    import torch

    from ccmh_torch.clip.model import normalize_pixels

    gen = torch.Generator(device="cuda").manual_seed(seed)
    raw = torch.randint(0, 256, (n, res, res, 3), generator=gen, device="cuda",
                        dtype=torch.uint8)
    return normalize_pixels(raw).cpu().numpy()


def http(port: int, path: str, body=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = None if body is None else json.dumps(body).encode()
    with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=300) as resp:
        return json.loads(resp.read())


def serving_path(state):
    """The serving path through its entry points (counted launches)."""
    import torch

    from ccmh_torch.clip.model import ClipConfig, init_clip_params
    from ccmh_torch.config import Config
    from ccmh_torch.retrieval import HashIndex, Retriever
    from ccmh_torch.serve import RetrievalService, serve
    from ccmh_torch.train.checkpoint import save_checkpoint
    from ccmh_torch.train.methods import get_method

    os.makedirs(WORK, exist_ok=True)
    ckpt = os.path.join(WORK, "vitb32_dchmt_k64.npz")
    cfg = Config(method="DCHMT", output_dim=K_BITS, max_words=32, nclass=80,
                 pretrained=ckpt)
    clip_cfg = ClipConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    heads, _, aux = get_method("DCHMT").init(gen, cfg, clip_cfg)
    params = {"clip": init_clip_params(gen, clip_cfg), **heads}
    n_params = sum(t.numel() for t in _leaves(params))
    save_checkpoint(ckpt, params, aux=aux)
    del params
    t0 = time.perf_counter()
    retriever = Retriever.from_pretrained(cfg, device="cuda")
    load_s = time.perf_counter() - t0
    check(retriever.clip_cfg == clip_cfg, f"restored {retriever.clip_cfg}")
    say("serve", model="ViT-B/32 DCHMT K=64 fp32", params=n_params,
        checkpoint_mb=round(os.path.getsize(ckpt) / 2 ** 20, 1), load_s=round(load_s, 3))

    images = random_images(N_IMAGES, clip_cfg.image_resolution, seed=1)
    img_codes = retriever.encode_images(images, batch_size=BATCH)
    check(img_codes.shape == (N_IMAGES, K_BITS) and set(np.unique(img_codes)) <= {-1, 1},
          f"image codes {img_codes.shape} {np.unique(img_codes)}")
    texts = captions(N_IMAGES, seed=2)
    txt_codes = retriever.encode_texts(texts, batch_size=BATCH)
    check(txt_codes.shape == (N_IMAGES, K_BITS), f"text codes {txt_codes.shape}")

    gen = torch.Generator(device="cuda").manual_seed(3)
    rest = torch.where(torch.rand((GALLERY - N_IMAGES, K_BITS), generator=gen,
                                  device="cuda") < 0.5, -1, 1).to(torch.int8)
    gallery = torch.cat([torch.from_numpy(img_codes).cuda(), rest])
    gallery_path = os.path.join(WORK, "gallery_packed.npz")
    HashIndex(gallery, packed=True, device="cuda").save(gallery_path)
    index = HashIndex.load(gallery_path, **retriever._index_kw())   # as serve --gallery
    check(index.packed and len(index) == GALLERY, "loaded gallery")
    say("serve", gallery=len(index), packed=index.packed,
        gallery_file_mb=round(os.path.getsize(gallery_path) / 2 ** 20, 1))

    service = RetrievalService(retriever, {"image": index})
    server = serve(service, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        health = http(port, "/healthz")
        check(health["ok"] and health["indexes"] == {"image": GALLERY}, f"healthz {health}")

        got = http(port, "/v1/encode", {"texts": texts[:8]})
        check(np.array_equal(np.asarray(got["codes"]), retriever.encode_texts(texts[:8])),
              "/v1/encode texts differs from Retriever.encode_texts")
        buf = io.BytesIO()
        np.save(buf, images[:4])
        got = http(port, "/v1/encode", {"images_b64": base64.b64encode(buf.getvalue()).decode()})
        check(np.array_equal(np.asarray(got["codes"]), retriever.encode_images(images[:4])),
              "/v1/encode images_b64 differs from Retriever.encode_images")

        queries = texts[8:16]
        answers = [None] * len(queries)

        def one(j):
            answers[j] = http(port, "/v1/search", {"texts": [queries[j]], "k": 10})

        workers = [threading.Thread(target=one, args=(j,)) for j in range(len(queries))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=300)
        check(not any(w.is_alive() for w in workers), "a /v1/search request hung")
        # the batcher coalesces concurrent requests into buckets of up to 8
        # rows; each answer must equal the direct search at batch 1 or 8
        direct = [index.search(retriever.encode_texts(queries), 10),
                  index.search(np.concatenate([retriever.encode_texts([t]) for t in queries]), 10)]
        for j, ans in enumerate(answers):
            check(any(ans["indices"] == [d[1][j].tolist()] and ans["distances"] == [d[0][j].tolist()]
                      for d in direct), f"/v1/search answer {j} differs from HashIndex.search")
        batches = http(port, "/healthz")["batching"]["search"]

        new = -img_codes[:4]            # sign-flipped codes: not in the gallery
        got = http(port, "/v1/add", {"index": "image", "codes": new.tolist()})
        check(got == {"index": "image", "size": GALLERY + 4}, f"/v1/add {got}")
        d, i = index.search(new, 1)
        check(np.all(d == 0) and np.array_equal(i[:, 0], np.arange(GALLERY, GALLERY + 4)),
              f"added codes not found: {d.ravel()} {i.ravel()}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    say("serve", http="ok", search_requests=len(queries), search_batches=batches["batches"],
        add="ok")
    state.update(retriever=retriever, index=index, images=images, texts=texts,
                 img_codes=img_codes, txt_codes=txt_codes, gallery=gallery, cfg=cfg)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# --------------------------------------------------------------------- phase 4

def beside_the_path(state):
    import torch

    from ccmh_torch.clip import model as cm
    from ccmh_torch.models.heads import select_hash
    from ccmh_torch.retrieval import HashIndex, Retriever
    from ccmh_torch.tokenizer import tokenize_batch
    from ccmh_torch.train.methods.base import image_embeds, text_embeds

    retriever, index, gallery = state["retriever"], state["index"], state["gallery"]
    images, texts = state["images"], state["texts"]

    # packed (kernel) and int8 (matmul) indexes: identical (distances, indices)
    int8_index = HashIndex(gallery, packed=False, device="cuda")
    int8_index.add(-state["img_codes"][:4])     # the rows of the /v1/add
    q = np.concatenate([state["txt_codes"][:SEARCH_Q // 2], state["img_codes"][:SEARCH_Q // 2]])
    dp, ip = index.search(q, 10)
    d8, i8 = int8_index.search(q, 10)
    check(np.array_equal(dp, d8) and np.array_equal(ip, i8), "packed and int8 top-10 differ")
    # an image query finds its own gallery row (or an equal code before it)
    own = dp[SEARCH_Q // 2:, 0] == 0
    check(own.all() and np.all(ip[SEARCH_Q // 2:, 0] <= np.arange(SEARCH_Q // 2)),
          "image queries do not find themselves at distance 0")
    # and a numpy brute force agrees on a few queries
    g_host = gallery.cpu().numpy().astype(np.int32)
    g_host = np.concatenate([g_host, -state["img_codes"][:4].astype(np.int32)])
    for j in (0, 1, SEARCH_Q - 1):
        dist = (K_BITS - g_host @ q[j].astype(np.int32)) // 2
        order = np.argsort(dist, kind="stable")[:10]
        check(np.array_equal(order, ip[j]) and np.array_equal(dist[order], dp[j]),
              f"query {j} differs from the numpy brute force")
    say("check", packed_vs_int8="identical", queries=SEARCH_Q, k=10, gallery=len(index),
        brute_force="ok")

    # kernel path vs plain path on the card: codes agree except at tiny margins
    params, cfg, ccfg = retriever.params, retriever.cfg, retriever.clip_cfg
    mismatches, near = 0, 0
    with torch.inference_mode():
        for kind, data, codes in (("image", images, state["img_codes"]),
                                  ("text", None, state["txt_codes"])):
            cm.set_attn_impl("plain")
            try:
                if kind == "image":
                    emb = torch.cat([image_embeds(params, ccfg, torch.from_numpy(images[s:s + BATCH]).cuda(), cfg)
                                     for s in range(0, N_IMAGES, BATCH)])
                else:
                    ids = torch.from_numpy(tokenize_batch(texts, cfg.max_words)).cuda()
                    emb = torch.cat([text_embeds(params, ccfg, ids[s:s + BATCH], cfg)
                                     for s in range(0, N_IMAGES, BATCH)])
            finally:
                cm.set_attn_impl("fused")
            pairs = select_hash(params["img_head" if kind == "image" else "txt_head"], emb)
            plain = (2 * pairs.argmax(-1) - 1).to(torch.int8).cpu().numpy()
            margin = (pairs[..., 1] - pairs[..., 0]).abs().cpu().numpy()
            differ = plain != codes
            near += int((margin < MARGIN).sum())
            mismatches += int(differ.sum())
            check(np.all(margin[differ] < MARGIN),
                  f"{kind} codes differ between kernel and plain paths at margin >= {MARGIN}")
    say("check", kernel_vs_plain_codes="agree", bits=2 * N_IMAGES * K_BITS,
        differing_bits=mismatches, bits_with_margin_below_1e_3=near)

    # rates: encode items/s (fp32 and bf16) and search ms per 512 queries
    ids = tokenize_batch(texts, cfg.max_words)
    bf16 = Retriever(retriever.method, params, retriever.aux,
                     cfg.replace(compute_dtype="bfloat16"), ccfg, device="cuda")
    rates = {}
    for name, r in (("fp32", retriever), ("bf16", bf16)):
        r.encode_images(images[:BATCH])
        rates[f"image_encode_items_per_s_{name}"] = N_IMAGES / host_s(
            lambda: r.encode_images(images, batch_size=BATCH))
        rates[f"text_encode_items_per_s_{name}"] = N_IMAGES / host_s(
            lambda: r.encode_texts(ids, batch_size=BATCH))
    bf16_codes = bf16.encode_images(images[:BATCH])
    rates["bf16_fp32_image_code_bit_agreement"] = float(
        (bf16_codes == state["img_codes"][:BATCH]).mean())
    rates["tokenize_captions_per_s"] = N_IMAGES / host_s(
        lambda: tokenize_batch(texts, cfg.max_words), reps=1)
    q512 = state["txt_codes"][:SEARCH_Q]
    rates["search_ms_per_512_packed"] = 1e3 * host_s(lambda: index.search(q512, 10))
    rates["search_ms_per_512_int8"] = 1e3 * host_s(lambda: int8_index.search(q512, 10))
    say("rates", **{k: round(v, 4) for k, v in rates.items()})
    return rates


def layernorm_beside_serving(state):
    """The serving model's codes with the LayerNorm kernels against the
    plain LayerNorm's (bits may differ only at pair margins < MARGIN), and
    encode items/s with LN fused and plain, in turns (plain, fused, fused,
    plain; the best of each)."""
    import torch

    from ccmh_torch.clip import model as cm
    from ccmh_torch.models.heads import select_hash
    from ccmh_torch.retrieval import Retriever
    from ccmh_torch.tokenizer import tokenize_batch
    from ccmh_torch.train.methods.base import image_embeds, text_embeds

    retriever, images, texts = state["retriever"], state["images"], state["texts"]
    params, cfg, ccfg = retriever.params, retriever.cfg, retriever.clip_cfg
    ids = tokenize_batch(texts, cfg.max_words)
    mismatches, near = 0, 0
    cm.set_ln_impl("fused")
    try:
        with torch.inference_mode():
            for kind, data, codes in (("image", images, state["img_codes"]),
                                      ("text", ids, state["txt_codes"])):
                embed = image_embeds if kind == "image" else text_embeds
                emb = torch.cat([embed(params, ccfg, torch.from_numpy(data[s:s + BATCH]).cuda(), cfg)
                                 for s in range(0, N_IMAGES, BATCH)])
                pairs = select_hash(params["img_head" if kind == "image" else "txt_head"], emb)
                fused = (2 * pairs.argmax(-1) - 1).to(torch.int8).cpu().numpy()
                margin = (pairs[..., 1] - pairs[..., 0]).abs().cpu().numpy()
                differ = fused != codes
                near += int((margin < MARGIN).sum())
                mismatches += int(differ.sum())
                check(np.all(margin[differ] < MARGIN),
                      f"{kind} codes differ between fused and plain LayerNorm at margin >= {MARGIN}")
    finally:
        cm.set_ln_impl("plain")
    say("check", fused_vs_plain_layernorm_codes="agree", bits=2 * N_IMAGES * K_BITS,
        differing_bits=mismatches, bits_with_margin_below_1e_3=near)

    bf16 = Retriever(retriever.method, params, retriever.aux,
                     cfg.replace(compute_dtype="bfloat16"), ccfg, device="cuda")
    rates = {}
    try:
        for name, r in (("fp32", retriever), ("bf16", bf16)):
            for kind, fn, data in (("image", r.encode_images, images), ("text", r.encode_texts, ids)):
                best = {"plain": 0.0, "fused": 0.0}
                for impl in ("plain", "fused", "fused", "plain"):
                    cm.set_ln_impl(impl)
                    fn(data[:BATCH], batch_size=BATCH)
                    rate = N_IMAGES / host_s(lambda: fn(data, batch_size=BATCH), reps=1)
                    best[impl] = max(best[impl], rate)
                for impl, rate in best.items():
                    rates[f"{kind}_encode_items_per_s_{name}_ln_{impl}"] = rate
    finally:
        cm.set_ln_impl("plain")
    say("rates", **{k: round(v, 4) for k, v in rates.items()})
    return rates


# --------------------------------------------------------------------- phase 5

TRAIN_ITEMS, TRAIN_QUERY, TRAIN_SPLIT, TRAIN_BATCH = 1024, 256, 512, 128


def training_path(state):
    """``python -m ccmh_torch.cli`` in-process: ViT-B/32 DCHMT K=64 fp32,
    2 epochs of batch 128 over a seeded synthetic 224x224 npy dataset,
    ``valid`` each epoch, ``--save-model`` (counted launches around it)."""
    import torch

    from ccmh_torch import cli
    from ccmh_torch.clip.model import ClipConfig, init_clip_params
    from ccmh_torch.config import Config
    from ccmh_torch.data.synthetic import write_synthetic_mat_dataset
    from ccmh_torch.train.checkpoint import save_checkpoint
    from ccmh_torch.train.methods import get_method

    data = os.path.join(WORK, "train_data")
    t0 = time.perf_counter()
    write_synthetic_mat_dataset(data, n=TRAIN_ITEMS, n_class=24, resolution=224, seed=5)
    data_s = time.perf_counter() - t0
    # a seeded random init as --pretrained, so the moved weights can be seen
    init = os.path.join(WORK, "train_init.npz")
    gen = torch.Generator(device="cuda").manual_seed(4)
    heads, _, aux = get_method("DCHMT").init(gen, Config(output_dim=K_BITS), ClipConfig())
    params0 = {"clip": init_clip_params(gen, ClipConfig()), **heads}
    save_checkpoint(init, params0, aux=aux)
    out = os.path.join(WORK, "train_out")
    argv = ["--method", "DCHMT", "--dataset", "synthetic", "--output-dim", str(K_BITS),
            "--data-dir", data, "--save-dir", out, "--epochs", "2",
            "--batch-size", str(TRAIN_BATCH), "--query-num", str(TRAIN_QUERY),
            "--train-num", str(TRAIN_SPLIT), "--eval-batch", "256", "--pretrained", init,
            "--display-step", "1", "--save-model", "--num-workers", "4", "--device", "cuda"]
    reset_counts()
    t0 = time.perf_counter()
    trainer = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    say("train", model="ViT-B/32 DCHMT K=64 fp32", items=TRAIN_ITEMS, train=TRAIN_SPLIT,
        query=TRAIN_QUERY, batch=TRAIN_BATCH, epochs=2, dataset_write_s=round(data_s, 2),
        cli_s=round(seconds, 2), **launches)
    state.update(trainer=trainer, params0=params0, train_launches=launches)


def check_served_codes(phase, trainer, pretrained, margin_of, **cfg_kw):
    """The saved weights serve: ``Retriever.from_pretrained`` on
    ``pretrained`` encodes the query split to the trainer's own codes, the
    text side as the method encodes it (MITH under its key-padding mask).
    A bit may differ only where ``margin_of(kind, retriever, cfg, x)``, the
    relaxed code's distance from a flip, is below MARGIN."""
    import torch

    from ccmh_torch.config import Config
    from ccmh_torch.retrieval import Retriever

    q_img, q_txt, _ = trainer.get_code(trainer.query_loader, len(trainer.query_data))
    batches = list(trainer.query_loader)
    images = np.concatenate([b["image"] for b in batches])
    ids = np.concatenate([b["text"] for b in batches])
    cfg = Config(method=trainer.cfg.method, output_dim=K_BITS,
                 max_words=trainer.cfg.max_words, pretrained=pretrained, **cfg_kw)
    retriever = Retriever.from_pretrained(cfg, device="cuda")
    differ, near = 0, 0
    for kind, x, codes, want in (("image", images, retriever.encode_images(images), q_img),
                                 ("text", ids, retriever.encode_texts(ids), q_txt)):
        with torch.inference_mode():
            margin = np.concatenate([
                margin_of(kind, retriever, cfg, torch.from_numpy(x[i:i + BATCH]).cuda()).cpu().numpy()
                for i in range(0, len(x), BATCH)])
        bad = codes != want
        differ += int(bad.sum())
        near += int((margin < MARGIN).sum())
        check(np.all(margin[bad] < MARGIN), f"served {trainer.cfg.method} {kind} codes differ "
                                            f"from the trainer's at margin >= {MARGIN}")
    say(phase, method=trainer.cfg.method, served_codes_vs_trainer="agree",
        bits=q_img.size + q_txt.size, differing_bits=differ, bits_with_margin_below_1e_3=near)


def check_training(state):
    from ccmh_torch.models.heads import select_hash
    from ccmh_torch.train.methods.base import image_embeds, text_embeds
    from ccmh_torch.train.optim import tree_leaves_with_path

    trainer, launches = state["trainer"], state["train_launches"]
    check(launches["fused_attention_fwd"] > 0, "training never launched the forward kernel")
    check(launches["fused_attention_bwd"] > 0, "training never launched the backward kernel")
    save_dir = trainer.cfg.save_dir
    with open(os.path.join(save_dir, "metrics.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    losses = [r["loss"] for r in records if r["event"] == "train"]
    steps = 2 * (TRAIN_SPLIT // TRAIN_BATCH)
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"step losses {losses}")
    valid = [r for r in records if r["event"] == "valid"]
    with open(os.path.join(save_dir, "train.log")) as fh:
        log = fh.read()
    for epoch in (0, 1):
        check(f"[{epoch}/2], MAP(i->t): " in log and "MAP(t->i): " in log,
              f"no MAP lines of epoch {epoch} in train.log")
    start = dict(tree_leaves_with_path(state.pop("params0")))
    moved = _moved(start, trainer.state.params)
    check(moved == len(start), f"only {moved} of {len(start)} parameter leaves moved")
    say("train", step_losses=losses, map_i2t=[r["i2t"] for r in valid],
        map_t2i=[r["t2i"] for r in valid], leaves_moved=moved, leaves=len(start))

    # the saved weights serve the trainer's codes; a bit may differ only
    # where its select pair's margin is below MARGIN
    def pair_margin(kind, retriever, cfg, x):
        embeds = image_embeds if kind == "image" else text_embeds
        head = retriever.params["img_head" if kind == "image" else "txt_head"]
        pairs = select_hash(head, embeds(retriever.params, retriever.clip_cfg, x, cfg))
        return (pairs[..., 1] - pairs[..., 0]).abs()

    check_served_codes("train", trainer, os.path.join(save_dir, "model-1.npz"), pair_margin)


def beside_training(state):
    """The fused path's full-width gradient against the plain path's, and
    the train step's time (fp32, bf16) split into forward, backward and
    optimizer by CUDA events."""
    import torch

    from ccmh_torch.clip import model as cm
    from ccmh_torch.train.optim import tree_leaves_with_path

    trainer = state["trainer"]
    cfg, clip_cfg, method = trainer.cfg, trainer.clip_cfg, trainer.method
    batch = trainer._put(next(iter(trainer.train_loader)))
    paths, leaves = zip(*tree_leaves_with_path(trainer.state.params))
    out = {}
    for impl in ("fused", "plain"):
        cm.set_attn_impl(impl)
        try:
            gen = torch.Generator(device="cuda").manual_seed(0)
            loss, _ = method.make_loss_fn(cfg, clip_cfg)(trainer.state.params, None, {},
                                                        batch, gen)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            cm.set_attn_impl("fused")
        out[impl] = (loss.item(), [torch.zeros_like(p) if g is None else g
                                   for p, g in zip(leaves, grads)])
    (lf, gf), (lp, gp) = out["fused"], out["plain"]
    num = math.sqrt(sum(((a - b) ** 2).sum().item() for a, b in zip(gf, gp)))
    den = math.sqrt(sum((b ** 2).sum().item() for b in gp))
    rel = num / den
    worst = max(range(len(gp)), key=lambda i: ((gf[i] - gp[i]).norm() / gp[i].norm().clamp(min=1e-30)).item())
    check(abs(lf - lp) <= 1e-5 * max(1.0, abs(lp)), f"fused loss {lf} vs plain {lp}")
    check(rel <= GRAD_REL_TOL, f"fused vs plain gradient: relative norm {rel} > {GRAD_REL_TOL}")
    say("check", fused_vs_plain_loss=[lf, lp], gradient_rel_norm=rel, tol=GRAD_REL_TOL,
        worst_leaf="/".join(paths[worst]))
    del out, gf, gp

    # train step time at batch 128, split by CUDA events
    timings = {}
    for name, dtype, impl in (("fp32", "float32", "fused"), ("bf16", "bfloat16", "fused"),
                              ("fp32_plain_attention", "float32", "plain")):
        loss_fn = method.make_loss_fn(cfg.replace(compute_dtype=dtype), clip_cfg)
        cm.set_attn_impl(impl)
        try:
            timings[name] = time_train_steps(loss_fn, trainer.state, batch,
                                             [trainer.optimizer], steps=5, warm=2)
        finally:
            cm.set_attn_impl("fused")
    say("rates", train_step_batch=TRAIN_BATCH, **timings)
    return timings


# --------------------------------------------------------------------- phase 7

LH_OTHERS = ("DNpH", "DDBH", "DMsH_LN", "DScPH", "DDWSH")
LH_KERNELS = ("fused_attention_fwd", "fused_attention_bwd", "fused_layer_norm",
              "fused_add_layer_norm")


def _snapshot(tree):
    from ccmh_torch.train.optim import tree_leaves_with_path

    return {path: leaf.detach().clone() for path, leaf in tree_leaves_with_path(tree)}


def _moved(start, tree) -> int:
    import torch

    from ccmh_torch.train.optim import tree_leaves_with_path

    return sum(not torch.equal(leaf.detach(), start[path])
               for path, leaf in tree_leaves_with_path(tree))


def linear_hash_path(state):
    """``python -m ccmh_torch.cli`` in-process with ``--method DSPH``, the
    LayerNorm kernels on (the caller sets ``set_ln_impl("fused")``):
    ViT-B/32 K=64 fp32 from a seeded ``--pretrained`` init (proxies
    included) on phase 5's dataset, batch 128, 2 epochs with ``valid`` and
    ``--save-model`` (counted launches around it)."""
    import torch

    from ccmh_torch import cli
    from ccmh_torch.clip.model import ClipConfig, init_clip_params
    from ccmh_torch.config import Config
    from ccmh_torch.train.checkpoint import save_checkpoint
    from ccmh_torch.train.methods import get_method

    data = os.path.join(WORK, "train_data")      # written by phase 5
    init = os.path.join(WORK, "dsph_init.npz")
    gen = torch.Generator(device="cuda").manual_seed(6)
    heads, extra, aux = get_method("DSPH").init(
        gen, Config(method="DSPH", output_dim=K_BITS, nclass=24), ClipConfig())
    params0 = {"clip": init_clip_params(gen, ClipConfig()), **heads}
    save_checkpoint(init, params0, extra=extra, aux=aux)
    out = os.path.join(WORK, "dsph_out")
    argv = ["--method", "DSPH", "--dataset", "synthetic", "--output-dim", str(K_BITS),
            "--data-dir", data, "--save-dir", out, "--epochs", "2",
            "--batch-size", str(TRAIN_BATCH), "--query-num", str(TRAIN_QUERY),
            "--train-num", str(TRAIN_SPLIT), "--eval-batch", "256", "--pretrained", init,
            "--display-step", "1", "--save-model", "--num-workers", "4", "--device", "cuda"]
    reset_counts()
    t0 = time.perf_counter()
    trainer = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    say("linear_hash", model="ViT-B/32 DSPH K=64 fp32, LayerNorm kernels on", items=TRAIN_ITEMS,
        train=TRAIN_SPLIT, query=TRAIN_QUERY, batch=TRAIN_BATCH, epochs=2,
        cli_s=round(seconds, 2), **launches)
    state.update(dsph=trainer, dsph_params0=_snapshot(params0), dsph_extra0=_snapshot(extra),
                 lh_launches=launches)
    del params0, extra


def check_linear_hash(state):
    from ccmh_torch.models.heads import linear_hash
    from ccmh_torch.train.methods.base import image_embeds, text_embeds

    trainer, launches = state["dsph"], state["lh_launches"]
    for name in LH_KERNELS:
        check(launches[name] > 0, f"the DSPH CLI run never launched {name}")
    save_dir = trainer.cfg.save_dir
    with open(os.path.join(save_dir, "metrics.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    losses = [r["loss"] for r in records if r["event"] == "train"]
    steps = 2 * (TRAIN_SPLIT // TRAIN_BATCH)
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"DSPH step losses {losses}")
    valid = [r for r in records if r["event"] == "valid"]
    with open(os.path.join(save_dir, "train.log")) as fh:
        log = fh.read()
    for epoch in (0, 1):
        check(f"[{epoch}/2], MAP(i->t): " in log and "MAP(t->i): " in log,
              f"no MAP lines of epoch {epoch} in the DSPH train.log")
    params0, extra0 = state.pop("dsph_params0"), state.pop("dsph_extra0")
    moved, moved_extra = _moved(params0, trainer.state.params), _moved(extra0, trainer.state.extra)
    check(moved == len(params0), f"DSPH: only {moved} of {len(params0)} parameter leaves moved")
    check(moved_extra == len(extra0), f"DSPH: only {moved_extra} of {len(extra0)} extra leaves moved")
    say("linear_hash", step_losses=losses, map_i2t=[r["i2t"] for r in valid],
        map_t2i=[r["t2i"] for r in valid], leaves_moved=moved, leaves=len(params0),
        extra_leaves_moved=moved_extra, extra_leaves=len(extra0))

    # the saved weights serve the trainer's codes; a bit may differ only
    # where the relaxed code is within MARGIN of 0
    def code_margin(kind, retriever, cfg, x):
        embeds = image_embeds if kind == "image" else text_embeds
        head = retriever.params["img_head" if kind == "image" else "txt_head"]
        return linear_hash(head, embeds(retriever.params, retriever.clip_cfg, x, cfg)).abs()

    check_served_codes("linear_hash", trainer, os.path.join(save_dir, "model-1.npz"),
                       code_margin)


def other_linear_hash_methods(state):
    """DNpH, DDBH, DMsH_LN, DScPH and DDWSH, each for 2 train steps at full
    width through ``Trainer.train_epoch`` (ViT-B/32 K=64 fp32, random
    init, batch 128 over a 256-item train split of phase 5's dataset),
    counted launches around each."""
    import torch

    from ccmh_torch.cli import config_from_args
    from ccmh_torch.clip.model import ClipConfig
    from ccmh_torch.train.trainer import Trainer

    data = os.path.join(WORK, "train_data")
    results = {}
    for name in LH_OTHERS:
        argv = ["--method", name, "--dataset", "synthetic", "--output-dim", str(K_BITS),
                "--data-dir", data, "--save-dir", os.path.join(WORK, "lh_out"),
                "--epochs", "1", "--batch-size", str(TRAIN_BATCH),
                "--query-num", str(TRAIN_QUERY), "--train-num", str(2 * TRAIN_BATCH),
                "--display-step", "1", "--num-workers", "4"]
        trainer = Trainer(config_from_args(argv), clip_cfg=ClipConfig(), device="cuda")
        if name == "DMsH_LN":
            # at the label net's init every label pair of this data is
            # positive and the loss is exactly 0 (in ccmh too); unit-normal
            # weights and small biases make it mine pairs.  The label net
            # only shapes the masks, so it gets no gradient and moves by
            # weight decay alone, which needs non-zero values
            gen = torch.Generator(device="cuda").manual_seed(8)
            with torch.no_grad():
                for layer in trainer.state.params["label_net"].values():
                    for key, std in (("w", 1.0), ("b", 0.01)):
                        layer[key].copy_(std * torch.randn(layer[key].shape, generator=gen,
                                                           device="cuda"))
        start = _snapshot(trainer.state.params)
        reset_counts()
        t0 = time.perf_counter()
        trainer.train_epoch(0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        with open(os.path.join(trainer.cfg.save_dir, "metrics.jsonl")) as fh:
            losses = [r["loss"] for r in map(json.loads, fh) if r["event"] == "train"]
        moved = _moved(start, trainer.state.params)
        for kernel in LH_KERNELS:
            check(launches[kernel] > 0, f"{name} never launched {kernel}")
        check(len(losses) == 2 and all(math.isfinite(x) for x in losses),
              f"{name} step losses {losses}")
        check(trainer.state.step == 2 and moved == len(start),
              f"{name}: {trainer.state.step} steps, {moved} of {len(start)} leaves moved")
        results[name] = {"step_losses": losses, "leaves_moved": moved, "leaves": len(start),
                         "seconds": round(seconds, 2), **launches}
        say("linear_hash", method=name, **results[name])
        del trainer, start
        torch.cuda.empty_cache()
    return results


def beside_linear_hash(state):
    """The full-width DSPH loss and gradient (parameters and proxies) with
    the LayerNorm kernels against the plain LayerNorm at the same
    parameters and batch, and the DSPH train step's time at batch 128,
    fp32 and bf16, LN fused and plain in turns (plain, fused, fused,
    plain), split into forward, backward and optimizers by CUDA events."""
    import torch

    from ccmh_torch.clip import model as cm
    from ccmh_torch.train.optim import tree_leaves_with_path

    trainer = state["dsph"]
    cfg, clip_cfg, method, st = trainer.cfg, trainer.clip_cfg, trainer.method, trainer.state
    batch = trainer._put(next(iter(trainer.train_loader)))
    batch["epoch"] = torch.tensor(0, dtype=torch.int32, device="cuda")
    trees = list(tree_leaves_with_path(st.params)) + [
        (("extra",) + p, leaf) for p, leaf in tree_leaves_with_path(st.extra)]
    paths, leaves = zip(*trees)
    out = {}
    try:
        for impl in ("fused", "plain"):
            cm.set_ln_impl(impl)
            gen = torch.Generator(device="cuda").manual_seed(0)
            loss, _ = method.make_loss_fn(cfg, clip_cfg)(st.params, st.extra, st.aux, batch, gen)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            out[impl] = (loss.item(), [torch.zeros_like(p) if g is None else g
                                       for p, g in zip(leaves, grads)])
    finally:
        cm.set_ln_impl("plain")
    (lf, gf), (lp, gp) = out["fused"], out["plain"]
    num = math.sqrt(sum(((a - b) ** 2).sum().item() for a, b in zip(gf, gp)))
    den = math.sqrt(sum((b ** 2).sum().item() for b in gp))
    rel = num / den
    worst = max(range(len(gp)), key=lambda i: ((gf[i] - gp[i]).norm() / gp[i].norm().clamp(min=1e-30)).item())
    check(abs(lf - lp) <= 1e-5 * max(1.0, abs(lp)), f"DSPH fused-LN loss {lf} vs plain {lp}")
    check(rel <= GRAD_REL_TOL, f"DSPH fused vs plain LN gradient: relative norm {rel} > {GRAD_REL_TOL}")
    say("check", dsph_fused_vs_plain_ln_loss=[lf, lp], gradient_rel_norm=rel, tol=GRAD_REL_TOL,
        worst_leaf="/".join(paths[worst]))
    del out, gf, gp

    opts = [trainer.optimizer] + ([trainer.extra_optimizer] if trainer.extra_optimizer else [])
    runs = []
    try:
        for name, dtype in (("fp32", "float32"), ("bf16", "bfloat16")):
            loss_fn = method.make_loss_fn(cfg.replace(compute_dtype=dtype), clip_cfg)
            for impl in ("plain", "fused", "fused", "plain"):
                cm.set_ln_impl(impl)
                runs.append({"dtype": name, "ln": impl,
                             **time_train_steps(loss_fn, st, batch, opts, steps=8, warm=2)})
    finally:
        cm.set_ln_impl("plain")
    say("rates", dsph_train_step_batch=TRAIN_BATCH, runs=runs)
    return runs


# --------------------------------------------------------------------- phase 9

ABLATION = ("backward_x", "forward_stacked", "backward_savedp", "backward_merged",
            "backward_headpair")
ABLATION_SOURCES = {   # (source, the TPU kernel it replaces)
    "backward_x": ("ccmh_torch/csrc/attention_bwd_x.cu", "tools/bench_attn_bwd.py:202"),
    "forward_stacked": ("ccmh_torch/csrc/attention_fwd_stacked.cu",
                        "tools/bench_attn_bwd.py:258"),
    "backward_savedp": ("ccmh_torch/csrc/attention_savedp.cu", "tools/bench_attn_bwd.py:322"),
    "backward_merged": ("ccmh_torch/csrc/attention_merged.cu", "tools/bench_attn_bwd.py:404"),
    "backward_headpair": ("ccmh_torch/csrc/attention_bwd_x.cu", "tools/bench_attn_bwd.py:470"),
}


def ablation_path():
    """``python -m ccmh_torch.tools.bench_attn_bwd --quick`` in-process
    (counted launches around it): every variant at vision and text, bf16
    and fp32, with its checks.  Its JSON lines go to a file beside the
    other outputs; the card's times per variant are summed up here."""
    import contextlib

    import torch

    from ccmh_torch.tools import bench_attn_bwd as bench

    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, "bench_attn_bwd.jsonl")
    reset_counts()
    t0 = time.perf_counter()
    with open(path, "w") as fh, contextlib.redirect_stdout(fh):
        rc = bench.main(["--quick"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    with open(path) as fh:
        rows = [json.loads(line) for line in fh if line.startswith("{")]
    check(rc == 0, f"the ablation bench exited {rc}")
    check(len(rows) == 64, f"the ablation bench printed {len(rows)} variants, not 16 x 4")
    for kernel in ABLATION + ("fused_attention_fwd", "fused_attention_bwd"):
        check(launches[kernel] > 0, f"the ablation bench never launched {kernel}")
    check(all(r["us_per_call"] is not None and r["us_per_call"] > 0 for r in rows),
          "an ablation variant has no device time")
    say("ablation", entry="python -m ccmh_torch.tools.bench_attn_bwd --quick",
        seconds=round(seconds, 2), variants=len(rows), **launches)
    for key in sorted({(r["shape"], r["dtype"]) for r in rows}):
        mine = [r for r in rows if (r["shape"], r["dtype"]) == key]
        say("ablation", shape=key[0], dtype=key[1],
            us_per_call={r["variant"]: round(r["us_per_call"], 2) for r in mine},
            bound_us={r["variant"]: round(r["bound_us"], 2) for r in mine},
            sdpa_fwd_us=mine[0]["library_us"], sdpa_bwd_us=mine[2]["library_us"])
    return launches


def _variant_call(kernel, qkv, mask, g, H, bb, mode, probs=None):
    """(kernel call, plain call) of one ablation kernel on these inputs
    (#8: from ``probs``, or the probabilities ``savedp_probs`` saves)."""
    from ccmh_torch.ops import attention_variants as av

    if kernel == "backward_x":
        return (lambda: av.backward_x(qkv, mask, g, H, bb, mode),
                lambda: av.backward_x_reference(qkv, mask, g, H, mode))
    if kernel == "forward_stacked":
        return (lambda: av.forward_stacked(qkv, mask, H, bb),
                lambda: av.forward_stacked_reference(qkv, mask, H))
    if kernel == "backward_savedp":
        if probs is None:
            probs = av.savedp_probs(qkv, mask, H)
        return (lambda: av.backward_savedp(qkv, mask, g, H, bb, probs=probs),
                lambda: av.backward_savedp_reference(qkv, probs, g, H))
    if kernel == "backward_merged":
        m = av.merged_mask(mask, qkv.shape[1], bb, device=qkv.device)
        return (lambda: av.backward_merged(qkv, mask, g, H, bb, mask=m),
                lambda: av.backward_merged_reference(qkv, m, g, H, bb))
    return (lambda: av.backward_headpair(qkv, mask, g, H, bb),
            lambda: av.backward_headpair_reference(qkv, mask, g, H))


def variant_entry(kernel, qkv, mask, g, H, bb, mode=None):
    """A zero-argument call of one of #6 (in ``mode``) - #10 through its
    C entry, with the arguments its wrapper passes (#9: ``mask`` is the
    [R, R] merged mask, and the plan ``_merged_plan`` makes; #8: ``mask``
    is the saved probabilities; #6, #8 and #10: the entry and arguments
    ``_bwd_x_entry`` or ``_savedp_entry`` gives) and a preallocated output:
    the kernel's own time, without the wrapper's Python checks."""
    import torch

    from ccmh_torch.ops import attention_variants as av

    B, L, D3 = qkv.shape
    Dh = D3 // 3 // H
    if kernel == "forward_stacked":
        out = torch.empty((B, L, D3 // 3), dtype=qkv.dtype, device=qkv.device)
        lib, name, ptrs, ints = ("attention_fwd_stacked", "ccmh_attention_fwd_stacked",
                                 (qkv, mask, out), (bb,))
    elif kernel == "backward_merged":
        out = torch.empty_like(qkv)
        lib, name, ptrs, ints = ("attention_merged", "ccmh_attention_bwd_merged",
                                 (qkv, mask, g, out),
                                 (bb, *av._merged_plan(bb * L, Dh, qkv.element_size())))
    elif kernel == "backward_savedp":
        out = torch.empty_like(qkv)
        lib, name, ints = av._savedp_entry(L, Dh, qkv.element_size(), bb, mask.data_ptr())
        ptrs = (qkv, mask, g, out)
    else:
        out = torch.empty_like(qkv)
        lib, name, ints = av._bwd_x_entry(mode or "headpair", L, Dh, qkv.element_size(), bb)
        ptrs = (qkv, mask, g, out)
    _, fn = av._entry(lib, name, len(ptrs), 4 + len(ints))
    args = (qkv.device.index, *(av._ptr(p) for p in ptrs), B, L, H, Dh, *ints,
            1.0 / math.sqrt(Dh), av._DTYPE_CODES[qkv.dtype],
            torch.cuda.current_stream(qkv.device).cuda_stream)

    def call():
        code = fn(*args)
        if code:
            fail(f"{name}: CUDA error {code}")
    return call


def _variant_err(kernel, mode, got, want, D):
    """Max abs error and the output scale it is held against: the forward
    absolutely (as kernel #1), a backward relative to its output's scale;
    fewstores on the dk slot it writes."""
    if mode == "fewstores":
        got, want = got[..., D:2 * D], want[..., D:2 * D]
    err = (got.float() - want.float()).abs().max().item()
    scale = 1.0 if kernel == "forward_stacked" else max(1.0, want.float().abs().max().item())
    return err, scale


def variant_case(kernel, name, L, H, causal, dtype, bb, mode, sdpa):
    """One ablation kernel against its plain version at a bench shape
    (B=256, Dh=64), with ms per call beside its bound, the plain version's
    ms and SDPA's where it computes the same function.  Each is timed at
    its C entry as min over 3 of (t_240 - t_40) / 200 chained calls, the
    wrapper and the plan of #6, #8, #9 and #10 beside."""
    import torch

    from ccmh_torch.ops import attention_variants as av
    from ccmh_torch.tools.bench_attn_bwd import bound_us, causal_bias, cost

    B, Dh = 256, 64
    D = H * Dh
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(L * 1000 + H + 2)
    qkv = torch.randn((B, L, 3 * D), generator=gen, device=dev).to(dtype)
    g = torch.randn((B, L, D), generator=gen, device=dev).to(dtype)
    mask = causal_bias(L, dev) if causal else None
    tname = "float32" if dtype == torch.float32 else "bfloat16"
    probs = av.savedp_probs(qkv, mask, H) if kernel == "backward_savedp" else None
    fn, plain = _variant_call(kernel, qkv, mask, g, H, bb, mode, probs)
    with torch.no_grad():
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err, scale = _variant_err(kernel, mode, got, want, D)
        del got, want
        check(math.isfinite(err) and err <= ATTN_TOL[tname] * scale,
              f"{kernel} {mode or ''} bb={bb} {name} {tname}: max abs err {err} > "
              f"{ATTN_TOL[tname]} x {scale}")
        m = mask
        if kernel == "backward_merged":
            m = av.merged_mask(mask, L, bb, device=dev)
        elif kernel == "backward_savedp":
            m = probs
        ms = steady_ms(variant_entry(kernel, qkv, m, g, H, bb, mode))
        timing = {"wrapper_ms": steady_ms(fn), "timed": "C entry, steady"}
        if kernel == "backward_merged":
            plan = av._merged_plan(bb * L, Dh, qkv.element_size())
            timing["plan"] = {"key_block": plan.key_block,
                              "path": av.MERGED_PATHS[plan.path],
                              "smem_bytes": plan.smem_bytes}
        elif kernel == "backward_savedp":
            timing["plan"] = savedp_plan(qkv, probs, H)
        elif kernel != "forward_stacked":
            timing["plan"] = bwd_x_plan(mode, L, Dh, qkv.element_size(), bb)
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
    forward = kernel == "forward_stacked"
    n_bytes, n_ops = cost(kernel, B, L, H, Dh, qkv.element_size(), causal, bb, mode or "full")
    bound, bound_by = bound_us(n_bytes, n_ops, dtype, kernel)
    same = mode is None or mode in av.SAME_FUNCTION_MODES
    if kernel == "backward_savedp":
        library, lib_ms = "none: no PyTorch call takes saved probabilities", None
    elif not same:
        library, lib_ms = f"none: mode {mode} is not the attention function", None
    elif forward:
        library, lib_ms = "SDPA fwd", sdpa[0]
    else:
        library, lib_ms = "SDPA fwd+bwd minus SDPA fwd", sdpa[1]
    case = {"case": f"{name} {tname}" + (f" {mode}" if mode else "") + f" bb={bb}",
            "shape": [B, L, 3 * D], "heads": H, "causal": causal, "bb": bb, "mode": mode,
            "max_abs_err": err, "output_scale": scale, "tol": ATTN_TOL[tname], "ms": ms,
            **timing, "plain_ms": plain_ms, "library_ms": lib_ms, "library": library,
            "bound_ms": bound / 1e3, "bound_by": bound_by}
    say("kernel", kernel=kernel, **case)
    return case


def bwd_x_plan(mode, L, Dh, itemsize, bb) -> dict:
    """The plan #6 (in ``mode``) or #10 (``mode`` None) takes, as its
    wrapper makes it."""
    from ccmh_torch.ops import attention_variants as av

    plan = av._bwd_x_plan(mode or "headpair", L, Dh, itemsize, bb)
    return {"path": av.BWD_X_PATHS[plan.path], "groups": plan.groups,
            "smem_bytes": plan.smem_bytes}


def savedp_plan(qkv, probs, H) -> dict:
    """The plan #8 takes for these probabilities, as its wrapper makes it."""
    from ccmh_torch.ops import attention_variants as av

    L, Dh = qkv.shape[1], qkv.shape[2] // 3 // H
    plan = av._savedp_plan(L, Dh, qkv.element_size(), probs.data_ptr())
    return {"path": av.SAVEDP_PATHS[plan.path], "width": plan.width,
            "smem_bytes": plan.smem_bytes}


def ablation_kernel_cases():
    """Each of #6-#10 against its plain version at the bench's shapes,
    fp32 and bf16: #6 in all eight modes at bb=4 and ``stacked`` at bb=8,
    #7 at bb=16, #8 and #10 at bb=4, #9 at bb=2 and 4 (R = 100 / 200
    vision, 64 / 128 text)."""
    import torch

    from ccmh_torch.ops import attention_variants as av
    from ccmh_torch.tools import bench_attn_bwd as bench

    cases = {k: [] for k in ABLATION}
    for dt in (torch.float32, torch.bfloat16):
        for name, L, H, causal in (("vision", 50, 12, False), ("text", 32, 8, True)):
            x = torch.randn((256, L, 3 * H * 64), device="cuda").to(dt)
            sdpa = bench.sdpa_yardstick(x, causal, H, (3, 23), 3)   # (fwd, bwd) ms
            del x
            for mode, bb in [(m, 4) for m in av.MODES] + [("stacked", 8)]:
                cases["backward_x"].append(
                    variant_case("backward_x", name, L, H, causal, dt, bb, mode, sdpa))
            for kernel, bbs in (("forward_stacked", (16,)), ("backward_savedp", (4,)),
                                ("backward_merged", (2, 4)), ("backward_headpair", (4,))):
                for bb in bbs:
                    cases[kernel].append(
                        variant_case(kernel, name, L, H, causal, dt, bb, None, sdpa))
            torch.cuda.empty_cache()
    return cases


def ablation_edges():
    """#6-#10 at edge shapes (L=77 causal at bb=2, Dh=30 at an odd bb=3,
    L=1 at bb=B), every mode of #6, fp32 and bf16; #9 at R = 256 (L=32
    causal, bb=8: four warps a tile, recomputed), R = 112 (L=56, bb=2: kept
    tiles) and R = 256 with Dh=128 (fp32: the operands streamed from device
    memory), #7 at L=77 with Dh=30 (the 128-row class on scalar loads), #6
    in every mode, #8 and #10 at L = Dh = 128 and at L=120 causal (fp32:
    #6's and #10's recompute path, #8's stream path), each with the path it
    took (#8 at every shape, with its probability copy width); and the
    refusals: odd H for #10 and ``pair``,
    R > 256 for #9, a bb that does not divide B, and fp16 raise and launch
    nothing."""
    import torch

    from ccmh_torch.ops import attention_variants as av
    from ccmh_torch.tools.bench_attn_bwd import causal_bias

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    shapes = ((4, 77, 8, 64, True, 2), (6, 13, 4, 30, False, 3), (5, 1, 2, 64, False, 5))
    calls = [("backward_x", m) for m in av.MODES] + [(k, None) for k in ABLATION[1:]]
    # (shape, the kernels it runs): #9's largest R, a kept R of 112 and the
    # largest R at Dh=128, #7 at L=77 on scalar loads, #6, #8 and #10 where
    # fp32 leaves the tiles (L = Dh = 128, L = 120)
    bwd_x = [("backward_x", m) for m in av.MODES] + [("backward_headpair", None),
                                                     ("backward_savedp", None)]
    shapes_for = [(s, calls) for s in shapes] + [
        ((8, 32, 8, 64, True, 8), [("backward_merged", None)]),
        ((4, 56, 4, 64, False, 2), [("backward_merged", None)]),
        ((2, 128, 2, 128, False, 2), [("backward_merged", None)] + bwd_x),
        ((4, 120, 2, 64, True, 2), bwd_x),
        ((4, 77, 4, 30, True, 2), [("forward_stacked", None)])]
    worst, paths = {}, []
    with torch.no_grad():
        for (B, L, H, Dh, causal, bb), kernels in shapes_for:
            for dtype in (torch.float32, torch.bfloat16):
                tname = "float32" if dtype == torch.float32 else "bfloat16"
                qkv = torch.randn((B, L, 3 * H * Dh), generator=gen, device=dev).to(dtype)
                g = torch.randn((B, L, H * Dh), generator=gen, device=dev).to(dtype)
                m = causal_bias(L, dev) if causal else None
                loads = "vector" if Dh * qkv.element_size() % 16 == 0 else "scalar"
                for kernel, mode in kernels:
                    if kernel == "backward_merged":
                        plan = av._merged_plan(bb * L, Dh, qkv.element_size())
                        paths.append({"kernel": kernel, "R": bb * L, "Dh": Dh, "dtype": tname,
                                      "key_block": plan.key_block,
                                      "path": av.MERGED_PATHS[plan.path], "loads": loads})
                    elif kernel == "forward_stacked":
                        paths.append({"kernel": kernel, "L": L, "Dh": Dh, "dtype": tname,
                                      "loads": loads})
                    elif kernel == "backward_headpair" or mode == "full":
                        paths.append({"kernel": kernel, "L": L, "Dh": Dh, "dtype": tname,
                                      **bwd_x_plan(mode, L, Dh, qkv.element_size(), bb),
                                      "loads": loads})
                    probs = None
                    if kernel == "backward_savedp":
                        probs = av.savedp_probs(qkv, m, H)
                        paths.append({"kernel": kernel, "L": L, "Dh": Dh, "dtype": tname,
                                      **savedp_plan(qkv, probs, H), "loads": loads})
                    fn, plain = _variant_call(kernel, qkv, m, g, H, bb, mode, probs)
                    err, scale = _variant_err(kernel, mode, fn(), plain(), H * Dh)
                    check(math.isfinite(err) and err <= ATTN_TOL[tname] * scale,
                          f"{kernel} {mode} at {(B, L, H, Dh, causal, bb)} {tname}: "
                          f"err {err} > {ATTN_TOL[tname]} x {scale}")
                    key = f"{kernel}{':' + mode if mode else ''} {tname}"
                    worst[key] = max(worst.get(key, 0.0), err / scale)

    x = torch.zeros((4, 8, 3 * 48), device=dev)
    gx = torch.zeros((4, 8, 48), device=dev)
    xv = torch.zeros((8, 50, 3 * 64), device=dev)
    gv = torch.zeros((8, 50, 64), device=dev)
    refused = 0
    for call in (
        lambda: av.backward_headpair(x, None, gx, 3, 1),                   # odd H
        lambda: av.backward_x(x, None, gx, 3, 1, "pair"),                  # odd H
        lambda: av.backward_merged(xv, None, gv, 1, 8),                    # R = 400
        lambda: av.backward_x(x, None, gx, 4, 3, "full"),                  # 4 % 3
        lambda: av.forward_stacked(x, None, 4, 3),                         # 4 % 3
        lambda: av.backward_savedp(x.half(), None, gx.half(), 4, 1),       # fp16
        lambda: av.backward_x(x.half(), None, gx.half(), 4, 1, "full"),    # fp16
    ):
        before = read_counts()
        try:
            call()
        except (ValueError, TypeError):
            refused += 1
        check(read_counts() == before, "a refused ablation input launched")
    check(refused == 7, f"only {refused} of 7 unsupported ablation inputs raised")
    say("edges", ablation_shapes=[list(s) for s, _ in shapes_for],
        ablation_worst_err_over_scale=worst, ablation_paths=paths, ablation_refusals=refused)


# -------------------------------------------------------------------- phase 10

TOKEN_KERNELS = ("fused_attention_fwd", "fused_attention_bwd", "fused_layer_norm",
                 "fused_add_layer_norm")
TOKEN_OTHERS = ("DPSIH", "DHaPH")
MITH_EVAL_BATCH = 256


def mith_launches(steps: int, eval_batches: int, clip_cfg, mith_cfg) -> dict:
    """The kernel launches a MITH CLI run implies.  Attention #1: the vision
    tower's blocks but its last (which returns its attention weights, so
    takes the plain formulation), no text block (the per-example
    key-padding bias takes the plain formulation), and every block of the
    two concept transformers (L = K, no mask); #2 once for each #1 of a
    train step.  LayerNorm #4 and #5 (``set_ln_impl("fused")``): once per
    block of both towers and both concept transformers.  An eval batch
    encodes both towers, the train step's forward once more."""
    concept = 2 * mith_cfg.transformer_layers
    attn_fwd = (clip_cfg.vision_layers - 1) + concept
    ln = clip_cfg.vision_layers + clip_cfg.transformer_layers + concept
    return {"fused_attention_fwd": (steps + eval_batches) * attn_fwd,
            "fused_attention_bwd": steps * attn_fwd,
            "fused_layer_norm": (steps + eval_batches) * ln,
            "fused_add_layer_norm": (steps + eval_batches) * ln}


def mith_path(state):
    """``python -m ccmh_torch.cli --method MITH`` in-process, the LayerNorm
    kernels on (the caller sets ``set_ln_impl("fused")``): ViT-B/32 K=64
    fp32 from a seeded ``--pretrained`` init (the four code buffers in its
    aux) on phase 5's dataset, batch 128, 1 epoch with ``valid`` and
    ``--save-model`` (counted launches around it)."""
    import torch

    from ccmh_torch import cli
    from ccmh_torch.clip.model import ClipConfig, init_clip_params
    from ccmh_torch.config import Config
    from ccmh_torch.train.checkpoint import save_checkpoint
    from ccmh_torch.train.methods import get_method

    data = os.path.join(WORK, "train_data")      # written by phase 5
    init = os.path.join(WORK, "mith_init.npz")
    gen = torch.Generator(device="cuda").manual_seed(12)
    cfg = Config(method="MITH", output_dim=K_BITS, nclass=24, train_num=TRAIN_SPLIT)
    heads, _, aux = get_method("MITH").init(gen, cfg, ClipConfig())
    params0 = {"clip": init_clip_params(gen, ClipConfig()), **heads}
    save_checkpoint(init, params0, aux=aux)
    out = os.path.join(WORK, "mith_out")
    argv = ["--method", "MITH", "--dataset", "synthetic", "--output-dim", str(K_BITS),
            "--data-dir", data, "--save-dir", out, "--epochs", "1",
            "--batch-size", str(TRAIN_BATCH), "--query-num", str(TRAIN_QUERY),
            "--train-num", str(TRAIN_SPLIT), "--eval-batch", str(MITH_EVAL_BATCH),
            "--pretrained", init, "--display-step", "1", "--save-model", "--num-workers", "4",
            "--device", "cuda"]
    reset_counts()
    t0 = time.perf_counter()
    trainer = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    say("token_methods", model="ViT-B/32 MITH K=64 fp32, LayerNorm kernels on",
        items=TRAIN_ITEMS, train=TRAIN_SPLIT, query=TRAIN_QUERY, batch=TRAIN_BATCH, epochs=1,
        cli_s=round(seconds, 2), **launches)
    state.update(mith=trainer, mith_params0=_snapshot(params0),
                 mith_buffers0=_snapshot(aux["buffers"]), token_launches=launches)
    del params0, aux


def check_mith(state):
    import torch

    from ccmh_torch.train.methods import mith as mith_method

    trainer, launches = state["mith"], state["token_launches"]
    steps = -(-TRAIN_SPLIT // TRAIN_BATCH)
    eval_batches = sum(-(-len(ds) // MITH_EVAL_BATCH)
                       for ds in (trainer.query_data, trainer.retrieval_data))
    want = mith_launches(steps, eval_batches, trainer.clip_cfg, trainer.cfg.mith)
    for name, n in want.items():
        check(launches[name] == n, f"MITH CLI run: {launches[name]} launches of {name}, "
                                   f"the code implies {n} ({steps} steps, {eval_batches} "
                                   "eval batches)")
    check(launches["hamming_distance_packed"] == 0 and all(
        launches[k] == 0 for k in ABLATION), f"MITH CLI run launched other kernels: {launches}")
    save_dir = trainer.cfg.save_dir
    with open(os.path.join(save_dir, "metrics.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    losses = [r["loss"] for r in records if r["event"] == "train"]
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"MITH step losses {losses}")
    valid = [r for r in records if r["event"] == "valid"]
    with open(os.path.join(save_dir, "train.log")) as fh:
        check("[0/1], MAP(i->t): " in fh.read(), "no MAP line in the MITH train.log")
    params0 = state.pop("mith_params0")
    moved = _moved(params0, trainer.state.params)
    check(moved == len(params0), f"MITH: only {moved} of {len(params0)} parameter leaves moved")
    # every train item's row of the four buffers took its codes (one epoch
    # covers the split): changed, and tanh codes in [-1, 1]
    buffers0 = state.pop("mith_buffers0")
    rows = torch.arange(len(trainer.train_data), device="cuda")
    for path, start in buffers0.items():
        buf = trainer.state.aux["buffers"][path[0]]
        changed = (buf[rows] != start[rows]).any(1)
        check(bool(changed.all()) and float(buf[rows].abs().max()) <= 1.0,
              f"MITH buffer {path[0]}: {int(changed.sum())} of {len(rows)} rows written")
    say("token_methods", method="MITH", step_losses=losses, map_i2t=[r["i2t"] for r in valid],
        map_t2i=[r["t2i"] for r in valid], leaves_moved=moved, leaves=len(params0),
        buffer_rows_written=len(rows), launches_as_implied=want)

    # the saved weights serve the trainer's codes, the text side under its
    # key-padding mask; a bit may differ only where tokens_hash + cls_hash
    # is within MARGIN of 0
    def mith_margin(kind, retriever, cfg, x):
        bits = mith_method._image_bits if kind == "image" else mith_method._text_bits
        return bits(retriever.params, x, cfg, retriever.clip_cfg).abs()

    check_served_codes("token_methods", trainer, os.path.join(save_dir, "model-0.npz"),
                       mith_margin, train_num=TRAIN_SPLIT)


def other_token_methods(state):
    """DPSIH and DHaPH, 2 train steps each at full width through
    ``Trainer.train_epoch`` (ViT-B/32 K=64 fp32, random init, batch 128
    over a 256-item train split of phase 5's dataset), counted launches
    around the steps, then ``valid``.  DPSIH's mAP comes through its
    ``dist_fn`` and a ``HashIndex`` built with it answers a search; DHaPH's
    HPmodel and LCAs move under AdamW."""
    import torch

    from ccmh_torch.cli import config_from_args
    from ccmh_torch.clip.model import ClipConfig
    from ccmh_torch.retrieval import HashIndex
    from ccmh_torch.train.trainer import Trainer

    data = os.path.join(WORK, "train_data")
    results = {}
    for name in TOKEN_OTHERS:
        argv = ["--method", name, "--dataset", "synthetic", "--output-dim", str(K_BITS),
                "--data-dir", data, "--save-dir", os.path.join(WORK, f"{name}_out"),
                "--epochs", "1", "--batch-size", str(TRAIN_BATCH),
                "--query-num", str(TRAIN_QUERY), "--train-num", str(2 * TRAIN_BATCH),
                "--eval-batch", "256", "--display-step", "1", "--num-workers", "4"]
        trainer = Trainer(config_from_args(argv), clip_cfg=ClipConfig(), device="cuda")
        start = _snapshot(trainer.state.params)
        extra0 = _snapshot(trainer.state.extra) if trainer.state.extra is not None else {}
        reset_counts()
        t0 = time.perf_counter()
        trainer.train_epoch(0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        with open(os.path.join(trainer.cfg.save_dir, "metrics.jsonl")) as fh:
            losses = [r["loss"] for r in map(json.loads, fh) if r["event"] == "train"]
        moved = _moved(start, trainer.state.params)
        for kernel in ("fused_attention_fwd", "fused_attention_bwd"):
            check(launches[kernel] > 0, f"{name} never launched {kernel}")
        check(len(losses) == 2 and all(math.isfinite(x) for x in losses),
              f"{name} step losses {losses}")
        check(trainer.state.step == 2 and moved == len(start),
              f"{name}: {trainer.state.step} steps, {moved} of {len(start)} leaves moved")
        result = {"step_losses": losses, "leaves_moved": moved, "leaves": len(start),
                  "seconds": round(seconds, 2), **launches}
        if name == "DHaPH":
            moved_extra = _moved(extra0, trainer.state.extra)
            check(trainer.extra_optimizer is not None and moved_extra == len(extra0),
                  f"DHaPH: {moved_extra} of {len(extra0)} HPmodel/LCA leaves moved")
            result.update(extra_leaves_moved=moved_extra, extra_leaves=len(extra0))

        # valid, the ranking through the method's distance where it has one
        calls = {"dist_fn": 0}
        dist_fn = trainer.eval_dist_fn
        if dist_fn is not None:
            def counted(q, r):
                calls["dist_fn"] += 1
                return dist_fn(q, r)
            trainer.eval_dist_fn = counted
        i2t, t2i, i2i, t2t = trainer.valid(0)
        check(all(math.isfinite(x) and 0 < x <= 1 for x in (i2t, t2i, i2i, t2t)),
              f"{name} valid mAPs {(i2t, t2i, i2i, t2t)}")
        result.update(map_i2t=i2t, map_t2i=t2i, dist_fn_calls=calls["dist_fn"])
        if name == "DPSIH":
            check(calls["dist_fn"] >= 4, f"DPSIH valid ranked {calls['dist_fn']} times "
                                         "through its dist_fn")
            q_img, q_txt, _ = trainer.get_code(trainer.query_loader, len(trainer.query_data))
            r_img, _, _ = trainer.get_code(trainer.retrieval_loader, len(trainer.retrieval_data))
            check(q_img.shape[1] == 4 * K_BITS, f"DPSIH codes {q_img.shape}")
            index = HashIndex(r_img, dist_fn=dist_fn, max_dist=K_BITS, device="cuda")
            dist, idx = index.search(q_txt, 10)
            with torch.inference_mode():
                full = dist_fn(torch.from_numpy(q_txt).cuda(), torch.from_numpy(r_img).cuda())
                want = torch.sort(full, dim=1, stable=True)
            check(np.array_equal(dist, want.values[:, :10].cpu().numpy())
                  and np.array_equal(idx, want.indices[:, :10].int().cpu().numpy()),
                  "DPSIH HashIndex search differs from the sorted dist_fn ranking")
            result.update(search="agrees with the sorted dist_fn ranking",
                          index_items=len(index))
        results[name] = result
        say("token_methods", method=name, **result)
        state[f"{name.lower()}_trainer"] = trainer
        del start, extra0
    return results


def beside_token_methods(state):
    """The full-width MITH loss and gradient with the kernels (attention
    and LayerNorm) against the plain attention and LayerNorm at the same
    parameters and batch, and the MITH, DPSIH and DHaPH step ms at batch
    128 in fp32 and bf16 (the path's setting: attention and LayerNorm
    kernels on), split into forward, backward and optimizers by CUDA
    events."""
    import torch

    from ccmh_torch.clip import model as cm
    from ccmh_torch.train.optim import tree_leaves_with_path

    trainer = state["mith"]
    cfg, clip_cfg, method, st = trainer.cfg, trainer.clip_cfg, trainer.method, trainer.state
    batch = trainer._put(next(iter(trainer.train_loader)))
    paths, leaves = zip(*tree_leaves_with_path(st.params))
    out = {}
    try:
        for impl in ("fused", "plain"):
            cm.set_attn_impl(impl)
            cm.set_ln_impl(impl)
            loss, _ = method.make_loss_fn(cfg, clip_cfg)(st.params, None, st.aux, batch, None)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            out[impl] = (loss.item(), [torch.zeros_like(p) if g is None else g
                                       for p, g in zip(leaves, grads)])
    finally:
        cm.set_attn_impl("fused")
        cm.set_ln_impl("plain")
    (lf, gf), (lp, gp) = out["fused"], out["plain"]
    num = math.sqrt(sum(((a - b) ** 2).sum().item() for a, b in zip(gf, gp)))
    den = math.sqrt(sum((b ** 2).sum().item() for b in gp))
    rel = num / den
    worst = max(range(len(gp)), key=lambda i: ((gf[i] - gp[i]).norm() / gp[i].norm().clamp(min=1e-30)).item())
    check(abs(lf - lp) <= 1e-5 * max(1.0, abs(lp)), f"MITH kernels' loss {lf} vs plain {lp}")
    check(rel <= GRAD_REL_TOL, f"MITH kernels vs plain gradient: relative norm {rel} > {GRAD_REL_TOL}")
    say("check", mith_kernels_vs_plain_loss=[lf, lp], gradient_rel_norm=rel, tol=GRAD_REL_TOL,
        worst_leaf="/".join(map(str, paths[worst])))
    del out, gf, gp

    timings = {}
    cm.set_ln_impl("fused")
    try:
        for name, tr in (("MITH", trainer), ("DPSIH", state["dpsih_trainer"]),
                         ("DHaPH", state["dhaph_trainer"])):
            opts = [tr.optimizer] + ([tr.extra_optimizer] if tr.extra_optimizer else [])
            batch = tr._put(next(iter(tr.train_loader)))
            batch["epoch"] = torch.tensor(0, dtype=torch.int32, device="cuda")
            for dname, dtype in (("fp32", "float32"), ("bf16", "bfloat16")):
                loss_fn = tr.method.make_loss_fn(tr.cfg.replace(compute_dtype=dtype), tr.clip_cfg)
                timings[f"{name}_{dname}"] = time_train_steps(
                    loss_fn, tr.state, batch, opts, steps=4, warm=2,
                    grad_clip=tr.method.grad_clip)
    finally:
        cm.set_ln_impl("plain")
    say("rates", token_methods_train_step_batch=TRAIN_BATCH, ln="fused", **timings)
    return timings


# --------------------------------------------------------------------- main

def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs one CUDA card",
              file=sys.stderr)
        return 2
    try:
        import ccmh_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the ccmh_torch package is not beside this script ({exc})",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    say("card", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])
    phase_build()

    # the towers' shapes at batch 256, and MITH's concept transformers
    # (L = K bits, no mask) at its batch of 128
    path_shapes = (("vision", 256, 50, 12, False), ("text", 256, 32, 8, True),
                   ("concept K=16", TRAIN_BATCH, 16, 8, False),
                   ("concept K=64", TRAIN_BATCH, 64, 8, False))
    attn_cases = [attention_case(n, B, L, H, causal, dt)
                  for dt in (torch.float32, torch.bfloat16) for n, B, L, H, causal in path_shapes]
    bwd_cases = [attention_bwd_case(n, B, L, H, causal, dt)
                 for dt in (torch.float32, torch.bfloat16) for n, B, L, H, causal in path_shapes]
    ham_case = hamming_case()
    ln_shapes = (("vision", 256 * 50, 768), ("text", 256 * 32, 512))
    ln_cases = [layernorm_case(n, rows, W, dt, add=False)
                for dt in (torch.float32, torch.bfloat16) for n, rows, W in ln_shapes]
    add_ln_cases = [layernorm_case(n, rows, W, dt, add=True)
                    for dt in (torch.float32, torch.bfloat16) for n, rows, W in ln_shapes]
    edge_checks()
    layernorm_edges()
    torch.cuda.empty_cache()

    # the serving path (slice 1), its counts set to 0 just before it
    state = {}
    reset_counts()
    serving_path(state)
    serving = read_counts()
    say("launches", path="serving", **serving)
    check(serving["fused_attention_fwd"] > 0, "the serving path never launched the attention kernel")
    check(serving["hamming_distance_packed"] > 0, "the serving path never launched the hamming kernel")
    beside_the_path(state)
    layernorm_beside_serving(state)
    for key in ("retriever", "index", "gallery", "images"):
        state.pop(key, None)
    torch.cuda.empty_cache()

    # the training path (slice 2): training_path resets the counts just
    # before it calls the CLI and reads them just after
    training_path(state)
    training = state["train_launches"]
    say("launches", path="training", **training)
    check_training(state)
    beside_training(state)
    state.pop("trainer")
    torch.cuda.empty_cache()

    # the LinearHash path (slice 3) with the LayerNorm kernels on:
    # linear_hash_path resets the counts just before it calls the CLI and
    # reads them just after; each other method counts its own two steps
    from ccmh_torch.clip import model as cm

    cm.set_ln_impl("fused")
    try:
        linear_hash_path(state)
        linear_hash = state["lh_launches"]
        say("launches", path="linear_hash", **linear_hash)
        check_linear_hash(state)
        other_linear_hash_methods(state)
    finally:
        cm.set_ln_impl("plain")
    beside_linear_hash(state)
    state.pop("dsph", None)
    torch.cuda.empty_cache()

    # the ablation path (slice 4): ablation_path resets the counts just
    # before it calls the bench's main and reads them just after
    t9 = time.perf_counter()
    ablation = ablation_path()
    say("launches", path="attn_ablation", **ablation)
    variant_cases = ablation_kernel_cases()
    ablation_edges()
    say("ablation", phase_seconds=round(time.perf_counter() - t9, 1))
    torch.cuda.empty_cache()

    # the token-level methods (slice 7) with the LayerNorm kernels on:
    # mith_path resets the counts just before it calls the CLI and reads
    # them just after; DPSIH and DHaPH count their own two steps
    t10 = time.perf_counter()
    cm.set_ln_impl("fused")
    try:
        mith_path(state)
        token = state["token_launches"]
        say("launches", path="token_methods", **token)
        check_mith(state)
        other_token_methods(state)
    finally:
        cm.set_ln_impl("plain")
    beside_token_methods(state)
    for key in ("mith", "dpsih_trainer", "dhaph_trainer"):
        state.pop(key, None)
    torch.cuda.empty_cache()
    say("token_methods", phase_seconds=round(time.perf_counter() - t10, 1))

    by_path = {k: {"serving": serving[k], "training": training[k],
                   "linear_hash": linear_hash[k], "attn_ablation": ablation[k],
                   "token_methods": token[k]}
               for k in serving}

    def entry(name, source, replaces, launches, cases):
        top = cases[0]   # vision fp32 (the default's dominant call) or the search
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "launches_by_path": by_path[name],
                "max_abs_err": top["max_abs_err"], "ms": top["ms"],
                "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
                "bound_by": top["bound_by"], "library_ms": top["library_ms"],
                **({"library": top["library"]} if "library" in top else {}),
                "cases": cases}

    kernels = [
        entry("fused_attention_fwd", "ccmh_torch/csrc/attention.cu",
              "ccmh/ops/attention.py:123", training["fused_attention_fwd"], attn_cases),
        entry("fused_attention_bwd", "ccmh_torch/csrc/attention_bwd.cu",
              "ccmh/ops/attention.py:235", training["fused_attention_bwd"], bwd_cases),
        entry("hamming_distance_packed", "ccmh_torch/csrc/hamming.cu",
              "ccmh/ops/hamming.py:56", serving["hamming_distance_packed"], [ham_case]),
        entry("fused_layer_norm", "ccmh_torch/csrc/layernorm.cu",
              "ccmh/ops/layernorm.py:63", linear_hash["fused_layer_norm"], ln_cases),
        entry("fused_add_layer_norm", "ccmh_torch/csrc/layernorm.cu",
              "ccmh/ops/layernorm.py:80", linear_hash["fused_add_layer_norm"], add_ln_cases),
    ] + [entry(name, *ABLATION_SOURCES[name], ablation[name], variant_cases[name])
         for name in ABLATION]
    say("done", seconds=round(time.perf_counter() - t_start, 1))
    shutil.rmtree(WORK, ignore_errors=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
