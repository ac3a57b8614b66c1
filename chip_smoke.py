#!/usr/bin/env python3
"""Drive the ccmh_torch serving and training paths on one NVIDIA card and
check them: DCHMT serving, DCHMT training, LinearHash training with the
LayerNorm kernels, the token-level methods (MITH, DPSIH, DHaPH), the
methods with extra state (DNPH, DPBE, DGHDGH, TwDH), the lifecycle of a
model (tower import, preemption and resume, ``--test``, export), the
real-data input path, the towers past 128 tokens (ViT-L/14), and the
ModifiedResNet tower (RN50).

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
   backward and optimizer device time by CUDA events;
11. the four methods with extra state, LayerNorm kernels on, each at
   ViT-B/32 from a random init on phase 5's dataset (batch 128, a
   256-item train split, 2 steps and ``valid``), counters set to 0 just
   before each run and read just after: DNPH through ``ccmh_torch.cli.main``
   with ``--save-model`` (proxies frozen, as the reference) and again with
   ``dnph.step_proxies``; DPBE; DGHDGH fused and ``sequenced``; TwDH at
   K=512 with the shipped mirflickr centres and its per-length
   ``valid_multi``.  It checks the launches of #1, #2, #4 and #5 against
   the counts the code implies, finite losses and mAPs, every trained
   leaf moved (the proxies only when stepped), the Hessians, BatchNorm
   stats and J meters, and that each saved ``.npz`` serves the trainer's
   codes (TwDH in chunks of the eval batch, whose BatchNorm statistics its
   image codes follow).  Then each one's step ms at batch 128 in fp32 and
   bf16 (forward, backward and optimizers by CUDA events; DGHDGH's
   sequenced step whole) and the host ms of DNPH's two Hungarian
   assignments;
12. the lifecycle, LayerNorm kernels on, counters set to 0 just before
   each run and read just after: a seeded ViT-B/32 init written as an
   OpenAI-layout ``.pt`` and read back through ``--clip-path`` bit for
   bit; DSPH K=64 fp32 through ``ccmh_torch.cli.main`` on phase 5's
   dataset (batch 128, 2 epochs of 4 steps, ``valid``, ``--save-model``,
   ``--checkpoint-every 1``): run A twice (the two must end in the same
   bits), run B cut by a real SIGTERM after global step 5 and resumed with
   ``--resume``, run C the same with ``--async-checkpoint`` cut at epoch
   0's last step; B and C held to A bit for bit (parameters, ``extra``,
   ``aux``, both optimizers, the generator, the step, the trackers, every
   ``train`` and ``valid`` row); then ``--test --pretrained`` A's
   ``model-1.npz``: the exact mAPs within 4 ulps of the plain CPU
   computation on the dumped codes, the histograms on the card equal to
   the CPU's, the curve files and ``python -m ccmh_torch.ops.pr_curve``'s
   within 1e-12 of ``ops.pr_curve`` on the CPU; ``python -m
   ccmh_torch.clip.export_ref`` of A's ``.npz`` to a reference ``.pth``,
   whose ``--test`` codes equal the ``.npz``'s.  The launches of #1, #2,
   #4, #5 equal the counts the code implies, none for a skipped step.  It
   prints the bytes of one slot, the ms a synchronous and an asynchronous
   save block the loop, a resume's load ms and ``test()``'s encode, mAP
   and curve ms;
13. the real-data input path, LayerNorm kernels on: a 12,000-item JPEG
   dataset at MIRFlickr-25K's split sizes, decoded on the card's host
   and held to the fixtures' PIL decodes, BPE rates, four transports and
   a streamed and a resident epoch bit for bit, JPEG serving, encode at
   prefetch depth 1 and 2 (``[input]`` lines);
14. the towers past 128 tokens: the long path of #1 and #2 at ViT-B/16
   (B=256, L=197, H=12), ViT-L/14 (B=64, L=257, H=16) and ViT-L/14@336
   (B=64, L=577, H=16), fp32 and bf16, and at the edges L in {1, 129,
   143, 192, 256, 577} causal and key-padded (each call one launch,
   within the gates of phase 2); #3 at K = 512 and 2,048 bits (Q = 512,
   N = 2^18, exact); then, counters set to 0 just before each run and
   read just after: ``python -m ccmh_torch.tools.bench_vitl 64`` (pairs/s,
   TFLOP/s); ViT-L/14 DSPH K=64 fp32 through ``ccmh_torch.cli.main`` from a
   seeded OpenAI-layout ``.pt`` via ``--clip-path``, batch 32, 2 steps
   with remat off, ``--remat`` and ``--remat --set remat_policy=dots``
   (losses, parameters and every gradient bit-equal; peak memory and step
   ms each; #1 twice a block a step under remat), its ``.npz`` serving the
   trainer's codes and a packed K=512 index ranking as the int8 one;
   batch 128 with ``--remat`` and bf16 moments; ViT-B/16 from a ``.pt``,
   its ``.npz`` serving; ViT-B/32 with bf16 moments cut by SIGTERM and
   resumed bit for bit, and ``--profile`` leaving a trace and the same
   losses (``[long]`` lines);
15. OpenAI's RN50 CLIP at full width (the ModifiedResNet tower: stages of
   3, 4, 6 and 3 bottlenecks, a 32-head attention pool; cuDNN convolutions
   in true fp32 and bf16; BatchNorm on trained statistics) from a seeded
   OpenAI-layout ``.pt``, LayerNorm kernels on, counters set to 0 just
   before each run and read just after: the ``.pt`` read back bit for bit;
   the card's fp32 embedding of 4 images within 1e-4 (relative norm) of
   the port's on the CPU; DCHMT K=64 served from an ``.npz`` through
   ``Retriever.from_pretrained`` (2,048 images at batch 256 in fp32 and
   bf16, items/s; bf16 embeddings at a cosine >= 0.999 of fp32; the
   captions; a 512-query search over 2^20 packed codes; HTTP encode and
   search, each equal to the direct call); DSPH and DCHMT K=64 through
   ``ccmh_torch.cli.main --clip-path`` at batch 128, 2 steps each with fp32
   and bf16 towers (launches of #1, #2, #4, #5 as the text tower implies,
   finite losses, every leaf moved, BatchNorm's mean and var included,
   DSPH's ``.npz`` serving the trainer's codes, peak memory, the step
   split by CUDA events; cuDNN's default algorithms and the deterministic
   ones the port sets: the same gradient bits twice? (the deterministic
   ones must) and the step ms); DSPH cut by SIGTERM after step 3 and
   resumed, bit-equal to the uninterrupted run (``[rn]`` lines).

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
import re
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
    for by_family in (attn.launches_by_family, attn.backward_launches_by_family):
        for family in by_family:
            by_family[family] = 0
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


def family_counts() -> dict:
    """#1's and #2's launches by the kernel family their C entries took
    (short, long_mma, long_wgmma) since the counts were last set to 0."""
    from ccmh_torch.ops import attention as attn

    return {"fused_attention_fwd": dict(attn.launches_by_family),
            "fused_attention_bwd": dict(attn.backward_launches_by_family)}


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
        lambda: attn.fused_attention(torch.zeros((1, attn.MAX_SEQ + 1, 192), device=dev),
                                     None, 1),
        lambda: attn.fused_attention(torch.zeros((1, 5, 192), device=dev,
                                                 dtype=torch.float16), None, 3),
        lambda: ham.hamming_distance_packed(
            torch.zeros((2, ham.MAX_LANES + 1), device=dev, dtype=torch.int32),
            torch.zeros((2, ham.MAX_LANES + 1), device=dev, dtype=torch.int32)),
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


def check_served_codes(phase, trainer, pretrained, margin_of, k_bits=K_BITS, **cfg_kw):
    """The saved weights serve: ``Retriever.from_pretrained`` on
    ``pretrained`` encodes the query split to the trainer's own codes, the
    text side as the method encodes it (MITH under its key-padding mask),
    in chunks of BATCH.  A bit may differ only where ``margin_of(kind,
    retriever, cfg, x)``, the relaxed code's distance from a flip, is below
    MARGIN."""
    import torch

    from ccmh_torch.config import Config
    from ccmh_torch.retrieval import Retriever

    q_img, q_txt, _ = trainer.get_code(trainer.query_loader, len(trainer.query_data))
    batches = list(trainer.query_loader)
    images = np.concatenate([b["image"] for b in batches])
    ids = np.concatenate([b["text"] for b in batches])
    cfg = Config(method=trainer.cfg.method, output_dim=k_bits,
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


# -------------------------------------------------------------------- phase 11

# (label, method, --set overrides, K): the four methods with extra state
EXTRA_STATE_RUNS = (
    ("DNPH", "DNPH", (), K_BITS),
    ("DNPH_step_proxies", "DNPH", ("dnph.step_proxies=True",), K_BITS),
    ("DPBE", "DPBE", (), K_BITS),
    ("DGHDGH", "DGHDGH", (), K_BITS),
    ("DGHDGH_sequenced", "DGHDGH", ("dghdgh.sequenced=True",), K_BITS),
    # the shipped centres hold no 64-bit long code with short codes: 512
    # (short 16, 32, 64); mirflickr's 24 classes fit phase 5's dataset
    ("TwDH", "TwDH", ("twdh.center_path={twdh}",), 512),
)


def extra_state_launches(steps: int, eval_batches: int, clip_cfg) -> dict:
    """The kernel launches a run of the pooled-feature methods implies:
    #1 once per block of both towers in every forward (no key-padding
    bias, no attention weights returned), #2 once per #1 of a train step;
    #4 and #5 (``set_ln_impl("fused")``) once per block each.  A train step
    runs both towers once (DGHDGH's sequenced step too: phases B and C
    read detached codes), an eval batch encodes both towers."""
    per_pass = clip_cfg.vision_layers + clip_cfg.transformer_layers
    return {"fused_attention_fwd": (steps + eval_batches) * per_pass,
            "fused_attention_bwd": steps * per_pass,
            "fused_layer_norm": (steps + eval_batches) * per_pass,
            "fused_add_layer_norm": (steps + eval_batches) * per_pass}


def _extra_state_margin(trainer):
    """The served codes' distance from a flip, per method: the relaxed
    LinearHash code (DNPH, DGHDGH), the mean sampled code (DPBE), the
    softmax pair gap with the chunk's BatchNorm statistics (TwDH)."""
    from ccmh_torch.losses.dpbe import dpbe_encode_codes
    from ccmh_torch.models.heads import linear_hash
    from ccmh_torch.train.methods import dpbe as dpbe_method
    from ccmh_torch.train.methods import twdh as twdh_method
    from ccmh_torch.train.methods.base import image_embeds, text_embeds

    name = trainer.cfg.method

    def margin(kind, retriever, cfg, x):
        params, aux = retriever.params, retriever.aux
        embed = (image_embeds if kind == "image" else text_embeds)(
            params, retriever.clip_cfg, x, cfg)
        head = "img_head" if kind == "image" else "txt_head"
        if name == "DPBE":
            draws = dpbe_method.encode_draws(cfg, params, embed.device)[
                0 if kind == "image" else 1]
            hess = aux["hessian_i" if kind == "image" else "hessian_t"]
            return dpbe_encode_codes(embed, params[head], hess, draws).abs()
        if name == "TwDH":
            code = (twdh_method._image_long(params, aux, embed)[0] if kind == "image"
                    else twdh_method._text_long(params, embed))
            pairs = code.reshape(code.shape[0], -1, 2)
            return (pairs[..., 1] - pairs[..., 0]).abs()
        return linear_hash(params[head], embed).abs()
    return margin


def time_custom_steps(step_fn, st, batch, steps: int, warm: int) -> dict:
    """Host ms per step of a method's own step (DGHDGH's sequenced three
    phases) and its device ms between CUDA events around it."""
    import torch

    t_host = t_dev = 0.0
    for i in range(warm + steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        ev[0].record()
        st, _ = step_fn(st, batch)
        ev[1].record()
        torch.cuda.synchronize()
        if i >= warm:
            t_host += time.perf_counter() - h0
            t_dev += ev[0].elapsed_time(ev[1])
    return {"step_ms": 1e3 * t_host / steps, "device_ms": t_dev / steps}


def extra_state_method(label, name, sets, k_bits, timings):
    """One of the four methods with extra state at full width (ViT-B/32,
    random init, batch 128 over a 256-item train split of phase 5's
    dataset, LayerNorm kernels on): 2 train steps and ``valid`` (TwDH's
    ``valid_multi`` too), through ``python -m ccmh_torch.cli`` with
    ``--save-model`` for DNPH (its init as ``--pretrained``), through
    ``Trainer`` for the others, counted launches around it.  Checks the launches against the implied count,
    finite losses, every trained leaf moved (DNPH's proxies only with
    ``step_proxies``), the aux state, and that the saved ``.npz`` serves
    the trainer's codes.  Then the step ms at batch 128, fp32 and bf16."""
    import torch

    from ccmh_torch import cli
    from ccmh_torch.cli import config_from_args
    from ccmh_torch.clip.model import ClipConfig
    from ccmh_torch.losses import dnph_tomm
    from ccmh_torch.train.optim import tree_leaves_with_path
    from ccmh_torch.train.trainer import Trainer

    data = os.path.join(WORK, "train_data")      # written by phase 5
    twdh = os.path.join(REPO, "ccmh_torch", "assets", "twdh", "mirflickr.npz")
    out = os.path.join(WORK, f"{label}_out")
    argv = ["--method", name, "--dataset", "synthetic", "--output-dim", str(k_bits),
            "--data-dir", data, "--save-dir", out, "--epochs", "1",
            "--batch-size", str(TRAIN_BATCH), "--query-num", str(TRAIN_QUERY),
            # the eval batch is BATCH, the chunk the served codes take:
            # TwDH's image codes follow their chunk's BatchNorm statistics
            "--train-num", str(2 * TRAIN_BATCH), "--eval-batch", str(BATCH),
            "--display-step", "1", "--num-workers", "4", "--device", "cuda"]
    for item in sets:
        argv += ["--set", item.format(twdh=twdh)]
    trainer = Trainer(config_from_args(argv), clip_cfg=ClipConfig(), device="cuda")
    start = _snapshot(trainer.state.params)
    extra0 = _snapshot(trainer.state.extra) if trainer.state.extra is not None else {}
    aux0 = _snapshot(trainer.state.aux)
    via_cli = label == "DNPH"
    if via_cli:
        # the CLI run starts from this trainer's init, saved as --pretrained
        init = os.path.join(WORK, "dnph_init.npz")
        trainer.save_checkpoint(init)
        del trainer
        torch.cuda.empty_cache()
        reset_counts()
        t0 = time.perf_counter()
        trainer = cli.main(argv + ["--pretrained", init, "--save-model"])
    else:
        reset_counts()
        t0 = time.perf_counter()
        trainer.train_epoch(0)
        trainer.valid(0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()

    steps = trainer.state.step
    eval_batches = sum(-(-len(ds) // BATCH)
                       for ds in (trainer.query_data, trainer.retrieval_data))
    if trainer.method.multi_encode is not None:
        eval_batches *= 2          # valid_multi encodes both splits again
    want = extra_state_launches(steps, eval_batches, trainer.clip_cfg)
    for kernel, n in want.items():
        check(launches[kernel] == n, f"{label}: {launches[kernel]} launches of {kernel}, the "
                                     f"code implies {n} ({steps} steps, {eval_batches} eval "
                                     "batches)")
    check(launches["hamming_distance_packed"] == 0 and all(launches[k] == 0 for k in ABLATION),
          f"{label} launched other kernels: {launches}")
    with open(os.path.join(trainer.cfg.save_dir, "metrics.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    losses = [r["loss"] for r in records if r["event"] == "train"]
    check(steps == 2 and len(losses) == 2 and all(math.isfinite(x) for x in losses),
          f"{label}: {steps} steps, losses {losses}")
    valid = {r["event"]: r for r in records if r["event"].startswith("valid")}
    for event, r in valid.items():
        check(all(0 < r[k] <= 1 for k in ("i2t", "t2i", "i2i", "t2t")), f"{label} {event} {r}")

    # every trained leaf moved; TwDH's image-head v_b and out_b shift all
    # rows alike before its BatchNorm, which removes them: no gradient
    still = {("img_head", "v_b"), ("img_head", "out_b")} if name == "TwDH" else set()
    moved = sum(not torch.equal(leaf.detach(), start[p])
                for p, leaf in tree_leaves_with_path(trainer.state.params) if p not in still)
    check(moved == len(start) - len(still), f"{label}: {moved} of {len(start) - len(still)} "
                                            "parameter leaves moved")
    result = {"seconds": round(seconds, 2), "step_losses": losses, "leaves_moved": moved,
              "leaves": len(start), **launches, "launches_as_implied": want,
              **{f"map_{e}": [r["i2t"], r["t2i"]] for e, r in valid.items()}}
    if extra0:
        moved_extra = _moved(extra0, trainer.state.extra)
        frozen = label == "DNPH"       # the reference never steps their SGD
        check(moved_extra == (0 if frozen else len(extra0)),
              f"{label}: {moved_extra} of {len(extra0)} extra leaves moved")
        result.update(extra_leaves_moved=moved_extra, extra_leaves=len(extra0))
    aux = trainer.state.aux
    if name == "DPBE":
        moved_aux = _moved(aux0, aux)
        check(moved_aux == len(aux0), f"DPBE: {moved_aux} of {len(aux0)} Hessian leaves moved")
        result.update(hessian_leaves_moved=moved_aux)
    if name == "TwDH":
        check(int(aux["bn"]["count"]) == 2 and sorted(valid) == [
            "valid", "valid_long", "valid_short16", "valid_short32", "valid_short64"],
            f"TwDH: bn count {int(aux['bn']['count'])}, rows {sorted(valid)}")
    if name == "DGHDGH":
        check(float(aux["avg_count"]) == 2.0 and int(aux["epoch"]) == 0
              and math.isfinite(float(aux["j_gen_avg"])), f"DGHDGH meters {aux}")
    say("extra_state", method=label, k_bits=k_bits, **result)

    saved = os.path.join(trainer.cfg.save_dir, "model-0.npz")
    if not via_cli:
        trainer.save_checkpoint(saved)
    check_served_codes("extra_state", trainer, saved, _extra_state_margin(trainer),
                       k_bits=k_bits)

    # the step's time at batch 128, fp32 and bf16, LayerNorm fused
    tr = trainer
    batch = tr._put(next(iter(tr.train_loader)))
    batch["epoch"] = torch.tensor(0, dtype=torch.int32, device="cuda")
    opts = [tr.optimizer] + ([tr.extra_optimizer] if tr.extra_optimizer else [])
    for dname, dtype in (("fp32", "float32"), ("bf16", "bfloat16")):
        cfg = tr.cfg.replace(compute_dtype=dtype)
        custom = (tr.method.custom_step(cfg, tr.clip_cfg, tr.optimizer, tr.extra_optimizer)
                  if tr.method.custom_step else None)
        if custom is not None:
            timings[f"{label}_{dname}"] = time_custom_steps(custom, tr.state, batch,
                                                            steps=4, warm=2)
        else:
            timings[f"{label}_{dname}"] = time_train_steps(
                tr.method.make_loss_fn(cfg, tr.clip_cfg), tr.state, batch, opts, steps=4,
                warm=2, grad_clip=tr.method.grad_clip)
    if label == "DNPH":
        # the host's share: two assignments of [128, 64] codes a step
        codes = torch.tanh(torch.randn((TRAIN_BATCH, k_bits), device="cuda"))
        noise = dnph_tomm.random_signs(None, TRAIN_BATCH, k_bits, "cuda")
        timings["DNPH_hungarian_two_ms"] = 1e3 * host_s(
            lambda: [dnph_tomm.assign_noise(codes, noise) for _ in range(2)], reps=5)
    del trainer, tr, batch, opts
    torch.cuda.empty_cache()
    return launches


def extra_state_path():
    """Phase 11: each of EXTRA_STATE_RUNS with the LayerNorm kernels on;
    returns the launches summed over the runs (each run counted from 0)."""
    from ccmh_torch.clip import model as cm

    total, timings = {}, {}
    cm.set_ln_impl("fused")
    try:
        for label, name, sets, k_bits in EXTRA_STATE_RUNS:
            launches = extra_state_method(label, name, sets, k_bits, timings)
            for kernel, n in launches.items():
                total[kernel] = total.get(kernel, 0) + n
    finally:
        cm.set_ln_impl("plain")
    say("rates", extra_state_train_step_batch=TRAIN_BATCH, ln="fused", **timings)
    return total


# -------------------------------------------------------------------- phase 12

LIFECYCLE_KERNELS = ("fused_attention_fwd", "fused_attention_bwd", "fused_layer_norm",
                     "fused_add_layer_norm")
# metrics.jsonl fields that are host timings, not results
TIMING_FIELDS = ("time", "q_encoder_time", "r_encoder_time")


def _tree_diff(got, want, path="") -> list:
    """Paths where two trees (dicts, lists, tensors, numbers) differ."""
    import torch

    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return [path]
        return [d for k in want for d in _tree_diff(got[k], want[k], f"{path}/{k}")]
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            return [path]
        return [d for i, (g, w) in enumerate(zip(got, want))
                for d in _tree_diff(g, w, f"{path}[{i}]")]
    if isinstance(want, torch.Tensor):
        same = (isinstance(got, torch.Tensor) and got.shape == want.shape
                and got.dtype == want.dtype and torch.equal(got, want))
        return [] if same else [path]
    return [] if got == want else [path]


def _float_spread(got, want) -> float:
    """The largest |got - want| over two trees' float tensors."""
    import torch

    if isinstance(want, dict):
        return max([_float_spread(got[k], want[k]) for k in want] or [0.0])
    if isinstance(want, (list, tuple)):
        return max([_float_spread(g, w) for g, w in zip(got, want)] or [0.0])
    if isinstance(want, torch.Tensor) and want.is_floating_point():
        return float((got.double() - want.double()).abs().max()) if want.numel() else 0.0
    return 0.0


def _final_slot(save_dir):
    """The run's last full-state slot, its timing tracker set aside."""
    from ccmh_torch.train.checkpoint import load_state

    tree = load_state(os.path.join(save_dir, "state_ckpt"))
    tree["meta"].pop("total_time")
    return tree


def _metric_rows(save_dir):
    with open(os.path.join(save_dir, "metrics.jsonl")) as fh:
        return [{k: v for k, v in r.items() if k not in TIMING_FIELDS}
                for r in map(json.loads, fh)]


def _lifecycle_run(argv, timings, cut_at=None):
    """``ccmh_torch.cli.main(argv)`` in-process with its launches counted;
    ``cut_at`` sends this process a SIGTERM once global step ``cut_at`` is
    done.  The blocking ms of every full-state save and of the resume's
    load go into ``timings``."""
    import signal

    import torch

    from ccmh_torch import cli
    from ccmh_torch.train import trainer as trainer_mod

    make = trainer_mod.make_train_step
    save, resume = trainer_mod.Trainer.save_full_checkpoint, trainer_mod.Trainer.try_resume

    def make_cut(*args, **kw):
        inner = make(*args, **kw)

        def step_fn(state, batch):
            state, metrics = inner(state, batch)
            if state.step == cut_at:
                os.kill(os.getpid(), signal.SIGTERM)
            return state, metrics
        return step_fn

    def timed(fn, key):
        def run(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, *a, **kw)
            timings.setdefault(key, []).append(round(1e3 * (time.perf_counter() - t0), 1))
            return out
        return run

    key = "async_save_block_ms" if "--async-checkpoint" in argv else "sync_save_block_ms"
    trainer_mod.make_train_step = make_cut if cut_at else make
    trainer_mod.Trainer.save_full_checkpoint = timed(save, key)
    trainer_mod.Trainer.try_resume = timed(resume, "resume_load_ms")
    reset_counts()
    t0 = time.perf_counter()
    try:
        trainer = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        trainer_mod.make_train_step = make
        trainer_mod.Trainer.save_full_checkpoint = save
        trainer_mod.Trainer.try_resume = resume
    return trainer, read_counts(), time.perf_counter() - t0


def _lifecycle_launches(steps: int, eval_batches: int) -> dict:
    from ccmh_torch.clip.model import ClipConfig

    return extra_state_launches(steps, eval_batches, ClipConfig())


def _check_launches(what, launches, want, phase="lifecycle"):
    for kernel in LIFECYCLE_KERNELS:
        check(launches[kernel] == want[kernel], f"{phase} {what}: {launches[kernel]} launches "
                                                f"of {kernel}, the code implies {want[kernel]}")
    others = {k: n for k, n in launches.items() if k not in LIFECYCLE_KERNELS and n}
    check(not others, f"{phase} {what} launched other kernels: {others}")


def _test_maps(save_dir):
    import re

    with open(os.path.join(save_dir, "test.log")) as fh:
        found = re.findall(r"MAP\(i->t\): (\S+), MAP\(t->i\): (\S+), MAP\(t->t\): (\S+), "
                           r"MAP\(i->i\): (\S+)$", fh.read(), re.M)
    check(len(found) == 1, f"test.log holds {len(found)} mAP lines")
    return np.asarray(found[0], np.float64).astype(np.float32)      # i2t, t2i, t2t, i2i


def lifecycle_path():
    """Phase 12: a tower imported from an OpenAI-layout ``.pt``, DSPH
    trained (run A, twice), preempted by SIGTERM and resumed (B; C with
    asynchronous saves, preempted at an epoch's last step), each held to A
    bit for bit; ``--test`` on A's ``.npz`` with its exact mAP and curves
    held to the plain CPU computation; A exported to a reference ``.pth``
    and tested again.  LayerNorm kernels on; returns the summed launches."""
    import torch

    from ccmh_torch.clip import model as cm
    from ccmh_torch.clip.convert import load_clip_params
    from ccmh_torch.clip.export_ref import export_clip_state_dict
    from ccmh_torch.clip.model import ClipConfig, init_clip_params
    from ccmh_torch.ops.map_metric import calc_map_4way
    from ccmh_torch.ops.pr_curve import compute_hists, curves, default_topn
    from ccmh_torch.train.checkpoint import load_state
    from ccmh_torch.train.optim import tree_leaves_with_path

    work = os.path.join(WORK, "lifecycle")
    os.makedirs(work, exist_ok=True)
    data = os.path.join(WORK, "train_data")      # written by phase 5
    timings, total = {}, {}

    def add(launches):
        for kernel, n in launches.items():
            total[kernel] = total.get(kernel, 0) + n

    # 1. the random init as an OpenAI-layout .pt, read back through --clip-path
    tower = os.path.join(work, "tower.pt")
    clip0 = init_clip_params(torch.Generator(device="cuda").manual_seed(12), ClipConfig())
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                export_clip_state_dict(clip0, prefix="").items()}, tower)
    loaded, cfg = load_clip_params(tower, device="cuda")
    check(cfg == ClipConfig(), f"lifecycle: the tower .pt reads as {cfg}")
    want = dict(tree_leaves_with_path(clip0))
    check(all(torch.equal(leaf, want[p]) for p, leaf in tree_leaves_with_path(loaded))
          and len(want) == len(dict(tree_leaves_with_path(loaded))),
          "lifecycle: the tower read from the .pt differs from the init")
    del loaded, clip0, want

    base = ["--method", "DSPH", "--dataset", "synthetic", "--output-dim", str(K_BITS),
            "--data-dir", data, "--epochs", "2", "--batch-size", str(TRAIN_BATCH),
            "--query-num", str(TRAIN_QUERY), "--train-num", str(TRAIN_SPLIT),
            "--eval-batch", str(BATCH), "--clip-path", tower, "--display-step", "1",
            "--num-workers", "4", "--device", "cuda"]
    train = base + ["--checkpoint-every", "1", "--save-model"]

    def run_dir(name):
        return os.path.join(work, name, "DSPH", "synthetic", str(K_BITS))

    steps_per_epoch = TRAIN_SPLIT // TRAIN_BATCH
    eval_batches = -(-TRAIN_QUERY // BATCH) + -(-(TRAIN_ITEMS - TRAIN_QUERY) // BATCH)
    cm.set_ln_impl("fused")
    try:
        # 2. run A, uninterrupted, twice: the card's step is deterministic
        # when the two end in the same bits
        results = {}
        for name in ("A", "A2"):
            _, launches, seconds = _lifecycle_run(
                train + ["--save-dir", os.path.join(work, name)], timings)
            _check_launches(name, launches, _lifecycle_launches(2 * steps_per_epoch,
                                                                2 * eval_batches))
            add(launches)
            results[name] = round(seconds, 2)
        slot_a, rows_a = _final_slot(run_dir("A")), _metric_rows(run_dir("A"))
        slot_bytes = os.path.getsize(os.path.join(run_dir("A"), "state_ckpt", "e000001",
                                                  "state.pt"))
        slot_a2 = _final_slot(run_dir("A2"))
        diff = _tree_diff(slot_a2, slot_a) + (["metrics.jsonl"]
                                              if _metric_rows(run_dir("A2")) != rows_a else [])
        say("lifecycle", run="A twice", seconds=[results["A"], results["A2"]],
            differing=diff[:8], spread=_float_spread(slot_a2, slot_a))
        check(not diff, f"lifecycle: two uninterrupted runs differ at {diff[:8]}")
        del slot_a2
        shutil.rmtree(os.path.join(work, "A2"))

        # 3-4. B: SIGTERM after global step 5 (epoch 1 step 1), synchronous
        # saves; C: asynchronous saves, SIGTERM at epoch 0's last step
        for name, flags, cut, where in (("B", [], steps_per_epoch + 1, (1, 1)),
                                        ("C", ["--async-checkpoint"], steps_per_epoch,
                                         (0, steps_per_epoch))):
            argv = train + flags + ["--save-dir", os.path.join(work, name)]
            cut_tr, cut_launches, cut_s = _lifecycle_run(argv, timings, cut_at=cut)
            check(cut_tr.state.step == cut, f"lifecycle {name}: train() ran on to step "
                                            f"{cut_tr.state.step} after the SIGTERM")
            slot = load_state(os.path.join(run_dir(name), "state_ckpt"))
            got = (slot["epoch"], int(slot["meta"]["step_in_epoch"]))
            check(got == where, f"lifecycle {name}: the preemption slot is (epoch, step) {got}, "
                                f"not {where}")
            del cut_tr, slot
            torch.cuda.empty_cache()
            res_tr, res_launches, res_s = _lifecycle_run(argv + ["--resume"], timings)
            with open(os.path.join(run_dir(name), "train.log")) as fh:
                check(f"fast-forwarding {where[1]} steps" in fh.read(),
                      f"lifecycle {name}: the resumed run did not fast-forward")
            # before the cut: `cut` steps and epoch 0's valid when it was
            # reached; after: the remaining steps, no launch for the skipped
            valid_before = 1 if cut > steps_per_epoch else 0
            _check_launches(f"{name} cut", cut_launches,
                            _lifecycle_launches(cut, valid_before * eval_batches))
            _check_launches(f"{name} resumed", res_launches, _lifecycle_launches(
                2 * steps_per_epoch - cut, (2 - valid_before) * eval_batches))
            add(cut_launches)
            add(res_launches)
            slot_x = _final_slot(run_dir(name))
            diff = _tree_diff(slot_x, slot_a) + (
                ["metrics.jsonl"] if _metric_rows(run_dir(name)) != rows_a else [])
            check(not diff, f"lifecycle {name}: the resumed run differs from A at {diff[:8]}")
            say("lifecycle", run=name, cut_at_step=cut, slot=list(where),
                cut_s=round(cut_s, 2), resumed_s=round(res_s, 2),
                equal_to_A="params, extra, aux, both optimizers, generator, step, meta, "
                           "every train and valid row")
            del res_tr, slot_x
            torch.cuda.empty_cache()
            shutil.rmtree(os.path.join(work, name))
        del slot_a

        # 6. --test on A's .npz: the exact mAP and the curves against the
        # plain CPU computation on the dumped codes, and the curves CLI
        model = os.path.join(run_dir("A"), "model-1.npz")
        test_tr, test_launches, test_s = _lifecycle_run(
            base + ["--test", "--pretrained", model, "--save-dir", os.path.join(work, "T")],
            timings)
        _check_launches("--test", test_launches, _lifecycle_launches(0, eval_batches))
        add(test_launches)
        test_dir = run_dir("T")
        maps = _test_maps(test_dir)
        mat_path = os.path.join(test_dir, "PR_cruve", f"{K_BITS}-ours-synthetic-i2t.mat")
        import scipy.io as scio

        mat = scio.loadmat(mat_path)
        plain = np.asarray([float(x) for x in calc_map_4way(
            mat["q_img"], mat["q_txt"], mat["r_img"], mat["r_txt"], mat["q_l"], mat["r_l"],
            method="exact", n_bins=K_BITS + 1, device="cpu")], np.float32)[[0, 1, 3, 2]]
        ulps = np.abs(maps.view(np.int32) - plain.view(np.int32))
        check(np.all(ulps <= 4), f"lifecycle --test: exact mAPs {maps} vs plain CPU {plain}")
        ns = default_topn(mat["r_l"].shape[0])
        cli_out = os.path.join(work, "cli-curves.mat")
        out = subprocess.run([sys.executable, "-m", "ccmh_torch.ops.pr_curve", mat_path,
                              "--direction", "i2t", "-o", cli_out], capture_output=True,
                             text=True, timeout=300, cwd=REPO)
        check(out.returncode == 0, f"python -m ccmh_torch.ops.pr_curve failed: {out.stderr}")
        for direction, q, r in (("i2t", "q_img", "r_txt"), ("t2i", "q_txt", "r_img")):
            hists_cpu = compute_hists(mat[q], mat[r], mat["q_l"], mat["r_l"], device="cpu")
            hists_gpu = compute_hists(mat[q], mat[r], mat["q_l"], mat["r_l"], device="cuda")
            check(all(np.array_equal(a, b) for a, b in zip(hists_cpu, hists_gpu)),
                  f"lifecycle: {direction} histograms on the card differ from the CPU's")
            want = curves(mat[q], mat[r], mat["q_l"], mat["r_l"], ns, device="cpu")
            files = [os.path.join(test_dir, "PR_cruve", f"curves-{direction}.mat")]
            files += [cli_out] if direction == "i2t" else []
            for path in files:
                got = scio.loadmat(path)
                for key in ("precision", "recall", "p_at_n"):
                    err = float(np.abs(got[key].ravel() - want[key]).max())
                    check(err <= 1e-12, f"lifecycle: {os.path.basename(path)} {key} is {err} "
                                        "from the CPU's")
                check(np.array_equal(got["topn"].ravel(), want["topn"]), "topn")
        codes = {k: mat[k] for k in ("q_img", "q_txt", "r_img", "r_txt")}
        test_seconds = {k: round(1e3 * v, 1) for k, v in test_tr.test_seconds.items()}
        del test_tr

        # 7. A's .npz as a reference .pth through the export CLI, tested again
        pth = os.path.join(work, "m.pth")
        out = subprocess.run([sys.executable, "-m", "ccmh_torch.clip.export_ref", model,
                              "--method", "DSPH", "--output-dim", str(K_BITS), "-o", pth],
                             capture_output=True, text=True, timeout=300, cwd=REPO)
        check(out.returncode == 0, f"python -m ccmh_torch.clip.export_ref failed: {out.stderr}")
        _, pth_launches, _ = _lifecycle_run(
            base + ["--test", "--pretrained", pth, "--save-dir", os.path.join(work, "P")],
            timings)
        _check_launches("--test .pth", pth_launches, _lifecycle_launches(0, eval_batches))
        add(pth_launches)
        got = scio.loadmat(os.path.join(run_dir("P"), "PR_cruve",
                                        f"{K_BITS}-ours-synthetic-i2t.mat"))
        check(all(np.array_equal(got[k], v) for k, v in codes.items()),
              "lifecycle: the .pth's codes differ from the .npz's")
        check(np.array_equal(_test_maps(run_dir("P")), maps), "lifecycle: the .pth's mAPs differ")
    finally:
        cm.set_ln_impl("plain")
    say("lifecycle", run="test", maps_i2t_t2i_t2t_i2i=maps.tolist(), ulps_to_plain=ulps.tolist(),
        pth_codes="equal to the .npz's", slot_bytes=slot_bytes, test_ms=test_seconds,
        **timings)
    shutil.rmtree(work, ignore_errors=True)
    return total


# -------------------------------------------------------------------- phase 13

# MIRFlickr-25K's split sizes (query 2,000, train 10,000, retrieval 10,000)
INPUT_ITEMS, INPUT_QUERY, INPUT_TRAIN = 12000, 2000, 10000
INPUT_SIZES = ((375, 500), (500, 375))     # MIRFlickr's two orientations
INPUT_STEPS = 16                           # the transports' bit-equality run
INPUT_EVAL_BATCH = 256
# the card's decode of the fixtures against ccmh's PIL outputs, LSB at 224:
# libjpeg decodes as PIL does (ccmh's own gate, tests/test_native_loader.py);
# nvJPEG's IDCT is not libjpeg's integer one (PERF.md §4), so its gate is
# on the largest and the mean difference
INPUT_FIXTURE_TOL = {"libjpeg": {"max": 2, "mean": None}, "nvjpeg": {"max": 4, "mean": 0.5}}
INPUT_SERVE_FILES = 64


class _StopSteps(Exception):
    pass


def input_fixtures(native):
    """Gate 1: the committed fixtures decoded by the loader on this machine
    against ccmh's PIL outputs at 224 (``expected.npz``)."""
    fixture_dir = os.path.join(REPO, "ccmh_torch", "assets", "jpeg")
    names = sorted(f[:-4] for f in os.listdir(fixture_dir) if f.endswith(".jpg"))
    paths = [os.path.join(fixture_dir, f"{n}.jpg") for n in names]
    per, total, count = {}, 0.0, 0
    with np.load(os.path.join(fixture_dir, "expected.npz")) as expected:
        for mode in ("train", "eval"):
            got, ok = native.decode_batch_u8(paths, 224, mode == "train")
            check(ok.all(), f"input: the loader failed on fixtures {np.flatnonzero(~ok)}")
            for name, img in zip(names, got):
                diff = np.abs(img.astype(np.int32) - expected[f"{name}/{mode}"])
                per[f"{name}/{mode}"] = [int(diff.max()), round(float(diff.mean()), 4)]
                total += float(diff.sum())
                count += diff.size
    decoder = native.decoder()
    tol = INPUT_FIXTURE_TOL[decoder]
    worst, mean = max(v[0] for v in per.values()), total / count
    say("input", decoder=decoder, fixtures=len(names), max_lsb=worst, mean_lsb=round(mean, 4),
        tol=tol, per_fixture=per)
    check(worst <= tol["max"], f"input: fixture decode {worst} LSB from PIL > {tol['max']}")
    check(tol["mean"] is None or mean <= tol["mean"],
          f"input: fixture decode {mean:.4f} LSB from PIL on average > {tol['mean']}")
    return paths


def input_rates(native, paths, texts):
    """Gate 2's numbers: decode img/s of the batch entries at 1, 4 and all
    threads against one image per call on one thread, and native against
    Python BPE texts/s."""
    from ccmh_torch.tokenizer.bpe import tokenize_batch

    native.decode_batch_u8(paths[:16], 224, True)            # warm: build, contexts
    tokenize_batch(texts[:8], 32)                            # warm: build, vocab
    tokenize_batch(texts[:8], 32, use_native=False)
    rates = {"cpu_count": os.cpu_count()}
    for name, fn in (("decode_batch_u8", native.decode_batch_u8),
                     ("decode_batch", native.decode_batch)):
        for threads in (1, 4, os.cpu_count()):
            n = 128 if threads == 1 else 512
            t0 = time.perf_counter()
            _, ok = fn(paths[:n], 224, True, n_threads=threads)
            rates[f"{name}_t{threads}_img_s"] = round(n / (time.perf_counter() - t0), 1)
            check(ok.all(), f"input: {name} failed on the dataset")
    t0 = time.perf_counter()
    for p in paths[:128]:
        native.decode_batch_u8([p], 224, True, n_threads=1)
    rates["plain_one_per_call_img_s"] = round(128 / (time.perf_counter() - t0), 1)
    t0 = time.perf_counter()
    ids = tokenize_batch(texts, 32)
    rates["bpe_native_texts_s"] = round(len(texts) / (time.perf_counter() - t0), 1)
    t0 = time.perf_counter()
    py_ids = tokenize_batch(texts, 32, use_native=False)
    rates["bpe_python_texts_s"] = round(len(texts) / (time.perf_counter() - t0), 1)
    check(np.array_equal(ids, py_ids), "input: native and Python BPE ids differ")
    say("input", texts=len(texts), **rates)
    return rates


def _input_hooks(steps_taken, stop_after=None):
    """Patches for one run: a train step that times itself (host clock and
    CUDA events; the host gap before each call is time spent waiting on the
    batches) and stops after ``stop_after`` steps; the cache build and the
    resident pins timed."""
    import torch

    from ccmh_torch.data import cache as cache_mod
    from ccmh_torch.data import resident as res_mod
    from ccmh_torch.train import trainer as trainer_mod

    make, build, pin = trainer_mod.make_train_step, cache_mod.open_or_build, res_mod._pin
    rec = {"losses": [], "events": [], "gaps": [], "cache_s": [], "pins": []}

    def make_timed(*args, **kw):
        inner = make(*args, **kw)

        def step_fn(state, batch):
            t_in = time.perf_counter()
            if rec.get("t_out") is not None:
                rec["gaps"].append(t_in - rec["t_out"])
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            state, metrics = inner(state, batch)
            ev[1].record()
            rec["events"].append(ev)
            rec["losses"].append(metrics["loss"])
            steps_taken[0] += 1
            rec["t_out"] = time.perf_counter()
            if stop_after is not None and steps_taken[0] >= stop_after:
                raise _StopSteps()
            return state, metrics
        return step_fn

    def timed_build(*a, **kw):
        t0 = time.perf_counter()
        out = build(*a, **kw)
        rec["cache_s"].append(time.perf_counter() - t0)
        return out

    def timed_pin(arr, device, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pin(arr, device, *a, **kw)
        rec["pins"].append((arr.nbytes, time.perf_counter() - t0))
        return out

    patches = ((trainer_mod, "make_train_step", make_timed),
               (cache_mod, "open_or_build", timed_build), (res_mod, "_pin", timed_pin))
    return rec, patches


def _with(patches, fn):
    old = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, new in patches:
        setattr(mod, name, new)
    try:
        return fn()
    finally:
        for mod, name, value in old:
            setattr(mod, name, value)


def input_transports(data, work):
    """Gate 3: the first 16 steps of epoch 0 in four transports, bit-equal
    step losses and parameters after step 16."""
    import torch

    from ccmh_torch import cli
    from ccmh_torch.train.optim import tree_leaves_with_path
    from ccmh_torch.train.trainer import Trainer

    base = ["--method", "DSPH", "--dataset", "synthetic", "--output-dim", str(K_BITS),
            "--data-dir", data, "--epochs", "1", "--batch-size", str(TRAIN_BATCH),
            "--query-num", str(INPUT_QUERY), "--train-num", str(INPUT_TRAIN),
            "--eval-batch", str(INPUT_EVAL_BATCH), "--display-step", "1",
            "--num-workers", "8", "--device", "cuda"]
    cache_dir = os.path.join(work, "cache")
    row = 224 * 224 * 3
    # chunked: a budget under the 1.51 GB split, above two 512-row superblocks
    chunk_mb = 1024
    modes = (("streaming", ["--device-resident", "off"]),
             ("cached", ["--cache-images", "--cache-dir", cache_dir, "--device-resident", "off"]),
             ("resident", ["--cache-images", "--cache-dir", cache_dir, "--device-resident", "on"]),
             ("chunked", ["--cache-images", "--cache-dir", cache_dir, "--device-resident", "auto",
                          "--set", f"device_resident_budget_mb={chunk_mb}"]))
    want_losses = want_params = None
    out, launches = {}, {}
    for name, flags in modes:
        steps = [0]
        rec, patches = _input_hooks(steps, stop_after=INPUT_STEPS)

        def run():
            cfg = cli.config_from_args(base + flags + ["--save-dir", os.path.join(work, name)])
            t0 = time.perf_counter()
            tr = Trainer(cfg, device="cuda")
            init_s = time.perf_counter() - t0
            reset_counts()
            try:
                tr.train_epoch(0)
            except _StopSteps:
                pass
            torch.cuda.synchronize()
            return tr, init_s, read_counts()

        tr, init_s, counts = _with(patches, run)
        launches[name] = counts
        check(steps[0] == INPUT_STEPS, f"input {name}: {steps[0]} steps")
        losses = [float(l) for l in rec["losses"]]
        check(all(math.isfinite(l) for l in losses), f"input {name}: losses {losses}")
        ck = tr.train_chunked
        if name == "chunked":
            check(ck is not None and ck["R"] < INPUT_TRAIN
                  and ck["region"].nbytes + 2 * ck["M"] * row <= chunk_mb * 2**20,
                  f"input chunked: the plan {ck and (ck['R'], ck['M'])} is not chunked in budget")
        check((tr.train_resident is not None) == (name == "resident"),
              f"input {name}: train_resident {tr.train_resident is not None}")
        params = dict(tree_leaves_with_path(tr.state.params))
        if want_losses is None:
            want_losses = losses
            want_params = {k: v.detach().clone() for k, v in params.items()}
        else:
            check(losses == want_losses, f"input {name}: step losses {losses} differ from "
                                         f"streaming's {want_losses}")
            differing = [str(k) for k, v in params.items() if not torch.equal(v, want_params[k])]
            check(not differing and len(params) == len(want_params),
                  f"input {name}: parameters differ from streaming's at {differing[:6]}")
        out[name] = {"init_s": round(init_s, 2),
                     "cache_build_s": [round(s, 2) for s in rec["cache_s"]],
                     "pins_mib_s": [[round(b / 2**20, 1), round(s, 3)] for b, s in rec["pins"]],
                     **({"chunked_R_M": [ck["R"], ck["M"]]} if ck else {})}
        del tr, params
        torch.cuda.empty_cache()
    say("input", transports=list(out), steps=INPUT_STEPS, step_losses=want_losses,
        losses_and_parameters="bit-equal", **out)
    return launches, out


def input_epochs(data, work):
    """Gate 4: a whole epoch streamed and one resident (79 steps, a ragged
    last batch of 16) through ``ccmh_torch.cli.main``, each with ``valid``
    (streamed, then resident): bit-equal parameters, equal codes and mAPs;
    epoch seconds, step ms, device ms by CUDA events, idle share and the
    streamed epoch's share spent waiting on the batches."""
    import scipy.io as scio
    import torch

    from ccmh_torch import cli
    from ccmh_torch.train.optim import tree_leaves_with_path

    base = ["--method", "DSPH", "--dataset", "synthetic", "--output-dim", str(K_BITS),
            "--data-dir", data, "--epochs", "1", "--batch-size", str(TRAIN_BATCH),
            "--query-num", str(INPUT_QUERY), "--train-num", str(INPUT_TRAIN),
            "--eval-batch", str(INPUT_EVAL_BATCH), "--display-step", "100",
            "--num-workers", "8", "--device", "cuda"]
    cache_dir = os.path.join(work, "cache")
    runs = (("streaming", ["--device-resident", "off"]),
            ("resident", ["--cache-images", "--cache-dir", cache_dir, "--device-resident", "on",
                          "--save-model"]))
    results, trainers, launches = {}, {}, {}
    n_steps = -(-INPUT_TRAIN // TRAIN_BATCH)
    for name, flags in runs:
        steps = [0]
        rec, patches = _input_hooks(steps)
        save_dir = os.path.join(work, f"epoch_{name}")
        argv = base + flags + ["--save-dir", save_dir]

        def run():
            reset_counts()
            tr = cli.main(argv)
            torch.cuda.synchronize()
            return tr, read_counts()

        tr, counts = _with(patches, run)
        launches[name] = counts
        check(steps[0] == n_steps, f"input {name}: {steps[0]} steps, not {n_steps}")
        device_ms = sum(a.elapsed_time(b) for a, b in rec["events"])
        epoch_s = tr.total_time
        run_dir = os.path.join(save_dir, "DSPH", "synthetic", str(K_BITS))
        with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
            valid = [r for r in map(json.loads, fh) if r["event"] == "valid"]
        check(len(valid) == 1, f"input {name}: {len(valid)} valid rows")
        results[name] = {
            "epoch_s": round(epoch_s, 2), "steps": steps[0],
            "step_ms_host": round(1e3 * epoch_s / steps[0], 1),
            "step_ms_device": round(device_ms / steps[0], 1),
            "idle_share": round(1 - device_ms / 1e3 / epoch_s, 3),
            "wait_share": round(sum(rec["gaps"]) / epoch_s, 3),
            "valid_q_encoder_s": round(valid[0]["q_encoder_time"], 2),
            "valid_r_encoder_s": round(valid[0]["r_encoder_time"], 2),
            "maps": [valid[0][k] for k in ("i2t", "t2i", "i2i", "t2t")],
            "resident_eval": sorted(tr._resident_eval)}
        results[name]["codes"] = scio.loadmat(
            os.path.join(run_dir, "PR_cruve", f"{K_BITS}-ours-synthetic-i2t.mat"))
        trainers[name] = {k: v.detach().clone()
                          for k, v in tree_leaves_with_path(tr.state.params)}
        results[name]["model"] = os.path.join(run_dir, "model-0.npz")
        del tr
        torch.cuda.empty_cache()
    s, r = results["streaming"], results["resident"]
    check(s["resident_eval"] == [] and r["resident_eval"] == ["query", "retrieval"],
          f"input: eval residency streamed {s['resident_eval']}, resident {r['resident_eval']}")
    differing = [str(k) for k, v in trainers["resident"].items()
                 if not torch.equal(v, trainers["streaming"][k])]
    check(not differing, f"input: the resident epoch's parameters differ at {differing[:6]}")
    check(s["maps"] == r["maps"], f"input: resident valid mAPs {r['maps']} != streamed {s['maps']}")
    for key in ("q_img", "q_txt", "r_img", "r_txt"):
        check(np.array_equal(s["codes"][key], r["codes"][key]),
              f"input: resident valid codes {key} differ from the streamed ones")
    model = r["model"]
    for v in results.values():
        v.pop("codes"), v.pop("model")
    say("input", epochs="streaming and resident", parameters="bit-equal",
        valid_codes_and_maps="equal", **results)
    return launches, results, model


def input_serving(model, fixture_paths):
    """Gate 5: 64 JPEG files over HTTP as ``images_jpeg_b64`` (codes equal
    to ``Retriever.encode_images`` of ``decode_batch_mem``'s arrays, a
    search over them launching #3); image encode items/s at batch 256 fp32
    with ``prefetch_device`` 1 and 2, the H2D copies' device ms from the
    profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ccmh_torch.config import Config
    from ccmh_torch.data import native
    from ccmh_torch.retrieval import HashIndex, Retriever
    from ccmh_torch.serve import RetrievalService, serve

    files = [open(fixture_paths[i % len(fixture_paths)], "rb").read()
             for i in range(INPUT_SERVE_FILES)]
    retriever = Retriever.from_pretrained(Config(method="DSPH", output_dim=K_BITS,
                                                 pretrained=model), device="cuda")
    arrays, ok = native.decode_batch_mem(files, retriever.clip_cfg.image_resolution)
    check(ok.all(), "input: decode_batch_mem failed on the fixtures")
    direct = retriever.encode_images(arrays)
    reset_counts()
    index = HashIndex(direct, packed=True, device="cuda")
    service = RetrievalService(retriever, {"image": index})
    server = serve(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    body = {"images_jpeg_b64": [base64.b64encode(f).decode() for f in files]}
    try:
        got = np.asarray(http(server.server_address[1], "/v1/encode", body)["codes"])
        found = http(server.server_address[1], "/v1/search", {**body, "k": 8})
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    serve_launches = read_counts()
    check(np.array_equal(got, direct), "input: images_jpeg_b64 codes differ from "
                                       "Retriever.encode_images of decode_batch_mem's arrays")
    check(all(d[0] == 0 for d in found["distances"]), "input: a served file is not its own "
                                                      "nearest code")
    check(serve_launches["hamming_distance_packed"] > 0, "input: the search never launched #3")
    # two vision passes (the encode and the search request, 64 rows each):
    # #1, #4 and #5 once per block, no backward
    layers = retriever.clip_cfg.vision_layers
    want = {"fused_attention_fwd": 2 * layers, "fused_attention_bwd": 0,
            "fused_layer_norm": 2 * layers, "fused_add_layer_norm": 2 * layers}
    check(all(serve_launches[k] == n for k, n in want.items()),
          f"input serving: launches {serve_launches}, the code implies {want}")

    images = random_images(N_IMAGES, 224, seed=13)
    rates = {}
    for depth in (1, 2, 2, 1):
        retriever.cfg = retriever.cfg.replace(prefetch_device=depth)
        retriever.encode_images(images[:BATCH], batch_size=BATCH)        # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codes = retriever.encode_images(images, batch_size=BATCH)
        torch.cuda.synchronize()
        rates.setdefault(f"encode_items_s_depth{depth}", []).append(
            round(N_IMAGES / (time.perf_counter() - t0), 1))
        check(np.array_equal(codes[:INPUT_SERVE_FILES], retriever.encode_images(
            images[:INPUT_SERVE_FILES])), "input: codes depend on the chunking")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            retriever.encode_images(images, batch_size=BATCH)
            torch.cuda.synchronize()
        # device-side records only, as tools/profile_torch_serving.py sums them
        h2d = sum((e.time_range.end - e.time_range.start) / 1e3 for e in prof.events()
                  if e.device_type == DeviceType.CUDA and "memcpy htod" in e.name.lower())
        rates.setdefault(f"h2d_device_ms_depth{depth}", []).append(round(h2d, 2))
    say("input", serve_files=INPUT_SERVE_FILES, served_codes="equal to direct encode",
        search_hamming_launches=serve_launches["hamming_distance_packed"], batch=BATCH,
        images=N_IMAGES, **rates)
    return serve_launches, rates


def input_path():
    """Phase 13: the real-data input path, LayerNorm kernels on.  A 12,000
    item JPEG dataset (MIRFlickr-25K's split sizes and orientations)
    written by the port's encoder; the fixtures against PIL; decode and BPE
    rates; the four transports bit-equal over 16 steps; a streamed and a
    resident epoch with ``valid``; JPEG serving.  Returns the summed
    launches of the runs."""
    import torch

    from ccmh_torch.clip import model as cm
    from ccmh_torch.clip.model import ClipConfig
    from ccmh_torch.data import native
    from ccmh_torch.data.split import load_raw
    from ccmh_torch.data.synthetic import write_photo_jpeg_dataset

    work = os.path.join(WORK, "input")
    data = os.path.join(work, "data")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    fixture_paths = input_fixtures(native)
    t0 = time.perf_counter()
    write_photo_jpeg_dataset(data, INPUT_ITEMS, n_class=24, seed=13, sizes=INPUT_SIZES,
                             device="cuda")
    write_s = time.perf_counter() - t0
    raw = load_raw(os.path.join(data, "caption.mat"), os.path.join(data, "index.mat"),
                   os.path.join(data, "label.mat"))
    paths = [str(p).strip() for p in raw.indexes]
    jpeg_bytes = sum(os.path.getsize(p) for p in paths)
    say("input", items=INPUT_ITEMS, query=INPUT_QUERY, train=INPUT_TRAIN,
        sizes=[list(s) for s in INPUT_SIZES], classes=24, captions_per_item=3,
        write_s=round(write_s, 2), jpeg_mean_kb=round(jpeg_bytes / len(paths) / 1024, 1))
    texts = [str(np.ravel(np.asarray(c, dtype=object))[0]) for c in raw.captions[:10000]]
    rates = input_rates(native, paths, texts)

    total, families = {}, {}

    def add(launches):
        for kernel, n in launches.items():
            total[kernel] = total.get(kernel, 0) + n
        for kernel, counts in family_counts().items():
            for family, n in counts.items():
                families.setdefault(kernel, dict.fromkeys(counts, 0))[family] += n

    n_steps = -(-INPUT_TRAIN // TRAIN_BATCH)
    eval_batches = (-(-INPUT_QUERY // INPUT_EVAL_BATCH)
                    + -(-(INPUT_ITEMS - INPUT_QUERY) // INPUT_EVAL_BATCH))   # query, retrieval
    cm.set_ln_impl("fused")
    try:
        transports, _ = input_transports(data, work)
        for name, launches in transports.items():
            _check_launches(f"{name} 16 steps", launches,
                            extra_state_launches(INPUT_STEPS, 0, ClipConfig()), phase="input")
            add(launches)
        epochs, epoch_results, model = input_epochs(data, work)
        for name, launches in epochs.items():
            _check_launches(f"{name} epoch", launches,
                            extra_state_launches(n_steps, eval_batches, ClipConfig()),
                            phase="input")
            add(launches)
        serve_launches, serve_rates = input_serving(model, fixture_paths)
        add(serve_launches)
    finally:
        cm.set_ln_impl("plain")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return total


# -------------------------------------------------------------------- phase 14

# the towers past 128 tokens: (name, B, L, H), head dim 64
LONG_SHAPES = (("ViT-B/16", 256, 197, 12), ("ViT-L/14", 64, 257, 16),
               ("ViT-L/14@336", 64, 577, 16))
LONG_EDGES = (1, 129, 143, 192, 256, 577)    # L at the edge cases, B=4 H=4
# rows 0, 1 and L - 1 masked entirely by these finite values (the plain
# softmax, and ccmh's, give each a uniform row)
MASKED_ROWS = (-1e9, -1e30, float(np.finfo(np.float32).min) / 2)
# the long shapes the wgmma kernels leave to the mma.sync ones: (L, head
# dim, bytes by which qkv, g and the outputs sit off 16-byte alignment)
LONG_MMA_EDGES = ((200, 128, 0), (257, 64, 8))
LONG_TIMING = (2, 12)                        # SDPA: (t_12 - t_2) / 10, min of 2
WIDE_KS = (512, 2048)                        # packed codes past 256 bits
WIDE_GALLERY = 2 ** 18
LONG_BATCH, LONG_BIG_BATCH = 32, 128         # ViT-L/14 training batches
LONG_EVAL_BATCH = 128


def _long_inputs(B, L, H, dtype, seed, with_g=True, Dh=64, offset=0):
    """Seeded qkv, its bias and g; ``offset`` bytes past a 16-byte aligned
    start (contiguous views of a larger buffer)."""
    import torch

    D = H * Dh
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        if not offset:
            return x
        skip = offset // x.element_size()
        buf = torch.empty(x.numel() + skip, dtype=dtype, device="cuda")
        view = buf[skip:].view(shape)
        view.copy_(x)
        return view
    qkv = randn(B, L, 3 * D)
    qkv_b = (0.1 * torch.randn((3 * D,), generator=gen, device="cuda")).to(dtype)
    g = randn(B, L, D) if with_g else None
    return qkv, qkv_b, g


def wgmma_report(name):
    """Phase 14: the long wgmma kernels of library ``name``: each one's ptxas line
    (registers, spills) and its HGMMA instructions from ``cuobjdump
    -sass``; fails if one has none, or if one spills."""
    from ccmh_torch.ops import build

    kernels, current = {}, None
    for ln in (build.build_log(name) or "").splitlines():
        if "Compiling entry function" in ln:
            current = ln.split("'")[1] if "'" in ln else None
        elif current and "wgmma" in current and ("spill" in ln or "registers" in ln):
            kernels.setdefault(current, []).append(ln.strip())
    counts = build.sass_counts(name)
    check(kernels, f"{name}: no wgmma kernel in the ptxas report")
    for kernel, lines in kernels.items():
        spills = [ln for ln in lines
                  if any(int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", ln))]
        check(not spills, f"{name}: {kernel} spills: {spills}")
        if counts is not None:
            check(counts.get(kernel, 0) > 0, f"{name}: no HGMMA in {kernel}'s SASS")
    say("build", library=name, wgmma_kernels={
        k: {"ptxas": v, "hgmma": None if counts is None else counts.get(k)}
        for k, v in kernels.items()},
        sass="cuobjdump -sass" if counts is not None else "no cuobjdump in the toolkit")


def _long_family(L, Dh=64, aligned=True):
    """The kernel family the C entries take (csrc/attention_family.cuh)
    for these tensors, fp32 or bf16: past 128 tokens the wgmma kernels at
    head dim 64 with every pointer 16-byte aligned, else mma.sync."""
    from ccmh_torch.ops import attention as attn

    if L <= attn.SHORT_SEQ:
        return "short"
    return "long_wgmma" if Dh == 64 and aligned else "long_mma"


def _one_launch(fn, what, family):
    """``fn()`` must launch its kernel once, of ``family``: the long path
    ran on the card, in the family the entry's rule gives."""
    from ccmh_torch.ops import attention as attn

    before = (attn.launches, attn.backward_launches)
    fam_before = family_counts()
    out = fn()
    ran = (attn.launches - before[0], attn.backward_launches - before[1])
    check(sum(ran) == 1, f"{what}: {ran} launches of (#1, #2), not one kernel launch")
    took = [f for kernel, counts in family_counts().items() for f, n in counts.items()
            if n > fam_before[kernel][f]]
    check(took == [family], f"{what}: took the {took} kernels, the rule gives {family}")
    return out


def long_attention_cases(name, B, L, H, dtype):
    """#1 and #2 at a long tower's shape against their plain versions,
    with the kernels' ms at their C entries beside the bound, the plain
    versions' ms and SDPA's (forward; forward + backward minus forward)."""
    import torch

    from ccmh_torch.ops import attention as attn
    from ccmh_torch.tools import bench_attn_bwd as bench

    tname = "float32" if dtype == torch.float32 else "bfloat16"
    qkv, qkv_b, g = _long_inputs(B, L, H, dtype, seed=L * 1000 + H)
    D, Dh = H * 64, 64
    cases = []
    family = _long_family(L)
    with torch.no_grad():
        got = _one_launch(lambda: attn.fused_attention(qkv, None, H, qkv_b=qkv_b),
                          f"attention {name}", family)
        want = attn.attention_reference(qkv, None, H, qkv_b=qkv_b)
        err_f = (got.float() - want.float()).abs().max().item()
        del got, want
        dq = _one_launch(lambda: attn.attention_backward(qkv, None, qkv_b, g, H),
                         f"attention backward {name}", family)
        dq_want = attn.attention_backward_reference(qkv, None, qkv_b, g, H)
        err_b = (dq.float() - dq_want.float()).abs().max().item()
        scale = max(1.0, dq_want.float().abs().max().item())
        del dq, dq_want
        torch.cuda.empty_cache()
        check(math.isfinite(err_f) and err_f <= ATTN_TOL[tname],
              f"long attention {name} {tname}: max abs err {err_f} > {ATTN_TOL[tname]}")
        check(math.isfinite(err_b) and err_b <= ATTN_TOL[tname] * scale,
              f"long attention backward {name} {tname}: max abs err {err_b} > "
              f"{ATTN_TOL[tname]} x output scale {scale}")
        ms = {"fwd": cuda_ms(attention_entry("fwd", qkv, None, qkv_b, H), iters=10),
              "bwd": cuda_ms(attention_entry("bwd", qkv, None, qkv_b, H, g), iters=10)}
        plain = {"fwd": cuda_ms(lambda: attn.attention_reference(qkv, None, H, qkv_b=qkv_b),
                                iters=3, warmup=1),
                 "bwd": cuda_ms(lambda: attn.attention_backward_reference(qkv, None, qkv_b,
                                                                          g, H),
                                iters=3, warmup=1)}
    torch.cuda.empty_cache()
    lib = dict(zip(("fwd", "bwd"), bench.sdpa_yardstick(qkv + qkv_b, False, H, LONG_TIMING, 2)))
    item = qkv.element_size()
    for kind, err, n_bytes, n_ops in (
            ("fwd", err_f, (qkv.numel() + qkv_b.numel() + B * L * D) * item,
             4.0 * B * H * L * L * Dh),
            ("bwd", err_b, (2 * qkv.numel() + g.numel() + qkv_b.numel()) * item,
             10.0 * B * H * L * L * Dh)):
        bound_ms, bound_by = bound(n_bytes, n_ops, ATTN_OP_TYPE[tname])
        case = {"case": f"{name} {tname}", "shape": [B, L, 3 * D], "heads": H,
                "causal": False, "path": family, "max_abs_err": err, "tol": ATTN_TOL[tname],
                "ms": ms[kind], "plain_ms": plain[kind], "library_ms": lib[kind],
                "library": "SDPA fwd" if kind == "fwd" else "SDPA fwd+bwd minus SDPA fwd",
                "bound_ms": bound_ms, "bound_by": bound_by}
        if kind == "bwd":
            case["output_scale"] = scale
        say("kernel", kernel=f"fused_attention_{kind}", **case)
        cases.append(case)
    return cases


def long_attention_edges():
    """#1 and #2 at the edges of the long path (B=4, H=4): L from 1 to 577,
    causal and with the last third of the keys padded; rows that a finite
    mask covers entirely (-1e9, -1e30, finfo.min / 2) on the wgmma kernels
    and on mma.sync; the shapes the wgmma kernels leave to mma.sync (head
    dim 128, tensors off 16-byte alignment); fp32 and bf16, each call one
    kernel launch of the family the rule gives, within the gates of their
    plain versions.  Returns the launches by family."""
    import torch

    from ccmh_torch.clip.model import causal_mask
    from ccmh_torch.ops import attention as attn

    cases = [(L, kind, 64, 0) for L in LONG_EDGES for kind in ("causal", "keypad")]
    cases += [(257, "rows", 64, 0), (200, "rows", 128, 0)]
    cases += [(L, "causal", Dh, off) for L, Dh, off in LONG_MMA_EDGES]
    worst = {}
    reset_counts()
    for dtype in (torch.float32, torch.bfloat16):
        tname = "float32" if dtype == torch.float32 else "bfloat16"
        for L, kind, Dh, off in cases:
            qkv, qkv_b, g = _long_inputs(4, L, 4, dtype, seed=L + 7, Dh=Dh, offset=off)
            mask = causal_mask(L, device="cuda")
            if kind == "keypad":
                mask = torch.zeros((L, L), device="cuda")
                mask[:, L - L // 3:] = -math.inf
            elif kind == "rows":
                mask = torch.zeros((L, L), device="cuda")
                for row, value in zip((0, 1, L - 1), MASKED_ROWS):
                    mask[row] = value
            family = _long_family(L, Dh, aligned=not off)
            with torch.no_grad():
                got = _one_launch(lambda: attn.fused_attention(qkv, mask, 4, qkv_b=qkv_b),
                                  f"attention L={L} {kind} Dh={Dh}", family)
                want = attn.attention_reference(qkv, mask, 4, qkv_b=qkv_b)
                dq = _one_launch(lambda: attn.attention_backward(qkv, mask, qkv_b, g, 4),
                                 f"attention backward L={L} {kind} Dh={Dh}", family)
                dq_want = attn.attention_backward_reference(qkv, mask, qkv_b, g, 4)
            err = (got.float() - want.float()).abs().max().item()
            err_b = (dq.float() - dq_want.float()).abs().max().item()
            scale = max(1.0, dq_want.float().abs().max().item())
            tag = f"L={L} {kind} Dh={Dh}{f' +{off} B' if off else ''} {tname}"
            check(math.isfinite(err) and err <= ATTN_TOL[tname],
                  f"attention edge {tag}: max abs err {err}")
            check(math.isfinite(err_b) and err_b <= ATTN_TOL[tname] * scale,
                  f"attention backward edge {tag}: max abs err {err_b} (scale {scale})")
            worst[tag] = [err, err_b / scale, family]
    families = family_counts()
    say("long_edges", cases=len(worst), max_abs_err_fwd_bwd_rel_family=worst,
        launches_by_family=families)
    return families


def tf32_selftest():
    """The fp32 building blocks of the wgmma kernels on one [64, 64] product
    each (3xTF32: shared-memory and register operands, the transposed
    split; check_attention_long's selftest, with the bf16 ones), and whether
    the tensor cores ignore the low 13 mantissa bits of a raw fp32 operand,
    printed on a line of its own."""
    import torch

    from ccmh_torch.tools import check_attention_long as cal

    for row in cal.wgmma_selftest(torch.device("cuda", 0)):
        if "tf32_low_13_bits" in row:
            say("tf32_low_13_bits", answer=row["tf32_low_13_bits"],
                raw_vs_hi_max_abs_diff=row["raw_vs_hi_max_abs_diff"], what=row["what"])
            continue
        check(row["ok"], f"wgmma selftest {row['selftest']}: {row}")
        say("selftest", **row)


def wide_hamming_cases():
    """#3 at K = 512 and 2,048 bits (Q = 512, N = 2^18) against its plain
    version, exactly, with its ms beside the bound and the plain ms."""
    import torch

    from ccmh_torch.ops import hamming as ham

    cases = []
    for k in WIDE_KS:
        W = k // 32
        gen = torch.Generator(device="cuda").manual_seed(k)
        lo, hi = -2 ** 31, 2 ** 31
        q = torch.randint(lo, hi, (SEARCH_Q, W), generator=gen, device="cuda", dtype=torch.int32)
        r = torch.randint(lo, hi, (WIDE_GALLERY, W), generator=gen, device="cuda",
                          dtype=torch.int32)
        with torch.inference_mode():
            before = ham.launches
            got = ham.hamming_distance_packed(q, r)
            check(ham.launches == before + 1, f"packed hamming K={k} did not launch its kernel")
            want = ham.hamming_distance_packed_reference(q, r)
            check(torch.equal(got, want), f"packed hamming K={k} differs from its plain version")
            del got, want
            ms = cuda_ms(lambda: ham.hamming_distance_packed(q, r))
            plain_ms = cuda_ms(lambda: ham.hamming_distance_packed_reference(q, r), iters=2,
                               warmup=1)
        bound_ms, bound_by = bound((q.numel() + r.numel() + SEARCH_Q * WIDE_GALLERY) * 4,
                                   3.0 * SEARCH_Q * WIDE_GALLERY * W, "int32")
        case = {"case": f"search int32 K={k}", "shape": [SEARCH_Q, WIDE_GALLERY, W],
                "max_abs_err": 0, "tol": 0, "ms": ms, "plain_ms": plain_ms,
                "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
        say("kernel", kernel="hamming_distance_packed", **case)
        cases.append(case)
    return cases


def _long_tower_pt(path, clip_cfg, seed):
    """A seeded random tower written as an OpenAI-layout ``.pt``."""
    import torch

    from ccmh_torch.clip.export_ref import export_clip_state_dict
    from ccmh_torch.clip.model import init_clip_params

    clip0 = init_clip_params(torch.Generator(device="cuda").manual_seed(seed), clip_cfg)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                export_clip_state_dict(clip0, prefix="").items()}, path)
    del clip0
    torch.cuda.empty_cache()


def _timed_run(argv, step_ms=None, start=None):
    """``ccmh_torch.cli.main(argv)`` with its launches counted, its peak
    device memory above what was allocated before it and, into
    ``step_ms``, each train step's host ms (the step synchronised); into
    ``start``, a copy of the parameters the first step starts from."""
    import torch

    from ccmh_torch import cli
    from ccmh_torch.train import trainer as trainer_mod

    make = trainer_mod.make_train_step

    def make_timed(*args, **kw):
        inner = make(*args, **kw)

        def step_fn(state, batch):
            if start is not None and not start:
                start.update(_snapshot(state.params))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(state, batch)
            torch.cuda.synchronize()
            step_ms.append(round(1e3 * (time.perf_counter() - t0), 1))
            return out
        return step_fn

    trainer_mod.make_train_step = make_timed if step_ms is not None else make
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    try:
        trainer = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        trainer_mod.make_train_step = make
    return trainer, read_counts(), torch.cuda.max_memory_allocated() - base


def _tower_launches(steps, clip_cfg, remat, eval_batches=0):
    """#1 / #2 launches of ``steps`` DSPH steps (plain LayerNorm): every
    block of both towers once forward and once backward, and forward once
    more under remat (the recompute); an eval batch encodes each tower."""
    blocks = clip_cfg.vision_layers + clip_cfg.transformer_layers
    return {"fused_attention_fwd": steps * blocks * (2 if remat else 1) + eval_batches * blocks,
            "fused_attention_bwd": steps * blocks}


def _check_tower_launches(what, launches, want):
    for kernel, n in launches.items():
        check(n == want.get(kernel, 0), f"long {what}: {n} launches of {kernel}, the code "
                                        f"implies {want.get(kernel, 0)}")


def _check_tower_families(what, clip_cfg, steps, remat):
    """#1's and #2's launches by kernel family since the counts were set to
    0: the vision tower past 128 tokens all on the wgmma kernels (fp32 or
    bf16, head dim 64), the text tower on the short ones, none on
    mma.sync.  Returns them."""
    took = family_counts()
    fwd = 2 if remat else 1
    want = {"fused_attention_fwd": {"short": steps * fwd * clip_cfg.transformer_layers,
                                    "long_mma": 0,
                                    "long_wgmma": steps * fwd * clip_cfg.vision_layers},
            "fused_attention_bwd": {"short": steps * clip_cfg.transformer_layers,
                                    "long_mma": 0, "long_wgmma": steps * clip_cfg.vision_layers}}
    check(took == want, f"{what}: kernel families {took}, the code implies {want}")
    return took


def _grads_by_remat(trainer, batch):
    """The DSPH loss and every gradient at the trainer's state on ``batch``,
    with remat off, "full" and "dots"."""
    import copy

    import torch

    from ccmh_torch.train.optim import tree_leaves_with_path

    paths, leaves = zip(*tree_leaves_with_path(trainer.state.params))
    extra = list(tree_leaves_with_path(trainer.state.extra))
    out = {}
    for mode in (False, "full", "dots"):
        cfg = copy.copy(trainer.cfg)
        cfg.remat, cfg.remat_policy = bool(mode), mode or "full"
        loss_fn = trainer.method.make_loss_fn(cfg, trainer.clip_cfg)
        gen = torch.Generator(device="cuda").manual_seed(1)
        loss, _ = loss_fn(trainer.state.params, trainer.state.extra, trainer.state.aux, batch,
                          gen)
        grads = torch.autograd.grad(loss, list(leaves) + [e for _, e in extra],
                                    allow_unused=True)
        out[mode] = (loss.detach(), grads)
        del loss
    return out


def long_path():
    """Phase 14: the towers past 128 tokens.  ViT-L/14 encode rate
    (bench_vitl); ViT-L/14 DSPH trained through the CLI from a seeded
    OpenAI-layout .pt at batch 32 with remat off, full and dots (losses,
    parameters and gradients bit-equal), at batch 128 with remat and bf16
    moments; its .npz serving the trainer's codes and a packed K=512 index
    equal to the int8 one; ViT-B/16 from a .pt; ViT-B/32 with bf16 moments
    cut by SIGTERM and resumed bit for bit; --profile; ViT-L/14 with bf16
    towers (the long path's wgmma kernels forward and backward).  Returns
    the summed launches of the runs and the serving path, and #1's and
    #2's by kernel family."""
    import torch

    from ccmh_torch.clip.model import ClipConfig
    from ccmh_torch.models.heads import linear_hash
    from ccmh_torch.retrieval import HashIndex
    from ccmh_torch.tools import bench_vitl
    from ccmh_torch.train.methods.base import image_embeds, text_embeds
    from ccmh_torch.train.optim import tree_leaves_with_path

    work = os.path.join(WORK, "long")
    os.makedirs(work, exist_ok=True)
    data = os.path.join(WORK, "train_data")      # written by phase 5
    total, families = {}, {}

    def add(launches):
        for kernel, n in launches.items():
            total[kernel] = total.get(kernel, 0) + n
        for kernel, counts in family_counts().items():
            for family, n in counts.items():
                families.setdefault(kernel, dict.fromkeys(counts, 0))[family] += n

    # 1. serving: bench_vitl's bf16 encode pair at B=64
    reset_counts()
    row = bench_vitl.main([str(64)])
    served = read_counts()
    pairs = bench_vitl.LOOPS[0] + bench_vitl.REPEATS * sum(bench_vitl.LOOPS)
    vitl = ClipConfig.vit_l14()
    _check_tower_launches("bench_vitl", served,
                          {"fused_attention_fwd": pairs * (vitl.vision_layers
                                                           + vitl.transformer_layers)})
    add(served)
    say("long", run="bench_vitl", **{k: row[k] for k in (
        "B", "vision_tokens", "params_M", "gflop_per_pair", "ms", "pairs_per_s", "tflops")})
    torch.cuda.empty_cache()

    # 2. ViT-L/14 DSPH from a .pt, batch 32, remat off / full / dots
    tower = os.path.join(work, "vitl14.pt")
    t0 = time.perf_counter()
    _long_tower_pt(tower, vitl, seed=14)
    pt_s = time.perf_counter() - t0
    def argv(batch, epochs=1, clip_path=None):
        """DSPH K=64 on phase 5's data, 2 steps an epoch, no validation."""
        return (["--method", "DSPH", "--dataset", "synthetic", "--output-dim", str(K_BITS),
                 "--data-dir", data, "--epochs", str(epochs), "--query-num", str(TRAIN_QUERY),
                 "--batch-size", str(batch), "--train-num", str(2 * batch),
                 "--eval-batch", str(LONG_EVAL_BATCH), "--display-step", "1", "--no-valid",
                 "--num-workers", "4", "--device", "cuda"]
                + (["--clip-path", clip_path] if clip_path else []))

    vitl_argv = argv(LONG_BATCH, clip_path=tower)
    runs, ref = {}, None
    for mode, flags in (("off", []), ("full", ["--remat"]),
                        ("dots", ["--remat", "--set", "remat_policy=dots"])):
        steps = []
        trainer, launches, peak = _timed_run(
            vitl_argv + flags + ["--save-dir", os.path.join(work, mode)]
            + (["--save-model"] if mode == "off" else []), steps)
        _check_tower_launches(f"ViT-L/14 remat={mode}", launches,
                              _tower_launches(2, vitl, mode != "off"))
        took = _check_tower_families(f"ViT-L/14 remat={mode}", vitl, 2, mode != "off")
        add(launches)
        losses = [r["loss"] for r in _metric_rows(trainer.cfg.save_dir) if r["event"] == "train"]
        check(len(losses) == 2 and all(math.isfinite(x) for x in losses),
              f"ViT-L/14 remat={mode}: losses {losses}")
        runs[mode] = {"losses": losses, "step_ms": steps, "peak_bytes": peak,
                      "fwd_launches": launches["fused_attention_fwd"],
                      "bwd_launches": launches["fused_attention_bwd"], "families": took}
        if ref is None:
            ref = trainer
        else:
            diff = _tree_diff(trainer.state.params, ref.state.params)
            with torch.no_grad():
                spread = _float_spread(trainer.state.params, ref.state.params) if diff else 0.0
            check(losses == runs["off"]["losses"] and not diff,
                  f"ViT-L/14 remat={mode} differs from remat off: losses {losses} vs "
                  f"{runs['off']['losses']}, parameters at {diff[:4]} (largest {spread})")
            del trainer
        torch.cuda.empty_cache()
    say("long", run="ViT-L/14 DSPH K=64 fp32 batch 32, 2 steps", tower_pt_s=round(pt_s, 1),
        by_remat=runs, equal="losses and parameters, bit for bit")

    # every gradient at the trained state on one batch, under each mode
    loader_batch = next(iter(ref.train_loader))
    batch = ref._put(loader_batch)
    batch["epoch"] = torch.tensor(0, dtype=torch.int32, device="cuda")
    grads = _grads_by_remat(ref, batch)
    base_loss, base_grads = grads[False]
    for mode in ("full", "dots"):
        loss, gs = grads[mode]
        bad = [i for i, (a, b) in enumerate(zip(gs, base_grads))
               if (a is None) != (b is None) or (a is not None and not torch.equal(a, b))]
        worst = max([float((gs[i] - base_grads[i]).abs().max()) for i in bad
                     if gs[i] is not None] or [0.0])
        check(torch.equal(loss, base_loss) and not bad,
              f"ViT-L/14 gradients under remat={mode} differ from remat off in {len(bad)} "
              f"leaves, largest difference {worst}")
    say("long", run="ViT-L/14 gradients by remat", leaves=len(base_grads),
        equal="loss and every gradient, off = full = dots")
    del grads, base_grads, batch
    torch.cuda.empty_cache()

    # the .npz serves the trainer's codes; a packed K=512 index = int8
    def code_margin(kind, retriever, cfg, x):
        embeds = image_embeds if kind == "image" else text_embeds
        head = retriever.params["img_head" if kind == "image" else "txt_head"]
        return linear_hash(head, embeds(retriever.params, retriever.clip_cfg, x, cfg)).abs()

    reset_counts()
    check_served_codes("long", ref, os.path.join(ref.cfg.save_dir, "model-0.npz"), code_margin,
                       k_bits=K_BITS)
    del ref
    torch.cuda.empty_cache()
    rng = np.random.RandomState(14)
    codes = np.where(rng.rand(2 ** 16, 512) < 0.5, -1, 1).astype(np.int8)
    queries = np.where(rng.rand(SEARCH_Q, 512) < 0.5, -1, 1).astype(np.int8)
    before = read_counts()["hamming_distance_packed"]
    d_packed, i_packed = HashIndex(codes, packed=True, device="cuda").search(queries, k=10)
    d_int8, i_int8 = HashIndex(codes, packed=False, device="cuda").search(queries, k=10)
    check(np.array_equal(d_packed, d_int8) and np.array_equal(i_packed, i_int8),
          "a packed K=512 index ranks otherwise than the int8 one")
    check(read_counts()["hamming_distance_packed"] > before,
          "the packed K=512 search never launched the hamming kernel")
    add(read_counts())
    say("long", run="packed K=512 index", gallery=len(codes), queries=SEARCH_Q,
        equal_to_int8="distances and indices")

    # 3. batch 128 with remat and bf16 moments
    steps = []
    trainer, launches, peak = _timed_run(
        argv(LONG_BIG_BATCH, clip_path=tower) + [
            "--remat", "--set", "optim_moments_dtype=bfloat16",
            "--save-dir", os.path.join(work, "b128")], steps)
    _check_tower_launches("ViT-L/14 batch 128", launches, _tower_launches(2, vitl, True))
    _check_tower_families("ViT-L/14 batch 128", vitl, 2, True)
    add(launches)
    moments = [t for st in trainer.optimizer.state.values() for t in (st["m"], st["v"])]
    check({t.dtype for t in moments} == {torch.bfloat16},
          "ViT-L/14 batch 128: the moments are not bf16")
    m_bytes = sum(t.numel() * t.element_size() for t in moments)
    losses = [r["loss"] for r in _metric_rows(trainer.cfg.save_dir) if r["event"] == "train"]
    check(len(losses) == 2 and all(math.isfinite(x) for x in losses),
          f"ViT-L/14 batch 128: losses {losses}")
    say("long", run="ViT-L/14 DSPH K=64 fp32 batch 128, --remat, bf16 moments, 2 steps",
        losses=losses, step_ms=steps, peak_bytes=peak, moment_bytes=m_bytes,
        fp32_moment_bytes=sum(t.numel() * 4 for t in moments))
    del trainer, moments
    torch.cuda.empty_cache()

    # 3b. bf16 towers (--compute-dtype bfloat16), batch 32: the vision
    # tower's 24 blocks on the long path's wgmma kernels, forward and
    # backward; the text tower's 12 on the short kernels
    steps = []
    trainer, launches, peak = _timed_run(
        argv(LONG_BATCH, clip_path=tower) + ["--compute-dtype", "bfloat16", "--save-dir",
                                             os.path.join(work, "bf16")], steps)
    _check_tower_launches("ViT-L/14 bf16", launches, _tower_launches(2, vitl, False))
    took = _check_tower_families("ViT-L/14 bf16", vitl, 2, False)
    add(launches)
    losses = [r["loss"] for r in _metric_rows(trainer.cfg.save_dir) if r["event"] == "train"]
    check(len(losses) == 2 and all(math.isfinite(x) for x in losses),
          f"ViT-L/14 bf16: losses {losses}")
    say("long", run="ViT-L/14 DSPH K=64 bf16 towers batch 32, 2 steps", losses=losses,
        step_ms=steps, peak_bytes=peak, families=took)
    del trainer
    os.remove(tower)
    torch.cuda.empty_cache()

    # 4. ViT-B/16 (197 tokens) from a .pt, 2 steps, its .npz serving
    vitb16 = ClipConfig(vision_patch_size=16)
    tower = os.path.join(work, "vitb16.pt")
    _long_tower_pt(tower, vitb16, seed=16)
    steps = []
    trainer, launches, peak = _timed_run(
        argv(LONG_BATCH, clip_path=tower) + ["--save-model", "--save-dir",
                                             os.path.join(work, "b16")], steps)
    _check_tower_launches("ViT-B/16", launches, _tower_launches(2, vitb16, False))
    _check_tower_families("ViT-B/16", vitb16, 2, False)
    add(launches)
    say("long", run="ViT-B/16 DSPH K=64 fp32 batch 32, 2 steps", step_ms=steps,
        peak_bytes=peak)
    check_served_codes("long", trainer, os.path.join(trainer.cfg.save_dir, "model-0.npz"),
                       code_margin, k_bits=K_BITS)
    del trainer
    torch.cuda.empty_cache()

    # 5. ViT-B/32 with bf16 moments: A; B cut by SIGTERM after global step 3
    # and resumed; both end in the same bits; --profile on A's run
    b32 = argv(TRAIN_BATCH, epochs=2) + ["--checkpoint-every", "1",
                                         "--set", "optim_moments_dtype=bfloat16"]

    def run_dir(name):
        return os.path.join(work, name, "DSPH", "synthetic", str(K_BITS))

    timings = {}
    for name, flags, cut in (("A", [], None), ("B", [], 3), ("B", ["--resume"], None),
                             ("P", ["--profile"], None)):
        _, launches, _ = _lifecycle_run(b32 + flags + ["--save-dir", os.path.join(work, name)],
                                        timings, cut_at=cut)
        n_steps = cut or (1 if "--resume" in flags else 4)
        _check_tower_launches(f"ViT-B/32 {name}{' '.join(flags)}", launches,
                              _tower_launches(n_steps, ClipConfig(), False))
        add(launches)
    slot_a, rows_a = _final_slot(run_dir("A")), _metric_rows(run_dir("A"))
    check({t.dtype for st in slot_a["optimizer"]["state"].values() for t in (st["m"], st["v"])}
          == {torch.bfloat16}, "ViT-B/32: the slot's moments are not bf16")
    diff = _tree_diff(_final_slot(run_dir("B")), slot_a) + (
        ["metrics.jsonl"] if _metric_rows(run_dir("B")) != rows_a else [])
    check(not diff, f"ViT-B/32 bf16 moments: the resumed run differs from A at {diff[:8]}")
    train_rows = [r["loss"] for r in rows_a if r["event"] == "train"]
    prof_rows = [r["loss"] for r in _metric_rows(run_dir("P")) if r["event"] == "train"]
    traces = [n for n in os.listdir(os.path.join(run_dir("P"), "profile"))
              if n.endswith(".json")]
    check(traces and prof_rows == train_rows,
          f"--profile: traces {traces}, losses {prof_rows} vs {train_rows}")
    say("long", run="ViT-B/32 DSPH bf16 moments", resumed_equal_to_A="params, extra, aux, "
        "both optimizers (bf16 moments), generator, step, meta, every train row",
        profile_traces=traces, profile_losses_equal=True,
        trace_bytes=sum(os.path.getsize(os.path.join(run_dir("P"), "profile", n))
                        for n in traces), **timings)
    shutil.rmtree(work, ignore_errors=True)
    for kernel in ("fused_attention_fwd", "fused_attention_bwd"):
        check(families[kernel]["long_wgmma"] > 0 and families[kernel]["long_mma"] == 0,
              f"phase 14's runs launched {kernel} by family {families[kernel]}: every tower "
              f"past 128 tokens takes the wgmma kernels, fp32 and bf16")
    say("long", launches_by_family=families)
    return total, families


# -------------------------------------------------------------------- phase 15

RN_SEED = 15
RN_STEPS = 2                 # train steps of each CLI run
RN_CPU_IMAGES = 4            # the card's fp32 embedding against the CPU's
# ||e_card - e_cpu|| / ||e_cpu|| of each fp32 embedding: cuDNN and the
# CPU's convolutions sum in other orders (cuDNN may take Winograd or FFT
# algorithms), through 16 bottlenecks and the attention pool
RN_CPU_TOL = 1e-4
RN_BF16_COSINE = 0.999       # bf16 embeddings against fp32, each row
RN_GRAD_PROBE = 2            # fp32 gradients computed twice, per cuDNN mode


def rn50_config():
    """OpenAI's RN50 (openai/CLIP clip/model.py build_model and
    ModifiedResNet): stages of 3, 4, 6 and 3 bottlenecks from a width-64
    stem, a 32-head attention pool over 7x7 + 1 tokens 2,048 wide, a
    1,024-wide embedding and ViT-B/32's 12-layer text tower."""
    from ccmh_torch.clip.model import ClipConfig

    return ClipConfig(embed_dim=1024, image_resolution=224, vision_layers=(3, 4, 6, 3),
                      vision_width=64, vision_patch_size=None, context_length=77,
                      vocab_size=49408, transformer_width=512, transformer_heads=8,
                      transformer_layers=12)


def _rn_tower(seed):
    """A seeded RN50 CLIP tree on the card: ``init_clip_params`` with every
    BatchNorm's scale and bias and its running mean and var redrawn as a
    trained checkpoint holds them (scale and var in [0.5, 1.5), bias and
    mean N(0, 0.1)): the init zeroes each block's ``bn3`` scale, which
    leaves the block's other leaves without a gradient."""
    import torch

    from ccmh_torch.clip.model import init_clip_params

    gen = torch.Generator(device="cuda").manual_seed(seed)
    clip = init_clip_params(gen, rn50_config())

    def draw(shape, lo=None, hi=None):
        if lo is None:
            return 0.1 * torch.randn(shape, generator=gen, device="cuda")
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device="cuda")

    def redraw(node):
        if set(node) == {"scale", "bias", "mean", "var"}:
            c = node["scale"].shape
            return {"scale": draw(c, 0.5, 1.5), "bias": draw(c), "mean": draw(c),
                    "var": draw(c, 0.5, 1.5)}
        return {k: redraw(v) if isinstance(v, dict) else v for k, v in node.items()}

    clip["visual"] = redraw(clip["visual"])
    return clip


def _rn_state_dict(clip):
    """The inverse of the port's RN conversion: a CLIP tree -> an
    OpenAI-layout state dict of host tensors (``visual.conv1.weight`` ..
    ``visual.attnpool.c_proj.bias``, BatchNorm's ``num_batches_tracked``
    included, and the text tower's keys)."""
    import torch

    from ccmh_torch.bridge import params_to_jax
    from ccmh_torch.clip.export_ref import _export_blocks, _ln

    tree = params_to_jax(clip)
    v, t = tree["visual"], tree["text"]
    sd = {}

    def conv(key, w):
        sd[key] = w.transpose(3, 2, 0, 1)                   # HWIO -> OIHW

    def bn(prefix, p):
        sd.update({f"{prefix}.weight": p["scale"], f"{prefix}.bias": p["bias"],
                   f"{prefix}.running_mean": p["mean"], f"{prefix}.running_var": p["var"],
                   f"{prefix}.num_batches_tracked": np.asarray(0, np.int64)})

    for i in (1, 2, 3):
        conv(f"visual.conv{i}.weight", v["stem"][f"conv{i}"])
        bn(f"visual.bn{i}", v["stem"][f"bn{i}"])
    for li in (1, 2, 3, 4):
        for bi, blk in v[f"layer{li}"].items():
            pre = f"visual.layer{li}.{bi}"
            for ci in (1, 2, 3):
                conv(f"{pre}.conv{ci}.weight", blk[f"conv{ci}"])
                bn(f"{pre}.bn{ci}", blk[f"bn{ci}"])
            if "downsample" in blk:
                conv(f"{pre}.downsample.0.weight", blk["downsample"]["conv"])
                bn(f"{pre}.downsample.1", blk["downsample"]["bn"])
    pool = v["attnpool"]
    sd["visual.attnpool.positional_embedding"] = pool["positional_embedding"]
    for name in ("q", "k", "v", "c"):
        sd[f"visual.attnpool.{name}_proj.weight"] = pool[f"{name}_w"].T
        sd[f"visual.attnpool.{name}_proj.bias"] = pool[f"{name}_b"]
    sd["token_embedding.weight"] = t["token_embedding"]
    sd["positional_embedding"] = t["positional_embedding"]
    _export_blocks(sd, "transformer", t["blocks"])
    _ln(sd, "ln_final", t["ln_final"])
    sd["text_projection"] = t["text_projection"]
    sd["logit_scale"] = np.asarray(tree["logit_scale"], np.float32)
    return {k: torch.from_numpy(np.array(a, order="C")) for k, a in sd.items()}


def rn_launches(text_passes: int, train_steps: int) -> dict:
    """The launches an RN run implies, LayerNorm kernels on: the tower
    runs no kernel, the text tower's 12 blocks take #1, #4 and #5 once a
    pass each and #2 once a train step each."""
    layers = rn50_config().transformer_layers
    return {"fused_attention_fwd": layers * text_passes,
            "fused_attention_bwd": layers * train_steps,
            "fused_layer_norm": layers * text_passes,
            "fused_add_layer_norm": layers * text_passes}


def _bn_leaves(tree):
    from ccmh_torch.train.optim import tree_leaves_with_path

    return [p for p, _ in tree_leaves_with_path(tree) if p[-1] in ("mean", "var")]


def _rn_grads_twice(trainer, batch):
    """Every gradient of the trainer's loss at its state on ``batch``,
    computed RN_GRAD_PROBE times: are they the same bits?"""
    import torch

    from ccmh_torch.train.optim import tree_leaves_with_path

    leaves = [leaf for _, leaf in tree_leaves_with_path(trainer.state.params)]
    loss_fn = trainer.method.make_loss_fn(trainer.cfg, trainer.clip_cfg)
    runs = []
    for _ in range(RN_GRAD_PROBE):
        gen = torch.Generator(device="cuda").manual_seed(1)
        loss, _ = loss_fn(trainer.state.params, trainer.state.extra, trainer.state.aux,
                          batch, gen)
        runs.append(torch.autograd.grad(loss, leaves, allow_unused=True))
        del loss
    return all((a is None and b is None) or torch.equal(a, b)
               for run in runs[1:] for a, b in zip(run, runs[0]))


def rn_serving(work, tower, clip0, images, total):
    """RN50 DCHMT K=64 served: the ``.npz`` restored by
    ``Retriever.from_pretrained`` with the tower's ``.pt`` as ``clip_path``,
    2,048 images encoded at batch 256 in fp32 and bf16, the captions through
    the text tower, a 512-query search over a 2^20-code packed gallery, and
    HTTP requests each equal to the direct call (counted launches)."""
    import torch

    from ccmh_torch.config import Config
    from ccmh_torch.retrieval import HashIndex, Retriever
    from ccmh_torch.serve import RetrievalService, serve
    from ccmh_torch.tokenizer import tokenize_batch
    from ccmh_torch.train.checkpoint import save_checkpoint
    from ccmh_torch.train.methods import get_method
    from ccmh_torch.train.methods.base import image_embeds

    rn50 = rn50_config()
    ckpt = os.path.join(work, "rn50_dchmt_k64.npz")
    gen = torch.Generator(device="cuda").manual_seed(RN_SEED + 1)
    heads, _, aux = get_method("DCHMT").init(gen, Config(method="DCHMT", output_dim=K_BITS), rn50)
    save_checkpoint(ckpt, {"clip": clip0, **heads}, aux=aux)
    cfg = Config(method="DCHMT", output_dim=K_BITS, max_words=32, nclass=80, pretrained=ckpt,
                 clip_path=tower)
    texts = captions(N_IMAGES, seed=RN_SEED + 2)
    ids = tokenize_batch(texts, cfg.max_words)

    reset_counts()
    retriever = Retriever.from_pretrained(cfg, device="cuda")
    check(retriever.clip_cfg == rn50, f"rn: the served tower reads as {retriever.clip_cfg}")
    bf16 = Retriever(retriever.method, retriever.params, retriever.aux,
                     cfg.replace(compute_dtype="bfloat16"), rn50, device="cuda")
    rates = {}
    for name, r in (("fp32", retriever), ("bf16", bf16)):
        r.encode_images(images[:BATCH])
        rates[f"image_encode_items_per_s_{name}"] = N_IMAGES / host_s(
            lambda: r.encode_images(images, batch_size=BATCH), reps=2)
    img_codes = retriever.encode_images(images, batch_size=BATCH)
    txt_codes = retriever.encode_texts(ids, batch_size=BATCH)
    rates["text_encode_items_per_s_fp32"] = N_IMAGES / host_s(
        lambda: retriever.encode_texts(ids, batch_size=BATCH), reps=2)
    check(img_codes.shape == (N_IMAGES, K_BITS) and set(np.unique(img_codes)) <= {-1, 1}
          and txt_codes.shape == (N_IMAGES, K_BITS), "rn: served code shapes")

    # bf16 embeddings against fp32 on one batch
    with torch.inference_mode():
        x = torch.from_numpy(images[:BATCH]).cuda()
        e32 = image_embeds(retriever.params, rn50, x, retriever.cfg).double()
        e16 = image_embeds(bf16.params, rn50, x, bf16.cfg).double()
        cos = float(((e32 * e16).sum(1) / e32.norm(dim=1) / e16.norm(dim=1)).min())
    check(cos >= RN_BF16_COSINE, f"rn: bf16 embeddings at cosine {cos} of fp32")
    del x, e32, e16

    gen = torch.Generator(device="cuda").manual_seed(RN_SEED + 3)
    rest = torch.where(torch.rand((GALLERY - N_IMAGES, K_BITS), generator=gen,
                                  device="cuda") < 0.5, -1, 1).to(torch.int8)
    index = HashIndex(torch.cat([torch.from_numpy(img_codes).cuda(), rest]), packed=True,
                      **retriever._index_kw())
    del rest
    q512 = txt_codes[:SEARCH_Q]
    dists, found = index.search(q512, 10)
    check(dists.shape == (SEARCH_Q, 10) and np.all(np.diff(dists, axis=1) >= 0),
          "rn: search results")
    rates["search_ms_per_512_packed"] = 1e3 * host_s(lambda: index.search(q512, 10))

    service = RetrievalService(retriever, {"image": index})
    server = serve(service, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        health = http(port, "/healthz")
        check(health["ok"] and health["indexes"] == {"image": GALLERY}, f"rn healthz {health}")
        buf = io.BytesIO()
        np.save(buf, images[:4])
        got = http(port, "/v1/encode", {"images_b64": base64.b64encode(buf.getvalue()).decode()})
        check(np.array_equal(np.asarray(got["codes"]), img_codes[:4]),
              "rn: /v1/encode images_b64 differs from Retriever.encode_images")
        got = http(port, "/v1/encode", {"texts": texts[:8]})
        check(np.array_equal(np.asarray(got["codes"]), retriever.encode_texts(texts[:8])),
              "rn: /v1/encode texts differs from Retriever.encode_texts")
        for j in range(4):
            got = http(port, "/v1/search", {"texts": [texts[j]], "k": 10})
            d, i = index.search(retriever.encode_texts([texts[j]]), 10)
            check(got["indices"] == i.tolist() and got["distances"] == d.tolist(),
                  f"rn: /v1/search answer {j} differs from HashIndex.search")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    launches = read_counts()
    for kernel in ("fused_attention_fwd", "hamming_distance_packed", "fused_layer_norm",
                   "fused_add_layer_norm"):
        check(launches[kernel] > 0, f"rn: the serving path never launched {kernel}")
    check(launches["fused_attention_bwd"] == 0, "rn: serving launched the backward")
    for kernel, n in launches.items():
        total[kernel] = total.get(kernel, 0) + n
    say("rn", run="RN50 DCHMT K=64 serving", http="ok", **launches,
        **{k: round(v, 4) for k, v in rates.items()}, bf16_min_cosine=cos)
    del retriever, bf16, index, service
    torch.cuda.empty_cache()


def rn_path():
    """Phase 15: OpenAI's RN50 at full width from a seeded OpenAI-layout
    ``.pt``: read back through ``--clip-path``'s loader; its fp32 embedding
    on the card against the port on the CPU; serving (rn_serving); DSPH
    and DCHMT K=64 through ``ccmh_torch.cli.main --clip-path`` at batch 128,
    2 steps each with fp32 and bf16 towers (every leaf moved, BatchNorm's
    mean and var included; DSPH's ``.npz`` serving the trainer's codes;
    the step split by CUDA events, peak memory); gradients computed twice
    with cuDNN's default algorithms and with the deterministic ones the
    port sets (the same bits?, step ms each; the deterministic ones must
    repeat); DSPH cut by SIGTERM after step 3 and resumed, bit-equal to
    the uninterrupted run.  LayerNorm kernels on; returns the summed
    launches."""
    import torch

    from ccmh_torch.clip import model as cm
    from ccmh_torch.clip.convert import load_clip_params
    from ccmh_torch.models.heads import linear_hash
    from ccmh_torch.train.methods.base import image_embeds, text_embeds
    from ccmh_torch.train.optim import tree_leaves_with_path

    work = os.path.join(WORK, "rn")
    os.makedirs(work, exist_ok=True)
    data = os.path.join(WORK, "train_data")      # written by phase 5
    rn50 = rn50_config()
    total = {}

    def add(launches):
        for kernel, n in launches.items():
            total[kernel] = total.get(kernel, 0) + n

    def check_launches(what, launches, want):
        for kernel, n in launches.items():
            check(n == want.get(kernel, 0), f"rn {what}: {n} launches of {kernel}, the code "
                                            f"implies {want.get(kernel, 0)}")

    # 1. the seeded tower as an OpenAI-layout .pt, read back as --clip-path reads it
    tower = os.path.join(work, "rn50.pt")
    t0 = time.perf_counter()
    clip0 = _rn_tower(RN_SEED)
    sd = _rn_state_dict(clip0)
    torch.save(sd, tower)
    pt_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded, cfg = load_clip_params(tower, device="cuda")
    load_s = time.perf_counter() - t0
    check(cfg == rn50 and isinstance(cfg.vision_layers, tuple),
          f"rn: the tower .pt reads as {cfg}")
    want = dict(tree_leaves_with_path(clip0))
    got = dict(tree_leaves_with_path(loaded))
    check(sorted(got) == sorted(want) and all(torch.equal(got[p], want[p]) for p in want),
          "rn: the tower read from the .pt differs from the seeded tree")
    n_vision = sum(t.numel() for _, t in tree_leaves_with_path(clip0["visual"]))
    n_text = sum(t.numel() for _, t in tree_leaves_with_path(clip0["text"]))
    say("rn", model="RN50 CLIP", vision_params=n_vision, text_params=n_text,
        state_dict_keys=len(sd), num_batches_tracked=sum(k.endswith("num_batches_tracked")
                                                         for k in sd),
        pt_mb=round(os.path.getsize(tower) / 2 ** 20, 1), write_s=round(pt_s, 2),
        load_s=round(load_s, 2))
    del loaded, got, want, sd

    # 2. the card's fp32 embedding against the port on the CPU
    images = random_images(N_IMAGES, rn50.image_resolution, seed=RN_SEED + 4)
    x = images[:RN_CPU_IMAGES]
    with torch.inference_mode():
        card = cm.vision_forward(clip0["visual"], rn50, torch.from_numpy(x).cuda()).pooled
        visual_cpu = _to_cpu(clip0["visual"])
        t0 = time.perf_counter()
        host = cm.vision_forward(visual_cpu, rn50, torch.from_numpy(x)).pooled.double()
        cpu_s = time.perf_counter() - t0
        card = card.cpu().double()
    check(bool(torch.isfinite(card).all()) and card.shape == (RN_CPU_IMAGES, rn50.embed_dim),
          f"rn: card embedding {tuple(card.shape)}")
    rel = ((card - host).norm(dim=1) / host.norm(dim=1)).max().item()
    check(rel <= RN_CPU_TOL, f"rn: the card's fp32 embedding is {rel} (relative norm) from "
                             f"the CPU's, above {RN_CPU_TOL}")
    say("rn", check="fp32 embedding, card vs CPU", images=RN_CPU_IMAGES, max_rel_norm=rel,
        tol=RN_CPU_TOL, cpu_s=round(cpu_s, 2), embedding_norm=host.norm(dim=1).tolist())
    del visual_cpu, card, host

    cm.set_ln_impl("fused")
    try:
        # 3. serving
        rn_serving(work, tower, clip0, images, total)
        del images, clip0
        torch.cuda.empty_cache()

        # 4. DSPH and DCHMT through the CLI, fp32 and bf16 towers
        def argv(method, dtype, save_dir, epochs=1):
            return ["--method", method, "--dataset", "synthetic", "--output-dim", str(K_BITS),
                    "--data-dir", data, "--epochs", str(epochs),
                    "--batch-size", str(TRAIN_BATCH), "--train-num", str(RN_STEPS * TRAIN_BATCH),
                    "--query-num", str(TRAIN_QUERY), "--eval-batch", str(BATCH),
                    "--clip-path", tower, "--display-step", "1", "--no-valid",
                    "--num-workers", "4", "--device", "cuda", "--compute-dtype", dtype,
                    "--save-dir", os.path.join(work, save_dir)]

        def code_margin(kind, retriever, cfg, x):
            embeds = image_embeds if kind == "image" else text_embeds
            head = retriever.params["img_head" if kind == "image" else "txt_head"]
            return linear_hash(head, embeds(retriever.params, retriever.clip_cfg, x, cfg)).abs()

        runs, splits = {}, {}
        for method in ("DSPH", "DCHMT"):
            for dname, dtype in (("fp32", "float32"), ("bf16", "bfloat16")):
                label = f"{method} {dname}"
                steps, start = [], {}
                flags = ["--save-model"] if (method, dname) == ("DSPH", "fp32") else []
                trainer, launches, peak = _timed_run(
                    argv(method, dtype, f"{method}_{dname}") + flags, steps, start)
                check_launches(label, launches, rn_launches(RN_STEPS, RN_STEPS))
                add(launches)
                losses = [r["loss"] for r in _metric_rows(trainer.cfg.save_dir)
                          if r["event"] == "train"]
                check(trainer.state.step == RN_STEPS and len(losses) == RN_STEPS
                      and all(math.isfinite(v) for v in losses), f"rn {label}: losses {losses}")
                moved = _moved(start, trainer.state.params)
                bn = _bn_leaves(trainer.state.params)
                now = dict(tree_leaves_with_path(trainer.state.params))
                bn_moved = sum(not torch.equal(now[p].detach(), start[p]) for p in bn)
                check(moved == len(start) and bn_moved == len(bn),
                      f"rn {label}: {moved} of {len(start)} leaves moved, {bn_moved} of "
                      f"{len(bn)} BatchNorm mean and var")
                runs[label] = {"losses": losses, "step_ms": steps, "peak_bytes": peak,
                               "leaves_moved": moved, "bn_stat_leaves_moved": bn_moved}
                if flags:
                    reset_counts()
                    check_served_codes("rn", trainer,
                                       os.path.join(trainer.cfg.save_dir, "model-0.npz"),
                                       code_margin, k_bits=K_BITS)
                if dname == "fp32":
                    # the step split by CUDA events, fp32 and bf16 towers
                    tr = trainer
                    batch = tr._put(next(iter(tr.train_loader)))
                    batch["epoch"] = torch.tensor(0, dtype=torch.int32, device="cuda")
                    opts = [tr.optimizer] + ([tr.extra_optimizer] if tr.extra_optimizer else [])
                    for tname, tdtype in (("fp32", "float32"), ("bf16", "bfloat16")):
                        cfg = tr.cfg.replace(compute_dtype=tdtype)
                        splits[f"{method}_{tname}"] = time_train_steps(
                            tr.method.make_loss_fn(cfg, tr.clip_cfg), tr.state, batch, opts,
                            steps=3, warm=1, grad_clip=tr.method.grad_clip)
                    if method == "DSPH":
                        # cuDNN's default algorithms against the deterministic
                        # ones the port sets (ccmh_torch/__init__.py)
                        check(torch.backends.cudnn.deterministic,
                              "rn: the port did not set cuDNN's deterministic algorithms")
                        for det in (False, True):
                            torch.backends.cudnn.deterministic = det
                            try:
                                same = _rn_grads_twice(tr, batch)
                                ms = time_train_steps(tr.method.make_loss_fn(tr.cfg, tr.clip_cfg),
                                                      tr.state, batch, opts, steps=3, warm=1)
                            finally:
                                torch.backends.cudnn.deterministic = True
                            splits[f"DSPH_fp32_cudnn_deterministic_{det}"] = {
                                **ms, "gradients_twice_same_bits": same}
                        check(splits["DSPH_fp32_cudnn_deterministic_True"][
                            "gradients_twice_same_bits"], "rn: cuDNN's deterministic "
                                                          "algorithms gave other gradient bits")
                    del tr, batch, opts
                del trainer
                torch.cuda.empty_cache()
        say("rn", run="DSPH and DCHMT K=64 batch 128 through the CLI", by_run=runs)
        say("rates", rn50_train_step_batch=TRAIN_BATCH, ln="fused", **splits)

        # 5. DSPH fp32: A uninterrupted (2 epochs of 2 steps, a slot each
        # epoch); B cut by SIGTERM after global step 3 and resumed
        base = argv("DSPH", "float32", "A", epochs=2)[:-2] + ["--checkpoint-every", "1"]

        def run_dir(name):
            return os.path.join(work, name, "DSPH", "synthetic", str(K_BITS))

        timings = {}
        for name, flags, cut, n_steps in (("A", [], None, 2 * RN_STEPS),
                                          ("B", [], 3, 3), ("B", ["--resume"], None, 1)):
            _, launches, _ = _lifecycle_run(base + ["--save-dir", os.path.join(work, name)]
                                            + flags, timings, cut_at=cut)
            check_launches(f"{name}{' '.join(flags)}", launches, rn_launches(n_steps, n_steps))
            add(launches)
            torch.cuda.empty_cache()
        slot_a = _final_slot(run_dir("A"))
        diff = _tree_diff(_final_slot(run_dir("B")), slot_a) + (
            ["metrics.jsonl"] if _metric_rows(run_dir("B")) != _metric_rows(run_dir("A")) else [])
        check(not diff, f"rn: the resumed RN50 run differs from the uninterrupted one at "
                        f"{diff[:8]}")
        with open(os.path.join(run_dir("B"), "train.log")) as fh:
            check("fast-forwarding 1 steps" in fh.read(), "rn: the resumed run did not "
                                                          "fast-forward")
        say("rn", run="RN50 DSPH fp32 cut by SIGTERM after step 3 and resumed",
            resumed_equal_to_A="params (BatchNorm statistics included), extra, aux, both "
            "optimizers, generator, step, meta, every train row", **timings)
    finally:
        cm.set_ln_impl("plain")
    shutil.rmtree(work, ignore_errors=True)
    return total


def _to_cpu(tree):
    return {k: _to_cpu(v) if isinstance(v, dict) else v.detach().cpu() for k, v in tree.items()}


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

    # the four methods with extra state (slice 11), LayerNorm kernels on:
    # each run resets the counts just before it and reads them just after
    t11 = time.perf_counter()
    extra_state = extra_state_path()
    say("launches", path="extra_state", **extra_state)
    say("extra_state", phase_seconds=round(time.perf_counter() - t11, 1))

    # the lifecycle (slice 12): tower import, train, preemption, resume,
    # --test and reference export; each run resets the counts just before
    # it and reads them just after
    t12 = time.perf_counter()
    lifecycle = lifecycle_path()
    say("launches", path="lifecycle", **lifecycle)
    say("lifecycle", phase_seconds=round(time.perf_counter() - t12, 1))

    # the real-data input path (slice 13): JPEG decode, BPE, caches,
    # prefetch, residency and JPEG serving; each run resets the counts just
    # before it and reads them just after
    t13 = time.perf_counter()
    input_launches = input_path()
    say("launches", path="input", **input_launches)
    say("input", phase_seconds=round(time.perf_counter() - t13, 1))

    # the towers past 128 tokens (slice 14): the long path of #1 and #2
    # and #3 past 256 bits against their plain versions, then ViT-L/14
    # serving and training, ViT-B/16, bf16 moments and --profile; each run
    # resets the counts just before it and reads them just after
    t14 = time.perf_counter()
    for name in ("attention", "attention_bwd"):
        wgmma_report(name)
    long_cases = {"fwd": [], "bwd": []}
    for dt in (torch.float32, torch.bfloat16):
        for name, B, L, H in LONG_SHAPES:
            fwd_case, bwd_case = long_attention_cases(name, B, L, H, dt)
            long_cases["fwd"].append(fwd_case)
            long_cases["bwd"].append(bwd_case)
            torch.cuda.empty_cache()
    edge_families = long_attention_edges()
    for kernel, counts in edge_families.items():
        check(counts["long_wgmma"] > 0 and counts["long_mma"] > 0,
              f"phase 14's edges launched {kernel} by family {counts}: the long path needs "
              f"both the wgmma kernels and the mma.sync ones (other head dims, views at odd "
              f"offsets)")
    tf32_selftest()
    wide_cases = wide_hamming_cases()
    torch.cuda.empty_cache()
    long_launches, long_families = long_path()
    say("launches", path="long", **long_launches)
    say("long", phase_seconds=round(time.perf_counter() - t14, 1))

    # OpenAI's RN50 (slice 17): serving and training from a seeded
    # OpenAI-layout .pt, LayerNorm kernels on; each run resets the counts
    # just before it and reads them just after
    t15 = time.perf_counter()
    rn = rn_path()
    say("launches", path="rn", **rn)
    say("rn", phase_seconds=round(time.perf_counter() - t15, 1))

    by_path = {k: {"serving": serving[k], "training": training[k],
                   "linear_hash": linear_hash[k], "attn_ablation": ablation[k],
                   "token_methods": token[k], "extra_state": extra_state[k],
                   "lifecycle": lifecycle[k], "input": input_launches.get(k, 0),
                   "long": long_launches.get(k, 0), "rn": rn.get(k, 0)}
               for k in serving}

    def entry(name, source, replaces, launches, cases):
        top = cases[0]   # vision fp32 (the default's dominant call) or the search
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "launches_by_path": by_path[name],
                **({"long_launches_by_family": long_families[name]}
                   if name in long_families else {}),
                "max_abs_err": top["max_abs_err"], "ms": top["ms"],
                "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
                "bound_by": top["bound_by"], "library_ms": top["library_ms"],
                **({"library": top["library"]} if "library" in top else {}),
                "cases": cases}

    kernels = [
        entry("fused_attention_fwd", "ccmh_torch/csrc/attention.cu",
              "ccmh/ops/attention.py:123", training["fused_attention_fwd"],
              attn_cases + long_cases["fwd"]),
        entry("fused_attention_bwd", "ccmh_torch/csrc/attention_bwd.cu",
              "ccmh/ops/attention.py:235", training["fused_attention_bwd"],
              bwd_cases + long_cases["bwd"]),
        entry("hamming_distance_packed", "ccmh_torch/csrc/hamming.cu",
              "ccmh/ops/hamming.py:56", serving["hamming_distance_packed"],
              [ham_case] + wide_cases),
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
