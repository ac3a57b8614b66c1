#!/usr/bin/env python3
"""Compile variants of the attention kernels' sources side by side and time
each through its C entry, on one CUDA card.

    python3 tools/tune_torch_attention.py [VARIANTS.json] [--shapes short|long|limit]
                                          [--dtypes bf16,fp32]

The checkout's ``ccmh_torch/csrc/attention.cu`` and ``attention_bwd.cu``
are always built (``fwd_new``, ``bwd_new``).  VARIANTS.json lists more:
``[{"name": "fwd_x", "src": "attention.cu", "srcdir": "...", "subs":
[["old text", "new text"], ...]}, ...]``: the source file and the headers
beside it are copied from ``srcdir`` (default: the checkout's csrc) into
``build/tune_attention/<name>/``, each substitution is applied to every
file that holds its old text (it must match somewhere), and the variant is
compiled with the port's nvcc flags, all variants at once (ptxas's registers,
spills and any wgmma it serialises are printed for each).  A name that
starts with ``fwd`` is the forward's entry, one that starts with
``stacked`` the ablation bench's #7 (``ccmh_attention_fwd_stacked`` of
``attention_fwd_stacked.cu``, at bb=16 on the same q, k, v without the
projection bias), one that starts with ``bwd_x`` the bench's #6
(``ccmh_attention_bwd_x`` of ``attention_bwd_x.cu``, without the
projection bias, the text shape under the bench's -1e9 causal mask) in
its spec's ``"mode"`` (default ``full``) at its ``"bb"`` (default 4),
with ``_bwd_x_plan``'s plan or the spec's ``"groups"`` in its place, one
that starts with ``savedp`` the bench's #8 (``ccmh_attention_bwd_savedp``
of ``attention_savedp.cu``, at bb=4 from the probabilities
``savedp_probs`` saves, under the same mask) with ``_savedp_plan``'s plan,
its shared memory grown by the spec's ``"extra_ll_tiles"`` [L, L] tiles
(default 0), any other the backward's.

For vision B=256 L=50 H=12 and text B=256 L=32 H=8 causal (Dh=64, with
the projection bias), bf16 and fp32, it prints one JSON line with each
variant's µs per call (min over 3 of (t_240 - t_40) / 200 chained calls,
CUDA events) and whether it agrees with the plain version (fp32 1e-4, bf16
2e-2, the backward relative to its output scale; a variant that computes
something else on purpose, an ablation, prints BAD with its error), and
SDPA's forward and forward + backward minus forward beside them.
``--shapes long`` takes the towers past 128 tokens instead (ViT-B/16 B=256
L=197 H=12, ViT-L/14 B=64 L=257 H=16 and at L=256, ViT-L/14@336 B=64 L=577
H=16, no mask), ``--shapes limit`` ViT-L/14's B=64 H=16 at L = 272, 273,
288, 320, 336 and 337 (around the bf16 one-pass kernels' limits), where the C entries take the long path; ``--dtypes`` picks the
types (default both); ``--no-bias`` calls #1 and #2 without the
projection bias (nothing to fold into the tiles); ``--profile`` adds, for
each #1 and #2 variant, the device µs a call of each kernel it launches
(``torch.profiler`` over 10 calls: the backward's kernels one by one, in
bf16 up to 272 keys the one-pass query side ``attention_bwd_onepass_q``
beside kernel 2; in fp32 past 128 keys kernel 1,
``attention_bwd_wgmma32_stats``, and the warp-specialised kernels 2 and 3,
``attention_bwd_wgmma32_ws<1|2, mask>``).  A backward variant whose sources take the bf16 long
path's row-statistics buffer (``ccmh_attention_bwd_stats_width``) is
passed one; an older one (``*_parent``) is called without it.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "ccmh_torch", "csrc")
OUT = os.path.join(REPO, "build", "tune_attention")
SHAPES = (("vision", 256, 50, 12, False), ("text", 256, 32, 8, True))
LONG_SHAPES = (("ViT-B/16", 256, 197, 12, False), ("ViT-L/14", 64, 257, 16, False),
               ("ViT-L/14 L=256", 64, 256, 16, False), ("ViT-L/14@336", 64, 577, 16, False))
# ViT-L/14's batch and heads around the bf16 one-pass kernel's limit (336)
LIMIT_SHAPES = tuple((f"L={L}", 64, L, 16, False) for L in (272, 273, 288, 320, 336, 337))


def variant(name, src, subs=(), srcdir=CSRC):
    """Write the variant's sources; returns (name, path of its .cu)."""
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    texts = {f: open(os.path.join(srcdir, f)).read() for f in os.listdir(srcdir)
             if f == src or f.endswith(".cuh")}
    for old, new in subs:
        hit = False
        for f, t in texts.items():
            if old in t:
                texts[f] = t.replace(old, new)
                hit = True
        if not hit:
            raise SystemExit(f"{name}: {old!r} is in none of its sources")
    for f, t in texts.items():
        with open(os.path.join(d, f), "w") as fh:
            fh.write(t)
    return name, os.path.join(d, src)


def build(variants):
    """Compile every variant at once; returns name -> loaded library."""
    from ccmh_torch.ops import build as kbuild

    procs = []
    for name, path in variants:
        so = path[:-3] + ".so"
        procs.append((name, so, subprocess.Popen(
            [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        report = [ln.strip() for ln in log.splitlines()
                  if "Used" in ln or "spill" in ln or "serialized" in ln]
        print(json.dumps({"variant": name, "ptxas": report}), flush=True)
        libs[name] = ctypes.CDLL(so)
    return libs


def entry(lib, kind, n_ints=0):
    """The kind's C entry in ``lib``; #6's and #8's take ``n_ints`` ints
    after their pointers (B, L, H, Dh and ``_bwd_x_entry``'s or
    ``_savedp_entry``'s)."""
    if kind in ("bwd_x", "savedp"):
        fn = lib.ccmh_attention_bwd_x if kind == "bwd_x" else lib.ccmh_attention_bwd_savedp
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * n_ints + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    elif kind == "stacked":
        fn = lib.ccmh_attention_fwd_stacked
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    else:
        fwd = kind == "fwd"
        fn = lib.ccmh_attention_fwd if fwd else lib.ccmh_attention_bwd
        n_ptrs = 4 if fwd else 5 + takes_stats(lib)
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * n_ptrs + [
            ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def takes_stats(lib) -> bool:
    """Whether the backward entry of ``lib`` takes the bf16 long path's
    row-statistics buffer after dqkv (sources that export
    ``ccmh_attention_bwd_stats_width``; older ones do not)."""
    return hasattr(lib, "ccmh_attention_bwd_stats_width")


def kernel_us(fn, calls: int = 10) -> dict:
    """Device µs a call of each kernel ``fn`` launches, by kernel name
    (``torch.profiler`` over ``calls`` calls after one)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if us > 0:
            out[ev.key[:90]] = us / calls
    return out


def kind_of(name):
    return next((k for k in ("fwd", "stacked", "bwd_x", "savedp") if name.startswith(k)), "bwd")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="?", help="JSON list of source variants")
    ap.add_argument("--shapes", choices=("short", "long", "limit"), default="short")
    ap.add_argument("--dtypes", default="bf16,fp32")
    ap.add_argument("--no-bias", action="store_true",
                    help="#1 and #2 without the projection bias")
    ap.add_argument("--profile", action="store_true",
                    help="the device us a call of each kernel #1 and #2 launch")
    args_ns = ap.parse_args(sys.argv[1:] if argv is None else argv)
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("tune_torch_attention: needs a CUDA card", file=sys.stderr)
        return 2
    from ccmh_torch.clip.model import causal_mask
    from ccmh_torch.ops import attention as attn
    from ccmh_torch.ops import attention_variants as av
    from ccmh_torch.tools import bench_attn_bwd as bench

    specs = json.load(open(args_ns.variants)) if args_ns.variants else []
    dtypes = [{"bf16": torch.bfloat16, "fp32": torch.float32}[d]
              for d in args_ns.dtypes.split(",")]
    vs = [variant("fwd_new", "attention.cu"), variant("bwd_new", "attention_bwd.cu")]
    vs += [variant(sp["name"], sp["src"], [tuple(x) for x in sp.get("subs", [])],
                   sp.get("srcdir", CSRC)) for sp in specs]
    libs = build(vs)
    plans = {sp["name"]: sp for sp in specs}
    dev = torch.device("cuda")

    def steady_ms(fn):
        def run(n):
            for _ in range(n):
                fn()
        run(40)
        return bench._events_ms(run, 40, 240, 3)

    for dtype in dtypes:
        for tag, B, L, H, causal in {"long": LONG_SHAPES, "limit": LIMIT_SHAPES}.get(
                args_ns.shapes, SHAPES):
            Dh, D = 64, H * 64
            gen = torch.Generator(device=dev).manual_seed(L)
            qkv = torch.randn((B, L, 3 * D), generator=gen, device=dev).to(dtype)
            qkv_b = (0.1 * torch.randn((3 * D,), generator=gen, device=dev)).to(dtype)
            g = torch.randn((B, L, D), generator=gen, device=dev).to(dtype)
            if args_ns.no_bias:
                qkv_b = None
            mask = causal_mask(L, device=dev) if causal else None
            want_f = attn.attention_reference(qkv, mask, H, qkv_b=qkv_b).float()
            want_b = attn.attention_backward_reference(qkv, mask, qkv_b, g, H).float()
            want_s = av.forward_stacked_reference(qkv, mask, H).float() \
                if any(kind_of(n) == "stacked" for n, _ in vs) else None
            scale = max(1.0, want_b.abs().max().item())
            stats = torch.empty((B, H, L, attn.STATS_WIDTH), dtype=torch.float32, device=dev)
            code = 0 if dtype == torch.float32 else 1
            stream = torch.cuda.current_stream().cuda_stream
            row = {"shape": tag, "dtype": str(dtype).split(".")[-1]}
            bench_mask = bench.causal_bias(L, dev) if causal else None
            for name, _ in vs:
                kind = kind_of(name)
                fwd = kind in ("fwd", "stacked")
                out = torch.empty((B, L, D) if fwd else (B, L, 3 * D), dtype=dtype, device=dev)
                mask_ptr = None if mask is None else mask.data_ptr()
                cols = slice(None)
                ints = ()
                if kind == "bwd_x":
                    sp = plans[name]
                    mode, bb = sp.get("mode", "full"), sp.get("bb", 4)
                    plan = av._bwd_x_plan(mode, L, Dh, qkv.element_size(), bb,
                                          groups=sp.get("groups"))
                    _, _, ints = av._bwd_x_entry(mode, L, Dh, qkv.element_size(), bb, plan)
                    bm = None if bench_mask is None else bench_mask.data_ptr()
                    args = [0, qkv.data_ptr(), bm, g.data_ptr(), out.data_ptr(), B, L, H, Dh,
                            *ints, 1.0 / math.sqrt(Dh), code, stream]
                    want_x = av.backward_x_reference(qkv, bench_mask, g, H, mode).float()
                    if mode == "fewstores":
                        cols = slice(D, 2 * D)
                elif kind == "savedp":
                    sp = plans[name]
                    probs = av.savedp_probs(qkv, bench_mask, H)
                    item = qkv.element_size()
                    plan = av._savedp_plan(L, Dh, item, probs.data_ptr())
                    plan = plan._replace(smem_bytes=plan.smem_bytes + sp.get("extra_ll_tiles", 0)
                                         * av._pad16(L) * av._tile_ld(L, item) * item)
                    _, _, ints = av._savedp_entry(L, Dh, item, 4, probs.data_ptr(), plan)
                    args = [0, qkv.data_ptr(), probs.data_ptr(), g.data_ptr(), out.data_ptr(), B,
                            L, H, Dh, *ints, 1.0 / math.sqrt(Dh), code, stream]
                    want_x = av.backward_savedp_reference(qkv, probs, g, H).float()
                elif kind == "stacked":
                    args = [0, qkv.data_ptr(), mask_ptr, out.data_ptr(), B, L, H, Dh, 16,
                            1.0 / math.sqrt(Dh), code, stream]
                else:
                    args = [0, qkv.data_ptr(), None if qkv_b is None else qkv_b.data_ptr(),
                            mask_ptr]
                    args += ([] if fwd else [g.data_ptr()]) + [out.data_ptr()]
                    if not fwd and takes_stats(libs[name]):
                        args.append(stats.data_ptr())
                    args += [B, L, H, Dh, 1.0 / math.sqrt(Dh), code, stream]
                fn = entry(libs[name], kind, 4 + len(ints))
                err = fn(*args)
                torch.cuda.synchronize()
                if err:
                    row[name] = f"CUDA error {err}"
                    continue
                want = want_x if kind in ("bwd_x", "savedp") else {
                    "fwd": want_f, "stacked": want_s, "bwd": want_b}[kind]
                e = (out[..., cols].float() - want[..., cols]).abs().max().item()
                out_scale = max(1.0, want[..., cols].abs().max().item()) \
                    if kind in ("bwd_x", "savedp") else scale
                tol = (1e-4 if code == 0 else 2e-2) * (1.0 if fwd else out_scale)
                row[name] = [1e3 * steady_ms(lambda: fn(*args)),
                             "ok" if e <= tol else f"BAD {e}"]
                if args_ns.profile and kind in ("fwd", "bwd"):
                    row[name].append(kernel_us(lambda: fn(*args)))
            f, b = bench.sdpa_yardstick(qkv if qkv_b is None else qkv + qkv_b, causal, H,
                                        (40, 240), 3)
            row["sdpa_fwd"], row["sdpa_bwd"] = 1e3 * f, 1e3 * b
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
