#!/usr/bin/env python3
"""Compile variants of the attention kernels' sources side by side and time
each through its C entry, on one CUDA card.

    python3 tools/tune_torch_attention.py [VARIANTS.json]

The checkout's ``ccmh_torch/csrc/attention.cu`` and ``attention_bwd.cu``
are always built (``fwd_new``, ``bwd_new``).  VARIANTS.json lists more:
``[{"name": "fwd_x", "src": "attention.cu", "srcdir": "...", "subs":
[["old text", "new text"], ...]}, ...]``: the source file and the headers
beside it are copied from ``srcdir`` (default: the checkout's csrc) into
``build/tune_attention/<name>/``, each substitution is applied to every
file that holds its old text (it must match somewhere), and the variant is
compiled with the port's nvcc flags, all variants at once.  A name that
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
        report = [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
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
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * (4 if fwd else 5) + [
            ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kind_of(name):
    return next((k for k in ("fwd", "stacked", "bwd_x", "savedp") if name.startswith(k)), "bwd")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("tune_torch_attention: needs a CUDA card", file=sys.stderr)
        return 2
    from ccmh_torch.clip.model import causal_mask
    from ccmh_torch.ops import attention as attn
    from ccmh_torch.ops import attention_variants as av
    from ccmh_torch.tools import bench_attn_bwd as bench

    specs = json.load(open(argv[0])) if argv else []
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

    for dtype in (torch.bfloat16, torch.float32):
        for tag, B, L, H, causal in SHAPES:
            Dh, D = 64, H * 64
            gen = torch.Generator(device=dev).manual_seed(L)
            qkv = torch.randn((B, L, 3 * D), generator=gen, device=dev).to(dtype)
            qkv_b = (0.1 * torch.randn((3 * D,), generator=gen, device=dev)).to(dtype)
            g = torch.randn((B, L, D), generator=gen, device=dev).to(dtype)
            mask = causal_mask(L, device=dev) if causal else None
            want_f = attn.attention_reference(qkv, mask, H, qkv_b=qkv_b).float()
            want_b = attn.attention_backward_reference(qkv, mask, qkv_b, g, H).float()
            want_s = av.forward_stacked_reference(qkv, mask, H).float()
            scale = max(1.0, want_b.abs().max().item())
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
                    args = [0, qkv.data_ptr(), qkv_b.data_ptr(), mask_ptr]
                    args += ([] if fwd else [g.data_ptr()]) + [
                        out.data_ptr(), B, L, H, Dh, 1.0 / math.sqrt(Dh), code, stream]
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
            f, b = bench.sdpa_yardstick(qkv + qkv_b, causal, H, (40, 240), 3)
            row["sdpa_fwd"], row["sdpa_bwd"] = 1e3 * f, 1e3 * b
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
