#!/usr/bin/env python3
"""Where the ccmh_torch serving path spends its time on one NVIDIA card.

    python3 tools/profile_torch_serving.py [--batch 256] [--gallery 1048576]

Builds a seeded random ViT-B/32 DCHMT K=64 Retriever on the card and runs
``torch.profiler`` (CPU + CUDA activities) over one steady-state call of
each serving step: image encode and text encode of one batch in fp32 and
bf16, and one packed and one int8 search of 512 queries over the gallery.
For each step it prints one JSON line: the host wall time of the call, the
summed device time of its kernels and copies, the device idle share
(1 - device / wall) and the device time by kernel class (matmul, the
fused attention kernel, the popcount kernel, top-k, host-to-device copies,
other), with the top kernels by name.  Kernel names are truncated to 120
characters.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _classify(name: str) -> str:
    n = name.lower()
    if "attention_fwd_kernel" in n:
        return "fused_attention_kernel"
    if "attention_bwd_kernel" in n:
        return "fused_attention_bwd_kernel"
    if "hamming_packed_kernel" in n:
        return "popcount_kernel"
    if "layer_norm_kernel<" in n and "at::native" not in n:
        return "fused_layernorm_kernel"
    if "memcpy htod" in n or "memcpy h2d" in n:
        return "h2d_copy"
    if "memcpy dtoh" in n or "memcpy d2h" in n:
        return "d2h_copy"
    if any(s in n for s in ("gemm", "xmma", "cutlass", "nvjet", "sm90_", "sm80_")):
        return "matmul"
    if "topk" in n or "sort" in n or "radix" in n:
        return "topk"
    return "other"


def profile_step(name: str, fn, top: int = 6):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()                                   # warm: allocator, cuBLAS handles
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()                               # ends in a device-to-host copy
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_class, by_name = {}, {}
    for evt in prof.events():
        # device-side records only (kernels, copies, memsets); the CPU ops
        # that launched them carry the same time again, and so do the device
        # spans of record_function ranges (e.g. "Optimizer.step#...")
        if (evt.device_type != DeviceType.CUDA or evt.name.startswith("Activity Buffer")
                or getattr(evt, "is_user_annotation", False)):
            continue
        ms = (evt.time_range.end - evt.time_range.start) / 1e3
        cls = _classify(evt.name)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        by_name[evt.name] = by_name.get(evt.name, 0.0) + ms
    device_ms = sum(by_class.values())
    out = {
        "step": name, "wall_ms": wall_ms, "device_ms": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "device_ms_by_class": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": {k[:120]: v for k, v in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:top]},
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--gallery", type=int, default=2 ** 20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_serving: needs a CUDA card", file=sys.stderr)
        return 2
    from ccmh_torch.clip.model import ClipConfig, init_clip_params
    from ccmh_torch.config import Config
    from ccmh_torch.ops.build import build_all
    from ccmh_torch.retrieval import HashIndex, Retriever
    from ccmh_torch.train.methods import get_method

    build_all()
    cfg = Config(method="DCHMT", output_dim=64, max_words=32, nclass=80)
    clip_cfg = ClipConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    method = get_method("DCHMT")
    heads, _, aux = method.init(gen, cfg, clip_cfg)
    params = {"clip": init_clip_params(gen, clip_cfg), **heads}
    r32 = Retriever(method, params, aux, cfg, clip_cfg, device="cuda")
    r16 = Retriever(method, params, aux, cfg.replace(compute_dtype="bfloat16"),
                    clip_cfg, device="cuda")
    rng = np.random.default_rng(1)
    res = clip_cfg.image_resolution
    images = rng.standard_normal((args.batch, res, res, 3), dtype=np.float32)
    ids = np.zeros((args.batch, 32), np.int32)
    ids[:, 0], ids[:, 1:12] = 49406, rng.integers(1, 49405, (args.batch, 11))
    ids[:, 12] = 49407

    print(json.dumps({"card": torch.cuda.get_device_name(0), "torch": torch.__version__,
                      "batch": args.batch, "gallery": args.gallery}), flush=True)
    for tag, r in (("fp32", r32), ("bf16", r16)):
        profile_step(f"image_encode_{tag}", lambda: r.encode_images(images, args.batch))
        profile_step(f"text_encode_{tag}", lambda: r.encode_texts(ids, args.batch))
    codes = torch.where(torch.rand((args.gallery, 64), generator=gen, device="cuda") < 0.5,
                        -1, 1).to(torch.int8)
    queries = codes[:512].cpu().numpy()
    for tag, packed in (("packed", True), ("int8", False)):
        index = HashIndex(codes, packed=packed, device="cuda")
        profile_step(f"search_512_{tag}", lambda: index.search(queries, 10))
    return 0


if __name__ == "__main__":
    sys.exit(main())
