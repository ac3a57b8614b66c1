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

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def profile_step(name: str, fn, top: int = 6):
    """One JSON line of ``torch.profiler`` over one steady ``fn()``
    (``ccmh_torch/tools/step_split.py`` ``profile_ranges``)."""
    from ccmh_torch.tools.step_split import profile_ranges

    prof = profile_ranges(fn, ranges=(), top=top)
    out = {"step": name, **{k: prof[k] for k in ("wall_ms", "device_ms", "device_idle_share",
                                                 "device_ms_by_class", "top_kernels_ms")}}
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
