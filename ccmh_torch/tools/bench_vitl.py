"""ViT-L/14 encode throughput on one card: a bf16 image + text encode pair.

    python -m ccmh_torch.tools.bench_vitl [B] [--device cuda|cpu] [--tiny]

Port of ``tools/bench_vitl.py``.  It builds the weight-free ViT-L/14
(``ClipConfig.vit_l14()``: 24 vision blocks of width 1024 over 257
tokens, whose attention takes the long path of kernels #1 and #2, and 12
text blocks of width 768) from a seed, casts its weights to bf16 once (as
a bf16 server does), and times the pair ``vision_forward(images).pooled``
+ ``text_forward(ids).pooled`` at batch B (default 64) on 32-token texts.

Timing, as the TPU tool: a chained loop, each pair's sum fed back into
the next pair's images, so no pair repeats another; per pair the minimum
over 3 repeats of (t_8 - t_2) / 6 from CUDA events.  It prints one JSON
line: ms per pair, image + text pairs/s, and TFLOP/s from the analytic
count of ``floors.encode_flops`` (the port has no compiler cost analysis),
with the card's name and power limit.

Without a card the default device raises; ``--device cpu`` runs the loop
once and times nothing (``ms`` null), and ``--tiny`` takes
``ClipConfig.tiny()``, for the tests.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys

import numpy as np
import torch

from ccmh_torch.clip.model import (
    ClipConfig, cast_clip_params, init_clip_params, text_forward, vision_forward,
)
from ccmh_torch.device import resolve_device
from ccmh_torch.tools.floors import TEXT_LEN, encode_flops

LOOPS = (2, 8)
REPEATS = 3


def inputs(cfg: ClipConfig, B: int, device: torch.device, dtype: torch.dtype):
    """Seeded normalised-scale images [B, R, R, 3] in ``dtype`` and token
    ids [B, 32]: start token, 30 random tokens, end token (the largest id)."""
    rng = np.random.RandomState(0)
    R = cfg.image_resolution
    images = torch.from_numpy(rng.randn(B, R, R, 3).astype(np.float32)).to(device, dtype)
    ids = np.zeros((B, TEXT_LEN), np.int64)
    ids[:, 0] = cfg.vocab_size - 2
    ids[:, 1:-1] = np.random.RandomState(1).randint(320, 40000, (B, TEXT_LEN - 2))
    ids[:, -1] = cfg.vocab_size - 1
    return images, torch.from_numpy(ids).to(device)


def encode_pair(params, cfg: ClipConfig, images: torch.Tensor, ids: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """The fp32 sum of both towers' pooled embeddings (one scalar a pair)."""
    img = vision_forward(params["visual"], cfg, images, dtype=dtype).pooled
    txt = text_forward(params["text"], cfg, ids, dtype=dtype).pooled
    return img.float().sum() + txt.float().sum()


def chained(params, cfg, images, ids, n: int, dtype=torch.bfloat16) -> torch.Tensor:
    """``n`` encode pairs, each pair's sum fed back into the next images."""
    acc = torch.zeros((), dtype=torch.float32, device=images.device)
    with torch.inference_mode():
        for _ in range(n):
            s = encode_pair(params, cfg, images, ids, dtype)
            images = images + (s * 1e-24).to(images.dtype)
            acc = acc + s
    return acc


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"


def pair_ms(run) -> float:
    """Min over REPEATS of (t_large - t_small) / (large - small), ms, from
    CUDA events around ``run(n)``."""
    small, large = LOOPS
    best = math.inf
    for _ in range(REPEATS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        run(small)
        ev[1].record()
        ev[2].record()
        run(large)
        ev[3].record()
        torch.cuda.synchronize()
        t = ev[2].elapsed_time(ev[3]) - ev[0].elapsed_time(ev[1])
        best = min(best, t / (large - small))
    return best


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("B", type=int, nargs="?", default=64, help="encode batch (64)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true", help="ClipConfig.tiny(), for the tests")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = ClipConfig.tiny() if args.tiny else ClipConfig.vit_l14()
    B = args.B
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_clip_params(gen, cfg)
    n_params = sum(t.numel() for t in _leaves(params))
    params = cast_clip_params(params, torch.bfloat16)
    images, ids = inputs(cfg, B, dev, torch.bfloat16)
    flops = encode_flops(cfg, B)
    row = {"tool": "bench_vitl", "config": "tiny" if args.tiny else "vit_l14",
           "B": B, "vision_tokens": cfg.n_patches + 1, "text_tokens": TEXT_LEN,
           "params_M": n_params / 1e6, "gflop_per_pair": flops / 1e9}
    total = chained(params, cfg, images, ids, LOOPS[0])
    if not torch.isfinite(total):
        raise RuntimeError(f"bench_vitl: the encode pair's sum is {float(total)}")
    if dev.type == "cuda":
        ms = pair_ms(lambda n: chained(params, cfg, images, ids, n))
        row.update(device=torch.cuda.get_device_name(dev), card=card_line(), ms=ms,
                   pairs_per_s=B / (ms / 1e3), tflops=flops / (ms / 1e3) / 1e12)
    else:
        row.update(device="cpu", card=None, ms=None, pairs_per_s=None, tflops=None)
    print(json.dumps(row), flush=True)
    return row


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    main(sys.argv[1:])
