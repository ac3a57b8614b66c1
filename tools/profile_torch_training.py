#!/usr/bin/env python3
"""Where the ccmh_torch train step spends its time on one NVIDIA card.

    python3 tools/profile_torch_training.py [--batch 128] [--method DCHMT]

Builds a seeded random ViT-B/32 K=64 model of the method (any ported one),
BertAdam with the Trainer's param groups (``make_main_optimizer``), the
method's own optimizer for its ``extra`` parameters where it has one, and
one random batch of CLIP-normalized 224x224 images, caption ids and labels
(24 classes) on the card, and runs ``torch.profiler`` (CPU + CUDA
activities) over one steady-state train step (forward, loss, backward,
optimizers) in fp32, in bf16 (``compute_dtype``), in fp32 with the plain
attention (``set_attn_impl("plain")``) and in fp32 and bf16 with the
LayerNorm kernels (``set_ln_impl("fused")``).  For each it prints one JSON
line in the format of ``tools/profile_torch_serving.py``: host wall time,
summed device time, device idle share, device time by kernel class
(matmul, the fused attention forward and backward kernels, the LayerNorm
kernels, other) and the top kernels.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.profile_torch_serving import profile_step  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--method", default="DCHMT")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_training: needs a CUDA card", file=sys.stderr)
        return 2
    from ccmh_torch.clip import model as cm
    from ccmh_torch.clip.model import ClipConfig, init_clip_params
    from ccmh_torch.config import Config
    from ccmh_torch.ops.build import build_all
    from ccmh_torch.train.methods import get_method
    from ccmh_torch.train.state import (
        TrainState, make_main_optimizer, make_train_step, trainable,
    )

    build_all()
    cfg = Config(method=args.method, output_dim=64, max_words=32, epochs=100, nclass=24)
    clip_cfg = ClipConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    method = get_method(args.method)
    heads, extra, aux = method.init(gen, cfg, clip_cfg)
    params = trainable({"clip": init_clip_params(gen, clip_cfg), **heads})
    opt = make_main_optimizer(cfg, params, steps_per_epoch=100)
    extra_opt = None
    if extra is not None and method.extra_optimizer is not None:
        extra = trainable(extra)
        extra_opt = method.extra_optimizer(cfg, extra)
    state = TrainState(params, extra, aux, 0, torch.Generator(device="cuda").manual_seed(1))

    rng = np.random.default_rng(1)
    B, res = args.batch, clip_cfg.image_resolution
    ids = np.zeros((B, 32), np.int32)
    ids[:, 0], ids[:, 1:12] = 49406, rng.integers(1, 49405, (B, 11))
    ids[:, 12] = 49407
    labels = (rng.random((B, 24)) < 0.2).astype(np.float32)
    labels[np.arange(B), rng.integers(0, 24, B)] = 1.0
    batch = {"image": torch.from_numpy(rng.standard_normal((B, res, res, 3), dtype=np.float32)),
             "text": torch.from_numpy(ids), "label": torch.from_numpy(labels),
             "epoch": torch.tensor(0, dtype=torch.int32)}
    batch = {k: v.cuda() for k, v in batch.items()}

    print(json.dumps({"card": torch.cuda.get_device_name(0), "torch": torch.__version__,
                      "batch": B, "model": f"ViT-B/32 {args.method} K=64"}), flush=True)
    for tag, dtype, attn, ln in (("fp32", "float32", "fused", "plain"),
                                 ("bf16", "bfloat16", "fused", "plain"),
                                 ("fp32_plain_attention", "float32", "plain", "plain"),
                                 ("fp32_ln_fused", "float32", "fused", "fused"),
                                 ("bf16_ln_fused", "bfloat16", "fused", "fused")):
        step = make_train_step(method.make_loss_fn(cfg.replace(compute_dtype=dtype), clip_cfg),
                               opt, extra_opt)
        cm.set_attn_impl(attn)
        cm.set_ln_impl(ln)
        try:
            profile_step(f"train_step_{tag}", lambda: step(state, batch), top=8)
        finally:
            cm.set_attn_impl("fused")
            cm.set_ln_impl("plain")
    return 0


if __name__ == "__main__":
    sys.exit(main())
