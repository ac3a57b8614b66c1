#!/usr/bin/env python3
"""Where the ccmh_torch DCHMT train step spends its time on one NVIDIA card.

    python3 tools/profile_torch_training.py [--batch 128]

Builds a seeded random ViT-B/32 DCHMT K=64 model, BertAdam with the
Trainer's param groups (``make_main_optimizer``) and one random batch of
CLIP-normalized 224x224 images, caption ids and labels on the card, and
runs ``torch.profiler`` (CPU + CUDA activities) over one steady-state train
step (forward, loss, backward, BertAdam) in fp32, in bf16
(``compute_dtype``) and in fp32 with the plain attention
(``set_attn_impl("plain")``).  For each it prints one JSON line in the
format of ``tools/profile_torch_serving.py``: host wall time, summed device
time, device idle share, device time by kernel class (matmul, the fused
attention forward and backward kernels, other) and the top kernels.
Exits non-zero without a card.
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
    cfg = Config(method="DCHMT", output_dim=64, max_words=32, epochs=100)
    clip_cfg = ClipConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    method = get_method("DCHMT")
    heads, _, aux = method.init(gen, cfg, clip_cfg)
    params = trainable({"clip": init_clip_params(gen, clip_cfg), **heads})
    opt = make_main_optimizer(cfg, params, steps_per_epoch=100)
    state = TrainState(params, None, aux, 0, torch.Generator(device="cuda").manual_seed(1))

    rng = np.random.default_rng(1)
    B, res = args.batch, clip_cfg.image_resolution
    ids = np.zeros((B, 32), np.int32)
    ids[:, 0], ids[:, 1:12] = 49406, rng.integers(1, 49405, (B, 11))
    ids[:, 12] = 49407
    labels = (rng.random((B, 24)) < 0.2).astype(np.float32)
    labels[np.arange(B), rng.integers(0, 24, B)] = 1.0
    batch = {"image": torch.from_numpy(rng.standard_normal((B, res, res, 3), dtype=np.float32)),
             "text": torch.from_numpy(ids), "label": torch.from_numpy(labels)}
    batch = {k: v.cuda() for k, v in batch.items()}

    print(json.dumps({"card": torch.cuda.get_device_name(0), "torch": torch.__version__,
                      "batch": B, "model": "ViT-B/32 DCHMT K=64"}), flush=True)
    for tag, dtype, impl in (("fp32", "float32", "fused"), ("bf16", "bfloat16", "fused"),
                             ("fp32_plain_attention", "float32", "plain")):
        step = make_train_step(method.make_loss_fn(cfg.replace(compute_dtype=dtype), clip_cfg),
                               opt)
        cm.set_attn_impl(impl)
        try:
            profile_step(f"train_step_{tag}", lambda: step(state, batch), top=8)
        finally:
            cm.set_attn_impl("fused")
    return 0


if __name__ == "__main__":
    sys.exit(main())
