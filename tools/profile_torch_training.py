#!/usr/bin/env python3
"""Where the ccmh_torch train step spends its time on one NVIDIA card.

    python3 tools/profile_torch_training.py [--tower vit-b-32|vit-l-14|rn50]
        [--method DSPH] [--batch N] [--dtype bfloat16|float32] [--ln plain|fused]
        [--quick] [--loops 2,8] [--repeats 2] [--device cuda|cpu]
    python3 tools/profile_torch_training.py --variants --method DCHMT --batch 128

The port of ``tools/profile_step.py``'s split.  It builds a seeded random
model of the method (any ported one; default DSPH) on the tower by name
(``ccmh_torch/tools/floors.py`` ``TOWERS``: ViT-B/32, ViT-L/14, OpenAI's
RN50), K=64, BertAdam with the Trainer's param groups and the method's
own optimizer for its ``extra`` parameters, and one random batch of
CLIP-normalized images, 32-token captions and labels (24 classes) on the
card, the towers computing in ``--dtype`` (default bfloat16, as
``profile_step.py``; the heads and losses in fp32).  Default batches:
256 at ViT-B/32 and RN50 (``profile_step.py``'s), 64 at ViT-L/14 (its
bf16 step's activations at 257 tokens).

It times each part of the Trainer's step (``ccmh_torch/train/state.py``
``TrainStep``, through ``ccmh_torch/tools/step_split.py``) as a
chain of calls on the card's stream, its ms the least over ``--repeats``
of (t_large - t_small) / (n_large - n_small) by CUDA events (``--loops``
small,large): the full step; the towers alone (both modalities, grad
enabled, as the step runs them, so that the parts add up); the loss
forward (towers + heads + loss); forward + backward; and the optimizers
alone on fixed gradients, the parameters and optimizer state restored
after.  "heads+loss" is the loss forward less the towers, "backward" the
forward + backward less the loss forward, "unattributed" the full step
less forward + backward and the optimizers.  These are host ms: an eager
step whose host launches outrun the card measures the host's launch rate.
So ``torch.profiler`` also runs over one step, and each part gets the
device ms of the kernels launched inside its ``record_function`` range
("towers", "heads+loss" less the towers, "backward", "optimizer"), and
its idle share, 1 - device / host.

Beside every part stands its floor from ``floors.py``, at the H100's
rates: the towers' forward FLOPs and backward FLOPs counted from the
configuration's shapes, the backward as the function needs it (#2's
recompute of ``q kᵀ`` and remat's forward are reported apart, as
``towers_bwd_executed``, and not in the floor) (GEMMs at the compute type's rate, fp32 with TF32
off at the fp32 FMA rate; the attention kernels' products in fp32 at the
3xTF32 rate), the heads' and the loss's FLOPs read by ``FlopCounterMode``
over the loss less the towers under the plain attention (whose products
it sees; it sees no kernel), at the fp32 rate, and the optimizers' bytes
from their state.  ``floor_share`` is the floor over the host ms; the
tool also checks the towers' count, as the plain attention runs it,
against ``FlopCounterMode``'s.

It prints one JSON line (parts, floors, FLOPs, bytes, device ms by range
and by kernel class, the top kernels, the card's name and power limit);
``--quick`` times the full step only.  ``--device cpu`` runs each part
once at a toy tower of the family (``ClipConfig.tiny()`` or a tiny RN)
and prints the same keys with the times null, for the tests.  Without a
card the default device raises.

``--variants`` profiles one steady step by kernel class in fp32, bf16,
fp32 with the plain attention and fp32 and bf16 with the LayerNorm
kernels (one line each in ``tools/profile_torch_serving.py``'s format):
with ``--method DCHMT --batch 128`` the five-variant table of
PERF.md §5.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_BATCH = {"vit-b-32": 256, "vit-l-14": 64, "rn50": 256}
CPU_BATCH = 4
TEXT_LEN = 32
N_CLASS = 24
K_BITS = 64


def build(method_name: str, clip_cfg, B: int, dtype: str, device):
    """(cfg, method, state, optimizers, batch): a seeded random model of
    the method on ``clip_cfg`` and one random batch, on ``device``."""
    import torch

    from ccmh_torch.clip.model import init_clip_params
    from ccmh_torch.config import Config
    from ccmh_torch.train.methods import get_method
    from ccmh_torch.train.state import TrainState, make_main_optimizer, trainable

    cfg = Config(method=method_name, output_dim=K_BITS, max_words=TEXT_LEN, epochs=100,
                 nclass=N_CLASS, compute_dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(0)
    method = get_method(method_name)
    heads, extra, aux = method.init(gen, cfg, clip_cfg)
    params = trainable({"clip": init_clip_params(gen, clip_cfg), **heads})
    optimizers = [make_main_optimizer(cfg, params, steps_per_epoch=100)]
    if extra is not None and method.extra_optimizer is not None:
        extra_opt = method.extra_optimizer(cfg, extra)
        if extra_opt is not None:
            trainable(extra)
            optimizers.append(extra_opt)
    state = TrainState(params, extra, aux, 0, torch.Generator(device=device).manual_seed(1))

    rng = np.random.default_rng(1)
    res = clip_cfg.image_resolution
    ids = np.zeros((B, TEXT_LEN), np.int64)
    ids[:, 0], ids[:, 1:12] = 49406, rng.integers(1, 49405, (B, 11))
    ids[:, 12] = 49407
    labels = (rng.random((B, N_CLASS)) < 0.2).astype(np.float32)
    labels[np.arange(B), rng.integers(0, N_CLASS, B)] = 1.0
    batch = {"image": torch.from_numpy(rng.standard_normal((B, res, res, 3), dtype=np.float32)),
             "text": torch.from_numpy(ids), "label": torch.from_numpy(labels),
             "index": torch.arange(B), "epoch": torch.tensor(0, dtype=torch.int32)}
    if method.needs_mask:
        batch["key_padding_mask"] = batch["text"] == 0
    return cfg, method, state, optimizers, {k: v.to(device) for k, v in batch.items()}


def _counted(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def count_flops(loss_fn, towers, state, batch, passes) -> dict:
    """FLOPs by ``FlopCounterMode`` under the plain attention: the towers'
    forward and backward (the backward of the sum of their outputs), the
    loss forward and backward; the heads' and loss's as their
    difference.  ``passes`` counts these tower passes."""
    import torch

    from ccmh_torch.clip import model as cm

    def tower_loss(outs):
        return sum(t.float().sum() for out in outs for t in out
                   if t is not None and t.requires_grad)

    cm.set_attn_impl("plain")
    try:
        holder = {}
        towers_fwd = _counted(lambda: holder.update(out=towers()))
        towers_bwd = _counted(tower_loss(holder.pop("out")).backward)
        loss_fwd = _counted(lambda: holder.update(loss=loss_fn(
            state.params, state.extra, state.aux, batch, state.generator)[0]))
        loss_bwd = _counted(holder.pop("loss").backward)
    finally:
        cm.set_attn_impl("fused")
    for leaf in _grad_leaves(state):
        leaf.grad = None
    passes["forward"] += 2
    passes["backward"] += 2
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return {"towers_fwd": towers_fwd, "towers_bwd": towers_bwd,
            "heads_loss_fwd": loss_fwd - towers_fwd, "heads_loss_bwd": loss_bwd - towers_bwd}


def _grad_leaves(state):
    from ccmh_torch.train.optim import tree_leaves_with_path

    trees = [state.params] + ([state.extra] if state.extra is not None else [])
    return [leaf for tree in trees for _, leaf in tree_leaves_with_path(tree)
            if leaf.requires_grad]


def _attention_layers(clip_cfg) -> int:
    return clip_cfg.transformer_layers + (0 if clip_cfg.is_resnet else clip_cfg.vision_layers)


def split_row(args, clip_cfg, device) -> dict:
    """The split of one configuration as one JSON-ready dict."""
    import torch

    from ccmh_torch.clip import model as cm
    from ccmh_torch.tools import floors
    from ccmh_torch.tools import step_split as ss
    from ccmh_torch.tools.bench_vitl import card_line
    from ccmh_torch.train.methods.base import clip_embeds, resolve_remat
    from ccmh_torch.train.state import TrainStep

    on_card = device.type == "cuda"
    B = args.batch or (DEFAULT_BATCH[args.tower] if on_card else CPU_BATCH)
    cfg, method, state, opts, batch = build(args.method, clip_cfg, B, args.dtype, device)
    loss_fn = method.make_loss_fn(cfg, clip_cfg)

    def towers():
        return clip_embeds(state.params, clip_cfg, batch, cfg, features=method.features)

    fused = {"forward": 0, "backward": 0}
    plain = {"forward": 0, "backward": 0}
    cm.set_ln_impl(args.ln)
    try:
        train_step = TrainStep(loss_fn, *opts, grad_clip=method.grad_clip)
        parts = ss.split_parts(train_step, state, batch, towers, fused)
        if on_card:
            host = ss.chained_split(parts, opts, quick=args.quick, loops=args.loops,
                                    repeats=args.repeats)
            prof = None if args.quick else ss.profile_ranges(lambda: parts["full"](1))
        else:
            for name in ("full", "towers", "loss_forward", "forward_backward", "optimizer"):
                parts[name](1)
            host, prof = None, None
        counted = count_flops(loss_fn, towers, state, batch, plain)
    finally:
        cm.set_ln_impl("plain")

    dtype, remat = args.dtype, resolve_remat(cfg)
    key_padding = "key_padding_mask" in batch
    tw_fwd = floors.tower_flops(clip_cfg, B, TEXT_LEN, method.features)
    tw_bwd = floors.tower_backward_flops(clip_cfg, B, TEXT_LEN, method.features)
    tw_bwd_run = floors.tower_backward_executed_flops(
        clip_cfg, B, TEXT_LEN, method.features, attn="fused", remat=remat,
        key_padding=key_padding)
    tw_bwd_plain = floors.tower_backward_executed_flops(
        clip_cfg, B, TEXT_LEN, method.features, attn="plain", remat=remat,
        key_padding=key_padding)
    fp32 = floors.PEAK_OPS_PER_S["float32"]
    opt_bytes = floors.optimizer_bytes(opts)
    floor_ms = {
        "towers": floors.tower_floor_ms(tw_fwd, dtype),
        "heads+loss": 1e3 * counted["heads_loss_fwd"] / fp32,
        "backward": floors.tower_floor_ms(tw_bwd, dtype) + 1e3 * counted["heads_loss_bwd"] / fp32,
        "optimizer": 1e3 * opt_bytes / floors.HBM_BYTES_PER_S,
    }
    floor_ms["full"] = sum(floor_ms.values())

    def part(name):
        h = None if host is None else host.get(name)
        if prof is None:
            d = None
        elif name == "full":
            d = prof["device_ms"]
        elif name == "unattributed":
            d = prof["device_ms_outside_ranges"]
        else:
            d = prof["device_ms_by_range"][name]
        f = floor_ms.get(name)
        return {"host_ms": h, "device_ms": d,
                "idle_share": None if h is None or d is None else max(0.0, 1.0 - d / h),
                "floor_ms": f, "floor_share": None if h is None or f is None else f / h}

    names = ("full",) if args.quick else ("full", "towers", "heads+loss", "backward",
                                          "optimizer", "unattributed")
    fwd_flops = tw_fwd["total"] + counted["heads_loss_fwd"]
    fb_flops = fwd_flops + tw_bwd["total"] + counted["heads_loss_bwd"]
    fwd_floor = floor_ms["towers"] + floor_ms["heads+loss"]

    def share(floor, key):
        return None if host is None or key not in host else floor / host[key]

    row = {
        "tool": "profile_torch_training", "tower": args.tower,
        "config": "tiny" if not on_card else args.tower, "method": args.method,
        "batch": B, "dtype": dtype, "ln": args.ln, "quick": args.quick,
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "card": card_line() if on_card else None,
        "n_params": sum(p.numel() for g in opts[0].param_groups for p in g["params"]),
        "parts": {name: part(name) for name in names},
        "floors": {
            "forward": {"flops": fwd_flops, "ms": fwd_floor,
                        "share": share(fwd_floor, "loss_forward")},
            "forward_backward": {"flops": fb_flops,
                                 "ms": fwd_floor + floor_ms["backward"],
                                 "share": share(fwd_floor + floor_ms["backward"],
                                                "forward_backward")},
            "optimizer": {"bytes": opt_bytes, "ms": floor_ms["optimizer"],
                          "share": share(floor_ms["optimizer"], "optimizer")}},
        "flops": {"towers_fwd": tw_fwd, "towers_bwd": tw_bwd, "towers_bwd_executed": tw_bwd_run,
                  "heads_loss_fwd": counted["heads_loss_fwd"],
                  "heads_loss_bwd": counted["heads_loss_bwd"],
                  "heads_loss_from": "FlopCounterMode: the loss less the towers, plain attention",
                  "towers_counted": {"fwd": counted["towers_fwd"], "bwd": counted["towers_bwd"]},
                  "towers_count_exact": (counted["towers_fwd"] == tw_fwd["total"]
                                         and counted["towers_bwd"] == tw_bwd_plain["total"])},
        "host_ms": host,
        "passes": {"fused_attention": fused, "plain_attention": plain},
        "attention_layers": _attention_layers(clip_cfg),
    }
    if prof is not None:
        row.update({k: prof[k] for k in ("wall_ms", "device_idle_share", "device_ms_by_range",
                                         "device_ms_linked_outside_ranges",
                                         "device_ms_by_class", "top_kernels_ms")})
    print(json.dumps(row), flush=True)
    return row


def variants(args, clip_cfg) -> list:
    """One steady step of each of the five variants by kernel class."""
    import torch

    from ccmh_torch.clip import model as cm
    from ccmh_torch.train.state import TrainStep
    from tools.profile_torch_serving import profile_step

    B = args.batch or 128
    rows = []
    print(json.dumps({"card": torch.cuda.get_device_name(0), "torch": torch.__version__,
                      "batch": B, "model": f"{args.tower} {args.method} K={K_BITS}"}), flush=True)
    for tag, dtype, attn, ln in (("fp32", "float32", "fused", "plain"),
                                 ("bf16", "bfloat16", "fused", "plain"),
                                 ("fp32_plain_attention", "float32", "plain", "plain"),
                                 ("fp32_ln_fused", "float32", "fused", "fused"),
                                 ("bf16_ln_fused", "bfloat16", "fused", "fused")):
        cfg, method, state, opts, batch = build(args.method, clip_cfg, B, dtype, "cuda")
        loss_fn = method.make_loss_fn(cfg, clip_cfg)
        cm.set_attn_impl(attn)
        cm.set_ln_impl(ln)
        try:
            train_step = TrainStep(loss_fn, *opts, grad_clip=method.grad_clip)
            rows.append(profile_step(f"train_step_{tag}", lambda: train_step(state, batch),
                                     top=8))
        finally:
            cm.set_attn_impl("fused")
            cm.set_ln_impl("plain")
        del state, opts, batch
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> list:
    from ccmh_torch.device import resolve_device
    from ccmh_torch.tools import floors

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tower", default="vit-b-32", choices=sorted(floors.TOWERS))
    ap.add_argument("--method", default="DSPH")
    ap.add_argument("--batch", type=int, default=0,
                    help="default: 256 (ViT-B/32, RN50), 64 (ViT-L/14); 4 on the CPU")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--ln", default="plain", choices=("plain", "fused"))
    ap.add_argument("--quick", action="store_true", help="time the full step only")
    ap.add_argument("--loops", default="2,8", help="small,large chained calls")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--variants", action="store_true",
                    help="profile the five variants by kernel class instead")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    args.loops = tuple(int(n) for n in args.loops.split(","))
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    clip_cfg = floors.tower_config(args.tower, tiny=not on_card)
    if on_card:
        from ccmh_torch.ops.build import build_all

        build_all(["attention", "attention_bwd", "layernorm"])
    if args.variants:
        if not on_card:
            raise ValueError("--variants profiles on the card")
        return variants(args, clip_cfg)
    return [split_row(args, clip_cfg, device)]


if __name__ == "__main__":
    main()
