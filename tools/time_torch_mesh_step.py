"""Time the tensor-parallel train step of ccmh_torch with and without the
data axis's collectives at one data rank, in turns, on one card.

Two gloo ranks share cuda:0 (NCCL refuses two ranks on one device) and
form a (1, 2) mesh: ViT-B/32 at full width, K = 64, DSPH, LayerNorm kernels
on, a seeded global batch of 128.  Two variants of the same step on the
same state, in the order identity, skip, skip, identity for each round:

* ``skip``: the port as it is; with one data rank the tower-output gather
  and the flat CLIP gradient SUM (``parallel/mesh.py`` ``gather_outputs``,
  ``sync_gradients``) move nothing;
* ``identity``: both run over the one-rank data group anyway (a gloo
  gather of CUDA tensors is a SUM of a zero-filled buffer, and the flat
  SUM goes through the host).

Each block times ``--steps`` steps after one warm step, each step between
two ``torch.cuda.synchronize()``; host ms a step.  Two ranks sharing one
card measure no scaling across cards.

    python tools/time_torch_mesh_step.py [--rounds 3] [--steps 4]

Prints the card's name and power limit, one JSON line per rank, and a last
JSON line with the least mean of each variant over the rounds and ranks.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BATCH = 128
K_BITS = 64


def _always_gather(out):
    """``gather_outputs`` without the one-data-rank shortcut."""
    from ccmh_torch.parallel.mesh import active_mesh, gather_rows

    mesh = active_mesh()
    if mesh is None:
        return out
    return type(out)(*[None if t is None else gather_rows(t, mesh) for t in out])


def _always_sum(params):
    """``sync_gradients`` without the one-data-rank shortcut."""
    import torch

    from ccmh_torch.parallel.mesh import active_mesh, all_reduce_flat
    from ccmh_torch.train.optim import tree_leaves_with_path

    mesh = active_mesh()
    if mesh is None:
        return
    with torch.no_grad():
        all_reduce_flat([leaf.grad for _, leaf in tree_leaves_with_path(params["clip"])
                         if leaf.grad is not None], mesh.data_group)


@contextlib.contextmanager
def _variant(name):
    from ccmh_torch.train import state as state_mod
    from ccmh_torch.train.methods import base

    saved = base.gather_outputs, state_mod.sync_gradients
    if name == "identity":
        base.gather_outputs, state_mod.sync_gradients = _always_gather, _always_sum
    try:
        yield
    finally:
        base.gather_outputs, state_mod.sync_gradients = saved


def _setup(mesh):
    """A seeded DSPH state sharded over the model axis, its step and batch."""
    import torch

    from ccmh_torch.clip.model import ClipConfig, init_clip_params
    from ccmh_torch.config import Config
    from ccmh_torch.parallel import tp
    from ccmh_torch.parallel.mesh import data_parallel_train_step
    from ccmh_torch.tokenizer import tokenize_batch
    from ccmh_torch.train.methods import get_method
    from ccmh_torch.train.state import (
        TrainState, make_main_optimizer, make_train_step, trainable,
    )

    cfg = Config(method="DSPH", output_dim=K_BITS, nclass=24, batch_size=BATCH,
                 train_num=4 * BATCH, epochs=2)
    method = get_method("DSPH")
    gen = torch.Generator(device="cuda").manual_seed(62)
    heads, extra, aux = method.init(gen, cfg, ClipConfig())
    clip = tp.shard_clip(init_clip_params(gen, ClipConfig()), ClipConfig(), mesh)
    params = trainable({"clip": clip, **heads})
    opt = make_main_optimizer(cfg, params, 4)
    extra_opt = None
    if extra is not None and method.extra_optimizer:
        extra_opt = method.extra_optimizer(cfg, extra)
        trainable(extra)
    step = make_train_step(method.make_loss_fn(cfg, ClipConfig()), opt, extra_opt,
                           grad_clip=method.grad_clip)
    state = TrainState(params, extra, aux, 0, torch.Generator(device="cuda").manual_seed(3))

    rng = np.random.default_rng(61)
    labels = (rng.random((BATCH, 24)) < 0.15).astype(np.float32)
    labels[np.arange(BATCH), rng.integers(0, 24, BATCH)] = 1.0
    images = rng.standard_normal((BATCH, 224, 224, 3), dtype=np.float32)
    words = ["a", "photo", "of", "the", "red", "dog", "on", "grass", "near", "sea"]
    texts = [" ".join(rng.choice(words, 8)) for _ in range(BATCH)]
    batch = {"image": torch.from_numpy(images).cuda(),
             "text": torch.from_numpy(tokenize_batch(texts, 32)).cuda(),
             "label": torch.from_numpy(labels).cuda(),
             "index": torch.arange(BATCH, dtype=torch.int32, device="cuda"),
             "epoch": torch.tensor(0, dtype=torch.int32, device="cuda")}
    return data_parallel_train_step(step, mesh), state, batch


def _rank(rank, world, init_method, out_path, rounds, steps):
    import torch

    from ccmh_torch.clip import model as cm
    from ccmh_torch.parallel.mesh import build_mesh, init_process

    init_process(rank, world, init_method, "cuda:0", backend="gloo")
    cm.set_ln_impl("fused")
    mesh = build_mesh(1, world, "cuda:0")
    step, state, batch = _setup(mesh)
    runs = {"identity": [], "skip": []}
    for _ in range(rounds):
        for name in ("identity", "skip", "skip", "identity"):
            with _variant(name):
                t = 0.0
                for i in range(1 + steps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, _ = step(state, batch)
                    torch.cuda.synchronize()
                    if i:
                        t += time.perf_counter() - t0
            runs[name].append(1e3 * t / steps)
    with open(f"{out_path}.rank{rank}", "w") as fh:
        json.dump({"rank": rank, "runs_ms": runs}, fh)
    torch.distributed.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)

    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from ccmh_torch.ops import build

    build.build_all()       # once, before the ranks start
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0])
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result")
        mp.spawn(_rank, args=(2, f"file://{tmp}/store", out, args.rounds, args.steps),
                 nprocs=2, join=True)
        results = []
        for rank in (0, 1):
            with open(f"{out}.rank{rank}") as fh:
                results.append(json.load(fh))
    for r in results:
        print(json.dumps(r))
    best = {name: min(min(r["runs_ms"][name]) for r in results) for name in ("identity", "skip")}
    print(json.dumps({"mesh": [1, 2], "method": "DSPH", "batch": BATCH, "step_ms_least": best,
                      "identity_minus_skip_ms": best["identity"] - best["skip"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
