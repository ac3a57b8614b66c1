#!/usr/bin/env python3
"""Time ViT-L/14 DSPH train steps on one CUDA card for the ``ccmh_torch``
of a checkout.

    python3 tools/time_torch_vitl_steps.py [--root DIR] [--steps 10] [--batch 32]

Trains ``ClipConfig.vit_l14()`` from a seeded OpenAI-layout ``.pt`` (read
through ``--clip-path``) with DSPH K=64 on a synthetic 224x224 dataset
(``chip_smoke.py``'s phase 5 data: 1,024 items, seed 5, written once under
this checkout's ``build/vitl_steps_data``), one epoch of ``--steps`` steps
at ``--batch``, in fp32 and then with bf16 towers (``--compute-dtype
bfloat16``), through ``ccmh_torch.cli.main`` as ``chip_smoke.py``'s phase
14 does.  Prints the card's name and power limit, then one JSON line a
run: each step's host ms (the step synchronised before and after, which
the bf16 steps, host-bound, feel most) and their median from the second
step on.  ``--root`` (default: this checkout) is the directory holding
the ``ccmh_torch`` and ``chip_smoke.py`` to time, so two versions compare
in one call: unpack the other under ``build/`` and run old, new, new, old.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO, help="the checkout whose ccmh_torch to time")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("time_torch_vitl_steps: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as c
    from ccmh_torch.clip.model import ClipConfig
    from ccmh_torch.data.synthetic import write_synthetic_mat_dataset

    print(c.card_line(), flush=True)
    data = os.path.join(REPO, "build", "vitl_steps_data")
    if not os.path.exists(data):
        write_synthetic_mat_dataset(data, n=1024, n_class=24, resolution=224, seed=5)
    work = os.path.join(root, "build", "vitl_steps")
    os.makedirs(work, exist_ok=True)
    tower = os.path.join(work, "vitl14.pt")
    if not os.path.exists(tower):
        c._long_tower_pt(tower, ClipConfig.vit_l14(), seed=14)
    for name, extra in (("fp32", []), ("bf16", ["--compute-dtype", "bfloat16"])):
        steps = []
        c._timed_run(["--method", "DSPH", "--dataset", "synthetic", "--output-dim", "64",
                      "--data-dir", data, "--epochs", "1", "--query-num", str(c.TRAIN_QUERY),
                      "--batch-size", str(args.batch), "--train-num", str(args.steps * args.batch),
                      "--eval-batch", "128", "--display-step", "1", "--no-valid",
                      "--num-workers", "4", "--device", "cuda", "--clip-path", tower,
                      "--save-dir", os.path.join(work, name)] + extra, steps)
        print(json.dumps({"root": root, "run": name, "batch": args.batch, "step_ms": steps,
                          "median_from_step_2": statistics.median(steps[1:])}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
