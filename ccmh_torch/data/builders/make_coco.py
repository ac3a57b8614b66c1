"""Offline MS-COCO builder: annotations -> index/caption/label.mat.

Host-side tool producing the exact file layout the pipeline ingests
(reference semantics: dataset/make_coco.py:70-163 — merge train2017 +
val2017 captions and instance categories, 80 classes, id-sorted order).

    python -m ccmh_torch.data.builders.make_coco --coco-dir /data/coco2017 \
        --save-dir ./dataset/coco
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import scipy.io as scio


def load_split(coco_dir: str, split: str):
    """-> {image_id: (path, [captions], multi-hot label)} for one split."""
    with open(os.path.join(coco_dir, "annotations", f"captions_{split}.json")) as fh:
        cap_data = json.load(fh)
    with open(os.path.join(coco_dir, "annotations", f"instances_{split}.json")) as fh:
        inst_data = json.load(fh)

    category_index = {c["id"]: i for i, c in enumerate(inst_data["categories"])}
    n_class = len(category_index)

    paths = {}
    img_dir = os.path.join(coco_dir, split)
    for img in cap_data["images"]:
        path = os.path.join(img_dir, img["file_name"])
        if os.path.exists(path):
            paths[img["id"]] = path

    captions: dict = {}
    for ann in cap_data["annotations"]:
        captions.setdefault(ann["image_id"], []).append(ann["caption"])

    labels: dict = {}
    for ann in inst_data["annotations"]:
        lab = labels.setdefault(ann["image_id"], np.zeros(n_class, np.float64))
        lab[category_index[ann["category_id"]]] = 1.0

    # keep only ids with path + captions + at least one category,
    # id-sorted for determinism (make_coco.py:55-67)
    out = {}
    for img_id in sorted(labels):
        if img_id in paths and img_id in captions:
            out[img_id] = (paths[img_id], captions[img_id], labels[img_id])
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--coco-dir", required=True)
    parser.add_argument("--save-dir", default="./dataset/coco")
    args = parser.parse_args(argv)

    items = {}
    for split in ("train2017", "val2017"):
        items.update(load_split(args.coco_dir, split))

    index_list, caption_list, label_list = [], [], []
    for img_id, (path, caps, lab) in items.items():
        index_list.append(path)
        caption_list.append(np.asarray(caps, dtype=object))
        label_list.append(lab)

    os.makedirs(args.save_dir, exist_ok=True)
    scio.savemat(os.path.join(args.save_dir, "index.mat"), {"index": index_list})
    caption_cells = np.empty((1, len(caption_list)), dtype=object)
    for i, caps in enumerate(caption_list):
        # '<U' char matrix per cell (NOT object): loadmat then yields np.str_
        # elements — the layout the reference builder produces and its
        # tokenizer consumes (dataset/base.py:66)
        caption_cells[0, i] = np.asarray([str(c) for c in caps])
    scio.savemat(os.path.join(args.save_dir, "caption.mat"), {"caption": caption_cells})
    scio.savemat(os.path.join(args.save_dir, "label.mat"),
                 {"category": np.stack(label_list)})
    print(f"wrote {len(index_list)} items to {args.save_dir}")


if __name__ == "__main__":
    main()
