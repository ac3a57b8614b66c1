"""Offline MIRFLICKR-25K builder.

Reference semantics (dataset/make_mirflickr25k.py): the 24 non-"_r1"
annotation files define the classes; tag files become single captions;
items sorted by string id.

    python -m ccmh_torch.data.builders.make_mirflickr25k \
        --annotations-dir .../mirflickr25k_annotations_v080 \
        --image-dir .../mirflickr --save-dir ./dataset/mirflickr
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import scipy.io as scio


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--annotations-dir", required=True)
    parser.add_argument("--image-dir", required=True)
    parser.add_argument("--save-dir", default="./dataset/mirflickr")
    args = parser.parse_args(argv)

    ann_files = [f for f in os.listdir(args.annotations_dir)
                 if "_r1" not in f and "README" not in f]
    class_index = {name: i for i, name in enumerate(ann_files)}

    label_dict: dict = {}
    for name in ann_files:
        with open(os.path.join(args.annotations_dir, name)) as fh:
            for line in fh:
                item = line.strip()
                if not item:
                    continue
                lab = label_dict.setdefault(item, np.zeros(len(ann_files)))
                lab[class_index[name]] = 1

    keys = sorted(label_dict)
    labels = [label_dict[k] for k in keys]
    index = [os.path.join(args.image_dir, f"im{k}.jpg") for k in keys]

    tags_dir = os.path.join(args.image_dir, "meta", "tags")
    caption_dict = {}
    for fname in os.listdir(tags_dir):
        item_id = fname.split(".")[0].replace("tags", "")
        with open(os.path.join(tags_dir, fname)) as fh:
            caption_dict[item_id] = " ".join(w.strip() for w in fh).strip()
    captions = [[caption_dict.get(k, "")] for k in keys]

    os.makedirs(args.save_dir, exist_ok=True)
    scio.savemat(os.path.join(args.save_dir, "index.mat"), {"index": index})
    caption_cells = np.empty((1, len(captions)), dtype=object)
    for i, caps in enumerate(captions):
        # '<U' char matrix per cell, the reference tokenizer-consumable layout
        caption_cells[0, i] = np.asarray([str(c) for c in caps])
    scio.savemat(os.path.join(args.save_dir, "caption.mat"), {"caption": caption_cells})
    scio.savemat(os.path.join(args.save_dir, "label.mat"),
                 {"category": np.stack(labels)})
    print(f"wrote {len(index)} items to {args.save_dir}")


if __name__ == "__main__":
    main()
