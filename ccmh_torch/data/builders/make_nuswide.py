"""Offline NUS-WIDE builder (21-class subset).

Reference semantics (dataset/make_nuswide.py): image list + All_Tags
captions + Groundtruth/AllLabels per used_label.txt classes; rows listed in
not_used_id.txt removed (ids are 2-based line numbers); captions exported
as caption.txt (one line per item).

    python -m ccmh_torch.data.builders.make_nuswide --nuswide-dir /data/NUS-WIDE \
        --image-dir /data/nuswide/Flickr --save-dir ./dataset/nuswide
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import scipy.io as scio


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--nuswide-dir", required=True)
    parser.add_argument("--image-dir", required=True)
    parser.add_argument("--save-dir", default="./dataset/nuswide")
    args = parser.parse_args(argv)

    root = args.nuswide_dir
    with open(os.path.join(root, "ImageList", "Imagelist.txt")) as fh:
        indexes = [os.path.join(args.image_dir, line.strip().replace("\\", "/"))
                   for line in fh]

    captions = []
    with open(os.path.join(root, "NUS_WID_Tags", "All_Tags.txt"), encoding="utf-8") as fh:
        for line in fh:
            if not line.strip():
                continue
            caption = " ".join(line.split()[1:]).strip()
            captions.append(caption or "123456")

    with open(os.path.join(root, "Groundtruth", "used_label.txt"), encoding="utf-8") as fh:
        used = [line.strip() for line in fh if line.strip()]

    labels = np.zeros((len(indexes), len(used)), np.int8)
    for col, name in enumerate(used):
        with open(os.path.join(root, "Groundtruth", "AllLabels", name)) as fh:
            for row, val in enumerate(fh):
                labels[row, col] = 1 if val.strip() == "1" else 0

    with open(os.path.join(root, "Groundtruth", "not_used_id.txt"), encoding="utf-8") as fh:
        drop = {int(line.strip()) - 2 for line in fh if line.strip()}

    keep = [i for i in range(len(indexes)) if i not in drop]
    indexes = [indexes[i] for i in keep]
    captions = [captions[i] for i in keep]
    labels = labels[np.asarray(keep)]

    os.makedirs(args.save_dir, exist_ok=True)
    scio.savemat(os.path.join(args.save_dir, "index.mat"), {"index": indexes})
    scio.savemat(os.path.join(args.save_dir, "label.mat"), {"category": labels})
    with open(os.path.join(args.save_dir, "caption.txt"), "w", encoding="utf-8") as fh:
        fh.writelines(c + "\n" for c in captions)
    print(f"wrote {len(indexes)} items to {args.save_dir}")


if __name__ == "__main__":
    main()
