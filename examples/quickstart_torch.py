"""End-to-end ccmh_torch quickstart on synthetic data: no downloads, no datasets.

The PyTorch port's copy of ``examples/quickstart.py``; it walks the same
four stages through ``ccmh_torch`` alone:

1. writes a synthetic JPEG dataset in the reference's ``.mat`` layout
   (``images/*.jpg``, ``index.mat``, ``caption.mat``, ``label.mat``);
2. trains a method for a few epochs through the CLI
   (``ccmh_torch.cli.main``) with full-state checkpoints and ``.npz``
   saves (TwDH with class centres generated for this dataset);
3. re-runs it with ``--test``: the four mAPs and the PR / top-N curve
   dump under ``PR_cruve``;
4. loads the saved ``.npz`` into a ``Retriever`` and serves a text→image
   top-5 search over a gallery of the dataset's JPEGs, decoded by the
   port's native loader (nvJPEG on a machine without libjpeg).

Run::

    python examples/quickstart_torch.py                  # on the card
    python examples/quickstart_torch.py --device cpu     # ~1 min on a CPU
    python examples/quickstart_torch.py --method DSPH --epochs 4 --bits 32
"""

import argparse
import os
import sys
import tempfile

try:
    import ccmh_torch  # noqa: F401  (installed)
except ImportError:  # running from a checkout: the repo root is one level up
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GALLERY = 24
QUERIES = ["a photo of a dog", "two people at the beach"]


def main(argv=None) -> dict:
    """Run the four stages; returns the run's directory, the checkpoint,
    the gallery size and the search's distances and ids."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--method", default="DCHMT", help="any of the 14 registered methods")
    ap.add_argument("--bits", type=int, default=16, help="hash code length")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--workdir", default="",
                    help="where to put data + results (default: a tmp dir)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    work = args.workdir or tempfile.mkdtemp(prefix="ccmh_torch_quickstart_")
    data_dir = os.path.join(work, "data")
    save_dir = os.path.join(work, "result")

    # 1. synthetic dataset in the reference .mat layout ----------------------
    from ccmh_torch.data.synthetic import write_synthetic_mat_dataset

    if not os.path.isdir(data_dir):
        # jpeg=True: real .jpg files + an index.mat of their paths, read by
        # the native batch loader
        write_synthetic_mat_dataset(data_dir, n=48, n_class=6, resolution=32, jpeg=True)
    print(f"[1/4] dataset at {data_dir}")

    # 2. train through the CLI ------------------------------------------------
    from ccmh_torch.cli import main as cli_main

    common = [
        "--method", args.method, "--dataset", "synthetic", "--output-dim", str(args.bits),
        "--data-dir", data_dir, "--save-dir", save_dir,
        "--batch-size", "12", "--query-num", "12", "--train-num", "24",
        "--eval-batch", "12", "--clip-arch", "tiny", "--device", args.device,
    ]
    centers = ""
    if args.method == "TwDH":
        # TwDH reads class-centre assets; generate them for this dataset
        from ccmh_torch.data.builders.twdh_centers import main as gen_centers

        centers = os.path.join(work, "twdh_centers.npz")
        gen_centers(["--nclass", "6", "--long-dims", str(args.bits),
                     "--short-dims", str(max(args.bits // 2, 4)), "--out", centers])
        common += ["--set", f"twdh.center_path={centers}"]
    cli_main(common + ["--epochs", str(args.epochs), "--checkpoint-every", "1",
                       "--save-model"])
    run_dir = os.path.join(save_dir, args.method, "synthetic", str(args.bits))
    print(f"[2/4] trained; artifacts in {run_dir}")

    # 3. --test: the four mAPs and the PR / top-N curves ------------------------
    ckpt = os.path.join(run_dir, f"model-{args.epochs - 1}.npz")
    cli_main(common + ["--test", "--pretrained", ckpt])
    print(f"[3/4] test eval done (PR curves under {run_dir}/PR_cruve)")

    # 4. serve: checkpoint -> Retriever -> text->image top-k -----------------
    import numpy as np

    from ccmh_torch.clip.model import ClipConfig
    from ccmh_torch.config import Config
    from ccmh_torch.retrieval import Retriever

    cfg = Config(method=args.method, output_dim=args.bits, nclass=6, pretrained=ckpt,
                 max_words=32)
    if centers:
        cfg.twdh.center_path = centers
    r = Retriever.from_pretrained(cfg, clip_cfg=ClipConfig.tiny(), device=args.device)

    index = r.build_image_index(images=load_gallery_images(data_dir, n=GALLERY))
    dists, ids = r.search_text2image(QUERIES, index, k=5)
    dists, ids = np.asarray(dists), np.asarray(ids)
    for q, (d_row, i_row) in enumerate(zip(dists, ids)):
        print(f"[4/4] query {q}: top-5 gallery ids {i_row.tolist()} "
              f"at Hamming distances {d_row.tolist()}")
    print(f"done: everything under {work}")
    return {"run_dir": run_dir, "checkpoint": ckpt, "gallery": GALLERY,
            "distances": dists, "ids": ids}


def load_gallery_images(data_dir: str, n: int):
    """The first ``n`` dataset JPEGs, decoded by the serving path's native
    loader (CLIP-normalized [n, 32, 32, 3] float32)."""
    import scipy.io as scio

    from ccmh_torch.data.dataset import images_from_bytes

    index = scio.loadmat(os.path.join(data_dir, "index.mat"))["index"]
    blobs = []
    for p in index[:n]:
        with open(str(p).strip(), "rb") as fh:
            blobs.append(fh.read())
    return images_from_bytes(blobs, resolution=32)


if __name__ == "__main__":
    main()
