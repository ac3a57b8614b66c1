"""The port's offline builders and retrieval demo against ccmh's.

On the same synthetic raw trees (the layouts of tests/test_builders.py:
COCO's annotation JSONs, NUS-WIDE's text tree, MIRFLICKR's annotation and
tag files), ``ccmh_torch.data.builders.*`` write ``.mat`` variables (and
NUS-WIDE's ``caption.txt``) equal to ``ccmh``'s, bit for bit, which the
port's split and dataset then read.  ``twdh_centers.generate_assets``
returns arrays equal to ``ccmh``'s for several class counts, lengths and
seeds, and the port's TwDH trains one epoch on centres the port's CLI
generated.  ``python -m ccmh_torch.retrieval`` prints the top-k lines of
``ccmh``'s demo on the same code dump.  Everything is exact.
"""

import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import scipy.io as scio

from ccmh.data.builders import make_coco as j_coco
from ccmh.data.builders import make_mirflickr25k as j_mir
from ccmh.data.builders import make_nuswide as j_nus
from ccmh.data.builders import twdh_centers as j_twdh
from ccmh_torch.data.builders import make_coco, make_mirflickr25k, make_nuswide, twdh_centers


def _jpg(path, rng, size=24):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rng.randint(0, 256, size=(size, size, 3), dtype=np.uint8)).save(
        path, quality=90)


def _coco_tree(root, rng):
    """train2017 + val2017 caption and instance JSONs over non-contiguous
    category ids, two captions an image -> (argv, item count)."""
    cat_ids = [7, 11, 23, 42, 99]
    n = 0
    for split, n0, count in (("train2017", 0, 10), ("val2017", 100, 6)):
        images, caps, insts = [], [], []
        for i in range(n0, n0 + count):
            fname = f"{i:012d}.jpg"
            _jpg(os.path.join(root, split, fname), rng)
            images.append({"id": i, "file_name": fname})
            caps += [{"image_id": i, "caption": f"a photo number {i} take {j}"} for j in range(2)]
            for c in rng.choice(cat_ids, size=rng.randint(1, 3), replace=False):
                insts.append({"image_id": i, "category_id": int(c)})
            n += 1
        os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
        with open(os.path.join(root, "annotations", f"captions_{split}.json"), "w") as fh:
            json.dump({"images": images, "annotations": caps}, fh)
        with open(os.path.join(root, "annotations", f"instances_{split}.json"), "w") as fh:
            json.dump({"categories": [{"id": c} for c in cat_ids], "annotations": insts}, fh)
    return ["--coco-dir", root], n


def _nuswide_tree(root, rng):
    """ImageList (backslash paths), All_Tags with empty rows, used_label
    columns and 2-based not_used_id lines -> (argv, item count)."""
    imgdir, n = os.path.join(root, "Flickr"), 14
    used = ["Labels_sky.txt", "Labels_water.txt", "Labels_person.txt"]
    for sub in ("ImageList", "NUS_WID_Tags", os.path.join("Groundtruth", "AllLabels")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    with open(os.path.join(root, "ImageList", "Imagelist.txt"), "w") as fh:
        for i in range(n):
            fh.write(f"photos\\{i:04d}.jpg\n")
            _jpg(os.path.join(imgdir, "photos", f"{i:04d}.jpg"), rng)
    with open(os.path.join(root, "NUS_WID_Tags", "All_Tags.txt"), "w") as fh:
        fh.writelines(f"{i} {'sky water' if i % 3 else ''}\n" for i in range(n))
    with open(os.path.join(root, "Groundtruth", "used_label.txt"), "w") as fh:
        fh.write("\n".join(used) + "\n")
    cols = rng.randint(0, 2, size=(n, len(used)))
    cols[:, 0] |= cols.sum(1) == 0
    for c, name in enumerate(used):
        with open(os.path.join(root, "Groundtruth", "AllLabels", name), "w") as fh:
            fh.writelines(f"{v}\n" for v in cols[:, c])
    with open(os.path.join(root, "Groundtruth", "not_used_id.txt"), "w") as fh:
        fh.writelines(f"{i + 2}\n" for i in (4, 9))
    return ["--nuswide-dir", root, "--image-dir", imgdir], n - 2


def _mirflickr_tree(root, rng):
    """Class files (``_r1`` and README ignored) and meta/tags captions ->
    (argv, item count)."""
    ann, imgdir, n = os.path.join(root, "ann"), os.path.join(root, "mirflickr"), 12
    classes = ["animals.txt", "sky.txt", "people.txt"]
    os.makedirs(ann, exist_ok=True)
    members = {c: sorted(rng.choice(n, size=6, replace=False) + 1) for c in classes}
    for c in classes:
        with open(os.path.join(ann, c), "w") as fh:
            fh.writelines(f"{i}\n" for i in members[c])
        with open(os.path.join(ann, c.replace(".txt", "_r1.txt")), "w") as fh:
            fh.write("999\n")
    with open(os.path.join(ann, "README.txt"), "w") as fh:
        fh.write("not a class\n")
    labeled = sorted({i for mem in members.values() for i in mem})
    os.makedirs(os.path.join(imgdir, "meta", "tags"), exist_ok=True)
    for i in labeled:
        _jpg(os.path.join(imgdir, f"im{i}.jpg"), rng)
        with open(os.path.join(imgdir, "meta", "tags", f"tags{i}.txt"), "w") as fh:
            fh.write("cat\ndog\nsky\n")
    return ["--annotations-dir", ann, "--image-dir", imgdir], len(labeled)


BUILDERS = {"coco": (_coco_tree, j_coco, make_coco),
            "nuswide": (_nuswide_tree, j_nus, make_nuswide),
            "mirflickr": (_mirflickr_tree, j_mir, make_mirflickr25k)}


def _assert_mat_equal(got_path, want_path):
    got, want = scio.loadmat(got_path), scio.loadmat(want_path)
    names = sorted(k for k in want if not k.startswith("__"))
    assert names and sorted(k for k in got if not k.startswith("__")) == names
    for name in names:
        g, w = got[name], want[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if w.dtype == object:
            for a, b in zip(g.ravel(), w.ravel()):
                assert a.dtype == b.dtype and np.array_equal(a, b), name
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_writes_ccmhs_files(name, tmp_path):
    from ccmh_torch.data.dataset import BatchIterator, CrossModalDataset
    from ccmh_torch.data.split import make_splits

    tree, j_mod, t_mod = BUILDERS[name]
    argv, n = tree(str(tmp_path / "raw"), np.random.RandomState(0))
    want, got = str(tmp_path / "ccmh"), str(tmp_path / "port")
    with redirect_stdout(io.StringIO()):
        j_mod.main(argv + ["--save-dir", want])
        t_mod.main(argv + ["--save-dir", got])
    files = sorted(os.listdir(want))
    assert files == sorted(os.listdir(got))
    for f in files:
        if f.endswith(".mat"):
            _assert_mat_equal(os.path.join(got, f), os.path.join(want, f))
        else:
            with open(os.path.join(got, f), "rb") as a, open(os.path.join(want, f), "rb") as b:
                assert a.read() == b.read(), f

    # the port's split and dataset read what its builder wrote
    caption = "caption.txt" if name == "nuswide" else "caption.mat"
    splits = make_splits(os.path.join(got, caption), os.path.join(got, "index.mat"),
                         os.path.join(got, "label.mat"), query_num=4, train_num=6, seed=1814)
    assert len(splits.query.labels) == 4 and len(splits.retrieval.labels) == n - 4
    ds = CrossModalDataset(splits.query, is_train=False, max_words=32, resolution=24)
    batch = next(iter(BatchIterator(ds, 4, shuffle=False, num_workers=1)))
    assert batch["image"].shape == (4, 24, 24, 3) and (batch["text"][:, 0] == 49406).all()


@pytest.mark.parametrize("n_class, long_dims, short_dims, seed", [
    (8, [16], [8], 0),            # independent shorts reachable
    (24, [64, 128], [16, 32], 3),  # MIRFLICKR's class count, two long lengths
    (40, [16], [8, 12], 1),       # C > 2K: shorts regenerated as projections
    (21, [32], [16], 7),          # NUS-WIDE's class count
])
def test_twdh_assets_equal_ccmhs(n_class, long_dims, short_dims, seed):
    want = j_twdh.generate_assets(n_class, long_dims, short_dims, seed=seed)
    got = twdh_centers.generate_assets(n_class, long_dims, short_dims, seed=seed)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_port_twdh_trains_on_centres_its_cli_generated(tmp_path):
    """``python -m ccmh_torch.data.builders.twdh_centers`` writes centres
    the port's TwDH reads through ``--set twdh.center_path`` and trains an
    epoch on, with a validation at each code length."""
    from ccmh_torch.cli import main as torch_main
    from ccmh_torch.data.synthetic import write_synthetic_mat_dataset
    from ccmh_torch.losses.twdh import load_twdh_assets

    out = str(tmp_path / "centres.npz")
    with redirect_stdout(io.StringIO()) as printed:
        assert twdh_centers.main(["--nclass", "5", "--long-dims", "16", "--short-dims", "8",
                                  "--seed", "0", "--out", out]) == 0
    assert "wrote" in printed.getvalue()
    assets = load_twdh_assets("anydataset", 16, out)
    assert assets["long_center"].shape == (5, 16) and assets["trans"][8].shape == (32, 16)
    data = write_synthetic_mat_dataset(str(tmp_path / "data"), n=24, n_class=5, resolution=32,
                                       seed=3)
    trainer = torch_main(["--method", "TwDH", "--dataset", "synthetic", "--output-dim", "16",
                          "--data-dir", data, "--save-dir", str(tmp_path / "out"),
                          "--epochs", "1", "--batch-size", "6", "--query-num", "6",
                          "--train-num", "12", "--eval-batch", "6", "--clip-arch", "tiny",
                          "--num-workers", "1", "--device", "cpu",
                          "--set", f"twdh.center_path={out}"])
    with open(os.path.join(trainer.cfg.save_dir, "metrics.jsonl")) as fh:
        rows = [json.loads(r) for r in fh]
    assert {"valid", "valid_long", "valid_short8"} <= {r["event"] for r in rows}
    assert all(np.isfinite(r["loss"]) for r in rows if r["event"] == "train")


@pytest.mark.parametrize("direction", ["t2i", "i2t"])
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "packed"])
def test_demo_prints_ccmhs_top_k(direction, packed, tmp_path):
    from ccmh.retrieval import _demo as j_demo
    from ccmh_torch.retrieval import _demo

    rng = np.random.RandomState(9)

    def codes(n):
        return np.where(rng.rand(n, 32) < 0.5, -1, 1).astype(np.int8)

    def labels(n):
        return (rng.rand(n, 6) < 0.3).astype(np.float32)

    mat = str(tmp_path / "32-ours-synthetic-i2t.mat")
    scio.savemat(mat, {"q_img": codes(12), "q_txt": codes(12), "r_img": codes(40),
                       "r_txt": codes(40), "q_l": labels(12), "r_l": labels(40)})
    argv = [mat, "--topk", "7", "--direction", direction, "--queries", "6"]
    argv += ["--packed"] if packed else []
    with redirect_stdout(io.StringIO()) as want:
        assert j_demo(argv) == 0
    with redirect_stdout(io.StringIO()) as got:
        assert _demo(argv + ["--device", "cpu"]) == 0
    assert got.getvalue() == want.getvalue()
    assert got.getvalue().count("query ") == 6 and "precision@7 over 12 queries" in got.getvalue()
