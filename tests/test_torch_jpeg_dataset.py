"""JPEG datasets in the port against ``ccmh``: the synthetic writer
(``write_synthetic_mat_dataset(jpeg=True)``), the batches of
``BatchIterator`` over JPEG paths and over npy arrays of another size,
and the committed JPEG fixtures (``ccmh_torch/assets/jpeg/``) with their
``expected.npz``, ``ccmh``'s PIL outputs that ``chip_smoke.py`` holds the
card's decoder to.

Tolerances: the writer's files, ``index.mat``, ``caption.mat`` and
``label.mat`` equal ``ccmh``'s (the port's libjpeg encoder takes PIL's
settings, so the JPEG files are byte for byte PIL's); batches equal
``ccmh``'s with its native loader bit for bit (the port's streamed JPEG
batches are the loader's uint8, ``ccmh``'s its float32: the test
normalizes the port's uint8 by ``ccmh``'s loader arithmetic and holds
them equal); the resize of arrays and the fixtures within 2 LSB of PIL
(``ccmh``'s own gate, tests/test_native_loader.py).

``python -m tests.test_torch_jpeg_dataset`` rewrites the fixtures and
``expected.npz`` with PIL.
"""

import os

import numpy as np
import pytest
import scipy.io as scio
from PIL import Image

from ccmh.data import native as jnative
from ccmh.data.dataset import BatchIterator as JBatchIterator
from ccmh.data.dataset import CrossModalDataset as JDataset
from ccmh.data.dataset import _to_pil, _transform_u8
from ccmh.data.split import make_splits as jmake_splits
from ccmh.data.synthetic import synthetic_arrays as jsynthetic_arrays
from ccmh.data.synthetic import write_synthetic_mat_dataset as jwrite
from ccmh_torch.data.dataset import BatchIterator, CrossModalDataset
from ccmh_torch.data.split import make_splits
from ccmh_torch.data.synthetic import (
    photo_like_images, synthetic_arrays, write_synthetic_mat_dataset,
)

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "ccmh_torch", "assets", "jpeg")
# name -> (height, width, PIL save options); MIRFlickr's two orientations,
# VGA, the model's own size, an image the transform upscales, grayscale,
# progressive and 4:4:4
FIXTURES = {
    "landscape_500x375": (375, 500, {}),
    "portrait_375x500": (500, 375, {}),
    "vga_640x480": (480, 640, {}),
    "square_224": (224, 224, {}),
    "small_97x131": (131, 97, {}),
    "gray_320x240": (240, 320, {"gray": True}),
    "progressive_320x240": (240, 320, {"progressive": True}),
    "yuv444_256x192": (192, 256, {"subsampling": 0}),
}
RES = 224
MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def write_fixtures(out_dir: str = FIXTURE_DIR) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for i, (name, (h, w, opts)) in enumerate(FIXTURES.items()):
        opts = dict(opts)
        img = Image.fromarray(photo_like_images(1, h, w, seed=100 + i)[0].numpy())
        if opts.pop("gray", False):
            img = img.convert("L")
        img.save(os.path.join(out_dir, f"{name}.jpg"), quality=92, **opts)
    np.savez_compressed(os.path.join(out_dir, "expected.npz"), **pil_outputs(out_dir))


def pil_outputs(fixture_dir: str = FIXTURE_DIR) -> dict:
    """``ccmh``'s PIL path on each fixture at 224, train and eval."""
    return {f"{name}/{mode}": _transform_u8(_to_pil(os.path.join(fixture_dir, f"{name}.jpg")),
                                            RES, mode == "train")
            for name in FIXTURES for mode in ("train", "eval")}


def _loader_normalize(u8):
    """``ccmh``'s native loader's float arithmetic on uint8 pixels: one FMA
    for q * (1/255) - mean (q * r is exact in float64, so one rounding to
    float32 is the FMA's).  A pixel clamped above 255 is folded otherwise
    (loader.cpp); the batches here hold none."""
    q = u8.astype(np.float64)
    fma = (q * np.float32(1 / 255.0) - MEAN.astype(np.float64)).astype(np.float32)
    return fma / STD


def test_expected_npz_is_ccmh_pil_output_of_the_fixtures():
    assert sorted(f for f in os.listdir(FIXTURE_DIR) if f.endswith(".jpg")) == sorted(
        f"{n}.jpg" for n in FIXTURES)
    total = sum(os.path.getsize(os.path.join(FIXTURE_DIR, f"{n}.jpg")) for n in FIXTURES)
    assert total <= 400 * 1024, total
    with np.load(os.path.join(FIXTURE_DIR, "expected.npz")) as stored:
        want = pil_outputs()
        assert set(stored.files) == set(want)
        for key in want:
            np.testing.assert_array_equal(stored[key], want[key], err_msg=key)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_the_loader_decodes_the_fixtures_within_2_lsb_of_pil(mode):
    from ccmh_torch.data import native

    paths = [os.path.join(FIXTURE_DIR, f"{n}.jpg") for n in FIXTURES]
    got, ok = native.decode_batch_u8(paths, RES, mode == "train")
    assert ok.all()
    want, _ = jnative.decode_batch_u8(paths, RES, mode == "train")
    np.testing.assert_array_equal(got, want)
    with np.load(os.path.join(FIXTURE_DIR, "expected.npz")) as stored:
        for name, img in zip(FIXTURES, got):
            diff = np.abs(img.astype(int) - stored[f"{name}/{mode}"])
            assert diff.max() <= 2, (name, diff.max())


def test_the_jpeg_writer_lays_out_what_ccmh_lays_out(tmp_path):
    mine = write_synthetic_mat_dataset(str(tmp_path / "mine"), n=12, n_class=4,
                                       resolution=40, seed=2, jpeg=True)
    ref = jwrite(str(tmp_path / "ref"), n=12, n_class=4, resolution=40, seed=2, jpeg=True)
    m_idx = scio.loadmat(os.path.join(mine, "index.mat"))["index"]
    r_idx = scio.loadmat(os.path.join(ref, "index.mat"))["index"]
    assert m_idx.shape == r_idx.shape and m_idx.dtype.kind == r_idx.dtype.kind == "U"
    for m, r in zip(m_idx, r_idx):
        assert os.path.relpath(m.strip(), mine) == os.path.relpath(r.strip(), ref)
        with open(m.strip(), "rb") as fa, open(r.strip(), "rb") as fb:
            assert fa.read() == fb.read()      # PIL's settings: the same file
    for name, key in (("caption.mat", "caption"), ("label.mat", "category")):
        got, want = (scio.loadmat(os.path.join(d, name))[key] for d in (mine, ref))
        assert got.shape == want.shape
        for g, w in zip(got.ravel(), want.ravel()):
            np.testing.assert_array_equal(g, w)


def test_the_photo_dataset_writer_alternates_the_sizes(tmp_path):
    """chip_smoke.py's dataset: the reference layout, item i at
    ``sizes[i % 2]``, readable by both packages' splits."""
    from ccmh_torch.data import native
    from ccmh_torch.data.synthetic import write_photo_jpeg_dataset

    out = write_photo_jpeg_dataset(str(tmp_path / "d"), 6, n_class=3, seed=1,
                                   sizes=((30, 40), (40, 30)))
    files = [os.path.join(out, f) for f in ("caption.mat", "index.mat", "label.mat")]
    split, jsplit = make_splits(*files, 2, 4, 0), jmake_splits(*files, 2, 4, 0)
    np.testing.assert_array_equal(split.train.labels, jsplit.train.labels)
    paths = [p.strip() for p in scio.loadmat(files[1])["index"]]
    shapes = [Image.open(p).size for p in paths]
    assert shapes == [(40, 30), (30, 40)] * 3                  # PIL's (width, height)
    _, ok = native.decode_batch_u8(paths, 16, True)
    assert ok.all()


@pytest.fixture(scope="module")
def jpeg_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("jpeg_data")
    return write_synthetic_mat_dataset(str(root / "data"), n=30, n_class=4, resolution=40,
                                       seed=5, jpeg=True)


@pytest.mark.parametrize("ragged_last", [True, False], ids=["ragged", "wrap"])
@pytest.mark.parametrize("is_train", [True, False], ids=["train", "eval"])
def test_jpeg_batches_equal_ccmh_native_batches(jpeg_data, is_train, ragged_last):
    files = [os.path.join(jpeg_data, f) for f in ("caption.mat", "index.mat", "label.mat")]
    split, jsplit = make_splits(*files, 6, 16, 1), jmake_splits(*files, 6, 16, 1)
    kw = dict(max_words=16, resolution=32, seed=1)
    it_kw = dict(shuffle=is_train, seed=1, num_workers=2, ragged_last=ragged_last)
    mine = BatchIterator(CrossModalDataset(split.train, is_train=is_train, **kw), 5, **it_kw)
    ref = JBatchIterator(JDataset(jsplit.train, is_train=is_train, **kw), 5, **it_kw)
    for epoch in (0, 1):
        mine.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(mine), list(ref)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"image", "text", "label", "index", "valid"}
            for key in ("text", "label", "index", "valid"):
                np.testing.assert_array_equal(g[key], w[key], err_msg=f"{epoch} {key}")
            assert g["image"].dtype == np.uint8 and w["image"].dtype == np.float32
            np.testing.assert_array_equal(_loader_normalize(g["image"]), w["image"])


def test_npy_images_of_another_size_are_resized_as_ccmh_resizes():
    raw = synthetic_arrays(n=6, n_class=3, resolution=45, seed=4)
    jraw = jsynthetic_arrays(n=6, n_class=3, resolution=45, seed=4)
    for is_train in (True, False):
        mine = CrossModalDataset(raw, is_train=is_train, resolution=32)
        ref = JDataset(jraw, is_train=is_train, resolution=32)
        for i in range(6):
            got, want = mine.load_image(i), ref.load_image(i)
            assert np.abs(got - want).max() * STD.max() * 255 <= 2 + 1e-3


def test_undecodable_items_raise_naming_the_item(tmp_path):
    png = str(tmp_path / "x.jpg")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(png, format="PNG")
    raw = jsynthetic_arrays(n=2, n_class=2, resolution=8, seed=0)
    raw = raw._replace(indexes=np.asarray([png, png]))
    ds = CrossModalDataset(raw, resolution=8)
    with pytest.raises(ValueError, match=r"item 0: .*x\.jpg"):
        ds.load_image(0)
    with pytest.raises(ValueError, match=r"x\.jpg"):
        next(iter(BatchIterator(ds, 2, shuffle=False, num_workers=1)))


if __name__ == "__main__":
    write_fixtures()
