"""The port's native image loader (``ccmh_torch/data/native``) against
``ccmh``'s native loader and ``ccmh``'s PIL path (mirrors
tests/test_native_loader.py).

Tolerances: ``decode_batch_u8``, ``decode_batch`` and ``decode_batch_mem``
equal ``ccmh``'s native loader bit for bit (the same libjpeg, the same
transform); against PIL's fixed-point resampling, and for ``resize_u8``
against ``ccmh``'s ``_transform_u8``, within 2 LSB (``ccmh``'s gate);
``encode_jpeg`` writes PIL's bytes.
"""

import io

import numpy as np
import pytest
from PIL import Image

from ccmh.data import native as jnative
from ccmh.data.dataset import _to_pil, _transform, _transform_u8
from ccmh.data.dataset import images_from_bytes as jimages_from_bytes
from ccmh_torch.data import native
from ccmh_torch.data.dataset import images_from_bytes

STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
# colour at several sizes (odd, upscaled, MIRFlickr's 500x375), grayscale
SIZES = [(320, 240), (224, 224), (64, 100), (500, 375), (97, 131), (33, 301)]


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    root = tmp_path_factory.mktemp("jpegs")
    rng = np.random.RandomState(0)
    paths = []
    for i, (w, h) in enumerate(SIZES):
        p = str(root / f"img{i}.jpg")
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(p, quality=92)
        paths.append(p)
    p = str(root / "gray.jpg")
    Image.fromarray((rng.rand(90, 70) * 255).astype(np.uint8)).save(p, quality=92)
    return paths + [p]


def test_the_decoder_is_libjpeg_here():
    assert native.decoder() == "libjpeg"
    assert native.build_flags()[0] == "libjpeg"


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "eval"])
def test_outputs_equal_ccmh_native_loader(jpegs, is_train):
    got, ok = native.decode_batch_u8(jpegs, 224, is_train, n_threads=3)
    want, jok = jnative.decode_batch_u8(jpegs, 224, is_train)
    assert ok.all() and jok.all()
    np.testing.assert_array_equal(got, want)
    got, _ = native.decode_batch(jpegs, 224, is_train)
    np.testing.assert_array_equal(got, jnative.decode_batch(jpegs, 224, is_train)[0])
    blobs = [open(p, "rb").read() for p in jpegs]
    got, _ = native.decode_batch_mem(blobs, 224, is_train)
    np.testing.assert_array_equal(got, jnative.decode_batch_mem(blobs, 224, is_train)[0])
    out = np.zeros((len(jpegs), 224, 224, 3), np.uint8)
    native.decode_batch_u8(jpegs, 224, is_train, out=out)
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "eval"])
def test_within_2_lsb_of_pil(jpegs, is_train):
    images, ok = native.decode_batch(jpegs, 224, is_train)
    assert ok.all()
    for img, p in zip(images, jpegs):
        diff = np.abs(img - _transform(_to_pil(p), 224, is_train)) * STD * 255.0
        assert diff.max() <= 2.0 + 1e-3, (p, diff.max())


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "eval"])
def test_resize_u8_matches_ccmh_transform(is_train):
    rng = np.random.RandomState(1)
    for h, w in [(40, 60), (32, 32), (100, 37), (17, 23)]:
        arr = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        got = native.resize_u8(arr, 32, is_train)
        want = _transform_u8(_to_pil(arr), 32, is_train)
        assert np.abs(got.astype(int) - want).max() <= 2
    gray = (rng.rand(20, 30) * 255).astype(np.uint8)
    assert np.abs(native.resize_u8(gray, 16, is_train).astype(int)
                  - _transform_u8(_to_pil(gray), 16, is_train)).max() <= 2
    same = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(native.resize_u8(same, 32, is_train), same)
    with pytest.raises(ValueError, match="uint8"):
        native.resize_u8(np.zeros((4, 4, 3), np.float32), 8, is_train)


def test_png_and_corrupt_bytes_raise_naming_the_item(jpegs):
    good = open(jpegs[0], "rb").read()
    png = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(png, format="PNG")
    _, ok = native.decode_batch_mem([good, png.getvalue(), b"not a jpeg", b""], 32)
    assert ok.tolist() == [True, False, False, False]
    _, ok = native.decode_batch([jpegs[0], "/nonexistent.jpg"], 32, False)
    assert ok.tolist() == [True, False]
    with pytest.raises(ValueError, match="image 1 "):
        images_from_bytes([good, png.getvalue()], 32)
    with pytest.raises(ValueError, match="image 0 "):
        images_from_bytes([b"\xff\xd8 corrupt"], 32)
    # ccmh decodes the PNG with PIL instead
    assert jimages_from_bytes([good, png.getvalue()], 32).shape == (2, 32, 32, 3)
    np.testing.assert_array_equal(images_from_bytes([good], 32),
                                  jimages_from_bytes([good], 32))


def test_encode_jpeg_writes_pil_bytes():
    rng = np.random.RandomState(2)
    images = [(rng.rand(h, w, 3) * 255).astype(np.uint8) for h, w in [(48, 64), (17, 9)]]
    for img, blob in zip(images, native.encode_jpeg(images)):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=92)
        assert blob == buf.getvalue()
    assert native.encode_jpeg([]) == []
    with pytest.raises(ValueError, match="uint8"):
        native.encode_jpeg([np.zeros((4, 4), np.uint8)])


def test_a_machine_without_a_decoder_raises_naming_what_it_looked_for(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_has_libjpeg", lambda: False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    with pytest.raises(RuntimeError, match="libjpeg.*nvjpeg.h"):
        native.build_flags()
    (tmp_path / "cuda" / "include").mkdir(parents=True)
    (tmp_path / "cuda" / "lib64").mkdir()
    (tmp_path / "cuda" / "include" / "nvjpeg.h").write_text("")
    (tmp_path / "cuda" / "lib64" / "libnvjpeg.so").write_text("")
    decoder, flags = native.build_flags()
    assert decoder == "nvjpeg" and "-DCCMH_NVJPEG" in flags and "-lnvjpeg" in flags
