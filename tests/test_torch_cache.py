"""The port's decoded-image cache (``ccmh_torch/data/cache.py``) against
``ccmh``'s (mirrors tests/test_cache.py): the same fingerprints and the
same on-disk layout, so a cache that either package built is read by the
other; cached batches equal streamed batches; an image edited in place
invalidates the cache; concurrent builders land one valid cache.
Tolerance: none, every comparison is exact.
"""

import os
import threading

import numpy as np
import pytest
from PIL import Image

from ccmh.data import cache as jcache
from ccmh.data.dataset import CrossModalDataset as JDataset
from ccmh.data.split import RawData as JRawData
from ccmh_torch.data import cache
from ccmh_torch.data.dataset import BatchIterator, CrossModalDataset
from ccmh_torch.data.split import RawData


def _sources(tmp_path, kind):
    rng = np.random.RandomState(0)
    if kind == "array":
        return (rng.rand(6, 40, 48, 3) * 255).astype(np.uint8)
    paths = []
    for i, (w, h) in enumerate([(40, 40), (64, 48), (30, 50), (45, 45), (80, 60), (50, 50)]):
        p = str(tmp_path / f"img{i}.jpg")
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(p, quality=92)
        paths.append(p)
    return np.asarray(paths, object)


def _pair(indexes, is_train=True, resolution=32):
    n = len(indexes)
    caps = np.asarray([f"caption {i}" for i in range(n)], object)
    labels = np.eye(n, dtype=np.float32)
    kw = dict(is_train=is_train, max_words=8, resolution=resolution, seed=0)
    return (CrossModalDataset(RawData(caps, indexes, labels), **kw),
            JDataset(JRawData(caps, indexes, labels), **kw))


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("kind", ["jpeg", "array"])
def test_fingerprints_and_payloads_equal_ccmh(tmp_path, kind, is_train):
    mine, ref = _pair(_sources(tmp_path, kind), is_train)
    assert cache.dataset_fingerprint(mine) == jcache.dataset_fingerprint(ref)
    built = cache.open_or_build(mine, str(tmp_path / "c"), "train")
    jbuilt = jcache.open_or_build(ref, str(tmp_path / "j"), "train")
    assert sorted(os.listdir(built.path)) == sorted(os.listdir(jbuilt.path))
    assert built.meta == jbuilt.meta
    if kind == "jpeg":      # ccmh's native loader: the same bits
        np.testing.assert_array_equal(built.images, jbuilt.images)
    else:                   # ccmh's PIL resize: within 2 LSB
        assert np.abs(built.images.astype(int) - jbuilt.images).max() <= 2


def test_each_package_reads_the_others_cache(tmp_path):
    mine, ref = _pair(_sources(tmp_path, "jpeg"))
    path = str(tmp_path / "shared")
    jbuilt = jcache.ImageCache.build(ref, path)
    mtime = os.path.getmtime(os.path.join(path, "meta.json"))
    read = cache.ImageCache.build(mine, path)          # reused, not rebuilt
    assert os.path.getmtime(os.path.join(path, "meta.json")) == mtime
    np.testing.assert_array_equal(read.gather([3, 0]), jbuilt.gather([3, 0]))
    path2 = str(tmp_path / "shared2")
    built = cache.ImageCache.build(mine, path2)
    jread = jcache.ImageCache(path2)
    assert jread.meta["fingerprint"] == jcache.dataset_fingerprint(ref)
    np.testing.assert_array_equal(jread.images, built.images)


@pytest.mark.parametrize("kind", ["jpeg", "array"])
def test_cached_batches_equal_streamed_batches(tmp_path, kind):
    ds, _ = _pair(_sources(tmp_path, kind))
    built = cache.open_or_build(ds, str(tmp_path / "c"), "train")
    kw = dict(seed=3, num_workers=2, ragged_last=True)
    streamed = list(BatchIterator(ds, 4, **kw))
    cached = list(BatchIterator(ds, 4, image_cache=built, **kw))
    assert len(streamed) == len(cached) == 2
    for s, c in zip(streamed, cached):
        assert set(s) == set(c)
        for key in ("text", "label", "index", "valid"):
            np.testing.assert_array_equal(s[key], c[key])
        assert c["image"].dtype == np.uint8
        if kind == "jpeg":      # the loader's uint8, both ways
            np.testing.assert_array_equal(s["image"], c["image"])
        else:                   # npy batches carry host-normalized float32
            from ccmh_torch.data.dataset import normalize_u8

            np.testing.assert_array_equal(s["image"], normalize_u8(c["image"]))


def test_an_image_edited_in_place_invalidates_the_cache(tmp_path):
    ds, _ = _pair(_sources(tmp_path, "jpeg"))
    path = str(tmp_path / "c")
    first = cache.ImageCache.build(ds, path)
    p = str(ds.raw.indexes[0])
    arr = (np.random.RandomState(9).rand(40, 40, 3) * 255).astype(np.uint8)
    Image.fromarray(arr).save(p, quality=92)
    os.utime(p, ns=(1, 1))      # a distinct mtime even on coarse clocks
    second = cache.ImageCache.build(ds, path)
    assert second.meta["fingerprint"] != first.meta["fingerprint"]
    np.testing.assert_array_equal(second.gather([0])[0], ds.load_image_u8(0))
    assert [n for n in os.listdir(path) if n.startswith("images.")] == [second.meta["data"]]


def test_two_concurrent_builders_land_one_valid_cache(tmp_path):
    ds, _ = _pair(_sources(tmp_path, "jpeg"))
    path = str(tmp_path / "c")
    got, errors = [None, None], []

    def build(i):
        try:
            got[i] = cache.ImageCache.build(ds, path, chunk=2)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=build, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    final = cache.ImageCache(path)
    assert final.meta["fingerprint"] == cache.dataset_fingerprint(ds)
    for g in got:
        np.testing.assert_array_equal(g.images, final.images)
    assert not [n for n in os.listdir(path) if ".tmp." in n]
    assert [n for n in os.listdir(path) if n.startswith("images.")] == [final.meta["data"]]


def test_an_undecodable_item_fails_the_build(tmp_path):
    paths = _sources(tmp_path, "jpeg")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(paths[2], format="PNG")
    ds, _ = _pair(paths)
    with pytest.raises(ValueError, match="item 2: .*img2.jpg"):
        cache.ImageCache.build(ds, str(tmp_path / "c"))
    assert not os.path.exists(os.path.join(tmp_path, "c", "meta.json"))
