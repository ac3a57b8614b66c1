"""The port's data pipeline against ccmh's: the seeded splits, the
``BatchIterator`` batches of epochs 0 and 1 (indices, caption ids, labels,
images, ``valid``), and the synthetic dataset writer.  Everything here is
exact: the same numpy permutations, the same caption draws, the same BPE
ids, and npy-mode images at the configured resolution, which ccmh passes
through PIL's same-size resize unchanged and normalizes with the same
float32 ops.
"""

import os

import numpy as np
import pytest
import scipy.io as scio

from ccmh.data.dataset import BatchIterator as JBatchIterator, CrossModalDataset as JDataset
from ccmh.data.split import make_splits as j_make_splits
from ccmh.data.synthetic import write_synthetic_mat_dataset as j_write
from ccmh_torch.data.dataset import BatchIterator, CrossModalDataset
from ccmh_torch.data.split import make_splits
from ccmh_torch.data.synthetic import synthetic_arrays, write_synthetic_mat_dataset

RES = 32


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    kw = dict(n=50, n_class=5, resolution=RES, seed=4)
    return j_write(str(root / "jax"), **kw), write_synthetic_mat_dataset(str(root / "torch"), **kw)


def _files(d):
    return [os.path.join(d, f) for f in ("caption.mat", "index.npy", "label.mat")]


def test_synthetic_writer_writes_ccmh_files(datasets):
    jdir, tdir = datasets
    with open(os.path.join(jdir, "index.npy"), "rb") as a, \
            open(os.path.join(tdir, "index.npy"), "rb") as b:
        assert a.read() == b.read()
    for name, key in (("label.mat", "category"), ("caption.mat", "caption")):
        want = scio.loadmat(os.path.join(jdir, name))[key]
        got = scio.loadmat(os.path.join(tdir, name))[key]
        if key == "category":
            np.testing.assert_array_equal(got, want)
        else:
            assert [list(map(str, c.ravel())) for c in got.ravel()] == \
                   [list(map(str, c.ravel())) for c in want.ravel()]
        # the .mat files differ only in scipy's header timestamp
        with open(os.path.join(jdir, name), "rb") as a, open(os.path.join(tdir, name), "rb") as b:
            assert a.read()[128:] == b.read()[128:]


def test_splits_match(datasets):
    jdir, _ = datasets
    args = (*_files(jdir), 10, 30, 1814)
    want = j_make_splits(*args, npy=True)
    got = make_splits(*args, npy=True)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(g.indexes), np.asarray(w.indexes))
        np.testing.assert_array_equal(g.labels, w.labels)
        assert [list(map(str, np.ravel(c))) for c in g.captions] == \
               [list(map(str, np.ravel(c))) for c in w.captions]


@pytest.mark.parametrize("ragged_last,drop_last,shuffle", [
    (True, False, True), (False, False, True), (False, True, False)])
def test_batches_of_two_epochs_match(datasets, ragged_last, drop_last, shuffle):
    jdir, _ = datasets
    splits = make_splits(*_files(jdir), 10, 30, 1814, npy=True)
    jsplits = j_make_splits(*_files(jdir), 10, 30, 1814, npy=True)
    kw = dict(max_words=16, resolution=RES, seed=1814)
    it_kw = dict(shuffle=shuffle, seed=1814, num_workers=3, drop_last=drop_last,
                 ragged_last=ragged_last)
    mine = BatchIterator(CrossModalDataset(splits.train, is_train=True, **kw), 8, **it_kw)
    ref = JBatchIterator(JDataset(jsplits.train, is_train=True, **kw), 8, **it_kw)
    assert len(mine) == len(ref)
    for epoch in (0, 1):
        mine.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(mine), list(ref)
        assert len(got) == len(want) == len(mine)
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"image", "text", "label", "index", "valid"}
            for key in w:
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=f"epoch {epoch} {key}")


def test_other_image_sizes_raise_not_yet_ported():
    raw = synthetic_arrays(n=4, n_class=3, resolution=RES + 8, seed=0)
    ds = CrossModalDataset(raw, resolution=RES)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ds.load_image(0)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        write_synthetic_mat_dataset("/nonexistent-dir-never-made", jpeg=True)


def test_a_consumer_that_stops_early_does_not_hang():
    raw = synthetic_arrays(n=40, n_class=3, resolution=RES, seed=0)
    it = BatchIterator(CrossModalDataset(raw, resolution=RES), 4, num_workers=2, prefetch=1)
    for i, _ in enumerate(it):
        if i == 1:
            break
    assert sum(1 for _ in it) == 10
