"""Dataset ingestion and the seeded query/train/retrieval split (a copy of
``ccmh/data/split.py``: the same files and seed give the same splits).

Exact split parity with the reference (dataset/dataloader.py:6-61):
``np.random.seed(seed)`` then one permutation; query = first ``query_num``,
train = next ``train_num``, retrieval = *everything except query* (train is
a subset of retrieval).  Identical .mat key conventions:
``caption``/``index``/``category``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.io as scio


class RawData(NamedTuple):
    captions: np.ndarray   # object array: item -> array/list of caption strings
    indexes: np.ndarray    # image paths (str) or raw arrays (npy mode)
    labels: np.ndarray     # [N, n_class] multi-hot


class SplitData(NamedTuple):
    query: RawData
    train: RawData
    retrieval: RawData


def load_raw(caption_file: str, index_file: str, label_file: str, npy: bool = False) -> RawData:
    if caption_file.endswith("mat"):
        captions = scio.loadmat(caption_file)["caption"]
        captions = captions[0] if captions.shape[0] == 1 else captions
    elif caption_file.endswith("txt"):
        with open(caption_file, "r") as fh:
            lines = fh.readlines()
        captions = np.asarray([[line.strip()] for line in lines])
    else:
        raise ValueError("caption file must be .mat or .txt")
    if npy:
        indexes = np.load(index_file, allow_pickle=True)
    else:
        indexes = scio.loadmat(index_file)["index"]
        if indexes.ndim > 1 and 1 in indexes.shape:
            # savemat round-trips 1-D cell/str arrays as (1, N) or (N, 1)
            indexes = indexes.ravel()
    labels = scio.loadmat(label_file)["category"]
    return RawData(captions, indexes, labels)


def split_data(
    raw: RawData, query_num: int = 5000, train_num: int = 10000, seed: int = None
) -> SplitData:
    np.random.seed(seed=seed)
    order = np.random.permutation(range(len(raw.indexes)))
    query_idx = order[:query_num]
    train_idx = order[query_num : query_num + train_num]
    retrieval_idx = order[query_num:]

    def take(idx):
        return RawData(raw.captions[idx], raw.indexes[idx], raw.labels[idx])

    return SplitData(take(query_idx), take(train_idx), take(retrieval_idx))


def make_splits(
    caption_file: str, index_file: str, label_file: str,
    query_num: int = 5000, train_num: int = 10000, seed: int = None, npy: bool = False,
) -> SplitData:
    return split_data(load_raw(caption_file, index_file, label_file, npy), query_num, train_num, seed)
