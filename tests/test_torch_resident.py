"""Prefetch and device residency in the port (``ccmh_torch/data/prefetch.py``,
``ccmh_torch/data/resident.py``, the Trainer's transports) against ``ccmh``
(mirrors tests/test_resident.py).

* ``device_prefetch`` keeps ``ccmh``'s order, its depth-1 control and its
  ``StopIteration`` rule; ``FusedBatchPut`` round-trips bit for bit.
* ``ResidentImages.plan`` in off / on / auto; ``plan_bytes`` equal to the
  bytes pinned (``ccmh``'s figure under a mesh is shown beside it); the
  chunked mode streams where two superblock buffers exceed the budget
  (``ccmh`` over-commits: its figure beside).
* Training: a tiny DSPH run of 2 epochs over a JPEG dataset is bit-equal
  across the port's four transports (streaming, cached, resident,
  chunked), and agrees with ``ccmh``'s Trainer in its resident mode
  within the port's Trainer tolerances (tests/test_torch_cli.py): step
  loss rtol 1e-4, mAP atol 1e-3, parameters atol 1e-4.  Both packages
  start from one ``--pretrained`` ``.npz`` and the heads' dropout is held
  off in both (their masks come from different generators).
* ``--resume`` with the cache on (resident) lands on the uninterrupted
  run bit for bit.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

import jax

from ccmh.cli import main as jax_main
from ccmh.data.cache import ImageCache as JImageCache
from ccmh.data.dataset import CrossModalDataset as JDataset
from ccmh.data.resident import ResidentEvalSplit as JResidentEvalSplit
from ccmh.data.split import RawData as JRawData
from ccmh.models import heads as jheads
from ccmh.train.trainer import Trainer as JTrainer
from ccmh_torch.cli import config_from_args
from ccmh_torch.cli import main as torch_main
from ccmh_torch.clip.model import ClipConfig
from ccmh_torch.data import cache as tcache
from ccmh_torch.data.dataset import CrossModalDataset
from ccmh_torch.data.prefetch import DevicePut, device_prefetch, to_device
from ccmh_torch.data.resident import (
    FusedBatchPut, ResidentEvalSplit, ResidentImages, augment_chunked_batches, pack_epoch,
    plan_chunked,
)
from ccmh_torch.data.split import RawData
from ccmh_torch.data.synthetic import write_synthetic_mat_dataset
from ccmh_torch.models import heads
from ccmh_torch.train.optim import tree_leaves_with_path
from ccmh_torch.train.trainer import Trainer
from tests.torch_outputs import drop_large_outputs  # noqa: F401 -- autouse
from tests.torch_resume_harness import (  # noqa: F401 -- one_thread: the fixture
    _assert_same, _cut_at, metric_rows, one_thread,
)

K = 16
CPU = torch.device("cpu")


def test_device_prefetch_order_depth_and_stop_iteration():
    calls = []

    def put(b):
        calls.append(b)
        return b * 10

    assert list(device_prefetch(range(5), put, depth=3)) == [0, 10, 20, 30, 40]
    calls.clear()
    it = device_prefetch(range(5), put, depth=1)
    assert next(it) == 0 and calls == [0]            # the serialized control
    calls.clear()
    it = device_prefetch(range(5), put, depth=2)
    assert next(it) == 0 and calls == [0, 1]         # one batch put ahead

    def bad_put(b):
        if b == 2:
            raise StopIteration
        return b

    with pytest.raises(RuntimeError):                # not a silently short epoch
        list(device_prefetch(range(5), bad_put, depth=2))
    out = DevicePut(CPU, 2)({"a": np.arange(3, dtype=np.int32), "b": np.ones((2, 2), bool)})
    assert out["a"].dtype == torch.int32 and out["b"].dtype == torch.bool


def test_fused_batch_put_round_trip():
    rng = np.random.RandomState(0)
    batch = {"text": rng.randint(0, 49408, (7, 5)).astype(np.int32),
             "label": rng.rand(7, 3).astype(np.float32),
             "index": np.arange(7, dtype=np.int32),
             "valid": np.asarray([1, 1, 0, 1, 0, 1, 1], bool),
             "key_padding_mask": rng.rand(7, 5) < 0.5}
    fused, spec = FusedBatchPut.pack(batch)
    assert fused.dtype == np.uint8 and fused.size % 16 == 0
    assert all(off % 16 == 0 for *_, off in spec)
    out = FusedBatchPut.unpack(to_device(fused, CPU), spec)
    for k, v in batch.items():
        np.testing.assert_array_equal(out[k].numpy(), v)
        assert out[k].numpy().dtype == v.dtype
    ragged = {k: v[:3] for k, v in batch.items()}
    groups = pack_epoch([batch, batch, ragged])
    assert [(t.shape[0], n) for t, _, n in groups] == [(2, 2), (1, 1)]
    row = FusedBatchPut.unpack(torch.from_numpy(groups[0][0])[1], groups[0][1])
    np.testing.assert_array_equal(row["text"].numpy(), batch["text"])


def _cached(tmp_path, n=12, res=16):
    rng = np.random.RandomState(1)
    raw = RawData(np.asarray([f"caption {i}" for i in range(n)], object),
                  (rng.rand(n, res, res, 3) * 255).astype(np.uint8),
                  np.eye(n, dtype=np.float32))
    ds = CrossModalDataset(raw, is_train=False, max_words=8, resolution=res)
    return ds, tcache.ImageCache.build(ds, str(tmp_path / "c"))


def test_resident_images_plan_and_gather(tmp_path):
    ds, cache = _cached(tmp_path)
    mb = cache.images.nbytes / 2**20
    assert not ResidentImages.plan(cache, budget_mb=mb * 2, mode="off")
    assert ResidentImages.plan(cache, budget_mb=mb * 2, mode="auto")
    assert not ResidentImages.plan(cache, budget_mb=mb / 2, mode="auto")
    assert ResidentImages.plan(cache, budget_mb=mb * 2, mode="on")
    with pytest.raises(ValueError, match="budget"):
        ResidentImages.plan(cache, budget_mb=mb / 2, mode="on")
    res = ResidentImages.maybe(cache, budget_mb=mb * 2, device=CPU)
    idx = np.asarray([3, 0, 7, 7, 11], np.int32)
    np.testing.assert_array_equal(res.gather(idx).numpy(), cache.gather(idx))
    assert ResidentImages.maybe(cache, budget_mb=mb / 2, device=CPU) is None


def test_eval_plan_bytes_are_the_bytes_pinned(tmp_path):
    ds, cache = _cached(tmp_path, n=10)
    split = ResidentEvalSplit(cache, ds, 4, CPU)
    pinned = sum(t.nelement() * t.element_size() for t in (split.images, split.tokens))
    assert ResidentEvalSplit.plan_bytes(cache, ds, 4) == split.nbytes == pinned
    # ccmh's figure: under its 8-device mesh the pin pads the rows to a
    # multiple of 8 that its plan does not count (12 -> 16 rows here)
    jds = JDataset(JRawData(ds.raw.captions, ds.raw.indexes, ds.raw.labels),
                   is_train=False, max_words=8, resolution=16)
    jcache = JImageCache(cache.path)
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("data",))
    jsplit = JResidentEvalSplit(jcache, jds, 4, sharding=NamedSharding(mesh, P("data")))
    assert JResidentEvalSplit.plan_bytes(jcache, jds, 4) == split.nbytes
    assert jsplit.nbytes > JResidentEvalSplit.plan_bytes(jcache, jds, 4)


def test_chunked_mode_streams_where_two_buffers_exceed_the_budget():
    row, batch, n = 3072, 5, 40
    assert plan_chunked(n, row, 2 * batch * row + row, batch) == (1, batch)
    assert plan_chunked(n, row, 2 * batch * row, batch) is None       # streams
    r, m = plan_chunked(n, row, 30 * row, batch, block_rows=8)
    assert r + 2 * m <= 30 and m == 8
    aug, blocks, block_of = augment_chunked_batches(
        [{"index": np.asarray([0, 9, 3, 12])}, {"index": np.asarray([11, 1, 10, 2])}], 4, 3)
    assert [b.tolist() for b in blocks] == [[9, 12], [11, 10]] and block_of == [0, 1]
    assert aug[1]["sb_pos"].tolist() == [0, 0, 1, 0] and aug[0]["is_res"].tolist() == [
        True, False, True, False]
    # ccmh's figure at the same budget: one region row and two batch-sized
    # buffers pinned anyway, over the budget
    fake = types.SimpleNamespace(
        cfg=types.SimpleNamespace(device_resident_budget_mb=2 * batch * row / 2**20,
                                  device_resident_block_rows=0, batch_size=batch),
        _chunked_source=types.SimpleNamespace(images=np.zeros((n, 32, 32, 3), np.uint8)),
        mesh=None, logger=types.SimpleNamespace(info=lambda *_: None))
    JTrainer._init_chunked_residency(fake)
    ck = fake.train_chunked
    assert ck["region"].nbytes + 2 * ck["M"] * row > 2 * batch * row


@pytest.fixture(scope="module")
def jpeg_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("resident_data")
    return write_synthetic_mat_dataset(str(root / "data"), n=40, n_class=5, resolution=40,
                                       seed=3, jpeg=True)


def _argv(data, save_dir, *flags):
    return ["--method", "DSPH", "--dataset", "synthetic", "--output-dim", str(K),
            "--data-dir", data, "--save-dir", str(save_dir), "--epochs", "2",
            "--batch-size", "5", "--query-num", "8", "--train-num", "15", "--eval-batch", "6",
            "--clip-arch", "tiny", "--display-step", "1", "--num-workers", "1", *flags]


def _torch_run(data, save_dir, *flags, **over):
    cfg = config_from_args(_argv(data, save_dir, *flags))
    for k, v in over.items():
        setattr(cfg, k, v)
    tiny = ClipConfig.tiny()
    tr = Trainer(cfg.replace(resolution=tiny.image_resolution), clip_cfg=tiny, device="cpu")
    tr.run()
    return tr


def _rows(save_dir, event):
    with open(os.path.join(save_dir, "metrics.jsonl")) as fh:
        return [r for r in map(json.loads, fh) if r["event"] == event]


def test_four_transports_are_bit_equal_and_agree_with_ccmh(jpeg_data, tmp_path, monkeypatch):
    monkeypatch.setattr(heads, "_dropout", lambda x, *a: x)
    monkeypatch.setattr(jheads, "_dropout", lambda x, *a: x)
    init = str(tmp_path / "init.npz")
    cfg = config_from_args(_argv(jpeg_data, tmp_path / "init"))
    tiny = ClipConfig.tiny()
    Trainer(cfg.replace(resolution=tiny.image_resolution), clip_cfg=tiny,
            device="cpu").save_checkpoint(init)
    pre = ("--pretrained", init)
    runs = {
        "stream": _torch_run(jpeg_data, tmp_path / "s", *pre, "--device-resident", "off"),
        "cached": _torch_run(jpeg_data, tmp_path / "c", *pre, "--cache-images",
                             "--device-resident", "off"),
        "resident": _torch_run(jpeg_data, tmp_path / "r", *pre, "--cache-images",
                               "--device-resident", "on"),
        # 0.04 MiB holds 3 of the 15 rows and two 5-row superblocks
        "chunked": _torch_run(jpeg_data, tmp_path / "k", *pre, "--cache-images",
                              device_resident_budget_mb=0.04),
    }
    assert runs["resident"].train_resident is not None
    assert set(runs["resident"]._resident_eval_plan) == {"query", "retrieval"}
    assert (runs["chunked"].train_chunked["R"], runs["chunked"].train_chunked["M"]) == (3, 5)
    assert runs["cached"].train_resident is runs["cached"].train_chunked is None
    want = runs["stream"]
    for name, got in runs.items():
        _assert_same(got.state.params, want.state.params, f"{name} params")
        _assert_same(got.state.extra, want.state.extra, f"{name} extra")
        assert metric_rows(got) == metric_rows(want), name

    jtr = jax_main(_argv(jpeg_data, tmp_path / "jax", *pre, "--cache-images",
                         "--device-resident", "on"))
    assert jtr.train_resident is not None
    jtrain, ttrain = _rows(jtr.cfg.save_dir, "train"), _rows(want.cfg.save_dir, "train")
    assert len(ttrain) == len(jtrain) == 6          # 3 steps an epoch
    for j, t in zip(jtrain, ttrain):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4, err_msg=f"step {t['step']}")
    for j, t in zip(_rows(jtr.cfg.save_dir, "valid"), _rows(want.cfg.save_dir, "valid")):
        for name in ("i2t", "t2i", "i2i", "t2t"):
            np.testing.assert_allclose(t[name], j[name], atol=1e-3, err_msg=name)
    jparams = jax.device_get(jtr.state.params)
    for path, leaf in tree_leaves_with_path(want.state.params):
        ref = jparams
        for k in path:
            ref = ref[k]
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(ref), atol=1e-4,
                                   err_msg=str(path))


def test_resume_with_the_cache_on_lands_on_the_uninterrupted_run(jpeg_data, tmp_path,
                                                                 monkeypatch):
    flags = ("--cache-images", "--cache-dir", str(tmp_path / "cache"),
             "--checkpoint-every", "1", "--device", "cpu")
    whole = torch_main(_argv(jpeg_data, tmp_path / "whole", *flags))
    holder = {}
    orig_init = Trainer.__init__

    def init(self, *a, **kw):
        orig_init(self, *a, **kw)
        holder["trainer"] = self

    with monkeypatch.context() as m:
        m.setattr(Trainer, "__init__", init)
        _cut_at(m, 4, lambda st: holder["trainer"].request_preempt())
        cut = torch_main(_argv(jpeg_data, tmp_path / "cut", *flags))
    assert cut.train_resident is not None and cut.state.step == 4
    got = torch_main(_argv(jpeg_data, tmp_path / "cut", *flags, "--resume"))
    with open(os.path.join(got.cfg.save_dir, "train.log")) as fh:
        assert "fast-forwarding 1 steps" in fh.read()
    for name in ("params", "extra", "aux"):
        _assert_same(getattr(got.state, name), getattr(whole.state, name), name)
    assert got.state.step == whole.state.step == 6
    assert metric_rows(got)[-1] == metric_rows(whole)[-1]
