"""Data parallelism of ccmh_torch (``ccmh_torch/parallel/mesh.py``) on two
gloo ranks on the CPU, held to the single-device port and to ``ccmh``.

One spawn of two ranks (tests/torch_parallel_harness.py) serves the whole
file.  For each of ccmh's 14 methods, and DGHDGH's sequenced step, on
``ClipConfig.tiny()`` at K=16 with a global batch of 8 (4 rows a rank):

* the loss and every gradient at the init, the mesh's against the
  single-device step's on the same global batch: loss within 1e-5
  relative, each gradient within 1e-5 of the largest gradient entry and all of
  them within a relative norm of 1e-5 (fp32; only the summation order of
  the tower gradients differs);
* every gradient identical on both ranks (the heads' and ``extra``'s are
  computed after the gather on the whole batch, the towers' are summed),
  checked by digests of the bytes (the trees are large: the ranks hold
  them to the single-device run themselves and send the comparisons);
* two train steps: the parameters, ``extra`` and ``aux`` identical on both
  ranks, the losses within 1e-5 relative of single-device, the parameters
  within ccmh's own DP-vs-single bound (1e-4, tests/test_parallel.py).

DCHMT and DSPH also take one mesh step against ``ccmh``'s
``data_parallel_train_step`` on a 2-device CPU mesh from ccmh's init with
the same numpy dropout masks, at the single-device method tests'
tolerances (params atol 2e-6 / rtol 1e-5, metrics rtol 1e-5).  A mesh
Trainer (TwDH: batch-statistics BatchNorm on its image head) whose last
train and eval batches wrap-pad matches a single-device Trainer with
``--no-ragged-last``: step losses, codes and mAP.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ccmh.models.heads as j_heads
from ccmh.parallel.mesh import (
    data_parallel_train_step as j_dp_step, make_mesh as j_make_mesh,
    replicate as j_replicate, shard_batch as j_shard_batch,
)
from ccmh_torch.config import Config
from ccmh_torch.data.synthetic import write_synthetic_mat_dataset, write_synthetic_twdh_assets
from ccmh_torch.train.methods import available_methods, get_method
from ccmh_torch.train.trainer import Trainer
from ccmh_torch.clip.model import ClipConfig
from tests import torch_parallel_harness as H
from tests.torch_extra_state_harness import batches as seeded_batches, build, configs, np_tree

TOL = dict(atol=2e-6, rtol=1e-5)


def _cases(twdh):
    extra = {"TwDH": {"sets": {"twdh.center_path": twdh}},
             "DHaPH": {"sets": {"dhaph.topk": 3, "dhaph.n_proxies": 24}}}
    cases = [(m, m, extra.get(m, {})) for m in available_methods()]
    return cases + [("DGHDGH_sequenced", "DGHDGH", {"sets": {"dghdgh.sequenced": True}})]


def _global_batches(name, seed):
    out = []
    for i, b in enumerate(seeded_batches(seed, 2, b=H.B, n_class=H.N_CLASS)):
        b["index"] = np.arange(i * H.B, (i + 1) * H.B, dtype=np.int32) % H.TRAIN_NUM
        if name == "DMsH_LN":
            # one-hot labels and the harness's unit-normal label net: the
            # multi-similarity loss mines pairs (ROADMAP, known faults)
            b["label"] = np.eye(H.N_CLASS, dtype=np.float32)[
                np.random.RandomState(seed + i).randint(0, H.N_CLASS, H.B)]
        if get_method(name).needs_mask:
            b["key_padding_mask"] = b["text"] == 0
        out.append(b)
    return out


def _jax_masks(monkeypatch):
    """ccmh's dropout takes the i-th numpy mask on its i-th call (the
    port's ranks take the same masks, torch_parallel_harness._numpy_masks)."""
    calls = [0]

    def dropout(x, rate, rng, train):
        if not train or rate <= 0.0 or rng is None:
            return x
        m = np.random.RandomState(1000 + calls[0]).rand(*x.shape) < 1.0 - rate
        calls[0] += 1
        return jnp.where(jnp.asarray(m), x / (1.0 - rate), 0.0)

    monkeypatch.setattr(j_heads, "_dropout", dropout)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_assets")
    data = write_synthetic_mat_dataset(str(root / "data"), n=24, n_class=H.N_CLASS,
                                       resolution=32, seed=7)
    twdh = write_synthetic_twdh_assets(str(root / "twdh.npz"), n_class=H.N_CLASS,
                                       long_bits=H.K, short_bits=8)
    return root, data, twdh


def _wrap_cfg(data, twdh, save_dir, mesh_shape):
    cfg = Config(method="TwDH", dataset="synthetic", output_dim=H.K, data_dir=data,
                 save_dir=str(save_dir), epochs=1, batch_size=4, train_num=10, query_num=6,
                 eval_batch=4, max_words=H.MAX_WORDS, resolution=32, display_step=1,
                 num_workers=1, ragged_last=False, save_mat=False, mesh_shape=mesh_shape)
    cfg.twdh.center_path = twdh
    return cfg


@pytest.fixture(scope="module")
def both(assets, tmp_path_factory):
    """The ranks' results, and ccmh's 2-device data-parallel step of DCHMT
    and DSPH from the init and batch the ranks take (dropout from the numpy
    masks), computed here while the ranks run."""
    root, data, twdh = assets
    cases = _cases(twdh)
    builds = {}
    for name in ("DCHMT", "DSPH"):
        jcfg, cfg = configs(name)
        h = build(name, jcfg, cfg)
        batch = seeded_batches(11, 1, b=H.B, n_class=H.N_CLASS)[0]
        builds[name] = (h, cfg, batch)
    payload = {
        "cases": cases,
        "batches": {label: _global_batches(name, 3) for label, name, _ in cases},
        "ccmh": {name: (cfg, {"params": np_tree(h.jstate.params),
                              "extra": None if h.jstate.extra is None else np_tree(h.jstate.extra),
                              "aux": np_tree(h.jstate.aux)}, batch)
                 for name, (h, cfg, batch) in builds.items()},
        "wrap_cfg": _wrap_cfg(data, twdh, root / "wrap_mesh", (2,))}
    results = H.start(tmp_path_factory.mktemp("dp_ranks"), 2, "dp_methods", payload)
    ccmh, mesh = {}, j_make_mesh(2)
    with pytest.MonkeyPatch.context() as mp:
        _jax_masks(mp)
        for name, (h, cfg, batch) in builds.items():
            with mesh:
                step = j_dp_step(h.jstep, mesh)
                st, m = step(j_replicate(mesh, h.jstate),
                             j_shard_batch(mesh, {k: np.asarray(v) for k, v in batch.items()}))
            ccmh[name] = {"params": np_tree(st.params),
                          "extra": None if st.extra is None else np_tree(st.extra),
                          "metrics": {k: float(v) for k, v in m.items()}}
    return results(), ccmh


@pytest.mark.parametrize("label", [c[0] for c in _cases("")])
def test_dp_step_matches_the_single_device_step(both, label):
    ranks = both[0]
    r0, r1 = (r["mesh"][label] for r in ranks)
    single = next(r["single"][label] for r in ranks if label in r["single"])
    assert r0["loss"] == pytest.approx(single["loss"], rel=1e-5)
    assert single["grad_paths"]
    assert single["grad_norm"] > 0, f"{label}: a flat loss proves nothing"
    bad = {p: e for p, e in single["grads"].items() if not e <= 1.0}
    assert not bad, f"{label} gradients off by more than the tolerance: {bad}"
    assert single["grad_rel_norm"] <= 1e-5
    # every gradient the same bits on both ranks: the heads' and extra's
    # were computed after the gather, the towers' summed over the ranks
    assert r0["grads"] == r1["grads"]
    np.testing.assert_allclose(r0["steps"], single["steps"], rtol=1e-5)
    for what in ("params", "extra", "aux"):
        assert r0["state"][what] == r1["state"][what], what
        bad = {p: e for p, e in single["state"][what].items() if not e <= 1.0}
        assert not bad, f"{label} {what} after two steps: {bad}"


@pytest.mark.parametrize("name", ["DCHMT", "DSPH"])
def test_dp_step_matches_ccmh_data_parallel_step(both, name):
    want = both[1][name]
    r0, r1 = (rank["ccmh_steps"][name] for rank in both[0])
    assert r0["digests"] == r1["digests"]          # both ranks hold the same state
    assert set(r0["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        assert r0["metrics"][k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    for what in ("params", "extra"):
        w = dict(H._np_leaves(want[what]))
        g = dict(H._np_leaves(r0[what]))
        assert set(g) == set(w), what
        for path in w:
            np.testing.assert_allclose(g[path], w[path], err_msg=f"{what} {path}", **TOL)


def test_mesh_trainer_wraps_the_last_batches_as_single_device(both, assets):
    root, data, twdh = assets
    single = Trainer(_wrap_cfg(data, twdh, root / "wrap_single", (1,)),
                     clip_cfg=ClipConfig.tiny(), device="cpu")
    assert len(single.train_loader) == 3          # 10 items, batches of 4: the last wraps
    single.train_epoch(0)
    codes = [single.get_code(single.query_loader, len(single.query_data))[:2],
             single.get_code(single.retrieval_loader, len(single.retrieval_data))[:2]]
    maps = single.valid(0)
    single.metrics.close()

    def losses(save_dir, suffix=""):
        with open(os.path.join(save_dir, "metrics.jsonl" + suffix)) as fh:
            return [r["loss"] for r in map(json.loads, fh) if r["event"] == "train"]

    want = losses(single.cfg.save_dir)
    assert len(want) == 3
    for rank, suffix in zip((r["wrap"] for r in both[0]), ("", ".p1")):
        np.testing.assert_allclose(losses(root / "wrap_mesh", suffix), want, rtol=1e-5)
        for got, ref in zip(rank["codes"], codes):
            for g, w in zip(got, ref):
                np.testing.assert_array_equal(g, w)
        np.testing.assert_allclose(rank["maps"], maps, atol=1e-6)


@pytest.mark.parametrize("under_torchrun", [False, True])
def test_initialize_multihost_joins_from_torchrun_env_else_is_a_no_op(monkeypatch,
                                                                     under_torchrun):
    import socket

    import torch.distributed as dist

    from ccmh_torch.parallel import mesh as mesh_mod

    monkeypatch.setattr(mesh_mod, "_RANK_DEVICE", None)
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    if under_torchrun:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        monkeypatch.setenv("WORLD_SIZE", "1")
        monkeypatch.setenv("RANK", "0")
        monkeypatch.setenv("LOCAL_RANK", "0")
        monkeypatch.setenv("MASTER_ADDR", "localhost")
        monkeypatch.setenv("MASTER_PORT", str(port))
    assert not dist.is_initialized()
    try:
        assert mesh_mod.initialize_multihost(device="cpu") == 1
        assert dist.is_initialized() == under_torchrun
        if under_torchrun:
            assert mesh_mod.rank_device() == torch.device("cpu")
            mesh = mesh_mod.make_mesh()
            assert (mesh.dp, mesh.rank, mesh.backend) == (1, 0, "gloo")
            assert mesh.any(True) and not mesh.any(False)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
