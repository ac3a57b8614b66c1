"""Tensor parallelism of ccmh_torch (``ccmh_torch/parallel/tp.py``) on gloo
ranks on the CPU, held to ``ccmh`` and to the single-device port.

* ``relayout_state`` is ``ccmh``'s head-major permutation bit for bit, both
  ways; ``validate`` refuses what ``ccmh``'s does, with its messages.
* One spawn of two ranks, a (1, 2) mesh (tests/torch_parallel_harness.py
  ``_tp``): both towers' outputs (pooled, and MITH's tokens and head-mean
  attention rows) within 1e-5 of the single-device port and the pooled
  embeddings within 1e-5 of ``ccmh``; one DSPH and one MITH step, the
  gathered gradients within 1e-5 of the largest gradient entry (1e-5
  relative), BertAdam's per-layer clip of every sharded leaf on gradients
  scaled past a per-layer norm of 1, the loss and the parameters after
  two steps (atol 1e-5); ``Retriever(tp_mesh=)``'s codes equal to single-device; a
  Trainer's slot and ``.npz`` from the mesh loaded by a single-device run
  bit for bit, a single-device slot resumed on the mesh bit for bit.
* One spawn of four ranks, a (2, 2) mesh (``_tp22``): one DSPH step's
  gradients against single-device.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from ccmh.clip.model import (
    ClipConfig as JClipConfig, init_clip_params as j_init_clip,
    text_forward as j_text_forward, vision_forward as j_vision_forward,
)
from ccmh.parallel import tp as j_tp
from ccmh_torch.bridge import params_from_jax
from ccmh_torch.clip.model import ClipConfig
from ccmh_torch.data.synthetic import write_synthetic_mat_dataset
from ccmh_torch.parallel import tp
from ccmh_torch.train import checkpoint as ck
from ccmh_torch.train.methods.base import image_features, text_features
from ccmh_torch.train.trainer import Trainer
from tests import torch_parallel_harness as H
from tests.torch_extra_state_harness import batches as seeded_batches

TINY = ClipConfig.tiny()
CLIP_SCALE = 1e4      # gradients scaled so BertAdam's per-layer clip acts


def _jclip():
    return jax.tree.map(np.asarray, j_init_clip(jax.random.PRNGKey(0), JClipConfig.tiny()))


def _inputs():
    rng = np.random.RandomState(4)
    images = rng.randn(4, 32, 32, 3).astype(np.float32)
    ids = seeded_batches(8, 1, b=4)[0]["text"]
    return images, ids


def _trainer_cfg(data, save_dir, mesh_shape, **kw):
    cfg = H.method_config("DSPH", dataset="synthetic", data_dir=data, save_dir=str(save_dir),
                          epochs=1, batch_size=4, train_num=8, query_num=4, eval_batch=4,
                          resolution=32, display_step=1, num_workers=1, checkpoint_every=1,
                          save_model=True, mesh_shape=mesh_shape)
    return cfg.replace(**kw) if kw else cfg


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    data = write_synthetic_mat_dataset(str(root / "data"), n=16, n_class=H.N_CLASS,
                                       resolution=32, seed=3)
    # a single-device slot for the mesh run to resume
    single = Trainer(_trainer_cfg(data, root / "single", (1,)), clip_cfg=TINY, device="cpu")
    single.train()
    single.metrics.close()
    images, ids = _inputs()
    batches = {}
    for name in ("DSPH", "MITH"):
        b = seeded_batches(12, 1, b=H.B, n_class=H.N_CLASS)[0]
        b["index"] = np.arange(H.B, dtype=np.int32)
        if name == "MITH":
            b["key_padding_mask"] = b["text"] == 0
        batches[name] = b
    payload = {"jclip": _jclip(), "images": images, "ids": ids, "batches": batches,
               "clip_scale": CLIP_SCALE,
               "tp_cfg": _trainer_cfg(data, root / "mesh", (1, 2)),
               "tp_npz": str(root / "mesh" / "model-0.npz"),
               "resume_cfg": _trainer_cfg(data, root / "single", (1, 2), resume=True)}
    results = H.run(root / "ranks", 2, "tp", payload)
    yield results, {"data": data, "root": root, "single": single}
    shutil.rmtree(root)     # the runs' checkpoint slots


def test_relayout_state_is_ccmhs_bit_for_bit():
    jclip = _jclip()
    rng = np.random.RandomState(0)
    moments = jax.tree.map(lambda a: np.asarray(rng.randn(*a.shape), np.float32), jclip)
    state = {"params": {"clip": jclip}, "opt": [{"m": {"clip": moments}}]}
    tstate = {"params": params_from_jax(state["params"], device="cpu"),
              "opt": [{"m": params_from_jax(state["opt"][0]["m"], device="cpu")}]}
    for to_head_major in (True, False):
        want = j_tp.relayout_state(state, JClipConfig.tiny(), to_head_major)
        got = tp.relayout_state(tstate, TINY, to_head_major)
        for (path, g), (_, w) in zip(H._np_leaves(H.np_tree(got)), H._np_leaves(want)):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(path))
    there = tp.relayout_clip(params_from_jax(jclip, device="cpu"), TINY, True)
    back = tp.relayout_clip(there, TINY, False)
    for (_, g), (_, w) in zip(H._np_leaves(H.np_tree(back)), H._np_leaves(jclip)):
        np.testing.assert_array_equal(g, w)


def test_validate_refuses_as_ccmh():
    rn = dataclasses.replace(TINY, vision_layers=(1, 1, 1, 1), vision_patch_size=None)
    jrn = dataclasses.replace(JClipConfig.tiny(), vision_layers=(1, 1, 1, 1),
                              vision_patch_size=None)
    for cfg, jcfg, size in ((TINY, JClipConfig.tiny(), 4), (rn, jrn, 2)):
        with pytest.raises(ValueError) as want:
            j_tp.validate(jcfg, size)
        with pytest.raises(ValueError) as got:
            tp.validate(cfg, size)
        assert str(got.value) == str(want.value)
    tp.validate(TINY, 2)


def test_towers_over_the_model_axis_match_single_device_and_ccmh(ranks):
    images, ids = _inputs()
    params = {"clip": params_from_jax(_jclip(), device="cpu")}
    timg, tids = torch.from_numpy(images), torch.from_numpy(ids)
    with torch.no_grad():
        want = {("vision", m): H.np_tree(image_features(params, TINY, timg, features=m)._asdict())
                for m in ("pooled", "mith")}
        want.update({("text", m): H.np_tree(text_features(
            params, TINY, tids, features=m, key_padding_mask=tids == 0)._asdict())
            for m in ("pooled", "mith")})
    jclip = _jclip()
    jv = np.asarray(j_vision_forward(jclip["visual"], JClipConfig.tiny(), images).pooled)
    jt = np.asarray(j_text_forward(jclip["text"], JClipConfig.tiny(), ids,
                                   key_padding_mask=ids == 0).pooled)
    for rank in ranks[0]:
        for key, w in want.items():
            for field, value in w.items():
                if value is None:
                    assert rank[key][field] is None
                elif value.dtype == bool:
                    np.testing.assert_array_equal(rank[key][field], value)
                else:
                    np.testing.assert_allclose(rank[key][field], value, atol=1e-5, rtol=1e-5,
                                               err_msg=f"{key} {field}")
        np.testing.assert_allclose(rank[("vision", "pooled")]["pooled"], jv, atol=1e-5)
        np.testing.assert_allclose(rank[("text", "pooled")]["pooled"], jt, atol=1e-5)


@pytest.mark.parametrize("name", ["DSPH", "MITH"])
def test_one_step_over_the_model_axis_matches_single_device(ranks, name):
    r0, r1 = (rank["steps"][name] for rank in ranks[0])
    for r in (r0, r1):
        assert r["loss_mesh"] == pytest.approx(r["loss_single"], rel=1e-5)
        bad = {p: e for p, e in H.worst(r["grads_mesh"], r["grads_single"], 1e-5, lambda v: 1e-5 * max(
            np.abs(x).max() for x in v)).items() if not e <= 1.0}
        assert not bad, bad
        assert H.rel_norm(r["grads_mesh"], r["grads_single"]) <= 1e-5
        # BertAdam's clip acted on the sharded leaves: some layer's norm
        # exceeds 1, and each rank clipped by the whole leaf's norm
        assert any((n > 1.0).any() for n in r["raw_single_norms"].values())
        assert set(r["clipped_mesh"]) == set(r["clipped_single"])
        for path, w in r["clipped_single"].items():
            np.testing.assert_allclose(r["clipped_mesh"][path], w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max(), err_msg=str(path))
        assert r["step_mesh"]["loss"] == pytest.approx(r["step_single"]["loss"], rel=1e-5)
        bad = {p: e for p, e in H.worst(r["step_mesh"]["params"], r["step_single"]["params"],
                                        0.0, 1e-5).items() if not e <= 1.0}
        assert not bad, bad
    # replicated leaves the same bits on both model ranks (Megatron's
    # construction gives them the same gradients)
    l0, l1 = (dict(H._np_leaves(r["step_mesh"]["local"])) for r in (r0, r1))
    for path, a in l0.items():
        if path[-2:] not in tp._TP_BLOCK_SPECS:
            np.testing.assert_array_equal(a, l1[path], err_msg=str(path))


def test_tp_retriever_codes_equal_single_device(ranks):
    for rank in ranks[0]:
        for got, want in zip(rank["retriever"]["mesh"], rank["retriever"]["single"]):
            np.testing.assert_array_equal(got, want)


def test_tp_slot_and_npz_load_into_a_single_device_run_bit_for_bit(ranks):
    results, env = ranks
    canon = results[0]["trainer"]["canonical"]
    assert H.digests(canon["params"]) == H.digests(results[1]["trainer"]["canonical"]["params"])
    cfg = _trainer_cfg(env["data"], env["root"] / "mesh", (1,), resume=True)
    single = Trainer(cfg, clip_cfg=TINY, device="cpu")
    single.try_resume()
    single.metrics.close()
    for (path, g), (_, w) in zip(H._np_leaves(H.np_tree(single.state.params)),
                                 H._np_leaves(canon["params"])):
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    want = canon["optimizer"]
    got = single.optimizer.state_dict()
    assert got["param_groups"] == want["param_groups"]
    for pid, st in want["state"].items():
        for name in ("m", "v"):
            assert torch.equal(got["state"][pid][name], st[name]), (pid, name)
    npz = ck.load_checkpoint(str(env["root"] / "mesh" / "model-0.npz"))
    for (path, g), (_, w) in zip(H._np_leaves(npz["params"]), H._np_leaves(canon["params"])):
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    # the mesh's .npz, served on one device, gives the mesh trainer's codes
    np.testing.assert_array_equal(results[0]["trainer"]["served_codes"],
                                  results[0]["trainer"]["query_codes"][0])


def test_single_device_slot_resumes_on_the_model_axis_bit_for_bit(ranks):
    results, env = ranks
    slot = ck.load_state(str(env["root"] / "single" / "state_ckpt"))
    for rank in results:
        got = rank["trainer"]["resumed"]
        assert got["step"] == int(slot["step"])
        for (path, g), (_, w) in zip(H._np_leaves(got["params"]),
                                     H._np_leaves(H.np_tree(slot["params"]))):
            np.testing.assert_array_equal(g, w, err_msg=str(path))
        for pid, st in slot["optimizer"]["state"].items():
            for name in ("m", "v"):
                assert torch.equal(got["optimizer"]["state"][pid][name], st[name]), (pid, name)


def test_2x2_mesh_step_matches_single_device(tmp_path):
    b = seeded_batches(13, 1, b=H.B, n_class=H.N_CLASS)[0]
    b["index"] = np.arange(H.B, dtype=np.int32)
    results = H.run(tmp_path, 4, "tp22", {"batch": b})
    assert sorted(r["rank"] for r in results) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in results:
        assert r["loss_mesh"] == pytest.approx(r["loss_single"], rel=1e-5)
        bad = {p: e for p, e in H.worst(r["grads_mesh"], r["grads_single"], 1e-5, lambda v: 1e-5 * max(
            np.abs(x).max() for x in v)).items() if not e <= 1.0}
        assert not bad, bad
    assert len({tuple(sorted(H.digests(r["grads_mesh"]).items())) for r in results}) == 1
