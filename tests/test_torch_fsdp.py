"""Fully-sharded data parallelism of ccmh_torch (``ccmh_torch/parallel/fsdp.py``)
on gloo ranks on the CPU, held to ``ccmh`` and to the single-device port.

* The sharding table: for every leaf of the parameters and of BertAdam's
  ``m`` and ``v``, ``spec_for_leaf`` gives ``ccmh.parallel.fsdp``'s
  ``state_shardings`` spec, on the tiny ViT and RN trees over (2,), (4,)
  and (2, 2) meshes, and on leaves with no or one divisible dimension.
* One spawn of two ranks (tests/torch_parallel_harness.py ``_fsdp``), a
  (2,) mesh: for each of ccmh's 14 methods and DGHDGH's sequenced step,
  two FSDP steps on a global batch of 8, the first against the DP step on
  the same mesh (the same loss, the gradients within 1e-6 relative norm
  and bit-equal unless a global clip rescales them) and both against the
  single-device steps (test_torch_parallel.py's DP bounds: each
  gradient within 1e-5 of the largest entry, 1e-5 relative norm, the
  losses 1e-5 relative, the state within 1e-4); every sharded leaf and its
  moments hold half the canonical leaf on each rank; remat off, full and
  dots give the same bits; the tiny RN tower against single-device; a
  Trainer's slot and ``.npz`` loaded by a single-device
  run bit for bit, a single-device slot resumed under FSDP bit for bit, a
  run cut after epoch 0 and resumed bit-equal to the uninterrupted one;
  and ``ccmh_torch.cli.main`` with ``--mesh 2 --fsdp``.
* Two more ranks (``_fsdp_ccmh``): one DSPH FSDP step from ccmh's init
  against ccmh's own ``fsdp_train_step`` on a 2-device mesh, with the same
  numpy dropout masks, at the single-device method tests' tolerances.
* One spawn of four ranks (``_fsdp22``), a (2, 2) mesh: one DSPH step's
  gradients against single-device, a quarter of ``qkv_w`` on each rank,
  and the CLI with ``--mesh 2,2 --fsdp``.
"""

import json
import os
import shutil

import numpy as np
import pytest
import scipy.io as scio

import jax

from ccmh.clip.model import ClipConfig as JClipConfig, init_clip_params as j_init_clip
from ccmh.config import Config as JConfig
from ccmh.parallel import fsdp as j_fsdp
from ccmh.parallel import tp as j_tp
from ccmh.parallel.mesh import make_mesh as j_make_mesh, shard_batch as j_shard_batch
from ccmh.train.methods import get_method as j_get_method
from ccmh.train.state import init_state as j_init_state, make_main_optimizer as j_make_opt
from ccmh_torch.clip.model import ClipConfig
from ccmh_torch.data.synthetic import write_synthetic_mat_dataset, write_synthetic_twdh_assets
from ccmh_torch.parallel.fsdp import MIN_SHARD_ELEMS, spec_for_leaf
from ccmh_torch.retrieval import Retriever
from ccmh_torch.train.optim import tree_leaves_with_path
from ccmh_torch.train.trainer import Trainer
from tests import torch_parallel_harness as H
from tests.test_torch_parallel import _cases, _global_batches, _jax_masks
from tests.test_tp import _bert_adam_state
from tests.torch_extra_state_harness import batches as seeded_batches, build, configs, np_tree

TINY = ClipConfig.tiny()
RN_TINY = dict(embed_dim=64, image_resolution=64, vision_layers=(2, 1, 1, 2), vision_width=8,
               vision_patch_size=None, transformer_width=128, transformer_heads=2,
               transformer_layers=2)
TOL = dict(atol=2e-6, rtol=1e-5)
K = H.K


# ------------------------------------------------------------ the sharding table

def _jstate(jclip):
    """ccmh's DSPH TrainState on ``jclip`` (BertAdam's moments included), as
    shapes (``state_shardings`` reads nothing else)."""
    return jax.eval_shape(lambda: _jstate_values(jclip))


def _jstate_values(jclip):
    cfg = JConfig(method="DSPH", output_dim=16, nclass=8, batch_size=8, epochs=1,
                  resolution=jclip.image_resolution, train_num=16)
    key = jax.random.PRNGKey(0)
    method = j_get_method("DSPH")
    heads, extra, aux = method.init(key, cfg, jclip)
    params = {"clip": j_init_clip(key, jclip), **heads}
    tx = j_make_opt(cfg, params, steps_per_epoch=4)
    return j_init_state(jax.random.fold_in(key, 7), params, extra, aux, tx,
                        method.extra_tx(cfg) if method.extra_tx else None)


def _jmesh(shape):
    return j_make_mesh(shape[0]) if len(shape) == 1 else j_tp.make_mesh_2d(*shape)


def _spec(sharding, ndim):
    spec = tuple(sharding.spec)
    return spec + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("mesh_shape", [(2,), (4,), (2, 2)], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("tower", ["vit", "rn"])
def test_sharding_table_matches_ccmh(jstates, tower, mesh_shape):
    state = jstates[tower]
    sh = j_fsdp.state_shardings(state, _jmesh(mesh_shape))
    dp, tp = mesh_shape[0], mesh_shape[1] if len(mesh_shape) > 1 else 1
    moments = _bert_adam_state(sh.opt_state)
    shapes = dict(tree_leaves_with_path(jax.tree.map(lambda x: tuple(x.shape), state.params)))
    trees = {"params": sh.params, "m": moments.m, "v": moments.v}
    n_data = 0
    for path, shape in shapes.items():
        want = spec_for_leaf(path, shape, dp, tp)
        n_data += "data" in want
        for name, tree in trees.items():
            node = tree
            for key in path:
                node = node[key]
            assert _spec(node, len(shape)) == want, (name, path, shape)
    assert n_data > 0
    for tree in (sh.extra, sh.aux):
        for leaf in jax.tree.leaves(tree):
            assert tuple(leaf.spec) == ()


@pytest.mark.parametrize("mesh_shape", [(2,), (4,), (2, 2)], ids=lambda s: "x".join(map(str, s)))
def test_sharding_table_edges_match_ccmh(mesh_shape):
    """Leaves with no divisible dimension, with only a smaller one divisible,
    just under and at MIN_SHARD_ELEMS, and a block leaf whose layer axis is
    the only divisible one."""
    leaves = {"odd": (3, 21847), "small_divisible": (6, 21845),
              "under": (MIN_SHARD_ELEMS - 2,), "at": (MIN_SHARD_ELEMS,),
              "blocks": {"attn": {"qkv_w": (4, 129, 509)}, "mlp": {"fc_w": (2, 256, 1024)}}}
    tree = {"clip": {"visual": jax.tree.map(lambda s: np.zeros(s, np.float32), leaves,
                                            is_leaf=lambda x: isinstance(x, tuple))},
            "img_head": {"w": np.zeros((256, 512), np.float32)}}
    sh = j_fsdp.state_shardings(tree, _jmesh(mesh_shape))
    dp, tp = mesh_shape[0], mesh_shape[1] if len(mesh_shape) > 1 else 1
    got = dict(tree_leaves_with_path(jax.tree.map(np.shape, tree)))
    for path, shape in got.items():
        node = sh
        for key in path:
            node = node[key]
        assert _spec(node, len(shape)) == spec_for_leaf(path, shape, dp, tp), path


# ------------------------------------------------------------------- the ranks

def _trainer_cfg(data, save_dir, mesh_shape, **kw):
    cfg = H.method_config("DSPH", dataset="synthetic", data_dir=data, save_dir=str(save_dir),
                          epochs=1, batch_size=4, train_num=8, query_num=4, eval_batch=4,
                          resolution=32, display_step=1, num_workers=1, checkpoint_every=1,
                          save_model=True, mesh_shape=mesh_shape, fsdp=len(mesh_shape) > 1
                          or mesh_shape[0] > 1)
    return cfg.replace(**kw) if kw else cfg


def _cli_argv(data, save_dir, mesh):
    return ["--method", "DSPH", "--dataset", "synthetic", "--output-dim", str(K),
            "--data-dir", data, "--save-dir", str(save_dir), "--epochs", "2",
            "--batch-size", "4", "--query-num", "4", "--train-num", "8", "--eval-batch", "4",
            "--clip-arch", "tiny", "--display-step", "1", "--num-workers", "1",
            "--device", "cpu", "--save-model", "--checkpoint-every", "1",
            "--mesh", mesh, "--fsdp"]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both spawns, started: their payloads, the single-device Trainer whose
    slot a mesh run resumes, and ccmh's DSPH state and batch, for the
    comparisons made here while the ranks run."""
    root = tmp_path_factory.mktemp("fsdp")
    data = write_synthetic_mat_dataset(str(root / "data"), n=16, n_class=H.N_CLASS,
                                       resolution=32, seed=3)
    twdh = write_synthetic_twdh_assets(str(root / "twdh.npz"), n_class=H.N_CLASS,
                                       long_bits=K, short_bits=8)
    single = Trainer(_trainer_cfg(data, root / "single", (1,)), clip_cfg=TINY, device="cpu")
    single.train()
    single.metrics.close()
    cases = _cases(twdh)
    rn_batches = seeded_batches(21, 2, b=H.B, n_class=H.N_CLASS,
                                res=RN_TINY["image_resolution"])
    for i, b in enumerate(rn_batches):
        b["index"] = np.arange(i * H.B, (i + 1) * H.B, dtype=np.int32) % H.TRAIN_NUM
    payload = {
        "cases": cases,
        "batches": {label: _global_batches(name, 3) for label, name, _ in cases},
        "rn_clip": RN_TINY, "rn_batches": rn_batches,
        "life_cfg": _trainer_cfg(data, root / "life", (2,)),
        "resume_cfg": _trainer_cfg(data, root / "single", (2,)),
        "whole_cfg": _trainer_cfg(data, root / "whole", (2,), epochs=2, valid=False,
                                  checkpoint_every=0, save_model=False),
        "cut_cfg": _trainer_cfg(data, root / "cut", (2,), epochs=2, valid=False,
                                checkpoint_every=0, save_model=False),
        "cli": _cli_argv(data, root / "cli2", "2")}
    two = H.start(root / "ranks2", 2, "fsdp", payload)
    four = H.start(root / "ranks4", 4, "fsdp22", {
        "batch": seeded_batches(13, 1, b=H.B, n_class=H.N_CLASS)[0],
        "cli": _cli_argv(data, root / "cli22", "2,2")})
    jcfg, cfg = configs("DSPH")
    h = build("DSPH", jcfg, cfg)
    batch = seeded_batches(11, 1, b=H.B, n_class=H.N_CLASS)[0]
    ccmh_init = H.start(root / "ranks_ccmh", 2, "fsdp_ccmh", {"ccmh": {"DSPH": (
        cfg, {"params": np_tree(h.jstate.params), "extra": np_tree(h.jstate.extra),
              "aux": np_tree(h.jstate.aux)}, batch)}})
    yield {"two": two, "four": four, "ccmh_init": ccmh_init, "h": h, "batch": batch,
           "root": root, "data": data, "single": H._trainer_digests(single)}
    shutil.rmtree(root)     # the runs' checkpoint slots, ~800 MB


@pytest.fixture(scope="module")
def jstates(spawned):
    """ccmh's DSPH states on the tiny ViT and RN towers (traced while the
    ranks run)."""
    return {"vit": _jstate(JClipConfig.tiny()), "rn": _jstate(JClipConfig(**RN_TINY))}


@pytest.fixture(scope="module")
def ranks(spawned):
    """Both spawns' results, and ccmh's 2-device FSDP step of DSPH from the
    init and batch the ranks take (computed here while the ranks run)."""
    h, batch = spawned["h"], spawned["batch"]
    mesh = j_make_mesh(2)
    with pytest.MonkeyPatch.context() as mp:
        _jax_masks(mp)
        with mesh:
            step, st = j_fsdp.fsdp_train_step(h.jstep, mesh, h.jstate)
            st, m = step(st, j_shard_batch(mesh, {k: np.asarray(v) for k, v in batch.items()}))
    ccmh = {"DSPH": {"params": np_tree(st.params),
                     "metrics": {k: float(v) for k, v in m.items()}}}
    return {"two": spawned["two"](), "four": spawned["four"](),
            "ccmh_init": spawned["ccmh_init"](), "ccmh": ccmh,
            "single": spawned["single"], "root": spawned["root"], "data": spawned["data"]}


@pytest.mark.parametrize("label", [c[0] for c in _cases("")])
def test_fsdp_step_matches_dp_and_single_device(ranks, label):
    r0, r1 = (r["cases"][label] for r in ranks["two"])
    single = next(r["single"][label] for r in ranks["two"] if label in r["single"])
    n_sharded, halves = r0["halves"]
    assert n_sharded > 0 and halves and r1["halves"] == r0["halves"]
    # both ranks end with the same (canonical) state and gradients
    assert r0["digests"] == r1["digests"] and r0["grad_digests"] == r1["grad_digests"]
    # the first step against DP's: the same forward bits, the gradients
    # summed in other places (bit-equal where no global clip rescales them)
    dp = r0["vs_dp"]
    assert dp["losses"][0] == dp["losses"][1]
    assert dp["grad_rel_norm"] <= 1e-6, dp["grad_rel_norm"]
    assert dp["grads_bit_equal"] == dp["n_grads"] or label in ("DPSIH", "DGHDGH_sequenced")
    assert single["grad_norm"] > 0, f"{label}: a flat loss proves nothing"
    np.testing.assert_allclose(*single["losses"], rtol=1e-5)
    bad = {p: e for p, e in single["grads"].items() if not e <= 1.0}
    assert not bad, f"{label} gradients off by more than the tolerance: {bad}"
    assert single["grad_rel_norm"] <= 1e-5
    for what in ("params", "extra", "aux"):
        bad = {p: e for p, e in single["state"][what].items() if not e <= 1.0}
        assert not bad, f"{label} {what} after two steps: {bad}"


def test_fsdp_remat_modes_give_the_same_bits(ranks):
    for rank in ranks["two"]:
        off, full, dots = (rank["remat"][k] for k in ("off", "full", "dots"))
        assert off == full == dots


def test_fsdp_rn_step_matches_single_device(ranks):
    for rank in ranks["two"]:
        rn = rank["rn"]
        n_sharded, halves = rn["halves"]
        assert n_sharded > 0 and halves
        single = rn["vs_single"]
        assert single["grad_norm"] > 0
        np.testing.assert_allclose(*single["losses"], rtol=1e-5)
        assert all(e <= 1.0 for e in single["grads"].values()), single["grads"]
        assert single["grad_rel_norm"] <= 1e-5
        for what in ("params", "extra", "aux"):
            assert all(e <= 1.0 for e in single["state"][what].values()), what


def test_fsdp_step_matches_ccmh_fsdp_train_step(ranks):
    want = ranks["ccmh"]["DSPH"]
    r0, r1 = (rank["DSPH"] for rank in ranks["ccmh_init"])
    assert r0["digests"] == r1["digests"]
    assert set(r0["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        assert r0["metrics"][k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    w, g = dict(H._np_leaves(want["params"])), dict(H._np_leaves(r0["params"]))
    assert set(g) == set(w)
    for path in w:
        np.testing.assert_allclose(g[path], w[path], err_msg=str(path), **TOL)


def test_fsdp_tp_2x2_step_matches_single_device(ranks):
    for r in ranks["four"]:
        assert r["loss_mesh"] == pytest.approx(r["loss_single"], rel=1e-5)
        assert all(e <= 1.0 for e in r["grads"].values()), r["grads"]
        assert r["grad_rel_norm"] <= 1e-5
        # qkv_w [L, W, 3W]: the model axis on its columns, the data axis on
        # its rows, a quarter on each rank
        assert r["qkv_axes"] == {"model": 2, "data": 1}
        local, whole = r["qkv_numel"]
        assert local * 4 == whole
    assert sorted(r["rank"] for r in ranks["four"]) == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_fsdp_trainer_slot_and_npz_load_into_a_single_device_run(ranks):
    root, data = ranks["root"], ranks["data"]
    r0, r1 = (rank["lifecycle"] for rank in ranks["two"])
    assert r0["trained"] == r1["trained"]
    assert r0["trained_halves"][0] > 0 and r0["trained_halves"][1]
    want = r0["trained"]
    slot = Trainer(_trainer_cfg(data, root / "life", (1,), resume=True), clip_cfg=TINY,
                   device="cpu")
    slot.try_resume()
    assert H._trainer_digests(slot) == want
    slot.metrics.close()
    npz = Trainer(_trainer_cfg(data, root / "from_npz", (1,),
                               pretrained=str(root / "life" / "model-0.npz")),
                  clip_cfg=TINY, device="cpu")
    assert H.digests(H.np_tree(npz.state.params)) == want["params"]
    assert npz.state.step == want["step"]
    npz.metrics.close()


def test_single_device_slot_resumes_under_fsdp(ranks):
    for rank in ranks["two"]:
        life = rank["lifecycle"]
        assert life["resumed"] == ranks["single"]
        assert life["resumed_halves"][0] > 0 and life["resumed_halves"][1]


def test_fsdp_run_cut_and_resumed_is_bit_equal(ranks):
    for rank in ranks["two"]:
        life = rank["lifecycle"]
        assert life["cut_resumed"] == life["whole"]
        assert life["cut_resumed"]["step"] == 4
        assert life["cut_resumed_halves"][0] > 0 and life["cut_resumed_halves"][1]


@pytest.mark.parametrize("mesh", ["2", "2,2"])
def test_fsdp_cli_trains_validates_and_saves(ranks, mesh):
    """``--mesh 2 --fsdp`` and ``--mesh 2,2 --fsdp`` through
    ``ccmh_torch.cli.main``: every rank logs, the lead alone writes the
    ``.npz`` files and the slot, and the best epoch's ``.npz`` served on
    one device gives the codes that epoch validated."""
    root, data = ranks["root"], ranks["data"]
    save_dir = root / ("cli2" if mesh == "2" else "cli22") / "DSPH" / "synthetic" / str(K)
    world = 2 if mesh == "2" else 4
    names = set(os.listdir(save_dir))
    assert {"train.log", "metrics.jsonl", "model-0.npz", "model-1.npz", "state_ckpt"} <= names
    assert {f"train.log.p{r}" for r in range(1, world)} <= names
    for suffix in [""] + [f".p{r}" for r in range(1, world)]:
        with open(save_dir / f"metrics.jsonl{suffix}") as fh:
            rows = [json.loads(r) for r in fh]
        assert len([r for r in rows if r["event"] == "train"]) == 4
        assert len([r for r in rows if r["event"] == "valid"]) == 2
    with open(save_dir / "train.log") as fh:
        log = fh.read()
    assert "FSDP weight/moment sharding" in log
    best = int(log.split("Best epoch, I-T: ")[1].split(",")[0])
    mat = scio.loadmat(save_dir / "PR_cruve" / f"{K}-ours-synthetic-i2t.mat")
    cfg = H.method_config("DSPH", dataset="synthetic", data_dir=data,
                          save_dir=str(root / f"serve{world}"), query_num=4, train_num=8,
                          eval_batch=4, resolution=32, num_workers=1,
                          pretrained=str(save_dir / f"model-{best}.npz"))
    batches = list(Trainer(cfg, clip_cfg=TINY, device="cpu").query_loader)
    retriever = Retriever.from_pretrained(cfg, device="cpu")
    images = np.concatenate([b["image"] for b in batches])[:4]
    texts = np.concatenate([b["text"] for b in batches])[:4]
    np.testing.assert_array_equal(retriever.encode_images(images), mat["q_img"])
    np.testing.assert_array_equal(retriever.encode_texts(texts), mat["q_txt"])
