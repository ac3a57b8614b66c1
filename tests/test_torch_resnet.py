"""The ModifiedResNet CLIP tower of the port against ccmh's.

A tiny RN tower: ``vision_layers=(2, 1, 1, 2)`` (identity and downsample
shortcuts both run), ``vision_width=8`` (256-wide attention pool, 4
heads), 64x64 images (a 2x2 pool grid) and a 128-wide text tower of 2
layers and 2 heads.  ccmh initialises it; its BatchNorm leaves are then
redrawn from a seeded numpy generator (scale and var in [0.5, 1.5], bias
and mean N(0, 0.1)), because ccmh's init zeroes every ``bn3`` scale, which
would leave most of a block's leaves without a gradient.  The tree crosses
to the port as numpy.

Tolerances: fp32 embeddings within atol 1e-5 and rtol 1e-4; the gradient
of every visual leaf within a relative norm of 1e-4 of ccmh's; bf16
embeddings at a cosine of at least 0.999 with fp32 and with ccmh's bf16;
conversions and ``.npz`` round trips exact.  The train steps on this
tower are in tests/test_torch_resnet_steps.py.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccmh.clip import model as jm
from ccmh_torch.bridge import params_from_jax
from ccmh_torch.clip import model as tm
from ccmh_torch.train.optim import tree_leaves_with_path
from tests import torch_extra_state_harness as H

RN_TINY = dict(embed_dim=64, image_resolution=64, vision_layers=(2, 1, 1, 2), vision_width=8,
               vision_patch_size=None, context_length=77, vocab_size=49408,
               transformer_width=128, transformer_heads=2, transformer_layers=2)
J_RN = jm.ClipConfig(**RN_TINY)
T_RN = tm.ClipConfig(**RN_TINY)
GRAD_REL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _redraw_bn(tree, rng):
    """Every BatchNorm dict of ``tree`` (numpy) with seeded statistics."""
    if isinstance(tree, dict) and set(tree) == {"scale", "bias", "mean", "var"}:
        c = tree["scale"].shape
        return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": (0.1 * rng.randn(*c)).astype(np.float32),
                "mean": (0.1 * rng.randn(*c)).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    if isinstance(tree, dict):
        return {k: _redraw_bn(v, rng) for k, v in tree.items()}
    return tree


def rn_clip_params(key, cfg):
    """ccmh's CLIP init of ``cfg`` with its BatchNorm leaves redrawn."""
    params = _np_tree(jax.jit(jm.init_clip_params, static_argnums=1)(key, cfg))
    params["visual"] = _redraw_bn(params["visual"], np.random.RandomState(3))
    return jax.tree.map(jnp.asarray, params)


@pytest.fixture(scope="module")
def towers():
    jp = rn_clip_params(jax.random.PRNGKey(0), J_RN)
    return jp, params_from_jax(_np_tree(jp), device="cpu")


def _images(n, seed, uint8=False):
    rng = np.random.RandomState(seed)
    if uint8:
        return rng.randint(0, 256, (n, 64, 64, 3)).astype(np.uint8)
    return rng.randn(n, 64, 64, 3).astype(np.float32)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_port_takes_cudnns_deterministic_algorithms():
    """The tower's convolutions run on cuDNN on the card; its default
    algorithms may sum a weight gradient in another order each run, which
    would break a resumed run's bit-equality (chip_smoke.py phase 15)."""
    import ccmh_torch  # noqa: F401

    assert torch.backends.cudnn.deterministic
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


def test_config_selects_the_resnet_tower():
    assert T_RN.is_resnet and not tm.ClipConfig().is_resnet
    listed = tm.ClipConfig(**{**RN_TINY, "vision_layers": [2, 1, 1, 2]})
    assert listed.vision_layers == (2, 1, 1, 2) and listed == T_RN
    assert tuple(f.name for f in dataclasses.fields(tm.ClipConfig)) == tuple(
        f.name for f in dataclasses.fields(jm.ClipConfig) if f.name != "qkv_layout")


@pytest.mark.parametrize("uint8", [False, True], ids=["float", "uint8"])
def test_fp32_embedding_matches_ccmh(towers, uint8):
    jp, tp = towers
    images = _images(3, seed=1, uint8=uint8)
    want = np.asarray(jax.jit(jm.encode_image, static_argnums=1)(jp, J_RN, jnp.asarray(images)))
    got = tm.vision_forward(tp["visual"], T_RN, torch.from_numpy(images)).pooled.numpy()
    assert got.shape == (3, 64)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_every_visual_gradient_matches_ccmh(towers):
    """The gradient of one scalar of the embeddings for every visual leaf
    (convolutions, BatchNorm scale, bias, mean and var, the attention
    pool), each within a relative norm of GRAD_REL of ``jax.grad``'s."""
    jp, _ = towers
    images = _images(4, seed=2)
    w = np.random.RandomState(4).randn(4, 64).astype(np.float32)

    def jloss(visual):
        return jnp.sum(jm.vision_forward(visual, J_RN, jnp.asarray(images)).pooled * w)

    jg = _np_tree(jax.jit(jax.grad(jloss))(jp["visual"]))
    visual = params_from_jax(_np_tree(jp["visual"]), device="cpu")
    paths, leaves = zip(*tree_leaves_with_path(visual))
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = (tm.vision_forward(visual, T_RN, torch.from_numpy(images)).pooled
            * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(loss, leaves)
    largest = max(np.linalg.norm(_get(jg, path)) for path in paths)
    kinds = set()
    for path, g in zip(paths, grads):
        want = _get(jg, path)
        if path == ("attnpool", "k_b"):
            # exactly 0: a key bias shifts all of a row's logits alike
            assert max(np.linalg.norm(want), np.linalg.norm(g.numpy())) <= 1e-6 * largest
            continue
        norm = np.linalg.norm(want)
        assert norm > 0, f"{path}: ccmh's gradient is 0"
        err = np.linalg.norm(g.numpy() - want) / norm
        assert err <= GRAD_REL, f"{path}: relative gradient error {err}"
        kinds.add(path[-1])
    assert {"mean", "var", "scale", "bias", "conv", "q_w", "c_b",
            "positional_embedding"} <= kinds


def _cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


def test_bf16_embedding_near_fp32_and_ccmh(towers):
    jp, tp = towers
    images = _images(3, seed=5)
    x = torch.from_numpy(images)
    f32 = tm.vision_forward(tp["visual"], T_RN, x).pooled.numpy()
    b16 = tm.vision_forward(tp["visual"], T_RN, x, dtype=torch.bfloat16).pooled
    assert b16.dtype == torch.bfloat16
    j16 = jax.jit(jm.encode_image, static_argnums=1, static_argnames="dtype")(
        jp, J_RN, jnp.asarray(images), dtype=jnp.bfloat16)
    b16 = b16.float().numpy()
    assert _cosine(b16, f32).min() >= 0.999
    assert _cosine(b16, np.asarray(j16.astype(jnp.float32))).min() >= 0.999
    # weights cast once (a bf16 server) give the bits of the per-call cast
    cast = tm.cast_clip_params(tp, torch.bfloat16)
    assert {t.dtype for _, t in tree_leaves_with_path(cast["visual"])} == {torch.bfloat16}
    again = tm.vision_forward(cast["visual"], T_RN, x, dtype=torch.bfloat16).pooled
    np.testing.assert_array_equal(again.float().numpy(), b16)


def test_token_features_are_refused(towers):
    _, tp = towers
    x = torch.from_numpy(_images(1, seed=6))
    for features in ("tokens", "mith"):
        with pytest.raises(ValueError, match="ViT tower"):
            tm.vision_forward(tp["visual"], T_RN, x, features=features)


# ---------------------------------------------------------------- conversion

def openai_rn_state_dict(clip):
    """The inverse of the RN conversion: a CLIP tree (numpy or tensors) ->
    an OpenAI-layout state dict of tensors, with BatchNorm's
    ``num_batches_tracked`` as a release file has it."""
    from ccmh_torch.bridge import params_to_jax
    from ccmh_torch.clip.export_ref import _export_blocks, _ln

    tree = params_to_jax(clip)
    v, t = tree["visual"], tree["text"]
    sd = {}

    def conv(key, w):
        sd[key] = w.transpose(3, 2, 0, 1)                   # HWIO -> OIHW

    def bn(prefix, p):
        sd.update({f"{prefix}.weight": p["scale"], f"{prefix}.bias": p["bias"],
                   f"{prefix}.running_mean": p["mean"], f"{prefix}.running_var": p["var"],
                   f"{prefix}.num_batches_tracked": np.asarray(0, np.int64)})

    for i in (1, 2, 3):
        conv(f"visual.conv{i}.weight", v["stem"][f"conv{i}"])
        bn(f"visual.bn{i}", v["stem"][f"bn{i}"])
    for li in (1, 2, 3, 4):
        for bi, blk in v[f"layer{li}"].items():
            pre = f"visual.layer{li}.{bi}"
            for ci in (1, 2, 3):
                conv(f"{pre}.conv{ci}.weight", blk[f"conv{ci}"])
                bn(f"{pre}.bn{ci}", blk[f"bn{ci}"])
            if "downsample" in blk:
                conv(f"{pre}.downsample.0.weight", blk["downsample"]["conv"])
                bn(f"{pre}.downsample.1", blk["downsample"]["bn"])
    pool = v["attnpool"]
    sd["visual.attnpool.positional_embedding"] = pool["positional_embedding"]
    for name in ("q", "k", "v", "c"):
        sd[f"visual.attnpool.{name}_proj.weight"] = pool[f"{name}_w"].T
        sd[f"visual.attnpool.{name}_proj.bias"] = pool[f"{name}_b"]
    sd["token_embedding.weight"] = t["token_embedding"]
    sd["positional_embedding"] = t["positional_embedding"]
    _export_blocks(sd, "transformer", t["blocks"])
    _ln(sd, "ln_final", t["ln_final"])
    sd["text_projection"] = t["text_projection"]
    sd["logit_scale"] = np.asarray(tree["logit_scale"], np.float32)
    return {k: torch.from_numpy(np.array(a, order="C")) for k, a in sd.items()}


def _assert_same_tree(got, want):
    got, want = dict(tree_leaves_with_path(got)), dict(tree_leaves_with_path(want))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        a = leaf.detach().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        b = want[path]
        b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def _same_cfg(tcfg, jcfg):
    assert isinstance(tcfg.vision_layers, tuple) and tcfg.is_resnet
    for f in dataclasses.fields(tm.ClipConfig):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


def test_openai_state_dict_converts_alike_in_both_packages(towers, tmp_path):
    from ccmh.clip.convert import convert_state_dict as j_convert
    from ccmh_torch.clip.convert import (
        convert_state_dict, convert_state_dict_numpy, infer_clip_config, load_clip_params,
    )

    jp, tp = towers
    sd = openai_rn_state_dict(tp)
    assert sum(k.endswith("num_batches_tracked") for k in sd) > 0
    jtree, jcfg = j_convert(dict(sd))
    tree, cfg = convert_state_dict_numpy(dict(sd))
    _assert_same_tree(tree, _np_tree(jtree))
    _assert_same_tree(tree, _np_tree(jp))          # the test's inverse, held to ccmh's
    _same_cfg(cfg, jcfg)
    assert cfg == T_RN and infer_clip_config(tree) == T_RN
    on_cpu, cfg2 = convert_state_dict(dict(sd), device="cpu")
    _assert_same_tree(on_cpu, tree)
    assert cfg2 == T_RN
    # an OpenAI .pt through --clip-path
    pt = str(tmp_path / "rn_tiny.pt")
    torch.save(sd, pt)
    loaded, cfg3 = load_clip_params(pt, device="cpu")
    _assert_same_tree(loaded, tree)
    assert cfg3 == T_RN


def test_npz_files_cross_both_ways(towers, tmp_path):
    from ccmh.clip.convert import load_params_npz as j_load
    from ccmh.clip.convert import save_params_npz as j_save
    from ccmh_torch.clip.convert import load_params_npz, save_params_npz

    jp, tp = towers
    ours = str(tmp_path / "port.npz")
    save_params_npz(ours, tp)
    jtree, jcfg = j_load(ours)
    _assert_same_tree(tp, _np_tree(jtree))
    _same_cfg(T_RN, jcfg)
    theirs = str(tmp_path / "ccmh.npz")
    j_save(theirs, jp)
    tree, cfg = load_params_npz(theirs, device="cpu")
    assert isinstance(tree["visual"]["layer1"], dict) and sorted(tree["visual"]["layer1"]) == [
        "0", "1"]
    _assert_same_tree(tree, tp)
    assert cfg == T_RN


def test_reference_pth_with_an_rn_tower_imports_as_in_ccmh(towers, tmp_path):
    from ccmh.clip.import_ref import import_reference_pth as j_import
    from ccmh_torch.clip.import_ref import import_reference_pth

    _, tp = towers
    rng = np.random.RandomState(8)
    sd = {f"clip.{k}": v for k, v in openai_rn_state_dict(tp).items()}
    for head in ("image_hash.fc", "text_hash.fc"):
        sd[f"{head}.weight"] = torch.from_numpy(rng.randn(16, 64).astype(np.float32))
        sd[f"{head}.bias"] = torch.from_numpy(rng.randn(16).astype(np.float32))
    pth = str(tmp_path / "model-3.pth")
    torch.save(sd, pth)
    params, cfg, aux = import_reference_pth(pth, "DSPH")
    jparams, jcfg, jaux = j_import(pth, "DSPH")
    _assert_same_tree(params, _np_tree(jparams))
    _same_cfg(cfg, jcfg)
    assert cfg == T_RN and aux == {} and not jaux


# ---------------------------------------------------------------- refusals

def test_exports_refuse_an_rn_tree_in_both_packages(towers):
    from ccmh.clip.export_ref import export_clip_state_dict as j_export
    from ccmh.clip.hf import to_hf_state_dict as j_to_hf
    from ccmh_torch.clip.export_ref import export_clip_state_dict
    from ccmh_torch.clip.hf import to_hf_state_dict

    jp, tp = towers
    with pytest.raises(ValueError, match="no ModifiedResNet tower"):
        j_to_hf(jp, J_RN)
    with pytest.raises(ValueError, match="no ModifiedResNet tower"):
        to_hf_state_dict(tp, T_RN)
    # the reference export is refused as NotImplementedError, in ccmh too
    with pytest.raises(NotImplementedError, match="RN-family"):
        j_export(jp)
    with pytest.raises(NotImplementedError, match="RN-family"):
        export_clip_state_dict(tp)


@pytest.mark.parametrize("name", ["MITH", "DPSIH"])
def test_token_methods_refuse_an_rn_tower_in_both_packages(towers, name):
    from ccmh.config import Config as JConfig
    from ccmh.train.methods import get_method as j_get_method
    from ccmh_torch.config import Config
    from ccmh_torch.train.methods import get_method

    jp, tp = towers
    images = _images(2, seed=7)
    jmethod, method = j_get_method(name), get_method(name)
    jcfg, cfg = JConfig(method=name, output_dim=16), Config(method=name, output_dim=16)
    heads, _, aux = jmethod.init(jax.random.PRNGKey(1), jcfg, J_RN)
    with pytest.raises(ValueError, match="ViT tower"):
        jmethod.encode({"clip": jp, **heads}, aux,
                       {"image": jnp.asarray(images), "text": jnp.zeros((2, 32), jnp.int32)},
                       jcfg, J_RN)
    theads, _, taux = method.init(torch.Generator(), cfg, T_RN)
    with pytest.raises(ValueError, match="ViT tower"):
        method.encode_image({"clip": tp, **theads}, taux, torch.from_numpy(images), cfg, T_RN)


# ---------------------------------------------------------------- the CLI

def test_cli_trains_from_an_rn_npz_and_serves(towers, tmp_path):
    """``--clip-path rn_tiny.npz`` trains an epoch on the CPU with full-state
    slots; ``--resume`` runs on from the slot; ``Retriever.from_pretrained``
    serves the trainer's codes from the ``.npz`` (with the tower's ``.pt`` as
    ``clip_path`` too); ``--test`` encodes at the tower's resolution; bf16
    towers and ``--remat`` (the text tower's) train."""
    from ccmh_torch.cli import main as torch_main
    from ccmh_torch.clip.convert import save_params_npz
    from ccmh_torch.config import Config
    from ccmh_torch.data.synthetic import write_synthetic_mat_dataset
    from ccmh_torch.retrieval import Retriever

    _, tp = towers
    tower = str(tmp_path / "rn_tiny.npz")
    save_params_npz(tower, tp)
    pt = str(tmp_path / "rn_tiny.pt")
    torch.save(openai_rn_state_dict(tp), pt)
    data = write_synthetic_mat_dataset(str(tmp_path / "data"), n=24, n_class=5,
                                       resolution=64, seed=3)
    common = ["--method", "DSPH", "--dataset", "synthetic", "--output-dim", "16",
              "--data-dir", data, "--batch-size", "6", "--query-num", "6", "--train-num", "12",
              "--eval-batch", "6", "--clip-path", tower, "--num-workers", "1",
              "--device", "cpu", "--resolution", "32"]
    trainer = torch_main(common + ["--epochs", "1", "--save-model", "--checkpoint-every", "1",
                                   "--save-dir", str(tmp_path / "out")])
    assert trainer.clip_cfg == T_RN and trainer.cfg.resolution == 64
    saved = os.path.join(trainer.cfg.save_dir, "model-0.npz")
    q_img, q_txt, _ = trainer.get_code(trainer.query_loader, len(trainer.query_data))
    batches = list(trainer.query_loader)
    images = np.concatenate([b["image"] for b in batches])
    texts = np.concatenate([b["text"] for b in batches])
    assert images.shape[1:] == (64, 64, 3)
    for clip_path in ("", pt):
        retriever = Retriever.from_pretrained(
            Config(method="DSPH", output_dim=16, max_words=trainer.cfg.max_words,
                   pretrained=saved, clip_path=clip_path), device="cpu")
        assert retriever.clip_cfg == T_RN
        np.testing.assert_array_equal(retriever.encode_images(images), q_img)
        np.testing.assert_array_equal(retriever.encode_texts(texts), q_txt)

    resumed = torch_main(common + ["--epochs", "2", "--checkpoint-every", "1", "--resume",
                                   "--save-dir", str(tmp_path / "out")])
    assert resumed.state.step == 4 and resumed.clip_cfg == T_RN
    tested = torch_main(common + ["--test", "--pretrained", saved,
                                  "--save-dir", str(tmp_path / "test")])
    assert tested.cfg.resolution == 64
    with open(os.path.join(tested.cfg.save_dir, "test.log")) as fh:
        assert "MAP(i->t)" in fh.read()

    other = torch_main(common + ["--epochs", "1", "--compute-dtype", "bfloat16", "--remat",
                                 "--display-step", "1", "--no-valid",
                                 "--save-dir", str(tmp_path / "bf16")])
    with open(os.path.join(other.cfg.save_dir, "metrics.jsonl")) as fh:
        losses = [r["loss"] for r in map(json.loads, fh) if r["event"] == "train"]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
