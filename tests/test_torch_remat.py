"""Long-sequence towers and activation checkpointing (``remat``) against
ccmh.

* ``ClipConfig.vit_l14`` is ccmh's preset, field for field.
* A narrow tower with ViT-L/14's token count (64x64 images in 4x4 patches:
  257 tokens; width 128, 2 layers): the pooled embeddings and the gradient
  of a fixed projection of them, through the attention's long-sequence
  path on both sides (the port's plain versions, ccmh's Pallas kernels in
  interpret mode).  Tolerance: 1e-4 of each tensor's largest magnitude
  (the packages sum the products in other orders).
* ``remat`` off, ``"full"`` and ``"dots"``: the port's gradients are the
  same bits (the recompute repeats the forward's operations on the same
  inputs), and they agree with ccmh's under the same policy (1e-4 as
  above).  ``need_last_attn`` (MITH) leaves the last block unchecked.
* Two DCHMT train steps with ``cfg.remat`` under each policy, ccmh's jitted
  step against the port's eager one from one bridged state (loss rtol
  1e-5; parameters atol 2e-6, rtol 1e-5, as tests/test_torch_train_step.py
  states).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccmh.clip import model as jm
from ccmh.clip.model import ClipConfig as JClipConfig, init_clip_params as j_init_clip
from ccmh.config import Config as JConfig
from ccmh.train.methods import get_method as j_get_method
from ccmh.train.state import (
    init_state as j_init_state, make_main_optimizer as j_make_opt,
    make_train_step as j_make_step,
)
from ccmh_torch.bridge import params_from_jax
from ccmh_torch.clip import model as tm
from ccmh_torch.config import Config
from ccmh_torch.train.methods import get_method
from ccmh_torch.train.optim import tree_leaves_with_path
from ccmh_torch.train.state import TrainState, make_main_optimizer, make_train_step, trainable

# 64 / 4 = 16 patches a side: 257 tokens, ViT-L/14's count at 224 px
LONG = jm.ClipConfig(embed_dim=64, image_resolution=64, vision_layers=2, vision_width=128,
                     vision_patch_size=4, context_length=77, vocab_size=49408,
                     transformer_width=128, transformer_heads=2, transformer_layers=2)
POLICIES = [False, "full", "dots"]


def _port_cfg(cfg):
    return tm.ClipConfig(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(tm.ClipConfig)})


@pytest.mark.parametrize("resolution", [224, 336])
def test_vit_l14_preset_is_ccmhs(resolution):
    want = jm.ClipConfig.vit_l14(resolution)
    got = tm.ClipConfig.vit_l14(resolution)
    assert dataclasses.asdict(got) == {f.name: getattr(want, f.name)
                                       for f in dataclasses.fields(tm.ClipConfig)}
    assert got.n_patches + 1 == {224: 257, 336: 577}[resolution]
    assert got.vision_heads == 16


@pytest.fixture(scope="module")
def long_tower():
    """ccmh's params of the 257-token tower, images, a projection of the
    pooled embeddings, and ccmh's pooled output and gradient under each
    remat policy."""
    params = jax.tree.map(np.asarray, j_init_clip(jax.random.PRNGKey(5), LONG))
    rng = np.random.RandomState(3)
    images = rng.randn(1, 64, 64, 3).astype(np.float32)
    proj = rng.randn(1, LONG.embed_dim).astype(np.float32)

    def loss(visual, remat):
        pooled = jm.vision_forward(visual, LONG, jnp.asarray(images), remat=remat).pooled
        return jnp.sum(pooled * proj), pooled

    want = {}
    for remat in POLICIES:
        (_, pooled), grads = jax.value_and_grad(loss, has_aux=True)(
            jax.tree.map(jnp.asarray, params["visual"]), remat)
        want[remat] = (np.asarray(pooled), jax.tree.map(np.asarray, grads))
    return params, images, proj, want


def _port_grads(params, images, proj, remat, features="pooled"):
    visual = trainable(params_from_jax(params["visual"], device="cpu"))
    out = tm.vision_forward(visual, _port_cfg(LONG), torch.from_numpy(images),
                            features=features, remat=remat)
    loss = (out.pooled * torch.from_numpy(proj)).sum()
    if features == "mith":
        loss = loss + out.cls_attn.sum()
    loss.backward()
    return out.pooled.detach(), dict(tree_leaves_with_path(visual))


def _close(got, want, rel=1e-4):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("remat", POLICIES, ids=["off", "full", "dots"])
def test_257_token_tower_matches_ccmh(long_tower, remat):
    params, images, proj, want = long_tower
    pooled, leaves = _port_grads(params, images, proj, remat)
    want_pooled, want_grads = want[remat]
    _close(pooled.numpy(), want_pooled)
    for path, leaf in leaves.items():
        _close(leaf.grad.numpy(), _get(want_grads, path))


@pytest.mark.parametrize("features", ["pooled", "mith"])
def test_remat_policies_give_the_same_bits(long_tower, features):
    params, images, proj, _ = long_tower
    runs = [_port_grads(params, images, proj, remat, features) for remat in POLICIES]
    (pooled0, leaves0), rest = runs[0], runs[1:]
    for pooled, leaves in rest:
        assert torch.equal(pooled, pooled0)
        for path, leaf in leaves.items():
            assert torch.equal(leaf.grad, leaves0[path].grad), path


def test_remat_checkpoints_every_block_but_mith_last(monkeypatch):
    calls = []
    real = tm._remat_block
    monkeypatch.setattr(tm, "_remat_block",
                        lambda *a: calls.append(a[-1]) or real(*a))
    cfg = tm.ClipConfig.tiny()
    params = tm.init_clip_params(torch.Generator().manual_seed(0), cfg)
    images = torch.zeros((1, 32, 32, 3))
    tm.vision_forward(params["visual"], cfg, images, remat="dots")
    assert calls == ["dots"] * cfg.vision_layers
    calls.clear()
    tm.vision_forward(params["visual"], cfg, images, remat=True, features="mith")
    assert calls == [True] * (cfg.vision_layers - 1)


# ---- the train step with cfg.remat, against ccmh's

B, K, N_CLASS, MAX_WORDS, STEPS = 4, 16, 5, 12, 2


def _batches(seed):
    rng = np.random.RandomState(seed)
    res = JClipConfig.tiny().image_resolution
    out = []
    for _ in range(STEPS):
        ids = rng.randint(1, 49406, size=(B, MAX_WORDS)).astype(np.int32)
        ids[:, 0] = 49406
        eot = rng.randint(3, MAX_WORDS, size=B)
        ids[np.arange(B), eot] = 49407
        ids[np.arange(MAX_WORDS)[None, :] > eot[:, None]] = 0
        labels = (rng.rand(B, N_CLASS) < 0.4).astype(np.float32)
        labels[np.arange(B), rng.randint(0, N_CLASS, B)] = 1.0
        out.append({"image": rng.randn(B, res, res, 3).astype(np.float32),
                    "text": ids, "label": labels})
    return out


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_two_remat_steps_match_ccmh(policy):
    kw = dict(method="DCHMT", output_dim=K, max_words=MAX_WORDS, epochs=2, lr=1e-3,
              clip_lr=1e-4, warmup_proportion=0.2, weight_decay=0.2, remat=True,
              remat_policy=policy)
    jcfg, cfg = JConfig(**kw), Config(**kw)
    steps_per_epoch = 4
    key = jax.random.PRNGKey(4)
    jclip = JClipConfig.tiny()
    jmethod = j_get_method("DCHMT")
    heads, extra, aux = jmethod.init(jax.random.fold_in(key, 1), jcfg, jclip)
    jparams = {"clip": j_init_clip(key, jclip), **heads}
    tx = j_make_opt(jcfg, jparams, steps_per_epoch)
    jstate = j_init_state(jax.random.fold_in(key, 2), jparams, extra, aux, tx, None)
    jstep = j_make_step(jmethod.make_loss_fn(jcfg, jclip), tx, None, jcfg, jclip, jit=True)

    params = trainable(params_from_jax(jax.tree.map(np.array, jstate.params), device="cpu"))
    opt = make_main_optimizer(cfg, params, steps_per_epoch)
    opt.load_tree_state(jax.tree.map(np.asarray, jstate.opt_state.m),
                        jax.tree.map(np.asarray, jstate.opt_state.v),
                        int(jstate.opt_state.step))
    method = get_method("DCHMT")
    state = TrainState(params, None, {}, 0, torch.Generator().manual_seed(0))
    step = make_train_step(method.make_loss_fn(cfg, tm.ClipConfig.tiny()), opt)
    for i, batch in enumerate(_batches(seed=9)):
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(m["loss"].item(), float(jm_["loss"]), rtol=1e-5,
                                   err_msg=f"loss at step {i}")
        want = jax.tree.map(np.asarray, jstate.params)
        for path, leaf in tree_leaves_with_path(state.params):
            np.testing.assert_allclose(leaf.detach().numpy(), _get(want, path),
                                       atol=2e-6, rtol=1e-5, err_msg=f"step {i} {path}")
