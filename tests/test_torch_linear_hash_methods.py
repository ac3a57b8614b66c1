"""The six LinearHash methods of the port (DSPH, DNpH, DDBH, DMsH_LN, DScPH,
DDWSH) against ccmh's on ``ClipConfig.tiny()``: the loss and every
gradient at a bridged initial state, then three train steps of the port's
eager step (BertAdam, plus SGD for DSPH's proxies) against ccmh's
``make_train_step(jit=False)`` (BertAdam, plus DSPH's optax proxy chain).

ccmh initialises; the port takes its parameters, ``extra`` and BertAdam
state as numpy.  Both sides get the same numpy batches and the same
dropout masks (``_dropout`` monkeypatched in both packages, masks drawn
from numpy by call order).  DDWSH's miner draws are ccmh's own: a wrapper
around ``jax.random.categorical`` records them, and the port's sampler
hands them back in the same order.  DMsH_LN trains on one-hot labels and
its label net starts from seeded numpy weights (unit normal, zero biases),
so that label codes disagree in sign and the multi-similarity loss mines
pairs: at ccmh's init on multi-hot labels every pair is positive and the
loss is exactly 0.

Tolerances: loss rtol 1e-5; gradients atol 1e-5 x the leaf's largest
entry (the towers' products sum in other orders); after each step the
parameters and ``extra`` atol 2e-6, rtol 1e-5 (as
tests/test_torch_train_step.py: BertAdam's first updates are nearly
sign-like, so a gradient that differs slightly moves its parameter by at
most lr x a small fraction; SGD moves the proxies by lr x the gradient).
"""

import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ccmh.models.heads as j_heads
from ccmh.clip.model import ClipConfig as JClipConfig, init_clip_params as j_init_clip
from ccmh.config import Config as JConfig
from ccmh.losses.dsph import codetable_threshold as j_codetable_threshold
from ccmh.train.methods import get_method as j_get_method
from ccmh.train.state import (
    init_state as j_init_state, make_main_optimizer as j_make_opt,
    make_train_step as j_make_step,
)
from ccmh_torch.bridge import params_from_jax
from ccmh_torch.clip.model import ClipConfig
from ccmh_torch.config import Config
from ccmh_torch.losses.dsph import codetable_threshold
from ccmh_torch.models import heads as t_heads
from ccmh_torch.train.methods import get_method
from ccmh_torch.train.optim import tree_leaves_with_path
from ccmh_torch.train.state import TrainState, make_main_optimizer, make_train_step, trainable

B, K, N_CLASS, MAX_WORDS, STEPS = 6, 16, 5, 12, 3
METHODS = ["DSPH", "DNpH", "DDBH", "DMsH_LN", "DScPH", "DDWSH"]


def _batches(seed, n, one_hot=False):
    rng = np.random.RandomState(seed)
    res = JClipConfig.tiny().image_resolution
    out = []
    for _ in range(n):
        ids = rng.randint(1, 49406, size=(B, MAX_WORDS)).astype(np.int32)
        ids[:, 0] = 49406
        eot = rng.randint(3, MAX_WORDS, size=B)
        ids[np.arange(B), eot] = 49407
        ids[np.arange(MAX_WORDS)[None, :] > eot[:, None]] = 0
        labels = (rng.rand(B, N_CLASS) < (0.0 if one_hot else 0.4)).astype(np.float32)
        labels[np.arange(B), rng.randint(0, N_CLASS, B)] = 1.0
        out.append({"image": rng.randn(B, res, res, 3).astype(np.float32),
                    "text": ids, "label": labels, "epoch": np.int32(1)})
    return out


def _same_masks(monkeypatch):
    """Both packages' dropout takes the i-th numpy mask on its i-th call."""
    calls = {"jax": 0, "torch": 0}

    def mask(side, shape, rate):
        i = calls[side]
        calls[side] += 1
        return np.random.RandomState(1000 + i).rand(*shape) < 1.0 - rate

    def j_dropout(x, rate, rng, train):
        if not train or rate <= 0.0 or rng is None:
            return x
        return jnp.where(jnp.asarray(mask("jax", x.shape, rate)), x / (1.0 - rate), 0.0)

    def t_dropout(x, rate, generator, train):
        if not train or rate <= 0.0 or generator is None:
            return x
        m = torch.from_numpy(mask("torch", tuple(x.shape), rate))
        return torch.where(m, x / (1.0 - rate), torch.zeros((), dtype=x.dtype))

    monkeypatch.setattr(j_heads, "_dropout", j_dropout)
    monkeypatch.setattr(t_heads, "_dropout", t_dropout)


def _ccmh_draws(monkeypatch):
    """Record ccmh's categorical draws; the port's DDWSH sampler replays
    them in order."""
    import ccmh_torch.train.methods.ddwsh as t_ddwsh

    draws = []
    orig = jax.random.categorical

    def record(key, logits, axis=-1, **kw):
        out = orig(key, logits, axis=axis, **kw)
        draws.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "categorical", record)
    monkeypatch.setattr(t_ddwsh, "gumbel_max",
                        lambda logits, generator: torch.from_numpy(draws.pop(0).astype(np.int64)))
    return draws


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _assert_trees_close(got, want, what, **tol):
    for path, leaf in tree_leaves_with_path(got):
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(_get(want, path)),
                                   err_msg=f"{what} {path}", **tol)


def _configs(name):
    kw = dict(method=name, output_dim=K, max_words=MAX_WORDS, epochs=2, nclass=N_CLASS,
              lr=1e-3, clip_lr=1e-4, warmup_proportion=0.2, weight_decay=0.2)
    return JConfig(**kw), Config(**kw)


@pytest.mark.parametrize("name", METHODS)
def test_linear_hash_method_matches_ccmh(name, monkeypatch):
    _same_masks(monkeypatch)
    draws = _ccmh_draws(monkeypatch)
    jcfg, cfg = _configs(name)
    jclip, clip = JClipConfig.tiny(), ClipConfig.tiny()
    steps_per_epoch = 4

    key = jax.random.PRNGKey(5)
    jmethod = j_get_method(name)
    heads, extra, aux = jmethod.init(jax.random.fold_in(key, 1), jcfg, jclip)
    jparams = {"clip": j_init_clip(key, jclip), **heads}
    if name == "DMsH_LN":
        rng = np.random.RandomState(1)
        jparams["label_net"] = jax.tree.map(
            lambda v: jnp.asarray(rng.randn(*v.shape).astype(np.float32) if v.ndim == 2
                                  else np.zeros(v.shape, np.float32)), heads["label_net"])
    tx = j_make_opt(jcfg, jparams, steps_per_epoch)
    extra_tx = jmethod.extra_tx(jcfg) if jmethod.extra_tx else None
    jstate = j_init_state(jax.random.fold_in(key, 2), jparams, extra, aux, tx, extra_tx)
    jloss_fn = jmethod.make_loss_fn(jcfg, jclip)
    jstep = j_make_step(jloss_fn, tx, extra_tx, jcfg, jclip, jit=False)

    method = get_method(name)
    assert (method.extra_optimizer is None) == (extra_tx is None)
    params = trainable(params_from_jax(jax.tree.map(np.asarray, jstate.params), device="cpu"))
    t_extra = (None if extra is None else
               trainable(params_from_jax(jax.tree.map(np.asarray, extra), device="cpu")))
    opt = make_main_optimizer(cfg, params, steps_per_epoch)
    opt.load_tree_state(jax.tree.map(np.asarray, jstate.opt_state.m),
                        jax.tree.map(np.asarray, jstate.opt_state.v),
                        int(jstate.opt_state.step))
    extra_opt = method.extra_optimizer(cfg, t_extra) if t_extra is not None else None
    loss_fn = method.make_loss_fn(cfg, clip)
    batches = _batches(seed=7, n=STEPS + 1, one_hot=name == "DMsH_LN")

    # the loss and every gradient at the initial state
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    (jl, (_, jm)), jg = jax.value_and_grad(
        lambda p, e: jloss_fn(p, e, jstate.aux, jb, jax.random.PRNGKey(0)),
        argnums=(0, 1), has_aux=True)(jstate.params, jstate.extra)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batches[0].items()}
    loss, (_, m) = loss_fn(params, t_extra, {}, tb, torch.Generator().manual_seed(0))
    assert float(jl) > 0 and math.isfinite(float(jl))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    assert set(m) == set(jm)
    for k in m:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    trees = [(params, jg[0], "grad")] + ([(t_extra, jg[1], "extra grad")] if extra else [])
    for tree, want_tree, what in trees:
        paths, leaves = zip(*tree_leaves_with_path(tree))
        grads = torch.autograd.grad(loss, leaves, retain_graph=True, allow_unused=True)
        for path, g in zip(paths, grads):
            w = np.asarray(_get(want_tree, path))
            g = np.zeros_like(w) if g is None else g.numpy()
            np.testing.assert_allclose(g, w, atol=1e-5 * max(1.0, np.abs(w).max()),
                                       err_msg=f"{what} {path}")
    assert not draws

    # three train steps
    state = TrainState(params, t_extra, {}, 0, torch.Generator().manual_seed(0))
    step = make_train_step(loss_fn, opt, extra_opt)
    for i, batch in enumerate(batches[1:]):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
        assert not draws
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5,
                                   err_msg=f"loss at step {i}")
        tol = dict(atol=2e-6, rtol=1e-5)
        _assert_trees_close(state.params, jax.tree.map(np.asarray, jstate.params),
                            f"step {i}", **tol)
        if extra is not None:
            _assert_trees_close(state.extra, jax.tree.map(np.asarray, jstate.extra),
                                f"step {i} extra", **tol)
    assert state.step == STEPS


@pytest.mark.parametrize("k", [16, 32, 64])
def test_codetable_threshold_matches_ccmh(k):
    """DSPH's threshold from the port's copy of the code table, for the
    class counts of the reference datasets and a few others."""
    for nclass in (2, 5, 10, 21, 24, 80, 255):
        assert codetable_threshold(k, nclass) == j_codetable_threshold(k, nclass)


def test_dsph_trainer_npz_restores_in_ccmh_with_its_extra(tmp_path):
    """A ``.npz`` the port's DSPH Trainer saves carries the trained proxies;
    ccmh's ``restore_state`` takes params and extra from it, bit for bit,
    and the port's Trainer restores them from ``--pretrained`` too."""
    from ccmh.data.synthetic import write_synthetic_mat_dataset
    from ccmh.train.trainer import restore_state
    from ccmh_torch.cli import main as torch_main

    data = write_synthetic_mat_dataset(str(tmp_path / "data"), n=24, n_class=N_CLASS,
                                       resolution=32, seed=2)
    common = ["--method", "DSPH", "--dataset", "synthetic", "--output-dim", str(K),
              "--data-dir", data, "--epochs", "1", "--batch-size", "6", "--query-num", "6",
              "--train-num", "12", "--eval-batch", "12", "--clip-arch", "tiny",
              "--save-model", "--num-workers", "1", "--device", "cpu"]
    trainer = torch_main(common + ["--save-dir", str(tmp_path / "out")])
    saved = os.path.join(trainer.cfg.save_dir, "model-0.npz")
    proxies = trainer.state.extra["proxies"].detach().numpy()
    assert trainer.extra_optimizer is not None and trainer.state.step == 2

    jcfg = JConfig(method="DSPH", output_dim=K, nclass=N_CLASS)
    jmethod = j_get_method("DSPH")
    tiny = JClipConfig.tiny()
    heads, extra, aux = jmethod.init(jax.random.PRNGKey(1), jcfg, tiny)
    jparams = {"clip": j_init_clip(jax.random.PRNGKey(0), tiny), **heads}
    tx = j_make_opt(jcfg, jparams, 2)
    jstate = j_init_state(jax.random.PRNGKey(2), jparams, extra, aux, tx,
                          jmethod.extra_tx(jcfg))
    state = restore_state(saved, jstate, "DSPH", tiny)
    np.testing.assert_array_equal(np.asarray(state.extra["proxies"]), proxies)
    for path, leaf in tree_leaves_with_path(trainer.state.params):
        np.testing.assert_array_equal(np.asarray(_get(state.params, path)),
                                      leaf.detach().numpy(), err_msg=str(path))

    again = torch_main(common + ["--save-dir", str(tmp_path / "again"), "--epochs", "0",
                                 "--pretrained", saved])
    np.testing.assert_array_equal(again.state.extra["proxies"].detach().numpy(), proxies)
