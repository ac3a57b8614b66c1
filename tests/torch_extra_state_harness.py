"""Shared harness of the parity tests of the four methods with extra state
(tests/test_torch_{dnph,twdh,dpbe,dghdgh}.py): ccmh initialises on
``ClipConfig.tiny()`` at K=16, the port takes its parameters, ``extra`` and
``aux`` as numpy, and both run the same numpy batches with the same dropout
masks (tests/test_torch_linear_hash_methods.py's ``_same_masks``).  ccmh's
train step is its Trainer's: ``make_train_step(jit=False)`` with the
method's global clip chained before BertAdam, its ``extra_tx`` and its
``custom_step``.  Each test file replays ccmh's own random draws in the
port.

Tolerances (as tests/test_torch_linear_hash_methods.py): loss and metrics
rtol 1e-5; gradients atol 1e-5 x the leaf's largest entry; after each step
params, ``extra`` and floating ``aux`` leaves atol 2e-6 / rtol 1e-5, integer
``aux`` leaves exact; ±1 codes exact except where the pre-sign value is
within 1e-6 of 0.
"""

import math
import types

import numpy as np
import optax
import torch

import jax
import jax.numpy as jnp

from ccmh.clip.model import ClipConfig as JClipConfig, init_clip_params as j_init_clip
from ccmh.config import Config as JConfig
from ccmh.train.methods import get_method as j_get_method
from ccmh.train.state import (
    init_state as j_init_state, make_main_optimizer as j_make_opt,
    make_train_step as j_make_step,
)
from ccmh_torch.bridge import params_from_jax
from ccmh_torch.clip.model import ClipConfig
from ccmh_torch.config import Config
from ccmh_torch.train.methods import get_method
from ccmh_torch.train.optim import tree_leaves_with_path
from ccmh_torch.train.state import TrainState, make_main_optimizer, make_train_step, trainable
from tests.test_torch_linear_hash_methods import _get, _same_masks

B, K, N_CLASS, MAX_WORDS = 6, 16, 5, 12
STEPS_PER_EPOCH = 4
CODE_MARGIN = 1e-6
TOL = dict(atol=2e-6, rtol=1e-5)

same_masks = _same_masks


def batches(seed, n, b=B, n_class=N_CLASS, epoch=1, res=None):
    """Seeded numpy batches: images at ``res`` (the tiny tower's by
    default), token ids with an EOT, and multi-hot labels with at least
    one class per row."""
    rng = np.random.RandomState(seed)
    res = res or JClipConfig.tiny().image_resolution
    out = []
    for _ in range(n):
        ids = rng.randint(1, 49406, size=(b, MAX_WORDS)).astype(np.int32)
        ids[:, 0] = 49406
        eot = rng.randint(3, MAX_WORDS, size=b)
        ids[np.arange(b), eot] = 49407
        ids[np.arange(MAX_WORDS)[None, :] > eot[:, None]] = 0
        labels = (rng.rand(b, n_class) < 0.4).astype(np.float32)
        labels[np.arange(b), rng.randint(0, n_class, b)] = 1.0
        out.append({"image": rng.randn(b, res, res, 3).astype(np.float32),
                    "text": ids, "label": labels, "epoch": np.int32(epoch)})
    return out


def configs(name, **kw):
    base = dict(method=name, output_dim=K, max_words=MAX_WORDS, epochs=2, nclass=N_CLASS,
                lr=1e-3, clip_lr=1e-4, warmup_proportion=0.2, weight_decay=0.2)
    sets = kw.pop("sets", {})
    base.update(kw)
    jcfg, cfg = JConfig(**base), Config(**base)
    for c in (jcfg, cfg):
        for key, value in sets.items():
            section, field = key.split(".")
            setattr(getattr(c, section), field, value)
    return jcfg, cfg


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def build(name, jcfg, cfg, seed=5, jclip=None, clip=None, init_clip=j_init_clip):
    """Both packages' train state at ccmh's init: ccmh's step, state and
    loss function beside the port's.  The towers are ``ClipConfig.tiny()``
    unless ``jclip`` / ``clip`` name others; ``init_clip(key, jclip)``
    draws ccmh's CLIP tree."""
    jclip, clip = jclip or JClipConfig.tiny(), clip or ClipConfig.tiny()
    key = jax.random.PRNGKey(seed)
    jmethod = j_get_method(name)
    heads, extra, aux = jmethod.init(jax.random.fold_in(key, 1), jcfg, jclip)
    jparams = {"clip": init_clip(key, jclip), **heads}
    tx = j_make_opt(jcfg, jparams, STEPS_PER_EPOCH)
    if jmethod.grad_clip > 0:
        tx = optax.chain(optax.clip_by_global_norm(jmethod.grad_clip), tx)
    extra_tx = jmethod.extra_tx(jcfg) if jmethod.extra_tx else None
    jstate = j_init_state(jax.random.fold_in(key, 2), jparams, extra, aux, tx, extra_tx)
    jloss_fn = jmethod.make_loss_fn(jcfg, jclip)
    jcustom = jmethod.custom_step(jcfg, jclip, tx, extra_tx) if jmethod.custom_step else None
    jstep = j_make_step(jloss_fn, tx, extra_tx, jcfg, jclip, jit=False, custom_step=jcustom)

    method = get_method(name)
    params = trainable(params_from_jax(np_tree(jstate.params), device="cpu"))
    t_extra = None if extra is None else params_from_jax(np_tree(extra), device="cpu")
    t_aux = params_from_jax(np_tree(aux), device="cpu")
    opt = make_main_optimizer(cfg, params, STEPS_PER_EPOCH)
    extra_opt = (method.extra_optimizer(cfg, t_extra)
                 if t_extra is not None and method.extra_optimizer else None)
    if extra_opt is not None:
        trainable(t_extra)
    loss_fn = method.make_loss_fn(cfg, clip)
    custom = method.custom_step(cfg, clip, opt, extra_opt) if method.custom_step else None
    step = make_train_step(loss_fn, opt, extra_opt, grad_clip=method.grad_clip,
                           custom_step=custom)
    state = TrainState(params, t_extra, t_aux, 0, torch.Generator().manual_seed(0))
    return types.SimpleNamespace(
        jmethod=jmethod, jcfg=jcfg, jclip=jclip, jstate=jstate, jloss_fn=jloss_fn,
        jstep=jstep, method=method, cfg=cfg, clip=clip, state=state, loss_fn=loss_fn,
        step=step, extra_opt=extra_opt)


def assert_trees_close(got, want, what, atol_of=None):
    """``atol_of``: {path: atol} for leaves held to a looser bound, each
    with its reason where the caller passes it."""
    for path, leaf in tree_leaves_with_path(got):
        w = np.asarray(_get(want, path))
        g = leaf.detach().numpy()
        if np.issubdtype(w.dtype, np.floating):
            tol = {**TOL, "atol": (atol_of or {}).get(path, TOL["atol"])}
            np.testing.assert_allclose(g, w, err_msg=f"{what} {path}", **tol)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {path}")


def check_loss_and_grads(h, batch, extra_grads=True, grad_tol=1e-5):
    """The loss, the metrics and every gradient of params (and ``extra``) at
    the initial state, with ``jax.random.PRNGKey(0)`` as ccmh's step key;
    gradients within ``grad_tol`` x the leaf's largest entry."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jextra = h.jstate.extra
    (jl, (_, jm)), jg = jax.value_and_grad(
        lambda p, e: h.jloss_fn(p, e, h.jstate.aux, jb, jax.random.PRNGKey(0)),
        argnums=(0, 1), has_aux=True)(h.jstate.params, jextra)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    extra = h.state.extra
    if extra is not None and extra_grads:
        trainable(extra)
    loss, (_, m) = h.loss_fn(h.state.params, extra, h.state.aux, tb,
                             torch.Generator().manual_seed(0))
    assert math.isfinite(float(jl))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    assert set(m) == set(jm)
    for k in m:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    trees = [(h.state.params, jg[0], "grad")]
    if extra is not None and extra_grads:
        trees.append((extra, jg[1], "extra grad"))
    for tree, want_tree, what in trees:
        paths, leaves = zip(*tree_leaves_with_path(tree))
        grads = torch.autograd.grad(loss, leaves, retain_graph=True, allow_unused=True)
        for path, g in zip(paths, grads):
            w = np.asarray(_get(want_tree, path))
            g = np.zeros_like(w) if g is None else g.numpy()
            np.testing.assert_allclose(g, w, atol=grad_tol * max(1.0, np.abs(w).max()),
                                       err_msg=f"{what} {path}")
    if extra is not None and extra_grads and h.extra_opt is None:
        for _, leaf in tree_leaves_with_path(extra):
            leaf.requires_grad_(False)


def run_steps(h, steps, before_step=None, atol_of=None):
    """The train steps of both packages, compared after each: the loss and
    the metrics, params, ``extra`` and ``aux``; ``before_step(h)`` runs
    before each (``atol_of`` as in :func:`assert_trees_close`, for params)."""
    for i, batch in enumerate(steps):
        if before_step is not None:
            before_step(h)
        h.jstate, jm = h.jstep(h.jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        h.state, m = h.step(h.state, {k: torch.from_numpy(np.asarray(v))
                                      for k, v in batch.items()})
        assert set(m) == set(jm)
        for k in m:
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{k} at step {i}")
        assert_trees_close(h.state.params, np_tree(h.jstate.params), f"step {i}", atol_of)
        if h.state.extra is not None:
            assert_trees_close(h.state.extra, np_tree(h.jstate.extra), f"step {i} extra")
        assert_trees_close(h.state.aux, np_tree(h.jstate.aux), f"step {i} aux")
    assert h.state.step == len(steps)


def assert_codes_match(got, want, margin, what):
    """±1 codes equal except where ``margin`` (the pre-sign value's
    distance from a flip) is within CODE_MARGIN of 0."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.int8, (got.shape, want.shape, got.dtype)
    bad = got != want
    assert np.all(np.asarray(margin)[bad] < CODE_MARGIN), f"{what}: {int(bad.sum())} bits differ"
