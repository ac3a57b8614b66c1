"""Three DCHMT train steps on ``ClipConfig.tiny()``: the port's eager step
against ccmh's jitted ``make_train_step``, from one bridged state.

ccmh initialises the parameters and BertAdam's state; the port takes them
as numpy (``bridge.params_from_jax`` and ``BertAdam.load_tree_state``).
Each step gets the same numpy batch.  After every step the loss and every
parameter are compared.

Tolerance: loss rtol 1e-5; parameters atol 2e-6, rtol 1e-5.  The two
frameworks sum the towers' products in other orders (gradients agree to
~1e-6 relative), and BertAdam's first updates are nearly sign-like
(m / sqrt(v) ~ ±0.7 for a gradient far above eps), so a gradient that
differs slightly moves its parameter by at most lr x a small fraction.
"""

import numpy as np
import pytest
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
from ccmh_torch.clip.model import ClipConfig, init_clip_params
from ccmh_torch.config import Config
from ccmh_torch.train.methods import get_method
from ccmh_torch.train.optim import tree_leaves_with_path
from ccmh_torch.train.state import (
    TrainState, make_main_optimizer, make_train_step, trainable,
)

B, K, N_CLASS, MAX_WORDS, STEPS = 6, 16, 5, 12, 3


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


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("similarity,loss_type", [("euclidean", "l2"), ("cosine", "l1")])
def test_three_dchmt_steps_match_ccmh(similarity, loss_type):
    kw = dict(method="DCHMT", output_dim=K, max_words=MAX_WORDS, epochs=2,
              lr=1e-3, clip_lr=1e-4, warmup_proportion=0.2, weight_decay=0.2)
    jcfg = JConfig(**kw)
    jcfg.dchmt.similarity_function, jcfg.dchmt.loss_type = similarity, loss_type
    cfg = Config(**kw)
    cfg.dchmt.similarity_function, cfg.dchmt.loss_type = similarity, loss_type
    steps_per_epoch = 4

    key = jax.random.PRNGKey(3)
    jclip = JClipConfig.tiny()
    jmethod = j_get_method("DCHMT")
    heads, extra, aux = jmethod.init(jax.random.fold_in(key, 1), jcfg, jclip)
    jparams = {"clip": j_init_clip(key, jclip), **heads}
    tx = j_make_opt(jcfg, jparams, steps_per_epoch)
    jstate = j_init_state(jax.random.fold_in(key, 2), jparams, extra, aux, tx, None)
    jstep = j_make_step(jmethod.make_loss_fn(jcfg, jclip), tx, None, jcfg, jclip, jit=True)

    before = jax.tree.map(np.array, jstate.params)   # the step donates its state
    params = trainable(params_from_jax(before, device="cpu"))
    opt = make_main_optimizer(cfg, params, steps_per_epoch)
    opt.load_tree_state(jax.tree.map(np.asarray, jstate.opt_state.m),
                        jax.tree.map(np.asarray, jstate.opt_state.v),
                        int(jstate.opt_state.step))
    method = get_method("DCHMT")
    state = TrainState(params, None, {}, 0, torch.Generator().manual_seed(0))
    step = make_train_step(method.make_loss_fn(cfg, ClipConfig.tiny()), opt)

    for i, batch in enumerate(_batches(seed=7)):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5,
                                   err_msg=f"loss at step {i}")
        want = jax.tree.map(np.asarray, jstate.params)
        for path, leaf in tree_leaves_with_path(state.params):
            np.testing.assert_allclose(leaf.detach().numpy(), _get(want, path),
                                       atol=2e-6, rtol=1e-5, err_msg=f"step {i} {path}")
    assert state.step == 3
    # the steps moved the weights (the first warmup step runs at lr 0)
    moved = [not np.array_equal(leaf.detach().numpy(), _get(before, path))
             for path, leaf in tree_leaves_with_path(state.params)]
    assert all(moved)


def test_linear_heads_train_with_dropout_from_the_step_generator():
    """hash_layer="linear": dropout draws from the state's generator (ccmh's
    jax.random bits cannot be reproduced, so this checks the wiring): the
    same seed gives the same step, another seed another loss."""
    cfg = Config(method="DCHMT", output_dim=K, max_words=MAX_WORDS, epochs=1)
    cfg.dchmt.hash_layer = "linear"
    method = get_method("DCHMT")
    losses = []
    for seed in (0, 0, 1):
        gen = torch.Generator().manual_seed(5)
        heads, _, _ = method.init(gen, cfg, ClipConfig.tiny())
        params = trainable({"clip": init_clip_params(gen, ClipConfig.tiny()), **heads})
        opt = make_main_optimizer(cfg, params, steps_per_epoch=2)
        state = TrainState(params, None, {}, 0, torch.Generator().manual_seed(seed))
        step = make_train_step(method.make_loss_fn(cfg, ClipConfig.tiny()), opt)
        batch = {k: torch.from_numpy(v) for k, v in _batches(seed=1)[0].items()}
        state, m = step(state, batch)
        assert torch.isfinite(m["loss"])
        losses.append(m["loss"].item())
    assert losses[0] == losses[1] and losses[0] != losses[2]
