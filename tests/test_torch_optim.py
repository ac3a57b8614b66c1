"""ccmh_torch BertAdam against ccmh's ``bert_adam``, step for step.

The same numpy parameters and gradient sequence go through both packages.
Tolerance: rtol 1e-6, atol 1e-7 on the parameters after every step (both
compute each update in float32 with the same constants; sums of squares
in the clipping norms are taken in another order, ~1 ulp).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccmh.train.optim import bert_adam, block_stacked_tree, lr_tree_for
from ccmh_torch.bridge import params_from_jax
from ccmh_torch.train.optim import SCHEDULES, BertAdam, bert_adam_for

RTOL, ATOL = 1e-6, 1e-7


def _tree(rng):
    return {
        "clip": {
            # a stacked leaf of 3 layers: layer 1's gradient is scaled far
            # over the clip norm, layers 0 and 2 stay under it
            "blocks": {"w": rng.randn(3, 4, 5).astype(np.float32)},
            "proj": rng.randn(6, 2).astype(np.float32),
            # the loss never reaches it: no gradient in torch, an exact
            # zero in ccmh; weight decay must still move it
            "logit_scale": np.asarray(2.6592, np.float32),
        },
        "head": {"w": rng.randn(5, 3).astype(np.float32),
                 "b": rng.randn(3).astype(np.float32)},
    }


def _grads(rng, params, steps):
    seq = []
    for _ in range(steps):
        g = jax.tree.map(lambda p: np.asarray(rng.randn(*p.shape), np.float32), params)
        g["clip"]["blocks"]["w"][1] *= 40.0
        g["clip"]["logit_scale"] = np.zeros((), np.float32)
        seq.append(g)
    return seq


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_bert_adam_matches_ccmh_step_for_step(schedule):
    rng = np.random.RandomState(0)
    params_np = _tree(rng)
    grads_seq = _grads(rng, params_np, steps=6)
    kw = dict(warmup=0.3, t_total=8, schedule=schedule, b1=0.9, b2=0.98, eps=1e-6,
              weight_decay=0.2, max_grad_norm=1.0)

    jparams = jax.tree.map(jnp.asarray, params_np)
    tx = bert_adam(lr_tree_for(jparams, 1e-3, {"clip": 1e-4}),
                   block_stacked=block_stacked_tree(jparams), **kw)
    jstate = tx.init(jparams)

    tparams = params_from_jax(params_np, device="cpu")
    opt = bert_adam_for(tparams, 1e-3, {"clip": 1e-4}, **kw)
    for step, grads in enumerate(grads_seq):
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        for group in opt.param_groups:
            for p, path in zip(group["params"], group["paths"]):
                if path[-1] == "logit_scale":
                    p.grad = None
                else:
                    g = grads
                    for k in path:
                        g = g[k]
                    p.grad = torch.from_numpy(g.copy())
        opt.step()
        want = jax.tree.map(np.asarray, jparams)
        for group in opt.param_groups:
            for p, path in zip(group["params"], group["paths"]):
                w = want
                for k in path:
                    w = w[k]
                np.testing.assert_allclose(p.numpy(), w, rtol=RTOL, atol=ATOL,
                                           err_msg=f"step {step} {path}")
        if step == 0:
            # the first warmup step runs at lr 0: nothing moves
            np.testing.assert_array_equal(tparams["head"]["w"].detach().numpy(),
                                          params_np["head"]["w"])
    # the leaf without a gradient decayed
    assert tparams["clip"]["logit_scale"].item() < params_np["clip"]["logit_scale"]


def test_per_layer_clip_touches_only_the_large_layer():
    """One optimizer step at lr 1 with no decay and zero moments: the
    update of a stacked leaf is m / (sqrt(v) + eps) with m = 0.1 g',
    v = 0.02 g'^2, so its size is fixed and the clip shows in the ratio of
    m to the raw gradient: layer 1 (norm 40x over) is scaled, 0 and 2 not."""
    rng = np.random.RandomState(1)
    w = torch.from_numpy(rng.randn(3, 4, 5).astype(np.float32))
    g = torch.from_numpy(rng.randn(3, 4, 5).astype(np.float32) * 0.01)
    g[1] *= 40_000.0
    p = w.clone()
    opt = BertAdam([{"params": [p], "block_stacked": True, "paths": [("w",)]}], 1.0,
                   max_grad_norm=1.0, weight_decay=0.0)
    p.grad = g.clone()
    opt.step()
    m = opt.state[p]["m"]
    ratio = (m / (0.1 * g)).flatten(1)
    assert torch.allclose(ratio[0], torch.ones(20)) and torch.allclose(ratio[2], torch.ones(20))
    norm1 = torch.linalg.vector_norm(g[1]).item()
    assert torch.allclose(ratio[1], torch.full((20,), 1.0 / (norm1 + 1e-6)), rtol=1e-5)


def test_first_warmup_step_has_lr_zero_and_state_loads_from_ccmh():
    rng = np.random.RandomState(2)
    params_np = {"a": rng.randn(4).astype(np.float32)}
    tparams = params_from_jax(params_np, device="cpu")
    opt = bert_adam_for(tparams, 1e-3, warmup=0.1, t_total=10, weight_decay=0.2)
    # progress = step / t_total before the increment: 0 at the first step,
    # then warmup_cosine's ramp and cosine
    assert opt.lr_scale(0) == 0.0
    assert opt.lr_scale(1) == np.float32(0.5) * (1 + np.cos(np.float32(np.pi) * np.float32(0.1)))
    # ccmh's state after two steps, loaded into a fresh port optimizer
    jparams = jax.tree.map(jnp.asarray, params_np)
    tx = bert_adam(1e-3, warmup=0.1, t_total=10, weight_decay=0.2)
    st = tx.init(jparams)
    for _ in range(2):
        u, st = tx.update({"a": jnp.asarray(rng.randn(4).astype(np.float32))}, st, jparams)
        jparams = jax.tree.map(lambda p, d: p + d, jparams, u)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    opt = bert_adam_for(tparams, 1e-3, warmup=0.1, t_total=10, weight_decay=0.2)
    opt.load_tree_state(jax.tree.map(np.asarray, st.m), jax.tree.map(np.asarray, st.v),
                        int(st.step))
    g = rng.randn(4).astype(np.float32)
    u, st = tx.update({"a": jnp.asarray(g)}, st, jparams)
    tparams["a"].grad = torch.from_numpy(g)
    opt.step()
    np.testing.assert_allclose(tparams["a"].numpy(), np.asarray(jparams["a"] + u["a"]),
                               rtol=RTOL, atol=ATOL)
    assert opt.param_groups[0]["step"] == int(st.step) == 3
