"""DHaPH in the port against ccmh: the Poincaré-ball ops of
``ccmh_torch/losses/pmath.py`` (values, and gradients against ``jax.vjp``
of ``ccmh``'s ``custom_vjp`` s), the self-paced MS loss, the HPmodel, the
hyperbolic proxy loss with ``ccmh``'s own random draws handed to the port,
and the whole method: loss, gradients and 3 train steps with AdamW on the
HPmodel and the LCAs.

``ccmh`` draws the triplets with ``jax.random.categorical`` and the
Gumbel noise with ``jax.random.gumbel``; wrappers record them, and a
:class:`Draws` of the port hands them back in the same order.  The
similarities are tie-free (random inputs), so both packages' top-k pick the
same mutual neighbours.  Small proxy counts and top-k keep the [T, C]
triplet tensors small.

Tolerances as tests/test_torch_linear_hash_methods.py: values rtol 1e-5,
gradients atol 1e-5 x the leaf's largest entry, parameters after each step
atol 2e-6, rtol 1e-5.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccmh.config import Config as JConfig, DHaPHConfig as JDHaPHConfig
from ccmh.losses import dhaph as j_dhaph
from ccmh.losses import pmath as j_pmath
from ccmh_torch.config import Config, DHaPHConfig
from ccmh_torch.losses import dhaph as t_dhaph
from ccmh_torch.losses import pmath as t_pmath

C = 0.1
rng = np.random.RandomState(0)
X = (rng.randn(12, 16) * 0.4).astype(np.float32)
Y = (rng.randn(9, 16) * 0.4).astype(np.float32)
# the method test's batch: JAX compiles each op once per shape, so the
# loss tests share its shapes
X6 = X[:6]


def _vjp_pair(jfn, tfn, *inputs, ct_seed=1, jit=False):
    """(ccmh value, port value, ccmh input gradients, port input gradients)
    of ``fn(*inputs)`` under one random cotangent; ``jit`` compiles ccmh's
    side as one program instead of op by op."""
    jin = [jnp.asarray(x) for x in inputs]
    shape = jax.eval_shape(jfn, *jin).shape
    ct = np.asarray(np.random.RandomState(ct_seed).randn(*shape), np.float32)

    def value_and_vjp(*xs):
        out, vjp = jax.vjp(jfn, *xs)
        return out, vjp(jnp.asarray(ct))

    jout, jgrads = (jax.jit(value_and_vjp) if jit else value_and_vjp)(*jin)
    jgrads = [np.asarray(g) for g in jgrads]
    tin = [torch.tensor(x, requires_grad=True) for x in inputs]
    tout = tfn(*tin)
    tgrads = torch.autograd.grad(tout, tin, torch.from_numpy(ct))
    return np.asarray(jout), tout.detach().numpy(), jgrads, [g.numpy() for g in tgrads]


def _assert_vjp(jfn, tfn, *inputs, rtol=1e-5):
    jv, tv, jg, tg = _vjp_pair(jfn, tfn, *inputs)
    np.testing.assert_allclose(tv, jv, rtol=rtol, atol=1e-6)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, atol=1e-5 * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("op", ["tanh_clamp", "project", "expmap0", "mobius", "dist"])
def test_poincare_ops_match_ccmh(op):
    big = X * 40.0        # past tanh's clamp and the ball's edge
    cases = {
        "tanh_clamp": (j_pmath.tanh_clamp, t_pmath.tanh_clamp, (big,)),
        "project": (lambda x: j_pmath.project(x, C), lambda x: t_pmath.project(x, C), (X * 8,)),
        "expmap0": (lambda x: j_pmath.expmap0(x, C), lambda x: t_pmath.expmap0(x, C), (X,)),
        "mobius": (lambda x, y: j_pmath.mobius_addition_batch(x, y, C),
                   lambda x, y: t_pmath.mobius_addition_batch(x, y, C), (X, Y)),
        "dist": (lambda x, y: j_pmath.dist_matrix(j_pmath.expmap0(x, C), j_pmath.expmap0(y, C), C),
                 lambda x, y: t_pmath.dist_matrix(t_pmath.expmap0(x, C), t_pmath.expmap0(y, C), C),
                 (X, Y)),
    }
    jfn, tfn, inputs = cases[op]
    _assert_vjp(jfn, tfn, *inputs, rtol=1e-4 if op == "dist" else 1e-5)


def test_artanh_matches_ccmh_at_and_past_the_clamp():
    edge = np.float32(1 - 1e-5)
    x = np.array([0.0, 0.3, -0.7, 0.99, edge, -edge, 1.0, -1.0, 1.5, -3.0], np.float32)
    jv, tv, (jg,), (tg,) = _vjp_pair(j_pmath.artanh, t_pmath.artanh, x)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-5)
    # the gradient is taken at the clamped input: finite at and past it
    assert np.all(np.isfinite(tg))


def test_riemannian_gradient_matches_ccmh():
    x = X * 2.0
    jv, tv, (jg,), (tg,) = _vjp_pair(j_pmath.make_riemannian_gradient(C),
                                     lambda t: t_pmath.riemannian_gradient(t, C), x)
    np.testing.assert_array_equal(tv, x)          # the forward is the identity
    np.testing.assert_array_equal(jv, x)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-5 * np.abs(jg).max())


def test_safe_norm_has_a_zero_gradient_at_the_origin():
    x = np.concatenate([np.zeros((2, 16), np.float32), X[:3]])
    jv, tv, (jg,), (tg,) = _vjp_pair(j_pmath._safe_norm, t_pmath._safe_norm, x)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-7)
    assert np.all(tg[:2] == 0.0)


def _labels(n, seed=3, n_class=5):
    r = np.random.RandomState(seed)
    labels = (r.rand(n, n_class) < 0.3).astype(np.float32)
    labels[np.arange(n), r.randint(0, n_class, n)] = 1.0
    return labels


@pytest.mark.parametrize("epoch", [1, 2, 3, 7])
def test_ms_loss_matches_ccmh(epoch):
    labels = _labels(6)
    labels[0] = 0.0                                     # a row without a positive
    kw = dict(temperature=0.3, total_epoch=9)
    _assert_vjp(lambda a, b: j_dhaph.ms_loss(a, b, jnp.asarray(labels), jnp.int32(epoch), **kw),
                lambda a, b: t_dhaph.ms_loss(a, b, torch.from_numpy(labels),
                                             torch.tensor(epoch, dtype=torch.int32), **kw),
                X6, X6[::-1].copy())


def test_hp_model_matches_ccmh():
    jcfg, cfg = JDHaPHConfig(), DHaPHConfig()
    p = j_dhaph.init_hp_model(jax.random.PRNGKey(1), 16, 16)
    w, b = np.asarray(p["linear"]["w"]), np.asarray(p["linear"]["b"])
    _assert_vjp(lambda x, w_, b_: j_dhaph.hp_model({"linear": {"w": w_, "b": b_}}, x, jcfg),
                lambda x, w_, b_: t_dhaph.hp_model({"linear": {"w": w_, "b": b_}}, x, cfg),
                X * 3.0, w, b)


class _Replay(t_dhaph.Draws):
    """The port's draws replaced by ccmh's, in call order."""

    def __init__(self, cat, gum):
        super().__init__(None)
        self.cat, self.gum = cat, gum

    def categorical(self, logits, n):
        out = self.cat.pop(0)
        assert out.shape == (logits.shape[0], n)
        return torch.from_numpy(out.astype(np.int64))

    def gumbel(self, like):
        out = self.gum.pop(0)
        assert out.shape == tuple(like.shape)
        return torch.from_numpy(out.copy())


def _record_ccmh_draws(monkeypatch):
    """ccmh's categorical and Gumbel draws, appended in program order as
    they run (an ordered host callback, so also under ``jit``)."""
    cat, gum = [], []
    orig_cat, orig_gum = jax.random.categorical, jax.random.gumbel

    def recorder(orig, store):
        def record(*a, **kw):
            out = orig(*a, **kw)
            jax.debug.callback(lambda v: store.append(np.asarray(v)), out, ordered=True)
            return out
        return record

    record_cat, record_gum = recorder(orig_cat, cat), recorder(orig_gum, gum)

    monkeypatch.setattr(jax.random, "categorical", record_cat)
    monkeypatch.setattr(jax.random, "gumbel", record_gum)
    return cat, gum


SMALL = dict(n_proxies=24, topk=4)


def test_hp_loss_with_ccmh_draws_matches_ccmh(monkeypatch):
    cat, gum = _record_ccmh_draws(monkeypatch)
    jcfg, cfg = JDHaPHConfig(**SMALL), DHaPHConfig(**SMALL)
    labels = _labels(6)
    lcas = np.asarray(j_dhaph.init_lcas(jax.random.PRNGKey(2), jcfg, 16))
    z = np.asarray(j_dhaph.to_poincare(jnp.asarray(X6), jcfg.curvature, jcfg.clip_r))
    t = np.asarray(j_dhaph.to_poincare(jnp.asarray(X6[::-1] + 0.1 * X6), jcfg.curvature,
                                       jcfg.clip_r))
    jv, tv, jg, tg = _vjp_pair(
        lambda a, b, l: j_dhaph.hp_loss(jax.random.PRNGKey(3), a, b, jnp.asarray(labels), l, jcfg),
        lambda a, b, l: t_dhaph.hp_loss(a, b, torch.from_numpy(labels), l, cfg,
                                        _Replay(cat, gum)),
        z, t, lcas, jit=True)
    assert len(cat) == 0 and len(gum) == 0            # 8 triplet and 8 Gumbel draws, all used
    assert float(jv) > 0
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, atol=1e-5 * max(1.0, np.abs(b).max()))


def test_draws_are_uniform_over_the_allowed_columns():
    """Gumbel-max over 0 / -1e30 logits draws only allowed columns.  In a
    row with nothing allowed the noise vanishes beside -1e30 in float32 and
    every draw is column 0, as it is with ccmh's categorical (the miner
    masks such anchors out)."""
    allowed = torch.tensor([[1, 0, 1, 0], [0, 0, 0, 0]], dtype=torch.bool)
    logits = torch.where(allowed, 0.0, -1e30)
    draws = t_dhaph.Draws(torch.Generator().manual_seed(0)).categorical(logits, 4000)
    assert set(draws[0].tolist()) == {0, 2}
    assert set(draws[1].tolist()) == {0}
    assert abs((draws[0] == 0).float().mean().item() - 0.5) < 0.05


def _same_masks_every_step(monkeypatch):
    """Both packages' LinearHash dropout takes, at its i-th call of a loss
    evaluation (image head, then text head), the i-th of two numpy masks.
    The masks repeat from step to step, so ccmh's step can run under
    ``jit``, which traces the dropout once."""
    import ccmh.models.heads as j_heads
    from ccmh_torch.models import heads as t_heads

    calls = {"jax": 0, "torch": 0}

    def mask(side, shape, rate):
        i = calls[side] % 2
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


KEY_BIAS_NOISE = 1e-5


def _assert_params_close(got, want, what, **tol):
    """Parameters after a step, leaf by leaf.  One exception: the key third
    of an attention's ``qkv_b`` has a gradient of exactly 0 in exact
    arithmetic (the softmax ignores a constant added to a row of logits),
    so both packages step it on float32 rounding noise, which BertAdam's
    m / (sqrt(v) + eps) scales up toward the learning rate.  Those entries
    are held to stay at that noise level (|x| <= 1e-5, two orders below the
    other biases' steps at lr 1e-3) in both packages, not to each other."""
    from ccmh_torch.train.optim import tree_leaves_with_path
    from tests.test_torch_linear_hash_methods import _get

    for path, leaf in tree_leaves_with_path(got):
        g, w = leaf.detach().numpy(), np.asarray(_get(want, path))
        if path[-1] == "qkv_b":
            d = g.shape[-1] // 3
            for x in (g[..., d:2 * d], w[..., d:2 * d]):
                assert np.abs(x).max() <= KEY_BIAS_NOISE, f"{what} {path} key bias"
            g, w = np.delete(g, np.s_[d:2 * d], -1), np.delete(w, np.s_[d:2 * d], -1)
        np.testing.assert_allclose(g, w, err_msg=f"{what} {path}", **tol)


def assert_method_matches_ccmh(name, jcfg, cfg, batches, fill_aux=None, jit=False):
    """Method ``name`` of both packages on ``ClipConfig.tiny()``: the loss,
    its metrics and every gradient (parameters and ``extra``) at a state
    ccmh initialises and the port takes as numpy, then a train step per
    further batch (BertAdam after ccmh's global clip where the method has
    one, the method's own optimizer on ``extra``), parameters, ``extra``
    and ``aux`` compared after each.  ``fill_aux(aux)`` completes ccmh's
    initial aux.  -> (port state, ccmh state)."""
    import optax

    from ccmh.clip.model import ClipConfig as JClipConfig, init_clip_params as j_init_clip
    from ccmh.train.methods import get_method as j_get_method
    from ccmh.train.state import (
        init_state as j_init_state, make_main_optimizer as j_make_opt,
        make_train_step as j_make_step,
    )
    from ccmh_torch.bridge import params_from_jax
    from ccmh_torch.clip.model import ClipConfig
    from ccmh_torch.train.methods import get_method
    from ccmh_torch.train.optim import tree_leaves_with_path
    from ccmh_torch.train.state import (
        TrainState, make_main_optimizer, make_train_step, trainable,
    )
    from tests.test_torch_linear_hash_methods import _assert_trees_close, _get

    jclip, clip = JClipConfig.tiny(), ClipConfig.tiny()
    key = jax.random.PRNGKey(5)
    jmethod, method = j_get_method(name), get_method(name)
    assert method.grad_clip == jmethod.grad_clip and method.features == jmethod.features
    assert method.needs_mask == jmethod.needs_mask
    heads, extra, aux = jmethod.init(jax.random.fold_in(key, 1), jcfg, jclip)
    aux = fill_aux(aux) if fill_aux else aux
    jparams = {"clip": j_init_clip(key, jclip), **heads}
    bert = j_make_opt(jcfg, jparams, 4)
    tx = optax.chain(optax.clip_by_global_norm(jmethod.grad_clip), bert) if jmethod.grad_clip else bert
    extra_tx = jmethod.extra_tx(jcfg) if jmethod.extra_tx else None
    jstate = j_init_state(jax.random.fold_in(key, 2), jparams, extra, aux, tx, extra_tx)
    jloss_fn = jmethod.make_loss_fn(jcfg, jclip)
    jstep = j_make_step(jloss_fn, tx, extra_tx, jcfg, jclip, jit=jit)

    numpy = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    params = trainable(params_from_jax(numpy(jstate.params), device="cpu"))
    t_extra = None if extra is None else trainable(params_from_jax(numpy(extra), device="cpu"))
    t_aux = params_from_jax(numpy(aux), device="cpu")
    opt = make_main_optimizer(cfg, params, 4)
    bert_state = jstate.opt_state[1] if jmethod.grad_clip else jstate.opt_state
    opt.load_tree_state(numpy(bert_state.m), numpy(bert_state.v), int(bert_state.step))
    extra_opt = method.extra_optimizer(cfg, t_extra) if t_extra is not None else None
    assert (extra_opt is None) == (extra_tx is None)
    loss_fn = method.make_loss_fn(cfg, clip)

    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    argnums = (0, 1) if extra is not None else (0,)
    value_and_grad = jax.value_and_grad(
        lambda p, e: jloss_fn(p, e, jstate.aux, jb, jax.random.PRNGKey(0)),
        argnums=argnums, has_aux=True)
    (jl, (_, jm)), jg = (jax.jit(value_and_grad) if jit else value_and_grad)(
        jstate.params, jstate.extra)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batches[0].items()}
    loss, (_, m) = loss_fn(params, t_extra, t_aux, tb, torch.Generator().manual_seed(0))
    assert math.isfinite(float(jl))
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

    extra0 = None if extra is None else numpy(extra)
    state = TrainState(params, t_extra, t_aux, 0, torch.Generator().manual_seed(0))
    step = make_train_step(loss_fn, opt, extra_opt, grad_clip=method.grad_clip)
    tol = dict(atol=2e-6, rtol=1e-5)
    for i, batch in enumerate(batches[1:]):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5,
                                   err_msg=f"loss at step {i}")
        _assert_params_close(state.params, numpy(jstate.params), f"step {i}", **tol)
        if extra is not None:
            _assert_trees_close(state.extra, numpy(jstate.extra), f"step {i} extra", **tol)
        _assert_trees_close(state.aux, numpy(jstate.aux), f"step {i} aux", **tol)
    assert state.step == len(batches) - 1
    if extra is not None:       # the extra optimizer moved every leaf
        for path, leaf in tree_leaves_with_path(state.extra):
            assert not np.array_equal(leaf.detach().numpy(), _get(extra0, path)), path
    return state, jstate


def test_dhaph_method_matches_ccmh(monkeypatch):
    """Loss and gradients at a bridged state, then 3 steps: BertAdam on the
    parameters, AdamW (the default lr 1e-5) on the HPmodel and the LCAs."""
    from ccmh_torch.train.methods import dhaph as t_method_mod
    from tests.test_torch_linear_hash_methods import K, N_CLASS, STEPS, _batches

    _same_masks_every_step(monkeypatch)
    cat, gum = _record_ccmh_draws(monkeypatch)
    monkeypatch.setattr(t_method_mod, "Draws", lambda generator: _Replay(cat, gum))
    kw = dict(method="DHaPH", output_dim=K, max_words=12, epochs=3, nclass=N_CLASS, lr=1e-3,
              clip_lr=1e-4, warmup_proportion=0.2, weight_decay=0.2)
    jcfg, cfg = JConfig(**kw, dhaph=JDHaPHConfig(**SMALL)), Config(**kw, dhaph=DHaPHConfig(**SMALL))
    state, _ = assert_method_matches_ccmh("DHaPH", jcfg, cfg, _batches(seed=7, n=STEPS + 1),
                                          jit=True)
    assert not cat and not gum              # every draw of ccmh's went to the port
    assert float(state.extra["lcas"].grad.abs().max()) > 0


def test_extra_optimizer_is_optax_adamw():
    """DHaPH's AdamW on the HPmodel and the LCAs against ccmh's
    ``optax.adamw`` over 3 steps of the same gradients (lr 1e-2, so the
    decoupled decay shows at float32 resolution)."""
    import optax

    from ccmh.train.methods import get_method as j_get_method
    from ccmh_torch.bridge import params_from_jax
    from ccmh_torch.train.methods import get_method
    from ccmh_torch.train.state import trainable

    jcfg = JConfig(output_dim=16, dhaph=JDHaPHConfig(**SMALL, hp_lr=1e-2))
    cfg = Config(output_dim=16, dhaph=DHaPHConfig(**SMALL, hp_lr=1e-2))
    extra = {"hpmodel": j_dhaph.init_hp_model(jax.random.PRNGKey(1), 16, 16),
             "lcas": j_dhaph.init_lcas(jax.random.PRNGKey(2), jcfg.dhaph, 16)}
    tx = j_get_method("DHaPH").extra_tx(jcfg)
    opt_state = tx.init(extra)
    t_extra = trainable(params_from_jax(jax.tree.map(np.asarray, extra), device="cpu"))
    opt = get_method("DHaPH").extra_optimizer(cfg, t_extra)
    r = np.random.RandomState(4)
    for step in range(3):
        grads = jax.tree.map(lambda x: jnp.asarray(r.randn(*x.shape).astype(np.float32)
                                                   * 10.0 ** -step), extra)
        updates, opt_state = tx.update(grads, opt_state, extra)
        extra = optax.apply_updates(extra, updates)
        t_grads = params_from_jax(jax.tree.map(np.asarray, grads), device="cpu")
        for name, leaf in (("w", t_extra["hpmodel"]["linear"]["w"]),
                           ("b", t_extra["hpmodel"]["linear"]["b"]), ("lcas", t_extra["lcas"])):
            leaf.grad = (t_grads["lcas"] if name == "lcas"
                         else t_grads["hpmodel"]["linear"][name]).clone()
        opt.step()
        for got, want in ((t_extra["lcas"], extra["lcas"]),
                          (t_extra["hpmodel"]["linear"]["w"], extra["hpmodel"]["linear"]["w"]),
                          (t_extra["hpmodel"]["linear"]["b"], extra["hpmodel"]["linear"]["b"])):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                                       atol=2e-6, err_msg=f"step {step}")
