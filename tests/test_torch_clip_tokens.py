"""The towers' token-level outputs in the port against ccmh on
``ClipConfig.tiny()``: the ``tokens`` and ``mith`` modes of both towers
(``tokens_pre``, ``tokens_proj``, ``cls_attn``, ``eos_attn``, the extended
key-padding mask) with their gradients, attention with ``need_weights``,
the per-example key-padding bias, and the routing: which blocks call the
fused attention entry, counted on the CPU in both packages.

Tolerances: values atol 1e-5 x the output's scale (the towers' products sum
in other orders, as tests/test_torch_clip.py); gradients atol 1e-5 x the
leaf's largest entry; masks equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ccmh.clip.model as jm
import ccmh.ops.attention as j_attn
from ccmh_torch.bridge import params_from_jax
from ccmh_torch.clip import model as tm

TINY = jm.ClipConfig.tiny()
PCFG = tm.ClipConfig.tiny()
B, L = 3, 12


@pytest.fixture(scope="module")
def towers():
    jp = jax.tree.map(np.asarray, jm.init_clip_params(jax.random.PRNGKey(0), TINY))
    return jp, params_from_jax(jp, device="cpu")


def _inputs(seed=1):
    rng = np.random.RandomState(seed)
    images = rng.randn(B, TINY.image_resolution, TINY.image_resolution, 3).astype(np.float32)
    ids = rng.randint(1, 49406, size=(B, L)).astype(np.int32)
    ids[:, 0] = 49406
    eot = np.array([4, 7, L - 1])
    ids[np.arange(B), eot] = 49407
    ids[np.arange(L)[None, :] > eot[:, None]] = 0
    return images, ids


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()), err_msg=what)


def _compare_outputs(jout, tout, fields):
    for name in fields:
        _close(getattr(tout, name).detach().numpy(), getattr(jout, name), name)


@pytest.mark.parametrize("features", ["tokens", "mith"])
def test_vision_token_modes_match_ccmh(towers, features):
    jp, tp = towers
    images, _ = _inputs()
    jout = jm.vision_forward(jp["visual"], TINY, jnp.asarray(images), features=features)
    tout = tm.vision_forward(tp["visual"], PCFG, torch.from_numpy(images), features=features)
    fields = (["pooled", "tokens_pre"] if features == "tokens"
              else ["pooled", "tokens_pre", "tokens_proj", "cls_attn"])
    _compare_outputs(jout, tout, fields)
    assert (tout.tokens_proj is None) == (features == "tokens")
    if features == "mith":
        assert tout.cls_attn.shape == (B, PCFG.n_patches)


@pytest.mark.parametrize("features,masked", [("pooled", True), ("tokens", False),
                                             ("tokens", True), ("mith", True), ("mith", False)])
def test_text_token_modes_match_ccmh(towers, features, masked):
    jp, tp = towers
    _, ids = _inputs()
    kpm = ids == 0
    jout = jm.text_forward(jp["text"], TINY, jnp.asarray(ids), features=features,
                           key_padding_mask=jnp.asarray(kpm) if masked else None)
    tout = tm.text_forward(tp["text"], PCFG, torch.from_numpy(ids), features=features,
                           key_padding_mask=torch.from_numpy(kpm) if masked else None)
    fields = {"pooled": ["pooled"], "tokens": ["pooled", "tokens_pre"],
              "mith": ["pooled", "tokens_pre", "tokens_proj", "eos_attn"]}[features]
    _compare_outputs(jout, tout, fields)
    if features == "mith":
        np.testing.assert_array_equal(tout.key_padding_mask.numpy(),
                                      np.asarray(jout.key_padding_mask))
        # the EOT token joins the mask; its own column of the EOS row is 0
        eot = ids.argmax(-1)
        assert tout.key_padding_mask[np.arange(B), eot].all()
        assert (tout.eos_attn[np.arange(B), eot] == 0).all()
        if masked:
            # a padded key gets no attention
            assert (tout.eos_attn.numpy()[kpm] == 0).all()


@pytest.mark.parametrize("tower", ["vision", "text"])
def test_mith_mode_gradients_match_ccmh(towers, tower):
    """Every tower leaf's gradient of a random projection of all the mith
    outputs (the last block's plain attention with weights included)."""
    jp, tp = towers
    images, ids = _inputs(seed=3)
    kpm = ids == 0
    rng = np.random.RandomState(5)
    if tower == "vision":
        def jfn(p):
            o = jm.vision_forward(p, TINY, jnp.asarray(images), features="mith")
            return o.tokens_proj, o.cls_attn

        def tfn(p):
            o = tm.vision_forward(p, PCFG, torch.from_numpy(images), features="mith")
            return o.tokens_proj, o.cls_attn
        key = "visual"
    else:
        def jfn(p):
            o = jm.text_forward(p, TINY, jnp.asarray(ids), features="mith",
                                key_padding_mask=jnp.asarray(kpm))
            return o.tokens_proj, o.eos_attn

        def tfn(p):
            o = tm.text_forward(p, PCFG, torch.from_numpy(ids), features="mith",
                                key_padding_mask=torch.from_numpy(kpm))
            return o.tokens_proj, o.eos_attn
        key = "text"
    shapes = jax.eval_shape(jfn, jax.tree.map(jnp.asarray, jp[key]))
    cts = [rng.randn(*o.shape).astype(np.float32) for o in shapes]

    @jax.jit                    # one program instead of op by op
    def grads_of(p):
        _, vjp = jax.vjp(jfn, p)
        return vjp(tuple(jnp.asarray(c) for c in cts))[0]

    jgrads = grads_of(jax.tree.map(jnp.asarray, jp[key]))

    from ccmh_torch.train.optim import tree_leaves_with_path
    from ccmh_torch.train.state import trainable

    p = trainable(params_from_jax(jp[key], device="cpu"))
    outs = tfn(p)
    paths, leaves = zip(*tree_leaves_with_path(p))
    grads = torch.autograd.grad(outs, leaves, [torch.from_numpy(c) for c in cts],
                                allow_unused=True)
    for path, g in zip(paths, grads):
        want = jgrads
        for k in path:
            want = want[k]
        want = np.asarray(want)
        g = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(g, want, atol=1e-5 * max(1.0, np.abs(want).max()),
                                   err_msg=str(path))


@pytest.mark.parametrize("bias_kind", ["none", "causal", "per_example"])
def test_need_weights_matches_ccmh(towers, bias_kind):
    """The attention output and the head-averaged probabilities."""
    _, tp = towers
    rng = np.random.RandomState(2)
    x = rng.randn(B, L, PCFG.transformer_width).astype(np.float32)
    jattn = jax.tree.map(lambda t: np.asarray(t)[0], towers[0]["text"]["blocks"]["attn"])
    tattn = {k: torch.from_numpy(v.copy()) for k, v in jattn.items()}
    causal = np.asarray(jm.causal_mask(L))
    if bias_kind == "none":
        bias = None
    elif bias_kind == "causal":
        bias = causal
    else:
        kp = np.where(_inputs()[1] == 0, -np.inf, 0.0).astype(np.float32)
        bias = causal[None, None] + kp[:, None, None, :]
    H = PCFG.transformer_heads
    jo, jw = jm.multi_head_attention(jnp.asarray(x), jattn, H,
                                     None if bias is None else jnp.asarray(bias), need_weights=True)
    to, tw = tm.multi_head_attention(torch.from_numpy(x), tattn, H,
                                     None if bias is None else torch.from_numpy(bias),
                                     need_weights=True)
    _close(to.numpy(), jo, "output")
    _close(tw.numpy(), jw, "weights")
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, atol=1e-6)
    # without weights the output is the same
    to2, none = tm.multi_head_attention(torch.from_numpy(x), tattn, H,
                                        None if bias is None else torch.from_numpy(bias))
    assert none is None
    _close(to2.numpy(), jo, "output without weights")


def _count_fused_calls(monkeypatch):
    """Count each package's calls of its fused attention entry.  ccmh's
    towers run the blocks under ``lax.scan``, which traces the block once
    for all the layers it covers; a Python loop takes its place here, so
    that every layer makes its own call."""
    counts = {"ccmh": 0, "port": 0}

    def python_scan(f, carry, xs, unroll=1):
        for i in range(jax.tree.leaves(xs)[0].shape[0]):
            carry, _ = f(carry, jax.tree.map(lambda t: t[i], xs))
        return carry, None

    monkeypatch.setattr(jax.lax, "scan", python_scan)

    def spy(side, fn):
        def wrapped(*a, **kw):
            counts[side] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(j_attn, "fused_attention", spy("ccmh", j_attn.fused_attention))
    monkeypatch.setattr(tm, "fused_attention", spy("port", tm.fused_attention))
    return counts


@pytest.mark.parametrize("tower,features,masked,kernel_blocks", [
    ("vision", "pooled", False, TINY.vision_layers),
    ("vision", "tokens", False, TINY.vision_layers),
    ("vision", "mith", False, TINY.vision_layers - 1),     # the last block returns weights
    ("text", "pooled", False, TINY.transformer_layers),
    ("text", "pooled", True, 0),                           # a per-example bias: plain
    ("text", "mith", True, 0),
    ("text", "mith", False, TINY.transformer_layers - 1),
])
def test_routing_matches_ccmh(towers, monkeypatch, tower, features, masked, kernel_blocks):
    """The blocks that take the fused attention: the same in both packages,
    and the number the dispatch rule implies."""
    jp, tp = towers
    images, ids = _inputs()
    counts = _count_fused_calls(monkeypatch)
    if tower == "vision":
        jm.vision_forward(jp["visual"], TINY, jnp.asarray(images), features=features)
        tm.vision_forward(tp["visual"], PCFG, torch.from_numpy(images), features=features)
    else:
        kpm = ids == 0
        jm.text_forward(jp["text"], TINY, jnp.asarray(ids), features=features,
                        key_padding_mask=jnp.asarray(kpm) if masked else None)
        tm.text_forward(tp["text"], PCFG, torch.from_numpy(ids), features=features,
                        key_padding_mask=torch.from_numpy(kpm) if masked else None)
    assert counts == {"ccmh": kernel_blocks, "port": kernel_blocks}


def test_unknown_feature_mode_raises(towers):
    _, tp = towers
    images, ids = _inputs()
    with pytest.raises(ValueError, match="features"):
        tm.vision_forward(tp["visual"], PCFG, torch.from_numpy(images), features="all")
    with pytest.raises(ValueError, match="features"):
        tm.text_forward(tp["text"], PCFG, torch.from_numpy(ids), features="all")
