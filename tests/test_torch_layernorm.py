"""Kernels #4 and #5 (the fused LayerNorm and residual add + LayerNorm):
the port's plain versions through its autograd Functions against ccmh's
``fused_layer_norm`` / ``fused_add_layer_norm``, whose Pallas kernels run
in interpret mode on the CPU, and the towers with ``set_ln_impl("fused")``
against ccmh's with its fused LN forced on.

Same numpy inputs through both.  Tolerances: fp32 atol 1e-6 forward (the
same fp32 operations, summed in other orders) and atol 2e-5, rtol 1e-5 for
gradients (as tests/test_layernorm.py holds ccmh's own fused VJP to its
plain one); bf16 atol 2e-2, one bf16 ulp at the output scale of 2-4, for
``y`` and the gradients, and the sum ``s`` exactly equal (the add rounds
once, in the input type, in both).  The towers: pooled features atol 2e-5,
rtol 1e-5; each leaf's gradient atol 1e-5 x its largest entry (the towers'
products sum in other orders through 2 + 2 layers; the text tower's
gradients reach ~50).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccmh.ops.layernorm import (
    fused_add_layer_norm as jax_fused_add_ln, fused_layer_norm as jax_fused_ln,
)
from ccmh_torch.ops import layernorm as ln

DTYPES = [pytest.param(torch.float32, jnp.float32, 1e-6, id="fp32"),
          pytest.param(torch.bfloat16, jnp.bfloat16, 2e-2, id="bf16")]
SHAPES = [pytest.param((4, 6, 128), id="rows24-w128"),
          pytest.param((7, 13, 96), id="ragged-rows91-w96"),
          pytest.param((1, 50, 768), id="vision-row-w768")]


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    W = shape[-1]
    return {"x": rng.randn(*shape).astype(np.float32),
            "d": rng.randn(*shape).astype(np.float32),
            "scale": (1.0 + 0.1 * rng.randn(W)).astype(np.float32),
            "bias": (0.1 * rng.randn(W)).astype(np.float32),
            "g1": rng.randn(*shape).astype(np.float32),
            "g2": rng.randn(*shape).astype(np.float32)}


def _np(t):
    return np.asarray(t.detach().float().numpy() if isinstance(t, torch.Tensor) else t,
                      np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tdtype,jdtype,tol", DTYPES)
def test_forward_matches_ccmh_kernels(shape, tdtype, jdtype, tol):
    a = _inputs(shape, seed=1)
    x, d = (torch.from_numpy(a[k]).to(tdtype) for k in ("x", "d"))
    scale, bias = torch.from_numpy(a["scale"]), torch.from_numpy(a["bias"])
    jx, jd = (jnp.asarray(a[k], jdtype) for k in ("x", "d"))
    js, jb = jnp.asarray(a["scale"]), jnp.asarray(a["bias"])

    y = ln.fused_layer_norm(x, scale, bias)
    assert y.dtype == tdtype and y.shape == x.shape
    np.testing.assert_allclose(_np(y), _np(jax_fused_ln(jx, js, jb)), atol=tol)

    y2, s = ln.fused_add_layer_norm(x, d, scale, bias)
    jy2, js2 = jax_fused_add_ln(jx, jd, js, jb)
    np.testing.assert_array_equal(_np(s), _np(js2))
    np.testing.assert_allclose(_np(y2), _np(jy2), atol=tol)


@pytest.mark.parametrize("shape", SHAPES[:2])
@pytest.mark.parametrize("tdtype,jdtype,tol", DTYPES)
def test_vjp_matches_ccmh(shape, tdtype, jdtype, tol):
    """Both outputs of #5 carry cotangents (the residual stream continues
    through s while y feeds the block body)."""
    a = _inputs(shape, seed=2)
    gtol = dict(atol=2e-5, rtol=1e-5) if tdtype == torch.float32 else dict(atol=tol)

    # kernel #4
    jargs = (jnp.asarray(a["x"], jdtype), jnp.asarray(a["scale"]), jnp.asarray(a["bias"]))
    out, vjp = jax.vjp(jax_fused_ln, *jargs)
    want = vjp(jnp.asarray(a["g1"], out.dtype))
    x = torch.from_numpy(a["x"]).to(tdtype).requires_grad_()
    scale = torch.from_numpy(a["scale"]).requires_grad_()
    bias = torch.from_numpy(a["bias"]).requires_grad_()
    y = ln.fused_layer_norm(x, scale, bias)
    got = torch.autograd.grad(y, (x, scale, bias), torch.from_numpy(a["g1"]).to(tdtype))
    for name, g, w in zip(("dx", "dscale", "dbias"), got, want):
        assert g.dtype == {"dx": tdtype}.get(name, torch.float32)
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **gtol)

    # kernel #5
    jargs = (jnp.asarray(a["x"], jdtype), jnp.asarray(a["d"], jdtype),
             jnp.asarray(a["scale"]), jnp.asarray(a["bias"]))
    (jy, js), vjp = jax.vjp(jax_fused_add_ln, *jargs)
    want = vjp((jnp.asarray(a["g1"], jy.dtype), jnp.asarray(a["g2"], js.dtype)))
    x = torch.from_numpy(a["x"]).to(tdtype).requires_grad_()
    d = torch.from_numpy(a["d"]).to(tdtype).requires_grad_()
    y, s = ln.fused_add_layer_norm(x, d, scale, bias)
    got = torch.autograd.grad((y, s), (x, d, scale, bias),
                              (torch.from_numpy(a["g1"]).to(tdtype),
                               torch.from_numpy(a["g2"]).to(tdtype)))
    for name, g, w in zip(("dx", "dd", "dscale", "dbias"), got, want):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **gtol)


@pytest.mark.parametrize("used", ["y", "s"])
def test_add_ln_takes_a_missing_cotangent(used):
    """Only one output of #5 reaches the loss: the Function's backward gets
    None for the other, and matches autograd through the plain version."""
    a = _inputs((3, 5, 64), seed=3)
    grads = {}
    for impl in ("fused", "plain"):
        x, d, scale, bias = (torch.from_numpy(a[k]).requires_grad_()
                             for k in ("x", "d", "scale", "bias"))
        fn = ln.fused_add_layer_norm if impl == "fused" else ln.add_layer_norm_reference
        y, s = fn(x, d, scale, bias)
        out = y if used == "y" else s
        loss = (out * torch.from_numpy(a["g1"])).sum()
        grads[impl] = torch.autograd.grad(loss, (x, d, scale, bias), allow_unused=True)
    for g, w in zip(grads["fused"], grads["plain"]):
        if w is None:
            assert g is None or not g.abs().max().item()
        else:
            np.testing.assert_allclose(_np(g), _np(w), atol=2e-5, rtol=1e-5)


def test_kernel_refusals():
    """What the CUDA kernels do not take raises before a launch: the
    wrappers' checks, run on CPU tensors (the launch path is on the card)."""
    x = torch.zeros((4, 64))
    w = torch.ones(64)
    ln._check_kernel_inputs(x, x, w, w)                         # accepted
    ln._check_kernel_inputs(x.bfloat16(), x.bfloat16(), w.bfloat16(), w.bfloat16())
    bad = [
        ((x.half(), None, w, w), TypeError),                    # float16
        ((torch.zeros((4, 1025)), None, torch.ones(1025), torch.ones(1025)), ValueError),
        ((torch.zeros((0, 64)), None, w, w), ValueError),       # no rows
        ((x, None, w, w.bfloat16()), TypeError),                # mixed scale / bias types
        ((x, None, torch.ones(32), torch.ones(32)), ValueError),
        ((x, x.bfloat16(), w, w), ValueError),                  # residual of another type
        ((torch.zeros((64, 4)).T, None, torch.ones(4), torch.ones(4)), ValueError),
    ]
    for args, exc in bad:
        with pytest.raises(exc):
            ln._check_kernel_inputs(*args)


def test_ln_switch_routes_each_block(monkeypatch):
    """The default is "plain" (ccmh's "xla"); under "fused" every block
    calls #4 once (ln_1) and #5 once (residual add + ln_2), and ln_pre /
    ln_post stay plain."""
    from ccmh_torch.clip import model as cm

    assert cm.LN_IMPL == "plain"
    with pytest.raises(ValueError):
        cm.set_ln_impl("xla")
    calls = {"ln": 0, "add_ln": 0}

    def spy(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(cm, "fused_layer_norm", spy("ln", cm.fused_layer_norm))
    monkeypatch.setattr(cm, "fused_add_layer_norm", spy("add_ln", cm.fused_add_layer_norm))
    cfg = cm.ClipConfig.tiny()
    p = cm.init_clip_params(torch.Generator().manual_seed(0), cfg)
    images = torch.randn(2, cfg.image_resolution, cfg.image_resolution, 3)
    plain = cm.vision_forward(p["visual"], cfg, images).pooled
    assert calls == {"ln": 0, "add_ln": 0}
    cm.set_ln_impl("fused")
    try:
        fused = cm.vision_forward(p["visual"], cfg, images).pooled
    finally:
        cm.set_ln_impl("plain")
    assert calls == {"ln": cfg.vision_layers, "add_ln": cfg.vision_layers}
    np.testing.assert_allclose(_np(fused), _np(plain), atol=1e-5)


@pytest.mark.parametrize("tower", ["vision", "text"])
def test_towers_with_fused_ln_match_ccmh(tower, monkeypatch):
    """ClipConfig.tiny(): the port's towers under set_ln_impl("fused") (the
    plain versions through the Functions on the CPU) against ccmh's towers
    with its fused LN forced on (Pallas in interpret mode): pooled
    features and the gradient of every tower leaf."""
    import ccmh.clip.model as jm
    from ccmh_torch.bridge import params_from_jax
    from ccmh_torch.clip import model as cm
    from ccmh_torch.train.optim import tree_leaves_with_path

    monkeypatch.setattr(jm, "_use_fused_ln", lambda: True)
    jcfg, cfg = jm.ClipConfig.tiny(), cm.ClipConfig.tiny()
    jparams = jm.init_clip_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(4)
    if tower == "vision":
        inp = rng.randn(2, cfg.image_resolution, cfg.image_resolution, 3).astype(np.float32)
        jfwd = lambda p: jm.vision_forward(p, jcfg, jnp.asarray(inp)).pooled  # noqa: E731
        fwd = lambda p: cm.vision_forward(p, cfg, torch.from_numpy(inp)).pooled  # noqa: E731
        key = "visual"
    else:
        inp = rng.randint(1, 49406, size=(3, 12)).astype(np.int32)
        inp[:, 5] = 49407
        jfwd = lambda p: jm.text_forward(p, jcfg, jnp.asarray(inp)).pooled   # noqa: E731
        fwd = lambda p: cm.text_forward(p, cfg, torch.from_numpy(inp)).pooled  # noqa: E731
        key = "text"
    t = rng.randn(2 if tower == "vision" else 3, cfg.embed_dim).astype(np.float32)

    jp = jax.tree.map(np.asarray, jparams[key])
    want, jvjp = jax.vjp(jfwd, jax.tree.map(jnp.asarray, jp))
    (jgrads,) = jvjp(jnp.asarray(t))

    p = params_from_jax(jp, device="cpu")
    leaves = [v.requires_grad_() for _, v in tree_leaves_with_path(p)]
    cm.set_ln_impl("fused")
    try:
        got = fwd(p)
        grads = torch.autograd.grad(got, leaves, torch.from_numpy(t), allow_unused=True)
    finally:
        cm.set_ln_impl("plain")
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5, rtol=1e-5)
    jg = dict(tree_leaves_with_path(jax.tree.map(np.asarray, jgrads)))
    for (path, _), g in zip(tree_leaves_with_path(p), grads):
        w = jg[path]
        g = np.zeros_like(w) if g is None else _np(g)
        np.testing.assert_allclose(g, w, atol=1e-5 * max(1.0, np.abs(w).max()),
                                   err_msg=str(path))
