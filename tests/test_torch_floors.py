"""The train step's FLOP and byte model (``ccmh_torch/tools/floors.py``).

* The towers' forward count equals ``FlopCounterMode`` over the port's
  forward on the CPU (where the attention kernels take their plain
  versions, whose products the counter sees), exactly, at
  ``ClipConfig.tiny()`` (pooled, and MITH's every-token mode with its
  key-padding mask) and at a tiny ModifiedResNet tower.
* Their executed backward count equals ``FlopCounterMode`` over
  ``loss.backward()`` exactly, with the attention kernel's backward (its
  plain version recomputes ``q kᵀ``) and with the plain formulation's
  autograd, with and without ``remat``; the floor's count (the function's
  own: twice the forward's products less the images' gradient) is that
  count less the recompute, and equal to it with the plain attention and
  no remat.
* The count lies within [0.97, 1.0] of XLA's ``cost_analysis()["flops"]``
  of ``ccmh``'s ``encode_image`` + ``encode_text`` (XLA also counts the
  elementwise work), lowered from shapes alone, at the tiny ViT (0.983).
  The tiny ModifiedResNet's ratio is 1.004, held to [0.99, 1.01]: XLA
  counts a padded convolution's taps on the image only, where the counter
  (and the card) take every tap, zero padding included, which outweighs
  the elementwise work XLA adds.
* The optimizer bytes equal the ``nbytes`` of the port's BertAdam state,
  parameters and gradients: 28 bytes a parameter with fp32 moments, 20
  with bf16 ones; DSPH's proxy SGD adds its momentum.
* The CLIP parameter count equals the port's tree at tiny shapes and
  ``ccmh``'s (by ``eval_shape``) at ViT-B/32, DSPH's heads included, as
  ``tools/profile_step.py`` counts it.
"""

import functools

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import jax
import jax.numpy as jnp

from ccmh.clip import model as jm
from ccmh_torch.clip import model as cm
from ccmh_torch.clip.model import ClipConfig, init_clip_params, text_forward, vision_forward
from ccmh_torch.config import Config
from ccmh_torch.tools import floors
from ccmh_torch.train.methods import get_method
from ccmh_torch.train.optim import tree_leaves_with_path
from ccmh_torch.train.state import make_main_optimizer, trainable
# toy shapes: one intra-op thread keeps them from contending with the other
# test workers (an autouse fixture; the counts do not depend on it)
from tests.torch_resume_harness import one_thread  # noqa: F401

B, T = 3, 32
TOWERS = {"vit": ClipConfig.tiny(), "rn": floors.rn_tiny_config()}


def _inputs(cfg, seed=0):
    rng = np.random.RandomState(seed)
    R = cfg.image_resolution
    images = torch.from_numpy(rng.randn(B, R, R, 3).astype(np.float32))
    ids = np.zeros((B, T), np.int64)
    ids[:, 0] = cfg.vocab_size - 2
    ids[:, 1:12] = rng.randint(1, 40000, (B, 11))
    ids[:, 12] = cfg.vocab_size - 1
    return images, torch.from_numpy(ids)


@functools.lru_cache(maxsize=None)
def _params(cfg, seed=0):
    """One tree a tower for the whole file (a backward adds to its .grad,
    which the counts do not see)."""
    return trainable(init_clip_params(torch.Generator().manual_seed(seed), cfg))


def _towers(params, cfg, images, ids, features, remat=False):
    kpm = (ids == 0) if features == "mith" else None
    img = vision_forward(params["visual"], cfg, images, features=features, remat=remat)
    txt = text_forward(params["text"], cfg, ids, features=features, key_padding_mask=kpm,
                       remat=remat)
    if features == "mith":
        return img.tokens_proj.sum() + txt.tokens_proj.sum()
    return img.pooled.sum() + txt.pooled.sum()


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


CASES = [("vit", "pooled"), ("vit", "mith"), ("rn", "pooled")]


@pytest.mark.parametrize("tower,features", CASES)
def test_tower_forward_count_equals_the_flop_counter(tower, features):
    cfg = TOWERS[tower]
    params, (images, ids) = _params(cfg), _inputs(cfg)
    with torch.no_grad():
        counted = _counted(lambda: _towers(params, cfg, images, ids, features))
    want = floors.tower_flops(cfg, B, T, features)
    assert want["total"] == counted
    assert want["total"] == want["gemm"] + want["attention"]
    if features == "pooled":
        assert floors.encode_flops(cfg, B) == counted
    if tower == "rn":     # the text tower's attention only
        assert want["attention"] == cfg.transformer_layers * 4 * B * T * T * cfg.transformer_width


@pytest.mark.parametrize("attn", ["fused", "plain"])
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("tower,features", CASES)
def test_tower_backward_count_equals_the_flop_counter(tower, features, remat, attn):
    cfg = TOWERS[tower]
    params, (images, ids) = _params(cfg), _inputs(cfg)
    cm.set_attn_impl(attn)
    try:
        loss = _towers(params, cfg, images, ids, features, remat=remat)
        counted = _counted(loss.backward)
    finally:
        cm.set_attn_impl("fused")
    want = floors.tower_backward_executed_flops(cfg, B, T, features, attn=attn, remat=remat,
                                                key_padding=features == "mith")
    assert want["total"] == counted
    forward = floors.tower_flops(cfg, B, T, features)
    fwd = forward["total"]
    # more than the forward's products once, less than three times
    assert fwd < want["total"] < 3 * fwd + (2 * fwd if remat else 0)
    floor = floors.tower_backward_flops(cfg, B, T, features)
    if cfg.is_resnet:       # the stem's first convolution, 3x3 stride 2
        R = (cfg.image_resolution - 1) // 2 + 1
        first = 2 * B * R * R * 9 * 3 * (cfg.vision_width // 2)
    else:                   # the patch embedding
        first = 2 * B * cfg.n_patches * 3 * cfg.vision_patch_size ** 2 * cfg.vision_width
    assert floor["attention"] == 2 * forward["attention"]
    assert floor["total"] == 2 * fwd - first
    assert floor["gemm"] <= want["gemm"] and floor["attention"] <= want["attention"]
    if attn == "plain" and not remat:
        assert floor == want


def _xla_encode_flops(cfg: jm.ClipConfig) -> float:
    params = jax.eval_shape(lambda k: jm.init_clip_params(k, cfg), jax.random.PRNGKey(0))
    R = cfg.image_resolution
    images = jax.ShapeDtypeStruct((B, R, R, 3), jnp.float32)
    ids = jax.ShapeDtypeStruct((B, T), jnp.int32)

    def encode(p, x, t):
        return jm.encode_image(p, cfg, x), jm.encode_text(p, cfg, t)

    jm.set_attn_impl("xla")
    try:
        cost = jax.jit(encode).lower(params, images, ids).cost_analysis()
    finally:
        jm.set_attn_impl("fused")
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    return float(cost["flops"])


@pytest.mark.parametrize("tower,low,high", [("vit", 0.97, 1.0), ("rn", 0.99, 1.01)])
def test_count_lies_near_xlas_cost_analysis_of_ccmh(tower, low, high):
    cfg = TOWERS[tower]
    jcfg = jm.ClipConfig(**{k: getattr(cfg, k) for k in (
        "embed_dim", "image_resolution", "vision_layers", "vision_width", "vision_patch_size",
        "context_length", "vocab_size", "transformer_width", "transformer_heads",
        "transformer_layers")})
    ratio = floors.encode_flops(cfg, B) / _xla_encode_flops(jcfg)
    assert low <= ratio <= high, ratio


@pytest.mark.parametrize("moments,per_param", [("float32", 28), ("bfloat16", 20)])
def test_optimizer_bytes_are_the_states_nbytes(moments, per_param):
    clip_cfg = ClipConfig.tiny()
    cfg = Config(method="DSPH", output_dim=16, nclass=6, epochs=1,
                 optim_moments_dtype=moments)
    method = get_method("DSPH")
    gen = torch.Generator().manual_seed(0)
    heads, extra, _ = method.init(gen, cfg, clip_cfg)
    params = trainable({"clip": init_clip_params(gen, clip_cfg), **heads})
    extra = trainable(extra)
    opt = make_main_optimizer(cfg, params, steps_per_epoch=2)
    extra_opt = method.extra_optimizer(cfg, extra)
    leaves = [p for _, p in tree_leaves_with_path(params)]
    extra_leaves = [p for _, p in tree_leaves_with_path(extra)]
    loss = sum((p.float() ** 2).sum() for p in leaves + extra_leaves)
    loss.backward()
    opt.step()
    extra_opt.step()
    n = sum(p.numel() for p in leaves)
    assert floors.optimizer_bytes([opt]) == per_param * n
    by_hand = sum(2 * p.nbytes + p.grad.nbytes + 2 * sum(
        t.nbytes for t in opt.state[p].values()) for p in leaves)
    assert floors.optimizer_bytes([opt]) == by_hand
    # the proxies' SGD: parameter read and written, gradient read, momentum
    # read and written
    momentum = [extra_opt.state[p]["momentum_buffer"] for p in extra_leaves]
    assert all(t is not None and t.shape == p.shape for t, p in zip(momentum, extra_leaves))
    assert floors.optimizer_bytes([opt, extra_opt]) == by_hand + 20 * sum(
        p.numel() for p in extra_leaves)


@pytest.mark.parametrize("tower", ["vit", "rn"])
def test_clip_param_count_is_the_trees(tower):
    cfg = TOWERS[tower]
    tree = init_clip_params(torch.Generator().manual_seed(0), cfg)
    assert floors.clip_param_count(cfg) == sum(p.numel() for _, p in tree_leaves_with_path(tree))


def test_vit_b32_trainable_count_is_ccmhs_tree():
    from ccmh.config import Config as JaxConfig
    from ccmh.train.methods import get_method as jax_method

    cfg = Config(method="DSPH", output_dim=64, nclass=80)
    heads, _, _ = get_method("DSPH").init(torch.Generator().manual_seed(0), cfg, ClipConfig())
    port = floors.clip_param_count(ClipConfig()) + sum(
        p.numel() for _, p in tree_leaves_with_path(heads))

    jcfg = JaxConfig(method="DSPH", output_dim=64, nclass=80)
    key = jax.random.PRNGKey(3)

    def tree(k):
        jheads, _, _ = jax_method("DSPH").init(k, jcfg, jm.ClipConfig())
        return {"clip": jm.init_clip_params(k, jm.ClipConfig()), **jheads}

    shapes = jax.eval_shape(tree, key)
    assert port == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert port > 150e6


def test_the_tower_table_and_rates():
    assert floors.tower_config("vit-b-32") == ClipConfig()
    assert floors.tower_config("vit-l-14") == ClipConfig.vit_l14()
    assert floors.tower_config("rn50").vision_layers == (3, 4, 6, 3)
    assert floors.tower_config("rn50", tiny=True).is_resnet
    with pytest.raises(ValueError):
        floors.tower_config("vit-h-14")
    rates = floors.PEAK_OPS_PER_S
    assert rates["3xtf32"] == rates["tf32"] / 3 and rates["b1"] == 8 * rates["int8"]
    assert floors.bound(3.35e9, 0, "bfloat16") == (1.0, "bytes")
    assert floors.bound(0, 989e9, "bfloat16") == (1.0, "operations")
    # profile_step.py's 15.6 GFLOP a pair overstates ViT-B/32's count
    per_pair = floors.encode_flops(ClipConfig(), 1)
    assert per_pair == 11_259_232_256
    assert 1.38 < 15.6e9 / per_pair < 1.39
