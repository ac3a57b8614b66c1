"""ccmh_torch CLIP towers, weight bridge and .npz files against ccmh.

ccmh's parameters (its own init, from a JAX key) cross the bridge as
numpy; the same numpy images and token ids go through both towers.
Tolerance for fp32 pooled embeddings: 1e-4 of the embedding's largest
magnitude (the two packages sum 12-layer matmuls in different orders).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccmh.clip import model as jm
from ccmh.clip.convert import load_params_npz as jax_load_npz
from ccmh.clip.convert import save_params_npz as jax_save_npz
from ccmh_torch.bridge import params_from_jax, params_to_jax
from ccmh_torch.clip import model as tm
from ccmh_torch.clip.convert import load_params_npz, save_params_npz
from tests.torch_outputs import drop_large_outputs  # noqa: F401 -- autouse

TINY = jm.ClipConfig.tiny()
# full-width ViT-B/32, cut to 2 layers per tower
VITB32_2L = jm.ClipConfig(vision_layers=2, transformer_layers=2)


def _port_cfg(cfg):
    return tm.ClipConfig(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(tm.ClipConfig)})


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(cfg, n, seed):
    rng = np.random.RandomState(seed)
    r = cfg.image_resolution
    images = rng.randn(n, r, r, 3).astype(np.float32)
    ids = np.zeros((n, 32), np.int32)
    for i in range(n):
        length = 3 + 5 * i
        ids[i, 0] = 49406
        ids[i, 1:length] = rng.randint(1, 49405, length - 1)
        ids[i, length] = 49407
    return images, ids


def _close(got, want, rel=1e-4):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.fixture(scope="module", params=[TINY, VITB32_2L], ids=["tiny", "vitb32-2layer"])
def towers(request):
    cfg = request.param
    jp = jm.init_clip_params(jax.random.PRNGKey(0), cfg)
    return cfg, jp, params_from_jax(_numpy_tree(jp), device="cpu")


def test_vision_pooled_matches_ccmh(towers):
    cfg, jp, tp = towers
    images, _ = _inputs(cfg, 3, seed=1)
    want = np.asarray(jm.vision_forward(jp["visual"], cfg, jnp.asarray(images)).pooled)
    got = tm.vision_forward(tp["visual"], _port_cfg(cfg), torch.from_numpy(images)).pooled.numpy()
    _close(got, want)


def test_text_pooled_matches_ccmh(towers):
    cfg, jp, tp = towers
    _, ids = _inputs(cfg, 3, seed=2)
    want = np.asarray(jm.text_forward(jp["text"], cfg, jnp.asarray(ids)).pooled)
    got = tm.text_forward(tp["text"], _port_cfg(cfg), torch.from_numpy(ids)).pooled.numpy()
    _close(got, want)


def test_plain_attention_impl_matches_fused_on_cpu(towers):
    cfg, _, tp = towers
    _, ids = _inputs(cfg, 2, seed=3)
    fused = tm.text_forward(tp["text"], _port_cfg(cfg), torch.from_numpy(ids)).pooled
    tm.set_attn_impl("plain")
    try:
        plain = tm.text_forward(tp["text"], _port_cfg(cfg), torch.from_numpy(ids)).pooled
    finally:
        tm.set_attn_impl("fused")
    _close(plain.numpy(), fused.numpy(), rel=1e-6)


def test_uint8_images_normalize_like_ccmh():
    jp = jm.init_clip_params(jax.random.PRNGKey(1), TINY)
    tp = params_from_jax(_numpy_tree(jp), device="cpu")
    raw = np.random.RandomState(4).randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    np.testing.assert_allclose(tm.normalize_pixels(torch.from_numpy(raw)).numpy(),
                               np.asarray(jm.normalize_pixels(jnp.asarray(raw))),
                               rtol=0, atol=1e-6)
    want = np.asarray(jm.vision_forward(jp["visual"], TINY, jnp.asarray(raw)).pooled)
    got = tm.vision_forward(tp["visual"], _port_cfg(TINY), torch.from_numpy(raw)).pooled.numpy()
    _close(got, want)


def test_patchify_and_causal_mask_match_ccmh():
    x = np.random.RandomState(5).randn(2, 64, 64, 3).astype(np.float32)
    np.testing.assert_array_equal(tm.patchify(torch.from_numpy(x), 16).numpy(),
                                  np.asarray(jm.patchify(jnp.asarray(x), 16)))
    np.testing.assert_array_equal(tm.causal_mask(7).numpy(), np.asarray(jm.causal_mask(7)))


def test_bf16_towers_track_ccmh():
    """bf16 rounds at other places in the two frameworks: hold the cosine
    of the pooled embeddings, not the values."""
    jp = jm.init_clip_params(jax.random.PRNGKey(2), TINY)
    tp = params_from_jax(_numpy_tree(jp), device="cpu")
    images, ids = _inputs(TINY, 2, seed=6)
    pcfg = _port_cfg(TINY)
    pairs = [
        (jm.vision_forward(jp["visual"], TINY, jnp.asarray(images), dtype=jnp.bfloat16).pooled,
         tm.vision_forward(tm.cast_clip_params(tp, torch.bfloat16)["visual"], pcfg,
                           torch.from_numpy(images), dtype=torch.bfloat16).pooled),
        (jm.text_forward(jp["text"], TINY, jnp.asarray(ids), dtype=jnp.bfloat16).pooled,
         tm.text_forward(tp["text"], pcfg, torch.from_numpy(ids), dtype=torch.bfloat16).pooled),
    ]
    for want, got in pairs:
        assert got.dtype == torch.bfloat16
        a, b = np.asarray(want, np.float32), got.float().numpy()
        cos = (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)
        assert cos.min() > 0.999, cos


def test_port_init_has_ccmh_structure_and_scales():
    jp = _numpy_tree(jm.init_clip_params(jax.random.PRNGKey(0), TINY))
    tp = params_to_jax(tm.init_clip_params(torch.Generator().manual_seed(0), _port_cfg(TINY)))
    flat_j = dict(_flat(jp))
    flat_t = dict(_flat(tp))
    assert sorted(flat_j) == sorted(flat_t)
    for key, a in flat_j.items():
        b = flat_t[key]
        assert a.shape == b.shape and a.dtype == b.dtype, key
        if a.size > 1000:   # same distribution: scales agree within sampling noise
            np.testing.assert_allclose(b.std(), a.std(), rtol=0.1, err_msg=key)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_npz_round_trip_across_packages(tmp_path):
    jp = jm.init_clip_params(jax.random.PRNGKey(3), TINY)
    path_j = os.path.join(tmp_path, "jax.npz")
    jax_save_npz(path_j, _numpy_tree(jp))
    tp, cfg = load_params_npz(path_j, device="cpu")
    assert cfg == _port_cfg(TINY)
    for (kj, a), (kt, b) in zip(sorted(_flat(_numpy_tree(jp))), sorted(_flat(params_to_jax(tp)))):
        assert kj == kt
        np.testing.assert_array_equal(a, b)
    path_t = os.path.join(tmp_path, "torch.npz")
    save_params_npz(path_t, tp)
    back, back_cfg = jax_load_npz(path_t)
    assert back_cfg == TINY
    for (kj, a), (kb, b) in zip(sorted(_flat(_numpy_tree(jp))), sorted(_flat(_numpy_tree(back)))):
        assert kj == kb
        np.testing.assert_array_equal(a, b)


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card error path is not reachable")
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax({"w": np.zeros(2, np.float32)})
