"""DPSIH in the port against ccmh: the DSIE module, the three losses, the
multi-embed ranking distance and the mAP through it (hist and exact), the
global gradient clip in optax's form, and the whole method: loss,
gradients and 3 train steps (BertAdam after the clip at 2.0).

Tolerances as tests/test_torch_linear_hash_methods.py (values rtol 1e-5,
gradients atol 1e-5 x the leaf's largest entry, parameters atol 2e-6,
rtol 1e-5) and tests/test_torch_map.py (exact mAP within 4 float32 ulps,
atol 5e-7; hist within 1e-6).  The distances are integers and equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccmh.config import Config as JConfig
from ccmh.losses import dpsih as j_loss
from ccmh.models import dpsih as j_model
from ccmh.ops.map_metric import calc_map as j_calc_map
from ccmh.train.methods.dpsih import make_dist_fn as j_make_dist_fn
from ccmh_torch.config import Config, DPSIHConfig
from ccmh_torch.losses import dpsih as t_loss
from ccmh_torch.models import dpsih as t_model
from ccmh_torch.ops.map_metric import calc_map, calc_map_4way
from ccmh_torch.train.methods.dpsih import make_dist_fn
from tests.test_torch_pmath_dhaph import (
    _assert_vjp, _same_masks_every_step, assert_method_matches_ccmh,
)

rng = np.random.RandomState(0)
B, L, D, K, E = 6, 7, 24, 16, 4
TOKENS = rng.randn(B, L, D).astype(np.float32)
CODE = np.tanh(rng.randn(B, K)).astype(np.float32)
LABELS = (rng.rand(B, 5) < 0.4).astype(np.float32)
LABELS[np.arange(B), rng.randint(0, 5, B)] = 1.0


def _dsie_params():
    p = j_model.init_dsie(jax.random.PRNGKey(1), E, D, K, D // 2)
    p["fc"]["b"] = 0.1 * jax.random.normal(jax.random.PRNGKey(2), (K,))
    return jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("masked", [False, True])
def test_dsie_matches_ccmh(masked):
    """Embeddings, attention and residual (one output through their sum)
    and the gradients of the code, the tokens and the three weights."""
    from ccmh_torch.bridge import params_from_jax

    jp = _dsie_params()
    tp = params_from_jax(jp, device="cpu")
    pad = np.zeros((B, L), bool)
    pad[:, 5:] = True

    def run(model, p, mask, out, x, w1, w2, fc_w):
        p = {**p, "w1": w1, "w2": w2, "fc": {"w": fc_w, "b": p["fc"]["b"]}}
        merged, attn, residual = model.dsie(p, out, x, mask if masked else None)
        return merged + residual.sum() + attn.sum()

    _assert_vjp(lambda *a: run(j_model, jp, jnp.asarray(pad), *a),
                lambda *a: run(t_model, tp, torch.from_numpy(pad), *a),
                CODE, TOKENS, jp["w1"], jp["w2"], jp["fc"]["w"])


def _embeds(seed):
    r = np.random.RandomState(seed)
    x = r.randn(B, E, K).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("case", ["msc_self", "msc_cross", "msc_flat", "rbf", "diversity", "dpsih"])
def test_losses_match_ccmh(case):
    mcfg = DPSIHConfig()
    a, b = _embeds(1), _embeds(2)
    lab_j, lab_t = jnp.asarray(LABELS), torch.from_numpy(LABELS)
    b_dup = b.copy()
    b_dup[0] = a[0]                 # a zero distance in the RBF's cross term
    cases = {
        "msc_self": (lambda x: j_loss.msc_loss(x, lab_j), lambda x: t_loss.msc_loss(x, lab_t), (a,)),
        "msc_cross": (lambda x, y: j_loss.msc_loss(x, lab_j, inputs=y),
                      lambda x, y: t_loss.msc_loss(x, lab_t, inputs=y), (a, b)),
        "msc_flat": (lambda x: j_loss.msc_loss(x, lab_j), lambda x: t_loss.msc_loss(x, lab_t),
                     (a[:, 0],)),
        "rbf": (lambda x, y: j_loss.rbf_mmd_loss(x.reshape(-1, K), y.reshape(-1, K), 0.5),
                lambda x, y: t_loss.rbf_mmd_loss(x.reshape(-1, K), y.reshape(-1, K), 0.5),
                (a, b_dup)),
        "diversity": (lambda x: j_loss.embedding_diversity_loss(x, E),
                      lambda x: t_loss.embedding_diversity_loss(x, E), (a * 3.0,)),
        "dpsih": (lambda *x: j_loss.dpsih_loss(*x, lab_j, mcfg)[0],
                  lambda *x: t_loss.dpsih_loss(*x, lab_t, mcfg)[0],
                  (a, b, a * 2.0 + 0.1, b - 0.3)),
    }
    jfn, tfn, inputs = cases[case]
    _assert_vjp(jfn, tfn, *inputs)


def _multi_codes(n, seed):
    r = np.random.RandomState(seed)
    codes = np.where(r.rand(n, E * K) < 0.5, -1, 1).astype(np.int8)
    codes[::3, :K] = codes[0, :K]       # ties on the best pair
    return codes


def test_dist_fn_matches_ccmh():
    q, g = _multi_codes(20, 1), _multi_codes(50, 2)
    want = np.asarray(j_make_dist_fn(K)(jnp.asarray(q), jnp.asarray(g)))
    got = make_dist_fn(K)(torch.from_numpy(q), torch.from_numpy(g))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.min() >= 0 and want.max() <= K


@pytest.mark.parametrize("method", ["exact", "hist"])
def test_map_through_dist_fn_matches_ccmh(method):
    q, g = _multi_codes(37, 3), _multi_codes(300, 4)
    r = np.random.RandomState(5)
    ql = (r.rand(37, 5) < 0.3).astype(np.float32)
    rl = (r.rand(300, 5) < 0.3).astype(np.float32)
    want = float(j_calc_map(q, g, ql, rl, method=method, dist_fn=j_make_dist_fn(K),
                            n_bins=K + 1))
    got = calc_map(q, g, ql, rl, method=method, dist_fn=make_dist_fn(K), n_bins=K + 1,
                   device="cpu").item()
    np.testing.assert_allclose(got, want, atol=5e-7 if method == "exact" else 1e-6, rtol=0)
    four = calc_map_4way(q, -q, g, g[::-1].copy(), ql, rl, method=method,
                         dist_fn=make_dist_fn(K), n_bins=K + 1, device="cpu")
    np.testing.assert_allclose(four[2].item(), got, atol=5e-7, rtol=0)   # i2i is q vs g


@pytest.mark.parametrize("norm", [0.5, 1.999, 2.001, 7.0])
def test_global_clip_is_optax_clip_by_global_norm(norm):
    import optax

    from ccmh_torch.train.state import clip_by_global_norm_

    r = np.random.RandomState(int(norm * 1000))
    grads = [r.randn(5, 3).astype(np.float32), r.randn(7).astype(np.float32)]
    scale = norm / np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads))
    grads = [(g * scale).astype(np.float32) for g in grads]
    tx = optax.clip_by_global_norm(2.0)
    want, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(None))
    got = [torch.from_numpy(g.copy()) for g in grads]
    clip_by_global_norm_(got, 2.0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
    clipped = norm >= 2.0
    assert clipped == (not np.array_equal(got[0].numpy(), grads[0]))


def test_dpsih_method_matches_ccmh(monkeypatch):
    """Loss and gradients at a bridged state, then 3 steps, the global clip
    engaged."""
    from ccmh_torch.train import state as t_state
    from tests.test_torch_linear_hash_methods import K as K_BITS, N_CLASS, STEPS, _batches

    _same_masks_every_step(monkeypatch)
    norms = []
    clip = t_state.clip_by_global_norm_
    monkeypatch.setattr(t_state, "clip_by_global_norm_",
                        lambda grads, max_norm: norms.append(clip(grads, max_norm).item()))
    kw = dict(method="DPSIH", output_dim=K_BITS, max_words=12, epochs=2, nclass=N_CLASS,
              lr=1e-3, clip_lr=1e-4, warmup_proportion=0.2, weight_decay=0.2)
    state, _ = assert_method_matches_ccmh("DPSIH", JConfig(**kw), Config(**kw),
                                          _batches(seed=7, n=STEPS + 1), jit=True)
    assert state.params["dsie_i"]["w1"].shape[0] == 128     # the tiny vision width
    assert len(norms) == STEPS and max(norms) > 2.0           # the clip engaged
