"""The port's DCHMT loss and its gradients against ``jax.value_and_grad``
of ccmh's ``dchmt_loss``.

Same numpy inputs through both.  Cases: euclidean and cosine distance, l1
and l2 reduction, select pairs ([B, 2K] in (0, 1)) and linear codes
([B, K] in (-1, 1)), and inputs built so that the thresholds tie:
``max(pos, threshold)``, ``min(neg, 1)`` and ``min(neg, max_value)`` meet
their bound exactly, where ``jnp.maximum``/``jnp.minimum`` split the
gradient 0.5/0.5 (``torch.clamp`` would not), and exact ±1 rows whose
squared distance sits on the ``eps`` floor of ``euclidean_similarity``.

The one-hot codes of the cosine tie case also put the linear mode's
quantization term |h| on 0, where ``jnp.abs``'s gradient is +1.

Tolerance: loss rtol 1e-5; gradients atol 1e-6 x max(1, max |grad|)
(float32 sums in other orders), except euclidean with l1: there the
diagonal a-vs-a distances are pure rounding noise (the squared distance
of a row with itself is ~1e-8 or on the eps floor, differently in each
framework), and the l1 gradient 1 / (2 n sqrt(sq)) amplifies that noise
by up to 1e4 before it cancels; 1e-4 x max |grad| there.  The l1 loss
itself carries those diagonal distances: sqrt of a few float32 ulps of
2|a|^2 (~20 here) is up to ~2e-3 for each of the 2B diagonal entries,
averaged over B^2, so its value is held to atol 1e-3 there.
"""

import dataclasses
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccmh.config import DCHMTConfig as JDCHMTConfig
from ccmh.losses.dchmt import dchmt_loss as jax_dchmt_loss
from ccmh_torch.config import DCHMTConfig
from ccmh_torch.losses.dchmt import dchmt_loss

B, K, N_CLASS = 8, 16, 4


def _compare(hi, ht, label, cfg_kw, rel=1e-6, loss_atol=0.0):
    jcfg, cfg = JDCHMTConfig(**cfg_kw), DCHMTConfig(**cfg_kw)

    def jloss(a, b):
        return jax_dchmt_loss(a, b, jnp.asarray(label), jcfg, K)[0]

    want, (gi, gt) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(hi), jnp.asarray(ht))
    a = torch.from_numpy(hi).requires_grad_()
    b = torch.from_numpy(ht).requires_grad_()
    got, metrics = dchmt_loss(a, b, torch.from_numpy(label), cfg, K)
    got.backward()
    assert set(metrics) == {"intra", "inter"}
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=loss_atol)
    for g, w in ((a.grad, gi), (b.grad, gt)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=rel * max(1.0, float(np.abs(w).max())))
    return a.grad.numpy(), b.grad.numpy()


def _labels(rng):
    label = (rng.rand(B, N_CLASS) < 0.3).astype(np.float32)
    label[np.arange(B), rng.randint(0, N_CLASS, B)] = 1.0
    return label


@pytest.mark.parametrize("hash_layer", ["select", "linear"])
@pytest.mark.parametrize("loss_type", ["l1", "l2"])
@pytest.mark.parametrize("similarity", ["euclidean", "cosine"])
def test_random_inputs(similarity, loss_type, hash_layer):
    rng = np.random.RandomState(zlib.crc32(f"{similarity}{loss_type}{hash_layer}".encode()))
    if hash_layer == "select":
        logits = rng.randn(2, B, K, 2).astype(np.float32)
        pairs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        hi, ht = (p.reshape(B, 2 * K).astype(np.float32) for p in pairs)
    else:
        hi, ht = (np.tanh(rng.randn(B, K)).astype(np.float32) for _ in range(2))
    noisy = (similarity, loss_type) == ("euclidean", "l1")
    _compare(hi, ht, _labels(rng), dict(hash_layer=hash_layer, similarity_function=similarity,
                                        loss_type=loss_type),
             rel=1e-4 if noisy else 1e-6, loss_atol=1e-3 if noisy else 0.0)


def test_cosine_threshold_ties_split_the_gradient():
    """One-hot codes: img_i . txt_j = 0 for i != j, so 1 - cos = 1 exactly.
    With sim_threshold = 1 the positive clip max(pos, 1) ties on every
    related off-diagonal pair, and the negative clip min(neg, 1) ties on
    every unrelated one."""
    eye = np.eye(K, dtype=np.float32)
    hi, ht = eye[:B].copy(), eye[B:2 * B].copy()
    label = np.zeros((B, N_CLASS), np.float32)
    label[np.arange(B), np.arange(B) % 2] = 1.0       # two classes, half and half
    _compare(hi, ht, label, dict(hash_layer="linear", similarity_function="cosine",
                                 loss_type="l1", sim_threshold=1.0))


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_euclidean_max_value_tie_and_eps_floor(loss_type):
    """vartheta = 0 makes max_value = 0: min(neg, 0) ties at every related
    pair (neg = 0 there).  Exact ±1 rows, some repeated, put the squared
    distance of equal rows at 0, under the eps floor."""
    rng = np.random.RandomState(5)
    hi = np.where(rng.rand(B, K) < 0.5, -1.0, 1.0).astype(np.float32)
    hi[1] = hi[0]
    ht = hi.copy()
    ht[::2] *= -1
    _compare(hi, ht, _labels(rng), dict(hash_layer="linear", similarity_function="euclidean",
                                        loss_type=loss_type, vartheta=0.0))


def test_configs_are_the_same_fields():
    assert ([f.name for f in dataclasses.fields(DCHMTConfig)]
            == [f.name for f in dataclasses.fields(JDCHMTConfig)])
