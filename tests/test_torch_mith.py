"""MITH in the port against ccmh: the localized token aggregation (with
all -inf concept columns and padded tokens), the hashing model and its
concept transformers' routing, the five-part loss, and the whole method:
loss, gradients and 3 train steps with the four code buffers and the
train labels carried across from ccmh's ``aux``.

Tolerances as tests/test_torch_linear_hash_methods.py: values rtol 1e-5
(atol 1e-5 x the scale for tensors), gradients atol 1e-5 x the leaf's
largest entry, parameters and buffers after each step atol 2e-6, rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccmh.config import Config as JConfig, MITHConfig as JMITHConfig
from ccmh.losses import mith as j_loss
from ccmh.models import mith as j_model
from ccmh_torch.bridge import params_from_jax
from ccmh_torch.config import Config, MITHConfig
from ccmh_torch.losses import mith as t_loss
from ccmh_torch.models import mith as t_model
from tests.test_torch_pmath_dhaph import _assert_vjp, assert_method_matches_ccmh

B, P, L, D, K = 4, 6, 9, 64, 16


def _tokens(seed):
    r = np.random.RandomState(seed)
    return (r.randn(B, P, D).astype(np.float32), r.randn(B, L, D).astype(np.float32),
            r.randn(B, D).astype(np.float32), r.randn(B, D).astype(np.float32))


def _kpm():
    kpm = np.zeros((B, L), bool)
    kpm[0, 5:] = kpm[2, 3:] = True
    return kpm


def test_localized_token_aggregation_matches_ccmh():
    r = np.random.RandomState(1)
    tokens = r.randn(B, L, D).astype(np.float32)
    concept = np.tanh(r.randn(B, L, K)).astype(np.float32)
    concept[:, :, 3] = -0.5               # a concept no token selects: its softmax is NaN -> 0
    concept[1, 2, :] = -0.1               # a token with no positive concept
    kpm = _kpm()
    jm, jp = j_model.localized_token_aggregation(jnp.asarray(tokens), jnp.asarray(concept), 4,
                                                 jnp.asarray(kpm))
    tm, tp = t_model.localized_token_aggregation(torch.from_numpy(tokens),
                                                 torch.from_numpy(concept), 4,
                                                 torch.from_numpy(kpm))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert not tp.numpy()[kpm].any()               # a padded token labels nothing
    assert (tm[:, 3] == 0).all()                    # the empty concept pools nothing
    _assert_vjp(lambda t: j_model.localized_token_aggregation(t, jnp.asarray(concept), 4,
                                                              jnp.asarray(kpm))[0],
                lambda t: t_model.localized_token_aggregation(t, torch.from_numpy(concept), 4,
                                                              torch.from_numpy(kpm))[0],
                tokens)
    assert np.isfinite(tm.numpy()).all()
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5, rtol=1e-5)


def _hash_params():
    p = j_model.init_hashing_model(jax.random.PRNGKey(3), D, K, JMITHConfig())
    return jax.tree.map(np.asarray, p)


def test_hashing_model_matches_ccmh():
    """Every output, and the gradients of the inputs and of every leaf
    through a random projection of all eight outputs."""
    from ccmh_torch.train.optim import tree_leaves_with_path
    from ccmh_torch.train.state import trainable

    jp = _hash_params()
    img_t, txt_t, img_c, txt_e = _tokens(2)
    kpm = _kpm()
    args = (jax.tree.map(jnp.asarray, jp), *map(jnp.asarray, (img_t, txt_t, img_c, txt_e)))

    def run(*a):
        return tuple(j_model.hashing_model(*a, jnp.asarray(kpm)))

    r = np.random.RandomState(9)
    cts = [r.randn(*o.shape).astype(np.float32) for o in jax.eval_shape(run, *args)]

    @jax.jit                    # one program instead of op by op
    def value_and_vjp(*a):
        out, vjp = jax.vjp(run, *a)
        return out, vjp(tuple(jnp.asarray(c) for c in cts))

    jout, jgrads = value_and_vjp(*args)

    tp = trainable(params_from_jax(jp, device="cpu"))
    inputs = [torch.tensor(x, requires_grad=True) for x in (img_t, txt_t, img_c, txt_e)]
    tout = t_model.hashing_model(tp, *inputs, torch.from_numpy(kpm))
    for name, t, j in zip(t_model.MithOutputs._fields, tout, jout):
        j = np.asarray(j)
        np.testing.assert_allclose(t.detach().numpy(), j, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(j).max()), err_msg=name)
    paths, leaves = zip(*tree_leaves_with_path(tp))
    grads = torch.autograd.grad(list(tout), list(leaves) + inputs,
                                [torch.from_numpy(c) for c in cts], allow_unused=True)
    wants = [np.asarray(jgrads[0][p[0]] if len(p) == 1 else _get(jgrads[0], p)) for p in paths]
    wants += [np.asarray(g) for g in jgrads[1:]]
    for what, g, w in zip(list(paths) + ["img_t", "txt_t", "img_c", "txt_e"], grads, wants):
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, atol=1e-5 * max(1.0, np.abs(w).max()), err_msg=str(what))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_concept_transformers_take_the_fused_attention(monkeypatch):
    """Both concept transformers call the fused attention entry once a
    layer in each package (L = K, no mask)."""
    from tests.test_torch_clip_tokens import _count_fused_calls

    counts = _count_fused_calls(monkeypatch)
    jp = _hash_params()
    args = _tokens(4)
    kpm = _kpm()
    j_model.hashing_model(jax.tree.map(jnp.asarray, jp), *map(jnp.asarray, args),
                          jnp.asarray(kpm))
    t_model.hashing_model(params_from_jax(jp, device="cpu"), *map(torch.from_numpy, args),
                          torch.from_numpy(kpm))
    n = 2 * JMITHConfig().transformer_layers
    assert counts == {"ccmh": n, "port": n}


def test_sincos_position_matches_ccmh():
    np.testing.assert_array_equal(t_model.sincos_position(K, D),
                                  np.asarray(j_model.sincos_position(K, D)))


def _outputs(seed):
    r = np.random.RandomState(seed)
    hashes = [np.tanh(r.randn(B, K)).astype(np.float32) for _ in range(4)]
    res = [r.randn(B, D).astype(np.float32) for _ in range(2)]
    res = [x / np.linalg.norm(x, axis=-1, keepdims=True) for x in res]
    trans = [r.randn(B, K, D).astype(np.float32) for _ in range(2)]
    trans = [x / np.linalg.norm(x, axis=-1, keepdims=True) for x in trans]
    # MithOutputs order: img_cls, txt_cls, res_img, res_txt, img_tok, txt_tok, trans_i, trans_t
    return [hashes[0], hashes[1], res[0], res[1], hashes[2], hashes[3], trans[0], trans[1]]


def test_mith_loss_matches_ccmh():
    n_train = 10
    r = np.random.RandomState(7)
    label_sim = (r.rand(n_train, B) < 0.4).astype(np.float32)
    bufs = {k: r.randn(n_train, K).astype(np.float32)
            for k in ("img_tokens", "img_cls", "txt_tokens", "txt_cls")}
    jcfg, cfg = JMITHConfig(), MITHConfig()

    def jfn(*outs):
        loss, parts = j_loss.mith_loss(j_model.MithOutputs(*outs), jnp.asarray(label_sim),
                                       {k: jnp.asarray(v) for k, v in bufs.items()}, jcfg, K)
        return jnp.stack([loss] + [parts[k] for k in sorted(parts)])

    def tfn(*outs):
        loss, parts = t_loss.mith_loss(t_model.MithOutputs(*outs), torch.from_numpy(label_sim),
                                       {k: torch.from_numpy(v) for k, v in bufs.items()}, cfg, K)
        return torch.stack([loss] + [parts[k] for k in sorted(parts)])

    _assert_vjp(jfn, tfn, *_outputs(8))


def test_mith_method_matches_ccmh(monkeypatch):
    """3 steps: BertAdam, and the four buffers written at the batch's rows
    before the loss, carried from ccmh's aux (the labels of the train split
    in it)."""
    from tests.test_torch_linear_hash_methods import K as K_BITS, N_CLASS, STEPS, _batches

    n_train = 12
    r = np.random.RandomState(3)
    train_labels = (r.rand(n_train, N_CLASS) < 0.4).astype(np.float32)
    batches = _batches(seed=7, n=STEPS + 1)
    for i, b in enumerate(batches):
        b["index"] = ((np.arange(len(b["label"])) + 5 * i) % n_train).astype(np.int32)
        b["label"] = train_labels[b["index"]]
        b["key_padding_mask"] = b["text"] == 0
    kw = dict(method="MITH", output_dim=K_BITS, max_words=12, epochs=2, nclass=N_CLASS,
              train_num=n_train, lr=1e-3, clip_lr=1e-4, warmup_proportion=0.2,
              weight_decay=0.2)
    state, jstate = assert_method_matches_ccmh(
        "MITH", JConfig(**kw), Config(**kw), batches,
        fill_aux=lambda aux: {**aux, "train_labels": jnp.asarray(train_labels)}, jit=True)
    # the buffers began as unit normal draws; the rows the steps wrote hold
    # tanh codes
    for name in ("img_tokens", "img_cls", "txt_tokens", "txt_cls"):
        assert torch.all(state.aux["buffers"][name][batches[-1]["index"]].abs() <= 1)
        assert np.abs(np.asarray(jstate.aux["buffers"][name])).max() <= 1


@pytest.mark.parametrize("top_k", [1, 4])
def test_top_k_ties_keep_every_tied_concept(top_k):
    """Top-k *values*: a token keeps every concept tied with its k-th."""
    tokens = torch.ones((1, 2, 3))
    concept = torch.tensor([[[0.5, 0.5, 0.2, -0.1], [0.3, 0.9, 0.9, 0.9]]])
    _, pseudo = t_model.localized_token_aggregation(tokens, concept, top_k)
    want = {1: [[1, 1, 0, 0], [0, 1, 1, 1]], 4: [[1, 1, 1, 0], [1, 1, 1, 1]]}[top_k]
    np.testing.assert_array_equal(pseudo[0].numpy(), want)
