"""DNPH of the port against ccmh's on ``ClipConfig.tiny()`` at K=16: the
loss, its two parts and every gradient (the proxies' included) at ccmh's
init, then two train steps (params, proxies and codes after each), with
the proxies frozen (the default: the reference never steps their SGD) and
with ``dnph.step_proxies`` (SGD(proxy_lr)).  ccmh's ±1 noise draws are
replayed in the port; the Hungarian assignment is scipy's on both sides.
The assignment is also held against a brute-force search over all
permutations, the oracle ccmh's own tests lack here.

Tolerances (tests/torch_extra_state_harness.py): loss rtol 1e-5, gradients
atol 1e-5 x the leaf's largest entry, params and proxies atol 2e-6 / rtol
1e-5 after each step, codes exact except where tanh's value is within 1e-6
of 0.
"""

import itertools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ccmh_torch.train.methods.dnph_tomm as t_dnph
from ccmh_torch.losses.dnph_tomm import assign_noise, hungarian
from ccmh_torch.models.heads import linear_hash
from ccmh_torch.train.methods.base import image_embeds, text_embeds
from tests import torch_extra_state_harness as H


def _replay_noise(monkeypatch):
    """ccmh's randint draws (its ±1 noise), handed to the port in order."""
    draws = []
    orig = jax.random.randint

    def record(key, shape, minval, maxval, *a, **kw):
        out = orig(key, shape, minval, maxval, *a, **kw)
        draws.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "randint", record)
    monkeypatch.setattr(t_dnph, "random_signs",
                        lambda gen, b, k, device: torch.from_numpy(
                            2.0 * draws.pop(0).astype(np.float32) - 1.0))
    return draws


@pytest.mark.parametrize("step_proxies", [False, True], ids=["frozen_proxies", "step_proxies"])
def test_dnph_matches_ccmh(step_proxies, monkeypatch):
    H.same_masks(monkeypatch)
    draws = _replay_noise(monkeypatch)
    jcfg, cfg = H.configs("DNPH", sets={"dnph.step_proxies": step_proxies,
                                        "dnph.proxy_lr": 0.05})
    h = H.build("DNPH", jcfg, cfg)
    assert (h.extra_opt is not None) == step_proxies
    proxies0 = h.state.extra["proxies"].detach().clone()
    data = H.batches(seed=11, n=3)

    H.check_loss_and_grads(h, data[0])
    assert not draws
    H.run_steps(h, data[1:])
    assert not draws
    moved = not torch.equal(h.state.extra["proxies"], proxies0)
    assert moved == step_proxies

    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in data[0].items()}
    jb = {k: jnp.asarray(v) for k, v in data[0].items()}
    j_img, j_txt = h.jmethod.encode(h.jstate.params, h.jstate.aux, jb, h.jcfg, h.jclip)
    with torch.no_grad():
        img, txt = h.method.encode(h.state.params, h.state.aux, tb, h.cfg, h.clip)
        p = h.state.params
        mi = linear_hash(p["img_head"], image_embeds(p, h.clip, tb["image"], h.cfg)).abs()
        mt = linear_hash(p["txt_head"], text_embeds(p, h.clip, tb["text"], h.cfg)).abs()
    H.assert_codes_match(img, j_img, mi, "image codes")
    H.assert_codes_match(txt, j_txt, mt, "text codes")


@pytest.mark.parametrize("b", [2, 4, 6])
def test_hungarian_matches_brute_force(b):
    """The assignment of each modality has the least total L2 cost of all
    b! permutations of the noise rows, on codes that tie nowhere."""
    rng = np.random.RandomState(b)
    for _ in range(5):
        codes = torch.from_numpy(np.tanh(rng.randn(b, 8)).astype(np.float32))
        noise = torch.from_numpy((2 * rng.randint(0, 2, (b, 8)) - 1).astype(np.float32))
        cost = torch.linalg.vector_norm(codes[:, None] - noise[None], dim=-1).double().numpy()
        col = hungarian(cost)
        best = min(itertools.permutations(range(b)),
                   key=lambda perm: cost[np.arange(b), list(perm)].sum())
        np.testing.assert_allclose(cost[np.arange(b), col].sum(),
                                   cost[np.arange(b), list(best)].sum(), rtol=1e-12)
        assert sorted(col.tolist()) == list(range(b))
        np.testing.assert_array_equal(assign_noise(codes, noise).numpy(), noise[col].numpy())


def test_dnph_trains_through_the_cli_and_serves(tmp_path):
    """DNPH trains on the CPU through ``python -m ccmh_torch.cli`` and its
    ``.npz`` serves the trainer's codes through ``Retriever``; ccmh's
    ``restore_state`` takes params and proxies from it bit for bit."""
    from ccmh.clip.model import ClipConfig as JClip, init_clip_params
    from ccmh.train.state import init_state, make_main_optimizer
    from ccmh.train.trainer import restore_state
    from ccmh_torch.cli import main as torch_main
    from ccmh_torch.config import Config
    from ccmh_torch.data.synthetic import write_synthetic_mat_dataset
    from ccmh_torch.retrieval import Retriever
    from ccmh_torch.train.optim import tree_leaves_with_path

    data = write_synthetic_mat_dataset(str(tmp_path / "data"), n=24, n_class=5, resolution=32,
                                       seed=3)
    trainer = torch_main(["--method", "DNPH", "--dataset", "synthetic", "--output-dim",
                          str(H.K), "--data-dir", data, "--save-dir", str(tmp_path / "out"),
                          "--epochs", "1", "--batch-size", "6", "--query-num", "6",
                          "--train-num", "12", "--eval-batch", "6", "--clip-arch", "tiny",
                          "--save-model", "--num-workers", "1", "--device", "cpu"])
    saved = os.path.join(trainer.cfg.save_dir, "model-0.npz")
    retriever = Retriever.from_pretrained(
        Config(method="DNPH", output_dim=H.K, max_words=trainer.cfg.max_words,
               pretrained=saved), device="cpu")
    q_img, q_txt, _ = trainer.get_code(trainer.query_loader, len(trainer.query_data))
    batches = list(trainer.query_loader)
    np.testing.assert_array_equal(
        retriever.encode_images(np.concatenate([b["image"] for b in batches])), q_img)
    np.testing.assert_array_equal(
        retriever.encode_texts(np.concatenate([b["text"] for b in batches])), q_txt)

    jcfg, _ = H.configs("DNPH")
    jmethod = H.j_get_method("DNPH")
    tiny = JClip.tiny()
    heads, extra, aux = jmethod.init(jax.random.PRNGKey(1), jcfg, tiny)
    jparams = {"clip": init_clip_params(jax.random.PRNGKey(0), tiny), **heads}
    jstate = init_state(jax.random.PRNGKey(2), jparams, extra, aux,
                        make_main_optimizer(jcfg, jparams, 2), jmethod.extra_tx(jcfg))
    state = restore_state(saved, jstate, "DNPH", tiny)
    np.testing.assert_array_equal(np.asarray(state.extra["proxies"]),
                                  trainer.state.extra["proxies"].numpy())
    for path, leaf in tree_leaves_with_path(trainer.state.params):
        np.testing.assert_array_equal(np.asarray(H._get(state.params, path)),
                                      leaf.detach().numpy(), err_msg=str(path))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_dnph_on_cuda_raises_without_a_card(tmp_path):
    """Asked for the card where there is none, the Trainer and the Retriever
    raise; nothing falls back to the CPU."""
    from ccmh_torch.config import Config
    from ccmh_torch.retrieval import Retriever
    from ccmh_torch.train.trainer import Trainer

    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(Config(method="DNPH", data_dir=str(tmp_path), save_dir=str(tmp_path)),
                device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        Retriever.from_pretrained(Config(method="DNPH", pretrained=str(tmp_path / "m.npz")),
                                  device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        t_dnph.random_signs(None, 2, 4, "cuda")
