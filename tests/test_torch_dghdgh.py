"""DGHDGH of the port against ccmh's on ``ClipConfig.tiny()`` at K=16 (a
GNN of 2 layers and 4 heads): the loss, its six metrics and every
gradient, the GNN's and the classifier's included, at ccmh's init, then two
train steps (params, the GNN and the classifier, and the J meters in aux
after each), in the fused step and in the sequenced three-phase step.
ccmh's categorical triplet draws are replayed in the port.  The steps run
in a new epoch, so the meters reset on the first.

Tolerances (tests/torch_extra_state_harness.py): loss and metrics rtol
1e-5, gradients atol 1e-5 x the leaf's largest entry, params, ``extra`` and
the meters atol 2e-6 / rtol 1e-5 after each step (Adam's first updates are
sign-like, as BertAdam's), codes exact except where tanh's value is within
1e-6 of 0.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ccmh_torch.train.methods.dghdgh as t_method
from ccmh_torch.losses import dghdgh as t_loss
from ccmh_torch.models.heads import linear_hash
from ccmh_torch.train.methods.base import image_embeds, text_embeds
from tests import torch_extra_state_harness as H


def _replay_triplets(monkeypatch):
    """ccmh's categorical draws ([B, T] a call), handed to the port's
    sampler in order."""
    draws = []
    orig = jax.random.categorical

    def record(key, logits, axis=-1, **kw):
        out = orig(key, logits, axis=axis, **kw)
        draws.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "categorical", record)

    def sampler(generator):
        def sample(logits, t):
            got = torch.from_numpy(draws.pop(0).astype(np.int64))
            assert tuple(got.shape) == (logits.shape[0], t)
            return got
        return sample
    monkeypatch.setattr(t_method, "triplet_sampler", sampler)
    return draws


@pytest.mark.parametrize("sequenced", [False, True], ids=["fused", "sequenced"])
def test_dghdgh_matches_ccmh(sequenced, monkeypatch):
    H.same_masks(monkeypatch)
    draws = _replay_triplets(monkeypatch)
    jcfg, cfg = H.configs("DGHDGH", sets={"dghdgh.sequenced": sequenced})
    h = H.build("DGHDGH", jcfg, cfg)
    assert h.extra_opt is not None
    assert (h.step is not None) and (cfg.dghdgh.sequenced == sequenced)
    data = H.batches(seed=19, n=3, epoch=0)

    if not sequenced:
        # the sequenced step is three losses, not one: its steps are compared
        H.check_loss_and_grads(h, data[0])
        assert not draws
    extra0 = {p: leaf.detach().clone() for p, leaf in H.tree_leaves_with_path(h.state.extra)}
    H.run_steps(h, data[1:])
    assert not draws
    assert int(h.state.aux["epoch"]) == 0 and float(h.state.aux["avg_count"]) == 2.0
    moved = sum(not torch.equal(leaf, extra0[p])
                for p, leaf in H.tree_leaves_with_path(h.state.extra))
    assert moved == len(extra0)

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


def test_meters_reset_when_the_epoch_changes():
    aux = {"j_r_avg": torch.tensor(0.5), "j_gen_avg": torch.tensor(2.0),
           "avg_count": torch.tensor(3.0), "epoch": torch.tensor(1, dtype=torch.int32)}
    same = t_method._roll_epoch(aux, {"epoch": torch.tensor(1, dtype=torch.int32)})
    fresh = t_method._roll_epoch(aux, {"epoch": torch.tensor(2, dtype=torch.int32)})
    assert float(same["avg_count"]) == 3.0 and float(same["j_r_avg"]) == 0.5
    assert all(float(fresh[k]) == 0.0 for k in ("j_r_avg", "j_gen_avg", "avg_count"))
    assert int(fresh["epoch"]) == 2
    assert t_method._roll_epoch(aux, {}) is aux


def test_gumbel_triplets_draw_only_allowed_columns():
    """The port's own sampler: every valid triplet's positive shares a
    label with its anchor (not itself in the same-set case) and its
    negative shares none; a row with nothing allowed is masked."""
    rng = np.random.RandomState(0)
    labels = (rng.rand(12, 4) < 0.3).astype(np.float32)
    labels[np.arange(12), rng.randint(0, 4, 12)] = 1.0
    labels[0] = 1.0                                      # no negative: masked
    labels = torch.from_numpy(labels)
    gen = torch.Generator().manual_seed(3)
    for cross in (False, True):
        a, pos, neg, valid = t_loss.gen_triplets(labels, t_loss.gumbel_sampler(gen),
                                                 cross=cross)
        assert a.shape == pos.shape == neg.shape == valid.shape == (12 * t_loss.T_PER_ANCHOR,)
        same = (labels @ labels.T) > 0
        v = valid
        assert bool(same[a[v], pos[v]].all()) and not bool(same[a[v], neg[v]].any())
        if not cross:
            assert not bool((a[v] == pos[v]).any())
        assert not bool(valid[a == 0].any())


def test_dghdgh_trains_through_the_cli_and_serves(tmp_path):
    """DGHDGH, fused and sequenced, trains on the CPU through ``python -m
    ccmh_torch.cli``; its ``.npz`` serves the trainer's codes through
    ``Retriever`` and restores its GNN layers (a list) in the port.  ccmh
    serves it too (encode reads the heads), though its GNN layers come back
    there as a dict keyed "0", "1"; ccmh writes that list as a pickled
    object, which neither package's reader takes."""
    from ccmh.clip.model import ClipConfig as JClip, init_clip_params
    from ccmh.train.state import init_state, make_main_optimizer
    from ccmh.train.trainer import restore_state
    from ccmh_torch.cli import main as torch_main
    from ccmh_torch.config import Config
    from ccmh_torch.data.synthetic import write_synthetic_mat_dataset
    from ccmh_torch.retrieval import Retriever
    from ccmh_torch.train.checkpoint import load_checkpoint

    data = write_synthetic_mat_dataset(str(tmp_path / "data"), n=24, n_class=5, resolution=32,
                                       seed=3)
    for sequenced in (False, True):
        out = tmp_path / f"out{int(sequenced)}"
        trainer = torch_main([
            "--method", "DGHDGH", "--dataset", "synthetic", "--output-dim", str(H.K),
            "--data-dir", data, "--save-dir", str(out), "--epochs", "1", "--batch-size", "6",
            "--query-num", "6", "--train-num", "12", "--eval-batch", "6", "--clip-arch", "tiny",
            "--save-model", "--num-workers", "1", "--device", "cpu",
            "--set", f"dghdgh.sequenced={sequenced}"])
        assert trainer.cfg.dghdgh.sequenced == sequenced
        assert trainer.state.step == 2 and float(trainer.state.aux["avg_count"]) == 2.0
        saved = os.path.join(trainer.cfg.save_dir, "model-0.npz")
        layers = load_checkpoint(saved)["extra"]["gnn"]["layers"]
        assert isinstance(layers, list) and len(layers) == 2
        retriever = Retriever.from_pretrained(
            Config(method="DGHDGH", output_dim=H.K, max_words=trainer.cfg.max_words,
                   pretrained=saved), device="cpu")
        q_img, q_txt, _ = trainer.get_code(trainer.query_loader, len(trainer.query_data))
        batches = list(trainer.query_loader)
        images = np.concatenate([b["image"] for b in batches])
        texts = np.concatenate([b["text"] for b in batches])
        np.testing.assert_array_equal(retriever.encode_images(images), q_img)
        np.testing.assert_array_equal(retriever.encode_texts(texts), q_txt)

    jcfg, _ = H.configs("DGHDGH")
    jmethod = H.j_get_method("DGHDGH")
    tiny = JClip.tiny()
    heads, extra, aux = jmethod.init(jax.random.PRNGKey(1), jcfg, tiny)
    jparams = {"clip": init_clip_params(jax.random.PRNGKey(0), tiny), **heads}
    jstate = init_state(jax.random.PRNGKey(2), jparams, extra, aux,
                        make_main_optimizer(jcfg, jparams, 2), jmethod.extra_tx(jcfg))
    state = restore_state(saved, jstate, "DGHDGH", tiny)
    assert sorted(state.extra["gnn"]["layers"]) == ["0", "1"]
    j_img, j_txt = jmethod.encode(state.params, state.aux,
                                  {"image": jnp.asarray(images), "text": jnp.asarray(texts)},
                                  jcfg, tiny)
    np.testing.assert_array_equal(np.asarray(j_img), q_img)
    np.testing.assert_array_equal(np.asarray(j_txt), q_txt)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_dghdgh_on_cuda_raises_without_a_card(tmp_path):
    from ccmh_torch.config import Config
    from ccmh_torch.train.trainer import Trainer

    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(Config(method="DGHDGH", data_dir=str(tmp_path), save_dir=str(tmp_path)),
                device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        t_loss.gumbel_sampler(None)(torch.zeros(3, 3, device="cuda"), 2)
