"""DPBE of the port against ccmh's on ``ClipConfig.tiny()`` at K=16 with
3 posterior samples: the loss and every gradient at ccmh's init, two
train steps (params and the Hessian EMA in aux after each), and the codes
of the deterministic encode.  ccmh's weight noise is replayed in the port:
ccmh vmaps ``jax.random.normal`` over the samples' keys, and the test draws
the same numbers key by key from the same key schedule (for a step, the
second half of ``split(state.rng)``; for encode, ``PRNGKey(cfg.seed)``).

The triplet count that scales the Hessian is held against an oracle of its
own (ccmh's needs the reference checkout): the uint8 ``[B, B, B]`` product
of the reference miner, counted by brute force in torch, on labels with
overlaps of 16 and more, where the uint8 wrap drops triplets.

Tolerances (tests/torch_extra_state_harness.py): loss rtol 1e-5, gradients
atol 1e-5 x the leaf's largest entry, params and the Hessians atol 2e-6 /
rtol 1e-5 after each step, codes exact except where the mean sampled code
is within 1e-6 of 0; the triplet count exact.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ccmh_torch.train.methods.dpbe as t_method
from ccmh.losses.dpbe import n_triplets as j_n_triplets
from ccmh_torch.losses.dpbe import dpbe_encode_codes, n_triplets
from ccmh_torch.train.methods.base import image_embeds, text_embeds
from tests import torch_extra_state_harness as H

N_SAMPLES = 3


def _ccmh_noise(rng, n_samples, params):
    """The noise ccmh's vmapped ``sample_head`` draws from ``rng``, per
    sample: (image {"w", "b"}, text {"w", "b"})."""
    out = []
    for key in jax.random.split(rng, n_samples):
        heads = []
        for k, head in zip(jax.random.split(key), ("img_head", "txt_head")):
            shapes = {n: np.shape(params[head][n]) for n in ("w", "b")}
            heads.append({"w": np.asarray(jax.random.normal(k, shapes["w"])),
                          "b": np.asarray(jax.random.normal(jax.random.fold_in(k, 1),
                                                            shapes["b"]))})
        out.append(heads)
    return out


def _replay(monkeypatch, queue):
    """The port's loss draws pop ``queue`` (w then b, image then text head,
    sample by sample)."""
    def draw(generator, device):
        return lambda shape: torch.from_numpy(queue.pop(0).copy())
    monkeypatch.setattr(t_method, "normal_draw", draw)


def _queue(noise):
    return [x for sample in noise for head in sample for x in (head["w"], head["b"])]


def test_dpbe_matches_ccmh(monkeypatch):
    H.same_masks(monkeypatch)
    queue = []
    _replay(monkeypatch, queue)
    jcfg, cfg = H.configs("DPBE", train_num=40, sets={"dpbe.n_samples": N_SAMPLES,
                                                      "dpbe.max_pairs": 50})
    h = H.build("DPBE", jcfg, cfg)
    data = H.batches(seed=17, n=3)

    queue += _queue(_ccmh_noise(jax.random.PRNGKey(0), N_SAMPLES, h.jstate.params))
    H.check_loss_and_grads(h, data[0])
    assert not queue

    def ccmh_step_noise(h):
        # the loss's rng in ccmh's step: the second half of split(state.rng)
        queue.extend(_queue(_ccmh_noise(jax.random.split(h.jstate.rng)[1], N_SAMPLES,
                                        h.jstate.params)))
    H.run_steps(h, data[1:], before_step=ccmh_step_noise)
    assert not queue
    for name in ("hessian_i", "hessian_t"):
        assert float(h.state.aux[name]["w"].min()) != float(jcfg.train_num)

    # encode: fresh noise from PRNGKey(cfg.seed) on every call
    noise = _ccmh_noise(jax.random.PRNGKey(cfg.seed), N_SAMPLES, h.jstate.params)
    monkeypatch.setattr(t_method, "encode_draws", lambda cfg, params, device: tuple(
        [{k: torch.from_numpy(v.copy()) for k, v in sample[i].items()} for sample in noise]
        for i in (0, 1)))
    jb = {k: jnp.asarray(v) for k, v in data[0].items()}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in data[0].items()}
    j_img, j_txt = h.jmethod.encode(h.jstate.params, h.jstate.aux, jb, h.jcfg, h.jclip)
    p, aux = h.state.params, h.state.aux
    with torch.no_grad():
        img, txt = h.method.encode(p, aux, tb, h.cfg, h.clip)
        draws = t_method.encode_draws(h.cfg, p, "cpu")
        mi = dpbe_encode_codes(image_embeds(p, h.clip, tb["image"], h.cfg), p["img_head"],
                               aux["hessian_i"], draws[0]).abs()
        mt = dpbe_encode_codes(text_embeds(p, h.clip, tb["text"], h.cfg), p["txt_head"],
                               aux["hessian_t"], draws[1]).abs()
    H.assert_codes_match(img, j_img, mi, "image codes")
    H.assert_codes_match(txt, j_txt, mt, "text codes")


def _brute_force_triplets(label: torch.Tensor) -> int:
    """The reference miner's count: nonzero entries of the uint8 product
    matches[a, p] * diffs[a, n] over the [B, B, B] cube."""
    m = (label @ label.T).to(torch.uint8)          # overlap counts mod 256
    d = m ^ 1
    cube = m[:, :, None] * d[:, None, :]           # uint8 arithmetic wraps
    assert cube.dtype == torch.uint8
    return int((cube != 0).sum())


@pytest.mark.parametrize("seed", range(4))
def test_n_triplets_is_the_uint8_count(seed):
    """Exact against the brute-force uint8 cube, on labels whose overlaps
    reach 16-64 (16*16 and 64*4 wrap to 0), and equal to ccmh's count."""
    rng = np.random.RandomState(seed)
    b, c = 24, 80
    label = (rng.rand(b, c) < rng.uniform(0.05, 0.6)).astype(np.float32)
    label[: b // 3, : 16 + 16 * seed] = 1.0       # rows sharing 16 .. 64 classes
    label[np.arange(b), rng.randint(0, c, b)] = 1.0
    t = torch.from_numpy(label)
    overlaps = (t @ t.T).long()
    assert int(overlaps.max()) >= 16
    want = _brute_force_triplets(t)
    wide = int((((t @ t.T).long())[:, :, None]
                * (((t @ t.T).long()) ^ 1)[:, None, :] != 0).sum())
    assert want < wide            # the wrap dropped triplets here
    got = n_triplets(t)
    assert got.dtype == torch.int64 and int(got) == want
    assert int(j_n_triplets(jnp.asarray(label))) == want


def test_dpbe_encode_is_deterministic_and_per_tower():
    """The image codes do not depend on the text side being encoded, nor on
    the batch size: the noise is drawn afresh from ``cfg.seed``."""
    from ccmh_torch.clip.model import ClipConfig, init_clip_params
    from ccmh_torch.config import Config

    cfg = Config(method="DPBE", output_dim=16, nclass=5, train_num=30, max_words=H.MAX_WORDS)
    clip = ClipConfig.tiny()
    gen = torch.Generator().manual_seed(0)
    heads, _, aux = t_method.METHOD.init(gen, cfg, clip)
    params = {"clip": init_clip_params(gen, clip), **heads}
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in H.batches(seed=3, n=1, b=6)[0].items()}
    with torch.no_grad():
        whole = t_method.METHOD.encode_image(params, aux, batch["image"], cfg, clip)
        t_method.METHOD.encode_text(params, aux, batch["text"], cfg, clip)
        parts = torch.cat([t_method.METHOD.encode_image(params, aux, batch["image"][i:i + 2],
                                                        cfg, clip) for i in (0, 2, 4)])
        again = t_method.METHOD.encode_image(params, aux, batch["image"], cfg, clip)
    assert torch.equal(whole, parts) and torch.equal(whole, again)


def test_dpbe_trains_through_the_cli_and_both_packages_serve_it(tmp_path):
    """DPBE trains on the CPU through ``python -m ccmh_torch.cli``; its
    ``.npz`` (the Hessians in aux) serves the trainer's codes through
    ``Retriever``, and ccmh restores its params and Hessians bit for bit."""
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
    trainer = torch_main(["--method", "DPBE", "--dataset", "synthetic", "--output-dim",
                          str(H.K), "--data-dir", data, "--save-dir", str(tmp_path / "out"),
                          "--epochs", "1", "--batch-size", "6", "--query-num", "6",
                          "--train-num", "12", "--eval-batch", "6", "--clip-arch", "tiny",
                          "--save-model", "--num-workers", "1", "--device", "cpu"])
    saved = os.path.join(trainer.cfg.save_dir, "model-0.npz")
    retriever = Retriever.from_pretrained(
        Config(method="DPBE", output_dim=H.K, max_words=trainer.cfg.max_words,
               pretrained=saved), device="cpu")
    q_img, q_txt, _ = trainer.get_code(trainer.query_loader, len(trainer.query_data))
    batches = list(trainer.query_loader)
    np.testing.assert_array_equal(
        retriever.encode_images(np.concatenate([b["image"] for b in batches]), batch_size=4),
        q_img)
    np.testing.assert_array_equal(
        retriever.encode_texts(np.concatenate([b["text"] for b in batches])), q_txt)

    jcfg, _ = H.configs("DPBE", train_num=12)
    jmethod = H.j_get_method("DPBE")
    tiny = JClip.tiny()
    heads, extra, aux = jmethod.init(jax.random.PRNGKey(1), jcfg, tiny)
    jparams = {"clip": init_clip_params(jax.random.PRNGKey(0), tiny), **heads}
    jstate = init_state(jax.random.PRNGKey(2), jparams, extra, aux,
                        make_main_optimizer(jcfg, jparams, 2), None)
    state = restore_state(saved, jstate, "DPBE", tiny)
    for tree, jtree in ((trainer.state.params, state.params), (trainer.state.aux, state.aux)):
        for path, leaf in tree_leaves_with_path(tree):
            np.testing.assert_array_equal(np.asarray(H._get(jtree, path)),
                                          leaf.detach().numpy(), err_msg=str(path))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_dpbe_on_cuda_raises_without_a_card(tmp_path):
    from ccmh_torch.config import Config
    from ccmh_torch.train.trainer import Trainer

    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(Config(method="DPBE", data_dir=str(tmp_path), save_dir=str(tmp_path)),
                device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        t_method.encode_draws(Config(method="DPBE"), {"img_head": {"w": torch.zeros(2, 2),
                                                                   "b": torch.zeros(2)},
                                                      "txt_head": {"w": torch.zeros(2, 2),
                                                                   "b": torch.zeros(2)}},
                              "cuda")
