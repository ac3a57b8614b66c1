"""TwDH of the port against ccmh's on ``ClipConfig.tiny()`` with small
numpy-written centres (long 16 bits, one short length 8, ccmh's
``write_synthetic_twdh_assets``), read by both packages through
``twdh.center_path``: the loss and its metrics and every gradient at
ccmh's init, then two train steps (params and the BatchNorm running stats
after each), the per-length codes of ``multi_encode`` on a batch with
wrap-padded rows, and the per-length mAPs of the Trainer's
``valid_multi``.  ccmh's random centre signs are replayed in the port.
A round trip through ``.npz`` (string keys) with short lengths {8, 16}
gives the same loss as the int-keyed assets.

Tolerances (tests/torch_extra_state_harness.py): loss rtol 1e-5, gradients
atol 1e-5 x the leaf's largest entry, params and aux atol 2e-6 / rtol 1e-5
after each step (the image head's two gradient-free biases atol 1e-5, the
reason beside the call); codes exact except where a softmax pair is within
1e-6 of a tie; mAPs to 1e-6 (the same codes, float32 means).  The short codes'
loss gradient is held apart, at 5e-3 (the reason beside it).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ccmh_torch.losses.twdh as t_twdh
from ccmh.data.synthetic import write_synthetic_twdh_assets as j_write_assets
from ccmh.ops.map_metric import calc_map_4way as j_calc_map_4way
from ccmh_torch.bridge import params_from_jax
from ccmh_torch.train.checkpoint import load_checkpoint, save_checkpoint
from ccmh_torch.train.methods.base import image_embeds, text_embeds
from ccmh_torch.train.methods import twdh as t_method
from tests import torch_extra_state_harness as H


def _replay_centre_signs(monkeypatch):
    """ccmh's randint draws (the centres' tie-breaking signs), handed to
    the port in order: the long code's, then the short lengths'."""
    draws = []
    orig = jax.random.randint

    def record(key, shape, minval, maxval, *a, **kw):
        out = orig(key, shape, minval, maxval, *a, **kw)
        draws.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "randint", record)
    monkeypatch.setattr(t_twdh, "random_center", lambda gen, k, device: torch.from_numpy(
        2.0 * draws.pop(0).astype(np.float32) - 1.0))
    return draws


def _pair_margin(code_flat):
    pairs = code_flat.reshape(code_flat.shape[0], -1, 2)
    return (pairs[..., 1] - pairs[..., 0]).abs()


def _margins(h, tb, valid):
    """Each length's (image, text) pair margins, as the port computes them."""
    p, aux = h.state.params, h.state.aux
    img_long = t_method._image_long(p, aux, image_embeds(p, h.clip, tb["image"], h.cfg),
                                    mask=valid)[0]
    txt_long = t_method._text_long(p, text_embeds(p, h.clip, tb["text"], h.cfg))
    out = {"long": (_pair_margin(img_long), _pair_margin(txt_long))}
    for k, t in t_twdh.int_keys(aux["assets"]["trans"]).items():
        out[f"short{k}"] = tuple(_pair_margin(t_method.softmax_pair_quantize(x @ t))
                                 for x in (img_long, txt_long))
    return out


def test_twdh_matches_ccmh(tmp_path, monkeypatch):
    H.same_masks(monkeypatch)
    draws = _replay_centre_signs(monkeypatch)
    assets = j_write_assets(str(tmp_path / "centres.npz"), n_class=H.N_CLASS)
    # low_rate at its default, 0: the short codes' losses are metrics only
    # (their gradient: test_twdh_short_code_loss_gradient_matches_ccmh)
    jcfg, cfg = H.configs("TwDH", sets={"twdh.center_path": assets})
    h = H.build("TwDH", jcfg, cfg)
    assert sorted(h.state.aux["assets"]["trans"]) == [8]
    data = H.batches(seed=13, n=3)

    H.check_loss_and_grads(h, data[0])
    assert not draws
    # the image head's v_b and out_b shift every row alike before the
    # train-mode BatchNorm, which removes the shift: their gradient is
    # rounding noise (~1e-8 here) that BertAdam scales to steps of ~1e-7
    # in both packages, so they are held to atol 1e-5 (not 2e-6)
    H.run_steps(h, data[1:], atol_of={("img_head", "v_b"): 1e-5,
                                       ("img_head", "out_b"): 1e-5})
    assert not draws
    assert int(h.state.aux["bn"]["count"]) == 2

    # the per-length codes, the last two rows wrap-padded out of the
    # BatchNorm statistics
    valid = np.array([True] * (H.B - 2) + [False] * 2)
    batch = {**data[0], "valid": valid}
    jout = h.jmethod.multi_encode(h.jstate.params, h.jstate.aux,
                                  {k: jnp.asarray(v) for k, v in batch.items()}, h.jcfg, h.jclip)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    with torch.no_grad():
        out = h.method.multi_encode(h.state.params, h.state.aux, tb, h.cfg, h.clip)
        margins = _margins(h, tb, tb["valid"])
        img, txt = h.method.encode(h.state.params, h.state.aux, tb, h.cfg, h.clip)
    assert sorted(out) == sorted(jout) == ["long", "short8"]
    for name in out:
        for side in (0, 1):
            H.assert_codes_match(out[name][side], jout[name][side], margins[name][side],
                                 f"{name} side {side}")
    j_img, j_txt = h.jmethod.encode(h.jstate.params, h.jstate.aux,
                                    {k: jnp.asarray(v) for k, v in batch.items()}, h.jcfg,
                                    h.jclip)
    H.assert_codes_match(img, j_img, margins["long"][0], "encode image")
    H.assert_codes_match(txt, j_txt, margins["long"][1], "encode text")
    _check_valid_multi(h, tmp_path, assets)


def _check_valid_multi(h, tmp_path, assets):
    """The Trainer's per-length validation at the trained state: its codes
    and mAPs against ccmh's ``multi_encode`` and ``calc_map_4way`` on the
    same loader batches (query 6 and retrieval 14 at eval batch 4:
    wrap-padded last batches)."""
    from ccmh_torch.clip.model import ClipConfig
    from ccmh_torch.config import Config
    from ccmh_torch.data.synthetic import write_synthetic_mat_dataset
    from ccmh_torch.train.trainer import Trainer

    data = write_synthetic_mat_dataset(str(tmp_path / "data"), n=20, n_class=H.N_CLASS,
                                       resolution=32, seed=6)
    cfg = Config(method="TwDH", dataset="synthetic", output_dim=H.K, data_dir=data,
                 save_dir=str(tmp_path / "out"), query_num=6, train_num=12, batch_size=6,
                 eval_batch=4, max_words=H.MAX_WORDS, num_workers=1, epochs=1)
    cfg.twdh.center_path = assets
    trainer = Trainer(cfg, clip_cfg=ClipConfig.tiny(), device="cpu")
    trainer.state.params = h.state.params
    trainer.state.aux = h.state.aux
    trainer.valid_multi(0)
    with open(os.path.join(cfg.save_dir, "metrics.jsonl")) as fh:
        rows = {r["event"]: r for r in map(json.loads, fh)}

    def ccmh_codes(loader, length):
        bufs = {}
        for batch in loader:
            jb = {k: jnp.asarray(batch[k]) for k in ("image", "text", "valid")}
            out = h.jmethod.multi_encode(h.jstate.params, h.jstate.aux, jb, h.jcfg, h.jclip)
            idx = batch["index"][batch["valid"]]
            for name, codes in out.items():
                for side, c in enumerate(codes):
                    c = np.asarray(c)
                    bufs.setdefault(name, [np.zeros((length, c.shape[1]), np.int8)] * 2)
                    buf = bufs[name][side].copy()
                    buf[idx] = c[batch["valid"]]
                    bufs[name][side] = buf
        return bufs

    q = ccmh_codes(trainer.query_loader, len(trainer.query_data))
    r = ccmh_codes(trainer.retrieval_loader, len(trainer.retrieval_data))
    tq = trainer._get_multi_codes(trainer.query_loader, len(trainer.query_data))
    for name in ("long", "short8"):
        # these codes have no pair within 1e-6 of a tie: they agree exactly
        np.testing.assert_array_equal(tq[name][0], q[name][0], err_msg=name)
        np.testing.assert_array_equal(tq[name][1], q[name][1], err_msg=name)
        want = j_calc_map_4way(q[name][0], q[name][1], r[name][0], r[name][1],
                               jnp.asarray(trainer.query_labels),
                               jnp.asarray(trainer.retrieval_labels))
        row = rows[f"valid_{name}"]
        np.testing.assert_allclose([row["i2t"], row["t2i"], row["i2i"], row["t2t"]],
                                   np.asarray(want, np.float64), atol=1e-6, err_msg=name)
    assert trainer.max_multi["short8"]["i2t"] == rows["valid_short8"]["i2t"]


def test_twdh_short_code_loss_gradient_matches_ccmh(tmp_path):
    """``twdh_loss`` with the short codes weighted in (low_rate 0.5) on the
    same long codes, centres (ccmh's synthetic ones, string-keyed on the
    port's side) and centre signs: the loss and its metrics to
    1e-6, the gradient wrt both long codes within 5e-3 (not 1e-5) x its
    largest entry.  The BCE's gradient divides by 1 - p, the transformed
    pairs sit within 1e-4 of saturation, and there a one-ulp difference
    between the two packages' softmax moves the gradient by up to 2e-3
    relative (about 1e-4 here); the loss agrees to 1e-7."""
    import ccmh.losses.twdh as j_twdh
    import ccmh.models.heads as j_heads

    with np.load(j_write_assets(str(tmp_path / "centres.npz"), n_class=H.N_CLASS)) as data:
        assets_np = {k: data[k] for k in data.files}
    rng = np.random.RandomState(4)
    labels = (rng.rand(H.B, H.N_CLASS) < 0.4).astype(np.float32)
    labels[:, 0] = 1.0
    longs = [np.asarray(j_heads.softmax_pair_quantize(jnp.asarray(
        rng.rand(H.B, 32).astype(np.float32)))) for _ in range(2)]
    jassets = {"long_center": jnp.asarray(assets_np["long/16"]),
               "short_center": {8: jnp.asarray(assets_np["short/8"])},
               "trans": {8: jnp.asarray(assets_np["trans/16/8"])}}
    signs = [np.where(rng.rand(k) < 0.5, 1.0, -1.0).astype(np.float32) for k in (16, 8)]

    def j_loss(il, tl):
        short = [{k: j_heads.softmax_pair_quantize(x @ t) for k, t in jassets["trans"].items()}
                 for x in (il, tl)]
        return j_twdh.twdh_loss(jax.random.PRNGKey(0), il, tl, *short, jnp.asarray(labels),
                                jassets, low_rate=0.5)
    orig = jax.random.randint
    j_draws = list(signs)
    jax.random.randint = lambda key, shape, lo, hi, *a, **kw: jnp.asarray(
        (j_draws.pop(0) + 1) / 2, jnp.int32)
    try:
        (jl, jm), jg = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(
            *map(jnp.asarray, longs))
    finally:
        jax.random.randint = orig

    tassets = {"long_center": torch.from_numpy(assets_np["long/16"]),
               "short_center": {"8": torch.from_numpy(assets_np["short/8"])},
               "trans": {"8": torch.from_numpy(assets_np["trans/16/8"])}}
    t_draws = list(signs)
    il, tl = (torch.tensor(x, requires_grad=True) for x in longs)
    short = [{k: t_method.softmax_pair_quantize(x @ t)
              for k, t in t_twdh.int_keys(tassets["trans"]).items()} for x in (il, tl)]
    random_center = t_twdh.random_center
    t_twdh.random_center = lambda gen, k, device: torch.from_numpy(t_draws.pop(0))
    try:
        loss, m = t_twdh.twdh_loss(il, tl, *short, torch.from_numpy(labels), tassets, None,
                                   low_rate=0.5)
    finally:
        t_twdh.random_center = random_center
    loss.backward()
    assert not j_draws and not t_draws
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    for k in jm:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-6, err_msg=k)
    for got, want in ((il.grad, jg[0]), (tl.grad, jg[1])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=5e-3 * np.abs(want).max())


def _assets_two_shorts(path, n_class=H.N_CLASS, long_bits=16, seed=3, write=True):
    """Centres of a 16-bit long code with short lengths 8 and 16: written
    to ``path``, or returned as arrays with ``write=False``."""
    r = np.random.RandomState(seed)
    arrays = {f"long/{long_bits}":
              (r.randint(0, 2, (n_class, long_bits)) * 2 - 1).astype(np.float32)}
    for s in (8, 16):
        arrays[f"short/{s}"] = (r.randint(0, 2, (n_class, s)) * 2 - 1).astype(np.float32)
        arrays[f"trans/{long_bits}/{s}"] = r.randn(2 * long_bits, 2 * s).astype(np.float32)
    if not write:
        return arrays
    np.savez(path, **arrays)
    return path


def test_twdh_npz_round_trip_keeps_the_short_lengths_in_order(tmp_path):
    """After an ``.npz`` round trip the assets' code lengths come back as
    the strings "8" and "16" ("16" sorts first); the loss reads them as
    int and gives the same value, draws and all, as the int-keyed assets."""
    from ccmh_torch.clip.model import ClipConfig, init_clip_params
    from ccmh_torch.config import Config

    cfg = Config(method="TwDH", output_dim=16, nclass=H.N_CLASS, max_words=H.MAX_WORDS)
    cfg.twdh.center_path = _assets_two_shorts(str(tmp_path / "two.npz"))
    cfg.twdh.low_rate = 1.0
    clip = ClipConfig.tiny()
    gen = torch.Generator().manual_seed(0)
    heads, _, aux = t_method.METHOD.init(gen, cfg, clip)
    params = {"clip": init_clip_params(gen, clip), **heads}
    path = str(tmp_path / "m.npz")
    save_checkpoint(path, params, aux=aux)
    back = params_from_jax(load_checkpoint(path)["aux"], device="cpu")
    assert sorted(back["assets"]["trans"]) == ["16", "8"]
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in H.batches(seed=2, n=1)[0].items()}
    loss_fn = t_method.METHOD.make_loss_fn(cfg, clip)
    losses = []
    for a in (aux, back):
        with torch.no_grad():
            loss, (_, m) = loss_fn(params, None, a, batch, torch.Generator().manual_seed(7))
        losses.append((loss.item(), m["short8_nce"].item(), m["short16_nce"].item()))
    assert losses[0] == losses[1]
    assert np.isfinite(losses[0]).all()


def test_twdh_trains_through_the_cli_and_both_packages_serve_it(tmp_path):
    """TwDH trains on the CPU through ``python -m ccmh_torch.cli``; its
    ``.npz`` (assets and BatchNorm state in aux) serves the trainer's codes
    through ``Retriever`` with no asset file, in chunks of the eval batch,
    and ccmh restores it and encodes the same codes."""
    from ccmh.clip.model import ClipConfig as JClip, init_clip_params
    from ccmh.train.state import init_state, make_main_optimizer
    from ccmh.train.trainer import restore_state
    from ccmh_torch.cli import main as torch_main
    from ccmh_torch.config import Config
    from ccmh_torch.data.synthetic import write_synthetic_mat_dataset, write_synthetic_twdh_assets
    from ccmh_torch.retrieval import Retriever

    data = write_synthetic_mat_dataset(str(tmp_path / "data"), n=24, n_class=H.N_CLASS,
                                       resolution=32, seed=3)
    assets = write_synthetic_twdh_assets(str(tmp_path / "centres.npz"), n_class=H.N_CLASS)
    trainer = torch_main(["--method", "TwDH", "--dataset", "synthetic", "--output-dim",
                          str(H.K), "--data-dir", data, "--save-dir", str(tmp_path / "out"),
                          "--epochs", "1", "--batch-size", "6", "--query-num", "6",
                          "--train-num", "12", "--eval-batch", "6", "--clip-arch", "tiny",
                          "--save-model", "--num-workers", "1", "--device", "cpu",
                          "--set", f"twdh.center_path={assets}"])
    with open(os.path.join(trainer.cfg.save_dir, "metrics.jsonl")) as fh:
        events = {r["event"] for r in map(json.loads, fh)}
    assert {"valid", "valid_long", "valid_short8"} <= events
    saved = os.path.join(trainer.cfg.save_dir, "model-0.npz")
    retriever = Retriever.from_pretrained(
        Config(method="TwDH", output_dim=H.K, max_words=trainer.cfg.max_words,
               dataset="synthetic", pretrained=saved), device="cpu")
    q_img, q_txt, _ = trainer.get_code(trainer.query_loader, len(trainer.query_data))
    batches = list(trainer.query_loader)
    images = np.concatenate([b["image"] for b in batches])
    texts = np.concatenate([b["text"] for b in batches])
    np.testing.assert_array_equal(retriever.encode_images(images, batch_size=6), q_img)
    np.testing.assert_array_equal(retriever.encode_texts(texts), q_txt)

    jcfg, _ = H.configs("TwDH", sets={"twdh.center_path": assets})
    jmethod = H.j_get_method("TwDH")
    tiny = JClip.tiny()
    heads, extra, aux = jmethod.init(jax.random.PRNGKey(1), jcfg, tiny)
    jparams = {"clip": init_clip_params(jax.random.PRNGKey(0), tiny), **heads}
    jstate = init_state(jax.random.PRNGKey(2), jparams, extra, aux,
                        make_main_optimizer(jcfg, jparams, 2), None)
    state = restore_state(saved, jstate, "TwDH", tiny)
    j_img, j_txt = jmethod.encode(state.params, state.aux,
                                  {"image": jnp.asarray(images), "text": jnp.asarray(texts)},
                                  jcfg, tiny)
    np.testing.assert_array_equal(np.asarray(j_img), q_img)
    np.testing.assert_array_equal(np.asarray(j_txt), q_txt)


def test_port_assets_are_ccmhs_byte_for_byte():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    names = sorted(os.listdir(os.path.join(repo, "ccmh", "assets", "twdh")))
    assert names == ["coco.npz", "mirflickr.npz", "nuswide.npz"]
    for name in names:
        with open(os.path.join(repo, "ccmh", "assets", "twdh", name), "rb") as a, \
                open(os.path.join(repo, "ccmh_torch", "assets", "twdh", name), "rb") as b:
            assert a.read() == b.read(), name


def test_shipped_assets_load_as_ccmh_loads_them():
    """``load_twdh_assets`` reads the port's copy as ccmh reads its own."""
    from ccmh.losses.twdh import load_twdh_assets as j_load

    for dataset, long_dim in (("flickr", 512), ("coco", 128), ("nuswide", 1024)):
        got, want = t_twdh.load_twdh_assets(dataset, long_dim), j_load(dataset, long_dim)
        np.testing.assert_array_equal(got["long_center"].numpy(), np.asarray(want["long_center"]))
        for part in ("short_center", "trans"):
            assert sorted(got[part]) == sorted(want[part])
            for k in got[part]:
                np.testing.assert_array_equal(got[part][k].numpy(), np.asarray(want[part][k]))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_twdh_on_cuda_raises_without_a_card(tmp_path):
    from ccmh_torch.config import Config
    from ccmh_torch.train.trainer import Trainer

    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(Config(method="TwDH", data_dir=str(tmp_path), save_dir=str(tmp_path)),
                device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        t_twdh.load_twdh_assets("flickr", 512, device="cuda")
