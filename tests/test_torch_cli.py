"""The whole training loop: ``python -m ccmh_torch.cli`` against
``python -m ccmh.cli`` (DCHMT, ``--clip-arch tiny``, 2 epochs with
validation) on one synthetic dataset.

The two packages' random inits differ, so both start from one
``--pretrained`` ``.npz`` written from a ccmh init.  Both log every step
(``--display-step 1``) to ``metrics.jsonl``.

Tolerances: per-step loss rtol 1e-4 (each step's parameters differ from
ccmh's by float32 rounding that BertAdam carries forward; 8 steps stay far
inside this); every logged mAP within 1e-3 (the ±1 codes are argmaxes of
select pairs, equal unless a pair's margin is within the rounding noise;
such a flip moves an mAP of 36 queries by ~1e-3 at most, and none happens
on this data).  The ``.npz`` the port saves restores in ccmh bit for bit.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from ccmh.cli import main as jax_main
from ccmh.clip.convert import save_params_npz
from ccmh.clip.model import ClipConfig as JClipConfig, init_clip_params
from ccmh.config import Config as JConfig
from ccmh.data.synthetic import write_synthetic_mat_dataset
from ccmh.train.methods import get_method
from ccmh.train.trainer import restore_state
from ccmh_torch.cli import main as torch_main
from ccmh_torch.train.optim import tree_leaves_with_path

K = 16


def _records(save_dir, event):
    with open(os.path.join(save_dir, "metrics.jsonl")) as fh:
        return [r for r in map(json.loads, fh) if r["event"] == event]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_cli_training_loop_matches_ccmh(tmp_path):
    data = write_synthetic_mat_dataset(str(tmp_path / "data"), n=60, n_class=6,
                                       resolution=32, seed=3)
    key = jax.random.PRNGKey(11)
    tiny = JClipConfig.tiny()
    heads, _, _ = get_method("DCHMT").init(jax.random.fold_in(key, 1),
                                          JConfig(output_dim=K), tiny)
    init = str(tmp_path / "init.npz")
    save_params_npz(init, jax.tree.map(np.asarray, {
        "params": {"clip": init_clip_params(key, tiny), **heads}, "step": np.int32(0)}))

    common = ["--method", "DCHMT", "--dataset", "synthetic", "--output-dim", str(K),
              "--data-dir", data, "--epochs", "2", "--batch-size", "10",
              "--query-num", "12", "--train-num", "36", "--eval-batch", "16",
              "--clip-arch", "tiny", "--pretrained", init, "--display-step", "1",
              "--save-model", "--num-workers", "2", "--lr", "1e-3", "--clip-lr", "1e-4"]
    jtr = jax_main(common + ["--save-dir", str(tmp_path / "jax")])
    ttr = torch_main(common + ["--save-dir", str(tmp_path / "torch"), "--device", "cpu"])

    jdir, tdir = jtr.cfg.save_dir, ttr.cfg.save_dir
    jtrain, ttrain = _records(jdir, "train"), _records(tdir, "train")
    assert len(ttrain) == len(jtrain) == 8          # 4 steps per epoch, ragged last
    for j, t in zip(jtrain, ttrain):
        assert t["step"] == j["step"]
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4, err_msg=f"step {t['step']}")
    jvalid, tvalid = _records(jdir, "valid"), _records(tdir, "valid")
    assert len(tvalid) == len(jvalid) == 2
    for j, t in zip(jvalid, tvalid):
        for name in ("i2t", "t2i", "i2i", "t2t"):
            np.testing.assert_allclose(t[name], j[name], atol=1e-3, err_msg=name)
    assert (ttr.best_epoch_i, ttr.best_epoch_t) == (jtr.best_epoch_i, jtr.best_epoch_t)
    assert (ttr.max_mapi2t, ttr.max_mapt2i) == pytest.approx(
        (jtr.max_mapi2t, jtr.max_mapt2i), abs=1e-3)

    # the reference log lines of both epochs
    with open(os.path.join(tdir, "train.log")) as fh:
        log = fh.read()
    for epoch in (0, 1):
        assert f"[{epoch}/2], MAP(i->t): " in log and "MAP(t->i): " in log

    # the port's .npz restores in ccmh, bit for bit
    saved = os.path.join(tdir, "model-1.npz")
    state = restore_state(saved, jtr.state, "DCHMT", tiny)
    for path, leaf in tree_leaves_with_path(ttr.state.params):
        np.testing.assert_array_equal(np.asarray(_get(state.params, path)),
                                      leaf.detach().numpy(), err_msg=str(path))
    assert int(state.step) == 8



@pytest.mark.parametrize("method", ["DSPH", "DNpH", "DDBH", "DMsH_LN", "DScPH", "DDWSH"])
def test_linear_hash_methods_train_and_save_through_the_cli(tmp_path, method):
    """Each LinearHash method trains 2 epochs on the CPU with the tiny tower
    and saves a ``.npz`` that ``Retriever.from_pretrained`` serves: the
    restored model encodes the query split to the trainer's own codes."""
    from ccmh_torch.config import Config
    from ccmh_torch.retrieval import Retriever

    data = write_synthetic_mat_dataset(str(tmp_path / "data"), n=30, n_class=5,
                                       resolution=32, seed=4)
    trainer = torch_main(["--method", method, "--dataset", "synthetic", "--output-dim", str(K),
                          "--data-dir", data, "--save-dir", str(tmp_path / "out"),
                          "--epochs", "2", "--batch-size", "6", "--query-num", "6",
                          "--train-num", "12", "--eval-batch", "6", "--clip-arch", "tiny",
                          "--display-step", "1", "--save-model", "--num-workers", "1",
                          "--device", "cpu"])
    losses = [r["loss"] for r in _records(trainer.cfg.save_dir, "train")]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert len(_records(trainer.cfg.save_dir, "valid")) == 2
    assert (trainer.state.extra is not None) == (method == "DSPH")

    saved = os.path.join(trainer.cfg.save_dir, "model-1.npz")
    retriever = Retriever.from_pretrained(
        Config(method=method, output_dim=K, max_words=trainer.cfg.max_words, pretrained=saved),
        device="cpu")
    q_img, q_txt, _ = trainer.get_code(trainer.query_loader, len(trainer.query_data))
    batches = list(trainer.query_loader)
    np.testing.assert_array_equal(
        retriever.encode_images(np.concatenate([b["image"] for b in batches])), q_img)
    np.testing.assert_array_equal(
        retriever.encode_texts(np.concatenate([b["text"] for b in batches])), q_txt)


@pytest.mark.parametrize("method", ["DHaPH", "DPSIH", "MITH"])
def test_token_methods_train_and_save_through_the_cli(tmp_path, method):
    """DHaPH, DPSIH and MITH each train 2 epochs on the CPU with the tiny
    tower (DHaPH with 24 proxies and top-3 mining for the 6-item batches)
    and save a ``.npz`` that ``Retriever.from_pretrained`` serves: the
    restored model encodes the query split to the trainer's own codes, and
    a search ranks with the method's distance (DPSIH's multi-embed one)."""
    from ccmh_torch.config import Config
    from ccmh_torch.retrieval import Retriever

    data = write_synthetic_mat_dataset(str(tmp_path / "data"), n=30, n_class=5,
                                       resolution=32, seed=4)
    trainer = torch_main(["--method", method, "--dataset", "synthetic", "--output-dim", str(K),
                          "--data-dir", data, "--save-dir", str(tmp_path / "out"),
                          "--epochs", "2", "--batch-size", "6", "--query-num", "6",
                          "--train-num", "12", "--eval-batch", "6", "--clip-arch", "tiny",
                          "--display-step", "1", "--save-model", "--num-workers", "1",
                          "--set", "dhaph.n_proxies=24", "--set", "dhaph.topk=3",
                          "--device", "cpu"])
    losses = [r["loss"] for r in _records(trainer.cfg.save_dir, "train")]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert len(_records(trainer.cfg.save_dir, "valid")) == 2
    assert (trainer.state.extra is not None) == (method == "DHaPH")
    assert (trainer.eval_dist_fn is not None) == (method == "DPSIH")

    saved = os.path.join(trainer.cfg.save_dir, "model-1.npz")
    retriever = Retriever.from_pretrained(
        Config(method=method, output_dim=K, max_words=trainer.cfg.max_words, pretrained=saved),
        device="cpu")
    q_img, q_txt, _ = trainer.get_code(trainer.query_loader, len(trainer.query_data))
    assert q_img.shape[1] == (4 * K if method == "DPSIH" else K)
    batches = list(trainer.query_loader)
    codes = retriever.encode_images(np.concatenate([b["image"] for b in batches]))
    np.testing.assert_array_equal(codes, q_img)
    np.testing.assert_array_equal(
        retriever.encode_texts(np.concatenate([b["text"] for b in batches])), q_txt)
    # text -> image search over the query images ranks by the method's distance
    index = retriever.build_image_index(codes=codes)
    dist, idx = index.search(q_txt, k=3)
    want = (trainer.eval_dist_fn or (lambda q, r: (K - q.float() @ r.float().T) / 2))(
        torch.from_numpy(q_txt), torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(dist, np.take_along_axis(want, idx, 1).astype(np.int32))
    assert (dist == np.sort(want, 1)[:, :3]).all()


@pytest.mark.parametrize("flags", [
    ["--test"], ["--resume"], ["--checkpoint-every", "1"], ["--mesh", "2"], ["--fsdp"],
    ["--cache-images"], ["--remat"], ["--profile"], ["--set", "optim_moments_dtype=bfloat16"],
], ids=lambda f: f[0].lstrip("-") + (f[1] if len(f) > 1 and f[0] == "--set" else ""))
def test_unported_flags_raise_instead_of_being_ignored(tmp_path, flags):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        torch_main(["--data-dir", str(tmp_path), "--save-dir", str(tmp_path), "--device", "cpu",
                    "--clip-arch", "tiny", *flags])


def test_the_cli_runs_on_cuda_unless_asked_for_cpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    data = write_synthetic_mat_dataset(str(tmp_path / "data"), n=20, resolution=32)
    with pytest.raises(RuntimeError, match="cuda"):
        torch_main(["--data-dir", data, "--save-dir", str(tmp_path), "--clip-arch", "tiny",
                    "--query-num", "4", "--train-num", "8"])
