"""``--test``: ``python -m ccmh_torch.cli --test --pretrained m.npz`` against
``python -m ccmh.cli --test --pretrained m.npz`` on one ``.npz`` that ccmh
wrote (tiny tower, K=16, a synthetic dataset), for DCHMT (Hamming
ranking) and DPSIH (its multi-embed ``dist_fn``).

Held: the four exact mAPs of the log line within 4 ulps (the summation
order differs, ROADMAP's recorded departure), the ``.mat`` code dumps
equal, and the curve files equal within 1e-12 (float64 numpy on equal
integer histograms).  A run without ``--pretrained`` raises ccmh's error.
"""

import os
import re

import numpy as np
import pytest
import scipy.io as scio

import jax

from ccmh.cli import main as jax_main
from ccmh.clip.convert import save_params_npz
from ccmh.clip.model import ClipConfig as JClipConfig, init_clip_params
from ccmh.config import Config as JConfig
from ccmh.data.synthetic import write_synthetic_mat_dataset
from ccmh.train.methods import get_method
from ccmh_torch.cli import main as torch_main

K = 16
MAP_LINE = re.compile(r"MAP\(i->t\): (\S+), MAP\(t->i\): (\S+), MAP\(t->t\): (\S+), "
                      r"MAP\(i->i\): (\S+)$", re.M)


def _maps(save_dir):
    with open(os.path.join(save_dir, "test.log")) as fh:
        found = MAP_LINE.findall(fh.read())
    assert len(found) == 1
    return np.asarray(found[0], np.float64).astype(np.float32)


@pytest.mark.parametrize("method", ["DCHMT", "DPSIH"])
def test_test_mode_matches_ccmh(tmp_path, method):
    data = write_synthetic_mat_dataset(str(tmp_path / "data"), n=40, n_class=5,
                                       resolution=32, seed=8)
    key = jax.random.PRNGKey(21)
    tiny = JClipConfig.tiny()
    heads, _, _ = get_method(method).init(jax.random.fold_in(key, 1),
                                          JConfig(output_dim=K, nclass=5), tiny)
    model = str(tmp_path / "m.npz")
    save_params_npz(model, jax.tree.map(np.asarray, {
        "params": {"clip": init_clip_params(key, tiny), **heads}, "step": np.int32(0)}))

    common = ["--method", method, "--dataset", "synthetic", "--output-dim", str(K),
              "--data-dir", data, "--query-num", "10", "--train-num", "20",
              "--eval-batch", "8", "--clip-arch", "tiny", "--num-workers", "1",
              "--test", "--pretrained", model]
    jtr = jax_main(common + ["--save-dir", str(tmp_path / "jax")])
    ttr = torch_main(common + ["--save-dir", str(tmp_path / "torch"), "--device", "cpu"])
    assert (ttr.eval_dist_fn is not None) == (method == "DPSIH")
    np.testing.assert_array_max_ulp(_maps(ttr.cfg.save_dir), _maps(jtr.cfg.save_dir),
                                    maxulp=4)
    assert set(ttr.test_seconds) == {"encode", "exact_map", "curves"}

    jdir = os.path.join(jtr.cfg.save_dir, "PR_cruve")
    tdir = os.path.join(ttr.cfg.save_dir, "PR_cruve")
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == [
        f"{K}-ours-synthetic-i2t.mat", "curves-i2t.mat", "curves-t2i.mat"]
    got, want = scio.loadmat(os.path.join(tdir, f"{K}-ours-synthetic-i2t.mat")), \
        scio.loadmat(os.path.join(jdir, f"{K}-ours-synthetic-i2t.mat"))
    for name in ("q_img", "q_txt", "r_img", "r_txt", "q_l", "r_l"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert got["q_img"].shape == (10, 4 * K if method == "DPSIH" else K)
    for direction in ("i2t", "t2i"):
        got = scio.loadmat(os.path.join(tdir, f"curves-{direction}.mat"))
        want = scio.loadmat(os.path.join(jdir, f"curves-{direction}.mat"))
        for name in ("radius", "topn"):
            np.testing.assert_array_equal(got[name], want[name])
        for name in ("precision", "recall", "p_at_n"):
            np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-12,
                                       err_msg=f"{direction} {name}")


def test_test_mode_requires_pretrained(tmp_path):
    data = write_synthetic_mat_dataset(str(tmp_path / "data"), n=20, n_class=4,
                                       resolution=32, seed=9)
    with pytest.raises(RuntimeError, match="requires --pretrained"):
        torch_main(["--data-dir", data, "--save-dir", str(tmp_path / "out"), "--test",
                    "--dataset", "synthetic", "--clip-arch", "tiny", "--query-num", "4",
                    "--train-num", "8", "--num-workers", "1", "--device", "cpu"])
