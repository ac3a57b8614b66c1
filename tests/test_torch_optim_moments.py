"""BertAdam with bf16 moments (``--set optim_moments_dtype=bfloat16``)
against ccmh's ``bert_adam(moments_dtype=jnp.bfloat16)``, and the ViT-L/14
encode bench on the tiny tower.

* Step for step from the same numpy parameters and gradients: the moments
  are stored in bf16 and the update runs in fp32 in both (cast up,
  accumulate, cast down, then the stored moments read back).  Tolerance:
  parameters rtol 1e-6, atol 1e-7 (tests/test_torch_optim.py's: both take
  each update in fp32 with the same constants); the stored moments within
  one bf16 ulp (an fp32 sum one ulp apart may round to the neighbouring
  bf16 value).
* ccmh's bf16 moment trees (``ml_dtypes.bfloat16`` numpy arrays) load
  into the port's optimizer bit for bit.
* End to end: a DSPH run with bf16 moments, preempted mid-epoch and
  resumed with ``--resume``, ends bit for bit where the uninterrupted run
  ends, its moments still bf16 (tests/torch_resume_harness.py).
* ``python -m ccmh_torch.tools.bench_vitl --device cpu --tiny``: the loop
  runs and the analytic FLOP count is the tiny tower's.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccmh.train.optim import bert_adam
from ccmh_torch.bridge import params_from_jax, tensor_from_numpy
from ccmh_torch.cli import main as torch_main
from ccmh_torch.clip.model import ClipConfig
from ccmh_torch.tools import bench_vitl
from ccmh_torch.train import checkpoint as ck
from ccmh_torch.train.optim import bert_adam_for
from ccmh_torch.train.state import moments_dtype
from ccmh_torch.train.trainer import Trainer
from tests.torch_resume_harness import (  # noqa: F401 -- fixtures
    _argv, _assert_same_run, _cut_at, data, one_thread,
)

RTOL, ATOL = 1e-6, 1e-7
KW = dict(warmup=0.1, t_total=100, weight_decay=0.01)


def _setup(seed=0, steps=5):
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(8, 8).astype(np.float32), "b": rng.randn(8).astype(np.float32)}
    grads = [{k: (0.1 * rng.randn(*v.shape)).astype(np.float32) for k, v in params.items()}
             for _ in range(steps)]
    return params, grads


def _bf16_ulps(a, b):
    """Distance in bf16 ulps between two bf16 tensors of one sign pattern."""
    ia = a.view(torch.int16).to(torch.int32)
    ib = b.view(torch.int16).to(torch.int32)
    return int((ia - ib).abs().max())


def test_bf16_moments_match_ccmh_step_for_step():
    params, grads = _setup()
    tx = bert_adam(1e-2, moments_dtype=jnp.bfloat16, **KW)
    jp = jax.tree.map(jnp.asarray, params)
    st = tx.init(jp)
    tp = params_from_jax(params, device="cpu")
    opt = bert_adam_for(tp, 1e-2, moments_dtype=torch.bfloat16, **KW)
    for i, g in enumerate(grads):
        upd, st = tx.update(jax.tree.map(jnp.asarray, g), st, jp)
        jp = jax.tree.map(lambda a, u: a + u, jp, upd)
        for k in tp:
            tp[k].grad = torch.from_numpy(g[k])
        opt.step()
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {i} {k}")
            for name, tree in (("m", st.m), ("v", st.v)):
                got = opt.state[tp[k]][name]
                assert got.dtype == torch.bfloat16
                assert _bf16_ulps(got, tensor_from_numpy(np.asarray(tree[k]))) <= 1, (i, k, name)


def test_ccmh_bf16_moment_trees_load_bit_for_bit():
    params, grads = _setup(seed=1, steps=2)
    tx = bert_adam(1e-2, moments_dtype=jnp.bfloat16, **KW)
    jp = jax.tree.map(jnp.asarray, params)
    st = tx.init(jp)
    for g in grads:
        _, st = tx.update(jax.tree.map(jnp.asarray, g), st, jp)
    m, v = jax.tree.map(np.asarray, st.m), jax.tree.map(np.asarray, st.v)
    assert m["w"].dtype.name == "bfloat16"
    with pytest.raises(TypeError):
        torch.from_numpy(np.array(m["w"]))  # why the bridge goes through a 16-bit view
    tp = params_from_jax(params, device="cpu")
    opt = bert_adam_for(tp, 1e-2, moments_dtype=torch.bfloat16, **KW)
    opt.load_tree_state(m, v, int(st.step))
    for k in tp:
        for name, tree in (("m", m), ("v", v)):
            got = opt.state[tp[k]][name]
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          tree[k].view(np.int16))
    assert opt.param_groups[0]["step"] == 2
    # and a bf16 parameter leaf crosses params_from_jax the same way
    assert params_from_jax({"x": m["w"]}, device="cpu")["x"].dtype == torch.bfloat16


def test_moments_dtype_names():
    assert moments_dtype("float32") is None
    assert moments_dtype("bfloat16") is torch.bfloat16
    with pytest.raises(ValueError):
        moments_dtype("int8")


BF16 = ["--set", "optim_moments_dtype=bfloat16"]


def test_bf16_moments_resume_bit_for_bit(data, tmp_path, monkeypatch):
    want = torch_main(_argv("DSPH", data, tmp_path / "whole", *BF16))
    holder = {}
    flags = [*BF16, "--checkpoint-every", "1"]
    with monkeypatch.context() as m:
        orig_init = Trainer.__init__

        def init(self, *a, **kw):
            orig_init(self, *a, **kw)
            holder["trainer"] = self
        m.setattr(Trainer, "__init__", init)
        _cut_at(m, 4, lambda st: holder["trainer"].request_preempt())
        cut = torch_main(_argv("DSPH", data, tmp_path / "cut", *flags))
    slot = ck.load_state(os.path.join(cut.cfg.save_dir, "state_ckpt"))
    assert {t.dtype for t in (s["m"] for s in slot["optimizer"]["state"].values())} == {
        torch.bfloat16}
    got = torch_main(_argv("DSPH", data, tmp_path / "cut", *flags, "--resume"))
    assert {st["v"].dtype for st in got.optimizer.state.values()} == {torch.bfloat16}
    _assert_same_run(got, want)


def test_bench_vitl_runs_and_counts_the_tiny_tower(capsys):
    cfg = ClipConfig.tiny()
    B, W, T, E = 3, cfg.vision_width, bench_vitl.TEXT_LEN, cfg.embed_dim
    Lv = cfg.n_patches + 1
    by_hand = (2 * B * cfg.n_patches * 3 * cfg.vision_patch_size ** 2 * W
               + cfg.vision_layers * (2 * B * Lv * W * (3 * W + W + 8 * W) + 2 * 2 * B * Lv * Lv * W)
               + 2 * B * W * E
               + cfg.transformer_layers * (24 * B * T * cfg.transformer_width ** 2
                                           + 4 * B * T * T * cfg.transformer_width)
               + 2 * B * cfg.transformer_width * E)
    assert bench_vitl.encode_flops(cfg, B) == by_hand
    row = bench_vitl.main([str(B), "--device", "cpu", "--tiny"])
    assert row["gflop_per_pair"] == by_hand / 1e9 and row["ms"] is None
    assert row["vision_tokens"] == 5 and row["config"] == "tiny"
    assert '"tool": "bench_vitl"' in capsys.readouterr().out
    # ViT-L/14 itself: 257 vision tokens, ~428 M parameters' worth of blocks
    assert bench_vitl.encode_flops(ClipConfig.vit_l14(), 64) > 1e13
