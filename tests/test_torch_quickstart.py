"""The port's walkthrough and training split on the CPU.

* ``examples/quickstart_torch.py --device cpu --epochs 1`` in-process
  under ``tmp_path``, for DCHMT and for TwDH (whose class centres it
  generates): the JPEG dataset, a CLI run with full-state checkpoints
  leaving ``model-0.npz``, ``--test`` leaving the ``PR_cruve`` dump (the
  codes and the curves), and a ``Retriever`` serving a text→image top-5:
  every id a gallery row, at sorted distances in [0, bits].
* ``tools/profile_torch_training.py --device cpu``: each part of the
  step runs once at a toy tower of the family and the JSON line has
  every part's host ms, device ms, idle share and floor (the times null
  on the CPU), the floors, and a tower count equal to ``FlopCounterMode``'s.
"""

import json
import os

import numpy as np
import pytest
import scipy.io as scio

from examples import quickstart_torch
# many tiny ops: one intra-op thread and no TensorBoard mirror keep them
# from contending with the other test workers (an autouse fixture)
from tests.torch_outputs import drop_large_outputs  # noqa: F401 -- autouse
from tests.torch_resume_harness import one_thread  # noqa: F401
from tools import profile_torch_training as ptt

BITS = 16
PARTS = ("full", "towers", "heads+loss", "backward", "optimizer", "unattributed")


@pytest.mark.parametrize("method", ["DCHMT", "TwDH"])
def test_quickstart_runs_the_four_stages_on_the_cpu(method, tmp_path, capsys):
    out = quickstart_torch.main(["--device", "cpu", "--epochs", "1", "--method", method,
                                 "--bits", str(BITS), "--workdir", str(tmp_path)])
    run_dir = os.path.join(str(tmp_path), "result", method, "synthetic", str(BITS))
    assert out["run_dir"] == run_dir
    assert out["checkpoint"] == os.path.join(run_dir, "model-0.npz")
    assert os.path.isfile(out["checkpoint"])
    assert os.path.isdir(os.path.join(run_dir, "state_ckpt"))
    dump = scio.loadmat(os.path.join(run_dir, "PR_cruve", f"{BITS}-ours-synthetic-i2t.mat"))
    assert dump["q_img"].shape[1] == BITS and set(np.unique(dump["r_txt"])) <= {-1, 1}
    for direction in ("i2t", "t2i"):
        assert os.path.isfile(os.path.join(run_dir, "PR_cruve", f"curves-{direction}.mat"))
    dists, ids = out["distances"], out["ids"]
    assert dists.shape == ids.shape == (len(quickstart_torch.QUERIES), 5)
    assert ((ids >= 0) & (ids < out["gallery"])).all()
    assert all(len(set(row)) == 5 for row in ids.tolist())
    assert ((dists >= 0) & (dists <= BITS)).all()
    assert (np.diff(dists, axis=1) >= 0).all()
    printed = capsys.readouterr().out
    assert "[4/4] query 1: top-5 gallery ids" in printed


@pytest.mark.parametrize("tower", ["vit-b-32", "rn50"])
def test_training_split_prints_every_part_on_the_cpu(tower, capsys):
    row = ptt.main(["--device", "cpu", "--tower", tower])[0]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == json.loads(
        json.dumps(row))
    assert row["config"] == "tiny" and row["method"] == "DSPH" and row["dtype"] == "bfloat16"
    assert list(row["parts"]) == list(PARTS)
    for name, part in row["parts"].items():
        assert set(part) == {"host_ms", "device_ms", "idle_share", "floor_ms", "floor_share"}
        assert part["host_ms"] is None and part["device_ms"] is None
        assert (part["floor_ms"] is None) == (name == "unattributed")
    assert row["parts"]["full"]["floor_ms"] == pytest.approx(sum(
        row["parts"][n]["floor_ms"] for n in ("towers", "heads+loss", "backward", "optimizer")))
    flops = row["flops"]
    assert flops["towers_count_exact"]
    assert flops["heads_loss_fwd"] > 0 and flops["heads_loss_bwd"] > 0
    assert row["floors"]["forward"]["flops"] == flops["towers_fwd"]["total"] + flops[
        "heads_loss_fwd"]
    # BertAdam's 28 bytes a parameter, and DSPH's proxy SGD beside it
    assert row["floors"]["optimizer"]["bytes"] > 28 * row["n_params"]
    # each part ran once (the full step, the towers, the loss forward,
    # forward + backward: four tower forwards, two backwards), and the two
    # counting passes under the plain attention
    assert row["passes"] == {"fused_attention": {"forward": 4, "backward": 2},
                             "plain_attention": {"forward": 2, "backward": 2}}
    assert row["attention_layers"] == (4 if tower == "vit-b-32" else 2)
