"""Resume after a real SIGTERM and after an asynchronous save
(tests/torch_resume_harness.py: bit for bit against the uninterrupted
run), and the exact-recheck decisions a resumed run takes.
"""

import pytest
import torch

from ccmh_torch.train import trainer as trainer_mod
from ccmh_torch.train.trainer import Trainer
from tests.torch_resume_harness import (  # noqa: F401 -- fixtures
    METHODS, check_resumed_run, data, make_trainer, metric_rows, one_thread,
)


@pytest.mark.parametrize("case", ["sigterm", "async"])
@pytest.mark.parametrize("method", list(METHODS))
def test_resumed_run_equals_the_uninterrupted_run(method, case, data, tmp_path,
                                                  tmp_path_factory, monkeypatch):
    check_resumed_run(method, case, data, tmp_path, tmp_path_factory, monkeypatch)


def test_resume_keeps_the_exact_recheck_decisions(data, tmp_path, monkeypatch):
    """``ccmh`` saves neither the hist maxima nor the observed |exact - hist|
    bias, so after a resume it stops the exact rechecks that an
    uninterrupted run takes.  The port saves them.  Scripted metrics make
    the two estimates differ: hist 0.50, 0.52, 0.40 by epoch, exact = hist +
    0.10.  Epoch 0 rechecks (bias 0.10 > 0.02); epoch 1's hist 0.52 is
    within the margin of the hist max 0.50 but not of the exact max 0.60,
    so only the bias keeps the recheck and the row reads 0.62."""
    hist = {0: 0.50, 1: 0.52, 2: 0.40}
    current = {}
    orig_valid = Trainer.valid

    def valid(self, epoch):
        current["epoch"] = epoch
        return orig_valid(self, epoch)

    def fake_4way(*a, **kw):
        return tuple(torch.tensor(hist[current["epoch"]] + d) for d in (0.0, 0.01, 0.2, 0.3))

    def fake_exact(q, r, *a, **kw):
        return torch.tensor(hist[current["epoch"]] + 0.10)

    monkeypatch.setattr(Trainer, "valid", valid)
    monkeypatch.setattr(trainer_mod, "calc_map_4way", fake_4way)
    monkeypatch.setattr(trainer_mod, "calc_map", fake_exact)

    def rows(tr):
        return [(r["epoch"], round(r["i2t"], 6), round(r["t2i"], 6))
                for r in metric_rows(tr) if r["event"] == "valid"]

    flags = ("--epochs", "3", "--checkpoint-every", "1")
    whole = make_trainer(data, tmp_path / "whole", *flags)
    whole.run()
    assert rows(whole) == [(0, 0.6, 0.6), (1, 0.62, 0.62), (2, 0.4, 0.41)]

    def resumed(out, drop_trackers):
        first = make_trainer(data, out, *flags)
        first.train_epoch(0)
        first.valid(0)
        if drop_trackers:     # what ccmh's slot holds
            for name in ("_max_hist_i2t", "_max_hist_t2i", "_hist_bias"):
                setattr(first, name, 0.0)
        first.save_full_checkpoint(0)
        tr = make_trainer(data, out, *flags, "--resume")
        tr.run()
        return rows(tr)

    assert resumed(tmp_path / "kept", drop_trackers=False) == rows(whole)
    # without the trackers, epoch 1 takes the hist estimate: ccmh's fault
    assert resumed(tmp_path / "dropped", drop_trackers=True)[1] == (1, 0.52, 0.53)
