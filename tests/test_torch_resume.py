"""Full-state checkpoints and resume (``ccmh_torch/train/checkpoint.py``,
``Trainer.try_resume``): a resumed run ends where the uninterrupted run
ends, bit for bit (tests/torch_resume_harness.py), after a crash past an
epoch's slot, after ``request_preempt`` mid-epoch and after a SIGTERM
mid-epoch with ``--async-checkpoint``; the slots' keep-2
pruning, their atomic finalisation and the refusal of ``ccmh``'s orbax
directories.  The synchronous SIGTERM and the asynchronous epoch-end cuts
are in tests/test_torch_resume_signals.py.
"""

import os

import numpy as np
import pytest

from ccmh_torch.train import checkpoint as ck
from tests.torch_outputs import drop_large_outputs  # noqa: F401 -- autouse
from tests.torch_resume_harness import (  # noqa: F401 -- fixtures
    METHODS, check_resumed_run, data, make_trainer, one_thread,
)


@pytest.mark.parametrize("case", ["epoch", "preempt", "async_sigterm"])
@pytest.mark.parametrize("method", list(METHODS))
def test_resumed_run_equals_the_uninterrupted_run(method, case, data, tmp_path,
                                                  tmp_path_factory, monkeypatch):
    check_resumed_run(method, case, data, tmp_path, tmp_path_factory, monkeypatch)


def test_two_newest_slots_are_kept_and_unfinalised_ones_skipped(data, tmp_path):
    tr = make_trainer(data, tmp_path)
    root = os.path.join(tr.cfg.save_dir, "state_ckpt")
    for epoch in range(4):
        tr.state.step = epoch
        tr.save_full_checkpoint(epoch)
    assert sorted(os.listdir(root)) == ["e000002", "e000003"]
    # a save cut short leaves a temporary directory, never a slot name
    os.makedirs(os.path.join(root, ".tmp-e000004-1-1"))
    assert ck.latest_checkpoint(tr.cfg.save_dir) == root
    assert ck.load_state(root)["epoch"] == 3
    # re-saving an epoch replaces its slot; the next save prunes leftovers
    tr.state.step = 7
    tr.save_full_checkpoint(3, step_in_epoch=1)
    assert sorted(os.listdir(root)) == ["e000002", "e000003"]
    assert ck.load_state(root)["step"] == 7
    # the asynchronous saver prunes only after its write is final
    with ck.AsyncStateSaver() as saver:
        saver.save(root, tr.state, tr.optimizer, tr.extra_optimizer, 5)
        saver.wait()
        assert sorted(os.listdir(root)) == ["e000003", "e000005"]
        saver.save(root, tr.state, tr.optimizer, tr.extra_optimizer, 6)
    assert sorted(os.listdir(root)) == ["e000005", "e000006"]
    assert ck.latest_checkpoint(str(tmp_path / "nothing")) is None


def test_an_orbax_directory_of_ccmh_is_refused(data, tmp_path):
    import orbax.checkpoint as ocp

    save_dir = tmp_path / "run"
    slot = save_dir / "state_ckpt" / "e000000"
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(str(slot), {"state": {"params": {"w": np.zeros(3, np.float32)}},
                               "epoch": np.int64(0)})
        ckptr.wait_until_finished()
    with pytest.raises(NotImplementedError, match="orbax"):
        ck.load_state(str(save_dir / "state_ckpt"))
    with pytest.raises(NotImplementedError, match="orbax"):
        ck.load_checkpoint(str(slot))
