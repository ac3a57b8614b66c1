"""Shared harness of the resume tests (tests/test_torch_resume.py and
tests/test_torch_resume_signals.py): a method runs twice from one seed on
the tiny tower (K=16, 2 epochs of 3 steps, validation every epoch), once
uninterrupted and once cut and resumed through ``ccmh_torch.cli.main`` with
``--resume``, and the two end bit for bit equal: every parameter,
``extra`` and ``aux`` leaf, both optimizers' ``state_dict``, the step
generator's state, the step, and every ``train`` and ``valid`` row of
``metrics.jsonl`` (the encoder timings aside).  The methods cover the
optimizer states: DSPH (the proxies' SGD), DNPH with
``dnph.step_proxies`` (SGD), DGHDGH sequenced (the two-group Adam, the
method's own step), TwDH (BatchNorm statistics in ``aux``) and DDWSH
(miner draws from the step generator).

The cuts (``CUTS``):

* ``epoch``: the process dies at the start of epoch 1, after epoch 0's
  ``--checkpoint-every 1`` slot;
* ``preempt``: ``request_preempt`` after global step 4 (epoch 1, step 1);
* ``sigterm``: a real SIGTERM to the process after global step 2;
* ``async``: ``--async-checkpoint``, preempted at epoch 0's last step;
* ``async_sigterm``: ``--async-checkpoint``, a real SIGTERM after global
  step 5 (epoch 1, step 2).
"""

import json
import os
import signal
import sys
import threading

import pytest
import torch

from ccmh_torch.cli import main as torch_main
from ccmh_torch.data.synthetic import write_synthetic_mat_dataset, write_synthetic_twdh_assets
from ccmh_torch.train import checkpoint as ck
from ccmh_torch.train import trainer as trainer_mod
from ccmh_torch.train.trainer import Trainer

K = 16
N_CLASS = 5
TIMINGS = ("time", "q_encoder_time", "r_encoder_time")
METHODS = {
    "DSPH": [],
    "DNPH": ["--set", "dnph.step_proxies=True"],
    "DGHDGH": ["--set", "dghdgh.sequenced=True"],
    "TwDH": ["--set", "twdh.center_path={twdh}"],
    "DDWSH": [],
}
# where each cut leaves its newest slot: (epoch, steps done in it)
CUTS = {"epoch": (0, 0), "preempt": (1, 1), "sigterm": (0, 2), "async": (0, 3),
        "async_sigterm": (1, 2)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Each run is many tiny ops and a metrics row a step: one intra-op
    thread, and no TensorBoard mirror of the rows (``MetricsWriter`` skips
    it without ``tensorboardX``; its flush a row waits on a writer thread),
    keep them from contending with the other test workers.  Both runs of a
    case take the same settings, and the jsonl rows stay."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as m:
        m.setitem(sys.modules, "tensorboardX", None)
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("resume_data")
    path = write_synthetic_mat_dataset(str(root / "data"), n=24, n_class=N_CLASS,
                                       resolution=32, seed=6)
    twdh = write_synthetic_twdh_assets(str(root / "twdh.npz"), n_class=N_CLASS,
                                       long_bits=K, short_bits=8)
    return path, twdh


def _argv(method, data, save_dir, *flags):
    path, twdh = data
    sets = [a.format(twdh=twdh) for a in METHODS[method]]
    return ["--method", method, "--dataset", "synthetic", "--output-dim", str(K),
            "--data-dir", path, "--save-dir", str(save_dir), "--epochs", "2",
            "--batch-size", "4", "--query-num", "6", "--train-num", "12",
            "--eval-batch", "6", "--clip-arch", "tiny", "--display-step", "1",
            "--num-workers", "1", "--device", "cpu", *sets, *flags]


def metric_rows(trainer):
    with open(os.path.join(trainer.cfg.save_dir, "metrics.jsonl")) as fh:
        return [{k: v for k, v in r.items() if k not in TIMINGS} for r in map(json.loads, fh)]


def _assert_same(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_same(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{what}[{i}]")
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got.detach(), want.detach()), what
    else:
        assert got == want, what


def _assert_same_run(got, want):
    for name in ("params", "extra", "aux"):
        _assert_same(getattr(got.state, name), getattr(want.state, name), name)
    _assert_same(got.optimizer.state_dict(), want.optimizer.state_dict(), "optimizer")
    assert (got.extra_optimizer is None) == (want.extra_optimizer is None)
    if want.extra_optimizer is not None:
        _assert_same(got.extra_optimizer.state_dict(), want.extra_optimizer.state_dict(),
                     "extra_optimizer")
    assert torch.equal(got.state.generator.get_state(), want.state.generator.get_state())
    assert got.state.step == want.state.step == 6
    assert metric_rows(got) == metric_rows(want)


_UNINTERRUPTED = {}


def _uninterrupted(method, data, tmp_path_factory):
    if method not in _UNINTERRUPTED:
        out = tmp_path_factory.mktemp(f"whole_{method}")
        _UNINTERRUPTED[method] = torch_main(_argv(method, data, out))
    return _UNINTERRUPTED[method]


class _Crash(Exception):
    pass


def _crash(state):
    raise _Crash()


def _cut_at(monkeypatch, step, action):
    """Run ``action(state)`` once the train step that makes global step
    ``step`` returns (``step`` < 0: just before global step -step runs)."""
    make = trainer_mod.make_train_step

    def make_cut(*args, **kw):
        inner = make(*args, **kw)

        def step_fn(state, batch):
            if step < 0 and state.step == -step - 1:
                action(state)
            state, metrics = inner(state, batch)
            if step > 0 and state.step == step:
                action(state)
            return state, metrics
        return step_fn

    monkeypatch.setattr(trainer_mod, "make_train_step", make_cut)


def _cut_run(case, method, data, out, monkeypatch):
    """The first, cut run of ``case``; returns the flags the resume adds."""
    flags = ["--checkpoint-every", "1"] + (["--async-checkpoint"] if case.startswith("async")
                                           else [])
    holder = {}
    with monkeypatch.context() as m:
        if case == "epoch":
            _cut_at(m, -4, _crash)
            with pytest.raises(_Crash):
                torch_main(_argv(method, data, out, *flags))
            return flags, 0, 0
        if case in ("sigterm", "async_sigterm"):
            assert threading.current_thread() is threading.main_thread()
            _cut_at(m, 2 if case == "sigterm" else 5,
                    lambda st: os.kill(os.getpid(), signal.SIGTERM))
        else:
            at = {"preempt": 4, "async": 3}[case]
            orig_init = Trainer.__init__

            def init(self, *a, **kw):
                orig_init(self, *a, **kw)
                holder["trainer"] = self
            m.setattr(Trainer, "__init__", init)
            _cut_at(m, at, lambda st: holder["trainer"].request_preempt())
        cut = torch_main(_argv(method, data, out, *flags))
    slot = ck.load_state(os.path.join(cut.cfg.save_dir, "state_ckpt"))
    return flags, slot["epoch"], int(slot["meta"]["step_in_epoch"])


def check_resumed_run(method, case, data, out, tmp_path_factory, monkeypatch):
    """Cut ``method``'s run as ``case`` says, resume it, and hold it to the
    uninterrupted run."""
    want = _uninterrupted(method, data, tmp_path_factory)
    flags, epoch, step_in_epoch = _cut_run(case, method, data, out, monkeypatch)
    assert (epoch, step_in_epoch) == CUTS[case]
    got = torch_main(_argv(method, data, out, *flags, "--resume"))
    with open(os.path.join(got.cfg.save_dir, "train.log")) as fh:
        log = fh.read()
    if step_in_epoch:
        assert f"fast-forwarding {step_in_epoch} steps" in log
    _assert_same_run(got, want)


def make_trainer(data, out, *flags, method="DSPH"):
    from ccmh_torch.cli import config_from_args
    from ccmh_torch.clip.model import ClipConfig

    return Trainer(config_from_args(_argv(method, data, out, *flags)),
                   clip_cfg=ClipConfig.tiny(), device="cpu")
