"""Train steps of DSPH, DCHMT and DNPH on the tiny ModifiedResNet tower
of tests/test_torch_resnet.py, the port against ccmh: the loss and every
gradient at ccmh's init (its BatchNorm leaves redrawn, as there), then two
train steps, through the harness of tests/torch_extra_state_harness.py
(same numpy batches and dropout masks; DNPH replays ccmh's noise draws).
Every visual leaf moves, BatchNorm's running mean and var included: they
are trained parameters, as in ccmh.

DCHMT runs with cosine similarity and the l1 loss: its euclidean default
compares each code with itself through sqrt(|a|^2 + |a|^2 - 2 a.a), the
square root of a rounding residue on the diagonal, which moves its loss by
~1e-4 relative between any two summation orders (ccmh's and the port's
alike); tests/test_torch_train_step.py holds the euclidean variant on the
ViT tower.

Tolerances (the harness's): loss and metrics rtol 1e-5, gradients atol
1e-5 x the leaf's largest entry, params atol 2e-6 / rtol 1e-5 after each
step.
"""

import pytest
import torch

from ccmh_torch.train.optim import tree_leaves_with_path
from tests import torch_extra_state_harness as H
from tests.test_torch_resnet import J_RN, T_RN, rn_clip_params

SETS = {"DSPH": {}, "DCHMT": {"dchmt.similarity_function": "cosine", "dchmt.loss_type": "l1"},
        "DNPH": {}}


@pytest.mark.parametrize("name", sorted(SETS))
def test_train_steps_on_the_rn_tower_match_ccmh(name, monkeypatch):
    """The loss and every gradient at ccmh's init, then two train steps,
    held to ccmh's; DNPH (a method with extra state) replays ccmh's noise."""
    draws = None
    if name == "DNPH":
        from tests.test_torch_dnph import _replay_noise

        draws = _replay_noise(monkeypatch)
    H.same_masks(monkeypatch)
    jcfg, cfg = H.configs(name, sets=SETS[name])
    h = H.build(name, jcfg, cfg, jclip=J_RN, clip=T_RN, init_clip=rn_clip_params)
    visual0 = {p: leaf.detach().clone()
               for p, leaf in tree_leaves_with_path(h.state.params["clip"]["visual"])}
    data = H.batches(seed=13, n=3, res=T_RN.image_resolution)
    H.check_loss_and_grads(h, data[0])
    H.run_steps(h, data[1:])
    assert not draws
    moved = [p for p, leaf in tree_leaves_with_path(h.state.params["clip"]["visual"])
             if not torch.equal(leaf, visual0[p])]
    assert len(moved) == len(visual0)             # BatchNorm's mean and var included
