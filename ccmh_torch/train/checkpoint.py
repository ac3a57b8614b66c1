"""Checkpoints: weights-only ``.npz`` interchange, full-state slots for
resume, and reference ``.pth`` weights (port of ``ccmh/train/checkpoint.py``
and of ``restore_state`` in ``ccmh/train/trainer.py``).

**Weights-only ``.npz``** in ``ccmh``'s Trainer format: flat ``a/b/c``
keys holding ``params/...`` (``params/clip/...`` plus the method's head
trees), ``extra/...``, ``aux/...`` and ``step``.  Both packages read
each other's files.

**Full state** (``--checkpoint-every``, ``--resume``, preemption): the
card's machine has no ``orbax``, so the port writes its own format with
``torch.save``: one ``state.pt`` per slot holding ``params``, ``extra``,
``aux``, the ``state_dict()`` of BertAdam and of the method's extra
optimizer, ``step``, the step generator's state, the epoch and the
trackers' ``meta``.  ``ccmh``'s crash-safety design is kept:

* epoch-named slots ``<root>/e000042``, each written under a temporary
  name and finalised by an atomic ``os.replace``, so a slot name always
  holds a complete checkpoint and :func:`latest_checkpoint` never sees an
  unfinalised one;
* the two newest slots are kept, and older ones are pruned only after the
  new slot is final;
* :class:`AsyncStateSaver` stages the tensors to host memory on the
  caller's thread, waits for the card's stream, writes the slot on one
  background thread, and prunes at the next save (or ``wait``).

An orbax ``state_ckpt`` written by ``ccmh`` is refused with the reason.

**Reference ``.pth``**: a reference trainer's ``model-<epoch>.pth`` imports
through ``clip/import_ref.py``; it holds weights (and TwDH's BatchNorm
statistics) only.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from ccmh_torch.bridge import params_to_jax
from ccmh_torch.clip.convert import flatten, unflatten

Params = Dict[str, Any]

SLOT_RE = re.compile(r"^e(\d{6})$")
KEEP_SLOTS = 2
STATE_FILE = "state.pt"
FORMAT = "ccmh_torch.full_state/1"
# files of an orbax checkpoint directory
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")


# ---------------------------------------------------------------- weights only

def load_checkpoint(path: str, method: Optional[str] = None) -> Params:
    """Read the weights of a checkpoint -> {"params", "extra", "aux", "step",
    "reference"} as numpy trees (hand them to ``bridge.params_from_jax``):
    an ``.npz``, a full-state slot or root (its weights), or a reference
    ``.pth`` of ``method`` (``reference`` True: ``aux`` then holds only the
    state-dict buffers, to update a fresh aux with)."""
    if path.endswith(".pth"):
        from ccmh_torch.clip.import_ref import import_reference_pth

        if method is None:
            raise ValueError(f"{path}: a reference .pth needs the method's name")
        params, _, aux = import_reference_pth(path, method)
        return {"params": params, "extra": None, "aux": aux, "step": 0, "reference": True}
    if os.path.isdir(path):
        tree = load_state(path)
        return {"params": params_to_jax(tree["params"]),
                "extra": params_to_jax(tree["extra"]) if tree["extra"] is not None else None,
                "aux": params_to_jax(tree["aux"]), "step": int(tree["step"]),
                "reference": False}
    with np.load(path, allow_pickle=False) as data:
        tree = unflatten({k: data[k] for k in data.files})
    if "params" not in tree:
        raise ValueError(f"{path} holds no params/... arrays (keys: {sorted(tree)})")
    return {"params": tree["params"], "extra": tree.get("extra") or None,
            "aux": tree.get("aux", {}), "step": int(tree.get("step", 0)), "reference": False}


def save_checkpoint(path: str, params: Params, extra: Optional[Params] = None,
                    aux: Optional[Params] = None, step: int = 0) -> None:
    """Write the Trainer's ``.npz`` layout from trees of tensors or arrays."""
    tree = {"params": params, "extra": extra if extra is not None else {},
            "aux": aux if aux is not None else {}, "step": np.asarray(step)}
    np.savez(path, **flatten(params_to_jax(tree)))


# ------------------------------------------------------------------ full state

def _stage(node):
    """A copy of ``node`` with every tensor copied to host memory (CUDA
    copies enqueued without blocking; the caller synchronises)."""
    if isinstance(node, dict):
        return {k: _stage(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_stage(v) for v in node)
    if isinstance(node, torch.Tensor):
        node = node.detach()
        return node.to("cpu", non_blocking=node.is_cuda, copy=True)
    return node


def pack_state(state, optimizer, extra_optimizer, epoch: int,
               meta: Optional[Dict[str, float]] = None) -> Params:
    """The full training state as a tree of host tensors: the live tensors
    copied out, after the card's stream has finished the step that wrote
    them."""
    tree = _stage({
        "format": FORMAT,
        "params": state.params, "extra": state.extra, "aux": state.aux,
        "optimizer": optimizer.state_dict(),
        "extra_optimizer": (extra_optimizer.state_dict()
                            if extra_optimizer is not None else None),
        "step": int(state.step),
        "generator": state.generator.get_state(),
        "epoch": int(epoch),
        "meta": {k: float(v) for k, v in (meta or {}).items()},
    })
    if state.generator.device.type == "cuda":
        torch.cuda.current_stream(state.generator.device).synchronize()
    return tree


def _slots(root: str):
    """Finalised slot directories under ``root``, oldest first: a slot name
    appears only through the atomic rename that finalises it."""
    if not os.path.isdir(root):
        return []
    found = []
    for name in os.listdir(root):
        m = SLOT_RE.match(name)
        if m and os.path.isdir(os.path.join(root, name)):
            found.append((int(m.group(1)), os.path.join(root, name)))
    return [p for _, p in sorted(found)]


def _write_slot(root: str, tree: Params) -> str:
    """Write ``tree`` to a temporary directory, then rename it to its epoch
    slot.  Re-saving an epoch (a mid-epoch preemption slot, then the same
    epoch's end) moves the old slot aside first: a directory replaces only
    an empty one."""
    os.makedirs(root, exist_ok=True)
    name = f"e{tree['epoch']:06d}"
    slot = os.path.join(root, name)
    tag = f"{os.getpid()}-{threading.get_ident()}"
    tmp = os.path.join(root, f".tmp-{name}-{tag}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, STATE_FILE), "wb") as fh:
        torch.save(tree, fh)
        fh.flush()
        os.fsync(fh.fileno())
    if os.path.isdir(slot):
        old = os.path.join(root, f".old-{name}-{tag}")
        os.replace(slot, old)
        os.replace(tmp, slot)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(tmp, slot)
    return slot


def _prune(root: str) -> None:
    """Keep the two newest finalised slots; drop leftovers of interrupted
    saves."""
    for old in _slots(root)[:-KEEP_SLOTS]:
        shutil.rmtree(old, ignore_errors=True)
    for name in os.listdir(root):
        if name.startswith((".tmp-", ".old-")):
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)


def save_state(ckpt_root: str, state, optimizer, extra_optimizer, epoch: int,
               meta: Optional[Dict[str, float]] = None) -> str:
    """Write a full-state checkpoint into its epoch slot, then prune; returns
    the slot.  The previous slot is deleted only after the new one is
    final, so a crash while saving never loses the last good one."""
    root = os.path.abspath(ckpt_root)
    slot = _write_slot(root, pack_state(state, optimizer, extra_optimizer, epoch, meta))
    _prune(root)
    return slot


class AsyncStateSaver:
    """Full-state saves that overlap the training after them.

    ``save`` returns once the tensors are staged in host memory (the loop
    blocks for the copies only); one background thread writes the slot.
    Pruning waits for the next ``save`` or ``wait``, after the pending
    write is final, so the two newest finalised slots exist at every
    instant.  An error of the writer is raised by the next ``save``,
    ``wait`` or ``close``."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._root: Optional[str] = None
        self._error: Optional[BaseException] = None

    def _write(self, root: str, tree: Params) -> None:
        try:
            _write_slot(root, tree)
        except BaseException as e:  # noqa: BLE001 -- handed to the caller's thread
            self._error = e

    def save(self, ckpt_root: str, state, optimizer, extra_optimizer, epoch: int,
             meta: Optional[Dict[str, float]] = None) -> str:
        self.wait()                   # finalise and prune the previous slot first
        root = os.path.abspath(ckpt_root)
        tree = pack_state(state, optimizer, extra_optimizer, epoch, meta)
        self._root = root
        self._thread = threading.Thread(target=self._write, args=(root, tree),
                                        name="ccmh-state-saver")
        self._thread.start()
        return os.path.join(root, f"e{epoch:06d}")

    def wait(self) -> None:
        """Block until the pending write is final, then prune."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        error, self._error = self._error, None
        if error is not None:
            raise error
        if self._root is not None:
            root, self._root = self._root, None
            _prune(root)

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "AsyncStateSaver":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_state(ckpt_dir: str) -> Params:
    """Read a slot written by :func:`save_state` as a tree of host tensors.
    ``ckpt_dir`` is a checkpoint root (its newest slot is read) or a slot.
    An orbax directory of ``ccmh`` raises."""
    path = os.path.abspath(ckpt_dir)
    inner = _slots(path)
    if inner:
        path = inner[-1]
    state_file = os.path.join(path, STATE_FILE)
    if not os.path.isfile(state_file):
        names = set(os.listdir(path)) if os.path.isdir(path) else set()
        if names & set(_ORBAX_MARKERS):
            raise NotImplementedError(
                f"{path} is an orbax checkpoint written by ccmh: ccmh_torch cannot read it, "
                "because the card's machine has no orbax.  Save the weights with ccmh's "
                "Trainer.save_checkpoint (an .npz) and pass that as --pretrained")
        raise FileNotFoundError(f"{path} holds no {STATE_FILE}: not a ccmh_torch "
                                "full-state checkpoint")
    tree = torch.load(state_file, map_location="cpu", weights_only=True)
    if tree.get("format") != FORMAT:
        raise ValueError(f"{state_file}: format {tree.get('format')!r}, expected {FORMAT!r}")
    return tree


def _copy_into(live: Params, saved: Params, what: str) -> None:
    """Copy a saved tree into the live leaves in place (the optimizers hold
    those tensors); the two trees must have the same leaves and shapes."""
    from ccmh_torch.train.optim import tree_leaves_with_path

    want = {p: tuple(t.shape) for p, t in tree_leaves_with_path(live)}
    got = {p: tuple(t.shape) for p, t in tree_leaves_with_path(saved)}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()), key=str)[:6]
        raise ValueError(f"the checkpoint's {what} does not fit this run: {diff}")
    saved_leaves = dict(tree_leaves_with_path(saved))
    with torch.no_grad():
        for path, leaf in tree_leaves_with_path(live):
            leaf.copy_(saved_leaves[path])


def _to(node, device: torch.device):
    if isinstance(node, dict):
        return {k: _to(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_to(v, device) for v in node]
    return node.to(device) if isinstance(node, torch.Tensor) else node


def restore_state(tree: Params, state, optimizer, extra_optimizer) -> None:
    """Put a slot's state into the live run: parameters and ``extra`` copied
    into their tensors, ``aux`` replaced, both optimizers' ``state_dict``,
    the step and the step generator's state."""
    _copy_into(state.params, tree["params"], "params")
    if (tree["extra"] is None) != (state.extra is None):
        raise ValueError("the checkpoint's extra tree does not fit this run")
    if state.extra is not None:
        _copy_into(state.extra, tree["extra"], "extra")
    if (tree["extra_optimizer"] is None) != (extra_optimizer is None):
        raise ValueError("the checkpoint's extra optimizer does not fit this run")
    optimizer.load_state_dict(tree["optimizer"])
    if extra_optimizer is not None:
        extra_optimizer.load_state_dict(tree["extra_optimizer"])
    state.aux = _to(tree["aux"], state.generator.device)
    state.step = int(tree["step"])
    state.generator.set_state(tree["generator"])


def latest_checkpoint(save_dir: str) -> Optional[str]:
    """The checkpoint root a ``--resume`` of this run directory reads, if
    any (a legacy single-directory ``state_ckpt`` too, which
    :func:`load_state` then refuses if it is orbax's)."""
    root = os.path.join(save_dir, "state_ckpt")
    if _slots(root) or (os.path.isdir(root) and any(
            not n.startswith((".tmp-", ".old-")) for n in os.listdir(root))):
        return root
    return None
