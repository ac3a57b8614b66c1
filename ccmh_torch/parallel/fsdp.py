"""Fully-sharded data parallelism (FSDP) for the CLIP towers (port of
``ccmh/parallel/fsdp.py``).

Plain data parallelism holds every parameter, its gradient and both of
BertAdam's moments whole on every rank: 16 bytes a parameter in fp32,
2.42 GB for the ViT-B/32 towers and 6.84 GB for ViT-L/14.  FSDP keeps each
large tower leaf, its gradient and its moments as one contiguous chunk per
data rank, so that this residency divides by the data degree.

The sharding rule is ``ccmh``'s (:func:`spec_for_leaf`): a leaf under
``clip`` with at least :data:`MIN_SHARD_ELEMS` elements takes the data axis
on its largest dimension that the data degree divides, never the layer
axis of the stacked ``blocks``, and never the dimension the Megatron specs
(``parallel/tp.py``) give the model axis; the choice is made on the
leaf's canonical shape.  Everything else is replicated: smaller leaves,
the heads, ``extra`` and ``aux``.  BertAdam's moments follow their
parameters, since they are made at the parameter's (local) shape.

``ccmh`` annotates shardings and lets GSPMD insert the collectives.  The
port writes them out, with ``ccmh``'s data-parallel semantics
(``parallel/mesh.py``) restricted to a shard:

* every read of a sharded leaf in the towers goes through
  :func:`full` or, for a layer of the stacked blocks, :func:`layer`: an
  all-gather over the data group forward (of the shard cast to the
  towers' dtype, so bf16 towers move half the bytes), and in backward a
  reduce-scatter (SUM, in the shard's own dtype) of the gradient, since
  each rank's towers saw only its rows;
* a gathered weight does not live from forward to backward: the towers
  run under :func:`regather_in_backward`, whose saved-tensor hooks keep
  the shard in place of a gathered weight (or a view of one) and gather it
  again when the backward unpacks it; every rank runs the same graph, so
  the gathers come in the same order on every rank.  Under ``--remat``
  the gather sits inside the checkpointed block and the recompute gathers
  again;
* ``sync_gradients`` skips the sharded leaves; BertAdam's clip norms and
  the global norm sum their squares over the axes a leaf is sharded on.

Collectives run over NCCL (``all_gather_into_tensor`` /
``reduce_scatter_tensor``) on the card.  Gloo gathers no CUDA tensors and
has no reduce-scatter: a gather there is ``gather_tensor``'s zero-slot
``all_reduce``, and a reduce-scatter an ``all_reduce`` and this rank's
slice (exactly the sum plain data parallelism takes).

Composed with tensor parallelism, a leaf is sharded over the model axis
first (``tp.shard_clip``) and then over the data axis on its local tensor;
the canonical tree comes back in the reverse order.  Checkpoints stay
canonical (:func:`canonical_clip`, :func:`unshard_optimizer_state`), so
FSDP, DP, TP and single-device runs interchange them.
"""

from __future__ import annotations

import contextlib
import math
import weakref
from typing import TYPE_CHECKING, Any, Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ccmh_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, Mesh, active_mesh, copy_marks, gather_tensor, mark_shard,
    shard_axes,
)
from ccmh_torch.parallel import tp as tp_mod

if TYPE_CHECKING:
    from ccmh_torch.clip.model import ClipConfig

__all__ = ["MIN_SHARD_ELEMS", "spec_for_leaf", "shard_fsdp", "unshard_fsdp", "full",
           "layer", "regather_in_backward", "all_gather_shard", "reduce_scatter_shard",
           "local_clip", "canonical_clip", "unshard_optimizer_state"]

# leaves below 2^16 elements (256 KB in fp32) stay replicated: LayerNorm
# scales, biases and the small embeddings, whose gather per layer would
# cost more in latency than it saves in memory (ccmh's constant)
MIN_SHARD_ELEMS = 1 << 16


def spec_for_leaf(path: Sequence[Any], shape: Sequence[int], dp: int, tp: int = 1
                  ) -> Tuple[Optional[str], ...]:
    """The mesh axis of each dimension of the leaf at ``path`` (dict keys
    from the state's root, e.g. ``("clip", "text", "blocks", "attn",
    "qkv_w")``) with canonical ``shape``: ``"model"`` on the Megatron
    dimension of a block leaf under a model axis, ``"data"`` on the
    dimension FSDP shards, else None.  ``ccmh``'s ``_spec_for_leaf``."""
    shape = tuple(int(n) for n in shape)
    spec: list = [None] * len(shape)
    if not shape:
        return ()
    in_clip, in_blocks = "clip" in path, "blocks" in path
    if tp > 1 and in_clip and in_blocks and len(path) >= 2:
        axis = tp_mod._TP_BLOCK_SPECS.get((path[-2], path[-1]))
        # the specs are of the stacked [n_layers, ...] leaves: weights 3-D,
        # biases 2-D
        if axis is not None and len(shape) == (3 if str(path[-1]).endswith("_w") else 2):
            spec[axis] = MODEL_AXIS
    if not in_clip or dp <= 1 or math.prod(shape) < MIN_SHARD_ELEMS:
        return tuple(spec)
    # the layer axis of the stacked blocks is sliced per layer, never
    # sharded; of the rest, the largest free dimension the data degree
    # divides (the first of equal ones)
    start = 1 if in_blocks else 0
    for d in sorted(range(start, len(shape)), key=lambda i: -shape[i]):
        if spec[d] is None and shape[d] % dp == 0:
            spec[d] = DATA_AXIS
            break
    return tuple(spec)


def _canonical_shape(leaf: torch.Tensor, tp: int) -> Tuple[int, ...]:
    shape = list(leaf.shape)
    dim = shard_axes(leaf).get(MODEL_AXIS)
    if dim is not None:
        shape[dim] *= tp
    return tuple(shape)


def _walk(tree: Any, fn, path: Tuple[Any, ...]) -> Any:
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


# -------------------------------------------------------------- collectives

def all_gather_shard(shard: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The whole leaf from each data rank's chunk of it along ``dim``
    (rank order), contiguous.  No autograd."""
    parts = gather_tensor(shard, mesh.data_group, mesh.dp, mesh.data_rank)
    shape = list(shard.shape)
    shape[dim] *= mesh.dp
    return parts.movedim(0, dim).reshape(shape).contiguous()


def reduce_scatter_shard(whole: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This data rank's chunk along ``dim`` of the SUM of ``whole`` over
    the data group.  No autograd; ``whole`` is not modified."""
    n = whole.shape[dim] // mesh.dp
    if dist.get_backend(mesh.data_group) == "nccl":
        split = list(whole.shape)
        split[dim:dim + 1] = [mesh.dp, n]
        src = whole.reshape(split).movedim(dim, 0).contiguous()
        out = torch.empty(src.shape[1:], dtype=whole.dtype, device=whole.device)
        dist.reduce_scatter_tensor(out, src, group=mesh.data_group)
        return out
    total = whole.contiguous().clone()
    dist.all_reduce(total, group=mesh.data_group)
    return total.narrow(dim, mesh.data_rank * n, n).contiguous()


# gathered weights alive in a forward, by the address of their storage:
# (a weak reference to the gathered tensor, the shard, dim, mesh, dtype)
_GATHERED: Dict[int, tuple] = {}


def _remember(whole: torch.Tensor, shard: torch.Tensor, dim: int, mesh: Mesh,
              dtype: torch.dtype) -> None:
    key = whole.untyped_storage().data_ptr()

    def forget(ref, key=key):
        if _GATHERED.get(key, (None,))[0] is ref:
            del _GATHERED[key]

    _GATHERED[key] = (weakref.ref(whole, forget), shard, dim, mesh, dtype)


class _GatherShard(torch.autograd.Function):
    """All-gather of a shard cast to ``dtype`` over the data group forward;
    the gradient cast to the shard's dtype and reduce-scattered (SUM)
    backward."""

    @staticmethod
    def forward(ctx, shard, dim, mesh, dtype):
        ctx.dim, ctx.mesh, ctx.dtype = dim, mesh, shard.dtype
        return all_gather_shard(shard.detach().to(dtype), dim, mesh)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_shard(grad.to(ctx.dtype), ctx.dim, ctx.mesh), None, None, None


def _gather(shard: torch.Tensor, dim: int, dtype: torch.dtype) -> torch.Tensor:
    mesh = active_mesh()
    if mesh is None or mesh.dp == 1:
        raise RuntimeError("a leaf sharded over the data axis was read outside its mesh "
                           "(activate the mesh, or gather the tree with unshard_fsdp)")
    whole = _GatherShard.apply(shard, dim, mesh, dtype)
    if torch.is_grad_enabled() and shard.requires_grad:
        _remember(whole, shard, dim, mesh, dtype)
    return whole


def full(leaf: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``leaf`` in ``dtype`` (its own by default), gathered whole where it is
    a data-axis shard."""
    dtype = dtype or leaf.dtype
    dim = shard_axes(leaf).get(DATA_AXIS)
    if dim is None:
        return leaf.to(dtype)
    return _gather(leaf, dim, dtype)


def layer(stacked: torch.Tensor, i: int, dtype: Optional[torch.dtype] = None
          ) -> torch.Tensor:
    """Layer ``i`` of a stacked block leaf in ``dtype``, gathered whole where
    the leaf is a data-axis shard (never on its layer axis)."""
    dtype = dtype or stacked.dtype
    dim = shard_axes(stacked).get(DATA_AXIS)
    if dim is None:
        return stacked[i].to(dtype)
    return _gather(stacked[i], dim - 1, dtype)


class _Regather:
    """What a saved gathered weight packs to: the shard and how to gather
    it, and the saved tensor's view of the gathered storage."""

    __slots__ = ("shard", "dim", "mesh", "dtype", "size", "stride", "offset")

    def __init__(self, entry, t: torch.Tensor):
        _, self.shard, self.dim, self.mesh, self.dtype = entry
        self.size, self.stride, self.offset = t.size(), t.stride(), t.storage_offset()

    def unpack(self) -> torch.Tensor:
        with torch.no_grad():
            whole = all_gather_shard(self.shard.detach().to(self.dtype), self.dim, self.mesh)
        return whole.as_strided(self.size, self.stride, self.offset)


def _pack(t: torch.Tensor):
    if not _GATHERED or t.layout != torch.strided:
        return t
    entry = _GATHERED.get(t.untyped_storage().data_ptr())
    if entry is None or entry[0]() is None or t.dtype != entry[4]:
        return t
    return _Regather(entry, t)


def _unpack(packed):
    return packed.unpack() if isinstance(packed, _Regather) else packed


@contextlib.contextmanager
def regather_in_backward() -> Iterator[None]:
    """Within the block, a tensor saved for backward that is a gathered
    weight (or a view of one) is saved as its shard and gathered again when
    the backward needs it.  A no-op without a data axis or without
    autograd."""
    mesh = active_mesh()
    if mesh is None or mesh.dp == 1 or not torch.is_grad_enabled():
        yield
        return
    with torch.autograd.graph.saved_tensors_hooks(_pack, _unpack):
        yield


# ----------------------------------------------------------------- the tree

def shard_fsdp(clip_tree: dict, mesh: Mesh) -> dict:
    """This data rank's contiguous chunk of each leaf of a clip-shaped tree
    (parameters or a moment tree, canonical or already sharded over the
    model axis) that :func:`spec_for_leaf` shards, as a new tensor marked
    with its axis and dimension; the other leaves are the tree's own.  One
    data rank shards nothing."""
    if mesh.dp == 1:
        return clip_tree

    def shard(path, leaf):
        spec = spec_for_leaf(path, _canonical_shape(leaf, mesh.tp), mesh.dp, mesh.tp)
        if DATA_AXIS not in spec:
            return leaf
        dim = spec.index(DATA_AXIS)
        n = leaf.shape[dim] // mesh.dp
        chunk = leaf.detach().narrow(dim, mesh.data_rank * n, n).contiguous().clone()
        return mark_shard(copy_marks(chunk, leaf), DATA_AXIS, dim)

    return _walk(clip_tree, shard, ("clip",))


@torch.no_grad()
def unshard_fsdp(clip_tree: dict, mesh: Mesh) -> dict:
    """The clip tree with every data-axis shard gathered whole (a collective
    over the data group, which every rank must call)."""
    def gather(path, leaf):
        dim = shard_axes(leaf).get(DATA_AXIS)
        return leaf if dim is None else all_gather_shard(leaf.detach(), dim, mesh)

    return _walk(clip_tree, gather, ())


def local_clip(clip_tree: dict, cfg: "ClipConfig", mesh: Mesh, fsdp: bool) -> dict:
    """This rank's shards of a canonical clip tree (parameters or a moment
    tree): over the model axis (``tp.shard_clip``), then with ``fsdp`` over
    the data axis."""
    if mesh.tp > 1:
        clip_tree = tp_mod.shard_clip(clip_tree, cfg, mesh)
    return shard_fsdp(clip_tree, mesh) if fsdp else clip_tree


def canonical_clip(clip_tree: dict, cfg: "ClipConfig", mesh: Mesh) -> dict:
    """The canonical clip tree from this rank's shards: gathered over the
    data axis, then the model axis (collectives every rank calls)."""
    clip_tree = unshard_fsdp(clip_tree, mesh)
    return tp_mod.unshard_clip(clip_tree, cfg, mesh) if mesh.tp > 1 else clip_tree


def unshard_optimizer_state(optimizer, cfg: "ClipConfig", mesh: Mesh) -> dict:
    """``optimizer.state_dict()`` with every sharded CLIP leaf's moments
    gathered to the canonical layout (:func:`canonical_clip`), the form a
    single-device run loads.  The moments take their parameters' shard
    marks."""
    sd = optimizer.state_dict()
    for saved, live in zip(sd["param_groups"], optimizer.param_groups):
        for pid, p in zip(saved["params"], live["params"]):
            for moment in sd["state"].get(pid, {}).values():
                copy_marks(moment, p)
    return tp_mod.map_clip_moments(sd, lambda tree: canonical_clip(tree, cfg, mesh))
