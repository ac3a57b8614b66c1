"""Tensor parallelism, Megatron-style, for the ViT and text towers (port of
``ccmh/parallel/tp.py``).

The attention and MLP weights of the stacked blocks shard over the
``model`` axis of a ``(data, model)`` mesh: per-rank weight and optimizer
residency divide by ``tp``, and one example's tower work spreads over the
model ranks.  ``qkv_w``, ``qkv_b``, ``fc_w`` and ``fc_b`` are
column-parallel, ``out_w`` and ``proj_w`` row-parallel; two Megatron
functions frame each half of a block (``clip/model.py``): identity forward
and all-reduce backward before ``qkv`` and ``fc``, all-reduce forward and
identity backward after ``out`` and ``proj`` — two all-reduces a block
forward.  ``out_b`` and ``proj_b`` are added once, after the all-reduce;
LayerNorm, the embeddings and the projections stay replicated.

**The live layout differs from ``ccmh``'s on purpose.**  ``ccmh`` relayouts
the fused qkv columns head-major (``[h0(q k v) | h1(q k v) | ...]``, its
``qkv_layout="head_major"``) so that GSPMD can shard them by head, and its
head-major path then runs XLA attention, since its Pallas kernel is a
single-device program.  A model rank of the port instead holds its own
H/tp heads' columns in **local packed order** ``[q_local | k_local |
v_local]``, so the attention kernels (#1, #2) run on ``[B, L, 3D/tp]`` with
H/tp heads and ``qkv_b`` folded in, exactly as on one card.  The local
columns of model rank m are the head-major columns of its heads, put back
in packed order with H/tp heads (:func:`shard_clip`).

**Checkpoints stay canonical**: :func:`unshard_clip` gathers the shards
into ``ccmh``'s packed layout, for parameters and BertAdam's moments
alike, so a slot or ``.npz`` of a mesh run loads into a single-device run
and the reverse.  :func:`relayout_clip` / :func:`relayout_state` are
``ccmh``'s head-major permutation, bit for bit.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ccmh_torch.device import DeviceLike
from ccmh_torch.parallel.mesh import (
    MODEL_AXIS, Mesh, active_mesh, build_mesh, gather_tensor, mark_shard, shard_axes,
)

if TYPE_CHECKING:   # clip/model.py imports this module for its blocks
    from ccmh_torch.clip.model import ClipConfig

__all__ = ["make_mesh_2d", "validate", "relayout_clip",
           "relayout_state", "map_clip_subtrees", "map_clip_moments", "shard_clip",
           "unshard_clip", "copy_to_model", "reduce_from_model", "tp_mesh", "is_sharded"]


def make_mesh_2d(dp: int, tp: int, device: Optional[DeviceLike] = None) -> Mesh:
    """The ``(dp, tp)`` mesh over the process group's ``dp * tp`` ranks."""
    return build_mesh(dp, tp, device)


def validate(cfg: ClipConfig, tp: int) -> None:
    """TP requires the ViT tower and head counts divisible by ``tp`` (a head
    is not split)."""
    if cfg.is_resnet:
        raise ValueError(
            "tensor parallelism supports the ViT towers only; the "
            "ModifiedResNet tower has no head-shardable attention stack")
    for tower, heads in (("vision", cfg.vision_heads),
                         ("text", cfg.transformer_heads)):
        if heads % tp:
            raise ValueError(
                f"model-axis size {tp} must divide the {tower} tower's "
                f"{heads} attention heads")


def tp_mesh() -> Optional[Mesh]:
    """The active mesh when it has a model axis, else None."""
    mesh = active_mesh()
    return mesh if mesh is not None and mesh.tp > 1 else None


# ----------------------------------------------------------------- relayout

def _permute_qkv(attn: dict, n_head: int, to_head_major: bool) -> dict:
    """Permute stacked fused-qkv columns between the packed ``[q | k | v]``
    order and the head-major ``[h0(q k v) | ...]`` one (shape-preserving;
    parameters and optimizer moments alike)."""
    w, b = attn["qkv_w"], attn["qkv_b"]
    n_layers, width, three_w = w.shape
    dh = three_w // (3 * n_head)
    if to_head_major:
        w = (w.reshape(n_layers, width, 3, n_head, dh)
             .permute(0, 1, 3, 2, 4).reshape(n_layers, width, three_w))
        b = (b.reshape(n_layers, 3, n_head, dh)
             .permute(0, 2, 1, 3).reshape(n_layers, three_w))
    else:
        w = (w.reshape(n_layers, width, n_head, 3, dh)
             .permute(0, 1, 3, 2, 4).reshape(n_layers, width, three_w))
        b = (b.reshape(n_layers, n_head, 3, dh)
             .permute(0, 2, 1, 3).reshape(n_layers, three_w))
    return {**attn, "qkv_w": w, "qkv_b": b}


def _towers(cfg: ClipConfig):
    """(tower key, head count) of the towers with a stacked transformer."""
    out = [("text", cfg.transformer_heads)]
    if not cfg.is_resnet:
        out.insert(0, ("visual", cfg.vision_heads))
    return out


def _map_blocks(clip_tree: dict, cfg: ClipConfig, fn) -> dict:
    """``clip_tree`` with each tower's ``blocks`` replaced by
    ``fn(blocks, n_head)``."""
    out = dict(clip_tree)
    for tower, heads in _towers(cfg):
        if tower in out:
            sub = dict(out[tower])
            sub["blocks"] = fn(sub["blocks"], heads)
            out[tower] = sub
    return out


def relayout_clip(clip_tree: dict, cfg: ClipConfig, to_head_major: bool) -> dict:
    """Relayout one clip-shaped tree (parameters or a moment tree)."""
    return _map_blocks(clip_tree, cfg, lambda blocks, heads: {
        **blocks, "attn": _permute_qkv(blocks["attn"], heads, to_head_major)})


def _is_clip_tree(node: Any) -> bool:
    return (isinstance(node, dict) and isinstance(node.get("text"), dict)
            and "blocks" in node["text"])


def map_clip_subtrees(tree: Any, fn) -> Any:
    """``tree`` with every clip-shaped subtree under a ``clip`` key,
    anywhere in its dicts, lists and tuples, replaced by ``fn(subtree)``:
    the parameters and the optimizer moment trees that mirror them."""
    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            out = {k: walk(v) for k, v in node.items()}
            if _is_clip_tree(out.get("clip")):
                out["clip"] = fn(out["clip"])
            return out
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v) for v in node))
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(tree)


def relayout_state(state: Any, cfg: ClipConfig, to_head_major: bool) -> Any:
    """The qkv relayout of every clip-shaped subtree of ``state``."""
    return map_clip_subtrees(state, lambda clip: relayout_clip(clip, cfg, to_head_major))


# ----------------------------------------------------------------- sharding

# the axis of each stacked [n_layers, ...] block leaf that shards over the
# model axis (ccmh's _TP_BLOCK_SPECS): qkv and fc by output column, out
# and proj by input row
_TP_BLOCK_SPECS: Dict[Tuple[str, str], int] = {
    ("attn", "qkv_w"): 2,
    ("attn", "qkv_b"): 1,
    ("attn", "out_w"): 1,
    ("mlp", "fc_w"): 2,
    ("mlp", "fc_b"): 1,
    ("mlp", "proj_w"): 1,
}


def is_sharded(leaf: torch.Tensor) -> bool:
    """Whether ``leaf`` is a model-axis shard (:func:`shard_clip` marks them
    with their axis, ``parallel/mesh.py`` :func:`shard_axes`)."""
    return MODEL_AXIS in shard_axes(leaf)


def _shard_blocks(blocks: dict, n_head: int, tp: int, m: int) -> dict:
    attn = _permute_qkv(blocks["attn"], n_head, to_head_major=True)
    local = {}
    for (sub, name), axis in _TP_BLOCK_SPECS.items():
        leaf = attn[name] if sub == "attn" else blocks[sub][name]
        size = leaf.shape[axis] // tp
        local[(sub, name)] = leaf.narrow(axis, m * size, size)
    # model rank m's heads, head-major, back to packed order with H/tp heads
    qkv = _permute_qkv({"qkv_w": local[("attn", "qkv_w")], "qkv_b": local[("attn", "qkv_b")]},
                       n_head // tp, to_head_major=False)
    local[("attn", "qkv_w")], local[("attn", "qkv_b")] = qkv["qkv_w"], qkv["qkv_b"]
    out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in blocks.items()}
    for (sub, name), t in local.items():
        out[sub][name] = mark_shard(t.contiguous().clone(), MODEL_AXIS,
                                    _TP_BLOCK_SPECS[(sub, name)])
    return out


def shard_clip(clip_tree: dict, cfg: ClipConfig, mesh: Mesh) -> dict:
    """Model rank ``mesh.model_rank``'s shard of a canonical clip tree
    (parameters or a moment tree): new tensors for the sharded block
    leaves, marked (:func:`is_sharded`); the replicated leaves are the
    tree's own."""
    validate(cfg, mesh.tp)
    return _map_blocks(clip_tree, cfg, lambda blocks, heads: _shard_blocks(
        blocks, heads, mesh.tp, mesh.model_rank))


def _gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return gather_tensor(t, mesh.model_group, mesh.tp, mesh.model_rank)


def _unshard_blocks(blocks: dict, n_head: int, mesh: Mesh) -> dict:
    parts = {key: _gather(blocks[key[0]][key[1]], mesh) for key in _TP_BLOCK_SPECS}
    # each rank's packed qkv columns back to head-major with H/tp heads,
    # the ranks' heads side by side, then packed order with all H heads
    head_major = [_permute_qkv({"qkv_w": parts[("attn", "qkv_w")][i],
                                "qkv_b": parts[("attn", "qkv_b")][i]},
                               n_head // mesh.tp, to_head_major=True)
                  for i in range(mesh.tp)]
    qkv = _permute_qkv({name: torch.cat([hm[name] for hm in head_major], dim=-1)
                        for name in ("qkv_w", "qkv_b")}, n_head, to_head_major=False)
    out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in blocks.items()}
    for (sub, name), axis in _TP_BLOCK_SPECS.items():
        out[sub][name] = (qkv[name] if sub == "attn" and name in qkv
                          else torch.cat(list(parts[(sub, name)]), dim=axis))
    return out


@torch.no_grad()
def unshard_clip(clip_tree: dict, cfg: ClipConfig, mesh: Mesh) -> dict:
    """The canonical (packed, whole) clip tree from every model rank's
    shard: a collective over the model axis, which every rank must call.
    Replicated leaves are this rank's."""
    return _map_blocks(clip_tree, cfg, lambda blocks, heads: _unshard_blocks(
        blocks, heads, mesh))


# ------------------------------------------------------- Megatron functions

class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce (SUM over the model axis) backward: the
    input of a column-parallel product, whose gradient each rank holds for
    its own columns only."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.mesh.model_group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce (SUM over the model axis) forward, identity backward: the
    output of a row-parallel product, a partial sum on each rank."""

    @staticmethod
    def forward(ctx, x, mesh):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=mesh.model_group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh)



# ------------------------------------------------------------ optimizer state

def map_clip_moments(sd: dict, fn) -> dict:
    """A copy of an optimizer ``state_dict`` (BertAdam's: groups carry the
    tree ``paths``) whose ``m`` and ``v`` of the CLIP leaves are replaced
    through ``fn(clip-shaped moment tree)``: the blocks' for the model
    axis, every sharded leaf's for the data axis (``parallel/fsdp.py``)."""
    out = {"state": {k: dict(v) for k, v in sd["state"].items()},
           "param_groups": sd["param_groups"]}
    where = [(pid, tuple(path)) for group in sd["param_groups"]
             for pid, path in zip(group["params"], group["paths"])
             if path[0] == "clip" and pid in sd["state"]]
    for name in ("m", "v"):
        if not where:
            break
        tree: dict = {}
        for pid, path in where:
            node = tree
            for key in path[1:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = sd["state"][pid][name]
        mapped = fn(tree)
        for pid, path in where:
            node = mapped
            for key in path[1:]:
                node = node[key]
            out["state"][pid][name] = node
    return out
