"""The device mesh over ``torch.distributed`` (port of ``ccmh/parallel/mesh.py``).

``ccmh``'s mesh step is one ``jit`` over global arrays: every method's loss
sees the whole global batch, and the mesh run computes the single-device
function.  Most of the losses are pairwise over the batch, so the usual DDP
recipe (the mean of per-rank losses over per-rank batches) would compute
another function.  The port keeps ``ccmh``'s semantics:

1. a rank runs the CLIP towers on its rows of the global batch only (rows
   ``rank * B/dp`` to ``(rank + 1) * B/dp``: :func:`shard_batch`, or a
   loader that assembles just those rows);
2. the tower outputs are all-gathered in rank order (:func:`gather_rows`,
   called by ``train/methods/base.py``'s tower functions under an active
   mesh); its backward returns this rank's slice of the incoming gradient,
   with no communication;
3. the heads, dropout, miners, BatchNorm statistics and the loss run on
   the global batch, identically on every rank, from step generators
   seeded alike, so the random draws are the single-device draws;
4. after ``backward`` the CLIP leaves' gradients are summed over the data
   group, one flat buffer per dtype (:func:`sync_gradients`); the leaves
   after the gather (heads, a method's ``extra``) already hold the whole
   gradient, the same on every rank, and are left alone, and so are the
   leaves sharded over the data axis (``parallel/fsdp.py``), whose
   gradients were reduce-scattered in ``backward``.

One process drives one device.  Collectives run over NCCL on the card and
gloo on the CPU; gloo takes only ``broadcast`` and ``all_reduce`` on CUDA
tensors, so a gloo gather of CUDA tensors is an ``all_reduce`` of a
zero-filled ``[world, ...]`` buffer in which each rank fills its own slot
(exact: every sum adds zeros to one value).

The 2-D ``(data, model)`` mesh and its Megatron-sharded towers are in
``parallel/tp.py``, the towers' weights sharded over the data axis in
``parallel/fsdp.py``; a sharded leaf carries the mesh axes it is sharded
on, and the dimension of each (:func:`shard_axes`).  Ranks are numbered
``data_rank * tp + model_rank``: the model axis, which carries the
per-block all-reduces, on neighbouring ranks, as ``ccmh``'s device order
puts it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

from ccmh_torch.device import DeviceLike, resolve_device

# the batch fields the CLIP towers read: a rank holds its rows of these, and
# the whole global batch of every other field
TOWER_FIELDS = ("image", "text", "key_padding_mask")

# this process's device, set when it joins the process group
_RANK_DEVICE: Optional[torch.device] = None
# the mesh the towers, the train step and the optimizer read (one process
# drives one rank, so one mesh is active at a time)
_ACTIVE: Optional["Mesh"] = None


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of a ``(data, model)`` mesh: the world size and
    rank, the rank's device, the axis sizes, and the process groups of the
    data axis (the ranks of this model rank), of the model axis (the ranks
    of this data rank) and of the host."""

    dp: int
    tp: int
    rank: int
    world: int
    device: torch.device
    backend: str
    data_group: Any
    model_group: Any
    # gloo over the whole world, for host-side flags (the world group itself
    # under gloo; a second group beside NCCL's)
    host_group: Any

    @property
    def data_rank(self) -> int:
        return self.rank // self.tp

    @property
    def model_rank(self) -> int:
        return self.rank % self.tp

    @property
    def is_lead(self) -> bool:
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of ``n`` global rows (``n`` divisible by dp)."""
        if n % self.dp:
            raise ValueError(f"a global batch of {n} rows does not divide over the "
                             f"mesh's {self.dp} data ranks")
        per = n // self.dp
        return slice(self.data_rank * per, (self.data_rank + 1) * per)

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is True on any (MAX over the
        world, a host tensor over :attr:`host_group`: it waits for the
        other ranks' host, never for the card's queue)."""
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return bool(t.item())


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE


DATA_AXIS, MODEL_AXIS = "data", "model"


def shard_axes(leaf: torch.Tensor) -> Dict[str, int]:
    """{mesh axis: dimension} of the axes ``leaf`` is a shard on (``model``
    from ``parallel/tp.py``, ``data`` from ``parallel/fsdp.py``); empty for
    a whole leaf."""
    return getattr(leaf, "shard_axes", {})


def mark_shard(leaf: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """Mark ``leaf`` as a shard on mesh axis ``axis`` along ``dim``."""
    leaf.shard_axes = {**shard_axes(leaf), axis: dim}
    return leaf


def copy_marks(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst`` with ``src``'s shard marks (a cast or a gathered copy)."""
    if shard_axes(src):
        dst.shard_axes = dict(shard_axes(src))
    return dst


def sum_over_shards(t: torch.Tensor, axes, mesh: "Mesh") -> torch.Tensor:
    """``t`` (a partial sum over a shard's elements) summed in place over
    the ranks of each mesh axis in ``axes``: the model axis, then the data
    axis."""
    for axis, group in ((MODEL_AXIS, mesh.model_group), (DATA_AXIS, mesh.data_group)):
        if axis in axes:
            dist.all_reduce(t, group=group)
    return t


@contextlib.contextmanager
def activated(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """``mesh`` is the one the towers, the train step and BertAdam read
    inside the block (None: single-device)."""
    global _ACTIVE
    previous, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = previous


# ------------------------------------------------------------------ joining

def init_process(rank: int, world: int, init_method: str,
                 device: DeviceLike = "cuda", backend: Optional[str] = None
                 ) -> torch.device:
    """Join the process group as ``rank`` of ``world`` on ``device`` (NCCL
    on a card, gloo on the CPU unless ``backend`` says otherwise)."""
    global _RANK_DEVICE
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world,
                            rank=rank, **kw)
    _RANK_DEVICE = dev
    return dev


def initialize_multihost(device: str = "cuda") -> int:
    """Join a ``torchrun`` launch; returns the world size.

    The rank, the world size and the rendezvous come from ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``), and a rank on a card takes
    ``cuda:LOCAL_RANK``.  A single process outside ``torchrun`` is a no-op
    that returns 1, as in ``ccmh``."""
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    if "WORLD_SIZE" not in env:
        return 1
    world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    local = int(env.get("LOCAL_RANK", rank))
    dev = f"cuda:{local}" if resolve_device(device).type == "cuda" else "cpu"
    init_process(rank, world, "env://", dev)
    return world


def rank_device() -> Optional[torch.device]:
    """The device this process joined the group on, if it joined one."""
    return _RANK_DEVICE


def _ensure_group(device: Optional[DeviceLike]) -> torch.device:
    """The process group (a one-rank group on a free local port when none
    exists yet) and this rank's device."""
    if not dist.is_initialized():
        import socket

        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        return init_process(0, 1, f"tcp://localhost:{port}", device or "cuda")
    if device is not None:
        return resolve_device(device)
    if _RANK_DEVICE is None:
        raise RuntimeError("the process group was joined without init_process; "
                           "pass device=")
    return _RANK_DEVICE


def build_mesh(dp: int, tp: int = 1, device: Optional[DeviceLike] = None) -> Mesh:
    """The ``(dp, tp)`` mesh over every rank of the process group: every
    rank calls it, with the same sizes.  ``device`` overrides this rank's
    device (two gloo ranks may share one card; NCCL refuses that)."""
    dev = _ensure_group(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp * tp != world:
        raise ValueError(f"mesh ({dp} data x {tp} model) needs {dp * tp} devices, "
                         f"have {world}")

    def groups(rank_lists: List[List[int]]):
        # every rank creates every group, in the same order
        mine = None
        for ranks in rank_lists:
            g = dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)
            if rank in ranks:
                mine = g
        return mine

    data = groups([[d * tp + m for d in range(dp)] for m in range(tp)])
    model = groups([[d * tp + m for m in range(tp)] for d in range(dp)])
    backend = dist.get_backend()
    host = dist.group.WORLD if backend == "gloo" else dist.new_group(backend="gloo")
    return Mesh(dp=dp, tp=tp, rank=rank, world=world, device=dev, backend=backend,
                data_group=data, model_group=model, host_group=host)


def make_mesh(n_devices: Optional[int] = None,
              device: Optional[DeviceLike] = None) -> Mesh:
    """The 1-D data mesh over ``n_devices`` ranks (default: the world).
    Without a process group it makes a one-rank one first."""
    dev = _ensure_group(device)
    return build_mesh(n_devices or dist.get_world_size(), 1, dev)


# -------------------------------------------------------------- collectives

def gather_tensor(x: torch.Tensor, group, n: int, index: int) -> torch.Tensor:
    """``[n, *x.shape]``: ``x`` of each of the ``n`` ranks of ``group``, in
    group order; ``index`` is this rank's position in it.  No autograd."""
    x = x.detach().contiguous()
    is_bool = x.dtype == torch.bool
    if is_bool:
        x = x.to(torch.uint8)
    backend = dist.get_backend(group)
    if backend == "nccl":
        out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
    elif x.device.type == "cuda":
        # gloo gathers no CUDA tensors: each rank fills its slot of a
        # zero buffer, one SUM adds zeros to every value
        out = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        out[index] = x
        dist.all_reduce(out, group=group)
    else:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        out = torch.stack(parts)
    return out.to(torch.bool) if is_bool else out


class _GatherRows(torch.autograd.Function):
    """All-gather along rows over the data axis; the backward returns this
    rank's slice of the incoming gradient, with no communication (every
    rank computes the same loss from the gathered rows, so the gradient
    there is already whole and the same on every rank).
    ``torch.distributed.nn``'s gather reduce-scatters instead, which would
    scale the tower gradients by dp here."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rows, ctx.index = x.shape[0], mesh.data_rank
        out = gather_tensor(x, mesh.data_group, mesh.dp, mesh.data_rank)
        return out.reshape((-1,) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.index * ctx.rows
        return grad[lo:lo + ctx.rows], None


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[B/dp, ...] rows of each data rank -> [B, ...] in rank order."""
    if x.is_floating_point():
        return _GatherRows.apply(x, mesh)
    out = gather_tensor(x, mesh.data_group, mesh.dp, mesh.data_rank)
    return out.reshape((-1,) + tuple(x.shape[1:]))


def gather_outputs(out):
    """A tower output (a NamedTuple of tensors and Nones) with every tensor
    gathered over the active mesh's data axis; unchanged without one or
    with one data rank."""
    mesh = _ACTIVE
    if mesh is None or mesh.dp == 1:
        return out
    return type(out)(*[None if t is None else gather_rows(t, mesh) for t in out])


def all_reduce_flat(tensors: Sequence[torch.Tensor], group) -> None:
    """SUM each tensor over ``group`` in place, through one flat buffer per
    dtype (one collective each instead of one per tensor)."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def _leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


@torch.no_grad()
def sync_gradients(params) -> None:
    """Under an active mesh, SUM the gradients of the CLIP leaves
    (``params["clip"]``) over the data axis: each rank's towers saw only
    its rows.  Call after ``backward`` and before any clip or update.  With
    one data rank the sum is the gradient itself, and nothing moves.  A
    leaf sharded over the data axis is skipped: its gradient is the
    reduce-scattered sum already (``parallel/fsdp.py``)."""
    mesh = _ACTIVE
    if mesh is None or mesh.dp == 1:
        return
    grads = [p.grad for p in _leaves(params["clip"])
             if p.grad is not None and DATA_AXIS not in shard_axes(p)]
    if grads:
        all_reduce_flat(grads, mesh.data_group)


@torch.no_grad()
def replicate(mesh: Mesh, tree: Any) -> Any:
    """Broadcast every tensor of ``tree`` from rank 0 to all ranks, in
    place (one flat buffer per dtype); returns ``tree``."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in _leaves(tree):
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        if mesh.backend == "nccl":
            flat = flat.to(mesh.device)
        dist.broadcast(flat, src=0)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return tree


def shard_batch(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of the towers' inputs (:data:`TOWER_FIELDS`); every
    other field (labels, indices, ``valid``, the epoch) stays whole: the
    loss runs on the global batch.  Scalars replicate."""
    out = {}
    for k, v in batch.items():
        if k in TOWER_FIELDS and getattr(v, "ndim", 0) >= 1:
            v = v[mesh.rows(v.shape[0])]
        out[k] = v
    return out


def data_parallel_train_step(step_fn, mesh: Mesh):
    """``step_fn(state, batch)`` under ``mesh``: the batch holds this rank's
    rows of the towers' inputs (:func:`shard_batch`) and the whole of every
    other field; the towers gather, the step sums the CLIP gradients over
    the data axis after ``backward`` (``train/state.py``), and every rank
    ends with the same state."""
    def step(state, batch):
        with activated(mesh):
            return step_fn(state, batch)
    return step


def sharded_map_eval(mesh: Mesh, calc_map_fn, q_codes, r_codes, q_labels, r_labels,
                     k=None):
    """mAP with the queries sharded over the data axis and the gallery
    whole on every rank: ``calc_map(..., mesh=mesh)``."""
    return calc_map_fn(q_codes, r_codes, q_labels, r_labels, k, mesh=mesh)
