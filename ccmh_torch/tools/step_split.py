"""The eager train step in its parts, timed and profiled on one card.

The step is ``ccmh_torch/train/state.py``'s :class:`TrainStep`: its
forward (zero the gradients, the loss forward: the towers, then the heads
and the loss), its backward (with the mesh's gradient sum) and its
optimize (the method's global gradient clip where it has one, then its
optimizers), each under its ``torch.profiler.record_function`` range
(:data:`RANGES`; the towers' range is ``clip_embeds``'s own, nested in
"heads+loss").  Every timing here runs those same parts:

* :func:`time_train_steps`, host ms a step and forward, backward and
  optimizer ms by CUDA events inside each step (``chip_smoke.py``'s step
  rates);
* :func:`chained_split`, each part alone as a chain of calls, its ms the
  least over repeats of (t_large - t_small) / (n_large - n_small) by CUDA
  events: the full step, the towers alone, the loss forward, forward +
  backward, and the optimizers alone on fixed gradients (the state
  restored after), the forward as the step runs it (grad enabled);
* :func:`profile_ranges`, one step under ``torch.profiler``: the device
  ms of the kernels launched inside each range, and by kernel class.
"""

from __future__ import annotations

import copy
import math
import time
from typing import Callable, Dict, Sequence

import torch

from ccmh_torch.train.state import TrainStep

RANGES = ("towers", "heads+loss", "backward", "optimizer")


def time_train_steps(loss_fn, st, batch, optimizers, steps: int, warm: int,
                     grad_clip: float = 0.0) -> dict:
    """Host ms per eager train step (:class:`TrainStep` of ``loss_fn``,
    ``optimizers`` and ``grad_clip``) and its forward, backward and
    optimizer device ms by CUDA events, over ``steps`` steps after
    ``warm``."""
    train_step = TrainStep(loss_fn, *optimizers, grad_clip=grad_clip)
    parts = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}
    t_host = 0.0
    for i in range(warm + steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        ev[0].record()
        loss, (new_aux, metrics) = train_step.forward(st, batch)
        ev[1].record()
        train_step.backward(st, loss)
        ev[2].record()
        train_step.optimize()
        ev[3].record()
        train_step.finish(st, loss, new_aux, metrics)
        torch.cuda.synchronize()
        if i >= warm:
            t_host += time.perf_counter() - h0
            for k, (a, b) in zip(parts, ((0, 1), (1, 2), (2, 3))):
                parts[k] += ev[a].elapsed_time(ev[b]) / steps
    return {"step_ms": 1e3 * t_host / steps, **{f"{k}_ms": v for k, v in parts.items()}}


def chained_ms(run: Callable[[int], None], loops: Sequence[int] = (2, 8),
               repeats: int = 2) -> float:
    """ms a call: the least over ``repeats`` of (t_large - t_small) /
    (large - small) from CUDA events around ``run(small)`` and
    ``run(large)``, after one warm call."""
    small, large = loops
    run(1)
    best = math.inf
    for _ in range(repeats):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        run(small)
        ev[1].record()
        ev[2].record()
        run(large)
        ev[3].record()
        torch.cuda.synchronize()
        t = ev[2].elapsed_time(ev[3]) - ev[0].elapsed_time(ev[1])
        best = min(best, t / (large - small))
    return best


def _snapshot(optimizers):
    params = [p for opt in optimizers for g in opt.param_groups for p in g["params"]]
    return ([p.detach().clone() for p in params],
            [copy.deepcopy(opt.state_dict()) for opt in optimizers], params)


def _restore(optimizers, snap) -> None:
    values, states, params = snap
    with torch.no_grad():
        for p, v in zip(params, values):
            p.copy_(v)
    for opt, sd in zip(optimizers, states):
        opt.load_state_dict(sd)


def split_parts(train_step: TrainStep, st, batch, towers: Callable[[], object],
                passes: Dict[str, int] = None) -> Dict[str, Callable[[int], None]]:
    """``{part: run(n)}``, each running its part of ``train_step`` ``n``
    times: "full" (the whole step), "towers", "loss_forward",
    "forward_backward" and "optimizer" (on the gradients the parameters
    hold).  ``passes`` (if given) counts the forward and backward passes of
    the towers the runs make."""
    passes = passes if passes is not None else {}
    passes.setdefault("forward", 0)
    passes.setdefault("backward", 0)

    def counted(fwd: int, bwd: int):
        passes["forward"] += fwd
        passes["backward"] += bwd

    def full(n):
        for _ in range(n):
            train_step(st, batch)
        counted(n, n)

    def towers_only(n):
        for _ in range(n):
            towers()
        counted(n, 0)

    def loss_forward(n):
        for _ in range(n):
            train_step.forward(st, batch)
        counted(n, 0)

    def forward_backward(n):
        for _ in range(n):
            train_step.backward(st, train_step.forward(st, batch)[0])
        counted(n, n)

    def optimizer(n):
        for _ in range(n):
            train_step.optimize()

    return {"full": full, "towers": towers_only, "loss_forward": loss_forward,
            "forward_backward": forward_backward, "optimizer": optimizer}


def chained_split(parts: Dict[str, Callable[[int], None]], optimizers, quick: bool = False,
                  loops: Sequence[int] = (2, 8), repeats: int = 2) -> Dict[str, float]:
    """Host ms of each part of :func:`split_parts` (``quick``: the full
    step only) and the derived ones: "heads+loss" (loss forward - towers),
    "backward" (forward + backward - loss forward) and "unattributed"
    (full - forward + backward - optimizer).  The optimizer is chained on
    the gradients of one forward + backward and the parameters and
    optimizer state are restored after it."""
    ms = {"full": chained_ms(parts["full"], loops, repeats)}
    if quick:
        return ms
    for name in ("towers", "loss_forward", "forward_backward"):
        ms[name] = chained_ms(parts[name], loops, repeats)
    parts["forward_backward"](1)
    snap = _snapshot(optimizers)
    ms["optimizer"] = chained_ms(parts["optimizer"], loops, repeats)
    _restore(optimizers, snap)
    del snap
    ms["heads+loss"] = ms["loss_forward"] - ms["towers"]
    ms["backward"] = ms["forward_backward"] - ms["loss_forward"]
    ms["unattributed"] = ms["full"] - ms["forward_backward"] - ms["optimizer"]
    return ms


def kernel_class(name: str) -> str:
    """The class of a device record by its name: the port's kernels (#1,
    #2, #3, #4/#5), the library's matrix products and convolutions, top-k,
    copies, other (elementwise and reductions)."""
    n = name.lower()
    for key, cls in (("attention_fwd", "fused_attention_kernel"),
                     ("attention_bwd", "fused_attention_bwd_kernel"),
                     ("hamming_", "popcount_kernel"),
                     ("memcpy htod", "h2d_copy"), ("memcpy h2d", "h2d_copy"),
                     ("memcpy dtoh", "d2h_copy"), ("memcpy d2h", "d2h_copy")):
        if key in n:
            return cls
    if "layer_norm_kernel<" in n and "at::native" not in n:
        return "fused_layernorm_kernel"
    if any(s in n for s in ("gemm", "xmma", "cutlass", "nvjet", "sm90_", "sm80_", "conv",
                            "cudnn", "winograd")):
        return "matmul"
    if "topk" in n or "sort" in n or "radix" in n:
        return "topk"
    return "other"


def _is_device(evt) -> bool:
    from torch.autograd import DeviceType

    return (evt.device_type == DeviceType.CUDA and not evt.name.startswith("Activity Buffer")
            and not getattr(evt, "is_user_annotation", False))


def profile_ranges(run_once: Callable[[], None], ranges: Sequence[str] = RANGES,
                   top: int = 8) -> dict:
    """``torch.profiler`` (CPU + CUDA) over one ``run_once()`` after a warm
    one: its wall ms, the summed device ms of its kernels and copies, the
    device ms launched inside each of ``ranges`` (the innermost named
    range holding the launch: "towers" is taken out of "heads+loss"), by
    kernel class, the top kernels, and the device ms no range holds."""
    from torch.profiler import ProfilerActivity, profile

    run_once()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_once()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    by_class, by_name = {}, {}
    for evt in events:
        if _is_device(evt):
            ms = (evt.time_range.end - evt.time_range.start) / 1e3
            cls = kernel_class(evt.name)
            by_class[cls] = by_class.get(cls, 0.0) + ms
            by_name[evt.name] = by_name.get(evt.name, 0.0) + ms
    by_range = dict.fromkeys(ranges, 0.0)
    by_range[None] = 0.0

    def walk(evt, label):
        if evt.name in by_range:
            label = evt.name
        by_range[label] += sum(k.duration for k in evt.kernels) / 1e3
        for child in evt.cpu_children:
            walk(child, label)

    from torch.autograd import DeviceType

    cpu = [evt for evt in events if evt.device_type == DeviceType.CPU]
    spans = [evt.time_range for evt in cpu if evt.name in by_range]
    names = [evt.name for evt in cpu if evt.name in by_range]
    for evt in cpu:
        if evt.cpu_parent is None:
            # a root on another thread (the autograd engine's, which runs a
            # CUDA backward) takes the innermost range open when it began
            t = evt.time_range.start
            inside = [(s.start, n) for s, n in zip(spans, names) if s.start <= t <= s.end]
            walk(evt, max(inside)[1] if inside else None)
    device_ms = sum(by_class.values())
    outside = by_range.pop(None)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
            "device_ms_by_range": by_range,
            "device_ms_outside_ranges": device_ms - sum(by_range.values()),
            "device_ms_linked_outside_ranges": outside,
            "device_ms_by_class": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms": {k[:120]: v for k, v in
                               sorted(by_name.items(), key=lambda kv: -kv[1])[:top]}}
