"""Rank workers of the mesh tests (tests/test_torch_parallel.py,
test_torch_sharded_search.py, test_torch_tp.py, test_torch_cli.py,
test_torch_fsdp.py).

:func:`run` starts ``world`` gloo ranks on the CPU with
``torch.multiprocessing.spawn`` (the process group joins through a file in
the test's tmp dir, so xdist workers never share a port); each rank runs
one job of :data:`JOBS` on a payload the test wrote, and saves what it
returns for the test process to hold against ``ccmh`` and the
single-device port.  With the spawn start method a child imports the
module of its target, so the workers live here, in a module that imports
only ``torch`` and ``ccmh_torch``: a worker defined in a test file would
import ``jax`` and ``ccmh`` into every rank.
"""

import copy
import os
import signal

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ccmh_torch.bridge import params_from_jax
from ccmh_torch.clip.model import ClipConfig, init_clip_params
from ccmh_torch.config import Config
from ccmh_torch.parallel import fsdp as fsdp_mod
from ccmh_torch.parallel import tp as tp_mod
from ccmh_torch.parallel.mesh import (
    activated, copy_marks, data_parallel_train_step, init_process, make_mesh, shard_batch,
    shard_axes, sync_gradients,
)
from ccmh_torch.train.methods import get_method
from ccmh_torch.train.optim import tree_leaves_with_path
from ccmh_torch.train.state import TrainState, make_main_optimizer, make_train_step, trainable

K, N_CLASS, MAX_WORDS, B = 16, 5, 12, 8
TRAIN_NUM = 16
STEPS_PER_EPOCH = 4


def start(tmp_path, world, job, payload):
    """Start ``world`` ranks running ``JOBS[job](payload)``; returns a
    function that waits for them and gives each rank's result in rank
    order (the test process may work meanwhile)."""
    tmp_path = str(tmp_path)
    os.makedirs(tmp_path, exist_ok=True)
    pay = os.path.join(tmp_path, f"{job}.payload.pt")
    torch.save(payload, pay)
    ctx = mp.spawn(_worker, args=(world, f"file://{tmp_path}/{job}.store", job, pay),
                   nprocs=world, join=False)

    def results():
        while not ctx.join():
            pass
        out = [torch.load(f"{pay}.rank{r}", weights_only=False) for r in range(world)]
        for path in [pay] + [f"{pay}.rank{r}" for r in range(world)]:
            os.remove(path)     # up to ~100 MB each, read now
        return out
    return results


def run(tmp_path, world, job, payload):
    """Each rank's result of ``JOBS[job](payload)``, in rank order."""
    return start(tmp_path, world, job, payload)()


def _worker(rank, world, init_method, job, pay):
    torch.set_num_threads(1)
    init_process(rank, world, init_method, "cpu")
    try:
        out = JOBS[job](torch.load(pay, weights_only=False))
        torch.save(out, f"{pay}.rank{rank}")
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ helpers

def np_tree(tree):
    """A tree of tensors as numpy copies (bf16 widened), None kept."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [np_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
    return tree


def grads_of(tree):
    """{path: gradient as numpy} of the leaves that have one."""
    if tree is None:
        return {}
    return {p: leaf.grad.detach().numpy().copy() for p, leaf in tree_leaves_with_path(tree)
            if isinstance(leaf, torch.Tensor) and leaf.grad is not None}


def as_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def method_config(name, **kw):
    """The tests' config of method ``name`` (K=16, five classes); ``kw``
    holds Config fields and ``sets`` {"section.field": value}."""
    sets = kw.pop("sets", {})
    base = dict(method=name, output_dim=K, max_words=MAX_WORDS, epochs=2, nclass=N_CLASS,
                lr=1e-3, clip_lr=1e-4, warmup_proportion=0.2, weight_decay=0.2,
                batch_size=B, train_num=TRAIN_NUM)
    base.update(kw)
    cfg = Config(**base)
    for key, value in sets.items():
        section, field = key.split(".")
        setattr(getattr(cfg, section), field, value)
    return cfg


def initial_state(cfg, seed=5, clip=None):
    """The seeded init of ``cfg``'s method on the tiny towers (or ``clip``'s;
    the same on every rank): {"params", "extra", "aux"}."""
    method = get_method(cfg.method)
    clip = clip or ClipConfig.tiny()
    gen = torch.Generator().manual_seed(seed)
    heads, extra, aux = method.init(gen, cfg, clip)
    params = {"clip": init_clip_params(gen, clip), **heads}
    if "train_labels" in aux:
        rng = np.random.RandomState(9)
        labels = (rng.rand(cfg.train_num, cfg.nclass) < 0.4).astype(np.float32)
        aux["train_labels"] = torch.from_numpy(labels)
    if "label_net" in params:
        # DMsH_LN: unit-normal weights, zero biases, so that label codes
        # disagree in sign and the loss mines pairs (at the method's init
        # every pair is positive and the loss is flat)
        rng = np.random.RandomState(1)
        params["label_net"] = {layer: {k: torch.from_numpy(
            rng.randn(*v.shape).astype(np.float32) if v.ndim == 2
            else np.zeros(tuple(v.shape), np.float32)) for k, v in leaves.items()}
            for layer, leaves in params["label_net"].items()}
    return {"params": params, "extra": extra, "aux": aux}


def fresh(cfg, init, mesh=None, fsdp=False, clip=None):
    """(state, step, loss_fn, optimizer) from a copy of ``init``; with a
    model axis the towers' blocks are this rank's shard, and with ``fsdp``
    the large tower leaves are this data rank's chunk (on top)."""
    method = get_method(cfg.method)
    clip = clip or ClipConfig.tiny()
    st = copy.deepcopy(init)
    params = st["params"]
    if mesh is not None:
        params = {**params, "clip": fsdp_mod.local_clip(params["clip"], clip, mesh, fsdp)}
    params, extra, aux = trainable(params), st["extra"], st["aux"]
    opt = make_main_optimizer(cfg, params, STEPS_PER_EPOCH)
    extra_opt = (method.extra_optimizer(cfg, extra)
                 if extra is not None and method.extra_optimizer else None)
    if extra_opt is not None:
        trainable(extra)
    loss_fn = method.make_loss_fn(cfg, clip)
    custom = method.custom_step(cfg, clip, opt, extra_opt) if method.custom_step else None
    step = make_train_step(loss_fn, opt, extra_opt, grad_clip=method.grad_clip,
                           custom_step=custom)
    return TrainState(params, extra, aux, 0, torch.Generator().manual_seed(0)), step, loss_fn, opt


def loss_and_grads(loss_fn, state, batch, mesh=None):
    """The loss at ``state`` on the global ``batch`` and every gradient
    (CLIP gradients summed over the data axis under ``mesh``)."""
    with activated(mesh):
        b = shard_batch(mesh, batch) if mesh is not None else batch
        loss, _ = loss_fn(state.params, state.extra, state.aux, b,
                          torch.Generator().manual_seed(0))
        loss.backward()
        sync_gradients(state.params)
    return loss.item(), state


def gathered_grads(params, mesh=None, clip=None):
    """The CLIP gradients gathered to the canonical layout (a collective
    under a sharded mesh: the data axis, then the model axis) and the
    heads' gradients, as numpy."""
    tree = {}
    for path, leaf in tree_leaves_with_path(params):
        if leaf.grad is None:
            continue
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = copy_marks(leaf.grad, leaf)
    if mesh is not None:
        tree["clip"] = fsdp_mod.canonical_clip(tree["clip"], clip or ClipConfig.tiny(), mesh)
    return {p: g.detach().numpy().copy() for p, g in tree_leaves_with_path(tree)}


# --------------------------------------------------------------------- jobs

def digests(tree):
    """{path: sha1 of the bytes} of every leaf: equal digests on two ranks
    mean the same bits, without shipping the arrays."""
    import hashlib

    return {p: hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest()
            for p, v in _np_leaves(tree)}


def _np_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _np_leaves(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _np_leaves(v, prefix + (i,))
    elif tree is not None:
        yield prefix, np.asarray(tree)


def worst(got, want, rtol, atol):
    """{path: max over elements of |got - want| / (atol + rtol |want|)} of
    two numpy trees with the same leaves (<= 1 passes ``assert_allclose``);
    integer leaves: 0 when equal, inf otherwise.  ``atol`` may be a function
    of ``want``'s leaves (their common scale)."""
    g, w = dict(_np_leaves(got)), dict(_np_leaves(want))
    assert set(g) == set(w), sorted(set(g) ^ set(w), key=str)[:4]
    if callable(atol):
        atol = atol([v for v in w.values() if np.issubdtype(v.dtype, np.floating)])
    out = {}
    for p, wv in w.items():
        if not np.issubdtype(wv.dtype, np.floating):
            out[p] = 0.0 if np.array_equal(g[p], wv) else float("inf")
            continue
        diff = np.abs(g[p].astype(np.float64) - wv)
        bound = atol + rtol * np.abs(wv.astype(np.float64))
        err = np.where(diff == 0, 0.0, diff / np.where(bound > 0, bound, 0.0))
        out[p] = float(err.max()) if err.size else 0.0
    return out


def rel_norm(got, want):
    """||got - want|| / ||want|| over all leaves together."""
    g, w = dict(_np_leaves(got)), dict(_np_leaves(want))
    diff = sum(float(np.sum((g[p].astype(np.float64) - v) ** 2)) for p, v in w.items())
    norm = sum(float(np.sum(v.astype(np.float64) ** 2)) for v in w.values())
    if norm == 0.0:     # a loss flat at this point (a hinge not yet active)
        return 0.0 if diff == 0.0 else float("inf")
    return (diff / norm) ** 0.5


def _all_grads(state):
    return {**grads_of(state.params),
            **{("extra",) + p: g for p, g in grads_of(state.extra).items()}}


def _state_np(state):
    return {"params": np_tree(state.params), "extra": np_tree(state.extra),
            "aux": np_tree(state.aux)}


def _dp_methods(payload):
    """For each case: the loss and gradients at the init on the global batch
    and two train steps, over the mesh on every rank, then single-device
    with the cases split between the ranks (``single`` holds a rank's);
    DCHMT and DSPH from ccmh's init (:func:`_dp_against_ccmh`); and
    :func:`_trainer_wrap`."""
    mesh = make_mesh(2)
    out = {"mesh": {}, "single": {}}
    runs = []
    for label, name, kw in payload["cases"]:
        cfg = method_config(name, **kw)
        runs.append((label, cfg, initial_state(cfg),
                     [as_batch(b) for b in payload["batches"][label]]))
    for label, cfg, init, batches in runs:
        st, step, loss_fn, _ = fresh(cfg, init)
        loss, st = loss_and_grads(loss_fn, st, batches[0], mesh)
        res = {"loss": loss, "grads": _all_grads(st), "steps": []}
        st, step, _, _ = fresh(cfg, init)
        dp = data_parallel_train_step(step, mesh)
        for b in batches:
            st, m = dp(st, shard_batch(mesh, b))
            res["steps"].append(m["loss"].item())
        res["state"] = _state_np(st)
        out["mesh"][label] = res
    out["ccmh_steps"] = _dp_against_ccmh(payload, mesh)
    out["wrap"] = _trainer_wrap(payload)
    for i, (label, cfg, init, batches) in enumerate(runs):
        if i % mesh.world != mesh.rank:
            continue
        st, step, loss_fn, _ = fresh(cfg, init)
        loss, st = loss_and_grads(loss_fn, st, batches[0])
        single = {"loss": loss, "grads": _all_grads(st), "steps": []}
        st, step, _, _ = fresh(cfg, init)
        for b in batches:
            st, m = step(st, b)
            single["steps"].append(m["loss"].item())
        single["state"] = _state_np(st)
        out["single"][label] = _against_single(out["mesh"][label], single)
    # the trees are large (the token embedding): what crosses to the test
    # process is their comparisons and digests
    for res in out["mesh"].values():
        res["grads"] = digests(res["grads"])
        res["state"] = {k: digests(v) for k, v in res["state"].items()}
    return out


def _against_single(mesh_res, single):
    """The mesh run's distance from the single-device run: losses, each
    gradient within 1e-5 of the largest gradient entry (and 1e-5
    relative), their relative norm, and the state after the steps within
    ccmh's DP-vs-single bound of 1e-4."""
    return {"loss": single["loss"], "steps": single["steps"],
            "grad_norm": sum(float(np.sum(g.astype(np.float64) ** 2))
                             for g in single["grads"].values()) ** 0.5,
            "grad_paths": sorted(mesh_res["grads"], key=str) == sorted(single["grads"], key=str),
            "grads": worst(mesh_res["grads"], single["grads"], 1e-5,
                           lambda leaves: 1e-5 * max(np.abs(v).max() for v in leaves)),
            "grad_rel_norm": rel_norm(mesh_res["grads"], single["grads"]),
            "state": {k: worst(mesh_res["state"][k], single["state"][k], 0.0, 1e-4)
                      for k in ("params", "extra", "aux")}}


def _numpy_masks():
    """Dropout takes the i-th numpy mask on its i-th call, as the tests'
    ccmh side does (tests/test_torch_linear_hash_methods.py _same_masks)."""
    from ccmh_torch.models import heads

    calls = [0]

    def dropout(x, rate, generator, train):
        if not train or rate <= 0.0 or generator is None:
            return x
        m = np.random.RandomState(1000 + calls[0]).rand(*x.shape) < 1.0 - rate
        calls[0] += 1
        return torch.where(torch.from_numpy(m), x / (1.0 - rate), torch.zeros((), dtype=x.dtype))

    real = heads._dropout
    heads._dropout = dropout
    return lambda: setattr(heads, "_dropout", real)


def _dp_against_ccmh(payload, mesh, fsdp=False):
    """One mesh step of each method from ccmh's numpy init, numpy dropout
    masks: the parameters (canonical), ``extra`` and metrics after it."""
    out = {}
    for name, (cfg, tree, batch) in payload["ccmh"].items():
        init = {"params": params_from_jax(tree["params"], device="cpu"),
                "extra": (None if tree["extra"] is None
                          else params_from_jax(tree["extra"], device="cpu")),
                "aux": params_from_jax(tree["aux"], device="cpu")}
        st, step, _, _ = fresh(cfg, init, mesh if fsdp else None, fsdp=fsdp)
        restore = _numpy_masks()
        try:
            st, m = data_parallel_train_step(step, mesh)(st, shard_batch(mesh, as_batch(batch)))
        finally:
            restore()
        params = {**st.params, "clip": fsdp_mod.canonical_clip(st.params["clip"],
                                                               ClipConfig.tiny(), mesh)}
        state = {"params": np_tree(params), "extra": np_tree(st.extra)}
        out[name] = {"metrics": {k: float(v) for k, v in m.items()}, "digests":
                     {k: digests(v) for k, v in state.items()},
                     **(state if mesh.rank == 0 else {})}
    return out


def _trainer_wrap(payload):
    """A mesh Trainer whose last train and eval batches wrap-pad: its step
    losses (metrics rows) and the codes of both eval splits."""
    from ccmh_torch.train.trainer import Trainer

    trainer = Trainer(payload["wrap_cfg"], clip_cfg=ClipConfig.tiny(), device="cpu")
    trainer.train_epoch(0)
    codes = [trainer.get_code(trainer.query_loader, len(trainer.query_data))[:2],
             trainer.get_code(trainer.retrieval_loader, len(trainer.retrieval_data))[:2]]
    maps = trainer.valid(0)
    trainer.metrics.close()
    return {"codes": codes, "maps": maps}


def _search(payload):
    """Mesh mAP and gallery-sharded search on the payload's codes."""
    from ccmh_torch.ops.map_metric import calc_map, calc_map_4way
    from ccmh_torch.retrieval import HashIndex, topk_search_sharded

    mesh = make_mesh(2)
    q, r, ql, rl = (payload[k] for k in ("q", "r", "ql", "rl"))
    out = {"map": {}, "search": {}}
    for method in ("exact", "hist"):
        out["map"][("query", method)] = float(calc_map(q, r, ql, rl, method=method,
                                                       mesh=mesh, device="cpu"))
        out["map"][("query_chunk", method)] = float(calc_map(q, r, ql, rl, method=method,
                                                             mesh=mesh, chunk=16,
                                                             device="cpu"))
    out["map"][("gallery", "hist")] = float(calc_map(q, r, ql, rl, method="hist", mesh=mesh,
                                                     shard_gallery=True, device="cpu"))
    qi, qt, ri, rt = (payload[k] for k in ("qi", "qt", "ri", "rt"))
    for sg in (False, True):
        out["map"][("4way", sg)] = [float(v) for v in calc_map_4way(
            qi, qt, ri, rt, ql, rl, mesh=mesh, shard_gallery=sg, device="cpu")]
    try:
        calc_map(q, r, ql, rl, method="exact", mesh=mesh, shard_gallery=True, device="cpu")
    except ValueError as e:
        out["exact_refusal"] = str(e)
    for name, (queries, gallery, k) in payload["search"].items():
        out["search"][name] = topk_search_sharded(queries, gallery, k, mesh, chunk=7)
    index = HashIndex(payload["index_codes"], mesh=mesh, packed=True)
    out["index_search"] = index.search(payload["index_queries"], 9)
    out["index_shard_rows"] = index._codes.shape[0]
    index.save(payload["index_path"])
    try:
        index.add(payload["index_codes"][:3])
    except NotImplementedError as e:
        out["add_refusal"] = str(e)
    return out


def _tp(payload):
    """Tensor parallelism over a (1, 2) mesh: the towers' embeddings, one
    DSPH and one MITH step against single-device, BertAdam's clip of a
    sharded leaf, Retriever(tp_mesh=), and a Trainer's slots both ways."""
    from ccmh_torch.retrieval import Retriever
    from ccmh_torch.train.methods.base import image_features, text_features

    mesh = tp_mod.make_mesh_2d(1, 2)
    clip = ClipConfig.tiny()
    out = {"model_rank": mesh.model_rank}
    params = {"clip": tp_mod.shard_clip(params_from_jax(payload["jclip"], device="cpu"),
                                        clip, mesh)}
    images, ids = (torch.from_numpy(payload[k]) for k in ("images", "ids"))
    with torch.no_grad(), activated(mesh):
        for mode in ("pooled", "mith"):
            out[("vision", mode)] = np_tree(image_features(params, clip, images,
                                                           features=mode)._asdict())
            out[("text", mode)] = np_tree(text_features(params, clip, ids, features=mode,
                                                        key_padding_mask=ids == 0)._asdict())
    out["steps"] = {name: _tp_step(name, payload, mesh)
                    for name in ("DSPH", "MITH")}
    out["retriever"] = _tp_retriever(payload, mesh)
    out["trainer"] = _tp_trainer(payload, mesh)
    return out


def _tp_step(name, payload, mesh):
    cfg = method_config(name)
    init = initial_state(cfg)
    batch = as_batch(payload["batches"][name])
    single, _, loss_fn1, opt1 = fresh(cfg, init)
    loss1, single = loss_and_grads(loss_fn1, single, batch)
    sharded, _, loss_fn2, opt2 = fresh(cfg, init, mesh)
    loss2, sharded = loss_and_grads(loss_fn2, sharded, batch, mesh)
    res = {"loss_single": loss1, "loss_mesh": loss2,
           "grads_single": gathered_grads(single.params),
           "grads_mesh": gathered_grads(sharded.params, mesh)}
    # BertAdam's per-layer clip of the sharded blocks, on gradients scaled
    # so that their per-layer norms exceed the clip's 1.0
    scale = payload["clip_scale"]
    with activated(mesh):
        clipped = {}
        for path, leaf in tree_leaves_with_path(sharded.params):
            if tp_mod.is_sharded(leaf):
                clipped[path] = opt2._clip(leaf.grad * scale, True, tuple(shard_axes(leaf)))
    tree = {}
    for path, g in clipped.items():
        node = tree
        for key in path[1:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = g
    gathered = tp_mod.unshard_clip(tree, ClipConfig.tiny(), mesh)
    res["clipped_mesh"] = {("clip",) + p: g.numpy() for p, g in tree_leaves_with_path(gathered)}
    res["clipped_single"] = {p: opt1._clip(leaf.grad * scale, True).numpy()
                             for p, leaf in tree_leaves_with_path(single.params) if p in clipped}
    res["raw_single_norms"] = {p: torch.linalg.vector_norm(leaf.grad * scale, dim=(1, 2)
                                                           if leaf.ndim == 3 else (1,)).numpy()
                               for p, leaf in tree_leaves_with_path(single.params)
                               if p in clipped}
    # two train steps each way (the first runs at warmup's lr 0)
    s1, step1, _, _ = fresh(cfg, init)
    s2, step2, _, _ = fresh(cfg, init, mesh)
    step2 = data_parallel_train_step(step2, mesh)
    for _ in range(2):
        s1, m1 = step1(s1, batch)
        s2, m2 = step2(s2, batch)
    canon = tp_mod.unshard_clip(s2.params["clip"], ClipConfig.tiny(), mesh)
    res["step_single"] = {"loss": float(m1["loss"]), "params": np_tree(s1.params)}
    res["step_mesh"] = {"loss": float(m2["loss"]),
                        "params": np_tree({**s2.params, "clip": canon}),
                        "local": np_tree(s2.params)}
    return res


def _tp_retriever(payload, mesh):
    from ccmh_torch.retrieval import Retriever

    cfg = method_config("DSPH")
    init = initial_state(cfg)
    images = payload["images"]
    ids = payload["ids"]
    single = Retriever(get_method("DSPH"), init["params"], init["aux"], cfg,
                       ClipConfig.tiny(), device="cpu")
    sharded = Retriever(get_method("DSPH"), init["params"], init["aux"], cfg,
                        ClipConfig.tiny(), tp_mesh=mesh)
    return {"single": (single.encode_images(images, batch_size=3),
                       single.encode_texts(ids, batch_size=3)),
            "mesh": (sharded.encode_images(images, batch_size=3),
                     sharded.encode_texts(ids, batch_size=3))}


def _tp_trainer(payload, mesh):
    """A (1, 2) Trainer for one epoch with a slot and an .npz, its
    canonical state; then another resumed from a single-device slot."""
    from ccmh_torch.retrieval import Retriever
    from ccmh_torch.train.trainer import Trainer

    out = {}
    trainer = Trainer(payload["tp_cfg"], clip_cfg=ClipConfig.tiny(), device="cpu")
    trainer.train()
    canon = trainer._canonical_state()
    out["canonical"] = {"params": np_tree(canon.params),
                        "optimizer": trainer._canonical_optimizer().state_dict()}
    q_img, q_txt, _ = trainer.get_code(trainer.query_loader, len(trainer.query_data))
    out["query_codes"] = (q_img, q_txt)
    served = Retriever.from_pretrained(
        payload["tp_cfg"].replace(pretrained=payload["tp_npz"]), device="cpu")
    batches = list(trainer.query_loader)
    out["served_codes"] = served.encode_images(np.concatenate(
        [b["image"] for b in batches]))
    trainer.metrics.close()
    resumed = Trainer(payload["resume_cfg"], clip_cfg=ClipConfig.tiny(), device="cpu")
    resumed.try_resume()
    canon = resumed._canonical_state()
    out["resumed"] = {"params": np_tree(canon.params),
                      "optimizer": resumed._canonical_optimizer().state_dict(),
                      "step": canon.step}
    resumed.metrics.close()
    return out


def _tp22(payload):
    """A (2, 2) mesh: one DSPH step's gradients against single-device."""
    mesh = tp_mod.make_mesh_2d(2, 2)
    cfg = method_config("DSPH")
    init = initial_state(cfg)
    batch = as_batch(payload["batch"])
    single, _, loss_fn1, _ = fresh(cfg, init)
    loss1, single = loss_and_grads(loss_fn1, single, batch)
    sharded, _, loss_fn2, _ = fresh(cfg, init, mesh)
    loss2, sharded = loss_and_grads(loss_fn2, sharded, batch, mesh)
    return {"rank": (mesh.data_rank, mesh.model_rank), "loss_single": loss1,
            "loss_mesh": loss2, "grads_single": gathered_grads(single.params),
            "grads_mesh": gathered_grads(sharded.params, mesh)}


def _cli_sigterm(payload):
    """Three CLI runs in one process group: uninterrupted, cut by a SIGTERM
    to rank 1 after global step 2, and resumed."""
    from ccmh_torch import cli
    from ccmh_torch.train import trainer as trainer_mod

    rank = dist.get_rank()
    cli.main(payload["whole"]).metrics.close()
    real = trainer_mod.data_parallel_train_step

    def cut(step_fn, mesh):
        inner = real(step_fn, mesh)

        def step(state, batch):
            state, metrics = inner(state, batch)
            if rank == 1 and state.step == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return state, metrics
        return step

    trainer_mod.data_parallel_train_step = cut
    try:
        cut_trainer = cli.main(payload["cut"])
    finally:
        trainer_mod.data_parallel_train_step = real
    cut_trainer.metrics.close()
    cli.main(payload["cut"] + ["--resume"]).metrics.close()
    return {"cut_step": cut_trainer.state.step}


# --------------------------------------------------------------------- FSDP

def _halves(state, opt, mesh, clip=None):
    """(number of data-axis shards, whether each of them and its two
    moments hold 1/dp of the canonical leaf on this rank)."""
    clip = clip or ClipConfig.tiny()
    n, ok = 0, True
    for path, leaf in tree_leaves_with_path(state.params):
        if path[0] != "clip":
            continue
        shape = list(leaf.shape)
        for axis, size in (("model", mesh.tp), ("data", mesh.dp)):
            if axis in shard_axes(leaf):
                shape[shard_axes(leaf)[axis]] *= size
        spec = fsdp_mod.spec_for_leaf(path, shape, mesh.dp, mesh.tp)
        if "data" not in spec:
            ok &= "data" not in shard_axes(leaf)
            continue
        n += 1
        whole = int(np.prod(shape)) // (mesh.tp if "model" in spec else 1)
        st = opt.state[leaf]
        ok &= (shard_axes(leaf).get("data") == spec.index("data")
               and leaf.numel() * mesh.dp == whole
               and st["m"].shape == leaf.shape == st["v"].shape)
    return n, bool(ok)


def _canonical(state, mesh, clip=None):
    """The state's trees in the canonical layout, as numpy."""
    params = {**state.params, "clip": fsdp_mod.canonical_clip(state.params["clip"],
                                                               clip or ClipConfig.tiny(), mesh)}
    return {"params": np_tree(params), "extra": np_tree(state.extra),
            "aux": np_tree(state.aux)}


def _two_steps(cfg, init, batches, mesh=None, fsdp=False, clip=None):
    """The steps from ``init`` on ``batches`` (over ``mesh`` when given):
    losses, the gradients left by the first and the last step and the
    state after it, canonical."""
    st, step, _, opt = fresh(cfg, init, mesh, fsdp=fsdp, clip=clip)
    if mesh is not None:
        step = data_parallel_train_step(step, mesh)
    losses, first = [], None
    for b in batches:
        st, m = step(st, shard_batch(mesh, b) if mesh is not None else b)
        losses.append(m["loss"].item())
        grads = gathered_grads(st.params, mesh, clip)
        grads.update({("extra",) + p: g for p, g in grads_of(st.extra).items()})
        first = grads if first is None else first
    out = {"losses": losses, "grads": grads, "first_grads": first,
           "state": _canonical(st, mesh, clip) if mesh is not None else _state_np(st)}
    if fsdp:
        out["halves"] = _halves(st, opt, mesh, clip)
    return out


def _versus(got, want, grad_tol=1e-5, state_atol=1e-4):
    """``got``'s distance from ``want`` (two :func:`_two_steps`): the
    single-device bounds of test_torch_parallel.py's DP test."""
    return {"losses": (got["losses"], want["losses"]),
            "grad_norm": sum(float(np.sum(g.astype(np.float64) ** 2))
                             for g in want["grads"].values()) ** 0.5,
            "grads": worst(got["grads"], want["grads"], grad_tol,
                           lambda leaves: grad_tol * max(np.abs(v).max() for v in leaves)),
            "grad_rel_norm": rel_norm(got["grads"], want["grads"]),
            "state": {k: worst(got["state"][k], want["state"][k], 0.0, state_atol)
                      for k in ("params", "extra", "aux")}}


def _fsdp(payload):
    """Two gloo ranks, FSDP over a (2,) mesh: every case's two steps
    against the DP steps on the same mesh and the single-device steps (the
    cases split between the ranks); DSPH under remat full and dots; a tiny
    RN tower; the Trainer's lifecycle; and the CLI."""
    mesh = make_mesh(2)
    out = {"cases": {}, "single": {}}
    runs = []
    for label, name, kw in payload["cases"]:
        cfg = method_config(name, **kw)
        runs.append((label, cfg, initial_state(cfg),
                     [as_batch(b) for b in payload["batches"][label]]))
    fsdp_runs = {}
    for i, (label, cfg, init, batches) in enumerate(runs):
        f = _two_steps(cfg, init, batches, mesh, fsdp=True)
        # the first step of each: the same parameters, so the gradients
        # differ only by where the sums ran
        d = _two_steps(cfg, init, batches[:1], mesh)
        fsdp_runs[label] = f
        out["cases"][label] = {"halves": f["halves"], "vs_dp": {
                                   "grad_rel_norm": rel_norm(f["first_grads"], d["grads"]),
                                   "grads_bit_equal": sum(
                                       np.array_equal(f["first_grads"][p], g)
                                       for p, g in d["grads"].items()),
                                   "n_grads": len(d["grads"]),
                                   "losses": (f["losses"][:1], d["losses"])},
                               "digests": {k: digests(v) for k, v in f["state"].items()},
                               "grad_digests": digests(f["grads"])}
    for i, (label, cfg, init, batches) in enumerate(runs):
        if i % mesh.world == mesh.rank:
            out["single"][label] = _versus(fsdp_runs[label], _two_steps(cfg, init, batches))
    remat = {"off": fsdp_runs["DSPH"]}
    cfg0, init, batches = next((c, i, b) for label, c, i, b in runs if label == "DSPH")
    for policy in ("full", "dots"):
        cfg = cfg0.replace(remat=True, remat_policy=policy)
        remat[policy] = _two_steps(cfg, init, batches, mesh, fsdp=True)
    out["remat"] = {k: {"grads": digests(v["grads"]),
                        "state": {w: digests(t) for w, t in v["state"].items()}}
                    for k, v in remat.items()}
    del fsdp_runs, remat
    out["rn"] = _fsdp_rn(payload, mesh)
    out["lifecycle"] = _fsdp_lifecycle(payload)
    from ccmh_torch import cli

    cli.main(payload["cli"]).metrics.close()
    return out


def _fsdp_rn(payload, mesh):
    """DSPH's two steps on the tiny RN tower under FSDP against one device
    (the rank computes both)."""
    clip = ClipConfig(**payload["rn_clip"])
    cfg = method_config("DSPH")
    init = initial_state(cfg, clip=clip)
    batches = [as_batch(b) for b in payload["rn_batches"]]
    f = _two_steps(cfg, init, batches, mesh, fsdp=True, clip=clip)
    return {"halves": f["halves"], "vs_single": _versus(f, _two_steps(cfg, init, batches,
                                                                      clip=clip))}


def _trainer_digests(trainer):
    """Digests of a Trainer's canonical state: params, extra, aux, both
    moments (a collective under a sharded mesh)."""
    canon = trainer._canonical_state()
    sd = trainer._canonical_optimizer().state_dict()
    moments = {}
    for group in sd["param_groups"]:
        for pid, path in zip(group["params"], group["paths"]):
            for name in ("m", "v"):
                moments[(name,) + tuple(path)] = sd["state"][pid][name].numpy()
    return {"params": digests(np_tree(canon.params)), "extra": digests(np_tree(canon.extra)),
            "aux": digests(np_tree(canon.aux)), "moments": digests(moments),
            "step": canon.step}


def _fsdp_lifecycle(payload):
    """A --mesh 2 --fsdp Trainer: one epoch with valid, .npz and a slot
    (its canonical digests); another resumed from a single-device slot;
    and two epochs uninterrupted against one cut after epoch 0 and
    resumed (ccmh's test_fsdp_resume_bit_exact)."""
    from ccmh_torch.train.trainer import Trainer

    out = {}
    trainer = Trainer(payload["life_cfg"], clip_cfg=ClipConfig.tiny(), device="cpu")
    trainer.train()
    out["trained"] = _trainer_digests(trainer)
    out["trained_halves"] = _halves(trainer.state, trainer.optimizer, trainer.mesh)
    trainer.metrics.close()
    resumed = Trainer(payload["resume_cfg"], clip_cfg=ClipConfig.tiny(), device="cpu")
    resumed.try_resume()
    out["resumed"] = _trainer_digests(resumed)
    out["resumed_halves"] = _halves(resumed.state, resumed.optimizer, resumed.mesh)
    resumed.metrics.close()
    whole = Trainer(payload["whole_cfg"], clip_cfg=ClipConfig.tiny(), device="cpu")
    whole.train()
    out["whole"] = _trainer_digests(whole)
    whole.metrics.close()
    cut = Trainer(payload["cut_cfg"], clip_cfg=ClipConfig.tiny(), device="cpu")
    cut.train_epoch(0)
    cut.save_full_checkpoint(0)
    cut.metrics.close()
    again = Trainer(payload["cut_cfg"].replace(resume=True), clip_cfg=ClipConfig.tiny(),
                    device="cpu")
    again.train()
    out["cut_resumed"] = _trainer_digests(again)
    out["cut_resumed_halves"] = _halves(again.state, again.optimizer, again.mesh)
    again.metrics.close()
    return out


def _fsdp_ccmh(payload):
    """DSPH's FSDP step over a (2,) mesh from ccmh's init
    (:func:`_dp_against_ccmh`)."""
    return _dp_against_ccmh(payload, make_mesh(2), fsdp=True)


def _fsdp22(payload):
    """A (2, 2) mesh under FSDP: one DSPH step's gradients against
    single-device, the shards' sizes; then the CLI over the same ranks."""
    mesh = tp_mod.make_mesh_2d(2, 2)
    cfg = method_config("DSPH")
    init = initial_state(cfg)
    batch = as_batch(payload["batch"])
    single, _, loss_fn1, _ = fresh(cfg, init)
    loss1, single = loss_and_grads(loss_fn1, single, batch)
    sharded, _, loss_fn2, _ = fresh(cfg, init, mesh, fsdp=True)
    qkv = sharded.params["clip"]["text"]["blocks"]["attn"]["qkv_w"]
    loss2, sharded = loss_and_grads(loss_fn2, sharded, batch, mesh)
    want = gathered_grads(single.params)
    got = gathered_grads(sharded.params, mesh)
    out = {"rank": (mesh.data_rank, mesh.model_rank), "loss_single": loss1,
           "loss_mesh": loss2, "qkv_axes": dict(shard_axes(qkv)),
           "qkv_numel": (qkv.numel(), int(np.prod(init["params"]["clip"]["text"]["blocks"]
                                                  ["attn"]["qkv_w"].shape))),
           "grads": worst(got, want, 1e-5,
                          lambda leaves: 1e-5 * max(np.abs(v).max() for v in leaves)),
           "grad_rel_norm": rel_norm(got, want)}
    from ccmh_torch import cli

    cli.main(payload["cli"]).metrics.close()
    return out


JOBS = {"dp_methods": _dp_methods, "search": _search,
        "tp": _tp, "tp22": _tp22, "cli_sigterm": _cli_sigterm,
        "fsdp": _fsdp, "fsdp_ccmh": _fsdp_ccmh, "fsdp22": _fsdp22}
