"""Trainer: the epoch loop, validation by mAP, ``test()`` with the curves,
checkpoints and resume (port of ``ccmh/train/trainer.py``).

One device (``cuda`` unless the caller asks for ``cpu``).  Per epoch: the
train split streams from :class:`BatchIterator` (host assembly on threads,
pinned host buffers on the card), each batch runs one eager train step
(CLIP forward x2, heads, loss, backward, the method's global gradient
clip where it has one, BertAdam, and the method's own optimizer for its
loss-side ``extra`` parameters where it has one, as DSPH's proxy SGD);
the epoch rides in every batch, and a ``needs_mask`` method's batches
carry the key-padding mask; a method with a ``custom_step`` (DGHDGH's
sequenced mode) replaces the generic step.  Then ``valid`` extracts
±1 codes for the query and retrieval splits, ranks them (by Hamming
distance, or the method's own ``dist_fn``) with the histogram mAP
and rechecks candidates for a best epoch with the exact stable-sort mAP
(``ccmh``'s ``_needs_exact``), keeps the best-epoch trackers, and writes
the ``.mat`` codes, the csv and the reference's log lines; a method with
``multi_encode`` (TwDH) is validated at each code length after it
(``valid_multi``).  ``--save-model`` writes ``model-<epoch>.npz`` in
``ccmh``'s format, which both packages load.

``--test`` (``test()``) encodes both splits of a ``--pretrained`` model,
reports the exact 4-way mAP and writes the codes and the PR / top-N
curves (``ops/pr_curve.py``).  ``--checkpoint-every`` writes full-state
slots (``train/checkpoint.py``; ``--async-checkpoint`` overlaps their
writes), SIGTERM or :meth:`Trainer.request_preempt` saves one at the next
step boundary and returns, and ``--resume`` continues from the newest
slot bit for bit: the skipped batches are never assembled, and the
trackers, the histogram-recheck ones included, come back with the state.
``--clip-path`` reads ``.npz``, OpenAI ``.pt`` and HF directories;
``--pretrained`` reads ``.npz``, full-state directories and reference
``.pth`` files.

The input path: JPEG ``index.mat`` datasets and npy images of any size
(``data/dataset.py``, the native loader); ``--cache-images`` decodes each
split once into a uint8 memmap (``data/cache.py``, under ``--cache-dir``);
with a cache, ``--device-resident auto|on`` pins the train split to the
card and gathers each batch there (``data/resident.py``), a split over
``device_resident_budget_mb`` trains in the chunked mode (a pinned region
plus superblocks streamed on a side stream) or streams, and the eval
splits pin where the rest of the budget holds them.  Streamed batches are
copied from pinned memory on a side stream ``prefetch_device`` batches
ahead (``data/prefetch.py``).  Every transport feeds the step the same
bits.

``--remat`` (``--set remat_policy=dots``) checkpoints the towers' blocks in
the train step, ``--set optim_moments_dtype=bfloat16`` stores BertAdam's
moments in bf16, and ``--profile`` traces epoch 1 with ``torch.profiler``
into ``save_dir/profile``.

``--mesh N`` / ``--mesh dp,tp`` (``cfg.mesh_shape``) trains over a mesh of
``torch.distributed`` ranks, one process per device (``parallel/``):
each rank's loader assembles its rows of the towers' inputs, the towers
gather, and the heads and the loss run on the global batch on every rank
(``ccmh``'s one-program semantics); a model axis Megatron-shards the
towers, and ``--fsdp`` (``cfg.fsdp``, with more than one rank, as in
``ccmh``) shards the towers' large weights, their gradients and
BertAdam's moments over the data axis, on top of the model axis
(``parallel/fsdp.py``: gathered per layer, reduce-scattered in
backward).  A global or eval batch the data ranks do not divide raises;
the last train batch is wrap-padded; mesh runs stream (no
device-resident splits); ``valid`` encodes each eval batch's rows on
their rank and ranks with the mesh (``calc_map(mesh=)``,
``--shard-gallery``).  The lead rank (0) alone writes checkpoints,
``.mat``, csv and ``.npz`` files; every other rank logs to
``train.log.p<rank>`` and ``metrics.jsonl.p<rank>`` (``ccmh``'s names).
Checkpoints stay canonical: a sharded state (FSDP, then TP) is gathered
before the lead saves and sharded again on resume, so that mesh and
single-device runs interchange slots and ``.npz`` files.  A SIGTERM that
reaches one rank stops every rank at the same step.

Not ported, each raising when asked for: compilation caches (XLA's; the
port builds its kernels once into ``build/``), and ``param_dtype``,
which ``ccmh`` reads nowhere, so that accepting it would differ from
nothing and mislead.
"""

from __future__ import annotations

import os
import signal
import threading
import time
import types
from typing import Dict, Optional, Tuple

import numpy as np
import scipy.io as scio
import torch

from ccmh_torch.bridge import params_from_jax
from ccmh_torch.clip.convert import load_clip_params
from ccmh_torch.clip.model import ClipConfig, init_clip_params
from ccmh_torch.config import Config
from ccmh_torch.data.dataset import BatchIterator, CrossModalDataset
from ccmh_torch.data.prefetch import DevicePut, device_prefetch
from ccmh_torch.data.split import SplitData, make_splits
from ccmh_torch.device import DeviceLike, resolve_device
from ccmh_torch.ops.map_metric import calc_map, calc_map_4way
from ccmh_torch.ops.pr_curve import curves, default_topn
from ccmh_torch.parallel.mesh import (
    Mesh, activated, data_parallel_train_step, replicate,
)
from ccmh_torch.train.checkpoint import (
    AsyncStateSaver, latest_checkpoint, load_checkpoint, load_state, restore_state,
    save_checkpoint, save_state,
)
from ccmh_torch.train.methods import get_method
from ccmh_torch.train.optim import tree_leaves_with_path
from ccmh_torch.train.state import TrainState, make_main_optimizer, make_train_step, trainable
from ccmh_torch.utils import MetricsWriter, get_logger


def _unported(cfg: Config):
    """(setting, why) for each setting of ``cfg`` the port cannot honour."""
    checks = (
        (bool(cfg.compilation_cache),
         "--compilation-cache (XLA's compilation cache; the port builds its "
         "kernels once into build/)"),
        (cfg.param_dtype != "float32",
         "param_dtype (ccmh reads it nowhere: the parameters are float32)"),
    )
    return [why for bad, why in checks if bad]


def _mesh_for(cfg: Config, device: torch.device) -> Optional[Mesh]:
    """The mesh of ``cfg.mesh_shape`` over the process group (None for one
    device): ``(dp,)`` or ``(dp, tp)``."""
    shape = tuple(cfg.mesh_shape)
    if len(shape) not in (1, 2) or any(int(n) < 1 for n in shape):
        raise ValueError(f"mesh_shape must be (dp,) or (dp, tp), got {shape}")
    dp, tp = int(shape[0]), int(shape[1]) if len(shape) > 1 else 1
    if dp * tp == 1:
        return None
    from ccmh_torch.parallel.tp import make_mesh_2d

    return make_mesh_2d(dp, tp, device)


class Trainer:
    def __init__(self, cfg: Config, *, splits: Optional[SplitData] = None,
                 clip_cfg: Optional[ClipConfig] = None, clip_params=None,
                 device: DeviceLike = "cuda", mesh: Optional[Mesh] = None):
        """``mesh`` (``parallel/mesh.py``) overrides the one of
        ``cfg.mesh_shape``, e.g. ranks that share a device over gloo."""
        missing = _unported(cfg)
        if missing:
            raise NotImplementedError(
                "not yet ported to ccmh_torch: " + ", ".join(missing))
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else _mesh_for(cfg, self.device)
        if self.mesh is not None:
            self.device = self.mesh.device
        self.tp = self.mesh.tp if self.mesh is not None else 1
        # ccmh's rule: --fsdp under a mesh of more than one rank; on one
        # device it is ignored, and one data rank shards nothing
        self.fsdp = bool(cfg.fsdp) and self.mesh is not None
        self._sharded = self.tp > 1 or (self.fsdp and self.mesh.dp > 1)
        os.makedirs(cfg.save_dir, exist_ok=True)
        # every rank runs the same Trainer; files written once are the
        # lead's, and each other rank's streams take a ".p<rank>" suffix
        self.process_index = self.mesh.rank if self.mesh is not None else 0
        self.is_lead = self.process_index == 0
        psuf = f".p{self.process_index}" if not self.is_lead else ""
        self.logger = get_logger(os.path.join(
            cfg.save_dir, ("train.log" if cfg.is_train else "test.log") + psuf))
        self.metrics = MetricsWriter(os.path.join(cfg.save_dir, "metrics.jsonl" + psuf),
                                     tensorboard_dir=os.path.join(cfg.save_dir,
                                                                  "tensorboard" + psuf))
        self.method = get_method(cfg.method)

        # the tower checkpoint fixes the image resolution, so it is read
        # before the datasets
        if clip_params is None and cfg.clip_path:
            clip_params, clip_cfg = load_clip_params(cfg.clip_path, device=self.device)
        if clip_cfg is not None and clip_cfg.image_resolution != cfg.resolution:
            self.logger.warning(
                f"--resolution {cfg.resolution} does not match the "
                f"{clip_cfg.image_resolution}px CLIP tower; using "
                f"{clip_cfg.image_resolution}")
            cfg.resolution = clip_cfg.image_resolution

        self._init_data(splits)
        self._init_model(clip_cfg, clip_params)

        self.global_step = 0
        self.max_mapi2t = 0.0
        self.max_mapt2i = 0.0
        self.best_epoch_i = 0
        self.best_epoch_t = 0
        self.total_time = 0.0
        self._max_hist_i2t = self._max_hist_t2i = 0.0
        self._hist_bias = 0.0   # largest |exact - hist| seen so far
        self._preempt = False
        self._async_saver: Optional[AsyncStateSaver] = None

    # ------------------------------------------------------------------ data
    def _init_data(self, splits: Optional[SplitData]):
        cfg = self.cfg
        if splits is None:
            if not cfg.data_dir:
                raise ValueError("provide data_dir or explicit splits")
            caption = os.path.join(
                cfg.data_dir, "caption.txt" if "nuswide" in cfg.dataset else "caption.mat")
            index = os.path.join(cfg.data_dir, "index.mat")
            npy = False
            if not os.path.exists(index):
                index = os.path.join(cfg.data_dir, "index.npy")
                npy = True
            label = os.path.join(cfg.data_dir, "label.mat")
            splits = make_splits(caption, index, label, cfg.query_num, cfg.train_num,
                                 cfg.seed, npy=npy)
        self.splits = splits
        mesh = self.mesh
        if mesh is not None:
            for flag, size in (("--batch-size", cfg.batch_size), ("--eval-batch", cfg.eval_batch)):
                if size % mesh.dp:
                    raise ValueError(f"{flag} {size} does not divide over the mesh's "
                                     f"{mesh.dp} data ranks")
        kw = dict(max_words=cfg.max_words, resolution=cfg.resolution, seed=cfg.seed,
                  with_mask=self.method.needs_mask)
        self.train_data = CrossModalDataset(splits.train, is_train=True, **kw)
        self.query_data = CrossModalDataset(splits.query, is_train=False, **kw)
        self.retrieval_data = CrossModalDataset(splits.retrieval, is_train=False, **kw)
        self.query_labels = self.query_data.all_labels()
        self.retrieval_labels = self.retrieval_data.all_labels()
        self.cfg.retrieval_num = len(self.retrieval_labels)
        if self.cfg.nclass == 0:
            self.cfg.nclass = self.query_labels.shape[1]
        nw = cfg.num_workers
        caches = {"train": None, "query": None, "retrieval": None}
        if cfg.cache_images:
            # each split decoded ONCE into a uint8 memmap; epochs read it and
            # the tower normalizes on the card (data/cache.py)
            from ccmh_torch.data.cache import open_or_build

            base = cfg.cache_dir or os.path.join(cfg.data_dir or cfg.save_dir, "_ccmh_cache")
            for split, ds in (("train", self.train_data), ("query", self.query_data),
                              ("retrieval", self.retrieval_data)):
                caches[split] = open_or_build(ds, base, split, num_workers=nw,
                                              logger=self.logger)
            self.logger.info(f"decoded-tensor image caches ready under {base}")
        # device-resident epochs (data/resident.py): a cached train split
        # within the budget pins to the card (in _init_model); one over it
        # trains chunked in auto mode, or streams where two superblock
        # buffers would not fit either
        self.train_resident = None
        self.train_chunked = None
        self._resident_source = None
        self._chunked_plan = None
        self._split_caches = caches
        if mesh is not None:
            # a rank assembles only its rows of each batch; device-resident
            # splits would pin every row on every rank (ccmh streams its
            # multi-controller runs too)
            self.logger.info(f"mesh data={mesh.dp} x model={mesh.tp}, rank {mesh.rank} on "
                             f"{mesh.device}: every rank streams its rows of each batch "
                             "(no device-resident splits)")
        elif caches["train"] is not None:
            from ccmh_torch.data.resident import ResidentImages, plan_chunked

            mode = cfg.device_resident_images
            if ResidentImages.plan(caches["train"], budget_mb=cfg.device_resident_budget_mb,
                                   mode=mode, logger=self.logger):
                self._resident_source = caches["train"]
            elif mode == "auto":
                images = caches["train"].images
                self._chunked_plan = plan_chunked(
                    len(images), int(np.prod(images.shape[1:])),
                    cfg.device_resident_budget_mb * 2**20, cfg.batch_size,
                    cfg.device_resident_block_rows)
                if self._chunked_plan is None:
                    self.logger.info("device-resident images [chunked]: two superblock "
                                     "buffers exceed the budget; streaming")
        # under a mesh the last train batch is wrap-padded: its true size
        # would rarely divide over the data ranks (ccmh's rule)
        self.train_loader = BatchIterator(
            self.train_data, cfg.batch_size, shuffle=cfg.shuffle, seed=cfg.seed,
            num_workers=nw, ragged_last=cfg.ragged_last and mesh is None,
            image_cache=caches["train"],
            with_images=self._resident_source is None and self._chunked_plan is None,
            rows=mesh.rows(cfg.batch_size) if mesh is not None else None)
        eval_rows = mesh.rows(cfg.eval_batch) if mesh is not None else None
        self.query_loader = BatchIterator(self.query_data, cfg.eval_batch, shuffle=False,
                                          seed=cfg.seed, num_workers=nw,
                                          image_cache=caches["query"], rows=eval_rows)
        self.retrieval_loader = BatchIterator(self.retrieval_data, cfg.eval_batch,
                                              shuffle=False, seed=cfg.seed, num_workers=nw,
                                              image_cache=caches["retrieval"], rows=eval_rows)

    # ----------------------------------------------------------------- model
    def _init_model(self, clip_cfg: Optional[ClipConfig], clip_params):
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        if clip_params is None:
            clip_cfg = clip_cfg or ClipConfig()
            self.logger.warning("no clip_path set — random CLIP init")
            clip_params = init_clip_params(gen, clip_cfg)
        self.clip_cfg = clip_cfg
        heads, extra, aux = self.method.init(gen, cfg, clip_cfg)
        params = {"clip": clip_params, **heads}
        step = 0
        if cfg.pretrained:
            if not os.path.exists(cfg.pretrained):
                raise FileNotFoundError(f"--pretrained {cfg.pretrained!r} does not exist")
            params, extra, aux, step = self._restore(cfg.pretrained, params, extra, aux)
        if "train_labels" in aux:
            # MITH's buffer losses compare against the whole train split; the
            # labels are this run's, also after --pretrained (ccmh keeps a
            # checkpoint's own)
            aux["train_labels"] = torch.from_numpy(self.train_data.all_labels()).to(self.device)
        if self.mesh is not None:
            # rank 0's canonical state on every rank, then this rank's
            # shards of the towers (model axis, then data axis)
            replicate(self.mesh, (params, extra, aux))
            from ccmh_torch.parallel.fsdp import local_clip

            params = {**params, "clip": local_clip(params["clip"], clip_cfg, self.mesh,
                                                   self.fsdp)}
            sharding = (["Megatron-sharded towers"] if self.tp > 1 else []) + (
                ["FSDP weight/moment sharding"] if self.fsdp else [])
            self.logger.info((f"2-D mesh: data={self.mesh.dp} x model={self.tp}"
                              if self.tp > 1 else
                              f"data-parallel mesh over {self.mesh.dp} ranks")
                             + (f" ({', '.join(sharding)})" if sharding else ""))
        params = trainable(params)
        self.optimizer = make_main_optimizer(cfg, params, len(self.train_loader))
        # the loss-side extra parameters train only under the method's own
        # optimizer (ccmh's extra_tx), where it has one for this config
        # (DNPH's proxies have none by default and stay at their init)
        self.extra_optimizer = None
        if extra is not None and self.method.extra_optimizer is not None:
            self.extra_optimizer = self.method.extra_optimizer(cfg, extra)
            if self.extra_optimizer is not None:
                trainable(extra)
        self.state = TrainState(params, extra, aux, step,
                                torch.Generator(device=self.device).manual_seed(cfg.seed + 1))
        custom = (self.method.custom_step(cfg, clip_cfg, self.optimizer, self.extra_optimizer)
                  if self.method.custom_step else None)
        self.train_step = make_train_step(self.method.make_loss_fn(cfg, clip_cfg),
                                          self.optimizer, self.extra_optimizer,
                                          grad_clip=self.method.grad_clip, custom_step=custom)
        if self.mesh is not None:
            self.train_step = data_parallel_train_step(self.train_step, self.mesh)
        # the method's own ranking distance in evaluation (DPSIH), else Hamming
        self.eval_dist_fn = self.method.dist_fn(cfg) if self.method.dist_fn else None
        self.max_multi: Dict[str, Dict[str, float]] = {}   # valid_multi's best-of
        # host batch -> device tensors, from pinned memory on a side stream
        # at prefetch_device >= 2 (data/prefetch.py)
        self._put = DevicePut(self.device, cfg.prefetch_device)
        if self._resident_source is not None:
            from ccmh_torch.data.resident import ResidentImages

            self.train_resident = ResidentImages(self._resident_source.images, self.device)
            self.logger.info(f"device-resident images: pinned {self.train_resident.n} items "
                             f"({self.train_resident.nbytes / 2**20:.0f} MiB)")
        if self._chunked_plan is not None:
            self._init_chunked_residency()
        self._plan_eval_residency()

    def _init_chunked_residency(self):
        """The chunked mode of an over-budget train split: rows below R pin
        to the card, the rest stream once an epoch in M-row superblocks
        (``data/resident.py`` :func:`plan_chunked`)."""
        from ccmh_torch.data.resident import ResidentImages

        cache = self._split_caches["train"]
        r, m = self._chunked_plan
        region = ResidentImages(cache.images[:r], self.device)
        row = int(np.prod(cache.images.shape[1:]))
        self.train_chunked = {"region": region, "R": r, "M": m, "cache": cache,
                              "row_shape": cache.images.shape[1:]}
        self.logger.info(
            f"device-resident images [chunked]: pinned rows 0..{r} of {len(cache.images)} "
            f"({region.nbytes / 2**20:.0f} MiB); the remaining {len(cache.images) - r} rows "
            f"stream once per epoch in {m}-row superblocks ({m * row / 2**20:.0f} MiB each)")

    def _plan_eval_residency(self):
        """Which eval splits pin to the card (query first), within what the
        train residency leaves of ``device_resident_budget_mb``; they pin at
        the first ``valid``."""
        from ccmh_torch.data.resident import ResidentEvalSplit

        cfg = self.cfg
        self._resident_eval: Dict[str, tuple] = {}
        self._resident_eval_plan: Dict[str, object] = {}
        if cfg.device_resident_images == "off":
            return
        budget = cfg.device_resident_budget_mb * 2**20
        used = self.train_resident.nbytes if self.train_resident is not None else 0
        if self.train_chunked is not None:
            ck = self.train_chunked
            used += ck["region"].nbytes + 2 * ck["M"] * int(np.prod(ck["row_shape"]))
        for split, ds in (("query", self.query_data), ("retrieval", self.retrieval_data)):
            cache = self._split_caches.get(split)
            if cache is None:
                continue
            est = ResidentEvalSplit.plan_bytes(cache, ds, cfg.eval_batch)
            if used + est <= budget:
                self._resident_eval_plan[split] = cache
                used += est
            else:
                self.logger.info(f"device-resident eval: {split} streams "
                                 f"({(used + est) / 2**20:.0f} MiB would exceed the "
                                 f"{budget / 2**20:.0f} MiB budget)")

    def _resident_eval_encoders(self, loader: BatchIterator):
        """(encode, multi_encode) over ``loader``'s split pinned to the card
        (pinned at the first call), or (None, None) where it streams."""
        split, ds = {id(self.query_loader): ("query", self.query_data),
                     id(self.retrieval_loader): ("retrieval", self.retrieval_data)
                     }.get(id(loader), (None, None))
        if split not in self._resident_eval_plan:
            return None, None
        enc = self._resident_eval.get(split)
        if enc is None:
            from ccmh_torch.data.resident import ResidentEvalSplit, make_resident_eval_encoder

            res = ResidentEvalSplit(self._resident_eval_plan[split], ds, self.cfg.eval_batch,
                                    self.device)
            cfg, clip_cfg, method = self.cfg, self.clip_cfg, self.method
            encode = make_resident_eval_encoder(
                lambda p, a, b: method.encode(p, a, b, cfg, clip_cfg), res)
            multi = None
            if method.multi_encode is not None:
                multi = make_resident_eval_encoder(
                    lambda p, a, b: method.multi_encode(p, a, b, cfg, clip_cfg), res)
            enc = self._resident_eval[split] = (encode, multi)
            self.logger.info(f"device-resident eval: pinned {split} split ({res.n} items, "
                             f"{res.nbytes / 2**20:.0f} MiB)")
        return enc

    def _restore(self, path: str, params, extra, aux):
        """Weights of a checkpoint (``restore_state``): an ``.npz`` or a
        full-state directory replaces the params tree, its ``extra`` the
        fresh extra where it holds one, and its aux and step come along; a
        reference ``.pth`` replaces the trees it holds (the CLIP tower and
        the method's heads) and updates aux with its buffers."""
        ckpt = load_checkpoint(path, method=self.cfg.method)
        saved = ckpt["params"]
        trees = [("params", {k: params.get(k, {}) for k in saved} if ckpt["reference"] else params,
                  saved)]
        if ckpt["extra"] is not None:
            trees.append(("extra", extra or {}, ckpt["extra"]))
        for name, fresh, got_tree in trees:
            want = {k: tuple(v.shape) for k, v in tree_leaves_with_path(fresh)}
            got = {k: tuple(np.shape(v)) for k, v in tree_leaves_with_path(got_tree)}
            if want != got:
                diff = sorted(set(want.items()) ^ set(got.items()))[:6]
                raise ValueError(f"{path} does not fit this {self.cfg.method} run "
                                 f"(K={self.cfg.output_dim}, {self.clip_cfg}): {name} {diff}")
        if ckpt["extra"] is not None:
            extra = params_from_jax(ckpt["extra"], device=self.device)
        loaded = params_from_jax(saved, device=self.device)
        saved_aux = params_from_jax(ckpt["aux"], device=self.device)
        self.logger.info(f"loaded checkpoint {path}")
        if ckpt["reference"]:
            return {**params, **loaded}, extra, {**aux, **saved_aux}, 0
        return loaded, extra, saved_aux, ckpt["step"]

    # ------------------------------------------------------------------ train
    def run(self):
        if self.cfg.is_train:
            self.train()
        else:
            self.test()

    def request_preempt(self) -> None:
        """Ask the training loop to save a full-state checkpoint at the next
        step boundary and return.  ``train()`` routes SIGTERM here (what a
        preempted machine or a batch scheduler sends)."""
        self._preempt = True

    def train(self):
        self.logger.info("Start train.")
        start_epoch, skip_steps = self.try_resume() if self.cfg.resume else (0, 0)
        self._preempt = False
        # SIGTERM -> a full-state slot at the next step boundary -> return;
        # --resume continues from that step bit for bit (the shuffle and
        # the caption draws are functions of (seed, epoch, item))
        in_main = threading.current_thread() is threading.main_thread()
        old_handler = None
        if in_main:
            def on_sigterm(signum, frame):
                self.logger.info("SIGTERM: checkpointing at the next step boundary")
                self.request_preempt()

            old_handler = signal.signal(signal.SIGTERM, on_sigterm)
        try:
            finished = self._train_epochs(start_epoch, skip_steps)
        finally:
            # every way out finalises a pending asynchronous write
            if self._async_saver is not None:
                self._async_saver.close()
                self._async_saver = None
            if in_main:
                signal.signal(signal.SIGTERM, old_handler)
        if self.mesh is not None:
            self.mesh.barrier()      # the lead's files are final for every rank
        if finished:
            self.logger.info(
                f">>>>>>> FINISHED >>>>>> Best epoch, I-T: {self.best_epoch_i}, "
                f"mAP: {self.max_mapi2t}, T-I: {self.best_epoch_t}, mAP: {self.max_mapt2i}")

    def _train_epochs(self, start_epoch: int, skip_steps: int) -> bool:
        """The epochs from ``start_epoch``; False when preempted (the slot is
        written)."""
        for epoch in range(start_epoch, self.cfg.epochs):
            if not self.train_epoch(epoch, skip_steps=skip_steps):
                return False        # preempted mid-epoch: the slot is written
            skip_steps = 0
            if self._preempt:
                # the signal landed on the epoch's last step: the slot
                # records the whole epoch as done, so the resumed run
                # still validates and saves it (ccmh resumes after it)
                self.save_full_checkpoint(epoch, step_in_epoch=len(self.train_loader))
                self.logger.info(f"preempted after epoch {epoch}'s steps; rerun with "
                                 "--resume")
                return False
            if self.cfg.valid:
                self.valid(epoch)
            if self.cfg.save_model:
                self.save_checkpoint(os.path.join(self.cfg.save_dir, f"model-{epoch}.npz"))
            if self.cfg.checkpoint_every and (epoch + 1) % self.cfg.checkpoint_every == 0:
                self.save_full_checkpoint(epoch)
        return True

    def train_epoch(self, epoch: int, skip_steps: int = 0) -> bool:
        """One epoch, entered after its first ``skip_steps`` batches on a
        mid-epoch resume.  Returns False when preempted: a full-state slot
        tagged with the step is on disk."""
        cfg = self.cfg
        self.logger.info(f">>>>>> epochs: {epoch}/{cfg.epochs}")
        self.train_loader.set_epoch(epoch)
        if skip_steps:
            self.train_loader.set_start_step(skip_steps)
            self.logger.info(f"mid-epoch resume: fast-forwarding {skip_steps} steps")
        step_in_epoch = skip_steps
        n_steps = len(self.train_loader)
        profiler = self._start_profile() if cfg.profile and epoch == 1 else None
        losses = []
        start = time.time()
        # the epoch rides in every train batch as a device scalar (DMsH_LN's
        # label net anneals with it), as in ccmh
        epoch_scalar = torch.tensor(epoch, dtype=torch.int32, device=self.device)
        if self.train_resident is not None:
            stream, run_step = self._resident_stream(epoch_scalar)
        elif self.train_chunked is not None:
            stream, run_step = self._chunked_stream(epoch_scalar)
        else:
            def put(b):
                b = self._put(b)
                b["epoch"] = epoch_scalar
                return b

            stream = device_prefetch(self.train_loader, put, depth=cfg.prefetch_device)
            run_step = self.train_step
        for batch in stream:
            self.state, metrics = run_step(self.state, batch)
            self.global_step += 1
            step_in_epoch += 1
            losses.append(metrics["loss"])
            if self.global_step % cfg.display_step == 0:
                m = {k: float(v) for k, v in metrics.items()}
                self.logger.info(f">>>>>> Display >>>>>> [{epoch}/{cfg.epochs}] {m}")
                self.metrics.write("train", self.global_step, **m)
            if self.mesh is not None:
                # a SIGTERM that reached any rank stops every rank here
                self._preempt = self.mesh.any(self._preempt)
            if self._preempt and step_in_epoch < n_steps:
                self.total_time += time.time() - start
                self._stop_profile(profiler)
                self.save_full_checkpoint(epoch, step_in_epoch=step_in_epoch)
                self.logger.info(f"preempted at epoch {epoch} step {step_in_epoch}/{n_steps}; "
                                 "rerun with --resume to continue from this step")
                return False
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.total_time += time.time() - start
        self._stop_profile(profiler)
        mean_loss = float(torch.stack(losses).mean()) if losses else 0.0
        self.logger.info(
            f">>>>>> [{epoch}/{cfg.epochs}] loss: {mean_loss}, time: {self.total_time}")
        return True

    def _start_profile(self):
        """``--profile``: trace epoch 1 (epoch 0 pays the kernels' builds
        and the first calls, as ``ccmh``'s pays its compiles) with
        ``torch.profiler``, host and, on a card, CUDA activity; the trace
        is written to ``save_dir/profile`` when it stops."""
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        out = os.path.join(self.cfg.save_dir, "profile")
        profiler = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(out))
        profiler.start()
        self.logger.info(f"profiling epoch 1 into {out}")
        return profiler

    def _stop_profile(self, profiler) -> None:
        if profiler is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            profiler.stop()

    def _epoch_tables(self, batches):
        """The epoch's host batches as device tables, one copy each
        (``pack_epoch``): yields (table, spec, row) per step."""
        from ccmh_torch.data.resident import pack_epoch
        from ccmh_torch.data.prefetch import to_device

        for table_np, spec, n_rows in pack_epoch(batches):
            table = to_device(table_np, self.device)
            for row in range(n_rows):
                yield table, spec, row

    def _resident_stream(self, epoch_scalar):
        """(items, run_step) of a device-resident epoch: the image-free
        batches packed into one table, each step gathering its images on the
        card."""
        from ccmh_torch.data.resident import make_resident_epoch_step

        stepper = make_resident_epoch_step(self.train_step)
        images = self.train_resident.images

        def run_step(state, item):
            table, spec, row = item
            return stepper(state, table, spec, row, epoch_scalar, images)

        return self._epoch_tables(list(self.train_loader)), run_step

    def _chunked_stream(self, epoch_scalar):
        """(items, run_step) of a chunked epoch: rows below R from the pinned
        region, the others from superblock buffers copied one ahead."""
        from ccmh_torch.data.resident import (
            AsyncBlockPut, augment_chunked_batches, make_chunked_epoch_step,
        )

        ck = self.train_chunked
        stepper = make_chunked_epoch_step(self.train_step)
        aug, blocks, block_of = augment_chunked_batches(list(self.train_loader),
                                                        ck["R"], ck["M"])
        putter = AsyncBlockPut(self.device)

        def start(g):
            def fill():
                buf = np.zeros((ck["M"],) + tuple(ck["row_shape"]), np.uint8)
                if len(blocks[g]):
                    buf[:len(blocks[g])] = ck["cache"].gather(blocks[g])
                return buf
            putter.start(g, fill)

        def items():
            start(0)
            current = (None, None)
            for step, item in enumerate(self._epoch_tables(aug)):
                g = block_of[step]
                if current[0] != g:
                    current = (g, putter.get(g))
                    if g + 1 < len(blocks):
                        start(g + 1)
                yield item + (current[1],)

        def run_step(state, item):
            table, spec, row, sb_buf = item
            return stepper(state, table, spec, row, epoch_scalar,
                           ck["region"].images, sb_buf)

        return items(), run_step

    # ------------------------------------------------------------------- eval
    def get_code(self, loader: BatchIterator, length: int
                 ) -> Tuple[np.ndarray, np.ndarray, float]:
        """±1 codes of a split, scattered by dataset index (train/base.py:
        130-148); the encoder time accumulates over the batches."""
        encode, _ = self._resident_eval_encoders(loader)
        cfg, clip_cfg, params, aux = self.cfg, self.clip_cfg, self.state.params, self.state.aux
        if encode is not None:
            start = time.time()
            img, txt = encode(params, aux)
            return img.cpu().numpy(), txt.cpu().numpy(), time.time() - start
        img_buf = txt_buf = None
        encoder_time = 0.0
        # under a mesh each rank encodes its rows of the batch; the towers
        # gather, so the codes of the whole batch come out on every rank
        with torch.inference_mode(), activated(self.mesh):
            for dev, batch in device_prefetch(loader, self._put_eval, depth=cfg.prefetch_device):
                start = time.time()
                img, txt = self.method.encode(params, aux, dev, cfg, clip_cfg)
                img, txt = img.cpu().numpy(), txt.cpu().numpy()
                encoder_time += time.time() - start
                if img_buf is None:
                    img_buf = np.zeros((length, img.shape[1]), np.int8)
                    txt_buf = np.zeros((length, txt.shape[1]), np.int8)
                valid = batch["valid"]
                idx = batch["index"][valid]
                img_buf[idx] = img[valid]
                txt_buf[idx] = txt[valid]
        return img_buf, txt_buf, encoder_time

    def _put_eval(self, batch):
        """(device batch, host batch): the host batch keeps the indices and
        the valid mask the scatter needs after encoding."""
        return self._put({k: batch[k] for k in ("image", "text", "valid")}), batch

    # hist-vs-exact agreement bound of ccmh's Trainer (trainer.py:821)
    EXACT_MARGIN = 0.02

    @staticmethod
    def _needs_exact(hist_val: float, max_exact: float, max_hist: float,
                     margin: float = EXACT_MARGIN,
                     hist_bias: Optional[float] = None) -> bool:
        """Should this epoch's hist estimate be rechecked exactly?  (a)
        within ``margin`` of the running EXACT max, or (b) within it of the
        running HIST max once the observed |exact - hist| bias exceeds the
        margin (``ccmh``'s rule, trainer.py:824)."""
        if hist_val > max_exact - margin:
            return True
        if hist_bias is not None and hist_bias <= margin:
            return False
        return hist_val > max_hist - margin

    def _eval_labels_dev(self):
        if not hasattr(self, "_labels_dev"):
            self._labels_dev = (
                torch.from_numpy(self.query_labels).to(self.device, torch.float32),
                torch.from_numpy(self.retrieval_labels).to(self.device, torch.float32))
        return self._labels_dev

    def valid(self, epoch: int):
        self.logger.info("Valid.")
        q_img, q_txt, q_time = self.get_code(self.query_loader, len(self.query_data))
        r_img, r_txt, r_time = self.get_code(self.retrieval_loader, len(self.retrieval_data))
        qL, rL = self._eval_labels_dev()
        # ranked over the mesh where there is one; every rank gets the same
        # numbers, so every rank takes the same exact-recheck decisions
        kw = dict(n_bins=self.cfg.output_dim + 1, device=self.device,
                  dist_fn=self.eval_dist_fn, mesh=self.mesh)
        i2t, t2i, i2i, t2t = map(float, calc_map_4way(
            q_img, q_txt, r_img, r_txt, qL, rL, **kw, shard_gallery=self._shard_gallery()))

        # best-epoch decisions use the exact stable-sort metric, the gallery
        # whole on every rank (its full-row sort cannot run sharded)
        hist_i2t, hist_t2i = i2t, t2i
        if self._needs_exact(i2t, self.max_mapi2t, self._max_hist_i2t,
                             hist_bias=self._hist_bias):
            i2t = float(calc_map(q_img, r_txt, qL, rL, method="exact", **kw))
            self._hist_bias = max(self._hist_bias, abs(i2t - hist_i2t))
        if self._needs_exact(t2i, self.max_mapt2i, self._max_hist_t2i,
                             hist_bias=self._hist_bias):
            t2i = float(calc_map(q_txt, r_img, qL, rL, method="exact", **kw))
            self._hist_bias = max(self._hist_bias, abs(t2i - hist_t2i))
        self._max_hist_i2t = max(self._max_hist_i2t, hist_i2t)
        self._max_hist_t2i = max(self._max_hist_t2i, hist_t2i)

        if self.max_mapi2t < i2t:
            self.best_epoch_i = epoch
            if self.cfg.save_mat:
                self.save_mat(q_img, q_txt, r_img, r_txt, mode_name="i2t")
        self.max_mapi2t = max(self.max_mapi2t, i2t)
        if self.max_mapt2i < t2i:
            self.best_epoch_t = epoch
            if self.cfg.save_mat:
                self.save_mat(q_img, q_txt, r_img, r_txt, mode_name="t2i")
        self.max_mapt2i = max(self.max_mapt2i, t2i)

        self.logger.info(
            f">>>>>> [{epoch}/{self.cfg.epochs}], MAP(i->t): {i2t}, MAP(t->i): {t2i}, "
            f"MAP(t->t): {t2t}, MAP(i->i): {i2i}, MAX MAP(i->t): {self.max_mapi2t}, "
            f"MAX MAP(t->i): {self.max_mapt2i}, query_encoder_time: {q_time}, "
            f"retrieval_encoder_time: {r_time}")
        self.metrics.write("valid", self.global_step, epoch=epoch, i2t=i2t, t2i=t2i,
                           i2i=i2i, t2t=t2t, q_encoder_time=q_time, r_encoder_time=r_time)
        if self.cfg.save_csv and self.is_lead:
            csv_path = os.path.join(self.cfg.save_dir, "results.csv")
            write_header = not os.path.exists(csv_path)
            with open(csv_path, "a") as fh:
                if write_header:
                    fh.write("epoch,i2t,t2i,i2i,t2t,max_i2t,max_t2i\n")
                fh.write(f"{epoch},{i2t},{t2i},{i2i},{t2t},"
                         f"{self.max_mapi2t},{self.max_mapt2i}\n")
        if self.method.multi_encode is not None:
            self.valid_multi(epoch)
        return i2t, t2i, i2i, t2t

    def _get_multi_codes(self, loader: BatchIterator, length: int
                         ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """{name: (image codes, text codes)} of a split at every code length
        of ``multi_encode``, scattered by dataset index."""
        _, multi = self._resident_eval_encoders(loader)
        cfg, clip_cfg, params, aux = self.cfg, self.clip_cfg, self.state.params, self.state.aux
        if multi is not None:
            return {name: tuple(c.cpu().numpy() for c in codes)
                    for name, codes in multi(params, aux).items()}
        buffers: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        with torch.inference_mode(), activated(self.mesh):
            for dev, batch in device_prefetch(loader, self._put_eval, depth=cfg.prefetch_device):
                out = self.method.multi_encode(params, aux, dev, cfg, clip_cfg)
                valid = batch["valid"]
                idx = batch["index"][valid]
                for name, codes in out.items():
                    ic, tc = (c.cpu().numpy() for c in codes)
                    if name not in buffers:
                        buffers[name] = (np.zeros((length, ic.shape[1]), np.int8),
                                         np.zeros((length, tc.shape[1]), np.int8))
                    buffers[name][0][idx] = ic[valid]
                    buffers[name][1][idx] = tc[valid]
        return buffers

    def valid_multi(self, epoch: int):
        """Per-length validation of a multi-code method
        (train/TwDH/hash_train.py:219-253 valid_each): the hist mAP quartet
        at each length, with K + 1 distance bins for a K-bit code, its
        best-of in the log and a ``valid_<name>`` row in metrics.jsonl."""
        q = self._get_multi_codes(self.query_loader, len(self.query_data))
        r = self._get_multi_codes(self.retrieval_loader, len(self.retrieval_data))
        qL, rL = self._eval_labels_dev()
        for name in q:
            i2t, t2i, i2i, t2t = map(float, calc_map_4way(
                q[name][0], q[name][1], r[name][0], r[name][1], qL, rL,
                n_bins=q[name][0].shape[1] + 1, device=self.device, mesh=self.mesh,
                shard_gallery=self._shard_gallery()))
            best = self.max_multi.setdefault(name, {"i2t": 0.0, "t2i": 0.0})
            best["i2t"] = max(best["i2t"], i2t)
            best["t2i"] = max(best["t2i"], t2i)
            self.logger.info(
                f">>>>>> [{epoch}/{self.cfg.epochs}] [{name}] MAP(i->t): {i2t}, "
                f"MAP(t->i): {t2i}, MAP(i->i): {i2i}, MAP(t->t): {t2t}, "
                f"MAX i2t: {best['i2t']}, MAX t2i: {best['t2i']}")
            self.metrics.write(f"valid_{name}", self.global_step, epoch=epoch,
                               i2t=i2t, t2i=t2i, i2i=i2i, t2t=t2t)

    def _shard_gallery(self) -> Optional[bool]:
        """``--shard-gallery`` under a mesh; without one it means nothing,
        as in ``ccmh``."""
        return self.cfg.shard_gallery if self.mesh is not None else None

    def test(self, mode_name: str = "i2t"):
        """The exact 4-way mAP of the ``--pretrained`` model (the method's
        ``dist_fn`` where it has one), the codes as ``PR_cruve/<K>-ours-
        <dataset>-<mode_name>.mat`` and the curves as ``curves-{i2t,t2i}.mat``.
        ``test_seconds`` keeps the encode, mAP and curve seconds."""
        if not self.cfg.pretrained:
            raise RuntimeError("test requires --pretrained (train/base.py:278)")
        t0 = time.perf_counter()
        q_img, q_txt, _ = self.get_code(self.query_loader, len(self.query_data))
        r_img, r_txt, _ = self.get_code(self.retrieval_loader, len(self.retrieval_data))
        t1 = time.perf_counter()
        qL, rL = self._eval_labels_dev()
        i2t, t2i, i2i, t2t = map(float, calc_map_4way(
            q_img, q_txt, r_img, r_txt, qL, rL, method="exact", dist_fn=self.eval_dist_fn,
            n_bins=self.cfg.output_dim + 1, device=self.device, mesh=self.mesh))
        t2 = time.perf_counter()
        self.logger.info(
            f">>>>>> MAP(i->t): {i2t}, MAP(t->i): {t2i}, MAP(t->t): {t2t}, MAP(i->i): {i2i}")
        self.save_mat(q_img, q_txt, r_img, r_txt, mode_name=mode_name)
        t3 = time.perf_counter()
        if self.is_lead:
            self.save_pr_curves(q_img, q_txt, r_img, r_txt)
        self.test_seconds = {"encode": t1 - t0, "exact_map": t2 - t1,
                             "curves": time.perf_counter() - t3}
        return i2t, t2i, i2i, t2t

    def save_pr_curves(self, q_img, q_txt, r_img, r_txt):
        """The PR and top-N precision curves of both directions, each from
        one histogram pass on the device, as ``PR_cruve/curves-<dir>.mat``
        beside the code dumps (the reference stops at the dumps)."""
        save_dir = os.path.join(self.cfg.save_dir, "PR_cruve")
        os.makedirs(save_dir, exist_ok=True)
        ns = default_topn(len(self.retrieval_labels))
        kw = dict(device=self.device)
        if self.eval_dist_fn is not None:
            kw.update(dist_fn=self.eval_dist_fn, max_dist=self.cfg.output_dim)
        for name, (qB, rB) in (("i2t", (q_img, r_txt)), ("t2i", (q_txt, r_img))):
            scio.savemat(os.path.join(save_dir, f"curves-{name}.mat"),
                         curves(qB, rB, self.query_labels, self.retrieval_labels, ns, **kw))
        self.logger.info(f">>>>>> save PR/topN curves to {save_dir}")

    def save_mat(self, q_img, q_txt, r_img, r_txt, mode_name="i2t"):
        """.mat export interoperable with reference tooling (train/base.py:328-349);
        the lead rank's alone under a mesh."""
        if not self.is_lead:
            return
        save_dir = os.path.join(self.cfg.save_dir, "PR_cruve")
        os.makedirs(save_dir, exist_ok=True)
        scio.savemat(
            os.path.join(save_dir, f"{self.cfg.output_dim}-ours-{self.cfg.dataset}-{mode_name}.mat"),
            {"q_img": np.asarray(q_img, np.float64), "q_txt": np.asarray(q_txt, np.float64),
             "r_img": np.asarray(r_img, np.float64), "r_txt": np.asarray(r_txt, np.float64),
             "q_l": self.query_labels, "r_l": self.retrieval_labels})
        self.logger.info(f">>>>>> save best {mode_name} data!")

    # ------------------------------------------------------------- checkpoint
    def save_checkpoint(self, path: str):
        """Weights-only ``.npz`` in ``ccmh``'s Trainer format (params, extra,
        aux, step), which ``ccmh`` and ``ccmh_torch`` both restore.  Under a
        mesh every rank calls it (a tensor-parallel state is gathered to
        the canonical layout first) and the lead writes."""
        st = self._canonical_state()
        if not self.is_lead:
            return
        save_checkpoint(path, st.params, extra=st.extra, aux=st.aux, step=np.int32(st.step))
        self.logger.info(f"save model to {path}")

    def _canonical_state(self) -> TrainState:
        """The live state in the canonical (packed, whole) layout, the form
        every checkpoint stores: the live state itself, or under a sharded
        mesh the CLIP tree gathered over the data axis (FSDP), then the
        model axis (a collective: every rank calls it; gating it on the
        lead would leave the others waiting)."""
        if not self._sharded:
            return self.state
        from ccmh_torch.parallel.fsdp import canonical_clip

        st = self.state
        params = {**st.params, "clip": canonical_clip(st.params["clip"], self.clip_cfg,
                                                      self.mesh)}
        return TrainState(params, st.extra, st.aux, st.step, st.generator)

    def _canonical_optimizer(self):
        """The main optimizer, or under a sharded mesh a stand-in whose
        ``state_dict`` holds the moments gathered to the canonical layout
        (a collective)."""
        if not self._sharded:
            return self.optimizer
        from ccmh_torch.parallel.fsdp import unshard_optimizer_state

        sd = unshard_optimizer_state(self.optimizer, self.clip_cfg, self.mesh)
        return types.SimpleNamespace(state_dict=lambda: sd)


    def save_full_checkpoint(self, epoch: int, step_in_epoch: int = 0):
        """A full-state slot (``train/checkpoint.py``) of ``epoch``: the
        state, both optimizers, the step generator and the trackers.
        ``step_in_epoch`` > 0 marks a preemption slot of the epoch in
        progress.  With ``--async-checkpoint`` the write overlaps the steps
        after it; ``train()`` waits for it on every way out."""
        root = os.path.join(self.cfg.save_dir, "state_ckpt")
        state, optimizer = self._canonical_state(), self._canonical_optimizer()
        if not self.is_lead:
            return
        args = (root, state, optimizer, self.extra_optimizer, epoch,
                self._tracker_meta(step_in_epoch))
        if self.cfg.async_checkpoint:
            if self._async_saver is None:
                self._async_saver = AsyncStateSaver()
            self._async_saver.save(*args)
        else:
            save_state(*args)
        at = f" (step {step_in_epoch})" if step_in_epoch else ""
        self.logger.info(f"full-state checkpoint @ epoch {epoch}{at}")

    def _tracker_meta(self, step_in_epoch: int = 0) -> Dict[str, float]:
        """The trackers a slot carries.  step_in_epoch > 0 marks a
        preemption slot: a resume re-enters its epoch after that many steps
        (all of them when the signal landed on the epoch's last step, so
        the resumed run still validates and saves it).  The hist trackers
        make a resumed run take the uninterrupted run's exact-recheck
        decisions; ``ccmh`` does not save them."""
        return {"max_mapi2t": self.max_mapi2t, "max_mapt2i": self.max_mapt2i,
                "best_epoch_i": float(self.best_epoch_i),
                "best_epoch_t": float(self.best_epoch_t),
                "total_time": self.total_time, "step_in_epoch": float(step_in_epoch),
                "max_hist_i2t": self._max_hist_i2t, "max_hist_t2i": self._max_hist_t2i,
                "hist_bias": self._hist_bias}

    def try_resume(self) -> Tuple[int, int]:
        """Restore the newest slot of ``save_dir/state_ckpt``, if any.
        Returns (start_epoch, skip_steps): skip_steps > 0 re-enters the
        slot's epoch after that many steps."""
        if self.mesh is not None:
            self.mesh.barrier()      # what the lead wrote is final
        path = latest_checkpoint(self.cfg.save_dir)
        if path is None:
            return 0, 0
        tree = load_state(path)
        if self._sharded:
            # the canonical slot, sharded again for this rank, parameters
            # and moments alike
            from ccmh_torch.parallel.fsdp import local_clip
            from ccmh_torch.parallel.tp import map_clip_moments, map_clip_subtrees

            def shard(clip):
                return local_clip(clip, self.clip_cfg, self.mesh, self.fsdp)

            tree = {**tree, "params": map_clip_subtrees(tree["params"], shard),
                    "optimizer": map_clip_moments(tree["optimizer"], shard)}
        restore_state(tree, self.state, self.optimizer, self.extra_optimizer)
        meta, epoch = tree["meta"], int(tree["epoch"])
        self.max_mapi2t = meta.get("max_mapi2t", 0.0)
        self.max_mapt2i = meta.get("max_mapt2i", 0.0)
        self.best_epoch_i = int(meta.get("best_epoch_i", 0))
        self.best_epoch_t = int(meta.get("best_epoch_t", 0))
        self.total_time = meta.get("total_time", 0.0)
        self._max_hist_i2t = meta.get("max_hist_i2t", 0.0)
        self._max_hist_t2i = meta.get("max_hist_t2i", 0.0)
        self._hist_bias = meta.get("hist_bias", 0.0)
        self.global_step = self.state.step
        skip = int(meta.get("step_in_epoch", 0))
        if skip:
            self.logger.info(f"resumed from {path} (mid-epoch {epoch}, step {skip})")
            return epoch, skip
        self.logger.info(f"resumed from {path} (completed epoch {epoch})")
        return epoch + 1, 0
