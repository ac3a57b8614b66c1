"""Trainer: the epoch loop, validation by mAP, weights-only checkpoints
(port of the core of ``ccmh/train/trainer.py``).

One device (``cuda`` unless the caller asks for ``cpu``).  Per epoch: the
train split streams from :class:`BatchIterator` (host assembly on threads,
pinned host buffers on the card), each batch runs one eager train step
(CLIP forward x2, heads, loss, backward, the method's global gradient
clip where it has one, BertAdam, and the method's own optimizer for its
loss-side ``extra`` parameters where it has one, as DSPH's proxy SGD);
the epoch rides in every batch, and a ``needs_mask`` method's batches
carry the key-padding mask.  Then ``valid`` extracts
±1 codes for the query and retrieval splits, ranks them (by Hamming
distance, or the method's own ``dist_fn``) with the histogram mAP
and rechecks candidates for a best epoch with the exact stable-sort mAP
(``ccmh``'s ``_needs_exact``), keeps the best-epoch trackers, and writes
the ``.mat`` codes, the csv and the reference's log lines.  ``--save-model``
writes ``model-<epoch>.npz`` in ``ccmh``'s format, which both packages load.

Not ported, each raising when asked for: ``--resume`` and full-state
checkpoints, preemption on SIGTERM, ``test()`` with its PR curves,
multi-length encoders (``multi_encode``), meshes (DP/TP/FSDP), image
caches and device residency, remat, profiling, compilation caches.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import scipy.io as scio
import torch

from ccmh_torch.bridge import params_from_jax
from ccmh_torch.clip.convert import load_params_npz
from ccmh_torch.clip.model import ClipConfig, init_clip_params
from ccmh_torch.config import Config
from ccmh_torch.data.dataset import BatchIterator, CrossModalDataset
from ccmh_torch.data.split import SplitData, make_splits
from ccmh_torch.device import DeviceLike, resolve_device
from ccmh_torch.ops.map_metric import calc_map, calc_map_4way
from ccmh_torch.train.checkpoint import load_checkpoint, save_checkpoint
from ccmh_torch.train.methods import get_method
from ccmh_torch.train.optim import tree_leaves_with_path
from ccmh_torch.train.state import TrainState, make_main_optimizer, make_train_step, trainable
from ccmh_torch.utils import MetricsWriter, get_logger


def _unported(cfg: Config):
    """(setting, why) for each setting of ``cfg`` the port cannot honour."""
    checks = (
        (not cfg.is_train, "--test (test() with PR curves)"),
        (cfg.resume, "--resume (full-state checkpoints)"),
        (cfg.checkpoint_every > 0, "--checkpoint-every (full-state checkpoints)"),
        (cfg.async_checkpoint, "--async-checkpoint"),
        (cfg.profile, "--profile"),
        (bool(cfg.compilation_cache), "--compilation-cache"),
        (tuple(cfg.mesh_shape) != (1,), f"--mesh {cfg.mesh_shape} (DP/TP meshes)"),
        (cfg.fsdp, "--fsdp"),
        (cfg.shard_gallery is not None, "--shard-gallery (mesh eval)"),
        (cfg.cache_images, "--cache-images (decoded-image caches)"),
        (bool(cfg.cache_dir), "--cache-dir"),
        (cfg.device_resident_images == "on", "--device-resident on"),
        (cfg.remat, "--remat"),
        (cfg.optim_moments_dtype != "float32", "optim_moments_dtype"),
        (cfg.param_dtype != "float32", "param_dtype"),
    )
    return [why for bad, why in checks if bad]


class Trainer:
    def __init__(self, cfg: Config, *, splits: Optional[SplitData] = None,
                 clip_cfg: Optional[ClipConfig] = None, clip_params=None,
                 device: DeviceLike = "cuda"):
        missing = _unported(cfg)
        if missing:
            raise NotImplementedError(
                "not yet ported to ccmh_torch: " + ", ".join(missing))
        self.cfg = cfg
        self.device = resolve_device(device)
        os.makedirs(cfg.save_dir, exist_ok=True)
        self.logger = get_logger(os.path.join(cfg.save_dir, "train.log"))
        self.metrics = MetricsWriter(os.path.join(cfg.save_dir, "metrics.jsonl"),
                                     tensorboard_dir=os.path.join(cfg.save_dir, "tensorboard"))
        self.method = get_method(cfg.method)

        # the tower checkpoint fixes the image resolution, so it is read
        # before the datasets
        if clip_params is None and cfg.clip_path:
            if not cfg.clip_path.endswith(".npz"):
                raise NotImplementedError(
                    f"--clip-path {cfg.clip_path}: only ccmh's .npz tower files are "
                    "read by ccmh_torch (OpenAI .pt and HuggingFace conversion is "
                    "not yet ported)")
            clip_params, clip_cfg = load_params_npz(cfg.clip_path, device=self.device)
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
        self.train_loader = BatchIterator(
            self.train_data, cfg.batch_size, shuffle=cfg.shuffle, seed=cfg.seed,
            num_workers=nw, ragged_last=cfg.ragged_last)
        self.query_loader = BatchIterator(self.query_data, cfg.eval_batch, shuffle=False,
                                          seed=cfg.seed, num_workers=nw)
        self.retrieval_loader = BatchIterator(self.retrieval_data, cfg.eval_batch,
                                              shuffle=False, seed=cfg.seed, num_workers=nw)

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
            params, extra, aux, step = self._restore(cfg.pretrained, params, extra)
        if "train_labels" in aux:
            # MITH's buffer losses compare against the whole train split; the
            # labels are this run's, also after --pretrained (ccmh keeps a
            # checkpoint's own)
            aux["train_labels"] = torch.from_numpy(self.train_data.all_labels()).to(self.device)
        params = trainable(params)
        self.optimizer = make_main_optimizer(cfg, params, len(self.train_loader))
        # the loss-side extra parameters train only under the method's own
        # optimizer (ccmh's extra_tx)
        self.extra_optimizer = None
        if extra is not None and self.method.extra_optimizer is not None:
            extra = trainable(extra)
            self.extra_optimizer = self.method.extra_optimizer(cfg, extra)
        self.state = TrainState(params, extra, aux, step,
                                torch.Generator(device=self.device).manual_seed(cfg.seed + 1))
        self.train_step = make_train_step(self.method.make_loss_fn(cfg, clip_cfg),
                                          self.optimizer, self.extra_optimizer,
                                          grad_clip=self.method.grad_clip)
        # the method's own ranking distance in evaluation (DPSIH), else Hamming
        self.eval_dist_fn = self.method.dist_fn(cfg) if self.method.dist_fn else None

    def _restore(self, path: str, params, extra):
        """Weights of a ccmh-format ``.npz`` (``restore_state``'s npz branch):
        the params tree replaces the fresh one, and its ``extra`` tree the
        fresh extra where it holds one; aux and step come along."""
        ckpt = load_checkpoint(path)
        trees = [("params", params, ckpt["params"])]
        if ckpt["extra"] is not None:
            trees.append(("extra", extra or {}, ckpt["extra"]))
        for name, fresh, saved in trees:
            want = {k: tuple(v.shape) for k, v in tree_leaves_with_path(fresh)}
            got = {k: tuple(np.shape(v)) for k, v in tree_leaves_with_path(saved)}
            if want != got:
                diff = sorted(set(want.items()) ^ set(got.items()))[:6]
                raise ValueError(f"{path} does not fit this {self.cfg.method} run "
                                 f"(K={self.cfg.output_dim}, {self.clip_cfg}): {name} {diff}")
        if ckpt["extra"] is not None:
            extra = params_from_jax(ckpt["extra"], device=self.device)
        self.logger.info(f"loaded checkpoint {path}")
        return (params_from_jax(ckpt["params"], device=self.device), extra,
                params_from_jax(ckpt["aux"], device=self.device), ckpt["step"])

    # ------------------------------------------------------------------ train
    def run(self):
        self.train()

    def train(self):
        self.logger.info("Start train.")
        for epoch in range(self.cfg.epochs):
            self.train_epoch(epoch)
            if self.cfg.valid:
                self.valid(epoch)
            if self.cfg.save_model:
                self.save_checkpoint(os.path.join(self.cfg.save_dir, f"model-{epoch}.npz"))
        self.logger.info(
            f">>>>>>> FINISHED >>>>>> Best epoch, I-T: {self.best_epoch_i}, "
            f"mAP: {self.max_mapi2t}, T-I: {self.best_epoch_t}, mAP: {self.max_mapt2i}")

    def _put(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host batch -> device tensors (through pinned buffers on the card,
        so the copies run asynchronously)."""
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def train_epoch(self, epoch: int) -> None:
        cfg = self.cfg
        self.logger.info(f">>>>>> epochs: {epoch}/{cfg.epochs}")
        self.train_loader.set_epoch(epoch)
        losses = []
        start = time.time()
        # the epoch rides in every train batch as a device scalar (DMsH_LN's
        # label net anneals with it), as in ccmh
        epoch_scalar = torch.tensor(epoch, dtype=torch.int32, device=self.device)
        for batch in self.train_loader:
            batch = self._put(batch)
            batch["epoch"] = epoch_scalar
            self.state, metrics = self.train_step(self.state, batch)
            self.global_step += 1
            losses.append(metrics["loss"])
            if self.global_step % cfg.display_step == 0:
                m = {k: float(v) for k, v in metrics.items()}
                self.logger.info(f">>>>>> Display >>>>>> [{epoch}/{cfg.epochs}] {m}")
                self.metrics.write("train", self.global_step, **m)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.total_time += time.time() - start
        mean_loss = float(torch.stack(losses).mean()) if losses else 0.0
        self.logger.info(
            f">>>>>> [{epoch}/{cfg.epochs}] loss: {mean_loss}, time: {self.total_time}")

    # ------------------------------------------------------------------- eval
    def get_code(self, loader: BatchIterator, length: int
                 ) -> Tuple[np.ndarray, np.ndarray, float]:
        """±1 codes of a split, scattered by dataset index (train/base.py:
        130-148); the encoder time accumulates over the batches."""
        img_buf = txt_buf = None
        encoder_time = 0.0
        cfg, clip_cfg, params, aux = self.cfg, self.clip_cfg, self.state.params, self.state.aux
        with torch.inference_mode():
            for batch in loader:
                start = time.time()
                dev = self._put({"image": batch["image"], "text": batch["text"]})
                img = self.method.encode_image(params, aux, dev["image"], cfg, clip_cfg)
                txt = self.method.encode_text(params, aux, dev["text"], cfg, clip_cfg)
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
        kw = dict(n_bins=self.cfg.output_dim + 1, device=self.device,
                  dist_fn=self.eval_dist_fn)
        i2t, t2i, i2i, t2t = map(float, calc_map_4way(q_img, q_txt, r_img, r_txt, qL, rL, **kw))

        # best-epoch decisions use the exact stable-sort metric
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
        if self.cfg.save_csv:
            csv_path = os.path.join(self.cfg.save_dir, "results.csv")
            write_header = not os.path.exists(csv_path)
            with open(csv_path, "a") as fh:
                if write_header:
                    fh.write("epoch,i2t,t2i,i2i,t2t,max_i2t,max_t2i\n")
                fh.write(f"{epoch},{i2t},{t2i},{i2i},{t2t},"
                         f"{self.max_mapi2t},{self.max_mapt2i}\n")
        return i2t, t2i, i2i, t2t

    def test(self):
        raise NotImplementedError("Trainer.test (exact mAP with PR curves) is not yet "
                                  "ported to ccmh_torch")

    def save_mat(self, q_img, q_txt, r_img, r_txt, mode_name="i2t"):
        """.mat export interoperable with reference tooling (train/base.py:328-349)."""
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
        aux, step), which ``ccmh`` and ``ccmh_torch`` both restore."""
        st = self.state
        save_checkpoint(path, st.params, extra=st.extra, aux=st.aux, step=np.int32(st.step))
        self.logger.info(f"save model to {path}")

