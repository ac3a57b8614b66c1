"""Command-line entry point of the port (``python -m ccmh_torch.cli``).

The same flags and defaults as ``ccmh/cli.py`` (the reference's
main.py:36-46 plus argsbase.py:4-37), plus ``--device`` (default
``cuda``; ``cpu`` only when asked for):

    python -m ccmh_torch.cli --method DCHMT --dataset flickr --output-dim 64 \
        --clip-path vitb32.npz --data-dir /data/flickr

Flags of features the port does not have yet (``--test``, ``--resume``,
checkpoints of the full state, meshes, image caches, ...) raise
``NotImplementedError`` from the Trainer instead of being ignored.
"""

from __future__ import annotations

import argparse
import os
import sys

from ccmh_torch.config import Config
from ccmh_torch.train.methods import available_methods


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    defaults = Config()
    parser.add_argument("--method", type=str, default="DCHMT",
                        help=f"one of {available_methods()}")
    parser.add_argument("--dataset", type=str, default="flickr")
    parser.add_argument("--output-dim", type=int, default=16)
    parser.add_argument("--is-train", action="store_true", default=True)
    parser.add_argument("--test", dest="is_train", action="store_false")

    parser.add_argument("--save-dir", type=str, default=defaults.save_dir)
    parser.add_argument("--clip-path", type=str, default=defaults.clip_path)
    parser.add_argument("--pretrained", type=str, default=defaults.pretrained)
    parser.add_argument("--data-dir", type=str, default=defaults.data_dir)

    parser.add_argument("--epochs", type=int, default=defaults.epochs)
    parser.add_argument("--batch-size", type=int, default=defaults.batch_size)
    parser.add_argument("--query-num", type=int, default=defaults.query_num)
    parser.add_argument("--train-num", type=int, default=defaults.train_num)
    parser.add_argument("--seed", type=int, default=defaults.seed)
    parser.add_argument("--max-words", type=int, default=defaults.max_words)
    parser.add_argument("--resolution", type=int, default=defaults.resolution)
    parser.add_argument("--display-step", type=int, default=defaults.display_step)

    parser.add_argument("--lr", type=float, default=defaults.lr)
    parser.add_argument("--clip-lr", type=float, default=defaults.clip_lr)
    parser.add_argument("--weight-decay", type=float, default=defaults.weight_decay)
    parser.add_argument("--warmup-proportion", type=float, default=defaults.warmup_proportion)
    parser.add_argument("--lr-decay", type=float, default=defaults.lr_decay,
                        help="accepted for CLI parity with argsbase.py:15 but UNUSED "
                             "— no reference trainer reads it; a warning is emitted "
                             "if a non-default value is passed")
    parser.add_argument("--lr-decay-freq", type=int, default=defaults.lr_decay_freq,
                        help="accepted for CLI parity with argsbase.py:26 but UNUSED "
                             "(see --lr-decay)")

    # reference argsbase.py:8-15 toggles
    parser.add_argument("--save-mat", dest="save_mat", action="store_true",
                        default=defaults.save_mat)
    parser.add_argument("--no-save-mat", dest="save_mat", action="store_false")
    parser.add_argument("--save-model", dest="save_model", action="store_true",
                        default=defaults.save_model)
    parser.add_argument("--save-csv", dest="save_csv", action="store_true",
                        default=defaults.save_csv)
    parser.add_argument("--valid", dest="valid", action="store_true",
                        default=defaults.valid)
    parser.add_argument("--no-valid", dest="valid", action="store_false")
    parser.add_argument("--vit-use", dest="vit_use", action="store_true",
                        default=defaults.vit_use,
                        help="accepted for CLI parity with argsbase.py:31 but UNUSED "
                             "— the reference never reads it either; the tower is "
                             "always the architecture of the loaded checkpoint")
    parser.add_argument("--no-vit-use", dest="vit_use", action="store_false")
    parser.add_argument("--num-workers", type=int, default=defaults.num_workers)
    parser.add_argument("--no-ragged-last", dest="ragged_last",
                        action="store_false", default=defaults.ragged_last,
                        help="wrap-pad the final train batch to the full batch "
                             "size instead of training it at its true "
                             "(reference-parity) size")
    parser.add_argument("--eval-batch", type=int, default=defaults.eval_batch)
    parser.add_argument("--compute-dtype", type=str, default=defaults.compute_dtype,
                        help="float32 (default) or bfloat16 towers")

    # ccmh's flags for features this package does not have yet: kept so
    # that a command line of ccmh parses, and refused by the Trainer
    unported = "not yet ported to ccmh_torch: raises NotImplementedError"
    parser.add_argument("--cache-images", dest="cache_images", action="store_true",
                        default=defaults.cache_images, help=unported)
    parser.add_argument("--cache-dir", type=str, default=defaults.cache_dir, help=unported)
    parser.add_argument("--device-resident", dest="device_resident_images",
                        choices=["auto", "on", "off"],
                        default=defaults.device_resident_images,
                        help="'on' is " + unported + "; images always stream")
    parser.add_argument("--remat", action="store_true", default=defaults.remat, help=unported)
    parser.add_argument("--checkpoint-every", type=int, default=defaults.checkpoint_every,
                        help="full-state checkpoints: " + unported)
    parser.add_argument("--async-checkpoint", dest="async_checkpoint",
                        action="store_true", default=defaults.async_checkpoint, help=unported)
    parser.add_argument("--resume", action="store_true", default=defaults.resume,
                        help=unported)
    parser.add_argument("--profile", action="store_true", default=defaults.profile,
                        help=unported)
    parser.add_argument("--compilation-cache", type=str,
                        default=defaults.compilation_cache, metavar="DIR", help=unported)
    parser.add_argument("--mesh", type=str, default="1",
                        help="device mesh shape; anything but '1' is " + unported)
    parser.add_argument("--fsdp", action="store_true", default=False, help=unported)
    parser.add_argument("--shard-gallery", type=str, default="auto",
                        choices=["auto", "true", "false"],
                        help="mesh eval gallery placement; " + unported)
    parser.add_argument("--clip-arch", type=str, default="vit-b-32",
                        choices=["vit-b-32", "tiny"],
                        help="architecture for random init when no --clip-path "
                             "is given ('tiny' for smoke tests)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default: one card) or cpu")
    parser.add_argument("--set", action="append", default=[],
                        metavar="SECTION.FIELD=VALUE",
                        help="method hyperparameter override, e.g. --set dchmt.vartheta=0.3")
    return parser


def config_from_args(argv=None) -> Config:
    args = build_parser().parse_args(argv)
    defaults = Config()
    # flags the reference declares but never reads (argsbase.py:15,26,31):
    # kept for CLI parity, but a non-default value must not silently no-op
    for flag, field in (("--lr-decay", "lr_decay"),
                        ("--lr-decay-freq", "lr_decay_freq"),
                        ("--vit-use/--no-vit-use", "vit_use")):
        if getattr(args, field) != getattr(defaults, field):
            import warnings

            warnings.warn(
                f"{flag} is accepted for CLI parity with the reference "
                f"(argsbase.py) but is UNUSED there and here — the value "
                f"has no effect", stacklevel=2)
    cfg = Config(
        method=args.method, dataset=args.dataset, output_dim=args.output_dim,
        is_train=args.is_train,
        save_dir=os.path.join(args.save_dir, args.method, args.dataset, str(args.output_dim)),
        clip_path=args.clip_path, pretrained=args.pretrained, data_dir=args.data_dir,
        epochs=args.epochs, batch_size=args.batch_size, query_num=args.query_num,
        train_num=args.train_num, seed=args.seed, max_words=args.max_words,
        resolution=args.resolution, display_step=args.display_step,
        lr=args.lr, clip_lr=args.clip_lr, weight_decay=args.weight_decay,
        warmup_proportion=args.warmup_proportion, eval_batch=args.eval_batch,
        lr_decay=args.lr_decay, lr_decay_freq=args.lr_decay_freq,
        save_mat=args.save_mat, save_model=args.save_model,
        save_csv=args.save_csv, valid=args.valid, vit_use=args.vit_use,
        num_workers=args.num_workers,
        cache_images=args.cache_images, cache_dir=args.cache_dir,
        device_resident_images=args.device_resident_images,
        ragged_last=args.ragged_last,
        compute_dtype=args.compute_dtype, remat=args.remat,
        checkpoint_every=args.checkpoint_every,
        async_checkpoint=args.async_checkpoint,
        resume=args.resume, profile=args.profile,
        compilation_cache=args.compilation_cache,
        mesh_shape=tuple(int(x) for x in args.mesh.split(",")),
        fsdp=args.fsdp,
        shard_gallery={"auto": None, "true": True, "false": False}[
            args.shard_gallery],
    )
    for override in args.set:
        key, _, raw = override.partition("=")
        section, dot, field = key.partition(".")
        # "--set dsph.alpha=0.5" targets a method section; a dotless key
        # ("--set remat_policy=dots") targets the top-level config
        sub = getattr(cfg, section) if dot else cfg
        if not dot:
            field = section
        current = getattr(sub, field)
        typ = type(current) if current is not None else str
        value = raw == "True" if typ is bool else typ(raw)
        setattr(sub, field, value)
    return cfg


def main(argv=None):
    from ccmh_torch.train.trainer import Trainer

    args = build_parser().parse_args(argv)
    cfg = config_from_args(argv)
    clip_cfg = None
    if not cfg.clip_path and args.clip_arch == "tiny":
        from ccmh_torch.clip.model import ClipConfig

        clip_cfg = ClipConfig.tiny()
        cfg = cfg.replace(resolution=clip_cfg.image_resolution)
    trainer = Trainer(cfg, clip_cfg=clip_cfg, device=args.device)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
