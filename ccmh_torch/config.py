"""Structured configuration for the ccmh framework.

One dataclass replaces the reference's two-stage argparse dance
(reference: argsbase.py:4-37 plus each train/<METHOD>/get_args.py, merged via
``argparse.Namespace(**vars(a), **vars(b))``).  Defaults are identical to the
reference so runs are comparable; per-method hyperparameters live in typed
sub-configs keyed by method name.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

METHODS = (
    "DSPH", "DCHMT", "TwDH", "MITH", "DNPH", "DHaPH", "DMsH_LN", "DNpH",
    "DPBE", "DDWSH", "DDBH", "DScPH", "DPSIH", "DGHDGH",
)

# Per-dataset class counts (reference: train/base.py:39-52).
DATASET_NCLASS = {"flickr": 24, "coco": 80, "nuswide": 21, "iapr": 291}


@dataclass
class DCHMTConfig:
    # reference: train/DCHMT/get_args.py:11-16
    hash_layer: str = "select"            # "select" (softmax pairs) or "linear"
    similarity_function: str = "euclidean"  # "cosine" or "euclidean"
    loss_type: str = "l2"                 # "l1" or "l2"
    vartheta: float = 0.5                 # tolerated error-code rate
    sim_threshold: float = 0.1


@dataclass
class DSPHConfig:
    # reference: train/DSPH/get_args.py:11-13, loss.py:13-20
    hypseed: int = 0
    alpha: float = 0.8                    # pairwise regulariser weight
    proxy_lr: float = 0.02                # SGD lr for proxies (hash_train.py:44)
    proxy_momentum: float = 0.9
    proxy_weight_decay: float = 5e-4


@dataclass
class MITHConfig:
    # reference: train/MITH/get_args.py:16-28
    hyper_tokens_intra: float = 1.0
    hyper_cls_inter: float = 10.0
    hyper_quan: float = 8.0
    hyper_info_nce: float = 50.0
    hyper_alpha: float = 0.01
    hyper_lambda: float = 0.99            # EMA factor for joint sign target
    hyper_distill: float = 1.0
    top_k_label: int = 8                  # localized token aggregation top-k
    res_mlp_layers: int = 2
    transformer_layers: int = 2
    nce_temperature: float = 0.07


@dataclass
class DNPHConfig:
    # reference: train/DNPH_TOMM/{get_args.py,loss.py,b_reg.py,hash_train.py}
    proxy_lr: float = 1e-4
    noise_weight: float = 0.1             # b_reg.py:41 scaling of noise term
    quan_alpha: float = 0.01
    # The reference constructs torch.optim.SGD over the proxies
    # (hash_train.py:48) but never calls its step(), so upstream proxies
    # never move.  Default reproduces that (imported reference .pth
    # checkpoints continue on reference-faithful dynamics); set True to
    # opt into the clearly-intended repair of actually stepping them.
    step_proxies: bool = False


@dataclass
class TwDHConfig:
    # reference: train/TwDH/get_args.py + hash_train.py
    low_rate: float = 0.0                 # weight of short-code losses
    short_dims: Tuple[int, ...] = ()      # e.g. (16,) for long=32
    center_path: str = ""                 # dir with long/short/trans assets


@dataclass
class DHaPHConfig:
    # reference: train/DHaPH/{get_args.py,HPloss.py,hp_model.py}
    n_proxies: int = 500                  # trainable LCAs
    curvature: float = 0.1                # Poincare ball c
    clip_r: float = 2.3
    hp_lr: float = 1e-5
    temperature: float = 0.1
    topk: int = 15                        # reciprocal-topk triplet mining
                                          # (hash_train.py:78 passes args.topk,
                                          # get_args.py:13 default 15)
    ms_warm_epoch_frac: float = 1.0 / 3.0


@dataclass
class DMsHLNConfig:
    # reference: train/DMsH_LN/{MSLOSS.py,labelnet.py}
    ms_thresh: float = 0.5
    ms_margin: float = 0.1
    scale_pos: float = 2.0
    scale_neg: float = 40.0
    labelnet_lr: float = 1e-3


@dataclass
class DNpHTMMConfig:
    # reference: train/DNpH_TMM/loss.py (quadratic mutual information)
    pass


@dataclass
class DPBEConfig:
    # reference: train/DPBE/{get_args.py,hash_train.py}
    n_samples: int = 5                    # posterior weight samples per step
    hessian_ema: float = 0.999
    max_pairs: int = 5000
    prior_prec: float = 1.0
    use_lam: bool = True


@dataclass
class DDWSHConfig:
    # reference: train/DDWSH/loss.py
    beta_init: float = 1.2
    margin: float = 0.2
    nu: float = 0.0
    cutoff: float = 0.5
    nonzero_loss_cutoff: float = 1.4
    beta_lr: float = 5e-4


@dataclass
class DDBHConfig:
    # reference: train/DDBH/loss.py + hash_train.py
    quan_weight: float = 0.1
    sigmoid_alpha: float = 1.0


@dataclass
class DScPHConfig:
    # reference: train/DScPH/{CPF_loss.py,FAST_HPP.py}
    tau: float = 0.9
    bit_var_weight: float = 0.1
    rot_lr: float = 1e-3
    # Repair gate: the reference never puts the Householder rotation in any
    # optimizer group (train/DScPH/hash_train.py:37-44 — recorded bug), so
    # upstream the rotation stays frozen at identity.  True (default) trains
    # it as clearly intended; False reproduces the reference's frozen-rot
    # dynamics exactly (used by the whole-loop parity test).
    train_rot: bool = True


@dataclass
class DPSIHConfig:
    # reference: train/DPSIH/{Loss.py,get_args.py}
    msc_weight: float = 100.0
    margin: float = 0.25
    sim_kind: str = "cosine"
    grad_clip: float = 2.0


@dataclass
class DGHDGHConfig:
    # reference: train/DGHDGH/get_args.py:11-21 defaults (the GNN modules
    # are missing upstream; ccmh reconstructs them — docs/dghdgh_reconstruction.md)
    n_layers: int = 2       # GNN message-passing rounds (GNN_LAYER)
    n_heads: int = 4        # attention heads per round (ATT_HEAD)
    gnn_hidden: int = 0     # edge-MLP hidden width (0 -> 2 * output_dim)
    alpha: float = 5.0      # GeneralPulling hardness (loss.alpha)
    beta: float = 2.0       # adaptive-λ3 temperature (loss.beta)
    margin: float = 0.25    # triplet margin (loss.py:84 default)
    lambda1: float = 1.0    # J_r
    lambda2: float = 1.0    # J_gca
    lambda4: float = 10.0   # J_cz
    lambda5: float = 10.0   # J_ce
    lambda6: float = 10.0   # J_sim
    lambda7: float = 0.3    # J_div
    # Reference-faithful step sequencing (train/DGHDGH/hash_train.py:75-130
    # runs THREE backward/step phases per batch: J_m -> model+GNN, λ4·J_cz ->
    # classifier, J_gen -> GNN again — the GNN takes two Adam steps per batch
    # and stage 1 sees the post-step GNN/classifier).  Default False = the
    # fused single-step form (one XLA program, same gradient routing, one
    # GNN update combining both contributions — docs/dghdgh_reconstruction.md
    # free choice 5); True = the exact three-phase sequencing.
    sequenced: bool = False


_METHOD_CONFIGS = {
    "DCHMT": DCHMTConfig, "DSPH": DSPHConfig, "MITH": MITHConfig,
    "DNPH": DNPHConfig, "TwDH": TwDHConfig, "DHaPH": DHaPHConfig,
    "DMsH_LN": DMsHLNConfig, "DNpH": DNpHTMMConfig, "DPBE": DPBEConfig,
    "DDWSH": DDWSHConfig, "DDBH": DDBHConfig, "DScPH": DScPHConfig,
    "DPSIH": DPSIHConfig, "DGHDGH": DGHDGHConfig,
}


@dataclass
class Config:
    """Top-level run configuration (defaults: reference argsbase.py:4-37)."""

    # run identity
    method: str = "DCHMT"
    dataset: str = "flickr"
    output_dim: int = 16                  # hash code length K
    is_train: bool = True

    # paths
    save_dir: str = "./result/"
    clip_path: str = ""                   # OpenAI ViT-B-32.pt (torch), converted .npz,
                                          # or a HuggingFace CLIP checkpoint directory
    pretrained: str = ""                  # resume weights
    data_dir: str = ""                    # dir with index.mat/caption.mat/label.mat
    save_mat: bool = True
    save_model: bool = False
    save_csv: bool = True
    valid: bool = True

    # schedule
    epochs: int = 200
    batch_size: int = 300
    query_num: int = 5000
    train_num: int = 10000
    seed: int = 1814
    display_step: int = 50
    lr_decay_freq: int = 5
    lr_decay: float = 0.9

    # optimization
    lr: float = 1e-3                      # hashing-head lr
    clip_lr: float = 1e-5                 # CLIP backbone lr
    weight_decay: float = 0.2
    warmup_proportion: float = 0.1

    # model / data shape
    resolution: int = 224
    max_words: int = 32
    vit_use: bool = True
    num_workers: int = 8                  # host data-pipeline threads
    cache_images: bool = False            # decoded-tensor cache (data/cache.py)
    cache_dir: str = ""                   # default: <data_dir>/_ccmh_cache
    ragged_last: bool = True              # true-size final train batch (ref parity)
    shuffle: bool = True                  # epoch-shuffle the train split
                                          # (off: deterministic order, used
                                          # by the whole-loop parity harness)
    # device-side double buffering (data/prefetch.py): batches resident on
    # device ahead of the step so H2D transfer overlaps compute; <=1 means
    # serialized put-then-step
    prefetch_device: int = 2
    # device-resident epochs (data/resident.py): with cache_images on a
    # single-device run, pin the decoded uint8 train split to HBM once and
    # gather each batch on-device — per-step host traffic drops to the
    # ids/labels.  Bit-exact vs streaming (same cache pixels, same shuffle
    # and caption draws); "auto" pins when the split fits the budget,
    # "on" requires it, "off" always streams.
    device_resident_images: str = "auto"
    device_resident_budget_mb: int = 6144
    # chunked (hybrid) residency for over-budget splits: superblock pixel
    # buffer size in rows (0 = max(batch_size, 512)); the budget covers the
    # pinned region + 2 such buffers (current + prefetched next)
    device_resident_block_rows: int = 0

    # TPU-specific
    remat: bool = False                   # recompute tower activations in bwd
    remat_policy: str = "full"            # "full" | "dots" (save matmul outs)
    # lax.scan unroll over the transformer blocks: -1/0 = full unroll (no
    # while-loop, no dynamic_update_slice stacking of activation saves in
    # the backward).  Default FULL: measured 103.1 -> 78.1 ms on the B=256
    # bf16 DSPH train step on v5e (+32% throughput, tools/profile_step.py);
    # numerics identical (test_scan_unroll_identical).  Set 1 for the
    # classic scan (fastest compile).
    scan_unroll: int = 0
    mesh_shape: Tuple[int, ...] = (1,)    # (dp,) data mesh, or (dp, tp) for
    # a 2-D ("data", "model") mesh with Megatron-sharded towers (parallel/tp.py)
    # ZeRO-style fully-sharded data parallelism (parallel/fsdp.py): large
    # tower weights + BertAdam moments shard over the "data" axis instead
    # of replicating (per-chip tower state divides by dp; composes with a
    # (dp, tp) mesh).  Numerics match plain DP; collective schedule differs.
    fsdp: bool = False
    # mesh eval gallery placement: None = auto (shard the gallery axis for
    # hist-path galleries >= 2^20 items, replicate otherwise), True/False
    # force.  Sharding divides per-chip gallery residency by the device
    # count (SURVEY §2.6 sharded-gallery eval); exact-path ranking always
    # replicates (its full-row sort cannot run sharded).
    shard_gallery: Optional[bool] = None
    param_dtype: str = "float32"
    compute_dtype: str = "float32"        # "bfloat16" for production
    # BertAdam m/v moment STORAGE dtype ("bfloat16" halves optimizer HBM
    # traffic and frees ~600 MB on-chip for the ViT-B/32 towers; update
    # math stays fp32).  Deliberate deviation from the reference when
    # changed — default float32 is bit-exact BertAdam.
    optim_moments_dtype: str = "float32"
    eval_batch: int = 512
    checkpoint_every: int = 0             # orbax checkpoint period (0 = off)
    async_checkpoint: bool = False        # overlap checkpoint writes with training
    resume: bool = False                  # auto-resume from save_dir/state_ckpt
    profile: bool = False
    # persistent XLA compilation cache directory ("" = off): first compile
    # of each (program, shape) is written to disk and every later process
    # start loads it instead of recompiling — on TPU the 20-40 s tower
    # compiles happen once per machine, not once per run.  Shared safely
    # across concurrent runs (content-addressed entries).
    compilation_cache: str = ""

    # filled in at runtime
    nclass: int = 0
    retrieval_num: int = 0

    # per-method hyperparameters
    dchmt: DCHMTConfig = field(default_factory=DCHMTConfig)
    dsph: DSPHConfig = field(default_factory=DSPHConfig)
    mith: MITHConfig = field(default_factory=MITHConfig)
    dnph: DNPHConfig = field(default_factory=DNPHConfig)
    twdh: TwDHConfig = field(default_factory=TwDHConfig)
    dhaph: DHaPHConfig = field(default_factory=DHaPHConfig)
    dmsh_ln: DMsHLNConfig = field(default_factory=DMsHLNConfig)
    dnph_tmm: DNpHTMMConfig = field(default_factory=DNpHTMMConfig)
    dpbe: DPBEConfig = field(default_factory=DPBEConfig)
    ddwsh: DDWSHConfig = field(default_factory=DDWSHConfig)
    ddbh: DDBHConfig = field(default_factory=DDBHConfig)
    dscph: DScPHConfig = field(default_factory=DScPHConfig)
    dpsih: DPSIHConfig = field(default_factory=DPSIHConfig)
    dghdgh: DGHDGHConfig = field(default_factory=DGHDGHConfig)

    def __post_init__(self):
        if self.nclass == 0 and self.dataset in DATASET_NCLASS:
            self.nclass = DATASET_NCLASS[self.dataset]

    def method_config(self) -> Any:
        key = {
            "DNpH": "dnph_tmm", "DNPH": "dnph", "DMsH_LN": "dmsh_ln",
        }.get(self.method, self.method.lower())
        return getattr(self, key)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        base_fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs: Dict[str, Any] = {}
        for k, v in d.items():
            if k not in base_fields:
                raise KeyError(f"unknown config key: {k}")
            f = base_fields[k]
            if dataclasses.is_dataclass(f.type) or (
                isinstance(f.default_factory, type) and dataclasses.is_dataclass(f.default_factory)
            ):
                kwargs[k] = f.default_factory(**v) if isinstance(v, dict) else v
            else:
                kwargs[k] = v
        return cls(**kwargs)
