"""ccmh_torch — the PyTorch/CUDA port of ccmh for NVIDIA Hopper (H100).

The JAX package ``ccmh`` stays the reference; this package re-implements
it slice by slice in PyTorch, with every Pallas TPU kernel on a ported
path replaced by a CUDA C++ kernel written for ``sm_90a``
(``ccmh_torch/csrc``).  It imports ``torch`` and never ``jax`` or ``ccmh``:
host modules it shares with ``ccmh`` are kept as copies.

Ported so far: the serving path (ViT-B/32 DCHMT encode -> Hamming top-k ->
HTTP) and training of DCHMT and the LinearHash methods DSPH, DNpH, DDBH,
DMsH_LN, DScPH and DDWSH (CLI -> Trainer -> train step -> BertAdam and a
method's own optimizer for its loss-side parameters, with validation by
mAP).  Layers, from the entry points down:

  ccmh_torch.cli        — training CLI (``python -m ccmh_torch.cli``)
  ccmh_torch.serve      — HTTP daemon (``python -m ccmh_torch.serve``)
  ccmh_torch.retrieval  — Retriever (per-tower encode) + HashIndex (top-k)
  ccmh_torch.train      — Trainer, train state and step, BertAdam, Method
                          protocol (DCHMT, the LinearHash factory and its
                          methods), ``.npz`` checkpoints
  ccmh_torch.data       — splits, dataset and batching, synthetic data
  ccmh_torch.losses     — the methods' losses
  ccmh_torch.models     — hash heads
  ccmh_torch.clip       — CLIP towers, ``.npz`` weight files
  ccmh_torch.ops        — kernel wrappers (attention forward and backward,
                          packed Hamming, LayerNorm and residual add +
                          LayerNorm), similarity, mAP
  ccmh_torch.tokenizer  — byte-level BPE (pure Python, no ``regex``)
  ccmh_torch.utils      — logger, metrics writer, a stdlib ``.xlsx`` reader

Entry points take ``device="cuda"`` by default and raise when CUDA is
absent; the CPU runs only when a caller asks for it (the tests do).
"""

import torch

# fp32 means fp32 on the card: cuBLAS matmuls and cuDNN convolutions would
# otherwise be free to run in TF32 (about three decimal digits), and the
# port is held to the JAX reference at fp32 tolerances.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
