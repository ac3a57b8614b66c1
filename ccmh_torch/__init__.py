"""ccmh_torch — the PyTorch/CUDA port of ccmh for NVIDIA Hopper (H100).

The JAX package ``ccmh`` stays the reference; this package re-implements
it slice by slice in PyTorch, with every Pallas TPU kernel on a ported
path replaced by a CUDA C++ kernel written for ``sm_90a``
(``ccmh_torch/csrc``).  It imports ``torch`` and never ``jax`` or ``ccmh``:
host modules it shares with ``ccmh`` are kept as copies.

Ported so far: the serving path (ViT-B/32 DCHMT encode -> Hamming top-k ->
HTTP).  Layers, from the entry point down:

  ccmh_torch.serve      — HTTP daemon (``python -m ccmh_torch.serve``)
  ccmh_torch.retrieval  — Retriever (per-tower encode) + HashIndex (top-k)
  ccmh_torch.train      — Method protocol, DCHMT encode, ``.npz`` restore
  ccmh_torch.models     — hash heads
  ccmh_torch.clip       — CLIP towers, ``.npz`` weight files
  ccmh_torch.ops        — kernel wrappers: fused attention, packed Hamming
  ccmh_torch.tokenizer  — byte-level BPE (pure Python, no ``regex``)

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
