"""Check and time the long path of the attention kernels #1 and #2 (L > 128)
and the wide codes of #3 (K > 256) on one card, against their plain
versions.

    python -m ccmh_torch.tools.check_attention_long

It builds the three libraries, prints the card's name and power limit and
each library's register and spill report, then one JSON line per case:
the kernels' max abs error against the plain versions (fp32 within 1e-4,
bf16 within 2e-2, the backward's times its output scale), whether two
backward calls give the same bits, and at the towers' shapes the ms per
call through the wrappers (mean of 20 after 3, CUDA events).  The cases
cover both head-dim classes (Dh = 64, 128), the scalar load path (Dh = 30,
6), causal and key-padded masks, L from 1 to 577; #3 at K = 64, 288, 512
and 2,048 bits over Q = 512, N = 2^18, exactly.  The last line is
``{"failed": n}``; the exit code is 1 when a case failed.  A new version of
the kernels takes this call first, before ``chip_smoke.py``.  Needs one
CUDA card.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys

import torch

from ccmh_torch.clip.model import causal_mask
from ccmh_torch.ops import attention as attn
from ccmh_torch.ops import build
from ccmh_torch.ops import hamming as ham

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# (B, L, H, Dh, mask); the towers' shapes (B >= 64) are timed
CASES = ((2, 129, 2, 64, "none"), (2, 143, 2, 64, "causal"), (2, 192, 3, 64, "pad"),
         (2, 577, 2, 64, "pad"), (2, 200, 2, 128, "none"), (2, 150, 2, 30, "causal"),
         (2, 150, 2, 6, "none"), (64, 257, 16, 64, "none"), (256, 197, 12, 64, "none"),
         (64, 577, 16, 64, "none"), (8, 1, 2, 64, "none"))
HAMMING_BITS = (512, 2048, 64, 288)


def _ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _mask(L, kind, dev):
    if kind == "causal":
        return causal_mask(L, device=dev)
    if kind == "pad":
        mask = torch.zeros((L, L), device=dev)
        mask[:, L - L // 3:] = -math.inf       # the last third of the keys padded
        return mask
    return None


def attention_case(B, L, H, Dh, kind, dtype, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(L * 7 + H)
    D = H * Dh
    qkv = torch.randn((B, L, 3 * D), generator=gen, device=dev).to(dtype)
    qkv_b = (0.1 * torch.randn((3 * D,), generator=gen, device=dev)).to(dtype)
    g = torch.randn((B, L, D), generator=gen, device=dev).to(dtype)
    mask = _mask(L, kind, dev)
    with torch.no_grad():
        out = attn.fused_attention(qkv, mask, H, qkv_b=qkv_b)
        want = attn.attention_reference(qkv, mask, H, qkv_b=qkv_b)
        err = (out.float() - want.float()).abs().max().item()
        dqkv = attn.attention_backward(qkv, mask, qkv_b, g, H)
        dwant = attn.attention_backward_reference(qkv, mask, qkv_b, g, H)
        scale = max(1.0, dwant.float().abs().max().item())
        err_b = (dqkv.float() - dwant.float()).abs().max().item()
        same_bits = torch.equal(dqkv, attn.attention_backward(qkv, mask, qkv_b, g, H))
        torch.cuda.synchronize()
    ok = (math.isfinite(err) and err <= TOL[dtype] and math.isfinite(err_b)
          and err_b <= TOL[dtype] * scale and same_bits)
    row = {"B": B, "L": L, "H": H, "Dh": Dh, "mask": kind, "dtype": str(dtype),
           "fwd_err": err, "bwd_err": err_b, "bwd_scale": scale, "same_bits": same_bits,
           "ok": ok}
    if B >= 64:
        with torch.no_grad():
            row["fwd_ms"] = _ms(lambda: attn.fused_attention(qkv, mask, H, qkv_b=qkv_b))
            row["bwd_ms"] = _ms(lambda: attn.attention_backward(qkv, mask, qkv_b, g, H))
    return row


def hamming_case(k_bits, dev) -> dict:
    W = k_bits // 32
    gen = torch.Generator(device=dev).manual_seed(k_bits)
    q = torch.randint(-2 ** 31, 2 ** 31, (512, W), generator=gen, device=dev, dtype=torch.int32)
    r = torch.randint(-2 ** 31, 2 ** 31, (2 ** 18, W), generator=gen, device=dev,
                      dtype=torch.int32)
    with torch.inference_mode():
        ok = torch.equal(ham.hamming_distance_packed(q, r),
                         ham.hamming_distance_packed_reference(q, r))
        ms = _ms(lambda: ham.hamming_distance_packed(q, r))
    return {"K": k_bits, "equal": ok, "ok": ok, "ms": ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("check_attention_long: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    names = ["attention", "attention_bwd", "hamming"]
    build.build_all(names)
    for name in names:
        print(json.dumps({"build": name, "ptxas": [
            ln.strip() for ln in (build.build_log(name) or "").splitlines()
            if "registers" in ln or "spill" in ln]}), flush=True)
    failed = 0
    for case in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            row = attention_case(*case, dtype, dev)
            failed += not row["ok"]
            print(json.dumps(row), flush=True)
    for k_bits in HAMMING_BITS:
        row = hamming_case(k_bits, dev)
        failed += not row["ok"]
        print(json.dumps(row), flush=True)
    print(json.dumps({"failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
