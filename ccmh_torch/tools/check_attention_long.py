"""Check and time the long path of the attention kernels #1 and #2 (L > 128)
and the wide codes of #3 (K > 256) on one card, against their plain
versions.

    python -m ccmh_torch.tools.check_attention_long

It builds the three libraries, prints the card's name and power limit,
each library's register and spill report and the ``HGMMA`` instructions
in each kernel (``cuobjdump -sass``), checks the ``wgmma`` building blocks
(``csrc/wgmma_tiles.cuh``: TMA tiles, the K-major and MN-major operands,
the bias folded through the swizzle; in fp32 the 3xTF32 splits, the
transposed tiles and the register operands) on one [64, 64] product
against ``torch.matmul``, prints whether the tensor cores ignore the low 13
mantissa bits of a raw fp32 operand (``tf32_low_13_bits``), then one JSON
line per case with the kernel family each call took (``short``,
``long_mma``, ``long_wgmma``, ``long_onepass``, ``long_resident``):
the kernels' max abs error against the plain versions (fp32 within 1e-4,
bf16 within 2e-2, the backward's times its output scale), whether two
calls of each give the same bits, and at the towers' shapes the ms per
call through the wrappers (mean of 20 after 3, CUDA events).  The cases
cover both head-dim classes (Dh = 64, 128), the scalar load path (Dh = 30,
6), causal and key-padded masks, rows that a finite mask covers entirely
(-1e9, -1e30, finfo.min / 2), L from 1 to 768 (the bf16 one-pass
kernels' limits and one past each, the backward's 16-key tails at 144
and 208, and the resident kernel's limit, among them); #3 at K = 64, 288, 512
and 2,048 bits over Q = 512, N = 2^18, exactly.  The last line is
``{"failed": n}``; the exit code is 1 when a case failed.  A new version of
the kernels takes this call first, before ``chip_smoke.py``.  Needs one
CUDA card.
"""

from __future__ import annotations

import ctypes
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
         (2, 577, 2, 64, "pad"), (2, 257, 2, 64, "rows"), (2, 200, 2, 128, "rows"),
         (2, attn.ONEPASS_MAX_L, 2, 64, "causal"), (2, attn.ONEPASS_MAX_L + 1, 2, 64, "pad"),
         (2, 272, 2, 64, "rows"), (2, 256, 2, 64, "none"), (2, 577, 2, 64, "rows"),
         (2, attn.BWD_ONEPASS_MAX_L + 1, 2, 64, "causal"), (2, 208, 2, 64, "pad"),
         (2, 144, 2, 64, "none"), (2, 145, 2, 64, "rows"),
         (2, attn.RESIDENT_MAX_L, 2, 64, "causal"),
         (2, 200, 2, 128, "none"), (2, 150, 2, 30, "causal"),
         (2, 150, 2, 6, "none"), (64, 257, 16, 64, "none"), (256, 197, 12, 64, "none"),
         (64, 577, 16, 64, "none"), (8, 1, 2, 64, "none"))
# "rows": rows 0, 1 and L - 1 masked entirely by these finite values (the
# plain softmax, and ccmh's, give each a uniform row)
MASKED_ROWS = (-1e9, -1e30, torch.finfo(torch.float32).min / 2)
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
    if kind == "rows":
        mask = torch.zeros((L, L), device=dev)
        for row, value in zip((0, 1, L - 1), MASKED_ROWS):
            mask[row] = value
        return mask
    return None


SELFTEST_MODES = ("a b^T", "a b (a in registers, b MN-major)", "(a + bias) (b + bias)^T")
# the fp32 modes 3-5 (3xTF32 on wgmma .tf32) and the two single tf32 passes
SELFTEST32_MODES = ("tf32x3 (a + bias) (b + bias)^T",
                    "tf32x3 (a + bias) (b + bias)^T (a in registers)",
                    "tf32x3 a (b + bias) (a an accumulator in registers, b transposed)")
TF32_RAW, TF32_HI = 6, 7


def _tf32_hi(x: torch.Tensor) -> torch.Tensor:
    """x with its low 13 mantissa bits cleared (the kernels' split)."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def wgmma_selftest(dev) -> list:
    """The wgmma building blocks on one [64, 64] product per mode against
    torch.matmul: bf16 (exact products, fp32 sums: 1e-3) and fp32 as
    3xTF32 (against float64: 1e-5 of the product's largest magnitude, each
    3xTF32 product keeping about 2^-21 of it).  Then whether the tensor
    cores ignore the low 13 mantissa bits of a raw fp32 operand: one tf32
    pass over the tiles as they landed against one over their hi tiles,
    bit for bit (a row of its own, not a check)."""
    gen = torch.Generator(device=dev).manual_seed(64)
    a32 = torch.randn((64, 64), generator=gen, device=dev)
    b32 = torch.randn((64, 64), generator=gen, device=dev)
    bias32 = torch.randn((64,), generator=gen, device=dev)
    a, b, bias = a32.to(torch.bfloat16), b32.to(torch.bfloat16), bias32.to(torch.bfloat16)
    lib = build.load("attention")
    fn = lib.ccmh_wgmma_selftest
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]

    def run(mode, x, y, z):
        c = torch.full((64, 64), float("nan"), device=dev)
        err = fn(dev.index or 0, x.data_ptr(), y.data_ptr(), z.data_ptr(), c.data_ptr(), mode,
                 torch.cuda.current_stream(dev).cuda_stream)
        build.raise_on_error(lib, "ccmh_wgmma_selftest", err)
        torch.cuda.synchronize()
        return c

    rows = []
    for mode, what in enumerate(SELFTEST_MODES):
        c = run(mode, a, b, bias)
        if mode == 0:
            want = a.float() @ b.float().T
        elif mode == 1:
            want = a.float() @ b.float()
        else:
            want = (a + bias).float() @ (b + bias).float().T
        e = (c - want).abs().max().item()
        rows.append({"selftest": what, "max_abs_err": e, "ok": math.isfinite(e) and e <= 1e-3})
    x, y = (a32 + bias32).double(), (b32 + bias32).double()
    wants = (x @ y.T, x @ y.T, a32.double() @ y)
    for mode, (what, want) in enumerate(zip(SELFTEST32_MODES, wants), start=3):
        e = (run(mode, a32, b32, bias32).double() - want).abs().max().item()
        tol = 1e-5 * max(1.0, want.abs().max().item())   # 3xTF32 keeps ~2^-21 a product
        rows.append({"selftest": what, "max_abs_err": e, "tol": tol,
                     "ok": math.isfinite(e) and e <= tol})
    raw, hi = run(TF32_RAW, a32, b32, bias32), run(TF32_HI, a32, b32, bias32)
    one_pass = _tf32_hi(a32).double() @ _tf32_hi(b32).double().T
    e = (hi.double() - one_pass).abs().max().item()
    rows.append({"selftest": "one tf32 pass over the hi tiles", "max_abs_err": e,
                 "ok": math.isfinite(e) and e <= 1e-3})
    rows.append({"tf32_low_13_bits": "ignored" if torch.equal(raw, hi) else "used",
                 "raw_vs_hi_max_abs_diff": (raw - hi).abs().max().item(),
                 "what": "one tf32 wgmma pass over raw fp32 tiles against one over the same "
                         "tiles with their low 13 mantissa bits cleared: equal bits mean the "
                         "tensor cores ignore those bits", "ok": True})
    return rows


def attention_case(B, L, H, Dh, kind, dtype, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(L * 7 + H)
    D = H * Dh
    qkv = torch.randn((B, L, 3 * D), generator=gen, device=dev).to(dtype)
    qkv_b = (0.1 * torch.randn((3 * D,), generator=gen, device=dev)).to(dtype)
    g = torch.randn((B, L, D), generator=gen, device=dev).to(dtype)
    mask = _mask(L, kind, dev)
    before = (dict(attn.launches_by_family), dict(attn.backward_launches_by_family))
    with torch.no_grad():
        out = attn.fused_attention(qkv, mask, H, qkv_b=qkv_b)
        want = attn.attention_reference(qkv, mask, H, qkv_b=qkv_b)
        err = (out.float() - want.float()).abs().max().item()
        fwd_same_bits = torch.equal(out, attn.fused_attention(qkv, mask, H, qkv_b=qkv_b))
        dqkv = attn.attention_backward(qkv, mask, qkv_b, g, H)
        dwant = attn.attention_backward_reference(qkv, mask, qkv_b, g, H)
        scale = max(1.0, dwant.float().abs().max().item())
        err_b = (dqkv.float() - dwant.float()).abs().max().item()
        same_bits = torch.equal(dqkv, attn.attention_backward(qkv, mask, qkv_b, g, H))
        torch.cuda.synchronize()
    ok = (math.isfinite(err) and err <= TOL[dtype] and math.isfinite(err_b)
          and err_b <= TOL[dtype] * scale and same_bits and fwd_same_bits)
    row = {"B": B, "L": L, "H": H, "Dh": Dh, "mask": kind, "dtype": str(dtype),
           "fwd_err": err, "bwd_err": err_b, "bwd_scale": scale, "same_bits": same_bits,
           "fwd_same_bits": fwd_same_bits, "ok": ok,
           "families": [[f for f in attn.FAMILIES if counts[f] > was[f]]
                        for counts, was in zip((attn.launches_by_family,
                                                attn.backward_launches_by_family), before)]}
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
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln],
            "hgmma": build.sass_counts(name)}), flush=True)
    failed = 0
    for row in wgmma_selftest(dev):
        failed += not row["ok"]
        print(json.dumps(row), flush=True)
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
