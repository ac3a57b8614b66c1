#!/usr/bin/env python3
"""Drive the ccmh_torch serving path on one NVIDIA card and check it.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and ``nvidia-smi``; run from the root of a
checkout.  It exits non-zero, printing no result, when there is no card or
the ``ccmh_torch`` package is not beside it.  Phases, one line each:

1. the card (``nvidia-smi`` name and power limit) and the build of every
   CUDA kernel of the path from the sources in the checkout;
2. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes: fused attention (vision B=256 L=50 D=768 H=12,
   text B=256 L=32 D=512 H=8 causal, both with the projection bias, fp32
   within 1e-4 and bf16 within 2e-2) and packed Hamming (Q=512, N=2^20,
   K=64, exactly equal), each with ms per call beside its bound;
3. the serving path at full width through its entry points, with the
   kernels' launch counters set to 0 just before and read just after:
   a seeded random ViT-B/32 DCHMT K=64 model saved as a ccmh-format
   ``.npz`` and restored by ``Retriever.from_pretrained``; 2,048 random
   CLIP-normalized 224x224 images encoded at batch 256; a 2^20-code gallery
   saved with ``HashIndex.save`` and loaded as ``ccmh_torch.serve
   --gallery`` loads it; ``RetrievalService`` on an HTTP port answering
   /healthz, /v1/encode (texts, images_b64), eight concurrent /v1/search
   and one /v1/add, each held against the direct calls;
4. checks and rates beside the path: packed and int8 indexes agree; the
   kernel path's codes against the plain path's on the card; encode items/s
   in fp32 and bf16 and search ms per 512 queries.

The second-to-last line of standard output is a JSON object with one
entry per kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check ends the run with a non-zero exit.
"""

from __future__ import annotations

import base64
import io
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the peak rate of their type.  The data sheet gives no int32 ALU rate; the
# fp32 CUDA-core rate stands in (the popcount kernel is bound by bytes
# either way).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "int32": 67e12}

ATTN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MARGIN = 1e-3          # code pairs closer than this may flip between paths
N_IMAGES = 2048
GALLERY = 2 ** 20
SEARCH_Q = 512
K_BITS = 64
BATCH = 256            # encode batch of the serving path


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, sort_keys=False), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time per call from CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_s(fn, reps: int = 3) -> float:
    """Best host-clock seconds of ``fn`` (which ends in a host copy)."""
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def bound(n_bytes: float, n_ops: float, op_type: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[op_type]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------- phase 1

def phase_build():
    from ccmh_torch.ops import build

    t0 = time.perf_counter()
    paths = build.build_all()
    seconds = time.perf_counter() - t0
    for name in paths:
        report = [ln.strip() for ln in (build.build_log(name) or "").splitlines()
                  if "registers" in ln or "spill" in ln]
        say("build", kernel=name, ptxas=report)
    say("build", seconds=round(seconds, 3), libraries=sorted(os.path.basename(p)
                                                             for p in paths.values()))


# --------------------------------------------------------------------- phase 2

def attention_case(name, B, L, H, causal, dtype):
    import torch
    import torch.nn.functional as F

    from ccmh_torch.clip.model import causal_mask
    from ccmh_torch.ops import attention as attn

    dev = torch.device("cuda")
    D, Dh = H * 64, 64
    gen = torch.Generator(device=dev).manual_seed(L * 1000 + H)
    qkv = torch.randn((B, L, 3 * D), generator=gen, device=dev).to(dtype)
    qkv_b = (0.1 * torch.randn((3 * D,), generator=gen, device=dev)).to(dtype)
    mask = causal_mask(L, device=dev) if causal else None
    with torch.inference_mode():
        got = attn.fused_attention(qkv, mask, H, qkv_b=qkv_b)
        want = attn.attention_reference(qkv, mask, H, qkv_b=qkv_b)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tname = "float32" if dtype == torch.float32 else "bfloat16"
        check(math.isfinite(err) and err <= ATTN_TOL[tname],
              f"attention {name} {tname}: max abs err {err} > {ATTN_TOL[tname]}")
        ms = cuda_ms(lambda: attn.fused_attention(qkv, mask, H, qkv_b=qkv_b))
        plain_ms = cuda_ms(lambda: attn.attention_reference(qkv, mask, H, qkv_b=qkv_b))
        # the library yardstick: SDPA on the same (biased) q, k, v
        q, k, v = (qkv + qkv_b).view(B, L, 3, H, Dh).permute(2, 0, 3, 1, 4)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))
    item = qkv.element_size()
    n_bytes = (qkv.numel() + qkv_b.numel() + B * L * D) * item + (L * L * 4 if causal else 0)
    n_ops = 4.0 * B * H * L * L * Dh
    bound_ms, bound_by = bound(n_bytes, n_ops, tname)
    case = {"case": f"{name} {tname}", "shape": [B, L, 3 * D], "heads": H,
            "causal": causal, "max_abs_err": err, "tol": ATTN_TOL[tname], "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}
    say("kernel", kernel="fused_attention_fwd", **case)
    return case


def hamming_case():
    import torch

    from ccmh_torch.ops import hamming as ham

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    W = K_BITS // 32
    lo, hi = -2 ** 31, 2 ** 31
    q = torch.randint(lo, hi, (SEARCH_Q, W), generator=gen, device=dev, dtype=torch.int32)
    r = torch.randint(lo, hi, (GALLERY, W), generator=gen, device=dev, dtype=torch.int32)
    with torch.inference_mode():
        got = ham.hamming_distance_packed(q, r)
        want = ham.hamming_distance_packed_reference(q, r)
        torch.cuda.synchronize()
        check(torch.equal(got, want), "packed hamming differs from its plain version")
        err = (got - want).abs().max().item()
        del want
        ms = cuda_ms(lambda: ham.hamming_distance_packed(q, r))
        plain_ms = cuda_ms(lambda: ham.hamming_distance_packed_reference(q, r), iters=5)
    n_bytes = (q.numel() + r.numel() + SEARCH_Q * GALLERY) * 4
    n_ops = 3.0 * SEARCH_Q * GALLERY * W        # xor, popcount, add per lane
    bound_ms, bound_by = bound(n_bytes, n_ops, "int32")
    case = {"case": "search int32", "shape": [SEARCH_Q, GALLERY, W],
            "max_abs_err": err, "tol": 0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
    say("kernel", kernel="hamming_distance_packed", **case)
    return case


def edge_checks():
    """Ragged and large-shared-memory shapes, and the refusals: a CUDA
    tensor the kernel does not take raises, it never takes the plain path."""
    import torch

    from ccmh_torch.clip.model import causal_mask
    from ccmh_torch.ops import attention as attn
    from ccmh_torch.ops import hamming as ham

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    shapes = (  # (B, L, H, Dh, causal): the longest text context (63 KB of
        #         shared memory), the L = Dh = 128 limit, an odd head dim, L = 1
        (3, 77, 8, 64, True), (2, 128, 2, 128, True), (2, 13, 3, 30, False),
        (5, 1, 2, 64, False))
    errs = []
    with torch.inference_mode():
        for B, L, H, Dh, causal in shapes:
            for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
                qkv = torch.randn((B, L, 3 * H * Dh), generator=gen, device=dev).to(dtype)
                b = torch.randn((3 * H * Dh,), generator=gen, device=dev).to(dtype)
                m = causal_mask(L, device=dev) if causal else None
                err = (attn.fused_attention(qkv, m, H, qkv_b=b).float()
                       - attn.attention_reference(qkv, m, H, qkv_b=b).float()
                       ).abs().max().item()
                check(err <= tol, f"attention {(B, L, H, Dh, causal)} {dtype}: err {err}")
                errs.append(err)
        q = torch.randint(-2 ** 31, 2 ** 31, (37, 3), generator=gen, device=dev, dtype=torch.int32)
        r = torch.randint(-2 ** 31, 2 ** 31, (1001, 3), generator=gen, device=dev, dtype=torch.int32)
        check(torch.equal(ham.hamming_distance_packed(q, r),
                          ham.hamming_distance_packed_reference(q, r)),
              "packed hamming differs on ragged shapes")
    refusals = 0
    for call in (
        lambda: attn.fused_attention(torch.zeros((1, 129, 192), device=dev), None, 3),
        lambda: attn.fused_attention(torch.zeros((1, 5, 192), device=dev,
                                                 dtype=torch.float16), None, 3),
        lambda: attn.fused_attention(torch.zeros((1, 5, 192), device=dev,
                                                 requires_grad=True), None, 3),
        lambda: ham.hamming_distance_packed(torch.zeros((2, 9), device=dev, dtype=torch.int32),
                                            torch.zeros((2, 9), device=dev, dtype=torch.int32)),
    ):
        try:
            call()
        except (ValueError, TypeError, RuntimeError):
            refusals += 1
    check(refusals == 4, f"only {refusals} of 4 unsupported CUDA inputs raised")
    say("edges", attention_shapes=[list(x) for x in shapes],
        attention_max_abs_err_fp32_bf16=errs, hamming_ragged="ok", refusals=refusals)


# --------------------------------------------------------------------- phase 3

CAPTION_WORDS = (
    ("a", "two", "three", "the", "some"),
    ("small", "large", "red", "black", "white", "young", "old", "happy"),
    ("dog", "cat", "man", "woman", "child", "car", "bus", "bird", "horse", "boat"),
    ("runs", "sits", "stands", "plays", "jumps", "rides", "sleeps", "waits"),
    ("on the grass", "near the water", "in the street", "on a sofa",
     "under a tree", "at the beach", "in the snow", "next to a window"),
)


def captions(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [" ".join(ws[rng.integers(len(ws))] for ws in CAPTION_WORDS) for _ in range(n)]


def random_images(n: int, res: int, seed: int) -> np.ndarray:
    """Random uint8 pixels, CLIP-normalized to float32 NHWC on the host."""
    import torch

    from ccmh_torch.clip.model import normalize_pixels

    gen = torch.Generator(device="cuda").manual_seed(seed)
    raw = torch.randint(0, 256, (n, res, res, 3), generator=gen, device="cuda",
                        dtype=torch.uint8)
    return normalize_pixels(raw).cpu().numpy()


def http(port: int, path: str, body=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = None if body is None else json.dumps(body).encode()
    with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=300) as resp:
        return json.loads(resp.read())


def serving_path(state):
    """The serving path through its entry points (counted launches)."""
    import torch

    from ccmh_torch.clip.model import ClipConfig, init_clip_params
    from ccmh_torch.config import Config
    from ccmh_torch.retrieval import HashIndex, Retriever
    from ccmh_torch.serve import RetrievalService, serve
    from ccmh_torch.train.checkpoint import save_checkpoint
    from ccmh_torch.train.methods import get_method

    os.makedirs(WORK, exist_ok=True)
    ckpt = os.path.join(WORK, "vitb32_dchmt_k64.npz")
    cfg = Config(method="DCHMT", output_dim=K_BITS, max_words=32, nclass=80,
                 pretrained=ckpt)
    clip_cfg = ClipConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    heads, _, aux = get_method("DCHMT").init(gen, cfg, clip_cfg)
    params = {"clip": init_clip_params(gen, clip_cfg), **heads}
    n_params = sum(t.numel() for t in _leaves(params))
    save_checkpoint(ckpt, params, aux=aux)
    del params
    t0 = time.perf_counter()
    retriever = Retriever.from_pretrained(cfg, device="cuda")
    load_s = time.perf_counter() - t0
    check(retriever.clip_cfg == clip_cfg, f"restored {retriever.clip_cfg}")
    say("serve", model="ViT-B/32 DCHMT K=64 fp32", params=n_params,
        checkpoint_mb=round(os.path.getsize(ckpt) / 2 ** 20, 1), load_s=round(load_s, 3))

    images = random_images(N_IMAGES, clip_cfg.image_resolution, seed=1)
    img_codes = retriever.encode_images(images, batch_size=BATCH)
    check(img_codes.shape == (N_IMAGES, K_BITS) and set(np.unique(img_codes)) <= {-1, 1},
          f"image codes {img_codes.shape} {np.unique(img_codes)}")
    texts = captions(N_IMAGES, seed=2)
    txt_codes = retriever.encode_texts(texts, batch_size=BATCH)
    check(txt_codes.shape == (N_IMAGES, K_BITS), f"text codes {txt_codes.shape}")

    gen = torch.Generator(device="cuda").manual_seed(3)
    rest = torch.where(torch.rand((GALLERY - N_IMAGES, K_BITS), generator=gen,
                                  device="cuda") < 0.5, -1, 1).to(torch.int8)
    gallery = torch.cat([torch.from_numpy(img_codes).cuda(), rest])
    gallery_path = os.path.join(WORK, "gallery_packed.npz")
    HashIndex(gallery, packed=True, device="cuda").save(gallery_path)
    index = HashIndex.load(gallery_path, **retriever._index_kw())   # as serve --gallery
    check(index.packed and len(index) == GALLERY, "loaded gallery")
    say("serve", gallery=len(index), packed=index.packed,
        gallery_file_mb=round(os.path.getsize(gallery_path) / 2 ** 20, 1))

    service = RetrievalService(retriever, {"image": index})
    server = serve(service, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        health = http(port, "/healthz")
        check(health["ok"] and health["indexes"] == {"image": GALLERY}, f"healthz {health}")

        got = http(port, "/v1/encode", {"texts": texts[:8]})
        check(np.array_equal(np.asarray(got["codes"]), retriever.encode_texts(texts[:8])),
              "/v1/encode texts differs from Retriever.encode_texts")
        buf = io.BytesIO()
        np.save(buf, images[:4])
        got = http(port, "/v1/encode", {"images_b64": base64.b64encode(buf.getvalue()).decode()})
        check(np.array_equal(np.asarray(got["codes"]), retriever.encode_images(images[:4])),
              "/v1/encode images_b64 differs from Retriever.encode_images")

        queries = texts[8:16]
        answers = [None] * len(queries)

        def one(j):
            answers[j] = http(port, "/v1/search", {"texts": [queries[j]], "k": 10})

        workers = [threading.Thread(target=one, args=(j,)) for j in range(len(queries))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=300)
        check(not any(w.is_alive() for w in workers), "a /v1/search request hung")
        # the batcher coalesces concurrent requests into buckets of up to 8
        # rows; each answer must equal the direct search at batch 1 or 8
        direct = [index.search(retriever.encode_texts(queries), 10),
                  index.search(np.concatenate([retriever.encode_texts([t]) for t in queries]), 10)]
        for j, ans in enumerate(answers):
            check(any(ans["indices"] == [d[1][j].tolist()] and ans["distances"] == [d[0][j].tolist()]
                      for d in direct), f"/v1/search answer {j} differs from HashIndex.search")
        batches = http(port, "/healthz")["batching"]["search"]

        new = -img_codes[:4]            # sign-flipped codes: not in the gallery
        got = http(port, "/v1/add", {"index": "image", "codes": new.tolist()})
        check(got == {"index": "image", "size": GALLERY + 4}, f"/v1/add {got}")
        d, i = index.search(new, 1)
        check(np.all(d == 0) and np.array_equal(i[:, 0], np.arange(GALLERY, GALLERY + 4)),
              f"added codes not found: {d.ravel()} {i.ravel()}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    say("serve", http="ok", search_requests=len(queries), search_batches=batches["batches"],
        add="ok")
    state.update(retriever=retriever, index=index, images=images, texts=texts,
                 img_codes=img_codes, txt_codes=txt_codes, gallery=gallery, cfg=cfg)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# --------------------------------------------------------------------- phase 4

def beside_the_path(state):
    import torch

    from ccmh_torch.clip import model as cm
    from ccmh_torch.models.heads import select_hash
    from ccmh_torch.retrieval import HashIndex, Retriever
    from ccmh_torch.tokenizer import tokenize_batch
    from ccmh_torch.train.methods.base import image_embeds, text_embeds

    retriever, index, gallery = state["retriever"], state["index"], state["gallery"]
    images, texts = state["images"], state["texts"]

    # packed (kernel) and int8 (matmul) indexes: identical (distances, indices)
    int8_index = HashIndex(gallery, packed=False, device="cuda")
    int8_index.add(-state["img_codes"][:4])     # the rows of the /v1/add
    q = np.concatenate([state["txt_codes"][:SEARCH_Q // 2], state["img_codes"][:SEARCH_Q // 2]])
    dp, ip = index.search(q, 10)
    d8, i8 = int8_index.search(q, 10)
    check(np.array_equal(dp, d8) and np.array_equal(ip, i8), "packed and int8 top-10 differ")
    # an image query finds its own gallery row (or an equal code before it)
    own = dp[SEARCH_Q // 2:, 0] == 0
    check(own.all() and np.all(ip[SEARCH_Q // 2:, 0] <= np.arange(SEARCH_Q // 2)),
          "image queries do not find themselves at distance 0")
    # and a numpy brute force agrees on a few queries
    g_host = gallery.cpu().numpy().astype(np.int32)
    g_host = np.concatenate([g_host, -state["img_codes"][:4].astype(np.int32)])
    for j in (0, 1, SEARCH_Q - 1):
        dist = (K_BITS - g_host @ q[j].astype(np.int32)) // 2
        order = np.argsort(dist, kind="stable")[:10]
        check(np.array_equal(order, ip[j]) and np.array_equal(dist[order], dp[j]),
              f"query {j} differs from the numpy brute force")
    say("check", packed_vs_int8="identical", queries=SEARCH_Q, k=10, gallery=len(index),
        brute_force="ok")

    # kernel path vs plain path on the card: codes agree except at tiny margins
    params, cfg, ccfg = retriever.params, retriever.cfg, retriever.clip_cfg
    mismatches, near = 0, 0
    with torch.inference_mode():
        for kind, data, codes in (("image", images, state["img_codes"]),
                                  ("text", None, state["txt_codes"])):
            cm.set_attn_impl("plain")
            try:
                if kind == "image":
                    emb = torch.cat([image_embeds(params, ccfg, torch.from_numpy(images[s:s + BATCH]).cuda(), cfg)
                                     for s in range(0, N_IMAGES, BATCH)])
                else:
                    ids = torch.from_numpy(tokenize_batch(texts, cfg.max_words)).cuda()
                    emb = torch.cat([text_embeds(params, ccfg, ids[s:s + BATCH], cfg)
                                     for s in range(0, N_IMAGES, BATCH)])
            finally:
                cm.set_attn_impl("fused")
            pairs = select_hash(params["img_head" if kind == "image" else "txt_head"], emb)
            plain = (2 * pairs.argmax(-1) - 1).to(torch.int8).cpu().numpy()
            margin = (pairs[..., 1] - pairs[..., 0]).abs().cpu().numpy()
            differ = plain != codes
            near += int((margin < MARGIN).sum())
            mismatches += int(differ.sum())
            check(np.all(margin[differ] < MARGIN),
                  f"{kind} codes differ between kernel and plain paths at margin >= {MARGIN}")
    say("check", kernel_vs_plain_codes="agree", bits=2 * N_IMAGES * K_BITS,
        differing_bits=mismatches, bits_with_margin_below_1e_3=near)

    # rates: encode items/s (fp32 and bf16) and search ms per 512 queries
    ids = tokenize_batch(texts, cfg.max_words)
    bf16 = Retriever(retriever.method, params, retriever.aux,
                     cfg.replace(compute_dtype="bfloat16"), ccfg, device="cuda")
    rates = {}
    for name, r in (("fp32", retriever), ("bf16", bf16)):
        r.encode_images(images[:BATCH])
        rates[f"image_encode_items_per_s_{name}"] = N_IMAGES / host_s(
            lambda: r.encode_images(images, batch_size=BATCH))
        rates[f"text_encode_items_per_s_{name}"] = N_IMAGES / host_s(
            lambda: r.encode_texts(ids, batch_size=BATCH))
    bf16_codes = bf16.encode_images(images[:BATCH])
    rates["bf16_fp32_image_code_bit_agreement"] = float(
        (bf16_codes == state["img_codes"][:BATCH]).mean())
    rates["tokenize_captions_per_s"] = N_IMAGES / host_s(
        lambda: tokenize_batch(texts, cfg.max_words), reps=1)
    q512 = state["txt_codes"][:SEARCH_Q]
    rates["search_ms_per_512_packed"] = 1e3 * host_s(lambda: index.search(q512, 10))
    rates["search_ms_per_512_int8"] = 1e3 * host_s(lambda: int8_index.search(q512, 10))
    say("rates", **{k: round(v, 4) for k, v in rates.items()})
    return rates


# --------------------------------------------------------------------- main

def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs one CUDA card",
              file=sys.stderr)
        return 2
    try:
        import ccmh_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the ccmh_torch package is not beside this script ({exc})",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    say("card", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])
    phase_build()

    from ccmh_torch.ops import attention as attn
    from ccmh_torch.ops import hamming as ham

    attn_cases = [attention_case(n, 256, L, H, causal, dt)
                  for dt in (torch.float32, torch.bfloat16)
                  for n, L, H, causal in (("vision", 50, 12, False), ("text", 32, 8, True))]
    ham_case = hamming_case()
    edge_checks()
    torch.cuda.empty_cache()

    state = {}
    attn.launches = 0
    ham.launches = 0
    serving_path(state)
    launches = {"attention": attn.launches, "hamming": ham.launches}
    say("launches", **launches)
    check(launches["attention"] > 0, "the serving path never launched the attention kernel")
    check(launches["hamming"] > 0, "the serving path never launched the hamming kernel")

    beside_the_path(state)

    top = attn_cases[0]   # vision fp32: the serving default's dominant call
    kernels = [
        {"name": "fused_attention_fwd", "route": "cuda",
         "source": "ccmh_torch/csrc/attention.cu",
         "replaces": "ccmh/ops/attention.py:123",
         "launches": launches["attention"], "max_abs_err": top["max_abs_err"],
         "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
         "bound_by": top["bound_by"], "library_ms": top["library_ms"],
         "cases": attn_cases},
        {"name": "hamming_distance_packed", "route": "cuda",
         "source": "ccmh_torch/csrc/hamming.cu",
         "replaces": "ccmh/ops/hamming.py:56",
         "launches": launches["hamming"], "max_abs_err": ham_case["max_abs_err"],
         "ms": ham_case["ms"], "plain_ms": ham_case["plain_ms"],
         "bound_ms": ham_case["bound_ms"], "bound_by": ham_case["bound_by"],
         "library_ms": None, "cases": [ham_case]},
    ]
    say("done", seconds=round(time.perf_counter() - t_start, 1))
    shutil.rmtree(WORK, ignore_errors=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
