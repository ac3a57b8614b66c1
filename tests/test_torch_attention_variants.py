"""The attention ablation variants (``ccmh_torch.ops.attention_variants``,
the plain versions the CPU runs) against the Pallas kernels of
``tools/bench_attn_bwd.py``, and the ported bench
(``ccmh_torch.tools.bench_attn_bwd``) end to end on the CPU.

The JAX tool is loaded by its file path (the name ``tools`` is not a
package); its ``pallas_call``\\ s run in interpret mode on the CPU, which it
selects itself.  Same numpy inputs through both: qkv, g unit normal,
B=4, L=8 or 7, H=4, Dh=16, bias None or causal, bb=2.

Tolerance: fp32 atol 1e-5 x max(1, output scale) (the frameworks sum the
products in other orders; the outputs are O(1)), and for ``nosoftmax``
1e-5 relative to the output scale (with the causal bias its probs are
-1e7 and its outputs ~1e14); bf16 2e-2 of the output scale (q, k, v, g,
the probabilities and dlogits are rounded to bf16 at the same points on
both sides, a bf16 ulp at unit scale is 7.8e-3, and a rounding that falls
the other way moves a product term by that much).  ``fewstores`` writes
only its dk slot; only that slot is compared.  bf16 ``pair`` is held to
the tool's ``full`` mode, the same math: interpret mode cannot run the
pair body's bf16 products on the CPU.
"""

import functools
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ccmh_torch.ops import attention_variants as av
from ccmh_torch.tools import bench_attn_bwd as bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, DH, BB = 4, 4, 16, 2
D = H * DH


@functools.lru_cache(maxsize=None)
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_attn_bwd", os.path.join(REPO, "tools", "bench_attn_bwd.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(L, causal, seed):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(B, L, 3 * D).astype(np.float32)
    g = rng.randn(B, L, D).astype(np.float32)
    bias = np.triu(np.full((L, L), -1e9, np.float32), 1) if causal else None
    return qkv, g, bias


def _dtypes(dtype):
    return (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)


def _close(got, want, dtype, relative=False, cols=None):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if cols is not None:
        got, want = got[..., cols], want[..., cols]
    scale = float(np.abs(want).max())
    scale = scale if relative else max(1.0, scale)
    tol = (1e-5 if dtype == "float32" else 2e-2) * scale
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


KERNELS = [*(f"x:{m}" for m in av.MODES), "savedp", "merged", "headpair", "fwd_stacked"]


def _run_both(kernel, qkv, g, bias, dtype):
    jdt, tdt = _dtypes(dtype)
    tool = jax_tool()
    jq, jg = jnp.asarray(qkv, jdt), jnp.asarray(g, jdt)
    jb = None if bias is None else jnp.asarray(bias)
    tq, tg = torch.from_numpy(qkv).to(tdt), torch.from_numpy(g).to(tdt)
    tb = None if bias is None else torch.from_numpy(bias)
    if kernel.startswith("x:"):
        mode = kernel[2:]
        # XLA:CPU has no bf16 x bf16 -> f32 dot over the pair body's two
        # batch dims; its math is `full`'s, so bf16 `pair` is held to that
        jmode = "full" if (mode, dtype) == ("pair", "bfloat16") else mode
        return (tool.backward_x(jq, jb, jg, H, BB, jmode),
                av.backward_x(tq, tb, tg, H, BB, mode))
    if kernel == "savedp":
        return tool.backward_savedp(jq, jb, jg, H, BB), av.backward_savedp(tq, tb, tg, H, BB)
    if kernel == "merged":
        return tool.backward_merged(jq, jb, jg, H, BB), av.backward_merged(tq, tb, tg, H, BB)
    if kernel == "headpair":
        return (tool.backward_headpair(jq, jb, jg, H, BB),
                av.backward_headpair(tq, tb, tg, H, BB))
    return tool.forward_stacked(jq, jb, H, BB), av.forward_stacked(tq, tb, H, BB)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,causal", [(8, False), (8, True), (7, False), (7, True)])
@pytest.mark.parametrize("kernel", KERNELS)
def test_variant_matches_the_pallas_kernel(kernel, L, causal, dtype):
    qkv, g, bias = _inputs(L, causal, seed=L * 10 + causal)
    want, got = _run_both(kernel, qkv, g, bias, dtype)
    assert got.dtype == _dtypes(dtype)[1]
    assert tuple(got.shape) == tuple(want.shape)
    _close(got.float().numpy(), want, dtype, relative=kernel == "x:nosoftmax",
           cols=slice(D, 2 * D) if kernel == "x:fewstores" else None)


@pytest.mark.parametrize("causal", [False, True])
def test_setup_inputs_match_the_tool(causal):
    """#8's saved probabilities (the tool's :331-338) and #9's block-diagonal
    mask (:410-414), built the same way on both sides."""
    L = 7
    qkv, _, bias = _inputs(L, causal, seed=5)
    x = jnp.asarray(qkv).reshape(B, L, 3, H, DH)
    logits = jnp.einsum("bqhd,bkhd->bhqk", x[:, :, 0], x[:, :, 1]) / np.sqrt(DH)
    if bias is not None:
        logits = logits + bias
    want = np.asarray(jnp.exp(logits - logits.max(-1, keepdims=True))
                      / jnp.exp(logits - logits.max(-1, keepdims=True)).sum(-1, keepdims=True))
    tb = None if bias is None else torch.from_numpy(bias)
    got = av.savedp_probs(torch.from_numpy(qkv), tb, H)
    assert got.shape == (B, H, L, L) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)

    R = BB * L
    blk = np.zeros((L, L), np.float32) if bias is None else bias
    mask = np.full((R, R), -1e9, np.float32)
    for i in range(BB):
        mask[i * L:(i + 1) * L, i * L:(i + 1) * L] = blk
    np.testing.assert_array_equal(av.merged_mask(tb, L, BB).numpy(), mask)


def _all_calls(qkv, g, n_head, bb):
    return [
        lambda: av.backward_x(qkv, None, g, n_head, bb, "full"),
        lambda: av.forward_stacked(qkv, None, n_head, bb),
        lambda: av.backward_savedp(qkv, None, g, n_head, bb),
        lambda: av.backward_merged(qkv, None, g, n_head, bb),
        lambda: av.backward_headpair(qkv, None, g, n_head, bb),
    ]


@pytest.mark.parametrize("which", range(5))
def test_a_batch_block_that_does_not_divide_b_raises(which):
    """Departure from the TPU tool: its grids are B // bb and leave the
    trailing rows of such a B unwritten; the port raises on every device."""
    qkv, g, _ = _inputs(8, False, seed=1)
    call = _all_calls(torch.from_numpy(qkv[:3]), torch.from_numpy(g[:3]), H, 2)[which]
    with pytest.raises(ValueError, match="must divide"):
        call()


def test_two_heads_a_block_need_an_even_head_count():
    qkv = torch.zeros((2, 5, 3 * 48))
    g = torch.zeros((2, 5, 48))
    for call in (lambda: av.backward_x(qkv, None, g, 3, 1, "pair"),
                 lambda: av.backward_headpair(qkv, None, g, 3, 1),
                 lambda: av.backward_x(qkv, None, g, 2, 1, "nope")):
        with pytest.raises(ValueError):
            call()


def test_cpu_never_counts_a_launch():
    names = ("backward_x_launches", "forward_stacked_launches", "backward_savedp_launches",
             "backward_merged_launches", "backward_headpair_launches")
    for n in names:
        setattr(av, n, 0)
    qkv, g, _ = _inputs(8, True, seed=2)
    for call in _all_calls(torch.from_numpy(qkv), torch.from_numpy(g), H, 2):
        call()
    assert all(getattr(av, n) == 0 for n in names)


def test_bench_runs_every_variant_on_the_cpu(capsys):
    assert bench.main(["--device", "cpu", "--tiny"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    names = ["fwd kernel (harness check)", f"fwd stacked bb={bench.FWD_BB}", "v0 shipped",
             "stacked bb=4", "stacked bb=8", *(f"{m} bb=4" for m in av.MODES if m != "stacked"),
             "savedp bb=4", "merged bb=2", "merged bb=4", "headpair bb=4"]
    assert [r["variant"] for r in rows] == names * 2           # vision, text (bf16)
    kernels = {r["kernel"] for r in rows}
    assert set(bench.COUNTERS) == kernels                      # every kernel of the tool
    for r in rows:
        assert r["device"] == "cpu" and r["us_per_call"] is None and r["library_us"] is None
        assert r["rel_err_vs_plain"] < bench.CHECK_TOL and r["bound_us"] > 0
        ref = r.get("rel_err_vs_v0", r.get("rel_err_vs_fwd_kernel"))
        same = r["variant"].split()[0] not in ("nosoftmax", "novjp", "bf16vjp", "fewstores")
        assert (ref is not None and ref < bench.CHECK_TOL) if same else ref is None
        assert r["launches"] == 0


def test_bench_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main(["--tiny"])
