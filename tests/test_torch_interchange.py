"""Weight interchange of the port against ``ccmh``: reference ``.pth``
export and import (``ccmh_torch/clip/{export_ref,import_ref}.py``),
OpenAI ``.pt`` conversion (``clip/convert.py``) and the HF layout
(``clip/hf.py``), on ccmh's seeded tiny-tower inits.

Every mapping is a transpose, a stack or a split of float32 arrays, so
every comparison is exact: key for key and bit for bit.  The TorchScript
case scripts a module built here whose state dict carries the OpenAI
keys (no OpenAI model code is needed for ``torch.jit.load``'s path).  The
HF directory is written by ``transformers``' ``save_pretrained`` and read
by the port with ``transformers`` hidden.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import scipy.io as scio
import torch
import transformers

import jax

from ccmh.clip import convert as j_convert
from ccmh.clip import export_ref as j_export
from ccmh.clip import hf as j_hf
from ccmh.clip import import_ref as j_import
from ccmh.clip.model import ClipConfig as JClipConfig, init_clip_params
from ccmh.config import MITHConfig
from ccmh.data.synthetic import write_synthetic_mat_dataset
from ccmh.models import heads as H
from ccmh.models.mith import init_hashing_model
from ccmh_torch.bridge import params_from_jax, params_to_jax
from ccmh_torch.cli import main as torch_main
from ccmh_torch.clip import convert, export_ref, hf, import_ref
from ccmh_torch.clip.model import ClipConfig
from ccmh_torch.config import Config
from ccmh_torch.retrieval import Retriever
from ccmh_torch.train.checkpoint import save_checkpoint
from tests.torch_outputs import drop_large_outputs  # noqa: F401 -- autouse

JTINY = JClipConfig.tiny()
TINY = ClipConfig.tiny()
K, C = 16, 5
FAMILIES = ["DSPH", "DNPH", "DPBE", "DCHMT", "TwDH", "MITH"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _heads(method, key):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    e = JTINY.embed_dim
    if method == "DNPH":
        return {"img_head": H.init_linear_hash(k1, e, K), "txt_head": H.init_linear_hash(k2, e, K),
                "img_pre": H.init_pre_layer(k3, e, C), "txt_pre": H.init_pre_layer(k4, e, C)}
    if method == "DPBE":
        return {"img_head": H.init_l2norm_hash(k1, e, K), "txt_head": H.init_l2norm_hash(k2, e, K)}
    if method == "DCHMT":
        return {"img_head": H.init_select_hash(k1, e, K), "txt_head": H.init_select_hash(k2, e, K)}
    if method == "TwDH":
        return {"img_head": H.init_modality_hash(k1, e, K, layernorm=False),
                "txt_head": H.init_modality_hash(k2, e, K, layernorm=True)}
    if method == "MITH":
        return {"hash": init_hashing_model(k1, e, K, MITHConfig())}
    return {"img_head": H.init_linear_hash(k1, e, K), "txt_head": H.init_linear_hash(k2, e, K)}


def _model(method, seed=7):
    """ccmh's params (numpy) and aux (TwDH's non-trivial BatchNorm stats)."""
    k_clip, k_heads = jax.random.split(jax.random.PRNGKey(seed))
    params = _np_tree({"clip": init_clip_params(k_clip, JTINY), **_heads(method, k_heads)})
    aux = {}
    if method == "TwDH":
        bn = _np_tree(H.init_bn_state(JTINY.embed_dim))
        aux = {"bn": {"mean": bn["mean"] + 0.25, "var": bn["var"] * 1.5,
                      "count": bn["count"] + 3}}
    return params, aux


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), f"{path}: {sorted(got)}"
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{path}[{i}]")
    else:
        got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


def _assert_state_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("method", FAMILIES)
def test_reference_export_and_import_match_ccmh(method):
    params, aux = _model(method)
    want = j_export.export_reference_state_dict(params, method, aux)
    # from numpy trees, and from the port's tensors
    _assert_state_dicts_equal(export_ref.export_reference_state_dict(params, method, aux), want)
    got = export_ref.export_reference_state_dict(params_from_jax(params, device="cpu"), method,
                                                 params_from_jax(aux, device="cpu"))
    _assert_state_dicts_equal(got, want)

    sd = {k: torch.from_numpy(np.array(v)) for k, v in want.items()}
    t_params, t_cfg, t_aux = import_ref.import_reference_state_dict(sd, method)
    j_params, j_cfg, j_aux = j_import.import_reference_state_dict(sd, method)
    assert t_cfg == TINY and dataclasses.asdict(t_cfg) == {
        k: v for k, v in dataclasses.asdict(j_cfg).items() if k in dataclasses.asdict(t_cfg)}
    _assert_trees_equal(t_params, _np_tree(j_params))
    _assert_trees_equal(t_params, params)              # the round trip is the identity
    _assert_trees_equal(t_aux, _np_tree(j_aux))


def test_unsupported_methods_raise():
    params, _ = _model("DSPH")
    with pytest.raises(NotImplementedError, match="DPSIH"):
        export_ref.export_reference_state_dict(params, "DPSIH")
    with pytest.raises(NotImplementedError, match="DGHDGH"):
        import_ref.import_reference_state_dict({"clip.x": torch.zeros(1)}, "DGHDGH")


def _dataset(tmp_path):
    return write_synthetic_mat_dataset(str(tmp_path / "data"), n=30, n_class=C,
                                       resolution=32, seed=12)


def _codes(save_dir, k_bits=K):
    mat = scio.loadmat(os.path.join(save_dir, "PR_cruve", f"{k_bits}-ours-synthetic-i2t.mat"))
    return {k: mat[k] for k in ("q_img", "q_txt", "r_img", "r_txt")}


@pytest.mark.parametrize("method", ["DSPH", "DCHMT", "TwDH"])
def test_pth_round_trip_serves_the_npz_codes(tmp_path, method):
    """An ``.npz`` and its ``.pth`` export give the same codes through
    ``--test`` and through ``Retriever.from_pretrained``."""
    params, aux = _model(method, seed=8)
    npz, pth = str(tmp_path / "m.npz"), str(tmp_path / "m.pth")
    save_checkpoint(npz, params, aux=aux)
    export_ref.export_reference_pth(pth, params, method, aux)
    data = _dataset(tmp_path)
    common = ["--method", method, "--dataset", "synthetic", "--output-dim", str(K),
              "--data-dir", data, "--query-num", "6", "--train-num", "12", "--eval-batch", "24",
              "--clip-arch", "tiny", "--num-workers", "1", "--test", "--device", "cpu"]
    from_npz = torch_main(common + ["--pretrained", npz, "--save-dir", str(tmp_path / "a")])
    from_pth = torch_main(common + ["--pretrained", pth, "--save-dir", str(tmp_path / "b")])
    want = _codes(from_npz.cfg.save_dir)
    for name, codes in _codes(from_pth.cfg.save_dir).items():
        np.testing.assert_array_equal(codes, want[name], err_msg=name)

    images = np.random.RandomState(2).randn(5, 32, 32, 3).astype(np.float32)
    ids = np.random.RandomState(3).randint(1, 400, (5, 32)).astype(np.int32)
    ids[:, 10] = 49407
    ids[:, 11:] = 0
    served = [Retriever.from_pretrained(Config(method=method, output_dim=K, pretrained=p),
                                        device="cpu") for p in (npz, pth)]
    np.testing.assert_array_equal(served[1].encode_images(images),
                                  served[0].encode_images(images))
    np.testing.assert_array_equal(served[1].encode_texts(ids), served[0].encode_texts(ids))


def test_pth_replaces_only_the_trees_it_holds(tmp_path):
    """DMsH_LN's label net has no counterpart in a reference ``.pth``: the
    run keeps its own init of it (``ccmh`` replaces the whole tree)."""
    from ccmh_torch.cli import config_from_args
    from ccmh_torch.train.trainer import Trainer

    params, _ = _model("DMsH_LN", seed=13)
    pth = str(tmp_path / "m.pth")
    export_ref.export_reference_pth(pth, params, "DMsH_LN")
    argv = ["--method", "DMsH_LN", "--dataset", "synthetic", "--output-dim", str(K),
            "--data-dir", _dataset(tmp_path), "--save-dir", str(tmp_path / "o"),
            "--query-num", "6", "--train-num", "12", "--num-workers", "1"]
    fresh = Trainer(config_from_args(argv), clip_cfg=TINY, device="cpu")
    loaded = Trainer(config_from_args(argv + ["--pretrained", pth]), clip_cfg=TINY,
                     device="cpu")
    assert set(loaded.state.params) == set(fresh.state.params) == {
        "clip", "img_head", "txt_head", "label_net"}
    _assert_trees_equal({k: loaded.state.params[k] for k in params}, params)
    _assert_trees_equal(loaded.state.params["label_net"],
                        params_to_jax(fresh.state.params["label_net"]))


def test_export_cli_matches_ccmh(tmp_path):
    params, _ = _model("DSPH", seed=9)
    npz = str(tmp_path / "m.npz")
    save_checkpoint(npz, params)
    got, want = str(tmp_path / "t.pth"), str(tmp_path / "j.pth")
    assert export_ref.main([npz, "--method", "DSPH", "--output-dim", str(K), "-o", got,
                            "--device", "cpu"]) == 0
    clip_pt = str(tmp_path / "tower.pt")       # ccmh takes the architecture from a tower
    torch.save({k: torch.from_numpy(v) for k, v in
                export_ref.export_clip_state_dict(params["clip"], prefix="").items()}, clip_pt)
    assert j_export._main([npz, "--method", "DSPH", "--output-dim", str(K), "--clip-path",
                           clip_pt, "-o", want]) == 0
    got, want = torch.load(got), torch.load(want)
    # ccmh writes the 0-d logit_scale as [1] (np.ascontiguousarray); the
    # port keeps it 0-d, as the reference model's parameter is
    assert got["clip.logit_scale"].shape == () and want["clip.logit_scale"].shape == (1,)
    want["clip.logit_scale"] = want["clip.logit_scale"].reshape(())
    _assert_state_dicts_equal({k: v.numpy() for k, v in got.items()},
                              {k: v.numpy() for k, v in want.items()})


def _openai_sd(params):
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          export_ref.export_clip_state_dict(params["clip"], prefix="").items()}
    # OpenAI's archives carry these three ints too; the converters drop them
    sd.update(input_resolution=torch.tensor(32), context_length=torch.tensor(77),
              vocab_size=torch.tensor(49408))
    return sd


class _Holder(torch.nn.Module):
    """A scriptable module whose state dict is a given flat state dict."""

    def __init__(self, sd):
        super().__init__()
        for key, value in sd.items():
            *path, leaf = key.split(".")
            module = self
            for part in path:
                if not hasattr(module, part):
                    module.add_module(part, torch.nn.Module())
                module = getattr(module, part)
            if value.is_floating_point():
                module.register_parameter(leaf, torch.nn.Parameter(value, requires_grad=False))
            else:
                module.register_buffer(leaf, value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


@pytest.mark.parametrize("form", ["state_dict", "hf_state_dict", "torchscript"])
def test_openai_pt_conversion_matches_ccmh(tmp_path, form):
    params, _ = _model("DSPH", seed=10)
    path = str(tmp_path / "tower.pt")
    if form == "hf_state_dict":
        torch.save({k: torch.from_numpy(np.array(v, order="C"))
                    for k, v in hf.to_hf_state_dict(params["clip"], TINY).items()}, path)
    elif form == "state_dict":
        torch.save(_openai_sd(params), path)
    else:
        torch.jit.script(_Holder(_openai_sd(params))).save(path)
        with pytest.raises(RuntimeError):
            torch.load(path, weights_only=True)     # only torch.jit.load reads it
    want, want_cfg = j_convert.convert_torch_checkpoint(path)
    got, got_cfg = convert.convert_torch_checkpoint(path, device="cpu")
    assert got_cfg == TINY and want_cfg == JTINY
    _assert_trees_equal(got, _np_tree(want))
    _assert_trees_equal(got, params["clip"])
    got_sd, _ = convert.convert_state_dict(_openai_sd(params), device="cpu")
    _assert_trees_equal(got_sd, params["clip"])

    # --clip-path through the Trainer takes the same tower
    trainer = torch_main(["--method", "DSPH", "--dataset", "synthetic", "--output-dim", str(K),
                          "--data-dir", _dataset(tmp_path), "--save-dir", str(tmp_path / "o"),
                          "--query-num", "6", "--train-num", "12", "--epochs", "0",
                          "--clip-path", path, "--num-workers", "1", "--device", "cpu"])
    assert trainer.clip_cfg == TINY
    _assert_trees_equal(trainer.state.params["clip"], params["clip"])


def test_resnet_towers_raise():
    """A ModifiedResNet tower converts (tests/test_torch_resnet.py holds it
    to ccmh); what still raises for one are the exports with no such
    tower, HF's ``CLIPModel`` and the reference ``.pth``, as in ccmh."""
    from ccmh_torch.clip.model import init_clip_params as t_init_clip

    rn = ClipConfig(embed_dim=64, image_resolution=64, vision_layers=(1, 1, 1, 1),
                    vision_width=8, vision_patch_size=None, transformer_width=128,
                    transformer_heads=2, transformer_layers=2)
    clip = t_init_clip(torch.Generator().manual_seed(0), rn)
    assert convert.infer_clip_config(clip) == rn
    with pytest.raises(ValueError, match="ModifiedResNet"):
        hf.to_hf_state_dict(clip, rn)
    with pytest.raises(NotImplementedError, match="RN-family"):
        export_ref.export_clip_state_dict(clip)


def test_hf_state_dict_conversions_match_ccmh():
    params, _ = _model("DSPH", seed=11)
    want = j_hf.to_hf_state_dict(params["clip"], JTINY)
    got = hf.to_hf_state_dict(params_from_jax(params["clip"], device="cpu"), TINY)
    _assert_state_dicts_equal(got, want)
    assert hf._looks_like_hf(got) and not hf._looks_like_hf(_openai_sd(params))
    _assert_state_dicts_equal(hf.hf_to_openai_state_dict(got), j_hf.hf_to_openai_state_dict(want))
    t_params, t_cfg = hf.load_hf_clip(got, device="cpu")
    _assert_trees_equal(t_params, params["clip"])
    assert t_cfg == TINY


@pytest.mark.parametrize("safe", [True, False], ids=["safetensors", "pytorch_model.bin"])
def test_hf_directory_loads_without_transformers(tmp_path, safe, monkeypatch):
    """A directory ``save_pretrained`` wrote (text heads 4, not width // 64)
    loads to ccmh's parameters and head counts."""
    four_heads = dataclasses.replace(JTINY, transformer_heads=4)
    torch.manual_seed(5)
    model = transformers.CLIPModel(j_hf.make_hf_config(four_heads)).float().eval()
    out = str(tmp_path / "hf")
    model.save_pretrained(out, safe_serialization=safe)
    assert os.path.exists(os.path.join(out, "model.safetensors" if safe
                                       else "pytorch_model.bin"))
    want, want_cfg = j_hf.load_hf_clip(out)
    import sys

    monkeypatch.setitem(sys.modules, "transformers", None)     # the card's machine
    got, got_cfg = convert.load_clip_params(out, device="cpu")
    assert got_cfg.transformer_heads == want_cfg.transformer_heads == 4
    assert got_cfg == dataclasses.replace(TINY, transformer_heads=4)
    _assert_trees_equal(got, _np_tree(want))


def test_hf_directory_refuses_an_unrepresentable_vision_head_count(tmp_path):
    model = transformers.CLIPModel(j_hf.make_hf_config(JTINY)).float().eval()
    out = str(tmp_path / "hf")
    model.save_pretrained(out)
    with open(os.path.join(out, "config.json")) as fh:
        config = json.load(fh)
    config["vision_config"]["num_attention_heads"] = 4
    with open(os.path.join(out, "config.json"), "w") as fh:
        json.dump(config, fh)
    with pytest.raises(ValueError, match="cannot be represented"):
        hf.load_hf_clip(out, device="cpu")


def test_safetensors_reader_reads_every_dtype(tmp_path):
    from safetensors.torch import save_file

    tensors = {"f32": torch.randn(3, 4), "bf16": torch.randn(5).to(torch.bfloat16),
               "f16": torch.randn(2, 2).half(), "i64": torch.arange(6).reshape(2, 3),
               "u8": torch.arange(7, dtype=torch.uint8), "empty": torch.zeros(0, 3)}
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = hf.read_safetensors(path)
    assert sorted(got) == sorted(tensors)
    for name, t in tensors.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name
    assert params_to_jax(got)["bf16"].dtype == np.float32
