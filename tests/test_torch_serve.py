"""ccmh_torch serving path against ccmh: a DCHMT Retriever restored from
ccmh checkpoints, and the HTTP daemon on an ephemeral port.

Codes are ±1 integers from an argmax over softmax pairs; the fp32 towers
of the two packages agree to ~1e-6, far inside the pairs' margins on
these seeded inputs, so codes compare exactly.
"""

import base64
import io
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from ccmh.clip.convert import save_params_npz as jax_save_npz
from ccmh.clip.model import ClipConfig as JaxClipConfig, init_clip_params
from ccmh.config import Config as JaxConfig
from ccmh.retrieval import Retriever as JaxRetriever
from ccmh.tokenizer.bpe import tokenize_batch as jax_tokenize
from ccmh.train.methods import get_method as jax_get_method
from ccmh_torch.clip.model import ClipConfig
from ccmh_torch.config import Config
from ccmh_torch.retrieval import HashIndex, Retriever
from ccmh_torch.serve import RetrievalService, ServiceError, serve
from ccmh_torch.train.methods import available_methods, get_method, unported_methods
from tests.test_retrieval import random_codes

TINY = JaxClipConfig.tiny()
CAPTIONS = ["a dog runs on the grass", "two people ride bikes", "a red car",
            "a cat sleeping on a sofa next to a window"]


def _cfg(**kw):
    base = dict(method="DCHMT", output_dim=16, nclass=8, max_words=32,
                resolution=TINY.image_resolution)
    base.update(kw)
    return base


def _images(n, seed):
    r = TINY.image_resolution
    return np.random.RandomState(seed).randn(n, r, r, 3).astype(np.float32)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(ccmh Retriever, port Retriever) over one tiny DCHMT model, the port
    restored from a Trainer-format .npz written by ccmh."""
    cfg = JaxConfig(**_cfg())
    method = jax_get_method("DCHMT")
    key = jax.random.PRNGKey(0)
    heads, _, aux = method.init(jax.random.fold_in(key, 1), cfg, TINY)
    params = {"clip": init_clip_params(key, TINY), **heads}
    path = str(tmp_path_factory.mktemp("ckpt") / "model.npz")
    jax_save_npz(path, jax.tree.map(np.asarray, {
        "params": params, "extra": {}, "aux": aux, "step": np.int32(0)}))
    jret = JaxRetriever(method, params, aux, cfg, TINY)
    tret = Retriever.from_pretrained(Config(**_cfg(pretrained=path)), device="cpu")
    return jret, tret, path


def test_codes_equal_ccmh(pair):
    jret, tret, _ = pair
    assert tret.clip_cfg == ClipConfig.tiny()
    np.testing.assert_array_equal(tret.encode_texts(CAPTIONS), jret.encode_texts(CAPTIONS))
    imgs = _images(5, seed=1)
    np.testing.assert_array_equal(tret.encode_images(imgs), jret.encode_images(imgs))
    # chunking does not change codes; empty batches keep their width
    np.testing.assert_array_equal(tret.encode_images(imgs, batch_size=2),
                                  jret.encode_images(imgs))
    assert tret.encode_texts([]).shape == (0, 16)
    assert tret.encode_images(np.zeros((0, 32, 32, 3), np.float32)).shape == (0, 16)


def test_text_encode_never_runs_the_vision_tower(pair, monkeypatch):
    _, tret, _ = pair
    import ccmh_torch.train.methods.base as base

    def boom(*a, **k):
        raise AssertionError("vision tower ran for a text query")

    monkeypatch.setattr(base, "vision_forward", boom)
    assert tret.encode_texts(CAPTIONS[:2]).shape == (2, 16)


def test_from_pretrained_checks(pair, tmp_path):
    _, _, path = pair
    with pytest.raises(ValueError):
        Retriever.from_pretrained(Config(**_cfg()), device="cpu")            # no path
    with pytest.raises(ValueError, match="tower"):
        Retriever.from_pretrained(Config(**_cfg(pretrained=path)),
                                  clip_cfg=ClipConfig(), device="cpu")      # wrong arch
    with pytest.raises(ValueError, match="head"):
        Retriever.from_pretrained(Config(**_cfg(pretrained=path, output_dim=32)),
                                  device="cpu")                              # wrong K
    with pytest.raises(FileNotFoundError):
        Retriever.from_pretrained(Config(**_cfg(pretrained=path[:-4] + ".pth")),
                                  device="cpu")                              # no such .pth
    orbax = tmp_path / "state_ckpt" / "e000000"
    orbax.mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="orbax"):
        Retriever.from_pretrained(Config(**_cfg(pretrained=str(orbax.parent))),
                                  device="cpu")                              # ccmh's orbax


def test_registry_says_what_is_ported():
    assert available_methods() == ["DCHMT", "DDBH", "DDWSH", "DGHDGH", "DHaPH", "DMsH_LN",
                                   "DNPH", "DNpH", "DPBE", "DPSIH", "DSPH", "DScPH", "MITH",
                                   "TwDH"]
    assert unported_methods() == []
    for name in available_methods():
        assert get_method(name).name == name
    with pytest.raises(KeyError):
        get_method("NOPE")


def test_ccmh_trainer_checkpoint_served_by_port(tmp_path):
    """A real ccmh Trainer writes its .npz; the port serves it unchanged."""
    from ccmh.data.split import split_data
    from ccmh.data.synthetic import synthetic_arrays
    from ccmh.train.trainer import Trainer

    cfg = JaxConfig(**_cfg(dataset="synthetic", save_dir=str(tmp_path), batch_size=8,
                           epochs=1, query_num=8, train_num=16, eval_batch=8))
    raw = synthetic_arrays(n=32, n_class=8, resolution=TINY.image_resolution)
    splits = split_data(raw, query_num=8, train_num=16, seed=cfg.seed)
    trainer = Trainer(cfg, splits=splits, clip_cfg=TINY,
                      clip_params=init_clip_params(jax.random.PRNGKey(3), TINY))
    path = os.path.join(tmp_path, "model-0.npz")
    trainer.save_checkpoint(path)
    live = JaxRetriever.from_trainer(trainer)
    served = Retriever.from_pretrained(Config(**_cfg(pretrained=path)), device="cpu")
    np.testing.assert_array_equal(served.encode_texts(CAPTIONS), live.encode_texts(CAPTIONS))
    imgs = _images(3, seed=2)
    np.testing.assert_array_equal(served.encode_images(imgs), live.encode_images(imgs))


# ---------------------------------------------------------------- HTTP


@pytest.fixture(scope="module")
def server(pair):
    jret, tret, _ = pair
    gallery = random_codes(64, 16, seed=3, with_ties=False)
    service = RetrievalService(tret, {"image": HashIndex(gallery, device="cpu")})
    srv = serve(service, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv, service, jret, tret, gallery
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)


def _call(srv, path, body=None):
    url = f"http://127.0.0.1:{srv.server_address[1]}{path}"
    data = None if body is None else json.dumps(body).encode()
    with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=60) as resp:
        return json.loads(resp.read())


def _error(srv, path, body):
    with pytest.raises(urllib.error.HTTPError) as err:
        _call(srv, path, body)
    return err.value.code, json.loads(err.value.read())["error"]


def test_healthz(server):
    srv, *_ = server
    got = _call(srv, "/healthz")
    assert got["ok"] and got["method"] == "DCHMT" and got["indexes"] == {"image": 64}
    assert got["resolution"] == TINY.image_resolution


def test_encode_routes_match_ccmh(server):
    srv, _, jret, _, _ = server
    got = _call(srv, "/v1/encode", {"texts": CAPTIONS})
    np.testing.assert_array_equal(np.asarray(got["codes"]), jret.encode_texts(CAPTIONS))
    ids = jax_tokenize(CAPTIONS[:2])
    got = _call(srv, "/v1/encode", {"ids": ids.tolist()})
    np.testing.assert_array_equal(np.asarray(got["codes"]), jret.encode_texts(ids))
    imgs = _images(3, seed=4)
    buf = io.BytesIO()
    np.save(buf, imgs)
    got = _call(srv, "/v1/encode", {"images_b64": base64.b64encode(buf.getvalue()).decode()})
    np.testing.assert_array_equal(np.asarray(got["codes"]), jret.encode_images(imgs))
    got = _call(srv, "/v1/encode", {"images": imgs[:1].tolist()})
    np.testing.assert_array_equal(np.asarray(got["codes"]), jret.encode_images(imgs[:1]))


def test_search_matches_direct_calls_under_concurrency(server):
    srv, service, _, tret, _ = server
    want_d, want_i = service.indexes["image"].search(tret.encode_texts(CAPTIONS), 5)
    results = [None] * len(CAPTIONS)

    def one(j):
        results[j] = _call(srv, "/v1/search", {"texts": [CAPTIONS[j]], "k": 5})

    threads = [threading.Thread(target=one, args=(j,)) for j in range(len(CAPTIONS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for j, got in enumerate(results):
        assert got["indices"] == [want_i[j].tolist()]
        assert got["distances"] == [want_d[j].tolist()]


def test_add_then_search_finds_new_item(server):
    srv, service, _, tret, _ = server
    new = tret.encode_texts(["a completely new caption"])
    got = _call(srv, "/v1/add", {"index": "image", "codes": new.tolist()})
    assert got == {"index": "image", "size": 65}
    found = _call(srv, "/v1/search", {"texts": ["a completely new caption"], "k": 1})
    assert found["distances"] == [[0]]


def test_client_errors_are_400(server):
    srv, *_ = server
    code, msg = _error(srv, "/v1/encode", {"images_jpeg_b64": ["AAAA"]})
    assert code == 400 and "not a decodable JPEG" in msg
    assert _error(srv, "/v1/encode", {})[0] == 400
    assert _error(srv, "/v1/search", {"texts": ["x"], "k": 0})[0] == 400
    assert _error(srv, "/v1/search", {"texts": ["x"], "index": "text"})[0] == 400
    assert _error(srv, "/v1/add", {"codes": [[1, -1]]})[0] == 400


def _fixture_files():
    from tests.test_torch_jpeg_dataset import FIXTURE_DIR, FIXTURES

    return [open(os.path.join(FIXTURE_DIR, f"{n}.jpg"), "rb").read() for n in FIXTURES]


def test_jpeg_b64_codes_equal_ccmh_service(server, pair):
    """``images_jpeg_b64`` over HTTP: the codes of ccmh's service on the
    same files and weights, and of the direct encode of the native
    loader's arrays; bad base64 and undecodable files answer 400 as in
    ccmh."""
    from ccmh.serve import RetrievalService as JService, ServiceError as JServiceError
    from ccmh_torch.data import native

    srv, *_ = server
    jret, tret, _ = pair
    files = _fixture_files()
    body = {"images_jpeg_b64": [base64.b64encode(f).decode() for f in files]}
    got = np.asarray(_call(srv, "/v1/encode", body)["codes"])
    want = JService(jret, {}, batching=False).encode(body)["codes"]
    np.testing.assert_array_equal(got, np.asarray(want))
    arrays, ok = native.decode_batch_mem(files, TINY.image_resolution)
    assert ok.all()
    np.testing.assert_array_equal(got, tret.encode_images(arrays))
    bad_b64 = {"images_jpeg_b64": ["not base64!"]}
    code, msg = _error(srv, "/v1/encode", bad_b64)
    with pytest.raises(JServiceError) as jerr:
        JService(jret, {}, batching=False).encode(bad_b64)
    assert code == 400 and msg == str(jerr.value)
    for body in ({"images_jpeg_b64": "x"}, {"images_jpeg_b64": [base64.b64encode(b"junk").decode()]}):
        with pytest.raises(JServiceError):
            JService(jret, {}, batching=False).encode(body)
        assert _error(srv, "/v1/encode", body)[0] == 400


def test_service_rejects_wrong_width_ids(pair):
    _, tret, _ = pair
    service = RetrievalService(tret, {})
    with pytest.raises(ServiceError):
        service.encode({"ids": [[1, 2, 3]]})
