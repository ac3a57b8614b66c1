"""Mesh evaluation of ccmh_torch on two gloo ranks on the CPU: ``calc_map``
and ``calc_map_4way`` with the queries or the gallery sharded over the data
axis, ``topk_search_sharded`` and ``HashIndex(mesh=)``, held to ``ccmh``'s
mesh versions on a 2-device CPU mesh and to the single-device port.

One spawn of two ranks (tests/torch_parallel_harness.py ``_search``) serves
the file.  mAP within 1e-6 with the queries sharded and 1e-5 with the
gallery sharded (tests/test_parallel.py's tolerances), on a gallery of 203
items that two ranks do not divide; the search exactly (distances and
indices, ties included) for ±1 and packed codes, with k above the 102 rows
of a shard; the same results on both ranks.
"""

import numpy as np
import pytest

from ccmh.ops.map_metric import calc_map as j_calc_map, calc_map_4way as j_calc_map_4way
from ccmh.ops.packing import pack_codes_np
from ccmh.parallel.mesh import make_mesh as j_make_mesh
from ccmh.retrieval import HashIndex as JIndex, topk_search_sharded as j_sharded
from ccmh_torch.retrieval import HashIndex, topk_search
from tests import torch_parallel_harness as H


def _codes(rng, n, k):
    return (rng.randint(0, 2, (n, k)) * 2 - 1).astype(np.int8)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.RandomState(11)
    q, r = _codes(rng, 37, 16), _codes(rng, 203, 16)       # 203 = 2 * 101 + 1
    r[5] = r[150] = q[0]                                    # ties across the shards
    ql = (rng.rand(37, 8) < 0.25).astype(np.float32)
    rl = (rng.rand(203, 8) < 0.25).astype(np.float32)
    qt, rt = _codes(rng, 37, 16), _codes(rng, 203, 16)
    sq, sg = _codes(rng, 13, 16), _codes(rng, 203, 16)
    sg[7] = sg[190] = sq[2]
    wide_q, wide_g = _codes(rng, 11, 64), _codes(rng, 203, 64)
    root = tmp_path_factory.mktemp("search")
    return {"q": q, "r": r, "ql": ql, "rl": rl, "qi": q, "qt": qt, "ri": r, "rt": rt,
            "search": {"pm1": (sq, sg, 120), "pm1_k7": (sq, sg, 7),
                       "packed": (pack_codes_np(sq), pack_codes_np(sg), 120)},
            "index_codes": wide_g, "index_queries": wide_q,
            "index_path": str(root / "index.npz")}


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    return H.run(tmp_path_factory.mktemp("search_ranks"), 2, "search", data)


@pytest.fixture(scope="module")
def jmesh():
    return j_make_mesh(2)


def test_both_ranks_return_the_same_results(ranks):
    r0, r1 = ranks
    assert r0["map"] == r1["map"]
    for name in r0["search"]:
        for a, b in zip(r0["search"][name], r1["search"][name]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", ["exact", "hist"])
def test_query_sharded_map_matches_ccmh_mesh(ranks, data, jmesh, method):
    d = data
    want = float(j_calc_map(d["q"], d["r"], d["ql"], d["rl"], method=method, mesh=jmesh))
    single = float(j_calc_map(d["q"], d["r"], d["ql"], d["rl"], method=method))
    for key in ("query", "query_chunk"):
        assert abs(ranks[0]["map"][(key, method)] - want) < 1e-6
        assert abs(ranks[0]["map"][(key, method)] - single) < 1e-6


def test_gallery_sharded_map_matches_ccmh_mesh(ranks, data, jmesh):
    d = data
    want = float(j_calc_map(d["q"], d["r"], d["ql"], d["rl"], method="hist", mesh=jmesh,
                            shard_gallery=True))
    assert abs(ranks[0]["map"][("gallery", "hist")] - want) < 1e-5


@pytest.mark.parametrize("shard_gallery", [False, True], ids=["queries", "gallery"])
def test_map_4way_over_the_mesh_matches_ccmh(ranks, data, jmesh, shard_gallery):
    d = data
    want = [float(v) for v in j_calc_map_4way(d["qi"], d["qt"], d["ri"], d["rt"], d["ql"],
                                              d["rl"], mesh=jmesh,
                                              shard_gallery=shard_gallery)]
    np.testing.assert_allclose(ranks[0]["map"][("4way", shard_gallery)], want,
                               atol=1e-5 if shard_gallery else 1e-6)


def test_exact_path_refuses_gallery_sharding_as_ccmh(ranks, data, jmesh):
    d = data
    with pytest.raises(ValueError) as e:
        j_calc_map(d["q"], d["r"], d["ql"], d["rl"], method="exact", mesh=jmesh,
                   shard_gallery=True)
    assert ranks[0]["exact_refusal"] == str(e.value)


@pytest.mark.parametrize("name", ["pm1", "pm1_k7", "packed"])
def test_sharded_search_equals_ccmh_and_single_device(ranks, data, jmesh, name):
    queries, gallery, k = data["search"][name]
    jd, ji = j_sharded(queries, gallery, k, jmesh)
    sd, si = topk_search(queries, gallery, k, device="cpu")
    for rank in ranks:
        d, i = rank["search"][name]
        np.testing.assert_array_equal(d, np.asarray(jd))
        np.testing.assert_array_equal(i, np.asarray(ji))
        np.testing.assert_array_equal(d, sd)
        np.testing.assert_array_equal(i, si)


def test_mesh_hash_index_shards_searches_saves_and_refuses_add(ranks, data, jmesh):
    codes, queries = data["index_codes"], data["index_queries"]
    want = HashIndex(codes, packed=True, device="cpu").search(queries, 9)
    jwant = JIndex(codes, packed=True, mesh=jmesh).search(queries, 9)
    # each rank holds its shard only: 102 rows, the last one short of its pad
    assert [rank["index_shard_rows"] for rank in ranks] == [102, 101]
    for rank in ranks:
        for got, w, jw in zip(rank["index_search"], want, jwant):
            np.testing.assert_array_equal(got, w)
            np.testing.assert_array_equal(got, np.asarray(jw))
    saved = HashIndex.load(data["index_path"], device="cpu")
    assert saved.n == 203
    np.testing.assert_array_equal(saved.search(queries, 9)[1], want[1])
    with pytest.raises(NotImplementedError) as e:
        JIndex(codes, mesh=jmesh).add(codes[:3])
    assert ranks[0]["add_refusal"] == ranks[1]["add_refusal"] == str(e.value)
    with pytest.raises(ValueError, match="single-device"):
        HashIndex(codes, mesh=object(), dist_fn=lambda q, r: q, max_dist=64)
