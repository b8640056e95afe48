"""The port's collective plane against the JAX package's, on the CPU.

The same numpy-seeded documents go into both packages' Engines: 4 shards,
200 docs, deletes, a second segment on two shards, a text field ``t``, a
``long`` field ``n`` and a ``keyword`` field ``cat`` (some docs lack each).
The JAX plane runs on a one-device mesh (``spd = 4``), the port's on a CPU
mesh of one gloo rank (``make_mesh(dp=1, shard=1, device="cpu")``), both
through ``MeshEngineSearcher.search_batch`` with same-shape bodies batched.

Bar: totals and per-shard totals exact; doc ids identical apart from exact
ties (scripts/bm25_oracle.py ``recall_with_tie_tolerance``); scores within
f32 rounding; sort values, counts and extrema exact; sums within rtol 1e-6
(K9's order against XLA's). Ineligible shapes raise the reference's
QueryParsingError text on both sides. Also: the port's and the JAX
package's ``rpc_oracle``, the block cache's counters, and the plane on two
gloo ranks (each rank 2 of the 4 shards, a FileStore) equal to one rank.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

from elasticsearch_tpu.common.errors import (
    QueryParsingError as JaxQueryParsingError)
from elasticsearch_tpu.index.engine import Engine as JaxEngine
from elasticsearch_tpu.mapping import MapperService as JaxMapperService
from elasticsearch_tpu.parallel import make_mesh as jax_make_mesh
from elasticsearch_tpu.parallel import mesh_engine as jax_me
from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, NotPortedError, QueryParsingError)
from elasticsearch_tpu_torch.index.engine import Engine
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.parallel import make_mesh
from elasticsearch_tpu_torch.parallel import mesh_engine as me

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
from bm25_oracle import recall_with_tie_tolerance  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
N_SHARDS = 4
RTOL = 2.4e-7            # 2 ulp of f32: the BM25 arithmetic's bar
SUM_RTOL = 1e-6
MAPPING = {"properties": {"t": {"type": "text", "analyzer": "whitespace"},
                          "n": {"type": "long"},
                          "cat": {"type": "keyword"}}}
#: the documents and their shard layout; the two-rank test's children
#: rebuild them from this source, so it imports nothing but numpy
CORPUS_SRC = textwrap.dedent('''
    import numpy as np

    def corpus_ops(seed=11, n_shards=4):
        """(shard, op, id, doc) in order; "refresh" ops cut segments."""
        rng = np.random.default_rng(seed)
        ops = []

        def doc(i):
            words = [f"w{int(x)}" for x in rng.zipf(1.7, size=7) if x < 30]
            d = {"t": " ".join(words) or "w1"}
            if i % 7:
                d["n"] = int((i * 37) % 101)
            if i % 9:
                d["cat"] = f"c{(i * 5) % 11}"
            return d
        for i in range(160):
            ops.append((i % n_shards, "index", str(i), doc(i)))
        for i in (3, 17, 42, 97):
            ops.append((i % n_shards, "delete", str(i), None))
        for si in range(2):
            ops.append((si, "refresh", None, None))
        for i in range(160, 200):
            ops.append((i % n_shards, "index", str(i), doc(i)))
        for si in range(n_shards):
            ops.append((si, "refresh", None, None))
        return ops

    def build(engine_cls, ms, base, n_shards=4, seed=11):
        engines = [engine_cls(base / f"s{i}", ms) for i in range(n_shards)]
        for si, op, did, d in corpus_ops(seed, n_shards):
            if op == "index":
                engines[si].index(did, d)
            elif op == "delete":
                engines[si].delete(did)
            else:
                engines[si].refresh()
        return engines
''')
_ns: dict = {}
exec(CORPUS_SRC, _ns)
build_engines = _ns["build"]


@pytest.fixture(scope="module")
def planes(tmp_path_factory):
    """(jax searcher, port searcher, jax engines, port engines, mappers)."""
    tmp = tmp_path_factory.mktemp("torch_plane")
    jms, ms = JaxMapperService(), MapperService()
    jms.merge("_doc", MAPPING)
    ms.merge("_doc", MAPPING)
    jengs = build_engines(JaxEngine, jms, tmp / "jax")
    engs = build_engines(Engine, ms, tmp / "torch")
    jmesh = jax_make_mesh(dp=1, shard=1, devices=jax.devices()[:1])
    mesh = make_mesh(dp=1, shard=1, device="cpu")
    out = (jax_me.MeshEngineSearcher(jmesh, jengs, jms),
           me.MeshEngineSearcher(mesh, engs, ms), jengs, engs, jms, ms)
    yield out
    for e in jengs + engs:
        e.close()
    me.clear_block_cache()


def _ids(searcher, res):
    return [searcher.doc_id(int(d)) for d in res["doc_ids"]]


def assert_plane_same(jres, pres, jsearch, psearch, what):
    assert len(jres) == len(pres)
    for bi, (j, p) in enumerate(zip(jres, pres)):
        tag = f"{what} [{bi}]"
        assert p["total"] == j["total"], tag
        assert np.array_equal(p["shard_totals"], j["shard_totals"]), tag
        np.testing.assert_allclose(p["scores"], j["scores"], rtol=RTOL,
                                   atol=0, err_msg=tag)
        jids, pids = _ids(jsearch, j), _ids(psearch, p)
        assert len(pids) == len(jids), tag
        if pids != jids:
            # exact ties may reorder: the bar is tie-tolerant recall 1.0
            score_of = dict(zip(jids, map(float, j["scores"])))
            score_of.update(zip(pids, map(float, p["scores"])))
            assert recall_with_tie_tolerance(
                jids, score_of, pids, len(jids), tol=RTOL) == 1.0, tag
        else:
            assert np.array_equal(p["doc_ids"], j["doc_ids"]), tag
        assert ("sort_values" in p) == ("sort_values" in j), tag
        if "sort_values" in j:
            # field values exact; a _score key within f32 rounding
            assert_aggs_same(p["sort_values"], j["sort_values"], tag,
                             rtol=RTOL)
        assert ("aggregations" in p) == ("aggregations" in j), tag
        if "aggregations" in j:
            assert_aggs_same(p["aggregations"], j["aggregations"], tag)


SUMS = ("sum", "avg")


def assert_aggs_same(got, want, path, rtol=0.0):
    assert type(got) is type(want), (path, got, want)
    if isinstance(got, dict):
        assert set(got) == set(want), (path, got, want)
        for key in got:
            assert_aggs_same(got[key], want[key], f"{path}.{key}",
                             SUM_RTOL if key in SUMS else rtol)
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want), (path, got, want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert_aggs_same(a, b, f"{path}[{i}]", rtol)
    elif isinstance(got, float) and rtol:
        assert got == pytest.approx(want, rel=rtol, abs=1e-9), \
            (path, got, want)
    else:
        assert got == want, (path, got, want)


def _both(planes, bodies, global_stats=True):
    js, ps = planes[0], planes[1]
    return (js.search_batch(bodies, global_stats=global_stats),
            ps.search_batch(bodies, global_stats=global_stats))


MATCH = ["w1 w3", "w2 w5", "w4 w7", "w0 w1"]

SHAPES = {
    "match": [{"query": {"match": {"t": q}}, "size": 25} for q in MATCH],
    "bool_range": [{"query": {"bool": {
        "must": [{"match": {"t": q}}],
        "filter": [{"range": {"n": {"gte": 20 + 10 * i}}}]}}, "size": 30}
        for i, q in enumerate(MATCH)],
    "phrase": [{"query": {"match_phrase": {"t": q}}, "size": 20}
               for q in ("w1 w2", "w2 w1", "w1 w1")],
    "score_cursor": [{"query": {"match": {"t": q}}, "size": 10,
                      "search_after": [s]}
                     for q, s in zip(MATCH, (1.5, 2.0, 0.8, 3.0))],
    "post_filter_min_score": [{
        "query": {"match": {"t": q}}, "size": 15, "min_score": 0.5,
        "post_filter": {"range": {"n": {"lt": 60}}}} for q in MATCH],
    "n_asc": [{"query": {"match": {"t": q}}, "size": 12,
               "sort": [{"n": "asc"}]} for q in MATCH],
    "n_desc_first": [{"query": {"match": {"t": q}}, "size": 12,
                      "sort": [{"n": {"order": "desc",
                                      "missing": "_first"}}]}
                     for q in MATCH],
    "n_desc_last": [{"query": {"match": {"t": q}}, "size": 12,
                     "sort": [{"n": {"order": "desc", "missing": "_last"}}]}
                    for q in MATCH],
    "n_asc_missing": [{"query": {"match": {"t": q}}, "size": 12, "from": 3,
                       "sort": [{"n": {"order": "asc", "missing": 50}}]}
                      for q in MATCH],
    "n_asc_first": [{"query": {"match_all": {}}, "size": 9,
                     "sort": [{"n": {"order": "asc", "missing": "_first"}}]}],
    "cat_asc": [{"query": {"match": {"t": q}}, "size": 14,
                 "sort": [{"cat": "asc"}]} for q in MATCH],
    "cat_desc_n": [{"query": {"match": {"t": q}}, "size": 14,
                    "sort": [{"cat": {"order": "desc"}}, {"n": "asc"}]}
                   for q in MATCH],
    "n_score": [{"query": {"match": {"t": q}}, "size": 14,
                 "sort": [{"n": "desc"}, "_score"]} for q in MATCH],
    "field_cursor": [{"query": {"match": {"t": q}}, "size": 10,
                      "sort": [{"cat": "asc"}, {"n": "desc"}],
                      "search_after": [c, v]}
                     for q, c, v in zip(MATCH, ("c2", "c3x", "c0", "c9a"),
                                        (40, 50, 100, 0))],
    "numeric_cursor": [{"query": {"match_all": {}}, "size": 8,
                        "sort": [{"n": "asc"}], "search_after": [v]}
                       for v in (10, 55, 99)],
    "metrics": [{"query": {"match": {"t": q}}, "size": 5, "aggs": {
        "mn": {"min": {"field": "n"}}, "mx": {"max": {"field": "n"}},
        "sm": {"sum": {"field": "n"}}, "av": {"avg": {"field": "n"}},
        "vc": {"value_count": {"field": "n"}},
        "st": {"stats": {"field": "n"}}}} for q in MATCH],
    "buckets": [{"query": {"match": {"t": q}}, "size": 5, "aggs": {
        "by_cat": {"terms": {"field": "cat", "size": 4}},
        "hist": {"histogram": {"field": "n", "interval": 10}}}}
        for q in MATCH],
    "sorted_aggs": [{"query": {"match": {"t": q}}, "size": 6,
                     "sort": [{"n": "asc"}], "post_filter": {
                         "term": {"cat": "c1"}}, "aggs": {
                         "by_cat": {"terms": {"field": "cat"}},
                         "st": {"stats": {"field": "n"}}}}
                    for q in MATCH],
}


@pytest.mark.parametrize("global_stats", [True, False])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plane_matches_jax_plane(planes, shape, global_stats):
    jres, pres = _both(planes, SHAPES[shape], global_stats)
    assert_plane_same(jres, pres, planes[0], planes[1], shape)


def test_plane_matches_both_rpc_oracles(planes):
    """Score order with global statistics: the port's plane against the
    port's fan-out oracle, which the JAX package's oracle also matches."""
    _, ps, jengs, engs, jms, ms = planes
    for q in MATCH[:2]:
        body = {"query": {"match": {"t": q}}, "size": 25}
        res = ps.search_batch([body], global_stats=True)[0]
        total, rows = me.rpc_oracle(ms, engs, body, 25, device="cpu")
        jtotal, jrows = jax_me.rpc_oracle(jms, jengs, body, 25)
        assert res["total"] == total == jtotal
        got = [(float(s), ps.doc_id(int(d)))
               for s, d in zip(res["scores"], res["doc_ids"])]
        assert [r[2] for r in rows] == [g[1] for g in got] or \
            recall_with_tie_tolerance(
                [r[2] for r in rows], {r[2]: r[0] for r in rows} | {
                    g[1]: g[0] for g in got}, [g[1] for g in got],
                len(rows), tol=RTOL) == 1.0
        np.testing.assert_allclose([g[0] for g in got], [r[0] for r in rows],
                                   rtol=RTOL)
        np.testing.assert_allclose([r[0] for r in jrows],
                                   [r[0] for r in rows], rtol=RTOL)


def test_plane_two_indices(tmp_path):
    """mapper_services: two indices' shards in one batch."""
    other = {"properties": {"t": {"type": "text", "analyzer": "standard"},
                            "n": {"type": "long"},
                            "cat": {"type": "keyword"}}}
    jms_a, jms_b, ms_a, ms_b = (JaxMapperService(), JaxMapperService(),
                                MapperService(), MapperService())
    for svc, mapping in ((jms_a, MAPPING), (ms_a, MAPPING),
                         (jms_b, other), (ms_b, other)):
        svc.merge("_doc", mapping)
    ja = build_engines(JaxEngine, jms_a, tmp_path / "ja", 2, seed=3)
    jb = build_engines(JaxEngine, jms_b, tmp_path / "jb", 2, seed=4)
    pa = build_engines(Engine, ms_a, tmp_path / "pa", 2, seed=3)
    pb = build_engines(Engine, ms_b, tmp_path / "pb", 2, seed=4)
    try:
        js = jax_me.MeshEngineSearcher(
            jax_make_mesh(dp=1, shard=1, devices=jax.devices()[:1]),
            ja + jb, jms_a, mapper_services=[jms_a] * 2 + [jms_b] * 2)
        ps = me.MeshEngineSearcher(
            make_mesh(device="cpu"), pa + pb, ms_a,
            mapper_services=[ms_a] * 2 + [ms_b] * 2)
        for bodies in (SHAPES["match"], SHAPES["cat_desc_n"],
                       SHAPES["buckets"]):
            for gs in (True, False):
                assert_plane_same(js.search_batch(bodies, global_stats=gs),
                                  ps.search_batch(bodies, global_stats=gs),
                                  js, ps, "two indices")
    finally:
        for e in ja + jb + pa + pb:
            e.close()


INELIGIBLE = {
    "doc_sort": [{"query": {"match_all": {}}, "sort": ["_doc"]}],
    "text_sort": [{"query": {"match_all": {}}, "sort": [{"t": "asc"}]}],
    "sub_aggs": [{"query": {"match_all": {}}, "aggs": {"c": {
        "terms": {"field": "cat"},
        "aggs": {"m": {"max": {"field": "n"}}}}}}],
    "range_agg": [{"query": {"match_all": {}}, "aggs": {"r": {
        "range": {"field": "n", "ranges": [{"to": 50}]}}}}],
    "divergent_sorts": [
        {"query": {"match_all": {}}, "sort": [{"n": "asc"}]},
        {"query": {"match_all": {}}, "sort": [{"n": "desc"}]}],
    "divergent_aggs": [
        {"query": {"match_all": {}}, "aggs": {"a": {"max": {"field": "n"}}}},
        {"query": {"match_all": {}}, "aggs": {"a": {"min": {"field": "n"}}}}],
    "doc_id_cursor": [{"query": {"match": {"t": "w1"}},
                       "search_after": [1.0, 5]}],
    "keyword_missing": [{"query": {"match_all": {}},
                         "sort": [{"cat": {"order": "asc",
                                           "missing": "zz"}}]}],
    "mixed_sort_mode": [{"query": {"match_all": {}}},
                        {"query": {"match_all": {}}, "sort": [{"n": "asc"}]}],
    "partial_cursor": [{"query": {"match_all": {}},
                        "sort": [{"n": "asc"}, {"cat": "asc"}],
                        "search_after": [3]}],
    "terms_on_text": [{"query": {"match_all": {}}, "aggs": {"x": {
        "terms": {"field": "t"}}}}],
    "mixed_plans": [{"query": {"match": {"t": "w1"}}},
                    {"query": {"match_phrase": {"t": "w1 w2"}}}],
}


@pytest.mark.parametrize("shape", sorted(INELIGIBLE))
def test_ineligible_shapes_raise_alike(planes, shape):
    js, ps = planes[0], planes[1]
    with pytest.raises(JaxQueryParsingError) as jerr:
        js.search_batch(INELIGIBLE[shape])
    with pytest.raises(QueryParsingError) as perr:
        ps.search_batch(INELIGIBLE[shape])
    assert str(perr.value) == str(jerr.value)


def test_deep_page_and_k_over_rows(planes):
    """from + size past every shard's rows: k buckets above the stride in
    both modes, pads never rendered."""
    bodies = [{"query": {"match_all": {}}, "from": 150, "size": 100}]
    for extra in ({}, {"sort": [{"n": "desc"}, {"cat": "asc"}]}):
        b = [dict(bodies[0], **extra)]
        jres, pres = _both(planes, b, True)
        assert_plane_same(jres, pres, planes[0], planes[1], str(extra))
        assert len(pres[0]["doc_ids"]) == pres[0]["total"]


def test_mesh_geometry_and_refusals():
    with pytest.raises(IllegalArgumentError) as err:
        make_mesh(dp=2, device="cpu")
    assert str(err.value) == ("mesh geometry dp=2 does not divide 1 "
                              "devices; valid dp×shard factorizations: "
                              "[(1, 1)]")
    with pytest.raises(IllegalArgumentError):
        make_mesh(dp=1, shard=2, device="cpu")
    with pytest.raises(NotPortedError):
        make_mesh(devices=["cpu", "cpu"])
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"dp": 1, "shard": 1} and mesh.shard_index() == 0
    import torch
    t = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    assert torch.equal(mesh.all_gather(t), t[None])
    assert torch.equal(mesh.psum(t), t)


def test_cuda_entry_point_without_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for hosts without")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_block_cache_counters(planes, tmp_path):
    """A first build uploads every column; a rebuild over the same views
    reuses them (``prev`` hands its slots over); a delete-only refresh
    re-ships live masks and zero column bytes; an added segment uploads
    only its own slot's blocks."""
    ms = MapperService()
    ms.merge("_doc", MAPPING)
    engs = build_engines(Engine, ms, tmp_path, seed=5)
    try:
        mesh = make_mesh(device="cpu")
        sinks = [{} for _ in engs]
        s1 = me.MeshEngineSearcher(mesh, engs, ms, stats_sinks=sinks)
        assert s1.data_layer["kind"] == "full"
        assert s1.data_layer["col_bytes_uploaded"] > 0
        assert sum(sk["col_bytes_uploaded"] for sk in sinks) == \
            s1.data_layer["col_bytes_uploaded"]
        s2 = me.MeshEngineSearcher(mesh, engs, ms, prev=s1)
        assert s2.data_layer["col_bytes_uploaded"] == 0
        assert s2.data_layer["mask_bytes_uploaded"] == 0
        assert s2.data_layer["bytes_reused"] == \
            s1.data_layer["col_bytes_uploaded"]
        assert s2.data_layer["slots_reused"] == s2.n_slots
        engs[1].delete("1")
        engs[1].refresh()
        s3 = me.MeshEngineSearcher(mesh, engs, ms, prev=s2)
        assert s3.data_layer["kind"] == "mask_only"
        assert s3.data_layer["col_bytes_uploaded"] == 0
        assert s3.data_layer["mask_bytes_uploaded"] > 0
        assert s3.data_layer["slots_reused"] < s3.n_slots
        body = {"query": {"match": {"t": "w1"}}, "size": 200}
        ids = {s3.doc_id(int(d))
               for d in s3.search_batch([body])[0]["doc_ids"]}
        assert "1" not in ids
        engs[2].index("new", {"t": "w1 w1", "n": 1})
        engs[2].refresh()
        s4 = me.MeshEngineSearcher(mesh, engs, ms, prev=s3,
                                   stats_sinks=sinks)
        assert s4.data_layer["kind"] == "incremental"
        assert 0 < s4.data_layer["col_bytes_uploaded"] < \
            s1.data_layer["col_bytes_uploaded"]
        assert sinks[2]["incremental_refreshes"] == 1
        assert me.block_cache_stats()["entries"] > 0
        assert s4.device_bytes() > 0
        assert "new" in {s4.doc_id(int(d)) for d in
                         s4.search_batch([body])[0]["doc_ids"]}
    finally:
        for e in engs:
            e.close()
    assert not any(k[0] == engs[0].engine_uuid
                   for k in me.block_cache_keys())
    with pytest.raises(NotPortedError):
        me.MeshEngineSearcher(make_mesh(device="cpu"), planes[3], planes[5],
                              breaker_service=object())


RANK_CHILD = textwrap.dedent('''
    import json, sys, tempfile
    from pathlib import Path
    import torch.distributed as dist
    {corpus}
    from elasticsearch_tpu_torch.mapping import MapperService
    from elasticsearch_tpu_torch.index.engine import Engine
    from elasticsearch_tpu_torch.parallel import make_mesh
    from elasticsearch_tpu_torch.parallel.mesh_engine import (
        MeshEngineSearcher)

    world, rank, store_path, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                                         sys.argv[3], sys.argv[4])
    bodies = json.loads(sys.argv[5])
    ms = MapperService()
    ms.merge("_doc", json.loads(sys.argv[6]))
    engines = build(Engine, ms, Path(tempfile.mkdtemp()))
    store = dist.FileStore(store_path, world) if world > 1 else None
    mesh = make_mesh(dp=1, shard=world, devices=["cpu"] * world,
                     store=store, rank=rank)
    plane = MeshEngineSearcher(mesh, engines, ms)
    out = []
    for group in bodies:
        for res in plane.search_batch(group, global_stats=True):
            out.append({{"total": res["total"],
                        "shard_totals": res["shard_totals"].tolist(),
                        "scores": res["scores"].tolist(),
                        "doc_ids": res["doc_ids"].tolist(),
                        "sort_values": res.get("sort_values"),
                        "aggregations": res.get("aggregations")}})
    Path(out_path).write_text(json.dumps(out))
    mesh.close()
''')


def test_two_gloo_ranks_equal_one_rank(tmp_path):
    """Two gloo ranks over a FileStore, each holding 2 of the 4 shards,
    give the one-rank result: the shard-major gather order, the psums and
    the extrema's pair reduce."""
    groups = [SHAPES["match"], SHAPES["cat_desc_n"], SHAPES["field_cursor"],
              SHAPES["metrics"], SHAPES["buckets"]]
    src = tmp_path / "rank_child.py"
    src.write_text(RANK_CHILD.format(corpus=CORPUS_SRC))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = []
    for world, rank in ((1, 0), (2, 0), (2, 1)):
        out = tmp_path / f"out_{world}_{rank}.json"
        procs.append((out, subprocess.Popen(
            [sys.executable, str(src), str(world), str(rank),
             str(tmp_path / "store"), str(out), json.dumps(groups),
             json.dumps(MAPPING)], env=env, cwd=str(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for out, p in procs:
        log, _ = p.communicate(timeout=120)
        assert p.returncode == 0, log
    one, r0, r1 = (json.loads(out.read_text()) for out, _ in procs)
    assert r0 == one
    assert r1 == one
