"""The port stands alone: serving searches through it (a match, a bool with a
match_phrase, a function_score, on the knn lane a dense knn in f32 and int8,
a hybrid and a rank_vectors MaxSim, on the impact lane the eager, pruned
and rescore arms, aggregations reduced by the coordinator's merge, the
percolator's registry, _mpercolate and serial paths, scripts: a
script_score query and function, script_fields, the template query, the
script aggregations and a script_score registration, geo: a
geo_distance and a geo_shape query, nested: a nested query, a nested /
reverse_nested aggregation and a nested registration, and the collective
plane: a score-ordered and a field-sorted search with aggregations over two
shards on a mesh of one gloo rank, and DistributedBM25) loads neither JAX nor
the JAX package, its entry points
never fall back to the CPU on their own, and its CUDA sources include no
header of torch or of the JAX package's native code."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SERVE_ONE_SEARCH = r"""
import json, sys, tempfile
from pathlib import Path
from elasticsearch_tpu_torch.index.device_reader import (
    DeviceReader, device_reader_for)
from elasticsearch_tpu_torch.index.engine import Engine
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.search.phase import (
    ShardSearcher, parse_search_request)

from elasticsearch_tpu_torch.search.controller import merge_responses
from elasticsearch_tpu_torch.search.segment_exec import (
    configure_impact_plane, configure_knn_plane, impact_index_stats)

ms = MapperService()
ms.merge("_doc", {"properties": {
    "body": {"type": "text"}, "rank": {"type": "double"},
    "cls": {"type": "text", "similarity": "classic"},
    "vec": {"type": "dense_vector", "dims": 3},
    "tok": {"type": "rank_vectors", "dims": 2},
    "loc": {"type": "geo_point"}, "shp": {"type": "geo_shape"}}})
eng = Engine(Path(tempfile.mkdtemp()), ms)
vecs = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.6, 0.8, 0.0]]
toks = [[[1.0, 0.0]], [[0.0, 1.0], [0.1, 0.9]], [[0.7, 0.7]]]
locs = [{"lat": 55.0, "lon": 7.0}, "55.5,7.5", [-74.0, 40.0]]
shps = [{"type": "point", "coordinates": [7.0, 55.0]},
        {"type": "polygon", "coordinates": [[[7.4, 55.4], [7.6, 55.4],
                                             [7.5, 55.6], [7.4, 55.4]]]},
        {"type": "linestring", "coordinates": [[-74.0, 40.0],
                                               [-73.0, 41.0]]}]
for i, text in enumerate(["quick brown fox", "lazy dog", "quick dog"]):
    eng.index(str(i), {"body": text, "cls": text, "rank": 10.0 * (3 - i),
                       "vec": vecs[i], "tok": toks[i], "loc": locs[i],
                       "shp": shps[i]})
eng.refresh()
reader = device_reader_for(eng, device="cpu")
searcher = ShardSearcher(0, reader, ms)
configure_knn_plane("int8_idx", {"index.knn.quantization": "int8"})
searcher_int8 = ShardSearcher(0, reader, ms, index_name="int8_idx")


def ids_of(body, s=searcher):
    req = parse_search_request(body)
    res = s.query_phase_batch([req])[0]
    return [h["_id"] for h in s.fetch_phase(
        req, res, "idx", list(range(len(res.doc_ids))))]


knn = {"field": "vec", "query_vector": [0.0, 1.0, 0.1], "k": 3}
knn_ids = [ids_of({"knn": knn}), ids_of({"knn": knn}, searcher_int8),
           ids_of({"knn": knn, "query": {"match": {"body": "fox"}}}),
           ids_of({"knn": {"field": "tok", "query_vector": [[0.0, 1.0]],
                           "k": 3}})]


configure_impact_plane("imp_idx", {"index.search.impact_plane": True,
                                   "index.search.impact.block_rows": 2})
searcher_imp = ShardSearcher(0, reader, ms, index_name="imp_idx")
impact_ids = [
    ids_of({"query": {"match": {"body": "quick dog"}}}, searcher_imp),
    ids_of({"query": {"match": {"body": "quick dog"}},
            "track_total_hits": False}, searcher_imp),
    ids_of({"query": {"match": {"body": "quick"}}, "rescore": {
        "window_size": 5, "query": {"rescore_query": {
            "match": {"body": "fox"}}, "rescore_query_weight": 9.0}}},
        searcher_imp)]
impact_admissions = impact_index_stats("imp_idx")["admissions"]
match_ids = ids_of({"query": {"match": {"body": "quick dog"}}})
phrase_ids = ids_of({"query": {"bool": {
    "must": [{"match": {"body": "dog"}}],
    "should": [{"match_phrase": {"body": "quick dog"}}]}}})
fs_ids = ids_of({"query": {"function_score": {
    "query": {"match": {"body": "dog fox"}},
    "functions": [{"field_value_factor": {"field": "rank",
                                          "modifier": "log1p"}}],
    "boost_mode": "multiply"}}})
leaf_ids = [
    ids_of({"query": {"span_near": {"clauses": [
        {"span_term": {"body": "quick"}}, {"span_term": {"body": "dog"}}],
        "slop": 1, "in_order": True}}}),
    ids_of({"query": {"span_not": {
        "include": {"span_term": {"body": "quick"}},
        "exclude": {"span_term": {"body": "fox"}}, "post": 2}}}),
    ids_of({"query": {"fuzzy": {"body": {"value": "dug", "fuzziness": 1}}}}),
    ids_of({"query": {"match": {"cls": "quick dog"}}})]
geo_ids = [
    ids_of({"query": {"geo_distance": {"distance": "100km",
                                       "loc": {"lat": 55.2, "lon": 7.2}}}}),
    ids_of({"query": {"geo_shape": {"shp": {"shape": {
        "type": "envelope", "coordinates": [[6.5, 56.0], [8.0, 54.8]]}}}}})]
agg_req = parse_search_request({
    "query": {"match": {"body": "quick dog"}}, "size": 2,
    "aggs": {"r": {"stats": {"field": "rank"}},
             "h": {"histogram": {"field": "rank", "interval": 10}}}})
merged = merge_responses("idx", agg_req, [searcher.query_phase(agg_req)],
                         [searcher], 0.0, agg_req.aggs)
agg_out = [merged["aggregations"]["r"]["count"],
           [b["doc_count"] for b in merged["aggregations"]["h"]["buckets"]],
           [h["_id"] for h in merged["hits"]["hits"]]]
import types
from elasticsearch_tpu_torch.search import percolator
pmeta = types.SimpleNamespace(
    name="pidx", uuid="u", settings={}, version=1,
    mappings={"_doc": {"properties": {"body": {"type": "text"}}}},
    percolators={"a": {"query": {"match": {"body": "fox"}}},
                 "b": {"query": {"match_phrase": {"body": {
                     "query": "quick fox", "slop": 1}}}},
                 "c": {"query": {"term": {"body": "dog"}}}})
perc_out = [
    [m["_id"] for m in percolator.percolate(
        pmeta, {"body": "quick brown fox"}, device="cpu")["matches"]],
    [[m["_id"] for m in r["matches"]] for r in percolator.percolate_many(
        pmeta, [{"doc": {"body": "lazy dog"}},
                {"doc": {"body": "quick red fox"}}], device="cpu")],
    percolator.percolate_serial(pmeta, {"body": "quick fox"},
                                device="cpu")["total"]]
script_ids = [
    ids_of({"query": {"script_score": {
        "query": {"match_all": {}},
        "script": {"source": "cosineSimilarity(params.q, 'vec') + 1.0",
                   "params": {"q": [1.0, 0.0, 0.0]}}}}}),
    ids_of({"query": {"function_score": {
        "query": {"match": {"body": "dog fox"}},
        "functions": [{"script_score": {"script": "log(2 + doc['rank']"
                                                  ".value) * 2"}}]}}}),
    ids_of({"query": {"template": {"query": {"match": {
        "body": "{{w}}"}}, "params": {"w": "quick"}}}})]
sf_req = parse_search_request({
    "query": {"match": {"body": "dog"}}, "script_fields": {
        "e": {"script": "doc['rank'].value * 2"},
        "g": {"script": "def r = doc['rank'].value; "
                        "if (r > 15) { return 'big' } else { return r }"}}})
sf_res = searcher.query_phase(sf_req)
script_fields = [h["fields"] for h in searcher.fetch_phase(
    sf_req, sf_res, "idx", list(range(len(sf_res.doc_ids))))]
sa_req = parse_search_request({
    "query": {"match_all": {}}, "size": 0, "aggs": {
        "m": {"scripted_metric": {"map_script": "doc['rank'].value * 2"}},
        "h": {"histogram": {"field": "rank", "interval": 10}, "aggs": {
            "s": {"bucket_script": {"buckets_path": {"c": "_count"},
                                    "script": "log(c + 1) * 2"}},
            "f": {"bucket_selector": {"buckets_path": {"c": "_count"},
                                      "script": "c > 0"}}}}}})
sa = merge_responses("idx", sa_req, [searcher.query_phase(sa_req)],
                     [searcher], 0.0, sa_req.aggs)["aggregations"]
script_aggs = [sa["m"]["value"], len(sa["h"]["buckets"]),
               round(sa["h"]["buckets"][0]["s"]["value"], 6)]
smeta = types.SimpleNamespace(
    name="sidx", uuid="u", settings={}, version=1,
    mappings=pmeta.mappings,
    percolators={"s": {"query": {"script_score": {
        "query": {"match": {"body": "fox"}},
        "script": {"source": "_score * 2"}}}}})
script_perc = [m["_id"] for m in percolator.percolate(
    smeta, {"body": "quick brown fox"}, device="cpu")["matches"]]
nms = MapperService()
nms.merge("_doc", {"properties": {
    "title": {"type": "keyword"},
    "c": {"type": "nested", "properties": {
        "who": {"type": "keyword"}, "text": {"type": "text"}}}}})
neng = Engine(Path(tempfile.mkdtemp()), nms)
for i, objs in enumerate([[{"who": "a", "text": "red"},
                           {"who": "b", "text": "blue"}],
                          [{"who": "a", "text": "blue"}], []]):
    neng.index(str(i), {"title": f"t{i}", "c": objs})
neng.refresh()
nsearcher = ShardSearcher(0, device_reader_for(neng, device="cpu"), nms)
nested_ids = ids_of({"query": {"nested": {"path": "c", "query": {
    "bool": {"must": [{"term": {"c.who": "a"}},
                      {"match": {"c.text": "blue"}}]}}}}}, nsearcher)
na_req = parse_search_request({"query": {"match_all": {}}, "size": 0,
    "aggs": {"n": {"nested": {"path": "c"}, "aggs": {
        "w": {"terms": {"field": "c.who"}},
        "r": {"reverse_nested": {}, "aggs": {
            "t": {"terms": {"field": "title"}}}}}}}})
na = merge_responses("idx", na_req, [nsearcher.query_phase(na_req)],
                     [nsearcher], 0.0, na_req.aggs)["aggregations"]["n"]
nested_aggs = [na["doc_count"],
               [(b["key"], b["doc_count"]) for b in na["w"]["buckets"]],
               na["r"]["doc_count"]]
nmeta = types.SimpleNamespace(
    name="nidx", uuid="u", settings={}, version=1,
    mappings={"_doc": {"properties": {"c": {"type": "nested", "properties": {
        "who": {"type": "keyword"}}}}}},
    percolators={"n": {"query": {"nested": {"path": "c", "query": {
        "term": {"c.who": "a"}}}}}})
nested_perc = [m["_id"] for m in percolator.percolate(
    nmeta, {"c": [{"who": "b"}, {"who": "a"}]}, device="cpu")["matches"]]
from elasticsearch_tpu_torch.models.bm25 import PackedTextIndex
from elasticsearch_tpu_torch.parallel import DistributedBM25, make_mesh
from elasticsearch_tpu_torch.parallel.mesh_engine import (
    MeshEngineSearcher, clear_block_cache)
pms = MapperService()
pms.merge("_doc", {"properties": {"body": {"type": "text"},
                                  "rank": {"type": "double"}}})
peng = [Engine(Path(tempfile.mkdtemp()), pms) for _ in range(2)]
for i, text in enumerate(["quick brown fox", "lazy dog", "quick dog",
                          "quick quick fox"]):
    peng[i // 3].index(str(i), {"body": text, "rank": 10.0 * (3 - i)})
for e in peng:
    e.refresh()
mesh = make_mesh(device="cpu")
plane = MeshEngineSearcher(mesh, peng, pms)
p_score = plane.search_batch([{"query": {"match": {"body": "quick"}}}])[0]
p_sort = plane.search_batch([{"query": {"match": {"body": "quick"}},
                              "sort": [{"rank": "desc"}],
                              "aggs": {"s": {"sum": {"field": "rank"}}}}])[0]
dist = DistributedBM25(mesh, [PackedTextIndex.from_texts(
    ["quick fox", "lazy dog"]), PackedTextIndex.from_texts(["quick dog"])])
d_scores, d_docs, d_totals = dist.search(["quick"], k=2)
plane_out = [[plane.doc_id(int(d)) for d in p_score["doc_ids"]],
             [plane.doc_id(int(d)) for d in p_sort["doc_ids"]],
             p_sort["sort_values"], p_sort["aggregations"]["s"]["value"],
             [dist.resolve(int(d)) for d in d_docs[0]], int(d_totals[0])]
clear_block_cache()
mesh.close()
try:
    make_mesh()
    mesh_refused = False
except RuntimeError:
    mesh_refused = True
try:
    DeviceReader(eng.acquire_searcher())
    refused = False
except RuntimeError:
    refused = mesh_refused
try:
    percolator.percolate(pmeta, {"body": "fox"})
    refused = False
except RuntimeError:
    pass
print(json.dumps({
    "ids": [match_ids, phrase_ids, fs_ids],
    "leaf_ids": leaf_ids, "geo_ids": geo_ids,
    "knn_ids": knn_ids,
    "impact_ids": impact_ids, "impact_admissions": impact_admissions,
    "agg_out": agg_out, "perc_out": perc_out,
    "script_ids": script_ids, "script_fields": script_fields,
    "script_aggs": script_aggs, "script_perc": script_perc,
    "nested": [nested_ids, nested_aggs, nested_perc],
    "plane": plane_out,
    "leaked": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib",
                                            "elasticsearch_tpu")),
    "no_card_refused": refused,
}))
"""


def test_port_serves_without_jax_or_the_jax_package(tmp_path):
    # hide any card, so "no device given" must mean a refusal here
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", SERVE_ONE_SEARCH], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["ids"] == [["2", "1", "0"], ["2", "1"], ["0", "1", "2"]]
    # a span_near, a span tree, a fuzzy term and a classic match
    assert got["leaf_ids"] == [["2"], ["2"], ["1", "2"], ["2", "1", "0"]]
    # a geo_distance and a geo_shape
    assert got["geo_ids"] == [["0", "1"], ["0", "1"]]
    assert got["knn_ids"] == [["1", "2", "0"], ["1", "2", "0"],
                              ["0", "1", "2"], ["1", "2", "0"]]
    assert got["impact_ids"] == [["2", "1", "0"], ["2", "1", "0"],
                                 ["0", "2"]]
    assert got["impact_admissions"] == 3
    assert got["agg_out"] == [3, [1, 1, 1], ["2", "1"]]
    assert got["perc_out"] == [["a", "b"], [["c"], ["a", "b"]], 2]
    assert got["script_ids"] == [["0", "2", "1"], ["0", "1", "2"],
                                 ["2", "0"]]
    assert got["script_fields"] == [{"e": [40.0], "g": ["big"]},
                                    {"e": [20.0], "g": [10.0]}]
    assert got["script_aggs"] == [120.0, 3, 1.386294]
    assert got["script_perc"] == ["s"]
    # a nested query (no leak across objects), a nested / reverse_nested
    # aggregation and a nested registration
    assert got["nested"] == [["1"], [3, [["a", 2], ["b", 1]], 2], ["n"]]
    # the collective plane over two shards, and DistributedBM25
    assert got["plane"] == [["3", "2", "0"], ["0", "2", "3"],
                            [[30], [10], [0]], 40.0, [[0, 0], [1, 0]], 2]
    assert got["leaked"] == []
    assert got["no_card_refused"]


def test_no_port_source_imports_jax_or_the_jax_package():
    """Every ``import`` line of the port and of chip_smoke.py names neither
    ``jax`` nor the top-level ``elasticsearch_tpu`` (``elasticsearch_tpu_torch``
    shares its prefix, so the match is on the exact top-level name)."""
    import ast
    files = sorted((REPO / "elasticsearch_tpu_torch").rglob("*.py"))
    assert {"mesh.py", "distributed.py", "mesh_engine.py"} <= {
        p.name for p in files if p.parent.name == "parallel"}
    files.append(REPO / "chip_smoke.py")
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib",
                                          "elasticsearch_tpu"):
                    bad.append(f"{path.relative_to(REPO)}: {name}")
    assert bad == []


def test_cuda_sources_have_a_plain_c_interface():
    """Every kernel source includes only CUDA's and the C library's
    headers: nothing of torch (the kernels bind through ctypes) and nothing
    of the JAX package."""
    import re
    sources = sorted((REPO / "elasticsearch_tpu_torch" / "csrc").glob("*.cu"))
    assert {p.name for p in sources} >= {"impact_scan.cu",
                                         "blockmax_sweep.cu",
                                         "agg_counts.cu", "agg_stats.cu",
                                         "script_eval.cu",
                                         "span_program.cu", "span_near.cu",
                                         "term_set_scan.cu", "geo_points.cu",
                                         "geo_shape.cu", "nested_reduce.cu",
                                         "sort_select.cu"}
    sources += sorted((REPO / "elasticsearch_tpu_torch" / "csrc").glob(
        "*.cuh"))
    bad = []
    for path in sources:
        text = path.read_text()
        for inc in re.findall(r'#include\s*[<"]([^>"]+)[>"]', text):
            if inc.split("/")[0] in ("torch", "ATen", "c10", "pybind11") or \
                    "elasticsearch_tpu" in inc or "jax" in inc:
                bad.append(f"{path.name}: {inc}")
        if path.suffix == ".cu" and not re.search(r'extern "C"', text):
            bad.append(f"{path.name}: no extern \"C\" entry point")
    assert bad == []
