"""The port stands alone: serving searches through it (a match, a bool with a
match_phrase, a function_score, on the knn lane a dense knn in f32 and int8,
a hybrid and a rank_vectors MaxSim, on the impact lane the eager, pruned
and rescore arms, aggregations reduced by the coordinator's merge, and the
percolator's registry, _mpercolate and serial paths) loads neither JAX nor
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
    "vec": {"type": "dense_vector", "dims": 3},
    "tok": {"type": "rank_vectors", "dims": 2}}})
eng = Engine(Path(tempfile.mkdtemp()), ms)
vecs = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.6, 0.8, 0.0]]
toks = [[[1.0, 0.0]], [[0.0, 1.0], [0.1, 0.9]], [[0.7, 0.7]]]
for i, text in enumerate(["quick brown fox", "lazy dog", "quick dog"]):
    eng.index(str(i), {"body": text, "rank": 10.0 * (3 - i),
                       "vec": vecs[i], "tok": toks[i]})
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
try:
    DeviceReader(eng.acquire_searcher())
    refused = False
except RuntimeError:
    refused = True
try:
    percolator.percolate(pmeta, {"body": "fox"})
    refused = False
except RuntimeError:
    pass
print(json.dumps({
    "ids": [match_ids, phrase_ids, fs_ids],
    "knn_ids": knn_ids,
    "impact_ids": impact_ids, "impact_admissions": impact_admissions,
    "agg_out": agg_out, "perc_out": perc_out,
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
    assert got["knn_ids"] == [["1", "2", "0"], ["1", "2", "0"],
                              ["0", "1", "2"], ["1", "2", "0"]]
    assert got["impact_ids"] == [["2", "1", "0"], ["2", "1", "0"],
                                 ["0", "2"]]
    assert got["impact_admissions"] == 3
    assert got["agg_out"] == [3, [1, 1, 1], ["2", "1"]]
    assert got["perc_out"] == [["a", "b"], [["c"], ["a", "b"]], 2]
    assert got["leaked"] == []
    assert got["no_card_refused"]


def test_no_port_source_imports_jax_or_the_jax_package():
    """Every ``import`` line of the port and of chip_smoke.py names neither
    ``jax`` nor the top-level ``elasticsearch_tpu`` (``elasticsearch_tpu_torch``
    shares its prefix, so the match is on the exact top-level name)."""
    import ast
    files = sorted((REPO / "elasticsearch_tpu_torch").rglob("*.py"))
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
                                         "agg_counts.cu", "agg_stats.cu"}
    bad = []
    for path in sources:
        text = path.read_text()
        for inc in re.findall(r'#include\s*[<"]([^>"]+)[>"]', text):
            if inc.split("/")[0] in ("torch", "ATen", "c10", "pybind11") or \
                    "elasticsearch_tpu" in inc or "jax" in inc:
                bad.append(f"{path.name}: {inc}")
        if not re.search(r'extern "C"', text):
            bad.append(f"{path.name}: no extern \"C\" entry point")
    assert bad == []
