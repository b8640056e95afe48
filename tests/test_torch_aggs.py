"""Aggregations through the port against the JAX package, on the CPU.

* The eleven bodies of ``ops/aggs_ops.py`` and the plain versions of the
  kernels K8 (bucket counts) and K9 (masked double-double stats) against
  the JAX bodies on the same seeded numpy inputs: odd shapes, an empty
  mask, values on double-double edges, -0.0 and NaN.
* One shard: the same documents indexed into both packages' Engine, one
  request carrying every aggregation the device path serves (the JAX
  package's ``tests/test_device_aggs.py`` ELIGIBLE_AGGS) and host-only ones
  (filter, filters, global, missing, cardinality, percentiles, a terms agg
  with an avg sub-aggregation, the avg_bucket and derivative pipelines)
  through each package's ``ShardSearcher.query_phase``; the shard partials
  must be equal and the eligible nodes must take the device path.
* What the slice refuses, and every batched arm declining a request that
  carries aggregations.

Tolerances. Counts, buckets, keys and extrema are exact: they are integer
or order results. Sums (sum, sum of squares) are f32 in both packages but
added in another order (XLA's reduction against torch's), so they agree to
rtol 1e-5, the bar the JAX package holds its own device path to against its
numpy collectors; a float derived from them by a difference (variance,
standard deviation) is held to rtol 1e-4.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.device_reader import (
    device_reader_for as jax_device_reader_for)
from elasticsearch_tpu.index.engine import Engine as JaxEngine
from elasticsearch_tpu.mapping import MapperService as JaxMapperService
from elasticsearch_tpu.ops import aggs_ops as jax_aggs_ops
from elasticsearch_tpu.ops import filters as jax_filters
from elasticsearch_tpu.search.phase import (
    ShardSearcher as JaxShardSearcher,
    parse_search_request as jax_parse_search_request)
from elasticsearch_tpu_torch.common.errors import NotPortedError
from elasticsearch_tpu_torch.index.device_reader import device_reader_for
from elasticsearch_tpu_torch.index.engine import Engine
from elasticsearch_tpu_torch.mapping import MapperService
from elasticsearch_tpu_torch.ops import aggs_ops
from elasticsearch_tpu_torch.search import aggregations, segment_exec
from elasticsearch_tpu_torch.search.phase import (
    ShardSearcher, parse_search_request)

SUM_RTOL = 1e-5
DERIVED_RTOL = 1e-4
#: partial / response keys whose floats are sums or derived from sums
SUMS = {"sum", "sum_sq", "avg", "sum_of_squares"}
DERIVED = {"variance", "std_deviation"}


def assert_same(got, want, path="", rtol=0.0):
    """Recursive equality; floats exact unless under a sum-like key."""
    assert type(got) is type(want), (path, got, want)
    if isinstance(got, dict):
        assert set(got) == set(want), (path, got, want)
        for key in got:
            tol = SUM_RTOL if key in SUMS else DERIVED_RTOL \
                if key in DERIVED else rtol
            assert_same(got[key], want[key], f"{path}.{key}", tol)
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want), (path, got, want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{path}[{i}]", rtol)
    elif isinstance(got, float):
        if rtol:
            assert got == pytest.approx(want, rel=rtol, abs=1e-9), \
                (path, got, want)
        else:
            assert got == want or (math.isnan(got) and math.isnan(want)), \
                (path, got, want)
    else:
        assert got == want, (path, got, want)


# ---------------------------------------------------------------------------
# the bodies
# ---------------------------------------------------------------------------

def _dd(values: np.ndarray):
    """The double-double split of the JAX package's device_reader.dd_split
    (lo 0 for ±inf)."""
    hi = values.astype(np.float32)
    with np.errstate(invalid="ignore"):
        lo = np.where(np.isfinite(values),
                      (values - hi.astype(np.float64)).astype(np.float32),
                      0.0)
    return hi, lo.astype(np.float32)


def _inputs(case: str):
    """Seeded numpy inputs: N off every power of two, K = 2 ordinal slots,
    epoch-millis values a third of them on 1h bucket edges; "empty": no row
    in context."""
    rng = np.random.default_rng(len(case))
    n, k, num_ords = 1003, 2, 37
    ords = rng.integers(-1, num_ords, (n, k)).astype(np.int32)
    values = 1.5e12 + rng.integers(0, 40, n) * 3_600_000.0 + \
        np.where(rng.random(n) < 0.3, 0.0, rng.integers(1, 3_600_000, n))
    exists = rng.random(n) < 0.9
    mask = rng.random(n) < 0.7
    if case == "empty":
        mask[:] = False
    small = rng.normal(0.0, 50.0, n)
    return ords, values, exists, mask, num_ords, small


def _both(fn_name, case):
    """(port result, JAX result) of one body on the case's inputs."""
    ords, values, exists, mask, num_ords, small = _inputs(case)
    hi, lo = _dd(values)
    base = float(np.floor(values[exists].min() / 3_600_000.0) * 3_600_000.0)
    bhi, blo = _dd(np.array([base]))
    t = torch.from_numpy
    j = jnp.asarray
    sm32 = small.astype(np.float32)
    lows = np.array([-np.inf, -10.0, 0.0, 25.0], np.float32)
    highs = np.array([0.0, 10.0, 25.0, np.inf], np.float32)
    calls = {
        "ord_value_counts": ((ords, mask, num_ords), {}),
        "ord_metric_sums": ((ords, mask, sm32, num_ords), {}),
        "histogram_counts": ((sm32, exists, mask, -200.0, 7.5, 60), {}),
        "histogram_counts_dd": ((hi, lo, exists, mask, float(bhi[0]),
                                 float(blo[0]), 3_600_000.0, 41), {}),
        "range_counts": ((sm32, exists, mask, lows, highs), {}),
        "dd_min_max": ((hi, lo, exists, mask), {}),
        "stats_metrics": ((sm32, exists, mask), {}),
        "sum_of_squares": ((sm32, exists, mask), {}),
        "value_count": ((exists, mask), {}),
        "cardinality_ords": ((ords, mask, num_ords), {}),
        "masked_sort_values": ((sm32, exists, mask), {}),
    }
    args, kw = calls[fn_name]
    conv = [(t(a), j(a)) if isinstance(a, np.ndarray) else (a, a)
            for a in args]
    got = getattr(aggs_ops, fn_name)(*[c[0] for c in conv], **kw)
    want = getattr(jax_aggs_ops, fn_name)(*[c[1] for c in conv], **kw)
    return got, want


BODIES = ["ord_value_counts", "ord_metric_sums", "histogram_counts",
          "histogram_counts_dd", "range_counts", "dd_min_max",
          "stats_metrics", "sum_of_squares", "value_count",
          "cardinality_ords", "masked_sort_values"]


#: (body, output index) of the outputs that are f32 sums
SUM_OUTPUTS = {("ord_metric_sums", 0), ("stats_metrics", 1),
               ("sum_of_squares", 0)}


@pytest.mark.parametrize("case", ["odd", "empty"])
@pytest.mark.parametrize("name", BODIES)
def test_body_matches_jax(name, case):
    got, want = _both(name, case)
    got = [g.numpy() for g in (got if isinstance(got, tuple) else (got,))]
    want = [np.asarray(w) for w in (want if isinstance(want, tuple)
                                    else (want,))]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (i, g, w)
        if (name, i) in SUM_OUTPUTS:
            np.testing.assert_allclose(g, w, rtol=SUM_RTOL)
        else:
            np.testing.assert_array_equal(g, w)


def _jax_stats_row(hi, lo, exists, mask):
    """The JAX package's per-segment metric reductions (_d_count_minmax and
    _d_metric's sums) as K9's row."""
    m = jnp.asarray(exists & mask)
    cnt, mn_hi, mn_lo, mx_hi, mx_lo = jax_aggs_ops.dd_min_max(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(exists),
        jnp.asarray(mask))
    s_hi = jnp.where(m, jnp.asarray(hi), 0.0).sum()
    s_lo = jnp.where(m, jnp.asarray(lo), 0.0).sum()
    ssq = jax_aggs_ops.sum_of_squares(jnp.asarray(hi), jnp.asarray(exists),
                                      jnp.asarray(mask))
    return np.array([float(v) for v in (cnt, mn_hi, mn_lo, mx_hi, mx_lo,
                                        s_hi, s_lo, ssq)])


def _check_stats_row(got, want):
    assert got.dtype == torch.float64 and got.shape == (8,)
    got = got.numpy()
    np.testing.assert_array_equal(got[:5], want[:5])    # count, extrema
    np.testing.assert_allclose(got[5:], want[5:], rtol=SUM_RTOL)


@pytest.mark.parametrize("case", ["odd", "empty"])
def test_k9_plain_matches_jax_metric_reductions(case):
    _, values, exists, mask, _, _ = _inputs(case)
    hi, lo = _dd(values)
    t = torch.from_numpy
    got = aggs_ops.dd_stats(t(hi), t(lo), t(exists), t(mask))
    _check_stats_row(got, _jax_stats_row(hi, lo, exists, mask))
    count = aggs_ops.dd_stats(None, None, t(exists), t(mask))
    assert count[0] == int(jax_aggs_ops.value_count(jnp.asarray(exists),
                                                    jnp.asarray(mask)))


def test_k9_plain_orders_signed_zeros_and_nan_as_jax():
    """-0.0 ties +0.0 (the extremum comes back as +0.0, the value the host
    rebuilds either way); a NaN makes both extrema NaN with their lo parts
    +inf / -inf, as jnp.min / jnp.max propagate it."""
    hi = np.array([0.0, -0.0, 3.5, -0.0, 0.0, 2.0], np.float32)
    lo = np.zeros(6, np.float32)
    lo[[1, 4]] = [1e-9, -1e-9]
    exists = np.ones(6, bool)
    mask = np.array([1, 1, 1, 1, 1, 0], bool)
    t = torch.from_numpy
    got = aggs_ops.dd_stats(t(hi), t(lo), t(exists), t(mask))
    want = _jax_stats_row(hi, lo, exists, mask)
    _check_stats_row(got, want)
    assert math.copysign(1.0, got[1]) == 1.0 and got[2] == np.float32(-1e-9)
    hi[2] = np.nan
    got = aggs_ops.dd_stats(t(hi), t(lo), t(exists), t(mask)).numpy()
    want = _jax_stats_row(hi, lo, exists, mask)
    assert np.isnan(got[1]) and np.isnan(got[3]) and np.isnan(want[1])
    assert (got[2], got[4]) == (want[2], want[4]) == (np.inf, -np.inf)


def _jax_range_counts(hi, lo, exists, mask, bounds):
    """_d_range's reference arithmetic: one numeric_range + sum a range."""
    out = []
    for frm, to in bounds:
        ghi, glo = _dd(np.array([frm]))
        lhi, llo = _dd(np.array([to]))
        m = jax_filters.numeric_range(
            jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(exists),
            jnp.float32(ghi[0]), jnp.float32(glo[0]), jnp.float32(lhi[0]),
            jnp.float32(llo[0]),
            hi_strict=jnp.float32(0.0 if to == np.inf else 1.0))
        out.append(int((m & jnp.asarray(mask)).sum()))
    return out


@pytest.mark.parametrize("case", ["odd", "empty"])
def test_k8_plain_matches_jax(case):
    """The three modes of K8's plain versions against the JAX bodies, with
    overlapping ranges, a `to: 0` range and an upper bound on a value."""
    ords, values, exists, mask, num_ords, small = _inputs(case)
    t = torch.from_numpy
    np.testing.assert_array_equal(
        aggs_ops.ord_counts(t(ords), t(mask), num_ords).numpy(),
        np.asarray(jax_aggs_ops.ord_value_counts(
            jnp.asarray(ords), jnp.asarray(mask), num_ords)))
    hi, lo = _dd(values)
    base = float(np.floor(values[exists].min() / 3_600_000.0) * 3_600_000.0)
    bhi, blo = _dd(np.array([base]))
    np.testing.assert_array_equal(
        aggs_ops.dd_histogram_counts(
            t(hi), t(lo), t(exists), t(mask), float(bhi[0]), float(blo[0]),
            3_600_000.0, 41).numpy(),
        np.asarray(jax_aggs_ops.histogram_counts_dd(
            jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(exists),
            jnp.asarray(mask), float(bhi[0]), float(blo[0]), 3_600_000.0,
            41)))
    shi, slo = _dd(small)
    bounds = [(-np.inf, 0.0), (-10.0, 10.0), (float(small[7]), np.inf),
              (0.0, float(small[3])), (-np.inf, np.inf)]
    dd, strict = aggs_ops.range_bounds_dd(bounds)
    got = aggs_ops.dd_range_counts(t(shi), t(slo), t(exists), t(mask),
                                   t(dd), t(strict))
    assert got.dtype == torch.int32
    assert got.tolist() == _jax_range_counts(shi, slo, exists, mask, bounds)


# ---------------------------------------------------------------------------
# one shard through both packages
# ---------------------------------------------------------------------------

MAPPING = {"properties": {"t": {"type": "text", "analyzer": "whitespace"},
                          "tag": {"type": "keyword"},
                          "price": {"type": "long"},
                          "when": {"type": "date"}}}

ELIGIBLE_AGGS = {
    "mx": {"max": {"field": "price"}},
    "mn": {"min": {"field": "price"}},
    "sm": {"sum": {"field": "price"}},
    "av": {"avg": {"field": "price"}},
    "st": {"stats": {"field": "price"}},
    "xs": {"extended_stats": {"field": "price"}},
    "vc": {"value_count": {"field": "tag"}},
    "vn": {"value_count": {"field": "price"}},
    "tg": {"terms": {"field": "tag", "size": 10}},
    "hi": {"histogram": {"field": "price", "interval": 100}},
    "rg": {"range": {"field": "price",
                     "ranges": [{"to": 0}, {"to": 100},
                                {"from": 100, "to": 300}, {"from": 300}]}},
    "dh": {"date_histogram": {"field": "when", "interval": "1h"}},
    "dr": {"date_range": {"field": "when", "ranges": [
        {"to": 1_500_003_600_000}, {"from": 1_500_003_600_000}]}},
}

HOST_AGGS = {
    "fl": {"filter": {"term": {"tag": "g1"}}},
    "fs": {"filters": {"filters": {"a": {"match": {"t": "word1"}},
                                   "b": {"range": {"price": {"gte": 250}}}}}},
    "gl": {"global": {}},
    "ms": {"missing": {"field": "price"}},
    "cd": {"cardinality": {"field": "tag"}},
    "pc": {"percentiles": {"field": "price", "percents": [5, 50, 99]}},
    "ts": {"terms": {"field": "tag"}, "aggs": {"p": {"avg": {
        "field": "price"}}}},
    "hd": {"histogram": {"field": "price", "interval": 50},
           "aggs": {"d": {"derivative": {"buckets_path": "_count"}}}},
    "ab": {"avg_bucket": {"buckets_path": "tg>_count"}},
}


def _agg_docs(n=160):
    rng = np.random.default_rng(5)
    docs = []
    for i in range(n):
        d = {"t": f"alpha word{i % 7}" + (" beta" if i % 3 == 0 else "")}
        if i % 9:
            d["tag"] = f"g{int(rng.integers(0, 6))}"
        if i % 11:
            d["price"] = int(rng.integers(-20, 500))
        # a third of the dates on an hour's edge
        d["when"] = 1_500_000_000_000 + int(rng.integers(0, 6)) * 3_600_000 \
            + (0 if i % 3 == 0 else int(rng.integers(1, 3_600_000)))
        docs.append(d)
    return docs


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    """(jax searcher, port searcher) over the same docs: two segments and a
    delete."""
    tmp = tmp_path_factory.mktemp("aggs")
    jms, ms = JaxMapperService(), MapperService()
    jms.merge("_doc", MAPPING)
    ms.merge("_doc", MAPPING)
    jeng = JaxEngine(tmp / "jax", jms)
    eng = Engine(tmp / "torch", ms)
    docs = _agg_docs()
    for e in (jeng, eng):
        for i, d in enumerate(docs):
            e.index(str(i), d)
            if i == len(docs) // 2:
                e.refresh()
        e.refresh()
        e.delete("4")
        e.refresh()
    return (JaxShardSearcher(0, jax_device_reader_for(jeng), jms),
            ShardSearcher(0, device_reader_for(eng, device="cpu"), ms))


def _partials(shard, body):
    js, ps = shard
    want = js.query_phase(jax_parse_search_request(body))
    before = dict(aggregations.DEVICE_AGG_STATS)
    got = ps.query_phase(parse_search_request(body))
    after = aggregations.DEVICE_AGG_STATS
    delta = {k: after[k] - before[k] for k in ("device_collects",
                                               "host_fallbacks")}
    return got, want, delta


@pytest.fixture(scope="module")
def all_aggs(shard):
    body = {"query": {"match": {"t": "alpha"}}, "size": 5,
            "aggs": {**ELIGIBLE_AGGS, **HOST_AGGS}}
    return _partials(shard, body)


@pytest.mark.parametrize("name", sorted({**ELIGIBLE_AGGS, **HOST_AGGS}))
def test_shard_partial_matches_jax(all_aggs, name):
    got, want, _ = all_aggs
    if name in ("ab",):           # pipelines have no shard partial
        assert name not in got.agg_partials and name not in want.agg_partials
        return
    assert_same(got.agg_partials[name], want.agg_partials[name], name)


def test_eligible_aggs_take_the_device_path(all_aggs):
    """Every eligible node is served by collect_device; the host-only nodes
    (all but the sibling pipeline) by the numpy collectors."""
    got, want, delta = all_aggs
    assert delta == {"device_collects": len(ELIGIBLE_AGGS),
                     "host_fallbacks": len(HOST_AGGS) - 1}
    assert got.total == want.total
    np.testing.assert_array_equal(got.doc_ids, want.doc_ids)


def test_device_path_copies_no_full_column(shard, monkeypatch):
    """An eligible-only request never materializes the host mask, and every
    tensor the shard copies to the host is bucket-, scalar- or page-sized,
    never a column."""
    made = []
    orig = aggregations.DeviceAggState.np_mask

    def np_mask(self):
        made.append(1)
        return orig(self)
    monkeypatch.setattr(aggregations.DeviceAggState, "np_mask", np_mask)
    copied = []
    orig_cpu = torch.Tensor.cpu

    def cpu(t, *a, **kw):
        copied.append(t.numel())
        return orig_cpu(t, *a, **kw)
    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    body = {"query": {"match": {"t": "alpha"}}, "size": 3,
            "aggs": ELIGIBLE_AGGS}
    _, ps = shard
    ps.query_phase(parse_search_request(body))
    assert made == []
    # at least one copy a node; none as large as a segment's column
    assert len(copied) >= len(ELIGIBLE_AGGS)
    smallest = min(seg.padded_docs for seg in ps.reader.segments)
    assert max(copied) < smallest


@pytest.mark.parametrize("extra", [
    {"post_filter": {"term": {"tag": "g2"}}},
    {"min_score": 1.0},
    {"query": {"match_all": {}}, "size": 0},
])
def test_aggs_see_min_score_but_not_post_filter(shard, extra):
    """Aggregations run on the mask after min_score and before post_filter,
    as in ES; the hits see both."""
    body = {"query": {"match": {"t": "beta word2"}}, "size": 50,
            "aggs": {"tg": ELIGIBLE_AGGS["tg"], "st": ELIGIBLE_AGGS["st"],
                     "ms": HOST_AGGS["ms"]}, **extra}
    got, want, _ = _partials(shard, body)
    assert got.total == want.total
    np.testing.assert_array_equal(got.doc_ids, want.doc_ids)
    assert_same(got.agg_partials, want.agg_partials)


def test_top_hits_and_significant_terms_match_jax(shard):
    body = {"query": {"match": {"t": "beta"}}, "size": 2, "aggs": {
        "th": {"top_hits": {"size": 3}},
        "sg": {"significant_terms": {"field": "tag", "min_doc_count": 1}},
        "sp": {"sampler": {"shard_size": 5},
               "aggs": {"m": {"max": {"field": "price"}}}},
        "pr": {"percentile_ranks": {"field": "price", "values": [100, 250]}},
        "cl": {"date_histogram": {"field": "when", "interval": "month"}}}}
    got, want, _ = _partials(shard, body)
    th_g, th_w = got.agg_partials.pop("th"), want.agg_partials.pop("th")
    assert [h["_id"] for h in th_g["hits"]] == \
        [h["_id"] for h in th_w["hits"]]
    assert th_g["total"] == th_w["total"]
    np.testing.assert_allclose([h["_score"] for h in th_g["hits"]],
                               [h["_score"] for h in th_w["hits"]],
                               rtol=2.4e-7)
    assert_same(got.agg_partials, want.agg_partials)


@pytest.mark.parametrize("spec", [
    {"term": {"tag": "g3"}},
    {"range": {"price": {"gte": 10, "lt": 240}}},
    {"bool": {"must": [{"match": {"t": "alpha"}}],
              "must_not": [{"term": {"tag": "g1"}}]}},
])
def test_filter_mask_matches_jax(shard, spec):
    """The filter / filters / missing collectors' mask: the live rows the
    query matches over the whole reader, equal to the JAX package's."""
    js, ps = shard
    from elasticsearch_tpu.search.query_dsl import parse_query as jax_parse
    from elasticsearch_tpu_torch.search.query_dsl import parse_query
    got = ps._filter_masks_np(parse_query(spec))
    want = np.asarray(js._filter_masks_np(jax_parse(spec)))
    assert got.dtype == bool and got.shape == (ps.reader.max_doc,)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size
    seg0 = ps.reader.segments[0]
    np.testing.assert_array_equal(
        got[:seg0.padded_docs],
        segment_exec.match_mask(seg0, ps.ctx, parse_query(spec)).numpy())


# ---------------------------------------------------------------------------
# refusals and declines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    {"scripted_metric": {"map_script": "_agg.x = 1"}},
    {"geohash_grid": {"field": "loc"}},
    {"geo_distance": {"field": "loc", "origin": "0,0", "ranges": []}},
    {"geo_bounds": {"field": "loc"}},
    {"geo_centroid": {"field": "loc"}},
    {"nested": {"path": "n"}},
    {"reverse_nested": {}},
    {"children": {"type": "c"}},
    {"top_hits": {"highlight": {"fields": {"t": {}}}}},
    {"terms": {"field": "tag"}, "aggs": {"s": {"bucket_script": {
        "buckets_path": {"c": "_count"}, "script": "c"}}}},
    {"terms": {"field": "tag"}, "aggs": {"s": {"bucket_selector": {
        "buckets_path": {"c": "_count"}, "script": "c > 1"}}}},
])
def test_refused_aggregation_is_not_ported(spec):
    with pytest.raises(NotPortedError):
        parse_search_request({"query": {"match_all": {}}, "aggs": {"a": spec}})


def test_suggest_stays_refused():
    with pytest.raises(NotPortedError):
        parse_search_request({"suggest": {"s": {"text": "x", "term": {
            "field": "t"}}}})


def _agg_req(body, **extra):
    return parse_search_request({**body, "aggs": {"tg": {"terms": {
        "field": "tag"}}}, **extra})


def test_exact_arm_declines_aggs(shard):
    _, ps = shard
    req = _agg_req({"query": {"match": {"t": "alpha"}}})
    assert ps._exact_batch_launch([req]) is None
    assert ps.query_phase_batch([req]) is None
    # served one at a time instead, with its partials
    assert "tg" in ps.query_phase(req).agg_partials


def test_impact_and_rescore_arms_decline_aggs(shard):
    _, ps = shard
    name = "aggs_impact_idx"
    segment_exec.configure_impact_plane(name, {
        "index.search.impact_plane": True})
    searcher = ShardSearcher(0, ps.reader, ps.mapper_service,
                             index_name=name)
    before = dict(segment_exec.impact_fallback_reasons())
    req = _agg_req({"query": {"match": {"t": "alpha"}}})
    assert searcher._impact_batch_launch([req]) is None
    after = segment_exec.impact_fallback_reasons()
    assert after.get("ineligible-shape", 0) == \
        before.get("ineligible-shape", 0) + 1
    rreq = _agg_req({"query": {"match": {"t": "alpha"}}, "rescore": {
        "window_size": 5, "query": {"rescore_query": {
            "match": {"t": "beta"}}}}})
    assert searcher._rescore_batch_launch([rreq]) is None
    # without aggs the same rescore request is the lane's
    plain = parse_search_request({"query": {"match": {"t": "alpha"}},
                                  "rescore": {"window_size": 5, "query": {
                                      "rescore_query": {"match": {
                                          "t": "beta"}}}}})
    assert searcher._rescore_batch_launch([plain]) is not None


def test_knn_arm_declines_aggs(shard):
    """The parse refuses knn + aggs (a 400, as in the JAX package); a
    request built past the parse is declined by the knn arm too."""
    _, ps = shard
    from elasticsearch_tpu_torch.search import query_dsl as q
    req = parse_search_request({"query": {"match_all": {}}})
    req.knn = q.KnnSection(field="v", query_vector=[0.1, 0.2], k=3,
                           num_candidates=5)
    req.aggs = aggregations.parse_aggs({"tg": {"terms": {"field": "tag"}}})
    ps._validate_knn = lambda knn: None
    assert ps._knn_batch_launch([req]) is None
