"""Structured filters over doc-values columns, batched.

Counterpart of ``elasticsearch_tpu/ops/filters.py``: term/terms/range/exists
over keyword ordinals and numeric columns — Lucene's TermQuery/
TermRangeQuery/NumericRangeQuery over doc values — and the geo_point
filters. Keyword vocabularies are sorted at segment build, so ordinal
compares implement lexical ranges. Numeric columns are double-double
``(hi, lo)`` f32 pairs whose lexicographic compare is exact f64 order.

Query constants are [B] tensors (one value per query of the batch) and
results are [B, N] masks; a scalar constant gives an [N] mask, as in the
reference.

The geo filters (geo_distance, geo_bounding_box with any number of boxes
OR'd — the geohash_cell query's cell and neighbours —, geo_distance_range,
geo_polygon) and the decay's distance all go through
:func:`geo_point_filter`: on CPU tensors its plain version
(:func:`geo_point_filter_plain`, the reference's arithmetic with each
operation one tensor op, rounded alone in the reference's order), on CUDA
tensors kernel K17 (``csrc/geo_points.cu``, one thread a row), bit for bit
the plain version's.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from elasticsearch_tpu_torch.ops import cuda_build, per_query


def _any_value(ords, pred, q):
    """OR of ``pred`` over a multi-valued [N, K] ordinal column, one [B, N]
    compare per value slot (K is small), never a [B, N, K] intermediate."""
    hit = None
    for j in range(ords.shape[1]):
        h = pred(ords[:, j])
        hit = h if hit is None else (hit | h)
    if hit is None:
        return torch.zeros(torch.broadcast_shapes(q.shape, ords.shape[:1]),
                           dtype=torch.bool, device=ords.device)
    return hit


def keyword_term(ords, qord):
    """ords: [N, K] int32 (-1 pad); qord: [B] (or scalar) int32, -1 =
    absent → all False."""
    q = per_query(qord, ords.device)
    return _any_value(ords, lambda o: o == q, q) & (q >= 0)


def keyword_terms(ords, qords):
    """Any-of-set membership. qords: [B, M] (or [M]) int32, -1 pads."""
    qords = torch.as_tensor(qords, device=ords.device)
    hit = None
    for m in range(qords.shape[-1]):
        h = keyword_term(ords, qords[..., m])
        hit = h if hit is None else (hit | h)
    return hit


def keyword_ord_range(ords, lo, hi):
    """Ordinal interval [lo, hi) — backs keyword range and prefix queries.
    The host finds lo/hi by binary search over the sorted vocabulary."""
    lo_, hi_ = per_query(lo, ords.device), per_query(hi, ords.device)
    return _any_value(ords, lambda o: (o >= 0) & (o >= lo_) & (o < hi_), lo_)


def _dd_ge(hi, lo, qhi, qlo):
    """(hi, lo) double-double >= (qhi, qlo): exact f64 order in f32 ops."""
    return (hi > qhi) | ((hi == qhi) & (lo >= qlo))


def _dd_le(hi, lo, qhi, qlo):
    return (hi < qhi) | ((hi == qhi) & (lo <= qlo))


def _dd_gt(hi, lo, qhi, qlo):
    return (hi > qhi) | ((hi == qhi) & (lo > qlo))


def _dd_lt(hi, lo, qhi, qlo):
    return (hi < qhi) | ((hi == qhi) & (lo < qlo))


def numeric_range(hi, lo, exists, gte_hi, gte_lo, lte_hi, lte_lo,
                  lo_strict=None, hi_strict=None):
    """Exact numeric/date range over the double-double column. Open ends use
    ∓inf for (gte_hi, lte_hi) with 0 lo parts. Exclusive bounds pass
    lo_strict/hi_strict as 0/1 constants: strictness rides the comparison,
    not a nextafter-bumped bound, whose f64 neighbour of a small value
    underflows the f32 split back to the value itself."""
    dev = hi.device
    gh, gl, lh, ll = (per_query(x, dev)
                      for x in (gte_hi, gte_lo, lte_hi, lte_lo))
    ge = _dd_ge(hi, lo, gh, gl)
    if lo_strict is not None:
        ge = torch.where(per_query(lo_strict, dev) > 0,
                         _dd_gt(hi, lo, gh, gl), ge)
    le = _dd_le(hi, lo, lh, ll)
    if hi_strict is not None:
        le = torch.where(per_query(hi_strict, dev) > 0,
                         _dd_lt(hi, lo, lh, ll), le)
    return exists & ge & le


def numeric_term(hi, lo, exists, qhi, qlo):
    return exists & (hi == per_query(qhi, hi.device)) & \
        (lo == per_query(qlo, hi.device))


def field_exists(exists):
    return exists


def text_field_exists(doc_len):
    return doc_len > 0


# ---- geo_point filters: K17 -----------------------------------------------

GEO_POINT_FILTER = cuda_build.CudaKernel(
    "geo_point_filter", "geo_points.cu", "geo_points_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])

#: K17's modes and the per-query parameters of each
GEO_DISTANCE = 0         # qlat, qlon, radius (m)
GEO_DISTANCE_RANGE = 1   # qlat, qlon, gte, gt, lte, lt (m; < 0 = open)
GEO_BOXES = 2            # top, left, bottom, right, a box
GEO_POLYGON = 3          # a closed ring [E+1] (lats, lons)
GEO_DISTANCE_OUT = 4     # qlat, qlon → [B, N] f32 meters
_N_PARAMS = {GEO_DISTANCE: 3, GEO_DISTANCE_RANGE: 6, GEO_DISTANCE_OUT: 2,
             GEO_POLYGON: 0}

#: f32(pi / 180) — jnp.radians multiplies by the constant rounded to f32
_RAD = float(np.float32(np.pi / 180))
#: mean earth radius (m) doubled and rounded to f32: the reference's
#: ``2 * r * arcsin(..)`` is one multiply by that constant
_TWO_R = float(np.float32(2 * 6371008.8))


def haversine_m(lat, lon, qlat, qlon):
    """Meters between the points (``lat``, ``lon`` [N] f32) and each
    query's point (``qlat``, ``qlon`` [B, 1] f32) → [B, N] f32: the
    reference's haversine, each operation rounded alone in its order."""
    p1 = lat * _RAD
    p2 = qlat * _RAD
    dphi = (lat - qlat) * _RAD
    dlmb = (lon - qlon) * _RAD
    s1 = torch.sin(dphi * 0.5)
    s2 = torch.sin(dlmb * 0.5)
    a = s1 * s1 + torch.cos(p1) * torch.cos(p2) * (s2 * s2)
    return _TWO_R * torch.asin(torch.sqrt(a))


def geo_point_filter_plain(lat, lon, exists, mode: int, params,
                           ring_lats=None, ring_lons=None):
    """K17's plain version. ``params`` [B, P] f32 (the mode's parameters a
    query), ``ring_lats``/``ring_lons`` [B, E+1] f32 closed rings (polygon
    mode) → [B, N] bool (f32 meters for GEO_DISTANCE_OUT)."""
    col = lambda j: params[:, j:j + 1]              # noqa: E731
    if mode in (GEO_DISTANCE, GEO_DISTANCE_RANGE, GEO_DISTANCE_OUT):
        d = haversine_m(lat, lon, col(0), col(1))
        if mode == GEO_DISTANCE_OUT:
            return d
        if mode == GEO_DISTANCE:
            return exists & (d <= col(2))
        gte, gt, lte, lt = col(2), col(3), col(4), col(5)
        return exists & ((gte < 0) | (d >= gte)) & ((gt < 0) | (d > gt)) & \
            ((lte < 0) | (d <= lte)) & ((lt < 0) | (d < lt))
    if mode == GEO_BOXES:
        out = None
        for k in range(0, params.shape[1], 4):
            top, left, bottom, right = col(k), col(k + 1), col(k + 2), \
                col(k + 3)
            in_lat = (lat <= top) & (lat >= bottom)
            # left > right: the box crosses the dateline
            in_lon = torch.where(left <= right, (lon >= left) & (lon <= right),
                                 (lon >= left) | (lon <= right))
            m = in_lat & in_lon
            out = m if out is None else out | m
        return exists & out
    if mode == GEO_POLYGON:
        from elasticsearch_tpu_torch.ops.geoshape import (
            _points_in_query_shape)
        e1 = ring_lats.shape[1]
        return exists & _points_in_query_shape(
            lat, lon, ring_lats, ring_lons, [0] * e1, [True] * e1)
    raise ValueError(f"unknown geo_point_filter mode [{mode}]")


def geo_point_filter(lat, lon, exists, mode: int, params, ring_lats=None,
                     ring_lons=None):
    """The batch's geo_point test over one geo column → [B, N] bool (f32
    meters for GEO_DISTANCE_OUT). CPU tensors run
    :func:`geo_point_filter_plain`; CUDA tensors launch K17 once."""
    dev = lat.device
    params = torch.as_tensor(params, dtype=torch.float32, device=dev)
    if dev.type == "cpu":
        return geo_point_filter_plain(lat, lon, exists, mode, params,
                                      ring_lats, ring_lons)
    return _geo_point_filter_cuda(lat, lon, exists, mode, params, ring_lats,
                                  ring_lons, dev)


def _geo_point_filter_cuda(lat, lon, exists, mode, params, ring_lats,
                           ring_lons, dev):
    name = "geo_point_filter"
    cuda_build.check_dtype(name, "lat", lat, torch.float32)
    cuda_build.check_dtype(name, "lon", lon, torch.float32)
    cuda_build.check_dtype(name, "exists", exists, torch.bool)
    n = lat.shape[0]
    if params.dim() != 2 or lat.shape != (n,) or lon.shape != (n,) or \
            exists.shape != (n,):
        raise ValueError(f"{name}: shapes disagree: lat {tuple(lat.shape)}, "
                         f"lon {tuple(lon.shape)}, exists "
                         f"{tuple(exists.shape)}, params "
                         f"{tuple(params.shape)}")
    b, n_params = params.shape
    want = _N_PARAMS.get(mode)
    if mode == GEO_BOXES:
        ok = n_params >= 4 and n_params % 4 == 0
    else:
        ok = want is not None and n_params == want
    if not ok:
        raise ValueError(f"{name}: mode {mode} takes "
                         f"{'4 a box' if mode == GEO_BOXES else want} "
                         f"parameters, got {n_params}")
    ring_len = 0
    if mode == GEO_POLYGON:
        cuda_build.check_dtype(name, "ring_lats", ring_lats, torch.float32)
        cuda_build.check_dtype(name, "ring_lons", ring_lons, torch.float32)
        ring_lats, ring_lons = ring_lats.contiguous(), ring_lons.contiguous()
        b, ring_len = ring_lats.shape
        if ring_lons.shape != (b, ring_len) or ring_len < 2:
            raise ValueError(f"{name}: rings {tuple(ring_lats.shape)} / "
                             f"{tuple(ring_lons.shape)}")
    else:
        ring_lats = ring_lons = None
    params = params.contiguous()
    cuda_build.check_cuda(name, dev, lat=lat, lon=lon, exists=exists,
                          params=params, ring_lats=ring_lats,
                          ring_lons=ring_lons)
    out = torch.empty((b, n), device=dev, dtype=torch.float32
                      if mode == GEO_DISTANCE_OUT else torch.bool)
    if b == 0 or n == 0:
        return out
    GEO_POINT_FILTER.launch(
        dev, lat.data_ptr(), lon.data_ptr(), exists.data_ptr(), n, mode, b,
        params.data_ptr() if n_params else None, n_params,
        cuda_build.ptr(ring_lats), cuda_build.ptr(ring_lons), ring_len,
        out.data_ptr())
    return out


def _batched(lat, *values):
    """Per-query constants (each [B] or a scalar) → ([B, P] f32 params,
    True when every one was a scalar: the caller then returns [N])."""
    ts = [torch.as_tensor(v, dtype=torch.float32, device=lat.device)
          for v in values]
    single = all(t.dim() == 0 for t in ts)
    b = max((t.shape[0] for t in ts if t.dim()), default=1)
    return torch.stack([t.expand(b) for t in ts], dim=1), single


def _unbatch(out, single: bool):
    return out[0] if single else out


def geo_distance(lat, lon, exists, qlat, qlon, radius_m):
    """Haversine distance filter (reference: GeoDistanceQueryParser)."""
    params, single = _batched(lat, qlat, qlon, radius_m)
    return _unbatch(geo_point_filter(lat, lon, exists, GEO_DISTANCE, params),
                    single)


def geo_distance_m(lat, lon, exists, qlat, qlon):
    """[B, N] f32 meters from each query's point, for every row whatever
    ``exists`` says (the geo decay's distance): K17's distance mode."""
    params, single = _batched(lat, qlat, qlon)
    return _unbatch(geo_point_filter(lat, lon, exists, GEO_DISTANCE_OUT,
                                     params), single)


def geo_bounding_box(lat, lon, exists, top, left, bottom, right):
    """lat in [bottom, top], lon in [left, right] — or, when left > right,
    the box crossing the dateline."""
    params, single = _batched(lat, top, left, bottom, right)
    return _unbatch(geo_point_filter(lat, lon, exists, GEO_BOXES, params),
                    single)


def geo_boxes(lat, lon, exists, boxes):
    """OR over boxes: ``boxes`` [B, nb, 4] (top, left, bottom, right) → [B,
    N] — the geohash_cell query's cell and its neighbours."""
    boxes = torch.as_tensor(boxes, dtype=torch.float32, device=lat.device)
    return geo_point_filter(lat, lon, exists, GEO_BOXES,
                            boxes.reshape(boxes.shape[0], -1))


def geo_distance_range(lat, lon, exists, qlat, qlon,
                       gte_m, gt_m, lte_m, lt_m):
    """Annulus filter (reference: GeoDistanceRangeQueryParser): bound
    values < 0 mean "unbounded on this side" (the host encodes None so)."""
    params, single = _batched(lat, qlat, qlon, gte_m, gt_m, lte_m, lt_m)
    return _unbatch(geo_point_filter(lat, lon, exists, GEO_DISTANCE_RANGE,
                                     params), single)


def geo_polygon(lat, lon, exists, vlats, vlons):
    """Even-odd ray-casting point-in-polygon (reference:
    GeoPolygonQueryParser → GeoPolygonQuery). ``vlats``/``vlons``: [B, V]
    (or [V]) f32 vertex rings, closed here by their first vertex."""
    vlats = torch.as_tensor(vlats, dtype=torch.float32, device=lat.device)
    vlons = torch.as_tensor(vlons, dtype=torch.float32, device=lat.device)
    single = vlats.dim() == 1
    if single:
        vlats, vlons = vlats[None, :], vlons[None, :]
    rl = torch.cat([vlats, vlats[:, :1]], dim=1)
    ro = torch.cat([vlons, vlons[:, :1]], dim=1)
    empty = torch.zeros((rl.shape[0], 0), dtype=torch.float32,
                        device=lat.device)
    return _unbatch(geo_point_filter(lat, lon, exists, GEO_POLYGON, empty,
                                     rl, ro), single)
