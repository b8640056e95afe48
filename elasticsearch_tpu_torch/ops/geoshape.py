"""geo_shape relations over vertex-ring columns, batched.

Counterpart of ``elasticsearch_tpu/ops/geoshape.py`` (ref: core/index/query/
GeoShapeQueryParser.java; the reference indexes shapes into a geohash prefix
tree and runs Lucene spatial queries — here shapes are doc-value MULTI-RING
vertex soups and the four relations are exact dense tests).

Doc shapes: ``lats``/``lons`` [N, V] f32 concatenated rings, ``rid`` [N, V]
i32 ring ids (edges exist only between same-rid neighbours; -1 = pad),
``area`` [N, V] bool (ring encloses area — line runs do not), ``nv`` [N]
i32 edge slots, ``exists`` [N] bool. Query shape: the same layout from
utils/geoshape.parse_shape_rings, its ring structure (``qrid``, ``qarea``:
host numpy, one for the batch) and its coordinates per query (``qlats``,
``qlons`` [B, E+1] f32).

Inside-ness is GLOBAL EVEN-ODD parity over area-ring edges: polygon holes
flip parity back out, multipolygon members flip it in. All edge tests treat
boundary contact as intersection (inclusive orientation ≤ 0).

The ``_*`` helpers and :func:`shape_relation_plain` keep the reference's
arithmetic, each operation one tensor op (rounded alone, in the reference's
order); on CUDA tensors :func:`shape_relation` is kernel K18
(``csrc/geo_shape.cu``, one warp a doc row), whose masks equal the plain
version's bit for bit. ``_points_in_query_shape`` also serves the
geo_polygon filter's plain version (ops/filters.py), as in the reference.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from elasticsearch_tpu_torch.ops import cuda_build

RELATIONS = ("intersects", "disjoint", "within", "contains")

SHAPE_RELATION = cuda_build.CudaKernel(
    "shape_relation", "geo_shape.cu", "geo_shape_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p])

#: the ray cast's stand-in for a zero edge height (a horizontal edge)
_TINY = 1e-30


def _orient(ax, ay, bx, by, cx, cy):
    return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)


def _doc_edges(dlats, dlons, dnv, drid):
    a_lat, a_lon = dlats[:, :-1], dlons[:, :-1]
    b_lat, b_lon = dlats[:, 1:], dlons[:, 1:]
    valid = (torch.arange(dlats.shape[1] - 1, device=dlats.device)[None, :]
             < dnv[:, None]) & (drid[:, :-1] == drid[:, 1:]) & \
        (drid[:, :-1] >= 0)
    return a_lat, a_lon, b_lat, b_lon, valid


def _q(t, i, extra: int):
    """Query vertex ``i`` of ``t`` [B, E+1] shaped [B, 1, ...] against
    ``extra`` trailing point axes."""
    return t[:, i].reshape(-1, *([1] * extra))


def _edge_cross_any(dlats, dlons, dnv, drid, qlats, qlons, qrid):
    """[B, N] — any doc edge meets any query edge (segment–segment
    orientation test, inclusive of collinear touch). A query edge between
    two rings (``qrid`` differs) is skipped, as the reference gates it."""
    a_lat, a_lon, b_lat, b_lon, valid = _doc_edges(dlats, dlons, dnv, drid)
    acc = torch.zeros((qlats.shape[0], dlats.shape[0]), dtype=torch.bool,
                      device=dlats.device)
    for i in range(qlats.shape[1] - 1):
        if qrid[i] != qrid[i + 1]:
            continue
        c_lat, c_lon = _q(qlats, i, 2), _q(qlons, i, 2)
        d_lat, d_lon = _q(qlats, i + 1, 2), _q(qlons, i + 1, 2)
        o1 = _orient(a_lon, a_lat, b_lon, b_lat, c_lon, c_lat)
        o2 = _orient(a_lon, a_lat, b_lon, b_lat, d_lon, d_lat)
        o3 = _orient(c_lon, c_lat, d_lon, d_lat, a_lon, a_lat)
        o4 = _orient(c_lon, c_lat, d_lon, d_lat, b_lon, b_lat)
        hit = (o1 * o2 <= 0) & (o3 * o4 <= 0)
        # all four orientations zero = collinear: the orientation test is
        # vacuous there — the 1-D bounding intervals must overlap on both
        # axes, or distant collinear segments would meet
        collinear = (o1 == 0) & (o2 == 0) & (o3 == 0) & (o4 == 0)
        bbox = (torch.minimum(a_lat, b_lat) <= torch.maximum(c_lat, d_lat)) \
            & (torch.maximum(a_lat, b_lat) >= torch.minimum(c_lat, d_lat)) \
            & (torch.minimum(a_lon, b_lon) <= torch.maximum(c_lon, d_lon)) \
            & (torch.maximum(a_lon, b_lon) >= torch.minimum(c_lon, d_lon))
        hit = hit & torch.where(collinear, bbox, True) & valid
        acc |= hit.any(dim=-1)
    return acc


def _points_in_query_shape(plats, plons, qlats, qlons, qrid, qarea):
    """Global even-odd ray cast of point arrays (``plats``/``plons`` of any
    shape P) against each query's AREA rings → [B, *P] bool. Edges between
    rings or of line rings (host constants ``qrid``, ``qarea``) never flip
    the parity, as the reference's gate."""
    extra = plats.dim()
    parity = torch.zeros((qlats.shape[0], *plats.shape), dtype=torch.bool,
                         device=plats.device)
    for i in range(qlats.shape[1] - 1):
        if qrid[i] != qrid[i + 1] or not qarea[i]:
            continue
        yi, xi = _q(qlats, i, extra), _q(qlons, i, extra)
        yj, xj = _q(qlats, i + 1, extra), _q(qlons, i + 1, extra)
        crosses = (yi > plats) != (yj > plats)
        den = yj - yi
        xcross = (xj - xi) * (plats - yi) / torch.where(den == 0, _TINY,
                                                        den) + xi
        parity ^= crosses & (plons < xcross)
    return parity


def _query_point_in_doc_shapes(qlat, qlon, dlats, dlons, dnv, drid, darea):
    """[B, N] — query vertex (``qlat``, ``qlon`` [B]) inside each doc's area
    rings (even-odd)."""
    a_lat, a_lon, b_lat, b_lon, valid = _doc_edges(dlats, dlons, dnv, drid)
    valid = valid & darea[:, :-1]
    ql, qo = qlat[:, None, None], qlon[:, None, None]
    crosses = ((a_lat > ql) != (b_lat > ql)) & valid
    den = b_lat - a_lat
    xcross = (b_lon - a_lon) * (ql - a_lat) / torch.where(den == 0, _TINY,
                                                          den) + a_lon
    return (crosses & (qo < xcross)).sum(dim=-1) % 2 == 1


def _ring_starts_np(qrid) -> list[int]:
    """Host-side: index of each ring's first vertex."""
    qrid = np.asarray(qrid)
    return [int(i) for i in range(len(qrid))
            if i == 0 or qrid[i] != qrid[i - 1]]


def shape_relation_plain(dlats, dlons, dnv, exists, drid, darea,
                         qlats, qlons, qrid_np, qarea_np,
                         relation: str) -> torch.Tensor:
    """K18's plain version: [B, N] bool for intersects / disjoint / within
    / contains, the reference's tests with a batch axis."""
    qrid = [int(x) for x in np.asarray(qrid_np)]
    qarea = [bool(x) for x in np.asarray(qarea_np)]
    if relation not in RELATIONS:
        raise ValueError(f"unknown geo_shape relation [{relation}]")
    cross = _edge_cross_any(dlats, dlons, dnv, drid, qlats, qlons, qrid)
    if relation in ("intersects", "disjoint"):
        # one representative vertex PER doc ring inside the query, and one
        # PER query ring inside the doc (a member ring wholly inside the
        # other shape intersects it even when the first ring does not)
        vparity = _points_in_query_shape(dlats, dlons, qlats, qlons, qrid,
                                         qarea)
        ring_start = (drid >= 0) & torch.cat(
            [torch.ones((dlats.shape[0], 1), dtype=torch.bool,
                        device=dlats.device),
             drid[:, 1:] != drid[:, :-1]], dim=1)
        inter = cross | (vparity & ring_start).any(dim=-1)
        for start in _ring_starts_np(qrid):
            inter = inter | _query_point_in_doc_shapes(
                qlats[:, start], qlons[:, start], dlats, dlons, dnv, drid,
                darea)
        return exists & (inter if relation == "intersects" else ~inter)
    if relation == "within":
        # every doc vertex inside the query shape, no boundary crossing
        vparity = _points_in_query_shape(dlats, dlons, qlats, qlons, qrid,
                                         qarea)
        all_in = torch.where(drid >= 0, vparity, True).all(dim=-1)
        return exists & all_in & ~cross
    # contains: every query vertex but the closing one inside the doc shape
    all_in = torch.ones_like(cross)
    for i in range(qlats.shape[1] - 1):
        all_in &= _query_point_in_doc_shapes(qlats[:, i], qlons[:, i], dlats,
                                             dlons, dnv, drid, darea)
    return exists & all_in & ~cross


def shape_relation(dlats, dlons, dnv, exists, drid, darea, qlats, qlons,
                   qrid_np, qarea_np, relation: str) -> torch.Tensor:
    """→ [B, N] bool, the relation of each doc shape to each query's shape
    (``qlats``/``qlons`` [B, E+1]; a single [E+1] query gives [N]).
    ``qrid_np``/``qarea_np`` are HOST constants (the ring structure is the
    batch's); only the coordinates are per query. CPU tensors run
    :func:`shape_relation_plain`; CUDA tensors launch K18 once."""
    if relation not in RELATIONS:
        raise ValueError(f"unknown geo_shape relation [{relation}]")
    single = qlats.dim() == 1
    if single:
        qlats, qlons = qlats[None, :], qlons[None, :]
    dev = dlats.device
    if dev.type == "cpu":
        out = shape_relation_plain(dlats, dlons, dnv, exists, drid, darea,
                                   qlats, qlons, qrid_np, qarea_np, relation)
    else:
        out = _shape_relation_cuda(dlats, dlons, dnv, exists, drid, darea,
                                   qlats, qlons, qrid_np, qarea_np, relation,
                                   dev)
    return out[0] if single else out


def _shape_meta(qrid_np, qarea_np) -> np.ndarray:
    """K18's query-structure table: ring ids, area flags (0/1), ring
    starts, as one int32 array."""
    qrid = np.asarray(qrid_np, np.int32)
    return np.concatenate([qrid, np.asarray(qarea_np, bool).astype(np.int32),
                           np.asarray(_ring_starts_np(qrid), np.int32)])


def _shape_relation_cuda(dlats, dlons, dnv, exists, drid, darea, qlats,
                         qlons, qrid_np, qarea_np, relation, dev):
    name = "shape_relation"
    for arg, t, dtype in (("lats", dlats, torch.float32),
                          ("lons", dlons, torch.float32),
                          ("nv", dnv, torch.int32),
                          ("exists", exists, torch.bool),
                          ("rid", drid, torch.int32),
                          ("area", darea, torch.bool),
                          ("qlats", qlats, torch.float32),
                          ("qlons", qlons, torch.float32)):
        cuda_build.check_dtype(name, arg, t, dtype)
    n, v = dlats.shape
    b, qlen = qlats.shape
    if dlons.shape != (n, v) or drid.shape != (n, v) or \
            darea.shape != (n, v) or dnv.shape != (n,) or \
            exists.shape != (n,) or qlons.shape != (b, qlen) or \
            len(qrid_np) != qlen or len(qarea_np) != qlen or qlen < 2:
        raise ValueError(
            f"{name}: shapes disagree: doc [{n}, {v}] (lons "
            f"{tuple(dlons.shape)}, rid {tuple(drid.shape)}, area "
            f"{tuple(darea.shape)}, nv {tuple(dnv.shape)}, exists "
            f"{tuple(exists.shape)}), query {tuple(qlats.shape)} / "
            f"{tuple(qlons.shape)}, ring structure {len(qrid_np)}")
    meta = _shape_meta(qrid_np, qarea_np)
    qmeta = torch.from_numpy(meta).to(dev)
    qlats, qlons = qlats.contiguous(), qlons.contiguous()
    cuda_build.check_cuda(name, dev, lats=dlats, lons=dlons, nv=dnv,
                          exists=exists, rid=drid, area=darea, qlats=qlats,
                          qlons=qlons)
    out = torch.empty((b, n), dtype=torch.bool, device=dev)
    if b == 0 or n == 0:
        return out
    n_starts = len(meta) - 2 * qlen
    SHAPE_RELATION.launch(
        dev, dlats.data_ptr(), dlons.data_ptr(), drid.data_ptr(),
        darea.data_ptr(), dnv.data_ptr(), exists.data_ptr(), n, v,
        qlats.data_ptr(), qlons.data_ptr(), b, qlen, qmeta.data_ptr(),
        n_starts, RELATIONS.index(relation), out.data_ptr())
    return out
