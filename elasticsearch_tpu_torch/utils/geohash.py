"""Geohash encoding (ref: core/common/geo/GeoHashUtils.java — base-32
interleaved lat/lon bits; the geohash_cell query and the geohash_grid
aggregation key on these).

Counterpart of ``elasticsearch_tpu/utils/geohash.py``, kept as the port's
own copy: host-side string work, exact in float64."""

from __future__ import annotations

_BASE32 = "0123456789bcdefghjkmnpqrstuvwxyz"

#: geohash length → approximate cell size in meters (ES's
#: GeoUtils.geoHashLevelsForPrecision table, coarsest edge)
_CELL_METERS = [None, 5_009_400, 1_252_300, 156_500, 39_100, 4_900,
                1_200, 152.9, 38.2, 4.78, 1.19, 0.149, 0.037]


def geohash_encode(lat: float, lon: float, length: int = 12) -> str:
    lat_lo, lat_hi = -90.0, 90.0
    lon_lo, lon_hi = -180.0, 180.0
    out = []
    bit = 0
    ch = 0
    even = True
    while len(out) < length:
        if even:
            mid = (lon_lo + lon_hi) / 2
            if lon >= mid:
                ch = (ch << 1) | 1
                lon_lo = mid
            else:
                ch <<= 1
                lon_hi = mid
        else:
            mid = (lat_lo + lat_hi) / 2
            if lat >= mid:
                ch = (ch << 1) | 1
                lat_lo = mid
            else:
                ch <<= 1
                lat_hi = mid
        even = not even
        bit += 1
        if bit == 5:
            out.append(_BASE32[ch])
            bit = 0
            ch = 0
    return "".join(out)


def precision_to_length(precision) -> int:
    """'5km' / '100m' / meters → the geohash length whose cells are at
    least that fine (GeoUtils.geoHashLevelsForPrecision)."""
    meters = None
    if isinstance(precision, (int, float)):
        if precision <= 12:              # bare number = geohash length
            return max(1, int(precision))
        meters = float(precision)
    else:
        s = str(precision).strip().lower()
        for suffix, mult in (("km", 1000.0), ("m", 1.0)):
            if s.endswith(suffix):
                meters = float(s[: -len(suffix)]) * mult
                break
        if meters is None:
            return max(1, min(int(float(s)), 12))  # bare geohash length
    for length in range(1, 13):
        if _CELL_METERS[length] <= meters:
            return length
    return 12


def geohash_decode_bbox(gh: str) -> tuple[float, float, float, float]:
    """geohash → (lat_lo, lat_hi, lon_lo, lon_hi) cell bounds."""
    lat_lo, lat_hi = -90.0, 90.0
    lon_lo, lon_hi = -180.0, 180.0
    even = True
    for c in gh:
        ch = _BASE32.index(c)
        for bit in (16, 8, 4, 2, 1):
            if even:
                mid = (lon_lo + lon_hi) / 2
                if ch & bit:
                    lon_lo = mid
                else:
                    lon_hi = mid
            else:
                mid = (lat_lo + lat_hi) / 2
                if ch & bit:
                    lat_lo = mid
                else:
                    lat_hi = mid
            even = not even
    return lat_lo, lat_hi, lon_lo, lon_hi


def geohash_neighbors(gh: str) -> list[str]:
    """The 8 neighboring cells at the same precision (re-encoding the
    centers offset by one cell — robust at edges/poles; duplicates and
    the cell itself are dropped)."""
    lat_lo, lat_hi, lon_lo, lon_hi = geohash_decode_bbox(gh)
    dlat = lat_hi - lat_lo
    dlon = lon_hi - lon_lo
    clat = (lat_lo + lat_hi) / 2
    clon = (lon_lo + lon_hi) / 2
    out = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            nlat = clat + dy * dlat
            nlon = clon + dx * dlon
            if not -90.0 <= nlat <= 90.0:
                continue
            nlon = ((nlon + 180.0) % 360.0) - 180.0
            n = geohash_encode(nlat, nlon, len(gh))
            if n != gh and n not in out:
                out.append(n)
    return out
