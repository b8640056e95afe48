"""MurmurHash3 x64_128 (h1 only), seed 0.

The mapper-murmur3 plugin indexes ``MurmurHash3.hash128(utf8 bytes).h1``
as a long doc-value (plugins/mapper-murmur3/.../Murmur3FieldMapper.java:137)
so cardinality aggregations can run on pre-hashed values. This is the
canonical x64_128 finalization; only h1 is returned, as a SIGNED 64-bit
int matching the Java long.
"""

from __future__ import annotations

_M = (1 << 64) - 1
_C1 = 0x87C37B91114253D5
_C2 = 0x4CF5AD432745937F


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M


def _fmix(k: int) -> int:
    k ^= k >> 33
    k = (k * 0xFF51AFD7ED558CCD) & _M
    k ^= k >> 33
    k = (k * 0xC4CEB9FE1A85EC53) & _M
    k ^= k >> 33
    return k


def hash128_x64_h1(data: bytes, seed: int = 0) -> int:
    """First 64-bit lane of MurmurHash3 x64_128 as a signed Java long."""
    length = len(data)
    h1 = h2 = seed
    nblocks = length // 16
    for i in range(nblocks):
        k1 = int.from_bytes(data[i * 16:i * 16 + 8], "little")
        k2 = int.from_bytes(data[i * 16 + 8:i * 16 + 16], "little")
        k1 = (k1 * _C1) & _M
        k1 = _rotl(k1, 31)
        k1 = (k1 * _C2) & _M
        h1 ^= k1
        h1 = _rotl(h1, 27)
        h1 = (h1 + h2) & _M
        h1 = (h1 * 5 + 0x52DCE729) & _M
        k2 = (k2 * _C2) & _M
        k2 = _rotl(k2, 33)
        k2 = (k2 * _C1) & _M
        h2 ^= k2
        h2 = _rotl(h2, 31)
        h2 = (h2 + h1) & _M
        h2 = (h2 * 5 + 0x38495AB5) & _M
    tail = data[nblocks * 16:]
    k1 = k2 = 0
    if len(tail) > 8:
        k2 = int.from_bytes(tail[8:].ljust(8, b"\x00"), "little")
        k2 = (k2 * _C2) & _M
        k2 = _rotl(k2, 33)
        k2 = (k2 * _C1) & _M
        h2 ^= k2
    if tail:
        k1 = int.from_bytes(tail[:8].ljust(8, b"\x00"), "little")
        k1 = (k1 * _C1) & _M
        k1 = _rotl(k1, 31)
        k1 = (k1 * _C2) & _M
        h1 ^= k1
    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & _M
    h2 = (h2 + h1) & _M
    h1 = _fmix(h1)
    h2 = _fmix(h2)
    h1 = (h1 + h2) & _M
    return h1 - (1 << 64) if h1 >= (1 << 63) else h1
