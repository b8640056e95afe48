"""Batch-size buckets.

Counterpart of ``elasticsearch_tpu/search/batching.py``'s
:func:`pow2_bucket`. The rest of that module (the admission queue,
``AdaptiveBatcher``) is not ported yet.
"""

from __future__ import annotations


def pow2_bucket(n: int, cap: int | None = None) -> int:
    """Smallest power of two >= n (>= 1), clamped to `cap` when given.

    The bucketing rule the JAX package's batched layers share; the
    collective plane buckets its k and batch sizes with it."""
    b = 1 if n <= 1 else 1 << (n - 1).bit_length()
    if cap is not None and b > cap:
        return cap
    return b
