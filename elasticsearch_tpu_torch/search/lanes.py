"""The serving lanes' counter registries.

Counterpart of ``elasticsearch_tpu/search/lanes.py``; this slice holds only
the percolator's counters. ``breaker_skips`` (fused dispatches an open plane
breaker routed eager) comes back with the plane breaker.
"""

#: PercolatorRegistry.stats — per-index registry/evaluation counters
PERCOLATE_COUNTERS = {
    "builds": "registry constructions from scratch",
    "syncs": "metadata syncs that applied a change",
    "adds": "query registrations",
    "removes": "query unregistrations",
    "bucket_invalidations": "shape buckets touched by syncs",
    "mapper_rebuilds": "scratch MapperService rebuilds",
    "count": "percolate ops (one per probe doc)",
    "time_ms": "wall milliseconds in percolate ops",
    "fused_queries": "query evaluations on the fused device lane",
    "fallback_queries": "query evaluations on the per-query eager lane",
}
