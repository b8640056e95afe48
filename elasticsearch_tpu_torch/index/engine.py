"""Engine — per-shard versioned CRUD orchestration.

The TPU-native counterpart of the reference's InternalEngine
(core/index/engine/InternalEngine.java): it owns

* an in-memory write buffer (:class:`SegmentBuilder`) — Lucene IndexWriter's
  RAM buffer;
* the committed immutable segment list + per-segment live bitmaps;
* the **version map** (doc _id → version/location) backing realtime get and
  optimistic concurrency (LiveVersionMap, InternalEngine.java:97,359,408);
* the :class:`Translog` WAL (add on every op, InternalEngine.java:335→
  translog.add);
* ``refresh()`` — turn the buffer into a searchable segment and swap the
  reader (InternalEngine.java:558);
* ``flush()`` — persist segments + commit point, roll the translog
  (InternalEngine.java:616);
* recovery — reopen last commit and replay uncommitted translog ops
  (InternalEngine.java:215).

Deletes against committed segments flip bits in the per-segment live bitmap
at refresh time (Lucene .liv semantics: visible to search after refresh,
immediately visible to realtime get via the version map).
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from elasticsearch_tpu_torch.common.errors import (
    DocumentMissingError, EngineClosedError, VersionConflictError)
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.segment import (
    Segment, SegmentBuilder, merge_segments, row_meta)
from elasticsearch_tpu_torch.index.translog import (
    Translog, TranslogOp, OP_INDEX, OP_DELETE, DURABILITY_REQUEST)
from elasticsearch_tpu_torch.mapping import MapperService

# Versioning ops match the reference's VersionType.INTERNAL semantics.
MATCH_ANY = -3  # Versions.MATCH_ANY
NOT_FOUND = -1


_VERSION_TYPES = ("internal", "external", "external_gt", "external_gte",
                  "force")


def _check_external_args(doc_id: str, version: int,
                         version_type: str) -> None:
    """VersionType validation (400-class): unknown types are rejected and
    non-internal types REQUIRE an explicit version (the reference's
    action_request_validation, not a 409)."""
    from elasticsearch_tpu_torch.common.errors import IllegalArgumentError
    if version_type not in _VERSION_TYPES:
        raise IllegalArgumentError(
            f"version type [{version_type}] is not supported")
    if version == MATCH_ANY:
        raise IllegalArgumentError(
            f"[{doc_id}] version must be set when version_type is "
            f"[{version_type}]")


@dataclass
class VersionEntry:
    version: int
    deleted: bool
    seg_id: int      # -1 = in the uncommitted buffer
    local_doc: int   # position within segment/buffer


@dataclass
class GetResult:
    found: bool
    doc_id: str
    version: int = 0
    source: dict | None = None
    # metadata-field values (_type/_parent/_timestamp/_ttl) read back from
    # the doc's parsed fields or segment columns
    meta: dict | None = None


@dataclass
class EngineStats:
    index_total: int = 0
    delete_total: int = 0
    refresh_total: int = 0
    flush_total: int = 0
    merge_total: int = 0
    index_time_ms: float = 0.0


class SearcherView:
    """An immutable point-in-time view: segments + live masks.

    The analog of an NRT reader acquired via IndexShard.acquireSearcher
    (core/index/shard/IndexShard.java:707). DeviceReader (ops layer) packs
    this onto the device.
    """

    def __init__(self, segments: list[Segment], live_masks: list[np.ndarray],
                 generation: int):
        self.segments = segments
        self.live_masks = live_masks   # [padded_docs] bool per segment
        self.generation = generation

    @property
    def num_docs(self) -> int:
        return int(sum(m[:s.num_docs].sum() for s, m in
                       zip(self.segments, self.live_masks)))

    @property
    def max_doc(self) -> int:
        return sum(s.num_docs for s in self.segments)


def _parsed_meta(doc) -> dict | None:
    """Metadata-field values out of a buffered ParsedDocument."""
    out = {}
    for key in ("_type", "_parent", "_routing"):
        f = doc.fields.get(key)
        if f is not None and f.keywords:
            out[key] = f.keywords[0]
    for key in ("_timestamp", "_ttl"):
        f = doc.fields.get(key)
        if f is not None and f.numerics:
            out[key] = int(f.numerics[0])
    return out or None


def _segment_meta(seg, local: int) -> dict | None:
    """Metadata-field values out of a committed segment's columns."""
    return row_meta(seg, local) or None


class Engine:
    def __init__(self, shard_path: Path, mapper_service: MapperService,
                 settings: Settings = Settings.EMPTY):
        self.path = Path(shard_path)
        self.path.mkdir(parents=True, exist_ok=True)
        # engine incarnation id: distinguishes delete+recreate of the same
        # index/shard in caches keyed by reader generation (a recreated
        # engine restarts generations from 0)
        import uuid as _uuid
        self.engine_uuid = _uuid.uuid4().hex
        self.mapper_service = mapper_service
        self.settings = settings
        self.stats = EngineStats()
        self._lock = threading.RLock()
        self._closed = False
        # While pinned (counter: concurrent recoveries/snapshots may
        # overlap), flush/force-merge are refused so the committed file
        # set cannot change underneath a reader of those files: the
        # peer-recovery TARGET pins while a source streams a commit in,
        # and recovery sources/snapshot uploads pin while reading the
        # commit out (the reference holds an IndexCommit ref / blocks
        # flush on RECOVERING shards for the same windows).
        self._commit_pins = 0
        # wired by IndexService: threshold slow log (IndexingSlowLog.java)
        # and the node's breaker service for memory accounting
        self.indexing_slow_log = None
        self.breaker_service = None
        # Engine self-fail (Engine.failEngine, core/index/engine/
        # Engine.java maybeFailEngine): an IO error on the WAL or the
        # committed store closes the engine and reports the shard failed
        # so the master reallocates the copy — the fault must surface as
        # a shard failure, never a wedged shard. on_failure(reason) is
        # wired by IndexService; disk_fault is the store-write injection
        # hook (hook(op, None), op in {"store.write", "store.commit"}).
        self.on_failure = None
        self.failure_reason: str | None = None
        self.disk_fault = None
        # background merging (ElasticsearchConcurrentMergeScheduler +
        # MergePolicyConfig): refresh() checks the policy and submits a
        # merge to this executor (callable(fn); the node wires its "merge"
        # thread pool here — None runs the merge inline, which unit tests
        # and standalone engines want for determinism)
        self.merge_executor = None
        self._merge_running = False
        self._merge_failures = 0
        self._booted = False
        # reader-swap listeners (RefreshListeners analog): fired OUTSIDE
        # the engine lock after any operation that published a fresh
        # point-in-time view (refresh, background/force merge, segment
        # install). The collective plane hangs its double-buffered
        # data-layer rebuild here — the next generation's device pack
        # starts composing AT refresh, not at the first search.
        self.reader_swap_listeners: list = []

        if getattr(type(self), "_SHADOW", False):
            # read-only replica: no write handle on the primary's WAL,
            # no uncommitted-op replay (commits-only visibility)
            self.translog = _NullTranslog()
        else:
            durability = settings.get("index.translog.durability",
                                      DURABILITY_REQUEST)
            self.translog = Translog(self.path / "translog",
                                     durability=durability)

        self._segments: list[Segment] = []
        self._live_masks: list[np.ndarray] = []
        # segments installed with track_versions=False: the background
        # merge's per-row version-map re-check would silently drop their
        # (untracked) docs, so they never background-merge
        self._untracked_seg_ids: set[int] = set()
        self._buffer = SegmentBuilder(seg_id=0)
        self._buffer_docs: dict[str, int] = {}      # _id → buffer local doc
        self._versions: dict[str, VersionEntry] = {}
        # (seg_id, local_doc) → doc_id: committed copies superseded since the
        # last refresh; their live bits are cleared at the next refresh.
        self._pending_seg_deletes: dict[tuple[int, int], str] = {}
        self._next_seg_id = 1
        self._reader_gen = 0
        self._commit_gen = self._load_commit()
        self._replay_translog()
        # End recovery with a refresh (reference: recoverFromTranslog ends
        # with refresh, InternalEngine.java:215ff) so replayed ops — and
        # replayed *deletes* queued in _pending_seg_deletes — are visible to
        # the first searcher.
        self._reader = SearcherView([], [], 0)
        self.refresh()
        # merges stay off during construction: merge_executor is wired by
        # IndexService only after the engine exists, and recovery must not
        # block on an inline merge of a large commit
        self._booted = True

    # ------------------------------------------------------- engine self-fail

    def fail_engine(self, reason: str) -> None:
        """Close the engine and report the failure upward (failEngine):
        the IndexService callback turns this into a shard-failed report
        to the master, which reallocates the copy. Idempotent; the
        report runs OFF the failing op's thread because it walks cluster
        state and may submit a master update."""
        with self._lock:
            if self._closed or self.failure_reason is not None:
                return
            self.failure_reason = str(reason)
        cb = self.on_failure
        if cb is not None:
            t = threading.Thread(target=cb, args=(self.failure_reason,),
                                 name="engine-failure", daemon=True)
            t.start()
        try:
            self.close()
        except Exception:                        # noqa: BLE001 — dying disk
            pass

    def _fail_io(self, what: str, e: Exception) -> None:
        """An IO error on a durability-critical write: self-fail, then
        surface the retryable EngineClosedError so coordinators re-route
        to the copy the master promotes."""
        self.fail_engine(f"{what} failed: {e}")
        raise EngineClosedError(
            f"engine failed [{what} failed: {e}]") from e

    def _translog_add(self, op: TranslogOp, sync: bool) -> None:
        try:
            self.translog.add(op, sync=sync)
        except OSError as e:
            self._fail_io("translog append", e)

    def translog_sync(self) -> None:
        """Fsync the WAL per the durability policy; an IO error fails the
        engine (bulk callers ack only after this returns). On an engine
        that already failed mid-bulk this raises the retryable
        EngineClosedError so the coordinator re-routes the whole bulk to
        the promoted primary instead of surfacing a closed-file error."""
        self._ensure_open()
        try:
            self.translog.sync()
        except OSError as e:
            self._fail_io("translog sync", e)

    def _io_fault(self, op: str) -> None:
        fault = self.disk_fault
        if fault is not None:
            fault(op, None)                      # may raise OSError

    # ------------------------------------------------------------------ CRUD

    def index(self, doc_id: str, source: dict, version: int = MATCH_ANY,
              routing: str | None = None, op_type: str = "index",
              version_type: str = "internal",
              from_translog: bool = False,
              meta: dict | None = None,
              sync: bool = True) -> tuple[int, bool]:
        """→ (new_version, created). Version semantics follow
        InternalEngine.innerIndex (version check → write → versionMap put);
        version_type external/external_gte/force per VersionType.java —
        external compares against the LAST KNOWN version (tombstones
        included) and the doc takes the caller's version."""
        t0 = time.perf_counter()
        with self._lock:
            self._ensure_open()
            entry = self._versions.get(doc_id)
            current = NOT_FOUND if entry is None or entry.deleted else entry.version
            if version_type != "internal":
                _check_external_args(doc_id, version, version_type)
                known = NOT_FOUND if entry is None else entry.version
                ok = (version_type == "force"
                      or known == NOT_FOUND
                      or (version_type == "external_gte"
                          and version >= known)
                      or (version_type in ("external", "external_gt")
                          and version > known))
                if not ok:
                    raise VersionConflictError("", doc_id, known, version)
                new_version = version
            else:
                if op_type == "create" and current != NOT_FOUND:
                    raise VersionConflictError("", doc_id, current, 0)
                # internal versioning CONTINUES through tombstones
                # (InternalEngine.innerIndex loads deletes from the
                # version map: delete v11 → next index v12, and an
                # explicit expected version matches the tombstone's).
                # Restarting at 1 would break per-doc version
                # monotonicity — the property every replica/replay
                # "skip strictly-older ops" guard is built on.
                known = NOT_FOUND if entry is None else entry.version
                if version != MATCH_ANY and version != known:
                    raise VersionConflictError("", doc_id, known, version)
                new_version = 1 if known == NOT_FOUND else known + 1

            # stamp the resolved version into the doc's columns (the
            # VersionFieldMapper doc-value): fetched hits read the
            # point-in-time version from the SEGMENT, not the live map
            meta = dict(meta or {})
            meta["_version"] = new_version
            parsed = self.mapper_service.document_mapper(
                meta.get("_type")).parse(
                doc_id, source, routing=routing, meta=meta)
            # supersede any buffered copy of the same doc
            old_buf = self._buffer_docs.get(doc_id)
            if old_buf is not None:
                self._buffer.docs[old_buf] = None  # tombstone slot
            if entry is not None and entry.seg_id >= 0:
                self._pending_seg_deletes[(entry.seg_id, entry.local_doc)] = doc_id
            local = self._buffer.add(parsed)
            self._buffer_docs[doc_id] = local
            self._versions[doc_id] = VersionEntry(new_version, False, -1, local)
            if not from_translog:
                self._translog_add(TranslogOp(OP_INDEX, doc_id, new_version,
                                              source=source, routing=routing,
                                              meta=meta), sync)
            self.stats.index_total += 1
            took = time.perf_counter() - t0
            self.stats.index_time_ms += took * 1e3
            if self.indexing_slow_log is not None:
                self.indexing_slow_log.maybe_log(
                    took, f"id[{doc_id}], version[{new_version}]")
            return new_version, current == NOT_FOUND

    def index_replica(self, doc_id: str, source: dict, version: int,
                      routing: str | None = None,
                      meta: dict | None = None, sync: bool = True) -> int:
        """Apply a replicated index op with the version the primary
        resolved (TransportShardBulkAction replica path: no version
        conflict re-check, core/action/bulk/TransportShardBulkAction.java:448).
        Ops STRICTLY below the locally known version are skipped, which
        dedupes recovery-replay vs. live-replication overlap; an op AT
        the known version re-applies — that's idempotent for a double
        delivery of the same op, and required for external_gte, where two
        successive legitimate writes can carry the SAME version and the
        later one must win."""
        with self._lock:
            self._ensure_open()
            entry = self._versions.get(doc_id)
            if entry is not None and entry.version > version:
                return entry.version
            meta = dict(meta or {})
            meta["_version"] = version
            parsed = self.mapper_service.document_mapper(
                meta.get("_type")).parse(
                doc_id, source, routing=routing, meta=meta)
            old_buf = self._buffer_docs.get(doc_id)
            if old_buf is not None:
                self._buffer.docs[old_buf] = None
            if entry is not None and entry.seg_id >= 0:
                self._pending_seg_deletes[(entry.seg_id, entry.local_doc)] \
                    = doc_id
            local = self._buffer.add(parsed)
            self._buffer_docs[doc_id] = local
            self._versions[doc_id] = VersionEntry(version, False, -1, local)
            self._translog_add(TranslogOp(OP_INDEX, doc_id, version,
                                          source=source, routing=routing,
                                          meta=meta), sync)
            self.stats.index_total += 1
            return version

    def delete_replica(self, doc_id: str, version: int,
                       sync: bool = True) -> int:
        """Apply a replicated delete with the primary-resolved version
        (same strictly-below skip rule as index_replica: an equal-version
        delete — external_gte can issue one — must still apply)."""
        with self._lock:
            self._ensure_open()
            entry = self._versions.get(doc_id)
            if entry is not None and entry.version > version:
                return entry.version
            if entry is not None and entry.seg_id == -1:
                self._buffer.docs[entry.local_doc] = None
                self._buffer_docs.pop(doc_id, None)
            elif entry is not None and entry.seg_id >= 0:
                self._pending_seg_deletes[(entry.seg_id, entry.local_doc)] \
                    = doc_id
            self._versions[doc_id] = VersionEntry(version, True, -2, -1)
            self._translog_add(TranslogOp(OP_DELETE, doc_id, version), sync)
            self.stats.delete_total += 1
            return version

    def delete(self, doc_id: str, version: int = MATCH_ANY,
               version_type: str = "internal",
               from_translog: bool = False, sync: bool = True) -> int:
        with self._lock:
            self._ensure_open()
            entry = self._versions.get(doc_id)
            current = NOT_FOUND if entry is None or entry.deleted else entry.version
            if version_type != "internal":
                _check_external_args(doc_id, version, version_type)
                known = NOT_FOUND if entry is None else entry.version
                ok = (version_type == "force" or known == NOT_FOUND
                      or (version_type == "external_gte"
                          and version >= known)
                      or (version_type in ("external", "external_gt")
                          and version > known))
                if not ok:
                    raise VersionConflictError("", doc_id, known, version)
                if current == NOT_FOUND:
                    raise DocumentMissingError("", doc_id)
                new_version = version
            else:
                # same continuation rule as the index arm: explicit
                # internal versions compare against the LAST KNOWN
                # version, tombstones included
                known = NOT_FOUND if entry is None else entry.version
                if version != MATCH_ANY and version != known:
                    raise VersionConflictError("", doc_id, known, version)
                if current == NOT_FOUND:
                    raise DocumentMissingError("", doc_id)
                new_version = current + 1
            if entry.seg_id == -1:
                self._buffer.docs[entry.local_doc] = None
                self._buffer_docs.pop(doc_id, None)
            elif entry.seg_id >= 0:
                self._pending_seg_deletes[(entry.seg_id, entry.local_doc)] = doc_id
            self._versions[doc_id] = VersionEntry(new_version, True, -2, -1)
            if not from_translog:
                self._translog_add(TranslogOp(OP_DELETE, doc_id,
                                              new_version), sync)
            self.stats.delete_total += 1
            return new_version

    def doc_version(self, doc_id: str) -> int | None:
        """Current version of a live doc (None if absent/deleted) — feeds
        search hits' _version (version:true) and delete-by-query's
        optimistic per-doc deletes."""
        with self._lock:
            entry = self._versions.get(doc_id)
            if entry is None or entry.deleted:
                return None
            return entry.version

    def get(self, doc_id: str, realtime: bool = True) -> GetResult:
        """Realtime get (reference: ShardGetService.java:68 — reads from the
        version map / translog without waiting for refresh). With
        ``realtime=False``, the LAST REFRESHED view answers, like the
        reference's searcher-backed get: buffered writes and buffered
        deletes are invisible until refresh."""
        with self._lock:
            self._ensure_open()
            entry = self._versions.get(doc_id)
            if not realtime:
                return self._get_from_reader(doc_id, entry)
            if entry is None or entry.deleted:
                return GetResult(found=False, doc_id=doc_id)
            if entry.seg_id == -1:
                doc = self._buffer.docs[entry.local_doc]
                return GetResult(True, doc_id, entry.version, doc.source,
                                 meta=_parsed_meta(doc))
            for seg in self._segments:
                if seg.seg_id == entry.seg_id:
                    return GetResult(True, doc_id, entry.version,
                                     seg.sources[entry.local_doc],
                                     meta=_segment_meta(seg,
                                                        entry.local_doc))
            return GetResult(found=False, doc_id=doc_id)

    def _get_from_reader(self, doc_id: str,
                         entry: "VersionEntry | None") -> GetResult:
        """Non-realtime get: resolve through the current point-in-time
        view's segments + live masks (callers hold self._lock). The
        version reported is the segment row's own _version doc-value
        (the VersionFieldMapper column) — the point-in-time value, NOT
        the live map's, which may already be ahead of the refreshed
        view; rows without the column (legacy segments) fall back to the
        latest known version."""
        view = self._reader
        for seg, live in zip(view.segments, view.live_masks):
            index = getattr(seg, "_id_index", None)
            if index is None:
                index = {d: i for i, d in enumerate(seg.ids[:seg.num_docs])}
                seg._id_index = index
            local = index.get(doc_id)
            if local is not None and bool(live[local]):
                meta = _segment_meta(seg, local)
                if meta is not None and "_version" in meta:
                    version = int(meta["_version"])
                else:
                    version = entry.version if entry is not None else 1
                return GetResult(True, doc_id, version, seg.sources[local],
                                 meta=meta)
        return GetResult(found=False, doc_id=doc_id)

    # --------------------------------------------------------------- refresh

    def refresh(self) -> SearcherView:
        """Make buffered writes searchable: build a segment from the buffer,
        apply pending deletes to live bitmaps, swap the reader."""
        with self._lock:
            self._ensure_open()
            live_docs = [d for d in self._buffer.docs if d is not None]
            if live_docs:
                builder = SegmentBuilder(self._next_seg_id,
                                         max_tokens=self._buffer.max_tokens)
                for d in live_docs:
                    builder.add(d)
                seg = builder.build()
                mask = np.zeros(seg.padded_docs, dtype=bool)
                mask[:seg.num_docs] = True
                for local, d in enumerate(live_docs):
                    e = self._versions.get(d.doc_id)
                    if e is not None and not e.deleted and e.seg_id == -1:
                        self._versions[d.doc_id] = VersionEntry(
                            e.version, False, seg.seg_id, local)
                self._segments.append(seg)
                self._live_masks.append(mask)
                self._next_seg_id += 1
                self._buffer = SegmentBuilder(seg_id=0,
                                              max_tokens=self._buffer.max_tokens)
                self._buffer_docs = {}
            # apply deletes & updates to committed segments (only docs whose
            # committed copy was superseded since the last refresh)
            if self._pending_seg_deletes:
                by_seg = {s.seg_id: (s, m) for s, m in
                          zip(self._segments, self._live_masks)}
                for (seg_id, local), did in self._pending_seg_deletes.items():
                    pair = by_seg.get(seg_id)
                    if pair is None:
                        continue
                    seg, mask = pair
                    e = self._versions.get(did)
                    if e is None or e.deleted or e.seg_id != seg_id \
                            or e.local_doc != local:
                        mask[local] = False
                self._pending_seg_deletes = {}
            self.stats.refresh_total += 1
            out = self._swap_reader()
        self._maybe_merge()
        self._notify_reader_swap()
        return out

    def _notify_reader_swap(self) -> None:
        """Fire reader-swap listeners outside the engine lock (a listener
        scheduling a device pack rebuild may itself acquire searcher
        views). Listener failures never fail the swap."""
        for cb in list(self.reader_swap_listeners):
            try:
                cb()
            except Exception:                # noqa: BLE001 — best-effort
                pass

    def _swap_reader(self) -> SearcherView:
        """Bump the generation and publish a fresh point-in-time view
        (callers hold self._lock)."""
        self._reader_gen += 1
        self._reader = SearcherView(list(self._segments),
                                    [m.copy() for m in self._live_masks],
                                    self._reader_gen)
        return self._reader

    def install_segment(self, segment: Segment,
                        track_versions: bool = True) -> None:
        """Bulk-ingest: install a pre-built immutable segment into the live
        segment set and swap the reader — the engine-level analog of
        Lucene's ``IndexWriter.addIndexes`` (used for bulk loads that
        build columnar segments directly, e.g. Segment.from_packed_text).

        Documents are taken as NEW: no version-conflict checks run. With
        ``track_versions=False`` the version map skips them (append-only
        corpora: realtime get / update / delete-by-id won't resolve these
        docs). The segment is NOT in the translog — call :meth:`flush` to
        make the install durable (addIndexes has the same contract: files
        are only safe after commit)."""
        with self._lock:
            self._ensure_open()
            segment.seg_id = self._next_seg_id
            self._next_seg_id += 1
            mask = np.zeros(segment.padded_docs, dtype=bool)
            mask[:segment.num_docs] = True
            if track_versions:
                for local in range(segment.num_docs):
                    self._versions[segment.ids[local]] = VersionEntry(
                        1, False, segment.seg_id, local)
            else:
                self._untracked_seg_ids.add(segment.seg_id)
            self._segments.append(segment)
            self._live_masks.append(mask)
            self.stats.index_total += segment.num_docs
            self._swap_reader()
        self._notify_reader_swap()

    def acquire_searcher(self) -> SearcherView:
        with self._lock:
            self._ensure_open()
            return self._reader

    # ----------------------------------------------------------------- flush

    def flush(self) -> None:
        """Persist segments + commit point; roll translog
        (InternalEngine.java:616: Lucene commit + translog roll)."""
        with self._lock:
            self._ensure_open()
            if self._commit_pins:
                return                           # commit pinned — no flush
            self.refresh()
            store_type = str(self.settings.get("index.store.type", "fs"))
            try:
                for seg, mask in zip(self._segments, self._live_masks):
                    self._io_fault("store.write")
                    seg_dir = self.path / f"seg_{seg.seg_id}"
                    if not (seg_dir / "meta.json").exists():
                        seg.write(seg_dir, store_type=store_type)
                    np.save(seg_dir / "live.tmp.npy", mask)
                    os.replace(seg_dir / "live.tmp.npy",
                               seg_dir / "live.npy")
                self._commit_gen += 1
                commit = {
                    "generation": self._commit_gen,
                    "segments": [s.seg_id for s in self._segments],
                    "next_seg_id": self._next_seg_id,
                    "versions": {did: [e.version, e.deleted, e.seg_id,
                                       e.local_doc]
                                 for did, e in self._versions.items()},
                }
                self._io_fault("store.commit")
                tmp = self.path / "commit.json.tmp"
                tmp.write_text(json.dumps(commit))
                os.replace(tmp, self.path / "commit.json")
                self.translog.roll(committed=True)
            except OSError as e:
                # a failed commit leaves the previous commit.json intact
                # (tmp + atomic replace), but the engine's durability
                # contract is broken — self-fail and reallocate
                self._fail_io("store commit", e)
            self.stats.flush_total += 1

    # ------------------------------------------------- background merging

    def _merge_candidates(self) -> list[tuple[Segment, "np.ndarray"]]:
        """Merge policy (MergePolicyConfig, tiered-lite): once the segment
        count exceeds segments_per_tier, merge up to max_merge_at_once of
        the SMALLEST re-analyzable segments into one. Two tiered-style
        guards keep total merge work O(n log n) instead of O(n²): segments
        above max_merged_segment_docs never merge again, and a run of
        small segments won't drag in a segment >4× their combined size
        (so the accumulated big segment isn't rewritten every cycle).
        Callers hold _lock."""
        per_tier = int(self.settings.get(
            "index.merge.policy.segments_per_tier", 10))
        max_at_once = int(self.settings.get(
            "index.merge.policy.max_merge_at_once", 10))
        max_merged = int(self.settings.get(
            "index.merge.policy.max_merged_segment_docs", 5_000_000))
        if len(self._segments) <= per_tier:
            return []
        cands = [(s, m) for s, m in zip(self._segments, self._live_masks)
                 if s.source_complete
                 and s.seg_id not in self._untracked_seg_ids
                 and s.num_docs < max_merged]
        if len(cands) < 2:
            return []
        cands.sort(key=lambda sm: sm[0].num_docs)
        picked: list = []
        total = 0
        for s, m in cands:
            if picked and s.num_docs > 4 * max(total, 64):
                break                      # size skew: stop before the jump
            picked.append((s, m))
            total += s.num_docs
            if len(picked) == max_at_once:
                break
        return picked if len(picked) >= 2 else []

    def _maybe_merge(self) -> None:
        """Refresh-time merge trigger (the scheduler seam the reference
        hangs off IndexWriter; ours hangs off refresh because that is when
        new segments appear)."""
        with self._lock:
            if (not self._booted or self._closed or self._commit_pins
                    or self._merge_running or self._merge_failures >= 3
                    or not self._merge_candidates()):
                return
            self._merge_running = True
        if self.merge_executor is not None:
            try:
                self.merge_executor(self._background_merge)
            except Exception:                # noqa: BLE001 — pool closed
                self._merge_running = False
        else:
            self._background_merge()

    def _background_merge(self) -> None:
        """One background merge: snapshot the candidate segments under the
        lock, re-analyze them into one OUTSIDE the lock (writes continue),
        then commit the swap — docs deleted or updated during the merge
        stay dead because the version map is re-checked per row at commit
        (Lucene carries deletes forward into merged segments the same
        way). Failures log and count toward a circuit breaker (3 strikes
        stops retriggering; a successful force_merge resets it) so a
        persistently unmergeable segment can't wedge refresh or spin the
        merge pool."""
        try:
            with self._lock:
                if self._closed or self._commit_pins:
                    return
                cands = self._merge_candidates()
                if not cands:
                    return
                srcs = [(s, m.copy()) for s, m in cands]
            builder = merge_segments(
                0, [s for s, _ in srcs], [m for _, m in srcs],
                self.mapper_service.document_mapper(),
                max_tokens=self._buffer.max_tokens)
            merged = builder.build()
            # row → source location, in merge_segments' iteration order
            locs = [(s.seg_id, local) for s, m in srcs
                    for local in range(s.num_docs) if m[local]]
            with self._lock:
                if self._closed or self._commit_pins:
                    return
                present = {s.seg_id for s in self._segments}
                if not all(s.seg_id in present for s, _ in srcs):
                    return               # raced with a force_merge
                merged.seg_id = self._next_seg_id
                self._next_seg_id += 1
                mask = np.zeros(merged.padded_docs, dtype=bool)
                for local, (ssid, slocal) in enumerate(locs):
                    e = self._versions.get(merged.ids[local])
                    if e is not None and not e.deleted \
                            and e.seg_id == ssid and e.local_doc == slocal:
                        mask[local] = True
                        self._versions[merged.ids[local]] = VersionEntry(
                            e.version, False, merged.seg_id, local)
                drop = {s.seg_id for s, _ in srcs}
                keep = [i for i, s in enumerate(self._segments)
                        if s.seg_id not in drop]
                self._segments = [self._segments[i] for i in keep] + [merged]
                self._live_masks = [self._live_masks[i]
                                    for i in keep] + [mask]
                self._pending_seg_deletes = {
                    k: v for k, v in self._pending_seg_deletes.items()
                    if k[0] not in drop}
                self.stats.merge_total += 1
                self._swap_reader()
                self._drop_segment_files(drop)
            self._merge_failures = 0
            self._notify_reader_swap()
        except Exception:                    # noqa: BLE001 — see docstring
            import logging
            self._merge_failures += 1
            logging.getLogger(__name__).exception(
                "background merge failed (%d/3) on %s",
                self._merge_failures, self.path)
        finally:
            self._merge_running = False

    def _drop_segment_files(self, drop_ids) -> None:
        """Persist the post-merge commit FIRST (when any dropped segment
        was committed), then delete the merged-away directories — a crash
        in between must never lose committed docs. Callers hold _lock."""
        was_committed = any(
            (self.path / f"seg_{sid}" / "meta.json").exists()
            for sid in drop_ids)
        if was_committed:
            self.flush()
        import shutil
        for sid in drop_ids:
            seg_dir = self.path / f"seg_{sid}"
            if seg_dir.exists():
                shutil.rmtree(seg_dir)

    def synced_flush(self, sync_id: str | None = None) -> str | None:
        """Flush + stamp a sync_id in the commit (SyncedFlushService.java:
        60). Every COPY of a shard must receive the SAME id (the broadcast
        coordinator generates one) — matching ids are the cheap proof of
        file identity; our recovery also diffs by checksum, so the id is a
        marker, not a correctness requirement."""
        import uuid as _uuid
        with self._lock:
            self._ensure_open()
            if self._commit_pins:
                return None
            self.flush()
            commit_file = self.path / "commit.json"
            if not commit_file.exists():
                return None
            commit = json.loads(commit_file.read_text())
            sync_id = sync_id or _uuid.uuid4().hex
            commit["sync_id"] = sync_id
            tmp = self.path / "commit.json.tmp"
            tmp.write_text(json.dumps(commit))
            os.replace(tmp, commit_file)
            return sync_id

    def buffer_memory_bytes(self) -> int:
        """Rough RAM footprint of the uncommitted write buffer — the
        figure the IndexingMemoryController budget governs (the analog of
        Lucene's DocumentsWriter RAM accounting)."""
        with self._lock:
            total = 0
            for doc in self._buffer.docs:
                if doc is None:
                    continue
                total += 256                      # per-doc fixed overhead
                for pf in doc.fields.values():
                    total += 16 * len(pf.tokens) + 24 * len(pf.keywords) \
                        + 8 * len(pf.numerics)
                    if pf.vector is not None:
                        total += pf.vector.nbytes
            return total

    def expired_docs(self, now_ms: int) -> list[str]:
        """Doc ids whose _ttl expiry passed (the IndicesTTLService sweep
        source, core/indices/ttl/IndicesTTLService.java — there a range
        query over _ttl; here a direct scan of the numeric column +
        write buffer)."""
        out: list[str] = []
        with self._lock:
            for seg, live in zip(self._segments, self._live_masks):
                col = seg.numeric_fields.get("_ttl")
                if col is None:
                    continue
                vals = np.asarray(col.values[:seg.num_docs])
                ex = np.asarray(col.exists[:seg.num_docs])
                mask = ex & (vals <= now_ms) & live[:seg.num_docs]
                for local in np.nonzero(mask)[0]:
                    did = seg.ids[int(local)]
                    entry = self._versions.get(did)
                    if entry is not None and not entry.deleted and \
                            entry.seg_id == seg.seg_id and \
                            entry.local_doc == int(local):
                        out.append(did)
            for did, local in self._buffer_docs.items():
                doc = self._buffer.docs[local]
                if doc is None:
                    continue
                f = doc.fields.get("_ttl")
                if f is not None and f.numerics and \
                        f.numerics[0] <= now_ms:
                    out.append(did)
        return out

    def commit_user_data(self) -> dict:
        """The last commit's user data (ref: SegmentInfos userData — where
        the reference stamps translog ids and the synced-flush sync_id)."""
        commit_file = self.path / "commit.json"
        if not commit_file.exists():
            return {}
        try:
            commit = json.loads(commit_file.read_text())
        except (OSError, json.JSONDecodeError):
            return {}
        out = {"translog_generation": str(commit.get("translog_gen", 0))}
        if commit.get("sync_id"):
            out["sync_id"] = commit["sync_id"]
        return out

    def force_merge(self, max_num_segments: int = 1) -> None:
        """_optimize / force-merge: rewrite segments into one, dropping
        deleted docs (ElasticsearchConcurrentMergeScheduler's job)."""
        with self._lock:
            self._ensure_open()
            if self._commit_pins:
                return                           # commit pinned — no merge
            self.refresh()
            if len(self._segments) <= max_num_segments:
                return
            # bulk-ingested segments without stored _source cannot be
            # re-analyzed, and untracked ones would lose every doc to the
            # version-map re-check — keep both as-is, merge only the rest
            # (kept MUST be the exact complement of mergeable: a segment
            # in neither list would silently vanish from the index)
            def can_merge(s: Segment) -> bool:
                return s.source_complete and \
                    s.seg_id not in self._untracked_seg_ids
            mergeable = [(s, m) for s, m in
                         zip(self._segments, self._live_masks)
                         if can_merge(s)]
            kept = [(s, m) for s, m in zip(self._segments, self._live_masks)
                    if not can_merge(s)]
            if len(mergeable) <= 1:
                return
            builder = merge_segments(self._next_seg_id,
                                     [s for s, _ in mergeable],
                                     [m for _, m in mergeable],
                                     self.mapper_service.document_mapper(),
                                     max_tokens=self._buffer.max_tokens)
            merged = builder.build()
            mask = np.zeros(merged.padded_docs, dtype=bool)
            mask[:merged.num_docs] = True
            for local, did in enumerate(merged.ids):
                e = self._versions.get(did)
                if e is not None and not e.deleted:
                    self._versions[did] = VersionEntry(e.version, False,
                                                       merged.seg_id, local)
            old = [s for s, _ in mergeable]
            self._segments = [s for s, _ in kept] + [merged]
            self._live_masks = [m for _, m in kept] + [mask]
            self._next_seg_id += 1
            self.stats.merge_total += 1
            self._merge_failures = 0
            self._swap_reader()
            self._drop_segment_files([seg.seg_id for seg in old])
        self._notify_reader_swap()

    # -------------------------------------------------------------- recovery

    def _load_commit(self) -> int:
        commit_file = self.path / "commit.json"
        if not commit_file.exists():
            return 0
        commit = json.loads(commit_file.read_text())
        for seg_id in commit["segments"]:
            seg_dir = self.path / f"seg_{seg_id}"
            seg = Segment.read(seg_dir)
            live_file = seg_dir / "live.npy"
            mask = (np.load(live_file) if live_file.exists()
                    else np.concatenate([np.ones(seg.num_docs, bool),
                                         np.zeros(seg.padded_docs - seg.num_docs,
                                                  bool)]))
            self._segments.append(seg)
            self._live_masks.append(mask)
        self._next_seg_id = commit["next_seg_id"]
        self._versions = {
            did: VersionEntry(v[0], v[1], v[2], v[3])
            for did, v in commit["versions"].items()}
        return commit["generation"]

    def _replay_translog(self) -> None:
        for op in self.translog.uncommitted_ops():
            if op.op == OP_INDEX:
                # apply UNCONDITIONALLY: the translog is the total order
                # of this shard's ops, and the committed state reflects a
                # prefix of it, so replaying every op in sequence
                # converges to the exact pre-crash state — version-based
                # skips can't express "later in the log" once force
                # writes (which may LOWER a version) or external_gte
                # equal-version successors are in play
                self._apply_replayed_index(op)
            elif op.op == OP_DELETE:
                entry = self._versions.get(op.doc_id)
                if entry is not None and entry.seg_id == -1:
                    self._buffer.docs[entry.local_doc] = None
                    self._buffer_docs.pop(op.doc_id, None)
                elif entry is not None and entry.seg_id >= 0:
                    self._pending_seg_deletes[(entry.seg_id, entry.local_doc)] \
                        = op.doc_id
                self._versions[op.doc_id] = VersionEntry(op.version, True, -2, -1)

    def _apply_replayed_index(self, op: TranslogOp) -> None:
        meta = dict(op.meta or {})
        meta["_version"] = op.version
        parsed = self.mapper_service.document_mapper(
            meta.get("_type")).parse(
            op.doc_id, op.source, routing=op.routing, meta=meta)
        old_buf = self._buffer_docs.get(op.doc_id)
        if old_buf is not None:
            self._buffer.docs[old_buf] = None
        prev = self._versions.get(op.doc_id)
        if prev is not None and prev.seg_id >= 0:
            self._pending_seg_deletes[(prev.seg_id, prev.local_doc)] = op.doc_id
        local = self._buffer.add(parsed)
        self._buffer_docs[op.doc_id] = local
        self._versions[op.doc_id] = VersionEntry(op.version, False, -1, local)

    @property
    def recovery_in_progress(self) -> bool:
        return self._commit_pins > 0

    def pin_commit(self, flush_first: bool = True) -> None:
        """Freeze the committed file set (refuse flush/merge) until
        unpin_commit — atomic under the engine lock so no merge can slip
        between the flush and the pin. Counted: overlapping pins stack."""
        with self._lock:
            self._ensure_open()
            if flush_first and self._commit_pins == 0:
                self.flush()
            self._commit_pins += 1

    def unpin_commit(self) -> None:
        with self._lock:
            self._commit_pins = max(0, self._commit_pins - 1)

    # ------------------------------------------------ peer recovery (source)

    def file_manifest(self) -> dict[str, list[int]]:
        """Relative path → [size, crc32] of every committed file (commit
        point + segment files). The analog of Store.MetadataSnapshot
        (core/index/store/Store.java:87) — the checksum diff that lets
        phase1 skip files the target already holds."""
        import zlib
        with self._lock:
            self._ensure_open()
            out: dict[str, list[int]] = {}
            commit = self.path / "commit.json"
            files = [commit] if commit.exists() else []
            for seg_dir in sorted(self.path.glob("seg_*")):
                # recursive: nested child blocks live in subdirectories
                files.extend(sorted(p for p in seg_dir.rglob("*")
                                    if p.is_file()))
            for f in files:
                data = f.read_bytes()
                out[str(f.relative_to(self.path))] = \
                    [len(data), zlib.crc32(data) & 0xFFFFFFFF]
            return out

    # ------------------------------------------------ peer recovery (target)

    def install_recovered_commit(self) -> None:
        """Swap in a commit whose files phase1 just wrote under this
        engine's path, discarding all in-memory state. Safe against live
        replicated writes racing the file copy: any op newer than the
        source's commit is re-delivered by phase2 translog replay (version-
        deduped), any older op is already inside the commit."""
        with self._lock:
            self._ensure_open()
            self._segments = []
            self._live_masks = []
            self._buffer = SegmentBuilder(seg_id=0,
                                          max_tokens=self._buffer.max_tokens)
            self._buffer_docs = {}
            self._versions = {}
            self._pending_seg_deletes = {}
            self._commit_gen = self._load_commit()
            # everything before the installed commit is superseded — mark
            # the local translog committed so restart-replay can't
            # resurrect pre-recovery ops
            self.translog.roll(committed=True)
            self.refresh()

    # ------------------------------------------------------------- lifecycle

    @property
    def num_docs(self) -> int:
        with self._lock:
            return sum(1 for e in self._versions.values() if not e.deleted)

    def segment_stats(self) -> list[dict]:
        return [{"seg_id": s.seg_id, "num_docs": s.num_docs,
                 "live_docs": int(m[:s.num_docs].sum()),
                 "memory_bytes": s.memory_bytes()}
                for s, m in zip(self._segments, self._live_masks)]

    def _ensure_open(self) -> None:
        if self._closed:
            raise EngineClosedError("engine is closed")

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                # return the cached device reader's breaker reservation
                from elasticsearch_tpu_torch.index.device_reader import (
                    release_device_reader)
                release_device_reader(self)
                # collective-plane packs (and anything else holding
                # device memory against this engine's segments) release
                # through close listeners — breaker balance must hold
                # the moment the ENGINE dies, not only at index close
                for cb in list(getattr(self, "_close_listeners", ())):
                    try:
                        cb()
                    except Exception:    # noqa: BLE001 — teardown path
                        pass
                self.translog.close()
                self._closed = True


class _NullTranslog:
    """The shadow's translog stand-in: a read-only replica must neither
    hold a write handle on the primary's WAL nor replay uncommitted ops
    (ShadowEngine reads COMMITS only)."""

    generation = 0
    committed_generation = 0

    def add(self, *a, **kw):
        raise EngineClosedError("shadow engine has no translog")

    def uncommitted_ops(self):
        return []

    def roll(self, *a, **kw):
        return None

    def sync(self):
        return None

    def stats(self):
        return {"operations": 0, "size_in_bytes": 0}

    def close(self):
        return None


class ShadowEngine(Engine):
    """Read-only engine over a shared-filesystem shard directory (ref:
    core/index/engine/ShadowEngine.java — with index.shadow_replicas,
    replicas never apply ops; they re-open the commits the primary wrote
    to shared storage). Document ops, flush, and merges are refused — the
    PRIMARY owns the directory's commit and translog; the shadow only
    ever reads committed state. ``refresh_from_disk`` picks up the
    primary's latest commit."""

    _SHADOW = True

    def index(self, *a, **kw):
        raise EngineClosedError(
            "shadow engine does not support document operations")

    index_replica = index
    delete = index
    delete_replica = index

    def flush(self, *a, **kw):
        # committing from the shadow would overwrite the primary's commit
        # and (worse) roll its translog — ShadowEngine.flush is a no-op
        # reader re-open in the reference too
        return None

    def force_merge(self, *a, **kw):
        raise EngineClosedError("shadow engine does not merge")

    def _maybe_merge(self, *a, **kw):
        # a shadow merging would rewrite — and then DELETE — segment
        # directories the PRIMARY's commit still references on the shared
        # filesystem; merging is the primary's job alone
        return None

    def synced_flush(self, *a, **kw):
        return None

    def refresh_from_disk(self) -> int:
        """Re-open the newest on-disk commit (the primary's flush) and
        swap the reader. → the commit generation now serving reads."""
        with self._lock:
            self._ensure_open()
            self._segments = []
            self._live_masks = []
            self._buffer = SegmentBuilder(
                seg_id=0, max_tokens=self._buffer.max_tokens)
            self._buffer_docs = {}
            self._versions = {}
            self._pending_seg_deletes = {}
            self._commit_gen = self._load_commit()
            self.refresh()
            return self._commit_gen
