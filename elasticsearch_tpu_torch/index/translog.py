"""Translog — the per-shard write-ahead log.

Mirrors the reference's durability design (core/index/translog/Translog.java):
an append-only sequence of checksummed frames split into **generations**
(``translog-<gen>.tlog`` files), with an atomically-updated ``translog.ckp``
checkpoint recording the current generation/offset/op-count
(Translog.java:179,273-276). Ops are added on every index/delete
(Translog.java:474); ``sync`` fsyncs per the durability policy
(REQUEST | ASYNC, Translog.java:1367); a flush (Lucene commit) rolls to a new
generation and trims ones below the commit point.

Frame format: ``[length u32][crc32 u32][payload bytes]`` where payload is a
compact JSON op record. CRC failures raise :class:`TranslogCorruptedError`
during replay (recovery stops at the first torn/corrupt tail frame, matching
the reference's truncated-translog handling).
"""

from __future__ import annotations

import json
import os
import threading
import struct
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Iterator

from elasticsearch_tpu_torch.common.errors import TranslogCorruptedError

OP_INDEX = "index"
OP_DELETE = "delete"

DURABILITY_REQUEST = "request"  # fsync on every write
DURABILITY_ASYNC = "async"      # fsync on interval / flush only

_HEADER = struct.Struct("<II")
_CKP_MAGIC = "es-tpu-translog-ckp"


@dataclass
class TranslogOp:
    op: str                    # OP_INDEX | OP_DELETE
    doc_id: str
    version: int
    source: dict | None = None
    routing: str | None = None
    seq_no: int = -1
    # metadata fields (_type/_parent/_timestamp/_ttl) — replayed so a
    # restart preserves parent joins and TTL expiries
    meta: dict | None = None

    def encode(self) -> bytes:
        rec: dict[str, Any] = {"op": self.op, "id": self.doc_id,
                               "v": self.version, "seq": self.seq_no}
        if self.source is not None:
            rec["src"] = self.source
        if self.routing is not None:
            rec["r"] = self.routing
        if self.meta:
            rec["m"] = self.meta
        return json.dumps(rec, separators=(",", ":")).encode("utf-8")

    @staticmethod
    def decode(data: bytes) -> "TranslogOp":
        rec = json.loads(data)
        return TranslogOp(op=rec["op"], doc_id=rec["id"], version=rec["v"],
                          source=rec.get("src"), routing=rec.get("r"),
                          seq_no=rec.get("seq", -1), meta=rec.get("m"))


class Translog:
    def __init__(self, path: Path, durability: str = DURABILITY_REQUEST):
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.durability = durability
        # Disk-fault injection seam (the MockDirectoryWrapper analog for
        # the WAL): hook(op, data) called before every append ("add",
        # frame bytes) and fsync ("sync", None). It may raise OSError to
        # inject an IO error, or — for "add" — return a truncated frame
        # to simulate a short (torn) write: the truncated bytes land in
        # the file and the append still fails. None in production.
        self.fault_hook = None
        gen, committed_gen, seq_no = self._read_checkpoint()
        self.generation = gen
        self.committed_generation = committed_gen
        self.next_seq_no = seq_no
        # A crash mid-append can leave a torn frame at the tail. Replay stops
        # at the first torn frame, so appending after one would make every
        # later (acked, fsynced) op unreachable — truncate to the last valid
        # frame boundary before reopening for append (the reference recovers
        # to the checkpointed offset; Translog.java:273-276).
        self._ops_in_gen = self._truncate_to_valid(self.generation)
        self._file = open(self._gen_path(self.generation), "ab")
        self._views: list[int] = []              # pinned view start gens
        # serializes view bookkeeping against roll/trim: an unsynchronized
        # acquire_view racing a concurrent flush could register a view for
        # generations _trim already deleted, silently losing phase2 ops
        self._views_lock = threading.Lock()

    # ---- files ------------------------------------------------------------

    def _gen_path(self, gen: int) -> Path:
        return self.path / f"translog-{gen}.tlog"

    def _ckp_path(self) -> Path:
        return self.path / "translog.ckp"

    def _read_checkpoint(self) -> tuple[int, int, int]:
        ckp = self._ckp_path()
        if not ckp.exists():
            return 1, 0, 0
        rec = json.loads(ckp.read_text())
        if rec.get("magic") != _CKP_MAGIC:
            raise TranslogCorruptedError(f"bad checkpoint magic in {ckp}")
        return rec["generation"], rec["committed_generation"], rec["seq_no"]

    def _write_checkpoint(self) -> None:
        tmp = self._ckp_path().with_suffix(".ckp.tmp")
        tmp.write_text(json.dumps({
            "magic": _CKP_MAGIC, "generation": self.generation,
            "committed_generation": self.committed_generation,
            "seq_no": self.next_seq_no}))
        os.replace(tmp, self._ckp_path())

    def _truncate_to_valid(self, gen: int) -> int:
        """Scan generation ``gen``; truncate any torn tail frame. Returns the
        number of valid ops. Raises on mid-file checksum corruption."""
        p = self._gen_path(gen)
        if not p.exists():
            return 0
        valid_end = 0
        ops = 0
        with open(p, "rb") as f:
            while True:
                header = f.read(_HEADER.size)
                if len(header) < _HEADER.size:
                    break
                length, crc = _HEADER.unpack(header)
                payload = f.read(length)
                if len(payload) < length:
                    break  # torn tail
                if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                    raise TranslogCorruptedError(
                        f"translog checksum mismatch in {p.name}")
                valid_end += _HEADER.size + length
                ops += 1
        if p.stat().st_size > valid_end:
            with open(p, "r+b") as f:
                f.truncate(valid_end)
        return ops

    # ---- write path -------------------------------------------------------

    def add(self, op: TranslogOp, sync: bool = True) -> int:
        """Append one op; returns its seq_no. With ``sync`` (the default)
        REQUEST durability fsyncs immediately; bulk callers pass
        sync=False per op and call :meth:`sync` ONCE before acking — the
        reference's per-REQUEST (not per-op) durability
        (TransportShardBulkAction syncs the translog once per shard bulk,
        IndexShard.sync). One fsync per 4k-doc bulk instead of 4k."""
        op.seq_no = self.next_seq_no
        payload = op.encode()
        frame = _HEADER.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload
        fault = self.fault_hook
        if fault is not None:
            torn = fault("add", frame)           # may raise OSError
            if torn is not None:
                # short write: the torn prefix reaches the file, then the
                # append fails — replay must stop at the frame boundary
                self._file.write(torn)
                self._file.flush()
                raise OSError(
                    f"simulated short write ({len(torn)}/{len(frame)} "
                    f"bytes)")
        self._file.write(frame)
        self.next_seq_no += 1
        self._ops_in_gen += 1
        if sync and self.durability == DURABILITY_REQUEST:
            self.sync()
        return op.seq_no

    def stats(self) -> dict:
        """Uncommitted operation count + on-disk bytes of live generations
        (the _stats translog section)."""
        ops = len(self.uncommitted_ops())
        size = 0
        for p in self.path.glob("translog-*.tlog"):
            try:
                size += p.stat().st_size
            except OSError:
                pass
        return {"operations": ops, "size_in_bytes": size}

    def sync(self) -> None:
        if self._file.closed:
            # closed by a concurrent engine self-fail: surface the IO
            # class the callers handle, not ValueError from flush()
            raise OSError("translog closed")
        fault = self.fault_hook
        if fault is not None:
            fault("sync", None)                  # may raise OSError
        self._file.flush()
        os.fsync(self._file.fileno())
        self._write_checkpoint()

    # ---- read / replay ----------------------------------------------------

    def read_generation(self, gen: int) -> Iterator[TranslogOp]:
        p = self._gen_path(gen)
        if not p.exists():
            return
        with open(p, "rb") as f:
            while True:
                header = f.read(_HEADER.size)
                if not header:
                    return
                if len(header) < _HEADER.size:
                    return  # torn tail write — stop (crash during append)
                length, crc = _HEADER.unpack(header)
                payload = f.read(length)
                if len(payload) < length:
                    return  # torn tail
                if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                    raise TranslogCorruptedError(
                        f"translog checksum mismatch in {p.name}")
                yield TranslogOp.decode(payload)

    def uncommitted_ops(self) -> list[TranslogOp]:
        """All ops in generations newer than the last commit (replayed on
        engine open — InternalEngine.java:215 recoverFromTranslog)."""
        return self.ops_since(self.committed_generation)

    def ops_since(self, gen: int) -> list[TranslogOp]:
        """All ops in generations newer than ``gen`` (peer-recovery phase2
        reads the ops captured during the file copy through a view —
        Translog snapshot/views, core/index/translog/Translog.java:506)."""
        self._file.flush()
        ops: list[TranslogOp] = []
        for g in range(gen + 1, self.generation + 1):
            ops.extend(self.read_generation(g))
        return ops

    # ---- views (pin generations open during peer recovery) -----------------

    def acquire_view(self) -> int:
        """Pin every generation after the current commit so a concurrent
        flush/roll can't trim them while a recovery streams files; returns
        the generation the view starts after (pass to ops_since)."""
        with self._views_lock:
            view_from = self.committed_generation
            self._views.append(view_from)
            return view_from

    def release_view(self, view_from: int) -> None:
        with self._views_lock:
            try:
                self._views.remove(view_from)
            except ValueError:
                pass
            self._trim()

    @property
    def num_uncommitted(self) -> int:
        return len(self.uncommitted_ops())

    # ---- lifecycle --------------------------------------------------------

    def roll(self, committed: bool = True) -> None:
        """Start a new generation; called by flush after the commit point is
        durable. Trims generations at/below the commit (Translog trimming)."""
        self.sync()
        self._file.close()
        if committed:
            self.committed_generation = self.generation
        self.generation += 1
        self._file = open(self._gen_path(self.generation), "ab")
        self._ops_in_gen = 0
        self._write_checkpoint()
        with self._views_lock:
            self._trim()

    def _trim(self) -> None:
        """Delete generations at/below the commit point, except ones a
        recovery view still needs. Caller holds _views_lock."""
        keep_after = min([self.committed_generation] + list(self._views))
        for p in self.path.glob("translog-*.tlog"):
            try:
                gen = int(p.stem.split("-")[1])
            except (IndexError, ValueError):
                continue
            if gen <= keep_after:
                p.unlink(missing_ok=True)

    def close(self) -> None:
        if not self._file.closed:
            try:
                self.sync()
            except OSError:
                # a failing disk must not wedge close — the engine is
                # self-failing; acked ops were already synced per policy
                pass
            self._file.close()
