"""Incremental append-only session log: continuous checkpointing.

``SessionStore`` (store.py) serializes a whole session at once — correct,
but stop-the-world: a busy multi-tenant service pays the full session
size at every checkpoint.  ``SessionLogStore`` replaces that with a
write-ahead log: **every memo decision, observed selectivity, pilot
probe, join mask, embedding-cache insert, oracle memo commit, precluster
fit, and table append/update becomes one framed record** appended (and
flushed) the moment it happens.  A checkpoint is just a log offset;
restart = snapshot-load + log-tail replay, so restart time is bounded by
the tail length, not the session size.

Frame format (little-endian), after an 8-byte file magic::

    <u32 payload length> <u32 crc32(payload)> <payload: msgpack map>

Numpy arrays travel as ``{"__nd__": dtype, shape, bytes}`` inside the
msgpack payload.  A torn final frame (crash mid-write) is detected by
length/crc and **truncated away on the next attach** — everything before
it replays normally.  A ``wal.lock`` file (O_CREAT|O_EXCL, pid inside)
rejects concurrent writers; a lock whose pid is dead is stolen.

Generations and compaction
--------------------------
Log files are ``wal_<gen>.log``.  ``compact()`` (a) opens generation
g+1 and re-writes the accumulated **table-mutation records** at its head
— the snapshot stores table *fingerprints*, not rows, so the mutations
that produced the fingerprinted content must stay replayable from the
base table the caller rebuilds — then (b) saves a standard
``SessionStore`` snapshot, (c) atomically commits ``CHECKPOINT.json``
pointing at ``(g+1, snapshot_offset)``, and (d) deletes older
generations.  A crash between any two steps leaves the previous
checkpoint fully usable.  ``restore()`` therefore replays:

    carried mutations (head of gen file) -> snapshot -> tail records

and the in-flight tail is exactly the work since the last compaction.

See docs/distributed.md; edge cases are covered in
tests/test_torch_session_log.py.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import struct
import threading
import zlib
from typing import Dict, List, Optional

import msgpack
import numpy as np

from repro_torch.api.memo import (DecisionMemo, JoinDecisionMemo, SelObservation,
                            oracle_identity)
from repro_torch.obs.trace import get_tracer
from repro_torch.plan.cost import PredStats
from repro_torch.service.store import RestoreReport, SessionStore

LOG_MAGIC = b"CSVWAL1\n"
LOG_SCHEMA = 1
_FRAME = struct.Struct("<II")


class ConcurrentWriterError(RuntimeError):
    """A second live writer tried to attach to the same log directory."""


class LogCorruptionError(RuntimeError):
    """The log failed structural validation beyond a recoverable tail."""


# ------------------------------------------------------------ array codec
def _enc(obj):
    if isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        return {"__nd__": arr.dtype.str, "s": list(arr.shape),
                "b": arr.tobytes()}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    raise TypeError(f"cannot log object of type {type(obj).__name__}")


def _dec(obj):
    if "__nd__" in obj:
        return np.frombuffer(obj["b"], dtype=np.dtype(obj["__nd__"])
                             ).reshape(obj["s"]).copy()
    return obj


def pack_record(payload: dict) -> bytes:
    """One framed record: length + crc32 header, msgpack body."""
    body = msgpack.packb(payload, use_bin_type=True, default=_enc)
    return _FRAME.pack(len(body), zlib.crc32(body)) + body


def read_records(path: pathlib.Path):
    """Scan one log file.  Returns ``(records, ends, valid_end, size)``
    where ``ends[i]`` is the file offset just past record ``i``.

    ``valid_end`` is the offset after the last intact frame; anything
    beyond it is a torn tail (crash mid-append) that ``LogWriter`` will
    truncate on the next attach.  A bad magic raises — that is not a torn
    tail but a file this code never wrote.
    """
    data = path.read_bytes()
    if len(data) < len(LOG_MAGIC) or data[:len(LOG_MAGIC)] != LOG_MAGIC:
        raise LogCorruptionError(f"{path} is not a session log "
                                 "(bad magic)")
    records: List[dict] = []
    ends: List[int] = []
    off = len(LOG_MAGIC)
    while off < len(data):
        if off + _FRAME.size > len(data):
            break  # torn header
        length, crc = _FRAME.unpack_from(data, off)
        body = data[off + _FRAME.size: off + _FRAME.size + length]
        if len(body) < length or zlib.crc32(body) != crc:
            break  # torn or corrupt frame: recovery truncates here
        records.append(msgpack.unpackb(body, raw=False, object_hook=_dec))
        off += _FRAME.size + length
        ends.append(off)
    return records, ends, off, len(data)


class LogWriter:
    """Append-only writer over one generation file (flush per record)."""

    def __init__(self, path: pathlib.Path, truncate_to: Optional[int] = None,
                 fresh: bool = False):
        self.path = path
        if fresh or not path.exists():
            path.write_bytes(LOG_MAGIC)
        elif truncate_to is not None and truncate_to < path.stat().st_size:
            with open(path, "r+b") as fh:
                fh.truncate(truncate_to)
        self._fh = open(path, "ab")

    @property
    def offset(self) -> int:
        return self._fh.tell()

    def append(self, payload: dict) -> int:
        """Write + flush one framed record; returns bytes written."""
        frame = pack_record(payload)
        self._fh.write(frame)
        self._fh.flush()
        return len(frame)

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()


@dataclasses.dataclass
class LogRestoreReport:
    """What a ``SessionLogStore.restore`` rebuilt, and from where."""
    snapshot: Optional[RestoreReport] = None  # compaction snapshot, if any
    n_carried_mutations: int = 0  # mutation records replayed pre-snapshot
    n_tail_records: int = 0       # records replayed after the snapshot
    torn_bytes: int = 0           # bytes dropped from a torn final frame
    skipped: List[str] = dataclasses.field(default_factory=list)

    @property
    def n_dropped(self) -> int:
        """Entries that could not be rebound (log skips + snapshot skips)."""
        snap = len(self.snapshot.skipped) if self.snapshot else 0
        return len(self.skipped) + snap

    def __str__(self) -> str:
        s = (f"log restore: {self.n_carried_mutations} carried mutation(s), "
             f"{'snapshot [' + str(self.snapshot) + '], ' if self.snapshot else 'no snapshot, '}"
             f"{self.n_tail_records} tail record(s)")
        if self.torn_bytes:
            s += f"; truncated {self.torn_bytes} torn byte(s)"
        if self.skipped:
            s += f"; skipped: {'; '.join(self.skipped)}"
        return s


_MUTATION_KINDS = ("append", "update")


class SessionLogStore:
    """Log-backed durability for one session (see module docstring).

    Lifecycle::

        store = SessionLogStore(log_dir)
        if store.exists():
            report = store.restore(session)   # snapshot + tail replay
        store.attach(session)                 # lock + start recording
        ...                                   # every event self-appends
        if store.compact_due:                 # thresholds crossed
            store.compact(session)            # at a quiescent point
        store.close()

    Recording hooks are installed on the session's memo, embedding cache,
    and registered oracles at ``attach`` and removed at ``close``; a
    session without an attached store pays a single ``is None`` check per
    event.  Appends are thread-safe (hooks fire from scheduler task
    threads and the dispatch lane).  ``compact()`` must run at a
    quiescent point — between ``gather()`` and the next ``submit()`` —
    because it snapshots live session state.
    """

    def __init__(self, directory, compact_bytes: int = 4 << 20,
                 compact_records: int = 10_000):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.compact_bytes = int(compact_bytes)
        self.compact_records = int(compact_records)
        self._snap = SessionStore(self.dir)
        self._lock = threading.RLock()
        self._writer: Optional[LogWriter] = None
        self._session = None
        self._recording = False
        self._gen = 0
        self._names: Dict[int, str] = {}   # id(oracle identity) -> name
        self._idents: Dict[int, object] = {}  # strong refs: ids stay stable
        self._carried: List[dict] = []     # mutation payloads to carry
        self._bytes_since = 0              # since last compaction
        self._records_since = 0
        self.n_unnamed_dropped = 0         # events of unregistered oracles

    # -------------------------------------------------------------- layout
    def _gen_path(self, gen: int) -> pathlib.Path:
        return self.dir / f"wal_{gen:06d}.log"

    @property
    def _checkpoint_path(self) -> pathlib.Path:
        return self.dir / "CHECKPOINT.json"

    @property
    def _lock_path(self) -> pathlib.Path:
        return self.dir / "wal.lock"

    def _read_checkpoint(self) -> dict:
        if self._checkpoint_path.exists():
            ck = json.loads(self._checkpoint_path.read_text())
            if ck.get("schema") != LOG_SCHEMA:
                raise LogCorruptionError(
                    f"session log schema {ck.get('schema')!r} does not "
                    f"match this build ({LOG_SCHEMA})")
            return ck
        return {"schema": LOG_SCHEMA, "gen": 0, "snapshot_offset": None}

    def _write_checkpoint(self, ck: dict) -> None:
        tmp = self._checkpoint_path.with_suffix(f".tmp-{os.getpid()}")
        tmp.write_text(json.dumps(ck))
        os.replace(tmp, self._checkpoint_path)

    def exists(self) -> bool:
        """Any restorable state under the directory?"""
        if self._checkpoint_path.exists():
            return True
        return any(self.dir.glob("wal_*.log"))

    @property
    def attached(self) -> bool:
        return self._writer is not None

    # ---------------------------------------------------------------- lock
    def _acquire_lock(self) -> None:
        for _ in range(2):
            try:
                fd = os.open(self._lock_path,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, str(os.getpid()).encode())
                os.close(fd)
                return
            except FileExistsError:
                pid = self._lock_holder()
                if pid is not None and _pid_alive(pid):
                    raise ConcurrentWriterError(
                        f"session log {self.dir} is held by live writer "
                        f"pid {pid}; a log directory supports exactly one "
                        "writer") from None
                # dead holder (killed process): steal the lock and retry
                try:
                    os.unlink(self._lock_path)
                except FileNotFoundError:
                    pass
        raise ConcurrentWriterError(
            f"could not acquire {self._lock_path} (lock churn)")

    def _lock_holder(self) -> Optional[int]:
        try:
            return int(self._lock_path.read_text().strip() or 0)
        except (FileNotFoundError, ValueError):
            return None

    def _release_lock(self) -> None:
        if self._lock_holder() == os.getpid():
            try:
                os.unlink(self._lock_path)
            except FileNotFoundError:
                pass

    # -------------------------------------------------------------- attach
    def attach(self, session) -> None:
        """Acquire the writer lock and start recording ``session``.

        Call ``restore(session)`` first when ``exists()`` — attaching a
        fresh session over unreplayed state would interleave records of
        two unrelated lifetimes.
        """
        with self._lock:
            if self._writer is not None:
                raise RuntimeError("store is already attached")
            self._acquire_lock()
            if self.exists() and self._session is not session:
                self._release_lock()
                raise RuntimeError(
                    "log directory has existing state; call "
                    "restore(session) before attach(session) (or point "
                    "the store at an empty directory)")
            ck = self._read_checkpoint()
            self._gen = int(ck["gen"])
            path = self._gen_path(self._gen)
            valid_end = None
            if path.exists():
                _, _, valid_end, size = read_records(path)
                if valid_end < size:
                    get_tracer().metrics.inc("log.torn_bytes",
                                             size - valid_end)
            self._writer = LogWriter(path, truncate_to=valid_end)
            if not self._checkpoint_path.exists():
                self._write_checkpoint(ck)
            self._session = session
            self._install_hooks(session)
            self._recording = True

    def _install_hooks(self, session) -> None:
        session._session_log = self
        session.memo.hook = self._on_memo_event
        session.embedding_cache.hook = self._on_embedding_insert
        for name, (oracle, _proxy) in session._oracles.items():
            self.bind_oracle(name, oracle)

    def _remove_hooks(self) -> None:
        s = self._session
        if s is None:
            return
        s._session_log = None
        s.memo.hook = None
        s.embedding_cache.hook = None
        for ident in self._idents.values():
            if getattr(ident, "memo_hook", None) is not None:
                ident.memo_hook = None

    def bind_oracle(self, name: str, oracle) -> None:
        """Give ``oracle`` a durable name; hook its memo commits.  Called
        for already-registered oracles at attach and by
        ``Session.register_oracle`` afterwards."""
        ident = oracle_identity(oracle)
        with self._lock:
            self._names[id(ident)] = name
            self._idents[id(ident)] = ident
        try:
            ident.memo_hook = (
                lambda ids, labels, _n=name: self.record_oracle_memo(
                    _n, ids, labels))
        except AttributeError:
            pass  # oracle without a per-id memo (e.g. plain callable)

    def _name_of(self, ident) -> Optional[str]:
        name = self._names.get(id(ident))
        if name is None:
            # registered after the entry's oracle was first sighted —
            # refresh from the session registry before giving up
            if self._session is not None:
                for n, (o, _p) in self._session._oracles.items():
                    self._names.setdefault(id(oracle_identity(o)), n)
                    self._idents.setdefault(id(oracle_identity(o)),
                                            oracle_identity(o))
                name = self._names.get(id(ident))
            if name is None:
                self.n_unnamed_dropped += 1
                get_tracer().metrics.inc("log.unnamed_dropped")
        return name

    # ------------------------------------------------------------- append
    def _append(self, payload: dict) -> None:
        with self._lock:
            if not self._recording or self._writer is None:
                return
            n = self._writer.append(payload)
            self._bytes_since += n
            self._records_since += 1
            if payload["t"] in _MUTATION_KINDS:
                self._carried.append(payload)
        m = get_tracer().metrics
        m.inc("log.records")
        m.inc("log.bytes", n)

    # hook targets ----------------------------------------------------
    def _on_memo_event(self, kind: str, **f) -> None:
        if not self._recording:
            return
        if kind == "decision":
            name = self._name_of(f["ident"])
            if name is None:
                return
            dm: DecisionMemo = f["dm"]
            self._append({
                "t": "decision", "table": f["table"], "oracle": name,
                "version": int(dm.version), "n": int(dm.n),
                "cluster_key": list(dm.cluster_key),
                "fp": list(dm.fingerprint), "mask": dm.mask})
        elif kind == "selectivity":
            name = self._name_of(f["ident"])
            if name is None:
                return
            obs: SelObservation = f["obs"]
            self._append({
                "t": "selectivity", "table": f["table"], "oracle": name,
                "version": int(obs.version),
                "selectivity": float(obs.selectivity),
                "tokens_per_call": float(obs.tokens_per_call)})
        elif kind == "pilot":
            name = self._name_of(f["ident"])
            if name is None:
                return
            self._append({
                "t": "pilot", "table": f["table"], "oracle": name,
                "version": int(f["version"]), "seed": int(f["seed"]),
                "pilot_size": int(f["pilot_size"]),
                "stats": dataclasses.asdict(f["stats"])})
        elif kind == "join":
            name = self._name_of(f["ident"])
            if name is None:
                return
            jm: JoinDecisionMemo = f["jm"]
            self._append({
                "t": "join", "left": f["left"], "right": f["right"],
                "oracle": name, "left_version": int(jm.left_version),
                "right_version": int(jm.right_version),
                "fp": list(jm.fingerprint), "mask": jm.pair_mask})

    def _on_embedding_insert(self, keys: List[str], rows) -> None:
        if self._recording:
            self._append({"t": "emb", "keys": list(keys),
                          "rows": np.asarray(rows, np.float32)})

    def record_oracle_memo(self, name: str, ids, labels) -> None:
        if self._recording:
            self._append({"t": "omemo", "oracle": name,
                          "ids": np.asarray(ids, np.int64),
                          "vals": np.asarray(labels, bool)})

    def record_mutation(self, kind: str, handle, texts=None, embeddings=None,
                        ids=None) -> None:
        if not self._recording:
            return
        payload = {"t": kind, "table": handle.name,
                   "texts": list(texts) if texts is not None else None,
                   "emb": (np.asarray(embeddings, np.float32)
                           if embeddings is not None else None)}
        if ids is not None:
            payload["ids"] = np.asarray(ids, np.int64)
        self._append(payload)

    def record_precluster(self, handle, k: int, seed: int) -> None:
        """A cold k-means fit just happened: log (assign, centroids) so a
        restart replays the clustering instead of re-fitting it (restart
        time must be bounded by the tail, not the table)."""
        if not self._recording:
            return
        cached = handle._table._assign_cache.get((k, seed))
        if cached is None:
            return
        assign, cents = cached
        self._append({"t": "precluster", "table": handle.name,
                      "k": int(k), "seed": int(seed),
                      "version": int(handle.version),
                      "assign": np.asarray(assign),
                      "centroids": np.asarray(cents, np.float32)})

    # ------------------------------------------------------------ restore
    def restore(self, session, strict: bool = False) -> LogRestoreReport:
        """Rebuild ``session`` (tables/oracles registered, base data) from
        carried mutations + compaction snapshot + log tail.  Read-only:
        call ``attach`` afterwards to resume recording."""
        rep = LogRestoreReport()
        ck = self._read_checkpoint()
        self._gen = int(ck["gen"])
        snapshot_offset = ck.get("snapshot_offset")
        path = self._gen_path(self._gen)
        records: List[dict] = []
        ends: List[int] = []
        if path.exists():
            records, ends, valid_end, size = read_records(path)
            rep.torn_bytes = size - valid_end
        self._session = session
        was_recording, self._recording = self._recording, False
        try:
            # locate the snapshot point: records ending at or before it
            # are carried mutations that must replay BEFORE the snapshot
            # load (the snapshot fingerprints post-mutation table content)
            n_carried = 0
            if snapshot_offset is not None:
                while (n_carried < len(ends)
                       and ends[n_carried] <= snapshot_offset):
                    n_carried += 1
            carried, tail = records[:n_carried], records[n_carried:]
            for r in carried:
                self._apply(session, r, rep, strict)
                rep.n_carried_mutations += 1
            if snapshot_offset is not None and self._snap.exists("snapshot"):
                rep.snapshot = self._snap.load(session, tag="snapshot",
                                               strict=strict)
            for r in tail:
                self._apply(session, r, rep, strict)
                rep.n_tail_records += 1
            # mutations seen anywhere must carry forward at next compaction
            self._carried = [r for r in records
                             if r["t"] in _MUTATION_KINDS]
        finally:
            self._recording = was_recording
        m = get_tracer().metrics
        m.inc("log.replayed_records", rep.n_tail_records)
        m.inc("log.carried_mutations", rep.n_carried_mutations)
        m.inc("store.restore_dropped", rep.n_dropped)
        return rep

    def _resolve_oracle(self, session, name: str, rep: LogRestoreReport,
                        strict: bool):
        entry = session._oracles.get(name)
        if entry is None:
            msg = f"oracle {name!r} not registered"
            if strict:
                raise ValueError(f"session log mismatch: {msg}")
            if msg not in rep.skipped:
                rep.skipped.append(msg)
            return None
        ident = oracle_identity(entry[0])
        session.memo._oracles[id(ident)] = ident
        return ident

    def _apply(self, session, r: dict, rep: LogRestoreReport,
               strict: bool) -> None:
        kind = r["t"]
        memo = session.memo
        if kind in _MUTATION_KINDS:
            handle = session._tables.get(r["table"])
            if handle is None:
                msg = f"table {r['table']!r} not registered"
                if strict:
                    raise ValueError(f"session log mismatch: {msg}")
                rep.skipped.append(msg)
                return
            if kind == "append":
                handle.append(texts=r["texts"], embeddings=r["emb"])
            else:
                handle.update(r["ids"], texts=r["texts"],
                              embeddings=r["emb"])
        elif kind == "precluster":
            handle = session._tables.get(r["table"])
            if handle is None:
                rep.skipped.append(f"table {r['table']!r} not registered")
                return
            k, seed = int(r["k"]), int(r["seed"])
            assign = np.asarray(r["assign"])
            cents = np.asarray(r["centroids"], np.float32)
            session._assign_cache[(handle.name, k, seed)] = assign
            handle._table._assign_cache[(k, seed)] = (assign, cents)
            handle._dirty.setdefault(
                (k, seed), np.full(k, int(r["version"]), dtype=np.int64))
        elif kind == "decision":
            ident = self._resolve_oracle(session, r["oracle"], rep, strict)
            if ident is None:
                return
            fp = tuple(r["fp"])
            memo._decisions[(r["table"], id(ident), fp)] = DecisionMemo(
                version=int(r["version"]), n=int(r["n"]),
                mask=np.asarray(r["mask"], bool),
                cluster_key=tuple(r["cluster_key"]), fingerprint=fp)
            memo.note_sighting(r["table"], ident)
        elif kind == "selectivity":
            ident = self._resolve_oracle(session, r["oracle"], rep, strict)
            if ident is None:
                return
            memo._selectivity[(r["table"], id(ident))] = SelObservation(
                version=int(r["version"]),
                selectivity=float(r["selectivity"]),
                tokens_per_call=float(r["tokens_per_call"]))
        elif kind == "pilot":
            ident = self._resolve_oracle(session, r["oracle"], rep, strict)
            if ident is None:
                return
            memo._pilots[(r["table"], id(ident), int(r["version"]),
                          int(r["seed"]), int(r["pilot_size"]))] = \
                PredStats(**r["stats"])
        elif kind == "join":
            ident = self._resolve_oracle(session, r["oracle"], rep, strict)
            if ident is None:
                return
            fp = tuple(r["fp"])
            memo._join_decisions[(r["left"], r["right"], id(ident), fp)] = \
                JoinDecisionMemo(left_version=int(r["left_version"]),
                                 right_version=int(r["right_version"]),
                                 pair_mask=np.asarray(r["mask"], bool),
                                 fingerprint=fp)
            memo.note_pair_oracle(r["left"], ident)
            memo.note_pair_oracle(r["right"], ident)
        elif kind == "emb":
            rows = np.asarray(r["rows"], np.float32)
            for i, key in enumerate(r["keys"]):
                session.embedding_cache._store[key] = rows[i]
        elif kind == "omemo":
            ident = self._resolve_oracle(session, r["oracle"], rep, strict)
            if ident is None or not hasattr(ident, "memo_restore"):
                return
            ident.memo_restore({int(i): bool(v)
                                for i, v in zip(r["ids"], r["vals"])})
        else:
            msg = f"unknown record type {kind!r}"
            if strict:
                raise LogCorruptionError(msg)
            rep.skipped.append(msg)

    # ------------------------------------------------------------- status
    def tail_summary(self) -> dict:
        """WAL tail at a glance (statusz / flight-recorder bundle): which
        generation is live, how far the writer has advanced, and how much
        has accumulated since the last compaction."""
        with self._lock:
            return {
                "dir": str(self.dir),
                "generation": self._gen,
                "attached": self._writer is not None,
                "tail_offset": (self._writer.offset
                                if self._writer is not None else None),
                "bytes_since_compaction": self._bytes_since,
                "records_since_compaction": self._records_since,
                "compact_due": (self._bytes_since >= self.compact_bytes
                                or self._records_since
                                >= self.compact_records),
            }

    # --------------------------------------------------------- compaction
    @property
    def compact_due(self) -> bool:
        return (self._bytes_since >= self.compact_bytes
                or self._records_since >= self.compact_records)

    def compact(self, session=None) -> None:
        """Fold the log into a fresh snapshot + empty tail (see module
        docstring for the crash-safe commit order).  Run at a quiescent
        point — no queries in flight."""
        session = session if session is not None else self._session
        if session is None:
            raise RuntimeError("compact() needs a session (none attached)")
        with self._lock:
            if self._writer is None:
                raise RuntimeError("compact() before attach()")
            new_gen = self._gen + 1
            # (a) new generation, carried mutations at its head
            writer = LogWriter(self._gen_path(new_gen), fresh=True)
            for payload in self._carried:
                writer.append(payload)
            snapshot_offset = writer.offset
            # (b) whole-session snapshot (atomic tmp+rename inside)
            self._snap.save(session, tag="snapshot")
            # (c) commit point: the checkpoint flips restores to the new
            # generation; a crash before this line leaves the old
            # checkpoint + old generation fully usable
            self._write_checkpoint({"schema": LOG_SCHEMA, "gen": new_gen,
                                    "snapshot_offset": snapshot_offset})
            old_writer, self._writer = self._writer, writer
            old_writer.close()
            old_gen, self._gen = self._gen, new_gen
            # (d) best-effort cleanup of superseded generations
            for g in range(old_gen, -1, -1):
                p = self._gen_path(g)
                if not p.exists():
                    break
                try:
                    p.unlink()
                except OSError:
                    pass
            self._bytes_since = 0
            self._records_since = 0
        m = get_tracer().metrics
        m.inc("log.compactions")
        # mark the compaction point so health rules can alert on WAL bytes
        # written since (counter_delta("log.bytes", "log.last_compaction_bytes"))
        m.set("log.last_compaction_bytes",
              getattr(m.counter("log.bytes"), "value", 0.0))

    def compact_if_due(self, session=None) -> bool:
        if self.compact_due:
            self.compact(session)
            return True
        return False

    # -------------------------------------------------------------- close
    def close(self, compact: bool = False) -> None:
        """Stop recording and release the lock.  ``compact=True`` folds
        the tail into a final snapshot first (fastest next restart)."""
        with self._lock:
            if self._writer is None:
                return
            if compact:
                self.compact()
            self._recording = False
            self._remove_hooks()
            self._writer.close()
            self._writer = None
            self._release_lock()

    def abandon(self) -> None:
        """Simulate a crash (tests): drop the writer mid-flight without
        hooks cleanup or compaction, releasing only the OS-level lock the
        dead process would no longer hold."""
        with self._lock:
            if self._writer is None:
                return
            self._recording = False
            self._remove_hooks()
            self._writer.close()
            self._writer = None
            self._release_lock()


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    return True
