"""Disk-persistent restartable sessions: SessionMemo + caches to disk.

A ``Session`` is an optimization scope whose value is the observations it
has accumulated (docs/caching.md): full-table decision masks, pilot
probes, observed selectivities, join pair decisions, the content-hash
embedding cache, the precluster assignments (+ centroids, for post-reload
incremental mutations) and the per-cluster dirty versions.  ``SessionStore``
serializes exactly that state through ``repro_torch.checkpoint.manager`` (msgpack
shards + manifest, atomic rename, zstd/zlib codec) so a new process can
rebuild the session and **replay every previously-collected query at zero
oracle calls, bit-identically** — and, after a post-reload ``append()``/
``update()``, re-vote only the dirty clusters, exactly as an unrestarted
session would.

Identity across processes: in-memory memo keys use ``id(oracle)``; on disk
they use the session's **registered oracle names** (``register_oracle``).
Entries whose oracle was never registered cannot be named durably and are
skipped (reported).  On load, names rebind to the current process's
registered oracle objects.

Versioned invalidation (mirrors the in-memory rules):
- a schema bump invalidates the whole store (clear error, no best-effort);
- each table carries a content fingerprint (texts if present, else
  embedding bytes); a mismatch — the caller rebuilt different data —
  drops every entry touching that table;
- decision/pilot/selectivity entries keep their recorded table versions,
  and handles are restored AT their saved version, so the normal
  dirty-cluster arithmetic applies unchanged after reload.

Per-id oracle memos of registered oracles ride along (the restartable-
driver cache of ``launch/serve.py``, now session-scoped).  Note the flip
RNG of a stochastic oracle is NOT state that can be restored — replays are
bit-identical regardless (no oracle involved), but post-reload *fresh*
evaluation of a ``flip_prob > 0`` oracle agrees with the unrestarted run
only in expectation (same caveat as docs/caching.md).
"""
from __future__ import annotations

import dataclasses
import hashlib
import pathlib
from typing import Dict, List

import numpy as np

from repro_torch.api.memo import (DecisionMemo, JoinDecisionMemo, SelObservation,
                            oracle_identity)
from repro_torch.checkpoint.manager import load_pytree, save_pytree
from repro_torch.obs.trace import get_tracer
from repro_torch.plan.cost import PredStats

STORE_SCHEMA = 1


def table_fingerprint(handle, require_embeddings: bool = False) -> dict:
    """Content hashes of a table's payload, per component:
    ``{"texts": hex | None, "emb": hex | None}``.

    BOTH components are hashed when available — same texts re-embedded by
    a different encoder are different data, and restoring precluster
    state computed in a foreign embedding space would silently corrupt
    dirty-cluster re-votes.  At save time a still-lazy embedding is
    simply absent from the fingerprint; at load time
    ``require_embeddings=True`` (the save hashed them) materializes the
    embeddings — cheap when the store's embedding-cache rows were
    restored first."""
    t = handle._table
    out = {"texts": None, "emb": None}
    if t.texts is not None:
        h = hashlib.blake2b(digest_size=16)
        h.update(f"texts:{len(t.texts)}".encode())
        for s in t.texts:
            h.update(s.encode("utf-8"))
            h.update(b"\x00")
        out["texts"] = h.hexdigest()
    emb = t.embeddings if require_embeddings else t._embeddings
    if emb is not None:
        emb = np.ascontiguousarray(emb, dtype=np.float32)
        h = hashlib.blake2b(digest_size=16)
        h.update(f"emb:{emb.shape}".encode())
        h.update(emb.tobytes())
        out["emb"] = h.hexdigest()
    return out


def _fingerprint_matches(saved: dict, handle) -> bool:
    """Every component the save hashed must match the rebuilt table."""
    cur = table_fingerprint(handle,
                            require_embeddings=saved.get("emb") is not None)
    return all(saved[part] == cur[part]
               for part in ("texts", "emb") if saved.get(part) is not None)


@dataclasses.dataclass
class RestoreReport:
    """What a ``SessionStore.load`` actually rebound.

    ``skipped`` lists entries present in the store that could not be
    rebound onto THIS session (unregistered table/oracle, changed
    content).  ``dropped`` lists entries the SAVE already left out
    (e.g. decisions of an oracle that was never registered under a
    durable name) — previously recorded in the manifest but silently
    discarded at load; warm-start paths surface them so a quiet
    "restored N masks" doesn't hide state that never made it to disk.
    """
    tables: List[str] = dataclasses.field(default_factory=list)
    n_decisions: int = 0
    n_selectivities: int = 0
    n_pilots: int = 0
    n_joins: int = 0
    n_embedding_rows: int = 0
    n_oracle_memo_entries: int = 0
    skipped: List[str] = dataclasses.field(default_factory=list)
    dropped: List[str] = dataclasses.field(default_factory=list)

    def __str__(self) -> str:
        s = (f"restored {len(self.tables)} table(s), "
             f"{self.n_decisions} decision mask(s), "
             f"{self.n_joins} join mask(s), {self.n_pilots} pilot(s), "
             f"{self.n_selectivities} selectivity(ies), "
             f"{self.n_embedding_rows} embedding row(s), "
             f"{self.n_oracle_memo_entries} oracle memo entry(ies)")
        if self.skipped:
            s += f"; skipped: {'; '.join(self.skipped)}"
        if self.dropped:
            s += (f"; {len(self.dropped)} entry(ies) dropped at save: "
                  f"{'; '.join(self.dropped)}")
        return s


class SessionStore:
    """Save/load one session's reusable state under a directory."""

    def __init__(self, directory):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def path(self, tag: str = "session") -> pathlib.Path:
        return self.dir / tag

    def exists(self, tag: str = "session") -> bool:
        return (self.path(tag) / "MANIFEST.json").exists()

    # ----------------------------------------------------------------- save
    def save(self, session, tag: str = "session") -> pathlib.Path:
        memo = session.memo
        arrays: Dict[str, np.ndarray] = {}
        # reverse map: durable names for oracles with stored entries
        name_of = {id(oracle_identity(o)): name
                   for name, (o, _proxy) in session._oracles.items()}

        tables: Dict[str, dict] = {}
        for tname, handle in session._tables.items():
            cluster_keys = []
            for (name, k, seed), assign in session._assign_cache.items():
                if name != tname:
                    continue
                cached = handle._table._assign_cache.get((k, seed))
                cents = cached[1] if cached is not None else np.zeros(
                    (0, 0), np.float32)
                dirty = handle._dirty.get(
                    (k, seed), np.full(k, handle.version, dtype=np.int64))
                arrays[f"table/{tname}/assign/{k}_{seed}"] = assign
                arrays[f"table/{tname}/centroids/{k}_{seed}"] = cents
                arrays[f"table/{tname}/dirty/{k}_{seed}"] = dirty
                cluster_keys.append([int(k), int(seed)])
            tables[tname] = {"version": int(handle.version),
                             "n": int(len(handle)),
                             "fingerprint": table_fingerprint(handle),
                             "cluster_keys": cluster_keys}

        decisions, dropped = [], []
        for (tname, oid, fp), dm in memo._decisions.items():
            oname = name_of.get(oid)
            if oname is None or tname not in tables:
                dropped.append(f"decision on {tname!r} (unregistered oracle)")
                continue
            arrays[f"dec/{len(decisions)}/mask"] = dm.mask
            decisions.append({"table": tname, "oracle": oname,
                              "version": int(dm.version), "n": int(dm.n),
                              "cluster_key": list(dm.cluster_key),
                              "fingerprint": list(fp)})
        selectivities = []
        for (tname, oid), obs in memo._selectivity.items():
            oname = name_of.get(oid)
            if oname is None or tname not in tables:
                continue
            selectivities.append({
                "table": tname, "oracle": oname,
                "version": int(obs.version),
                "selectivity": float(obs.selectivity),
                "tokens_per_call": float(obs.tokens_per_call)})
        pilots = []
        for (tname, oid, version, seed, pilot_size), ps in \
                memo._pilots.items():
            oname = name_of.get(oid)
            if oname is None or tname not in tables:
                continue
            pilots.append({"table": tname, "oracle": oname,
                           "version": int(version), "seed": int(seed),
                           "pilot_size": int(pilot_size),
                           "stats": dataclasses.asdict(ps)})
        joins = []
        for (lname, rname, oid, fp), jm in memo._join_decisions.items():
            oname = name_of.get(oid)
            if oname is None or lname not in tables or rname not in tables:
                dropped.append(f"join {lname!r} x {rname!r} "
                               "(unregistered oracle)")
                continue
            arrays[f"join/{len(joins)}/mask"] = jm.pair_mask
            joins.append({"left": lname, "right": rname, "oracle": oname,
                          "left_version": int(jm.left_version),
                          "right_version": int(jm.right_version),
                          "fingerprint": list(fp)})

        emb_groups: Dict[str, List[str]] = {}
        by_dim: Dict[int, List[str]] = {}
        for key, row in session.embedding_cache._store.items():
            by_dim.setdefault(int(np.asarray(row).shape[0]), []).append(key)
        for g, (dim, keys) in enumerate(sorted(by_dim.items())):
            arrays[f"emb/{g}/rows"] = np.stack(
                [session.embedding_cache._store[k] for k in keys])
            emb_groups[str(g)] = keys

        oracle_memos = []
        for name, (oracle, _proxy) in session._oracles.items():
            target = oracle_identity(oracle)
            snap = (target.memo_snapshot()
                    if hasattr(target, "memo_snapshot") else {})
            if not snap:
                continue
            ids = np.fromiter(snap.keys(), dtype=np.int64, count=len(snap))
            vals = np.fromiter((snap[int(i)] for i in ids), dtype=bool,
                               count=len(snap))
            arrays[f"omemo/{name}/ids"] = ids
            arrays[f"omemo/{name}/vals"] = vals
            oracle_memos.append({"oracle": name, "n": int(len(ids))})

        meta = {"store_schema": STORE_SCHEMA, "tables": tables,
                "decisions": decisions, "selectivities": selectivities,
                "pilots": pilots, "joins": joins, "emb_groups": emb_groups,
                "oracle_memos": oracle_memos, "dropped": dropped}
        save_pytree(arrays, self.path(tag), extra_meta=meta)
        return self.path(tag)

    # ----------------------------------------------------------------- load
    def load(self, session, tag: str = "session",
             strict: bool = False) -> RestoreReport:
        """Rebind saved state onto ``session`` (tables and oracles already
        registered under their original names).  Entries whose table
        fingerprint or oracle name no longer resolves are skipped — or, in
        ``strict`` mode, raise."""
        by_key, meta = load_pytree(self.path(tag))
        if meta.get("store_schema") != STORE_SCHEMA:
            raise ValueError(
                f"session store schema {meta.get('store_schema')!r} does "
                f"not match this build ({STORE_SCHEMA}); re-save the "
                "session (stale stores are invalidated, not migrated)")
        rep = RestoreReport(dropped=list(meta.get("dropped", [])))
        memo = session.memo

        def _skip(msg: str):
            if strict:
                raise ValueError(f"session store mismatch: {msg}")
            rep.skipped.append(msg)

        # embedding cache FIRST: the fingerprint check below may have to
        # materialize a lazy table's embeddings, which should come from
        # the restored cache rows, not a fresh encoder pass
        for g, keys in meta["emb_groups"].items():
            rows = by_key[f"emb/{g}/rows"]
            for r, key in enumerate(keys):
                session.embedding_cache._store[key] = np.array(
                    rows[r], dtype=np.float32)
            rep.n_embedding_rows += len(keys)

        restored_tables = set()
        for tname, tinfo in meta["tables"].items():
            handle = session._tables.get(tname)
            if handle is None:
                _skip(f"table {tname!r} not registered")
                continue
            if len(handle) != tinfo["n"]:
                _skip(f"table {tname!r} has {len(handle)} rows, "
                      f"store expects {tinfo['n']}")
                continue
            if not _fingerprint_matches(tinfo["fingerprint"], handle):
                _skip(f"table {tname!r} content changed since the save")
                continue
            handle.version = int(tinfo["version"])
            for k, seed in tinfo["cluster_keys"]:
                assign = np.array(by_key[f"table/{tname}/assign/{k}_{seed}"])
                cents = np.array(
                    by_key[f"table/{tname}/centroids/{k}_{seed}"])
                dirty = np.array(by_key[f"table/{tname}/dirty/{k}_{seed}"],
                                 dtype=np.int64)
                session._assign_cache[(tname, int(k), int(seed))] = assign
                handle._dirty[(int(k), int(seed))] = dirty
                if cents.size:
                    handle._table._assign_cache[(int(k), int(seed))] = (
                        assign, cents)
            restored_tables.add(tname)
            rep.tables.append(tname)

        def _oracle(name: str):
            entry = session._oracles.get(name)
            if entry is None:
                _skip(f"oracle {name!r} not registered")
                return None
            ident = oracle_identity(entry[0])
            memo._oracles[id(ident)] = ident
            return ident

        for i, d in enumerate(meta["decisions"]):
            if d["table"] not in restored_tables:
                continue
            ident = _oracle(d["oracle"])
            if ident is None:
                continue
            fp = tuple(d["fingerprint"])
            memo._decisions[(d["table"], id(ident), fp)] = DecisionMemo(
                version=d["version"], n=d["n"],
                mask=np.array(by_key[f"dec/{i}/mask"], dtype=bool),
                cluster_key=tuple(d["cluster_key"]), fingerprint=fp)
            memo.note_sighting(d["table"], ident)
            rep.n_decisions += 1
        for s in meta["selectivities"]:
            if s["table"] not in restored_tables:
                continue
            ident = _oracle(s["oracle"])
            if ident is None:
                continue
            memo._selectivity[(s["table"], id(ident))] = SelObservation(
                version=s["version"], selectivity=s["selectivity"],
                tokens_per_call=s["tokens_per_call"])
            rep.n_selectivities += 1
        for p in meta["pilots"]:
            if p["table"] not in restored_tables:
                continue
            ident = _oracle(p["oracle"])
            if ident is None:
                continue
            memo._pilots[(p["table"], id(ident), p["version"], p["seed"],
                          p["pilot_size"])] = PredStats(**p["stats"])
            rep.n_pilots += 1
        for i, j in enumerate(meta["joins"]):
            if (j["left"] not in restored_tables
                    or j["right"] not in restored_tables):
                continue
            ident = _oracle(j["oracle"])
            if ident is None:
                continue
            fp = tuple(j["fingerprint"])
            memo._join_decisions[(j["left"], j["right"], id(ident), fp)] = \
                JoinDecisionMemo(
                    left_version=j["left_version"],
                    right_version=j["right_version"],
                    pair_mask=np.array(by_key[f"join/{i}/mask"], dtype=bool),
                    fingerprint=fp)
            memo.note_pair_oracle(j["left"], ident)
            memo.note_pair_oracle(j["right"], ident)
            rep.n_joins += 1

        for om in meta["oracle_memos"]:
            ident = _oracle(om["oracle"])
            if ident is None or not hasattr(ident, "memo_restore"):
                continue
            ids = by_key[f"omemo/{om['oracle']}/ids"]
            vals = by_key[f"omemo/{om['oracle']}/vals"]
            ident.memo_restore({int(i): bool(v)
                                for i, v in zip(ids, vals)})
            rep.n_oracle_memo_entries += len(ids)
        if rep.dropped or rep.skipped:
            get_tracer().metrics.inc("store.restore_dropped",
                                     len(rep.dropped) + len(rep.skipped))
        return rep
