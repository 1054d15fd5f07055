"""Checkpointing from scratch (no orbax offline): msgpack + zstd/zlib, atomic.

Layout per step:
    <dir>/step_<n>.tmp-<nonce>/   — written first
        shard_000.msgpack.<codec> — leaf payloads (chunked)
        MANIFEST.json             — tree structure, shapes, dtypes, checksums
    <dir>/step_<n>/               — atomic rename on completion

Compression: zstd when the ``zstandard`` package is importable, otherwise a
stdlib ``zlib`` fallback.  The codec is recorded in the manifest so restores
pick the right decompressor; requesting ``codec="zstd"`` explicitly without
the package installed is a clear error (not a silent downgrade).

Fault-tolerance properties:
- a crash mid-write leaves only a .tmp dir (ignored on restore);
- ``latest_step`` picks the newest *committed* checkpoint;
- restore casts onto a caller's template tree (numpy arrays or tensors,
  each leaf restored with the template leaf's dtype and device), and with
  a ``shardings`` tree places each leaf as a DTensor on any mesh: the
  elastic restore (a checkpoint holds whole tensors, so a run saved on
  one mesh resumes on another);
- a DTensor leaf is saved whole (gathered from its shards), so the files
  are byte for byte what an unsharded save writes, and in a process group
  only rank 0 writes;
- async=True saves on a background thread (training continues), with
  ``wait()`` joining before the next save — checkpoint/compute overlap.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import zlib

import msgpack
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.distributed.api import place
from repro_torch.utils.timing import monotonic
from repro_torch.utils.tree import tree_leaves_with_path, tree_map

try:  # optional: zstd gives better ratios, zlib keeps the module importable
    import zstandard as zstd
except ImportError:  # pragma: no cover - depends on the environment
    zstd = None

_SHARD_EXT = {"zstd": ".zst", "zlib": ".zlib", "none": ".raw"}


def _default_codec() -> str:
    return "zstd" if zstd is not None else "zlib"


def _require_codec(codec: str):
    """Validate a write-side codec request (fail before any file I/O)."""
    if codec not in _SHARD_EXT:
        raise ValueError(f"unknown checkpoint codec: {codec!r}")
    if codec == "zstd" and zstd is None:
        raise ModuleNotFoundError(
            "checkpoint codec 'zstd' requested but the 'zstandard' "
            "package is not installed; install it or use codec='zlib'")


def _compress(blob: bytes, codec: str) -> bytes:
    _require_codec(codec)
    if codec == "zstd":
        return zstd.ZstdCompressor(level=3).compress(blob)
    if codec == "zlib":
        return _zlib_compress(blob)
    return blob


ZLIB_PIECE = 64 << 20  # bytes of a blob that one thread deflates
_ZLIB_WINDOW = 32 << 10


def _zlib_compress(blob: bytes) -> bytes:
    """zlib at level 6, a large blob's pieces deflated by parallel threads.

    As pigz does: each ``ZLIB_PIECE`` is a raw deflate stream primed with
    the 32 KiB before it (the window a back-reference may reach) and
    ended on a byte boundary (``Z_SYNC_FLUSH``), the last with
    ``Z_FINISH``; the pieces go between the zlib header and the adler-32
    of the whole blob.  The result is one zlib stream, which
    ``zlib.decompress`` (and so the reference's reader) takes as it
    takes ``zlib.compress``'s.  zlib releases the interpreter lock while
    it deflates, so the threads run side by side: one thread deflates
    bf16 weights held as float32 slowly enough that a full-width train
    state would take minutes (PERF.md gives the rates)."""
    n = len(blob)
    if n <= ZLIB_PIECE:
        return zlib.compress(blob, level=6)
    view = memoryview(blob)
    starts = range(0, n, ZLIB_PIECE)

    def deflate(lo: int) -> bytes:
        kw = {"zdict": view[lo - _ZLIB_WINDOW:lo]} if lo else {}
        c = zlib.compressobj(6, zlib.DEFLATED, -15, **kw)
        hi = min(lo + ZLIB_PIECE, n)
        return c.compress(view[lo:hi]) + c.flush(
            zlib.Z_FINISH if hi == n else zlib.Z_SYNC_FLUSH)

    with ThreadPoolExecutor(min(len(starts), os.cpu_count() or 1)) as ex:
        pieces = list(ex.map(deflate, starts))
    return b"".join([b"\x78\x9c", *pieces,
                     zlib.adler32(blob).to_bytes(4, "big")])


def _decompress(blob: bytes, codec: str) -> bytes:
    if codec == "zstd":
        if zstd is None:
            raise ModuleNotFoundError(
                "checkpoint was written with zstd but the 'zstandard' "
                "package is not installed; install it to restore")
        return zstd.ZstdDecompressor().decompress(blob)
    if codec == "zlib":
        return zlib.decompress(blob)
    if codec == "none":
        return blob
    raise ValueError(f"unknown checkpoint codec: {codec!r}")


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as a host array; a bfloat16 tensor as its float32 values
    (numpy has no bfloat16; a template restores the type).  A DTensor is
    gathered whole first (every rank of its mesh takes part)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def save_pytree(tree, path: pathlib.Path, extra_meta: dict = None,
                codec: Optional[str] = None):
    path = pathlib.Path(path)
    codec = codec or _default_codec()
    _require_codec(codec)  # fail before the tmp dir is created
    # genuine wall-clock uses (unique tmp name, "created" metadata) — the
    # TID251 duration-clock ban does not apply
    tmp = path.with_name(path.name + f".tmp-{os.getpid()}-{int(time.time()*1e3)}")  # noqa: TID251
    tmp.mkdir(parents=True, exist_ok=False)
    flat = tree_leaves_with_path(tree)
    manifest = {"leaves": [], "extra": extra_meta or {},
                "created": time.time(), "codec": codec}  # noqa: TID251
    shard_path = tmp / ("shard_000.msgpack" + _SHARD_EXT[codec])
    records = []
    for key, leaf in flat:
        arr = _to_numpy(leaf)
        payload = arr.tobytes()
        records.append({"key": key, "shape": list(arr.shape),
                        "dtype": str(arr.dtype), "data": payload})
        manifest["leaves"].append({
            "key": key, "shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha1": hashlib.sha1(payload).hexdigest()})
    blob = _compress(msgpack.packb(records, use_bin_type=True), codec)
    shard_path.write_bytes(blob)
    (tmp / "MANIFEST.json").write_text(json.dumps(manifest, indent=1))
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)  # atomic commit


def load_pytree(path: pathlib.Path, template=None, shardings=None,
                verify: bool = True):
    """Restore ``(tree, extra)``.  Without a template the tree is a flat
    ``{key: array}`` dict; with one, every leaf takes the template leaf's
    dtype (and device, for a tensor).  ``shardings`` (with a template)
    mirrors the template down to its leaves, each ``(DeviceMesh,
    placements)`` or None: a leaf with a mesh comes back as a DTensor
    with those placements, each rank keeping its own block (the elastic
    restore); None, or no ``shardings``, gives a whole tensor."""
    path = pathlib.Path(path)
    manifest = json.loads((path / "MANIFEST.json").read_text())
    codec = manifest.get("codec", "zstd")  # pre-codec checkpoints were zstd
    if codec not in _SHARD_EXT:
        raise ValueError(f"unknown checkpoint codec: {codec!r}")
    shard = path / ("shard_000.msgpack" + _SHARD_EXT[codec])
    records = msgpack.unpackb(_decompress(shard.read_bytes(), codec),
                              raw=False)
    by_key = {}
    for rec, meta in zip(records, manifest["leaves"]):
        if verify and hashlib.sha1(rec["data"]).hexdigest() != meta["sha1"]:
            raise ValueError(f"checksum mismatch at {rec['key']}")
        arr = np.frombuffer(rec["data"], dtype=np.dtype(rec["dtype"])
                            ).reshape(rec["shape"])
        by_key[rec["key"]] = arr

    if template is None:
        return by_key, manifest["extra"]
    keys = iter(k for k, _ in tree_leaves_with_path(template))

    def restore(tmpl, sh=None):
        arr = by_key[next(keys)]
        if not isinstance(tmpl, torch.Tensor):
            return arr.astype(np.asarray(tmpl).dtype)
        t = torch.from_numpy(arr.copy()).to(tmpl.device, tmpl.dtype)
        return t if sh is None else place(t, *sh)

    if shardings is None:
        return tree_map(restore, template), manifest["extra"]
    return tree_map(restore, template, shardings), manifest["extra"]


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.saves: list = []

    def step_path(self, step: int) -> pathlib.Path:
        return self.dir / f"step_{step:08d}"

    def latest_step(self) -> Optional[int]:
        steps = []
        for p in self.dir.glob("step_*"):
            if p.name.endswith(".json") or ".tmp-" in p.name:
                continue
            try:
                steps.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return max(steps) if steps else None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree, extra_meta: dict = None,
             async_: bool = False):
        """Snapshot ``tree`` to host arrays, then write it (on a thread
        with ``async_``).  Each save appends ``{"step", "snapshot_s",
        "write_s", "bytes"}`` to ``self.saves`` once written."""
        self.wait()
        t0 = monotonic()
        host_tree = tree_map(_to_numpy, tree)  # snapshot
        snapshot_s = monotonic() - t0
        if dist.is_initialized() and dist.get_rank() != 0:
            return  # every rank gathers; rank 0 writes

        def work():
            t1 = monotonic()
            save_pytree(host_tree, self.step_path(step),
                        dict(extra_meta or {}, step=step))
            self.saves.append({
                "step": step, "snapshot_s": snapshot_s,
                "write_s": monotonic() - t1,
                "bytes": sum(f.stat().st_size
                             for f in self.step_path(step).iterdir())})
            self._gc()

        if async_:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def restore(self, template=None, shardings=None, step: int = None):
        """(step, tree, extra) of checkpoint ``step`` (the newest by
        default), or (None, None, None) without one; ``template`` and
        ``shardings`` as ``load_pytree``'s."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None, None
        tree, extra = load_pytree(self.step_path(step), template, shardings)
        return step, tree, extra

    def _gc(self):
        steps = sorted(p for p in self.dir.glob("step_*")
                       if ".tmp-" not in p.name)
        for p in steps[:-self.keep]:
            shutil.rmtree(p, ignore_errors=True)
        # clean stale tmp dirs from crashed writers
        for p in self.dir.glob("*.tmp-*"):
            shutil.rmtree(p, ignore_errors=True)
