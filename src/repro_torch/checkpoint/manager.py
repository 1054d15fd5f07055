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
  each leaf restored with the template leaf's dtype and device);
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
from typing import Optional

import zlib

import msgpack
import numpy as np
import torch

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
        return zlib.compress(blob, level=6)
    return blob


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


def _flatten_with_paths(tree, prefix=()):
    """``(key, leaf)`` pairs in the reference's ``jax.tree_util`` order:
    dict keys sorted, list and tuple items by index, ``None`` an empty
    subtree; a key is the path's parts joined by ``/``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, sub in enumerate(tree)
                for kv in _flatten_with_paths(sub, prefix + (i,))]
    return [("/".join(str(p) for p in prefix), tree)]


def _map_leaves(tree, fn):
    """``tree`` with every leaf replaced by ``fn(leaf)`` (same structure);
    leaves are visited in ``_flatten_with_paths`` order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(tree[k], fn) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn) for v in tree)
    return fn(tree)


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as a host array; a bfloat16 tensor as its float32 values
    (numpy has no bfloat16; a template restores the type)."""
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
    flat = _flatten_with_paths(tree)
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


def load_pytree(path: pathlib.Path, template=None, verify: bool = True):
    """Restore ``(tree, extra)``.  Without a template the tree is a flat
    ``{key: array}`` dict; with one, every leaf takes the template leaf's
    dtype (and device, for a tensor)."""
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
    keys = iter(k for k, _ in _flatten_with_paths(template))

    def restore(tmpl):
        arr = by_key[next(keys)]
        if isinstance(tmpl, torch.Tensor):
            return torch.from_numpy(arr.copy()).to(tmpl.device, tmpl.dtype)
        return arr.astype(np.asarray(tmpl).dtype)

    return _map_leaves(template, restore), manifest["extra"]


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

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
        self.wait()
        host_tree = _map_leaves(tree, _to_numpy)  # snapshot

        def work():
            save_pytree(host_tree, self.step_path(step),
                        dict(extra_meta or {}, step=step))
            self._gc()

        if async_:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def restore(self, template=None, step: int = None):
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None, None
        tree, extra = load_pytree(self.step_path(step), template)
        return step, tree, extra

    def _gc(self):
        steps = sorted(p for p in self.dir.glob("step_*")
                       if ".tmp-" not in p.name)
        for p in steps[:-self.keep]:
            shutil.rmtree(p, ignore_errors=True)
        # clean stale tmp dirs from crashed writers
        for p in self.dir.glob("*.tmp-*"):
            shutil.rmtree(p, ignore_errors=True)
