"""Graceful shutdown for long-running entry points (serve.py, watch.py).

A ``GracefulShutdown`` installs SIGINT/SIGTERM handlers that run a set of
registered cleanup callbacks exactly once — a final ``SessionStore``
checkpoint, a sink flush — before the process exits, so killing a service
or a stream watcher never loses acknowledged state.  Two consumption
modes:

- **exit mode** (``exit_on_signal=True``, the serve.py default): the
  handler runs the callbacks and raises ``SystemExit(128 + signum)`` —
  the conventional fatal-signal exit code — from wherever the main thread
  happened to be.
- **flag mode** (``exit_on_signal=False``, the watch.py default): the
  handler runs the callbacks and sets ``requested``; a tick loop checks
  ``requested`` between ticks and winds down at a tick boundary, so the
  checkpoint it wrote is never followed by a half-applied tick.

Cleanup callbacks run in registration order and are idempotent at the
manager level: however many signals arrive (or whether ``close()`` also
runs at normal exit), each callback fires once.  A failing callback is
logged to stderr and does not block the remaining ones — shutdown must
make progress even when a sink is wedged.

Tests drive the handler in-process (``trigger()``) instead of delivering
real signals; see tests/test_torch_service.py.
"""
from __future__ import annotations

import signal
import sys
import threading
from typing import Callable, List, Optional


class GracefulShutdown:
    """Run registered cleanups once on SIGINT/SIGTERM (or ``close()``)."""

    SIGNALS = (signal.SIGINT, signal.SIGTERM)

    def __init__(self, exit_on_signal: bool = True):
        self.exit_on_signal = exit_on_signal
        self.requested = False          # flag-mode loops poll this
        self.signum: Optional[int] = None
        self._callbacks: List[tuple] = []   # (label, fn), fire-once order
        self._done = set()                  # labels already fired
        self._lock = threading.Lock()
        self._previous: dict = {}
        self._installed = False

    # ------------------------------------------------------------ wiring
    def register(self, label: str, fn: Callable[[], None]) -> None:
        """Add a cleanup; ``label`` names it in error output and keys the
        fire-once bookkeeping (re-registering a label replaces the fn)."""
        with self._lock:
            self._callbacks = [(lb, f) for lb, f in self._callbacks
                               if lb != label]
            self._callbacks.append((label, fn))
            self._done.discard(label)

    def install(self) -> "GracefulShutdown":
        """Install the signal handlers (main thread only — Python delivers
        signals there).  Previous handlers are saved and restored by
        ``close()``.  Off the main thread (a test driving the entry point
        in-process) installation is skipped: ``trigger()`` still works."""
        if threading.current_thread() is threading.main_thread():
            for sig in self.SIGNALS:
                self._previous[sig] = signal.signal(sig, self._handler)
            self._installed = True
        return self

    # ---------------------------------------------------------- shutdown
    def _handler(self, signum, frame) -> None:
        self.trigger(signum)
        if self.exit_on_signal:
            raise SystemExit(128 + signum)

    def trigger(self, signum: int = signal.SIGTERM) -> None:
        """The handler body, callable in-process (tests, supervisors):
        mark shutdown requested and run the cleanups once."""
        self.signum = signum
        self.requested = True
        self._run_callbacks()

    def _run_callbacks(self) -> None:
        with self._lock:
            todo = [(lb, f) for lb, f in self._callbacks
                    if lb not in self._done]
            self._done.update(lb for lb, _ in todo)
        for label, fn in todo:
            try:
                fn()
            except BaseException as e:   # keep shutting down regardless
                print(f"[shutdown] cleanup {label!r} failed: "
                      f"{type(e).__name__}: {e}", file=sys.stderr)

    def close(self) -> None:
        """Normal-exit path: run any cleanups that have not fired yet and
        restore the previous signal handlers."""
        self._run_callbacks()
        if self._installed:
            for sig, prev in self._previous.items():
                signal.signal(sig, prev)
            self._installed = False

    def __enter__(self) -> "GracefulShutdown":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.close()
