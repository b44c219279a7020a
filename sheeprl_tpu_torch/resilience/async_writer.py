"""Background checkpoint writer (port of
``sheeprl_tpu/resilience/async_writer.py``, without its telemetry).

The caller takes a host snapshot of the state, then hands a zero-argument
``write_fn`` to :meth:`AsyncCheckpointWriter.submit`: serialization, commit
and pruning run on a daemon thread, so the train loop pays for the snapshot
only. At most one save is in flight: a submit that arrives while a write
runs is dropped (counted in ``skipped``), and the next interval saves
fresher state. A failed write never kills the run: it is warned, kept in
``last_error``, and the next ``drain`` returns normally.
"""

from __future__ import annotations

import threading
import warnings
from typing import Callable, Optional

_writer_lock = threading.Lock()
_writer: Optional["AsyncCheckpointWriter"] = None


class AsyncCheckpointWriter:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None
        self.submitted = 0
        self.skipped = 0

    @property
    def busy(self) -> bool:
        with self._lock:
            t = self._thread
        return t is not None and t.is_alive()

    @property
    def last_error(self) -> Optional[BaseException]:
        return self._last_error

    def record_skip(self) -> None:
        """Count a save request dropped because a write was in flight."""
        self.skipped += 1

    def submit(self, write_fn: Callable[[], None], *, path: str = "") -> bool:
        """Run ``write_fn`` on the background thread; ``False`` (and a skip)
        when a write is still in flight."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                self.record_skip()
                return False
            self.submitted += 1
            self._thread = threading.Thread(target=self._run, args=(write_fn, path), name="ckpt-writer", daemon=True)
            self._thread.start()
            return True

    def _run(self, write_fn: Callable[[], None], path: str) -> None:
        try:
            write_fn()
        except BaseException as exc:  # a failed save must not kill the run
            self._last_error = exc
            warnings.warn(f"async checkpoint write for {path!r} failed: {exc!r}")

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait for the write in flight, if any; ``True`` when none remains."""
        with self._lock:
            t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        return not self.busy


def get_async_writer() -> AsyncCheckpointWriter:
    """The process-wide writer: one save in flight per process."""
    global _writer
    with _writer_lock:
        if _writer is None:
            _writer = AsyncCheckpointWriter()
        return _writer


def drain_async_checkpoints(timeout: Optional[float] = None) -> bool:
    """Join the save in flight, if a writer exists."""
    w = _writer
    return w.drain(timeout) if w is not None else True
