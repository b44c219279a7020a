"""Preemption watcher (port of ``sheeprl_tpu/resilience/preemption.py``,
one process).

SIGTERM and SIGINT set a flag that the train loop polls at the top of each
update; the loop then writes an emergency checkpoint and the run exits with
:data:`PREEMPTED_EXIT_CODE`, which a supervisor tells apart from success (0)
and from a crash. A second SIGINT while draining raises ``KeyboardInterrupt``.
"""

from __future__ import annotations

import signal
import threading

# preempted after a committed emergency checkpoint: safe to restart with
# checkpoint.resume_from=auto
PREEMPTED_EXIT_CODE = 77

_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class PreemptionWatcher:
    def __init__(self) -> None:
        self._requested = False
        self.signum = 0
        self._old_handlers: dict = {}
        self.installed = False

    def install(self) -> "PreemptionWatcher":
        """Install the handlers; a no-op off the main thread, where Python
        allows no signal handler."""
        if self.installed or threading.current_thread() is not threading.main_thread():
            return self
        for sig in _SIGNALS:
            self._old_handlers[sig] = signal.signal(sig, self._handle)
        self.installed = True
        return self

    def uninstall(self) -> None:
        if not self.installed:
            return
        for sig, old in self._old_handlers.items():
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):
                pass
        self._old_handlers.clear()
        self.installed = False

    def _handle(self, signum, frame) -> None:
        if self._requested and signum == signal.SIGINT:
            self.uninstall()
            raise KeyboardInterrupt
        self._requested = True
        self.signum = int(signum)

    @property
    def requested(self) -> bool:
        return self._requested
