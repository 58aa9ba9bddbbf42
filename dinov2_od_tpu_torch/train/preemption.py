"""Preemption-safe training: SIGTERM -> checkpoint -> clean exit
(counterpart of dinov2_od_tpu/train/preemption.py).

Managed clusters deliver SIGTERM with a short grace window before they
kill the process. The reference loses everything since its last
epoch-cadence save; here a guard turns the signal into a synchronous
checkpoint at the next step boundary and a clean return, and `--checkpoint`
resumes the interrupted epoch at the batch it reached.

The handler only sets a flag: the device sync and the save happen on the
main thread at a step boundary, never inside the signal handler.
"""

from __future__ import annotations

import logging
import signal
import threading

logger = logging.getLogger(__name__)


class PreemptionGuard:
    """Context manager that latches listed signals into a flag.

    Usage:
        with PreemptionGuard() as guard:
            for step in ...:
                ...
                if guard.triggered:
                    save(); break

    Installs handlers only from the main thread (signal module
    restriction); elsewhere it degrades to a never-triggered flag. A
    second signal while the flag is already set falls through to the
    previous handler (default: kill) — the escape hatch if the save
    itself wedges."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._previous = {}

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def _handle(self, signum, frame):
        if self._event.is_set():
            prev = self._previous.get(signum)
            if callable(prev):
                return prev(signum, frame)
            # SIG_DFL for SIGTERM: terminate now.
            signal.signal(signum, signal.SIG_DFL)
            return signal.raise_signal(signum)
        logger.warning(
            "received signal %d: will checkpoint and exit at the next "
            "step boundary (send again to terminate immediately)", signum
        )
        self._event.set()

    def install(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            for s in self._signals:
                self._previous[s] = signal.signal(s, self._handle)
        return self

    def uninstall(self) -> None:
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False
