"""Graceful preemption: finish the step, checkpoint, exit clean.

Port of ``myconvnet_tpu/utils/preemption.py``: :class:`PreemptionGuard`
latches SIGTERM/SIGINT (and a manual :meth:`trigger`) into a flag that
``Trainer.fit`` polls once a step; on a signal it stops enqueueing steps,
saves the full state and returns, so ``--max_restarts`` / ``--resume``
continue where it left off.
"""

from __future__ import annotations

import signal
import threading


class PreemptionGuard:
    """A context manager: the previous handlers come back on exit.  A
    second SIGINT raises KeyboardInterrupt."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = signals
        self._event = threading.Event()
        self._prev = {}
        self._hits = 0

    def __enter__(self) -> "PreemptionGuard":
        for s in self._signals:
            try:
                self._prev[s] = signal.signal(s, self._on_signal)
            except ValueError:
                # not the main thread: trigger() still works
                pass
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev.clear()
        return False

    def _on_signal(self, signum, frame):
        self._hits += 1
        if signum == signal.SIGINT and self._hits > 1:
            raise KeyboardInterrupt
        self._event.set()

    def trigger(self) -> None:
        """Preempt by hand (tests, external watchers)."""
        self._event.set()

    @property
    def preempted(self) -> bool:
        return self._event.is_set()
