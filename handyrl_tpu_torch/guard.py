"""Preemption guard: SIGTERM/SIGINT become a cooperative stop flag (the
subset of ``handyrl_tpu/guard.py`` the serving path uses).

A process that drains on the flag and exits with :data:`PREEMPT_EXIT_CODE`
tells its supervisor "done cleanly, restart me". A third signal is an
operator override and exits at once with ``128 + signum``.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Any, Dict, Optional

# EX_TEMPFAIL: the supervisor contract of a drained, restartable process
PREEMPT_EXIT_CODE = 75


class PreemptionGuard:
    """SIGTERM/SIGINT -> cooperative stop flag (checked at safe points).

    ``install`` is a no-op off the main thread (the CPython signal API
    requirement); ``uninstall`` restores the previous handlers."""

    def __init__(self):
        self.signum: Optional[int] = None
        self._event = threading.Event()
        self._count = 0
        self._previous: Dict[int, Any] = {}

    def install(self) -> 'PreemptionGuard':
        if self._previous or \
                threading.current_thread() is not threading.main_thread():
            return self
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._previous[sig] = signal.signal(sig, self._handle)
        return self

    def uninstall(self):
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous = {}

    def _handle(self, signum, frame):
        self._count += 1
        self.signum = signum
        self._event.set()
        if self._count >= 3:
            os._exit(128 + signum)

    def requested(self) -> bool:
        return self._event.is_set()
