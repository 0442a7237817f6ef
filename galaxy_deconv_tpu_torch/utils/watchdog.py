"""Stall watchdog (counterpart of ``galaxy_deconv_tpu/utils/watchdog.py``).

A training process can block for ever inside a device call that never
returns (a wedged device call, a lost collective) while raising nothing, so
no try/except sees it.  :class:`StallWatchdog` is a daemon thread that the
trainer ``beat()``s after every completed step; when no beat arrives for
``timeout_s`` it calls ``on_stall(name, elapsed_s)``, by default logging a
CRITICAL line and hard-exiting with :data:`STALL_EXIT_CODE`, so a supervising
loop can restart from the last checkpoint.  The exit is hard because the
blocked thread sits in a C call that Python cannot interrupt.

Usage::

    with StallWatchdog(timeout_s=300, name="train") as dog:
        for step in range(n):
            state, loss = train_step(state, batch)   # may block for ever
            dog.beat()
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional

logger = logging.getLogger("galaxy_deconv_tpu_torch.utils.watchdog")

#: exit status of the default on_stall (EX_TEMPFAIL: transient, retry from the
#: last checkpoint)
STALL_EXIT_CODE = 75


def _default_on_stall(name: str, elapsed: float) -> None:
    logger.critical("watchdog '%s': no progress for %.0fs; the device call is presumed wedged; exiting with "
                    "status %d for a supervisor to restart", name, elapsed, STALL_EXIT_CODE)
    os._exit(STALL_EXIT_CODE)


class StallWatchdog:
    """Daemon-thread progress monitor.  ``beat()`` after each unit of
    progress; ``on_stall(name, elapsed_s)`` fires once if beats stop for
    longer than ``timeout_s``.  ``timeout_s=None`` disables it (no thread)."""

    def __init__(self, timeout_s: Optional[float], name: str = "watchdog",
                 on_stall: Callable[[str, float], None] = _default_on_stall, poll_s: Optional[float] = None):
        self.timeout_s = timeout_s
        self.name = name
        self.on_stall = on_stall
        self.poll_s = poll_s if poll_s is not None else (min(5.0, timeout_s / 4.0) if timeout_s else 5.0)
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self) -> None:
        self._last = time.monotonic()

    def start(self) -> "StallWatchdog":
        if self.timeout_s and self._thread is None:
            self._last = time.monotonic()
            self._thread = threading.Thread(target=self._run, name=self.name, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.poll_s)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            elapsed = time.monotonic() - self._last
            if elapsed > self.timeout_s:
                self.on_stall(self.name, elapsed)
                return

    def __enter__(self) -> "StallWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
