"""SIGTERM as a preemption flag: a copy of ``install_preemption_handler``
and ``preempted`` of ``neural_marionette_tpu/parallel/distributed.py``.

The training CLI polls :func:`preempted` after each epoch and, when it is
set, saves a checkpoint and exits before the machine goes away."""
from __future__ import annotations

import signal
import threading

_preempted = threading.Event()


def install_preemption_handler() -> threading.Event:
    """SIGTERM -> preemption flag (call from the main thread)."""
    def _handler(signum, frame):
        _preempted.set()

    signal.signal(signal.SIGTERM, _handler)
    return _preempted


def preempted() -> bool:
    return _preempted.is_set()
