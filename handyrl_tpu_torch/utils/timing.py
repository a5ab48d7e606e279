"""Per-stage wall-clock accounting for the learner's ingest path (the
port of ``handyrl_tpu/utils/timing.py``).

The host learner's path crosses several hand-off points (episode
selection -> bz2 decode -> batch assembly -> batcher IPC -> host-to-device
staging -> the launch of the graphed update step -> the host waiting on
the card), and a regression in any one of them hides inside an aggregate
episodes/s. ``StageTimer`` accumulates wall seconds and event counts per
named stage from any thread, and ``HANDYRL_TPU_TIMING=1`` prints one
compact JSON line an epoch with the breakdown.

Stage names (``telemetry.INGEST_STAGES``):
  select / decode / assemble / ipc / h2d / dispatch / host_block

On the port ``dispatch`` is the host time to launch the graphed update
step (its replay returns as soon as the work is queued on the card) and
``host_block`` the time the host then waits for the card (the fetch of
the step's losses). Their ratio is the device-utilization proxy of the
compiled-performance plane.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict

from .. import telemetry


class StageTimer:
    """Thread-safe accumulator of per-stage wall time.

    ``add`` is cheap (one lock acquisition); the timed sections themselves
    run unlocked, so batcher threads never serialize on the timer.

    ``registry`` (a telemetry.MetricRegistry) mirrors every ``add`` into
    the ``stage_seconds{stage=...}`` span-histogram family, so the same
    measurements that feed the per-epoch timing line also feed the
    exporter's view, and, with tracing on (``HANDYRL_TPU_TRACE``), each
    mirrored add also lands as a rate-sampled batch-level span in the
    trace file (one vocabulary for timing lines, histograms and traces).
    """

    def __init__(self, registry=None):
        self._lock = threading.Lock()
        self._acc: Dict[str, float] = {}
        self._n: Dict[str, int] = {}
        self._registry = registry

    def add(self, stage: str, seconds: float, count: int = 1):
        with self._lock:
            self._acc[stage] = self._acc.get(stage, 0.0) + seconds
            self._n[stage] = self._n.get(stage, 0) + count
        if self._registry is not None:
            self._registry.observe_stage(stage, seconds, count)
            telemetry.trace_stage(stage, seconds, count)

    @contextmanager
    def section(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(stage, time.perf_counter() - t0)

    def snapshot(self, reset: bool = False) -> Dict[str, Dict[str, float]]:
        """{stage: {'s': total_seconds, 'n': events}} at this instant."""
        with self._lock:
            out = {k: {'s': round(self._acc[k], 4), 'n': self._n.get(k, 0)}
                   for k in self._acc}
            if reset:
                self._acc.clear()
                self._n.clear()
        return out

    def seconds(self, stage: str) -> float:
        with self._lock:
            return self._acc.get(stage, 0.0)


def null_section(_stage):
    """A no-op replacement for ``StageTimer.section`` when timing is off."""
    return _NULL


class _NullCtx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()
