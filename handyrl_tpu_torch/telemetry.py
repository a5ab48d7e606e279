"""In-process telemetry: a leveled logger and a metric registry.

The subset of ``handyrl_tpu/telemetry.py`` the serving path and the
learner use: one process-global :class:`MetricRegistry` of labeled
counters, gauges and fixed-bucket histograms with a plain-data
``snapshot``, :func:`summarize` (the compact form a ``metrics_jsonl`` row
carries), :func:`run_id` and :func:`get_logger`. The same environment variables switch them:
``HANDYRL_TPU_TELEMETRY=0`` turns collection off and
``HANDYRL_TPU_LOG_LEVEL`` sets the log level. Tracing, the exporter and
alerts are not ported yet.
"""

from __future__ import annotations

import bisect
import logging
import os
import sys
import threading
import time
import uuid
from typing import Any, Dict, Sequence, Tuple

_ENABLED = os.environ.get('HANDYRL_TPU_TELEMETRY', '1').strip().lower() \
    not in ('0', 'false', 'off')


# ---------------------------------------------------------------------------
# leveled logger (one complete line per record, stderr)

_LOG_LOCK = threading.Lock()
_LOG_CONFIGURED = False
_ROOT = 'handyrl_tpu_torch'


def _log_level() -> int:
    name = os.environ.get('HANDYRL_TPU_LOG_LEVEL', 'info').strip().lower()
    return {'debug': logging.DEBUG, 'info': logging.INFO,
            'warning': logging.WARNING, 'warn': logging.WARNING,
            'error': logging.ERROR}.get(name, logging.INFO)


def get_logger(name: str = _ROOT) -> logging.Logger:
    """A logger under the ``handyrl_tpu_torch`` root, configured once per
    process: single lines to stderr, level from HANDYRL_TPU_LOG_LEVEL."""
    global _LOG_CONFIGURED
    root = logging.getLogger(_ROOT)
    with _LOG_LOCK:
        if not _LOG_CONFIGURED:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(logging.Formatter(
                '[%(asctime)s %(levelname).1s %(process)d %(name)s] '
                '%(message)s', datefmt='%H:%M:%S'))
            root.addHandler(handler)
            root.setLevel(_log_level())
            root.propagate = False
            _LOG_CONFIGURED = True
    if name in ('', _ROOT):
        return root
    return root.getChild(name)


# ---------------------------------------------------------------------------
# run id: one identity for every record of a training run

_RUN_ID = os.environ.get('HANDYRL_TPU_RUN_ID') or uuid.uuid4().hex[:12]


def run_id() -> str:
    return _RUN_ID


# ---------------------------------------------------------------------------
# metrics

DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# row-count buckets for the inference engine's engine_batch_rows histogram:
# powers of two matching the padded dispatch buckets
BATCH_ROW_BUCKETS: Tuple[float, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def metric_key(name: str, labels: Dict[str, Any]) -> str:
    """'name' or 'name{k="v",k2="v2"}' (label keys sorted)."""
    if not labels:
        return name
    inner = ','.join('%s="%s"' % (k, str(labels[k]).replace('"', "'"))
                     for k in sorted(labels))
    return '%s{%s}' % (name, inner)


class Counter:
    """Monotonic labeled counter."""

    __slots__ = ('_lock', 'value')

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0

    def inc(self, n: int = 1):
        if not _ENABLED:
            return
        with self._lock:
            self.value += n


class Gauge:
    """Last-value labeled gauge."""

    __slots__ = ('_lock', 'value')

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def set(self, v: float):
        if not _ENABLED:
            return
        with self._lock:
            self.value = float(v)


class Histogram:
    """Fixed-bucket histogram: observations land in the first bucket whose
    upper bound is >= the value (one overflow bucket past the last)."""

    __slots__ = ('_lock', 'bounds', 'buckets', 'sum', 'count')

    def __init__(self, lock: threading.Lock,
                 bounds: Sequence[float] = DEFAULT_BUCKETS):
        self._lock = lock
        self.bounds = tuple(float(b) for b in bounds)
        self.buckets = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float):
        if not _ENABLED:
            return
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.buckets[i] += 1
            self.sum += v
            self.count += 1


def hist_quantile(bounds: Sequence[float], buckets: Sequence[int],
                  count: int, q: float) -> float:
    """Linear-interpolated quantile of a bucketed distribution."""
    if count <= 0:
        return 0.0
    rank = q * count
    seen = 0.0
    for i, n in enumerate(buckets):
        if n <= 0:
            continue
        if seen + n >= rank:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i] if i < len(bounds) else bounds[-1]
            frac = (rank - seen) / n
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        seen += n
    return float(bounds[-1])


class MetricRegistry:
    """Process-local metric store; one lock guards every update."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}    # guarded-by: _lock
        self._gauges: Dict[str, Gauge] = {}        # guarded-by: _lock
        self._hists: Dict[str, Histogram] = {}     # guarded-by: _lock

    def counter(self, name: str, **labels) -> Counter:
        with self._lock:
            return self._counters.setdefault(metric_key(name, labels),
                                             Counter(self._lock))

    def gauge(self, name: str, **labels) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(metric_key(name, labels),
                                           Gauge(self._lock))

    def histogram(self, name: str, buckets: Sequence[float] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        with self._lock:
            return self._hists.setdefault(metric_key(name, labels),
                                          Histogram(self._lock, buckets))

    def snapshot(self) -> Dict[str, Any]:
        """Plain-data (wire- and json-safe) dump of every metric."""
        with self._lock:
            return {
                'time': time.time(),
                'counters': {k: c.value for k, c in self._counters.items()},
                'gauges': {k: g.value for k, g in self._gauges.items()},
                'hists': {k: {'bounds': list(h.bounds),
                              'buckets': list(h.buckets),
                              'sum': h.sum, 'count': h.count}
                          for k, h in self._hists.items()},
            }


# the process-global registry every module instruments against
REGISTRY = MetricRegistry()
counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
snapshot = REGISTRY.snapshot


def summarize(snap: Dict[str, Any]) -> Dict[str, Any]:
    """Compact form for metrics_jsonl: counters and gauges verbatim,
    histograms reduced to count/sum/p50/p95/p99."""
    hists = {}
    for k, h in (snap.get('hists') or {}).items():
        n = int(h['count'])
        hists[k] = {'count': n, 'sum': round(float(h['sum']), 6)}
        for name, q in (('p50', 0.50), ('p95', 0.95), ('p99', 0.99)):
            hists[k][name] = round(hist_quantile(h['bounds'], h['buckets'],
                                                 n, q), 6)
    return {'counters': dict(snap.get('counters') or {}),
            'gauges': {k: round(float(v), 6)
                       for k, v in (snap.get('gauges') or {}).items()},
            'hists': hists}
