"""Telemetry: the metric registry, spans, the leveled logger, tracing,
the flight recorder, SLO alerts, the Prometheus exporter and the
compiled-performance plane (the port of ``handyrl_tpu/telemetry.py``, on
its formats: metric keys, snapshot layout, trace events and files,
blackbox dumps, alert blocks and the ``/statusz`` payload are the JAX
package's, so a dashboard or a ``telemetry.alerts`` override written for
one package reads the other). Stdlib only: gathers that never import
torch import this module too.

* :class:`MetricRegistry`: process-local labeled counters, gauges and
  fixed-bucket histograms; every mutator is one flag check when
  collection is off (``HANDYRL_TPU_TELEMETRY=0``, or ``telemetry: false``
  / ``{enabled: false}`` in the config, :func:`set_enabled`).
  ``snapshot()`` is plain data that rides the wire codec, so workers and
  gathers carry theirs in their heartbeat beacons and the learner merges
  them (:func:`merge_snapshots`: counters and gauges sum, histogram
  buckets add).
* Spans: timed sections folded into the ``stage_seconds{stage=...}``
  histogram family (the ingest :class:`~.utils.timing.StageTimer`'s
  vocabulary, :data:`INGEST_STAGES`).
* :func:`get_logger`: single lines to stderr under the
  ``handyrl_tpu_torch`` root, level from ``HANDYRL_TPU_LOG_LEVEL``; every
  line also lands in the flight recorder.
* Tracing (``HANDYRL_TPU_TRACE=<dir>`` or ``telemetry.trace_dir``):
  Chrome-trace complete events appended by every process of the run to
  one ``trace-<run_id>.jsonl`` in single ``O_APPEND`` writes,
  :func:`finalize_trace` collates ``trace-<run_id>.json``. An episode's
  trace id is its server-stamped task's ``role`` + ``sample_key``
  (:func:`episode_trace_id`), so the learner's ``task_assign``,
  ``ingest`` and ``train_step``, a worker's ``generate`` and a gather's
  ``upload`` share it with no new wire field; sampling by a crc32 of the
  id keeps the same episodes in every process of either package. Off,
  each trace call is one falsy-string check.
* The flight recorder (:class:`FlightRecorder`): a bounded ring of recent
  events, dumped to ``<blackbox_dir>/<role>-<pid>-<run_id>.json`` at an
  abnormal death (:func:`dump_blackbox`, :func:`install_crash_dump`).
* :class:`AlertEngine` over :data:`BUILTIN_ALERTS` and the
  ``telemetry.alerts`` overrides; :class:`TelemetryExporter` serves
  ``/metrics`` (Prometheus text 0.0.4), ``/statusz`` and ``/healthz`` on
  stdlib ``http.server``; :func:`status_main` renders a live
  ``/statusz`` (``python -m handyrl_tpu_torch --status HOST:PORT``).
* The compiled-performance plane: device memory from
  ``torch.cuda.memory_stats`` (:func:`sample_device_memory`), the
  dispatch/host_block utilization proxy, and the steady-state sentinel.
  The JAX sentinel counts XLA compiles after warm-up; the port compiles
  no program at run time but captures CUDA graphs
  (``ops/graphs.CountedGraph``) and builds kernel libraries
  (``ops/cuda_build.build``), and each runs in a :func:`compile_scope`:
  after :func:`mark_steady_state`, a capture or a build outside an
  :func:`expected_compile` scope is a retrace. The metric names are the
  JAX package's, so its ``retrace_storm`` rule reads them:
  ``xla_retraces_total`` counts those captures and builds,
  ``xla_expected_compiles_total`` the exempted ones,
  ``xla_compile_events_total{event=graph_capture|kernel_build}`` and the
  ``xla_compile_seconds`` histogram every one, ``xla_steady_state`` is 1
  in steady state.
"""

from __future__ import annotations

import atexit
import bisect
import json
import logging
import os
import random
import re
import sys
import threading
import time
import uuid
import zlib
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# enable/disable switch (near-zero cost when off)

_ENABLED = os.environ.get('HANDYRL_TPU_TELEMETRY', '1').strip().lower() \
    not in ('0', 'false', 'off')


def enabled() -> bool:
    return _ENABLED


def set_enabled(flag: bool):
    """Flip collection globally; mirrored into the environment so spawned
    children (batchers, gathers, workers) inherit the choice."""
    global _ENABLED
    _ENABLED = bool(flag)
    os.environ['HANDYRL_TPU_TELEMETRY'] = '1' if _ENABLED else '0'


# ---------------------------------------------------------------------------
# run id: one identity for every record/span of a training run

_RUN_ID = os.environ.get('HANDYRL_TPU_RUN_ID') or uuid.uuid4().hex[:12]


def run_id() -> str:
    return _RUN_ID


def set_run_id(rid: Optional[str]):
    """Adopt the learner's run id (workers receive it in the merged config);
    mirrored into the environment so spawned children inherit it."""
    global _RUN_ID
    if rid:
        _RUN_ID = str(rid)
        os.environ['HANDYRL_TPU_RUN_ID'] = _RUN_ID


# ---------------------------------------------------------------------------
# distributed tracing (Chrome-trace events over one shared per-run JSONL)

# Default per-config knobs for the ``telemetry`` block (a bare bool in the
# config is accepted as {'enabled': <bool>} for back-compat).
TELEMETRY_DEFAULTS: Dict[str, Any] = {
    'enabled': True, 'trace_dir': '', 'trace_sample_rate': 1.0,
    'blackbox_dir': 'blackbox', 'recorder_events': 256,
    'metrics_rotate_mb': 0, 'alerts': {},
    # compiled-performance plane: device-memory gauges, the retrace
    # sentinel, and the host-block decomposition
    'perf_plane': True, 'retrace': 'warn', 'retrace_warmup_epochs': 1}


def config_block(args: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Normalize the ``telemetry`` config knob: bool (legacy collection
    switch) or a block with ``enabled`` / ``trace_dir`` /
    ``trace_sample_rate``."""
    raw = (args or {}).get('telemetry', True)
    if isinstance(raw, dict):
        out = dict(TELEMETRY_DEFAULTS)
        out.update(raw)
        return out
    return {**TELEMETRY_DEFAULTS, 'enabled': bool(raw)}


class _TraceState:
    """Per-process trace sink: destination dir, sample rate, event buffer."""

    def __init__(self):
        self.dir = os.environ.get('HANDYRL_TPU_TRACE', '').strip()
        rate = os.environ.get('HANDYRL_TPU_TRACE_RATE', '').strip()
        try:
            self.rate = min(1.0, max(0.0, float(rate))) if rate else 1.0
        except ValueError:
            self.rate = 1.0
        self.label = 'proc'
        self.lock = threading.Lock()
        # event buffer + its one-shot metadata flag share the sink lock
        # (*_locked helpers are called with it held)
        self.buf: List[str] = []          # guarded-by: lock
        self.meta_done = False            # guarded-by: lock


_TRACE = _TraceState()
_TRACE_FLUSH_AT = 128      # buffered events per O_APPEND write


def trace_enabled() -> bool:
    return bool(_TRACE.dir)


def trace_dir() -> str:
    return _TRACE.dir


def trace_sample_rate() -> float:
    return _TRACE.rate


def configure_tracing(trace_dir: Optional[str] = None,
                      sample_rate: Optional[float] = None,
                      force: bool = False):
    """Adopt trace settings from the run config, mirrored into the
    environment so spawned children (batchers, gathers, workers) inherit
    them. An operator-set ``HANDYRL_TPU_TRACE`` / ``HANDYRL_TPU_TRACE_RATE``
    wins over config values unless ``force`` (tests)."""
    if sample_rate is not None and (force or
                                    not os.environ.get('HANDYRL_TPU_TRACE_RATE')):
        _TRACE.rate = min(1.0, max(0.0, float(sample_rate)))
        os.environ['HANDYRL_TPU_TRACE_RATE'] = '%g' % _TRACE.rate
    if trace_dir is not None and (force or
                                  not os.environ.get('HANDYRL_TPU_TRACE')):
        trace_flush()
        with _TRACE.lock:   # a racing trace_event must not emit its meta
            _TRACE.dir = str(trace_dir).strip()   # line into the old sink
            _TRACE.meta_done = False
        os.environ['HANDYRL_TPU_TRACE'] = _TRACE.dir


def set_process_label(label: str):
    """Human-readable process name for the trace viewer's process rows
    (learner / gather-N / worker-N / batcher-N)."""
    _TRACE.label = str(label)


def adopt_config(args: Optional[Dict[str, Any]]):
    """One call for every process that receives the merged run config:
    run id, the collection switch, the trace destination/sampling, and the
    flight-recorder geometry."""
    args = args or {}
    set_run_id(args.get('run_id'))
    tel = config_block(args)
    if not tel.get('enabled', True):
        set_enabled(False)
    configure_tracing(tel.get('trace_dir') or None,
                      tel.get('trace_sample_rate'))
    configure_recorder(tel.get('recorder_events'),
                       tel.get('blackbox_dir'))
    configure_perf_plane(tel.get('perf_plane'), tel.get('retrace'))


def episode_trace_id(task_args: Optional[Dict[str, Any]]) -> Optional[str]:
    """The trace context: derived from the server-stamped task identity
    (``role`` + ``sample_key``), so every process holding the task or an
    episode/result payload built from it computes the SAME id with no new
    wire fields. None when the payload carries no sample_key (local
    fallback streams, pre-ledger peers)."""
    if not isinstance(task_args, dict):
        return None
    skey = task_args.get('sample_key')
    if skey is None:
        return None
    return '%s%d' % (str(task_args.get('role') or 'g'), int(skey))


_MINT_LOCK = threading.Lock()
_MINT_SEQ = [0]                       # guarded-by: _MINT_LOCK


def mint_trace_id() -> str:
    """Serving-path trace context: a fresh request-scoped id (``r<pid
    hash><seq>``), minted once at the edge (``ServiceClient.submit`` /
    a gateway ply) and carried inside the INFER/admin payload so every
    downstream hop — router, replica, engine, failover replay — stamps
    the SAME id. Unlike :func:`episode_trace_id` there is no
    server-stamped identity to recompute from, so the id itself crosses
    the wire (absent key = unsampled; old peers ignore it)."""
    with _MINT_LOCK:
        _MINT_SEQ[0] += 1
        seq = _MINT_SEQ[0]
    return 'r%x.%d' % (os.getpid() & 0xFFFFFF, seq)


def trace_sampled(trace_id) -> bool:
    """Deterministic keep/drop for one episode: hash-based on the trace_id,
    so the learner, gather and worker agree without coordination."""
    if not _TRACE.dir:
        return False
    rate = _TRACE.rate
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return (zlib.crc32(str(trace_id).encode()) % 10000) < rate * 10000


def _emit_locked(line: str):
    if not _TRACE.meta_done:
        _TRACE.meta_done = True
        _TRACE.buf.append(json.dumps(
            {'name': 'process_name', 'ph': 'M', 'pid': os.getpid(), 'tid': 0,
             'args': {'name': '%s-%d' % (_TRACE.label, os.getpid())}}))
    _TRACE.buf.append(line)
    if len(_TRACE.buf) >= _TRACE_FLUSH_AT:
        _flush_locked()


def trace_event(name: str, ts: Optional[float] = None, dur: float = 0.0,
                trace_id=None, always: bool = False, **args):
    """Record one Chrome-trace complete event ("ph": "X"; instants are
    zero-duration spans). ``ts``/``dur`` are wall-clock seconds (converted
    to the microseconds the viewers expect — wall time, so events align
    across processes). Sampling: a truthy ``trace_id`` decides
    deterministically; ``always`` bypasses (callers who already sampled);
    otherwise batch-level events sample probabilistically at the same
    rate."""
    if not _TRACE.dir:
        return
    if trace_id:
        if not trace_sampled(trace_id):
            return
        args['trace_id'] = trace_id
    elif not always:
        rate = _TRACE.rate
        if rate < 1.0 and random.random() >= rate:
            return
    args['run_id'] = _RUN_ID
    try:
        tid = threading.get_native_id()
    except AttributeError:
        tid = threading.get_ident() & 0x7FFFFFFF
    ev = {'name': name, 'cat': 'handyrl', 'ph': 'X',
          'ts': int((time.time() if ts is None else ts) * 1e6),
          'dur': max(0, int(dur * 1e6)),
          'pid': os.getpid(), 'tid': tid, 'args': args}
    with _TRACE.lock:
        _emit_locked(json.dumps(ev))


@contextmanager
def trace_span(name: str, trace_id=None, **args):
    """Timed section: always folded into the ``stage_seconds{stage=...}``
    histogram family; additionally written to the trace file when tracing
    is on (and the id — or the rate, for id-less spans — samples it)."""
    t_wall = time.time()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        REGISTRY.observe_stage(name, dt)
        if _TRACE.dir:
            trace_event(name, ts=t_wall, dur=dt, trace_id=trace_id, **args)


def trace_stage(stage: str, seconds: float, count: int = 1):
    """Batch-level stage event (the StageTimer mirror): one span covering
    the just-finished timed section, rate-sampled."""
    if not _TRACE.dir:
        return
    trace_event(stage, ts=time.time() - seconds, dur=seconds, count=count)


def _flush_locked():
    buf = _TRACE.buf
    if not buf or not _TRACE.dir:
        return
    _TRACE.buf = []
    try:
        os.makedirs(_TRACE.dir, exist_ok=True)
        path = os.path.join(_TRACE.dir, 'trace-%s.jsonl' % _RUN_ID)
        data = ('\n'.join(buf) + '\n').encode()
        # one O_APPEND write per flush: complete lines, atomic offset —
        # every fleet process appends to the same per-run file safely
        fd = os.open(path, os.O_CREAT | os.O_WRONLY | os.O_APPEND, 0o644)
        try:
            os.write(fd, data)
        finally:
            os.close(fd)
    except OSError:
        pass   # tracing must never take the run down


def trace_flush():
    if not _TRACE.dir:
        return
    with _TRACE.lock:
        _flush_locked()


atexit.register(trace_flush)


def finalize_trace() -> Optional[str]:
    """Collate this run's JSONL event stream into a valid Chrome-trace /
    Perfetto JSON file (``<dir>/trace-<run_id>.json``); returns the path
    (None when tracing is off or nothing was recorded). Written atomically
    (temp + rename); the JSONL stays the append-forever source of truth."""
    if not _TRACE.dir:
        return None
    trace_flush()
    src = os.path.join(_TRACE.dir, 'trace-%s.jsonl' % _RUN_ID)
    events: List[Dict[str, Any]] = []
    try:
        with open(src) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except ValueError:
                    continue   # torn tail line from a killed process
    except OSError:
        return None
    if not events:
        return None
    out = os.path.join(_TRACE.dir, 'trace-%s.json' % _RUN_ID)
    try:
        # atomic publish through the shared fs helper: a collate
        # interrupted mid-write must not leave a half-JSON next to the
        # intact JSONL source of truth
        from .utils.fs import atomic_write_bytes
        atomic_write_bytes(out, json.dumps(
            {'traceEvents': events, 'displayTimeUnit': 'ms'}).encode('utf-8'))
    except OSError:
        return None
    return out


# ---------------------------------------------------------------------------
# leveled logger (multi-process safe: one line per record, stderr)

_LOG_CONFIGURED = False
_LOG_LOCK = threading.Lock()
_ROOT = 'handyrl_tpu_torch'


def _log_level() -> int:
    name = os.environ.get('HANDYRL_TPU_LOG_LEVEL', 'info').strip().lower()
    return {'debug': logging.DEBUG, 'info': logging.INFO,
            'warning': logging.WARNING, 'warn': logging.WARNING,
            'error': logging.ERROR}.get(name, logging.INFO)


def get_logger(name: str = _ROOT) -> logging.Logger:
    """A logger under the ``handyrl_tpu_torch`` root, configured once per
    process: single lines to stderr, level from HANDYRL_TPU_LOG_LEVEL;
    every line also lands in the flight recorder."""
    global _LOG_CONFIGURED
    root = logging.getLogger(_ROOT)
    if not _LOG_CONFIGURED:
        with _LOG_LOCK:
            if not _LOG_CONFIGURED:
                handler = logging.StreamHandler(sys.stderr)
                handler.setFormatter(logging.Formatter(
                    '[%(asctime)s %(levelname).1s %(process)d %(name)s] '
                    '%(message)s', datefmt='%H:%M:%S'))
                root.addHandler(handler)
                # a blackbox dump carries the process's last log lines
                root.addHandler(_RecorderLogHandler())
                root.setLevel(_log_level())
                root.propagate = False
                _LOG_CONFIGURED = True
    if name in ('', _ROOT):
        return root
    return root.getChild(name)


# ---------------------------------------------------------------------------
# flight recorder: bounded ring of recent events, dumped on abnormal death

RECORDER_EVENTS_DEFAULT = 256


class FlightRecorder:
    """Bounded in-memory ring of this process's recent events: leveled log
    lines, span completions, state-machine transitions, and guard trips.

    Every fleet process keeps one (learner, gathers, workers, inference
    supervisors, serving services, the fleet resolver). When the process
    dies abnormally — uncaught fatal error, PreemptionGuard signal,
    NonFiniteGuard abort, or a supervisor declaring a child dead — the ring
    is dumped atomically (``utils/fs``) to
    ``<blackbox_dir>/<role>-<pid>-<run_id>.json`` so
    a post-mortem can reconstruct each dead process's last seconds
    without a debugger (the JAX package's ``scripts/postmortem.py``
    reads the layout). Recording is one deque append under a lock and
    honours the global telemetry switch (``telemetry: false`` disables it
    with the rest of the plane).
    """

    def __init__(self, capacity: int = RECORDER_EVENTS_DEFAULT):
        self._lock = threading.Lock()
        # ring + counters share one lock
        self._events: deque = deque(maxlen=max(16, int(capacity)))  # guarded-by: _lock
        self._total = 0                 # guarded-by: _lock
        self._dumps: List[str] = []     # guarded-by: _lock

    @property
    def capacity(self) -> int:
        with self._lock:
            return self._events.maxlen or 0

    def set_capacity(self, capacity: int):
        cap = max(16, int(capacity))
        with self._lock:
            if cap != self._events.maxlen:
                self._events = deque(self._events, maxlen=cap)

    def record(self, kind: str, msg: str, **fields):
        if not _ENABLED:
            return
        ev = {'t': round(time.time(), 6), 'kind': str(kind),
              'msg': str(msg)[:500]}
        if fields:
            ev.update(fields)
        with self._lock:
            self._events.append(ev)
            self._total += 1

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(ev) for ev in self._events]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            held = len(self._events)
            return {'events': held, 'total': self._total,
                    'dropped': max(0, self._total - held),
                    'capacity': self._events.maxlen,
                    'dumps': list(self._dumps)}

    def dump(self, reason: str, directory: Optional[str] = None,
             context: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Atomically write the ring (plus a summarized registry snapshot)
        to the blackbox file for this process. Returns the path, or None
        when dumping is disabled (empty dir) or the write failed — a dump
        must never take the dying process down harder."""
        directory = _BLACKBOX_DIR if directory is None else directory
        if not directory:
            return None
        role = re.sub(r'[^A-Za-z0-9_.-]', '_', _TRACE.label or 'proc')
        path = os.path.join(directory,
                            '%s-%d-%s.json' % (role, os.getpid(), _RUN_ID))
        payload = {
            'schema': 'handyrl_tpu.blackbox/1',
            'role': _TRACE.label, 'pid': os.getpid(), 'run_id': _RUN_ID,
            'reason': str(reason), 'time': round(time.time(), 6),
            'stats': self.stats(), 'events': self.events(),
            'metrics': summarize(REGISTRY.snapshot()),
        }
        if context:
            payload['context'] = context
        try:
            os.makedirs(directory, exist_ok=True)
            from .utils.fs import atomic_write_bytes
            atomic_write_bytes(path, json.dumps(payload).encode('utf-8'))
        except Exception:
            return None
        with self._lock:
            if path not in self._dumps:
                self._dumps.append(path)
        return path


class _RecorderLogHandler(logging.Handler):
    """Mirror leveled log lines into the flight-recorder ring."""

    def emit(self, record):  # noqa: D102 (logging API)
        try:
            _RECORDER.record('log', record.getMessage(),
                             level=record.levelname, logger=record.name)
        except Exception:
            pass   # the recorder must never break logging


_RECORDER = FlightRecorder(
    int(os.environ.get('HANDYRL_TPU_RECORDER_EVENTS')
        or RECORDER_EVENTS_DEFAULT))
_BLACKBOX_DIR = os.environ.get('HANDYRL_TPU_BLACKBOX', 'blackbox')


def recorder() -> FlightRecorder:
    return _RECORDER


def recorder_stats() -> Dict[str, Any]:
    return _RECORDER.stats()


def configure_recorder(events: Optional[int] = None,
                       directory: Optional[str] = None,
                       force: bool = False):
    """Adopt recorder geometry from the run config, mirrored into the
    environment so spawned children inherit it. Operator-set
    ``HANDYRL_TPU_RECORDER_EVENTS`` / ``HANDYRL_TPU_BLACKBOX`` win over
    config values unless ``force`` (tests)."""
    global _BLACKBOX_DIR
    if events is not None and (force or
                               not os.environ.get('HANDYRL_TPU_RECORDER_EVENTS')):
        _RECORDER.set_capacity(int(events))
        os.environ['HANDYRL_TPU_RECORDER_EVENTS'] = str(_RECORDER.capacity)
    if directory is not None and (force or
                                  not os.environ.get('HANDYRL_TPU_BLACKBOX')):
        _BLACKBOX_DIR = str(directory).strip()
        os.environ['HANDYRL_TPU_BLACKBOX'] = _BLACKBOX_DIR


def record_event(kind: str, msg: str, **fields):
    """Append one event to this process's flight-recorder ring (a single
    deque append under a lock; a no-op with telemetry disabled)."""
    _RECORDER.record(kind, msg, **fields)


def dump_blackbox(reason: str, **context) -> Optional[str]:
    """Dump the flight recorder for an abnormal-death reason (fatal-error,
    preempt, nonfinite-abort, crash declarations). Idempotent per process:
    a later dump atomically replaces the earlier file with a fresher
    ring."""
    path = _RECORDER.dump(reason, context=context or None)
    if path:
        counter('blackbox_dumps_total').inc()
        get_logger('recorder').warning('blackbox dump (%s): %s',
                                       reason, path)
        trace_flush()
    return path


_CRASH_HOOK_INSTALLED = False


def install_crash_dump():
    """Chain ``sys.excepthook`` so an uncaught fatal error dumps the flight
    recorder before the traceback prints. Installed once per process at
    the fleet entry points (learner, gather, worker, serving service,
    fleet resolver). KeyboardInterrupt is left to the PreemptionGuard
    path; SystemExit never reaches the hook."""
    global _CRASH_HOOK_INSTALLED
    if _CRASH_HOOK_INSTALLED:
        return
    _CRASH_HOOK_INSTALLED = True
    prev = sys.excepthook

    def hook(tp, val, tb):
        if not issubclass(tp, KeyboardInterrupt):
            try:
                record_event('fatal', '%s: %s' % (tp.__name__, val))
                dump_blackbox('fatal-error',
                              error='%s: %s' % (tp.__name__, str(val)[:200]))
            except Exception:
                pass   # dumping must never mask the real traceback
        prev(tp, val, tb)

    sys.excepthook = hook


# ---------------------------------------------------------------------------
# metric key codec: 'name' or 'name{k="v",k2="v2"}' (label keys sorted)

_NAME_RE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*$')


def metric_key(name: str, labels: Dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ','.join('%s="%s"' % (k, str(labels[k]).replace('"', "'"))
                     for k in sorted(labels))
    return '%s{%s}' % (name, inner)


def split_key(key: str) -> Tuple[str, str]:
    """('name', 'k="v",...') — the label string is '' when unlabeled."""
    if '{' not in key:
        return key, ''
    name, _, rest = key.partition('{')
    return name, rest.rstrip('}')


def relabel(snapshot: Dict[str, Any], **labels) -> Dict[str, Any]:
    """A copy of ``snapshot`` with ``labels`` appended to every metric key
    (the exporter tags the merged fleet snapshot with source="fleet")."""
    extra = ','.join('%s="%s"' % (k, v) for k, v in sorted(labels.items()))

    def rekey(key: str) -> str:
        name, inner = split_key(key)
        inner = (inner + ',' + extra) if inner else extra
        return '%s{%s}' % (name, inner)

    out = dict(snapshot)
    for section in ('counters', 'gauges'):
        out[section] = {rekey(k): v
                        for k, v in (snapshot.get(section) or {}).items()}
    out['hists'] = {rekey(k): dict(v)
                    for k, v in (snapshot.get('hists') or {}).items()}
    return out


# ---------------------------------------------------------------------------
# metrics

# Default histogram buckets: latency-oriented, seconds. Fixed per metric for
# the life of the process so fleet merges are bucket-aligned.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# Canonical ingest-path stage vocabulary, shared by StageTimer epoch lines
# and the stage_seconds histogram family (the JAX package's). 'dispatch'
# is the launch of the graphed update step (the replay returns once the
# work is queued on the card) and 'host_block' the host waiting on the
# card (the fetch of the step's losses): the device-utilization proxy is
# computed from them.
INGEST_STAGES: Tuple[str, ...] = (
    'select', 'decode', 'assemble', 'ipc', 'h2d', 'dispatch', 'host_block')

# Row-count buckets for batching histograms (e.g. the inference engine's
# engine_batch_rows): powers of two matching the padded dispatch buckets.
BATCH_ROW_BUCKETS: Tuple[float, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256)

# Policy-lag buckets: how many epochs behind the learner the params that
# generated a consumed sample were (the policy_lag_epochs histogram).
LAG_EPOCH_BUCKETS: Tuple[float, ...] = (0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32,
                                        48, 64)

# Sample-age buckets (seconds from learner ingest to consumption): buffer
# dwell spans far past the latency-oriented DEFAULT_BUCKETS.
AGE_SECOND_BUCKETS: Tuple[float, ...] = (0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25,
                                         50, 100, 250, 500, 1000)

# Run-time compile durations (compile_scope: graph captures and kernel
# library builds): seconds, up to a minutes-long nvcc build.
COMPILE_SECOND_BUCKETS: Tuple[float, ...] = (0.01, 0.05, 0.1, 0.25, 0.5, 1,
                                             2.5, 5, 10, 30, 60, 120, 300)

# Numeric encoding of the fleet controller's host health states
# (fault.FleetController) for the per-host ``fleet_host_state`` gauge
# family and the serving fleet's per-replica ``fleet_replica_state``
# gauges: monotone in severity, so operators can alert on `value >= 2`
# (draining or quarantined = the host/replica is not receiving fresh
# work). The serving resolver additionally uses -1 for a retired replica.
HOST_STATE_CODES: Dict[str, int] = {
    'healthy': 0, 'degraded': 1, 'draining': 2, 'quarantined': 3}


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

    def add(self, n: float = 1.0):
        if not _ENABLED:
            return
        with self._lock:
            self.value += n


class Histogram:
    """Fixed-bucket histogram with closed-form percentile summaries.

    ``bounds`` are ascending upper edges; observations land in the first
    bucket whose bound is >= the value (one overflow bucket past the last
    bound). Quantiles interpolate linearly inside the winning bucket —
    exact enough for p50/p95/p99 dashboards at 14 buckets.
    """

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

    def observe_agg(self, total: float, n: int):
        """Fold ``n`` events totalling ``total`` in (a StageTimer batch):
        the mean lands in one bucket, sum/count stay exact."""
        if not _ENABLED or n <= 0:
            return
        i = bisect.bisect_left(self.bounds, total / n)
        with self._lock:
            self.buckets[i] += n
            self.sum += total
            self.count += n

    def quantile(self, q: float) -> float:
        with self._lock:
            return hist_quantile(self.bounds, self.buckets, self.count, q)


def hist_quantile(bounds: Sequence[float], buckets: Sequence[int],
                  count: int, q: float) -> float:
    """Linear-interpolated quantile of a bucketed distribution (also used on
    merged fleet histograms, where no Histogram object exists)."""
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
    """Process-local metric store. One lock guards every update (updates are
    a few arithmetic ops; the timed sections themselves run unlocked)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}    # guarded-by: _lock
        self._gauges: Dict[str, Gauge] = {}        # guarded-by: _lock
        self._hists: Dict[str, Histogram] = {}     # guarded-by: _lock

    def counter(self, name: str, **labels) -> Counter:
        key = metric_key(name, labels)
        # lock-free fast path: the dict only grows, and setdefault under
        # the lock makes the miss race benign
        c = self._counters.get(key)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(key, Counter(self._lock))
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        key = metric_key(name, labels)
        # lock-free fast path: the dict only grows, and setdefault under
        # the lock makes the miss race benign
        g = self._gauges.get(key)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(key, Gauge(self._lock))
        return g

    def histogram(self, name: str, buckets: Sequence[float] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        key = metric_key(name, labels)
        # lock-free fast path: the dict only grows, and setdefault under
        # the lock makes the miss race benign
        h = self._hists.get(key)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(key,
                                           Histogram(self._lock, buckets))
        return h

    @contextmanager
    def span(self, stage: str, parent: Optional[str] = None):
        """Timed section recorded under ``stage_seconds{stage=...}`` (plus a
        DEBUG structured event carrying the run id and a monotonic stamp).
        ``parent`` names the enclosing stage, keeping the select/decode/
        assemble/ipc/h2d/compute/drain vocabulary hierarchical."""
        if not _ENABLED:
            yield
            return
        labels = {'stage': stage}
        if parent:
            labels['parent'] = parent
        hist = self.histogram('stage_seconds', **labels)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            hist.observe(dt)
            _RECORDER.record('span', stage, seconds=round(dt, 6))
            log = get_logger('span')
            if log.isEnabledFor(logging.DEBUG):
                log.debug('span %s run=%s t=%.6f dur=%.6f parent=%s',
                          stage, _RUN_ID, time.monotonic(), dt, parent or '-')

    def observe_stage(self, stage: str, seconds: float, count: int = 1):
        """StageTimer mirror: fold an ingest-stage timing batch into the
        span histogram family (same canonical stage names)."""
        if not _ENABLED:
            return
        self.histogram('stage_seconds', stage=stage).observe_agg(
            seconds, count)
        _RECORDER.record('span', stage, seconds=round(seconds, 6),
                         count=count)

    def snapshot(self, reset: bool = False) -> Dict[str, Any]:
        """Plain-data (msgpack/json-safe) dump of every metric; with
        ``reset`` counters/histograms restart from zero (gauges keep their
        last value — they are levels, not flows)."""
        with self._lock:
            snap = {
                'run_id': _RUN_ID,
                'time': time.time(),
                'counters': {k: c.value for k, c in self._counters.items()},
                'gauges': {k: g.value for k, g in self._gauges.items()},
                'hists': {k: {'bounds': list(h.bounds),
                              'buckets': list(h.buckets),
                              'sum': h.sum, 'count': h.count}
                          for k, h in self._hists.items()},
            }
            if reset:
                for c in self._counters.values():
                    c.value = 0
                for h in self._hists.values():
                    h.buckets = [0] * len(h.buckets)
                    h.sum = 0.0
                    h.count = 0
        return snap


# the process-global registry every subsystem instruments against
REGISTRY = MetricRegistry()
counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
span = REGISTRY.span
snapshot = REGISTRY.snapshot


# ---------------------------------------------------------------------------
# fleet merge + summaries


def merge_snapshots(snaps: List[Optional[Dict[str, Any]]]
                    ) -> Dict[str, Any]:
    """Fleet-wide aggregate of per-process snapshots.

    Merge semantics: counters SUM (flows add across processes), gauges SUM
    (queue depths and rates add; per-peer resolution survives via labels —
    e.g. ``gather_episodes_per_sec{gather="3"}`` keys stay distinct),
    histogram buckets ADD elementwise when bounds agree. A peer whose
    bounds DISAGREE for a key is dropped for that key (never mis-binned)
    and the drop is counted: once in the merged
    ``telemetry_hist_bound_conflicts_total`` counter (so the conflict
    survives re-merging up the fleet tree and reaches the exposition) and
    once in the top-level ``hist_bound_conflicts`` field of the returned
    snapshot.
    """
    out: Dict[str, Any] = {'run_id': _RUN_ID, 'time': time.time(),
                           'counters': {}, 'gauges': {}, 'hists': {},
                           'peers': 0}
    conflicts = 0
    for snap in snaps:
        if not isinstance(snap, dict):
            continue
        out['peers'] += 1
        for k, v in (snap.get('counters') or {}).items():
            out['counters'][k] = out['counters'].get(k, 0) + v
        for k, v in (snap.get('gauges') or {}).items():
            out['gauges'][k] = out['gauges'].get(k, 0.0) + v
        for k, h in (snap.get('hists') or {}).items():
            cur = out['hists'].get(k)
            if cur is None:
                out['hists'][k] = {'bounds': list(h['bounds']),
                                   'buckets': list(h['buckets']),
                                   'sum': float(h['sum']),
                                   'count': int(h['count'])}
            elif list(cur['bounds']) == list(h['bounds']):
                cur['buckets'] = [a + b for a, b in
                                  zip(cur['buckets'], h['buckets'])]
                cur['sum'] += float(h['sum'])
                cur['count'] += int(h['count'])
            else:
                conflicts += 1
    if conflicts:
        key = 'telemetry_hist_bound_conflicts_total'
        out['counters'][key] = out['counters'].get(key, 0) + conflicts
        out['hist_bound_conflicts'] = conflicts
        get_logger('telemetry').warning(
            'merge_snapshots: dropped %d histogram(s) with mismatched '
            'bucket bounds (peers disagree on a histogram geometry)',
            conflicts)
    return out


def summarize(snap: Dict[str, Any]) -> Dict[str, Any]:
    """Compact form for metrics_jsonl: counters/gauges verbatim, histograms
    reduced to count/sum/p50/p95/p99 (full buckets stay wire-only)."""
    hists = {}
    for k, h in (snap.get('hists') or {}).items():
        n = int(h['count'])
        hists[k] = {
            'count': n, 'sum': round(float(h['sum']), 6),
            'p50': round(hist_quantile(h['bounds'], h['buckets'], n, 0.50), 6),
            'p95': round(hist_quantile(h['bounds'], h['buckets'], n, 0.95), 6),
            'p99': round(hist_quantile(h['bounds'], h['buckets'], n, 0.99), 6),
        }
    out = {'counters': dict(snap.get('counters') or {}),
           'gauges': {k: round(float(v), 6)
                      for k, v in (snap.get('gauges') or {}).items()},
           'hists': hists}
    if snap.get('peers') is not None:
        out['peers'] = snap['peers']
    return out


# ---------------------------------------------------------------------------
# SLO alert engine: declarative rules over merged registry/fleet snapshots

# Built-in alert catalog. Each rule is declarative: a metric selector
# (name or list of names, summed over matching label sets), a value kind
# (``value`` = current level, ``rate`` = per-second counter increase
# between evaluations, ``ratio`` = rate(metric)/rate(denominator) — the
# burn rate over the existing latency/shed counters), a comparison, a
# sustain window (``for`` seconds the breach must hold before firing) and
# a ``clear_for`` debounce before an active alert clears. ``arm_metric``
# keeps a rule silent until its subsystem has shown life (ingest stall
# must not fire before the first episode ever arrives). Custom rules from
# the ``telemetry.alerts`` config block override built-ins by name.
BUILTIN_ALERTS: Tuple[Dict[str, Any], ...] = (
    {'name': 'ingest_stall',
     'metric': 'learner_episodes_returned_total', 'kind': 'rate',
     'op': '<=', 'threshold': 0.0, 'for': 60.0,
     'arm_metric': 'learner_episodes_returned_total'},
    {'name': 'policy_lag_runaway',
     'metric': 'policy_lag_mean', 'kind': 'value',
     'op': '>', 'threshold': 16.0, 'for': 30.0},
    {'name': 'nonfinite_spike',
     'metric': 'guard_nonfinite_total', 'kind': 'rate',
     'op': '>', 'threshold': 0.2},
    {'name': 'serve_shed_burn',
     'metric': ['serve_shed_total', 'engine_shed_total'], 'kind': 'ratio',
     'denominator': ['serve_requests_total', 'engine_requests_total'],
     'op': '>', 'threshold': 0.05, 'for': 10.0},
    {'name': 'replica_quarantine_flap',
     'metric': ['fleet_replica_transitions_total',
                'fleet_host_transitions_total'],
     'labels': 'to="quarantined"', 'kind': 'rate',
     'op': '>', 'threshold': 0.05},
    {'name': 'heartbeat_misses',
     'metric': ['fleet_heartbeat_misses_total', 'hub_disconnects_total'],
     'kind': 'rate', 'op': '>', 'threshold': 0.0},
    # compiled-performance plane: sustained device-memory pressure, and
    # any post-warm-up recompile (on the port a graph capture or a kernel
    # build; each stalls the device for its whole duration)
    {'name': 'hbm_pressure',
     'metric': 'device_mem_utilization', 'kind': 'value',
     'op': '>', 'threshold': 0.92, 'for': 30.0, 'clear_for': 30.0},
    {'name': 'retrace_storm',
     'metric': 'xla_retraces_total', 'kind': 'rate',
     'op': '>', 'threshold': 0.0, 'clear_for': 60.0},
    # league plane: a pool that stops booking rated games
    # starves PFSP and freezes the promotion gate — armed only once the
    # first league game ever lands, so non-league runs stay silent
    {'name': 'league_rating_stall',
     'metric': 'league_games_total', 'kind': 'rate',
     'op': '<=', 'threshold': 0.0, 'for': 120.0,
     'arm_metric': 'league_games_total'},
    # match gateway: the zero-loss
    # session contract — ANY dropped session is an incident (armed once
    # the gateway has ever opened one), and the per-ply latency SLO the
    # session tier promises on top of the fleet's request SLO
    {'name': 'session_drop',
     'metric': 'gateway_session_drops_total', 'kind': 'rate',
     'op': '>', 'threshold': 0.0, 'clear_for': 60.0,
     'arm_metric': 'gateway_sessions_opened_total'},
    {'name': 'gateway_ply_slo',
     'metric': 'gateway_ply_p99_ms', 'kind': 'value',
     'op': '>', 'threshold': 250.0, 'for': 15.0, 'clear_for': 30.0,
     'arm_metric': 'gateway_plies_total'},
    # durable training plane: a spool whose segment count keeps climbing means
    # GC has fallen behind the checkpoint consumption horizon (snapshots
    # stopped landing, or keep_segments is mis-sized) — disk is no longer
    # bounded; and ANY resend-buffer eviction is permanent episode loss
    # on a plane that promises zero, so the rate threshold is 0
    {'name': 'spool_growth',
     'metric': 'spool_segments', 'kind': 'value',
     'op': '>', 'threshold': 8.0, 'for': 60.0,
     'arm_metric': 'spool_bytes_total'},
    {'name': 'resend_buffer_loss',
     'metric': 'gather_resend_dropped_total', 'kind': 'rate',
     'op': '>', 'threshold': 0.0, 'clear_for': 60.0,
     'arm_metric': 'gather_uploads_total'},
)

_ALERT_OPS: Dict[str, Callable[[float, float], bool]] = {
    '>': lambda v, t: v > t, '>=': lambda v, t: v >= t,
    '<': lambda v, t: v < t, '<=': lambda v, t: v <= t,
}


def _metric_value(snaps: List[Optional[Dict[str, Any]]],
                  names, label_sub: str = '') -> float:
    """Sum a metric selector over snapshots: counters and gauges by value,
    histograms by observation count; label_sub (e.g. ``to="quarantined"``)
    restricts to matching label sets."""
    if isinstance(names, str):
        names = (names,)
    total = 0.0
    for snap in snaps:
        if not isinstance(snap, dict):
            continue
        for section in ('counters', 'gauges'):
            for key, v in (snap.get(section) or {}).items():
                name, labels = split_key(key)
                if name in names and (not label_sub or label_sub in labels):
                    total += float(v)
        for key, h in (snap.get('hists') or {}).items():
            name, labels = split_key(key)
            if name in names and (not label_sub or label_sub in labels):
                total += int(h.get('count', 0))
    return total


class AlertRule:
    """One normalized rule plus its evaluation state (sustain/clear
    windows, last rate sample)."""

    def __init__(self, spec: Dict[str, Any]):
        self.name = str(spec['name'])
        self.metric = spec.get('metric') or ()
        self.denominator = spec.get('denominator') or ()
        self.kind = str(spec.get('kind', 'value'))
        self.labels = str(spec.get('labels', ''))
        self.op = str(spec.get('op', '>'))
        self.threshold = float(spec.get('threshold', 0.0))
        self.for_s = float(spec.get('for', 0.0))
        self.clear_for = float(spec.get('clear_for', 0.0))
        self.arm_metric = spec.get('arm_metric') or ()
        if self.kind not in ('value', 'rate', 'ratio'):
            raise ValueError('alert %r: unknown kind %r'
                             % (self.name, self.kind))
        if self.op not in _ALERT_OPS:
            raise ValueError('alert %r: unknown op %r' % (self.name, self.op))
        if self.kind == 'ratio' and not self.denominator:
            raise ValueError('alert %r: ratio needs a denominator'
                             % self.name)
        # evaluation state (engine-lock protected via AlertEngine)
        self.active = False
        self.fired = 0
        self.last_value = 0.0
        self.breach_since: Optional[float] = None
        self.ok_since: Optional[float] = None
        self._prev: Optional[Tuple[float, float, float]] = None  # t, num, den

    def _rates(self, snaps, now) -> Tuple[float, float]:
        num = _metric_value(snaps, self.metric, self.labels)
        den = _metric_value(snaps, self.denominator, self.labels) \
            if self.denominator else 0.0
        prev, self._prev = self._prev, (now, num, den)
        if prev is None or now <= prev[0]:
            return 0.0, 0.0
        dt = now - prev[0]
        return (max(0.0, num - prev[1]) / dt,
                max(0.0, den - prev[2]) / dt)

    def value(self, snaps, now) -> float:
        if self.kind == 'value':
            return _metric_value(snaps, self.metric, self.labels)
        num_rate, den_rate = self._rates(snaps, now)
        if self.kind == 'rate':
            return num_rate
        return (num_rate / den_rate) if den_rate > 0 else 0.0


class AlertEngine:
    """Evaluate declarative SLO rules against merged registry snapshots.

    One engine runs on the learner (against local + merged fleet
    snapshots), one on the fleet resolver, one in the serving service.
    Fired alerts land as ``alerts_active{alert=}`` gauges,
    ``alerts_fired_total{alert=}`` counters, WARNING log transitions,
    flight-recorder events, and — on the learner — an ``alerts`` block in
    every metrics_jsonl record. ``maybe_evaluate`` is cadence-gated so the
    learner loop, the epoch writer and /statusz scrapes share one
    evaluation stream (rates need a stable window)."""

    def __init__(self, rules: Optional[Sequence[Dict[str, Any]]] = None,
                 interval: float = 5.0):
        specs = BUILTIN_ALERTS if rules is None else rules
        self.interval = max(0.2, float(interval))
        self._lock = threading.Lock()
        self._rules = [AlertRule(dict(s)) for s in specs]  # guarded-by: _lock
        self._last: Dict[str, Any] = {'time': 0.0, 'active': [],
                                      'fired': {}, 'values': {}}  # guarded-by: _lock
        self._log = get_logger('alerts')

    @classmethod
    def from_config(cls, args: Optional[Dict[str, Any]]
                    ) -> Optional['AlertEngine']:
        """Build from the ``telemetry.alerts`` block: ``{builtin, interval,
        rules: [...]}`` (or a bare rule list; False/{'enabled': False}
        disables). Returns None with alerting or telemetry off."""
        tel = config_block(args)
        if not tel.get('enabled', True) or not _ENABLED:
            return None
        blk = tel.get('alerts')
        if blk is False:
            return None
        if isinstance(blk, (list, tuple)):
            blk = {'rules': list(blk)}
        if not isinstance(blk, dict):
            blk = {}
        if not blk.get('enabled', True):
            return None
        by_name: Dict[str, Dict[str, Any]] = {}
        if blk.get('builtin', True):
            for spec in BUILTIN_ALERTS:
                by_name[str(spec['name'])] = dict(spec)
        for spec in (blk.get('rules') or []):
            if isinstance(spec, dict) and spec.get('name'):
                merged = dict(by_name.get(str(spec['name'])) or {})
                merged.update(spec)
                by_name[str(spec['name'])] = merged
        return cls(list(by_name.values()),
                   interval=float(blk.get('interval', 5.0)))

    def rule_names(self) -> List[str]:
        with self._lock:
            return [r.name for r in self._rules]

    def evaluate(self, snaps: List[Optional[Dict[str, Any]]],
                 now: Optional[float] = None) -> Dict[str, Any]:
        """One evaluation pass; returns the ``alerts`` block."""
        now = time.time() if now is None else float(now)
        fired, cleared = [], []
        with self._lock:
            for rule in self._rules:
                armed = (not rule.arm_metric
                         or _metric_value(snaps, rule.arm_metric) > 0)
                value = rule.value(snaps, now)
                rule.last_value = value
                breach = armed and _ALERT_OPS[rule.op](value, rule.threshold)
                if breach:
                    rule.ok_since = None
                    if rule.breach_since is None:
                        rule.breach_since = now
                    if (not rule.active
                            and now - rule.breach_since >= rule.for_s):
                        rule.active = True
                        rule.fired += 1
                        fired.append((rule.name, value))
                else:
                    rule.breach_since = None
                    if rule.active:
                        if rule.ok_since is None:
                            rule.ok_since = now
                        if now - rule.ok_since >= rule.clear_for:
                            rule.active = False
                            rule.ok_since = None
                            cleared.append((rule.name, value))
            block = {
                'time': round(now, 3),
                'active': sorted(r.name for r in self._rules if r.active),
                'fired': {r.name: r.fired for r in self._rules if r.fired},
                'values': {r.name: round(r.last_value, 6)
                           for r in self._rules},
            }
            self._last = block
        for name, value in fired:
            counter('alerts_fired_total', alert=name).inc()
            gauge('alerts_active', alert=name).set(1)
            record_event('alert', 'fired %s (value=%g)' % (name, value),
                         alert=name, state='firing')
            self._log.warning('alert FIRING: %s (value=%g)', name, value)
        for name, value in cleared:
            gauge('alerts_active', alert=name).set(0)
            record_event('alert', 'cleared %s (value=%g)' % (name, value),
                         alert=name, state='cleared')
            self._log.warning('alert cleared: %s (value=%g)', name, value)
        return block

    def maybe_evaluate(self, collect: Callable[[], List[Dict[str, Any]]],
                       now: Optional[float] = None) -> Dict[str, Any]:
        """Cadence-gated evaluation: runs a pass at most every
        ``interval`` seconds, otherwise returns the cached block."""
        now = time.time() if now is None else float(now)
        with self._lock:
            fresh = now - float(self._last.get('time') or 0.0) < self.interval
        if fresh:
            return self.block()
        return self.evaluate(collect(), now)

    def poll(self) -> Dict[str, Any]:
        """``maybe_evaluate`` over this process's own registry."""
        return self.maybe_evaluate(lambda: [snapshot()])

    def block(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._last)

    def active(self) -> List[str]:
        with self._lock:
            return [r.name for r in self._rules if r.active]


# ---------------------------------------------------------------------------
# Prometheus text exposition


def _prom_value(v) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def render_prometheus(snaps: List[Dict[str, Any]]) -> str:
    """Render snapshots in Prometheus text exposition format 0.0.4.
    Caller guarantees key disjointness across snapshots (the fleet snapshot
    is relabeled with source="fleet")."""
    types: Dict[str, str] = {}
    lines_by_name: Dict[str, List[str]] = {}

    def emit(name: str, labelstr: str, value, kind: str):
        if not _NAME_RE.match(name):
            return
        types.setdefault(name, kind)
        body = '%s{%s}' % (name, labelstr) if labelstr else name
        lines_by_name.setdefault(name, []).append(
            '%s %s' % (body, _prom_value(value)))

    for snap in snaps:
        if not isinstance(snap, dict):
            continue
        for key, v in (snap.get('counters') or {}).items():
            name, labelstr = split_key(key)
            emit(name, labelstr, v, 'counter')
        for key, v in (snap.get('gauges') or {}).items():
            name, labelstr = split_key(key)
            emit(name, labelstr, v, 'gauge')
        for key, h in (snap.get('hists') or {}).items():
            name, labelstr = split_key(key)
            types.setdefault(name, 'histogram')
            cum = 0
            for bound, n in zip(list(h['bounds']) + ['+Inf'],
                                h['buckets']):
                cum += n
                le = ('+Inf' if bound == '+Inf'
                      else _prom_value(bound))
                ls = (labelstr + ',' if labelstr else '') + 'le="%s"' % le
                lines_by_name.setdefault(name, []).append(
                    '%s_bucket{%s} %d' % (name, ls, cum))
            suffix = '{%s}' % labelstr if labelstr else ''
            lines_by_name.setdefault(name, []).append(
                '%s_sum%s %s' % (name, suffix, _prom_value(h['sum'])))
            lines_by_name.setdefault(name, []).append(
                '%s_count%s %d' % (name, suffix, h['count']))

    out: List[str] = []
    for name in sorted(lines_by_name):
        out.append('# TYPE %s %s' % (name, types[name]))
        out.extend(lines_by_name[name])
    return '\n'.join(out) + ('\n' if out else '')


class TelemetryExporter:
    """Prometheus-style scrape endpoint on stdlib http.server.

    ``collect`` returns the snapshots to serve (called per scrape, so the
    endpoint always shows live registry values); ``port=0`` binds an
    ephemeral port (tests), a fixed port serves operators' scrape configs.
    ``/metrics`` answers the exposition text, ``/healthz`` a liveness
    ``ok`` line, ``/statusz`` a JSON health view (run identity, recorder
    stats, plus whatever the ``status`` callable contributes — active
    alerts, fleet states, run progress); every other path 404s.
    """

    def __init__(self, collect: Callable[[], List[Dict[str, Any]]],
                 port: int = 0, host: str = '',
                 status: Optional[Callable[[], Dict[str, Any]]] = None):
        self._collect = collect
        self._status = status
        self._host = host
        self._port = int(port)
        self._server = None
        self._thread = None

    @property
    def port(self) -> int:
        return self._port

    def status_payload(self) -> Dict[str, Any]:
        """The /statusz JSON: base process identity + recorder stats,
        overlaid with the owner's status callable (alerts, fleet states,
        progress, SLO snapshots)."""
        base: Dict[str, Any] = {
            'run_id': _RUN_ID, 'role': _TRACE.label, 'pid': os.getpid(),
            'time': round(time.time(), 3), 'recorder': recorder_stats()}
        if self._status is not None:
            extra = self._status()
            if isinstance(extra, dict):
                base.update(extra)
        return base

    def start(self) -> 'TelemetryExporter':
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def _respond(self, body: bytes, ctype: str):
                self.send_response(200)
                self.send_header('Content-Type', ctype)
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (http.server API)
                path = self.path.split('?')[0]
                if path == '/healthz':
                    self._respond(b'ok\n', 'text/plain; charset=utf-8')
                    return
                if path == '/statusz':
                    try:
                        body = json.dumps(exporter.status_payload(),
                                          sort_keys=True).encode()
                    except Exception as exc:   # a broken status callable
                        self.send_error(500, str(exc)[:120])   # 500s, only
                        return
                    self._respond(body, 'application/json; charset=utf-8')
                    return
                if path not in ('/metrics', '/'):
                    self.send_error(404)
                    return
                try:
                    body = render_prometheus(exporter._collect()).encode()
                except Exception as exc:   # a broken collector must not
                    self.send_error(500, str(exc)[:120])   # kill the server
                    return
                self._respond(
                    body, 'text/plain; version=0.0.4; charset=utf-8')

            def log_message(self, fmt, *args):
                get_logger('exporter').debug(fmt, *args)

        # Bind with retry, then fall back to an ephemeral port: a stale
        # TIME_WAIT socket or a colliding process on the configured
        # telemetry_port must degrade the scrape target, not crash the
        # learner. The actual bound port is logged (and kept on .port).
        log = get_logger('exporter')
        requested = self._port
        attempts = ([requested] * 3 + [0]) if requested else [0]
        server, last_err = None, None
        for i, port in enumerate(attempts):
            try:
                server = ThreadingHTTPServer((self._host, port), Handler)
                break
            except OSError as exc:
                last_err = exc
                if port and i + 1 < len(attempts) and attempts[i + 1]:
                    log.warning('telemetry port %d bind failed (%s); '
                                'retrying', port, exc)
                    time.sleep(0.2 * (i + 1))
        if server is None:
            log.error('telemetry exporter could not bind any port (%s); '
                      'exporter disabled for this run', last_err)
            return self
        self._server = server
        self._server.daemon_threads = True
        self._port = self._server.server_address[1]
        if requested and self._port != requested:
            counter('telemetry_port_fallbacks_total').inc()
            log.warning('telemetry_port %d unavailable (%s); serving '
                        '/metrics on ephemeral port %d instead',
                        requested, last_err, self._port)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name='telemetry-exporter',
                                        daemon=True)
        self._thread.start()
        log.info('telemetry exporter serving /metrics on port %d',
                 self._port)
        return self

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


def start_exporter(port: int, status: Optional[Callable[[], Dict[str, Any]]]
                   = None) -> Tuple[Optional[TelemetryExporter], int]:
    """Serve this process's registry on ``port`` (``status`` fills
    /statusz) when a port is set and telemetry is on. Returns the started
    exporter, None when it is off, and the port it bound."""
    if not port or not _ENABLED:
        return None, port
    exporter = TelemetryExporter(lambda: [snapshot()], port=port,
                                 status=status).start()
    return exporter, exporter.port


# ---------------------------------------------------------------------------
# Compiled-performance plane: device-memory gauges, the steady-state
# retrace sentinel, and the dispatch/host_block utilization proxy. All
# process-local state lives in the two dicts below so tests can reset it.

RETRACE_POLICIES = ('warn', 'abort', 'off')

_PERF_PLANE: Dict[str, Any] = {
    'enabled': True, 'retrace': 'warn', 'last_mem': [], 'util': None}

_STEADY: Dict[str, Any] = {
    'on': False, 'since': 0.0, 'retraces': 0, 'note': '',
    'last_compile': ''}


class RetraceError(RuntimeError):
    """Raised where a CUDA graph is captured or a kernel library built
    after steady state under the ``abort`` policy
    (``HANDYRL_TPU_RETRACE=abort``)."""


def configure_perf_plane(enabled=None, retrace=None):
    """Adopt the ``telemetry.perf_plane`` / ``telemetry.retrace`` config
    knobs (called from adopt_config on every process in the fleet)."""
    if enabled is not None:
        _PERF_PLANE['enabled'] = bool(enabled)
    if retrace is not None:
        retrace = str(retrace).strip().lower()
        if retrace in RETRACE_POLICIES:
            _PERF_PLANE['retrace'] = retrace


def perf_plane_enabled() -> bool:
    return _ENABLED and bool(_PERF_PLANE['enabled'])


def retrace_policy() -> str:
    """Active retrace policy: the HANDYRL_TPU_RETRACE env knob (the CI
    override) wins over the ``telemetry.retrace`` config value."""
    env = os.environ.get('HANDYRL_TPU_RETRACE', '').strip().lower()
    if env in RETRACE_POLICIES:
        return env
    return _PERF_PLANE['retrace']


def mark_steady_state(note: str = '') -> bool:
    """Declare warm-up over: from here on, every CUDA graph capture and
    kernel library build outside an :func:`expected_compile` scope is a
    retrace the sentinel counts, records, and (under the abort policy)
    raises on. The learner crosses this boundary after
    ``retrace_warmup_epochs``, the device actor after its warm-up."""
    if not perf_plane_enabled():
        return False
    if _STEADY['on']:
        return True
    _STEADY.update(on=True, since=time.time(), retraces=0, note=note)
    gauge('xla_steady_state').set(1)
    record_event('steady_state', 'steady state marked%s'
                 % ((': ' + note) if note else ''), policy=retrace_policy())
    return True


def clear_steady_state():
    """Leave steady state (learner shutdown, or test teardown). The flag is
    process-global, so an in-process learner must clear it or a later
    capture in the same process would trip the sentinel."""
    _STEADY.update(on=False, note='', last_compile='')
    gauge('xla_steady_state').set(0)


def steady_state_active() -> bool:
    return bool(_STEADY['on'])


def steady_retrace_count() -> int:
    return int(_STEADY['retraces'])


# Helpers that legitimately capture or build after warm-up (a fresh shape
# by design) declare the scope with expected_compile(); the sentinel books
# those under xla_expected_compiles_total instead of as retraces.
# Thread-local: a capture runs on the thread that opened the scope.
_EXPECTED_COMPILE = threading.local()


@contextmanager
def expected_compile(reason: str = ''):
    """Declare that a graph capture or kernel build inside this scope is
    expected, exempting it from the retrace sentinel's count/warn/abort
    path."""
    depth = getattr(_EXPECTED_COMPILE, 'depth', 0)
    _EXPECTED_COMPILE.depth = depth + 1
    _EXPECTED_COMPILE.reason = reason
    try:
        yield
    finally:
        _EXPECTED_COMPILE.depth = depth


def _in_expected_compile() -> bool:
    return getattr(_EXPECTED_COMPILE, 'depth', 0) > 0


@contextmanager
def compile_scope(kind: str, what: str = '', of_warmup: bool = False):
    """One run-time compile (``kind``: 'graph_capture' or 'kernel_build'),
    counted in ``xla_compile_events_total{event=kind}`` and timed into
    ``xla_compile_seconds``. After steady state the sentinel sees it
    before it starts, so under the abort policy nothing is captured or
    built; ``of_warmup`` marks the capture that completes a program whose
    first call came before steady state (``ops/graphs.CapturedCall``),
    which the sentinel does not see."""
    _STEADY['last_compile'] = ('%s %s' % (kind, what)).strip()[:300]
    if _STEADY['on'] and not of_warmup:
        _note_retrace(kind)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        counter('xla_compile_events_total', event=kind).inc()
        histogram('xla_compile_seconds', buckets=COMPILE_SECOND_BUCKETS
                  ).observe(time.perf_counter() - t0)


def _note_retrace(event: str):
    """One post-steady-state capture or build: count it, flight-record it,
    warn, and under the abort policy raise at the call site. The raise
    sits outside the metric try/except on purpose."""
    policy = retrace_policy()
    if policy == 'off':
        return
    if _in_expected_compile():
        try:
            counter('xla_expected_compiles_total').inc()
        except Exception:
            pass
        return
    who = _STEADY['last_compile'] or ('event ' + event)
    try:
        _STEADY['retraces'] += 1
        counter('xla_retraces_total').inc()
        record_event('retrace', 'steady-state retrace: %s' % who,
                     policy=policy, count=_STEADY['retraces'])
        get_logger('retrace').warning(
            'steady-state retrace #%d (%s): a new shape or a rebuilt '
            'library is recompiling the hot path', _STEADY['retraces'], who)
    except Exception:
        pass
    if policy == 'abort':
        raise RetraceError(
            'steady-state retrace under HANDYRL_TPU_RETRACE=abort: %s' % who)


def _rss_memory() -> Dict[str, int]:
    """The process-RSS row: RSS (current), VmHWM (peak), physical RAM
    (limit), from procfs."""
    in_use = peak = limit = 0
    try:
        page = os.sysconf('SC_PAGE_SIZE')
        with open('/proc/self/statm') as fh:
            in_use = int(fh.read().split()[1]) * page
        limit = os.sysconf('SC_PHYS_PAGES') * page
    except Exception:
        pass
    try:
        with open('/proc/self/status') as fh:
            for line in fh:
                if line.startswith('VmHWM:'):
                    peak = int(line.split()[1]) * 1024
                    break
    except Exception:
        try:
            import resource
            peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        except Exception:
            pass
    return {'bytes_in_use': in_use,
            'peak_bytes_in_use': max(peak, in_use),
            'bytes_limit': limit}


def _cuda_memory_row(torch, index: int) -> Dict[str, Any]:
    stats = torch.cuda.memory_stats(index)
    _free, total = torch.cuda.mem_get_info(index)
    in_use = int(stats.get('allocated_bytes.all.current', 0))
    return {'device': 'cuda:%d' % index, 'bytes_in_use': in_use,
            'peak_bytes_in_use': int(stats.get('allocated_bytes.all.peak',
                                               in_use)),
            'bytes_limit': int(total)}


def sample_device_memory(devices=None):
    """Sample per-device memory into the ``device_mem_bytes_*`` gauges.
    A process that has initialized CUDA reports its current card (or each
    index in ``devices``) from ``torch.cuda.memory_stats`` (bytes the
    caching allocator has handed out, current and peak) with the card's
    total from ``torch.cuda.mem_get_info`` as the limit, labelled
    ``cuda:<index>``; any other process (the CPU, a gather that never
    loads torch) one process-RSS row labelled ``process_rss``, as the JAX
    package reports a CPU backend."""
    if not perf_plane_enabled():
        return []
    torch = sys.modules.get('torch')
    rows = []
    if torch is not None:
        try:
            if devices is None and torch.cuda.is_initialized():
                devices = [torch.cuda.current_device()]
            for dev in devices or ():
                index = getattr(dev, 'index', dev)
                rows.append(_cuda_memory_row(
                    torch, torch.cuda.current_device() if index is None
                    else int(index)))
        except Exception:
            rows = []
    if not rows:
        rows = [dict(_rss_memory(), device='process_rss')]
    for row in rows:
        dev = row['device']
        gauge('device_mem_bytes_in_use', device=dev).set(row['bytes_in_use'])
        gauge('device_mem_bytes_peak', device=dev).set(
            row['peak_bytes_in_use'])
        gauge('device_mem_bytes_limit', device=dev).set(row['bytes_limit'])
    _PERF_PLANE['last_mem'] = rows
    return rows


def device_memory_utilization(rows=None):
    """Worst-case bytes_in_use/bytes_limit across sampled devices — the
    ``hbm_pressure`` alert input. Only the learner publishes the
    ``device_mem_utilization`` gauge (a ratio must not be summed across
    fleet snapshots the way counters are)."""
    rows = _PERF_PLANE['last_mem'] if rows is None else rows
    util = 0.0
    for row in rows:
        limit = float(row.get('bytes_limit') or 0)
        if limit > 0:
            util = max(util, float(row.get('bytes_in_use', 0)) / limit)
    return util


def utilization_from_stages(stages) -> Optional[float]:
    """Device-utilization proxy from one epoch's ingest-stage seconds:
    host_block / total. Near 1.0 the host spends the epoch waiting on the
    device (device-bound, good); near 0.0 the device is starving behind
    host work (select/decode/assemble/ipc/h2d/dispatch). Accepts plain
    ``{stage: seconds}`` or StageTimer.snapshot's ``{stage: {'s':..}}``."""

    def _sec(val):
        if isinstance(val, dict):
            val = val.get('s', 0.0)
        return float(val or 0.0)

    try:
        total = sum(_sec(stages.get(s)) for s in INGEST_STAGES)
        block = _sec(stages.get('host_block'))
    except Exception:
        return None
    if total <= 0:
        return None
    return block / total


def set_utilization_proxy(value):
    if value is None or not perf_plane_enabled():
        return
    value = max(0.0, min(1.0, float(value)))
    _PERF_PLANE['util'] = value
    gauge('device_utilization_proxy').set(value)


def perf_status() -> Dict[str, Any]:
    """Compiled-performance block for /statusz (rendered by --status)."""
    return {
        'steady_state': bool(_STEADY['on']),
        'retraces': int(_STEADY['retraces']),
        'retrace_policy': retrace_policy(),
        'device_memory': list(_PERF_PLANE['last_mem']),
        'device_mem_utilization': device_memory_utilization(),
        'device_utilization_proxy': _PERF_PLANE['util']}


# ---------------------------------------------------------------------------
# JSONL schema helper (shared by tests and the CI smoke script)

FLEET_KEYS = ('epoch', 'steps', 'episodes', 'time', 'run_id', 'telemetry')


def validate_metrics_line(line: str, fleet: bool = False) -> Dict[str, Any]:
    """Parse one metrics_jsonl line and assert the telemetry schema: the
    base keys always, plus the merged ``fleet_telemetry`` aggregate when
    ``fleet`` (server-mode runs). Raises ValueError on any violation."""
    rec = json.loads(line)
    for key in FLEET_KEYS:
        if key not in rec:
            raise ValueError('metrics line missing %r: %s' % (key, line[:120]))
    tel = rec['telemetry']
    if not isinstance(tel, dict) or 'counters' not in tel:
        raise ValueError('telemetry summary malformed: %r' % (tel,))
    if fleet:
        ft = rec.get('fleet_telemetry')
        if not isinstance(ft, dict) or 'counters' not in ft:
            raise ValueError('fleet_telemetry missing/malformed: %r' % (ft,))
    if 'alerts' in rec:
        ab = rec['alerts']
        if not isinstance(ab, dict) or 'active' not in ab:
            raise ValueError('alerts block malformed: %r' % (ab,))
    return rec


# ---------------------------------------------------------------------------
# operator status view (``python -m handyrl_tpu_torch --status HOST:PORT``)


def fetch_statusz(target: str, timeout: float = 5.0) -> Dict[str, Any]:
    """GET http://<target>/statusz and parse the JSON payload."""
    import urllib.request
    with urllib.request.urlopen('http://%s/statusz' % target,
                                timeout=timeout) as resp:
        return json.loads(resp.read().decode('utf-8'))


def render_status(payload: Dict[str, Any]) -> str:
    """Human-readable rendering of one /statusz payload."""
    lines = ['%s pid=%s run=%s' % (payload.get('role', '?'),
                                   payload.get('pid', '?'),
                                   payload.get('run_id', '?'))]
    progress = payload.get('progress')
    if isinstance(progress, dict):
        lines.append('progress: ' + ' '.join(
            '%s=%s' % (k, progress[k]) for k in sorted(progress)))
    alerts = payload.get('alerts')
    if isinstance(alerts, dict):
        active = alerts.get('active') or []
        lines.append('alerts: %s'
                     % (', '.join('FIRING %s' % a for a in active)
                        if active else 'none active'))
        fired = alerts.get('fired') or {}
        if fired:
            lines.append('  fired so far: ' + ', '.join(
                '%s x%d' % (k, fired[k]) for k in sorted(fired)))
    for key in ('fleet_hosts', 'fleet_replicas'):
        states = payload.get(key)
        if isinstance(states, dict) and states:
            lines.append('%s: ' % key.replace('_', ' ') + ', '.join(
                '%s=%s' % (k, states[k]) for k in sorted(states)))
    slo = payload.get('slo')
    if isinstance(slo, dict):
        lines.append('slo: ' + ' '.join(
            '%s=%s' % (k, slo[k]) for k in sorted(slo)))
    perf = payload.get('perf')
    if isinstance(perf, dict):
        bits = ['steady' if perf.get('steady_state') else 'warming',
                'retraces=%s' % perf.get('retraces', 0),
                'policy=%s' % perf.get('retrace_policy', '?')]
        util = perf.get('device_utilization_proxy')
        if util is not None:
            bits.append('device_util=%.0f%%' % (float(util) * 100.0))
        mem_util = perf.get('device_mem_utilization')
        if mem_util:
            bits.append('mem_util=%.0f%%' % (float(mem_util) * 100.0))
        lines.append('perf: ' + ' '.join(bits))
        for row in perf.get('device_memory') or []:
            limit = row.get('bytes_limit') or 0
            lines.append('  mem %s: %.0f MiB in use (peak %.0f) of %s'
                         % (row.get('device', '?'),
                            row.get('bytes_in_use', 0) / 2**20,
                            row.get('peak_bytes_in_use', 0) / 2**20,
                            ('%.0f MiB' % (limit / 2**20)) if limit
                            else 'unknown'))
    sessions = payload.get('sessions')
    if isinstance(sessions, list) and sessions:
        lines.append('sessions: %d active' % len(sessions))
        lines.append('  %-12s %-14s %6s %9s %9s %-8s'
                     % ('sid', 'client', 'plies', 'version', 'ply_p99',
                        'replica'))
        for s in sessions:
            p99 = s.get('ply_p99_ms')
            lines.append('  %-12s %-14s %6s %9s %9s %-8s'
                         % (s.get('sid', '?'), s.get('client', '?'),
                            s.get('plies', 0), s.get('version') or '-',
                            ('%.1fms' % p99) if p99 is not None else '-',
                            s.get('replica') or '-'))
    requests = payload.get('requests')
    if isinstance(requests, list) and requests:
        lines.append('requests:')
        lines.append('  %-10s %8s %9s %9s %9s %9s %s'
                     % ('replica', 'inflight', 'p50', 'p99', 'received',
                        'answered', 'state'))
        for r in requests:
            lines.append('  %-10s %8s %8.1fms %8.1fms %9s %9s %s'
                         % (r.get('replica', '?'), r.get('inflight', 0),
                            float(r.get('p50_ms') or 0.0),
                            float(r.get('p99_ms') or 0.0),
                            r.get('received', 0), r.get('answered', 0),
                            'draining' if r.get('draining') else 'serving'))
    rec = payload.get('recorder')
    if isinstance(rec, dict):
        lines.append('recorder: %s/%s events (%s dropped), %d dump(s)'
                     % (rec.get('events', 0), rec.get('capacity', 0),
                        rec.get('dropped', 0), len(rec.get('dumps') or [])))
    return '\n'.join(lines)


def status_main(args: Optional[Dict[str, Any]], argv: Sequence[str]):
    """``python -m handyrl_tpu_torch --status HOST:PORT``: fetch a live
    /statusz (the learner's telemetry_port) and render it; exit 1 when
    the fetch fails."""
    rest = [a for a in argv if not a.startswith('--')]
    target = rest[0] if rest else ''
    if not target:
        port = int((args or {}).get('telemetry_port') or 0)
        if port:
            target = 'localhost:%d' % port
    if not target:
        print('usage: python -m handyrl_tpu_torch --status <host:port> '
              '[--json]')
        raise SystemExit(1)
    if ':' not in target:
        target = 'localhost:' + target
    try:
        payload = fetch_statusz(target)
    except Exception as exc:
        print('status fetch from %s failed: %s' % (target, exc))
        raise SystemExit(1)
    if '--json' in argv:
        print(json.dumps(payload, indent=2, sort_keys=True))
    else:
        print(render_status(payload))
    return payload
