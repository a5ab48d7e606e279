"""Collate the port's blackbox dumps into a cross-process postmortem.

The counterpart of ``scripts/postmortem.py`` for ``handyrl_tpu_torch``,
with the same CLI, the same ``--json`` schema and the same exit contract;
on the same dumps both print the same JSON (the two packages write one
dump format, ``handyrl_tpu.blackbox/1``). Stdlib only.

Input: the ``blackbox/`` directory (``telemetry.blackbox_dir``) of
flight-recorder dumps every process of a run writes on abnormal death
(``telemetry.dump_blackbox``: a fatal error, a preemption signal, a
nonfinite abort, a supervisor's crash declaration such as a worker host's
``gather-death``), plus optionally the run's ``trace-<run_id>.jsonl``
stream and the learner's ``metrics_jsonl`` file. Output: one causal
timeline across processes: which process failed FIRST, the last-N
flight-recorder events before each death, and the alert transitions the
learner's SLO engine recorded around the failure window.

The first failure is attributed by the earliest *triggering event* among
the dumps: a dump's own recorder ring usually contains the supervisor or
guard event that declared the death, so dumps are ordered by the time of
their final recorded event (falling back to the dump timestamp): a
supervisor that dumped late about an early death still sorts first.

Exit code: 0 when at least one blackbox dump was found and a causal
timeline could be built, 2 otherwise.

Usage:
    python scripts/torch_postmortem.py [BLACKBOX_DIR]
        [--trace DIR-or-file] [--metrics PATH] [--run RUN_ID]
        [--last N] [--json]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional

BLACKBOX_SCHEMA = 'handyrl_tpu.blackbox/1'


def discover_dumps(path: str, run_id: Optional[str] = None
                   ) -> List[Dict[str, Any]]:
    """Load every parseable blackbox dump under ``path`` (a directory of
    ``<role>-<pid>-<run_id>.json`` files, or one such file), optionally
    filtered to one run id. Unreadable files are skipped with a warning —
    a postmortem must degrade, not crash."""
    if os.path.isfile(path):
        files = [path]
    else:
        files = sorted(glob.glob(os.path.join(path, '*.json')))
    dumps = []
    for fp in files:
        try:
            with open(fp) as f:
                payload = json.load(f)
        except (OSError, ValueError) as exc:
            print('warning: skipping unreadable %s (%s)' % (fp, exc),
                  file=sys.stderr)
            continue
        if not isinstance(payload, dict) \
                or payload.get('schema') != BLACKBOX_SCHEMA:
            continue
        if run_id and str(payload.get('run_id')) != str(run_id):
            continue
        payload['_path'] = fp
        dumps.append(payload)
    return dumps


def failure_time(dump: Dict[str, Any]) -> float:
    """The moment this dump's process (or the process it declared dead)
    actually failed: the last recorded event's timestamp when present —
    the ring ends at the death — else the dump write time."""
    events = dump.get('events') or []
    if events:
        try:
            return float(events[-1].get('t', 0.0))
        except (TypeError, ValueError):
            pass
    return float(dump.get('time', 0.0))


def load_metrics_alerts(path: str, run_id: Optional[str] = None
                        ) -> List[Dict[str, Any]]:
    """Alert transitions reconstructed from the metrics_jsonl stream:
    one entry per rule appearance/disappearance in successive records'
    ``alerts.active`` lists (plus the final cumulative fired counts).
    Reads ``<path>.1`` first when a rotation generation exists."""
    records: List[Dict[str, Any]] = []
    for fp in (path + '.1', path):
        if not os.path.isfile(fp):
            continue
        try:
            with open(fp) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue   # torn tail line from a killed learner
                    if run_id and str(rec.get('run_id')) != str(run_id):
                        continue
                    if isinstance(rec.get('alerts'), dict):
                        records.append(rec)
        except OSError as exc:
            print('warning: skipping unreadable %s (%s)' % (fp, exc),
                  file=sys.stderr)
    transitions: List[Dict[str, Any]] = []
    prev_active: set = set()
    prev_fired: Dict[str, int] = {}
    for rec in records:
        blk = rec['alerts']
        active = set(blk.get('active') or [])
        t = float(blk.get('time') or rec.get('time') or 0.0)
        for name in sorted(active - prev_active):
            transitions.append({'t': t, 'alert': name, 'state': 'firing'})
        for name in sorted(prev_active - active):
            transitions.append({'t': t, 'alert': name, 'state': 'cleared'})
        # records land per epoch but alerts evaluate every few seconds: a
        # rule that fired AND cleared entirely between two records never
        # shows in any active set — only its cumulative fired count moves
        fired_now = {k: int(v) for k, v in (blk.get('fired') or {}).items()}
        for name, n in sorted(fired_now.items()):
            if n > prev_fired.get(name, 0) and name not in active \
                    and name not in prev_active:
                transitions.append({'t': t, 'alert': name,
                                    'state': 'fired+cleared'})
        if fired_now:
            prev_fired = fired_now
        prev_active = active
    fired = dict((records[-1]['alerts'].get('fired') or {})) \
        if records else {}
    return [{'transitions': transitions, 'fired': fired,
             'records': len(records),
             'still_active': sorted(prev_active)}]


def load_trace_activity(path: str) -> Dict[str, Any]:
    """Per-pid last-activity marks from the trace stream: when a process
    stops emitting spans, that silence brackets its death from the other
    side of the blackbox evidence."""
    files: List[str] = []
    if os.path.isfile(path):
        files = [path]
    elif os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, 'trace-*.jsonl')))
    last_by_pid: Dict[int, float] = {}
    events = 0
    for fp in files:
        try:
            with open(fp) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        ev = json.loads(line)
                    except ValueError:
                        continue
                    if ev.get('ph') != 'X':
                        continue
                    events += 1
                    pid = int(ev.get('pid', 0))
                    t = (int(ev.get('ts', 0))
                         + int(ev.get('dur', 0))) / 1e6
                    if t > last_by_pid.get(pid, 0.0):
                        last_by_pid[pid] = t
        except OSError as exc:
            print('warning: skipping unreadable %s (%s)' % (fp, exc),
                  file=sys.stderr)
    return {'events': events,
            'last_activity': {str(pid): round(t, 6)
                              for pid, t in sorted(last_by_pid.items())}}


def build_report(dumps: List[Dict[str, Any]], last_n: int,
                 alerts: Optional[Dict[str, Any]] = None,
                 trace: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    deaths = []
    for dump in sorted(dumps, key=failure_time):
        events = dump.get('events') or []
        deaths.append({
            'role': dump.get('role'), 'pid': dump.get('pid'),
            'run_id': dump.get('run_id'), 'reason': dump.get('reason'),
            'time': failure_time(dump),
            'dumped_at': dump.get('time'),
            'path': dump.get('_path'),
            'context': dump.get('context') or {},
            'last_events': events[-last_n:],
        })
    timeline: List[Dict[str, Any]] = []
    for death in deaths:
        who = '%s[%s]' % (death['role'], death['pid'])
        for ev in death['last_events']:
            timeline.append({'t': float(ev.get('t', 0.0)), 'source': who,
                             'kind': ev.get('kind'), 'msg': ev.get('msg')})
        timeline.append({'t': death['time'], 'source': who,
                         'kind': 'death',
                         'msg': 'declared dead (%s)' % death['reason']})
    if alerts:
        for tr in alerts.get('transitions') or []:
            timeline.append({'t': float(tr['t']), 'source': 'alerts',
                             'kind': 'alert',
                             'msg': '%s %s' % (tr['alert'], tr['state'])})
    timeline.sort(key=lambda e: e['t'])
    report: Dict[str, Any] = {
        'schema': 'handyrl_tpu.postmortem/1',
        'dumps': len(deaths),
        'runs': sorted({str(d['run_id']) for d in deaths}),
        'first_failure': deaths[0] if deaths else None,
        'deaths': deaths,
        'timeline': timeline,
    }
    if alerts is not None:
        report['alerts'] = alerts
    if trace is not None:
        report['trace'] = trace
    return report


def render(report: Dict[str, Any]):
    first = report.get('first_failure')
    print('postmortem: %d blackbox dump(s) across run(s) %s'
          % (report['dumps'], ', '.join(report['runs']) or '-'))
    if first:
        print('first failure: %s (pid %s) — %s at %.3f'
              % (first['role'], first['pid'], first['reason'],
                 first['time']))
    for death in report['deaths']:
        print('\n%s (pid %s): %s — last %d event(s):'
              % (death['role'], death['pid'], death['reason'],
                 len(death['last_events'])))
        for ev in death['last_events']:
            print('  %.3f %-10s %s'
                  % (float(ev.get('t', 0.0)), ev.get('kind', '?'),
                     ev.get('msg', '')))
    alerts = report.get('alerts')
    if alerts:
        fired = alerts.get('fired') or {}
        if fired:
            print('\nalerts fired: '
                  + ', '.join('%s x%d' % kv for kv in sorted(fired.items())))
        if alerts.get('still_active'):
            print('alerts still active: '
                  + ', '.join(alerts['still_active']))
        for tr in (alerts.get('transitions') or [])[-10:]:
            print('  %.3f alert %s %s'
                  % (tr['t'], tr['alert'], tr['state']))
    print('\ncausal timeline (%d entries):' % len(report['timeline']))
    for ev in report['timeline'][-40:]:
        print('  %.3f %-20s %-10s %s'
              % (ev['t'], ev['source'], ev['kind'], ev['msg']))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('blackbox', nargs='?', default='blackbox',
                        help='blackbox dump directory (or one dump file)')
    parser.add_argument('--trace', metavar='PATH',
                        help='trace dir or trace-<run_id>.jsonl file')
    parser.add_argument('--metrics', metavar='PATH',
                        help='the learner metrics_jsonl file')
    parser.add_argument('--run', metavar='RUN_ID',
                        help='only consider dumps/records from this run')
    parser.add_argument('--last', type=int, default=20, metavar='N',
                        help='events to keep before each death (default 20)')
    parser.add_argument('--json', action='store_true',
                        help='machine-readable report (one JSON object)')
    opts = parser.parse_args(argv)

    dumps = discover_dumps(opts.blackbox, run_id=opts.run)
    alerts = None
    if opts.metrics:
        alerts = load_metrics_alerts(opts.metrics, run_id=opts.run)[0]
    trace = load_trace_activity(opts.trace) if opts.trace else None
    report = build_report(dumps, max(1, opts.last), alerts=alerts,
                          trace=trace)
    if opts.json:
        print(json.dumps(report))
    else:
        render(report)
    # exit contract: evidence found and a timeline built => 0, else 2
    return 0 if report['dumps'] > 0 and report['timeline'] else 2


if __name__ == '__main__':
    sys.exit(main())
