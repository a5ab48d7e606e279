"""Collate the port's trace files into a critical-path summary.

The counterpart of ``scripts/trace_report.py`` for ``handyrl_tpu_torch``,
with the same CLI, the same ``--json`` schema and the same exit contract;
on the same files both print the same JSON (the two packages write one
trace format). Stdlib only.

Input: a trace directory (``telemetry.trace_dir``, ``HANDYRL_TPU_TRACE``)
holding the per-run ``trace-<run_id>.jsonl`` event stream (and/or the
finalized ``trace-<run_id>.json`` Chrome-trace file), or a single file of
either flavor. Every event is a Chrome-trace "complete" event;
episode-linked events carry ``args.trace_id`` (derived from the
server-stamped task) and the learner's ``train_step`` events carry
``args.trace_ids``: the sampled episodes whose windows that update
consumed.

Output: a per-stage latency table, the per-episode critical path
(task_assign -> generate -> upload -> ingest -> train_step) with
generation->gradient p50/p95, and the batch-level stage summaries. The
port's learner times its ingest as select, ipc, h2d, dispatch and
host_block (it has no decode or assemble stage; a JAX trace's are
summarized too). ``--chrome OUT`` additionally writes one merged
Chrome-trace JSON across every run found.

``--serve`` additionally reduces the serving-path spans: per-hop latency
percentiles (client_request -> route_dispatch -> serve_request ->
queue_wait -> engine_batch), the queue-wait vs batch-compute split per
replica, failover replay and journal-reconstruction chains (link spans
carrying the ORIGINAL trace_id), and per-session gateway ply timelines.

Exit code: 0 when at least one complete chain of the required kind was
found, 2 otherwise. ``--require training|serve|any`` picks the kind; the
default is ``training`` unless ``--serve`` is given (so a serve-only run,
with no learner, does not report failure).

Usage:
    python scripts/torch_trace_report.py <dir-or-file> [--chrome OUT]
                                         [--json] [--serve]
                                         [--require KIND]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

# the episode-lifecycle stage chain, in causal order; 'evaluate' chains
# are reported too but only generation chains feed the
# generation->gradient headline
CHAIN_STAGES = ('task_assign', 'generate', 'upload', 'ingest', 'train_step')

# batch-level stages worth a duration summary when present: the port's
# ingest stages (select, ipc, h2d, dispatch, host_block) and the JAX
# learner's decode and assemble, so that either package's file reads the
# same
BATCH_STAGES = ('select', 'decode', 'assemble', 'ipc', 'h2d', 'dispatch',
                'host_block', 'engine_batch', 'generate', 'upload',
                'evaluate')

# the serving-path request chain, in causal order (client submit ->
# router dispatch -> replica service -> engine queue -> forward batch)
SERVE_CHAIN_STAGES = ('client_request', 'route_dispatch', 'serve_request',
                      'queue_wait', 'engine_batch')

# link spans: re-dispatches that carry the ORIGINAL trace_id so a
# failover reads as one causal chain (args.link names the kind)
SERVE_LINK_STAGES = ('router_replay', 'gateway_handoff',
                     'gateway_reconstruct')

# gateway session-tier spans (per-session ply timelines)
GATEWAY_STAGES = ('gateway_open', 'gateway_ply', 'gateway_seat')


def discover_files(path: str) -> List[str]:
    """Trace files under ``path``: per run, prefer the append-forever JSONL
    (a superset of the finalized snapshot) and fall back to the .json."""
    if os.path.isfile(path):
        return [path]
    jsonls = sorted(glob.glob(os.path.join(path, 'trace-*.jsonl')))
    have = {os.path.splitext(os.path.basename(p))[0] for p in jsonls}
    jsons = [p for p in sorted(glob.glob(os.path.join(path, 'trace-*.json')))
             if os.path.splitext(os.path.basename(p))[0] not in have]
    return jsonls + jsons


def load_events(files: List[str]) -> List[Dict[str, Any]]:
    events: List[Dict[str, Any]] = []
    for path in files:
        try:
            with open(path) as f:
                if path.endswith('.json'):
                    events.extend(json.load(f).get('traceEvents', []))
                    continue
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        events.append(json.loads(line))
                    except ValueError:
                        continue   # torn tail line from a killed process
        except (OSError, ValueError) as exc:
            print('warning: skipping unreadable %s (%s)' % (path, exc),
                  file=sys.stderr)
    return events


def build_chains(events: List[Dict[str, Any]]
                 ) -> Dict[str, Dict[str, Tuple[int, int, int]]]:
    """trace_id -> {stage: (ts, dur, pid)}; the earliest event wins per
    stage (re-issues/resends may repeat a stage — the first occurrence is
    the critical-path one, later ones are retries)."""
    chains: Dict[str, Dict[str, Tuple[int, int, int]]] = defaultdict(dict)

    def note(tid, stage, ev):
        cur = chains[tid].get(stage)
        ent = (int(ev.get('ts', 0)), int(ev.get('dur', 0)),
               int(ev.get('pid', 0)))
        if cur is None or ent[0] < cur[0]:
            chains[tid][stage] = ent

    for ev in events:
        if ev.get('ph') != 'X':
            continue
        args = ev.get('args') or {}
        name = ev.get('name')
        tid = args.get('trace_id')
        if tid and name in CHAIN_STAGES:
            note(tid, name, ev)
        for linked in (args.get('trace_ids') or ()):
            if name == 'train_step':
                note(linked, 'train_step', ev)
    return chains


def chain_errors(stages: Dict[str, Tuple[int, int, int]]) -> List[str]:
    """Causal-order violations within one chain: each present stage must
    START no earlier than the previous present stage's start (spans may
    overlap across hosts by clock skew; a start-order inversion beyond
    that indicates broken propagation)."""
    errors = []
    prev: Optional[Tuple[str, int]] = None
    for stage in CHAIN_STAGES:
        ent = stages.get(stage)
        if ent is None:
            continue
        if prev is not None and ent[0] < prev[1]:
            errors.append('%s starts before %s' % (stage, prev[0]))
        prev = (stage, ent[0])
    return errors


def build_serve_chains(events: List[Dict[str, Any]]
                       ) -> Dict[str, Dict[str, Any]]:
    """trace_id -> serving-path chain record: the earliest event per hop
    stage (``engine_batch`` links through ``args.trace_ids``, like
    train_step), plus EVERY link span (replays/handoffs/reconstructs
    repeat legitimately — each one is part of the causal story, not a
    retry to collapse)."""
    chains: Dict[str, Dict[str, Any]] = defaultdict(
        lambda: {'stages': {}, 'links': []})

    def note(tid, stage, ev):
        stages = chains[tid]['stages']
        cur = stages.get(stage)
        ent = (int(ev.get('ts', 0)), int(ev.get('dur', 0)),
               int(ev.get('pid', 0)))
        if cur is None or ent[0] < cur[0]:
            stages[stage] = ent

    for ev in events:
        if ev.get('ph') != 'X':
            continue
        args = ev.get('args') or {}
        name = ev.get('name')
        tid = args.get('trace_id')
        if tid:
            if name in SERVE_CHAIN_STAGES or name in GATEWAY_STAGES:
                note(tid, name, ev)
            if name in SERVE_LINK_STAGES:
                chains[tid]['links'].append(dict(args, stage=name,
                                                 ts=int(ev.get('ts', 0))))
        if name == 'engine_batch':
            for linked in (args.get('trace_ids') or ()):
                note(linked, 'engine_batch', ev)
    return dict(chains)


def serve_summary(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The ``--serve`` report block: chain counts (complete / replay /
    reconstruct), per-hop latency percentiles, the per-replica
    queue-wait vs batch-compute split, and per-session ply timelines."""
    chains = build_serve_chains(events)

    # pid -> replica name, learned from serve_request spans (the engine
    # runs in the service process, so its queue_wait/engine_batch events
    # share the pid)
    pid_replica: Dict[int, str] = {}
    for ev in events:
        if ev.get('ph') == 'X' and ev.get('name') == 'serve_request':
            replica = (ev.get('args') or {}).get('replica')
            if replica:
                pid_replica.setdefault(int(ev.get('pid', 0)), str(replica))

    hop_durs: Dict[str, List[float]] = defaultdict(list)
    split: Dict[str, Dict[str, List[float]]] = defaultdict(
        lambda: {'queue_wait': [], 'engine_batch': []})
    sessions: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    for ev in events:
        if ev.get('ph') != 'X':
            continue
        name = ev.get('name')
        dur_s = int(ev.get('dur', 0)) / 1e6
        if name in SERVE_CHAIN_STAGES or name in GATEWAY_STAGES:
            hop_durs[name].append(dur_s)
        if name in ('queue_wait', 'engine_batch'):
            replica = pid_replica.get(int(ev.get('pid', 0)))
            if replica is not None:
                split[replica][name].append(dur_s)
        if name == 'gateway_ply':
            sid = (ev.get('args') or {}).get('sid')
            if sid is not None:
                sessions[str(sid)].append((int(ev.get('ts', 0)),
                                           int(ev.get('dur', 0))))

    complete = routed = replays = complete_replays = reconstructs = 0
    for rec in chains.values():
        stages, links = rec['stages'], rec['links']
        is_complete = all(s in stages for s in
                          ('client_request', 'serve_request', 'engine_batch'))
        has_replay = any(l['stage'] == 'router_replay' for l in links)
        complete += is_complete
        routed += is_complete and 'route_dispatch' in stages
        replays += has_replay
        complete_replays += is_complete and has_replay
        reconstructs += ('gateway_open' in stages
                         and any(l['stage'] == 'gateway_reconstruct'
                                 for l in links))

    def pcts(d: List[float]) -> Dict[str, Any]:
        return {'n': len(d), 'p50': round(percentile(d, 0.50), 6),
                'p95': round(percentile(d, 0.95), 6),
                'p99': round(percentile(d, 0.99), 6)}

    return {
        'chains': len(chains),
        'complete_chains': complete,
        'routed_chains': routed,
        'replay_chains': replays,
        'complete_replay_chains': complete_replays,
        'reconstruct_chains': reconstructs,
        'hop_seconds': {name: pcts(d)
                        for name, d in sorted(hop_durs.items())},
        'replica_split': {
            replica: {'queue_wait': pcts(d['queue_wait']),
                      'engine_batch': pcts(d['engine_batch'])}
            for replica, d in sorted(split.items())},
        'sessions': {
            sid: {'plies': len(rows),
                  'ply_seconds': pcts([dur / 1e6 for _ts, dur in rows]),
                  'span_seconds': round(
                      (max(ts + dur for ts, dur in rows)
                       - min(ts for ts, _d in rows)) / 1e6, 6)}
            for sid, rows in sorted(sessions.items())},
    }


def percentile(values: List[float], q: float) -> float:
    if not values:
        return 0.0
    vals = sorted(values)
    idx = min(len(vals) - 1, int(q * (len(vals) - 1) + 0.5))
    return vals[idx]


def summarize(events: List[Dict[str, Any]], as_json: bool = False,
              serve: bool = False, require: str = 'training') -> int:
    chains = build_chains(events)
    pids = {ev.get('pid') for ev in events if ev.get('ph') == 'X'}

    # batch-level stage durations
    stage_durs: Dict[str, List[float]] = defaultdict(list)
    for ev in events:
        if ev.get('ph') == 'X' and ev.get('name') in BATCH_STAGES:
            stage_durs[ev['name']].append(int(ev.get('dur', 0)) / 1e6)

    # per-chain segments + generation->gradient totals
    seg_durs: Dict[str, List[float]] = defaultdict(list)
    totals: List[float] = []
    complete = 0
    bad_chains = 0
    for tid, stages in chains.items():
        if chain_errors(stages):
            bad_chains += 1
        present = [(s,) + stages[s] for s in CHAIN_STAGES if s in stages]
        for (s_a, ts_a, dur_a, _p), (s_b, ts_b, _d, _q) in zip(
                present, present[1:]):
            seg_durs['%s->%s' % (s_a, s_b)].append(
                max(0.0, (ts_b - ts_a) / 1e6))
        if 'generate' in stages and 'train_step' in stages:
            complete += 1
            t_end = stages['train_step'][0] + stages['train_step'][1]
            totals.append(max(0.0, (t_end - stages['generate'][0]) / 1e6))

    report = {
        'events': len(events),
        'processes': len(pids),
        'chains': len(chains),
        'complete_chains': complete,
        'order_violations': bad_chains,
        'stage_seconds': {
            name: {'n': len(d), 'p50': round(percentile(d, 0.50), 6),
                   'p95': round(percentile(d, 0.95), 6)}
            for name, d in sorted(stage_durs.items())},
        'segment_seconds': {
            name: {'n': len(d), 'p50': round(percentile(d, 0.50), 6),
                   'p95': round(percentile(d, 0.95), 6)}
            for name, d in sorted(seg_durs.items())},
        'generation_to_gradient_seconds': {
            'n': len(totals), 'p50': round(percentile(totals, 0.50), 6),
            'p95': round(percentile(totals, 0.95), 6)},
    }
    sv = serve_summary(events)
    if serve:
        report['serve'] = sv
    if as_json:
        print(json.dumps(report))
    else:
        print('trace report: %d events from %d processes, %d episode '
              'chains (%d complete, %d order violations)'
              % (report['events'], report['processes'], report['chains'],
                 complete, bad_chains))
        print('stage durations (s):')
        for name, row in report['stage_seconds'].items():
            print('  %-14s p50=%-10g p95=%-10g n=%d'
                  % (name, row['p50'], row['p95'], row['n']))
        print('critical path (%s):' % ' -> '.join(CHAIN_STAGES))
        for name, row in report['segment_seconds'].items():
            print('  %-26s p50=%-10g p95=%-10g n=%d'
                  % (name, row['p50'], row['p95'], row['n']))
        g2g = report['generation_to_gradient_seconds']
        print('generation->gradient: p50=%g p95=%g n=%d'
              % (g2g['p50'], g2g['p95'], g2g['n']))
        if serve:
            print('serving path: %d request chains (%d complete, %d '
                  'routed), %d replay chain(s) (%d complete), %d '
                  'reconstruct chain(s)'
                  % (sv['chains'], sv['complete_chains'],
                     sv['routed_chains'], sv['replay_chains'],
                     sv['complete_replay_chains'],
                     sv['reconstruct_chains']))
            print('per-hop latency (s):')
            for name, row in sv['hop_seconds'].items():
                print('  %-14s p50=%-10g p95=%-10g p99=%-10g n=%d'
                      % (name, row['p50'], row['p95'], row['p99'],
                         row['n']))
            for replica, row in sv['replica_split'].items():
                print('replica %s: queue_wait p50=%g p99=%g (n=%d) | '
                      'engine_batch p50=%g p99=%g (n=%d)'
                      % (replica,
                         row['queue_wait']['p50'], row['queue_wait']['p99'],
                         row['queue_wait']['n'],
                         row['engine_batch']['p50'],
                         row['engine_batch']['p99'],
                         row['engine_batch']['n']))
            for sid, row in sv['sessions'].items():
                print('session %s: %d plies over %gs, ply p50=%g p99=%g'
                      % (sid, row['plies'], row['span_seconds'],
                         row['ply_seconds']['p50'],
                         row['ply_seconds']['p99']))
    ok_training = complete > 0
    ok_serve = sv['complete_chains'] > 0
    if require == 'serve':
        return 0 if ok_serve else 2
    if require == 'any':
        return 0 if (ok_training or ok_serve) else 2
    return 0 if ok_training else 2


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('path', help='trace dir (HANDYRL_TPU_TRACE) or one '
                                     'trace-*.jsonl / trace-*.json file')
    parser.add_argument('--chrome', metavar='OUT',
                        help='also write one merged Chrome-trace JSON')
    parser.add_argument('--json', action='store_true',
                        help='machine-readable summary (one JSON object)')
    parser.add_argument('--serve', action='store_true',
                        help='also reduce the serving-path spans (per-hop '
                             'percentiles, replica split, replay chains, '
                             'session timelines)')
    parser.add_argument('--require', choices=('training', 'serve', 'any'),
                        default=None,
                        help='which chain kind must be complete for exit 0 '
                             '(default: serve when --serve, else training)')
    opts = parser.parse_args(argv)
    require = opts.require or ('serve' if opts.serve else 'training')

    files = discover_files(opts.path)
    if not files:
        print('no trace files under %r' % opts.path, file=sys.stderr)
        return 2
    events = load_events(files)
    if opts.chrome:
        with open(opts.chrome, 'w') as f:
            json.dump({'traceEvents': events, 'displayTimeUnit': 'ms'}, f)
        print('merged Chrome trace -> %s (%d events)'
              % (opts.chrome, len(events)), file=sys.stderr)
    return summarize(events, as_json=opts.json, serve=opts.serve,
                     require=require)


if __name__ == '__main__':
    sys.exit(main())
