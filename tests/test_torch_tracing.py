"""Episode tracing and the flight recorder on the port's training plane,
held to the JAX package: the same trace ids and the same keep/drop
decisions (a crc32 of the id, 10,000 ids at rates 0.1 and 0.5: equal
decisions, tolerance 0), the same event keys and file names, the same
trace events from the ledger on the same tasks; then, on the CPU, a
``--server`` learner and a worker host over TCP with one gather killed:
one trace id across ``task_assign`` (learner), ``generate`` (worker),
``upload`` (gather), ``ingest`` and ``train_step`` (learner) from three
processes, the host's ``gather-death`` dump, ``heartbeat_misses`` fired
in the metrics rows, and rows that the JAX package's
``validate_metrics_line`` accepts."""

import glob
import json
import os
import signal
import socket
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import pytest

from handyrl_tpu import telemetry as jt
from handyrl_tpu.fault import TaskLedger as JaxTaskLedger
from handyrl_tpu_torch import telemetry as pt
from handyrl_tpu_torch.fault import TaskLedger
from handyrl_tpu_torch.ops.shm_batch import selected_trace_ids

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAIN = ('task_assign', 'generate', 'upload', 'ingest', 'train_step')
# the environment variables the telemetry config is mirrored into: a
# subprocess must take its settings from its config, not from a learner
# that ran earlier in this process
MIRRORED = ('HANDYRL_TPU_TRACE', 'HANDYRL_TPU_TRACE_RATE',
            'HANDYRL_TPU_BLACKBOX', 'HANDYRL_TPU_RECORDER_EVENTS',
            'HANDYRL_TPU_RUN_ID', 'HANDYRL_TPU_TELEMETRY',
            'HANDYRL_TPU_RETRACE', 'HANDYRL_TPU_CHAOS')


@pytest.fixture
def trace_dirs(tmp_path):
    """Both packages' tracing routed into tmp dirs for one test, then off
    again (other tests see tracing disabled)."""
    dirs = (str(tmp_path / 'port'), str(tmp_path / 'jax'))
    pt.configure_tracing(dirs[0], 1.0, force=True)
    jt.configure_tracing(dirs[1], 1.0, force=True)
    try:
        yield dirs
    finally:
        for mod in (pt, jt):
            mod.trace_flush()
            mod.configure_tracing('', 1.0, force=True)
        os.environ.pop('HANDYRL_TPU_TRACE', None)
        os.environ.pop('HANDYRL_TPU_TRACE_RATE', None)


def read_events(mod, d):
    mod.trace_flush()
    events = []
    for path in glob.glob(os.path.join(d, 'trace-*.jsonl')):
        with open(path) as f:
            events += [json.loads(line) for line in f if line.strip()]
    return events


def test_episode_trace_ids_agree():
    for args in ({'role': 'g', 'sample_key': 7}, {'role': 'e',
                                                  'sample_key': 0},
                 {'sample_key': 3}, {'role': 'g'}, None, 'x', {}):
        assert pt.episode_trace_id(args) == jt.episode_trace_id(args)


@pytest.mark.parametrize('rate', [0.1, 0.5])
def test_sampling_decisions_agree_on_10000_ids(trace_dirs, rate):
    """Exact: the same crc32 rule keeps the same episodes everywhere."""
    pt.configure_tracing(trace_dirs[0], rate, force=True)
    jt.configure_tracing(trace_dirs[1], rate, force=True)
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 1 << 40, 10000)
    ids = ['%s%d' % ('ge'[i % 2], int(k)) for i, k in enumerate(keys)]
    got = [pt.trace_sampled(t) for t in ids]
    assert got == [jt.trace_sampled(t) for t in ids]
    assert abs(np.mean(got) - rate) < 0.03


def test_tracing_off_writes_nothing(tmp_path):
    assert not pt.trace_enabled()
    assert pt.trace_sampled('g1') is False
    pt.trace_event('x', trace_id='g1')
    with pt.trace_span('y'):
        pass
    pt.trace_flush()
    assert pt.finalize_trace() is None
    assert not glob.glob(str(tmp_path / '**'), recursive=True)[1:]


def test_events_files_and_collation_have_the_jax_layout(trace_dirs):
    for mod, d in zip((pt, jt), trace_dirs):
        mod.set_process_label('learner')
        mod.trace_event('ingest', ts=100.0, dur=0.25, trace_id='g42',
                        task_id=3)
        with mod.trace_span('generate', trace_id='g42', worker=1):
            pass
        mod.trace_event('train_step', ts=101.0, dur=0.5, always=True,
                        trace_ids=['g42'], steps=9)
    ep, ej = (read_events(m, d) for m, d in zip((pt, jt), trace_dirs))
    assert [e['name'] for e in ep] == [e['name'] for e in ej] == [
        'process_name', 'ingest', 'generate', 'train_step']
    for a, b in zip(ep, ej):
        assert sorted(a) == sorted(b)
        assert sorted(a['args']) == sorted(b['args'])
        assert {k: a[k] for k in ('name', 'ph', 'cat') if k in a} == \
            {k: b[k] for k in ('name', 'ph', 'cat') if k in b}
    assert ep[1]['ts'] == ej[1]['ts'] == 100000000
    assert ep[1]['dur'] == ej[1]['dur'] == 250000
    assert ep[1]['args']['trace_id'] == 'g42'
    assert ep[1]['args']['run_id'] == pt.run_id()
    out = pt.finalize_trace()
    assert os.path.basename(out) == 'trace-%s.json' % pt.run_id()
    with open(out) as f:
        doc = json.load(f)
    assert sorted(doc) == ['displayTimeUnit', 'traceEvents']
    assert len(doc['traceEvents']) == 4
    assert os.path.exists(os.path.join(
        trace_dirs[0], 'trace-%s.jsonl' % pt.run_id()))


def test_trace_span_folds_into_the_stage_histogram(trace_dirs):
    key = 'stage_seconds{stage="unit_span"}'
    before = pt.snapshot()['hists'].get(key, {}).get('count', 0)
    with pt.trace_span('unit_span', trace_id='g1'):
        time.sleep(0.01)
    assert pt.snapshot()['hists'][key]['count'] == before + 1
    [ev] = [e for e in read_events(pt, trace_dirs[0])
            if e['name'] == 'unit_span']
    assert ev['dur'] >= 10000 and ev['args']['trace_id'] == 'g1'


def _ledger_events(ledger_cls, mod, d):
    ledger = ledger_cls(deadline=60.0)
    tasks = [{'role': 'g', 'sample_key': k, 'model_id': {0: 1}}
             for k in range(6)] + [{'role': 'e', 'sample_key': 2}]
    for t in tasks:
        ledger.assign('ep', t)
    ledger.admit([{'args': dict(t)} for t in tasks[:4]] + [None])
    ledger.admit_chunks([{'args': dict(tasks[5]), 'chunk': c,
                          'base': 0, 'steps': 1} for c in (0, 1)])
    return [(e['name'], e['args'].get('trace_id'), e['args'].get('task_id'),
             e['args'].get('chunk'))
            for e in read_events(mod, d) if e['name'] != 'process_name']


def test_the_ledger_writes_the_jax_ledgers_events(trace_dirs):
    got = _ledger_events(TaskLedger, pt, trace_dirs[0])
    want = _ledger_events(JaxTaskLedger, jt, trace_dirs[1])
    assert got == want
    assert [n for n, *_ in got].count('task_assign') == 7
    assert ('ingest', 'g5', 5, 1) in got


def test_a_batchs_trace_ids_are_the_jax_batchers(trace_dirs):
    from handyrl_tpu.train import _selected_trace_ids
    pt.configure_tracing(trace_dirs[0], 0.5, force=True)
    jt.configure_tracing(trace_dirs[1], 0.5, force=True)
    selected = [{'args': {'role': 'g', 'sample_key': k % 23}}
                for k in range(64)] + [{'args': {}}, {}]
    assert selected_trace_ids(selected) == _selected_trace_ids(selected)
    assert selected_trace_ids(selected)


def test_a_worker_that_loses_its_gather_dumps_its_recorder(tmp_path,
                                                          monkeypatch):
    from handyrl_tpu_torch.worker import Worker
    monkeypatch.setattr(pt, '_BLACKBOX_DIR', str(tmp_path))

    class Lost:
        worker_id = 5
    Worker._gather_lost(Lost())
    [path] = glob.glob(str(tmp_path / '*.json'))
    with open(path) as f:
        dump = json.load(f)
    assert dump['reason'] == 'gather-lost'
    assert dump['context'] == {'worker': 5}
    assert dump['events'][-1]['msg'] == 'gather connection lost'


# ---------------------------------------------------------------------------
# the worker plane over TCP on the CPU, one gather killed

def free_port_pair():
    socks = [socket.socket() for _ in range(3)]
    for s in socks:
        s.bind(('127.0.0.1', 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def test_a_server_run_links_one_trace_across_three_processes(tmp_path):
    entry, data, tport = free_port_pair()
    cfg = {'env_args': {'env': 'TicTacToe'},
           'train_args': {
               'batch_size': 16, 'forward_steps': 8, 'num_batchers': 1,
               'minimum_episodes': 30, 'update_episodes': 30, 'epochs': 6,
               'seed': 3, 'model_dir': str(tmp_path / 'models'),
               'metrics_jsonl': str(tmp_path / 'm.jsonl'),
               'fault_tolerance': {'heartbeat_interval': 0.5,
                                   'host_quarantine_period': 2.0},
               'telemetry': {'trace_dir': str(tmp_path / 'traces'),
                             'trace_sample_rate': 1.0,
                             'blackbox_dir': str(tmp_path / 'bb'),
                             'alerts': {'interval': 0.25}},
               'telemetry_port': tport},
           'worker_args': {'server_address': '127.0.0.1',
                           'num_parallel': 2}}
    path = str(tmp_path / 'cfg.json')
    with open(path, 'w') as f:
        json.dump(cfg, f)
    env = {k: v for k, v in os.environ.items() if k not in MIRRORED}
    env.update(OMP_NUM_THREADS='1', HANDYRL_TPU_ENTRY_PORT=str(entry),
               HANDYRL_TPU_DATA_PORT=str(data), PYTHONUNBUFFERED='1')
    logs = {k: open(str(tmp_path / (k + '.out')), 'w')
            for k in ('server', 'host')}
    procs = {}
    try:
        procs['server'] = subprocess.Popen(
            [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config',
             path, '--device', 'cpu', '--server'], cwd=REPO,
            stdout=logs['server'], stderr=subprocess.STDOUT, env=env,
            start_new_session=True)
        # the kill 2.8 s after the host joins (seed 0's first draw is
        # 1.8606 x the mean), well inside the run
        procs['host'] = subprocess.Popen(
            [sys.executable, '-m', 'handyrl_tpu_torch.worker', '--config',
             path, '--device', 'cpu'], cwd=REPO, stdout=logs['host'],
            stderr=subprocess.STDOUT, start_new_session=True,
            env=dict(env, HANDYRL_TPU_CHAOS='kill_gather=1.5,max_kills=1,'
                                            'seed=0'))
        for k in ('server', 'host'):
            procs[k].wait(timeout=150)
    finally:
        for proc in procs.values():
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except OSError:
                pass
            proc.wait()
        for f in logs.values():
            f.close()
    outs = {k: open(str(tmp_path / (k + '.out'))).read() for k in logs}
    assert procs['server'].returncode == 0, outs['server'][-3000:]
    assert procs['host'].returncode == 0, outs['host'][-3000:]
    assert 'chaos: killing gather' in outs['host']
    line = json.loads([l for l in outs['server'].splitlines()
                       if l.startswith('{')][-1])
    assert line['telemetry']['retraces'] == 0

    # one trace id, five events, three processes
    with open(line['telemetry']['trace']) as f:
        events = json.load(f)['traceEvents']
    by_id = defaultdict(lambda: defaultdict(set))
    for e in events:
        a = e.get('args') or {}
        for tid in ([a['trace_id']] if 'trace_id' in a else []) + list(
                a.get('trace_ids') or ()):
            by_id[tid][e['name']].add(e['pid'])
    linked = [t for t, names in by_id.items() if set(CHAIN) <= set(names)]
    assert linked
    pids = set().union(*(by_id[linked[0]][n] for n in CHAIN))
    assert len(pids) >= 3

    # the host's supervisor dumped its recorder for the dead gather
    dumps = glob.glob(str(tmp_path / 'bb' / 'worker-host-*.json'))
    assert dumps
    with open(dumps[0]) as f:
        dump = json.load(f)
    assert dump['reason'] == 'gather-death'

    # every row passes the JAX schema check with the fleet aggregate, and
    # the disconnect of the killed gather fired heartbeat_misses
    with open(str(tmp_path / 'm.jsonl')) as f:
        rows = [jt.validate_metrics_line(l, fleet=True) for l in f]
    assert len(rows) == 6
    assert any('heartbeat_misses' in r['alerts']['fired'] for r in rows)
    fleet_counters = rows[-1]['fleet_telemetry']['counters']
    assert any(k.startswith('gather_uploads_total') for k in fleet_counters)
    assert any(k.startswith('worker_tasks_total') for k in fleet_counters)
    assert rows[-1]['telemetry']['counters'][
        'learner_episodes_returned_total'] >= 150
