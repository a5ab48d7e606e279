"""The port's tools held to the JAX package's on the CPU:
``scripts/torch_trace_report.py`` and ``scripts/torch_postmortem.py``
against ``scripts/trace_report.py`` and ``scripts/postmortem.py`` (the same
``--json`` output on the same files, byte for byte: tolerance 0, and the
same exit codes), ``scripts/torch_aux_swa.py`` against
``scripts/aux_swa.py`` (the averaged params within 1e-6: an fp32 running
mean on both sides, other kernels), and the runtime concurrency sanitizer
(``handyrl_tpu_torch/analysis/sanitizer.py``) against the JAX one's cases,
plus a small CPU fleet with a gateway run under ``HANDYRL_TPU_SANITIZE=1``.

The trace and dump files are written by both packages' telemetry (and by
hand, as the JAX scripts' tests write them). One intra-op thread.
"""

import ast
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from handyrl_tpu import telemetry as jt
from handyrl_tpu_torch import telemetry as pt
from handyrl_tpu_torch.analysis import sanitizer as sz
from torch_engine_support import one_torch_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, 'scripts')
sys.path.insert(0, SCRIPTS)

import postmortem  # noqa: E402
import torch_postmortem  # noqa: E402
import torch_trace_report  # noqa: E402
import trace_report  # noqa: E402

_one_torch_thread = pytest.fixture(autouse=True, scope='module')(
    one_torch_thread)
SWA_TOL = 1e-6


def both(capsys, jax_mod, port_mod, argv):
    """Run the JAX script's ``main`` and the port's on ``argv``; their
    exit codes and outputs must be equal. Returns (code, parsed output)."""
    outs = []
    for mod in (jax_mod, port_mod):
        rc = mod.main(list(argv))
        outs.append((rc, capsys.readouterr().out))
    assert outs[0] == outs[1], argv
    rc, out = outs[1]
    return rc, (json.loads(out) if '--json' in argv and out.strip()
                else out)


def ev(name, ts, dur, pid, trace_id=None, trace_ids=None, **extra):
    args = dict(extra)
    if trace_id:
        args['trace_id'] = trace_id
    if trace_ids:
        args['trace_ids'] = trace_ids
    return json.dumps({'name': name, 'cat': 'handyrl', 'ph': 'X', 'ts': ts,
                       'dur': dur, 'pid': pid, 'tid': 1, 'args': args})


# -- the trace report ----------------------------------------------------------


def test_trace_report_json_schema(tmp_path, capsys):
    """The counterpart of tests/test_scripts.py's schema case, on both
    scripts: the keys, the rows' shapes, the exit contract (0 with a
    complete chain, 2 without, 2 on an empty dir)."""
    (tmp_path / 'trace-run1.jsonl').write_text('\n'.join([
        ev('task_assign', 1000, 10, 1, trace_id='g7'),
        ev('generate', 2000, 5000, 2, trace_id='g7'),
        ev('upload', 8000, 300, 3, trace_id='g7'),
        ev('ingest', 9000, 100, 1, trace_id='g7'),
        ev('train_step', 10000, 2000, 1, trace_ids=['g7']),
        ev('h2d', 9500, 50, 1),
        ev('host_block', 9600, 20, 1),
        ev('decode', 9500, 50, 1),
        '{torn half-line',
    ]) + '\n')
    rc, report = both(capsys, trace_report, torch_trace_report,
                      [str(tmp_path), '--json'])
    assert rc == 0
    assert (report['events'], report['processes'], report['chains'],
            report['complete_chains'], report['order_violations']) == \
        (8, 3, 1, 1, 0)
    assert {'h2d', 'host_block', 'decode'} <= set(report['stage_seconds'])
    for table in ('stage_seconds', 'segment_seconds'):
        for row in report[table].values():
            assert set(row) == {'n', 'p50', 'p95'} and row['n'] >= 1
    g2g = report['generation_to_gradient_seconds']
    assert g2g['n'] == 1 and abs(g2g['p50'] - 0.01) < 1e-9

    broken = tmp_path / 'broken'
    broken.mkdir()
    (broken / 'trace-run2.jsonl').write_text('\n'.join([
        ev('task_assign', 1000, 10, 1, trace_id='g9'),
        ev('generate', 2000, 5000, 2, trace_id='g9')]) + '\n')
    assert both(capsys, trace_report, torch_trace_report,
                [str(broken), '--json'])[0] == 2
    empty = tmp_path / 'empty'
    empty.mkdir()
    assert both(capsys, trace_report, torch_trace_report,
                [str(empty)])[0] == 2


def test_trace_report_serve_mode_and_require(tmp_path, capsys):
    """The counterpart of tests/test_scripts.py's ``--serve`` case: chain
    counts, hop percentiles, the replica split, session timelines, and
    ``--require`` picking the chain kind."""
    (tmp_path / 'trace-serve1.jsonl').write_text('\n'.join([
        ev('client_request', 1000, 9000, 1, trace_id='r1'),
        ev('route_dispatch', 1200, 50, 1, trace_id='r1', replica='r0',
           breaker='closed'),
        ev('router_replay', 4000, 80, 1, trace_id='r1', link='replay',
           from_replica='r0', to_replica='r1'),
        ev('serve_request', 5000, 2000, 20, trace_id='r1', replica='r1'),
        ev('queue_wait', 5200, 300, 20, trace_id='r1'),
        ev('engine_batch', 5600, 900, 20, trace_ids=['r1']),
        ev('gateway_open', 500, 100, 3, trace_id='g1', sid='s1'),
        ev('gateway_ply', 2000, 400, 3, trace_id='p1', sid='s1',
           session_trace='g1'),
        ev('gateway_ply', 3000, 500, 3, trace_id='p2', sid='s1',
           session_trace='g1'),
        ev('gateway_reconstruct', 6000, 700, 3, trace_id='g1',
           link='reconstruct', sid='s1', replayed=2, ok=True),
    ]) + '\n')
    rc, report = both(capsys, trace_report, torch_trace_report,
                      [str(tmp_path), '--serve', '--json'])
    assert rc == 0
    sv = report['serve']
    assert (sv['complete_chains'], sv['routed_chains'], sv['replay_chains'],
            sv['complete_replay_chains'], sv['reconstruct_chains']) == \
        (1, 1, 1, 1, 1)
    assert set(sv['replica_split']) == {'r1'}
    assert sv['sessions']['s1']['plies'] == 2
    # a serve-only trace is a training failure unless asked otherwise
    assert both(capsys, trace_report, torch_trace_report,
                [str(tmp_path), '--json'])[0] == 2
    for kind, code in (('serve', 0), ('any', 0), ('training', 2)):
        assert both(capsys, trace_report, torch_trace_report,
                    [str(tmp_path), '--json', '--require', kind])[0] == code
    assert both(capsys, trace_report, torch_trace_report,
                [str(tmp_path), '--serve'])[0] == 0


def _write_spans(mod, directory):
    """One episode chain and one served, replayed and rebuilt request
    chain, written through ``mod``'s telemetry (fixed clocks)."""
    mod.configure_tracing(str(directory), 1.0, force=True)
    try:
        t = 1.7e9
        mod.trace_event('task_assign', ts=t, dur=0.001, trace_id='g3')
        mod.trace_event('generate', ts=t + 0.01, dur=0.2, trace_id='g3')
        mod.trace_event('upload', ts=t + 0.22, dur=0.01, trace_id='g3')
        mod.trace_event('ingest', ts=t + 0.24, dur=0.002, trace_id='g3')
        mod.trace_event('train_step', ts=t + 0.3, dur=0.05,
                        trace_ids=['g3'], always=True)
        for stage in ('select', 'ipc', 'h2d', 'dispatch', 'host_block'):
            mod.trace_stage(stage, 0.001)
        mod.trace_event('gateway_open', ts=t, dur=0.01, trace_id='o1',
                        sid='s000001')
        mod.trace_event('gateway_ply', ts=t + 0.02, dur=0.03,
                        trace_id='p1', sid='s000001', session_trace='o1')
        mod.trace_event('client_request', ts=t + 0.021, dur=0.02,
                        trace_id='p1', rid=1, client='gateway')
        mod.trace_event('route_dispatch', ts=t + 0.021, dur=0.001,
                        trace_id='p1', replica='r0', breaker='closed')
        mod.trace_event('router_replay', ts=t + 0.03, dur=0.001,
                        trace_id='p1', link='replay', from_replica='r0',
                        to_replica='r1')
        mod.trace_event('serve_request', ts=t + 0.031, dur=0.005,
                        trace_id='p1', model='default@1', replica='r1')
        mod.trace_event('queue_wait', ts=t + 0.032, dur=0.001,
                        trace_id='p1', mid=1)
        mod.trace_event('engine_batch', ts=t + 0.033, dur=0.002, rows=1,
                        mid=1, trace_ids=['p1'], always=True)
        mod.trace_event('gateway_reconstruct', ts=t + 0.05, dur=0.01,
                        trace_id='o1', link='reconstruct', sid='s000001',
                        replayed=1, ok=True)
        mod.trace_flush()
    finally:
        mod.configure_tracing('', 1.0, force=True)
        os.environ.pop('HANDYRL_TPU_TRACE', None)
        os.environ.pop('HANDYRL_TPU_TRACE_RATE', None)


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_trace_report_reads_either_packages_files_as_the_jax_script(
        writer, tmp_path, capsys):
    _write_spans({'port': pt, 'jax': jt}[writer], tmp_path)
    for argv in ([str(tmp_path), '--json'],
                 [str(tmp_path), '--serve', '--json']):
        rc, report = both(capsys, trace_report, torch_trace_report, argv)
        assert rc == 0
        assert report['complete_chains'] == 1
        assert {'select', 'ipc', 'h2d', 'dispatch', 'host_block'} <= \
            set(report['stage_seconds'])
    sv = report['serve']
    assert (sv['complete_chains'], sv['routed_chains'],
            sv['complete_replay_chains'], sv['reconstruct_chains']) == \
        (1, 1, 1, 1)
    out = tmp_path / 'merged.json'
    assert both(capsys, trace_report, torch_trace_report,
                [str(tmp_path), '--chrome', str(out)])[0] == 0
    assert json.loads(out.read_text())['traceEvents']


# -- the postmortem ------------------------------------------------------------


def _dump(role, pid, run_id, reason, t_dump, events):
    return {'schema': 'handyrl_tpu.blackbox/1', 'role': role, 'pid': pid,
            'run_id': run_id, 'reason': reason, 'time': t_dump,
            'stats': {'events': len(events), 'total': len(events)},
            'events': events, 'metrics': {}}


def _write(directory, name, payload):
    path = directory / name
    path.write_text(json.dumps(payload))
    return str(path)


def test_postmortem_discovery_and_attribution_as_the_jax_script(tmp_path):
    """The counterparts of tests/test_postmortem.py's unit cases, through
    both scripts' functions on the same inputs."""
    _write(tmp_path, 'gather-0-11-runA.json',
           _dump('gather-0', 11, 'runA', 'gather-lost', 10.0, []))
    _write(tmp_path, 'worker-1-12-runB.json',
           _dump('worker-1', 12, 'runB', 'crash', 11.0, []))
    _write(tmp_path, 'junk.json', {'schema': 'something-else'})
    (tmp_path / 'torn.json').write_text('{not json')
    for run in (None, 'runA'):
        found = [torch_postmortem.discover_dumps(str(tmp_path), run_id=run),
                 postmortem.discover_dumps(str(tmp_path), run_id=run)]
        assert found[0] == found[1]
    assert [d['role'] for d in found[0]] == ['gather-0']

    early = _dump('worker-host', 20, 'r', 'gather-death', 200.0,
                  [{'t': 99.0, 'kind': 'log', 'msg': 'spawning'},
                   {'t': 100.0, 'kind': 'supervisor',
                    'msg': 'gather 0 died'}])
    late = _dump('worker-3', 21, 'r', 'gather-lost', 160.0,
                 [{'t': 150.0, 'kind': 'guard', 'msg': 'pipe EOF'}])
    reports = [mod.build_report([late, early], last_n=5)
               for mod in (torch_postmortem, postmortem)]
    assert reports[0] == reports[1]
    assert reports[0]['first_failure']['role'] == 'worker-host'
    assert reports[0]['first_failure']['time'] == 100.0


def test_postmortem_alert_transitions_as_the_jax_script(tmp_path):
    path = str(tmp_path / 'metrics.jsonl')

    def rec(t, active, fired):
        return json.dumps({'epoch': 1, 'run_id': 'r', 'time': t,
                           'alerts': {'time': t, 'active': active,
                                      'fired': fired}}) + '\n'
    with open(path + '.1', 'w') as f:
        f.write(rec(10.0, [], {}))
    with open(path, 'w') as f:
        f.write(rec(20.0, ['heartbeat_misses'], {'heartbeat_misses': 1}))
        f.write(rec(30.0, [], {'heartbeat_misses': 1}))
        f.write(rec(40.0, [], {'heartbeat_misses': 1, 'session_drop': 1}))
        f.write('{torn half-line')
    alerts = [mod.load_metrics_alerts(path)[0]
              for mod in (torch_postmortem, postmortem)]
    assert alerts[0] == alerts[1]
    assert [(t['alert'], t['state']) for t in alerts[0]['transitions']] == [
        ('heartbeat_misses', 'firing'), ('heartbeat_misses', 'cleared'),
        ('session_drop', 'fired+cleared')]


def test_postmortem_reads_either_packages_dumps_as_the_jax_script(
        tmp_path, capsys):
    """Dumps written by both packages' flight recorders (a worker host's
    ``gather-death`` declaration), a trace and a metrics file: both
    scripts print the same report and exit 0; an empty dir exits 2."""
    bb = tmp_path / 'blackbox'
    for mod in (pt, jt):
        mod.record_event('supervisor', 'gather 0 died', exitcode=-9,
                         respawn_in=0.5)
        assert mod.recorder().dump('gather-death', directory=str(bb),
                                   context={'gather': 0})
    _write_spans(pt, tmp_path / 'traces')
    metrics = tmp_path / 'm.jsonl'
    metrics.write_text(json.dumps({'epoch': 1, 'time': 5.0, 'alerts': {
        'time': 5.0, 'active': ['heartbeat_misses'],
        'fired': {'heartbeat_misses': 1}}}) + '\n')
    rc, report = both(capsys, postmortem, torch_postmortem,
                      [str(bb), '--trace', str(tmp_path / 'traces'),
                       '--metrics', str(metrics), '--last', '5', '--json'])
    assert rc == 0
    assert report['schema'] == 'handyrl_tpu.postmortem/1'
    assert report['dumps'] == 2
    assert {d['reason'] for d in report['deaths']} == {'gather-death'}
    assert all(d['context'] == {'gather': 0} for d in report['deaths'])
    assert report['trace']['events'] > 0
    assert report['alerts']['fired'] == {'heartbeat_misses': 1}
    assert both(capsys, postmortem, torch_postmortem, [str(bb)])[0] == 0
    empty = tmp_path / 'empty'
    empty.mkdir()
    assert both(capsys, postmortem, torch_postmortem,
                [str(empty), '--json'])[0] == 2


# -- SWA -------------------------------------------------------------------------


def test_swa_equals_the_jax_scripts_average(tmp_path, monkeypatch, capsys):
    """Three TicTacToe checkpoints (the JAX package's bytes, seeds 1..3);
    both scripts average epochs 1..3 (and skip the missing 4): the swa.ckpt
    params agree within 1e-6 and differ from every input."""
    from flax.serialization import msgpack_restore

    from handyrl_tpu.environment import make_env as jax_make_env
    from handyrl_tpu.model import ModelWrapper as JaxModelWrapper

    import aux_swa
    import torch_aux_swa
    env = jax_make_env({'env': 'TicTacToe'})
    env.reset()
    dirs = {name: tmp_path / name for name in ('jax', 'port')}
    for d in dirs.values():
        d.mkdir()
    inputs = []
    for epoch in (1, 2, 3):
        w = JaxModelWrapper(env.net(), seed=epoch)
        w.ensure_params(env.observation(0))
        raw = w.params_bytes()
        inputs.append(msgpack_restore(raw))
        for d in dirs.values():
            (d / ('%d.ckpt' % epoch)).write_bytes(raw)
    monkeypatch.setattr(sys, 'argv', ['aux_swa.py', 'TicTacToe', '1', '4',
                                      str(dirs['jax'])])
    aux_swa.main()
    assert torch_aux_swa.main(['TicTacToe', '1', '4', str(dirs['port']),
                               '--device', 'cpu']) == 0
    out = capsys.readouterr().out
    assert 'averaged 3 checkpoints' in out and 'finite True' in out
    trees = [msgpack_restore((dirs[n] / 'swa.ckpt').read_bytes())
             for n in ('jax', 'port')]

    def leaves(tree, prefix=''):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], prefix + '/' + k)
        else:
            yield prefix, np.asarray(tree)
    ref, got = dict(leaves(trees[0])), dict(leaves(trees[1]))
    assert sorted(ref) == sorted(got)
    for key, value in ref.items():
        assert got[key].dtype == value.dtype == np.float32
        np.testing.assert_allclose(got[key], value, rtol=0, atol=SWA_TOL,
                                   err_msg=key)
    # the average is none of its inputs (a GroupNorm's ones and zeros are
    # every input's, so not every leaf moves)
    for tree in inputs:
        assert any(not np.array_equal(dict(leaves(tree))[key], value)
                   for key, value in ref.items())


# -- the runtime sanitizer -------------------------------------------------------


@pytest.fixture
def sanitized():
    sz.install()
    sz.reset()
    try:
        yield sz
    finally:
        sz.uninstall()
        sz.reset()


@pytest.mark.timeout(60)
def test_sanitizer_detects_abba_without_hanging(sanitized):
    lock_a = threading.Lock()    # one allocation site a lock: the
    lock_b = threading.Lock()    # sanitizer's identity of a lock

    def ab():
        with lock_a:
            with lock_b:
                pass

    def ba():
        with lock_b:
            with lock_a:
                pass

    for fn, name in ((ab, 'order-ab'), (ba, 'order-ba')):
        t = threading.Thread(target=fn, name=name)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    report = sanitized.lock_report()
    assert len(report['inversions']) == 1
    with pytest.raises(AssertionError, match='lock-order inversion'):
        sanitized.assert_clean()


@pytest.mark.timeout(60)
def test_sanitizer_condition_wait_and_rlock_make_no_false_edges(sanitized):
    cv, other, r = threading.Condition(), threading.Lock(), threading.RLock()
    woke = []

    def waiter():
        with cv:
            cv.wait(timeout=10)
            woke.append(1)

    t = threading.Thread(target=waiter, name='cv-waiter')
    t.start()
    time.sleep(0.2)
    with other:            # taken while the waiter sleeps inside cv.wait
        pass
    with cv:
        cv.notify_all()
    t.join(timeout=30)
    with r:
        with r:
            pass
    assert woke == [1]
    report = sanitized.lock_report()
    assert report['inversions'] == []
    sanitized.assert_clean()


@pytest.mark.timeout(60)
def test_the_stdlib_and_torch_import_under_the_sanitizer(sanitized):
    """A wrapped lock takes the stdlib's fork hooks (``_at_fork_reinit``,
    which ``concurrent.futures.thread`` reads at import)."""
    for factory in (threading.Lock, threading.RLock):
        lock = factory()
        lock.acquire()
        lock._at_fork_reinit()
        assert lock.acquire(blocking=False)
        lock.release()
    assert sanitized.lock_report()['inversions'] == []


@pytest.mark.timeout(60)
def test_thread_accountant_flags_unnamed_and_leaks(sanitized):
    gate = threading.Event()
    t = threading.Thread(target=gate.wait)      # anonymous, non-daemon
    t.start()
    report = sanitized.thread_report()
    assert len(report['unnamed']) == 1 and len(report['leaked']) == 1
    with pytest.raises(AssertionError, match='leaked non-daemon thread'):
        sanitized.assert_clean()
    gate.set()
    t.join(timeout=30)
    assert sanitized.thread_report()['leaked'] == []


def _sanitized_child(code, tmp_path, timeout=150):
    env = dict(os.environ, HANDYRL_TPU_SANITIZE='1', OMP_NUM_THREADS='1',
               PYTHONPATH=REPO)
    for key in ('HANDYRL_TPU_TRACE', 'HANDYRL_TPU_TRACE_RATE',
                'HANDYRL_TPU_BLACKBOX'):
        env.pop(key, None)
    return subprocess.run([sys.executable, '-c', code, str(tmp_path)],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=timeout)


@pytest.mark.timeout(120)
def test_sanitizer_env_install_reports_at_exit(tmp_path):
    """HANDYRL_TPU_SANITIZE=1 installs at the port's import and prints the
    JAX sanitizer's report line at exit."""
    code = ('import threading\n'
            'import handyrl_tpu_torch\n'
            'a = threading.Lock()\n'
            'b = threading.Lock()\n'
            'with a:\n'
            '    with b: pass\n'
            'with b:\n'
            '    with a: pass\n')
    proc = _sanitized_child(code, tmp_path, timeout=90)
    assert proc.returncode == 0, proc.stderr
    assert 'graftlint-sanitizer: 1 lock-order inversion(s)' in proc.stderr


FLEET_CHILD = r'''
import json, sys
import handyrl_tpu_torch
from handyrl_tpu_torch.analysis import sanitizer
assert sanitizer._S.installed
import torch
torch.set_num_threads(1)
torch.manual_seed(0)
from handyrl_tpu_torch.config import serving_args
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.model import ModelWrapper
from handyrl_tpu_torch.serving.fleet import ServiceResolver
from handyrl_tpu_torch.serving.gateway import GatewayClient, MatchGateway
from handyrl_tpu_torch.serving.registry import ModelRegistry
from handyrl_tpu_torch.serving.service import InferenceService
root = sys.argv[1]
env = make_env({'env': 'TicTacToe'})
env.reset()
ModelRegistry(root).publish(
    'default', snapshot=ModelWrapper(env.net(), device='cpu').snapshot(),
    version=1, promote=True)
def args(**srv):
    return serving_args({'env': 'TicTacToe'}, {'batch_wait_ms': 1.0},
                        dict({'port': 0, 'registry_dir': root}, **srv))
resolver = ServiceResolver(args(fleet={'heartbeat_timeout': 60.0})).start()
endpoint = '127.0.0.1:%d' % resolver.port
svc = InferenceService(args(fleet={'resolver': endpoint,
                                   'heartbeat_interval': 0.1}),
                       device='cpu').start()
assert resolver.wait_routable(1, timeout=60)
gw_args = args(gateway={'resolver': endpoint, 'workers': 2,
                        'monitor_interval': 0.1})
gw_args['seed'] = 11
gw = MatchGateway(gw_args).start()
client = GatewayClient('127.0.0.1', gw.port, name='alice')
outcomes = []
for seed in (23, 24):
    reply = client.open('TicTacToe', seat=0, seed=seed)
    while not reply.get('done'):
        reply = client.play(reply['sid'], reply['legal'][0]
                            if reply.get('to_move') else None)
    outcomes.append(reply['outcome'])
client.close()
gw.stop()
svc.stop(drain=True)
resolver.stop(drain=False)
print(json.dumps({'outcomes': outcomes,
                  'sessions': gw.stats()['outcomes']}))
'''


@pytest.mark.timeout(200)
def test_a_sanitized_cpu_fleet_with_a_gateway_is_clean(tmp_path):
    """A resolver, a replica and a gateway in one process under
    ``HANDYRL_TPU_SANITIZE=1``, two matches through the gateway client:
    the exit report shows no lock-order inversion and no leaked
    thread."""
    proc = _sanitized_child(FLEET_CHILD, tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary['sessions'] == 2 and len(summary['outcomes']) == 2
    line = [ln for ln in proc.stderr.splitlines()
            if ln.startswith('graftlint-sanitizer: ') and 'inversion(s)' in ln]
    assert len(line) == 1, proc.stderr[-4000:]
    assert ' 0 lock-order inversion(s),' in line[0], line[0]
    assert ' 0 leaked non-daemon thread(s)' in line[0], line[0]
    assert 'INVERSION' not in proc.stderr


def test_the_sanitizer_is_a_copy_of_the_jax_sanitizer():
    """The same code as the JAX sanitizer: the two modules' syntax trees
    are equal once their docstrings and the port's ``_at_fork_reinit``
    methods (which the JAX copy lacks: torch's import needs them under
    the sanitizer) are taken out."""
    def tree(path):
        with open(os.path.join(REPO, path)) as f:
            node = ast.parse(f.read())
        for n in ast.walk(node):
            if isinstance(n, ast.ClassDef):
                n.body = [b for b in n.body if not (
                    isinstance(b, ast.FunctionDef)
                    and b.name == '_at_fork_reinit')]
            body = getattr(n, 'body', None)
            if (isinstance(body, list) and body
                    and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                n.body = body[1:]
        return ast.dump(node)
    assert tree('handyrl_tpu_torch/analysis/sanitizer.py') == \
        tree('handyrl_tpu/analysis/sanitizer.py')
