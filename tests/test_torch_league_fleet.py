"""The league end to end on the port's worker plane, on the CPU: the
counterpart of tests/test_league.py's
``test_league_fleet_restart_preserves_ratings_and_promotes``.

``python -m handyrl_tpu_torch.train --server`` on TicTacToe with
``league.enabled`` (every 'g' task seats a PFSP-drawn member, every 'e'
task is a rating match, the gate at margin 0 after 1 game) serves one
worker host of 2 workers over localhost TCP. The learner is SIGTERMed
once its third checkpoint lands (exit 75) and restarted
(``restart_epoch: -1``); the host's gather reattaches. Checked: at least
2 distinct registry members seated in 'g' episodes, the journal reloaded
bit for bit (the restart's reload line, each package's load and save of
the journal the same bytes), nothing booked before the restart lost, a
promotion in the manifest, every member's checkpoint kept by the GC; and
``scripts/league_report.py`` renders the run's ``metrics_jsonl``."""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import time

import pytest

from handyrl_tpu import league as jax_league
from handyrl_tpu.serving.registry import ModelRegistry as JaxModelRegistry
from handyrl_tpu_torch import league

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS, STOP_AT = 6, 3


def free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(('127.0.0.1', 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _wait_for(predicate, deadline, poll=0.1):
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(poll)
    return predicate()


@pytest.fixture(scope='module')
def fleet_run(tmp_path_factory):
    """The two learner runs and the host; returns their logs, exit codes,
    the journal's bytes after the first run and the paths."""
    tmp = tmp_path_factory.mktemp('league_fleet')
    model_dir = str(tmp / 'models')
    metrics = str(tmp / 'metrics.jsonl')
    entry, data = free_ports(2)
    cfg = {'env_args': {'env': 'TicTacToe'},
           'train_args': {
               'batch_size': 8, 'forward_steps': 8, 'update_episodes': 12,
               'minimum_episodes': 12, 'epochs': EPOCHS, 'num_batchers': 1,
               'eval_rate': 0.3, 'seed': 11, 'restart_epoch': -1,
               'keep_checkpoints': 3, 'metrics_jsonl': metrics,
               'model_dir': model_dir,
               'serving': {'publish': True, 'line': 'default'},
               'league': {'enabled': True, 'self_play_rate': 0.0,
                          'rating_match_rate': 1.0, 'curve': 'uniform',
                          'min_games': 1, 'promote_margin': 0.0},
               'fault_tolerance': {
                   'heartbeat_interval': 1.0, 'liveness_timeout': 8.0,
                   'rpc_timeout': 30.0, 'task_deadline': 30.0,
                   'reconnect_initial_delay': 0.25,
                   'reconnect_max_delay': 1.0, 'reconnect_max_tries': 240}},
           'worker_args': {'server_address': '127.0.0.1', 'num_parallel': 2}}
    path = tmp / 'cfg.json'
    path.write_text(json.dumps(cfg))
    # the processes take their telemetry and run identity from their
    # config, not from a learner that ran earlier in this process
    env = {k: v for k, v in os.environ.items() if k not in (
        'HANDYRL_TPU_RUN_ID', 'HANDYRL_TPU_TELEMETRY', 'HANDYRL_TPU_TRACE',
        'HANDYRL_TPU_TRACE_RATE', 'HANDYRL_TPU_BLACKBOX',
        'HANDYRL_TPU_RECORDER_EVENTS', 'HANDYRL_TPU_RETRACE')}
    env.update(OMP_NUM_THREADS='1', PYTHONUNBUFFERED='1',
               HANDYRL_TPU_ENTRY_PORT=str(entry),
               HANDYRL_TPU_DATA_PORT=str(data))
    learner_cmd = [sys.executable, '-m', 'handyrl_tpu_torch.train',
                   '--config', str(path), '--device', 'cpu', '--server']
    names = ('learner1', 'learner2', 'host')
    logs = {n: open(tmp / (n + '.log'), 'w') for n in names}
    procs = []

    def start(cmd, log):
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log,
                                      stderr=subprocess.STDOUT))
        return procs[-1]

    def text(name):
        return (tmp / (name + '.log')).read_text()
    journal = league.journal_path(model_dir)
    try:
        learner1 = start(learner_cmd, logs['learner1'])
        assert _wait_for(lambda: 'started server' in text('learner1')
                         or learner1.poll() is not None, time.time() + 60)
        host = start([sys.executable, '-m', 'handyrl_tpu_torch.worker',
                      '--config', str(path), '--device', 'cpu'],
                     logs['host'])
        target = os.path.join(model_dir, '%d.ckpt' % STOP_AT)
        assert _wait_for(lambda: os.path.exists(target)
                         or learner1.poll() is not None, time.time() + 90)
        assert learner1.poll() is None, text('learner1')[-3000:]
        learner1.send_signal(signal.SIGTERM)
        learner1.wait(timeout=60)
        journal1 = open(journal, 'rb').read()
        learner2 = start(learner_cmd, logs['learner2'])
        learner2.wait(timeout=120)
        host.wait(timeout=60)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs.values():
            log.close()
    return {'tmp': tmp, 'model_dir': model_dir, 'metrics': metrics,
            'journal': journal, 'journal1': journal1,
            'logs': {n: text(n) for n in names},
            'rcs': (learner1.returncode, learner2.returncode,
                    host.returncode)}


def _league_block(fleet_run):
    with open(os.path.join(str(fleet_run['tmp']), 'cfg.json')) as f:
        return json.load(f)['train_args']['league']


@pytest.mark.timeout(300)
def test_league_fleet_restart_preserves_ratings_and_promotes(fleet_run,
                                                             tmp_path):
    logs = fleet_run['logs']
    rc1, rc2, host_rc = fleet_run['rcs']
    assert rc1 == 75, logs['learner1'][-3000:]
    assert 'preempted: checkpoint flushed' in logs['learner1']
    assert rc2 == 0 and host_rc == 0, (logs['learner2'][-3000:],
                                       logs['host'][-2000:])
    j1_raw = fleet_run['journal1']
    j1 = json.loads(j1_raw)
    assert j1['entries'], 'the first run booked no rated game'

    # the journal round-trips through either package's book byte for byte
    for mod in (league, jax_league):
        book = mod.RatingBook()
        out = str(tmp_path / ('%s.json' % mod.__name__))
        assert book.load(fleet_run['journal'] + '.missing') is False
        with open(out + '.in', 'wb') as f:
            f.write(j1_raw)
        assert book.load(out + '.in')
        book.save(out)
        assert open(out, 'rb').read() == j1_raw
    # the restart reloaded exactly that journal
    reload = re.search(r'league: reloaded ratings journal \((\d+) entries, '
                       r'(\d+) promotions\)', logs['learner2'])
    assert reload, logs['learner2'][-3000:]
    assert (int(reload.group(1)), int(reload.group(2))) == (
        len(j1['entries']), j1['promotions'])
    assert 'reattached across a learner restart' in logs['host']

    # nothing booked before the restart was lost
    j2 = json.loads(open(fleet_run['journal'], 'rb').read())
    assert set(j1['entries']) <= set(j2['entries'])
    for name, entry in j1['entries'].items():
        assert j2['entries'][name]['games'] >= entry['games']
    assert j2['promotions'] >= max(1, j1['promotions'])

    # >= 2 distinct registry members seated in 'g' episodes
    sampled, rows = set(), 0
    with open(fleet_run['metrics']) as f:
        for line in f:
            lg = json.loads(line).get('league')
            if not lg:
                continue
            rows += 1
            assert 'ratings' in lg and 'champion' in lg
            sampled.update(lg.get('opponents_sampled') or {})
    assert rows > 0
    members = {m for m in sampled if '@' in m}
    assert len(members) >= 2, sampled

    # the learner's JSON line: the league as it ended
    line = json.loads([l for l in logs['learner2'].splitlines()
                       if l.startswith('{')][-1])
    lg = line['league']
    assert line['model_epoch'] == EPOCHS
    assert lg['promotions'] == j2['promotions']
    assert set(lg['rating_matches']) <= set(lg['roster'])
    for d in lg['decisions']:
        book = league.RatingBook()
        book.from_state(d['state'])
        pool = league.LeaguePool(_league_block(fleet_run), 'default')
        pool.champion = d['champion']
        assert pool.should_promote(book) == d['promoted']

    # a promotion in the manifest, read by the JAX registry; every member
    # checkpoint kept by the GC (keep_checkpoints 3 < members)
    reg = JaxModelRegistry(fleet_run['model_dir'])
    champ, meta = reg.resolve('default', 'champion')
    assert int(champ) >= 1 and os.path.exists(meta['path'])
    assert 'default@%s' % champ == lg['champion']
    pool = league.LeaguePool({}, 'default')
    pool.refresh(reg)
    assert len(pool.members()) > 3
    for path in pool.member_paths():
        assert os.path.exists(path), path


@pytest.mark.timeout(120)
def test_league_report_renders_the_ports_metrics(fleet_run):
    """scripts/league_report.py (stdlib only) on the run's metrics rows
    and journal: exit 0, the rating table, the promotions and the PFSP
    tallies."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, 'scripts', 'league_report.py'),
         fleet_run['metrics'], '--journal', fleet_run['journal']],
        capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert out.startswith('league report: epoch %d' % EPOCHS)
    assert 'name' in out and 'rating' in out and 'sigma' in out
    assert re.search(r'^learner\s+\d+\.\d\s+\d+\.\d\s+\d+\s+learner$', out,
                     re.M), out
    assert re.search(r'^default@\d+\s.*champion$', out, re.M), out
    assert 'promotions:\n  epoch' in out
    assert 'opponents sampled (PFSP draws):' in out
