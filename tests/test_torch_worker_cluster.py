"""The port's local worker cluster (``batched_generation: false``): the
learner serves its four RPCs to spawned gather and worker processes
(handyrl_tpu_torch/worker.py ``WorkerCluster``, handyrl_tpu_torch/train.py
``Learner.server``), after the JAX package's tests/test_cluster.py.

On the CPU (``--device cpu``): TicTacToe through the CLI for one epoch
(its ``1.ckpt`` loads in the JAX package's ``ModelWrapper`` and computes
the port's outputs within 1e-4: fp32 sums in other orders), and a
GeeseNet (filters 16, 2 blocks) learner in this process for two epochs
(epoch 0 is model id 0, the RandomModel, as in the JAX package); every
task's episode counts once, the ledger ends with nothing outstanding, the
workers' last beacons reach the summary, and no worker process is left.
With every worker killed mid-run the learner exits 1 within 60 s, naming
the lost gather (the JAX learner would wait for it forever)."""

import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.evaluation import load_model as jax_load_model
from handyrl_tpu_torch.config import apply_defaults
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.evaluation import load_model
from handyrl_tpu_torch.models.geese import GeeseNet
from handyrl_tpu_torch.train import Learner
from handyrl_tpu_torch.utils.fs import verify_checkpoint


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The workers of a parallel test run share the cores: one intra-op
    thread a process (and in the processes a test starts, through
    OMP_NUM_THREADS) keeps these runs' many small ops from waiting on
    descheduled OpenMP threads (tens of times slower without it)."""
    before, omp = torch.get_num_threads(), os.environ.get('OMP_NUM_THREADS')
    torch.set_num_threads(1)
    os.environ['OMP_NUM_THREADS'] = '1'
    yield
    torch.set_num_threads(before)
    if omp is None:
        os.environ.pop('OMP_NUM_THREADS', None)
    else:
        os.environ['OMP_NUM_THREADS'] = omp


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
TICTACTOE = {
    'env_args': {'env': 'TicTacToe'},
    'train_args': {'batch_size': 8, 'forward_steps': 8, 'num_batchers': 1,
                   'minimum_episodes': 20, 'update_episodes': 20,
                   'epochs': 1, 'batched_generation': False,
                   'worker': {'num_parallel': 2}}}
PID = re.compile(r'(started gather|opened worker) \d+ \(pid (\d+)\)')


def _write_config(tmp_path, config):
    path = tmp_path / 'config.json'
    path.write_text(json.dumps(config))
    return str(path)


def _pids(text):
    return [int(m.group(2)) for m in PID.finditer(text)]


def _all_gone(pids, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if not [p for p in pids if os.path.exists('/proc/%d' % p)]:
            return True
        time.sleep(0.2)
    return False


def _check_fleet(line, workers):
    assert line['generation'] == 'workers' and line['fleet_failure'] is None
    assert line['fleet']['outstanding'] == 0
    assert line['fleet']['live'] == 0
    assert line['repeated_sample_keys'] == 0
    assert line['distinct_sample_keys'] == line['episodes']
    # every worker's last beacon arrived: its stats and launch counts
    assert line['worker_processes'] == workers
    assert sum(s['episodes'] for s in line['worker_stats'].values()) \
        >= line['episodes']
    assert all(s['device'] == 'cpu' for s in line['worker_stats'].values())
    assert sum(line['worker_kernel_launches'].values()) == 0   # the CPU


@pytest.mark.timeout(300)
def test_cli_trains_tictactoe_from_a_local_cluster(tmp_path):
    config = json.loads(json.dumps(TICTACTOE))
    config['train_args']['model_dir'] = str(tmp_path / 'models')
    proc = subprocess.run(
        [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config',
         _write_config(tmp_path, config), '--device', 'cpu'],
        cwd=REPO, capture_output=True, text=True, timeout=280,
        env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [l for l in proc.stdout.splitlines() if l.startswith('{')]
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line['epochs'] == 1 and line['episodes'] >= 20
    assert not line['failed'] and line['steps'] > 0
    _check_fleet(line, workers=2)
    assert 'fleet: live=' in proc.stdout
    pids = _pids(proc.stderr)
    assert len(pids) == 3             # one gather, two workers
    assert _all_gone(pids)

    ckpt = str(tmp_path / 'models' / '1.ckpt')
    assert verify_checkpoint(ckpt) == (True, 'ok')
    want = jax_load_model(ckpt, jax_make_env({'env': 'TicTacToe'}))
    got = load_model(ckpt, make_env({'env': 'TicTacToe'}), device='cpu')
    env = make_env({'env': 'TicTacToe'})
    obs = np.stack([env.observation(p) for p in env.players()] * 4)
    out, ref = got.batch_inference(obs), want.batch_inference(obs)
    for k in ('policy', 'value'):
        np.testing.assert_allclose(out[k], np.asarray(ref[k]), rtol=0,
                                   atol=TOL, err_msg=k)


@pytest.mark.timeout(300)
def test_geese_learner_trains_from_a_local_cluster(tmp_path):
    args = apply_defaults({
        'env_args': {'env': 'HungryGeese', 'torus_impl': 'pallas'},
        'train_args': {'turn_based_training': False, 'observation': True,
                       'gamma': 0.99, 'forward_steps': 4, 'batch_size': 4,
                       'num_batchers': 1, 'minimum_episodes': 4,
                       'update_episodes': 4, 'epochs': 2,
                       'batched_generation': False,
                       'worker': {'num_parallel': 2},
                       'model_dir': str(tmp_path / 'models')}})
    net = GeeseNet(filters=16, layers=2, torus_impl='pallas')
    net.reset_parameters(torch.Generator().manual_seed(0))
    learner = Learner(args, net=net, device='cpu')
    learner.run()
    line = learner.summary()
    assert learner.model_epoch == 2 and line['episodes'] >= 12
    assert not line['failed'] and line['steps'] > 0
    _check_fleet(line, workers=2)
    assert (tmp_path / 'models' / '2.ckpt').exists()
    # epoch 0 is model id 0 (the RandomModel); epoch 1 the snapshot's
    # narrow net, rebuilt in the workers from its config
    stats = line['worker_stats'].values()
    assert sum(s['random_plies'] for s in stats) > 0
    assert sum(s['plies'] for s in stats) > 0
    assert all(not p.is_alive() for p in learner.worker.procs)


@pytest.mark.timeout(180)
def test_learner_exits_1_when_every_worker_is_lost(tmp_path):
    config = json.loads(json.dumps(TICTACTOE))
    config['train_args'].update(update_episodes=10 ** 6,
                                model_dir=str(tmp_path / 'models'))
    err_path = tmp_path / 'stderr.txt'
    with open(err_path, 'w') as err:
        proc = subprocess.Popen(
            [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config',
             _write_config(tmp_path, config), '--device', 'cpu'],
            cwd=REPO, stdout=subprocess.PIPE, stderr=err, text=True,
            env=dict(os.environ, OMP_NUM_THREADS='1'))
        try:
            deadline = time.time() + 120
            workers = []
            while len(workers) < 2 and time.time() < deadline:
                time.sleep(0.2)
                workers = [int(p) for p in re.findall(
                    r'opened worker \d+ \(pid (\d+)\)', err_path.read_text())]
            assert len(workers) == 2, err_path.read_text()[-3000:]
            time.sleep(1.0)           # mid-run: tasks are in flight
            for pid in workers:
                os.kill(pid, signal.SIGKILL)
            t0 = time.time()
            out, _ = proc.communicate(timeout=60)
            took = time.time() - t0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    stderr = err_path.read_text()
    assert proc.returncode == 1, stderr[-3000:]
    assert took < 60
    assert re.search(r'training failed: lost gather 0 \(pid \d+, exit code '
                     r'1\)', stderr), stderr[-3000:]
    assert 'all 2 of its workers were lost' in stderr
    line = json.loads([l for l in out.splitlines() if l.startswith('{')][0])
    assert line['fleet_failure'].startswith('lost gather 0')
    assert _all_gone(_pids(stderr))
