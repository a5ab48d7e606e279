"""The port's training server and a worker host over localhost TCP on the
CPU: ``python -m handyrl_tpu_torch.train --server`` and ``python -m
handyrl_tpu_torch.worker ... --device cpu`` as two processes, on entry
and data ports picked free for the run (``HANDYRL_TPU_ENTRY_PORT``,
``HANDYRL_TPU_DATA_PORT``), after the JAX package's slow
tests/test_remote_cluster.py. One epoch of TicTacToe; both exit 0, the
host's workers' last beacons reach the learner's summary. A worker host
asked for CUDA where there is none exits non-zero at once, naming it."""

import json
import os
import socket
import subprocess
import sys
import time

import pytest
import torch


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The workers of a parallel test run share the cores: one intra-op
    thread a process (and in the processes a test starts, through
    OMP_NUM_THREADS)."""
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
CONFIG = {
    'env_args': {'env': 'TicTacToe'},
    'train_args': {'batch_size': 8, 'forward_steps': 8, 'num_batchers': 1,
                   'minimum_episodes': 20, 'update_episodes': 20,
                   'epochs': 1},
    'worker_args': {'server_address': '127.0.0.1', 'num_parallel': 4}}


def free_ports(n):
    """``n`` ports that were free a moment ago (bound to 0, then
    released)."""
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(('', 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _env(ports):
    return dict(os.environ, OMP_NUM_THREADS='1',
                HANDYRL_TPU_ENTRY_PORT=str(ports[0]),
                HANDYRL_TPU_DATA_PORT=str(ports[1]))


@pytest.mark.timeout(300)
def test_server_and_worker_host_train_one_epoch(tmp_path):
    config = json.loads(json.dumps(CONFIG))
    config['train_args']['model_dir'] = str(tmp_path / 'models')
    path = tmp_path / 'config.json'
    path.write_text(json.dumps(config))
    env = _env(free_ports(2))
    server = subprocess.Popen(
        [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config',
         str(path), '--device', 'cpu', '--server'], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        host = subprocess.run(
            [sys.executable, '-m', 'handyrl_tpu_torch.worker', '--config',
             str(path), '2', '--device', 'cpu'], cwd=REPO,
            capture_output=True, text=True, timeout=240, env=env)
        out, err = server.communicate(timeout=120)
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
    assert host.returncode == 0, host.stderr[-3000:]
    assert server.returncode == 0, err[-3000:]
    assert 'worker host: 0 gather respawns, 0 slots given up' in host.stdout
    assert 'accepted connection from' in err
    line = json.loads([l for l in out.splitlines() if l.startswith('{')][0])
    assert line['generation'] == 'server' and line['epochs'] == 1
    assert line['episodes'] >= 20 and line['steps'] > 0
    assert line['fleet']['outstanding'] == 0
    assert line['repeated_sample_keys'] == 0
    assert line['worker_processes'] == 2   # the CLI's 2 over the config's 4
    assert all(s['device'] == 'cpu' for s in line['worker_stats'].values())
    assert (tmp_path / 'models' / '1.ckpt').exists()


@pytest.mark.timeout(120)
def test_worker_host_without_cuda_exits_at_once(tmp_path):
    path = tmp_path / 'config.json'
    path.write_text(json.dumps(CONFIG))
    env = _env(free_ports(2))
    env['CUDA_VISIBLE_DEVICES'] = ''
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, '-m', 'handyrl_tpu_torch.worker', '--config',
         str(path), '--device', 'cuda'], cwd=REPO, capture_output=True,
        text=True, timeout=100, env=env)
    assert proc.returncode != 0
    assert 'CUDA' in proc.stderr
    assert time.time() - t0 < 60   # before any handshake (none listens)
    assert 'joined run' not in proc.stderr
