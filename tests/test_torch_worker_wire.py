"""The worker plane's wire between the packages: the port's training
server (handyrl_tpu_torch/train.py ``Learner.server`` behind
``WorkerServer``) answers a JAX gather's link (handyrl_tpu/connection.py
``FramedConnection``, whose ``recv`` decodes with the JAX package's
``unpack``, msgpack).

A JAX gather's ``('args', [None] * k)`` block gets k well-formed tasks
with the JAX key set; its ``model`` request gets a snapshot from which the
JAX package's ``ModelWrapper.from_snapshot`` builds a model whose policy
and value on real TicTacToe boards match the port's within 1e-5 (fp32
sums in other orders); episodes and results that the JAX package's
``Generator`` and ``Evaluator`` play on it are taken (acknowledged with
None each), counted once, and a resent batch is dropped as a duplicate.
The entry handshake answers a JAX host's worker_args with its base worker
id and the merged config."""

import os
import socket
import threading

import numpy as np
import pytest
import torch

from handyrl_tpu import connection as jax_connection
from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.evaluation import Evaluator as JaxEvaluator
from handyrl_tpu.generation import Generator as JaxGenerator
from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
from handyrl_tpu_torch.config import apply_defaults
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.model import ModelWrapper
from handyrl_tpu_torch.models.tictactoe import SimpleConv2dModel
from handyrl_tpu_torch.train import Learner


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


TOL = 1e-5
TASK_KEYS = {'role', 'player', 'model_id', 'sample_key', 'task_id'}


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(('', 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _connect(port, timeout=30.0):
    """A JAX client link, retried while the listener comes up."""
    import time
    deadline = time.time() + timeout
    while True:
        try:
            return jax_connection.connect_socket_connection('127.0.0.1',
                                                            port)
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.1)


@pytest.fixture
def server(tmp_path, monkeypatch):
    entry, data = _free_ports(2)
    monkeypatch.setenv('HANDYRL_TPU_ENTRY_PORT', str(entry))
    monkeypatch.setenv('HANDYRL_TPU_DATA_PORT', str(data))
    args = apply_defaults({
        'env_args': {'env': 'TicTacToe'},
        'train_args': {'minimum_episodes': 1000, 'update_episodes': 1000,
                       'eval_rate': 0.5, 'seed': 5,
                       'model_dir': str(tmp_path / 'models')}})
    net = SimpleConv2dModel(generator=torch.Generator().manual_seed(8))
    learner = Learner(args, net=net, device='cpu', remote=True)
    learner.worker.run()
    thread = threading.Thread(target=learner.server, daemon=True)
    thread.start()
    yield learner, entry, data
    learner.shutdown_flag = True
    thread.join(30)
    learner.shutdown()
    assert not thread.is_alive()


@pytest.mark.timeout(120)
def test_a_jax_gather_is_served(server):
    learner, _entry, data = server
    conn = _connect(data)
    tasks = jax_connection.send_recv(conn, ('args', [None] * 4))
    assert len(tasks) == 4
    for t in tasks:
        assert set(t) == TASK_KEYS
        assert t['role'] in ('g', 'e')
        assert set(t['model_id']) == {0, 1}
    assert [t['task_id'] for t in tasks] == [0, 1, 2, 3]
    gens = [t for t in tasks if t['role'] == 'g']
    evals = [t for t in tasks if t['role'] == 'e']
    assert gens and evals
    assert [t['sample_key'] for t in gens] == list(range(len(gens)))
    assert [t['sample_key'] for t in evals] == list(range(len(evals)))
    for t in gens:
        assert t['player'] == [0, 1] and t['model_id'] == {0: 0, 1: 0}
    for t in evals:
        assert len(t['player']) == 1
        assert t['model_id'][t['player'][0]] == 0

    # the snapshot builds a JAX model that computes the port's outputs
    snap = jax_connection.send_recv(conn, ('model', 0))
    assert snap['architecture'] == 'SimpleConv2dModel'
    jenv = jax_make_env({'env': 'TicTacToe'})
    jmodel = JaxModelWrapper.from_snapshot(snap, jenv.observation(0))
    env = make_env({'env': 'TicTacToe'})
    boards = []
    rng = np.random.default_rng(3)
    for _ in range(6):
        env.reset()
        for _ in range(rng.integers(0, 6)):
            env.step({env.turn(): int(rng.choice(env.legal_actions()))})
        boards += [env.observation(p) for p in env.players()]
    obs = np.stack(boards)
    want = jmodel.batch_inference(obs)
    got = ModelWrapper(learner.module, device='cpu').batch_inference(obs)
    for k in ('policy', 'value'):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                   atol=TOL, err_msg=k)

    # JAX-played uploads are taken and counted once
    args = dict(learner.args)
    episodes = [JaxGenerator(jenv, args).execute(
        {p: jmodel for p in jenv.players()}, t) for t in gens]
    results = [JaxEvaluator(jenv, args).execute(
        {p: (jmodel if p in t['player'] else None) for p in jenv.players()},
        t) for t in evals]
    assert jax_connection.send_recv(conn, ('episode', episodes)) \
        == [None] * len(episodes)
    assert jax_connection.send_recv(conn, ('result', results)) \
        == [None] * len(results)
    assert jax_connection.send_recv(conn, ('episode', episodes)) \
        == [None] * len(episodes)   # a resend: acknowledged, dropped
    jax_connection.send_recv(conn, ('args', [None]))   # a barrier
    assert learner.num_returned_episodes == len(episodes)
    assert learner.ledger.stats['duplicates'] == len(episodes)
    assert learner.ledger.outstanding() == 1
    assert sum(n for n, _, _ in learner.results.values()) == len(results)
    conn.close()


@pytest.mark.timeout(60)
def test_entry_handshake_answers_a_jax_host(server):
    learner, entry, _data = server
    host_args = {'server_address': '127.0.0.1', 'num_parallel': 3,
                 'backend': '', 'address': 'host-a', 'num_gathers': 1}
    merged = []
    for _ in range(2):
        conn = _connect(entry)
        merged.append(jax_connection.send_recv(conn, dict(host_args)))
        conn.close()
    assert [m['worker']['base_worker_id'] for m in merged] == [0, 3]
    assert merged[0]['worker']['num_parallel'] == 3
    assert merged[0]['env'] == {'env': 'TicTacToe'}
    assert merged[0]['seed'] == 5 and merged[0]['fault_tolerance'] \
        == learner.args['fault_tolerance']
