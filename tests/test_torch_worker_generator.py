"""The worker plane's sequential generator and worker
(handyrl_tpu_torch/generation.py ``Generator``, handyrl_tpu_torch/
worker.py ``Worker``) against the JAX package's ``Generator``
(handyrl_tpu/generation.py).

One set of weights drives both packages: GeeseNet (filters 16, 2 blocks;
the JAX side its 'pad' trunk, the port its 'pallas' trunk, whose plain
version runs on the CPU) and TicTacToe's full-width SimpleConv2dModel,
carried across with ``params_from_flax``; model id 0 is the
``RandomModel`` of each package. Each task's episode is a pure function of
(seed, sample_key, params); a task without a key draws from the worker's
namespace stream, the same in both.

The records must be equal in args, steps, outcome, and every moment's
turn list, observations, actions, action masks, rewards and returns;
``value`` and ``selected_prob`` within 1e-5 absolute (fp32 forwards of
the same weights that sum in other orders; the seeded draws are the same
numbers, so the actions differ only if a draw lands within that of a
boundary of the cumulative policy, which these keys do not). Two port
workers with different ids give the same record for one keyed task, and
a worker's last beacon reports its stats and launch counts."""

import os

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.generation import Generator as JaxGenerator
from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
from handyrl_tpu.model import RandomModel as JaxRandomModel
from handyrl_tpu.models import build as jax_build
from handyrl_tpu_torch.connection import HEARTBEAT_KIND
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.generation import Generator
from handyrl_tpu_torch.model import ModelWrapper, RandomModel
from handyrl_tpu_torch.models import geese, tictactoe
from handyrl_tpu_torch.ops import batch
from handyrl_tpu_torch.worker import Worker


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


TOL = 1e-5
SEED = 7
ARGS = {
    'HungryGeese': {'seed': SEED, 'observation': True, 'gamma': 0.99,
                    'compress_steps': 4},
    'TicTacToe': {'seed': SEED, 'observation': False, 'gamma': 0.8,
                  'compress_steps': 4},
}
_CACHE = {}


def _wrappers(env_name):
    """(JAX wrapper, port wrapper) of the same weights."""
    if env_name not in _CACHE:
        obs = jax_make_env({'env': env_name}).observation(0)
        if env_name == 'HungryGeese':
            jw = JaxModelWrapper(jax_build('GeeseNet', filters=16, layers=2),
                                 seed=3)
            jw.ensure_params(obs)
            net = geese.GeeseNet(filters=16, layers=2, torus_impl='pallas')
            net.load_state_dict(geese.params_from_flax(
                jax.tree_util.tree_map(np.asarray, jw.params)))
        else:
            jw = JaxModelWrapper(jax_build('SimpleConv2dModel'), seed=4)
            jw.ensure_params(obs)
            net = tictactoe.SimpleConv2dModel()
            net.load_state_dict(tictactoe.params_from_flax(
                jax.tree_util.tree_map(np.asarray, jw.params)))
        _CACHE[env_name] = (jw, ModelWrapper(net, device='cpu'))
    return _CACHE[env_name]


def _task(env, key, model_id=1):
    task = {'role': 'g', 'player': env.players(),
            'model_id': {p: model_id for p in env.players()}}
    if key is not None:
        task['sample_key'] = key
    return task


def assert_same_record(got, want):
    assert got['args'] == want['args']
    assert got['steps'] == want['steps'] and got['outcome'] == want['outcome']
    gm = batch.decompress_moments(got['moment'])
    wm = batch.decompress_moments(want['moment'])
    assert len(gm) == len(wm) == got['steps']
    for a, b in zip(gm, wm):
        assert a['turn'] == b['turn']
        for key in ('observation', 'action', 'action_mask', 'reward',
                    'return', 'value', 'selected_prob'):
            assert a[key].keys() == b[key].keys()
            for p in b[key]:
                if b[key][p] is None:
                    assert a[key][p] is None, (key, p)
                elif key in ('value', 'selected_prob'):
                    np.testing.assert_allclose(
                        np.asarray(a[key][p]), np.asarray(b[key][p]),
                        rtol=0, atol=TOL, err_msg=key)
                else:
                    np.testing.assert_array_equal(
                        np.asarray(a[key][p]), np.asarray(b[key][p]),
                        err_msg=key)


@pytest.mark.parametrize('env_name,keys,random_model', [
    ('HungryGeese', (0, 5, None, 17), False),
    ('HungryGeese', (3, None), True),
    ('TicTacToe', (1, None, 2, 9), False),
    ('TicTacToe', (4,), True),
])
def test_generator_gives_the_reference_records(env_name, keys, random_model):
    jw, pw = _wrappers(env_name)
    jenv, env = jax_make_env({'env': env_name}), make_env({'env': env_name})
    if random_model:   # model id 0: uniform play after masking
        jw = JaxRandomModel(jw, jenv.observation(0))
        pw = RandomModel(pw, env.observation(0))
    args = ARGS[env_name]
    jgen = JaxGenerator(jenv, args, namespace=3)
    gen = Generator(env, args, namespace=3)
    for key in keys:
        want = jgen.execute({p: jw for p in jenv.players()},
                            _task(jenv, key))
        got = gen.execute({p: pw for p in env.players()}, _task(env, key))
        assert want is not None and got is not None
        assert_same_record(got, want)


class _ScriptedGather:
    """A gather's end of a worker's pipe: hands out ``tasks`` then None,
    answers 'model' with ``snapshot`` and acks uploads."""

    def __init__(self, tasks, snapshot):
        self.tasks = list(tasks) + [None]
        self.snapshot = snapshot
        self.sent = []
        self._reply = None

    def send(self, msg):
        self.sent.append(msg)
        kind = msg[0]
        if kind == 'args':
            self._reply = self.tasks.pop(0)
        elif kind == 'model':
            self._reply = self.snapshot
        elif kind != HEARTBEAT_KIND:
            self._reply = None

    def recv(self):
        return self._reply


def _worker_args(env_name):
    return dict(ARGS[env_name], env={'env': env_name},
                worker={'device': 'cpu'}, eval={'opponent': ['random']},
                fault_tolerance={'heartbeat_interval': 10.0})


@pytest.mark.parametrize('env_name', ['HungryGeese', 'TicTacToe'])
def test_two_workers_play_one_keyed_task_alike(env_name):
    jw, pw = _wrappers(env_name)
    jenv = jax_make_env({'env': env_name})
    want = JaxGenerator(jenv, ARGS[env_name], namespace=0).execute(
        {p: jw for p in jenv.players()}, _task(jenv, 11))
    records = []
    for wid in (1, 6):
        task = _task(make_env({'env': env_name}), 11)
        task['task_id'] = 40 + wid
        gather = _ScriptedGather([task], pw.snapshot())
        Worker(_worker_args(env_name), gather, wid).run()
        uploads = [m[1] for m in gather.sent if m[0] == 'episode']
        beacons = [m[1] for m in gather.sent if m[0] == HEARTBEAT_KIND]
        assert len(uploads) == 1
        assert [m for m in gather.sent if m[0] == 'model'] == [('model', 1)]
        # the last beacon, sent on the None task, reports the episode
        assert beacons and beacons[-1]['worker'] == wid
        assert beacons[-1]['stats']['episodes'] == 1
        assert beacons[-1]['stats']['plies'] == uploads[0]['steps']
        assert set(beacons[-1]['launches']) >= {'geese_trunk'}
        assert sum(beacons[-1]['launches'].values()) == 0   # the CPU
        records.append(uploads[0])
    for rec in records:
        expect = dict(want, args=dict(want['args'], task_id=rec['args']
                                      ['task_id']))
        assert_same_record(rec, expect)
    assert records[0]['moment'] == records[1]['moment']


def test_worker_plays_evaluation_tasks():
    _, pw = _wrappers('TicTacToe')
    env = make_env({'env': 'TicTacToe'})
    tasks = [{'role': 'e', 'player': [p], 'sample_key': k,
              'model_id': {q: (1 if q == p else -1) for q in env.players()}}
             for k, p in enumerate(env.players())]
    gather = _ScriptedGather(tasks, pw.snapshot())
    Worker(_worker_args('TicTacToe'), gather, 2).run()
    results = [m[1] for m in gather.sent if m[0] == 'result']
    assert [r['args']['sample_key'] for r in results] == [0, 1]
    for r in results:
        assert r['opponent'] == 'random'
        assert set(r['result']) == set(env.players())
