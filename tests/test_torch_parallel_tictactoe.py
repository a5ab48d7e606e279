"""ParallelTicTacToe in the port (handyrl_tpu_torch/envs/
parallel_tictactoe.py), against the JAX package's (handyrl_tpu/envs/
parallel_tictactoe.py): the simultaneous env move for move, its episode
layout through the batched generator and the batch (both players act
every ply; a window is one seat's, the solo layout), and the learners
through the CLI.

Tolerances: the env, the moments' turns, actions and observations and the
batch's masks are exact; values within 1e-5 (the same net's forward in
the two packages)."""

import json
import os
import random
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.generation import BatchedGenerator as JaxBatchedGenerator
from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
from handyrl_tpu.models.tictactoe import SimpleConv2dModel as JaxNet
from handyrl_tpu.ops import batch as jbatch
from handyrl_tpu_torch.config import apply_defaults
from handyrl_tpu_torch.environment import ENVS, make_env
from handyrl_tpu_torch.generation import BatchedGenerator
from handyrl_tpu_torch.model import ModelWrapper
from handyrl_tpu_torch.models.tictactoe import (SimpleConv2dModel,
                                                params_from_flax)
from handyrl_tpu_torch.ops import batch as tbatch


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
TOL = 1e-5
ENV_ARGS = {'env': 'ParallelTicTacToe'}


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_env_plays_move_for_move_like_the_reference(seed):
    """Seeded games to a full board or a line: the env's own
    ``random.choice`` over the submitted actions draws the same seat in
    both packages; observations from each seat's colour, the delta
    strings and a mirror env follow."""
    env, ref = make_env(ENV_ARGS), jax_make_env(ENV_ARGS)
    mirror = make_env(ENV_ARGS)
    rng = random.Random(seed)
    for game in range(6):
        env.reset()
        ref.reset()
        mirror.update(env.diff_info(), True)
        while not ref.terminal():
            assert env.terminal() is False
            assert env.turns() == ref.turns() == [0, 1]
            for p in (None, 0, 1):
                np.testing.assert_array_equal(env.observation(p),
                                              ref.observation(p))
                assert env.legal_actions(p) == ref.legal_actions(p)
            actions = {p: rng.choice(ref.legal_actions(p))
                       for p in ref.turns()}
            state = random.getstate()
            env.step(dict(actions))
            random.setstate(state)
            ref.step(dict(actions))
            np.testing.assert_array_equal(env.cells, ref.cells)
            assert env.diff_info() == ref.diff_info()
            mirror.update(env.diff_info(), False)
            np.testing.assert_array_equal(mirror.cells, env.cells)
        assert env.terminal() and env.outcome() == ref.outcome()
        assert str(env) == str(ref)
    with pytest.raises(NotImplementedError):
        env.turn()


def test_env_is_registered_on_every_path():
    assert ENVS['ParallelTicTacToe'] == \
        'handyrl_tpu_torch.envs.parallel_tictactoe'
    assert isinstance(make_env(ENV_ARGS).net(), SimpleConv2dModel)
    for train in ({'turn_based_training': False},
                  {'turn_based_training': False,
                   'batched_generation': False}):
        args = apply_defaults({'env_args': dict(ENV_ARGS),
                               'train_args': train})
        assert args['env_args'] == ENV_ARGS


@pytest.mark.timeout(120)
def test_episode_layout_matches_jax():
    """Batched self-play of 4 envs on the same seeds and weights: both
    seats act and observe every ply, the same moves and outcomes as the
    JAX generator's; the batch (not turn-based) is the JAX builder's."""
    jm = JaxNet()
    params = jm.init(jax.random.PRNGKey(0),
                     np.zeros((1, 3, 3, 3), np.float32))
    jw = JaxModelWrapper(jm, params)
    net = SimpleConv2dModel()
    net.load_state_dict(params_from_flax(params))
    pw = ModelWrapper(net, device='cpu')
    args = {'observation': True, 'gamma': 1.0, 'compress_steps': 4,
            'turn_based_training': False, 'forward_steps': 4,
            'burn_in_steps': 0, 'maximum_episodes': 100}
    runs = []
    for cls, make, w in ((JaxBatchedGenerator, jax_make_env, jw),
                         (BatchedGenerator, make_env, pw)):
        np.random.seed(3)
        random.seed(3)
        gen = cls(lambda i: make(dict(ENV_ARGS, id=i)), w, args, n_envs=4)
        eps = []
        while len(eps) < 6:
            eps += gen.step()
        runs.append(eps[:6])
    want, got = runs
    for g, w in zip(got, want):
        assert g['steps'] == w['steps'] and g['outcome'] == w['outcome']
        for a, b in zip(tbatch.decompress_moments(g['moment']),
                        jbatch.decompress_moments(w['moment'])):
            assert a['turn'] == b['turn'] == [0, 1]
            assert a['action'] == b['action']
            for p in (0, 1):
                np.testing.assert_array_equal(a['observation'][p],
                                              b['observation'][p])
                np.testing.assert_allclose(a['value'][p], b['value'][p],
                                           rtol=0, atol=TOL)
    # not turn-based: each window is one seat's (the solo layout), drawn
    # as the JAX builder draws it
    batches = []
    for pkg, eps in ((jbatch, want), (tbatch, got)):
        random.seed(4)
        batches.append(pkg.make_batch([pkg.select_episode(eps, args)
                                       for _ in range(3)], args))
    jb, batch = batches
    assert batch['observation'].shape == (3, 4, 1, 3, 3, 3)
    assert batch['action'].shape == (3, 4, 1, 1)
    assert set(batch) == set(jb)
    for k in jb:
        np.testing.assert_allclose(batch[k], jb[k], rtol=0, atol=TOL,
                                   err_msg=k)
    # both seats act every ply: the seat's turn and observation masks are
    # the episode mask
    np.testing.assert_array_equal(batch['turn_mask'],
                                  batch['observation_mask'])
    np.testing.assert_array_equal(batch['turn_mask'],
                                  batch['episode_mask'])


@pytest.mark.timeout(300)
@pytest.mark.parametrize('plane', ['batched', 'workers'])
def test_parallel_tictactoe_trains_through_the_cli(tmp_path, plane):
    """The host learner on tictactoe.json's train_args cut to size, not
    turn-based; the batched generators and the worker plane."""
    with open(os.path.join(REPO, 'tictactoe.json')) as f:
        train = json.load(f)['train_args']
    train.update({'turn_based_training': False, 'batch_size': 8,
                  'forward_steps': 4, 'generation_envs': 4,
                  'num_batchers': 1, 'minimum_episodes': 8,
                  'update_episodes': 8, 'epochs': 1,
                  'model_dir': str(tmp_path / 'models')})
    if plane == 'workers':
        train.update({'batched_generation': False,
                      'worker': {'num_parallel': 2}})
    path = tmp_path / 'cfg.json'
    path.write_text(json.dumps({'env_args': ENV_ARGS, 'train_args': train}))
    env = dict(os.environ, OMP_NUM_THREADS='1')
    proc = subprocess.run(
        [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config',
         str(path), '--device', 'cpu'], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=280)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads([l for l in proc.stdout.splitlines()
                       if l.startswith('{')][-1])
    assert line['epochs'] == 1 and not line['failed'] and line['steps'] > 0
    assert (tmp_path / 'models' / 'latest.ckpt').exists()
