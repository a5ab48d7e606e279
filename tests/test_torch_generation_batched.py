"""The port's batched generator and evaluator (handyrl_tpu_torch/
generation.py) against the JAX package's (handyrl_tpu/generation.py).

One set of GeeseNet weights (filters 16, 2 blocks) drives both: the JAX
side runs its 'pad' trunk (the same param tree as 'pallas', held equal to
it by tests/test_pallas_geese.py), the port its 'pallas' trunk, whose plain
version runs on the CPU; the weights are carried across with
``params_from_flax``. Both get the same env ids (``Environment({'id': i})``
seeds each env's rng) and the same ``np.random`` and ``random`` seeds.

The same episodes must result: the records' args, steps and outcomes, and
every moment's turn list, observations, actions, action masks, rewards and
returns equal; ``value`` and ``selected_prob`` within 1e-5 absolute (fp32
forwards of the same weights that sum in other orders; the Gumbel draws
are the same numbers, so the actions only differ if two masked logits
plus noise tie within that, which these seeds do not). The evaluator must
give the same results, opponent by opponent."""

import os
import copy
import random

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.generation import BatchedEvaluator as JaxBatchedEvaluator
from handyrl_tpu.generation import BatchedGenerator as JaxBatchedGenerator
from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
from handyrl_tpu.models import build as jax_build
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.generation import (BatchedEvaluator, BatchedGenerator,
                                          finalize_episode_record,
                                          seed_env_rng)
from handyrl_tpu_torch.model import ModelWrapper
from handyrl_tpu_torch.models.geese import GeeseNet, params_from_flax
from handyrl_tpu_torch.ops import batch


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
ENVS = 6
_CACHE = {}


def _models():
    """(JAX wrapper, port wrapper) of the same small GeeseNet weights."""
    if 'models' not in _CACHE:
        jw = JaxModelWrapper(jax_build('GeeseNet', filters=16, layers=2),
                             seed=3)
        jw.ensure_params(jax_make_env({'env': 'HungryGeese'}).observation(0))
        net = GeeseNet(filters=16, layers=2, torus_impl='pallas')
        net.load_state_dict(params_from_flax(
            jax.tree_util.tree_map(np.asarray, jw.params)))
        _CACHE['models'] = (jw, ModelWrapper(net, device='cpu'))
    return _CACHE['models']


def _run(gen_cls, make, wrapper, args, until, seed, **kw):
    np.random.seed(seed)
    random.seed(seed)
    gen = gen_cls(lambda i: make({'env': 'HungryGeese', 'id': i}), wrapper,
                  args, n_envs=ENVS, **kw)
    out, plies = [], 0
    while len(out) < until:
        out += gen.step()
        plies += 1
        assert plies < 2000
    return out


@pytest.mark.parametrize('observation', [True, False])
def test_generator_gives_the_reference_episodes(observation):
    jw, pw = _models()
    args = {'observation': observation, 'gamma': 0.99, 'compress_steps': 4}
    want = _run(JaxBatchedGenerator, jax_make_env, jw, args, 12, seed=5)
    got = _run(BatchedGenerator, make_env, pw, args, 12, seed=5)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g['args'] == w['args']
        assert g['steps'] == w['steps'] and g['outcome'] == w['outcome']
        gm = batch.decompress_moments(g['moment'])
        wm = batch.decompress_moments(w['moment'])
        assert len(gm) == len(wm) == g['steps']
        for a, b in zip(gm, wm):
            assert a['turn'] == b['turn']
            for key in ('observation', 'action', 'action_mask', 'reward',
                        'return'):
                assert a[key].keys() == b[key].keys()
                for p in b[key]:
                    if b[key][p] is None:
                        assert a[key][p] is None, (key, p)
                    else:
                        np.testing.assert_array_equal(
                            np.asarray(a[key][p]), np.asarray(b[key][p]),
                            err_msg=key)
            for key in ('value', 'selected_prob'):
                for p in b[key]:
                    if b[key][p] is None:
                        assert a[key][p] is None, (key, p)
                    else:
                        np.testing.assert_allclose(
                            np.asarray(a[key][p]), np.asarray(b[key][p]),
                            rtol=0, atol=TOL, err_msg=key)


def test_evaluator_gives_the_reference_results():
    jw, pw = _models()
    args = {'eval': {'opponent': ['random', 'rulebase']}}
    want = _run(JaxBatchedEvaluator, jax_make_env, jw, args, 10, seed=9)
    got = _run(BatchedEvaluator, make_env, pw, args, 10, seed=9)
    assert got == want
    assert {r['opponent'] for r in got} == {'random', 'rulebase'}


def test_record_helpers_match_the_reference():
    from handyrl_tpu.generation import finalize_episode_record as jax_final
    from handyrl_tpu.generation import seed_env_rng as jax_seed
    envs = [make_env({'env': 'HungryGeese'}),
            jax_make_env({'env': 'HungryGeese'})]
    seed_env_rng(envs[0], 7, (3, 1))
    jax_seed(envs[1], 7, (3, 1))
    assert envs[0].rng.random() == envs[1].rng.random()
    moments = [{'reward': {0: r, 1: None}, 'return': {0: None, 1: None}}
               for r in (1.0, None, 2.0)]
    args = {'gamma': 0.9, 'compress_steps': 2}
    got = finalize_episode_record({0: 1}, copy.deepcopy(moments), args,
                                  {'role': 'g'})
    want = jax_final({0: 1}, copy.deepcopy(moments), args, {'role': 'g'})
    assert got == want


def test_evaluator_plays_a_checkpoint_opponent_like_the_reference(tmp_path):
    """A '.ckpt' opponent: the env's full-width net with the checkpoint's
    params, loaded by each package's ``load_model`` from the same file
    (written by the port), batched across matches like the trained seat."""
    from handyrl_tpu_torch.model import params_bytes
    jw, pw = _models()
    opponent = GeeseNet(generator=torch.Generator().manual_seed(2))
    path = str(tmp_path / '3.ckpt')
    with open(path, 'wb') as f:
        f.write(params_bytes(opponent))
    args = {'eval': {'opponent': [path]}}
    want = _run(JaxBatchedEvaluator, jax_make_env, jw, args, 4, seed=2)
    got = _run(BatchedEvaluator, make_env, pw, args, 4, seed=2)
    assert got == want
