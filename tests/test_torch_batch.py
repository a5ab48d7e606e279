"""The port's batch builder (handyrl_tpu_torch/ops/batch.py) against the JAX
package's (handyrl_tpu/ops/batch.py), on the same episode records: Hungry
Geese episodes generated by the JAX package's BatchedGenerator with a small
GeeseNet (filters 16, 2 blocks). With the same ``random.seed``,
``select_episode`` must draw the same windows, and ``make_batch`` and
``make_batch_reference`` of both packages must give the same batch, equal
bit for bit (numpy only on both sides, so no tolerance), for observation
True and False, solo and turn-based layouts, and windows longer and
shorter than the episodes."""

import os
import torch
import random

import numpy as np
import pytest

from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.generation import BatchedGenerator as JaxBatchedGenerator
from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
from handyrl_tpu.models import build as jax_build
from handyrl_tpu.ops import batch as jax_batch
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


B = 24
_CACHE = {}


def _episodes():
    """30 episode records from the JAX package's batched self-play."""
    if 'eps' not in _CACHE:
        env = jax_make_env({'env': 'HungryGeese'})
        wrapper = JaxModelWrapper(jax_build('GeeseNet', filters=16,
                                            layers=2))
        wrapper.ensure_params(env.observation(0))
        args = {'observation': True, 'gamma': 0.99, 'compress_steps': 4}
        np.random.seed(0)
        random.seed(0)
        gen = JaxBatchedGenerator(
            lambda i: jax_make_env({'env': 'HungryGeese', 'id': i}),
            wrapper, args, n_envs=8)
        eps = []
        while len(eps) < 30:
            eps += gen.step()
        _CACHE['eps'] = eps
    return _CACHE['eps']


def _args(turn_based, observation, forward_steps):
    return {'turn_based_training': turn_based, 'observation': observation,
            'forward_steps': forward_steps, 'burn_in_steps': 0,
            'compress_steps': 4, 'maximum_episodes': 100}


def _assert_batches_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize('turn_based,observation,forward_steps', [
    (False, True, 16), (False, False, 4), (True, True, 8), (True, False, 16)])
def test_selection_and_batches_equal_bit_for_bit(turn_based, observation,
                                                 forward_steps):
    eps = _episodes()
    args = _args(turn_based, observation, forward_steps)
    random.seed(7)
    port_sel = [batch.select_episode(eps, args) for _ in range(B)]
    random.seed(7)
    jax_sel = [jax_batch.select_episode(eps, args) for _ in range(B)]
    for p, j in zip(port_sel, jax_sel):
        assert set(p) == set(j)       # recv_time included
        for k in p:
            assert p[k] == j[k], k

    built = {}
    for name, fn, sel in (
            ('port', batch.make_batch, port_sel),
            ('port_reference', batch.make_batch_reference, port_sel),
            ('jax', jax_batch.make_batch, jax_sel),
            ('jax_reference', jax_batch.make_batch_reference, jax_sel)):
        random.seed(11)   # solo windows draw their seat
        built[name] = fn(sel, args)
    for name in ('port', 'port_reference', 'jax_reference'):
        _assert_batches_equal(built[name], built['jax'])
    # windows shorter than forward_steps were padded in this draw
    assert (built['port']['episode_mask'] == 0).any() or forward_steps == 4


def test_cached_blocks_give_the_same_batch():
    eps = _episodes()
    args = _args(False, True, 16)
    cache = batch.make_block_cache(args)
    random.seed(3)
    sel = [batch.select_episode(eps, args) for _ in range(B)]
    random.seed(5)
    first = batch.make_batch(sel, args, cache=cache)
    random.seed(5)
    again = batch.make_batch(sel, args, cache=cache)
    assert cache.hits > 0
    _assert_batches_equal(again, first)
    random.seed(5)
    _assert_batches_equal(jax_batch.make_batch(sel, args), first)


def test_records_decompress_and_compress_like_the_reference():
    eps = _episodes()
    moments = batch.decompress_moments(eps[0]['moment'])
    assert len(moments) == eps[0]['steps']
    assert batch.compress_moments(moments, 4) == \
        jax_batch.compress_moments(moments, 4)
