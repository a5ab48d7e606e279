"""The port's Hungry Geese simulator against the JAX package's, move for
move: both are driven with the same env seed and the same random (or
rule-based) actions, and every observation, legal-action list, reward,
outcome, terminal flag and delta-sync record must be identical. Exact
equality: both are pure Python and numpy on the same integers."""

import os
import torch
import random

import numpy as np
import pytest

from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu_torch.environment import make_env


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


def _assert_same_state(a, b):
    assert a.terminal() == b.terminal()
    assert a.turns() == b.turns()
    assert a.players() == b.players()
    assert a.reward() == b.reward()
    assert a.diff_info() == b.diff_info()
    assert str(a) == str(b)
    for p in a.players():
        assert a.legal_actions(p) == b.legal_actions(p)
        oa, ob = a.observation(p), b.observation(p)
        assert oa.dtype == ob.dtype and oa.shape == ob.shape == (17, 7, 11)
        np.testing.assert_array_equal(oa, ob)


@pytest.mark.parametrize('policy', ['random', 'rule_based'])
def test_seeded_play_is_identical(policy):
    episodes, plies = 0, 0
    for seed in range(4):
        args = {'env': 'HungryGeese', 'id': seed}
        ref, env = jax_make_env(dict(args)), make_env(dict(args))
        rng = random.Random(100 + seed)
        for _ in range(2):          # the second episode reuses the env rng
            ref.reset()
            env.reset()
            _assert_same_state(ref, env)
            while not ref.terminal():
                if policy == 'random':
                    actions = {p: rng.choice(env.legal_actions(p))
                               for p in env.turns()}
                else:
                    actions = {p: env.rule_based_action(p)
                               for p in env.turns()}
                    assert actions == {p: ref.rule_based_action(p)
                                       for p in ref.turns()}
                ref.step(actions)
                env.step(actions)
                _assert_same_state(ref, env)
                plies += 1
            assert ref.outcome() == env.outcome()
            episodes += 1
    assert episodes == 8 and plies > 8 * 5


def test_action_strings_and_delta_sync():
    env = make_env({'env': 'HungryGeese', 'id': 3})
    ref = jax_make_env({'env': 'HungryGeese', 'id': 3})
    for a in range(4):
        assert env.action2str(a) == ref.action2str(a)
        assert env.str2action(env.action2str(a)) == a
    rng = random.Random(5)
    for _ in range(6):
        env.step({p: rng.randrange(4) for p in env.turns()})
    mirror = make_env({'env': 'HungryGeese', 'id': 99})
    mirror.update(env.diff_info(), reset=False)
    for p in env.players():
        np.testing.assert_array_equal(mirror.observation(p),
                                      env.observation(p))
    assert mirror.outcome() == env.outcome()
