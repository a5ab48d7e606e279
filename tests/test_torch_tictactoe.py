"""The port's TicTacToe env (handyrl_tpu_torch/envs/tictactoe.py) and its
net, ``SimpleConv2dModel`` (handyrl_tpu_torch/models/tictactoe.py), against
the JAX package's (handyrl_tpu/envs/tictactoe.py, handyrl_tpu/models/
tictactoe.py), and the config repair that makes TicTacToe the default env.

Tolerances:
- the env is exact: the same moves give equal observations, legal actions,
  turns, outcomes, strings and mirror updates;
- the forward, params carried from a flax init (perturbed so no norm is
  the identity), within 1e-5 absolute: fp32 convs and GroupNorm statistics
  summed in other orders (about 2e-6 seen); flax's GroupNorm takes the
  variance as E[x^2] - E[x]^2, torch as E[(x - mean)^2];
- the param round trip and the checkpoint bytes are exact: the same
  leaves give the same bytes."""

import os
import random

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.evaluation import load_model as jax_load_model
from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
from handyrl_tpu.models.tictactoe import SimpleConv2dModel as JaxModel
from handyrl_tpu_torch.config import ConfigError, apply_defaults
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.evaluation import load_model
from handyrl_tpu_torch.model import ModelWrapper, params_bytes
from handyrl_tpu_torch.models import build
from handyrl_tpu_torch.models.tictactoe import (SimpleConv2dModel,
                                                params_from_flax,
                                                params_to_flax)


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


def _boards(n=64, seed=0):
    """Observations of real positions, from both seats' views."""
    env, rng = make_env({'env': 'TicTacToe'}), random.Random(seed)
    obs = []
    while len(obs) < n:
        if env.terminal():
            env.reset()
        obs += [env.observation(p) for p in env.players()]
        env.play(rng.choice(env.legal_actions()))
    return np.stack(obs[:n])


def _flax_params(seed=1):
    """A flax init of the JAX model, every leaf perturbed by 0.1 N(0, 1),
    its maps in the init's order (the order ``to_bytes`` writes)."""
    rng = np.random.RandomState(seed)

    def perturb(tree):
        if isinstance(tree, dict):
            return {k: perturb(v) for k, v in tree.items()}
        a = np.asarray(tree)
        return a + 0.1 * rng.randn(*a.shape).astype(np.float32)
    return perturb(JaxModel().init(jax.random.PRNGKey(seed),
                                   np.zeros((1, 3, 3, 3), np.float32)))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_env_plays_move_for_move_like_the_reference(seed):
    env, ref = make_env({'env': 'TicTacToe'}), jax_make_env(
        {'env': 'TicTacToe'})
    mirror = make_env({'env': 'TicTacToe'})
    rng = random.Random(seed)
    for _ in range(8):
        env.reset()
        ref.reset()
        mirror.update(env.diff_info(), True)
        while not ref.terminal():
            assert env.terminal() is False
            assert env.turn() == ref.turn() and env.turns() == ref.turns()
            assert env.legal_actions() == ref.legal_actions()
            for p in (None, 0, 1):
                np.testing.assert_array_equal(env.observation(p),
                                              ref.observation(p))
            action = rng.choice(ref.legal_actions())
            assert env.action2str(action) == ref.action2str(action)
            assert env.str2action(ref.action2str(action)) == action
            env.step({env.turn(): action})
            ref.play(action)
            assert env.diff_info() == ref.diff_info()
            mirror.update(env.diff_info(), False)
            np.testing.assert_array_equal(mirror.cells, env.cells)
        assert env.terminal() and env.outcome() == ref.outcome()
        assert str(env) == str(ref) and env.players() == ref.players()


def test_forward_matches_flax_with_carried_params():
    params = _flax_params()
    obs = _boards()
    want = JaxModel().apply(params, obs)
    net = SimpleConv2dModel()
    net.load_state_dict(params_from_flax(params))
    got = net(torch.from_numpy(obs))
    for k in ('policy', 'value'):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=0, atol=TOL,
                                   err_msg=k)
    # the same forward with a leading (B, T) shape
    got2 = net(torch.from_numpy(obs.reshape((4, 16) + obs.shape[1:])))
    np.testing.assert_array_equal(got2['policy'].detach().numpy().reshape(
        -1, 9), got['policy'].detach().numpy())


def test_params_round_trip_is_the_identity():
    params = _flax_params(seed=3)
    back = params_to_flax(_net_from(params))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    leaves = jax.tree_util.tree_leaves(params)
    assert len(leaves) == 18
    for a, b in zip(leaves, jax.tree_util.tree_leaves(back)):
        assert a.shape == b.shape and np.array_equal(a, b)
    # and the other way: a torch init survives flax and back bit for bit
    net = SimpleConv2dModel(generator=torch.Generator().manual_seed(4))
    again = params_from_flax(params_to_flax(net))
    for k, v in net.state_dict().items():
        assert torch.equal(again[k], v), k


def _net_from(params):
    net = SimpleConv2dModel()
    net.load_state_dict(params_from_flax(params))
    return net


def test_checkpoint_bytes_read_both_ways(tmp_path):
    obs = _boards(16, seed=5)
    # the port writes, the JAX package's load_model reads
    net = SimpleConv2dModel(generator=torch.Generator().manual_seed(6))
    path = tmp_path / '1.ckpt'
    path.write_bytes(params_bytes(net))
    jw = jax_load_model(str(path), jax_make_env({'env': 'TicTacToe'}))
    want = jw.batch_inference(obs)
    got = net(torch.from_numpy(obs))
    for k in ('policy', 'value'):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=0, atol=TOL)
    # the JAX package's checkpoint bytes (ModelWrapper.params_bytes), read
    # by the port's load_model: a fresh init's tree, which the port writes
    # back byte for byte, and a trained one's (optax's tree_map leaves its
    # maps in sorted key order, so only the values can be compared)
    for name, tree in (('2.ckpt', _flax_params(seed=7)),
                       ('3.ckpt', jax.tree_util.tree_map(
                           np.asarray, _flax_params(seed=8)))):
        jw = JaxModelWrapper(JaxModel(), tree)
        path = tmp_path / name
        path.write_bytes(jw.params_bytes())
        pw = load_model(str(path), make_env({'env': 'TicTacToe'}),
                        device='cpu')
        if name == '2.ckpt':
            assert params_bytes(pw.module) == jw.params_bytes()
        want, got = jw.batch_inference(obs), pw.batch_inference(obs)
        for k in ('policy', 'value'):
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                       atol=TOL)


def test_snapshots_load_in_both_packages():
    obs = _boards(8, seed=8)
    jw = JaxModelWrapper(JaxModel(), _flax_params(seed=9))
    pw = ModelWrapper.from_snapshot(jw.snapshot(), device='cpu')
    np.testing.assert_allclose(pw.batch_inference(obs)['value'],
                               np.asarray(jw.batch_inference(obs)['value']),
                               rtol=0, atol=TOL)
    back = JaxModelWrapper.from_snapshot(pw.snapshot(), obs[0])
    assert back.params_bytes() == jw.params_bytes()
    # a non-default width is carried as config and rebuilt
    narrow = ModelWrapper(build('SimpleConv2dModel', filters=8, layers=1),
                          device='cpu')
    snap = narrow.snapshot()
    assert snap['config'] == {'filters': 8, 'layers': 1}
    again = ModelWrapper.from_snapshot(snap, device='cpu')
    assert params_bytes(again.module) == snap['params']


def test_env_net_is_the_full_width_model():
    net = make_env({'env': 'TicTacToe'}).net()
    assert isinstance(net, SimpleConv2dModel)
    assert (net.filters, net.layers, net.config()) == (32, 3, {})
    assert sum(p.numel() for p in net.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(_flax_params()))


def test_config_defaults_to_tictactoe_like_the_reference():
    from handyrl_tpu.config import apply_defaults as jax_apply_defaults
    args = apply_defaults({})
    assert args['env_args'] == jax_apply_defaults({})['env_args'] == {
        'env': 'TicTacToe'}
    # config.yaml's blocks, worker size included, validate as they are
    args = apply_defaults({'env_args': {'env': 'TicTacToe'},
                           'train_args': {'worker': {'num_parallel': 6},
                                          'batch_size': 128}})
    assert args['train_args']['turn_based_training'] is True
    assert args['train_args']['observation'] is False


@pytest.mark.parametrize('train_args,missing', [
    ({'device_generation': True, 'batched_generation': False,
      'generation': {'backend': 'engine'},
      'serving': {'fleet': {'resolver': 'localhost:9000'},
                  'gateway': {'metrics_port': 9102}},
      'distributed': {'num_processes': 2}},
     ('train_args.distributed.num_processes', 'the distributed plane')),
    ({'device_generation': True, 'device_replay': True,
      'generation': {'backend': 'device'}, 'league': {'enabled': True}},
     ('league.enabled requires serving.publish',)),
    ({'device_generation': True, 'device_replay': True,
      'fused_pipeline': False, 'batched_generation': False,
      'inference': {'enabled': True, 'engine_backend': 'tpu'}},
     ("inference.engine_backend must be 'cpu' or 'device'",)),
], ids=['train_args0-EngineSupervisor', 'train_args1-league',
        'train_args2-inference'])
def test_tictactoe_on_the_device_path_names_what_is_missing(train_args,
                                                            missing):
    """TicTacToe runs the fused loop in the 'turn' layout, every other
    device combination, the device actor and engine backends (a serving
    fleet's resolver and the serving tier's exporter ports too); the
    planes the JAX package has and the port not yet (mesh parallelism,
    the distributed runtime) still raise, naming them, as do the league
    without the registry it draws from and an engine backend the JAX
    config refuses."""
    with pytest.raises(ConfigError) as exc:
        apply_defaults({'env_args': {'env': 'TicTacToe'},
                        'train_args': train_args})
    msg = str(exc.value)
    for part in missing:
        assert part in msg
    args = apply_defaults({'env_args': {'env': 'TicTacToe'},
                           'train_args': {'device_generation': True,
                                          'device_replay': True}})
    assert args['train_args']['turn_based_training'] is True


def test_other_envs_and_worker_sizes_are_refused():
    # every env of the JAX registry is ported; one outside it is refused
    with pytest.raises(ConfigError, match='Othello'):
        apply_defaults({'env_args': {'env': 'Othello'}})
    # the worker plane runs: a cluster of 2 is taken, a size below 1 is
    # refused
    assert apply_defaults({'train_args': {'worker': {'num_parallel': 2}}}
                          )['train_args']['worker'] == {'num_parallel': 2}
    with pytest.raises(ConfigError, match='worker'):
        apply_defaults({'train_args': {'worker': {'num_parallel': 0}}})


def test_quick_start_config_is_config_yaml_as_json():
    """tictactoe.json holds config.yaml's env_args and train_args as they
    are (the port parses no YAML)."""
    import json
    import os
    import yaml
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, 'config.yaml')) as f:
        want = yaml.safe_load(f)
    with open(os.path.join(root, 'tictactoe.json')) as f:
        got = json.load(f)
    assert got == {'env_args': want['env_args'],
                   'train_args': want['train_args']}
    assert apply_defaults(got)['env_args'] == {'env': 'TicTacToe'}
