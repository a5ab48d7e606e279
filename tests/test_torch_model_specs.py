"""The model specs of handyrl_tpu_torch/evaluation.py ``load_model``
beyond learner checkpoints: ``registry://ROOT/line@selector`` (a snapshot
of handyrl_tpu_torch/serving/registry.py) and
``serve://host:port/line@selector`` (serving/client.py
``RemoteServiceModel`` through ``model_from_spec``), against the
``.ckpt`` of the same weights and the JAX package's ``load_model``.

The nets are the envs' own at full width (TicTacToe's SimpleConv2dModel;
GeeseNet with the 'pallas' trunk, whose plain version runs on the CPU),
seeded. A registry snapshot holds the checkpoint's bytes, so its model
equals the checkpoint's exactly. A service answers from its own copy of
the snapshot through its engine, which batches rows into other bucket
sizes, so ``serve://`` is held within 1e-5 (fp32 sums in other orders),
and the JAX package's proxy to the same service must read the same
replies exactly. A fleet resolver's endpoint loads through the fleet's
RoutedClient (serving/fleet.py) and reads the replica's replies exactly;
the batched evaluator refuses a ``serve://`` opponent as the JAX one
does."""

import os
import random

import numpy as np
import pytest
import torch

from handyrl_tpu import evaluation as jax_eval
from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.generation import BatchedEvaluator as JaxBatchedEvaluator
from handyrl_tpu_torch import evaluation
from handyrl_tpu_torch.agent import Agent
from handyrl_tpu_torch.config import serving_args
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.generation import BatchedEvaluator
from handyrl_tpu_torch.model import ModelWrapper, params_bytes
from handyrl_tpu_torch.serving.client import (RemoteServiceModel,
                                              parse_endpoint)
from handyrl_tpu_torch.serving.registry import ModelRegistry
from handyrl_tpu_torch.serving.service import InferenceService


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
ENVS = {'TicTacToe': {'env': 'TicTacToe'},
        'HungryGeese': {'env': 'HungryGeese', 'torus_impl': 'pallas'}}


def observations(env, count=6, seed=0):
    """Observations of every player along a seeded random game."""
    rng = random.Random(seed)
    env.reset()
    out = []
    while len(out) < count:
        if env.terminal():
            env.reset()
        out += [env.observation(p) for p in env.players()]
        env.step({p: rng.choice(env.legal_actions(p)) for p in env.turns()})
    return out[:count]


@pytest.fixture(scope='module', params=sorted(ENVS))
def published(request, tmp_path_factory):
    """(env_args, .ckpt path, registry root, running CPU service) of one
    seeded net, published as 'line@1', the champion."""
    env_args = ENVS[request.param]
    env = make_env(env_args)
    torch.manual_seed(9)
    module = env.net()
    tmp = tmp_path_factory.mktemp('specs_' + request.param)
    ckpt = str(tmp / '1.ckpt')
    with open(ckpt, 'wb') as f:
        f.write(params_bytes(module))
    root = str(tmp / 'registry')
    ModelRegistry(root).publish(
        'line', snapshot=ModelWrapper(module, 'cpu').snapshot(), version=1,
        promote=True)
    service = InferenceService(serving_args(
        env_args, {}, {'port': 0, 'registry_dir': root}), device='cpu')
    service.start()
    try:
        yield env_args, ckpt, root, service
    finally:
        service.stop(drain=False)


def test_a_registry_spec_equals_its_checkpoint(published):
    env_args, ckpt, root, _ = published
    env = make_env(env_args)
    want = evaluation.load_model(ckpt, env, 'cpu')
    got = evaluation.load_model('registry://%s/line@champion' % root, env,
                                'cpu')
    assert isinstance(got, ModelWrapper) and got.device.type == 'cpu'
    for obs in observations(env):
        a, b = got.inference(obs), want.inference(obs)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    if env_args['env'] == 'TicTacToe':   # the JAX package reads it too
        jax_model = jax_eval.load_model('registry://%s/line@1' % root,
                                        jax_make_env(env_args))
        for obs in observations(env):
            np.testing.assert_allclose(
                np.asarray(jax_model.inference(obs, None)['policy']),
                want.inference(obs)['policy'], rtol=0, atol=TOL)


def test_a_serve_spec_plays_through_the_service(published):
    env_args, ckpt, _, service = published
    env = make_env(env_args)
    want = evaluation.load_model(ckpt, env, 'cpu')
    spec = 'serve://127.0.0.1:%d/line@champion' % service.port
    got = evaluation.load_model(spec, env)
    jax_got = jax_eval.load_model(spec, jax_make_env(env_args))
    try:
        assert isinstance(got, RemoteServiceModel)
        assert got.init_hidden() is None
        for obs in observations(env):
            a, b = got.inference(obs), want.inference(obs)
            for k in ('policy', 'value'):
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=TOL)
            j = jax_got.inference(obs)
            for k in a:
                np.testing.assert_array_equal(np.asarray(j[k]), a[k])
        # a greedy agent on the proxy plays the checkpoint's moves
        env.reset()
        for p in env.turns():
            assert Agent(got).action(env, p) == Agent(want).action(env, p)
        assert service.stats()['answered'] > 0
    finally:
        got.close()
        jax_got.close()


def test_the_batched_evaluator_refuses_a_serve_opponent(published):
    env_args, ckpt, _, service = published
    spec = 'serve://127.0.0.1:%d/line@champion' % service.port
    wrapper = evaluation.load_model(ckpt, make_env(env_args), 'cpu')
    with pytest.raises(ValueError, match='batched inference') as port_exc:
        BatchedEvaluator(lambda i: make_env(env_args), wrapper,
                         {'eval': {'opponent': [spec]}}, n_envs=2)
    jax_wrapper = jax_eval.load_model(ckpt, jax_make_env(env_args))
    with pytest.raises(ValueError) as jax_exc:
        JaxBatchedEvaluator(lambda i: jax_make_env(env_args), jax_wrapper,
                            {'eval': {'opponent': [spec]}}, n_envs=2)
    assert str(port_exc.value) == str(jax_exc.value)


def test_a_fleet_endpoint_is_refused_naming_the_missing_module(tmp_path):
    """The refusal is gone with the fleet's port: a ``serve://`` spec of a
    resolver answers through a RoutedClient over its replicas, exactly as
    the replica itself answers."""
    from handyrl_tpu_torch.serving.fleet import RoutedClient, ServiceResolver
    env_args = ENVS['TicTacToe']
    env = make_env(env_args)
    torch.manual_seed(9)
    root = str(tmp_path / 'registry')
    ModelRegistry(root).publish(
        'line', snapshot=ModelWrapper(env.net(), 'cpu').snapshot(),
        version=1, promote=True)
    args = serving_args(env_args, {}, {'port': 0, 'registry_dir': root})
    resolver = ServiceResolver(args).start()
    service = InferenceService(serving_args(env_args, {}, {
        'port': 0, 'registry_dir': root, 'fleet': {
            'resolver': '127.0.0.1:%d' % resolver.port,
            'heartbeat_interval': 0.1}}), device='cpu').start()
    got = direct = None
    try:
        assert resolver.wait_routable(1, timeout=60)
        got = evaluation.load_model(
            'serve://127.0.0.1:%d/line@champion' % resolver.port, env)
        assert isinstance(got, RemoteServiceModel)
        assert isinstance(got.client, RoutedClient)
        direct = evaluation.load_model(
            'serve://127.0.0.1:%d/line@champion' % service.port, env)
        for obs in observations(env):
            a, b = got.inference(obs), direct.inference(obs)
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]))
    finally:
        for model in (got, direct):
            if model is not None:
                model.close()
        service.stop(drain=False)
        resolver.stop(drain=False)


@pytest.mark.parametrize('raw', [
    'a.ckpt:random', 'x.ckpt', 'registry://m/l@champion',
    'serve://h:9/l@1:random',
    'registry://models/default@champion:serve://127.0.0.1:9997/default@2',
    'serve://127.0.0.1:9997/default@champion:rulebase-1'])
def test_split_model_specs_round_trips(raw):
    parts = evaluation.split_model_specs(raw)
    assert parts == jax_eval.split_model_specs(raw)
    assert ':'.join(parts) == raw
    assert all(p.startswith(('serve://', 'registry://')) or ':' not in p
               for p in parts)


def test_endpoints_parse_as_the_jax_package_parses_them():
    from handyrl_tpu.serving.client import parse_endpoint as jax_parse
    for endpoint in ('127.0.0.1:9997', 'host:1', ':5', '42'):
        assert parse_endpoint(endpoint) == jax_parse(endpoint)
