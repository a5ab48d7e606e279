"""The port's serving slice as a whole against the JAX package's, on the
CPU. One set of GeeseNet weights (L=2, F=16, torus_impl='pallas': the JAX
side runs its Pallas trunk in interpret mode, the port its trunk's plain
version) is published to two registries, a JAX snapshot in one and the
port's snapshot (made through ``params_from_flax``) in the other. Both
InferenceServices get the same requests from real Hungry Geese plies,
with the same legal actions and sample seeds.

Tolerances: actions equal; ``prob`` and ``value`` within 1e-5 absolute
(fp32 on both sides, different summation orders in the trunk); the port's
reply bit-identical to the port's own local ``model_act``."""

import os
import torch
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from handyrl_tpu.config import apply_defaults
from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
from handyrl_tpu.models.geese import GeeseNet as JaxGeeseNet
from handyrl_tpu.serving.client import ServiceClient as JaxServiceClient
from handyrl_tpu.serving.registry import ModelRegistry as JaxModelRegistry
from handyrl_tpu.serving.service import InferenceService as JaxService
from handyrl_tpu_torch.config import serving_args
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.generation import model_act, sample_seed
from handyrl_tpu_torch.model import ModelWrapper
from handyrl_tpu_torch.models.geese import GeeseNet, params_from_flax
from handyrl_tpu_torch.ops import kernel_launches
from handyrl_tpu_torch.serving.client import ServiceClient, ServiceError
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


NET = dict(layers=2, filters=16, torus_impl='pallas')
SPEC = 'geese@champion'
TOL = 1e-5


def _plies(count, seed=0):
    """(obs, legal, seed sequence) of ``count`` real requests: four geese
    per ply of a seeded random game, reversal excluded from ``legal``."""
    env = make_env({'env': 'HungryGeese', 'id': seed})
    rng = random.Random(seed)
    last, out, ply = {}, [], 0
    while len(out) < count:
        if env.terminal():
            env.reset()
            last = {}
        actions = {}
        for p in env.turns():
            legal = [a for a in range(4) if a != {0: 1, 1: 0, 2: 3, 3: 2}
                     .get(last.get(p))]
            out.append((env.observation(p), legal,
                        sample_seed(seed, (7, p), ply)))
            actions[p] = rng.choice(legal)
        env.step(actions)
        last.update(actions)
        ply += 1
    return out[:count]


@pytest.fixture(scope='module')
def services(tmp_path_factory):
    obs0 = _plies(1)[0][0]
    jax_net = JaxGeeseNet(**NET)
    params = jax_net.init(jax.random.PRNGKey(3), jnp.asarray(obs0)[None])
    jax_wrapper = JaxModelWrapper(jax_net, params)
    port_net = GeeseNet(**NET)
    port_net.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    port_wrapper = ModelWrapper(port_net, device='cpu')

    jax_root = str(tmp_path_factory.mktemp('jax_registry'))
    port_root = str(tmp_path_factory.mktemp('port_registry'))
    JaxModelRegistry(jax_root).publish('geese', snapshot=jax_wrapper.snapshot(),
                                       version=1, promote=True)
    ModelRegistry(port_root).publish('geese', snapshot=port_wrapper.snapshot(),
                                     version=1, promote=True)

    jax_args = apply_defaults({
        'env_args': {'env': 'HungryGeese'},
        'train_args': {'serving': {'port': 0, 'registry_dir': jax_root}},
    })['train_args']
    jax_args['env'] = {'env': 'HungryGeese'}
    port_args = serving_args({'env': 'HungryGeese'}, {},
                             {'port': 0, 'registry_dir': port_root})
    jax_svc = JaxService(jax_args).start()
    port_svc = InferenceService(port_args, device='cpu').start()
    try:
        yield {'jax': jax_svc, 'port': port_svc, 'port_root': port_root}
    finally:
        jax_svc.stop(drain=False)
        port_svc.stop(drain=False)


def _ask(client, plies):
    """Pipeline every request, then collect: the engines coalesce them."""
    rids = [client.submit(SPEC, obs, legal=legal, seed=seed)
            for obs, legal, seed in plies]
    return [client.collect(rid, timeout=120) for rid in rids]


@pytest.mark.timeout(600)
def test_port_service_matches_jax_service(services):
    plies = _plies(12)
    jax_client = JaxServiceClient('localhost', services['jax'].port,
                                  timeout=120)
    port_client = ServiceClient('localhost', services['port'].port,
                                timeout=120)
    try:
        ref = _ask(jax_client, plies)
        got = _ask(port_client, plies)
        status = port_client.status()
    finally:
        jax_client.close()
        port_client.close()

    local = ModelWrapper.from_snapshot(
        ModelRegistry(services['port_root']).load_snapshot('geese'),
        device='cpu')
    for (obs, legal, seed), r, g in zip(plies, ref, got):
        assert g['action'] == r['action'] and g['action'] in legal
        assert abs(float(g['prob']) - float(r['prob'])) <= TOL
        np.testing.assert_allclose(g['value'], r['value'], rtol=0, atol=TOL)
        np.testing.assert_array_equal(g['action_mask'], r['action_mask'])
        # the port's reply equals its own local ply bit for bit
        mine = model_act(local, obs, None, legal, seed)
        assert g['action'] == mine['action']
        assert isinstance(g['prob'], np.float32) and g['prob'] == mine['prob']
        np.testing.assert_array_equal(g['value'], mine['value'])
        np.testing.assert_array_equal(g['action_mask'], mine['action_mask'])
    assert status['answered'] == status['received'] == len(plies)
    assert status['device'] == 'cpu'
    # the CPU path never launches a CUDA kernel; the status lists every
    # kernel of the port
    assert status['kernel_launches'] == {
        'geese_trunk': 0, 'geese_trunk_bwd': 0, 'geese_trunk_bf16': 0,
        'geese_trunk_bwd_bf16': 0, 'td_lambda': 0, 'upgo': 0, 'vtrace': 0}
    assert kernel_launches()['geese_trunk'] == 0


@pytest.mark.timeout(300)
def test_jax_client_is_served_by_the_port(services):
    """Wire compatibility: the JAX package's ServiceClient talks to the
    port's service, for inference and admin frames."""
    (obs, legal, seed), = _plies(1, seed=1)
    client = JaxServiceClient('localhost', services['port'].port, timeout=120)
    try:
        rep = client.request(SPEC, obs, legal=legal, seed=seed)
        resolved = client.resolve(SPEC)
    finally:
        client.close()
    local = ModelWrapper.from_snapshot(
        ModelRegistry(services['port_root']).load_snapshot('geese'),
        device='cpu')
    mine = model_act(local, obs, None, legal, seed)
    assert rep['action'] == mine['action']
    assert rep['prob'] == mine['prob']
    np.testing.assert_array_equal(rep['value'], mine['value'])
    assert resolved['version'] == '1'
    assert resolved['architecture'] == 'GeeseNet'


@pytest.mark.timeout(300)
def test_errors_are_answered_and_drain_refuses(services):
    (obs, legal, seed), = _plies(1, seed=2)
    svc = services['port']
    client = ServiceClient('localhost', svc.port, timeout=120)
    try:
        for spec in ('geese@99', 'nosuchline@champion', '@champion'):
            with pytest.raises(ServiceError):
                client.request(spec, obs, legal=legal, seed=seed)
        # the outputs path (no legal actions): policy and value, no sample
        out = client.request(SPEC, obs)['outputs']
        assert np.asarray(out['policy']).shape == (4,)
        svc.request_drain()
        with pytest.raises(ServiceError, match='draining'):
            client.request(SPEC, obs, legal=legal, seed=seed)
        assert svc.drained()
        status = client.status()
        assert status['draining'] is True
        assert status['answered'] == status['received']
    finally:
        client.close()
