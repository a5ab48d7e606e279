"""Snapshots that both packages read, on the CPU.

A snapshot is (architecture, non-default config, param bytes). The JAX
package writes the params with ``flax.serialization.to_bytes``; the port
writes the same bytes with its own msgpack writer
(``handyrl_tpu_torch/utils/flax_msgpack.py``) and also reads its older
snapshots, whose arrays used the wire codec's ext layout. Each package
loads the other's snapshot and the two forwards agree on real Hungry Geese
boards, at L=2, F=16 (``torus_impl='pallas'``: the JAX side runs its Pallas
trunk in interpret mode, the port its trunk's plain version) and at full
width, F=32, L=12 (``'pad'``), on one board. One registry, filled by the
JAX package, serves the same replies through either package's service.

Tolerance: policy and value within 1e-4 absolute (fp32 on both sides,
the trunk's sums in other orders: about 1e-5 is seen); sampled actions
equal; the snapshot bytes equal flax's exactly."""

import os
import torch
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

from handyrl_tpu.config import apply_defaults
from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
from handyrl_tpu.models.geese import GeeseNet as JaxGeeseNet
from handyrl_tpu.serving.client import ServiceClient as JaxServiceClient
from handyrl_tpu.serving.registry import ModelRegistry as JaxModelRegistry
from handyrl_tpu.serving.service import InferenceService as JaxService
from handyrl_tpu_torch.config import serving_args
from handyrl_tpu_torch.connection import pack
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.generation import sample_seed
from handyrl_tpu_torch.model import ModelWrapper
from handyrl_tpu_torch.models.geese import params_to_flax
from handyrl_tpu_torch.serving.client import ServiceClient
from handyrl_tpu_torch.serving.service import InferenceService
from handyrl_tpu_torch.utils import flax_msgpack


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


TOL = 1e-4
NETS = {'narrow': (dict(layers=2, filters=16, torus_impl='pallas'), 4),
        'full': (dict(layers=12, filters=32, torus_impl='pad'), 1)}
OPPOSITE = {0: 1, 1: 0, 2: 3, 3: 2}


def _plies(count, seed):
    """(obs, legal, sample seed) of ``count`` requests from a seeded random
    game: four geese a ply, the reversal left out of ``legal``."""
    env = make_env({'env': 'HungryGeese', 'id': seed})
    rng = np.random.default_rng(seed)
    last, out, ply = {}, [], 0
    while len(out) < count:
        if env.terminal():
            env.reset()
            last = {}
        actions = {}
        for p in env.turns():
            legal = [a for a in range(4) if a != OPPOSITE.get(last.get(p))]
            out.append((env.observation(p), legal,
                        sample_seed(seed, (7, p), ply)))
            actions[p] = int(rng.choice(legal))
        env.step(actions)
        last.update(actions)
        ply += 1
    return out[:count]


def _jax_wrapper(net, obs, seed=3, **extra):
    module = JaxGeeseNet(**net, **extra)
    params = module.init(jax.random.PRNGKey(seed), jnp.asarray(obs)[None])
    return JaxModelWrapper(module, params)


def _outputs(wrapper, boards):
    outs = [wrapper.inference(obs) for obs in boards]
    return {k: np.stack([np.asarray(o[k]) for o in outs])
            for k in ('policy', 'value')}


def _assert_close(got, ref):
    for k in ('policy', 'value'):
        assert got[k].shape == ref[k].shape
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=TOL)


@pytest.fixture(scope='module', params=sorted(NETS))
def case(request):
    net, count = NETS[request.param]
    boards = [obs for obs, _, _ in _plies(count, seed=5)]
    jax_wrapper = _jax_wrapper(net, boards[0])
    return {'net': net, 'boards': boards, 'jax': jax_wrapper,
            'snap': jax_wrapper.snapshot(),
            'ref': _outputs(jax_wrapper, boards)}


def test_jax_snapshot_loads_in_the_port(case):
    port = ModelWrapper.from_snapshot(case['snap'], device='cpu')
    _assert_close(_outputs(port, case['boards']), case['ref'])


def test_port_snapshot_loads_in_jax(case):
    port = ModelWrapper.from_snapshot(case['snap'], device='cpu')
    snap = port.snapshot()
    assert snap['architecture'] == 'GeeseNet'
    assert snap.get('config') == case['snap'].get('config')
    back = JaxModelWrapper.from_snapshot(snap, case['boards'][0])
    _assert_close(_outputs(back, case['boards']),
                  _outputs(port, case['boards']))
    _assert_close(_outputs(back, case['boards']), case['ref'])


def test_port_snapshot_bytes_are_flax_bytes(case):
    port = ModelWrapper.from_snapshot(case['snap'], device='cpu')
    assert port.snapshot()['params'] == case['snap']['params']


def test_older_port_snapshots_still_load(case):
    """The port's snapshots before flax's layout: the wire codec's ext 1."""
    port = ModelWrapper.from_snapshot(case['snap'], device='cpu')
    old = dict(port.snapshot(), params=pack(params_to_flax(port.module)))
    assert old['params'] != case['snap']['params']
    again = ModelWrapper.from_snapshot(old, device='cpu')
    got, want = _outputs(again, case['boards']), _outputs(port,
                                                          case['boards'])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_foreign_config_keys_are_dropped_and_unknown_ones_raise():
    net, _ = NETS['narrow']
    boards = [obs for obs, _, _ in _plies(2, seed=6)]
    jax_wrapper = _jax_wrapper(net, boards[0], pallas_tile=32)
    snap = jax_wrapper.snapshot()
    assert snap['config']['pallas_tile'] == 32
    port = ModelWrapper.from_snapshot(snap, device='cpu')
    _assert_close(_outputs(port, boards), _outputs(jax_wrapper, boards))
    with pytest.raises(ValueError, match='tile_rows'):
        ModelWrapper.from_snapshot(
            dict(snap, config=dict(snap['config'], tile_rows=8)),
            device='cpu')


@pytest.mark.parametrize('tree', [
    {'params': {'w': np.arange(6, dtype=np.float32).reshape(2, 3),
                'b': np.zeros((), np.float32)}},
    {'a': np.float32(1.5), 'b': {'c': np.arange(300, dtype=np.int64)},
     'n': 3, 'x': 2.5, 's': 'str', 'big': np.ones(70000, np.float32)},
])
def test_flax_msgpack_matches_flax(tree):
    raw = serialization.to_bytes(tree)
    assert flax_msgpack.to_bytes(tree) == raw
    back = flax_msgpack.from_bytes(raw)

    def check(a, b):
        if isinstance(b, dict):
            assert list(a) == list(b)
            for k in b:
                check(a[k], b[k])
        else:
            assert type(a) is type(b) or isinstance(b, np.ndarray)
            np.testing.assert_array_equal(a, b)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and a.flags.owndata
    check(back, tree)


def test_chunked_arrays_are_refused_by_name():
    raw = flax_msgpack.to_bytes({'w': {'__msgpack_chunked_array__': True,
                                       'shape': {'0': 2}}})
    with pytest.raises(ValueError, match='__msgpack_chunked_array__'):
        flax_msgpack.from_bytes(raw)


@pytest.mark.timeout(600)
def test_one_jax_registry_serves_both_services(tmp_path):
    """The JAX package publishes; each package's service answers the same
    INFER requests from that registry."""
    net, _ = NETS['narrow']
    plies = _plies(8, seed=7)
    wrapper = _jax_wrapper(net, plies[0][0])
    root = str(tmp_path / 'registry')
    JaxModelRegistry(root).publish('geese', snapshot=wrapper.snapshot(),
                                   version=1, promote=True)
    jax_args = apply_defaults({
        'env_args': {'env': 'HungryGeese'},
        'train_args': {'serving': {'port': 0, 'registry_dir': root}},
    })['train_args']
    jax_args['env'] = {'env': 'HungryGeese'}
    port_args = serving_args({'env': 'HungryGeese'}, {},
                             {'port': 0, 'registry_dir': root})
    jax_svc = JaxService(jax_args).start()
    port_svc = InferenceService(port_args, device='cpu').start()
    clients = [JaxServiceClient('localhost', jax_svc.port, timeout=120),
               ServiceClient('localhost', port_svc.port, timeout=120)]
    try:
        replies = []
        for client in clients:
            rids = [client.submit('geese@champion', obs, legal=legal,
                                  seed=seed) for obs, legal, seed in plies]
            replies.append([client.collect(rid, timeout=120)
                            for rid in rids])
        status = clients[1].status()
    finally:
        for client in clients:
            client.close()
        jax_svc.stop(drain=False)
        port_svc.stop(drain=False)
    for (obs, legal, _), ref, got in zip(plies, *replies):
        assert got['action'] == ref['action'] and got['action'] in legal
        assert abs(float(got['prob']) - float(ref['prob'])) <= TOL
        np.testing.assert_allclose(got['value'], ref['value'], rtol=0,
                                   atol=TOL)
    assert status['answered'] == status['received'] == len(plies)
