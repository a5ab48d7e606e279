"""The port's per-host inference engine against the JAX package's, on the
CPU: the shared sampler and buckets, the snapshot vault, the engine-mode
handles, and the coalescing engine with the client that workers use.

One set of weights runs in both packages: GeeseNet at L=2, F=16 with
``torus_impl='pallas'`` (the JAX side's Pallas trunk in interpret mode,
the port's trunk kernel's plain version), GeeseNetLSTM at F=8, and
TicTacToe's SimpleConv2dModel; the port's wrappers are built from the JAX
package's snapshots. The same requests, from real plies, go to both
engines with the same legal actions and sample seeds.

Tolerances: actions and action masks equal; ``prob``, ``value`` and the
recurrent state within 1e-5 absolute (fp32 on both sides, other summation
orders in the trunk). Within the port, an engine reply equals the local
``model_act`` bit for bit, and episode records are byte-identical (pickle
bytes) on the engine path and the per-worker path. Also here: the
``inference`` block's defaults and checks against the JAX config, and a
short local cluster with the engine."""

import copy
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from handyrl_tpu.config import TRAIN_DEFAULTS as JAX_TRAIN_DEFAULTS
from handyrl_tpu.config import apply_defaults as jax_apply_defaults
from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.generation import Generator as JaxGenerator
from handyrl_tpu.generation import masked_sample as jax_masked_sample
from handyrl_tpu.generation import pad_to_bucket as jax_pad_to_bucket
from handyrl_tpu.inference import EngineClient as JaxEngineClient
from handyrl_tpu.inference import InferenceEngine as JaxInferenceEngine
from handyrl_tpu.inference import RemoteModelCache as JaxRemoteModelCache
from handyrl_tpu_torch.config import (TRAIN_DEFAULTS, ConfigError,
                                      apply_defaults)
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.generation import (Generator, bucket_rows,
                                          masked_sample, masked_sample_batch,
                                          model_act, pad_to_bucket,
                                          sample_seed)
from handyrl_tpu_torch.inference import (EngineClient, InferenceEngine,
                                         ModelVault, RemoteModel,
                                         RemoteModelCache)
from handyrl_tpu_torch.model import ModelWrapper, RandomModel
from handyrl_tpu_torch.ops.batch import decompress_moments

from torch_engine_support import (GEN_ARGS, TOL, Loopback, Sink,
                                  geese_plies, geese_wrappers,
                                  one_torch_thread, sink_reply,
                                  ttt_wrappers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    yield from one_torch_thread()


def _args(env, **inf):
    return {'inference': dict({'enabled': True}, **inf), 'env': {'env': env}}


def _engine(snapshots, env='TicTacToe', clients=1, **inf):
    """A started port engine on the CPU, its vault's example observation
    built from ``env`` on the engine thread."""
    return InferenceEngine(
        _args(env, batch_wait_ms=inf.pop('batch_wait_ms', 2.0), **inf),
        fetch_snapshot=lambda mid: snapshots[mid], reply_fn=sink_reply,
        clients=clients, device='cpu').start()


def _remote(engine, mid, env='TicTacToe', failover=False, **inf):
    """A RemoteModel over a fresh client and a loopback pipe; ``failover``
    off, so that an engine error raises (the failover tests turn it on)."""
    args = _args(env, request_timeout=30.0, request_retries=0,
                 failover=failover, **inf)
    args['worker'] = {'device': 'cpu'}
    return RemoteModel(EngineClient(Loopback(engine), args), mid)


def _collect(sink, n):
    replies = [sink.replies.get(timeout=120) for _ in range(n)]
    return {r['rid']: r for r in replies}


# -- the sampler and the buckets, shared with the JAX package -------------


def test_masked_sample_deterministic_legal_and_the_jax_draw():
    rng = np.random.RandomState(0)
    for draw in range(20):
        policy = rng.randn(9).astype(np.float32)
        legal = sorted(rng.choice(9, size=1 + draw % 8, replace=False))
        seed = sample_seed(5, (0, draw), draw)
        a = masked_sample(policy, legal, seed)
        assert a[0] in legal
        assert a[0] == masked_sample(policy, legal, seed)[0]
        want = jax_masked_sample(policy, legal, seed)
        assert a[0] == want[0] and a[1] == want[1]
        np.testing.assert_array_equal(a[2], want[2])


def test_masked_sample_batch_matches_single_rows():
    rng = np.random.RandomState(1)
    policies = rng.randn(6, 4).astype(np.float32)
    legal = [[0, 1], [2], [0, 1, 2, 3], [3, 1], [0, 2], [1, 2, 3]]
    seeds = [sample_seed(3, (0, n), n) for n in range(6)]
    actions, probs, masks = masked_sample_batch(policies, legal, seeds)
    for n in range(6):
        a, p, m = masked_sample(policies[n], legal[n], seeds[n])
        assert actions[n] == a and probs[n] == p
        np.testing.assert_array_equal(masks[n], m)


@pytest.mark.parametrize('rows', [1, 5, 8, 9, 17, 33, 64])
def test_pad_to_bucket_is_the_jax_bucket(rows):
    rng = np.random.RandomState(rows)
    rowsets = [{'a': rng.randn(3).astype(np.float32),
                'b': (rng.randn(2, 2).astype(np.float32),)}
               for _ in range(rows)]
    got, n = pad_to_bucket(rowsets)
    want, m = jax_pad_to_bucket(rowsets)
    assert n == m == rows
    assert got['a'].shape[0] == bucket_rows(rows) == max(
        8, 1 << (rows - 1).bit_length())
    np.testing.assert_array_equal(got['a'], want['a'])
    np.testing.assert_array_equal(got['b'][0], want['b'][0])


# -- the vault and the handles --------------------------------------------


def test_vault_distinct_ids_never_alias_params():
    _env, jw, pw = ttt_wrappers()
    _env, _jw2, other = ttt_wrappers(seed=8)
    snaps = {1: pw.snapshot(), 2: other.snapshot()}
    vault = ModelVault(lambda mid: snaps[mid], _env.observation(0),
                       device='cpu')
    a, b = vault.model(1), vault.model(2)
    assert a is not b and a.module is not b.module
    pa = dict(a.module.named_parameters())
    pb = dict(b.module.named_parameters())
    assert any((pa[k] != pb[k]).any() for k in pa)
    assert vault.model(1) is a and vault.fetches == 2


def test_vault_eviction_rematerializes():
    env, _jw, pw = ttt_wrappers()
    vault = ModelVault(lambda mid: pw.snapshot(), env.observation(0),
                       capacity=2, device='cpu')
    first = vault.model(1)
    vault.model(2)
    vault.model(3)                      # evicts 1
    assert vault.model(1) is not first and vault.fetches == 4


def test_vault_negative_and_none_ids_and_the_random_model():
    env, _jw, pw = ttt_wrappers()
    vault = ModelVault(lambda mid: pw.snapshot(), env.observation(0),
                       device='cpu')
    out = vault.obtain({0: None, 1: -1, 2: 0, 3: 4})
    assert out[0] is None and out[1] is None
    assert isinstance(out[2], RandomModel)
    assert isinstance(out[3], ModelWrapper)


def test_remote_model_cache_semantics():
    cache = RemoteModelCache(object(), capacity=2)
    out = cache.obtain({0: None, 1: -1, 2: 5})
    assert out[0] is None and out[1] is None
    assert isinstance(out[2], RemoteModel) and out[2].model_id == 5
    assert out[2].init_hidden() is None
    assert cache.obtain({0: 5})[0] is out[2]     # the cached handle
    cache.obtain({0: 6})
    cache.obtain({0: 7})                         # evicts 5 (capacity 2)
    assert cache.obtain({0: 5})[0] is not out[2]
    # the JAX package's cache keeps the same book
    jcache = JaxRemoteModelCache(object(), capacity=2)
    assert sorted(k for k, v in jcache.obtain({0: None, 1: -1, 2: 5})
                  .items() if v is not None) == [2]


# -- the engine -----------------------------------------------------------


@pytest.mark.timeout(120)
def test_engine_coalesces_across_clients():
    env, _jw, pw = ttt_wrappers()
    obs = env.observation(0)
    engine = _engine({1: pw.snapshot()}, clients=4, batch_wait_ms=500.0)
    try:
        models = [_remote(engine, 1) for _ in range(4)]
        rids = [m.act_send(obs, None, [0, 1, 2], sample_seed(11, (0, k), 0))
                for k, m in enumerate(models)]
        replies = [m.act_recv(r) for m, r in zip(models, rids)]
        # four clients, a quiet queue: one forward served all four
        assert engine.batches_run == 1 and engine.requests_served == 4
        assert engine.batch_fill_ratio() == 4.0
        assert engine.buckets == {8: 1}
        for rep in replies:
            assert rep['action'] in (0, 1, 2)
            assert isinstance(rep['prob'], np.float32)
            assert rep['action_mask'].shape == (9,)
    finally:
        engine.stop()


@pytest.mark.timeout(600)
def test_engine_act_replies_match_the_jax_engine():
    """Twelve Hungry Geese requests in one tick of each package's engine:
    the replies agree within the tolerance, and each port reply equals the
    port's own local ply bit for bit."""
    jw, pw = geese_wrappers()
    plies = geese_plies(12)
    reqs = [{'rid': n, 'mid': 1, 'obs': obs, 'hidden': None,
             'legal': legal, 'seed': seed}
            for n, (obs, legal, seed) in enumerate(plies)]
    port = _engine({1: pw.snapshot()}, env='HungryGeese', clients=12,
                   batch_wait_ms=2000.0)
    jax_engine = JaxInferenceEngine(
        _args('HungryGeese', batch_wait_ms=2000.0),
        fetch_snapshot=lambda mid: jw.snapshot(), reply_fn=sink_reply,
        clients=12, example_obs=plies[0][0]).start()
    try:
        mine, ref = Sink(), Sink()
        for req in reqs:
            port.submit(mine, dict(req))
            jax_engine.submit(ref, dict(req))
        got, want = _collect(mine, 12), _collect(ref, 12)
    finally:
        port.stop()
        jax_engine.stop()
    assert port.batches_run == 1 and port.buckets == {16: 1}
    for n, (obs, legal, seed) in enumerate(plies):
        g, r = got[n], want[n]
        assert g['action'] == r['action'] and g['action'] in legal
        np.testing.assert_array_equal(g['action_mask'], r['action_mask'])
        assert abs(float(g['prob']) - float(r['prob'])) <= TOL
        np.testing.assert_allclose(g['value'], r['value'], rtol=0, atol=TOL)
        local = model_act(pw, obs, None, legal, seed)
        assert g['action'] == local['action'] and g['prob'] == local['prob']
        np.testing.assert_array_equal(g['value'], local['value'])
        np.testing.assert_array_equal(g['action_mask'], local['action_mask'])


@pytest.mark.timeout(600)
def test_engine_full_output_replies_match_the_jax_engine():
    """Requests without legal actions (observer plies, evaluation agents)
    get the forward's outputs."""
    jw, pw = geese_wrappers()
    plies = geese_plies(6, seed=2)
    port = _engine({1: pw.snapshot()}, env='HungryGeese', clients=6,
                   batch_wait_ms=2000.0)
    jax_engine = JaxInferenceEngine(
        _args('HungryGeese', batch_wait_ms=2000.0),
        fetch_snapshot=lambda mid: jw.snapshot(), reply_fn=sink_reply,
        clients=6, example_obs=plies[0][0]).start()
    try:
        mine, ref = Sink(), Sink()
        for n, (obs, _legal, _seed) in enumerate(plies):
            port.submit(mine, {'rid': n, 'mid': 1, 'obs': obs})
            jax_engine.submit(ref, {'rid': n, 'mid': 1, 'obs': obs})
        got, want = _collect(mine, 6), _collect(ref, 6)
    finally:
        port.stop()
        jax_engine.stop()
    for n in range(6):
        g, r = got[n]['outputs'], want[n]['outputs']
        assert sorted(g) == sorted(r) == ['policy', 'value']
        for k in ('policy', 'value'):
            np.testing.assert_allclose(g[k], np.asarray(r[k]), rtol=0,
                                       atol=TOL, err_msg=k)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


@pytest.mark.timeout(600)
def test_engine_recurrent_hidden_round_trip_matches_the_jax_engine():
    """A None hidden is a fresh initial state on the engine's side, and the
    next state each reply carries, sent back on the next ply, gives the
    JAX engine's trajectory (and the port's local one bit for bit)."""
    jw, pw = geese_wrappers(lstm=True)
    plies = [p for p in geese_plies(24, seed=4)][::4][:5]   # goose 0
    port = _engine({1: pw.snapshot()}, env='HungryGeese')
    jax_engine = JaxInferenceEngine(
        _args('HungryGeese'), fetch_snapshot=lambda mid: jw.snapshot(),
        reply_fn=sink_reply, clients=1, example_obs=plies[0][0]).start()
    try:
        h_port = h_jax = None
        h_local = pw.init_hidden()
        for n, (obs, legal, seed) in enumerate(plies):
            mine, ref = Sink(), Sink()
            req = {'rid': n, 'mid': 1, 'obs': obs, 'legal': legal,
                   'seed': seed}
            port.submit(mine, dict(req, hidden=h_port))
            jax_engine.submit(ref, dict(req, hidden=h_jax))
            g = mine.replies.get(timeout=120)
            r = ref.replies.get(timeout=120)
            assert g['action'] == r['action']
            for a, b in zip(_leaves(g['hidden']), _leaves(r['hidden'])):
                np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
            local = model_act(pw, obs, h_local, legal, seed)
            assert g['action'] == local['action']
            for a, b in zip(_leaves(g['hidden']), _leaves(local['hidden'])):
                np.testing.assert_array_equal(a, b)
            h_port, h_jax, h_local = g['hidden'], r['hidden'], local['hidden']
        assert any(np.any(a != 0) for a in _leaves(h_port))
    finally:
        port.stop()
        jax_engine.stop()


@pytest.mark.timeout(120)
def test_engine_error_reply_does_not_kill_the_engine():
    env, _jw, pw = ttt_wrappers()
    obs = env.observation(0)

    def fetch(mid):
        if mid == 99:
            raise ConnectionError('no such snapshot')
        return pw.snapshot()

    engine = InferenceEngine(_args('TicTacToe', batch_wait_ms=1.0),
                             fetch_snapshot=fetch, reply_fn=sink_reply,
                             example_obs=obs, clients=1, device='cpu').start()
    try:
        with pytest.raises(RuntimeError, match='no such snapshot'):
            _remote(engine, 99).act(obs, None, [0], sample_seed(0, (0, 0), 0))
        rep = _remote(engine, 1).act(obs, None, [0, 1],
                                     sample_seed(0, (0, 1), 0))
        assert rep['action'] in (0, 1)     # the engine lives on
    finally:
        engine.stop()


@pytest.mark.timeout(120)
def test_engine_serves_id_zero_as_uniform_play():
    env, _jw, pw = ttt_wrappers()
    obs = env.observation(0)
    engine = _engine({0: pw.snapshot()})
    try:
        legal = [2, 5, 7]
        rep = _remote(engine, 0).act(obs, None, legal,
                                     sample_seed(1, (0, 0), 0))
        assert rep['action'] in legal
        assert abs(float(rep['prob']) - 1 / 3) < 1e-6
        assert engine.buckets == {}          # no forward for id 0
    finally:
        engine.stop()


# -- episode records: the engine path and the per-worker path -------------


def _ttt_episodes(models, namespace, keys):
    gen = Generator(make_env({'env': 'TicTacToe'}), GEN_ARGS,
                    namespace=namespace)
    task = {'role': 'g', 'player': [0, 1], 'model_id': {0: 1, 1: 1}}
    return [gen.generate(models, dict(task, sample_key=k)) for k in keys]


@pytest.mark.timeout(300)
def test_episode_records_byte_identical_across_paths():
    _env, _jw, pw = ttt_wrappers()
    snap = pw.snapshot()
    local = ModelWrapper.from_snapshot(snap, device='cpu')
    episodes_local = _ttt_episodes({0: local, 1: local}, 0, range(4))
    engine = _engine({1: snap})
    try:
        remote = _remote(engine, 1)
        # the namespace keys only tasks without a sample_key
        episodes_engine = _ttt_episodes({0: remote, 1: remote}, 3, range(4))
    finally:
        engine.stop()
    for a, b in zip(episodes_local, episodes_engine):
        assert a is not None and b is not None
        assert pickle.dumps(a) == pickle.dumps(b)


@pytest.mark.timeout(300)
def test_episode_records_reproducible_across_workers():
    """The same sample_key gives the same episode whichever worker (its
    namespace, its local draws so far) plays it: the ledger's re-issue."""
    _env, _jw, pw = ttt_wrappers()
    snap = pw.snapshot()

    def run(namespace, warmup):
        model = ModelWrapper.from_snapshot(snap, device='cpu')
        gen = Generator(make_env({'env': 'TicTacToe'}), GEN_ARGS,
                        namespace=namespace)
        task = {'role': 'g', 'player': [0, 1], 'model_id': {0: 1, 1: 1}}
        for _ in range(warmup):
            gen.generate({0: model, 1: model}, dict(task))
        return gen.generate({0: model, 1: model}, dict(task, sample_key=17))

    assert pickle.dumps(run(0, 0)) == pickle.dumps(run(4, 3))


class _CountingModel:
    """An engine handle that records the order of its sends and receives."""

    def __init__(self, inner, log):
        self.inner, self.log = inner, log

    def init_hidden(self):
        return None

    def inference(self, obs, hidden=None):
        return self.inner.inference(obs, hidden)

    def act_send(self, *a):
        self.log.append('send')
        return self.inner.act_send(*a)

    def act_recv(self, rid):
        self.log.append('recv')
        return self.inner.act_recv(rid)


@pytest.mark.timeout(600)
def test_submit_then_collect_generator_matches_the_jax_generator():
    """Hungry Geese through each package's Generator on its own engine: a
    ply's four acting seats are all submitted before any reply is read (so
    one worker's turn lands in one tick), and the episodes agree with the
    JAX Generator's move for move (prob and value within the tolerance)."""
    jw, pw = geese_wrappers()
    args = dict(GEN_ARGS, observation=True)
    task = {'role': 'g', 'player': [0, 1, 2, 3],
            'model_id': {p: 1 for p in range(4)}, 'sample_key': 3}
    # one client: a tick closes once the queue is quiet (the four sends
    # come back to back), and a ply with fewer geese alive does not wait
    # out the deadline
    port = _engine({1: pw.snapshot()}, env='HungryGeese', clients=1,
                   batch_wait_ms=20.0)
    jax_engine = JaxInferenceEngine(
        _args('HungryGeese', batch_wait_ms=20.0),
        fetch_snapshot=lambda mid: jw.snapshot(), reply_fn=sink_reply,
        clients=1, example_obs=geese_plies(1)[0][0]).start()
    try:
        log = []
        remote = _remote(port, 1, env='HungryGeese')
        models = {p: _CountingModel(remote, log) for p in range(4)}
        mine = Generator(make_env({'env': 'HungryGeese'}), args).generate(
            models, dict(task))
        jargs = _args('HungryGeese', request_timeout=60.0,
                      request_retries=0, failover=False)
        jremote = JaxRemoteModelCache(JaxEngineClient(
            Loopback(jax_engine), jargs)).obtain({0: 1})[0]
        ref = JaxGenerator(jax_make_env({'env': 'HungryGeese'}),
                           args).generate({p: jremote for p in range(4)},
                                          dict(task))
    finally:
        port.stop()
        jax_engine.stop()
    # the first ply: four sends, then four receives, in one engine tick
    assert log[:8] == ['send'] * 4 + ['recv'] * 4
    assert port.buckets.get(8, 0) >= 1 and port.batch_fill_ratio() > 1.0
    assert mine['steps'] == ref['steps'] and mine['outcome'] == ref['outcome']
    for m, r in zip(decompress_moments(mine['moment']),
                    decompress_moments(ref['moment'])):
        assert m['action'] == r['action'] and m['turn'] == r['turn']
        for p, prob in m['selected_prob'].items():
            if prob is not None:
                assert abs(float(prob) - float(r['selected_prob'][p])) <= TOL
                np.testing.assert_array_equal(m['action_mask'][p],
                                              r['action_mask'][p])
        for p, v in m['value'].items():
            if v is not None:
                np.testing.assert_allclose(v, r['value'][p], rtol=0,
                                           atol=TOL)


# -- the config ------------------------------------------------------------


def test_inference_block_defaults_are_the_jax_packages():
    assert TRAIN_DEFAULTS['inference'] == JAX_TRAIN_DEFAULTS['inference']
    assert list(TRAIN_DEFAULTS['inference']) == list(
        JAX_TRAIN_DEFAULTS['inference'])
    for key, value in JAX_TRAIN_DEFAULTS['inference'].items():
        assert type(TRAIN_DEFAULTS['inference'][key]) is type(value)
    assert TRAIN_DEFAULTS['serving']['endpoint'] == \
        JAX_TRAIN_DEFAULTS['serving']['endpoint'] == ''


@pytest.mark.parametrize('train_args,key', [
    ({'inference': {'engine_backend': 'gpu'}}, 'engine_backend'),
    ({'inference': {'batch_wait_ms': -1.0}}, 'batch_wait_ms'),
    ({'inference': {'max_batch': 0}}, 'max_batch'),
    ({'inference': {'vault_size': 0}}, 'vault_size'),
    ({'inference': {'queue_max': -1}}, 'queue_max'),
    ({'inference': {'request_retries': -1}}, 'request_retries'),
    ({'inference': {'stall_timeout': 0}}, 'stall_timeout'),
    ({'inference': {'restart_max_delay': 0}}, 'restart_max_delay'),
    ({'inference': {'request_timeout': -2.0}}, 'request_timeout'),
    ({'inference': {'reprobe_initial_delay': 0}}, 'reprobe_initial_delay'),
    ({'inference': {'reprobe_max_delay': 0}}, 'reprobe_max_delay'),
    ({'serving': {'endpoint': 'localhost'}}, 'serving.endpoint'),
    ({'serving': {'endpoint': 'a:1,b:70000'}}, 'serving.endpoint'),
])
def test_inference_checks_raise_where_the_jax_config_asserts(train_args,
                                                             key):
    raw = {'env_args': {'env': 'HungryGeese'}, 'train_args': train_args}
    with pytest.raises(AssertionError, match=key):
        jax_apply_defaults(copy.deepcopy(raw))
    with pytest.raises(ConfigError, match=key):
        apply_defaults(raw)


@pytest.mark.parametrize('train_args,worker_args', [
    ({'batched_generation': False, 'inference': {'enabled': True}}, {}),
    ({'batched_generation': False, 'generation': {'backend': 'engine'}}, {}),
    ({'inference': {'enabled': True},
      'serving': {'endpoint': 'localhost:9997, 10.0.0.2:9997'}}, {}),
    ({}, {'server_address': '127.0.0.1', 'backend': 'engine'}),
    ({'inference': {'enabled': True, 'engine_backend': 'device'}}, {}),
])
def test_the_engine_configs_validate_in_both_packages(train_args,
                                                      worker_args):
    raw = {'env_args': {'env': 'HungryGeese', 'torus_impl': 'pallas'},
           'train_args': train_args, 'worker_args': worker_args}
    jax_apply_defaults(copy.deepcopy(raw))
    apply_defaults(raw)


def test_engine_backend_does_not_move_the_ports_engine():
    """The deliberate difference: 'cpu' (the JAX default, which pins the
    JAX engine to host cores) and 'device' both pass the check, and a
    gather's engine runs on ``worker.device`` either way: the JAX default
    never puts the port's engine on the host, and without a card a
    'cuda' gather raises instead."""
    import torch
    from handyrl_tpu_torch.worker import Gather
    for backend in ('cpu', 'device'):
        args = apply_defaults({'env_args': {'env': 'HungryGeese'},
                               'train_args': {'inference': {
                                   'enabled': True,
                                   'engine_backend': backend}}})
        assert args['train_args']['inference']['engine_backend'] == backend
    assert TRAIN_DEFAULTS['inference']['engine_backend'] == 'cpu'

    def gather(device, backend):
        args = {'env': {'env': 'TicTacToe'},
                'inference': dict(TRAIN_DEFAULTS['inference'], enabled=True,
                                  engine_backend=backend),
                'worker': {'num_parallel': 0, 'num_gathers': 1,
                           'device': device}}
        return Gather(args, object(), 0)

    for backend in ('cpu', 'device'):
        g = gather('cpu', backend)
        try:
            assert g.engine.device == torch.device('cpu')
        finally:
            g.engine.stop()
            g.hub.close()
    if torch.cuda.is_available():
        g = gather('cuda', 'cpu')
        try:
            assert g.engine.device.type == 'cuda'
        finally:
            g.engine.stop()
            g.hub.close()
    else:
        with pytest.raises(RuntimeError, match='CUDA'):
            gather('cuda', 'cpu')


# -- a short local cluster with the engine ----------------------------------


@pytest.mark.timeout(300)
def test_local_cluster_with_the_engine_on_tictactoe(tmp_path):
    """The learner's CLI with ``batched_generation: false`` and the
    inference block on: the gather's engine serves every worker's plies
    (coalesced), the workers hold no params and fail over never."""
    cfg = {'env_args': {'env': 'TicTacToe'},
           'train_args': {'batch_size': 16, 'forward_steps': 8,
                          'num_batchers': 1, 'minimum_episodes': 30,
                          'update_episodes': 20, 'epochs': 2,
                          'batched_generation': False,
                          'worker': {'num_parallel': 2},
                          'inference': {'enabled': True},
                          'model_dir': str(tmp_path / 'models')}}
    path = tmp_path / 'cfg.json'
    path.write_text(json.dumps(cfg))
    proc = subprocess.run(
        [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config',
         str(path), '--device', 'cpu'], cwd=REPO, capture_output=True,
        text=True, timeout=240, env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads([x for x in proc.stdout.splitlines()
                       if x.startswith('{')][-1])
    assert line['epochs'] == 2 and line['fleet']['outstanding'] == 0
    [engine] = line['engines']
    assert engine['requests'] > engine['batches'] > 0
    assert engine['restarts'] == 0 and engine['device'] == 'cpu'
    assert engine['fill_ratio'] > 1.0 and engine['buckets']
    clients = line['engine_clients']
    assert clients['failovers'] == clients['local_inferences'] == 0
    assert line['worker_processes'] == 2
    assert line['repeated_sample_keys'] == 0
    assert (tmp_path / 'models' / '2.ckpt').exists()
