"""The port's self-healing inference tier against the JAX package's rules,
on the CPU: the engine's bounded queue and stop leak, the supervisor's
crash and stall restarts with their error fan-out, a zombie's late reply
dropped, fail-fast while restarting; the worker's client with deadlines,
the failover to its own forward (bit for bit), the re-probe and
re-promotion, ``failover: false``, the remote-service mode against the
port's InferenceService on localhost (a dead replica rotated past, all of
them dead degrading locally); episode records byte-identical (pickle
bytes) across an engine killed mid-episode; a worker in engine mode; and
the learner's soft faults from the fleet's beacons, fed to its
FleetController as the JAX learner feeds its own.

TicTacToe's SimpleConv2dModel and GeeseNet (L=2, F=16, 'pallas') run on
the CPU with weights from the JAX package's snapshots; a degraded reply
is compared with the engine's and the local ply's bit for bit."""

import pickle
import socket
import time

import numpy as np
import pytest

from handyrl_tpu.fault import FleetController as JaxFleetController
from handyrl_tpu.fault import parse_chaos as jax_parse_chaos
from handyrl_tpu_torch import telemetry
from handyrl_tpu_torch.config import TRAIN_DEFAULTS, serving_args
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.fault import (HOST_DEGRADED, HOST_HEALTHY,
                                     FleetController, parse_chaos)
from handyrl_tpu_torch.generation import Generator, model_act, sample_seed
from handyrl_tpu_torch.inference import (EngineClient, EngineSupervisor,
                                         InferenceEngine, RemoteModel,
                                         RemoteModelCache)
from handyrl_tpu_torch.model import ModelWrapper
from handyrl_tpu_torch.serving.registry import ModelRegistry
from handyrl_tpu_torch.serving.service import InferenceService
from handyrl_tpu_torch.train import record_soft_faults

from torch_engine_support import (GEN_ARGS, Loopback, Sink, act_request,
                                  blackbox_in, geese_plies, geese_wrappers,
                                  one_torch_thread, sink_reply, ttt_wrappers,
                                  wait_for)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(autouse=True, scope='module')
def _blackbox_in_tmp(tmp_path_factory):
    yield from blackbox_in(tmp_path_factory.mktemp('blackbox'))


def _counter(name, **labels):
    return telemetry.counter(name, **labels).value


def _args(env='TicTacToe', **inf):
    return {'inference': dict({'enabled': True, 'batch_wait_ms': 1.0}, **inf),
            'env': {'env': env}, 'worker': {'device': 'cpu'}}


def test_parse_chaos_engine_knobs_as_the_jax_package():
    spec = ('enginekill=4,enginestall=6,enginestall_secs=600,'
            'engine_max_faults=2')
    assert parse_chaos(spec) == jax_parse_chaos(spec) == {
        'enginekill': 4.0, 'enginestall': 6.0, 'enginestall_secs': 600.0,
        'engine_max_faults': 2.0}


# -- the engine's hardening ----------------------------------------------


def test_engine_bounded_queue_sheds_with_an_error_reply():
    env, _jw, pw = ttt_wrappers()
    obs = env.observation(0)
    engine = InferenceEngine(_args(queue_max=2),
                             fetch_snapshot=lambda mid: pw.snapshot(),
                             reply_fn=sink_reply, device='cpu')
    # not started: the queue cannot drain, so the bound is exact
    shed_before = _counter('engine_shed_total')
    ep = Sink()
    for rid in range(3):
        engine.submit(ep, act_request(rid, obs))
    assert len(engine._queue) == 2 and engine.busy()
    reply = ep.replies.get(timeout=5)
    assert reply['rid'] == 2 and reply['engine_fault']
    assert 'shed' in reply['error'] and engine.sheds == 1
    assert _counter('engine_shed_total') == shed_before + 1
    assert len(engine.drain_pending()) == 2 and not engine.busy()


def _supervisor(pw, chaos, stall_timeout=0.5, **inf):
    return EngineSupervisor(
        _args(stall_timeout=stall_timeout, restart_max_delay=1.0, **inf),
        fetch_snapshot=lambda mid: pw.snapshot(), reply_fn=sink_reply,
        clients=1, chaos=chaos, device='cpu')


@pytest.mark.timeout(120)
def test_supervisor_restarts_a_crashed_engine_with_the_error_fanout():
    env, _jw, pw = ttt_wrappers()
    obs = env.observation(0)
    before = _counter('engine_restarts_total', reason='crash')
    sup = _supervisor(pw, chaos={'enginekill': 1e-4, 'engine_max_faults': 1})
    try:
        ep = Sink()
        sup.submit(ep, act_request(1, obs))
        # the kill fires on the first tick: the request in flight is
        # error-answered by the crash fan-out, not dropped
        reply = ep.replies.get(timeout=10)
        assert reply['rid'] == 1 and 'crashed' in reply['error']
        assert wait_for(lambda: (sup.restarts >= 1 and sup.engine is not None
                                 and sup.engine.thread_alive()), 15)
        assert sup.restarts == 1
        assert sup.restarts_by_reason == {'crash': 1, 'stall': 0}
        assert _counter('engine_restarts_total', reason='crash') == before + 1
        sup.submit(ep, act_request(2, obs))   # the new engine serves
        reply = ep.replies.get(timeout=10)
        assert reply['rid'] == 2 and reply['action'] in (0, 1, 2)
        stats = sup.stats()
        # the killed tick served nothing: one request, one forward in all
        assert stats['restarts'] == 1 and stats['requests'] == 1
        assert stats['batches'] == 1 and stats['buckets'] == {'8': 1}
    finally:
        sup.stop()


@pytest.mark.timeout(120)
def test_supervisor_detects_a_stall_and_drops_the_zombies_reply():
    """The engine wedges holding a request; the watchdog declares the
    stall, error-answers what the zombie holds and restarts. When the
    zombie wakes and serves what it held, the generation tag drops that
    reply: the request is answered once."""
    env, _jw, pw = ttt_wrappers()
    obs = env.observation(0)
    before = _counter('engine_restarts_total', reason='stall')
    sup = _supervisor(pw, chaos={'enginestall': 1e-4, 'engine_max_faults': 1,
                                 'enginestall_secs': 2.0})
    try:
        ep = Sink()
        sup.submit(ep, act_request(1, obs))
        reply = ep.replies.get(timeout=15)
        assert reply['rid'] == 1 and 'stall' in reply['error']
        assert wait_for(lambda: sup.engine is not None
                        and sup.engine.thread_alive(), 15)
        assert _counter('engine_restarts_total', reason='stall') == before + 1
        assert sup.restarts_by_reason['stall'] == 1
        sup.submit(ep, act_request(2, obs))
        reply = ep.replies.get(timeout=10)
        assert reply['rid'] == 2 and reply['action'] in (0, 1, 2)
        assert wait_for(lambda: sup.stale_replies >= 1, 10)
        time.sleep(0.2)
        assert ep.replies.empty()             # rid 1 was answered once
    finally:
        sup.stop()


@pytest.mark.timeout(120)
def test_supervisor_fails_fast_while_restarting():
    env, _jw, pw = ttt_wrappers()
    obs = env.observation(0)
    sup = _supervisor(pw, chaos={'enginekill': 1e-4, 'engine_max_faults': 1})
    try:
        ep = Sink()
        sup.submit(ep, act_request(1, obs))
        assert 'crashed' in ep.replies.get(timeout=10)['error']
        # the backoff window (0.25-0.5 s): no engine, an answer at once
        assert wait_for(lambda: sup.engine is None, 10, poll=0.002)
        t0 = time.monotonic()
        sup.submit(ep, act_request(2, obs))
        reply = ep.replies.get(timeout=1)
        assert time.monotonic() - t0 < 0.2
        assert reply['rid'] == 2 and 'restarting' in reply['error']
        assert reply['engine_fault']
    finally:
        sup.stop()


@pytest.mark.timeout(60)
def test_engine_stop_leak_is_visible():
    """stop() on a wedged engine cannot join its thread: a counted,
    logged leak, not a silent return."""
    env, _jw, pw = ttt_wrappers()
    obs = env.observation(0)
    engine = InferenceEngine(_args(), fetch_snapshot=lambda mid: pw.snapshot(),
                             reply_fn=sink_reply, device='cpu')
    engine.arm_fault('stall', 0.0, stall_secs=30)
    engine.start()
    engine.submit(Sink(), act_request(1, obs))
    assert wait_for(lambda: engine.busy() and engine.progress_age() > 0.3, 10)
    before = _counter('engine_stop_leaked_total')
    engine.stop(timeout=0.3)
    assert engine.thread_alive()
    assert _counter('engine_stop_leaked_total') == before + 1


# -- the worker's client -------------------------------------------------


def _engine_and_pipe(snap, **inf):
    args = _args(**inf)
    engine = InferenceEngine(args, fetch_snapshot=lambda mid: snap,
                             reply_fn=sink_reply, clients=1,
                             device='cpu').start()
    pipe = Loopback(engine, {1: snap})
    return engine, pipe, EngineClient(pipe, args)


@pytest.mark.timeout(120)
def test_client_deadline_failover_is_bitwise_identical():
    env, _jw, pw = ttt_wrappers()
    obs = env.observation(0)
    snap = pw.snapshot()
    engine, pipe, client = _engine_and_pipe(
        snap, request_timeout=0.2, request_retries=1,
        reprobe_initial_delay=30.0)
    try:
        remote = RemoteModel(client, 1)
        legal = env.legal_actions(0)
        seed = sample_seed(11, (0, 3), 0)
        healthy = remote.act(obs, None, legal, seed)
        assert client.engine_ok
        pipe.drop_infer = True          # the engine's replies never come
        timeouts = client.stats['timeouts']
        t0 = time.monotonic()
        degraded = remote.act(obs, None, legal, seed)
        assert time.monotonic() - t0 >= 0.4   # a deadline and one resend
        assert not client.engine_ok and pipe.model_fetches == 1
        assert client.stats['timeouts'] == timeouts + 2
        assert client.stats['failovers'] == 1
        local = model_act(ModelWrapper.from_snapshot(snap, device='cpu'),
                          obs, None, legal, seed)
        for res in (healthy, degraded):
            assert res['action'] == local['action']
            assert res['prob'] == local['prob']
            np.testing.assert_array_equal(res['action_mask'],
                                          local['action_mask'])
            np.testing.assert_array_equal(res['value'], local['value'])
        t0 = time.monotonic()           # degraded: served here, at once
        remote.act(obs, None, legal, sample_seed(11, (0, 3), 1))
        assert time.monotonic() - t0 < 0.2
        assert client.stats['local_inferences'] == 2
    finally:
        engine.stop()


@pytest.mark.timeout(120)
def test_client_reprobes_and_repromotes():
    env, _jw, pw = ttt_wrappers()
    obs = env.observation(0)
    engine, pipe, client = _engine_and_pipe(
        pw.snapshot(), request_timeout=0.2, request_retries=0,
        reprobe_initial_delay=0.2, reprobe_max_delay=0.5)
    try:
        remote = RemoteModel(client, 1)
        legal = env.legal_actions(0)
        pipe.drop_infer = True
        remote.act(obs, None, legal, sample_seed(11, (0, 1), 0))
        assert not client.engine_ok
        time.sleep(0.3)                 # the probe goes out and fails
        remote.act(obs, None, legal, sample_seed(11, (0, 1), 1))
        assert not client.engine_ok
        pipe.drop_infer = False         # the engine heals
        assert wait_for(lambda: (remote.act(obs, None, legal,
                                            sample_seed(11, (0, 1), 2))
                                 or True) and client.engine_ok, 10, poll=0.2)
        assert client.stats['failovers'] == 1
        assert client.stats['repromotions'] == 1
    finally:
        engine.stop()


@pytest.mark.timeout(60)
def test_client_without_failover_raises():
    env, _jw, pw = ttt_wrappers()
    obs = env.observation(0)
    engine, pipe, client = _engine_and_pipe(
        pw.snapshot(), request_timeout=0.1, request_retries=0,
        failover=False)
    try:
        pipe.drop_infer = True
        with pytest.raises(RuntimeError, match='inference engine'):
            RemoteModel(client, 1).act(obs, None, [0, 1],
                                       sample_seed(1, (0, 0), 0))
        assert client.stats['local_inferences'] == 0
        assert pipe.model_fetches == 0
    finally:
        engine.stop()


@pytest.mark.timeout(60)
def test_client_rpc_absorbs_a_late_engine_reply():
    """After a failover the engine's late answer arrives in front of the
    next RPC's reply: it is counted stale, never taken for the reply."""
    env, _jw, pw = ttt_wrappers()
    obs = env.observation(0)
    snap = pw.snapshot()
    engine, pipe, client = _engine_and_pipe(
        snap, request_timeout=0.2, request_retries=0,
        reprobe_initial_delay=30.0)
    engine.arm_fault('stall', 0.0, stall_secs=0.6)
    try:
        RemoteModel(client, 1).act(obs, None, [0, 1],
                                   sample_seed(1, (0, 0), 0))
        assert not client.engine_ok
        assert wait_for(lambda: not pipe.replies.empty(), 10)
        reply = client.rpc(('model', 1))
        assert reply['architecture'] == snap['architecture']
        assert client.stats['stale_replies'] == 1
    finally:
        engine.stop()


@pytest.mark.timeout(300)
def test_engine_killed_mid_episode_keeps_the_record_byte_identical():
    """The engine dies mid-episode: the worker degrades, finishes the
    episode on its own forward, and the record is byte for byte the
    uninterrupted engine run's and the per-worker path's; a degrade and
    re-promote cycle within one episode is lossless too."""
    _env, _jw, pw = ttt_wrappers()
    snap = pw.snapshot()
    task = {'role': 'g', 'player': [0, 1], 'model_id': {0: 1, 1: 1},
            'sample_key': 5}

    def per_worker():
        m = ModelWrapper.from_snapshot(snap, device='cpu')
        return Generator(make_env({'env': 'TicTacToe'}), GEN_ARGS).generate(
            {0: m, 1: m}, dict(task))

    def on_engine(drop_after=None, drop_until=None, reprobe=30.0):
        engine, pipe, client = _engine_and_pipe(
            snap, request_timeout=0.2, request_retries=0,
            reprobe_initial_delay=reprobe, reprobe_max_delay=reprobe)
        try:
            pipe.drop_after, pipe.drop_until = drop_after, drop_until
            models = RemoteModelCache(client).obtain({0: 1, 1: 1})
            episode = Generator(make_env({'env': 'TicTacToe'}), GEN_ARGS,
                                namespace=9).generate(models, dict(task))
            return episode, client
        finally:
            engine.stop()

    ref = pickle.dumps(per_worker())
    whole, _ = on_engine()
    assert pickle.dumps(whole) == ref
    degraded, client = on_engine(drop_after=3)
    assert not client.engine_ok and client.stats['failovers'] == 1
    assert pickle.dumps(degraded) == ref
    cycled, client = on_engine(drop_after=3, drop_until=4, reprobe=1e-6)
    assert client.engine_ok and client.stats['repromotions'] == 1
    assert pickle.dumps(cycled) == ref


@pytest.mark.timeout(120)
def test_worker_in_engine_mode_holds_no_params():
    """A Worker with the inference block on: its models are engine
    handles, its RPCs go through the client, and its beacon carries the
    client's counts."""
    from handyrl_tpu_torch.worker import Worker
    _env, _jw, pw = ttt_wrappers()
    args = dict(_args(), seed=0, observation=False, gamma=0.8,
                compress_steps=4, eval={'opponent': ['random']},
                worker={'device': 'cpu'})
    pipe = Loopback(None, {1: pw.snapshot()})
    worker = Worker(args, pipe, 3)
    assert isinstance(worker.vault, RemoteModelCache)
    assert worker._rpc(('model', 1))['architecture'] == 'SimpleConv2dModel'
    models = worker.vault.obtain({0: 1, 1: 0})
    assert all(isinstance(m, RemoteModel) for m in models.values())
    beacon = worker.beacon()
    assert beacon['engine_client']['failovers'] == 0
    assert beacon['engine_client']['engine_ok'] is True
    assert beacon['launches']['geese_trunk'] == 0


# -- the remote-service mode ---------------------------------------------


def _dead_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope='module')
def service(tmp_path_factory):
    jw, pw = geese_wrappers()
    root = str(tmp_path_factory.mktemp('registry'))
    ModelRegistry(root).publish('geese', snapshot=pw.snapshot(), version=1,
                                promote=True)
    svc = InferenceService(serving_args(
        {'env': 'HungryGeese'}, {}, {'port': 0, 'registry_dir': root}),
        device='cpu').start()
    try:
        yield svc, pw
    finally:
        svc.stop(drain=False)


def _remote_client(endpoints, pw):
    args = _args('HungryGeese', request_timeout=20.0, request_retries=1,
                 reprobe_initial_delay=30.0)
    args['serving'] = {'endpoint': ','.join(endpoints), 'line': 'geese'}
    pipe = Loopback(None, {1: pw.snapshot()})
    return EngineClient(pipe, args), pipe


@pytest.mark.timeout(300)
def test_remote_mode_rotates_past_a_dead_endpoint(service):
    svc, pw = service
    client, pipe = _remote_client(
        ['127.0.0.1:%d' % _dead_port(), 'localhost:%d' % svc.port], pw)
    remote = RemoteModel(client, 1)
    for obs, legal, seed in geese_plies(4, seed=5):
        got = remote.act(obs, None, legal, seed)
        local = model_act(pw, obs, None, legal, seed)
        assert got['action'] == local['action']
        assert isinstance(got['prob'], np.float32)
        assert got['prob'] == local['prob']
        np.testing.assert_array_equal(got['value'], local['value'])
        np.testing.assert_array_equal(got['action_mask'],
                                      local['action_mask'])
    assert client.engine_ok and client.stats['failovers'] == 0
    assert client.stats['endpoint_rotations'] == 1
    assert client.stats['remote_dials'] == 1
    assert pipe.model_fetches == 0 and svc.stats()['answered'] >= 4


@pytest.mark.timeout(300)
def test_remote_mode_with_every_endpoint_dead_degrades_locally(service):
    _svc, pw = service
    client, pipe = _remote_client(
        ['127.0.0.1:%d' % _dead_port(), '127.0.0.1:%d' % _dead_port()], pw)
    obs, legal, seed = geese_plies(1, seed=6)[0]
    t0 = time.monotonic()
    got = RemoteModel(client, 1).act(obs, None, legal, seed)
    assert time.monotonic() - t0 < 10      # no deadline waited out
    local = model_act(pw, obs, None, legal, seed)
    assert got['action'] == local['action'] and got['prob'] == local['prob']
    assert not client.engine_ok and client.stats['failovers'] == 1
    assert pipe.model_fetches == 1


# -- the learner's soft faults -------------------------------------------


def _jax_rule(fleet, peer_info, host_of, seen):
    """The JAX learner's soft-fault feed (handyrl_tpu/train.py:3116-3135),
    over its beacons' telemetry counters."""
    for ep, info in peer_info.items():
        if not isinstance(info, dict) or ep not in host_of:
            continue
        counters = (info.get('telemetry') or {}).get('counters') or {}
        cur = sum(v for k, v in counters.items()
                  if k.startswith(('engine_restarts_total',
                                   'worker_engine_failovers_total')))
        prev = seen.get(ep, 0)
        if cur > prev:
            fleet.record_soft_fault(host_of[ep], cur - prev)
        seen[ep] = cur


def test_soft_faults_from_beacons_reach_the_fleet_controller():
    """Synthetic beacons of two gathers: engine restarts and worker
    failovers, as deltas, degrade a host exactly as the JAX learner's rule
    degrades it from the same counts; a restarted process's smaller count
    records nothing."""
    clock = {'t': 1000.0}
    ft = TRAIN_DEFAULTS['fault_tolerance']

    def controller(cls):
        return cls(degrade_after=2,
                   quarantine_after=int(ft['host_quarantine_after']),
                   health_window=float(ft['host_health_window']),
                   quarantine_period=float(ft['host_quarantine_period']),
                   clock=lambda: clock['t'])

    def port_beacon(restarts, failovers):
        return {'gather': 0, 'engine': {'restarts': restarts},
                'workers': [{'worker': w, 'engine_client': {'failovers': f}}
                            for w, f in enumerate(failovers)]}

    def jax_beacon(restarts, failovers):
        return {'gather': 0, 'telemetry': {'counters': {
            'engine_restarts_total{reason="crash"}': restarts,
            'worker_engine_failovers_total': sum(failovers)}}}

    ours, theirs = controller(FleetController), controller(JaxFleetController)
    host_of = {'ep-a': 'host-a', 'ep-b': 'host-b'}
    for fleet in (ours, theirs):
        for host in host_of.values():
            fleet.observe(host)
    seen_ours, seen_theirs = {}, {}
    steps = [
        ({'ep-a': (0, [0, 0]), 'ep-b': (0, [0])}, HOST_HEALTHY, HOST_HEALTHY),
        ({'ep-a': (1, [0, 0]), 'ep-b': (2, [0])}, HOST_HEALTHY, HOST_DEGRADED),
        # host b's gather restarted: its smaller count records nothing
        ({'ep-a': (1, [1, 0]), 'ep-b': (0, [1])}, HOST_DEGRADED,
         HOST_DEGRADED),
        ({'ep-a': (1, [1, 0]), 'ep-b': (0, [2])}, HOST_DEGRADED,
         HOST_DEGRADED),
    ]
    for counts, want_a, want_b in steps:
        clock['t'] += 1.0
        record_soft_faults(ours, {ep: port_beacon(*c)
                                  for ep, c in counts.items()},
                           host_of, seen_ours)
        _jax_rule(theirs, {ep: jax_beacon(*c) for ep, c in counts.items()},
                  host_of, seen_theirs)
        assert ours.state('host-a') == theirs.state('host-a') == want_a
        assert ours.state('host-b') == theirs.state('host-b') == want_b
    assert seen_ours == seen_theirs == {'ep-a': 2, 'ep-b': 2}
    assert ours._softs['host-b'] == theirs._softs['host-b']
    assert len(ours._softs['host-b']) == 3
    # a peer of no known host is skipped
    record_soft_faults(ours, {'ep-c': port_beacon(5, [5])}, host_of,
                       seen_ours)
    assert 'ep-c' not in seen_ours
