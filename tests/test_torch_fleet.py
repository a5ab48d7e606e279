"""The serving fleet of the port (handyrl_tpu_torch/serving/fleet.py, the
replica side of serving/service.py, EngineClient._refresh_endpoints and the
``serving.fleet`` config) against the JAX package's, on the CPU.

The pure parts (ReplicaBreaker, AutoscalerPolicy, the config's defaults
and checks) must decide exactly as the JAX ones on the same inputs and
fake clocks. The resolver and the routed client run in process, as
threads, over in-process services of a TicTacToe SimpleConv2dModel whose
weights come from the JAX package's snapshot. Tolerances: a routed reply
equals the port's own local ``model_act`` bit for bit (inference is pure
in ``(model@version, obs, hidden, legal, seed)``, and the replica's engine
runs the same bucketed forward), and the JAX ``model_act`` on the same
weights within 1e-5 in ``prob`` with the same action (fp32 on both sides,
other summation orders). The JAX RoutedClient speaks to the port's
resolver and replicas and must get the port client's replies exactly.
Heartbeats and refreshes are short and every wait polls with a deadline.
"""

import json
import random
import sys
import time

import numpy as np
import pytest

from handyrl_tpu.config import apply_defaults as jax_apply_defaults
from handyrl_tpu.generation import model_act as jax_model_act
from handyrl_tpu.serving import __main__ as jax_serving_cli
from handyrl_tpu.serving.fleet import AutoscalerPolicy as JaxAutoscaler
from handyrl_tpu.serving.fleet import ReplicaBreaker as JaxBreaker
from handyrl_tpu.serving.fleet import RoutedClient as JaxRoutedClient
from handyrl_tpu_torch import config, telemetry
from handyrl_tpu_torch.config import ConfigError, serving_args
from handyrl_tpu_torch.generation import model_act, sample_seed
from handyrl_tpu_torch.inference import EngineClient, RemoteModel
from handyrl_tpu_torch.serving import __main__ as serving_cli
from handyrl_tpu_torch.serving import fleet
from handyrl_tpu_torch.serving.client import ServiceClient, ServiceError
from handyrl_tpu_torch.serving.fleet import (AutoscalerPolicy,
                                             ReplicaBreaker, RoutedClient,
                                             ServiceResolver)
from handyrl_tpu_torch.serving.registry import ModelRegistry
from handyrl_tpu_torch.serving.service import InferenceService
from proxy import ChaosProxy
from torch_engine_support import Loopback, one_torch_thread, ttt_wrappers, \
    wait_for

TOL = 1e-5
_one_torch_thread = pytest.fixture(autouse=True, scope='module')(
    one_torch_thread)


def _args(root, **flt):
    return serving_args({'env': 'TicTacToe'}, {'batch_wait_ms': 1.0},
                        {'port': 0, 'registry_dir': str(root),
                         'fleet': flt})


@pytest.fixture(scope='module')
def nets():
    """Two versions of TicTacToe's net: (env, [(JAX wrapper, port wrapper)
    of version 1, of version 2])."""
    env, jw1, pw1 = ttt_wrappers(seed=7)
    _env, jw2, pw2 = ttt_wrappers(seed=19)
    return env, [(jw1, pw1), (jw2, pw2)]


def _requests(env, count=4):
    env.reset()
    obs, legal = env.observation(0), env.legal_actions(0)
    return [(obs, legal, sample_seed(11, (0, k), 0)) for k in range(count)]


def _same(reply, ref):
    """A routed reply equals the local reference bit for bit."""
    assert reply['action'] == ref['action']
    assert isinstance(reply['prob'], np.float32)
    assert reply['prob'] == ref['prob']
    np.testing.assert_array_equal(reply['action_mask'], ref['action_mask'])
    np.testing.assert_array_equal(reply['value'], ref['value'])


# -- the pure parts against the JAX classes --------------------------------


def test_replica_breaker_decides_as_the_jax_breaker():
    clock = [100.0]
    port = ReplicaBreaker(initial=1.0, maximum=8.0, clock=lambda: clock[0],
                          rng=random.Random(0))
    ref = JaxBreaker(initial=1.0, maximum=8.0, clock=lambda: clock[0],
                     rng=random.Random(0))
    script = ['admits', 'failure', 'admits', 2.5, 'admits', 'probe',
              'admits', 'failure', 0.5, 'admits', 20.0, 'admits', 'probe',
              'success', 'admits', 'failure', 'failure', 30.0, 'admits']
    seen = {'port': [], 'jax': []}
    for step in script:
        if isinstance(step, float):
            clock[0] += step
            continue
        for name, b in (('port', port), ('jax', ref)):
            out = {'admits': b.admits, 'probe': b.begin_probe,
                   'failure': b.record_failure,
                   'success': b.record_success}[step]()
            seen[name].append((step, out, b.state))
    assert seen['port'] == seen['jax']
    assert ('failure', True, 'open') in seen['port']


def test_autoscaler_decides_as_the_jax_policy():
    clock = [0.0]
    kw = dict(slo_p99_ms=50.0, breach_window=10.0, idle_window=30.0,
              min_replicas=1, max_replicas=3, clock=lambda: clock[0])
    port, ref = AutoscalerPolicy(**kw), JaxAutoscaler(**kw)

    def table(p99, inflight, n=2, shed=0, state='healthy'):
        return [{'replica': 'r%d' % i, 'state': state, 'p99_ms': p99,
                 'inflight': inflight, 'shed': shed} for i in range(n)]

    script = [(0, table(80, 4)), (5, table(80, 4)), (11, table(80, 4)),
              (30, table(80, 4, n=3)), (45, table(80, 4, n=3)),
              (50, table(10, 0)), (79, table(10, 0)), (81, table(10, 0)),
              (120, table(10, 0, n=1)), (160, table(10, 0, n=1)),
              (200, table(10, 1, shed=5)), (201, table(10, 1, shed=9)),
              (212, table(10, 1, shed=12)), (215, table(10, 1, n=0)),
              (216, table(90, 2, state='quarantined')), (230, table(10, 1))]
    decisions = []
    for t, rows in script:
        clock[0] = float(t)
        got, want = port.decide(rows), ref.decide(rows)
        assert got == want, (t, got, want)
        decisions.append(got)
    assert decisions.count('admit') == 2 and decisions.count('drain') == 1


# -- the config blocks against the JAX package's -----------------------------


def _jax_serving(serving):
    return jax_apply_defaults({'env_args': {'env': 'TicTacToe'},
                               'train_args': {'serving': serving}})[
        'train_args']['serving']


def test_fleet_and_gateway_defaults_equal_the_jax_defaults():
    jax_srv = _jax_serving({})
    for block in ('fleet', 'gateway'):
        assert config.SERVING_DEFAULTS[block] == jax_srv[block]
        assert config.TRAIN_DEFAULTS['serving'][block] == jax_srv[block]
    assert config.SERVING_DEFAULTS['metrics_port'] == jax_srv['metrics_port']
    learner = config.apply_defaults({})['train_args']['serving']
    assert {k: learner[k] for k in ('fleet', 'gateway')} == {
        k: jax_srv[k] for k in ('fleet', 'gateway')}


# (a serving block the JAX checks refuse, the key the port's message names)
BAD_SERVING = [
    ({'fleet': {'heartbeat_interval': 0}}, 'heartbeat_interval'),
    ({'fleet': {'heartbeat_timeout': -1.0}}, 'heartbeat_timeout'),
    ({'fleet': {'refresh_interval': 0}}, 'refresh_interval'),
    ({'fleet': {'breach_window': 0}}, 'breach_window'),
    ({'fleet': {'idle_window': -5}}, 'idle_window'),
    ({'fleet': {'quarantine_period': 0}}, 'quarantine_period'),
    ({'fleet': {'heartbeat_interval': 5.0, 'heartbeat_timeout': 4.0}},
     'heartbeat_timeout must exceed'),
    ({'fleet': {'port': 70000}}, 'serving.fleet.port'),
    ({'fleet': {'replicas': -1}}, 'replicas'),
    ({'fleet': {'min_replicas': 0}}, 'min_replicas'),
    ({'fleet': {'min_replicas': 3, 'max_replicas': 2}}, 'max_replicas'),
    ({'fleet': {'slo_p99_ms': -1.0}}, 'slo_p99_ms'),
    ({'fleet': {'resolver': 'localhost'}}, 'serving.fleet.resolver'),
    ({'fleet': {'resolver': 'h:0'}}, 'serving.fleet.resolver'),
    ({'gateway': {'port': -1}}, 'serving.gateway.port'),
    ({'gateway': {'workers': 0}}, 'workers'),
    ({'gateway': {'max_sessions': 0}}, 'max_sessions'),
    ({'gateway': {'ply_timeout': 0}}, 'ply_timeout'),
    ({'gateway': {'monitor_interval': -1}}, 'monitor_interval'),
    ({'gateway': {'session_timeout': 0}}, 'session_timeout'),
    ({'gateway': {'resolver': 'nohost:port'}}, 'serving.gateway.resolver'),
    ({'metrics_port': 70000}, 'metrics_port'),
]


@pytest.mark.parametrize('serving,key', BAD_SERVING)
def test_serving_checks_refuse_what_the_jax_checks_refuse(serving, key):
    with pytest.raises(AssertionError):
        _jax_serving(serving)
    with pytest.raises(ConfigError, match=key):
        serving_args({'env': 'TicTacToe'}, {}, serving)
    with pytest.raises(ConfigError, match=key):
        config.apply_defaults({'train_args': {'serving': serving}})


@pytest.mark.parametrize('serving', [
    {'fleet': {'resolver': '10.0.0.2:9411', 'heartbeat_interval': 0.5,
               'heartbeat_timeout': 0.6, 'replicas': 0, 'autoscale': True,
               'min_replicas': 2, 'max_replicas': 2, 'slo_p99_ms': 25.0}},
    {'gateway': {'resolver': 'localhost:1', 'workers': 1,
                 'max_sessions': 1, 'model': 'geese@3'}}])
def test_serving_checks_accept_what_the_jax_checks_accept(serving):
    _jax_serving(serving)
    srv = serving_args({'env': 'TicTacToe'}, {}, serving)['serving']
    for block, values in serving.items():
        assert {k: srv[block][k] for k in values} == values
    config.apply_defaults({'train_args': {'serving': serving}})


@pytest.mark.parametrize('serving,key', [
    ({'metrics_port': 9100}, 'serving.metrics_port 9100'),
    ({'fleet': {'metrics_port': 9101}}, 'serving.fleet.metrics_port 9101'),
    ({'gateway': {'metrics_port': 9102}},
     'serving.gateway.metrics_port 9102')])
def test_an_exporter_port_is_refused_naming_item_4(serving, key):
    """Each tier's exporter port validates as the JAX checks do (the
    serving tier's telemetry is ported): a TCP port is taken, one out of
    range is refused with the JAX message."""
    _jax_serving(serving)     # the JAX package runs its exporter there
    srv = serving_args({'env': 'TicTacToe'}, {}, serving)['serving']
    config.apply_defaults({'train_args': {'serving': serving}})
    name, _, port = key.rpartition(' ')
    path = name.split('.')[1:]
    node = srv
    for part in path[:-1]:
        node = node[part]
    assert node[path[-1]] == int(port)
    bad = json.loads(json.dumps(serving).replace(port, '70000'))
    if name == 'serving.fleet.metrics_port':
        # the JAX checks leave this one to the bind; the port refuses it
        # up front with the message of the other two
        _jax_serving(bad)
    else:
        with pytest.raises(AssertionError, match='must be a TCP port'):
            _jax_serving(bad)
    with pytest.raises(ConfigError, match=name + ' must be a TCP port '
                       r'\(0 = exporter off\)'):
        serving_args({'env': 'TicTacToe'}, {}, bad)
    with pytest.raises(ConfigError, match=name + ' must be a TCP port'):
        config.apply_defaults({'train_args': {'serving': bad}})


def test_the_cli_defaults_equal_the_jax_cli_defaults(monkeypatch):
    """Every flag the two runners share has the JAX default (``--env`` was
    'HungryGeese' in the port), and a flagless start builds the JAX
    runner's service args."""
    port_ap = serving_cli.parser()
    seen = {}

    class JaxStop(Exception):
        pass

    def capture(ap_self, argv=None, namespace=None):
        seen['jax'] = jax_parse(ap_self, [])
        raise JaxStop
    import argparse
    jax_parse = argparse.ArgumentParser.parse_args
    monkeypatch.setattr(argparse.ArgumentParser, 'parse_args', capture)
    with pytest.raises(JaxStop):
        jax_serving_cli.main([])
    monkeypatch.undo()
    port = vars(port_ap.parse_args([]))
    jax = vars(seen['jax'])
    shared = set(port) & set(jax)
    assert {'env', 'registry', 'port', 'resolver', 'replica', 'replicas',
            'gateway', 'fleet', 'seed', 'max_sessions'} <= shared
    assert {k: port[k] for k in shared} == {k: jax[k] for k in shared}
    assert port['env'] == 'TicTacToe' and port['device'] == 'cuda'
    assert set(port) - set(jax) == {'device'}
    # only the JAX engine's backend flag is not the port's (its engine
    # runs on --device); --metrics-port is shared, with the JAX default 0
    assert set(jax) - set(port) == {'engine_backend'}
    assert port['metrics_port'] == jax['metrics_port'] == 0


# -- the resolver ------------------------------------------------------------


def _walk(admin_call):
    """register -> heartbeat -> silence -> quarantine -> re-register, as
    the (state, endpoint) rows an admin reads at each step."""
    rows = []
    rep = admin_call({'op': 'register', 'endpoint': '127.0.0.1:12345',
                      'pid': 1})
    name = rep['replica']
    assert rep['ok'] and name == 'r0'
    for _ in range(3):
        beat = admin_call({'op': 'heartbeat', 'replica': name,
                           'slo': {'p99_ms': 1.0, 'inflight': 0,
                                   'shed': 0}})
        assert beat == {'ok': True, 'drain': False}
        time.sleep(0.05)
    table = admin_call({'op': 'fleet'})
    assert table['fleet'] is True
    rows.append(table['replicas'][0]['state'])
    assert 'error' in admin_call({'op': 'heartbeat', 'replica': 'ghost'})
    assert wait_for(lambda: admin_call({'op': 'fleet'})['replicas'][0][
        'state'] == 'quarantined', timeout=20)
    rows.append('quarantined')
    rep = admin_call({'op': 'register', 'replica': name,
                      'endpoint': '127.0.0.1:12346', 'pid': 2})
    assert rep == {'ok': True, 'replica': name}
    row = admin_call({'op': 'fleet'})['replicas'][0]
    rows.append((row['state'], row['endpoint'], row['pid']))
    status = admin_call({'op': 'status'})
    assert status['resolver'] is True
    assert status['controller']['readmitted'] >= 1
    assert 'error' in admin_call({'op': 'bogus'})
    return rows


@pytest.mark.timeout(120)
def test_resolver_walk_matches_the_jax_resolver(tmp_path):
    from handyrl_tpu.serving.client import ServiceClient as JaxClient
    from handyrl_tpu.serving.fleet import ServiceResolver as JaxResolver
    flt = dict(heartbeat_interval=0.1, heartbeat_timeout=0.5,
               quarantine_period=60.0)
    walks = {}
    for name, resolver, client_cls in (
            ('port', ServiceResolver(_args(tmp_path, **flt)), ServiceClient),
            ('jax', JaxResolver(jax_apply_defaults({
                'train_args': {'serving': {'registry_dir': str(tmp_path),
                                           'fleet': flt}}})['train_args']),
             JaxClient)):
        resolver.start()
        admin = client_cls('127.0.0.1', resolver.port, name='ops')
        try:
            walks[name] = _walk(admin._call_admin)
        finally:
            admin.close()
            resolver.stop(drain=False)
    assert walks['port'] == walks['jax'] == [
        'healthy', 'quarantined', ('healthy', '127.0.0.1:12346', 2)]


class _FakeProc:
    """A managed replica's process handle for the supervision walk."""

    def __init__(self, pid):
        self.pid = pid
        self.rc = None
        self.signals = []

    def poll(self):
        return self.rc

    def send_signal(self, sig):
        self.signals.append(sig)
        self.rc = 75

    def wait(self, timeout=None):
        return self.rc

    def kill(self):
        self.rc = -9


def test_a_crashed_managed_replica_is_respawned_under_its_old_name(tmp_path):
    """The resolver's supervision on a fake clock: a managed replica that
    dies walks healthy -> draining -> quarantined, is respawned under the
    same name after its backoff, and its re-registration re-admits it; a
    drained one is retired."""
    clock = [1000.0]
    spawned = []

    def spawner(name):
        spawned.append(name)
        return _FakeProc(len(spawned))
    resolver = ServiceResolver(_args(tmp_path, heartbeat_timeout=60.0),
                               spawner=spawner, clock=lambda: clock[0])
    resolver._journal = lambda: None        # no hub: the loops never ran
    name = resolver.admit_replica()
    assert name == 'r0' and spawned == ['r0']

    class Ep:
        pass
    sent = []
    resolver.hub = type('H', (), {'send': lambda self, ep, m:
                                  sent.append(m)})()
    resolver._register(Ep(), {'replica': name, 'endpoint': 'h:1',
                              'pid': 1})
    assert resolver.fleet_table()[0]['state'] == 'healthy'
    resolver._procs[name].rc = -9           # SIGKILL
    resolver.tick_once()
    assert resolver.fleet_table()[0]['state'] == 'draining'
    assert spawned == ['r0']                # the backoff first
    clock[0] += 10.0
    resolver.tick_once()
    assert resolver.fleet_table()[0]['state'] == 'quarantined'
    assert spawned == ['r0', 'r0']          # the old name
    resolver._register(Ep(), {'replica': name, 'endpoint': 'h:2',
                              'pid': 2})
    row = resolver.fleet_table()[0]
    assert (row['state'], row['endpoint']) == ('healthy', 'h:2')
    assert resolver.controller.stats['readmitted'] == 1
    # a drain the resolver asked for is retired, not respawned
    assert resolver._request_drain(name)
    assert resolver._procs[name].signals       # SIGTERM sent
    resolver.tick_once()
    assert resolver.fleet_table() == [] and spawned == ['r0', 'r0']


def test_the_spawner_passes_the_device_and_the_fleet_knobs(tmp_path,
                                                           monkeypatch):
    seen = []
    monkeypatch.setattr(fleet.subprocess, 'Popen',
                        lambda cmd, **kw: seen.append(cmd) or _FakeProc(1))
    args = serving_args({'env': 'HungryGeese'}, {'max_batch': 16},
                        {'registry_dir': str(tmp_path),
                         'fleet': {'heartbeat_interval': 0.5}})
    resolver = ServiceResolver(args)
    resolver.port = 4321
    fleet._replica_spawner(args, resolver, 'cuda')('r3')
    cmd = seen[0]
    assert cmd[:3] == [sys.executable, '-m', 'handyrl_tpu_torch.serving']
    opts = dict(zip(cmd[3::2], cmd[4::2]))
    assert opts['--device'] == 'cuda' and opts['--replica'] == 'r3'
    assert opts['--resolver'] == '127.0.0.1:4321'
    assert opts['--env'] == 'HungryGeese'
    assert opts['--registry'] == str(tmp_path)
    assert opts['--heartbeat'] == '0.5' and opts['--max-batch'] == '16'
    # the runner of a replica parses what the spawner passes
    parsed = serving_cli.parser().parse_args(cmd[3:])
    assert parsed.device == 'cuda' and parsed.resolver == '127.0.0.1:4321'


def test_resolver_main_refuses_the_card_it_cannot_see(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip('this host has a card')
    with pytest.raises(RuntimeError, match='CUDA'):
        fleet.resolver_main(_args(tmp_path), device='cuda')


# -- the routed client over in-process replicas ------------------------------


@pytest.fixture
def fleet_of_two(tmp_path, nets):
    """A resolver, two self-registering replicas (r0, r1) over version 1
    as the champion, and the registry."""
    _env, versions = nets
    reg = ModelRegistry(str(tmp_path))
    reg.publish('default', snapshot=versions[0][1].snapshot(), version=1,
                promote=True)
    resolver = ServiceResolver(_args(tmp_path,
                                     heartbeat_timeout=60.0)).start()
    services = [InferenceService(_args(
        tmp_path, resolver='127.0.0.1:%d' % resolver.port,
        heartbeat_interval=0.1), device='cpu').start() for _ in range(2)]
    assert resolver.wait_routable(2, timeout=60)
    try:
        yield resolver, services, reg
    finally:
        for svc in services:
            svc.stop(drain=False)
        resolver.stop(drain=False)


@pytest.mark.timeout(300)
def test_routed_failover_is_byte_identical_and_holds_to_jax(tmp_path, nets):
    """One replica dies mid-burst through a ChaosProxy (severed sockets,
    refused redials): every stranded request is replayed on the survivor
    and every reply is the local reference's bits. A burst stalled on the
    dying replica while the champion flips replays the version it was
    pinned to, and fresh requests follow the flip."""
    env, versions = nets
    (jw1, pw1), (_jw2, pw2) = versions
    reg = ModelRegistry(str(tmp_path))
    reg.publish('default', snapshot=pw1.snapshot(), version=1, promote=True)
    resolver = ServiceResolver(_args(tmp_path,
                                     heartbeat_timeout=60.0)).start()
    svc_a = InferenceService(_args(tmp_path), device='cpu').start()
    svc_b = InferenceService(_args(tmp_path), device='cpu').start()
    proxy = ChaosProxy(target_port=svc_a.port)
    admin = ServiceClient('127.0.0.1', resolver.port, name='ops')
    admin.call_admin({'op': 'register', 'replica': 'a',
                      'endpoint': '127.0.0.1:%d' % proxy.port, 'pid': 0})
    admin.call_admin({'op': 'register', 'replica': 'b',
                      'endpoint': '127.0.0.1:%d' % svc_b.port, 'pid': 0})
    rc = RoutedClient('127.0.0.1', resolver.port, timeout=15.0,
                      refresh_interval=0.2)
    try:
        reqs = _requests(env)
        refs1 = [model_act(pw1, o, None, l, s) for o, l, s in reqs]
        refs2 = [model_act(pw2, o, None, l, s) for o, l, s in reqs]
        assert any(a['prob'] != b['prob'] for a, b in zip(refs1, refs2))
        for (o, l, s), ref in zip(reqs, refs1):
            _same(rc.request('default@champion', o, legal=l, seed=s), ref)
            jax_ref = jax_model_act(jw1, o, None, l, s)
            assert jax_ref['action'] == ref['action']
            assert abs(float(jax_ref['prob']) - float(ref['prob'])) <= TOL
        assert proxy.accepted > 0, 'the round robin never dialed replica a'
        # a burst whose replies never come back from a, then a's death
        proxy.stall = True
        rids = [rc.submit('default@champion', o, legal=l, seed=s,
                          replica='a') for o, l, s in reqs]
        reg.publish('default', snapshot=pw2.snapshot(), version=2,
                    promote=True)
        time.sleep(0.3)          # past the pin cache's interval
        proxy.accepting = False
        proxy.sever()
        for rid, ref in zip(rids, refs1):
            _same(rc.collect(rid), ref)     # replayed on b, at version 1
        assert rc.replays >= len(rids)
        for (o, l, s), ref in zip(reqs, refs2):
            _same(rc.request('default@champion', o, legal=l, seed=s), ref)
        assert rc.status()['resolver'] is True
    finally:
        rc.close()
        admin.close()
        proxy.close()
        svc_a.stop(drain=False)
        svc_b.stop(drain=False)
        resolver.stop(drain=False)


@pytest.mark.timeout(300)
def test_a_stranded_request_is_not_awaited_on_its_replicas_respawn(
        tmp_path, nets):
    """A replica respawned under its old name at a new endpoint while
    requests to its predecessor are in flight: each is replayed on a
    survivor at once, never awaited on the newcomer, which never got it
    (the JAX RoutedClient re-dials the name and waits out the timeout,
    once a stranded request)."""
    env, versions = nets
    pw = versions[0][1]
    ModelRegistry(str(tmp_path)).publish('default', snapshot=pw.snapshot(),
                                         version=1, promote=True)
    resolver = ServiceResolver(_args(tmp_path,
                                     heartbeat_timeout=60.0)).start()
    svcs = [InferenceService(_args(tmp_path), device='cpu').start()
            for _ in range(3)]
    proxy = ChaosProxy(target_port=svcs[0].port)
    admin = ServiceClient('127.0.0.1', resolver.port, name='ops')
    for name, port in (('a', proxy.port), ('b', svcs[1].port)):
        admin.call_admin({'op': 'register', 'replica': name,
                          'endpoint': '127.0.0.1:%d' % port, 'pid': 0})
    rc = RoutedClient('127.0.0.1', resolver.port, timeout=20.0,
                      refresh_interval=0.1)
    try:
        reqs = _requests(env)
        refs = [model_act(pw, o, None, l, s) for o, l, s in reqs]
        proxy.stall = True
        rids = [rc.submit('default@champion', o, legal=l, seed=s,
                          replica='a') for o, l, s in reqs]
        admin.call_admin({'op': 'register', 'replica': 'a', 'pid': 0,
                          'endpoint': '127.0.0.1:%d' % svcs[2].port})
        time.sleep(0.3)
        proxy.accepting = False
        proxy.sever()
        t0 = time.monotonic()
        for rid, ref in zip(rids, refs):
            _same(rc.collect(rid), ref)
        assert time.monotonic() - t0 < 10.0
        assert svcs[2].stats()['received'] == 0
    finally:
        rc.close()
        admin.close()
        proxy.close()
        for svc in svcs:
            svc.stop(drain=False)
        resolver.stop(drain=False)


@pytest.mark.timeout(300)
def test_rolling_promote_warms_before_the_flip(fleet_of_two, nets):
    """``promote`` warms every routable replica (one request through its
    engine) before the champion flips; a version that does not resolve
    leaves the champion where it was."""
    env, versions = nets
    resolver, services, reg = fleet_of_two
    (_jw1, pw1), (_jw2, pw2) = versions
    reqs = _requests(env)
    rc = RoutedClient('127.0.0.1', resolver.port, timeout=15.0,
                      refresh_interval=60.0)
    try:
        for o, l, s in reqs:
            _same(rc.request('default@champion', o, legal=l, seed=s),
                  model_act(pw1, o, None, l, s))
        out = rc.promote('default@7', timeout=60)
        assert 'error' in out
        assert reg.resolve('default', 'champion')[0] == '1'
        reg.publish('default', snapshot=pw2.snapshot(), version=2)
        served = [svc.stats()['engine_requests'] for svc in services]
        received = [svc.stats()['received'] for svc in services]
        out = rc.promote('default@2', timeout=120)
        assert out == {'ok': True, 'line': 'default', 'version': '2',
                       'warmed': ['r0', 'r1']}
        assert reg.resolve('default', 'champion')[0] == '2'
        # each replica ran one warm-up through its engine, which no
        # client sent
        assert [svc.stats()['engine_requests'] for svc in services] == \
            [n + 1 for n in served]
        assert [svc.stats()['received'] for svc in services] == received
        for o, l, s in reqs:
            _same(rc.request('default@champion', o, legal=l, seed=s),
                  model_act(pw2, o, None, l, s))
        stats = services[0].stats()
        assert (stats['replica'], stats['resolver']) == (
            'r0', '127.0.0.1:%d' % resolver.port)
        slo = services[0].slo_snapshot()
        assert slo['received'] >= 1 and slo['p99_ms'] >= slo['p50_ms'] > 0
        client = ServiceClient('127.0.0.1', services[0].port)
        try:
            # the trace op answers as the JAX op does; no dir leaves
            # tracing off, as it was
            assert client.call_admin({'op': 'trace'}) == {
                'ok': True, 'dir': '',
                'rate': telemetry.trace_sample_rate()}
            assert 'error' in client.call_admin({'op': 'warm',
                                                 'model': 'default@9'})
        finally:
            client.close()
    finally:
        rc.close()


@pytest.mark.timeout(300)
def test_a_resolver_directed_drain_reaches_the_replica(fleet_of_two):
    resolver, services, _reg = fleet_of_two
    admin = ServiceClient('127.0.0.1', resolver.port, name='ops')
    try:
        assert admin.call_admin({'op': 'drain', 'replica': 'r1'}) == {
            'ok': True, 'replica': 'r1'}
        assert 'error' in admin.call_admin({'op': 'drain', 'replica': 'x'})
        assert wait_for(services[1].fleet_drain_requested, timeout=20)
        row = {r['replica']: r for r in resolver.fleet_table()}['r1']
        assert row['draining']
    finally:
        admin.close()


@pytest.mark.timeout(300)
def test_the_jax_routed_client_gets_the_port_clients_replies(fleet_of_two,
                                                             nets):
    """Wire parity: the JAX package's RoutedClient dials the port's
    resolver and replicas."""
    env, _versions = nets
    resolver, _services, _reg = fleet_of_two
    port_rc = RoutedClient('127.0.0.1', resolver.port, timeout=15.0)
    jax_rc = JaxRoutedClient('127.0.0.1', resolver.port, timeout=15.0)
    try:
        assert sorted(r['replica'] for r in jax_rc.replicas()) == \
            ['r0', 'r1']
        for o, l, s in _requests(env):
            want = port_rc.request('default@champion', o, legal=l, seed=s)
            got = jax_rc.request('default@champion', o, legal=l, seed=s)
            assert got['action'] == want['action']
            assert got['prob'] == want['prob']
            np.testing.assert_array_equal(got['value'], want['value'])
        assert jax_rc.status()['resolver'] is True
    finally:
        port_rc.close()
        jax_rc.close()


@pytest.mark.timeout(300)
def test_engine_client_follows_the_resolvers_table(fleet_of_two, nets):
    """``serving.fleet.resolver`` gives a worker's EngineClient the fleet's
    routable replicas; a replica that leaves the table leaves the
    rotation, and the worker stays on the engine path."""
    env, versions = nets
    resolver, services, _reg = fleet_of_two
    pw = versions[0][1]
    args = {'inference': {'enabled': True, 'request_timeout': 5.0,
                          'request_retries': 1},
            'env': {'env': 'TicTacToe'}, 'worker': {'device': 'cpu'},
            'serving': {'line': 'default', 'fleet': {
                'resolver': '127.0.0.1:%d' % resolver.port,
                'refresh_interval': 0.5}}}
    client = EngineClient(Loopback(None, {1: pw.snapshot()}), args)
    remote = RemoteModel(client, 1)
    try:
        for o, l, s in _requests(env):
            _same(remote.act(o, None, l, s), model_act(pw, o, None, l, s))
        assert sorted(client._endpoints) == sorted(
            '127.0.0.1:%d' % svc.port for svc in services)
        admin = ServiceClient('127.0.0.1', resolver.port)
        admin.call_admin({'op': 'drain', 'replica': 'r0'})
        admin.close()
        client._resolver_next = 0.0
        client._refresh_endpoints()
        assert client._endpoints == ['127.0.0.1:%d' % services[1].port]
        client._drop_remote()         # the next dial reads the new table
        for o, l, s in _requests(env):
            _same(remote.act(o, None, l, s), model_act(pw, o, None, l, s))
        assert client.engine_ok and client.stats['failovers'] == 0
    finally:
        client._drop_remote()


def test_a_plain_service_endpoint_is_not_a_resolver(fleet_of_two):
    _resolver, services, _reg = fleet_of_two
    with pytest.raises(ServiceError, match='not a fleet resolver'):
        RoutedClient('127.0.0.1', services[0].port, timeout=5.0)
