"""The serving tier's telemetry on the port (the service's, the resolver's
and the gateway's exporters, ``/statusz`` and alerts, the ``trace`` admin
op, the serving-path spans and trace ids, the session events) held to the
JAX package's on the CPU.

Both packages run the same in-process stacks (a resolver, one replica of
TicTacToe's SimpleConv2dModel on the same weights, a gateway) on the same
traffic. The ``/statusz`` payloads must have the same keys and render to
the same ``--status`` text once the fields that differ by nature are
normalised (:data:`BY_NATURE`); the ``trace`` op must answer as the JAX
op does; a failover replay and a journal rebuild must read as one chain
under the original trace id; ``fail_replica`` and ``_drop`` must leave the
JAX events; a silent replica must fire ``heartbeat_misses`` on both
resolvers; and every span and event name the JAX package emits must be
emitted by the port. Exact comparisons (tolerance 0): the payloads are
counters and names, not floats. One intra-op thread; every wait polls
with a deadline.
"""

import copy
import glob
import json
import os
import random
import re
import socket
import time
import urllib.request

import pytest

from handyrl_tpu import telemetry as jt
from handyrl_tpu.config import apply_defaults as jax_apply_defaults
from handyrl_tpu.fault import SessionLedger as JaxSessionLedger
from handyrl_tpu.serving import gateway as jax_gateway
from handyrl_tpu.serving.client import ServiceClient as JaxServiceClient
from handyrl_tpu.serving.fleet import RoutedClient as JaxRoutedClient
from handyrl_tpu.serving.fleet import ServiceResolver as JaxResolver
from handyrl_tpu.serving.registry import ModelRegistry as JaxModelRegistry
from handyrl_tpu.serving.service import InferenceService as JaxService
from handyrl_tpu_torch import telemetry as pt
from handyrl_tpu_torch.config import serving_args
from handyrl_tpu_torch.fault import SessionLedger
from handyrl_tpu_torch.generation import sample_seed
from handyrl_tpu_torch.serving.client import ServiceClient
from handyrl_tpu_torch.serving.fleet import RoutedClient, ServiceResolver
from handyrl_tpu_torch.serving.gateway import MatchGateway, MatchSession
from handyrl_tpu_torch.serving.registry import ModelRegistry
from handyrl_tpu_torch.serving.service import InferenceService
from proxy import ChaosProxy
from torch_engine_support import one_torch_thread, ttt_wrappers, wait_for

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_one_torch_thread = pytest.fixture(autouse=True, scope='module')(
    one_torch_thread)

# the alert engines evaluate once (their first scrape) and then hold that
# block: both packages' statusz then carry the same alert state whatever
# else the test process's registries hold
FROZEN_ALERTS = {'alerts': {'interval': 3600.0}}

# /statusz fields that differ by nature between two processes (or two
# packages in one process) on the same traffic: the process identity and
# clock, the recorder's ring (each package's log lines), measured
# latencies and ages, the alert engine's clock and its raw values (not
# rendered)
BY_NATURE = ('pid', 'run_id', 'role', 'time', 'recorder', 'slo.p50_ms',
             'slo.p99_ms', 'slo.ply_p50_ms', 'slo.ply_p99_ms',
             'requests[].p50_ms', 'requests[].p99_ms',
             'sessions[].ply_p99_ms', 'sessions[].age_s', 'alerts.time',
             'alerts.values')


def free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(('127.0.0.1', 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def normalise(payload):
    """``payload`` with every :data:`BY_NATURE` field set to a constant."""
    out = copy.deepcopy(payload)
    for path in BY_NATURE:
        head, _, leaf = path.rpartition('.')
        if not head:
            if leaf in out:
                out[leaf] = '*'
            continue
        if head.endswith('[]'):
            rows = out.get(head[:-2]) or []
        else:
            rows = [out.get(head)] if isinstance(out.get(head), dict) else []
        for row in rows:
            if leaf in row:
                row[leaf] = 0.0
    return out


def shape(node):
    """The key structure of a JSON value: dicts by their keys, lists by
    their first row, leaves by kind."""
    if isinstance(node, dict):
        return {k: shape(v) for k, v in node.items()}
    if isinstance(node, list):
        return [shape(node[0])] if node else []
    if isinstance(node, bool) or node is None:
        return type(node).__name__
    return 'number' if isinstance(node, (int, float)) else 'str'


# -- the two stacks --------------------------------------------------------


def _port_args(root, **srv):
    return serving_args({'env': 'TicTacToe'}, {'batch_wait_ms': 1.0},
                        dict({'port': 0, 'registry_dir': str(root)}, **srv),
                        telemetry=FROZEN_ALERTS)


def _jax_args(root, **srv):
    args = jax_apply_defaults({
        'env_args': {'env': 'TicTacToe'},
        'train_args': {'serving': dict({'port': 0,
                                        'registry_dir': str(root)}, **srv),
                       'inference': {'batch_wait_ms': 1.0},
                       'telemetry': FROZEN_ALERTS}})['train_args']
    args['env'] = {'env': 'TicTacToe'}
    args['seed'] = 11
    return args


GATEWAY_COUNTERS = {
    'opened': 'gateway_sessions_opened_total',
    'plies': 'gateway_plies_total',
    'outcomes': 'gateway_outcomes_total',
    'handoffs': 'gateway_handoffs_total',
    'reconstructs': 'gateway_reconstructs_total',
    'dropped': 'gateway_session_drops_total'}


class Stack:
    """One package's resolver, one self-registering replica and a gateway,
    each with its exporter on a free port, over version 1 of the same
    TicTacToe weights."""

    def __init__(self, root, jax, snapshot):
        self.jax = jax
        mk_args, Resolver, Service, Registry = (
            (_jax_args, JaxResolver, JaxService, JaxModelRegistry) if jax
            else (_port_args, ServiceResolver, InferenceService,
                  ModelRegistry))
        Registry(str(root)).publish('default', snapshot=snapshot, version=1,
                                    promote=True)
        fport, sport, gport = free_ports(3)
        self.resolver = Resolver(mk_args(root, fleet={
            'heartbeat_timeout': 60.0, 'metrics_port': fport})).start()
        endpoint = '127.0.0.1:%d' % self.resolver.port
        sargs = mk_args(root, metrics_port=sport, fleet={
            'resolver': endpoint, 'heartbeat_interval': 0.1})
        self.service = (Service(sargs) if jax
                        else Service(sargs, device='cpu')).start()
        assert self.resolver.wait_routable(1, timeout=60)
        # the JAX gateway reads its process's counters, which other JAX
        # gateways of a test process move too: its progress is taken from
        # the counters as they stand now
        self.base = {k: jt.counter(n).value
                     for k, n in GATEWAY_COUNTERS.items()} if jax else None
        gw_args = mk_args(root, gateway={
            'resolver': endpoint, 'workers': 1, 'monitor_interval': 0.1,
            'metrics_port': gport})
        gw_args['seed'] = 11
        self.gateway = (jax_gateway.MatchGateway if jax
                        else MatchGateway)(gw_args).start()
        self.ports = {'resolver': self.resolver.metrics_port,
                      'service': self.service.metrics_port,
                      'gateway': self.gateway.metrics_port}

    def drive(self, requests):
        """The traffic: ``requests`` routed requests, then one gateway
        session of two client plies; returns the replies."""
        Routed = JaxRoutedClient if self.jax else RoutedClient
        rc = Routed('127.0.0.1', self.resolver.port, timeout=15.0,
                    refresh_interval=0.1)
        try:
            replies = [rc.request('default@champion', o, legal=l, seed=s)
                       for o, l, s in requests]
        finally:
            rc.close()
        rng = random.Random(5)
        reply = self.gateway._op_open({'env': 'TicTacToe', 'seat': 0,
                                       'client': 'alice', 'seed': 23})
        for _ in range(2):
            reply = self.gateway._op_play({
                'sid': reply['sid'],
                'action': int(rng.choice(reply['legal']))})
            assert 'error' not in reply, reply
        return replies

    def statusz(self, tier):
        payload = pt.fetch_statusz('127.0.0.1:%d' % self.ports[tier])
        if self.jax and tier == 'gateway':
            payload['progress'] = {
                k: v - int(self.base[k])
                for k, v in payload['progress'].items()}
        return payload

    def close(self):
        router = getattr(self.gateway._tl, 'router', None)
        if self.jax and router is not None:
            router.close()
        self.gateway.stop(drain=False)
        self.service.stop(drain=False)
        self.resolver.stop(drain=False)


@pytest.fixture(scope='module')
def stacks(tmp_path_factory):
    env, jw, pw = ttt_wrappers(seed=7)
    env.reset()
    obs, legal = env.observation(0), env.legal_actions(0)
    requests = [(obs, legal, sample_seed(11, (0, k), 0)) for k in range(3)]
    built = {}
    try:
        for name, jax, w in (('port', False, pw), ('jax', True, jw)):
            built[name] = Stack(tmp_path_factory.mktemp(name), jax,
                                w.snapshot())
        replies = {name: s.drive(requests) for name, s in built.items()}
        assert [r['action'] for r in replies['port']] == \
            [r['action'] for r in replies['jax']]
        total = len(requests) + 1     # and at least one gateway ply
        for s in built.values():
            # the resolver's request table carries the replica's counts
            # once a heartbeat has told it
            answered = s.service.stats()['answered']
            assert answered >= total
            assert wait_for(lambda s=s, n=answered: any(
                r['answered'] == n for r in s.resolver._status_info()[
                    'requests']), timeout=30)
        yield built
    finally:
        for s in built.values():
            s.close()


# -- each tier's exporter ----------------------------------------------------


@pytest.mark.timeout(300)
@pytest.mark.parametrize('tier', ['service', 'resolver', 'gateway'])
def test_each_tier_serves_metrics_and_the_jax_statusz(stacks, tier):
    port, ref = stacks['port'].statusz(tier), stacks['jax'].statusz(tier)
    assert shape(normalise(port)) == shape(normalise(ref))
    assert set(port['recorder']) == set(ref['recorder'])
    assert pt.render_status(normalise(port)) == \
        jt.render_status(normalise(ref))
    with urllib.request.urlopen(
            'http://127.0.0.1:%d/metrics' % stacks['port'].ports[tier],
            timeout=5) as resp:
        text = resp.read().decode()
    want = {'service': 'serve_requests_total',
            'resolver': 'fleet_replicas',
            'gateway': 'gateway_sessions_opened_total'}[tier]
    assert re.search(r'^%s(\{[^}]*\})? \d' % want, text, re.M), want
    if tier == 'gateway':
        # two client plies, each answered by one opponent ply
        assert [s['plies'] for s in port['sessions']] == [4]
        assert (port['progress']['opened'], port['progress']['plies']) == \
            (1, 2)
    if tier == 'resolver':
        assert port['fleet_replicas'] == {'r0': 'healthy'}


def test_the_status_cli_renders_each_tier(stacks, capsys):
    from handyrl_tpu_torch import __main__ as cli
    for tier in ('service', 'resolver', 'gateway'):
        target = '127.0.0.1:%d' % stacks['port'].ports[tier]
        assert cli.main(['--status', target]) == 0
        out = capsys.readouterr().out
        assert {'service': 'slo:', 'resolver': 'fleet replicas: r0=healthy',
                'gateway': 'sessions: 1 active'}[tier] in out
    assert cli.main(['--status', '127.0.0.1:%d' % free_ports(1)[0]]) == 1


# -- the trace op ------------------------------------------------------------


@pytest.fixture
def tracing_off():
    """Tracing is process-global: each test leaves both packages' off."""
    try:
        yield
    finally:
        for mod in (pt, jt):
            mod.trace_flush()
            mod.configure_tracing('', 1.0, force=True)
        os.environ.pop('HANDYRL_TPU_TRACE', None)
        os.environ.pop('HANDYRL_TPU_TRACE_RATE', None)


@pytest.mark.timeout(120)
@pytest.mark.parametrize('tier', ['service', 'gateway'])
def test_the_trace_op_answers_as_the_jax_op(stacks, tier, tmp_path,
                                           tracing_off):
    replies = {}
    for name, Client, mod in (('port', ServiceClient, pt),
                              ('jax', JaxServiceClient, jt)):
        target = getattr(stacks[name], tier)
        client = Client('127.0.0.1', target.port, name='ops')
        try:
            d = str(tmp_path / name / 'traces')
            on = client.call_admin({'op': 'trace', 'dir': d, 'rate': 0.25})
            assert (mod.trace_dir(), mod.trace_sample_rate()) == (d, 0.25)
            off = client.call_admin({'op': 'trace'})
            assert not mod.trace_enabled()
        finally:
            client.close()
        replies[name] = (dict(on, dir=os.path.basename(on['dir'])), off)
    assert replies['port'] == replies['jax']
    assert replies['port'][0] == {'ok': True, 'dir': 'traces', 'rate': 0.25}


# -- the serving-path chains ---------------------------------------------------


def _events(trace_d):
    pt.trace_flush()
    events = []
    for path in glob.glob(os.path.join(trace_d, 'trace-*.jsonl')):
        with open(path) as f:
            events.extend(json.loads(line) for line in f if line.strip())
    return events


def _chain(events, tid):
    names = set()
    for e in events:
        a = e.get('args') or {}
        if a.get('trace_id') == tid or tid in (a.get('trace_ids') or ()):
            names.add(e['name'])
    return names


SERVE_CHAIN = ('client_request', 'route_dispatch', 'serve_request',
               'queue_wait', 'engine_batch')


@pytest.mark.timeout(300)
def test_failover_replay_links_original_trace_id(tmp_path, tracing_off):
    """A request stranded by a dead replica is replayed on the survivor
    under its ORIGINAL trace id, with a ``router_replay`` link span: the
    kill reads as one chain. The engine closes its ``engine_batch`` span
    after it replies, so the chains are read until they are whole (with
    a deadline), never after a fixed sleep."""
    env, _jw, pw = ttt_wrappers(seed=7)
    env.reset()
    obs, legal = env.observation(0), env.legal_actions(0)
    ModelRegistry(str(tmp_path)).publish('default', snapshot=pw.snapshot(),
                                         version=1, promote=True)
    trace_d = str(tmp_path / 'traces')
    pt.configure_tracing(trace_d, 1.0, force=True)
    args = _port_args(tmp_path, fleet={'heartbeat_timeout': 60.0})
    resolver = ServiceResolver(args).start()
    svc_a = InferenceService(_port_args(tmp_path), device='cpu').start()
    svc_b = InferenceService(_port_args(tmp_path), device='cpu').start()
    proxy = ChaosProxy(target_port=svc_a.port)       # a dies through this
    admin = ServiceClient('127.0.0.1', resolver.port, name='ops')
    rc = RoutedClient('127.0.0.1', resolver.port, timeout=15.0,
                      refresh_interval=0.2)
    try:
        for name, port in (('a', proxy.port), ('b', svc_b.port)):
            admin.call_admin({'op': 'register', 'replica': name, 'pid': 0,
                              'endpoint': '127.0.0.1:%d' % port})
        seeds = [sample_seed(11, (0, k), 0) for k in range(4)]
        for s in seeds:                        # warm both replicas
            rc.request('default@champion', obs, legal=legal, seed=s)
        tids = ['torchtest%d' % k for k in range(4)]
        proxy.stall = True
        rids = [rc.submit('default@champion', obs, legal=legal, seed=s,
                          replica='a', trace=t)
                for s, t in zip(seeds, tids)]
        proxy.accepting = False
        proxy.sever()
        for rid in rids:
            rc.collect(rid)                    # the replays ride b
        assert rc.replays >= len(rids)

        def whole():
            events = _events(trace_d)
            return events if all(set(SERVE_CHAIN) <= _chain(events, t)
                                 for t in tids) else None
        assert wait_for(whole, timeout=20), \
            {t: sorted(_chain(_events(trace_d), t)) for t in tids}
        events = whole()
        replays = [e for e in events if e['name'] == 'router_replay']
        assert {e['args']['trace_id'] for e in replays} == set(tids)
        for e in replays:
            assert (e['args']['link'], e['args']['from_replica'],
                    e['args']['to_replica']) == ('replay', 'a', 'b')
        serve = [e for e in events if e['name'] == 'serve_request'
                 and e['args']['trace_id'] in tids]
        assert serve and all(e['args']['model'] == 'default@1'
                             for e in serve)
        # the warm-up requests minted their own ids at the router
        minted = {e['args']['trace_id'] for e in events
                  if e['name'] == 'client_request'} - set(tids)
        assert len(minted) >= len(seeds)
    finally:
        rc.close()
        admin.close()
        proxy.close()
        svc_a.stop(drain=False)
        svc_b.stop(drain=False)
        resolver.stop(drain=False)


@pytest.mark.timeout(300)
def test_gateway_reconstruct_spans_link_open_trace(tmp_path, tracing_off):
    """A journal rebuild: ``gateway_reconstruct`` carries the session's
    ORIGINAL open-time trace id, every ``gateway_ply`` points back at it
    through ``session_trace``, and a refused rebuild (a tampered journal)
    emits the link span with ``ok`` false; the trace id changes no
    reply: the traced session's replies equal an untraced run's."""
    _env, _jw, pw = ttt_wrappers(seed=7)
    ModelRegistry(str(tmp_path)).publish('default', snapshot=pw.snapshot(),
                                         version=1, promote=True)
    resolver = ServiceResolver(_port_args(
        tmp_path, fleet={'heartbeat_timeout': 60.0})).start()
    svc = InferenceService(_port_args(tmp_path, fleet={
        'resolver': '127.0.0.1:%d' % resolver.port,
        'heartbeat_interval': 0.1}), device='cpu').start()
    assert resolver.wait_routable(1, timeout=60)
    gw_args = _port_args(tmp_path, gateway={
        'resolver': '127.0.0.1:%d' % resolver.port, 'workers': 1,
        'monitor_interval': 0.1})
    gw_args['seed'] = 11
    # two gateways, so that both runs open their session under counter 1
    plain, gw = MatchGateway(gw_args), MatchGateway(gw_args)
    trace_d = str(tmp_path / 'traces')

    def session(seed, gw=gw):
        rng = random.Random(3)
        reply = gw._op_open({'env': 'TicTacToe', 'seat': 0, 'client': 'tr',
                             'seed': seed})
        trail = [reply]
        for _ in range(2):
            reply = gw._op_play({'sid': reply['sid'],
                                 'action': int(rng.choice(reply['legal']))})
            assert 'error' not in reply, reply
            trail.append(reply)
        return reply['sid'], trail

    try:
        _sid0, untraced = session(31, plain)
        pt.configure_tracing(trace_d, 1.0, force=True)
        sid, traced = session(31)
        for a, b in zip(untraced, traced):
            a, b = dict(a), dict(b)
            a.pop('sid'), b.pop('sid')
            assert json.dumps(a, sort_keys=True, default=repr) == \
                json.dumps(b, sort_keys=True, default=repr)
        sess = gw._sessions[sid]
        assert sess.trace and 'trace' not in json.dumps(sess.journal)
        assert gw._reconstruct(sess, gw._router())
        sid2, _trail = session(37)
        sess2 = gw._sessions[sid2]
        sess2.journal['hidden_digest'] = '0' * 40
        assert not gw._reconstruct(sess2, gw._router())

        events = _events(trace_d)
        by_name = {}
        for e in events:
            by_name.setdefault(e['name'], []).append(e)
        opens = [e for e in by_name['gateway_open']
                 if e['args']['sid'] == sid]
        assert len(opens) == 1 and opens[0]['args']['trace_id'] == sess.trace
        recs = [e for e in by_name['gateway_reconstruct']
                if e['args']['sid'] == sid]
        assert len(recs) == 1
        assert (recs[0]['args']['trace_id'], recs[0]['args']['link'],
                recs[0]['args']['ok']) == (sess.trace, 'reconstruct', True)
        assert recs[0]['args']['replayed'] >= 2
        plies = [e for e in by_name['gateway_ply']
                 if e['args']['sid'] == sid]
        assert len(plies) == 2
        assert all(e['args']['session_trace'] == sess.trace for e in plies)
        # each ply's own id runs through the router into the replica
        for e in plies:
            assert {'gateway_ply', 'gateway_seat', 'client_request',
                    'route_dispatch', 'serve_request',
                    'queue_wait'} <= _chain(events, e['args']['trace_id'])
        recs2 = [e for e in by_name['gateway_reconstruct']
                 if e['args']['sid'] == sid2]
        assert len(recs2) == 1
        assert (recs2[0]['args']['trace_id'], recs2[0]['args']['ok']) == (
            sess2.trace, False)
        assert sid2 not in gw._sessions
    finally:
        plain.stop(drain=False)
        gw.stop(drain=False)
        svc.stop(drain=False)
        resolver.stop(drain=False)


# -- the session events --------------------------------------------------------


def _recorded(mod, kind, since):
    return [{k: v for k, v in e.items() if k != 't'}
            for e in mod.recorder().events()
            if e['kind'] == kind and e['t'] >= since]


def test_fail_replica_records_one_stranding_a_session_as_the_jax_ledger():
    since = time.time() - 1.0
    for Ledger in (SessionLedger, JaxSessionLedger):
        ledger = Ledger()
        for sid, replica in (('s3', 'r0'), ('s1', 'r0'), ('s2', 'r1'),
                             ('s4', 'r0')):
            ledger.book(sid, replica)
        assert ledger.fail_replica('r0', reason='killed') == \
            ['s1', 's3', 's4']
        assert ledger.fail_replica('r9') == []
    port = _recorded(pt, 'session_stranding', since)[-3:]
    ref = _recorded(jt, 'session_stranding', since)[-3:]
    assert port == ref
    assert port == [{'kind': 'session_stranding', 'msg': 'r0',
                     'reason': 'killed', 'session': s}
                    for s in ('s1', 's3', 's4')]


def test_a_dropped_session_records_session_drop_as_the_jax_gateway(tmp_path):
    since = time.time() - 1.0
    _env, jw, pw = ttt_wrappers(seed=7)
    for gw_mod, mk_args, Session in (
            (None, _port_args, MatchSession),
            (jax_gateway, _jax_args, jax_gateway.MatchSession)):
        args = mk_args(tmp_path, gateway={'resolver': '127.0.0.1:1'})
        args['seed'] = 11
        gw = (MatchGateway if gw_mod is None else gw_mod.MatchGateway)(args)
        sess = Session('s000007', 7, 'TicTacToe', {'env': 'TicTacToe'},
                       None, 'default@1', 0, 11, 'bob')
        gw.ledger.book(sess.sid, 'r1')
        gw._drop(sess, 'reconstruct hidden-digest mismatch')
        assert gw.ledger.outstanding() == 0
    port = _recorded(pt, 'session_drop', since)[-1:]
    assert port == _recorded(jt, 'session_drop', since)[-1:]
    assert port == [{'kind': 'session_drop', 'msg': 's000007',
                     'reason': 'reconstruct hidden-digest mismatch'}]


# -- the resolver's alerts -----------------------------------------------------


@pytest.mark.timeout(120)
def test_a_silent_replica_fires_heartbeat_misses_as_on_the_jax_resolver(
        tmp_path):
    """The same script on both resolvers: a replica registers, beats once
    and falls silent past ``heartbeat_timeout``; each resolver's alert
    block then shows ``heartbeat_misses`` fired."""
    blocks = {}
    for name, Resolver, mk_args, Client in (
            ('port', ServiceResolver, serving_args, ServiceClient),
            ('jax', JaxResolver, None, JaxServiceClient)):
        flt = {'heartbeat_interval': 0.1, 'heartbeat_timeout': 0.4,
               'quarantine_period': 60.0}
        tel = {'alerts': {'interval': 0.2}}
        if name == 'port':
            args = serving_args({'env': 'TicTacToe'}, {}, {
                'port': 0, 'registry_dir': str(tmp_path), 'fleet': flt},
                telemetry=tel)
        else:
            args = jax_apply_defaults({'env_args': {'env': 'TicTacToe'},
                                       'train_args': {'serving': {
                                           'port': 0, 'fleet': flt,
                                           'registry_dir': str(tmp_path)},
                                           'telemetry': tel}})['train_args']
        resolver = Resolver(args).start()
        admin = Client('127.0.0.1', resolver.port, name='ops')
        call = admin.call_admin if name == 'port' else admin._call_admin
        try:
            time.sleep(0.3)    # one evaluation before the miss: its rate
            rep = call({'op': 'register', 'endpoint': '127.0.0.1:12345',
                        'pid': 1})
            call({'op': 'heartbeat', 'replica': rep['replica'],
                  'slo': {'p50_ms': 1.0, 'p99_ms': 2.0, 'inflight': 0,
                          'shed': 0, 'received': 0, 'answered': 0,
                          'draining': False}})
            assert wait_for(lambda: 'heartbeat_misses' in (
                resolver._status_info().get('alerts') or {}).get(
                    'fired', {}), timeout=30)
            blocks[name] = resolver._status_info()
        finally:
            admin.close()
            resolver.stop(drain=False)
    for block in blocks.values():
        assert block['alerts']['fired']['heartbeat_misses'] >= 1
        assert block['fleet_replicas'] != {}
    assert set(blocks['port']['alerts']) == set(blocks['jax']['alerts'])
    assert set(blocks['port']['alerts']['values']) == \
        set(blocks['jax']['alerts']['values'])


# -- the names -----------------------------------------------------------------


# span and event names the JAX package emits only on its mesh (ROADMAP.md
# §1 item 5): none today; a name added there is listed here
MESH_ONLY = frozenset()
_EMITTED = re.compile(r"""\b(?:trace_event|trace_span|trace_stage|"""
                      r"""record_event)\(\s*['"]([A-Za-z_][A-Za-z0-9_]*)['"]""")


def _emitted(package):
    out = set()
    for path in glob.glob(os.path.join(REPO, package, '**', '*.py'),
                          recursive=True):
        with open(path) as f:
            out |= set(_EMITTED.findall(f.read()))
    return out


def test_every_jax_span_and_event_name_is_emitted_by_the_port():
    jax_names, port_names = _emitted('handyrl_tpu'), _emitted(
        'handyrl_tpu_torch')
    assert {'client_request', 'route_dispatch', 'router_replay',
            'serve_request', 'gateway_open', 'gateway_ply', 'gateway_seat',
            'gateway_reconstruct', 'gateway_handoff', 'session_drop',
            'session_stranding'} <= jax_names
    assert sorted(jax_names - port_names - MESH_ONLY) == []
    assert MESH_ONLY <= jax_names
