"""The match gateway of the port (handyrl_tpu_torch/serving/gateway.py and
fault.SessionLedger) against the JAX package's, on the CPU.

The session primitives (``state_digest``, ``session_env_seed``) and the
ledger must equal the JAX ones exactly on the same inputs. The gateway
runs in process over an in-process fleet (resolver and replicas as
threads) of a TicTacToe SimpleConv2dModel and of a 2-layer GeeseNetLSTM
(filters 8), the weights from the JAX package's snapshots. Its opponents'
actions must equal the JAX gateway's on the same seeds (the sampled
actions are equal; the forwards agree within the engine tests' 1e-5, far
from a sampling boundary here), a journal rebuild must reproduce the
actions and the hidden digest byte for byte, and the JAX GatewayClient
must get from the port's gateway exactly the port client's replies.
Every wait polls with a deadline.
"""

import json
import os
import random
import signal
import subprocess
import sys

import numpy as np
import pytest

from handyrl_tpu.config import apply_defaults as jax_apply_defaults
from handyrl_tpu.fault import SessionLedger as JaxSessionLedger
from handyrl_tpu.serving import gateway as jax_gateway
from handyrl_tpu.serving.client import ServiceError as JaxServiceError
from handyrl_tpu.serving.fleet import ServiceResolver as JaxResolver
from handyrl_tpu.serving.registry import ModelRegistry as JaxModelRegistry
from handyrl_tpu.serving.service import InferenceService as JaxService
from handyrl_tpu_torch.config import serving_args
from handyrl_tpu_torch.fault import SessionLedger
from handyrl_tpu_torch.league import journal_path, make_rating_book
from handyrl_tpu_torch.serving import gateway
from handyrl_tpu_torch.serving.client import ServiceError
from handyrl_tpu_torch.serving.fleet import ServiceResolver
from handyrl_tpu_torch.serving.gateway import (GatewayClient, MatchGateway,
                                               session_env_seed,
                                               state_digest)
from handyrl_tpu_torch.serving.registry import ModelRegistry
from handyrl_tpu_torch.serving.service import InferenceService
from torch_engine_support import (geese_plies, one_torch_thread,
                                  ttt_wrappers, wait_for)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_one_torch_thread = pytest.fixture(autouse=True, scope='module')(
    one_torch_thread)


# -- the session primitives ----------------------------------------------


STATES = [
    None, {}, {3: None},
    {1: [np.arange(6, dtype=np.float32).reshape(2, 3),
         np.zeros((2, 3), np.float32)]},
    {2: (np.ones(4, np.float64), b'\x00\x01'), 0: [1, 2.5, 'x']},
    [np.float32(1.5), np.int64(3), np.array([True, False])],
]


@pytest.mark.parametrize('state', STATES)
def test_state_digest_equals_the_jax_digest(state):
    assert state_digest(state) == jax_gateway.state_digest(state)


def test_state_digest_sees_order_and_bytes_as_the_jax_digest():
    a = {1: np.ones(3, np.float32), 2: None}
    b = {2: None, 1: np.ones(3, np.float32)}
    assert state_digest(a) == state_digest(b)
    c = {1: np.ones(3, np.float32), 2: None}
    c[1][0] = np.nextafter(np.float32(1), np.float32(2))
    assert state_digest(c) != state_digest(a)
    assert state_digest({1: np.ones(3, np.float64)}) != state_digest(
        {1: np.ones(3, np.float32)})


@pytest.mark.parametrize('base_seed,counter', [(0, 1), (11, 1), (11, 2),
                                               (2 ** 40, 7), (-3, 12)])
def test_session_env_seed_equals_the_jax_seed(base_seed, counter):
    assert session_env_seed(base_seed, counter) == \
        jax_gateway.session_env_seed(base_seed, counter)
    assert gateway.GATEWAY_SEED_NAMESPACE == \
        jax_gateway.GATEWAY_SEED_NAMESPACE == 4


def test_session_ledger_ends_as_the_jax_ledger():
    clock = [5.0]
    port = SessionLedger(clock=lambda: clock[0])
    ref = JaxSessionLedger(clock=lambda: clock[0])
    rng = random.Random(3)
    ops = []
    for k in range(200):
        op = rng.choice(['book', 'move', 'move', 'release', 'fail'])
        sid, replica = 's%d' % rng.randrange(12), 'r%d' % rng.randrange(3)
        ops.append((op, sid, replica))
    for op, sid, replica in ops:
        clock[0] += 1.0
        for ledger in (port, ref):
            out = {'book': lambda: ledger.book(sid, replica),
                   'move': lambda: ledger.move(sid, replica),
                   'release': lambda: ledger.release(sid),
                   'fail': lambda: ledger.fail_replica(replica, 'killed')}[
                op]()
            if ledger is port:
                got = out
            else:
                assert got == out, (op, sid, replica)
        assert port.replica_of(sid) == ref.replica_of(sid)
    assert port.stats == ref.stats
    assert port.outstanding() == ref.outstanding()
    assert port.outstanding_by_replica() == ref.outstanding_by_replica()
    for r in ('r0', 'r1', 'r2'):
        assert port.sessions_on(r) == ref.sessions_on(r)
    assert port.drain_stranding_events() == ref.drain_stranding_events()
    assert port.stats['stranded'] > 0 and port.stats['moved'] > 0


# -- the gateway over an in-process fleet --------------------------------


def _args(root, **srv):
    return serving_args({'env': 'TicTacToe'}, {'batch_wait_ms': 1.0},
                        dict({'port': 0, 'registry_dir': str(root)}, **srv))


def _gateway(root, resolver_port, **gw):
    args = _args(root, gateway=dict({
        'resolver': '127.0.0.1:%d' % resolver_port, 'workers': 1,
        'monitor_interval': 0.1}, **gw))
    args['seed'] = 11
    return MatchGateway(args)


class Fleet:
    """A resolver and ``replicas`` self-registering in-process services
    over one champion, in ``root``."""

    def __init__(self, root, snapshot, replicas=2, env='TicTacToe'):
        ModelRegistry(str(root)).publish('default', snapshot=snapshot,
                                         version=1, promote=True)
        self.root = root
        self.resolver = ServiceResolver(_args(root, fleet={
            'heartbeat_interval': 0.1, 'heartbeat_timeout': 2.0})).start()
        self.services = [self.replica(env) for _ in range(replicas)]
        assert self.resolver.wait_routable(replicas, timeout=60)

    def replica(self, env='TicTacToe'):
        args = serving_args({'env': env}, {'batch_wait_ms': 1.0}, {
            'port': 0, 'registry_dir': str(self.root), 'fleet': {
                'resolver': '127.0.0.1:%d' % self.resolver.port,
                'heartbeat_interval': 0.1, 'heartbeat_timeout': 2.0}})
        return InferenceService(args, device='cpu').start()

    def close(self):
        for svc in self.services:
            svc.stop(drain=False)
        self.resolver.stop(drain=False)


@pytest.fixture
def ttt_fleet(tmp_path):
    _env, _jw, pw = ttt_wrappers(seed=7)
    fl = Fleet(tmp_path, pw.snapshot())
    try:
        yield fl
    finally:
        fl.close()


def _play(gw, sid, reply, rng, plies=None):
    """Drive a session with ``_op_play`` to its end (or ``plies`` plies):
    (the last reply, the plies played)."""
    n = 0
    while not reply.get('done') and (plies is None or n < plies):
        action = (int(rng.choice(reply['legal']))
                  if reply.get('to_move') and reply.get('legal') else None)
        reply = gw._op_play({'sid': sid, 'action': action})
        assert 'error' not in reply, reply
        n += 1
    return reply, n


@pytest.mark.timeout(300)
def test_gateway_lifecycle_books_the_outcome(ttt_fleet):
    gw = _gateway(ttt_fleet.root, ttt_fleet.resolver.port)
    try:
        reply = gw._op_open({'env': 'TicTacToe', 'seat': 0,
                             'client': 'alice', 'seed': 23})
        assert 'error' not in reply, reply
        sid = reply['sid']
        assert reply['model'] == 'default@1'       # the selector pinned
        assert reply['to_move'] and reply['legal']
        rng = random.Random(0)
        reply = gw._op_play({'sid': sid,
                             'action': int(rng.choice(reply['legal']))})
        assert gw.ledger.replica_of(sid) in ('r0', 'r1')
        table = gw.session_table()
        assert [r['sid'] for r in table] == [sid] and table[0]['plies'] >= 1
        reply, plies = _play(gw, sid, reply, rng)
        assert plies >= 1 and set(reply['outcome']) == {0, 1}
        assert sum(reply['outcome'].values()) == pytest.approx(0.0)
        assert sid not in gw._sessions and gw.ledger.outstanding() == 0
        assert 'error' in gw._op_play({'sid': sid})
        assert gw.ratings.is_provisional('gateway:alice')
        assert not gw.ratings.is_provisional('default@1')
        book = make_rating_book({})
        assert book.load(journal_path(str(ttt_fleet.root)))
        assert book.is_provisional('gateway:alice')
        assert 'default@1' in book.names()
        stats = gw.stats()
        assert (stats['opened'], stats['outcomes'], stats['dropped']) == \
            (1, 1, 0)
    finally:
        gw.stop(drain=False)


@pytest.mark.timeout(300)
def test_gateway_sheds_opens_never_plies(ttt_fleet):
    gw = _gateway(ttt_fleet.root, ttt_fleet.resolver.port, max_sessions=1)
    try:
        r1 = gw._op_open({'env': 'TicTacToe', 'seat': 0, 'client': 'a',
                          'seed': 5})
        assert 'error' not in r1, r1
        r2 = gw._op_open({'env': 'TicTacToe', 'seat': 0, 'client': 'b'})
        assert r2.get('shed') and 'error' in r2
        assert 'error' in gw._op_play({'sid': r1['sid'], 'action': 99})
        assert 'error' in gw._op_play({'sid': r1['sid']})
        assert 'error' in gw._op_play({'sid': 'zzz', 'action': 0})
        good = gw._op_play({'sid': r1['sid'], 'action': r1['legal'][0]})
        assert 'error' not in good, good
        assert gw._op_close({'sid': r1['sid']})['closed']
        assert gw.ledger.outstanding() == 0
        bad = gw._op_open({'env': 'NoSuchGame'})
        assert 'error' in bad and not bad.get('shed')
        bad = gw._op_open({'env': 'TicTacToe', 'seat': 5})
        assert 'error' in bad and not bad.get('shed')
        assert 'error' not in gw._op_open({'env': 'TicTacToe', 'seat': 0})
        assert gw.stats()['shed'] == 1
    finally:
        gw.stop(drain=False)


def _jax_fleet_and_gateway(root, jw):
    """The JAX package's resolver, one replica and gateway over ``jw``."""
    JaxModelRegistry(str(root)).publish('default', snapshot=jw.snapshot(),
                                        version=1, promote=True)

    def args(serving):
        a = jax_apply_defaults({'env_args': {'env': 'TicTacToe'},
                                'train_args': {'serving': dict(
                                    {'port': 0, 'registry_dir': str(root)},
                                    **serving)}})['train_args']
        a['env'] = {'env': 'TicTacToe'}
        a['seed'] = 11
        return a
    resolver = JaxResolver(args({'fleet': {'heartbeat_timeout': 60.0}}))
    resolver.start()
    svc = JaxService(args({'fleet': {
        'resolver': '127.0.0.1:%d' % resolver.port,
        'heartbeat_interval': 0.1}})).start()
    assert resolver.wait_routable(1, timeout=60)
    gw = jax_gateway.MatchGateway(args({'gateway': {
        'resolver': '127.0.0.1:%d' % resolver.port, 'workers': 1,
        'monitor_interval': 0.1}}))
    return resolver, svc, gw


@pytest.mark.timeout(300)
def test_opponent_actions_equal_the_jax_gateways(tmp_path, ttt_fleet):
    """The same sessions (seeds, client actions) through the port's and
    the JAX package's gateway: the same opponent actions, observations and
    outcomes."""
    _env, jw, _pw = ttt_wrappers(seed=7)
    resolver, svc, jax_gw = _jax_fleet_and_gateway(tmp_path / 'jax', jw)
    gw = _gateway(ttt_fleet.root, ttt_fleet.resolver.port)
    try:
        for seed, seat in ((23, 0), (24, 1), (25, 0)):
            trails = []
            for g in (gw, jax_gw):
                rng = random.Random(seed)
                reply = g._op_open({'env': 'TicTacToe', 'seat': seat,
                                    'client': 'c', 'seed': seed})
                trail = [(reply['sid'], reply['model'],
                          reply.get('legal'))]
                while not reply.get('done'):
                    action = (int(rng.choice(reply['legal']))
                              if reply.get('to_move') else None)
                    reply = g._op_play({'sid': reply['sid'],
                                        'action': action})
                    trail.append((reply['actions'], reply.get('legal'),
                                  np.asarray(reply.get('obs')).tolist()))
                trail.append(reply['outcome'])
                trails.append(trail)
            assert trails[0] == trails[1]
            assert any(len(a) > 1 for a, *_ in trails[0][1:-1])
    finally:
        gw.stop(drain=False)
        router = getattr(jax_gw._tl, 'router', None)
        if router is not None:
            router.close()
        svc.stop(drain=False)
        resolver.stop(drain=False)


@pytest.mark.timeout(300)
def test_a_drained_replicas_sessions_are_handed_off_unreplayed(ttt_fleet):
    gw = _gateway(ttt_fleet.root, ttt_fleet.resolver.port).start()
    client = GatewayClient('127.0.0.1', gw.port, name='d')
    try:
        rng = random.Random(1)
        replies = [client.open('TicTacToe', seed=s) for s in range(4)]
        replies = [client.play(r['sid'], int(rng.choice(r['legal'])))
                   for r in replies]      # the opponents' first plies
        owners = {r['sid']: gw.ledger.replica_of(r['sid']) for r in replies}
        victim = sorted(owners.values())[0]
        # the replica drains itself (a SIGTERM's drain): its heartbeats
        # say so while the resolver still routes... nothing new to it
        [svc] = [s for s in ttt_fleet.services if s.replica_name == victim]
        svc.request_drain()
        assert wait_for(lambda: not gw.ledger.sessions_on(victim), 20)
        stats = gw.stats()
        assert stats['handoffs'] >= 1 and stats['replayed_plies'] == 0
        for reply in replies:
            while not reply['done']:
                reply = client.play(reply['sid'], int(rng.choice(
                    reply['legal'])) if reply['to_move'] else None)
        stats = gw.stats()
        assert (stats['outcomes'], stats['dropped'], stats['mismatches']) \
            == (4, 0, 0)
    finally:
        client.close()
        gw.stop(drain=False)


@pytest.fixture
def lstm_fleet(tmp_path):
    """A fleet serving a 2-layer GeeseNetLSTM (filters 8) from the JAX
    package's snapshot."""
    from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
    from handyrl_tpu.models.geese import GeeseNetLSTM as JaxGeeseNetLSTM
    from handyrl_tpu_torch.model import ModelWrapper
    jw = JaxModelWrapper(JaxGeeseNetLSTM(filters=8, stem_layers=2), seed=5)
    jw.ensure_params(geese_plies(1)[0][0])
    pw = ModelWrapper.from_snapshot(jw.snapshot(), device='cpu')
    assert pw.module.stem_layers == 2
    fl = Fleet(tmp_path, pw.snapshot(), env='HungryGeese')
    try:
        yield fl
    finally:
        fl.close()


@pytest.mark.timeout(300)
@pytest.mark.parametrize('game', ['TicTacToe', 'HungryGeese'])
def test_a_reconstruct_is_byte_exact(game, request):
    """``_reconstruct`` rebuilds a session from its journal through the
    fleet: the same opponent actions and hidden digest (non-empty for the
    recurrent net), the rebuilt env's observation equal, play going on
    from it; a tampered digest is refused and the session dropped."""
    fl = request.getfixturevalue('ttt_fleet' if game == 'TicTacToe'
                                 else 'lstm_fleet')
    gw = _gateway(fl.root, fl.resolver.port)
    try:
        rng = random.Random(3)
        for seed in range(31, 64):     # a match still running after 3
            reply = gw._op_open({'env': game, 'seat': 0, 'client': 'rec',
                                 'seed': seed})
            sid = reply['sid']
            reply, _ = _play(gw, sid, reply, rng, plies=2 if game ==
                             'TicTacToe' else 3)
            if sid in gw._sessions:
                break
        session = gw._sessions[sid]
        if game == 'HungryGeese':
            assert sorted(session.hiddens) == [1, 2, 3]
            assert session.journal['hidden_digest'] != state_digest({})
        obs = np.asarray(session.env.observation(0)).copy()
        digest, draws, env = (session.journal['hidden_digest'],
                              session.draws, session.env)
        assert gw._reconstruct(session, gw._router())
        assert session.env is not env
        np.testing.assert_array_equal(np.asarray(
            session.env.observation(0)), obs)
        assert state_digest(session.hiddens) == digest
        assert session.draws == draws
        reply, _ = _play(gw, sid, reply, rng, plies=3)
        stats = gw.stats()
        assert stats['reconstructs'] == 1 and stats['replayed_plies'] > 0
        assert stats['mismatches'] == 0
        reply = gw._op_open({'env': game, 'seat': 0, 'client': 'tamper',
                             'seed': 37})
        tampered = gw._sessions[reply['sid']]
        tampered.journal['hidden_digest'] = '0' * 40
        assert not gw._reconstruct(tampered, gw._router())
        assert tampered.sid not in gw._sessions
        assert gw.stats()['mismatches'] == 1
        assert gw.stats()['dropped'] == 1
        assert gw.stats()['opened'] == int(sid[1:]) + 1
    finally:
        gw.stop(drain=False)


@pytest.mark.timeout(300)
def test_a_lost_replicas_sessions_are_rebuilt_by_the_monitor(lstm_fleet):
    """A replica goes silent (stopped in process: its heartbeats end): the
    resolver strands it, the gateway's monitor rebuilds its sessions from
    their journals through the survivor, and every match reaches its
    outcome with no drop and no mismatch."""
    fl = lstm_fleet
    gw = _gateway(fl.root, fl.resolver.port, workers=2).start()
    clients = [GatewayClient('127.0.0.1', gw.port, name='c%d' % i)
               for i in range(4)]
    try:
        replies = [c.open('HungryGeese', seed=40 + i)
                   for i, c in enumerate(clients)]
        rng = random.Random(2)
        for _ in range(3):
            replies = [c.play(r['sid'], int(rng.choice(r['legal'])))
                       if not r['done'] else r
                       for c, r in zip(clients, replies)]
        owners = {gw.ledger.replica_of(r['sid']) for r in replies
                  if not r['done']}
        victim = sorted(owners)[0]
        [svc] = [s for s in fl.services if s.replica_name == victim]
        svc.stop(drain=False)
        assert wait_for(lambda: gw.stats()['reconstructs'] >= 1, 30)
        for c, r in zip(clients, replies):
            while not r['done']:
                r = c.play(r['sid'], int(rng.choice(r['legal']))
                           if r['to_move'] else None)
        stats = gw.stats()
        assert stats['outcomes'] == 4
        assert (stats['dropped'], stats['mismatches']) == (0, 0)
        assert stats['ledger']['stranded'] >= 1
    finally:
        for c in clients:
            c.close()
        gw.stop(drain=False)


@pytest.mark.timeout(300)
def test_the_jax_gateway_client_gets_the_port_clients_replies(ttt_fleet):
    """Wire parity: the same session driven through two fresh port
    gateways, one by the port's GatewayClient and one by the JAX
    package's, answers the same bytes."""
    trails = []
    for client_cls in (GatewayClient, jax_gateway.GatewayClient):
        gw = _gateway(ttt_fleet.root, ttt_fleet.resolver.port).start()
        client = client_cls('127.0.0.1', gw.port, name='wire')
        try:
            rng = random.Random(9)
            reply = client.open('TicTacToe', seed=77)
            trail = [json.dumps({k: np.asarray(v).tolist()
                                 for k, v in sorted(reply.items())})]
            while not reply['done']:
                reply = client.play(reply['sid'],
                                    int(rng.choice(reply['legal'])))
                trail.append(json.dumps({k: np.asarray(v).tolist()
                                         if k == 'obs' else v
                                         for k, v in sorted(reply.items())},
                                        sort_keys=True))
            trail.append(sorted(s['sid'] for s in client.sessions()))
            status = client.status()
            trail.append((status['opened'], status['outcomes']))
            with pytest.raises((ServiceError, JaxServiceError),
                               match='unknown session'):
                client.play('s999999', 0)
            trails.append(trail)
        finally:
            client.close()
            gw.stop(drain=False)
    assert trails[0] == trails[1]


@pytest.mark.timeout(120)
def test_the_cli_runs_a_fleet_and_a_gateway_to_exit_75(tmp_path):
    """``python -m handyrl_tpu_torch.serving --fleet`` (no managed
    replicas) and ``--gateway`` over it print their ready lines and drain
    to 75 on SIGTERM."""
    env = dict(os.environ, OMP_NUM_THREADS='1')
    procs = []
    try:
        fleet = subprocess.Popen(
            [sys.executable, '-m', 'handyrl_tpu_torch.serving', '--fleet',
             '--replicas', '0', '--registry', str(tmp_path), '--device',
             'cpu'], cwd=REPO, stdout=subprocess.PIPE, text=True, env=env)
        procs.append(fleet)
        ready = json.loads(fleet.stdout.readline())['fleet_ready']
        assert ready['replicas'] == 0 and ready['device'] == 'cpu'
        gw = subprocess.Popen(
            [sys.executable, '-m', 'handyrl_tpu_torch.serving', '--gateway',
             '--resolver', '127.0.0.1:%d' % ready['port'], '--registry',
             str(tmp_path), '--max-sessions', '3', '--seed', '5'],
            cwd=REPO, stdout=subprocess.PIPE, text=True, env=env)
        procs.append(gw)
        gw_ready = json.loads(gw.stdout.readline())['gateway_ready']
        assert gw_ready['max_sessions'] == 3
        assert gw_ready['resolver'] == '127.0.0.1:%d' % ready['port']
        client = GatewayClient('127.0.0.1', gw_ready['port'])
        assert client.status()['sessions'] == 0
        client.close()
        for proc in (gw, fleet):
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=60) == 75
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
