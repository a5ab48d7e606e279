"""The network battle's entry points (handyrl_tpu_torch/evaluation.py
``eval_server_main``, ``eval_client_main``, ``client_mp_child``,
``_network_runner``) and the socket handover of
handyrl_tpu_torch/connection.py, on the CPU, on free ports (never 9876:
``network_match_port`` is patched).

One test starts processes: a TicTacToe server with two spawned runners,
each playing through the sockets of its group handed over to it, and two
in-process client loops whose four spawned children play the full-width
SimpleConv2dModel on ``--device cpu`` (one OpenMP thread each). Every game
is counted, each game's two outcomes sum to 0 exactly, and every child has
exited when its loop returns. The rest runs in threads: the read-ahead
that a handover must carry (env_args and the first command in one write),
a client lost mid-game (its socket closed, as a killed child's is) ending
the server with an error naming the seat, inline and from a runner, and a
connection whose env_args never come getting no child."""

import json
import os
import queue
import re
import socket
import threading
import time
from multiprocessing.reduction import ForkingPickler

import pytest
import torch

from handyrl_tpu_torch import connection, evaluation
from handyrl_tpu_torch.agent import RandomAgent
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.model import params_bytes
from handyrl_tpu_torch.models.tictactoe import SimpleConv2dModel


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


ENV = {'env': 'TicTacToe'}


def free_port():
    s = socket.socket()
    s.bind(('', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def wait_listening(port, timeout=30.0):
    """Until a socket listens on ``port`` (the kernel's tables; a probe
    connection would be accepted as a client)."""
    needle = ':%04X ' % port
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for table in ('/proc/net/tcp', '/proc/net/tcp6'):
            with open(table) as f:
                if any(needle in l and l.split()[3] == '0A' for l in f):
                    return
        time.sleep(0.02)
    raise TimeoutError('nothing listens on port %d' % port)


@pytest.fixture
def port(monkeypatch):
    p = free_port()
    monkeypatch.setattr(evaluation, 'network_match_port', p)
    return p


@pytest.fixture(scope='module')
def ckpt(tmp_path_factory):
    torch.manual_seed(5)
    path = str(tmp_path_factory.mktemp('net_cli') / 'ttt.ckpt')
    with open(path, 'wb') as f:
        f.write(params_bytes(SimpleConv2dModel()))
    return path


def frame(msg):
    payload = connection.pack(msg)
    return connection._HEADER.pack(len(payload)) + payload


def test_server_runners_and_client_children_in_spawned_processes(
        port, ckpt, capfd):
    games = 6
    result = {}

    def server():
        result['t'] = evaluation.eval_server_main({'env_args': ENV},
                                                  [str(games), '2'])
    st = threading.Thread(target=server, daemon=True)
    st.start()
    wait_listening(port)
    codes = []
    clients = [threading.Thread(target=lambda: codes.append(
        evaluation.eval_client_main({}, [ckpt, '127.0.0.1'], device='cpu')),
        daemon=True) for _ in range(2)]
    for c in clients:
        c.start()
    for t in [st] + clients:
        t.join(timeout=240)
        assert not t.is_alive()
    assert codes == [0, 0]
    t = result['t']
    assert len(t._procs) == 2 and all(p.exitcode == 0 for p in t._procs)
    assert sum(t.overall[0].values()) == sum(t.overall[1].values()) == games
    out = capfd.readouterr().out
    for line in ('network match server mode', '2 process, %d games' % games,
                 'total games = %d' % games, '---agent 1---',
                 'network match client mode'):
        assert line in out
    reports = {int(pid): json.loads(body) for pid, body in
               re.findall(r'client child \(pid (\d+)\): (\{.*\})', out)}
    assert len(reports) == 4   # two groups of two, a child a connection
    assert all(r['device'] == 'cpu' and r['start_seconds'] > 0
               for r in reports.values())
    # the children of one group played the same games: pair them by
    # outcomes that sum to 0 game by game
    lists = sorted((r['outcomes'] for r in reports.values()), key=len)
    assert sum(len(o) for o in lists) == 2 * games
    unpaired = list(lists)
    while unpaired:
        a = unpaired.pop()
        b = next(o for o in unpaired if len(o) == len(a) and all(
            x + y == 0 for x, y in zip(a, o)))
        unpaired.remove(b)
    for pid in reports:   # joined: no child outlives its client loop
        with pytest.raises(OSError):
            os.kill(pid, 0)


def test_a_handover_carries_the_read_ahead(port):
    listener = connection.open_socket_connection(port)
    listener.listen(1)
    conn = connection.connect_socket_connection('localhost', port)
    peer, _ = listener.accept()
    listener.close()
    update = ('update', ['', True])
    third = frame(('action', [0]))
    # env_args, the first command and part of a third frame in one write
    peer.sendall(frame(ENV) + frame(update) + third[:3])
    assert conn.recv() == ENV
    while not conn._parser._buf:   # the whole write has been read
        assert conn.poll(5.0)
        conn._ready.extend(conn._parser.feed(conn.sock.recv(1 << 16)))
    moved = ForkingPickler.loads(bytes(ForkingPickler.dumps(
        conn.handover())))   # the socket duplicated, as into a child
    conn.close()
    child = moved.open()
    child.sock.settimeout(10.0)   # a lost read-ahead fails, not hangs
    assert child.recv() == ['update', ['', True]]
    peer.sendall(third[3:])
    assert child.recv() == ['action', [0]]
    child.send('A1')
    got = connection.FramedConnection(peer)
    assert got.recv() == 'A1'
    child.close()
    got.close()


def _play(port, die_after=None):
    """A client thread's body: RandomAgent, or a client whose socket
    closes after ``die_after`` commands, as a killed child's does."""
    conn = connection.connect_socket_connection('localhost', port)
    env = make_env(conn.recv())
    if die_after is None:
        evaluation.NetworkAgentClient(RandomAgent(), env, conn).run()
        return
    client = evaluation.NetworkAgentClient(RandomAgent(), env, conn)
    for _ in range(die_after):
        command, args = conn.recv()
        conn.send(client._execute(command, list(args)))
    conn.close()


def test_a_lost_client_ends_the_inline_server_naming_the_seat(port):
    st = {}

    def server():
        try:
            evaluation.eval_server_main({'env_args': ENV}, ['4', '1'])
        except evaluation.LostClient as exc:
            st['error'] = str(exc)
    t = threading.Thread(target=server, daemon=True)
    t.start()
    wait_listening(port)
    clients = [threading.Thread(target=_play, args=(port,), daemon=True),
               threading.Thread(target=_play, args=(port, 2), daemon=True)]
    for c in clients:
        c.start()
    for c in [t] + clients:
        c.join(timeout=60)
        assert not c.is_alive()   # the other client ended on the reset
    assert re.search(r'runner 0, game 0: lost the client in seat [01]',
                     st['error']), st


def test_a_runner_relays_a_lost_client_to_the_server(port):
    listener = connection.open_socket_connection(port)
    listener.listen(2)
    threads = [threading.Thread(target=_play, args=(port, k), daemon=True)
               for k in (None, 3)]
    for c in threads:
        c.start()
    socks = [connection.FramedConnection(listener.accept()[0])
             for _ in threads]
    listener.close()
    for c in socks:
        c.send(ENV)
    jobs, results = queue.Queue(), queue.Queue()
    jobs.put((0, [0, 1], 'default-F', {}))
    jobs.put(None)
    with pytest.raises(evaluation.LostClient):
        evaluation._network_runner([c.handover() for c in socks], ENV, 0,
                                   jobs, results, 1)
    for c in socks:
        c.close()
    for c in threads:
        c.join(timeout=30)
    message = results.get_nowait()
    assert re.search(r'runner 0, game 0: lost the client in seat [01]',
                     message)
    tournament = evaluation.Tournament(make_env(ENV), [None, None], None,
                                       ENV, {'default': {}}, 2, 1, 0)
    tournament.results = queue.Queue()
    tournament.results.put(message)
    with pytest.raises(evaluation.LostClient, match='seat'):
        tournament.collect()


def test_a_connection_without_env_args_gets_no_child(port, ckpt, capfd):
    # refused at once: nothing listens
    assert evaluation.eval_client_main({}, [ckpt, '127.0.0.1'],
                                       device='cpu') == 0
    listener = connection.open_socket_connection(port)
    listener.listen(1)

    def reset_one():
        peer, _ = listener.accept()
        peer.close()          # closed before any env_args
        listener.close()
    t = threading.Thread(target=reset_one, daemon=True)
    t.start()
    assert evaluation.eval_client_main({}, [ckpt, '127.0.0.1'],
                                       device='cpu') == 0
    t.join(timeout=10)
    assert 'client child' not in capfd.readouterr().out
