"""The port's Hub as the worker plane uses it (handyrl_tpu_torch/
connection.py), beside the JAX package's (handyrl_tpu/connection.py):
heartbeat frames refresh a peer's deadline and land in
``peer_info_snapshot``, never in the inbox, and stay readable after the
peer detaches (``departed_peer_info``: a worker's last beacon comes just
before its pipe closes); every detach is journaled once; a silent socket
peer is detached after its liveness deadline; ``PipeEndpoint.drain``
reads a spawned child's pipe. The heartbeat frame is the JAX package's
on the wire: a JAX client's beacon is filtered the same way."""

import os
import socket
import time

import pytest
import torch

from handyrl_tpu import connection as jax_connection
from handyrl_tpu_torch.connection import (HEARTBEAT_KIND, FramedConnection,
                                          Hub, PipeEndpoint, is_heartbeat,
                                          spawn_pipe_workers)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The workers of a parallel test run share the cores: one intra-op
    thread a process (and in the processes a test starts, through
    OMP_NUM_THREADS)."""
    before, omp = torch.get_num_threads(), os.environ.get('OMP_NUM_THREADS')
    torch.set_num_threads(1)
    os.environ['OMP_NUM_THREADS'] = '1'
    yield
    torch.set_num_threads(before)
    if omp is None:
        os.environ.pop('OMP_NUM_THREADS', None)
    else:
        os.environ['OMP_NUM_THREADS'] = omp


def _pair():
    a, b = socket.socketpair()
    return FramedConnection(a), FramedConnection(b)


def _wait(cond, timeout=10.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.02)
    return cond()


def test_heartbeat_kind_is_the_jax_packages():
    assert HEARTBEAT_KIND == jax_connection.HEARTBEAT_KIND
    assert is_heartbeat((HEARTBEAT_KIND, {}))
    assert is_heartbeat([HEARTBEAT_KIND, {}])   # as a socket hop delivers it
    assert not is_heartbeat(('args', None))


def test_heartbeats_stay_out_of_the_inbox_and_outlive_the_detach():
    hub = Hub()
    ep, client = _pair()
    hub.attach(ep, liveness=1.5)
    for i in range(5):             # 2 s of beacons > the 1.5 s deadline
        client.send((HEARTBEAT_KIND, {'gather': 3, 'seq': i}))
        time.sleep(0.4)
    assert hub.count() == 1        # the beacons kept it alive
    client.send(('args', [None, None]))
    _ep, msg = hub.recv(timeout=5)
    assert msg == ['args', [None, None]]   # beacons were filtered out
    assert hub.peer_info_snapshot()[ep] == {'gather': 3, 'seq': 4}
    assert hub.stats_snapshot()['heartbeats'] == 5
    # a JAX client's beacon is the same frame
    jax_client = jax_connection.FramedConnection(client.sock)
    jax_client.send((jax_connection.HEARTBEAT_KIND, {'gather': 3, 'seq': 5}))
    assert _wait(lambda: hub.peer_info_snapshot()[ep]['seq'] == 5)
    client.close()                 # the peer's last beacon survives
    assert _wait(lambda: hub.count() == 0)
    assert hub.peer_info_snapshot() == {}
    assert hub.departed_peer_info() == {ep: {'gather': 3, 'seq': 5}}
    events = hub.drain_detach_events()
    assert [(e[0], e[1]) for e in events] == [(ep, 'read_error')]
    assert hub.drain_detach_events() == []
    stats = hub.stats_snapshot()
    assert stats['detached'] == 1 and stats['disconnect_read_error'] == 1
    hub.close()


def test_silent_socket_peer_is_detached_after_the_liveness_timeout(
        monkeypatch):
    monkeypatch.setattr(Hub, 'LIVENESS_TIMEOUT', 1.0)
    hub = Hub()
    ep, client = _pair()
    hub.attach(ep)                 # a socket: the default deadline applies
    client.send({'hello': 1})
    hub.recv(timeout=5)
    t0 = time.time()
    assert _wait(lambda: hub.count() == 0)   # then silent, socket open
    assert 0.9 < time.time() - t0 < 5.0
    events = hub.drain_detach_events()
    assert len(events) == 1
    assert events[0][0] is ep and events[0][1] == 'heartbeat_miss'
    assert hub.stats_snapshot()['disconnect_heartbeat_miss'] == 1
    hub.detach(ep)                 # a second detach counts nothing
    assert hub.stats_snapshot()['detached'] == 1
    client.close()
    hub.close()


def test_pipes_carry_no_deadline():
    hub = Hub()
    ep, _client = _pair()
    hub.attach(ep)
    assert hub._liveness[ep] == Hub.LIVENESS_TIMEOUT

    class _Pipe:
        def fileno(self):
            return -1

        def close(self):
            pass
    pipe = _Pipe()
    hub.attach(pipe)
    assert hub._liveness[pipe] == 0.0
    hub.close()


def _child(conn, index):
    """A spawned child: three messages, a beacon, then exit."""
    for i in range(3):
        conn.send(('episode', {'child': index, 'n': i}))
    conn.send((HEARTBEAT_KIND, {'worker': index, 'seq': 1}))
    conn.close()


@pytest.mark.timeout(120)
def test_pipe_endpoint_drains_a_spawned_child():
    hub = Hub()
    procs = []
    for proc, ep in spawn_pipe_workers(2, _child, lambda i, c: (c, i)):
        assert isinstance(ep, PipeEndpoint)
        procs.append(proc)
        hub.attach(ep)
    msgs = [hub.recv(timeout=60)[1] for _ in range(6)]
    got = sorted((m[1]['child'], m[1]['n']) for m in msgs)
    assert got == [(c, n) for c in (0, 1) for n in range(3)]
    assert all(m[0] == 'episode' for m in msgs)
    assert _wait(lambda: hub.count() == 0, timeout=60)
    for proc in procs:
        proc.join(30)
        assert proc.exitcode == 0
    beacons = sorted(b['worker'] for b in hub.departed_peer_info().values())
    assert beacons == [0, 1]
    assert len(hub.drain_detach_events()) == 2
    hub.close()


@pytest.mark.timeout(120)
def test_the_gathers_module_imports_no_torch():
    """A gather process imports ``handyrl_tpu_torch.worker`` (its entry
    point's module) and nothing of torch: gathers relay bytes and never
    touch the card; a worker imports torch inside ``open_worker``."""
    import subprocess
    import sys
    probe = ('import sys, handyrl_tpu_torch.worker as w; '
             'assert "torch" not in sys.modules, "torch imported"; '
             'print(w.gather_loop.__module__)')
    out = subprocess.run([sys.executable, '-c', probe], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == 'handyrl_tpu_torch.worker'
