"""The training server's task booking around a peer's detach
(handyrl_tpu_torch/train.py ``Learner.server``).

A peer's last request and its EOF can both be waiting when the server
loop comes round: the loop handles the detach first (the ledger re-issues
what the peer held), then reads the request from its inbox. Booking a
task on that dead endpoint would leave it outstanding for the rest of the
run (no detach is left to re-issue it), and the dead socket would file
the peer under a new host ('host-unknown'). The server books nothing for
it; a live peer's request in the same loop is served as ever. A fake hub
feeds the loop exactly that order."""

import os
import queue
import threading

import pytest
import torch

from handyrl_tpu_torch.config import apply_defaults
from handyrl_tpu_torch.models.tictactoe import SimpleConv2dModel
from handyrl_tpu_torch.train import Learner


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread, as every port test file runs."""
    before, omp = torch.get_num_threads(), os.environ.get('OMP_NUM_THREADS')
    torch.set_num_threads(1)
    os.environ['OMP_NUM_THREADS'] = '1'
    yield
    torch.set_num_threads(before)
    if omp is None:
        os.environ.pop('OMP_NUM_THREADS', None)
    else:
        os.environ['OMP_NUM_THREADS'] = omp


class _Peer:
    """A pipe-like endpoint (no socket): the server keys it by fileno."""

    def __init__(self, fd):
        self.fd = fd

    def fileno(self):
        return self.fd


class _Hub:
    """The WorkerServer surface the server loop reads, scripted."""

    def __init__(self):
        self.inbox = queue.Queue()
        self.events = []
        self.sent = []
        self.open = 2
        self.served = threading.Event()

    def connection_count(self):
        return self.open

    def lost(self, shutdown):
        return None

    def drain_detach_events(self):
        events, self.events = self.events, []
        return events

    def peer_info(self):
        return {}    # no beacons: no soft faults

    def recv(self, timeout=None):
        return self.inbox.get(timeout=timeout)

    def send(self, endpoint, msg):
        self.sent.append((endpoint, msg))
        self.served.set()

    def close(self, timeout=None):
        pass


@pytest.mark.timeout(60)
def test_a_detached_peers_queued_request_books_no_task(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv('HANDYRL_TPU_ENTRY_PORT', '0')
    monkeypatch.setenv('HANDYRL_TPU_DATA_PORT', '0')
    args = apply_defaults({
        'env_args': {'env': 'TicTacToe'},
        'train_args': {'minimum_episodes': 1000, 'update_episodes': 1000,
                       'seed': 5, 'model_dir': str(tmp_path / 'models')}})
    net = SimpleConv2dModel(generator=torch.Generator().manual_seed(8))
    learner = Learner(args, net=net, device='cpu', remote=True)
    real, hub = learner.worker, _Hub()
    learner.worker = hub
    dead, live = _Peer(101), _Peer(102)
    # the dead peer's request is already in the inbox with its EOF pending
    hub.inbox.put((dead, ('args', [None, None])))
    hub.events.append((dead, 'read_error', 0.0))
    hub.inbox.put((live, ('args', [None])))
    thread = threading.Thread(target=learner.server, daemon=True)
    thread.start()
    try:
        assert hub.served.wait(30)
        booked = learner.ledger.outstanding_by_endpoint()
        assert booked.get(dead, 0) == 0
        assert booked.get(live) == 1
        assert [ep for ep, _ in hub.sent] == [live]
        assert list(learner.fleet.snapshot()) == ['local-102']
    finally:
        hub.open = 0
        learner.shutdown_flag = True
        thread.join(30)
        learner.shutdown()
        real.close()
    assert not thread.is_alive()
