"""Kernel launch counts under threads (handyrl_tpu_torch/ops/launches.py).

The learner counts launches by path while its generator (main thread) and
its trainer thread launch at once, and autograd runs a CUDA backward on a
thread of its own: counts of concurrent paths must not be lost or mixed,
the trunk's backward must count under its forward's path whatever thread
runs it, and a forward on the card must wait while a CUDA graph is being
captured (``capture_lock``). On the CPU no wrapper counts, so these tests
count through ``launches.count`` directly or through a counting stand-in
for the backward wrapper."""

import sys
import threading

import numpy as np
import torch

from handyrl_tpu_torch.model import ModelWrapper
from handyrl_tpu_torch.models.geese import GeeseNet
from handyrl_tpu_torch.ops import geese_trunk, kernel_launches, launches


def _join(threads, timeout=60):
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)


def test_concurrent_paths_lose_no_count():
    launches.reset()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    n, names = 3000, ('generation', 'evaluation', 'training', 'main')
    try:
        def worker(name):
            with launches.path(name):
                for _ in range(n):
                    launches.count('geese_trunk')
                    launches.count('td_lambda')
        threads = [threading.Thread(target=worker, args=(name,))
                   for name in names for _ in range(4)]
        for t in threads:
            t.start()
        _join(threads)
    finally:
        sys.setswitchinterval(interval)
    try:
        for name in names:
            assert kernel_launches(name)['geese_trunk'] == 4 * n
            assert kernel_launches(name)['td_lambda'] == 4 * n
        assert kernel_launches()['geese_trunk'] == 4 * n * len(names)
        assert launches.current_path() == launches.DEFAULT_PATH
    finally:
        launches.reset()


def test_backward_counts_under_the_forward_path(monkeypatch):
    """Autograd may run the backward on another thread (its CUDA worker):
    the launch goes to the path the forward ran under."""
    real = geese_trunk.trunk_backward

    def counting_backward(*args, **kwargs):
        launches.count('geese_trunk_bwd')
        return real(*args, **kwargs)
    monkeypatch.setattr(geese_trunk, 'trunk_backward', counting_backward)
    net = GeeseNet(filters=16, layers=2, torus_impl='pallas',
                   generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(0).rand(
        3, 17, 7, 11).astype(np.float32))
    out = {}

    def forward():
        with launches.path('training'):
            out['y'] = net(x)['value'].sum()

    def backward():
        with launches.path('elsewhere'):
            out['y'].backward()
    launches.reset()
    try:
        for fn in (forward, backward):
            t = threading.Thread(target=fn)
            t.start()
            _join([t])
        assert kernel_launches('training')['geese_trunk_bwd'] == 1
        assert kernel_launches('elsewhere')['geese_trunk_bwd'] == 0
        assert net.block_w.grad is not None
    finally:
        launches.reset()


def test_forward_waits_for_a_capture():
    net = GeeseNet(filters=16, layers=2, torus_impl='pallas',
                   generator=torch.Generator().manual_seed(1))
    wrapper = ModelWrapper(net, device='cpu')
    obs = np.random.RandomState(1).rand(8, 17, 7, 11).astype(np.float32)
    done = threading.Event()

    def forward():
        wrapper.batch_inference(obs)
        done.set()
    with launches.capture_lock:     # as GraphedUpdateStep._capture holds it
        t = threading.Thread(target=forward)
        t.start()
        assert not done.wait(0.5)
    assert done.wait(60)
    _join([t])
