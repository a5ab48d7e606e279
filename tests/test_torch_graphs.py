"""``ops/graphs.CapturedCall`` and the lifetime of its owners' graphs, on
the CPU.

A ``CapturedCall`` holds a bound method weakly, so an owner that keeps
its call forms no reference cycle with it: dropping the owner frees the
call (and on the card its CUDA graph) by reference count at once, with
Python's cyclic collector off, never later inside another graph's
capture. Held for a generic owner and for each owner the port has that
is built here at a small size: the split ``DeviceGenerator`` (its call
takes an argument), the ``DeviceEvaluator`` and the ``FusedPipeline``
with its ``ReplayUpdateStep``. On the CPU a call runs ``fn(*args)``
eagerly each time; that is held too.
"""

import gc
import os
import weakref

import pytest
import torch

from handyrl_tpu_torch import device_generation as dg
from handyrl_tpu_torch.envs import torch_tictactoe as tt
from handyrl_tpu_torch.models.tictactoe import SimpleConv2dModel
from handyrl_tpu_torch.ops import losses, train_step
from handyrl_tpu_torch.ops.device_windows import DeviceWindower
from handyrl_tpu_torch.ops.fused_pipeline import FusedPipeline
from handyrl_tpu_torch.ops.graphs import CapturedCall

pytestmark = pytest.mark.timeout(120)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    before, omp = torch.get_num_threads(), os.environ.get('OMP_NUM_THREADS')
    torch.set_num_threads(1)
    os.environ['OMP_NUM_THREADS'] = '1'
    yield
    torch.set_num_threads(before)
    if omp is None:
        os.environ.pop('OMP_NUM_THREADS', None)
    else:
        os.environ['OMP_NUM_THREADS'] = omp


@pytest.fixture
def no_cyclic_collector():
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def _dropped(make, calls_of):
    """Build an owner, call it, drop it; the weak references to it and to
    its ``CapturedCall``s, which must be dead with the collector off."""
    owner = make()
    calls = calls_of(owner)
    assert calls and all(isinstance(c, CapturedCall) for c in calls)
    refs = [weakref.ref(owner)] + [weakref.ref(c) for c in calls]
    del owner, calls
    return refs


class _Owner:
    def __init__(self):
        self.n = 0
        self.call = CapturedCall(self.step, 'cpu', args=(3,))

    def step(self, k):
        self.n += k
        return self.n


def test_a_call_runs_its_method_with_its_args_on_the_cpu():
    owner = _Owner()
    assert [owner.call() for _ in range(3)] == [3, 6, 9]
    assert owner.call.calls == 3 and owner.call.captures == 0
    assert owner.call.graph is None
    seen = []
    call = CapturedCall(lambda *a: seen.append(a) or len(seen), 'cpu',
                        args=('x', 1))
    assert call() == 1 and call() == 2 and seen == [('x', 1)] * 2


def test_a_dropped_owner_frees_its_call_without_the_collector(
        no_cyclic_collector):
    def make():
        owner = _Owner()
        owner.call()
        return owner
    for ref in _dropped(make, lambda o: [o.call]):
        assert ref() is None


def _net():
    return SimpleConv2dModel(filters=8, layers=1,
                             generator=torch.Generator().manual_seed(0))


def _generator():
    gen = dg.DeviceGenerator(tt, _net(), {'observation': False,
                                          'gamma': 0.8},
                             n_envs=4, chunk_steps=3, seed=1)
    gen._dispatch(True)     # the full records' call and the accounting's
    gen._dispatch(False)
    return gen


def _evaluator():
    ev = dg.DeviceEvaluator(tt, _net(), {}, n_envs=4, chunk_steps=3, seed=1,
                            opponents=['random'])
    ev.step()
    return ev


def _fused():
    net = _net()
    cfg = losses.LossConfig(turn_based_training=True, observation=False,
                            policy_target='TD', value_target='TD')
    step = train_step.ReplayUpdateStep(net, cfg,
                                       train_step.init_train_state(net))
    windower = DeviceWindower(mode='turn', fs=4, bi=0,
                              max_steps=tt.MAX_STEPS, windows_cap=2,
                              capacity=32, num_players=tt.NUM_PLAYERS,
                              gamma=0.8, has_reward=False)
    fp = FusedPipeline(tt, net, step, windower, n_envs=4, chunk_steps=3,
                       sgd_steps=1, batch_size=2, seed=1)
    for _ in range(2):
        fp._chunk()
    return fp


@pytest.mark.parametrize('make,calls_of', [
    (_generator, lambda g: list(g._calls.values())),
    (_evaluator, lambda e: [e._call]),
    (_fused, lambda f: [f._chunk, f.update_step._call]),
], ids=['DeviceGenerator', 'DeviceEvaluator', 'FusedPipeline'])
def test_the_port_owners_free_their_calls_without_the_collector(
        make, calls_of, no_cyclic_collector):
    for ref in _dropped(make, calls_of):
        assert ref() is None
