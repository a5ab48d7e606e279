"""The worker plane's task ledger and fleet controller
(handyrl_tpu_torch/fault.py) against the JAX package's
(handyrl_tpu/fault.py).

Both classes are pure Python on an injectable clock: each script below
drives the JAX object and the port's through the same calls under one
fake clock and compares every output and the stats after each call,
exactly (no arithmetic but counting)."""

import copy
import os

import pytest
import torch

from handyrl_tpu import fault as jax_fault
from handyrl_tpu_torch import fault


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


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class Twin:
    """Calls a method on the JAX object and the port's and asserts equal
    outputs (and equal stats after the call)."""

    def __init__(self, jax_obj, port_obj):
        self.objs = (jax_obj, port_obj)

    def __getattr__(self, name):
        def call(*args, **kwargs):
            outs = [getattr(o, name)(*copy.deepcopy(args), **kwargs)
                    for o in self.objs]
            assert outs[0] == outs[1], (name, outs)
            assert self.objs[0].stats == self.objs[1].stats, name
            return outs[1]
        return call


def _task(role, key):
    return {'role': role, 'player': [0, 1], 'sample_key': key,
            'model_id': {0: 3, 1: 3 if role == 'g' else -1}}


def test_ledger_assign_admit_duplicates_and_reissue_order():
    clock = Clock()
    led = Twin(jax_fault.TaskLedger(deadline=30.0, clock=clock),
               fault.TaskLedger(deadline=30.0, clock=clock))
    tasks = {}
    for i, (ep, role) in enumerate([('a', 'g'), ('a', 'e'), ('b', 'g'),
                                    ('b', 'g'), ('c', 'g')]):
        t = _task(role, i)
        assert led.assign(ep, t) == i
        tasks[i] = dict(t, task_id=i)   # as the stamped task went out
        clock.t += 1.0
    assert led.outstanding() == 5
    assert led.outstanding_by_endpoint() == {'a': 2, 'b': 2, 'c': 1}
    # an upload completes its task; its resend is a duplicate, dropped
    ep0 = {'args': dict(tasks[0]), 'steps': 3}
    assert len(led.admit([ep0, None, {'args': {'role': 'g'}}])) == 3
    assert led.admit([ep0]) == []
    # a detached endpoint strands its tasks, re-issued in order, verbatim
    assert led.fail_endpoint('b') == 2
    assert led.fail_endpoint('b') == 0
    assert led.pending_reissue() == 2
    # past the deadline: the rest of 'a' and all of 'c'
    clock.t += 40.0
    assert led.reap() == 2
    events = led.drain_stranding_events()
    assert [(e[0], e[1]) for e in events] == [
        ('b', 'detach'), ('b', 'detach'), ('a', 'deadline'),
        ('c', 'deadline')]
    assert led.drain_stranding_events() == []
    order = []
    while True:
        t = led.next_reissue()
        if t is None:
            break
        order.append(t['sample_key'])
        assert 'task_id' not in t
    assert order == [2, 3, 1, 4]
    # a late upload of a stranded task is a duplicate too
    assert led.admit([{'args': dict(tasks[2])}]) == []
    # re-issued work books fresh ids on its new endpoint
    assert led.assign('d', _task('g', 2)) == 5
    assert led.outstanding_by_endpoint() == {'d': 1}
    assert led.outstanding() == 1


def test_fleet_controller_walks_the_same_states():
    clock = Clock()
    kw = dict(degrade_after=1, quarantine_after=3, health_window=120.0,
              quarantine_period=60.0, clock=clock)
    fc = Twin(jax_fault.FleetController(**kw), fault.FleetController(**kw))
    for host in ('host-a', 'host-b', 'local-7'):
        assert fc.observe(host) is True
    assert fc.observe('host-a') is False
    fc.record_soft_fault('host-b')             # healthy -> degraded
    assert fc.state('host-b') == 'degraded' and fc.admits('host-b')
    clock.t += 121.0
    fc.tick({})                                # a quiet window: healthy
    assert fc.state('host-b') == 'healthy'
    fc.record_stranding('host-a', 2)           # degraded (2 < 3)
    assert fc.state('host-a') == 'degraded'
    clock.t += 5.0
    fc.record_stranding('host-a')              # 3 in the window: draining
    assert fc.state('host-a') == 'draining' and not fc.admits('host-a')
    fc.tick({'host-a': 2})                     # booked work still open
    assert fc.state('host-a') == 'draining'
    fc.tick({'host-a': 0})                     # drained: quarantined
    assert fc.state('host-a') == 'quarantined'
    clock.t += 59.0
    fc.tick({})
    assert fc.state('host-a') == 'quarantined'
    clock.t += 2.0
    fc.tick({})                                # re-admitted, history cleared
    assert fc.state('host-a') == 'healthy' and fc.admits('host-a')
    fc.record_stranding('host-a')
    assert fc.state('host-a') == 'degraded'
    fc.snapshot()
    fc.counts()
    transitions = fc.drain_transitions()
    assert [(h, a, b) for h, a, b, _t in transitions] == [
        ('host-b', 'healthy', 'degraded'), ('host-b', 'degraded', 'healthy'),
        ('host-a', 'healthy', 'degraded'), ('host-a', 'degraded', 'draining'),
        ('host-a', 'draining', 'quarantined'),
        ('host-a', 'quarantined', 'healthy'),
        ('host-a', 'healthy', 'degraded')]
    assert fc.drain_transitions() == []


def test_ledger_and_fleet_together_as_the_server_feeds_them():
    """The server's pump: strandings of a detached endpoint feed the
    host's health, outstanding work gates the quarantine."""
    clock = Clock()
    outs = []
    for mod in (jax_fault, fault):
        led = mod.TaskLedger(deadline=300.0, clock=clock)
        fc = mod.FleetController(quarantine_after=3, clock=clock)
        for i in range(4):
            led.assign('ep1', _task('g', i))
        led.assign('ep2', _task('g', 9))
        led.fail_endpoint('ep1')
        for ep, _reason, _t in led.drain_stranding_events():
            fc.record_stranding({'ep1': 'host-x', 'ep2': 'host-y'}[ep])
        by_host = {{'ep1': 'host-x', 'ep2': 'host-y'}[ep]: n
                   for ep, n in led.outstanding_by_endpoint().items()}
        fc.tick(by_host)
        outs.append((led.stats, fc.stats, fc.snapshot(), fc.counts(),
                     by_host, led.pending_reissue()))
        clock.t = 1000.0
    assert outs[0] == outs[1]
    assert outs[1][2] == {'host-x': 'quarantined'}
