"""The learner's resilience pieces of the port (handyrl_tpu_torch/guard.py,
fault.parse_chaos) against the JAX package's (handyrl_tpu/guard.py), on
the inputs of tests/test_guard.py:35-60,175-208.

Checked: the supervisor exit code; the preemption flag on a real SIGTERM
(and the handlers restored after), the guard when disabled; ChaosNaN's
burst budget and its fused-dispatch ranges give the same ``due`` sequence
as the JAX class on the same calls (exact: booleans); ``parse_chaos``
reads the same dict from the same specs; ``arm_chaos_preempt`` arms a
timer only when ``preempt`` is set. No tolerance: every value compared
is an integer, a boolean or a parsed float of the same text."""

import os
import signal
import time

import pytest

from handyrl_tpu import guard as jax_guard
from handyrl_tpu.fault import parse_chaos as jax_parse_chaos
from handyrl_tpu_torch import guard
from handyrl_tpu_torch.fault import parse_chaos

pytestmark = pytest.mark.timeout(60)   # each test's own limit


def test_preempt_exit_code_is_the_supervisor_contract():
    assert guard.PREEMPT_EXIT_CODE == jax_guard.PREEMPT_EXIT_CODE == 75


def test_preempt_guard_sets_flag_on_sigterm():
    pg = guard.PreemptionGuard().install()
    try:
        assert not pg.requested() and not pg.fired
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 5
        while not pg.requested() and time.time() < deadline:
            time.sleep(0.01)
        assert pg.requested() and pg.fired
        assert pg.signum == signal.SIGTERM
    finally:
        pg.uninstall()
    assert signal.getsignal(signal.SIGTERM) is not pg._handle


def test_preempt_guard_disabled_never_installs():
    before = signal.getsignal(signal.SIGTERM)
    pg = guard.PreemptionGuard(enabled=False).install()
    assert not pg._previous and not pg.fired
    assert signal.getsignal(signal.SIGTERM) is before
    pg.uninstall()


# the (step, count) calls of tests/test_guard.py:186-200, and a longer
# sequence with a nanepoch arm, a rollback rewind and fused ranges
DUE_CASES = [
    ({'nanstep': 10, 'nanburst': 3}, None,
     [(8, 1), (10, 1), (11, 1), (12, 1), (13, 1), (10, 1)]),
    ({'nanstep': 10, 'nanburst': 2}, None, [(0, 8), (8, 8), (16, 8)]),
    ({'nanepoch': 2, 'nanburst': 4}, 37,
     [(30, 4), (34, 4), (38, 4), (42, 1), (36, 2), (44, 64)]),
    ({'nanstep': 0}, None, [(0, 64), (64, 64)]),
    ({}, 5, [(0, 1), (5, 1), (6, 64)]),
]


@pytest.mark.parametrize('chaos,arm_at,calls', DUE_CASES)
def test_chaos_nan_due_sequence_matches_jax(chaos, arm_at, calls):
    ours, ref = guard.ChaosNaN(dict(chaos)), jax_guard.ChaosNaN(dict(chaos))
    if arm_at is not None:
        ours.arm(arm_at)
        ref.arm(arm_at)
    got = [ours.due(step, count) for step, count in calls]
    want = [ref.due(step, count) for step, count in calls]
    assert got == want
    assert (ours.at, ours.epoch, ours.burst, ours.remaining) == (
        ref.at, ref.epoch, ref.burst, ref.remaining)


def test_chaos_nan_consumes_its_burst():
    c = guard.ChaosNaN({'nanstep': 10, 'nanburst': 3})
    assert not c.due(8)
    assert c.due(10)
    assert c.due(11) and c.due(12)
    assert not c.due(13)
    assert not c.due(10)           # a rollback rewind must not re-trigger


def test_chaos_nan_covers_fused_dispatch_ranges():
    c = guard.ChaosNaN({'nanstep': 10, 'nanburst': 2})
    assert not c.due(0, count=8)
    assert c.due(8, count=8)
    assert not c.due(16, count=8)


@pytest.mark.parametrize('spec', [
    '', 'preempt=12', 'nanstep=40,nanburst=3', ' nanepoch = 2 , nanburst=8 ',
    'preempt=oops,nanstep=5', 'preempt=0.5,,nanstep=1'])
def test_parse_chaos_matches_jax(spec, monkeypatch):
    assert parse_chaos(spec) == jax_parse_chaos(spec)
    monkeypatch.setenv('HANDYRL_TPU_CHAOS', spec)
    assert parse_chaos() == jax_parse_chaos()
    assert guard.ChaosNaN().remaining == jax_guard.ChaosNaN().remaining


def test_arm_chaos_preempt_only_when_asked():
    assert guard.arm_chaos_preempt({}) is None
    assert guard.arm_chaos_preempt({'nanstep': 3.0}) is None
    timer = guard.arm_chaos_preempt({'preempt': 3600.0})
    try:
        assert timer is not None and timer.daemon and timer.is_alive()
    finally:
        timer.cancel()
