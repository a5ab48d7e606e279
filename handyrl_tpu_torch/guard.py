"""Learner and service resilience: the subset of ``handyrl_tpu/guard.py``
the serving path and the local learner use.

* :class:`PreemptionGuard`: SIGTERM/SIGINT become a cooperative stop flag
  that the learner's loops check at safe points (between dispatches, at
  the top of a loop iteration). On it the learner flushes a full
  checkpoint, writes a ``preempted`` metrics row and exits with
  :data:`PREEMPT_EXIT_CODE`: the supervisor contract "done cleanly,
  restart me" (``restart_epoch: -1`` resumes). The service drains on it
  the same way. A third signal is an operator override and exits at once
  with ``128 + signum``.
* :class:`NonFiniteGuard`: the host's escalation policy over the update
  step's on-device finiteness flag (skip, rollback, abort).
* :class:`ChaosNaN` and :func:`arm_chaos_preempt`: the
  ``HANDYRL_TPU_CHAOS`` drills (``nanstep``/``nanepoch`` + ``nanburst``
  poison the lr of updates; ``preempt=<s>`` SIGTERMs the process).
* :func:`numbered_checkpoints` and :func:`newest_valid_epoch`: the
  CRC-verified resume and rollback targets.
* :func:`episode_is_finite`: the ingest screen for poisoned episodes.
"""

from __future__ import annotations

import math
import os
import signal
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import telemetry
from .fault import parse_chaos

_LOG = telemetry.get_logger('guard')

# EX_TEMPFAIL: the supervisor contract of a drained, restartable process
PREEMPT_EXIT_CODE = 75


class PreemptionGuard:
    """SIGTERM/SIGINT -> cooperative stop flag (checked at safe points).

    The handler only sets the flag (and counts): the flush runs on the
    loop's thread, never inside a graph capture or replay. ``install`` is
    a no-op off the main thread (the CPython signal API requirement) and
    when ``enabled`` is False; ``uninstall`` restores the previous
    handlers, so an in-process learner (tests) leaves the interpreter's
    signal disposition as it found it."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self.signum: Optional[int] = None
        self._event = threading.Event()
        self._count = 0
        self._previous: Dict[int, Any] = {}

    def install(self) -> 'PreemptionGuard':
        if not self.enabled or self._previous:
            return self
        if threading.current_thread() is not threading.main_thread():
            return self
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._previous[sig] = signal.signal(sig, self._handle)
            except (ValueError, OSError):   # exotic embedding: stay passive
                self._previous.pop(sig, None)
                break
        return self

    def uninstall(self):
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._previous = {}

    def _handle(self, signum, frame):
        self._count += 1
        self.signum = signum
        self._event.set()
        if self._count == 1:
            # the handler runs between bytecodes on the main thread, which
            # may hold the recorder's or the registry's lock: the dump
            # runs on a side thread so it can never deadlock the handler
            threading.Thread(
                target=telemetry.dump_blackbox, args=('preempt',),
                kwargs={'signum': int(signum)}, daemon=True).start()
        if self._count >= 3:
            # operator insists: skip the graceful snapshot entirely
            os._exit(128 + signum)

    def adopt(self, signum: int = signal.SIGTERM):
        """A peer rank's preemption, taken as this process's own: the flag
        set (and ``signum`` recorded) without a signal, so every rank of a
        data-parallel job flushes and exits 75 together."""
        self.signum = int(signum)
        self._event.set()

    @property
    def fired(self) -> bool:
        return self._event.is_set()

    def requested(self) -> bool:
        return self._event.is_set()


class NonFiniteGuard:
    """Host-side escalation policy over the device's per-update finiteness
    flag. ``observe`` folds one drained metrics group in and returns the
    action the trainer must take: None (clean), 'skip' (count and carry
    on), 'rollback' (restore the last good checkpoint), 'abort'."""

    def __init__(self, cfg: Optional[Dict[str, Any]] = None):
        cfg = cfg or {}
        self.policy = str(cfg.get('nonfinite_policy') or 'rollback')
        self.rollback_after = max(1, int(cfg.get('rollback_after') or 8))
        self.zscore = float(cfg.get('loss_spike_zscore') or 0.0)
        self.consecutive = 0
        self.total_bad = 0
        self.rollbacks = 0
        # EMA loss statistics for the optional spike trip
        self._loss_mean = 0.0
        self._loss_var = 0.0
        self._loss_n = 0

    def observe(self, bad: int, good: int,
                loss_mean: Optional[float] = None) -> Optional[str]:
        if bad:
            self.total_bad += bad
            self.consecutive += bad
            telemetry.record_event('guard', 'nonfinite updates', bad=int(bad),
                                   consecutive=int(self.consecutive))
            if self.policy == 'abort':
                telemetry.dump_blackbox('nonfinite-abort', bad=int(bad),
                                        total_bad=int(self.total_bad))
                return 'abort'
            if (self.policy == 'rollback'
                    and self.consecutive >= self.rollback_after):
                telemetry.record_event('guard', 'nonfinite rollback',
                                       consecutive=int(self.consecutive))
                return 'rollback'
            return 'skip'
        if good:
            self.consecutive = 0
            if loss_mean is not None and math.isfinite(loss_mean):
                return self._observe_loss(loss_mean)
        return None

    def _observe_loss(self, loss: float) -> Optional[str]:
        """EMA mean/variance z-score over per-drain loss means: a finite
        but exploding loss trips the same rollback as a NaN burst. Needs
        ``loss_spike_zscore`` > 0 and ~20 warmup samples."""
        trip = None
        if self.zscore > 0 and self._loss_n >= 20:
            std = math.sqrt(max(self._loss_var, 1e-12))
            if abs(loss - self._loss_mean) > self.zscore * std:
                trip = 'rollback' if self.policy == 'rollback' else None
                if trip:
                    telemetry.record_event('guard', 'loss spike rollback',
                                           loss=round(loss, 6))
                    _LOG.warning('guard: loss spike %.4g (mean %.4g, std '
                                 '%.4g) tripped the z-score guard', loss,
                                 self._loss_mean, std)
        self._loss_n += 1
        alpha = 0.99
        delta = loss - self._loss_mean
        self._loss_mean += (1 - alpha) * delta
        self._loss_var = alpha * (self._loss_var + (1 - alpha) * delta ** 2)
        return trip

    def reset_streak(self):
        """Called after a rollback (or a rollback that had nowhere to go):
        the restored state starts a fresh streak and fresh loss stats."""
        self.consecutive = 0
        self._loss_n = 0
        self._loss_mean = 0.0
        self._loss_var = 0.0


class ChaosNaN:
    """``nanstep``/``nanepoch``/``nanburst`` injection bookkeeping.

    ``due(step, count)`` answers whether any of the ``count`` updates
    dispatched starting at global SGD step ``step`` should be poisoned,
    and consumes the burst budget when it fires: a rollback that rewinds
    the step counter back into the window must not re-trigger the
    injection forever. ``nanepoch`` arms lazily (the learner arms it at
    the matching epoch boundary, once a rollback target exists on disk).
    """

    def __init__(self, chaos: Optional[Dict[str, float]] = None):
        chaos = parse_chaos() if chaos is None else chaos
        self.at = int(chaos['nanstep']) if 'nanstep' in chaos else None
        self.epoch = int(chaos['nanepoch']) if 'nanepoch' in chaos else None
        self.burst = max(1, int(chaos.get('nanburst', 1)))
        self.remaining = self.burst if (self.at is not None
                                        or self.epoch is not None) else 0

    def arm(self, at: int):
        """Start the injection window at step ``at`` (once)."""
        if self.at is None:
            self.at = int(at)

    def due(self, step: int, count: int = 1) -> bool:
        if self.at is None or self.remaining <= 0 or step + count <= self.at:
            return False
        self.remaining -= count
        return True


def arm_chaos_preempt(chaos: Optional[Dict[str, float]] = None):
    """``HANDYRL_TPU_CHAOS=preempt=<s>``: SIGTERM this process after a
    fixed delay, the drill's stand-in for a preemption notice. Returns the
    timer (None when the knob is off)."""
    chaos = parse_chaos() if chaos is None else chaos
    delay = chaos.get('preempt')
    if not delay:
        return None

    def _fire():
        print('chaos: preempting learner (SIGTERM)', flush=True)
        os.kill(os.getpid(), signal.SIGTERM)

    timer = threading.Timer(float(delay), _fire)
    timer.daemon = True
    timer.start()
    return timer



# ---------------------------------------------------------------------------
# checkpoint selection (integrity-verified resume / rollback targets)


def numbered_checkpoints(model_dir: str) -> List[int]:
    """Sorted epochs of the ``<epoch>.ckpt`` files present in model_dir."""
    try:
        names = os.listdir(model_dir)
    except OSError:
        return []
    out = []
    for name in names:
        stem, dot, ext = name.partition('.')
        if dot and ext == 'ckpt' and stem.isdigit():
            out.append(int(stem))
    return sorted(out)


def newest_valid_epoch(model_dir: str, at_most: Optional[int] = None
                       ) -> Tuple[int, List[int]]:
    """Newest numbered checkpoint epoch passing CRC verification (0 when
    none), plus the list of newer epochs that were discarded as invalid."""
    from .utils.fs import verify_checkpoint
    discarded: List[int] = []
    for epoch in reversed(numbered_checkpoints(model_dir)):
        if at_most is not None and epoch > at_most:
            continue
        ok, reason = verify_checkpoint(
            os.path.join(model_dir, '%d.ckpt' % epoch))
        if ok:
            return epoch, discarded
        _LOG.error('discarding checkpoint %d.ckpt: %s', epoch, reason)
        discarded.append(epoch)
    return 0, discarded


# ---------------------------------------------------------------------------
# episode ingest guard


def _all_finite(x) -> bool:
    if x is None:
        return True
    if isinstance(x, dict):
        return all(_all_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_all_finite(v) for v in x)
    arr = np.asarray(x)
    if arr.dtype.kind not in 'fc':
        return True
    return bool(np.isfinite(arr).all())


def episode_is_finite(episode: Dict[str, Any]) -> bool:
    """True when the episode's outcome and decoded per-moment observations,
    rewards, values and returns are all finite. Undecodable payloads count
    as poisoned: one bad actor must not contaminate every future batch."""
    from .ops.batch import decompress_moments
    try:
        if not _all_finite(episode.get('outcome')):
            return False
        for moment in decompress_moments(episode.get('moment') or []):
            for key in ('observation', 'reward', 'value', 'return'):
                if not _all_finite(moment.get(key)):
                    return False
    except Exception:
        return False
    return True
