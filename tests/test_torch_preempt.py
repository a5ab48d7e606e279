"""Preempt, flush and resume through the port's CLI, ``python -m
handyrl_tpu_torch.train --device cpu``: the port's counterparts of the JAX
package's tests/test_guard.py:307-364 (SIGTERM mid-run -> a flushed
checkpoint pair, a ``preempted`` metrics row and exit 75; the supervisor's
restart with ``restart_epoch: -1`` finishes the budget with monotonic
steps and no duplicate epoch rows) and tests/test_checkpoint_interval.py:86
(the fused loop's flush writes the epoch ``checkpoint_interval`` skipped,
and the restart resumes the train state from it).

Both loops: the host learner on TicTacToe (its full-width net, B=8, T=8)
and the fused device loop on Hungry Geese (the full-width GeeseNet on its
plain trunk, B=4, T=4, 4 envs, 8-ply chunks, 2 SGD steps a chunk,
``checkpoint_interval`` 3). The SIGTERM goes out once the first metrics
row is on disk. A resumed fused run refills its ring for
``minimum_episodes`` before it trains again, as the JAX package's does
(handyrl_tpu/train.py:2740,2874: the ring is not saved). Every check is
exact (exit codes, counts, steps)."""

import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest

from handyrl_tpu.telemetry import validate_metrics_line
from handyrl_tpu_torch import guard
from handyrl_tpu_torch.utils.fs import verify_checkpoint

pytestmark = pytest.mark.timeout(60)   # each test's own limit
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    'host': {'env_args': {'env': 'TicTacToe'},
             'train_args': {'batch_size': 8, 'forward_steps': 8,
                            'generation_envs': 8, 'num_batchers': 1,
                            'minimum_episodes': 12, 'update_episodes': 12}},
    'fused': {'env_args': {'env': 'HungryGeese', 'torus_impl': 'pallas'},
              'train_args': {'turn_based_training': False,
                             'observation': True, 'gamma': 0.99,
                             'forward_steps': 4, 'batch_size': 4,
                             'policy_target': 'VTRACE',
                             'value_target': 'VTRACE',
                             'generation_envs': 4, 'eval_envs': 4,
                             'minimum_episodes': 4, 'update_episodes': 4,
                             'maximum_episodes': 16,
                             'device_generation': True,
                             'device_replay': True, 'device_chunk_steps': 8,
                             'sgd_steps_per_chunk': 2,
                             'checkpoint_interval': 3}},
}


def _config(tmp_path, loop, epochs, restart):
    cfg = json.loads(json.dumps(CONFIGS[loop]))
    cfg['train_args'].update(
        epochs=epochs, restart_epoch=restart,
        model_dir=str(tmp_path / 'models'),
        metrics_jsonl=str(tmp_path / 'metrics.jsonl'))
    path = tmp_path / ('config_%d.json' % epochs)
    path.write_text(json.dumps(cfg))
    return [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config',
            str(path), '--device', 'cpu']


def _env():
    # one intra-op thread: the workers of a parallel test run share the cores
    env = dict(os.environ, OMP_NUM_THREADS='1')
    env.pop('HANDYRL_TPU_CHAOS', None)
    env.pop('HANDYRL_TPU_DEADLINE', None)
    return env


def _rows(tmp_path):
    path = tmp_path / 'metrics.jsonl'
    if not path.exists():
        return []
    return [validate_metrics_line(l) for l in path.read_text().splitlines()
            if l.strip()]


@pytest.mark.parametrize('loop', ['host', 'fused'])
def test_preempt_flush_and_resume_through_the_cli(tmp_path, loop):
    models = tmp_path / 'models'
    log = open(tmp_path / 'first.log', 'w')
    proc = subprocess.Popen(_config(tmp_path, loop, 1000, 0), cwd=REPO,
                            env=_env(), stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 40
        while (not _rows(tmp_path) and proc.poll() is None
               and time.time() < deadline):
            time.sleep(0.05)
        assert proc.poll() is None, 'the learner died before the preempt'
        assert _rows(tmp_path), 'no metrics row within 40 s'
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    out = (tmp_path / 'first.log').read_text()
    assert rc == guard.PREEMPT_EXIT_CODE, out[-2000:]
    m = re.search(r'preempted: checkpoint flushed at epoch (\d+) \(steps '
                  r'(\d+)\)', out)
    assert m, out[-2000:]
    flushed, flushed_steps = int(m.group(1)), int(m.group(2))
    assert flushed >= 1 and flushed_steps > 0
    assert verify_checkpoint(str(models / 'trainer_state.ckpt')) == (True,
                                                                     'ok')
    assert guard.newest_valid_epoch(str(models))[0] == flushed
    pre = [r for r in _rows(tmp_path) if r.get('preempted')]
    assert len(pre) == 1 and pre[0]['steps'] == flushed_steps
    assert pre[0]['epoch'] == flushed and pre[0]['signal'] == signal.SIGTERM
    lines = [l for l in out.splitlines() if l.startswith('{')]
    assert json.loads(lines[-1])['steps_at_exit'] >= flushed_steps

    end = flushed + 2
    again = subprocess.run(_config(tmp_path, loop, end, -1), cwd=REPO,
                           env=_env(), capture_output=True, text=True,
                           timeout=40)
    assert again.returncode == 0, again.stdout[-2000:] + again.stderr[-2000:]
    assert ('auto-resume: newest valid checkpoint is epoch %d' % flushed
            in again.stdout)
    assert 'resumed trainer state (steps %d)' % flushed_steps in again.stdout
    assert verify_checkpoint(str(models / ('%d.ckpt' % end)))[0]
    rows = _rows(tmp_path)
    steps = [r['steps'] for r in rows]
    assert steps == sorted(steps), 'steps regressed across the restart'
    epochs = [r['epoch'] for r in rows if not r.get('preempted')]
    assert len(epochs) == len(set(epochs)), epochs
    assert max(epochs) == end
    assert [r['epoch'] for r in rows[-2:]] == [flushed + 1, end]
    assert rows[-2]['steps'] > flushed_steps
    line = json.loads([l for l in again.stdout.splitlines()
                       if l.startswith('{')][-1])
    assert line['model_epoch'] == end and line['epochs'] == 2
    if loop == 'fused':
        # the interval skipped the flushed epoch's files unless it is a
        # multiple of 3; the flush wrote them all the same
        assert (models / ('%d.ckpt' % flushed)).exists()
        assert line['warm_dispatches'] >= 1 and line['steps'] > 0
