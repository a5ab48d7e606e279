"""The port's local learner on TicTacToe, turn-based (the README's quick
start), on the CPU: the counterpart of tests/test_train_e2e.py's
``test_learner_two_epochs`` with the same config (B=16, T=8, 8 envs, 40
episodes before the first epoch and 30 an epoch, 2 epochs), through the
``Learner`` and through ``python -m handyrl_tpu_torch.train``.

Checked: the epochs, the episode and evaluation counts (and the summary's
evaluation tallies by epoch, the numbers the win-rate lines print); every
checkpoint with a CRC sidecar the JAX package verifies; the JAX package's
``load_model`` reads ``latest.ckpt`` and its forward matches the port's
within 1e-5 (fp32 sums in other orders); the trained params moved; the
compact batch (player axis 1 for the acting seat's data, 2 for values and
masks) reached the step."""

import pytest
import json
import os
import subprocess
import sys

import numpy as np
import torch

from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.evaluation import load_model as jax_load_model
from handyrl_tpu.utils.fs import verify_checkpoint as jax_verify
from handyrl_tpu_torch.config import apply_defaults
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.evaluation import load_model
from handyrl_tpu_torch.models.tictactoe import SimpleConv2dModel
from handyrl_tpu_torch.train import Learner


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


TOL = 1e-5
TRAIN = {'batch_size': 16, 'update_episodes': 30, 'minimum_episodes': 40,
         'epochs': 2, 'generation_envs': 8, 'forward_steps': 8,
         'num_batchers': 1}
FILES = ('1.ckpt', '2.ckpt', 'latest.ckpt', 'trainer_state.ckpt')


def _raw(model_dir):
    return {'env_args': {'env': 'TicTacToe'},
            'train_args': dict(TRAIN, model_dir=str(model_dir))}


def _boards(n=16, seed=2):
    env, rng = make_env({'env': 'TicTacToe'}), np.random.RandomState(seed)
    obs = []
    while len(obs) < n:
        if env.terminal():
            env.reset()
        obs.append(env.observation(env.turn()))
        env.play(int(rng.choice(env.legal_actions())))
    return np.stack(obs)


def test_learner_two_epochs(tmp_path):
    models = tmp_path / 'models'
    learner = Learner(apply_defaults(_raw(models)), device='cpu')
    assert isinstance(learner.module, SimpleConv2dModel)
    seen = {}
    step = learner.trainer.update_step
    body = step._body

    def spy(batch):
        seen.setdefault('shapes', {k: tuple(v.shape)
                                   for k, v in batch.items()})
        return body(batch)
    step._body = spy
    start = {k: v.clone() for k, v in learner.params.items()}
    learner.run()

    assert learner.model_epoch == 2
    for name in FILES:
        assert jax_verify(str(models / name)) == (True, 'ok'), name
    assert learner.num_returned_episodes >= 60
    assert learner.num_results > 0 and len(learner.trainer.episodes) > 0
    summary = learner.summary()
    assert summary['epochs'] == 2 and not summary['failed']
    by_epoch = summary['eval_by_epoch']
    assert sum(n for n, _ in by_epoch.values()) == learner.num_results
    for e, (n, r) in by_epoch.items():
        assert (n, r) == learner.results[int(e)][:2]
    assert summary['kernel_launches'] == {}   # the CPU launches no kernel

    shapes = seen['shapes']
    assert shapes['observation'] == (16, 8, 1, 3, 3, 3)
    assert shapes['action_mask'] == (16, 8, 1, 9)
    assert shapes['value'] == shapes['turn_mask'] == (16, 8, 2, 1)
    assert any(not torch.equal(start[k], v)
               for k, v in learner.params.items())

    jw = jax_load_model(str(models / 'latest.ckpt'),
                        jax_make_env({'env': 'TicTacToe'}))
    pw = load_model(str(models / 'latest.ckpt'), make_env({'env': 'TicTacToe'}),
                    device='cpu')
    obs = _boards()
    want, got = jw.batch_inference(obs), pw.batch_inference(obs)
    assert got['policy'].shape == (16, 9)
    for k in ('policy', 'value'):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                   atol=TOL, err_msg=k)


def test_quick_start_cli_on_the_cpu(tmp_path):
    cfg = tmp_path / 'tictactoe.json'
    cfg.write_text(json.dumps(_raw(tmp_path / 'models')))
    proc = subprocess.run(
        [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config',
         str(cfg), '--device', 'cpu'], capture_output=True, text=True,
        timeout=240, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [l for l in proc.stdout.splitlines() if l.startswith('{')]
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line['epochs'] == 2 and line['steps'] > 0
    assert set(line['eval_by_epoch']) <= {'0', '1', '2'}
    assert 'win rate' in proc.stdout and 'updated model' in proc.stdout
    for name in FILES:
        assert (tmp_path / 'models' / name).exists(), name
