"""The quick start on the fused device loop on the CPU: the port's learner
(handyrl_tpu_torch/train.py ``_run_fused``) with ``device_generation``
and ``device_replay`` on TicTacToe runs the 'turn' layout, as the JAX
package's tests/test_fused_pipeline.py:34-51 runs its own: ``(turn
mode)``, two epochs, metrics rows, and checkpoints that the JAX package
reads (its ``load_model`` gives the port's forward within 1e-5: the two
nets' float32 sums differ in order; its ``Trainer.load_state_bytes``
restores the steps and the params exactly). The step's loss runs with
``observation=False`` on the compact ring, also for ``observation: true``
(the JAX learner's ``device_cfg``), and the device evaluator plays
'random' while the host evaluator plays 'rulebase', which the twin does
not vectorize.
"""

import json
import os
import random

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu.config import apply_defaults as jax_apply_defaults
from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.evaluation import load_model as jax_load_model
from handyrl_tpu.train import Trainer as JaxTrainer
from handyrl_tpu.utils.fs import verify_checkpoint as jax_verify
from handyrl_tpu_torch.config import apply_defaults
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.evaluation import load_model
from handyrl_tpu_torch.models.tictactoe import params_from_flax
from handyrl_tpu_torch.train import Learner

pytestmark = pytest.mark.timeout(60)   # each test's own limit


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
K = 4
DEVICE_KEYS = ('device_generation', 'device_replay', 'sgd_steps_per_chunk',
               'metrics_jsonl')


def _raw(tmp_path, **over):
    ta = {'batch_size': 12, 'forward_steps': 4, 'compress_steps': 2,
          'update_episodes': 40, 'minimum_episodes': 40, 'epochs': 2,
          'generation_envs': 16, 'num_batchers': 1,
          'device_generation': True, 'device_replay': True,
          'sgd_steps_per_chunk': K,
          'model_dir': str(tmp_path / 'models'),
          'metrics_jsonl': str(tmp_path / 'metrics.jsonl')}
    ta.update(over)
    return {'env_args': {'env': 'TicTacToe'}, 'train_args': ta}


def _boards(n=16, seed=0):
    env, rng = make_env({'env': 'TicTacToe'}), random.Random(seed)
    obs = []
    while len(obs) < n:
        if env.terminal():
            env.reset()
        obs += [env.observation(p) for p in env.players()]
        env.play(rng.choice(env.legal_actions()))
    return np.stack(obs[:n])


def test_tictactoe_fused_learner_and_checkpoints_the_jax_package_reads(
        tmp_path, capsys):
    models = tmp_path / 'models'
    learner = Learner(apply_defaults(_raw(tmp_path)), device='cpu')
    learner.run()
    out = capsys.readouterr().out
    assert 'fused device pipeline' in out and '(turn mode)' in out
    assert 'loss =' in out and 'updated model(' in out
    assert learner.model_epoch == 2
    assert learner.num_returned_episodes >= 80
    steps = learner.trainer.steps
    line = learner.summary()
    assert steps > 0 and steps == line['fused_dispatches'] * K
    assert line['fused'] and line['kernel_launches'] == {}
    assert line['eval_results'] > 0 and line['eval_dispatches'] >= 1
    assert line['windows_ingested'] >= line['ring_size'] > 0
    assert learner.trainer.device_cfg.observation is False
    rows = [json.loads(l)
            for l in (tmp_path / 'metrics.jsonl').read_text().splitlines()]
    assert [r['epoch'] for r in rows] == [1, 2]
    assert rows[-1]['dispatches_gen'] > 0 and rows[-1]['steps'] == steps

    for name in ('1.ckpt', '2.ckpt', 'latest.ckpt', 'trainer_state.ckpt'):
        assert jax_verify(str(models / name)) == (True, 'ok'), name
    env = jax_make_env({'env': 'TicTacToe'})
    jw = jax_load_model(str(models / 'latest.ckpt'), env)
    pw = load_model(str(models / 'latest.ckpt'),
                    make_env({'env': 'TicTacToe'}), device='cpu')
    obs = _boards()
    want, got = jw.batch_inference(obs), pw.batch_inference(obs)
    for k in ('policy', 'value'):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                   atol=TOL, err_msg=k)
    host = {k: v for k, v in _raw(tmp_path)['train_args'].items()
            if k not in DEVICE_KEYS}
    jt = JaxTrainer(jax_apply_defaults({'env_args': {'env': 'TicTacToe'},
                                        'train_args': host})['train_args'],
                    jw)
    jt.load_state_bytes((models / 'trainer_state.ckpt').read_bytes())
    assert jt.steps == steps and int(jt.state.steps) == steps
    flat = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                   jt.state.params))
    for k, v in flat.items():
        assert torch.equal(v, learner.params[k]), k


@pytest.mark.parametrize('opponents,on_device', [
    (['random'], True), (['random', 'rulebase'], False)])
def test_observation_true_trains_the_compact_layout(tmp_path, opponents,
                                                    on_device):
    """config.yaml's observation: true on the turn device path: the loss
    runs observation=False on the compact ring (the JAX device_cfg); a
    'rulebase' opponent moves evaluation to the host evaluator."""
    learner = Learner(apply_defaults(_raw(
        tmp_path, observation=True, epochs=1,
        eval={'opponent': opponents})), device='cpu')
    assert learner.trainer.cfg.observation is True
    assert learner.trainer.device_cfg.observation is False
    learner.run()
    assert learner.model_epoch == 1 and learner.trainer.steps > 0
    # the device evaluator counts its dispatches; the host one has none
    assert (learner.summary()['eval_dispatches'] is not None) == on_device
    played = {o for per in learner.results_per_opponent.values()
              for o in per}
    assert played and played <= set(opponents)
