"""The fused device loop of the port's learner (handyrl_tpu_torch/train.py
``Learner._run_fused`` on ops/fused_pipeline.py) end to end on the CPU,
after tests/test_fused_pipeline.py, and its checkpoints against the JAX
package.

A small GeeseNet (filters 16, 2 blocks, 'pallas' trunk on its plain
version) trains Hungry Geese with ``device_generation`` and
``device_replay``: B=4, T=4, 4 envs, 8-ply chunks, 2 SGD steps a chunk,
VTRACE/VTRACE, evaluation against 'random' and 'rulebase' on the device.
Checked: the run prints ``fused device pipeline ... (solo mode)`` and
closes its epochs; the steps equal the fused dispatches x K; the JSON
line's fields; on a ring of 4 rows the windows ingested are cumulative and
pass the capacity; the files the JAX package reads (its ``ModelWrapper``
loads ``latest.ckpt`` and its forward matches the port's within 1e-5,
fp32 sums in other orders; its ``Trainer.load_state_bytes`` restores
``trainer_state.ckpt`` to the port's params bit for bit);
``checkpoint_interval``, with the last epoch always written;
``restart_epoch`` resumes into the fused loop (with an opponent the host
evaluator plays); the CLI without a card and
without ``--device cpu`` exits naming CUDA; ``validate`` raises for each
device combination the port does not run."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu.config import apply_defaults as jax_apply_defaults
from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
from handyrl_tpu.models import build as jax_build
from handyrl_tpu.train import Trainer as JaxTrainer
from handyrl_tpu.utils.fs import verify_checkpoint as jax_verify
from handyrl_tpu_torch.config import ConfigError, apply_defaults
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.model import ModelWrapper, load_params_bytes
from handyrl_tpu_torch.models.geese import GeeseNet, params_from_flax
from handyrl_tpu_torch.train import Learner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
K = 2
TRAIN = {'turn_based_training': False, 'observation': True, 'gamma': 0.99,
         'forward_steps': 4, 'compress_steps': 4, 'batch_size': 4,
         'policy_target': 'VTRACE', 'value_target': 'VTRACE',
         'generation_envs': 4, 'eval_envs': 4, 'minimum_episodes': 4,
         'update_episodes': 4, 'epochs': 1, 'maximum_episodes': 16,
         'device_generation': True, 'device_replay': True,
         'device_chunk_steps': 8, 'sgd_steps_per_chunk': K,
         'eval': {'opponent': ['random', 'rulebase']}}
DEVICE_KEYS = ('device_generation', 'device_replay', 'device_chunk_steps',
               'sgd_steps_per_chunk')


def _raw(model_dir, **train):
    return {'env_args': {'env': 'HungryGeese', 'torus_impl': 'pallas'},
            'train_args': dict(TRAIN, model_dir=str(model_dir), **train)}


def _net(seed=0):
    return GeeseNet(filters=16, layers=2, torus_impl='pallas',
                    generator=torch.Generator().manual_seed(seed))


def _boards(n=12, seed=4):
    env = make_env({'env': 'HungryGeese', 'id': seed})
    rng = np.random.RandomState(seed)
    obs = []
    while len(obs) < n:
        if env.terminal():
            env.reset()
        obs += [env.observation(p) for p in env.turns()]
        env.step({p: int(rng.randint(4)) for p in env.turns()})
    return np.stack(obs[:n])


def test_one_epoch_and_checkpoints_the_jax_package_reads(tmp_path, capsys):
    models = tmp_path / 'models'
    learner = Learner(apply_defaults(_raw(models)), net=_net(), device='cpu')
    learner.run()
    out = capsys.readouterr().out
    assert 'fused device pipeline' in out and '(solo mode)' in out
    assert 'loss = ' in out and 'updated model(' in out
    assert learner.model_epoch == 1
    line = learner.summary()
    steps = learner.trainer.steps
    assert steps > 0 and steps == line['fused_dispatches'] * K
    assert line['steps_at_exit'] == steps == learner.epoch_steps[-1]
    assert line['dispatches'] == (line['fused_dispatches']
                                  + line['warm_dispatches'])
    assert line['warm_dispatches'] >= 1 and line['eval_dispatches'] >= 1
    assert line['windows_ingested'] >= line['ring_size'] > 0
    assert line['sample_reuse'] == pytest.approx(
        steps * 4 / line['windows_ingested'])
    assert line['ring_capacity'] == 16 * 16     # min(16, 4096) * 64 // 4
    assert line['sgd_steps_per_s'] > 0 and line['kernel_launches'] == {}
    loop = line['loop_seconds']
    assert loop['checkpoint_write'] > 0 and loop['checkpoint_wait'] >= 0
    assert loop['epoch_close'] >= loop['checkpoint_write']
    assert line['episodes'] >= 8 and line['eval_results'] > 0
    assert learner.num_results > 0 and learner.generation_results

    for name in ('1.ckpt', 'latest.ckpt', 'trainer_state.ckpt'):
        assert jax_verify(str(models / name)) == (True, 'ok'), name
    latest = (models / 'latest.ckpt').read_bytes()
    assert latest == (models / '1.ckpt').read_bytes()
    obs = _boards()
    jw = JaxModelWrapper(jax_build('GeeseNet', filters=16, layers=2))
    jw.load_params_bytes(latest, obs[0])
    net = _net(seed=9)
    load_params_bytes(net, latest)
    got = ModelWrapper(net, device='cpu').batch_inference(obs)
    want = jw.batch_inference(obs)
    for k in ('policy', 'value'):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                   atol=TOL, err_msg=k)
    host = {k: v for k, v in _raw(models)['train_args'].items()
            if k not in DEVICE_KEYS}
    jt = JaxTrainer(jax_apply_defaults({'env_args': {'env': 'HungryGeese'},
                                        'train_args': host})['train_args'],
                    jw)
    jt.load_state_bytes((models / 'trainer_state.ckpt').read_bytes())
    assert jt.steps == steps and int(jt.state.steps) == steps
    assert jt.data_cnt_ema == learner.trainer.data_cnt_ema
    flat = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                   jt.state.params))
    for k, v in flat.items():
        assert torch.equal(v, learner.params[k]), k


def test_windows_ingested_are_cumulative_past_a_ring_of_4_rows(tmp_path):
    learner = Learner(apply_defaults(_raw(
        tmp_path / 'models', maximum_episodes=2, replay_windows_per_episode=2,
        epochs=2)), net=_net(), device='cpu')
    learner.run()
    line = learner.summary()
    assert line['ring_capacity'] == 4 and line['ring_size'] == 4
    assert line['windows_ingested'] > 4 * 4
    assert learner.trainer.steps == line['fused_dispatches'] * K > 0


def test_checkpoint_interval_keeps_the_last_epochs_files(tmp_path):
    models = tmp_path / 'models'
    learner = Learner(apply_defaults(_raw(models, epochs=3,
                                          checkpoint_interval=2)),
                      net=_net(), device='cpu')
    learner.run()
    assert learner.model_epoch == 3
    assert not (models / '1.ckpt').exists()
    assert (models / '2.ckpt').exists() and (models / '3.ckpt').exists()
    assert (models / 'latest.ckpt').read_bytes() == (
        models / '3.ckpt').read_bytes()


def test_restart_epoch_resumes_into_the_fused_loop(tmp_path, capsys):
    models = tmp_path / 'models'
    first = Learner(apply_defaults(_raw(models)), net=_net(), device='cpu')
    first.run()
    steps = first.trainer.steps
    capsys.readouterr()
    # an opponent the device evaluator does not play: the host evaluator
    again = Learner(apply_defaults(_raw(
        models, restart_epoch=1, epochs=2,
        eval={'opponent': ['rulebase-1']})), net=_net(seed=5), device='cpu')
    assert again.model_epoch == 1 and again.trainer.steps == steps
    state = again.trainer.update_step.state
    assert int(state.steps) == steps
    for k, v in first.params.items():
        assert torch.equal(state.params[k].detach(), v), k
    again.run()
    out = capsys.readouterr().out
    assert 'resumed trainer state (steps %d)' % steps in out
    assert 'fused device pipeline' in out
    assert again.model_epoch == 2
    assert again.trainer.steps > steps
    assert (models / '2.ckpt').exists()
    assert again.plies['evaluation'] > 0 and again._eval_dispatches is None


def test_cli_without_cuda_raises_on_the_device_path(tmp_path):
    path = tmp_path / 'config.json'
    path.write_text(json.dumps(_raw(tmp_path / 'models')))
    proc = subprocess.run(
        [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config',
         str(path)], cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert proc.returncode != 0 and 'CUDA' in proc.stderr
    assert not (tmp_path / 'models').exists()


@pytest.mark.parametrize('env_args,train_args,key', [
    ({}, {'device_replay': True}, 'device_replay without device_generation'),
    ({}, {'device_generation': True},
     'device_generation without device_replay'),
    ({}, {'device_generation': True, 'device_replay': True,
          'fused_pipeline': False}, 'fused_pipeline'),
    ({}, {'device_generation': True, 'device_replay': True,
          'device_ingest': False}, 'device_ingest'),
    ({}, {'device_generation': True, 'device_replay': True,
          'turn_based_training': True}, 'turn_based_training'),
    ({'env': 'TicTacToe'}, {'device_generation': True,
                            'device_replay': True}, 'TicTacToe'),
    ({}, {'device_generation': True, 'device_replay': True,
          'device_chunk_steps': 0}, 'device_chunk_steps'),
    ({}, {'device_generation': True, 'device_replay': True,
          'replay_fused_steps': 8}, 'replay_fused_steps'),
])
def test_validate_rejects_device_combinations_the_port_does_not_run(
        env_args, train_args, key):
    raw = {'env_args': dict({'env': 'HungryGeese'}, **env_args),
           'train_args': dict({'turn_based_training': False}, **train_args)}
    with pytest.raises(ConfigError, match=key):
        apply_defaults(raw)


def test_validate_takes_the_fused_loops_jax_defaults():
    args = apply_defaults({'env_args': {'env': 'HungryGeese'},
                           'train_args': {'turn_based_training': False,
                                          'device_generation': True,
                                          'device_replay': True}})
    ta = args['train_args']
    assert (ta['fused_pipeline'], ta['device_ingest'], ta['device_eval'],
            ta['device_chunk_steps'], ta['sgd_steps_per_chunk'],
            ta['checkpoint_interval'], ta['replay_windows_per_episode']) == (
        True, True, True, 16, None, 1, None)
