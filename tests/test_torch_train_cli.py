"""The port's learner CLI, ``python -m handyrl_tpu_torch.train``, and the
config it reads (handyrl_tpu_torch/config.py).

On the CPU (``--device cpu``) with a JSON config it trains the env's
full-width GeeseNet for one epoch at a small batch (B=4, T=4, 4 envs),
exits 0 and prints one JSON line; the JAX package's ``load_model`` reads
its ``latest.ckpt``, and the JAX forward matches the port's within 1e-4
(fp32 sums in other orders through 12 normalised blocks). Without
``--device`` it runs on the card, so on a machine without CUDA it exits
non-zero naming CUDA, before any training. ``apply_defaults`` rejects,
with a message naming the key, each option this slice does not run."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.evaluation import load_model as jax_load_model
from handyrl_tpu_torch.config import ConfigError, apply_defaults
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.evaluation import load_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
CONFIG = {
    'env_args': {'env': 'HungryGeese', 'torus_impl': 'pallas'},
    'train_args': {'turn_based_training': False, 'observation': True,
                   'gamma': 0.99, 'forward_steps': 4, 'batch_size': 4,
                   'generation_envs': 4, 'num_batchers': 1,
                   'minimum_episodes': 4, 'update_episodes': 4, 'epochs': 1,
                   'eval': {'opponent': ['random', 'rulebase']}}}


def _cli(tmp_path, config, *extra, env=None):
    path = tmp_path / 'config.json'
    path.write_text(json.dumps(config))
    return subprocess.run(
        [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config',
         str(path), *extra], cwd=REPO, capture_output=True, text=True,
        timeout=600, env=env)


def test_cli_trains_on_the_cpu(tmp_path):
    config = json.loads(json.dumps(CONFIG))
    config['train_args']['model_dir'] = str(tmp_path / 'models')
    proc = _cli(tmp_path, config, '--device', 'cpu',
                env=dict(os.environ, OMP_NUM_THREADS='2'))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [l for l in proc.stdout.splitlines() if l.startswith('{')]
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line['device'] == 'cpu' and line['epochs'] == 1
    assert line['steps'] > 0 and line['episodes'] >= 8
    assert line['trajectories_per_s'] > 0 and not line['failed']
    assert line['kernel_launches'] == {}      # the CPU launches no kernel
    assert 'updated model(%d)' % line['steps'] in proc.stdout

    latest = str(tmp_path / 'models' / 'latest.ckpt')
    jax_env = jax_make_env({'env': 'HungryGeese'})
    want = jax_load_model(latest, jax_env)
    got = load_model(latest, make_env(CONFIG['env_args']), device='cpu')
    env = make_env({'env': 'HungryGeese', 'id': 3})
    obs = np.stack([env.observation(p) for p in env.players()] * 2)
    out, ref = got.batch_inference(obs), want.batch_inference(obs)
    for k in ('policy', 'value'):
        np.testing.assert_allclose(out[k], np.asarray(ref[k]), rtol=0,
                                   atol=TOL, err_msg=k)


def test_cli_without_cuda_raises(tmp_path):
    config = json.loads(json.dumps(CONFIG))
    config['train_args']['model_dir'] = str(tmp_path / 'models')
    proc = _cli(tmp_path, config,
                env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert proc.returncode != 0
    assert 'CUDA' in proc.stderr
    assert not [l for l in proc.stdout.splitlines() if l.startswith('{')]
    assert not (tmp_path / 'models').exists()


@pytest.mark.parametrize('env_args,train_args,key', [
    ({}, {'device_generation': True}, 'device_generation'),
    ({}, {'device_replay': True}, 'device_replay'),
    ({}, {'batcher_processes': True}, 'batcher_processes'),
    ({}, {'streaming': {'enabled': True}}, 'streaming'),
    ({}, {'streaming': {'target_clip': 1.0}}, 'streaming'),
    ({}, {'league': {'enabled': True}}, 'league'),
    ({}, {'parallel': {'model_parallel': 2}}, 'parallel'),
    ({}, {'batched_generation': False}, 'batched_generation'),
    ({}, {'burn_in_steps': 2}, 'burn_in_steps'),
    ({}, {'metrics_jsonl': 'm.jsonl'}, 'metrics_jsonl'),
    ({'net_kind': 'lstm'}, {}, 'net_kind'),
    ({'norm_kind': 'batch'}, {}, 'norm_kind'),
    ({'env': 'TicTacToe'}, {}, 'TicTacToe'),
])
def test_validate_rejects_what_the_slice_does_not_run(env_args, train_args,
                                                      key):
    raw = {'env_args': dict({'env': 'HungryGeese'}, **env_args),
           'train_args': train_args}
    with pytest.raises(ConfigError, match=key):
        apply_defaults(raw)


def test_validate_takes_the_jax_defaults_of_the_planes_it_lacks():
    args = apply_defaults({
        'env_args': {'env': 'HungryGeese', 'torus_impl': 'pallas'},
        'train_args': {'device_generation': False, 'device_replay': False,
                       'batcher_processes': False,
                       'streaming': {'enabled': False, 'chunk_steps': 32},
                       'league': {'enabled': False},
                       'parallel': {'model_parallel': 1,
                                    'partition_rules': []}}})
    assert args['train_args']['batched_generation'] is True
    assert args['env_args']['torus_impl'] == 'pallas'
