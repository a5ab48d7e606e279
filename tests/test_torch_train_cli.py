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

import torch
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
                env=dict(os.environ, OMP_NUM_THREADS='1'))
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
    # every device combination runs; the device knobs' ranges are checked
    ({}, {'device_generation': True, 'replay_fused_steps': 0},
     'replay_fused_steps'),
    ({}, {'device_replay': True, 'max_sample_reuse': -1.0},
     'max_sample_reuse'),
    ({}, {'batcher_shared_memory': True}, 'batcher_processes'),
    # streaming and its IMPACT target run; their values are checked as
    # the JAX package checks them
    ({}, {'streaming': {'enabled': True, 'chunk_steps': 6}}, 'chunk_steps'),
    ({}, {'streaming': {'target_clip': -1.0}}, 'target_clip'),
    ({}, {'league': {'enabled': True}}, 'league.enabled requires '
     'serving.publish'),
    ({}, {'parallel': {'model_parallel': 2}}, 'parallel'),
    # the worker plane runs, the device actor backend with it; its
    # knobs are checked as the JAX package checks them
    ({}, {'batched_generation': False, 'device_generation': True,
          'device_replay': True,
          'generation': {'device_actor_chunk_steps': 0}},
     'device_actor_chunk_steps'),
    ({}, {'compute_dtype': 'float16'}, 'compute_dtype'),
    # the exporter runs since telemetry was ported; its port is checked as
    # the JAX package checks it
    ({}, {'telemetry_port': 70000}, 'telemetry_port'),
    ({'net_kind': 'former'}, {}, 'net_kind'),
    ({'norm_kind': 'batch', 'torus_impl': 'pallas'}, {}, 'pallas'),
    ({'env': 'TicTacToe'}, {'device_generation': True,
                            'batched_generation': False,
                            'generation': {'device_actor_record': 'exact'}},
     'device_actor_record'),
    pytest.param({}, {'inference': {'enabled': True,
                                    'engine_backend': 'gpu'}},
                 'inference.engine_backend',
                 id='env_args13-train_args13-host inference engine'),
    # the fleet's resolver and its exporter port run since the serving
    # tier's telemetry was ported; mesh parallelism is still refused
    pytest.param({}, {'generation': {'backend': 'engine'},
                      'serving': {'fleet': {'resolver': 'localhost:9000',
                                            'metrics_port': 9100}},
                      'parallel': {'model_parallel': 2}},
                 'train_args.parallel.model_parallel: the parallel plane',
                 id='env_args14-train_args14-inference engine'),
    ({}, {'generation': {'backend': 'gpu'}}, 'generation.backend'),
    ({}, {'batched_generation': False, 'worker': {'num_parallel': 0}},
     'num_parallel'),
    ({}, {'fault_tolerance': {'liveness_timeout': 5.0}}, 'liveness_timeout'),
])
def test_validate_rejects_what_the_slice_does_not_run(env_args, train_args,
                                                      key):
    raw = {'env_args': dict({'env': 'HungryGeese'}, **env_args),
           'train_args': train_args}
    with pytest.raises(ConfigError, match=key):
        apply_defaults(raw)


@pytest.mark.parametrize('backend,key', [
    ('gpu', 'worker_args.backend'),
    # backends are names: 'engine' runs, a misspelt one is refused
    pytest.param('Engine', 'worker_args.backend',
                 id='engine-inference engine'),
    ('tpu', 'worker_args.backend')])
def test_validate_rejects_a_worker_host_backend_it_lacks(backend, key):
    with pytest.raises(ConfigError, match=key):
        apply_defaults({'env_args': {'env': 'HungryGeese'},
                        'worker_args': {'backend': backend}})


def test_worker_plane_defaults_are_the_jax_packages():
    from handyrl_tpu.config import TRAIN_DEFAULTS as JAX_TRAIN
    from handyrl_tpu.config import WORKER_DEFAULTS as JAX_WORKER
    from handyrl_tpu_torch.config import TRAIN_DEFAULTS, WORKER_DEFAULTS
    assert TRAIN_DEFAULTS['worker'] == JAX_TRAIN['worker']
    ft, jax_ft = TRAIN_DEFAULTS['fault_tolerance'], JAX_TRAIN['fault_tolerance']
    assert list(ft) == list(jax_ft)
    for key in jax_ft:
        assert ft[key] == jax_ft[key] and type(ft[key]) is type(jax_ft[key])
    assert WORKER_DEFAULTS == JAX_WORKER
    # a config.yaml-shaped worker plane passes, local and remote
    args = apply_defaults({
        'env_args': {'env': 'HungryGeese'},
        'train_args': {'batched_generation': False,
                       'worker': {'num_parallel': 4},
                       'fault_tolerance': {'heartbeat_interval': 5.0},
                       'generation': {'backend': 'worker'},
                       'inference': {'enabled': False, 'vault_size': 2}},
        'worker_args': {'server_address': '127.0.0.1', 'num_parallel': 2,
                        'backend': 'worker'}})
    assert args['train_args']['fault_tolerance']['heartbeat_interval'] == 5.0
    assert args['train_args']['fault_tolerance']['liveness_timeout'] == 60.0


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
