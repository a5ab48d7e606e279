"""``compute_dtype: 'bfloat16'`` through the port's entry points: the port
twin of tests/test_bf16.py (the learner trains with the net in bf16
activations, its params fp32 before and after), the config's rules, the
snapshots and checkpoints (fp32 params and no dtype, as the JAX package's
``module_config`` skips dtype fields, so workers, the service and the
export build fp32 nets from them) and the bench's ``--compute-dtype``.
Everything on the CPU (the kernels' plain versions)."""

import os

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
from handyrl_tpu_torch import bench
from handyrl_tpu_torch.config import ConfigError, apply_defaults
from handyrl_tpu_torch.model import ModelWrapper
from handyrl_tpu_torch.models.blocks import compute_dtype_of
from handyrl_tpu_torch.train import Learner


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread a process: the workers of a parallel run share
    the cores."""
    before, omp = torch.get_num_threads(), os.environ.get('OMP_NUM_THREADS')
    torch.set_num_threads(1)
    os.environ['OMP_NUM_THREADS'] = '1'
    yield
    torch.set_num_threads(before)
    if omp is None:
        os.environ.pop('OMP_NUM_THREADS', None)
    else:
        os.environ['OMP_NUM_THREADS'] = omp


def _raw(tmp_path, **extra):
    return {'env_args': {'env': 'TicTacToe'},
            'train_args': dict({
                'batch_size': 8, 'update_episodes': 20,
                'minimum_episodes': 20, 'epochs': 1, 'generation_envs': 8,
                'forward_steps': 8, 'num_batchers': 1,
                'compute_dtype': 'bfloat16',
                'model_dir': str(tmp_path / 'models')}, **extra)}


@pytest.mark.timeout(300)
def test_learner_bf16_compute(tmp_path):
    learner = Learner(apply_defaults(_raw(tmp_path)), device='cpu')
    assert compute_dtype_of(learner.module) == torch.bfloat16
    assert compute_dtype_of(learner.actor.module) == torch.bfloat16
    # params remain float32
    assert {t.dtype for t in learner.params.values()} == {torch.float32}
    obs = learner.env.observation(learner.env.players()[0])
    out = learner.actor.inference(obs)
    # numpy has no bf16: the host edge hands the bf16 values over as fp32
    assert out['policy'].dtype == np.float32
    learner.run()
    assert learner.model_epoch == 1
    # after training and checkpointing every param is still float32
    assert {t.dtype for t in learner.params.values()} == {torch.float32}
    # the checkpoint is the fp32 net's, loadable by the JAX package
    ckpt = tmp_path / 'models' / '1.ckpt'
    jw = JaxModelWrapper.from_snapshot(
        {'architecture': 'SimpleConv2dModel', 'params': ckpt.read_bytes()},
        obs)
    for leaf in jax.tree_util.tree_leaves(jw.params):
        assert leaf.dtype == np.float32


def test_snapshots_carry_no_dtype(tmp_path):
    learner = Learner(apply_defaults(_raw(tmp_path)), device='cpu')
    snap = learner.actor.snapshot()
    assert 'dtype' not in (snap.get('config') or {})
    fresh = ModelWrapper.from_snapshot(snap, device='cpu')
    assert compute_dtype_of(fresh.module) is None
    obs = learner.env.observation(learner.env.players()[0])
    assert fresh.module(torch.from_numpy(obs)[None])['policy'].dtype \
        == torch.float32


@pytest.mark.parametrize('value,ok', [('', True), ('float32', True),
                                      ('bfloat16', True), ('float16', False),
                                      ('bf16', False)])
def test_compute_dtype_config(tmp_path, value, ok):
    raw = _raw(tmp_path, compute_dtype=value)
    if ok:
        assert apply_defaults(raw)['train_args']['compute_dtype'] == value
    else:
        with pytest.raises(ConfigError, match='compute_dtype'):
            apply_defaults(raw)


def test_learner_float32_is_the_params_dtype(tmp_path):
    for value in ('', 'float32'):
        learner = Learner(apply_defaults(_raw(tmp_path, compute_dtype=value)),
                          device='cpu')
        assert compute_dtype_of(learner.module) is None


def test_bench_compute_dtype_on_the_cpu():
    line = bench.run_bench('cpu', steps=1, B=2, T=2, filters=16, layers=1,
                           compute_dtype='bfloat16')
    assert line['compute_dtype'] == 'bfloat16'
    assert all(np.isfinite(v) for v in line['losses'].values())
    assert line['nonfinite'] == 0
    assert bench.run_bench('cpu', steps=1, B=2, T=2, filters=16, layers=1
                           )['compute_dtype'] == 'float32'
    with pytest.raises(ValueError, match='compute_dtype'):
        bench.run_bench('cpu', steps=1, B=2, T=2, filters=16, layers=1,
                        compute_dtype='float16')
