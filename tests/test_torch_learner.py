"""The port's local learner (handyrl_tpu_torch/train.py ``Learner``) end to
end on the CPU, after tests/test_geese_e2e.py, and its checkpoints against
the JAX package.

A small GeeseNet (filters 16, 2 blocks, 'pallas' trunk on its plain
version) trains Hungry Geese by batched self-play for 2 epochs (B=4, T=4,
4 envs, 8 episodes an epoch). Checked: the epoch and the episode and
result counts; ``1.ckpt``, ``2.ckpt``, ``latest.ckpt`` and
``trainer_state.ckpt``, each with a CRC sidecar the JAX package verifies;
the JAX package loads ``latest.ckpt`` and its forward matches the port's
within 1e-5 (fp32 sums in other orders); flax's ``from_bytes``, with the
template the JAX trainer restores into, reads ``trainer_state.ckpt`` and
every leaf equals the port's own reading of it (bit for bit: the same
bytes). Then the port resumes (``restart_epoch: 1``) from a ``1.ckpt`` and
``trainer_state.ckpt`` written by the JAX package after 8 update steps:
params, Adam's moments, ``steps`` and ``data_cnt_ema`` come back equal bit
for bit, and training goes on to epoch 2."""

import os
import pytest
import queue

import jax
import numpy as np
import torch
from flax import serialization

from handyrl_tpu.config import apply_defaults as jax_apply_defaults
from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
from handyrl_tpu.models import build as jax_build
from handyrl_tpu.ops.train_step import init_train_state as jax_init_state
from handyrl_tpu.train import Trainer as JaxTrainer
from handyrl_tpu.utils.fs import checksummed_write_bytes as jax_write
from handyrl_tpu.utils.fs import verify_checkpoint as jax_verify
from handyrl_tpu_torch.bench import synthetic_batch
from handyrl_tpu_torch.config import apply_defaults
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.model import ModelWrapper, load_params_bytes
from handyrl_tpu_torch.models.geese import GeeseNet, params_from_flax
from handyrl_tpu_torch.train import Learner
from handyrl_tpu_torch.utils import flax_msgpack


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
TRAIN = {'turn_based_training': False, 'observation': True, 'gamma': 0.99,
         'forward_steps': 4, 'compress_steps': 4, 'batch_size': 4,
         'policy_target': 'TD', 'value_target': 'TD', 'generation_envs': 4,
         'num_batchers': 1, 'minimum_episodes': 8, 'update_episodes': 8,
         'epochs': 2}
FILES = ('1.ckpt', '2.ckpt', 'latest.ckpt', 'trainer_state.ckpt')


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


def _flat(tree):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, tree))


def test_two_epochs_and_checkpoints_the_jax_package_reads(tmp_path):
    models = tmp_path / 'models'
    learner = Learner(apply_defaults(_raw(models)), net=_net(),
                      device='cpu')
    learner.run()
    assert not learner.trainer.failed
    assert learner.model_epoch == 2
    assert learner.num_returned_episodes >= 8 + 2 * 8
    n, _, _ = learner.generation_results.get(0, (0, 0, 0))
    assert n > 0 and learner.num_results > 0
    assert learner.epoch_steps[-1] > learner.epoch_steps[0] > 0
    for name in FILES:
        assert jax_verify(str(models / name)) == (True, 'ok'), name
    latest = (models / 'latest.ckpt').read_bytes()
    assert latest == (models / '2.ckpt').read_bytes()
    assert latest != (models / '1.ckpt').read_bytes()

    # the JAX package loads latest.ckpt; its forward matches the port's
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

    # flax reads trainer_state.ckpt into the JAX trainer's template
    raw = (models / 'trainer_state.ckpt').read_bytes()
    template = {'state': jax_init_state(jw.params), 'steps': 0,
                'data_cnt_ema': 0.0}
    restored = serialization.from_bytes(template, raw)
    ours = flax_msgpack.from_bytes(raw)
    assert restored['steps'] == ours['steps'] == learner.epoch_steps[-1]
    assert restored['data_cnt_ema'] == ours['data_cnt_ema']
    flax_state = serialization.to_state_dict(restored['state'])
    assert (jax.tree_util.tree_structure(flax_state)
            == jax.tree_util.tree_structure(ours['state']))
    for a, b in zip(jax.tree_util.tree_leaves(flax_state),
                    jax.tree_util.tree_leaves(ours['state'])):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(restored['state'].opt_state[2].count) == learner.epoch_steps[-1]
    for k, v in _flat(restored['state'].params).items():
        assert torch.equal(v, learner.params[k]), k


class _FixedBatches:
    def __init__(self, batches):
        self._batches = list(batches)

    def batch(self, timeout=None):
        if not self._batches:
            raise queue.Empty
        return self._batches.pop(0)


def test_resumes_from_the_jax_packages_checkpoints(tmp_path):
    models = tmp_path / 'models'
    models.mkdir()
    raw = _raw(models)
    jw = JaxModelWrapper(jax_build('GeeseNet', filters=16, layers=2), seed=5)
    jw.ensure_params(jax_make_env({'env': 'HungryGeese'}).observation(0))
    jt = JaxTrainer(jax_apply_defaults(raw)['train_args'], jw)
    jt.batcher = _FixedBatches(
        synthetic_batch(4, 4, 1, (17, 7, 11), 4, np.random.RandomState(i))
        for i in range(8))
    jt.update_flag = True
    params = jt.train()
    jax_write(str(models / '1.ckpt'), serialization.to_bytes(params))
    jax_write(str(models / 'trainer_state.ckpt'), jt.state_bytes())

    learner = Learner(apply_defaults(_raw(models, restart_epoch=1)),
                      net=_net(seed=1), device='cpu')
    assert learner.model_epoch == 1
    tr = learner.trainer
    assert (tr.steps, tr.data_cnt_ema) == (jt.steps, jt.data_cnt_ema) == (
        8, jt.data_cnt_ema)
    state = tr.update_step.state
    assert int(state.steps) == 8 and int(state.opt_state.count) == 8
    for k, v in _flat(jt.state.params).items():
        assert torch.equal(learner.params[k], v), k
        assert torch.equal(state.params[k].detach(), v), k
    adam = jt.state.opt_state[2]
    for name, tree, got in (('mu', adam.mu, state.opt_state.mu),
                            ('nu', adam.nu, state.opt_state.nu)):
        for k, v in _flat(tree).items():
            assert torch.equal(got[k], v), (name, k)

    learner.run()
    assert not tr.failed
    assert learner.model_epoch == 2
    assert learner.epoch_steps[-1] > 8
