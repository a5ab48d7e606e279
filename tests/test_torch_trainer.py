"""The port's Trainer (handyrl_tpu_torch/train.py) against the JAX package's
(handyrl_tpu/train.py), fed the same fixed batches in the same order.

A small GeeseNet (filters 16, 2 blocks; the JAX side's 'pad' trunk, the
port's 'pallas' trunk on its plain version) starts from the same weights
(``params_from_flax``). Each trainer's batcher is replaced by a list of 8
seeded synthetic batches (B=4, T=4, the bench's batch of real shapes), and
with the epoch's update already asked for, ``train()`` runs exactly one
drain of 8 steps, as in the learner's loop. After the epoch: the learning
rates (the EMA schedule) and ``steps`` and ``data_cnt_ema`` equal; params
and Adam's moments within the tolerances of tests/test_torch_train_step.py
(params lr / 10 per step, here over 8 steps; moments 1e-4 relative plus
1e-4 of each leaf's largest element). The non-finite guard is driven by a
NaN learning rate at steps 2 and 3: under 'skip' both trainers skip them
and end in the same state; under 'rollback' (after 2) both restore the
state their rollback source gives; under 'abort' both raise. A state of
another net is refused without a change."""

import queue

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu.config import apply_defaults as jax_apply_defaults
from handyrl_tpu.guard import ChaosNaN
from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
from handyrl_tpu.models import build as jax_build
from handyrl_tpu.train import Trainer as JaxTrainer
from handyrl_tpu_torch.bench import synthetic_batch
from handyrl_tpu_torch.config import apply_defaults
from handyrl_tpu_torch.models.geese import GeeseNet, params_from_flax
from handyrl_tpu_torch.train import Trainer

B, T, STEPS = 4, 4, 8
MOMENT_RTOL, MOMENT_ATOL_OF_MAX = 1e-4, 1e-4
NAN_STEPS = (2, 3)


class _FixedBatches:
    """A batcher that hands out the given batches, then runs dry."""

    def __init__(self, batches):
        self._batches = list(batches)

    def batch(self, timeout=None):
        if not self._batches:
            raise queue.Empty
        return self._batches.pop(0)

    def stop(self):
        pass


def _batches():
    return [synthetic_batch(B, T, 1, (17, 7, 11), 4,
                            np.random.RandomState(100 + i))
            for i in range(STEPS)]


def _train_args(guard=None):
    raw = {'env_args': {'env': 'HungryGeese'},
           'train_args': {'turn_based_training': False, 'observation': True,
                          'gamma': 0.99, 'forward_steps': T, 'batch_size': B,
                          'policy_target': 'TD', 'value_target': 'TD',
                          'guard': guard or {}}}
    return jax_apply_defaults(raw)['train_args'], \
        apply_defaults(raw)['train_args']


def _trainers(guard=None):
    jax_args, args = _train_args(guard)
    jm = jax_build('GeeseNet', filters=16, layers=2)
    jw = JaxModelWrapper(jm, seed=0)
    jw.ensure_params(np.zeros((17, 7, 11), np.float32))
    jt = JaxTrainer(jax_args, jw)
    net = GeeseNet(filters=16, layers=2, torus_impl='pallas')
    net.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, jw.params)))
    pt = Trainer(args, net)
    for tr in (jt, pt):
        tr.batcher = _FixedBatches(_batches())
        tr.update_flag = True      # the epoch's update is asked for
        tr.lrs = []
        lr = tr._lr

        def recording_lr(tr=tr, lr=lr):
            tr.lrs.append(lr())
            return tr.lrs[-1]
        tr._lr = recording_lr
    return jt, pt


def _nan_at(tr, steps):
    """The port's trainer takes a NaN lr at ``steps``."""
    lr = tr._lr

    def poisoned():
        value = lr()
        return float('nan') if tr.steps in steps else value
    tr._lr = poisoned


def _assert_states_match(jt, pt, lr_bound):
    assert int(jt.state.steps) == int(pt.update_step.state.steps) \
        == jt.steps == pt.steps
    _assert_params_and_moments_match(jt, pt, lr_bound)


def _assert_params_and_moments_match(jt, pt, lr_bound):
    state = pt.update_step.state
    for k, want in params_from_flax(
            jax.tree_util.tree_map(np.asarray, jt.state.params)).items():
        np.testing.assert_allclose(state.params[k].detach().numpy(),
                                   want.numpy(), rtol=0,
                                   atol=lr_bound / 10 * STEPS, err_msg=k)
    adam = jt.state.opt_state[2]
    assert int(adam.count) == int(state.opt_state.count)
    for name, tree, got in (('mu', adam.mu, state.opt_state.mu),
                            ('nu', adam.nu, state.opt_state.nu)):
        for k, want in params_from_flax(
                jax.tree_util.tree_map(np.asarray, tree)).items():
            w = want.numpy()
            np.testing.assert_allclose(
                got[k].numpy(), w, rtol=MOMENT_RTOL,
                atol=MOMENT_ATOL_OF_MAX * np.abs(w).max(),
                err_msg='%s %s' % (name, k))


def test_one_epoch_matches_the_jax_trainer():
    jt, pt = _trainers()
    jparams = jt.train()
    params = pt.train()
    assert pt.lrs == jt.lrs and len(pt.lrs) == STEPS
    assert pt.steps == jt.steps == STEPS
    assert pt.data_cnt_ema == jt.data_cnt_ema
    _assert_states_match(jt, pt, max(pt.lrs))
    # the handed-over params are the state's, on the host
    for k, v in params.items():
        assert v.device.type == 'cpu'
        assert torch.equal(v, pt.update_step.state.params[k])
    assert jparams is not None
    assert set(pt.last_losses) == {'p', 'v', 'ent', 'total'}


def test_nan_lr_is_skipped_like_the_jax_trainer():
    jt, pt = _trainers({'nonfinite_policy': 'skip'})
    jt.chaos_nan = ChaosNaN({'nanstep': NAN_STEPS[0],
                             'nanburst': len(NAN_STEPS)})
    _nan_at(pt, NAN_STEPS)
    jt.train()
    pt.train()
    assert pt.guard.total_bad == jt.guard.total_bad == len(NAN_STEPS)
    assert int(pt.update_step.state.opt_state.count) == STEPS - len(NAN_STEPS)
    assert pt.data_cnt_ema == jt.data_cnt_ema
    _assert_states_match(jt, pt, max(pt.lrs))


def test_nan_lr_aborts_like_the_jax_trainer():
    jt, pt = _trainers({'nonfinite_policy': 'abort'})
    jt.chaos_nan = ChaosNaN({'nanstep': NAN_STEPS[0],
                             'nanburst': len(NAN_STEPS)})
    _nan_at(pt, NAN_STEPS)
    for tr in (jt, pt):
        with pytest.raises(RuntimeError, match='abort'):
            tr.train()


def test_nan_burst_rolls_back_like_the_jax_trainer():
    """Under 'rollback' with rollback_after 2, the NaN-lr steps 2 and 3 trip
    a rollback at the drain: each trainer restores the state its
    ``rollback_source`` gives (its own state before the epoch) in place,
    steps and the lr EMA included, and names the epoch to rewind to."""
    jt, pt = _trainers({'nonfinite_policy': 'rollback',
                        'rollback_after': 2})
    jt.chaos_nan = ChaosNaN({'nanstep': NAN_STEPS[0],
                             'nanburst': len(NAN_STEPS)})
    _nan_at(pt, NAN_STEPS)
    for tr in (jt, pt):
        blob = tr.state_bytes()
        tr.rollback_source = lambda blob=blob: (1, blob)
        tr.train()
    assert jt.rollback_epoch == pt.rollback_epoch == 1
    assert jt.guard.rollbacks == pt.guard.rollbacks == 1
    # the restored state's steps are 0; both loops then count the step
    # whose drain rolled back, as the reference does
    assert int(jt.state.steps) == int(pt.update_step.state.steps) == 0
    assert jt.steps == pt.steps == 1
    assert pt.data_cnt_ema == jt.data_cnt_ema
    _assert_params_and_moments_match(jt, pt, max(pt.lrs))
    assert int(pt.update_step.state.opt_state.count) == 0


def test_a_state_of_another_net_is_refused_and_changes_nothing():
    _, pt = _trainers()
    before = {k: v.detach().clone()
              for k, v in pt.update_step.state.params.items()}
    other = Trainer(_train_args()[1], GeeseNet(filters=16, layers=3))
    with pytest.raises(ValueError, match='do not match'):
        pt.load_state_bytes(other.state_bytes())
    assert pt.steps == 0
    for k, v in pt.update_step.state.params.items():
        assert torch.equal(v, before[k]), k
