"""The port's update step (handyrl_tpu_torch/ops/train_step.py) against the
JAX package's ``build_update_step`` (handyrl_tpu/ops/train_step.py) over
three steps, from the same weights on the same numpy batch: a small
GeeseNet (filters 16, 2 blocks) with torus_impl='pallas' on both sides (the
JAX trunk in Pallas interpret mode, the port's through TrunkFunction's
plain versions), B=4, T=4, the headline TD/TD config and UPGO/VTRACE. The
metrics, the params, Adam's mu, nu and count, and ``steps`` are compared
after every step; the random weights give pre-clip grad norms far above
4.0, so the clip is active. The non-finite guard is driven with a NaN lr
and a NaN observation.

Tolerances:
- metrics rtol = atol = 1e-4: loss sums and the grad norm are fp32 sums
  taken in other orders;
- mu and nu: rtol 1e-4, atol 1e-4 times the tensor's largest element (they
  carry the grads' reassociation, relative to the largest grad);
- params atol lr / 10 over three steps: Adam divides by sqrt(v_hat) + 1e-8,
  so an element whose gradient is near 1e-8 turns a reassociation of its
  gradient into a change of up to lr a step; observed below lr / 500."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_batch
from handyrl_tpu.models import build as jax_build
from handyrl_tpu.ops.losses import LossConfig as JaxLossConfig
from handyrl_tpu.ops.train_step import build_update_step as jax_build_step
from handyrl_tpu.ops.train_step import init_train_state as jax_init_state
from handyrl_tpu_torch.models.geese import (GeeseNet, params_from_flax,
                                            params_to_flax)
from handyrl_tpu_torch.ops import losses, train_step

FILTERS, LAYERS, B, T = 16, 2, 4, 4
LR = 1e-4
METRIC_TOL = dict(rtol=1e-4, atol=1e-4)
MOMENT_RTOL, MOMENT_ATOL_OF_MAX = 1e-4, 1e-4
PARAM_ATOL = LR / 10

_CACHE = {}


def _setup(policy_target, value_target):
    """JAX step and initial state, port step and state, batches (numpy and
    torch); the compiled JAX step is built once per config."""
    key = (policy_target, value_target)
    if key not in _CACHE:
        rng = np.random.RandomState(0)
        batch = _synthetic_batch(B, T, 1, (17, 7, 11), 4, rng)
        jm = jax_build('GeeseNet', filters=FILTERS, layers=LAYERS,
                       torus_impl='pallas')
        params = jm.init(jax.random.PRNGKey(0),
                         batch['observation'][:, 0, 0], None)
        kw = dict(turn_based_training=False, observation=True,
                  policy_target=policy_target, value_target=value_target,
                  gamma=0.99)
        jstep = jax_build_step(jm, JaxLossConfig(**kw), donate=False)
        net = GeeseNet(filters=FILTERS, layers=LAYERS, torus_impl='pallas')
        net.load_state_dict(params_from_flax(
            jax.tree_util.tree_map(np.asarray, params)))
        _CACHE[key] = (jstep, jax_init_state(params), net,
                       train_step.build_update_step(net,
                                                    losses.LossConfig(**kw)),
                       batch)
    jstep, jstate, net, step, batch = _CACHE[key]
    return jstep, jstate, step, train_step.init_train_state(net), batch


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _flat(tree):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, tree))


def _assert_states_match(jstate, state):
    assert int(jstate.steps) == int(state.steps)
    for k, want in _flat(jstate.params).items():
        np.testing.assert_allclose(state.params[k].numpy(), want.numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)
    adam = jstate.opt_state[2]
    assert int(adam.count) == int(state.opt_state.count)
    for name, jtree, got in (('mu', adam.mu, state.opt_state.mu),
                             ('nu', adam.nu, state.opt_state.nu)):
        for k, want in _flat(jtree).items():
            w = want.numpy()
            np.testing.assert_allclose(
                got[k].numpy(), w, rtol=MOMENT_RTOL,
                atol=MOMENT_ATOL_OF_MAX * np.abs(w).max(),
                err_msg='%s %s' % (name, k))


def _assert_metrics_match(jm, m):
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), err_msg=k,
                                   **METRIC_TOL)


@pytest.mark.parametrize('pt,vt', [('TD', 'TD'), ('UPGO', 'VTRACE')])
def test_three_steps_match_jax(pt, vt):
    jstep, jstate, step, state, batch = _setup(pt, vt)
    tb = _torch(batch)
    for _ in range(3):
        jstate, jm = jstep(jstate, batch, jnp.asarray(LR, jnp.float32))
        state, m = step(state, tb, torch.tensor(LR))
        _assert_metrics_match(jm, m)
        assert m['nonfinite'].item() == 0
        assert m['diag_grad_norm'].item() > train_step.CLIP_NORM   # clipped
        _assert_states_match(jstate, state)


@pytest.mark.parametrize('bad', ['lr', 'observation'])
def test_nonfinite_step_keeps_params_and_optimizer_state(bad):
    jstep, jstate, step, state, batch = _setup('TD', 'TD')
    tb = _torch(batch)
    # one good step first, so the kept moments and count are not zeros
    jstate, _ = jstep(jstate, batch, jnp.asarray(LR, jnp.float32))
    state, _ = step(state, tb, torch.tensor(LR))
    lr = LR
    if bad == 'lr':
        lr = float('nan')
    else:
        batch = dict(batch, observation=batch['observation'].copy())
        batch['observation'][1, 2, 0, 3, 4, 5] = np.nan
        tb = _torch(batch)
    jnew, jm = jstep(jstate, batch, jnp.asarray(lr, jnp.float32))
    new, m = step(state, tb, torch.tensor(lr))
    assert float(jm['nonfinite']) == m['nonfinite'].item() == 1.0
    _assert_metrics_match(jm, m)
    for k, v in m.items():
        if k != 'nonfinite':
            assert v.item() == 0.0, k
    assert int(new.steps) == int(state.steps) + 1 == int(jnew.steps)
    assert int(new.opt_state.count) == int(state.opt_state.count) == 1
    for k in state.params:
        assert torch.equal(new.params[k], state.params[k]), k
        assert torch.equal(new.opt_state.mu[k], state.opt_state.mu[k]), k
        assert torch.equal(new.opt_state.nu[k], state.opt_state.nu[k]), k
    _assert_states_match(jnew, new)


def test_update_leaves_the_given_state_as_it_was():
    _, _, step, state, batch = _setup('TD', 'TD')
    before = {k: v.clone() for k, v in state.params.items()}
    new, _ = step(state, _torch(batch), torch.tensor(LR))
    for k, v in before.items():
        assert torch.equal(state.params[k], v)
        assert not torch.equal(new.params[k], v)
    assert int(state.steps) == 0 and int(state.opt_state.count) == 0


def test_optimizer_state_maps_to_and_from_optax_layout():
    jstep, jstate, step, state, batch = _setup('TD', 'TD')
    jstate, _ = jstep(jstate, batch, jnp.asarray(LR, jnp.float32))
    adam = jstate.opt_state[2]
    loaded = train_step.opt_state_from_flax(
        adam.count, jax.tree_util.tree_map(np.asarray, adam.mu),
        jax.tree_util.tree_map(np.asarray, adam.nu), params_from_flax)
    assert loaded.count.dtype == torch.int32 and int(loaded.count) == 1
    back = train_step.opt_state_to_flax(loaded, params_to_flax)
    assert back['count'] == 1 and back['count'].dtype == np.int32
    for name in ('mu', 'nu'):
        want = jax.tree_util.tree_map(np.asarray, getattr(adam, name))
        got_leaves = jax.tree_util.tree_leaves(back[name])
        want_leaves = jax.tree_util.tree_leaves(want)
        assert (jax.tree_util.tree_structure(back[name])
                == jax.tree_util.tree_structure(want))
        for g, w in zip(got_leaves, want_leaves):
            np.testing.assert_array_equal(g, w)
