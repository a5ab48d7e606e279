"""The update step on static buffers (handyrl_tpu_torch/ops/train_step.py
``StaticUpdateStep``, the body that ``GraphedUpdateStep`` captures as a CUDA
graph on the card) against the functional ``build_update_step`` and the JAX
package's jitted step, over three steps from the same weights on the same
numpy batch: a small GeeseNet (filters 16, 2 blocks, torus_impl='pallas';
the JAX trunk in Pallas interpret mode, the port's through TrunkFunction's
plain versions), B=4, T=4, TD/TD and UPGO/VTRACE. The graph itself needs a
card: chip_smoke.py's training phase holds it against the eager step and
the CPU there.

Tolerances:
- body against the functional step: none (torch.equal). Both run the same
  ops in the same order on the same device; only where the state lives
  differs.
- body against JAX: those of tests/test_torch_train_step.py, for the same
  reasons: metrics rtol = atol = 1e-4 (fp32 sums in other orders); mu and
  nu rtol 1e-4, atol 1e-4 of the tensor's largest element; params atol
  lr / 10 over three steps (Adam divides by sqrt(v_hat) + 1e-8, so a grad
  near 1e-8 turns its reassociation into a change of up to lr a step)."""

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
from handyrl_tpu_torch.models.geese import GeeseNet, params_from_flax
from handyrl_tpu_torch.ops import losses, train_step

FILTERS, LAYERS, B, T = 16, 2, 4, 4
LR = 1e-4
METRIC_TOL = dict(rtol=1e-4, atol=1e-4)
MOMENT_RTOL, MOMENT_ATOL_OF_MAX = 1e-4, 1e-4
PARAM_ATOL = LR / 10

_CACHE = {}


def _setup(pt, vt):
    """(JAX step, JAX state, port net, port cfg, numpy batch); the JAX step
    is compiled once per config."""
    if (pt, vt) not in _CACHE:
        batch = _synthetic_batch(B, T, 1, (17, 7, 11), 4,
                                 np.random.RandomState(0))
        jm = jax_build('GeeseNet', filters=FILTERS, layers=LAYERS,
                       torus_impl='pallas')
        params = jm.init(jax.random.PRNGKey(0),
                         batch['observation'][:, 0, 0], None)
        kw = dict(turn_based_training=False, observation=True,
                  policy_target=pt, value_target=vt, gamma=0.99)
        net = GeeseNet(filters=FILTERS, layers=LAYERS, torus_impl='pallas')
        net.load_state_dict(params_from_flax(
            jax.tree_util.tree_map(np.asarray, params)))
        _CACHE[(pt, vt)] = (
            jax_build_step(jm, JaxLossConfig(**kw), donate=False),
            jax_init_state(params), net, losses.LossConfig(**kw), batch)
    return _CACHE[(pt, vt)]


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _assert_states_equal(a, b):
    assert torch.equal(a.steps, b.steps)
    assert torch.equal(a.opt_state.count, b.opt_state.count)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        assert torch.equal(a.opt_state.mu[k], b.opt_state.mu[k]), k
        assert torch.equal(a.opt_state.nu[k], b.opt_state.nu[k]), k


def _assert_matches_jax(jstate, jm, state, m):
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), err_msg=k,
                                   **METRIC_TOL)
    assert int(jstate.steps) == int(state.steps)
    flat = lambda tree: params_from_flax(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, tree))
    for k, want in flat(jstate.params).items():
        np.testing.assert_allclose(state.params[k].numpy(), want.numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)
    adam = jstate.opt_state[2]
    assert int(adam.count) == int(state.opt_state.count)
    for name, jtree, got in (('mu', adam.mu, state.opt_state.mu),
                             ('nu', adam.nu, state.opt_state.nu)):
        for k, want in flat(jtree).items():
            w = want.numpy()
            np.testing.assert_allclose(
                got[k].numpy(), w, rtol=MOMENT_RTOL,
                atol=MOMENT_ATOL_OF_MAX * np.abs(w).max(),
                err_msg='%s %s' % (name, k))


@pytest.mark.parametrize('pt,vt', [('TD', 'TD'), ('UPGO', 'VTRACE')])
def test_static_body_matches_functional_step_and_jax(pt, vt):
    jstep, jstate, net, cfg, batch = _setup(pt, vt)
    update = train_step.build_update_step(net, cfg)
    state = train_step.init_train_state(net)
    static = train_step.StaticUpdateStep(net, cfg, state)
    tb = _torch(batch)
    for _ in range(3):
        jstate, jm = jstep(jstate, batch, jnp.asarray(LR, jnp.float32))
        state, m = update(state, tb, torch.tensor(LR))
        got = static(tb, torch.tensor(LR))
        assert list(got) == list(m)
        for k in m:
            assert torch.equal(got[k], m[k]), k
        assert got['nonfinite'].item() == 0
        assert got['diag_grad_norm'].item() > train_step.CLIP_NORM
        _assert_states_equal(static.state, state)
        _assert_matches_jax(jstate, jm, static.state, got)


def test_nan_lr_step_keeps_the_state_and_the_next_step_trains():
    _, _, net, cfg, batch = _setup('TD', 'TD')
    update = train_step.build_update_step(net, cfg)
    state = train_step.init_train_state(net)
    static = train_step.StaticUpdateStep(net, cfg, state)
    tb = _torch(batch)
    for lr in (LR, float('nan'), LR):
        before = static.state
        before = train_step.TrainState(
            params={k: v.clone() for k, v in before.params.items()},
            opt_state=train_step.AdamState(
                count=before.opt_state.count.clone(),
                mu={k: v.clone() for k, v in before.opt_state.mu.items()},
                nu={k: v.clone() for k, v in before.opt_state.nu.items()}),
            steps=before.steps.clone())
        state, m = update(state, tb, torch.tensor(lr))
        got = static(tb, torch.tensor(lr))
        _assert_states_equal(static.state, state)
        assert int(static.state.steps) == int(before.steps) + 1
        if lr != lr:   # the guard: params, moments and count are kept
            assert got['nonfinite'].item() == 1.0
            assert all(v.item() == 0.0 for k, v in got.items()
                       if k != 'nonfinite')
            _assert_states_equal(static.state, before._replace(
                steps=static.state.steps))
        else:
            assert got['nonfinite'].item() == 0.0
            assert int(static.state.opt_state.count) == int(
                before.opt_state.count) + 1
            assert not any(torch.equal(static.state.params[k], v)
                           for k, v in before.params.items())
    assert int(static.state.opt_state.count) == 2
    assert int(static.state.steps) == 3


def test_metrics_do_not_alias_the_static_buffers():
    _, _, net, cfg, batch = _setup('TD', 'TD')
    static = train_step.StaticUpdateStep(net, cfg,
                                         train_step.init_train_state(net))
    tb = _torch(batch)
    first = static(tb, torch.tensor(LR))
    kept = {k: v.clone() for k, v in first.items()}
    buffers = ([*static.state.params.values(),
                *static.state.opt_state.mu.values(),
                *static.state.opt_state.nu.values(),
                static.state.opt_state.count, static.state.steps]
               + [v for b in static._batches.values() for v in b.values()])
    spans = [(t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
             for t in buffers]
    for k, v in first.items():
        assert not any(lo <= v.data_ptr() < hi for lo, hi in spans), k
    second = static(tb, torch.tensor(LR))
    assert not torch.equal(second['total'], kept['total'])
    for k, v in first.items():
        assert torch.equal(v, kept[k]), k


def test_the_static_step_takes_its_own_copy_of_the_state():
    _, _, net, cfg, batch = _setup('TD', 'TD')
    state = train_step.init_train_state(net)
    given = {k: v.clone() for k, v in state.params.items()}
    static = train_step.StaticUpdateStep(net, cfg, state)
    static(_torch(batch), torch.tensor(LR))
    for k, v in given.items():
        assert torch.equal(state.params[k], v), k
        assert not torch.equal(static.state.params[k], v), k
    assert int(state.steps) == 0 and int(static.state.steps) == 1


def test_graphed_builder_raises_for_a_cpu_module():
    _, _, net, cfg, _ = _setup('TD', 'TD')
    with pytest.raises(ValueError, match='CUDA'):
        train_step.build_graphed_update_step(
            net, cfg, train_step.init_train_state(net))


def test_a_batch_on_another_device_raises():
    _, _, net, cfg, batch = _setup('TD', 'TD')
    static = train_step.StaticUpdateStep(net, cfg,
                                         train_step.init_train_state(net))
    tb = {k: v.to('meta') for k, v in _torch(batch).items()}
    with pytest.raises(ValueError, match='meta'):
        static(tb, torch.tensor(LR))
