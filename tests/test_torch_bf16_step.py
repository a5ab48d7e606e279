"""The update step with the net in bf16 (``compute_dtype: 'bfloat16'``):
the port's step (handyrl_tpu_torch/ops/train_step.py) against the JAX
package's ``build_update_step`` on the same GeeseNet built with
``dtype=jnp.bfloat16`` (flax's module dtype, the params fp32), one step
from the same weights on the same numpy batch of 0/1 boards: filters 16,
2 blocks, ``torus_impl='pallas'`` on both sides (the JAX trunk in Pallas
interpret mode, the port's through TrunkFunction's plain bf16 versions),
B=4, T=4, TD/TD and UPGO/VTRACE. Then the step's other forms in bf16: the
static body of the graphed step and the replay trainer's K-step, each
equal to the functional step; and a recurrent net's window state in the
compute dtype.

Tolerances (bf16 has 8 significant bits, eps 2^-8):
- the metrics within METRIC_RTOL = 1e-2 of max(|value|, 1): the losses
  are fp32 sums of bf16 outputs (masked by the fp32 masks, as in JAX), so
  they carry a flipped rounding of an output (below 1e-5 of the total
  seen) and the grad norm the backward's (2e-4 seen);
- Adam's first moment (0.1 x the clipped grad) within MU_RTOL = 2^-5 of
  each leaf's largest element: JAX's bf16 vjp rounds each tap's product
  and each tile's weight grad to bf16, the port's backward fewer values
  (CHANGES.md); below 0.8% seen;
- the params within 2 lr + 1e-7: Adam's first step moves each element by
  about lr times the sign of its grad, and a grad within bf16 rounding of
  0 may take the other sign (2 lr seen);
- every param and moment fp32 on both sides, count and steps equal.
"""

import os

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
from handyrl_tpu_torch.models.blocks import set_compute_dtype
from handyrl_tpu_torch.models.geese import (GeeseNet, GeeseNetLSTM,
                                            params_from_flax)
from handyrl_tpu_torch.ops import losses, train_step

FILTERS, LAYERS, B, T = 16, 2, 4, 4
LR = 1e-4
METRIC_RTOL = 1e-2
MU_RTOL = 2.0 ** -5
PARAM_ATOL = 2 * LR + 1e-7


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


def _batch(seed=0):
    """The JAX package's synthetic batch with 0/1 boards for observations
    (uniform noise planes saturate the net: every grad 0)."""
    rng = np.random.RandomState(seed)
    batch = _synthetic_batch(B, T, 1, (17, 7, 11), 4, rng)
    batch['observation'] = (rng.rand(*batch['observation'].shape)
                            < 0.15).astype(np.float32)
    return batch


def _cfg(pt, vt):
    return dict(turn_based_training=False, observation=True,
                policy_target=pt, value_target=vt, gamma=0.99)


def _flat(tree):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, tree))


def _bf16_net(params=None):
    net = GeeseNet(filters=FILTERS, layers=LAYERS, torus_impl='pallas',
                   generator=torch.Generator().manual_seed(1))
    if params is not None:
        net.load_state_dict(_flat(params))
    return set_compute_dtype(net, 'bfloat16')


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.timeout(300)
@pytest.mark.parametrize('pt,vt', [('TD', 'TD'), ('UPGO', 'VTRACE')])
def test_one_bf16_step_matches_jax(pt, vt):
    batch = _batch()
    params = jax_build('GeeseNet', filters=FILTERS, layers=LAYERS).init(
        jax.random.PRNGKey(0), batch['observation'][:, 0, 0], None)
    jm = jax_build('GeeseNet', filters=FILTERS, layers=LAYERS,
                   torus_impl='pallas', pallas_tile=B * T,
                   dtype=jnp.bfloat16)
    jstep = jax_build_step(jm, JaxLossConfig(**_cfg(pt, vt)), donate=False)
    jstate, jmet = jstep(jax_init_state(params), batch,
                         jnp.asarray(LR, jnp.float32))
    net = _bf16_net(params)
    step = train_step.build_update_step(net, losses.LossConfig(**_cfg(pt,
                                                                      vt)))
    state, met = step(train_step.init_train_state(net), _torch(batch),
                      torch.tensor(LR))
    assert set(met) == set(jmet)
    for k in jmet:
        want = float(jmet[k])
        assert abs(met[k].item() - want) <= METRIC_RTOL * max(abs(want), 1.0), (
            k, met[k].item(), want)
    assert met['nonfinite'].item() == 0
    assert met['diag_grad_norm'].item() > 0
    adam = jstate.opt_state[2]
    assert int(adam.count) == int(state.opt_state.count) == 1
    assert int(jstate.steps) == int(state.steps) == 1
    jparams, jmu = _flat(jstate.params), _flat(adam.mu)
    for k, want in jparams.items():
        got = state.params[k]
        assert got.dtype == torch.float32
        assert state.opt_state.mu[k].dtype == torch.float32
        assert state.opt_state.nu[k].dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
        mu, jm_ = state.opt_state.mu[k].numpy(), jmu[k].numpy()
        assert np.abs(mu - jm_).max() <= MU_RTOL * np.abs(jm_).max(), k
    for leaf in jax.tree_util.tree_leaves(jstate.params):
        assert leaf.dtype == jnp.float32


@pytest.mark.timeout(300)
def test_static_and_replay_steps_in_bf16_are_the_functional_step():
    batch = _torch(_batch(1))
    cfg = losses.LossConfig(**_cfg('VTRACE', 'VTRACE'))
    net = _bf16_net()
    update = train_step.build_update_step(net, cfg)
    state = train_step.init_train_state(net)
    static = train_step.StaticUpdateStep(net, cfg, state)
    for _ in range(2):
        state, m = update(state, batch, torch.tensor(LR))
        got = static(batch, torch.tensor(LR))
        for k in m:
            assert torch.equal(got[k], m[k]), k
    for k in state.params:
        assert torch.equal(static.state.params[k], state.params[k]), k
        assert static.state.params[k].dtype == torch.float32
    # the replay trainer's K-step on a ring of the same windows: the slots
    # it draws, replayed through the functional step, give its state
    cap = B
    flat = {k: torch.cat([v.reshape(cap, -1), torch.zeros((1, v[0].numel()),
                                                           dtype=v.dtype)])
            for k, v in batch.items()}
    spec = {k: (tuple(v.shape[1:]), v.dtype) for k, v in batch.items()}
    net2 = _bf16_net()
    replay = train_step.ReplayUpdateStep(net2, cfg,
                                         train_step.init_train_state(net2))
    replay.bind(flat, spec, torch.tensor(cap), torch.tensor(0), cap, B, None)
    g = torch.Generator().manual_seed(3)
    slots = torch.randint(0, cap, (2, B), generator=g)
    replay.run(2, float(B * T), slots=slots)
    state = train_step.init_train_state(net2)
    for i in range(2):
        sb = {k: flat[k][slots[i]].reshape((B,) + spec[k][0]) for k in flat}
        lr = (torch.tensor(float(B * T)) * 3e-8
              / (1 + state.steps.float() * 1e-5))
        state, _ = update(state, sb, lr)
    for k in state.params:
        assert torch.equal(replay.state.params[k], state.params[k]), k
        assert replay.state.opt_state.mu[k].dtype == torch.float32


def test_a_recurrent_window_starts_in_the_compute_dtype():
    net = set_compute_dtype(GeeseNetLSTM(filters=8, stem_layers=1),
                            torch.bfloat16)
    batch = {'value': torch.zeros(3, 2, 4, 1)}
    h, c = train_step.init_hidden_for(net, batch)
    assert h.dtype == c.dtype == torch.bfloat16
    assert tuple(h.shape) == (3, 4, 7, 11, 8)
    obs = torch.from_numpy((np.random.RandomState(0).rand(5, 17, 7, 11)
                            < 0.2).astype(np.float32))
    out = net(obs, net.init_hidden((5,)))
    assert out['policy'].dtype == out['hidden'][0].dtype == torch.bfloat16
    # the learner's gated state is fp32 (the state times the fp32 mask):
    # the cell then runs in fp32, as JAX promotes it
    gated = tuple(t.float() for t in net.init_hidden((5,)))
    assert net(obs, gated)['hidden'][1].dtype == torch.float32
