"""The turn-based (compact) training path of the port against the JAX
package, on TicTacToe episodes: ``turn_based_training`` True with
``observation`` False, the default of both packages and the README's quick
start.

Episodes come from both packages' ``BatchedGenerator`` with the full-width
``SimpleConv2dModel`` (weights carried from flax) and the same seeds, and
must be the same episodes. On them:

- ``make_batch`` of both packages gives the same compact batch, bit for bit
  (numpy only): observations, actions, probabilities and action masks with
  a player axis of 1, values, masks and outcomes with 2;
- ``compute_loss`` gives the same loss terms, data count, diagnostics and
  gradients for TD/TD, UPGO/VTRACE and MC/MC, within the tolerances of
  tests/test_torch_losses.py (loss sums rtol 1e-5 / atol 1e-4; grads rtol
  1e-4 / atol 2e-5 of each tensor's largest element: fp32 sums in other
  orders);
- the value targets of the two-player blend (K3's plain version at P=2
  with the turn player's rhos broadcast from P=1) equal the JAX Pallas
  kernel's in interpret mode and the JAX scan's within 1e-5 (the fused
  multiply-adds of the recursion round differently);
- one Adam step (functional and on static buffers, the learner's body)
  gives the JAX step's metrics, params and moments within
  tests/test_torch_train_step.py's tolerances (metrics 1e-4; params lr / 10:
  Adam turns a reassociated grad near 1e-8 into a step of up to lr;
  moments rtol 1e-4, atol 1e-4 of the largest element)."""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.generation import BatchedGenerator as JaxBatchedGenerator
from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
from handyrl_tpu.models.tictactoe import SimpleConv2dModel as JaxModel
from handyrl_tpu.ops import batch as jax_batch
from handyrl_tpu.ops import pallas_targets as jax_pallas
from handyrl_tpu.ops.losses import LossConfig as JaxLossConfig
from handyrl_tpu.ops.losses import compute_loss as jax_compute_loss
from handyrl_tpu.ops.losses import forward_prediction as jax_forward
from handyrl_tpu.ops.targets import compute_target as jax_compute_target
from handyrl_tpu.ops.train_step import build_update_step as jax_build_step
from handyrl_tpu.ops.train_step import init_train_state as jax_init_state
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.generation import BatchedGenerator
from handyrl_tpu_torch.model import ModelWrapper
from handyrl_tpu_torch.models.tictactoe import (SimpleConv2dModel,
                                                params_from_flax)
from handyrl_tpu_torch.ops import batch, losses, targets, train_step


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


B = 16
LR = 1e-4
LOSS_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 2e-5
TARGET_TOL = 1e-5
METRIC_TOL = dict(rtol=1e-4, atol=1e-4)
MOMENT_RTOL, MOMENT_ATOL_OF_MAX = 1e-4, 1e-4
PARAM_ATOL = LR / 10
CASES = [('TD', 'TD'), ('UPGO', 'VTRACE'), ('MC', 'MC')]
# the actor's weights play the episodes, the learner's (another init) train
# on them, so the importance ratios are off 1 and their clip counts are
# not decided by rounding
ACTOR_KEY, TRAIN_KEY = 2, 4
_CACHE = {}


def _params(key=TRAIN_KEY):
    """A flax init of the full-width model (the tree a trained JAX model
    has: maps in sorted key order)."""
    if key not in _CACHE:
        params = JaxModel().init(jax.random.PRNGKey(key),
                                 np.zeros((1, 3, 3, 3), np.float32))
        _CACHE[key] = jax.tree_util.tree_map(np.asarray, params)
    return _CACHE[key]


def _net(key=TRAIN_KEY):
    net = SimpleConv2dModel()
    net.load_state_dict(params_from_flax(_params(key)))
    return net


def _generate(gen_cls, make, wrapper, n=40, seed=3):
    np.random.seed(seed)
    random.seed(seed)
    gen = gen_cls(lambda i: make({'env': 'TicTacToe', 'id': i}), wrapper,
                  {'observation': False, 'gamma': 0.8, 'compress_steps': 4},
                  n_envs=8)
    eps = []
    while len(eps) < n:
        eps += gen.step()
    return eps


def _episodes():
    """(port episodes, JAX episodes) of the same weights and seeds."""
    if 'eps' not in _CACHE:
        jw = JaxModelWrapper(JaxModel(), _params(ACTOR_KEY))
        pw = ModelWrapper(_net(ACTOR_KEY), device='cpu')
        _CACHE['eps'] = (_generate(BatchedGenerator, make_env, pw),
                         _generate(JaxBatchedGenerator, jax_make_env, jw))
    return _CACHE['eps']


def _args(forward_steps):
    return {'turn_based_training': True, 'observation': False,
            'forward_steps': forward_steps, 'burn_in_steps': 0,
            'compress_steps': 4, 'maximum_episodes': 100}


def _batches(forward_steps, seed=0):
    """(port batch, JAX batch) of the same window draws from the JAX
    package's episodes."""
    eps = _episodes()[1]
    args = _args(forward_steps)
    out = []
    for mod in (batch, jax_batch):
        random.seed(seed)
        sel = [mod.select_episode(eps, args) for _ in range(B)]
        out.append(mod.make_batch(sel, args))
    return out


def _torch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _cfgs(pt, vt):
    kw = dict(turn_based_training=True, observation=False, policy_target=pt,
              value_target=vt, gamma=0.8, lmb=0.7)
    return JaxLossConfig(**kw), losses.LossConfig(**kw)


def test_generator_gives_the_reference_episodes():
    """Same records: args, steps, outcomes and every moment; value and
    prob within 1e-5 (fp32 forwards of the same weights)."""
    got, want = _episodes()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g['args'] == w['args']
        assert (g['steps'], g['outcome']) == (w['steps'], w['outcome'])
        gm = batch.decompress_moments(g['moment'])
        wm = batch.decompress_moments(w['moment'])
        for a, b in zip(gm, wm):
            assert a['turn'] == b['turn'] and len(a['turn']) == 1
            for key in ('observation', 'action', 'action_mask', 'reward',
                        'return', 'value', 'selected_prob'):
                for p in (0, 1):
                    if b[key][p] is None:
                        assert a[key][p] is None, (key, p)
                    else:
                        np.testing.assert_allclose(
                            np.asarray(a[key][p], np.float64),
                            np.asarray(b[key][p], np.float64), rtol=0,
                            atol=1e-5, err_msg=key)
    # only the turn player runs the net: the other's value stays None
    m = batch.decompress_moments(got[0]['moment'])[0]
    other = 1 - m['turn'][0]
    assert m['value'][other] is None and m['observation'][other] is None


@pytest.mark.parametrize('forward_steps', [4, 16])
def test_make_batch_matches_the_reference(forward_steps):
    got, want = _batches(forward_steps)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    T = forward_steps
    assert got['observation'].shape == (B, T, 1, 3, 3, 3)
    for k in ('selected_prob', 'action'):
        assert got[k].shape == (B, T, 1, 1), k
    assert got['action_mask'].shape == (B, T, 1, 9)
    for k in ('value', 'turn_mask', 'observation_mask'):
        assert got[k].shape == (B, T, 2, 1), k
    assert got['outcome'].shape == (B, 1, 2, 1)
    # one acting seat a ply on real steps, none on padding
    np.testing.assert_array_equal(got['turn_mask'].sum(axis=(2, 3)),
                                  got['episode_mask'][:, :, 0, 0])


@pytest.mark.parametrize('pt,vt', CASES)
def test_losses_and_grads_match_jax(pt, vt):
    batch_np = _batches(16, seed=1)[1]
    jcfg, cfg = _cfgs(pt, vt)

    def jloss(p):
        return jax_compute_loss(JaxModel().apply, p, None, batch_np, jcfg)
    (_, jaux), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        _params())

    net = _net()
    live = {k: v.detach().requires_grad_(True)
            for k, v in net.named_parameters()}

    def apply_fn(p, obs, hidden):
        return torch.func.functional_call(net, p, (obs, hidden))
    total, aux = losses.compute_loss(apply_fn, live, None, _torch(batch_np),
                                     cfg)
    grads = dict(zip(live, torch.autograd.grad(total, list(live.values()))))

    assert set(aux['losses']) == set(jaux['losses']) == {'p', 'v', 'ent',
                                                         'total'}
    for k, v in aux['losses'].items():
        np.testing.assert_allclose(v.item(), float(jaux['losses'][k]),
                                   err_msg=k, **LOSS_TOL)
    assert aux['data_count'].item() == float(jaux['data_count'])
    for k, v in aux['diag'].items():
        np.testing.assert_allclose(v.item(), float(jaux['diag'][k]),
                                   err_msg=k, **LOSS_TOL)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    for k, g in grads.items():
        w = want[k].numpy()
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(g.numpy(), w, err_msg=k, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_OF_MAX * np.abs(w).max())


def _blended_values(batch_np):
    """The value targets' inputs as compute_loss forms them on the compact
    batch: the JAX forward's values broadcast to P=2 by observation_mask,
    blended with the opponent's negation, bootstrapped past the end."""
    jcfg, _ = _cfgs('TD', 'TD')
    out = jax_forward(JaxModel().apply, _params(), None, batch_np, jcfg)
    v = np.asarray(out['value'])
    om = batch_np['observation_mask']
    om_opp = om[:, :, ::-1]
    blend = (v * om - v[:, :, ::-1] * om_opp) / (om + om_opp + 1e-8)
    em = batch_np['episode_mask']
    values = blend * em + batch_np['outcome'] * (1 - em)
    masks = np.clip(om + om_opp, 0, 1)
    return values.astype(np.float32), masks.astype(np.float32)


@pytest.mark.parametrize('algorithm', ['TD', 'UPGO', 'VTRACE'])
def test_value_targets_at_two_players_match_jax(algorithm):
    batch_np = _batches(16, seed=2)[1]
    values, masks = _blended_values(batch_np)
    assert values.shape == (B, 16, 2, 1)
    rng = np.random.RandomState(5)
    rhos = rng.uniform(0, 1, (B, 16, 1, 1)).astype(np.float32)
    cs = rng.uniform(0, 1, (B, 16, 1, 1)).astype(np.float32)
    args = (values, batch_np['outcome'], None, 0.7, 1.0, rhos, cs, masks)
    got = targets.compute_target(algorithm, *[
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        for a in args])
    want = jax_compute_target(algorithm, *args, use_pallas=False)
    for g, w in zip(got, want):
        assert g.shape == (B, 16, 2, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TARGET_TOL)
    if algorithm == 'TD':   # K3's TPU kernel, in interpret mode
        lam = (0.7 + 0.3 * (1 - masks)).astype(np.float32)
        pal = jax_pallas.td_lambda_pallas(values, batch_np['outcome'], None,
                                          lam, 1.0, interpret=True)
        for g, w in zip(got, pal):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=TARGET_TOL)


def _assert_states_match(jstate, state):
    flat = lambda t: params_from_flax(jax.tree_util.tree_map(np.asarray, t))
    assert int(jstate.steps) == int(state.steps)
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


@pytest.mark.parametrize('pt,vt', CASES[:2])
def test_one_adam_step_matches_jax(pt, vt):
    batch_np = _batches(16, seed=3)[1]
    jcfg, cfg = _cfgs(pt, vt)
    jstep = jax_build_step(JaxModel(), jcfg, donate=False)
    jstate, jm = jstep(jax_init_state(_params()), batch_np,
                       jnp.asarray(LR, jnp.float32))
    net = _net()
    state, m = train_step.build_update_step(net, cfg)(
        train_step.init_train_state(net), _torch(batch_np), torch.tensor(LR))
    static = train_step.StaticUpdateStep(net, cfg,
                                         train_step.init_train_state(net))
    sm = static(_torch(batch_np), torch.tensor(LR))
    for metrics, st in ((m, state), (sm, static.state)):
        assert set(metrics) == set(jm)
        for k in jm:
            np.testing.assert_allclose(metrics[k].item(), float(jm[k]),
                                       err_msg=k, **METRIC_TOL)
        assert metrics['nonfinite'].item() == 0
        _assert_states_match(jstate, st)
    moved = [k for k, v in net.named_parameters()
             if not torch.equal(static.state.params[k], v.detach())]
    assert len(moved) == 18
