"""The port's loss pipeline (handyrl_tpu_torch/ops/losses.py) against the JAX
package's (handyrl_tpu/ops/losses.py) on a small GeeseNet (filters 16,
2 blocks), the same numpy batch and the same weights: every loss term, the
data count, the diagnostics, and the gradients of the total loss, for
TD/TD, UPGO/VTRACE and MC/MC, on the solo batch the headline step uses and
on a turn-based two-player batch (value symmetrization, terminal
bootstrap after the episode ends, illegal-action masks).

The JAX net runs with torus_impl='pallas' (the Pallas trunk in interpret
mode, its backward the TPU kernel's jax.vjp); the port's with 'pallas' too
(TrunkFunction, on the CPU the plain forward and the hand-derived
backward).

Tolerances: loss sums rtol 1e-5 / atol 1e-4 (fp32 sums over B*T*P terms of
order 1); grads rtol 1e-4 and atol 2e-5 times the tensor's largest element:
each element is a sum over N*77 pixels of terms as large as that, taken in
other orders through two normalised layers, so a small element carries the
rounding of the large ones (observed up to 3e-6 of the largest)."""

import os
import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_batch
from handyrl_tpu.models import build as jax_build
from handyrl_tpu.ops.losses import LossConfig as JaxLossConfig
from handyrl_tpu.ops.losses import compute_loss as jax_compute_loss
from handyrl_tpu_torch.models.geese import GeeseNet, params_from_flax
from handyrl_tpu_torch.ops import losses


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


FILTERS, LAYERS, B, T = 16, 2, 4, 4
LOSS_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 2e-5


def turn_based_batch(B, T, rng):
    """Two players alternating turns, only the turn player observing; some
    episodes end inside the window (episode_mask 0 afterwards) and some
    actions are illegal (action_mask 1e32), never the one taken."""
    P = 2
    turn = np.zeros((B, T, P, 1), np.float32)
    first = rng.randint(0, 2, B)
    for b in range(B):
        for t in range(T):
            turn[b, t, (first[b] + t) % 2] = 1
    emask = np.ones((B, T, P, 1), np.float32)
    for b in range(0, B, 2):
        emask[b, T - 1 - b % T:] = 0
    action = rng.randint(0, 4, (B, T, P, 1)).astype(np.int32)
    amask = np.where(rng.rand(B, T, P, 4) < 0.3, 1e32, 0).astype(np.float32)
    np.put_along_axis(amask, action, 0, axis=-1)
    return {
        'observation': rng.rand(B, T, P, 17, 7, 11).astype(np.float32),
        'selected_prob': rng.uniform(0.1, 1.0, (B, T, P, 1)).astype(np.float32),
        'value': rng.uniform(-1, 1, (B, T, P, 1)).astype(np.float32),
        'action': action,
        'outcome': np.sign(rng.randn(B, 1, P, 1)).astype(np.float32),
        'reward': (0.1 * rng.randn(B, T, P, 1)).astype(np.float32),
        'return': rng.uniform(-1, 1, (B, T, P, 1)).astype(np.float32),
        'episode_mask': emask,
        'turn_mask': turn,
        'observation_mask': turn.copy(),
        'action_mask': amask,
        'progress': np.linspace(0, 1, T, dtype=np.float32)[None, :, None]
        .repeat(B, 0),
    }


def setup(policy_target, value_target, turn_based, seed=0):
    """(jax module, jax params, port net, batch, jax cfg, port cfg)."""
    rng = np.random.RandomState(seed)
    if turn_based:
        batch = turn_based_batch(B, T, rng)
    else:
        batch = _synthetic_batch(B, T, 1, (17, 7, 11), 4, rng)
    jm = jax_build('GeeseNet', filters=FILTERS, layers=LAYERS,
                   torus_impl='pallas')
    params = jm.init(jax.random.PRNGKey(seed),
                     batch['observation'][:, 0, 0], None)
    params = jax.tree_util.tree_map(np.asarray, params)
    net = GeeseNet(filters=FILTERS, layers=LAYERS, torus_impl='pallas')
    net.load_state_dict(params_from_flax(params))
    kw = dict(turn_based_training=turn_based, observation=not turn_based,
              policy_target=policy_target, value_target=value_target,
              gamma=0.99)
    return jm, params, net, batch, JaxLossConfig(**kw), losses.LossConfig(**kw)


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


CASES = [('TD', 'TD', False), ('UPGO', 'VTRACE', False), ('MC', 'MC', False),
         ('TD', 'TD', True), ('UPGO', 'VTRACE', True)]


@pytest.mark.parametrize('pt,vt,turn_based', CASES)
def test_compute_loss_terms_and_grads_match_jax(pt, vt, turn_based):
    jm, params, net, batch, jcfg, cfg = setup(pt, vt, turn_based)

    def jloss(p):
        return jax_compute_loss(jm.apply, p, None, batch, jcfg)
    (_, jaux), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)

    live = {k: v.detach().requires_grad_(True)
            for k, v in net.named_parameters()}

    def apply_fn(p, obs, hidden):
        return torch.func.functional_call(net, p, (obs, hidden))
    total, aux = losses.compute_loss(apply_fn, live, None,
                                     torch_batch(batch), cfg)
    grads = dict(zip(live, torch.autograd.grad(total, list(live.values()))))

    assert set(aux['losses']) == set(jaux['losses']) == {'p', 'v', 'ent',
                                                         'total'}
    for k, v in aux['losses'].items():
        np.testing.assert_allclose(v.item(), float(jaux['losses'][k]),
                                   err_msg=k, **LOSS_TOL)
    assert aux['data_count'].item() == float(jaux['data_count'])
    assert set(aux['diag']) == set(jaux['diag'])
    for k, v in aux['diag'].items():
        np.testing.assert_allclose(v.item(), float(jaux['diag'][k]),
                                   err_msg=k, **LOSS_TOL)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    for k, g in grads.items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, err_msg=k, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_OF_MAX * np.abs(w).max())


def test_forward_prediction_masks_and_turn_gather():
    """A stub net with known outputs: the policy is masked by turn and
    legal actions, every other output by observation_mask."""
    rng = np.random.RandomState(3)
    batch = torch_batch(turn_based_batch(2, 3, rng))

    def stub(params, obs, hidden):
        s = obs.reshape(obs.shape[0], -1).sum(-1, keepdim=True)
        return {'policy': s.repeat(1, 4), 'value': torch.tanh(s)}
    out = losses.forward_prediction(stub, None, None, batch,
                                    losses.LossConfig())
    s = batch['observation'].reshape(2, 3, 2, -1).sum(-1, keepdim=True)
    torch.testing.assert_close(
        out['policy'], s * batch['turn_mask'] - batch['action_mask'])
    torch.testing.assert_close(
        out['value'], torch.tanh(s) * batch['observation_mask'])


def test_entropy_of_masked_logits_is_finite():
    logits = torch.tensor([[0.3, -1e32, 1.2, -1e32]])
    ent = losses._entropy(logits)
    p = torch.softmax(torch.tensor([0.3, 1.2]), 0)
    torch.testing.assert_close(ent, -(p * p.log()).sum()[None])


def test_huber_matches_optax():
    import optax
    rng = np.random.RandomState(4)
    pred, target = rng.randn(2, 50).astype(np.float32) * 2
    want = np.asarray(optax.huber_loss(pred, target, delta=1.0))
    got = losses.optax_huber(torch.from_numpy(pred), torch.from_numpy(target))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_deferred_paths_raise():
    """The IMPACT target network, the last path this test found deferred
    (a NotImplementedError), now runs: a target equal to the params at
    clip 1.0 gives the no-target loss terms (rtol 1e-6: the target's
    no-grad forward is the same numbers through the trunk's serving
    operator) with the three target diagnostics, and a target_clip
    without target params is no target, as in the JAX ``use_target``."""
    _, _, net, batch, _, cfg = setup('TD', 'TD', False)
    tb = torch_batch(batch)

    def apply_fn(p, obs, hidden):
        return torch.func.functional_call(net, p, (obs, hidden))
    params = dict(net.named_parameters())
    _, base = losses.compute_loss(apply_fn, params, None, tb, cfg)
    _, aux = losses.compute_loss(apply_fn, params, None, tb,
                                 cfg._replace(target_clip=1.0),
                                 target_params={k: v.detach().clone()
                                                for k, v in params.items()})
    for k, v in base['losses'].items():
        np.testing.assert_allclose(aux['losses'][k].item(), v.item(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert {'target_clip', 'target_ratio_sum', 'target_gap_sum'} <= set(
        aux['diag'])
    _, none = losses.compute_loss(apply_fn, params, None, tb,
                                  cfg._replace(target_clip=2.0),
                                  target_params=None)
    assert set(none['diag']) == set(base['diag'])
