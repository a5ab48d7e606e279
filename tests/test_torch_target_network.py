"""The IMPACT clipped target network of the port (handyrl_tpu_torch/ops/
losses.py ``compute_loss(target_params=)``, ops/train_step.py's target
buffers, train.py's Trainer lifecycle) against the JAX package's
(handyrl_tpu/ops/losses.py:229-352, ops/train_step.py, train.py).

Each net gets a target that is its parameters perturbed by seeded noise
(a lagged target), carried across with ``params_from_flax``: a narrow
GeeseNet with the Pallas trunk (its JAX side in interpret mode, as the JAX
tests run it on the CPU; the port's plain trunk, the no-grad target
forward through the serving operator), TicTacToe's SimpleConv2dModel on a
turn-based compact batch (two players, TD targets, K3 at P=2), a
GeeseNetLSTM with 2 burn-in steps, and GeeseNet('batch'), whose target
normalizes by the batch's statistics and whose running averages must not
move. Tolerances: loss terms and diagnostics rtol 1e-5 / atol 1e-4 (fp32
sums of order-1 terms over B*T*P, as tests/test_torch_losses.py); grads
atol 1e-4 of each tensor's largest element. A fresh target (the params
themselves) at clip 1.0 gives the no-target loss terms within 1e-6
relative: the same numbers through a second forward, which on the CPU may
sum in another order only in the trunk's no-grad operator.
"""

import logging
import os
import queue

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_batch
from handyrl_tpu.config import apply_defaults as jax_apply_defaults
from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
from handyrl_tpu.models import build as jax_build
from handyrl_tpu.models.geese import GeeseNet as JaxGeeseNet
from handyrl_tpu.models.geese import GeeseNetLSTM as JaxLSTM
from handyrl_tpu.models.tictactoe import SimpleConv2dModel as JaxTTT
from handyrl_tpu.ops.losses import LossConfig as JaxLossConfig
from handyrl_tpu.ops.losses import compute_loss as jax_compute_loss
from handyrl_tpu.train import Trainer as JaxTrainer
from handyrl_tpu_torch.bench import synthetic_batch
from handyrl_tpu_torch.config import apply_defaults
from handyrl_tpu_torch.models import geese, tictactoe
from handyrl_tpu_torch.ops import losses
from handyrl_tpu_torch.ops.train_step import (StaticUpdateStep, _apply_fn,
                                              build_update_step,
                                              init_hidden_for,
                                              init_train_state,
                                              split_batch_stats)
from handyrl_tpu_torch.train import Trainer


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread a process (and OMP_NUM_THREADS=1 in the
    processes a test starts): the workers of a parallel run share the
    cores."""
    before, omp = torch.get_num_threads(), os.environ.get('OMP_NUM_THREADS')
    torch.set_num_threads(1)
    os.environ['OMP_NUM_THREADS'] = '1'
    yield
    torch.set_num_threads(before)
    if omp is None:
        os.environ.pop('OMP_NUM_THREADS', None)
    else:
        os.environ['OMP_NUM_THREADS'] = omp


LOSS_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_ATOL_OF_MAX = 1e-4
FRESH_RTOL = 1e-6
TARGET_DIAGS = ('target_clip', 'target_ratio_sum', 'target_gap_sum')


def _perturb(tree, seed, scale=0.05):
    rng = np.random.RandomState(seed)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        a = np.asarray(t)
        return a + scale * rng.randn(*a.shape).astype(np.float32)
    return go(tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ttt_turn_batch(B, T, rng):
    """TicTacToe's compact turn-based window: the acting player's row
    alone in observation, action, probs and masks (P=1), both players in
    value, outcome, reward, return and the turn/observation masks."""
    turn = np.zeros((B, T, 2, 1), np.float32)
    first = rng.randint(0, 2, B)
    for b in range(B):
        for t in range(T):
            turn[b, t, (first[b] + t) % 2] = 1
    emask = np.ones((B, T, 1, 1), np.float32)
    for b in range(0, B, 2):
        emask[b, T - 1 - b % T:] = 0
    action = rng.randint(0, 9, (B, T, 1, 1)).astype(np.int32)
    amask = np.where(rng.rand(B, T, 1, 9) < 0.4, 1e32, 0).astype(np.float32)
    np.put_along_axis(amask, action, 0, axis=-1)
    return {
        'observation': (rng.rand(B, T, 1, 3, 3, 3) < 0.3).astype(np.float32),
        'selected_prob': rng.uniform(0.1, 1.0, (B, T, 1, 1)).astype(
            np.float32),
        'value': rng.uniform(-1, 1, (B, T, 2, 1)).astype(np.float32),
        'action': action,
        'outcome': np.sign(rng.randn(B, 1, 2, 1)).astype(np.float32),
        'reward': np.zeros((B, T, 2, 1), np.float32),
        'return': np.zeros((B, T, 2, 1), np.float32),
        'episode_mask': emask, 'turn_mask': turn,
        'observation_mask': turn.copy(), 'action_mask': amask,
        'progress': np.linspace(0, 1, T, dtype=np.float32)[None, :, None]
        .repeat(B, 0)}


def _lstm_batch(B, T, P, rng):
    """A solo (B, T, P) Geese window, every goose observing where a random
    mask says so."""
    mask = (rng.rand(B, T, P, 1) < 0.8).astype(np.float32)
    action = rng.randint(0, 4, (B, T, P, 1)).astype(np.int32)
    return {
        'observation': (rng.rand(B, T, P, 17, 7, 11) < 0.15).astype(
            np.float32),
        'selected_prob': rng.uniform(0.1, 1.0, (B, T, P, 1)).astype(
            np.float32),
        'value': rng.uniform(-1, 1, (B, T, P, 1)).astype(np.float32),
        'action': action,
        'outcome': np.sign(rng.randn(B, 1, P, 1)).astype(np.float32),
        'reward': (0.1 * rng.randn(B, T, P, 1)).astype(np.float32),
        'return': rng.uniform(-1, 1, (B, T, P, 1)).astype(np.float32),
        'episode_mask': np.ones((B, T, P, 1), np.float32),
        'turn_mask': mask, 'observation_mask': mask.copy(),
        'action_mask': np.zeros((B, T, P, 4), np.float32),
        'progress': np.linspace(0, 1, T, dtype=np.float32)[None, :, None]
        .repeat(B, 0)}


def _case(name):
    """(JAX module, JAX variables, JAX target variables, port net, batch,
    loss config kwargs, JAX hidden, port hidden)."""
    rng = np.random.RandomState(5)
    if name == 'geese':
        batch = _synthetic_batch(4, 4, 1, (17, 7, 11), 4, rng)
        batch['selected_prob'] = rng.uniform(0.05, 0.6, (4, 4, 1, 1)).astype(
            np.float32)
        jm = jax_build('GeeseNet', filters=16, layers=2, torus_impl='pallas')
        v = _np(jm.init(jax.random.PRNGKey(0), batch['observation'][:, 0, 0],
                        None))
        net = geese.GeeseNet(filters=16, layers=2, torus_impl='pallas')
        kw = dict(turn_based_training=False, observation=True,
                  policy_target='VTRACE', value_target='VTRACE', gamma=0.99)
        from_flax = geese.params_from_flax
    elif name == 'tictactoe':
        batch = _ttt_turn_batch(6, 5, rng)
        jm = JaxTTT()
        v = _np(jm.init(jax.random.PRNGKey(1),
                        np.zeros((1, 3, 3, 3), np.float32)))
        net = tictactoe.SimpleConv2dModel()
        kw = dict(turn_based_training=True, observation=False,
                  policy_target='TD', value_target='TD', gamma=0.8)
        from_flax = tictactoe.params_from_flax
    elif name == 'lstm':
        batch = _lstm_batch(3, 6, 4, rng)
        jm = JaxLSTM(filters=8, stem_layers=1)
        v = _perturb(_np(jm.init(jax.random.PRNGKey(2),
                                 batch['observation'][:, 0, 0], None)), 7)
        net = geese.GeeseNetLSTM(filters=8, stem_layers=1)
        kw = dict(turn_based_training=False, observation=True,
                  burn_in_steps=2, policy_target='VTRACE',
                  value_target='VTRACE', gamma=0.99)
        from_flax = geese.params_from_flax
    else:   # 'batch'
        batch = _lstm_batch(2, 3, 4, rng)
        jm = JaxGeeseNet(filters=8, layers=2, norm_kind='batch')
        v = _np(jm.init(jax.random.PRNGKey(3),
                        np.zeros((1, 17, 7, 11), np.float32)))
        v = {'params': _perturb(v['params'], 8, 0.1),
             'batch_stats': jax.tree_util.tree_map(
                 lambda a: a + 0.2, v['batch_stats'])}
        net = geese.GeeseNet(filters=8, layers=2, norm_kind='batch')
        kw = dict(turn_based_training=False, observation=True,
                  policy_target='VTRACE', value_target='VTRACE', gamma=0.99)
        from_flax = geese.params_from_flax
    target = _perturb(v, 11)
    net.load_state_dict(from_flax(v))
    tb = {k: torch.from_numpy(np.asarray(a)) for k, a in batch.items()}
    jhidden = hidden = None
    if name == 'lstm':
        jhidden = jm.init_hidden((3, 4))
        hidden = init_hidden_for(net, tb)
    return (jm, v, target, net, batch, tb, kw, jhidden, hidden,
            from_flax(target))


def _port_loss(net, tb, cfg, hidden, target=None):
    """compute_loss on the net's parameters as the update step splits
    them, with their gradients; ``target`` by the state's names."""
    state = init_train_state(net)
    live = {k: v.detach().requires_grad_(k in state.opt_state.mu)
            for k, v in state.params.items()}
    trainable, stats = split_batch_stats(live, state.opt_state)
    total, aux = losses.compute_loss(_apply_fn(net), trainable, hidden, tb,
                                     cfg, batch_stats=stats,
                                     target_params=target)
    names = list(state.opt_state.mu)
    grads = dict(zip(names, torch.autograd.grad(total,
                                                [live[k] for k in names])))
    return aux, grads


@pytest.mark.timeout(240)
@pytest.mark.parametrize('name', ['geese', 'tictactoe', 'lstm', 'batch'])
def test_impact_loss_matches_jax(name):
    """The loss terms, the data count, every diagnostic (the three
    target ones included) and the gradients equal the JAX
    ``compute_loss``'s with the same lagged target at clip 1.0."""
    (jm, v, target, net, batch, tb, kw, jhidden, hidden,
     port_target) = _case(name)
    jcfg = JaxLossConfig(target_clip=1.0, **kw)
    cfg = losses.LossConfig(target_clip=1.0, **kw)

    def jloss(p):
        return jax_compute_loss(jm.apply, p, jhidden, batch, jcfg,
                                target_params=target)
    jparams = v
    if name == 'batch':
        def jloss(p):   # noqa: F811 (the params split off the stats)
            return jax_compute_loss(jm.apply, p, jhidden, batch, jcfg,
                                    batch_stats=v['batch_stats'],
                                    target_params=target)
        jparams = {'params': v['params']}
    (_, jaux), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    aux, grads = _port_loss(net, tb, cfg, hidden, port_target)

    assert set(aux['diag']) == set(jaux['diag']) >= set(TARGET_DIAGS)
    for group in ('losses', 'diag'):
        for k, val in aux[group].items():
            np.testing.assert_allclose(val.item(), float(jaux[group][k]),
                                       err_msg='%s %s' % (group, k),
                                       **LOSS_TOL)
    assert aux['data_count'].item() == float(jaux['data_count'])
    assert abs(aux['diag']['target_gap_sum'].item()) > 1e-4  # a lag
    want = (tictactoe if name == 'tictactoe' else geese).params_from_flax(
        _np(jgrads))
    assert set(grads) <= set(want)
    for k, g in grads.items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, err_msg=k, rtol=0,
                                   atol=GRAD_ATOL_OF_MAX * np.abs(w).max())
    if name == 'batch':
        # the live forward advances the running averages as without a
        # target; the target's own statistics stay as they were
        base, _ = _port_loss(net, tb, losses.LossConfig(**kw), hidden)
        for k, t in aux['batch_stats'].items():
            torch.testing.assert_close(t, base['batch_stats'][k], rtol=0,
                                       atol=0)
        still = geese.params_from_flax(target)
        for k, t in port_target.items():
            assert torch.equal(t, still[k]), k
        jbs = geese.params_from_flax({'params': v['params'],
                                      'batch_stats': _np(
                                          jaux['batch_stats'])})
        for k, t in aux['batch_stats'].items():
            np.testing.assert_allclose(t.numpy(), jbs[k].numpy(), rtol=0,
                                       atol=1e-5, err_msg=k)


@pytest.mark.timeout(120)
@pytest.mark.parametrize('name', ['geese', 'tictactoe'])
def test_fresh_target_at_clip_one_equals_no_target(name):
    """tests/test_losses.py:211's pin on the port: the target equal to the
    params at clip 1.0 gives the no-target loss terms and grads, a zero
    log-prob gap, and a target_clip of 0 ignores the target."""
    (_, _, _, net, _, tb, kw, _, hidden, _) = _case(name)
    fresh = {k: v.detach().clone() for k, v in net.state_dict().items()}
    aux, grads = _port_loss(net, tb, losses.LossConfig(target_clip=1.0,
                                                       **kw), hidden, fresh)
    base, base_grads = _port_loss(net, tb, losses.LossConfig(**kw), hidden)
    off, _ = _port_loss(net, tb, losses.LossConfig(**kw), hidden, fresh)
    for k, v in base['losses'].items():
        np.testing.assert_allclose(aux['losses'][k].item(), v.item(),
                                   rtol=FRESH_RTOL, atol=1e-6, err_msg=k)
        assert off['losses'][k].item() == v.item()
    for k, g in grads.items():
        torch.testing.assert_close(g, base_grads[k], rtol=1e-5, atol=1e-6)
    assert abs(aux['diag']['target_gap_sum'].item()) < 1e-5
    assert set(off['diag']).isdisjoint(TARGET_DIAGS)


# ---------------------------------------------------------------------------
# the step


@pytest.mark.timeout(120)
def test_static_step_with_a_target_equals_the_eager_step():
    """Three steps of the static step (its target buffers synced once,
    after the first step) against the functional step given the same
    target: metrics and params equal (exact: the same body on the same
    tensors); a sync copies the live params into the buffers in place."""
    (_, _, _, net, _, tb, kw, _, _, _) = _case('geese')
    cfg = losses.LossConfig(target_clip=1.0, **kw)
    state = init_train_state(net)
    static = StaticUpdateStep(net, cfg, state)
    buffers = {k: t.data_ptr() for k, t in static.target.items()}
    update = build_update_step(net, cfg)
    target = {k: v.clone() for k, v in state.params.items()}
    for step in range(3):
        lr = torch.tensor(1e-3)
        state, want = update(state, tb, lr, target)
        got = static(dict(tb), lr)
        for k, v in want.items():
            assert torch.equal(got[k], v), (step, k)
        for k, v in state.params.items():
            assert torch.equal(static.state.params[k], v), (step, k)
        if step == 0:
            static.sync_target()
            target = {k: v.clone() for k, v in state.params.items()}
            for k, t in static.target.items():
                assert torch.equal(t, state.params[k])
                assert t.data_ptr() == buffers[k]
    assert static.target_syncs == 1
    assert abs(got['diag_target_gap_sum'].item()) > 0


# ---------------------------------------------------------------------------
# the trainer


class _FixedBatches:
    def __init__(self, batches):
        self._batches = list(batches)

    def batch(self, timeout=None):
        if not self._batches:
            raise queue.Empty
        return self._batches.pop(0)

    def stop(self):
        pass


RAW = {'env_args': {'env': 'HungryGeese'},
       'train_args': {'turn_based_training': False, 'observation': True,
                      'gamma': 0.99, 'forward_steps': 4, 'batch_size': 4,
                      'policy_target': 'VTRACE', 'value_target': 'VTRACE',
                      'streaming': {'target_clip': 1.0,
                                    'target_sync_epochs': 2}}}


def _trainers(raw=RAW):
    jw = JaxModelWrapper(jax_build('GeeseNet', filters=16, layers=2), seed=0)
    jw.ensure_params(np.zeros((17, 7, 11), np.float32))
    jt = JaxTrainer(jax_apply_defaults(raw)['train_args'], jw)
    net = geese.GeeseNet(filters=16, layers=2, torus_impl='pallas')
    net.load_state_dict(geese.params_from_flax(_np(jw.params)))
    return jt, Trainer(apply_defaults(raw)['train_args'], net)


def _epoch(tr, seed):
    tr.batcher = _FixedBatches([
        synthetic_batch(4, 4, 1, (17, 7, 11), 4,
                        np.random.RandomState(seed + i)) for i in range(8)])
    tr.update_flag = True
    tr.train()


@pytest.mark.timeout(240)
def test_trainer_syncs_every_target_sync_epochs_and_after_a_load():
    """``target_sync_epochs`` 2: the target is the params at the start of
    epochs 0 and 2 and again at the start of the epoch after a
    ``load_state_bytes``, in both trainers (the port's buffers equal the
    JAX trainer's target within 1e-4: 8 steps an epoch (one metrics
    drain) at the JAX trainer's lr, params within lr / 10 a step as
    tests/test_torch_trainer.py holds them); the metrics rows carry the
    three target means."""
    jt, pt = _trainers()
    assert jt._use_target and pt.use_target
    starts = []
    for epoch in range(4):
        starts.append({k: v.clone()
                       for k, v in pt.update_step.state.params.items()})
        _epoch(jt, 10 * epoch)
        _epoch(pt, 10 * epoch)
        synced = starts[epoch - epoch % 2]
        for k, t in pt.update_step.target.items():
            assert torch.equal(t, synced[k]), (epoch, k)
        want = geese.params_from_flax(_np(jt.target_params))
        for k, t in pt.update_step.target.items():
            np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=0,
                                       atol=1e-4, err_msg=k)
        assert pt.update_step.target_syncs == 1 + epoch // 2
    assert set(pt.last_dynamics) >= {'target_clip_fraction',
                                     'target_ratio_mean', 'target_gap_mean'}
    blob = pt.state_bytes()
    pt.load_state_bytes(blob)
    jt.load_state_bytes(jt.state_bytes())
    assert jt.target_params is None
    loaded = {k: v.clone() for k, v in pt.update_step.state.params.items()}
    _epoch(pt, 99)
    assert pt.update_step.target_syncs == 3
    for k, t in pt.update_step.target.items():
        assert torch.equal(t, loaded[k]), k


def test_device_replay_ignores_the_target_with_the_warning():
    """The replay trainers have no target variant: device_replay drops
    the knob with the JAX trainer's warning, and the update step carries
    no target buffers."""
    raw = {'env_args': {'env': 'TicTacToe'},
           'train_args': {'device_replay': True, 'maximum_episodes': 8,
                          'replay_windows_per_episode': 1,
                          'streaming': {'target_clip': 1.0}}}
    records = []

    class _Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())
    handler = _Keep()
    logger = logging.getLogger('handyrl_tpu_torch.train')
    logger.addHandler(handler)
    try:
        tr = Trainer(apply_defaults(raw)['train_args'],
                     tictactoe.SimpleConv2dModel())
    finally:
        logger.removeHandler(handler)
    assert not tr.use_target
    assert tr.cfg.target_clip == 0 and tr.device_cfg.target_clip == 0
    assert tr.update_step.target is None
    assert ('streaming.target_clip is ignored in device_replay mode (the '
            'fused trainer has no target variant)') in records
