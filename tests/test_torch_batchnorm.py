"""The port's norms (handyrl_tpu_torch/models/blocks.py: 'batch',
'batchstats', 'layer') and a 'batch' net's running averages through the
update step (ops/losses.py, ops/train_step.py) and the snapshots
(model.py), against the JAX package's (handyrl_tpu/models/blocks.py,
ops/losses.py, ops/train_step.py; flax's nn.BatchNorm and nn.LayerNorm).

Tolerances:
- a norm layer's output and flax BatchNorm's running averages after 3
  training forwards: 1e-5 absolute (fp32 statistics over 8 x 36 rows
  summed in other orders; torch's own BatchNorm2d would be 0.35% off, its
  unbiased running variance);
- the GeeseNet ('batch', 'pad') VTRACE update step against the JAX step,
  3 steps: each loss term within 1e-5 relative (atol 1e-4), params within
  1e-5 absolute, the running averages within 1e-5 (they are EMAs of batch
  moments the two packages sum in other orders);
- the EMA identity and the guard: 1e-6 (the same arithmetic on the same
  tensors); a B=1 row against its batched row: 1e-5 (the convs of one
  row and of six sum in other orders; up to 3e-6 seen on logits of 8);
- the snapshot bytes and the trees exact."""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
from handyrl_tpu.models.geese import GeeseNet as JaxGeeseNet
from handyrl_tpu.ops.losses import LossConfig as JaxLossConfig
from handyrl_tpu.ops.train_step import build_update_step as jax_step
from handyrl_tpu.ops.train_step import init_train_state as jax_init_state
from handyrl_tpu_torch.model import ModelWrapper, params_bytes
from handyrl_tpu_torch.models import blocks
from handyrl_tpu_torch.models.geese import (GeeseNet, params_from_flax,
                                            params_to_flax)
from handyrl_tpu_torch.ops import losses
from handyrl_tpu_torch.ops.train_step import (StaticUpdateStep,
                                              build_update_step,
                                              init_train_state)


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
LOSS_TOL = dict(rtol=1e-5, atol=1e-4)
EXACT = 1e-6


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


# -- the norm layers ---------------------------------------------------------

def test_batch_norm_matches_flax_over_three_training_forwards():
    """8 boards of 6 x 6 x 5 channels: flax's BatchNorm(momentum 0.9, eps
    1e-5) in training mode three times, then in inference mode; the port's
    'batch' norm on the same inputs, its running averages the sink's."""
    rng = np.random.RandomState(0)
    fl = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    x0 = rng.randn(8, 6, 6, 5).astype(np.float32)
    v = fl.init(jax.random.PRNGKey(0), x0)
    scale = 1 + 0.1 * rng.randn(5).astype(np.float32)
    bias = 0.1 * rng.randn(5).astype(np.float32)
    v = {'params': {'scale': scale, 'bias': bias},
         'batch_stats': v['batch_stats']}
    norm = blocks.make_norm('batch', 5)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
    for step in range(3):
        x = (2 * rng.randn(8, 6, 6, 5) + step).astype(np.float32)
        want, mut = fl.apply(v, x, mutable=['batch_stats'])
        before = norm.mean.clone(), norm.var.clone()
        with blocks.batch_stats_sink() as sink:
            got = norm(_nchw(x), train=True)
        # the buffers never change in a forward: the step writes them
        assert torch.equal(norm.mean, before[0])
        assert torch.equal(norm.var, before[1])
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0,
                                   atol=TOL)
        new = blocks.collect_batch_stats(norm, sink)
        assert set(new) == {'mean', 'var'}
        for k in ('mean', 'var'):
            np.testing.assert_allclose(new[k].numpy(),
                                       np.asarray(mut['batch_stats'][k]),
                                       rtol=0, atol=TOL, err_msg=k)
        norm.load_state_dict({'weight': norm.weight, 'bias': norm.bias,
                              **new})
        v = {'params': v['params'], 'batch_stats': mut['batch_stats']}
    x = rng.randn(3, 6, 6, 5).astype(np.float32)
    want = fnn.BatchNorm(use_running_average=True, momentum=0.9,
                         epsilon=1e-5).apply(v, x)
    with blocks.batch_stats_sink() as sink:
        got = norm(_nchw(x))
    assert not sink     # inference mode reports nothing
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0,
                               atol=TOL)
    # not torch's BatchNorm2d: its running variance is the unbiased one
    torch_bn = torch.nn.BatchNorm2d(5, momentum=0.1)
    torch_bn(_nchw(x0))
    assert not np.allclose(torch_bn.running_var.numpy(), np.asarray(
        fl.apply(fl.init(jax.random.PRNGKey(0), x0), x0,
                 mutable=['batch_stats'])[1]['batch_stats']['var']),
        rtol=0, atol=TOL)


@pytest.mark.parametrize('kind', ['batchstats', 'layer', 'group', 'group1'])
def test_stateless_norms_match_flax(kind):
    """'batchstats' (the JAX package's ``BatchStatsNorm``, the batch's
    statistics in every forward), 'layer' (flax's LayerNorm over each
    cell's channels, eps 1e-6) and the GroupNorms, in both modes."""
    from handyrl_tpu.models import blocks as jblocks
    rng = np.random.RandomState(1)
    x = (3 * rng.randn(4, 6, 6, 8) + 1).astype(np.float32)
    fl = jblocks.make_norm(kind, 8, jnp.float32)
    v = fl.init(jax.random.PRNGKey(0), x)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*a.shape).astype(
            np.float32), v)
    want = fl.apply(v, x)
    norm = blocks.make_norm(kind, 8)
    leaf = v['params']
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(np.asarray(leaf['scale'])))
        norm.bias.copy_(torch.from_numpy(np.asarray(leaf['bias'])))
    for train in (False, True):
        with blocks.batch_stats_sink() as sink:
            got = norm(_nchw(x), train=train)
        assert not sink
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0,
                                   atol=TOL)
    with pytest.raises(ValueError, match='norm kind'):
        blocks.make_norm('instance', 8)


# -- GeeseNet('batch') through the update step -------------------------------

F, L = 8, 2
B, T, P = 2, 3, 4


def _geese_pair(seed=0):
    jm = JaxGeeseNet(filters=F, layers=L, norm_kind='batch')
    rng = np.random.RandomState(seed)
    v = jm.init(jax.random.PRNGKey(seed), np.zeros((1, 17, 7, 11),
                                                    np.float32))
    v = {'params': jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*a.shape).astype(
            np.float32), v['params']),
        'batch_stats': jax.tree_util.tree_map(
            lambda a: np.asarray(a) + 0.2 * np.abs(rng.randn(*a.shape))
            .astype(np.float32), v['batch_stats'])}
    net = GeeseNet(filters=F, layers=L, norm_kind='batch')
    net.load_state_dict(params_from_flax(v))
    return jm, v, net


def _batch(rng):
    ones = np.ones((B, T, P, 1), np.float32)
    return {
        'observation': (rng.rand(B, T, P, 17, 7, 11) < 0.2).astype(
            np.float32),
        'selected_prob': rng.uniform(0.1, 1, (B, T, P, 1)).astype(
            np.float32),
        'value': rng.uniform(-1, 1, (B, T, P, 1)).astype(np.float32),
        'action': rng.randint(0, 4, (B, T, P, 1)).astype(np.int32),
        'outcome': np.sign(rng.randn(B, 1, P, 1)).astype(np.float32),
        'reward': np.zeros((B, T, P, 1), np.float32),
        'return': np.zeros((B, T, P, 1), np.float32),
        'episode_mask': ones, 'turn_mask': ones.copy(),
        'observation_mask': ones.copy(),
        'action_mask': np.zeros((B, T, P, 4), np.float32),
        'progress': np.linspace(0, 1, T, dtype=np.float32)[None, :, None]
        .repeat(B, 0)}


CFG = dict(turn_based_training=False, observation=True,
           policy_target='VTRACE', value_target='VTRACE', gamma=0.99)


def _tree_close(port_tree, jax_tree, atol, what):
    for (path, a), b in zip(
            jax.tree_util.tree_flatten_with_path(jax_tree)[0],
            jax.tree_util.tree_leaves(port_tree)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=atol,
                                   err_msg='%s %s' % (what, path))


@pytest.mark.timeout(240)
def test_geesenet_batch_steps_match_the_jax_steps():
    """Three VTRACE steps of GeeseNet('batch', 'pad') on three batches:
    the loss terms, the params and the running averages after each step
    equal the JAX step's (its ``batch_stats`` advanced by the training
    forward, never by Adam)."""
    jm, v, net = _geese_pair()
    rng = np.random.RandomState(2)
    jstate = jax_init_state(v)
    jupdate = jax_step(jm, JaxLossConfig(**CFG), donate=False)
    state = init_train_state(net)
    assert set(state.opt_state.mu) == {k for k, _ in net.named_parameters()}
    assert {'stem_mean', 'block_var'} <= set(state.params)
    update = build_update_step(net, losses.LossConfig(**CFG))
    lr = 1e-3
    for step in range(3):
        batch = _batch(rng)
        jstate, jm_ = jupdate(jstate, batch, jnp.float32(lr))
        state, metrics = update(state, {k: torch.from_numpy(a)
                                        for k, a in batch.items()},
                                torch.tensor(lr))
        for k in ('p', 'v', 'ent', 'total'):
            np.testing.assert_allclose(metrics[k].item(), float(jm_[k]),
                                       err_msg='%s step %d' % (k, step),
                                       **LOSS_TOL)
        flax_now = params_to_flax(state.params, norm_kind='batch')
        jv = jax.tree_util.tree_map(np.asarray, jstate.params)
        _tree_close(flax_now['batch_stats'], jv['batch_stats'], TOL,
                    'batch_stats step %d' % step)
        _tree_close(flax_now['params'], jv['params'], TOL,
                    'params step %d' % step)


@pytest.mark.timeout(120)
def test_the_step_advances_the_running_averages_by_their_ema_alone():
    """The new running averages are 0.9 old + 0.1 the batch's moments of
    the training forward (feed-forward: once a window), whatever the lr:
    no gradient, no weight decay, no Adam; a NaN lr keeps them, as it
    keeps params and moments (the static step too)."""
    _, _, net = _geese_pair(seed=3)
    rng = np.random.RandomState(4)
    batch = {k: torch.from_numpy(a) for k, a in _batch(rng).items()}
    state = init_train_state(net)
    stats = {k: state.params[k] for k in ('stem_mean', 'stem_var',
                                          'block_mean', 'block_var')}
    # the batch moments: one training forward on the folded window
    obs = batch['observation'].reshape((-1, 17, 7, 11))
    with blocks.batch_stats_sink() as sink:
        torch.func.functional_call(net, state.params, (obs, None),
                                   {'train': True})
    want = blocks.collect_batch_stats(net, sink)
    update = build_update_step(net, losses.LossConfig(**CFG))
    for lr in (0.0, 1e-2):
        new, metrics = update(state, batch, torch.tensor(lr))
        assert metrics['nonfinite'].item() == 0
        for k, old in stats.items():
            torch.testing.assert_close(new.params[k], want[k], rtol=0,
                                       atol=EXACT)
            assert not torch.equal(new.params[k], old), k
            assert k not in new.opt_state.mu
    bad, metrics = update(state, batch, torch.tensor(float('nan')))
    assert metrics['nonfinite'].item() == 1
    for k, v in state.params.items():
        assert torch.equal(bad.params[k], v), k
    static = StaticUpdateStep(net, losses.LossConfig(**CFG), state)
    flat = dict(batch)
    static(flat, torch.tensor(float('nan')))
    for k, v in state.params.items():
        assert torch.equal(static.state.params[k], v), k
    static(flat, torch.tensor(1e-2))
    for k in stats:
        torch.testing.assert_close(static.state.params[k], want[k], rtol=0,
                                   atol=EXACT)


def test_inference_reads_the_running_averages_row_by_row():
    """Out of training every forward normalises by the running averages:
    a B=1 forward equals its row of a batched one, on the module (eval
    or not) and through the wrapper; the batch's statistics would not."""
    _, _, net = _geese_pair(seed=5)
    rng = np.random.RandomState(6)
    obs = torch.from_numpy((rng.rand(6, 17, 7, 11) < 0.2).astype(
        np.float32))
    net.train()       # the flag decides nothing: ``train`` does
    full = net(obs)['policy']
    for i in range(6):
        torch.testing.assert_close(net(obs[i:i + 1])['policy'],
                                   full[i:i + 1], rtol=0, atol=TOL)
    wrapper = ModelWrapper(net, device='cpu')
    for i in (0, 5):
        np.testing.assert_allclose(
            wrapper.inference(obs[i].numpy())['policy'],
            full[i].detach().numpy(), rtol=0, atol=TOL)
    trained = net(obs, train=True)['policy']
    assert not torch.allclose(trained, full, atol=1e-3)


@pytest.mark.timeout(120)
def test_running_averages_cross_both_packages_in_snapshots():
    """After a port step the running averages ride the snapshot as
    ``batch_stats``: the JAX wrapper rebuilt from the port's snapshot
    holds them and answers as the port; its bytes come back into the port
    unchanged; the torus_impl 'pallas' trunk refuses 'batch'."""
    jm, _, net = _geese_pair(seed=7)
    rng = np.random.RandomState(8)
    state = init_train_state(net)
    state, _ = build_update_step(net, losses.LossConfig(**CFG))(
        state, {k: torch.from_numpy(a) for k, a in _batch(rng).items()},
        torch.tensor(1e-3))
    net.load_state_dict(state.params)
    pw = ModelWrapper(net, device='cpu')
    snap = pw.snapshot()
    assert snap['config'] == {'filters': F, 'layers': L,
                              'norm_kind': 'batch'}
    obs = (rng.rand(17, 7, 11) < 0.2).astype(np.float32)
    jw = JaxModelWrapper.from_snapshot(snap, obs)
    flax_stats = params_to_flax(net)['batch_stats']
    _tree_close(flax_stats, jax.tree_util.tree_map(
        np.asarray, jw.params['batch_stats']), 0, 'batch_stats')
    np.testing.assert_allclose(jw.inference(obs)['policy'],
                               pw.inference(obs)['policy'], rtol=0, atol=TOL)
    back = ModelWrapper.from_snapshot(jw.snapshot(), device='cpu')
    for k, t in net.state_dict().items():
        assert torch.equal(back.module.state_dict()[k], t), k
    assert params_bytes(back.module) == params_bytes(net)
    with pytest.raises(ValueError, match='GroupNorm'):
        GeeseNet(norm_kind='batch', torus_impl='pallas')


@pytest.mark.parametrize('kind', ['batchstats', 'layer'])
def test_geesenet_stateless_norms_match_flax(kind):
    jm = JaxGeeseNet(filters=F, layers=L, norm_kind=kind, torus_impl='halo')
    rng = np.random.RandomState(9)
    v = jm.init(jax.random.PRNGKey(1), np.zeros((1, 17, 7, 11), np.float32))
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*a.shape).astype(
            np.float32), v)
    net = GeeseNet(filters=F, layers=L, norm_kind=kind, torus_impl='halo')
    net.load_state_dict(params_from_flax(v))
    obs = (rng.rand(5, 17, 7, 11) < 0.2).astype(np.float32)
    want = jm.apply(v, obs)
    got = net(torch.from_numpy(obs))
    for k in ('policy', 'value'):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=1e-5, atol=TOL,
                                   err_msg=k)
    assert list(params_to_flax(net)) == ['params']
