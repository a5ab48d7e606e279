"""The compute dtype bfloat16 on the port's nets against the JAX package's
nets built with ``dtype=jnp.bfloat16`` (flax's module dtype: the convs and
dense layers take bf16 inputs and kernels, the norms keep fp32
statistics and return bf16, the params stay fp32): TicTacToe's
SimpleConv2dModel, ConnectFourNet, GeisterNet (every norm and policy
head), GeeseNet on 'pad', 'halo' and 'pallas' (the JAX package's kernel
trunk in interpret mode, the port's through its plain bf16 version) and
GeeseNetLSTM, with params carried from perturbed flax inits and the same
numpy inputs.

Tolerance: every output is bf16 in both packages, and compared in bf16
units. bf16 keeps 8 significant bits (eps 2^-8), so one rounding of a
value v is within 2^-9 |v|. The two frameworks sum the convs' products in
other orders (XLA's convs and dots against PyTorch's), so a value near a
rounding boundary of bf16 rounds the other way, one ulp apart, and that
difference runs on through the next layers and the norms. The outputs
are held to ``BF16_TOL`` = 2^-5 (8 bf16 ulps of a value of magnitude 1)
times max(1, |reference|), elementwise; the bulk agrees far closer, which
the mean error bound (2^-6, a few ulps; Geister's value head after four
ConvLSTM steps was seen at 2^-7.8) checks. The recurrent nets carry their
state in bf16 for three plies, and the state is held to the same bound.
'layer' is held to four times both bounds: flax's LayerNorm normalises
each cell over its channels alone, two in Geister's scalar heads, whose
variance can be near eps, so a flipped rounding of its input is
amplified (the fp32 test of the same net allows it ten times the others'
bound; 1.1 times BF16_TOL seen here).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.models.connect_four import ConnectFourNet as JaxC4
from handyrl_tpu.models.geese import GeeseNet as JaxGeese
from handyrl_tpu.models.geese import GeeseNetLSTM as JaxLSTM
from handyrl_tpu.models.geister import GeisterNet as JaxGeister
from handyrl_tpu.models.tictactoe import SimpleConv2dModel as JaxTTT
from handyrl_tpu_torch.model import ModelWrapper
from handyrl_tpu_torch.models import blocks
from handyrl_tpu_torch.models import geese as tgeese
from handyrl_tpu_torch.models import geister as tgeister
from handyrl_tpu_torch.models import tictactoe as tttt
from handyrl_tpu_torch.models.connect_four import ConnectFourNet

BF16_TOL = 2.0 ** -5
MEAN_TOL = 2.0 ** -6


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


def _perturbed(tree, rng, bf16_leaves=()):
    """A flax tree moved off its init (so no norm is the identity); the
    leaves under a module named in ``bf16_leaves`` are rounded to bf16 (the
    JAX module makes those params in its dtype)."""
    def go(t, path):
        if isinstance(t, dict):
            return {k: go(v, path + (k,)) for k, v in t.items()}
        a = np.asarray(t) + 0.1 * rng.randn(*np.shape(t)).astype(np.float32)
        if any(p.startswith(b) for p in path for b in bf16_leaves):
            a = np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
        return a.astype(np.float32)
    return go(tree, ())


def _jax_bf16_params(tree):
    """The params a JAX learner's bf16 module holds: fp32, but a
    BatchStatsNorm's scale and bias in bf16 (its params take the module's
    dtype)."""
    def go(t, path):
        if isinstance(t, dict):
            return {k: go(v, path + (k,)) for k, v in t.items()}
        if any(p.startswith('BatchStatsNorm') for p in path):
            return jnp.asarray(t, jnp.bfloat16)
        return t
    return go(tree, ())


def _assert_bf16_close(got, ref, what, scale=1.0):
    assert got.dtype == torch.bfloat16, (what, got.dtype)
    assert str(ref.dtype) == 'bfloat16', (what, ref.dtype)
    g = got.detach().float().numpy()
    r = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert g.shape == r.shape, (what, g.shape, r.shape)
    err = np.abs(g - r)
    bound = scale * BF16_TOL * np.maximum(1.0, np.abs(r))
    assert (err <= bound).all(), (what, float(err.max()),
                                  float((err / bound).max()))
    assert float(err.mean()) <= MEAN_TOL * max(1.0, float(np.abs(r).mean())), (
        what, float(err.mean()))


def _state_close(got, ref, what, scale=1.0):
    flat_g = [t for part in got for t in (part if isinstance(part, list)
                                          else [part])]
    flat_r = [t for part in ref for t in (part if isinstance(part, list)
                                          else [part])]
    assert len(flat_g) == len(flat_r)
    for i, (g, r) in enumerate(zip(flat_g, flat_r)):
        _assert_bf16_close(g, r, '%s state %d' % (what, i), scale)


@pytest.mark.timeout(120)
@pytest.mark.parametrize('kind', ['tictactoe', 'connectx'])
def test_conv_nets_in_bf16(kind):
    rng = np.random.RandomState(0)
    jcls, tcls, shape = ((JaxTTT, tttt.SimpleConv2dModel, (3, 3, 3))
                         if kind == 'tictactoe'
                         else (JaxC4, ConnectFourNet, (3, 6, 7)))
    obs = (rng.rand(16, *shape) < 0.3).astype(np.float32)
    variables = jcls().init(jax.random.PRNGKey(0), obs[:1])
    params = {'params': _perturbed(variables['params'], rng)}
    net = tcls()
    net.load_state_dict(tttt.params_from_flax(params))
    blocks.set_compute_dtype(net, torch.bfloat16)
    ref = jcls(dtype=jnp.bfloat16).apply(params, obs)
    with torch.no_grad():
        out = net(torch.from_numpy(obs))
    for k in ('policy', 'value'):
        _assert_bf16_close(out[k], ref[k], '%s %s' % (kind, k))
    # the params stay fp32; float32 (and '') is the params' own dtype
    assert all(p.dtype == torch.float32 for p in net.parameters())
    blocks.set_compute_dtype(net, 'float32')
    with torch.no_grad():
        assert net(torch.from_numpy(obs))['policy'].dtype == torch.float32


def _geister_obs(rng, n):
    board = (rng.rand(n, 7, 6, 6) < 0.3).astype(np.float32)
    scalar = (rng.rand(n, 18) < 0.5).astype(np.float32)
    return {'board': board, 'scalar': scalar}


@pytest.mark.timeout(240)
@pytest.mark.parametrize('norm_kind,policy_head,train', [
    ('group', 'dense', False), ('group', 'spatial', False),
    ('batch', 'spatial', False), ('batch', 'dense', True),
    ('batchstats', 'dense', False), ('layer', 'spatial', False)])
def test_geister_net_in_bf16(norm_kind, policy_head, train):
    rng = np.random.RandomState(1)
    scale = 4.0 if norm_kind == 'layer' else 1.0
    cfg = dict(filters=16, drc_layers=2, drc_repeats=2, norm_kind=norm_kind,
               policy_head=policy_head)
    jm = JaxGeister(**cfg)
    obs = _geister_obs(rng, 6)
    v = jm.init(jax.random.PRNGKey(0), {k: a[:1] for k, a in obs.items()},
                None)
    variables = {'params': _perturbed(v['params'], rng, ('BatchStatsNorm',))}
    if 'batch_stats' in v:
        stats = _perturbed(v['batch_stats'], rng)
        variables['batch_stats'] = jax.tree_util.tree_map(
            lambda a: a, {m: {n: {'mean': s['mean'],
                                  'var': np.abs(s['var']) + 0.5}
                              for n, s in mod.items()}
                          for m, mod in stats.items()})
    net = tgeister.GeisterNet(**cfg)
    net.load_state_dict(tgeister.params_from_flax(variables))
    blocks.set_compute_dtype(net, torch.bfloat16)
    jb = JaxGeister(dtype=jnp.bfloat16, **cfg)
    jvars = dict(variables, params=_jax_bf16_params(variables['params']))
    jh, th = jb.init_hidden((6,)), net.init_hidden((6,))
    assert all(t.dtype == torch.bfloat16 for part in th for t in part)
    for ply in range(3):
        obs = _geister_obs(rng, 6)
        if train:
            ref, _ = jb.apply(jvars, obs, jh, train=True,
                              mutable=['batch_stats'])
        else:
            ref = jb.apply(jvars, obs, jh)
        with torch.no_grad():
            out = net({k: torch.from_numpy(a) for k, a in obs.items()}, th,
                      train=train)
        for k in ('policy', 'value', 'return'):
            _assert_bf16_close(out[k], ref[k], '%s ply %d' % (k, ply),
                               scale)
        _state_close(out['hidden'], ref['hidden'], 'ply %d' % ply, scale)
        jh, th = ref['hidden'], out['hidden']
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert all(b.dtype == torch.float32 for b in net.buffers())


def _geese_obs(rng, n):
    return (rng.rand(n, 17, 7, 11) < 0.15).astype(np.float32)


@pytest.mark.timeout(240)
@pytest.mark.parametrize('impl,norm_kind,filters,layers', [
    ('pad', 'group', 16, 2), ('halo', 'group', 16, 2),
    ('pad', 'batchstats', 16, 2), ('halo', 'layer', 16, 2),
    ('pallas', 'group', 16, 2), ('pallas', 'group', 32, 12)])
def test_geesenet_in_bf16(impl, norm_kind, filters, layers):
    rng = np.random.RandomState(2)
    cfg = dict(filters=filters, layers=layers, norm_kind=norm_kind)
    obs = _geese_obs(rng, 8)
    v = JaxGeese(**cfg).init(jax.random.PRNGKey(0), obs[:1])
    variables = {'params': _perturbed(v['params'], rng, ('BatchStatsNorm',))}
    jcfg = dict(cfg, torus_impl=impl)
    if impl == 'pallas':
        jcfg['pallas_tile'] = 8
    ref = JaxGeese(dtype=jnp.bfloat16, **jcfg).apply(
        dict(variables, params=_jax_bf16_params(variables['params'])), obs)
    net = tgeese.GeeseNet(torus_impl=impl, **cfg)
    net.load_state_dict(tgeese.params_from_flax(variables))
    blocks.set_compute_dtype(net, torch.bfloat16)
    with torch.no_grad():
        out = net(torch.from_numpy(obs))
    for k in ('policy', 'value'):
        _assert_bf16_close(out[k], ref[k], '%s %s' % (impl, k))
    # under autograd (K1's training form and K2 on the card; the plain
    # versions here) the forward is the same
    out_g = net(torch.from_numpy(obs))
    torch.testing.assert_close(out_g['policy'], out['policy'], rtol=0,
                               atol=0)


@pytest.mark.timeout(240)
@pytest.mark.parametrize('impl', ['pad', 'halo'])
def test_geesenet_lstm_in_bf16(impl):
    rng = np.random.RandomState(3)
    cfg = dict(filters=16, stem_layers=2)
    obs = _geese_obs(rng, 6)
    v = JaxLSTM(**cfg).init(jax.random.PRNGKey(0), obs, None)
    variables = {'params': _perturbed(v['params'], rng)}
    jm = JaxLSTM(dtype=jnp.bfloat16, torus_impl=impl, **cfg)
    net = tgeese.GeeseNetLSTM(torus_impl=impl, **cfg)
    net.load_state_dict(tgeese.params_from_flax(variables))
    blocks.set_compute_dtype(net, torch.bfloat16)
    jh = jm.init_hidden((6,))
    th = net.init_hidden((6,))
    assert all(t.dtype == torch.bfloat16 for t in th)
    for ply in range(3):
        obs = _geese_obs(rng, 6)
        ref = jm.apply(variables, obs, jh)
        with torch.no_grad():
            out = net(torch.from_numpy(obs), th)
        for k in ('policy', 'value'):
            _assert_bf16_close(out[k], ref[k], '%s ply %d' % (k, ply))
        _state_close(out['hidden'], ref['hidden'], 'ply %d' % ply)
        jh, th = ref['hidden'], out['hidden']
    # a host actor's state crosses the numpy edge as fp32 (numpy has no
    # bf16) and ModelWrapper takes it back in the compute dtype, so the
    # actor's recurrence is the JAX actor's bf16 one
    wrapper = ModelWrapper(net, 'cpu')
    host = wrapper.init_hidden()
    assert all(a.dtype == np.float32 for a in host)
    obs = _geese_obs(rng, 1)
    first = wrapper.inference(obs[0], host)
    again = wrapper.inference(obs[0], first['hidden'])
    with torch.no_grad():
        out = net(torch.from_numpy(obs), net.init_hidden((1,)))
        out = net(torch.from_numpy(obs), out['hidden'])
    for k in ('policy', 'value'):
        np.testing.assert_array_equal(again[k], out[k][0].float().numpy())
