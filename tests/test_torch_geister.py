"""Geister in the port: the host env (handyrl_tpu_torch/envs/geister.py),
its tensor twin (envs/torch_geister.py) and GeisterNet (models/geister.py)
with every ``norm_kind`` and ``policy_head``, against the JAX package's
(handyrl_tpu/envs/geister.py, envs/jax_geister.py, models/geister.py).

Tolerances:
- the host env and the twin are exact: the same moves give equal legal
  sets, observations (both seats' hidden views and the omniscient one),
  strings, mirror updates, outcomes, state leaves (values and dtypes) and
  resets;
- GeisterNet's forward over 3 plies of carried DRC state, params carried
  from a flax init perturbed so no norm is the identity: policy, value,
  return and the next state within 1e-5 absolute (fp32 convs and norm
  statistics summed in other orders; a few 1e-6 seen), 'layer' within
  1e-4: flax's LayerNorm normalises each cell over its channels alone,
  two channels in the scalar heads, whose variance can be near eps, so
  the rounding of its inputs is amplified (up to 2e-5 seen);
- ``init_kind='torch'``: every kernel and bias within its bound
  1/sqrt(fan_in) (+1e-5) and spread over it;
- the param round trip and the snapshot bytes are exact."""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.envs import jax_geister
from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
from handyrl_tpu.model import module_config
from handyrl_tpu.models.geister import GeisterNet as JaxNet
from handyrl_tpu_torch.config import apply_defaults
from handyrl_tpu_torch.environment import (DEVICE_ENVS, ENVS,
                                           make_device_env, make_env)
from handyrl_tpu_torch.envs import torch_geister
from handyrl_tpu_torch.model import ModelWrapper, params_bytes
from handyrl_tpu_torch.models.geister import (GeisterNet, params_from_flax,
                                              params_to_flax)


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
LAYER_TOL = 1e-4
ENV_ARGS = {'env': 'Geister'}
SMALL = dict(filters=8, drc_layers=2, drc_repeats=1)


# -- the host env -----------------------------------------------------------

def _assert_views(env, ref):
    for p in (None, 0, 1):
        a, b = env.observation(p), ref.observation(p)
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg='%s %s'
                                          % (p, k))


@pytest.mark.timeout(120)
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_env_plays_move_for_move_like_the_reference(seed):
    """Seeded random games to the end, both envs on the same moves, and a
    mirror env per seat following the delta protocol (a hidden opponent
    layout is drawn from ``random`` in both packages: the same seed, the
    same mirror)."""
    env, ref = make_env(ENV_ARGS), jax_make_env(ENV_ARGS)
    mirrors = {p: make_env(ENV_ARGS) for p in (0, 1)}
    refs = {p: jax_make_env(ENV_ARGS) for p in (0, 1)}
    rng = random.Random(seed)
    for game in range(4):
        env.reset()
        ref.reset()
        for p in (0, 1):
            mirrors[p].update(env.diff_info(p), True)
            refs[p].update(ref.diff_info(p), True)
        while not ref.terminal():
            assert env.terminal() is False
            assert env.turn() == ref.turn() and env.turns() == ref.turns()
            assert env.legal_actions() == ref.legal_actions()
            _assert_views(env, ref)
            action = rng.choice(ref.legal_actions())
            player = ref.turn()
            assert (env.action2str(action, player)
                    == ref.action2str(action, player))
            assert env.str2action(ref.action2str(action, player),
                                  player) == action
            assert env.reward() == ref.reward()
            env.play(action)
            ref.play(action)
            state = random.getstate()
            for p in (0, 1):
                assert env.diff_info(p) == ref.diff_info(p)
                random.setstate(state)
                refs[p].update(ref.diff_info(p), False)
                random.setstate(state)
                mirrors[p].update(env.diff_info(p), False)
                np.testing.assert_array_equal(mirrors[p].board,
                                              refs[p].board)
                # the mirror knows its own pieces and every square
                np.testing.assert_array_equal(mirrors[p].board >= 0,
                                              env.board >= 0)
                np.testing.assert_array_equal(
                    mirrors[p].observation(p)['board'],
                    env.observation(p)['board'])
        assert env.terminal() and env.outcome() == ref.outcome()
        assert str(env) == str(ref) and env.players() == ref.players()


def test_env_is_registered_and_builds_the_port_net():
    assert ENVS['Geister'] == 'handyrl_tpu_torch.envs.geister'
    assert DEVICE_ENVS['Geister'] == 'handyrl_tpu_torch.envs.torch_geister'
    assert make_device_env(ENV_ARGS) is torch_geister
    net = make_env(ENV_ARGS).net()
    assert isinstance(net, GeisterNet) and net.config() == {}
    knobs = {'norm_kind': 'batch', 'policy_head': 'spatial',
             'init_kind': 'torch'}
    net = make_env(dict(ENV_ARGS, **knobs)).net()
    assert net.config() == knobs == module_config(JaxNet(**knobs))
    for name in ('N_ACTIONS', 'N_MOVE', 'N_SET', 'MAX_PLIES',
                 'NUM_PLAYERS', 'RNG_COMPAT', 'SIMULTANEOUS'):
        assert getattr(torch_geister, name) == getattr(jax_geister, name)
    assert not hasattr(torch_geister, 'MAX_STEPS')   # as the JAX twin


def test_config_takes_geister_with_every_knob():
    for norm in ('group', 'batch', 'batchstats', 'layer'):
        for head in ('dense', 'spatial'):
            env_args = dict(ENV_ARGS, norm_kind=norm, policy_head=head,
                            init_kind='torch')
            args = apply_defaults({'env_args': env_args, 'train_args': {
                'device_generation': True, 'device_replay': True}})
            assert args['env_args'] == env_args
    args = apply_defaults({'env_args': dict(ENV_ARGS), 'train_args': {
        'batched_generation': False, 'generation': {'backend': 'device'}}})
    assert args['train_args']['generation']['backend'] == 'device'


# -- the tensor twin --------------------------------------------------------

def _assert_state(js, ts):
    for name, a, b in zip(ts._fields, js, ts):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)


def _assert_obs(jo, to):
    assert set(jo) == set(to) == {'scalar', 'board'}
    for k in jo:
        assert to[k].dtype == torch.float32
        np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]),
                                      err_msg=k)


@pytest.mark.timeout(180)
@pytest.mark.parametrize('seed', [0, 1])
def test_twin_matches_jax_geister_ply_by_ply(seed):
    """N=32 games under seeded legal actions, auto-reset included, until
    every lane finished a game: state, legal mask, both seats' views,
    turn, rewards, terminal and outcome equal at every ply; each finished
    lane's game replayed through the host env gives the same outcome."""
    n = 32
    rng = np.random.default_rng(seed)
    js, ts = jax_geister.init_state(n), torch_geister.init_state(n)
    _assert_state(js, ts)
    hosts = [make_env(ENV_ARGS) for _ in range(n)]
    finished = np.zeros(n, bool)
    ply = 0
    while not finished.all():
        legal = np.asarray(jax_geister.legal_mask(js))
        np.testing.assert_array_equal(torch_geister.legal_mask(ts).numpy(),
                                      legal)
        _assert_obs(jax_geister.observe(js), torch_geister.observe(ts))
        viewer = rng.integers(0, 2, n)
        _assert_obs(jax_geister.observe_as(js, jnp.asarray(viewer)),
                    torch_geister.observe_as(ts, torch.from_numpy(viewer)))
        np.testing.assert_array_equal(torch_geister.turn(ts).numpy(),
                                      np.asarray(jax_geister.turn(js)))
        for i, env in enumerate(hosts):
            assert sorted(np.flatnonzero(legal[i])) == sorted(
                env.legal_actions()), (i, ply)
            host = env.observation(env.turn())
            np.testing.assert_array_equal(
                torch_geister.observe(ts)['board'][i].numpy(), host['board'])
        actions = np.array([rng.choice(np.flatnonzero(r)) for r in legal])
        js = jax_geister.step(js, jnp.asarray(actions))
        ts = torch_geister.step(ts, torch.from_numpy(actions))
        _assert_state(js, ts)
        for i, env in enumerate(hosts):
            env.play(int(actions[i]))
        np.testing.assert_array_equal(torch_geister.rewards(ts).numpy(),
                                      np.asarray(jax_geister.rewards(js)))
        done = np.asarray(jax_geister.terminal(js))
        np.testing.assert_array_equal(torch_geister.terminal(ts).numpy(),
                                      done)
        np.testing.assert_array_equal(torch_geister.outcome(ts).numpy(),
                                      np.asarray(jax_geister.outcome(js)))
        for i in np.flatnonzero(done):
            assert hosts[i].terminal()
            oc = torch_geister.outcome(ts)[i].tolist()
            assert hosts[i].outcome() == {0: oc[0], 1: oc[1]}
            hosts[i].reset()
        finished |= done
        js = jax_geister.auto_reset(js, jnp.asarray(done))
        ts = torch_geister.auto_reset(ts, torch.from_numpy(done))
        _assert_state(js, ts)
        ply += 1
        assert ply < 2000


# -- the net ----------------------------------------------------------------

def _perturbed(tree, rng):
    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        a = np.asarray(t)
        return a + 0.1 * rng.randn(*a.shape).astype(np.float32)
    return go(tree)


def _flax_variables(jm, seed=1):
    """A flax init perturbed so no norm is the identity; running averages
    moved off their init too (variances kept positive)."""
    rng = np.random.RandomState(seed)
    obs = {'scalar': np.zeros((1, 18), np.float32),
           'board': np.zeros((1, 7, 6, 6), np.float32)}
    # the init's key order (a jax tree_map would sort the keys), so the
    # snapshot bytes compare
    v = jm.init(jax.random.PRNGKey(seed), obs, jm.init_hidden((1,)))
    out = {'params': _perturbed(v['params'], rng)}
    if 'batch_stats' in v:
        stats = _perturbed(v['batch_stats'], rng)
        out['batch_stats'] = {m: {n: {'mean': s['mean'],
                                      'var': np.abs(s['var']) + 0.5}
                                  for n, s in mod.items()}
                              for m, mod in stats.items()}
    return out


def geister_obs(n, seed):
    """Views of real positions (both seats, setup plies included)."""
    env, rng = make_env(ENV_ARGS), random.Random(seed)
    out = []
    while len(out) < n:
        if env.terminal():
            env.reset()
        out.append(env.observation(rng.choice([0, 1])))
        env.play(rng.choice(env.legal_actions()))
    return {k: np.stack([o[k] for o in out]) for k in ('scalar', 'board')}


def _hidden_torch(h):
    return tuple([torch.from_numpy(np.array(t)) for t in part] for part in h)


@pytest.mark.timeout(180)
@pytest.mark.parametrize('head', ['dense', 'spatial'])
@pytest.mark.parametrize('norm', ['group', 'batch', 'batchstats', 'layer'])
def test_forward_matches_flax_over_three_plies(norm, head):
    """Every norm and head, in inference mode (a 'batch' net reads its
    running averages), the DRC state carried over 3 plies from None."""
    jm = JaxNet(norm_kind=norm, policy_head=head, **SMALL)
    v = _flax_variables(jm, seed=3)
    net = GeisterNet(norm_kind=norm, policy_head=head, **SMALL)
    net.load_state_dict(params_from_flax(v))
    tol = LAYER_TOL if norm == 'layer' else TOL
    jh, th = None, None
    for ply in range(3):
        obs = geister_obs(6, seed=ply)
        want = jm.apply(v, obs, jh)
        got = net({k: torch.from_numpy(a) for k, a in obs.items()}, th)
        for k in ('policy', 'value', 'return'):
            assert got[k].shape == want[k].shape, k
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       np.asarray(want[k]), rtol=0,
                                       atol=tol, err_msg='%s ply %d'
                                       % (k, ply))
        assert len(got['hidden'][0]) == len(want['hidden'][0]) == 2
        for a, b in zip(got['hidden'][0] + got['hidden'][1],
                        want['hidden'][0] + want['hidden'][1]):
            assert tuple(a.shape) == b.shape == (6, 6, 6, 8)
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=0, atol=tol)
        jh, th = want['hidden'], got['hidden']
        th = _hidden_torch(jax.tree_util.tree_map(np.asarray, jh))


def test_init_hidden_is_distinct_zero_leaves():
    net = GeisterNet(**SMALL)
    hs, cs = net.init_hidden((3, 2))
    assert len(hs) == len(cs) == 2
    leaves = hs + cs
    assert all(tuple(t.shape) == (3, 2, 6, 6, 8) and not t.any()
               for t in leaves)
    assert len({t.data_ptr() for t in leaves}) == 4
    jh = JaxNet(**SMALL).init_hidden((3, 2))
    assert [np.shape(t) for t in jh[0] + jh[1]] == [
        tuple(t.shape) for t in leaves]


@pytest.mark.parametrize('head', ['dense', 'spatial'])
def test_torch_init_kind_draws_within_its_bounds(head):
    """``init_kind='torch'``: kernels and biases uniform in
    +-1/sqrt(fan_in) (fan_in = receptive field x input channels), as the
    JAX package's ``torch_default_inits``; flax's tree of the same
    structure; the spread reaches most of the bound."""
    net = GeisterNet(init_kind='torch', policy_head=head,
                     generator=torch.Generator().manual_seed(0))
    checked = 0
    for name, p in net.named_parameters():
        if '.norm.' in name:
            continue
        w = p.detach()
        if name.endswith('bias'):
            mod = net.get_submodule(name.rsplit('.', 1)[0])
            fan_in = mod.weight[0].numel()
        else:
            fan_in = w[0].numel()
        bound = 1.0 / fan_in ** 0.5
        assert float(w.abs().max()) <= bound + 1e-5, name
        if w.numel() >= 64:
            assert float(w.abs().max()) > 0.8 * bound, name
        checked += 1
    assert checked >= 10
    jm = JaxNet(init_kind='torch', policy_head=head)
    v = _flax_variables(jm)
    assert (jax.tree_util.tree_structure(params_to_flax(net))
            == jax.tree_util.tree_structure(v))


@pytest.mark.timeout(120)
@pytest.mark.parametrize('norm', ['group', 'batch', 'layer'])
def test_params_and_snapshots_cross_both_packages(norm):
    """The flax variables round trip exactly (the running averages as the
    ``batch_stats`` collection); a JAX snapshot rebuilds the port's net
    with its config and the same outputs; the port's snapshot rebuilds the
    JAX wrapper with the same bytes."""
    jm = JaxNet(norm_kind=norm, policy_head='spatial', **SMALL)
    v = _flax_variables(jm, seed=5)
    net = GeisterNet(norm_kind=norm, policy_head='spatial', **SMALL)
    net.load_state_dict(params_from_flax(v))
    back = params_to_flax(net)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(v))
    for a, b in zip(jax.tree_util.tree_leaves(v),
                    jax.tree_util.tree_leaves(back)):
        assert a.shape == b.shape and np.array_equal(a, b)
    jw = JaxModelWrapper(jm, v)
    pw = ModelWrapper.from_snapshot(jw.snapshot(), device='cpu')
    assert isinstance(pw.module, GeisterNet)
    assert pw.snapshot()['config'] == jw.snapshot()['config']
    obs = geister_obs(5, seed=9)
    np.testing.assert_allclose(
        pw.batch_inference(obs)['policy'],
        np.asarray(jw.batch_inference(obs)['policy']), rtol=0,
        atol=LAYER_TOL if norm == 'layer' else TOL)
    one = {k: a[0] for k, a in obs.items()}
    np.testing.assert_allclose(pw.inference(one)['value'],
                               np.asarray(jw.inference(one)['value']),
                               rtol=0, atol=TOL)
    again = JaxModelWrapper.from_snapshot(pw.snapshot(), one)
    assert again.params_bytes() == jw.params_bytes()
    assert params_bytes(pw.module) == jw.params_bytes()
