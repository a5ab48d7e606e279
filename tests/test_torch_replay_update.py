"""The K-step replay update (handyrl_tpu_torch/ops/train_step.py
``ReplayUpdateStep``) and its slot draw (ops/replay.py ``recency_slots``)
against the port's static step and the JAX package's
``build_replay_update``.

- ``recency_slots`` equals the JAX package's for the same uniforms (the
  JAX draw's own): empty, partly filled and full, wrapped rings; exactly
  (one float32 sqrt and product, truncation, the same clip and offset).
- K = 3 steps of ``ReplayUpdateStep`` equal three sequential
  ``StaticUpdateStep`` calls on the batches gathered from the same slots,
  with the lr the JAX schedule gives from the step counter: bit for bit
  (the same body on the same device in the same order).
- They match the JAX package's ``build_replay_update`` (its slots from its
  key splits, fed to the port) on the same flat ring within
  tests/test_torch_graphed_step.py's tolerances: metrics rtol = atol =
  1e-4; mu and nu rtol 1e-4, atol 1e-4 of the largest element; params atol
  lr / 10 over the three steps. A small GeeseNet (filters 16, 2 blocks,
  'pallas' trunk: the JAX one in Pallas interpret mode, the port's plain
  version), B=4, T=4, VTRACE/VTRACE on a ring of 12 real-board windows.
"""

import os
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.models import build as jax_build
from handyrl_tpu.ops.losses import LossConfig as JaxLossConfig
from handyrl_tpu.ops.replay import recency_slots as jax_recency_slots
from handyrl_tpu.ops.train_step import build_replay_update
from handyrl_tpu.ops.train_step import init_train_state as jax_init_state
from handyrl_tpu_torch.models.geese import GeeseNet, params_from_flax
from handyrl_tpu_torch.ops import losses, train_step
from handyrl_tpu_torch.ops.replay import recency_slots, ring_capacity


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


FILTERS, LAYERS, B, T, K, CAP = 16, 2, 4, 4, 3, 12
EMA = 3333.0                     # lr = 3e-8 * EMA ~ 1e-4
LR = 3e-8 * EMA
METRIC_TOL = dict(rtol=1e-4, atol=1e-4)
MOMENT_RTOL, MOMENT_ATOL_OF_MAX = 1e-4, 1e-4
PARAM_ATOL = LR / 10
CFG = dict(turn_based_training=False, observation=True,
           policy_target='VTRACE', value_target='VTRACE', gamma=0.99)


@pytest.mark.parametrize('size,cursor', [(0, 0), (1, 1), (7, 7), (12, 0),
                                         (12, 5), (12, 11)])
def test_recency_slots_match_jax(size, cursor):
    key = jax.random.PRNGKey(size * 31 + cursor)
    want = np.asarray(jax_recency_slots(key, jnp.int32(size),
                                        jnp.int32(cursor), CAP, 256))
    u = np.array(jax.random.uniform(key, (256,)))
    got = recency_slots(torch.from_numpy(u), torch.tensor(size),
                        torch.tensor(cursor), CAP)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() < CAP
    if size == 0:
        assert (got == 0).all()


def test_ring_capacity_is_the_jax_learners_rule():
    args = {'maximum_episodes': 100000, 'forward_steps': 16,
            'replay_windows_per_episode': None}
    assert ring_capacity(args) == 16384
    assert ring_capacity(dict(args, forward_steps=4)) == 49152
    assert ring_capacity(dict(args, maximum_episodes=2,
                              replay_windows_per_episode=2)) == 4


def _ring():
    """A flat ring of CAP solo windows (T, 1, ...) of real boards, with the
    windower's window spec."""
    from handyrl_tpu_torch.envs import torch_hungry_geese as tg
    rng = np.random.RandomState(0)
    gen = torch.Generator().manual_seed(0)
    state = tg.init_state(CAP, generator=gen)
    obs = []
    for _ in range(T):
        obs.append(tg.observe(state)[:, 0])
        state = tg.step(state, torch.randint(0, 4, (CAP, 4), generator=gen),
                        generator=gen)
        state = tg.auto_reset(state, tg.terminal(state), generator=gen)
    rows = {
        'observation': torch.stack(obs, 1)[:, :, None],
        'selected_prob': rng.uniform(0.2, 1, (CAP, T, 1, 1)),
        'action': rng.randint(0, 4, (CAP, T, 1, 1)),
        'action_mask': np.zeros((CAP, T, 1, 4)),
        'value': rng.uniform(-1, 1, (CAP, T, 1, 1)),
        'reward': np.zeros((CAP, T, 1, 1)),
        'return': np.zeros((CAP, T, 1, 1)),
        'outcome': rng.choice([-1, -1 / 3, 1 / 3, 1], (CAP, 1, 1, 1)),
        'episode_mask': np.ones((CAP, T, 1, 1)),
        'turn_mask': np.ones((CAP, T, 1, 1)),
        'observation_mask': np.ones((CAP, T, 1, 1)),
        'progress': rng.uniform(0, 1, (CAP, T, 1)),
    }
    spec, ring = {}, {}
    for k, v in rows.items():
        v = torch.as_tensor(np.asarray(v))
        v = v.to(torch.int32 if k == 'action' else torch.float32)
        spec[k] = (tuple(v.shape[1:]), v.dtype)
        ring[k] = torch.cat([v.reshape(CAP, -1),
                             torch.zeros((1, v[0].numel()), dtype=v.dtype)])
    return ring, spec


def _net():
    return GeeseNet(filters=FILTERS, layers=LAYERS, torus_impl='pallas',
                    generator=torch.Generator().manual_seed(1))


def _replay_step(net, ring, spec, size, cursor):
    step = train_step.ReplayUpdateStep(net, losses.LossConfig(**CFG),
                                       train_step.init_train_state(net))
    step.bind(ring, spec, torch.tensor(size), torch.tensor(cursor), CAP, B,
              None)
    return step


def _slots(size, cursor, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.stack([recency_slots(torch.rand(B, generator=g),
                                      torch.tensor(size),
                                      torch.tensor(cursor), CAP)
                        for _ in range(K)])


def test_k_steps_equal_k_static_steps_on_the_same_slots():
    ring, spec = _ring()
    net = _net()
    step = _replay_step(net, ring, spec, CAP, 5)
    static = train_step.StaticUpdateStep(net, losses.LossConfig(**CFG),
                                         train_step.init_train_state(net))
    slots = _slots(CAP, 5, seed=2)
    summed = step.unpack(step.run(K, EMA, slots=slots))
    want = {}
    for i in range(K):
        batch = {k: ring[k][slots[i]].reshape((B,) + spec[k][0])
                 for k in ring}
        lr = (torch.tensor(EMA, dtype=torch.float32) * 3e-8
              / (1 + static.state.steps.float() * 1e-5))
        for k, v in static(batch, lr).items():
            want[k] = want.get(k, 0) + v
    assert torch.equal(step.last_slots, slots[-1])
    for k in want:
        assert torch.equal(summed[k], want[k]), k
    a, b = step.state, static.state
    assert int(a.steps) == int(b.steps) == K
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        assert torch.equal(a.opt_state.mu[k], b.opt_state.mu[k]), k
        assert torch.equal(a.opt_state.nu[k], b.opt_state.nu[k]), k
    # a second call sums its own steps only
    again = step.unpack(step.run(1, EMA, slots=slots[:1]))
    assert again['data_count'] < summed['data_count']


def test_k_steps_match_jax_build_replay_update():
    ring, spec = _ring()
    size, cursor = CAP, 5
    jm = jax_build('GeeseNet', filters=FILTERS, layers=LAYERS,
                   torus_impl='pallas')
    obs0 = ring['observation'][:1].reshape((1,) + spec['observation'][0])
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(obs0[:, 0, 0]), None)
    net = _net()
    net.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))

    jspec = {k: (shape, None) for k, (shape, _) in spec.items()}
    fused = build_replay_update(jm, JaxLossConfig(**CFG), capacity=CAP,
                                batch_size=B, num_steps=K,
                                spec_fn=lambda: (jspec, None))
    key = jax.random.PRNGKey(4)
    # the slots of the JAX scan's key splits (train_step.py:245-247 there)
    k, slots = key, []
    for _ in range(K):
        k, sub = jax.random.split(k)
        slots.append(np.asarray(jax_recency_slots(
            sub, jnp.int32(size), jnp.int32(cursor), CAP, B)))
    jring = {k2: jnp.asarray(v[:CAP].numpy()) for k2, v in ring.items()}
    jstate, _, jsum = fused(jax_init_state(params), jring, key,
                            jnp.int32(size), jnp.int32(cursor),
                            jnp.asarray(EMA, jnp.float32))

    step = _replay_step(net, ring, spec, size, cursor)
    got = step.unpack(step.run(K, EMA, slots=torch.from_numpy(
        np.stack(slots)).long()))
    assert set(got) == set(jsum)
    for name in jsum:
        np.testing.assert_allclose(got[name].item(), float(jsum[name]),
                                   err_msg=name, **METRIC_TOL)
    st = step.state
    assert int(st.steps) == int(jstate.steps) == K
    flat = lambda tree: params_from_flax(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, tree))
    for name, want in flat(jstate.params).items():
        np.testing.assert_allclose(st.params[name].numpy(), want.numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)
    adam = jstate.opt_state[2]
    assert int(adam.count) == int(st.opt_state.count)
    for label, jtree, mine in (('mu', adam.mu, st.opt_state.mu),
                               ('nu', adam.nu, st.opt_state.nu)):
        for name, want in flat(jtree).items():
            w = want.numpy()
            np.testing.assert_allclose(
                mine[name].numpy(), w, rtol=MOMENT_RTOL,
                atol=MOMENT_ATOL_OF_MAX * np.abs(w).max(),
                err_msg='%s %s' % (label, name))


def test_run_needs_a_bound_ring():
    net = _net()
    step = train_step.ReplayUpdateStep(net, losses.LossConfig(**CFG),
                                       train_step.init_train_state(net))
    with pytest.raises(RuntimeError, match='bind'):
        step.run(1, EMA)
