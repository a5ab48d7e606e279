"""The port's tensor twin of Hungry Geese (handyrl_tpu_torch/envs/
torch_hungry_geese.py) against the JAX package's twin and the port's host
simulator.

- States reached by JAX rollouts (random actions, numpy seed) go through
  both packages' ``step`` with the same actions: every field but the food
  equal exactly (integers, and scores that are integers in float32). Food
  equal where no goose ate; where one ate, the port's new food lies on a
  cell no goose holds and is not the other food (the draws differ: each
  package has its own generator). ``observe``, ``outcome``, ``terminal``
  and ``acting`` equal exactly on every state; ``greedy_action`` equal
  wherever a candidate exists (elsewhere both draw a random fallback).
- The rule scenarios of tests/test_geese_conformance.py, one parametrised
  test, against the port's host simulator (envs/kaggle/hungry_geese.py).
- ``auto_reset`` and the invariants of a 200-ply random rollout, as
  tests/test_jax_geese.py holds the JAX twin.
"""

import os
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.envs import jax_hungry_geese as jhg
from handyrl_tpu_torch.envs import torch_hungry_geese as tg
from handyrl_tpu_torch.envs.kaggle.hungry_geese import Environment as Host


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


N_ENVS = 8
FIELDS = ('cells', 'length', 'alive', 'last_action', 'prev_heads', 'steps',
          'scores')


def _to_port(js) -> tg.State:
    return tg.State(*[torch.from_numpy(np.array(getattr(js, f)))
                      for f in tg.State._fields])


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _greedy_with_candidate(state):
    """The port's greedy actions and where a candidate exists: with no
    candidate the fallback follows the uniform, so u = 0 and u ~ 1 give
    actions 0 and 3 there."""
    n = state.cells.shape[0]
    lo = tg.greedy_action(state, u=torch.zeros(n, 4))
    hi = tg.greedy_action(state, u=torch.full((n, 4), 0.999))
    return lo, (lo == hi).numpy()


def test_step_and_views_match_jax_along_jax_rollouts():
    rng = np.random.RandomState(3)
    js = jhg.init_state(N_ENVS, seed=5)
    jstep, jreset = jax.jit(jhg.step), jax.jit(jhg.auto_reset)
    jobs, jgreedy = jax.jit(jhg.observe), jax.jit(jhg.greedy_action)
    ate_seen = checked = 0
    for ply in range(120):
        ps = _to_port(js)
        np.testing.assert_array_equal(_np(tg.observe(ps)),
                                      np.asarray(jobs(js)))
        for fn in ('outcome', 'terminal', 'acting', 'legal_mask'):
            np.testing.assert_array_equal(_np(getattr(tg, fn)(ps)),
                                          np.asarray(getattr(jhg, fn)(js)),
                                          err_msg='%s ply %d' % (fn, ply))
        want = np.asarray(jgreedy(js, jax.random.PRNGKey(ply)))
        got, has = _greedy_with_candidate(ps)
        np.testing.assert_array_equal(got.numpy()[has], want[has])
        checked += int(has.sum())

        actions = rng.randint(0, 4, (N_ENVS, 4)).astype(np.int32)
        jn = jstep(js, jnp.asarray(actions))
        pn = tg.step(ps, torch.from_numpy(actions),
                     u=torch.from_numpy(rng.rand(N_ENVS, 2).astype(np.float32)))
        for f in FIELDS:
            np.testing.assert_array_equal(_np(getattr(pn, f)),
                                          np.asarray(getattr(jn, f)),
                                          err_msg='%s ply %d' % (f, ply))
        jfood, pfood = np.asarray(jn.food), pn.food.numpy()
        old = np.asarray(js.food)
        for i in range(N_ENVS):
            eaten = jfood[i] != old[i]
            np.testing.assert_array_equal(pfood[i][~eaten], old[i][~eaten])
            if not eaten.any():
                continue
            ate_seen += 1
            cells, length = pn.cells.numpy()[i], pn.length.numpy()[i]
            held = {int(c) for p in range(4) for c in cells[p, :length[p]]}
            assert not (set(pfood[i].tolist()) & held), (ply, i)
            assert pfood[i][0] != pfood[i][1], (ply, i)
        js = jreset(jn, jhg.terminal(jn))
    assert ate_seen > 5 and checked > 1000


# (geese, food, actions, last_actions, steps, alive after the step), from
# tests/test_geese_conformance.py; N S W E = 0 1 2 3
N, S, W, E = 0, 1, 2, 3
SCENARIOS = {
    'reversal_kills_even_at_length_1': (
        [[5], [20], [40], [60]], [70, 75], [W, E, E, E], {0: E}, 0,
        [False, True, True, True]),
    'reversal_kills_at_length_2': (
        [[5, 4], [20], [40], [60]], [70, 75], [W, E, E, E], {0: E}, 0,
        [False, True, True, True]),
    'non_opposite_first_step_is_free': (
        [[5], [20], [40], [60]], [70, 75], [W, E, E, E], {}, 0,
        [True] * 4),
    'head_swap_length_1_passes_through': (
        [[0], [1], [40], [60]], [70, 75], [E, W, E, E], {}, 0, [True] * 4),
    'head_swap_length_2_kills_both': (
        [[5, 4], [6, 7], [40], [60]], [70, 75], [E, W, E, E], {0: E, 1: W},
        0, [False, False, True, True]),
    'two_heads_same_cell_kill_both': (
        [[4], [6], [40], [60]], [70, 75], [E, W, E, E], {}, 0,
        [False, False, True, True]),
    'eat_then_hunger_same_step_nets_zero': (
        [[5, 4], [30, 31], [50, 51], [60, 61]], [6, 75], [E, W, N, N], {},
        tg.HUNGER_RATE - 1, [True] * 4),
    'hunger_starves_length_1_goose': (
        [[5], [30, 31], [50, 51], [60, 61]], [70, 75], [E, W, N, N], {},
        tg.HUNGER_RATE - 1, [False, True, True, True]),
    'own_vacated_tail_is_safe': (
        [[11, 12, 1, 0], [40], [50], [60]], [70, 75], [N, E, E, E], {0: W},
        0, [True] * 4),
    'eating_onto_own_tail_kills': (
        [[11, 12, 1, 0], [40], [50], [60]], [0, 75], [N, E, E, E], {0: W},
        0, [False, True, True, True]),
    'opponents_vacated_tail_is_safe': (
        [[8], [5, 6, 7], [40], [60]], [70, 75], [W, W, E, E], {1: W}, 0,
        [True] * 4),
    'self_collided_goose_body_does_not_kill_others': (
        [[40], [17, 28, 29, 30, 19, 18], [50], [60]], [70, 75], [N, S, E, E],
        {1: W}, 0, [True, False, True, True]),
    'reversed_goose_body_does_not_kill_others': (
        [[31], [20, 21, 22, 23], [50], [60]], [70, 75], [N, E, E, E],
        {1: W}, 0, [True, False, True, True]),
    'three_heads_one_cell_kill_all': (
        [[5], [27], [15], [60]], [70, 75], [S, N, E, E], {}, 0,
        [False, False, False, True]),
    'pileup_on_food_consumes_and_respawns': (
        [[5], [27], [15], [60]], [16, 75], [S, N, E, E], {}, 0,
        [False, False, False, True]),
    'four_way_pileup_ends_the_episode': (
        [[5], [27], [15], [17]], [70, 75], [S, N, E, W], {}, 0,
        [False] * 4),
    'all_east': (
        [[0], [20], [40], [60]], [5, 70], [E, E, E, E], {}, 0, [True] * 4),
    'eat': ([[0], [20], [40], [60]], [1, 70], [E, E, E, E], {}, 0,
            [True] * 4),
    'head_on': ([[0], [2], [40], [60]], [70, 75], [E, W, E, E], {}, 0,
                [False, False, True, True]),
    'body_hit': ([[0], [12, 1, 2], [40], [60]], [70, 75], [E, S, E, E], {},
                 0, [False, True, True, True]),
}


def _device_state(geese, food, last_actions, steps) -> tg.State:
    cells = torch.full((1, 4, tg.MAX_LEN), -1, dtype=torch.int32)
    length = torch.zeros((1, 4), dtype=torch.int32)
    for p, goose in enumerate(geese):
        cells[0, p, :len(goose)] = torch.tensor(goose, dtype=torch.int32)
        length[0, p] = len(goose)
    last = torch.full((1, 4), -1, dtype=torch.int32)
    for p, a in last_actions.items():
        last[0, p] = a
    alive = length > 0
    st = torch.full((1,), steps, dtype=torch.int32)
    scores = torch.where(alive, ((st[:, None] + 1) * tg.MAX_LEN_SCORE
                                 + length).float(), 0.0)
    return tg.State(cells=cells, length=length, alive=alive,
                    food=torch.tensor([food], dtype=torch.int32),
                    last_action=last,
                    prev_heads=torch.full((1, 4), -1, dtype=torch.int32),
                    steps=st, scores=scores)


def _host(geese, food, last_actions, steps) -> Host:
    e = Host({})
    e.geese = [list(g) for g in geese]
    e.prev_geese = [list(g) for g in geese]
    e.food = list(food)
    e.alive = [len(g) > 0 for g in geese]
    e.last_actions = dict(last_actions)
    e.step_count = steps
    e.scores = [0.0] * 4
    e._update_scores()
    return e


@pytest.mark.parametrize('name', sorted(SCENARIOS))
def test_conformance_scenarios_against_the_host_simulator(name):
    geese, food, actions, last, steps, alive = SCENARIOS[name]
    host = _host(geese, food, last, steps)
    host.step({p: a for p, a in enumerate(actions)})
    dev = tg.step(_device_state(geese, food, last, steps),
                  torch.tensor([actions]), u=torch.full((1, 2), 0.5))
    assert host.alive == alive
    assert dev.alive[0].tolist() == alive
    for p in range(4):
        n = int(dev.length[0, p])
        assert n == len(host.geese[p]), (name, p)
        assert dev.cells[0, p, :n].tolist() == host.geese[p], (name, p)
    held = {c for g in host.geese for c in g}
    dfood = dev.food[0].tolist()
    assert len(set(dfood)) == 2 and not (set(dfood) & held)
    assert bool(tg.terminal(dev)[0]) == host.terminal()
    if host.terminal():
        assert tg.outcome(dev)[0].tolist() == pytest.approx(
            [host.outcome()[p] for p in range(4)])
    # observation planes, from the same position (previous heads aside:
    # the host keeps the previous board, the twin its previous heads)
    st = _device_state(geese, food, last, steps)
    obs = tg.observe(st)[0].numpy()
    ref = _host(geese, food, last, steps)
    for viewer in range(4):
        want = ref.observation(viewer)
        got = obs[viewer].copy()
        got[12:16] = want[12:16]
        np.testing.assert_array_equal(got, want)


def test_auto_reset_starts_fresh_games_where_done():
    gen = torch.Generator().manual_seed(0)
    state = tg.init_state(6, generator=gen)
    for _ in range(5):
        state = tg.step(state, torch.randint(0, 4, (6, 4), generator=gen),
                        generator=gen)
    done = torch.tensor([True, False, True, False, False, True])
    u = torch.rand((6, tg.N_CELLS), generator=gen)
    reset = tg.auto_reset(state, done, u=u)
    for i in range(6):
        if not done[i]:
            for f in tg.State._fields:
                assert torch.equal(getattr(reset, f)[i], getattr(state, f)[i])
            continue
        assert reset.length[i].tolist() == [1] * 4
        assert reset.alive[i].all() and int(reset.steps[i]) == 0
        assert reset.last_action[i].tolist() == [-1] * 4
        assert reset.prev_heads[i].tolist() == [-1] * 4
        assert reset.scores[i].tolist() == [tg.MAX_LEN_SCORE + 1.0] * 4
        picks = reset.cells[i, :, 0].tolist() + reset.food[i].tolist()
        assert picks == torch.argsort(u[i], stable=True)[:6].tolist()
        assert (reset.cells[i, :, 1:] == -1).all()
    # the same uniforms give the same boards; other uniforms other boards
    again = tg.auto_reset(state, done, u=u)
    assert torch.equal(again.cells, reset.cells)
    other = tg.auto_reset(state, done, u=torch.rand((6, 77), generator=gen))
    assert not torch.equal(other.cells, reset.cells)


def test_random_rollout_invariants_over_200_plies():
    gen = torch.Generator().manual_seed(1)
    state = tg.init_state(8, generator=gen)
    finished = 0
    for _ in range(200):
        state = tg.step(state, torch.randint(0, 4, (8, 4), generator=gen),
                        generator=gen)
        done = tg.terminal(state)
        finished += int(done.sum())
        state = tg.auto_reset(state, done, generator=gen)
        lengths, alive = state.length.numpy(), state.alive.numpy()
        assert (lengths[alive] >= 1).all()
        assert (lengths[~alive] == 0).all()
        cells, food = state.cells.numpy(), state.food.numpy()
        for i in range(8):
            occ = [int(c) for p in range(4) if alive[i, p]
                   for c in cells[i, p, :lengths[i, p]]]
            assert len(occ) == len(set(occ))
            assert len(set(food[i])) == tg.N_FOOD
            assert not (set(food[i].tolist()) & set(occ))
        assert (state.steps.numpy() < tg.MAX_STEPS).all()
    assert finished > 8
