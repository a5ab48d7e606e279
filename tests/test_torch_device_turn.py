"""The fused loop's 'turn' layout against the JAX package: the TicTacToe
tensor twin (handyrl_tpu_torch/envs/torch_tictactoe.py against
handyrl_tpu/envs/jax_tictactoe.py), the turn windows and their ingest
(ops/device_windows.py), the turn-based self-play ply and evaluator
(device_generation.py) and the K-step update on a turn ring
(``ReplayUpdateStep`` against ``build_replay_update``).

- The twin plays whole random games (numpy seed) like the JAX twin:
  boards, side, winner, moves, observations, legal masks, the acting
  player, outcomes and auto-reset equal exactly.
- ``build_windows_turn`` equals the JAX package's for every train start
  (burn-in included): exactly. It equals the port's host batch builder's
  compact turn windows (``turn_based_training``, ``observation=False``)
  within rtol 1e-5, atol 1e-6, as tests/test_device_windows.py holds the
  JAX windower (progress comes through the host's own float32 arange).
- The turn ingest of JAX twin records, with the train starts' uniforms the
  JAX key splits give, fills the JAX ring rows, cursor, size, history and
  counts exactly, into a ring the windows wrap.
- The self-play ply and the evaluator run ply by ply from the JAX state
  with the same weights (``params_from_flax``) and the draws the JAX key
  splits give: records exactly, prob and value within 1e-5 (the nets'
  float32 sums differ in order); the evaluator's packed rows, seats and
  result records exactly, its seats rotating over the two players.
- Three K-step updates on a ring of real turn windows match the JAX
  package's ``build_replay_update`` on the same slots within
  tests/test_torch_replay_update.py's tolerances.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu import device_generation as jdg
from handyrl_tpu.envs import jax_tictactoe as jtt
from handyrl_tpu.envs.tictactoe import WIN_LINES as HOST_WIN_LINES
from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
from handyrl_tpu.models.tictactoe import SimpleConv2dModel as JaxModel
from handyrl_tpu.ops import device_windows as jdw
from handyrl_tpu.ops.losses import LossConfig as JaxLossConfig
from handyrl_tpu.ops.replay import recency_slots as jax_recency_slots
from handyrl_tpu.ops.train_step import build_replay_update
from handyrl_tpu.ops.train_step import init_train_state as jax_init_state
from handyrl_tpu_torch import device_generation as dg
from handyrl_tpu_torch.environment import make_device_env
from handyrl_tpu_torch.envs import torch_tictactoe as tt
from handyrl_tpu_torch.models.tictactoe import (SimpleConv2dModel,
                                                params_from_flax)
from handyrl_tpu_torch.ops import device_windows as dw
from handyrl_tpu_torch.ops import losses, train_step
from handyrl_tpu_torch.ops.batch import compress_moments, make_batch

pytestmark = pytest.mark.timeout(60)   # each test's own limit


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


TINY = float(np.finfo(np.float32).tiny)
N = 8
FILTERS, LAYERS = 16, 2


def _to_port(js) -> tt.State:
    return tt.State(*[torch.from_numpy(np.array(getattr(js, f)))
                      for f in tt.State._fields])


def _assert_state_equal(port, js, what):
    for f in tt.State._fields:
        a, b = getattr(port, f).numpy(), np.asarray(getattr(js, f))
        assert a.dtype == b.dtype, (f, what)
        np.testing.assert_array_equal(a, b, err_msg='%s %s' % (f, what))


def _random_legal(rng, legal):
    return np.argmax(rng.rand(*legal.shape) * legal, axis=1)


def test_twin_tables_and_registry():
    assert tt.WIN_LINES == tuple(tuple(int(v) for v in row)
                                 for row in HOST_WIN_LINES)
    assert tt.win_lines('cpu').tolist() == [list(r) for r in tt.WIN_LINES]
    assert make_device_env({'env': 'TicTacToe'}) is tt
    for name in ('N_ACTIONS', 'MAX_STEPS', 'NUM_PLAYERS', 'RNG_COMPAT'):
        assert getattr(tt, name) == getattr(jtt, name), name
    assert not hasattr(tt, 'greedy_action') and not hasattr(tt,
                                                            'SIMULTANEOUS')


def test_twin_matches_jax_over_whole_random_games():
    rng = np.random.RandomState(0)
    js, ps = jtt.init_state(N), tt.init_state(N)
    _assert_state_equal(ps, js, 'init')
    games = 0
    for ply in range(80):
        for name in ('legal_mask', 'observe', 'terminal'):
            np.testing.assert_array_equal(
                getattr(tt, name)(ps).numpy(),
                np.asarray(getattr(jtt, name)(js)), err_msg=name)
        np.testing.assert_array_equal(tt.turn(ps).numpy(),
                                      np.asarray(jtt.turn(js)))
        actions = _random_legal(rng, np.asarray(jtt.legal_mask(js)))
        js = jtt.step(js, jnp.asarray(actions, jnp.int32))
        ps = tt.step(ps, torch.from_numpy(actions))
        _assert_state_equal(ps, js, 'step %d' % ply)
        done = np.asarray(jtt.terminal(js))
        np.testing.assert_array_equal(tt.terminal(ps).numpy(), done)
        np.testing.assert_array_equal(tt.outcome(ps).numpy(),
                                      np.asarray(jtt.outcome(js)))
        js = jtt.auto_reset(js, jnp.asarray(done))
        ps = tt.auto_reset(ps, torch.from_numpy(done))
        _assert_state_equal(ps, js, 'reset %d' % ply)
        games += int(done.sum())
    assert games >= 40


# ------------------------------------------------------------- windows

FS, BI, L, P, A = 4, 2, 9, 2, 9


def _turn_episode(S=9, seed=3):
    rng = np.random.RandomState(seed)
    return dict(
        obs=rng.rand(S, 3, 3, 3).astype(np.float32),
        prob=rng.uniform(0.1, 1.0, S).astype(np.float32),
        action=rng.randint(0, A, S).astype(np.int32),
        amask=np.where(rng.rand(S, A) < 0.3, 1e32, 0).astype(np.float32),
        value=rng.uniform(-1, 1, (S, 1)).astype(np.float32),
        player=(np.arange(S) % 2).astype(np.int64),
        outcome=np.array([1.0, -1.0], np.float32), S=S)


def _hist(ep):
    S = ep['S']
    pad = lambda a: np.concatenate(   # noqa: E731
        [a, np.zeros((L - S,) + a.shape[1:], a.dtype)])
    return {k: pad(ep[k]) for k in ('obs', 'prob', 'action', 'amask',
                                    'value', 'player')}


@pytest.mark.parametrize('S', [9, 5, 2])
def test_build_windows_turn_matches_jax_for_every_start(S):
    ep = _turn_episode(S=S)
    hist = _hist(ep)
    jh = {k: jnp.asarray(v.astype(np.int32) if k == 'player' else v)
          for k, v in hist.items()}
    th = {k: torch.from_numpy(v) for k, v in hist.items()}
    starts = np.arange(1 + max(0, S - FS), dtype=np.int32)
    want = jdw.build_windows_turn(jh, jnp.int32(S), jnp.asarray(starts),
                                  jnp.asarray(ep['outcome']), FS, BI, L, P)
    got = dw.build_windows_turn(th, S, torch.from_numpy(starts),
                                torch.from_numpy(ep['outcome']), FS, BI, L,
                                P)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == getattr(torch, str(want[k].dtype)), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def _moments(ep):
    moments = []
    for t in range(ep['S']):
        m = {key: {q: None for q in range(P)} for key in
             ('observation', 'selected_prob', 'action_mask', 'action',
              'value', 'reward', 'return')}
        p = int(ep['player'][t])
        m['turn'] = [p]
        m['observation'][p] = ep['obs'][t]
        m['selected_prob'][p] = float(ep['prob'][t])
        m['action_mask'][p] = ep['amask'][t]
        m['action'][p] = int(ep['action'][t])
        m['value'][p] = ep['value'][t]
        moments.append(m)
    return moments


def test_turn_windows_match_the_host_batch_builder():
    args = {'turn_based_training': True, 'observation': False,
            'forward_steps': FS, 'burn_in_steps': BI, 'compress_steps': 3}
    ep = _turn_episode(S=9, seed=4)
    S, cs = ep['S'], args['compress_steps']
    blocks = compress_moments(_moments(ep), cs)
    th = {k: torch.from_numpy(v) for k, v in _hist(ep).items()}
    for ts in range(1 + max(0, S - FS)):
        st, ed = max(0, ts - BI), min(ts + FS, S)
        sb, eb = st // cs, (ed - 1) // cs + 1
        window = {'args': {}, 'outcome': {q: float(ep['outcome'][q])
                                          for q in range(P)},
                  'moment': blocks[sb:eb], 'base': sb * cs, 'start': st,
                  'end': ed, 'train_start': ts, 'total': S}
        host = make_batch([window], args)
        dev = dw.build_windows_turn(th, S, torch.tensor([ts]),
                                    torch.from_numpy(ep['outcome']), FS, BI,
                                    L, P)
        for key in host:
            assert dev[key].shape == host[key].shape, key
            np.testing.assert_allclose(
                dev[key].numpy().astype(np.float32),
                np.asarray(host[key], np.float32), rtol=1e-5, atol=1e-6,
                err_msg='%s ts %d' % (key, ts))


def _jax_records(K, n, seed):
    """K plies of n JAX-twin games under random legal moves, as the turn
    rollout records them."""
    rng = np.random.RandomState(seed)
    js = jtt.init_state(n)
    plies = []
    for _ in range(K):
        legal = np.asarray(jtt.legal_mask(js))
        actions = _random_legal(rng, legal).astype(np.int32)
        nxt = jtt.step(js, jnp.asarray(actions))
        done = np.asarray(jtt.terminal(nxt))
        plies.append({
            'obs': np.asarray(jtt.observe(js)), 'action': actions,
            'prob': rng.uniform(0.1, 1, n).astype(np.float32),
            'amask': ((1 - legal) * 1e32).astype(np.float32),
            'value': rng.uniform(-1, 1, (n, 1)).astype(np.float32),
            'player': np.asarray(jtt.turn(js)), 'done': done,
            'outcome': np.asarray(jtt.outcome(nxt))})
        js = jtt.auto_reset(nxt, jnp.asarray(done))
    return {k: np.stack([p[k] for p in plies]) for k in plies[0]}


def _jax_draws(key, K, n, W):
    """The windower's per-ply draws from its key (the train starts'
    uniforms; the seat key is split off and unused in turn mode)."""
    us = []
    for _ in range(K):
        key, k_ts, _ = jax.random.split(key, 3)
        us.append(np.asarray(jax.random.uniform(k_ts, (n, W))))
    u = torch.from_numpy(np.stack(us))
    return {'u': u, 'seat': torch.zeros(u.shape, dtype=torch.int64)}


@pytest.mark.parametrize('capacity', [256, 20])
def test_turn_ingest_of_jax_records_fills_the_jax_rows(capacity):
    K, n, W, fs = 30, 6, 2, 3
    rec = _jax_records(K, n, seed=2)
    key = jax.random.PRNGKey(9)
    draws = _jax_draws(key, K, n, W)   # before the ingest donates the key
    jwd = jdw.DeviceWindower('turn', fs, 0, jtt.MAX_STEPS, W, capacity, 2,
                             0.8, False)
    jrec = {k: jnp.asarray(v) for k, v in rec.items()}
    jstate = jwd.init_state(jrec)
    jring = jwd.init_ring(jrec)
    jstate, jring, jcur, jsize, _, jdone, jwin = jwd.ingest(
        jrec, jstate, jring, jnp.int32(0), jnp.int32(0), key)

    wd = dw.DeviceWindower('turn', fs, 0, tt.MAX_STEPS, W, capacity, 2,
                           0.8, False)
    trec = {k: torch.from_numpy(v) for k, v in rec.items()}
    state = wd.init_state(trec)
    ring = wd.init_ring(trec)
    assert set(ring) == set(jring)
    for k in ring:
        assert wd.window_spec[k][0] == jwd.window_spec[k][0], k
    cursor, size = torch.zeros((), dtype=torch.int64), torch.zeros(
        (), dtype=torch.int64)
    done, win = wd.ingest(trec, state, ring, cursor, size, draws=draws)
    assert (int(done), int(win)) == (int(jdone), int(jwin))
    assert int(win) > capacity or capacity > 100
    assert (int(cursor), int(size)) == (int(jcur), int(jsize))
    for k in ring:
        np.testing.assert_array_equal(ring[k][:capacity].numpy(),
                                      np.asarray(jring[k]), err_msg=k)
    for k in state['hist']:
        np.testing.assert_array_equal(state['hist'][k].numpy(),
                                      np.asarray(jstate['hist'][k]),
                                      err_msg=k)
    np.testing.assert_array_equal(state['counts'].numpy(),
                                  np.asarray(jstate['counts']))


# ------------------------------------------------ self-play and evaluation

def _jax_pair(seed=0):
    """A JAX SimpleConv2dModel (its params) and the port's net with the
    same weights."""
    jm = JaxModel(filters=FILTERS, layers=LAYERS)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 3, 3, 3), jnp.float32))
    net = SimpleConv2dModel(filters=FILTERS, layers=LAYERS)
    net.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, net


def test_gen_body_records_the_turn_layout():
    _, _, net = _jax_pair()
    rollout = dg.make_gen_body(tt, net)
    state, rec, _ = rollout(tt.init_state(5), 7,
                            torch.Generator().manual_seed(1))
    assert rec['obs'].shape == (7, 5, 3, 3, 3)
    assert rec['action'].shape == rec['prob'].shape == (7, 5)
    assert rec['amask'].shape == (7, 5, 9) and rec['value'].shape == (7, 5, 1)
    assert rec['player'].tolist()[0] == [0] * 5
    assert rec['outcome'].shape == (7, 5, 2) and 'acting' not in rec
    # a legal move every ply
    legal = rec['amask'] < 1
    assert legal.gather(-1, rec['action'].long()[..., None]).all()


def test_gen_body_matches_jax_ply_by_ply(monkeypatch):
    """obs, amask, player, action, done and outcome equal exactly, prob and
    value within 1e-5."""
    jm, params, net = _jax_pair()
    jroll = jax.jit(jdg.make_gen_body(jtt, jm.apply, False, False),
                    static_argnums=4)
    rollout = dg.make_gen_body(tt, net)
    real_gumbel = dg.gumbel_argmax
    cur = {}
    monkeypatch.setattr(dg, 'gumbel_argmax',
                        lambda logits, u: real_gumbel(logits, cur['u']))
    js, rng = jtt.init_state(N), jax.random.PRNGKey(8)
    gen = torch.Generator().manual_seed(1)
    dones = 0
    for ply in range(30):
        _, key = jax.random.split(rng)
        cur['u'] = torch.from_numpy(np.array(jax.random.uniform(
            key, (N, 9), minval=TINY, maxval=1.0)))
        ps, rec, _ = rollout(_to_port(js), 1, gen)
        js, _, rng, jrec = jroll(params, js, None, rng, 1)
        for k in ('obs', 'amask', 'player', 'action', 'done', 'outcome'):
            np.testing.assert_array_equal(rec[k].numpy(),
                                          np.asarray(jrec[k]),
                                          err_msg='%s ply %d' % (k, ply))
        for k in ('prob', 'value'):
            np.testing.assert_allclose(rec[k].numpy(), np.asarray(jrec[k]),
                                       rtol=0, atol=1e-5,
                                       err_msg='%s ply %d' % (k, ply))
        _assert_state_equal(ps, js, 'ply %d' % ply)
        dones += int(rec['done'].sum())
    assert dones >= 10


def test_device_evaluator_matches_jax_ply_by_ply(monkeypatch):
    """The packed (done, seat, outcome) rows, the seats after each ply, the
    result records and the states equal exactly; the model moves on its
    seat's plies and the seats rotate over the two players."""
    jm, params, net = _jax_pair(seed=2)
    jev = jdg.DeviceEvaluator(jtt, JaxModelWrapper(jm, params), {},
                              n_envs=N, chunk_steps=1, seed=6,
                              opponents=['random'])
    ev = dg.DeviceEvaluator(tt, net, {}, n_envs=N, chunk_steps=1, seed=6,
                            opponents=['random'])
    assert ev.seat.tolist() == np.asarray(jev.seat).tolist() == [0, 1] * 4
    real_gumbel = dg.gumbel_argmax
    cur = {}
    monkeypatch.setattr(dg, 'gumbel_argmax',
                        lambda logits, u: real_gumbel(logits, cur['u']))
    results, seats_seen = [], set()
    for ply in range(40):
        _, key = jax.random.split(jev.rng)
        cur['u'] = torch.from_numpy(np.array(jax.random.uniform(
            key, (N, 9), minval=TINY, maxval=1.0)))
        dg.copy_state_(ev.state, _to_port(jev.state))
        ev.seat.copy_(torch.from_numpy(np.array(jev.seat)).long())
        packed = ev._rollout().numpy()
        (jev.state, jev.hidden, jev.opp_hidden, jev.seat, jev.rng,
         jrec) = jev._rollout(params, (), jev.state, None, None, jev.seat,
                              jev.rng)
        jrec = {k: np.asarray(v) for k, v in jrec.items()}
        want = np.concatenate([jrec['done'].reshape(-1).astype(np.float32),
                               jrec['seat'].reshape(-1).astype(np.float32),
                               jrec['outcome'].reshape(-1)])
        np.testing.assert_array_equal(packed, want, err_msg='ply %d' % ply)
        np.testing.assert_array_equal(ev.seat.numpy(), np.asarray(jev.seat))
        _assert_state_equal(ev.state, jev.state, 'ply %d' % ply)
        got = ev._collect(packed)
        assert got == jev._collect(jrec), ply
        results += got
        seats_seen |= set(ev.seat.tolist())
    assert len(results) >= 8 and seats_seen == {0, 1}
    for r in results:
        (seat,) = r['args']['player']
        assert r['args']['model_id'] == {q: 0 if q == seat else -1
                                         for q in range(2)}
        assert set(r['result']) == {0, 1}
        assert r['result'][0] == -r['result'][1]


def test_device_evaluator_refuses_a_rulebase_the_twin_lacks():
    _, _, net = _jax_pair()
    with pytest.raises(ValueError, match='greedy_action'):
        dg.DeviceEvaluator(tt, net, {}, n_envs=4, chunk_steps=2,
                           opponents=['random', 'rulebase'])


# ------------------------------------------------------ the K-step update

B, T, K, CAP = 4, 4, 3, 12
EMA = 3333.0                     # lr = 3e-8 * EMA ~ 1e-4
LR = 3e-8 * EMA
METRIC_TOL = dict(rtol=1e-4, atol=1e-4)
MOMENT_RTOL, MOMENT_ATOL_OF_MAX = 1e-4, 1e-4
PARAM_ATOL = LR / 10
CFG = dict(turn_based_training=True, observation=False,
           policy_target='TD', value_target='TD', gamma=0.8, lmb=0.7)


def _turn_ring():
    """A ring of real turn windows: random TicTacToe games (JAX twin)
    ingested by the port's windower into CAP rows."""
    rec = _jax_records(24, 6, seed=5)
    wd = dw.DeviceWindower('turn', T, 0, tt.MAX_STEPS, 1, CAP, 2, 0.8,
                           False)
    trec = {k: torch.from_numpy(v) for k, v in rec.items()}
    state, ring = wd.init_state(trec), wd.init_ring(trec)
    cursor, size = torch.zeros((), dtype=torch.int64), torch.zeros(
        (), dtype=torch.int64)
    _, win = wd.ingest(trec, state, ring, cursor, size,
                       generator=torch.Generator().manual_seed(3))
    assert int(win) > CAP and int(size) == CAP
    return ring, wd.window_spec, int(cursor)


def test_k_steps_on_a_turn_ring_match_jax_build_replay_update():
    ring, spec, cursor = _turn_ring()
    jm, params, net = _jax_pair(seed=4)
    jcfg = JaxLossConfig(turn_based_training=True, observation=False,
                         policy_target='TD', value_target='TD', gamma=0.8,
                         lmb=0.7)
    jspec = {k: (shape, None) for k, (shape, _) in spec.items()}
    fused = build_replay_update(jm, jcfg, capacity=CAP, batch_size=B,
                                num_steps=K, spec_fn=lambda: (jspec, None))
    key = jax.random.PRNGKey(4)
    k, slots = key, []
    for _ in range(K):
        k, sub = jax.random.split(k)
        slots.append(np.asarray(jax_recency_slots(
            sub, jnp.int32(CAP), jnp.int32(cursor), CAP, B)))
    jring = {k2: jnp.asarray(v[:CAP].numpy()) for k2, v in ring.items()}
    jstate, _, jsum = fused(jax_init_state(params), jring, key,
                            jnp.int32(CAP), jnp.int32(cursor),
                            jnp.asarray(EMA, jnp.float32))

    step = train_step.ReplayUpdateStep(net, losses.LossConfig(**CFG),
                                       train_step.init_train_state(net))
    step.bind(ring, spec, torch.tensor(CAP), torch.tensor(cursor), CAP, B,
              None)
    got = step.unpack(step.run(K, EMA, slots=torch.from_numpy(
        np.stack(slots)).long()))
    assert set(got) == set(jsum)
    for name in jsum:
        np.testing.assert_allclose(got[name].item(), float(jsum[name]),
                                   err_msg=name, **METRIC_TOL)
    assert got['data_count'].item() > 0
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
