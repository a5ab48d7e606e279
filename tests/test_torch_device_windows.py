"""Window assembly on the device (handyrl_tpu_torch/ops/device_windows.py,
solo layout) against the JAX package's windower and the port's host batch
builder.

- ``build_windows_solo`` equals the JAX package's on the same synthetic
  history (numpy seed) for every train start and seat, burn-in included:
  exactly (the same gathers, selects and one float32 division).
- The chunk ingest of records from a JAX rollout (the JAX env twin under
  random actions, numpy seed), with the train starts' uniforms and the
  seats that the JAX windower's key splits give (device_windows.py:351-370
  there), fills the same ring rows, cursor, size, history and counts as
  the JAX ingest: exactly. Once into a ring far larger than the chunk's
  windows, once into one they wrap (no ply writes more windows than the
  ring holds, where both packages' scatters would pick a winner freely).
- The windows equal the port's host ``ops/batch.make_batch`` windows of the
  same episode for every train start and seat (its seat draw pinned), as
  tests/test_device_windows.py holds the JAX windower to the JAX host
  builder, with its tolerance (rtol 1e-5, atol 1e-6: the host builder
  computes progress through its own float32 arange).
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.envs import jax_hungry_geese as jhg
from handyrl_tpu.ops import device_windows as jdw
from handyrl_tpu_torch.ops import device_windows as dw
from handyrl_tpu_torch.ops.batch import compress_moments, make_batch


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


FS, BI, L = 4, 2, 16
P, A = 3, 4


def _episode(S=9, seed=3):
    rng = np.random.RandomState(seed)
    acting = rng.rand(S, P) < 0.7
    acting[:, 0] = True
    return dict(
        obs=rng.rand(S, P, 2, 3, 3).astype(np.float32),
        prob=rng.uniform(0.1, 1.0, (S, P)).astype(np.float32),
        action=rng.randint(0, A, (S, P)).astype(np.int32),
        amask=np.where(rng.rand(S, P, A) < 0.3, 1e32, 0).astype(np.float32),
        value=rng.uniform(-1, 1, (S, P, 1)).astype(np.float32),
        acting=acting,
        outcome=np.array([1.0, -1 / 3, -2 / 3], np.float32), S=S)


def _hist(ep):
    S = ep['S']
    pad = lambda a: np.concatenate(   # noqa: E731
        [a, np.zeros((L - S,) + a.shape[1:], a.dtype)])
    return {k: pad(ep[k]) for k in ('obs', 'prob', 'action', 'amask',
                                    'value', 'acting')}


def test_build_windows_solo_matches_jax_for_every_start_and_seat():
    ep = _episode()
    hist = _hist(ep)
    jh = {k: jnp.asarray(v) for k, v in hist.items()}
    th = {k: torch.from_numpy(v) for k, v in hist.items()}
    S = ep['S']
    starts = np.arange(1 + max(0, S - FS), dtype=np.int32)
    for seat in range(P):
        seats = np.full_like(starts, seat)
        want = jdw.build_windows_solo(jh, jnp.int32(S), jnp.asarray(starts),
                                      jnp.asarray(seats),
                                      jnp.asarray(ep['outcome']), FS, BI, L)
        got = dw.build_windows_solo(th, S, torch.from_numpy(starts),
                                    torch.from_numpy(seats),
                                    torch.from_numpy(ep['outcome']), FS, BI,
                                    L)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == getattr(torch, str(want[k].dtype)), k
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]),
                                          err_msg='%s seat %d' % (k, seat))


def _moments(ep):
    moments = []
    for t in range(ep['S']):
        m = {key: {q: None for q in range(P)} for key in
             ('observation', 'selected_prob', 'action_mask', 'action',
              'value', 'reward', 'return')}
        m['turn'] = []
        for p in range(P):
            if ep['acting'][t, p]:
                m['turn'].append(p)
                m['observation'][p] = ep['obs'][t, p]
                m['selected_prob'][p] = float(ep['prob'][t, p])
                m['action_mask'][p] = ep['amask'][t, p]
                m['action'][p] = int(ep['action'][t, p])
                m['value'][p] = ep['value'][t, p]
        moments.append(m)
    return moments


def test_windows_match_the_host_batch_builder(monkeypatch):
    args = {'turn_based_training': False, 'observation': True,
            'forward_steps': FS, 'burn_in_steps': BI, 'compress_steps': 3}
    ep = _episode(S=11, seed=4)
    S, cs = ep['S'], args['compress_steps']
    blocks = compress_moments(_moments(ep), cs)
    th = {k: torch.from_numpy(v) for k, v in _hist(ep).items()}
    for seat in range(P):
        monkeypatch.setattr(random, 'choice', lambda seq, s=seat: s)
        for ts in range(1 + max(0, S - FS)):
            st, ed = max(0, ts - BI), min(ts + FS, S)
            sb, eb = st // cs, (ed - 1) // cs + 1
            window = {'args': {}, 'outcome': {q: float(ep['outcome'][q])
                                              for q in range(P)},
                      'moment': blocks[sb:eb], 'base': sb * cs, 'start': st,
                      'end': ed, 'train_start': ts, 'total': S}
            host = make_batch([window], args)
            dev = dw.build_windows_solo(
                th, S, torch.tensor([ts]), torch.tensor([seat]),
                torch.from_numpy(ep['outcome']), FS, BI, L)
            for key in host:
                np.testing.assert_allclose(
                    dev[key].numpy().astype(np.float32),
                    np.asarray(host[key], np.float32), rtol=1e-5, atol=1e-6,
                    err_msg='%s seat %d ts %d' % (key, seat, ts))


def _jax_records(K, N, seed):
    """K plies of N JAX-twin games under random actions, as the rollout
    records them: obs, action, prob, amask, value, acting, done, outcome."""
    rng = np.random.RandomState(seed)
    js = jhg.init_state(N, seed=seed)
    step, reset = jax.jit(jhg.step), jax.jit(jhg.auto_reset)
    observe = jax.jit(jhg.observe)
    plies = []
    for _ in range(K):
        actions = rng.randint(0, 4, (N, 4)).astype(np.int32)
        nxt = step(js, jnp.asarray(actions))
        done = jhg.terminal(nxt)
        plies.append({
            'obs': np.asarray(observe(js)), 'action': actions,
            'prob': rng.uniform(0.1, 1, (N, 4)).astype(np.float32),
            'amask': np.zeros((N, 4, 4), np.float32),
            'value': rng.uniform(-1, 1, (N, 4, 1)).astype(np.float32),
            'acting': np.asarray(jhg.acting(js)), 'done': np.asarray(done),
            'outcome': np.asarray(jhg.outcome(nxt))})
        js = reset(nxt, done)
    return {k: np.stack([p[k] for p in plies]) for k in plies[0]}


def _jax_draws(key, K, N, W):
    """The windower's per-ply draws from its key (device_windows.py:351-370
    in the JAX package): the train starts' uniforms and the seats."""
    us, seats = [], []
    for _ in range(K):
        key, k_ts, k_seat = jax.random.split(key, 3)
        us.append(np.asarray(jax.random.uniform(k_ts, (N, W))))
        seats.append(np.asarray(jax.random.randint(k_seat, (N, W), 0, 4)))
    return {'u': torch.from_numpy(np.stack(us)),
            'seat': torch.from_numpy(np.stack(seats))}


@pytest.mark.parametrize('capacity', [512, 24])
def test_ingest_of_jax_records_fills_the_jax_rows(capacity):
    K, N, W, fs, Lmax = 40, 6, 3, 2, 64
    rec = _jax_records(K, N, seed=2)
    key = jax.random.PRNGKey(9)
    draws = _jax_draws(key, K, N, W)   # before the ingest donates the key
    jwd = jdw.DeviceWindower('solo', fs, 0, Lmax, W, capacity, 4, 0.99,
                             False)
    jrec = {k: jnp.asarray(v) for k, v in rec.items()}
    jstate = jwd.init_state(jrec)
    jring = jwd.init_ring(jrec)
    jstate, jring, jcur, jsize, _, jdone, jwin = jwd.ingest(
        jrec, jstate, jring, jnp.int32(0), jnp.int32(0), key)

    wd = dw.DeviceWindower('solo', fs, 0, Lmax, W, capacity, 4, 0.99, False)
    trec = {k: torch.from_numpy(v) for k, v in rec.items()}
    state = wd.init_state(trec)
    ring = wd.init_ring(trec)
    cursor = torch.zeros((), dtype=torch.int64)
    size = torch.zeros((), dtype=torch.int64)
    n_done, n_win = wd.ingest(trec, state, ring, cursor, size,
                              draws=draws)

    assert int(n_done) == int(jdone) > 10
    assert int(n_win) == int(jwin)
    assert (int(cursor), int(size)) == (int(jcur), int(jsize))
    if capacity < int(n_win):
        assert int(size) == capacity and int(cursor) == int(n_win) % capacity
    assert set(ring) == set(jring)
    for k in jring:
        assert ring[k].shape[0] == capacity + 1   # the spare row
        np.testing.assert_array_equal(ring[k][:capacity].numpy(),
                                      np.asarray(jring[k]), err_msg=k)
    for k in jstate['hist']:
        np.testing.assert_array_equal(state['hist'][k].numpy(),
                                      np.asarray(jstate['hist'][k]),
                                      err_msg=k)
    np.testing.assert_array_equal(state['counts'].numpy(),
                                  np.asarray(jstate['counts']))
    rows = wd.unflatten_rows({k: v[:4] for k, v in ring.items()})
    assert rows['observation'].shape == (4, fs, 1, 17, 7, 11)
    assert rows['action_mask'].shape == (4, fs, 1, 4)


def test_ingest_writes_nothing_but_the_spare_row_without_a_finished_episode():
    K, N = 3, 4
    rec = _jax_records(K, N, seed=5)
    rec['done'][:] = False
    wd = dw.DeviceWindower('solo', 2, 0, 16, 2, 8, 4, 0.99, False)
    trec = {k: torch.from_numpy(v) for k, v in rec.items()}
    state = wd.init_state(trec)
    ring = wd.init_ring(trec)
    cursor = torch.zeros((), dtype=torch.int64)
    size = torch.zeros((), dtype=torch.int64)
    n_done, n_win = wd.ingest(trec, state, ring, cursor, size,
                              generator=torch.Generator().manual_seed(0))
    assert (int(n_done), int(n_win), int(cursor), int(size)) == (0, 0, 0, 0)
    assert state['counts'].tolist() == [K] * N
    assert all(not v[:8].any() for v in ring.values())
    assert ring['observation'][8].any()


def test_windower_refuses_the_turn_layout():
    """The 'turn' layout is ported (tests/test_torch_device_turn.py holds
    it to the JAX package): the windower takes it and refuses only a
    layout it does not know."""
    wd = dw.DeviceWindower('turn', 2, 0, 16, 2, 8, 2, 0.99, False)
    assert wd.mode == 'turn' and 'player' in wd._hist_keys()
    with pytest.raises(ValueError, match="'solo' or 'turn'"):
        dw.DeviceWindower('wide', 2, 0, 16, 2, 8, 2, 0.99, False)


def test_discounted_returns_match_jax():
    rng = np.random.RandomState(0)
    rew = rng.uniform(-1, 1, (12, 3)).astype(np.float32)
    valid = np.arange(12) < 9
    want = jdw._discounted_returns(jnp.asarray(rew), jnp.asarray(valid), 0.9)
    got = dw.discounted_returns(torch.from_numpy(rew),
                                torch.from_numpy(valid), 0.9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_window_keys_flatten_and_unflatten():
    win = {'observation': {'board': np.zeros((2, 3)),
                           'scalar': {'x': np.ones(4)}},
           'value': np.zeros(2)}
    flat = dw.flatten_window_keys(win)
    assert sorted(flat) == sorted(jdw.flatten_window_keys(win))
    back = dw.unflatten_window_keys(flat)
    assert back['observation']['scalar']['x'] is win['observation'][
        'scalar']['x']
    with pytest.raises(ValueError):
        dw.flatten_window_keys({'observation': {'a.b': np.zeros(1)}})
