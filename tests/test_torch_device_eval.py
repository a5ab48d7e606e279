"""The device evaluator (handyrl_tpu_torch/device_generation.py
``DeviceEvaluator``) on the CPU, against 'random' and 'rulebase'
opponents, and the self-play ply it shares its inference with
(``make_gen_body``).

A small GeeseNet (filters 16, 2 blocks, 'pallas' trunk on its plain
version). Checked: result records in the shape ``Learner.feed_results``
takes from the host evaluator; one seat per env, rotating by one on every
finished match; the opponent of each env block; many plies and finished
matches from one dispatch, read after the next dispatch is enqueued; the rulebase seats
play the env twin's GreedyAgent; and the self-play records' shapes, the
Gumbel-max draw's distribution (within 4 standard errors of the softmax
over 20000 draws) and that the recorded probability is the softmax's at
the drawn action (rtol 1e-6: the same float32 softmax).

Against the JAX package (``handyrl_tpu/device_generation.py``), ply by ply
from the same states and draws with the same weights (``params_from_flax``):
the self-play ply's records (obs, amask, acting, action, done and outcome
exactly; prob and value within 1e-5 abs) and the evaluator's packed (done,
seat, outcome) rows, rotated seats and result records (exactly), with every
state field but the food equal exactly in the envs that did not reset;
also with a checkpoint opponent, whose own net plays its env block on the
device.
"""

import os

import numpy as np
import pytest
import torch

from handyrl_tpu_torch import device_generation as dg
from handyrl_tpu_torch.envs import torch_hungry_geese as tg
from handyrl_tpu_torch.models.geese import GeeseNet

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


def _net():
    return GeeseNet(filters=16, layers=2, torus_impl='pallas',
                    generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize('opponents', [['random'], ['rulebase'],
                                       ['random', 'rulebase']])
def test_device_evaluator_results(opponents):
    ev = dg.DeviceEvaluator(tg, _net(), {}, n_envs=8, chunk_steps=48,
                            seed=3, opponents=opponents)
    # a step enqueues the next dispatch before it reads the previous one: the
    # first step enqueues two and reads the first
    results = ev.step()
    assert ev.dispatches == 2
    results += ev.step()
    assert ev.dispatches == 3
    results += ev.drain()
    assert ev.dispatches == 3 and ev.drain() == []
    assert len(results) >= 8
    by_env_opp = {name for name in ev._env_opp}
    assert by_env_opp == set(opponents)
    for r in results:
        assert r['args']['role'] == 'e'
        (seat,) = r['args']['player']
        assert r['args']['model_id'] == {q: 0 if q == seat else -1
                                         for q in range(4)}
        assert r['opponent'] in opponents
        assert set(r['result']) == {0, 1, 2, 3}
        assert sum(r['result'].values()) == pytest.approx(0.0, abs=1e-6)
        assert all(-1 <= v <= 1 for v in r['result'].values())
    seats = [r['args']['player'][0] for r in results]
    assert len(set(seats)) > 1


def test_seats_rotate_on_every_finished_match():
    ev = dg.DeviceEvaluator(tg, _net(), {}, n_envs=4, chunk_steps=40,
                            seed=5, opponents=['random'])
    start = ev.seat.clone()
    assert start.tolist() == [0, 1, 2, 3]
    finished = [0] * 4
    flat = None
    for _ in range(3):
        flat = ev._rollout()
        per = flat.reshape(ev.chunk_steps, -1)
        done = per[:, :4] > 0.5
        seats = per[:, 4:8].long()
        for i in range(4):
            for k in range(ev.chunk_steps):
                # the seat of a ply is the env's start seat plus its
                # finished matches so far
                assert int(seats[k, i]) == (int(start[i]) + finished[i]) % 4
                finished[i] += int(done[k, i])
    assert sum(finished) >= 4
    assert ev.seat.tolist() == [(int(s) + f) % 4
                                for s, f in zip(start, finished)]


def test_rulebase_block_plays_the_greedy_agent(monkeypatch):
    calls = []
    real = tg.greedy_action

    def spy(state, u=None, generator=None):
        out = real(state, u=u, generator=generator)
        calls.append((state, out))
        return out
    monkeypatch.setattr(tg, 'greedy_action', spy)
    ev = dg.DeviceEvaluator(tg, _net(), {}, n_envs=4, chunk_steps=3, seed=1,
                            opponents=['random', 'rulebase'])
    seen = []
    real_step = tg.step

    def step_spy(state, actions, u=None, generator=None):
        seen.append(actions.clone())
        return real_step(state, actions, u=u, generator=generator)
    monkeypatch.setattr(tg, 'step', step_spy)
    ev._rollout()
    assert len(calls) == len(seen) == 3
    for (_, greedy), acts in zip(calls, seen):
        for i in (2, 3):          # the rulebase block: all but the model seat
            assert int((acts[i] == greedy[i].long()).sum()) >= 3


def test_device_evaluator_refuses_checkpoint_opponents():
    """A checkpoint opponent plays on the device when its file exists;
    a path that names no file is refused."""
    with pytest.raises(ValueError, match='random, rulebase and checkpoint'):
        dg.DeviceEvaluator(tg, _net(), {}, n_envs=4, chunk_steps=2,
                           opponents=['models/1.ckpt'])


def test_gen_body_records_and_draws():
    net = _net()
    rollout = dg.make_gen_body(tg, net)
    gen = torch.Generator().manual_seed(2)
    state = tg.init_state(6, generator=gen)
    state, rec, _ = rollout(state, 5, gen)
    assert rec['obs'].shape == (5, 6, 4, 17, 7, 11)
    assert rec['action'].shape == rec['prob'].shape == (5, 6, 4)
    assert rec['action'].dtype == torch.int32
    assert rec['amask'].shape == (5, 6, 4, 4) and not rec['amask'].any()
    assert rec['value'].shape == (5, 6, 4, 1)
    assert rec['acting'].dtype == torch.bool and rec['done'].shape == (5, 6)
    assert rec['outcome'].shape == (5, 6, 4)
    # the recorded probability is the softmax's at the drawn action
    with torch.no_grad():
        logits = net(rec['obs'].reshape(-1, 17, 7, 11))['policy']
    probs = torch.softmax(logits, -1).reshape(5, 6, 4, 4)
    want = torch.gather(probs, -1, rec['action'].long()[..., None])[..., 0]
    np.testing.assert_allclose(rec['prob'].numpy(), want.numpy(), rtol=1e-6)


def test_gumbel_argmax_draws_the_softmax():
    logits = torch.tensor([[1.0, 0.0, -1.0, 2.0]]).repeat(20000, 1)
    u = torch.rand(logits.shape, generator=torch.Generator().manual_seed(4))
    counts = torch.bincount(dg.gumbel_argmax(logits, u), minlength=4).float()
    p = torch.softmax(logits[0], -1)
    se = (p * (1 - p) / 20000).sqrt()
    assert ((counts / 20000 - p).abs() < 4 * se).all()


# ------------------------------------------------ against the JAX package
#
# Both packages' ply bodies from the same states, ply by ply: before each
# ply the port takes the JAX state (food respawns and fresh boards come
# from each package's own generator, so the states would part at the first
# eaten food), and the port's draws are the uniforms that the JAX key splits
# give (jax.random.categorical is argmax(logits - log(-log(u))) with u from
# jax.random.uniform(key, minval=tiny); the rulebase fallback's randint is
# fed to the port as the centre of its quarter of [0, 1)).

TINY = float(np.finfo(np.float32).tiny)
N_JAX = 6


def _jax_pair(seed=0):
    """A JAX GeeseNet (its params) and the port's net with the same
    weights."""
    from handyrl_tpu.models import build as jax_build
    from handyrl_tpu_torch.models.geese import params_from_flax
    import jax
    import jax.numpy as jnp
    jm = jax_build('GeeseNet', filters=16, layers=2)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 17, 7, 11), jnp.float32), None)
    net = _net()
    net.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, net


def _to_port(js) -> tg.State:
    return tg.State(*[torch.from_numpy(np.array(getattr(js, f)))
                      for f in tg.State._fields])


def _live_fields_equal(port_next, jax_next, live, ply):
    """Every state field but the food equal exactly in the envs that did not
    reset (where JAX's returned state is its post-step state)."""
    for f in ('cells', 'length', 'alive', 'last_action', 'prev_heads',
              'steps', 'scores'):
        np.testing.assert_array_equal(
            getattr(port_next, f).numpy()[live],
            np.asarray(getattr(jax_next, f))[live],
            err_msg='%s ply %d' % (f, ply))


def test_gen_body_matches_jax_ply_by_ply(monkeypatch):
    """obs, amask, acting, action, done and outcome equal exactly, prob and
    value within 1e-5 (the two nets' float32 sums differ in order)."""
    import jax
    import jax.numpy as jnp
    from handyrl_tpu import device_generation as jdg
    from handyrl_tpu.envs import jax_hungry_geese as jhg
    jm, params, net = _jax_pair()
    jroll = jax.jit(jdg.make_gen_body(jhg, jm.apply, False, True),
                    static_argnums=4)
    rollout = dg.make_gen_body(tg, net)
    real_gumbel, real_step = dg.gumbel_argmax, tg.step
    cur, stepped = {}, []
    monkeypatch.setattr(dg, 'gumbel_argmax',
                        lambda logits, u: real_gumbel(logits, cur['u']))

    def step_spy(state, actions, u=None, generator=None):
        stepped.append(real_step(state, actions, u=u, generator=generator))
        return stepped[-1]
    monkeypatch.setattr(tg, 'step', step_spy)

    js, rng = jhg.init_state(N_JAX, seed=4), jax.random.PRNGKey(8)
    gen = torch.Generator().manual_seed(1)
    dones = 0
    for ply in range(60):
        _, key = jax.random.split(rng)
        cur['u'] = torch.from_numpy(np.array(jax.random.uniform(
            key, (N_JAX, 4, 4), minval=TINY, maxval=1.0)))
        _, rec, _ = rollout(_to_port(js), 1, gen)
        js, _, rng, jrec = jroll(params, js, None, rng, 1)
        for k in ('obs', 'amask', 'acting', 'action', 'done', 'outcome'):
            np.testing.assert_array_equal(rec[k].numpy(),
                                          np.asarray(jrec[k]),
                                          err_msg='%s ply %d' % (k, ply))
        for k in ('prob', 'value'):
            np.testing.assert_allclose(rec[k].numpy(), np.asarray(jrec[k]),
                                       rtol=0, atol=1e-5,
                                       err_msg='%s ply %d' % (k, ply))
        done = rec['done'].numpy()[0]
        _live_fields_equal(stepped[-1], js, ~done, ply)
        dones += int(done.sum())
    assert dones >= 3


@pytest.mark.parametrize('opponents', [['random'], ['random', 'rulebase'],
                                       ['random', 'checkpoint']])
def test_device_evaluator_matches_jax_ply_by_ply(monkeypatch, tmp_path,
                                                 opponents):
    """The packed (done, seat, outcome) rows, the seats after the ply, the
    result records and every live state field equal exactly. A checkpoint
    opponent (other weights, written with flax's ``to_bytes`` and read by
    both evaluators) plays its greedy policy in its env block."""
    import jax
    import jax.numpy as jnp
    from flax import serialization
    from handyrl_tpu import device_generation as jdg
    from handyrl_tpu.envs import jax_hungry_geese as jhg
    from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
    jm, params, net = _jax_pair(seed=2)
    if 'checkpoint' in opponents:
        _, opp_params, _ = _jax_pair(seed=9)
        path = tmp_path / '3.ckpt'
        path.write_bytes(serialization.to_bytes(opp_params))
        opponents = [str(path) if o == 'checkpoint' else o
                     for o in opponents]
    jev = jdg.DeviceEvaluator(jhg, JaxModelWrapper(jm, params), {},
                              n_envs=N_JAX, chunk_steps=1, seed=6,
                              opponents=opponents)
    ev = dg.DeviceEvaluator(tg, net, {}, n_envs=N_JAX, chunk_steps=1,
                            seed=6, opponents=opponents)
    assert list(ev._env_opp) == list(jev._env_opp)
    rulebase = 'rulebase' in opponents
    real_gumbel, real_greedy, real_step = (dg.gumbel_argmax,
                                           tg.greedy_action, tg.step)
    cur, stepped = {}, []
    monkeypatch.setattr(dg, 'gumbel_argmax',
                        lambda logits, u: real_gumbel(logits, cur['u']))
    monkeypatch.setattr(tg, 'greedy_action',
                        lambda state, u=None, generator=None:
                        real_greedy(state, u=cur['fallback']))

    def step_spy(state, actions, u=None, generator=None):
        stepped.append(real_step(state, actions, u=u, generator=generator))
        return stepped[-1]
    monkeypatch.setattr(tg, 'step', step_spy)

    results = 0
    for ply in range(60):
        r1, key = jax.random.split(jev.rng)
        cur['u'] = torch.from_numpy(np.array(jax.random.uniform(
            key, (N_JAX, 4, 4), minval=TINY, maxval=1.0)))
        if rulebase:
            _, rkey = jax.random.split(r1)
            fb = np.asarray(jax.random.randint(rkey, (N_JAX, 4), 0, 4,
                                               jnp.int32))
            cur['fallback'] = torch.from_numpy(
                ((fb + 0.5) / 4).astype(np.float32))
        dg.copy_state_(ev.state, _to_port(jev.state))
        ev.seat.copy_(torch.from_numpy(np.array(jev.seat)).long())
        packed = ev._rollout().numpy()
        (jev.state, jev.hidden, jev.opp_hidden, jev.seat, jev.rng,
         jrec) = jev._rollout(params, tuple(jev._opp_params), jev.state,
                              None, None, jev.seat, jev.rng)
        jrec = {k: np.asarray(v) for k, v in jrec.items()}
        want = np.concatenate([jrec['done'].reshape(-1).astype(np.float32),
                               jrec['seat'].reshape(-1).astype(np.float32),
                               jrec['outcome'].reshape(-1)])
        np.testing.assert_array_equal(packed, want, err_msg='ply %d' % ply)
        np.testing.assert_array_equal(ev.seat.numpy(), np.asarray(jev.seat))
        got = ev._collect(packed)
        assert got == jev._collect(jrec), ply
        results += len(got)
        _live_fields_equal(stepped[-1], jev.state, ~jrec['done'][0], ply)
    assert results >= 3
