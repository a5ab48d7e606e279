"""The device actor backend (handyrl_tpu_torch/device_generation.py
``DeviceActorEngine``, handyrl_tpu_torch/worker.py ``DeviceActorGather``,
handyrl_tpu_torch/league.py ``plan_slots``) on the CPU, against the JAX
package's (handyrl_tpu/device_generation.py, worker.py, league.py), after
its tests/test_device_actor.py.

Both engines read the same weights: each vault fetches the flax
``to_bytes`` snapshot the JAX ``ModelWrapper`` seeded 100 + model id
writes (TicTacToe's full-width SimpleConv2dModel; a small GeeseNet,
filters 16 and 2 blocks, whose port copy runs the 'pallas' trunk on its
plain version). Checked, each with its tolerance:

* ``plan_slots``, ``resolve_record_mode`` and ``_u_pick`` equal the JAX
  functions exactly (integers, or the same exception);
* strict TicTacToe: every spliced episode is the port's host
  ``Generator`` record for the task byte for byte (``connection.pack``),
  its actions, steps and outcome equal the JAX engine's exactly and its
  ``selected_prob``/``value`` within 1e-6 (the same float32 softmax of
  logits that two nets sum in other orders);
* slot admission, deferral and the evaluation pool's opponent equal the
  JAX engine's; a new slot -> model id map builds no new chunk program;
* Hungry Geese 'device' records ply by ply against the JAX engine's chunk
  from the same states, draws and weights (obs, amask, acting, live,
  action, done and outcome exactly; prob and value within 1e-5, fp32 sums
  in other orders); spliced episodes carry ``record_version: 1`` and a
  ``Batcher`` builds a batch from them;
* a learner with ``generation.backend: 'device'`` trains TicTacToe from a
  local ``DeviceActorGather`` and from a worker host with
  ``worker_args.backend: 'device'`` over localhost TCP, every episode
  counted once;
* the ``generation`` block's defaults and checks are the JAX package's.
"""

import copy
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.config import TRAIN_DEFAULTS as JAX_TRAIN_DEFAULTS
from handyrl_tpu.config import apply_defaults as jax_apply_defaults
from handyrl_tpu import device_generation as jdg
from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.environment import make_jax_env
from handyrl_tpu.envs import jax_hungry_geese, jax_tictactoe
from handyrl_tpu.inference import ModelVault as JaxModelVault
from handyrl_tpu.league import plan_slots as jax_plan_slots
from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
from handyrl_tpu.models import build as jax_build
from handyrl_tpu_torch import device_generation as dg
from handyrl_tpu_torch.config import (TRAIN_DEFAULTS, ConfigError,
                                      apply_defaults)
from handyrl_tpu_torch.connection import pack
from handyrl_tpu_torch.environment import make_device_env, make_env
from handyrl_tpu_torch.envs import torch_hungry_geese, torch_tictactoe
from handyrl_tpu_torch.evaluation import Evaluator
from handyrl_tpu_torch.generation import Generator
from handyrl_tpu_torch.inference import ModelVault
from handyrl_tpu_torch.league import plan_slots
from handyrl_tpu_torch.ops.batch import decompress_moments, make_batch
from handyrl_tpu_torch.train import Batcher
from handyrl_tpu_torch.worker import resolve_generation_backend


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


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = float(np.finfo(np.float32).tiny)
SEED = 11


def _train_args(env_name, opponents=None):
    """(JAX train args, port train args) of one raw config."""
    train = {'seed': SEED}
    if opponents is not None:
        train['eval'] = {'opponent': list(opponents)}
    raw = {'env_args': {'env': env_name}, 'train_args': train}
    out = []
    for apply in (jax_apply_defaults, apply_defaults):
        cfg = apply(copy.deepcopy(raw))
        ta = dict(cfg['train_args'])
        ta['env'] = cfg['env_args']
        out.append(ta)
    return out


def _jax_net(env_name):
    if env_name == 'HungryGeese':
        return jax_build('GeeseNet', filters=16, layers=2)
    return jax_make_env({'env': env_name}).net()


def _engines(env_name, n_envs=6, chunk_steps=8, slots=2, opponents=None):
    """A JAX engine and a port engine on the same snapshots: (jax engine,
    port engine, port vault, port train args)."""
    jta, pta = _train_args(env_name, opponents)
    jenv = jax_make_env(jta['env'])
    jenv.reset()
    obs0 = jenv.observation(jenv.players()[0])
    snaps = {}

    def jax_fetch(mid):
        if mid not in snaps:
            w = JaxModelWrapper(_jax_net(env_name), seed=100 + int(mid))
            w.ensure_params(obs0)
            snaps[mid] = w.snapshot()
        return snaps[mid]

    def port_fetch(mid):
        snap = dict(jax_fetch(mid))
        if env_name == 'HungryGeese':   # the port's K1 trunk
            snap['config'] = dict(snap.get('config') or {},
                                  torus_impl='pallas')
        return snap

    jvault = JaxModelVault(jax_fetch, obs0, capacity=slots + 2)
    jeng = jdg.DeviceActorEngine(
        make_jax_env(jta['env']), jvault, jax_make_env(jta['env']), jta,
        n_envs=n_envs, chunk_steps=chunk_steps, slots=slots, seed=5)
    penv = make_env(pta['env'])
    penv.reset()
    pvault = ModelVault(port_fetch, penv.observation(penv.players()[0]),
                        capacity=slots + 2, device='cpu')
    peng = dg.DeviceActorEngine(
        make_device_env(pta['env']), pvault, make_env(pta['env']), pta,
        n_envs=n_envs, chunk_steps=chunk_steps, slots=slots, seed=5,
        device='cpu')
    return jeng, peng, pvault, pta


def _g_task(key, mids):
    players = sorted(mids)
    return {'role': 'g', 'player': players, 'model_id': dict(mids),
            'sample_key': key, 'task_id': key}


def _e_task(key, seat, mid, players=2, opponent=None):
    task = {'role': 'e', 'player': [seat],
            'model_id': {p: (mid if p == seat else -1)
                         for p in range(players)},
            'sample_key': key, 'task_id': 1000 + key}
    if opponent is not None:
        task['opponent'] = opponent
    return task


@pytest.fixture(scope='module')
def ttt():
    return _engines('TicTacToe')


# -- units ----------------------------------------------------------------

@pytest.mark.timeout(60)
@pytest.mark.parametrize('seed,slots', [(0, 1), (1, 2), (2, 2), (3, 3),
                                        (4, 4)])
def test_plan_slots_equals_the_jax_function(seed, slots):
    """Exact: the same mid -> slot map and verdicts on seeded blocks of
    mid lists (ids -1 to 5, some repeated, some below 1)."""
    rng = np.random.default_rng(seed)
    for _ in range(20):
        block = [[int(m) for m in rng.integers(-1, 6, rng.integers(0, 5))]
                 for _ in range(rng.integers(1, 12))]
        assert plan_slots(block, slots) == jax_plan_slots(block, slots)


@pytest.mark.timeout(60)
@pytest.mark.parametrize('requested', ['', 'strict', 'device'])
@pytest.mark.parametrize('recurrent', [False, True])
@pytest.mark.parametrize('twins', [(torch_tictactoe, jax_tictactoe),
                                   (torch_hungry_geese, jax_hungry_geese)],
                         ids=['TicTacToe', 'HungryGeese'])
def test_resolve_record_mode_equals_the_jax_function(twins, recurrent,
                                                     requested):
    """The same mode, or a ValueError where the JAX function raises."""
    port_twin, jax_twin = twins
    try:
        want = jdg.resolve_record_mode(jax_twin, recurrent, requested)
    except ValueError:
        with pytest.raises(ValueError, match='strict'):
            dg.resolve_record_mode(port_twin, recurrent, requested)
        return
    assert dg.resolve_record_mode(port_twin, recurrent, requested) == want


@pytest.mark.timeout(60)
@pytest.mark.parametrize('u_kind', ['uniform', 'near_0', 'near_1'])
def test_u_pick_equals_the_jax_function(u_kind):
    """Exact int actions on seeded weights and legal masks (some rows with
    one legal action, some all-zero weight rows), u uniform, just above 0
    or just below 1."""
    rng = np.random.default_rng({'uniform': 1, 'near_0': 2,
                                 'near_1': 3}[u_kind])
    n, a = 256, 9
    weights = rng.random((n, a)).astype(np.float32)
    weights[rng.random(n) < 0.1] = 0.0
    legal = (rng.random((n, a)) < 0.6).astype(np.float32)
    legal[np.arange(n), rng.integers(0, a, n)] = 1.0
    legal[:8] = 0.0
    legal[np.arange(8), np.arange(8)] = 1.0
    if u_kind == 'uniform':
        u = rng.random(n).astype(np.float32)
    elif u_kind == 'near_0':
        u = (rng.random(n) * 1e-6).astype(np.float32)
    else:
        u = (1.0 - rng.random(n) * 1e-7).astype(np.float32)
    got = dg._u_pick(torch.from_numpy(weights), torch.from_numpy(legal),
                     torch.from_numpy(u)).numpy()
    want = np.asarray(jdg._u_pick(jnp.asarray(weights), jnp.asarray(legal),
                                  jnp.asarray(u)))
    np.testing.assert_array_equal(got, want)
    assert legal[np.arange(n), got].all()


# -- strict records (TicTacToe) ------------------------------------------

def _moments_close(got, want, tol):
    gm, wm = decompress_moments(got['moment']), decompress_moments(
        want['moment'])
    assert len(gm) == len(wm) == got['steps'] == want['steps']
    for a, b in zip(gm, wm):
        assert a['turn'] == b['turn']
        for p in a['turn']:
            assert a['action'][p] == b['action'][p]
            np.testing.assert_allclose(a['selected_prob'][p],
                                       b['selected_prob'][p], rtol=0,
                                       atol=tol)
            np.testing.assert_allclose(np.asarray(a['value'][p]),
                                       np.asarray(b['value'][p]), rtol=0,
                                       atol=tol)


@pytest.mark.timeout(120)
def test_strict_episodes_are_the_host_generators_records(ttt):
    jeng, peng, pvault, pta = ttt
    assert peng.record_mode == jeng.record_mode == 'strict'
    tasks = ([_g_task(k, {0: 1, 1: 1}) for k in range(4)]
             + [_g_task(4, {0: 1, 1: 2}), _g_task(5, {0: 0, 1: 2})])
    uploads, deferred = peng.run_block(copy.deepcopy(tasks))
    juploads, jdeferred = jeng.run_block(copy.deepcopy(tasks))
    assert deferred == jdeferred == []
    gen = Generator(make_env(pta['env']), pta)
    for task, (kind, got), (_, want) in zip(tasks, uploads, juploads):
        assert kind == 'episode' and got is not None
        host = gen.execute(pvault.obtain(dict(task['model_id'])), task)
        assert pack(got) == pack(host), task
        assert 'record_version' not in got
        assert got['outcome'] == want['outcome']
        _moments_close(got, want, 1e-6)
    st = peng.stats
    assert st['episodes'] + st['divergences'] == len(tasks)
    assert st['none_payloads'] == 0


@pytest.mark.timeout(120)
def test_slot_pairing_and_overflow_as_the_jax_engine(ttt):
    jeng, peng, pvault, _ = ttt
    # a cross-model pairing plays in one lane
    blocks = [[_g_task(7, {0: 1, 1: 2})],
              # three distinct ids into two slots: the third task defers
              [_g_task(0, {0: 1, 1: 1}), _g_task(1, {0: 2, 1: 2}),
               _g_task(2, {0: 3, 1: 1})]]
    for tasks in blocks:
        uploads, deferred = peng.run_block(copy.deepcopy(tasks))
        juploads, jdeferred = jeng.run_block(copy.deepcopy(tasks))
        assert [t['task_id'] for t in deferred] == [
            t['task_id'] for t in jdeferred]
        assert [k for k, _ in uploads] == [k for k, _ in juploads]
        assert all(p is not None for _, p in uploads)
    assert [t['task_id'] for t in deferred] == [2]
    # a new slot -> model id map is a params upload: no new chunk program
    builds = peng.builds
    uploads, deferred = peng.run_block([_g_task(8, {0: 3, 1: 4})])
    assert not deferred and uploads[0][1] is not None
    assert peng.builds == builds == 1 and peng.captures == 0
    assert peng._stack_key == (3, 4)
    for net, mid in zip(peng._nets, (3, 4)):
        src = pvault.model(mid).module.state_dict()
        for name, value in net.state_dict().items():
            assert torch.equal(value, src[name]), (mid, name)


@pytest.mark.timeout(120)
def test_eval_tasks_draw_the_jax_engines_opponent():
    """Keyed evaluation tasks without an opponent: the namespace-2 pool
    draw names the same opponent in both engines and in the port's host
    Evaluator; 'rulebase' (no TicTacToe twin heuristic) defers in both,
    'random' plays with equal results."""
    opponents = ['random', 'rulebase']
    jeng, peng, _, pta = _engines('TicTacToe', n_envs=12,
                                  opponents=opponents)
    tasks = [_e_task(k, k % 2, 1) for k in range(12)]
    uploads, deferred = peng.run_block(copy.deepcopy(tasks))
    juploads, jdeferred = jeng.run_block(copy.deepcopy(tasks))
    assert [t['task_id'] for t in deferred] == [
        t['task_id'] for t in jdeferred]
    assert uploads == juploads
    assert 0 < len(uploads) < len(tasks)
    evaluator = Evaluator(make_env(pta['env']), pta, device='cpu')
    served = {p['args']['task_id']: p['opponent'] for _, p in uploads}
    for task in tasks:
        drawn = evaluator._draw_opponent(opponents, task)
        assert served.get(task['task_id'], 'rulebase') == drawn
    # a re-issue plays the same match
    again, _ = peng.run_block(copy.deepcopy(tasks))
    assert again == uploads


@pytest.mark.timeout(60)
@pytest.mark.parametrize('case', ['checkpoint', 'strict_without_key',
                                  'unknown_role', 'negative_mid', 'idle'])
def test_unservable_tasks_defer_as_in_the_jax_engine(ttt, case):
    jeng, peng, _, _ = ttt
    task = {
        'checkpoint': _e_task(3, 0, 1, opponent='models/3.ckpt'),
        'strict_without_key': {'role': 'g', 'player': [0, 1],
                               'model_id': {0: 1, 1: 1}, 'task_id': 5},
        'unknown_role': {'role': 'x', 'player': [0],
                         'model_id': {0: 1, 1: 1}, 'task_id': 6},
        'negative_mid': _g_task(0, {0: 1, 1: -5}),
        'idle': {'role': 'idle', 'wait': 1.0},
    }[case]
    uploads, deferred = peng.run_block([dict(task)])
    juploads, jdeferred = jeng.run_block([dict(task)])
    assert uploads == juploads == []
    assert deferred == jdeferred == ([] if case == 'idle' else [task])


# -- 'device' records (Hungry Geese) ---------------------------------------

N_GEESE = 6


@pytest.mark.timeout(240)
def test_geese_device_chunk_matches_jax_ply_by_ply(monkeypatch):
    """Both engines' chunk (one ply a chunk) from the same state, live
    lanes and ply counts before each ply, with the port's draws the
    uniforms the JAX key splits give (jax.random.categorical is
    argmax(logits - log(-log(u))) with u from uniform(key, minval=tiny);
    the rulebase fallback's randint fed as the centre of its quarter of
    [0, 1)), over lanes of self-play, a cross pairing and evaluation
    against 'random' and 'rulebase'."""
    jeng, peng, _, _ = _engines('HungryGeese', n_envs=N_GEESE,
                                chunk_steps=1)
    assert peng.record_mode == jeng.record_mode == 'device'
    tasks = [_g_task(0, {p: 1 for p in range(4)}),
             _g_task(1, {0: 1, 1: 2, 2: 1, 3: 2}),
             _g_task(2, {0: 2, 1: 0, 2: 2, 3: 0}),
             _e_task(3, 1, 1, players=4, opponent='random'),
             _e_task(4, 2, 2, players=4, opponent='rulebase')]
    plan = [peng._classify(t) for t in tasks]
    for cls, task in zip(plan, tasks):
        want = jeng._classify(task)
        assert (cls['modes'], cls['mids'], cls['slot_mids']) == (
            want['modes'], want['mids'], want['slot_mids'])
    assign, admitted = plan_slots([c['slot_mids'] for c in plan], 2)
    assert all(admitted) and assign == {1: 0, 2: 1}
    peng._build(peng.vault.model(1))
    peng._stack_params(assign)
    peng._load_block(plan, assign)
    jeng._build(jeng.vault.model(1))
    stacked = jeng._stack_params(assign)
    slot_d = jnp.asarray(peng._slot.numpy().astype(np.int32))
    mode_d = jnp.asarray(peng._mode.numpy().astype(np.int32))
    u_d = jnp.zeros((N_GEESE, 1), jnp.float32)

    real_gumbel, real_greedy = dg.gumbel_argmax, torch_hungry_geese.\
        greedy_action
    draws = []
    monkeypatch.setattr(dg, 'gumbel_argmax',
                        lambda logits, u: real_gumbel(logits, draws.pop(0)))
    monkeypatch.setattr(torch_hungry_geese, 'greedy_action',
                        lambda state, u=None, generator=None:
                        real_greedy(state, u=draws.pop(0)))

    js = jax_hungry_geese.init_state(N_GEESE, seed=3)
    live = jnp.asarray(np.arange(N_GEESE) < len(tasks))
    t = jnp.zeros((N_GEESE,), jnp.int32)
    rng = jax.random.PRNGKey(9)
    finished = 0
    for ply in range(200):
        _, k1, k2, k3 = jax.random.split(rng, 4)
        draws[:] = [torch.from_numpy(np.array(jax.random.uniform(
            k, (N_GEESE, 4, 4), minval=TINY, maxval=1.0))) for k in (k1, k2)]
        fb = np.asarray(jax.random.randint(k3, (N_GEESE, 4), 0, 4,
                                           jnp.int32))
        draws.append(torch.from_numpy(((fb + 0.5) / 4).astype(np.float32)))
        dg.copy_state_(peng.state, torch_hungry_geese.State(*[
            torch.from_numpy(np.array(getattr(js, f)))
            for f in torch_hungry_geese.State._fields]))
        peng._live.copy_(torch.from_numpy(np.array(live)))
        peng._t.copy_(torch.from_numpy(np.array(t)).long())
        packed = peng._call()
        rec = peng._pack.unpack(packed.numpy())
        assert not draws
        js, _, live, t, rng, jrec = jeng._rollout(
            stacked, js, None, u_d, slot_d, mode_d, live, t, rng)
        for k in ('obs', 'amask', 'acting', 'live', 'action', 'done',
                  'outcome'):
            np.testing.assert_array_equal(
                rec[k], np.asarray(jrec[k]).astype(rec[k].dtype),
                err_msg='%s ply %d' % (k, ply))
        for k in ('prob', 'value'):
            np.testing.assert_allclose(rec[k], np.asarray(jrec[k]), rtol=0,
                                       atol=1e-5,
                                       err_msg='%s ply %d' % (k, ply))
        finished += int(rec['done'].sum())
        if not np.asarray(live).any():
            break
    assert finished == len(tasks)


@pytest.mark.timeout(240)
def test_geese_device_episodes_are_stamped_and_batch():
    jeng, peng, _, pta = _engines('HungryGeese', n_envs=4, chunk_steps=16)
    tasks = [_g_task(k, {p: 1 for p in range(4)}) for k in range(3)]
    tasks.append(_e_task(3, 0, 1, players=4, opponent='rulebase'))
    uploads, deferred = peng.run_block(tasks)
    assert not deferred and peng.captures == 0 and peng.builds == 1
    assert [k for k, _ in uploads] == ['episode'] * 3 + ['result']
    episodes = [p for k, p in uploads if k == 'episode']
    for ep in episodes:
        assert ep['record_version'] == 1
        moments = decompress_moments(ep['moment'])
        assert len(moments) == ep['steps'] > 0
        assert set(ep['outcome']) == {0, 1, 2, 3}
        assert abs(sum(ep['outcome'].values())) < 1e-6
    result = uploads[-1][1]
    assert result['opponent'] == 'rulebase' and set(result['result']) == {
        0, 1, 2, 3}
    st = peng.stats
    assert (st['episodes'], st['results'], st['none_payloads']) == (3, 1, 0)
    assert 0 < peng.last_block['fill_ratio'] <= 1
    args = dict(pta, turn_based_training=False, observation=True,
                forward_steps=4, batch_size=4)
    batcher = Batcher(args, episodes)
    batch = make_batch(batcher._select(), args)
    assert batch['observation'].shape[:2] == (4, 4)
    assert batch['observation'].shape[-3:] == (17, 7, 11)
    assert all(np.isfinite(v).all() for v in batch.values()
               if isinstance(v, np.ndarray))


# -- the learner with the backend -----------------------------------------

QUICK = {'batch_size': 16, 'forward_steps': 8, 'num_batchers': 1,
         'minimum_episodes': 40, 'update_episodes': 30, 'epochs': 2,
         'batched_generation': False,
         'generation': {'backend': 'device', 'device_actor_envs': 16,
                        'device_actor_chunk_steps': 4}}


def free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(('', 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


@pytest.mark.timeout(300)
@pytest.mark.parametrize('plane', ['local', 'server'])
def test_learner_trains_from_the_device_actor_backend(tmp_path, plane):
    """TicTacToe, 2 epochs: a local ``DeviceActorGather`` (the train
    config's ``generation.backend``), or ``--server`` with a worker host
    whose ``worker_args.backend`` is 'device' (the train config names
    none). Both exit 0; every episode is counted once; the gather's
    beacon carries the engine's counts: its lanes played episodes and
    results, the epoch-0 tasks (model id 0 everywhere) went to the host
    fallback, no lane uploaded None, one chunk program was built."""
    train = dict(QUICK, model_dir=str(tmp_path / 'models'))
    config = {'env_args': {'env': 'TicTacToe'}, 'train_args': train}
    env = dict(os.environ, OMP_NUM_THREADS='1')
    cmd = [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config',
           str(tmp_path / 'config.json'), '--device', 'cpu']
    if plane == 'local':
        (tmp_path / 'config.json').write_text(json.dumps(config))
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=240, env=env)
        assert proc.returncode == 0, proc.stderr[-3000:]
        out = proc.stdout
    else:
        train['generation'] = {'device_actor_envs': 16,
                               'device_actor_chunk_steps': 4}
        config['worker_args'] = {'server_address': '127.0.0.1',
                                 'num_parallel': 1, 'backend': 'device'}
        (tmp_path / 'config.json').write_text(json.dumps(config))
        ports = free_ports(2)
        env.update(HANDYRL_TPU_ENTRY_PORT=str(ports[0]),
                   HANDYRL_TPU_DATA_PORT=str(ports[1]))
        server = subprocess.Popen(cmd + ['--server'], cwd=REPO,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True, env=env)
        try:
            host = subprocess.run(
                [sys.executable, '-m', 'handyrl_tpu_torch.worker',
                 '--config', str(tmp_path / 'config.json'), '--device',
                 'cpu'], cwd=REPO, capture_output=True, text=True,
                timeout=240, env=env)
            out, err = server.communicate(timeout=120)
        finally:
            if server.poll() is None:
                server.kill()
                server.wait()
        assert host.returncode == 0, host.stderr[-3000:]
        assert server.returncode == 0, err[-3000:]
        assert 'device actor backend on cpu' in host.stderr
    line = json.loads([l for l in out.splitlines() if l.startswith('{')][-1])
    assert line['epochs'] == 2 and not line['failed']
    assert line['generation'] == ('workers' if plane == 'local'
                                  else 'server')
    assert line['repeated_sample_keys'] == 0
    assert line['distinct_sample_keys'] == line['episodes'] >= 70
    assert line['fleet']['outstanding'] == 0
    assert line['stamped_episodes'] == 0          # strict TicTacToe records
    (actor,) = line['device_actor']
    assert actor['record_mode'] == 'strict' and actor['device'] == 'cpu'
    assert actor['episodes'] + actor['divergences'] > 0
    assert actor['results'] > 0 and actor['deferred'] > 0
    assert actor['none_payloads'] == 0 and actor['host_failures'] == 0
    assert actor['builds'] == 1 and actor['graph_captures'] == 0
    assert 0 < actor['fill_ratio'] <= 1
    assert (tmp_path / 'models' / '2.ckpt').exists()


@pytest.mark.timeout(60)
@pytest.mark.parametrize('train_args', [
    {'device_generation': True, 'batched_generation': False},
    {'device_generation': True, 'device_replay': True,
     'fused_pipeline': False, 'batched_generation': False},
    {'device_generation': True, 'device_replay': True,
     'generation': {'backend': 'device'}},
])
def test_device_generation_on_the_worker_plane_is_read_as_the_jax_learner(
        train_args):
    """The configs the port refused before it had the backend validate in
    both packages; the port's learner on the worker plane turns
    ``device_generation`` off and builds its worker cluster (the JAX
    learner reads ``device_generation`` in its batched loop only,
    handyrl_tpu/train.py:2551), or runs the fused loop when batched."""
    from handyrl_tpu_torch.train import Learner
    from handyrl_tpu_torch.worker import WorkerCluster
    from handyrl_tpu_torch.models.tictactoe import SimpleConv2dModel
    raw = {'env_args': {'env': 'TicTacToe'}, 'train_args': train_args}
    jax_apply_defaults(copy.deepcopy(raw))
    learner = Learner(apply_defaults(copy.deepcopy(raw)),
                      net=SimpleConv2dModel(), device='cpu')
    try:
        worker_plane = not learner.use_batched_generation
        assert worker_plane == (train_args.get('batched_generation')
                                is False)
        assert isinstance(learner.worker, WorkerCluster) == worker_plane
        assert learner.args['device_generation'] is (not worker_plane)
        assert resolve_generation_backend(learner.args) == (
            train_args.get('generation', {}).get('backend') or 'worker')
    finally:
        learner.shutdown()


# -- the generation block --------------------------------------------------

@pytest.mark.timeout(60)
def test_generation_defaults_are_the_jax_packages():
    assert TRAIN_DEFAULTS['generation'] == JAX_TRAIN_DEFAULTS['generation']
    assert list(TRAIN_DEFAULTS['generation']) == list(
        JAX_TRAIN_DEFAULTS['generation'])
    args = apply_defaults({'env_args': {'env': 'HungryGeese'},
                           'train_args': {'generation': {
                               'backend': 'device'}}})
    assert args['train_args']['generation'] == dict(
        JAX_TRAIN_DEFAULTS['generation'], backend='device')


@pytest.mark.timeout(60)
@pytest.mark.parametrize('block,value,key', [
    ('generation', {'backend': 'gpu'}, 'generation.backend'),
    ('generation', {'device_actor_envs': 0}, 'device_actor_envs'),
    ('generation', {'device_actor_chunk_steps': 0},
     'device_actor_chunk_steps'),
    ('generation', {'device_actor_slots': 0}, 'device_actor_slots'),
    ('generation', {'device_actor_record': 'exact'}, 'device_actor_record'),
    ('worker_args', {'backend': 'gpu'}, 'worker_args.backend'),
])
def test_generation_checks_are_the_jax_packages(block, value, key):
    """Each value the JAX config asserts on raises a ConfigError naming
    the key (the JAX package an AssertionError)."""
    raw = {'env_args': {'env': 'TicTacToe'}}
    if block == 'generation':
        raw['train_args'] = {'generation': value}
    else:
        raw['worker_args'] = value
    with pytest.raises(AssertionError):
        jax_apply_defaults(copy.deepcopy(raw))
    with pytest.raises(ConfigError, match=key):
        apply_defaults(copy.deepcopy(raw))
