"""ConnectX in the port: the host env (handyrl_tpu_torch/envs/kaggle/
connectx.py), its tensor twin (envs/torch_connectx.py) and ConnectFourNet
(models/connect_four.py), against the JAX package's (handyrl_tpu/envs/
kaggle/connectx.py, envs/jax_connectx.py, models/connect_four.py), and
ConnectX on the paths the port has.

Tolerances:
- the host env and the twin are exact: the same moves give equal
  observations, legal actions, turns, outcomes, strings, mirror updates,
  state leaves (values and dtypes), heuristic moves and resets;
- the net's forward, params carried from a flax init perturbed so no norm
  is the identity, within 1e-5 absolute at full width: fp32 convs and
  GroupNorm statistics summed in other orders (a few 1e-6 seen);
- the param round trip and the checkpoint bytes are exact;
- the device actor's strict records are the host Generator's byte for
  byte, and its actions and outcomes the JAX engine's exactly;
- the learners (host, fused 'turn' loop) and the tournament are run end
  to end on tiny configs: they finish, with the counts they print."""

import copy
import json
import os
import random
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu import device_generation as jdg
from handyrl_tpu.config import apply_defaults as jax_apply_defaults
from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.environment import make_jax_env
from handyrl_tpu.envs import jax_connectx
from handyrl_tpu.inference import ModelVault as JaxModelVault
from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
from handyrl_tpu.models.connect_four import ConnectFourNet as JaxNet
from handyrl_tpu_torch import device_generation as dg
from handyrl_tpu_torch.config import ConfigError, apply_defaults
from handyrl_tpu_torch.connection import pack
from handyrl_tpu_torch.environment import (DEVICE_ENVS, ENVS,
                                           make_device_env, make_env)
from handyrl_tpu_torch.envs import torch_connectx
from handyrl_tpu_torch.envs.kaggle import connectx
from handyrl_tpu_torch.generation import Generator
from handyrl_tpu_torch.inference import ModelVault
from handyrl_tpu_torch.model import ModelWrapper, params_bytes
from handyrl_tpu_torch.models import build
from handyrl_tpu_torch.models.connect_four import (ConnectFourNet,
                                                   params_from_flax,
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


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
ENV_ARGS = {'env': 'ConnectX'}


# -- the host env -----------------------------------------------------------

@pytest.mark.timeout(60)
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_env_plays_move_for_move_like_the_reference(seed):
    env, ref = make_env(ENV_ARGS), jax_make_env(ENV_ARGS)
    mirror = make_env(ENV_ARGS)
    rng = random.Random(seed)
    for game in range(6):
        env.reset()
        ref.reset()
        mirror.update(env.diff_info(), True)
        while not ref.terminal():
            assert env.terminal() is False
            assert env.turn() == ref.turn() and env.turns() == ref.turns()
            assert env.legal_actions() == ref.legal_actions()
            for p in (None, 0, 1):
                np.testing.assert_array_equal(env.observation(p),
                                              ref.observation(p))
            for p in (0, 1):
                assert (env.rule_based_action(p)
                        == ref.rule_based_action(p))
            # half the games follow the heuristic, so wins and blocks
            # come up
            action = (ref.rule_based_action(ref.turn()) if game % 2
                      and rng.random() < 0.7
                      else rng.choice(ref.legal_actions()))
            assert env.action2str(action) == ref.action2str(action)
            assert env.str2action(ref.action2str(action)) == action
            env.step({env.turn(): action})
            ref.play(action)
            assert env.diff_info() == ref.diff_info()
            mirror.update(env.diff_info(), False)
            np.testing.assert_array_equal(mirror.cells, env.cells)
        assert env.terminal() and env.outcome() == ref.outcome()
        assert str(env) == str(ref) and env.players() == ref.players()


def test_env_is_registered_and_builds_the_port_net():
    assert ENVS['ConnectX'] == 'handyrl_tpu_torch.envs.kaggle.connectx'
    assert make_device_env(ENV_ARGS) is torch_connectx
    assert DEVICE_ENVS['ConnectX'] == 'handyrl_tpu_torch.envs.torch_connectx'
    net = make_env(ENV_ARGS).net()
    assert isinstance(net, ConnectFourNet)
    assert (net.filters, net.layers, net.config()) == (32, 4, {})
    # the twin's tables are the host env's
    assert sorted(map(tuple, torch_connectx.win_lines('cpu').tolist())) \
        == sorted(map(tuple, connectx.WIN_LINES.tolist()))
    order = torch.argsort(torch_connectx.center_rank('cpu')).tolist()
    assert order == connectx.CENTER_ORDER
    assert (torch_connectx.MAX_STEPS, torch_connectx.N_ACTIONS,
            torch_connectx.RNG_COMPAT) == (jax_connectx.MAX_STEPS,
                                          jax_connectx.N_ACTIONS, 'strict')


# -- the tensor twin --------------------------------------------------------

def _assert_state(js, ts):
    for name, a, b in zip(ts._fields, js, ts):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)


@pytest.mark.timeout(120)
@pytest.mark.parametrize('seed', [0, 1])
def test_twin_matches_jax_connectx_to_the_end(seed):
    """N=64 boards under seeded legal actions (some lanes the heuristic's,
    so the win and block branches fire) until every lane has finished at
    least one game, auto-reset included; the heuristic also against the
    host env's ``rule_based_action`` on every board."""
    n = 64
    rng = np.random.default_rng(seed)
    js, ts = jax_connectx.init_state(n), torch_connectx.init_state(n)
    _assert_state(js, ts)
    finished = np.zeros(n, bool)
    hosts = [connectx.Environment() for _ in range(n)]
    ply = 0
    while not finished.all() or ply < 50:
        legal = np.asarray(jax_connectx.legal_mask(js))
        np.testing.assert_array_equal(torch_connectx.legal_mask(ts).numpy(),
                                      legal)
        np.testing.assert_array_equal(torch_connectx.observe(ts).numpy(),
                                      np.asarray(jax_connectx.observe(js)))
        np.testing.assert_array_equal(torch_connectx.turn(ts).numpy(),
                                      np.asarray(jax_connectx.turn(js)))
        greedy = torch_connectx.greedy_action(ts).numpy()
        np.testing.assert_array_equal(
            greedy, np.asarray(jax_connectx.greedy_action(js)))
        for i, env in enumerate(hosts):
            if not env.terminal():
                assert greedy[i] == env.rule_based_action(env.turn()), i
        pick = np.array([rng.choice(np.flatnonzero(r)) for r in legal])
        use_rule = rng.random(n) < 0.5
        actions = np.where(use_rule, greedy, pick)
        js = jax_connectx.step(js, jnp.asarray(actions))
        ts = torch_connectx.step(ts, torch.from_numpy(actions))
        for i, env in enumerate(hosts):
            env.play(int(actions[i]))
        _assert_state(js, ts)
        done = np.array(jax_connectx.terminal(js))
        np.testing.assert_array_equal(torch_connectx.terminal(ts).numpy(),
                                      done)
        np.testing.assert_array_equal(torch_connectx.outcome(ts).numpy(),
                                      np.asarray(jax_connectx.outcome(js)))
        for i in np.flatnonzero(done):
            assert hosts[i].terminal()
            assert hosts[i].outcome() == {0: float(ts.winner[i]),
                                          1: -float(ts.winner[i])}
            hosts[i].reset()
        finished |= done
        js = jax_connectx.auto_reset(js, jnp.asarray(done))
        ts = torch_connectx.auto_reset(ts, torch.from_numpy(done))
        _assert_state(js, ts)
        ply += 1


def test_twin_edge_cases_match_the_reference():
    """A full column's drop index is clamped and flagged; the lowest
    winning column wins the heuristic; a draw at 42 plies scores 0."""
    boards = np.zeros((3, 42), np.int8)
    # lane 0: column 0 full, the side to move (+1) wins at columns 2 and 6
    boards[0, [0, 7, 14, 21, 28, 35]] = [1, -1, 1, -1, 1, -1]
    boards[0, [37, 38, 39]] = 1          # bottom row, columns 2..4 (+1)
    boards[0, [40, 41]] = 0
    boards[0, [36]] = 0
    # lane 1: only the opponent threatens, at columns 1 and 5
    boards[1, [36, 37, 38]] = 0
    boards[1, [29, 30, 31]] = 0
    boards[1, [38, 39, 40]] = -1
    boards[1, [37]] = 0
    cols = np.array([[0, 1, 6], [2, 3, 4], [6, 5, 0]])
    for k in range(3):
        idx, ok = jax_connectx._drop_index(jnp.asarray(boards),
                                           jnp.asarray(cols[:, k]))
        tidx, tok = torch_connectx._drop_index(torch.from_numpy(boards),
                                               torch.from_numpy(cols[:, k]))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(ok))
    side = np.array([1, 1, -1], np.int8)
    js = jax_connectx.State(jnp.asarray(boards), jnp.asarray(side),
                            jnp.zeros(3, jnp.int8),
                            jnp.asarray(np.array([10, 6, 0], np.int8)))
    ts = torch_connectx.State(torch.from_numpy(boards),
                              torch.from_numpy(side),
                              torch.zeros(3, dtype=torch.int8),
                              torch.tensor([10, 6, 0], dtype=torch.int8))
    np.testing.assert_array_equal(torch_connectx.greedy_action(ts).numpy(),
                                  np.asarray(jax_connectx.greedy_action(js)))
    # a full board without a line: 42 plies, a draw
    env = connectx.Environment()
    draw = [0, 1, 0, 1, 0, 1, 1, 0, 1, 0, 1, 0, 2, 3, 2, 3, 2, 3, 3, 2, 3,
            2, 3, 2, 4, 5, 4, 5, 4, 5, 5, 4, 5, 4, 5, 4, 6, 6, 6, 6, 6, 6]
    ts = torch_connectx.init_state(1)
    for a in draw:
        assert not env.terminal()
        env.play(a)
        ts = torch_connectx.step(ts, torch.tensor([a]))
    assert env.terminal() and env.winner == 0 and int(ts.moves[0]) == 42
    assert bool(torch_connectx.terminal(ts)[0])
    assert torch_connectx.outcome(ts).tolist() == [[0.0, 0.0]]
    assert torch_connectx.legal_mask(ts).sum() == 0


# -- the net ----------------------------------------------------------------

def _boards(n=64, seed=0):
    """Observations of real positions, from both seats' views."""
    env, rng = make_env(ENV_ARGS), random.Random(seed)
    obs = []
    while len(obs) < n:
        if env.terminal():
            env.reset()
        obs += [env.observation(p) for p in env.players()]
        env.play(rng.choice(env.legal_actions()))
    return np.stack(obs[:n])


def _flax_params(seed=1):
    rng = np.random.RandomState(seed)

    def perturb(tree):
        if isinstance(tree, dict):
            return {k: perturb(v) for k, v in tree.items()}
        a = np.asarray(tree)
        return a + 0.1 * rng.randn(*a.shape).astype(np.float32)
    return perturb(JaxNet().init(jax.random.PRNGKey(seed),
                                 np.zeros((1, 3, 6, 7), np.float32)))


@pytest.mark.timeout(60)
def test_forward_matches_flax_at_full_width():
    params = _flax_params()
    obs = _boards()
    want = JaxNet().apply(params, obs)
    net = ConnectFourNet()
    net.load_state_dict(params_from_flax(params))
    got = net(torch.from_numpy(obs))
    for k in ('policy', 'value'):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=0, atol=TOL,
                                   err_msg=k)
    got2 = net(torch.from_numpy(obs.reshape((4, 16) + obs.shape[1:])))
    np.testing.assert_array_equal(
        got2['policy'].detach().numpy().reshape(-1, 7),
        got['policy'].detach().numpy())


@pytest.mark.timeout(60)
def test_params_and_snapshots_cross_both_packages(tmp_path):
    params = _flax_params(seed=3)
    net = ConnectFourNet()
    net.load_state_dict(params_from_flax(params))
    back = params_to_flax(net)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    leaves = jax.tree_util.tree_leaves(params)
    assert len(leaves) == 21
    for a, b in zip(leaves, jax.tree_util.tree_leaves(back)):
        assert a.shape == b.shape and np.array_equal(a, b)
    obs = _boards(8, seed=8)
    jw = JaxModelWrapper(JaxNet(), params)
    pw = ModelWrapper.from_snapshot(jw.snapshot(), device='cpu')
    assert isinstance(pw.module, ConnectFourNet)
    np.testing.assert_allclose(pw.batch_inference(obs)['policy'],
                               np.asarray(jw.batch_inference(obs)['policy']),
                               rtol=0, atol=TOL)
    again = JaxModelWrapper.from_snapshot(pw.snapshot(), obs[0])
    assert again.params_bytes() == jw.params_bytes()
    assert params_bytes(pw.module) == jw.params_bytes()
    narrow = ModelWrapper(build('ConnectFourNet', filters=8, layers=1),
                          device='cpu')
    assert narrow.snapshot()['config'] == {'filters': 8, 'layers': 1}


# -- config -----------------------------------------------------------------

def test_config_accepts_connectx_on_every_path():
    for train in ({}, {'device_generation': True, 'device_replay': True},
                  {'batched_generation': False, 'generation': {
                      'backend': 'device'}},
                  {'device_generation': True}):
        args = apply_defaults({'env_args': dict(ENV_ARGS),
                               'train_args': dict(train)})
        assert args['env_args'] == ENV_ARGS
    assert jax_apply_defaults({'env_args': dict(ENV_ARGS)})['env_args'] \
        == ENV_ARGS


@pytest.mark.parametrize('env', ['Othello', 'handyrl_tpu.envs.geister'])
def test_the_envs_still_missing_are_refused_by_name(env):
    """Every env of the JAX registry is ported; a name outside the port's
    registry (an unknown game, or a module path, which the port never
    imports) is refused by name."""
    with pytest.raises(ConfigError, match=env.replace('.', r'\.')):
        apply_defaults({'env_args': {'env': env}})


# -- the device actor's strict records ---------------------------------------

def _engines(n_envs=6, chunk_steps=8, slots=2):
    raw = {'env_args': dict(ENV_ARGS), 'train_args': {'seed': 13}}
    tas = []
    for apply in (jax_apply_defaults, apply_defaults):
        cfg = apply(copy.deepcopy(raw))
        ta = dict(cfg['train_args'])
        ta['env'] = cfg['env_args']
        tas.append(ta)
    jta, pta = tas
    jenv = jax_make_env(ENV_ARGS)
    jenv.reset()
    obs0 = jenv.observation(0)
    snaps = {}

    def fetch(mid):
        if mid not in snaps:
            w = JaxModelWrapper(JaxNet(), seed=100 + int(mid))
            w.ensure_params(obs0)
            snaps[mid] = w.snapshot()
        return snaps[mid]

    jeng = jdg.DeviceActorEngine(
        make_jax_env(ENV_ARGS), JaxModelVault(fetch, obs0,
                                              capacity=slots + 2),
        jax_make_env(ENV_ARGS), jta, n_envs=n_envs, chunk_steps=chunk_steps,
        slots=slots, seed=5)
    pvault = ModelVault(fetch, obs0, capacity=slots + 2, device='cpu')
    peng = dg.DeviceActorEngine(
        make_device_env(ENV_ARGS), pvault, make_env(ENV_ARGS), pta,
        n_envs=n_envs, chunk_steps=chunk_steps, slots=slots, seed=5,
        device='cpu')
    return jeng, peng, pvault, pta


@pytest.mark.timeout(180)
def test_device_actor_strict_records_are_the_host_generators():
    jeng, peng, pvault, pta = _engines()
    assert peng.record_mode == jeng.record_mode == 'strict'
    tasks = ([{'role': 'g', 'player': [0, 1], 'model_id': {0: 1, 1: 1},
               'sample_key': k, 'task_id': k} for k in range(4)]
             + [{'role': 'g', 'player': [0, 1], 'model_id': {0: 1, 1: 2},
                 'sample_key': 4, 'task_id': 4}])
    uploads, deferred = peng.run_block(copy.deepcopy(tasks))
    juploads, jdeferred = jeng.run_block(copy.deepcopy(tasks))
    assert deferred == jdeferred == []
    gen = Generator(make_env(ENV_ARGS), pta)
    for task, (kind, got), (_, want) in zip(tasks, uploads, juploads):
        assert kind == 'episode' and got is not None
        host = gen.execute(pvault.obtain(dict(task['model_id'])), task)
        assert pack(got) == pack(host), task
        assert got['outcome'] == want['outcome']
        assert got['steps'] == want['steps']
    # 'rulebase' evaluation tasks play the twin's heuristic on the device
    # (TicTacToe's twin has none and defers them)
    etasks = [{'role': 'e', 'player': [k % 2],
               'model_id': {p: (1 if p == k % 2 else -1) for p in (0, 1)},
               'sample_key': k, 'task_id': 100 + k, 'opponent': 'rulebase'}
              for k in range(4)]
    uploads, deferred = peng.run_block(copy.deepcopy(etasks))
    juploads, jdeferred = jeng.run_block(copy.deepcopy(etasks))
    assert deferred == jdeferred == []
    assert uploads == juploads and len(uploads) == 4
    assert peng.stats['divergences'] == 0


# -- the paths, end to end ------------------------------------------------------

def _learn(tmp_path, extra, timeout=240):
    train = {'batch_size': 8, 'forward_steps': 8, 'generation_envs': 8,
             'num_batchers': 1, 'minimum_episodes': 12,
             'update_episodes': 10, 'epochs': 2, 'eval_envs': 4,
             'model_dir': str(tmp_path / 'models'),
             'eval': {'opponent': ['random', 'rulebase']}}
    train.update(extra)
    path = tmp_path / 'cfg.json'
    path.write_text(json.dumps({'env_args': ENV_ARGS,
                                'train_args': train}))
    env = dict(os.environ, OMP_NUM_THREADS='1')
    proc = subprocess.run(
        [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config',
         str(path), '--device', 'cpu'], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads([l for l in proc.stdout.splitlines()
                       if l.startswith('{')][-1])
    assert line['epochs'] == 2 and not line['failed']
    assert (tmp_path / 'models' / 'latest.ckpt').exists()
    return proc.stdout, line


@pytest.mark.timeout(300)
@pytest.mark.parametrize('path', ['host', 'fused_turn'])
def test_connectx_trains_through_the_cli(tmp_path, path):
    extra = {} if path == 'host' else {
        'device_generation': True, 'device_replay': True,
        'device_chunk_steps': 8, 'sgd_steps_per_chunk': 2,
        'maximum_episodes': 64}
    out, line = _learn(tmp_path, extra)
    assert line['steps'] > 0 and line['episodes'] > 0
    if path == 'fused_turn':
        assert '(turn mode)' in out and line['fused'] is True
    else:
        assert line['plies']['generation'] > 0


@pytest.mark.timeout(300)
def test_tournament_plays_connectx_against_rulebase(tmp_path):
    """The offline tournament (spawned processes) of a fresh checkpoint
    against the heuristic: every game counted."""
    net = ConnectFourNet(generator=torch.Generator().manual_seed(3))
    ckpt = tmp_path / '1.ckpt'
    ckpt.write_bytes(params_bytes(net))
    cfg = tmp_path / 'cfg.json'
    cfg.write_text(json.dumps({'env_args': ENV_ARGS,
                               'train_args': {}}))
    env = dict(os.environ, OMP_NUM_THREADS='1')
    proc = subprocess.run(
        [sys.executable, '-m', 'handyrl_tpu_torch.evaluation',
         '%s:rulebase' % ckpt, '4', '2', '--config', str(cfg), '--device',
         'cpu'],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'total games = 4' in proc.stdout
