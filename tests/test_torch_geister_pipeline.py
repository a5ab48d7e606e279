"""Geister through the port's pipeline, against the JAX package's
(tests/test_geister_pipeline.py, tests/test_geister_device_parity.py):
batched generation with the DRC state and dict observations, the batch,
the recurrent update step with burn-in on a GeisterNet('batch',
'spatial'), the device generator's and evaluator's acting-seat-only
semantics, the device actor's Geister lanes and the learners through the
CLI. The nets are the JAX tests' small one (filters 8, 2 DRC layers, 1
repeat): the JAX package compiles the full DRC step slowly on the CPU.

Tolerances:
- the generators: actions, turns, masks, outcomes and observations exact,
  values within 1e-5 (the same Gumbel draws on logits within rounding);
- the batch: every leaf exact but the values and probabilities (1e-5);
- the update step with burn-in 2: each loss term within 1e-5 relative
  (atol 1e-4), the pre-clip grad norm within 1e-5 relative, params within
  1e-5 and the running averages within 1e-5 absolute (the burn-in steps
  advance them too);
- the 'turn' ingest of Geister records: the JAX windower's rows
  exactly, the discounted returns within 1e-6 (one fused rounding);
- the device paths' semantics are exact (who observed, which state
  moved); their numbers are the port's own draws."""

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

from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.envs import jax_geister
from handyrl_tpu.generation import BatchedGenerator as JaxBatchedGenerator
from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
from handyrl_tpu.models.geister import GeisterNet as JaxNet
from handyrl_tpu.ops import batch as jbatch
from handyrl_tpu.ops.losses import LossConfig as JaxLossConfig
from handyrl_tpu.ops.train_step import build_update_step as jax_step
from handyrl_tpu.ops.train_step import init_train_state as jax_init_state
from handyrl_tpu_torch import device_generation as dg
from handyrl_tpu_torch.envs import torch_geister
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.generation import BatchedGenerator
from handyrl_tpu_torch.inference import ModelVault
from handyrl_tpu_torch.model import ModelWrapper
from handyrl_tpu_torch.models.geister import (GeisterNet, params_from_flax,
                                              params_to_flax)
from handyrl_tpu_torch.ops import batch as tbatch
from handyrl_tpu_torch.ops.losses import LossConfig
from handyrl_tpu_torch.ops.train_step import (build_update_step,
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


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
LOSS_TOL = dict(rtol=1e-5, atol=1e-4)
ENV_ARGS = {'env': 'Geister', 'norm_kind': 'batch', 'policy_head': 'spatial'}
SMALL = dict(filters=8, drc_layers=2, drc_repeats=1, norm_kind='batch',
             policy_head='spatial')
ENVS = 4


def _args(burn_in=2):
    return {'turn_based_training': True, 'observation': True,
            'gamma': 0.9, 'forward_steps': 4, 'burn_in_steps': burn_in,
            'compress_steps': 4, 'maximum_episodes': 100, 'lambda': 0.7,
            'policy_target': 'TD', 'value_target': 'TD',
            'entropy_regularization': 0.1,
            'entropy_regularization_decay': 0.1}


def _variables(seed=1):
    """The small net's flax init perturbed, its running averages moved off
    their init, in the init's key order."""
    jm = JaxNet(**SMALL)
    rng = np.random.RandomState(seed)
    env = jax_make_env(ENV_ARGS)
    env.reset()
    obs = {k: v[None] for k, v in env.observation(0).items()}
    v = jm.init(jax.random.PRNGKey(seed), obs, jm.init_hidden((1,)))

    def go(t, pos):
        if isinstance(t, dict):
            return {k: go(x, pos) for k, x in t.items()}
        a = np.asarray(t)
        d = 0.1 * rng.randn(*a.shape).astype(np.float32)
        return np.abs(a + d) if pos else a + d
    return jm, {'params': go(v['params'], False),
                'batch_stats': {m: {'BatchNorm_0': {
                    'mean': go(s['BatchNorm_0']['mean'], False),
                    'var': go(s['BatchNorm_0']['var'], True)}}
                    for m, s in v['batch_stats'].items()}}


def _wrappers(seed=1):
    jm, v = _variables(seed)
    jw = JaxModelWrapper(jm, v)
    net = GeisterNet(**SMALL)
    net.load_state_dict(params_from_flax(v))
    return jm, v, jw, ModelWrapper(net, device='cpu')


def _generate(gen_cls, make, wrapper, args, until, seed):
    np.random.seed(seed)
    random.seed(seed)
    gen = gen_cls(lambda i: make(dict(ENV_ARGS, id=i)), wrapper, args,
                  n_envs=ENVS)
    out, plies = [], 0
    while len(out) < until:
        out += gen.step()
        plies += 1
        assert plies < 3000
    return out


@pytest.fixture(scope='module')
def episodes():
    jm, v, jw, pw = _wrappers()
    args = _args()
    want = _generate(JaxBatchedGenerator, jax_make_env, jw, args, 3, 7)
    got = _generate(BatchedGenerator, make_env, pw, args, 3, 7)
    return jm, v, pw, want, got


def _assert_obs_equal(a, b):
    if b is None:
        assert a is None
        return
    assert a.keys() == b.keys()
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.timeout(300)
def test_batched_generation_matches_jax_with_dict_observations(episodes):
    """Self-play of 4 envs on the same seeds: the same games, each ply's
    acting seat alone observing (``observation: true`` widens the batch,
    not who observes), the DRC state carried per seat."""
    _, _, _, want, got = episodes
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g['steps'] == w['steps'] and g['outcome'] == w['outcome']
        for a, b in zip(tbatch.decompress_moments(g['moment']),
                        jbatch.decompress_moments(w['moment'])):
            assert a['turn'] == b['turn'] and a['action'] == b['action']
            assert len(a['turn']) == 1
            for p in (0, 1):
                _assert_obs_equal(a['observation'][p], b['observation'][p])
                if b['value'][p] is not None:
                    np.testing.assert_allclose(a['value'][p], b['value'][p],
                                               rtol=0, atol=TOL)
                    np.testing.assert_allclose(a['selected_prob'][p],
                                               b['selected_prob'][p],
                                               rtol=0, atol=TOL)


def _windows(pkg, eps, args, seed, n=3):
    random.seed(seed)
    return [pkg.select_episode(eps, args) for _ in range(n)]


@pytest.mark.timeout(300)
def test_batch_and_burn_in_step_match_jax(episodes):
    """The wide (observation) batch with dict observations from both
    packages' windows, then two update steps with burn-in 2 on a
    GeisterNet('batch', 'spatial'): losses, the grad norm, params and the
    running averages (advanced at every step of the scan, burn-in
    included) equal the JAX step's."""
    jm, v, _, want_eps, got_eps = episodes
    args = _args()
    jb = jbatch.make_batch(_windows(jbatch, want_eps, args, 3), args)
    tb = tbatch.make_batch(_windows(tbatch, got_eps, args, 3), args)
    assert set(tb) == set(jb)
    assert set(tb['observation']) == {'scalar', 'board'}
    assert tb['observation']['board'].shape == (3, 6, 2, 7, 6, 6)
    for k in jb:
        if k == 'observation':
            for leaf in jb[k]:
                np.testing.assert_array_equal(tb[k][leaf], jb[k][leaf])
        elif k in ('value', 'selected_prob'):
            np.testing.assert_allclose(tb[k], jb[k], rtol=0, atol=TOL)
        else:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    jcfg = JaxLossConfig.from_args(args)
    jstate = jax_init_state(v)
    jupdate = jax_step(jm, jcfg, donate=False)
    cfg = LossConfig(**jcfg._asdict())
    net = GeisterNet(**SMALL)
    net.load_state_dict(params_from_flax(v))
    state = init_train_state(net)
    update = build_update_step(net, cfg)
    torch_batch = {k: ({kk: torch.from_numpy(np.asarray(vv))
                        for kk, vv in x.items()} if isinstance(x, dict)
                       else torch.from_numpy(np.asarray(x)))
                   for k, x in tb.items()}
    for step in range(2):
        jstate, jm_ = jupdate(jstate, jb, jnp.float32(1e-3))
        state, metrics = update(state, torch_batch, torch.tensor(1e-3))
        for k in ('p', 'v', 'r', 'ent', 'total'):
            np.testing.assert_allclose(metrics[k].item(), float(jm_[k]),
                                       err_msg='%s step %d' % (k, step),
                                       **LOSS_TOL)
        np.testing.assert_allclose(metrics['diag_grad_norm'].item(),
                                   float(jm_['diag_grad_norm']), rtol=TOL)
        now = params_to_flax(state.params, norm_kind='batch')
        jv = jax.tree_util.tree_map(np.asarray, jstate.params)
        for coll in ('params', 'batch_stats'):
            for (path, a), b in zip(
                    jax.tree_util.tree_flatten_with_path(jv[coll])[0],
                    jax.tree_util.tree_leaves(now[coll])):
                np.testing.assert_allclose(b, a, rtol=0, atol=TOL,
                                           err_msg='%s %s' % (coll, path))
    # the running averages moved from their start
    start = params_from_flax(v)
    assert not torch.allclose(state.params['stem.norm.mean'],
                              start['stem.norm.mean'])


# -- the device paths ----------------------------------------------------------

def _device_net(seed=2):
    return GeisterNet(generator=torch.Generator().manual_seed(seed),
                      **SMALL).eval()


@pytest.mark.timeout(240)
def test_device_generator_records_the_acting_seat_alone():
    """tests/test_geister_device_parity.py's semantics on the port: each
    device-generated moment has exactly the acting seat observing, acting
    and valued, and its batch (observation: true) is the host batch's
    layout, observation_mask equal to turn_mask."""
    args = _args()
    gen = dg.DeviceGenerator(torch_geister, _device_net(), args, n_envs=4,
                             chunk_steps=16, seed=3)
    eps = []
    for _ in range(40):
        eps += gen.step_chunk()
        if len(eps) >= 2:
            break
    assert len(eps) >= 2
    for ep in eps[:2]:
        moments = tbatch.decompress_moments(ep['moment'])
        assert len(moments) == ep['steps']
        for m in moments:
            (player,) = m['turn']
            other = 1 - player
            assert m['observation'][player]['board'].shape == (7, 6, 6)
            assert m['observation'][player]['scalar'].shape == (18,)
            for key in ('value', 'action', 'selected_prob', 'action_mask'):
                assert m[key][player] is not None, key
                assert m[key][other] is None, key
            assert m['observation'][other] is None
    batch = tbatch.make_batch(_windows(tbatch, eps, args, 5, 4), args)
    omask, tmask = batch['observation_mask'], batch['turn_mask']
    assert omask.shape[2] == 2
    np.testing.assert_array_equal(omask, tmask)
    np.testing.assert_array_equal(tmask.sum(axis=2)[..., 0],
                                  batch['episode_mask'][:, :, 0, 0])


def _jax_geister_records(K, N, seed):
    """K plies of N Geister games on the JAX twin under seeded legal
    actions: the 'turn' records the rollout body writes (a dict
    observation, the per-ply rewards)."""
    rng = np.random.RandomState(seed)
    js = jax_geister.init_state(N)
    plies = []
    for _ in range(K):
        legal = np.asarray(jax_geister.legal_mask(js))
        actions = np.array([rng.choice(np.flatnonzero(r)) for r in legal])
        nxt = jax_geister.step(js, jnp.asarray(actions))
        done = np.asarray(jax_geister.terminal(nxt))
        obs = jax_geister.observe(js)
        plies.append({
            'obs': {k: np.asarray(v) for k, v in obs.items()},
            'action': actions.astype(np.int32),
            'prob': rng.uniform(0.1, 1, N).astype(np.float32),
            'amask': (1 - legal) * np.float32(1e32),
            'value': rng.uniform(-1, 1, (N, 1)).astype(np.float32),
            'player': np.asarray(jax_geister.turn(js)), 'done': done,
            'outcome': np.asarray(jax_geister.outcome(nxt)),
            'reward': np.asarray(jax_geister.rewards(nxt))})
        js = jax_geister.auto_reset(nxt, jnp.asarray(done))

    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([i[k] for i in items]) for k in items[0]}
        return np.stack(items)
    return {k: stack([p[k] for p in plies]) for k in plies[0]}


@pytest.mark.timeout(240)
def test_turn_ingest_of_geister_records_fills_the_jax_rows():
    """The 'turn' windower on Geister's records (a dict observation, the
    rewards' discounted returns, burn-in 2) writes the JAX windower's ring
    rows, one ring leaf an observation entry: exactly, but the returns
    within 1e-6 (XLA fuses r + gamma * carry into one rounding; 1 ulp of
    up to 24 of 3,072 seen)."""
    from handyrl_tpu.ops import device_windows as jdw
    from handyrl_tpu_torch.ops import device_windows as dw
    K, N, W, fs, bi, Lmax, cap = 120, 4, 3, 4, 2, 64, 256
    rec = _jax_geister_records(K, N, seed=3)
    key = jax.random.PRNGKey(11)
    us = []
    for _ in range(K):
        key, k_ts, _ = jax.random.split(key, 3)
        us.append(np.asarray(jax.random.uniform(k_ts, (N, W))))
    key = jax.random.PRNGKey(11)
    jwd = jdw.DeviceWindower('turn', fs, bi, Lmax, W, cap, 2, 0.9, True)
    jrec = jax.tree_util.tree_map(jnp.asarray, rec)
    jstate, jring = jwd.init_state(jrec), jwd.init_ring(jrec)
    jstate, jring, jcur, jsize, _, jdone, jwin = jwd.ingest(
        jrec, jstate, jring, jnp.int32(0), jnp.int32(0), key)
    wd = dw.DeviceWindower('turn', fs, bi, Lmax, W, cap, 2, 0.9, True)
    trec = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else torch.from_numpy(v))
            for k, v in rec.items()}
    state, ring = wd.init_state(trec), wd.init_ring(trec)
    cursor = torch.zeros((), dtype=torch.int64)
    size = torch.zeros((), dtype=torch.int64)
    n_done, n_win = wd.ingest(trec, state, ring, cursor, size, draws={
        'u': torch.from_numpy(np.stack(us)), 'seat': None})
    assert int(n_done) == int(jdone) > 0
    assert int(n_win) == int(jwin) and int(cursor) == int(jcur)
    assert set(ring) == set(jring) >= {'observation.board',
                                       'observation.scalar', 'return'}
    for k in jring:
        np.testing.assert_allclose(ring[k][:cap].numpy(),
                                   np.asarray(jring[k]), rtol=0,
                                   atol=1e-6 if k == 'return' else 0,
                                   err_msg=k)
    rows = wd.unflatten_rows({k: v[:2] for k, v in ring.items()})
    assert rows['observation']['board'].shape == (2, bi + fs, 1, 7, 6, 6)
    assert rows['value'].shape == (2, bi + fs, 2, 1)


def test_ply_inference_advances_the_acting_seats_state_alone():
    """A turn-based recurrent ply gathers the acting seat's state, runs
    the net and scatters the next state back: the other seat's state is
    untouched (the evaluator's model seat advances on its own turns)."""
    net = _device_net()
    state = torch_geister.init_state(3)
    for a in (144, 150):      # both setup plies
        state = torch_geister.step(state, torch.full((3,), a))
    hidden = net.init_hidden((3, 2))
    hidden = tuple([torch.randn_like(t) for t in part] for part in hidden)
    _, _, _, _, nh = dg._ply_inference(torch_geister, net, state, hidden)
    player = torch_geister.turn(state)
    rows = torch.arange(3)
    for before, after in zip(hidden[0] + hidden[1], nh[0] + nh[1]):
        assert torch.equal(before[rows, 1 - player], after[rows, 1 - player])
        assert not torch.equal(before[rows, player], after[rows, player])


@pytest.mark.timeout(240)
def test_device_evaluator_plays_geister_with_its_own_state(tmp_path):
    """Matches against 'random' and a checkpoint opponent (its own DRC
    state), to the end; every result zero-sum and from the rotating
    seat."""
    from handyrl_tpu_torch.model import params_bytes
    ckpt = tmp_path / '1.ckpt'
    ckpt.write_bytes(params_bytes(_device_net(seed=4)))
    ev = dg.DeviceEvaluator(torch_geister, _device_net(), _args(),
                            n_envs=4, chunk_steps=32, seed=5,
                            opponents=['random', str(ckpt)])
    assert ev.recurrent and ev.opp_hidden is not None
    results = []
    for _ in range(40):
        results += ev.step()
        if len(results) >= 4:
            break
    assert len(results) >= 4
    for r in results:
        seat = r['args']['player'][0]
        assert r['opponent'] in ('random', str(ckpt))
        assert set(r['result']) == {0, 1}
        assert r['result'][seat] in (-1.0, 0.0, 1.0)
        assert r['result'][0] == -r['result'][1]


@pytest.mark.timeout(240)
def test_device_actor_plays_geister_lanes_in_device_records():
    """A block of 'g' and 'e' tasks on Geister lanes: 'device' records
    (the host env's hidden layouts draw from its own rng), every task
    answered, each episode's moments the acting seat's alone."""
    from handyrl_tpu_torch.config import apply_defaults
    cfg = apply_defaults({'env_args': dict(ENV_ARGS),
                          'train_args': {'seed': 13}})
    ta = dict(cfg['train_args'], env=cfg['env_args'])
    host = make_env(ENV_ARGS)
    host.reset()
    obs0 = host.observation(0)

    def fetch(mid):
        net = _device_net(seed=10 + int(mid))
        return ModelWrapper(net, device='cpu').snapshot()
    vault = ModelVault(fetch, obs0, capacity=4, device='cpu')
    eng = dg.DeviceActorEngine(torch_geister, vault, host, ta, n_envs=4,
                               chunk_steps=16, slots=2, seed=5,
                               device='cpu')
    assert eng.recurrent and eng.record_mode == 'device'
    tasks = ([{'role': 'g', 'player': [0, 1], 'model_id': {0: 1, 1: 2},
               'sample_key': k, 'task_id': k} for k in range(2)]
             + [{'role': 'e', 'player': [k], 'model_id': {k: 1, 1 - k: -1},
                 'sample_key': 9 + k, 'task_id': 9 + k,
                 'opponent': 'random'} for k in range(2)])
    uploads, deferred = eng.run_block(copy.deepcopy(tasks))
    assert deferred == [] and len(uploads) == 4
    for task, (kind, payload) in zip(tasks, uploads):
        assert payload is not None
        if task['role'] == 'g':
            assert kind == 'episode' and payload['record_version'] == 1
            for m in tbatch.decompress_moments(payload['moment']):
                (player,) = m['turn']
                assert m['observation'][1 - player] is None
                assert m['observation'][player]['board'].shape == (7, 6, 6)
        else:
            assert kind == 'result'


@pytest.mark.timeout(120)
def test_engine_answers_geister_with_the_next_drc_state():
    """The serving engine on a 'batch' GeisterNet: a None hidden is the
    net's zero state, each reply carries its row's next ``([h]*L,
    [c]*L)``, the same numbers as the JAX wrapper's single-sample
    inference (which reads the running averages) over three plies."""
    import queue
    from handyrl_tpu_torch.inference import InferenceEngine
    _, _, jw, pw = _wrappers(seed=6)
    env = make_env(ENV_ARGS)
    env.reset()
    replies = queue.Queue()
    engine = InferenceEngine({'inference': {'batch_wait_ms': 1.0}},
                             lambda mid: pw.snapshot(),
                             lambda ep, msg: replies.put(msg),
                             env.observation(0), device='cpu')
    engine.start()
    try:
        hidden, jhidden = None, jw.init_hidden()
        for ply in range(3):
            obs = env.observation(env.turn())
            engine.submit('ep', {'rid': ply, 'mid': 1, 'obs': obs,
                                 'hidden': hidden})
            reply = replies.get(timeout=60)
            assert reply['rid'] == ply, reply
            out = reply['outputs']
            want = jw.inference(obs, jhidden)
            np.testing.assert_allclose(out['policy'], want['policy'],
                                       rtol=0, atol=TOL)
            hs, cs = out['hidden']
            assert len(hs) == len(cs) == 2
            for a, b in zip(hs + cs, want['hidden'][0] + want['hidden'][1]):
                assert np.shape(a) == (6, 6, 8)
                np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
            hidden, jhidden = out['hidden'], want['hidden']
            env.play(env.legal_actions()[0])
    finally:
        engine.stop()


@pytest.mark.timeout(300)
def test_geister_resumes_with_its_running_averages(tmp_path):
    """A second run with ``restart_epoch: -1`` resumes the trainer state
    (params, Adam, running averages) from ``trainer_state.ckpt`` and
    trains on: the resumed model's averages are the first run's at the
    start and move again."""
    from flax import serialization
    _learn(tmp_path, {})
    first = serialization.msgpack_restore(
        (tmp_path / 'models' / '1.ckpt').read_bytes())['batch_stats']
    state = serialization.msgpack_restore(
        (tmp_path / 'models' / 'trainer_state.ckpt').read_bytes())
    np.testing.assert_array_equal(
        state['state']['params']['batch_stats']['ConvBlock_0'][
            'BatchNorm_0']['mean'],
        first['ConvBlock_0']['BatchNorm_0']['mean'])
    out, line = _learn(tmp_path, {'restart_epoch': -1, 'epochs': 2})
    assert 'auto-resume: newest valid checkpoint is epoch 1' in out
    second = serialization.msgpack_restore(
        (tmp_path / 'models' / '2.ckpt').read_bytes())['batch_stats']
    assert not np.array_equal(second['ConvBlock_0']['BatchNorm_0']['mean'],
                              first['ConvBlock_0']['BatchNorm_0']['mean'])


# -- the learners, end to end ------------------------------------------------------

def _learn(tmp_path, extra, timeout=280):
    train = {'turn_based_training': True, 'observation': True,
             'burn_in_steps': 2, 'forward_steps': 4, 'batch_size': 4,
             'generation_envs': 4, 'eval_envs': 4, 'num_batchers': 1,
             'minimum_episodes': 4, 'update_episodes': 4, 'epochs': 1,
             'model_dir': str(tmp_path / 'models')}
    train.update(extra)
    path = tmp_path / 'cfg.json'
    path.write_text(json.dumps({'env_args': ENV_ARGS, 'train_args': train}))
    env = dict(os.environ, OMP_NUM_THREADS='1')
    proc = subprocess.run(
        [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config',
         str(path), '--device', 'cpu'], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads([l for l in proc.stdout.splitlines()
                       if l.startswith('{')][-1])
    # the epochs this process ran (a resumed run counts its own)
    assert line['epochs'] == 1 and not line['failed'] and line['steps'] > 0
    return proc.stdout, line


PATHS = {
    'host': {},
    'fused_turn': {'device_generation': True, 'device_replay': True,
                   'device_chunk_steps': 8, 'sgd_steps_per_chunk': 2,
                   'maximum_episodes': 16},
    # the threaded replay trainer fed by the host's self-play
    'host_push': {'device_replay': True, 'device_ingest': False,
                  'replay_fused_steps': 2, 'maximum_episodes': 16},
    'workers': {'batched_generation': False,
                'worker': {'num_parallel': 2}},
}


@pytest.mark.timeout(300)
@pytest.mark.parametrize('path', sorted(PATHS))
def test_geister_batch_norm_trains_through_the_cli(tmp_path, path):
    """GeisterNet('batch', 'spatial') with burn-in on the host learner,
    the fused 'turn' loop, the threaded replay trainer fed by the host
    and the worker plane: the checkpoint carries running averages that
    moved, in the layout flax reads."""
    from flax import serialization
    out, line = _learn(tmp_path, PATHS[path])
    if path == 'fused_turn':
        assert '(turn mode)' in out and line['fused'] is True
    raw = (tmp_path / 'models' / 'latest.ckpt').read_bytes()
    tree = serialization.msgpack_restore(raw)
    assert set(tree) == {'params', 'batch_stats'}
    stats = tree['batch_stats']
    assert set(stats) == {'ConvBlock_0', 'SpatialPolicyHead_0',
                          'ScalarHead_0', 'ScalarHead_1'}
    mean = stats['ConvBlock_0']['BatchNorm_0']['mean']
    assert mean.shape == (32,) and np.abs(mean).max() > 0
    jw = JaxModelWrapper(JaxNet(norm_kind='batch', policy_head='spatial'))
    env = jax_make_env(ENV_ARGS)
    env.reset()
    jw.load_params_bytes(raw, env.observation(0))
    np.testing.assert_array_equal(
        np.asarray(jw.params['batch_stats']['ConvBlock_0']['BatchNorm_0'][
            'var']), stats['ConvBlock_0']['BatchNorm_0']['var'])
