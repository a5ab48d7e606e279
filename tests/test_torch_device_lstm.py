"""The recurrent GeeseNetLSTM on the port's device loops
(handyrl_tpu_torch/device_generation.py ``make_gen_body``,
``DeviceGenerator``, ``DeviceEvaluator``, ``DeviceActorEngine``;
ops/fused_pipeline.py) on the CPU, against the JAX package's
(handyrl_tpu/device_generation.py; tests/test_device_eval.py).

A small GeeseNetLSTM (filters 8, one stem block) with the same weights in
both packages (``params_from_flax``). As in tests/test_torch_device_eval.py
the port takes the JAX env state before each ply (food respawns and fresh
boards come from each package's own generator) and draws the uniforms the
JAX key splits give; the hidden state is each package's own, carried from
ply to ply.

Checked, with tolerances:
- the self-play ply: obs, amask, acting, action, done and outcome exactly;
  prob and value within 1e-5; the carried ``(h, c)`` within 1e-5 of the
  JAX package's after every ply (fp32 convs in other orders), and zero in
  the envs whose episode ended;
- the evaluator with a recurrent checkpoint opponent: the packed (done,
  seat, outcome) rows and result records exactly, the trained net's and
  the opponent's state within 1e-5;
- the split generator: its static hidden state carried across chunks and
  zeroed where an episode ended, its episodes' moments complete;
- the device actor: a recurrent block takes 'device' records (strict is
  refused for a recurrent net, as in the JAX package), its episodes are
  stamped and a batch with burn-in builds from them;
- the fused loop and the split path train a GeeseNetLSTM with burn-in
  through the CLI."""

import copy
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu import device_generation as jdg
from handyrl_tpu.config import apply_defaults as jax_apply_defaults
from handyrl_tpu.envs import jax_hungry_geese as jhg
from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
from handyrl_tpu.models.geese import GeeseNetLSTM as JaxLSTM
from handyrl_tpu_torch import device_generation as dg
from handyrl_tpu_torch.config import apply_defaults
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.envs import torch_hungry_geese as tg
from handyrl_tpu_torch.inference import ModelVault
from handyrl_tpu_torch.models.geese import GeeseNetLSTM, params_from_flax
from handyrl_tpu_torch.ops.batch import make_batch

pytestmark = pytest.mark.timeout(180)


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
TOL = 1e-5
N = 6
GEESE = {'env': 'HungryGeese', 'net_kind': 'lstm'}


def _pair(seed=0):
    jm = JaxLSTM(filters=8, stem_layers=1)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 17, 7, 11), jnp.float32), None)
    params = jax.tree_util.tree_map(np.asarray, params)
    net = GeeseNetLSTM(filters=8, stem_layers=1)
    net.load_state_dict(params_from_flax(params))
    return jm, params, net


def _to_port(js) -> tg.State:
    return tg.State(*[torch.from_numpy(np.array(getattr(js, f)))
                      for f in tg.State._fields])


def _close(mine, ref, what):
    for a, b in zip(mine, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL, err_msg=what)


def test_recurrent_gen_body_matches_jax_ply_by_ply(monkeypatch):
    jm, params, net = _pair()
    jroll = jax.jit(jdg.make_gen_body(jhg, jm.apply, True, True),
                    static_argnums=4)
    rollout = dg.make_gen_body(tg, net)
    real_gumbel = dg.gumbel_argmax
    cur = {}
    monkeypatch.setattr(dg, 'gumbel_argmax',
                        lambda logits, u: real_gumbel(logits, cur['u']))
    js, rng = jhg.init_state(N, seed=4), jax.random.PRNGKey(8)
    jh = jm.init_hidden((N, 4))
    th = net.init_hidden((N, 4))
    gen = torch.Generator().manual_seed(1)
    dones = 0
    for ply in range(60):
        _, key = jax.random.split(rng)
        cur['u'] = torch.from_numpy(np.array(jax.random.uniform(
            key, (N, 4, 4), minval=TINY, maxval=1.0)))
        _, rec, th = rollout(_to_port(js), 1, gen, th)
        js, jh, rng, jrec = jroll(params, js, jh, rng, 1)
        for k in ('obs', 'amask', 'acting', 'action', 'done', 'outcome'):
            np.testing.assert_array_equal(rec[k].numpy(),
                                          np.asarray(jrec[k]),
                                          err_msg='%s ply %d' % (k, ply))
        for k in ('prob', 'value'):
            np.testing.assert_allclose(rec[k].numpy(), np.asarray(jrec[k]),
                                       rtol=0, atol=TOL,
                                       err_msg='%s ply %d' % (k, ply))
        _close(th, jh, 'hidden ply %d' % ply)
        done = rec['done'].numpy()[0]
        for h in th:
            assert not h[torch.from_numpy(done)].any()
        dones += int(done.sum())
    assert dones >= 3


def test_evaluator_with_a_recurrent_checkpoint_matches_jax(monkeypatch,
                                                           tmp_path):
    """'random' and a recurrent checkpoint opponent (other weights, flax
    ``to_bytes``), whose blocks carry their own state through the chunk."""
    from flax import serialization
    jm, params, net = _pair(seed=2)
    _, opp_params, _ = _pair(seed=9)
    path = tmp_path / '3.ckpt'
    path.write_bytes(serialization.to_bytes(opp_params))
    opponents = ['random', str(path)]
    jev = jdg.DeviceEvaluator(jhg, JaxModelWrapper(jm, params), {},
                              n_envs=N, chunk_steps=1, seed=6,
                              opponents=opponents)
    ev = dg.DeviceEvaluator(tg, net, {}, n_envs=N, chunk_steps=1, seed=6,
                            opponents=opponents)
    assert ev.recurrent and jev.recurrent
    assert ev.opp_hidden is not None and jev.opp_hidden is not None
    real_gumbel = dg.gumbel_argmax
    cur = {}
    monkeypatch.setattr(dg, 'gumbel_argmax',
                        lambda logits, u: real_gumbel(logits, cur['u']))
    results = 0
    for ply in range(60):
        _, key = jax.random.split(jev.rng)
        cur['u'] = torch.from_numpy(np.array(jax.random.uniform(
            key, (N, 4, 4), minval=TINY, maxval=1.0)))
        dg.copy_state_(ev.state, _to_port(jev.state))
        ev.seat.copy_(torch.from_numpy(np.array(jev.seat)).long())
        packed = ev._rollout().numpy()
        (jev.state, jev.hidden, jev.opp_hidden, jev.seat, jev.rng,
         jrec) = jev._rollout(params, tuple(jev._opp_params), jev.state,
                              jev.hidden, jev.opp_hidden, jev.seat, jev.rng)
        jrec = {k: np.asarray(v) for k, v in jrec.items()}
        want = np.concatenate([jrec['done'].reshape(-1).astype(np.float32),
                               jrec['seat'].reshape(-1).astype(np.float32),
                               jrec['outcome'].reshape(-1)])
        np.testing.assert_array_equal(packed, want, err_msg='ply %d' % ply)
        _close(ev.hidden, jev.hidden, 'hidden ply %d' % ply)
        _close(ev.opp_hidden, jev.opp_hidden, 'opp_hidden ply %d' % ply)
        got = ev._collect(packed)
        assert got == jev._collect(jrec), ply
        results += len(got)
    assert results >= 3


def test_split_generator_carries_and_resets_the_hidden_state():
    _, _, net = _pair(seed=3)
    gen = dg.DeviceGenerator(tg, net, {'observation': True, 'gamma': 0.99,
                                       'compress_steps': 4},
                             n_envs=4, chunk_steps=16, seed=2)
    assert gen.recurrent and [tuple(h.shape) for h in gen.hidden] == [
        (4, 4, 7, 11, 8)] * 2
    static = [h.data_ptr() for h in gen.hidden]
    episodes = []
    for _ in range(8):
        episodes += gen.step_chunk()
        # the static state is updated in place, never replaced
        assert [h.data_ptr() for h in gen.hidden] == static
    episodes += gen.drain_episodes()
    assert len(episodes) >= 1
    rec = gen.records
    last_done = rec['done'][-1]
    for h in gen.hidden:
        assert h.abs().sum() > 0
        assert not h[last_done].any()
    for ep in episodes:
        assert ep['steps'] >= 1 and len(ep['moment']) >= 1


def test_device_actor_plays_recurrent_lanes_in_device_mode():
    """A block of 'g' and 'e' tasks on the recurrent net: 'device' records
    (strict refused for a recurrent net), stamped episodes, results, and a
    batch with burn-in from the episodes."""
    raw = {'env_args': dict(GEESE), 'train_args': {
        'seed': 11, 'turn_based_training': False, 'observation': True,
        'forward_steps': 4, 'burn_in_steps': 2}}
    jta = jax_apply_defaults(copy.deepcopy(raw))['train_args']
    pargs = apply_defaults(copy.deepcopy(raw))
    pta = dict(pargs['train_args'], env=pargs['env_args'])
    assert jta['burn_in_steps'] == pta['burn_in_steps'] == 2
    env = make_env(GEESE)
    env.reset()
    obs0 = env.observation(0)
    snaps = {}

    def fetch(mid):
        if mid not in snaps:
            w = JaxModelWrapper(JaxLSTM(filters=8, stem_layers=1),
                                seed=100 + int(mid))
            w.ensure_params(obs0)
            snaps[mid] = w.snapshot()
        return snaps[mid]

    with pytest.raises(ValueError, match='strict'):
        dg.DeviceActorEngine(tg, ModelVault(fetch, obs0, device='cpu'),
                             make_env(GEESE), pta, n_envs=4, record_mode=
                             'strict', device='cpu')
    eng = dg.DeviceActorEngine(tg, ModelVault(fetch, obs0, device='cpu'),
                               make_env(GEESE), pta, n_envs=6, chunk_steps=16,
                               slots=2, seed=5, device='cpu')
    assert eng.recurrent and eng.record_mode == 'device'
    tasks = [{'role': 'g', 'player': [0, 1, 2, 3],
              'model_id': {p: 1 for p in range(4)}, 'sample_key': k,
              'task_id': k} for k in range(3)]
    tasks += [{'role': 'e', 'player': [k % 4],
               'model_id': {p: (2 if p == k % 4 else -1) for p in range(4)},
               'sample_key': 10 + k, 'task_id': 10 + k,
               'opponent': 'random'} for k in range(2)]
    uploads, deferred = eng.run_block(tasks)
    assert deferred == []
    kinds = [k for k, _ in uploads]
    assert kinds.count('episode') == 3 and kinds.count('result') == 2
    episodes = [p for k, p in uploads if k == 'episode']
    assert all(p is not None and p.get('record_version') == 1
               for p in episodes)
    assert all(h.shape == (6, 4, 7, 11, 8) for h in eng._hidden)
    windows = []
    for ep in episodes:
        st = min(2, ep['steps'] - 1)
        windows.append({'args': ep['args'], 'outcome': ep['outcome'],
                        'moment': ep['moment'], 'base': 0, 'start': 0,
                        'end': min(ep['steps'], st + 4), 'train_start': st,
                        'total': ep['steps']})
    batch = make_batch(windows, pta)
    assert batch['observation'].shape[:2] == (3, 6)


def _learn(tmp_path, extra):
    train = {'turn_based_training': False, 'observation': True,
             'gamma': 0.99, 'forward_steps': 4, 'burn_in_steps': 2,
             'batch_size': 4, 'generation_envs': 4, 'eval_envs': 4,
             'minimum_episodes': 4, 'update_episodes': 4,
             'maximum_episodes': 16, 'epochs': 2, 'num_batchers': 1,
             'device_chunk_steps': 8, 'sgd_steps_per_chunk': 2,
             'policy_target': 'VTRACE', 'value_target': 'VTRACE',
             'eval': {'opponent': ['random', 'rulebase']},
             'model_dir': str(tmp_path / 'models')}
    train.update(extra)
    path = tmp_path / 'cfg.json'
    path.write_text(json.dumps({'env_args': dict(GEESE),
                                'train_args': train}))
    proc = subprocess.run(
        [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config',
         str(path), '--device', 'cpu'], cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS='1'), capture_output=True,
        text=True, timeout=170)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout, json.loads([l for l in proc.stdout.splitlines()
                                    if l.startswith('{')][-1])


@pytest.mark.parametrize('path', ['fused', 'split'])
def test_device_loops_train_a_geesenet_lstm(tmp_path, path):
    extra = {'device_generation': True, 'device_replay': path == 'fused'}
    out, line = _learn(tmp_path, extra)
    assert line['epochs'] == 2 and not line['failed']
    assert line['steps'] > 0 and line['eval_results'] > 0
    if path == 'fused':
        assert line['fused'] is True and '(solo mode)' in out
    else:
        assert line['device_path'] == 'split'
