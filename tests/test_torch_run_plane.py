"""The learner's run plane in the port (handyrl_tpu_torch/train.py) against
the JAX package's (handyrl_tpu/train.py:1155-1202,1369-1379,1588-1680,
1834-1935,2378-2496): the metrics rows, the wall-clock budget, checkpoint
retention, the registry publish hook, the ``init_params`` warm start, the
chaos NaN drills, and the config keys that switch them.

In process on the CPU, at a small size: a GeeseNet of 16 filters and 2
blocks on the fused loop (B=4, T=4, 4 envs, 8-ply chunks, 2 SGD steps a
chunk) or the host loop, and TicTacToe's net on the host loop. Every
metrics line passes the JAX package's ``telemetry.validate_metrics_line``
and carries the keys of the JAX rows that the port has the planes for
(named below beside the JAX lines); the planes it lacks are named and
must be absent. The warm start is held bit for bit (a load copies
float32 values); the published version's forward in the JAX package
within 1e-5 of the port's (fp32 sums in other orders through 2 blocks).
Counts (non-finite updates, files kept) are exact."""

import json
import os
import time

import numpy as np
import pytest
import torch

from handyrl_tpu.config import TRAIN_DEFAULTS as JAX_TRAIN_DEFAULTS
from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
from handyrl_tpu.models import build as jax_build
from handyrl_tpu.serving.registry import ModelRegistry as JaxModelRegistry
from handyrl_tpu.telemetry import validate_metrics_line
from handyrl_tpu_torch.config import ConfigError, apply_defaults
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.model import ModelWrapper
from handyrl_tpu_torch.models.geese import GeeseNet, params_from_flax
from handyrl_tpu_torch.serving.registry import ModelRegistry
from handyrl_tpu_torch.train import Learner
from handyrl_tpu_torch.utils.fs import (checksummed_write_bytes,
                                        sidecar_path, verify_checkpoint)

pytestmark = pytest.mark.timeout(60)   # each test's own limit
TOL = 1e-5
K = 2
FUSED = {'turn_based_training': False, 'observation': True, 'gamma': 0.99,
         'forward_steps': 4, 'batch_size': 4,
         'policy_target': 'VTRACE', 'value_target': 'VTRACE',
         'generation_envs': 4, 'eval_envs': 4, 'minimum_episodes': 4,
         'update_episodes': 4, 'epochs': 2, 'maximum_episodes': 16,
         'device_generation': True, 'device_replay': True,
         'device_chunk_steps': 8, 'sgd_steps_per_chunk': K,
         'eval': {'opponent': ['random', 'rulebase']}}
HOST = {'batch_size': 8, 'forward_steps': 8, 'generation_envs': 8,
        'num_batchers': 1, 'minimum_episodes': 12, 'update_episodes': 12,
        'epochs': 2}
# the keys of handyrl_tpu/train.py _write_metrics that every port row has
# (:2381-2385 the schema and rates, :2448-2450 the guard, :2478 the
# telemetry summary), the fused loop's (:2432-2437 the replay, :2997 the
# dispatches) and those of epochs with results (:2388-2405 generation and
# evaluation, :2424-2431 the trailing window)
ROW_KEYS = ('epoch', 'steps', 'episodes', 'time', 'run_id', 'telemetry',
            'sgd_steps_per_sec', 'buffer', 'guard_nonfinite',
            'guard_rollbacks', 'guard_bad_episodes', 'alerts')
FUSED_ROW_KEYS = ('replay_dropped_episodes', 'replay_ring_occupancy',
                  'replay_sample_reuse', 'dispatches_gen', 'dispatches_eval')
RESULT_KEYS = ('generation_mean', 'win_rate', 'eval_opponents',
               'win_rate_recent10', 'eval_games_recent10')
# the learning dynamics (:2442, :950-985), from the diag metrics
DYNAMICS_KEYS = ('entropy', 'rho_clip_fraction', 'c_clip_fraction',
                 'importance_ratio_mean', 'importance_ratio_std',
                 'grad_norm')
# keys absent from these rows: the league's block (:2406-2422), which a
# row has with league.enabled alone, as in the reference; the fleet's
# (:2468-2471, :2479-2481), which a worker-plane row has; and names that
# are gauges in the registry summary, never row keys (:2333, :2458). The
# alert block (:2484-2486) rides every row since telemetry was ported
ABSENT_KEYS = ('league', 'lag_mean', 'policy_lag_mean', 'fleet_telemetry',
               'fleet_hosts', 'device_mem_utilization')


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The workers of a parallel test run share the cores: one intra-op
    thread a process keeps these runs' many small ops from waiting on
    descheduled OpenMP threads (tens of times slower without it)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _geese(model_dir, **train):
    ta = dict(FUSED, model_dir=str(model_dir))
    ta.update(train)
    return apply_defaults({'env_args': {'env': 'HungryGeese',
                                        'torus_impl': 'pallas'},
                           'train_args': ta})


def _tictactoe(model_dir, **train):
    ta = dict(HOST, model_dir=str(model_dir))
    ta.update(train)
    return apply_defaults({'env_args': {'env': 'TicTacToe'},
                           'train_args': ta})


def _net(seed=0, torus_impl='pallas'):
    return GeeseNet(filters=16, layers=2, torus_impl=torus_impl,
                    generator=torch.Generator().manual_seed(seed))


def _rows(path):
    with open(path) as f:
        return [validate_metrics_line(l) for l in f if l.strip()]


def _ckpts(model_dir):
    return sorted(int(n.split('.')[0]) for n in os.listdir(model_dir)
                  if n.endswith('.ckpt') and n.split('.')[0].isdigit())


# ------------------------------------------------------------------ config

def test_run_plane_keys_take_the_jax_defaults():
    ta = apply_defaults({'env_args': {'env': 'HungryGeese'}})['train_args']
    for key in ('metrics_jsonl', 'keep_checkpoints', 'init_params'):
        assert ta[key] == JAX_TRAIN_DEFAULTS[key], key
    assert ta['guard']['preempt_signals'] is JAX_TRAIN_DEFAULTS['guard'][
        'preempt_signals'] is True
    for key in ('publish', 'line', 'auto_promote', 'registry_dir'):
        assert ta['serving'][key] == JAX_TRAIN_DEFAULTS['serving'][key], key
    over = apply_defaults({'env_args': {'env': 'HungryGeese'}, 'train_args': {
        'metrics_jsonl': 'm.jsonl', 'keep_checkpoints': 3,
        'init_params': 'x.ckpt', 'guard': {'preempt_signals': False},
        'serving': {'publish': True, 'line': 'geese',
                    'registry_dir': 'reg'}}})['train_args']
    assert over['serving'] == {'publish': True, 'line': 'geese',
                               'registry_dir': 'reg', 'auto_promote': True,
                               'endpoint': '', 'metrics_port': 0,
                               'fleet': JAX_TRAIN_DEFAULTS['serving'][
                                   'fleet'],
                               'gateway': JAX_TRAIN_DEFAULTS['serving'][
                                   'gateway']}
    assert over['guard']['preempt_signals'] is False
    assert over['guard']['nonfinite_policy'] == 'rollback'


@pytest.mark.parametrize('train_args,key', [
    ({'keep_checkpoints': -1}, 'keep_checkpoints'),
    ({'serving': {'port': 0}}, 'serving keys'),
    ({'serving': {'line': ''}}, 'serving.line'),
    ({'metrics_rotate_mb': 4}, 'metrics_rotate_mb'),
])
def test_validate_rejects_what_the_run_plane_does_not_take(train_args, key):
    with pytest.raises(ConfigError, match=key):
        apply_defaults({'env_args': {'env': 'HungryGeese'},
                        'train_args': train_args})


# ------------------------------------------------------------ metrics rows

def test_metrics_rows_of_the_fused_loop(tmp_path):
    path = str(tmp_path / 'm.jsonl')
    learner = Learner(_geese(tmp_path / 'models', epochs=3,
                             metrics_jsonl=path), net=_net(), device='cpu')
    seen = []   # the results as each row was written (later ones land late)
    write = learner._write_metrics

    def record(*a, **k):
        seen.append(dict(learner.results))
        write(*a, **k)
    learner._write_metrics = record
    learner.run()
    rows = _rows(path)
    assert [r['epoch'] for r in rows] == [1, 2, 3]
    for r in rows:
        for k in ROW_KEYS + FUSED_ROW_KEYS:
            assert k in r, k
        for k in ABSENT_KEYS:
            assert k not in r, k
        assert r['buffer'] == 0 and r['replay_dropped_episodes'] == 0
        assert 0 < r['replay_ring_occupancy'] <= 1
        assert r['telemetry']['gauges']['learner_epoch'] == r['epoch']
        assert r['guard_nonfinite'] == r['guard_rollbacks'] == 0
    assert [r['steps'] for r in rows] == learner.epoch_steps
    assert len({r['run_id'] for r in rows}) == 1
    for k in RESULT_KEYS:
        assert any(k in r for r in rows), k
    # the first epoch's metrics arrive one dispatch late, after its close
    for k in DYNAMICS_KEYS:
        assert k in rows[-1], k
    assert rows[-1]['dispatches_gen'] == learner._fused.dispatches
    # the row of an epoch reads the closed epoch's results, as the JAX row
    for r, results in zip(rows, seen):
        if 'win_rate' in r:
            n, s, _ = results[r['epoch'] - 1]
            assert r['win_rate'] == pytest.approx((s / (n + 1e-6) + 1) / 2)
            assert sum(v['games'] for v in r['eval_opponents'].values()) == n


def test_metrics_rows_of_the_host_loop(tmp_path):
    path = str(tmp_path / 'm.jsonl')
    learner = Learner(_tictactoe(tmp_path / 'models', metrics_jsonl=path),
                      device='cpu')
    learner.run()
    rows = _rows(path)
    assert [r['epoch'] for r in rows] == [1, 2]
    for r in rows:
        for k in ROW_KEYS + ('entropy', 'grad_norm'):
            assert k in r, k
        for k in FUSED_ROW_KEYS + ABSENT_KEYS:
            assert k not in r, k
        assert r['sgd_steps_per_sec'] > 0 and r['buffer'] > 0
    assert [r['steps'] for r in rows] == learner.epoch_steps


# ------------------------------------------------------- wall-clock budget

@pytest.mark.parametrize('loop', ['fused', 'host'])
def test_deadline_stops_at_an_epoch_boundary_with_a_final_checkpoint(
        tmp_path, monkeypatch, loop):
    monkeypatch.setenv('HANDYRL_TPU_DEADLINE', str(time.time() + 3600))
    models = tmp_path / 'models'
    path = str(tmp_path / 'm.jsonl')
    if loop == 'fused':
        learner = Learner(_geese(models, epochs=50, checkpoint_interval=5,
                                 metrics_jsonl=path), net=_net(),
                          device='cpu')
    else:
        learner = Learner(_tictactoe(models, epochs=50, metrics_jsonl=path),
                          device='cpu')
    assert learner._deadline == float(os.environ['HANDYRL_TPU_DEADLINE'])
    assert not learner._past_epoch_budget()
    write = learner._write_metrics

    def spend_budget(*a, **k):   # the budget runs out in epoch 1's close
        write(*a, **k)
        learner._deadline = time.time() - 1
    learner._write_metrics = spend_budget
    learner.run()
    assert learner.model_epoch == 1 and learner._past_epoch_budget()
    assert _ckpts(models) == [1]
    steps = learner.epoch_steps[-1]
    assert learner._last_ckpt_steps == steps > 0
    if loop == 'fused':   # the host trainer may step on until its shutdown
        assert learner.trainer.steps == steps
    assert verify_checkpoint(str(models / 'trainer_state.ckpt')) == (True,
                                                                     'ok')
    assert (models / 'latest.ckpt').read_bytes() == (models /
                                                     '1.ckpt').read_bytes()
    assert [r['epoch'] for r in _rows(path)] == [1]


# -------------------------------------------------------------- retention

def _fake_checkpoints(models, epochs):
    os.makedirs(models, exist_ok=True)
    for e in epochs:
        checksummed_write_bytes(os.path.join(models, '%d.ckpt' % e),
                                b'epoch %d' % e)


def test_keep_checkpoints_spares_pins_and_opponents_and_takes_sidecars(
        tmp_path):
    models = str(tmp_path / 'models')
    opponent = os.path.join(models, '3.ckpt')
    learner = Learner(_geese(models, keep_checkpoints=2,
                             eval={'opponent': [opponent]}),
                      net=_net(), device='cpu')
    _fake_checkpoints(models, range(1, 7))
    ModelRegistry(models).publish('default', path=os.path.join(models,
                                                               '2.ckpt'),
                                  architecture='GeeseNet', version=2)
    learner._gc_checkpoints()
    assert _ckpts(models) == [2, 3, 5, 6]
    for e in (1, 4):
        assert not os.path.exists(sidecar_path(os.path.join(models,
                                                            '%d.ckpt' % e)))
    for e in (2, 3, 5, 6):
        assert verify_checkpoint(os.path.join(models, '%d.ckpt' % e)) == (
            True, 'ok')


def test_keep_checkpoints_suspends_on_an_unreadable_manifest(tmp_path):
    models = str(tmp_path / 'models')
    learner = Learner(_geese(models, keep_checkpoints=1), net=_net(),
                      device='cpu')
    _fake_checkpoints(models, range(1, 5))
    with open(os.path.join(models, 'registry.json'), 'w') as f:
        f.write('{not json')
    learner._gc_checkpoints()
    assert _ckpts(models) == [1, 2, 3, 4]


def test_keep_checkpoints_in_a_run(tmp_path):
    models = tmp_path / 'models'
    Learner(_geese(models, epochs=4, keep_checkpoints=2), net=_net(),
            device='cpu').run()
    assert _ckpts(models) == [3, 4]
    assert sorted(os.listdir(models)) == sorted(
        ['3.ckpt', '3.ckpt.crc', '4.ckpt', '4.ckpt.crc', 'latest.ckpt',
         'latest.ckpt.crc', 'trainer_state.ckpt', 'trainer_state.ckpt.crc'])


# ---------------------------------------------------------------- publish

def _boards(n=8, seed=4):
    env = make_env({'env': 'HungryGeese', 'id': seed})
    rng = np.random.RandomState(seed)
    obs = []
    while len(obs) < n:
        if env.terminal():
            env.reset()
        obs += [env.observation(p) for p in env.turns()]
        env.step({p: int(rng.randint(4)) for p in env.turns()})
    return np.stack(obs[:n])


def test_published_versions_are_read_by_the_jax_registry(tmp_path):
    models, root = tmp_path / 'models', str(tmp_path / 'registry')
    learner = Learner(_geese(models, keep_checkpoints=1, serving={
        'publish': True, 'line': 'geese', 'registry_dir': root}),
        net=_net(torus_impl='pad'), device='cpu')
    learner.run()
    reg = JaxModelRegistry(root)
    line = reg.describe()['geese']
    assert sorted(line['versions']) == ['1', '2']
    assert line['champion'] == '2' and line['previous'] == '1'
    # every version is pinned: the retention GC kept both files
    assert _ckpts(models) == [1, 2]
    snap = reg.load_snapshot('geese')
    assert snap['params'] == (models / '2.ckpt').read_bytes()
    assert snap['architecture'] == 'GeeseNet'
    assert line['versions']['2']['steps'] == learner.trainer.steps
    obs = _boards()
    want = JaxModelWrapper.from_snapshot(snap, obs[0]).batch_inference(obs)
    got = ModelWrapper.from_snapshot(
        ModelRegistry(root).load_snapshot('geese'),
        device='cpu').batch_inference(obs)
    for k in ('policy', 'value'):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                   atol=TOL, err_msg=k)


def test_a_registry_failure_does_not_stop_training(tmp_path):
    blocker = tmp_path / 'not_a_dir'
    blocker.write_text('a file where the registry root should be')
    learner = Learner(_geese(tmp_path / 'models', serving={
        'publish': True, 'registry_dir': str(blocker)}), net=_net(),
        device='cpu')
    learner.run()
    assert learner.model_epoch == 2 and not learner.trainer.failed
    assert _ckpts(tmp_path / 'models') == [1, 2]


# ------------------------------------------------------------- warm start

def test_init_params_warm_starts_from_a_jax_checkpoint(tmp_path, capsys):
    obs = _boards()
    jw = JaxModelWrapper(jax_build('GeeseNet', filters=16, layers=2), seed=3)
    jw.ensure_params(obs[0])
    ckpt = tmp_path / 'jax.ckpt'
    ckpt.write_bytes(jw.params_bytes())
    learner = Learner(_geese(tmp_path / 'models', init_params=str(ckpt)),
                      net=_net(seed=9), device='cpu')
    assert 'warm-started params from %s' % ckpt in capsys.readouterr().out
    want = params_from_flax(jw.params['params'])
    state = learner.trainer.update_step.state
    assert learner.model_epoch == 0 and learner.trainer.steps == 0
    assert int(state.steps) == 0 and int(state.opt_state.count) == 0
    for k, v in want.items():
        assert torch.equal(state.params[k].detach(), v), k
        assert torch.equal(learner.params[k], v), k
        assert torch.equal(dict(learner.actor.module.named_parameters())[k]
                           .detach(), v), k
        assert not state.opt_state.mu[k].any() and \
            not state.opt_state.nu[k].any(), k


# ------------------------------------------------------------ chaos drills

@pytest.mark.parametrize('loop,chaos', [
    ('fused', 'nanstep=0,nanburst=2'), ('fused', 'nanepoch=1,nanburst=2'),
    ('host', 'nanstep=3,nanburst=2'), ('host', 'nanepoch=1,nanburst=2')])
def test_chaos_nan_updates_are_skipped_and_counted(tmp_path, monkeypatch,
                                                   loop, chaos):
    monkeypatch.setenv('HANDYRL_TPU_CHAOS', chaos)
    path = str(tmp_path / 'm.jsonl')
    guard = {'nonfinite_policy': 'skip'}
    if loop == 'fused':
        learner = Learner(_geese(tmp_path / 'models', epochs=4, guard=guard,
                                 metrics_jsonl=path), net=_net(),
                          device='cpu')
    else:
        learner = Learner(_tictactoe(tmp_path / 'models', epochs=3,
                                     guard=guard, metrics_jsonl=path),
                          device='cpu')
    learner.run()
    assert learner.trainer.guard.total_bad == 2
    assert learner.trainer.chaos_nan.remaining <= 0
    rows = _rows(path)
    assert rows[-1]['guard_nonfinite'] == 2
    assert rows[-1]['guard_rollbacks'] == 0
    if chaos.startswith('nanepoch'):
        assert rows[0]['guard_nonfinite'] == 0   # armed at epoch 1's close
    for v in learner.params.values():
        assert torch.isfinite(v).all()
