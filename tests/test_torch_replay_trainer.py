"""The learner's device branches other than the fused loop
(handyrl_tpu_torch/train.py ``Learner._run_batched`` and the threaded
replay trainer ``Trainer._train_replay``), end to end on the CPU, after the
JAX learner's ``_run_batched`` (handyrl_tpu/train.py:2534-2774).

A small GeeseNet (filters 16, 2 blocks, 'pallas' trunk on its plain
version) trains Hungry Geese for 2 epochs (B=4, T=4, 4 envs, 8-ply chunks,
2 update steps a replay dispatch) in each branch:

- split: ``device_generation`` alone, episodes spliced on the host from
  the ``DeviceGenerator``'s chunks, the host trainer;
- ingest: ``device_generation`` and ``device_replay`` with
  ``fused_pipeline: false``, the chunks' records ingested by the trainer
  thread into the windower's ring;
- split with host push: ``device_ingest: false``, the spliced episodes
  windowed on the host and pushed to ``DeviceReplay``;
- host push: ``device_replay`` with the host's batched self-play;
- the turn-based mismatch: ``turn_based_training`` on Hungry Geese with
  both switches, which no ingest layout serves (split, host push).

Each run must close its epochs with finite losses, report its branch, and
write checkpoints that the JAX package verifies and reads: its
``ModelWrapper`` gives the port's forward within 1e-5 (fp32 sums in other
orders) and its ``Trainer.load_state_bytes`` restores the steps and the
params exactly. The replay branches' ``metrics_jsonl`` rows carry the
replay statistics; with ``max_sample_reuse`` every row's samples drawn
stay within cap x windows ingested plus one dispatch; with a cap that no
ingest can meet, each epoch still closes with exactly one dispatch (an
epoch waiting to close is never throttled) and the trainer's wait shows.
The TicTacToe mismatch runs through the CLI with ``--device cpu``; a
``--server`` learner with ``device_generation`` is the worker plane, with
the switch off and its gathers' backend from ``generation.backend``. Both
learners resolve an unset ``replay_windows_per_episode`` from the env
twin's episode length to the same value and ring capacity (F3).
"""

import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu.config import apply_defaults as jax_apply_defaults
from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
from handyrl_tpu.models import build as jax_build
from handyrl_tpu.train import Trainer as JaxTrainer
from handyrl_tpu.utils.fs import verify_checkpoint as jax_verify
from handyrl_tpu_torch.config import apply_defaults
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.model import ModelWrapper, load_params_bytes
from handyrl_tpu_torch.models.geese import GeeseNet, params_from_flax
from handyrl_tpu_torch.train import Learner

pytestmark = pytest.mark.timeout(240)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
B, K = 4, 2
TRAIN = {'turn_based_training': False, 'observation': True, 'gamma': 0.99,
         'forward_steps': 4, 'compress_steps': 4, 'batch_size': B,
         'generation_envs': 4, 'eval_envs': 4, 'num_batchers': 1,
         'minimum_episodes': 4, 'update_episodes': 4, 'epochs': 2,
         'maximum_episodes': 16, 'device_chunk_steps': 8,
         'replay_fused_steps': K}
BRANCHES = {
    'split': ({'device_generation': True}, 'split'),
    'ingest': ({'device_generation': True, 'device_replay': True,
                'fused_pipeline': False, 'max_sample_reuse': 2.0}, 'ingest'),
    'split_host_push': ({'device_generation': True, 'device_replay': True,
                         'device_ingest': False}, 'split'),
    'host_push': ({'device_replay': True}, 'host_push'),
    'turn_mismatch': ({'device_generation': True, 'device_replay': True,
                       'turn_based_training': True}, 'split'),
}
DEVICE_KEYS = ('device_generation', 'device_replay', 'device_chunk_steps',
               'fused_pipeline', 'device_ingest', 'replay_fused_steps',
               'max_sample_reuse')


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    before, omp = torch.get_num_threads(), os.environ.get('OMP_NUM_THREADS')
    torch.set_num_threads(1)
    os.environ['OMP_NUM_THREADS'] = '1'
    yield
    torch.set_num_threads(before)
    if omp is None:
        os.environ.pop('OMP_NUM_THREADS', None)
    else:
        os.environ['OMP_NUM_THREADS'] = omp


def _net(seed=0):
    return GeeseNet(filters=16, layers=2, torus_impl='pallas',
                    generator=torch.Generator().manual_seed(seed))


def _raw(tmp_path, **train):
    return {'env_args': {'env': 'HungryGeese', 'torus_impl': 'pallas'},
            'train_args': dict(TRAIN, model_dir=str(tmp_path / 'models'),
                               metrics_jsonl=str(tmp_path / 'm.jsonl'),
                               **train)}


def _rows(tmp_path):
    with open(tmp_path / 'm.jsonl') as f:
        return [json.loads(line) for line in f]


def _boards(n=12, seed=4):
    env = make_env({'env': 'HungryGeese', 'id': seed})
    rng = np.random.RandomState(seed)
    obs = []
    while len(obs) < n:
        if env.terminal():
            env.reset()
        obs += [env.observation(p) for p in env.turns()]
        env.step({p: int(rng.randint(4)) for p in env.turns()})
    return np.stack(obs[:n])


def _jax_reads_the_checkpoints(models, learner, train_args):
    for name in ('1.ckpt', '2.ckpt', 'latest.ckpt', 'trainer_state.ckpt'):
        assert jax_verify(str(models / name)) == (True, 'ok'), name
    latest = (models / 'latest.ckpt').read_bytes()
    obs = _boards()
    jw = JaxModelWrapper(jax_build('GeeseNet', filters=16, layers=2))
    jw.load_params_bytes(latest, obs[0])
    net = _net(seed=9)
    load_params_bytes(net, latest)
    got = ModelWrapper(net, device='cpu').batch_inference(obs)
    want = jw.batch_inference(obs)
    for k in ('policy', 'value'):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                   atol=TOL, err_msg=k)
    host = {k: v for k, v in train_args.items() if k not in DEVICE_KEYS}
    jt = JaxTrainer(jax_apply_defaults({'env_args': {'env': 'HungryGeese'},
                                        'train_args': host})['train_args'],
                    jw)
    jt.load_state_bytes((models / 'trainer_state.ckpt').read_bytes())
    steps = learner.epoch_steps[-1]
    assert jt.steps == steps and int(jt.state.steps) == steps
    flat = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                   jt.state.params))
    for k, v in flat.items():
        assert torch.equal(v, learner.params[k]), k


@pytest.mark.parametrize('branch', sorted(BRANCHES))
def test_branch_trains_and_the_jax_package_reads_its_checkpoints(
        tmp_path, capsys, branch):
    switches, path = BRANCHES[branch]
    raw = _raw(tmp_path, **switches)
    learner = Learner(apply_defaults(raw), net=_net(), device='cpu')
    learner.run()
    out = capsys.readouterr().out
    assert 'fused device pipeline' not in out
    assert ('device ingest: windows assembled on device (solo mode)'
            in out) == (path == 'ingest')
    line = learner.summary()
    assert not line['failed'] and learner.model_epoch == 2
    assert line['device_path'] == path
    assert line['epochs'] == 2 and len(line['epoch_steps']) == 2
    assert all(math.isfinite(v) for v in line['losses'].values())
    assert line['kernel_launches'] == {}
    if switches.get('device_generation'):
        assert line['generator_dispatches'] >= 2
        assert line['plies']['generation'] == 8 * (
            line['generator_dispatches'] - 1)
    _jax_reads_the_checkpoints(tmp_path / 'models', learner,
                               raw['train_args'])
    rows = _rows(tmp_path)
    assert [r['epoch'] for r in rows] == [1, 2]
    replay = line.get('replay')
    if not switches.get('device_replay'):
        assert replay is None and 'replay_samples_drawn' not in rows[-1]
        return
    tr = learner.trainer
    assert replay['fused_steps'] == K
    assert replay['samples_drawn'] == tr.steps * B
    assert replay['windows_ingested'] > 0
    assert replay['dropped_episodes'] == 0
    assert 0 < replay['ring_occupancy'] <= 1
    assert replay['ring_capacity'] == 16 * 50   # min(16, 4096) * 200 // 4
    for r in rows:
        for key in ('replay_dropped_episodes', 'replay_ring_occupancy',
                    'replay_sample_reuse', 'replay_windows_ingested',
                    'replay_samples_drawn'):
            assert key in r, key
        assert r['replay_samples_drawn'] % (B * K) == 0
    cap = switches.get('max_sample_reuse')
    if cap:
        for r in rows + [{'replay_samples_drawn': replay['samples_drawn'],
                          'replay_windows_ingested':
                              replay['windows_ingested']}]:
            assert (r['replay_samples_drawn']
                    <= cap * r['replay_windows_ingested'] + B * K), r


def test_an_epoch_waiting_to_close_is_never_throttled(tmp_path):
    """A reuse cap no ingest can meet: every dispatch waits except the one
    an epoch needs to close."""
    learner = Learner(apply_defaults(_raw(
        tmp_path, device_generation=True, device_replay=True,
        fused_pipeline=False, max_sample_reuse=1e-6)), net=_net(),
        device='cpu')
    learner.run()
    line = learner.summary()
    assert learner.model_epoch == 2 and not line['failed']
    assert line['epoch_steps'] == [K, 2 * K]
    assert learner.trainer.steps == 2 * K
    assert line['replay']['samples_drawn'] == 2 * K * B
    assert line['trainer_batch_wait_seconds'] > 0
    rows = _rows(tmp_path)
    assert [r['replay_samples_drawn'] for r in rows] == [K * B, 2 * K * B]


def test_tictactoe_mismatch_through_the_cli(tmp_path):
    """TicTacToe with ``turn_based_training: false`` on both device
    switches: no ingest layout, so the split generator and the host push,
    through ``python -m handyrl_tpu_torch.train --device cpu``."""
    config = {'env_args': {'env': 'TicTacToe'},
              'train_args': {'turn_based_training': False, 'batch_size': 8,
                             'forward_steps': 4, 'generation_envs': 8,
                             'minimum_episodes': 8, 'update_episodes': 8,
                             'maximum_episodes': 64, 'epochs': 2,
                             'device_generation': True, 'device_replay': True,
                             'replay_fused_steps': 2, 'device_chunk_steps': 4,
                             'model_dir': str(tmp_path / 'models')}}
    path = tmp_path / 'cfg.json'
    path.write_text(json.dumps(config))
    proc = subprocess.run(
        [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config',
         str(path), '--device', 'cpu'], cwd=REPO, capture_output=True,
        text=True, timeout=200, env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads([l for l in proc.stdout.splitlines()
                       if l.startswith('{')][-1])
    assert line['device_path'] == 'split' and line['epochs'] == 2
    assert line['replay']['windows_ingested'] > 0
    assert (tmp_path / 'models' / '2.ckpt').exists()


def test_server_with_device_generation_names_the_device_actor_gather(
        tmp_path):
    """A ``--server`` learner with ``device_generation`` is the worker
    plane, as in the JAX learner, which reads ``device_generation`` in its
    batched loop only: it builds with the switch resolved off (the replay
    takes the host push) and hands its gathers the backend that
    ``generation.backend`` names, 'device' for a ``DeviceActorGather``."""
    from handyrl_tpu_torch.worker import (WorkerServer,
                                          resolve_generation_backend)
    raw = _raw(tmp_path, device_generation=True, device_replay=True,
               generation={'backend': 'device'})
    learner = Learner(apply_defaults(raw), net=_net(), device='cpu',
                      remote=True)
    try:
        assert isinstance(learner.worker, WorkerServer)
        assert not learner.use_batched_generation
        assert learner.args['device_generation'] is False
        assert learner.trainer.replay is not None
        assert resolve_generation_backend(learner.args) == 'device'
    finally:
        learner.shutdown()


# F3: the replay's windows per episode, resolved by the learner from the
# env twin's episode length when device_replay is on and the value unset
@pytest.mark.parametrize('env_name,forward_steps', [
    ('HungryGeese', 4), ('HungryGeese', 16), ('TicTacToe', 4),
    ('TicTacToe', 16)])
def test_learner_resolves_windows_per_episode_as_the_jax_learner(
        tmp_path, env_name, forward_steps):
    """Both learners on the same config, ``device_replay`` on and
    ``replay_windows_per_episode`` unset: the resolved value
    (max(1, MAX_STEPS // forward_steps), handyrl_tpu/train.py:1212-1224)
    and the ring's capacity are equal exactly."""
    from handyrl_tpu.train import Learner as JaxLearner
    from handyrl_tpu_torch.ops.replay import ring_capacity
    train = {'forward_steps': forward_steps, 'device_replay': True,
             'maximum_episodes': 16, 'batch_size': B,
             'model_dir': str(tmp_path / 'models')}
    jax_net, net = None, None
    if env_name == 'HungryGeese':
        train.update(turn_based_training=False, observation=True)
        jax_net, net = jax_build('GeeseNet', filters=16, layers=2), _net()
    raw = {'env_args': {'env': env_name}, 'train_args': train}
    jax_learner = JaxLearner(jax_apply_defaults(json.loads(json.dumps(raw))),
                             net=jax_net)
    learner = Learner(apply_defaults(json.loads(json.dumps(raw))), net=net,
                      device='cpu')
    try:
        want = jax_learner.args['replay_windows_per_episode']
        assert want == max(1, (200 if env_name == 'HungryGeese' else 9)
                           // forward_steps)
        assert learner.args['replay_windows_per_episode'] == want
        assert (ring_capacity(learner.args) == learner.trainer.replay.capacity
                == jax_learner.trainer.replay.capacity)
    finally:
        learner.shutdown()
