"""The port's checkpoint scorer and north-star driver
(scripts/torch_eval_checkpoints.py, scripts/torch_run_north_star.py)
against the JAX package's scripts/eval_checkpoints.py and
scripts/run_north_star.py, and the evaluator's rescoring surface
(``DeviceEvaluator.flush``/``play``).

The rows: both scorers run on the same model dir of full-width GeeseNet
checkpoints with their device evaluators replaced by one stream of
finished matches drawn from a seed (the port's keeps its own ``flush``
and ``play``), so the same picks, the same drain between checkpoints and
the same games give the same rows, compared exactly (same floats rounded
the same way). A real scorer run on the CPU (the plain trunk, 4 envs)
checks the row format, the summary line and ``--skip-scored``. The
north-star driver runs the JAX ``BASE`` (GeeseNet's trunk on the port's
kernel is the one difference) and resumes from its newest checkpoint."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import handyrl_tpu.device_generation as jax_device_generation
import handyrl_tpu_torch.device_generation as device_generation
from handyrl_tpu_torch.environment import make_device_env
from handyrl_tpu_torch.model import params_bytes
from handyrl_tpu_torch.models.geese import GeeseNet

pytestmark = pytest.mark.timeout(60)   # each test's own limit
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The workers of a parallel test run share the cores: one intra-op
    thread a process keeps these runs' many small ops from waiting on
    descheduled OpenMP threads (tens of times slower without it)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, 'scripts', name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _model_dir(path, epochs):
    """Full-width GeeseNet checkpoints, one seed an epoch."""
    os.makedirs(path, exist_ok=True)
    for e in epochs:
        net = GeeseNet(generator=torch.Generator().manual_seed(e))
        with open(os.path.join(path, '%d.ckpt' % e), 'wb') as f:
            f.write(params_bytes(net))
    return str(path)


class _Matches:
    """Finished matches a chunk, drawn from one seed: the seat that played
    the model and every player's outcome."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)

    def step(self):
        out = []
        for _ in range(self.rng.randint(0, 7)):
            seat = int(self.rng.randint(4))
            res = self.rng.choice([-1.0, -1 / 3, 1 / 3, 1.0], 4)
            out.append({'args': {'role': 'e', 'player': [seat]},
                        'opponent': 'random',
                        'result': {q: float(res[q]) for q in range(4)}})
        return out


class _JaxFake:
    def __init__(self, env_mod, wrapper, args, n_envs, chunk_steps, seed,
                 opponents, **_):
        self.matches = _Matches(seed)

    def step(self):
        return self.matches.step()


class _PortFake(device_generation.DeviceEvaluator):
    """The port's evaluator with its chunks replaced by the same stream;
    ``flush`` and ``play`` are the real ones."""

    def __init__(self, env_mod, net, args, n_envs, chunk_steps, seed,
                 opponents):
        self.env_mod, self.chunk_steps = env_mod, chunk_steps
        self.matches = _Matches(seed)
        self.dispatches = 0
        self._call = None

    def step(self):
        self.dispatches += 1
        return self.matches.step()


def test_rows_match_the_jax_scorer(tmp_path, monkeypatch, capsys):
    models = _model_dir(tmp_path / 'models', [10, 20, 30, 40, 50])
    monkeypatch.setattr(jax_device_generation, 'DeviceEvaluator', _JaxFake)
    monkeypatch.setattr(device_generation, 'DeviceEvaluator', _PortFake)
    jax_scorer = _script('eval_checkpoints')
    port_scorer = _script('torch_eval_checkpoints')
    common = ['--every', '2', '--games', '40', '--envs', '8']
    for opponent in ('random', 'rulebase'):
        jax_out = str(tmp_path / ('jax_%s.jsonl' % opponent))
        port_out = str(tmp_path / ('port_%s.jsonl' % opponent))
        monkeypatch.setattr(sys, 'argv', ['eval_checkpoints.py', models,
                                          'HungryGeese', jax_out, *common,
                                          '--opponent', opponent])
        jax_scorer.main()
        port_scorer.main([models, 'HungryGeese', port_out, *common,
                          '--opponent', opponent, '--device', 'cpu'])
        want = [json.loads(l) for l in open(jax_out)]
        got = [json.loads(l) for l in open(port_out)]
        assert [r['epoch'] for r in want] == [10, 30, 50]
        assert got == want
        assert all(r['games'] >= 40 and r['opponent'] == opponent
                   for r in got)
        # a rerun with --skip-scored scores nothing new, as the JAX one
        port_scorer.main([models, 'HungryGeese', port_out, *common,
                          '--opponent', opponent, '--device', 'cpu',
                          '--skip-scored'])
        assert [json.loads(l) for l in open(port_out)] == want
    capsys.readouterr()


def test_scorer_runs_on_the_cpu(tmp_path, capsys):
    models = _model_dir(tmp_path / 'models', [5, 10])
    out = str(tmp_path / 'curve.jsonl')
    rows = _script('torch_eval_checkpoints').main(
        [models, 'HungryGeese', out, '--every', '1', '--games', '4',
         '--envs', '4', '--opponent', 'rulebase', '--device', 'cpu',
         '--env-args', '{"torus_impl": "pallas"}'])
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == ('evaluating 2 checkpoints of 2 (every 1) from %s'
                          % models)
    assert [json.loads(l) for l in open(out)] == rows
    assert [r['epoch'] for r in rows] == [5, 10]
    for r in rows:
        assert set(r) == {'epoch', 'opponent', 'games', 'win_rate', 'mean'}
        assert r['games'] >= 4 and r['opponent'] == 'rulebase'
        # both rounded to 4 places from the same unrounded mean
        assert abs(r['win_rate'] - (r['mean'] + 1) / 2) <= 1e-4
        assert -1 <= r['mean'] <= 1
    summary = json.loads(printed[-1])
    assert summary['scored'] == 2 and summary['device'] == 'cpu'
    assert summary['kernel_launches'] == {}    # the CPU launches no kernel
    assert summary['rollout_graphs'] == 0 and summary['dispatches'] > 8


def test_scorer_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    models = _model_dir(tmp_path / 'models', [1])
    with pytest.raises(RuntimeError, match='CUDA'):
        _script('torch_eval_checkpoints').main(
            [models, 'HungryGeese', str(tmp_path / 'o.jsonl')])
    assert not (tmp_path / 'o.jsonl').exists()


def test_evaluator_flush_and_play_after_an_in_place_load():
    net = GeeseNet(filters=16, layers=2, torus_impl='pallas',
                   generator=torch.Generator().manual_seed(0))
    env_mod = make_device_env({'env': 'HungryGeese'})
    ev = device_generation.DeviceEvaluator(
        env_mod, net, {}, n_envs=4, chunk_steps=16, seed=1009,
        opponents=['random'])
    first = ev.play(6)
    assert len(first) >= 6 and ev.dispatches >= 2
    ptrs = [p.data_ptr() for p in net.parameters()]
    other = GeeseNet(filters=16, layers=2, torus_impl='pallas',
                     generator=torch.Generator().manual_seed(1))
    net.load_state_dict(other.state_dict())
    assert [p.data_ptr() for p in net.parameters()] == ptrs
    before = ev.dispatches
    assert ev.flush() == env_mod.MAX_STEPS // 16 + 2
    assert ev.dispatches == before + env_mod.MAX_STEPS // 16 + 2
    second = ev.play(6)
    assert len(second) >= 6
    for r in first + second:
        assert r['opponent'] == 'random' and len(r['args']['player']) == 1


def test_north_star_config_is_the_jax_base():
    ours, ref = _script('torch_run_north_star'), _script('run_north_star')
    assert ours.BASE['train_args'] == ref.BASE['train_args']
    assert ours.BASE['env_args'] == dict(ref.BASE['env_args'],
                                         torus_impl='pallas')
    dev = ours.config(False, 600, 'm', 'x.jsonl', 0)['train_args']
    host = ours.config(True, 600, 'm', 'x.jsonl', 0)['train_args']
    # scripts/run_north_star.py:103-111: --host drops the device keys and
    # generates with 16 envs
    want = {k: v for k, v in ref.BASE['train_args'].items()
            if k not in ('device_generation', 'device_replay',
                         'device_chunk_steps', 'eval_envs',
                         'sgd_steps_per_chunk')}
    want['generation_envs'] = 16
    extra = {'model_dir': 'm', 'metrics_jsonl': 'x.jsonl', 'epochs': 600,
             'restart_epoch': 0}
    assert host == dict(want, **extra)
    assert dev == dict(ref.BASE['train_args'], **extra)


def test_north_star_resumes_from_its_newest_checkpoint(tmp_path, monkeypatch,
                                                       capsys):
    ns = _script('torch_run_north_star')
    # BASE cut to a CPU size; the driver's options as given
    monkeypatch.setitem(ns.BASE, 'train_args', dict(
        ns.BASE['train_args'], batch_size=4, forward_steps=4,
        update_episodes=4, minimum_episodes=4, generation_envs=4,
        eval_envs=4, device_chunk_steps=8, sgd_steps_per_chunk=2,
        maximum_episodes=16, checkpoint_interval=2))
    opts = ['--device', 'cpu', '--model-dir', str(tmp_path / 'm'),
            '--metrics-out', str(tmp_path / 'm.jsonl')]
    assert ns.main(['--epochs', '3'] + opts) == 0
    out = capsys.readouterr().out
    assert 'north-star device run: epochs 0->3' in out
    assert ns.main(['--epochs', '4'] + opts) == 0
    out = capsys.readouterr().out
    assert 'north-star device run: epochs 3->4' in out
    assert 'resumed trainer state' in out
    line = json.loads([l for l in out.splitlines()
                       if l.startswith('{"row"')][-1])
    assert line['row'] == 'north-star-torch-device' and line['epochs'] == 4
    rows = [json.loads(l) for l in open(tmp_path / 'm.jsonl')]
    assert [r['epoch'] for r in rows] == [1, 2, 3, 4]
    assert sorted(os.listdir(tmp_path / 'm'))[:6] == [
        '2.ckpt', '2.ckpt.crc', '2.ckpt.layout', '3.ckpt', '3.ckpt.crc',
        '3.ckpt.layout']


def test_curves_script_reads_both_packages_curves(capsys):
    """scripts/torch_north_star_curves.py on the committed curves: the JAX
    run-5 statistics the band cites (mean over points, 4-place rows)."""
    out = _script('torch_north_star_curves').main([])
    capsys.readouterr()
    run5 = out['jax run 5']
    assert run5['random_epoch10'] == 0.9388
    assert abs(run5['random_mean_110_600'] - 0.9815) < 1e-4
    assert abs(run5['rulebase_mean_360_600'] - 0.2835) < 1e-4
    port = out['port']
    assert port['last_epoch'] >= 600 and port['games_per_point'][0] >= 1000
    assert set(port['rulebase_10_160']) == {10, 60, 110, 160}
    run = out['port_run']
    assert run['epochs'] == port['last_epoch'] and run['episodes_per_s'] > 0
