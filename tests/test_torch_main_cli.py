"""``python -m handyrl_tpu_torch MODE [ARGS...] [--config FILE.json]
[--device cuda|cpu]`` (handyrl_tpu_torch/__main__.py), the port's
``main.py``: every mode of the JAX ``main.py`` that the port runs reaches
its entry point with the config's blocks, the arguments and the device;
the modes whose modules are not ported exit 2 naming them; no mode prints
the JAX usage. Then ``--eval`` end to end in a subprocess on the CPU
(and ``python -m handyrl_tpu_torch.evaluation`` with two spawned
runners), and without ``--device cpu`` on a host with no card, its
refusal naming CUDA."""

import json
import os
import subprocess
import sys

import pytest
import torch

import handyrl_tpu_torch
from handyrl_tpu_torch import __main__ as cli
from handyrl_tpu_torch import evaluation, train, worker
from handyrl_tpu_torch.config import ConfigError
from handyrl_tpu_torch.model import params_bytes
from handyrl_tpu_torch.models.tictactoe import SimpleConv2dModel
from handyrl_tpu_torch.serving import fleet, gateway, service

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


CONFIG = {'env_args': {'env': 'HungryGeese', 'torus_impl': 'pallas'},
          'train_args': {'batch_size': 4},
          'worker_args': {'num_parallel': 3}}
# the service's knobs ride in train_args.serving, as in the JAX package's
# config.yaml; the learner's modes take only the learner's keys there
SERVE_CONFIG = {'env_args': CONFIG['env_args'],
                'train_args': {'serving': {'port': 0},
                               'inference': {'max_batch': 8}}}


def write(tmp_path, cfg):
    path = str(tmp_path / 'cfg.json')
    with open(path, 'w') as f:
        json.dump(cfg, f)
    return path


@pytest.fixture
def config(tmp_path):
    return write(tmp_path, CONFIG)


@pytest.fixture
def calls(monkeypatch):
    """Every entry point replaced by a recorder returning 0."""
    seen = []

    def recorder(name):
        def entry(*args, **kwargs):
            seen.append((name, args, kwargs))
            return 0
        return entry
    for module, name in ((train, 'train_main'), (worker, 'worker_main'),
                         (evaluation, 'eval_main'),
                         (evaluation, 'eval_server_main'),
                         (evaluation, 'eval_client_main'),
                         (service, 'serve_main'),
                         (fleet, 'resolver_main'),
                         (gateway, 'gateway_main')):
        monkeypatch.setattr(module, name, recorder(name))
    return seen


@pytest.mark.parametrize('mode', ['--train', '-t', '--train-server', '-ts'])
def test_training_modes_reach_train_main(mode, config, calls):
    assert cli.main([mode, '--config', config, '--device', 'cpu']) == 0
    [(name, (args, device), kwargs)] = calls
    assert name == 'train_main' and device == 'cpu'
    assert kwargs == {'server': mode in ('--train-server', '-ts')}
    assert args['env_args'] == CONFIG['env_args']
    assert args['train_args']['batch_size'] == 4


@pytest.mark.parametrize('mode', ['--worker', '-w'])
def test_worker_mode_reaches_worker_main(mode, config, calls):
    assert cli.main([mode, '5', '--config=' + config, '--device=cpu']) == 0
    [(name, (args, argv), _)] = calls
    assert name == 'worker_main' and argv == ['5']
    assert args['worker_args']['num_parallel'] == 3
    assert args['worker_args']['device'] == 'cpu'


@pytest.mark.parametrize('mode,entry,argv', [
    ('--eval', 'eval_main', ['m.ckpt:random', '4', '2']),
    ('-e', 'eval_main', []),
    ('--eval-server', 'eval_server_main', ['8', '1']),
    ('-es', 'eval_server_main', ['3']),
    ('--eval-client', 'eval_client_main', ['m.ckpt', '127.0.0.1']),
    ('-ec', 'eval_client_main', ['m.ckpt'])])
def test_eval_modes_reach_their_entry_points(mode, entry, argv, config,
                                             calls):
    assert cli.main(['--device', 'cpu', mode] + argv
                    + ['--config', config]) == 0
    [(name, (args, got_argv), kwargs)] = calls
    assert name == entry and got_argv == argv
    assert args['env_args'] == CONFIG['env_args']
    # the eval server loads no model: it is given no device
    assert kwargs == ({} if entry == 'eval_server_main'
                      else {'device': 'cpu'})


@pytest.mark.parametrize('mode', ['--serve', '-sv'])
def test_serve_mode_reaches_serve_main(mode, tmp_path, calls):
    config = write(tmp_path, SERVE_CONFIG)
    assert cli.main([mode, '--config', config, '--device', 'cpu']) == 0
    [(name, (args,), kwargs)] = calls
    assert name == 'serve_main' and kwargs == {'device': 'cpu'}
    assert args['env'] == CONFIG['env_args']
    assert args['serving']['port'] == 0
    assert args['serving']['registry_dir'] == 'models'   # the default
    assert args['inference']['max_batch'] == 8


def test_without_a_config_the_env_is_tictactoe(calls):
    assert cli.main(['--eval-server']) == 0
    assert calls[0][1][0]['env_args'] == {'env': 'TicTacToe'}


@pytest.mark.parametrize('mode,module', [
    ('--serve-fleet', 'serving/fleet.py'), ('-sf', 'serving/fleet.py'),
    ('--gateway', 'serving/gateway.py'), ('-gw', 'serving/gateway.py'),
    ('--status', 'status_main')])
def test_modes_not_ported_exit_naming_their_module(mode, module, calls,
                                                   capsys):
    """Every mode of the JAX ``main.py`` is ported: the fleet's and the
    gateway's reach their mains, and ``--status`` (since telemetry,
    ROADMAP.md §1 item 4a) reaches ``telemetry.status_main``, which on a
    port nothing listens on exits 1 with the JAX package's line."""
    if mode != '--status':
        assert cli.main([mode]) == 0
        [(name, _args, _kwargs)] = calls
        assert name == {'serving/fleet.py': 'resolver_main',
                        'serving/gateway.py': 'gateway_main'}[module]
        return
    import socket
    from handyrl_tpu import telemetry as jax_telemetry
    with socket.socket() as s:      # a port that was free a moment ago
        s.bind(('127.0.0.1', 0))
        target = '127.0.0.1:%d' % s.getsockname()[1]
    assert cli.main([mode, target]) == 1
    got = capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        jax_telemetry.status_main(None, [target])
    assert exc.value.code == 1
    want = capsys.readouterr().out
    assert got == want and got.startswith('status fetch from %s failed'
                                          % target)
    assert calls == []


FLEET_CONFIG = {
    'env_args': CONFIG['env_args'],
    'train_args': {'model_dir': 'runs/a', 'seed': 7,
                   'league': {'k_factor': 16.0},
                   'serving': {'fleet': {'port': 0, 'replicas': 3},
                               'gateway': {'resolver': '127.0.0.1:9411',
                                           'workers': 2}},
                   'inference': {'max_batch': 8}}}


@pytest.mark.parametrize('mode', ['--serve-fleet', '-sf'])
def test_serve_fleet_reaches_resolver_main(mode, tmp_path, calls):
    config = write(tmp_path, FLEET_CONFIG)
    assert cli.main([mode, '--config', config, '--device', 'cpu']) == 0
    [(name, (args,), kwargs)] = calls
    assert name == 'resolver_main' and kwargs == {'device': 'cpu'}
    assert args['env'] == CONFIG['env_args']
    assert args['serving']['fleet']['replicas'] == 3
    assert args['serving']['fleet']['heartbeat_timeout'] == 10.0  # default
    assert args['serving']['registry_dir'] == 'runs/a'   # the learner's
    assert args['inference']['max_batch'] == 8
    # without --device the replicas run on the card
    calls.clear()
    assert cli.main([mode, '--config', config]) == 0
    assert calls[0][2] == {'device': 'cuda'}


@pytest.mark.parametrize('mode', ['--gateway', '-gw'])
def test_gateway_reaches_gateway_main(mode, tmp_path, calls):
    config = write(tmp_path, FLEET_CONFIG)
    assert cli.main([mode, '--config', config, '--device', 'cpu']) == 0
    [(name, (args,), kwargs)] = calls
    assert name == 'gateway_main' and kwargs == {}
    assert args['serving']['gateway']['resolver'] == '127.0.0.1:9411'
    assert args['serving']['gateway']['workers'] == 2
    assert args['serving']['gateway']['max_sessions'] == 64   # default
    assert args['seed'] == 7 and args['league'] == {'k_factor': 16.0}
    assert args['serving']['registry_dir'] == 'runs/a'


def test_serving_modes_refuse_an_exporter_port(tmp_path, calls):
    """An exporter port reaches the gateway (the serving tier's
    telemetry is ported), with the config's telemetry block; one out of
    range is refused with the JAX message."""
    tel = {'trace_dir': 'traces', 'alerts': {'interval': 1.0}}
    cfg = {'env_args': CONFIG['env_args'],
           'train_args': {'serving': {'gateway': {'metrics_port': 9100}},
                          'telemetry': tel}}
    assert cli.main(['--gateway', '--config', write(tmp_path, cfg)]) == 0
    [(name, (args,), _kwargs)] = calls
    assert name == 'gateway_main'
    assert args['serving']['gateway']['metrics_port'] == 9100
    assert args['telemetry'] == tel
    calls.clear()
    cfg['train_args']['serving']['gateway']['metrics_port'] = 70000
    with pytest.raises(ConfigError,
                       match='gateway.metrics_port must be a TCP port'):
        cli.main(['--gateway', '--config', write(tmp_path, cfg)])
    assert calls == []


def test_no_mode_prints_the_jax_usage(capsys, calls):
    assert cli.main([]) == 1
    out = capsys.readouterr().out
    assert out.strip() == cli.USAGE.strip()
    for mode in ('--eval-server, -es', '--eval-client, -ec', '--serve, -sv'):
        assert mode in out
    assert cli.main(['--bogus']) == 1
    assert 'Not found mode --bogus.' in capsys.readouterr().out


def test_eval_through_python_m_on_the_cpu(tmp_path):
    torch.manual_seed(2)
    ckpt = str(tmp_path / 'ttt.ckpt')
    with open(ckpt, 'wb') as f:
        f.write(params_bytes(SimpleConv2dModel()))
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.dirname(handyrl_tpu_torch.__file__)))
    proc = subprocess.run(
        [sys.executable, '-m', 'handyrl_tpu_torch', '--eval', ckpt, '2',
         '--device', 'cpu'], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for line in ('1 process, 2 games', 'total games = 2', '---agent 0---',
                 '---agent 1---'):
        assert line in proc.stdout
    # the module's own CLI with two spawned runners, which find their
    # entry point by the module's name
    proc = subprocess.run(
        [sys.executable, '-m', 'handyrl_tpu_torch.evaluation', ckpt, '2',
         '2', '--device', 'cpu'], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert '2 process, 2 games' in proc.stdout
    assert proc.stdout.count('*** Game') == 2
    proc = subprocess.run(
        [sys.executable, '-m', 'handyrl_tpu_torch', '-e', ckpt, '2'],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=120,
        env=dict(env, CUDA_VISIBLE_DEVICES=''))
    assert proc.returncode != 0 and 'CUDA' in proc.stderr
    assert 'total games' not in proc.stdout


def test_eval_client_without_a_card_names_cuda(monkeypatch):
    """The client refuses before it connects: its children would play on
    the card."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setattr(evaluation, 'connect_socket_connection', None)
    with pytest.raises(RuntimeError, match='CUDA'):
        evaluation.eval_client_main({}, ['m.ckpt', '127.0.0.1'])
