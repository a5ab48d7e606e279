"""The network battle protocol of handyrl_tpu_torch/evaluation.py
(``NetworkAgentClient``, ``NetworkAgent``, ``_WireSeat``,
``exec_network_match``, ``network_match_acception``) against the JAX
package's, over localhost TCP on free ports, clients in threads.

Each battle is one group of clients playing two games from a fixed
``random`` seed through the server's env, with the server and the
clients of either package (port-port, JAX server with port clients, port
server with JAX clients). Every seat is a greedy ``Agent`` over one set of
weights: a narrow GeeseNet (filters 16, 2 blocks; the JAX side its 'pad'
trunk, the port its 'pallas' trunk, whose plain version runs on the CPU)
or TicTacToe's full-width SimpleConv2dModel, carried across from Flax
with ``params_from_flax``. The moves of every ply and the outcomes must
equal the JAX ``exec_match`` of the same agents from the same seed, the
wire carrying the Geese ``diff_info``'s int-keyed ``last_actions`` both
ways; the two packages' logits on the game's observations within 1e-5
(fp32 forwards of the same weights summed in other orders: the greedy
moves agree because no ply of these games has a near-tie)."""

import os
import random
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu import agent as jax_agent
from handyrl_tpu import connection as jax_connection
from handyrl_tpu import evaluation as jax_eval
from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
from handyrl_tpu.models import build as jax_build
from handyrl_tpu_torch import agent, connection, evaluation
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.model import ModelWrapper
from handyrl_tpu_torch.models import geese, tictactoe


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


TOL = 1e-5
SEED = 11
GAMES = 2
PACKAGES = {
    'port': dict(eval=evaluation, make_env=make_env, agent=agent.Agent,
                 connect=connection.connect_socket_connection),
    'jax': dict(eval=jax_eval, make_env=jax_make_env, agent=jax_agent.Agent,
                connect=jax_connection.connect_socket_connection),
}
_CACHE = {}


def free_port():
    s = socket.socket()
    s.bind(('', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def models(env_name):
    """{'jax': JAX wrapper, 'port': port wrapper} of the same weights."""
    if env_name not in _CACHE:
        obs = jax_make_env({'env': env_name}).observation(0)
        if env_name == 'HungryGeese':
            # weights whose greedy geese live 80 plies (most seeds' die
            # within a few)
            jw = JaxModelWrapper(jax_build('GeeseNet', filters=16, layers=2),
                                 seed=1)
            net = geese.GeeseNet(filters=16, layers=2, torus_impl='pallas')
            from_flax = geese.params_from_flax
        else:
            jw = JaxModelWrapper(jax_build('SimpleConv2dModel'), seed=4)
            net = tictactoe.SimpleConv2dModel()
            from_flax = tictactoe.params_from_flax
        jw.ensure_params(obs)
        net.load_state_dict(from_flax(
            jax.tree_util.tree_map(np.asarray, jw.params)))
        _CACHE[env_name] = {'jax': jw, 'port': ModelWrapper(net, 'cpu')}
    return _CACHE[env_name]


def recording(env, plies):
    """``env`` with its ``step`` recording each ply's moves and every
    player's observation before it."""
    step = env.step

    def recorded(moves):
        plies.append((dict(moves), [env.observation(p)
                                    for p in env.players()]))
        return step(moves)
    env.step = recorded
    return env


def reference_games(env_name):
    """The JAX ``exec_match`` of the greedy agents: [(plies, result)]."""
    pkg = PACKAGES['jax']
    model = models(env_name)['jax']
    random.seed(SEED)
    games = []
    for _ in range(GAMES):
        plies = []
        env = recording(pkg['make_env']({'env': env_name}), plies)
        agents = {p: pkg['agent'](model) for p in env.players()}
        result = pkg['eval'].exec_match(env, agents)
        games.append((plies, result['result']))
    return games


def client(pkg_name, env_name, port, done):
    pkg = PACKAGES[pkg_name]
    conn = None
    for _ in range(100):   # until the server's listener is bound
        try:
            conn = pkg['connect']('localhost', port)
            break
        except OSError:
            time.sleep(0.05)
    env = pkg['make_env'](conn.recv())
    runner = pkg['eval'].NetworkAgentClient(
        pkg['agent'](models(env_name)[pkg_name]), env, conn)
    runner.run()
    done.append(runner)


def network_games(server, clients, env_name):
    """One group of ``clients``-package clients in threads playing GAMES
    games through the ``server`` package's env: ([(plies, result)], the
    clients' ``NetworkAgentClient`` objects)."""
    pkg = PACKAGES[server]
    port = free_port()
    n = len(pkg['make_env']({'env': env_name}).players())
    done = []
    threads = [threading.Thread(target=client, daemon=True,
                                args=(clients, env_name, port, done))
               for _ in range(n)]
    for t in threads:
        t.start()
    group = pkg['eval'].network_match_acception(1, {'env': env_name}, n,
                                                port)[0]
    random.seed(SEED)
    games = []
    try:
        for _ in range(GAMES):
            plies = []
            env = recording(pkg['make_env']({'env': env_name}), plies)
            result = pkg['eval'].exec_network_match(
                env, {p: group[i] for i, p in enumerate(env.players())})
            games.append((plies, result['result']))
    finally:
        for a in group:
            a.conn.close()   # the clients end on the reset
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert len(done) == n
    return games, done


@pytest.mark.parametrize('env_name', ['TicTacToe', 'HungryGeese'])
@pytest.mark.parametrize('server,clients', [('port', 'port'),
                                            ('jax', 'port'),
                                            ('port', 'jax')])
def test_network_match_equals_the_jax_exec_match(server, clients, env_name):
    want = reference_games(env_name)
    got, runners = network_games(server, clients, env_name)
    assert len(got) == len(want) == GAMES
    for (g_plies, g_result), (w_plies, w_result) in zip(got, want):
        assert [m for m, _ in g_plies] == [m for m, _ in w_plies]
        assert g_result == w_result
        if env_name == 'TicTacToe':
            assert sum(g_result.values()) == 0   # zero-sum
    if clients == 'port':   # each client kept its seat's outcomes
        assert all(len(r.outcomes) == GAMES for r in runners)
    assert sum(len(p) for p, _ in got) >= 5 * GAMES
    # the two forwards on the games' observations
    m = models(env_name)
    for plies, _ in want:
        for _moves, observations in plies[::3]:
            for obs in observations:
                j = m['jax'].inference(obs, None)
                t = m['port'].inference(obs, None)
                np.testing.assert_allclose(t['policy'], np.asarray(
                    j['policy']), rtol=0, atol=TOL)
                np.testing.assert_allclose(t['value'], np.asarray(
                    j['value']), rtol=0, atol=TOL)


def test_port_clients_count_what_they_answered():
    """A port client counts its actions and keeps each game's outcome,
    which the eval client's children report."""
    _games, runners = network_games('port', 'port', 'TicTacToe')
    plies = sum(len(p) for p, _ in _games)
    assert sum(r.actions for r in runners) == plies   # one mover a ply
    for r in runners:
        assert len(r.outcomes) == GAMES
    assert [sum(o) for o in zip(*(r.outcomes for r in runners))] == \
        [0.0] * GAMES
