"""The port's agents and evaluation stack (handyrl_tpu_torch/agent.py,
evaluation.py, generation.BatchedEvaluator) against the JAX package's, on
TicTacToe with the full-width ``SimpleConv2dModel``: one set of weights,
written once as a ``.ckpt`` by the port and loaded by each package's
``load_model``.

Matches between a greedy model agent and ``RandomAgent`` are the same
games in both packages under the same ``random`` seed: the model's argmax
decides the model's moves (the two forwards agree within 1e-5, and these
seeds have no near-tie), the seeded draws decide the random agent's. So
outcomes, tallies, reports and results are compared exactly; values within
1e-5, logits (of size up to about 12 with these weights) within 1e-5
relative (fp32 forwards summed in other orders). ``eval_main`` runs inline with
one process (held to the JAX package's for the same seed) and with two
spawned processes (every game counted, the report printed)."""

import os
import random

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu import agent as jax_agent
from handyrl_tpu import evaluation as jax_eval
from handyrl_tpu.environment import make_env as jax_make_env
from handyrl_tpu.generation import BatchedEvaluator as JaxBatchedEvaluator
from handyrl_tpu.models.tictactoe import SimpleConv2dModel as JaxModel
from handyrl_tpu_torch import agent, evaluation
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.generation import BatchedEvaluator
from handyrl_tpu_torch.model import params_bytes
from handyrl_tpu_torch.models.tictactoe import (SimpleConv2dModel,
                                                params_from_flax)


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
ENV = {'env': 'TicTacToe'}


@pytest.fixture(scope='module')
def ckpt(tmp_path_factory):
    """A checkpoint of a model that is neither uniform nor saturated."""
    params = JaxModel().init(jax.random.PRNGKey(11),
                             np.zeros((1, 3, 3, 3), np.float32))
    net = SimpleConv2dModel()
    net.load_state_dict(params_from_flax(jax.tree_util.tree_map(
        lambda a: np.asarray(a) * 3.0, params)))
    path = tmp_path_factory.mktemp('models') / '7.ckpt'
    path.write_bytes(params_bytes(net))
    return str(path)


@pytest.fixture(scope='module')
def models(ckpt):
    """(port wrapper, JAX wrapper) of the checkpoint."""
    return (evaluation.load_model(ckpt, make_env(ENV), device='cpu'),
            jax_eval.load_model(ckpt, jax_make_env(ENV)))


def _boards(n=40, seed=0):
    env, rng = make_env(ENV), random.Random(seed)
    boards = []
    while len(boards) < n:
        if env.terminal():
            env.reset()
        boards.append((env.cells.copy(), env.moves[:]))
        env.play(rng.choice(env.legal_actions()))
    return boards


def _at(env, cells_moves):
    cells, moves = cells_moves
    env.reset()
    for a in moves:
        env.play(a)
    return env


def test_agents_act_and_observe_like_the_reference(models):
    pw, jw = models
    env, jenv = make_env(ENV), jax_make_env(ENV)
    pairs = [(agent.Agent(pw), jax_agent.Agent(jw)),
             (agent.EnsembleAgent([pw, pw]),
              jax_agent.EnsembleAgent([jw, jw])),
             (agent.SoftAgent(pw), jax_agent.SoftAgent(jw))]
    for i, board in enumerate(_boards()):
        _at(env, board)
        _at(jenv, board)
        p = env.turn()
        np.testing.assert_allclose(
            agent.masked_logits(pw.inference(env.observation(p))['policy'],
                                env.legal_actions()),
            jax_agent.masked_logits(
                np.asarray(jw.inference(jenv.observation(p))['policy']),
                jenv.legal_actions()), rtol=TOL, atol=TOL)
        for mine, ref in pairs:
            mine.reset(env)
            ref.reset(jenv)
            random.seed(i)
            a = mine.action(env, p)
            random.seed(i)
            assert a == ref.action(jenv, p)
            np.testing.assert_allclose(mine.observe(env, p),
                                       np.asarray(ref.observe(jenv, p)),
                                       rtol=0, atol=TOL)


def test_exec_match_plays_the_reference_games(models, capsys):
    pw, jw = models
    env, jenv = make_env(ENV), jax_make_env(ENV)
    for seed in range(6):
        lineup = {seed % 2: agent.Agent(pw), 1 - seed % 2: agent.RandomAgent()}
        jlineup = {seed % 2: jax_agent.Agent(jw),
                   1 - seed % 2: jax_agent.RandomAgent()}
        random.seed(seed)
        got = evaluation.exec_match(env, lineup, show=True)
        shown = capsys.readouterr().out
        random.seed(seed)
        want = jax_eval.exec_match(jenv, jlineup, show=True)
        jshown = capsys.readouterr().out
        assert got == want and env.moves == jenv.moves
        # the boards and the final outcome print the same; the agents'
        # policy and value lines carry their fp32 digits, so only their
        # count is compared
        strip = [l for l in shown.splitlines() if not l.startswith(('v =',
                                                                    'p ='))]
        jstrip = [l for l in jshown.splitlines() if not l.startswith(
            ('v =', 'p ='))]
        assert strip == jstrip and 'final outcome' in shown
        assert len(shown.splitlines()) == len(jshown.splitlines())


def test_wp_func_matches_the_reference():
    for tally in ({}, {1.0: 3}, {1.0: 2, 0.0: 1, -1.0: 5},
                  {-1.0: 4, None: 2}, {0.5: 1, -0.5: 3}):
        assert evaluation.wp_func(tally) == jax_eval.wp_func(tally)


def test_tournament_schedule_tallies_and_report(models, capsys):
    pw, jw = models
    runs = []
    for mod, wrapper, agent_mod, make in (
            (evaluation, pw, agent, make_env),
            (jax_eval, jw, jax_agent, jax_make_env)):
        agents = [agent_mod.Agent(wrapper), agent_mod.RandomAgent()]
        t = mod.Tournament(make(ENV), agents, None, ENV,
                           {'default': {}, 'other': {}}, 1, 7, seed=123)
        t.schedule()
        if mod is evaluation:
            t.launch(show_inline=False)
        else:
            t.launch([agents], show_inline=False)
        t.collect()
        capsys.readouterr()
        t.report()
        runs.append((t.jobs, t.by_pattern, t.overall,
                     capsys.readouterr().out))
    assert runs[0] == runs[1]
    jobs, _, overall, report = runs[0]
    assert len(jobs) == 14 and sum(overall[0].values()) == 14
    assert [j[2] for j in jobs[:7]] == ['default-F'] * 4 + ['default-S'] * 3
    assert report.splitlines()[0] == '---agent 0---'


def test_batched_evaluator_gives_the_reference_results(models):
    pw, jw = models
    results = []
    for cls, wrapper, make in ((BatchedEvaluator, pw, make_env),
                               (JaxBatchedEvaluator, jw, jax_make_env)):
        np.random.seed(4)
        random.seed(4)
        ev = cls(lambda i: make(dict(ENV, id=i)), wrapper,
                 {'eval': {'opponent': ['random']}}, n_envs=5)
        out = []
        while len(out) < 20:
            out += ev.step()
        results.append(out)
    assert results[0] == results[1]
    assert {r['args']['player'][0] for r in results[0]} == {0, 1}


def test_sequential_evaluator_matches_the_reference(models, ckpt):
    pw, jw = models
    args = {'seed': 3, 'eval': {'opponent': ['random', ckpt]}}
    ev = evaluation.Evaluator(make_env(ENV), args, device='cpu')
    jev = jax_eval.Evaluator(jax_make_env(ENV), args)
    for key in range(6):
        seat = key % 2
        eval_args = {'sample_key': key, 'player': [seat]}
        random.seed(key)
        got = ev.execute({seat: pw, 1 - seat: None}, eval_args)
        random.seed(key)
        want = jev.execute({seat: jw, 1 - seat: None}, eval_args)
        assert got == want


def _tallies(t):
    return t.by_pattern, t.overall


def test_eval_main_inline_matches_the_reference(ckpt, capsys):
    random.seed(5)
    got = evaluation.eval_main({'env_args': ENV}, [ckpt, '6', '1'],
                               device='cpu')
    out = capsys.readouterr().out
    captured = {}

    real = jax_eval.Tournament

    def keep(*a, **k):
        captured['t'] = real(*a, **k)
        return captured['t']
    jax_eval.Tournament = keep
    try:
        random.seed(5)
        jax_eval.eval_main({'env_args': ENV}, [ckpt, '6', '1'])
    finally:
        jax_eval.Tournament = real
    jout = capsys.readouterr().out
    assert _tallies(got) == _tallies(captured['t'])
    tail = out[out.index('---agent 0---'):]
    assert tail == jout[jout.index('---agent 0---'):]
    assert out.splitlines()[:3] == jout.splitlines()[:3]   # 1 process, seed


def test_eval_main_in_two_spawned_processes(ckpt, capsys):
    t = evaluation.eval_main({'env_args': ENV}, [ckpt + ':random', '5', '2'],
                             device='cpu')
    out = capsys.readouterr().out
    assert sum(t.overall[0].values()) == sum(t.overall[1].values()) == 5
    assert sum(t.by_pattern[0]['default-F'].values()) == 3
    for line in ('2 process, 5 games', 'total games = 5', '---agent 0---',
                 '---agent 1---'):
        assert line in out
    assert all(p.exitcode == 0 for p in t._procs)


def test_model_specs_the_port_does_not_load_are_named(ckpt):
    env = make_env(ENV)
    with pytest.raises(ValueError) as exc:
        evaluation.load_model('model.jaxexp', env, device='cpu')
    for name in ('.jaxexp', 'ExportedModel', '.pt2',
                 'scripts/torch_export_model.py'):
        assert name in str(exc.value)
    with pytest.raises(ValueError, match='none of them'):
        evaluation.load_model('model.pt', env, device='cpu')
    for raw in ('a.ckpt:random', 'serve://h:9/l@1:random',
                'registry://m/l@champion', 'x.ckpt'):
        assert (evaluation.split_model_specs(raw)
                == jax_eval.split_model_specs(raw))
    assert isinstance(evaluation._resolve_agent('random', env),
                      agent.RandomAgent)
    assert isinstance(evaluation._resolve_agent(ckpt, env, 'cpu'),
                      agent.Agent)


def test_a_spawned_tournament_without_a_device_names_cuda(ckpt,
                                                           monkeypatch):
    """The runners' device defaults to the card: with none, the launch
    raises naming CUDA before it spawns anything."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    env = make_env(ENV)
    agents = [agent.RandomAgent(), agent.RandomAgent()]
    t = evaluation.Tournament(env, agents, None, ENV, {'default': {}}, 2, 2,
                              0)
    t.schedule()
    with pytest.raises(RuntimeError, match='CUDA'):
        t.launch(show_inline=False, specs=[ckpt, 'random'])
    assert t._procs == []
    with pytest.raises(RuntimeError, match='CUDA'):
        evaluation.evaluate_mp(env, agents, None, ENV, {'default': {}}, 2, 2,
                               0, specs=[ckpt, 'random'])


def test_cli_without_a_card_names_cuda(ckpt):
    import subprocess
    import sys
    import os
    proc = subprocess.run(
        [sys.executable, '-m', 'handyrl_tpu_torch.evaluation', ckpt, '2'],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert proc.returncode != 0 and 'CUDA' in proc.stderr
    assert '---agent' not in proc.stdout
    if not torch.cuda.is_available():
        proc = subprocess.run(
            [sys.executable, '-m', 'handyrl_tpu_torch.evaluation', ckpt, '2',
             '--device', 'cpu'], capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert 'total games = 2' in proc.stdout
