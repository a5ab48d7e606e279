"""Evaluation: the match engine, the online evaluator's opponents, the
offline tournament and network battles, ``python -m
handyrl_tpu_torch.evaluation MODEL[:OPPONENT] [NUM_GAMES [NUM_PROC]]
[--config FILE.json] [--device cuda|cpu]`` (and ``python -m
handyrl_tpu_torch --eval/--eval-server/--eval-client``).

The port of ``handyrl_tpu/evaluation.py``: one match engine
(:func:`run_match`) drives every match through seat adapters, an
in-process agent (:class:`_AgentSeat`) or a remote client that mirrors the
env from ``diff_info`` deltas and answers actions as strings
(:class:`_WireSeat`, the TCP battle protocol on port 9876); the offline
harness is a :class:`Tournament` with schedule / launch / collect /
report phases; :class:`Evaluator` is the sequential online evaluator.
Models are learner checkpoints (``<epoch>.ckpt``, the param tree in
flax's ``to_bytes`` layout, as either package writes it), registry
entries (``registry://ROOT/line@selector``) loaded on the device asked
for, names served by a running service (``serve://host:port/
line@selector``), or the port's exported programs (``.pt2``, written by
``scripts/torch_export_model.py``; :class:`ExportedModel`).

Processes start with the ``spawn`` method: a forked child could not use
the parent's CUDA context. A tournament's runners get the agents' specs
and the device and load their own models; a network battle's runners
(which load no model) and the client's children get their sockets as
:class:`~.connection.SocketHandover`. With one process the tournament
runs inline, as in the JAX package.

stdout formats (``total games``, ``---agent N---``, the win-rate lines,
the client's ``outcome = ...`` and board views) are the JAX package's
verbatim. Deliberate differences (ROADMAP.md section 3): a server whose
client is lost ends with an error naming the seat (the JAX collector
waits forever), and the client joins its children and fails when one
did. The JAX package's ``.jaxexp`` exports (StableHLO) only JAX loads; the
port's counterpart is its own ``.pt2``.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import queue
import random
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import telemetry
from .agent import Agent, RandomAgent, RuleBasedAgent
from .connection import (_bare_main, accept_socket_connections,
                         connect_socket_connection, send_recv)
from .environment import make_env

network_match_port = 9876


def view(env, player=None):
    if hasattr(env, 'view'):
        env.view(player=player)
    else:
        print(env)


def view_transition(env):
    if hasattr(env, 'view_transition'):
        env.view_transition()


# ---------------------------------------------------------------------------
# network battle protocol


class NetworkAgentClient:
    """Remote side of a battle: executes server commands against a local
    env + agent. Commands: update / action / observe / outcome / quit.
    ``actions`` and ``outcomes`` count what it answered."""

    def __init__(self, agent, env, conn):
        self.conn = conn
        self.agent = agent
        self.env = env
        self.actions = 0
        self.outcomes: List[float] = []

    def run(self):
        while True:
            try:
                command, args = self.conn.recv()
            except (ConnectionResetError, EOFError, OSError):
                break
            if command == 'quit':
                break
            self.conn.send(self._execute(command, list(args)))

    def _execute(self, command: str, args: list):
        if command == 'outcome':
            print('outcome = %f' % args[0])
            self.outcomes.append(args[0])
            return None
        if command in ('action', 'observe'):
            view(self.env)
            reply = getattr(self.agent, command)(self.env, *args, show=True)
            if command == 'action':
                self.actions += 1
                reply = self.env.action2str(reply, args[0])
            return reply
        # env-state command (update etc.) mirrored onto the local env
        reply = getattr(self.env, command)(*args)
        if command == 'update':
            if args[1]:                        # reset flag: new game
                self.agent.reset(self.env, show=True)
            else:
                view_transition(self.env)
        return reply


class NetworkAgent:
    """Server-side proxy for one remote NetworkAgentClient."""

    def __init__(self, conn):
        self.conn = conn

    def _call(self, command: str, *args):
        return send_recv(self.conn, (command, list(args)))

    def update(self, data, reset):
        return self._call('update', data, reset)

    def outcome(self, value):
        return self._call('outcome', value)

    def action(self, player):
        return self._call('action', player)

    def observe(self, player):
        return self._call('observe', player)


class LostClient(ConnectionError):
    """A network battle's client went away before its games ended."""


# ---------------------------------------------------------------------------
# match engine


class _AgentSeat:
    """A player slot occupied by an in-process agent on the shared env."""

    def __init__(self, agent):
        self.agent = agent

    def begin(self, env, player, show):
        self.agent.reset(env, show=show)

    def act(self, env, player, show):
        return self.agent.action(env, player, show=show)

    def watch(self, env, player, show):
        self.agent.observe(env, player, show=show)

    def sync(self, env, player):
        pass

    def finish(self, env, player, outcome):
        pass


class _WireSeat:
    """A player slot occupied by a remote client that mirrors the env from
    diff_info deltas and exchanges actions as strings. A transport failure
    raises :class:`LostClient` naming the seat."""

    def __init__(self, proxy: NetworkAgent):
        self.proxy = proxy

    def _call(self, player, method: str, *args):
        try:
            return getattr(self.proxy, method)(*args)
        except OSError as exc:
            raise LostClient('lost the client in seat %s (%s: %s)'
                             % (player, type(exc).__name__, exc)) from exc

    def begin(self, env, player, show):
        self._call(player, 'update', env.diff_info(player), True)

    def act(self, env, player, show):
        return env.str2action(self._call(player, 'action', player), player)

    def watch(self, env, player, show):
        self._call(player, 'observe', player)

    def sync(self, env, player):
        self._call(player, 'update', env.diff_info(player), False)

    def finish(self, env, player, outcome):
        self._call(player, 'outcome', outcome)


def run_match(env, seats: Dict[int, Any], critic=None, show=False,
              game_args={}) -> Optional[dict]:
    """Play one game to completion; None on env failure."""
    if env.reset(game_args):
        return None
    for p, seat in seats.items():
        seat.begin(env, p, show)
    while not env.terminal():
        if show:
            view(env)
            if critic is not None:
                print('cv = ', critic.observe(env, None, show=False)[0])
        acting, watching = env.turns(), env.observers()
        moves = {}
        for p, seat in seats.items():
            if p in acting:
                moves[p] = seat.act(env, p, show)
            elif p in watching:
                seat.watch(env, p, show)
        if env.step(moves):
            return None
        if show:
            view_transition(env)
        for p, seat in seats.items():
            seat.sync(env, p)
    outcome = env.outcome()
    if show:
        print('final outcome = %s' % outcome)
    for p, seat in seats.items():
        seat.finish(env, p, outcome[p])
    return {'result': outcome}


def exec_match(env, agents: Dict[int, Any], critic=None, show=False,
               game_args={}) -> Optional[dict]:
    """Match between in-process agents on one shared environment."""
    return run_match(env, {p: _AgentSeat(a) for p, a in agents.items()},
                     critic, show, game_args)


def exec_network_match(env, network_agents: Dict[int, NetworkAgent],
                       critic=None, show=False, game_args={}
                       ) -> Optional[dict]:
    """Match against remote clients speaking the diff_info protocol."""
    return run_match(env,
                     {p: _WireSeat(a) for p, a in network_agents.items()},
                     critic, show, game_args)


# ---------------------------------------------------------------------------
# online evaluation (during training)


def build_agent(raw: str, env=None):
    """'random' or 'rulebase[-key]' as a host agent; None for anything
    else (a model spec)."""
    if raw == 'random':
        return RandomAgent()
    if raw.startswith('rulebase'):
        key = raw.split('-')[1] if '-' in raw else None
        return RuleBasedAgent(key)
    return None


class Evaluator:
    """Sequential online evaluation: the trained model vs a configured
    opponent pool (default 'random'), one match a call. Opponent specs are
    host agent names or checkpoint paths; checkpoint opponents are loaded
    once on ``device`` and cached."""

    def __init__(self, env, args, device: Any = 'cuda'):
        self.env = env
        self.args = args
        self.device = device
        self.default_opponent = 'random'
        self._opponent_cache: Dict[str, Any] = {}

    def _opponent_agent(self, spec: str):
        agent = build_agent(spec, self.env)
        if agent is not None:
            return agent
        if spec not in self._opponent_cache:
            self._opponent_cache[spec] = Agent(load_model(spec, self.env,
                                                          self.device))
        return self._opponent_cache[spec]

    def _draw_opponent(self, opponents, eval_args) -> str:
        """The pool draw keyed by the task's ``sample_key``: which opponent
        a task meets is a pure function of (seed, sample_key), in namespace
        2 of the seeded helper, as in the JAX package; without a key any
        member of the pool."""
        if not opponents:
            return self.default_opponent
        skey = (eval_args or {}).get('sample_key')
        if skey is None:
            return opponents[random.randrange(len(opponents))]
        from .generation import sample_seed
        seq = sample_seed(self.args.get('seed', 0), (2, int(skey)), 0)
        idx = int(np.random.default_rng(seq).integers(len(opponents)))
        return opponents[idx]

    def execute(self, models: Dict[int, Any], eval_args) -> Optional[dict]:
        opponent = (eval_args or {}).get('opponent')
        if not opponent:
            opponents = self.args.get('eval', {}).get('opponent', [])
            opponent = self._draw_opponent(opponents, eval_args)
        agents = {p: Agent(model) if model is not None
                  else self._opponent_agent(opponent)
                  for p, model in models.items()}
        with telemetry.trace_span(
                'evaluate', trace_id=telemetry.episode_trace_id(eval_args)):
            results = exec_match(self.env, agents)
        if results is None:
            print('None episode in evaluation!')
            return None
        return {'args': eval_args, 'opponent': opponent, **results}


# ---------------------------------------------------------------------------
# offline tournament


def wp_func(results: Dict[Optional[float], int]) -> float:
    games = sum(v for k, v in results.items() if k is not None)
    win = sum((k + 1) / 2 * v for k, v in results.items() if k is not None)
    return win / games if games else 0.0


def _tournament_child(agents, critic, env_args, index, job_queue,
                      result_queue, seed, show=False):
    """One match runner: drain jobs until the None sentinel. Agents that
    are :class:`NetworkAgent` proxies play through the wire protocol; a
    lost client raises :class:`LostClient` naming the runner, the game and
    the seat."""
    random.seed(seed + index)
    env = make_env({**env_args, 'id': index})
    remote_mode = isinstance(agents[0], NetworkAgent)
    engine = exec_network_match if remote_mode else exec_match
    while True:
        job = job_queue.get()
        if job is None:
            break
        serial, seat_ids, label, game_args = job
        print('*** Game %d ***' % serial)
        lineup = {env.players()[i]: agents[ai]
                  for i, ai in enumerate(seat_ids)}
        try:
            outcome = engine(env, lineup, critic, show=show,
                             game_args=game_args)
        except LostClient as exc:
            raise LostClient('network battle runner %d, game %d: %s'
                             % (index, serial, exc)) from exc
        result_queue.put((label, seat_ids, outcome))
    result_queue.put(None)


def _network_runner(handovers, env_args, index, job_queue, result_queue,
                    seed):
    """A spawned runner of a network battle: its group's sockets arrive
    as handovers; it loads no model. A lost client's message goes to the
    result queue (the server raises it) before this process fails."""
    agents = [NetworkAgent(h.open()) for h in handovers]
    try:
        _tournament_child(agents, None, env_args, index, job_queue,
                          result_queue, seed)
    except LostClient as exc:
        result_queue.put(str(exc))
        raise


def _spawned_child(specs, device, env_args, index, job_queue, result_queue,
                   seed):
    """A spawned match runner: loads its own agents from their specs on
    ``device``, then runs :func:`_tournament_child`."""
    from .model import fp32_on_card, resolve_device
    fp32_on_card(resolve_device(device))
    env = make_env(env_args)
    agents = [_resolve_agent(spec, env, device) for spec in specs]
    _tournament_child(agents, None, env_args, index, job_queue,
                      result_queue, seed)


class Tournament:
    """Offline round-robin harness over N processes.

    ``schedule`` materializes every game up front (2-player games get
    first/second seat balancing; larger games get shuffled seats);
    ``launch`` runs the games inline for 1 process, or starts spawned
    runner processes that load their agents from ``specs`` (or, in a
    network battle, take their group's sockets); ``collect`` tallies
    outcomes per agent per pattern and joins the runners; ``report``
    prints the JAX package's summary.
    """

    def __init__(self, env, agents: List[Any], critic, env_args,
                 args_patterns: Dict[str, dict], num_process: int,
                 num_games: int, seed: int):
        self.env = env
        self.agents = agents
        self.critic = critic
        self.env_args = env_args
        self.patterns = args_patterns
        self.num_process = num_process
        self.num_games = num_games
        self.seed = seed
        self.jobs: List[tuple] = []
        self.by_pattern = [dict() for _ in agents]   # agent -> label -> tally
        self.overall = [dict() for _ in agents]      # agent -> tally
        self._procs: List[Any] = []

    def _seating(self, game_index: int) -> tuple:
        """(label_suffix, seat assignment) for one game."""
        n = len(self.agents)
        if n == 2:
            plays_first = game_index < (self.num_games + 1) // 2
            return ('-F', [0, 1]) if plays_first else ('-S', [1, 0])
        return ('', random.sample(range(n), n))

    def schedule(self):
        serial = 0
        for label, game_args in self.patterns.items():
            for i in range(self.num_games):
                suffix, seat_ids = self._seating(i)
                self.jobs.append((serial, seat_ids, label + suffix, game_args))
                for tallies in self.by_pattern:
                    tallies.setdefault(label + suffix, {})
                serial += 1

    def launch(self, show_inline: bool, specs: Optional[List[str]] = None,
               device: Any = 'cuda',
               groups: Optional[List[List[NetworkAgent]]] = None):
        """Run the games inline (1 process, on ``self.agents`` or the one
        group of ``groups``) or start ``num_process`` spawned runners: in a
        network battle runner i plays through ``groups[i]``, otherwise each
        loads the agents named by ``specs`` on ``device``."""
        ctx = mp.get_context('spawn')
        # both queues stay referenced until collect(): a spawned child
        # unpickles them after start() returns
        self.job_queue: Any = ctx.Queue()
        self.results: Any = ctx.Queue()
        job_queue = self.job_queue
        for job in self.jobs:
            job_queue.put(job)
        for _ in range(self.num_process):
            job_queue.put(None)
        if self.num_process == 1:
            _tournament_child(groups[0] if groups else self.agents,
                              self.critic, self.env_args, 0, job_queue,
                              self.results, self.seed, show=show_inline)
            return
        if groups is not None:
            for i, group in enumerate(groups):
                self._start(ctx, _network_runner, (
                    [a.conn.handover() for a in group], self.env_args, i,
                    job_queue, self.results, self.seed))
                for agent in group:   # the child holds its duplicates now
                    agent.conn.close()
            return
        if specs is None or len(specs) != len(self.agents):
            raise ValueError('a tournament over %d processes needs a spec '
                             'for each of its %d agents'
                             % (self.num_process, len(self.agents)))
        from .model import resolve_device
        device = str(resolve_device(device))   # no CUDA: raise here
        for i in range(self.num_process):
            self._start(ctx, _spawned_child, (
                list(specs), device, self.env_args, i, job_queue,
                self.results, self.seed))

    def _start(self, ctx, target, args):
        proc = ctx.Process(target=target, args=args, daemon=True)
        with _bare_main():
            proc.start()
        self._procs.append(proc)

    def _next_result(self):
        """The next item of the result queue; raises when a runner died
        without finishing its jobs, or reported a lost client."""
        while True:
            dead = [p.exitcode for p in self._procs
                    if p.exitcode not in (None, 0)]
            try:   # what a dead runner sent before it exited comes first
                item = self.results.get(timeout=1.0)
            except queue.Empty:
                if dead:
                    raise RuntimeError('a tournament process exited with '
                                       'code %d' % dead[0])
                continue
            if isinstance(item, str):
                raise LostClient(item)
            return item

    def collect(self):
        pending = self.num_process
        while pending > 0:
            item = self._next_result()
            if item is None:
                pending -= 1
                continue
            label, seat_ids, match = item
            outcome = (match or {}).get('result')
            if outcome is None:
                continue
            for idx, player in enumerate(self.env.players()):
                agent_id = seat_ids[idx]
                score = outcome[player]
                pat = self.by_pattern[agent_id][label]
                pat[score] = pat.get(score, 0) + 1
                self.overall[agent_id][score] = \
                    self.overall[agent_id].get(score, 0) + 1
        for proc in self._procs:
            proc.join()

    def report(self):
        for a, per_pattern in enumerate(self.by_pattern):
            print('---agent %d---' % a)
            for label, tally in per_pattern.items():
                print(label,
                      {k: tally[k] for k in sorted(tally, reverse=True)},
                      wp_func(tally))
            print('total',
                  {k: self.overall[a][k]
                   for k in sorted(self.overall[a], reverse=True)},
                  wp_func(self.overall[a]))


def evaluate_mp(env, agents: List[Any], critic, env_args, args_patterns,
                num_process: int, num_games: int, seed: int,
                specs: Optional[List[str]] = None, device: Any = 'cuda'
                ) -> Tournament:
    """Run an offline tournament; ``specs`` (one per agent) and ``device``
    are what the spawned runners load when ``num_process`` > 1. Agents of
    None make it a network battle: ``num_process`` groups of clients are
    accepted on ``network_match_port``."""
    tournament = Tournament(env, agents, critic, env_args, args_patterns,
                            num_process, num_games, seed)
    print('total games = %d' % (len(args_patterns) * num_games))
    time.sleep(0.1)
    tournament.schedule()
    groups = None
    if agents[0] is None:
        groups = network_match_acception(num_process, env_args, len(agents),
                                         network_match_port)
    try:
        tournament.launch(show_inline=num_process == 1, specs=specs,
                          device=device, groups=groups)
        tournament.collect()
    finally:   # the clients end on the reset
        for agent in sum(groups or [], []):
            agent.conn.close()
    tournament.report()
    return tournament


def network_match_acception(n: int, env_args, num_agents: int, port: int
                            ) -> List[List[NetworkAgent]]:
    """Accept exactly n*num_agents client connections, grouped per match;
    every client of a group receives env_args once the group is full. The
    listener closes on return, so a client's reconnect after the last
    group is refused or reset."""
    waiting, groups = [], []
    acceptor = accept_socket_connections(port)
    try:
        while len(groups) < n:
            conn = next(acceptor)
            waiting.append(conn)
            if len(waiting) == num_agents:
                for c in waiting:
                    c.send(env_args)
                groups.append([NetworkAgent(c) for c in waiting])
                waiting = []
    finally:
        acceptor.close()
    return groups


# ---------------------------------------------------------------------------
# model loading


class ExportedModel:
    """Inference over the port's exported program (``.pt2``, written by
    ``scripts/torch_export_model.py``): the counterpart of the JAX
    package's ``ExportedModel`` (handyrl_tpu/evaluation.py:467-514) over
    its ``.jaxexp``, with the same numpy-in, numpy-out ``inference`` and
    ``init_hidden``, the batch axis of 1 added and taken away. The file
    loads without the net's class: only the module that registers K1's
    operator (``ops/geese_trunk``) is imported before
    ``torch.export.load``. The program, exported on the CPU, is moved to
    ``device`` (the card by default; it raises without one). A recurrent
    net's program takes the hidden state after the observation: its
    shapes are read from the program's inputs, ``init_hidden`` gives
    zeros of them (None for a feed-forward net), and ``inference``
    returns the next state under 'hidden', with its batch axis of 1, as
    the JAX package's does."""

    def __init__(self, model_path: str, device: Any = 'cuda'):
        self.model_path = model_path
        self.device = device
        self._module = None
        self._hidden_shapes: List[Tuple[int, ...]] = []

    def _open(self):
        if self._module is not None:
            return
        import torch
        from torch.export.passes import move_to_device_pass
        from .ops import geese_trunk  # noqa: F401  (registers K1's operator)
        dev = torch.device(self.device)
        if dev.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError(
                'ExportedModel on %r: torch sees no CUDA device; pass '
                "device='cpu' to run on the host" % (str(self.device),))
        program = move_to_device_pass(torch.export.load(self.model_path),
                                      dev)
        # the user inputs after the observation are the hidden state's
        names = program.graph_signature.user_inputs[1:]
        nodes = {n.name: n for n in program.graph.nodes
                 if n.op == 'placeholder'}
        self._hidden_shapes = [tuple(nodes[n].meta['val'].shape)
                               for n in names]
        self.device = dev
        self._module = program.module()

    def init_hidden(self, batch_size=None):
        self._open()
        if not self._hidden_shapes:
            return None
        return tuple(np.zeros(s, np.float32) for s in self._hidden_shapes)

    def inference(self, x, hidden=None) -> Dict[str, Any]:
        import torch
        self._open()
        obs = torch.from_numpy(np.asarray(x, np.float32)[None]).to(
            self.device)
        args = (obs,)
        if self._hidden_shapes:
            if hidden is None:
                hidden = self.init_hidden()
            args += (tuple(torch.from_numpy(np.asarray(h, np.float32)).to(
                self.device) for h in hidden),)
        with torch.no_grad():
            outputs = self._module(*args)
        result = {}
        for k, v in outputs.items():
            if k == 'hidden':
                result[k] = tuple(h.cpu().numpy() for h in v)
            elif v is not None:
                result[k] = v.cpu().numpy()[0]
        return result


def load_model(model_path: str, env, device: Any = 'cuda'):
    """A model spec as a model the agents call:

    * a learner checkpoint (``.ckpt``): the env's net with its params, a
      ``ModelWrapper`` on ``device``;
    * ``registry://ROOT/line@selector``: the registry-pinned snapshot
      (CRC-verified), a ``ModelWrapper`` on ``device``, e.g.
      ``registry://models/default@champion``;
    * ``serve://host:port/line@selector``: a proxy onto a running
      InferenceService, every inference a request resolved by name there
      (``device`` is the service's own);
    * an exported program (``.pt2``): an :class:`ExportedModel` on
      ``device``.
    """
    if model_path.startswith('serve://'):
        from .serving.client import model_from_spec
        return model_from_spec(model_path)
    from .model import ModelWrapper, load_params_bytes
    if model_path.startswith('registry://'):
        from .serving.registry import ModelRegistry, parse_spec
        root, _, spec = model_path[len('registry://'):].rpartition('/')
        line, selector = parse_spec(spec)
        snap = ModelRegistry(root or '.').load_snapshot(line, selector)
        env.reset()   # the JAX package's probe: the env's rng moves too
        return ModelWrapper.from_snapshot(snap, device)
    if model_path.endswith('.pt2'):
        return ExportedModel(model_path, device)
    if model_path.endswith('.jaxexp'):
        raise ValueError(
            '%r is a .jaxexp export (StableHLO, which only JAX loads; the '
            'JAX package\'s ExportedModel reads it): export the checkpoint '
            'to the port\'s .pt2 with scripts/torch_export_model.py, which '
            'this port\'s ExportedModel loads' % (model_path,))
    if not model_path.endswith('.ckpt'):
        raise ValueError(
            'load_model reads learner checkpoints (.ckpt), exported '
            'programs (.pt2), registry:// and serve:// specs; %r is none of '
            'them' % (model_path,))
    module = env.net()
    # the JAX package resets the env to probe an example observation; an
    # env with a random start (Hungry Geese) draws from its rng there, so
    # the matches that follow start from the reference's boards
    env.reset()
    with open(model_path, 'rb') as f:
        load_params_bytes(module, f.read())
    return ModelWrapper(module, device)


def _resolve_agent(model_path: str, env, device: Any = 'cuda'):
    agent = build_agent(model_path, env)
    if agent is None:
        agent = Agent(load_model(model_path, env, device))
    return agent


def split_model_specs(raw: str) -> List[str]:
    """Split the CLI's ``MODEL[:OPPONENT]`` argv on ``:`` while keeping
    URL-style specs whole: ``serve://host:port/line@sel`` and
    ``registry://root/line@sel`` carry colons of their own (the scheme and
    the endpoint port), so a naive split would shred them."""
    out: List[str] = []
    for part in raw.split(':'):
        if out and out[-1].endswith(('serve', 'registry')) \
                and part.startswith('//'):
            out[-1] += ':' + part          # scheme:// reassembled
        elif out and '://' in out[-1] and part[:1].isdigit():
            out[-1] += ':' + part          # the endpoint's port
        else:
            out.append(part)
    return out


# ---------------------------------------------------------------------------
# CLI entry points


def eval_main(args, argv, device: Any = 'cuda') -> Tournament:
    """The JAX package's ``eval_main``: ``argv`` is ``[MODEL[:OPPONENT]
    [NUM_GAMES [NUM_PROC]]]``; the main agent meets OPPONENT (default
    'random') in every other seat."""
    from .model import fp32_on_card, resolve_device
    dev = resolve_device(device)
    fp32_on_card(dev)
    env_args = args['env_args']
    env = make_env(env_args)

    model_paths = (split_model_specs(argv[0]) if len(argv) >= 1
                   else ['models/latest.ckpt'])
    num_games = int(argv[1]) if len(argv) >= 2 else 100
    num_process = int(argv[2]) if len(argv) >= 3 else 1

    main_agent = _resolve_agent(model_paths[0], env, dev)
    critic = None

    print('%d process, %d games' % (num_process, num_games))
    seed = random.randrange(int(1e8))
    print('seed = %d' % seed)

    opponent = model_paths[1] if len(model_paths) > 1 else 'random'
    n_opp = len(env.players()) - 1
    agents = [main_agent] + [_resolve_agent(opponent, env, dev)
                             for _ in range(n_opp)]
    specs = [model_paths[0]] + [opponent] * n_opp
    return evaluate_mp(env, agents, critic, env_args, {'default': {}},
                       num_process, num_games, seed, specs=specs, device=dev)


def eval_server_main(args, argv) -> Tournament:
    """The JAX package's ``eval_server_main``: ``argv`` is ``[NUM_GAMES
    [NUM_PROC]]``; every seat is a network client accepted on
    ``network_match_port``. Loads no model and touches no device."""
    print('network match server mode')
    env_args = args['env_args']
    env = make_env(env_args)

    num_games = int(argv[0]) if len(argv) >= 1 else 100
    num_process = int(argv[1]) if len(argv) >= 2 else 1

    print('%d process, %d games' % (num_process, num_games))
    seed = random.randrange(int(1e8))
    print('seed = %d' % seed)

    return evaluate_mp(env, [None] * len(env.players()), None, env_args,
                       {'default': {}}, num_process, num_games, seed)


def client_mp_child(env_args, model_path, device, handover, spawned_at):
    """One client child: plays its connection's games with MODEL on
    ``device``, then prints one ``client child`` line (its start seconds,
    what it answered, its kernel launches)."""
    from .model import fp32_on_card, resolve_device
    from .ops import kernel_launches
    dev = resolve_device(device)
    fp32_on_card(dev)
    conn = handover.open()
    env = make_env(env_args)
    agent = _resolve_agent(model_path, env, dev)
    started = time.time()
    client = NetworkAgentClient(agent, env, conn)
    client.run()
    line = 'client child (pid %d): %s\n' % (os.getpid(), json.dumps({
        'device': str(dev), 'start_seconds': started - spawned_at,
        'play_seconds': time.time() - started, 'actions': client.actions,
        'outcomes': client.outcomes,
        'kernel_launches': kernel_launches()}))
    # the group's children share the client's stdout: the buffered boards
    # go first, then the report in one write, so a sibling's flush cannot
    # land inside it
    sys.stdout.flush()
    os.write(sys.stdout.fileno(), line.encode())


def eval_client_main(args, argv, device: Any = 'cuda') -> int:
    """The JAX package's ``eval_client_main``: ``argv`` is ``[MODEL
    [HOST]]``. Connects to the server until it refuses; each connection
    whose env_args arrive gets a spawned child that plays its games on
    ``device``. Joins the children; 1 when one of them failed."""
    from .model import resolve_device
    print('network match client mode')
    device = str(resolve_device(device))   # no CUDA: fail before joining
    model_path = argv[0] if len(argv) >= 1 else 'models/latest.ckpt'
    host = argv[1] if len(argv) >= 2 else 'localhost'
    ctx = mp.get_context('spawn')
    children = []
    while True:
        try:
            conn = connect_socket_connection(host, network_match_port)
        except OSError:   # refused: the server has all its clients
            break
        try:
            env_args = conn.recv()
        except OSError:   # reset: the listener closed with this in its backlog
            conn.close()
            break
        with _bare_main():
            proc = ctx.Process(target=client_mp_child, args=(
                env_args, model_path, device, conn.handover(), time.time()))
            proc.start()
        conn.close()   # the child holds its duplicate now
        children.append(proc)
    for proc in children:
        proc.join()
    failed = [(p.pid, p.exitcode) for p in children if p.exitcode != 0]
    if failed:
        print('network match client: children failed (pid, exit code): %s'
              % failed, file=sys.stderr, flush=True)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog='python -m handyrl_tpu_torch.evaluation',
        description='play an offline tournament of a checkpoint against an '
        'opponent (the JAX package\'s main.py --eval)')
    ap.add_argument('specs', nargs='*',
                    help='MODEL[:OPPONENT] [NUM_GAMES [NUM_PROC]]')
    ap.add_argument('--config', default=None,
                    help='JSON file with an env_args block (default: '
                    'TicTacToe)')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    a = ap.parse_args(argv)
    raw: Dict[str, Any] = {}
    if a.config:
        with open(a.config) as f:
            raw = json.load(f)
    eval_main({'env_args': raw.get('env_args', {'env': 'TicTacToe'})},
              a.specs, device=a.device)
    return 0


if __name__ == '__main__':
    # run the named module's main, so that the spawned runners find their
    # entry points by the module's name (they see a bare __main__)
    from handyrl_tpu_torch import evaluation as _named
    raise SystemExit(_named.main())
