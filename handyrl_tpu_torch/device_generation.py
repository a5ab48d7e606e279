"""Device-resident self-play and evaluation: whole chunks of plies on the
card, with no host round trip inside a chunk.

The port of ``handyrl_tpu/device_generation.py`` for envs with a tensor
twin (simultaneous: ``envs/torch_hungry_geese.py``; turn-based:
``envs/torch_tictactoe.py``, ``envs/torch_connectx.py``), feed-forward and
recurrent nets: ``_ply_inference`` (observe, the net on the (N, P)
players folded into N * P rows, or on the acting player's N rows, a
recurrent net's state advanced with it, and the illegal-action mask),
``make_gen_body``
(the self-play ply: inference, a Gumbel-max draw, transition, record,
auto-reset), :class:`DeviceGenerator` (the split path: rollout chunks on
the card, episodes spliced on the host or the records handed to the
device ingest) and :class:`DeviceEvaluator` (whole matches against
'random', 'rulebase' where the twin vectorizes it, and checkpoint
opponents played by their own net in the same chunk). The net is called
on device tensors; nothing goes through ``ModelWrapper.batch_inference``,
which copies to the host.

On the card a chunk runs as one CUDA graph (:class:`CapturedCall`): the
env state, the draws' generator and the actor's parameters are static
tensors, updated in place, so the graph's pointers stay valid; the host
reads one packed tensor a chunk, one dispatch late (:class:`PackedFetch`).
On the CPU the same functions run eagerly.

:class:`DeviceActorEngine` is the device actor backend's rollout
(``generation.backend: 'device'``, ``worker.DeviceActorGather``): a block
of ledger tasks, one lane each, played in chunks of one CUDA graph with a
stack of parameter slots, the finished lanes spliced into upload records
('strict' records verified on the host byte for byte, or 'device' records
stamped ``record_version: 1``).

A recurrent net's hidden state, (N, P, ...) a leaf, is one more static
tensor of each loop, zeroed where an episode ends
(``_reset_hidden_where_done``). With ``emit`` set (streaming on), the
engine's 'device' record lanes leave in fixed-T window chunks as they
fill, the final one with the outcome (``generation.build_chunk``).
"""

from __future__ import annotations

import copy
import os
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import telemetry
from .generation import (Generator, _blank_moment, _finalize_episode,
                         bucketed_inference, build_chunk, masked_sample,
                         pad_to_bucket, sample_seed, seed_env_rng)
from .ops.batch import compress_moments
from .ops.device_windows import flatten_window_keys, unflatten_window_keys
from .ops.graphs import CapturedCall, PackedFetch
from .utils.tree import map_structure, map_zip

Tensor = torch.Tensor


# -------------------------------------------------------- the ply bodies

def simultaneous(env_mod) -> bool:
    return bool(getattr(env_mod, 'SIMULTANEOUS', False))


def _ply_inference(env_mod, net: torch.nn.Module, state, hidden=None):
    """Observe, run the net and build the illegal-action mask. Returns
    (obs, logits, amask, out, hidden), ``out`` the net's output dict
    without 'hidden'. A simultaneous env's (N, P) players fold into N * P
    rows, logits and amask (N, P, A); a turn-based env's N rows are the
    acting players', (N, A). A recurrent net's ``hidden`` (N, P, ...) a
    leaf advances for every player of a simultaneous env (they all
    observe), and for the acting player's slot alone of a turn-based one
    (gathered, run, scattered back: the omask-gated training carry);
    None for a feed-forward net."""
    obs = env_mod.observe(state)
    legal = env_mod.legal_mask(state)
    amask = (1.0 - legal) * 1e32
    if not simultaneous(env_mod):
        if hidden is None:
            out = dict(net(obs))
        else:
            rows = torch.arange(legal.shape[0], device=legal.device)
            player = env_mod.turn(state)
            out = dict(net(obs, map_structure(lambda h: h[rows, player],
                                              hidden)))
            hidden = map_zip(lambda h, x: h.index_put((rows, player), x),
                          hidden, out['hidden'])
        out.pop('hidden', None)
        return obs, out['policy'] - amask, amask, out, hidden
    n, p = obs.shape[:2]
    flat = obs.reshape((n * p,) + obs.shape[2:])
    if hidden is None:
        out = dict(net(flat))
    else:
        out = dict(net(flat, map_structure(
            lambda h: h.reshape((n * p,) + h.shape[2:]), hidden)))
        hidden = map_structure(lambda h: h.reshape((n, p) + h.shape[1:]),
                               out['hidden'])
    out.pop('hidden', None)
    logits = out['policy'].reshape(n, p, -1) - amask
    return obs, logits, amask, out, hidden


def _reset_hidden_where_done(hidden, done: Tensor):
    """Fresh episodes start with zero recurrent state."""
    return map_structure(
        lambda h: torch.where(done.reshape((-1,) + (1,) * (h.dim() - 1)),
                              torch.zeros_like(h), h), hidden)


def copy_hidden_(dst, src) -> None:
    """Write a hidden state into the static ``dst`` in place (nothing for
    a feed-forward net's None)."""
    if dst is not None:
        map_zip(lambda d, x: d.copy_(x), dst, src)


def gumbel_argmax(logits: Tensor, u: Tensor) -> Tensor:
    """A categorical draw from ``logits`` (the JAX package's
    ``jax.random.categorical``: argmax of logits plus Gumbel noise), the
    noise -log(-log(u)) from uniforms ``u`` of the same shape."""
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(u.clamp(min=tiny)))
    return torch.argmax(logits + g, dim=-1)


def make_gen_body(env_mod, net: torch.nn.Module):
    """The self-play ply: inference, sampling, transition, record,
    auto-reset. Returns ``rollout_chunk(state, chunk_steps, generator,
    hidden=None) -> (state, records, hidden)``: a recurrent net's next
    ``hidden`` (zeroed where an episode ended), None for a feed-forward
    net's, and the records stacked as
    (K, N, ...): 'obs', 'action', 'prob', 'amask', 'value', 'done',
    'outcome', and 'acting' (N, P) for a simultaneous env (obs (N, P, ...))
    or 'player' (N,) for a turn-based one (the acting player's obs, prob,
    value: only the acting seat observes a ply, with ``observation`` on or
    off, as in the JAX package); with the env's rewards, 'reward'. A dict
    observation (Geister's) stays a dict of stacked leaves. Shared by the
    fused pipeline, so the recorded trajectory has one definition."""
    simult = simultaneous(env_mod)

    @torch.no_grad()
    def rollout_chunk(state, chunk_steps: int,
                      generator: Optional[torch.Generator], hidden=None):
        recurrent = hidden is not None
        plies: List[Dict[str, Tensor]] = []
        for _ in range(chunk_steps):
            obs, logits, amask, out, hidden = _ply_inference(
                env_mod, net, state, hidden)
            u = torch.rand(logits.shape, generator=generator,
                           device=logits.device)
            actions = gumbel_argmax(logits, u)
            probs = torch.softmax(logits, dim=-1)
            sel = torch.gather(probs, -1, actions[..., None])[..., 0]
            if simult:
                n, p = obs.shape[:2]
                who = {'value': out['value'].reshape(n, p, -1),
                       'acting': env_mod.acting(state)}
            else:
                who = {'value': out['value'], 'player': env_mod.turn(state)}
            nstate = env_mod.step(state, actions, generator=generator)
            done = env_mod.terminal(nstate)
            record = {'obs': obs, 'action': actions.int(), 'prob': sel,
                      'amask': amask, **who, 'done': done,
                      'outcome': env_mod.outcome(nstate)}
            if hasattr(env_mod, 'rewards'):
                record['reward'] = env_mod.rewards(nstate)
            plies.append(record)
            state = env_mod.auto_reset(nstate, done, generator=generator)
            if recurrent:
                hidden = _reset_hidden_where_done(hidden, done)
        records = {k: map_zip(lambda *xs: torch.stack(xs),
                              *[r[k] for r in plies]) for k in plies[0]}
        return state, records, hidden

    return rollout_chunk


def copy_state_(dst, src) -> None:
    """Write an env state (a NamedTuple of tensors) into ``dst`` in place."""
    for d, s in zip(dst, src):
        d.copy_(s)


def env_generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s own streams in a sharded loop (its
    envs', windows' and slots' draws): distinct for every rank."""
    return int(seed) + 7919 * (int(rank) + 1)


def state_rows(state, lo: int, hi: int):
    """Rows [lo, hi) of an env twin's state (every leaf (N, ...)), as new
    tensors: a rank's envs in a sharded loop are its rows of the global
    reset."""
    return type(state)(*[t[lo:hi].clone() for t in state])


# ------------------------------------------------------- the split path

def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """numpy's dtype of ``dtype``; bf16 (a bf16 net's value, which numpy
    lacks) is fp32, which holds its values."""
    if dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty(0, dtype=dtype).numpy().dtype


class _RecordPacker:
    """A records dict of device tensors packed into ONE float32 tensor (the
    host's one copy a chunk) and unpacked to numpy with each leaf's shape
    and dtype (the JAX package's ``_RecordPacker``: int and bool values
    are small enough to round-trip through float32 exactly)."""

    def __init__(self, records: Dict[str, Any]):
        # a dict observation's leaves under dotted keys
        records = flatten_window_keys(records)
        self.keys = list(records)
        self.shapes = [tuple(records[k].shape) for k in self.keys]
        self.dtypes = [_numpy_dtype(records[k].dtype) for k in self.keys]

    def pack(self, records: Dict[str, Any]) -> Tensor:
        records = flatten_window_keys(records)
        return torch.cat([records[k].float().reshape(-1) for k in self.keys])

    def unpack(self, flat: np.ndarray) -> Dict[str, Any]:
        out, pos = {}, 0
        for k, shape, dtype in zip(self.keys, self.shapes, self.dtypes):
            n = int(np.prod(shape)) if shape else 1
            out[k] = flat[pos:pos + n].reshape(shape).astype(dtype)
            pos += n
        return unflatten_window_keys(out)


class DeviceChunk(NamedTuple):
    """A chunk's records handed to the device ingest: copies of the
    generator's static record tensors (the next dispatch rewrites those),
    and the event after the copy on the generator's stream (None on the
    CPU), which the consumer's stream waits for."""
    records: Dict[str, Tensor]
    ready: Optional[Any]


def _blank(players):
    return {key: {p: None for p in players} for key in
            ('observation', 'selected_prob', 'action_mask', 'action',
             'value', 'reward', 'return')}


class DeviceGenerator:
    """Chunks of self-play on the device for an env twin, the split path:
    the port of the JAX package's ``DeviceGenerator`` (device_generation.py
    :226-386 there).

    A chunk is one :class:`CapturedCall` over :func:`make_gen_body` that
    advances the static env state and copies its records into static
    tensors (:attr:`records`, rewritten by every dispatch). Dispatch is
    pipelined one chunk deep: each ``step_chunk*`` call enqueues the next
    chunk before it reads the previous one, so callers see a one-chunk
    delay and nothing else.

    * :meth:`step_chunk` / :meth:`drain_episodes` read the full records
      (one packed copy) and splice them on the host into the JAX package's
      episode dicts: moments by player, discounted returns,
      ``compress_moments``.
    * :meth:`step_chunk_records` / :meth:`drain_records` keep the records
      on the device, copied into a :class:`DeviceChunk` right after their
      dispatch (before the next one rewrites the static tensors), and read
      only (done, outcome).

    ``net`` is the actor's module on the device, read in place: refresh
    its parameters between dispatches, on the dispatching thread."""

    pipelined = True    # step_chunk* returns the PREVIOUS dispatch's chunk

    def __init__(self, env_mod, net: torch.nn.Module, args: Dict[str, Any],
                 n_envs: int = 256, chunk_steps: int = 16, seed: int = 0):
        self.env_mod, self.net, self.args = env_mod, net, args
        self.n_envs, self.chunk_steps = int(n_envs), int(chunk_steps)
        self.simultaneous = simultaneous(env_mod)
        self.device = next(net.parameters()).device
        self.generator = env_generator(self.device, seed)
        self.state = env_mod.init_state(self.n_envs,
                                        generator=self.generator,
                                        device=self.device)
        self._rollout = make_gen_body(env_mod, net)
        # a recurrent net's state, (N, P, ...) a leaf, static like the env's
        self.recurrent = is_recurrent(net)
        self.hidden = (net.init_hidden((self.n_envs, env_mod.NUM_PLAYERS))
                       if self.recurrent else None)
        self.records: Optional[Dict[str, Tensor]] = None
        self._calls: Dict[bool, CapturedCall] = {}
        self._packers: Dict[bool, _RecordPacker] = {}
        self._fetch = PackedFetch(self.device)
        self._partials: List[List[dict]] = [[] for _ in range(self.n_envs)]
        self._pending = None
        self.dispatches = 0

    def _chunk(self, full: bool) -> Tensor:
        """One chunk in place: the env state and :attr:`records`; returns
        the packed records (all of them, or done and outcome)."""
        state, records, hidden = self._rollout(
            self.state, self.chunk_steps, self.generator, self.hidden)
        copy_state_(self.state, state)
        with torch.no_grad():
            copy_hidden_(self.hidden, hidden)
            if self.records is None:   # the first call, which runs eagerly
                self.records = map_structure(torch.empty_like, records)
            map_zip(lambda d, v: d.copy_(v), self.records, records)
        subset = (self.records if full else
                  {k: self.records[k] for k in ('done', 'outcome')})
        if full not in self._packers:
            self._packers[full] = _RecordPacker(subset)
        return self._packers[full].pack(subset)

    def _dispatch(self, full: bool):
        call = self._calls.get(full)
        if call is None:
            call = self._calls[full] = CapturedCall(
                self._chunk, self.device, [self.generator], args=(full,))
        packed = call()
        self.dispatches += 1
        return self._fetch.put(packed)

    def _dispatch_records(self):
        handle = self._dispatch(False)
        with torch.no_grad():
            records = map_structure(torch.clone, self.records)
        ready = None
        if self.device.type == 'cuda':
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        return DeviceChunk(records, ready), handle

    def _acct(self, handle):
        acct = self._packers[False].unpack(PackedFetch.get(handle))
        return acct['done'], acct['outcome']

    def step_chunk_records(self):
        """One chunk, its trajectory kept on the device: returns the
        PREVIOUS dispatch's (:class:`DeviceChunk`, done (K, N), outcome
        (K, N, P)), the last two on the host."""
        if self._pending is None:
            self._pending = self._dispatch_records()
        (chunk, handle), self._pending = (self._pending,
                                          self._dispatch_records())
        return (chunk,) + self._acct(handle)

    def drain_records(self):
        """The in-flight chunk at the loop's end, or None."""
        if self._pending is None:
            return None
        (chunk, handle), self._pending = self._pending, None
        return (chunk,) + self._acct(handle)

    def step_chunk(self) -> List[dict]:
        """One chunk; returns the episodes that finished in the PREVIOUS
        dispatch's chunk."""
        if self._pending is None:
            self._pending = self._dispatch(True)
        prev, self._pending = self._pending, self._dispatch(True)
        return self._splice(self._packers[True].unpack(PackedFetch.get(prev)))

    step = step_chunk   # the host generators' streaming surface

    def drain_episodes(self) -> List[dict]:
        """Splice the in-flight chunk at the loop's end."""
        if self._pending is None:
            return []
        prev, self._pending = self._pending, None
        return self._splice(self._packers[True].unpack(PackedFetch.get(prev)))

    # -- host-side episode splicing (the JAX package's, on numpy) --------
    def _splice(self, rec: Dict[str, np.ndarray]) -> List[dict]:
        players = list(range(self.env_mod.NUM_PLAYERS))
        episodes: List[dict] = []
        for k in range(self.chunk_steps):
            for i in range(self.n_envs):
                if self.simultaneous:
                    moment = self._moment_simultaneous(rec, k, i, players)
                else:
                    moment = self._moment_turn_based(rec, k, i, players)
                self._partials[i].append(moment)
                if rec['done'][k, i]:
                    episodes.append(self._finalize(i, rec, k, players))
        return episodes

    def _moment_turn_based(self, rec, k, i, players):
        player = int(rec['player'][k, i])
        moment = _blank(players)
        moment['observation'][player] = map_structure(lambda o: o[k, i],
                                                      rec['obs'])
        moment['selected_prob'][player] = float(rec['prob'][k, i])
        moment['action_mask'][player] = rec['amask'][k, i]
        moment['action'][player] = int(rec['action'][k, i])
        if rec.get('value') is not None:
            moment['value'][player] = rec['value'][k, i]
        moment['reward'] = self._rewards(rec, k, i, players)
        moment['turn'] = [player]
        return moment

    def _rewards(self, rec, k, i, players):
        if rec.get('reward') is None:
            return {p: None for p in players}
        return {p: float(rec['reward'][k, i, p]) for p in players}

    def _moment_simultaneous(self, rec, k, i, players):
        moment = _blank(players)
        turn_players = []
        for p in players:
            if not rec['acting'][k, i, p]:
                continue
            turn_players.append(p)
            moment['observation'][p] = rec['obs'][k, i, p]
            moment['selected_prob'][p] = float(rec['prob'][k, i, p])
            moment['action_mask'][p] = rec['amask'][k, i, p]
            moment['action'][p] = int(rec['action'][k, i, p])
            if rec.get('value') is not None:
                moment['value'][p] = rec['value'][k, i, p]
        moment['reward'] = self._rewards(rec, k, i, players)
        moment['turn'] = turn_players
        return moment

    def _finalize(self, i, rec, k, players):
        moments = self._partials[i]
        self._partials[i] = []
        outcome = {p: float(rec['outcome'][k, i, p]) for p in players}
        for p in players:
            ret = 0.0
            for t in range(len(moments) - 1, -1, -1):
                ret = (moments[t]['reward'][p] or 0) + self.args['gamma'] * ret
                moments[t]['return'][p] = ret
        return {
            'args': {'role': 'g', 'player': players,
                     'model_id': {p: -1 for p in players}},
            'steps': len(moments),
            'outcome': outcome,
            'moment': compress_moments(moments, self.args['compress_steps']),
        }


# ------------------------------------------------------------ evaluation

def is_checkpoint_opponent(name: str) -> bool:
    """An eval opponent that names a checkpoint file (the JAX learner's
    ``device_eval_ok``: any existing path)."""
    return name not in ('random', 'rulebase') and os.path.exists(name)


class DeviceEvaluator:
    """Online evaluation as whole matches on the device: ``n_envs`` matches
    of ``chunk_steps`` plies a dispatch. One rotating seat per env plays
    the trained model greedily (temperature 0, as the host
    ``BatchedEvaluator``); the envs split into one contiguous block per
    opponent, whose seats play uniformly ('random'), the env twin's
    vectorized GreedyAgent ('rulebase', where the twin has
    ``greedy_action``) or a checkpoint's own greedy policy (a path: its
    params, read with ``load_params_bytes`` into a copy of ``net`` on the
    device, inferenced on its block inside the same chunk, so a GeeseNet
    opponent runs K1 too; a recurrent one carries its own state in
    ``opp_hidden``). In a turn-based env the model moves on the plies
    whose acting player is its seat. The seat rotates over the env's
    players on every reset, so every seat is balanced. The host reads
    (done, seat, outcome) of a chunk as one packed tensor, one dispatch
    late (``pipelined``).

    ``net`` is the actor's module on the device; its parameters are read in
    place on every ply, so the caller refreshes them with ``copy_`` (or
    ``load_state_dict``, which copies into them: the checkpoint scorer
    rescores many checkpoints with one evaluator and one captured rollout,
    :meth:`flush` between them, :meth:`play` for a point's games).

    Beside the sharded fused loop (a ``mesh`` of W ranks) each rank plays
    ``n_envs / W`` of the matches, its rows of the global reset with its
    own stream of draws (the JAX evaluator's envs sharded over 'data',
    handyrl_tpu/device_generation.py:457-468), and the finished matches
    of every rank are gathered at the read, as the fused loop's pack, so
    every rank books the same results."""

    pipelined = True

    def __init__(self, env_mod, net: torch.nn.Module, args: Dict[str, Any],
                 n_envs: int = 64, chunk_steps: int = 16, seed: int = 77,
                 opponents: Optional[Sequence[str]] = None, mesh=None):
        self.env_mod, self.net, self.args = env_mod, net, args
        self.n_envs, self.chunk_steps = n_envs, chunk_steps
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        ndev = self.mesh.size if self.mesh is not None else 1
        if n_envs % ndev:
            raise ValueError('eval_envs %d must divide over the %d ranks'
                             % (n_envs, ndev))
        self.n_loc = n_envs // ndev
        self._lo = (self.mesh.index if self.mesh is not None else 0) \
            * self.n_loc
        self.device = next(net.parameters()).device
        self.opponents = [str(o) for o in (opponents or ['random'])]
        bad = [o for o in self.opponents if o not in ('random', 'rulebase')
               and not is_checkpoint_opponent(o)]
        if bad:
            raise ValueError('the device evaluator plays random, rulebase '
                             'and checkpoint opponents (an existing file), '
                             'got %s' % bad)
        if n_envs < len(self.opponents):
            raise ValueError('need at least one eval env per opponent')
        if 'rulebase' in self.opponents and not hasattr(env_mod,
                                                        'greedy_action'):
            raise ValueError('the env twin has no vectorized rulebase agent '
                             '(greedy_action); the host evaluator plays it')
        bounds = np.linspace(0, n_envs, len(self.opponents) + 1).astype(int)
        self._opp_bounds = [(int(a), int(b), name) for a, b, name in
                            zip(bounds[:-1], bounds[1:], self.opponents)]
        self._env_opp = np.empty(n_envs, dtype=object)
        for a, b, name in self._opp_bounds:
            self._env_opp[a:b] = name
        # each opponent's block among this rank's envs
        lo, hi = self._lo, self._lo + self.n_loc
        self._loc_bounds = [(min(max(a, lo), hi) - lo,
                             min(max(b, lo), hi) - lo, name)
                            for a, b, name in self._opp_bounds]
        # one module a checkpoint opponent, its params on the device
        self._opp_nets: Dict[str, torch.nn.Module] = {}
        for name in self.opponents:
            if is_checkpoint_opponent(name) and name not in self._opp_nets:
                from .model import load_params_bytes
                opp = copy.deepcopy(net).eval()
                with open(name, 'rb') as f:
                    load_params_bytes(opp, f.read())
                self._opp_nets[name] = opp
        self.generator = env_generator(self.device, seed)
        self.state = env_mod.init_state(n_envs, generator=self.generator,
                                        device=self.device)
        self.seat = torch.remainder(
            torch.arange(n_envs, device=self.device), env_mod.NUM_PLAYERS)
        if self.mesh is not None:
            self.state = state_rows(self.state, lo, hi)
            self.seat = self.seat[lo:hi].clone()
            self.generator = env_generator(
                self.device, rank_seed(seed, self.mesh.index))
        # a recurrent net's state, and one more for the checkpoint
        # opponents (their blocks are disjoint slices of it), static
        self.recurrent = is_recurrent(net)
        shape = (self.n_loc, env_mod.NUM_PLAYERS)
        self.hidden = net.init_hidden(shape) if self.recurrent else None
        self.opp_hidden = (net.init_hidden(shape)
                           if self.recurrent and self._opp_nets else None)
        self._call = CapturedCall(self._rollout, self.device,
                                  [self.generator])
        self._fetch = PackedFetch(self.device)
        self._pending = None
        self.dispatches = 0

    @torch.no_grad()
    def _rollout(self) -> Tensor:
        """One chunk in place on the static state; returns the packed
        (done, seat, outcome) of its plies."""
        env, gen = self.env_mod, self.generator
        state, seat = self.state, self.seat
        hidden, opp_hidden = self.hidden, self.opp_hidden
        rows: List[Tensor] = []
        players = torch.arange(env.NUM_PLAYERS, device=self.device)
        for _ in range(self.chunk_steps):
            obs, logits, amask, _, hidden = _ply_inference(
                env, self.net, state, hidden)
            greedy = torch.argmax(logits, dim=-1)
            opp = gumbel_argmax(-amask, torch.rand(amask.shape, generator=gen,
                                                   device=self.device))
            if any(name == 'rulebase' for _, _, name in self._loc_bounds):
                rule = env.greedy_action(state, generator=gen).long()
            for a, b, name in self._loc_bounds:
                if name == 'random' or a == b:
                    continue
                if name == 'rulebase':
                    block = rule[a:b]
                else:
                    block, opp_hidden = self._opponent_greedy(
                        name, map_structure(lambda o: o[a:b], obs),
                        amask[a:b], state, a, b, opp_hidden)
                opp = torch.cat([opp[:a], block, opp[b:]])
            if simultaneous(env):
                is_main = players[None, :] == seat[:, None]
            else:
                is_main = env.turn(state) == seat
            actions = torch.where(is_main, greedy, opp)
            nstate = env.step(state, actions, generator=gen)
            done = env.terminal(nstate)
            rows += [done.float(), seat.float(),
                     env.outcome(nstate).reshape(-1)]
            state = env.auto_reset(nstate, done, generator=gen)
            seat = torch.where(done, torch.remainder(seat + 1,
                                                     env.NUM_PLAYERS), seat)
            if self.recurrent:
                hidden = _reset_hidden_where_done(hidden, done)
                if opp_hidden is not None:
                    opp_hidden = _reset_hidden_where_done(opp_hidden, done)
        copy_state_(self.state, state)
        self.seat.copy_(seat)
        copy_hidden_(self.hidden, hidden)
        copy_hidden_(self.opp_hidden, opp_hidden)
        return torch.cat(rows)

    def _opponent_greedy(self, name: str, obs: Tensor, amask: Tensor,
                         state, a: int, b: int, opp_hidden):
        """A checkpoint opponent's greedy actions on its block [a, b): its
        net on the block's observations (a simultaneous env's players
        folded into rows), masked as the model's. A recurrent opponent
        reads and advances its block's slice of ``opp_hidden`` as the
        trained net does its own state. Returns (actions, opp_hidden)."""
        net = self._opp_nets[name]
        if simultaneous(self.env_mod):
            n, p = obs.shape[:2]
            flat = obs.reshape((n * p,) + obs.shape[2:])
            if opp_hidden is None:
                policy = net(flat)['policy']
            else:
                out = net(flat, map_structure(
                    lambda h: h[a:b].reshape((n * p,) + h.shape[2:]),
                    opp_hidden))
                policy = out['policy']
                opp_hidden = map_zip(lambda h, x: torch.cat(
                    [h[:a], x.reshape((n, p) + x.shape[1:]), h[b:]]),
                    opp_hidden, out['hidden'])
            logits = policy.reshape(n, p, -1) - amask
        else:
            if opp_hidden is None:
                policy = net(obs)['policy']
            else:
                rows = torch.arange(b - a, device=amask.device)
                pl = self.env_mod.turn(state)[a:b]
                out = net(obs, map_structure(lambda h: h[a:b][rows, pl],
                                             opp_hidden))
                policy = out['policy']
                opp_hidden = map_zip(
                    lambda h, x: h.index_put((a + rows, pl), x),
                    opp_hidden, out['hidden'])
            logits = policy - amask
        return torch.argmax(logits, dim=-1), opp_hidden

    def _dispatch(self):
        packed = self._call()
        self.dispatches += 1
        return self._fetch.put(packed)

    def step(self) -> List[dict]:
        """One chunk; returns the finished matches of the previous one, as
        the records ``Learner.feed_results`` takes from the host
        evaluator."""
        if self._pending is None:
            self._pending = self._dispatch()
        prev, self._pending = self._pending, self._dispatch()
        return self._collect(PackedFetch.get(prev))

    def flush(self) -> int:
        """Play and discard the matches started under the previous
        parameters (the checkpoint scorer's swap, as the JAX scorer drains
        them, scripts/eval_checkpoints.py:106-110): a whole match of the
        env's longest length plus the chunk in flight. Returns the chunks
        played."""
        chunks = (int(getattr(self.env_mod, 'MAX_STEPS', 256))
                  // self.chunk_steps + 2)
        for _ in range(chunks):
            self.step()
        return chunks

    def play(self, games: int) -> List[dict]:
        """Chunks until at least ``games`` matches have finished; returns
        every finished match (``games`` or a few more)."""
        results: List[dict] = []
        while len(results) < games:
            results.extend(self.step())
        return results

    def drain(self) -> List[dict]:
        """The in-flight chunk's matches, at the loop's end."""
        if self._pending is None:
            return []
        prev, self._pending = self._pending, None
        return self._collect(PackedFetch.get(prev))

    def _collect(self, flat: np.ndarray) -> List[dict]:
        n, p, K = self.n_loc, self.env_mod.NUM_PLAYERS, self.chunk_steps
        packs = [flat]
        if self.mesh is not None:
            from .parallel.multihost import all_gather_host
            packs = all_gather_host(flat)
        per = [f.reshape(K, -1) for f in packs]
        done = np.concatenate([q[:, :n] for q in per], axis=1) > 0.5
        seats = np.concatenate([q[:, n:2 * n] for q in per],
                               axis=1).astype(np.int64)
        outcomes = np.concatenate([q[:, 2 * n:].reshape(K, n, p)
                                   for q in per], axis=1)
        players = list(range(p))
        results: List[dict] = []
        for k, i in zip(*np.nonzero(done)):
            seat = int(seats[k, i])
            results.append({
                'args': {'role': 'e', 'player': [seat],
                         'model_id': {q: (0 if q == seat else -1)
                                      for q in players}},
                'opponent': self._env_opp[i],
                'result': {q: float(outcomes[k, i, q]) for q in players},
            })
        return results


# ------------------------------------------------- the device actor backend
#
# generation.backend 'device': a gather that owns a card answers the
# learner's ledger tasks with one fused rollout on it instead of a fleet of
# worker processes. One chunk program plays every pairing the learner
# stamps (self-play, evaluation) by holding ``device_actor_slots`` copies
# of the net and picking each seat's logits by a per-(lane, seat) slot
# index, so a new pairing is a params upload, never a new capture.

# a seat's policy inside the chunk (a device tensor of these codes):
#   SAMPLE   - sample the seat's slot policy ('g' seats)
#   GREEDY   - argmax of the seat's slot policy (evaluation model seats,
#              the host Agent at temperature 0)
#   UNIFORM  - uniform over the legal actions (model id 0 and 'random')
#   FIRST    - the first legal action (an evaluation seat of model id 0:
#              the Agent's argmax over a zero policy)
#   RULEBASE - the env twin's vectorized ``greedy_action``
MODE_SAMPLE, MODE_GREEDY, MODE_UNIFORM, MODE_FIRST, MODE_RULEBASE = range(5)


class Divergence(Exception):
    """A device-played action disagrees with the host sampling contract
    (the card's float32 cumulative sum against the host's float64 one at a
    boundary); the episode reruns on the host."""


def resolve_record_mode(env_mod, recurrent: bool, requested: str = '') -> str:
    """The device actor's record mode for an env twin.

    'strict': episodes are verified on the host at splice time and
    uploaded byte for byte as a worker's record (divergent lanes rerun on
    the host); it needs a twin deterministic given the actions
    (``RNG_COMPAT == 'strict'``), turn-based, and a feed-forward net.
    'device': episodes are spliced from the device trajectory and stamped
    ``record_version: 1``. '' picks strict where it is allowed."""
    compat = str(getattr(env_mod, 'RNG_COMPAT', 'device'))
    simult = simultaneous(env_mod)
    strict_ok = compat == 'strict' and not recurrent and not simult
    if requested == 'strict':
        if not strict_ok:
            raise ValueError(
                'device_actor_record=strict requires a turn-based env twin '
                "with RNG_COMPAT == 'strict' and a non-recurrent model "
                '(got compat=%r, recurrent=%s, simultaneous=%s)'
                % (compat, recurrent, simult))
        return 'strict'
    if requested == 'device':
        return 'device'
    return 'strict' if strict_ok else 'device'


def _tree_where(cond: Tensor, a, b):
    """Per lane ``a`` where ``cond`` else ``b``, over an env state
    NamedTuple (``cond`` (N,) broadcast to each field)."""
    return type(a)(*(torch.where(cond.reshape((-1,) + (1,) * (x.dim() - 1)),
                                 x, y) for x, y in zip(a, b)))


def _u_pick(weights: Tensor, legal: Tensor, u: Tensor) -> Tensor:
    """The inverse-CDF draw of ``generation.masked_sample`` on the device:
    the first legal action whose float32 cumulative weight exceeds
    ``u * total``, else the last legal action (u rounded past the end).
    Rows of all-zero weights fall through to the last legal action. Returns
    (N,) int64."""
    legalb = legal > 0
    c = torch.cumsum(weights * legal, dim=-1)
    total = c[:, -1:]
    cond = (c > u[:, None] * total) & legalb
    acts = legal.shape[-1]
    last_legal = (acts - 1) - torch.argmax(legalb.flip(-1).to(torch.uint8),
                                           dim=-1)
    first = torch.argmax(cond.to(torch.uint8), dim=-1)
    return torch.where(cond.any(dim=-1), first, last_legal)


def is_recurrent(net: torch.nn.Module) -> bool:
    """A net with a hidden state (``init_hidden`` returns one)."""
    init = getattr(net, 'init_hidden', None)
    return init is not None and init() is not None


class DeviceActorEngine:
    """The fused rollout behind a device actor gather: the port of the JAX
    package's ``DeviceActorEngine`` (device_generation.py:686-1362 there).

    :meth:`run_block` takes a list of ledger tasks ('g' episodes and 'e'
    evaluations, one lane each), plays them all in chunks of
    ``chunk_steps`` plies (every slot's net on every lane, per-seat
    modes, the transition, termination) and splices the finished lanes
    into upload payloads. Lanes freeze when their episode ends (no
    auto-reset), so a task's record is exactly one episode.

    A chunk is one :class:`CapturedCall` on static tensors: the env state,
    the lanes' liveness and ply counts, the per-seat slot and mode tables,
    the strict draws and ``slots`` copies of the net, whose parameters are
    overwritten in place for a new slot -> model id map. The graph is
    captured once (at the first block's second chunk) and replayed for
    every later chunk and block; :attr:`builds` counts the chunk programs
    built and :attr:`captures` the graphs captured. On the CPU the chunk
    runs eagerly.

    Tasks the chunk cannot express (unknown opponents, checkpoint
    opponents, more model ids than slots, strict tasks without a
    ``sample_key``) come back for the caller's host fallback. A failed
    build or launch raises; only a lane's splice is guarded, and a lane
    that fails there uploads None (the ledger re-issues its task).

    The streaming sink :attr:`emit` (set by the gather when the
    ``streaming`` block is on) takes the windows of the 'device' record
    lanes: each lane's moments are folded in after every chunk, a filled
    window of ``streaming.chunk_steps`` plies leaves as a chunk stamped
    ``record_version`` (the learner keys such streams by task_id), a
    finished lane's tail leaves as the final chunk with the outcome, and
    at the block's cap the unfinished lanes' tails leave as non-final
    chunks. 'strict' lanes never stream: their byte contract is checked
    on the whole episode."""

    def __init__(self, env_mod, vault, host_env, args: Dict[str, Any],
                 n_envs: int = 64, chunk_steps: int = 16, slots: int = 2,
                 record_mode: str = '', seed: int = 0, device: Any = 'cuda'):
        from .model import resolve_device
        self.args = args
        self.vault = vault
        self.host_env = host_env
        self.env_mod = env_mod
        self.device = resolve_device(device)
        self.n_envs = int(n_envs)
        self.chunk_steps = int(chunk_steps)
        self.slots = max(1, int(slots))
        self.seed = int(seed)
        self.num_players = int(env_mod.NUM_PLAYERS)
        self.simultaneous = simultaneous(env_mod)
        self.max_steps = int(getattr(env_mod, 'MAX_STEPS', 1000))
        self._has_rule = hasattr(env_mod, 'greedy_action')
        # recurrence is the architecture's: the env's net decides it before
        # any snapshot arrives
        self.recurrent = is_recurrent(host_env.net())
        self.record_mode = resolve_record_mode(env_mod, self.recurrent,
                                               str(record_mode or ''))
        self.generator = env_generator(self.device, self.seed)
        self.blocks = 0
        self.builds = 0
        self._call: Optional[CapturedCall] = None
        self._nets: List[torch.nn.Module] = []
        self._pack: Optional[_RecordPacker] = None
        self._fetch = PackedFetch(self.device)
        self._stack_key = None
        self._gen = None            # the host Generator of strict reruns
        # what the gather's beacon reports
        self.stats = {'plies': 0, 'scheduled_plies': 0, 'episodes': 0,
                      'results': 0, 'divergences': 0, 'none_payloads': 0,
                      'chunks': 0, 'chunk_seconds': 0.0,
                      'block_seconds': 0.0, 'streamed_chunks': 0}
        self.last_block: Dict[str, Any] = {}
        self.emit = None            # the streaming sink (the gather's)
        self._m_plies = telemetry.counter('device_actor_plies_total')
        self._m_episodes = telemetry.counter('device_actor_episodes_total')
        self._m_results = telemetry.counter('device_actor_results_total')
        self._m_divergence = telemetry.counter(
            'device_actor_divergence_total')
        self._m_chunk = telemetry.histogram('device_actor_chunk_seconds')
        self._m_fill = telemetry.gauge('device_actor_fill_ratio')

    @property
    def captures(self) -> int:
        return self._call.captures if self._call is not None else 0

    # -- task classification ----------------------------------------------

    def _classify(self, task) -> Optional[Dict[str, Any]]:
        """One ledger task as per-seat (mode, slot model id) vectors, or
        None when the chunk cannot express it (host fallback)."""
        role = (task or {}).get('role')
        P = self.num_players
        raw = (task or {}).get('model_id') or {}
        mids = {p: int(raw.get(p, -1)) for p in range(P)}
        modes = [MODE_FIRST] * P
        slot_mids: List[int] = []
        if role == 'g':
            if self.record_mode == 'strict' \
                    and task.get('sample_key') is None:
                return None     # no server key: no byte contract to keep
            for p in range(P):
                if mids[p] >= 1:
                    modes[p] = MODE_SAMPLE
                    slot_mids.append(mids[p])
                elif mids[p] == 0:
                    modes[p] = MODE_UNIFORM
                else:
                    return None
            return {'task': task, 'kind': 'episode', 'modes': modes,
                    'mids': mids, 'slot_mids': slot_mids, 'opponent': None}
        if role == 'e':
            seat = int(task['player'][0])
            opponent = task.get('opponent')
            if not opponent:
                opponents = (self.args.get('eval') or {}).get('opponent', [])
                skey = task.get('sample_key')
                if opponents and skey is not None:
                    # the Evaluator's namespace-2 pool draw, so the
                    # opponent is the one a host re-issue would meet
                    seq = sample_seed(self.args.get('seed', 0),
                                      (2, int(skey)), 0)
                    opponent = opponents[int(
                        np.random.default_rng(seq).integers(len(opponents)))]
                elif opponents:
                    return None   # an unkeyed pool draw: the host decides
                else:
                    opponent = 'random'
            for p in range(P):
                if p == seat:
                    modes[p] = MODE_GREEDY if mids[p] >= 1 else MODE_FIRST
                    if mids[p] >= 1:
                        slot_mids.append(mids[p])
                elif mids[p] >= 1:
                    modes[p] = MODE_GREEDY
                    slot_mids.append(mids[p])
                elif opponent == 'random':
                    modes[p] = MODE_UNIFORM
                elif str(opponent).startswith('rulebase') and self._has_rule:
                    modes[p] = MODE_RULEBASE
                else:
                    return None   # checkpoint and other opponents: host
            return {'task': task, 'kind': 'result', 'modes': modes,
                    'mids': mids, 'slot_mids': slot_mids,
                    'opponent': opponent}
        return None

    # -- the chunk program --------------------------------------------------

    def _build(self, wrapper):
        """The static tensors and the chunk's :class:`CapturedCall`, from
        the first model the vault materializes: ``slots`` copies of its
        net on the device, the env state, the lanes' liveness and ply
        counts, the seat tables and the strict draws (N, MAX_STEPS) in
        strict mode, (N, 1) otherwise."""
        if is_recurrent(wrapper.module) != self.recurrent:
            raise ValueError('the env net and the snapshot disagree on '
                             'recurrence')
        N, P, dev = self.n_envs, self.num_players, self.device
        self._nets = [copy.deepcopy(wrapper.module).to(dev).eval()
                      for _ in range(self.slots)]
        self.state = self.env_mod.init_state(N, seed=self.seed, device=dev)
        # a recurrent net's lanes' state (N, P, ...), zeroed for a block
        self._hidden = (self._nets[0].init_hidden((N, P))
                        if self.recurrent else None)
        self._live = torch.zeros((N,), dtype=torch.bool, device=dev)
        self._t = torch.zeros((N,), dtype=torch.int64, device=dev)
        u_len = self.max_steps if self.record_mode == 'strict' else 1
        self._u = torch.zeros((N, u_len), dtype=torch.float32, device=dev)
        self._slot = torch.zeros((N, P), dtype=torch.int64, device=dev)
        self._mode = torch.full((N, P), MODE_FIRST, dtype=torch.int64,
                                device=dev)
        self._call = CapturedCall(self._chunk, dev, [self.generator])
        self._stack_key = None
        self.builds += 1

    @torch.no_grad()
    def _chunk(self) -> Tensor:
        """``chunk_steps`` plies in place on the static tensors; returns
        the chunk's records packed into one float32 tensor."""
        state, live, t = self.state, self._live, self._t
        hidden = self._hidden
        plies: List[Dict[str, Tensor]] = []
        for _ in range(self.chunk_steps):
            state, hidden, live, t, record = self._ply(state, hidden, live,
                                                       t)
            plies.append(record)
        # stacked before the static tensors are written: the first ply's
        # records may be views of them (its liveness, a twin's 'acting')
        records = {k: map_zip(lambda *xs: torch.stack(xs),
                              *[r[k] for r in plies]) for k in plies[0]}
        copy_state_(self.state, state)
        copy_hidden_(self._hidden, hidden)
        self._live.copy_(live)
        self._t.copy_(t)
        if self._pack is None:     # the first call, which runs eagerly
            self._pack = _RecordPacker(records)
        return self._pack.pack(records)

    def _ply(self, state, hidden, live: Tensor, t: Tensor):
        """One ply of every lane: every slot's net on every lane, each
        seat's logits from its slot, the seat modes' actions, the
        transition (frozen where the lane is not live) and the record. A
        recurrent net's state advances in every slot from the lanes'
        state; each lane keeps its acting seat's slot's (turn-based), or
        each seat its own slot's (simultaneous). The draws come from the
        engine's generator in this order: the sampled action's uniforms,
        the uniform action's, the rulebase fallback's ('device' records;
        strict lanes take theirs from the block's table)."""
        env, gen, dev = self.env_mod, self.generator, self.device
        N, P = self.n_envs, self.num_players
        rows = torch.arange(N, device=dev)
        per_slot = [_ply_inference(env, net, state, hidden)
                    for net in self._nets]
        obs, amask = per_slot[0][0], per_slot[0][2]
        legal = (amask <= 0).float()
        logits_m = torch.stack([s[1] for s in per_slot])
        value_m = None
        if per_slot[0][3].get('value') is not None:
            value_m = torch.stack([
                s[3]['value'].reshape(N, P, -1) if self.simultaneous
                else s[3]['value'] for s in per_slot])
        if self.simultaneous:
            r2 = rows[:, None]
            cols = torch.arange(P, device=dev)[None, :]
            seat = (self._slot, r2, cols)           # each seat its own slot
            mode = self._mode
        else:
            player = env.turn(state)                            # (N,)
            seat = (self._slot[rows, player], rows)  # the acting seat's slot
            mode = self._mode[rows, player]
        logits = logits_m[seat]                 # (N, P, A) or (N, A)
        value = value_m[seat] if value_m is not None else None
        if hidden is not None:
            # the slots' next states, stacked (M, N, P, ...), at ``seat``
            hidden = map_zip(lambda *hs: torch.stack(hs)[seat],
                             *(s[4] for s in per_slot))
        if self.record_mode == 'strict' and not self.simultaneous:
            idx = t.clamp(max=self._u.shape[1] - 1)
            u = self._u[rows, idx]
            a_sample = _u_pick(torch.softmax(logits, dim=-1), legal, u)
            a_unif = _u_pick(torch.ones_like(legal), legal, u)
        else:
            a_sample = gumbel_argmax(logits, torch.rand(
                logits.shape, generator=gen, device=dev))
            a_unif = gumbel_argmax(-amask, torch.rand(
                amask.shape, generator=gen, device=dev))
        probs = torch.softmax(logits, dim=-1)
        action = torch.argmax(legal, dim=-1)                    # FIRST
        action = torch.where(mode == MODE_SAMPLE, a_sample, action)
        action = torch.where(mode == MODE_GREEDY,
                             torch.argmax(logits, dim=-1), action)
        action = torch.where(mode == MODE_UNIFORM, a_unif, action)
        if self._has_rule:
            a_rule = env.greedy_action(state, generator=gen).long()
            action = torch.where(mode == MODE_RULEBASE, a_rule, action)
        sel = torch.gather(probs, -1, action[..., None])[..., 0]
        gate = live[:, None] if self.simultaneous else live
        action = torch.where(gate, action, torch.zeros_like(action))
        nstate = env.step(state, action, generator=gen)
        nstate = _tree_where(live, nstate, state)               # frozen lanes
        done_now = env.terminal(nstate) & live
        record = {'action': action.int(), 'live': live, 'done': done_now,
                  'outcome': env.outcome(nstate)}
        if self.simultaneous:
            record['acting'] = env.acting(state)
        else:
            record['player'] = env.turn(state)
        if self.record_mode == 'device':
            record['obs'] = obs
            record['prob'] = sel
            record['amask'] = amask
            if value is not None:
                record['value'] = value
            if hasattr(env, 'rewards'):
                record['reward'] = env.rewards(nstate)
        t = t + live.long()
        live = live & ~done_now
        return nstate, hidden, live, t, record

    @torch.no_grad()
    def _stack_params(self, assign: Dict[int, int]) -> None:
        """Copy each slot's model's parameters into the slot's net, in
        place (unused slots take the first assigned model's). Cached on
        the slot -> model id map: the same pairing again costs nothing."""
        by_slot: List[Optional[int]] = [None] * self.slots
        for mid, slot in assign.items():
            by_slot[slot] = mid
        key = tuple(by_slot)
        if key == self._stack_key:
            return
        pad = next(iter(assign))
        for net, mid in zip(self._nets, by_slot):
            src = self.vault.model(pad if mid is None else mid).module
            src_state = src.state_dict()
            for name, dst in net.state_dict().items():
                dst.copy_(src_state[name])
        self._stack_key = key

    # -- block execution ----------------------------------------------------

    def run_block(self, tasks):
        """Serve one block of ledger tasks on the device. Returns
        ``(uploads, deferred)``: uploads are ``(kind, payload)`` pairs for
        the gather's upload box (payload None for a lane whose splice
        failed: the ledger re-issues its task), deferred the tasks the
        host fallback must play."""
        t_block = time.perf_counter()
        deferred, plan = [], []
        for task in tasks:
            if task.get('role') == 'idle':
                continue
            cls = self._classify(task)
            if cls is None:
                deferred.append(task)
            else:
                plan.append(cls)
        if len(plan) > self.n_envs:
            # more tasks than lanes: the overflow rides the host fallback
            deferred.extend(cls['task'] for cls in plan[self.n_envs:])
            plan = plan[:self.n_envs]
        if not plan:
            return [], deferred

        # slot planning: tasks admitted in order until the stack is full;
        # the overflow rides the host fallback
        from .league import plan_slots
        assign, admitted = plan_slots(
            [cls['slot_mids'] for cls in plan], self.slots)
        kept = []
        for cls, ok in zip(plan, admitted):
            if ok:
                kept.append(cls)
            else:
                deferred.append(cls['task'])
        plan = kept
        if not assign or not plan:
            # nothing slot-backed to run (epoch 0, or pure overflow): the
            # chunk needs at least one model's params
            deferred.extend(cls['task'] for cls in plan)
            return [], deferred

        if self._call is None:
            self._build(self.vault.model(next(iter(assign))))
        self._stack_params(assign)
        self._load_block(plan, assign)

        stream = None
        if self.emit is not None and self.record_mode != 'strict' \
                and (self.args.get('streaming') or {}).get('enabled'):
            stream = {
                'T': int((self.args.get('streaming') or {})
                         .get('chunk_steps', 32)),
                'lanes': [dict(moments=[], flushed=0, chunk=0, done=False)
                          if cls['kind'] == 'episode' else None
                          for cls in plan],
            }

        chunks: List[Dict[str, np.ndarray]] = []
        chunk_ms: List[float] = []
        n_chunks_cap = max(2, -(-self.max_steps // self.chunk_steps) + 2)
        cuda = self.device.type == 'cuda'
        for _ in range(n_chunks_cap):
            t0 = time.perf_counter()
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
            packed = self._call()
            if cuda:
                end.record()
            rec = self._pack.unpack(PackedFetch.get(self._fetch.put(packed)))
            if cuda:
                chunk_ms.append(start.elapsed_time(end))
            self.stats['chunk_seconds'] += time.perf_counter() - t0
            self._m_chunk.observe(time.perf_counter() - t0)
            chunks.append(rec)
            if stream is not None:
                self._stream_lanes(plan, rec, stream)
            if not (rec['live'][-1] & ~rec['done'][-1]).any():
                break
        if stream is not None:
            # the block's cap: the unfinished lanes' tails leave as
            # non-final windows (the learner trains on the exposed prefix;
            # the deadline re-issues the task)
            for i, st in enumerate(stream['lanes']):
                if st is None or st['done'] \
                        or len(st['moments']) <= st['flushed']:
                    continue
                self._emit_lane_chunk(plan[i], st, final=False)
        rec = {k: map_zip(lambda *xs: np.concatenate(xs),
                          *[c[k] for c in chunks]) for k in chunks[0]}
        plies = int(rec['live'].sum())
        scheduled = len(chunks) * self.chunk_steps * len(plan)
        self.stats['plies'] += plies
        self.stats['scheduled_plies'] += scheduled
        self.stats['chunks'] += len(chunks)
        self._m_plies.inc(plies)
        self._m_fill.set(plies / max(1, scheduled))

        uploads = []
        for i, cls in enumerate(plan):
            if stream is not None and stream['lanes'][i] is not None:
                # every window of the lane already left through the sink;
                # an unfinished lane re-issues on its deadline
                continue
            ks = np.nonzero(rec['live'][:, i])[0]
            finished = len(ks) > 0 and bool(rec['done'][ks[-1], i])
            payload = None
            if finished:
                try:
                    if cls['kind'] == 'result':
                        payload = self._result_record(cls, i, rec, ks)
                    elif self.record_mode == 'strict':
                        payload = self._splice_strict(cls, i, rec, ks)
                    else:
                        payload = self._splice_device(cls, i, rec, ks)
                except Exception:
                    import traceback
                    traceback.print_exc()
                    payload = None
            self.stats['none_payloads'] += payload is None
            uploads.append((cls['kind'], payload))
        if self.blocks == 1:
            telemetry.mark_steady_state(note='device actor warmup complete')
        seconds = time.perf_counter() - t_block
        self.stats['block_seconds'] += seconds
        self.last_block = {'lanes': len(plan), 'chunks': len(chunks),
                           'plies': plies, 'fill_ratio': plies / scheduled,
                           'seconds': seconds, 'chunk_ms': chunk_ms}
        return uploads, deferred

    def _load_block(self, plan, assign: Dict[int, int]) -> None:
        """The block's lanes into the static tensors: a fresh env state
        (seeded per block), the lanes' liveness, ply counts 0, the seat
        tables and, in strict mode, each lane's draws (the host
        Generator's ``sample_seed`` stream of the task's key)."""
        N, P = self.n_envs, self.num_players
        strict = self.record_mode == 'strict'
        seat_slot = np.zeros((N, P), np.int64)
        seat_mode = np.full((N, P), MODE_FIRST, np.int64)
        live = np.zeros((N,), bool)
        u_tab = np.zeros(tuple(self._u.shape), np.float32)
        base_seed = self.args.get('seed', 0)
        for i, cls in enumerate(plan):
            live[i] = True
            for p in range(P):
                seat_mode[i, p] = cls['modes'][p]
                if cls['modes'][p] in (MODE_SAMPLE, MODE_GREEDY):
                    seat_slot[i, p] = assign[cls['mids'][p]]
            if strict:
                skey = cls['task'].get('sample_key')
                if cls['kind'] == 'episode':
                    ekey, d0 = (0, int(skey)), 0
                else:
                    # evaluation lanes carry no byte contract; draw 0 named
                    # the opponent, so the plies' draws continue the stream
                    ekey, d0 = (2, int(skey if skey is not None else i)), 1
                for tt in range(u_tab.shape[1]):
                    seq = sample_seed(base_seed, ekey, d0 + tt)
                    u_tab[i, tt] = np.random.default_rng(seq).random()
        block_seed = self.seed + 7919 * self.blocks
        self.blocks += 1
        with torch.no_grad():
            copy_state_(self.state, self.env_mod.init_state(
                N, seed=block_seed, device=self.device))
            self._live.copy_(torch.from_numpy(live))
            self._t.zero_()
            if self._hidden is not None:
                map_structure(lambda h: h.zero_(), self._hidden)
            self._u.copy_(torch.from_numpy(u_tab))
            self._slot.copy_(torch.from_numpy(seat_slot))
            self._mode.copy_(torch.from_numpy(seat_mode))

    # -- streaming ----------------------------------------------------------

    def _stream_lanes(self, plan, rec, stream):
        """Fold one chunk's records into the lanes' streams, sending every
        filled window through :attr:`emit`; a lane whose episode ended
        sends its final chunk (tail and outcome) and stops."""
        players = list(range(self.num_players))
        for i, cls in enumerate(plan):
            st = stream['lanes'][i]
            if st is None or st['done']:
                continue
            try:
                ks = np.nonzero(rec['live'][:, i])[0]
                for k in ks:
                    if self.simultaneous:
                        st['moments'].append(self._lane_moment_simultaneous(
                            rec, k, i, players))
                    else:
                        st['moments'].append(self._lane_moment_turn_based(
                            rec, k, i, players))
                while len(st['moments']) - st['flushed'] >= stream['T']:
                    self._emit_lane_chunk(cls, st, final=False,
                                          upto=st['flushed'] + stream['T'])
                if len(ks) > 0 and bool(rec['done'][ks[-1], i]):
                    outcome = {p: float(rec['outcome'][ks[-1], i, p])
                               for p in players}
                    self._emit_lane_chunk(cls, st, final=True,
                                          outcome=outcome)
                    st['done'] = True
                    self.stats['episodes'] += 1
                    telemetry.counter('episodes_generated_total').inc()
                    telemetry.counter('generation_steps_total').inc(
                        len(st['moments']))
                    self._m_episodes.inc()
            except Exception:
                import traceback
                traceback.print_exc()
                # the lane stops streaming; its sent prefix stays usable
                # and the deadline re-issues the task
                st['done'] = True
                self.stats['none_payloads'] += 1
                telemetry.counter('worker_task_failures_total').inc()

    def _emit_lane_chunk(self, cls, st, final, outcome=None, upto=None):
        """Send one window of a streamed lane, stamped ``record_version``
        (device records follow the block's draws, not the host byte
        contract)."""
        upto = len(st['moments']) if upto is None else upto
        window = st['moments'][st['flushed']:upto]
        chunk = build_chunk(cls['task'], st['chunk'], st['flushed'], window,
                            self.args, final=final, outcome=outcome)
        chunk['record_version'] = 1
        st['flushed'] = upto
        st['chunk'] += 1
        self.stats['streamed_chunks'] += 1
        self.emit(chunk)

    # -- splicing -----------------------------------------------------------

    def _result_record(self, cls, lane, rec, ks):
        """An evaluation lane's outcome-only record (the Evaluator's
        ``{'args', 'opponent', 'result'}``)."""
        k = ks[-1]
        self.stats['results'] += 1
        self._m_results.inc()
        return {'args': cls['task'], 'opponent': cls['opponent'],
                'result': {p: float(rec['outcome'][k, lane, p])
                           for p in range(self.num_players)}}

    def _splice_device(self, cls, lane, rec, ks):
        """A ``record_version: 1`` episode from the lane's device
        trajectory (the split generator's moment layout)."""
        players = list(range(self.num_players))
        moments = []
        for k in ks:
            if self.simultaneous:
                moments.append(self._lane_moment_simultaneous(
                    rec, k, lane, players))
            else:
                moments.append(self._lane_moment_turn_based(
                    rec, k, lane, players))
        k = ks[-1]
        outcome = {p: float(rec['outcome'][k, lane, p]) for p in players}
        for p in players:
            ret = 0.0
            for t in range(len(moments) - 1, -1, -1):
                ret = ((moments[t]['reward'][p] or 0)
                       + self.args['gamma'] * ret)
                moments[t]['return'][p] = ret
        self.stats['episodes'] += 1
        telemetry.counter('episodes_generated_total').inc()
        telemetry.counter('generation_steps_total').inc(len(moments))
        self._m_episodes.inc()
        return {
            'args': cls['task'], 'steps': len(moments), 'outcome': outcome,
            'moment': compress_moments(
                moments, self.args['compress_steps'],
                level=self.args.get('compress_level', 9)),
            # these records follow the device's draws, not the host byte
            # contract: stamped, never silently different
            'record_version': 1,
        }

    def _lane_moment_turn_based(self, rec, k, i, players):
        player = int(rec['player'][k, i])
        moment = _blank(players)
        moment['observation'][player] = map_structure(lambda o: o[k, i],
                                                      rec['obs'])
        moment['selected_prob'][player] = float(rec['prob'][k, i])
        moment['action_mask'][player] = rec['amask'][k, i]
        moment['action'][player] = int(rec['action'][k, i])
        if rec.get('value') is not None:
            moment['value'][player] = rec['value'][k, i]
        moment['reward'] = self._lane_rewards(rec, k, i, players)
        moment['turn'] = [player]
        return moment

    def _lane_moment_simultaneous(self, rec, k, i, players):
        moment = _blank(players)
        turn_players = []
        for p in players:
            if not rec['acting'][k, i, p]:
                continue
            turn_players.append(p)
            moment['observation'][p] = rec['obs'][k, i, p]
            moment['selected_prob'][p] = float(rec['prob'][k, i, p])
            moment['action_mask'][p] = rec['amask'][k, i, p]
            moment['action'][p] = int(rec['action'][k, i, p])
            if rec.get('value') is not None:
                moment['value'][p] = rec['value'][k, i, p]
        moment['reward'] = self._lane_rewards(rec, k, i, players)
        moment['turn'] = turn_players
        return moment

    def _lane_rewards(self, rec, k, i, players):
        if rec.get('reward') is None:
            return {p: None for p in players}
        return {p: float(rec['reward'][k, i, p]) for p in players}

    def _splice_strict(self, cls, lane, rec, ks):
        """Replay the lane's device actions through the host env and the
        host sampling contract, verifying every draw: a verified lane's
        record is the one the host Generator writes for the task, byte for
        byte, with no version stamp. A mismatch reruns the task on the
        host Generator and counts a divergence."""
        task = cls['task']
        try:
            episode = self._replay_strict(task, lane, rec, ks)
        except Divergence:
            episode = None
        if episode is None:
            self.stats['divergences'] += 1
            self._m_divergence.inc()
            return self._host_rerun(task)
        self.stats['episodes'] += 1
        self._m_episodes.inc()
        return episode

    def _replay_strict(self, task, lane, rec, ks):
        env = self.host_env
        args = self.args
        base_seed = args.get('seed', 0)
        episode_key = (0, int(task['sample_key']))
        seed_env_rng(env, base_seed, episode_key)
        if env.reset():
            raise Divergence
        device_actions = [int(a) for a in rec['action'][ks, lane]]
        plies = []      # [player, obs, legal, seed_seq, reward, action]
        draws = 0
        for a_dev in device_actions:
            if env.terminal():
                raise Divergence             # the device episode ran long
            turn_players = env.turns()
            if len(turn_players) != 1:
                raise Divergence             # strict is turn-based only
            p = turn_players[0]
            obs = env.observation(p)
            seed_seq = sample_seed(base_seed, episode_key, draws)
            draws += 1
            legal = env.legal_actions(p)
            if a_dev not in legal:
                raise Divergence
            if env.step({p: a_dev}):
                raise Divergence
            plies.append([p, obs, legal, seed_seq, env.reward(), a_dev])
        if not env.terminal():
            raise Divergence                 # the device episode ended early

        # the policy recomputed per model in buckets of 8 rows, the bucket
        # the Generator's per-ply forward uses: rows of one bucket size are
        # independent of each other, a larger bucket may round differently
        models = self.vault.obtain(dict(task['model_id']))
        outputs: List[Optional[dict]] = [None] * len(plies)
        groups: Dict[int, list] = {}
        for j, ply in enumerate(plies):
            groups.setdefault(id(models[ply[0]]), []).append(j)
        with telemetry.expected_compile('device-actor strict recompute'):
            for idxs in groups.values():
                model = models[plies[idxs[0]][0]]
                if not hasattr(model, 'batch_inference'):
                    for j in idxs:           # RandomModel: zero outputs
                        outputs[j] = bucketed_inference(model, plies[j][1])
                    continue
                for lo in range(0, len(idxs), 8):
                    part = idxs[lo:lo + 8]
                    obs_b, _ = pad_to_bucket([plies[j][1] for j in part])
                    out = model.batch_inference(obs_b, None)
                    policy = np.asarray(out['policy'])
                    value = (np.asarray(out['value'])
                             if out.get('value') is not None else None)
                    for row, j in enumerate(part):
                        outputs[j] = {'policy': policy[row],
                                      'value': (value[row]
                                                if value is not None
                                                else None)}

        moments = []
        for j, (p, obs, legal, seed_seq, reward, a_dev) in enumerate(plies):
            action, prob, mask = masked_sample(outputs[j]['policy'], legal,
                                               seed_seq)
            if action != a_dev:
                raise Divergence             # a boundary collision: rerun
            moment = _blank_moment(env.players())
            moment['observation'][p] = obs
            moment['value'][p] = outputs[j].get('value')
            moment['selected_prob'][p] = prob
            moment['action_mask'][p] = mask
            moment['action'][p] = action
            for player in env.players():
                moment['reward'][player] = reward.get(player, None)
            moment['turn'] = [p]
            moments.append(moment)
        return _finalize_episode(env, moments, args, task)

    def _host_rerun(self, task):
        """The byte-exact fallback: the host Generator plays the task from
        its key (the record any worker would upload)."""
        if self._gen is None:
            self._gen = Generator(self.host_env, self.args, namespace=-1)
        models = self.vault.obtain(dict(task['model_id']))
        with telemetry.expected_compile('device-actor host rerun'):
            return self._gen.execute(models, task)
