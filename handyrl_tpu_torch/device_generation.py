"""Device-resident self-play and evaluation: whole chunks of plies on the
card, with no host round trip inside a chunk.

The port of ``handyrl_tpu/device_generation.py`` for envs with a tensor
twin (simultaneous: ``envs/torch_hungry_geese.py``; turn-based:
``envs/torch_tictactoe.py``) and feed-forward nets: ``_ply_inference``
(observe, the net on the (N, P) players folded into N * P rows, or on the
acting player's N rows, and the illegal-action mask), ``make_gen_body``
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

What waits (ROADMAP.md): recurrent nets' hidden state and
``DeviceActorEngine``.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .ops.batch import compress_moments
from .ops.graphs import CapturedCall, PackedFetch

Tensor = torch.Tensor


# -------------------------------------------------------- the ply bodies

def simultaneous(env_mod) -> bool:
    return bool(getattr(env_mod, 'SIMULTANEOUS', False))


def _ply_inference(env_mod, net: torch.nn.Module, state):
    """Observe, run the net and build the illegal-action mask. Returns
    (obs, logits, amask, out), ``out`` the net's output dict. A simultaneous
    env's (N, P) players fold into N * P rows, logits and amask (N, P, A);
    a turn-based env's N rows are the acting players', (N, A)."""
    obs = env_mod.observe(state)
    legal = env_mod.legal_mask(state)
    amask = (1.0 - legal) * 1e32
    if not simultaneous(env_mod):
        out = dict(net(obs))
        return obs, out['policy'] - amask, amask, out
    n, p = obs.shape[:2]
    out = dict(net(obs.reshape((n * p,) + obs.shape[2:])))
    logits = out['policy'].reshape(n, p, -1) - amask
    return obs, logits, amask, out


def gumbel_argmax(logits: Tensor, u: Tensor) -> Tensor:
    """A categorical draw from ``logits`` (the JAX package's
    ``jax.random.categorical``: argmax of logits plus Gumbel noise), the
    noise -log(-log(u)) from uniforms ``u`` of the same shape."""
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(u.clamp(min=tiny)))
    return torch.argmax(logits + g, dim=-1)


def make_gen_body(env_mod, net: torch.nn.Module):
    """The self-play ply of a feed-forward net: inference, sampling,
    transition, record, auto-reset. Returns ``rollout_chunk(state,
    chunk_steps, generator) -> (state, records)``, records stacked as
    (K, N, ...): 'obs', 'action', 'prob', 'amask', 'value', 'done',
    'outcome', and 'acting' (N, P) for a simultaneous env (obs (N, P, ...))
    or 'player' (N,) for a turn-based one (the acting player's obs, prob,
    value); with the env's rewards, 'reward'. Shared by the fused pipeline,
    so the recorded trajectory has one definition."""
    simult = simultaneous(env_mod)

    @torch.no_grad()
    def rollout_chunk(state, chunk_steps: int,
                      generator: Optional[torch.Generator]):
        plies: List[Dict[str, Tensor]] = []
        for _ in range(chunk_steps):
            obs, logits, amask, out = _ply_inference(env_mod, net, state)
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
        records = {k: torch.stack([r[k] for r in plies]) for k in plies[0]}
        return state, records

    return rollout_chunk


def copy_state_(dst, src) -> None:
    """Write an env state (a NamedTuple of tensors) into ``dst`` in place."""
    for d, s in zip(dst, src):
        d.copy_(s)


def env_generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


# ------------------------------------------------------- the split path

def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


class _RecordPacker:
    """A records dict of device tensors packed into ONE float32 tensor (the
    host's one copy a chunk) and unpacked to numpy with each leaf's shape
    and dtype (the JAX package's ``_RecordPacker``: int and bool values
    are small enough to round-trip through float32 exactly)."""

    def __init__(self, records: Dict[str, Tensor]):
        self.keys = list(records)
        self.shapes = [tuple(records[k].shape) for k in self.keys]
        self.dtypes = [_numpy_dtype(records[k].dtype) for k in self.keys]

    def pack(self, records: Dict[str, Tensor]) -> Tensor:
        return torch.cat([records[k].float().reshape(-1) for k in self.keys])

    def unpack(self, flat: np.ndarray) -> Dict[str, np.ndarray]:
        out, pos = {}, 0
        for k, shape, dtype in zip(self.keys, self.shapes, self.dtypes):
            n = int(np.prod(shape)) if shape else 1
            out[k] = flat[pos:pos + n].reshape(shape).astype(dtype)
            pos += n
        return out


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
        state, records = self._rollout(self.state, self.chunk_steps,
                                       self.generator)
        copy_state_(self.state, state)
        with torch.no_grad():
            if self.records is None:   # the first call, which runs eagerly
                self.records = {k: torch.empty_like(v)
                                for k, v in records.items()}
            for k, v in records.items():
                self.records[k].copy_(v)
        subset = (self.records if full else
                  {k: self.records[k] for k in ('done', 'outcome')})
        if full not in self._packers:
            self._packers[full] = _RecordPacker(subset)
        return self._packers[full].pack(subset)

    def _dispatch(self, full: bool):
        call = self._calls.get(full)
        if call is None:
            call = self._calls[full] = CapturedCall(
                lambda: self._chunk(full), self.device, [self.generator])
        packed = call()
        self.dispatches += 1
        return self._fetch.put(packed)

    def _dispatch_records(self):
        handle = self._dispatch(False)
        with torch.no_grad():
            records = {k: v.clone() for k, v in self.records.items()}
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
        moment['observation'][player] = rec['obs'][k, i]
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
    opponent runs K1 too; feed-forward nets). In a turn-based env the model moves on the plies
    whose acting player is its seat. The seat rotates over the env's
    players on every reset, so every seat is balanced. The host reads
    (done, seat, outcome) of a chunk as one packed tensor, one dispatch
    late (``pipelined``).

    ``net`` is the actor's module on the device; its parameters are read in
    place on every ply, so the caller refreshes them with ``copy_`` (or
    ``load_state_dict``, which copies into them: the checkpoint scorer
    rescores many checkpoints with one evaluator and one captured rollout,
    :meth:`flush` between them, :meth:`play` for a point's games)."""

    pipelined = True

    def __init__(self, env_mod, net: torch.nn.Module, args: Dict[str, Any],
                 n_envs: int = 64, chunk_steps: int = 16, seed: int = 77,
                 opponents: Optional[Sequence[str]] = None):
        self.env_mod, self.net, self.args = env_mod, net, args
        self.n_envs, self.chunk_steps = n_envs, chunk_steps
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
        rows: List[Tensor] = []
        players = torch.arange(env.NUM_PLAYERS, device=self.device)
        for _ in range(self.chunk_steps):
            obs, logits, amask, _ = _ply_inference(env, self.net, state)
            greedy = torch.argmax(logits, dim=-1)
            opp = gumbel_argmax(-amask, torch.rand(amask.shape, generator=gen,
                                                   device=self.device))
            if any(name == 'rulebase' for _, _, name in self._opp_bounds):
                rule = env.greedy_action(state, generator=gen).long()
            for a, b, name in self._opp_bounds:
                if name == 'random' or a == b:
                    continue
                if name == 'rulebase':
                    block = rule[a:b]
                else:
                    block = self._opponent_greedy(name, obs[a:b], amask[a:b])
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
        copy_state_(self.state, state)
        self.seat.copy_(seat)
        return torch.cat(rows)

    def _opponent_greedy(self, name: str, obs: Tensor, amask: Tensor
                         ) -> Tensor:
        """A checkpoint opponent's greedy actions on its block: its net on
        the block's observations (a simultaneous env's players folded into
        rows), masked as the model's."""
        net = self._opp_nets[name]
        if simultaneous(self.env_mod):
            n, p = obs.shape[:2]
            policy = net(obs.reshape((n * p,) + obs.shape[2:]))['policy']
            logits = policy.reshape(n, p, -1) - amask
        else:
            logits = net(obs)['policy'] - amask
        return torch.argmax(logits, dim=-1)

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
        n, p = self.n_envs, self.env_mod.NUM_PLAYERS
        per = flat.reshape(self.chunk_steps, -1)
        done = per[:, :n] > 0.5
        seats = per[:, n:2 * n].astype(np.int64)
        outcomes = per[:, 2 * n:].reshape(self.chunk_steps, n, p)
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
