"""Device-resident self-play and evaluation: whole chunks of plies on the
card, with no host round trip inside a chunk.

The port of ``handyrl_tpu/device_generation.py`` for simultaneous envs
with a tensor twin (``envs/torch_hungry_geese.py``) and feed-forward nets:
``_ply_inference`` (observe, the net on the (N, P) players folded into
N * P rows, the illegal-action mask), ``make_gen_body`` (the self-play ply:
inference, a Gumbel-max draw, transition, record, auto-reset) and
:class:`DeviceEvaluator` (whole matches against 'random' and 'rulebase'
opponents). The net is called on device tensors; nothing goes through
``ModelWrapper.batch_inference``, which copies to the host.

On the card a chunk runs as one CUDA graph (:class:`CapturedCall`): the
env state, the draws' generator and the actor's parameters are static
tensors, updated in place, so the graph's pointers stay valid; the host
reads one packed tensor a chunk, one dispatch late (:class:`PackedFetch`).
On the CPU the same functions run eagerly.

What waits (ROADMAP.md): the split path's ``DeviceGenerator`` (episodes
spliced on the host), checkpoint opponents on the device (the host
``BatchedEvaluator`` plays them), recurrent nets' hidden state, the turn-
based protocol and ``DeviceActorEngine``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .ops.graphs import CapturedCall, PackedFetch

Tensor = torch.Tensor


# -------------------------------------------------------- the ply bodies

def _ply_inference(env_mod, net: torch.nn.Module, state):
    """Observe, run the net with the (N, P) players folded into N * P rows,
    and build the illegal-action mask. Returns (obs, logits, amask, out):
    logits and amask (N, P, A), ``out`` the net's output dict."""
    obs = env_mod.observe(state)
    legal = env_mod.legal_mask(state)
    amask = (1.0 - legal) * 1e32
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
    """The self-play ply of a simultaneous env and a feed-forward net:
    inference, sampling, transition, record, auto-reset. Returns
    ``rollout_chunk(state, chunk_steps, generator) -> (state, records)``,
    records stacked as (K, N, ...): 'obs' (K, N, P, 17, 7, 11), 'action',
    'prob', 'amask', 'value', 'acting', 'done', 'outcome'; with the env's
    rewards, 'reward'. Shared by the fused pipeline, so the recorded
    trajectory has one definition."""
    if not getattr(env_mod, 'SIMULTANEOUS', False):
        raise NotImplementedError('device generation of turn-based envs is '
                                  'not ported yet (ROADMAP.md)')

    @torch.no_grad()
    def rollout_chunk(state, chunk_steps: int,
                      generator: Optional[torch.Generator]):
        plies: List[Dict[str, Tensor]] = []
        for _ in range(chunk_steps):
            obs, logits, amask, out = _ply_inference(env_mod, net, state)
            n, p = obs.shape[:2]
            u = torch.rand(logits.shape, generator=generator,
                           device=logits.device)
            actions = gumbel_argmax(logits, u)
            probs = torch.softmax(logits, dim=-1)
            sel = torch.gather(probs, -1, actions[..., None])[..., 0]
            nstate = env_mod.step(state, actions, generator=generator)
            done = env_mod.terminal(nstate)
            record = {'obs': obs, 'action': actions.int(), 'prob': sel,
                      'amask': amask,
                      'value': out['value'].reshape(n, p, -1),
                      'acting': env_mod.acting(state), 'done': done,
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


# ------------------------------------------------------------ evaluation

class DeviceEvaluator:
    """Online evaluation as whole matches on the device: ``n_envs`` matches
    of ``chunk_steps`` plies a dispatch. One rotating seat per env plays
    the trained model greedily (temperature 0, as the host
    ``BatchedEvaluator``); the envs split into one contiguous block per
    opponent, whose seats play uniformly ('random') or the env twin's
    vectorized GreedyAgent ('rulebase'). The seat rotates on every reset so
    every goose slot is balanced. The host reads (done, seat, outcome) of a
    chunk as one packed tensor, one dispatch late (``pipelined``).

    ``net`` is the actor's module on the device; its parameters are read in
    place on every ply, so the caller refreshes them with ``copy_``."""

    pipelined = True

    def __init__(self, env_mod, net: torch.nn.Module, args: Dict[str, Any],
                 n_envs: int = 64, chunk_steps: int = 16, seed: int = 77,
                 opponents: Optional[Sequence[str]] = None):
        self.env_mod, self.net, self.args = env_mod, net, args
        self.n_envs, self.chunk_steps = n_envs, chunk_steps
        self.device = next(net.parameters()).device
        self.opponents = [str(o) for o in (opponents or ['random'])]
        bad = [o for o in self.opponents if o not in ('random', 'rulebase')]
        if bad:
            raise ValueError('the device evaluator plays random and rulebase '
                             'opponents only, got %s' % bad)
        if n_envs < len(self.opponents):
            raise ValueError('need at least one eval env per opponent')
        bounds = np.linspace(0, n_envs, len(self.opponents) + 1).astype(int)
        self._opp_bounds = [(int(a), int(b), name) for a, b, name in
                            zip(bounds[:-1], bounds[1:], self.opponents)]
        self._env_opp = np.empty(n_envs, dtype=object)
        for a, b, name in self._opp_bounds:
            self._env_opp[a:b] = name
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
            _, logits, amask, _ = _ply_inference(env, self.net, state)
            greedy = torch.argmax(logits, dim=-1)
            opp = gumbel_argmax(-amask, torch.rand(amask.shape, generator=gen,
                                                   device=self.device))
            if any(name == 'rulebase' for _, _, name in self._opp_bounds):
                rule = env.greedy_action(state, generator=gen).long()
                for a, b, name in self._opp_bounds:
                    if name == 'rulebase' and a < b:
                        opp = torch.cat([opp[:a], rule[a:b], opp[b:]])
            actions = torch.where(players[None, :] == seat[:, None], greedy,
                                  opp)
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
