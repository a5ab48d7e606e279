"""Action sampling, bucketed inference and batched episode generation.

The port of ``handyrl_tpu/generation.py`` as far as the serving path and the
local learner use it: the ONE audited sampling routine shared by a local
ply and the inference engine, keyed by an explicit seed sequence instead of
process-global RNG state (a draw is a pure function of seed sequence,
policy and legal actions, so the engine replays any caller's draw
bit-identically however requests interleave); the power-of-two buckets of
the batched forward; and the learner's in-process engines,
:class:`BatchedGenerator` (N environments in lockstep against one batched
forward per ply, self-play) and :class:`BatchedEvaluator` (online
evaluation against host agents or checkpoints). They produce the JAX
package's episode records: ``{'args', 'steps', 'outcome', 'moment': [bz2
chunks]}`` with per-step moment dicts of 7 per-player entries and the turn
list. The worker plane's :class:`Generator` plays one env a ply at a
time, each acting seat through :func:`model_act` (the 8-row bucket of the
batched forward), with draws keyed by the task's ``sample_key``; with the
per-host engine's handles (``act_send``) it submits every acting seat's
request before it collects any reply.
"""

from __future__ import annotations

import random
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from . import telemetry
from .ops.batch import MOMENT_KEYS, compress_moments
from .utils.tree import map_structure, softmax, stack_structure

# every finished episode of any engine counts here; the registries ride
# the beacons, so the learner sees the fleet's generation volume
_EPISODES = telemetry.counter('episodes_generated_total')
_STEPS = telemetry.counter('generation_steps_total')


def sample_seed(base_seed, episode_key: Sequence[int], draw_index: int
                ) -> List[int]:
    """Deterministic per-draw seed sequence for np.random.default_rng.

    ``episode_key`` identifies the episode (the server-stamped
    ``sample_key``, or a worker-local fallback stream); ``draw_index``
    counts action draws within the episode in play order."""
    seq = (int(base_seed), *(int(k) for k in episode_key), int(draw_index))
    return [k & 0xFFFFFFFFFFFFFFFF for k in seq]


def masked_sample_batch(policies: np.ndarray, legal_lists, seed_seqs):
    """Sample one action per row from the legality-masked softmax.

    Vectorized over rows: the mask build and the softmax (the hot part) run
    as single array ops; the draw itself is one inverse-CDF lookup per row
    from that row's own seeded generator. Returns
    ``(actions[int64], selected_probs[float32], action_masks[float32])``;
    the mask rows use the reference's +1e32 illegal penalty so recorded
    ``action_mask`` entries stay contract-identical.
    """
    policies = np.asarray(policies)
    masks = np.full(policies.shape, 1e32, policies.dtype)
    for n, legal in enumerate(legal_lists):
        masks[n, list(legal)] = 0
    probs = softmax(policies - masks)
    actions = np.empty(len(legal_lists), np.int64)
    selected = np.empty(len(legal_lists), policies.dtype)
    for n, (legal, seq) in enumerate(zip(legal_lists, seed_seqs)):
        legal = list(legal)
        cum = np.cumsum(probs[n, legal], dtype=np.float64)
        u = np.random.default_rng(seq).random() * cum[-1]
        idx = min(int(np.searchsorted(cum, u, side='right')), len(legal) - 1)
        actions[n] = legal[idx]
        selected[n] = probs[n, legal[idx]]
    return actions, selected, masks


def masked_sample(policy: np.ndarray, legal_actions, seed_seq) -> tuple:
    """B=1 view of :func:`masked_sample_batch`.

    Returns (action, prob_of_action, action_mask)."""
    actions, selected, masks = masked_sample_batch(
        np.asarray(policy)[None], [legal_actions], [seed_seq])
    return int(actions[0]), selected[0], masks[0]


def bucketed_inference(model, obs, hidden=None) -> Dict[str, Any]:
    """Single-sample forward through the power-of-two-bucket batched program.

    The inference engine runs padded power-of-two buckets; routing the
    sequential path through the same bucketed forward keeps a local ply
    bit-identical to one the engine serves. Models without
    ``batch_inference`` (RandomModel, wire proxies) use their own
    ``inference``."""
    batch = getattr(model, 'batch_inference', None)
    if batch is None:
        return model.inference(obs, hidden)
    obs_b, _ = pad_to_bucket([obs])
    hidden_b = None
    if hidden is not None:
        hidden_b, _ = pad_to_bucket([hidden])
    outputs = batch(obs_b, hidden_b)
    out = {}
    for k, v in outputs.items():
        if v is None:
            continue
        if k == 'hidden':
            out[k] = map_structure(lambda a: np.asarray(a)[0], v)
        else:
            out[k] = np.asarray(v)[0]
    return out


def model_act(model, obs, hidden, legal_actions, seed_seq) -> Dict[str, Any]:
    """One acting ply: forward pass + masked sample.

    Models that expose ``act`` (service proxies) run both halves
    server-side in a coalesced batch; everything else runs the local
    bucketed forward and the same shared sampler."""
    act = getattr(model, 'act', None)
    if act is not None:
        return act(obs, hidden, legal_actions, seed_seq)
    outputs = bucketed_inference(model, obs, hidden)
    action, prob, mask = masked_sample(outputs['policy'], legal_actions,
                                       seed_seq)
    return {'action': action, 'prob': prob, 'action_mask': mask,
            'value': outputs.get('value'), 'hidden': outputs.get('hidden')}


def bucket_rows(rows: int, min_bucket: int = 8) -> int:
    """The power-of-two row bucket ``rows`` rows are padded to."""
    return max(min_bucket, 1 << (rows - 1).bit_length())


def pad_to_bucket(structures: list, min_bucket: int = 8):
    """Stack a list of pytrees row-wise and pad the row count to a
    power-of-two bucket (replicating row 0), so batches of any row count
    run at a few fixed shapes (the JAX package's bucket contract).

    Returns ``(padded_batch, true_rows)``."""
    rows = len(structures)
    pad = bucket_rows(rows, min_bucket) - rows

    def pad_rows(x):
        if pad == 0:
            return x
        return np.concatenate([x, np.repeat(x[:1], pad, axis=0)], axis=0)

    return map_structure(pad_rows, stack_structure(structures)), rows


def seed_env_rng(env, base_seed, episode_key) -> None:
    """Reseed an env's per-instance rng from the episode key.

    Envs with stochastic transitions (HungryGeese's spawns) keep a
    ``random.Random`` instance; seeding it from (seed, episode_key) makes
    the whole episode a pure function of (seed, sample_key, params). The
    seed string is the JAX package's, so both replay the same episode."""
    env_rng = getattr(env, 'rng', None)
    if isinstance(env_rng, random.Random):
        env_rng.seed('episode:%d:%s' % (int(base_seed), (episode_key,)))


def _blank_moment(players) -> Dict[str, Dict[int, Any]]:
    return {key: {p: None for p in players} for key in MOMENT_KEYS}


def finalize_episode_record(outcome, moments: List[dict],
                            args: Dict[str, Any], gen_args: Dict[str, Any]
                            ) -> Optional[dict]:
    """The canonical episode record from raw moments and the outcome: the
    discounted returns filled in from the rewards, the moments compressed
    in ``compress_steps`` chunks. None for an episode without moments."""
    if len(moments) < 1:
        return None
    players = list(moments[0]['return'].keys())
    for player in players:
        ret = 0.0
        for i, m in reversed(list(enumerate(moments))):
            ret = (m['reward'][player] or 0) + args['gamma'] * ret
            moments[i]['return'][player] = ret
    t0 = time.perf_counter()
    blocks = compress_moments(moments, args['compress_steps'],
                              level=args.get('compress_level', 9))
    telemetry.REGISTRY.observe_stage('compress', time.perf_counter() - t0)
    return {'args': gen_args, 'steps': len(moments), 'outcome': outcome,
            'moment': blocks}


def _finalize_episode(env, moments: List[dict], args: Dict[str, Any],
                      gen_args: Dict[str, Any]) -> Optional[dict]:
    """:func:`finalize_episode_record` of a generator's finished env,
    counted in ``episodes_generated_total`` and
    ``generation_steps_total``."""
    record = finalize_episode_record(env.outcome(), moments, args, gen_args)
    if record is not None:
        _EPISODES.inc()
        _STEPS.inc(len(moments))
    return record


def build_chunk(gen_args: Dict[str, Any], chunk_index: int, base: int,
                window: List[dict], args: Dict[str, Any],
                final: bool = False, outcome=None) -> dict:
    """One streaming upload: a fixed-T window of in-flight moments, whose
    ``'return'`` entries are None (the learner fills the returns once the
    final chunk lands). Its blocks use the whole episode's
    ``compress_steps`` grid (``streaming.chunk_steps`` is a multiple of
    it), so a partial episode's blocks index like a finished record's."""
    return {
        'args': dict(gen_args), 'chunk': int(chunk_index), 'base': int(base),
        'steps': len(window),
        'moment': compress_moments(window, args['compress_steps'],
                                   level=args.get('compress_level', 9)),
        'final': bool(final),
        'outcome': outcome if final else None,
    }


class Generator:
    """Sequential single-env episode generator (a worker's engine).

    ``namespace`` (the worker id) keys the fallback sampling stream of tasks
    without a server-stamped ``sample_key``, so parallel workers never
    replay one another's draws. With a ``sample_key`` (the learner stamps
    every assignment) the episode is a pure function of (seed,
    sample_key, model params), whichever worker plays it.

    With ``emit`` (streaming) a keyed task's episode leaves in chunks of
    ``streaming.chunk_steps`` plies as they fill, the last one with the
    outcome, and :meth:`generate` returns a ``{'streamed': True}``
    sentinel instead of the record. Chunk boundaries are a pure function
    of (seed, sample_key, T), so a re-issued attempt regenerates the same
    chunks and the learner's screen merges them."""

    def __init__(self, env, args: Dict[str, Any], namespace: int = 0):
        self.env = env
        self.args = args
        self.namespace = int(namespace)
        self._local_episodes = 0

    @staticmethod
    def _record_act(moment: dict, player, hidden: dict, res: Dict[str, Any]):
        hidden[player] = res.get('hidden', None)
        moment['value'][player] = res.get('value', None)
        moment['selected_prob'][player] = res['prob']
        moment['action_mask'][player] = res['action_mask']
        moment['action'][player] = res['action']

    def generate(self, models: Dict[int, Any], gen_args: Dict[str, Any],
                 emit=None) -> Optional[dict]:
        base_seed = self.args.get('seed', 0)
        skey = (gen_args or {}).get('sample_key')
        episode_key = ((0, int(skey)) if skey is not None
                       else (1, self.namespace, self._local_episodes))
        self._local_episodes += 1
        draws = 0
        stream = None
        if emit is not None and skey is not None:
            stream = {'T': int((self.args.get('streaming') or {})
                               .get('chunk_steps', 32)),
                      'flushed': 0, 'chunk': 0}
        seed_env_rng(self.env, base_seed, episode_key)
        moments: List[dict] = []
        hidden = {p: models[p].init_hidden() for p in self.env.players()}
        if self.env.reset():
            return None

        while not self.env.terminal():
            moment = _blank_moment(self.env.players())
            turn_players = self.env.turns()
            observers = self.env.observers()
            # the acting seats submit, then collect: an engine-mode model
            # (``act_send``) has every simultaneous-turn request on the
            # wire before any reply is read, so a worker's whole ply lands
            # in one engine tick instead of one round trip a seat
            pending = []   # (player, model, request id)
            for player in turn_players:
                obs = self.env.observation(player)
                moment['observation'][player] = obs
                seed_seq = sample_seed(base_seed, episode_key, draws)
                draws += 1
                legal = self.env.legal_actions(player)
                submit = getattr(models[player], 'act_send', None)
                if submit is not None:
                    pending.append((player, models[player],
                                    submit(obs, hidden[player], legal,
                                           seed_seq)))
                else:
                    self._record_act(moment, player, hidden,
                                     model_act(models[player], obs,
                                               hidden[player], legal,
                                               seed_seq))
            for player, model, rid in pending:
                self._record_act(moment, player, hidden, model.act_recv(rid))

            for player in observers:
                if player in turn_players:
                    continue
                if (player in gen_args['player']
                        and not self.args['observation']):
                    continue
                obs = self.env.observation(player)
                outputs = bucketed_inference(models[player], obs,
                                             hidden[player])
                hidden[player] = outputs.get('hidden', None)
                moment['observation'][player] = obs
                moment['value'][player] = outputs.get('value', None)

            if self.env.step(moment['action']):
                return None

            reward = self.env.reward()
            for player in self.env.players():
                moment['reward'][player] = reward.get(player, None)
            moment['turn'] = turn_players
            moments.append(moment)

            if stream is not None and \
                    len(moments) - stream['flushed'] >= stream['T']:
                window = moments[stream['flushed']:
                                 stream['flushed'] + stream['T']]
                emit(build_chunk(gen_args, stream['chunk'],
                                 stream['flushed'], window, self.args))
                stream['flushed'] += stream['T']
                stream['chunk'] += 1

        if stream is not None:
            if len(moments) < 1:
                return None
            # the final chunk: the moments past the last full window (maybe
            # none) and the outcome that closes the episode
            emit(build_chunk(gen_args, stream['chunk'], stream['flushed'],
                             moments[stream['flushed']:], self.args,
                             final=True, outcome=self.env.outcome()))
            _EPISODES.inc()
            _STEPS.inc(len(moments))
            return {'streamed': True, 'args': gen_args,
                    'steps': len(moments)}

        return _finalize_episode(self.env, moments, self.args, gen_args)

    def execute(self, models, gen_args, emit=None) -> Optional[dict]:
        # the worker's hop of the task_assign -> generate -> upload ->
        # ingest -> train_step chain, keyed by the task's trace id
        with telemetry.trace_span(
                'generate', trace_id=telemetry.episode_trace_id(gen_args),
                worker=self.namespace):
            episode = self.generate(models, gen_args, emit=emit)
        if episode is None:
            print('None episode in generation!')
        return episode


class BatchedGenerator:
    """N-env lockstep self-play generator against one batched forward.

    Every step gathers the observations of all (env, player) pairs that must
    run inference, evaluates them in ONE ``batch_inference`` call (padded
    to a power-of-two bucket), then samples and steps on the host: the
    categorical draw is Gumbel-max over the legality-masked logits from
    numpy's global generator, ``selected_prob`` the masked softmax's, as in
    the JAX package. Finished episodes come out of :meth:`step`; their
    slots reset at once.
    """

    def __init__(self, make_env_fn, wrapper, args: Dict[str, Any],
                 n_envs: int = 64):
        self.envs = [make_env_fn(i) for i in range(n_envs)]
        self.wrapper = wrapper
        self.args = args
        self.n_envs = n_envs
        self._moments: List[List[dict]] = [[] for _ in range(n_envs)]
        # a recurrent net's state, per (env, player), on the host
        self._hidden: List[Dict[int, Any]] = [{} for _ in range(n_envs)]
        for i, env in enumerate(self.envs):
            env.reset()
            self._hidden[i] = {p: wrapper.init_hidden()
                               for p in env.players()}

    def _gen_args(self, env) -> Dict[str, Any]:
        return {'role': 'g', 'player': env.players(),
                'model_id': {p: -1 for p in env.players()}}

    def step(self) -> List[dict]:
        """Advance all envs one step; returns episodes finished this step."""
        jobs = []   # (env_idx, player, acting: bool, obs)
        for i, env in enumerate(self.envs):
            turn_players = env.turns()
            observers = env.observers()
            for player in env.players():
                if player not in turn_players + observers:
                    continue
                if (player not in turn_players
                        and not self.args['observation']):
                    continue
                jobs.append((i, player, player in turn_players,
                             env.observation(player)))
        if not jobs:
            return []

        obs_batch, _ = pad_to_bucket([j[3] for j in jobs])
        hidden_batch = None
        if any(self._hidden[i].get(p) is not None for i, p, _, _ in jobs):
            hidden_batch, _ = pad_to_bucket(
                [self._hidden[i][p] for i, p, _, _ in jobs])
        outputs = self.wrapper.batch_inference(obs_batch, hidden_batch)
        policies = np.asarray(outputs['policy'])
        values = np.asarray(outputs['value']) if 'value' in outputs else None
        next_hidden = outputs.get('hidden')

        # one vectorized draw for every acting row: Gumbel-max over the
        # masked logits is a sample of the masked softmax
        acting_rows = [r for r, j in enumerate(jobs) if j[2]]
        if acting_rows:
            amasks = np.full((len(acting_rows),) + policies.shape[1:], 1e32,
                             np.float32)
            for n, r in enumerate(acting_rows):
                i, player, _, _ = jobs[r]
                amasks[n][self.envs[i].legal_actions(player)] = 0
            masked = policies[acting_rows] - amasks
            probs = softmax(masked)
            gumbel = -np.log(-np.log(
                np.random.random_sample(masked.shape) + 1e-12) + 1e-12)
            sampled = np.argmax(masked + gumbel, axis=-1)
        row_to_sample = {r: n for n, r in enumerate(acting_rows)}

        pending: Dict[int, dict] = {}
        for row, (i, player, acting, obs) in enumerate(jobs):
            env = self.envs[i]
            if i not in pending:
                pending[i] = _blank_moment(env.players())
                pending[i]['turn'] = env.turns()
            moment = pending[i]
            moment['observation'][player] = obs
            if values is not None:
                moment['value'][player] = values[row]
            if next_hidden is not None:
                self._hidden[i][player] = map_structure(
                    lambda a: np.asarray(a)[row], next_hidden)
            if acting:
                n = row_to_sample[row]
                action = int(sampled[n])
                moment['selected_prob'][player] = probs[n, action]
                moment['action_mask'][player] = amasks[n]
                moment['action'][player] = action

        finished: List[dict] = []
        for i, moment in pending.items():
            env = self.envs[i]
            err = env.step(moment['action'])
            if err:
                self._reset_slot(i)
                continue
            reward = env.reward()
            for player in env.players():
                moment['reward'][player] = reward.get(player, None)
            self._moments[i].append(moment)
            if env.terminal():
                episode = _finalize_episode(
                    env, self._moments[i], self.args, self._gen_args(env))
                if episode is not None:
                    finished.append(episode)
                self._reset_slot(i)
        return finished

    def _reset_slot(self, i: int):
        self._moments[i] = []
        self.envs[i].reset()
        self._hidden[i] = {p: self.wrapper.init_hidden()
                           for p in self.envs[i].players()}


class BatchedEvaluator:
    """Vectorized online evaluation: N concurrent matches of the trained
    model (greedy, one rotating seat per match) against the configured
    opponents (``eval.opponent``): host agents ('random', 'rulebase') or
    checkpoint files, whose model seats are batched across matches like the
    trained model's, one ``batch_inference`` call per model per step."""

    MAIN = ''   # pool key of the trained model under evaluation
    # one ply of every match a step, its results read in the same call
    pipelined = False
    chunk_steps = 1

    def __init__(self, make_env_fn, wrapper, args: Dict[str, Any],
                 n_envs: int = 16):
        self.envs = [make_env_fn(i) for i in range(n_envs)]
        self.wrapper = wrapper
        self.args = args
        self.n_envs = n_envs
        self._seat_counter = 0
        self._opponents = (args.get('eval', {}).get('opponent', [])
                           or ['random'])
        self._model_pool: Dict[str, Any] = {self.MAIN: wrapper}
        # preload model opponents now: load_model resets the env it probes,
        # which must never happen once matches are in flight
        for spec in self._opponents:
            if self._host_agent(spec) is None:
                self._opponent_model(spec)
        self._slot_state: List[dict] = [None] * n_envs
        for i in range(n_envs):
            self._start_match(i)

    def _host_agent(self, name: str):
        """Host-side opponent for a spec name, or None if it names a model."""
        from .evaluation import build_agent
        return build_agent(name, self.envs[0])

    def _opponent_model(self, path: str):
        """Load (once) a checkpoint-file opponent into the model pool, on
        the trained model's device. Its seats are batched, so a model
        without ``batch_inference`` (a ``serve://`` proxy) is refused."""
        if path not in self._model_pool:
            from .evaluation import load_model
            model = load_model(path, self.envs[0], device=self.wrapper.device)
            if not hasattr(model, 'batch_inference'):
                raise ValueError(
                    'evaluator model opponents must be .ckpt checkpoints '
                    '(batched inference); %r loads as %s'
                    % (path, type(model).__name__))
            self._model_pool[path] = model
        return self._model_pool[path]

    def _start_match(self, i: int):
        env = self.envs[i]
        env.reset()
        players = env.players()
        seat = players[self._seat_counter % len(players)]
        self._seat_counter += 1
        opponent = random.choice(self._opponents)

        agents: Dict[int, Any] = {}
        # each model seat: its pool key and its recurrent state
        model_seats: Dict[int, dict] = {
            seat: {'key': self.MAIN, 'hidden': self.wrapper.init_hidden()}}
        for p in players:
            if p == seat:
                continue
            agent = self._host_agent(opponent)
            if agent is not None:
                agents[p] = agent
            else:
                opp = self._opponent_model(opponent)
                model_seats[p] = {'key': opponent,
                                  'hidden': opp.init_hidden()}
        self._slot_state[i] = {'seat': seat, 'opponent': opponent,
                               'agents': agents, 'model_seats': model_seats}

    def _batched_actions(self, key: str, jobs: List[tuple]
                         ) -> Dict[tuple, int]:
        """Greedy actions for the (env_idx, player) seats of model ``key``:
        one padded batch_inference call, the seats' hidden states with it."""
        obs_batch, _ = pad_to_bucket(
            [self.envs[i].observation(p) for i, p in jobs])
        seats = [self._slot_state[i]['model_seats'][p] for i, p in jobs]
        hidden_batch = None
        if seats[0]['hidden'] is not None:
            hidden_batch, _ = pad_to_bucket([s['hidden'] for s in seats])
        outputs = self._model_pool[key].batch_inference(obs_batch,
                                                        hidden_batch)
        policies = np.asarray(outputs['policy'])
        next_hidden = outputs.get('hidden')
        actions: Dict[tuple, int] = {}
        for row, (i, p) in enumerate(jobs):
            if next_hidden is not None:
                seats[row]['hidden'] = map_structure(
                    lambda a: np.asarray(a)[row], next_hidden)
            logits = policies[row]
            actions[(i, p)] = max(self.envs[i].legal_actions(p),
                                  key=lambda a: logits[a])   # greedy
        return actions

    def step(self) -> List[dict]:
        """Advance all matches one step; returns finished result records."""
        due: Dict[str, List[tuple]] = {}
        for i, env in enumerate(self.envs):
            seats = self._slot_state[i]['model_seats']
            for p in env.turns():
                if p in seats:
                    due.setdefault(seats[p]['key'], []).append((i, p))
        model_actions: Dict[tuple, int] = {}
        for key, jobs in due.items():
            model_actions.update(self._batched_actions(key, jobs))

        finished = []
        for i, env in enumerate(self.envs):
            st = self._slot_state[i]
            actions = {}
            for p in env.turns():
                if p in st['model_seats']:
                    actions[p] = model_actions.get((i, p))
                else:
                    actions[p] = st['agents'][p].action(env, p)
            err = env.step(actions)
            if err:
                self._start_match(i)
                continue
            if env.terminal():
                eval_args = {'role': 'e', 'player': [st['seat']],
                             'model_id': {p: (-1 if p != st['seat'] else 0)
                                          for p in env.players()}}
                finished.append({'args': eval_args,
                                 'opponent': st['opponent'],
                                 'result': env.outcome()})
                self._start_match(i)
        return finished
