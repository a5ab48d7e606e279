"""League training: an opponent population over the model registry.

The port of ``handyrl_tpu/league.py``. The learner owns a
:class:`LeaguePool` that turns the versioned
:class:`~handyrl_tpu_torch.serving.registry.ModelRegistry` into a
population: the registry versions of one line (named ``line@version``)
plus built-in anchors (``random``, and ``rulebase``/``rulebase-*`` for
envs with a ``rule_based_action``). PFSP sampling weights the members by a
curve over the learner's empirical win rate against each:

* ``variance``: weight p(1-p), the opponents the learner is even with;
* ``hard``: weight (1-p)^k, the opponents it loses to
  (``league.hard_exponent`` = k);
* ``uniform``: every member alike.

Each draw is keyed on ``(seed, sample_key)`` through
:func:`~handyrl_tpu_torch.generation.sample_seed` (episode-key namespace
3), so an opponent is a pure function of its task: the same on a ledger
re-issue, on any worker, and the JAX package's draw for the same pool.

A :class:`RatingBook` keeps an Elo rating for each member (with a
TrueSkill-lite ``sigma`` that shrinks with games and scales the K-factor),
updated from 'g' episodes' outcomes and from the rating matches of the 'e'
slice. Its journal is written atomically (``utils/fs.atomic_write_bytes``)
as the JAX package writes it, byte for byte, so ratings survive a restart
and either package reads the other's. The book gates promotion: the
registry's champion changes only when the learner's rating clears the
incumbent's by ``league.promote_margin`` after ``league.min_games`` games
since the last change.

:func:`plan_slots` packs a block of tasks' model ids into the device
actor's stack of parameter slots (``device_generation.DeviceActorEngine``).
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .generation import sample_seed
from .utils.fs import atomic_write_bytes

# Episode-key namespace of league opponent draws (0: server-stamped
# generation episodes, 1: the worker-local fallback, 2: the evaluator's
# opponent draws).
LEAGUE_SEED_NAMESPACE = 3

# The RatingBook's entry for the learner (the model being trained).
LEARNER = 'learner'

# The anchor that needs no checkpoint: uniform play over legal actions
# (the worker's ModelVault serves model id 0 as the RandomModel). The
# 'rulebase' anchors call the env's rule_based_action, so they play in 'e'
# rating matches only, never in a 'g' seat.
RANDOM_ANCHOR = 'random'

PFSP_CURVES = ('variance', 'hard', 'uniform')

# Added to every PFSP weight: a member at p = 1 stays reachable (to see
# regressions and to keep its rating current).
_WEIGHT_FLOOR = 0.01


def pfsp_weights(win_rates: Sequence[float], curve: str = 'variance',
                 hard_exponent: float = 2.0) -> np.ndarray:
    """Unnormalized PFSP weights for the learner's win rates against each
    member (0.5 for an unplayed one): a positive float64 vector."""
    p = np.clip(np.asarray(win_rates, dtype=np.float64), 0.0, 1.0)
    if curve == 'variance':
        w = p * (1.0 - p)
    elif curve == 'hard':
        w = (1.0 - p) ** float(hard_exponent)
    elif curve == 'uniform':
        w = np.ones_like(p)
    else:
        raise ValueError('unknown PFSP curve %r (expected one of %s)'
                         % (curve, ', '.join(PFSP_CURVES)))
    return w + _WEIGHT_FLOOR


def plan_slots(task_mids: Sequence[Sequence[int]], slots: int
               ) -> Tuple[Dict[int, int], List[bool]]:
    """Pack a block of tasks' model ids into a fixed device slot stack.

    ``task_mids[i]`` lists the model ids task ``i`` needs on the device
    (its slot-backed seats). Tasks are admitted in order while their ids
    still fit into ``slots`` distinct entries; a task whose new ids would
    overflow the stack is skipped (False) and runs on the host fallback
    instead. Ids below 1 never claim a slot. Returns ``(assign,
    admitted)``: the mid -> slot map and the per-task verdicts."""
    assign: Dict[int, int] = {}
    admitted: List[bool] = []
    for mids in task_mids:
        new = sorted({int(m) for m in mids if int(m) >= 1} - set(assign))
        if len(assign) + len(new) > int(slots):
            admitted.append(False)
            continue
        for m in new:
            assign[m] = len(assign)
        admitted.append(True)
    return assign, admitted


def member_name(line: str, version: Any) -> str:
    return '%s@%s' % (line, version)


def split_member(name: str) -> Tuple[Optional[str], Optional[str]]:
    """``'line@version' -> (line, version)``; an anchor gives (None,
    None)."""
    if '@' not in name:
        return None, None
    line, _, version = name.rpartition('@')
    return line, version


class RatingBook:
    """Elo ratings of the learner and every member, kept across restarts.

    An entry is ``{'rating', 'sigma', 'games', 'wins'}`` (``wins`` sums
    scores: a draw is 0.5). Every update is float arithmetic on the stored
    state, in the JAX package's order, so a journal round trip reproduces
    the following updates bit for bit."""

    def __init__(self, initial_rating: float = 1200.0,
                 k_factor: float = 32.0, track_sigma: bool = True,
                 initial_sigma: float = 200.0, min_sigma: float = 50.0):
        self.initial_rating = float(initial_rating)
        self.k_factor = float(k_factor)
        self.track_sigma = bool(track_sigma)
        self.initial_sigma = float(initial_sigma)
        self.min_sigma = float(min_sigma)
        self._entries: Dict[str, Dict[str, float]] = {}
        # the learner's games since the champion last changed: what
        # league.min_games gates
        self.games_since_promote = 0
        self.promotions = 0

    # -- entries -----------------------------------------------------------

    def entry(self, name: str) -> Dict[str, float]:
        e = self._entries.get(name)
        if e is None:
            e = {'rating': self.initial_rating,
                 'sigma': self.initial_sigma, 'games': 0, 'wins': 0.0}
            self._entries[name] = e
        return e

    def seed(self, name: str, rating: float) -> None:
        """Create ``name`` at ``rating`` (fresh sigma, no games)."""
        self._entries[name] = {'rating': float(rating),
                               'sigma': self.initial_sigma,
                               'games': 0, 'wins': 0.0}

    def seed_provisional(self, name: str, rating: Optional[float] = None
                         ) -> Dict[str, float]:
        """Create (or return) a provisional member: an unrated outsider
        seeded at the learner's rating (or ``rating``) with the full sigma.
        Its games never count toward ``min_games`` and it is never a
        champion (champions come from the registry)."""
        e = self._entries.get(name)
        if e is not None:
            return e
        if rating is None:
            rating = self.rating(LEARNER)
        e = {'rating': float(rating), 'sigma': self.initial_sigma,
             'games': 0, 'wins': 0.0, 'provisional': True}
        self._entries[name] = e
        return e

    def is_provisional(self, name: str) -> bool:
        e = self._entries.get(name)
        return bool(e is not None and e.get('provisional'))

    def rating(self, name: str) -> float:
        e = self._entries.get(name)
        return self.initial_rating if e is None else float(e['rating'])

    def games(self, name: str) -> int:
        e = self._entries.get(name)
        return 0 if e is None else int(e['games'])

    def win_rate(self, name: str) -> float:
        """The learner's empirical win rate against ``name`` (0.5
        unplayed)."""
        e = self._entries.get(name)
        if e is None or e['games'] <= 0:
            return 0.5
        return float(e['wins']) / float(e['games'])

    def names(self) -> List[str]:
        return sorted(self._entries)

    # -- updates -----------------------------------------------------------

    def _k(self, e: Dict[str, float]) -> float:
        if not self.track_sigma:
            return self.k_factor
        scale = max(float(e['sigma']) / self.initial_sigma, 0.25)
        return self.k_factor * scale

    def _shrink(self, e: Dict[str, float]) -> None:
        if self.track_sigma:
            e['sigma'] = max(self.min_sigma,
                             self.initial_sigma
                             / math.sqrt(1.0 + float(e['games']) / 8.0))

    def record(self, opponent: str, score: float) -> None:
        """Book one game in which the learner scored ``score`` in [0, 1]
        against ``opponent``: Elo with each side's K (scaled by sigma when
        tracked), the opponent moved by the mirrored delta; its (games,
        wins) are the learner's, the PFSP curve's input."""
        s = min(max(float(score), 0.0), 1.0)
        learner = self.entry(LEARNER)
        member = self.entry(opponent)
        expected = 1.0 / (1.0 + 10.0 ** ((member['rating']
                                          - learner['rating']) / 400.0))
        learner['rating'] += self._k(learner) * (s - expected)
        member['rating'] += self._k(member) * ((1.0 - s) - (1.0 - expected))
        learner['games'] += 1
        learner['wins'] += s
        member['games'] += 1
        member['wins'] += s
        self._shrink(learner)
        self._shrink(member)
        if not member.get('provisional'):
            # an outsider's games calibrate its rating and say nothing of
            # the learner against the league
            self.games_since_promote += 1

    def record_between(self, a: str, b: str, score_a: float) -> None:
        """Book one game between two members, neither the learner: both
        ratings move; only provisional entries count the game (as their
        own score), so a rated member's PFSP win rate stays the
        learner's; the promotion gate is untouched."""
        s = min(max(float(score_a), 0.0), 1.0)
        ea, eb = self.entry(a), self.entry(b)
        expected = 1.0 / (1.0 + 10.0 ** ((eb['rating']
                                          - ea['rating']) / 400.0))
        ea['rating'] += self._k(ea) * (s - expected)
        eb['rating'] += self._k(eb) * ((1.0 - s) - (1.0 - expected))
        for e, own in ((ea, s), (eb, 1.0 - s)):
            if e.get('provisional'):
                e['games'] += 1
                e['wins'] += own
                self._shrink(e)

    def note_promotion(self) -> None:
        self.promotions += 1
        self.games_since_promote = 0

    # -- the journal -------------------------------------------------------

    def to_state(self) -> Dict[str, Any]:
        return {'entries': {k: dict(v) for k, v in self._entries.items()},
                'games_since_promote': self.games_since_promote,
                'promotions': self.promotions,
                'initial_rating': self.initial_rating}

    def from_state(self, state: Dict[str, Any]) -> None:
        self._entries = {k: dict(v)
                         for k, v in (state.get('entries') or {}).items()}
        self.games_since_promote = int(state.get('games_since_promote', 0))
        self.promotions = int(state.get('promotions', 0))

    def save(self, path: str) -> None:
        """Write the journal atomically (temp file, fsync, rename)."""
        payload = json.dumps(self.to_state(), sort_keys=True) + '\n'
        atomic_write_bytes(path, payload.encode('utf-8'))

    def load(self, path: str) -> bool:
        """Reload a journal :meth:`save` wrote; False when it is missing or
        does not decode (the book is then untouched)."""
        try:
            with open(path, 'rb') as f:
                raw = f.read()
        except OSError:
            return False
        try:
            self.from_state(json.loads(raw.decode('utf-8')))
        except (ValueError, UnicodeDecodeError):
            return False
        return True


class LeaguePool:
    """The opponent population: registry members plus built-in anchors.

    Refreshed from the registry's manifest at each epoch's close; the
    member window holds the champion, the rollback target and the
    ``max_members`` newest versions of the line."""

    def __init__(self, league_args: Dict[str, Any], line: str):
        self.args = dict(league_args or {})
        self.line = line
        self.curve = self.args.get('curve', 'variance')
        self.hard_exponent = float(self.args.get('hard_exponent', 2.0))
        self.max_members = int(self.args.get('max_members', 8))
        self.anchors = list(self.args.get('anchors', [RANDOM_ANCHOR]))
        self.self_play_rate = float(self.args.get('self_play_rate', 0.5))
        # name -> absolute checkpoint path (registry members only)
        self._member_paths: Dict[str, str] = {}
        # name -> integer version, a 'g' task's model_id for its seats
        self._member_ids: Dict[str, int] = {}
        self.champion: Optional[str] = None

    # -- membership --------------------------------------------------------

    def refresh(self, registry) -> None:
        """Rebuild the member window from the registry's manifest."""
        entry = (registry.describe() or {}).get(self.line) or {}
        versions = entry.get('versions') or {}
        order = sorted(versions,
                       key=lambda v: int(versions[v].get('seq', 0)))
        keep = set(order[-self.max_members:])
        for special in (entry.get('champion'), entry.get('previous')):
            if special is not None:
                keep.add(special)
        paths, ids = {}, {}
        for vid in keep:
            meta = versions.get(vid)
            if meta is None:
                continue
            name = member_name(self.line, vid)
            paths[name] = meta['path']
            try:
                ids[name] = int(vid)
            except (TypeError, ValueError):
                pass   # a non-numeric version plays in 'e' matches only
        self._member_paths = paths
        self._member_ids = ids
        champ = entry.get('champion')
        self.champion = (member_name(self.line, champ)
                         if champ is not None else None)

    def members(self) -> List[str]:
        """The registry members, sorted (the draws' order)."""
        return sorted(self._member_paths)

    def roster(self) -> List[str]:
        """Members and anchors: everything the RatingBook rates."""
        return self.members() + list(self.anchors)

    def member_paths(self) -> Set[str]:
        """The checkpoint paths the retention GC keeps while they are
        members."""
        return set(self._member_paths.values())

    def member_model_id(self, name: str) -> Optional[int]:
        """The model_id a task carries for this member's seats: its
        version for a registry member, 0 (the RandomModel) for the
        ``random`` anchor, None for what no worker can load as a model
        (the rulebase anchors, non-numeric versions)."""
        if name == RANDOM_ANCHOR:
            return 0
        return self._member_ids.get(name)

    # -- sampling ----------------------------------------------------------

    def gen_candidates(self) -> List[str]:
        """The members a 'g' episode can seat: those with a model_id."""
        out = [m for m in self.members() if m in self._member_ids]
        if RANDOM_ANCHOR in self.anchors:
            out.append(RANDOM_ANCHOR)
        return out

    def sample_opponent(self, base_seed: int, sample_key: int,
                        ratings: RatingBook) -> Optional[str]:
        """The PFSP draw for the 'g' task stamped ``sample_key``: None for
        the self-play share (``self_play_rate``) and for an empty pool.
        The self-play coin and the member draw are draws 0 and 1 of the
        seed sequence in namespace 3, so the result depends on ``(seed,
        sample_key)`` and the book alone."""
        candidates = self.gen_candidates()
        if not candidates:
            return None
        key = (LEAGUE_SEED_NAMESPACE, int(sample_key))
        coin = np.random.default_rng(
            sample_seed(base_seed, key, 0)).random()
        if coin < self.self_play_rate:
            return None
        weights = pfsp_weights([ratings.win_rate(m) for m in candidates],
                               self.curve, self.hard_exponent)
        probs = weights / weights.sum()
        u = np.random.default_rng(sample_seed(base_seed, key, 1)).random()
        idx = min(int(np.searchsorted(np.cumsum(probs), u, side='right')),
                  len(candidates) - 1)
        return candidates[idx]

    def rating_opponent(self, counter: int) -> Optional[str]:
        """Round robin over the whole roster for the rating matches (the
        'e' slice): every member and anchor is rated at one cadence."""
        roster = self.roster()
        if not roster:
            return None
        return roster[int(counter) % len(roster)]

    # -- the promotion gate ------------------------------------------------

    def should_promote(self, ratings: RatingBook) -> bool:
        """True when the learner's rating clears the champion's by
        ``promote_margin`` with at least ``min_games`` games since the
        last change. With no champion yet, the registry's promotion of
        the first version decides."""
        if self.champion is None:
            return False
        margin = float(self.args.get('promote_margin', 30.0))
        min_games = int(self.args.get('min_games', 20))
        if ratings.games_since_promote < min_games:
            return False
        return (ratings.rating(LEARNER)
                >= ratings.rating(self.champion) + margin)


def journal_path(root: str) -> str:
    """The RatingBook's journal under the registry root."""
    return os.path.join(root, 'league_ratings.json')


def make_rating_book(league_args: Dict[str, Any]) -> RatingBook:
    lg = league_args or {}
    return RatingBook(
        initial_rating=float(lg.get('initial_rating', 1200.0)),
        k_factor=float(lg.get('k_factor', 32.0)),
        track_sigma=bool(lg.get('track_sigma', True)),
        initial_sigma=float(lg.get('initial_sigma', 200.0)),
        min_sigma=float(lg.get('min_sigma', 50.0)))
