"""Episode storage and training-batch construction (host side).

A copy of ``handyrl_tpu/ops/batch.py`` (numpy, bz2 and pickle only), the
streaming ingest's per-chunk receive stamps and staleness-aware
reselection included, without the stage timer.
``make_batch(out=)`` builds into caller-owned arenas (the shared-memory
slots of ``ops/shm_batch.py``), restoring their pad defaults first. Episode records and moments are plain dicts of numpy
arrays, so they cross between the packages unchanged, and one seed gives
both the same batch.

It turns ragged self-play episodes into the fixed-shape ``(B, T, P, ...)``
arrays the update step consumes, with the reference batch builder's
semantics (train.py:33-124 of HandyRL), on which every downstream mask
depends:

  * missing per-player entries are backfilled: prob -> 1, action -> 0,
    action_mask -> +1e32 (all actions illegal), observation -> zeros;
  * windows shorter than ``burn_in_steps + forward_steps`` are padded:
    before-window with zeros (masks 0), after episode end with zeros except
    ``value``, which is padded with the final outcome (terminal bootstrap),
    and ``progress``, padded with 1;
  * ``turn_mask`` marks steps where the player actually acted,
    ``observation_mask`` steps where they observed, ``episode_mask`` real
    (non-padding) steps.

Episodes are stored as independently decompressible chunks of
``compress_steps`` moments (bz2), so window selection only decodes the
blocks it needs.

Two builders produce identical bits: the arena builder (:func:`make_batch`),
the production path, which decodes each episode once and writes it straight
into preallocated ``(B, T, P, ...)`` arenas; and the reference builder
(:func:`make_batch_reference`), the per-moment list-comprehension
implementation kept as the semantic pin (tests/test_torch_batch.py holds
the two and the JAX package's to each other).
"""

from __future__ import annotations

import bz2
import pickle
import random
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.tree import map_structure, stack_structure

MOMENT_KEYS = ('observation', 'selected_prob', 'action_mask', 'action',
               'value', 'reward', 'return')


def compress_moments(moments: List[dict], compress_steps: int,
                     level: int = 9) -> List[bytes]:
    """Chunk + compress a finished episode's moments.

    ``level`` is bz2's compresslevel (1 fastest .. 9 smallest, the bz2
    default): on engine-mode workers compression dominates the remaining
    per-episode CPU, so hosts squeezed for actor cycles can trade upload
    bytes for throughput via the ``compress_level`` config knob."""
    return [bz2.compress(pickle.dumps(moments[i:i + compress_steps]),
                         compresslevel=int(level))
            for i in range(0, len(moments), compress_steps)]


def decompress_moments(blocks: Sequence[bytes]) -> List[dict]:
    out: List[dict] = []
    for block in blocks:
        out += pickle.loads(bz2.decompress(block))
    return out


def _chunk_recv_time(ep: dict, train_st: int):
    """The receive time of the window at ``train_st``: its chunk's for a
    streamed entry (the assembler stamps ``chunk_recv`` per exposed
    window), the whole episode's otherwise."""
    recv = ep.get('chunk_recv')
    if recv:
        T = max(1, int(ep.get('chunk_steps') or 1))
        return recv[min(train_st // T, len(recv) - 1)]
    return ep.get('recv_time')


def select_episode(episodes: Sequence[dict], args: Dict[str, Any],
                   now=None) -> dict:
    """Recency-biased episode + window sampling (HandyRL train.py:291-315).

    Index i among N buffered episodes is accepted with probability
    (i+1)/N (newer episodes are proportionally more likely), then a uniform
    random ``forward_steps`` window (plus up to ``burn_in_steps`` of warmup
    context) is sliced out, keeping only the compressed blocks it covers.

    With ``streaming.staleness_half_life`` > 0, a drawn window with a
    receive stamp is also accepted with probability ``0.5 ** (age /
    half_life)`` over its chunk's age, re-drawing episode and window up to
    ``streaming.max_reselect`` times before it is accepted regardless. At
    0 the knob adds no draw: the draws are those of the JAX package's
    sampler with streaming off.
    """
    stm = args.get('streaming') or {}
    half_life = float(stm.get('staleness_half_life', 0.0) or 0.0)
    reselects = int(stm.get('max_reselect', 4)) if half_life > 0 else 0
    while True:
        while True:
            ep_count = min(len(episodes), args['maximum_episodes'])
            ep_idx = random.randrange(ep_count)
            accept_rate = 1 - (ep_count - 1 - ep_idx) / ep_count
            if random.random() >= accept_rate:
                continue
            try:
                ep = episodes[ep_idx]
                break
            except IndexError:
                continue

        turn_candidates = 1 + max(0, ep['steps'] - args['forward_steps'])
        train_st = random.randrange(turn_candidates)
        if reselects <= 0:
            break
        recv = _chunk_recv_time(ep, train_st)
        if recv is None:
            break
        if now is None:
            now = time.time()
        age = max(0.0, float(now) - float(recv))
        if random.random() < 0.5 ** (age / half_life):
            break
        reselects -= 1

    st = max(0, train_st - args['burn_in_steps'])
    ed = min(train_st + args['forward_steps'], ep['steps'])
    cs = args['compress_steps']
    st_block, ed_block = st // cs, (ed - 1) // cs + 1
    return {
        'args': ep['args'], 'outcome': ep['outcome'],
        'moment': ep['moment'][st_block:ed_block],
        'base': st_block * cs,
        'start': st, 'end': ed, 'train_start': train_st, 'total': ep['steps'],
        'recv_time': _chunk_recv_time(ep, train_st),
    }


def _replace_none(value, fallback):
    return value if value is not None else fallback


# ---------------------------------------------------------------------------
# reference builder: the original implementation, kept as the semantic pin
# for the arena builder. Not used on the production path.


def build_window_reference(moments: List[dict], ep: dict, args: Dict[str, Any]
                           ) -> Dict[str, Any]:
    """One training window via per-moment/per-player list comprehensions
    (reference train.py:33-124 semantics, pre-vectorization)."""
    players = list(moments[0]['observation'].keys())
    if not args['turn_based_training']:   # solo training: one random seat
        players = [random.choice(players)]

    first_turn = moments[0]['turn'][0]
    obs_zeros = map_structure(np.zeros_like, moments[0]['observation'][first_turn])
    amask_full = np.zeros_like(moments[0]['action_mask'][first_turn]) + 1e32

    if args['turn_based_training'] and not args['observation']:
        # store only the turn player's data each step (P axis of size 1)
        players_list = [[m['turn'][0]] for m in moments]
    else:
        players_list = [players for _ in moments]

    obs = [[_replace_none(m['observation'][p], obs_zeros) for p in ps]
           for m, ps in zip(moments, players_list)]
    obs = stack_structure([stack_structure(row) for row in obs])   # (T, P, ...)

    prob = np.array([[[_replace_none(m['selected_prob'][p], 1.0)] for p in ps]
                     for m, ps in zip(moments, players_list)], dtype=np.float32)
    act = np.array([[[_replace_none(m['action'][p], 0)] for p in ps]
                    for m, ps in zip(moments, players_list)], dtype=np.int32)
    amask = np.array([[_replace_none(m['action_mask'][p], amask_full) for p in ps]
                      for m, ps in zip(moments, players_list)], dtype=np.float32)

    T, P = len(moments), len(players)
    v = np.array([[_replace_none(m['value'][p], [0]) for p in players]
                  for m in moments], dtype=np.float32).reshape(T, P, -1)
    rew = np.array([[_replace_none(m['reward'][p], 0) for p in players]
                    for m in moments], dtype=np.float32).reshape(T, P, -1)
    ret = np.array([[_replace_none(m['return'][p], 0) for p in players]
                    for m in moments], dtype=np.float32).reshape(T, P, -1)
    oc = np.array([ep['outcome'][p] for p in players],
                  dtype=np.float32).reshape(1, P, -1)

    # NOTE: masks span ALL players even in turn-alternating mode (where
    # obs/prob/action/action_mask carry only the turn player, P=1): the
    # loss pipeline gathers the turn player's policy row via turn_mask and
    # gates per-player RNN state via observation_mask (train.py:86-87).
    emask = np.ones((T, 1, 1), dtype=np.float32)
    tmask = np.array([[[m['selected_prob'][p] is not None] for p in players]
                      for m in moments], dtype=np.float32)
    omask = np.array([[[m['observation'][p] is not None] for p in players]
                      for m in moments], dtype=np.float32)
    progress = (np.arange(ep['start'], ep['end'], dtype=np.float32)[:, None]
                / ep['total'])

    batch_steps = args['burn_in_steps'] + args['forward_steps']
    if T < batch_steps:
        pad_b = args['burn_in_steps'] - (ep['train_start'] - ep['start'])
        pad_a = batch_steps - T - pad_b

        def pad_t(a, before, after, value):
            width = [(before, after)] + [(0, 0)] * (a.ndim - 1)
            return np.pad(a, width, 'constant', constant_values=value)

        obs = map_structure(lambda o: pad_t(o, pad_b, pad_a, 0), obs)
        prob = pad_t(prob, pad_b, pad_a, 1)
        # value: zeros before the window, final outcome beyond episode end
        v = np.concatenate([pad_t(v, pad_b, 0, 0), np.tile(oc, (pad_a, 1, 1))])
        act = pad_t(act, pad_b, pad_a, 0)
        rew = pad_t(rew, pad_b, pad_a, 0)
        ret = pad_t(ret, pad_b, pad_a, 0)
        emask = pad_t(emask, pad_b, pad_a, 0)
        tmask = pad_t(tmask, pad_b, pad_a, 0)
        omask = pad_t(omask, pad_b, pad_a, 0)
        amask = pad_t(amask, pad_b, pad_a, 1e32)
        progress = pad_t(progress, pad_b, pad_a, 1)

    return {
        'observation': obs, 'selected_prob': prob, 'value': v, 'action': act,
        'outcome': oc, 'reward': rew, 'return': ret, 'episode_mask': emask,
        'turn_mask': tmask, 'observation_mask': omask, 'action_mask': amask,
        'progress': progress,
    }


def _decode_window(ep: dict, cache: Optional['BlockCache'] = None
                   ) -> List[dict]:
    if cache is None:
        moments = decompress_moments(ep['moment'])
    else:
        moments = []
        for block in ep['moment']:
            moments += cache.get(block)
    return moments[ep['start'] - ep['base']:ep['end'] - ep['base']]


class BlockCache:
    """Bounded LRU of decoded bz2 moment blocks, shared across batches.

    Window selection is recency-biased, so the same episodes (the same
    compressed blocks) are decoded over and over: within one batch (B
    windows drawn from far fewer buffered episodes) and across consecutive
    batches. Keying on the immutable block bytes themselves (CPython caches
    a bytes object's hash, and dict hits short-circuit on identity) makes
    each block's bz2+pickle cost one-time until evicted. Thread-safe: one
    instance serves every batcher thread.

    Cached moments are shared read-only: both builders only read moment
    dicts (arena assignment copies leaf arrays), so sharing is safe.
    """

    def __init__(self, max_blocks: int = 1024):
        from collections import OrderedDict
        import threading
        self.max_blocks = max_blocks
        self._od: 'OrderedDict[bytes, List[dict]]' = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, block: bytes) -> List[dict]:
        with self._lock:
            hit = self._od.get(block)
            if hit is not None:
                self._od.move_to_end(block)
                self.hits += 1
                return hit
            self.misses += 1
        decoded = pickle.loads(bz2.decompress(block))
        with self._lock:
            self._od[block] = decoded
            while len(self._od) > self.max_blocks:
                self._od.popitem(last=False)
        return decoded


def make_block_cache(args: Dict[str, Any]) -> Optional[BlockCache]:
    """BlockCache sized by args['decode_cache_blocks'] (default 1024);
    0 disables the cross-batch cache (per-batch de-dup remains)."""
    n = args.get('decode_cache_blocks')
    n = 1024 if n is None else int(n)
    return BlockCache(n) if n > 0 else None


def stack_windows(rows: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack per-window dicts into one (B, T, P, ...) batch dict."""
    batch = {}
    for key in rows[0]:
        batch[key] = stack_structure([r[key] for r in rows])
    return batch


def make_batch_reference(episodes: Sequence[dict], args: Dict[str, Any]
                         ) -> Dict[str, Any]:
    """(B, T, P, ...) batch via the reference per-window builder + stack."""
    return stack_windows([build_window_reference(_decode_window(ep), ep, args)
                          for ep in episodes])


# ---------------------------------------------------------------------------
# arena builder: the production path


def _leaf_paths(x, prefix: Tuple = ()) -> List[Tuple]:
    """Depth-first paths of every non-container leaf (dict keys in
    insertion order, list/tuple indices), mirroring utils.tree walks."""
    if isinstance(x, dict):
        out: List[Tuple] = []
        for k in x:
            out += _leaf_paths(x[k], prefix + (k,))
        return out
    if isinstance(x, (list, tuple)):
        out = []
        for i, v in enumerate(x):
            out += _leaf_paths(v, prefix + (i,))
        return out
    return [prefix]


def _get_path(x, path: Tuple):
    for k in path:
        x = x[k]
    return x


def _tail_dim(windows: Sequence[List[dict]], key: str) -> int:
    """Trailing feature dim the reference's ``reshape(T, P, -1)`` yields for
    ``key``: the element count of the first non-None entry (1 if all None,
    from the scalar/[0] fallback)."""
    for moments in windows:
        for m in moments:
            for v in m[key].values():
                if v is not None:
                    return max(1, int(np.asarray(v).size))
    return 1


def _alloc_arenas(B: int, S: int, moments0: List[dict], players: List,
                  args: Dict[str, Any], dims: Tuple[int, int, int]
                  ) -> Dict[str, Any]:
    """Preallocate the full (B, S, P, ...) batch with pad defaults baked in
    (obs/act/value/reward/return/masks 0, prob 1, action_mask 1e32,
    progress 1). Shapes/dtypes come from the first window's acting seat,
    exactly where the reference builder takes its zero templates."""
    first_turn = moments0[0]['turn'][0]
    obs_t = moments0[0]['observation'][first_turn]
    amask_t = np.asarray(moments0[0]['action_mask'][first_turn])
    P = len(players)
    Pd = 1 if (args['turn_based_training'] and not args['observation']) else P
    Vv, Vr, Vt = dims
    return {
        'observation': map_structure(
            lambda leaf: np.zeros((B, S, Pd) + np.asarray(leaf).shape,
                                  np.asarray(leaf).dtype), obs_t),
        'selected_prob': np.full((B, S, Pd, 1), 1.0, np.float32),
        'value': np.zeros((B, S, P, Vv), np.float32),
        'action': np.zeros((B, S, Pd, 1), np.int32),
        'outcome': np.zeros((B, 1, P, 1), np.float32),
        'reward': np.zeros((B, S, P, Vr), np.float32),
        'return': np.zeros((B, S, P, Vt), np.float32),
        'episode_mask': np.zeros((B, S, 1, 1), np.float32),
        'turn_mask': np.zeros((B, S, P, 1), np.float32),
        'observation_mask': np.zeros((B, S, P, 1), np.float32),
        'action_mask': np.full((B, S, Pd) + amask_t.shape, 1e32, np.float32),
        'progress': np.full((B, S, 1), 1.0, np.float32),
    }


def _reset_arenas(ar: Dict[str, Any]):
    """Restore the pad defaults in a reused (e.g. shared-memory) arena set."""
    for key, arena in ar.items():
        if key == 'observation':
            map_structure(lambda a: a.fill(0), arena)
        elif key == 'selected_prob' or key == 'progress':
            arena.fill(1)
        elif key == 'action_mask':
            arena.fill(1e32)
        else:
            arena.fill(0)


def _fill_window(ar: Dict[str, Any], b: int, moments: List[dict], ep: dict,
                 args: Dict[str, Any], players: List,
                 obs_dsts: List[Tuple[Tuple, np.ndarray]]):
    """Write one window into batch row ``b`` of the preallocated arenas.
    Rows outside [pad_b, pad_b+T) keep their pre-filled pad defaults; the
    value tail additionally gets the terminal-bootstrap outcome."""
    S = args['burn_in_steps'] + args['forward_steps']
    T = len(moments)
    compact = args['turn_based_training'] and not args['observation']
    pad_b = (args['burn_in_steps'] - (ep['train_start'] - ep['start'])
             if T < S else 0)
    plain_obs = len(obs_dsts) == 1 and obs_dsts[0][0] == ()

    prob, act = ar['selected_prob'], ar['action']
    amask, val = ar['action_mask'], ar['value']
    rew, ret = ar['reward'], ar['return']
    tmask, omask = ar['turn_mask'], ar['observation_mask']

    for t, m in enumerate(moments):
        tt = pad_b + t
        ps = (m['turn'][0],) if compact else players
        m_obs, m_prob = m['observation'], m['selected_prob']
        m_amask, m_act = m['action_mask'], m['action']
        for j, p in enumerate(ps):
            x = m_prob[p]
            if x is not None:
                prob[b, tt, j, 0] = x
            x = m_act[p]
            if x is not None:
                act[b, tt, j, 0] = x
            x = m_amask[p]
            if x is not None:
                amask[b, tt, j] = x
            x = m_obs[p]
            if x is not None:
                if plain_obs:
                    obs_dsts[0][1][b, tt, j] = x
                else:
                    for path, dst in obs_dsts:
                        dst[b, tt, j] = _get_path(x, path)
        m_val, m_rew, m_ret = m['value'], m['reward'], m['return']
        for j, p in enumerate(players):
            x = m_val[p]
            if x is not None:
                val[b, tt, j] = np.asarray(x, np.float32).reshape(-1)
            x = m_rew[p]
            if x is not None:
                rew[b, tt, j] = np.asarray(x, np.float32).reshape(-1)
            x = m_ret[p]
            if x is not None:
                ret[b, tt, j] = np.asarray(x, np.float32).reshape(-1)
            if m_prob[p] is not None:
                tmask[b, tt, j, 0] = 1.0
            if m_obs[p] is not None:
                omask[b, tt, j, 0] = 1.0

    ar['episode_mask'][b, pad_b:pad_b + T, 0, 0] = 1.0
    ar['progress'][b, pad_b:pad_b + T, 0] = (
        np.arange(ep['start'], ep['end'], dtype=np.float32) / ep['total'])
    tail = pad_b + T
    for j, p in enumerate(players):
        oc = np.float32(ep['outcome'][p])
        ar['outcome'][b, 0, j, 0] = oc
        if tail < S:
            val[b, tail:, j] = oc


def _window_players(moments: List[dict], args: Dict[str, Any]) -> List:
    """The window's player axis: all seats, or one random seat in solo
    mode. The draw matches the reference builder's (one random.choice per
    window, same argument, same order), so a seeded RNG produces identical
    batches from either builder."""
    players = list(moments[0]['observation'].keys())
    if not args['turn_based_training']:
        players = [random.choice(players)]
    return players


def _obs_dsts(ar: Dict[str, Any]) -> List[Tuple[Tuple, np.ndarray]]:
    return [(path, _get_path(ar['observation'], path))
            for path in _leaf_paths(ar['observation'])]


def make_batch(episodes: Sequence[dict], args: Dict[str, Any],
               out: Optional[Dict[str, Any]] = None,
               cache: Optional[BlockCache] = None) -> Dict[str, Any]:
    """Build a (B, T, P, ...) training batch from selected episode windows.

    Each distinct bz2 block is decoded at most once per batch (and, with a
    shared ``cache``, at most once across batches until evicted), and
    windows are written directly into the batch arenas. ``out`` lets the
    caller own the arenas (a shared-memory batcher slot, written in place;
    its pad defaults are restored first); it is returned."""
    if cache is None:
        # within-batch de-dup at minimum: recency bias repeats episodes
        cache = BlockCache(max_blocks=max(256, 64 * len(episodes)))
    windows = [_decode_window(ep, cache) for ep in episodes]
    players_per = [_window_players(m, args) for m in windows]
    dims = (_tail_dim(windows, 'value'), _tail_dim(windows, 'reward'),
            _tail_dim(windows, 'return'))
    S = args['burn_in_steps'] + args['forward_steps']
    if out is None:
        ar = _alloc_arenas(len(episodes), S, windows[0], players_per[0],
                           args, dims)
    else:
        ar = out
        _reset_arenas(ar)
    obs_dsts = _obs_dsts(ar)
    for b, (moments, players) in enumerate(zip(windows, players_per)):
        _fill_window(ar, b, moments, episodes[b], args, players, obs_dsts)
    return ar
