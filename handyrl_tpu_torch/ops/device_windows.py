"""Window assembly on the device: rollout records -> replay ring, with no
host copy of a trajectory.

The port of ``handyrl_tpu/ops/device_windows.py`` in its 'solo' layout (a
simultaneous env, ``turn_based_training=False``). A per-env episode
history lives on the device as fixed (N, L, P, ...) tensors; the ingest
consumes a rollout chunk ply by ply, and wherever an episode ends it

  * draws ``clip(steps // forward_steps, 1, W)`` training windows at
    uniform train starts (the host ingestion rate), each for a uniform
    seat,
  * builds them with the pad and mask rules of ``ops/batch.py``'s window
    builder (reference train.py:33-124): prob pad 1, action-mask pad
    +1e32, value tail = the seat's final outcome, progress pad 1, the
    episode, turn and observation masks; every leaf has P axis 1,
  * and writes them into the ring at consecutive slots from ``cursor``
    (prefix sums over the finished envs).

Where the JAX package skips the window build on plies where no episode
ended (``lax.cond``), this runs it on every ply and sends the windows of
the envs that did not finish to a spare ring row at index ``capacity``
(the JAX scatter's dropped slot), so the ingest has no branch on device
values and can be captured in a CUDA graph.

The ring stores each window as one flat row per leaf, (capacity + 1,
prod(window shape)); ``window_spec`` restores the shapes after a gather.

What waits (ROADMAP.md): the 'turn' layout (``build_windows_turn``),
which comes with the turn-based device envs.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def flatten_window_keys(win: Dict[str, Any]) -> Dict[str, Any]:
    """Nested window dicts (a pytree observation) to dotted keys
    ('observation.board'), any depth; a key holding '.' is refused, and
    every value must be array-like."""
    out = {}

    def walk(prefix, v):
        if isinstance(v, dict):
            for sk, sv in v.items():
                if '.' in str(sk):
                    raise ValueError(
                        'observation key %r contains ".", which is reserved '
                        'for the ring\'s flattened-path encoding' % (sk,))
                walk('%s.%s' % (prefix, sk) if prefix else str(sk), sv)
        else:
            if not hasattr(v, 'shape'):
                raise TypeError('window leaf %r is %r, not an array'
                                % (prefix, type(v)))
            out[prefix] = v

    for k, v in win.items():
        walk(str(k), v)
    return out


def unflatten_window_keys(win: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`flatten_window_keys`."""
    out: Dict[str, Any] = {}
    for k, v in win.items():
        parts = k.split('.')
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def build_windows_solo_batched(hist: Dict[str, Tensor], S: Tensor,
                               ts: Tensor, seat: Tensor, outcome: Tensor,
                               fs: int, bi: int, L: int) -> Dict[str, Tensor]:
    """Solo windows of N envs at once: hist leaves (N, L, P, ...), S (N,)
    episode lengths, ts and seat (N, W) train starts and seats, outcome
    (N, P). Returns flat-keyed leaves with leading axes (N, W)."""
    T = bi + fs
    n, w = ts.shape
    dev = ts.device
    m = ts[..., None].long() - bi + torch.arange(T, device=dev)   # (N, W, T)
    lengths = S.long()[:, None, None]
    in_ep = (m >= 0) & (m < lengths)
    tail = m >= lengths
    idxm = m.clamp(0, L - 1)
    rows = torch.arange(n, device=dev)[:, None, None]
    seats = seat.long()[..., None]

    def take(x: Tensor) -> Tensor:
        return x[rows, idxm, seats]                                # (N, W, T, ...)

    def vmask(x: Tensor, fill: float, cond: Tensor) -> Tensor:
        return torch.where(cond.reshape(cond.shape + (1,) * (x.dim() - 3)),
                           x, fill)

    valid = in_ep & take(hist['acting'])
    oc = torch.gather(outcome, 1, seat.long())                     # (N, W)
    obs = vmask(take(hist['obs']), 0.0, valid)[:, :, :, None]
    prob = torch.where(valid, take(hist['prob']), 1.0)
    act = torch.where(valid, take(hist['action']), 0)
    amask = vmask(take(hist['amask']), 1e32, valid)[:, :, :, None]
    val = take(hist['value'])[..., 0]
    val = torch.where(valid, val, torch.where(tail, oc[..., None], 0.0))
    if 'reward' in hist:
        rew = torch.where(in_ep, take(hist['reward']), 0.0)
        ret = torch.where(in_ep, take(hist['return']), 0.0)
    else:
        rew = torch.zeros((n, w, T), dtype=torch.float32, device=dev)
        ret = rew
    progress = torch.where(in_ep, m.float() / lengths.float(), 1.0)
    f32 = torch.float32
    return flatten_window_keys({
        'observation': obs.to(f32),
        'selected_prob': prob.to(f32)[..., None, None],
        'action': act.to(torch.int32)[..., None, None],
        'action_mask': amask.to(f32),
        'value': val.to(f32)[..., None, None],
        'reward': rew.to(f32)[..., None, None],
        'return': ret.to(f32)[..., None, None],
        'outcome': oc.to(f32).reshape(n, w, 1, 1, 1),
        'episode_mask': in_ep.to(f32)[..., None, None],
        'turn_mask': valid.to(f32)[..., None, None],
        'observation_mask': valid.to(f32)[..., None, None],
        'progress': progress.to(f32)[..., None],
    })


def build_windows_solo(hist: Dict[str, Tensor], S, ts: Tensor, seat: Tensor,
                       outcome: Tensor, fs: int, bi: int, L: int
                       ) -> Dict[str, Tensor]:
    """Windows of ONE env in solo layout, as the JAX package's function:
    hist leaves (L, P, ...), S its episode length, ts and seat (W,),
    outcome (P,). Returns leaves with leading axis W."""
    hist1 = {k: v[None] for k, v in hist.items()}
    S1 = torch.as_tensor(S, device=ts.device).reshape(1)
    win = build_windows_solo_batched(hist1, S1, ts[None], seat[None],
                                     outcome[None], fs, bi, L)
    return {k: v[0] for k, v in win.items()}


def discounted_returns(rewards: Tensor, valid: Tensor, gamma: float
                       ) -> Tensor:
    """Backward discounted returns over an (L, P) reward history:
    ret[m] = r[m] + gamma * ret[m+1] within the valid prefix, 0 outside
    (the JAX package's ``_discounted_returns``)."""
    out = torch.zeros_like(rewards)
    carry = torch.zeros_like(rewards[0])
    for m in range(rewards.shape[0] - 1, -1, -1):
        nxt = rewards[m] + gamma * carry
        v = valid[m].reshape(valid[m].shape + (1,) * (nxt.dim()
                                                      - valid[m].dim()))
        carry = torch.where(v, nxt, 0.0)
        out[m] = carry
    return out


class DeviceWindower:
    """Owns the shapes of the per-env episode history and of the ring, and
    the chunk ingest.

    ``ingest(records, state, ring, cursor, size, generator)`` consumes one
    rollout chunk, updating the history, the ring, ``cursor`` and ``size``
    (0-d int64 tensors) in place, and returns (episodes finished, windows
    written) as 0-d tensors. The draws (per ply: the train starts' uniforms
    (N, W) and the seats (N, W)) come from ``generator``, or from ``draws``
    {'u': (K, N, W), 'seat': (K, N, W)}."""

    def __init__(self, mode: str, fs: int, bi: int, max_steps: int,
                 windows_cap: int, capacity: int, num_players: int,
                 gamma: float, has_reward: bool):
        if mode != 'solo':
            raise NotImplementedError(
                "the %r ingest layout is not ported yet (ROADMAP.md); the "
                "port runs 'solo'" % (mode,))
        self.mode = mode
        self.fs, self.bi = int(fs), int(bi)
        self.L = int(max_steps)
        self.W = max(1, int(windows_cap))
        self.capacity = int(capacity)
        self.P = int(num_players)
        self.gamma = float(gamma)
        self.has_reward = bool(has_reward)
        self.window_spec: Optional[Dict[str, Tuple[tuple, torch.dtype]]] = None

    def _hist_keys(self):
        return ['obs', 'action', 'prob', 'amask', 'value', 'acting'] + (
            ['reward'] if self.has_reward else [])

    # -- allocation ---------------------------------------------------------
    def init_state(self, records: Dict[str, Tensor]) -> Dict[str, Any]:
        """Zero history tensors shaped after a chunk's records (K, N, ...):
        {'hist': {key: (N, L, ...)}, 'counts': (N,) int64}."""
        hist = {k: torch.zeros((r.shape[1], self.L) + tuple(r.shape[2:]),
                               dtype=r.dtype, device=r.device)
                for k, r in records.items() if k in self._hist_keys()}
        n = records['done'].shape[1]
        return {'hist': hist,
                'counts': torch.zeros((n,), dtype=torch.int64,
                                      device=records['done'].device)}

    def init_ring(self, records: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """Zero ring rows, (capacity + 1, prod(window shape)) a leaf; the
        last row takes the windows of envs that did not finish. Sets
        ``window_spec``."""
        T = self.bi + self.fs
        obs_shape = tuple(records['obs'].shape[3:])
        A = records['amask'].shape[-1]
        f32 = torch.float32
        self.window_spec = {
            'observation': ((T, 1) + obs_shape, f32),
            'selected_prob': ((T, 1, 1), f32),
            'action': ((T, 1, 1), torch.int32),
            'action_mask': ((T, 1, A), f32),
            'value': ((T, 1, 1), f32),
            'reward': ((T, 1, 1), f32),
            'return': ((T, 1, 1), f32),
            'outcome': ((1, 1, 1), f32),
            'episode_mask': ((T, 1, 1), f32),
            'turn_mask': ((T, 1, 1), f32),
            'observation_mask': ((T, 1, 1), f32),
            'progress': ((T, 1), f32),
        }
        dev = records['done'].device
        return {k: torch.zeros((self.capacity + 1, int(np.prod(shape))),
                               dtype=dtype, device=dev)
                for k, (shape, dtype) in self.window_spec.items()}

    def unflatten_rows(self, rows: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """(n, flat) ring rows -> (n,) + window shape a leaf."""
        return unflatten_window_keys(
            {k: v.reshape((v.shape[0],) + self.window_spec[k][0])
             for k, v in rows.items()})

    # -- the ingest ---------------------------------------------------------
    def ingest(self, records: Dict[str, Tensor], state: Dict[str, Any],
               ring: Dict[str, Tensor], cursor: Tensor, size: Tensor,
               generator: Optional[torch.Generator] = None,
               draws: Optional[Dict[str, Tensor]] = None):
        hist, counts = state['hist'], state['counts']
        fs, bi, L, W, cap = self.fs, self.bi, self.L, self.W, self.capacity
        n = counts.shape[0]
        dev = counts.device
        rows = torch.arange(n, device=dev)
        w_ix = torch.arange(W, device=dev)[None, :]
        done_total = torch.zeros((), dtype=torch.int64, device=dev)
        new_total = torch.zeros((), dtype=torch.int64, device=dev)
        for k in range(records['done'].shape[0]):
            idx = counts.clamp(0, L - 1)
            for key in hist:
                hist[key][rows, idx] = records[key][k]
            counts.add_(1)
            done = records['done'][k]
            if draws is None:
                u = torch.rand((n, W), generator=generator, device=dev)
                seat = torch.randint(0, self.P, (n, W), generator=generator,
                                     device=dev)
            else:
                u, seat = draws['u'][k], draws['seat'][k]
            win_hist = hist
            if self.has_reward:
                valid = torch.arange(L, device=dev)[None, :] < counts[:, None]
                win_hist = dict(hist, **{'return': torch.stack([
                    discounted_returns(hist['reward'][i], valid[i],
                                       self.gamma) for i in range(n)])})
            # windows a finished episode contributes: the host ingestion rate
            wcount = torch.clamp(torch.div(counts, fs, rounding_mode='floor'),
                                 1, W)
            span = (counts - fs).clamp(min=0) + 1        # train start in [0, span)
            ts = torch.minimum((u * span[:, None]).to(torch.int64),
                               span[:, None] - 1)
            windows = build_windows_solo_batched(win_hist, counts, ts, seat,
                                                 records['outcome'][k], fs,
                                                 bi, L)
            # ring slots by prefix sums over the finished envs; the rest go
            # to the spare row
            dcount = torch.where(done, wcount, 0)
            base = cursor + torch.cumsum(dcount, 0) - dcount
            slot = torch.remainder(base[:, None] + w_ix, cap)
            valid_w = done[:, None] & (w_ix < wcount[:, None])
            slot = torch.where(valid_w, slot, cap).reshape(-1)
            for key, rb in ring.items():
                rb[slot] = windows[key].reshape(n * W, -1).to(rb.dtype)
            n_new = dcount.sum()
            cursor.copy_(torch.remainder(cursor + n_new, cap))
            size.copy_(torch.clamp(size + n_new, max=cap))
            counts.copy_(torch.where(done, 0, counts))
            done_total += done.sum()
            new_total += n_new
        return done_total, new_total
