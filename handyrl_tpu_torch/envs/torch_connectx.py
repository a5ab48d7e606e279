"""Vectorized ConnectX on tensors: the device-resident twin of
``envs/kaggle/connectx.py``, for the fused loop's 'turn' layout, the
device evaluator and the device actor.

The port of ``handyrl_tpu/envs/jax_connectx.py``. N boards advance as one
call: the drop to the lowest empty row, win detection over the 69 lines
of four, the observation codec and auto-reset are tensor ops, so a
rollout chunk can be captured as one CUDA graph. The lines and the
heuristic's center-out ranks are computed with ``arange`` and arithmetic
on the boards' device, never built from a Python list inside a call (a
host-to-device copy cannot run inside a graph capture); they equal the
host env's ``WIN_LINES`` as a set and its ``CENTER_ORDER`` as ranks.

State (every leaf has the env axis N first):
  boards  (N, 42) int8   +1 first player / -1 second / 0 empty (row-major)
  side    (N,)    int8   side to move (+1/-1)
  winner  (N,)    int8   +1/-1 once decided, 0 otherwise
  moves   (N,)    int8   plies played (<= 42)

Turn-based protocol (device_generation.py): ``turn`` -> (N,) acting
player, ``observe`` -> (N, 3, 6, 7), ``step`` takes (N,) actions. The env
draws nothing, so ``generator`` is accepted and unused, and a game's
records replay exactly through the host env (``RNG_COMPAT = 'strict'``).
``greedy_action`` is the host ``rule_based_action`` for every board at
once, so 'rulebase' seats play inside the captured ply.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .kaggle.connectx import COLS, IN_A_ROW, ROWS

N_ACTIONS = COLS
MAX_STEPS = ROWS * COLS
NUM_PLAYERS = 2
# deterministic given the actions: records replay byte for byte through
# the host env
RNG_COMPAT = 'strict'

Tensor = torch.Tensor


class State(NamedTuple):
    boards: Tensor
    side: Tensor
    winner: Tensor
    moves: Tensor


def win_lines(device) -> Tensor:
    """The 69 lines of four as a (69, 4) int64 tensor of flat cell
    indices on ``device``, from ``arange``: rows, columns, the diagonals
    and the anti-diagonals (``WIN_LINES`` holds the same lines in another
    order)."""
    i = torch.arange(IN_A_ROW, device=device)
    r = torch.arange(ROWS, device=device)
    c = torch.arange(COLS, device=device)
    rs, cs = r[:ROWS - 3], c[:COLS - 3]

    def lines(r0: Tensor, c0: Tensor, dr: int, dc: int) -> Tensor:
        rr = r0[:, None, None] + dr * i
        cc = c0[None, :, None] + dc * i
        return (rr * COLS + cc).reshape(-1, IN_A_ROW)

    return torch.cat([lines(r, cs, 0, 1), lines(rs, c, 1, 0),
                      lines(rs, cs, 1, 1), lines(rs, c[3:], 1, -1)])


def center_rank(device) -> Tensor:
    """(7,) int64: the rank of each column in ``CENTER_ORDER`` (3, 2, 4,
    1, 5, 0, 6 -> ranks 0..6), as 2|c - 3| less one left of center."""
    c = torch.arange(COLS, device=device)
    mid = COLS // 2
    return 2 * (c - mid).abs() - (c < mid).long()


def init_state(n: int, seed: int = 0, device='cpu',
               generator: Optional[torch.Generator] = None) -> State:
    """``n`` empty boards, the first player to move (``seed`` and
    ``generator`` are unused: a fresh game draws nothing)."""
    return State(
        boards=torch.zeros((n, ROWS * COLS), dtype=torch.int8,
                           device=device),
        side=torch.ones((n,), dtype=torch.int8, device=device),
        winner=torch.zeros((n,), dtype=torch.int8, device=device),
        moves=torch.zeros((n,), dtype=torch.int8, device=device))


def legal_mask(state: State) -> Tensor:
    """(N, 7) float32, 1 = legal: the column's top cell is empty."""
    return (state.boards[:, :COLS] == 0).float()


def terminal(state: State) -> Tensor:
    return (state.winner != 0) | (state.moves >= MAX_STEPS)


def turn(state: State) -> Tensor:
    """The acting player's index (0 first, 1 second) per env, int64."""
    return torch.remainder(state.moves.long(), 2)


def observe(state: State) -> Tensor:
    """The side to move's view, (N, 3, 6, 7) float32: [1, mine, theirs]
    (the host env's codec)."""
    board = state.boards.reshape(-1, ROWS, COLS)
    side = state.side[:, None, None]
    mine = (board == side).float()
    theirs = (board == -side).float()
    return torch.stack([torch.ones_like(mine), mine, theirs], dim=1)


def _drop_index(boards: Tensor, cols: Tensor) -> Tuple[Tensor, Tensor]:
    """The flat cell index of a drop into ``cols`` (any shape broadcast
    against the env axis first), and whether the column had room. A full
    column's index is clamped into range; callers mask with legality."""
    n = boards.shape[0]
    board = boards.reshape(n, ROWS, COLS)
    filled = (board != 0).sum(dim=1)                          # (N, 7)
    cols = cols.long()
    f = torch.gather(filled, 1, cols.reshape(n, -1)).reshape(cols.shape)
    row = ROWS - 1 - f
    return row.clamp(0, ROWS - 1) * COLS + cols, row >= 0


def _wins(boards: Tensor, side: Tensor, lines: Tensor) -> Tensor:
    """(...,) bool: four of ``side`` in a row on ``boards`` (..., 42),
    ``side`` broadcast against the leading axes."""
    sums = boards[..., lines].int().sum(dim=-1)               # (..., 69)
    return (sums == IN_A_ROW * side.int()[..., None]).any(dim=-1)


def step(state: State, actions: Tensor,
         generator: Optional[torch.Generator] = None) -> State:
    """Drop one checker per env (callers feed legal actions only; an env
    already over is replaced by the caller's ``auto_reset`` first)."""
    n = state.boards.shape[0]
    rows = torch.arange(n, device=state.boards.device)
    idx, _ = _drop_index(state.boards, actions)
    boards = state.boards.clone()
    boards[rows, idx] = state.side
    won = _wins(boards, state.side, win_lines(boards.device))
    winner = torch.where(won & (state.winner == 0), state.side, state.winner)
    return State(boards=boards, side=-state.side, winner=winner,
                 moves=state.moves + 1)


def outcome(state: State) -> Tensor:
    """(N, 2) float32 outcome by seat (seat 0 moves first); a draw (42
    plies and no line) scores 0."""
    w = state.winner.float()
    return torch.stack([w, -w], dim=1)


def auto_reset(state: State, done: Tensor,
               generator: Optional[torch.Generator] = None) -> State:
    """Fresh boards where ``done``."""
    fresh = init_state(state.boards.shape[0], device=state.boards.device)

    def pick(f: Tensor, s: Tensor) -> Tensor:
        return torch.where(done.reshape((-1,) + (1,) * (s.dim() - 1)), f, s)

    return State(*(pick(f, s) for f, s in zip(fresh, state)))


def _drop_wins(boards: Tensor, side: Tensor) -> Tensor:
    """(N, 7) bool: would ``side``'s checker dropped into each column make
    four in a row? False where the column is full."""
    n = boards.shape[0]
    dev = boards.device
    cols = torch.arange(COLS, device=dev).expand(n, COLS)
    idx, ok = _drop_index(boards, cols)                       # (N, 7)
    cand = boards[:, None, :].expand(n, COLS, ROWS * COLS).clone()
    cand.scatter_(2, idx[..., None],
                  side[:, None, None].expand(n, COLS, 1).to(cand.dtype))
    return _wins(cand, side[:, None], win_lines(dev)) & ok


def greedy_action(state: State, generator: Optional[torch.Generator] = None,
                  key=None) -> Tensor:
    """The host ``rule_based_action`` on every board, (N,) int64: the
    winning drop if one exists (the lowest such column, as the host's
    ascending legal scan finds it), else the drop that blocks the
    opponent's win (lowest first too), else the first legal column
    center-out. Deterministic: ``generator`` and ``key`` are accepted for
    the rulebase seats' protocol and unused."""
    legal = legal_mask(state) > 0                             # (N, 7)
    my_win = _drop_wins(state.boards, state.side) & legal
    opp_win = _drop_wins(state.boards, -state.side) & legal
    # argmax of a 0/1 row is its first 1
    first = lambda m: torch.argmax(m.int(), dim=1)
    rank = torch.where(legal, center_rank(legal.device)[None, :],
                       torch.full_like(legal, COLS + 1, dtype=torch.long))
    center = torch.argmin(rank, dim=1)
    return torch.where(my_win.any(dim=1), first(my_win),
                       torch.where(opp_win.any(dim=1), first(opp_win),
                                   center))
